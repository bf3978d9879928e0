"""The port's NW path against the JAX package's, on the CPU.

The plain versions of the port's kernels (the wavefront fill, the batched
fill, the pointer walk) are held to the XLA scan of ``nw_jax`` and to the
host fill, and the port's entry points (``perform_alignment``,
``align_pairs``, ``align_grid``, ``grid_search``) to the JAX package's on
the same inputs, made from seeds. Everything is integer (or the float32 the
XLA scan also uses), so every comparison is exact. The JAX side runs its
XLA scan and its host fill: the Pallas NW kernels take about a minute per
bucket in interpret mode.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_alignment_tpu.align import perform_alignment as jax_align
from text_alignment_tpu.align import resolve_scoring
from text_alignment_tpu.align import nw_jax, nw_pallas
from text_alignment_tpu.align.nw_pallas import _token_ids as pallas_ids
from text_alignment_tpu.evaluate import grid_search as jax_grid_search
from text_alignment_tpu.evaluate import scoring_grid
from text_alignment_tpu.pipeline.preprocess import PreprocParams
from text_alignment_tpu.synth import corrupt_ocr, make_page, ocr_with_spaces
from text_alignment_tpu_torch.align import api, nw_kernel, nw_torch
from text_alignment_tpu_torch.align import perform_alignment
from text_alignment_tpu_torch.evaluate import grid_search

from nw_window_model import TB_KERNEL, TB_SMALL, WindowEscape, windowed_walk

torch.set_num_threads(1)

SYNTH_PARAMS = PreprocParams(filter_size=8)


def random_pair(rng, n, m, alphabet="abcdefg "):
    return ([rng.choice(alphabet) for _ in range(n)],
            [rng.choice(alphabet) for _ in range(m)])


def plain_packed(t, o, sc):
    """The port's plain fill of one pair (sentinels included), through the
    route its scoring form takes on the device."""
    L, NoP = nw_torch._bucket(len(t)), nw_torch._bucket(len(o))
    if nw_torch.kernel_form(sc):
        ti, oi = nw_torch._token_ids(t, o)
        row, S = nw_torch.kernel_params(sc), None
    else:
        ti, oi, row, S = nw_torch._encode(t, o, sc)
        S = None if S is None else torch.from_numpy(S)
    tt = torch.from_numpy(nw_torch._ext(ti, L)[None])
    oo = torch.from_numpy(nw_torch._ext(oi, NoP)[None])
    params = torch.from_numpy(row[None])
    if S is None and nw_torch.kernel_form(sc):
        return nw_kernel.fill(tt, oo, params)[0].numpy()
    return nw_kernel.fill_reference(tt, oo, params, S)[0].numpy()


def valid_cells(packed, Nt, No):
    i, j = np.meshgrid(np.arange(Nt), np.arange(No), indexing="ij")
    return packed[i + j, i]


FORMS = {
    "default": (None, True),
    "four": ([10, -5, -7, -7], True),
    "six_asym": ([5, -4, -2, -7, 0, -3], True),
    "loose": (None, False),
    "callable": ([lambda a, b: 6 if a == b else (-1 if " " in (a, b) else -3),
                  -7, -5, -2, -1], True),
    "float": ([8.5, -4.25, -7, -7, -3, 0], True),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n,m", [(127, 129), (40, 70)])
def test_plain_fill_matches_xla_scan(form, n, m):
    """Pointer bytes of every valid cell equal nw_jax.fill_jax_packed's,
    across the 128 -> 256 bucket jump (127/129 characters plus sentinels)
    and under every scoring form."""
    rng = random.Random(n * 7 + m)
    system, strict = FORMS[form]
    t, o = random_pair(rng, n, m)
    t, o = t + [" "], o + [" "]
    sc = resolve_scoring(system, strict=strict)
    ref = nw_jax.fill_jax_packed(t, o, sc)
    got = plain_packed(t, o, sc)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(valid_cells(got, len(t), len(o)),
                                  valid_cells(ref, len(t), len(o)))


def _bucket_batch(pairs):
    t, o, nts, nos = nw_torch.lane_batch([(t + [" "], o + [" "])
                                          for t, o in pairs])
    return torch.from_numpy(t), torch.from_numpy(o), nts, nos


def test_plain_batched_fill_mixed_lengths():
    """A mixed-length batch of one bucket under one scoring row equals each
    pair's own XLA scan fill on its valid cells."""
    rng = random.Random(3)
    pairs = [random_pair(rng, n, m) for n, m in
             [(100, 60), (70, 120), (126, 126), (90, 3)]]
    t, o, nts, nos = _bucket_batch(pairs)
    sc = resolve_scoring(None)
    row = torch.from_numpy(nw_torch.kernel_params(sc)[None])
    got = nw_kernel.fill_batched(t, o, row).numpy()
    for b, (tp, op) in enumerate(pairs):
        ref = nw_jax.fill_jax_packed(tp + [" "], op + [" "], sc)
        np.testing.assert_array_equal(valid_cells(got[b], nts[b], nos[b]),
                                      valid_cells(ref, nts[b], nos[b]))


def test_plain_batched_fill_per_pair_shared_feed():
    """One OCR row shared by every pair and a scoring row per pair (the
    grid search's mode) equals the XLA scan under each row."""
    rng = random.Random(4)
    tp, op = random_pair(rng, 90, 110)
    rows = scoring_grid()[[0, 100, 364, 728]]
    t, o, nts, nos = _bucket_batch([(tp, op)])
    params = torch.from_numpy(np.concatenate(
        [rows, np.full((4, 2), -1)], axis=1).astype(np.int32))
    got = nw_kernel.fill_batched(t.expand(4, -1).contiguous(), o,
                                 params).numpy()
    for b, r in enumerate(rows):
        ref = nw_jax.fill_jax_packed(tp + [" "], op + [" "],
                                     resolve_scoring(list(r)))
        np.testing.assert_array_equal(valid_cells(got[b], nts[0], nos[0]),
                                      valid_cells(ref, nts[0], nos[0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_traceback_matches_jax(seed):
    """ops[:k], k, xpt and ypt of the plain walk equal
    nw_jax._traceback_ops on the same pointers."""
    rng = random.Random(seed)
    t, o = random_pair(rng, 30 + 40 * seed, 90 - 25 * seed)
    t, o = t + [" "], o + [" "]
    sc = resolve_scoring([5, -4, -2, -7, 0, -3] if seed == 2 else None)
    packed = nw_jax.fill_jax_packed(t, o, sc)
    j_ops, j_k, j_x, j_y = (np.asarray(v) for v in nw_jax._traceback_ops(
        jnp.asarray(packed), jnp.int32(len(t)), jnp.int32(len(o)),
        packed.shape[0] + 1))
    wire = nw_kernel.traceback_batched(
        torch.from_numpy(np.array(packed[None])),
        torch.tensor([len(t)], dtype=torch.int32),
        torch.tensor([len(o)], dtype=torch.int32)).numpy()
    ops, k, x, y = nw_torch.unwire(wire[0])
    assert (int(k), int(x), int(y)) == (int(j_k), int(j_x), int(j_y))
    np.testing.assert_array_equal(ops[:k], j_ops[:j_k])


def test_plain_traceback_batch_of_mixed_lengths():
    """The lock-step walk over a batch equals each pair's own walk."""
    rng = random.Random(8)
    pairs = [random_pair(rng, n, m) for n, m in [(50, 20), (10, 60), (64, 64)]]
    t, o, nts, nos = _bucket_batch(pairs)
    row = torch.from_numpy(nw_torch.kernel_params(resolve_scoring(None))[None])
    packed = nw_kernel.fill_batched(t, o, row)
    wire = nw_kernel.traceback_batched(
        packed, torch.tensor(nts, dtype=torch.int32),
        torch.tensor(nos, dtype=torch.int32)).numpy()
    for b in range(len(pairs)):
        one = nw_kernel.traceback_batched(
            packed[b:b + 1].contiguous(),
            torch.tensor(nts[b:b + 1], dtype=torch.int32),
            torch.tensor(nos[b:b + 1], dtype=torch.int32)).numpy()[0]
        k = wire[b, 0]
        np.testing.assert_array_equal(wire[b, :3 + k], one[:3 + k])


@pytest.mark.parametrize("trial", range(12))
def test_device_host_and_jax_agree_on_random_scorings(trial):
    """perform_alignment on a CPU device (the plain versions), the JAX
    package's XLA backend and the host fill give the same alignment under
    seeded random integer scorings (tests/test_nw.py's fuzz)."""
    rng = random.Random(100 + trial)
    system = [rng.randrange(1, 13), -rng.randrange(0, 11),
              -rng.randrange(0, 9), -rng.randrange(0, 9),
              -rng.randrange(0, 6), -rng.randrange(0, 6)]
    strict = trial % 4 != 3
    t, o = random_pair(rng, rng.randrange(2, 60), rng.randrange(2, 60))
    dev = perform_alignment(t, o, system, backend="device", device="cpu",
                            strict=strict)
    host = perform_alignment(t, o, system, backend="host", strict=strict)
    ref = jax_align(t, o, system, backend="jax", strict=strict)
    assert dev == host == ref


@pytest.mark.parametrize("backend", ["auto", "host"])
def test_auto_on_a_cpu_device_takes_the_host_fill(monkeypatch, backend):
    """On a CPU device "auto" stays on the host fill whatever the size, as
    the JAX package does on a CPU platform."""
    def refuse(*args):
        raise AssertionError("the device fill ran")

    monkeypatch.setattr(nw_kernel, "fill", refuse)
    monkeypatch.setattr(nw_kernel, "fill_reference", refuse)
    monkeypatch.setattr(api, "auto_device_min_cells", lambda: 0)
    rng = random.Random(5)
    t, o = random_pair(rng, 40, 50)
    got = perform_alignment(t, o, backend=backend, device="cpu")
    assert got == jax_align(t, o, backend="host")


def test_device_routes_by_scoring_form():
    """Integer match/mismatch takes the kernel route, callable and
    non-integer scoring the plain wavefront."""
    assert (api._device_align_ops(resolve_scoring(None))
            is nw_torch.align_ops)
    assert (api._device_align_ops(resolve_scoring(None, strict=False))
            is nw_torch.align_ops)
    for system in (FORMS["callable"][0], FORMS["float"][0]):
        assert (api._device_align_ops(resolve_scoring(system))
                is nw_torch.align_ops_plain)


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        perform_alignment(list("ab"), list("ab"), backend="jax")


def test_align_pairs_matches_jax():
    """align_pairs(min_device_cells=0) on a CPU device equals
    align_pairs_jax(min_device_cells=0), over two buckets."""
    rng = random.Random(11)
    pairs = [random_pair(rng, n, m) for n, m in
             [(8, 40), (40, 9), (90, 120), (130, 100), (60, 60)]]
    sc = resolve_scoring(None)
    got = nw_torch.align_pairs(pairs, sc, min_device_cells=0, device="cpu")
    assert got == nw_jax.align_pairs_jax(pairs, sc, min_device_cells=0)
    assert got == nw_torch.align_pairs(pairs, sc, device="cpu")  # host fill


def test_align_pairs_leaves_callable_scoring_to_the_caller():
    sc = resolve_scoring(FORMS["callable"][0])
    assert nw_torch.align_pairs([(list("ab"), list("ba"))], sc) == [None]


def test_align_grid_matches_jax():
    """align_grid over 27 rows of the scoring grid equals align_grid_jax,
    in two launches (a budget that holds 20 rows)."""
    rng = random.Random(12)
    t, o = random_pair(rng, 70, 85)
    rows = scoring_grid()[::27]
    assert len(rows) == 27
    old = nw_torch.PTR_BUDGET
    try:
        nw_torch.PTR_BUDGET = 20 * 255 * 128
        got = api.align_grid(t, o, rows, device="cpu")
    finally:
        nw_torch.PTR_BUDGET = old
    assert got == nw_jax.align_grid_jax(t, o, rows)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 2047, 2048, 2049, 2400,
                               2561, 16383, 16384])
def test_bucket_matches_jax(n):
    assert nw_torch._bucket(n) == nw_jax._bucket(n)


@pytest.mark.parametrize("t,o", [("abc d", "ab cd"),
                                 (["ab", "c", "d"], ["c", "ab", "e"])])
def test_token_ids_match_pallas(t, o):
    for mine, theirs in zip(nw_torch._token_ids(list(t), list(o)),
                            pallas_ids(list(t), list(o))):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_ops_matches_jax(seed):
    rng = random.Random(seed)
    t, o = random_pair(rng, 20 + 30 * seed, 50 - 10 * seed)
    t, o = t + [" "], o + [" "]
    ops, k, x, y = nw_torch.align_ops(t, o, resolve_scoring(None), "cpu")
    assert (nw_torch.replay_ops(t, o, ops, k, x, y)
            == nw_jax.replay_ops(t, o, ops, k, x, y))


H100_SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("L", [128, 1024, 2048, 2560, 8192, 16384, 26112,
                               32768])
def test_fill_launch_shape_fits_a_block(L):
    """The fill kernel's plan for every bucket up to the 16383^2 bench
    pair and past the old one-block cap: the segments cover [0, L)
    exactly, each CTA within 1024 threads of whole runs and within one
    block's 227 KB of shared memory; a pair of at most 1024 lanes and the
    729-row grids keep one CTA a pair wherever it fits, and a lone long
    pair spreads over several SMs."""
    for B in (1, 6, 729):
        S, run = nw_kernel.fill_plan(B, L, H100_SMS)
        P = -(-L // S)
        assert (P - 1) * S < L <= P * S
        assert S % run == 0 and S // run <= nw_kernel.MAX_THREADS
        assert nw_kernel.fill_smem_bytes(S, run) <= nw_kernel.SMEM_LIMIT
        if P > 1:
            assert S % 32 == 0
        if B == 729 and L <= 16384:
            assert (S, P) == (L, 1)
        if L <= nw_kernel.MAX_THREADS:
            assert (S, run, P) == (L, 1, 1)
        elif B == 1:
            assert P > 1 and S >= nw_kernel.SEG_FLOOR and P <= H100_SMS
    assert nw_kernel.fill_plan(1, 8192, H100_SMS) == (nw_kernel.SEG_FLOOR, 1)


def test_check_fill_takes_long_transcripts():
    """A 26,000-element transcript (L = 26,112) passes the shape checks:
    the fill has no length cap."""
    t = torch.zeros((1, 26112), dtype=torch.int32)
    o = torch.zeros((1, 2048), dtype=torch.int32)
    row = torch.zeros((1, 8), dtype=torch.int32)
    assert nw_kernel._check_fill("nw_fill", t, o, row) == (1, 26112, 2048)
    S, run = nw_kernel.fill_plan(1, 26112, H100_SMS)
    assert -(-26112 // S) <= H100_SMS and S >= nw_kernel.SEG_FLOOR


# (registers, spill bytes, most threads) of each group-route instantiation
# for one shared transcript and OCR row, as ta_nw_group_attrs reads them
# from the library nvcc builds for sm_90a (ptxas -v, PERF.md).
GROUP_ATTRS = {(1, 1): (31, 0, 1024), (1, 2): (60, 0, 1024),
               (1, 4): (76, 0, 768), (2, 1): (50, 0, 1024),
               (2, 2): (69, 0, 896), (2, 4): (118, 0, 512),
               (4, 1): (63, 0, 896), (4, 2): (95, 0, 640),
               (8, 1): (126, 0, 512)}


def _waves(B, plan, attrs, sms):
    run, g, threads = plan
    per_wave = sms * nw_kernel.resident_ctas(threads, attrs[(run, g)][0])
    return -(-(-(-B // g)) // per_wave)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,n,L", [(729, 316, 512), (243, 2401, 2560),
                                   (6, 900, 1024)])
def test_group_plan_runs_the_grids_in_one_wave(sms, B, n, L):
    """The chant grid's launch (729 pairs of 316 x 313 in L = 512), a 2400^2
    grid launch (243 pairs) and a few pairs of one bucket each get a CTA of
    whole warps covering the extent in whole runs that divide L, from an
    instantiation that does not spill, and run in one wave of resident
    CTAs on an H100 (132 SMs) and on a 114-SM part, where one exists: a
    2400^2 launch on 114 SMs would need three of its pairs an SM, which no
    instantiation holds, so it takes the fewest waves there, two."""
    plan = nw_kernel.group_plan(B, n, L, sms, GROUP_ATTRS)
    run, g, threads = plan
    assert (run, g) in nw_kernel.GROUPS and L % run == 0
    assert threads % 32 == 0 and (threads - 32) * run < n <= threads * run
    assert threads <= GROUP_ATTRS[(run, g)][2]
    fewest = min(_waves(B, (r, gg, -(-n // (32 * r)) * 32), GROUP_ATTRS, sms)
                 for r, gg in nw_kernel.GROUPS
                 if -(-n // (32 * r)) * 32 <= GROUP_ATTRS[(r, gg)][2])
    assert _waves(B, plan, GROUP_ATTRS, sms) == fewest
    assert fewest == (2 if (B, sms) == (243, 114) else 1)


def test_group_plan_forced_and_ragged():
    """Forced G and run are kept; a G that does not divide B leaves a
    ragged last CTA (ceil(B / G) CTAs), still in one wave at the grid."""
    for g in (1, 2, 4):
        run, gg, threads = nw_kernel.group_plan(729, 316, 512, 132,
                                                GROUP_ATTRS, g=g)
        assert gg == g and threads * run >= 316
    assert nw_kernel.group_plan(729, 316, 512, 132, GROUP_ATTRS, run=4,
                                g=2)[:2] == (4, 2)
    plan = nw_kernel.group_plan(7, 300, 512, 132, GROUP_ATTRS, g=4)
    assert plan[1] == 4 and _waves(7, plan, GROUP_ATTRS, 132) == 1


def test_group_plan_refuses():
    """No plan for an extent past every instantiation's threads x run, a
    G or run that is not built, or a run that does not divide L; an
    instantiation that spills is never taken."""
    assert nw_kernel.group_plan(243, 8 * 512 + 1, 16384, 132,
                                GROUP_ATTRS) is None
    assert nw_kernel.group_plan(729, 316, 512, 132, GROUP_ATTRS,
                                g=3) is None
    assert nw_kernel.group_plan(729, 316, 512, 132, GROUP_ATTRS,
                                run=16) is None
    assert nw_kernel.group_plan(4, 90, 100, 132, GROUP_ATTRS,
                                run=8) is None
    spills = {k: (v[0], 64 if k != (2, 1) else 0, v[2])
              for k, v in GROUP_ATTRS.items()}
    assert nw_kernel.group_plan(729, 316, 512, 132, spills)[:2] == (2, 1)
    assert nw_kernel.group_plan(729, 316, 512, 132, spills,
                                g=2) is None


def test_align_grid_cuts_equal_launches(monkeypatch):
    """A grid whose rows overflow one launch's pointer budget is cut into
    launches of equal rows (27 rows under a budget of 10: 9 + 9 + 9, not
    10 + 10 + 7), each one transcript and one OCR row with the pair's
    sizes, and still equals nw_jax.align_grid_jax."""
    rng = random.Random(13)
    t, o = random_pair(rng, 70, 85)
    rows = scoring_grid()[::27]
    monkeypatch.setattr(nw_torch, "PTR_BUDGET", 10 * 255 * 128)
    seen = []
    fill = nw_kernel.fill_batched

    def spy(tt, oo, pr, nts=None, nos=None):
        seen.append((tt.shape[0], oo.shape[0], pr.shape[0], list(nts),
                     list(nos)))
        return fill(tt, oo, pr, nts, nos)

    monkeypatch.setattr(nw_kernel, "fill_batched", spy)
    got = api.align_grid(t, o, rows, device="cpu")
    assert seen == [(1, 1, 9, [71], [86])] * 3
    assert got == nw_jax.align_grid_jax(t, o, rows)


def _grid_wire(t, o, rows, monkeypatch):
    """align_grid's alignments of (t, o) under ``rows`` on the CPU and the
    host wire it replayed them from."""
    wires = []
    replay_rows = nw_torch.replay_rows

    def spy(transcript, ocr, wire):
        wires.append(wire.copy())
        return replay_rows(transcript, ocr, wire)

    monkeypatch.setattr(nw_torch, "replay_rows", spy)
    got = nw_torch.align_grid(t, o, rows, device="cpu")
    monkeypatch.undo()
    return got, wires[0]


def _live(wire):
    """The distinct live parts [k, xpt, ypt, ops[:k]] of a wire's rows."""
    return {tuple(row[:3 + row[0]]) for row in wire.tolist()}


# (case, rows of the scoring grid, distinct live parts: None where the
# test counts them from the wire)
GROUPING = [("duplicates", slice(None, None, 27), None),
            ("distinct", slice(0, 6), 6),
            ("ops_past_k", slice(0, 1), 1)]


@pytest.mark.parametrize("case,rows,distinct", GROUPING,
                         ids=[c[0] for c in GROUPING])
def test_align_grid_replays_each_distinct_wire_once(case, rows, distinct,
                                                    monkeypatch):
    """align_grid replays each distinct live part of the wire once: every
    row equals replay_ops on its own wire and align_grid_jax, no two rows
    share a list, and mutating a row's lists leaves every other row as it
    was. ``ops_past_k``: rows whose wires differ only past k (the ops'
    padding and the walk's counts in the last slots) share one replay."""
    rng = random.Random(12)
    t, o = random_pair(rng, 70, 85)
    rows = scoring_grid()[rows]
    got, wire = _grid_wire(t, o, rows, monkeypatch)
    transcript, ocr = t + [" "], o + [" "]
    if case == "ops_past_k":
        k = int(wire[0, 0])
        wire = np.repeat(wire, 3, axis=0)
        wire[1, 3 + k:] = np.arange(wire.shape[1] - 3 - k) % 3
        wire[2, 3 + k:] = -7
        rows = np.repeat(rows, 3, axis=0)
        assert len({w.tobytes() for w in wire}) == 3
    calls = []
    replay_ops = nw_torch.replay_ops

    def counted(*args):
        calls.append(args[3])
        return replay_ops(*args)

    monkeypatch.setattr(nw_torch, "replay_ops", counted)
    if case == "ops_past_k":
        got = nw_torch.replay_rows(transcript, ocr, wire)
    else:
        got = nw_torch.align_grid(t, o, rows, device="cpu")
    monkeypatch.undo()
    live = _live(wire)
    assert len(calls) == len(live)
    if distinct is None:
        assert 1 < len(live) < len(rows)
    else:
        assert len(live) == distinct
    ops, k, xpt, ypt = nw_torch.unwire(wire)
    want = [nw_torch.replay_ops(transcript, ocr, ops[b], int(k[b]),
                                int(xpt[b]), int(ypt[b]))
            for b in range(len(wire))]
    assert got == want == nw_jax.align_grid_jax(t, o, rows)
    lists = [id(x) for pair in got for x in pair]
    assert len(set(lists)) == len(lists) == 2 * len(rows)
    for b in range(len(got)):  # mutate each row in turn
        got[b][0].append("#")
        got[b][1].clear()
        assert got[b + 1:] == want[b + 1:]


def test_replay_rows_raises_where_a_stream_ends_off_its_tail(monkeypatch):
    """A row whose op stream ends off its walk's tail raises replay_ops'
    RuntimeError, after rows that share another row's replay."""
    rng = random.Random(12)
    t, o = random_pair(rng, 70, 85)
    _, wire = _grid_wire(t, o, scoring_grid()[:2], monkeypatch)
    transcript, ocr = t + [" "], o + [" "]
    bad = wire[1].copy()
    bad[1] += 1  # the walk's xpt tail
    wire = np.stack([wire[0], wire[1], wire[0], bad, wire[1]])
    ops, k, xpt, ypt = nw_torch.unwire(bad)
    with pytest.raises(RuntimeError) as want:
        nw_torch.replay_ops(transcript, ocr, ops, int(k), int(xpt), int(ypt))
    with pytest.raises(RuntimeError) as got:
        nw_torch.replay_rows(transcript, ocr, wire)
    assert str(got.value) == str(want.value)
    assert "NW op stream ends at" in str(got.value)


def test_cpu_dispatcher_takes_and_ignores_sizes():
    """On CPU tensors fill_batched takes the pair sizes and returns the
    plain version's whole bucket, byte for byte, whatever the sizes."""
    rng = random.Random(14)
    t, o, nts, nos = _bucket_batch([random_pair(rng, 50, 90),
                                    random_pair(rng, 100, 20)])
    row = torch.from_numpy(nw_torch.kernel_params(resolve_scoring(None))[None])
    whole = nw_kernel.fill_reference(t, o, row)
    for sizes in ((nts, nos), (nts[:1], nos[:1]), ([5, 5], [3, 3])):
        assert torch.equal(nw_kernel.fill_batched(t, o, row, *sizes), whole)


def _max3(a, b, c):
    v01 = np.maximum(a, b)
    p01 = np.where(a >= b, 0, 1)
    return np.maximum(v01, c), np.where(v01 >= c, p01, 2)


def segmented_fill(t, o, row, S):
    """The fill kernel's segment hand-off on the CPU: one pair's wavefront
    one segment of S lanes at a time, in int32, with the kernel's state (a
    lane's m, x, y and carried OCR id at d-1, its max3 and argmax at d-2).
    Segment k runs diagonals [kS, min(D, kS + S - 1 + NoP)); its first
    lane's left neighbour at diagonal d is segment k-1's record of
    diagonal d - 1 (its last lane after that diagonal), or the neutral
    record past the diagonals segment k-1 ran. Returns (D, L) uint8; cells
    outside 0 <= j < NoP hold what this model left there."""
    neg = np.int32(nw_kernel.INT_NEG)
    L, NoP = len(t), len(o)
    D = L + NoP - 1
    match, mismatch, gox, goy, gex, gey, bge_r0, bge_c0 = (
        np.int32(v) for v in row)
    out = np.zeros((D, L), np.uint8)
    rec = None
    for k in range(-(-L // S)):
        lanes = np.arange(k * S, min(k * S + S, L))
        n = len(lanes)
        m1, x1, y1 = (np.full(n, neg, np.int32) for _ in range(3))
        o1 = np.zeros(n, np.int32)
        best, barg = np.full(n, neg, np.int32), np.zeros(n, np.int32)
        d0 = k * S
        d_end, rec_end = min(D, d0 + S - 1 + NoP), min(D, d0 - 1 + NoP)
        new = np.zeros((D, 6), np.int32)
        for d in range(d0, d_end):
            if k == 0:
                left = (neg, neg, neg, o[d] if d < NoP else 0, neg, 0)
            elif d - 1 < rec_end:
                left = rec[d - 1]
            else:
                left = (neg, neg, neg, 0, neg, 0)
            lm, lx, ly, lo, lb, la = (
                np.concatenate([[v], a[:-1]]).astype(np.int32)
                for v, a in zip(left, (m1, x1, y1, o1, best, barg)))
            s = np.where(t[lanes] == lo, match, mismatch).astype(np.int32)
            m_int = lb + s
            y_int, yp = _max3(m1 + goy + gey, x1 + goy + gey, y1 + gey)
            x_int, xp = _max3(lm + gox + gex, lx + gex, ly + gox + gex)
            best, barg = _max3(m1, x1, y1)
            j = (d - lanes).astype(np.int32)
            row0, col0 = lanes == 0, (j == 0) & (lanes > 0)
            invalid = (j < 0) | (j >= NoP)
            lane32 = lanes.astype(np.int32)
            mv = np.where(row0, bge_r0 * j,
                          np.where(col0, bge_c0 * lane32, m_int))
            xv = np.where(row0, bge_r0 * j, np.where(col0, neg, x_int))
            yv = np.where(row0, neg, np.where(col0, bge_c0 * lane32, y_int))
            m1, x1, y1 = (np.where(invalid, neg, v).astype(np.int32)
                          for v in (mv, xv, yv))
            o1 = lo
            out[d, lanes] = la | (xp << 2) | (yp << 4)
            new[d] = (m1[-1], x1[-1], y1[-1], o1[-1], best[-1], barg[-1])
        rec = new
    return out


@pytest.mark.parametrize("n,m,S", [(100, 40, 8), (200, 60, 32),
                                   (200, 60, 48), (40, 200, 16),
                                   (130, 250, 64)])
def test_segment_hand_off_matches_fill(n, m, S):
    """The kernel's hand-off between segments (records of diagonal d - 1
    for the m/x/y/OCR neighbour, of d - 2 for the mat candidates; dead
    diagonals skipped; the neutral record past the left segment's end),
    modelled on the CPU with small forced S (S = 48 leaves a ragged last
    segment), gives fill_reference's and nw_jax's XLA scan's pointer bytes
    on every valid cell, on pairs whose L and NoP differ."""
    rng = random.Random(n * 31 + m + S)
    tp, op = random_pair(rng, n, m)
    tp, op = tp + [" "], op + [" "]
    sc = resolve_scoring([7, -3, -5, -6, -2, -1])
    t, o, nts, nos = _bucket_batch([(tp[:-1], op[:-1])])
    row = nw_torch.kernel_params(sc)
    got = segmented_fill(t[0].numpy(), o[0].numpy(), row, S)
    ref = nw_kernel.fill_reference(t, o, torch.from_numpy(row[None]))[0]
    Nt, No = int(nts[0]), int(nos[0])
    assert -(-t.shape[1] // S) > 1
    np.testing.assert_array_equal(valid_cells(got, Nt, No),
                                  valid_cells(ref.numpy(), Nt, No))
    np.testing.assert_array_equal(
        valid_cells(got, Nt, No),
        valid_cells(nw_jax.fill_jax_packed(tp, op, sc), Nt, No))


def group_fill(t, o, params, nts, nos, run, G, threads):
    """The group route of the fill kernel on the CPU: CTAs of G pairs and
    ``threads`` threads of ``run`` lanes, each thread's m, x, y at d-1 and
    max3 and argmax at d-2 for its lanes and the G pairs, its left neighbour
    the previous thread's last lane after diagonal d-1 (lane -1: NEG and the
    OCR id of j = d), across warps the double-buffered warp edge record the
    previous warp's last thread wrote on the last diagonal of that parity
    on which its warp ran, a CTA stopping after max(Nt + No) - 2, a run
    updated only on a diagonal where it holds a cell of some pair's extent,
    a warp with no such run skipping the diagonal (its edge too), the
    boundary overwrites only where some lane is not interior (which the
    model checks), and a run stored only where it holds a cell of that
    pair. ``t``, ``o``, ``params``, ``nts``, ``nos`` have 1 or B rows.
    Returns (B, D, L) uint8, 0xFF where nothing was stored."""
    neg = nw_kernel.INT_NEG
    B = max(len(t), len(o), len(params))
    L, NoP = t.shape[1], o.shape[1]
    D = L + NoP - 1
    out = np.full((B, D, L), 0xFF, np.uint8)
    i0 = np.arange(threads) * run
    lanes = i0[:, None] + np.arange(run)[None, :]  # (T, run)

    def row(a, b):
        return a[0 if len(a) == 1 else b]

    for b0 in range(0, B, G):
        bs = [min(b0 + g, B - 1) for g in range(G)]
        nt = np.array([row(nts, b) if b0 + g < B else 0
                       for g, b in enumerate(bs)], np.int64)
        no = np.array([row(nos, b) if b0 + g < B else 0
                       for g, b in enumerate(bs)], np.int64)
        sc = np.stack([row(params, b) for b in bs]).astype(np.int64)
        match, mismatch, gox, goy, gex, gey, r0, c0 = (
            sc[:, k][:, None] for k in range(8))
        tid = np.stack([np.where(lanes < L, row(t, b)[np.minimum(lanes,
                                                                 L - 1)], 0)
                        for b in bs])  # (G, T, run)
        orow = np.stack([row(o, b) for b in bs])  # (G, NoP)
        m, x, y, bb = (np.full((G, threads, run), neg, np.int64)
                       for _ in range(4))
        ba = np.zeros((G, threads, run), np.int64)
        oc = np.zeros((G, threads, run), np.int64)
        nwarps = threads // 32
        # [parity][field][G, warp]: m, x, y, max3, argmax, OCR id
        edge = np.zeros((2, 6, G, nwarps), np.int64)
        edge[:, :4] = neg
        for d in range(int((nt + no - 1).max())):
            jb = d - i0
            holds = (i0[None] < nt[:, None]) & (jb >= 0)[None] & (
                (jb - (run - 1))[None] < no[:, None])  # (G, T)
            live = holds.any(0)
            warp_live = live.reshape(nwarps, 32).any(1)
            fields = (m, x, y, bb, ba, oc)
            nb_ = [np.concatenate([np.full((G, 1), neg if f < 4 else 0),
                                   a[:, :-1, -1]], 1)
                   for f, a in enumerate(fields)]
            firsts = np.arange(1, nwarps) * 32  # a warp's first thread
            for f in range(6):
                nb_[f][:, firsts] = edge[(d + 1) % 2, f][:, :-1]
            nb_[5][:, 0] = orow[:, d] if d < NoP else 0
            nid = nb_.pop()
            interior = (jb >= run) & (i0 >= 1) & (jb[None] < no[:, None]).all(0)
            word = np.zeros((G, threads, run), np.int64)
            new = [a.copy() for a in (m, x, y, bb, ba)]
            for r in range(run - 1, -1, -1):
                if r:
                    lm, lx, ly, lb, la = (a[:, :, r - 1] for a in (m, x, y, bb,
                                                                   ba))
                    lo = oc[:, :, r - 1]
                else:
                    lm, lx, ly, lb, la = nb_
                    lo = nid
                i = lanes[:, r][None]
                j = (d - lanes[:, r])[None]
                s = np.where(tid[:, :, r] == lo, match, mismatch)
                m_int = lb + s
                y_int, yp = _max3(m[:, :, r] + goy + gey, x[:, :, r] + goy + gey,
                                  y[:, :, r] + gey)
                x_int, xp = _max3(lm + gox + gex, lx + gex, ly + gox + gex)
                bv, av = _max3(m[:, :, r], x[:, :, r], y[:, :, r])
                bad = (j < 0) | (j >= no[:, None])
                row0, col0 = i == 0, j == 0
                # an interior run has no boundary cell of any pair
                assert not (interior[None] & (bad | row0 | col0)).any()
                mv = np.where(bad, neg, np.where(row0, r0 * j, np.where(
                    col0, c0 * i, m_int)))
                xv = np.where(bad, neg, np.where(row0, r0 * j, np.where(
                    col0, neg, x_int)))
                yv = np.where(bad, neg, np.where(row0, neg, np.where(
                    col0, c0 * i, y_int)))
                for a, v in zip(new, (mv, xv, yv, bv, av)):
                    a[:, :, r] = np.where(live[None], v, a[:, :, r])
                word[:, :, r] = la | (xp << 2) | (yp << 4)
            m, x, y, bb, ba = new
            shifted = np.concatenate([nid[:, :, None], oc[:, :, :-1]], 2)
            oc = np.where(live[None, :, None], shifted, oc)
            lasts = np.arange(nwarps) * 32 + 31
            for f, a in enumerate((m, x, y, bb, ba, oc)):
                edge[d % 2, f] = np.where(warp_live[None], a[:, lasts, -1],
                                          edge[d % 2, f])
            for g in range(G):
                if b0 + g >= B:
                    continue
                for k in np.nonzero(holds[g] & live)[0]:
                    out[b0 + g, d, i0[k]:i0[k] + run] = word[g, k]
    return out


def _mode_inputs(mode, seed, B=5):
    """t, o, params (numpy int32), nts, nos and the pairs of one of the
    batched fill's modes, in one bucket: "shared_row" (own transcripts and
    OCR rows, one scoring row), "per_pair_shared_feed" (one transcript and
    one OCR row, a scoring row a pair: the grid) and "own_feeds" (own
    rows and a scoring row a pair)."""
    rng = random.Random(seed)
    if mode == "per_pair_shared_feed":
        pairs = [random_pair(rng, 90, 110)]
    else:
        pairs = [random_pair(rng, 30 + 17 * k, 120 - 19 * k)
                 for k in range(B)]
    t, o, nts, nos = nw_torch.lane_batch([(a + [" "], b + [" "])
                                          for a, b in pairs])
    nr = np.random.default_rng(seed)
    rows = np.concatenate([nr.integers(1, 12, (B, 1)),
                           -nr.integers(0, 10, (B, 5)),
                           np.full((B, 2), -1)], axis=1)
    if mode == "shared_row":
        rows = rows[:1]
    return t, o, rows.astype(np.int32), nts, nos, pairs


BATCH_MODES = ["shared_row", "per_pair_shared_feed", "own_feeds"]


@pytest.mark.parametrize("mode", BATCH_MODES)
@pytest.mark.parametrize("run,G", [(1, 1), (1, 4), (2, 2), (2, 4), (4, 1),
                                   (4, 2), (8, 1)])
def test_group_route_model_matches_fill(mode, run, G):
    """The group route modelled on the CPU (``group_fill``), with 5 pairs
    in groups of G (a ragged last group where G does not divide 5), at each
    (run, G) of nw_kernel.GROUPS and CTAs shaped by the largest Nt (several
    warps at run 1 and 2), gives fill_reference's
    pointer bytes on every valid cell, stores no byte of a row past L, and
    checks on every diagonal that a run it takes as interior holds no
    boundary cell."""
    t, o, rows, nts, nos, _ = _mode_inputs(mode, run * 10 + G)
    threads = -(-int(nts.max()) // (32 * run)) * 32
    got = group_fill(t, o, rows, nts, nos, run, G, threads)
    ref = nw_kernel.fill_reference(torch.from_numpy(t), torch.from_numpy(o),
                                   torch.from_numpy(rows)).numpy()
    for b in range(ref.shape[0]):
        Nt, No = int(nts[0 if len(nts) == 1 else b]), int(
            nos[0 if len(nos) == 1 else b])
        np.testing.assert_array_equal(valid_cells(got[b], Nt, No),
                                      valid_cells(ref[b], Nt, No))


@pytest.mark.parametrize("mode", BATCH_MODES)
def test_valid_cells_do_not_depend_on_the_padding(mode):
    """The extent is exact: fill_reference on a bucket whose padding (ids
    past Nt and No) is random gives, on every valid cell, the bytes of
    fill_reference on the exact-size tensors (L = Nt, NoP = No) and of
    nw_jax.fill_jax_packed, so a fill may stop at each pair's extent."""
    t, o, rows, nts, nos, pairs = _mode_inputs(mode, 40)
    nr = np.random.default_rng(41)
    for a, n in ((t, nts), (o, nos)):
        for b in range(len(a)):
            a[b, n[0 if len(n) == 1 else b]:] = nr.integers(
                0, 2**20, a.shape[1] - n[0 if len(n) == 1 else b])
    B = max(len(t), len(o), len(rows))
    got = nw_kernel.fill_batched(torch.from_numpy(t), torch.from_numpy(o),
                                 torch.from_numpy(rows), nts, nos).numpy()
    for b in range(B):
        k = 0 if len(pairs) == 1 else b
        Nt, No = int(nts[k]), int(nos[k])
        tb, ob = t[0 if len(t) == 1 else b], o[0 if len(o) == 1 else b]
        row = rows[0 if len(rows) == 1 else b]
        exact = nw_kernel.fill_reference(
            torch.from_numpy(tb[None, :Nt].copy()),
            torch.from_numpy(ob[None, :No].copy()),
            torch.from_numpy(row[None])).numpy()[0]
        np.testing.assert_array_equal(valid_cells(got[b], Nt, No),
                                      valid_cells(exact, Nt, No))
        ta, oa = pairs[k]
        ref = nw_jax.fill_jax_packed(ta + [" "], oa + [" "],
                                     resolve_scoring(list(row[:6])))
        np.testing.assert_array_equal(valid_cells(got[b], Nt, No),
                                      valid_cells(ref, Nt, No))


def _jax_walks(packed, nts, nos):
    """[k, xpt, ypt, ops[:k]] of nw_jax._traceback_ops, pair by pair."""
    P = packed.shape[1] + 1
    out = []
    for b in range(packed.shape[0]):
        ops, k, x, y = (np.asarray(v) for v in nw_jax._traceback_ops(
            jnp.asarray(packed[b]), jnp.int32(nts[b]), jnp.int32(nos[b]), P))
        out.append((int(k), int(x), int(y), ops[:int(k)]))
    return out


def _assert_wire_is(wire, walks):
    for b, (k, x, y, ops) in enumerate(walks):
        assert tuple(wire[b, :3]) == (k, x, y)
        np.testing.assert_array_equal(wire[b, 3:3 + k], ops)


def _tb_pairs(case):
    """(transcript, ocr) pairs (sentinels not included) of one model case."""
    rng = random.Random(TB_CASES.index(case))
    base = [rng.choice("abcdefg") for _ in range(300)]
    if case == "diagonal":
        return [(base, list(base))]
    if case == "random":
        return [random_pair(rng, 260, 240)]
    if case == "y_gap_run":  # 70 OCR characters inserted: a y-gap run
        junk = [rng.choice("xyz") for _ in range(70)]
        return [(base, base[:150] + junk + base[150:])]
    if case == "x_gap_run":  # 70 transcript characters the OCR lacks
        junk = [rng.choice("xyz") for _ in range(70)]
        return [(base[:150] + junk + base[150:], base)]
    if case == "full_buckets":  # Nt = L, No = NoP: the end cell at (D-1, L-1)
        return [random_pair(rng, 127, 127)]
    if case == "one":  # Nt or No of 1: no step
        return [([], list("abc")), (list("abcd"), []), ([], [])]
    assert case == "mixed"
    return [random_pair(rng, n, m) for n, m in
            [(200, 90), (40, 250), (255, 255), (0, 17), (120, 3)]]


TB_CASES = ["diagonal", "random", "y_gap_run", "x_gap_run", "full_buckets",
            "one", "mixed"]


@pytest.mark.parametrize("case", TB_CASES)
def test_window_schedule_matches_jax_and_pallas(case):
    """The kernel's window schedule, modelled on the CPU with windows shrunk
    to 24 x 12 so that the walk hops dozens of times, gives nw_jax's
    _traceback_ops and the Pallas tile-hopping kernel (interpret mode) on
    every pair: exits through both edges, origins clamped at 0 and windows
    whose top is the last diagonal and lane, a gap run that the slope
    prediction misses, Nt or No of 1, and a mixed-length batch."""
    pairs = _tb_pairs(case)
    t, o, nts, nos = _bucket_batch(pairs)
    sc = resolve_scoring(None)
    row = torch.from_numpy(nw_torch.kernel_params(sc)[None])
    packed = nw_kernel.fill_batched(t, o, row).numpy()
    wire, log = windowed_walk(packed, nts, nos, **TB_SMALL)
    walks = _jax_walks(packed, nts, nos)
    _assert_wire_is(wire, walks)
    D, L = packed.shape[1:]
    p_ops, p_k, p_x, p_y = (np.asarray(v) for v in
                            nw_pallas.traceback_ops_pallas_batched(
                                jnp.asarray(packed), nts, nos, D + 1, L,
                                interpret=True))
    _assert_wire_is(wire, [(int(p_k[b]), int(p_x[b]), int(p_y[b]),
                            p_ops[b, :int(p_k[b])])
                           for b in range(len(pairs))])
    windows, misses = wire[:, -2], wire[:, -1]
    edges = {e for pair_edges, _ in log for e in pair_edges}
    origins = [o for _, pair_origins in log for o in pair_origins]
    long = wire[:, 0] > 100
    assert windows[long].min(initial=10) >= 10
    if case == "one":
        assert wire[:, 0].tolist() == [0, 0, 0] and windows.sum() == 0
    elif case == "diagonal":  # two rows a step: the lane edge binds
        assert edges == {"i"} and misses.sum() == 0
        assert any(d0 == 0 for d0, _ in origins)
        assert any(i0 == 0 for _, i0 in origins)
    elif case == "full_buckets":
        assert (D - TB_SMALL["TH"], L - TB_SMALL["TW"]) in origins
    else:
        assert edges == {"d", "i"} and misses.sum() >= 1


def test_window_schedule_at_the_kernel_size():
    """At the kernel's own window (256 x 128, blocks of 16) the model gives
    the plain walk's wire on pairs long enough to hop, and a diagonal path
    takes one window per ~100 steps with no miss."""
    rng = random.Random(17)
    base = [rng.choice("abcdefg") for _ in range(1500)]
    pairs = [(base, list(base)), random_pair(rng, 1200, 1400),
             (base, base[:700] + ["z"] * 300 + base[700:])]
    t, o, nts, nos = _bucket_batch(pairs)
    row = torch.from_numpy(nw_torch.kernel_params(resolve_scoring(None))[None])
    packed = nw_kernel.fill_batched(t, o, row)
    ref = nw_kernel.traceback_reference(packed, torch.from_numpy(nts),
                                        torch.from_numpy(nos)).numpy()
    wire, _ = windowed_walk(packed.numpy(), nts, nos, **TB_KERNEL)
    assert np.array_equal(wire[:, :3], ref[:, :3])
    for b in range(len(pairs)):
        np.testing.assert_array_equal(wire[b, 3:3 + wire[b, 0]],
                                      ref[b, 3:3 + ref[b, 0]])
    assert 10 <= wire[0, -2] <= wire[0, 0] // 80 + 2 and wire[0, -1] == 0
    assert wire[2, -1] >= 1


@pytest.mark.parametrize("case,U", [("diagonal", 2), ("random", 4),
                                    ("y_gap_run", 4), ("x_gap_run", 4),
                                    ("mixed", 4)])
def test_window_schedule_fails_with_one_more_safe_step(case, U):
    """The safe-step count is tight: one step more and the walk reads a
    cell outside its window. Whole blocks of U steps take the extra step
    only when it completes a block, which the diagonal path's windows never
    do at U = 4, so that path is checked at U = 2."""
    t, o, nts, nos = _bucket_batch(_tb_pairs(case))
    row = torch.from_numpy(nw_torch.kernel_params(resolve_scoring(None))[None])
    packed = nw_kernel.fill_batched(t, o, row).numpy()
    cfg = dict(TB_SMALL, U=U)
    _assert_wire_is(windowed_walk(packed, nts, nos, **cfg)[0],
                    _jax_walks(packed, nts, nos))
    with pytest.raises(WindowEscape):
        windowed_walk(packed, nts, nos, extra=1, **cfg)


@pytest.mark.parametrize("bad", ["sizes", "dtype", "rank"])
def test_traceback_rejects_bad_inputs(bad):
    packed = torch.zeros((1, 255, 128), dtype=torch.uint8)
    nts = torch.tensor([10], dtype=torch.int32)
    nos = torch.tensor([10], dtype=torch.int32)
    if bad == "sizes":
        nos = torch.tensor([200], dtype=torch.int32)
    elif bad == "dtype":
        nts = nts.long()
    else:
        packed = packed[0]
    with pytest.raises(ValueError):
        nw_kernel.traceback_batched(packed, nts, nos)


def test_grid_search_matches_jax():
    """The port's grid_search with the device grid fill on a CPU device
    gives the JAX package's grid_search(grid_align="device") log, and the
    port's host route the same."""
    page = make_page(np.random.default_rng(21), n_lines=3,
                     words_per_line=2)
    inj = ocr_with_spaces(corrupt_ocr(np.random.default_rng(4),
                                      page.char_boxes))
    gt = [{"syl": c.char, "difficult": 0,
           "ul": (c.ul[0] - 2, c.ul[1] - 2), "lr": (c.lr[0] + 2, c.lr[1] + 2)}
          for c in page.char_boxes[:8]]
    fixtures = [{"raw_image": page.image, "transcript": page.transcript,
                 "gt_boxes": gt, "existing_ocr": inj,
                 "preproc_params": SYNTH_PARAMS}]
    rows = scoring_grid()[::81]
    assert len(rows) == 9
    kw = dict(shuffle=False, backend="host", verbose=False, params_list=rows)
    ref, ref_ranked = jax_grid_search(fixtures, grid_align="device", **kw)
    got, ranked = grid_search(fixtures, grid_align="device", device="cpu",
                              **kw)
    assert got == ref and ranked == ref_ranked
    host, _ = grid_search(fixtures, grid_align="host", device="cpu", **kw)
    assert host == ref
