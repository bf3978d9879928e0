"""The port's CC (``ops/cc.py``, the plain version the CUDA kernels of
``csrc/cc_filter.cu`` are held to) against the JAX package's
``ops/cc_pallas.py`` (the Pallas kernel in interpret mode, as
tests/test_cc_pallas.py runs it) and against ``ops/oracle.py``, on seeded
numpy pages: every filter mode at k in {0, 3, 25, 175}, the by-area mode,
the cleanup chain, the table at several thresholds, and both overflows.
Pages are byte-identical; tables, counts and ok flags are equal.

The JAX kernel is compiled once per page geometry, so the parity cases
share one shape (64 x 90); the oracle cases cover odd widths."""

import numpy as np
import pytest
import torch

from text_alignment_tpu.ops import cc_pallas, oracle
from text_alignment_tpu_torch.ops import cc

torch.set_num_threads(1)

R = 4096  # run capacity of the parity cases (both packages)


def _parity_pages():
    rng = np.random.default_rng(0)
    bars = np.zeros((64, 90), bool)
    bars[:, ::3] = True
    bars[30, :] = True
    rings = np.zeros((64, 90), bool)
    for r in range(0, 30, 4):
        rings[r, r:90 - r] = rings[63 - r, r:90 - r] = True
        rings[r:64 - r, r] = rings[r:64 - r, 89 - r] = True
    return {"random25": rng.random((64, 90)) < 0.25,
            "random60": rng.random((64, 90)) < 0.6,
            "bars": bars, "rings": rings}


def _oracle_pages():
    rng = np.random.default_rng(1)
    c = np.zeros((50, 50), bool)
    c[0, 0] = c[0, -1] = c[-1, 0] = c[-1, -1] = True
    return {"W32": rng.random((40, 32)) < 0.3,
            "W33": rng.random((40, 33)) < 0.3,
            "W65": rng.random((23, 65)) < 0.5,
            "empty": np.zeros((70, 64), bool),
            "full": np.ones((66, 95), bool),
            "corners": c}


PARITY = _parity_pages()


def _cpu(fn, *args, **kw):
    return fn(*args, device="cpu", **kw)


@pytest.mark.parametrize("name", list(PARITY))
@pytest.mark.parametrize("k", [0, 3, 25, 175])
def test_filter_modes_match_cc_pallas_and_oracle(name, k):
    img = PARITY[name]
    kt = max(k, 1)
    cases = [
        (cc.despeckle, cc_pallas.despeckle, (k,), {},
         oracle.despeckle(img, k)),
        (cc.despeckle_white, cc_pallas.despeckle_white, (k,), {},
         ~oracle.despeckle(~img, k)),
        (cc.remove_tall_ccs, cc_pallas.remove_tall_ccs, (kt,), {},
         oracle.remove_tall_ccs(img, kt)),
        (cc.remove_tall_ccs, cc_pallas.remove_tall_ccs, (kt,),
         {"by_area": True}, oracle.remove_big_ccs(img, kt)),
    ]
    for port, jax_fn, args, kw, want in cases:
        got, ok = _cpu(port, img, *args, max_runs=R, **kw)
        ref, ok_ref = jax_fn(img, *args, max_runs=R, **kw)
        assert ok and ok_ref
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(PARITY))
def test_packed_filter_pass_matches_cc_pallas(name):
    """The packed entry: painted words (bits past W included), ok and the
    run count equal."""
    import jax.numpy as jnp

    img = PARITY[name]
    H, W = img.shape
    pk = cc.pack_page(img)
    for mode in (cc.MODE_BLACK, cc.MODE_WHITE, cc.MODE_TALL):
        out, ok, n = cc._run_filter(torch.from_numpy(pk), H, W, 9, mode,
                                    max_runs=R)
        ref, ok_ref, n_ref = cc_pallas._run_filter(jnp.asarray(pk), H, W, 9,
                                                   mode, max_runs=R)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert bool(ok) == bool(ok_ref) and int(n) == int(n_ref)


@pytest.mark.parametrize("name", list(_oracle_pages()))
def test_filters_match_oracle_on_odd_shapes(name):
    img = _oracle_pages()[name]
    for k in (0, 3, 25):
        assert (_cpu(cc.despeckle, img, k)[0]
                == oracle.despeckle(img, k)).all()
        assert (_cpu(cc.despeckle_white, img, k)[0]
                == ~oracle.despeckle(~img, k)).all()
        assert (_cpu(cc.remove_tall_ccs, img, k + 1)[0]
                == oracle.remove_tall_ccs(img, k + 1)).all()


@pytest.mark.parametrize("by_area", [False, True])
def test_preproc_clean_matches_cc_pallas(by_area):
    for name, img in PARITY.items():
        got, ok = _cpu(cc.preproc_clean, img, 10, 20, sat_by_area=by_area,
                       max_runs=R)
        ref, ok_ref = cc_pallas.preproc_clean(img, 10, 20,
                                              sat_by_area=by_area,
                                              max_runs=R)
        assert ok and ok_ref
        np.testing.assert_array_equal(got, ref)
        tall = oracle.remove_big_ccs if by_area else oracle.remove_tall_ccs
        want = tall(~oracle.despeckle(~oracle.despeckle(img, 10), 10), 20)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh", [None, 2, 8])
def test_table_matches_cc_pallas_and_oracle(thresh):
    for name, img in PARITY.items():
        tab, count, ok = _cpu(cc.cc_table_compact, img,
                              min_area_keep=thresh, max_ccs=512, max_runs=R)
        tj, cj, okj = cc_pallas.cc_table_compact(img, min_area_keep=thresh,
                                                 max_ccs=512, max_runs=R)
        count = int(count)
        assert bool(ok) and bool(np.asarray(okj))
        assert count == int(np.asarray(cj))
        np.testing.assert_array_equal(tab.numpy()[:count],
                                      np.asarray(tj)[:count])
        _, want = oracle.cc_stats(img)
        if thresh is not None:
            want = want[want[:, 4] > thresh]
        np.testing.assert_array_equal(tab.numpy()[:count], want)
        assert not tab.numpy()[count:].any()


def test_table_count_overflow():
    img = np.zeros((64, 90), bool)
    img[::2, ::2] = True  # 1440 components
    tab, count, ok = _cpu(cc.cc_table_compact, img, max_ccs=100, max_runs=R)
    _, cj, okj = cc_pallas.cc_table_compact(img, max_ccs=100, max_runs=R)
    assert not bool(ok) and not bool(np.asarray(okj))
    assert int(count) == int(np.asarray(cj)) == 100


def test_run_overflow_certificate():
    """More runs than the capacity: ok is 0 in both packages, the count is
    the true run count, and the page is the components of the first R
    runs, identical too."""
    img = np.zeros((64, 90), bool)
    img[::2, ::2] = True  # 1440 single-pixel runs
    for fn in ("despeckle", "despeckle_white"):
        got, ok = _cpu(getattr(cc, fn), img, 0, max_runs=512)
        ref, ok_ref = getattr(cc_pallas, fn)(img, 0, max_runs=512)
        assert not ok and not ok_ref
        np.testing.assert_array_equal(got, ref)
    H, W = img.shape
    _, ok, n = cc._run_filter(torch.from_numpy(cc.pack_page(img)), H, W, 0,
                              cc.MODE_BLACK, max_runs=512)
    assert not bool(ok) and int(n) == 1440
    _, _, ok_t = _cpu(cc.cc_table_compact, img, max_runs=512)
    assert not bool(ok_t)


def test_pack_roundtrip_and_torch_packing():
    rng = np.random.default_rng(3)
    for W in (31, 32, 33, 64, 90, 129):
        img = rng.random((17, W)) < 0.4
        pk = cc.pack_page(img)
        assert pk.shape == (17, -(-W // 32))
        np.testing.assert_array_equal(pk, cc_pallas.pack_page(img))
        np.testing.assert_array_equal(cc.unpack_page(pk, 17, W), img)
        t = torch.from_numpy(img)
        np.testing.assert_array_equal(cc.pack_bool(t).numpy(), pk)
        np.testing.assert_array_equal(
            cc.unpack_bits(torch.from_numpy(pk), W).numpy(), img)


def test_wrappers_reject_bad_pages():
    pk = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError):  # W past the words
        cc.cc_filter(pk, 8, 65, 3, cc.MODE_BLACK)
    with pytest.raises(ValueError):  # H mismatch
        cc.cc_table(pk, 9, 40, 3, 16)
    with pytest.raises(ValueError):  # int64 words
        cc.cc_clean(pk.long(), 8, 40, 3, 5)


@pytest.mark.parametrize("wrapper,args", [
    ("filter_cuda", (5, 70, 3, 0, False, 64)),
    ("table_cuda", (5, 70, 3, 16, 64)),
    ("clean_cuda", (5, 70, 3, 100, False, 64)),
])
def test_kernel_wrappers_hold_scratch_through_the_launch(monkeypatch, wrapper,
                                                         args):
    """A launch wrapper keeps every tensor whose pointer it passes alive
    until the C call returns: a block freed before the call could be handed
    to another thread issuing on the same stream (the batch's OCR worker)
    and written between the kernel's passes. A fake library checks, at the
    call, that the scratch it was given still exists."""
    import weakref

    from text_alignment_tpu_torch import _kernels
    from text_alignment_tpu_torch.ops import cc_kernel

    made = []

    def scratch(page, H, R):
        t = torch.zeros(8, dtype=torch.int32)
        made.append(weakref.ref(t))
        return t

    def launch(*_):
        assert made and made[-1]() is not None, "scratch freed before launch"
        return 0

    class FakeLib:
        ta_cc_filter = ta_cc_table = ta_cc_clean = staticmethod(launch)

    monkeypatch.setattr(cc_kernel, "_scratch", scratch)
    monkeypatch.setattr(_kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(_kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_kernels, "launches", dict(_kernels.launches))
    page = torch.zeros((5, 3), dtype=torch.int32)
    getattr(cc_kernel, wrapper)(page, *args)
    assert len(made) == 1


# ---------------------------------------------------------------------------
# The band design of csrc/cc_filter.cu, modelled on the CPU
# ---------------------------------------------------------------------------

def _row_runs(row):
    """(x0, x1) of the runs of a bool row, left to right."""
    d = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1) - 1


def banded_components(img, R, band, shift=0):
    """The CC kernels' components, computed as their band design does:
    bands of ``band`` rows; each band's first run index from the counts of
    the bands before it (the look-back); the band's rows united alone and
    each run flattened to its band-local root, whose statistics (area, row
    and column spans) the band adds up; then each band's first row united
    with the row above it (``y0 - 1 + shift``: 0 is the kernel's, the tests
    move it to show the model fails); then each band-local root's
    statistics added to its final root, and every run pointed at its
    band-local root's final root. Unions link the larger root under the
    smaller. Returns the kept runs (x0, x1, ry), each run's final root, the
    statistics at the roots, and the run count n."""
    H, W = img.shape
    runs = [_row_runs(img[y]) for y in range(H)]
    counts = np.array([len(r[0]) for r in runs], np.int64)
    nb = -(-H // band)
    band_n = [int(counts[b * band:(b + 1) * band].sum()) for b in range(nb)]
    first = np.concatenate([[0], np.cumsum(band_n)])  # the look-back
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    n = int(rowptr[-1])
    nk = min(n, R)
    x0 = np.concatenate([r[0] for r in runs] + [[]]).astype(np.int64)[:nk]
    x1 = np.concatenate([r[1] for r in runs] + [[]]).astype(np.int64)[:nk]
    ry = np.repeat(np.arange(H), counts)[:nk]
    parent = np.arange(nk)

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        if a != b:
            parent[max(a, b)] = min(a, b)

    def above(i, y):
        """Kept runs of row y overlapping run i's span widened by one."""
        if not 0 <= y < H:
            return []
        return [j for j in range(int(rowptr[y]), min(int(rowptr[y + 1]), nk))
                if x1[j] >= x0[i] - 1 and x0[j] <= x1[i] + 1]

    big = np.iinfo(np.int64).max
    area = np.zeros(nk, np.int64)
    ymin, xmin = np.full(nk, big), np.full(nk, big)
    ymax, xmax = np.full(nk, -1), np.full(nk, -1)
    local = np.arange(nk)
    for b in range(nb):
        y0 = b * band
        lo, hi = min(int(first[b]), nk), min(int(first[b + 1]), nk)
        assert lo == min(int(rowptr[y0]), nk)
        for i in range(min(int(rowptr[y0 + 1]), nk), hi):
            for j in above(i, ry[i] - 1):
                unite(i, j)
        for i in range(lo, hi):
            local[i] = parent[i] = find(i)
        for i in range(lo, hi):
            r = local[i]
            area[r] += x1[i] - x0[i] + 1
            ymin[r], ymax[r] = min(ymin[r], ry[i]), max(ymax[r], ry[i])
            xmin[r], xmax[r] = min(xmin[r], x0[i]), max(xmax[r], x1[i])
    for b in range(1, nb):
        y0 = b * band
        for i in range(int(rowptr[y0]), min(int(rowptr[y0 + 1]), nk)):
            for j in above(i, y0 - 1 + shift):
                unite(i, j)
    roots = np.flatnonzero(local == np.arange(nk))
    final = {int(r): find(r) for r in roots}
    for r, g in final.items():
        if g != r:
            area[g] += area[r]
            ymin[g], ymax[g] = min(ymin[g], ymin[r]), max(ymax[g], ymax[r])
            xmin[g], xmax[g] = min(xmin[g], xmin[r]), max(xmax[g], xmax[r])
    root = np.array([final[int(r)] for r in local], np.int64)
    return x0, x1, ry, root, area, ymin, ymax, xmin, xmax, n


def band_filter(img, k, mode, by_area, R, band, shift=0):
    """One filter pass from :func:`banded_components`: (page, ok)."""
    white = mode == cc.MODE_WHITE
    x0, x1, ry, root, area, ymin, ymax, _, _, n = banded_components(
        ~img if white else img, R, band, shift)
    a = area[root]
    if mode == cc.MODE_BLACK:
        keep = a > k
    elif white:
        keep = a <= k
    else:
        keep = (a if by_area else ymax[root] - ymin[root] + 1) <= k
    out = np.zeros_like(img)
    for i in np.flatnonzero(keep):
        out[ry[i], x0[i]:x1[i] + 1] = True
    return (out | img if white else out), (int(n <= R), n)


def band_table(img, thresh, max_ccs, R, band):
    """The stats table from :func:`banded_components`: (rows, ok)."""
    _, _, _, root, area, ymin, ymax, xmin, xmax, n = banded_components(
        img, R, band)
    roots = [r for r in range(len(root)) if root[r] == r and area[r] > thresh]
    table = np.zeros((max_ccs, 5), np.int64)
    for s, r in enumerate(roots[:max_ccs]):
        table[s] = ymin[r], ymax[r], xmin[r], xmax[r], area[r]
    return table, (int(n <= R and len(roots) <= max_ccs),
                   min(len(roots), max_ccs))


def _band_pages():
    """Pages for the band model: random noise; one tall stroke through
    every band; a staircase diagonal, whose rows meet only through
    8-connectivity; a comb whose teeth, each rooted in the first band, join
    only in the last row; a single row; a page shorter than one band."""
    rng = np.random.default_rng(5)
    stroke = rng.random((64, 90)) < 0.05
    stroke[:, 40:43] = True
    diag = np.zeros((64, 90), bool)
    diag[np.arange(64), np.arange(64) * 4 // 3] = True
    diag[np.arange(64), 89 - np.arange(64)] = True
    comb = np.zeros((64, 90), bool)
    comb[:, 3:88:6] = True
    comb[-1, 3:88] = True
    return {"random30": rng.random((64, 90)) < 0.3, "stroke": stroke,
            "diagonal": diag, "comb": comb,
            "one_row": rng.random((1, 90)) < 0.4,
            "short": rng.random((5, 90)) < 0.4}


BAND_PAGES = _band_pages()


def _plain_filter(img, k, mode, by_area, R):
    H, W = img.shape
    pk = torch.from_numpy(cc.pack_page(img))
    out, ok = cc.filter_reference(pk, H, W, k, mode, by_area, R)
    return cc.unpack_page(out.numpy(), H, W), tuple(ok.tolist())


@pytest.mark.parametrize("band", [3, 8, 12, 64])
@pytest.mark.parametrize("name", list(BAND_PAGES))
def test_band_model_matches_plain_filter_and_table(name, band):
    """Bands of 3, 8 and 12 rows (none divides 64 or 5 but 8 of 64) and of
    64 (the page in one band, or more rows than the page): every filter
    mode and the table equal the plain versions."""
    img = BAND_PAGES[name]
    H, W = img.shape
    for mode, by_area in ((cc.MODE_BLACK, False), (cc.MODE_WHITE, False),
                          (cc.MODE_TALL, False), (cc.MODE_TALL, True)):
        for k in (3, 25):
            got, ok = band_filter(img, k, mode, by_area, 4096, band)
            want, ok_want = _plain_filter(img, k, mode, by_area, 4096)
            np.testing.assert_array_equal(got, want)
            assert ok == ok_want
    pk = torch.from_numpy(cc.pack_page(img))
    for thresh in (-1, 4):
        for max_ccs in (512, 3):
            tab, ok = band_table(img, thresh, max_ccs, 4096, band)
            want, ok_want = cc.table_reference(pk, H, W, thresh, max_ccs,
                                               4096)
            np.testing.assert_array_equal(tab, want.numpy())
            assert ok == tuple(ok_want.tolist())


@pytest.mark.parametrize("name", ["random30", "stroke", "diagonal", "comb"])
def test_band_model_matches_cc_pallas(name):
    """The model against the JAX package's Pallas kernel in interpret mode
    (bands of 7 rows): painted pages, ok, run counts and tables equal."""
    import jax.numpy as jnp

    img = BAND_PAGES[name]
    H, W = img.shape
    pk = jnp.asarray(cc.pack_page(img))
    for mode in (cc.MODE_BLACK, cc.MODE_WHITE, cc.MODE_TALL):
        got, ok = band_filter(img, 9, mode, False, R, 7)
        ref, ok_ref, n_ref = cc_pallas._run_filter(pk, H, W, 9, mode,
                                                   max_runs=R)
        np.testing.assert_array_equal(
            got, cc.unpack_page(np.asarray(ref), H, W))
        assert ok == (int(bool(ok_ref)), int(n_ref))
    tab, ok = band_table(img, 2, 512, R, 7)
    tj, cj, okj = cc_pallas.cc_table_compact(img, min_area_keep=2,
                                             max_ccs=512, max_runs=R)
    count = int(np.asarray(cj))
    assert ok == (int(bool(np.asarray(okj))), count)
    np.testing.assert_array_equal(tab[:count], np.asarray(tj)[:count])


def test_band_model_roots_come_from_the_first_band():
    """The comb's teeth start in the first band and join only in the last
    row: the joined component's root is the first tooth's first run, and
    its area and spans sum every band's share."""
    img = BAND_PAGES["comb"]
    x0, _, ry, root, area, ymin, ymax, xmin, xmax, n = banded_components(
        img, 4096, 8)
    assert set(root.tolist()) == {0}
    assert (ry[0], x0[0]) == (0, 3)
    assert (area[0], ymin[0], ymax[0], xmin[0], xmax[0]) == (
        int(img.sum()), 0, 63, 3, 87)


@pytest.mark.parametrize("band", [5, 8])
def test_band_model_overflow_inside_a_band(band):
    """A run capacity that cuts a band's runs in the middle of a row: ok
    is 0 with the true count, and the pages and tables are those of the
    first R runs, as the plain version's."""
    img = BAND_PAGES["random30"]
    H, W = img.shape
    n_row = [len(_row_runs(img[y])[0]) for y in range(H)]
    R_cut = sum(n_row[:2 * band + 2]) + n_row[2 * band + 2] // 2
    assert (2 * band + 2) % band and n_row[2 * band + 2] > 1
    for mode in (cc.MODE_BLACK, cc.MODE_WHITE, cc.MODE_TALL):
        got, ok = band_filter(img, 3, mode, False, R_cut, band)
        want, ok_want = _plain_filter(img, 3, mode, False, R_cut)
        np.testing.assert_array_equal(got, want)
        assert ok == ok_want and ok[0] == 0
    pk = torch.from_numpy(cc.pack_page(img))
    tab, ok = band_table(img, -1, 512, R_cut, band)
    want, ok_want = cc.table_reference(pk, H, W, -1, 512, R_cut)
    np.testing.assert_array_equal(tab, want.numpy())
    assert ok == tuple(ok_want.tolist()) and ok[0] == 0


@pytest.mark.parametrize("name,shift", [("diagonal", -1), ("diagonal", 1),
                                        ("comb", 1), ("stroke", 1)])
def test_band_model_fails_with_the_boundary_row_off_by_one(name, shift):
    """The model is sharp: uniting a band's first row with the row two
    above it (which a staircase does not touch), or with itself, in place
    of the row just above, gives other pages than the plain version."""
    img = BAND_PAGES[name]
    H, W = img.shape
    differs = False
    for mode in (cc.MODE_BLACK, cc.MODE_TALL):
        got, _ = band_filter(img, 25, mode, False, 4096, 8, shift)
        want, _ = _plain_filter(img, 25, mode, False, 4096)
        differs |= not np.array_equal(got, want)
    assert differs
