"""The port's mesh (text_alignment_tpu_torch/parallel: mesh, infer_dp,
train_dp, multihost) on gloo ranks of the CPU, against the port's own
one-rank runs and against the JAX package's mesh runs.

One module-scoped fixture a world size (2 and 4 ranks; ``data_model_mesh
(4)`` is 2 x 2) spawns the ranks once (``multihost.launch``, a FileStore
under the test's temporary directory, a deadline). Every rank runs the
cases of :func:`_rank_cases` and writes its results to that directory;
the tests read them. The references run in the pytest process: the
port's one-rank calls with ``device="cpu"``, and the JAX package on its
8-device virtual CPU mesh (tests/conftest.py). This module imports no JAX
at its top, since the ranks import it by name.

Bars: the sharded OCR wire, the process_batch JSON, the grid and the NW
pairs are byte-identical to the port's one-rank run; the grid and the
injected-OCR process_batch JSON are byte-identical to the JAX package's
mesh runs; the OCR against the JAX package is held at the bar of
tests/test_torch_slice.py (lengths and t_raw exact on the device path,
rows equal through the host normalizer both packages share); the train
step at the bar of tests/test_parallel.py (loss to 1e-5 relative) and
its gradients to 1e-4 x their global norm.
"""

import functools
import json
import pickle

import numpy as np
import pytest
import torch

from text_alignment_tpu_torch.align.nw_torch import align_pairs
from text_alignment_tpu_torch.align.api import align_grid
from text_alignment_tpu_torch.align.scoring import resolve_scoring
from text_alignment_tpu_torch.evaluate import grid_search, scoring_grid
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lineest_host import DEFAULT_PAD
from text_alignment_tpu_torch.models.lstm import (
    init_params_np, init_params_seeded, params_from_np, params_leaves)
from text_alignment_tpu_torch.models import recognizer as rz
from text_alignment_tpu_torch.models.recognizer import (
    SeqRecognizer, _unpack_wire_rows)
from text_alignment_tpu_torch.models.train import Trainer
from text_alignment_tpu_torch.parallel import (
    data_model_mesh, infer_dp, make_mesh, process_batch)
from text_alignment_tpu_torch.parallel.mesh import axis_size
from text_alignment_tpu_torch.parallel.multihost import (
    assert_same_across_processes, gather_shares, launch)
from text_alignment_tpu_torch.parallel.train_dp import (
    Adam, make_sharded_train_step, sharded_train_demo_step, trainer_recipe,
    unshard)
from text_alignment_tpu_torch.pipeline.preprocess import (
    PreprocParams, identify_text_lines, preprocess_images)
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

torch.set_num_threads(1)

WORLDS = (2, 4)
DEADLINE_S = 300.0
GLOBAL_B = 8                       # the train step's lines, every world
TRAIN_T, TRAIN_NI, TRAIN_NS = 64, 16, 16
DEMO_CHARSET = ["", "~", " ", "a", "b", "c"]
WIRE_REGIONS = 128
GRID_T = "dominus vobiscum et cum spiritu tuo"
GRID_O = "domnus vobiscm et cvm spirjtu tuo"
# the dry run's 9 rows (__graft_entry__.py:205-209): 9 rows pad at 2 and 4
GRID_ROWS = [[8, -4, -7, -7, -3, 0], [5, -4, -2, -2, 0, 0],
             [11, -10, -7, -7, -5, -5], [8, -7, -5, -2, -3, 0],
             [5, -7, -7, -5, 0, -3], [11, -4, -2, -7, -5, 0],
             [8, -10, -5, -5, -3, -3], [5, -10, -2, -5, 0, -5],
             [11, -7, -7, -2, -5, -3]]
PAIR_SIZES = ((50, 60), (120, 110), (30, 200), (300, 280), (130, 140),
              (20, 20))
PAIR_MIN_CELLS = 3000  # the 20 x 20 pair runs the host fill


def peaky_params(seed=0, ni=48, ns=100, nout=29):
    """tests/test_torch_slice.py's weights: lines decode to several
    regions and no argmax is decided by a float tie."""
    rng = np.random.default_rng(seed)
    d = init_params_np(rng, ni, ns, nout, initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:1 + ni] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-1, 1, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 2.0
    return d


def strip_batch():
    """The strips of tests/test_parallel.py:97-125's page."""
    page = make_page(np.random.default_rng(11), n_lines=4, words_per_line=2,
                     H=700, W=600, char_h=45, char_w=28, gap=5, space_w=35,
                     line_spacing=140, speckles=20, margin_x=25, angle=0.0)
    image, eroded, _ = preprocess_images(page.image, backend="host")
    strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                       verbose=False)
    return [s.img for s in strips]


def folio_pages():
    return [make_page(np.random.default_rng(60 + i), n_lines=3,
                      words_per_line=2) for i in range(2)]


def injected_ocr(pages):
    return [ocr_with_spaces(corrupt_ocr(np.random.default_rng(i),
                                        p.char_boxes))
            for i, p in enumerate(pages)]


def nw_pairs():
    rng = np.random.default_rng(7)
    alphabet = np.array(list("abcdefgh "))
    return [(list(rng.choice(alphabet, n)), list(rng.choice(alphabet, m)))
            for n, m in PAIR_SIZES]


def grid_fixture():
    """tests/test_torch_nw.py's grid_search fixture and its 9 rows."""
    page = make_page(np.random.default_rng(21), n_lines=3,
                     words_per_line=2)
    inj = ocr_with_spaces(corrupt_ocr(np.random.default_rng(4),
                                      page.char_boxes))
    gt = [{"syl": c.char, "difficult": 0,
           "ul": (c.ul[0] - 2, c.ul[1] - 2), "lr": (c.lr[0] + 2, c.lr[1] + 2)}
          for c in page.char_boxes[:8]]
    return ([{"raw_image": page.image, "transcript": page.transcript,
              "gt_boxes": gt, "existing_ocr": inj,
              "preproc_params": PreprocParams(filter_size=8)}],
            scoring_grid()[::81])


def train_batch(seed=3, nout=len(DEMO_CHARSET)):
    """The JAX demo's batch for ``seed`` (labels 3, 4, 5); with a larger
    codec, labels of 2 to 6 classes drawn from it."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 1, (GLOBAL_B, TRAIN_T, TRAIN_NI)).astype(np.float32)
    xlens = np.full(GLOBAL_B, TRAIN_T, np.int32)
    if nout == len(DEMO_CHARSET):
        labels = np.tile(np.array([[3, 4, 5, 0]], np.int32), (GLOBAL_B, 1))
        llens = np.full(GLOBAL_B, 3, np.int32)
        return xs, xlens, labels, llens
    labels = np.zeros((GLOBAL_B, 8), np.int32)
    llens = rng.integers(2, 7, GLOBAL_B).astype(np.int32)
    for b, n in enumerate(llens):
        labels[b, :n] = rng.integers(1, nout, n)
    return xs, xlens, labels, llens


def packed_batch(inks):
    rec = SeqRecognizer(params_from_np(peaky_params()), Codec(),
                        device="cpu")
    packed_meta, _, ws, Wp = rec._pack_strips(inks)
    return packed_meta, rec._initial_t_max(Wp, ws[:len(inks)])


def _leaves_np(params):
    return [t.detach().cpu().numpy().copy() for t in params_leaves(params)]


def _step_case(mesh, nout, optimizer, params, batch):
    step, shard_params, shard_batch = make_sharded_train_step(mesh,
                                                              optimizer)
    sp = shard_params(params)
    opt = optimizer.init(sp)
    sp, opt, loss = step(sp, opt, *shard_batch(*batch))
    return {"loss": loss, "grads": _leaves_np(unshard(sp, mesh, grads=True)),
            "weights": _leaves_np(unshard(sp, mesh))}


def _batch_out(results):
    """Each folio's JSON and OCR char stream (None where nothing
    aligned)."""
    return [None if r is None else
            (json.dumps(r.json_dict, sort_keys=True),
             [(c.char, c.ul, c.lr) for c in r.all_chars]) for r in results]


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return None


def _rank_cases(out_dir: str, world: int) -> None:
    """Every case's result in one rank; written to ``rank<r>.pkl``."""
    import torch.distributed as dist

    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    rank = dist.get_rank()
    mesh = make_mesh(world)
    mesh2 = data_model_mesh(world)
    out = {"rank": rank}

    # training
    n_data = axis_size(mesh2, "data")
    out["demo_loss"] = sharded_train_demo_step(
        mesh2, batch_per_device=GLOBAL_B // n_data, seed=3)
    for nout in (len(DEMO_CHARSET), len(Codec())):
        params = params_from_np(init_params_seeded(3, TRAIN_NI, TRAIN_NS,
                                                   nout))
        out[f"step_{nout}"] = _step_case(mesh2, nout, Adam(1e-3), params,
                                         train_batch(3, nout))
    tr = Trainer(Codec(), ni=TRAIN_NI, ns=TRAIN_NS, lr=5e-3, seed=1,
                 device="cpu")
    out["recipe"] = _step_case(mesh2, len(Codec()), trainer_recipe(tr),
                               tr.params, train_batch(5, len(Codec())))

    # OCR
    params = params_from_np(peaky_params())
    packed_meta, t_max = inp["packed"]
    kw = dict(t_max=t_max, target_height=48, pad=DEFAULT_PAD,
              max_regions=WIRE_REGIONS)
    out["wire"] = infer_dp.recognize_sharded_meta(params, packed_meta, mesh,
                                                  **kw)
    out["shares"] = dict(infer_dp.LAST_WORK_SHARES)
    five = np.concatenate([packed_meta[:4], np.zeros_like(packed_meta[:1])])
    out["wire5"] = infer_dp.recognize_sharded_meta(params, five, mesh, **kw)
    out["shares5"] = dict(infer_dp.LAST_WORK_SHARES)
    rec = SeqRecognizer(params, Codec(), normalize_on_device=True,
                        mesh=mesh, device="cpu")
    out["rows_device"] = rec.recognize_batch(inp["inks"])
    out["rows_host"] = SeqRecognizer(params, Codec(), mesh=mesh,
                                     device="cpu").recognize_batch(
                                         inp["inks"])
    handle = rec.dispatch_async(inp["inks"])
    out["async_handle_rows"] = (handle[0] == "rows", handle[1])
    out["async_collect"] = rec.collect_async([handle])[0]
    out["device_error"] = _raises(
        lambda: SeqRecognizer(params, Codec(), mesh=mesh, device="meta"),
        ValueError)

    # the folio batch
    pp = PreprocParams(filter_size=8)
    base = SeqRecognizer(params, Codec(), normalize_on_device=True,
                         device="cpu")
    res = process_batch(inp["folios"], base, backend="hybrid",
                        preproc_params=pp, mesh=mesh,
                        min_align_device_cells=0)
    out["batch_json"] = _batch_out(res)
    out["batch_shares"] = dict(infer_dp.LAST_WORK_SHARES)
    out["base_untouched"] = (base.mesh is None, base._fpp_hint)
    res = process_batch(inp["folios"], None, backend="hybrid",
                        preproc_params=pp, existing_ocr=inp["injected"],
                        mesh=mesh, min_align_device_cells=0)
    out["injected_json"] = [j for j, _ in _batch_out(res)]

    # NW
    out["grid"] = align_grid(list(GRID_T), list(GRID_O), GRID_ROWS,
                             mesh=mesh)
    out["pairs"] = align_pairs(inp["pairs"], resolve_scoring(None),
                               min_device_cells=PAIR_MIN_CELLS, mesh=mesh)
    fixtures, rows = inp["grid_fixture"]
    out["grid_search"] = grid_search(fixtures, shuffle=False, backend="host",
                                     verbose=False, params_list=rows,
                                     mesh=mesh)
    # seed=None: every rank draws its own order; rank 0's must win
    logs, _ = grid_search(fixtures, shuffle=True, seed=None, backend="host",
                          verbose=False, params_list=rows, mesh=mesh)
    out["grid_search_shuffled"] = (list(logs), logs)
    out["grid_search_host_error"] = _raises(
        lambda: grid_search(fixtures, grid_align="host", mesh=mesh),
        ValueError)

    # the collectives and the mesh's own checks
    out["shares_merged"] = gather_shares({f"rank{rank}": rank + 1})
    assert_same_across_processes("equal", 42)
    out["same_error"] = _raises(
        lambda: assert_same_across_processes("rank", rank), RuntimeError)
    out["mesh_errors"] = (
        _raises(lambda: make_mesh(world + 1), ValueError),
        _raises(lambda: data_model_mesh(world, model_parallel=3),
                ValueError))
    out["mesh_shapes"] = (tuple(mesh.shape), mesh.mesh_dim_names,
                          tuple(mesh2.shape), mesh2.mesh_dim_names)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def inputs():
    pages = folio_pages()
    inks = strip_batch()
    return {"inks": inks, "packed": packed_batch(inks),
            "folios": [(p.image, p.transcript) for p in pages],
            "injected": injected_ocr(pages), "pairs": nw_pairs(),
            "grid_fixture": grid_fixture()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, inputs, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"mesh{world}")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    launch(_rank_cases, world, args=(str(d), world), device="cpu",
           store_dir=str(d), deadline_s=DEADLINE_S)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return world, out


@pytest.fixture(scope="module")
def one_rank(inputs):
    """The port's unsharded runs in the pytest process, on the CPU."""
    params = params_from_np(peaky_params())
    packed_meta, t_max = inputs["packed"]
    wire = rz._recognize_device_impl(
        params, torch.from_numpy(packed_meta), t_max=t_max,
        target_height=48, pad=DEFAULT_PAD, max_regions=WIRE_REGIONS)
    rec = SeqRecognizer(params, Codec(), normalize_on_device=True,
                        device="cpu")
    pp = PreprocParams(filter_size=8)
    res = process_batch(inputs["folios"], rec, backend="hybrid",
                        preproc_params=pp, device="cpu")
    fixtures, rows = inputs["grid_fixture"]
    return {
        "wire": wire,
        "rows_device": SeqRecognizer(params, Codec(), normalize_on_device=True,
                                     device="cpu").recognize_batch(
                                         inputs["inks"]),
        "batch_json": _batch_out(res),
        "grid": align_grid(list(GRID_T), list(GRID_O), GRID_ROWS,
                           device="cpu"),
        "pairs": align_pairs(inputs["pairs"], resolve_scoring(None),
                             min_device_cells=PAIR_MIN_CELLS, device="cpu"),
        "grid_search": grid_search(fixtures, shuffle=False, backend="host",
                                   verbose=False, params_list=rows,
                                   grid_align="device", device="cpu"),
    }


def _same_on_every_rank(out, key):
    first = pickle.dumps(out[0][key])
    assert all(pickle.dumps(o[key]) == first for o in out[1:]), key
    return out[0][key]


# ---- training ----

def test_train_demo_matches_jax(ranks):
    """tests/test_parallel.py's bar: one sharded step's loss on the same
    global batch of 8 equals JAX's one-device step to 1e-5 relative."""
    world, out = ranks
    got = _same_on_every_rank(out, "demo_loss")
    assert got == pytest.approx(_jax_demo_loss(), rel=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_demo_loss():
    from text_alignment_tpu.parallel import data_model_mesh as jax_mesh
    from text_alignment_tpu.parallel import (
        sharded_train_demo_step as jax_demo)

    return jax_demo(jax_mesh(1), batch_per_device=GLOBAL_B, seed=3)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(nout):
    """JAX's one-device loss and gradients (BiLSTMParams leaf order) of
    init_bilstm(PRNGKey(3)) on train_batch(3, nout)."""
    import jax

    from text_alignment_tpu.models.ctc import ctc_loss
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.train import bilstm_logits

    params = init_bilstm(jax.random.PRNGKey(3), TRAIN_NI, TRAIN_NS, nout)
    xs, xlens, labels, llens = train_batch(3, nout)

    def loss_fn(p):
        return ctc_loss(bilstm_logits(p, xs, xlens), xlens, labels, llens)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _assert_grads_close(got, want):
    norm = float(np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                             for w in want)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.max(np.abs(g - w))) <= 1e-4 * norm


@pytest.mark.parametrize("nout", [len(DEMO_CHARSET), len(Codec())],
                         ids=["nout6", "nout29"])
def test_sharded_step_matches_jax(ranks, nout):
    """One make_sharded_train_step step (W2's rows over 'model'; 29
    classes shard unevenly over 2): loss to 1e-5 relative and the
    gradients, after unshard, to 1e-4 x their global norm against JAX's
    one-device gradients."""
    world, out = ranks
    got = _same_on_every_rank(out, f"step_{nout}")
    loss, grads = _jax_loss_and_grads(nout)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _assert_grads_close(got["grads"], grads)


def test_trainer_recipe_step_matches_trainer(ranks):
    """The Trainer's recipe (global-norm clipping, then Adam) under the
    mesh against the port's one-process Trainer.step: loss to 1e-5
    relative, clipped gradients to 1e-4 x their norm, and the updated
    weights."""
    world, out = ranks
    got = _same_on_every_rank(out, "recipe")
    tr = Trainer(Codec(), ni=TRAIN_NI, ns=TRAIN_NS, lr=5e-3, seed=1,
                 device="cpu")
    loss = tr.step(*train_batch(5, len(Codec())))
    grads = [p.grad.numpy() for p in tr.model.parameters()]
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _assert_grads_close(got["grads"], grads)
    norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in grads)))
    assert norm == pytest.approx(1.0, rel=1e-5)  # the recipe clipped
    # Adam's first update is lr * g / (|g| + eps): equal where the
    # gradient is not within float noise of 0
    for g, w_got, w_want in zip(grads, got["weights"],
                                _leaves_np(tr.params)):
        firm = np.abs(g) > 1e-4 * norm
        np.testing.assert_allclose(w_got[firm], w_want[firm], rtol=0,
                                   atol=1e-6)


# ---- OCR ----

def test_ocr_wire_matches_one_rank(ranks, one_rank):
    world, out = ranks
    wire = _same_on_every_rank(out, "wire")
    np.testing.assert_array_equal(wire, one_rank["wire"])
    assert (_unpack_wire_rows(wire)[:, 0] > 0).sum() >= 3


def test_ocr_wire_matches_jax_mesh(ranks, inputs):
    """The sharded wire against JAX's recognize_sharded over 8 devices:
    lengths and t_raw exact (tests/test_torch_slice.py's bar for the two
    packages' device normalizers)."""
    from text_alignment_tpu.models.lstm_jax import params_from_np as jparams
    from text_alignment_tpu.parallel import infer_dp as jax_infer
    from text_alignment_tpu.parallel import make_mesh as jax_mesh

    world, out = ranks
    packed_meta, t_max = inputs["packed"]
    want = jax_infer.recognize_sharded_meta(
        jparams(peaky_params()), packed_meta, jax_mesh(8), t_max=t_max,
        target_height=48, pad=DEFAULT_PAD, max_regions=WIRE_REGIONS)
    got = _unpack_wire_rows(out[0]["wire"])
    np.testing.assert_array_equal(got[:, 1:3], _unpack_wire_rows(want)[:, 1:3])
    assert set(jax_infer.LAST_WORK_SHARES.values()) == {
        packed_meta.shape[0] // 8}


def test_host_normalizer_rows_match_jax_mesh(ranks, inputs):
    """Through the host scipy normalizer both packages share, the port's
    sharded recognizer decodes JAX's SeqRecognizer(mesh=) rows."""
    from text_alignment_tpu.models.codec import Codec as JCodec
    from text_alignment_tpu.models.lstm_jax import params_from_np as jparams
    from text_alignment_tpu.models.recognizer import SeqRecognizer as JRec
    from text_alignment_tpu.parallel import make_mesh as jax_mesh

    world, out = ranks
    want = JRec(jparams(peaky_params()), JCodec(),
                mesh=jax_mesh(8)).recognize_batch(inputs["inks"])
    assert _same_on_every_rank(out, "rows_host") == want
    assert sum(len(r) for r in want) > len(want)


def test_recognizer_rows_match_one_rank(ranks, one_rank):
    world, out = ranks
    assert _same_on_every_rank(out, "rows_device") == one_rank["rows_device"]


def test_work_shares_partition_the_batch(ranks, inputs):
    """One equal share a rank, summing to the padded batch."""
    world, out = ranks
    B = inputs["packed"][0].shape[0]
    shares = _same_on_every_rank(out, "shares")
    assert len(shares) == world
    assert set(shares.values()) == {-(-B // world)}
    assert sum(shares.values()) == -(-B // world) * world
    assert set(shares) == {f"rank{r}:cpu" for r in range(world)}


def test_padded_rows_decode_to_zero_regions(ranks, one_rank):
    """Four strips and a row of h = w = 0 pad to 6 or 8 rows with more
    such rows; the strips come back equal to the unsharded wire and the
    empty row decodes to no region."""
    world, out = ranks
    wire5 = _same_on_every_rank(out, "wire5")
    assert wire5.shape[0] == 5
    np.testing.assert_array_equal(wire5[:4], one_rank["wire"][:4])
    assert _unpack_wire_rows(wire5)[4, 0] == 0
    shares = out[0]["shares5"]
    assert sum(shares.values()) == -(-5 // world) * world
    assert len(set(shares.values())) == 1


def test_mesh_dispatch_runs_synchronously(ranks, one_rank):
    """Under a mesh, dispatch_async hands back finished rows (every
    rank's collectives in order)."""
    world, out = ranks
    is_rows, rows = _same_on_every_rank(out, "async_handle_rows")
    assert is_rows and rows == one_rank["rows_device"]
    assert out[0]["async_collect"] == one_rank["rows_device"]


def test_mesh_rejects_another_device(ranks):
    world, out = ranks
    assert "not this rank's device" in _same_on_every_rank(out,
                                                           "device_error")


# ---- the folio batch ----

def test_process_batch_matches_unsharded(ranks, one_rank):
    world, out = ranks
    got = _same_on_every_rank(out, "batch_json")
    assert all(g is not None and len(g[1]) > 10 for g in got)
    assert got == one_rank["batch_json"]
    assert len(out[0]["batch_shares"]) == world


def test_process_batch_leaves_callers_recognizer(ranks):
    world, out = ranks
    no_mesh, hint = _same_on_every_rank(out, "base_untouched")
    assert no_mesh and hint is None


def test_process_batch_injected_matches_jax_mesh(ranks, inputs):
    """Injected OCR puts the sharded NW buckets against the JAX package's
    sharded buckets exactly."""
    from text_alignment_tpu.parallel import make_mesh as jax_mesh
    from text_alignment_tpu.parallel.batch import process_batch as jax_batch
    from text_alignment_tpu.pipeline.preprocess import (
        PreprocParams as JPreproc)

    world, out = ranks
    want = jax_batch(inputs["folios"], None, backend="hybrid",
                     preproc_params=JPreproc(filter_size=8),
                     existing_ocr=inputs["injected"], mesh=jax_mesh(8),
                     min_align_device_cells=0)
    want = [None if r is None else json.dumps(r.json_dict, sort_keys=True)
            for r in want]
    assert all(j is not None for j in want)
    assert _same_on_every_rank(out, "injected_json") == want


# ---- NW ----

def test_align_grid_matches_one_rank_and_jax(ranks, one_rank):
    from text_alignment_tpu.align.api import align_grid as jax_grid
    from text_alignment_tpu.parallel import make_mesh as jax_mesh

    world, out = ranks
    got = _same_on_every_rank(out, "grid")
    assert len(got) == len(GRID_ROWS)
    assert got == one_rank["grid"]
    assert got == jax_grid(list(GRID_T), list(GRID_O), GRID_ROWS,
                           mesh=jax_mesh(8))


def test_align_pairs_mixed_buckets(ranks, one_rank):
    """Four buckets of 1 or 2 pairs (each padded at 2 and 4 ranks) and a
    pair under the host threshold."""
    world, out = ranks
    got = _same_on_every_rank(out, "pairs")
    assert got == one_rank["pairs"]
    assert all(len(a) == len(b) for a, b in got)


def test_grid_search_logs_match_unsharded(ranks, one_rank):
    world, out = ranks
    logs, ranked = _same_on_every_rank(out, "grid_search")
    assert (logs, ranked) == one_rank["grid_search"]
    assert "host route" in out[0]["grid_search_host_error"]


def test_grid_search_shuffled_order_is_rank0s(ranks, one_rank):
    """With shuffle=True and seed=None each rank draws its own order; under
    the mesh every rank takes rank 0's, so the sharded grid's rows meet
    their own scoring rows and the logs equal the unsharded ones."""
    world, out = ranks
    order, logs = _same_on_every_rank(out, "grid_search_shuffled")
    assert logs == one_rank["grid_search"][0]
    assert sorted(order) == sorted(one_rank["grid_search"][0])


# ---- the collectives ----

def test_gather_shares_merges_every_rank(ranks):
    world, out = ranks
    assert _same_on_every_rank(out, "shares_merged") == {
        f"rank{r}": r + 1 for r in range(world)}


def test_assert_same_raises_when_a_rank_differs(ranks):
    world, out = ranks
    for o in out:
        assert "value differs across processes" in o["same_error"]


def test_mesh_shapes_and_wrong_sizes(ranks):
    world, out = ranks
    shapes = _same_on_every_rank(out, "mesh_shapes")
    assert shapes == ((world,), ("data",), (world // 2, 2),
                      ("data", "model"))
    wrong_world, wrong_model = _same_on_every_rank(out, "mesh_errors")
    assert f"this group has {world}" in wrong_world
    assert "does not divide" in wrong_model
