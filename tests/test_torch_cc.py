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
