"""The schedule of the normalizer tail's CUDA kernel (csrc/lineest_tail.cu),
modelled on the CPU (tests/lineest_tail_model.py): argmax keys, column
tiles with a reflect-mapped halo, the zero-tap skip and per-tile MAD
partials.

- The model against the plain tail (``tail_reference``), bit for bit
  (center, dsum, dcnt), on the cases the card tests run; the skip of the
  zero taps and the tile width leave every bit as it was.
- The model against the JAX package's Pallas tail in interpret mode on
  tests/test_lineest_pallas.py's case: ink counts exact, center within the
  one-row float32 knife edge, as the plain tail is held there.
- A halo one column short, and ties resolved to the last maximum, each
  change the result: the model catches an off-by-one.
"""

import numpy as np
import pytest
import torch

from lineest_tail_model import (
    TAIL_CASES, argmax_keys, decode_keys, plateau_case, strip_radius,
    tail_case, tiled_tail)
from test_lineest_pallas import _build_case
from text_alignment_tpu.models import lineest_pallas as lp
from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models.lineest_kernel import (
    CENTER_TILE, tail_reference)

torch.set_num_threads(1)


def _equal(got, ref):
    return all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("B,Hp,Wp,kind", TAIL_CASES)
def test_tiled_model_matches_plain_bit_for_bit(B, Hp, Wp, kind):
    args = tail_case(B, Hp, Wp, kind)
    assert _equal(tiled_tail(*args), tail_reference(*args))


@pytest.mark.parametrize("B,Hp,Wp,kind", [
    (5, 64, 512, None), (4, 96, 256, "wrap"), (5, 32, 300, "h1"),
    (1, 96, 1536, None), (3, 48, 640, "ties")])
@pytest.mark.parametrize("tile,skip", [(CENTER_TILE, False), (37, True),
                                       (1, True)])
def test_tile_width_and_the_zero_tap_skip_change_no_bit(B, Hp, Wp, kind,
                                                        tile, skip):
    """Every tap beyond a strip's radius is an exact zero (a padding
    strip's identity tap too), and a tile sees the same argmax row through
    its halo at any width."""
    args = tail_case(B, Hp, Wp, kind)
    assert _equal(tiled_tail(*args, tile=tile, skip=skip),
                  tail_reference(*args))


def test_strip_radius_is_the_gaussian_truncation():
    """The radius the kernel reads off the taps is scipy's
    int(4 * 0.3 h + 0.5); a padding strip (h = 0) has the identity tap."""
    Hp = 96
    hs = np.array([0, 1, 2, 17, 60, 96])
    k2 = tle.smoothing_taps(hs, Hp)
    r2 = k2.shape[1] // 2
    for b, h in enumerate(hs):
        assert strip_radius(k2[b, r2::-1]) == int(4.0 * (h * 0.3) + 0.5)
    assert k2[0, r2] == 1.0 and strip_radius(k2[0, r2::-1]) == 0


def test_argmax_keys_order_like_the_values_first_row_first():
    vals = np.array([-np.inf, -3.0, -1e-38, -0.0, 0.0, 1e-45, 2.0, np.inf],
                    np.float32)
    Hp = len(vals)
    v = vals[None, :, None].repeat(2, axis=2)
    keys = argmax_keys(v[:, ::-1].copy(), np.array([Hp]), np.array([2]))
    assert decode_keys(keys, Hp)[0, 0] == 0  # inf, now at row 0
    # one value per key: the high words order as the values do, and -0.0
    # and +0.0 share theirs
    hi = []
    for x in vals:
        k = argmax_keys(np.full((1, 1, 1), x, np.float32), np.array([1]),
                        np.array([1]))
        hi.append(int(k[0, 0]) >> 32)
    assert hi[3] == hi[4]
    assert all(hi[k] < hi[k + 1] for k in range(len(hi) - 1) if k != 3)
    assert min(hi) > 0  # a finite or infinite value never gives key 0
    # equal values: the first row wins, or the last with ties="last"
    tied = np.array([[[1.0], [5.0], [5.0], [-0.0], [5.0]]], np.float32)
    k = argmax_keys(tied, np.array([5]), np.array([1]))
    assert decode_keys(k, 5)[0, 0] == 1
    k = argmax_keys(tied, np.array([5]), np.array([1]), ties="last")
    assert decode_keys(k, 5, ties="last")[0, 0] == 4
    # no key (h = 0, or x >= w) decodes as row 0
    k = argmax_keys(tied, np.array([0]), np.array([1]))
    assert k[0, 0] == 0 and decode_keys(k, 5)[0, 0] == 0


def test_tiled_model_matches_pallas_interpret():
    B, Hp, Wp = 6, 96, 768
    sm, tj, hs, ws, _ = _build_case(B, Hp, Wp)
    ref = [np.asarray(a) for a in lp.tail_from_sm(sm, tj, hs, ws,
                                                  interpret=True)]
    cg, dsg, dcg = (a.numpy() for a in tiled_tail(
        torch.from_numpy(np.array(sm)),
        torch.from_numpy(np.array(tj, np.uint8)),
        torch.from_numpy(np.asarray(hs, np.int32)),
        torch.from_numpy(np.asarray(ws, np.int32)),
        torch.from_numpy(tle.smoothing_taps(hs, Hp))))
    np.testing.assert_array_equal(dcg, ref[2])
    for b, w in enumerate(ws):
        d = np.abs(cg[b, :w].astype(np.int64) - ref[0][b, :w])
        assert d.max() <= 1, (b, d.max())
    assert np.abs(dsg - ref[1]).max() <= int(ref[2].max())


@pytest.mark.parametrize("case", ["plateau", "random"])
def test_model_fails_with_the_halo_one_column_short(case):
    """The first and last column of each tile lose their outermost pair:
    on a plateau whose taps sum past 1 the truncation drops a row there."""
    args = (plateau_case() if case == "plateau"
            else tail_case(5, 64, 512, None))
    ref = tail_reference(*args)
    assert _equal(tiled_tail(*args), ref)
    short = tiled_tail(*args, halo_short=1)
    assert not _equal(short, ref)
    if case == "plateau":
        tile_edge = np.zeros(args[0].shape[2], bool)
        tile_edge[::CENTER_TILE] = tile_edge[CENTER_TILE - 1::CENTER_TILE] = 1
        moved = (short[0] != ref[0]).numpy().any(axis=0)
        assert moved.any() and not (moved & ~tile_edge).any()


def test_model_fails_with_ties_to_the_last_maximum():
    args = tail_case(3, 48, 640, "ties")
    ref = tail_reference(*args)
    assert _equal(tiled_tail(*args), ref)
    assert not _equal(tiled_tail(*args, ties="last"), ref)
