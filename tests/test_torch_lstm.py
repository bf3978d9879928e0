"""The port's BiLSTM (text_alignment_tpu_torch.models.lstm) against the JAX
package: the plain recurrence against lstm_jax's scan and the Pallas kernel
in interpret mode, and the whole forward pass against
lstm_jax.bilstm_forward_batched, at the reference's own LSTM tolerance
(tests/test_models.py: rtol=2e-5, atol=2e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_alignment_tpu.models import lstm_jax
from text_alignment_tpu.models.lstm_pallas import bidir_scan_pallas
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models import lstm_kernel as lk
from text_alignment_tpu_torch.models.lstm_kernel import (
    bidir_scan, bidir_scan_reference)
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch._kernels import SMEM_LIMIT

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _case(seed, B, T, ni, ns, nout=16, initial_range=0.3):
    rng = np.random.default_rng(seed)
    d = tl.init_params_np(rng, ni, ns, nout, initial_range)
    xs = rng.normal(0, 1, (B, T, ni)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    return d, xs, lens


def _torch_scan(d, xs, lens):
    p = tl.params_from_np(d)
    gx, whT, peep = tl.scan_inputs(p, torch.from_numpy(xs),
                                   torch.from_numpy(lens))
    out = bidir_scan(gx, whT, peep)
    f = out[0].transpose(0, 1).numpy()
    b_rev = out[1].transpose(0, 1).numpy()
    return f, b_rev


def _jax_scan(d, xs, lens):
    p = lstm_jax.params_from_np(d)
    xs_j = jnp.asarray(xs)
    xs_rev = lstm_jax._reverse_by_length(xs_j, jnp.asarray(lens))
    return p, xs_j, xs_rev


@pytest.mark.parametrize("B,T,ni,ns", [(3, 12, 8, 12), (12, 24, 48, 100),
                                      (2, 6, 8, 160), (2, 4, 8, 256)])
def test_scan_reference_matches_jax_scan(B, T, ni, ns):
    """B=12 at the production widths (ni=48, ns=100): a 9-12 line folio
    packs at B=12. ns = 160 and 256 are the kernel's wide route (one and
    four-lane groups past ns = 128)."""
    d, xs, lens = _case(1, B, T, ni, ns)
    p, xs_j, xs_rev = _jax_scan(d, xs, lens)
    f0, b0 = lstm_jax._bidir_scan(p.fwd, p.bwd, xs_j, xs_rev)
    f1, b1 = _torch_scan(d, xs, lens)
    np.testing.assert_allclose(f1, np.asarray(f0), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b1, np.asarray(b0), rtol=RTOL, atol=ATOL)


def test_scan_reference_matches_pallas_interpret():
    B, T, ni, ns = 8, 16, 48, 100
    d, xs, lens = _case(2, B, T, ni, ns)
    p, xs_j, xs_rev = _jax_scan(d, xs, lens)
    f0, b0 = bidir_scan_pallas(p.fwd, p.bwd, xs_j, xs_rev, interpret=True)
    f1, b1 = _torch_scan(d, xs, lens)
    np.testing.assert_allclose(f1, np.asarray(f0), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b1, np.asarray(b0), rtol=RTOL, atol=ATOL)


def test_t0_output_peephole_skip():
    """ocropy quirk: the WOP term is absent at t = 0 only. A huge WOP
    would saturate the output gate at t = 0 if it were applied there."""
    rng = np.random.default_rng(3)
    ns, B, G = 4, 2, 16
    gx = torch.from_numpy(rng.normal(0, 1, (2, 3, B, G)).astype(np.float32))
    whT = torch.zeros((2, ns, G))
    peep = torch.zeros((2, 3, ns))
    base = bidir_scan_reference(gx, whT, peep)
    peep[:, 2] = 50.0
    skewed = bidir_scan_reference(gx, whT, peep)
    torch.testing.assert_close(skewed[:, 0], base[:, 0], rtol=0, atol=0)
    assert (skewed[:, 1:] - base[:, 1:]).abs().max() > 1e-2


@pytest.mark.parametrize("B,T", [(3, 20), (12, 32)])
def test_forward_matches_jax(B, T):
    ni, ns, nout = 48, 100, 29
    d, xs, lens = _case(4, B, T, ni, ns, nout, initial_range=0.1)
    d["W2"] = np.random.default_rng(5).uniform(
        -2, 2, d["W2"].shape).astype(np.float32)
    y0 = np.asarray(lstm_jax.bilstm_forward_batched(
        lstm_jax.params_from_np(d), jnp.asarray(xs), jnp.asarray(lens)))
    y1 = tl.bilstm_forward_batched(tl.params_from_np(d), torch.from_numpy(xs),
                                   torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(y1, y0, rtol=RTOL, atol=ATOL)


def test_params_from_jax_carries_weights_across():
    import jax

    pj = lstm_jax.init_bilstm(jax.random.PRNGKey(0), 8, 12, 6)
    pt = tl.params_from_jax(lstm_jax.params_to_np(pj))
    for name in lstm_jax.LSTMParams._fields:
        for dj, dt in ((pj.fwd, pt.fwd), (pj.bwd, pt.bwd)):
            np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                          np.asarray(getattr(dj, name)))
    np.testing.assert_array_equal(pt.W2.numpy(), np.asarray(pj.W2))


def test_reverse_by_length_matches_jax():
    rng = np.random.default_rng(6)
    xs = rng.normal(0, 1, (4, 7, 3)).astype(np.float32)
    lens = np.array([7, 3, 0, 5], np.int32)
    ref = np.asarray(lstm_jax._reverse_by_length(jnp.asarray(xs),
                                                 jnp.asarray(lens)))
    got = tl._reverse_by_length(torch.from_numpy(xs),
                                torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, ref)


def _planned_batches():
    """Every batch size the recognizer's pack ladder yields for 1 to 128
    strips: 8, 12, 16, then multiples of 32."""
    return sorted({SeqRecognizer._plan_pack([(40, 300)] * n)[0]
                   for n in range(1, 129)})


def test_planned_batches_are_the_ladder():
    assert _planned_batches() == [8, 12, 16, 32, 64, 96, 128]


H100_SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("B", [8, 12, 16, 32, 64, 96, 128])
def test_kernel_launch_plan(B):
    """At the production width the plan's grid of 2 * ceil(B / bt) CTAs
    fits one wave on an H100's SMs, with a batch tile the kernel is built
    for, and no smaller tile would have fit the wave. (Its registers and
    shared memory are held at compile time by the kernel's static_assert
    and on the card by test_torch_cuda.py's test_lstm_scan_plan_fits.)"""
    bt = lk.launch_plan(B, 100, H100_SMS)
    tiles = lk.TILES[lk.quads(100)]
    assert bt in tiles
    assert 2 * -(-B // bt) <= H100_SMS
    assert all(2 * -(-B // b) > H100_SMS for b in tiles if b < bt)


def test_kernel_launch_plan_refuses_what_cannot_fit():
    """ns over 128 takes the wide route: NQ = ceil(ns / 4), tiles 1/2/4,
    the smallest whose clusters the card holds at once, up to the widest
    ns whose h and c buffers fit a block; a batch tile the kernel is not
    built for (bt = 8 at ns = 128, whose Wh would overflow a block's shared
    memory, or at a wide ns) is refused before a launch; a batch past one
    wave takes the largest tile; the small widths share the ns = 100
    instantiation. A wide tile is a cluster of the fewest CTAs (up to 8)
    whose shared memory holds their columns of Wh; a narrow tile is one
    CTA."""
    assert lk.quads(12) == lk.quads(100) == 25 and lk.quads(128) == 32
    assert lk.quads(129) == 33 and lk.quads(160) == 40
    assert lk.quads(256) == 64 and lk.quads(300) == 75
    assert lk.tiles(160) == lk.tiles(4096) == lk.WIDE_TILES == (1, 2, 4)
    assert lk.tiles(6000) == (1, 2)  # 4 rows of h and c are over a block
    assert lk.tiles(19368) == (1,)
    with pytest.raises(ValueError):
        lk.tiles(19369)
    assert lk.cluster_size(12, 1) == lk.cluster_size(100, 8) == 1
    assert lk.cluster_size(128, 4) == 1
    assert lk.cluster_size(129, 1) == lk.cluster_size(160, 4) == 2
    assert lk.cluster_size(200, 1) == lk.cluster_size(200, 4) == 4
    assert lk.cluster_size(256, 1) == lk.cluster_size(300, 2) == 8
    # past what 8 CTAs hold: the widest cluster, the rest from global memory
    assert lk.cluster_size(4096, 1) == lk.cluster_size(19368, 1) == 8
    assert lk.cta_threads(100, 1) == 416 and lk.cta_threads(128, 1) == 512
    assert lk.cta_threads(129, 2) == 288 and lk.cta_threads(200, 4) == 224
    assert lk.cta_threads(4096, 8) == 1024  # 512 units: two unit groups
    assert lk.launch_plan(12, 129, H100_SMS) == 1
    # 24 clusters of 8 are over the 16 of 132 SMs: two rows a CTA
    assert lk.launch_plan(12, 256, H100_SMS) == 2
    assert lk.launch_plan(96, 256, H100_SMS) == 4
    assert lk.launch_plan(4096, 300, H100_SMS) == 4
    assert lk.launch_plan(4096, 100, H100_SMS) == 8
    assert lk.launch_plan(4096, 128, H100_SMS) == 4
    assert lk.launch_plan(96, 100, 48) == 4  # a card of fewer SMs
    assert lk.launch_plan(12, 200, H100_SMS) == 1  # kraken's folio
    assert lk.launch_plan(128, 200, H100_SMS) == 4
    # a card that holds fewer clusters at once than its SMs make room for
    assert lk.launch_plan(12, 200, H100_SMS, lambda bt: 12) == 2
    assert lk.launch_plan(12, 200, H100_SMS, lambda bt: 0) == 4
    for ns, bt in ((100, 3), (100, 16), (4, 0), (128, 8), (160, 8),
                   (300, 3), (200, 8)):
        gx = torch.zeros((2, 3, 4, 4 * ns), device="meta")
        with pytest.raises(ValueError):
            lk.bidir_scan_cuda(gx, torch.zeros((2, ns, 4 * ns), device="meta"),
                               torch.zeros((2, 3, ns), device="meta"), bt=bt)


WIDE_NS = (129, 160, 200, 256, 300, 4096)
# The clusters of C CTAs an H100 SXM holds at once with the wide route's
# shared memory, one CTA an SM (the card's cudaOccupancyMaxActiveClusters,
# kernel_attrs' active_clusters): the limit the plan is held to here.
H100_ACTIVE = {2: 66, 4: 32, 8: 16}


def _cta_bytes(ns, bt, c):
    """Shared bytes a CTA of a cluster of c takes to hold its units'
    columns of Wh, each padded to whole quads of 16 bytes, a column for
    each of 4 lanes a unit in whole warps (a CTA of more than 1024 lanes
    walks its units in groups of 256, a slot each), and the tile's h
    (two buffers) and c rows."""
    nq = -(-ns // 4)
    lanes = 4 * -(-ns // c)
    slots = -(-lanes // 32) * 32 if lanes <= 1024 else 1024 * -(-lanes // 1024)
    return 16 * nq * slots + 3 * 4 * bt * 4 * nq


@pytest.mark.parametrize("ns", WIDE_NS)
@pytest.mark.parametrize("B", [8, 12, 16, 32, 64, 96, 128])
def test_wide_plan_holds_wh_in_a_cluster(B, ns):
    """Across the pack ladder and the wide widths, on an H100's SMs and
    its assumed cluster limit: the plan's cluster is the fewest CTAs whose
    shared memory holds one direction's Wh wherever 8 can (else 8, with
    the rest of each column read from global memory), its 2 * ceil(B / bt)
    clusters fit the limit unless no tile does (then the largest tile),
    no smaller tile would have fit, and the narrow plan at ns = 100 and
    128 is the one-CTA-an-SM plan it always was."""
    def active(bt):
        return H100_ACTIVE[lk.cluster_size(ns, bt)]

    bt = lk.launch_plan(B, ns, H100_SMS, active)
    c = lk.cluster_size(ns, bt)
    assert bt in lk.tiles(ns) and c in H100_ACTIVE
    if _cta_bytes(ns, bt, 8) <= SMEM_LIMIT:
        assert _cta_bytes(ns, bt, c) <= SMEM_LIMIT
        assert _cta_bytes(ns, bt, c // 2) > SMEM_LIMIT
    else:
        assert c == 8
    assert lk.cta_threads(ns, c) <= 1024

    def fits(t):
        return 2 * -(-B // t) <= active(t)

    assert fits(bt) or bt == lk.tiles(ns)[-1]
    assert not any(fits(t) for t in lk.tiles(ns) if t < bt)
    if ns == 200:  # kraken's width: the same cluster at every tile
        assert {lk.cluster_size(ns, t) for t in lk.tiles(ns)} == {4}
    for narrow in (100, 128):
        ts = lk.tiles(narrow)
        want = next((t for t in ts if 2 * -(-B // t) <= H100_SMS), ts[-1])
        assert lk.launch_plan(B, narrow, H100_SMS) == want
        assert {lk.cluster_size(narrow, t) for t in ts} == {1}


def test_wrapper_refuses_unknown_devices():
    gx = torch.zeros((2, 1, 1, 4), device="meta")
    with pytest.raises(ValueError):
        bidir_scan(gx, gx, gx)
