"""The port's ``perform_alignment(backend="reference")`` against the JAX
package's, on the CPU.

The reference backend is the literal O(N*M) port of the reference's fill
(``nw_host.fill_reference_slow``) and the dense traceback: the oracle
``tests/test_nw.py`` holds every other engine to. These are that file's
reference cases, on the same inputs made from the same seeds: the port's
reference backend must give exactly the JAX package's aligned lists, and
the port's ``"host"`` and ``"device"`` (on the CPU: the plain versions of
the kernels) must give exactly the same. The port's copy of
``fill_reference_slow`` must give the JAX one's pointers.
"""

import random

import numpy as np
import pytest
import torch

from text_alignment_tpu.align import perform_alignment as jax_align
from text_alignment_tpu.align import resolve_scoring as jax_scoring
from text_alignment_tpu.align.nw_host import (
    fill_reference_slow as jax_fill_reference_slow)
from text_alignment_tpu_torch.align import api, nw_host, nw_torch
from text_alignment_tpu_torch.align import perform_alignment
from text_alignment_tpu_torch.align import resolve_scoring

torch.set_num_threads(1)


def _random_pair(rng, n, m, alphabet="abcdefg "):
    t = [rng.choice(alphabet) for _ in range(n)]
    o = [rng.choice(alphabet) for _ in range(m)]
    return t, o


def _corrupted_pair(rng, n):
    t = [rng.choice("abcdefghij ") for _ in range(n)]
    o = list(t)
    for _ in range(max(1, n // 8)):
        k = rng.randrange(len(o))
        op = rng.random()
        if op < 0.4:
            o[k] = rng.choice("abcdefghij ")
        elif op < 0.7 and len(o) > 2:
            del o[k]
        else:
            o.insert(k, rng.choice("abcdefghij "))
    return t, o


SYSTEMS = [
    None,                      # default [8, -4, -7, -7, -3, 0]
    [10, -5, -7, -7],          # 4-form
    [5, -4, -2, -7, 0, -3],    # 6-form, asymmetric
]


def _all_agree(t, o, scoring=None, strict=True):
    """The port's reference backend equals the JAX package's, and the
    port's host and device (CPU) backends equal it. Returns it."""
    kw = dict(scoring_system=scoring, strict=strict)
    ref = perform_alignment(t, o, backend="reference", **kw)
    assert ref == jax_align(t, o, backend="reference", **kw)
    assert perform_alignment(t, o, backend="host", **kw) == ref
    assert perform_alignment(t, o, backend="device", device="cpu",
                             **kw) == ref
    return ref


def _corrupted_cases():
    rng = random.Random(2)  # test_backends_agree_end_to_end's stream
    return {n: _corrupted_pair(rng, n) for n in (20, 64, 150)}


CORRUPTED = _corrupted_cases()


@pytest.mark.parametrize("n", sorted(CORRUPTED))
def test_backends_agree_on_corrupted_pairs(n):
    t, o = CORRUPTED[n]
    a, b = _all_agree(t, o)
    assert len(a) == len(b)
    assert [c for c in a if c != "_"] == t
    assert [c for c in b if c != "_"] == o


def test_reference_main_fixture():
    """The reference's bigram-chunked lorem ipsum with deliberate
    corruptions (textSeqCompare.py:180-189) under [10, -5, -7, -7]."""
    seq1 = "Lorem ipsum dolor sit amet, consectetur adipiscing elit "
    seq2 = "LoLorem fipsudolor ..... sit eamet, c.nnr adizisdcing eelitellit"
    seq1 = [seq1[2 * x] + seq1[2 * x + 1] for x in range(len(seq1) // 2)]
    seq2 = [seq2[2 * x] + seq2[2 * x + 1] for x in range(len(seq2) // 2)]
    a, b = _all_agree(seq1, seq2, [10, -5, -7, -7])
    assert len(a) == len(b)
    assert [x for x in a if x != "_"] == seq1
    assert [x for x in b if x != "_"] == seq2


def test_callable_scoring_system():
    def score(x, y):
        return 12 if x == y else -6

    _all_agree(list("abcabc"), list("abxabc"), [score, -7, -7, -3, 0])


@pytest.mark.parametrize("min_device_cells", [None, 0])
def test_align_pairs_routes_equal_the_reference(min_device_cells):
    """align_pairs' small-pair host route (the default) and its forced
    device route (min_device_cells=0, on the CPU) each equal the reference
    backend pair by pair, on test_align_pairs_small_pair_host_routing's
    pairs."""
    rng = random.Random(11)
    pairs = [_corrupted_pair(rng, n) for n in (8, 40, 90)]
    got = nw_torch.align_pairs(pairs, resolve_scoring(None),
                               min_device_cells=min_device_cells,
                               device="cpu")
    for (ta, oa), (t, o) in zip(got, pairs):
        ref = perform_alignment(t, o, backend="reference")
        assert (ta, oa) == ref == jax_align(t, o, backend="reference")


def _fuzz_trials():
    """test_fuzz_random_scorings_all_fills_agree's 10 seeded scorings and
    pairs, in its order."""
    rng = random.Random(7)
    trials = []
    for _ in range(10):
        match = rng.randrange(1, 13)
        mismatch = -rng.randrange(0, 11)
        gox, goy = -rng.randrange(0, 9), -rng.randrange(0, 9)
        gex, gey = -rng.randrange(0, 6), -rng.randrange(0, 6)
        system = [match, mismatch, gox, goy, gex, gey]
        n, m = rng.randrange(2, 60), rng.randrange(2, 60)
        trials.append((system, *_random_pair(rng, n, m)))
    return trials


FUZZ = _fuzz_trials()


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("trial", range(len(FUZZ)))
def test_fuzz_random_scorings(trial, strict):
    system, t, o = FUZZ[trial]
    _all_agree(t, o, system, strict=strict)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("scoring", SYSTEMS, ids=["default", "four", "six"])
def test_fill_reference_slow_pointers_match_jax(scoring, strict):
    """The port's copy of fill_reference_slow gives the JAX one's three
    pointer planes, whole, on test_fast_host_fill_matches_reference's
    pairs."""
    rng = random.Random(0)
    sc = resolve_scoring(scoring, strict=strict)
    jsc = jax_scoring(scoring, strict=strict)
    for n in (3, 10, 30, 60):
        t, o = _corrupted_pair(rng, n)
        t, o = t + [" "], o + [" "]
        for mine, theirs, name in zip(nw_host.fill_reference_slow(t, o, sc),
                                      jax_fill_reference_slow(t, o, jsc),
                                      ("mat", "x", "y")):
            np.testing.assert_array_equal(
                mine, theirs, err_msg=f"{name} pointers, n={n}")


def test_auto_never_takes_the_reference(monkeypatch):
    """"auto" picks the host or the device, never the reference fill."""
    def refuse(*args):
        raise AssertionError("the reference fill ran")

    monkeypatch.setattr(api, "fill_reference_slow", refuse)
    t, o = CORRUPTED[20]
    for cells in (0, 1 << 40):
        monkeypatch.setattr(api, "auto_device_min_cells", lambda: cells)
        assert (perform_alignment(t, o, backend="auto", device="cpu")
                == jax_align(t, o, backend="reference"))


def test_reference_runs_on_the_host_whatever_the_device(monkeypatch):
    """The reference backend never resolves ``device``: a card that is
    not there is not asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, o = CORRUPTED[20]
    want = jax_align(t, o, backend="reference")
    assert perform_alignment(t, o, backend="reference") == want
    assert perform_alignment(t, o, backend="reference",
                             device="cuda") == want
