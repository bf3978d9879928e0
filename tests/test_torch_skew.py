"""The port's skew search (``ops/skew_device.py``, the search of the card
raster's chain) against the host oracle and against the JAX package's
device search (``ops/skew_device.py``, XLA on the CPU): the angles are
identical on seeded pages skewed to +1.37, -1.37 and -2.6 degrees, on blank
and tiny pages, and on a wide page whose full-width ink band gives
projection steps past 4096."""

import numpy as np
import pytest
import torch

from text_alignment_tpu.ops import oracle
from text_alignment_tpu.ops import skew_device as jax_sd
from text_alignment_tpu.synth import make_page
from text_alignment_tpu_torch.ops import skew_device as sd

torch.set_num_threads(1)


def _skewed(seed, angle):
    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=2)
    img = oracle.to_onebit(page.image)
    return oracle.rotate_onebit(img, angle) if angle else img


def _wide_sharp_edge():
    rng = np.random.default_rng(11)
    page = np.zeros((64, 5000), bool)
    page[20:33, 100:4900] = True  # |d| = 4800 at the band edges
    page[rng.integers(0, 64, 200), rng.integers(0, 5000, 200)] = True
    return page


def _tiny():
    tiny = np.zeros((3, 130), bool)
    tiny[1, ::2] = True
    return tiny


PAGES = {"skew+1.37": lambda: _skewed(12, 1.37),
         "skew-1.37": lambda: _skewed(15, -1.37),
         "skew-2.6": lambda: _skewed(13, -2.6),
         "blank": lambda: np.zeros((64, 80), bool),
         "tiny": _tiny,
         "wide_sharp_edge": _wide_sharp_edge}


@pytest.mark.parametrize("name", list(PAGES))
def test_search_matches_oracle_and_jax(name):
    img = PAGES[name]()
    got = sd.angle_from_indices(*sd.search(torch.from_numpy(img)).tolist())
    assert got == oracle.rotation_angle_projections(img, -6, 6)
    assert got == jax_sd.rotation_angle_projections(img, -6, 6)


def test_tan_tree_and_indices_are_the_jax_packages():
    for a, b in zip(sd._tan_tree(-6.0, 6.0), jax_sd._tan_tree(-6.0, 6.0)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for _ in range(20):
        i1, i2, i3 = (int(rng.integers(13)), int(rng.integers(19)),
                      int(rng.integers(19)))
        assert (sd.angle_from_indices(i1, i2, i3)
                == jax_sd.angle_from_indices(i1, i2, i3))
