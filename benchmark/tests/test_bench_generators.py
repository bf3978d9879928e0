"""The generators: the same seed gives the same inputs, other seeds other
ones of the same sizes, and seeds past 32 bits work."""

import numpy as np

from benchmark import common

BIG = 2 ** 31 + 12345
CONFIG = common.load_json(common.os.path.join(
    common.HERE, "tests", "data", "tiny.json"))


def test_sub_seeds_take_large_seeds():
    a = common.sub_seed(BIG, 1)
    assert a == common.sub_seed(BIG, 1)
    assert a != common.sub_seed(BIG + 1, 1) != common.sub_seed(BIG, 2)
    assert 0 <= common.sub_seed(2 ** 70, 3) < 2 ** 63


def test_pages_follow_the_seed():
    a = common.make_pages(CONFIG, BIG, 2)
    b = common.make_pages(CONFIG, BIG, 2)
    c = common.make_pages(CONFIG, BIG + 1, 2)
    for x, y in zip(a, b):
        assert np.array_equal(x.image, y.image)
        assert x.transcript == y.transcript
    assert not np.array_equal(a[0].image, c[0].image)
    assert a[0].image.shape == c[0].image.shape


def test_injected_ocr_follows_the_seed():
    p = common.make_pages(CONFIG, BIG, 1)[0]
    a = common.injected_ocr(p, common.rng(BIG, 5), 0.08, 0.03)
    b = common.injected_ocr(p, common.rng(BIG, 5), 0.08, 0.03)
    assert [c.char for c in a] == [c.char for c in b]
