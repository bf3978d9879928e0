"""The benchmark's plain reference against the port's CPU path at a tiny
size: the NW alignment under rows of the scoring grid."""

import pytest

from benchmark import common
from benchmark.reference import nw
from text_alignment_tpu_torch.align.api import perform_alignment

CONFIG = common.load_json(common.os.path.join(
    common.HERE, "tests", "data", "tiny.json"))
SEED = 2 ** 33 + 7


@pytest.fixture(scope="module")
def page():
    return common.make_pages(CONFIG, SEED, 1)[0]


def test_nw_equals_the_ports_host_fill(page):
    chars = common.injected_ocr(page, common.rng(SEED, 5), 0.08, 0.03)
    o = "".join(c.char for c in chars)
    for row in ([8, -4, -7, -7, -3, 0], [5, -10, -2, -7, 0, -5],
                [11, -7, -5, -2, -5, -3]):
        want = perform_alignment(list(page.transcript), list(o), row,
                                 backend="host")
        assert nw.align(page.transcript, o, row) == want
