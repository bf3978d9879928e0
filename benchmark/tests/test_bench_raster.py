"""The readers of the folio raster's per-layer metrics
(``raster_ms.jobs_hybrid``, ``raster_ms.jobs_kraken``,
``raster_card_pct.jobs_hybrid``) on hand-built traces: host events as
(name, start us, end us)."""

from types import SimpleNamespace

import pytest

from benchmark.run import load_reader

RASTER_MS = ("raster_ms.jobs_hybrid", "raster_ms.jobs_kraken")


def ctx(host, traced=3):
    return SimpleNamespace(host=sorted(host, key=lambda x: x[1]), dev=[],
                           traced=[{}] * traced)


def folio(t0, pre_us, lines_us, card=True):
    """One traced folio's host events from ``t0``: the card route's span
    around the preprocess and line-finding stages, then the OCR stage."""
    t1 = t0 + pre_us
    t2 = t1 + lines_us
    events = [("ta.stage.preprocess", t0, t1),
              ("aten::cat", t0 + 10.0, t0 + 20.0),
              ("ta.stage.identify_lines", t1, t2),
              ("ta.stage.ocr", t2, t2 + 4000.0)]
    if card:
        events.append(("ta.raster.card", t0, t2))
    return events


HOST = (folio(0.0, 6000.0, 1500.0) + folio(20000.0, 5000.0, 1000.0)
        + folio(40000.0, 7000.0, 2000.0))


@pytest.mark.parametrize("name", RASTER_MS)
def test_raster_ms_is_the_stages_ms_a_traced_folio(name):
    want = (7.5 + 6.0 + 9.0) / 3
    assert load_reader(name)(ctx(HOST)) == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("name", RASTER_MS)
def test_raster_ms_with_no_stage_span_reads_none(name):
    host = [("ta.stage.ocr", 0.0, 10.0), ("aten::cat", 0.0, 1.0),
            ("stage.preprocess", 20.0, 30.0)]
    assert load_reader(name)(ctx(host)) is None


def test_raster_card_pct_reads_100_with_one_span_a_traced_folio():
    assert load_reader("raster_card_pct.jobs_hybrid")(ctx(HOST)) == 100.0


def test_raster_card_pct_counts_the_folios_that_took_the_card():
    host = (folio(0.0, 6000.0, 1500.0)
            + folio(20000.0, 30000.0, 3000.0, card=False)
            + folio(60000.0, 7000.0, 2000.0, card=False)
            + folio(80000.0, 5000.0, 1000.0))
    got = load_reader("raster_card_pct.jobs_hybrid")(ctx(host, traced=4))
    assert got == pytest.approx(50.0)


def test_raster_card_pct_with_no_card_span_reads_none():
    host = [e for e in HOST if e[0] != "ta.raster.card"]
    assert load_reader("raster_card_pct.jobs_hybrid")(ctx(host)) is None
