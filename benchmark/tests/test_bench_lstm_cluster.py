"""The reader of ``lstm_cluster_pct.jobs_kraken`` on hand-built traces:
host events and device events as (name, start us, end us)."""

from types import SimpleNamespace

import pytest

from benchmark.run import load_reader

WIDE = "void ta_lstm_scan_wide_kernel<1, 256>(float const*, float const*)"


def ctx(host, dev, traced=3):
    return SimpleNamespace(host=sorted(host, key=lambda x: x[1]),
                           dev=sorted(dev, key=lambda x: x[1]),
                           traced=[{}] * traced)


def folio(t0, cluster=True):
    """One traced folio of kraken's network: three layers, each a
    ``ta.ocr.lstm`` span around one wide launch (in a ``ta.lstm.cluster``
    span where the launch took a cluster), and a convolution."""
    host, dev = [("ta.ocr.conv", t0, t0 + 100.0)], [
        ("implicit_convolve_sgemm", t0 + 50.0, t0 + 400.0)]
    for k in range(3):
        s = t0 + 200.0 + 100.0 * k
        host.append(("ta.ocr.lstm", s, s + 50.0))
        if cluster:
            host.append(("ta.lstm.cluster", s + 10.0, s + 20.0))
        dev.append((WIDE, s + 300.0, s + 650.0))
    return host, dev


def trace_of(*folios):
    host, dev = [], []
    for h, d in folios:
        host += h
        dev += d
    return host, dev


READ = load_reader("lstm_cluster_pct.jobs_kraken")


def test_every_wide_launch_in_a_cluster_reads_100():
    host, dev = trace_of(folio(0.0), folio(5000.0), folio(10000.0))
    assert READ(ctx(host, dev)) == 100.0


def test_a_folio_without_clusters_lowers_the_share():
    host, dev = trace_of(folio(0.0), folio(5000.0, cluster=False),
                         folio(10000.0))
    assert READ(ctx(host, dev)) == pytest.approx(200.0 / 3)


@pytest.mark.parametrize("drop", ["span", "kernel"])
def test_no_span_or_no_wide_launch_reads_none(drop):
    host, dev = trace_of(folio(0.0), folio(5000.0))
    if drop == "span":
        host = [e for e in host if e[0] != "ta.lstm.cluster"]
    else:
        dev = [e for e in dev if "wide" not in e[0]]
    assert READ(ctx(host, dev)) is None
