"""Share of the traced wide-route scans that ran as a thread-block cluster: 100 x the program's ``ta.lstm.cluster`` spans (``models.lstm_kernel.bidir_scan_cuda`` opens one around each wide launch in clusters of more than one CTA) over the traced ``ta_lstm_scan_wide_kernel`` device events; None where either is missing (a program without the span)."""

from benchmark import trace


def read(ctx):
    spans = sum(name == "ta.lstm.cluster" for name, _, _ in ctx.host)
    _, launches = trace.kernel_us(ctx.dev, "ta_lstm_scan_wide_kernel")
    if not spans or not launches:
        return None
    return 100.0 * spans / launches
