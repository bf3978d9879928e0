"""Device milliseconds a traced folio of the BiLSTM recurrence (``ta_lstm_scan_kernel`` and ``ta_lstm_scan_wide_kernel``, ``models.lstm_kernel``); its byte bound means nothing, as the scan is a chain of dependent steps."""

from benchmark import trace


def read(ctx):
    us, n = trace.kernel_us(ctx.dev, "ta_lstm_scan_")
    return us * 1e-3 / len(ctx.traced) if n and ctx.traced else None
