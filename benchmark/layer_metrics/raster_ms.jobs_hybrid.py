"""Host milliseconds a traced folio in the folio's raster and line finding: the program's ``ta.stage.preprocess`` and ``ta.stage.identify_lines`` spans (``pipeline.process``'s stage timer)."""

from benchmark.spans import span_ms

read = span_ms("ta.stage.preprocess", "ta.stage.identify_lines")
