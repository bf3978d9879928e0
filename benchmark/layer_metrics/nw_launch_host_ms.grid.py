"""Host milliseconds a grid of the NW path's encoding and launches: ids, buckets, scoring rows, lane layout and uploads, and the host side of each fill and traceback launch (the program's ``ta.nw.encode``, ``ta.nw.fill`` and ``ta.nw.walk`` spans)."""

from benchmark.spans import span_ms

read = span_ms("ta.nw.encode", "ta.nw.fill", "ta.nw.walk")
