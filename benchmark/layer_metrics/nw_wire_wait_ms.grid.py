"""Host milliseconds a grid spent waiting for the card's traceback wire: the join and the blocking copy to the host, which ends when the fill and the walk are done (the program's ``ta.nw.wire`` span)."""

from benchmark.spans import span_ms

read = span_ms("ta.nw.wire")
