"""Host milliseconds a grid of the replay of every row's op stream into aligned lists (the program's ``ta.nw.replay`` span)."""

from benchmark.spans import span_ms

read = span_ms("ta.nw.replay")
