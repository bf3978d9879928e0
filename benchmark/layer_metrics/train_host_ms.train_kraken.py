"""Host milliseconds a traced training step in the program's spans around its phases (``models.train.VGSLTrainer.step``: ``ta.train.forward``, ``ta.train.loss``, ``ta.train.backward``, ``ta.train.update``)."""

from benchmark.spans import span_ms

read = span_ms("ta.train.forward", "ta.train.loss", "ta.train.backward",
               "ta.train.update")
