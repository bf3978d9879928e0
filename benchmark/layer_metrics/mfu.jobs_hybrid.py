"""The BiLSTM's operations (input projection, recurrence, output layer; ``work/ocr.py``) of the traced folios over the traced window's time and the card's float32 operation rate."""

from benchmark.readers import mfu

read = mfu("bilstm")
