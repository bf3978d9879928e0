"""The operations of the traced training steps of kraken's network (the forward of ``work/ocr_vgsl.py``'s network and a backward of twice its operations; ``work/vgsl_train.py``) over the traced window's time and the card's float32 operation rate."""

from benchmark.readers import mfu

read = mfu("vgsl_train")
