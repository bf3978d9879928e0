"""Recognizer models of the port: BiLSTM, CTC decode, line normalizer, and
their CUDA kernels."""

from .codec import Codec
from .lstm import BiLSTMParams, LSTMParams, bilstm_forward_batched
from .recognizer import SeqRecognizer
from .pyrnn import load_pyrnn, save_pyrnn

__all__ = [
    "Codec",
    "LSTMParams",
    "BiLSTMParams",
    "bilstm_forward_batched",
    "SeqRecognizer",
    "load_pyrnn",
    "save_pyrnn",
]
