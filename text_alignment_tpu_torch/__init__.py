"""text_alignment_tpu_torch — the PyTorch and CUDA port of text_alignment_tpu.

Aligns a chant transcript to the text layer of a manuscript page and emits
the reference's ``syl_boxes`` JSON, like ``text_alignment_tpu``, whose JAX
package stays beside it as the reference the port is tested against.

Layer map of the slices ported so far (one folio through ``process()``, NW
alignment and the scoring grid search):

- ``pipeline.process`` — ``process()`` and ``to_JSON_dict``. The raster,
  line segmentation and assembly are the JAX package's framework-free host
  code, reached through ``_reuse``.
- ``evaluate`` — ``grid_search`` over the scoring grid.
- ``align.api`` — ``perform_alignment`` and ``align_grid``: NW on the host
  fill or on a device. ``align.nw_torch`` — one pair, batches of pairs
  (``align_pairs``) and the grid on a device. ``align.nw_kernel`` — the
  wavefront fill, the batched fill and the pointer walk, each a
  hand-written CUDA kernel beside its plain PyTorch version.
- ``models.recognizer`` — ``SeqRecognizer``: bit-packed strips -> line
  normalizer -> BiLSTM -> CTC region decode -> uint16 wire, on one device.
- ``models.lineest`` / ``models.lineest_kernel`` — the batched line
  normalizer; its center-finding tail is a hand-written CUDA kernel.
- ``models.lstm`` / ``models.lstm_kernel`` — the BiLSTM; its recurrence is
  a hand-written CUDA kernel.
- ``models.ctc`` — batched CTC decode.
- ``_kernels`` — builds ``csrc/*.cu`` with ``nvcc`` at first CUDA use and
  binds it with ``ctypes``.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
