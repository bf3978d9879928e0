"""text_alignment_tpu_torch — the PyTorch and CUDA port of text_alignment_tpu.

Aligns a chant transcript to the text layer of a manuscript page and emits
the reference's ``syl_boxes`` JSON, like ``text_alignment_tpu``, whose JAX
package stays beside it as the reference the port is tested against.

Layer map of the slices ported so far (one folio through ``process()``, NW
alignment and the scoring grid search, the manuscript batch, serving):

- ``serve`` — the spool-directory server (``serve``, ``warmup``), the entry
  point of a deployment; ``rodan_job`` — the Rodan task body;
  ``verify_reference`` — the real-asset parity harness; ``mei`` — the MEI
  merge; ``cli`` — ``align``, ``serve``, ``evaluate``, ``mei``,
  ``verify-reference``.
- ``parallel.batch`` — ``process_batch``: many folios stage-major, the OCR
  queued on the card while the host rasters the next folio, NW batched by
  size bucket; the raster on the engine ``process()`` takes.
- ``pipeline.process`` — ``process()`` and ``to_JSON_dict``.
- ``pipeline.preprocess`` / ``pipeline.assemble`` / ``pipeline.render`` —
  the raster, line segmentation and assembly (``preprocess.raster_backend``
  picks the raster engine: on a card ``"hybrid"`` and ``"device"`` both
  take ``ops.device``): the port's own copies of the JAX package's
  framework-free host code (as are ``lang``, ``charbox``,
  ``textio``, ``synth``, ``models.codec``, ``models.pyrnn``,
  ``models.lineest_host``, ``align.scoring``, ``align.nw_host``,
  ``align.traceback``, ``utils`` (timing, the stage cache, the OCR-pickle
  loader), ``mei`` and ``ops.oracle`` / ``fixedpoint`` /
  ``projections`` / ``host_native``).
- ``ops.device`` — the raster on a device: the cleanup chain, the skew
  search (``ops.skew_device``), rotation, erosion and projection on the
  bit-packed page (``ops.raster_kernel``), the separator-masked CC table.
- ``ops.cc`` / ``ops.cc_kernel`` — connected components over a bit-packed
  page (filter pass, cleanup chain, stats table), hand-written CUDA kernels
  beside their plain PyTorch version.
- ``evaluate`` — ``grid_search`` over the scoring grid.
- ``align.api`` — ``perform_alignment`` and ``align_grid``: NW on the host
  fill or on a device. ``align.nw_torch`` — one pair, batches of pairs
  (``align_pairs``) and the grid on a device. ``align.nw_kernel`` — the
  wavefront fill, the batched fill and the pointer walk, each a
  hand-written CUDA kernel beside its plain PyTorch version.
- ``models.recognizer`` — ``SeqRecognizer``: bit-packed strips -> line
  normalizer -> BiLSTM -> CTC region decode -> uint16 wire, on one device.
- ``models.lineest`` / ``models.lineest_kernel`` — the batched line
  normalizer; its center-finding tail is a hand-written CUDA kernel, and so
  is the whole center chain from the ink mask
  (``TEXT_ALIGNMENT_TPU_TAIL=full``).
- ``models.lstm`` / ``models.lstm_kernel`` — the BiLSTM; its recurrence is
  a hand-written CUDA kernel.
- ``models.ctc`` — batched CTC decode.
- ``_kernels`` — builds ``csrc/*.cu`` with ``nvcc`` at first CUDA use and
  binds it with ``ctypes``.

The package imports ``torch`` and never ``jax``, nor any file of the JAX
package. Its entry points run on the card unless the caller names the CPU
(``device="cpu"``, CLI ``--device cpu``); without a card they raise.
"""

__version__ = "0.1.0"

from .charbox import CharBox
from .textio import read_file

__all__ = ["CharBox", "read_file", "__version__"]
