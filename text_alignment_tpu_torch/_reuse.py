"""The one doorway from the port to the JAX package's framework-free host code.

The host stages of the slice (the native C++ raster, line segmentation,
syllabification, the NW scoring forms, host fill and traceback, assembly,
``.pyrnn`` I/O, the scipy line normalizer, the evaluation metrics and the
synthetic page generator) never touch JAX, but their
packages' ``__init__`` files do: ``ops/__init__.py`` imports ``ops.device``,
``models/__init__.py`` imports ``lstm_jax`` and ``pipeline/__init__.py``
imports ``process``. Importing ``text_alignment_tpu.pipeline.preprocess``
therefore pulls JAX in, and the machine with the card has no JAX.

So this module builds a private alias of the package tree under
``text_alignment_tpu_torch._host``: every alias package's ``__path__``
points at the real directory, so the real source files load from disk,
and relative imports inside them resolve inside the alias tree.

- ``_host`` itself, ``_host.ops``, ``_host.models`` and ``_host.pipeline``
  are empty stubs: their JAX-importing ``__init__`` files never run.
- ``_host.align``, ``_host.lang`` and ``_host.utils`` run their real
  ``__init__``, which is JAX-free.

The real ``text_alignment_tpu.*`` names are never registered, so a process
that also imports the JAX package (the parity tests) keeps two independent
copies and neither sees the other. ``ops.host_native`` still finds
``native/raster.cpp`` because each module's ``__file__`` is its real path.
No host code is copied into the port.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_REAL_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "text_alignment_tpu",
)
_ALIAS = __name__.rsplit(".", 1)[0] + "._host"
_STUBS = ("ops", "models", "pipeline")


def _stub(name: str, path: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__path__ = [path]
    mod.__package__ = name
    mod.__spec__ = importlib.util.spec_from_loader(name, loader=None,
                                                   is_package=True)
    mod.__spec__.submodule_search_locations = [path]
    sys.modules[name] = mod
    return mod


def _install() -> None:
    if _ALIAS in sys.modules:
        return
    if not os.path.isdir(_REAL_ROOT):
        raise ImportError(
            f"the JAX package's host code is not at {_REAL_ROOT}; the port "
            "reuses it from a checkout of the repository")
    _stub(_ALIAS, _REAL_ROOT)
    for sub in _STUBS:
        _stub(f"{_ALIAS}.{sub}", os.path.join(_REAL_ROOT, sub))


def _mod(relname: str):
    return importlib.import_module(f"{_ALIAS}.{relname}")


_install()

_preprocess = _mod("pipeline.preprocess")
_assemble = _mod("pipeline.assemble")
_lineest = _mod("models.lineest")
_pyrnn = _mod("models.pyrnn")

preprocess_images = _preprocess.preprocess_images
identify_text_lines = _preprocess.identify_text_lines
PreprocParams = _preprocess.PreprocParams
SAT_AREA_THRESH_AREA = _preprocess.SAT_AREA_THRESH_AREA

llocs_to_charboxes = _assemble.llocs_to_charboxes
expand_abbreviations = _assemble.expand_abbreviations
group_syllables = _assemble.group_syllables
rotate_bboxes = _assemble.rotate_bboxes

syllabify_text = _mod("lang.syllabify").syllabify_text
filename_to_text_func = _mod("lang").filename_to_text_func
auto_device_min_cells = _mod("align.api").auto_device_min_cells
stage_timer = _mod("utils.timing").stage_timer
load_charboxes = _mod("utils.ref_pickle").load_charboxes

load_pyrnn = _pyrnn.load_pyrnn
save_pyrnn = _pyrnn.save_pyrnn
Codec = _mod("models.codec").Codec
lineest = _lineest
DEFAULT_PAD = _lineest.DEFAULT_PAD
DEFAULT_TARGET_HEIGHT = _lineest.DEFAULT_TARGET_HEIGHT

_scoring = _mod("align.scoring")
resolve_scoring = _scoring.resolve_scoring
Scoring = _scoring.Scoring
BOUNDARY_GAP_EXTEND = _scoring.BOUNDARY_GAP_EXTEND
fill_host = _mod("align.nw_host").fill_host
_traceback = _mod("align.traceback")
traceback = _traceback.traceback
DensePtrView = _traceback.DensePtrView
DiagPtrView = _traceback.DiagPtrView

_evaluate = _mod("evaluate")
scoring_grid = _evaluate.scoring_grid
DEFAULT_GRID = _evaluate.DEFAULT_GRID
evaluate_alignment = _evaluate.evaluate_alignment
parse_gt_xml = _evaluate.parse_gt_xml

_synth = _mod("synth")
make_page = _synth.make_page
corrupt_ocr = _synth.corrupt_ocr
ocr_with_spaces = _synth.ocr_with_spaces


def draw_results_on_page(*args, **kwargs):
    """``pipeline.render.draw_results_on_page``; imported on call because
    it needs Pillow."""
    return _mod("pipeline.render").draw_results_on_page(*args, **kwargs)
