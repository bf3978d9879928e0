"""NW alignment of the port: ``perform_alignment``, ``align_grid`` and the
batched ``nw_torch.align_pairs``, on the host or on a torch device."""

from .scoring import DEFAULT_SYS, BOUNDARY_GAP_EXTEND, resolve_scoring, Scoring
from .api import align_grid, perform_alignment, resolve_device

__all__ = [
    "DEFAULT_SYS",
    "BOUNDARY_GAP_EXTEND",
    "resolve_scoring",
    "Scoring",
    "align_grid",
    "perform_alignment",
    "resolve_device",
]
