"""NW alignment of the port: ``perform_alignment``, ``align_grid`` and the
batched ``nw_torch.align_pairs``, on the host or on a torch device."""

from .api import align_grid, perform_alignment, resolve_device

__all__ = ["align_grid", "perform_alignment", "resolve_device"]
