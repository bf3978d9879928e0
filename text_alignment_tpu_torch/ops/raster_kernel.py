"""Launch wrapper of the rotate + erode + project kernel of
``csrc/raster.cu`` (``ta_raster_rotate_erode``).

It replaces the torch chain that carried the JAX package's XLA ops of
``text_alignment_tpu/ops/device.py`` ``rotate_erode_project`` over: the
plain version, and the dispatch between the two, are in :mod:`.device`
(``rotate_erode_project_packed``). The wrapper takes a contiguous (H, Wq)
int32 bit-packed page on a CUDA device, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and counts its launch in ``_kernels.launches``. The input
page is held by the caller's name until the C call returns.
"""

from __future__ import annotations

import torch

from .. import _kernels


def rotate_erode_cuda(page, H: int, W: int, cfix: int, sfix: int, H2: int,
                      W2: int):
    """``ta_raster_rotate_erode``: (rotated page, eroded page) (H2,
    ceil(W2/32)) int32 and the eroded page's row projection (H2,) int32."""
    Wq2 = -(-int(W2) // 32)
    rot = torch.empty((H2, Wq2), dtype=torch.int32, device=page.device)
    ero = torch.empty_like(rot)
    proj = torch.empty(H2, dtype=torch.int32, device=page.device)
    code = _kernels.lib().ta_raster_rotate_erode(
        page.data_ptr(), rot.data_ptr(), ero.data_ptr(), proj.data_ptr(),
        int(H), int(page.shape[1]), int(W), int(H2), int(W2), int(cfix),
        int(sfix), page.device.index, _kernels.stream_handle(page.device))
    _kernels.check(code, "raster_rotate_erode launch")
    _kernels.launches["raster_rotate_erode"] += 1
    return rot, ero, proj
