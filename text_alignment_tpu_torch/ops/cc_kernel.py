"""Launch wrappers of the connected-components kernels of
``csrc/cc_filter.cu``: one filter pass (``cc_filter``), the stats table
(``cc_table``) and the three-pass cleanup chain (``cc_clean``).

They replace the Pallas kernel ``text_alignment_tpu/ops/cc_pallas.py``
``_make_filter_kernel`` behind its entry points ``_run_filter``,
``cc_table_packed`` and ``preproc_clean_packed``. Each takes a contiguous
(H, Wq) int32 bit-packed page on a CUDA device, allocates its outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream without
synchronising, and counts its launch in ``_kernels.launches``; the chain
runs the filter pass three times, so it counts one ``cc_clean`` and three
``cc_filter`` launches. The plain PyTorch versions, and the dispatch
between the two, are in :mod:`.cc`.

Every tensor a launch uses is held by a local name until the C call has
returned. A temporary's block would go back to PyTorch's caching allocator
before the kernels are queued, and ctypes releases the GIL during the call:
another thread issuing on the same stream (the batch's OCR worker) could
then be handed the block and write into it between the kernel's passes.
"""

from __future__ import annotations

import torch

from .. import _kernels


def _scratch(page, H: int, R: int):
    n = _kernels.lib().ta_cc_scratch_ints(H, R)
    return torch.empty(n, dtype=torch.int32, device=page.device)


def filter_cuda(page, H: int, W: int, thresh: int, mode: int, by_area: bool,
                max_runs: int):
    """``ta_cc_filter``: (painted page (H, Wq) int32, ok (2,) int32)."""
    Wq = page.shape[1]
    out = torch.empty_like(page)
    ok = torch.empty(2, dtype=torch.int32, device=page.device)
    scratch = _scratch(page, H, max_runs)
    code = _kernels.lib().ta_cc_filter(
        page.data_ptr(), out.data_ptr(), ok.data_ptr(),
        scratch.data_ptr(), H, Wq, W, int(thresh),
        int(mode), int(by_area), int(max_runs), page.device.index,
        _kernels.stream_handle(page.device))
    _kernels.check(code, "cc_filter launch")
    _kernels.launches["cc_filter"] += 1
    return out, ok


def table_cuda(page, H: int, W: int, thresh: int, max_ccs: int,
               max_runs: int):
    """``ta_cc_table``: (table (max_ccs, 5) int32, ok (2,) int32)."""
    Wq = page.shape[1]
    table = torch.empty((max_ccs, 5), dtype=torch.int32, device=page.device)
    ok = torch.empty(2, dtype=torch.int32, device=page.device)
    scratch = _scratch(page, H, max_runs)
    code = _kernels.lib().ta_cc_table(
        page.data_ptr(), table.data_ptr(), ok.data_ptr(),
        scratch.data_ptr(), H, Wq, W, int(thresh),
        int(max_ccs), int(max_runs), page.device.index,
        _kernels.stream_handle(page.device))
    _kernels.check(code, "cc_table launch")
    _kernels.launches["cc_table"] += 1
    return table, ok


def clean_cuda(page, H: int, W: int, despeckle_amt: int,
               sat_area_thresh: int, by_area: bool, max_runs: int):
    """``ta_cc_clean``: (page (H, Wq) int32, ok (1,) int32)."""
    Wq = page.shape[1]
    out = torch.empty_like(page)
    tmp = torch.empty((2, H, Wq), dtype=torch.int32, device=page.device)
    oks = torch.empty(7, dtype=torch.int32, device=page.device)
    scratch = _scratch(page, H, max_runs)
    code = _kernels.lib().ta_cc_clean(
        page.data_ptr(), out.data_ptr(), tmp[0].data_ptr(),
        tmp[1].data_ptr(), oks.data_ptr(), oks[6:].data_ptr(),
        scratch.data_ptr(), H, Wq, W,
        int(despeckle_amt), int(sat_area_thresh), int(by_area),
        int(max_runs), page.device.index,
        _kernels.stream_handle(page.device))
    _kernels.check(code, "cc_clean launch")
    _kernels.launches["cc_clean"] += 1
    _kernels.launches["cc_filter"] += 3  # its three filter passes
    return out, oks[6:]
