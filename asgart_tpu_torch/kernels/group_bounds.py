"""KB ``group_bounds``: run boundaries over the sorted fused keys.

Kernel: ``csrc/group_bounds.cu``. ``group_bounds_plain`` is the same
function in plain PyTorch (the cummax formulation of the JAX package).
"""

from __future__ import annotations

import torch

from . import _build


def group_bounds(skey: torch.Tensor, sa: torch.Tensor, W: int):
    """(run_lo int32 [M], run_hi int32 [M], tied bool [M]) for the sorted
    keys ``skey`` (int64) and their rows ``sa`` (int32): run_lo is the
    true-key (flag-free) run start, run_hi is run_lo for direct rows
    (sa < W) and the full-key run start for probe rows, tied marks direct
    rows whose full-key run is longer than one."""
    M = skey.numel()
    if skey.dtype != torch.int64 or sa.dtype != torch.int32 \
            or sa.numel() != M or not (skey.is_contiguous()
                                       and sa.is_contiguous()):
        raise ValueError("group_bounds: skey int64 and sa int32, "
                         "contiguous, of one length")
    if not _build.on_cuda(skey, sa):
        return group_bounds_plain(skey, sa, W)
    dev = skey.device
    run_lo = torch.empty(M, dtype=torch.int32, device=dev)
    run_hi = torch.empty(M, dtype=torch.int32, device=dev)
    tied = torch.empty(M, dtype=torch.bool, device=dev)
    lib = _build.lib()
    group_bounds.launches += 1
    _build.check(lib.asgart_group_bounds(
        skey.data_ptr(), sa.data_ptr(), M, W, run_lo.data_ptr(),
        run_hi.data_ptr(), tied.data_ptr(), _build.stream_of(skey)),
        "group_bounds")
    return run_lo, run_hi, tied


group_bounds.launches = 0


def group_bounds_plain(skey, sa, W):
    """Plain PyTorch version of the KB kernel."""
    M = skey.numel()
    dev = skey.device
    iota = torch.arange(M, device=dev)

    def starts(v):
        neq = torch.ones(M, dtype=torch.bool, device=dev)
        neq[1:] = v[1:] != v[:-1]
        return neq

    neq_true = starts(skey >> 1)
    neq_full = starts(skey)
    run_lo = torch.cummax(torch.where(neq_true, iota, 0), 0).values
    run_lo_full = torch.cummax(torch.where(neq_full, iota, 0), 0).values
    direct = sa < W
    run_hi = torch.where(direct, run_lo, run_lo_full)
    nxt = torch.ones(M, dtype=torch.bool, device=dev)
    nxt[:-1] = neq_full[1:]
    tied = direct & ~(neq_full & nxt)
    return run_lo.to(torch.int32), run_hi.to(torch.int32), tied
