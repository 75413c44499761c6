"""KB ``group_bounds``: run boundaries over the sorted fused keys.

Kernel: ``csrc/group_bounds.cu``. ``group_bounds_plain`` is the same
function in plain PyTorch (the cummax formulation of the JAX package).
"""

from __future__ import annotations

import torch

from . import _build


def n_flag_shift(k: int, words: int) -> int:
    """The right shift that brings a key's first symbol (3 bits) to the
    bottom of its first word: the top plane of two words (k = 21..30), the
    hi part of one (k = 11..20), else the lo part above the flag."""
    if words == 2:
        return 31 + 3 * (k - 21)
    return 31 + 3 * (k - 11) if k > 10 else 1 + 3 * (k - 1)


def group_bounds(skeys, sa: torch.Tensor, W: int, flag_n_k: int = 0,
                 run_end: bool = False):
    """(run_lo int32 [M], run_hi int32 [M], tied bool [M]) for the sorted
    keys ``skeys`` (the words of :func:`~.pack_keys.pack_keys`, sorted:
    [skey int64] or [sw1 int64, sw0 int32]; the flag is bit 0 of the last
    word) and their rows ``sa`` (int32): run_lo is the true-key
    (flag-free) run start, run_hi is run_lo for direct rows (sa < W) and
    the full-key run start for probe rows, tied marks direct rows whose
    full-key run is longer than one.

    The table build's options (the JAX ``_group_bounds`` with
    ``flag_n_k``): ``flag_n_k`` = k sets run_lo's sign bit on rows whose
    k-mer starts with N; ``run_end`` gives direct rows their full-key run
    end (exclusive) in run_hi instead."""
    M = sa.numel()
    dtypes = (torch.int64, torch.int32)[:len(skeys)]
    if not 1 <= len(skeys) <= 2 or sa.dtype != torch.int32 \
            or not sa.is_contiguous() \
            or any(w.dtype != dt or w.numel() != M or not w.is_contiguous()
                   for w, dt in zip(skeys, dtypes)):
        raise ValueError("group_bounds: skeys [int64] or [int64, int32] "
                         "and sa int32, contiguous, of one length")
    n_shift = n_flag_shift(flag_n_k, len(skeys)) if flag_n_k else -1
    if not _build.on_cuda(*skeys, sa):
        return group_bounds_plain(skeys, sa, W, n_shift, run_end)
    dev = sa.device
    run_lo = torch.empty(M, dtype=torch.int32, device=dev)
    run_hi = torch.empty(M, dtype=torch.int32, device=dev)
    tied = torch.empty(M, dtype=torch.bool, device=dev)
    lib = _build.lib()
    group_bounds.launches += 1
    _build.check(lib.asgart_group_bounds(
        skeys[0].data_ptr(),
        skeys[1].data_ptr() if len(skeys) == 2 else None, sa.data_ptr(), M,
        W, n_shift, int(run_end), run_lo.data_ptr(), run_hi.data_ptr(),
        tied.data_ptr(),
        _build.stream_of(sa)), "group_bounds")
    return run_lo, run_hi, tied


group_bounds.launches = 0


def group_bounds_plain(skeys, sa, W, n_shift=-1, run_end=False):
    """Plain PyTorch version of the KB kernel (``n_shift``: the first
    symbol's shift, or -1 for no N flag)."""
    M = sa.numel()
    dev = sa.device
    iota = torch.arange(M, device=dev)

    def starts(*words):
        neq = torch.zeros(M, dtype=torch.bool, device=dev)
        neq[0] = True
        for v in words:
            neq[1:] |= v[1:] != v[:-1]
        return neq

    neq_true = starts(*skeys[:-1], skeys[-1] >> 1)
    neq_full = starts(*skeys)
    run_lo = torch.cummax(torch.where(neq_true, iota, 0), 0).values
    run_lo_full = torch.cummax(torch.where(neq_full, iota, 0), 0).values
    direct = sa < W
    nxt = torch.ones(M, dtype=torch.bool, device=dev)
    nxt[:-1] = neq_full[1:]
    if run_end:  # first boundary after each row, a reverse cummin
        ends = torch.where(nxt, iota + 1, M).flip(0)
        own = torch.cummin(ends, 0).values.flip(0)
    else:
        own = run_lo
    run_hi = torch.where(direct, own, run_lo_full)
    tied = direct & ~(neq_full & nxt)
    run_lo = run_lo.to(torch.int32)
    if n_shift >= 0:
        first = (skeys[0] >> n_shift) & 7
        run_lo = torch.where(first == 4, run_lo | (-2**31), run_lo)
    return run_lo, run_hi.to(torch.int32), tied
