"""KE ``tie_keys`` and KF ``tie_refine``: one round of prefix doubling on
the tied subset, before and after the round's sort.

Kernels: ``csrc/ties.cu`` (see its header for what they replace in the
JAX package and how they are bounded). ``tie_keys_plain`` and
``tie_refine_plain`` are the same functions in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import _build


def _check(name, *pairs):
    for t, dt in pairs:
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: bad dtype or layout")


def tie_keys(ps: torch.Tensor, prims: torch.Tensor, rank: torch.Tensor,
             h: int, bad: torch.Tensor) -> torch.Tensor:
    """Round keys ``(prims << 32) | (rank[ps + h] + 1)`` (int64 [n]) of the
    tied entries (positions ``ps``, group ranks ``prims``, int32 [n]);
    ``rank`` is int32 [W]. An entry with ``ps + h >= W`` sets ``bad``
    (int32 [1], never cleared here) and reads ``rank[W - 1]``."""
    n = ps.numel()
    _check("tie_keys", (ps, torch.int32), (prims, torch.int32),
           (rank, torch.int32), (bad, torch.int32))
    if prims.numel() != n or bad.numel() != 1 or not 0 <= h < 2**31:
        raise ValueError("tie_keys: bad shapes or h")
    if not _build.on_cuda(ps, prims, rank, bad):
        return tie_keys_plain(ps, prims, rank, h, bad)
    key = torch.empty(n, dtype=torch.int64, device=ps.device)
    lib = _build.lib()
    tie_keys.launches += 1
    _build.check(lib.asgart_tie_keys(
        ps.data_ptr(), prims.data_ptr(), rank.data_ptr(), n, rank.numel(),
        h, key.data_ptr(), bad.data_ptr(), _build.stream_of(ps)),
        "tie_keys")
    return key


tie_keys.launches = 0


def tie_keys_plain(ps, prims, rank, h, bad):
    """Plain PyTorch version of the KE kernel."""
    W = rank.numel()
    ph = ps.long() + h
    bad |= (ph >= W).any().to(torch.int32)
    sec = rank[ph.clamp(max=W - 1)].long()
    return (prims.long() << 32) | (sec + 1)


def tie_refine(skey: torch.Tensor, order: torch.Tensor, slots: torch.Tensor,
               ps: torch.Tensor, sa: torch.Tensor, rank: torch.Tensor):
    """Apply one sorted round (``skey`` int64 [n] sorted, ``order`` int64
    [n] its source entries) to the tied entries at ``slots`` (int32 [n],
    ascending) with positions ``ps`` (int32 [n]): writes ``sa[slots[r]] =
    ps[order[r]]`` and each position's new rank, the slot of its sub-run
    start, into ``rank``, both in place.

    Returns (p_sorted int32 [n], rs int32 [n], still bool [n]): the sorted
    positions, their new ranks, and whether each sub-run is still tied
    (longer than one)."""
    n = skey.numel()
    _check("tie_refine", (skey, torch.int64), (order, torch.int64),
           (slots, torch.int32), (ps, torch.int32), (sa, torch.int32),
           (rank, torch.int32))
    if order.numel() != n or slots.numel() != n or ps.numel() != n:
        raise ValueError("tie_refine: entry arrays differ in length")
    if not _build.on_cuda(skey, order, slots, ps, sa, rank):
        return tie_refine_plain(skey, order, slots, ps, sa, rank)
    dev = skey.device
    p_sorted = torch.empty(n, dtype=torch.int32, device=dev)
    rs = torch.empty(n, dtype=torch.int32, device=dev)
    still = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _build.lib()
    tie_refine.launches += 1
    _build.check(lib.asgart_tie_refine(
        skey.data_ptr(), order.data_ptr(), slots.data_ptr(), ps.data_ptr(),
        n, sa.data_ptr(), rank.data_ptr(), p_sorted.data_ptr(),
        rs.data_ptr(), still.data_ptr(), _build.stream_of(skey)),
        "tie_refine")
    return p_sorted, rs, still


tie_refine.launches = 0


def tie_refine_plain(skey, order, slots, ps, sa, rank):
    """Plain PyTorch version of the KF kernel (the JAX package's cummax
    of sub-run start slots)."""
    p_sorted = ps[order]
    new_run = torch.ones_like(skey, dtype=torch.bool)
    new_run[1:] = skey[1:] != skey[:-1]
    rs = torch.cummax(torch.where(new_run, slots.long(), -1), 0).values
    rs = rs.to(torch.int32)
    sa[slots.long()] = p_sorted
    rank[p_sorted.long()] = rs
    same = rs[1:] == rs[:-1]
    still = torch.zeros_like(new_run)
    still[:-1] |= same
    still[1:] |= same
    return p_sorted, rs, still
