"""KA ``pack_keys``: the int64 sort key of every fused-index row.

Kernel: ``csrc/pack_keys.cu`` (see its header for what it replaces in the
JAX package and how it is bounded). ``pack_keys_plain`` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..host_helpers import COMP_CODE, _probe_x0
from . import _build

LO_SYMS = 10  # symbols in the low 30 bits (device_index.LO_SYMS)
LO_CLAMP = (1 << 30) - 1
PAD_KEY = ((2**31 - 1) << 31) | (LO_CLAMP << 1) | 1


def chunk_tables(specs, n1: int, k: int, reverse: bool, complement: bool):
    """(lane_off [n_chunks + 1], x0 [n_chunks], cl [n_chunks]) as Python
    ints: each chunk's first lane, and the source position of its probe
    j = 0 in the probe source (the transformed half for R/C runs, the
    direct text otherwise; `_probe_x0` minus the half's base)."""
    base = n1 if (reverse or complement) else 0
    lane_off = [0]
    x0s, cls = [], []
    for (cs, cl, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
        x0s.append(_probe_x0(cs, cl, n1, k, reverse, complement) - base)
        cls.append(cl)
    return lane_off, x0s, cls


def pack_keys(codes: torch.Tensor, specs, k: int, reverse: bool,
              complement: bool, W: int, total: int):
    """Keys of the W direct text rows then ``total`` probe-lane rows
    (``specs`` = ((chunk_start, chunk_len, n_lanes), ...), lanes
    back-to-back, padded to ``total``) and the probe lane mask.

    Returns (key int64 [W + total], lane_mask bool [total])."""
    n1 = codes.numel()
    if not 0 < W <= n1 or not 2 <= k <= 2 * LO_SYMS:
        raise ValueError(f"pack_keys: bad W={W} / k={k} for n1={n1}")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("pack_keys: codes must be contiguous uint8")
    lane_off, x0s, cls = chunk_tables(specs, n1, k, reverse, complement)
    if lane_off[-1] > total:
        raise ValueError("pack_keys: total is below the chunks' lanes")
    if not _build.on_cuda(codes):
        return pack_keys_plain(codes, lane_off, x0s, cls, k, reverse,
                               complement, W, total)
    dev = codes.device
    key = torch.empty(W + total, dtype=torch.int64, device=dev)
    lane_mask = torch.empty(total, dtype=torch.bool, device=dev)
    off_t = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    x0cl = torch.tensor([v for pair in zip(x0s, cls) for v in pair] or [0],
                        dtype=torch.int64, device=dev)
    lib = _build.lib()
    pack_keys.launches += 1
    _build.check(lib.asgart_pack_keys(
        codes.data_ptr(), n1, off_t.data_ptr(), x0cl.data_ptr(),
        len(specs), W, total, k, int(reverse), int(complement),
        key.data_ptr(), lane_mask.data_ptr(), _build.stream_of(codes)),
        "pack_keys")
    return key, lane_mask


pack_keys.launches = 0


def pack_keys_plain(codes, lane_off, x0s, cls, k, reverse, complement, W,
                    total):
    """Plain PyTorch version of the KA kernel (same arguments after
    :func:`chunk_tables`)."""
    dev = codes.device
    n1 = codes.numel()
    step = k // 2
    n_hi = max(k - LO_SYMS, 0)
    c64 = codes.to(torch.int64)

    def fold(sym):  # sym(t) -> int64 symbols; (hi, lo, first symbol)
        hi = lo = first = None
        for t in range(k):
            s = sym(t)
            if t == 0:
                first = s
                hi = torch.zeros_like(s)
                lo = torch.zeros_like(s)
            if t < n_hi:
                hi = (hi << 3) | s
            else:
                lo = (lo << 3) | s
        return hi, lo, first

    padded = torch.cat([c64, torch.zeros(k, dtype=torch.int64, device=dev)])
    hi, lo, _ = fold(lambda t: padded[t:t + W])
    direct = (hi << 31) | (lo << 1)

    n_live = lane_off[-1]
    transformed = reverse or complement
    if transformed:
        src = c64[: n1 - 1]
        if complement:
            src = torch.as_tensor(COMP_CODE, device=dev).to(torch.int64)[src]
        if reverse:
            src = src.flip(0)
    else:
        src = c64
    n_src = src.numel()
    counts = torch.tensor([lane_off[i + 1] - lane_off[i]
                           for i in range(len(x0s))], dtype=torch.int64,
                          device=dev)
    chunk = torch.repeat_interleave(
        torch.arange(len(x0s), device=dev), counts)
    off_t = torch.tensor(lane_off[:-1] or [0], dtype=torch.int64,
                         device=dev)
    j = torch.arange(n_live, dtype=torch.int64, device=dev) - off_t[chunk]
    x0 = torch.tensor(x0s or [0], dtype=torch.int64, device=dev)[chunk]
    cl = torch.tensor(cls or [0], dtype=torch.int64, device=dev)[chunk]
    pos = x0 + j * step

    def probe_sym(t):
        q = pos + t
        live = q < n_src
        return torch.where(live, src[q.clamp(0, max(n_src - 1, 0))], 0)

    if n_live:
        hi, lo, first = fold(probe_sym)
        probe = (hi << 31) | (lo.clamp(max=LO_CLAMP) << 1) | 1
        mask = (first != 4) & (j * step < cl - k - step)
    else:
        probe = torch.zeros(0, dtype=torch.int64, device=dev)
        mask = torch.zeros(0, dtype=torch.bool, device=dev)
    pad = total - n_live
    key = torch.cat([direct, probe,
                     torch.full((pad,), PAD_KEY, dtype=torch.int64,
                                device=dev)])
    lane_mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)])
    return key, lane_mask
