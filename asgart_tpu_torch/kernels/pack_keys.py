"""KA ``pack_keys``: the sort key of every fused-index row, as one int64
word (k <= 20) or two words (k = 21..30: int64 ``w1``, int32 ``w0``).

Kernel: ``csrc/pack_keys.cu`` (see its header for the layout, what it
replaces in the JAX package and how it is bounded). ``pack_keys_plain`` is
the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..host_helpers import COMP_CODE, _probe_x0
from . import _build

LO_SYMS = 10  # symbols in the low 30 bits (device_index.LO_SYMS)
LO_CLAMP = (1 << 30) - 1
PLANE_MAX = 2**31 - 1  # the JAX pad sentinel of every plane
PAD_KEY = (PLANE_MAX << 31) | (LO_CLAMP << 1) | 1
PAD_KEY2 = ((PLANE_MAX << 31) | PLANE_MAX, (LO_CLAMP << 1) | 1)
MAX_K = 3 * LO_SYMS  # two words hold three 30-bit symbol planes


def key_words(k: int) -> int:
    """Words of the fused sort key at probe size ``k``: one int64 up to
    two 30-bit symbol planes and the flag (k <= 20), else two."""
    return 1 if k <= 2 * LO_SYMS else 2


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
              complement: bool, W: int, total: int, ws: int = 0):
    """Keys of the W direct text rows then ``total`` probe-lane rows
    (``specs`` = ((chunk_start, chunk_len, n_lanes), ...), lanes
    back-to-back, padded to ``total``) and the probe lane mask.

    The direct text is the window ``codes[ws:ws + W - 1]`` plus its '$'
    (a trim window; the whole genome is ws = 0, W = n1, whose last code
    is the strand's '$'). Probe rows read the whole genome either way.
    The merge-join window engine packs the two sides apart: W = 0 gives
    the probe rows alone (probe-only mode), total = 0 and no specs the
    window's direct rows alone.

    Returns (keys, lane_mask bool [total]): ``keys`` is a list of the
    :func:`key_words` words, [key int64 [W + total]] or [w1 int64,
    w0 int32], most significant first (a list, so that the sort can drop
    each word once it is dead)."""
    n1 = codes.numel()
    if not (0 <= ws and 0 <= W and ws + W <= n1) or not 2 <= k <= MAX_K:
        raise ValueError(f"pack_keys: bad ws={ws} / W={W} / k={k} for "
                         f"n1={n1}")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("pack_keys: codes must be contiguous uint8")
    lane_off, x0s, cls = chunk_tables(specs, n1, k, reverse, complement)
    if lane_off[-1] > total:
        raise ValueError("pack_keys: total is below the chunks' lanes")
    if not _build.on_cuda(codes):
        return pack_keys_plain(codes, lane_off, x0s, cls, k, reverse,
                               complement, W, total, ws)
    dev = codes.device
    keys = [torch.empty(W + total, dtype=torch.int64, device=dev)]
    if key_words(k) == 2:
        keys.append(torch.empty(W + total, dtype=torch.int32, device=dev))
    lane_mask = torch.empty(total, dtype=torch.bool, device=dev)
    off_t = torch.tensor(lane_off, dtype=torch.int64, device=dev)
    x0cl = torch.tensor([v for pair in zip(x0s, cls) for v in pair] or [0],
                        dtype=torch.int64, device=dev)
    lib = _build.lib()
    pack_keys.launches += 1
    _build.check(lib.asgart_pack_keys(
        codes.data_ptr(), n1, off_t.data_ptr(), x0cl.data_ptr(),
        len(specs), W, ws, total, k, int(reverse), int(complement),
        keys[0].data_ptr(), keys[1].data_ptr() if len(keys) == 2 else None,
        lane_mask.data_ptr(), _build.stream_of(codes)), "pack_keys")
    return keys, lane_mask


pack_keys.launches = 0


def pack_keys_plain(codes, lane_off, x0s, cls, k, reverse, complement, W,
                    total, ws=0):
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

    padded = torch.cat([c64[ws:ws + max(W - 1, 0)],
                        torch.zeros(k + 1, dtype=torch.int64, device=dev)])
    hi_d, lo, _ = fold(lambda t: padded[t:t + W])
    lo_d = lo << 1  # flag 0

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
        hi_p, lo, first = fold(probe_sym)
        lo_p = (lo.clamp(max=LO_CLAMP) << 1) | 1  # flag 1
        mask = (first != 4) & (j * step < cl - k - step)
    else:
        hi_p = lo_p = torch.zeros(0, dtype=torch.int64, device=dev)
        mask = torch.zeros(0, dtype=torch.bool, device=dev)
    pad = total - n_live
    lane_mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)])
    if key_words(k) == 1:
        key = (torch.cat([hi_d, hi_p]) << 31) | torch.cat([lo_d, lo_p])
        return [_pad(key, PAD_KEY, pad)], lane_mask
    hi = torch.cat([hi_d, hi_p])
    w1 = ((hi >> 30) << 31) | (hi & LO_CLAMP)
    w0 = torch.cat([lo_d, lo_p]).to(torch.int32)
    return [_pad(w1, PAD_KEY2[0], pad), _pad(w0, PAD_KEY2[1], pad)], \
        lane_mask


def _pad(word, value, pad):
    return torch.cat([word, torch.full((pad,), value, dtype=word.dtype,
                                       device=word.device)])
