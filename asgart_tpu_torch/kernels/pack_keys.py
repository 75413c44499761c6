"""KA ``pack_keys``: the sort key of every fused-index row, as one int64
word (k <= 20) or two words (k = 21..30: int64 ``w1``, int32 ``w0``).

Kernel: ``csrc/pack_keys.cu`` (see its header for the layout, what it
replaces in the JAX package and how it is bounded): tiles of direct rows
and tiles of one chunk's probe lanes, each staged in shared memory and
rolled (:func:`probe_tiles` is the host's tile table). ``pack_keys_plain``
is the same function in plain PyTorch.
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
# csrc/pack_keys.cu: the direct rows of a tile (kDirectRows) and the probe
# lanes of one (kProbeLanes)
KA_DIRECT_TILE = 2048
KA_PROBE_TILE = 1024


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


def probe_tiles(lane_off) -> list[int]:
    """Each chunk's first probe tile, then the live tiles' count
    (n_chunks + 1 ints): chunk c's lanes [lane_off[c], lane_off[c + 1])
    take ceil(lanes / KA_PROBE_TILE) tiles of their own, so that no tile
    straddles a chunk."""
    tiles = [0]
    for a, b in zip(lane_off, lane_off[1:]):
        tiles.append(tiles[-1] + -(-(b - a) // KA_PROBE_TILE))
    return tiles


def pack_keys(codes: torch.Tensor, specs, k: int, reverse: bool,
              complement: bool, W: int, total: int, ws: int = 0,
              doubled: bool = False):
    """Keys of the W direct text rows then ``total`` probe-lane rows
    (``specs`` = ((chunk_start, chunk_len, n_lanes), ...), lanes
    back-to-back, padded to ``total``) and the probe lane mask.

    The direct text is the window ``codes[ws:ws + W - 1]`` plus its '$'
    (a trim window; the whole genome is ws = 0, W = n1, whose last code
    is the strand's '$'). Probe rows read the whole genome either way.
    The merge-join window engine packs the two sides apart: W = 0 gives
    the probe rows alone (probe-only mode), total = 0 and no specs the
    window's direct rows alone. ``doubled`` (the table engine's build of
    an R/C run: W = 2 n1 - 1, no probe rows) makes the direct text the
    doubled text, the genome and its '$' then the appended half (the
    genome complemented, then reversed), whose rows carry the flag.

    Returns (keys, lane_mask bool [total]): ``keys`` is a list of the
    :func:`key_words` words, [key int64 [W + total]] or [w1 int64,
    w0 int32], most significant first (a list, so that the sort can drop
    each word once it is dead)."""
    n1 = codes.numel()
    if doubled:
        if not (reverse or complement) or ws or specs or total \
                or W != 2 * n1 - 1:
            raise ValueError("pack_keys: the doubled text takes W = 2 n1 - "
                             "1 rows of an R/C run and nothing else")
    elif not (0 <= ws and 0 <= W and ws + W <= n1):
        raise ValueError(f"pack_keys: bad ws={ws} / W={W} for n1={n1}")
    if not 2 <= k <= MAX_K:
        raise ValueError(f"pack_keys: bad k={k}")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("pack_keys: codes must be contiguous uint8")
    lane_off, x0s, cls = chunk_tables(specs, n1, k, reverse, complement)
    if lane_off[-1] > total:
        raise ValueError("pack_keys: total is below the chunks' lanes")
    if not _build.on_cuda(codes):
        return pack_keys_plain(codes, lane_off, x0s, cls, k, reverse,
                               complement, W, total, ws, doubled)
    dev = codes.device
    keys = [torch.empty(W + total, dtype=torch.int64, device=dev)]
    if key_words(k) == 2:
        keys.append(torch.empty(W + total, dtype=torch.int32, device=dev))
    lane_mask = torch.empty(total, dtype=torch.bool, device=dev)
    n_chunks = len(specs)
    tile_off = probe_tiles(lane_off)
    # one table: lane_off, tile_off, then the (x0, cl) pairs
    tab = torch.tensor(lane_off + tile_off + [v for pair in zip(x0s, cls)
                                              for v in pair],
                       dtype=torch.int64)
    if dev.type == "cuda":  # through pinned memory: the host does not wait
        tab = tab.pin_memory().to(dev, non_blocking=True)  # for the card
    tp = tab.data_ptr()
    lib = _build.lib()
    pack_keys.launches += 1
    _build.check(lib.asgart_pack_keys(
        codes.data_ptr(), n1, tp, tp + 8 * (n_chunks + 1),
        tp + 16 * (n_chunks + 1), n_chunks, tile_off[-1], lane_off[-1], W,
        ws, total, k, int(reverse), int(complement), int(doubled),
        keys[0].data_ptr(), keys[1].data_ptr() if len(keys) == 2 else None,
        lane_mask.data_ptr(), _build.stream_of(codes)), "pack_keys")
    return keys, lane_mask


pack_keys.launches = 0


def pack_keys_plain(codes, lane_off, x0s, cls, k, reverse, complement, W,
                    total, ws=0, doubled=False):
    """Plain PyTorch version of the KA kernel (same arguments after
    :func:`chunk_tables`). It widens only the codes it reads (the window,
    and each probe symbol through the transform's index map), so it runs
    beside a genome of any size."""
    dev = codes.device
    n1 = codes.numel()
    step = k // 2
    n_hi = max(k - LO_SYMS, 0)

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

    comp = torch.as_tensor(COMP_CODE, device=dev).to(torch.int64)
    if doubled:  # the genome and its '$', then T(genome)
        half = codes[:n1 - 1].to(torch.int64)
        if complement:
            half = comp[half]
        if reverse:
            half = half.flip(0)
        text = [codes.to(torch.int64), half]
    else:
        text = [codes[ws:ws + max(W - 1, 0)].to(torch.int64)]
    padded = torch.cat(text + [torch.zeros(k + 1, dtype=torch.int64,
                                           device=dev)])
    hi_d, lo, _ = fold(lambda t: padded[t:t + W])
    lo_d = lo << 1  # flag 0
    if doubled:
        lo_d[n1:] |= 1

    n_live = lane_off[-1]
    # the probe source: the transformed text codes[:n1 - 1], complemented
    # then reversed, for R/C runs; the direct text otherwise
    n_src = n1 - 1 if (reverse or complement) else n1
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
        q = q.clamp(0, max(n_src - 1, 0))
        sym = codes[n_src - 1 - q if reverse else q].to(torch.int64)
        return torch.where(live, comp[sym] if complement else sym, 0)

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
