"""The fused-probe index on one device: the whole genome or one trim window.

Counterpart of ``FusedIndex`` / ``FusedIndex.build`` and ``fused_fits``
(asgart_tpu/device_index.py:1571-1787) at k = 2..30, of
``fused_window_applicable`` (asgart_tpu/device_engine.py:2140; both fit
checks are :func:`fits` here), of the merge-join window fit
``device_window_fits`` (device_index.py:161; :func:`mj_fits` here), plus a
one-entry device index cache for either index type (the counterpart of
``cached_build``, device_index.py:1064).

The direct text's W key rows (the whole genome, W = n1, or a trim window
[ws, we) with its own '$', W = we - ws + 1) and every chunk's probe-lane
rows (always the whole genome's) are sorted together; equal-key runs then
give each probe lane its window [lane_lo, lane_hi) of direct suffixes,
and tie resolution turns the k-mer order into the suffix order. Build
steps and their kernels:

  upload codes (codes.py) -> KA pack_keys -> sort_keys (torch.sort)
  -> KB group_bounds -> KC invert_fused -> ties.resolve_ties (KE, KF)
  -> KG offset_slots (windows with ws > 0: window to genome positions)

The sort key is one int64 word up to k = 20 and two words (int64, int32)
for k = 21..30 (kernels/pack_keys.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .codes import upload_codes
from .host_helpers import _bucket, _strand_fingerprint
from .kernels import group_bounds, invert_fused, offset_slots, pack_keys
from .kernels.pack_keys import LO_SYMS, MAX_K, key_words
from .ties import resolve_ties

# Device bytes per fused row (W + probe lanes) at the build's peak, by key
# words: the stable sorts hold the key words, their sorted copies, the
# int64 row indices and the sort's scratch, next to codes and lane
# arrays. Measured with torch.cuda.max_memory_allocated in chip_smoke.py's
# cold runs on an NVIDIA H100 80GB HBM3 (700 W power limit), 128 Mbp -RC:
# one word 48.34 B/row at 141.7 M rows (k = 20), two words 56.33 B/row at
# 139.6 M rows (k = 25); rounded up for a margin.
PEAK_BYTES_PER_ROW = {1: 50, 2: 58}

# The merge-join window engine (window_index.py, k <= 20). Its build peaks
# at the stable sort of the W window keys; its stage 1 and scans hold the
# 12 B/row sorted keys and suffix order, plus per probe lane the packed
# key and mask (MJ_KEY_BYTES_PER_LANE, which a sharded run keeps cached
# beside every later window's build), the lane window and the largest
# chunk's scan buffers. Measured with torch.cuda.max_memory_allocated by
# chip_smoke.py's merge-join paths on an NVIDIA H100 80GB HBM3 (700 W
# power limit), -RC, k = 20: build 48.25 B per window row at 32 M rows
# (128 Mbp) and 49.99 B at 1 M rows (4 Mbp); stage 1 and scans 39.02 and
# 41.70 B per probe lane. The constants are the larger reading plus 10%.
# KD's outputs, inside the per-lane figure, grow with the matches, so a
# genome more repetitive than chip_smoke.py's synthetic one needs more.
MJ_MAX_K = 2 * LO_SYMS  # one-word keys: two 30-bit symbol planes
MJ_PEAK_BYTES_PER_ROW = 55
MJ_BYTES_PER_LANE = 46
MJ_KEY_BYTES_PER_LANE = 9  # int64 key + bool mask


def sort_keys(keys: list):
    """Stable sort of the fused rows by their key words (most significant
    first), ties kept in row order as ``jax.lax.sort(is_stable=True)``
    keeps its iota payload. Empties ``keys`` (each word is freed once it
    is dead) and returns (sorted words, sa int32: the rows in order).

    Two words sort LSD: a stable sort by the low word, then a stable sort
    of the high word gathered into that order, the permutations composed
    (two library radix sorts; no kernel of this repository)."""
    if len(keys) == 1:
        skey, order = torch.sort(keys.pop(), stable=True)
        return [skey], order.to(torch.int32)
    w1, w0 = keys
    keys.clear()
    sw0, order = torch.sort(w0, stable=True)
    del w0
    perm = order.to(torch.int32)
    del order
    g1 = w1[perm]
    del w1
    sw1, order = torch.sort(g1, stable=True)
    del g1
    sa = perm[order]
    del perm
    sw0 = sw0[order]
    return [sw1, sw0], sa


def fused_layout(W: int, specs) -> tuple[int, int, list[int]]:
    """(W, total, lane_off): W direct rows, then ``total`` probe-lane
    rows — the chunks' lanes back-to-back (chunk c from lane_off[c]) and
    the JAX build's slack (device_index.py:1662), so both builds sort the
    same rows; the pad rows sort last."""
    tail_pad = max((_bucket(nc) - nc for (_, _, nc) in specs),
                   default=1 << 16) + 8
    lane_off = [0]
    for (_, _, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
    return W, lane_off[-1] + tail_pad, lane_off


def free_bytes(device: torch.device) -> float:
    """Device bytes a build may use: on a GPU the free memory
    ``torch.cuda.mem_get_info`` reports, plus the blocks PyTorch's
    allocator holds unused, plus the cached index a miss would evict;
    unbounded on the CPU."""
    if device.type != "cuda":
        return float("inf")
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device)
            + INDEX_CACHE.reclaimable_bytes())


def probe_span(n1: int, doubled: bool) -> int:
    """Length of the text the probes address: the doubled text of R/C
    runs, else the strand."""
    return 2 * n1 - 1 if doubled else n1


def projected_rows(n1: int, W: int, k: int) -> int:
    """Fused rows the fit predicates project for W direct rows probed by
    an ``n1``-byte strand (``device_index.fused_fits`` /
    ``fused_window_applicable``): W, n1 // step probe lanes and 2^21 of
    bucket slack."""
    return W + n1 // max(1, k // 2) + (1 << 21)


def window_fits_bytes(n1: int, W: int, k: int, free: float,
                      resident: int = 0) -> bool:
    """Whether a fused build of W direct rows (probed by the whole
    ``n1``-byte strand) fits ``free`` bytes: int32 row addressing, and the
    projected peak, :func:`projected_rows` times ``PEAK_BYTES_PER_ROW`` of
    k's key words, plus ``resident`` bytes held beside it."""
    M = projected_rows(n1, W, k)
    return M < (1 << 31) and \
        M * PEAK_BYTES_PER_ROW[key_words(k)] + resident <= free


def mj_window_fits_bytes(n1: int, W: int, k: int, free: float,
                         resident: int = 0, keys_held: bool = False
                         ) -> bool:
    """Whether the merge-join engine's window of W rows, probed by the
    whole ``n1``-byte strand, fits ``free`` bytes: one-word keys (k <=
    20), W < 2^30, and the larger of its build peak
    (``MJ_PEAK_BYTES_PER_ROW`` per row, plus the packed probe keys when
    ``keys_held``, as in a sharded run's later windows) and its stage 1
    and scans (12 B per row resident plus ``MJ_BYTES_PER_LANE`` per probe
    lane, the keys included), plus ``resident`` bytes held beside it."""
    lanes = n1 // max(1, k // 2)
    build = MJ_PEAK_BYTES_PER_ROW * W
    if keys_held:
        build += MJ_KEY_BYTES_PER_LANE * lanes
    peak = max(build, 12 * W + MJ_BYTES_PER_LANE * lanes)
    return k <= MJ_MAX_K and W < (1 << 30) and peak + resident <= free


def mj_fits(n1: int, W: int, k: int, doubled: bool, device: torch.device,
            resident: int = 0, keys_held: bool = False) -> bool:
    """:func:`fits` for the merge-join window engine: the probed text
    within int32 addressing, and :func:`mj_window_fits_bytes` against
    :func:`free_bytes`."""
    return probe_span(n1, doubled) < (1 << 31) and mj_window_fits_bytes(
        n1, W, k, free_bytes(device), resident, keys_held)


def fits(n1: int, W: int, k: int, doubled: bool, device: torch.device,
         resident: int = 0) -> bool:
    """Whether a fused build of W direct rows fits ``device``: the probed
    text within int32 addressing, and :func:`window_fits_bytes` against
    :func:`free_bytes`. The whole genome (W = n1) frees its codes before
    the sort's peak (``resident`` 0); trim windows keep the genome's n1
    code bytes resident across a sharded run's windows."""
    return probe_span(n1, doubled) < (1 << 31) and window_fits_bytes(
        n1, W, k, free_bytes(device), resident)


@dataclass
class FusedIndex:
    """Device-resident fused index: the final suffix order over the
    direct text with the probe rows interleaved, and the per-lane
    windows of a fixed chunk set."""

    sa: torch.Tensor         # int32 [W + total]; direct slots hold genome
    #                          positions, probe slots W + lane (+ ws; never
    #                          read)
    lane_lo: torch.Tensor    # int32 [total] window starts, lane order
    lane_hi: torch.Tensor    # int32 [total] window ends
    lane_mask: torch.Tensor  # bool [total] live-probe mask
    specs: tuple             # ((chunk_start, chunk_len, n_lanes), ...)
    offs: dict               # (chunk_start, chunk_len) -> (lane_offset,
    #                          raw match total)
    k: int
    n: int                   # doubled text length (probe addressing)
    first_len: int           # genome + '$' length
    reverse: bool
    complement: bool
    trim: tuple | None = None  # (ws, we) of a trim window's build

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.sa, self.lane_lo, self.lane_hi,
                             self.lane_mask))

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, specs: tuple,
              reverse: bool, complement: bool, device: torch.device,
              trim: tuple | None = None,
              codes: torch.Tensor | None = None) -> "FusedIndex":
        """The index of the whole genome, or of the trim window ``trim``
        = (ws, we) (its text strand[ws:we] plus its own '$'; the probes
        still read the whole genome). ``codes``: the strand's codes
        already on ``device`` (a sharded run uploads them once)."""
        if not 2 <= k <= MAX_K:
            raise ValueError(f"fused index supports probe_size 2..{MAX_K}")
        n1 = int(len(strand_data))
        n = 2 * n1 - 1 if (reverse or complement) else n1
        if trim is not None:
            ws, we = int(trim[0]), int(trim[1])
            if not 0 <= ws < we <= n1 - 1:
                raise ValueError(f"bad trim window {trim}")
            W = we - ws + 1  # window text + its own '$'
        else:
            ws, W = 0, n1
        W, total, lane_off = fused_layout(W, specs)
        M = W + total
        if n >= (1 << 31) or ws + M >= (1 << 31):
            raise ValueError("genome too large for int32 addressing")

        if codes is None:
            codes = upload_codes(strand_data, device)
        keys, lane_mask = pack_keys(codes, specs, k, reverse, complement,
                                    W, total, ws)
        del codes
        skeys, sa = sort_keys(keys)
        run_lo, run_hi, tied = group_bounds(skeys, sa, W)
        del skeys
        rank, lane_lo, lane_hi, totals = invert_fused(
            sa, run_lo, run_hi, lane_mask, W, lane_off)
        del run_lo, run_hi
        sa = resolve_ties(sa, rank, tied, M, k)
        if ws:
            offset_slots(sa, ws)
        offs = {(cs, cl): (off, int(t)) for (cs, cl, _), off, t in
                zip(specs, lane_off, totals.tolist())}
        return cls(sa=sa, lane_lo=lane_lo, lane_hi=lane_hi,
                   lane_mask=lane_mask, specs=tuple(specs), offs=offs, k=k,
                   n=n, first_len=n1, reverse=reverse,
                   complement=complement,
                   trim=(ws, we) if trim is not None else None)


def device_index_cache_enabled() -> bool:
    """``ASGART_DEVICE_INDEX_CACHE=0`` disables the cache, as in the JAX
    package (device_index.py:947)."""
    return os.environ.get("ASGART_DEVICE_INDEX_CACHE", "1") != "0"


class IndexCache:
    """One-entry cache of the last built index, fused or merge-join: keyed
    by the index type, the strand's content fingerprint and every build
    argument, so a rescan of the same genome and chunks skips the build. A
    miss evicts the entry before building, so its memory is free for the
    build's peak."""

    def __init__(self):
        self._key = None
        self._index = None

    def reclaimable_bytes(self) -> int:
        return self._index.nbytes() if self._index is not None else 0

    def clear(self) -> None:
        self._key = self._index = None

    def get_or_build(self, kind: str, strand_data, args: tuple, build):
        """The cached index of type ``kind`` built from ``strand_data``
        and ``args``, or ``build()`` (``ASGART_DEVICE_INDEX_CACHE=0``:
        always built, nothing kept)."""
        if not device_index_cache_enabled():
            self.clear()
            return build()
        key = (kind, _strand_fingerprint(strand_data), *args)
        if key != self._key:
            self.clear()
            self._index = build()
            self._key = key
        return self._index


# the process-wide default cache (a long-lived service rescanning a
# genome hits it across `search_duplications` calls)
INDEX_CACHE = IndexCache()
