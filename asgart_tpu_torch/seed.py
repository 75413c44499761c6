"""Seed lookups on the device for ``SearchEngine(engine="cuda")``.

Counterpart of ``asgart_tpu/seed.py``: ``DeviceSeedIndex``, a trim
window's ``GenomeIndex`` on the device, where a packed probe's equal range
is its prefix bucket narrowed by a binary search (KQ ``equal_range``), and
``DevicePositionTables``, the doubled-text ``PositionIndex``'s per-position
range table on the device, where a probe's range is one row read at its
text position (KR ``gather_ranges``); and KS ``pack_probe_planes``, the
JAX module's pack of probe k-mers on the device, which no pipeline calls
(the search engine packs its probes on the host).

Two things of the TPU design do not carry over. The keys stay one int64
word per row: the JAX program splits them into two int32 planes because
device x64 was off, at the same 8 B per row and with the same bounds. And
no call is padded to ``batch`` probes, which only spared XLA recompiles:
``batch`` caps the probes of one launch. Positions stay below 2^31, as in
the JAX package (the same ``ValueError``s).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import cuda_device
from .index import GenomeIndex
from .kernels.seed import LO_BITS, equal_range, gather_ranges
from .kernels.seed import pack_probe_planes  # noqa: F401  (the JAX name)

LO_MASK = (1 << LO_BITS) - 1
DEFAULT_BATCH = 1 << 20


def split_planes(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 packed k-mers → (hi, lo) int32 planes."""
    hi = (kmers >> LO_BITS).astype(np.int32)
    lo = (kmers & LO_MASK).astype(np.int32)
    return hi, lo


def _gather_tables(pos_lo: torch.Tensor, pos_hi: torch.Tensor,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``pos_lo[x]``, ``pos_hi[x]`` as int64 (seed.py:120-122): KR over two
    [n] int32 tables."""
    return gather_ranges(pos_lo, pos_hi, x)


def _gather_range_rows(ranges: torch.Tensor, x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of the [n, 2] int32 table ``ranges`` at ``x``, as (lo, hi)
    int64 (seed.py:125-127): KR over the table's two columns."""
    return gather_ranges(ranges[:, 0], ranges[:, 1], x)


def _batches(values: np.ndarray, batch: int, device: torch.device):
    """(start, int64 tensor on ``device``) for each ``batch`` values."""
    for b0 in range(0, len(values), batch):
        part = np.ascontiguousarray(values[b0: b0 + batch], dtype=np.int64)
        yield b0, torch.from_numpy(part).to(device)


class DevicePositionTables:
    """Device-resident per-position equal-range tables (doubled-text
    index): a probe lookup is one row read, no search."""

    def __init__(self, pidx, device: Optional[torch.device] = None,
                 batch: int = DEFAULT_BATCH):
        n = len(pidx.ranges)
        if n >= (1 << 31):
            raise ValueError(
                "device table shard too large for int32; shard the index")
        self.batch = batch
        self.device = device if device is not None else cuda_device()
        # interleaved [n, 2] table: one row read returns [lo, hi)
        self.ranges = torch.from_numpy(np.ascontiguousarray(
            pidx.ranges, dtype=np.int32)).to(self.device)

    def gather_ranges(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The table's (lo, hi) at the text positions ``x``, as int64."""
        lo_out = np.empty(len(x), dtype=np.int64)
        hi_out = np.empty(len(x), dtype=np.int64)
        for b0, part in _batches(x, self.batch, self.device):
            lo, hi = _gather_range_rows(self.ranges, part)
            lo_out[b0: b0 + len(part)] = lo.cpu().numpy()
            hi_out[b0: b0 + len(part)] = hi.cpu().numpy()
        return lo_out, hi_out


class DeviceSeedIndex:
    """Device-resident seed index built from a host ``GenomeIndex``."""

    def __init__(self, index: GenomeIndex,
                 device: Optional[torch.device] = None,
                 prefix_bits: Optional[int] = None,
                 batch: int = DEFAULT_BATCH):
        k = index.k
        if 3 * k > 60:
            raise ValueError("device seed index requires probe_size <= 20")
        if len(index.sa) >= (1 << 31):
            raise ValueError(
                "device index shard too large for int32 positions; "
                "shard the index across devices")
        self.k = k
        self.batch = batch

        if prefix_bits is None:
            prefix_bits = min(24, max(3 * k - LO_BITS, 0))
        if prefix_bits > 0 and 3 * k - prefix_bits < LO_BITS:
            prefix_bits = max(3 * k - LO_BITS, 0)
        self.prefix_bits = prefix_bits
        # shift applied to the HI plane to get the bucket id
        self.prefix_shift = (3 * k - prefix_bits) - LO_BITS \
            if prefix_bits > 0 else -1

        if prefix_bits > 0:
            prefixes = (index.sa_kmers >> (3 * k - prefix_bits))
            starts = np.searchsorted(
                prefixes, np.arange(1 << prefix_bits), side="left")
            bucket_starts = np.concatenate(
                [starts, [len(index.sa_kmers)]]).astype(np.int32)
            max_bucket = int(np.max(np.diff(bucket_starts))) \
                if len(bucket_starts) > 1 else len(index.sa_kmers)
        else:
            bucket_starts = np.array([0, len(index.sa_kmers)], dtype=np.int32)
            max_bucket = len(index.sa_kmers)
        self.steps = max(1, int(np.ceil(np.log2(max(max_bucket, 1) + 1))))

        self.device = device if device is not None else cuda_device()
        self.keys = torch.from_numpy(np.ascontiguousarray(
            index.sa_kmers, dtype=np.int64)).to(self.device)
        self.bucket_starts = torch.from_numpy(bucket_starts).to(self.device)

    def lookup(self, probe_kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host-convenient API: packed int64 probes → (lo, hi) int64."""
        lo_out = np.empty(len(probe_kmers), dtype=np.int64)
        hi_out = np.empty(len(probe_kmers), dtype=np.int64)
        for b0, part in _batches(probe_kmers, self.batch, self.device):
            left, right = equal_range(self.keys, self.bucket_starts, part,
                                      self.steps, self.prefix_shift)
            lo_out[b0: b0 + len(part)] = left.cpu().numpy()
            hi_out[b0: b0 + len(part)] = right.cpu().numpy()
        return lo_out, hi_out
