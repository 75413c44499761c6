"""The strand's symbol codes on the device.

Counterpart of ``DeviceIndex.upload_codes`` (asgart_tpu/device_index.py:1124)
with ``pack_codes_host`` (:67) and K1 ``_unpack_codes`` (:98): the host packs
the strand 2 bits per base (plus a sparse list of its other bytes), the
packed bytes cross the bus, and KI ``unpack_codes`` (kernels/codes.py)
expands them on the device. A strand whose exceptions are dense (5 bytes
each above an eighth of the strand, the JAX package's threshold: more than
2.5% of its bytes outside ACGT) takes the plain 1 B/bp ``CODE`` upload, as
in the JAX package; the exceptions are counted before anything is packed,
so such a strand pays a partial counting pass and no packing. Unlike
``pack_codes_host``, exception positions are int64, so strands of 2^31
bytes and more pack too.

Measured reason, and where it holds (chip_smoke.py on the host of an
NVIDIA H100 80GB HBM3, 700 W; PERF.md): on chip_smoke's synthetic genomes,
nearly free of N, the host ``CODE`` LUT and its pinned 1 B/bp copy were
the largest cost of a cold 128 Mbp run, and the pack with its copy of a
quarter the size takes about half as long. Assembled genomes are not
sparse: GRCh38 holds ~151 Mbp of N gaps in 3.1 Gbp (4.9%), and
``--skip-masked`` makes more, so on them KI is not launched and the
saving does not apply; the upload is the LUT after a partial count.
"""

from __future__ import annotations

import numpy as np
import torch

from .index import CODE
from .kernels import unpack_codes

_BLOCK = 1 << 18  # strand bytes per step of the host passes (cache-sized)


def exception_positions(strand_data: np.ndarray):
    """int64 positions (ascending) of the strand's bytes outside ACGT, or
    None as soon as they are too dense to pack (5 · n_exc > max(n1 // 8,
    64), the JAX package's threshold): the first pass of
    :func:`pack_codes`, read in cache-sized blocks."""
    n1 = int(len(strand_data))
    limit = max(n1 // 8, 64)
    exc = np.empty(_BLOCK, dtype=bool)
    other = np.empty(_BLOCK, dtype=bool)
    parts, n_exc = [], 0
    for b in range(0, n1, _BLOCK):
        x = strand_data[b:b + _BLOCK]
        e, o = exc[:x.size], other[:x.size]
        np.not_equal(x, ord("A"), out=e)
        for base in b"CGT":
            np.not_equal(x, base, out=o)
            e &= o
        local = np.flatnonzero(e)
        if local.size:
            n_exc += local.size
            if n_exc * 5 > limit:
                return None
            parts.append(local + b)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def pack_planes(strand_data: np.ndarray, exc_pos: np.ndarray) -> np.ndarray:
    """uint8 [ceil(n1 / 4)]: byte j holds positions j, n4 + j, 2·n4 + j and
    3·n4 + j in its bit pairs from the lowest (A, C, G, T = 0..3; 0 at the
    exceptions ``exc_pos``). The second pass of :func:`pack_codes`, with
    arithmetic in place of the JAX package's LUTs: (byte >> 1) & 3 is 0,
    1, 3, 2 for A, C, G, T, and v ^ (v >> 1) puts G and T in order."""
    n1 = int(len(strand_data))
    n4 = -(-n1 // 4)
    packed = np.zeros(n4, dtype=np.uint8)
    two = np.empty(_BLOCK, dtype=np.uint8)
    for q in range(4):
        for b in range(q * n4, min(n1, (q + 1) * n4), _BLOCK):
            x = strand_data[b:min(b + _BLOCK, (q + 1) * n4, n1)]
            v = two[:x.size]
            np.right_shift(x, 1, out=v)
            v &= 3
            v ^= v >> 1
            v <<= 2 * q
            packed[b - q * n4:b - q * n4 + x.size] |= v
    for q in range(4):  # each quarter's exceptions hit distinct bytes
        lo, hi = np.searchsorted(exc_pos, [q * n4, (q + 1) * n4])
        packed[exc_pos[lo:hi] - q * n4] &= np.uint8(~(3 << 2 * q) & 0xFF)
    return packed


def pack_codes(strand_data: np.ndarray):
    """(packed uint8 [ceil(n1 / 4)], exc_pos int64, exc_code uint8) of the
    strand, equal to ``pack_codes_host``'s: the 2-bit planes of
    :func:`pack_planes`, and every byte outside ACGT as an exception (its
    ascending position, its ``CODE``). None when exceptions are so dense
    that the packed form would not beat the plain upload; that is decided
    by :func:`exception_positions` before any packing."""
    exc_pos = exception_positions(strand_data)
    if exc_pos is None:
        return None
    return (pack_planes(strand_data, exc_pos), exc_pos,
            CODE[strand_data[exc_pos]])


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``; through pinned memory on a GPU, so the copy
    is one DMA."""
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_codes(strand_data: np.ndarray, device: torch.device
                 ) -> torch.Tensor:
    """uint8 symbol ranks ``CODE[strand]`` ($=0, A=1, C=2, G=3, N=4, T=5)
    on ``device``: packed on the host and unpacked by KI, or copied 1 B/bp
    when the strand's exceptions are dense."""
    packed = pack_codes(strand_data)
    if packed is None:
        return _to_device(CODE[strand_data], device)
    return unpack_codes(*(_to_device(a, device) for a in packed),
                        int(len(strand_data)))
