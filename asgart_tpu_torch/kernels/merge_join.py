"""KH ``mj_ranges``: each probe lane's equal range in the sorted window
keys, searched from the window's key directory (``mj_directory``).

Kernels: ``csrc/merge_join.cu`` (see its header for what they replace in
the JAX package and how they are bounded). ``mj_ranges_plain`` is the
same function in plain PyTorch, by the JAX package's method: a co-sort, a
cumsum and a cummax, then a scatter back into lane order;
``mj_directory_plain`` builds the directory by ``torch.searchsorted``
over the bucket boundaries.

The directory kernel flags keys out of order (or outside k symbols) on
the card, and its wrapper does not wait to read the flag: the directory
carries it (``MjDirectory.flag``), and whoever uses the directory reads it
with a host read it makes anyway: an engine with KH's chunk totals
(:func:`totals_with_flag`, :func:`read_totals`), a check alone with
:meth:`MjDirectory.check`. The plain version raises at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build


# csrc/merge_join.cu kDigits: the 2-bit digit of each 3-bit symbol rank
# ('$' 0 shares A's, N 4 shares G's, the unused 6 and 7 T's);
# non-decreasing. FILL: the digit of every later symbol after a rank that
# shares its digit with a higher one (0 after '$') or a lower one (3 after
# N, 6, 7), -1 for none; so the digit string never decreases along sorted
# keys
DIGITS = (0, 0, 1, 2, 2, 3, 3, 3)
FILL = (0, -1, -1, -1, 3, -1, 3, 3)
MAX_K = 20  # one-word keys: k symbols of 3 bits below bit 61


class MjDirectory(NamedTuple):
    """The key directory of ``W`` sorted keys of ``k`` symbols: ``table``
    (int32 [2^bits + 1]) holds, for each bucket b, the first row whose
    bucket is at least b (the bucket: the top ``bits`` bits of the 2-bit
    digits of a key's first symbols, :func:`bucket_of`), and W last.
    ``bits`` >= 1; a window too small for one is given none (None).
    ``flag``: the kernel's int32 [1], nonzero when a key lies outside k
    symbols or below its predecessor (then ``table`` means nothing), not
    yet read; None where the keys were checked on the host."""

    table: torch.Tensor
    k: int
    bits: int
    W: int
    flag: torch.Tensor | None = None

    def nbytes(self) -> int:
        return self.table.numel() * 4

    def check(self) -> "MjDirectory":
        """Reads the flag (one host read) and raises ``ValueError`` if it is
        set; returns the directory."""
        if self.flag is not None and self.flag.item():
            raise ValueError(_UNSORTED)
        return self


def mj_directory_bits(W: int, k: int) -> int:
    """The directory's ``bits`` for ``W`` keys of ``k`` symbols: the most
    with 2^bits + 1 <= W // 16 entries (0.25 B a key at most) and bits <=
    2k; 0 (no directory) when W // 16 < 3."""
    cap = W // 16
    if cap < 3:
        return 0
    return min(2 * k, (cap - 1).bit_length() - 1)


def bucket_of(v: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """The buckets (int64) of flag-free keys ``v`` of ``k`` symbols in
    [0, 2^(3k)): the top ``bits`` bits of the digits (``DIGITS``,
    ``FILL``) of their first ceil(bits / 2) symbols."""
    m = (bits + 1) // 2
    digits, fills = (torch.tensor(t, dtype=torch.int64, device=v.device)
                     for t in (DIGITS, FILL))
    d = torch.zeros_like(v)
    fill = torch.full_like(v, -1)
    for t in range(m):
        r = (v >> (3 * (k - 1 - t))) & 7
        held = fill >= 0
        d = (d << 2) | torch.where(held, fill, digits[r])
        fill = torch.where(held, fill, fills[r])
    return d >> (2 * m - bits)


def _check_keys(name: str, skey, k: int, bits: int | None) -> int:
    if skey.dtype != torch.int64 or skey.dim() != 1 \
            or not skey.is_contiguous():
        raise ValueError(f"{name}: skey must be a contiguous 1-D int64 "
                         "tensor")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: bad k={k}")
    most = mj_directory_bits(skey.numel(), k)
    if bits is None:
        return most
    if not 1 <= bits <= most:
        raise ValueError(f"{name}: bits={bits} outside [1, {most}] for "
                         f"{skey.numel()} keys of k={k}")
    return bits


_UNSORTED = ("mj_directory: a key lies outside k symbols or below its "
             "predecessor")


def mj_directory(skey: torch.Tensor, k: int,
                 bits: int | None = None) -> MjDirectory | None:
    """The directory of the sorted window keys ``skey`` (int64 [W], k
    symbols, flag bit 0), at ``bits`` (default :func:`mj_directory_bits`;
    1 to that); None when that is 0 (under 48 keys). A flag-free key
    outside [0, 2^(3k)) or below its predecessor sets the directory's
    ``flag`` on the card, which this makes no host read of (the plain
    version raises ``ValueError`` at once): read it with the totals of a
    join from it (:func:`read_totals`) or with :meth:`MjDirectory.check`
    before the directory's result is used."""
    bits = _check_keys("mj_directory", skey, k, bits)
    W = skey.numel()
    if bits == 0:
        return None
    if not _build.on_cuda(skey):
        return mj_directory_plain(skey, k, bits)
    table = torch.empty((1 << bits) + 1, dtype=torch.int32,
                        device=skey.device)
    flag = torch.empty(1, dtype=torch.int32, device=skey.device)
    lib = _build.lib()
    mj_directory.launches += 1
    _build.check(lib.asgart_mj_directory(
        skey.data_ptr(), W, k, bits, table.data_ptr(), flag.data_ptr(),
        _build.stream_of(skey)), "mj_directory")
    return MjDirectory(table, k, bits, W, flag)


mj_directory.launches = 0


def index_directory(skey: torch.Tensor, k: int) -> MjDirectory | None:
    """The directory a window index keeps for KH: :func:`mj_directory`
    of its keys on the card; None on the CPU, where KH's plain version
    co-sorts and reads no directory."""
    return mj_directory(skey, k) if _build.on_cuda(skey) else None


def totals_with_flag(totals: torch.Tensor,
                     directory: MjDirectory | None) -> torch.Tensor:
    """KH's chunk totals (int64 [n_chunks]) with the flag of the directory
    it searched appended (0 without a flag): int64 [n_chunks + 1], which
    an engine reads back in one host read (:func:`read_totals`), summed
    over the ranks where each searched its own shard's directory."""
    flag = directory.flag if directory is not None else None
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=totals.device)
    return torch.cat([totals, flag.to(torch.int64)])


def read_totals(totals_flag: torch.Tensor) -> list[int]:
    """The chunk totals of :func:`totals_with_flag`'s tensor, read in one
    host read; raises ``ValueError`` when the directory's flag is set (its
    keys were out of order), before any result of the join is used."""
    *totals, flag = totals_flag.tolist()
    if flag:
        raise ValueError(_UNSORTED)
    return totals


def mj_directory_plain(skey, k: int, bits: int) -> MjDirectory:
    """Plain PyTorch version of the directory kernel: each key's bucket,
    then ``torch.searchsorted`` of every bucket boundary 0 .. 2^bits."""
    v = skey >> 1
    if v.numel() and (bool((v < 0).any()) or bool((v >> (3 * k)).any())
                      or bool((v[1:] < v[:-1]).any())):
        raise ValueError(_UNSORTED)
    b = bucket_of(v, k, bits)
    edges = torch.arange((1 << bits) + 1, dtype=torch.int64,
                         device=skey.device)
    table = torch.searchsorted(b, edges, side="left").to(torch.int32)
    return MjDirectory(table, k, bits, skey.numel())


def _check_join(skey, pkey, lane_mask, lane_off, directory):
    W = skey.numel()
    total = pkey.numel()
    for t, dt in ((skey, torch.int64), (pkey, torch.int64),
                  (lane_mask, torch.bool)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("mj_ranges: bad dtype or layout")
    if lane_mask.numel() != total or not lane_off or lane_off[0] != 0 \
            or lane_off[-1] > total:
        raise ValueError("mj_ranges: lane arrays do not match the keys")
    if W >= 2**31:
        raise ValueError("mj_ranges: the window is beyond int32 slots")
    if directory is not None and (
            directory.W != W
            or directory.table.numel() != (1 << directory.bits) + 1):
        raise ValueError("mj_ranges: the directory is not this window's")


def mj_ranges(skey: torch.Tensor, pkey: torch.Tensor,
              lane_mask: torch.Tensor, lane_off: list[int],
              directory: MjDirectory | None = None):
    """Equal ranges of the probe keys ``pkey`` (int64 [total], KA's
    probe-only mode: flag bit 1) in the sorted window keys ``skey`` (int64
    [W], flag bit 0), keys compared without their flag bit; ``lane_off`` =
    each chunk's first lane plus the end (n_chunks + 1 ascending ints);
    ``directory``: :func:`mj_directory` of ``skey``, which the kernel
    searches from (None: the whole window, one bucket; the result is the
    same; the plain version reads none).

    Returns (lane_lo int32 [total], lane_hi int32 [total], totals int64
    [n_chunks]): lanes outside ``lane_mask`` get (0, 0); totals are the
    exact sums of (lane_hi - lane_lo) over each chunk's lanes."""
    _check_join(skey, pkey, lane_mask, lane_off, directory)
    tensors = (skey, pkey, lane_mask) + (
        (directory.table,) if directory is not None else ())
    if not _build.on_cuda(*tensors):
        return mj_ranges_plain(skey, pkey, lane_mask, lane_off)
    return launch_mj_ranges(skey, pkey, lane_mask, lane_off, directory)


mj_ranges.launches = 0


def launch_mj_ranges(skey, pkey, lane_mask, lane_off, directory=None,
                     counts=None):
    """KH's launch, on arguments :func:`mj_ranges` has checked: (lane_lo,
    lane_hi, totals), nothing read back. ``counts``, an int64 [2] tensor
    on the card, runs the counting instance, which adds its key reads and
    its directory reads to it."""
    dev = skey.device
    W, total = skey.numel(), pkey.numel()
    n_chunks = len(lane_off) - 1
    lane_lo = torch.empty(total, dtype=torch.int32, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return lane_lo, lane_hi, torch.zeros(n_chunks, dtype=torch.int64,
                                             device=dev)
    totals = torch.empty(max(n_chunks, 1), dtype=torch.int64, device=dev)
    off = torch.tensor(lane_off, dtype=torch.int64)
    if dev.type == "cuda":  # through pinned memory: the host does not wait
        off = off.pin_memory().to(dev, non_blocking=True)  # for the card
    has_dir = directory is not None
    lib = _build.lib()
    mj_ranges.launches += 1
    _build.check(lib.asgart_mj_ranges(
        skey.data_ptr(), W, pkey.data_ptr(), lane_mask.data_ptr(), total,
        off.data_ptr(), n_chunks,
        directory.table.data_ptr() if has_dir else None,
        directory.bits if has_dir else 0, directory.k if has_dir else 0,
        lane_lo.data_ptr(),
        lane_hi.data_ptr(), totals.data_ptr(),
        None if counts is None else counts.data_ptr(),
        _build.stream_of(skey)), "mj_ranges")
    return lane_lo, lane_hi, totals[:n_chunks]


def mj_ranges_reads(skey, pkey, lane_mask, lane_off,
                    directory: MjDirectory | None = None) -> tuple[int, int]:
    """(the window keys KH reads on these inputs, the directory words it
    reads), counted by the kernel itself in one launch of its counting
    instance; CUDA tensors that :func:`mj_ranges` accepts."""
    _check_join(skey, pkey, lane_mask, lane_off, directory)
    if not _build.on_cuda(skey, pkey, lane_mask):
        raise ValueError("mj_ranges_reads: KH counts its reads on the card "
                         "only")
    counts = torch.zeros(2, dtype=torch.int64, device=skey.device)
    launch_mj_ranges(skey, pkey, lane_mask, lane_off, directory, counts)
    reads, dir_reads = counts.tolist()
    return int(reads), int(dir_reads)


def mj_ranges_plain(skey, pkey, lane_mask, lane_off):
    """Plain PyTorch version of the KH kernel, as ``_mj_tail`` computes
    it: a stable co-sort of the window and probe keys (an equal key's
    window entries, flag 0, sort before its probes, flag 1), then per
    probe hi = the window entries at or before it (a cumsum) and lo = the
    window entries before its run's start (a cummax), scattered back into
    lane order."""
    dev = skey.device
    W, total = skey.numel(), pkey.numel()
    skeys, order = torch.sort(torch.cat([skey, pkey]), stable=True)
    probe = order >= W
    t = torch.arange(W + total, device=dev)
    cw = t + 1 - torch.cumsum(probe.to(torch.int64), 0)
    flagless = skeys >> 1
    starts = torch.ones(W + total, dtype=torch.bool, device=dev)
    starts[1:] = flagless[1:] != flagless[:-1]
    before = torch.where(starts, cw - (~probe).to(torch.int64), -1)
    wbs = torch.cummax(before, 0).values
    lanes = order[probe] - W
    lane_lo = torch.empty(total, dtype=torch.int64, device=dev)
    lane_hi = torch.empty(total, dtype=torch.int64, device=dev)
    lane_lo[lanes] = wbs[probe]
    lane_hi[lanes] = cw[probe]
    lane_lo = torch.where(lane_mask, lane_lo, 0)
    lane_hi = torch.where(lane_mask, lane_hi, 0)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(lane_hi - lane_lo, 0)])
    off = torch.tensor(lane_off, dtype=torch.int64)
    if dev.type == "cuda":  # through pinned memory: the host does not wait
        off = off.pin_memory().to(dev, non_blocking=True)  # for the card
    return (lane_lo.to(torch.int32), lane_hi.to(torch.int32),
            csum[off[1:]] - csum[off[:-1]])
