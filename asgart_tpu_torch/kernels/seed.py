"""KQ ``equal_range``, KR ``gather_ranges`` and KS ``pack_probe_planes``:
the seed lookups of ``SearchEngine(engine="cuda")`` (``seed.py``).

Kernels: ``csrc/seed.cu`` (see its header for what each replaces in the
JAX package and how it is bounded). ``equal_range_plain``,
``gather_ranges_plain`` and ``pack_probe_planes_plain`` are the same
functions in plain PyTorch. Every row a kernel reads must lie inside its
array: a CUDA read past an array's end reads other memory, where the JAX
programs' gathers clamp. KS checks its positions before the launch (one
``aminmax``, read on the host); KQ checks each probe's bucket and KR each
index in the kernel, which raises a flag that the wrapper reads after it.
On CPU tensors the wrappers check the same conditions on the host.
"""

from __future__ import annotations

import torch

from . import _build

LO_BITS = 30  # the JAX low key plane's width (asgart_tpu/seed.py:36)


def _extremes(*tensors) -> list:
    """[min, max, ...] of each non-empty tensor, with one host read."""
    return torch.stack([v for t in tensors
                        for v in torch.aminmax(t)]).tolist()


def _contiguous(name: str, **tensors) -> None:
    for arg, (t, dt) in tensors.items():
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous 1-D "
                             f"{dt} tensor")


def equal_range(keys: torch.Tensor, bucket_starts: torch.Tensor,
                probes: torch.Tensor, steps: int, prefix_shift: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64 [B]: for each packed probe of ``probes`` (int64 [B])
    the rows [lo, hi) of ``keys`` (int64 [N], sorted) equal to it, searched
    in the probe's prefix bucket, rows ``bucket_starts[p]`` to
    ``bucket_starts[p + 1]`` (int32) of ``p = probe >> (prefix_shift +
    LO_BITS)``, or in all N rows when ``prefix_shift`` < 0, by at most
    ``steps`` halvings on each side: the JAX ``equal_range`` on one-word
    keys, whose ``prefix_shift`` applies to the high plane. Raises
    ``ValueError`` for a probe whose bucket lies outside the table (a
    negative probe included) or whose bounds do not satisfy 0 <= lo0 <=
    hi0 <= N."""
    _contiguous("equal_range", keys=(keys, torch.int64),
                bucket_starts=(bucket_starts, torch.int32),
                probes=(probes, torch.int64))
    if steps < 0:
        raise ValueError(f"equal_range: bad steps {steps}")
    cuda = _build.on_cuda(keys, bucket_starts, probes)
    if probes.numel() == 0:
        return (torch.empty(0, dtype=torch.int64, device=probes.device),
                torch.empty(0, dtype=torch.int64, device=probes.device))
    key_shift = prefix_shift + LO_BITS if prefix_shift >= 0 else -1
    if key_shift >= 0 and bucket_starts.numel() < 2:
        raise ValueError("equal_range: no bucket table")
    outside = ("equal_range: a probe's bucket or a bucket bound lies "
               "outside its array")
    if not cuda:
        if not _buckets_inside(keys.numel(), bucket_starts, probes,
                               key_shift):
            raise ValueError(outside)
        return equal_range_plain(keys, bucket_starts, probes, steps,
                                 prefix_shift)
    lo, hi, bad = launch_equal_range(keys, bucket_starts, probes, steps,
                                     prefix_shift)
    if bad.item():  # one 4-byte read: the host waits for the kernel
        raise ValueError(outside)
    return lo, hi


def _buckets_inside(N: int, bucket_starts, probes, key_shift: int) -> bool:
    """The condition KQ checks per probe, on the host: each probe's bucket
    lies in the table and its bounds satisfy 0 <= lo0 <= hi0 <= N (always
    true without buckets)."""
    if key_shift < 0:
        return True
    prefix = probes >> key_shift
    if not bool(((probes >= 0)
                 & (prefix <= bucket_starts.numel() - 2)).all()):
        return False
    lo0, hi0 = bucket_starts[prefix], bucket_starts[prefix + 1]
    return bool(((lo0 >= 0) & (lo0 <= hi0) & (hi0 <= N)).all())


def launch_equal_range(keys, bucket_starts, probes, steps: int,
                       prefix_shift: int, counts=None):
    """KQ's launch alone, on arguments :func:`equal_range` has checked:
    (lo, hi, bad), ``bad`` an int32 [1] flag on the card, nonzero when a
    probe's bucket or its bounds lie outside their arrays (and lo, hi then
    garbage). Nothing is read back, so the host does not wait for the
    card. ``counts``, an int64 [2] tensor on the card, runs the counting
    instance, which adds its key reads and the probes that took the JAX
    loop to it."""
    lib = _build.lib()
    B = probes.numel()
    lo = torch.empty(B, dtype=torch.int64, device=probes.device)
    hi = torch.empty(B, dtype=torch.int64, device=probes.device)
    bad = torch.empty(1, dtype=torch.int32, device=probes.device)
    key_shift = prefix_shift + LO_BITS if prefix_shift >= 0 else -1
    equal_range.launches += 1
    _build.check(lib.asgart_equal_range(
        keys.data_ptr(), keys.numel(), bucket_starts.data_ptr(),
        bucket_starts.numel(), key_shift, probes.data_ptr(), B,
        min(steps, 63), lo.data_ptr(), hi.data_ptr(), bad.data_ptr(),
        None if counts is None else counts.data_ptr(),
        _build.stream_of(probes)), "equal_range")
    return lo, hi, bad


equal_range.launches = 0


def equal_range_reads(keys, bucket_starts, probes, steps: int,
                      prefix_shift: int) -> tuple[int, int]:
    """(the keys KQ reads on these inputs, the probes that take the JAX
    loop), counted by the kernel itself in one launch of its counting
    instance; CUDA tensors that :func:`equal_range` accepts."""
    if not _build.on_cuda(keys, bucket_starts, probes):
        raise ValueError("equal_range_reads: KQ counts its reads on the "
                         "card only")
    counts = torch.zeros(2, dtype=torch.int64, device=probes.device)
    _, _, bad = launch_equal_range(keys, bucket_starts, probes, steps,
                                   prefix_shift, counts)
    if bad.item():
        raise ValueError("equal_range_reads: a probe's bucket or a bucket "
                         "bound lies outside its array")
    reads, jax_loop = counts.tolist()
    return int(reads), int(jax_loop)


def equal_range_plain(keys, bucket_starts, probes, steps: int,
                      prefix_shift: int):
    """Plain PyTorch version of the KQ kernel (the JAX loop: a lane stops
    moving once its interval is empty)."""
    if prefix_shift >= 0:
        prefix = probes >> (prefix_shift + LO_BITS)
        lo0 = bucket_starts[prefix].long()
        hi0 = bucket_starts[prefix + 1].long()
    else:
        lo0 = torch.zeros_like(probes)
        hi0 = torch.full_like(probes, keys.numel())

    def search(right: bool):
        lo, hi = lo0, hi0
        for _ in range(steps):
            live = lo < hi
            if not bool(live.any()):
                break
            mid = (lo + hi) >> 1
            key = keys[torch.where(live, mid, 0)]
            go_right = key <= probes if right else key < probes
            lo = torch.where(live & go_right, mid + 1, lo)
            hi = torch.where(live & ~go_right, mid, hi)
        return lo

    return search(False), search(True)


def gather_ranges(lo_src: torch.Tensor, hi_src: torch.Tensor,
                  x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo_src[x], hi_src[x]) as int64 [B]: ``lo_src`` and ``hi_src`` are
    int32 [n] tensors of one stride (two tables, or the two columns of an
    [n, 2] row table), ``x`` int64 [B] in [0, n); raises ``ValueError``
    for an index outside it."""
    _contiguous("gather_ranges", x=(x, torch.int64))
    n = lo_src.numel()
    if lo_src.dtype != torch.int32 or hi_src.dtype != torch.int32 \
            or lo_src.dim() != 1 or hi_src.shape != lo_src.shape \
            or hi_src.stride() != lo_src.stride() or lo_src.stride(0) < 1:
        raise ValueError("gather_ranges: the sources must be int32 [n] "
                         "tensors of one positive stride")
    cuda = _build.on_cuda(lo_src, hi_src, x)
    if x.numel() == 0:
        return (torch.empty(0, dtype=torch.int64, device=x.device),
                torch.empty(0, dtype=torch.int64, device=x.device))
    outside = f"gather_ranges: an index lies outside [0, {n})"
    if not cuda:  # torch's CPU indexing would wrap a negative index
        xmin, xmax = _extremes(x)
        if xmin < 0 or xmax >= n:
            raise ValueError(outside)
        return gather_ranges_plain(lo_src, hi_src, x)
    lo, hi, bad = launch_gather_ranges(lo_src, hi_src, x)
    if bad.item():  # one 4-byte read: the host waits for the kernel
        raise ValueError(outside)
    return lo, hi


def launch_gather_ranges(lo_src, hi_src, x):
    """KR's launch alone, on arguments :func:`gather_ranges` has checked:
    (lo, hi, bad), ``bad`` an int32 [1] flag on the card, nonzero when an
    index lies outside [0, n) (and lo, hi then garbage). Nothing is read
    back, so the host does not wait for the card."""
    lib = _build.lib()
    B = x.numel()
    lo = torch.empty(B, dtype=torch.int64, device=x.device)
    hi = torch.empty(B, dtype=torch.int64, device=x.device)
    bad = torch.empty(1, dtype=torch.int32, device=x.device)
    gather_ranges.launches += 1
    _build.check(lib.asgart_gather_ranges(
        lo_src.data_ptr(), hi_src.data_ptr(), lo_src.stride(0),
        lo_src.numel(), x.data_ptr(), B, lo.data_ptr(), hi.data_ptr(),
        bad.data_ptr(), _build.stream_of(x)), "gather_ranges")
    return lo, hi, bad


gather_ranges.launches = 0


def gather_ranges_plain(lo_src, hi_src, x):
    """Plain PyTorch version of the KR kernel."""
    return lo_src[x].long(), hi_src[x].long()


def pack_probe_planes(codes: torch.Tensor, positions: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 [B]: the k codes of ``codes`` (uint8) from each of
    ``positions`` (int64 [B]) folded 3 bits at a time, the first max(k -
    10, 0) into ``hi`` and the rest into ``lo``; every ``position + k``
    must lie within ``codes`` (a needle's codes padded by k)."""
    _contiguous("pack_probe_planes", codes=(codes, torch.uint8),
                positions=(positions, torch.int64))
    if not 1 <= k <= 20:
        raise ValueError(f"pack_probe_planes: probe size {k} is outside "
                         "1..20 (two planes of 10 3-bit codes)")
    cuda = _build.on_cuda(codes, positions)
    B = positions.numel()
    if B == 0:
        return (torch.empty(0, dtype=torch.int32, device=codes.device),
                torch.empty(0, dtype=torch.int32, device=codes.device))
    pmin, pmax = _extremes(positions)
    if pmin < 0 or pmax + k > codes.numel():
        raise ValueError("pack_probe_planes: a probe reads past the codes "
                         f"({codes.numel()}; pad them by k = {k})")
    if not cuda:
        return pack_probe_planes_plain(codes, positions, k)
    hi = torch.empty(B, dtype=torch.int32, device=codes.device)
    lo = torch.empty(B, dtype=torch.int32, device=codes.device)
    lib = _build.lib()
    pack_probe_planes.launches += 1
    _build.check(lib.asgart_pack_probe_planes(
        codes.data_ptr(), positions.data_ptr(), B, k, hi.data_ptr(),
        lo.data_ptr(), _build.stream_of(codes)), "pack_probe_planes")
    return hi, lo


pack_probe_planes.launches = 0


def pack_probe_planes_plain(codes, positions, k: int):
    """Plain PyTorch version of the KS kernel (asgart_tpu/seed.py:47-62)."""
    n_hi = max(k - 10, 0)
    hi = torch.zeros(positions.shape, dtype=torch.int32,
                     device=positions.device)
    lo = torch.zeros_like(hi)
    c = codes.to(torch.int32)
    for j in range(n_hi):
        hi = (hi << 3) | c[positions + j]
    for j in range(n_hi, k):
        lo = (lo << 3) | c[positions + j]
    return hi, lo
