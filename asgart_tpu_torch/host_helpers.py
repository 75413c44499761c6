"""Host-only helpers whose originals live in JAX-importing modules.

``asgart_tpu.device_index`` and ``asgart_tpu.device_engine`` import jax at
module level, so the port cannot import these from there. Each is a copy
of its original, named in its docstring; tests/test_torch_host_copies.py
pins every copy against its original.
"""

from __future__ import annotations

import numpy as np

# Copy of asgart_tpu.device_index.COMP_CODE (device_index.py:47).
# 3-bit symbol rank complement: $->$, A<->T, C<->G, N->N
COMP_CODE = np.array([0, 5, 3, 2, 4, 1], dtype=np.uint8)

# Copy of asgart_tpu.device_engine.B_GRAN (device_engine.py:60).
B_GRAN = 1 << 20


def _bucket(n: int, lo: int = 1 << 16) -> int:
    """Copy of ``asgart_tpu.device_engine._bucket`` (device_engine.py:47):
    pow2 buckets up to B_GRAN, then B_GRAN multiples."""
    b = lo
    while b < n and b < B_GRAN:
        b <<= 1
    if b < n:
        b = -(-n // B_GRAN) * B_GRAN
    return b


def _probe_x0(chunk_start, chunk_len, first_len, k: int, reverse: bool,
              complement: bool):
    """Copy of ``asgart_tpu.device_engine._probe_x0`` (device_engine.py:130):
    doubled-text position of probe j=0 (i = step); the probe positions are
    x0 + j*step for every transform."""
    step = k // 2
    if reverse:
        return 2 * first_len - 1 - chunk_start - chunk_len + step
    if complement:
        return first_len + chunk_start + step
    return chunk_start + step


def _strand_fingerprint(data: np.ndarray) -> tuple:
    """Copy of ``asgart_tpu.device_index._strand_fingerprint``
    (device_index.py:910): content key of a strand — blake2b over
    per-slice blake2b digests, the slice size, and the length."""
    import hashlib

    buf = memoryview(np.ascontiguousarray(data)).cast("B")
    n = len(buf)
    slice_bytes = 32 << 20
    if n <= slice_bytes:
        h = hashlib.blake2b(buf, digest_size=16)
        return (h.hexdigest(), int(n))
    import os
    from concurrent.futures import ThreadPoolExecutor

    starts = range(0, n, slice_bytes)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
            as ex:
        parts = list(ex.map(
            lambda s: hashlib.blake2b(buf[s:s + slice_bytes],
                                      digest_size=16).digest(),
            starts))
    h = hashlib.blake2b(b"".join(parts), digest_size=16)
    return (h.hexdigest(), slice_bytes, int(n))


def _merge_shard_events(shard_events):
    """Copy of ``asgart_tpu.device_engine._merge_shard_events``
    (device_engine.py:1082): concatenate per-part (ev [3, n], m, z_trail)
    into one event stream, carrying trailing quiet steps onto the next
    part's first event."""
    evs, ms = [], []
    carry = 0
    for (ev, m, z_trail) in shard_events:
        if ev.shape[1] > 0:
            ev = ev.copy()
            ev[1, 0] += carry
            evs.append(ev)
            ms.append(m)
            carry = z_trail
        else:
            carry += z_trail
    if not evs:
        return None, None, carry
    return np.concatenate(evs, axis=1), np.concatenate(ms), carry
