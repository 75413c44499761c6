"""Host-only helpers whose originals live in JAX-importing modules.

``asgart_tpu.device_index`` and ``asgart_tpu.device_engine`` import jax at
module level (``asgart_tpu.pipeline`` inside its functions), so the port
cannot import these from there. Each is a copy
of its original, named in its docstring or in the comment above it;
tests/test_torch_host_copies.py pins every copy against its original.
"""

from __future__ import annotations

import os

import numpy as np

# Copy of asgart_tpu.device_index.COMP_CODE (device_index.py:47).
# 3-bit symbol rank complement: $->$, A<->T, C<->G, N->N
COMP_CODE = np.array([0, 5, 3, 2, 4, 1], dtype=np.uint8)

# Copy of asgart_tpu.device_engine.B_GRAN (device_engine.py:60).
B_GRAN = 1 << 20

# Copy of asgart_tpu.device_engine.SLICE_GRAN (device_engine.py:478).
SLICE_GRAN = 4096        # planning granule (probe lanes)


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


# Copy of asgart_tpu.device_engine._slice_budget (device_engine.py:481).
def _slice_budget() -> int:
    env = os.environ.get("ASGART_DEVICE_SLICE_LANES")
    return int(env) if env else (1 << 26)


# Copy of asgart_tpu.device_engine._plan_slices (device_engine.py:609)
# without its B_GRAN lane cap, which kept a slice's table reads inside the
# JAX table padding (`table_pad_for`); KD reads no padded table and takes
# any lane count.
def _plan_slices(gran_totals, gran_lanes: int, budget: int):
    """Greedy-pack consecutive granules into probe slices whose raw
    totals stay within ``budget`` (a single over-budget granule becomes
    its own slice). No lane cap: KD reads no padded table. Returns
    [(lane0, n_lanes, total)] partitioning [0, len*gran_lanes)."""
    slices = []
    cur0 = 0
    cur_lanes = 0
    cur_tot = 0.0
    for g, t in enumerate(gran_totals):
        t = float(t)
        if cur_lanes and cur_tot + t > budget:
            slices.append((cur0, cur_lanes, cur_tot))
            cur0 = g * gran_lanes
            cur_lanes = 0
            cur_tot = 0.0
        cur_lanes += gran_lanes
        cur_tot += t
    if cur_lanes:
        slices.append((cur0, cur_lanes, cur_tot))
    return slices


def host_window_arrays(strand_data: np.ndarray, k: int, ws: int,
                       we: int, n_threads: int = 0):
    """(key_hi, key_lo, run_lo, sa_rel, W) for one trim window, built on
    the HOST — the build path for windows larger than one HBM (the
    device build's sorts need the whole window in one memory; the host
    has RAM). Bit-equal to `device_index.window_arrays_from_codes` (the
    sorted-key order of equal k-mers IS the suffix order, which both
    builders produce exactly; pinned by tests/test_rank_sharded.py)."""
    from .index import CODE
    from .native import suffix_array

    w_text = we - ws
    W = w_text + 1
    sub = np.empty(W, dtype=np.uint8)
    sub[:w_text] = strand_data[ws:we]
    sub[w_text] = ord("$")
    sa = suffix_array(sub).astype(np.int32)
    codes = np.zeros(W + k, dtype=np.uint8)
    codes[:W] = CODE[sub]
    codes[W - 1] = 0  # '$' rank
    from .kernels.pack_keys import LO_SYMS

    n_hi = max(k - LO_SYMS, 0)
    key_hi = np.zeros(W, dtype=np.int64)
    key_lo = np.zeros(W, dtype=np.int64)
    for j in range(n_hi):
        key_hi = (key_hi << 3) | codes[sa + j]
    for j in range(n_hi, k):
        key_lo = (key_lo << 3) | codes[sa + j]
    key_hi = key_hi.astype(np.int32)
    key_lo = key_lo.astype(np.int32)
    iota = np.arange(W, dtype=np.int32)
    neq = np.empty(W, dtype=bool)
    neq[0] = True
    neq[1:] = (key_hi[1:] != key_hi[:-1]) | (key_lo[1:] != key_lo[:-1])
    run_lo = np.maximum.accumulate(np.where(neq, iota, 0))
    return key_hi, key_lo, run_lo, sa, W


def rank_sharded_window_applies(n1: int, W: int, doubled: bool,
                                n_dev: int | None = None,
                                k: int = 20, *, free: float) -> bool:
    """Whether a trim window should be served by the rank-sharded
    engine: forced via ``ASGART_RANK_SHARDED=1``, or the window exceeds
    a single device (rows or HBM) while a multi-device mesh can hold it
    at ~12 B/row per shard plus bounded scan transients."""
    from .distributed import world
    from .fused_index import mj_fits

    if os.environ.get("ASGART_RANK_SHARDED") == "1":
        return True
    if n_dev is None:
        n_dev = world()
    if n_dev < 2 or mj_fits(n1, W, k, free, resident=n1):
        return False
    per_shard = 12 * (-(-W // n_dev)) + (1 << 28)
    return per_shard <= free
