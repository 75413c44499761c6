"""ctypes bindings for the native runtime (SA-IS, chaining, Levenshtein).

The shared library is built on demand with g++ (no external build deps);
rebuilds happen automatically whenever the C++ source is newer than the
artifact.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading  # noqa: F401 — os used by thread-count defaults

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "asgart_native.cpp")
_LIB = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                    "asgart_tpu_torch", "libasgart_native.so")

_lock = threading.Lock()
_lib = None


def _tune_malloc() -> None:
    """Keep big allocations on the reusable heap: this kernel's page
    faults cost ~6s/GB, so fresh mmap-backed allocations dominate runtime
    unless glibc recycles memory (M_MMAP_MAX=0, M_TRIM_THRESHOLD=-1)."""
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(ctypes.c_int(-4), ctypes.c_int(0))       # M_MMAP_MAX
        libc.mallopt(ctypes.c_int(-1), ctypes.c_int(-1))      # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()


def _madv_hugepage(arr: np.ndarray) -> np.ndarray:
    """Advise THP for a large buffer (madvise mode on this kernel):
    cuts first-touch fault counts ~512x, the dominant cold-build cost
    on the host it was tuned on (~6 s/GB fault tax)."""
    try:
        MADV_HUGEPAGE = 14
        libc = ctypes.CDLL(None, use_errno=True)
        addr = arr.ctypes.data
        aligned = addr & ~0xFFF
        length = arr.nbytes + (addr - aligned)
        libc.madvise(ctypes.c_void_p(aligned), ctypes.c_size_t(length),
                     ctypes.c_int(MADV_HUGEPAGE))
    except Exception:
        pass
    return arr


def _build() -> None:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    # prefer native tuning, fall back to a portable baseline (the artifact
    # is never shipped — it is rebuilt whenever the source is newer)
    for arch in ("-march=native", "-march=x86-64-v3", None):
        cmd = base + ([arch] if arch else [])
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            # concurrent builders never expose a half-written library
            os.replace(tmp, _LIB)
            return
        except subprocess.CalledProcessError as e:
            last = e
    raise RuntimeError(f"native build failed: {last.stderr[-2000:]}")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)

        lib.asgart_sais.restype = ctypes.c_int
        lib.asgart_sais.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]

        lib.asgart_chain.restype = ctypes.c_int
        lib.asgart_chain.argtypes = [
            ctypes.c_void_p,  # params
            ctypes.c_void_p,  # sa
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # probes
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,  # outputs
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]

        lib.asgart_chain_events.restype = ctypes.c_int
        lib.asgart_chain_events.argtypes = [
            ctypes.c_void_p,  # params
            ctypes.c_void_p, ctypes.c_void_p,  # probe_is, z_before
            ctypes.c_void_p, ctypes.c_void_p,  # m_offsets, m_starts
            ctypes.c_int64, ctypes.c_int64,    # n_events, z_trail
            ctypes.c_void_p, ctypes.c_void_p,  # outputs
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]

        lib.asgart_levenshtein.restype = ctypes.c_int64
        lib.asgart_levenshtein.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_levenshtein_myers.restype = ctypes.c_int64
        lib.asgart_levenshtein_myers.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_reduce_overlap.restype = ctypes.c_int
        lib.asgart_reduce_overlap.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_filter_ns.restype = ctypes.c_int
        lib.asgart_filter_ns.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_kmer_suffix_sort.restype = ctypes.c_int
        lib.asgart_kmer_suffix_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_build_position_index.restype = ctypes.c_int
        lib.asgart_build_position_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_build_position_index_codes.restype = ctypes.c_int
        lib.asgart_build_position_index_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_build_position_index_codes2.restype = ctypes.c_int
        lib.asgart_build_position_index_codes2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_build_position_index_codes_i32.restype = ctypes.c_int
        lib.asgart_build_position_index_codes_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_batch_equal_range_bytes.restype = ctypes.c_int
        lib.asgart_batch_equal_range_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_batch_equal_range.restype = ctypes.c_int
        lib.asgart_batch_equal_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_build_bucket_table.restype = ctypes.c_int
        lib.asgart_build_bucket_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_batch_equal_range_bucketed.restype = ctypes.c_int
        lib.asgart_batch_equal_range_bucketed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_pack_at.restype = ctypes.c_int
        lib.asgart_pack_at.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]

        lib.asgart_pack_kmers.restype = ctypes.c_int
        lib.asgart_pack_kmers.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_group_tables.restype = ctypes.c_int
        lib.asgart_group_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]

        lib.asgart_group_tables32.restype = ctypes.c_int
        lib.asgart_group_tables32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]

        _lib = lib
        return lib


class _ChainParams(ctypes.Structure):
    _fields_ = [
        ("probe_size", ctypes.c_int64),
        ("step_size", ctypes.c_int64),
        ("max_gap_size", ctypes.c_int64),
        ("min_duplication_length", ctypes.c_int64),
        ("max_cardinality", ctypes.c_int64),
        ("needle_offset", ctypes.c_int64),
        ("needle_len", ctypes.c_int64),
        ("reverse", ctypes.c_int64),
        ("max_match_pos", ctypes.c_int64),
        ("sa_is_i32", ctypes.c_int64),
    ]


def _as_i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def suffix_array(text: bytes | np.ndarray) -> np.ndarray:
    """Suffix array of ``text`` (byte-lexicographic), int64 positions."""
    lib = _load()
    buf = np.frombuffer(text, dtype=np.uint8) if isinstance(text, bytes) \
        else np.ascontiguousarray(text, dtype=np.uint8)
    n = len(buf)
    sa = np.empty(n, dtype=np.int64)
    rc = lib.asgart_sais(
        buf.ctypes.data_as(ctypes.c_void_p), n,
        sa.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError("asgart_sais failed")
    return sa


def chain(
    sa: np.ndarray,
    probe_is: np.ndarray,
    los: np.ndarray,
    his: np.ndarray,
    *,
    probe_size: int,
    step_size: int,
    max_gap_size: int,
    min_duplication_length: int,
    max_cardinality: int,
    needle_offset: int,
    needle_len: int,
    reverse: bool,
    max_match_pos: int = 1 << 62,
) -> list[list[tuple[int, int, int, int]]]:
    """Run the native automaton; returns families of
    (left, right, left_length, right_length) proto-duplicons in
    needle-relative left coordinates (like automaton.rs output).

    ``max_match_pos`` drops matches at/after the given absolute position
    (used by the doubled-text index to ignore transformed-half hits)."""
    lib = _load()
    sa_is_i32 = sa.dtype == np.int32
    sa = np.ascontiguousarray(sa)  # int32 passes through natively
    probe_is = _as_i64(probe_is)
    los = _as_i64(los)
    his = _as_i64(his)
    n_probes = len(probe_is)
    params = _ChainParams(
        probe_size=probe_size,
        step_size=step_size,
        max_gap_size=max_gap_size,
        min_duplication_length=min_duplication_length,
        max_cardinality=max_cardinality,
        needle_offset=needle_offset,
        needle_len=needle_len,
        reverse=1 if reverse else 0,
        max_match_pos=max_match_pos,
        sa_is_i32=1 if sa_is_i32 else 0,
    )

    cap_sds, cap_fams = 4096, 1024
    while True:
        out_sds = np.empty((cap_sds, 4), dtype=np.int64)
        out_fams = np.empty(cap_fams, dtype=np.int64)
        n_sds = ctypes.c_int64(0)
        n_fams = ctypes.c_int64(0)
        rc = lib.asgart_chain(
            ctypes.byref(params),
            sa.ctypes.data_as(ctypes.c_void_p),
            probe_is.ctypes.data_as(ctypes.c_void_p),
            los.ctypes.data_as(ctypes.c_void_p),
            his.ctypes.data_as(ctypes.c_void_p),
            n_probes,
            out_sds.ctypes.data_as(ctypes.c_void_p),
            out_fams.ctypes.data_as(ctypes.c_void_p),
            cap_sds, cap_fams,
            ctypes.byref(n_sds), ctypes.byref(n_fams))
        if rc == 0:
            break
        cap_sds = max(cap_sds * 2, int(n_sds.value) + 1)
        cap_fams = max(cap_fams * 2, int(n_fams.value) + 1)

    families = []
    k = 0
    for f in range(n_fams.value):
        size = int(out_fams[f])
        fam = [tuple(int(x) for x in out_sds[k + s]) for s in range(size)]
        families.append(fam)
        k += size
    return families


def chain_events(
    probe_is: np.ndarray,
    z_before: np.ndarray,
    m_offsets: np.ndarray,
    m_starts: np.ndarray,
    *,
    z_trail: int,
    probe_size: int,
    step_size: int,
    max_gap_size: int,
    min_duplication_length: int,
    max_cardinality: int,
) -> list[list[tuple[int, int, int, int]]]:
    """Run the automaton over a compacted event stream (probes with >= 1
    kept match, CSR matches already filtered, plus intervening aging-step
    counts). Exactly equivalent to :func:`chain` on the full probe stream;
    the device engine downloads only events, so this is the host-side
    chaining endpoint of the TPU scan path."""
    lib = _load()
    probe_is = _as_i64(probe_is)
    z_before = _as_i64(z_before)
    m_offsets = _as_i64(m_offsets)
    m_starts = _as_i64(m_starts)
    n_events = len(probe_is)
    params = _ChainParams(
        probe_size=probe_size,
        step_size=step_size,
        max_gap_size=max_gap_size,
        min_duplication_length=min_duplication_length,
        max_cardinality=max_cardinality,
        needle_offset=0, needle_len=0, reverse=0,
        max_match_pos=1 << 62, sa_is_i32=0,
    )
    cap_sds, cap_fams = 4096, 1024
    while True:
        out_sds = np.empty((cap_sds, 4), dtype=np.int64)
        out_fams = np.empty(cap_fams, dtype=np.int64)
        n_sds = ctypes.c_int64(0)
        n_fams = ctypes.c_int64(0)
        rc = lib.asgart_chain_events(
            ctypes.byref(params),
            probe_is.ctypes.data_as(ctypes.c_void_p),
            z_before.ctypes.data_as(ctypes.c_void_p),
            m_offsets.ctypes.data_as(ctypes.c_void_p),
            m_starts.ctypes.data_as(ctypes.c_void_p),
            n_events, z_trail,
            out_sds.ctypes.data_as(ctypes.c_void_p),
            out_fams.ctypes.data_as(ctypes.c_void_p),
            cap_sds, cap_fams,
            ctypes.byref(n_sds), ctypes.byref(n_fams))
        if rc == 0:
            break
        cap_sds = max(cap_sds * 2, int(n_sds.value) + 1)
        cap_fams = max(cap_fams * 2, int(n_fams.value) + 1)

    families = []
    k = 0
    for f in range(n_fams.value):
        size = int(out_fams[f])
        families.append(
            [tuple(int(x) for x in out_sds[k + s]) for s in range(size)])
        k += size
    return families


def kmer_suffix_sort(kmers: np.ndarray, k: int,
                     n_threads: int = 0) -> np.ndarray:
    """Suffix array via parallel k-mer radix sort + prefix doubling.

    Equivalent to ``suffix_array`` when all suffixes are distinct (always
    true for texts with a unique '$'), but parallel and bandwidth-bound.
    """
    lib = _load()
    kmers = _as_i64(kmers)
    n = len(kmers)
    sa = np.empty(n, dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_kmer_suffix_sort(
        kmers.ctypes.data_as(ctypes.c_void_p), n, k,
        sa.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_kmer_suffix_sort failed")
    return sa


def build_position_index(codes: np.ndarray, k: int, n_threads: int = 0,
                         with_keys: bool = False):
    """Fused suffix sort + per-position equal-range tables (int32) from
    3-bit symbol codes (k-mers are packed on the fly; 12-byte sort
    records). Returns (sa int64, ranges int32[n,2][, keys int64])."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    if n >= (1 << 31):
        raise ValueError("fused tables require n < 2^31; use "
                         "kmer_suffix_sort + group_tables")
    sa = _madv_hugepage(np.empty(n, dtype=np.int32))
    ranges = _madv_hugepage(np.empty((n, 2), dtype=np.int32))
    keys = _madv_hugepage(np.empty(n, dtype=np.int64)) if with_keys \
        else None
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_build_position_index_codes_i32(
        codes.ctypes.data_as(ctypes.c_void_p), n, k,
        sa.ctypes.data_as(ctypes.c_void_p),
        ranges.ctypes.data_as(ctypes.c_void_p),
        keys.ctypes.data_as(ctypes.c_void_p) if with_keys else None,
        n_threads)
    if rc != 0:
        raise RuntimeError("asgart_build_position_index failed")
    if with_keys:
        return sa, ranges, keys
    return sa, ranges


def batch_equal_range(keys_sorted: np.ndarray, probes: np.ndarray,
                      n_threads: int = 0, bucket_table=None, k: int = 0,
                      topb: int = 0):
    """Parallel equal-range of packed probe k-mers in the sorted keys;
    accelerated by a prefix bucket table when provided."""
    lib = _load()
    keys_sorted = _as_i64(keys_sorted)
    probes = _as_i64(probes)
    m = len(probes)
    lo = np.empty(m, dtype=np.int64)
    hi = np.empty(m, dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    if bucket_table is not None:
        rc = lib.asgart_batch_equal_range_bucketed(
            keys_sorted.ctypes.data_as(ctypes.c_void_p), len(keys_sorted),
            probes.ctypes.data_as(ctypes.c_void_p), m,
            bucket_table.ctypes.data_as(ctypes.c_void_p), k, topb,
            lo.ctypes.data_as(ctypes.c_void_p),
            hi.ctypes.data_as(ctypes.c_void_p), n_threads)
    else:
        rc = lib.asgart_batch_equal_range(
            keys_sorted.ctypes.data_as(ctypes.c_void_p), len(keys_sorted),
            probes.ctypes.data_as(ctypes.c_void_p), m,
            lo.ctypes.data_as(ctypes.c_void_p),
            hi.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_batch_equal_range failed")
    return lo, hi


def batch_equal_range_bytes(text: np.ndarray, sa: np.ndarray,
                            patterns: np.ndarray, k: int,
                            sa_offset: int = 0,
                            n_threads: int = 0) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Byte-compare equal-range over a suffix array (the wide-probe
    k > 21 path). ``patterns`` is [m, k] uint8; ``sa`` holds absolute
    positions rebased into ``text`` by ``sa_offset``."""
    lib = _load()
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = _as_i64(sa)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    m = len(patterns)
    lo = np.empty(m, dtype=np.int64)
    hi = np.empty(m, dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_batch_equal_range_bytes(
        text.ctypes.data_as(ctypes.c_void_p), len(text),
        sa.ctypes.data_as(ctypes.c_void_p), len(sa), sa_offset,
        patterns.ctypes.data_as(ctypes.c_void_p), k, m,
        lo.ctypes.data_as(ctypes.c_void_p),
        hi.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_batch_equal_range_bytes failed")
    return lo, hi


def build_bucket_table(keys_sorted: np.ndarray, k: int, topb: int,
                       n_threads: int = 0) -> np.ndarray:
    lib = _load()
    keys_sorted = _as_i64(keys_sorted)
    out = np.empty((1 << topb) + 1, dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_build_bucket_table(
        keys_sorted.ctypes.data_as(ctypes.c_void_p), len(keys_sorted),
        k, topb, out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_build_bucket_table failed")
    return out


def pack_at(codes: np.ndarray, k: int, positions: np.ndarray,
            n_threads: int = 0) -> np.ndarray:
    """Packed k-mers at the given positions only."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    positions = _as_i64(positions)
    out = np.empty(len(positions), dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_pack_at(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes), k,
        positions.ctypes.data_as(ctypes.c_void_p), len(positions),
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_pack_at failed")
    return out


def pack_kmers(codes: np.ndarray, k: int, n_threads: int = 0) -> np.ndarray:
    """int64 packed k-mers at every position (zero-padded past the end)."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    out = np.empty(n, dtype=np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_pack_kmers(
        codes.ctypes.data_as(ctypes.c_void_p), n, k,
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_pack_kmers failed")
    return out


def group_tables(sa: np.ndarray, kmers: np.ndarray,
                 n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-position equal-range tables. int32 tables when the text fits
    (halves the scatter traffic and feeds the device path directly)."""
    lib = _load()
    sa = _as_i64(sa)
    kmers = _as_i64(kmers)
    n = len(sa)
    n_threads = n_threads or (os.cpu_count() or 1)
    if n < (1 << 31):
        pos_lo = np.empty(n, dtype=np.int32)
        pos_hi = np.empty(n, dtype=np.int32)
        fn = lib.asgart_group_tables32
    else:
        pos_lo = np.empty(n, dtype=np.int64)
        pos_hi = np.empty(n, dtype=np.int64)
        fn = lib.asgart_group_tables
    rc = fn(
        sa.ctypes.data_as(ctypes.c_void_p),
        kmers.ctypes.data_as(ctypes.c_void_p), n,
        pos_lo.ctypes.data_as(ctypes.c_void_p),
        pos_hi.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_group_tables failed")
    return pos_lo, pos_hi


def reduce_overlap_csr(sds: np.ndarray, fam_offsets: np.ndarray,
                       n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Fixpoint overlap reduction over CSR-packed families ([total, 4]
    int64 records + offsets), threaded across families. Returns the
    reduced (sds, offsets)."""
    lib = _load()
    sds = np.ascontiguousarray(sds, dtype=np.int64)
    fam_offsets = _as_i64(fam_offsets)
    n_fams = len(fam_offsets) - 1
    out_sds = np.empty_like(sds)
    out_offsets = np.empty_like(fam_offsets)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_reduce_overlap(
        sds.ctypes.data_as(ctypes.c_void_p),
        fam_offsets.ctypes.data_as(ctypes.c_void_p), n_fams,
        out_sds.ctypes.data_as(ctypes.c_void_p),
        out_offsets.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_reduce_overlap failed")
    return out_sds[: out_offsets[-1]], out_offsets


def filter_ns_flags(sds: np.ndarray, strand: bytes,
                    n_threads: int = 0) -> np.ndarray:
    """Per-record keep flags for the FilterNs step (>20% N drop)."""
    lib = _load()
    sds = np.ascontiguousarray(sds, dtype=np.int64)
    keep = np.empty(len(sds), dtype=np.uint8)
    sb = np.frombuffer(strand, dtype=np.uint8)
    n_threads = n_threads or (os.cpu_count() or 1)
    rc = lib.asgart_filter_ns(
        sds.ctypes.data_as(ctypes.c_void_p), len(sds),
        sb.ctypes.data_as(ctypes.c_void_p), len(sb),
        keep.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError("asgart_filter_ns failed")
    return keep.astype(bool)


def levenshtein(a: bytes, b: bytes) -> int:
    """Levenshtein distance (Myers/Hyyrö bit-parallel; same metric as the
    reference's DP, usable on Mbp-scale arms)."""
    lib = _load()
    ab = np.frombuffer(a, dtype=np.uint8)
    bb = np.frombuffer(b, dtype=np.uint8)
    return int(lib.asgart_levenshtein_myers(
        ab.ctypes.data_as(ctypes.c_void_p), len(ab),
        bb.ctypes.data_as(ctypes.c_void_p), len(bb)))


def levenshtein_dp(a: bytes, b: bytes) -> int:
    """Two-row DP oracle (the reference's algorithm, structs.rs:439-452)."""
    lib = _load()
    ab = np.frombuffer(a, dtype=np.uint8)
    bb = np.frombuffer(b, dtype=np.uint8)
    return int(lib.asgart_levenshtein(
        ab.ctypes.data_as(ctypes.c_void_p), len(ab),
        bb.ctypes.data_as(ctypes.c_void_p), len(bb)))
