"""Genome index: suffix array + packed-k-mer sorted view.

The reference indexes the genome with a suffix array plus a dense 8-mer →
SA-interval cache, and answers probe queries by byte-wise binary search
(``src/searcher.rs``, ``src/divsufsort.rs``). The TPU-native redesign keeps
a true suffix array (for reference-identical match *ordering*) but replaces
byte-compare binary search with integer compares over a packed view:

  * each genome position packs its next ``k`` symbols into one int64
    (3 bits/symbol, byte-rank order ``$ < A < C < G < N < T`` so packed
    order == suffix order restricted to k prefixes),
  * ``sa_kmers[r] = pack(text[sa[r]:sa[r]+k])`` is therefore sorted, and a
    probe lookup is ``searchsorted`` — a data-parallel gather-only loop
    that runs equally well in numpy (host engine) and on TPU,
  * matches for a probe are ``sa[lo:hi]`` — in the reference's SA order,
    which the chaining automaton is sensitive to.

Positions whose window crosses the sentinel pack with low-order zero
symbols and can never equal an ACGTN probe, reproducing the reference's
"suffix shorter than pattern compares Less" rule (searcher.rs:164-170).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

_BUCKET_BUILD_LOCK = threading.Lock()

# byte → 3-bit symbol rank; '$'(36) < 'A' < 'C' < 'G' < 'N' < 'T'
CODE = np.zeros(256, dtype=np.uint8)
for _rank, _ch in enumerate(b"$ACGNT"):
    CODE[_ch] = _rank

# 3 bits/symbol in an int64 key caps the packable k-mer size; larger
# probes would silently wrap (and corrupt the radix histograms in the
# native builder), so every index entry point validates against this.
MAX_PROBE_SIZE = 21


def check_probe_size(k: int) -> None:
    if not (1 <= k <= MAX_PROBE_SIZE):
        raise ValueError(
            f"probe_size {k} is out of range: packed-k-mer indexing "
            f"supports 1..{MAX_PROBE_SIZE} (3 bits/symbol in 64-bit keys)")


def pack_kmers_at(codes_padded: np.ndarray, positions: np.ndarray,
                  k: int) -> np.ndarray:
    """Pack the k symbols starting at each position into int64.

    ``codes_padded`` must be uint8 with at least ``k`` zero-padding entries
    after the logical end of the text.
    """
    out = np.zeros(len(positions), dtype=np.int64)
    for j in range(k):
        out <<= 3
        out |= codes_padded[positions + j].astype(np.int64)
    return out


def pack_kmer(pattern: bytes) -> int:
    v = 0
    for b in pattern:
        v = (v << 3) | int(CODE[b])
    return v


@dataclass
class GenomeIndex:
    """Suffix array + sorted packed-k-mer view over (a window of) the
    concatenated strand."""

    sa: np.ndarray         # int64 absolute positions, suffix order
    sa_kmers: np.ndarray   # int64, sorted; sa_kmers[r] = pack(text[sa[r]:+k])
    k: int

    @classmethod
    def build(
        cls,
        strand_data: np.ndarray,   # uint8, includes trailing '$'
        k: int,
        trim: Optional[tuple[int, int]] = None,
        block: int = 1 << 22,
    ) -> "GenomeIndex":
        """Build the index the way the reference does (asgart.rs:140-155):
        full-strand SA by default; with ``trim``, the SA covers only
        ``strand[start:end] + '$'`` with positions shifted back to global
        coordinates."""
        from .native import suffix_array

        check_probe_size(k)
        if trim is not None:
            start, end = trim
            sub = np.concatenate(
                [strand_data[start:end], np.frombuffer(b"$", dtype=np.uint8)])
            sa = suffix_array(sub)
            sa += start
            # window-truncated view: text ends (with '$') at global `end`
            codes = np.zeros(end + 1 + k, dtype=np.uint8)
            codes[:end] = CODE[strand_data[:end]]
            # codes[end] is the '$' rank (0) and the tail is zero padding
        else:
            sa = suffix_array(strand_data)
            codes = np.zeros(len(strand_data) + k, dtype=np.uint8)
            codes[:len(strand_data)] = CODE[strand_data]

        sa_kmers = np.empty(len(sa), dtype=np.int64)
        for b0 in range(0, len(sa), block):
            blk = sa[b0: b0 + block]
            sa_kmers[b0: b0 + block] = pack_kmers_at(codes, blk, k)
        return cls(sa=sa, sa_kmers=sa_kmers, k=k)

    def lookup(self, probe_kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized equal-range for a batch of packed probes → [lo, hi)."""
        lo = np.searchsorted(self.sa_kmers, probe_kmers, side="left")
        hi = np.searchsorted(self.sa_kmers, probe_kmers, side="right")
        return lo.astype(np.int64), hi.astype(np.int64)

    def search(self, pattern: bytes) -> list[int]:
        """Single-probe exact search → absolute match starts in SA order
        (equivalent to Searcher::search, searcher.rs:145-180)."""
        v = pack_kmer(pattern)
        lo = int(np.searchsorted(self.sa_kmers, v, side="left"))
        hi = int(np.searchsorted(self.sa_kmers, v, side="right"))
        return [int(x) for x in self.sa[lo:hi]]


@dataclass
class ByteIndex:
    """Wide-probe index (k > MAX_PROBE_SIZE): a full suffix array (the
    SA itself is k-independent — built by the parallel packed-prefix
    sorter with 21-symbol keys + doubling) plus byte-compare equal-range,
    which is the reference's own search strategy for arbitrary probe
    sizes (searcher.rs:145-171 over sa_searchb64). Matches come out in
    SA order like every other strategy."""

    sa: np.ndarray       # int64 absolute positions, suffix order
    text: np.ndarray     # bytes compared against (the window for trim)
    k: int
    sa_offset: int       # text[p - sa_offset] rebases sa positions

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int,
              trim: Optional[tuple[int, int]] = None,
              n_threads: int = 0) -> "ByteIndex":
        from . import native

        if k < 1:
            raise ValueError(f"probe_size {k} is out of range")
        if trim is not None:
            start, end = trim
            sub = np.concatenate([
                strand_data[start:end],
                np.frombuffer(b"$", dtype=np.uint8)])
            text, offset = sub, start
        else:
            text, offset = strand_data, 0
        codes = CODE[text]
        kmers = native.pack_kmers(codes, MAX_PROBE_SIZE, n_threads)
        sa = native.kmer_suffix_sort(kmers, MAX_PROBE_SIZE, n_threads)
        if offset:
            sa += offset
        return cls(sa=sa, text=text, k=k, sa_offset=offset)

    def lookup_needle(self, needle: np.ndarray, is_: np.ndarray,
                      n_threads: int = 0,
                      block: int = 1 << 20) -> tuple[np.ndarray,
                                                     np.ndarray]:
        """Equal ranges for the probes at ``is_`` of ``needle`` (pattern
        bytes taken by value; blocked to bound the m*k staging buffer)."""
        from . import native

        k = self.k
        lo = np.empty(len(is_), dtype=np.int64)
        hi = np.empty(len(is_), dtype=np.int64)
        win = np.arange(k, dtype=np.int64)
        for b0 in range(0, len(is_), block):
            part = is_[b0: b0 + block]
            pats = needle[part[:, None] + win[None, :]]
            lo[b0: b0 + len(part)], hi[b0: b0 + len(part)] = \
                native.batch_equal_range_bytes(
                    self.text, self.sa, pats, k,
                    sa_offset=self.sa_offset, n_threads=n_threads)
        return lo, hi

    def search(self, pattern: bytes) -> list[int]:
        """Single-probe search (oracle hook), SA order."""
        pats = np.frombuffer(pattern, dtype=np.uint8)[None, :]
        from . import native

        lo, hi = native.batch_equal_range_bytes(
            self.text, self.sa, pats, len(pattern),
            sa_offset=self.sa_offset, n_threads=1)
        return [int(x) for x in self.sa[lo[0]:hi[0]]]


# byte → complement byte over normalized ACGTN (identity elsewhere)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


@dataclass
class PositionIndex:
    """Doubled-text index with O(1) probe-range lookup tables.

    TPU-native redesign of the probe search: the text indexed is
    ``strand.data ++ T(S)`` where ``S`` is the genome without the ``$``
    sentinel and ``T`` is the run's needle transform (reverse, complement,
    or reverse-complement; empty for direct runs). Every probe k-mer of
    the (transformed) needle is then literally a k-mer of the indexed
    text at a computable position, so a probe lookup is one gather into
    per-position equal-range tables — no binary search anywhere on the
    hot path (host or TPU).

    Match-order exactness: suffixes of the first half compare identically
    with or without the appended half because the interior ``$`` is a
    unique smallest separator, so first-half positions appear inside each
    equal range in exactly the reference's suffix order; appended-half
    positions (>= ``first_len``) are filtered out during chaining.
    """

    sa: np.ndarray       # int64 suffix order over the (doubled) text
    ranges: np.ndarray   # int32 [n, 2]: per text position [lo, hi)
    k: int
    first_len: int       # N = len(strand.data) (genome + '$')
    reverse: bool
    complement: bool
    # sorted k-mer keys (kmers[sa]); kept by the single-text strategy so
    # transformed probes resolve by parallel batch equal-range instead of
    # doubling the indexed text
    keys: Optional[np.ndarray] = None

    @property
    def pos_lo(self) -> np.ndarray:
        return self.ranges[:, 0]

    @property
    def pos_hi(self) -> np.ndarray:
        return self.ranges[:, 1]

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int,
              reverse: bool = False, complement: bool = False,
              n_threads: int = 0) -> "PositionIndex":
        from . import native

        check_probe_size(k)
        n = len(strand_data)
        s = strand_data[: n - 1]  # genome without the '$' sentinel
        if reverse or complement:
            half = _COMP[s] if complement else s
            if reverse:
                half = half[::-1]
            text = np.concatenate([strand_data, half])
        else:
            text = strand_data

        codes = CODE[text]
        # parallel radix + prefix doubling: same SA as SA-IS (the interior
        # '$' makes all suffixes distinct) at memory bandwidth, with
        # on-the-fly k-mer packing and the equal-range tables fused into
        # the final pass
        if len(codes) < (1 << 31):
            sa, ranges = native.build_position_index(codes, k, n_threads)
        else:
            kmers = native.pack_kmers(codes, k, n_threads)
            sa = native.kmer_suffix_sort(kmers, k, n_threads)
            pos_lo, pos_hi = native.group_tables(sa, kmers, n_threads)
            ranges = np.stack([pos_lo, pos_hi], axis=1)
        return cls(sa=sa, ranges=ranges, k=k, first_len=n,
                   reverse=reverse, complement=complement)

    @classmethod
    def build_single_cached(cls, strand_data: np.ndarray, k: int,
                            cache_dir: str, n_threads: int = 0
                            ) -> "PositionIndex":
        """``build_single`` with an on-disk cache keyed by the strand
        content hash and k. One cached single-text index serves all four
        run modes (direct and R/C/RC resolve against the same tables /
        keys), so repeated runs skip the suffix sort entirely; arrays are
        memory-mapped on load, so pages fault in lazily during the scan
        instead of up front. Beyond-reference feature (the reference
        rebuilds its SA every run)."""
        import hashlib
        import json
        import os

        h = hashlib.sha256()
        h.update(strand_data.tobytes())
        h.update(f"|k={k}|v1".encode())
        key = h.hexdigest()[:32]
        base = os.path.join(cache_dir, f"asgart-index-{key}")
        meta_p = base + ".json"
        try:
            with open(meta_p) as fh:
                meta = json.load(fh)
            if meta.get("n") == int(len(strand_data)) and meta.get("k") == k:
                sa = np.load(base + ".sa.npy", mmap_mode="r")
                ranges = np.load(base + ".ranges.npy", mmap_mode="r")
                keys = np.load(base + ".keys.npy", mmap_mode="r")
                idx = cls(sa=sa, ranges=ranges, k=k,
                          first_len=len(strand_data),
                          reverse=False, complement=False, keys=keys)
                idx._build_bucket_table(n_threads)
                return idx
        except (OSError, ValueError):
            pass
        idx = cls.build_single(strand_data, k, n_threads=n_threads)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = base + ".tmp"
        try:
            np.save(tmp + ".sa.npy", idx.sa)
            np.save(tmp + ".ranges.npy", idx.ranges)
            np.save(tmp + ".keys.npy", idx.keys)
            for part in (".sa.npy", ".ranges.npy", ".keys.npy"):
                os.replace(tmp + part, base + part)
            with open(meta_p, "w") as fh:
                json.dump({"n": int(len(strand_data)), "k": k}, fh)
        except OSError:
            pass  # cache is best-effort
        return idx

    @classmethod
    def build_single(cls, strand_data: np.ndarray, k: int,
                     n_threads: int = 0) -> "PositionIndex":
        """Single-text index (host fast path for transformed modes): the
        tables serve direct probes by gather; R/C/RC probes resolve by
        parallel batch equal-range over the retained sorted keys — half
        the sort work of the doubled text, at +O(probes·log n) search."""
        from . import native

        check_probe_size(k)
        codes = CODE[strand_data]
        sa, ranges, keys = native.build_position_index(
            codes, k, n_threads, with_keys=True)
        idx = cls(sa=sa, ranges=ranges, k=k, first_len=len(strand_data),
                  reverse=False, complement=False, keys=keys)
        # eager bucket table: the multi-threaded chunk path shares this
        # index across workers, so build the accelerator before any
        # concurrent search_ranges call
        idx._build_bucket_table(n_threads)
        return idx

    def _build_bucket_table(self, n_threads: int = 0) -> None:
        from . import native

        # ~16 entries per bucket on average
        self._bucket_topb = max(
            1, min(24, 3 * self.k,
                   int(np.log2(max(len(self.keys) // 16, 2)))))
        self._bucket_table = native.build_bucket_table(
            self.keys, self.k, self._bucket_topb, n_threads)

    def search_ranges(self, probe_kmers: np.ndarray,
                      n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Equal ranges by value (transformed probes on a single-text
        index), accelerated by a lazily built prefix bucket table."""
        from . import native

        if self.keys is None:
            raise ValueError("index built without retained keys")
        if not hasattr(self, "_bucket_table"):
            # build paths create the table eagerly; this lazy fallback
            # (hand-constructed indexes) is locked so concurrent
            # search_ranges callers don't duplicate the build
            with _BUCKET_BUILD_LOCK:
                if not hasattr(self, "_bucket_table"):
                    self._build_bucket_table(n_threads)
        return native.batch_equal_range(
            self.keys, probe_kmers, n_threads,
            bucket_table=self._bucket_table, k=self.k,
            topb=self._bucket_topb)

    def probe_table_positions(self, chunk_start: int, chunk_len: int,
                              probe_is: np.ndarray) -> np.ndarray:
        """Map needle-relative probe indices to indexed-text positions
        whose k-mer equals the probe's pattern."""
        n = self.first_len
        if self.reverse:
            q = chunk_start + chunk_len - probe_is - self.k
            return n + (n - 1 - q - self.k)
        if self.complement:
            return n + chunk_start + probe_is
        return chunk_start + probe_is

    def probe_ranges(self, chunk_start: int, chunk_len: int,
                     probe_is: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Equal ranges for every probe of a chunk: one table gather."""
        x = self.probe_table_positions(chunk_start, chunk_len, probe_is)
        r = self.ranges[x]
        return r[:, 0], r[:, 1]
