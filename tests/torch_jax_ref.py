"""JAX-side references for the asgart_tpu_torch tests: the stages of the
JAX fused build (asgart_tpu/device_index.py:1605-1787), run step by step
on the CPU exactly as ``FusedIndex.build`` runs them, with every
intermediate copied out as numpy; plus shared genome fixtures.

The port's settings and results are the port's own classes
(``asgart_tpu_torch.structs``); :func:`jax_settings` gives the JAX
package's settings with the same fields, and :func:`json_text` serializes
either package's result with that package's exporter."""

from __future__ import annotations

import dataclasses
import fcntl
import io
import os

import numpy as np
import pytest
import torch

from asgart_tpu_torch.fasta import prepare_data
from asgart_tpu_torch.structs import RunSettings

from util import plant_duplication, random_dna, revcomp, write_fasta

TRANSFORMS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch operations on one intra-op thread (import
    this fixture into the module), so that the pytest-xdist workers, which
    share the machine's cores, are not oversubscribed by torch's OpenMP
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_port_test_at_a_time(tmp_path_factory):
    """Under pytest-xdist, run the port's tests one at a time across the
    workers (import this fixture into the module): each holds an exclusive
    lock on a file in the run's shared temporary root. The port's tests
    then add at most one worker's load beside the JAX package's tests. A
    JAX test on the virtual 8-device mesh can deadlock in XLA's CPU
    all-reduce when the machine's cores are oversubscribed, which aborts
    its worker (ROADMAP F7)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        yield
        return
    lock = tmp_path_factory.getbasetemp().parent / "asgart_torch_tests.lock"
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def json_text(result) -> str:
    """The JSON of a result of either package, by its own exporter (each
    package's serializer recognizes its own float32 type only)."""
    if type(result).__module__.startswith("asgart_tpu_torch."):
        from asgart_tpu_torch.exporters import JSONExporter
    else:
        from asgart_tpu.exporters import JSONExporter
    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def jax_settings(settings):
    """The JAX package's RunSettings with the fields of the port's."""
    from asgart_tpu.structs import RunSettings as JaxRunSettings

    return JaxRunSettings(**{f.name: getattr(settings, f.name)
                             for f in dataclasses.fields(settings)})


def chunked_genome(seed: int = 32, n: int = 60000) -> bytes:
    """Planted reverse-complement duplication, a > 5000-N run that splits
    the chunk, in-chunk N probes and a soft-masked stretch."""
    rng = np.random.default_rng(seed)
    g = bytearray(plant_duplication(rng, n, 2500, 3000, 40000, noise=0.0,
                                    transform=revcomp))
    g[12000:18000] = b"N" * 6000
    g[30000:30100] = b"N" * 100
    g[45000:46000] = bytes(g[45000:46000]).lower()
    return bytes(g)


def masked_multifasta(seed: int = 600) -> list:
    """The two FASTA records of tests/test_adversarial_pins.py:107-122:
    a soft-masked duplication source, an inter-fragment duplication,
    IUPAC bytes inside an arm, and a 5500-N run across the fragment
    boundary (chr1 is 24000 bp, chr2 16000 bp)."""
    rng = np.random.default_rng(seed)
    f1 = bytearray(random_dna(rng, 24000, b"ACGT"))
    f2 = bytearray(random_dna(rng, 16000, b"ACGT"))
    f1[14000:16000] = bytes(f1[2000:4000])
    f1[2800:3200] = bytes(f1[2800:3200]).lower()
    f2[6000:8000] = bytes(f1[13500:15500])
    for p in (14100, 14700, 15200):
        f1[p] = b"RYKMSWBDHV"[int(rng.integers(0, 10))]
    f1[20000:24000] = b"N" * 4000
    f2[0:1500] = b"N" * 1500
    return [("chr1", bytes(f1)), ("chr2", bytes(f2))]


def vocab_genome(seed: int = 34, tiles: int = 1500) -> bytes:
    """Tiled vocabulary: nearly every k-mer recurs, so the tied set is
    most of the genome (tests/test_fused.py:100's input, shortened)."""
    rng = np.random.default_rng(seed)
    vocab = [random_dna(rng, 50) for _ in range(300)]
    picks = rng.integers(0, len(vocab), tiles)
    return b"".join(vocab[t] for t in picks)


def satellite_genome(rng, n: int = 40000) -> bytes:
    """tests/test_device_window.py:387's genome (built the same way inline
    at tests/test_device_engine.py:386-397): a 40-mer satellite repeated
    over 10 kb (a raw-match explosion), a reverse-complement copy of part
    of it, and a plain 2 kb duplication."""
    g = bytearray(random_dna(rng, n, b"ACGT"))
    unit = random_dna(rng, 40, b"ACGT")
    g[15000:25000] = (unit * 250)[:10000]
    g[5000:9000] = revcomp(bytes(g[15000:19000]))
    g[30000:32000] = bytes(g[2000:4000])
    return bytes(g)


def granule_lanes(rng, kinds, n: int, gran: int, k: int = 20,
                  max_cardinality: int = 8):
    """One chunk's probe lanes (lane_lo, lane_hi int32, lane_mask bool, as
    numpy) over the identity suffix order ``sa`` (int32 numpy), for KD
    with the constants (0, 0, 0) direct: granule g of ``gran`` lanes (the
    last one cut at ``n``) holds lanes of ``kinds[g]``: "event" (windows
    above the probe, at most ``max_cardinality`` wide, with a quiet lane
    in four), "quiet" (windows at and below the probe: nothing kept),
    "over" (more than ``max_cardinality`` kept: neither event nor quiet);
    one lane in eight is masked out."""
    step = k // 2
    lo = np.zeros(n, np.int64)
    hi = np.zeros(n, np.int64)
    i = (np.arange(n) + 1) * step
    for g, kind in enumerate(kinds):
        s = slice(g * gran, min(n, (g + 1) * gran))
        m = s.stop - s.start
        r = rng.integers(1, 40, m)
        w = rng.integers(1, max_cardinality + 1, m)
        if kind == "event":
            quiet = rng.random(m) < 0.25
            lo[s] = np.where(quiet, np.maximum(i[s] - r, 0), i[s] + r)
            hi[s] = np.where(quiet, i[s] + 1, i[s] + r + w)
        elif kind == "quiet":
            lo[s], hi[s] = np.maximum(i[s] - r, 0), i[s] + 1
        else:  # "over"
            lo[s], hi[s] = i[s] + r, i[s] + r + max_cardinality + w
    mask = rng.random(n) >= 0.125
    lo, hi = np.where(mask, lo, 0), np.where(mask, hi, 0)
    sa = np.arange(int(hi.max()) + 1, dtype=np.int32)
    return lo.astype(np.int32), hi.astype(np.int32), mask, sa


def prepared(tmp_path, records, skip_masked: bool = False):
    """(chunks, strand) of a FASTA holding ``records``."""
    fa = tmp_path / "g.fa"
    write_fasta(fa, records)
    _, chunks, strand = prepare_data([str(fa)], skip_masked, None)
    return str(fa), chunks, strand


def specs_for(chunks, settings: RunSettings) -> tuple:
    """The JAX FusedEngine's chunk specs (device_engine.py:2185)."""
    from asgart_tpu.device_engine import FusedEngine

    eng = FusedEngine.__new__(FusedEngine)
    eng.settings = jax_settings(settings)
    eng.mesh = None
    return eng._specs_for([tuple(c) for c in chunks])


def jax_fused_stages(strand_data: np.ndarray, k: int, specs: tuple,
                     reverse: bool, complement: bool,
                     trim: tuple | None = None) -> dict:
    """Every intermediate of the JAX fused build, as numpy (with the
    third key plane, ``cktop``/``sktop``, for k = 21..30), of the whole
    genome or of the trim window ``trim`` = (ws, we)."""
    import jax.numpy as jnp

    from asgart_tpu import device_engine as de
    from asgart_tpu import device_index as di
    from asgart_tpu.index import CODE

    n1 = int(len(strand_data))
    W = n1 if trim is None else trim[1] - trim[0] + 1
    step = k // 2
    doubled = reverse or complement
    n = 2 * n1 - 1 if doubled else n1
    tail_pad = max((de._bucket(nc) - nc for (_, _, nc) in specs),
                   default=1 << 16) + 8
    total = sum(nc for (_, _, nc) in specs) + tail_pad
    codes1 = jnp.asarray(CODE[strand_data])
    base = n1 if doubled else 0
    n_src = n - base
    Lp = de.table_len_for(n_src, k)
    if doubled:
        src = di._transformed_codes(codes1, k, reverse, complement, Lp)
    else:
        src = di._build_text_codes(codes1, k, False, False, Lp)
    dec_src = di.decimate_codes_auto(src, step=step, L=Lp, n=n_src)
    x0s = tuple(int(de._probe_x0(cs, cl, n1, k, reverse, complement))
                - base for (cs, cl, _) in specs)
    j0s = jnp.zeros(max(len(specs), 1), jnp.int32)
    if trim is None:
        text_codes = di._build_text_codes(codes1, k, False, False, W)
    else:  # FusedIndex.build's window text (device_index.py:1718-1719)
        text_codes = di._window_codes(codes1, jnp.int32(trim[0]), W - 1, k)
    out = {"W": W, "total": total}
    if k > di.DEVICE_MAX_K:  # the planes3 branch of FusedIndex.build
        ptop, phi, plo, lane_mask = de._pack_batch_probe_keys3(
            dec_src, j0s, k, reverse, complement, n1, specs, total,
            x0s=x0s)
        cktop, ckhi, cklo = di._fused_cat_planes3(
            *di._pack_planes3_all(text_codes, k, W), ptop, phi, plo)
        out.update(cktop=np.asarray(cktop), ckhi=np.asarray(ckhi),
                   cklo=np.asarray(cklo))  # before the donating sort
        sktop, skhi, sklo, sa = di._flagged_sort3(cktop, ckhi, cklo,
                                                  jnp.int32(W))
        out.update(sktop=np.asarray(sktop))
    else:
        phi, plo, lane_mask = de._pack_batch_probe_keys(
            dec_src, j0s, k, reverse, complement, n1, specs, total,
            x0s=x0s)
        ckhi, cklo = di._fused_cat_planes(
            *di._pack_planes_all(text_codes, k, W), phi, plo)
        out.update(ckhi=np.asarray(ckhi), cklo=np.asarray(cklo))
        skhi, sklo, sa = di._flagged_sort(ckhi, cklo, jnp.int32(W))
        sktop = None
    out.update(lane_mask=np.asarray(lane_mask), skhi=np.asarray(skhi),
               sklo=np.asarray(sklo), sa=np.asarray(sa))
    run_lo, run_hi, tied = di._group_bounds_impl(
        skhi, sklo, sa, jnp.int32(W), flagged=True, sktop=sktop)
    out.update(run_lo=np.asarray(run_lo), run_hi=np.asarray(run_hi),
               tied=np.asarray(tied))
    L1 = de.table_len_for(W, k)
    rank, lane_lo, lane_hi, totals = di._invert_fused(
        sa, run_lo, run_hi, lane_mask, step, L1, W, specs=specs)
    out.update(rank_dec=np.asarray(rank), lane_lo=np.asarray(lane_lo),
               lane_hi=np.asarray(lane_hi), totals=np.asarray(totals))
    return out


def fused_key(ckhi: np.ndarray, cklo: np.ndarray, W: int) -> np.ndarray:
    """The JAX (hi, (lo << 1) | row >= W) sort key as one int64."""
    flag = (np.arange(len(ckhi)) >= W).astype(np.int64)
    return (ckhi.astype(np.int64) << 31) | (cklo.astype(np.int64) << 1) \
        | flag


def key_planes(words):
    """The port's two key words decoded back into the JAX planes: (top,
    hi, lo) int32 and the flag bit (which must equal row >= W)."""
    w1, w0 = (np.asarray(w) for w in words)
    planes = ((w1 >> 31).astype(np.int32),
              (w1 & (2**31 - 1)).astype(np.int32),
              (w0 >> 1).astype(np.int32))
    return planes, (w0 & 1).astype(bool)


def mesh_genome() -> bytes:
    """A 220 kb record with planted -RC pairs and a direct pair, a 6 kb N
    run, then a 60 kb record (two chunks): at k = 8 the first chunk has
    54,997 lanes in a 65,536-lane bucket, so every probe slot of 2 and of
    4 scans some, and the second chunk's lanes all fall to slot 0; at k =
    12, 36,665 lanes, where the planted pairs stand out of the random
    matches."""
    rng = np.random.default_rng(88)
    a = bytearray(random_dna(rng, 220000))
    a[150000:152000] = revcomp(bytes(a[10000:12000]))   # -RC pair
    a[200000:201500] = revcomp(bytes(a[90000:91500]))   # across slots
    a[120000:122000] = bytes(a[30000:32000])            # direct pair
    b = random_dna(rng, 60000)
    return bytes(a) + b"N" * 6000 + b


def dist_genome() -> tuple[bytes, tuple[int, int]]:
    """asgart_tpu/distributed.py's genome (70 kb, seed 77: a direct pair
    inside the trim window, a reverse-complement pair) and its window."""
    rng = np.random.default_rng(77)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = bytearray(rng.choice(acgt, 70000).tobytes())
    g[40000:43000] = g[6000:9000]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    g[55000:57500] = bytes(g[20000:22500]).translate(comp)[::-1]
    return bytes(g), (1000, 65000)
