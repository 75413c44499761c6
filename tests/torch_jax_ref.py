"""JAX-side references for the asgart_tpu_torch tests: the stages of the
JAX fused build (asgart_tpu/device_index.py:1605-1787), run step by step
on the CPU exactly as ``FusedIndex.build`` runs them, with every
intermediate copied out as numpy; plus shared genome fixtures."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from asgart_tpu.exporters import JSONExporter
from asgart_tpu.fasta import prepare_data
from asgart_tpu.structs import RunSettings

from util import plant_duplication, random_dna, revcomp, write_fasta

TRANSFORMS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch operations on one intra-op thread (import
    this fixture into the module). With one thread per core, torch's
    OpenMP workers spin between operations and starve the XLA CPU
    collectives of the JAX tests that other pytest-xdist workers run at
    the same time on the virtual 8-device mesh; those abort the process
    when a collective waits too long."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def json_text(result) -> str:
    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


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


def vocab_genome(seed: int = 34, tiles: int = 1500) -> bytes:
    """Tiled vocabulary: nearly every k-mer recurs, so the tied set is
    most of the genome (tests/test_fused.py:100's input, shortened)."""
    rng = np.random.default_rng(seed)
    vocab = [random_dna(rng, 50) for _ in range(300)]
    picks = rng.integers(0, len(vocab), tiles)
    return b"".join(vocab[t] for t in picks)


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
    eng.settings = settings
    eng.mesh = None
    return eng._specs_for([tuple(c) for c in chunks])


def jax_fused_stages(strand_data: np.ndarray, k: int, specs: tuple,
                     reverse: bool, complement: bool) -> dict:
    """Every intermediate of the JAX fused build, as numpy (with the
    third key plane, ``cktop``/``sktop``, for k = 21..30)."""
    import jax.numpy as jnp

    from asgart_tpu import device_engine as de
    from asgart_tpu import device_index as di
    from asgart_tpu.index import CODE

    n1 = int(len(strand_data))
    W = n1
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
    text_codes = di._build_text_codes(codes1, k, False, False, W)
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
