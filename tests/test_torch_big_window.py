"""The merge-join engine's kernels against the JAX big-window engine's: KD's
plain version with rebased constants against ``_scan_core_based``, KI's
plain version against ``_unpack_codes`` and the host pack against
``pack_codes_host``, KA's probe-only mode with KH against ``_needle_ranges``
over needle codes made by ``_needle_batch_device`` and
``decimate_codes_auto``, and the window-relative index against the JAX
``BigWindowEngine``'s arrays. Exact (integers; tolerance 0). The fused
engine's constants (``fused_bases``) are pinned against ``_scan_core`` by
tests/test_torch_scan_core.py."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu import device_engine as de
from asgart_tpu import device_index as di
from asgart_tpu_torch import codes as codes_mod
from asgart_tpu_torch.codes import pack_codes, upload_codes
from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import mj_ranges, pack_keys, unpack_codes
from asgart_tpu_torch.kernels.scan_core import fused_bases, scan_core_plain
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.window_index import DeviceWindowIndex

from torch_jax_ref import (TRANSFORMS, chunked_genome, jax_settings,
                           prepared)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import revcomp

CPU = torch.device("cpu")


def _genome() -> bytes:
    """The chunked genome (chunks (0, 12000) and (18000, 42000), N probes
    at 30000, a planted -RC pair 3000 -> 40000) with a 60 bp unit copied
    four more times in each chunk, so lanes of its copies keep four
    matches or more, and a 300 bp -RC copy inside the first chunk."""
    g = bytearray(chunked_genome())
    for src, dsts in ((500, (2000, 4000, 6000, 8000)),
                      (20500, (22000, 24000, 26000, 28000))):
        for p in dsts:
            g[p:p + 60] = g[src:src + 60]
    g[9000:9300] = revcomp(bytes(g[600:900]))
    return bytes(g)


def _jax_engine(strand, s, trim):
    return de.BigWindowEngine(strand, jax_settings(s), trim)


def _port_key(hi, lo) -> np.ndarray:
    return (np.asarray(hi).astype(np.int64) << 31) \
        | (np.asarray(lo).astype(np.int64) << 1)


def _t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


# (reverse, trim, max_cardinality): windows at 0 (the second chunk lies
# past it: constants clamped at their upper bounds) and inside the genome
# (the first chunk lies before it: clamped at their lower bounds); max_card
# 2 drops the repeat's lanes
@pytest.mark.parametrize("reverse,trim,max_card", [
    (False, (0, 10000), 500),
    (False, (19000, 46000), 2),
    (True, (0, 10000), 2),
    (True, (19000, 46000), 500),
])
def test_scan_core_rebased_equals_jax(tmp_path, reverse, trim, max_card):
    _, chunks, strand = prepared(tmp_path, [("chr1", _genome())])
    s = RunSettings(reverse=reverse, complement=reverse,
                    max_cardinality=max_card)
    eng = _jax_engine(strand, s, trim)
    W, k = eng.W, s.probe_size
    clamped = set()
    n_events = 0
    for (cs, cl, nc) in chunk_specs(chunks, s):
        bases = rebased_bases(cs, cl, trim[0], W)
        assert bases == eng._rebased((cs, cl))
        clamped |= {"upper" if b < f - trim[0] else "lower"
                    for b, f in zip(bases, fused_bases(cs, cl))
                    if b != f - trim[0]}
        lo, hi, mask, _ = eng._stage1_for((cs, cl))
        b_pad = lo.shape[0]
        ev, m, sc = de._scan_core_based(
            lo, hi, mask, eng.sa, jnp.int32(cl), *(jnp.int32(b)
                                                   for b in bases),
            jnp.int32(W + 1), jnp.int32(max_card), jnp.int32(0), k=k,
            reverse=reverse, b_pad=b_pad, cap=1 << 16, ev_cap=b_pad)
        ne, nk, z_trail, overflow = (int(v) for v in np.asarray(sc))
        assert not overflow
        got = scan_core_plain(
            _t(np.asarray(lo)[:nc], torch.int32),
            _t(np.asarray(hi)[:nc], torch.int32),
            _t(np.asarray(mask)[:nc], torch.bool),
            _t(eng.sa, torch.int32), *bases, max_card, 0, k,
            reverse).to_host()
        assert np.array_equal(got[0], np.asarray(ev)[:, :ne])
        assert np.array_equal(got[1], np.asarray(m)[:nk])
        assert got[2] == z_trail
        n_events += ne
    assert n_events > 0
    assert clamped == ({"upper"} if trim[0] == 0 else {"lower"})


def test_relative_scan_is_the_global_scan(tmp_path):
    """KD over a window-relative suffix order with the rebased constants,
    its matches shifted by the window start, equals KD over the same
    order in genome positions with the fused constants."""
    from asgart_tpu_torch.device_engine import DeviceWindowEngine

    _, chunks, strand = prepared(tmp_path, [("chr1", _genome())])
    ws, we = 19000, 46000
    for rc in (False, True):
        s = RunSettings(reverse=rc, complement=rc, max_cardinality=3)
        eng = DeviceWindowEngine(strand, s, CPU, (ws, we), cache=None)
        r = eng.stage1(chunks)
        rel = eng.index.sa
        assert eng.m_offset == ws
        for (cs, cl, nc) in r.specs:
            lanes = slice(r.offs[(cs, cl)][0], r.offs[(cs, cl)][0] + nc)
            args = (r.lane_lo[lanes], r.lane_hi[lanes], r.lane_mask[lanes])
            tail = (s.max_cardinality, 0, s.probe_size, rc)
            want = scan_core_plain(*args, rel + ws, *fused_bases(cs, cl),
                                   *tail).to_host()
            got = scan_core_plain(*args, rel, *rebased_bases(
                cs, cl, ws, we - ws + 1), *tail).to_host()
            assert np.array_equal(got[0], want[0]) and got[2] == want[2]
            assert np.array_equal(got[1].astype(np.int64) + ws, want[1])


def _strand(n: int, seed: int, exc: bytes = b"", rate: float = 0.0):
    rng = np.random.default_rng(seed)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    if exc:
        hit = rng.random(n) < rate
        g[hit] = np.frombuffer(exc, np.uint8)[rng.integers(0, len(exc),
                                                          hit.sum())]
    g[-1] = ord("$") if exc else g[-1]
    return g


@pytest.mark.parametrize("n,exc,rate", [
    (40001, b"N", 0.002),            # $ and N; n1 % 4 == 1
    (40002, b"NRYKMSWBDHV", 0.004),  # IUPAC bytes; n1 % 4 == 2
    (40003, b"", 0.0),               # no exception at all; n1 % 4 == 3
    (40000, b"N", 0.001),            # n1 % 4 == 0
    (6, b"N", 0.3),                  # below the 64-byte floor
])
def test_unpack_codes_equals_jax(n, exc, rate):
    g = _strand(n, n, exc, rate)
    mine, ref = pack_codes(g), di.pack_codes_host(g)
    assert mine is not None and ref is not None
    for a, b in zip(mine, ref[:3]):
        assert np.array_equal(a, b)
    assert mine[1].dtype == np.int64 and mine[2].dtype == np.uint8
    assert (mine[1].size > 0) == bool(exc)
    want = np.asarray(di._unpack_codes(*(jnp.asarray(a) for a in ref[:3]),
                                       n))
    got = unpack_codes(*(torch.from_numpy(a) for a in mine), n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, CODE[g])
    assert np.array_equal(upload_codes(g, CPU).numpy(), CODE[g])


def test_pack_declines_dense_strands_as_jax():
    """Both packs decline the same strands: 5 bytes per exception above
    max(n1 // 8, 64) takes the plain 1 B/bp upload, which
    ``upload_codes`` then makes."""
    for n, rate, packs in ((4000, 0.01, True), (4000, 0.2, False),
                           (200, 0.05, True), (200, 0.3, False)):
        g = _strand(n, 7, b"N", rate)
        assert (pack_codes(g) is not None) == packs
        assert (di.pack_codes_host(g) is not None) == packs
        assert np.array_equal(upload_codes(g, CPU).numpy(), CODE[g])


@pytest.mark.parametrize("where", ["start", "end"])
def test_dense_strand_is_declined_before_packing(monkeypatch, where):
    """A gapped strand (5% N in one long run, as in an assembly with
    GRCh38's gap share) is declined by the exception count alone: no 2-bit
    plane is packed, and the upload is the plain ``CODE`` copy. With the
    run at the start the count stops there."""
    g = _strand(1 << 16, 5)
    run = slice(0, 1 << 12) if where == "start" else slice(-(1 << 12), None)
    g[run] = ord("N")
    monkeypatch.setattr(codes_mod, "pack_planes", None)  # never reached
    assert codes_mod.exception_positions(g) is None
    assert pack_codes(g) is None and di.pack_codes_host(g) is None
    assert np.array_equal(upload_codes(g, CPU).numpy(), CODE[g])
    blocks = []
    monkeypatch.setattr(codes_mod, "_BLOCK", 1 << 10)
    monkeypatch.setattr(codes_mod.np, "flatnonzero",
                        lambda e: blocks.append(1) or np.nonzero(e)[0])
    assert codes_mod.exception_positions(g) is None
    assert len(blocks) == (2 if where == "start" else 62)


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_probe_only_join_equals_needle_ranges(tmp_path, reverse, complement,
                                              k):
    """KA's probe-only mode reads each chunk's transformed probes from the
    strand's codes (``_probe_x0``'s layout); with KH they give the JAX
    big-window engine's stage 1: ``_needle_ranges`` over the chunk's
    needle codes (``_needle_batch_device``, then ``decimate_codes_auto``),
    whose lane j reads needle[(j + 1) * step ..]."""
    _, chunks, strand = prepared(tmp_path, [("chr1", _genome())])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    trim = (19000, 46000)
    eng = _jax_engine(strand, s, trim)
    specs = chunk_specs(chunks, s)
    lane_off = [0]
    for (_, _, nc) in specs:
        lane_off.append(lane_off[-1] + nc)
    (pkey,), mask = pack_keys(torch.from_numpy(CODE[strand.data]), specs,
                              k, reverse, complement, 0, lane_off[-1])
    lo, hi, totals = mj_ranges(torch.from_numpy(_port_key(eng.key_hi,
                                                          eng.key_lo)),
                               pkey, mask, lane_off)
    codes1 = jnp.asarray(CODE[strand.data])
    step = k // 2
    for c, (cs, cl, nc) in enumerate(specs):
        b_pad = de._bucket(nc)
        off = (b_pad + 7) * step
        buf = de._needle_batch_device(
            codes1, jnp.asarray([cs], jnp.int32), jnp.asarray([cl], jnp.int32),
            jnp.asarray([0], jnp.int32), off, (cl + 7) & ~7, reverse,
            complement)
        needle = di.decimate_codes_auto(buf, step, off, off)
        w_lo, w_hi, w_mask, w_tot = (np.asarray(a) for a in de._needle_ranges(
            eng.key_hi, eng.key_lo, needle, jnp.int32(cl), jnp.int32(0), k=k,
            b_pad=b_pad))
        lanes = slice(lane_off[c], lane_off[c + 1])
        assert np.array_equal(mask[lanes].numpy(), w_mask[:nc])
        assert not w_mask[nc:].any()
        assert np.array_equal(lo[lanes].numpy(), w_lo[:nc])
        assert np.array_equal(hi[lanes].numpy(), w_hi[:nc])
        assert int(totals[c]) == int(w_tot)
    if reverse == complement:  # the repeats and the planted -RC pair
        assert int(totals.sum()) > 0


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("trim", [(0, 21000), (38000, 60000)])
def test_relative_index_equals_jax(tmp_path, trim, k):
    """``DeviceWindowIndex.build`` keeps the JAX ``BigWindowEngine``'s
    window-relative arrays (``window_arrays_from_codes`` over
    ``_window_codes``): no KG."""
    _, _, strand = prepared(tmp_path, [("chr1", _genome())])
    s = RunSettings(reverse=True, complement=True, probe_size=k)
    eng = _jax_engine(strand, s, trim)
    W = trim[1] - trim[0] + 1
    win = di._window_codes(jnp.asarray(CODE[strand.data]),
                           jnp.int32(trim[0]), W - 1, k)
    ref_hi, ref_lo, _, ref_sa = di.window_arrays_from_codes(win, k, W)
    assert np.array_equal(np.asarray(ref_sa), np.asarray(eng.sa))
    got = DeviceWindowIndex.build(strand.data, k, trim, True, True, CPU)
    assert got.W == eng.W == W
    assert np.array_equal(got.key.numpy(), _port_key(ref_hi, ref_lo))
    assert np.array_equal(got.key.numpy(), _port_key(eng.key_hi, eng.key_lo))
    assert np.array_equal(got.sa.numpy(), np.asarray(eng.sa))
    assert np.array_equal(np.sort(got.sa.numpy()), np.arange(W))
