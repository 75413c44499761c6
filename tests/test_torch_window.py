"""The trim-window fused build against the JAX one: KA's window mode
(plain version) against ``_window_codes`` + the JAX key planes, and the
whole window build (sa, lane windows, lane mask, per-chunk totals) against
JAX ``FusedIndex.build(trim=...)``, at k = 8, 20 and 25, for the four
transforms, with windows at the genome's start, in its middle, at its end,
and across an N run and a fragment boundary, and on the tied vocabulary.
The port's window ``sa`` keeps window positions: it is the JAX ``sa``
minus the window start, every slot. KD over it with the rebased filter
constants (``device_engine.rebased_bases``) against the JAX
``_scan_core`` over the JAX ``sa`` with the fused ones: the same events,
the matches shifted by the window start. Exact (integers; tolerance
0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.device_engine import rebased_bases
from asgart_tpu_torch.fused_index import FusedIndex
from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.kernels import pack_keys, scan_core
from asgart_tpu_torch.kernels.pack_keys import key_words
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import (TRANSFORMS, chunked_genome, fused_key,
                           jax_fused_stages, key_planes, masked_multifasta,
                           prepared, specs_for, vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import revcomp

CPU = torch.device("cpu")

# (genome, window): the chunked genome (60000 bp; N run 12000-18000, N
# probes 30000-30100) and the two-record genome (chr1 24000 bp with an N
# run from 20000, chr2 from 24000 starting with 1500 N)
WINDOWS = {
    "start": ("chunked", (0, 21000)),
    "middle": ("chunked", (19000, 46000)),
    "end": ("chunked", (38000, 60000)),
    "n_run": ("chunked", (9000, 33000)),
    "fragments": ("multifasta", (17000, 39000)),
}


def _repeats_genome() -> bytes:
    """The chunked genome with a 120 bp unit at 2000, 20500, 25000 and
    50000, and its reverse complement at 8000 and 55000: matches of every
    transform inside each KD case's window, beside the planted -RC pair
    (3000 -> 40000)."""
    g = bytearray(chunked_genome())
    unit = bytes(g[20500:20620])
    for p in (2000, 25000, 50000):
        g[p:p + 120] = unit
    for p in (8000, 55000):
        g[p:p + 120] = revcomp(unit)
    return bytes(g)


def _records(genome):
    return {"chunked": lambda: [("chr1", chunked_genome())],
            "repeats": lambda: [("chr1", _repeats_genome())],
            "multifasta": masked_multifasta,
            "vocab": lambda: [("chr1", vocab_genome())]}[genome]()


def _setup(tmp_path, genome, k, reverse, complement):
    _, chunks, strand = prepared(tmp_path, _records(genome))
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    return strand, specs_for(chunks, s)


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("k", [8, 20, 25])
def test_pack_keys_window_equals_jax(tmp_path, k, window):
    """KA window mode: the direct rows are the window text + '$' + zero
    padding (JAX ``_window_codes``), the probe rows the whole genome's."""
    genome, trim = WINDOWS[window]
    strand, specs = _setup(tmp_path, genome, k, True, True)
    ref = jax_fused_stages(strand.data, k, specs, True, True, trim=trim)
    W = ref["W"]
    assert W == trim[1] - trim[0] + 1
    keys, lane_mask = pack_keys(torch.from_numpy(CODE[strand.data]), specs,
                                k, True, True, W, ref["total"], ws=trim[0])
    assert len(keys) == key_words(k)
    if len(keys) == 1:
        assert np.array_equal(keys[0].numpy(),
                              fused_key(ref["ckhi"], ref["cklo"], W))
    else:
        (top, hi, lo), flag = key_planes(keys)
        assert np.array_equal(top, ref["cktop"])
        assert np.array_equal(hi, ref["ckhi"])
        assert np.array_equal(lo, ref["cklo"])
        assert np.array_equal(flag, np.arange(len(flag)) >= W)
    assert np.array_equal(lane_mask.numpy(), ref["lane_mask"])


def test_pack_keys_whole_genome_is_window_zero(tmp_path):
    """The whole genome is the window ws = 0, W = n1: one code path."""
    strand, specs = _setup(tmp_path, "chunked", 20, True, True)
    codes = torch.from_numpy(CODE[strand.data])
    n1 = codes.numel()
    ref = jax_fused_stages(strand.data, 20, specs, True, True)
    (key,), mask = pack_keys(codes, specs, 20, True, True, n1,
                             ref["total"], ws=0)
    assert np.array_equal(key.numpy(),
                          fused_key(ref["ckhi"], ref["cklo"], n1))
    with pytest.raises(ValueError, match="bad ws"):
        pack_keys(codes, specs, 20, True, True, n1, ref["total"], ws=1)


def _builds(strand, specs, k, reverse, complement, trim):
    """(port build, JAX build) of the window ``trim``."""
    from asgart_tpu.device_index import FusedIndex as JaxFusedIndex

    ref = JaxFusedIndex.build(strand.data, k, specs=specs, reverse=reverse,
                              complement=complement, trim=trim)
    got = FusedIndex.build(strand.data, k, specs, reverse, complement, CPU,
                           trim=trim)
    return got, ref


def _assert_build_equal(strand, specs, k, reverse, complement, trim):
    got, ref = _builds(strand, specs, k, reverse, complement, trim)
    assert got.trim == ref.trim == tuple(trim)
    # window positions: the JAX sa less ws in every slot, probe slots too
    assert np.array_equal(got.sa.numpy(), np.asarray(ref.sa) - trim[0])
    assert np.array_equal(got.lane_lo.numpy(), np.asarray(ref.lane_lo))
    assert np.array_equal(got.lane_hi.numpy(), np.asarray(ref.lane_hi))
    assert np.array_equal(got.lane_mask.numpy(), np.asarray(ref.lane_mask))
    assert got.offs == {c: (o, int(t)) for c, (o, t) in ref.offs.items()}
    return got


@pytest.mark.parametrize("k", [8, 20, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_window_build_equals_jax_transforms(tmp_path, reverse, complement,
                                            k):
    """The middle window for every transform: its suffix order holds
    window positions, each of [0, W) once."""
    genome, trim = WINDOWS["middle"]
    strand, specs = _setup(tmp_path, genome, k, reverse, complement)
    got = _assert_build_equal(strand, specs, k, reverse, complement, trim)
    W = trim[1] - trim[0] + 1
    sa = got.sa.numpy()
    direct = np.sort(sa[sa < W])  # probe slots hold W + lane
    assert np.array_equal(direct, np.arange(W))


@pytest.mark.parametrize("window", ["start", "end", "n_run", "fragments"])
@pytest.mark.parametrize("k", [20, 25])
def test_window_build_equals_jax_windows(tmp_path, window, k):
    genome, trim = WINDOWS[window]
    strand, specs = _setup(tmp_path, genome, k, True, True)
    _assert_build_equal(strand, specs, k, True, True, trim)


@pytest.mark.parametrize("k,reverse,complement", [(20, True, True),
                                                  (25, False, False)])
def test_window_build_equals_jax_tied_vocabulary(tmp_path, k, reverse,
                                                 complement):
    """Nearly every position of the window is tied: the subset rounds run
    inside the window text (its own '$' ends every tie)."""
    strand, specs = _setup(tmp_path, "vocab", k, reverse, complement)
    _assert_build_equal(strand, specs, k, reverse, complement,
                        (15000, 60000))


def _jax_window_scan(ref, off, nc, cs, cl, max_card, k, reverse):
    """The JAX ``_scan_core`` of one chunk over the JAX window index (genome
    positions, the fused constants), as its ``FusedEngine`` runs it:
    (events, matches, z_trail)."""
    from asgart_tpu.device_engine import _bucket, _scan_core

    b_pad = _bucket(nc)
    lanes = slice(off, off + b_pad)
    ev, m, sc = _scan_core(
        ref.lane_lo[lanes], ref.lane_hi[lanes], ref.lane_mask[lanes],
        ref.sa, jnp.int32(cs), jnp.int32(cl), jnp.int32((1 << 31) - 1),
        jnp.int32(max_card), jnp.int32(0), k=k, reverse=reverse,
        b_pad=b_pad, cap=1 << 20, ev_cap=b_pad)
    n_events, total_kept, z_trail, overflow = (int(v) for v in
                                               np.asarray(sc))
    assert not overflow
    return (np.asarray(ev)[:, :n_events], np.asarray(m)[:total_kept],
            z_trail)


# (genome, window, k, reverse, complement)
KD_CASES = ([("repeats", WINDOWS["middle"][1], k, r, c)
             for k in (8, 20, 25) for r, c in TRANSFORMS]
            + [("repeats", WINDOWS[w][1], k, True, True)
               for w in ("start", "end") for k in (8, 20, 25)]
            + [("vocab", (15000, 60000), 20, False, False),
               ("vocab", (15000, 60000), 25, False, False)])


@pytest.mark.parametrize("genome,trim,k,reverse,complement", KD_CASES)
def test_window_scan_rebased_equals_jax(tmp_path, genome, trim, k, reverse,
                                        complement):
    """KD (plain version) over the port's window-relative ``sa`` with
    ``rebased_bases`` against the JAX ``_scan_core`` over its genome-position
    ``sa`` with the fused constants, every chunk: events, matches + ws,
    n_events, total_kept and z_trail equal."""
    strand, specs = _setup(tmp_path, genome, k, reverse, complement)
    got, ref = _builds(strand, specs, k, reverse, complement, trim)
    ws, we = trim
    max_card = RunSettings().max_cardinality
    n_events = 0
    for (cs, cl, nc) in specs:
        off = ref.offs[(cs, cl)][0]
        want = _jax_window_scan(ref, off, nc, cs, cl, max_card, k, reverse)
        lanes = slice(off, off + nc)
        res = scan_core(got.lane_lo[lanes], got.lane_hi[lanes],
                        got.lane_mask[lanes], got.sa,
                        *rebased_bases(cs, cl, ws, we - ws + 1), max_card,
                        0, k, reverse)
        ev, m, z_trail = res.to_host()
        assert (res.n_events, res.total_kept) == (want[0].shape[1],
                                                  len(want[1]))
        assert np.array_equal(ev, want[0])
        assert np.array_equal(m.astype(np.int64) + ws, want[1])
        assert z_trail == want[2]
        n_events += res.n_events
    if reverse == complement:
        assert n_events > 0


def test_window_build_refuses_bad_trim(tmp_path):
    strand, specs = _setup(tmp_path, "chunked", 20, True, True)
    n1 = len(strand.data)
    for trim in ((5, 5), (10, 2), (-1, 100), (0, n1)):
        with pytest.raises(ValueError, match="bad trim window"):
            FusedIndex.build(strand.data, 20, specs, True, True, CPU,
                             trim=trim)
