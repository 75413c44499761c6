"""The port's device chain (asgart_tpu_torch/chain.py, KN's plain version
on the CPU) against the JAX ``chain_jax`` programs and the native chains,
exactly (integers; tolerance 0):

- ``chain_events_device`` against the JAX ``chain_events_device`` and
  ``native.chain_events`` on tests/test_chain_jax.py:188's and :233's
  inputs (random settings, multi-burst splits, in-burst quiet runs, tiny
  ``out_cap`` and ``max_arms`` so that both retries run);
- ``chain_device`` against the JAX ``chain_device`` and ``native.chain``
  on :42-75's cases and :266's 280-seed arm overflow;
- matches past 2^31 and an arm longer than 2^24 against
  ``native.chain_events`` alone, where the JAX chain wraps its int32
  positions and rounds ``allow`` in float32 (ROADMAP F13);
- the pinned copy of ``prepare_probe_stream_host`` and the burst split.
"""

import inspect

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu import chain_jax, native
from asgart_tpu.index import CODE, GenomeIndex
from asgart_tpu.pipeline import _pack_probe_kmers, probe_positions
from asgart_tpu_torch import chain
from asgart_tpu_torch.kernels.chain import chain_bursts_plain

from test_native import events_from_stream
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, random_dna, revcomp

CPU = torch.device("cpu")


def _stream(text: bytes, k: int, needle: bytes | None = None):
    """(sa, probe_is, lo, hi, needle_len) of ``needle`` (default: the text
    without its '$') probed against ``text``."""
    idx = GenomeIndex.build(np.frombuffer(text, dtype=np.uint8), k)
    arr = np.frombuffer(needle if needle is not None else text[:-1],
                        dtype=np.uint8)
    is_ = probe_positions(arr, k)
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    lo, hi = idx.lookup(_pack_probe_kmers(codes, is_, k))
    return idx.sa, is_, lo, hi, len(arr)


def _kw(k, max_gap, min_dup, max_card):
    return dict(probe_size=k, step_size=k // 2, max_gap_size=max_gap,
                min_duplication_length=min_dup, max_cardinality=max_card)


def _both_cfgs(kw, **caps):
    return (chain.ChainConfig(**caps, **kw),
            chain_jax.ChainConfig(**caps, **kw))


def _events_case(trial):
    """tests/test_chain_jax.py:188's input for ``trial``."""
    rng = np.random.default_rng(7000 + trial)
    k = int(rng.choice([8, 10, 14]))
    max_gap = int(rng.integers(k + 5, 90))
    min_dup = int(rng.integers(60, 300))
    max_card = int(rng.integers(5, 60))
    n = int(rng.integers(3000, 9000))
    g = bytearray(random_dna(rng, n, b"ACGT" if trial % 2 else b"ACG"))
    for _ in range(int(rng.integers(1, 6))):
        L = int(rng.integers(100, 500))
        src = int(rng.integers(0, n - 2 * L - 10))
        dst = int(rng.integers(src + L, n - L))
        g[dst:dst + L] = bytes(g[src:src + L])
    sa, is_, lo, hi, nl = _stream(bytes(g) + b"$", k)
    ev = events_from_stream(sa, is_, lo, hi, needle_offset=0,
                            needle_len=nl, reverse=False,
                            max_cardinality=max_card)
    return ev, _kw(k, max_gap, min_dup, max_card)


def _native_events(ev, kw, m_offset=0):
    pe, zb, offs, flat, z_trail = ev
    return native.chain_events(pe, zb, offs, np.asarray(flat, np.int64)
                               + m_offset, z_trail=z_trail, **kw)


@pytest.mark.parametrize("trial", range(8))
def test_chain_events_device_equals_jax_and_native(trial):
    """:188's cases: every burst split, in-burst quiet run and trailing
    drop as the native event chain; the JAX burst chain on half of them
    (its CPU compile is the slow part)."""
    ev, kw = _events_case(trial)
    want = _native_events(ev, kw)
    port_cfg, jax_cfg = _both_cfgs(kw, max_arms=256, max_matches=64,
                                   out_cap=256)
    got = chain.chain_events_device(port_cfg, *ev, device=CPU)
    assert got == want
    if trial % 2 == 0:
        assert chain_jax.chain_events_device(jax_cfg, *ev) == want


def _repeat_case():
    """:233's input: one source copied ten times (arm and output
    pressure)."""
    rng = np.random.default_rng(41)
    g = bytearray(random_dna(rng, 12000, b"ACGT"))
    for i in range(10):
        g[3000 + i * 400:3000 + i * 400 + 150] = bytes(g[200:350])
    sa, is_, lo, hi, nl = _stream(bytes(g) + b"$", 10)
    ev = events_from_stream(sa, is_, lo, hi, needle_offset=0,
                            needle_len=nl, reverse=False, max_cardinality=80)
    return ev, _kw(10, 30, 100, 80)


def test_capacity_retries_equal_jax_and_native():
    """:233's case with one arm slot and one output row: both retries run
    (KN's plain version reports the arm overflow and the row count) and
    the result is the native's and the JAX chain's."""
    ev, kw = _repeat_case()
    want = _native_events(ev, kw)
    assert sum(len(f) for f in want) > 4
    port_cfg, jax_cfg = _both_cfgs(kw, max_arms=2, max_matches=96,
                                   out_cap=1)
    assert chain.chain_events_device(port_cfg, *ev, device=CPU) == want
    assert chain_jax.chain_events_device(jax_cfg, *ev) == want
    events = chain.upload_events(*ev, 0, CPU)
    rows, stats = chain.chain_rows(events, port_cfg)
    big, stats_big = chain.chain_rows(events, chain.ChainConfig(**kw))
    assert torch.equal(rows, big)
    assert stats.passes > 3 and stats_big.passes == 1
    assert stats.tests == stats_big.tests > 0
    assert stats.bursts == stats_big.bursts >= 2


def test_plain_pass_reports_overflow():
    """One pass of KN's plain version at one arm: every burst that spawns
    two arms reports status 1; the row count goes past ``out_cap``."""
    ev, kw = _repeat_case()
    events = chain.upload_events(*ev, 0, CPU)
    cfg = chain.ChainConfig(**kw)
    t = chain.burst_threshold(cfg)
    bs, order = chain.bursts_from_events(events, t)
    args = (events.ev_i, events.ev_z, events.m_off, events.m, 0, bs, order,
            events.z_trail, t, 10, 5, 30, 100)
    rows, n_rows, status, tests = chain_bursts_plain(*args, 1, 1)
    assert int(status.sum()) > 0
    full = chain_bursts_plain(*args, 4096, 4096)
    assert int(full[2].sum()) == 0
    assert int(full[1]) > 1 and int(n_rows) <= int(full[1])
    assert int(full[3].sum()) > 0


def test_bursts_from_events():
    """A burst starts at the first event and after t_split or more quiet
    probes; the order is longest first, ties in burst order."""
    z = torch.tensor([5, 0, 3, 4, 0, 0, 9, 4], dtype=torch.int32)
    ev = chain.Events(torch.arange(8, dtype=torch.int32), z,
                      torch.arange(9, dtype=torch.int64),
                      torch.arange(8, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32))
    bs, order = chain.bursts_from_events(ev, 4)
    assert bs.tolist() == [0, 3, 6, 7, 8]
    assert order.tolist() == [0, 1, 2, 3]
    bs, order = chain.bursts_from_events(ev, 5)
    assert bs.tolist() == [0, 6, 8]
    assert order.tolist() == [0, 1]
    assert chain.burst_threshold(chain.ChainConfig(20, 10, 120, 1000,
                                                   500)) == 12
    assert chain.burst_threshold(chain.ChainConfig(20, 10, 0, 1000,
                                                   500)) == 1


def _chain_device_case(text, needle, k, max_gap, min_dup, max_card,
                       reverse, **caps):
    sa, is_, lo, hi, nl = _stream(text, k, needle)
    kw = _kw(k, max_gap, min_dup, max_card)
    want = native.chain(sa, is_, lo, hi, needle_offset=0, needle_len=nl,
                        reverse=reverse, **kw)
    port_cfg, jax_cfg = _both_cfgs(kw, **caps)
    args = dict(needle_offset=0, needle_len=nl, reverse=reverse)
    got = chain.chain_device(port_cfg, sa, is_, lo, hi, device=CPU, **args)
    assert got == want
    assert chain_jax.chain_device(jax_cfg, sa, is_, lo, hi, **args) == want
    return want


@pytest.mark.parametrize("seed", range(4))
def test_chain_device_direct(seed):
    """:42's random texts."""
    rng = np.random.default_rng(seed)
    text = random_dna(rng, 2500, b"ACGT" if seed % 2 else b"ACG") + b"$"
    _chain_device_case(text, None, 10, 30, 100, 50, False, max_arms=256,
                       max_matches=64, out_cap=1024)


def test_chain_device_planted_and_reverse():
    """:52's planted duplication (default settings) and :61's reverse
    complement."""
    rng = np.random.default_rng(77)
    text = plant_duplication(rng, 8000, 1500, 1000, 5000, noise=0.01) + b"$"
    assert _chain_device_case(text, None, 20, 120, 1000, 500, False,
                              max_arms=256, max_matches=512, out_cap=1024)
    rng = np.random.default_rng(5)
    text = plant_duplication(rng, 4000, 600, 500, 2500,
                             transform=revcomp) + b"$"
    needle = text[:-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]
    assert _chain_device_case(text, needle, 10, 40, 300, 50, True,
                              max_arms=256, max_matches=64, out_cap=1024)


def test_chain_device_arm_overflow():
    """:266: 280 identical seeds in one probe's matches pass 256 arm slots;
    the burst reruns with 512 and equals the native chain."""
    rng = np.random.default_rng(9)
    k, seed = 10, b"ACGTACGGTA"
    g = bytearray()
    for _ in range(280):
        g += seed + random_dna(rng, 40, b"ACGT")
    text = bytes(g) + b"$"
    assert _chain_device_case(text, None, k, 60, 300, 500, False,
                              max_arms=256, max_matches=512, out_cap=4096)


def test_matches_past_2_31_equal_native():
    """Matches shifted past 2^31 in int64 (as KN adds a window start): the
    native chain's families, with int32 matches and the offset, and with
    int64 matches (the JAX grid would wrap them)."""
    for trial in (2, 5):
        ev, kw = _events_case(trial)
        for off in (2**31 + 12345, 3 * 2**31 - 7):
            want = _native_events(ev, kw, off)
            assert want and max(r for f in want for _, r, _, _ in f) >= 2**31
            cfg = chain.ChainConfig(**kw)
            pe, zb, offs, flat, z_trail = ev
            assert chain.chain_events_device(
                cfg, pe, zb, offs, np.asarray(flat, np.int32), z_trail,
                m_offset=off, device=CPU) == want
            assert chain.chain_events_device(
                cfg, pe, zb, offs, np.asarray(flat, np.int64) + off,
                z_trail, device=CPU) == want


def test_allow_in_double_at_2_24():
    """An arm 16,777,219 bases long: ``allow`` is 1,677,721 in double (the
    native chain) and 1,677,722 in float32 (the JAX chain). A match at
    distance 1,677,721 spawns a new arm, as in the native chain."""
    k, ps = 20, 20
    l_len = 16_777_219
    assert int(0.1 * float(l_len)) == 1_677_721
    assert int(np.float32(0.1) * np.float32(l_len)) == 1_677_722
    re = 1000 + 2 * ps  # the arm's right end after the second event
    pe = np.array([0, l_len - ps, l_len], dtype=np.int64)
    zb = np.zeros(3, dtype=np.int64)
    m = np.array([1000, 1000 + ps, re + 1_677_721], dtype=np.int64)
    offs = np.arange(4, dtype=np.int64)
    kw = _kw(k, 120, 1, 500)
    want = native.chain_events(pe, zb, offs, m, z_trail=100, **kw)
    assert want == [[(0, 1000, l_len, 2 * ps),
                     (l_len, re + 1_677_721, ps, ps)]]
    got = chain.chain_events_device(chain.ChainConfig(**kw), pe, zb, offs,
                                    m, 100, device=CPU)
    assert got == want
    # one base nearer, both chains extend
    m[2] -= 1
    want = native.chain_events(pe, zb, offs, m, z_trail=100, **kw)
    assert len(want[0]) == 1
    assert chain.chain_events_device(chain.ChainConfig(**kw), pe, zb, offs,
                                     m, 100, device=CPU) == want


def test_prepare_probe_stream_copy_equals_original():
    """The pinned copy: the same source line for line and the same
    output."""
    assert inspect.getsource(chain.prepare_probe_stream_host) == \
        inspect.getsource(chain_jax.prepare_probe_stream_host)
    rng = np.random.default_rng(3)
    text = random_dna(rng, 3000, b"ACG") + b"$"
    sa, is_, lo, hi, nl = _stream(text, 10)
    for reverse in (False, True):
        args = dict(needle_offset=0, needle_len=nl, reverse=reverse,
                    max_cardinality=20, max_matches=64)
        for a, b in zip(chain.prepare_probe_stream_host(sa, is_, lo, hi,
                                                        **args),
                        chain_jax.prepare_probe_stream_host(sa, is_, lo, hi,
                                                            **args)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
