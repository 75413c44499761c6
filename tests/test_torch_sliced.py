"""Sliced dispatch of repeat-heavy chunks in the port, on the CPU (the
kernels' plain versions):

- KO ``granule_totals`` against the JAX ``_range_granule_totals`` on
  seeded lanes, and KM + KO against ``_raw_total_granules`` over a JAX
  ``DeviceIndex``'s tables (whose float32 sums are exact here: every sum
  stays under 2^24); KP ``gather_flat`` against ``_gather_flat``;
- a sliced scan (``device_engine.scan_lanes`` at a budget) against one
  unsliced ``scan_core_plain`` on the same lanes: the merged buffer
  (``merge_slices``, KP) and the host merge (``host_events``) at budgets
  that give every granule its own slice, that leave slices with no event,
  and below a single granule's total;
- the port's counterparts of the JAX tests of sliced dispatch
  (tests/test_device_engine.py:376, whole genome, direct and -RC;
  tests/test_device_window.py:400, a trim window on the merge-join engine;
  :422, the route past 2^31), with their budgets and seeds, each run on
  the host chain, with ``ASGART_DEVICE_CHAIN=1`` and journaled: JSON
  byte-equal to the port's host engine and to the JAX ``engine="tpu"``
  run, and slicing seen to run. The port's granule is lowered from 4096 to
  64 lanes there, so that these 4,000-lane chunks split into many slices
  (at 4096 each would be one).

Tolerance 0 throughout (integers)."""

import itertools
import os

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import device_engine, native, pipeline
from asgart_tpu_torch.convert import table_index_from_numpy
from asgart_tpu_torch.device_engine import (Sliced, chunk_specs,
                                            host_events, merge_slices,
                                            merged_index, scan_lanes)
from asgart_tpu_torch.host_helpers import SLICE_GRAN
from asgart_tpu_torch.kernels import table_ranges
from asgart_tpu_torch.kernels.scan_core import scan_core_plain
from asgart_tpu_torch.kernels.slices import (gather_flat_plain,
                                             granule_totals_plain)
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.window_index import WindowRanges

from torch_jax_ref import (TRANSFORMS, chunked_genome, granule_lanes,
                           jax_settings, json_text, prepared,
                           satellite_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import write_fasta

CPU = torch.device("cpu")
T = torch.from_numpy


@pytest.mark.parametrize("seed,n_lanes,n_gran", [(1, 4096, 4), (2, 3000, 16),
                                                 (3, 1, 8), (4, 0, 2)])
def test_granule_totals_equal_jax_range_granule_totals(seed, n_lanes,
                                                       n_gran):
    """KO's plain version on stage-1 ranges (masked lanes zero, the live
    lanes re-masked by ``n_lanes``) against ``_range_granule_totals``."""
    from asgart_tpu import device_engine as de

    rng = np.random.default_rng(seed)
    b = 4096
    lo = rng.integers(0, 1 << 20, b).astype(np.int32)
    hi = (lo + rng.integers(0, 400, b)).astype(np.int32)
    dead = rng.random(b) < 0.2
    lo[dead], hi[dead] = 0, 0
    want = np.asarray(de._range_granule_totals(
        jnp.asarray(lo), jnp.asarray(hi), jnp.int32(n_lanes), n_gran))
    live = torch.arange(b) < n_lanes
    got = granule_totals_plain(T(lo), T(hi), live, b // n_gran)
    assert got.dtype == torch.int64
    assert got.tolist() == want.astype(np.int64).tolist()
    # the partial granule: only the live prefix, ceil(n / gran) granules
    gran = b // n_gran
    part = granule_totals_plain(T(lo[:n_lanes]), T(hi[:n_lanes]),
                                live[:n_lanes], gran)
    assert part.tolist() == want[:-(-n_lanes // gran)].astype(
        np.int64).tolist()


@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_table_lanes_granules_equal_jax_raw_total_granules(
        tmp_path, reverse, complement):
    """KM's lanes and KO's plain version over the tables of a JAX
    ``DeviceIndex`` (carried across by ``convert.table_index_from_numpy``)
    against ``_raw_total_granules`` on the same tables, per chunk, at 16
    and 512 granules a chunk: the JAX sums also count the windows of N
    probes, which KM masks out."""
    from asgart_tpu import device_engine as de
    from asgart_tpu.device_index import DeviceIndex as JaxDeviceIndex

    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    k = 20
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    ref = JaxDeviceIndex.build(strand.data, k, reverse=reverse,
                               complement=complement)
    idx = table_index_from_numpy(
        np.asarray(ref.sa), np.asarray(ref.pos_lo), np.asarray(ref.pos_hi),
        ref.k, ref.n, ref.first_len, reverse, complement, CPU)
    specs = chunk_specs(chunks, s)
    n1, step = len(strand.data), k // 2
    lane_lo, lane_hi, mask, _, lane_off = table_ranges(
        idx.pos_lo, idx.pos_hi, specs, n1, k, reverse, complement)
    n_flagged = 0
    for n_gran, (c, (cs, cl, nc)) in itertools.product(
            (16, 512), enumerate(specs)):
        b_pad = de._bucket(nc)
        gran = b_pad // n_gran
        want = np.asarray(de._raw_total_granules(
            ref.pos_lo, ref.pos_hi, jnp.int32(cs), jnp.int32(cl),
            jnp.int32(n1), k, reverse, complement, b_pad, n_gran))
        lanes = slice(lane_off[c], lane_off[c + 1])
        got = granule_totals_plain(lane_lo[lanes], lane_hi[lanes],
                                   mask[lanes], gran).numpy()
        # the N probes' windows, which the JAX sums keep
        x0 = de._probe_x0(jnp.int32(cs), jnp.int32(cl), n1, k, reverse,
                          complement)
        lo_raw = np.asarray(de._dec_read(ref.pos_lo, x0, b_pad, step))
        hi = np.asarray(de._dec_read(ref.pos_hi, x0, b_pad, step))
        j = np.arange(b_pad)
        n_lane = (j * step < cl - k - step) & (lo_raw < 0)
        n_flagged += int(n_lane.sum())
        n_win = np.where(n_lane, hi - (lo_raw & 0x7FFFFFFF), 0)
        n_win = n_win.reshape(n_gran, gran).sum(1)
        assert want.max() < 2**24  # float32 is exact here
        g = len(got)
        assert g == -(-nc // gran)
        assert (got + n_win[:g]).tolist() == want[:g].astype(
            np.int64).tolist()
        assert not want[g:].any()
    assert n_flagged > 0  # the genome's in-chunk N probes


@pytest.mark.parametrize("pieces", [1, 3])
def test_gather_flat_equals_jax(pieces):
    """KP's plain version against ``_gather_flat`` on a stacked
    [G, 3, ev_cap] buffer and a padded index array, as
    ``_packed_group_download`` calls it; the port's source split into
    ``pieces`` tensors read as one."""
    from asgart_tpu import device_engine as de

    rng = np.random.default_rng(5 + pieces)
    arr = rng.integers(-2**31, 2**31, (4, 3, 257), dtype=np.int64
                       ).astype(np.int32)
    idx = np.zeros(1024, np.int64)
    idx[:700] = rng.integers(0, arr.size, 700)
    want = np.asarray(de._gather_flat(jnp.asarray(arr), jnp.asarray(idx)))
    flat = arr.reshape(-1)
    cuts = np.sort(rng.choice(np.arange(1, flat.size), pieces - 1,
                              replace=False))
    srcs = [T(p) for p in np.split(flat, cuts)]
    got = gather_flat_plain(srcs, T(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_src,cap", [(1, 8), (2, 8), (5, 8), (8, 8),
                                       (9, 64), (64, 64), (65, 1024),
                                       (1024, 1024), (1025, 0)])
def test_gather_flat_source_table_form(monkeypatch, n_src, cap):
    """KP's form, chosen from the source count alone: up to 1024 sources
    the host table of pointers and offsets goes to the launch by value (no
    tensor made), past it the table goes to the device (cap 0). The
    wrapper's arguments, with the inputs reported as GPU tensors and the
    library faked."""
    import ctypes

    from asgart_tpu_torch.kernels import _build, slices

    calls = []

    class Lib:
        @staticmethod
        def asgart_gather_flat(table, S, *args):
            words = (ctypes.c_int64 * (2 * S + 1)).from_address(table)
            calls.append((list(words), S, *args))
            return 0

    made = []
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    real = torch.frombuffer
    monkeypatch.setattr(torch, "frombuffer",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    srcs = [torch.zeros(s % 3, dtype=torch.int32) for s in range(n_src)]
    idx = torch.zeros(7, dtype=torch.int64)
    before = slices.gather_flat.launches
    out = slices.gather_flat(srcs, idx)
    assert slices.kp_capacity(n_src) == cap
    assert out.shape == (7,) and out.dtype == torch.int32
    assert slices.gather_flat.launches == before + 1
    (words, S, got_cap, idx_p, n, out_p, stream), = calls
    assert (S, got_cap, idx_p, n, out_p) == (n_src, cap, idx.data_ptr(), 7,
                                             out.data_ptr())
    off = np.concatenate([[0], np.cumsum([t.numel() for t in srcs])])
    assert words == [t.data_ptr() for t in srcs] + off.tolist()
    assert len(made) == (cap == 0)


KINDS = ["event", "quiet", "quiet", "event", "over", "event", "quiet",
         "event", "event"]


def _sliced(lo, hi, mask, sa, budget, monkeypatch, max_card=8, k=20):
    """``scan_lanes`` over one chunk of the lanes at ``budget``: (its
    result, the slice plan or None)."""
    n = lo.numel()
    total = int(torch.where(mask, hi.long() - lo.long(), 0).sum())
    chunk = (1000, 2 * n * (k // 2))
    lanes = WindowRanges(lane_lo=lo, lane_hi=hi, lane_mask=mask,
                         specs=((*chunk, n),), offs={chunk: (0, total)})
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", str(budget))
    s = RunSettings(probe_size=k, max_cardinality=max_card)
    (res,) = scan_lanes(s, lanes, sa, [chunk], lambda cs, cl: (0, 0, 0))
    return res, (res.plan if isinstance(res, Sliced) else None)


@pytest.mark.parametrize("case", ["each_granule", "quiet_slices",
                                  "below_granule", "unsliced"])
def test_sliced_scan_equals_unsliced(case, monkeypatch):
    """The slices' merged buffer (KP) and their host merge equal one
    unsliced scan of the same lanes, bit for bit, at four budgets: 0
    (every granule its own slice), the largest granule's total (a quiet
    granule's, so slices with no event, and event granules packed
    together), below it (a granule alone past the budget) and the default
    (not sliced)."""
    rng = np.random.default_rng(17)
    n = len(KINDS) * SLICE_GRAN - 321
    lo, hi, mask, sa = (T(a) for a in granule_lanes(rng, KINDS, n,
                                                    SLICE_GRAN))
    gt = granule_totals_plain(lo, hi, mask).tolist()
    assert min(gt) > 0
    budget = {"each_granule": 0, "quiet_slices": max(gt),
              "below_granule": max(gt) - 1, "unsliced": 1 << 26}[case]
    want = scan_core_plain(lo, hi, mask, sa, 0, 0, 0, 8, 0, 20, False)
    assert want.n_events > 0
    before = scan_lanes.sliced
    res, plan = _sliced(lo, hi, mask, sa, budget, monkeypatch)
    if case == "unsliced":
        assert scan_lanes.sliced == before and plan is None
        assert torch.equal(res.flat, want.flat)
        return
    assert scan_lanes.sliced == before + 1 and isinstance(res, Sliced)
    assert [(a, b) for a, b, _ in plan] == [
        (a, min(b, n - a)) for a, b, _ in plan]
    assert sum(b for _, b, _ in plan) == n
    parts = list(res)
    assert len(parts) == len(plan)
    if case == "each_granule":
        assert len(plan) == len(gt)
    elif case == "quiet_slices":
        assert any(p.n_events == 0 for p in parts)
        assert any(b > SLICE_GRAN for _, b, _ in plan)
    else:
        assert any(t > budget for _, _, t in plan)
    idx = merged_index(parts)
    assert idx.numel() == want.flat.numel()
    merged = merge_slices(parts)
    assert (merged.n_events, merged.total_kept) == (want.n_events,
                                                    want.total_kept)
    assert torch.equal(merged.flat, want.flat)
    got_ev, got_m, got_z = host_events(res)
    want_ev, want_m, want_z = host_events(want)
    assert np.array_equal(got_ev, want_ev)
    assert np.array_equal(got_m, want_m)
    assert got_z == want_z


def test_sliced_scan_without_events(monkeypatch):
    """A sliced chunk with no event at all: no merged event, and the
    quiet lanes of every slice carried into z_trail."""
    rng = np.random.default_rng(19)
    n = 3 * SLICE_GRAN + 5
    lo, hi, mask, sa = (T(a) for a in granule_lanes(
        rng, ["quiet", "over", "quiet", "quiet"], n, SLICE_GRAN))
    want = scan_core_plain(lo, hi, mask, sa, 0, 0, 0, 8, 0, 20, False)
    assert want.n_events == 0
    res, plan = _sliced(lo, hi, mask, sa, 0, monkeypatch)
    assert len(plan) == 4
    merged = merge_slices(list(res))
    assert torch.equal(merged.flat, want.flat)
    assert host_events(res) is None


# the JAX tests of sliced dispatch: (genome seed, settings, budget, the
# JAX MIN_CAP patch); the merge-join and big-window cases are trim windows
CASES = {
    "whole": (11, dict(min_duplication_length=500, max_cardinality=500),
              256, 128),
    "whole_rc": (11, dict(min_duplication_length=500, max_cardinality=500,
                          reverse=True, complement=True), 256, 128),
    "merge_join": (21, dict(trim=(10000, 35000),
                            min_duplication_length=500), 8192, 2048),
    "big_window": (22, dict(trim=(10000, 35000), reverse=True,
                            complement=True, min_duplication_length=500),
                   256, 128),
}


def _route(case, monkeypatch):
    """Send the port (and the JAX package) to the case's engine."""
    if case == "merge_join":  # no fused window build
        monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
        monkeypatch.setenv("ASGART_FUSED", "0")
    elif case == "big_window":  # the route past int32 addressing
        monkeypatch.setattr(pipeline, "BIG_WINDOW_SPAN", 0)
        monkeypatch.setenv("ASGART_BIG_WINDOW", "1")


def _refs(case, s, monkeypatch, tmp_path_factory):
    """The case's FASTA, the port's host engine's JSON and the JAX
    ``engine="tpu"`` run's (which slices too, as its own test makes it),
    made once per test run: under pytest-xdist the first worker to reach
    the case writes them into the run's shared temporary root (under the
    lock of ``one_port_test_at_a_time``), and the others read them (the
    JSON names the FASTA's path)."""
    root = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        root = root.parent
    d = root / "sliced_refs" / case
    fa = d / "g.fa"
    if not (d / "tpu.json").exists():
        from asgart_tpu import device_engine as de

        d.mkdir(parents=True, exist_ok=True)
        write_fasta(fa, [("chr1", satellite_genome(
            np.random.default_rng(CASES[case][0])))])
        monkeypatch.setattr(de, "MIN_CAP", CASES[case][3])
        de._CAP_CACHE.clear()
        host = json_text(search_duplications([str(fa)], s, engine="host"))
        tpu = json_text(jax_search([str(fa)], jax_settings(s),
                                   engine="tpu"))
        assert any(v == "sliced" for v in de._CAP_CACHE.values())
        de._CAP_CACHE.clear()
        (d / "host.json").write_text(host)
        (d / "tpu.json").write_text(tpu)
    return (str(fa), (d / "host.json").read_text(),
            (d / "tpu.json").read_text())


@pytest.mark.parametrize("chain", ["host", "device", "journal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sliced_pipeline_equals_host_and_jax(tmp_path, tmp_path_factory,
                                             monkeypatch, case, chain):
    _, kw, budget, _ = CASES[case]
    s = RunSettings(**kw)
    _route(case, monkeypatch)
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", str(budget))
    fa, host, tpu = _refs(case, s, monkeypatch, tmp_path_factory)
    assert host == tpu
    assert host.count("chr_left_position") >= 1

    monkeypatch.setattr(device_engine, "SLICE_GRAN", 64)
    plans = []
    plan_of = device_engine.slice_plan
    monkeypatch.setattr(device_engine, "slice_plan",
                        lambda *a: plans.append(plan_of(*a)) or plans[-1])
    run, journaled = {}, []
    if chain == "device":
        monkeypatch.setenv("ASGART_DEVICE_CHAIN", "1")

        def no_host_chain(*a, **kw):
            raise AssertionError("the host chain ran under "
                                 "ASGART_DEVICE_CHAIN")

        monkeypatch.setattr(native, "chain_events", no_host_chain)
    elif chain == "journal":  # one chunk at a time
        run["checkpoint"] = str(tmp_path / "run.jsonl")
        eng = (pipeline.TableEngine if case.startswith("whole") else
               pipeline.DeviceWindowEngine)
        orig = eng.run_chunk
        monkeypatch.setattr(eng, "run_chunk", lambda self, c: (
            journaled.append(c) or orig(self, c)))
    port = json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         **run))
    assert bool(journaled) == (chain == "journal")
    assert plans and max(len(p) for p in plans) > 4  # slicing ran
    assert port == host
    assert port == tpu
