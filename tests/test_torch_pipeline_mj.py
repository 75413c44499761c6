"""The merge-join window engine end to end on the CPU:
``asgart_tpu_torch.pipeline.search_duplications(engine="cuda",
device=cpu)`` (the kernels' plain versions), routed there because the fused
build does not fit, writes JSON byte-equal to the JAX ``DeviceWindowEngine``
(``ASGART_FUSED=0``, ``engine="tpu"``: its one-device trim route) and to
the JAX host engine, for trim windows and ``--shards``; the route memory
alone chooses, the probe keys a sharded run holds included; the one-window
whole genome; the refusals; and a JAX-built window index carried in
through convert.py."""

import json

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import fused_index, pipeline
from asgart_tpu_torch.fused_index import (INDEX_CACHE, MJ_BYTES_PER_LANE,
                                          MJ_KEY_BYTES_PER_LANE,
                                          MJ_PEAK_BYTES_PER_ROW,
                                          PEAK_BYTES_PER_ROW,
                                          TABLE_PEAK_BYTES_PER_ROW,
                                          projected_rows)
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.window_index import DeviceWindowIndex

from torch_jax_ref import jax_settings, json_text, masked_multifasta
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, revcomp, write_fasta

CPU = torch.device("cpu")


def _genome(tmp_path, reverse=True):
    """90 kbp with a planted duplication 10000 -> 60000 (reverse
    complemented for -RC runs)."""
    rng = np.random.default_rng(41)
    g = plant_duplication(rng, 90000, 3000, 10000, 60000, noise=0.01,
                          transform=revcomp if reverse else None)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    return str(fa)


def _port(fa, s, **kw):
    return json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         **kw))


def _jax(fa, s, engine="host", **kw):
    return json_text(jax_search([fa], jax_settings(s), engine=engine, **kw))


def _sds(text):
    return sum(len(f) for f in json.loads(text)["families"])


@pytest.fixture
def fused_off(monkeypatch):
    """Both packages take their merge-join engines: the JAX package by its
    switch, the port because no fused build fits."""
    monkeypatch.setenv("ASGART_FUSED", "0")
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)


@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("k", [8, 20])
def test_trim_json_equals_jax_window_engine(tmp_path, fused_off, k, rc):
    """Both packages' merge-join engines, and the JAX host engine,
    agree."""
    fa = _genome(tmp_path, reverse=rc)
    s = RunSettings(reverse=rc, complement=rc, probe_size=k,
                    trim=(5000, 70000))
    port = _port(fa, s)
    assert port == _jax(fa, s, "tpu")
    assert port == _jax(fa, s)
    assert _sds(port) >= (1 if k == 20 else 0)  # k = 8 chains nothing
    assert isinstance(INDEX_CACHE._index, DeviceWindowIndex)


def test_trim_json_masked_multifasta(tmp_path, fused_off):
    """Soft-masked runs, IUPAC bytes and an N run across the fragment
    boundary, -RC with --skip-masked and direct."""
    fa = tmp_path / "g.fa"
    write_fasta(fa, masked_multifasta())
    for kw in (dict(skip_masked=True, reverse=True, complement=True), {}):
        s = RunSettings(min_duplication_length=800, trim=(1000, 30000),
                        **kw)
        port = _port(str(fa), s)
        assert port == _jax(str(fa), s, "tpu")
        assert port == _jax(str(fa), s)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("k", [8, 20])
def test_shards_json_equals_jax_host(tmp_path, fused_off, k, shards):
    """Every window on the merge-join engine, the probe keys packed once
    for the run; the JAX host engine's sharded bytes."""
    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True, probe_size=k)
    packs = []
    orig = pipeline.ProbeKeyCache.get_or_pack

    def counting(self, key, pack):
        return orig(self, key, lambda: packs.append(1) or pack())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline.ProbeKeyCache, "get_or_pack", counting)
        port = _port(fa, s, shards=shards)
    assert len(packs) == 1
    assert port == _jax(fa, s, shards=shards)
    assert _sds(port) >= (1 if k == 20 else 0)


def _mj_need(n1, W, k, keys_held=False):
    """The merge-join engine's projected bytes for a W-row window, the n1
    resident code bytes included."""
    lanes = n1 // (k // 2)
    build = MJ_PEAK_BYTES_PER_ROW * W
    if keys_held:
        build += MJ_KEY_BYTES_PER_LANE * lanes
    return max(build, 12 * W + MJ_BYTES_PER_LANE * lanes) + n1


def _free_between(n1, W, k, keys_held=False):
    """Free device bytes that fit the merge-join engine's projection for
    a W-row window (plus the n1 resident code bytes) but not the fused
    build's."""
    fused = projected_rows(n1, W, k) * PEAK_BYTES_PER_ROW[1] + n1
    mj = _mj_need(n1, W, k, keys_held)
    assert mj < fused
    return (mj + fused) / 2


def test_natural_route(tmp_path, monkeypatch):
    """Routing follows memory alone: with the free bytes between the two
    projections, a trim window, the shards' windows and the whole genome
    (one window (0, n1 - 1), whose JSON is the whole genome's) run on the
    merge-join engine; the whole genome only when the table engine, which
    the router tries before it, does not fit either (at this size the
    table's projection lies below the fused build's, whose bucket slack
    dominates)."""
    fa = _genome(tmp_path)
    n1 = 90001
    s = RunSettings(reverse=True, complement=True)
    built = []
    orig = DeviceWindowIndex.build.__func__

    def spy(cls, *a, **kw):
        built.append(a[2])
        return orig(cls, *a, **kw)

    monkeypatch.setattr(DeviceWindowIndex, "build", classmethod(spy))
    table = (2 * n1 - 1) * TABLE_PEAK_BYTES_PER_ROW
    assert _mj_need(n1, n1, 20) < table < _free_between(n1, n1, 20)
    monkeypatch.setattr(pipeline, "free_bytes",
                        lambda device: _free_between(n1, n1, 20))
    assert _port(fa, s) == _jax(fa, s)
    assert built == []  # the table engine
    monkeypatch.setattr(pipeline, "free_bytes",
                        lambda device: (_mj_need(n1, n1, 20) + table) / 2)
    assert _port(fa, s) == _jax(fa, s)
    assert built == [(0, n1 - 1)]
    trim = RunSettings(reverse=True, complement=True, trim=(5000, 70000))
    monkeypatch.setattr(pipeline, "free_bytes",
                        lambda device: _free_between(n1, 65001, 20))
    assert _port(fa, trim) == _jax(fa, trim)
    assert built[-1] == (5000, 70000)
    monkeypatch.setattr(pipeline, "free_bytes",
                        lambda device: _free_between(n1, 45001, 20,
                                                     keys_held=True))
    assert _port(fa, s, shards=2) == _jax(fa, s, shards=2)
    assert built[-2:] == [(0, 45000), (45000, 90000)]


def test_sharded_run_charges_its_held_probe_keys(tmp_path, monkeypatch):
    """Free memory modelled as a budget that the uploaded codes and the
    cached probe keys draw down: the auto-shard planner charges the keys
    that a sharded merge-join run holds beside every later window's
    build, so it picks a shard count whose windows all run (the keys-free
    projection would pick 2 and find window 2 over budget), and the run
    decides its route once, before the keys exist."""
    fa = _genome(tmp_path)
    n1 = 90001
    s = RunSettings(reverse=True, complement=True)
    W2 = 45001
    budget = (_mj_need(n1, W2, 20) + _mj_need(n1, W2, 20, True)) // 2
    assert _mj_need(n1, 30001, 20, True) <= budget
    held = {"codes": 0, "keys": 0}
    upload = pipeline.upload_codes
    get_or_pack = pipeline.ProbeKeyCache.get_or_pack

    def uploading(data, device):
        held["codes"] = len(data)
        return upload(data, device)

    def packing(self, key, pack):
        pkey, mask = get_or_pack(self, key, pack)
        held["keys"] = pkey.numel() * 8 + mask.numel()
        return pkey, mask

    built = []
    orig = DeviceWindowIndex.build.__func__

    def building(cls, *a, **kw):
        built.append(a[2])
        return orig(cls, *a, **kw)

    def free(device):
        return budget - sum(held.values())

    monkeypatch.setattr(pipeline, "upload_codes", uploading)
    monkeypatch.setattr(pipeline.ProbeKeyCache, "get_or_pack", packing)
    monkeypatch.setattr(DeviceWindowIndex, "build", classmethod(building))
    monkeypatch.setattr(fused_index, "free_bytes", free)
    monkeypatch.setattr(pipeline, "free_bytes", free)
    assert pipeline.plan_shards(n1, 20, True, budget) == 3
    assert _port(fa, s) == _jax(fa, s, shards=3)
    assert built == [(0, 30000), (30000, 60000), (60000, 90000)]
    # S = 2 by the keys-free projection: window 2's build would not fit
    # beside the codes and the held keys
    assert budget - n1 - held["keys"] < MJ_PEAK_BYTES_PER_ROW * W2


def test_refusals(tmp_path, monkeypatch):
    """Windows at k > 20 that no fused build holds name the host engine;
    a window that fits neither route raises, a sharded run before any
    window runs."""
    fa = _genome(tmp_path)
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    s25 = RunSettings(reverse=True, complement=True, probe_size=25,
                      trim=(5000, 70000))
    with pytest.raises(NotImplementedError,
                       match="beyond one device's fused build runs on the "
                       "host engine"):
        _port(fa, s25)
    with pytest.raises(NotImplementedError, match="host engine"):
        _port(fa, RunSettings(probe_size=25), shards=2)
    monkeypatch.setattr(pipeline, "mj_fits", lambda *a, **kw: False)
    with pytest.raises(NotImplementedError, match="fits no device route"):
        _port(fa, RunSettings(trim=(5000, 70000)))
    monkeypatch.setattr(DeviceWindowIndex, "build", None)  # never reached
    monkeypatch.setattr(pipeline, "upload_codes", None)
    with pytest.raises(NotImplementedError, match="fits no device route"):
        _port(fa, RunSettings(), shards=2)


@pytest.mark.parametrize("reverse", [True, False])
def test_port_engine_on_jax_window_index(tmp_path, reverse):
    """A JAX-built DeviceWindowIndex carried across with convert.py
    drives the port's merge-join engine to the host engine's JSON."""
    from asgart_tpu.device_index import DeviceWindowIndex as JaxIndex
    from asgart_tpu_torch.convert import window_index_from_numpy
    from asgart_tpu_torch.device_engine import DeviceWindowEngine
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.pipeline import (_finalize_result,
                                           raw_families_to_protosds)

    fa = _genome(tmp_path, reverse=reverse)
    trim = (4000, 75000)
    s = RunSettings(reverse=reverse, complement=reverse, trim=trim)
    _, chunks, strand = prepare_data([fa], False, trim)
    ref = JaxIndex.build(strand.data, 20, trim=trim, reverse=reverse,
                         complement=reverse)
    idx = window_index_from_numpy(
        np.asarray(ref.key_hi), np.asarray(ref.key_lo), np.asarray(ref.sa),
        ref.k, ref.n, ref.first_len, ref.W, ref.win_start, ref.win_end,
        ref.reverse, ref.complement, CPU)
    eng = DeviceWindowEngine(strand, s, CPU, trim, cache=None, index=idx)
    fams = []
    for (start, length), raw in zip(chunks, eng.run_chunks(chunks)):
        fams.extend(raw_families_to_protosds(raw, s, start, length))
    port = json_text(_finalize_result(fams, strand, s))
    assert port == _jax(fa, s)
    assert _sds(port) >= 1


def test_warm_rescan_skips_build_and_join(tmp_path, fused_off):
    """A rescan of the same window and chunks is served from the index
    cache with its stage 1: no build, no probe pack, no join."""
    import importlib

    def mod(name):  # the module, not the wrapper of the same name
        return importlib.import_module(f"asgart_tpu_torch.kernels.{name}")

    fa = _genome(tmp_path)
    s = RunSettings(reverse=True, complement=True, trim=(5000, 70000))
    INDEX_CACHE.clear()
    cold = _port(fa, s)
    idx = INDEX_CACHE._index
    assert idx.stage1 is not None

    def forbidden(*a, **kw):
        raise AssertionError("a warm rescan packed or joined again")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod("pack_keys"), "pack_keys_plain", forbidden)
        mp.setattr(mod("merge_join"), "mj_ranges_plain", forbidden)
        assert _port(fa, s) == cold
    assert INDEX_CACHE._index is idx
    INDEX_CACHE.clear()
