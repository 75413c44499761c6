"""The table engine's probe-axis scan (asgart_tpu_torch
``TableEngine`` under a process group: ``device_engine.probe_lanes``,
``scan_lanes`` over a rank's lanes, ``gather_ranks``) against the JAX
``DeviceEngine`` on a probe mesh (``_sharded_scan``, device_engine.py:987)
of 2 and 4 of the conftest's CPU devices: each rank's stream equals the JAX
shard's; the ranks' streams merged equal the one-rank table engine's,
unsliced and with a rank's lanes sliced (``ASGART_DEVICE_SLICE_LANES``
small), on a genome whose second chunk leaves the last ranks without a
lane; and two gloo ranks on the CPU write the JAX host engine's JSON.
Exact (integers, JSON bytes; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch import distributed
from asgart_tpu_torch.device_engine import (Sliced, TableEngine,
                                            gather_ranks, merge_slices,
                                            probe_lanes, scan_lanes)
from asgart_tpu_torch.kernels.scan_core import ScanResult, fused_bases
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import jax_settings, json_text, prepared
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, revcomp

CPU = torch.device("cpu")
# k = 8: a 220 kb chunk has 54,997 lanes in a 65,536-lane bucket, so every
# rank of 2 and of 4 scans some; the 60 kb chunk's 14,997 lanes all fall to
# rank 0 (the other ranks get none)
SETTINGS = RunSettings(probe_size=8, reverse=True, complement=True,
                       min_duplication_length=800)


def _genome() -> bytes:
    rng = np.random.default_rng(88)
    a = bytearray(random_dna(rng, 220000))
    a[150000:152000] = revcomp(bytes(a[10000:12000]))   # -RC pair
    a[200000:201500] = revcomp(bytes(a[90000:91500]))   # across ranks
    b = random_dna(rng, 60000)
    return bytes(a) + b"N" * 6000 + b


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return prepared(tmp_path_factory.mktemp("mesh"), [("chr1", _genome())])


def _rank_results(eng, chunks, r, D):
    """Rank r's result for each chunk (None, or one ScanResult: a sliced
    one merged)."""
    out = []
    for res in scan_lanes(eng.settings, eng.ranges(chunks), eng.index.sa,
                          chunks, fused_bases,
                          part=lambda nc: probe_lanes(nc, r, D)):
        out.append(merge_slices(list(res)) if isinstance(res, Sliced)
                   else res)
    return out


def test_probe_lanes_partition():
    """Every rank's lanes, in rank order, tile the chunk's lanes: the JAX
    ``_chunk_geometry`` (bucket rounded up to a multiple of D, over D)."""
    from asgart_tpu import device_engine as jde

    for nc in (1, 100, 14997, 54997, 65536, 65537, 3 << 20, 6_400_001):
        for D in (1, 2, 3, 4, 8):
            parts = [probe_lanes(nc, r, D) for r in range(D)]
            assert parts[0][0] == 0 and parts[-1][1] == nc
            assert all(parts[i][1] == parts[i + 1][0]
                       for i in range(D - 1))
            b_pad = jde._bucket(nc)
            b_pad += -b_pad % D
            assert parts[0][1] == min(nc, b_pad // D)


@pytest.mark.parametrize("D", [2, 4])
def test_rank_streams_equal_jax_shards(genome, D):
    """Rank r's KD stream (plain version) over its lanes equals shard r of
    the JAX ``_sharded_scan`` on a D-device probe mesh: ``ev_pack``,
    ``m_flat`` and ``scalars``' live prefixes."""
    from jax.sharding import Mesh

    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import prepare_data

    fa, chunks, strand = genome
    _, jchunks, jstrand = prepare_data([fa], False, None)
    jeng = DeviceEngine(jstrand, jax_settings(SETTINGS), mesh=Mesh(
        np.array(jax.devices()[:D]), ("probes",)))
    eng = TableEngine(strand, SETTINGS, CPU, cache=None)
    ranks = [_rank_results(eng, chunks, r, D) for r in range(D)]
    assert len(chunks) == 2
    for c, chunk in enumerate(chunks):
        st = jeng._dispatch_chunk(tuple(chunk))
        assert not st.get("sliced")
        # the JAX collect's retry: events past its ev_cap bucket overflow
        b_local = jeng._chunk_geometry(tuple(chunk))[1]
        st = jeng._dispatch_chunk(tuple(chunk), cap=st["cap"],
                                  ev_cap=b_local)
        assert len(st["shards"]) == D
        for r, (ev_pack, m_flat, scalars) in enumerate(st["shards"]):
            ev_pack, m_flat, scalars = (np.asarray(a) for a in
                                        (ev_pack, m_flat, scalars))
            res = ranks[r][c]
            ev, m, z_trail = res.to_host()
            assert [res.n_events, res.total_kept, z_trail, 0] == \
                scalars.tolist(), (c, r)
            assert np.array_equal(ev, ev_pack[:, :res.n_events])
            assert np.array_equal(m, m_flat[:res.total_kept])
    # every rank scans lanes of the first chunk; the second chunk's all
    # fall to rank 0
    assert all(ranks[r][0].n_events for r in range(D))
    assert all(ranks[r][1].flat.tolist() == [0] for r in range(1, D))


@pytest.mark.parametrize("budget", [None, 20000])
@pytest.mark.parametrize("D", [2, 4])
def test_ranks_merged_equal_one_rank(genome, monkeypatch, D, budget):
    """``gather_ranks`` on rank 0 (``all_gather_var`` fed the other ranks'
    results, as a group would hand them over) merges the ranks' streams
    into the one-rank table engine's, bit for bit, unsliced and with each
    rank's lanes sliced at a small budget."""
    fa, chunks, strand = genome
    eng = TableEngine(strand, SETTINGS, CPU, cache=None)
    want = list(scan_lanes(SETTINGS, eng.ranges(chunks), eng.index.sa,
                           chunks, fused_bases))
    assert not any(isinstance(w, Sliced) for w in want)
    if budget is not None:
        monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", str(budget))
    sliced0 = scan_lanes.sliced
    ranks = [_rank_results(eng, chunks, r, D) for r in range(D)]
    if budget is not None:
        assert scan_lanes.sliced - sliced0 >= D
    queue = []
    for c in range(len(chunks)):
        queue.append([ranks[r][c].flat for r in range(D)])
        queue.append([torch.tensor([ranks[r][c].n_events,
                                    ranks[r][c].total_kept])
                      for r in range(D)])
    monkeypatch.setattr(distributed, "all_gather_var",
                        lambda t: queue.pop(0))
    got = list(gather_ranks(scan_lanes(
        SETTINGS, eng.ranges(chunks), eng.index.sa, chunks, fused_bases,
        part=lambda nc: probe_lanes(nc, 0, D))))
    assert not queue
    for g, w in zip(got, want):
        assert isinstance(g, ScanResult)
        assert (g.n_events, g.total_kept) == (w.n_events, w.total_kept)
        assert torch.equal(g.flat, w.flat)
    assert sum(w.n_events for w in want) > 0


def test_two_ranks_json_equal_jax_host(genome):
    """Two gloo ranks on the CPU (``distributed.dryrun``): the whole genome
    through the router (no fused build under a group: the table engine's
    probe-axis scan), both ranks' JSON equal to the JAX host engine's."""
    from asgart_tpu.pipeline import search_duplications as jax_search

    fa, chunks, _ = genome
    host = json_text(jax_search([fa], jax_settings(SETTINGS),
                                engine="host"))
    text, reports = distributed.dryrun(
        2, "cpu", fa=fa, settings=SETTINGS, host=host,
        env={"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}, timeout=600)
    assert text == host
    assert [r["lanes"] for r in reports] == [
        distributed.rank_lanes(SETTINGS, chunks, r, 2) for r in range(2)]
    assert all(r["lanes"] for r in reports)
    assert all(op == "all_gather" for r in reports
               for op, _, _ in r["collectives"])
