"""The route past int32 probe addressing end to end on the CPU:
``asgart_tpu_torch.pipeline.search_duplications(engine="cuda",
device=cpu)`` (the kernels' plain versions), sent there by lowering
``pipeline.BIG_WINDOW_SPAN`` (the probed-text length from which the fused
build drops out and every window takes the merge-join engine; 2^31 in
use), writes JSON byte-equal to the JAX ``BigWindowEngine``
(``ASGART_BIG_WINDOW=1``, ``engine="tpu"``) and to the JAX host engine, on
the cases of tests/test_device_window.py's big-window tests; the route of
trim windows, shards and the whole genome; the planner's arithmetic at
whole-genome scale; the refusals; and a JAX big window carried in through
convert.py."""

import json

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import pipeline
from asgart_tpu_torch.pipeline import plan_shards, search_duplications
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import jax_settings, json_text
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, revcomp, write_fasta

CPU = torch.device("cpu")


@pytest.fixture
def big(monkeypatch):
    """Both packages take their route past int32 addressing: the JAX
    package its big-window engine by its switch, the port its merge-join
    engine by a probed-text threshold every genome passes. Yields the trims
    of the port's windows, in scan order."""
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    monkeypatch.setattr(pipeline, "BIG_WINDOW_SPAN", 0)
    monkeypatch.setattr(pipeline, "FusedEngine", None)  # never reached
    trims = []
    scan = pipeline.DeviceWindowEngine.scan_chunks

    def spy(self, chunks):
        trims.append(self.trim)
        return scan(self, chunks)

    monkeypatch.setattr(pipeline.DeviceWindowEngine, "scan_chunks", spy)
    return trims


def _fasta(tmp_path, g: bytes) -> str:
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    return str(fa)


def _direct(rng):  # test_big_window_direct
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[12000:14000] = bytes(g[2000:4000])
    g[30000:32000] = bytes(g[5000:7000])
    g[19000:21000] = bytes(g[8000:10000])
    return bytes(g)


def _rc(rng):  # test_big_window_rc
    g = bytearray(random_dna(rng, 30000, b"ACGT"))
    g[15000:17000] = revcomp(bytes(g[3000:5000]))
    return bytes(g)


def _chunks_and_repeats(rng):  # test_big_window_multi_chunk_and_repeats
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    alu = random_dna(rng, 250, b"ACGT")
    for i in range(12):
        g[10000 + i * 400: 10000 + i * 400 + 250] = alu
    g[6000:7500] = bytes(g[1000:2500])
    g[16000:22000] = b"N" * 6000
    g[30000:31500] = bytes(g[25000:26500])
    return bytes(g)


def _shards(rng):  # test_big_window_shards_byte_equal
    g = bytearray(random_dna(rng, 36000, b"ACGT"))
    g[20000:22500] = revcomp(bytes(g[2000:4500]))
    g[30000:31500] = bytes(g[8000:9500])
    return bytes(g)


CASES = {
    "direct": (41, _direct, dict(trim=(10000, 20000),
                                 min_duplication_length=800), 1, 1),
    "rc": (42, _rc, dict(trim=(12000, 26000), reverse=True, complement=True,
                         min_duplication_length=800), 1, 1),
    "chunks_and_repeats": (43, _chunks_and_repeats,
                           dict(trim=(0, 35000), max_cardinality=15,
                                min_duplication_length=700), 1, 2),
    "shards": (44, _shards, dict(min_duplication_length=800, reverse=True,
                                 complement=True), 3, 1),
}


@pytest.mark.parametrize("k", [20, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_json_equals_jax_big_window(tmp_path, big, case, k):
    """Windows at 0 (chunks_and_repeats, the first shard) and past it;
    chunks split by an N run and a repeat above max_cardinality; k = 8
    finds nothing to chain here, k = 20 the planted pairs."""
    seed, make, kw, shards, min_sds = CASES[case]
    fa = _fasta(tmp_path, make(np.random.default_rng(seed)))
    s = RunSettings(probe_size=k, **kw)
    port = json_text(search_duplications([fa], s, engine="cuda", device=CPU,
                                         shards=shards))
    js = jax_settings(s)
    assert port == json_text(jax_search([fa], js, engine="tpu",
                                        shards=shards))
    assert port == json_text(jax_search([fa], js, engine="host",
                                        shards=shards))
    assert len(big) == shards
    if k == 20:
        assert sum(len(f) for f in json.loads(port)["families"]) >= min_sds


def test_routes(tmp_path, big):
    """Past the threshold every window takes the merge-join engine: a
    trim window, the shards, and the whole genome through the planner's
    windows (S = 2 on an unbounded device); k > 20 raises naming the host
    engine."""
    fa = _fasta(tmp_path, _shards(np.random.default_rng(44)))
    s = RunSettings(reverse=True, complement=True,
                    min_duplication_length=800)

    def port(settings, **kw):
        return json_text(search_duplications([fa], settings, engine="cuda",
                                             device=CPU, **kw))

    def host(settings, **kw):
        return json_text(jax_search([fa], jax_settings(settings),
                                    engine="host", **kw))

    assert port(s) == host(s, shards=2)
    assert big == [(0, 18000), (18000, 36000)]
    t = RunSettings(reverse=True, complement=True, trim=(2000, 30000))
    assert port(t) == host(t)
    assert big[-1] == (2000, 30000)
    for kw in (dict(trim=(2000, 30000)), {}):
        with pytest.raises(NotImplementedError, match="host engine"):
            port(RunSettings(probe_size=25, **kw))
    with pytest.raises(NotImplementedError, match="host engine"):
        port(RunSettings(probe_size=25), shards=2)


def test_refusals_past_the_engine_bounds():
    """A window of 2^30 rows, a chunk of 2^30 bases and k > 20 have no
    device route past int32 probe addressing; W < 2^30 with chunks below
    2^30 bases does."""
    n1 = 3_100_000_001
    s = RunSettings(reverse=True, complement=True)
    route = pipeline._window_route(n1, (1 << 30) - 1, s, CPU, n1,
                                   chunk_len=(1 << 30) - 1)
    assert route is pipeline.DeviceWindowEngine
    with pytest.raises(NotImplementedError, match="fits no device route"):
        pipeline._window_route(n1, 1 << 30, s, CPU, n1)
    with pytest.raises(NotImplementedError, match="chunks under 2\\^30"):
        pipeline._window_route(n1, 1000, s, CPU, n1, chunk_len=1 << 30)
    with pytest.raises(NotImplementedError, match="host engine"):
        pipeline._window_route(n1, 1000, RunSettings(probe_size=21), CPU,
                               n1)


@pytest.mark.parametrize("gbp", [2.2, 3.1])
def test_plan_shards_whole_genome_scale(gbp):
    """-RC at k = 20 on 80 GB of free bytes: two windows would pass 2^30
    rows, three fit (2.2 Gbp: W = 733 M, the build 55·W + 9·lanes + n1
    ≈ 44.5 GB; 3.1 Gbp, the whole human genome: W ≈ 1.034·10^9)."""
    n1 = int(gbp * 1e9) + 1
    assert plan_shards(n1, 20, True, 80e9) == 3
    W3 = (n1 - 1 + 2) // 3 + 1
    assert W3 < (1 << 30) < (n1 - 1 + 1) // 2 + 1
    need = 55 * W3 + 9 * (n1 // 10) + n1
    assert need <= 80e9
    assert plan_shards(n1, 20, True, need - 1) == 4
    assert plan_shards(n1, 25, True, 80e9) is None


@pytest.mark.parametrize("rc", [True, False])
def test_port_engine_on_jax_big_window(tmp_path, rc):
    """A JAX ``BigWindowEngine``'s window-relative key planes and suffix
    order, carried across with ``window_index_from_numpy(relative=True)``,
    drive the port's merge-join engine to the host engine's JSON; a JAX
    ``DeviceWindowIndex`` of the same window (genome positions) carried
    across gives the same index."""
    from asgart_tpu.device_engine import BigWindowEngine as JaxBig
    from asgart_tpu.device_index import DeviceWindowIndex as JaxIndex
    from asgart_tpu_torch.convert import window_index_from_numpy
    from asgart_tpu_torch.device_engine import DeviceWindowEngine
    from asgart_tpu_torch.fasta import prepare_data
    from asgart_tpu_torch.pipeline import (_finalize_result,
                                           raw_families_to_protosds)

    fa = _fasta(tmp_path, _rc(np.random.default_rng(42)) if rc
                else _direct(np.random.default_rng(41)))
    trim = (12000, 26000) if rc else (10000, 20000)
    s = RunSettings(reverse=rc, complement=rc, min_duplication_length=800,
                    trim=trim)
    _, chunks, strand = prepare_data([fa], False, trim)
    ref = JaxBig(strand, jax_settings(s), trim)
    n1 = len(strand.data)
    idx = window_index_from_numpy(
        np.asarray(ref.key_hi), np.asarray(ref.key_lo), np.asarray(ref.sa),
        20, 2 * n1 - 1 if rc else n1, n1, ref.W, trim[0], trim[1], rc, rc,
        CPU, relative=True)
    eng = DeviceWindowEngine(strand, s, CPU, trim, cache=None, index=idx)
    fams = []
    for (start, length), raw in zip(chunks, eng.run_chunks(chunks)):
        fams.extend(raw_families_to_protosds(raw, s, start, length))
    port = json_text(_finalize_result(fams, strand, s))
    assert port == json_text(jax_search([fa], jax_settings(s),
                                        engine="host"))
    assert json.loads(port)["families"]
    glob = JaxIndex.build(strand.data, 20, trim=trim, reverse=rc,
                          complement=rc)
    assert int(np.asarray(glob.sa).min()) == trim[0]
    got = window_index_from_numpy(
        np.asarray(glob.key_hi), np.asarray(glob.key_lo),
        np.asarray(glob.sa), glob.k, glob.n, glob.first_len, glob.W,
        glob.win_start, glob.win_end, rc, rc, CPU)
    assert torch.equal(got.key, idx.key) and torch.equal(got.sa, idx.sa)
