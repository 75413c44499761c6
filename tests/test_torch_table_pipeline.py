"""``--checkpoint`` on both of the port's engines, and the cuda engine's
routes around the table engine, on the CPU
(``search_duplications(engine="cuda", device=cpu)``, the kernels' plain
versions):

- the journal's first run, its resumed run and a run without a journal
  write the JAX host engine's bytes, and the JAX ``engine="tpu",
  checkpoint=...`` run's (tests/test_pipeline.py:466 and
  tests/test_cli.py:104's cases), on the table engine and the host engine,
  and through the CLI;
- a journal the JAX package wrote resumes in the port and the reverse,
  record for record; a chunk that raises mid-run resumes to the same
  JSON, scanning only what is missing; a header that does not match
  starts the journal afresh;
- the router: fused build, then the table, then the one-window merge
  join, then the planner (k <= 20); under a journal the table, then the
  one-window merge join, and for ``--trim`` the merge-join engine;
- F11: at k = 21..30 no planner runs; and F12, every input where the JAX
  ``engine="tpu"`` quietly runs its host engine and the port raises.
"""

import json
import logging

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu.pipeline import search_duplications as jax_search
from asgart_tpu_torch import fused_index, pipeline
from asgart_tpu_torch.device_engine import (DeviceWindowEngine, FusedEngine,
                                            TableEngine)
from asgart_tpu_torch.fused_index import INDEX_CACHE
from asgart_tpu_torch.pipeline import search_duplications
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import jax_settings, json_text
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import plant_duplication, random_dna, revcomp, write_fasta

CPU = torch.device("cpu")
ENGINES = ("cuda", "host")


def _pipeline_genome(tmp_path):
    """tests/test_pipeline.py:466's genome: a direct copy and a 6500-N run
    that splits it into two chunks."""
    rng = np.random.default_rng(31)
    g = bytearray(random_dna(rng, 30000))
    g[20000:22000] = bytes(g[3000:5000])
    g[12000:18500] = b"N" * 6500
    fa = tmp_path / "c.fa"
    write_fasta(fa, [("chr", bytes(g))])
    return str(fa)


def _cli_genome(tmp_path):
    """tests/test_cli.py:15's genome: a noisy direct copy and an RC copy,
    one chunk."""
    rng = np.random.default_rng(42)
    g = bytearray(plant_duplication(rng, 16000, 1500, 2000, 9000,
                                    noise=0.005))
    g[12000:13200] = revcomp(bytes(g[4000:5200]))
    fa = tmp_path / "genome.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    return str(fa)


def _three_chunks(tmp_path):
    """The same copies spread over 40 kbp, with two 5500-N runs that split
    it into three chunks: the direct pair inside chunk 1, the RC pair
    across chunks 1 and 3."""
    rng = np.random.default_rng(42)
    g = bytearray(plant_duplication(rng, 40000, 1500, 2000, 9000,
                                    noise=0.005))
    g[32000:33200] = revcomp(bytes(g[4000:5200]))
    g[11000:16500] = b"N" * 5500
    g[22000:27500] = b"N" * 5500
    fa = tmp_path / "three.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    return str(fa)


def _run(engine, fa, s, **kw):
    if engine == "cuda":
        kw["device"] = CPU
    return json_text(search_duplications([fa], s, engine=engine, **kw))


def _jax(fa, s, **kw):
    return json_text(jax_search([fa], jax_settings(s), **kw))


class _Scans:
    """Counts the chunks each engine scans (``run_chunk`` calls)."""

    def __init__(self, monkeypatch):
        self.chunks = []
        for cls in (TableEngine, DeviceWindowEngine,
                    pipeline.SearchEngine):
            orig = cls.run_chunk

            def spy(eng, chunk, orig=orig):
                self.chunks.append(tuple(chunk))
                return orig(eng, chunk)

            monkeypatch.setattr(cls, "run_chunk", spy)


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_resume(tmp_path, monkeypatch, engine, rc):
    """tests/test_pipeline.py:466 on the port: the journaled run, its
    resumed rerun (every chunk restored, none scanned) and a run without
    a journal are the JAX host engine's bytes and the JAX table engine's
    (``engine="tpu", checkpoint=...``)."""
    fa = _pipeline_genome(tmp_path)
    s = RunSettings(min_duplication_length=900, reverse=rc, complement=rc)
    ck = str(tmp_path / "journal.jsonl")
    want = _jax(fa, s, engine="host")
    assert _jax(fa, s, engine="tpu", checkpoint=str(tmp_path / "j.jsonl")) \
        == want
    scans = _Scans(monkeypatch)
    assert _run(engine, fa, s, checkpoint=ck) == want
    assert len(scans.chunks) == 2
    lines = open(ck).read().splitlines()
    assert [json.loads(line)["chunk"] for line in lines[1:]] == \
        [[0, 12000], [18500, 11500]]
    assert _run(engine, fa, s, checkpoint=ck) == want
    assert len(scans.chunks) == 2  # nothing scanned again
    assert _run(engine, fa, s) == want
    assert json.loads(want)["families"] or rc  # the copy is direct


def test_checkpoint_resume_cli_case(tmp_path, monkeypatch):
    """tests/test_cli.py:104 on the port, both engines: first run, rerun
    and the plain run equal (and equal to the JAX host engine); other
    settings find the journal's header different and run afresh."""
    fa = _cli_genome(tmp_path)
    s = RunSettings()
    want = _jax(fa, s, engine="host")
    for engine in ENGINES:
        ck = str(tmp_path / f"{engine}.ckpt")
        assert _run(engine, fa, s, checkpoint=ck) == want
        assert _run(engine, fa, s, checkpoint=ck) == want
        other = RunSettings(probe_size=16)
        assert _run(engine, fa, other, checkpoint=ck) == \
            _jax(fa, other, engine="host")
        header = json.loads(open(ck).readline())
        assert header["settings"]["probe_size"] == 16


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_resumes_across_packages(tmp_path, monkeypatch, writer):
    """A journal written by one package resumes in the other: whole, and
    with its last record removed (the other package scans that chunk
    alone); the records are the same in both directions."""
    fa = _three_chunks(tmp_path)
    s = RunSettings(reverse=True, complement=True)
    want = _jax(fa, s, engine="host")
    ck = tmp_path / "j.jsonl"

    def write(path):
        if writer == "jax":
            return _jax(fa, s, engine="host", checkpoint=str(path))
        return _run("cuda", fa, s, checkpoint=str(path))

    def resume(path):
        if writer == "jax":
            return _run("cuda", fa, s, checkpoint=str(path))
        return _jax(fa, s, engine="host", checkpoint=str(path))

    assert write(ck) == want
    written = ck.read_text().splitlines()
    assert len(written) == 4  # header and three chunks
    scans = _Scans(monkeypatch)
    assert resume(ck) == want
    ck.write_text("\n".join(written[:-1]) + "\n")
    assert resume(ck) == want
    if writer == "jax":
        assert scans.chunks == [tuple(json.loads(written[-1])["chunk"])]
    # the record the other package appended is the writer's
    assert [json.loads(x) for x in ck.read_text().splitlines()] == \
        [json.loads(x) for x in written]


def test_failing_chunk_resumes(tmp_path, monkeypatch):
    """A chunk that raises mid-run fails the run after the chunks before
    it are journaled; the rerun restores those and scans the rest, to the
    JSON of a run without failure."""
    fa = _three_chunks(tmp_path)
    s = RunSettings(reverse=True, complement=True)
    ck = str(tmp_path / "j.jsonl")
    want = _jax(fa, s, engine="host")
    orig = TableEngine.run_chunk
    calls = []

    def failing(eng, chunk):
        calls.append(tuple(chunk))
        if len(calls) == 2:
            raise RuntimeError("chunk 2 failed")
        return orig(eng, chunk)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TableEngine, "run_chunk", failing)
        with pytest.raises(RuntimeError, match="chunk 2 failed"):
            _run("cuda", fa, s, checkpoint=ck)
    assert len(open(ck).read().splitlines()) == 2  # header and chunk 1
    scans = _Scans(monkeypatch)
    assert _run("cuda", fa, s, checkpoint=ck) == want
    assert len(scans.chunks) == 2 and scans.chunks[0] == calls[1]


def test_header_mismatch_starts_afresh(tmp_path, monkeypatch, caplog):
    fa = _three_chunks(tmp_path)
    s = RunSettings(reverse=True, complement=True)
    ck = tmp_path / "j.jsonl"
    ck.write_text(json.dumps({"files": [fa], "settings": {},
                              "reverse": True, "complement": True})
                  + "\n" + json.dumps({"chunk": [0, 6000],
                                       "families": [[]]}) + "\n")
    scans = _Scans(monkeypatch)
    with caplog.at_level(logging.WARNING, logger="asgart"):
        assert _run("cuda", fa, s, checkpoint=str(ck)) == \
            _jax(fa, s, engine="host")
    assert "checkpoint mismatch; starting fresh" in caplog.text
    assert len(scans.chunks) == 3
    lines = ck.read_text().splitlines()
    assert json.loads(lines[0])["settings"] == s.to_json_obj()
    assert len(lines) == 4


def test_cli_checkpoint(tmp_path):
    """``--checkpoint`` through the port's CLI writes the JAX CLI's bytes
    (first run and resumed run)."""
    from asgart_tpu.cli.main import main as jax_main
    from asgart_tpu_torch.cli.main import main

    fa = _cli_genome(tmp_path)
    out, ref = tmp_path / "port.json", tmp_path / "jax.json"
    assert jax_main([fa, "-R", "-C", "--out", str(ref)]) == 0
    for _ in range(2):
        assert main([fa, "-R", "-C", "--checkpoint",
                     str(tmp_path / "c.jsonl"), "--out", str(out)]) == 0
        assert out.read_text() == ref.read_text()


def _route_spy(monkeypatch):
    used = []
    for cls in (FusedEngine, TableEngine, DeviceWindowEngine):
        orig = cls.ensure_index

        def spy(eng, chunks=None, orig=orig, cls=cls):
            if eng.index is None:  # the engine's first call
                used.append((cls.__name__, getattr(eng, "trim", None)))
            return orig(eng, chunks)

        monkeypatch.setattr(cls, "ensure_index", spy)
    return used


def test_routes(tmp_path, monkeypatch, caplog):
    """With patched fits, the whole genome takes the fused build, else the
    table, else the one-window merge join, else the planner; under a
    journal the table (never the fused build), else the one-window merge
    join, else a refusal; a journaled ``--trim`` takes the merge-join
    engine. Every run writes the JAX host engine's bytes."""
    fa = _three_chunks(tmp_path)
    s = RunSettings(reverse=True, complement=True)
    trim = RunSettings(reverse=True, complement=True, trim=(1000, 11000))
    want, want_trim = _jax(fa, s, engine="host"), _jax(fa, trim,
                                                       engine="host")
    n1 = 40001
    used = _route_spy(monkeypatch)
    ck = str(tmp_path / "j.jsonl")

    def run(settings=s, **kw):
        INDEX_CACHE.clear()
        used.clear()
        return _run("cuda", fa, settings, **kw)

    assert run() == want and used == [("FusedEngine", None)]
    assert run(checkpoint=ck) == want and used == [("TableEngine", None)]
    assert run(trim, checkpoint=ck + "t") == want_trim
    assert used == [("DeviceWindowEngine", (1000, 11000))]
    assert run(trim) == want_trim
    assert used == [("FusedEngine", (1000, 11000))]
    # the whole genome (W = n1) does not fit; its windows do
    monkeypatch.setattr(pipeline, "fits", lambda n1, W, *a, **kw: W != n1)
    assert run() == want and used == [("TableEngine", None)]
    monkeypatch.setattr(pipeline, "table_fits", lambda *a, **kw: False)
    for kw in ({}, {"checkpoint": ck + "2"}):
        assert run(**kw) == want
        assert used == [("DeviceWindowEngine", (0, n1 - 1))]
    monkeypatch.setattr(pipeline, "mj_fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "plan_shards", lambda *a: 2)
    with caplog.at_level(logging.WARNING, logger="asgart"):
        assert run() == _jax(fa, s, engine="host", shards=2)
    assert "auto-sharding into 2 trim windows" in caplog.text
    with pytest.raises(NotImplementedError,
                       match="--checkpoint with a genome beyond"):
        run(checkpoint=ck + "3")


def test_wide_k_never_auto_shards(tmp_path, monkeypatch):
    """F11: at k = 21..30 a whole genome beyond the fused build and the
    table raises and names the host engine, as the JAX package keeps
    whole-genome semantics there: the planner gives no windows, however
    much memory is free."""
    fa = _three_chunks(tmp_path)
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "table_fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "free_bytes", lambda device: float("inf"))
    with pytest.raises(NotImplementedError,
                       match="beyond one device's fused build and table at "
                       "probe_size 25 runs on the host engine"):
        _run("cuda", fa, RunSettings(probe_size=25))
    monkeypatch.setattr(pipeline, "table_fits", fused_index.table_fits)
    assert _run("cuda", fa, RunSettings(probe_size=25)) == \
        _jax(fa, RunSettings(probe_size=25), engine="host")


def test_refusals_where_jax_runs_its_host_engine(tmp_path, monkeypatch):
    """F12, the full list: each input where the JAX ``engine="tpu"``
    quietly switches to its host engine (and writes the host engine's
    bytes), while the port's cuda engine raises, naming the host engine
    or the missing device."""
    import asgart_tpu.device_engine as jde
    import asgart_tpu.device_index as jdi

    fa = _cli_genome(tmp_path)

    def jax_tpu_is_host(s, **kw):
        with pytest.MonkeyPatch.context() as mp:
            for mod, name, value in kw.pop("patch", ()):
                mp.setattr(mod, name, value)
            assert _jax(fa, s, engine="tpu", **kw) == \
                _jax(fa, s, engine="host")

    def port_raises(s, match, exc=NotImplementedError, **kw):
        with pytest.raises(exc, match=match):
            _run("cuda", fa, s, **kw)

    no = lambda *a, **kw: False  # noqa: E731
    # k > 30 (asgart_tpu/pipeline.py:137-145)
    k31 = RunSettings(probe_size=31)
    jax_tpu_is_host(k31)
    port_raises(k31, "probe_size > 30 has no device route")
    # a k = 21..30 trim window beyond the fused build (:768-774), and any
    # journaled one (no fused build keeps a journal: :763)
    k25 = RunSettings(probe_size=25, trim=(1000, 11000))
    jax_tpu_is_host(k25, patch=[(jde, "fused_window_applicable", no)])
    jax_tpu_is_host(k25, checkpoint=str(tmp_path / "a"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "fits", no)
        port_raises(k25, "beyond one device's fused build runs on the "
                    "host engine")
    port_raises(k25, "with --checkpoint .* runs on the host engine",
                checkpoint=str(tmp_path / "b"))
    # a k = 22..30 genome beyond the fused build and the table, journaled
    # or not: the JAX SearchEngine builds its ByteIndex on the host
    # (:137-145, :880); at k = 21 it takes its device position tables,
    # which the port runs too (tests/test_torch_seed.py)
    k22 = RunSettings(probe_size=22)
    wide = [(jde, "fused_applicable", no), (jdi, "device_index_fits", no)]
    jax_tpu_is_host(k22, patch=wide)
    jax_tpu_is_host(k22, patch=wide[1:], checkpoint=str(tmp_path / "e"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "fits", no)
        mp.setattr(pipeline, "table_fits", no)
        port_raises(k22, "beyond one device's fused build and table at "
                    "probe_size 22 runs on the host engine")
        port_raises(k22, "--checkpoint with a genome beyond .* host engine",
                    checkpoint=str(tmp_path / "f"))
    # a genome beyond every device route and any S <= 256 (:843-848)
    s = RunSettings(reverse=True, complement=True)
    beyond = [(jde, "fused_applicable", no),
              (jdi, "device_index_fits", no),
              (jdi, "device_window_whole_fits", no),
              (jdi, "device_window_fits", no)]
    jax_tpu_is_host(s, patch=beyond)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("fits", "table_fits", "mj_fits"):
            mp.setattr(pipeline, name, no)
        mp.setattr(pipeline, "plan_shards", lambda *a: None)
        port_raises(s, "fits no device route .* use more --shards or "
                    "engine='host'")
        # --checkpoint beyond the table and the one-window merge join
        # (:786: a journaled run is not auto-sharded)
        port_raises(s, "--checkpoint with a genome beyond .* host engine",
                    checkpoint=str(tmp_path / "c"))
    jax_tpu_is_host(s, patch=beyond[1:3], checkpoint=str(tmp_path / "d"))
    # no device (:869-877); the port's library default is engine="cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        search_duplications([fa], s)
