"""asgart_tpu_torch on ``torch.distributed`` (asgart_tpu_torch/distributed.py,
the counterpart of asgart_tpu/distributed.py): the dryrun with 2 and 4
gloo ranks on the CPU (each rank a worker process running
``search_duplications(engine="cuda", device=cpu)`` under the group) on
asgart_tpu/distributed.py's genome, its trim window through the
rank-sharded window engine and the whole genome through the table
engine's probe-axis scan, every rank's JSON equal to the JAX host
engine's; the route every rank takes from the least free memory of the
group; each route that the JAX package runs on its mesh or on one device
of it (``--shards``, a journal, a trim window, the k = 21 engine, the
one-window whole genome, the planner), every rank writing the JAX
``engine="tpu"`` bytes; a journal that differs across the ranks raising
on every rank; and the CLI under ``torchrun``'s environment
(rank 0 alone writes). Workers run with one thread each and every wait
has a timeout."""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import pytest

from asgart_tpu_torch import distributed
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import dist_genome, jax_settings, json_text
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WENV = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


@pytest.mark.parametrize("whole", [False, True], ids=["window", "whole"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_equals_jax_host(tmp_path, n_ranks, whole):
    """asgart_tpu/distributed.py's dryrun on gloo ranks: the JAX workers'
    window (rank-sharded, host build) or the whole genome (probe axis);
    every rank's JSON identical and equal to the JAX host engine's."""
    from asgart_tpu.pipeline import search_duplications as jax_search

    g, trim = dist_genome()
    fa = tmp_path / "genome.fa"
    fa.write_bytes(b">chr1\n" + g + b"\n")
    s = RunSettings(min_duplication_length=800,
                    trim=None if whole else trim)
    host = json_text(jax_search([str(fa)], jax_settings(s), engine="host"))
    text, reports = distributed.dryrun(n_ranks, "cpu", fa=str(fa),
                                       settings=s, host=host, env=WENV,
                                       timeout=600)
    assert text == host and json.loads(host)["families"]
    assert [r["rank"] for r in reports] == list(range(n_ranks))
    assert {r["backend"] for r in reports} == {"gloo"}
    ops = {op for r in reports for op, _, _ in r["collectives"]}
    assert ops == ({"all_gather"} if whole else {"all_reduce"})


# Each rank of a 2-rank gloo group: the free memory search_duplications
# routes from (rank 0 sees 1 GB, rank 1 unbounded) and the routes taken
# from it, then each route of the JAX mesh: its JSON and the engines made.
RANK_SCRIPT = r'''
import json, sys, torch
from asgart_tpu_torch import device_engine, distributed, pipeline
from asgart_tpu_torch.exporters import JSONExporter
from asgart_tpu_torch.structs import RunSettings

r, D, port, out, fa, fa2 = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4], sys.argv[5],
                            sys.argv[6])
cpu = torch.device("cpu")
distributed.init(r, D, cpu, f"tcp://127.0.0.1:{port}", timeout_s=120)
res = {}
local = 1e9 if r == 0 else float("inf")
pipeline.free_bytes = lambda device: local
window_route = pipeline._window_route


class Routed(Exception):
    pass


def spy(*a, free=None, **kw):
    res["free"] = free
    raise Routed


pipeline._window_route = spy
try:
    pipeline.search_duplications([fa], RunSettings(trim=(1000, 65000)),
                                 engine="cuda", device=cpu)
except Routed:
    pass
pipeline._window_route = window_route
s = RunSettings(reverse=True, complement=True)
n1 = 100_000_001
res["window"] = window_route(n1, 50_000_001, s, cpu, resident=n1,
                             free=res["free"]).__name__
eng, trim = pipeline._whole_route(n1, s, cpu, False, res["free"])
res["whole"] = [eng.__name__, list(trim)]


used = []
for cls in (pipeline.SearchEngine, device_engine.TableEngine,
            device_engine.DeviceWindowEngine):
    def init(self, *a, _orig=cls.__init__, **kw):
        used.append(type(self).__name__)
        _orig(self, *a, **kw)
    cls.__init__ = init


def run(free, settings=RunSettings(min_duplication_length=800), fa=fa,
        **kw):
    """The search's JSON, the engines it made and its mesh cell."""
    pipeline.free_bytes = lambda device: free
    del used[:]
    prof = {}
    res = pipeline.search_duplications([fa], settings, engine="cuda",
                                       device=cpu, profile=prof, **kw)
    with open(f"{out}/rank{r}.out", "w") as fh:
        JSONExporter().save(res, fh)
    with open(f"{out}/rank{r}.out") as fh:
        return {"json": fh.read(), "engines": sorted(set(used)),
                "mesh": prof.get("mesh")}


inf = float("inf")
res["shards2"] = run(inf, shards=2)
res["shards3"] = run(inf, shards=3)
# a journaled run, then one resumed from its header and first record (rank
# 0 cuts it; the journal is one file for both ranks)
journal = f"{out}/journal"
cold = run(inf, fa=fa2, checkpoint=journal)
distributed.all_min(0.0)  # a barrier
lines = open(journal).read().splitlines()
distributed.all_min(0.0)  # a barrier
if r == 0:
    with open(journal, "w") as fh:
        fh.write("\n".join(lines[:2]) + "\n")
distributed.all_min(0.0)  # a barrier
resumed = run(inf, fa=fa2, checkpoint=journal)
distributed.all_min(0.0)  # a barrier: rank 0 has written the journal
res["checkpoint"] = dict(resumed, cold=cold["json"], records=len(lines) - 1,
                         same=open(journal).read().splitlines() == lines)
# each rank its own journal: rank 0's holds the first record, rank 1's both
own = f"{journal}.{r}"
with open(own, "w") as fh:
    fh.write("\n".join(lines[:2] if r == 0 else lines) + "\n")
try:
    run(inf, fa=fa2, checkpoint=own)
except RuntimeError as e:
    res["journals_differ"] = str(e)
res["own_journal_kept"] = open(own).read().splitlines() == (
    lines[:2] if r == 0 else lines)
res["trim"] = run(inf, RunSettings(trim=(1000, 65000)))
res["k21"] = run(1e6, RunSettings(probe_size=21))
res["one_window"] = run(5e6)
res["planner"] = run(3e6)
try:  # a mesh window that no rank's merge join holds
    run(1e5, shards=2)
except NotImplementedError as e:
    res["too_large"] = str(e)
with open(f"{out}/rank{r}.json", "w") as fh:
    json.dump(res, fh)
distributed.dist.destroy_process_group()
'''

_RANKS = {}


def _journal_genome() -> bytes:
    """asgart_tpu/distributed.py's genome with a 6 kb N run (two chunks)."""
    g, _ = dist_genome()
    return g[:30000] + b"N" * 6000 + g[36000:]


def _rank_results(tmp_path_factory) -> list:
    """Both ranks' results of RANK_SCRIPT (run once for the module)."""
    if not _RANKS:
        work = tmp_path_factory.mktemp("ranks")
        g, _ = dist_genome()
        fa = work / "genome.fa"
        fa.write_bytes(b">chr1\n" + g + b"\n")
        (work / "journal.fa").write_bytes(b">chr1\n" + _journal_genome()
                                          + b"\n")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("ASGART_")}
        env.update(WENV, PYTHONPATH=REPO)
        port = distributed._free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), "2", str(port),
             str(work), str(fa), str(work / "journal.fa")], env=env,
            cwd=REPO,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, err[-3000:]
        _RANKS["res"] = [json.loads((work / f"rank{r}.json").read_text())
                         for r in range(2)]
        _RANKS["work"] = work
    return _RANKS["res"]


def test_route_from_least_free_memory(tmp_path_factory):
    """The group's least free memory decides: ``search_duplications``
    hands both ranks' routes rank 0's 1 GB, which holds neither a 50 M-row
    window's merge join nor the 100 Mbp genome's table, but holds their
    rank-sharded shards, so both ranks take the rank-sharded engine (rank
    1 alone, unbounded, would have routed elsewhere)."""
    a, b = _rank_results(tmp_path_factory)
    assert a["free"] == b["free"] == 1e9
    assert a["window"] == b["window"] == "ShardedWindowEngine"
    assert a["whole"] == b["whole"] == ["ShardedWindowEngine",
                                        [0, 100_000_000]]


# (the test ids of the cases when each of them was a refusal)
@pytest.mark.parametrize("case,engine", [
    ("shards2", "MeshWindowEngine"), ("shards3", "DeviceWindowEngine"),
    ("checkpoint", "TableEngine"), ("trim", "DeviceWindowEngine"),
    ("k21", "SearchEngine"), ("one_window", "DeviceWindowEngine"),
    ("planner", "MeshWindowEngine")], ids=[
    "shards2-MeshWindowEngine", "shards3-one after another",
    "checkpoint---checkpoint", "trim-DeviceWindowEngine",
    "k21-SearchEngine", "one_window-one-window DeviceWindowEngine",
    "planner-MeshWindowEngine"])
def test_refusals_under_a_group(tmp_path_factory, case, engine):
    """Under a group of 2 ranks each route that the JAX package runs on
    its mesh or on one device of it runs on every rank, and both ranks
    write the JAX ``engine="tpu"`` run's bytes: ``--shards 2`` on the 2 x 1
    windows x probes mesh; ``--shards 3`` (3 windows do not tile 2 ranks)
    one window after another, each on the merge-join engine of every
    rank; a journal on the table engine's probe-axis scan, cold and then
    resumed from its first record (rank 0 the one writer: the journal ends
    as the cold run left it); a trim window that one card's merge join
    holds, on every rank's merge-join engine; the k = 21 whole genome
    beyond the table on every rank's ``SearchEngine``; the one-window
    merge join; and the auto-shard planner's windows on the mesh, held to
    the JAX ``--shards`` run with the planner's S."""
    from asgart_tpu.pipeline import search_duplications as jax_search

    a, b = _rank_results(tmp_path_factory)
    got = a[case]
    # the same bytes and engines on both ranks (each its own mesh cell)
    assert {k: v for k, v in got.items() if k != "mesh"} == \
        {k: v for k, v in b[case].items() if k != "mesh"}
    assert got["engines"] == [engine]
    _, trim = dist_genome()
    fa = _RANKS["work"] / ("journal.fa" if case == "checkpoint" else
                           "genome.fa")  # the ranks' FASTA (its name is
    #                                      in the JSON)
    s = RunSettings(min_duplication_length=800)
    kw = {}
    if case == "trim":
        s = RunSettings(trim=trim)
    elif case == "k21":
        s = RunSettings(probe_size=21)
    elif case in ("shards2", "shards3", "planner"):
        kw["shards"] = got["mesh"]["S"] if case == "planner" else \
            int(case[-1])
    want = json_text(jax_search([str(fa)], jax_settings(s), engine="tpu",
                                **kw))
    assert got["json"] == want and json.loads(want)["families"]
    if engine == "MeshWindowEngine":
        assert [(x[case]["mesh"]["S"], x[case]["mesh"]["P"],
                 x[case]["mesh"]["w"]) for x in (a, b)] == [(2, 1, 0),
                                                            (2, 1, 1)]
    else:
        assert got["mesh"] is None and b[case]["mesh"] is None
    if case == "checkpoint":
        assert got["cold"] == want and got["records"] == 2 and got["same"]


def test_mesh_window_no_rank_holds_raises_on_every_rank(tmp_path_factory):
    """``--shards 2`` on 2 ranks whose least free memory (100 kB) holds
    no window's merge join: every rank raises the same refusal (the group
    agreed the free memory), and no rank goes on alone."""
    a, b = _rank_results(tmp_path_factory)
    assert a["too_large"] == b["too_large"]
    assert "2 x 1 mesh" in a["too_large"] and "fits no device route" in \
        a["too_large"]


def test_journals_that_differ_raise_on_every_rank(tmp_path_factory):
    """A journaled run whose ranks read different journals (rank 0's
    holds one record, rank 1's both) raises on every rank before any
    chunk runs, and rank 0 leaves its journal as it was."""
    a, b = _rank_results(tmp_path_factory)
    assert a["journals_differ"] == b["journals_differ"].replace(
        "journal.1", "journal.0")
    assert "different checkpoint journals" in a["journals_differ"]
    assert a["own_journal_kept"] and b["own_journal_kept"]


def test_cli_rank0_alone_writes(tmp_path, monkeypatch):
    """Under ``torchrun``'s environment (``WORLD_SIZE`` 2) the CLI's rank 1
    writes nothing and rank 0 writes ``--out`` (the host engine needs no
    group); ``--hosts`` is refused there."""
    from asgart_tpu_torch.cli.main import main

    g, _ = dist_genome()
    fa = tmp_path / "genome.fa"
    fa.write_bytes(b">chr1\n" + g + b"\n")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for rank in (1, 0):
        monkeypatch.setenv("RANK", str(rank))
        out = tmp_path / f"out{rank}.json"
        assert main([str(fa), "--min-length", "800", "--threads", "1",
                     "--out", str(out)]) == 0
        assert out.exists() == (rank == 0)
    assert main([str(fa), "--hosts", "2", "--out",
                 str(tmp_path / "h.json")]) == 1
