"""asgart_tpu_torch on ``torch.distributed`` (asgart_tpu_torch/distributed.py,
the counterpart of asgart_tpu/distributed.py): the dryrun with 2 and 4
gloo ranks on the CPU (each rank a worker process running
``search_duplications(engine="cuda", device=cpu)`` under the group) on
asgart_tpu/distributed.py's genome, its trim window through the
rank-sharded window engine and the whole genome through the table
engine's probe-axis scan, every rank's JSON equal to the JAX host
engine's; the route every rank takes from the least free memory of the
group; the ``NotImplementedError`` of each route with no form on ranks;
and the CLI under ``torchrun``'s environment (rank 0 alone writes).
Workers run with one thread each and every wait has a timeout."""

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
# from it, then every refusal.
RANK_SCRIPT = r'''
import json, sys, torch
from asgart_tpu_torch import distributed, pipeline
from asgart_tpu_torch.structs import RunSettings

r, D, port, out, fa = (int(sys.argv[1]), int(sys.argv[2]),
                       int(sys.argv[3]), sys.argv[4], sys.argv[5])
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


def refusal(free, settings=RunSettings(min_duplication_length=800), **kw):
    pipeline.free_bytes = lambda device: free
    try:
        pipeline.search_duplications([fa], settings, engine="cuda",
                                     device=cpu, **kw)
    except NotImplementedError as e:
        return str(e)
    return None


inf = float("inf")
res["shards2"] = refusal(inf, shards=2)
res["shards3"] = refusal(inf, shards=3)
res["checkpoint"] = refusal(inf, checkpoint=f"{out}/journal{r}")
res["trim"] = refusal(inf, RunSettings(trim=(1000, 65000)))
res["k21"] = refusal(1e6, RunSettings(probe_size=21))
res["one_window"] = refusal(5e6)
res["planner"] = refusal(1e6)
with open(f"{out}/rank{r}.json", "w") as fh:
    json.dump(res, fh)
distributed.dist.destroy_process_group()
'''

_RANKS = {}


def _rank_results(tmp_path_factory) -> list:
    """Both ranks' results of RANK_SCRIPT (run once for the module)."""
    if not _RANKS:
        work = tmp_path_factory.mktemp("ranks")
        g, _ = dist_genome()
        fa = work / "genome.fa"
        fa.write_bytes(b">chr1\n" + g + b"\n")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("ASGART_")}
        env.update(WENV, PYTHONPATH=REPO)
        port = distributed._free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), "2", str(port),
             str(work), str(fa)], env=env, cwd=REPO,
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


@pytest.mark.parametrize("case,needle", [
    ("shards2", "MeshWindowEngine"),
    ("shards3", "one after another"),
    ("checkpoint", "--checkpoint"),
    ("trim", "DeviceWindowEngine"),
    ("k21", "SearchEngine"),
    ("one_window", "one-window DeviceWindowEngine"),
    ("planner", "MeshWindowEngine")])
def test_refusals_under_a_group(tmp_path_factory, case, needle):
    """Under a group of 2 ranks every route without a form on ranks
    raises ``NotImplementedError`` naming the JAX engine, on every rank
    alike: ``--shards 2`` (the JAX ``MeshWindowEngine``), ``--shards 3``,
    a journal, a trim window that one card's merge join holds, the k = 21
    whole genome beyond the table, the one-window merge join, and the
    auto-shard planner."""
    a, b = _rank_results(tmp_path_factory)
    assert a[case] is not None and a[case] == b[case]
    assert needle in a[case] and "ROADMAP" in a[case]


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
