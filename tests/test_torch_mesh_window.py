"""The windows x probes mesh engine (asgart_tpu_torch
``device_engine.MeshWindowEngine``) against the JAX ``MeshWindowEngine``
(asgart_tpu/device_engine.py:2903) and its four programs on the
conftest's virtual 8-device mesh at (S, P) = (2, 4) and (4, 2), direct
and -RC: each cell (w, p) of the port, computed in this process through
the functions a rank calls, equals the JAX cell of ``_mesh_window_ranges``
and ``_mesh_window_core`` (one chunk a dispatch) and of
``_mesh_ranges_batch`` and ``_mesh_window_core_off`` (every chunk in one
dispatch); each window's cells merged in p order equal the one-rank
merge-join engine's result on that window; :func:`pipeline.window_layout`
on the JAX condition's edge cases; and gloo ranks on the CPU
(``distributed.dryrun``) writing the JAX ``engine="tpu"`` ``--shards``
JSON and the host engine's, on the mesh and the sequential form, and
journaled, cold and resumed. Exact (integers, JSON bytes; tolerance 0).

The genome is ``torch_jax_ref.mesh_genome`` at k = 8: its 220 kb chunk
has 54,997 lanes in a 65,536-lane bucket, so every probe slot of 2 and
of 4 scans some, and its 60 kb chunk's 14,997 lanes all fall to p = 0."""

import json

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch import distributed
from asgart_tpu_torch.device_engine import (DeviceWindowEngine,
                                            MeshWindowEngine, Sliced,
                                            chunk_specs, merge_slices)
from asgart_tpu_torch.pipeline import plan_windows, window_layout
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import jax_settings, json_text, mesh_genome, prepared
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)
from util import random_dna, revcomp

CPU = torch.device("cpu")
WENV = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
SHAPES = [(2, 4), (4, 2)]
RC = [False, True]


def _settings(rc: bool) -> RunSettings:
    return RunSettings(probe_size=8, reverse=rc, complement=rc,
                       min_duplication_length=800)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return prepared(tmp_path_factory.mktemp("mesh"),
                    [("chr1", mesh_genome())])


def _cell(res):
    """One cell's ScanResult (a sliced one merged)."""
    return merge_slices(list(res)) if isinstance(res, Sliced) else res


_JAX = {}


def _jax_engine(fa, S: int, rc: bool):
    """The JAX ``MeshWindowEngine`` on the (S, 8 / S) mesh of the
    conftest's devices, and its chunks (built once a module)."""
    if (S, rc) not in _JAX:
        from jax.sharding import Mesh

        from asgart_tpu.device_engine import MeshWindowEngine as JaxMesh
        from asgart_tpu.fasta import prepare_data

        _, chunks, strand = prepare_data([fa], False, None)
        windows = plan_windows(len(strand.data) - 1, S)
        mesh = Mesh(np.array(jax.devices()).reshape(S, 8 // S),
                    ("windows", "probes"))
        _JAX[(S, rc)] = (JaxMesh(strand, jax_settings(_settings(rc)),
                                 windows, mesh), chunks)
    return _JAX[(S, rc)]


def _jax_cells(jeng, chunks, batched: bool) -> list:
    """The JAX cells' outputs for each live chunk: [(chunk, b_local, lo,
    hi, mask, ev, mf, sc)], lo/hi/mask [S, P, b_local] and the core's
    outputs [S, P, ...] as numpy; one chunk a dispatch
    (``_mesh_window_ranges``, ``_mesh_window_core``) or every chunk in
    one (``_mesh_ranges_batch``, ``_mesh_window_core_off``), as
    ``run_windows`` calls them, with the event capacity at b_local (no
    retry)."""
    import jax.numpy as jnp

    from asgart_tpu import device_engine as jde

    s = jeng.settings
    k = s.probe_size
    live = [(c, jeng._geometry(c)) for c in chunks]
    live = [(c, g) for c, g in live if g is not None]
    if batched:
        specs = tuple((int(c[0]), int(c[1]), g[1]) for c, g in live)
        b_locals = tuple(g[1] for _, g in live)
        total = sum(b_locals) + max(b_locals) + 8
        lo_all, hi_all, mask_all, tot = jde._mesh_ranges_batch(
            jeng.mesh, k, s.reverse, s.complement, int(jeng.first_len),
            specs, total, b_locals)(jeng.key_hi, jeng.key_lo, jeng.codes)
    out, off = [], 0
    for i, (c, (_, b_local, _)) in enumerate(live):
        if batched:
            cap = jde._cap_bucket(int(np.asarray(tot)[:, :, i].max()) + 1)
            core = jde._mesh_window_core_off(jeng.mesh, k, s.reverse,
                                             b_local, cap, b_local)
            ev, mf, sc = core(lo_all, hi_all, mask_all, jeng.sa,
                              jnp.int32(off), jnp.int32(c[0]),
                              jnp.int32(c[1]), jnp.int32(s.max_cardinality))
            lo, hi, mask = (np.asarray(a)[:, :, off: off + b_local]
                            for a in (lo_all, hi_all, mask_all))
            off += b_local
        else:
            lo, hi, mask, tot1 = jde._mesh_window_ranges(
                jeng.mesh, k, s.reverse, s.complement, b_local)(
                jeng.key_hi, jeng.key_lo, jeng.codes, jnp.int32(c[0]),
                jnp.int32(c[1]), jnp.int32(jeng.first_len))
            cap = jde._cap_bucket(int(np.asarray(tot1).max()) + 1)
            core = jde._mesh_window_core(jeng.mesh, k, s.reverse, b_local,
                                         cap, b_local)
            ev, mf, sc = core(lo, hi, mask, jeng.sa, jnp.int32(c[0]),
                              jnp.int32(c[1]), jnp.int32(s.max_cardinality))
            lo, hi, mask = (np.asarray(a) for a in (lo, hi, mask))
        out.append((tuple(c), b_local, lo, hi, mask, np.asarray(ev),
                    np.asarray(mf), np.asarray(sc)))
    return out


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("rc", RC, ids=["direct", "rc"])
@pytest.mark.parametrize("S,P", SHAPES)
def test_cells_equal_jax_mesh_programs(genome, S, P, rc, batched):
    """Cell (w, p) of the port (a ``MeshWindowEngine`` made for rank w·P +
    p of S·P; its stage 1 over the cell's lanes, then KD's plain version
    over them) equals the JAX cell: lo, hi and mask on the cell's lanes
    (the JAX lanes past the chunk's end masked out), the first n_events
    events and total_kept matches (the port's window positions plus the
    window start equal the JAX genome positions), and n_events,
    total_kept and z_trail. "one": each live chunk alone, as the JAX
    ``_run_one`` (K17f, K17i); "batch": every chunk in one pass, as
    ``_run_batched`` (K17g, K17h)."""
    fa, chunks, strand = genome
    s = _settings(rc)
    jeng, jchunks = _jax_engine(fa, S, rc)
    assert [tuple(c) for c in jchunks] == [tuple(c) for c in chunks]
    jcells = _jax_cells(jeng, jchunks, batched)
    specs = {(cs, cl): nc for cs, cl, nc in chunk_specs(chunks, s)}
    assert len(jcells) == len(specs) == 2
    windows = plan_windows(len(strand.data) - 1, S)
    assert [list(w) for w in windows] == [list(w) for w in jeng.windows]
    slots = set()
    for w in range(S):
        for p in range(P):
            eng = MeshWindowEngine(strand, s, CPU, windows, r=w * P + p,
                                   D=S * P)
            assert (eng.w, eng.p, eng.trim) == (w, p, windows[w])
            for chunk, b_local, lo, hi, mask, ev, mf, sc in jcells:
                todo = list(chunks) if batched else [chunk]
                ranges = eng.stage1(todo)
                off, _ = ranges.offs[chunk]
                a, b = eng.part(specs[chunk])
                assert a == min(specs[chunk], p * b_local)
                n = b - a
                for got, want in ((ranges.lane_lo, lo), (ranges.lane_hi, hi),
                                  (ranges.lane_mask, mask)):
                    assert np.array_equal(got[off + a: off + b].numpy(),
                                          want[w, p, :n]), (w, p, chunk)
                assert not mask[w, p, n:].any()
                res = _cell(list(eng.scan_results(todo, part=eng.part))[
                    [tuple(c) for c in todo].index(chunk)])
                e, m, z_trail = res.to_host()
                n_ev, kept, jz, overflow = sc[w, p].tolist()
                assert (res.n_events, res.total_kept, z_trail, 0) == \
                    (n_ev, kept, jz, overflow), (w, p, chunk)
                assert np.array_equal(e, ev[w, p][:, :n_ev])
                assert np.array_equal(m.astype(np.int64) + windows[w][0],
                                      mf[w, p][:kept])
                if chunk == tuple(chunks[0]) and n:
                    slots.add(p)
    # every probe slot scans lanes of the 220 kb chunk
    assert slots == set(range(P))


@pytest.mark.parametrize("budget", [None, 20000])
@pytest.mark.parametrize("rc", RC, ids=["direct", "rc"])
@pytest.mark.parametrize("S,P", SHAPES)
def test_cells_merged_equal_one_rank(genome, monkeypatch, S, P, rc, budget):
    """Each window's P cells merged in p order (``merge_slices``, as every
    rank merges them after the gather) equal the one-rank
    ``DeviceWindowEngine``'s result on that window, bit for bit; also with
    the cells' lanes sliced at a small budget."""
    fa, chunks, strand = genome
    s = _settings(rc)
    windows = plan_windows(len(strand.data) - 1, S)
    events = 0
    for w in range(S):
        one = DeviceWindowEngine(strand, s, CPU, windows[w], cache=None)
        want = [None if r is None else _cell(r)
                for r in one.scan_results(chunks)]
        if budget is not None:
            monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", str(budget))
        engs = [MeshWindowEngine(strand, s, CPU, windows, r=w * P + p,
                                 D=S * P) for p in range(P)]
        cells = [[None if r is None else _cell(r)
                  for r in e.scan_results(chunks, part=e.part)]
                 for e in engs]
        monkeypatch.delenv("ASGART_DEVICE_SLICE_LANES", raising=False)
        for c, wnt in enumerate(want):
            got = merge_slices([cells[p][c] for p in range(P)])
            assert (got.n_events, got.total_kept) == (wnt.n_events,
                                                      wnt.total_kept)
            assert torch.equal(got.flat, wnt.flat), (w, c)
            events += wnt.n_events
    assert events > 0


def test_window_layout_edges():
    """:func:`window_layout` is the JAX condition (asgart_tpu/pipeline.py:
    408-409) on the windows left after empty ones are dropped: a mesh only
    with more than one rank, at least one rank a window and the windows
    dividing the ranks; a genome whose last window is empty has fewer
    windows than shards, and its layout follows the windows."""
    def jax_mesh(n_dev, n_windows):
        return n_dev > 1 and n_dev >= n_windows and n_dev % n_windows == 0

    for n_dev in range(1, 13):
        for n_windows in range(1, 13):
            form, S, P = window_layout(n_dev, n_windows)
            assert (form == "mesh") == jax_mesh(n_dev, n_windows)
            assert S == n_windows
            assert P == (n_dev // n_windows if form == "mesh" else 1)
    assert window_layout(1, 1) == ("sequential", 1, 1)
    assert window_layout(8, 4) == ("mesh", 4, 2)
    assert window_layout(8, 8) == ("mesh", 8, 1)
    assert window_layout(3, 4) == ("sequential", 4, 1)
    assert window_layout(4, 3) == ("sequential", 3, 1)
    # 9 bases in 4 shards of 3: the last window (9, 9) is empty, so 3
    # windows, which 3 ranks tile and 4 ranks do not
    windows = plan_windows(9, 4)
    assert windows == [(0, 3), (3, 6), (6, 9)]
    assert window_layout(3, len(windows)) == ("mesh", 3, 1)
    assert window_layout(4, len(windows)) == ("sequential", 3, 1)
    assert window_layout(6, len(windows)) == ("mesh", 3, 2)


def _boundary_genome() -> bytes:
    """tests/test_mesh_sharded.py's 48 kb genome with its copies
    reverse-complemented: right arms across the 2- and 4-window
    boundaries (24000, 12000)."""
    rng = np.random.default_rng(21)
    g = bytearray(random_dna(rng, 48000, b"ACGT"))
    g[23000:25500] = revcomp(bytes(g[1000:3500]))
    g[11000:13000] = revcomp(bytes(g[30000:32000]))
    g[5000:7000] = bytes(g[40000:42000])
    return bytes(g)


@pytest.mark.parametrize("case", ["mesh2x2_k12_rc", "mesh4x1_rc",
                                  "seq3_direct"])
def test_dryrun_shards_equal_jax_and_host(genome, tmp_path, case):
    """Gloo ranks on the CPU (``distributed.dryrun``) with ``--shards``:
    4 ranks at 2 windows (the 2 x 2 mesh, on this module's genome at k =
    12, where its planted pairs stand out of the random matches and both
    probe slots of a window scan lanes), 4 ranks at 4 windows (4 x 1,
    -RC, arms across the window boundaries) and 2 ranks at 3 windows (the
    windows one after another on every rank). Every rank's JSON is the
    JAX ``engine="tpu"`` ``--shards`` run's and the host engine's."""
    from asgart_tpu.pipeline import search_duplications as jax_search

    n_ranks, shards = {"mesh2x2_k12_rc": (4, 2), "mesh4x1_rc": (4, 4),
                       "seq3_direct": (2, 3)}[case]
    if case == "mesh2x2_k12_rc":
        fa, chunks, _ = genome
        s = RunSettings(probe_size=12, reverse=True, complement=True,
                        min_duplication_length=800)
    else:
        fa, chunks, _ = prepared(tmp_path, [("chr1", _boundary_genome())])
        rc = case == "mesh4x1_rc"
        s = RunSettings(reverse=rc, complement=rc,
                        min_duplication_length=800)
    want = json_text(jax_search([fa], jax_settings(s), engine="tpu",
                                shards=shards))
    host = json_text(jax_search([fa], jax_settings(s), engine="host",
                                shards=shards))
    assert want == host and json.loads(host)["families"]
    text, reports = distributed.dryrun(n_ranks, "cpu", fa=fa, settings=s,
                                       host=host, env=WENV, timeout=600,
                                       shards=shards)
    assert text == want
    if case == "seq3_direct":
        assert all("mesh" not in r["profile"] for r in reports)
        assert all(not r["collectives"] for r in reports)
        return
    P = n_ranks // shards
    cells = [r["profile"]["mesh"] for r in reports]
    assert [(c["w"], c["p"], c["S"], c["P"]) for c in cells] == \
        [(r // P, r % P, shards, P) for r in range(n_ranks)]
    # one all_gather of each cell's buffer and one of its sizes, a chunk
    assert all(len(r["collectives"]) == 2 * len(chunks) for r in reports)
    if case == "mesh2x2_k12_rc":
        assert all(c["lanes"][0] > 0 for c in cells)  # both slots scan


def test_dryrun_journal_cold_and_resumed(tmp_path):
    """``--checkpoint`` on 2 gloo ranks (the table engine's probe-axis
    scan, rank 0 the journal's one writer): a cold run, then a run resumed
    from the journal cut to its header and first chunk, both writing the
    JAX ``engine="tpu"`` run's JSON and the host engine's; the resumed
    run rescans the second chunk and the journal ends as the cold one."""
    from asgart_tpu.pipeline import search_duplications as jax_search

    g = bytearray(_boundary_genome())
    g[20000:26000] = b"N" * 6000  # two chunks
    fa, chunks, _ = prepared(tmp_path, [("chr1", bytes(g))])
    assert len(chunks) == 2
    s = RunSettings(reverse=True, complement=True,
                    min_duplication_length=800)
    want = json_text(jax_search([fa], jax_settings(s), engine="tpu"))
    host = json_text(jax_search([fa], jax_settings(s), engine="host"))
    assert want == host and json.loads(host)["families"]
    journal = tmp_path / "run.journal"
    text, reports = distributed.dryrun(2, "cpu", fa=fa, settings=s,
                                       host=host, env=WENV, timeout=600,
                                       checkpoint=str(journal))
    assert text == want
    lines = journal.read_text().splitlines()
    assert len(lines) == 3  # the header and one record a chunk
    journal.write_text("\n".join(lines[:2]) + "\n")
    text, reports = distributed.dryrun(2, "cpu", fa=fa, settings=s,
                                       host=host, env=WENV, timeout=600,
                                       checkpoint=str(journal))
    assert text == want
    assert journal.read_text().splitlines() == lines
    # the rescanned chunk's two all_gathers on each rank
    assert all(len(r["collectives"]) == 2 for r in reports)
