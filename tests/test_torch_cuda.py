"""The CUDA kernels against their plain PyTorch versions on the GPU, for
every transform and k in {8, 20} (one-word keys) and {25, 30} (two-word
keys), KA's window mode on trim windows (whose suffix order keeps window
positions, scanned by KD with rebased constants), the merge-join window
engine's kernels (KA's probe-only mode and window keys, KC with no lanes,
KH with and without its key directory, the directory against its plain
version at its edges and on a shard, KD with rebased constants on its
window-relative index), KI, the table engine's (KA's doubled mode, KB's N
flag and run ends, KJ, the table form of KC's scatter, also at the
bucket's and the tile's edges and with its launch counts, KK / KL at a
small ``tied_cap``, KM, KD on its lanes), KA's tiles at their tile,
chunk and k edges in every mode, KE's sort and sizing pass at their group
and tile edges and KO on views at every lane offset, KL's in-order pass and KC scatter at
their edges (rank compared), KK's keys in position order at its row and
alignment edges, the directory kernel at its thread, warp and block edges
(its flag read by ``check``), and the port's JSON on the GPU
against the host engine (whole genome, trim windows and ``shards``, on the
fused build, on the table engine with and without ``--checkpoint``, on
the merge-join engine with its route chosen by free memory alone, and past
int32 addressing), the sliced dispatch of a repeat-heavy chunk (KO
and KP against their plain versions, a sliced scan against one unsliced
KD launch, and the JSON of sliced runs on both chains and journaled), and
the seed lookups (KQ, KR and KS against their plain versions, with empty
inputs, no buckets and wide buckets; KQ also against two
``torch.searchsorted`` calls, on runs that end at a bucket's last row,
empty buckets and every ``steps`` from 1, and its check in the kernel;
``SearchEngine(engine="cuda")`` and
the k = 21 route against the host engine), and the rank-sharded window
engine on one rank (KT against its plain version on every shard, and its
JSON against the host engine), and gloo ranks sharing the GPU on the
windows x probes mesh and on a journaled run (their JSON against the
one-device run's). The
kernels have no CPU mode, so without a CUDA GPU these tests skip. On a
machine with a GPU (and without jax, which tests/conftest.py imports),
run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Exact comparisons (integers; tolerance 0). No jax is imported here.
"""

import numpy as np
import pytest
import torch

from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import (TRANSFORMS, chunked_genome, granule_lanes,
                           json_text, prepared, satellite_genome,
                           vocab_genome)

pytestmark = pytest.mark.cuda
# the table engine's kernels, which only its build and scan launch, KN,
# which runs only with ASGART_DEVICE_CHAIN set, and KO / KP, which run
# only on chunks whose raw totals reach the slice budget
TABLE_KERNELS = ("invert_tables", "table_ranges", "full_round_keys",
                 "full_round_refine")
CHAIN_KERNELS = ("chain_bursts",)
SLICE_KERNELS = ("granule_totals", "gather_flat")
# the seed lookups, which only SearchEngine(engine="cuda") launches (and KS
# no pipeline)
SEED_KERNELS = ("equal_range", "gather_ranges", "pack_probe_planes")
# KT, which only the rank-sharded window engine launches
SHARD_KERNELS = ("gather_owned",)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("k", [20, 8, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse, complement, k):
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fused_index import fused_layout, sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          launch_counts, pack_keys,
                                          scan_core, tie_groups, tie_keys,
                                          tie_refine)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import (fused_bases,
                                                    scan_core_plain)
    from asgart_tpu_torch.kernels.ties import (tie_groups_plain,
                                               tie_keys_plain,
                                               tie_refine_plain)
    from asgart_tpu_torch.ties import resolve_ties

    g = bytearray(chunked_genome())
    g[500:560] = g[20500:20560]  # a direct repeat for direct runs
    _, chunks, strand = prepared(tmp_path, [("chr1", bytes(g))])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    W, total, lane_off = fused_layout(n1, specs)
    before = launch_counts()

    codes = torch.from_numpy(CODE[strand.data]).to(gpu)
    keys, mask = pack_keys(codes, specs, k, reverse, complement, W, total)
    want_keys, want_mask = pack_keys_plain(
        codes, *chunk_tables(specs, n1, k, reverse, complement), k,
        reverse, complement, W, total)
    assert len(keys) == (1 if k <= 20 else 2)
    _equal((*keys, mask), (*want_keys, want_mask))
    skeys, sa = sort_keys(keys)
    bounds = group_bounds(skeys, sa, W)
    _equal(bounds, group_bounds_plain(skeys, sa, W))
    run_lo, run_hi, tied = bounds
    inv = invert_fused(sa, run_lo, run_hi, mask, W, lane_off)
    _equal(inv, invert_fused_plain(sa, run_lo, run_hi, mask, W, lane_off))
    rank, lane_lo, lane_hi, _ = inv
    # KE / KF on the first tie round, each side on its own sa/rank copies
    slots = torch.nonzero(tied).flatten()
    assert slots.numel() > 0
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(torch.int32)
    bad = [torch.zeros(1, dtype=torch.int32, device=gpu) for _ in "kp"]
    want = tie_keys_plain(ps, prims, rank, k, bad[1])
    largest = [torch.zeros(1, dtype=torch.int32, device=gpu) for _ in "kp"]
    tie_groups(prims, largest[0])
    tie_groups_plain(prims, largest[1])
    _equal(largest[:1], largest[1:])
    # KE's two routes: the key pass and the library's sort, then its sort
    for g in (None, int(largest[0])):
        _equal((*tie_keys(ps, prims, rank, k, bad[0], g), bad[0]),
               (*want, bad[1]))
    assert int(bad[0]) == 0
    skey, order = want
    sa_k, rank_k, sa_p, rank_p = sa.clone(), rank.clone(), sa.clone(), \
        rank.clone()
    cnt = [torch.zeros(2, dtype=torch.int32, device=gpu) for _ in "kp"]
    got = tie_refine(skey, order, slots, ps, sa_k, rank_k, cnt[0])
    want = tie_refine_plain(skey, order, slots, ps, sa_p, rank_p, cnt[1])
    m = int(cnt[1][0])
    _equal((cnt[0], sa_k, rank_k, *(t[:m] for t in got)),
           (cnt[1], sa_p, rank_p, *(t[:m] for t in want)))
    sa = resolve_ties(sa, rank, tied, W + total, k)
    n_events = 0
    for c, (cs, cl, nc) in enumerate(specs):
        lanes = slice(lane_off[c], lane_off[c] + nc)
        for max_card in (500, 1):
            args = (lane_lo[lanes], lane_hi[lanes], mask[lanes], sa,
                    *fused_bases(cs, cl), max_card, 0, k, reverse)
            got, want = scan_core(*args), scan_core_plain(*args)
            assert (got.n_events, got.total_kept) == \
                (want.n_events, want.total_kept)
            _equal((got.flat,), (want.flat,))
            n_events += got.n_events
    torch.cuda.synchronize()
    after = launch_counts()
    # KH and its directory run on the merge-join engine
    # (test_mj_kernels_equal_plain_on_gpu),
    # KI in upload_codes (test_unpack_codes_equal_plain_on_gpu), KJ, KM, KK
    # and KL on the table engine (test_table_kernels_equal_plain_on_gpu)
    assert all(after[name] > before[name] for name in after
               if name not in ("mj_ranges", "mj_directory", "unpack_codes",
                               *TABLE_KERNELS, *CHAIN_KERNELS,
                               *SLICE_KERNELS, *SEED_KERNELS,
                               *SHARD_KERNELS))
    if reverse == complement:
        assert n_events > 0


def test_gpu_json_equals_host_k25(tmp_path, gpu):
    """Two-word keys end to end: the library and the CLI (``-k 25
    --engine cuda``) write the host engine's bytes."""
    from asgart_tpu_torch.cli.main import main
    from asgart_tpu_torch.pipeline import search_duplications

    for genome in ("chunked", "vocab"):
        g = chunked_genome() if genome == "chunked" else vocab_genome()
        fa, _, _ = prepared(tmp_path, [("chr1", g)])
        for reverse, complement in TRANSFORMS:
            s = RunSettings(reverse=reverse, complement=complement,
                            probe_size=25)
            host = json_text(search_duplications([fa], s, engine="host"))
            port = json_text(search_duplications([fa], s, engine="cuda",
                                                 device=gpu))
            assert port == host
        outs = [tmp_path / f"{genome}_{e}.json" for e in ("host", "cuda")]
        for engine, out in zip(("host", "cuda"), outs):
            assert main([fa, "-R", "-C", "-k", "25", "--engine", engine,
                         "--out", str(out)]) == 0
        assert outs[0].read_text() == outs[1].read_text()


@pytest.mark.parametrize("genome", ["chunked", "vocab"])
def test_gpu_json_equals_host(tmp_path, gpu, genome):
    from asgart_tpu_torch.pipeline import search_duplications

    g = chunked_genome() if genome == "chunked" else vocab_genome()
    fa, _, _ = prepared(tmp_path, [("chr1", g)])
    for reverse, complement in TRANSFORMS:
        s = RunSettings(reverse=reverse, complement=complement)
        host = json_text(search_duplications([fa], s, engine="host"))
        port = json_text(search_duplications([fa], s, engine="cuda",
                                             device=gpu))
        assert port == host


@pytest.mark.parametrize("k", [20, 8, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_window_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse,
                                           complement, k):
    """KA in window mode on a window with ws > 0 against its plain version;
    the window build on the GPU (window positions) equals the CPU build,
    and KD over it with the rebased constants equals its plain version."""
    from asgart_tpu_torch.device_engine import chunk_specs, rebased_bases
    from asgart_tpu_torch.fused_index import FusedIndex, fused_layout
    from asgart_tpu_torch.kernels import launch_counts, pack_keys, scan_core
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain

    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    ws, we = 19000, 46000
    W, total, _ = fused_layout(we - ws + 1, specs)
    before = launch_counts()
    codes = torch.from_numpy(CODE[strand.data]).to(gpu)
    keys, mask = pack_keys(codes, specs, k, reverse, complement, W, total,
                           ws)
    want_keys, want_mask = pack_keys_plain(
        codes, *chunk_tables(specs, n1, k, reverse, complement), k,
        reverse, complement, W, total, ws)
    _equal((*keys, mask), (*want_keys, want_mask))
    got = FusedIndex.build(strand.data, k, specs, reverse, complement, gpu,
                           trim=(ws, we))
    ref = FusedIndex.build(strand.data, k, specs, reverse, complement,
                           torch.device("cpu"), trim=(ws, we))
    _equal((got.sa, got.lane_lo, got.lane_hi, got.lane_mask),
           (ref.sa, ref.lane_lo, ref.lane_hi, ref.lane_mask))
    assert got.offs == ref.offs
    assert int(got.sa[got.sa < we - ws + 1].numel()) == we - ws + 1
    for (cs, cl, nc) in specs:
        off = got.offs[(cs, cl)][0]
        lanes = slice(off, off + nc)
        args = (got.lane_lo[lanes], got.lane_hi[lanes], got.lane_mask[lanes],
                got.sa, *rebased_bases(cs, cl, ws, we - ws + 1), 500, 0, k,
                reverse)
        res, want = scan_core(*args), scan_core_plain(*args)
        assert (res.n_events, res.total_kept) == \
            (want.n_events, want.total_kept)
        _equal((res.flat,), (want.flat,))
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[name] > before[name] for name in after
               if name not in ("mj_ranges", "mj_directory", "unpack_codes",
                               *TABLE_KERNELS, *CHAIN_KERNELS,
                               *SLICE_KERNELS, *SEED_KERNELS,
                               *SHARD_KERNELS))


@pytest.mark.parametrize("k", [20, 25])
def test_gpu_trim_and_shards_json_equal_host(tmp_path, gpu, k):
    """Trim windows and shards end to end on the GPU, and the CLI's
    ``--trim`` and ``--shards``, write the host engine's bytes."""
    from asgart_tpu_torch.cli.main import main
    from asgart_tpu_torch.pipeline import search_duplications

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    for reverse, complement in TRANSFORMS:
        for trim in ((0, 30000), (400, 52000), (35000, 60000)):
            s = RunSettings(reverse=reverse, complement=complement,
                            probe_size=k, trim=trim)
            host = json_text(search_duplications([fa], s, engine="host"))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu)) == host
        s = RunSettings(reverse=reverse, complement=complement,
                        probe_size=k)
        for shards in (2, 3):
            host = json_text(search_duplications([fa], s, engine="host",
                                                 shards=shards))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu, shards=shards)) == host
    for flags in (["--trim", "400", "52000"], ["--shards", "3"]):
        outs = [tmp_path / f"{e}.json" for e in ("host", "cuda")]
        for engine, out in zip(("host", "cuda"), outs):
            assert main([fa, "-R", "-C", "-k", str(k), *flags, "--engine",
                         engine, "--out", str(out)]) == 0
        assert outs[0].read_text() == outs[1].read_text()


def test_gpu_fused_windows_json_equal_host(tmp_path, gpu, monkeypatch):
    """The fused trim window at k = 25 and a fused ``--shards 4`` run at k
    = 20, -RC: both route to ``FusedEngine``, whose windows keep window
    positions (scanned with the rebased constants, the window start added
    to the matches), write the host engine's bytes, and launch every
    kernel of the fused window path."""
    from asgart_tpu_torch import device_engine
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import search_duplications

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    seen = []
    scan = device_engine.FusedEngine.scan_results

    def spy(self, chunks):
        seen.append((self.trim, self.m_offset))
        return scan(self, chunks)

    monkeypatch.setattr(device_engine.FusedEngine, "scan_results", spy)
    window = ("pack_keys", "group_bounds", "invert_fused", "tie_keys",
              "tie_refine", "scan_core")
    for k, kw in ((25, dict(trim=(400, 52000))), (20, {})):
        s = RunSettings(reverse=True, complement=True, probe_size=k, **kw)
        shards = {} if kw else dict(shards=4)
        host = json_text(search_duplications([fa], s, engine="host",
                                             **shards))
        INDEX_CACHE.clear()
        seen.clear()
        before = launch_counts()
        assert json_text(search_duplications([fa], s, engine="cuda",
                                             device=gpu, **shards)) == host
        after = launch_counts()
        assert all(after[name] > before[name] for name in window)
        assert seen and all(t is not None and m == t[0] for t, m in seen)
        assert len({t for t, _ in seen}) == (1 if kw else 4)
    INDEX_CACHE.clear()


@pytest.mark.parametrize("k", [20, 8])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_mj_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse, complement,
                                       k):
    """The merge-join engine's kernels on a window with ws > 0: KA's window
    keys and probe-only mode, KC with no lanes and KH, each against its
    plain version; the window index and stage 1 on the GPU equal the CPU's."""
    from asgart_tpu_torch.device_engine import DeviceWindowEngine, chunk_specs
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          launch_counts, mj_ranges, pack_keys)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.merge_join import mj_ranges_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    _, chunks, strand = prepared(tmp_path, [("chr1", bytes(g))])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = chunk_specs(chunks, s)
    n1 = len(strand.data)
    ws, we = 19000, 46000
    W = we - ws + 1
    tabs = chunk_tables(specs, n1, k, reverse, complement)
    total = tabs[0][-1]
    before = launch_counts()
    codes = torch.from_numpy(CODE[strand.data]).to(gpu)
    (key,), empty = pack_keys(codes, (), k, reverse, complement, W, 0, ws)
    (want,), _ = pack_keys_plain(codes, [0], [], [], k, reverse, complement,
                                 W, 0, ws)
    _equal((key,), (want,))
    (pkey,), mask = pack_keys(codes, specs, k, reverse, complement, 0, total)
    want = pack_keys_plain(codes, *tabs, k, reverse, complement, 0, total)
    _equal((pkey, mask), (want[0][0], want[1]))
    (skey,), sa = sort_keys([key])
    run_lo, run_hi, tied = group_bounds([skey], sa, W)
    _equal((run_lo, run_hi, tied), group_bounds_plain([skey], sa, W))
    inv = invert_fused(sa, run_lo, run_hi, empty, W, [0])
    _equal(inv, invert_fused_plain(sa, run_lo, run_hi, empty, W, [0]))
    got = mj_ranges(skey, pkey, mask, tabs[0])
    _equal(got, mj_ranges_plain(skey, pkey, mask, tabs[0]))
    if reverse == complement:  # the planted pairs match these probes
        assert int(got[2].sum()) > 0
    cpu = torch.device("cpu")
    engines = [DeviceWindowEngine(strand, s, dev, (ws, we), cache=None)
               for dev in (gpu, cpu)]
    r_gpu, r_cpu = (e.stage1(chunks) for e in engines)
    _equal((engines[0].index.key, engines[0].index.sa, r_gpu.lane_lo,
            r_gpu.lane_hi, r_gpu.lane_mask),
           (engines[1].index.key, engines[1].index.sa, r_cpu.lane_lo,
            r_cpu.lane_hi, r_cpu.lane_mask))
    assert r_gpu.offs == r_cpu.offs
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[name] > before[name] for name in after
               if name not in ("scan_core", "unpack_codes",
                               *TABLE_KERNELS, *CHAIN_KERNELS,
                               *SLICE_KERNELS, *SEED_KERNELS,
                               *SHARD_KERNELS))


@pytest.mark.parametrize("k", [20, 8])
def test_gpu_mj_trim_and_shards_json_equal_host(tmp_path, gpu, monkeypatch,
                                                k):
    """With no fused build (and no table) fitting, trim windows, shards and
    the whole genome (one window) run on the merge-join engine and write
    the host engine's bytes."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.window_index import DeviceWindowIndex

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "table_fits", lambda *a, **kw: False)
    for reverse, complement in TRANSFORMS:
        for trim in ((0, 30000), (400, 52000), (35000, 60000)):
            s = RunSettings(reverse=reverse, complement=complement,
                            probe_size=k, trim=trim)
            host = json_text(search_duplications([fa], s, engine="host"))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu)) == host
            assert isinstance(INDEX_CACHE._index, DeviceWindowIndex)
        s = RunSettings(reverse=reverse, complement=complement,
                        probe_size=k)
        for shards in (2, 3):
            host = json_text(search_duplications([fa], s, engine="host",
                                                 shards=shards))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu, shards=shards)) == host
        host = json_text(search_duplications([fa], s, engine="host"))
        INDEX_CACHE.clear()
        assert json_text(search_duplications(
            [fa], s, engine="cuda", device=gpu)) == host
        assert isinstance(INDEX_CACHE._index, DeviceWindowIndex)
    INDEX_CACHE.clear()


def test_gpu_natural_route_ballast(tmp_path, gpu):
    """A ballast tensor that leaves free memory between the merge-join
    projection and the fused build's sends a trim window, the whole
    genome as one window (the table, which the router tries before it,
    made not to fit: at this size its projection lies below the fused
    build's, and a ballast below it leaves too little for any build to
    run), and every window of a sharded run (its held probe keys charged)
    to the merge-join engine; the JSON is the host engine's."""
    from asgart_tpu_torch import fused_index, pipeline
    from asgart_tpu_torch.fused_index import (INDEX_CACHE, MJ_BYTES_PER_LANE,
                                              MJ_KEY_BYTES_PER_LANE,
                                              MJ_PEAK_BYTES_PER_ROW,
                                              PEAK_BYTES_PER_ROW,
                                              projected_rows)
    from asgart_tpu_torch.pipeline import plan_windows, search_duplications
    from asgart_tpu_torch.window_index import DeviceWindowIndex

    g = chunked_genome()
    fa, _, strand = prepared(tmp_path, [("chr1", g)])
    n1 = len(strand.data)
    lanes = n1 // 10
    built = []
    orig = DeviceWindowIndex.build.__func__

    def spy(cls, *a, **kw):
        built.append(a[2])
        return orig(cls, *a, **kw)

    for trim, shards in (((5000, 50000), 1), (None, 1), (None, 3)):
        ws, we = plan_windows(n1 - 1, shards)[0] if trim is None else trim
        W = n1 if shards == 1 and trim is None else we - ws + 1
        held = MJ_KEY_BYTES_PER_LANE * lanes if shards > 1 else 0
        fused = projected_rows(n1, W, 20) * PEAK_BYTES_PER_ROW[1] + n1
        mj = max(MJ_PEAK_BYTES_PER_ROW * W + held,
                 12 * W + MJ_BYTES_PER_LANE * lanes) + n1
        s = RunSettings(reverse=True, complement=True, trim=trim)
        host = json_text(search_duplications([fa], s, engine="host",
                                             shards=shards))
        INDEX_CACHE.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        built.clear()
        ballast = torch.empty(
            int(fused_index.free_bytes(gpu) - (mj + fused) / 2),
            dtype=torch.uint8, device=gpu)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(DeviceWindowIndex, "build", classmethod(spy))
                mp.setattr(pipeline, "table_fits", lambda *a, **kw: False)
                got = json_text(search_duplications(
                    [fa], s, engine="cuda", device=gpu, shards=shards))
        finally:
            del ballast
            INDEX_CACHE.clear()
            torch.cuda.empty_cache()
        assert len(built) == shards
        assert got == host


def test_unpack_codes_equal_plain_on_gpu(gpu):
    """KI against its plain version and ``CODE[strand]``: $, N and IUPAC
    exceptions, no exception, n1 % 4 from 0 to 3, n4 % 4 from 0 to 3
    (every quarter at its own alignment), strands under a tile and under
    16 bytes, through ``upload_codes`` too; ``packed`` as views at byte
    offsets 1-15, and the entry point writing into ``codes`` views at byte
    offsets 1-15 (the wrapper's own buffer is aligned)."""
    import numpy as np

    from asgart_tpu_torch.codes import pack_codes, upload_codes
    from asgart_tpu_torch.kernels import _build, launch_counts, unpack_codes
    from asgart_tpu_torch.kernels.codes import unpack_codes_plain

    before = launch_counts()["unpack_codes"]
    rng = np.random.default_rng(5)

    def strand(n, exc):
        g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        if exc:
            hit = rng.random(n) < 0.003
            g[hit] = np.frombuffer(exc, np.uint8)[
                rng.integers(0, len(exc), hit.sum())]
            g[-1] = ord("$")
        return g

    cases = [(1 << 20, b"N"), ((1 << 20) + 1, b"NRYKM"),
             ((1 << 20) + 2, b""), ((1 << 20) + 3, b"N"), (7, b"N")]
    # n4 = ceil(n1 / 4) at each residue mod 4, and short strands
    cases += [(4 * ((1 << 20) + r) - 1, b"N") for r in range(4)]
    cases += [(n, b"N") for n in (1, 15, 16, 17, 4095, 4 * 4096 + 5)]
    for n, exc in cases:
        g = strand(n, exc)
        packed = [torch.from_numpy(a).to(gpu) for a in pack_codes(g)]
        got = unpack_codes(*packed, n)
        _equal((got,), (unpack_codes_plain(*packed, n),))
        _equal((got,), (torch.from_numpy(CODE[g]),))
        _equal((upload_codes(g, gpu),), (torch.from_numpy(CODE[g]),))
    lib = _build.lib()
    for mis in range(1, 16):
        n = (1 << 18) + 4 * mis + mis % 4
        g = strand(n, b"N")
        want = torch.from_numpy(CODE[g])
        p, pos, code = (torch.from_numpy(a).to(gpu) for a in pack_codes(g))
        buf = torch.zeros(p.numel() + 32, dtype=torch.uint8, device=gpu)
        o = (mis - buf.data_ptr()) % 16
        view = buf[o: o + p.numel()]
        view.copy_(p)
        _equal((unpack_codes(view, pos, code, n),), (want,))
        out = torch.full((n + 32,), 255, dtype=torch.uint8, device=gpu)
        o = ((16 - mis) - out.data_ptr()) % 16
        _build.check(lib.asgart_unpack_codes(
            view.data_ptr(), view.numel(), n, pos.data_ptr(),
            code.data_ptr(), pos.numel(), out[o:].data_ptr(),
            _build.stream_of(view)), "unpack_codes")
        _equal((out[o: o + n],), (want,))
        assert bool((out[:o] == 255).all()) and bool((out[o + n:] == 255)
                                                     .all())
    torch.cuda.synchronize()
    assert launch_counts()["unpack_codes"] >= before + 2 * len(cases) + 15


@pytest.mark.parametrize("k", [20, 8])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_big_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse, complement,
                                        k):
    """KD with the merge-join engine's rebased constants on its
    window-relative index (windows at 0 and past it, max_cardinality 500
    and 1) against its plain version; the relative index and stage 1 on
    the GPU equal the CPU's."""
    from asgart_tpu_torch.device_engine import (DeviceWindowEngine,
                                                rebased_bases)
    from asgart_tpu_torch.kernels import launch_counts, scan_core
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    _, chunks, strand = prepared(tmp_path, [("chr1", bytes(g))])
    cpu = torch.device("cpu")
    before = launch_counts()
    n_events = 0
    for trim in ((0, 10000), (19000, 46000)):
        s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
        engines = [DeviceWindowEngine(strand, s, dev, trim, cache=None)
                   for dev in (gpu, cpu)]
        r_gpu, r_cpu = (e.stage1(chunks) for e in engines)
        idx = engines[0].index
        _equal((idx.key, idx.sa, r_gpu.lane_lo, r_gpu.lane_hi,
                r_gpu.lane_mask),
               (engines[1].index.key, engines[1].index.sa, r_cpu.lane_lo,
                r_cpu.lane_hi, r_cpu.lane_mask))
        for (cs, cl, nc) in r_gpu.specs:
            off = r_gpu.offs[(cs, cl)][0]
            lanes = slice(off, off + nc)
            for max_card in (500, 1):
                args = (r_gpu.lane_lo[lanes], r_gpu.lane_hi[lanes],
                        r_gpu.lane_mask[lanes], idx.sa,
                        *rebased_bases(cs, cl, trim[0], idx.W), max_card, 0,
                        k, reverse)
                got, want = scan_core(*args), scan_core_plain(*args)
                assert (got.n_events, got.total_kept) == \
                    (want.n_events, want.total_kept)
                _equal((got.flat,), (want.flat,))
                n_events += got.n_events
    torch.cuda.synchronize()
    after = launch_counts()
    # this genome's N run makes its exceptions dense: a plain upload, no KI
    # (test_unpack_codes_equal_plain_on_gpu)
    assert all(after[name] > before[name] for name in after
               if name not in ("unpack_codes",
                               *TABLE_KERNELS, *CHAIN_KERNELS,
                               *SLICE_KERNELS, *SEED_KERNELS,
                               *SHARD_KERNELS))
    if reverse == complement:
        assert n_events > 0


@pytest.mark.parametrize("k", [20, 8])
def test_gpu_big_json_equals_host(tmp_path, gpu, monkeypatch, k):
    """With every probed text past the threshold of int32 addressing, trim
    windows, shards and the whole genome (the planner's windows) skip the
    fused build, run on the merge-join engine and write the host engine's
    bytes."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    monkeypatch.setattr(pipeline, "BIG_WINDOW_SPAN", 0)
    trims = []
    scan = pipeline.DeviceWindowEngine.scan_chunks
    monkeypatch.setattr(pipeline.DeviceWindowEngine, "scan_chunks",
                        lambda self, c: trims.append(self.trim)
                        or scan(self, c))
    for reverse, complement in TRANSFORMS:
        for trim in ((0, 30000), (400, 52000), (35000, 60000)):
            s = RunSettings(reverse=reverse, complement=complement,
                            probe_size=k, trim=trim)
            host = json_text(search_duplications([fa], s, engine="host"))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu)) == host
            assert trims[-1] == trim
        s = RunSettings(reverse=reverse, complement=complement,
                        probe_size=k)
        for shards in (2, 3):
            host = json_text(search_duplications([fa], s, engine="host",
                                                 shards=shards))
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu, shards=shards)) == host
        trims.clear()
        host = json_text(search_duplications([fa], s, engine="host",
                                             shards=2))
        assert json_text(search_duplications(
            [fa], s, engine="cuda", device=gpu)) == host
        assert len(trims) == 2
    INDEX_CACHE.clear()


@pytest.mark.parametrize("k", [20, 8, 25])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_table_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse,
                                          complement, k):
    """The table build's kernels step by step (KA doubled, the sort, KB
    with the N flag and run ends, KJ, two full rounds KK / KL, then KE /
    KF), the whole build against the plain build on the CPU, then KM and
    KD on its lanes."""
    from asgart_tpu_torch.device_engine import TableEngine, chunk_specs
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (full_round_keys, full_round_refine,
                                          group_bounds, invert_tables,
                                          launch_counts, pack_keys,
                                          scan_core, table_ranges)
    from asgart_tpu_torch.kernels.group_bounds import (group_bounds_plain,
                                                       n_flag_shift)
    from asgart_tpu_torch.kernels.pack_keys import pack_keys_plain
    from asgart_tpu_torch.kernels.scan_core import (fused_bases,
                                                    scan_core_plain)
    from asgart_tpu_torch.kernels.tables import (invert_tables_plain,
                                                 table_ranges_plain,
                                                 table_x0s)
    from asgart_tpu_torch.kernels.ties import (full_round_keys_plain,
                                               full_round_refine_plain)
    from asgart_tpu_torch.table_index import DeviceIndex

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    _, chunks, strand = prepared(tmp_path, [("chr1", bytes(g))])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    n1 = len(strand.data)
    doubled = reverse or complement
    n = 2 * n1 - 1 if doubled else n1
    before = launch_counts()
    codes = torch.from_numpy(CODE[strand.data]).to(gpu)
    keys, _ = pack_keys(codes, (), k, reverse, complement, n, 0,
                        doubled=doubled)
    want, _ = pack_keys_plain(codes, [0], [], [], k, reverse, complement, n,
                              0, 0, doubled)
    _equal(keys, want)
    skeys, sa = sort_keys(keys)
    bounds = group_bounds(skeys, sa, n1, flag_n_k=k, run_end=not doubled)
    _equal(bounds, group_bounds_plain(skeys, sa, n1,
                                      n_flag_shift(k, len(skeys)),
                                      not doubled))
    run_lo, run_hi, tied = bounds
    assert bool((run_lo < 0).any())  # the genome's N probes
    tables = invert_tables(sa, run_lo, run_hi, k // 2)
    _equal(tables, invert_tables_plain(sa, run_lo, run_hi, k // 2))
    pos_lo, pos_hi, rank = tables
    h = k
    for _ in range(2):
        key = full_round_keys(rank, h, n1)
        _equal((key,), (full_round_keys_plain(rank, h, n1),))
        skey, order = torch.sort(key, stable=True)
        rank_p = rank.clone()
        got = full_round_refine(skey, order, rank, n1)
        _equal((*got, rank), (*full_round_refine_plain(skey, order, rank_p,
                                                       n1), rank_p))
        sa = got[0]
        h *= 2
    # the whole build, full rounds and subset rounds, against the CPU's
    for cap in (None, 64):
        idx = DeviceIndex.build(strand.data, k, reverse, complement, gpu,
                                tied_cap=cap)
        ref = DeviceIndex.build(strand.data, k, reverse, complement,
                                torch.device("cpu"), tied_cap=cap)
        _equal((idx.sa, idx.pos_lo, idx.pos_hi),
               (ref.sa, ref.pos_lo, ref.pos_hi))
    specs = chunk_specs(chunks, s)
    got = table_ranges(idx.pos_lo, idx.pos_hi, specs, n1, k, reverse,
                       complement)
    want = table_ranges_plain(idx.pos_lo, idx.pos_hi,
                              *table_x0s(specs, n1, k, reverse, complement),
                              k, n)
    _equal(got[:4], want)
    lane_lo, lane_hi, mask, _, lane_off = got
    n_events = 0
    for c, (cs, cl, nc) in enumerate(specs):
        lanes = slice(lane_off[c], lane_off[c] + nc)
        args = (lane_lo[lanes], lane_hi[lanes], mask[lanes], idx.sa,
                *fused_bases(cs, cl), 500, 0, k, reverse)
        got, want = scan_core(*args), scan_core_plain(*args)
        assert (got.n_events, got.total_kept) == \
            (want.n_events, want.total_kept)
        _equal((got.flat,), (want.flat,))
        n_events += got.n_events
    if reverse == complement:
        assert n_events > 0
    eng = TableEngine(strand, s, gpu, cache=None, index=idx)
    assert [eng.run_chunk(c) for c in chunks] == eng.run_chunks(chunks)
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[name] > before[name] for name in
               ("pack_keys", "group_bounds", "scan_core", "tie_keys",
                "tie_refine", *TABLE_KERNELS))


def test_gpu_table_json_equals_host(tmp_path, gpu, monkeypatch):
    """The table engine end to end: ``--checkpoint`` runs (first, resumed,
    and resumed with the last record removed) and the route past a fused
    build that does not fit write the host engine's bytes, also with the
    host engine journaling; the CLI's ``--engine cuda --checkpoint``
    too."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.cli.main import main
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.table_index import DeviceIndex

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    for i, (reverse, complement) in enumerate(TRANSFORMS):
        for k in (20, 25):
            s = RunSettings(reverse=reverse, complement=complement,
                            probe_size=k)
            ck = tmp_path / f"j{i}_{k}.jsonl"
            host = json_text(search_duplications(
                [fa], s, engine="host", checkpoint=str(tmp_path / "h")))
            INDEX_CACHE.clear()
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu,
                checkpoint=str(ck))) == host
            assert isinstance(INDEX_CACHE._index, DeviceIndex)
            before = launch_counts()
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu,
                checkpoint=str(ck))) == host
            assert launch_counts() == before  # every chunk restored
            lines = ck.read_text().splitlines()
            ck.write_text("\n".join(lines[:-1]) + "\n")
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu,
                checkpoint=str(ck))) == host
            after = launch_counts()
            assert after["table_ranges"] == before["table_ranges"] + 1
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pipeline, "fits", lambda *a, **kw: False)
                INDEX_CACHE.clear()
                assert json_text(search_duplications(
                    [fa], s, engine="cuda", device=gpu)) == host
                assert isinstance(INDEX_CACHE._index, DeviceIndex)
    INDEX_CACHE.clear()
    out = [tmp_path / f"{e}.json" for e in ("host", "cuda")]
    for engine, o in zip(("host", "cuda"), out):
        assert main([fa, "-R", "-C", "--engine", engine, "--checkpoint",
                     str(tmp_path / f"{engine}.ckpt"), "--out",
                     str(o)]) == 0
    assert out[0].read_text() == out[1].read_text()


def _random_events(rng, n_events: int, step: int, t_split: int,
                   tracks: int, junk: int):
    """A synthetic event stream (numpy, ``native.chain_events``'s
    arguments): probes every ``step`` bases with quiet runs (now and then
    past ``t_split``, a burst break), each event's matches drawn from
    ``tracks`` diagonals (arms that extend) and up to ``junk`` random
    positions (arms that spawn, die and are pruned)."""
    z = np.where(rng.random(n_events) < 0.03,
                 rng.integers(t_split, 3 * t_split, n_events),
                 np.where(rng.random(n_events) < 0.3,
                          rng.integers(1, t_split, n_events), 0))
    z[0] = 0
    pe = np.cumsum((1 + z) * step)
    diag = rng.integers(10**4, 10**7, tracks)
    offs, flat = [0], []
    for i in pe:
        ms = [int(i + d + rng.integers(-2, 3)) for d in diag
              if rng.random() < 0.6]
        ms += [int(x) for x in rng.integers(0, 10**7,
                                            int(rng.integers(0, junk + 1)))]
        if not ms:
            ms = [int(i + diag[0])]
        flat += ms
        offs.append(len(flat))
    return (pe.astype(np.int64), z.astype(np.int64),
            np.asarray(offs, np.int64), np.asarray(flat, np.int64),
            int(rng.integers(0, 3 * t_split)))


@pytest.mark.parametrize("case", range(4))
def test_chain_kernel_equals_plain_on_gpu(gpu, monkeypatch, case):
    """KN against its plain version on the GPU and against
    ``native.chain_events``, on synthetic event streams (many bursts,
    in-burst quiet runs, more than 200 arms, matches past 2^31 through
    ``m_offset``), with the first capacities and with one arm and one
    output row (both retries), and with the arms in global scratch."""
    from asgart_tpu_torch import chain, native
    from asgart_tpu_torch.kernels import chain as kc
    from asgart_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(100 + case)
    k = (20, 8, 14, 20)[case]
    kw = dict(probe_size=k, step_size=k // 2, max_gap_size=(120, 30, 60,
                                                            200)[case],
              min_duplication_length=(1000, 60, 200, 300)[case],
              max_cardinality=500)
    cfg = chain.ChainConfig(**kw)
    ev = _random_events(rng, (3000, 4000, 2000, 1500)[case], k // 2,
                        chain.burst_threshold(cfg), (3, 6, 12, 40)[case],
                        (2, 8, 30, 250)[case])
    off = (0, 2**31 + 5, 0, 3 * 2**31)[case]
    pe, zb, offs, flat, z_trail = ev
    want = native.chain_events(pe, zb, offs, flat + off, z_trail=z_trail,
                               **kw)
    events = chain.upload_events(*ev, off, gpu)
    before = launch_counts()["chain_bursts"]
    plain, p_stats = chain.chain_rows(events, cfg, kc.chain_bursts_plain)
    assert chain.families_from_rows(plain.cpu().numpy()) == want
    for caps in (dict(), dict(max_arms=1, out_cap=1)):
        c = cfg._replace(**caps)
        rows, stats = chain.chain_rows(events, c)
        torch.cuda.synchronize()
        _equal((rows,), (plain,))
        assert stats.tests == p_stats.tests and stats.bursts > 1
        if caps:
            assert stats.passes > 2
    monkeypatch.setattr(kc, "SMEM_LIMIT", 0)  # arms in global scratch
    rows, _ = chain.chain_rows(events, cfg._replace(max_arms=4))
    torch.cuda.synchronize()
    _equal((rows,), (plain,))
    assert launch_counts()["chain_bursts"] > before + 3
    assert want


@pytest.mark.parametrize("warp_arms,smem,threads", [
    (64, True, 256), (4, True, 256), (0, True, 256), (64, False, 256),
    (0, False, 512), (33, True, 512)])
def test_chain_kernel_paths_on_gpu(gpu, monkeypatch, warp_arms, smem,
                                   threads):
    """KN with each path forced against its plain version: every burst on
    the warp path with a budget of 64 arms (the kernel's most) or 33, or of
    4 (most bursts handed over to the block path mid-burst), or none (the
    block path alone); the block path's arms in shared memory or in
    global scratch; blocks of 256 and 512 threads. Rows, n_rows, status
    and the finished bursts' test counts in one pass at the capacities of
    the chain, and at 40 arms and 3 rows (overflows in the pass), then the
    whole chain with one arm and one row (both retries)."""
    from asgart_tpu_torch import chain
    from asgart_tpu_torch.kernels import chain as kc

    monkeypatch.setattr(kc, "WARP_ARMS", warp_arms)
    monkeypatch.setattr(kc, "THREADS", threads)
    if not smem:
        monkeypatch.setattr(kc, "SMEM_LIMIT", 0)
    rng = np.random.default_rng(300 + warp_arms)
    kw = dict(probe_size=20, step_size=10, max_gap_size=120,
              min_duplication_length=150, max_cardinality=500)
    cfg = chain.ChainConfig(**kw)
    t = chain.burst_threshold(cfg)
    events = chain.upload_events(*_random_events(rng, 2500, 10, t, 12, 60),
                                 3 * 2**31, gpu)
    bs, order = chain.bursts_from_events(events, t)
    for arms, cap in ((1024, 1 << 16), (40, 1 << 16), (1024, 3)):
        args = (events.ev_i, events.ev_z, events.m_off, events.m,
                events.m_offset, bs, order, events.z_trail, t, 20, 10, 120,
                150, arms, cap)
        got = kc.chain_bursts(*args)
        want = kc.chain_bursts_plain(*args)
        torch.cuda.synchronize()
        n = int(want[1])
        assert int(got[1]) == n
        assert torch.equal(got[2], want[2])
        ok = want[2] == 0
        assert torch.equal(got[3][ok], want[3][ok])
        if n <= cap:
            key = lambda r: r[torch.sort(r[:, 0]).indices]  # noqa: E731
            _equal((key(got[0][:n]),), (key(want[0][:n]),))
    plain, p_stats = chain.chain_rows(events, cfg, kc.chain_bursts_plain)
    rows, stats = chain.chain_rows(events, cfg._replace(max_arms=1,
                                                        out_cap=1))
    torch.cuda.synchronize()
    _equal((rows,), (plain,))
    assert stats.tests == p_stats.tests and stats.passes > 2


def test_chain_kernel_launch_failure_raises(gpu, monkeypatch):
    """A launch the card refuses (a block of 2048 threads) raises; nothing
    falls back to the plain version or to the host chain."""
    from asgart_tpu_torch import chain
    from asgart_tpu_torch.kernels import chain as kc

    def no_plain(*a, **kw):
        raise AssertionError("plain version used for a GPU tensor")

    monkeypatch.setattr(kc, "chain_bursts_plain", no_plain)
    monkeypatch.setattr(kc, "THREADS", 2048)
    ev = _random_events(np.random.default_rng(1), 50, 10, 12, 2, 1)
    cfg = chain.ChainConfig(20, 10, 120, 1000, 500)
    with pytest.raises(RuntimeError, match="chain_bursts"):
        chain.chain_rows(chain.upload_events(*ev, 0, gpu), cfg)


def test_gpu_device_chain_json_equals_host(tmp_path, gpu, monkeypatch):
    """ASGART_DEVICE_CHAIN=1: the fused whole genome, the table engine
    with ``--checkpoint``, trim windows, shards and the merge-join route
    past int32 addressing write the host engine's bytes; KN runs and the
    host event chain never does."""
    from asgart_tpu_torch import native, pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import search_duplications

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    monkeypatch.setenv("ASGART_DEVICE_CHAIN", "1")

    def no_host_chain(*a, **kw):
        raise AssertionError("the host chain ran under ASGART_DEVICE_CHAIN")

    monkeypatch.setattr(native, "chain_events", no_host_chain)
    for reverse, complement in TRANSFORMS:
        s = RunSettings(reverse=reverse, complement=complement)
        host = json_text(search_duplications([fa], s, engine="host"))
        runs = [dict(), dict(checkpoint=str(tmp_path / f"{reverse}"
                                            f"{complement}.jsonl"))]
        for kw in runs:
            INDEX_CACHE.clear()
            before = launch_counts()["chain_bursts"]
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu, **kw)) == host
            if reverse == complement:  # R alone or C alone: no event here
                assert launch_counts()["chain_bursts"] > before
        trim = RunSettings(reverse=reverse, complement=complement,
                           trim=(400, 52000))
        host = json_text(search_duplications([fa], trim, engine="host"))
        assert json_text(search_duplications(
            [fa], trim, engine="cuda", device=gpu)) == host
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pipeline, "BIG_WINDOW_SPAN", 0)
            assert json_text(search_duplications(
                [fa], trim, engine="cuda", device=gpu)) == host
        host = json_text(search_duplications([fa], s, engine="host",
                                             shards=3))
        assert json_text(search_duplications(
            [fa], s, engine="cuda", device=gpu, shards=3)) == host
    INDEX_CACHE.clear()


def test_slices_kernels_equal_plain_on_gpu(gpu):
    """KO on whole and partial granules of several sizes and KP on a
    source of one and of three buffers, against their plain versions."""
    from asgart_tpu_torch.kernels import (gather_flat, granule_totals,
                                          launch_counts)
    from asgart_tpu_torch.kernels.slices import (gather_flat_plain,
                                                 granule_totals_plain)

    rng = np.random.default_rng(31)
    kinds = ["event", "quiet", "over", "event", "quiet"]
    n = 5 * 4096 - 77
    lanes = [torch.from_numpy(a).to(gpu)
             for a in granule_lanes(rng, kinds, n, 4096)[:3]]
    before = launch_counts()
    for gran in (4096, 64, 1000, 1):
        for m in (n, 1, 0):
            part = [t[:m] for t in lanes]
            _equal([granule_totals(*part, gran)],
                   [granule_totals_plain(*part, gran)])
    srcs = [torch.from_numpy(rng.integers(-2**31, 2**31, m, dtype=np.int64)
                             .astype(np.int32)).to(gpu)
            for m in (1000, 1, 70000)]
    for k in (1, 3):
        total = sum(t.numel() for t in srcs[:k])
        idx = torch.from_numpy(rng.integers(0, total, 200000)).to(gpu)
        _equal([gather_flat(srcs[:k], idx)],
               [gather_flat_plain(srcs[:k], idx)])
    after = launch_counts()
    assert after["granule_totals"] == before["granule_totals"] + 8
    assert after["gather_flat"] == before["gather_flat"] + 2


@pytest.mark.parametrize("shifts", [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                                    (3, 3, 3), (5, 5, 5), (0, 1, 0),
                                    (2, 0, 3)])
def test_granule_totals_views_on_gpu(gpu, shifts):
    """KO on views at lane offsets from a 16-byte boundary (one offset:
    scalar ends around 16-byte vectors; offsets that differ: every lane a
    scalar), granules of 4096 and 61 lanes with a partial last one,
    granules with every lane masked and with none, totals past 2^31."""
    from asgart_tpu_torch.kernels import granule_totals
    from asgart_tpu_torch.kernels.slices import granule_totals_plain

    rng = np.random.default_rng(sum(shifts))
    n = 7 * 4096 + 45
    lo = rng.integers(0, 1 << 20, n + 8).astype(np.int32)
    hi = (lo + rng.integers(0, 1 << 10, n + 8)).astype(np.int32)
    mask = rng.random(n + 8) < 0.7
    mask[:4096 + 8] = False
    mask[2 * 4096:3 * 4096 + 8] = True
    lo[4 * 4096:5 * 4096 + 8] = 0
    hi[4 * 4096:5 * 4096 + 8] = (1 << 31) - 1
    mask[4 * 4096:5 * 4096 + 8] = True
    lanes = [torch.from_numpy(a).to(gpu)[s:s + n]
             for a, s in zip((lo, hi, mask), shifts)]
    for gran in (4096, 61):
        got = granule_totals(*lanes, gran)
        _equal([got], [granule_totals_plain(*lanes, gran)])
        assert int(got.max()) > 2**31


def _sort_round(rng, sizes, gpu, few_secs=False):
    """(ps, prims, rank) of a tie round whose groups have ``sizes``."""
    n = int(sum(sizes))
    W = 4 * n + 64
    starts = np.repeat(np.cumsum([0] + list(sizes[:-1])), sizes)
    prims = (3 * starts + 1).astype(np.int32)
    ps = rng.choice(W - 40, n, replace=False).astype(np.int32)
    rank = rng.integers(0, 3 if few_secs else W, W).astype(np.int32)
    return [torch.from_numpy(a).to(gpu) for a in (ps, prims, rank)]


@pytest.mark.parametrize("case", ["pairs", "mixed", "thirty_two",
                                  "thirty_three", "registers", "tile",
                                  "across_tiles", "one_group", "capacity",
                                  "few_secs", "n2", "bad"])
def test_tie_sort_equals_plain_on_gpu(gpu, case):
    """KE's sort (windows of 32 lanes, the warp's register sort of 33 to
    128 entries, the capacity) against the plain version (the keys and the
    library's stable sort), and its sizing pass, at groups of 2, 32, 33,
    64, 65 and 128, groups that fill a tile's width, groups across tiles'
    edges, the whole set in one group, equal secs (stability), n = 2 and
    the bad flag; the library route past the capacity, and where a longer
    group reaches the kernel, 2 ORed into its bad flag and that group written
    unsorted and in range."""
    from asgart_tpu_torch.kernels import launch_counts, tie_groups, tie_keys
    from asgart_tpu_torch.kernels.ties import (TIE_SORT_CAP,
                                               tie_groups_plain,
                                               tie_keys_plain)

    cap = TIE_SORT_CAP
    rng = np.random.default_rng(len(case))
    sizes = {"pairs": [2] * 300000, "thirty_two": [32] * 3000,
             "thirty_three": [33] * 3000, "tile": [cap, cap] * 50,
             "registers": [64, 65, 2, 128, 3] * 300,
             "across_tiles": [2, 40, 3, 120, 7, cap, 2] * 40,
             "one_group": [cap], "capacity": [2, cap, 3] * 20,
             "few_secs": [2, 7, 40, 3, cap] * 30, "n2": [2],
             "bad": [2, 3, 50, 120]}.get(case)
    if case == "mixed":
        sizes = list(np.where(rng.random(100000) < 0.9,
                              rng.integers(2, 8, 100000),
                              rng.integers(2, cap + 1, 100000)))
    ps, prims, rank = _sort_round(rng, sizes, gpu, case == "few_secs")
    if case == "bad":  # entries of each path read past the text
        for at in (1, 4, 40, 100):
            ps[at] = rank.numel() - 5
    h = 17
    largest = [torch.zeros(1, dtype=torch.int32, device=gpu) for _ in "kp"]
    before = launch_counts()
    tie_groups(prims, largest[0])
    tie_groups_plain(prims, largest[1])
    _equal(largest[:1], largest[1:])
    assert int(largest[0]) == max(sizes)
    bad = [torch.zeros(1, dtype=torch.int32, device=gpu) for _ in "kp"]
    want = tie_keys_plain(ps, prims, rank, h, bad[1])
    got = tie_keys(ps, prims, rank, h, bad[0], max(sizes))
    torch.cuda.synchronize()
    _equal((*got, bad[0]), (*want, bad[1]))
    assert int(bad[0]) == (case == "bad")
    bad[0].zero_()
    got = tie_keys(ps, prims, rank, h, bad[0], TIE_SORT_CAP + 1)
    _equal((*got, bad[0]), (*want, bad[1]))
    after = launch_counts()
    assert after["tie_keys"] == before["tie_keys"] + 2
    assert after["tie_groups"] == before["tie_groups"] + 1
    if case == "capacity":  # a longer group handed to the kernel: flagged
        ps, prims, rank = _sort_round(rng, [2, cap + 1, 3], gpu)
        bad[0].zero_()
        skey, order = tie_keys(ps, prims, rank, h, bad[0], cap)
        want = tie_keys_plain(ps, prims, rank, h, bad[1])
        assert int(bad[0]) == 2
        big = slice(2, 3 + cap)
        key = (prims.long() << 32) | (rank[ps.long() + h].long() + 1)
        _equal((order[big], skey[big]),
               (torch.arange(2, 3 + cap, device=gpu), key[big]))
        _equal((skey[:2], order[:2], skey[3 + cap:], order[3 + cap:]),
               (want[0][:2], want[1][:2], want[0][3 + cap:],
                want[1][3 + cap:]))


def _merge_like_index(rng, sizes, n: int) -> np.ndarray:
    """n int64 indices into the concatenation of sources of ``sizes``:
    runs of consecutive indices within one source (as ``merged_index``
    writes), then random indices, in random order of runs."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    total = int(off[-1])
    out, left = [], n
    while left > 0:
        s = int(rng.integers(0, len(sizes)))
        if sizes[s] == 0 or rng.random() < 0.2:
            m = min(left, int(rng.integers(1, 9)))
            out.append(rng.integers(0, total, m))
        else:
            a = int(rng.integers(off[s], off[s + 1]))
            m = min(left, int(off[s + 1]) - a, int(rng.integers(1, 300)))
            out.append(np.arange(a, a + m))
        left -= m
    return np.concatenate(out)[:n] if n else np.zeros(0, np.int64)


@pytest.mark.parametrize("n_src", [1, 2, 5, 8, 9, 64, 65, 1024, 1025])
def test_gather_flat_source_tables_on_gpu(gpu, n_src):
    """KP against its plain version at every form of its source table: by
    value at S = 1, 2 and 5, at each capacity (8, 64, 1024) and one past
    it, and the device table past the largest; some sources empty."""
    from asgart_tpu_torch.kernels import gather_flat, launch_counts
    from asgart_tpu_torch.kernels.slices import gather_flat_plain

    rng = np.random.default_rng(50 + n_src)
    sizes = [int(m) if rng.random() > 0.1 else 0
             for m in rng.integers(1, 400, n_src)]
    sizes[0] = max(sizes[0], 1)
    srcs = [torch.from_numpy(rng.integers(-2**31, 2**31, m, dtype=np.int64)
                             .astype(np.int32)).to(gpu) for m in sizes]
    idx = torch.from_numpy(_merge_like_index(rng, sizes, 20011)).to(gpu)
    before = launch_counts()["gather_flat"]
    _equal([gather_flat(srcs, idx)], [gather_flat_plain(srcs, idx)])
    assert launch_counts()["gather_flat"] == before + 1


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001, 4099, 200003])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_gather_flat_views_and_lengths_on_gpu(gpu, n, offset):
    """KP with ``idx`` a view at an odd int64 offset (no 16-byte loads)
    or an even one, sources that are views at odd int32 offsets, lengths
    that are not a multiple of the vector width, and no index at all
    (nothing launched)."""
    from asgart_tpu_torch.kernels import gather_flat, launch_counts
    from asgart_tpu_torch.kernels.slices import gather_flat_plain

    rng = np.random.default_rng(7 * n + offset)
    buf = torch.from_numpy(rng.integers(-2**31, 2**31, 90001, dtype=np.int64)
                           .astype(np.int32)).to(gpu)
    srcs = [buf[1:20000], buf[20003:20004], buf[20005:90001]]
    sizes = [t.numel() for t in srcs]
    whole = torch.from_numpy(_merge_like_index(rng, sizes, n + offset))
    idx = whole.to(gpu)[offset:]
    assert idx.numel() == n and idx.is_contiguous()
    before = launch_counts()["gather_flat"]
    got = gather_flat(srcs, idx)
    _equal([got], [gather_flat_plain(srcs, idx)])
    assert got.dtype == torch.int32
    assert launch_counts()["gather_flat"] == before + (n > 0)


@pytest.mark.parametrize("packed", [False, True])
def test_sliced_scan_equals_unsliced_on_gpu(gpu, monkeypatch, packed):
    """A chunk's lanes scanned as slices (every granule its own, or
    granules packed up to the largest one's total) merge, by KP on the
    card and on the host, to one unsliced KD launch's outputs."""
    from asgart_tpu_torch import device_engine
    from asgart_tpu_torch.kernels import granule_totals, scan_core
    from asgart_tpu_torch.window_index import WindowRanges

    rng = np.random.default_rng(37)
    kinds = ["event", "quiet", "quiet", "event", "over", "event", "event"]
    n = 7 * 4096 - 999
    lo, hi, mask, sa = (torch.from_numpy(a).to(gpu) for a in
                        granule_lanes(rng, kinds, n, 4096))
    want = scan_core(lo, hi, mask, sa, 0, 0, 0, 8, 0, 20, False)
    chunk = (0, 2 * n * 10)
    lanes = WindowRanges(lane_lo=lo, lane_hi=hi, lane_mask=mask,
                         specs=((*chunk, n),), offs={chunk: (0, 1 << 40)})
    budget = int(granule_totals(lo, hi, mask).max()) if packed else 0
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", str(budget))
    s = RunSettings(max_cardinality=8)
    (res,) = device_engine.scan_lanes(s, lanes, sa, [chunk],
                                      lambda cs, cl: (0, 0, 0))
    parts = list(res)
    assert len(parts) > 1 and any(p.n_events == 0 for p in parts)
    merged = device_engine.merge_slices(parts)
    assert (merged.n_events, merged.total_kept) == (want.n_events,
                                                    want.total_kept)
    _equal([merged.flat], [want.flat])
    got, ref = device_engine.host_events(res), device_engine.host_events(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_gpu_sliced_json_equals_host(tmp_path, gpu, monkeypatch):
    """tests/test_device_engine.py:376's satellite genome, direct and -RC,
    sliced (budget 256, 64-lane granules): the fused engine on both chains
    and the table engine with ``--checkpoint`` write the host engine's
    bytes, launching KO (and KP on the device chain)."""
    from asgart_tpu_torch import device_engine
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import search_duplications
    from util import write_fasta

    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", satellite_genome(np.random.default_rng(11)))])
    fa = str(fa)
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "256")
    monkeypatch.setattr(device_engine, "SLICE_GRAN", 64)
    for rc in (False, True):
        s = RunSettings(min_duplication_length=500, max_cardinality=500,
                        reverse=rc, complement=rc)
        host = json_text(search_duplications([fa], s, engine="host"))
        for chain, kw in (("", {}), ("1", {}),
                          ("", dict(checkpoint=str(tmp_path / f"{rc}.j")))):
            monkeypatch.setenv("ASGART_DEVICE_CHAIN", chain)
            INDEX_CACHE.clear()
            before = launch_counts()
            assert json_text(search_duplications(
                [fa], s, engine="cuda", device=gpu, **kw)) == host
            after = launch_counts()
            assert after["granule_totals"] > before["granule_totals"]
            assert (after["gather_flat"] > before["gather_flat"]) == \
                bool(chain)
    INDEX_CACHE.clear()


def test_seed_kernels_equal_plain_on_gpu(gpu):
    """KQ on tests/test_seed.py's cases (k = 20, 12 and 8: no buckets),
    the poly-A text (buckets wider than the depth) and depths too small to
    converge; KR in both forms; KS at k = 20, 12, 8 and 1; each also on
    an empty input, which launches nothing."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.index import GenomeIndex
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.kernels.seed import (equal_range_plain,
                                               gather_ranges_plain,
                                               pack_probe_planes_plain)
    from asgart_tpu_torch.pipeline import _pack_probe_kmers, probe_positions
    from util import random_dna

    rng = np.random.default_rng(41)
    texts = [(random_dna(np.random.default_rng(s), n, b"ACGTN") + b"$", k)
             for s, n, k in ((0, 3000, 20), (1, 5000, 12), (2, 2000, 8))]
    texts.append((b"A" * 500 + random_dna(rng, 1000, b"AC") + b"A" * 300
                  + b"$", 10))
    before = launch_counts()
    launches = 0
    for text, k in texts:
        arr = np.frombuffer(text, dtype=np.uint8)
        idx = GenomeIndex.build(arr, k)
        dsi = seed.DeviceSeedIndex(idx, gpu)
        is_ = probe_positions(arr[:-1], k)
        codes = np.zeros(len(arr) + k, dtype=np.uint8)
        codes[:len(arr) - 1] = CODE[arr[:-1]]
        pk = np.concatenate([_pack_probe_kmers(codes, is_, k),
                             rng.integers(0, 1 << (3 * k), 500)])
        probes = torch.from_numpy(pk).to(gpu)
        for steps in (dsi.steps, 2, 1):
            args = (dsi.keys, dsi.bucket_starts, probes, steps,
                    dsi.prefix_shift)
            _equal(seed.equal_range(*args), equal_range_plain(*args))
            launches += 1
        got = dsi.lookup(pk)
        want = idx.lookup(pk)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        launches += 1
        args = (dsi.keys, dsi.bucket_starts, probes[:0], dsi.steps,
                dsi.prefix_shift)
        assert all(t.numel() == 0 for t in seed.equal_range(*args))
        for kk in sorted({k, 1}):
            pos = torch.from_numpy(is_).to(gpu)
            t_codes = torch.from_numpy(codes).to(gpu)
            _equal(seed.pack_probe_planes(t_codes, pos, kk),
                   pack_probe_planes_plain(t_codes, pos, kk))
            launches += 1
        assert all(t.numel() == 0 for t in
                   seed.pack_probe_planes(t_codes, pos[:0], k))
    ranges = torch.from_numpy(rng.integers(-2**31, 2**31, (7000, 2))
                              .astype(np.int32)).to(gpu)
    x = torch.from_numpy(rng.integers(0, 7000, 50000)).to(gpu)
    planes = (ranges[:, 0].contiguous(), ranges[:, 1].contiguous())
    for src in ((ranges[:, 0], ranges[:, 1]), planes):
        _equal(seed.gather_ranges(*src, x), gather_ranges_plain(*src, x))
        assert all(t.numel() == 0 for t in seed.gather_ranges(*src, x[:0]))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["gather_ranges"] == before["gather_ranges"] + 2
    assert after["equal_range"] + after["pack_probe_planes"] == \
        before["equal_range"] + before["pack_probe_planes"] + launches


def _kq_table(rng, n_prefix: int = 64, empty=(3, 17, 40, 63)):
    """Sorted keys (prefix << 30 | a suffix in 0..19) with many equal runs,
    every bucket's last rows one run (so runs end at a bucket's last row),
    bucket 5 one run of 300 equal keys (an equal run past the descent's
    depth, as on the poly-A text), the buckets ``empty`` empty; the bucket
    table over prefix_shift 0 and the converging depth."""
    parts = []
    for pre in range(n_prefix):
        if pre in empty:
            continue
        suf = np.full(300, 7) if pre == 5 else \
            np.sort(rng.integers(0, 20, int(rng.integers(1, 400))))
        parts.append((np.int64(pre) << 30) | suf.astype(np.int64))
    keys = np.concatenate(parts)
    starts = np.searchsorted(keys >> 30, np.arange(n_prefix), side="left")
    table = np.concatenate([starts, [len(keys)]]).astype(np.int32)
    steps = int(np.ceil(np.log2(np.diff(table).max() + 1)))
    return keys, table, steps


def _kq_probes(rng, keys, n_prefix: int = 64, extra: int = 3000):
    """Every key, then random probes of every bucket (empty ones too) with
    suffixes 0..24 (mostly absent)."""
    pre = rng.integers(0, n_prefix, extra).astype(np.int64)
    return np.concatenate([keys, (pre << 30) | rng.integers(0, 25, extra)])


def test_equal_range_equals_plain_and_searchsorted_on_gpu(gpu):
    """KQ against its plain version at every ``steps`` from 1 to two past
    the converging depth (a bucket wider than 2^steps runs the JAX loop's
    two searches), and against two ``torch.searchsorted`` calls where the
    depth converges: a synthetic table (runs that end at a bucket's last
    row, empty buckets, a 300-key run), tests/test_seed.py's texts at k =
    20 and 8 (no buckets) and the poly-A text (k = 10)."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.index import GenomeIndex
    from asgart_tpu_torch.kernels.seed import equal_range_plain
    from asgart_tpu_torch.pipeline import _pack_probe_kmers, probe_positions
    from util import random_dna

    rng = np.random.default_rng(53)
    keys, table, depth = _kq_table(rng)
    cases = [(torch.from_numpy(keys).to(gpu), torch.from_numpy(table).to(gpu),
              torch.from_numpy(_kq_probes(rng, keys)).to(gpu), depth, 0)]
    texts = [(random_dna(np.random.default_rng(0), 3000, b"ACGTN") + b"$",
              20),
             (random_dna(np.random.default_rng(2), 2000, b"ACGTN") + b"$", 8),
             (b"A" * 500 + random_dna(rng, 1000, b"AC") + b"A" * 300 + b"$",
              10)]
    for text, k in texts:
        arr = np.frombuffer(text, dtype=np.uint8)
        dsi = seed.DeviceSeedIndex(GenomeIndex.build(arr, k), gpu)
        is_ = probe_positions(arr[:-1], k)
        codes = np.zeros(len(arr) + k, dtype=np.uint8)
        codes[:len(arr) - 1] = CODE[arr[:-1]]
        pk = np.concatenate([_pack_probe_kmers(codes, is_, k),
                             rng.integers(0, 1 << (3 * k), 500)])
        cases.append((dsi.keys, dsi.bucket_starts,
                      torch.from_numpy(pk).to(gpu), dsi.steps,
                      dsi.prefix_shift))
    assert cases[2][4] < 0  # k = 8: no buckets
    for keys_t, table_t, probes, depth, shift in cases:
        library = (torch.searchsorted(keys_t, probes, side="left"),
                   torch.searchsorted(keys_t, probes, side="right"))
        for steps in range(1, depth + 3):
            args = (keys_t, table_t, probes, steps, shift)
            got = seed.equal_range(*args)
            _equal(got, equal_range_plain(*args))
            if steps >= depth:
                _equal(got, library)


@pytest.mark.parametrize("extra", [1, 2, 3])
@pytest.mark.parametrize("base", [4096, 132 * 32 * 256])
def test_equal_range_tails_on_gpu(gpu, base, extra):
    """KQ on 1, 2 and 3 probes past a multiple of its block (256 threads,
    one probe each) and past its grid's stride (132 x 32 blocks, whose
    threads then take a second probe)."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.kernels.seed import equal_range_plain

    rng = np.random.default_rng(59 + extra)
    keys, table, depth = _kq_table(rng)
    pk = _kq_probes(rng, keys, extra=max(base + extra - len(keys), 0))
    probes = torch.from_numpy(pk[: base + extra]).to(gpu)
    args = (torch.from_numpy(keys).to(gpu), torch.from_numpy(table).to(gpu),
            probes, depth, 0)
    _equal(seed.equal_range(*args), equal_range_plain(*args))


@pytest.mark.parametrize("bad", ["negative probe", "prefix past the table",
                                 "bound below 0", "bound past N",
                                 "bounds crossed"])
def test_equal_range_outside_raises_on_gpu(gpu, bad):
    """KQ's check in the kernel: a probe that is negative or whose prefix
    lies past the bucket table, or a bucket bound outside 0 <= lo0 <= hi0
    <= N that a probe reads, raises ``ValueError``; the next call, whose
    flag is zeroed with its launch, returns its plain version's outputs."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.kernels.seed import equal_range_plain

    rng = np.random.default_rng(61)
    keys, table, depth = _kq_table(rng)
    pk = _kq_probes(rng, keys)
    args = [torch.from_numpy(keys).to(gpu), torch.from_numpy(table).to(gpu),
            torch.from_numpy(pk).to(gpu), depth, 0]
    bad_table, bad_pk = table.copy(), pk.copy()
    at = len(pk) // 2
    if bad == "negative probe":
        bad_pk[at] = -1
    elif bad == "prefix past the table":
        bad_pk[at] = np.int64(len(table) - 1) << 30
    else:
        bucket = 9
        bad_pk[at] = np.int64(bucket) << 30
        bad_table[bucket + {"bound below 0": 0, "bound past N": 1,
                            "bounds crossed": 0}[bad]] = \
            {"bound below 0": -1, "bound past N": len(keys) + 1,
             "bounds crossed": table[bucket + 1] + 1}[bad]
    with pytest.raises(ValueError, match="outside its array"):
        seed.equal_range(args[0], torch.from_numpy(bad_table).to(gpu),
                         torch.from_numpy(bad_pk).to(gpu), depth, 0)
    _equal(seed.equal_range(*args), equal_range_plain(*args))


# (keys, probes, steps, (key reads, JAX-loop probes)), no buckets: 0..7
# and probes 3 (a descent of 3 reads, then one read past its run) and 100
# (3 reads, past the end); eight 5s (4 reads down to row 0, then
# run_end's gallop to rows 1, 2, 4 and its bisection at 6 and 7); at
# steps 1 the 8-row interval is 2^1 rows or wider, so both probes take the
# JAX loop's two searches, a halving each
KQ_READS = {
    "descent and one gallop read": (list(range(8)), [3, 100], 10, (7, 0)),
    "a run to the end": ([5] * 8, [5], 10, (9, 0)),
    "the JAX loop": (list(range(8)), [3, 100], 1, (4, 2)),
}


@pytest.mark.parametrize("case", sorted(KQ_READS))
def test_equal_range_reads_exact_on_gpu(gpu, case):
    """KQ's counting instance counts the keys the kernel reads, worked
    out by hand, and returns its plain version's outputs."""
    from asgart_tpu_torch.kernels.seed import (equal_range_plain,
                                               equal_range_reads,
                                               launch_equal_range)

    keys, probes, steps, want = KQ_READS[case]
    args = (torch.tensor(keys, dtype=torch.int64, device=gpu),
            torch.zeros(0, dtype=torch.int32, device=gpu),
            torch.tensor(probes, dtype=torch.int64, device=gpu), steps, -1)
    assert equal_range_reads(*args) == want
    counts = torch.zeros(2, dtype=torch.int64, device=gpu)
    lo, hi, bad = launch_equal_range(*args, counts=counts)
    assert bad.item() == 0 and tuple(counts.tolist()) == want
    _equal((lo, hi), equal_range_plain(*args))


def test_equal_range_reads_on_gpu(gpu):
    """On the synthetic table at every ``steps`` from 1 to the converging
    depth: the probes counted as taking the JAX loop are those whose
    bucket is 2^steps rows or wider; at steps 1 each of them makes one
    halving a search and a one-row bucket's probe one read, and at the
    depth the probes of non-empty buckets read at least one key each and
    at most 2 x depth + 1 each on average."""
    from asgart_tpu_torch.kernels.seed import equal_range_reads

    rng = np.random.default_rng(67)
    keys, table, depth = _kq_table(rng)
    pk = _kq_probes(rng, keys)
    width = np.diff(table.astype(np.int64))[pk >> 30]
    args = [torch.from_numpy(keys).to(gpu), torch.from_numpy(table).to(gpu),
            torch.from_numpy(pk).to(gpu), 0, 0]
    for steps in range(1, depth + 1):
        args[3] = steps
        reads, jax_loop = equal_range_reads(*args)
        assert jax_loop == int((width >= 1 << steps).sum())
        if steps == 1:
            assert reads == 2 * jax_loop + int((width == 1).sum())
    live = int((width > 0).sum())
    assert jax_loop == 0 and live <= reads <= (2 * depth + 1) * live


@pytest.mark.parametrize("form", ["rows", "planar"])
@pytest.mark.parametrize("bad", [-1, "n", 1 << 40])
def test_gather_ranges_outside_raises_on_gpu(gpu, form, bad):
    """KR's check in the kernel, in both forms: an index of -1, n or far
    past n raises ``ValueError``; the next call, whose flag is zeroed
    with its launch, returns its plain version's outputs."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.kernels.seed import gather_ranges_plain

    rng = np.random.default_rng(43)
    n = 7000
    ranges = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 2))
                              .astype(np.int32)).to(gpu)
    src = ((ranges[:, 0], ranges[:, 1]) if form == "rows"
           else (ranges[:, 0].contiguous(), ranges[:, 1].contiguous()))
    x = torch.from_numpy(rng.integers(0, n, 50000)).to(gpu)
    bad_x = x.clone()
    bad_x[31337] = n if bad == "n" else bad
    with pytest.raises(ValueError, match="outside"):
        seed.gather_ranges(*src, bad_x)
    _equal(seed.gather_ranges(*src, x), gather_ranges_plain(*src, x))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gather_ranges_row_views_on_gpu(gpu, offset):
    """KR's rows form on an [n, 2] view at an int32 offset: at an odd one
    the columns are not 8-byte aligned and the kernel reads each row as
    two 4-byte loads; at an even one as one 8-byte load. Both equal the
    plain version, and ``x`` may be a view at an odd offset too."""
    from asgart_tpu_torch import seed
    from asgart_tpu_torch.kernels.seed import gather_ranges_plain

    rng = np.random.default_rng(47 + offset)
    n = 9001
    buf = torch.from_numpy(rng.integers(-2**31, 2**31, 2 * n + 4)
                           .astype(np.int32)).to(gpu)
    rows = buf[offset: offset + 2 * n].view(n, 2)
    x = torch.from_numpy(rng.integers(0, n, 40001)).to(gpu)[offset:]
    src = (rows[:, 0], rows[:, 1])
    _equal(seed.gather_ranges(*src, x), gather_ranges_plain(*src, x))
    _equal(seed._gather_range_rows(rows, x),
           (rows[x, 0].long(), rows[x, 1].long()))


@pytest.mark.parametrize("rc", [False, True])
def test_gpu_seed_routes_equal_host(tmp_path, gpu, monkeypatch, rc):
    """``SearchEngine(engine="cuda")`` on a trim window at k = 20 (KQ) and
    the whole genome at k = 21 (KR) chunk by chunk against the host
    engine; then the k = 21 route of ``search_duplications``, beyond the
    fused build and the table, journaled or not, writing the host
    engine's bytes."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import SearchEngine, search_duplications

    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    for k, trim, kernel in ((20, (12000, 52000), "equal_range"),
                            (21, None, "gather_ranges")):
        s = RunSettings(probe_size=k, trim=trim, reverse=rc, complement=rc)
        _, chunks, strand = pipeline.prepare_data([fa], False, trim)
        before = launch_counts()[kernel]
        se = SearchEngine(strand, s, trim, engine="cuda", device=gpu)
        host = SearchEngine(strand, s, trim, engine="host")
        for c in chunks:
            assert [[vars(sd) for sd in f] for f in se.run_chunk(c)] == \
                [[vars(sd) for sd in f] for f in host.run_chunk(c)]
        assert launch_counts()[kernel] > before
    s = RunSettings(probe_size=21, reverse=rc, complement=rc)
    want = json_text(search_duplications([fa], s, engine="host"))
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setattr(pipeline, "table_fits", lambda *a, **kw: False)
    for ck in (None, str(tmp_path / f"{rc}.j")):
        before = launch_counts()["gather_ranges"]
        assert json_text(search_duplications([fa], s, engine="cuda",
                                             device=gpu,
                                             checkpoint=ck)) == want
        assert launch_counts()["gather_ranges"] > before


@pytest.mark.parametrize("W,n_ranks", [(100003, 4), (100003, 8), (5, 8)])
def test_gather_owned_equals_plain_on_gpu(gpu, W, n_ranks):
    """KT on every rank's shard against its plain version: random windows
    of a W-row order (lanes that end at a shard boundary, span three
    shards, are empty or masked), every shard including those that own no
    row (W = 5 over 8 ranks); the shards' buffers sum to the windows. An
    empty buffer launches nothing. Then a chunk shaped like rank_trim4's
    largest: 6.4 M lanes, about 0.4% of them with entries, and one lane
    spanning three shards."""
    from asgart_tpu_torch.kernels import gather_owned, launch_counts
    from asgart_tpu_torch.kernels.sharded import (csr_offsets,
                                                  gather_owned_plain)

    rng = np.random.default_rng(W + n_ranks)
    Wl = -(-W // n_ranks)
    n = 20000
    lo = rng.integers(0, W, n)
    hi = np.minimum(W, lo + rng.integers(0, 3 * Wl if W > 5 else 3, n))
    if W > 5:  # end at a shard's end, span three shards, span all
        lo[:3] = [Wl - 3, Wl - 2, 0]
        hi[:3] = [Wl, 3 * Wl + 1, W]
    mask = rng.random(n) >= 0.1
    lo, hi = np.where(mask, lo, 0), np.where(mask, hi, 0)
    sa = rng.permutation(W).astype(np.int32)
    t = [torch.from_numpy(a).to(gpu) for a in
         (lo.astype(np.int32), hi.astype(np.int32), mask)]
    off, total = csr_offsets(*t)
    before = launch_counts()["gather_owned"]
    summed = torch.zeros(total, dtype=torch.int64, device=gpu)
    for r in range(n_ranks):
        a, b = min(W, r * Wl), min(W, (r + 1) * Wl)
        shard = torch.from_numpy(sa[a:b].copy()).to(gpu)
        got = gather_owned(*t, off, total, shard, a)
        _equal([got], [gather_owned_plain(*t, off, total, shard, a)])
        summed += got
    torch.cuda.synchronize()
    want = np.concatenate([sa[x:y] for x, y, m in zip(lo, hi, mask) if m])
    assert np.array_equal(summed.cpu().numpy(), want)
    assert launch_counts()["gather_owned"] == before + n_ranks
    empty = gather_owned(*(x[:0] for x in t), off[:0], 0, shard, 0)
    assert empty.numel() == 0
    assert launch_counts()["gather_owned"] == before + n_ranks
    # a chunk shaped like rank_trim4's largest: 6.4 M lanes, about 0.4% of
    # them with entries (1 to 4 each), and one lane of 3 Wl + 5 entries
    n = 6_400_000
    lo = rng.integers(0, W, n)
    hi = np.where(rng.random(n) < 0.004,
                  np.minimum(W, lo + rng.integers(1, 5, n)), lo)
    lo[n // 2], hi[n // 2] = 0, min(W, 3 * Wl + 5)
    mask = rng.random(n) >= 0.05
    mask[n // 2] = True
    t = [torch.from_numpy(a).to(gpu) for a in
         (lo.astype(np.int32), hi.astype(np.int32), mask)]
    off, total = csr_offsets(*t)
    for r in range(n_ranks):
        a, b = min(W, r * Wl), min(W, (r + 1) * Wl)
        shard = torch.from_numpy(sa[a:b].copy()).to(gpu)
        _equal([gather_owned(*t, off, total, shard, a)],
               [gather_owned_plain(*t, off, total, shard, a)])


def test_gpu_rank_sharded_json_equals_host(tmp_path, gpu, monkeypatch):
    """``ASGART_RANK_SHARDED=1`` on one rank (the fused build refused): the
    rank-sharded engine, built on the card and on the host, writes the
    host engine's bytes through KA, KH, KT and KD."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.pipeline import search_duplications

    fa, _, _ = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(reverse=True, complement=True, trim=(9000, 47000))
    want = json_text(search_duplications([fa], s, engine="host"))
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
    monkeypatch.setenv("ASGART_RANK_SHARDED", "1")
    for hb in ("0", "1"):
        monkeypatch.setenv("ASGART_RSH_HOST_BUILD", hb)
        INDEX_CACHE.clear()
        before = launch_counts()
        assert json_text(search_duplications([fa], s, engine="cuda",
                                             device=gpu)) == want
        after = launch_counts()
        for name in ("pack_keys", "mj_ranges", "gather_owned", "scan_core"):
            assert after[name] > before[name], (hb, name)


@pytest.mark.parametrize("form", ["mesh", "journal"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gpu_ranks_mesh_and_journal_json_equal_one_device(tmp_path, gpu,
                                                          n_ranks, form):
    """Gloo ranks sharing ``cuda:0`` (``distributed.dryrun``): ``--shards
    2`` on the windows x probes mesh (2 ranks: 2 x 1; 4 ranks: 2 x 2, both
    probe slots of a window scanning lanes at k = 12), launching KA, KH
    and KD on every rank, and on 4 ranks KP, which merges each window's
    cells; and ``--checkpoint`` on the table engine's
    probe axis (KM and KD on every rank), cold, then resumed from its
    first record; every rank's JSON is the one-device run's, which is
    the host engine's."""
    from asgart_tpu_torch import distributed
    from asgart_tpu_torch.device_engine import chunk_specs, probe_lanes
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications

    from torch_jax_ref import mesh_genome

    fa, chunks, _ = prepared(tmp_path, [("chr1", mesh_genome())])
    s = RunSettings(probe_size=12, reverse=True, complement=True,
                    min_duplication_length=800)
    shards = 2 if form == "mesh" else 1
    want = json_text(search_duplications([fa], s, engine="cuda",
                                         device=gpu, shards=shards))
    INDEX_CACHE.clear()
    torch.cuda.empty_cache()
    assert '"families": []' not in want
    # the one-device run is the host engine's, so a fault that both CUDA
    # runs share cannot pass
    host = json_text(search_duplications([fa], s, engine="host",
                                         shards=shards))
    assert want == host
    journal = str(tmp_path / "run.journal") if form == "journal" else None
    kernels = ("pack_keys", "mj_ranges", "scan_core") if form == "mesh" \
        else ("table_ranges", "scan_core")
    if form == "mesh" and n_ranks > shards:  # KP merges a window's cells
        kernels += ("gather_flat",)
    for rerun in (False, True) if journal else (False,):
        if rerun:  # resume from the header and the first record
            lines = open(journal).read().splitlines()
            with open(journal, "w") as fh:
                fh.write("\n".join(lines[:2]) + "\n")
        text, reports = distributed.dryrun(
            n_ranks, "cuda:0", fa=fa, settings=s, host=host, timeout=600,
            shards=shards, checkpoint=journal)
        assert text == want
        # KD runs on the ranks that hold lanes of a scanned chunk (the
        # resumed run scans the 60 kb record alone, whose lanes all fall
        # to rank 0; on 4 ranks the 220 kb record's fill ranks 0-2); KA,
        # KH and KM read every lane on every rank
        P = n_ranks // shards
        scanned = chunk_specs(chunks[1:] if rerun else chunks, s)
        for rep in reports:
            p = rep["rank"] % P
            holds = any(a < b for _, _, nc in scanned
                        for a, b in [probe_lanes(nc, p, P)])
            for name in kernels:
                assert (rep["launches"][name] > 0) == \
                    (holds or name != "scan_core"), (rep["rank"], name)
        if form == "mesh":
            P = n_ranks // 2
            assert [(r["profile"]["mesh"]["w"], r["profile"]["mesh"]["p"])
                    for r in reports] == [(r // P, r % P)
                                          for r in range(n_ranks)]
            assert all(r["profile"]["mesh"]["lanes"][0] > 0
                       for r in reports)


def _kd_lanes(rng, n, N, long_frac=0.1, maxlen=100, mask_p=0.9):
    """Seeded lane windows over an N-entry order: most 0-3 entries long,
    ``long_frac`` of them up to ``maxlen``; ``mask_p`` of them masked in."""
    L = rng.integers(0, 4, n)
    longs = rng.random(n) < long_frac
    L[longs] = rng.integers(0, maxlen, int(longs.sum()))
    lo = rng.integers(0, np.maximum(N - L, 1))
    hi = np.minimum(lo + L, N)
    return (lo.astype(np.int32), hi.astype(np.int32), rng.random(n) < mask_p)


def _kd_equal(gpu, lo, hi, mask, sa, consts, max_card, j0=0, k=20,
              reverse=False):
    """KD against its plain version on the same inputs (exact); returns
    KD's result."""
    from asgart_tpu_torch.kernels import scan_core
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain

    t = [torch.from_numpy(np.ascontiguousarray(a)).to(gpu)
         for a in (lo, hi, mask, sa)]
    args = (*t, *consts, max_card, j0, k, reverse)
    got, want = scan_core(*args), scan_core_plain(*args)
    assert (got.n_events, got.total_kept) == (want.n_events,
                                              want.total_kept)
    _equal([got.flat], [want.flat])
    return got


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1023, 1024, 1025, 4097,
                               132 * 32 * 256 + 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_core_lane_counts_on_gpu(gpu, n, reverse):
    """KD at lane counts around a warp, a block (1024 lanes) and past a
    grid-stride loop's stride (132 x 32 blocks of 256), with short and long
    windows (thread and warp walks), j0 > 0 and a max_cardinality that some
    lanes pass; one launch a call (none for no lane)."""
    from asgart_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(n + reverse)
    N = 200_000
    lo, hi, mask = _kd_lanes(rng, n, N)
    sa = rng.permutation(N).astype(np.int32)
    before = launch_counts()["scan_core"]
    _kd_equal(gpu, lo, hi, mask, sa, (0, 5000, 150_000), 8, j0=37,
              reverse=reverse)
    assert launch_counts()["scan_core"] == before + (n > 0)


@pytest.mark.parametrize("case", ["all masked", "block boundary",
                                  "max_card", "max_card + 1"])
@pytest.mark.parametrize("length", [5, 31, 32, 33, 300])
def test_scan_core_edges_on_gpu(gpu, case, length):
    """KD with every lane masked out; with events only on both sides of a
    block boundary (lanes 1023 and 1024, 2047 and 2048); and with windows
    that keep exactly max_cardinality and max_cardinality + 1 matches (an
    event, then a lane that is neither); each at a window length below, at
    and past the warp walk's threshold (32)."""
    n, N = 3000, 50_000
    rng = np.random.default_rng(length)
    sa = rng.permutation(N).astype(np.int32) + N  # every m > i + dir_base
    lo = (np.arange(n) * 7 % (N - length)).astype(np.int32)
    hi = lo + np.int32(length)
    mask = np.ones(n, dtype=bool)
    max_card = length
    if case == "all masked":
        mask[:] = False
    elif case == "block boundary":
        mask[:] = False
        mask[[1023, 1024, 2047, 2048]] = True
    elif case == "max_card + 1":
        max_card = length - 1
    res = _kd_equal(gpu, lo, hi, mask, sa, (0, 0, 0), max_card)
    want_events = {"all masked": 0, "block boundary": 4, "max_card": n,
                   "max_card + 1": 0}[case]
    assert res.n_events == want_events


@pytest.mark.parametrize("keep", [False, True])
def test_scan_core_long_window_on_gpu(gpu, keep):
    """One window of 10^6 entries among short ones: every match rejected
    (dir_base above every m), or every match kept (dir_base below every i,
    max_cardinality above 10^6): the warp walk's counts and its coalesced
    writes in slot order."""
    n, N = 3000, 1_200_000
    rng = np.random.default_rng(keep)
    lo, hi, mask = _kd_lanes(rng, n, N, long_frac=0.0)
    lo[1234], hi[1234], mask[1234] = 100_000, 1_100_000, True
    sa = rng.permutation(N).astype(np.int32)
    dir_base = -(10 ** 7) if keep else 10 ** 8
    res = _kd_equal(gpu, lo, hi, mask, sa, (-(10 ** 8), dir_base, 0),
                    2_000_000)
    assert (res.total_kept >= 10 ** 6) == keep


def test_scan_core_rebased_and_gathered_on_gpu(gpu):
    """KD with the merge-join engine's rebased constants on a
    window-relative order, and on the buffer the rank-sharded engine
    passes in place of sa (KT's gather of every window, with the CSR
    windows): the same events and matches as over sa."""
    from asgart_tpu_torch.device_engine import rebased_bases
    from asgart_tpu_torch.kernels import gather_owned
    from asgart_tpu_torch.kernels.sharded import csr_offsets

    rng = np.random.default_rng(11)
    W, n = 300_000, 20_000
    lo, hi, mask = _kd_lanes(rng, n, W, long_frac=0.2, maxlen=80)
    sa = rng.permutation(W).astype(np.int32)
    consts = rebased_bases(40_000_000, 200_000, 39_900_000, W)
    over_sa = _kd_equal(gpu, lo, hi, mask, sa, consts, 20, j0=5,
                        reverse=True)
    t = [torch.from_numpy(a).to(gpu) for a in (lo, hi, mask)]
    off, total = csr_offsets(*t)
    flat = gather_owned(*t, off, total, torch.from_numpy(sa).to(gpu), 0)
    end = off + torch.where(t[2], t[1] - t[0], 0)
    g = _kd_equal(gpu, off.to(torch.int32).cpu().numpy(),
                  end.to(torch.int32).cpu().numpy(), mask,
                  flat.cpu().numpy(), consts, 20, j0=5, reverse=True)
    _equal([g.flat], [over_sa.flat])


def _kc_equal(gpu, M, W, n_chunks, seed):
    """KC against its plain version on a random permutation of M rows, W of
    them direct, the M - W lanes cut into n_chunks chunks."""
    from asgart_tpu_torch.kernels import invert_fused, launch_counts
    from asgart_tpu_torch.kernels.invert import invert_fused_plain

    rng = np.random.default_rng(seed)
    total = M - W
    sa = torch.from_numpy(rng.permutation(M).astype(np.int32)).to(gpu)
    lo = torch.from_numpy(rng.integers(0, 1 << 30, M).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(0, 100, M).astype(np.int32))
    mask = torch.from_numpy(rng.random(total) < 0.8).to(gpu)
    cuts = sorted(rng.integers(0, total + 1, max(n_chunks - 1, 0)).tolist())
    lane_off = [0] + cuts + [total] if n_chunks else [0]
    args = (sa, lo.to(gpu), hi.to(gpu), mask, W, lane_off)
    before = launch_counts()["invert_fused"]
    got = invert_fused(*args)
    _equal(got, invert_fused_plain(*args))
    assert launch_counts()["invert_fused"] == before + (M > 0)


@pytest.mark.parametrize("M,W,n_chunks", [
    (1, 1, 0), (1, 0, 1), (5000, 0, 3), (5000, 5000, 0),
    ((1 << 21) + 3, (1 << 21) + 3, 0), ((1 << 22) + 7, (1 << 21) + 5, 4),
    ((1 << 21) + 100, 1 << 21, 2), (3 << 21, 3 << 20, 256),
    (3 << 21, 3 << 20, 257), ((1 << 25) + 1, (1 << 25) - 999, 1),
    (8193, 8192, 1), (3 * 8192 + 1, 8000, 3), (0, 0, 2)])
def test_invert_fused_partition_on_gpu(gpu, M, W, n_chunks):
    """KC's partitioned scatter against its plain version: one row, W = M
    and W = 0; M off the bucket width (2^21) and off the tile width (2^13);
    a bucket and a tile straddling W (their rows split between rank and
    the lanes); chunk counts at the by-value capacity (256) and one past
    it; 17 buckets; no row (zero totals, no launch)."""
    _kc_equal(gpu, M, W, n_chunks, M + W + n_chunks)


@pytest.mark.parametrize("M", [1, 8191, 8193, (1 << 21) + 5, 1 << 24])
def test_invert_tables_partition_on_gpu(gpu, M):
    """KJ, the table form of KC's partitioned scatter, against its plain
    version on a random permutation: one row, off the tile width (2^13)
    on both sides, off the bucket width (2^21), and 2^24 rows; run_lo
    with its sign bit set on some rows (KB's N flag). One KJ launch
    counted, none of KC."""
    from asgart_tpu_torch.kernels import invert_tables, launch_counts
    from asgart_tpu_torch.kernels.tables import invert_tables_plain

    rng = np.random.default_rng(M)
    sa = torch.from_numpy(rng.permutation(M).astype(np.int32)).to(gpu)
    lo = rng.integers(-(1 << 31), 1 << 31, M, dtype=np.int64)
    hi = rng.integers(0, 1 << 31, M, dtype=np.int64)
    lo, hi = (torch.from_numpy(a.astype(np.int32)).to(gpu) for a in (lo, hi))
    before = launch_counts()
    got = invert_tables(sa, lo, hi, 1)
    _equal(got, invert_tables_plain(sa, lo, hi, 1))
    after = launch_counts()
    assert after["invert_tables"] == before["invert_tables"] + 1
    assert after["invert_fused"] == before["invert_fused"]


def test_table_build_launch_counts_on_gpu(tmp_path, gpu):
    """The table build launches KJ once and KC never."""
    from asgart_tpu_torch.kernels import launch_counts
    from asgart_tpu_torch.table_index import DeviceIndex

    _, _, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    for doubled in (True, False):
        before = launch_counts()
        DeviceIndex.build(strand.data, 20, doubled, doubled, gpu)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["invert_tables"] == before["invert_tables"] + 1
        assert after["invert_fused"] == before["invert_fused"]


def _mj_keys(rng, k, W, alphabet):
    """W sorted one-word window keys (flag 0) of k symbols drawn from
    ``alphabet`` (3-bit ranks)."""
    syms = rng.choice(alphabet, size=(W, k))
    v = np.zeros(W, dtype=np.int64)
    for t in range(k):
        v = (v << 3) | syms[:, t]
    return np.sort(v) << 1


# (k, W, alphabet, form): W = 1; every key in one bucket (one repeated
# key); empty buckets (two symbols of four); '$' and N ranks; k below the
# directory's symbols; k = 2 and k = 20; the directory's least window (48)
# and one under it (no directory)
MJ_CASES = [(20, 1, (1, 2, 3, 5), "random"), (20, 5000, (1,), "random"),
            (20, 5000, (1, 5), "random"), (8, 3000, (0, 1, 4, 5), "random"),
            (3, 4000, (1, 2, 3, 5), "random"), (2, 3000, (0, 1, 2, 3, 4, 5),
                                                "random"),
            (20, 200_000, (1, 2, 3, 5), "random"),
            (20, 200_000, (1, 2, 3, 5), "repeats"),
            (12, 48, (1, 2, 3, 5), "random"), (12, 47, (1, 2, 3, 5),
                                               "random")]


@pytest.mark.parametrize("k,W,alphabet,form", MJ_CASES)
def test_mj_directory_and_ranges_on_gpu(gpu, k, W, alphabet, form):
    """KH's key directory against its plain version, and KH searching from
    it (and without it) against its plain version, with probes from the
    window, absent ones, masked lanes, a negative key and one past k
    symbols; its reads counted with and without the directory."""
    from asgart_tpu_torch.kernels import launch_counts, mj_directory, \
        mj_ranges
    from asgart_tpu_torch.kernels.merge_join import (mj_directory_plain,
                                                     mj_ranges_plain,
                                                     mj_ranges_reads)

    rng = np.random.default_rng(W + k)
    skey = _mj_keys(rng, k, W, alphabet)
    if form == "repeats":  # a quarter of the window one key
        skey[W // 2: W // 2 + W // 4] = skey[W // 2]
        skey = np.sort(skey)
    B = 3 * W + 100
    pkey = _mj_keys(rng, k, B, alphabet) | 1
    take = rng.random(B) < 0.5
    pkey[take] = skey[rng.integers(0, W, B)[take]] | 1
    pkey[:2] = (-(1 << 40)) | 1, ((1 << (3 * k)) + 5) << 1 | 1
    mask = rng.random(B) < 0.8
    mask[:2] = True
    lane_off = [0, *sorted(rng.integers(0, B + 1, 3).tolist()), B]
    skey, pkey, mask = (torch.from_numpy(a).to(gpu)
                        for a in (skey, pkey, mask))
    before = launch_counts()
    d = mj_directory(skey, k)
    if d is not None:
        d.check()
        assert launch_counts()["mj_directory"] == \
            before["mj_directory"] + 1
        assert (1 << d.bits) + 1 <= W // 16
        _equal((d.table,), (mj_directory_plain(skey, k, d.bits).table,))
    else:
        assert W < 48 and launch_counts() == before
    want = mj_ranges_plain(skey, pkey, mask, lane_off)
    _equal(mj_ranges(skey, pkey, mask, lane_off, d), want)
    _equal(mj_ranges(skey, pkey, mask, lane_off), want)
    reads, dir_reads = mj_ranges_reads(skey, pkey, mask, lane_off, d)
    reads0, dir0 = mj_ranges_reads(skey, pkey, mask, lane_off)
    assert dir0 == 0 and reads0 > 0 and reads > 0
    assert dir_reads == (2 * int(mask[2:].sum()) if d is not None else 0)


def test_mj_directory_on_shard_and_refusal_on_gpu(gpu):
    """A shard's directory (keys[a:b] of 4 shards) equals its plain
    version, and KH from it equals the plain version on the shard; keys
    out of order or past k symbols raise."""
    from asgart_tpu_torch.kernels import mj_directory, mj_ranges
    from asgart_tpu_torch.kernels.merge_join import (mj_directory_plain,
                                                     mj_ranges_plain)

    rng = np.random.default_rng(7)
    W, k = 100_001, 20
    skey = torch.from_numpy(_mj_keys(rng, k, W, (1, 2, 3, 5))).to(gpu)
    Wl = -(-W // 4)
    pkey = skey[rng.integers(0, W, 5000)] | 1
    mask = torch.ones(5000, dtype=torch.bool, device=gpu)
    for r in range(4):
        key = skey[min(W, r * Wl): min(W, (r + 1) * Wl)].clone()
        d = mj_directory(key, k).check()
        _equal((d.table,), (mj_directory_plain(key, k, d.bits).table,))
        _equal(mj_ranges(key, pkey, mask, [0, 5000], d),
               mj_ranges_plain(key, pkey, mask, [0, 5000]))
    with pytest.raises(ValueError, match="below its predecessor"):
        mj_directory(skey.flip(0).contiguous(), k).check()
    with pytest.raises(ValueError, match="outside k symbols"):
        mj_directory(skey, 8).check()


# (k, W, form, offset): the directory kernel's edges. A thread takes 4
# rows, a warp 128, a block 1024: W = 48 (the least directory), rows at
# the thread, warp and block edges, the grid-stride's second sweep (past
# 4.3 M rows), long bucket runs (a sparse key set: the warp writes them),
# '$' and N, keys in 8-byte alignment only (offset 1: no 16-byte loads),
# tiles of more than 31 change rows (several rounds of bucket_of)
DIR_EDGES = [(20, 48, "random", 0), (20, 127, "random", 0),
             (20, 128, "random", 1), (20, 129, "sparse", 0),
             (20, 1023, "random", 0), (20, 1024, "sparse", 1),
             (20, 1025, "dollar_n", 0), (12, 4099, "dollar_n", 1),
             (20, 5_000_003, "random", 0), (20, 5_000_003, "random", 1),
             (20, 200_001, "sparse", 0), (4, 100_000, "random", 0),
             (20, 5000, "dollar_n", 0)]


def _dir_keys(rng, k, W, form):
    if form == "sparse":  # few distinct keys far apart in the key space
        v = np.sort(rng.integers(0, 1 << (3 * k), 7)) // 8 * 8
        return np.sort(v[rng.integers(0, 7, W)]) << 1
    alphabet = (0, 1, 2, 3, 4, 5) if form == "dollar_n" else (1, 2, 3, 5)
    return _mj_keys(rng, k, W, alphabet)


@pytest.mark.parametrize("k,W,form,offset", DIR_EDGES)
def test_mj_directory_edges_on_gpu(gpu, k, W, form, offset):
    """The directory kernel (4 rows a thread, a warp's predecessor from the
    lane before, its bucket computed only where a key's first symbols
    change) against its plain version at its thread, warp and block edges,
    over two grid sweeps, on long bucket runs and on keys without 16-byte
    alignment; its wrapper reads nothing back (the flag stays on the card
    until ``check``); one key out of order at a warp edge, and one past k
    symbols in the last row, flag it."""
    from asgart_tpu_torch.kernels import mj_directory
    from asgart_tpu_torch.kernels.merge_join import mj_directory_plain

    rng = np.random.default_rng(W + offset)
    key = _dir_keys(rng, k, W, form)
    buf = torch.zeros(W + 2, dtype=torch.int64, device=gpu)
    skey = buf[offset:offset + W]
    skey.copy_(torch.from_numpy(key))
    d = mj_directory(skey, k)
    assert d.flag.device.type == "cuda"
    assert d.check() is d
    _equal((d.table,), (mj_directory_plain(skey, k, d.bits).table,))
    for at in sorted({min(W - 1, 128), min(W - 1, 1024), W // 2}):
        bad = skey.clone()
        bad[at - 1], bad[at] = int(skey[at]) + 2, int(skey[at - 1])
        with pytest.raises(ValueError, match="below its predecessor"):
            mj_directory(bad, k).check()
    bad = skey.clone()
    bad[-1] = (1 << (3 * k)) << 1
    with pytest.raises(ValueError, match="outside k symbols"):
        mj_directory(bad, k).check()


def _ka_codes(rng, n, offset, gpu):
    """Genome codes (A, C, G, T, a few N runs) and the '$', as a view
    ``offset`` bytes into a larger tensor on the GPU."""
    g = rng.choice(np.array([1, 2, 3, 5], dtype=np.uint8), n)
    for _ in range(4):
        a = int(rng.integers(0, n))
        g[a:a + int(rng.integers(1, 40))] = 4
    g = np.concatenate([g, [0]]).astype(np.uint8)
    buf = torch.zeros(len(g) + 64, dtype=torch.uint8, device=gpu)
    buf[offset:offset + len(g)] = torch.from_numpy(g).to(gpu)
    return buf[offset:offset + len(g)]


@pytest.mark.parametrize("k", [2, 10, 11, 20, 21, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_pack_keys_tiles_on_gpu(gpu, reverse, complement, k):
    """KA against its plain version in every mode at its tile, chunk and k
    edges: probe-only over chunks of 1023, 3, 1025 and 1024 lanes (tiles
    of 1024 lanes ending mid-chunk) with pad rows past them, and over
    chunks with more lanes than their length holds at both ends of the
    genome (reads past the probe source); fused (whole genome, then the
    lanes); window keys (W = 2049, a window ending at the '$', W = 1);
    a fused trim window; the doubled text (R/C runs); codes at aligned and
    odd addresses. One launch counted a call."""
    from asgart_tpu_torch.kernels import launch_counts, pack_keys
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)

    rng = np.random.default_rng(k * 4 + 2 * reverse + complement)
    step = k // 2
    counts = (1023, 3, 1025, 1024)
    need = sum(nc * step + k + step + 17 for nc in counts) + 4200
    for offset in (0, 3):
        codes = _ka_codes(rng, need, offset, gpu)
        n1 = codes.numel()
        specs, pos = [], 5
        for nc in counts:
            cl = nc * step + k + step
            specs.append((pos, cl, nc))
            pos += cl + 17
        specs = tuple(specs)
        live = sum(counts)
        tail = ((5, 100, 1025), (n1 - 151, 100, 1025))
        cases = [(specs, 0, live + 1025, 0, False),
                 (tail, 0, 2050, 0, False),
                 (specs, n1, live + 3, 0, False),
                 ((), 2049, 0, 1000, False),
                 ((), 2048, 0, n1 - 2048, False),
                 ((), 1, 0, 7, False),
                 (specs, 4097, live, 333, False),
                 ((), 0, 2050, 0, False)]
        if reverse or complement:
            cases.append(((), 2 * n1 - 1, 0, 0, True))
        for sp, W, total, ws, doubled in cases:
            before = launch_counts()["pack_keys"]
            got = pack_keys(codes, sp, k, reverse, complement, W, total, ws,
                            doubled)
            assert launch_counts()["pack_keys"] == before + 1
            tabs = chunk_tables(sp, n1, k, reverse, complement)
            want = pack_keys_plain(codes, *tabs, k, reverse, complement, W,
                                   total, ws, doubled)
            _equal([*got[0], got[1]], [*want[0], want[1]])


def _kl_inputs(rng, n, runs, gpu):
    """A sorted round key of n rows in runs of the given lengths (cycled),
    a random permutation ``order`` and random ranks."""
    lens = []
    while sum(lens) < n:
        lens.append(runs[len(lens) % len(runs)])
    lens[-1] -= sum(lens) - n
    skey = np.repeat(np.cumsum(rng.integers(1, 5, len(lens))), lens)
    order = rng.permutation(n).astype(np.int64)
    rank = rng.integers(0, n, n).astype(np.int32)
    return (torch.from_numpy(skey.astype(np.int64)).to(gpu),
            torch.from_numpy(order).to(gpu), torch.from_numpy(rank).to(gpu))


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("n,runs", [
    (1, (1,)), (5000, (1, 2, 7)), ((1 << 13) - 1, (1, 3)),
    ((1 << 13) + 1, (2, 1)), ((1 << 21) + 5, (1, 1, 4, 30)),
    (20_000, (20_000,)), (20_000, (1,)), (50_000, (10_000, 1, 3))])
def test_full_round_refine_on_gpu(gpu, n, runs, whole):
    """KL (its in-order pass, then KC's scatter with M = W = n) against its
    plain version, rank compared too: one row, below one tile (2^13), off
    the tile on both sides, off the bucket (2^21), every row tied, none
    tied, runs longer than a tile; half the positions direct, or all
    (``direct_bound = n``). One KL launch counted, none of KC."""
    from asgart_tpu_torch.kernels import full_round_refine, launch_counts
    from asgart_tpu_torch.kernels.ties import full_round_refine_plain

    rng = np.random.default_rng(n + len(runs))
    skey, order, rank = _kl_inputs(rng, n, runs, gpu)
    bound = n if whole else n // 2 + 1
    rank_p = rank.clone()
    before = launch_counts()
    got = full_round_refine(skey, order, rank, bound)
    after = launch_counts()
    want = full_round_refine_plain(skey, order, rank_p, bound)
    _equal([*got, rank], [*want, rank_p])
    assert after["full_round_refine"] == before["full_round_refine"] + 1
    assert after["invert_fused"] == before["invert_fused"]


@pytest.mark.parametrize("ranks", ["random", "tied", "distinct"])
@pytest.mark.parametrize("n", [1, (1 << 13) - 1, (1 << 13) + 1,
                               (1 << 21) + 5, 5_000_003])
def test_full_round_keys_on_gpu(gpu, n, ranks):
    """KK (4 rows a thread, 16-byte loads and stores, the shifted read as
    one load where h is a multiple of 4) against its plain version, past
    the grid's first sweep (4.3 M rows) too: h = 0 (one row), 1, 20, 25,
    n - 1 and n; direct_bound 0, n / 2 and n; every position tied (one rank), none (every rank distinct);
    ranks in 4-byte alignment only (a view at offset 1: scalar loads). One
    launch a call."""
    from asgart_tpu_torch.kernels import full_round_keys, launch_counts
    from asgart_tpu_torch.kernels.ties import full_round_keys_plain

    rng = np.random.default_rng(n)
    if ranks == "random":
        r = rng.integers(0, 1 << 31, n)
    elif ranks == "tied":
        r = np.zeros(n)
    else:
        r = rng.permutation(n)
    for offset in (0, 1):
        buf = torch.zeros(n + 4, dtype=torch.int32, device=gpu)
        rank = buf[offset:offset + n]
        rank.copy_(torch.from_numpy(r.astype(np.int32)))
        for h in sorted({min(n, x) for x in (1, 20, 25, n - 1, n)}):
            for bound in (0, n // 2, n):
                before = launch_counts()["full_round_keys"]
                got = full_round_keys(rank, h, bound)
                assert launch_counts()["full_round_keys"] == before + 1
                _equal((got,), (full_round_keys_plain(rank, h, bound),))


def _tie_round(rng, n, ties):
    """One tie round's inputs for KF: sorted keys (every key distinct,
    one key, or runs of 1-40 entries), their source order, ascending slots
    in an sa of 4 n rows, distinct positions in a rank of 2 n + 1."""
    if ties == "none":
        skey = np.arange(n, dtype=np.int64)
    elif ties == "all":
        skey = np.zeros(n, dtype=np.int64)
    else:
        skey = np.repeat(np.arange(n), rng.integers(1, 41, n))[:n]
    slots = np.sort(rng.choice(4 * n, n, replace=False)).astype(np.int32)
    ps = rng.choice(2 * n + 1, n, replace=False).astype(np.int32)
    order = rng.permutation(n).astype(np.int64)
    sa = rng.integers(0, 2 * n + 1, 4 * n).astype(np.int32)
    rank = rng.integers(0, 4 * n, 2 * n + 1).astype(np.int32)
    return skey, order, slots, ps, sa, rank


@pytest.mark.parametrize("ties", ["none", "all", "runs"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1025, 33 * 256 + 7,
                               1_220_234])
def test_tie_refine_compacts_on_gpu(gpu, n, ties):
    """KF's single-pass compaction (tiles of 256 entries, decoupled
    look-back) against its plain version: no entry still tied, every
    entry still tied, sub-runs across the tiles' edges, one entry, a tile
    and one entry past it, more than 32 tiles (a look-back window) and the
    whole k = 20 build's first round size; sa, rank, the count on the
    device and the compacted entries. One launch a call."""
    from asgart_tpu_torch.kernels import launch_counts, tie_refine
    from asgart_tpu_torch.kernels.ties import tie_refine_plain

    rng = np.random.default_rng(n)
    arrays = _tie_round(rng, n, ties)
    g = [torch.from_numpy(a).to(gpu) for a in arrays]
    p = [t.clone() for t in g]
    cnt = [torch.full((2,), -1, dtype=torch.int32, device=gpu)
           for _ in "kp"]
    before = launch_counts()["tie_refine"]
    got = tie_refine(*g, cnt[0])
    assert launch_counts()["tie_refine"] == before + 1
    want = tie_refine_plain(*p, cnt[1])
    m = int(cnt[1][0])
    assert m == {"none": 0, "all": n if n > 1 else 0}.get(ties, m)
    _equal((cnt[0], g[4], g[5], *(t[:m] for t in got)),
           (cnt[1], p[4], p[5], *(t[:m] for t in want)))


@pytest.mark.parametrize("step", [1, 10, 12, 15])
@pytest.mark.parametrize("M", [1, 8191, 8192, 8193, (1 << 21) + 5])
def test_invert_tables_decimated_on_gpu(gpu, M, step):
    """KJ writing pos_lo and pos_hi decimated by ``step`` (residue by
    residue from each tile; the last tile zeroes the slots past M) against
    its plain version on a random permutation, at and off the tile width
    (2^13) and the bucket width (2^21); rank in position order."""
    from asgart_tpu_torch.kernels import invert_tables
    from asgart_tpu_torch.kernels.tables import invert_tables_plain

    rng = np.random.default_rng(M + step)
    sa = torch.from_numpy(rng.permutation(M).astype(np.int32)).to(gpu)
    lo = rng.integers(-(1 << 31), 1 << 31, M, dtype=np.int64)
    hi = rng.integers(0, 1 << 31, M, dtype=np.int64)
    lo, hi = (torch.from_numpy(a.astype(np.int32)).to(gpu) for a in (lo, hi))
    got = invert_tables(sa, lo, hi, step)
    assert got[0].numel() == step * -(-M // step) and got[2].numel() == M
    _equal(got, invert_tables_plain(sa, lo, hi, step))


def _km_case(rng, n, k, n_chunks):
    """Decimated planes of an n-position text (pos_lo's sign bit set on a
    tenth of the positions) and chunk specs of a direct-only run (x0 =
    chunk start + step): empty chunks, one-lane chunks, chunks whose lanes
    pass their lane bound, and chunks whose probes pass n."""
    from asgart_tpu_torch.kernels.tables import decimated_size

    step = k // 2
    C, size = decimated_size(n, step)
    lo = rng.integers(0, 1 << 30, size)
    hi = lo + rng.integers(0, 1000, size)
    lo = np.where(rng.random(size) < 0.1, lo | (1 << 31), lo)
    specs = []
    for c in range(n_chunks):
        cs = int(rng.integers(0, n))
        cl = int(rng.integers(1, 3000))
        kind = (c + 2) % 5
        nc = (0 if kind == 0 else 1 if kind == 1 else
              max(0, (cl - k - step) // step) + int(rng.integers(0, 40)))
        specs.append((cs, cl, nc))
    planes = [torch.from_numpy(a.astype(np.uint32).view(np.int32))
              for a in (lo, hi)]
    return planes, specs


@pytest.mark.parametrize("k", [4, 20, 25, 30])
@pytest.mark.parametrize("n_chunks", [1, 5, 256, 257, 700])
def test_table_ranges_edges_on_gpu(gpu, n_chunks, k):
    """KM over decimated planes against its plain version: its chunk table
    by value (up to 256 chunks) and on the card past it; empty and
    one-lane chunks, lanes past the lane bound and past n, N-flagged
    lanes, n % step from 0 to step - 1. One launch a call, none without a
    lane; the call does not wait for the card."""
    from asgart_tpu_torch.kernels import launch_counts, table_ranges
    from asgart_tpu_torch.kernels.tables import (table_ranges_plain,
                                                 table_x0s)

    step = k // 2
    live = False
    for r in range(step):
        n = 50_000 + r
        rng = np.random.default_rng(n * n_chunks + k)
        planes, specs = _km_case(rng, n, k, n_chunks)
        lo, hi = (t.to(gpu) for t in planes)
        before = launch_counts()["table_ranges"]
        got = table_ranges(lo, hi, specs, n, k, False, False)
        total = got[4][-1]
        assert launch_counts()["table_ranges"] == before + (total > 0)
        want = table_ranges_plain(lo.cpu(), hi.cpu(), *table_x0s(
            specs, n, k, False, False), k, n)
        _equal(got[:4], want)
        live |= bool(got[2].any())
    assert live
    # queued behind a busy-wait, the call returns before the card reaches it
    start = torch.cuda.Event()
    torch.cuda._sleep(50_000_000)
    start.record()
    table_ranges(lo, hi, specs, n, k, False, False)
    assert not start.query()
    torch.cuda.synchronize()


@pytest.mark.parametrize("sized", [False, True])
def test_resolve_ties_reads_once_a_round_on_gpu(tmp_path, gpu, monkeypatch,
                                                sized):
    """On the GPU a tie round of the table build launches KE (with its
    sort) and KF, makes one host read (``tolist`` of KE's flag, KF's count
    and its longest still-tied sub-run), and runs no cumsum, scatter_,
    where or stack; before the loop, KE's sizing pass and one read only
    where the tied set reaches ``ties.SIZING_MIN`` (``sized``: set to 0
    here); the resolved order is the one the same rounds give on the
    CPU."""
    from asgart_tpu_torch import ties as ties_mod
    from asgart_tpu_torch.fused_index import sort_keys
    from asgart_tpu_torch.kernels import (group_bounds, invert_tables,
                                          launch_counts, pack_keys)

    _, _, strand = prepared(tmp_path, [("chr1", vocab_genome())])
    k, n1 = 20, len(strand.data)
    n = 2 * n1 - 1
    codes = torch.from_numpy(CODE[strand.data]).to(gpu)
    keys, _ = pack_keys(codes, (), k, True, True, n, 0, doubled=True)
    skeys, sa = sort_keys(keys)
    run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                        run_end=False)
    _, _, rank = invert_tables(sa, run_lo, run_hi, k // 2)
    cpu = [t.cpu() for t in (sa, rank, tied)]
    reads = []
    real = torch.Tensor.tolist

    def tolist(t):
        reads.append(t.numel())
        return real(t)

    def refused(*a, **kw):
        raise AssertionError("a tie round ran a compaction op")

    if sized:
        monkeypatch.setattr(ties_mod, "SIZING_MIN", 0)
    else:
        assert int(tied.sum()) < ties_mod.SIZING_MIN
    before = launch_counts()
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist", tolist)
        for name in ("cumsum", "where", "stack"):
            mp.setattr(torch, name, refused)
        mp.setattr(torch.Tensor, "scatter_", refused)
        got = ties_mod.resolve_ties(sa, rank, tied, n, k, tied_cap=n,
                                    direct_bound=n1)
    after = launch_counts()
    rounds = after["tie_refine"] - before["tie_refine"]
    assert rounds > 1 and after["tie_keys"] - before["tie_keys"] == rounds
    assert after["tie_groups"] - before["tie_groups"] == int(sized)
    assert reads == [1] * sized + [3] * rounds
    want = ties_mod.resolve_ties(*cpu[:2], cpu[2], n, k, tied_cap=n,
                                 direct_bound=n1)
    _equal((got,), (want,))
