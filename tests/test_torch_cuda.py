"""The CUDA kernels against their plain PyTorch versions on the GPU, for
every transform and k in {8, 20} (one-word keys) and {25, 30} (two-word
keys), KA's window mode and KG on trim windows, the merge-join window
engine's kernels (KA's probe-only mode and window keys, KC with no lanes,
KH), and the port's JSON on the GPU against the host engine (whole
genome, trim windows and ``shards``, on the fused build and on the
merge-join engine, with its route chosen by free memory alone). The
kernels have no CPU mode, so without a CUDA GPU these tests skip. On a
machine with a GPU (and without jax, which tests/conftest.py imports),
run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Exact comparisons (integers; tolerance 0). No jax is imported here.
"""

import pytest
import torch

from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.structs import RunSettings

from torch_jax_ref import (TRANSFORMS, chunked_genome, json_text, prepared,
                           vocab_genome)

pytestmark = pytest.mark.cuda


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
                                          scan_core, tie_keys, tie_refine)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain
    from asgart_tpu_torch.kernels.ties import (tie_keys_plain,
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
    key = tie_keys(ps, prims, rank, k, bad[0])
    _equal((key, bad[0]), (tie_keys_plain(ps, prims, rank, k, bad[1]),
                           bad[1]))
    assert int(bad[0]) == 0
    skey, order = torch.sort(key, stable=True)
    sa_k, rank_k, sa_p, rank_p = sa.clone(), rank.clone(), sa.clone(), \
        rank.clone()
    got = tie_refine(skey, order, slots, ps, sa_k, rank_k)
    want = tie_refine_plain(skey, order, slots, ps, sa_p, rank_p)
    _equal((*got, sa_k, rank_k), (*want, sa_p, rank_p))
    sa = resolve_ties(sa, rank, tied, W + total, k)
    n_events = 0
    for c, (cs, cl, nc) in enumerate(specs):
        lanes = slice(lane_off[c], lane_off[c] + nc)
        for max_card in (500, 1):
            args = (lane_lo[lanes], lane_hi[lanes], mask[lanes], sa, cs, cl,
                    max_card, 0, k, reverse)
            got, want = scan_core(*args), scan_core_plain(*args)
            assert (got.n_events, got.total_kept) == \
                (want.n_events, want.total_kept)
            _equal((got.flat,), (want.flat,))
            n_events += got.n_events
    torch.cuda.synchronize()
    after = launch_counts()
    # KG runs on trim windows only (test_window_kernels_equal_plain_on_gpu),
    # KH on the merge-join engine (test_mj_kernels_equal_plain_on_gpu)
    assert all(after[name] > before[name] for name in after
               if name not in ("offset_slots", "mj_ranges"))
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
    """KA in window mode and KG on a window with ws > 0, each against its
    plain version; the window build on the GPU equals the CPU build."""
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fused_index import FusedIndex, fused_layout
    from asgart_tpu_torch.kernels import launch_counts, offset_slots, pack_keys
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.window import offset_slots_plain

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
    for n in (W + total, 4097, 3, 0):  # vector body, ragged tail, empty
        sa = torch.randint(0, 2**30, (n,), dtype=torch.int32, device=gpu)
        want = offset_slots_plain(sa.clone(), ws)
        _equal((offset_slots(sa, ws),), (want,))
    sa = torch.arange(9, dtype=torch.int32, device=gpu)[1:]  # unaligned
    _equal((offset_slots(sa, ws),),
           (torch.arange(1, 9, dtype=torch.int32, device=gpu) + ws,))
    got = FusedIndex.build(strand.data, k, specs, reverse, complement, gpu,
                           trim=(ws, we))
    ref = FusedIndex.build(strand.data, k, specs, reverse, complement,
                           torch.device("cpu"), trim=(ws, we))
    _equal((got.sa, got.lane_lo, got.lane_hi, got.lane_mask),
           (ref.sa, ref.lane_lo, ref.lane_hi, ref.lane_mask))
    assert got.offs == ref.offs
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[name] > before[name] for name in after
               if name not in ("scan_core", "mj_ranges"))


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
               if name != "scan_core")


@pytest.mark.parametrize("k", [20, 8])
def test_gpu_mj_trim_and_shards_json_equal_host(tmp_path, gpu, monkeypatch,
                                                k):
    """With no fused build fitting, trim windows, shards and the whole
    genome (one window) run on the merge-join engine and write the host
    engine's bytes."""
    from asgart_tpu_torch import pipeline
    from asgart_tpu_torch.fused_index import INDEX_CACHE
    from asgart_tpu_torch.pipeline import search_duplications
    from asgart_tpu_torch.window_index import DeviceWindowIndex

    g = bytearray(chunked_genome())
    g[500:3560] = g[20500:23560]  # a direct duplication
    fa, _, _ = prepared(tmp_path, [("chr1", bytes(g))])
    monkeypatch.setattr(pipeline, "fits", lambda *a, **kw: False)
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
    genome as one window, and every window of a sharded run (its held
    probe keys charged) to the merge-join engine; the JSON is the host
    engine's."""
    from asgart_tpu_torch import fused_index
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
                got = json_text(search_duplications(
                    [fa], s, engine="cuda", device=gpu, shards=shards))
        finally:
            del ballast
            INDEX_CACHE.clear()
            torch.cuda.empty_cache()
        assert len(built) == shards
        assert got == host
