"""The CUDA kernels against their plain PyTorch versions on the GPU, for
every transform and k in {8, 20} (one-word keys) and {25, 30} (two-word
keys), and the port's JSON on the GPU against the host engine. The
kernels have no CPU mode, so without a CUDA GPU these tests skip. On a
machine with a GPU (and without jax, which tests/conftest.py imports),
run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Exact comparisons (integers; tolerance 0). No jax is imported here.
"""

import pytest
import torch

from asgart_tpu.index import CODE
from asgart_tpu.structs import RunSettings

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
    assert all(after[name] > before[name] for name in after)
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
