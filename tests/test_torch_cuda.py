"""The CUDA kernels against their plain PyTorch versions on the GPU, for
every transform and k in {8, 20}, and the port's JSON on the GPU against
the host engine. The kernels have no CPU mode, so without a CUDA GPU these
tests skip. On a machine with a GPU (and without jax, which
tests/conftest.py imports), run them with::

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


@pytest.mark.parametrize("k", [20, 8])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_kernels_equal_plain_on_gpu(tmp_path, gpu, reverse, complement, k):
    from asgart_tpu_torch.device_engine import chunk_specs
    from asgart_tpu_torch.fused_index import fused_layout
    from asgart_tpu_torch.kernels import (group_bounds, invert_fused,
                                          launch_counts, pack_keys,
                                          scan_core)
    from asgart_tpu_torch.kernels.group_bounds import group_bounds_plain
    from asgart_tpu_torch.kernels.invert import invert_fused_plain
    from asgart_tpu_torch.kernels.pack_keys import (chunk_tables,
                                                    pack_keys_plain)
    from asgart_tpu_torch.kernels.scan_core import scan_core_plain
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
    key, mask = pack_keys(codes, specs, k, reverse, complement, W, total)
    _equal((key, mask), pack_keys_plain(
        codes, *chunk_tables(specs, n1, k, reverse, complement), k,
        reverse, complement, W, total))
    skey, order = torch.sort(key, stable=True)
    sa = order.to(torch.int32)
    bounds = group_bounds(skey, sa, W)
    _equal(bounds, group_bounds_plain(skey, sa, W))
    run_lo, run_hi, tied = bounds
    inv = invert_fused(sa, run_lo, run_hi, mask, W, lane_off)
    _equal(inv, invert_fused_plain(sa, run_lo, run_hi, mask, W, lane_off))
    rank, lane_lo, lane_hi, _ = inv
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
