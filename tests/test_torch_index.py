"""The port's fused index build against the JAX one, stage by stage:
the stable sort vs ``_flagged_sort``, KB vs ``_group_bounds_impl``
(flagged), KC vs ``_invert_fused`` (rank through ``rank_from_decimated``),
and the whole build, tie resolution included, vs ``FusedIndex.build``.
Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.convert import rank_from_decimated
from asgart_tpu_torch.fused_index import FusedIndex
from asgart_tpu_torch.kernels import group_bounds, invert_fused

from torch_jax_ref import (TRANSFORMS, chunked_genome, fused_key,
                           jax_fused_stages, prepared, specs_for,
                           vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

CPU = torch.device("cpu")


def _lane_off(specs):
    off = [0]
    for (_, _, nc) in specs:
        off.append(off[-1] + nc)
    return off


@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_sort_bounds_invert_equal_jax(tmp_path, reverse, complement):
    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    k = 20
    s = RunSettings(reverse=reverse, complement=complement)
    specs = specs_for(chunks, s)
    ref = jax_fused_stages(strand.data, k, specs, reverse, complement)
    W = ref["W"]

    # the flagged sort: torch's stable sort of the int64 key gives the
    # JAX sort's row order (its iota payload)
    key = torch.from_numpy(fused_key(ref["ckhi"], ref["cklo"], W))
    skey, order = torch.sort(key, stable=True)
    sa = order.to(torch.int32)
    assert np.array_equal(sa.numpy(), ref["sa"])
    assert np.array_equal(skey.numpy(),
                          (ref["skhi"].astype(np.int64) << 31)
                          | ref["sklo"].astype(np.int64))

    # KB
    run_lo, run_hi, tied = group_bounds([skey], sa, W)
    assert np.array_equal(run_lo.numpy(), ref["run_lo"])
    assert np.array_equal(run_hi.numpy(), ref["run_hi"])
    assert np.array_equal(tied.numpy(), ref["tied"])
    assert tied.any()

    # KC
    lane_mask = torch.from_numpy(ref["lane_mask"].copy())
    rank, lane_lo, lane_hi, totals = invert_fused(
        sa, run_lo, run_hi, lane_mask, W, _lane_off(specs))
    assert np.array_equal(lane_lo.numpy(), ref["lane_lo"])
    assert np.array_equal(lane_hi.numpy(), ref["lane_hi"])
    assert np.array_equal(totals.numpy(), ref["totals"].astype(np.int64))
    if reverse == complement:  # direct self hits / the planted -RC copy
        assert totals.sum() > 0
    assert np.array_equal(rank.numpy(),
                          rank_from_decimated(ref["rank_dec"], k // 2, W))


@pytest.mark.parametrize("genome,k,reverse,complement", [
    ("chunked", 20, True, True),
    ("chunked", 20, False, False),
    ("chunked", 8, True, False),
    ("vocab", 20, True, True),
    ("chunked", 21, True, True),
    ("chunked", 25, False, False),
    ("chunked", 30, True, False),
    ("vocab", 21, False, True),
    ("vocab", 25, True, True),
    ("vocab", 30, False, False),
])
def test_whole_build_equals_jax(tmp_path, genome, k, reverse, complement):
    """The final suffix order and lane windows, after tie resolution; the
    vocabulary genome ties most of its positions. k = 21..30 sorts two
    key words (the JAX 3-plane build)."""
    from asgart_tpu.device_index import FusedIndex as JaxFusedIndex

    g = chunked_genome() if genome == "chunked" else vocab_genome()
    _, chunks, strand = prepared(tmp_path, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = specs_for(chunks, s)
    ref = JaxFusedIndex.build(strand.data, k, specs=specs, reverse=reverse,
                              complement=complement)
    got = FusedIndex.build(strand.data, k, specs, reverse, complement, CPU)
    assert np.array_equal(got.sa.numpy(), np.asarray(ref.sa))
    assert np.array_equal(got.lane_lo.numpy(), np.asarray(ref.lane_lo))
    assert np.array_equal(got.lane_hi.numpy(), np.asarray(ref.lane_hi))
    assert np.array_equal(got.lane_mask.numpy(), np.asarray(ref.lane_mask))
    assert got.offs == {c: (o, int(t)) for c, (o, t) in ref.offs.items()}
