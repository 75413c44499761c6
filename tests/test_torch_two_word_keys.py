"""The two-word fused key of k = 21..30 against the JAX 3-plane build: KA
``pack_keys`` (plain version) vs ``_pack_planes3_all`` +
``_pack_batch_probe_keys3`` + ``_fused_cat_planes3`` and the
``_flagged_sort3`` flag, decoded back into planes; the two-pass stable
sort (``fused_index.sort_keys``) vs ``_flagged_sort3``'s row order; KB
``group_bounds`` (plain version) vs ``_group_bounds_impl(sktop=...,
flagged=True)``. Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.fused_index import sort_keys
from asgart_tpu_torch.kernels import group_bounds, pack_keys
from asgart_tpu_torch.kernels.pack_keys import PAD_KEY2, key_words

from torch_jax_ref import (TRANSFORMS, chunked_genome, jax_fused_stages,
                           key_planes, prepared, specs_for, vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)


def _stages(tmp_path, genome, k, reverse, complement):
    g = chunked_genome() if genome == "chunked" else vocab_genome()
    _, chunks, strand = prepared(tmp_path, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = specs_for(chunks, s)
    ref = jax_fused_stages(strand.data, k, specs, reverse, complement)
    codes = torch.from_numpy(CODE[strand.data])
    keys, lane_mask = pack_keys(codes, specs, k, reverse, complement,
                                ref["W"], ref["total"])
    return specs, ref, keys, lane_mask


@pytest.mark.parametrize("k", [21, 25, 30])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_pack_keys_two_words_equal_jax(tmp_path, reverse, complement, k):
    """All four transforms over the chunked genome with N runs (a chunk
    split, in-chunk N probes masked out)."""
    specs, ref, keys, lane_mask = _stages(tmp_path, "chunked", k, reverse,
                                          complement)
    assert key_words(k) == 2 and len(keys) == 2
    assert keys[0].dtype == torch.int64 and keys[1].dtype == torch.int32
    W = ref["W"]
    (top, hi, lo), flag = key_planes(keys)
    assert np.array_equal(top, ref["cktop"])
    assert np.array_equal(hi, ref["ckhi"])
    assert np.array_equal(lo, ref["cklo"])
    assert np.array_equal(flag, np.arange(len(flag)) >= W)
    assert np.array_equal(lane_mask.numpy(), ref["lane_mask"])
    # the N probes really are masked, and the pad rows carry the sentinel
    n_live = sum(nc for (_, _, nc) in specs)
    assert not lane_mask[:n_live].all() and lane_mask[:n_live].any()
    assert (keys[0][W + n_live:] == PAD_KEY2[0]).all()
    assert (keys[1][W + n_live:] == PAD_KEY2[1]).all()


@pytest.mark.parametrize("genome,k,reverse,complement", [
    ("chunked", 21, True, True),
    ("chunked", 30, False, False),
    ("vocab", 25, True, True),
    ("vocab", 25, False, True),
])
def test_sort_bounds_two_words_equal_jax(tmp_path, genome, k, reverse,
                                         complement):
    """The LSD sort gives `_flagged_sort3`'s rows and sorted planes (its
    ties in row order), and KB its run bounds and tied set; the
    vocabulary genome ties most rows."""
    _, ref, keys, _ = _stages(tmp_path, genome, k, reverse, complement)
    W = ref["W"]
    skeys, sa = sort_keys(keys)
    assert keys == []  # consumed
    assert np.array_equal(sa.numpy(), ref["sa"])
    (top, hi, lo), flag = key_planes(skeys)
    assert np.array_equal(top, ref["sktop"])
    assert np.array_equal(hi, ref["skhi"])
    assert np.array_equal((lo << 1) | flag, ref["sklo"])
    run_lo, run_hi, tied = group_bounds(skeys, sa, W)
    assert np.array_equal(run_lo.numpy(), ref["run_lo"])
    assert np.array_equal(run_hi.numpy(), ref["run_hi"])
    assert np.array_equal(tied.numpy(), ref["tied"])
    assert tied.any()
