"""KA ``pack_keys`` (asgart_tpu_torch/kernels/pack_keys.py) against the JAX
key planes it replaces: ``_pack_planes_all`` + ``_pack_batch_probe_keys`` +
``_fused_cat_planes`` + the ``_flagged_sort`` flag, as one int64 key, and
the probe lane mask. Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

from asgart_tpu_torch.index import CODE
from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.kernels import pack_keys
from asgart_tpu_torch.kernels.pack_keys import PAD_KEY

from torch_jax_ref import (TRANSFORMS, chunked_genome, fused_key,
                           jax_fused_stages, prepared, specs_for)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)


@pytest.mark.parametrize("k", [20, 8])
@pytest.mark.parametrize("reverse,complement", TRANSFORMS)
def test_pack_keys_equals_jax(tmp_path, reverse, complement, k):
    """All four transforms over a chunked genome with N runs (a chunk
    split, in-chunk N probes masked out), k = 20 and k = 8."""
    _, chunks, strand = prepared(tmp_path, [("chr1", chunked_genome())])
    s = RunSettings(reverse=reverse, complement=complement, probe_size=k)
    specs = specs_for(chunks, s)
    assert len(specs) == 2
    ref = jax_fused_stages(strand.data, k, specs, reverse, complement)
    codes = torch.from_numpy(CODE[strand.data])
    (key,), lane_mask = pack_keys(codes, specs, k, reverse, complement,
                                  ref["W"], ref["total"])
    want = fused_key(ref["ckhi"], ref["cklo"], ref["W"])
    assert np.array_equal(key.numpy(), want)
    assert np.array_equal(lane_mask.numpy(), ref["lane_mask"])
    # the N probes really are masked, and the pad rows carry the sentinel
    n_live = sum(nc for (_, _, nc) in specs)
    assert not lane_mask[:n_live].all() and lane_mask[:n_live].any()
    assert (key[ref["W"] + n_live:] == PAD_KEY).all()
