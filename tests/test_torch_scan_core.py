"""KD ``scan_core`` (asgart_tpu_torch/kernels/scan_core.py) with the fused
and merge-join engines' filter constants (``fused_bases``) against the live
prefixes of the JAX ``_scan_core`` outputs (asgart_tpu/device_engine.py:352)
on lanes of a JAX-built fused index: ev_pack[:, :n_events],
m_flat[:total_kept] and z_trail. Exact (integers; tolerance 0). The
big-window engine's rebased constants: tests/test_torch_big_window.py."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.kernels import scan_core
from asgart_tpu_torch.kernels.scan_core import fused_bases

from torch_jax_ref import chunked_genome, prepared, specs_for
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)


def _jax_index(tmp_path, reverse, complement, g):
    from asgart_tpu.device_index import FusedIndex as JaxFusedIndex

    _, chunks, strand = prepared(tmp_path, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement)
    specs = specs_for(chunks, s)
    return JaxFusedIndex.build(strand.data, s.probe_size, specs=specs,
                               reverse=reverse, complement=complement)


def _jax_scan(idx, off, nc, cs, cl, max_card, j0, k, reverse):
    from asgart_tpu.device_engine import _bucket, _scan_core

    b_pad = _bucket(nc)
    lanes = slice(off + j0, off + j0 + b_pad)
    cap = 1 << 20
    ev, m, sc = _scan_core(
        idx.lane_lo[lanes], idx.lane_hi[lanes], idx.lane_mask[lanes],
        idx.sa, jnp.int32(cs), jnp.int32(cl), jnp.int32((1 << 31) - 1),
        jnp.int32(max_card), jnp.int32(j0), k=k, reverse=reverse,
        b_pad=b_pad, cap=cap, ev_cap=b_pad)
    n_events, total_kept, z_trail, overflow = (int(v) for v in
                                               np.asarray(sc))
    assert not overflow
    return (np.asarray(ev)[:, :n_events], np.asarray(m)[:total_kept],
            z_trail)


def _port_scan(idx, off, nc, cs, cl, max_card, j0, k, reverse):
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype)

    lanes = slice(off + j0, off + nc)
    res = scan_core(t(idx.lane_lo[lanes], torch.int32),
                    t(idx.lane_hi[lanes], torch.int32),
                    t(idx.lane_mask[lanes], torch.bool),
                    t(idx.sa, torch.int32), *fused_bases(cs, cl), max_card,
                    j0, k, reverse)
    return res.to_host()


@pytest.mark.parametrize("reverse,complement,max_card,j0", [
    (False, False, 500, 0),   # direct: the repeated unit's copies
    (True, True, 500, 0),     # reversed: the planted -RC copy
    (True, True, 500, 7),     # a lane slice starting past lane 0
    (False, False, 2, 0),     # windows above max_cardinality
])
def test_scan_core_equals_jax(tmp_path, reverse, complement, max_card, j0):
    g = chunked_genome()
    if not reverse:
        # a 60 bp unit copied 4 more times inside the first chunk: lanes
        # in its first copy keep 4 later matches, above max_card = 2
        b = bytearray(g)
        unit = b[500:560]
        for p in (2000, 4000, 6000, 8000):
            b[p:p + 60] = unit
        g = bytes(b)
    idx = _jax_index(tmp_path, reverse, complement, g)
    k = idx.k
    n_events_seen = 0
    for (cs, cl, nc) in idx.specs:
        off = idx.offs[(cs, cl)][0]
        want = _jax_scan(idx, off, nc, cs, cl, max_card, j0, k, reverse)
        got = _port_scan(idx, off, nc, cs, cl, max_card, j0, k, reverse)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
        n_events_seen += got[0].shape[1]
    if reverse == complement and j0 == 0:
        assert n_events_seen > 0
