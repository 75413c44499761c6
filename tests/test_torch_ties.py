"""Tie resolution: KE ``tie_keys`` and KF ``tie_refine`` (plain versions)
against the JAX subset doubling they replace — one round against
``_extract_tied`` + ``_slot_payload`` + ``_doubling_rounds(rounds=1)``,
and ``ties.resolve_ties`` against ``_resolve_ties`` — on the tied
vocabulary genome (most rows tied) at k = 8, 20 and 25; and the bound
check that must raise. Exact (integers; tolerance 0)."""

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.convert import rank_from_decimated
from asgart_tpu_torch.kernels import tie_keys, tie_refine
from asgart_tpu_torch.ties import resolve_ties

from torch_jax_ref import (jax_fused_stages, prepared, specs_for,
                           vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

I32 = torch.int32


def _tied_stages(tmp_path, k):
    _, chunks, strand = prepared(tmp_path, [("chr1", vocab_genome())])
    s = RunSettings(reverse=True, complement=True, probe_size=k)
    ref = jax_fused_stages(strand.data, k, specs_for(chunks, s), True, True)
    assert ref["tied"].sum() > 1000
    return ref, ref["W"], ref["W"] + ref["total"], k // 2


def _port_arrays(ref, step, W):
    sa = torch.from_numpy(ref["sa"].copy())
    rank = torch.from_numpy(rank_from_decimated(ref["rank_dec"], step, W)
                            .astype(np.int32))
    return sa, rank, torch.from_numpy(ref["tied"].copy())


@pytest.mark.parametrize("k", [8, 20, 25])
def test_one_round_equals_jax(tmp_path, k):
    from asgart_tpu import device_index as di

    ref, W, M, step = _tied_stages(tmp_path, k)
    n_tied = int(ref["tied"].sum())
    cap = max(1024, di._bucket_pow2(n_tied))
    jsa, jrank = jnp.asarray(ref["sa"]), jnp.asarray(ref["rank_dec"])
    slots, n = di._extract_tied(jnp.asarray(ref["tied"]), cap)
    ps, prims = di._slot_payload(jsa, jrank, slots, n, dec_step=step)
    jsa, jrank, jslots, jps, jprims, jn = di._doubling_rounds(
        jsa, jrank, slots, ps, prims, n, jnp.int32(min(k, M)), 1,
        dec_step=step)
    jn = int(jn)

    sa, rank, tied = _port_arrays(ref, step, W)
    slots = torch.nonzero(tied).flatten()
    ps = sa[slots]
    prims = rank[ps.long()]
    slots = slots.to(I32)
    bad = torch.zeros(1, dtype=I32)
    key = tie_keys(ps, prims, rank, min(k, M), bad)
    skey, order = torch.sort(key, stable=True)
    p_sorted, rs, still = tie_refine(skey, order, slots, ps, sa, rank)
    assert int(bad) == 0
    # ranks agree everywhere; the still-tied slots and their group ranks
    # agree; the resolved slots hold the same positions (order inside a
    # still-tied sub-run is free: the JAX round sorts it by position)
    assert np.array_equal(rank.numpy(), rank_from_decimated(
        np.asarray(jrank), step, W))
    assert int(still.sum()) == jn > 0
    assert np.array_equal(slots[still].numpy(), np.asarray(jslots)[:jn])
    assert np.array_equal(rs[still].numpy(), np.asarray(jprims)[:jn])
    assert np.array_equal(np.sort(p_sorted[still].numpy()),
                          np.sort(np.asarray(jps)[:jn]))
    done = slots[~still].long().numpy()
    assert len(done) > 0
    assert np.array_equal(sa.numpy()[done], np.asarray(jsa)[done])


@pytest.mark.parametrize("k", [8, 20, 25])
def test_resolve_ties_equals_jax(tmp_path, k):
    from asgart_tpu import device_index as di

    ref, W, M, step = _tied_stages(tmp_path, k)
    n_tied = int(ref["tied"].sum())
    want = di._resolve_ties(
        jnp.asarray(ref["sa"]), jnp.asarray(ref["rank_dec"]),
        jnp.asarray(ref["tied"]), M, k, 2, max(1024, n_tied),
        direct_bound=W, dec_step=step, n_tied_host=n_tied)
    sa, rank, tied = _port_arrays(ref, step, W)
    got = resolve_ties(sa, rank, tied, M, k)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_bound_check_raises():
    """Tied suffixes that run off the direct text (a strand without a
    unique '$'): KE flags the read and the round raises."""
    W, M, k = 8, 12, 4
    sa = torch.arange(M, dtype=I32)
    rank = torch.zeros(W, dtype=I32)
    tied = torch.zeros(M, dtype=torch.bool)
    tied[6:8] = True  # positions 6 and 7: 6 + 4 >= W
    bad = torch.zeros(1, dtype=I32)
    tie_keys(sa[6:8].clone(), rank[6:8].clone(), rank, k, bad)
    assert int(bad) == 1
    with pytest.raises(RuntimeError, match="read past the direct text"):
        resolve_ties(sa, rank, tied, M, k)
