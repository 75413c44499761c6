"""Tie resolution: KE ``tie_keys`` and KF ``tie_refine`` (plain versions)
against the JAX subset doubling they replace — one round, KF's compacted
still-tied entries and their count included, against
``_extract_tied`` + ``_slot_payload`` + ``_doubling_rounds(rounds=1)``,
and ``ties.resolve_ties`` against ``_resolve_ties`` — on the tied
vocabulary genome (most rows tied) at k = 8, 20 and 25, with the plain
versions and with both of KE's routes in one resolution (the library made
a model of the kernels: KE's sort by tests/ke_ko_model.py, past a small
capacity set by the test the key pass and the library's sort); and the
bound check that must raise. Exact (integers; tolerance 0)."""

import ctypes
import importlib

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asgart_tpu_torch.structs import RunSettings
from asgart_tpu_torch.convert import rank_from_decimated
from asgart_tpu_torch.kernels import _build, tie_keys, tie_refine
from asgart_tpu_torch.kernels.ties import tie_refine_plain
from asgart_tpu_torch.ties import resolve_ties

from ke_ko_model import model_tie_sort

from torch_jax_ref import (jax_fused_stages, prepared, specs_for,
                           vocab_genome)
from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

I32 = torch.int32
ties_k = importlib.import_module("asgart_tpu_torch.kernels.ties")


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
    flags = torch.zeros(3, dtype=I32)
    skey, order = tie_keys(ps, prims, rank, min(k, M), flags[:1])
    done = slots.long().numpy()
    nxt = tie_refine(skey, order, slots, ps, sa, rank, flags[1:])
    bad, m, _ = flags.tolist()
    assert bad == 0
    # ranks agree everywhere; KF's compacted still-tied entries agree with
    # the JAX stable partition: the count, the slots in order, their group
    # ranks, and the positions of each still-tied group (order inside a
    # still-tied sub-run is free: the JAX round sorts it by position)
    assert np.array_equal(rank.numpy(), rank_from_decimated(
        np.asarray(jrank), step, W))
    assert m == jn > 0
    n_slots, n_ps, n_prims = (t[:m].numpy() for t in nxt)
    assert np.array_equal(n_slots, np.asarray(jslots)[:jn])
    assert (np.diff(n_slots) > 0).all()
    assert np.array_equal(n_prims, np.asarray(jprims)[:jn])
    got = np.lexsort((n_ps, n_prims))
    want = np.lexsort((np.asarray(jps)[:jn], np.asarray(jprims)[:jn]))
    assert np.array_equal(n_ps[got], np.asarray(jps)[:jn][want])
    # the resolved slots hold the same positions
    done = np.setdiff1d(done, n_slots)
    assert len(done) > 0
    assert np.array_equal(sa.numpy()[done], np.asarray(jsa)[done])


class _ModelLib:
    """KE's entry points over CPU memory (its sort through the model of
    the kernel, its key pass and sizing pass as the plain versions), KF as
    its plain version; the routes KE took, in order."""

    def __init__(self, sa_n, rank_n):
        self.sa_n, self.rank_n, self.routes = sa_n, rank_n, []

    @staticmethod
    def _ints(ptr, n, ctype=ctypes.c_int32):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def asgart_tie_groups(self, prims, n, largest, stream):
        out = torch.zeros(1, dtype=I32)
        ties_k.tie_groups_plain(torch.from_numpy(self._ints(prims, n)), out)
        self._ints(largest, 1)[0] = int(out)
        return 0

    def asgart_tie_keys(self, ps, prims, rank, n, W, h, key, bad, stream):
        ph = self._ints(ps, n).astype(np.int64) + h
        if (ph >= W).any():
            self._ints(bad, 1)[0] = 1
        sec = self._ints(rank, W)[np.minimum(ph, W - 1)].astype(np.int64)
        self._ints(key, n, ctypes.c_int64)[:] = \
            (self._ints(prims, n).astype(np.int64) << 32) | (sec + 1)
        self.routes.append("library")
        return 0

    def asgart_tie_sort(self, ps, prims, rank, n, W, h, skey, order, bad,
                        stream):
        s, o, b = model_tie_sort(self._ints(ps, n).copy(),
                                 self._ints(prims, n).copy(),
                                 self._ints(rank, W).copy(), h)
        self._ints(skey, n, ctypes.c_int64)[:] = s
        self._ints(order, n, ctypes.c_int64)[:] = o
        self._ints(bad, 1)[0] |= b[0]
        self.routes.append("kernel")
        return 0

    def asgart_tie_refine(self, skey, order, slots, ps, n, sa, rank,
                          o_slots, o_ps, o_prims, count, largest, scratch,
                          n_tiles, stream):
        i64 = ctypes.c_int64
        t = [torch.from_numpy(a) for a in (
            self._ints(skey, n, i64), self._ints(order, n, i64),
            self._ints(slots, n), self._ints(ps, n),
            self._ints(sa, self.sa_n), self._ints(rank, self.rank_n))]
        cnt = torch.zeros(2, dtype=I32)
        out = tie_refine_plain(*t, cnt)
        for p, row in zip((o_slots, o_ps, o_prims), out):
            self._ints(p, n)[:] = row.numpy()
        self._ints(count, 1)[0] = int(cnt[0])
        self._ints(largest, 1)[0] = int(cnt[1])
        return 0


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("k", [8, 20, 25])
def test_resolve_ties_equals_jax(tmp_path, monkeypatch, k, cap):
    """The plain versions (cap None), and the kernels' routes (cap 4: the
    rounds whose largest group passes 4 entries take the key pass and the
    library's sort, the others KE's sort: both in one resolution)."""
    from asgart_tpu import device_index as di

    ref, W, M, step = _tied_stages(tmp_path, k)
    n_tied = int(ref["tied"].sum())
    want = di._resolve_ties(
        jnp.asarray(ref["sa"]), jnp.asarray(ref["rank_dec"]),
        jnp.asarray(ref["tied"]), M, k, 2, max(1024, n_tied),
        direct_bound=W, dec_step=step, n_tied_host=n_tied)
    sa, rank, tied = _port_arrays(ref, step, W)
    if cap is not None:
        lib = _ModelLib(sa.numel(), rank.numel())
        monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
        monkeypatch.setattr(_build, "lib", lambda: lib)
        monkeypatch.setattr(_build, "stream_of", lambda t: 0)
        monkeypatch.setattr(ties_k, "TIE_SORT_CAP", cap)
    got = resolve_ties(sa, rank, tied, M, k)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if cap is not None:
        assert "kernel" in lib.routes and "library" in lib.routes


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
