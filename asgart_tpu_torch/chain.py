"""The chain on the device: the arm automaton over bursts of events.

Counterpart of ``asgart_tpu/chain_jax.py``. The event stream that KD
``scan_core`` leaves on the card (probe index, quiet probes before, kept
count per event; the kept matches; the quiet probes after the last event)
splits into bursts at every run of ``burst_threshold`` or more quiet
probes, after which every arm is provably dead and its families are out;
so the bursts are independent, and KN ``chain_bursts`` (kernels/chain.py)
runs one per thread block. The bursts are found with torch ops on the card
(a flag, ``torch.nonzero``, ``torch.cumsum``) in CSR form over the flat
events and matches: no padded grid, so nothing is refused for its size.
Families come back in the native order (burst order, then emission order),
equal to ``native.chain_events`` on the same events.

Three things differ from the JAX module, each where it departs from the
native chain (ROADMAP F13): positions are int64 throughout (the JAX grid
is int32 and wraps past 2^31), ``allow`` is computed in float64 (float32
there), and nothing falls back to the host chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import cuda_device
from .kernels.chain import chain_bursts

# bursts whose arms pass the capacity rerun with twice the capacity; the
# device engines start where the repeat-dense genomes' arm sets stay
ENGINE_ARMS = 1024


class ChainConfig(NamedTuple):
    """The automaton's settings and its first capacities (the JAX
    ``ChainConfig``, chain_jax.py:49): ``max_arms`` arms a burst and
    ``out_cap`` output rows, each doubled (rows: resized exactly) on
    overflow; ``max_matches`` bounds a probe's matches in
    :func:`prepare_probe_stream_host`."""

    probe_size: int
    step_size: int
    max_gap_size: int
    min_duplication_length: int
    max_cardinality: int
    max_arms: int = 256
    max_matches: int = 512
    out_cap: int = 4096


def config_for(settings) -> ChainConfig:
    """The device engines' chain settings for a run (``settings``:
    RunSettings), starting at ``ENGINE_ARMS`` arms a burst."""
    k = settings.probe_size
    return ChainConfig(probe_size=k, step_size=k // 2,
                       max_gap_size=settings.max_gap_size,
                       min_duplication_length=settings.min_duplication_length,
                       max_cardinality=settings.max_cardinality,
                       max_arms=ENGINE_ARMS)


def prepare_probe_stream_host(
    sa: np.ndarray, probe_is: np.ndarray, lo: np.ndarray, hi: np.ndarray,
    *, needle_offset: int, needle_len: int, reverse: bool,
    max_cardinality: int, max_matches: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact host preparation of the padded per-probe match stream.

    Returns (probe_is, matches [P, M] int32 padded with -1, valid [P]).
    Probes whose filtered match count exceeds ``max_cardinality`` are
    marked invalid (the automaton skips them entirely — no gap aging).
    """
    P = len(probe_is)
    M = max_matches
    matches = np.full((P, M), -1, dtype=np.int32)
    valid = np.ones(P, dtype=bool)
    for p in range(P):
        i = int(probe_is[p])
        ms = []
        for r in range(int(lo[p]), int(hi[p])):
            m_start = int(sa[r])
            if m_start == i:
                continue
            if not reverse:
                if not (m_start > i + needle_offset):
                    continue
            else:
                if not (m_start >= needle_offset + needle_len - i):
                    continue
            ms.append(m_start)
        if len(ms) > max_cardinality:
            valid[p] = False
            continue
        if len(ms) > M:
            raise ValueError(
                f"probe match count {len(ms)} exceeds max_matches={M}; "
                "ChainConfig.max_matches must be >= max_cardinality")
        matches[p, :len(ms)] = ms
    return probe_is.astype(np.int32), matches, valid


def burst_threshold(cfg: ChainConfig) -> int:
    """Quiet valid probes after which every arm is provably dead: each
    quiet probe ages every arm by ``step_size``, and an arm dies at a gap
    of ``max_gap_size`` (chain_jax.py:331); at least 1, since with
    ``max_gap_size`` <= 0 an extended arm stays alive through its event."""
    return max(1, -(-cfg.max_gap_size // cfg.step_size))


class Events(NamedTuple):
    """An event stream on one device: probe index and quiet probes before
    each event (int32 [E]), CSR offsets of its kept matches (int64 [E +
    1]), the matches (int32 or int64) shifted by ``m_offset`` in int64, and
    the quiet probes after the last event (int32 [1])."""

    ev_i: torch.Tensor
    ev_z: torch.Tensor
    m_off: torch.Tensor
    m: torch.Tensor
    z_trail: torch.Tensor
    m_offset: int = 0


def events_from_flat(flat: torch.Tensor, n_events: int, total_kept: int,
                     m_offset: int = 0) -> Events:
    """The events of KD's ``ScanResult.flat`` = [ev_pack (3 x n) | m_flat |
    z_trail], read in place (views; the offsets by ``torch.cumsum`` of the
    kept counts)."""
    n = n_events
    m_off = torch.zeros(n + 1, dtype=torch.int64, device=flat.device)
    torch.cumsum(flat[2 * n: 3 * n], 0, out=m_off[1:])
    return Events(flat[:n], flat[n: 2 * n], m_off,
                  flat[3 * n: 3 * n + total_kept], flat[-1:], m_offset)


def bursts_from_events(ev: Events, t_split: int) -> tuple:
    """(burst_start int64 [NB + 1], order int32 [NB]): the bursts of
    ``ev``, each starting at the first event or at an event after
    ``t_split`` or more quiet probes, and their indices longest first
    (ties in burst order), with torch ops on the events' device."""
    E = ev.ev_i.numel()
    new = ev.ev_z >= t_split
    new[0] = True
    burst_start = torch.cat([
        torch.nonzero(new).flatten(),
        torch.full((1,), E, dtype=torch.int64, device=new.device)])
    length = burst_start[1:] - burst_start[:-1]
    order = torch.sort(length, descending=True, stable=True).indices
    return burst_start, order.to(torch.int32)


class ChainStats(NamedTuple):
    """What one chain did: events, matches, bursts, the longest burst's
    events, KN passes, the (match, arm) tests of the native walk, the last
    pass's arm capacity and the rows."""

    events: int
    matches: int
    bursts: int
    longest: int
    passes: int
    tests: int
    arms: int
    rows: int


def chain_rows(ev: Events, cfg: ChainConfig, fn=chain_bursts,
               bursts: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, ChainStats]:
    """Every family row of the events ``ev`` (int64 [R, 6], ordered by
    burst, then emission; kernels/chain.py), through ``fn`` (KN, or its
    plain version): the bursts longest first (or only the burst indices
    ``bursts``, int32, in their order); a pass whose rows passed
    ``out_cap`` reruns with room for all of them; bursts whose arms passed
    the capacity rerun alone with twice as many."""
    dev = ev.ev_i.device
    E = ev.ev_i.numel()
    if E == 0:
        return (torch.zeros((0, 6), dtype=torch.int64, device=dev),
                ChainStats(0, 0, 0, 0, 0, 0, 0, 0))
    t_split = burst_threshold(cfg)
    burst_start, todo = bursts_from_events(ev, t_split)
    nb = burst_start.numel() - 1
    if bursts is not None:
        todo = bursts
    longest = int((burst_start[todo.long() + 1]
                   - burst_start[todo.long()]).max())
    todo_n = todo.numel()
    arms, cap = cfg.max_arms, cfg.out_cap
    parts, passes, tests = [], 0, 0
    while True:
        rows, n_rows, status, t = fn(
            ev.ev_i, ev.ev_z, ev.m_off, ev.m, ev.m_offset, burst_start,
            todo, ev.z_trail, t_split, cfg.probe_size, cfg.step_size,
            cfg.max_gap_size, cfg.min_duplication_length, arms, cap)
        passes += 1
        n_rows = int(n_rows)
        if n_rows > cap:
            cap = n_rows
            continue
        ids = todo.to(torch.int64)
        over = status[ids] != 0
        bad = torch.zeros(nb, dtype=torch.bool, device=dev)
        bad[ids[over]] = True
        rows = rows[:n_rows]
        parts.append(rows[~bad[rows[:, 0] >> 32]])
        tests += int(t[ids[~over]].sum())
        todo = todo[over]
        if not todo.numel():
            break
        arms *= 2
    rows = torch.cat(parts)
    rows = rows[torch.sort(rows[:, 0]).indices]
    return rows, ChainStats(E, int(ev.m_off[-1]), todo_n, longest, passes,
                            tests, arms, rows.shape[0])


def families_from_rows(rows: np.ndarray) -> list:
    """Family rows (ordered, as :func:`chain_rows` returns them) in the
    native-engine format: lists of (left, right, left_len, right_len)."""
    families = []
    prev = None
    for key, left, right, llen, rlen, fam in rows.tolist():
        at = (key >> 32, fam)
        if at != prev:
            families.append([])
            prev = at
        families[-1].append((left, right, llen, rlen))
    return families


def chain_events_tensors(ev: Events, cfg: ChainConfig
                         ) -> tuple[list, ChainStats]:
    """Raw families of the events ``ev`` (native-engine format), chained
    by KN on the events' device; only the family rows come back."""
    rows, stats = chain_rows(ev, cfg)
    return families_from_rows(rows.cpu().numpy()), stats


def upload_events(probe_is, z_before, m_offsets, m_flat, z_trail, m_offset,
                  device) -> Events:
    """The numpy event stream of ``native.chain_events`` as :class:`Events`
    on ``device`` (probe indices, quiet counts and ``z_trail`` under
    2^31)."""
    i32 = np.iinfo(np.int32)
    for name, a in (("probe_is", probe_is), ("z_before", z_before),
                    ("z_trail", np.asarray([z_trail]))):
        a = np.asarray(a)
        if a.size and (a.min() < i32.min or a.max() > i32.max):
            raise ValueError(f"chain: {name} out of int32 range")
    m = np.asarray(m_flat)
    m = m if m.dtype == np.int32 else m.astype(np.int64)

    def up(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dt)).to(device)

    return Events(up(probe_is, np.int32), up(z_before, np.int32),
                  up(m_offsets, np.int64), up(m, m.dtype),
                  up([int(z_trail)], np.int32), int(m_offset))


def chain_events_device(cfg: ChainConfig, probe_is, z_before, m_offsets,
                        m_flat, z_trail, *, m_offset: int = 0,
                        device: torch.device | None = None) -> list:
    """Raw families of an event stream given as ``native.chain_events``
    takes it (numpy; the matches shifted by ``m_offset``), chained on
    ``device`` (default: the CUDA device; the CPU runs KN's plain version);
    the JAX ``chain_events_device`` (chain_jax.py:434)."""
    if device is None:
        device = cuda_device()
    ev = upload_events(probe_is, z_before, m_offsets, m_flat, z_trail,
                       m_offset, device)
    return chain_events_tensors(ev, cfg)[0]


def events_from_probe_stream(probe_is, matches, valid) -> tuple:
    """A prepared probe stream (:func:`prepare_probe_stream_host`) as
    events: an invalid probe is skipped with no aging, a valid probe
    without matches is a quiet probe, a matched probe an event. Returns
    (probe_is, z_before, m_offsets, m_flat, z_trail) as numpy."""
    counts = (np.asarray(matches) >= 0).sum(1)
    valid = np.asarray(valid, dtype=bool)
    event = valid & (counts > 0)
    quiet = np.cumsum(valid & (counts == 0))
    at = quiet[event]
    z_before = np.diff(np.concatenate([[0], at]))
    z_trail = int(quiet[-1] - (at[-1] if at.size else 0)) if len(quiet) \
        else 0
    m_offsets = np.concatenate([[0], np.cumsum(counts[event])])
    m_flat = np.asarray(matches)[event]
    m_flat = m_flat[m_flat >= 0]  # a row's matches come first, in order
    return (np.asarray(probe_is)[event], z_before, m_offsets, m_flat,
            z_trail)


def chain_device(cfg: ChainConfig, sa: np.ndarray, probe_is: np.ndarray,
                 lo: np.ndarray, hi: np.ndarray, *, needle_offset: int,
                 needle_len: int, reverse: bool,
                 device: torch.device | None = None) -> list:
    """Families of the full probe stream (the JAX ``chain_device``,
    chain_jax.py:275, behind ``chain_scan`` :245): the exact host match
    preparation, the stream turned into events, then KN."""
    pis, matches, valid = prepare_probe_stream_host(
        sa, probe_is, lo, hi, needle_offset=needle_offset,
        needle_len=needle_len, reverse=reverse,
        max_cardinality=cfg.max_cardinality, max_matches=cfg.max_matches)
    ev = events_from_probe_stream(pis, matches, valid)
    return chain_events_device(cfg, *ev, device=device)
