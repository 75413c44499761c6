"""KN ``chain_bursts``: the arm automaton over independent bursts of events.

Kernel: ``csrc/chain.cu`` (see its header for what it replaces in the JAX
package and how it is bounded). ``chain_bursts_plain`` is the same
function in plain PyTorch: the JAX ``_match_step`` / ``_quiet_step`` /
``_age_prune_emit`` form (asgart_tpu/chain_jax.py:136-241) batched over
bursts as its vmap was, with int64 positions and the native chain's
float64 ``allow``.

Both take the event stream as tensors (``ev_i`` / ``ev_z`` int32 [E],
``m_off`` int64 [E + 1], matches ``m`` int32 or int64 plus ``m_offset``),
the bursts (``burst_start`` int64 [NB + 1]) and the bursts to run
(``order`` int32), and return ``(rows, n_rows, status, tests)``:

- ``rows`` int64 [out_cap, 6]: (burst << 32 | row within the burst, left,
  right, left length, right length, family within the burst), the first
  ``min(n_rows, out_cap)`` filled, in no particular order;
- ``n_rows`` int64 [1]: the rows emitted, counted past ``out_cap``;
- ``status`` int32 [NB]: 1 where a run burst needed more than ``arms_cap``
  arms (its rows are then incomplete), else 0;
- ``tests`` int64 [NB]: the (match, arm) tests the native walk makes on
  each run burst.

Entries of bursts not in ``order`` are unspecified. ``chain.chain_rows``
runs the retries and orders the rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

THREADS = 256  # the block path's threads (512 at most: csrc/chain.cu)
# arms a burst may hold on the warp path (csrc/chain.cu kWarpArms at
# most); a burst with more is handed over to the block path; 0: every
# burst on the block path
WARP_ARMS = 64
# the dynamic shared memory a block may take (H100: 227 KB); larger arm
# sets go to global scratch
SMEM_LIMIT = 232448
PRUNE_ABOVE = 200  # automaton.rs:173
PLAIN_LANES = 64  # bursts the plain version runs in lockstep
ARM_BYTES = 56  # csrc/chain.cu kArmBytes
WINDOW = 32  # csrc/chain.cu kWindow


def smem_bytes(threads: int, arms_cap: int, in_smem: bool) -> int:
    """csrc/chain.cu smem_bytes: a block's event records, event tiles, a
    tile sorted, tile results, warp sums and prune histogram, and its arms
    when they are in shared memory."""
    return 16 * 8 + threads * (4 * 8 + 3 * 4) + (64 + WINDOW) * 4 + \
        (arms_cap * ARM_BYTES if in_smem else 0)


def _check(ev_i, ev_z, m_off, m, burst_start, order, z_trail):
    for t, dts in ((ev_i, (torch.int32,)), (ev_z, (torch.int32,)),
                   (m_off, (torch.int64,)), (m, (torch.int32, torch.int64)),
                   (burst_start, (torch.int64,)), (order, (torch.int32,)),
                   (z_trail, (torch.int32,))):
        if t.dtype not in dts or not t.is_contiguous():
            raise ValueError("chain_bursts: bad dtype or layout")
    if ev_z.numel() != ev_i.numel() or m_off.numel() != ev_i.numel() + 1:
        raise ValueError("chain_bursts: event arrays differ in length")
    if z_trail.numel() != 1:
        raise ValueError("chain_bursts: z_trail holds one count")


_GRIDS: dict = {}


def _grid(lib, dev, arms_cap: int) -> tuple:
    """(arms in shared memory, resident blocks) for a launch of THREADS
    threads with arms_cap arms, asked of the library once per device,
    block size, capacity and shared-memory limit."""
    key = (str(dev), THREADS, arms_cap, SMEM_LIMIT)
    if key not in _GRIDS:
        grid = ctypes.c_int(0)
        in_smem = smem_bytes(THREADS, arms_cap, True) <= SMEM_LIMIT - 512
        for mode in ((True, False) if in_smem else (False,)):
            _build.check(lib.asgart_chain_grid(THREADS, arms_cap, int(mode),
                                               ctypes.addressof(grid)),
                         "chain_bursts(grid)")
            if grid.value > 0:
                _GRIDS[key] = (mode, grid.value)
                break
        else:
            raise RuntimeError(f"chain_bursts: no block of {THREADS} "
                               f"threads fits on this device")
    return _GRIDS[key]


def chain_bursts(ev_i, ev_z, m_off, m, m_offset: int, burst_start, order,
                 z_trail, t_split: int, ps: int, step: int, max_gap: int,
                 min_dup: int, arms_cap: int, out_cap: int):
    """One pass of the automaton over the bursts ``order`` (module
    docstring), with at most ``arms_cap`` arms a burst and ``out_cap``
    output rows."""
    _check(ev_i, ev_z, m_off, m, burst_start, order, z_trail)
    if arms_cap < 1 or out_cap < 1:
        raise ValueError("chain_bursts: capacities must be positive")
    args = (m_offset, burst_start, order, z_trail, t_split, ps, step,
            max_gap, min_dup, arms_cap, out_cap)
    if not _build.on_cuda(ev_i, ev_z, m_off, m, burst_start, order,
                          z_trail):
        return chain_bursts_plain(ev_i, ev_z, m_off, m, *args)
    if step < 1:
        raise ValueError("chain_bursts: the kernel takes step >= 1")
    dev = ev_i.device
    nb = burst_start.numel() - 1
    n_order = order.numel()
    rows = torch.empty((out_cap, 6), dtype=torch.int64, device=dev)
    # n_rows, then 4 int32 counters (jobs, handovers pushed and taken,
    # warp jobs done), then the handover queue: one memset
    counters = torch.zeros(3 + n_order, dtype=torch.int64, device=dev)
    status = torch.empty(max(nb, 1), dtype=torch.int32, device=dev)
    tests = torch.empty(max(nb, 1), dtype=torch.int64, device=dev)
    if n_order == 0:
        return rows, counters[:1], status[:nb], tests[:nb]
    lib = _build.lib()
    in_smem, grid = _grid(lib, dev, arms_cap)
    blocks = min(n_order, grid)  # the block path's (csrc/chain.cu)
    scratch = None if in_smem else torch.empty(
        blocks * arms_cap * ARM_BYTES, dtype=torch.uint8, device=dev)
    cp = counters.data_ptr()
    chain_bursts.launches += 1
    _build.check(lib.asgart_chain_bursts(
        ev_i.data_ptr(), ev_z.data_ptr(), m_off.data_ptr(), m.data_ptr(),
        int(m.dtype == torch.int64), m.numel(), m_offset,
        burst_start.data_ptr(),
        order.data_ptr(), n_order, nb, z_trail.data_ptr(), t_split, ps,
        step, max_gap, min_dup, arms_cap, WARP_ARMS, rows.data_ptr(),
        out_cap, cp, cp + 8, cp + 24, status.data_ptr(), tests.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks, THREADS,
        _build.stream_of(ev_i)), "chain_bursts")
    return rows, counters[:1], status[:nb], tests[:nb]


chain_bursts.launches = 0


def _d_ss(a_start, a_end, m_start, m_end):
    """Segment distance (automaton.rs:207-216), as chain_jax._d_ss."""
    inside = ((m_start >= a_start) & (m_start <= a_end)) | \
             ((m_end >= a_start) & (m_end <= a_end))
    d = torch.minimum((a_start - m_end).abs(), (a_end - m_start).abs())
    return torch.where(inside, 0, d)


class _Lanes:
    """The arm sets of B bursts in lockstep: [B, A] tensors whose first
    ``n[b]`` slots hold burst b's arms in arm order (A grows as needed)."""

    def __init__(self, B: int, dev):
        z = torch.zeros((B, 8), dtype=torch.int64, device=dev)
        self.ls, self.le, self.rs, self.re, self.gap = (z.clone()
                                                        for _ in range(5))
        self.act = torch.zeros((B, 8), dtype=torch.bool, device=dev)
        self.n = torch.zeros(B, dtype=torch.int64, device=dev)

    @property
    def width(self) -> int:
        return self.ls.shape[1]

    def fields(self):
        return ("ls", "le", "rs", "re", "gap", "act")

    def grow(self, need: int) -> None:
        if need <= self.width:
            return
        extra = max(need, 2 * self.width) - self.width
        for f in self.fields():
            t = getattr(self, f)
            setattr(self, f, torch.cat(
                [t, torch.zeros((t.shape[0], extra), dtype=t.dtype,
                                device=t.device)], 1))

    def used(self):
        return torch.arange(self.width, device=self.n.device)[None, :] < \
            self.n[:, None]


def chain_bursts_plain(ev_i, ev_z, m_off, m, m_offset, burst_start, order,
                       z_trail, t_split, ps, step, max_gap, min_dup,
                       arms_cap, out_cap):
    """Plain PyTorch version of the KN kernel: the bursts of ``order`` in
    lockstep, ``PLAIN_LANES`` at a time (their [lanes, matches, arms]
    classification stays small), one event position (and one quiet step)
    at a time."""
    dev = ev_i.device
    i64 = torch.int64
    nb = burst_start.numel() - 1
    status = torch.zeros(max(nb, 1), dtype=torch.int32, device=dev)[:nb]
    tests = torch.zeros(max(nb, 1), dtype=i64, device=dev)[:nb]
    out = []
    for g in range(0, order.numel(), PLAIN_LANES):
        bid = order[g: g + PLAIN_LANES].to(i64)
        out += _plain_lanes(ev_i, ev_z, m_off, m, m_offset, burst_start,
                            bid, z_trail, t_split, ps, step, max_gap,
                            min_dup, arms_cap, status, tests)
    rows_all = torch.cat(out) if out else torch.zeros((0, 6), dtype=i64,
                                                      device=dev)
    n = rows_all.shape[0]
    rows = torch.zeros((out_cap, 6), dtype=i64, device=dev)
    rows[:min(n, out_cap)] = rows_all[:out_cap]
    return rows, torch.tensor([n], dtype=i64, device=dev), status, tests


def _plain_lanes(ev_i, ev_z, m_off, m, m_offset, burst_start, bid, z_trail,
                 t_split, ps, step, max_gap, min_dup, arms_cap, status,
                 tests) -> list:
    """The bursts ``bid`` in lockstep; sets their ``status`` and ``tests``
    and returns their rows (a list of [r, 6] tensors)."""
    dev = ev_i.device
    i64 = torch.int64
    nb = burst_start.numel() - 1
    B = bid.numel()
    bs = burst_start[bid]
    length = burst_start[bid + 1] - bs
    zt = z_trail.to(i64).reshape(())
    tz = torch.where(bid == nb - 1, torch.clamp(zt, max=t_split),
                     torch.full_like(bid, t_split))
    st = _Lanes(B, dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    n_fam = torch.zeros(B, dtype=i64, device=dev)
    n_row = torch.zeros(B, dtype=i64, device=dev)
    b_tests = torch.zeros(B, dtype=i64, device=dev)
    out = []

    def tail(lane, dirty):
        """Age every non-dirty arm of the lanes ``lane``, prune above 200,
        emit on simultaneous death (chain_jax._age_prune_emit)."""
        nonlocal n_fam, n_row
        used = st.used()
        age = used & ~dirty & lane[:, None]
        st.gap = torch.where(age, st.gap + step, st.gap)
        st.act = st.act & ~(age & (st.gap >= max_gap))
        prune = lane & (st.n > PRUNE_ABOVE)
        keep = used & (st.act | ((st.le - st.ls) >= min_dup)
                       | ((st.re - st.rs) >= min_dup))
        keep = torch.where(prune[:, None], keep, used)
        A = st.width
        dest = torch.where(keep, torch.cumsum(keep.to(i64), 1) - 1, A)
        for f in st.fields():
            t = getattr(st, f)
            c = torch.zeros((B, A + 1), dtype=t.dtype, device=dev)
            setattr(st, f, c.scatter(1, dest, t)[:, :A])
        st.n = keep.sum(1)
        used = st.used()
        dead = lane & (st.n > 0) & ~(st.act & used).any(1)
        emit = used & ((st.re - st.rs) >= min_dup) & dead[:, None]
        rank = torch.cumsum(emit.to(i64), 1) - 1
        lane_i, slot = torch.nonzero(emit, as_tuple=True)
        if lane_i.numel():
            out.append(torch.stack([
                (bid[lane_i] << 32) | (n_row[lane_i] + rank[lane_i, slot]),
                st.ls[lane_i, slot], st.rs[lane_i, slot],
                st.le[lane_i, slot] - st.ls[lane_i, slot],
                st.re[lane_i, slot] - st.rs[lane_i, slot],
                n_fam[lane_i]], 1))
        n_row = n_row + emit.sum(1)
        n_fam = n_fam + emit.any(1).to(i64)
        st.n = torch.where(dead, 0, st.n)
        st.act = st.act & ~dead[:, None]

    def quiet(steps):
        """Quiet steps: ``steps[b]`` of them on lane b, while it has arms."""
        for q in range(int(steps.max()) if steps.numel() else 0):
            lane = alive & (q < steps) & (st.n > 0)
            if not bool(lane.any()):
                break
            tail(lane, torch.zeros_like(st.act))

    for p in range(int(length.max())):
        on = alive & (p < length)
        if not bool(on.any()):
            break
        e = torch.where(on, bs + p, 0)
        if p > 0:
            quiet(torch.where(on, ev_z[e].to(i64), 0))
        mb = m_off[e]
        cnt = torch.where(on, m_off[e + 1] - mb, 0)
        M = int(cnt.max())
        j = torch.arange(M, device=dev)
        valid = j[None, :] < cnt[:, None]
        x = torch.where(valid, mb[:, None] + j[None, :], 0)
        ms = m[x].to(i64) + m_offset
        m_end = ms + ps
        i = ev_i[e].to(i64)
        # classification against the pre-step snapshot
        A = st.width
        used = st.used()
        l_len = st.le - st.ls
        allow = torch.clamp((0.1 * l_len.to(torch.float64)).to(i64),
                            min=max_gap)
        d = _d_ss(st.rs[:, None, :], st.re[:, None, :], ms[:, :, None],
                  m_end[:, :, None])
        adm = (used & st.act)[:, None, :] & (d < allow[:, None, :]) & \
            (m_end[:, :, None] > st.re[:, None, :])
        arm = torch.arange(A, device=dev)
        first = torch.where(adm, arm[None, None, :], A).min(2).values
        extend = valid & (first < A)
        b_tests += torch.where(valid, torch.where(extend, first + 1,
                                                  st.n[:, None]), 0).sum(1)
        # extensions, the last match winning
        target = torch.where(extend, first, A)
        last = torch.full((B, A + 1), -1, dtype=i64, device=dev)
        last = last.scatter_reduce(1, target, j[None, :].expand(B, M),
                                   "amax")[:, :A]
        dirty = last >= 0
        st.re = torch.where(dirty, m_end.gather(1, last.clamp(min=0)), st.re)
        st.le = torch.where(dirty, (i + ps)[:, None], st.le)
        st.gap = torch.where(dirty, 0, st.gap)
        # spawns in match order, appended
        fresh = valid & ~extend
        n_new = fresh.sum(1)
        over = on & (st.n + n_new > arms_cap)
        status[bid[over]] = 1
        alive = alive & ~over
        on = on & ~over
        fresh = fresh & on[:, None]
        st.grow(int(torch.where(on, st.n + n_new, 0).max()))
        A = st.width
        slot = torch.where(fresh, st.n[:, None] + torch.cumsum(
            fresh.to(i64), 1) - 1, A)
        for f, v in (("ls", i[:, None].expand(B, M)),
                     ("le", (i + ps)[:, None].expand(B, M)),
                     ("rs", ms), ("re", m_end),
                     ("gap", torch.zeros_like(ms)),
                     ("act", torch.ones_like(fresh))):
            t = getattr(st, f)
            c = torch.cat([t, torch.zeros((B, 1), dtype=t.dtype,
                                          device=dev)], 1)
            setattr(st, f, c.scatter(1, slot, v.to(t.dtype))[:, :A])
        dirty = torch.cat([dirty, torch.zeros((B, A - dirty.shape[1]),
                                              dtype=torch.bool,
                                              device=dev)], 1)
        st.n = torch.where(on, st.n + n_new, st.n)
        tail(on, dirty)
    quiet(torch.where(alive, tz, 0))
    tests[bid] = b_tests
    return out
