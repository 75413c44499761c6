"""KN ``chain_bursts``'s design (csrc/chain.cu) on the CPU.

A numpy model of the kernel (:func:`kn_model`) computes what it computes,
burst by burst, the way it does:

- aging is implicit: an arm keeps the step ``x`` after which it is dead
  (extended at step s: s + D, spawned: s - 1 + D, D = max(1, ceil(max_gap
  / step))), active while the step count c < x; ``X``, the largest x since
  the last emission, is the step at which the last active arm dies;
- a match is admissible for an arm while c < x and (unsigned)(m_start -
  (r_end - ps + 1)) < w, the arm's width w = allow + ps - 1 (allow from its
  left length, in float64; 0 where allow <= 0), that is r_end - ps <
  m_start < r_end + allow;
- quiet runs in closed form: nothing but the emission at step X when it
  falls in the run; above 200 arms, histograms of the short arms' deaths
  over 32 steps at a time give the last step at which the prune fires,
  and one compaction removes every short arm dead by then;
- every burst starts on the warp path (no prune, at most ``warp_arms``
  arms); one that passes that budget below ``arms_cap`` is handed over to
  the block path, which reruns it from its first event and writes only
  the rows past those the warp wrote (the model checks that the rerun's
  first rows are the warp's);
- ``status`` 1 on arm overflow, ``n_rows`` counted past ``out_cap``, each
  finished burst's native (match, arm) test count.

It is held exactly (integers, tolerance 0) to ``chain_bursts_plain`` and,
through ``chain.chain_rows``, to ``native.chain_events``: rows, families,
status and test count, on a one-event burst, 31 / 32 / 33 arms, a burst
that passes the warp's budget mid-burst after an emission, 199 / 200 /
201 arms (the prune fires or not) in an event step and in a quiet run,
simultaneous death on a quiet run's last step, the last burst's z_trail
under t_split, matches past 2^31 through ``m_offset``, ``max_arms=1`` and
``out_cap=1`` (both reruns), and random streams. Then the wrapper and
``chain_rows`` with the library faked (the fake launch runs the model on
the wrapper's buffers): the arguments and zeroed counters it passes, the
block count, one launch a pass, and the passes and host reads of
``chain_rows``. The kernel itself is held to its plain version on the GPU
(tests/test_torch_cuda.py)."""

import ctypes

import numpy as np
import pytest
import torch

from asgart_tpu_torch import chain, native
from asgart_tpu_torch.kernels import _build
from asgart_tpu_torch.kernels import chain as kc

from torch_jax_ref import (one_port_test_at_a_time,  # noqa: F401
                           one_torch_thread)  # (autouse)

PRUNE_ABOVE = 200  # automaton.rs:173
WARP_ARMS = 64     # csrc/chain.cu kWarpArms
WINDOW = 32        # csrc/chain.cu kWindow
K, STEP, MAX_GAP = 20, 10, 120
T_SPLIT = -(-MAX_GAP // STEP)  # 12 = D


def death_delay(max_gap, step):
    return 1 if max_gap <= 0 else max(1, -(-max_gap // step))


def arm_w(l_len, ps, max_gap):
    """An arm's width over arrays: allow + ps - 1 (allow in float64,
    truncated as the C cast does), 0 where allow <= 0."""
    allow = np.maximum(max_gap, (0.1 * l_len.astype(np.float64))
                       .astype(np.int64))
    return np.where(allow > 0, allow + ps - 1, 0)


class _Burst:
    """One burst's run in the model (warp path with a budget and no
    prune, or block path)."""

    def __init__(self, ev, b, budget, cfg, info):
        (self.ev_i, self.ev_z, self.m_off, self.m, self.m_offset,
         self.bs, self.z_trail, self.n_bursts) = ev
        self.b, self.budget, self.info = b, budget, info
        (self.t_split, self.ps, self.step, self.max_gap,
         self.min_dup) = cfg
        self.D = death_delay(self.max_gap, self.step)
        z = np.zeros(0, np.int64)
        self.ls = self.le = self.rs = self.re = self.w = self.x = z
        self.c, self.X, self.fam, self.tests = 0, None, 0, 0
        self.rows = []  # (rank, l, r, l_len, r_len, family)
        self.over = False

    @property
    def n(self):
        return len(self.ls)

    def keep(self, mask):
        for f in ("ls", "le", "rs", "re", "w", "x"):
            setattr(self, f, getattr(self, f)[mask])

    def short(self):
        return (self.le - self.ls < self.min_dup) & \
            (self.re - self.rs < self.min_dup)

    def emit(self):
        em = np.nonzero(self.re - self.rs >= self.min_dup)[0]
        for j in em:
            self.rows.append((len(self.rows), int(self.ls[j]),
                              int(self.rs[j]), int(self.le[j] - self.ls[j]),
                              int(self.re[j] - self.rs[j]), self.fam))
        if len(em):
            self.fam += 1
        self.keep(np.zeros(self.n, bool))
        self.X = None

    def quiet(self, z):
        """z quiet steps in closed form."""
        if self.n == 0 or z <= 0:
            self.c += z
            return
        emits = self.X <= self.c + z
        s_end = self.X - 1 if emits else self.c + z
        s0 = self.c + 1
        while self.n > PRUNE_ABOVE and s0 <= s_end:
            w_end = min(s_end, s0 + WINDOW - 1)
            sel = self.short() & (self.x <= w_end)
            hist = np.bincount(np.maximum(self.x[sel] - s0, 0),
                               minlength=WINDOW)
            C, k = 0, 0
            while True:
                C += int(hist[k])
                if self.n - C <= PRUNE_ABOVE or s0 + k == w_end:
                    break
                k += 1
            if C:
                self.keep(~(self.short() & (self.x <= s0 + k)))
                self.info["quiet_prunes"] += 1
            s0 += k + 1
        if emits:
            self.emit()
            self.info["quiet_emits"] += 1
        self.c += z

    def event(self, e):
        i = int(self.ev_i[e])
        ms = self.m[self.m_off[e]: self.m_off[e + 1]].astype(np.int64) + \
            self.m_offset
        n0, ps, c, D = self.n, self.ps, self.c, self.D
        adm = (c < self.x)[None, :] & \
            ((ms[:, None] - self.re[None, :] + ps - 1).astype(np.uint64)
             < self.w[None, :].astype(np.uint64))
        hit = adm.any(1)
        first = np.where(hit, adm.argmax(1), -1) if n0 else \
            np.full(len(ms), -1)
        self.tests += int(np.where(hit, first + 1, n0).sum())
        fresh = ms[~hit]
        if n0 + len(fresh) > self.budget:
            self.over = True
            return
        last = np.full(n0, -1)
        for mi in np.nonzero(hit)[0]:  # the last match wins
            last[first[mi]] = mi
        ext = last >= 0
        self.le = np.where(ext, i + ps, self.le)
        self.re = np.where(ext, ms[np.maximum(last, 0)] + ps, self.re)
        self.w = np.where(ext, arm_w(self.le - self.ls, ps, self.max_gap),
                          self.w)
        self.x = np.where(ext, c + 1 + D, self.x)
        w_new = arm_w(np.full(len(fresh), ps), ps, self.max_gap)
        for f, v in (("ls", np.full(len(fresh), i)),
                     ("le", np.full(len(fresh), i + ps)), ("rs", fresh),
                     ("re", fresh + ps), ("w", w_new),
                     ("x", np.full(len(fresh), c + D))):
            setattr(self, f, np.concatenate([getattr(self, f),
                                             v.astype(np.int64)]))
        if ext.any():
            self.X = c + 1 + D
        elif len(fresh):
            self.X = c + D if self.X is None else max(self.X, c + D)
        self.c = c + 1
        if self.n > 0 and self.X <= self.c:  # simultaneous death
            self.emit()
        elif self.n > PRUNE_ABOVE:
            before = self.n
            self.keep(~(self.short() & (self.x <= self.c)))
            self.info["event_prunes"] += before > self.n
        self.info["max_arms"] = max(self.info["max_arms"], self.n)

    def run(self):
        e0, e1 = int(self.bs[self.b]), int(self.bs[self.b + 1])
        for e in range(e0, e1):
            if e > e0:
                self.quiet(int(self.ev_z[e]))
            self.event(e)
            if self.over:
                return self
        zt = int(self.z_trail)
        last = self.b == self.n_bursts - 1 and zt < self.t_split
        self.quiet(zt if last else self.t_split)
        return self


def kn_model(ev_i, ev_z, m_off, m, m_offset, burst_start, order, z_trail,
             t_split, ps, step, max_gap, min_dup, arms_cap, out_cap,
             warp_arms=WARP_ARMS):
    """The kernel's pass in numpy: (rows [min(n_rows, out_cap), 6] in
    emission order, n_rows, status [NB], tests [NB], info)."""
    nb = len(burst_start) - 1
    ev = (ev_i, ev_z, m_off, m, m_offset, burst_start, int(z_trail[0]), nb)
    cfg = (t_split, ps, step, max_gap, min_dup)
    status = np.zeros(nb, np.int32)
    tests = np.zeros(nb, np.int64)
    info = dict(handovers=0, handed_rows=0, quiet_prunes=0, event_prunes=0,
                quiet_emits=0, max_arms=0)
    out, queue = [], []

    def put(b, rows):
        out.extend(((b << 32) | r[0],) + r[1:] for r in rows)

    for b in (int(x) for x in order):  # the warp path, longest first
        if warp_arms == 0:
            queue.append((b, []))
            continue
        budget = min(warp_arms, arms_cap)
        run = _Burst(ev, b, budget, cfg, info).run()
        put(b, run.rows)
        if run.over and budget < arms_cap:
            queue.append((b, run.rows))
            info["handovers"] += 1
            info["handed_rows"] += len(run.rows)
            continue
        status[b], tests[b] = run.over, run.tests
    for b, warp_rows in queue:  # the block path, from the first event
        run = _Burst(ev, b, arms_cap, cfg, info).run()
        assert run.rows[:len(warp_rows)] == warp_rows
        put(b, run.rows[len(warp_rows):])
        status[b], tests[b] = run.over, run.tests
    rows = np.asarray(out, dtype=np.int64).reshape(-1, 6)
    return rows[:out_cap], len(out), status, tests, info


# --- event streams -------------------------------------------------------

def stream(events, z_trail=T_SPLIT, m_offset=0, i64=False):
    """numpy events from [(probe index, quiet probes before, matches)]."""
    ev_i = np.asarray([e[0] for e in events], np.int32)
    ev_z = np.asarray([e[1] for e in events], np.int32)
    counts = [len(e[2]) for e in events]
    m_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    m = np.asarray([x for e in events for x in e[2]],
                   np.int64 if i64 else np.int32)
    return ev_i, ev_z, m_off, m, int(z_trail), m_offset


def spawn_stream(n_first, extra=3, seed=0):
    """A burst whose first event spawns ``n_first`` arms (scattered
    matches), then ``extra`` events extending one of them."""
    rng = np.random.default_rng(seed)
    far = [int(x) for x in rng.choice(10 ** 6, n_first, replace=False)
           * 1000 + 10 ** 7]
    ev = [(0, 0, far)]
    for p in range(1, extra + 1):
        ev.append((p * STEP, 0, [far[0] + p * STEP]))
    return stream(ev)


def mid_budget_stream():
    """A burst whose one track emits a family mid-burst, then an event
    that spawns 70 arms (past the warp's 64). The track's last event also
    spawns an arm and extends none (its last extension was a step
    before), so every arm dies on the last step of the quiet run of D - 1
    probes that follows: under t_split, within the burst."""
    ev, p = [], 0
    for q in range(30):  # a track long enough to emit
        ev.append((p * STEP, 0, [5 * 10 ** 6 + p * STEP]))
        p += 1
    ev.append((p * STEP, 0, [7 * 10 ** 6]))
    p += T_SPLIT
    ev.append((p * STEP, T_SPLIT - 1, [9 * 10 ** 6 + 1000 * j
                                       for j in range(70)]))
    for q in range(1, 25):
        ev.append(((p + q) * STEP, 0, [9 * 10 ** 6 + (p + q) * STEP]))
    return stream(ev)


def prune_stream(n_total, quiet=False, seed=1):
    """A burst with one long-lived track and scattered spawns (8 an
    event): ``n_total`` arms after the event that spawns the last of them,
    the earliest spawns dead and short by then (the prune fires in that
    event step at 201, not at 199 or 200); then the track alone. With
    ``quiet``, 60 spawns an event, and a quiet run of D - 1 probes with
    more than 200 arms in which they die one event's worth a step."""
    rng = np.random.default_rng(seed)
    track = 3 * 10 ** 7
    ev, p, made = [], 0, 1
    ev.append((0, 0, [track]))
    while made < n_total:
        take = min(8 if not quiet else 60, n_total - made)
        scattered = [int(x) * 1000 + 10 ** 8 for x in
                     rng.choice(10 ** 6, take, replace=False)]
        p += 1
        ev.append((p * STEP, 0, [track + p * STEP] + scattered))
        made += take
    if quiet:
        p += T_SPLIT - 1
        ev.append((p * STEP, T_SPLIT - 1, [track + p * STEP]))
    for q in range(1, 6):  # the track alone: tests over what is left
        ev.append(((p + q) * STEP, 0, [track + (p + q) * STEP]))
    return stream(ev)


def random_stream(seed, n_events=150, tracks=3, spur=(0, 12), wide=0,
                  m_offset=0, i64=False, burst_p=0.03, max_z=6):
    """Tracks (diagonals that extend arms), scattered matches (arms that
    spawn, die and are pruned), quiet runs, burst breaks, wide events."""
    rng = np.random.default_rng(seed)
    offs = [int(rng.integers(10 ** 3, 10 ** 6)) * STEP for _ in range(tracks)]
    on = [True] * tracks
    ev, p = [], 0
    for e in range(n_events):
        z = 0
        if e:
            z = int(rng.integers(0, max_z + 1)) if rng.random() < 0.5 else 0
            if rng.random() < burst_p:
                z = T_SPLIT + int(rng.integers(0, 5))
            p += z + 1
        i = p * STEP
        ms = []
        for t in range(tracks):
            if rng.random() < 0.05:
                on[t] = not on[t]
            if on[t] and rng.random() < 0.8:
                ms.append(i + offs[t] + int(rng.integers(-3, 4)))
        n_s = wide if wide and e % 13 == 12 else \
            int(rng.integers(spur[0], spur[1] + 1))
        ms += [int(x) for x in rng.integers(0, 5 * 10 ** 6, n_s)]
        ev.append((i, z, ms or [int(rng.integers(0, 5 * 10 ** 6))]))
    return stream(ev, int(rng.integers(0, 2 * T_SPLIT)), m_offset, i64)


CASES = {
    "one_event": lambda: stream([(0, 0, [10 ** 6, 3 * 10 ** 6, 7])], 5),
    "arms31": lambda: spawn_stream(31),
    "arms32": lambda: spawn_stream(32),
    "arms33": lambda: spawn_stream(33),
    "arms65": lambda: spawn_stream(65),
    "budget_mid_burst": mid_budget_stream,
    "prune199": lambda: prune_stream(199),
    "prune200": lambda: prune_stream(200),
    "prune201": lambda: prune_stream(201),
    "prune_quiet": lambda: prune_stream(320, quiet=True),
    "last_burst_trail0": lambda: stream([(0, 0, [10 ** 6]),
                                         (STEP, 0, [10 ** 6 + STEP])], 0),
    "last_burst_trail_d1": lambda: stream([(0, 0, [10 ** 6]),
                                           (STEP, 0, [10 ** 6 + STEP])],
                                          T_SPLIT - 1),
    "past_2_31": lambda: random_stream(5, m_offset=3 * 2 ** 31),
    "past_2_31_i64": lambda: random_stream(6, m_offset=2 ** 31 + 5,
                                           i64=True),
    "random_sparse": lambda: random_stream(7, spur=(0, 2)),
    "random_dense": lambda: random_stream(8, n_events=100, spur=(10, 40),
                                          wide=120),
    "random_many_bursts": lambda: random_stream(9, burst_p=0.2),
}


def cfg_of(min_dup=60, **caps):
    return chain.ChainConfig(probe_size=K, step_size=STEP,
                             max_gap_size=MAX_GAP,
                             min_duplication_length=min_dup,
                             max_cardinality=10 ** 6, **caps)


def events_of(s):
    ev_i, ev_z, m_off, m, z_trail, m_offset = s
    t = torch.from_numpy
    return chain.Events(t(ev_i), t(ev_z), t(m_off), t(m),
                        torch.tensor([z_trail], dtype=torch.int32), m_offset)


def model_fn(warp_arms=WARP_ARMS, infos=None):
    """``kn_model`` in the form of ``chain_bursts`` (tensors in and out)."""
    def fn(ev_i, ev_z, m_off, m, m_offset, burst_start, order, z_trail,
           *args):
        rows, n, st, te, info = kn_model(
            ev_i.numpy(), ev_z.numpy(), m_off.numpy(), m.numpy(), m_offset,
            burst_start.numpy(), order.numpy(), z_trail.numpy(), *args,
            warp_arms=warp_arms)
        if infos is not None:
            infos.append(info)
        out = torch.zeros((args[-1], 6), dtype=torch.int64)
        out[:len(rows)] = torch.from_numpy(rows)
        return (out, torch.tensor([n]), torch.from_numpy(st),
                torch.from_numpy(te))
    return fn


def canon(rows, n, status, tests):
    """A pass's result as comparable values: the rows as a sorted list
    (they come in no order), and the test counts of the finished bursts
    (an overflowed burst's count is not part of the contract)."""
    n = int(n)
    st = status.tolist() if hasattr(status, "tolist") else list(status)
    te = [int(t) for t, s in zip(tests, st) if s == 0]
    return n, sorted(map(tuple, np.asarray(rows)[:n].tolist())), st, te


_PLAIN = {}


@pytest.mark.parametrize("warp_arms", [64, 4, 0])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_plain_and_native(name, warp_arms):
    """The model, through ``chain_rows``, equals the plain version's rows,
    families, test count and passes, and ``native.chain_events``'s
    families; with one arm and one row (both reruns) too."""
    s = CASES[name]()
    ev = events_of(s)
    min_dup = 150 if name.startswith("budget") else 60
    infos = []
    for caps in (dict(max_arms=1024), dict(max_arms=1, out_cap=1)):
        cfg = cfg_of(min_dup, **caps)
        key = (name, tuple(caps.items()))
        if key not in _PLAIN:  # the plain chain once for the warp budgets
            _PLAIN[key] = chain.chain_rows(ev, cfg, kc.chain_bursts_plain)
        want, w_st = _PLAIN[key]
        got, g_st = chain.chain_rows(ev, cfg, model_fn(warp_arms, infos))
        assert torch.equal(got, want)
        assert g_st == w_st
    ev_i, ev_z, m_off, m, z_trail, m_offset = s
    fams = native.chain_events(
        ev_i, ev_z, m_off, m.astype(np.int64) + m_offset, z_trail=z_trail,
        probe_size=K, step_size=STEP, max_gap_size=MAX_GAP,
        min_duplication_length=min_dup, max_cardinality=10 ** 6)
    assert chain.families_from_rows(got.numpy()) == fams
    info = infos[0]
    # each edge is what its name says
    if name.startswith("arms"):
        assert info["max_arms"] == int(name[4:])
        assert bool(info["handovers"]) == (int(name[4:]) > warp_arms > 0)
    if name == "budget_mid_burst" and warp_arms == 64:
        assert info["handovers"] == 1 and info["handed_rows"] > 0
    if name.startswith("prune19") or name == "prune200":
        assert info["event_prunes"] == 0
    if name == "prune201":
        assert info["event_prunes"] > 0
    if name == "prune_quiet":
        assert info["quiet_prunes"] > 0
    if name == "budget_mid_burst":
        assert info["quiet_emits"] > 0  # death on a quiet run's last step


@pytest.mark.parametrize("name", ["arms33", "prune_quiet", "random_dense",
                                  "budget_mid_burst", "past_2_31"])
def test_model_pass_equals_plain_pass(name):
    """One pass at small capacities (arm overflow and row overflow in the
    pass itself): n_rows, rows, status and the finished bursts' tests
    equal the plain version's."""
    s = CASES[name]()
    ev = events_of(s)
    t_split = chain.burst_threshold(cfg_of())
    bs, order = chain.bursts_from_events(ev, t_split)
    for arms, cap in ((1024, 4096), (40, 4096), (1, 1), (300, 3)):
        args = (ev.ev_i, ev.ev_z, ev.m_off, ev.m, ev.m_offset, bs, order,
                ev.z_trail, t_split, K, STEP, MAX_GAP, 60, arms, cap)
        want = canon(*kc.chain_bursts_plain(*args))
        got = canon(*model_fn()(*args))
        assert got[0] == want[0] and got[2:] == want[2:]
        if got[0] <= cap:
            assert got[1] == want[1]


def test_trailing_run_of_the_last_burst():
    """The last burst's trailing run is min(z_trail, t_split) steps: an
    arm extended by the last event outlives D - 1 of them and dies on the
    D-th, so no family under D quiet probes and one from D on; the plain
    version's rows each time."""
    fams = []
    for zt in (0, T_SPLIT - 2, T_SPLIT - 1, T_SPLIT, 3 * T_SPLIT):
        s = stream([(0, 0, [10 ** 6])] + [(p * STEP, 0, [10 ** 6 + p * STEP])
                                          for p in range(1, 12)], zt)
        ev = events_of(s)
        got, _ = chain.chain_rows(ev, cfg_of(), model_fn())
        want, _ = chain.chain_rows(ev, cfg_of(), kc.chain_bursts_plain)
        assert torch.equal(got, want)
        fams.append(len(chain.families_from_rows(got.numpy())))
    assert fams == [0, 0, 0, 1, 1]


# --- the wrapper with the library faked ------------------------------------

def _arr(ptr, n, ct=ctypes.c_int64):
    return np.ctypeslib.as_array((ct * max(n, 1)).from_address(ptr))[:n]


class FakeLib:
    """The kernel library's chain entries: the launch runs the model on
    the buffers the wrapper passes."""

    def __init__(self, grid=8):
        self.grid, self.calls = grid, []

    def asgart_chain_grid(self, threads, arms_cap, in_smem, blocks):
        assert threads == kc.THREADS
        _arr(blocks, 1, ctypes.c_int32)[0] = \
            self.grid if in_smem or kc.SMEM_LIMIT == 0 else 0
        return 0

    def asgart_chain_bursts(self, ev_i, ev_z, m_off, m, m_is_i64, m_total,
                            m_offset, burst_start, order, n_order, n_bursts,
                            z_trail,
                            t_split, ps, step, max_gap, min_dup, arms_cap,
                            warp_arms, rows, out_cap, n_rows, ctr, queue,
                            status, tests, arms_global, blocks, threads,
                            stream):
        bs = _arr(burst_start, n_bursts + 1).copy()
        E = int(bs[-1])
        offs = _arr(m_off, E + 1).copy()
        assert m_total == offs[-1]
        mv = _arr(m, m_total,
                  ctypes.c_int64 if m_is_i64 else ctypes.c_int32).copy()
        assert not _arr(ctr, 4, ctypes.c_int32).any()
        assert not _arr(queue, n_order).any()
        assert _arr(n_rows, 1)[0] == 0
        r, n, st, te, _ = kn_model(
            _arr(ev_i, E, ctypes.c_int32), _arr(ev_z, E, ctypes.c_int32),
            offs, mv, m_offset, bs, _arr(order, n_order, ctypes.c_int32),
            _arr(z_trail, 1, ctypes.c_int32), t_split, ps, step, max_gap,
            min_dup, arms_cap, out_cap, warp_arms=warp_arms)
        out = _arr(rows, out_cap * 6).reshape(-1, 6)
        out[:len(r)] = r
        _arr(n_rows, 1)[0] = n
        ids = _arr(order, n_order, ctypes.c_int32)
        _arr(status, n_bursts, ctypes.c_int32)[ids] = st[ids]
        _arr(tests, n_bursts)[ids] = te[ids]
        self.calls.append(dict(n_order=n_order, arms_cap=arms_cap,
                               warp_arms=warp_arms, blocks=blocks,
                               threads=threads, scratch=arms_global))
        return 0


def _fake(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


def _count_reads(monkeypatch):
    reads = []
    for name in ("__int__", "item", "tolist", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            reads.append(1)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


@pytest.mark.parametrize("case", [
    # (stream, caps, WARP_ARMS, SMEM_LIMIT, passes, of them row reruns)
    ("random_sparse", dict(max_arms=1024), 64, None, 1, 0),
    ("random_many_bursts", dict(max_arms=1024, out_cap=1), 64, None, 2, 1),
    ("random_dense", dict(max_arms=1024), 0, None, 1, 0),
    ("budget_mid_burst", dict(max_arms=1024), 64, 0, 1, 0),
    ("prune_quiet", dict(max_arms=64), 64, None, 4, 0),
    ("arms33", dict(max_arms=1, out_cap=1), 4, None, 7, 0),
])
def test_chain_rows_launches_with_the_library_faked(monkeypatch, case):
    """``chain_rows`` through the wrapper with the library faked: one
    launch a pass; the counters, the handover queue and n_rows zeroed; the
    warp budget, the block size and a block per 8 bursts (one per burst on
    the block path alone) passed; arms in global scratch when they do not
    fit; rows equal to the plain version's; and the parent's passes and
    host reads: one for the longest burst and one for the matches, and per
    pass n_rows and, unless the rows passed out_cap, the tests (the grid
    query, asked once per capacity, reads no tensor)."""
    name, caps, warp, smem, passes, row_reruns = case
    monkeypatch.setattr(kc, "WARP_ARMS", warp)
    if smem is not None:
        monkeypatch.setattr(kc, "SMEM_LIMIT", smem)
    ev = events_of(CASES[name]())
    cfg = cfg_of(150 if name.startswith("budget") else 60, **caps)
    want, w_st = chain.chain_rows(ev, cfg, kc.chain_bursts_plain)
    lib = FakeLib()
    _fake(monkeypatch, lib)
    monkeypatch.setattr(kc, "_GRIDS", {})
    before = kc.chain_bursts.launches
    reads = _count_reads(monkeypatch)
    got, g_st = chain.chain_rows(ev, cfg)
    n = len(reads)
    monkeypatch.undo()
    assert torch.equal(got, want) and g_st == w_st
    assert g_st.passes == passes == len(lib.calls)
    assert kc.chain_bursts.launches - before == passes
    assert n == 2 + 2 * passes - row_reruns
    for call in lib.calls:
        assert call["blocks"] == min(call["n_order"], lib.grid)
        assert call["threads"] == kc.THREADS
        assert call["warp_arms"] == warp
        assert (call["scratch"] is not None) == (smem == 0)


def test_wrapper_refuses_a_step_under_one(monkeypatch):
    """The kernel counts steps of ``step`` bases: step < 1 raises on the
    card's path (the plain version takes it on the CPU)."""
    ev = events_of(CASES["one_event"]())
    bs, order = chain.bursts_from_events(ev, T_SPLIT)
    _fake(monkeypatch, FakeLib())
    with pytest.raises(ValueError, match="step"):
        kc.chain_bursts(ev.ev_i, ev.ev_z, ev.m_off, ev.m, 0, bs, order,
                        ev.z_trail, T_SPLIT, K, 0, MAX_GAP, 60, 8, 8)
