"""State carried across from the JAX package: its device indexes.

The system has no weights; its state is the device index. These helpers
take the arrays of a JAX ``FusedIndex`` (asgart_tpu/device_index.py:1580),
``DeviceWindowIndex`` (:1342), ``DeviceIndex`` (:1109) or
``BigWindowEngine`` (its window-relative ``key_hi``, ``key_lo`` and
``sa``; asgart_tpu/device_engine.py:2453),
read out with ``np.asarray``, and give the port's counterparts, so the
port's engines can run on an index the JAX package built.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_index import FusedIndex
from .kernels.tables import decimated_index, decimated_size
from .table_index import DeviceIndex
from .window_index import DeviceWindowIndex


def rank_from_decimated(rank_dec: np.ndarray, step: int, W: int
                        ) -> np.ndarray:
    """Plain-layout rank [W] from the JAX decimated rank (position p sits
    at (p % step) * C + p // step, C = len(rank_dec) // step); the JAX
    decimated tables pos_lo and pos_hi share the layout."""
    C = len(rank_dec) // step
    p = np.arange(W)
    return np.asarray(rank_dec)[decimated_index(p, step, C)]


def fused_index_from_numpy(sa, lane_lo, lane_hi, lane_mask, specs, offs,
                           k: int, n: int, first_len: int, reverse: bool,
                           complement: bool, device: torch.device,
                           trim: tuple | None = None) -> FusedIndex:
    """The port's FusedIndex from a JAX FusedIndex's arrays and fields
    (its float raw totals become ints; ``trim`` is a window build's
    (ws, we)). A JAX window's ``sa`` holds genome positions, every slot
    shifted by ws, its probe slots too (asgart_tpu/device_index.py:
    1771-1774); the port's keeps window positions, so ws comes off every
    slot."""
    def dev(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    sa = np.asarray(sa)
    if trim is not None:
        sa = sa - np.int32(trim[0])
    return FusedIndex(
        sa=dev(sa, torch.int32), lane_lo=dev(lane_lo, torch.int32),
        lane_hi=dev(lane_hi, torch.int32),
        lane_mask=dev(lane_mask, torch.bool), specs=tuple(specs),
        offs={c: (int(o), int(t)) for c, (o, t) in offs.items()}, k=k,
        n=n, first_len=first_len, reverse=reverse, complement=complement,
        trim=None if trim is None else (int(trim[0]), int(trim[1])))


def window_index_from_numpy(key_hi, key_lo, sa, k: int, n: int,
                            first_len: int, W: int, win_start: int,
                            win_end: int, reverse: bool, complement: bool,
                            device: torch.device, relative: bool = False
                            ) -> DeviceWindowIndex:
    """The port's DeviceWindowIndex from a JAX DeviceWindowIndex's sorted
    key planes and suffix order, whose ``sa`` holds genome positions, or
    (``relative``) from a JAX BigWindowEngine's, whose ``sa`` holds window
    positions: the planes packed into the port's one int64 key, (hi << 31)
    | (lo << 1); ``sa`` in window positions, as the port's index keeps it
    (genome positions minus ``win_start``). The decimated probe codes are
    not carried: the port's engine reads the strand's codes."""
    key = (np.asarray(key_hi).astype(np.int64) << 31) \
        | (np.asarray(key_lo).astype(np.int64) << 1)
    sa = np.asarray(sa)
    if not relative:
        sa = sa - np.int32(win_start)
    return DeviceWindowIndex(
        key=torch.tensor(key, dtype=torch.int64, device=device),
        sa=torch.tensor(sa, dtype=torch.int32, device=device),
        k=k, n=n, first_len=first_len, W=W, win_start=int(win_start),
        win_end=int(win_end), reverse=reverse, complement=complement)


def relaid_decimated(tab_dec: np.ndarray, step: int, n: int) -> np.ndarray:
    """A JAX decimated, padded table (row r = the positions p = r mod step,
    its row length len(tab_dec) // step) in the port's decimated layout:
    the same rows cut to C = ceil(n / step) columns (position p at
    :func:`decimated_index`; the slots past the n positions hold the JAX
    padding's zeros)."""
    tab = np.asarray(tab_dec)
    C, _ = decimated_size(n, step)
    return tab.reshape(step, len(tab) // step)[:, :C].reshape(-1)


def table_index_from_numpy(sa, pos_lo, pos_hi, k: int, n: int,
                           first_len: int, reverse: bool, complement: bool,
                           device: torch.device) -> DeviceIndex:
    """The port's DeviceIndex from a JAX DeviceIndex's suffix order and
    decimated, padded tables: the tables re-laid at C = ceil(n / step)
    columns (:func:`relaid_decimated`), the N flag kept in pos_lo's sign
    bit."""
    step = k // 2

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    return DeviceIndex(sa=dev(sa), pos_lo=dev(relaid_decimated(pos_lo, step,
                                                               n)),
                       pos_hi=dev(relaid_decimated(pos_hi, step, n)), k=k,
                       n=n, first_len=first_len, reverse=reverse,
                       complement=complement)
