"""State carried across from the JAX package: its device indexes.

The system has no weights; its state is the device index. These helpers
take the arrays of a JAX ``FusedIndex`` (asgart_tpu/device_index.py:1580)
or ``DeviceWindowIndex`` (:1342), read out with ``np.asarray``, and give
the port's counterparts, so the port's engines can run on an index the
JAX package built.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_index import FusedIndex
from .window_index import DeviceWindowIndex


def rank_from_decimated(rank_dec: np.ndarray, step: int, W: int
                        ) -> np.ndarray:
    """Plain-layout rank [W] from the JAX decimated rank (position p sits
    at (p % step) * C + p // step, C = len(rank_dec) // step)."""
    C = len(rank_dec) // step
    p = np.arange(W)
    return np.asarray(rank_dec)[(p % step) * C + p // step]


def fused_index_from_numpy(sa, lane_lo, lane_hi, lane_mask, specs, offs,
                           k: int, n: int, first_len: int, reverse: bool,
                           complement: bool, device: torch.device,
                           trim: tuple | None = None) -> FusedIndex:
    """The port's FusedIndex from a JAX FusedIndex's arrays and fields
    (its float raw totals become ints; ``trim`` is a window build's
    (ws, we))."""
    def dev(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

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
                            device: torch.device) -> DeviceWindowIndex:
    """The port's DeviceWindowIndex from a JAX DeviceWindowIndex's sorted
    key planes and suffix order: the planes packed into the port's one
    int64 key, (hi << 31) | (lo << 1); ``sa`` copied (its decimated probe
    codes are not carried: the port's engine reads the strand's codes)."""
    key = (np.asarray(key_hi).astype(np.int64) << 31) \
        | (np.asarray(key_lo).astype(np.int64) << 1)
    return DeviceWindowIndex(
        key=torch.tensor(key, dtype=torch.int64, device=device),
        sa=torch.tensor(np.asarray(sa), dtype=torch.int32, device=device),
        k=k, n=n, first_len=first_len, W=W, win_start=int(win_start),
        win_end=int(win_end), reverse=reverse, complement=complement)
