"""The table index on one device: per-position equal ranges over the whole
(doubled) text.

Counterpart of ``DeviceIndex`` (asgart_tpu/device_index.py:1109-1258),
the index of the JAX package's table engine (``DeviceEngine``,
asgart_tpu/device_engine.py:1180), which its ``--checkpoint`` runs take:
the index does not depend on the chunk set, so the chunks can be scanned
one at a time. Its fit, the counterpart of ``device_index_fits`` (:127),
is ``fused_index.table_fits``, beside the other builds' fits. Build steps
and their kernels:

  upload codes (KI) -> KA pack_keys (doubled mode for R/C runs: the
  genome, its '$', then T(genome)) -> sort_keys (torch.sort)
  -> KB group_bounds (the N-probe flag; run ends of a direct-only text)
  -> KJ invert_tables -> ties.resolve_ties (KK, KL full rounds while more
  than ``tied_cap`` rows are tied; then KE, KF)

Every position of the text (n = 2 n1 - 1 rows for R/C runs, else n1) has
a row. For R/C runs the appended half's rows carry the flag bit, so each
k-mer group lists its direct positions first; pos_lo/pos_hi of an
appended position is then the window of its group's direct positions,
which is all a probe reads (its table position lies in the appended
half), and only direct rows are tied. Without an appended half, pos_hi is
the group's end. pos_lo's sign bit marks positions whose k-mer starts
with N. As in the JAX package, pos_lo and pos_hi are decimated by step =
k // 2: position x at (x % step) * C + x // step, C = ceil(n / step) (no
TPU padding; the step * C - n slots past the text hold 0), so that the
probes of a chunk, x = x0 + j * step, are one contiguous run of each
plane (KM ``table_ranges``). The rank seed keeps position order (the tie
rounds read it so) and is dropped after the build.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .codes import upload_codes
from .fused_index import probe_span, sort_keys
from .kernels import group_bounds, invert_tables, pack_keys
from .kernels.pack_keys import MAX_K
from .kernels.tables import decimated_index, decimated_size
from .ties import resolve_ties


@dataclass
class DeviceIndex:
    """Device-resident table index of the whole (doubled) text."""

    sa: torch.Tensor      # int32 [n] suffix order of the text
    pos_lo: torch.Tensor  # int32 [step * C] per-position range start (N
    #                       flag in the sign bit), decimated
    pos_hi: torch.Tensor  # int32 [step * C] per-position range end,
    #                       decimated
    k: int
    n: int                # text length (2 n1 - 1 for R/C runs)
    first_len: int        # genome + '$' length
    reverse: bool
    complement: bool

    @property
    def step(self) -> int:
        """k // 2: the decimation of pos_lo and pos_hi."""
        return self.k // 2

    @property
    def C(self) -> int:
        """ceil(n / step): the columns of pos_lo and pos_hi."""
        return decimated_size(self.n, self.step)[0]

    def nbytes(self) -> int:
        return 12 * self.n

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, reverse: bool,
              complement: bool, device: torch.device,
              tied_cap: int | None = None) -> "DeviceIndex":
        """The index of the strand (genome + '$') and, for R/C runs, its
        appended half. ``tied_cap``: the tied count above which full
        rounds run (default ``max(1024, n // 8)``, as the JAX build's)."""
        if not 2 <= k <= MAX_K:
            raise ValueError(f"table index supports probe_size 2..{MAX_K}")
        n1 = int(len(strand_data))
        doubled = reverse or complement
        n = probe_span(n1, doubled)
        if n >= (1 << 31):
            raise ValueError("table index too large for int32 positions")
        if tied_cap is None:
            tied_cap = max(1024, n // 8)
        codes = upload_codes(strand_data, device)
        keys, _ = pack_keys(codes, (), k, reverse, complement, n, 0,
                            doubled=doubled)
        del codes
        skeys, sa = sort_keys(keys)
        run_lo, run_hi, tied = group_bounds(skeys, sa, n1, flag_n_k=k,
                                            run_end=not doubled)
        del skeys
        pos_lo, pos_hi, rank = invert_tables(sa, run_lo, run_hi, k // 2)
        del run_lo, run_hi
        sa = resolve_ties(sa, rank, tied, n, k, tied_cap=tied_cap,
                          direct_bound=n1)
        return cls(sa=sa, pos_lo=pos_lo, pos_hi=pos_hi, k=k, n=n,
                   first_len=n1, reverse=reverse, complement=complement)

    def to_host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(sa, ranges [n, 2]) as numpy in position order, the N flag
        stripped: the JAX ``DeviceIndex.to_host_arrays``
        (device_index.py:1247)."""
        at = decimated_index(np.arange(self.n), self.step, self.C)
        lo, hi = (t.cpu().numpy()[at] for t in (self.pos_lo, self.pos_hi))
        return self.sa.cpu().numpy(), np.stack([lo & 0x7FFFFFFF, hi], axis=1)
