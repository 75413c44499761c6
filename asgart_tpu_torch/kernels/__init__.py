"""The port's hand-written CUDA kernels, each behind a wrapper that keeps
a plain-integer launch counter (``<wrapper>.launches``) and runs its plain
PyTorch version only for tensors on the CPU."""

from .chain import chain_bursts
from .codes import unpack_codes
from .group_bounds import group_bounds
from .invert import invert_fused
from .merge_join import mj_directory, mj_ranges
from .pack_keys import pack_keys
from .scan_core import scan_core
from .seed import equal_range, gather_ranges, pack_probe_planes
from .sharded import gather_owned
from .slices import gather_flat, granule_totals
from .tables import invert_tables, table_ranges
from .ties import full_round_keys, full_round_refine, tie_keys, tie_refine

KERNELS = (unpack_codes, pack_keys, group_bounds, invert_fused, tie_keys,
           tie_refine, mj_ranges, scan_core, invert_tables,
           table_ranges, full_round_keys, full_round_refine, chain_bursts,
           granule_totals, gather_flat, equal_range, gather_ranges,
           pack_probe_planes, gather_owned, mj_directory)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in KERNELS}


def reset_launch_counts() -> None:
    for f in KERNELS:
        f.launches = 0
