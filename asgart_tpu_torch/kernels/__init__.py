"""The port's hand-written CUDA kernels, each behind a wrapper that keeps
a plain-integer launch counter (``<wrapper>.launches``) and runs its plain
PyTorch version only for tensors on the CPU."""

from .group_bounds import group_bounds
from .invert import invert_fused
from .merge_join import mj_ranges
from .pack_keys import pack_keys
from .scan_core import scan_core
from .ties import tie_keys, tie_refine
from .window import offset_slots

KERNELS = (pack_keys, group_bounds, invert_fused, tie_keys, tie_refine,
           offset_slots, mj_ranges, scan_core)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in KERNELS}


def reset_launch_counts() -> None:
    for f in KERNELS:
        f.launches = 0
