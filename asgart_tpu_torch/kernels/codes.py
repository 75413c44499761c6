"""KI ``unpack_codes``: the strand's symbol codes from its 2-bit packing.

Kernel: ``csrc/codes.cu`` (see its header for the layout, what it replaces
in the JAX package and how it is bounded). ``unpack_codes_plain`` is the
same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import _build


def unpack_codes(packed: torch.Tensor, exc_pos: torch.Tensor,
                 exc_code: torch.Tensor, n1: int) -> torch.Tensor:
    """uint8 symbol ranks [n1] of a strand packed by
    :func:`asgart_tpu_torch.codes.pack_codes`: ``packed`` (uint8 [n4], n4
    = ceil(n1 / 4); byte j holds positions j, n4 + j, 2·n4 + j and 3·n4 +
    j, two bits each, A, C, G, T = 0..3) and the exceptions, unique
    positions ``exc_pos`` (int64) with their codes ``exc_code`` (uint8)."""
    n4 = -(-n1 // 4)
    for t, dt in ((packed, torch.uint8), (exc_pos, torch.int64),
                  (exc_code, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("unpack_codes: bad dtype or layout")
    if packed.numel() != n4 or exc_pos.numel() != exc_code.numel():
        raise ValueError(f"unpack_codes: {packed.numel()} packed bytes and "
                         f"{exc_pos.numel()} / {exc_code.numel()} exception "
                         f"entries for n1={n1}")
    if not _build.on_cuda(packed, exc_pos, exc_code):
        return unpack_codes_plain(packed, exc_pos, exc_code, n1)
    codes = torch.empty(n1, dtype=torch.uint8, device=packed.device)
    if n1 == 0:
        return codes
    lib = _build.lib()
    unpack_codes.launches += 1
    _build.check(lib.asgart_unpack_codes(
        packed.data_ptr(), n4, n1, exc_pos.data_ptr(), exc_code.data_ptr(),
        exc_pos.numel(), codes.data_ptr(), _build.stream_of(packed)),
        "unpack_codes")
    return codes


unpack_codes.launches = 0


def unpack_codes_plain(packed, exc_pos, exc_code, n1) -> torch.Tensor:
    """Plain PyTorch version of the KI kernel: shift and mask into the four
    quarters, the LUT [1, 2, 3, 5] as arithmetic (v + 1, + 1 more for T,
    so no int64 index tensor of n1 entries), then ``index_put_`` of the
    exceptions."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    two = ((packed[None, :] >> shifts[:, None]) & 3).reshape(-1)[:n1]
    codes = two + 1 + (two == 3).to(torch.uint8)
    return codes.index_put_((exc_pos,), exc_code)
