"""The strand's symbol codes on the device.

Counterpart of ``DeviceIndex.upload_codes`` (asgart_tpu/device_index.py:1124)
without its 2-bit packing: the packed upload and its on-device unpack
existed for a slow host link, while a PCIe copy of 1 B/bp from pinned
memory is a small share of the build.
"""

from __future__ import annotations

import numpy as np
import torch

from .index import CODE


def upload_codes(strand_data: np.ndarray, device: torch.device
                 ) -> torch.Tensor:
    """uint8 symbol ranks ``CODE[strand]`` ($=0, A=1, C=2, G=3, N=4, T=5)
    on ``device``; the host copy is pinned so the transfer is one DMA."""
    host = torch.from_numpy(CODE[strand_data])
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
