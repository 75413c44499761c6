"""Device selection: the GPU, named explicitly, or an error."""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """``torch.device("cuda", index)``; raises when CUDA is absent.

    There is no CPU default: a caller that wants the plain PyTorch
    versions of the kernels passes ``torch.device("cpu")`` itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the asgart_tpu_torch device engine "
            "needs an NVIDIA GPU (pass torch.device('cpu') explicitly to "
            "run the plain PyTorch versions, or use engine='host')")
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index} "
                           f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)
