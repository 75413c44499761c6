"""asgart_tpu_torch — the PyTorch / CUDA port of asgart_tpu for one NVIDIA
Hopper GPU (H100).

The JAX package ``asgart_tpu`` is the reference: this package reproduces
its fused whole-genome engine (one device, k <= 20) byte-for-byte, with
hand-written CUDA kernels in ``csrc/`` for the device passes and the
shared host modules of ``asgart_tpu`` (FASTA parsing, native chaining,
post-processing, exporters) imported unchanged. It imports ``torch`` and
never ``jax``.

Every device-bearing function takes an explicit ``torch.device``
(:func:`asgart_tpu_torch.device.cuda_device` gives the GPU); the CPU is
used only when a caller passes it on purpose, and then each kernel
wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
