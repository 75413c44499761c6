"""asgart_tpu_torch — the PyTorch / CUDA port of asgart_tpu for one NVIDIA
Hopper GPU (H100).

The JAX package ``asgart_tpu`` is the reference: this package reproduces
its fused engine on one device (the whole genome, a ``--trim`` window or
``--shards`` windows; k = 2..30) byte-for-byte, with hand-written CUDA
kernels in ``csrc/`` for the device passes. It imports ``torch`` and
nothing of ``jax`` or ``asgart_tpu``: the host modules it needs (FASTA
parsing, native chaining and its C++ source, post-processing, exporters,
the host engine) are copies of the JAX package's, pinned against their
originals by tests/test_torch_host_copies.py.

Every device-bearing function takes an explicit ``torch.device``
(:func:`asgart_tpu_torch.device.cuda_device` gives the GPU); the CPU is
used only when a caller passes it on purpose, and then each kernel
wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
