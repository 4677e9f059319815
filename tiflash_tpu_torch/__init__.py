"""tiflash-tpu-torch: the PyTorch / CUDA port of ``tiflash_tpu``.

A second package beside the JAX reference, written for one NVIDIA H100.
Plain tensor code is PyTorch, running eagerly; the reference's Pallas
kernels become hand-written CUDA kernels for Hopper (``csrc/``).  Module
paths mirror the reference's, so ``tiflash_tpu/ops/stream_fuse.py`` has
its counterpart at ``tiflash_tpu_torch/ops/stream_fuse.py``.

The package imports torch and never jax.  There is no global device:
every tensor is created on a device its caller names.
"""

__version__ = "0.1.0"
