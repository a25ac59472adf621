"""spt_tpu_torch — the PyTorch / CUDA port of the spt_tpu path tracer.

A second package beside the JAX reference ``spt_tpu``, with the same module
layout.  It imports ``torch`` and ``numpy`` and never ``jax`` or ``spt_tpu``.
The ``Renderer`` renders small scenes and resident, instanced and
stream-tier mesh scenes with every integrator, through hand-written CUDA
kernels (``csrc/``, bound in ``ops/cuda_*``) on a CUDA device and their
plain PyTorch versions on the CPU.  Entry points: ``python -m
spt_tpu_torch.cli`` and ``python -m spt_tpu_torch.bench``.
"""

from spt_tpu_torch.config import GPU_PARITY, RenderConfig
from spt_tpu_torch.camera import Camera, default_camera

__all__ = ["RenderConfig", "GPU_PARITY", "Camera", "default_camera"]
