"""spt_tpu_torch — the PyTorch / CUDA port of the spt_tpu path tracer.

A second package beside the JAX reference ``spt_tpu``, with the same module
layout.  It imports ``torch`` and ``numpy`` and never ``jax`` or ``spt_tpu``.
This slice covers the small-scene wavefront path: the ``Renderer`` renders
the default, Cornell and HDR-glass scenes, with the whole depth loop in one
hand-written CUDA kernel (``ops/cuda_bounce`` + ``csrc/fused_frame.cu``) on
a CUDA device and in plain PyTorch on the CPU.
"""

from spt_tpu_torch.config import GPU_PARITY, RenderConfig
from spt_tpu_torch.camera import Camera, default_camera

__all__ = ["RenderConfig", "GPU_PARITY", "Camera", "default_camera"]
