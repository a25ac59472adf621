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

# The package root's user-facing API, imported on first use so that
# `import spt_tpu_torch` stays light (spt_tpu/__init__.py:31-53).
_LAZY = {
    "SceneDesc": "spt_tpu_torch.scene",
    "Material": "spt_tpu_torch.scene",
    "build_default_scene": "spt_tpu_torch.scene",
    "build_test_triangle_scene": "spt_tpu_torch.scene",
    "build_cornell_box_scene": "spt_tpu_torch.scene",
    "flatten_scene": "spt_tpu_torch.scene",
    "Renderer": "spt_tpu_torch.engine",
    "LightManager": "spt_tpu_torch.lights",
    "load_environment": "spt_tpu_torch.env",
    "load_gltf": "spt_tpu_torch.io.gltf",
    "render_wavefront": "spt_tpu_torch.integrators",
    "render_megakernel": "spt_tpu_torch.integrators",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'spt_tpu_torch' has no attribute {name!r}")


__all__ = ["RenderConfig", "GPU_PARITY", "Camera", "default_camera",
           *_LAZY]
