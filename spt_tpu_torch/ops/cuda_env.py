"""The equirect environment sampler for Hopper (K2).

``env_sample`` is the HDR branch of ``env.environment_color_v``: the
bilinear equirect lookup of each lane's (normalized) direction, clamped
and scaled by the environment's intensity.  It is the counterpart of
``spt_tpu.ops.pallas_env.sample_equirect_pallas`` (:192, pallas_call :218)
and of its sorted variant (:262), which computes the same function in
another lane order, together with the tap setup and the clamp x intensity
that their caller applies (spt_tpu/env.py:395-442).

- On a CUDA tensor it launches ``csrc/env_sample.cu`` on the environment's
  map, which must be held in the texel layout (``env.equirect_texels``, the
  layout every environment is made in), or raises: lanes in `need` (all
  when None) get the term, the others 0, and load nothing.
- On a CPU tensor it runs the plain version, ``env_sample_reference``
  (``env.sample_equirect_v``, clamp and scale), on every lane (the caller
  masks the lanes it does not need).

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.env import Environment, has_texel_layout, sample_equirect_v
from spt_tpu_torch.ops import cuda_lib
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.ops.vec3 import Vec3

LAUNCHES = 0


def env_sample_reference(env: Environment, direction: Vec3,
                         need=None) -> Vec3:
    """The plain version, on every lane (`need` unused)."""
    tex = sample_equirect_v(env.image, v3.safe_normalize(direction))
    return Vec3(*(torch.clamp(c, max=env.max_clamp) * env.intensity
                  for c in tex))


def env_sample(env: Environment, direction: Vec3, need=None) -> Vec3:
    """clamp(bilinear equirect sample, max_clamp) * intensity per lane."""
    global LAUNCHES
    device = direction.x.device
    if device.type == "cpu":
        return env_sample_reference(env, direction, need)
    if device.type != "cuda":
        raise ValueError(f"env_sample runs on CUDA or CPU tensors, not {device}")
    n = direction.x.shape[0]
    for c in direction:
        if c.device != device or c.dtype != torch.float32 or c.shape != (n,):
            raise ValueError(f"direction planes must be float32 ({n},) "
                             f"tensors on {device}")
    direction = Vec3(*(c.contiguous() for c in direction))
    image = env.image
    if (image.device != device or image.dtype != torch.float32
            or image.dim() != 3 or image.shape[2] != 3):
        raise ValueError(f"the environment map must be an (H, W, 3) float32 "
                         f"tensor on {device}")
    if not has_texel_layout(image):
        raise ValueError("the environment map must be held in the texel "
                         "layout (env.equirect_texels; make_hdr_environment "
                         "holds it so)")
    h, w = image.shape[0], image.shape[1]
    if need is not None:
        need = torch.broadcast_to(need.to(device=device, dtype=torch.bool),
                                  (n,)).contiguous()
    out = [torch.empty(n, dtype=torch.float32, device=device)
           for _ in range(3)]
    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_env_sample(
            *(c.data_ptr() for c in direction),
            None if need is None else need.data_ptr(), image.data_ptr(),
            h, w, env.max_clamp, env.intensity,
            *(t.data_ptr() for t in out), n, cuda_lib.stream_of(device))
    cuda_lib.check(err, "env_sample")
    LAUNCHES += 1
    return Vec3(*out)
