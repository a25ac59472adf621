"""Inverse rendering on the PyTorch port: recover material albedos from a
target image.

The counterpart of ``examples/inverse_albedo.py``: the megakernel
integrator is plain PyTorch over the shading, so a render is a
differentiable function of the material tables.  The loop renders a target
with the true albedos, resets every material to flat gray, and recovers
the originals by Adam on the image MSE through the gradient of the
renderer itself.  The gradient step is ``megakernel.GradStep``, the
counterpart of ``jax.jit(jax.grad(loss_fn))``: on the card the forward
pass and its backward are one captured CUDA graph, replayed once a step.
Adam runs outside it, as optax runs outside ``jit`` in the JAX example.

Run: python3 examples/inverse_albedo_torch.py     (on a CUDA card)
In Python, ``main(device="cpu")`` runs it on the CPU (about 10-20 s: the
kernels' plain versions).
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spt_tpu_torch.camera import default_camera  # noqa: E402
from spt_tpu_torch.config import RenderConfig  # noqa: E402
from spt_tpu_torch.engine.renderer import render_device  # noqa: E402
from spt_tpu_torch.env import make_procedural_environment  # noqa: E402
from spt_tpu_torch.integrators import megakernel  # noqa: E402
from spt_tpu_torch.lights import default_lights  # noqa: E402
from spt_tpu_torch.scene import build_default_scene, flatten_scene  # noqa: E402


def example_inputs(device, cfg=None):
    """(cfg, scene, env, lights, camera rays) of the JAX example: the default
    scene at 64x32, spp 1, depth 3 unless `cfg` says otherwise."""
    cfg = cfg or RenderConfig(width=64, height=32, spp=1, max_depth=3)
    return (cfg, flatten_scene(build_default_scene(), device),
            make_procedural_environment(device), default_lights(device),
            default_camera(cfg.width, cfg.height).rays(device))


def albedo_loss(cfg, scene, env, lights, cam):
    """(loss_fn, true_bc): ``loss_fn(bc)`` is the image MSE of a render with
    the base colors `bc` against the target rendered with the scene's own
    (``true_bc``, a copy)."""
    def render(base_color):
        s = scene._replace(
            materials=scene.materials._replace(base_color=base_color))
        # fixed sample index -> fixed RNG: the target and the optimized
        # render see identical path noise, so the albedo is the only unknown
        return megakernel.render_sample(cfg, s, env, lights, cam, 0)

    true_bc = scene.materials.base_color.detach().clone()
    with torch.no_grad():
        target = render(true_bc)

    def loss_fn(bc):
        return torch.mean((render(bc) - target) ** 2)

    return loss_fn, true_bc


class Trained(NamedTuple):
    err: float              # max |albedo error| over the visible materials
    seen: np.ndarray        # (materials,) bool: the gradient reached it
    step: megakernel.GradStep
    losses: torch.Tensor    # (steps,) the loss each step's gradient saw


def train(loss_fn, true_bc, steps: int = 150, lr: float = 0.05,
          log=print) -> Trained:
    """Adam on the base colors from 0.5 gray, clipped to [0, 1] after each
    update, printing the image MSE every 25 steps and at the last, then the
    recovery on the visible materials (examples/inverse_albedo.py:53-70)."""
    step = megakernel.GradStep(loss_fn, torch.full_like(true_bc, 0.5))
    bc = step.param
    opt = torch.optim.Adam([bc], lr=lr)
    losses, g0 = [], None
    for i in range(steps):
        loss, bc.grad = step()
        if g0 is None:
            # the gradient at the 0.5 start, which the report reads
            g0 = bc.grad.abs()
        losses.append(loss.clone())
        opt.step()
        with torch.no_grad():
            bc.clamp_(0.0, 1.0)
        if i % 25 == 0 or i == steps - 1:
            with torch.no_grad():
                log(f"step {i:4d}  image MSE {float(loss_fn(bc)):.3e}")

    # report recovery on the materials that are actually visible (gradient
    # reached them); hidden materials can't be recovered from one view
    seen = (g0.max(dim=1).values > 1e-6).cpu().numpy()
    err = float((bc.detach() - true_bc).abs().cpu().numpy()[seen].max())
    log(f"visible materials: {int(seen.sum())}/{len(seen)}, "
        f"max albedo error after {steps} steps: {err:.3f}")
    return Trained(err, seen, step, torch.stack(losses))


def main(steps: int = 150, lr: float = 0.05, device="cuda") -> float:
    """The JAX example's run on `device` (the card unless the caller asks
    for the CPU); returns the max albedo error on the visible materials.
    ``train(*albedo_loss(*example_inputs(device, cfg)))`` runs it at
    another size, and on another scene with that scene's inputs."""
    inputs = example_inputs(render_device(device))
    return train(*albedo_loss(*inputs), steps=steps, lr=lr).err


if __name__ == "__main__":
    main()
