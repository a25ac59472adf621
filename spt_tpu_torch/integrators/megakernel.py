"""Megakernel integrator: the whole path per pixel batch, bounce after bounce.

The counterpart of ``spt_tpu.integrators.megakernel`` (the reference's CPU
recursive tracer, PathTracer.cpp:113-224, restated iteratively in
wf_pt_cpu.cpp:94-248): every bounce traces and shades the full pixel batch
through ``transport.trace_bounce`` and ``transport.shade``, dead lanes
masked.

This is the differentiable path: it is plain PyTorch over the shading, so
``torch.autograd`` reaches the material tables (set ``requires_grad`` on
``scene.materials.base_color``, ``roughness`` or ``metallic``, which
``flatten_scene`` makes as leaves).  On a mesh scene on the card the hits
come from the CUDA tracers (``ops/cuda_trace``), whose outputs carry no
gradient, as in the JAX package: a hit's t, ids, normal and uv are
constants of the graph, and the gradient reaches the materials through
shading only.  An HDR environment on the card goes through the equirect
sampler (``ops/cuda_env``), which passes no gradient to the miss direction
either; the procedural sky is plain PyTorch and does.

``GradStep`` is the counterpart of ``jax.jit(jax.grad(loss_fn))``: on the
card the forward pass and its backward are captured once and each
gradient is one graph launch (``examples/inverse_albedo_torch.py`` trains
on it).
"""

from __future__ import annotations

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment
from spt_tpu_torch.integrators import transport, wavefront
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.scene.flatten import DeviceScene


def render_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
) -> torch.Tensor:
    """One sample per pixel -> (N, 3) linear radiance."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index)
    for bounce in range(cfg.max_depth):
        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(cfg, scene, env, lights, ps, hit, bounce=bounce,
                             is_last=bounce == cfg.max_depth - 1)
    return ps.radiance.to_array()


def render_megakernel(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
) -> torch.Tensor:
    """cfg.spp samples averaged -> (H, W, 3) linear radiance (the spp loop
    of PathTracer::traceRay, PathTracer.cpp:280-303, minus its per-sample
    tonemap; resolve happens once downstream)."""
    acc = None
    for s in range(cfg.spp):
        rad = render_sample(cfg, scene, env, lights, camera, frame_index, s)
        acc = rad if acc is None else acc + rad
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)


class GradStep:
    """``fn(param)`` and its gradient as one device program: the port's
    ``jax.jit(jax.value_and_grad(fn))`` over one parameter.

    The parameter is a leaf the step owns (``param``, a copy of `init`
    that requires grad): the graph reads one address, so where JAX rebinds
    the array an optimizer updates this one in place.  Each call returns
    ``(loss, grad)``, the step's own 0-dim and ``param``-shaped buffers,
    overwritten by the next call.

    On the card the first call runs the body once eagerly on a side stream
    (the warm-up ``torch.cuda.graphs`` asks for before a capture of a
    backward pass: it builds the kernels and makes autograd's buffers),
    then captures it, forward and backward, as a
    ``wavefront.SegmentedGraph``; every call, the first too, is one replay
    of that graph.  A capture that fails raises: nothing runs the body
    eagerly in its place.  On the CPU a call runs the body eagerly.  The
    wrappers' launch counts tick for the warm-up as it launches and for
    each replay by what the capture counted."""

    def __init__(self, fn, init: torch.Tensor):
        self.fn = fn
        self.param = init.detach().clone().requires_grad_(True)
        self.loss = torch.zeros((), dtype=init.dtype, device=init.device)
        self.grad = torch.zeros_like(self.param, requires_grad=False)
        self.graph = None

    def body(self):
        """``fn(param)`` and its gradient into the step's buffers, eagerly:
        what the graph captures, and the reference it is held against."""
        with torch.enable_grad():
            loss = self.fn(self.param)
            (grad,) = torch.autograd.grad(loss, self.param)
        self.loss.copy_(loss.detach())
        self.grad.copy_(grad)
        return self.loss, self.grad

    def _capture(self) -> None:
        device = self.param.device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body()
        current.wait_stream(side)
        graph = wavefront.SegmentedGraph(device)
        with graph.capture():
            self.body()
        self.graph = graph

    def __call__(self):
        if self.param.device.type != "cuda":
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.loss, self.grad
