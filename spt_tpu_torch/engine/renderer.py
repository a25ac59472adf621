"""Progressive headless renderer — the render-loop state machine.

The counterpart of ``spt_tpu.engine.renderer`` (GLRenderer::renderLoop,
GLRenderer.cpp:111-188, minus the GL window): per frame it checks camera
movement and resets accumulation, renders cfg.spp samples (wavefront or
megakernel, ``toggle_integrator`` flips between them) into the
accumulation, and on demand resolves it to a display image (exposure ->
Reinhard -> gamma, device_programs.cu:854-899).

Every table and state tensor lives on the device given to the Renderer:
the card unless the caller asks for the CPU (``device="cpu"``, which runs
the kernels' plain PyTorch versions).
``render_frames(k)`` queues k frames; the masked path syncs with the host
only where the sorted mesh frame decides its condense, the compact and
regen paths once a bounce.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spt_tpu_torch.camera import Camera
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.engine import state as state_mod
from spt_tpu_torch.engine.image import write_png
from spt_tpu_torch.env import Environment, make_procedural_environment
from spt_tpu_torch.integrators.megakernel import render_megakernel
from spt_tpu_torch.integrators.wavefront import WavefrontStats, render_wavefront
from spt_tpu_torch.lights import DeviceLights, default_lights
from spt_tpu_torch.ops.tonemap import resolve
from spt_tpu_torch.scene.desc import SceneDesc
from spt_tpu_torch.scene.flatten import flatten_scene


def _frame_step(cfg, scene, env, lights, camera, rstate):
    """One progressive frame: cfg.spp samples folded into the accumulation.
    The megakernel (the reference's CPU-backend role) reports primaries
    only: per-bounce telemetry is a wavefront notion
    (spt_tpu/engine/renderer.py:46-58)."""
    if cfg.integrator == "megakernel":
        img = render_megakernel(cfg, scene, env, lights, camera,
                                frame_index=rstate.frame_index)
        device = img.device
        rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
        rays[0] = cfg.num_pixels
        stats = WavefrontStats(
            rays_per_bounce=rays,
            bounces_run=torch.tensor(cfg.max_depth, dtype=torch.int64,
                                     device=device))
    else:
        img, stats = render_wavefront(cfg, scene, env, lights, camera,
                                      frame_index=rstate.frame_index)
    new_state = state_mod.accumulate(rstate, img.reshape(-1, 3), float(cfg.spp))
    return new_state, stats


def render_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" is the current
    card, "cuda:0" on one card, as the tensors made on it report it); raises
    when it is the card and there is none (there is no CPU fallback: the
    caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("Renderer: no CUDA device (pass device='cpu' "
                               "to run the plain PyTorch versions)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for o in obj:
            yield from _tensors(o)


class Renderer:
    """Progressive renderer over one scene on one device."""

    def __init__(
        self,
        desc: SceneDesc,
        cfg: Optional[RenderConfig] = None,
        env: Optional[Environment] = None,
        lights: Optional[DeviceLights] = None,
        camera: Optional[Camera] = None,
        multi_device: Optional[bool] = None,
        *,
        device="cuda",
    ):
        self.cfg = cfg or RenderConfig()
        if multi_device:
            raise NotImplementedError(
                "multi_device=True (pixel-band sharding) is not ported yet")
        self.device = render_device(device)
        self.scene = flatten_scene(desc, self.device)
        self.env = (env if env is not None
                    else make_procedural_environment(self.device))
        self.lights = (lights if lights is not None
                       else default_lights(self.device))
        for name, obj in (("env", self.env), ("lights", self.lights)):
            for t in _tensors(obj):
                if t.device != self.device:
                    raise ValueError(f"{name} lies on {t.device}, the "
                                     f"renderer on {self.device}")
        self.camera = camera or Camera(aspect_ratio=self.cfg.width / self.cfg.height)
        self.state = state_mod.init_state(self.cfg.num_pixels, self.device)
        self.last_stats = None
        self._wavefront_integrator = (
            "masked" if self.cfg.integrator == "megakernel"
            else self.cfg.integrator)

    def toggle_integrator(self) -> str:
        """Flip wavefront <-> megakernel and reset accumulation, the
        reference's 'G' backend toggle (GLRenderer.cpp:263-277): switching
        backends resets accumulation so images stay comparable.  The second
        toggle restores the wavefront integrator the renderer started with.
        Returns the new integrator name."""
        if self.cfg.integrator != "megakernel":
            self._wavefront_integrator = self.cfg.integrator
            new = "megakernel"
        else:
            new = self._wavefront_integrator
        self.cfg = self.cfg.replace(integrator=new)
        self.state = state_mod.reset(self.state)
        return new

    def resize(self, width: int, height: int) -> None:
        """Change the render resolution in place: reset accumulation, keep
        scene/camera/lights; the camera adopts the new aspect ratio
        (OptixBackend::resize, OptixBackend.cpp:1508-1543)."""
        if (width, height) == (self.cfg.width, self.cfg.height):
            return
        self.cfg = self.cfg.replace(width=width, height=height)
        self.camera.set_aspect_ratio(width / height)
        self.state = state_mod.init_state(self.cfg.num_pixels, self.device)
        self.last_stats = None

    # --- frame loop -----------------------------------------------------------

    def render_frame(self, check_camera: bool = True) -> None:
        """Advance the progressive render by one frame (cfg.spp samples)."""
        self.render_frames(1, check_camera=check_camera)

    def render_frames(self, k: int, check_camera: bool = False) -> None:
        """Advance by `k` frames with a static camera; summed stats land in
        last_stats.  Nothing in the loop waits for the device."""
        if check_camera and self.camera.has_moved_since_last_check():
            self.state = state_mod.reset(self.state)
        rays = self.camera.rays(self.device)
        st = self.state
        total = torch.zeros(self.cfg.max_depth, dtype=torch.int64,
                            device=self.device)
        bounces = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(max(k, 1)):
            st, stats = _frame_step(self.cfg, self.scene, self.env,
                                    self.lights, rays, st)
            total = total + stats.rays_per_bounce
            bounces = torch.maximum(bounces, stats.bounces_run)
        self.state = st
        self.last_stats = WavefrontStats(rays_per_bounce=total,
                                         bounces_run=bounces)

    def render(self, frames: int = 1) -> np.ndarray:
        """Run `frames` progressive frames and return the resolved image."""
        for _ in range(frames):
            self.render_frame()
        return self.image()

    # --- outputs ----------------------------------------------------------------

    @property
    def accumulated_samples(self) -> float:
        return float(self.state.sample_count)

    def image(self) -> np.ndarray:
        """Resolved display image, (H, W, 3) float in [0, 1]."""
        img = resolve(self.state.accum, self.state.sample_count,
                      exposure=self.cfg.exposure, gamma=self.cfg.gamma,
                      tonemap=self.cfg.tonemap)
        return img.reshape(self.cfg.height, self.cfg.width, 3).cpu().numpy()

    def hdr_image(self) -> np.ndarray:
        """Linear HDR mean radiance, (H, W, 3) float32."""
        cnt = max(self.accumulated_samples, 1e-30)
        return self.state.accum.cpu().numpy().reshape(
            self.cfg.height, self.cfg.width, 3) / cnt

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    # --- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        state_mod.save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        st = state_mod.load_checkpoint(path, self.device)
        if st.num_pixels != self.cfg.num_pixels:
            raise ValueError(f"checkpoint holds {st.num_pixels} pixels, the "
                             f"renderer {self.cfg.num_pixels}")
        self.state = st
