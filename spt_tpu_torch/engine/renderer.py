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

``render_frames(k)`` on the card replays a captured frame k times
(``_captured_step_dyn``, the counterpart of the JAX package's
``_jitted_step_dyn``), with every integrator (masked, compact, regen, the
megakernel): one CUDA graph launch a frame, whose conditionals (the sorted
mesh frame's condense decision, the compact path's chunk loops, the regen
loop) the device decides, so nothing in the loop waits for the device.  On
the CPU it runs ``frame_chain``, the eager loop, which is also the
reference the graph is held against.

Under an initialized process group of several ranks (``torchrun``), the
Renderer shards the image into row bands, one a rank
(``parallel/sharding``), as the JAX Renderer shards over a device mesh,
the bands sized by a probe of the frame's work at construction
(``cfg.band_edges``; ``resize`` probes again): each rank renders its band
on its own device, the stats are summed over
the ranks once per ``render_frames`` call, and ``image()``,
``hdr_image()`` and ``save_checkpoint`` gather the bands (every rank must
call them); only rank 0 writes a file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spt_tpu_torch.camera import Camera, CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.engine import state as state_mod
from spt_tpu_torch.engine.image import write_png
from spt_tpu_torch.env import Environment, make_procedural_environment
from spt_tpu_torch.integrators import wavefront
from spt_tpu_torch.integrators.megakernel import render_megakernel
from spt_tpu_torch.integrators.wavefront import WavefrontStats, render_wavefront
from spt_tpu_torch.lights import DeviceLights, default_lights
from spt_tpu_torch.ops import cuda_bounce
from spt_tpu_torch.ops.tonemap import resolve
from spt_tpu_torch.scene.desc import SceneDesc
from spt_tpu_torch.scene.flatten import flatten_scene
from spt_tpu_torch.utils import timing


def _frame_image(cfg, scene, env, lights, camera, frame_index, row0=0,
                 rows=None):
    """One progressive frame's mean radiance of the band of `rows` rows from
    `row0` (the whole image by default) and its stats.  The megakernel (the
    reference's CPU-backend role) renders whole frames only and reports
    primaries only: per-bounce telemetry is a wavefront notion
    (spt_tpu/engine/renderer.py:46-58)."""
    if cfg.integrator == "megakernel":
        img = render_megakernel(cfg, scene, env, lights, camera,
                                frame_index=frame_index)
        device = img.device
        rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
        rays[0].fill_(cfg.num_pixels)
        return img, WavefrontStats(
            rays_per_bounce=rays,
            bounces_run=torch.full((), cfg.max_depth, dtype=torch.int64,
                                   device=device))
    return render_wavefront(cfg, scene, env, lights, camera,
                            frame_index=frame_index, row0=row0, rows=rows)


def _frame_step(cfg, scene, env, lights, camera, rstate, row0=0, rows=None):
    """One progressive frame of the band: cfg.spp samples folded into the
    accumulation."""
    img, stats = _frame_image(cfg, scene, env, lights, camera,
                              rstate.frame_index, row0, rows)
    new_state = state_mod.accumulate(rstate, img.reshape(-1, 3), float(cfg.spp))
    return new_state, stats


def frame_chain(cfg, scene, env, lights, camera, rstate, k: int, row0=0,
                rows=None):
    """`k` progressive frames (at least one) of the band of `rows` rows from
    `row0` -> (state, stats summed over the frames), eagerly: the CPU path
    and the reference the captured step is held against.  Nothing in the
    loop talks to another process."""
    device = rstate.accum.device
    total = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    bounces = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(max(k, 1)):
        rstate, stats = _frame_step(cfg, scene, env, lights, camera, rstate,
                                    row0, rows)
        total = total + stats.rays_per_bounce
        bounces = torch.maximum(bounces, stats.bounces_run)
    return rstate, WavefrontStats(rays_per_bounce=total, bounces_run=bounces)


def captures(cfg: RenderConfig, device) -> bool:
    """Whether frames of `cfg` on `device` run as a captured graph: every
    integrator on the card."""
    return torch.device(device).type == "cuda"


class StaticStep:
    """One progressive frame of the band of `rows` rows from `row0` on fixed
    buffers: the camera rays, the band's RenderState and the stats summed
    over a call.  ``frame()`` is the body ``_captured_step_dyn`` captures;
    it also runs eagerly, which is how the CPU tests hold it against
    ``frame_chain``.

    The state is updated in place (``state.accumulate_``) so that every
    replay of the graph reads and writes the same tensors: the JAX
    package's arrays are immutable and ``_jitted_step_dyn`` does not donate
    them.  A state handed to ``load`` that is not this step's own (after a
    reset, a checkpoint load, or set from outside) is copied in.  A frame
    runs without autograd: the megakernel's gradients are taken through
    its own functions (``integrators/megakernel``), whose ``GradStep``
    captures a gradient step as a graph of its own.

    On the card, where ``wavefront._whole_frame_ok`` holds for the step's
    inputs (``whole``: the masked frame at spp 1 of a small scene under the
    procedural sky), a frame is one launch of ``cuda_bounce.whole_frame``
    from lane index to accumulation, which reads the camera buffer and the
    frame index on the device, on tables packed here once (``tables``);
    the stats and the state's two counters follow it.  Every other frame,
    and every frame on the CPU, is the split frame, ``_frame_image`` and
    ``state.accumulate_``, whose bits the whole frame keeps."""

    def __init__(self, cfg: RenderConfig, scene, env, lights, device,
                 row0: int = 0, rows: Optional[int] = None):
        rows = cfg.height if rows is None else rows
        self.cfg, self.scene, self.env, self.lights = cfg, scene, env, lights
        self.row0, self.rows = row0, rows
        # position, forward, right, up, half_width, half_height
        self.cam = torch.zeros(14, dtype=torch.float32, device=device)
        cam = self.cam
        self.camera = CameraRays(cam[0:3], cam[3:6], cam[6:9], cam[9:12],
                                 cam[12], cam[13])
        self.whole = (device.type == "cuda"
                      and wavefront._whole_frame_ok(cfg, scene, env, lights))
        self.tables = (cuda_bounce.frame_tables(cfg, scene, lights)
                       if self.whole else None)
        self.state = state_mod.init_state(cfg.width * rows, device)
        self.rays = torch.zeros(cfg.max_depth, dtype=torch.int64,
                                device=device)
        self.bounces = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, camera: CameraRays, rstate: state_mod.RenderState) -> None:
        """Copy the camera rays, and `rstate` unless it is the step's own
        state, into the buffers; zero the stats."""
        for dst, src in zip(self.camera, camera):
            dst.copy_(src)
        if rstate is not self.state:
            if rstate.accum.shape != self.state.accum.shape:
                raise ValueError(f"a state of {rstate.num_pixels} pixels for "
                                 f"a band of {self.state.num_pixels}")
            for dst, src in zip(self.state, rstate):
                dst.copy_(src)
        self.rays.zero_()
        self.bounces.zero_()

    @torch.no_grad()
    def frame(self) -> None:
        if self.whole:
            rays = cuda_bounce.whole_frame(
                self.cfg, self.scene, self.lights, self.cam, self.state.accum,
                self.state.frame_index, self.tables, self.row0)
            stats = WavefrontStats(rays_per_bounce=rays,
                                   bounces_run=(rays > 0).sum())
            state_mod.count_(self.state, float(self.cfg.spp))
        else:
            img, stats = _frame_image(self.cfg, self.scene, self.env,
                                      self.lights, self.camera,
                                      self.state.frame_index, self.row0,
                                      self.rows)
            state_mod.accumulate_(self.state, img.reshape(-1, 3),
                                  float(self.cfg.spp))
        self.rays.add_(stats.rays_per_bounce)
        torch.maximum(self.bounces, stats.bounces_run, out=self.bounces)

    def stats(self) -> WavefrontStats:
        """The stats summed since ``load``, in tensors of their own."""
        return WavefrontStats(rays_per_bounce=self.rays.clone(),
                              bounces_run=self.bounces.clone())


class CapturedStep:
    """``StaticStep.frame`` captured once and replayed a frame: the
    counterpart of the JAX package's traced-k ``_frame_step_k``.  The
    capture is a ``wavefront.SegmentedGraph``: one CUDA graph, whose IF
    nodes (``wavefront._cond``) and WHILE nodes (``wavefront._while_loop``)
    the device decides; a frame is one graph launch and no host read.

    The first call runs its first frame eagerly on a side stream, the
    warm-up ``torch.cuda.graphs`` asks for (it builds the kernels, makes
    the first allocation of every buffer and every opt-in of the C
    entries), then captures a frame in the relaxed mode and throws it away,
    which warms the branch the eager frame did not take and every loop
    body, then captures the frame in the global mode; each later frame is
    a replay.  A capture that fails raises: nothing runs eagerly in its
    place.  The wrappers' launch counts tick for the eager frame as it
    launches and for each replay by what its capture counted, the
    conditional bodies' share when ``wavefront.launch_counts`` is read.

    The capture is the set-up span "capture" (utils/timing.py); a call,
    while a torch.profiler records, the spans "load", "replays" and
    "stats" and device stamps outside the graph: before the load copies,
    before each replay, after the last replay and after the stats."""

    def __init__(self, step: StaticStep):
        self.step = step
        self.graph = None

    def _capture(self) -> None:
        s = self.step
        device = s.state.accum.device
        with timing.setup_span("capture"):
            with timing.setup_span("warmup_frame"):
                current = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    s.frame()
                current.wait_stream(side)
            with timing.setup_span("capture_relaxed"):
                with wavefront.SegmentedGraph(device).capture(mode="relaxed"):
                    s.frame()
            with timing.setup_span("capture_global"):
                graph = wavefront.SegmentedGraph(device)
                with graph.capture():
                    s.frame()
        self.graph = graph

    def __call__(self, camera: CameraRays, rstate, k: int):
        """`k` frames (at least one) -> (the step's state, stats)."""
        device = self.step.state.accum.device
        timing.stamp("load", device)
        with timing.span("load"):
            self.step.load(camera, rstate)
        k = max(k, 1)
        if self.graph is None:
            self._capture()
            k -= 1
        # one flag check for the loop, not one a replay
        stamp = timing.RECORDER.stamp if timing.recording() else None
        with timing.span("replays"):
            for _ in range(k):
                if stamp is not None:
                    stamp("replay", device)
                self.graph.replay()
        timing.stamp("stats", device)
        with timing.span("stats"):
            stats = self.step.stats()
        timing.stamp("end", device)
        return self.step.state, stats


def _captured_step_dyn(cfg: RenderConfig, scene, env, lights, device,
                       row0: int = 0, rows: Optional[int] = None):
    """step(camera, rstate, k) -> (rstate, stats): `k` frames of the band of
    `rows` rows from `row0` as k replays of one captured frame, the
    counterpart of ``_jitted_step_dyn`` (spt_tpu/engine/renderer.py:
    135-150).  JAX caches its program per config; this graph holds its
    own buffers, so its caller keeps it (the Renderer for its cfg, the
    sharded step for its band)."""
    return CapturedStep(StaticStep(cfg, scene, env, lights, device, row0,
                                   rows))


def render_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" is the current
    card, "cuda:0" on one card, as the tensors made on it report it; under
    a process group, the card LOCAL_RANK names, which becomes the current
    card); raises
    when it is the card and there is none (there is no CPU fallback: the
    caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("Renderer: no CUDA device (pass device='cpu' "
                               "to run the plain PyTorch versions)")
        if device.index is None:
            if dist.is_initialized() and "LOCAL_RANK" in os.environ:
                # a rank of a process group renders on its own card
                torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def tree_tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tree_tensors(o)


class Renderer:
    """Progressive renderer over one scene, on one device or, under a
    process group, over a mesh of one device a rank.

    The constructor is the set-up span "renderer_init" (utils/timing.py),
    its parts "mesh", "flatten", "env_lights", "state", and on a mesh
    "replicate" and "band_probe" (``_shard``);
    while a torch.profiler records, ``render_frames`` and ``image`` record
    spans of their parts and enqueue device stamps (PERF.md section 3)."""

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
        with timing.setup_span("renderer_init"):
            self._init(desc, cfg, env, lights, camera, multi_device, device)

    def _init(self, desc, cfg, env, lights, camera, multi_device, device):
        self.cfg = cfg or RenderConfig()
        # Shard the image into row bands when a process group of several
        # ranks is up and the height tiles; an auto-detected mesh yields to
        # the megakernel (the user asked for a backend, not a mesh), an
        # explicit multi_device=True with it is a conflict
        # (spt_tpu/engine/renderer.py:179-203).
        world = dist.get_world_size() if dist.is_initialized() else 1
        if multi_device is None:
            multi_device = (world > 1 and self.cfg.height % world == 0
                            and self.cfg.integrator != "megakernel")
        if multi_device and self.cfg.integrator == "megakernel":
            raise ValueError(
                "integrator='megakernel' is single-device only; use the "
                "wavefront integrators (masked/compact/regen) on a device "
                "mesh")
        self.device = render_device(device)
        self.mesh = None
        if multi_device:
            from spt_tpu_torch.parallel import sharding

            with timing.setup_span("mesh"):
                self.mesh = sharding.make_mesh(self.device.type)
        self.rank = dist.get_rank() if world > 1 else 0
        with timing.setup_span("flatten"):
            self.scene = flatten_scene(desc, self.device)
        with timing.setup_span("env_lights"):
            self.env = (env if env is not None
                        else make_procedural_environment(self.device))
            self.lights = (lights if lights is not None
                           else default_lights(self.device))
            for name, obj in (("env", self.env), ("lights", self.lights)):
                for t in tree_tensors(obj):
                    if t.device != self.device:
                        raise ValueError(f"{name} lies on {t.device}, the "
                                         f"renderer on {self.device}")
        with timing.setup_span("state"):
            self.camera = camera or Camera(
                aspect_ratio=self.cfg.width / self.cfg.height)
            self.state = state_mod.init_state(self.cfg.num_pixels,
                                              self.device)
            self.last_stats = None
            self._captured = None
            self._wavefront_integrator = (
                "masked" if self.cfg.integrator == "megakernel"
                else self.cfg.integrator)
            self.band_edges = self.band_work_share = None
            self.band_device_ms = None
        if self.mesh is not None:
            with timing.setup_span("replicate"):
                for tree in (self.scene, self.env, self.lights):
                    sharding.replicate(self.mesh, tree)
            self._shard()

    def _shard(self) -> None:
        """Size the bands by the frame's work from the camera as it stands
        (the set-up span "band_probe", ``sharding.probe_edges``), set them
        on ``cfg.band_edges``, make the sharded step and keep this rank's
        band of the whole-frame state.  The probe renders on states of its
        own: the state, its frame index and ``last_stats`` are left as
        they were.  ``band_work_share`` is each band's share of the probe's
        rays (None where the image makes one strip a rank),
        ``band_device_ms`` each band's timed frame on the card (None on
        the CPU)."""
        from spt_tpu_torch.bench import shadow_rays_per_surface_lane
        from spt_tpu_torch.parallel import sharding

        with timing.setup_span("band_probe"):
            probe = sharding.probe_edges(
                self.cfg, self.scene, self.env, self.lights,
                self.camera.rays(self.device), self.state.frame_index,
                self.mesh, shadow_rays_per_surface_lane(self))
        self.band_edges = probe.edges
        self.band_work_share = probe.work_share
        self.band_device_ms = probe.device_ms
        self.cfg = self.cfg.replace(band_edges=self.band_edges)
        self._step = sharding.sharded_frame_step_dyn(self.cfg, self.mesh)
        self.state = sharding.shard_pixels(self.mesh, self.state, self.cfg)

    def toggle_integrator(self) -> str:
        """Flip wavefront <-> megakernel and reset accumulation, the
        reference's 'G' backend toggle (GLRenderer.cpp:263-277): switching
        backends resets accumulation so images stay comparable.  The second
        toggle restores the wavefront integrator the renderer started with.
        Returns the new integrator name.  A no-op on a device mesh (the
        sharded step is a wavefront program)."""
        if self.mesh is not None:
            return self.cfg.integrator
        if self.cfg.integrator != "megakernel":
            self._wavefront_integrator = self.cfg.integrator
            new = "megakernel"
        else:
            new = self._wavefront_integrator
        self.cfg = self.cfg.replace(integrator=new)
        self.state = state_mod.reset(self.state)
        self._captured = None
        return new

    def resize(self, width: int, height: int) -> None:
        """Change the render resolution in place: reset accumulation, keep
        scene/camera/lights; the camera adopts the new aspect ratio
        (OptixBackend::resize, OptixBackend.cpp:1508-1543).  On a device
        mesh the new height must still tile over the ranks, and the bands
        are probed again for it; otherwise the renderer drops the mesh and
        every rank renders the whole frame on its own device
        (spt_tpu/engine/renderer.py:259-265)."""
        if (width, height) == (self.cfg.width, self.cfg.height):
            return
        self.cfg = self.cfg.replace(width=width, height=height,
                                    band_edges=None)
        self.band_edges = self.band_work_share = None
        self.band_device_ms = None
        self.camera.set_aspect_ratio(width / height)
        self.state = state_mod.init_state(self.cfg.num_pixels, self.device)
        self.last_stats = None
        self._captured = None
        if self.mesh is not None:
            if height % self.mesh.size() == 0:
                self._shard()
            else:
                self.mesh = None

    # --- frame loop -----------------------------------------------------------

    def render_frame(self, check_camera: bool = True) -> None:
        """Advance the progressive render by one frame (cfg.spp samples)."""
        self.render_frames(1, check_camera=check_camera)

    def render_frames(self, k: int, check_camera: bool = False) -> None:
        """Advance by `k` frames with a static camera; summed stats land in
        last_stats (the whole frame's on a mesh).  On the card it copies
        the camera rays (and a state that is not the captured step's own)
        into the step's buffers and replays its graph k times, the first
        call capturing it (``_captured_step_dyn``); the state is then the
        step's buffers, updated in place.  Nothing in the loop waits for
        the device; on a mesh the call ends with the step's two all_reduces
        of the stats.  While a torch.profiler records: the span
        "render_frames" and a device stamp before the camera's upload."""
        with timing.span("render_frames"):
            if check_camera and self.camera.has_moved_since_last_check():
                self.state = state_mod.reset(self.state)
            timing.stamp("upload", self.device)
            with timing.span("camera_upload"):
                rays = self.camera.rays(self.device)
            if self.mesh is not None:
                self.state, self.last_stats = self._step(
                    self.scene, self.env, self.lights, rays, self.state, k)
            elif captures(self.cfg, self.device):
                self.state, self.last_stats = self.captured_step()(
                    rays, self.state, k)
            else:
                self.state, self.last_stats = frame_chain(
                    self.cfg, self.scene, self.env, self.lights, rays,
                    self.state, k)

    def captured_step(self) -> CapturedStep:
        """The whole image's captured step for the current cfg (its band is
        the image: row0 0, rows cfg.height), made on first use; ``resize``
        and ``toggle_integrator`` drop it with its graphs' memory."""
        if self._captured is None or self._captured.step.cfg != self.cfg:
            self._captured = _captured_step_dyn(
                self.cfg, self.scene, self.env, self.lights, self.device)
        return self._captured

    def render(self, frames: int = 1) -> np.ndarray:
        """Run `frames` progressive frames and return the resolved image."""
        for _ in range(frames):
            self.render_frame()
        return self.image()

    # --- outputs ----------------------------------------------------------------

    @property
    def accumulated_samples(self) -> float:
        return float(self.state.sample_count)

    def _full_state(self) -> state_mod.RenderState:
        """The whole frame's state (the bands gathered on a mesh)."""
        if self.mesh is None:
            return self.state
        from spt_tpu_torch.parallel import sharding

        with timing.span("gather"):
            return self.state._replace(accum=sharding.gather_bands(
                self.mesh, self.state.accum, self.cfg))

    def image(self) -> np.ndarray:
        """Resolved display image, (H, W, 3) float in [0, 1].  While a
        torch.profiler records: the span "image" (its parts "gather" on a
        mesh, "resolve", "readback") and device stamps before the gather or
        resolve, after the resolve and after the readback."""
        with timing.span("image"):
            timing.stamp("image", self.device)
            st = self._full_state()
            with timing.span("resolve"):
                img = resolve(st.accum, st.sample_count,
                              exposure=self.cfg.exposure, gamma=self.cfg.gamma,
                              tonemap=self.cfg.tonemap)
            timing.stamp("readback", self.device)
            with timing.span("readback"):
                out = img.reshape(self.cfg.height, self.cfg.width,
                                  3).cpu().numpy()
            timing.stamp("end", self.device)
        return out

    def hdr_image(self) -> np.ndarray:
        """Linear HDR mean radiance, (H, W, 3) float32."""
        cnt = max(self.accumulated_samples, 1e-30)
        return self._full_state().accum.cpu().numpy().reshape(
            self.cfg.height, self.cfg.width, 3) / cnt

    def save_png(self, path: str) -> None:
        img = self.image()
        if self.rank == 0:
            write_png(path, img)

    # --- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """The whole frame's state in the JAX package's .npz format, written
        by rank 0; on a mesh every rank returns once the file is written."""
        st = self._full_state()
        if self.rank == 0:
            state_mod.save_checkpoint(path, st)
        if self.mesh is not None:
            from spt_tpu_torch.parallel import sharding

            sharding.barrier(self.mesh, self.device)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a whole-frame checkpoint; on a mesh each rank keeps
        its band."""
        st = state_mod.load_checkpoint(path, self.device)
        if st.num_pixels != self.cfg.num_pixels:
            raise ValueError(f"checkpoint holds {st.num_pixels} pixels, the "
                             f"renderer {self.cfg.num_pixels}")
        if self.mesh is not None:
            from spt_tpu_torch.parallel import sharding

            st = sharding.shard_pixels(self.mesh, st, self.cfg)
        self.state = st
