"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It reads ``BENCHMARK.json``, builds the
cell's scene from its configuration file through the port's public API
(``spt_tpu_torch``: ``SceneDesc``, ``LightManager``, ``Camera``,
``Renderer``), warms up and captures the frame with the cell's traffic,
then runs the traffic's jobs in a closed loop for ``--seconds`` (whole
jobs: the window ends with the job in flight once the time is up), checks
a sample of what the window brought to the host against the plain
reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown`` of the device trace, and last ``check``, each compared
number beside its limit (also the last lines on standard error).

``--seed`` sets the RNG epoch (frame index) of the run's first frame and
the pixels and jobs that are checked.  A cell on several cards starts one
process a card (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and a local
rendezvous, NCCL with its shared-memory transport off); rank 0 prints the
line.  Without CUDA, or with fewer cards than the cell asks for, it exits
2 and prints no result; a rank that finds ``jax``, ``jaxlib``, ``flax`` or
``spt_tpu`` in ``sys.modules`` after the window exits 3, and the run with
it, printing no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "spt_tpu")
# Frame indices are int32 in the port: the epoch leaves room for the run.
EPOCH_SPAN = (1 << 31) - (1 << 26)
CACHE_DIRS = {"CUDA_CACHE_PATH": "cuda_cache",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton_cache"}


def process_start() -> float:
    """This process's start on the epoch clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Client:
    """The cell's renderer and the traffic's closed-loop client."""

    def __init__(self, spec, workload: str, device, world: int = 1):
        import torch

        from portbench import scenes
        from portbench.work.rays import shadow_rays_per_surface_lane

        self.torch = torch
        self.cell = spec.cell(workload)
        self.traffic = spec.traffic(self.cell["traffic"])
        self.checkspec = spec.check(workload)
        self.data = scenes.scene_data(spec.config(self.cell["config"]))
        self.render = dict(self.data.render)
        self.device = torch.device(device)
        self.world = world
        self.cuda = self.device.type == "cuda"
        self.spans = {}
        t0 = time.perf_counter()
        from spt_tpu_torch.config import RenderConfig
        from spt_tpu_torch.engine.renderer import Renderer

        desc = scenes.port_scene(self.data)
        w, h = int(self.render["width"]), int(self.render["height"])
        self.renderer = Renderer(
            desc, RenderConfig(**self.render),
            lights=scenes.port_lights(self.data, self.device),
            camera=scenes.port_camera(self.data, w, h), device=self.device)
        self.spans["scene_build_s"] = time.perf_counter() - t0
        self.n_shadow = shadow_rays_per_surface_lane(self.data, self.render)
        self.frames_done = 0
        self.epoch0 = 0
        self.keep = None          # pixel indices kept of every image
        self.keep_here = None     # positions in `keep` of this rank's band
        self._keep_dev = None     # their rows of this rank's accumulation
        self.timing = False       # CUDA events around the calls
        self.captured = False
        self._pre_reduce = None

    # --- traffic ------------------------------------------------------------

    def start(self, seed: int) -> None:
        """Set the RNG epoch from the seed; draw the pixels the check
        keeps, and find those of this rank's band of rows."""
        from portbench import check

        torch = self.torch
        r = self.renderer
        self.epoch0 = seed % EPOCH_SPAN
        self.frames_done = 0
        r.state = r.state._replace(frame_index=torch.full(
            (), self.epoch0, dtype=torch.int32, device=self.device))
        cs = self.checkspec
        w, h = int(self.render["width"]), int(self.render["height"])
        self.keep = check.sample_pixels(seed, w, h, int(cs["pixels"]),
                                        int(cs["row_groups"]))
        row0, rows = 0, h
        if self.world > 1:
            from spt_tpu_torch.parallel import sharding

            row0, rows = sharding.band(r.cfg, r.rank, self.world)
        lo, hi = row0 * w, (row0 + rows) * w
        self.keep_here = np.nonzero((self.keep >= lo) & (self.keep < hi))[0]
        self._keep_dev = torch.as_tensor(self.keep[self.keep_here] - lo,
                                         device=self.device)

    def _label(self, name):
        if self.timing:
            return self.torch.profiler.record_function(name)
        import contextlib

        return contextlib.nullcontext()

    def _event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def job(self):
        """One job of the traffic -> (record, kept display values, kept
        radiance of this rank's band)."""
        from portbench.record import Job
        from spt_tpu_torch.engine import state as state_mod

        torch = self.torch
        r = self.renderer
        tr = self.traffic
        t_start = time.perf_counter()
        r.state = state_mod.reset(r.state)
        epoch = self.epoch0 + self.frames_done
        left = int(tr["job_frames"])
        chain = int(tr["chain_frames"])
        calls, stats = [], []
        while left > 0:
            k = min(chain, left)
            ev0 = self._event() if self.timing else None
            self._pre_reduce = None
            t0 = time.perf_counter()
            with self._label("portbench.render_frames"):
                r.render_frames(k)
            if not self.captured and self.cuda:
                torch.cuda.synchronize(self.device)
                self.spans["capture_s"] = time.perf_counter() - t0
            self.captured = True
            if self.timing:
                calls.append((ev0, self._pre_reduce, self._event()))
                stats.append(r.last_stats.rays_per_bounce.clone())
            left -= k
            self.frames_done += k
        ev_i = self._event() if self.timing else None
        with self._label("portbench.image"):
            img = r.image()
        st = r.state
        radiance = (st.accum[self._keep_dev] / st.sample_count).cpu().numpy()
        t_end = time.perf_counter()
        frames = int(tr["job_frames"])
        rec = Job(t_start=t_start, t_end=t_end, frames=frames,
                  samples=frames * r.cfg.num_pixels * r.cfg.spp, epoch=epoch)
        if self.timing:
            ev_e = self._event()
            ev_e.synchronize()
            rec.device_ms = sum(a.elapsed_time(b) for a, _, b in calls)
            rec.band_ms = sum(a.elapsed_time(m if m is not None else b)
                              for a, m, b in calls)
            rec.image_ms = ev_i.elapsed_time(ev_e)
            rec.rays = np.sum([s.cpu().numpy() for s in stats], 0)
        return rec, img.reshape(-1, 3)[self.keep], radiance

    def hook_reduce(self):
        """Record a CUDA event where a render call reaches its first
        all_reduce (the sharded step's stats), so a band's own time can be
        told from its wait for the other bands."""
        import torch.distributed as dist

        orig = dist.all_reduce
        client = self

        def all_reduce(*a, **kw):
            if client.timing and client._pre_reduce is None:
                client._pre_reduce = client._event()
            return orig(*a, **kw)

        dist.all_reduce = all_reduce
        return orig


def _agree(client, go: bool) -> bool:
    """Rank 0's decision to run another job, on every rank."""
    if client.world == 1:
        return go
    import torch.distributed as dist

    flag = client.torch.tensor([1 if go else 0], device=client.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def window(client, seconds: float):
    """Jobs in a closed loop until `seconds` have passed, the last one
    whole -> (job records, kept display values, kept radiance of this
    rank's band, window seconds)."""
    jobs, kept, radiance = [], [], []
    t_w0 = time.perf_counter()
    while True:
        rec, vals, rad = client.job()
        jobs.append(rec)
        kept.append(vals)
        radiance.append(rad)
        if not _agree(client, time.perf_counter() - t_w0 < seconds):
            break
    return jobs, kept, radiance, jobs[-1].t_end - t_w0


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", rank: int = 0, world: int = 1,
             t_start: float = None) -> dict:
    """Run the cell once -> the result (rank 0) or None (other ranks)."""
    import torch

    from portbench import check
    from portbench.record import RunRecord
    from portbench.spec import Spec

    t_start = process_start() if t_start is None else t_start
    spec = Spec(root)
    client = Client(spec, workload, device, world)
    tr = client.traffic
    if world > 1:
        orig_reduce = client.hook_reduce()
    if client.cuda:
        torch.cuda.reset_peak_memory_stats(client.device)
    client.start(seed)
    for _ in range(int(tr.get("warmup_jobs", 1))):
        client.job()
    client.timing = trace and client.cuda
    setup_s = time.time() - t_start
    jobs, kept, radiance, window_s = window(client, seconds)
    timed = client.timing
    client.timing = False
    prof = None
    if trace and client.cuda:
        from portbench import trace as trace_mod

        client.timing = True
        prof = trace_mod.profile(client.job, int(tr["profile_jobs"]),
                                 client.device)
        client.timing = False
    peak = (torch.cuda.max_memory_allocated(client.device) if client.cuda
            else 0)
    checkspec = spec.check(workload)
    chosen = check.choose_jobs(seed, len(jobs), int(checkspec["jobs"]))
    me = {"window_s": window_s, "peak": peak,
          "keep_here": client.keep_here,
          "radiance": [radiance[j] for j in chosen],
          "busy_ms": (sum(j.band_ms + j.image_ms for j in jobs) if timed
                      else None),
          "band_ms": sum(j.band_ms for j in jobs) if timed else None,
          "prof": prof}
    ranks = [me]
    if world > 1:
        import torch.distributed as dist

        ranks = [None] * world
        dist.all_gather_object(ranks, me)
        dist.all_reduce = orig_reduce
    kind = (torch.cuda.get_device_name(client.device) if client.cuda
            else "cpu")
    data, render, keep = client.data, client.render, client.keep
    spans = dict(client.spans)
    n_shadow = client.n_shadow
    del client
    gc.collect()
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    run = RunRecord(workload=workload, render=render, world=world,
                    trace=trace, jobs=jobs, window_s=window_s,
                    setup_s=setup_s, spans=spans, n_shadow=n_shadow,
                    scene=data, device_kind=kind, ranks=ranks)
    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, kind_key):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, after the window, the peak and the program's state
    got = np.stack([kept[j] for j in chosen])
    got_rad = np.full(got.shape, np.nan, np.float32)
    for rk in ranks:
        for i, rad in enumerate(rk["radiance"]):
            got_rad[i, rk["keep_here"]] = rad
    t_ref = time.perf_counter()
    want, want_rad = reference_values(data, render, [jobs[j] for j in chosen],
                                      keep, device)
    ref_s = time.perf_counter() - t_ref
    nums = check.numbers(got, want, float(checkspec["off_threshold"]),
                         got_rad, want_rad)
    correct, table = check.judge(nums, checkspec["limits"])
    result = {
        "correct": bool(correct),
        "attempted": len(jobs),
        "failed": 0 if correct else len(chosen),
        "metrics": metrics,
        "device": {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": kind, "count": world,
                   "memory_peak_bytes": int(max(r["peak"] for r in ranks))},
    }
    if prof is not None:
        profs = [r["prof"] for r in ranks]
        result["device"]["busy_s"] = float(np.mean([p["busy_s"]
                                                    for p in profs]))
        result["device"]["window_s"] = float(np.mean([p["window_s"]
                                                      for p in profs]))
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    lat = [(j.t_end - j.t_start) * 1e3 for j in jobs]
    result["job_ms"] = {"count": len(lat), "median": float(np.median(lat)),
                        "p95": float(np.percentile(lat, 95))}
    result["reference_s"] = ref_s
    result["check"] = table
    return result


def reference_values(data, render, jobs, pixels, device,
                     shade_dtype=None) -> tuple:
    """The reference's display values and mean radiance, each
    (len(jobs), P, 3), of `pixels` for each job: its frames from its RNG
    epoch through the configuration's camera."""
    import torch

    from portbench import scenes
    from portbench.reference import render as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = torch.float32 if shade_dtype is None else shade_dtype
    sc = ref.prepare(data, device)
    s = ref.settings(render)
    pos, yaw, pitch = scenes.camera_yaw_pitch(data.camera)
    aspect = int(render["width"]) / int(render["height"])
    cam = ref.camera_basis(pos, yaw, pitch, float(data.camera["fov_degrees"]),
                           aspect)
    images, radiance = [], []
    with torch.no_grad():
        for job in jobs:
            acc = ref.render_sums(sc, render, cam, pixels, job.epoch,
                                  job.frames, sd=sd)
            count = job.frames * int(s["spp"])
            img = ref.resolve(acc, count, float(s["exposure"]),
                              float(s["gamma"]))
            images.append(img.float().cpu().numpy())
            radiance.append((acc / count).float().cpu().numpy())
    return np.stack(images), np.stack(radiance)


# --- entry ---------------------------------------------------------------------

def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def first_failure(codes) -> int:
    """The first rank's exit code that is not 0, or 0."""
    return next((c for c in codes if c != 0), 0)


def launch_ranks(argv, world: int, t_start: float, timeout: float = 330.0):
    """Start `world` rank processes of this command and wait for them ->
    (exit code, rank 0's standard output)."""
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), NCCL_SHM_DISABLE="1",
               PORTBENCH_T0=repr(t_start), OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.run", *argv],
                cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
        out, _ = procs[0].communicate(timeout=timeout)
        deadline = time.monotonic() + 60.0
        codes = [procs[0].returncode] + [
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return first_failure(codes), out.decode()


def print_check(result: dict) -> None:
    """The job latencies, then each compared number beside its limit, as
    the last lines on standard error."""
    lat = result["job_ms"]
    print(f"jobs {lat['count']}: median {lat['median']!r} ms, p95 "
          f"{lat['p95']!r} ms", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr, flush=True)


def finish(result, rank: int = 0) -> int:
    """On every rank: exit 3 and print no result where ``jax``, ``jaxlib``,
    ``flax`` or ``spt_tpu`` was loaded by the time the window closed;
    else rank 0 prints the compared numbers and the result's line."""
    found = forbidden_modules()
    if found:
        print(f"portbench: {found} in sys.modules after the window "
              f"(rank {rank})", file=sys.stderr, flush=True)
        return 3
    if rank == 0:
        print_check(result)
        print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    t_start = float(os.environ.get("PORTBENCH_T0", process_start()))
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    import torch

    from portbench.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    if chips > 1 and "RANK" not in os.environ:
        # build the kernel library once, before the ranks look for it
        from spt_tpu_torch.ops import cuda_lib

        cuda_lib.build()
        code, out = launch_ranks(argv, chips, t_start)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        if code != 0 or not lines:
            print(f"portbench: a rank failed (exit {code})", file=sys.stderr)
            return code or 1
        return finish(json.loads(lines[-1]))
    rank, world, created = 0, 1, False
    if chips > 1:
        torch.set_num_threads(1)
        from spt_tpu_torch.parallel.launch import init_from_env

        created = init_from_env("cuda")
        rank, world = int(os.environ["RANK"]), chips
    try:
        result = run_cell(ROOT, args.workload, seed, args.seconds,
                          bool(args.trace), "cuda", rank, world, t_start)
    finally:
        if created:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    return finish(result, rank)


if __name__ == "__main__":
    sys.exit(main())
