"""The resident cluster tracer for Hopper: ``closest_hit`` and ``any_hit``.

The counterpart of ``spt_tpu.ops.pallas_trace`` (K4: ``closest_hit`` :732,
``any_hit`` :753, via ``_common_call`` :685).  Both take the scene's cluster
accel (``ops/bvh.MeshAccel``) and one ray per lane:

- ``closest_hit`` -> ``intersect.HitV``: t (inf on a miss), the geometric
  normal or the interpolated shading normal where the scene carries them,
  the material and the kind.  The analytic spheres are tested first.
- ``any_hit`` -> (N,) bool; lanes with tmax <= tmin report blocked, as the
  TPU kernel's do (every caller masks them out).

On a CUDA tensor each launches the kernel of ``csrc/cluster_trace.cu``
(the ClusterTracer of ``csrc/spt_tracers.cuh``, which the resident forms of
fused_frame and fused_bounce inline) or raises.  On a CPU tensor each runs
its plain version, ``closest_hit_reference`` / ``any_hit_reference``: the
chunked brute force of ``intersect`` over the scene's flat tables.  The two
agree except on exact ties in t.  (``intersect.occluded_v`` on a CPU tensor
calls the chunked version itself, which reports empty intervals unblocked,
as the JAX package's does; its callers mask those lanes.)  ``CLOSEST_LAUNCHES`` and
``ANY_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import math

import torch

from spt_tpu_torch.ops import cuda_lib
from spt_tpu_torch.ops import intersect as isect
from spt_tpu_torch.ops.bvh import MAX_RESIDENT_TRIS
from spt_tpu_torch.ops.vec3 import Vec3

CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0


def closest_hit_reference(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                          tmax=math.inf) -> isect.HitV:
    """Plain version of closest_hit (intersect._intersect_chunked)."""
    return isect._intersect_chunked(scene, o, d, tmin, tmax)


def any_hit_reference(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                      tmax=math.inf) -> torch.Tensor:
    """Plain version of any_hit: intersect._occluded_chunked, with the
    lanes of an empty interval counted blocked as the kernel counts them
    (the chunked version reports them unblocked)."""
    blocked = isect._occluded_chunked(scene, o, d, tmin, tmax)
    return blocked | (torch.as_tensor(tmax, device=blocked.device) <= tmin)


def _launch_inputs(accel, scene, o: Vec3, d: Vec3, tmax):
    """(ray pointers, scene arguments, keep-alive tensors) for a launch."""
    device = o.x.device
    n = o.x.shape[0]
    for c in (*o, *d):
        if (c.device != device or c.dtype != torch.float32
                or c.shape != (n,) or not c.is_contiguous()):
            raise ValueError(f"ray planes must be contiguous float32 ({n},) "
                             f"tensors on {device}")
    if isinstance(tmax, torch.Tensor):
        tmax = torch.broadcast_to(tmax.to(device=device, dtype=torch.float32),
                                  (n,)).contiguous()
    else:
        tmax = torch.full((n,), min(float(tmax), 1e30), dtype=torch.float32,
                          device=device)
    if accel.num_clusters * accel.cluster_size > MAX_RESIDENT_TRIS:
        raise NotImplementedError("the stream tier is not ported")

    def bits(t):
        return t.to(torch.int32).contiguous().view(torch.float32).reshape(-1)

    tables = torch.cat([
        torch.cat([scene.sph_center, scene.sph_radius.reshape(-1, 1),
                   bits(scene.sph_mat).reshape(-1, 1)], 1).reshape(-1),
        torch.cat([accel.cluster_lo, accel.cluster_hi], 1).reshape(-1),
        bits(accel.cl_okey)])
    pack = accel.tri_pack.contiguous()
    rays = [*o, *d, tmax]
    scene_args = (tables.data_ptr(), scene.num_spheres, pack.data_ptr(),
                  pack.shape[-1], accel.num_clusters, accel.cluster_size)
    return [t.data_ptr() for t in rays], scene_args, rays + [tables, pack]


def closest_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                tmax=math.inf) -> isect.HitV:
    """Closest hit of every lane against the spheres and the clusters."""
    global CLOSEST_LAUNCHES
    device = o.x.device
    if device.type == "cpu":
        return closest_hit_reference(accel, scene, o, d, tmin, tmax)
    if device.type != "cuda":
        raise ValueError(f"closest_hit runs on CUDA or CPU tensors, not {device}")
    rays, scene_args, keep = _launch_inputs(accel, scene, o, d, tmax)
    n = o.x.shape[0]
    out_f = [torch.empty(n, dtype=torch.float32, device=device)
             for _ in range(4)]
    out_i = [torch.empty(n, dtype=torch.int32, device=device)
             for _ in range(2)]
    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_closest_hit(
            *rays, *(t.data_ptr() for t in out_f + out_i), *scene_args, n,
            float(tmin), cuda_lib.stream_of(device))
    cuda_lib.check(err, "closest_hit")
    del keep
    CLOSEST_LAUNCHES += 1
    t, nx, ny, nz = out_f
    return isect.HitV(t=t, normal=Vec3(nx, ny, nz), mat_id=out_i[0],
                      kind=out_i[1])


def any_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
            tmax=math.inf) -> torch.Tensor:
    """Whether anything blocks each lane's ray within (tmin, tmax)."""
    global ANY_LAUNCHES
    device = o.x.device
    if device.type == "cpu":
        return any_hit_reference(accel, scene, o, d, tmin, tmax)
    if device.type != "cuda":
        raise ValueError(f"any_hit runs on CUDA or CPU tensors, not {device}")
    rays, scene_args, keep = _launch_inputs(accel, scene, o, d, tmax)
    n = o.x.shape[0]
    blocked = torch.empty(n, dtype=torch.bool, device=device)
    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_any_hit(*rays, blocked.data_ptr(), *scene_args, n,
                              float(tmin), cuda_lib.stream_of(device))
    cuda_lib.check(err, "any_hit")
    del keep
    ANY_LAUNCHES += 1
    return blocked
