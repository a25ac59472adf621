"""The mesh tracers for Hopper: resident (K4), instanced (K7) and stream (K8).

- ``closest_hit`` / ``any_hit``: the resident cluster tracer, the
  counterpart of ``spt_tpu.ops.pallas_trace`` (K4: ``closest_hit`` :732,
  ``any_hit`` :753, via ``_common_call`` :685), over the scene's cluster
  accel (``ops/bvh.MeshAccel``) while it holds at most
  ``bvh.MAX_RESIDENT_TRIS`` triangles.
- ``inst_closest_hit`` / ``inst_any_hit``: the instanced TLAS/BLAS tracer,
  the counterpart of ``spt_tpu.ops.pallas_inst`` (K7: ``closest_hit`` :893,
  ``any_hit`` :915, via ``_inst_call`` :854), over ``ops/bvh.InstAccel``.
- ``stream_closest_hit`` / ``stream_any_hit``: the two-level supercluster
  tracer, the counterpart of ``spt_tpu.ops.pallas_stream`` (K8:
  ``closest_hit`` :511, ``any_hit`` :534, via ``_stream_call`` :465), over
  a cluster accel past ``bvh.MAX_RESIDENT_TRIS`` (``is_stream``), up to
  ``bvh.MAX_STREAM_CLUSTERS`` clusters.

Contracts, as the TPU kernels':

- closest -> ``intersect.HitV``: t (inf on a miss), the geometric normal or
  the interpolated shading normal where the mesh carries them, the material
  and the kind, and on a textured scene the hit's texture coordinates.  The
  analytic spheres are tested first.
- any -> (N,) bool; lanes with tmax <= tmin report blocked, as the TPU
  kernels' do (every caller masks them out).

On a CUDA tensor each launches its kernel (``csrc/cluster_trace.cu``,
``csrc/inst_trace.cu``, ``csrc/stream_trace.cu``: the ClusterTracer,
InstTracer and StreamTracer of ``csrc/spt_tracers.cuh``, which fused_frame
and fused_bounce inline) or raises.  On a CPU tensor each runs its plain
version:

- ``closest_hit_reference`` / ``any_hit_reference``: the chunked brute
  force of ``intersect`` over the scene's flat tables, for the resident and
  the stream tracer alike;
- ``inst_closest_hit_reference`` / ``inst_any_hit_reference``: the
  instanced walk in PyTorch.  Closest runs the kernel's rounds: each round
  every lane takes its next crossed instance in (tnear, id) order
  (pallas_inst._next_inst, its cursor strictly advancing), the lanes of
  each mesh transform into object space (directions unnormalized, so t is
  world t) and test that mesh's BLAS rows cluster by cluster, and results
  fold by strict ``<``.  Any tests every crossed instance (the order cannot
  change a flag).

Each kernel copies its tables (spheres, boxes, instance rows, keys) into
a block's shared memory while they fit there, and otherwise reads them from
global memory through a kernel of the same code (``tables_in_global``:
thousands of instances, or of spheres beside a mesh).

Kernel and plain version agree except on exact ties in t and on a grazing
ray whose cluster box test and triangle test round apart.
``CLOSEST_LAUNCHES``, ``ANY_LAUNCHES``, ``INST_CLOSEST_LAUNCHES``,
``INST_ANY_LAUNCHES``, ``STREAM_CLOSEST_LAUNCHES`` and
``STREAM_ANY_LAUNCHES`` count kernel launches in the shared placement, the
same names with ``_GLOBAL`` before ``_LAUNCHES`` those in the global one.
"""

from __future__ import annotations

import math

import torch

from spt_tpu_torch.ops import bvh, cuda_lib
from spt_tpu_torch.ops import intersect as isect
from spt_tpu_torch.ops.vec3 import Vec3

CLOSEST_LAUNCHES = 0
ANY_LAUNCHES = 0
INST_CLOSEST_LAUNCHES = 0
INST_ANY_LAUNCHES = 0
STREAM_CLOSEST_LAUNCHES = 0
STREAM_ANY_LAUNCHES = 0
CLOSEST_GLOBAL_LAUNCHES = 0
ANY_GLOBAL_LAUNCHES = 0
INST_CLOSEST_GLOBAL_LAUNCHES = 0
INST_ANY_GLOBAL_LAUNCHES = 0
STREAM_CLOSEST_GLOBAL_LAUNCHES = 0
STREAM_ANY_GLOBAL_LAUNCHES = 0

_BIG = 1e30          # pallas_trace._BIG
_MT_EPS = 1e-9
_NS_STEP = 4.0 / 4094.0
# words per instance row of the kernels' table: world box lo | hi | the
# (16,) InstAccel.inst row
INST_WORDS = 22
# Elements of one (lanes, rows) block of the plain instanced tests.
_BLOCK_ELEMS = 1 << 22


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


# --- the instanced tracer's plain version ----------------------------------------

def _inv_dir(x: torch.Tensor) -> torch.Tensor:
    """pallas_trace._inv_dir: zero components become +-1e30."""
    return torch.where(x.abs() > 1e-20, 1.0 / x,
                       torch.where(x >= 0, _BIG, -_BIG))


def _slab(lo, hi, o: Vec3, inv: Vec3, tmin, bound):
    """(tnear, tfar) of boxes lo/hi (B, 3) against lanes (N,):
    pallas_trace._box_flags' arithmetic, (B, N) each."""
    t = [((lo[:, k, None] - oc[None]) * ic[None],
          (hi[:, k, None] - oc[None]) * ic[None])
         for k, (oc, ic) in enumerate(zip(o, inv))]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(*t[0]), torch.minimum(*t[1])),
        torch.clamp(torch.minimum(*t[2]), min=tmin))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(*t[0]), torch.maximum(*t[1])),
        torch.minimum(torch.maximum(*t[2]), bound[None]))
    return tnear, tfar


def _xform(r, o: Vec3, d: Vec3):
    """World -> object space by the instance rows r (L, 16)
    (pallas_inst._xform_rays): o' = R o + t, d' = R d unnormalized."""
    oo = Vec3(r[:, 0] * o.x + r[:, 1] * o.y + r[:, 2] * o.z + r[:, 9],
              r[:, 3] * o.x + r[:, 4] * o.y + r[:, 5] * o.z + r[:, 10],
              r[:, 6] * o.x + r[:, 7] * o.y + r[:, 8] * o.z + r[:, 11])
    dd = Vec3(r[:, 0] * d.x + r[:, 1] * d.y + r[:, 2] * d.z,
              r[:, 3] * d.x + r[:, 4] * d.y + r[:, 5] * d.z,
              r[:, 6] * d.x + r[:, 7] * d.y + r[:, 8] * d.z)
    return oo, dd


def _pack_test(rows, o: Vec3, d: Vec3, tmin, tmax):
    """Moller-Trumbore of lanes (L,) against packed rows (R, W) in
    pallas_trace._tri_sub_test's formulation -> (ok, t, u, v), (L, R)."""
    c = [rows[None, :, k] for k in range(9)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    big = a.abs() > _MT_EPS
    inv = 1.0 / torch.where(big, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
          & (t < tmax[:, None]))
    return ok, t, u, v


def _real_clusters(ia, mesh: int) -> torch.Tensor:
    lo, hi = ia.blas_lo[mesh], ia.blas_hi[mesh]
    return torch.nonzero(lo[:, 0] <= hi[:, 0]).flatten()


def _mesh_closest(ia, mesh: int, o: Vec3, d: Vec3, tmin, tmax, best):
    """The closest triangle of each lane (L,) in one BLAS, object-space rays.
    Clusters fold in id order by strict <, starting from `best`; inside a
    cluster the winner follows tri_block_min (lowest t, ties to the highest
    row of an 8-row sub-block, strict across sub-blocks).  Returns (t (L,)
    with `best` where nothing improved, improved (L,), winner pack row (L,)
    int64, u, v)."""
    k = ia.cluster_size
    kb = 8 if k % 8 == 0 else k
    pack = ia.tri_pack.reshape(-1, ia.tri_pack.shape[-1])
    n = o.x.shape[0]
    dev = o.x.device
    t_best = best.clone()
    improved = torch.zeros(n, dtype=torch.bool, device=dev)
    w_row = torch.zeros(n, dtype=torch.int64, device=dev)
    w_u = torch.zeros(n, device=dev)
    w_v = torch.zeros(n, device=dev)
    clusters = _real_clusters(ia, mesh) + mesh * ia.cmax
    g_max = max(1, _BLOCK_ELEMS // max(n * k, 1))
    lane = torch.arange(n, device=dev)
    for g0 in range(0, clusters.numel(), g_max):
        cl = clusters[g0:g0 + g_max]
        g = cl.numel()
        row_ids = (cl[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
        ok, t, u, v = _pack_test(pack[row_ids], o, d, tmin, tmax)
        t = torch.where(ok, t, _BIG).reshape(n, g, k // kb, kb)
        tm_s = t.amin(-1)                                    # (n, g, s)
        eq = t == tm_s[..., None]
        hi_row = kb - 1 - torch.argmax(eq.flip(-1).to(torch.uint8), -1)
        tm_c = tm_s.amin(-1)                                 # (n, g)
        s_first = torch.argmax((tm_s == tm_c[..., None]).to(torch.uint8), -1)
        row_c = s_first * kb + torch.gather(hi_row, 2, s_first[..., None])[..., 0]
        tm = tm_c.amin(-1)                                   # (n,)
        c_first = torch.argmax((tm_c == tm[:, None]).to(torch.uint8), -1)
        row = torch.gather(row_c, 1, c_first[:, None])[:, 0]
        win = tm < t_best
        flat = c_first * k + row
        t_best = torch.where(win, tm, t_best)
        improved = improved | win
        w_row = torch.where(win, cl[c_first] * k + row, w_row)
        w_u = torch.where(win, u[lane, flat], w_u)
        w_v = torch.where(win, v[lane, flat], w_v)
    return t_best, improved, w_row, w_u, w_v


def _resolve(ia, rows, u, v, inst_rows):
    """The winner's material, world normal and texture coordinates from its
    pack row (make_cluster_opener.resolve with pallas_inst._lane_finish):
    the 12-bit shading normal where the mesh packs one, the instance's
    material override, sign(det) R^T on geometric normals and R^T alone on
    interpolated ones."""
    pack = ia.tri_pack.reshape(-1, ia.tri_pack.shape[-1])
    w = pack[rows]
    nx, ny, nz = w[:, 9], w[:, 10], w[:, 11]
    geom = torch.ones_like(u, dtype=torch.bool)
    if w.shape[1] > 24:
        p = [w[:, 19 + k] for k in range(5)]
        allz = (p[0] + p[1] + p[2] + p[3] + p[4]) <= 0.0

        def split(x):
            h = torch.floor(x * (1.0 / 4096.0))
            return h, x - h * 4096.0

        def dq(q):
            return (q - 1.0) * _NS_STEP - 2.0

        n0x, n0y = split(p[0])
        n0z, d1x = split(p[1])
        d1y, d1z = split(p[2])
        d2x, d2y = split(p[3])
        d2z, _ = split(p[4])
        snx = dq(n0x) + u * dq(d1x) + v * dq(d2x)
        sny = dq(n0y) + u * dq(d1y) + v * dq(d2y)
        snz = dq(n0z) + u * dq(d1z) + v * dq(d2z)
        geom = allz | (snx * snx + sny * sny + snz * snz <= 1e-12)
        nx = torch.where(geom, nx, snx)
        ny = torch.where(geom, ny, sny)
        nz = torch.where(geom, nz, snz)
    mat = w[:, 12].to(torch.int32)
    r = inst_rows
    mat_ov = r[:, 13].to(torch.int32)
    s = torch.where(geom, r[:, 14], 1.0)
    mat = torch.where(mat_ov >= 0, mat_ov, mat)
    normal = (s * (r[:, 0] * nx + r[:, 3] * ny + r[:, 6] * nz),
              s * (r[:, 1] * nx + r[:, 4] * ny + r[:, 7] * nz),
              s * (r[:, 2] * nx + r[:, 5] * ny + r[:, 8] * nz))
    uvx = w[:, 13] + u * w[:, 15] + v * w[:, 17]
    uvy = w[:, 14] + u * w[:, 16] + v * w[:, 18]
    return mat, normal, uvx, uvy


def _sphere_pass(scene, o: Vec3, d: Vec3, tmin, tmax, best, kind, mat, a,
                 rinv):
    """pallas_trace._sphere_pass_closest: each sphere in turn, strict t <
    best."""
    for i in range(scene.num_spheres):
        c = scene.sph_center[i]
        rad = scene.sph_radius[i]
        ocx, ocy, ocz = o.x - c[0], o.y - c[1], o.z - c[2]
        b = ocx * d.x + ocy * d.y + ocz * d.z
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where((t0 > tmin) & (t0 < tmax), t0, t1)
        ok = (disc > 0.0) & (rad > 0.0) & (t > tmin) & (t < tmax) & (t < best)
        best = torch.where(ok, t, best)
        mat = torch.where(ok, scene.sph_mat[i], mat)
        kind = torch.where(ok, isect.KIND_SPHERE, kind)
        a = [torch.where(ok, c[k], a[k]) for k in range(3)]
        rinv = torch.where(ok, 1.0 / torch.clamp(rad, min=1e-12), rinv)
    return best, kind, mat, a, rinv


def _next_instance(ia, o: Vec3, inv: Vec3, tmin, bound, last_tn, last_id):
    """pallas_inst._next_inst: each lane's nearest crossed instance strictly
    after its cursor in (tnear, id) order; id -1 where none is left."""
    tnear, tfar = _slab(ia.inst_lo, ia.inst_hi, o, inv, tmin, bound)
    ids = torch.arange(ia.num_instances, device=o.x.device)[:, None]
    ok = (tnear <= tfar) & ((tnear > last_tn[None])
                            | ((tnear == last_tn[None]) & (ids > last_id[None])))
    cand = torch.where(ok, tnear, _BIG)
    cur_tn = cand.amin(0)
    first = torch.argmax((ok & (tnear == cur_tn[None])).to(torch.uint8), 0)
    has = cur_tn < _BIG
    return cur_tn, torch.where(has, first, -1)


def inst_closest_hit_reference(ia, scene, o: Vec3, d: Vec3, tmin=0.0,
                               tmax=math.inf) -> isect.HitV:
    """Plain version of inst_closest_hit: the kernel's rounds in PyTorch."""
    tmax = torch.clamp(isect._lane_tmax(tmax, o), max=_BIG)
    n, dev = o.x.shape[0], o.x.device
    best = torch.full((n,), _BIG, device=dev)
    kind = torch.zeros(n, dtype=torch.int32, device=dev)
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros(n, device=dev)
    a, rinv = [zero, zero, zero], zero
    uvx = uvy = zero
    best, kind, mat, a, rinv = _sphere_pass(scene, o, d, tmin, tmax, best,
                                            kind, mat, a, rinv)
    inv = Vec3(_inv_dir(d.x), _inv_dir(d.y), _inv_dir(d.z))
    last_tn = torch.full((n,), -_BIG, device=dev)
    last_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    mesh_of = ia.inst[:, 12].to(torch.int64)
    while True:
        cur_tn, cur_id = _next_instance(ia, o, inv, tmin,
                                        torch.minimum(tmax, best), last_tn,
                                        last_id)
        has = cur_id >= 0
        if not bool(has.any()):
            break
        lane_mesh = torch.where(has, mesh_of[cur_id.clamp(min=0)], -1)
        for m in range(ia.num_meshes):
            lanes = torch.nonzero(lane_mesh == m).flatten()
            if lanes.numel() == 0:
                continue
            rows = ia.inst[cur_id[lanes]]
            oo, dd = _xform(rows, Vec3(*(c[lanes] for c in o)),
                            Vec3(*(c[lanes] for c in d)))
            t_m, won, w_row, w_u, w_v = _mesh_closest(
                ia, m, oo, dd, tmin, tmax[lanes], best[lanes])
            wl = lanes[won]
            if wl.numel() == 0:
                continue
            wmat, wn, wu, wv = _resolve(ia, w_row[won], w_u[won], w_v[won],
                                        rows[won])
            best[wl] = t_m[won]
            kind[wl] = isect.KIND_TRIANGLE
            mat[wl] = wmat
            a = [ak.index_put((wl,), wk) for ak, wk in zip(a, wn)]
            uvx = uvx.index_put((wl,), wu)
            uvy = uvy.index_put((wl,), wv)
        last_tn = torch.where(has, cur_tn, last_tn)
        last_id = torch.where(has, cur_id, last_id)
    # closest_epilogue: sphere normals from the world ray
    is_sph = kind == isect.KIND_SPHERE
    normal = Vec3(*(torch.where(is_sph, (oc + best * dc - ac) * rinv, ac)
                    for oc, dc, ac in zip(o, d, a)))
    t = torch.where(kind != isect.KIND_MISS, best, math.inf)
    textured = scene.textures is not None
    return isect.HitV(t=t, normal=normal, mat_id=mat, kind=kind,
                      uvx=uvx if textured else None,
                      uvy=uvy if textured else None)


def inst_any_hit_reference(ia, scene, o: Vec3, d: Vec3, tmin=0.0,
                           tmax=math.inf) -> torch.Tensor:
    """Plain version of inst_any_hit: empty intervals, then the spheres,
    then every crossed instance's BLAS rows in object space."""
    tmax = torch.clamp(isect._lane_tmax(tmax, o), max=_BIG)
    blocked = tmax <= tmin
    if scene.num_spheres:
        t = isect._sph_chunk_test(o, d, scene.sph_center, scene.sph_radius,
                                  tmin, tmax)
        blocked = blocked | torch.isfinite(t).any(1)
    inv = Vec3(_inv_dir(d.x), _inv_dir(d.y), _inv_dir(d.z))
    tnear, tfar = _slab(ia.inst_lo, ia.inst_hi, o, inv, tmin, tmax)
    crossed = tnear <= tfar
    k = ia.cluster_size
    pack = ia.tri_pack.reshape(-1, ia.tri_pack.shape[-1])
    for i in range(ia.num_instances):
        lanes = torch.nonzero(crossed[i] & ~blocked).flatten()
        if lanes.numel() == 0:
            continue
        row = ia.inst[i:i + 1].expand(lanes.numel(), 16)
        oo, dd = _xform(row, Vec3(*(c[lanes] for c in o)),
                        Vec3(*(c[lanes] for c in d)))
        mesh = int(ia.inst[i, 12])
        clusters = _real_clusters(ia, mesh) + mesh * ia.cmax
        rows = (clusters[:, None] * k
                + torch.arange(k, device=clusters.device)).reshape(-1)
        step = max(k, _BLOCK_ELEMS // max(lanes.numel(), 1) // k * k)
        hit = torch.zeros(lanes.numel(), dtype=torch.bool, device=o.x.device)
        for r0 in range(0, rows.numel(), step):
            ok = _pack_test(pack[rows[r0:r0 + step]], oo, dd, tmin,
                            tmax[lanes])[0]
            hit = hit | ok.any(1)
        blocked = blocked.index_put((lanes,), hit | blocked[lanes])
    return blocked


# --- launches ----------------------------------------------------------------------

def _rays_in(o: Vec3, d: Vec3, tmax):
    """Checked ray planes and the per-lane tmax for a launch."""
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
    return [*o, *d, tmax]


def _bits(t):
    return t.to(torch.int32).contiguous().view(torch.float32).reshape(-1)


def _sph_rows(scene) -> torch.Tensor:
    return torch.cat([scene.sph_center, scene.sph_radius.reshape(-1, 1),
                      _bits(scene.sph_mat).reshape(-1, 1)], 1).reshape(-1)


def visit_keys(okey: torch.Tensor) -> torch.Tensor:
    """(rows, C) int32 octant keys -> the same visit order as keys whose
    ranks are 0..C-1 in every row, as the kernels' order tables need: the
    trimmed BLAS rows keep the ranks of their padded build and give the
    padding clusters rank = id, so their ranks repeat."""
    okey = okey.reshape(okey.shape[0], -1)
    ids = torch.sort(okey, dim=1).values & 0xFFFF
    ranks = torch.arange(okey.shape[1], dtype=torch.int32,
                         device=okey.device)
    return (ranks[None] << 16) | ids


def inst_rows(ia) -> torch.Tensor:
    """(I, INST_WORDS) float32: world box lo | hi | the instance row."""
    return torch.cat([ia.inst_lo, ia.inst_hi, ia.inst], 1)


def is_stream(accel) -> bool:
    """Whether the accel is past the resident tier, so that the stream
    tracer traces it (intersect._trace_module's gate, intersect.py:460-479)."""
    return accel.num_clusters * accel.cluster_size > bvh.MAX_RESIDENT_TRIS


def _resident_inputs(accel, scene):
    if is_stream(accel):
        raise ValueError(
            f"{accel.num_clusters} clusters of {accel.cluster_size} are past "
            f"MAX_RESIDENT_TRIS={bvh.MAX_RESIDENT_TRIS}: the stream tracer "
            "(stream_closest_hit / stream_any_hit) traces this accel")
    tables = torch.cat([
        _sph_rows(scene),
        torch.cat([accel.cluster_lo, accel.cluster_hi], 1).reshape(-1),
        _bits(accel.cl_okey)])
    pack = accel.tri_pack.contiguous()
    return tables, pack, (accel.num_clusters, accel.cluster_size, 0, 1)


def _inst_inputs(ia, scene):
    m = ia.num_meshes
    tables = torch.cat([
        _sph_rows(scene),
        torch.cat([ia.blas_lo, ia.blas_hi], 2).reshape(-1),
        inst_rows(ia).reshape(-1),
        _bits(visit_keys(ia.blas_okey.reshape(8 * m, ia.cmax)))])
    pack = ia.tri_pack.contiguous()
    return tables, pack, (m * ia.cmax, ia.cluster_size, ia.num_instances, m)


def super_boxes(accel) -> torch.Tensor:
    """(G, 6) float32: the supercluster boxes lo | hi."""
    return torch.cat([accel.sup_lo, accel.sup_hi], 1)


def stream_globals(accel):
    """(cluster boxes (C, 6) float32 lo | hi, cl_order (8, C) int16): the
    stream kernels' tables in global memory.  Raises unless the accel's
    clusters fill whole superclusters within the 16-bit ids."""
    c = accel.num_clusters
    if c > bvh.MAX_STREAM_CLUSTERS or accel.sup_lo.shape[0] * bvh.SUPER_FAN != c:
        raise ValueError(f"{c} clusters: the stream tracer takes a multiple "
                         f"of {bvh.SUPER_FAN} up to "
                         f"MAX_STREAM_CLUSTERS={bvh.MAX_STREAM_CLUSTERS}")
    return (torch.cat([accel.cluster_lo, accel.cluster_hi], 1).contiguous(),
            accel.cl_order.contiguous())


def _stream_inputs(accel, scene):
    """The stream tracer's shared tables (spheres, super boxes, sup_okey),
    tri_pack, and (G, K, cluster boxes, cl_order) with the global tables
    as pointers; the tensors behind the pointers ride in `dims`' tail."""
    tables = torch.cat([_sph_rows(scene), super_boxes(accel).reshape(-1),
                        _bits(accel.sup_okey)])
    cbox, corder = stream_globals(accel)
    pack = accel.tri_pack.contiguous()
    return tables, pack, (accel.sup_lo.shape[0], accel.cluster_size,
                          cbox.data_ptr(), corder.data_ptr()), (cbox, corder)


def shared_bytes(tables: torch.Tensor, n_clusters: int,
                 in_global: bool = False) -> int:
    """Dynamic shared memory of a tracer's block (csrc/spt_common.cuh
    smem_bytes): the packed `tables` (not in the global placement), the
    visit orders of `n_clusters` boxes, the warps' staging buffers."""
    return cuda_lib.shared_bytes(
        (0 if in_global else 4 * tables.numel()) + 2 * 8 * n_clusters, True)


def tables_in_global(tables: torch.Tensor, n_clusters: int) -> bool:
    """Whether a tracer reads its packed `tables` from global memory:
    whether a block's shared copy passes cuda_lib.MAX_SHARED_BYTES, as
    with some 2 500 instances (22 words each) or 11 000 spheres beside a
    mesh (``cuda_lib.tables_in_global``)."""
    return cuda_lib.tables_in_global(shared_bytes(tables, n_clusters), True)


def _placement(tables, dims, in_global) -> bool:
    return (tables_in_global(tables, dims[0]) if in_global is None
            else bool(in_global))


def _closest(what, fn, tables, pack, dims, scene, o, d, tmin, tmax,
             in_global):
    device = o.x.device
    rays = _rays_in(o, d, tmax)
    n = o.x.shape[0]
    out_f = [torch.empty(n, dtype=torch.float32, device=device)
             for _ in range(4)]
    out_i = [torch.empty(n, dtype=torch.int32, device=device)
             for _ in range(2)]
    uv = ([torch.empty(n, dtype=torch.float32, device=device)
           for _ in range(2)] if scene.textures is not None else [])
    uv_ptrs = [t.data_ptr() for t in uv] or [None, None]
    tables = tables.contiguous()
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in rays + out_f + out_i), *uv_ptrs,
                 tables.data_ptr(), scene.num_spheres, pack.data_ptr(),
                 pack.shape[-1], *dims, int(in_global), n, float(tmin),
                 cuda_lib.stream_of(device))
    cuda_lib.check(err, what)
    t, nx, ny, nz = out_f
    return isect.HitV(t=t, normal=Vec3(nx, ny, nz), mat_id=out_i[0],
                      kind=out_i[1], uvx=uv[0] if uv else None,
                      uvy=uv[1] if uv else None)


def _any(what, fn, tables, pack, dims, scene, o, d, tmin, tmax, in_global):
    device = o.x.device
    rays = _rays_in(o, d, tmax)
    n = o.x.shape[0]
    blocked = torch.empty(n, dtype=torch.bool, device=device)
    tables = tables.contiguous()
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in rays), blocked.data_ptr(),
                 tables.data_ptr(), scene.num_spheres, pack.data_ptr(),
                 pack.shape[-1], *dims, int(in_global), n, float(tmin),
                 cuda_lib.stream_of(device))
    cuda_lib.check(err, what)
    return blocked


def _device_of(o: Vec3, what: str):
    device = o.x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {device}")
    return device


def closest_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                tmax=math.inf, *, _in_global=None) -> isect.HitV:
    """Closest hit of every lane against the spheres and the clusters.
    `_in_global` forces a placement of the tables on the card
    (``tables_in_global`` decides otherwise); no entry point passes it."""
    global CLOSEST_LAUNCHES, CLOSEST_GLOBAL_LAUNCHES
    if _device_of(o, "closest_hit").type == "cpu":
        return closest_hit_reference(accel, scene, o, d, tmin, tmax)
    tables, pack, dims = _resident_inputs(accel, scene)
    glob = _placement(tables, dims, _in_global)
    hit = _closest("closest_hit", cuda_lib.build().spt_closest_hit, tables,
                   pack, dims, scene, o, d, tmin, tmax, glob)
    if glob:
        CLOSEST_GLOBAL_LAUNCHES += 1
    else:
        CLOSEST_LAUNCHES += 1
    return hit


def any_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
            tmax=math.inf, *, _in_global=None) -> torch.Tensor:
    """Whether anything blocks each lane's ray within (tmin, tmax)."""
    global ANY_LAUNCHES, ANY_GLOBAL_LAUNCHES
    if _device_of(o, "any_hit").type == "cpu":
        return any_hit_reference(accel, scene, o, d, tmin, tmax)
    tables, pack, dims = _resident_inputs(accel, scene)
    glob = _placement(tables, dims, _in_global)
    blocked = _any("any_hit", cuda_lib.build().spt_any_hit, tables, pack,
                   dims, scene, o, d, tmin, tmax, glob)
    if glob:
        ANY_GLOBAL_LAUNCHES += 1
    else:
        ANY_LAUNCHES += 1
    return blocked


def inst_closest_hit(ia, scene, o: Vec3, d: Vec3, tmin=0.0,
                     tmax=math.inf, *, _in_global=None) -> isect.HitV:
    """Closest hit of every lane against the spheres and the instances."""
    global INST_CLOSEST_LAUNCHES, INST_CLOSEST_GLOBAL_LAUNCHES
    if _device_of(o, "inst_closest_hit").type == "cpu":
        return inst_closest_hit_reference(ia, scene, o, d, tmin, tmax)
    tables, pack, dims = _inst_inputs(ia, scene)
    glob = _placement(tables, dims, _in_global)
    hit = _closest("inst_closest_hit", cuda_lib.build().spt_inst_closest_hit,
                   tables, pack, dims, scene, o, d, tmin, tmax, glob)
    if glob:
        INST_CLOSEST_GLOBAL_LAUNCHES += 1
    else:
        INST_CLOSEST_LAUNCHES += 1
    return hit


def inst_any_hit(ia, scene, o: Vec3, d: Vec3, tmin=0.0,
                 tmax=math.inf, *, _in_global=None) -> torch.Tensor:
    """Whether anything blocks each lane's ray within (tmin, tmax), through
    the instances."""
    global INST_ANY_LAUNCHES, INST_ANY_GLOBAL_LAUNCHES
    if _device_of(o, "inst_any_hit").type == "cpu":
        return inst_any_hit_reference(ia, scene, o, d, tmin, tmax)
    tables, pack, dims = _inst_inputs(ia, scene)
    glob = _placement(tables, dims, _in_global)
    blocked = _any("inst_any_hit", cuda_lib.build().spt_inst_any_hit, tables,
                   pack, dims, scene, o, d, tmin, tmax, glob)
    if glob:
        INST_ANY_GLOBAL_LAUNCHES += 1
    else:
        INST_ANY_LAUNCHES += 1
    return blocked


def stream_closest_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                       tmax=math.inf, *, _in_global=None) -> isect.HitV:
    """Closest hit of every lane against the spheres and the clusters of a
    stream-tier accel."""
    global STREAM_CLOSEST_LAUNCHES, STREAM_CLOSEST_GLOBAL_LAUNCHES
    if _device_of(o, "stream_closest_hit").type == "cpu":
        return closest_hit_reference(accel, scene, o, d, tmin, tmax)
    tables, pack, dims, keep = _stream_inputs(accel, scene)
    glob = _placement(tables, dims, _in_global)
    hit = _closest("stream_closest_hit",
                   cuda_lib.build().spt_stream_closest_hit, tables, pack, dims,
                   scene, o, d, tmin, tmax, glob)
    del keep
    if glob:
        STREAM_CLOSEST_GLOBAL_LAUNCHES += 1
    else:
        STREAM_CLOSEST_LAUNCHES += 1
    return hit


def stream_any_hit(accel, scene, o: Vec3, d: Vec3, tmin=0.0,
                   tmax=math.inf, *, _in_global=None) -> torch.Tensor:
    """Whether anything blocks each lane's ray within (tmin, tmax), through
    a stream-tier accel."""
    global STREAM_ANY_LAUNCHES, STREAM_ANY_GLOBAL_LAUNCHES
    if _device_of(o, "stream_any_hit").type == "cpu":
        return any_hit_reference(accel, scene, o, d, tmin, tmax)
    tables, pack, dims, keep = _stream_inputs(accel, scene)
    glob = _placement(tables, dims, _in_global)
    blocked = _any("stream_any_hit", cuda_lib.build().spt_stream_any_hit,
                   tables, pack, dims, scene, o, d, tmin, tmax, glob)
    del keep
    if glob:
        STREAM_ANY_GLOBAL_LAUNCHES += 1
    else:
        STREAM_ANY_LAUNCHES += 1
    return blocked
