"""Mesh acceleration for the resident and stream tiers: the cluster build.

The counterpart of ``spt_tpu.ops.bvh`` (copied and adapted, numpy host
code): order the triangles by a recursive longest-axis object-median split
with cluster-aligned cuts (``_split_order``), cut the order into clusters of
``cluster_size`` triangles, store one AABB per cluster, a supercluster level
over ``SUPER_FAN`` consecutive clusters, and per ray-direction octant the
clusters' front-to-back visit keys.  ``tri_pack`` holds the same triangles
in one dense row per triangle for the tracers
(``csrc/spt_tracers.cuh`` reads it from global memory), and ``cl_order``
each supercluster's clusters in front-to-back order per octant, the table
the stream tier walks inside an opened supercluster.

The build runs in the native host library (``io/native``:
``native/spt_native.cpp``'s ``spt_split_build``, as the JAX package's
does) when ``g++`` can build it, else in numpy (``_cluster_build_numpy``);
the two give bit-identical tables, so both packages trace the same
clusters.  ``build_inst_accel`` builds the instanced
TLAS/BLAS pair (``InstAccel``) over the same per-mesh cluster tables.  Not
ported: the 128-padded ``tri_stream`` copy the JAX package builds beyond
``MAX_RESIDENT_TRIS`` (a Mosaic DMA-alignment device; the card's stream
tracer reads ``tri_pack`` where it lies) and the ``SPT_CLUSTER=morton``
build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spt_tpu_torch.io import native

# Clusters per supercluster (the DMA granule of the JAX package's streaming
# tier); cluster counts are padded to a multiple of it.
SUPER_FAN = 16

# tri_pack width with shading normals: cols 19-23 hold [n0 | n1-n0 | n2-n0]
# quantized to 12 bits, two fields per column (encode_ns).  Without them the
# width is 24.
PACK_NS = 25

# 12-bit packed shading normals: each column holds q_hi * 4096 + q_lo with q
# in [1, 4095], exact in float32; q = 1 + round((v + 2) / NS_STEP) quantizes
# [-2, 2].  All-zero planes mark a triangle without vertex normals.
NS_FIELDS = ((0, 1), (2, 3), (4, 5), (6, 7), (8, None))
NS_STEP = np.float32(4.0 / 4094.0)

# Largest triangle table the resident tracer takes; past it the stream
# tier traces the accel.
MAX_RESIDENT_TRIS = 12288
# Clusters the stream tier takes: the 16-bit id / 15-bit rank packing of
# the octant keys (spt_tpu/ops/pallas_bounce.py:74).
MAX_STREAM_CLUSTERS = 1 << 14


def encode_ns(ns: np.ndarray) -> np.ndarray:
    """(T, 9) float shading normals -> (T, 5) packed planes (NS_FIELDS
    layout); all-zero rows stay all-zero."""
    ns = np.asarray(ns, np.float32).reshape(-1, 9)
    q = (1.0 + np.round((np.clip(ns, -2.0, 2.0) + np.float32(2.0))
                        / NS_STEP)).astype(np.float32)
    out = np.zeros((ns.shape[0], 5), np.float32)
    for c, (hi, lo) in enumerate(NS_FIELDS):
        v = q[:, hi] * np.float32(4096.0)
        if lo is not None:
            v = v + q[:, lo]
        out[:, c] = v
    out[np.abs(ns).max(axis=1) == 0.0] = 0.0
    return out


def decode_ns(planes: np.ndarray) -> np.ndarray:
    """(T, 5) packed planes -> (T, 9) quantized shading normals: the float32
    ops the tracers' winner resolution runs, so every path shades with the
    same values.  All-zero rows stay zero."""
    planes = np.asarray(planes, np.float32).reshape(-1, 5)
    out = np.zeros((planes.shape[0], 9), np.float32)
    for c, (hi, lo) in enumerate(NS_FIELDS):
        h = np.floor(planes[:, c] * np.float32(1.0 / 4096.0)).astype(
            np.float32)
        out[:, hi] = (h - np.float32(1.0)) * NS_STEP - np.float32(2.0)
        if lo is not None:
            lq = planes[:, c] - h * np.float32(4096.0)
            out[:, lo] = (lq - np.float32(1.0)) * NS_STEP - np.float32(2.0)
    out[np.abs(planes).max(axis=1) == 0.0] = 0.0
    return out


def quantize_ns(ns: np.ndarray) -> np.ndarray:
    """Round-trip a (T, 9) shading-normal table through the 12-bit packing."""
    return decode_ns(encode_ns(ns))


class MeshAccel(NamedTuple):
    """Cluster-sorted triangle soup + per-cluster AABBs, as tensors."""

    cluster_lo: torch.Tensor  # (C, 3) float32; padding clusters inverted
    cluster_hi: torch.Tensor  # (C, 3)
    tri_v0: torch.Tensor      # (C*K, 3) cluster order, padded with degenerates
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_mat: torch.Tensor     # (C*K,) int32
    # (C, K, 24 | PACK_NS) float32: [v0 | e1 | e2 | cross(e1, e2) | mat |
    # uv0 duv1 duv2 | packed shading normals]
    tri_pack: torch.Tensor
    # (8, C, 1) int32: (front-to-back rank << 16) | cluster id per octant
    # (octant bit set = negative direction component: x 4, y 2, z 1)
    cl_okey: torch.Tensor
    sup_lo: torch.Tensor      # (G, 3)
    sup_hi: torch.Tensor      # (G, 3)
    sup_okey: torch.Tensor    # (8, G, 1)
    # (8, C) int16: per octant, each supercluster's SUPER_FAN local cluster
    # ids (0..15) in cl_okey's front-to-back order (cluster_visit_order)
    cl_order: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.cluster_lo.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_v0.shape[0] // self.cluster_lo.shape[0]


def cluster_visit_order(cl_okey) -> np.ndarray:
    """(8, C[, 1]) octant keys -> (8, C) int16: row o holds, for supercluster
    g at [g * SUPER_FAN, (g + 1) * SUPER_FAN), its clusters' local ids in the
    order pallas_stream's min-extraction opens them (lowest cl_okey first,
    :186-190)."""
    okey = np.asarray(cl_okey, np.int32).reshape(8, -1)
    g = okey.shape[1] // SUPER_FAN
    keys = np.sort(okey.reshape(8, g, SUPER_FAN), axis=2)
    local = (keys & 0xFFFF) - (np.arange(g, dtype=np.int32) * SUPER_FAN)[:, None]
    return local.reshape(8, g * SUPER_FAN).astype(np.int16)


def _split_order(lo: np.ndarray, hi: np.ndarray, cs: int) -> np.ndarray:
    """Recursive longest-axis object-median split -> triangle permutation;
    cut points land on cs multiples, so no cluster straddles a split plane
    (only the last cluster may be short).  Iterative stack, centroid keys."""
    centroid = 0.5 * (lo + hi)
    out = []
    stack = [np.arange(len(centroid))]
    while stack:
        idx = stack.pop()
        if len(idx) <= cs:
            out.append(idx)
            continue
        c = centroid[idx]
        ax = int((c.max(0) - c.min(0)).argmax())
        part = idx[np.argsort(c[:, ax], kind="stable")]
        n = len(idx)
        cut = (n + cs) // (2 * cs) * cs
        cut = min(max(cs, cut), (n - 1) // cs * cs)
        stack.append(part[cut:])
        stack.append(part[:cut])
    return np.concatenate(out)


def _octant_keys(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(8, B) int32 visit keys: boxes ranked front to back by centroid
    along each octant's sign vector (inverted boxes rank at centroid 0)."""
    b = lo.shape[0]
    cent = np.where(lo <= hi, 0.5 * (lo + hi), 0.0)
    keys = np.zeros((8, b), np.int32)
    ids = np.arange(b, dtype=np.int32)
    for o in range(8):
        sgn = np.array([-1.0 if (o >> 2) & 1 else 1.0,
                        -1.0 if (o >> 1) & 1 else 1.0,
                        -1.0 if o & 1 else 1.0])
        order = np.argsort(cent @ sgn, kind="stable")
        rank = np.empty(b, np.int32)
        rank[order] = ids
        keys[o] = (rank << 16) | ids
    return keys


def _cluster_build_numpy(v0, e1, e2, cluster_size: int):
    """The median-split build in numpy (spt_tpu/ops/bvh.py:459-487): (order,
    cluster lo, cluster hi), degenerate (padding) triangles last and out of
    the boxes."""
    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    degenerate = (np.abs(e1).sum(1) == 0) & (np.abs(e2).sum(1) == 0)
    real = np.nonzero(~degenerate)[0]
    if real.size:
        order = np.concatenate(
            [real[_split_order(lo[real], hi[real], cluster_size)],
             np.nonzero(degenerate)[0]])
    else:
        order = np.arange(v0.shape[0])
    los = np.where(degenerate[order][:, None], np.inf, lo[order])
    his = np.where(degenerate[order][:, None], -np.inf, hi[order])
    c = v0.shape[0] // cluster_size
    cl_lo = los.reshape(c, cluster_size, 3).min(1)
    cl_hi = his.reshape(c, cluster_size, 3).max(1)
    cl_lo = np.where(np.isfinite(cl_lo), cl_lo, 1e30).astype(np.float32)
    cl_hi = np.where(np.isfinite(cl_hi), cl_hi, -1e30).astype(np.float32)
    return order, cl_lo, cl_hi


def build_mesh_accel(v0, e1, e2, mat, cluster_size: int = 64, uv=None,
                     ns=None, device="cpu") -> MeshAccel:
    """Order triangles by the median split and cut them into clusters.

    `uv`: (T, 6) texture coordinates or None; `ns`: (T, 9) shading normals
    [n0 | n1-n0 | n2-n0] or None (flat shading: tri_pack is 24 wide)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    mat = np.asarray(mat, np.int32)
    t = v0.shape[0]
    uv = (np.zeros((t, 6), np.float32) if uv is None
          else np.asarray(uv, np.float32).reshape(t, 6))
    with_ns = ns is not None
    if with_ns:
        ns = np.asarray(ns, np.float32).reshape(t, 9)

    pad = (-t) % cluster_size
    if pad:
        z = np.zeros((pad, 3), np.float32)
        v0 = np.concatenate([v0, z])
        e1 = np.concatenate([e1, z])
        e2 = np.concatenate([e2, z])
        mat = np.concatenate([mat, np.zeros(pad, np.int32)])
        uv = np.concatenate([uv, np.zeros((pad, 6), np.float32)])
        if with_ns:
            ns = np.concatenate([ns, np.zeros((pad, 9), np.float32)])

    built = native.cluster_build(v0, e1, e2, cluster_size)
    if built is not None:
        order, cl_lo, cl_hi = built
    else:
        order, cl_lo, cl_hi = _cluster_build_numpy(v0, e1, e2, cluster_size)

    v0s, e1s, e2s, mats, uvs = (v0[order], e1[order], e2[order], mat[order],
                                uv[order])
    nss = ns[order] if with_ns else None

    # pad the cluster count to a SUPER_FAN multiple with inverted boxes
    pad_c = (-cl_lo.shape[0]) % SUPER_FAN
    if pad_c:
        cl_lo = np.concatenate([cl_lo, np.full((pad_c, 3), 1e30, np.float32)])
        cl_hi = np.concatenate([cl_hi, np.full((pad_c, 3), -1e30, np.float32)])
        zt = np.zeros((pad_c * cluster_size, 3), np.float32)
        v0s = np.concatenate([v0s, zt])
        e1s = np.concatenate([e1s, zt])
        e2s = np.concatenate([e2s, zt])
        mats = np.concatenate([mats, np.zeros(pad_c * cluster_size, np.int32)])
        uvs = np.concatenate(
            [uvs, np.zeros((pad_c * cluster_size, 6), np.float32)])
        if with_ns:
            nss = np.concatenate(
                [nss, np.zeros((pad_c * cluster_size, 9), np.float32)])

    c_total = cl_lo.shape[0]
    if c_total > MAX_STREAM_CLUSTERS:
        raise ValueError(f"{c_total} clusters overflow the 16-bit id / "
                         "15-bit rank packing")
    cl_okey = _octant_keys(cl_lo, cl_hi)

    pack_w = PACK_NS if with_ns else 24
    pack = np.zeros((c_total * cluster_size, pack_w), np.float32)
    pack[:, 0:3] = v0s
    pack[:, 3:6] = e1s
    pack[:, 6:9] = e2s
    pack[:, 9:12] = np.cross(e1s, e2s)  # geometric normal, unnormalized
    pack[:, 12] = mats.astype(np.float32)
    pack[:, 13:19] = uvs
    if with_ns:
        pack[:, 19:24] = encode_ns(nss)
    pack = pack.reshape(c_total, cluster_size, pack_w)

    g_total = c_total // SUPER_FAN
    sup_lo = cl_lo.reshape(g_total, SUPER_FAN, 3).min(1).astype(np.float32)
    sup_hi = cl_hi.reshape(g_total, SUPER_FAN, 3).max(1).astype(np.float32)
    sup_okey = _octant_keys(sup_lo, sup_hi)

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MeshAccel(
        cluster_lo=t_(cl_lo), cluster_hi=t_(cl_hi),
        tri_v0=t_(v0s), tri_e1=t_(e1s), tri_e2=t_(e2s), tri_mat=t_(mats),
        tri_pack=t_(pack),
        cl_okey=t_(cl_okey.reshape(8, c_total, 1)),
        sup_lo=t_(sup_lo), sup_hi=t_(sup_hi),
        sup_okey=t_(sup_okey.reshape(8, g_total, 1)),
        cl_order=t_(cluster_visit_order(cl_okey)),
    )


class InstAccel(NamedTuple):
    """Two-level instanced acceleration: a TLAS of instance boxes over
    shared per-mesh BLAS cluster tables (spt_tpu.ops.bvh.InstAccel, every
    array as the JAX package builds it).  Rays transform into each crossed
    instance's object space (directions unnormalized, so t stays world t)
    and walk that mesh's clusters."""

    blas_lo: torch.Tensor    # (M, CMAX, 3) object-space cluster boxes
    blas_hi: torch.Tensor    # (M, CMAX, 3); padding clusters inverted
    # (8*M, CMAX, 1) int32 (rank << 16) | local cluster id, row
    # octant * M + mesh; the ranks of a trimmed BLAS need not be 0..CMAX-1
    blas_okey: torch.Tensor
    tri_pack: torch.Tensor   # (M*CMAX, K, 24 | PACK_NS) object space
    inst_lo: torch.Tensor    # (I, 3) world-space instance boxes
    inst_hi: torch.Tensor    # (I, 3)
    inst_okey: torch.Tensor  # (8, I, 1) int32 (rank << 16) | instance id
    # (I, 16) float32: [R_ofw row-major 0:9 | t_ofw 9:12 | mesh 12 |
    # material override or -1 13 | sign(det) 14 | 0 15]
    inst: torch.Tensor

    @property
    def num_instances(self) -> int:
        return self.inst.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.blas_lo.shape[0]

    @property
    def cmax(self) -> int:
        return self.blas_lo.shape[1]

    @property
    def cluster_size(self) -> int:
        return self.tri_pack.shape[1]


def build_inst_accel(meshes, instances, cluster_size: int = 64,
                     device="cpu") -> InstAccel:
    """The TLAS/BLAS pair from object-space meshes and transforms
    (spt_tpu/ops/bvh.py:234-345).

    `meshes`: (v0, e1, e2, mat, uv[, ns]) object-space arrays per mesh (uv
    (T, 6) or None, ns (T, 9) or None); `instances`: (mesh index,
    world_from_object (4, 4), material override or -1).  Each BLAS is
    trimmed to its real clusters and padded to CMAX with inverted boxes;
    instance boxes are the object box through the affine map by interval
    arithmetic.  Raises ValueError for a singular transform or more than
    16384 instances (the caller then declines to the flattened path)."""
    meshes = [m if len(m) >= 6 else tuple(m) + (None,) for m in meshes]
    any_ns = any(m[5] is not None for m in meshes)
    blas = [build_mesh_accel(
        v0, e1, e2, mat, cluster_size=cluster_size, uv=uv,
        ns=(ns if ns is not None
            else (np.zeros((v0.shape[0], 9), np.float32) if any_ns
                  else None)))
            for (v0, e1, e2, mat, uv, ns) in meshes]
    real_c = [-(-m[0].shape[0] // cluster_size) for m in meshes]
    cmax = max(real_c)
    k = cluster_size
    m_count = len(blas)

    lo = np.full((m_count, cmax, 3), 1e30, np.float32)
    hi = np.full((m_count, cmax, 3), -1e30, np.float32)
    okey = np.zeros((8, m_count, cmax), np.int32)
    pack_w = PACK_NS if any_ns else 24
    pack = np.zeros((m_count * cmax, k, pack_w), np.float32)
    obj_lo = np.zeros((m_count, 3), np.float32)
    obj_hi = np.zeros((m_count, 3), np.float32)
    pad_ids = np.arange(cmax, dtype=np.int32)
    for mi, b in enumerate(blas):
        c = real_c[mi]
        lo[mi, :c] = b.cluster_lo.numpy()[:c]
        hi[mi, :c] = b.cluster_hi.numpy()[:c]
        okey[:, mi, :] = (pad_ids << 16) | pad_ids
        okey[:, mi, :c] = b.cl_okey.numpy().reshape(8, -1)[:, :c]
        pack[mi * cmax:mi * cmax + c] = b.tri_pack.numpy()[:c]
        valid = lo[mi, :, 0] <= hi[mi, :, 0]
        if valid.any():
            obj_lo[mi] = lo[mi, valid].min(0)
            obj_hi[mi] = hi[mi, valid].max(0)

    i_count = len(instances)
    if i_count > (1 << 14):
        raise ValueError(f"{i_count} instances overflow the 16-bit id / "
                         "15-bit rank packing")
    inst_lo = np.zeros((i_count, 3), np.float32)
    inst_hi = np.zeros((i_count, 3), np.float32)
    inst = np.zeros((i_count, 16), np.float32)
    for ii, (mesh_idx, xf, mat_ov) in enumerate(instances):
        xf = np.asarray(xf, np.float64).reshape(4, 4)
        det = np.linalg.det(xf[:3, :3])
        if abs(det) < 1e-12:
            raise ValueError(f"instance {ii}: singular world_from_object "
                             "(det ~ 0)")
        ofw = np.linalg.inv(xf)
        inst[ii, 0:9] = ofw[:3, :3].reshape(9)
        inst[ii, 9:12] = ofw[:3, 3]
        inst[ii, 12] = mesh_idx
        inst[ii, 13] = mat_ov
        inst[ii, 14] = 1.0 if det > 0 else -1.0
        r_wfo = xf[:3, :3]
        t_wfo = xf[:3, 3]
        a = r_wfo * obj_lo[mesh_idx][None, :]
        b2 = r_wfo * obj_hi[mesh_idx][None, :]
        inst_lo[ii] = (t_wfo + np.minimum(a, b2).sum(1)).astype(np.float32)
        inst_hi[ii] = (t_wfo + np.maximum(a, b2).sum(1)).astype(np.float32)

    # instance boxes are never inverted: the cluster keys' ranking applies
    inst_okey = _octant_keys(inst_lo, inst_hi)

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return InstAccel(
        blas_lo=t_(lo), blas_hi=t_(hi),
        blas_okey=t_(okey.reshape(8 * m_count, cmax, 1)),
        tri_pack=t_(pack),
        inst_lo=t_(inst_lo), inst_hi=t_(inst_hi),
        inst_okey=t_(inst_okey.reshape(8, i_count, 1)),
        inst=t_(inst),
    )
