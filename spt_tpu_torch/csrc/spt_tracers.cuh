// The four tracers the kernels are templated on.  Each answers
//   int  closest(o, d, tmin, tmax, t, mat, normal, u, v) -> kind (0 miss, 1 tri, 2 sphere)
//   bool occluded(o, d, tmin, tmax)
// for one ray per thread; (u, v) are the hit's interpolated texture
// coordinates (0 where no triangle won).
//
// - RolledTracer: the small-scene brute force over the triangle and sphere
//   tables in shared memory (ops/intersect.py, unrolled semantics).
// - ClusterTracer: the resident cluster tracer, the counterpart of
//   spt_tpu/ops/pallas_trace.py closest_hit_tile / any_hit_tile
//   (:497-669).  The TPU tests every cluster box against a whole ray
//   subtile in one broadcast pass and opens the union; here each thread
//   walks the clusters in its own direction octant's front-to-back order
//   (the octant keys of bvh.MeshAccel.cl_okey), slab-tests each box against
//   min(tmax, best_t) with _box_flags' arithmetic (:75-107) and opens a box
//   it hits: Moller-Trumbore over the cluster's rows of tri_pack in
//   _tri_sub_test's formulation (:220-248).  The octant is the thread's
//   own, not the subtile's; that changes only the visit order, and so only
//   which triangle wins an exact tie in t.  Within a cluster the winner
//   follows tri_block_min (:262-312): the lowest t, ties to the highest row
//   of an 8-row sub-block, strict across sub-blocks; across clusters strict
//   t < best (spheres, tested first, win ties).  The shading normal decodes
//   the 12-bit columns 19-23 exactly as bvh.decode_ns; the texture
//   coordinates interpolate columns 13-18 (make_cluster_opener.resolve).
// - InstTracer: the instanced TLAS/BLAS tracer (K7), the counterpart of
//   spt_tpu/ops/pallas_inst.py inst_closest_tile_rounds / inst_any_tile_rounds
//   (:306, :483).  One thread walks its own crossed instances front to back
//   in the (tnear, id) order of _next_inst (:199-238): each round rescans the
//   instance boxes against min(tmax, best) for the nearest one strictly
//   after the thread's cursor, so the cursor advances every round and the
//   walk ends after at most I rounds.  The ray goes into the instance's
//   object space unnormalized (_xform_rays :72-86: t stays world t), walks
//   that mesh's BLAS clusters with the ClusterTracer's loop in its own
//   object-space octant's order, and a win takes _lane_finish (:284-303):
//   the material override, sign(det) R^T on geometric normals, R^T alone on
//   interpolated ones.  The TPU's per-instance union scheme, its bounce-0
//   union hybrid and its per-round mesh serialisation are tile devices and
//   are not ported; any-hit visits the crossed instances in id order, which
//   cannot change a flag.
// - StreamTracer: the two-level tracer of meshes past the resident tier
//   (K8), the counterpart of spt_tpu/ops/pallas_stream.py
//   stream_closest_tile / stream_any_tile (:104, :250).  One thread walks
//   the supercluster boxes (one box over each kSuperFan consecutive
//   clusters) in its octant's front-to-back order (sup_okey), re-tests each
//   against min(tmax, best) when its turn comes (the TPU's recheck,
//   :211-217), and walks an opened super's 16 clusters with the
//   ClusterTracer's loop in the order of bvh.MeshAccel.cl_order (cl_okey's
//   order within the super).  The TPU streams each opened super's
//   128-padded triangle block HBM -> VMEM by DMA, double-buffered; on the
//   card the threads read tri_pack where it lies, through L2, so neither
//   the padded copy nor the DMA schedule is ported.  Only the super level
//   (G <= 1024 boxes and orders) sits in shared memory; the cluster boxes
//   (C * 24 B, up to 384 KiB) and orders stay in global memory.
//
// What bounds the mesh tracers: per-thread ALU (a cluster open is 64
// Moller-Trumbore tests) and the latency of tri_pack reads.  The boxes,
// instance rows and visit orders (a few KB) sit in shared memory; tri_pack
// (C*K rows of 24 or 25 floats, ~1.2 MB for the 12 288-slot BLAS) is read
// through the read-only cache (__ldg) and stays resident in the 50 MB L2.
// The stream tier's tri_pack (12 MB at 104k triangles, 109 MB at 940k)
// stays in L2 up to ~50 MB and is read from device memory past it.
// Padding clusters (inverted boxes, degenerate triangles only) are skipped
// without a test; the TPU's slab test flags them and opens triangles that
// cannot hit.

#pragma once

#include "spt_common.cuh"

namespace spt {

// Moller-Trumbore for triangle record r; returns whether t lies in
// (tmin, tmax) and below best, with t and the barycentrics (u, v).
__device__ __forceinline__ bool tri_test(const float* r, V3 o, V3 d, float tmin, float tmax,
                                         float best, float& t, float& u, float& v) {
  float v0x = r[0], v0y = r[1], v0z = r[2];
  float e1x = r[3], e1y = r[4], e1z = r[5];
  float e2x = r[6], e2y = r[7], e2z = r[8];
  float hx = d.y * e2z - d.z * e2y;
  float hy = d.z * e2x - d.x * e2z;
  float hz = d.x * e2y - d.y * e2x;
  float a = e1x * hx + e1y * hy + e1z * hz;
  bool big = fabsf(a) > F32(1e-9);
  float inv = 1.0f / (big ? a : 1.0f);
  float sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  u = inv * (sx * hx + sy * hy + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  v = inv * (d.x * qx + d.y * qy + d.z * qz);
  t = inv * (e2x * qx + e2y * qy + e2z * qz);
  return big && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tmin) && (t < tmax) &&
         (t < best);
}

__device__ __forceinline__ bool sph_test(const float* r, V3 o, V3 d, float tmin, float tmax,
                                         float best, float& t) {
  float cx = r[0], cy = r[1], cz = r[2], rad = r[3];
  float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
  float b = ocx * d.x + ocy * d.y + ocz * d.z;
  float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = b * b - c;
  float sq = safe_sqrt(disc);
  float t0 = -b - sq;
  float t1 = -b + sq;
  t = ((t0 > tmin) && (t0 < tmax)) ? t0 : t1;
  return (disc > 0.0f) && (rad > 0.0f) && (t > tmin) && (t < tmax) && (t < best);
}

struct RolledTracer {
  const Tables* tb;

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& best, int& mat,
                         V3& normal, float& hu, float& hv) const {
    best = INFINITY;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    for (int i = 0; i < tb->n_tris; ++i) {
      const float* r = tb->tri + i * kTriWords;
      float t, u, v;
      if (!tri_test(r, o, d, tmin, tmax, best, t, u, v)) continue;
      float e1x = r[3], e1y = r[4], e1z = r[5];
      float e2x = r[6], e2y = r[7], e2z = r[8];
      float nx = e1y * e2z - e1z * e2y;
      float ny = e1z * e2x - e1x * e2z;
      float nz = e1x * e2y - e1y * e2x;
      if (tb->ns != nullptr) {
        // interpolated shading normal; zero rows keep the geometric one
        const float* rn = tb->ns + i * kNsWords;
        float snx = rn[0] + u * rn[3] + v * rn[6];
        float sny = rn[1] + u * rn[4] + v * rn[7];
        float snz = rn[2] + u * rn[5] + v * rn[8];
        if (snx * snx + sny * sny + snz * snz > F32(1e-12)) {
          nx = snx;
          ny = sny;
          nz = snz;
        }
      }
      if (tb->uv != nullptr) {
        // a sphere that wins later keeps this uv (intersect.py:173-176)
        const float* ru = tb->uv + i * kUvWords;
        hu = ru[0] + u * ru[2] + v * ru[4];
        hv = ru[1] + u * ru[3] + v * ru[5];
      }
      best = t;
      kind = 1;
      mat = as_int(r[9]);
      ax = nx;
      ay = ny;
      az = nz;
    }
    for (int i = 0; i < tb->n_sphs; ++i) {
      const float* r = tb->sph + i * kSphWords;
      float t;
      if (!sph_test(r, o, d, tmin, tmax, best, t)) continue;
      best = t;
      kind = 2;
      mat = as_int(r[4]);
      ax = r[0];
      ay = r[1];
      az = r[2];
      rinv = 1.0f / fmaxf(r[3], F32(1e-12));
    }
    if (kind == 2) {
      float px = o.x + best * d.x;
      float py = o.y + best * d.y;
      float pz = o.z + best * d.z;
      normal = v3((px - ax) * rinv, (py - ay) * rinv, (pz - az) * rinv);
    } else {
      normal = v3(ax, ay, az);
    }
    return kind;
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    float t, u, v;
    for (int i = 0; i < tb->n_tris; ++i)
      if (tri_test(tb->tri + i * kTriWords, o, d, tmin, tmax, INFINITY, t, u, v)) return true;
    for (int i = 0; i < tb->n_sphs; ++i)
      if (sph_test(tb->sph + i * kSphWords, o, d, tmin, tmax, INFINITY, t)) return true;
    return false;
  }
};

constexpr float kBig = 1e30f;       // pallas_trace._BIG
constexpr int kPackCross = 9;       // tri_pack column of cross(e1, e2)
constexpr int kPackMat = 12;
constexpr int kPackUv = 13;         // uv0 | uv1-uv0 | uv2-uv0
constexpr int kPackNs = 19;         // first of the five packed shading-normal columns
constexpr int kPackFlat = 24;       // pack width without shading normals

// pallas_trace._inv_dir: zero components become +-1e30.
__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > F32(1e-20) ? 1.0f / x : (x >= 0.0f ? kBig : -kBig);
}

__device__ __forceinline__ V3 inv_dir3(V3 d) { return v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)); }

__device__ __forceinline__ int octant(V3 d) {
  return (d.x < 0.0f) * 4 + (d.y < 0.0f) * 2 + (d.z < 0.0f);
}

// pallas_trace._box_flags for one box and one ray: the interval
// [tnear, tfar] of the ray inside box b, clipped to [tmin, bound].
__device__ __forceinline__ void box_interval(const float* b, V3 o, V3 inv, float tmin, float bound,
                                             float& tnear, float& tfar) {
  const float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
  const float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
  const float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
  tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
  tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), bound));
}

__device__ __forceinline__ bool box_hit(const float* b, V3 o, V3 inv, float tmin, float bound) {
  float tnear, tfar;
  box_interval(b, o, inv, tmin, bound, tnear, tfar);
  return tnear <= tfar;
}

// pallas_trace._tri_sub_test for one packed row and one ray.
__device__ __forceinline__ bool pack_test(const float* __restrict__ p, V3 o, V3 d, float tmin,
                                          float tmax, float& t, float& u, float& v) {
  const float v0x = __ldg(p + 0), v0y = __ldg(p + 1), v0z = __ldg(p + 2);
  const float e1x = __ldg(p + 3), e1y = __ldg(p + 4), e1z = __ldg(p + 5);
  const float e2x = __ldg(p + 6), e2y = __ldg(p + 7), e2z = __ldg(p + 8);
  const float hx = d.y * e2z - d.z * e2y;
  const float hy = d.z * e2x - d.x * e2z;
  const float hz = d.x * e2y - d.y * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool big = fabsf(a) > F32(1e-9);
  const float inv = 1.0f / (big ? a : 1.0f);
  const float sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  u = inv * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = inv * (d.x * qx + d.y * qy + d.z * qz);
  t = inv * (e2x * qx + e2y * qy + e2z * qz);
  return big && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tmin) && (t < tmax);
}

__device__ __forceinline__ float ns_dequant(float q) {
  return (q - 1.0f) * F32(4.0 / 4094.0) - 2.0f;
}

// Splits a packed column into its high and low 12-bit fields.
__device__ __forceinline__ void ns_split(float p, float& hi, float& lo) {
  hi = floorf(p * F32(1.0 / 4096.0));
  lo = p - hi * 4096.0f;
}

// _sphere_pass_closest: every sphere in turn, strict t < best.
__device__ __forceinline__ void sphere_pass(const float* sph, int n_sphs, V3 o, V3 d, float tmin,
                                            float tmax, float& best, int& kind, int& mat,
                                            float& ax, float& ay, float& az, float& rinv) {
  for (int i = 0; i < n_sphs; ++i) {
    const float* r = sph + i * kSphWords;
    const float cx = r[0], cy = r[1], cz = r[2], rad = r[3];
    const float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
    const float b = ocx * d.x + ocy * d.y + ocz * d.z;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - cc;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = ((t0 > tmin) && (t0 < tmax)) ? t0 : t1;
    if ((disc > 0.0f) && (rad > 0.0f) && (t > tmin) && (t < tmax) && (t < best)) {
      best = t;
      mat = as_int(r[4]);
      kind = 2;
      ax = cx;
      ay = cy;
      az = cz;
      rinv = 1.0f / fmaxf(rad, F32(1e-12));
    }
  }
}

__device__ __forceinline__ bool sphere_any(const float* sph, int n_sphs, V3 o, V3 d, float tmin,
                                           float tmax) {
  for (int i = 0; i < n_sphs; ++i) {
    const float* r = sph + i * kSphWords;
    const float rad = r[3];
    const float ocx = o.x - r[0], ocy = o.y - r[1], ocz = o.z - r[2];
    const float b = ocx * d.x + ocy * d.y + ocz * d.z;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - cc;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = ((t0 > tmin) && (t0 < tmax)) ? t0 : t1;
    if ((disc > 0.0f) && (rad > 0.0f) && (t > tmin) && (t < tmax)) return true;
  }
  return false;
}

// A cluster walk's winner: its tri_pack row and barycentrics.
struct Winner {
  const float* row;
  float u, v;
};

// Walks n clusters (ids ord[0..n), offset by base) front to back, opening
// each box that min(tmax, best) still reaches; lowers best and records the
// winner on a strict improvement.  Returns whether any cluster improved.
__device__ inline bool walk_closest(const float* box, const uint16_t* ord, int n, int base,
                                    const float* __restrict__ pack, int pack_w, int k, V3 o, V3 d,
                                    V3 inv, float tmin, float tmax, float& best, Winner& win) {
  const int kb = (k % 8 == 0) ? 8 : k;  // pallas_trace._sub_k
  bool any = false;
  for (int j = 0; j < n; ++j) {
    const int c = base + ord[j];
    const float* b = box + c * kBoxWords;
    // padding clusters (inverted boxes) hold only degenerate triangles
    if (b[0] > b[3] || !box_hit(b, o, inv, tmin, fminf(tmax, best))) continue;
    const float* __restrict__ blk = pack + static_cast<size_t>(c) * k * pack_w;
    float tm = kBig, pu = 0.0f, pv = 0.0f;
    int wi = -1;
    for (int row = 0; row < k; ++row) {
      float t, u, v;
      if (!pack_test(blk + row * pack_w, o, d, tmin, tmax, t, u, v)) continue;
      if (t < tm || (t == tm && wi >= 0 && row / kb == wi / kb)) {
        tm = t;
        wi = row;
        pu = u;
        pv = v;
      }
    }
    if (!(tm < best)) continue;
    best = tm;
    win = Winner{blk + wi * pack_w, pu, pv};
    any = true;
  }
  return any;
}

__device__ inline bool walk_any(const float* box, const uint16_t* ord, int n, int base,
                                const float* __restrict__ pack, int pack_w, int k, V3 o, V3 d,
                                V3 inv, float tmin, float tmax) {
  for (int j = 0; j < n; ++j) {
    const int c = base + ord[j];
    const float* b = box + c * kBoxWords;
    if (b[0] > b[3] || !box_hit(b, o, inv, tmin, tmax)) continue;
    const float* __restrict__ blk = pack + static_cast<size_t>(c) * k * pack_w;
    for (int row = 0; row < k; ++row) {
      float t, u, v;
      if (pack_test(blk + row * pack_w, o, d, tmin, tmax, t, u, v)) return true;
    }
  }
  return false;
}

// Winner resolution (make_cluster_opener.resolve): material, the geometric
// or the decoded shading normal (geom tells which), texture coordinates.
__device__ inline void resolve(const Winner& w, int pack_w, int& mat, V3& n, bool& geom,
                               float& hu, float& hv) {
  const float* __restrict__ r = w.row;
  n = v3(__ldg(r + kPackCross), __ldg(r + kPackCross + 1), __ldg(r + kPackCross + 2));
  geom = true;
  if (pack_w > kPackFlat) {
    const float p0 = __ldg(r + kPackNs), p1 = __ldg(r + kPackNs + 1), p2 = __ldg(r + kPackNs + 2),
                p3 = __ldg(r + kPackNs + 3), p4 = __ldg(r + kPackNs + 4);
    const bool allz = (p0 + p1 + p2 + p3 + p4) <= 0.0f;
    float n0x, n0y, n0z, d1x, d1y, d1z, d2x, d2y, d2z, unused;
    ns_split(p0, n0x, n0y);
    ns_split(p1, n0z, d1x);
    ns_split(p2, d1y, d1z);
    ns_split(p3, d2x, d2y);
    ns_split(p4, d2z, unused);
    const float snx = ns_dequant(n0x) + w.u * ns_dequant(d1x) + w.v * ns_dequant(d2x);
    const float sny = ns_dequant(n0y) + w.u * ns_dequant(d1y) + w.v * ns_dequant(d2y);
    const float snz = ns_dequant(n0z) + w.u * ns_dequant(d1z) + w.v * ns_dequant(d2z);
    geom = allz || (snx * snx + sny * sny + snz * snz <= F32(1e-12));
    if (!geom) n = v3(snx, sny, snz);
  }
  mat = static_cast<int>(__ldg(r + kPackMat));
  hu = __ldg(r + kPackUv) + w.u * __ldg(r + kPackUv + 2) + w.v * __ldg(r + kPackUv + 4);
  hv = __ldg(r + kPackUv + 1) + w.u * __ldg(r + kPackUv + 3) + w.v * __ldg(r + kPackUv + 5);
}

// closest_epilogue: sphere normals from the world ray, miss -> inf.
__device__ __forceinline__ int epilogue(int kind, V3 o, V3 d, float best, float ax, float ay,
                                        float az, float rinv, float& t_out, V3& normal) {
  if (kind == 2) {
    const float px = o.x + best * d.x;
    const float py = o.y + best * d.y;
    const float pz = o.z + best * d.z;
    normal = v3((px - ax) * rinv, (py - ay) * rinv, (pz - az) * rinv);
  } else {
    normal = v3(ax, ay, az);
  }
  t_out = kind != 0 ? best : INFINITY;
  return kind;
}

struct ClusterTracer {
  const float* sph;                // shared: kSphWords rows
  int n_sphs;
  const float* box;                // shared: kBoxWords per cluster
  const uint16_t* order;           // shared: 8 x C cluster ids, front to back
  int n_clusters;
  const float* __restrict__ pack;  // global: (C*K, pack_w)
  int pack_w, k;

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    float best = kBig;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    // analytic spheres first (_sphere_pass_closest)
    sphere_pass(sph, n_sphs, o, d, tmin, tmax, best, kind, mat, ax, ay, az, rinv);
    Winner w;
    if (walk_closest(box, order + octant(d) * n_clusters, n_clusters, 0, pack, pack_w, k, o, d,
                     inv_dir3(d), tmin, tmax, best, w)) {
      V3 n;
      bool geom;
      resolve(w, pack_w, mat, n, geom, hu, hv);
      ax = n.x;
      ay = n.y;
      az = n.z;
      kind = 1;
    }
    return epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    // empty intervals count as blocked (any_hit_tile :631-637)
    if (tmax <= tmin) return true;
    if (sphere_any(sph, n_sphs, o, d, tmin, tmax)) return true;
    return walk_any(box, order + octant(d) * n_clusters, n_clusters, 0, pack, pack_w, k, o, d,
                    inv_dir3(d), tmin, tmax);
  }
};

__device__ inline ClusterTracer cluster_tracer(const Tables& tb, const SceneArgs& s) {
  return ClusterTracer{tb.sph, tb.n_sphs, tb.box, tb.order, s.n_clusters, s.pack, s.pack_w,
                       s.cluster_size};
}

// One instance row of the kernels' table: world box lo | hi at 0..5, then
// bvh.InstAccel.inst: R_ofw row-major at 6..14, t_ofw at 15..17, mesh at
// 18, material override or -1 at 19, sign(det) at 20.
constexpr int kInstRow = 6;

// _xform_rays: world -> object space, the direction left unnormalized.
__device__ __forceinline__ void xform(const float* r, V3 o, V3 d, V3& oo, V3& dd) {
  oo = v3(r[0] * o.x + r[1] * o.y + r[2] * o.z + r[9],
          r[3] * o.x + r[4] * o.y + r[5] * o.z + r[10],
          r[6] * o.x + r[7] * o.y + r[8] * o.z + r[11]);
  dd = v3(r[0] * d.x + r[1] * d.y + r[2] * d.z, r[3] * d.x + r[4] * d.y + r[5] * d.z,
          r[6] * d.x + r[7] * d.y + r[8] * d.z);
}

struct InstTracer {
  const float* sph;                // shared: kSphWords rows
  int n_sphs;
  const float* box;                // shared: M x CMAX BLAS boxes
  const uint16_t* order;           // shared: 8M x CMAX cluster ids, row octant * M + mesh
  const float* inst;               // shared: I x kInstWords
  int n_inst, n_meshes, cmax;
  const float* __restrict__ pack;  // global: (M*CMAX*K, pack_w) object space
  int pack_w, k;

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    float best = kBig;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    sphere_pass(sph, n_sphs, o, d, tmin, tmax, best, kind, mat, ax, ay, az, rinv);
    const V3 inv = inv_dir3(d);
    float last_tn = -kBig;
    int last_id = -1;
    for (;;) {
      // _next_inst: the nearest crossed instance strictly after the cursor
      const float bound = fminf(tmax, best);
      float cur_tn = kBig;
      int cur_id = 0x7FFFFFFF;
      for (int i = 0; i < n_inst; ++i) {
        float tnear, tfar;
        box_interval(inst + i * kInstWords, o, inv, tmin, bound, tnear, tfar);
        const bool ok =
            (tnear <= tfar) && ((tnear > last_tn) || ((tnear == last_tn) && (i > last_id)));
        if (ok && ((tnear < cur_tn) || ((tnear == cur_tn) && (i < cur_id)))) {
          cur_tn = tnear;
          cur_id = i;
        }
      }
      if (!(cur_tn < kBig)) break;
      const float* r = inst + cur_id * kInstWords + kInstRow;
      V3 oo, dd;
      xform(r, o, d, oo, dd);
      const int mesh = static_cast<int>(r[12]);
      Winner w;
      if (walk_closest(box, order + (octant(dd) * n_meshes + mesh) * cmax, cmax, mesh * cmax,
                       pack, pack_w, k, oo, dd, inv_dir3(dd), tmin, tmax, best, w)) {
        V3 n;
        bool geom;
        resolve(w, pack_w, mat, n, geom, hu, hv);
        // _lane_finish: the override, then the normal back to world space
        const int mat_ov = static_cast<int>(r[13]);
        if (mat_ov >= 0) mat = mat_ov;
        const float s = geom ? r[14] : 1.0f;
        ax = s * (r[0] * n.x + r[3] * n.y + r[6] * n.z);
        ay = s * (r[1] * n.x + r[4] * n.y + r[7] * n.z);
        az = s * (r[2] * n.x + r[5] * n.y + r[8] * n.z);
        kind = 1;
      }
      last_tn = cur_tn;
      last_id = cur_id;
    }
    return epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    // empty intervals count as blocked (pallas_inst any_hit :915-925)
    if (tmax <= tmin) return true;
    if (sphere_any(sph, n_sphs, o, d, tmin, tmax)) return true;
    const V3 inv = inv_dir3(d);
    for (int i = 0; i < n_inst; ++i) {
      const float* b = inst + i * kInstWords;
      if (!box_hit(b, o, inv, tmin, tmax)) continue;
      const float* r = b + kInstRow;
      V3 oo, dd;
      xform(r, o, d, oo, dd);
      const int mesh = static_cast<int>(r[12]);
      if (walk_any(box, order + (octant(dd) * n_meshes + mesh) * cmax, cmax, mesh * cmax, pack,
                   pack_w, k, oo, dd, inv_dir3(dd), tmin, tmax))
        return true;
    }
    return false;
  }
};

__device__ inline InstTracer inst_tracer(const Tables& tb, const SceneArgs& s) {
  return InstTracer{tb.sph,     tb.n_sphs,  tb.box, tb.order,        tb.inst,
                    s.n_inst,   s.n_meshes, s.n_clusters / s.n_meshes, s.pack,
                    s.pack_w,   s.cluster_size};
}

struct StreamTracer {
  const float* sph;                      // shared: kSphWords rows
  int n_sphs;
  const float* sbox;                     // shared: G super boxes
  const uint16_t* sorder;                // shared: 8 x G super ids, front to back
  int n_supers;
  const float* __restrict__ cbox;        // global: G * kSuperFan cluster boxes
  const uint16_t* __restrict__ corder;   // global: 8 x G * kSuperFan local ids
  const float* __restrict__ pack;        // global: (C*K, pack_w)
  int pack_w, k;

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    float best = kBig;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    sphere_pass(sph, n_sphs, o, d, tmin, tmax, best, kind, mat, ax, ay, az, rinv);
    const V3 inv = inv_dir3(d);
    const int oct = octant(d);
    const uint16_t* so = sorder + oct * n_supers;
    const uint16_t* co = corder + static_cast<size_t>(oct) * n_supers * kSuperFan;
    Winner w;
    bool won = false;
    for (int j = 0; j < n_supers; ++j) {
      const int g = so[j];
      const float* b = sbox + g * kBoxWords;
      // all-padding supers are inverted; a super is opened only while the
      // bound tightened by the supers before it still reaches its box
      if (b[0] > b[3] || !box_hit(b, o, inv, tmin, fminf(tmax, best))) continue;
      if (walk_closest(cbox, co + g * kSuperFan, kSuperFan, g * kSuperFan, pack, pack_w, k, o,
                       d, inv, tmin, tmax, best, w))
        won = true;
    }
    if (won) {
      V3 n;
      bool geom;
      resolve(w, pack_w, mat, n, geom, hu, hv);
      ax = n.x;
      ay = n.y;
      az = n.z;
      kind = 1;
    }
    return epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    // empty intervals count as blocked (stream_any_tile :262-265)
    if (tmax <= tmin) return true;
    if (sphere_any(sph, n_sphs, o, d, tmin, tmax)) return true;
    const V3 inv = inv_dir3(d);
    const int oct = octant(d);
    const uint16_t* so = sorder + oct * n_supers;
    const uint16_t* co = corder + static_cast<size_t>(oct) * n_supers * kSuperFan;
    for (int j = 0; j < n_supers; ++j) {
      const int g = so[j];
      const float* b = sbox + g * kBoxWords;
      if (b[0] > b[3] || !box_hit(b, o, inv, tmin, tmax)) continue;
      if (walk_any(cbox, co + g * kSuperFan, kSuperFan, g * kSuperFan, pack, pack_w, k, o, d,
                   inv, tmin, tmax))
        return true;
    }
    return false;
  }
};

__device__ inline StreamTracer stream_tracer(const Tables& tb, const SceneArgs& s) {
  return StreamTracer{tb.sph, tb.n_sphs, tb.box, tb.order, s.n_clusters,
                      s.cbox, s.corder,  s.pack, s.pack_w, s.cluster_size};
}

}  // namespace spt
