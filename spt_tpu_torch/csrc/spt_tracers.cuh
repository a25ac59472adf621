// The four tracers the kernels are templated on.  Each answers
//   int  closest(o, d, tmin, tmax, t, mat, normal, u, v) -> kind (0 miss, 1 tri, 2 sphere)
//   bool occluded(o, d, tmin, tmax)
// for one ray per thread; (u, v) are the hit's interpolated texture
// coordinates (0 where no triangle won).
//
// - RolledTracer: the small-scene brute force over the triangle and sphere
//   tables in shared memory (ops/intersect.py, unrolled semantics), rows in
//   the small layout (spt_common.cuh small_table_words).
// - ClusterTracer: the resident cluster tracer, the counterpart of
//   spt_tpu/ops/pallas_trace.py closest_hit_tile / any_hit_tile
//   (:497-669).  The TPU tests every cluster box against a whole ray
//   subtile in one broadcast pass and opens the union; here each ray walks
//   the clusters in its own direction octant's front-to-back order (the
//   octant keys of bvh.MeshAccel.cl_okey), slab-tests each box against
//   min(tmax, best_t) with _box_flags' arithmetic (:75-107) and opens a box
//   it hits: Moller-Trumbore over the cluster's rows of tri_pack in
//   _tri_sub_test's formulation (:220-248).  The octant is the ray's own,
//   not the subtile's; that changes only the visit order, and so only
//   which triangle wins an exact tie in t.  Within a cluster the winner
//   follows tri_block_min (:262-312): the lowest t, ties to the highest row
//   of an 8-row sub-block, strict across sub-blocks; across clusters strict
//   t < best (spheres, tested first, win ties).  The shading normal decodes
//   the 12-bit columns 19-23 exactly as bvh.decode_ns; the texture
//   coordinates interpolate columns 13-18 (make_cluster_opener.resolve).
// - InstTracer: the instanced TLAS/BLAS tracer (K7), the counterpart of
//   spt_tpu/ops/pallas_inst.py inst_closest_tile_rounds / inst_any_tile_rounds
//   (:306, :483).  Each ray walks its own crossed instances front to back
//   in the (tnear, id) order of _next_inst (:199-238): each round rescans the
//   instance boxes against min(tmax, best) for the nearest one strictly
//   after the ray's cursor, so the cursor advances every round and the
//   walk ends after at most I rounds.  The ray goes into the instance's
//   object space unnormalized (_xform_rays :72-86: t stays world t), walks
//   that mesh's BLAS clusters with the cluster walk in its own
//   object-space octant's order, and a win takes _lane_finish (:284-303):
//   the material override, sign(det) R^T on geometric normals, R^T alone on
//   interpolated ones.  The TPU's per-instance union scheme, its bounce-0
//   union hybrid and its per-round mesh serialisation are tile devices and
//   are not ported; any-hit visits the crossed instances in id order, which
//   cannot change a flag.
// - StreamTracer: the two-level tracer of meshes past the resident tier
//   (K8), the counterpart of spt_tpu/ops/pallas_stream.py
//   stream_closest_tile / stream_any_tile (:104, :250).  Each ray walks
//   the supercluster boxes (one box over each kSuperFan consecutive
//   clusters) in its octant's front-to-back order (sup_okey), re-tests each
//   against min(tmax, best) when its turn comes (the TPU's recheck,
//   :211-217), and walks an opened super's 16 clusters with the cluster
//   walk in the order of bvh.MeshAccel.cl_order (cl_okey's order within
//   the super).  Only the super level (G <= 1024 boxes and orders) sits in
//   shared memory; the cluster boxes (C * 24 B, up to 384 KiB) and orders
//   stay in global memory.
//
// In the global placement of the tables (spt_common.cuh) the rows marked
// "shared" below (spheres, boxes, instance rows) are read where they lie in
// global memory; the visit orders and staging buffers stay in shared memory.
//
// What bounds the mesh tracers: the 64 Moller-Trumbore tests of each opened
// cluster (ALU, an IEEE division each) and the wait for their rows.  The
// boxes, instance rows and visit orders (a few KB) sit in shared memory;
// tri_pack (C*K rows of 24 or 25 floats: 1.2 MB for the 12 288-slot BLAS,
// 10.4 MB at the stream tier's 104k triangles, 94 MB at 940k) lies in
// global memory, behind the 50 MB L2.  A lane that walks alone scans an
// opened cluster's 64 rows itself while the lanes of its warp that did not
// open that cluster idle: on a cluster a few lanes open, most of the warp's
// issue slots go to nothing.
//
// What the design does about it: one cluster walk, warp-cooperative, serves
// all three mesh tracers.  The lanes that enter a tracer together step
// through their supers, instances and clusters in lockstep, each in its own
// front-to-back order with its own ray, bound and arithmetic; at each step
// a ballot says which lanes open a cluster, and the lanes that open the
// same one are served together.  Few of them (below kStageMin): the whole
// warp takes each one's 64 tests in turn, two rows a lane, and reduces them
// to that lane's winner (two min-reductions on keys that order the hits as
// the lone scan does) or blocked flag.  Many of them: the warp copies the
// nine Moller-Trumbore columns of the cluster's rows into its staging buffer
// in shared memory (coalesced loads, all in flight at once) and each scans
// the rows there, every lane reading the same row (a broadcast).  Each lane
// keeps its own visit order, bound and winner (a pointer into tri_pack,
// which resolve reads), so every result is the lone walk's, bit for bit;
// the sorted frame's octant-major ray order (ray_sort.sort_key) is what
// puts many lanes on one cluster.  The TPU streams each opened super's
// 128-padded triangle block HBM -> VMEM by DMA, double-buffered; the
// staging copy is its counterpart here, one cluster at a time and not
// overlapped.
// When live rays are few (the sorted frame's last bounce), the fused_frame
// kernel gives each ray several threads of a warp (twins): they walk it as
// a group, testing a window of boxes at once and spreading the 64 tests of
// each cluster it opens, and re-test each candidate box in visit order
// against the current bound so that the group opens exactly the clusters
// the lone walk opens.
// Padding clusters (inverted boxes, degenerate triangles only) are skipped
// without a test; the TPU's slab test flags them and opens triangles that
// cannot hit.

#pragma once

#include "spt_common.cuh"

namespace spt {

// Moller-Trumbore for the small layout's triangle row r (three float4
// loads); whether t lies in (tmin, tmax) and below best, with t and the
// barycentrics (u, v).  Every condition is evaluated, in the plain
// version's order: a test that returns on its first failed condition
// measured slower on the card (frame_sweep.py, PERF.md), since the lanes of
// a warp seldom fail together past the primary rays.  With kEarly it does
// return there (once !big, then once u, then once v or u + v fails), on
// the same values in the same order, so its result is the same and so are
// t, u, v where it passes: for coherent rays, whose warps fail together.
template <bool kEarly = false>
__device__ __forceinline__ bool tri_test(const float4* r, V3 o, V3 d, float tmin, float tmax,
                                         float best, float& t, float& u, float& v) {
  const float4 r0 = r[0], r1 = r[1], r2 = r[2];
  const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float hx = d.y * e2z - d.z * e2y;
  const float hy = d.z * e2x - d.x * e2z;
  const float hz = d.x * e2y - d.y * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool big = fabsf(a) > F32(1e-9);
  if constexpr (kEarly) {
    if (!big) return false;
  }
  const float inv = 1.0f / (big ? a : 1.0f);
  const float sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  u = inv * (sx * hx + sy * hy + sz * hz);
  if constexpr (kEarly) {
    if (!(u >= 0.0f)) return false;
  }
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = inv * (d.x * qx + d.y * qy + d.z * qz);
  if constexpr (kEarly) {
    if (!((v >= 0.0f) && (u + v <= 1.0f))) return false;
  }
  t = inv * (e2x * qx + e2y * qy + e2z * qz);
  return big && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tmin) && (t < tmax) &&
         (t < best);
}

// The ray against the small layout's sphere row r (one float4 load); with
// kEarly it returns before the square root once the discriminant or the
// radius fails (the same result).
template <bool kEarly = false>
__device__ __forceinline__ bool sph_test(const float4* r, V3 o, V3 d, float tmin, float tmax,
                                         float best, float& t) {
  const float4 c = r[0];
  const float rad = c.w;
  const float ocx = o.x - c.x, ocy = o.y - c.y, ocz = o.z - c.z;
  const float b = ocx * d.x + ocy * d.y + ocz * d.z;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - cc;
  if constexpr (kEarly) {
    if (!((disc > 0.0f) && (rad > 0.0f))) return false;
  }
  const float sq = safe_sqrt(disc);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  t = ((t0 > tmin) && (t0 < tmax)) ? t0 : t1;
  return (disc > 0.0f) && (rad > 0.0f) && (t > tmin) && (t < tmax) && (t < best);
}

// The small forms' brute-force tracer over the tables in shared memory;
// kEarly selects the tests that return at their first failed condition.
template <bool kEarly>
struct SmallTracer {
  const Tables* tb;

  __device__ const float4* tri_row(int i) const {
    return reinterpret_cast<const float4*>(tb->tri + i * kSmallTriWords);
  }
  __device__ const float4* sph_row(int i) const {
    return reinterpret_cast<const float4*>(tb->sph + i * kSmallSphWords);
  }

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& best, int& mat,
                         V3& normal, float& hu, float& hv) const {
    best = INFINITY;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    for (int i = 0; i < tb->n_tris; ++i) {
      float t, u, v;
      if (!tri_test<kEarly>(tri_row(i), o, d, tmin, tmax, best, t, u, v)) continue;
      const float* r = tb->tri + i * kSmallTriWords;
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
      float t;
      if (!sph_test<kEarly>(sph_row(i), o, d, tmin, tmax, best, t)) continue;
      const float* r = tb->sph + i * kSmallSphWords;
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
      if (tri_test<kEarly>(tri_row(i), o, d, tmin, tmax, INFINITY, t, u, v)) return true;
    for (int i = 0; i < tb->n_sphs; ++i)
      if (sph_test<kEarly>(sph_row(i), o, d, tmin, tmax, INFINITY, t)) return true;
    return false;
  }
};

// K1 small's tracer: every condition of every test evaluated.
using RolledTracer = SmallTracer<false>;

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

// pallas_trace._tri_sub_test for one packed row and one ray: the row's
// Moller-Trumbore columns v0 | e1 | e2 at p[0..9), read from tri_pack in
// global memory (through the read-only cache) or from a staging buffer in
// shared memory (kStaged).
template <bool kStaged>
__device__ __forceinline__ bool pack_test(const float* __restrict__ p, V3 o, V3 d, float tmin,
                                          float tmax, float& t, float& u, float& v) {
  float c[kMtCols];
#pragma unroll
  for (int i = 0; i < kMtCols; ++i) {
    if constexpr (kStaged) {
      c[i] = p[i];
    } else {
      c[i] = __ldg(p + i);
    }
  }
  const float v0x = c[0], v0y = c[1], v0z = c[2];
  const float e1x = c[3], e1y = c[4], e1z = c[5];
  const float e2x = c[6], e2y = c[7], e2z = c[8];
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

// Lanes that must open one cluster before the warp stages it in shared
// memory and each of them scans the 64 rows alone; fewer spread their
// tests over the warp.  Chosen on the card with walk_sweep.py (PERF.md).
constexpr int kStageMin = 24;

__device__ __forceinline__ unsigned lane_bit() { return 1u << (threadIdx.x & 31); }

// This warp's staging buffer and lock word (spt_common.cuh), or null in a
// form without one.
__device__ __forceinline__ float* warp_stage(const Tables& tb) {
  return tb.stage != nullptr ? tb.stage + (threadIdx.x >> 5) * kStageFloats : nullptr;
}
__device__ __forceinline__ int* warp_lock(const Tables& tb) {
  return tb.stage_lock != nullptr ? tb.stage_lock + (threadIdx.x >> 5) : nullptr;
}

// The lanes m take their warp's staging buffer for one walk (their first
// lane locks it) and get it back, or null when a walk of other lanes of the
// warp holds it (those then read tri_pack in place).
__device__ inline float* take_stage(unsigned m, float* buf, int* lock) {
  const int first = __ffs(m) - 1;
  int held = 0;
  if ((threadIdx.x & 31) == first && buf != nullptr) held = atomicCAS(lock, 0, 1) == 0;
  return __shfl_sync(m, held, first) ? buf : nullptr;
}

__device__ inline void drop_stage(unsigned m, float* rows, int* lock) {
  __syncwarp(m);
  if (rows != nullptr && (threadIdx.x & 31) == __ffs(m) - 1) {
    __threadfence_block();
    atomicExch(lock, 0);
  }
}

// The lanes m copy the Moller-Trumbore columns of a cluster's k rows (blk,
// row stride pack_w) into the staging buffer, kMtCols floats a row.
__device__ inline void stage_cluster(unsigned m, const float* __restrict__ blk, int pack_w,
                                     int k, float* rows) {
  const int rank = __popc(m & (lane_bit() - 1u));
  const int size = __popc(m);
  for (int e = rank; e < k * kMtCols; e += size) {
    const int r = e / kMtCols;
    rows[e] = __ldg(blk + r * pack_w + (e - r * kMtCols));
  }
}

// A lane's tests of one opened cluster, rows at `rows` with row stride
// `stride`: closest keeps tri_block_min's winner (the lowest t, ties to the
// highest row of an 8-row sub-block, strict across sub-blocks).
template <bool kStaged>
__device__ inline void open_closest(const float* __restrict__ rows, int stride, int k, V3 o,
                                    V3 d, float tmin, float tmax, float& tm, int& wi, float& pu,
                                    float& pv) {
  const int kb = (k % 8 == 0) ? 8 : k;  // pallas_trace._sub_k
  for (int row = 0; row < k; ++row) {
    float t, u, v;
    if (!pack_test<kStaged>(rows + row * stride, o, d, tmin, tmax, t, u, v)) continue;
    if (t < tm || (t == tm && wi >= 0 && row / kb == wi / kb)) {
      tm = t;
      wi = row;
      pu = u;
      pv = v;
    }
  }
}

template <bool kStaged>
__device__ inline bool open_any(const float* __restrict__ rows, int stride, int k, V3 o, V3 d,
                                float tmin, float tmax) {
  for (int row = 0; row < k; ++row) {
    float t, u, v;
    if (pack_test<kStaged>(rows + row * stride, o, d, tmin, tmax, t, u, v)) return true;
  }
  return false;
}

// open_closest's winner as an order of unsigned keys, so that the warp can
// pick it with two min-reductions: t's bits in the order of the values
// (-0 taken as +0, which equals it), then the row's place in the tie order
// (the lowest sub-block first, within it the highest row).
__device__ __forceinline__ unsigned t_key(float t) {
  const unsigned b = __float_as_uint(t + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned row_key(int row, int kb) {
  return (static_cast<unsigned>(row / kb) << 16) | static_cast<unsigned>(0xFFFF - row);
}

// The tests of one cluster (blk) for each lane of `voters`, spread over the
// lanes m: for each voter in turn every lane of m takes the voter's ray and
// tests its share of the rows (read from tri_pack; for the voters after the
// first they come from L1), and the warp reduces the shares to
// open_closest's winner (closest) or to whether any row hit (any-hit).
template <bool kAny>
__device__ inline void spread_cluster(unsigned m, unsigned voters,
                                      const float* __restrict__ blk, int pack_w, int k, V3 o,
                                      V3 d, float tmin, float tmax, float& best, Winner& win,
                                      bool& hit) {
  const int lane = threadIdx.x & 31;
  const int rank = __popc(m & (lane_bit() - 1u));
  const int size = __popc(m);
  const int kb = (k % 8 == 0) ? 8 : k;
  while (voters != 0u) {
    const int src = __ffs(voters) - 1;
    voters &= voters - 1u;
    const V3 ro = v3(__shfl_sync(m, o.x, src), __shfl_sync(m, o.y, src), __shfl_sync(m, o.z, src));
    const V3 rd = v3(__shfl_sync(m, d.x, src), __shfl_sync(m, d.y, src), __shfl_sync(m, d.z, src));
    const float rtmin = __shfl_sync(m, tmin, src), rtmax = __shfl_sync(m, tmax, src);
    if constexpr (kAny) {
      bool h = false;
      for (int row = rank; row < k && !h; row += size) {
        float t, u, v;
        h = pack_test<false>(blk + row * pack_w, ro, rd, rtmin, rtmax, t, u, v);
      }
      if (__ballot_sync(m, h) != 0u && lane == src) hit = true;
    } else {
      unsigned bk = 0xFFFFFFFFu, bk2 = 0xFFFFFFFFu;
      float bt = 0.0f, bu = 0.0f, bv = 0.0f;
      for (int row = rank; row < k; row += size) {
        float t, u, v;
        if (!pack_test<false>(blk + row * pack_w, ro, rd, rtmin, rtmax, t, u, v)) continue;
        const unsigned k1 = t_key(t), k2 = row_key(row, kb);
        if (k1 < bk || (k1 == bk && k2 < bk2)) {
          bk = k1;
          bk2 = k2;
          bt = t;
          bu = u;
          bv = v;
        }
      }
      const unsigned kmin = __reduce_min_sync(m, bk);
      if (kmin == 0xFFFFFFFFu) continue;
      const unsigned k2min = __reduce_min_sync(m, bk == kmin ? bk2 : 0xFFFFFFFFu);
      const int win_lane = __ffs(__ballot_sync(m, bk == kmin && bk2 == k2min)) - 1;
      const float tm = __shfl_sync(m, bt, win_lane);
      const float pu = __shfl_sync(m, bu, win_lane), pv = __shfl_sync(m, bv, win_lane);
      if (lane == src && tm < best) {
        best = tm;
        win = Winner{blk + (0xFFFF - static_cast<int>(k2min & 0xFFFFu)) * pack_w, pu, pv};
        hit = true;
      }
    }
  }
}

// The walk of one ray carried by a group of twins g (every twin holding the
// walker's ray, bound and blocked flag): the group steps through the visit
// order (ids base + ord[j], boxes at box + id * kBoxWords) |g| entries at a
// time, each twin testing one entry's box against the bound at the window's
// start, a superset of the boxes the lone walk opens since the bound only
// falls; the candidates are then re-tested in order against the current
// bound, exactly as the lone walk tests them, and visit(id) takes each that
// passes (and keeps the bound and flag equal on every twin).  Any-hit stops
// once `hit` is set.
template <bool kAny, class Visit>
__device__ inline void group_walk(unsigned g, const float* box, const uint16_t* ord, int n,
                                  int base, V3 o, V3 inv, float tmin, float tmax,
                                  const float& best, const bool& hit, Visit visit) {
  const int rank = __popc(g & (lane_bit() - 1u));
  const int size = __popc(g);
  for (int j0 = 0; j0 < n; j0 += size) {
    if (kAny && hit) return;
    const int j = j0 + rank;
    float b[kBoxWords] = {};
    int id = 0;
    bool cand = false;
    if (j < n) {
      id = base + ord[j];
      for (int i = 0; i < kBoxWords; ++i) b[i] = box[id * kBoxWords + i];
      cand = !(b[0] > b[3]) && box_hit(b, o, inv, tmin, kAny ? tmax : fminf(tmax, best));
    }
    unsigned cands = __ballot_sync(g, cand);
    while (cands != 0u) {
      const int src = __ffs(cands) - 1;
      cands &= cands - 1u;
      float bb[kBoxWords];
      for (int i = 0; i < kBoxWords; ++i) bb[i] = __shfl_sync(g, b[i], src);
      const int c = __shfl_sync(g, id, src);
      if (!box_hit(bb, o, inv, tmin, kAny ? tmax : fminf(tmax, best))) continue;
      visit(c);
      if (kAny && hit) return;
    }
  }
}

// The cluster walk, warp-cooperative: the lanes m step through n clusters
// together, each lane through its own visit order (ids ord[0..n), offset by
// base), with its own ray.  A lane with `open` false votes no at every
// step.  Closest (kAny false): a lane opens each box that min(tmax, best)
// still reaches, lowers best and records its winner on a strict
// improvement, and sets `hit` when a cluster improved.  Any-hit: a lane
// opens each box (tmin, tmax) reaches until `hit` (its blocked flag) is
// set; the walk ends when no lane of m is left to open one.  At each step
// the lanes that open the same cluster are served together: at least
// kStageMin of them copy it into the staging buffer `rows` (when the walk
// holds it) and each scans its rows there, a broadcast; fewer spread their
// tests over the warp.
//
// With kTwins, when every thread of m has a twin (walks below), each group
// of twins walks its ray on its own instead (group_walk): the group tests a
// window of boxes at once and spreads the tests of each cluster it opens.
template <bool kAny, bool kTwins = false>
__device__ inline void walk_clusters(unsigned m, unsigned twins, bool open, float* rows,
                                     const float* box, const uint16_t* ord, int n, int base,
                                     const float* __restrict__ pack, int pack_w, int k, V3 o,
                                     V3 d, V3 inv, float tmin, float tmax, float& best,
                                     Winner& win, bool& hit) {
  if constexpr (kTwins) {
    if (__all_sync(m, __popc(twins) > 1)) {
      const unsigned g = twins;
      const int lead = __ffs(g) - 1;
      if (__shfl_sync(g, static_cast<int>(open), lead) == 0) return;
      // the walker's ray, visit order and bound on every twin (a twin of
      // the instanced walk holds the world ray)
      o = v3(__shfl_sync(g, o.x, lead), __shfl_sync(g, o.y, lead), __shfl_sync(g, o.z, lead));
      d = v3(__shfl_sync(g, d.x, lead), __shfl_sync(g, d.y, lead), __shfl_sync(g, d.z, lead));
      inv = v3(__shfl_sync(g, inv.x, lead), __shfl_sync(g, inv.y, lead),
               __shfl_sync(g, inv.z, lead));
      ord = reinterpret_cast<const uint16_t*>(
          __shfl_sync(g, reinterpret_cast<unsigned long long>(ord), lead));
      base = __shfl_sync(g, base, lead);
      best = __shfl_sync(g, best, lead);
      if constexpr (kAny) hit = __shfl_sync(g, static_cast<int>(hit), lead) != 0;
      group_walk<kAny>(g, box, ord, n, base, o, inv, tmin, tmax, best, hit, [&](int c) {
        spread_cluster<kAny>(g, 1u << lead, pack + static_cast<size_t>(c) * k * pack_w, pack_w,
                             k, o, d, tmin, tmax, best, win, hit);
        if constexpr (kAny) {
          hit = __shfl_sync(g, static_cast<int>(hit), lead) != 0;
        } else {
          best = __shfl_sync(g, best, lead);
        }
      });
      return;
    }
  }
  const bool can_stage = rows != nullptr && k <= kStageRows;
  for (int j = 0; j < n; ++j) {
    if constexpr (kAny) {
      if (__ballot_sync(m, open && !hit) == 0u) return;
    }
    const int c = base + ord[j];
    const float* b = box + c * kBoxWords;
    // padding clusters (inverted boxes) hold only degenerate triangles
    const bool want = open && !(kAny && hit) && !(b[0] > b[3]) &&
                      box_hit(b, o, inv, tmin, kAny ? tmax : fminf(tmax, best));
    unsigned todo = __ballot_sync(m, want);
    if (todo == 0u) continue;
    const unsigned same = __match_any_sync(m, c) & todo;
    while (todo != 0u) {
      const int lead = __ffs(todo) - 1;
      const unsigned voters = __shfl_sync(m, same, lead);
      const int cl = __shfl_sync(m, c, lead);
      todo &= ~voters;
      const float* __restrict__ blk = pack + static_cast<size_t>(cl) * k * pack_w;
      if (__popc(voters) < kStageMin) {
        spread_cluster<kAny>(m, voters, blk, pack_w, k, o, d, tmin, tmax, best, win, hit);
        continue;
      }
      if (can_stage) {
        stage_cluster(m, blk, pack_w, k, rows);
        __syncwarp(m);
      }
      if (voters & lane_bit()) {
        if constexpr (kAny) {
          hit = can_stage ? open_any<true>(rows, kMtCols, k, o, d, tmin, tmax)
                          : open_any<false>(blk, pack_w, k, o, d, tmin, tmax);
        } else {
          float tm = kBig, pu = 0.0f, pv = 0.0f;
          int wi = -1;
          if (can_stage) {
            open_closest<true>(rows, kMtCols, k, o, d, tmin, tmax, tm, wi, pu, pv);
          } else {
            open_closest<false>(blk, pack_w, k, o, d, tmin, tmax, tm, wi, pu, pv);
          }
          if (tm < best) {
            best = tm;
            win = Winner{blk + wi * pack_w, pu, pv};
            hit = true;
          }
        }
      }
      if (can_stage) __syncwarp(m);
    }
  }
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

// Twins (kTwins): threads of a warp that carry the same ray, named by
// `ray`, walk it once: the lowest of them in m is its walker, and the
// others help and then take its result (from_walker).  When every ray of
// the warp has twins, each group walks on its own (group_walk: a window of
// box tests at once, each opened cluster's tests spread over the group);
// otherwise the twins take part in the warp's lockstep walk without voting.
// The fused_frame kernel puts a few rays on each warp this way when live
// lanes are few.  Without kTwins every thread walks its own ray.
template <bool kTwins>
__device__ __forceinline__ bool walks(unsigned m, int ray, unsigned& twins) {
  if constexpr (!kTwins) {
    twins = lane_bit();
    return true;
  } else {
    twins = __match_any_sync(m, ray);
    return (threadIdx.x & 31) == static_cast<unsigned>(__ffs(twins) - 1);
  }
}

template <bool kTwins, class T>
__device__ __forceinline__ T from_walker(unsigned m, unsigned twins, T x) {
  if constexpr (!kTwins) {
    return x;
  } else {
    return __shfl_sync(m, x, __ffs(twins) - 1);
  }
}

// closest()'s results from the walker of each group of twins.
template <bool kTwins>
__device__ __forceinline__ int closest_from_walker(unsigned m, unsigned twins, int kind,
                                                   float& t_out, int& mat, V3& normal,
                                                   float& hu, float& hv) {
  if constexpr (kTwins) {
    t_out = from_walker<true>(m, twins, t_out);
    mat = from_walker<true>(m, twins, mat);
    normal = v3(from_walker<true>(m, twins, normal.x), from_walker<true>(m, twins, normal.y),
                from_walker<true>(m, twins, normal.z));
    hu = from_walker<true>(m, twins, hu);
    hv = from_walker<true>(m, twins, hv);
  }
  return from_walker<kTwins>(m, twins, kind);
}

template <bool kTwins = false>
struct ClusterTracer {
  const float* sph;                // shared: kSphWords rows
  int n_sphs;
  const float* box;                // shared: kBoxWords per cluster
  const uint16_t* order;           // shared: 8 x C cluster ids, front to back
  int n_clusters;
  const float* __restrict__ pack;  // global: (C*K, pack_w)
  int pack_w, k;
  float* stage;                    // shared: this warp's staging buffer, or null
  int* lock;
  int ray;                         // kTwins: the ray this thread carries

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
    float best = kBig;
    int kind = 0;
    mat = 0;
    hu = 0.0f;
    hv = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    // analytic spheres first (_sphere_pass_closest)
    sphere_pass(sph, n_sphs, o, d, tmin, tmax, best, kind, mat, ax, ay, az, rinv);
    Winner w;
    bool won = false;
    float* rows = take_stage(m, stage, lock);
    walk_clusters<false, kTwins>(m, twins, walker, rows, box, order + octant(d) * n_clusters,
                                 n_clusters, 0, pack, pack_w, k, o, d, inv_dir3(d), tmin, tmax,
                                 best, w, won);
    drop_stage(m, rows, lock);
    if (won) {
      V3 n;
      bool geom;
      resolve(w, pack_w, mat, n, geom, hu, hv);
      ax = n.x;
      ay = n.y;
      az = n.z;
      kind = 1;
    }
    kind = epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
    return closest_from_walker<kTwins>(m, twins, kind, t_out, mat, normal, hu, hv);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
    // empty intervals count as blocked (any_hit_tile :631-637)
    bool blocked = tmax <= tmin || sphere_any(sph, n_sphs, o, d, tmin, tmax);
    float best = kBig;
    Winner w;
    float* rows = take_stage(m, stage, lock);
    walk_clusters<true, kTwins>(m, twins, walker, rows, box, order + octant(d) * n_clusters,
                                n_clusters, 0, pack, pack_w, k, o, d, inv_dir3(d), tmin, tmax,
                                best, w, blocked);
    drop_stage(m, rows, lock);
    return from_walker<kTwins>(m, twins, static_cast<int>(blocked)) != 0;
  }
};

template <bool kTwins = false>
__device__ inline ClusterTracer<kTwins> cluster_tracer(const Tables& tb, const SceneArgs& s,
                                                       int ray = 0) {
  return ClusterTracer<kTwins>{tb.sph,       tb.n_sphs,    tb.box,         tb.order,
                               s.n_clusters, s.pack,       s.pack_w,       s.cluster_size,
                               warp_stage(tb), warp_lock(tb), ray};
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

// The instanced walk: the lanes of a warp go through their rounds together;
// each round a lane takes its next crossed instance and walks that mesh's
// BLAS in its own object-space octant's order, in step with the others.
// The rounds go on while any lane of the warp has an instance left.
template <bool kTwins = false>
struct InstTracer {
  const float* sph;                // shared: kSphWords rows
  int n_sphs;
  const float* box;                // shared: M x CMAX BLAS boxes
  const uint16_t* order;           // shared: 8M x CMAX cluster ids, row octant * M + mesh
  const float* inst;               // shared: I x kInstWords
  int n_inst, n_meshes, cmax;
  const float* __restrict__ pack;  // global: (M*CMAX*K, pack_w) object space
  int pack_w, k;
  float* stage;                    // shared: this warp's staging buffer, or null
  int* lock;
  int ray;                         // kTwins: the ray this thread carries

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
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
    // a group of twins follows its walker's rounds together (walk_clusters
    // then walks each instance's BLAS as a group)
    bool grouped = false;
    if constexpr (kTwins) grouped = __all_sync(m, __popc(twins) > 1);
    bool pending = walker || grouped;
    const int rank = __popc(twins & (lane_bit() - 1u));
    const int size = grouped ? __popc(twins) : 1;
    float* rows = take_stage(m, stage, lock);
    while (__ballot_sync(m, pending) != 0u) {
      // _next_inst: the nearest crossed instance strictly after the cursor;
      // a group scans a slice of the instances a twin and takes the nearest
      // (tnear, id) of the slices' nearest
      float cur_tn = kBig;
      int cur_id = 0x7FFFFFFF;
      if (pending) {
        const float bound = fminf(tmax, best);
        for (int i = grouped ? rank : 0; i < n_inst; i += size) {
          float tnear, tfar;
          box_interval(inst + i * kInstWords, o, inv, tmin, bound, tnear, tfar);
          const bool ok =
              (tnear <= tfar) && ((tnear > last_tn) || ((tnear == last_tn) && (i > last_id)));
          if (ok && ((tnear < cur_tn) || ((tnear == cur_tn) && (i < cur_id)))) {
            cur_tn = tnear;
            cur_id = i;
          }
        }
        if (grouped) {
          const unsigned key = t_key(cur_tn);
          const unsigned kmin = __reduce_min_sync(twins, key);
          const unsigned idmin =
              __reduce_min_sync(twins, key == kmin ? static_cast<unsigned>(cur_id) : ~0u);
          const int src =
              __ffs(__ballot_sync(twins, key == kmin && static_cast<unsigned>(cur_id) == idmin)) -
              1;
          cur_tn = __shfl_sync(twins, cur_tn, src);
          cur_id = __shfl_sync(twins, cur_id, src);
        }
        pending = cur_tn < kBig;
      }
      const float* r = inst + (pending ? cur_id : 0) * kInstWords + kInstRow;
      V3 oo = o, dd = d;
      int mesh = 0;
      if (pending) {
        xform(r, o, d, oo, dd);
        mesh = static_cast<int>(r[12]);
      }
      Winner w;
      bool won = false;
      walk_clusters<false, kTwins>(m, twins, pending, rows, box,
                                   order + (octant(dd) * n_meshes + mesh) * cmax, cmax,
                                   mesh * cmax, pack, pack_w, k, oo, dd, inv_dir3(dd), tmin, tmax,
                                   best, w, won);
      if (won) {
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
      if (pending) {
        last_tn = cur_tn;
        last_id = cur_id;
      }
    }
    drop_stage(m, rows, lock);
    kind = epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
    return closest_from_walker<kTwins>(m, twins, kind, t_out, mat, normal, hu, hv);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
    // empty intervals count as blocked (pallas_inst any_hit :915-925)
    bool blocked = tmax <= tmin || sphere_any(sph, n_sphs, o, d, tmin, tmax);
    const V3 inv = inv_dir3(d);
    float best = kBig;
    Winner w;
    float* rows = take_stage(m, stage, lock);
    for (int i = 0; i < n_inst; ++i) {
      if (__ballot_sync(m, walker && !blocked) == 0u) break;
      const float* b = inst + i * kInstWords;
      const bool cross = walker && !blocked && box_hit(b, o, inv, tmin, tmax);
      if (__ballot_sync(m, cross) == 0u) continue;
      const float* r = b + kInstRow;
      V3 oo = o, dd = d;
      if (cross) xform(r, o, d, oo, dd);
      const int mesh = static_cast<int>(r[12]);
      walk_clusters<true, kTwins>(m, twins, cross, rows, box,
                                  order + (octant(dd) * n_meshes + mesh) * cmax, cmax,
                                  mesh * cmax, pack, pack_w, k, oo, dd, inv_dir3(dd), tmin, tmax,
                                  best, w, blocked);
    }
    drop_stage(m, rows, lock);
    return from_walker<kTwins>(m, twins, static_cast<int>(blocked)) != 0;
  }
};

template <bool kTwins = false>
__device__ inline InstTracer<kTwins> inst_tracer(const Tables& tb, const SceneArgs& s,
                                                 int ray = 0) {
  return InstTracer<kTwins>{tb.sph,   tb.n_sphs,  tb.box,     tb.order,
                            tb.inst,  s.n_inst,   s.n_meshes, s.n_clusters / s.n_meshes,
                            s.pack,   s.pack_w,   s.cluster_size, warp_stage(tb),
                            warp_lock(tb), ray};
}

template <bool kTwins = false>
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
  float* stage;                          // shared: this warp's staging buffer, or null
  int* lock;
  int ray;                               // kTwins: the ray this thread carries

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal, float& hu, float& hv) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
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
    if (kTwins && __all_sync(m, __popc(twins) > 1)) {
      // each group of twins tests the supers a window at a time too
      group_walk<false>(twins, sbox, so, n_supers, 0, o, inv, tmin, tmax, best, won, [&](int s) {
        walk_clusters<false, kTwins>(twins, twins, true, nullptr, cbox, co + s * kSuperFan,
                                     kSuperFan, s * kSuperFan, pack, pack_w, k, o, d, inv, tmin,
                                     tmax, best, w, won);
      });
    } else {
      float* rows = take_stage(m, stage, lock);
      for (int j = 0; j < n_supers; ++j) {
        const int s = so[j];
        const float* b = sbox + s * kBoxWords;
        // all-padding supers are inverted; a super is opened only while the
        // bound tightened by the supers before it still reaches its box
        const bool open =
            walker && !(b[0] > b[3]) && box_hit(b, o, inv, tmin, fminf(tmax, best));
        if (__ballot_sync(m, open) == 0u) continue;
        walk_clusters<false, kTwins>(m, twins, open, rows, cbox, co + s * kSuperFan, kSuperFan,
                                     s * kSuperFan, pack, pack_w, k, o, d, inv, tmin, tmax, best,
                                     w, won);
      }
      drop_stage(m, rows, lock);
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
    kind = epilogue(kind, o, d, best, ax, ay, az, rinv, t_out, normal);
    return closest_from_walker<kTwins>(m, twins, kind, t_out, mat, normal, hu, hv);
  }

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    const unsigned m = __activemask();
    unsigned twins;
    const bool walker = walks<kTwins>(m, ray, twins);
    // empty intervals count as blocked (stream_any_tile :262-265)
    bool blocked = tmax <= tmin || sphere_any(sph, n_sphs, o, d, tmin, tmax);
    const V3 inv = inv_dir3(d);
    const int oct = octant(d);
    const uint16_t* so = sorder + oct * n_supers;
    const uint16_t* co = corder + static_cast<size_t>(oct) * n_supers * kSuperFan;
    float best = kBig;
    Winner w;
    if (kTwins && __all_sync(m, __popc(twins) > 1)) {
      group_walk<true>(twins, sbox, so, n_supers, 0, o, inv, tmin, tmax, best, blocked,
                       [&](int s) {
                         walk_clusters<true, kTwins>(twins, twins, true, nullptr, cbox,
                                                     co + s * kSuperFan, kSuperFan,
                                                     s * kSuperFan, pack, pack_w, k, o, d, inv,
                                                     tmin, tmax, best, w, blocked);
                       });
    } else {
      float* rows = take_stage(m, stage, lock);
      for (int j = 0; j < n_supers; ++j) {
        if (__ballot_sync(m, walker && !blocked) == 0u) break;
        const int s = so[j];
        const float* b = sbox + s * kBoxWords;
        const bool open = walker && !blocked && !(b[0] > b[3]) && box_hit(b, o, inv, tmin, tmax);
        if (__ballot_sync(m, open) == 0u) continue;
        walk_clusters<true, kTwins>(m, twins, open, rows, cbox, co + s * kSuperFan, kSuperFan,
                                    s * kSuperFan, pack, pack_w, k, o, d, inv, tmin, tmax, best,
                                    w, blocked);
      }
      drop_stage(m, rows, lock);
    }
    return from_walker<kTwins>(m, twins, static_cast<int>(blocked)) != 0;
  }
};

template <bool kTwins = false>
__device__ inline StreamTracer<kTwins> stream_tracer(const Tables& tb, const SceneArgs& s,
                                                     int ray = 0) {
  return StreamTracer<kTwins>{tb.sph,  tb.n_sphs, tb.box,  tb.order,       s.n_clusters,
                              s.cbox,  s.corder,  s.pack,  s.pack_w,       s.cluster_size,
                              warp_stage(tb), warp_lock(tb), ray};
}

}  // namespace spt
