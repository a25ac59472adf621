// The two tracers the kernels are templated on.  Both answer
//   int  closest(o, d, tmin, tmax, t, mat, normal)  -> kind (0 miss, 1 tri, 2 sphere)
//   bool occluded(o, d, tmin, tmax)
// for one ray per thread.
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
//   the 12-bit columns 19-23 exactly as bvh.decode_ns.
//
// What bounds the cluster tracer: per-thread ALU (a cluster open is 64
// Moller-Trumbore tests) and the latency of tri_pack reads.  The boxes and
// visit orders (a few KB) sit in shared memory; tri_pack (C*K rows of 24 or
// 25 floats, ~0.7 MB for 7168 triangles) is read through the read-only
// cache (__ldg) and stays resident in the 50 MB L2.  Padding clusters
// (inverted boxes, degenerate triangles only) are skipped without a test;
// the TPU's slab test flags them and opens triangles that cannot hit.

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
                         V3& normal) const {
    best = INFINITY;
    int kind = 0;
    mat = 0;
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
constexpr int kPackNs = 19;         // first of the five packed shading-normal columns
constexpr int kPackFlat = 24;       // pack width without shading normals

// pallas_trace._inv_dir: zero components become +-1e30.
__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > F32(1e-20) ? 1.0f / x : (x >= 0.0f ? kBig : -kBig);
}

// pallas_trace._box_flags for one box and one ray.
__device__ __forceinline__ bool box_hit(const float* b, V3 o, V3 inv, float tmin, float bound) {
  const float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
  const float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
  const float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
  const float tnear =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), bound));
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

struct ClusterTracer {
  const float* sph;                // shared: kSphWords rows
  int n_sphs;
  const float* box;                // shared: kBoxWords per cluster
  const uint16_t* order;           // shared: 8 x C cluster ids, front to back
  int n_clusters;
  const float* __restrict__ pack;  // global: (C*K, pack_w)
  int pack_w, k;

  __device__ int closest(V3 o, V3 d, float tmin, float tmax, float& t_out, int& mat,
                         V3& normal) const {
    float best = kBig;
    int kind = 0;
    mat = 0;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, rinv = 0.0f;
    // analytic spheres first (_sphere_pass_closest)
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

    const V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
    const int oct = (d.x < 0.0f) * 4 + (d.y < 0.0f) * 2 + (d.z < 0.0f);
    const uint16_t* ord = order + oct * n_clusters;
    const int kb = (k % 8 == 0) ? 8 : k;  // pallas_trace._sub_k
    for (int j = 0; j < n_clusters; ++j) {
      const float* b = box + ord[j] * kBoxWords;
      // padding clusters (inverted boxes) hold only degenerate triangles
      if (b[0] > b[3] || !box_hit(b, o, inv, tmin, fminf(tmax, best))) continue;
      const int c = ord[j];
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
      // winner resolution (make_cluster_opener.resolve)
      const float* w = blk + wi * pack_w;
      float nx = __ldg(w + kPackCross), ny = __ldg(w + kPackCross + 1),
            nz = __ldg(w + kPackCross + 2);
      if (pack_w > kPackFlat) {
        const float p0 = __ldg(w + kPackNs), p1 = __ldg(w + kPackNs + 1),
                    p2 = __ldg(w + kPackNs + 2), p3 = __ldg(w + kPackNs + 3),
                    p4 = __ldg(w + kPackNs + 4);
        const bool allz = (p0 + p1 + p2 + p3 + p4) <= 0.0f;
        float n0x, n0y, n0z, d1x, d1y, d1z, d2x, d2y, d2z, unused;
        ns_split(p0, n0x, n0y);
        ns_split(p1, n0z, d1x);
        ns_split(p2, d1y, d1z);
        ns_split(p3, d2x, d2y);
        ns_split(p4, d2z, unused);
        const float snx = ns_dequant(n0x) + pu * ns_dequant(d1x) + pv * ns_dequant(d2x);
        const float sny = ns_dequant(n0y) + pu * ns_dequant(d1y) + pv * ns_dequant(d2y);
        const float snz = ns_dequant(n0z) + pu * ns_dequant(d1z) + pv * ns_dequant(d2z);
        const bool geom = allz || (snx * snx + sny * sny + snz * snz <= F32(1e-12));
        if (!geom) {
          nx = snx;
          ny = sny;
          nz = snz;
        }
      }
      mat = static_cast<int>(__ldg(w + kPackMat));
      ax = nx;
      ay = ny;
      az = nz;
      kind = 1;
      best = tm;
    }

    // closest_epilogue
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

  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) const {
    // empty intervals count as blocked (any_hit_tile :631-637)
    if (tmax <= tmin) return true;
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
    const V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
    const int oct = (d.x < 0.0f) * 4 + (d.y < 0.0f) * 2 + (d.z < 0.0f);
    const uint16_t* ord = order + oct * n_clusters;
    for (int j = 0; j < n_clusters; ++j) {
      const float* b = box + ord[j] * kBoxWords;
      if (b[0] > b[3] || !box_hit(b, o, inv, tmin, tmax)) continue;
      const int c = ord[j];
      const float* __restrict__ blk = pack + static_cast<size_t>(c) * k * pack_w;
      for (int row = 0; row < k; ++row) {
        float t, u, v;
        if (pack_test(blk + row * pack_w, o, d, tmin, tmax, t, u, v)) return true;
      }
    }
    return false;
  }
};

__device__ inline ClusterTracer cluster_tracer(const Tables& tb, const SceneArgs& s) {
  return ClusterTracer{tb.sph, tb.n_sphs, tb.box, tb.order, s.n_clusters, s.pack, s.pack_w,
                       s.cluster_size};
}

}  // namespace spt
