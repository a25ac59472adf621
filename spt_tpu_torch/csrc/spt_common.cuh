// Device code shared by the path-tracing kernels: vec3, rng, sampling, the
// packed scene tables, the texture sampler (K6) and one bounce of shading
// (shade_bounce), templated on the tracer (spt_tracers.cuh).
//
// Numerics: every translation unit is built with --fmad=false and without
// fast math, and every expression below is evaluated in the order of the
// plain PyTorch version (transport.py, sampling.py, vec3.py, intersect.py),
// so a kernel rounds op for op like it and branch decisions (the RR test
// xi_rr >= survival, the Fresnel test xi_d < fr, the triangle edge tests)
// agree.  Each lane computes only its own scatter branch; the RNG stream
// still matches the select-all-branches version because every branch
// starts from the same post-NEE state, the metal branch keeps that state
// when cos_nv <= 0, and only surface lanes write their state back.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace spt {

// Constants as the plain version rounds them: a Python double cast to float.
#define F32(x) (static_cast<float>(x))
constexpr double kPi = 3.14159265358979323846;

// Packed table layout, in 32-bit words (ints are stored as their bits).
constexpr int kSphWords = 5;    // center xyz | radius | mat (mesh forms)
constexpr int kMatWords = 12;   // base xyz | metallic | roughness | ior | type | emission xyz | transparency | tex_id
constexpr int kLightWords = 11; // kind | vec xyz | color xyz | intensity | attenuation xyz
constexpr int kEmitWords = 13;  // v0 xyz | e1 xyz | e2 xyz | le xyz | area
constexpr int kNsWords = 9;     // n0 | n1-n0 | n2-n0
constexpr int kUvWords = 6;     // uv0 | uv1-uv0 | uv2-uv0
constexpr int kBoxWords = 6;    // cluster lo xyz | hi xyz
constexpr int kInstWords = 22;  // world box lo xyz | hi xyz | bvh.InstAccel.inst row (16)
constexpr int kSuperFan = 16;   // clusters per supercluster (bvh.SUPER_FAN)

// The small forms' (accel mode None) triangle and sphere rows, padded to
// 16-byte words so that a test reads its row with float4 shared loads.
constexpr int kSmallTriWords = 12;  // v0 xyz e1x | e1yz e2xy | e2z mat, 2 unused
constexpr int kSmallSphWords = 8;   // center xyz radius | mat, 3 unused

// Every kernel runs blocks of kWarps warps (128 threads).  In the mesh forms
// each warp owns a staging buffer in shared memory (spt_tracers.cuh): the
// kMtCols Moller-Trumbore columns (v0 | e1 | e2) of up to kStageRows
// cluster rows, 2304 B, and a lock word.
constexpr int kWarps = 4;
constexpr int kMtCols = 9;
constexpr int kStageRows = 64;
constexpr int kStageFloats = kStageRows * kMtCols;

// RenderConfig toggles, one bit each.
constexpr int kNee = 1 << 0;            // cfg.nee and the scene has emitters
constexpr int kShadowRays = 1 << 1;
constexpr int kMetalVndf = 1 << 2;
constexpr int kMetalMirror = 1 << 3;
constexpr int kCpuTransparency = 1 << 4;
constexpr int kDepthTermNormalVis = 1 << 5;
constexpr int kDirectLightDielectric = 1 << 6;
constexpr int kHasNs = 1 << 7;          // the flat tables carry shading normals
constexpr int kTextured = 1 << 8;       // the scene has a texture table

// The mesh forms' scene tables as one float buffer in global memory,
// copied whole into shared memory by every block:
//   sph | mat | light | emit | cluster boxes | instances | octant keys
// (the small forms read their own layout, small_table_words).  The
// resident form fills the cluster boxes and bvh.MeshAccel.cl_okey (8 x C int32 bits, (rank << 16) | cluster id).  The
// instanced form fills the boxes of every BLAS (M x CMAX, padding clusters
// inverted), the instance rows and the BLAS keys (8M x CMAX, row
// octant * M + mesh, ranks 0..CMAX-1 per row).  The stream form fills the
// supercluster level only: the G super boxes and sup_okey (8 x G), with
// n_clusters = G; its cluster boxes and per-super visit orders stay in
// global memory (cbox, corder).  From the keys every block builds the
// front-to-back visit orders (uint16 ids, one row of C / M per key row) in
// shared memory after the tables.  The mesh forms' triangles stay in
// global memory (tri_pack), and so does the texture table.
struct SceneArgs {
  const float* tables;
  int n_tris, n_sphs, n_mats, n_lights, n_emit, flags;
  const float* pack;  // mesh forms: (C*K, pack_w) tri_pack, else null
  int pack_w, n_clusters, cluster_size;
  int n_inst, n_meshes;  // instanced form: I, M (C = M * CMAX); else 0, 1
  const int* tex;        // textured: (n_tex, res^2, 2) int32, else null
  int tex_res;
  // stream form: (G * kSuperFan, 6) cluster boxes and bvh.MeshAccel.cl_order
  // (8 x G * kSuperFan local ids), both in global memory; else null
  const float* cbox;
  const uint16_t* corder;
};

struct Tables {
  const float *tri, *sph, *mat, *light, *emit, *ns, *uv, *box, *inst;
  const uint16_t* order;
  const int* tex;
  float* stage;     // mesh forms: kWarps staging buffers, else null
  int* stage_lock;  // mesh forms: kWarps lock words, else null
  int n_tris, n_sphs, n_mats, n_lights, n_emit, tex_res;
};

__host__ __device__ inline int table_words(const SceneArgs& s) {
  return s.n_sphs * kSphWords + s.n_mats * kMatWords + s.n_lights * kLightWords +
         s.n_emit * kEmitWords + s.n_clusters * (kBoxWords + 8) + s.n_inst * kInstWords;
}

// Bytes of the tables plus the visit orders.
__host__ __device__ inline size_t table_bytes(const SceneArgs& s) {
  return sizeof(float) * static_cast<size_t>(table_words(s)) +
         sizeof(uint16_t) * 8 * static_cast<size_t>(s.n_clusters);
}

// The mesh forms' staging buffers start at the first 16-byte boundary
// after the tables.
__host__ __device__ inline size_t stage_offset(const SceneArgs& s) {
  return (table_bytes(s) + 15) / 16 * 16;
}

// Dynamic shared memory of a mesh form's block: the tables and visit
// orders, then the warps' staging buffers and lock words.
__host__ __device__ inline size_t smem_bytes(const SceneArgs& s) {
  return stage_offset(s) + kWarps * (sizeof(float) * kStageFloats + sizeof(int));
}

// Copies the tables into shared memory, builds the visit orders (the whole
// block takes part), frees the staging buffers and returns the pointers
// into it.
__device__ inline Tables load_tables(float* smem, const SceneArgs& s) {
  const int words = table_words(s);
  for (int k = threadIdx.x; k < words; k += blockDim.x) smem[k] = s.tables[k];
  // order[row * cmax + rank] = id, from the keys in global memory
  const int c = s.n_clusters;
  const int cmax = c / max(s.n_meshes, 1);
  const int* okey = reinterpret_cast<const int*>(s.tables + words - 8 * c);
  uint16_t* order = reinterpret_cast<uint16_t*>(smem + words);
  for (int k = threadIdx.x; k < 8 * c; k += blockDim.x) {
    const int key = okey[k];
    order[(k / cmax) * cmax + (key >> 16)] = static_cast<uint16_t>(key & 0xFFFF);
  }
  float* stage = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + stage_offset(s));
  int* stage_lock = reinterpret_cast<int*>(stage + kWarps * kStageFloats);
  if (threadIdx.x < kWarps) stage_lock[threadIdx.x] = 0;
  __syncthreads();
  Tables tb;
  tb.stage = stage;
  tb.stage_lock = stage_lock;
  tb.tri = tb.ns = tb.uv = nullptr;  // the mesh forms' triangles are in tri_pack
  tb.sph = smem;
  tb.mat = tb.sph + s.n_sphs * kSphWords;
  tb.light = tb.mat + s.n_mats * kMatWords;
  tb.emit = tb.light + s.n_lights * kLightWords;
  tb.box = tb.emit + s.n_emit * kEmitWords;
  tb.inst = tb.box + s.n_clusters * kBoxWords;
  tb.order = order;
  tb.tex = (s.flags & kTextured) ? s.tex : nullptr;
  tb.tex_res = s.tex_res;
  tb.n_tris = s.n_tris;
  tb.n_sphs = s.n_sphs;
  tb.n_mats = s.n_mats;
  tb.n_lights = s.n_lights;
  tb.n_emit = s.n_emit;
  return tb;
}

// The small forms' tables, copied whole into shared memory by every
// block (the first 16-byte aligned):
//   tri (kSmallTriWords) | sph (kSmallSphWords) | mat | light | emit | ns | uv
// with ns on a scene with shading normals and uv on a textured one.
__host__ __device__ inline int small_table_words(const SceneArgs& s) {
  return s.n_tris * kSmallTriWords + s.n_sphs * kSmallSphWords + s.n_mats * kMatWords +
         s.n_lights * kLightWords + s.n_emit * kEmitWords +
         ((s.flags & kHasNs) ? s.n_tris * kNsWords : 0) +
         ((s.flags & kTextured) ? s.n_tris * kUvWords : 0);
}

// load_tables for the small layout; `smem` 16-byte aligned.
__device__ inline Tables load_small_tables(float* smem, const SceneArgs& s) {
  const int words = small_table_words(s);
  for (int k = threadIdx.x; k < words; k += blockDim.x) smem[k] = s.tables[k];
  __syncthreads();
  Tables tb;
  tb.tri = smem;
  tb.sph = tb.tri + s.n_tris * kSmallTriWords;
  tb.mat = tb.sph + s.n_sphs * kSmallSphWords;
  tb.light = tb.mat + s.n_mats * kMatWords;
  tb.emit = tb.light + s.n_lights * kLightWords;
  const float* after_emit = tb.emit + s.n_emit * kEmitWords;
  tb.ns = (s.flags & kHasNs) ? after_emit : nullptr;
  tb.uv = (s.flags & kTextured)
              ? after_emit + ((s.flags & kHasNs) ? s.n_tris * kNsWords : 0)
              : nullptr;
  tb.box = tb.inst = nullptr;
  tb.order = nullptr;
  tb.tex = (s.flags & kTextured) ? s.tex : nullptr;
  tb.stage = nullptr;
  tb.stage_lock = nullptr;
  tb.tex_res = s.tex_res;
  tb.n_tris = s.n_tris;
  tb.n_sphs = s.n_sphs;
  tb.n_mats = s.n_mats;
  tb.n_lights = s.n_lights;
  tb.n_emit = s.n_emit;
  return tb;
}

struct ShadeArgs {
  int rr_after, flags;
  float hit_eps, ray_offset_dir, firefly_clamp;
};

// --- vec3 (ops/vec3.py) --------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ int as_int(float f) { return __float_as_int(f); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// vec3.safe_normalize: zero vectors stay zero; rsqrt as the plain version.
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  float l2 = dot(v, v);
  float inv = l2 > 0.0f ? rsqrtf(l2) : 0.0f;
  return scale(v, inv);
}

// vec3.normalize_or
__device__ __forceinline__ V3 normalize_or(V3 v, V3 fallback) {
  float l2 = dot(v, v);
  bool ok = l2 > 0.0f;
  float inv = rsqrtf(ok ? l2 : 1.0f);
  return ok ? scale(v, inv) : fallback;
}

__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.0f * dot(i, n))); }

__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// vec3.make_onb, written out with up = (upx, 0, 1 - upx) as the plain version.
__device__ __forceinline__ void make_onb(V3 n, V3& t, V3& b) {
  bool use_z = fabsf(n.z) < F32(0.999);
  float upx = use_z ? 0.0f : 1.0f;
  float uz = 1.0f - upx;
  V3 up = v3(upx, 0.0f, uz);
  t = safe_normalize(cross(up, n));
  b = cross(n, t);
}

__device__ __forceinline__ V3 from_onb(V3 t, V3 b, V3 n, float lx, float ly, float lz) {
  return add(add(scale(t, lx), scale(b, ly)), scale(n, lz));
}

// vec3.refract: returns the direction (zero on TIR) and can_refract.
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta, bool& can) {
  float cosi = clampf(-dot(n, i), -1.0f, 1.0f);
  float sin2t = eta * eta * fmaxf(1.0f - cosi * cosi, 0.0f);
  can = sin2t <= 1.0f;
  float cost = sin2t < 1.0f ? sqrtf(1.0f - sin2t) : 0.0f;
  V3 t = add(scale(i, eta), scale(n, eta * cosi - cost));
  t = safe_normalize(t);
  return can ? t : v3(0.0f, 0.0f, 0.0f);
}

// intersect.safe_origin_v with front = true
__device__ __forceinline__ V3 safe_origin(V3 p, V3 n) {
  float mag = fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z)));
  float eps = F32(1e-4) * fmaxf(mag, 1.0f);
  return add(p, scale(n, eps));
}

// --- rng (ops/rng.py) ----------------------------------------------------------

__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  return x;
}

__device__ __forceinline__ float next_float(uint32_t& s) {
  s = wang_hash(s);
  return static_cast<float>(static_cast<int>(s & 0x00FFFFFFu)) * F32(1.0 / 16777216.0);
}

// --- sampling (ops/sampling.py) ------------------------------------------------

__device__ __forceinline__ float fresnel_schlick_eta(float cos_i, float eta_i, float eta_t) {
  float r0 = (eta_t - eta_i) / (eta_t + eta_i);
  r0 = r0 * r0;
  float m = 1.0f - clampf(cos_i, 0.0f, 1.0f);
  return r0 + (1.0f - r0) * m * m * m * m * m;
}

__device__ __forceinline__ V3 fresnel_schlick_v(float cos_vh, V3 f0) {
  float m = 1.0f - clampf(cos_vh, 0.0f, 1.0f);
  float m5 = (m * m) * (m * m) * m;
  return v3(f0.x + (1.0f - f0.x) * m5, f0.y + (1.0f - f0.y) * m5, f0.z + (1.0f - f0.z) * m5);
}

__device__ __forceinline__ float roughness_to_alpha(float roughness) {
  float r = clampf(roughness, F32(0.02), 1.0f);
  return r * r;
}

__device__ __forceinline__ float d_ggx(float cos_nh, float alpha) {
  cos_nh = fmaxf(cos_nh, 0.0f);
  float a2 = alpha * alpha;
  float denom = cos_nh * cos_nh * (a2 - 1.0f) + 1.0f;
  return a2 / (F32(kPi) * denom * denom);
}

__device__ __forceinline__ float g1_schlick(float c, float k) { return c / (c * (1.0f - k) + k); }

__device__ __forceinline__ float g_smith_cpu(float cos_nv, float cos_nl, float alpha) {
  float r = clampf(sqrtf(fmaxf(alpha, 0.0f)), F32(0.02), 1.0f);
  float k = (r + 1.0f) * (r + 1.0f) / 8.0f;
  return g1_schlick(fmaxf(cos_nv, 0.0f), k) * g1_schlick(fmaxf(cos_nl, 0.0f), k);
}

__device__ __forceinline__ float g_smith_gpu(float cos_nl, float cos_nv, float alpha) {
  float a = alpha + 1.0f;
  float k = a * a * 0.125f;
  return g1_schlick(cos_nl, k) * g1_schlick(cos_nv, k);
}

__device__ inline V3 evaluate_brdf(V3 n, V3 v, V3 l, V3 base, float metallic, float roughness,
                                   float ior) {
  V3 h = safe_normalize(add(v, l));
  float cos_nv = fmaxf(dot(n, v), 0.0f);
  float cos_nl = fmaxf(dot(n, l), 0.0f);
  float cos_hv = fmaxf(dot(h, v), 0.0f);
  float cos_nh = fmaxf(dot(n, h), 0.0f);
  float alpha = roughness_to_alpha(roughness);
  float d = d_ggx(cos_nh, alpha);
  float g = g_smith_cpu(cos_nv, cos_nl, alpha);
  float q = (ior - 1.0f) / (ior + 1.0f);
  float f0_diel = q * q;
  float f0s = f0_diel * (1.0f - metallic);
  V3 f0 = v3(base.x * metallic + f0s, base.y * metallic + f0s, base.z * metallic + f0s);
  V3 f = fresnel_schlick_v(cos_hv, f0);
  float spec_scale = (d * g) / (4.0f * cos_nv * cos_nl + F32(1e-4));
  V3 specular = scale(f, spec_scale);
  V3 kd = v3(1.0f - f.x, 1.0f - f.y, 1.0f - f.z);
  V3 diffuse = scale(base, (1.0f - metallic) / F32(kPi));
  return scale(add(mul(kd, diffuse), specular), cos_nl);
}

__device__ inline V3 cosine_sample(V3 n, float u1, float u2) {
  float r = safe_sqrt(u1);
  float phi = F32(2.0 * kPi) * u2;
  float lx = r * cosf(phi);
  float ly = r * sinf(phi);
  float lz = safe_sqrt(1.0f - u1);
  V3 t, b;
  make_onb(n, t, b);
  return safe_normalize(from_onb(t, b, n, lx, ly, lz));
}

__device__ inline V3 ggx_sample_half_vector(float u1, float u2, float alpha, V3 n) {
  float a2 = alpha * alpha;
  float phi = F32(2.0 * kPi) * u1;
  float denom = 1.0f + (a2 - 1.0f) * u2;
  float cos_t = safe_sqrt((1.0f - u2) / denom);
  float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
  float lx = sin_t * cosf(phi);
  float ly = sin_t * sinf(phi);
  V3 t, b;
  make_onb(n, t, b);
  return normalize_or(from_onb(t, b, n, lx, ly, cos_t), n);
}

__device__ inline V3 ggx_sample_vndf(float u1, float u2, float alpha, V3 n, V3 v) {
  V3 t, b;
  make_onb(n, t, b);
  V3 vh = safe_normalize(v3(dot(v, t), dot(v, b), dot(v, n)));
  V3 vs = safe_normalize(v3(alpha * vh.x, alpha * vh.y, vh.z));
  V3 t1 = safe_normalize(cross(v3(0.0f, 0.0f, 1.0f), vs));
  if (!(vs.z < F32(0.9999))) t1 = v3(1.0f, 0.0f, 0.0f);
  V3 t2 = cross(vs, t1);
  float r_disk = safe_sqrt(u1);
  float phi = F32(2.0 * kPi) * u2;
  float p1 = r_disk * cosf(phi);
  float p2 = r_disk * sinf(phi);
  float s = 0.5f * (1.0f + vs.z);
  p2 = (1.0f - s) * safe_sqrt(1.0f - p1 * p1) + s * p2;
  float p3 = safe_sqrt(1.0f - p1 * p1 - p2 * p2);
  V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vs, p3));
  V3 h_local = safe_normalize(v3(alpha * nh.x, alpha * nh.y, fmaxf(nh.z, 0.0f)));
  return safe_normalize(from_onb(t, b, n, h_local.x, h_local.y, h_local.z));
}

// --- the texture sampler (K6: transport.sample_texture_v) ----------------------

// Bilinear sample of texture tex_id at (u, v): the glTF REPEAT wrap and
// texel-centre setup of transport._bilinear_setup, four taps of one 8-byte
// load each (plane 0 the sqrt-encoded 10/10/10 baseColor, plane 1 the
// 16/16 roughness/metallic multipliers, texel (ty, tx) at row ty * res +
// tx), each tap unpacked as materials.unpack_color / unpack_mr and summed
// in the plain version's order.  Replaces the Pallas sampler
// spt_tpu/ops/pallas_bounce.py:527 (_make_texture_sampler, with
// _gather_rc :510): its distinct-key while loop, (8, 128) tile gathers and
// whole-tile skip are TPU devices; a thread here loads its own four texels
// through the read-only cache, and a 256^2 table (512 KiB a texture) stays
// in L2.
__device__ inline void sample_texture(const int* __restrict__ tex, int res, int tex_id, float u,
                                      float v, V3& rgb, float& rough, float& metal) {
  const float fu = u - floorf(u);
  const float fv = v - floorf(v);
  const float sx = fu * static_cast<float>(res) - 0.5f;
  const float sy = fv * static_cast<float>(res) - 0.5f;
  const int x0 = static_cast<int>(floorf(sx));
  const int y0 = static_cast<int>(floorf(sy));
  const float wx = sx - static_cast<float>(x0);
  const float wy = sy - static_cast<float>(y0);
  const int xs[2] = {x0 < 0 ? x0 + res : x0, x0 + 1 >= res ? 0 : x0 + 1};
  const int ys[2] = {y0 < 0 ? y0 + res : y0, y0 + 1 >= res ? 0 : y0 + 1};
  const float wxs[2] = {1.0f - wx, wx};
  const float wys[2] = {1.0f - wy, wy};
  const int2* __restrict__ base =
      reinterpret_cast<const int2*>(tex) + static_cast<size_t>(tex_id) * res * res;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int a = 0; a < 2; ++a) {
    for (int b = 0; b < 2; ++b) {
      const int2 p = __ldg(base + ys[b] * res + xs[a]);
      const float w = wxs[a] * wys[b];
      const float cr = static_cast<float>((p.x >> 20) & 1023) * F32(1.0 / 1023.0);
      const float cg = static_cast<float>((p.x >> 10) & 1023) * F32(1.0 / 1023.0);
      const float cb = static_cast<float>(p.x & 1023) * F32(1.0 / 1023.0);
      const float vals[5] = {cr * cr, cg * cg, cb * cb,
                             static_cast<float>((p.y >> 16) & 0xFFFF) * F32(1.0 / 65535.0),
                             static_cast<float>(p.y & 0xFFFF) * F32(1.0 / 65535.0)};
      for (int i = 0; i < 5; ++i) acc[i] = acc[i] + w * vals[i];
    }
  }
  rgb = v3(acc[0], acc[1], acc[2]);
  rough = acc[3];
  metal = acc[4];
}

// --- one bounce (transport.trace_bounce + transport.shade_core) ----------------

// One bounce of a live lane.  Updates the lane's state in place, sets
// `missed` when the ray left the scene (the lane then keeps its direction
// and throughput for the deferred environment term) and returns whether
// the lane is alive afterwards.
template <class Tracer>
__device__ inline bool shade_bounce(const Tables& tb, const Tracer& tr, const ShadeArgs& sa,
                                    int bounce, bool is_last, V3& o, V3& d, V3& thr, V3& rad,
                                    uint32_t& rng, bool& emok, bool& missed) {
  const bool nee_on = sa.flags & kNee;
  const bool shadow_rays = sa.flags & kShadowRays;
  const bool metal_vndf = sa.flags & kMetalVndf;
  const bool metal_mirror = sa.flags & kMetalMirror;
  const bool cpu_transparency = sa.flags & kCpuTransparency;
  const bool normal_vis = sa.flags & kDepthTermNormalVis;
  const bool direct_diel = sa.flags & kDirectLightDielectric;
  const V3 up = v3(0.0f, 1.0f, 0.0f);

  float t, hu, hv;
  int mat_id;
  V3 hn;
  if (tr.closest(o, d, 0.0f, F32(1e30), t, mat_id, hn, hu, hv) == 0) {
    missed = true;
    return false;
  }
  missed = false;

  // --- surface setup ---
  const float* m = tb.mat + min(max(mat_id, 0), tb.n_mats - 1) * kMatWords;
  V3 base = load3(m);
  float metallic = m[3], roughness = m[4];
  const float ior = m[5];
  const int mat_type = as_int(m[6]);
  if (tb.tex != nullptr) {
    // the texture channels multiply the material factors; untextured
    // materials take multipliers of 1, and every lane is clipped
    V3 trgb = v3(1.0f, 1.0f, 1.0f);
    float trough = 1.0f, tmetal = 1.0f;
    const int tex_id = as_int(m[11]);
    if (tex_id >= 0) sample_texture(tb.tex, tb.tex_res, tex_id, hu, hv, trgb, trough, tmetal);
    base = mul(base, trgb);
    roughness = clampf(roughness * trough, F32(0.01), 1.0f);
    metallic = clampf(metallic * tmetal, 0.0f, 1.0f);
  }
  const V3 emission = load3(m + 7);
  const float transparency = m[10];

  const V3 ng = normalize_or(hn, up);
  const bool entering = dot(d, ng) < 0.0f;
  const V3 n = entering ? ng : neg(ng);
  const V3 p = add(o, scale(d, t));

  const V3 diffuse_color = scale(base, 1.0f - metallic);
  const bool is_dielectric = mat_type == 1;
  const bool is_metal = (metallic > 0.5f) && !is_dielectric;
  const bool is_diffuse = !is_metal && !is_dielectric;

  // --- emission ---
  if (!nee_on || emok) rad = add(rad, mul(thr, emission));

  // --- direct lighting over the light table ---
  const bool direct_ok = direct_diel || !is_dielectric;
  const V3 view = safe_normalize(neg(d));
  for (int li = 0; li < tb.n_lights; ++li) {
    const float* L = tb.light + li * kLightWords;
    const int kind = as_int(L[0]);
    const V3 lv0 = load3(L + 1);
    const float it = L[7];
    const V3 c = v3(L[4] * it, L[5] * it, L[6] * it);
    const float a0 = L[8], a1 = L[9], a2 = L[10];
    const bool is_point = kind == 2;
    const V3 lv = sub(lv0, p);
    const float dist_p = sqrtf(lv.x * lv.x + lv.y * lv.y + lv.z * lv.z);
    const float inv = 1.0f / fmaxf(dist_p, F32(1e-12));
    const float atten = a0 + a1 * dist_p + a2 * dist_p * dist_p;
    const float inv_at = 1.0f / fmaxf(atten, F32(1e-12));
    const V3 ldir = is_point ? scale(lv, inv) : lv0;
    const float ldist = is_point ? dist_p : F32(1e30);
    const V3 li_rad = is_point ? scale(c, inv_at) : c;
    const float cos_theta = fmaxf(dot(n, ldir), 0.0f);
    bool contrib = direct_ok && (kind != 0) && (cos_theta > 0.0f);
    if (contrib && shadow_rays)
      contrib = !tr.occluded(safe_origin(p, n), ldir, sa.hit_eps, ldist - sa.hit_eps);
    if (contrib) {
      V3 brdf = evaluate_brdf(n, view, ldir, base, metallic, roughness, ior);
      rad = add(rad, mul(mul(thr, brdf), li_rad));
    }
  }

  // --- NEE toward emissive triangles ---
  if (nee_on) {
    const int e_count = tb.n_emit;
    const float xe = next_float(rng);
    const float xu1 = next_float(rng);
    const float xu2 = next_float(rng);
    // uniform pick: truncate toward zero, then clamp
    const int pick = min(max(static_cast<int>(xe * static_cast<float>(e_count)), 0), e_count - 1);
    const float* E = tb.emit + pick * kEmitWords;
    const V3 ev0 = load3(E), ee1 = load3(E + 3), ee2 = load3(E + 6), ele = load3(E + 9);
    const float earea = E[12];
    const float su = safe_sqrt(xu1);
    const float b1 = 1.0f - su;
    const float b2 = xu2 * su;
    const V3 pe = add(add(ev0, scale(ee1, b1)), scale(ee2, b2));
    const V3 to_e = sub(pe, p);
    const float dist = fmaxf(sqrtf(dot(to_e, to_e)), F32(1e-6));
    const V3 wi = scale(to_e, 1.0f / dist);
    const V3 n_e = safe_normalize(cross(ee1, ee2));
    const float cos_e = fabsf(dot(n_e, wi));
    const float cos_s = dot(n, wi);
    bool nee_mask = !is_dielectric && (cos_s > 0.0f) && (cos_e > F32(1e-6));
    if (nee_mask && shadow_rays)
      nee_mask = !tr.occluded(safe_origin(p, n), wi, sa.hit_eps, dist * F32(1.0 - 1e-3));
    if (nee_mask) {
      V3 brdf = evaluate_brdf(n, view, wi, base, metallic, roughness, ior);
      const float weight = (cos_e / (dist * dist)) * (earea * static_cast<float>(e_count));
      rad = add(rad, scale(mul(mul(thr, brdf), ele), weight));
    }
  }

  // --- scatter: this lane's branch only, each from the post-NEE state ---
  V3 new_dir, new_org, new_thr;
  uint32_t new_rng = rng;
  bool rr_dead = false;
  if (is_dielectric) {
    const float xi_d = next_float(new_rng);
    const float eta_i = entering ? 1.0f : ior;
    const float eta_t = entering ? ior : 1.0f;
    const float eta = eta_i / eta_t;
    const float cos_i = clampf(-dot(d, n), -1.0f, 1.0f);
    const float fr = fresnel_schlick_eta(cos_i, eta_i, eta_t);
    bool can_refract;
    const V3 refr_dir = refract(d, n, eta, can_refract);
    const V3 reflect_dir = safe_normalize(reflect(d, n));
    new_dir = (!can_refract || (xi_d < fr)) ? reflect_dir : refr_dir;
    new_org = add(p, scale(new_dir, sa.ray_offset_dir));
    new_thr = thr;
    if (cpu_transparency) {
      const float w_d = (xi_d < fr) ? 1.0f - transparency : (can_refract ? transparency : 1.0f);
      new_thr = scale(thr, w_d);
    }
  } else if (is_metal) {
    const float cos_nv_raw = dot(n, view);
    const V3 mirror_dir = normalize_or(reflect(d, n), n);
    if (metal_mirror) {
      new_dir = mirror_dir;
      new_thr = scale(mul(thr, base), metallic);
    } else {
      uint32_t rng_m = rng;
      const float u1 = next_float(rng_m);
      const float u2 = next_float(rng_m);
      const float alpha = roughness_to_alpha(roughness);
      const V3 h = metal_vndf ? ggx_sample_vndf(u1, u2, alpha, n, view)
                              : ggx_sample_half_vector(u1, u2, alpha, n);
      const float cos_nh_raw = dot(n, h);
      const V3 l_dir = normalize_or(reflect(neg(view), h), n);
      const float cos_nl_raw = dot(n, l_dir);
      const bool ggx_ok = (cos_nv_raw > 0.0f) && (cos_nh_raw > 0.0f) && (cos_nl_raw > 0.0f);
      const float cos_nv = fmaxf(cos_nv_raw, F32(1e-6));
      const float cos_nl = fmaxf(cos_nl_raw, F32(1e-6));
      const float cos_nh = fmaxf(cos_nh_raw, F32(1e-6));
      float scl;
      V3 f;
      if (metal_vndf) {
        const float cos_vh = fmaxf(dot(view, h), F32(1e-6));
        f = fresnel_schlick_v(cos_vh, base);
        const float g = g_smith_cpu(cos_nv, cos_nl, alpha);
        scl = clampf(g * cos_vh / cos_nh, 0.0f, sa.firefly_clamp);
      } else {
        const float cos_vh = fmaxf(dot(view, h), 0.0f);
        f = fresnel_schlick_v(cos_vh, base);
        const float g = g_smith_gpu(cos_nl, cos_nv, alpha);
        scl = clampf(g * cos_vh / (cos_nv * cos_nh), 0.0f, sa.firefly_clamp);
      }
      new_dir = ggx_ok ? l_dir : mirror_dir;
      new_thr = mul(thr, ggx_ok ? scale(f, scl) : base);
      // the GPU's cosNV <= 0 fallback bails before drawing randoms
      if (cos_nv_raw > 0.0f) new_rng = rng_m;
    }
    new_org = add(p, scale(n, F32(1e-3)));
  } else {
    const float du1 = next_float(new_rng);
    const float du2 = next_float(new_rng);
    new_dir = cosine_sample(n, du1, du2);
    new_org = safe_origin(p, n);
    const float survival =
        clampf(fmaxf(diffuse_color.x, fmaxf(diffuse_color.y, diffuse_color.z)), F32(1e-6), 1.0f);
    const float xi_rr = next_float(new_rng);
    const bool rr_on = bounce > sa.rr_after;
    rr_dead = rr_on && (xi_rr >= survival);
    new_thr = mul(thr, diffuse_color);
    if (rr_on) new_thr = scale(new_thr, 1.0f / survival);
  }

  const bool scatter_alive = !is_last && !(is_diffuse && rr_dead);

  // quirk 5: diffuse * normal-vis at max depth instead of black
  if (normal_vis && is_last) {
    const V3 nn = normalize_or(ng, up);
    const V3 nvis = v3((nn.x + 1.0f) * 0.5f, (nn.y + 1.0f) * 0.5f, (nn.z + 1.0f) * 0.5f);
    rad = add(rad, mul(mul(thr, diffuse_color), nvis));
  }
  if (nee_on) emok = scatter_alive ? is_dielectric : emok;
  if (scatter_alive) {
    o = new_org;
    d = new_dir;
    thr = new_thr;
  }
  rng = new_rng;
  return scatter_alive;
}

// Dynamic shared memory above the default 48 KiB needs an opt-in per
// kernel; returns the launch error to report, or cudaSuccess.
template <class K>
inline cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Registers per thread and local (spill) bytes of a kernel, and the blocks
// of `threads` threads (by default kWarps warps) an SM holds at once with
// `smem` bytes of dynamic shared memory each.  Returns the CUDA error (0:
// filled).
template <class K>
inline int kernel_info(K kernel, int smem, int* num_regs, int* local_bytes, int* blocks,
                       int threads = 32 * kWarps) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = reserve_smem(kernel, static_cast<size_t>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                        static_cast<size_t>(smem));
  if (err == cudaSuccess) {
    *num_regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // namespace spt
