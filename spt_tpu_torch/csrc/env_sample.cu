// env_sample: the deferred environment term's equirect lookup (K2), one
// thread per lane.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_env.py:192
// (`sample_equirect_pallas` -> `_sample_from_taps` :205, pallas_call :218,
// body `_env_kernel` :158 over `env_gather_tile` :59; the sorted variant
// `sample_equirect_pallas_sorted` :262 computes the same function in
// another lane order) together with the tap setup and the clamp x
// intensity its caller applies (spt_tpu/env.py:395-442).  A lane in `need`
// normalizes its direction (vec3.safe_normalize), computes the equirect
// taps as env._equirect_taps does (atan2f / acosf, texel-centre floor, wrap
// in u by a true modulo, per-tap clamp in v from the unclipped floor),
// loads its four texels, blends them in the plain version's order and
// applies min(., max_clamp) * intensity; a lane outside `need` writes 0 and
// loads nothing.  The TPU kernel min-extracts the distinct (8, 128) map
// tiles a lane tile touches and DMAs each, from a copy of the map pre-tiled
// for that DMA (pallas_env.env_pretile :149); here every thread loads its
// own texels through L2, from the map held in its texel layout
// (env.equirect_texels: each texel's RGB and a zero pad, 16 bytes, the
// layout every environment is made in), so that a tap is one aligned
// 16-byte load: 4 vector loads a lane where the
// (H, W, 3) map takes 12 scalar ones at a 12-byte stride (the 1024 x 2048
// bench map is 32 MiB so, still inside the 50 MB L2).
//
// Numerics: built with --fmad=false, every expression in the order of the
// plain PyTorch version (env.environment_color_v); PyTorch's CUDA division
// by a Python scalar multiplies by the scalar's float reciprocal, so the
// two divisions here do too.
//
// What bounds it on an H100: bytes — 13 B in and 12 B out per lane and up
// to 48 B of texels per needed lane (counted on the 12-byte texels of the
// map), about 46 operations a lane; the gathers are scattered wherever the
// deferred field's directions are.  A 16-byte texel never straddles two
// 32-byte sectors, as a third of the 12-byte ones do, and takes one load
// instruction in place of three; the column wrap divides only at the seam.
// On the card (frame_sweep.py, PERF.md) two or four lanes a thread with
// every load issued first, and blocks of 128 or 512, gained nothing, and
// the exact atan2f / acosf take about a tenth of the time.

#include "spt_common.cuh"

namespace {

using namespace spt;

constexpr int kEnvBlock = 256;

struct EnvIO {
  const float *dx, *dy, *dz;
  const uint8_t* need;  // null: every lane
  const float4* __restrict__ texels;  // (H, W, 4): RGB and a pad
  float *o_r, *o_g, *o_b;
  int n, h, w;
  float max_clamp, intensity;
};

// torch.clamp(x, max=c) keeps a NaN
__device__ __forceinline__ float clamp_max(float x, float c) { return isnan(x) ? x : fminf(x, c); }

__global__ void __launch_bounds__(kEnvBlock) env_sample_kernel(EnvIO io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  if (io.need != nullptr && io.need[i] == 0) {
    io.o_r[i] = 0.0f;
    io.o_g[i] = 0.0f;
    io.o_b[i] = 0.0f;
    return;
  }
  const V3 d = safe_normalize(v3(io.dx[i], io.dy[i], io.dz[i]));
  const float theta = atan2f(d.z, d.x);
  const float phi = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f));
  const float u = (theta + F32(kPi)) * (1.0f / F32(2.0 * kPi));
  const float v = phi * (1.0f / F32(kPi));
  const float x = u * static_cast<float>(io.w) - 0.5f;
  const float y = v * static_cast<float>(io.h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // torch.remainder, whose integer division only a column outside [0, w)
  // needs (x0 = -1 left of the u seam)
  int x0i = static_cast<int>(x0);
  if (x0i < 0 || x0i >= io.w) {
    x0i %= io.w;
    if (x0i < 0) x0i += io.w;
  }
  const int x1i = x0i + 1 == io.w ? 0 : x0i + 1;
  const int y0f = static_cast<int>(y0);
  const size_t r0 = static_cast<size_t>(min(max(y0f, 0), io.h - 1)) * io.w;
  const size_t r1 = static_cast<size_t>(min(max(y0f + 1, 0), io.h - 1)) * io.w;
  const float4 c00 = __ldg(io.texels + r0 + x0i);
  const float4 c01 = __ldg(io.texels + r0 + x1i);
  const float4 c10 = __ldg(io.texels + r1 + x0i);
  const float4 c11 = __ldg(io.texels + r1 + x1i);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float top_r = c00.x * gx + c01.x * fx, bot_r = c10.x * gx + c11.x * fx;
  const float top_g = c00.y * gx + c01.y * fx, bot_g = c10.y * gx + c11.y * fx;
  const float top_b = c00.z * gx + c01.z * fx, bot_b = c10.z * gx + c11.z * fx;
  io.o_r[i] = clamp_max(top_r * gy + bot_r * fy, io.max_clamp) * io.intensity;
  io.o_g[i] = clamp_max(top_g * gy + bot_g * fy, io.max_clamp) * io.intensity;
  io.o_b[i] = clamp_max(top_b * gy + bot_b * fy, io.max_clamp) * io.intensity;
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_env.py:192 (sample_equirect_pallas,
// pallas_call :218) and its sorted variant :262.  `texels` is the map in
// its texel layout, (h, w, 4), 16-byte aligned; `need` may be null (every
// lane).
// Returns the CUDA error of the launch (0: accepted); allocates nothing and
// does not synchronise.
int spt_env_sample(const float* dx, const float* dy, const float* dz, const uint8_t* need,
                   const float* texels, int h, int w, float max_clamp, float intensity,
                   float* o_r, float* o_g, float* o_b, int n, void* stream) {
  if (h < 1 || w < 1 || texels == nullptr || reinterpret_cast<uintptr_t>(texels) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  EnvIO io{dx, dy, dz, need, reinterpret_cast<const float4*>(texels), o_r, o_g, o_b,
           n, h, w, max_clamp, intensity};
  const int grid = (n + kEnvBlock - 1) / kEnvBlock;
  env_sample_kernel<<<grid, kEnvBlock, 0, static_cast<cudaStream_t>(stream)>>>(io);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of env_sample.
int spt_env_sample_kernel_info(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, env_sample_kernel);
  if (err == cudaSuccess) {
    *num_regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
