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
// loads its four texels from the (H, W, 3) map in global memory, blends
// them in the plain version's order and applies min(., max_clamp) *
// intensity; a lane outside `need` writes 0 and loads nothing.  The TPU
// kernel min-extracts the distinct (8, 128) map tiles a lane tile touches
// and DMAs each; here every thread loads its own texels through L2 (the
// 1024 x 2048 bench map is 24 MiB, inside the 50 MB L2).
//
// Numerics: built with --fmad=false, every expression in the order of the
// plain PyTorch version (env.environment_color_v); PyTorch's CUDA division
// by a Python scalar multiplies by the scalar's float reciprocal, so the
// two divisions here do too.
//
// What bounds it on an H100: bytes — 13 B in and 12 B out per lane and up
// to 48 B of texels per needed lane, about 46 operations a lane; the
// gathers are scattered wherever the deferred field's directions are.

#include "spt_common.cuh"

namespace {

using namespace spt;

constexpr int kEnvBlock = 256;

struct EnvIO {
  const float *dx, *dy, *dz;
  const uint8_t* need;  // null: every lane
  const float* __restrict__ map;
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
  int x0i = static_cast<int>(x0) % io.w;  // x0 may be -1: torch.remainder
  if (x0i < 0) x0i += io.w;
  const int x1i = (x0i + 1) % io.w;
  const int y0f = static_cast<int>(y0);
  const int y0i = min(max(y0f, 0), io.h - 1);
  const int y1i = min(max(y0f + 1, 0), io.h - 1);
  const float* c00 = io.map + (static_cast<size_t>(y0i) * io.w + x0i) * 3;
  const float* c01 = io.map + (static_cast<size_t>(y0i) * io.w + x1i) * 3;
  const float* c10 = io.map + (static_cast<size_t>(y1i) * io.w + x0i) * 3;
  const float* c11 = io.map + (static_cast<size_t>(y1i) * io.w + x1i) * 3;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float out[3];
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(c00 + c) * gx + __ldg(c01 + c) * fx;
    const float bot = __ldg(c10 + c) * gx + __ldg(c11 + c) * fx;
    out[c] = clamp_max(top * gy + bot * fy, io.max_clamp) * io.intensity;
  }
  io.o_r[i] = out[0];
  io.o_g[i] = out[1];
  io.o_b[i] = out[2];
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_env.py:192 (sample_equirect_pallas,
// pallas_call :218) and its sorted variant :262.  `need` may be null (every
// lane).  Returns the CUDA error of the launch (0: accepted); allocates
// nothing and does not synchronise.
int spt_env_sample(const float* dx, const float* dy, const float* dz, const uint8_t* need,
                   const float* map, int h, int w, float max_clamp, float intensity,
                   float* o_r, float* o_g, float* o_b, int n, void* stream) {
  if (h < 1 || w < 1 || map == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  EnvIO io{dx, dy, dz, need, map, o_r, o_g, o_b, n, h, w, max_clamp, intensity};
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
