// The standalone tracers' launch plumbing (cluster_trace.cu, inst_trace.cu,
// stream_trace.cu):
// the ray and hit planes, one thread per ray, and the launch with its
// shared-memory opt-in.  Each source defines its own __global__ kernels
// over trace_body, so every kernel keeps a name of its own in a profile.

#pragma once

#include "spt_tracers.cuh"

namespace spt {

constexpr int kTraceBlock = 128;
static_assert(kTraceBlock == 32 * kWarps, "the staging buffers are laid out per warp");

struct TraceIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  float *o_t, *o_nx, *o_ny, *o_nz;
  int *o_mat, *o_kind;
  float *o_u, *o_v;  // texture coordinates; null when the caller has no texture
  uint8_t* o_blocked;
  int n;
  float tmin;
};

template <bool kAny, class Tracer>
__device__ inline void trace_body(const TraceIO& io, const Tracer& tr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  const V3 o = v3(io.ox[i], io.oy[i], io.oz[i]);
  const V3 d = v3(io.dx[i], io.dy[i], io.dz[i]);
  if constexpr (kAny) {
    io.o_blocked[i] = tr.occluded(o, d, io.tmin, io.tmax[i]);
  } else {
    float t, u, v;
    int mat;
    V3 nrm;
    const int kind = tr.closest(o, d, io.tmin, io.tmax[i], t, mat, nrm, u, v);
    io.o_t[i] = t;
    io.o_nx[i] = nrm.x;
    io.o_ny[i] = nrm.y;
    io.o_nz[i] = nrm.z;
    io.o_mat[i] = mat;
    io.o_kind[i] = kind;
    if (io.o_u != nullptr) {
      io.o_u[i] = u;
      io.o_v[i] = v;
    }
  }
}

// The scene arguments of a standalone trace: spheres, boxes, [instances,]
// keys in `tables`; no triangles, materials, lights or textures.  The
// stream tracer adds its cluster boxes and visit orders in global memory.
inline SceneArgs trace_scene(const float* tables, int n_sphs, const float* pack, int pack_w,
                             int n_clusters, int cluster_size, int n_inst, int n_meshes,
                             const float* cbox = nullptr, const uint16_t* corder = nullptr) {
  return SceneArgs{tables, 0,      n_sphs,     0,            0,      0,        0,       pack,
                   pack_w, n_clusters, cluster_size, n_inst, n_meshes, nullptr, 0, cbox,
                   corder};
}

template <class K>
inline int launch_trace(K kernel, const TraceIO& io, const SceneArgs& sc, void* stream) {
  const size_t smem = smem_bytes(sc);
  if (sc.pack == nullptr || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (io.n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (io.n + kTraceBlock - 1) / kTraceBlock;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err == cudaSuccess)
    kernel<<<grid, kTraceBlock, smem, static_cast<cudaStream_t>(stream)>>>(io, sc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spt
