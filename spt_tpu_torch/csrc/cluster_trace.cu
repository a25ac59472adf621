// closest_hit / any_hit: the resident cluster tracer, one thread per ray.
//
// Replaces the Pallas TPU kernels spt_tpu/ops/pallas_trace.py:732
// (`closest_hit`) and :753 (`any_hit`), launched through `_common_call`
// (:685, pallas_call :714) with the bodies `closest_hit_tile` (:497) and
// `any_hit_tile` (:617).  The traversal itself is ClusterTracer
// (spt_tracers.cuh), the same code the resident forms of fused_frame and
// fused_bounce inline.  The hit record is t (inf on a miss), the geometric
// or interpolated shading normal, the material and the kind; any_hit
// reports lanes with tmax <= tmin as blocked, as the TPU kernel does.
//
// What bounds it on an H100: per-ray ALU work and the latency of tri_pack
// reads (see spt_tracers.cuh); the ray planes are 28 B in and 24 B out per
// lane (closest) — a few us of memory time at 196k rays.

#include "spt_tracers.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;

struct TraceIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  float *o_t, *o_nx, *o_ny, *o_nz;
  int *o_mat, *o_kind;
  uint8_t* o_blocked;
  int n;
  float tmin;
};

template <bool kAny>
__global__ void __launch_bounds__(kBlock) trace_kernel(TraceIO io, SceneArgs sc) {
  extern __shared__ float smem[];
  const Tables tb = load_tables(smem, sc);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  const ClusterTracer tr = cluster_tracer(tb, sc);
  const V3 o = v3(io.ox[i], io.oy[i], io.oz[i]);
  const V3 d = v3(io.dx[i], io.dy[i], io.dz[i]);
  if constexpr (kAny) {
    io.o_blocked[i] = tr.occluded(o, d, io.tmin, io.tmax[i]);
  } else {
    float t;
    int mat;
    V3 nrm;
    const int kind = tr.closest(o, d, io.tmin, io.tmax[i], t, mat, nrm);
    io.o_t[i] = t;
    io.o_nx[i] = nrm.x;
    io.o_ny[i] = nrm.y;
    io.o_nz[i] = nrm.z;
    io.o_mat[i] = mat;
    io.o_kind[i] = kind;
  }
}

int launch(bool any, const TraceIO& io, const SceneArgs& sc, void* stream) {
  const size_t smem = smem_bytes(sc);
  if (sc.pack == nullptr || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (io.n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (io.n + kBlock - 1) / kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (any) {
    err = reserve_smem(trace_kernel<true>, smem);
    if (err == cudaSuccess) trace_kernel<true><<<grid, kBlock, smem, st>>>(io, sc);
  } else {
    err = reserve_smem(trace_kernel<false>, smem);
    if (err == cudaSuccess) trace_kernel<false><<<grid, kBlock, smem, st>>>(io, sc);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

SceneArgs trace_scene(const float* tables, int n_sphs, const float* pack, int pack_w,
                      int n_clusters, int cluster_size) {
  return SceneArgs{tables, 0, n_sphs, 0, 0, 0, 0, pack, pack_w, n_clusters, cluster_size};
}

}  // namespace

extern "C" {

// `tables`: sph | cluster boxes | octant keys (spt_common.cuh layout).
// Both return the CUDA error of the launch (0: accepted), allocate nothing
// and do not synchronise.
// Replaces spt_tpu/ops/pallas_trace.py:732 (closest_hit, pallas_call :714).
int spt_closest_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tmax, float* o_t,
                    float* o_nx, float* o_ny, float* o_nz, int* o_mat, int* o_kind,
                    const float* tables, int n_sphs, const float* pack, int pack_w,
                    int n_clusters, int cluster_size, int n, float tmin,
                    void* stream) {
  TraceIO io{ox, oy, oz, dx, dy, dz, tmax, o_t, o_nx, o_ny, o_nz, o_mat, o_kind, nullptr,
             n, tmin};
  return launch(false, io,
                trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size),
                stream);
}

// Replaces spt_tpu/ops/pallas_trace.py:753 (any_hit, pallas_call :714).
int spt_any_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                const float* dy, const float* dz, const float* tmax, uint8_t* o_blocked,
                const float* tables, int n_sphs, const float* pack, int pack_w, int n_clusters,
                int cluster_size, int n, float tmin, void* stream) {
  TraceIO io{ox, oy, oz, dx, dy, dz, tmax, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, o_blocked, n, tmin};
  return launch(true, io,
                trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size),
                stream);
}

// Registers per thread and local (spill) bytes of closest_hit (any = 0) or
// any_hit (1).
int spt_trace_kernel_info(int any, int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = any ? cudaFuncGetAttributes(&attr, trace_kernel<true>)
                              : cudaFuncGetAttributes(&attr, trace_kernel<false>);
  if (err == cudaSuccess) {
    *num_regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
