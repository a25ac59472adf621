// closest_hit / any_hit through the instanced TLAS/BLAS (K7), one thread
// per ray.
//
// Replaces the Pallas TPU kernels spt_tpu/ops/pallas_inst.py:893
// (`closest_hit`) and :915 (`any_hit`), launched through `_inst_call`
// (:854, pallas_call :883) with the bodies `_inst_closest_kernel` (:823) and
// `_inst_any_kernel` (:840) over the rounds traversal (:306, :483).  The
// traversal itself is InstTracer (spt_tracers.cuh), the same code the
// instanced forms of fused_frame and fused_bounce inline: each thread walks
// its own crossed instances front to back, transforms its ray into each
// one's object space and walks that mesh's BLAS clusters.  The instance
// rows (I x 22 floats), the BLAS boxes (M*CMAX x 6) and the per-octant
// visit orders sit in shared memory; tri_pack is read through __ldg.  Past
// some 2 500 instances the rows do not fit a block, and
// inst_trace_global_kernel, the same code, reads the rows and boxes from
// global memory (the visit orders stay in shared memory).  Hit record and
// any-hit contract as cluster_trace.cu's.
//
// What bounds it on an H100: per-ray ALU work — I slab tests per round, up
// to one round per crossed instance, and 64 Moller-Trumbore tests per
// opened cluster — and the latency of tri_pack reads; the ray planes are
// 28 B in and 24-32 B out per lane.

#include "spt_trace_io.cuh"

namespace {

using namespace spt;

// The kernels' body; kGlobal: the tables in global memory (spt_common.cuh
// load_tables).
template <bool kAny, bool kGlobal>
__device__ __forceinline__ void inst_trace(const TraceIO& io, const SceneArgs& sc) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<kGlobal>(smem, sc);
  trace_body<kAny>(io, inst_tracer(tb, sc));
}

template <bool kAny>
__global__ void __launch_bounds__(kTraceBlock) inst_trace_kernel(TraceIO io, SceneArgs sc) {
  inst_trace<kAny, false>(io, sc);
}

template <bool kAny>
__global__ void __launch_bounds__(kTraceBlock)
    inst_trace_global_kernel(TraceIO io, SceneArgs sc) {
  inst_trace<kAny, true>(io, sc);
}

}  // namespace

extern "C" {

// `tables`: sph | BLAS boxes | instance rows | BLAS keys (spt_common.cuh
// layout), n_clusters = M * CMAX; `global_tables` nonzero selects their
// global placement (spt_common.cuh: thousands of instances), else the
// shared one.  Both return the CUDA error of the launch
// (0: accepted), allocate nothing and do not synchronise.  `o_u` / `o_v`
// may be null.
// Replaces spt_tpu/ops/pallas_inst.py:893 (closest_hit, pallas_call :883).
int spt_inst_closest_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const float* tmax, float* o_t,
                         float* o_nx, float* o_ny, float* o_nz, int* o_mat, int* o_kind,
                         float* o_u, float* o_v, const float* tables, int n_sphs,
                         const float* pack, int pack_w, int n_clusters, int cluster_size,
                         int n_inst, int n_meshes, int global_tables, int n, float tmin,
                         void* stream) {
  if (n_inst < 1 || n_meshes < 1) return static_cast<int>(cudaErrorInvalidValue);
  TraceIO io{ox, oy, oz, dx, dy, dz, tmax, o_t, o_nx, o_ny, o_nz, o_mat, o_kind, o_u, o_v,
             nullptr, n, tmin};
  return launch_trace(inst_trace_kernel<false>, inst_trace_global_kernel<false>, global_tables, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size,
                                  n_inst, n_meshes),
                      stream);
}

// Replaces spt_tpu/ops/pallas_inst.py:915 (any_hit, pallas_call :883).
int spt_inst_any_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, const float* tmax, uint8_t* o_blocked,
                     const float* tables, int n_sphs, const float* pack, int pack_w,
                     int n_clusters, int cluster_size, int n_inst, int n_meshes,
                     int global_tables, int n, float tmin, void* stream) {
  if (n_inst < 1 || n_meshes < 1) return static_cast<int>(cudaErrorInvalidValue);
  TraceIO io{ox,      oy,      oz,      dx,      dy,      dz,      tmax,      nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o_blocked, n,       tmin};
  return launch_trace(inst_trace_kernel<true>, inst_trace_global_kernel<true>, global_tables, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size,
                                  n_inst, n_meshes),
                      stream);
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the instanced closest
// (any = 0) or any (1) kernel in the shared
// placement, or in the global one (2 + any).
int spt_inst_trace_kernel_info(int any, int smem, int* num_regs, int* local_bytes, int* blocks) {
  switch (any) {
    case 1: return kernel_info(inst_trace_kernel<true>, smem, num_regs, local_bytes, blocks);
    case 2:
      return kernel_info(inst_trace_global_kernel<false>, smem, num_regs, local_bytes, blocks);
    case 3:
      return kernel_info(inst_trace_global_kernel<true>, smem, num_regs, local_bytes, blocks);
    default: return kernel_info(inst_trace_kernel<false>, smem, num_regs, local_bytes, blocks);
  }
}

}  // extern "C"
