// closest_hit / any_hit: the resident cluster tracer, one thread per ray.
//
// Replaces the Pallas TPU kernels spt_tpu/ops/pallas_trace.py:732
// (`closest_hit`) and :753 (`any_hit`), launched through `_common_call`
// (:685, pallas_call :714) with the bodies `closest_hit_tile` (:497) and
// `any_hit_tile` (:617).  The traversal itself is ClusterTracer
// (spt_tracers.cuh), the same code the resident forms of fused_frame and
// fused_bounce inline.  The hit record is t (inf on a miss), the geometric
// or interpolated shading normal, the material, the kind and, when the
// caller asks for them, the texture coordinates; any_hit reports lanes
// with tmax <= tmin as blocked, as the TPU kernel does.  Its tables (the
// spheres, the cluster boxes) sit in shared memory, or, past 227 KiB (some
// 11 000 spheres beside the mesh), are read from global memory by
// trace_global_kernel, the same code.
//
// What bounds it on an H100: per-ray ALU work and the latency of tri_pack
// reads (see spt_tracers.cuh); the ray planes are 28 B in and 24-32 B out
// per lane (closest) — a few us of memory time at 196k rays.

#include "spt_trace_io.cuh"

namespace {

using namespace spt;

// The kernels' body; kGlobal: the tables in global memory (spt_common.cuh
// load_tables).
template <bool kAny, bool kGlobal>
__device__ __forceinline__ void cluster_trace(const TraceIO& io, const SceneArgs& sc) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<kGlobal>(smem, sc);
  trace_body<kAny>(io, cluster_tracer(tb, sc));
}

template <bool kAny>
__global__ void __launch_bounds__(kTraceBlock) trace_kernel(TraceIO io, SceneArgs sc) {
  cluster_trace<kAny, false>(io, sc);
}

template <bool kAny>
__global__ void __launch_bounds__(kTraceBlock) trace_global_kernel(TraceIO io, SceneArgs sc) {
  cluster_trace<kAny, true>(io, sc);
}

}  // namespace

extern "C" {

// `tables`: sph | cluster boxes | octant keys (spt_common.cuh layout);
// n_inst 0 and n_meshes 1; `global_tables` nonzero selects their global
// placement (spt_common.cuh), else the shared one.  Both return the CUDA error of the launch (0:
// accepted), allocate nothing and do not synchronise.  `o_u` / `o_v` may
// be null.
// Replaces spt_tpu/ops/pallas_trace.py:732 (closest_hit, pallas_call :714).
int spt_closest_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tmax, float* o_t,
                    float* o_nx, float* o_ny, float* o_nz, int* o_mat, int* o_kind, float* o_u,
                    float* o_v, const float* tables, int n_sphs, const float* pack, int pack_w,
                    int n_clusters, int cluster_size, int n_inst, int n_meshes,
                    int global_tables, int n, float tmin, void* stream) {
  TraceIO io{ox, oy, oz, dx, dy, dz, tmax, o_t, o_nx, o_ny, o_nz, o_mat, o_kind, o_u, o_v,
             nullptr, n, tmin};
  return launch_trace(trace_kernel<false>, trace_global_kernel<false>, global_tables, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size,
                                  n_inst, n_meshes),
                      stream);
}

// Replaces spt_tpu/ops/pallas_trace.py:753 (any_hit, pallas_call :714).
int spt_any_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                const float* dy, const float* dz, const float* tmax, uint8_t* o_blocked,
                const float* tables, int n_sphs, const float* pack, int pack_w, int n_clusters,
                int cluster_size, int n_inst, int n_meshes, int global_tables, int n,
                float tmin, void* stream) {
  TraceIO io{ox,      oy,      oz,      dx,      dy,      dz,      tmax,      nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o_blocked, n,       tmin};
  return launch_trace(trace_kernel<true>, trace_global_kernel<true>, global_tables, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_clusters, cluster_size,
                                  n_inst, n_meshes),
                      stream);
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of closest_hit (any = 0) or
// any_hit (1) in the shared placement, or in the global one (2 + any).
int spt_trace_kernel_info(int any, int smem, int* num_regs, int* local_bytes, int* blocks) {
  switch (any) {
    case 1: return kernel_info(trace_kernel<true>, smem, num_regs, local_bytes, blocks);
    case 2: return kernel_info(trace_global_kernel<false>, smem, num_regs, local_bytes, blocks);
    case 3: return kernel_info(trace_global_kernel<true>, smem, num_regs, local_bytes, blocks);
    default: return kernel_info(trace_kernel<false>, smem, num_regs, local_bytes, blocks);
  }
}

}  // extern "C"
