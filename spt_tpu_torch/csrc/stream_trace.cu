// closest_hit / any_hit through the stream tier's two-level traversal (K8),
// one thread per ray.
//
// Replaces the Pallas TPU kernels spt_tpu/ops/pallas_stream.py:511
// (`closest_hit`) and :534 (`any_hit`), launched through `_stream_call`
// (:465, pallas_call :499) with the tiles `stream_closest_tile` (:104) and
// `stream_any_tile` (:250).  The traversal itself is StreamTracer
// (spt_tracers.cuh), the same code the stream forms of fused_frame and
// fused_bounce inline: each thread culls the supercluster boxes front to
// back in its octant's order, re-testing each against its tightened bound,
// and walks an opened super's 16 clusters with the resident tracer's loop.
// The super boxes and visit orders (G <= 1024: at most 72 KiB with their
// keys) sit in shared memory; the cluster boxes, the per-super cluster
// orders and tri_pack stay in global memory and are read through L2.  Hit
// record and any-hit contract as cluster_trace.cu's.
//
// What bounds it on an H100: per-ray ALU work — G super slab tests, 16
// cluster slab tests per opened super and 64 Moller-Trumbore tests per
// opened cluster — and the latency of the dependent tri_pack reads, which
// come from device memory once tri_pack outgrows the 50 MB L2; the ray
// planes are 28 B in and 24-32 B out per lane.

#include "spt_trace_io.cuh"

namespace {

using namespace spt;

template <bool kAny>
__global__ void __launch_bounds__(kTraceBlock) stream_trace_kernel(TraceIO io, SceneArgs sc) {
  extern __shared__ float smem[];
  const Tables tb = load_tables(smem, sc);
  trace_body<kAny>(io, stream_tracer(tb, sc));
}

}  // namespace

extern "C" {

// `tables`: sph | super boxes | sup_okey (spt_common.cuh layout), n_supers
// = G; `cbox`: (G * 16, 6) cluster boxes, `corder`: bvh.MeshAccel.cl_order
// (8 x G * 16), both in global memory.  Both return the CUDA error of the
// launch (0: accepted), allocate nothing and do not synchronise.  `o_u` /
// `o_v` may be null.
// Replaces spt_tpu/ops/pallas_stream.py:511 (closest_hit, pallas_call :499).
int spt_stream_closest_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                           const float* dy, const float* dz, const float* tmax, float* o_t,
                           float* o_nx, float* o_ny, float* o_nz, int* o_mat, int* o_kind,
                           float* o_u, float* o_v, const float* tables, int n_sphs,
                           const float* pack, int pack_w, int n_supers, int cluster_size,
                           const float* cbox, const uint16_t* corder, int n, float tmin,
                           void* stream) {
  if (n_supers < 1 || cbox == nullptr || corder == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TraceIO io{ox, oy, oz, dx, dy, dz, tmax, o_t, o_nx, o_ny, o_nz, o_mat, o_kind, o_u, o_v,
             nullptr, n, tmin};
  return launch_trace(stream_trace_kernel<false>, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_supers, cluster_size, 0, 1,
                                  cbox, corder),
                      stream);
}

// Replaces spt_tpu/ops/pallas_stream.py:534 (any_hit, pallas_call :499).
int spt_stream_any_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                       const float* dy, const float* dz, const float* tmax, uint8_t* o_blocked,
                       const float* tables, int n_sphs, const float* pack, int pack_w,
                       int n_supers, int cluster_size, const float* cbox,
                       const uint16_t* corder, int n, float tmin, void* stream) {
  if (n_supers < 1 || cbox == nullptr || corder == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TraceIO io{ox,      oy,      oz,      dx,      dy,      dz,      tmax,      nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o_blocked, n,       tmin};
  return launch_trace(stream_trace_kernel<true>, io,
                      trace_scene(tables, n_sphs, pack, pack_w, n_supers, cluster_size, 0, 1,
                                  cbox, corder),
                      stream);
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the stream closest
// (any = 0) or any (1) kernel.
int spt_stream_trace_kernel_info(int any, int smem, int* num_regs, int* local_bytes, int* blocks) {
  return any ? kernel_info(stream_trace_kernel<true>, smem, num_regs, local_bytes, blocks)
             : kernel_info(stream_trace_kernel<false>, smem, num_regs, local_bytes, blocks);
}

}  // extern "C"
