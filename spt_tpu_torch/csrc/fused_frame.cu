// fused_frame: the wavefront depth loop of one sample, one thread per path.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_bounce.py:1090-1322
// (`_frame_kernel`, launched by `fused_frame` :1207) in three forms:
// - small (accel mode None): brute-force loops over at most 192 primitives
//   with every table in shared memory (RolledTracer);
// - resident: the cluster tracer over tri_pack in global memory, with the
//   small tables (materials, lights, emitters, spheres, cluster boxes and
//   visit orders) in shared memory (ClusterTracer, spt_tracers.cuh);
// - instanced: the TLAS/BLAS tracer over the shared BLAS tri_pack in global
//   memory, with the instance rows and the BLAS boxes and visit orders in
//   shared memory (InstTracer);
// - stream: the two-level supercluster tracer (K8) over a tri_pack of any
//   size in global memory, with only the super boxes and visit orders in
//   shared memory and the cluster boxes and orders read from global memory
//   (StreamTracer; the TPU form runs pallas_stream's tiles in the kernel,
//   pallas_bounce.py:634-655).
// It computes bounces [start_bounce, max_depth) of
// spt_tpu_torch.integrators.transport (trace_bounce + shade_core) for every
// lane and hands back what the deferred environment term needs: final
// direction and throughput, radiance, the missed-ever flag and the per-lane
// bounce count.  A textured scene samples its texture table in-kernel (K6,
// spt_common.cuh sample_texture) in every form.  No in-kernel environment
// term.
//
// What bounds it on an H100: the path state is 15 planes in and 11 out,
// 26 x 4 = 104 B per lane per frame — about 216 MB at 1920x1080, some
// 65 us at 3.35 TB/s — so device memory is not the limit.  Per-thread ALU
// work (ray-primitive tests per bounce), its divergence across a warp
// (lanes die at different bounces and take different scatter branches)
// and the latency of dependent float chains are.  The design answers that
// plainly: the small tables are copied into shared memory once per block
// and read by the threads of a warp at mostly the same index, and each
// thread exits its loop as soon as its own path dies.

#include "spt_tracers.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;
static_assert(kBlock == 32 * kWarps, "the staging buffers are laid out per warp");

struct FrameIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tx, *ty, *tz, *rx, *ry, *rz;
  const int *rng, *alive, *emok;
  float *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  int *o_missed, *o_bounces;
  int n, start_bounce, max_depth;
};

// kMode: 0 small (RolledTracer), 1 resident (ClusterTracer), 2 instanced
// (InstTracer), 3 stream (StreamTracer).
template <int kMode>
__global__ void __launch_bounds__(kBlock)
    fused_frame_kernel(FrameIO io, SceneArgs sc, ShadeArgs sa) {
  extern __shared__ float smem[];
  const Tables tb = load_tables(smem, sc);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;

  V3 o = v3(io.ox[i], io.oy[i], io.oz[i]);
  V3 d = v3(io.dx[i], io.dy[i], io.dz[i]);
  V3 thr = v3(io.tx[i], io.ty[i], io.tz[i]);
  V3 rad = v3(io.rx[i], io.ry[i], io.rz[i]);
  uint32_t rng = static_cast<uint32_t>(io.rng[i]);
  bool alive = io.alive[i] != 0;
  bool emok = io.emok[i] != 0;
  int missed_ever = 0;
  int bounces = 0;

  for (int bounce = io.start_bounce; bounce < io.max_depth && alive; ++bounce) {
    ++bounces;
    const bool is_last = bounce == io.max_depth - 1;
    bool missed;
    if constexpr (kMode == 3) {
      alive = shade_bounce(tb, stream_tracer(tb, sc), sa, bounce, is_last, o, d, thr, rad, rng,
                           emok, missed);
    } else if constexpr (kMode == 2) {
      alive = shade_bounce(tb, inst_tracer(tb, sc), sa, bounce, is_last, o, d, thr, rad, rng,
                           emok, missed);
    } else if constexpr (kMode == 1) {
      alive = shade_bounce(tb, cluster_tracer(tb, sc), sa, bounce, is_last, o, d, thr, rad,
                           rng, emok, missed);
    } else {
      alive = shade_bounce(tb, RolledTracer{&tb}, sa, bounce, is_last, o, d, thr, rad, rng,
                           emok, missed);
    }
    if (missed) missed_ever = 1;
  }

  io.o_dx[i] = d.x;
  io.o_dy[i] = d.y;
  io.o_dz[i] = d.z;
  io.o_tx[i] = thr.x;
  io.o_ty[i] = thr.y;
  io.o_tz[i] = thr.z;
  io.o_rx[i] = rad.x;
  io.o_ry[i] = rad.y;
  io.o_rz[i] = rad.z;
  io.o_missed[i] = missed_ever;
  io.o_bounces[i] = bounces;
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:1207 (fused_frame, pallas_call
// :1298).  Launches the kernel on `stream` and returns the CUDA error of
// the launch (0: accepted).  `pack` null selects the small form, n_inst > 0
// the instanced one, `cbox` (with `corder`) the stream one.  Allocates
// nothing and does not synchronise.
int spt_fused_frame(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tx, const float* ty,
                    const float* tz, const float* rx, const float* ry, const float* rz,
                    const int* rng, const int* alive, const int* emok, float* o_dx, float* o_dy,
                    float* o_dz, float* o_tx, float* o_ty, float* o_tz, float* o_rx, float* o_ry,
                    float* o_rz, int* o_missed, int* o_bounces, const float* tables, int n_tris,
                    int n_sphs, int n_mats, int n_lights, int n_emit, int flags,
                    const float* pack, int pack_w, int n_clusters, int cluster_size,
                    int n_inst, int n_meshes, const int* tex, int tex_res,
                    const float* cbox, const uint16_t* corder, int n, int start_bounce,
                    int max_depth, int rr_after, float hit_eps,
                    float ray_offset_dir, float firefly_clamp, void* stream) {
  FrameIO io{ox,   oy,   oz,   dx,   dy,   dz,   tx,   ty,       tz,        rx,
             ry,   rz,   rng,  alive, emok, o_dx, o_dy, o_dz,    o_tx,      o_ty,
             o_tz, o_rx, o_ry, o_rz, o_missed, o_bounces, n, start_bounce, max_depth};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const size_t smem = smem_bytes(sc);
  if (n_mats < 1 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pack == nullptr) {
    err = reserve_smem(fused_frame_kernel<0>, smem);
    if (err == cudaSuccess) fused_frame_kernel<0><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else if (n_inst > 0) {
    err = reserve_smem(fused_frame_kernel<2>, smem);
    if (err == cudaSuccess) fused_frame_kernel<2><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else if (cbox != nullptr) {
    if (corder == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = reserve_smem(fused_frame_kernel<3>, smem);
    if (err == cudaSuccess) fused_frame_kernel<3><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else {
    err = reserve_smem(fused_frame_kernel<1>, smem);
    if (err == cudaSuccess) fused_frame_kernel<1><<<grid, kBlock, smem, st>>>(io, sc, sa);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the small (mode 0), resident (1),
// instanced (2) or stream (3) form.
int spt_fused_frame_kernel_info(int mode, int smem, int* num_regs, int* local_bytes,
                                int* blocks) {
  return mode == 3   ? kernel_info(fused_frame_kernel<3>, smem, num_regs, local_bytes, blocks)
         : mode == 2 ? kernel_info(fused_frame_kernel<2>, smem, num_regs, local_bytes, blocks)
         : mode == 1 ? kernel_info(fused_frame_kernel<1>, smem, num_regs, local_bytes, blocks)
                     : kernel_info(fused_frame_kernel<0>, smem, num_regs, local_bytes, blocks);
}

const char* spt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
