// fused_bounce: one wavefront bounce (trace + shade), one thread per path.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_bounce.py:752-855
// (`_kernel`, launched by `fused_bounce` :965): transport.trace_bounce +
// transport.shade_core for every lane, on the 15 path-state planes, with
// the bounce index and is_last as arguments.  It writes the 15 state planes
// back and the `missed` mask (the caller owes throughput * env(direction)
// to those lanes).  Dead lanes are copied through.  It is the per-thread
// body of fused_frame for one bounce, in the same four forms (small:
// RolledTracer, resident: ClusterTracer, instanced: InstTracer, stream:
// StreamTracer), textured or not; the sorted mesh frame (integrators/wavefront.py) runs it for the
// bounces between its sorts.
//
// What bounds it on an H100: not bytes (the state is read and written once
// per bounce, 15 planes in and 16 out — the RNG word goes out as int64, the
// flags as bytes: 60 + 63 B per lane) but, in the mesh forms, the tracer's
// walks (the closest hit and every shadow ray): the Moller-Trumbore tests of
// each opened 64-triangle cluster, which a lane walking alone runs while
// the lanes of its warp that did not open the cluster idle.  The walks are
// warp-cooperative (spt_tracers.cuh): the lanes step through their clusters
// together, the tests of a cluster few of them open are spread over the
// whole warp, and a cluster many open is staged once in the warp's
// shared-memory buffer and scanned there by each; the sorted frame's
// octant-major ray order puts many lanes on one cluster.

#include "spt_tracers.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;
static_assert(kBlock == 32 * kWarps, "the staging buffers are laid out per warp");

struct BounceIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tx, *ty, *tz, *rx, *ry, *rz;
  const int *rng, *alive, *emok;
  float *o_ox, *o_oy, *o_oz, *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  long long* o_rng;
  uint8_t *o_alive, *o_emok, *o_missed;
  int n, bounce, is_last;
};

// kMode: 0 small (RolledTracer), 1 resident (ClusterTracer), 2 instanced
// (InstTracer), 3 stream (StreamTracer).
template <int kMode>
__global__ void __launch_bounds__(kBlock)
    fused_bounce_kernel(BounceIO io, SceneArgs sc, ShadeArgs sa) {
  extern __shared__ __align__(16) float smem[];
  Tables tb;
  if constexpr (kMode == 0) {
    tb = load_small_tables(smem, sc);
  } else {
    tb = load_tables(smem, sc);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;

  V3 o = v3(io.ox[i], io.oy[i], io.oz[i]);
  V3 d = v3(io.dx[i], io.dy[i], io.dz[i]);
  V3 thr = v3(io.tx[i], io.ty[i], io.tz[i]);
  V3 rad = v3(io.rx[i], io.ry[i], io.rz[i]);
  uint32_t rng = static_cast<uint32_t>(io.rng[i]);
  bool alive = io.alive[i] != 0;
  bool emok = io.emok[i] != 0;
  bool missed = false;
  if (alive) {
    if constexpr (kMode == 3) {
      alive = shade_bounce(tb, stream_tracer(tb, sc), sa, io.bounce, io.is_last != 0, o, d, thr,
                           rad, rng, emok, missed);
    } else if constexpr (kMode == 2) {
      alive = shade_bounce(tb, inst_tracer(tb, sc), sa, io.bounce, io.is_last != 0, o, d, thr,
                           rad, rng, emok, missed);
    } else if constexpr (kMode == 1) {
      alive = shade_bounce(tb, cluster_tracer(tb, sc), sa, io.bounce, io.is_last != 0, o, d,
                           thr, rad, rng, emok, missed);
    } else {
      alive = shade_bounce(tb, RolledTracer{&tb}, sa, io.bounce, io.is_last != 0, o, d, thr,
                           rad, rng, emok, missed);
    }
  }

  io.o_ox[i] = o.x;
  io.o_oy[i] = o.y;
  io.o_oz[i] = o.z;
  io.o_dx[i] = d.x;
  io.o_dy[i] = d.y;
  io.o_dz[i] = d.z;
  io.o_tx[i] = thr.x;
  io.o_ty[i] = thr.y;
  io.o_tz[i] = thr.z;
  io.o_rx[i] = rad.x;
  io.o_ry[i] = rad.y;
  io.o_rz[i] = rad.z;
  io.o_rng[i] = static_cast<long long>(rng);
  io.o_alive[i] = alive;
  io.o_emok[i] = emok;
  io.o_missed[i] = missed;
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:965 (fused_bounce, pallas_call
// :1063).  Launches the kernel on `stream` and returns the CUDA error of
// the launch (0: accepted).  `pack` null selects the small form, n_inst > 0
// the instanced one, `cbox` (with `corder`) the stream one.  Allocates
// nothing and does not synchronise.
int spt_fused_bounce(const float* ox, const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, const float* tx, const float* ty,
                     const float* tz, const float* rx, const float* ry, const float* rz,
                     const int* rng, const int* alive, const int* emok, float* o_ox,
                     float* o_oy, float* o_oz, float* o_dx, float* o_dy, float* o_dz,
                     float* o_tx, float* o_ty, float* o_tz, float* o_rx, float* o_ry,
                     float* o_rz, long long* o_rng, uint8_t* o_alive, uint8_t* o_emok,
                     uint8_t* o_missed, const float* tables, int n_tris, int n_sphs, int n_mats,
                     int n_lights, int n_emit, int flags, const float* pack, int pack_w,
                     int n_clusters, int cluster_size, int n_inst, int n_meshes,
                     const int* tex, int tex_res, const float* cbox, const uint16_t* corder,
                     int n, int bounce,
                     int is_last, int rr_after, float hit_eps, float ray_offset_dir,
                     float firefly_clamp, void* stream) {
  BounceIO io{ox,   oy,   oz,   dx,   dy,   dz,    tx,      ty,      tz,       rx,
              ry,   rz,   rng,  alive, emok, o_ox, o_oy,    o_oz,    o_dx,     o_dy,
              o_dz, o_tx, o_ty, o_tz, o_rx, o_ry,  o_rz,    o_rng,   o_alive,  o_emok,
              o_missed, n, bounce, is_last};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const size_t smem =
      pack == nullptr ? sizeof(float) * static_cast<size_t>(small_table_words(sc)) : smem_bytes(sc);
  if (n_mats < 1 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pack == nullptr) {
    err = reserve_smem(fused_bounce_kernel<0>, smem);
    if (err == cudaSuccess) fused_bounce_kernel<0><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else if (n_inst > 0) {
    err = reserve_smem(fused_bounce_kernel<2>, smem);
    if (err == cudaSuccess) fused_bounce_kernel<2><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else if (cbox != nullptr) {
    if (corder == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = reserve_smem(fused_bounce_kernel<3>, smem);
    if (err == cudaSuccess) fused_bounce_kernel<3><<<grid, kBlock, smem, st>>>(io, sc, sa);
  } else {
    err = reserve_smem(fused_bounce_kernel<1>, smem);
    if (err == cudaSuccess) fused_bounce_kernel<1><<<grid, kBlock, smem, st>>>(io, sc, sa);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the small (mode 0), resident (1),
// instanced (2) or stream (3) form.
int spt_fused_bounce_kernel_info(int mode, int smem, int* num_regs, int* local_bytes,
                                 int* blocks) {
  return mode == 3   ? kernel_info(fused_bounce_kernel<3>, smem, num_regs, local_bytes, blocks)
         : mode == 2 ? kernel_info(fused_bounce_kernel<2>, smem, num_regs, local_bytes, blocks)
         : mode == 1 ? kernel_info(fused_bounce_kernel<1>, smem, num_regs, local_bytes, blocks)
                     : kernel_info(fused_bounce_kernel<0>, smem, num_regs, local_bytes, blocks);
}

}  // extern "C"
