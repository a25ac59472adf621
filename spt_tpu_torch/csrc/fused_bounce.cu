// fused_bounce: one wavefront bounce (trace + shade) of every live lane.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_bounce.py:752-855
// (`_kernel`, launched by `fused_bounce` :965): transport.trace_bounce +
// transport.shade_core for every lane, on the 15 path-state planes, with
// the bounce index and is_last as arguments.  It writes the 15 state planes
// back and the `missed` mask (the caller owes throughput * env(direction)
// to those lanes).  Dead lanes are copied through.  It is one bounce of
// fused_frame's body, in the same four forms (small: RolledTracer,
// resident: ClusterTracer, instanced: InstTracer, stream: StreamTracer),
// textured or not, and reads the path state in the dtypes the port keeps it
// in (the RNG word as int64, the flags as bytes), so the wrapper converts
// nothing.  Each form is two kernels of the same code, the tables copied
// into each block's shared memory or, for a scene whose tables do not fit
// there, read from global memory (*_global_kernel; spt_common.cuh).  The
// sorted mesh frame (integrators/wavefront.py) runs it for
// the bounces between its sorts: bounce 0 on every lane in pixel order,
// then bounces 1 and 2 after a coherence sort, whose live lanes sit at the
// head of each sort chunk (condensed to 65 536 lanes on the mesh scene);
// the compact path runs it at bounce 0.
//
// What bounds it on an H100: not bytes (a lane reads 58 B of state and
// writes 59 B: 12 float planes, the int64 RNG word, its flags as bytes)
// but, in the mesh forms, the tracer's walks (the closest hit and every
// shadow ray): the Moller-Trumbore tests of each opened 64-triangle
// cluster and the wait for its rows.  The walks are warp-cooperative
// (spt_tracers.cuh): the lanes step through their clusters together, the
// tests of a cluster few of them open are spread over the whole warp, and
// a cluster many open is staged once in the warp's shared-memory buffer.
//
// The resident form (fused_bounce_queue_kernel<1>) is a queue kernel
// (spt_queue.cuh, shared with fused_frame's mesh forms): a persistent
// cooperative grid sweeps every lane, copying the dead ones through and
// queueing the live ones, passes a grid barrier, and runs the queued
// paths: one a warp at a time, its 32 threads twins that walk its ray as a
// group, or, when the live lanes fill every thread (bounce 0), one a
// thread with the lockstep walk.  A sorted call's thousands of live lanes,
// which a grid of one thread per lane left on the few blocks of a few SMs
// while every other block loaded the tables only to copy dead lanes,
// spread over every warp of every SM.  Each path runs the call's one bounce with the call's
// is_last and writes the whole new state at its own lane; K3 counts no
// rays.  The instanced and stream forms (fused_bounce_kernel<2, 3>) run
// one thread a lane.
//
// The small form (small_bounce_kernel) is the compact path's bounce 0: two
// million lanes, every one alive, each a brute-force trace over at most
// 192 primitives in shared memory, then the shading with a shadow ray a
// light and one a NEE sample.  At 117 B a lane it needs 0.072 ms of the
// H100's 3.35 TB/s, and a quarter of that in float32 operations.  What
// bounds it, timed at 1920x1080 on an NVIDIA H100 80GB HBM3 at its 700 W
// limit (frame_sweep.py --edits floor,trace; PERF.md): moving the state
// alone takes 0.082 ms, the closest
// hit adds 0.003-0.034 ms, and the shading the rest (0.09 ms on cornell):
// chains of dependent float operations, whose registers (80 and spill at 24
// warps an SM) leave too few warps to hide them.  The one-thread-a-lane
// grid's 16 200 blocks, each copying the tables and waiting on a barrier,
// cost little: a persistent grid alone gained 0-4 %.  So the design:
// - a persistent grid, as many blocks of 256 threads as the SMs hold at
//   once (3 at 80 registers), each loading the tables once, its threads
//   walking the lanes in a grid-stride loop, a warp's 32 neighbouring lanes
//   a step, coalesced, with no counter to zero (no fill launch; K1 small's
//   counter-fed loop took 12 % more on hdr);
// - the trace's tests return at their first failed condition
//   (SmallTracer<true>, the same result): a warp's primary rays are
//   neighbours in the image and fail together (-8 % on default);
// - the BRDF a call (shade_bounce with kBrdfCall), so its registers are not
//   live beside the shading's own: less spill, -1 % on cornell and hdr.

#include "spt_queue.cuh"

namespace {

using namespace spt;

struct BounceIO {
  PathIn in;
  float *o_ox, *o_oy, *o_oz, *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  long long* o_rng;
  uint8_t *o_alive, *o_emok, *o_missed;
  // the resident form: (3) zeroed by the caller, the counters of lanes
  // handed out, of lanes queued and of the blocks at the grid barrier; and
  // (n) the live lanes' ids.  Null in the other forms.
  unsigned long long* counters;
  int* queue;
  int n, bounce, is_last;

  // run_paths: the one bounce `bounce`, is_last from the caller; no rays
  // counted
  static constexpr bool kCountsRays = false;
  __device__ unsigned long long* handed() const { return counters; }
  __device__ int first() const { return bounce; }
  __device__ int stop() const { return bounce + 1; }
  __device__ bool last(int) const { return is_last != 0; }
  __device__ void store(int i, const Path& p) const {
    o_ox[i] = p.o.x;
    o_oy[i] = p.o.y;
    o_oz[i] = p.o.z;
    o_dx[i] = p.d.x;
    o_dy[i] = p.d.y;
    o_dz[i] = p.d.z;
    o_tx[i] = p.thr.x;
    o_ty[i] = p.thr.y;
    o_tz[i] = p.thr.z;
    o_rx[i] = p.rad.x;
    o_ry[i] = p.rad.y;
    o_rz[i] = p.rad.z;
    o_rng[i] = static_cast<long long>(p.rng);
    o_alive[i] = p.alive;
    o_emok[i] = p.emok;
    o_missed[i] = p.missed;
  }
};

// The resident form's launch bound, as fused_frame's mesh forms'.
constexpr int kBounceMinBlocks = 4;  // __launch_bounds__ blocks per SM

// The small form's launch shape, chosen on the card with frame_sweep.py
// (PERF.md).
constexpr int kSmallBounceBlock = 256;     // threads a block
constexpr int kSmallBounceMinBlocks = 3;   // __launch_bounds__ blocks per SM
constexpr int kSmallBounceEarly = 1;       // 1: tests that return at their first failed condition
constexpr int kSmallBounceBrdfCall = 1;    // 1: the BRDF a call, not inlined
static_assert(kSmallBounceBlock % 32 == 0, "a step of the loop is whole warps");

// Lanes [0, io.n) of a grid-stride loop: thread t of the grid runs lanes t,
// t + step, ...  Each lane runs exactly the arithmetic of the
// one-thread-a-lane kernel and writes its own outputs.
template <class Tracer>
__device__ inline void stride_paths(const BounceIO& io, const Tables& tb, const Tracer& tracer,
                                    const ShadeArgs& sa) {
  const bool is_last = io.is_last != 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < io.n; i += gridDim.x * blockDim.x) {
    Path p = load_path(io.in, i, io.bounce);
    if (p.alive)
      p.alive = shade_bounce<Tracer, kSmallBounceBrdfCall != 0>(
          tb, tracer, sa, p.bounce, is_last, p.o, p.d, p.thr, p.rad, p.rng, p.emok, p.missed);
    io.store(i, p);
  }
}

// Each form is defined once as a macro and instantiated twice: NAME with
// GLOBAL false copies the tables into shared memory, the *_global_kernel
// with GLOBAL true reads them from global memory (spt_common.cuh
// load_tables), each kernel's body its own text as in fused_frame.cu.
#define SPT_SMALL_BOUNCE_KERNEL(NAME, GLOBAL)                                       \
  __global__ void __launch_bounds__(kSmallBounceBlock, kSmallBounceMinBlocks)       \
      NAME(BounceIO io, SceneArgs sc, ShadeArgs sa) {                               \
    extern __shared__ __align__(16) float smem[];                                   \
    const Tables tb = load_small_tables<GLOBAL>(smem, sc);                          \
    const SmallTracer<kSmallBounceEarly != 0> tracer{&tb};                          \
    stride_paths(io, tb, tracer, sa);                                               \
  }

SPT_SMALL_BOUNCE_KERNEL(small_bounce_kernel, false)
SPT_SMALL_BOUNCE_KERNEL(small_bounce_global_kernel, true)

// kMode: 2 instanced (InstTracer), 3 stream (StreamTracer); one thread a
// lane.
#define SPT_FUSED_BOUNCE_KERNEL(NAME, GLOBAL)                                       \
  template <int kMode>                                                              \
  __global__ void __launch_bounds__(kBlock) NAME(BounceIO io, SceneArgs sc, ShadeArgs sa) { \
    extern __shared__ __align__(16) float smem[];                                   \
    const Tables tb = load_tables<GLOBAL>(smem, sc);                                \
    const int i = blockIdx.x * blockDim.x + threadIdx.x;                            \
    if (i >= io.n) return;                                                          \
                                                                                    \
    Path p = load_path(io.in, i, io.bounce);                                        \
    if (p.alive) {                                                                  \
      const bool is_last = io.is_last != 0;                                         \
      if constexpr (kMode == 3) {                                                   \
        p.alive = shade_bounce(tb, stream_tracer(tb, sc), sa, p.bounce, is_last, p.o, p.d, \
                               p.thr, p.rad, p.rng, p.emok, p.missed);              \
      } else {                                                                      \
        p.alive = shade_bounce(tb, inst_tracer(tb, sc), sa, p.bounce, is_last, p.o, p.d, \
                               p.thr, p.rad, p.rng, p.emok, p.missed);              \
      }                                                                             \
    }                                                                               \
    io.store(i, p);                                                                 \
  }

SPT_FUSED_BOUNCE_KERNEL(fused_bounce_kernel, false)
SPT_FUSED_BOUNCE_KERNEL(fused_bounce_global_kernel, true)

// The queue kernel (spt_queue.cuh); kMode 1 resident (ClusterTracer).
#define SPT_FUSED_BOUNCE_QUEUE_KERNEL(NAME, GLOBAL)                                 \
  template <int kMode>                                                              \
  __global__ void __launch_bounds__(kBlock, kBounceMinBlocks)                       \
      NAME(BounceIO io, SceneArgs sc, ShadeArgs sa) {                               \
    extern __shared__ __align__(16) float smem[];                                   \
    unsigned long long* queued = io.counters + 1;                                   \
    /* dead lanes' outputs are their inputs, missed 0 */                            \
    sweep_queue(io.in.alive, io.n, true, queued, io.queue, [&](int i) {             \
      io.o_ox[i] = io.in.ox[i];                                                     \
      io.o_oy[i] = io.in.oy[i];                                                     \
      io.o_oz[i] = io.in.oz[i];                                                     \
      io.o_dx[i] = io.in.dx[i];                                                     \
      io.o_dy[i] = io.in.dy[i];                                                     \
      io.o_dz[i] = io.in.dz[i];                                                     \
      io.o_tx[i] = io.in.tx[i];                                                     \
      io.o_ty[i] = io.in.ty[i];                                                     \
      io.o_tz[i] = io.in.tz[i];                                                     \
      io.o_rx[i] = io.in.rx[i];                                                     \
      io.o_ry[i] = io.in.ry[i];                                                     \
      io.o_rz[i] = io.in.rz[i];                                                     \
      io.o_rng[i] = io.in.rng[i];                                                   \
      io.o_alive[i] = 0;                                                            \
      io.o_emok[i] = io.in.emok[i] != 0;                                            \
      io.o_missed[i] = 0;                                                           \
    });                                                                             \
    grid_barrier(queued + 1);                                                       \
    int live;                                                                       \
    const int take = queue_take(queued, live);                                      \
    if (take == 0) return;                                                          \
    const Tables tb = load_tables<GLOBAL>(smem, sc);                                \
    run_queue<kMode>(io, tb, sc, sa, nullptr, live, take);                          \
  }

SPT_FUSED_BOUNCE_QUEUE_KERNEL(fused_bounce_queue_kernel, false)
SPT_FUSED_BOUNCE_QUEUE_KERNEL(fused_bounce_queue_global_kernel, true)

// One launch of a one-thread-a-lane form, in the global placement when
// `global`.
template <int kMode>
inline cudaError_t launch_lanes(BounceIO& io, SceneArgs& sc, ShadeArgs& sa, size_t smem,
                                bool global, cudaStream_t st) {
  void (*kernel)(BounceIO, SceneArgs, ShadeArgs) = fused_bounce_kernel<kMode>;
  if (global) kernel = fused_bounce_global_kernel<kMode>;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = (io.n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, st>>>(io, sc, sa);
  return cudaSuccess;
}

// One launch of the small form on as many blocks as the SMs hold at once
// and no more than one a kSmallBounceBlock lanes, in the global placement
// when `global`.
inline cudaError_t launch_small(BounceIO& io, SceneArgs& sc, ShadeArgs& sa, size_t smem,
                                bool global, cudaStream_t st) {
  void (*kernel)(BounceIO, SceneArgs, ShadeArgs) = small_bounce_kernel;
  if (global) kernel = small_bounce_global_kernel;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, kSmallBounceBlock, smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(blocks, (io.n + kSmallBounceBlock - 1) / kSmallBounceBlock);
  kernel<<<grid, kSmallBounceBlock, smem, st>>>(io, sc, sa);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:965 (fused_bounce, pallas_call
// :1063): one bounce of lanes whose RNG words are int64 and flags bytes,
// writing the new state (the RNG words as int64, the flags as bytes) and
// `missed`.  `pack` null selects the small form, n_inst > 0 the instanced
// one, `cbox` (with `corder`) the stream one, else the resident one, which
// needs `counters`, (3) int64 zeroed, and `queue`, (n) int32 scratch, and
// makes one cooperative launch.  `global_tables` nonzero selects the global
// placement of the tables (spt_common.cuh; the small form's `tables` then
// 16-byte aligned), else the shared one, refused when a block's shared
// memory cannot hold it.  Launches on `stream` and returns the CUDA error
// of the launch (0: accepted).  Allocates nothing and does not
// synchronise.
int spt_fused_bounce(const float* ox, const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, const float* tx, const float* ty,
                     const float* tz, const float* rx, const float* ry, const float* rz,
                     const long long* rng, const uint8_t* alive, const uint8_t* emok,
                     float* o_ox, float* o_oy, float* o_oz, float* o_dx, float* o_dy,
                     float* o_dz, float* o_tx, float* o_ty, float* o_tz, float* o_rx,
                     float* o_ry, float* o_rz, long long* o_rng, uint8_t* o_alive,
                     uint8_t* o_emok, uint8_t* o_missed, unsigned long long* counters,
                     int* queue, const float* tables, int n_tris, int n_sphs, int n_mats,
                     int n_lights, int n_emit, int flags, const float* pack, int pack_w,
                     int n_clusters, int cluster_size, int n_inst, int n_meshes,
                     const int* tex, int tex_res, const float* cbox, const uint16_t* corder,
                     int global_tables, int n, int bounce, int is_last, int rr_after,
                     float hit_eps,
                     float ray_offset_dir, float firefly_clamp, void* stream) {
  BounceIO io{{ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz, rng, alive, emok},
              o_ox, o_oy, o_oz, o_dx, o_dy, o_dz, o_tx, o_ty, o_tz, o_rx, o_ry, o_rz,
              o_rng, o_alive, o_emok, o_missed, counters, queue, n, bounce, is_last};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const bool resident = pack != nullptr && n_inst <= 0 && cbox == nullptr;
  const bool global = global_tables != 0;
  const size_t smem =
      pack == nullptr
          ? (global ? 0 : sizeof(float) * static_cast<size_t>(small_table_words(sc)))
          : smem_bytes(sc, global);
  if (n_mats < 1 || smem > kMaxSharedBytes || (cbox != nullptr && corder == nullptr) ||
      (resident && (counters == nullptr || queue == nullptr)) ||
      (pack == nullptr && global && reinterpret_cast<uintptr_t>(tables) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pack == nullptr) {
    err = launch_small(io, sc, sa, smem, global, st);
  } else if (n_inst > 0) {
    err = launch_lanes<2>(io, sc, sa, smem, global, st);
  } else if (cbox != nullptr) {
    err = launch_lanes<3>(io, sc, sa, smem, global, st);
  } else if (global) {
    err = launch_queue(fused_bounce_queue_global_kernel<1>, io, sc, sa, smem, st);
  } else {
    err = launch_queue(fused_bounce_queue_kernel<1>, io, sc, sa, smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the small (mode 0), resident (1),
// instanced (2) or stream (3) form in the shared placement, or of the same
// form in the global one (mode 4 + form).
int spt_fused_bounce_kernel_info(int mode, int smem, int* num_regs, int* local_bytes,
                                 int* blocks) {
  switch (mode) {
    case 1:
      return kernel_info(fused_bounce_queue_kernel<1>, smem, num_regs, local_bytes, blocks);
    case 2: return kernel_info(fused_bounce_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 3: return kernel_info(fused_bounce_kernel<3>, smem, num_regs, local_bytes, blocks);
    case 4:
      return kernel_info(small_bounce_global_kernel, smem, num_regs, local_bytes, blocks,
                         kSmallBounceBlock);
    case 5:
      return kernel_info(fused_bounce_queue_global_kernel<1>, smem, num_regs, local_bytes,
                         blocks);
    case 6: return kernel_info(fused_bounce_global_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 7: return kernel_info(fused_bounce_global_kernel<3>, smem, num_regs, local_bytes, blocks);
    default:
      return kernel_info(small_bounce_kernel, smem, num_regs, local_bytes, blocks,
                         kSmallBounceBlock);
  }
}

}  // extern "C"
