// fused_frame: the wavefront depth loop of one sample.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_bounce.py:1090-1322
// (`_frame_kernel`, launched by `fused_frame` :1207) in four forms:
// - small (accel mode None): brute-force loops over at most 192 primitives
//   with every table in shared memory (RolledTracer), a kernel of its own
//   (small_frame_kernel, below);
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
// Each form is two kernels of the same code (spt_common.cuh, "The placement
// of the tables"): one copies the tables into every block's shared memory,
// the other (small_frame_global_kernel, fused_frame_global_kernel<1..3>)
// reads them from global memory, for the scenes whose tables do not fit a
// block (a thousand lights, thousands of instances), which the TPU kernel
// holds in VMEM.
// It computes bounces [start_bounce, max_depth) of
// spt_tpu_torch.integrators.transport (trace_bounce + shade_core) for every
// lane and hands back what the deferred environment term needs: final
// direction and throughput, radiance, the missed-ever flag and the rays
// per bounce.  A textured scene samples its texture table in-kernel (K6,
// spt_common.cuh sample_texture) in every form.  No in-kernel environment
// term.
//
// What bounds it on an H100: the path state is 58 B a lane in (12 float
// planes, the int64 RNG word, two byte flags) and 37 B out (9 float
// planes, the missed byte), 95 B (the mesh forms add 4 B a live lane for
// their queue, and copy a dead lane through in 74 B) — about 197 MB at
// 1920x1080, some 59 us at 3.35 TB/s — so device memory is not the
// limit.  Per-thread ALU work (ray-primitive tests per bounce), its
// divergence across a warp (lanes die at different bounces and take
// different scatter branches) and the latency of dependent float chains
// are; in the mesh forms, the walks' tests of each opened cluster and the
// wait for its rows (spt_tracers.cuh).
//
// Both kinds of kernel are persistent: a grid of as many blocks as the SMs
// hold at once loads the tables into shared memory once per block, and
// each warp takes lanes from a counter in global memory and refills the
// threads whose paths ended (spt_queue.cuh run_paths):
// - lane refill: at the top of its bounce loop a warp hands the next lanes
//   of its chunk to its threads whose paths ended once enough of them are
//   free, so a warp whose paths die early keeps working on new ones instead
//   of idling beside its longest path.  Each path runs exactly the
//   arithmetic it runs alone (its own bounce index and is_last) and writes
//   its outputs at its own lane, so only which thread computes a path
//   changes, never a bit of its result;
// - the rays per bounce counted in the kernel: a block histograms how many
//   bounces its paths ran (warp-aggregated shared atomics) and adds the
//   suffix sums to the int64 output, one atomic a block and bounce; the
//   path state is read in the dtypes the port keeps it in (the RNG word as
//   int64, the flags as bytes), so the wrapper converts nothing.
//
// The small form (small_frame_kernel) takes every lane in turn, in chunks
// of kChunk on all 32 threads of a warp.  Small chunks keep the warps' ends
// together (chunks of 512 lanes took 2.7x the time of 32 on default).
// Refilling at 8 free threads is the compromise measured over the three
// small configs: at 4, cornell gains 3 % and hdr loses 3 %; at 16, hdr
// gains 3 % and cornell loses 11 %; refilling only whole warps takes 1.29x
// on cornell.  6 blocks of 128 threads per SM: the launch bound caps it at
// 80 registers, and it spills (56 B stored, 76 B loaded a thread, 72 B of
// stack); 5 blocks (93 registers, no spill) took 3 %, 5 % and 5 % more time
// on default, cornell and hdr, 8 (64 registers) more on two of them.  Its
// triangle and sphere rows are float4s (spt_tracers.cuh tri_test /
// sph_test).
//
// The mesh forms (fused_frame_kernel<1..3>) are built for what the sorted
// frame hands them: the last bounce of a few thousand live lanes among
// 65 536-196 608, packed at the head of each sort chunk, where a grid of
// one thread per lane left most SMs idle and had every block load the
// tables only to copy dead lanes through.  They are queue kernels
// (spt_queue.cuh, shared with fused_bounce's resident form): a coalesced
// sweep copies the dead lanes through and queues the live ones, a grid
// barrier, then warps take queued lanes `take` at a time and run each path
// on 32 / take threads in step (twins walking each ray as a group:
// spt_tracers.cuh group_walk, a window of box tests at once, the 64 tests
// of each opened cluster spread over the group, the instanced tracer's
// instance scan split over it), or at take 32 (a dense call: every lane of
// bounce 0, the unsorted route) one path a thread with the warp's lockstep
// walk.  The queue's counters follow the rays per bounce in the caller's
// buffer.
// The constants were chosen on the card with frame_sweep.py (PERF.md): a
// warp refills only once all its paths have ended, since refilling at 8
// free threads mixes a primary ray into a warp of later bounces and took
// 11-25 % more time on the grids' dense calls; a launch bound of 3 blocks
// per SM (155-165 registers, 32 B of spill) took 25-42 % more on the
// grids' sorted calls; a floor of 2 lanes a warp took 1.3x on the mesh
// scene's 1207 live lanes.

#include "spt_queue.cuh"

namespace {

using namespace spt;

struct FrameIO {
  PathIn in;
  float *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  uint8_t* o_missed;
  // (max_depth + 3), zeroed by the caller: the rays per bounce, then the
  // counters of lanes handed out, of lanes queued (mesh forms) and of the
  // blocks at the grid barrier (mesh forms: gridDim.x once it is passed)
  unsigned long long* counts;
  int* queue;  // mesh forms: (n) the live lanes' ids; small form: null
  int n, start_bounce, max_depth;

  // run_paths: bounces [start_bounce, max_depth), the rays counted
  static constexpr bool kCountsRays = true;
  __device__ unsigned long long* handed() const { return counts + max_depth; }
  __device__ int first() const { return start_bounce; }
  __device__ int stop() const { return max_depth; }
  __device__ bool last(int bounce) const { return bounce == max_depth - 1; }
  __device__ void store(int i, const Path& p) const {
    o_dx[i] = p.d.x;
    o_dy[i] = p.d.y;
    o_dz[i] = p.d.z;
    o_tx[i] = p.thr.x;
    o_ty[i] = p.thr.y;
    o_tz[i] = p.thr.z;
    o_rx[i] = p.rad.x;
    o_ry[i] = p.rad.y;
    o_rz[i] = p.rad.z;
    o_missed[i] = p.missed;
  }
};

// The small form's launch shape and refill, chosen on the card with
// frame_sweep.py (PERF.md).
constexpr int kSmallBlock = 128;     // threads a block
constexpr int kSmallMinBlocks = 6;   // __launch_bounds__ blocks per SM
constexpr int kRefillMin = 8;        // free threads at which a warp refills
constexpr int kChunk = 32;           // lanes a warp takes from the counter at once
static_assert(kSmallBlock % 32 == 0, "the refill works on whole warps");

// The mesh forms', chosen on the card with frame_sweep.py (PERF.md).
constexpr int kFrameMinBlocks = 4;   // __launch_bounds__ blocks per SM

// Dynamic shared memory of a fused_frame block: the tables (the shared
// placement; and, in a mesh form, the visit orders and the warps' staging
// buffers), then the histogram of bounces run (0 .. max_depth -
// start_bounce).
__host__ __device__ inline size_t frame_smem(const SceneArgs& sc, int span, bool global) {
  const size_t tables =
      sc.pack == nullptr
          ? (global ? 0 : sizeof(float) * static_cast<size_t>(small_table_words(sc)))
          : smem_bytes(sc, global);
  return tables + sizeof(int) * static_cast<size_t>(span + 1);
}

// Adds the block's histogram of bounces run to the rays per bounce: a path
// that ran nb bounces was live at bounces start .. start + nb - 1.
__device__ inline void add_rays(const FrameIO& io, const int* hist) {
  const int span = io.max_depth - io.start_bounce;
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    unsigned long long live = 0;
    for (int k = j + 1; k <= span; ++k) live += static_cast<unsigned long long>(hist[k]);
    if (live != 0) atomicAdd(io.counts + io.start_bounce + j, live);
  }
}

// Each form is defined once as a macro and instantiated twice: NAME with
// GLOBAL false copies the tables into shared memory, the *_global_kernel
// with GLOBAL true reads them from global memory (spt_common.cuh
// load_tables).  A macro, not a common inlined body, so that each kernel's
// body is its own text and the shared kernels compile to the code they had
// before the global ones existed (a common body changed the stream form's
// SASS and local bytes).
#define SPT_SMALL_FRAME_KERNEL(NAME, GLOBAL)                                        \
  __global__ void __launch_bounds__(kSmallBlock, kSmallMinBlocks)                   \
      NAME(FrameIO io, SceneArgs sc, ShadeArgs sa) {                                \
    extern __shared__ __align__(16) float small_smem[];                             \
    const int span = io.max_depth - io.start_bounce;                                \
    int* hist = reinterpret_cast<int*>(small_smem + (GLOBAL ? 0 : small_table_words(sc))); \
    for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;              \
    /* the loader's barrier covers hist */                                          \
    const Tables tb = load_small_tables<GLOBAL>(small_smem, sc);                    \
    run_paths<false>(io, tb, RolledTracer{&tb}, sa, hist, io.n, kChunk, 32, kRefillMin); \
    add_rays(io, hist);                                                             \
  }

SPT_SMALL_FRAME_KERNEL(small_frame_kernel, false)
SPT_SMALL_FRAME_KERNEL(small_frame_global_kernel, true)

// The mesh forms.  kMode: 1 resident (ClusterTracer), 2 instanced
// (InstTracer), 3 stream (StreamTracer).
#define SPT_FUSED_FRAME_KERNEL(NAME, GLOBAL)                                        \
  template <int kMode>                                                              \
  __global__ void __launch_bounds__(kBlock, kFrameMinBlocks)                        \
      NAME(FrameIO io, SceneArgs sc, ShadeArgs sa) {                                \
    extern __shared__ __align__(16) float smem[];                                   \
    unsigned long long* queued = io.counts + io.max_depth + 1;                      \
    /* dead lanes' outputs are their inputs, missed 0 */                            \
    sweep_queue(io.in.alive, io.n, io.start_bounce < io.max_depth, queued, io.queue, \
                [&](int i) {                                                        \
                  io.o_dx[i] = io.in.dx[i];                                         \
                  io.o_dy[i] = io.in.dy[i];                                         \
                  io.o_dz[i] = io.in.dz[i];                                         \
                  io.o_tx[i] = io.in.tx[i];                                         \
                  io.o_ty[i] = io.in.ty[i];                                         \
                  io.o_tz[i] = io.in.tz[i];                                         \
                  io.o_rx[i] = io.in.rx[i];                                         \
                  io.o_ry[i] = io.in.ry[i];                                         \
                  io.o_rz[i] = io.in.rz[i];                                         \
                  io.o_missed[i] = 0;                                               \
                });                                                                 \
    grid_barrier(queued + 1);                                                       \
    int live;                                                                       \
    const int take = queue_take(queued, live);                                      \
    if (take == 0) return;                                                          \
                                                                                    \
    const int span = io.max_depth - io.start_bounce;                                \
    int* hist = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + smem_bytes(sc, GLOBAL)); \
    for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;              \
    /* the loader's barrier covers hist */                                          \
    const Tables tb = load_tables<GLOBAL>(smem, sc);                                \
    run_queue<kMode>(io, tb, sc, sa, hist, live, take);                             \
    add_rays(io, hist);                                                             \
  }

SPT_FUSED_FRAME_KERNEL(fused_frame_kernel, false)
SPT_FUSED_FRAME_KERNEL(fused_frame_global_kernel, true)

// One launch of a form in the placement `global`: Shared is the kernel of
// the shared placement, Global that of the global one.
template <class Shared, class Global>
inline cudaError_t launch_frame(Shared shared, Global global_form, bool global, FrameIO& io,
                                SceneArgs& sc, ShadeArgs& sa, size_t smem, cudaStream_t st) {
  return global ? launch_queue(global_form, io, sc, sa, smem, st)
                : launch_queue(shared, io, sc, sa, smem, st);
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:1207 (fused_frame, pallas_call
// :1298): bounces [start_bounce, max_depth) of lanes whose RNG words are
// int64 and flags bytes, writing `missed` as bytes and adding the rays per
// bounce into counts[0 .. max_depth) of the zeroed (max_depth + 3) int64
// `counts` (the rest are the kernel's counters).  A null `pack` selects the
// small form, n_inst > 0 the instanced one, `cbox` (with `corder`) the
// stream one, else the resident one; a mesh form needs `queue`, (n) int32
// scratch.  `global_tables` nonzero selects the global placement of the
// tables (spt_common.cuh; the small form's `tables` then 16-byte aligned),
// else the shared one, refused when a block's shared memory cannot hold
// it.  One persistent launch on `stream` (cooperative in the mesh forms);
// returns the CUDA error of the launch (0: accepted).  Allocates nothing
// and does not synchronise.
int spt_fused_frame(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tx, const float* ty,
                    const float* tz, const float* rx, const float* ry, const float* rz,
                    const long long* rng, const uint8_t* alive, const uint8_t* emok,
                    float* o_dx, float* o_dy, float* o_dz, float* o_tx, float* o_ty, float* o_tz,
                    float* o_rx, float* o_ry, float* o_rz, uint8_t* o_missed,
                    unsigned long long* counts, int* queue, const float* tables, int n_tris,
                    int n_sphs, int n_mats, int n_lights, int n_emit, int flags,
                    const float* pack, int pack_w, int n_clusters, int cluster_size,
                    int n_inst, int n_meshes, const int* tex, int tex_res, const float* cbox,
                    const uint16_t* corder, int global_tables, int n, int start_bounce,
                    int max_depth,
                    int rr_after, float hit_eps, float ray_offset_dir, float firefly_clamp,
                    void* stream) {
  FrameIO io{{ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz, rng, alive, emok},
             o_dx, o_dy, o_dz, o_tx, o_ty, o_tz, o_rx, o_ry, o_rz, o_missed, counts, queue,
             n, start_bounce, max_depth};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const bool small = pack == nullptr;
  const bool global = global_tables != 0;
  if (n_mats < 1 || start_bounce < 0 || start_bounce > max_depth ||
      (!small && queue == nullptr) || (cbox != nullptr && corder == nullptr) ||
      (small && global && reinterpret_cast<uintptr_t>(tables) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = frame_smem(sc, max_depth - start_bounce, global);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (small) {
    void (*kernel)(FrameIO, SceneArgs, ShadeArgs) = small_frame_kernel;
    if (global) kernel = small_frame_global_kernel;
    int blocks = 0;
    err = resident_blocks(kernel, kSmallBlock, smem, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    // no more blocks than the lanes give each warp a chunk
    const int lanes_a_block = kChunk * (kSmallBlock / 32);
    const int grid = max(1, min(blocks, (n + lanes_a_block - 1) / lanes_a_block));
    kernel<<<grid, kSmallBlock, smem, st>>>(io, sc, sa);
  } else if (n_inst > 0) {
    err = launch_frame(fused_frame_kernel<2>, fused_frame_global_kernel<2>, global, io, sc, sa,
                       smem, st);
  } else if (cbox != nullptr) {
    err = launch_frame(fused_frame_kernel<3>, fused_frame_global_kernel<3>, global, io, sc, sa,
                       smem, st);
  } else {
    err = launch_frame(fused_frame_kernel<1>, fused_frame_global_kernel<1>, global, io, sc, sa,
                       smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the small (mode 0), resident (1),
// instanced (2) or stream (3) form in the shared placement, or of the same
// form in the global one (mode 4 + form).
int spt_fused_frame_kernel_info(int mode, int smem, int* num_regs, int* local_bytes,
                                int* blocks) {
  switch (mode) {
    case 1: return kernel_info(fused_frame_kernel<1>, smem, num_regs, local_bytes, blocks);
    case 2: return kernel_info(fused_frame_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 3: return kernel_info(fused_frame_kernel<3>, smem, num_regs, local_bytes, blocks);
    case 4:
      return kernel_info(small_frame_global_kernel, smem, num_regs, local_bytes, blocks,
                         kSmallBlock);
    case 5: return kernel_info(fused_frame_global_kernel<1>, smem, num_regs, local_bytes, blocks);
    case 6: return kernel_info(fused_frame_global_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 7: return kernel_info(fused_frame_global_kernel<3>, smem, num_regs, local_bytes, blocks);
    default:
      return kernel_info(small_frame_kernel, smem, num_regs, local_bytes, blocks, kSmallBlock);
  }
}

const char* spt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
