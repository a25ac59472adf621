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
// threads whose paths ended (run_paths):
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
// tables only to copy dead lanes through.  A kernel runs in two steps:
// - a coalesced sweep over every lane writes each dead lane's outputs (its
//   inputs, missed 0) and appends the live lanes to a queue in global
//   memory, one atomic a warp (ballot, then each lane's rank below it);
// - after a grid-wide barrier (the launch is cooperative, so every block
//   is resident) the warps take queued lanes `take` at a time, where take
//   follows the live count read on the device: live / (warps in the grid),
//   rounded up, at most 32.  Below 32 a warp runs each of its `take` paths
//   on 32 / take threads in step (twins, run_paths), and each group of
//   twins walks its ray as one (spt_tracers.cuh group_walk: a window of
//   box tests at once, the 64 tests of each opened cluster spread over the
//   group, the instanced tracer's instance scan split over it), so a sparse
//   tail spreads over every warp of every SM and a lone ray's walk is not
//   one thread's chain of dependent loads.  At 32 (a dense call: every lane
//   of bounce 0, the unsorted route) each thread runs a path with the
//   warp's lockstep walk, as before.  Blocks past those the live lanes need
//   leave after the barrier without loading the tables.
// The constants were chosen on the card with frame_sweep.py (PERF.md): a
// warp refills only once all its paths have ended, since refilling at 8
// free threads mixes a primary ray into a warp of later bounces and took
// 11-25 % more time on the grids' dense calls; a launch bound of 3 blocks
// per SM (155-165 registers, 32 B of spill) took 25-42 % more on the
// grids' sorted calls; a floor of 2 lanes a warp took 1.3x on the mesh
// scene's 1207 live lanes.

#include "spt_tracers.cuh"

namespace {

using namespace spt;

struct FrameIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tx, *ty, *tz, *rx, *ry, *rz;
  const long long* rng;  // uint32 words held in int64
  const uint8_t *alive, *emok;
  float *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  uint8_t* o_missed;
  // (max_depth + 3), zeroed by the caller: the rays per bounce, then the
  // counters of lanes handed out, of lanes queued (mesh forms) and of the
  // blocks at the grid barrier (mesh forms: gridDim.x once it is passed)
  unsigned long long* counts;
  int* queue;  // mesh forms: (n) the live lanes' ids; small form: null
  int n, start_bounce, max_depth;
};

// The small form's launch shape and refill, chosen on the card with
// frame_sweep.py (PERF.md).
constexpr int kSmallBlock = 128;     // threads a block
constexpr int kSmallMinBlocks = 6;   // __launch_bounds__ blocks per SM
constexpr int kRefillMin = 8;        // free threads at which a warp refills
constexpr int kChunk = 32;           // lanes a warp takes from the counter at once
static_assert(kSmallBlock % 32 == 0, "the refill works on whole warps");

// The mesh forms', chosen on the card with frame_sweep.py (PERF.md).
constexpr int kBlock = 128;
static_assert(kBlock == 32 * kWarps, "the staging buffers are laid out per warp");
constexpr int kFrameMinBlocks = 4;   // __launch_bounds__ blocks per SM

// Dynamic shared memory of a fused_frame block: the tables (and, in a mesh
// form, the visit orders and the warps' staging buffers), then the
// histogram of bounces run (0 .. max_depth - start_bounce).
__host__ __device__ inline size_t frame_smem(const SceneArgs& sc, int span) {
  const size_t tables = sc.pack == nullptr
                            ? sizeof(float) * static_cast<size_t>(small_table_words(sc))
                            : smem_bytes(sc);
  return tables + sizeof(int) * static_cast<size_t>(span + 1);
}

// The refill loop of both kinds of kernel.  Each warp takes positions
// [0, lanes) from the counter counts[max_depth], `chunk` at a time, and
// runs their paths on its first `width` threads; the lane of position p is
// p itself or, with kQueued, queue[p].  With width below 32, thread t past
// the first `width` runs a copy of thread t % width's path (its twin,
// spt_tracers.cuh): it computes the same values in step with it and helps
// its walks, and writes nothing.  At the top of its bounce loop the warp
// finishes the paths that ended (outputs at their lane, bounces run into
// `hist`) and hands the next positions of its chunk to its free threads
// once min(refill_min, width) of them are free: by default once all are.
template <bool kQueued, class Tracer>
__device__ inline void run_paths(const FrameIO& io, const Tables& tb, const Tracer& tracer,
                                 const ShadeArgs& sa, int* hist, int lanes, int chunk,
                                 int width, int refill_min = 32) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool mine = lane < static_cast<unsigned>(width);
  const int refill_at = min(refill_min, width);
  unsigned long long* handed = io.counts + io.max_depth;

  int idx = -1;  // the lane this thread's path belongs to; -1: none
  int bounce = 0, nb = 0;
  V3 o, d, thr, rad;
  uint32_t rng = 0;
  bool alive = false, emok = false, missed_ever = false;
  int next = 0, end = 0;  // the warp's chunk of positions (warp-uniform)
  bool more = true;       // the counter has positions left (warp-uniform)

  while (true) {
    // the warp has converged here: finish the paths that ended ...
    const bool done = idx >= 0 && !(alive && bounce < io.max_depth);
    const unsigned done_mask = __ballot_sync(0xffffffffu, done && mine);
    if (done && mine) {
      io.o_dx[idx] = d.x;
      io.o_dy[idx] = d.y;
      io.o_dz[idx] = d.z;
      io.o_tx[idx] = thr.x;
      io.o_ty[idx] = thr.y;
      io.o_tz[idx] = thr.z;
      io.o_rx[idx] = rad.x;
      io.o_ry[idx] = rad.y;
      io.o_rz[idx] = rad.z;
      io.o_missed[idx] = missed_ever;
      const unsigned same = __match_any_sync(done_mask, nb);
      if (nb > 0 && lane == static_cast<unsigned>(__ffs(same) - 1))
        atomicAdd(hist + nb, __popc(same));
    }
    if (done) idx = -1;
    // ... then hand the free threads the next positions of the warp's chunk
    const unsigned free_mask = __ballot_sync(0xffffffffu, mine && idx < 0);
    const int n_free = __popc(free_mask);
    if (more && n_free >= refill_at) {
      const bool fresh = mine && idx < 0;
      const int rank = __popc(free_mask & below);
      int pos = -1, taken = 0;
      while (taken < n_free) {
        if (next >= end) {
          unsigned long long c = 0;
          if (lane == 0) c = atomicAdd(handed, static_cast<unsigned long long>(chunk));
          c = __shfl_sync(0xffffffffu, c, 0);
          if (c >= static_cast<unsigned long long>(lanes)) {
            more = false;
            break;
          }
          next = static_cast<int>(c);
          end = min(lanes, next + chunk);
        }
        const int k = min(n_free - taken, end - next);
        if (fresh && rank >= taken && rank < taken + k) pos = next + rank - taken;
        next += k;
        taken += k;
      }
      if (width < 32) pos = __shfl_sync(0xffffffffu, pos, lane % width);
      if (pos >= 0) {
        // the queue was written by other blocks before the grid barrier
        idx = kQueued ? __ldcg(io.queue + pos) : pos;
        o = v3(io.ox[idx], io.oy[idx], io.oz[idx]);
        d = v3(io.dx[idx], io.dy[idx], io.dz[idx]);
        thr = v3(io.tx[idx], io.ty[idx], io.tz[idx]);
        rad = v3(io.rx[idx], io.ry[idx], io.rz[idx]);
        rng = static_cast<uint32_t>(io.rng[idx]);
        alive = io.alive[idx] != 0;
        emok = io.emok[idx] != 0;
        missed_ever = false;
        bounce = io.start_bounce;
        nb = 0;
      }
    }
    if (!more && __ballot_sync(0xffffffffu, idx >= 0) == 0) break;
    if (idx >= 0 && alive && bounce < io.max_depth) {
      ++nb;
      bool missed;
      alive = shade_bounce(tb, tracer, sa, bounce, bounce == io.max_depth - 1, o, d, thr, rad,
                           rng, emok, missed);
      if (missed) missed_ever = true;
      ++bounce;
    }
  }
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

__global__ void __launch_bounds__(kSmallBlock, kSmallMinBlocks)
    small_frame_kernel(FrameIO io, SceneArgs sc, ShadeArgs sa) {
  extern __shared__ __align__(16) float small_smem[];
  const int span = io.max_depth - io.start_bounce;
  int* hist = reinterpret_cast<int*>(small_smem + small_table_words(sc));
  for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;
  const Tables tb = load_small_tables(small_smem, sc);  // its barrier covers hist
  run_paths<false>(io, tb, RolledTracer{&tb}, sa, hist, io.n, kChunk, 32, kRefillMin);
  add_rays(io, hist);
}

// run_paths on a mesh form's tracer; kMode: 1 resident (ClusterTracer), 2
// instanced (InstTracer), 3 stream (StreamTracer).
template <int kMode, bool kTwins>
__device__ inline void run_mesh(const FrameIO& io, const Tables& tb, const SceneArgs& sc,
                                const ShadeArgs& sa, int* hist, int live, int take) {
  const int ray = static_cast<int>(threadIdx.x & 31) % take;
  if constexpr (kMode == 3) {
    run_paths<true>(io, tb, stream_tracer<kTwins>(tb, sc, ray), sa, hist, live, take, take);
  } else if constexpr (kMode == 2) {
    run_paths<true>(io, tb, inst_tracer<kTwins>(tb, sc, ray), sa, hist, live, take, take);
  } else {
    run_paths<true>(io, tb, cluster_tracer<kTwins>(tb, sc, ray), sa, hist, live, take, take);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kBlock, kFrameMinBlocks)
    fused_frame_kernel(FrameIO io, SceneArgs sc, ShadeArgs sa) {
  extern __shared__ __align__(16) float smem[];
  unsigned long long* queued = io.counts + io.max_depth + 1;
  unsigned long long* arrived = queued + 1;
  const unsigned lane = threadIdx.x & 31;
  const bool run = io.start_bounce < io.max_depth;

  // the sweep, one warp-wide step at a time: dead lanes' outputs are their
  // inputs; live lanes join the queue, one atomic a warp
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < io.n;
       base += gridDim.x * blockDim.x) {
    const int i = base + static_cast<int>(lane);
    const bool in = i < io.n;
    const bool live = in && run && io.alive[i] != 0;
    if (in && !live) {
      io.o_dx[i] = io.dx[i];
      io.o_dy[i] = io.dy[i];
      io.o_dz[i] = io.dz[i];
      io.o_tx[i] = io.tx[i];
      io.o_ty[i] = io.ty[i];
      io.o_tz[i] = io.tz[i];
      io.o_rx[i] = io.rx[i];
      io.o_ry[i] = io.ry[i];
      io.o_rz[i] = io.rz[i];
      io.o_missed[i] = 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m != 0u) {
      unsigned long long at = 0;
      if (lane == 0) at = atomicAdd(queued, static_cast<unsigned long long>(__popc(m)));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (live) io.queue[at + __popc(m & ((1u << lane) - 1u))] = i;
    }
  }

  // the grid barrier, once per launch (the counter starts at 0)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1ull);
    while (*reinterpret_cast<volatile unsigned long long*>(arrived) < gridDim.x) {
    }
    __threadfence();
  }
  __syncthreads();

  const int live = static_cast<int>(*reinterpret_cast<volatile unsigned long long*>(queued));
  const int warps = static_cast<int>(gridDim.x) * kWarps;
  const int take = min(32, (live + warps - 1) / warps);
  // the blocks the live lanes need; the others have nothing left to do
  if (live == 0 || static_cast<int>(blockIdx.x) * kWarps * take >= live) return;

  const int span = io.max_depth - io.start_bounce;
  int* hist = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + smem_bytes(sc));
  for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;
  const Tables tb = load_tables(smem, sc);  // its barrier covers hist
  // a path a thread (the lockstep walk alone) when the lanes fill every
  // thread, else twins past the first `take` threads
  if (take < 32) {
    run_mesh<kMode, true>(io, tb, sc, sa, hist, live, take);
  } else {
    run_mesh<kMode, false>(io, tb, sc, sa, hist, live, take);
  }
  add_rays(io, hist);
}

// The blocks of `kernel` an SM holds at once with `smem` bytes of dynamic
// shared memory each, times the SMs: the persistent grid.
template <class K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = sms * per_sm;
  return err;
}

// One cooperative launch of a mesh form on as many blocks as the SMs hold
// at once, and no more than one a kBlock lanes.
template <int kMode>
inline cudaError_t launch_mesh(FrameIO& io, SceneArgs& sc, ShadeArgs& sa, size_t smem,
                               cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident_blocks(fused_frame_kernel<kMode>, kBlock, smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(blocks, (io.n + kBlock - 1) / kBlock);
  void* args[] = {&io, &sc, &sa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_frame_kernel<kMode>),
                                     dim3(grid), dim3(kBlock), args, smem, st);
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
// scratch.  One persistent launch on `stream` (cooperative in the mesh
// forms); returns the CUDA error of the launch (0: accepted).  Allocates
// nothing and does not synchronise.
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
                    const uint16_t* corder, int n, int start_bounce, int max_depth,
                    int rr_after, float hit_eps, float ray_offset_dir, float firefly_clamp,
                    void* stream) {
  FrameIO io{ox,   oy,   oz,   dx,   dy,   dz,   tx,   ty,       tz,     rx,    ry,
             rz,   rng,  alive, emok, o_dx, o_dy, o_dz, o_tx,     o_ty,   o_tz,  o_rx,
             o_ry, o_rz, o_missed, counts, queue, n, start_bounce, max_depth};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const bool small = pack == nullptr;
  if (n_mats < 1 || start_bounce < 0 || start_bounce > max_depth ||
      (!small && queue == nullptr) || (cbox != nullptr && corder == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = frame_smem(sc, max_depth - start_bounce);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (small) {
    int blocks = 0;
    err = resident_blocks(small_frame_kernel, kSmallBlock, smem, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    // no more blocks than the lanes give each warp a chunk
    const int lanes_a_block = kChunk * (kSmallBlock / 32);
    const int grid = max(1, min(blocks, (n + lanes_a_block - 1) / lanes_a_block));
    small_frame_kernel<<<grid, kSmallBlock, smem, st>>>(io, sc, sa);
  } else if (n_inst > 0) {
    err = launch_mesh<2>(io, sc, sa, smem, st);
  } else if (cbox != nullptr) {
    err = launch_mesh<3>(io, sc, sa, smem, st);
  } else {
    err = launch_mesh<1>(io, sc, sa, smem, st);
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
                     : kernel_info(small_frame_kernel, smem, num_regs, local_bytes, blocks,
                                   kSmallBlock);
}

const char* spt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
