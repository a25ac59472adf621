// The persistent queue kernels' shared parts: K1's mesh forms
// (fused_frame.cu fused_frame_kernel<1..3>) and K3's resident form
// (fused_bounce.cu fused_bounce_queue_kernel<1>), and the refill loop K1's
// small form (small_frame_kernel) runs too.
//
// A queue kernel runs on a persistent grid, as many blocks as the SMs hold
// at once, launched cooperatively (launch_queue), in two steps:
// - a coalesced sweep over every lane writes each dead lane's outputs (its
//   inputs carried through) and appends the live lanes to a queue in global
//   memory, one atomic a warp (sweep_queue: a ballot, then each lane's rank
//   below it);
// - after a grid-wide barrier (grid_barrier) the warps take queued lanes
//   `take` at a time, where take follows the live count read on the device:
//   live / (warps in the grid), rounded up, 32 when that reaches 32, else
//   kTakeMax (1; queue_take).  Below 32 a warp runs each of its `take`
//   paths on 32 / take threads in step (twins: spt_tracers.cuh kTwins, each
//   group walking its ray as one, group_walk) and takes more once they
//   end, so a sparse tail spreads over every warp of every SM and a lone
//   ray's walk is not one thread's chain of dependent loads; at 32 (a dense
//   call) each thread runs a path with the warp's lockstep walk
//   (run_queue).  Blocks past those the live lanes need leave after the
//   barrier without loading the tables.
// What the kernels differ in is the IO class run_paths is templated on:
// the path state both read (PathIn), what they write of a path that ended
// (K1: what the deferred environment term needs; K3: the whole new state)
// and how many bounces a path runs (K1: [start_bounce, max_depth); K3: one,
// whose is_last the caller gives).

#pragma once

#include "spt_tracers.cuh"

namespace spt {

// Threads a block of the queue kernels (and of K3's one-thread-a-lane forms).
constexpr int kBlock = 128;
static_assert(kBlock == 32 * kWarps, "the staging buffers are laid out per warp");

// The path state the kernels read, in the dtypes the port keeps it in.
struct PathIn {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tx, *ty, *tz, *rx, *ry, *rz;
  const long long* rng;  // uint32 words held in int64
  const uint8_t *alive, *emok;
};

// One path in a thread's registers.
struct Path {
  V3 o, d, thr, rad;
  uint32_t rng;
  bool alive, emok;
  bool missed;     // the ray left the scene at a bounce run
  int bounce, nb;  // the next bounce; the bounces run
};

__device__ __forceinline__ Path load_path(const PathIn& in, int i, int bounce) {
  Path p;
  p.o = v3(in.ox[i], in.oy[i], in.oz[i]);
  p.d = v3(in.dx[i], in.dy[i], in.dz[i]);
  p.thr = v3(in.tx[i], in.ty[i], in.tz[i]);
  p.rad = v3(in.rx[i], in.ry[i], in.rz[i]);
  p.rng = static_cast<uint32_t>(in.rng[i]);
  p.alive = in.alive[i] != 0;
  p.emok = in.emok[i] != 0;
  p.missed = false;
  p.bounce = bounce;
  p.nb = 0;
  return p;
}

// The refill loop.  Each warp takes positions [0, lanes) from the counter
// io.handed(), `chunk` at a time, and runs their paths on its first `width`
// threads; the lane of position p is p itself or, with kQueued,
// io.queue[p].  A path runs bounces io.first() .. io.stop() - 1 while it
// lives, is_last from io.last(bounce).  With width below 32, thread t past
// the first `width` runs a copy of thread t % width's path (its twin): it
// computes the same values in step with it and helps its walks, and writes
// nothing.  At the top of its bounce loop the warp finishes the paths that
// ended (io.store at their lane; with IO::kCountsRays the bounces run into
// `hist`) and hands the next positions of its chunk to its free threads
// once min(refill_min, width) of them are free: by default once all are.
// Each path runs exactly the arithmetic it runs alone and writes its
// outputs at its own lane, so only which thread computes a path changes,
// never a bit of its result.
template <bool kQueued, class IO, class Tracer>
__device__ inline void run_paths(const IO& io, const Tables& tb, const Tracer& tracer,
                                 const ShadeArgs& sa, int* hist, int lanes, int chunk,
                                 int width, int refill_min = 32) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool mine = lane < static_cast<unsigned>(width);
  const int refill_at = min(refill_min, width);
  const int stop = io.stop();
  unsigned long long* handed = io.handed();

  int idx = -1;  // the lane this thread's path belongs to; -1: none
  Path p{};
  int next = 0, end = 0;  // the warp's chunk of positions (warp-uniform)
  bool more = true;       // the counter has positions left (warp-uniform)

  while (true) {
    // the warp has converged here: finish the paths that ended ...
    const bool done = idx >= 0 && !(p.alive && p.bounce < stop);
    const unsigned done_mask = __ballot_sync(0xffffffffu, done && mine);
    if (done && mine) {
      io.store(idx, p);
      if constexpr (IO::kCountsRays) {
        const unsigned same = __match_any_sync(done_mask, p.nb);
        if (p.nb > 0 && lane == static_cast<unsigned>(__ffs(same) - 1))
          atomicAdd(hist + p.nb, __popc(same));
      }
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
        p = load_path(io.in, idx, io.first());
      }
    }
    if (!more && __ballot_sync(0xffffffffu, idx >= 0) == 0) break;
    if (idx >= 0 && p.alive && p.bounce < stop) {
      ++p.nb;
      bool missed;
      p.alive = shade_bounce(tb, tracer, sa, p.bounce, io.last(p.bounce), p.o, p.d, p.thr,
                             p.rad, p.rng, p.emok, missed);
      if (missed) p.missed = true;
      ++p.bounce;
    }
  }
}

// The sweep, one warp-wide step at a time over lanes [0, n): `copy(i)`
// writes dead lane i's outputs; the live lanes (alive, when `run`) join
// `queue` at the count `queued`, one atomic a warp.
template <class Copy>
__device__ inline void sweep_queue(const uint8_t* alive, int n, bool run,
                                   unsigned long long* queued, int* queue, Copy copy) {
  const unsigned lane = threadIdx.x & 31;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n;
       base += gridDim.x * blockDim.x) {
    const int i = base + static_cast<int>(lane);
    const bool in = i < n;
    const bool live = in && run && alive[i] != 0;
    if (in && !live) copy(i);
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m != 0u) {
      unsigned long long at = 0;
      if (lane == 0) at = atomicAdd(queued, static_cast<unsigned long long>(__popc(m)));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (live) queue[at + __popc(m & ((1u << lane) - 1u))] = i;
    }
  }
}

// The grid barrier, once per launch: `arrived` starts at 0 (the caller
// zeroes it) and ends at the blocks launched.  Every block is resident, as
// the launch is cooperative.
__device__ inline void grid_barrier(unsigned long long* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1ull);
    while (*reinterpret_cast<volatile unsigned long long*>(arrived) < gridDim.x) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The most lanes a warp takes at once below 32, chosen on the card with
// frame_sweep.py (PERF.md): a warp's groups of twins walk their rays one
// after another about as much as together, so K3's sorted bounce 1 (17 859
// live lanes, 9 a warp on groups of 3-4 threads) took as long as the
// one-thread-a-lane kernel, 0.134 ms; taken 2 at a time on groups of 16,
// more times over, it took 0.061, and 1 at a time 0.067; over K3's other
// sparse calls and K1's grid sorted calls 1 at a time was 6-12 % faster
// than 2.  So below 32 a warp walks one path at a time, all its threads
// twins of it.
constexpr int kTakeMax = 1;

// After the barrier: `live`, the lanes queued, and the lanes each warp
// takes at once, or 0 when this block has nothing left to do (no lane is
// live, or the live lanes do not reach it): live / (warps in the grid),
// rounded up, 32 when that reaches 32 (a dense call, a path a thread),
// else at most kTakeMax.
__device__ inline int queue_take(const unsigned long long* queued, int& live) {
  live = static_cast<int>(*reinterpret_cast<const volatile unsigned long long*>(queued));
  const int warps = static_cast<int>(gridDim.x) * kWarps;
  int take = min(32, (live + warps - 1) / warps);
  if (take < 32) take = min(take, kTakeMax);
  if (live == 0 || static_cast<int>(blockIdx.x) * kWarps * take >= live) return 0;
  return take;
}

// run_paths over the queue on a mesh form's tracer; kMode: 1 resident
// (ClusterTracer), 2 instanced (InstTracer), 3 stream (StreamTracer).
template <int kMode, bool kTwins, class IO>
__device__ inline void run_mesh(const IO& io, const Tables& tb, const SceneArgs& sc,
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

// A path a thread (the lockstep walk alone) when the lanes fill every
// thread, else twins past the first `take` threads.
template <int kMode, class IO>
__device__ inline void run_queue(const IO& io, const Tables& tb, const SceneArgs& sc,
                                 const ShadeArgs& sa, int* hist, int live, int take) {
  if (take < 32) {
    run_mesh<kMode, true>(io, tb, sc, sa, hist, live, take);
  } else {
    run_mesh<kMode, false>(io, tb, sc, sa, hist, live, take);
  }
}

// One cooperative launch of a queue kernel, kernel(io, sc, sa), on as many
// blocks as the SMs hold at once and no more than one a kBlock lanes.
template <class K, class IO>
inline cudaError_t launch_queue(K kernel, IO& io, SceneArgs& sc, ShadeArgs& sa, size_t smem,
                                cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, kBlock, smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(blocks, (io.n + kBlock - 1) / kBlock);
  return launch_cooperative(kernel, grid, kBlock, smem, st, io, sc, sa);
}

}  // namespace spt
