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
// What bounds it on an H100: the mesh forms' path state is 15 planes in
// and 11 out, 26 x 4 = 104 B per lane per frame; the small form's is 58 B
// in (12 float planes, the int64 RNG word, two byte flags) and 37 B out (9
// float planes, the missed byte), 95 B — about 197 MB at 1920x1080, some
// 59 us at 3.35 TB/s — so device memory is not the limit.  Per-thread ALU
// work (ray-primitive tests per bounce), its divergence across a warp
// (lanes die at different bounces and take different scatter branches)
// and the latency of dependent float chains are.
//
// The mesh forms run one thread per path: the tables are copied into shared
// memory once per block and each thread exits its loop when its own path
// dies.  The small form answers the divergence:
// - lane refill: a persistent grid (as many blocks as the SMs hold) loads
//   the tables once per block; each warp takes lanes in chunks of kChunk
//   from a counter in global memory and, at the top of its bounce loop,
//   hands the next lanes of its chunk to its threads whose paths ended once
//   kRefillMin of them are free, so a warp whose paths die early keeps
//   working on new ones instead of idling beside its longest path.  Each
//   path runs exactly the arithmetic it runs alone (its own bounce index
//   and is_last) and writes its outputs at its own lane, so only which
//   thread computes a path changes, never a bit of its result.  Small
//   chunks keep the warps' ends together (chunks of 512 lanes took 2.7x
//   the time of 32 on default).  Refilling at 8 free threads is the
//   compromise measured over the three small configs: at 4, cornell gains
//   3 % and hdr loses 3 %; at 16, hdr gains 3 % and cornell loses 11 %;
//   refilling only whole warps takes 1.29x on cornell;
// - 6 blocks of 128 threads per SM: the launch bound caps the kernel at 80
//   registers, and it spills (56 B stored, 76 B loaded a thread, 72 B of
//   stack); 5 blocks (93 registers, no spill) took 3 %, 5 % and 5 % more
//   time on default, cornell and hdr, 8 (64 registers) more on two of them;
// - float4 triangle and sphere rows (spt_tracers.cuh tri_test / sph_test);
// - the rays per bounce counted in the kernel: a block histograms how many
//   bounces its paths ran (warp-aggregated shared atomics) and adds the
//   suffix sums to the int64 output, one atomic a block and bounce; the
//   path state is read in the dtypes the port keeps it in (the RNG word as
//   int64, the flags as bytes), so the wrapper converts nothing.

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

// kMode: 1 resident (ClusterTracer), 2 instanced (InstTracer), 3 stream
// (StreamTracer).
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
    } else {
      alive = shade_bounce(tb, cluster_tracer(tb, sc), sa, bounce, is_last, o, d, thr, rad,
                           rng, emok, missed);
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

// The small form's launch shape and refill, chosen on the card with
// frame_sweep.py (PERF.md).
constexpr int kSmallBlock = 128;     // threads a block
constexpr int kSmallMinBlocks = 6;   // __launch_bounds__ blocks per SM
constexpr int kRefillMin = 8;        // free threads at which a warp refills
constexpr int kChunk = 32;           // lanes a warp takes from the counter at once
static_assert(kSmallBlock % 32 == 0, "the refill works on whole warps");

struct SmallIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tx, *ty, *tz, *rx, *ry, *rz;
  const long long* rng;  // uint32 words held in int64
  const uint8_t *alive, *emok;
  float *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  uint8_t* o_missed;
  // (max_depth + 1), zeroed by the caller: rays per bounce, then the
  // counter of lanes handed out
  unsigned long long* counts;
  int n, start_bounce, max_depth;
};

// Dynamic shared memory of a small_frame_kernel block: the tables, then the
// histogram of bounces run (0 .. max_depth - start_bounce).
__host__ __device__ inline size_t small_frame_smem(const SceneArgs& sc, int span) {
  return sizeof(float) * static_cast<size_t>(small_table_words(sc)) +
         sizeof(int) * static_cast<size_t>(span + 1);
}

__global__ void __launch_bounds__(kSmallBlock, kSmallMinBlocks)
    small_frame_kernel(SmallIO io, SceneArgs sc, ShadeArgs sa) {
  extern __shared__ __align__(16) float small_smem[];
  const int span = io.max_depth - io.start_bounce;
  int* hist = reinterpret_cast<int*>(small_smem + small_table_words(sc));
  for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;
  const Tables tb = load_small_tables(small_smem, sc);  // its barrier covers hist
  const RolledTracer tracer{&tb};
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* handed = io.counts + io.max_depth;

  int idx = -1;  // the lane this thread's path belongs to; -1: none
  int bounce = 0, nb = 0;
  V3 o, d, thr, rad;
  uint32_t rng = 0;
  bool alive = false, emok = false, missed_ever = false;
  int next = 0, end = 0;  // the warp's chunk of lanes (warp-uniform)
  bool more = true;       // the counter has lanes left (warp-uniform)

  while (true) {
    // the warp has converged here: finish the paths that ended ...
    const bool done = idx >= 0 && !(alive && bounce < io.max_depth);
    const unsigned done_mask = __ballot_sync(0xffffffffu, done);
    if (done) {
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
      idx = -1;
    }
    // ... then hand the free threads the next lanes of the warp's chunk
    const unsigned free_mask = __ballot_sync(0xffffffffu, idx < 0);
    const int n_free = __popc(free_mask);
    if (more && n_free >= kRefillMin) {
      const bool fresh = idx < 0;
      const int rank = __popc(free_mask & below);
      int taken = 0;
      while (taken < n_free) {
        if (next >= end) {
          unsigned long long c = 0;
          if (lane == 0) c = atomicAdd(handed, static_cast<unsigned long long>(kChunk));
          c = __shfl_sync(0xffffffffu, c, 0);
          if (c >= static_cast<unsigned long long>(io.n)) {
            more = false;
            break;
          }
          next = static_cast<int>(c);
          end = min(io.n, next + kChunk);
        }
        const int k = min(n_free - taken, end - next);
        if (fresh && rank >= taken && rank < taken + k) idx = next + rank - taken;
        next += k;
        taken += k;
      }
      if (fresh && idx >= 0) {
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

  // a path that ran nb bounces was live at bounces start .. start + nb - 1
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    unsigned long long live = 0;
    for (int k = j + 1; k <= span; ++k) live += static_cast<unsigned long long>(hist[k]);
    if (live != 0) atomicAdd(io.counts + io.start_bounce + j, live);
  }
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:1207 (fused_frame, pallas_call
// :1298) on a mesh scene: launches the resident form on `stream`, the
// instanced one when n_inst > 0, the stream one when `cbox` (with `corder`)
// is set, and returns the CUDA error of the launch (0: accepted; a null
// `pack` is refused: the small form is spt_small_frame).  Allocates nothing
// and does not synchronise.
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
  if (n_mats < 1 || pack == nullptr || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_inst > 0) {
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

// The small form (accel mode None, tables in the small layout):
// fused_frame for lanes whose RNG words are int64 and flags bytes, writing
// `missed` as bytes and adding the rays per bounce into counts[0 ..
// max_depth) of the zeroed (max_depth + 1) int64 `counts` (the last entry
// is the kernel's lane counter).  One persistent launch of as many blocks
// as the SMs hold at once on `stream`; returns the CUDA error of the launch
// (0: accepted).  Allocates nothing and does not synchronise.
int spt_small_frame(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tx, const float* ty,
                    const float* tz, const float* rx, const float* ry, const float* rz,
                    const long long* rng, const uint8_t* alive, const uint8_t* emok,
                    float* o_dx, float* o_dy, float* o_dz, float* o_tx, float* o_ty, float* o_tz,
                    float* o_rx, float* o_ry, float* o_rz, uint8_t* o_missed,
                    unsigned long long* counts, const float* tables, int n_tris, int n_sphs,
                    int n_mats, int n_lights, int n_emit, int flags, const float* pack,
                    int pack_w, int n_clusters, int cluster_size, int n_inst, int n_meshes,
                    const int* tex, int tex_res, const float* cbox, const uint16_t* corder,
                    int n, int start_bounce, int max_depth, int rr_after, float hit_eps,
                    float ray_offset_dir, float firefly_clamp, void* stream) {
  SmallIO io{ox,   oy,   oz,   dx,   dy,   dz,   tx,   ty,   tz,   rx,       ry,     rz,
             rng,  alive, emok, o_dx, o_dy, o_dz, o_tx, o_ty, o_tz, o_rx,     o_ry,   o_rz,
             o_missed, counts, n, start_bounce, max_depth};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  if (n_mats < 1 || pack != nullptr || start_bounce < 0 || start_bounce > max_depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = small_frame_smem(sc, max_depth - start_bounce);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = reserve_smem(small_frame_kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small_frame_kernel,
                                                        kSmallBlock, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more blocks than the lanes give each warp a chunk
  const int lanes_a_block = kChunk * (kSmallBlock / 32);
  const int grid = max(1, min(sms * per_sm, (n + lanes_a_block - 1) / lanes_a_block));
  small_frame_kernel<<<grid, kSmallBlock, smem, static_cast<cudaStream_t>(stream)>>>(io, sc,
                                                                                     sa);
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
