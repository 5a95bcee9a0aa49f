// Full-depth forward path trace for Hopper (sm_90a).
//
// Replaces the TPU kernel pathtracer_tpu/ops/trace_pallas.py:_trace_kernel
// (launched by _trace_call / trace_fused), whose loop body is
// pathtracer_tpu/ops/bounce_pallas.py:bounce_physics.  One launch traces a
// wavefront of primary rays through all max_depth bounces and returns each
// lane's radiance plus the number of rays traced (alive lanes per bounce,
// twice that with next-event estimation for the shadow rays).  The plain
// PyTorch version is pathtracer_tpu_torch/ops/trace.py:trace_plain over
// ops/bounce.py; this file repeats its arithmetic in the same order.
//
// Design
// - Persistent threads that start a new path in a lane as soon as its path
//   ends (persistent_paths, below).  The grid holds only the blocks that
//   are resident at once (the SMs times the instance's occupancy); each
//   thread runs paths until the launch's lane counter passes n, one bounce
//   per pass of its loop.  Each pass, a warp whose lanes have ended their
//   paths takes as many new lanes from the counter (one atomic by the
//   leader) and hands them out in lane order, so the paths that start
//   together stay in lockstep on consecutive lanes.  A path writes its
//   radiance where it ends.  That is exact: a path's arithmetic depends on
//   its lane alone (the RNG is keyed by sample and depth), so the radiance
//   and the ray count are those of one thread per lane.  One thread per
//   lane, as before, let a warp idle its ended lanes until its longest path
//   ended: about a third of Cornell's lane-bounces.
// - The geom / material / light tables are copied once per block into
//   shared memory (once per resident block: 132 SMs times a few) and
//   indexed by geom, material and light id: the TPU
//   kernel's where-chains over every row (it has no vector gather) become
//   gathers with the same semantics: strict t < best so the first minimum
//   wins, a miss keeps material 0, the light id is clipped to [0, G-1], the
//   geom type is compared as a float.  Misses and light hits terminate
//   without sampling a BSDF; only diffuse lanes sample a light and sweep the
//   shadow ray, and a shadow sweep is skipped when the connection cannot
//   count.  Each skip drops work whose result the JAX kernel masks away.
// - The ray count: each thread counts the bounces of all its paths, and a
//   warp adds its sum with one 64-bit atomic: exact at any size (the TPU
//   kernel sums a float across its sequential grid).
// - Built with -fmad=false and without fast math: a*b+c is not contracted,
//   divisions and sqrtf are IEEE, and rsqrtf stands where JAX uses
//   lax.rsqrt, so the kernel rounds as the op-by-op plain version does.
// - The loop body, pt::bounce_step, lives in trace_common.cuh: the forward
//   kernel of the differentiable trace (trace_grad.cu) runs the same
//   function, so the two forwards agree bit for bit whatever their
//   schedules, and the per-bounce kernel (bounce.cu) runs the same
//   pt::bounce.

// Triangle meshes (kernel 1 with mesh_tables, trace_pallas.py:67-74,115-137):
// a scene whose meshes total at most 4096 triangles passes their in-kernel
// tables (ops/mesh_tables.KernelMeshes: triangles, chunk boxes, corner
// normals, one descriptor row per mesh), which stay in device memory and
// are read through the caches by every lane alike (every lane reads the
// same rows, so they stay in L1: staging smooth_mesh's 15.6 KB in shared
// memory measured no faster).  Each bounce's nearest hit and each counted
// shadow ray also sweep them (trace_common.cuh:mesh_sweep, mesh_occ), each
// lane culling 32-triangle chunks by their boxes.  The sweep keeps only the
// winner (mesh, row, t, u, v) in its loop and shades it once after; the
// shadow ray's sweep stops at the first triangle nearer than the light (its
// caller only compares t with the light's distance).  The kernel is built
// twice: with the sweep, launched for n_mesh > 0, and without it for
// analytic scenes, whose code and registers stay as before.
//
// Participating media (kernel 1 with the volumetric and Henyey-Greenstein
// blocks, trace_pallas.py:90-98,131-173): each lane carries its medium
// (sigma_a rgb, sigma_s, and the phase g) in registers from bounce to
// bounce, starting in vacuum; pt::bounce's kVol / kHg blocks sample the free
// path, scatter in the medium and connect scatter points to the light
// (volumetric NEE: the shadow ray sweeps the analytic geoms and, in the
// mesh instance, the triangles through pt::mesh_occ_split, split by
// material into refractive and opaque).  The launcher picks the instance
// from the volumetric and hg flags, so vacuum scenes run the vacuum code.
//
// Optional surface physics (kernel 1 with the texture, bump, microfacet and
// ward blocks, bounce_pallas.py:645-706,756-783,1054-1074,1121-1138): the
// kSurf instance runs pt::bounce's surface blocks, which the feature bits
// `surf` switch on (a uniform branch per block) and the material columns
// select per lane, so a lobe compiled in but not selected changes nothing,
// as JAX's where-selection.  The launcher picks it for surf != 0 (any mesh
// and media combination), so scenes without the features keep their code.
//
// What bounds it on the H100: operations, not bytes.  A lane reads 28 bytes
// (origin, direction, sample) and writes 12, about 26 MB per 640,000-lane
// iteration (~8 us at 3.35 TB/s), while every bounce costs two sweeps over
// all geoms (nearest hit and shadow ray) of roughly 50-70 fp32 operations
// per geom.  The loop is branchy and divergent: a warp runs the union of its
// lanes' material branches; the persistent schedule keeps its lanes busy
// across path ends, not across materials.  Registers, not memory, are the
// working set.  With meshes the triangle tests dominate: a lane tests the
// 32 triangles of every chunk its ray reaches nearer than its best, and a
// warp runs the chunks any of its lanes reaches (on smooth_mesh's primary
// rays the nearest sweep took ~70% of the mesh instance's time before the
// winner moved out of the loop, the shadow sweep ~25%; chip_smoke.py's
// [mesh:time] measures it).  Sorting lanes by material is later work.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

// One path on a thread: its lane, the bounce it takes next, its carries and
// the radiance it has gathered.  With kVol it carries its medium, starting
// in vacuum (kHg: with the phase g).
struct Path {
  V3 o, d, thr, rad;
  float prev_state;
  Medium med;
  uint32_t s_term;  // sample * 0x85EBCA6B, the RNG's per-sample term
  int lane;
  int dep;
  bool alive;
};

// Path `lane` before its first bounce: its primary ray, unit throughput,
// emit state 0, vacuum, no radiance.
PT_FN Path path_start(int lane, const float* origin, const float* direction,
                      const uint32_t* sample) {
  Path p;
  p.o = v3(origin[3 * lane], origin[3 * lane + 1], origin[3 * lane + 2]);
  p.d = v3(direction[3 * lane], direction[3 * lane + 1], direction[3 * lane + 2]);
  p.thr = v3(1.0f, 1.0f, 1.0f);
  p.rad = v3(0.0f, 0.0f, 0.0f);
  p.prev_state = 0.0f;
  p.med = Medium{};
  p.s_term = sample[lane] * 0x85EBCA6Bu;
  p.lane = lane;
  p.dep = 0;
  p.alive = true;
  return p;
}

// A launch's options, the same for every path.
struct LoopArgs {
  uint32_t seed;
  int max_depth, nee, rr, rr_start, vol_nee;
};

// One bounce of the live path p (bounce_step at its depth).  Clears alive
// where the path ends, by its own outcome or at max_depth, and then writes
// its radiance to its lane of `radiance` [n, 3].
template <bool kVol = false, bool kHg = false, bool kSurf = false>
PT_FN void trace_step(const Tables& T, const LoopArgs& A, Path& p, float* radiance) {
  int gid;
  bool nee_add;
  bounce_step<kVol, kHg, kSurf>(T, bounce_base(A.seed, p.s_term, p.dep), p.dep, A.nee, A.rr,
                                A.rr_start, p.o, p.d, p.thr, p.prev_state, p.rad, p.alive, gid,
                                nee_add, &p.med, A.vol_nee);
  if (++p.dep >= A.max_depth) p.alive = false;
  if (p.alive) return;
  radiance[3 * p.lane] = p.rad.x;
  radiance[3 * p.lane + 1] = p.rad.y;
  radiance[3 * p.lane + 2] = p.rad.z;
}

// Lane `lane`'s whole path on one thread; returns the bounces it traced.
// tests/kernel_host_harness.cpp runs the lanes one by one in index order
// with it, the reference of the schedule below.  max_depth > 0.
template <bool kVol = false, bool kHg = false, bool kSurf = false>
PT_FN unsigned trace_lane(const Tables& T, const LoopArgs& A, int lane, const float* origin,
                          const float* direction, const uint32_t* sample, float* radiance) {
  Path p = path_start(lane, origin, direction, sample);
  unsigned bounces = 0;
  for (; p.alive; ++bounces) trace_step<kVol, kHg, kSurf>(T, A, p, radiance);
  return bounces;
}

// The rank of `lane` among a warp's lanes without a live path (`free`):
// it takes the lane base + rank of the warp's refill.
PT_FN int refill_rank(uint32_t free, int lane) { return PT_POPC(free & ((1u << lane) - 1u)); }

}  // namespace pt

#ifdef __CUDACC__

#include <map>
#include <mutex>
#include <tuple>

namespace {

using namespace pt;

constexpr int TRACE_THREADS = 128;

// The persistent schedule (tests/kernel_host_harness.cpp emulates it):
// every thread of a resident grid runs paths until the lanes run out.  Each
// pass of the loop, a warp with lanes free of a live path takes their count
// from the launch's lane counter `next` (one atomic, by the leader), and its
// free lanes start lanes base + rank: the paths that start together take
// consecutive lanes and stay in lockstep, so their loads and stores share
// sectors.  Then every live path takes one bounce: step(p), which writes
// the path's radiance where it ends.  A thread leaves the loop only with its
// whole warp, once no lane of the warp is live and the counter has passed
// n, so the ballots and the caller's shuffles keep the full mask.  Returns
// the bounces this thread traced.
template <typename Step>
__device__ __forceinline__ unsigned long long persistent_paths(
    int n, unsigned long long* next, const float* origin, const float* direction,
    const uint32_t* sample, Step step) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  Path p;
  p.alive = false;
  unsigned long long bounces = 0;
  bool drained = false;  // warp-uniform: the counter has passed n
  for (;;) {
    if (!drained) {
      const unsigned free = __ballot_sync(FULL, !p.alive);
      if (free) {
        const int leader = __ffs(free) - 1;
        unsigned long long base = 0;
        if (lane == leader) base = atomicAdd(next, (unsigned long long)__popc(free));
        base = __shfl_sync(FULL, base, leader);
        drained = base + __popc(free) >= (unsigned long long)n;
        const unsigned long long mine = base + refill_rank(free, lane);
        if (!p.alive && mine < (unsigned long long)n)
          p = path_start((int)mine, origin, direction, sample);
      }
    }
    // no live lane: the warp refilled every lane unless the counter has
    // passed n, so the warp is done
    if (!__any_sync(FULL, p.alive)) break;
    if (p.alive) {
      step(p);
      ++bounces;
    }
  }
  return bounces;
}

// kMesh = false compiles the analytic kernel: its mesh tables are a
// constant n = 0, and the sweep drops out of the code (and of the register
// budget) as in the kernels that never take meshes.  kVol / kHg compile the
// participating-media blocks in (pt::bounce); without them the code is the
// vacuum kernel's.  kSurf compiles the surface blocks in.  `next` is the
// persistent schedule's lane counter, zeroed before the launch.
template <bool kMesh, bool kVol, bool kHg, bool kSurf>
__global__ void __launch_bounds__(TRACE_THREADS)
trace_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
             const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
             const float* __restrict__ origin, const float* __restrict__ direction,
             const uint32_t* __restrict__ sample, int n, float* __restrict__ radiance,
             unsigned long long* __restrict__ nrays, unsigned long long* __restrict__ next,
             int max_depth, int nee, int rr, int rr_start, int vol_nee, int surf,
             MeshTables mesh) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  __syncthreads();

  const Tables T{s_g, s_m, s_l, G, scal[0], scal[1] > 0.5f,
                 kMesh ? mesh : MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0},
                 kSurf ? surf : 0};
  const LoopArgs A{seed, max_depth, nee, rr, rr_start, vol_nee};
  const unsigned long long bounces = persistent_paths(
      n, next, origin, direction, sample,
      [&](Path& p) { trace_step<kVol, kHg, kSurf>(T, A, p, radiance); });

  // exact ray count: warp sum, one 64-bit atomic per warp
  unsigned long long c = bounces * (nee ? 2ull : 1ull);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(nrays, c);
}

// the instance of one media case (vacuum, volumetric, volumetric + HG)
template <bool kMesh, bool kSurf>
decltype(&trace_kernel<false, false, false, false>) media_instance(int vol, int hg) {
  return !vol ? trace_kernel<kMesh, false, false, kSurf>
              : (hg ? trace_kernel<kMesh, true, true, kSurf>
                    : trace_kernel<kMesh, true, false, kSurf>);
}

// The blocks of `kernel` resident at once on device `dev`: its SMs times
// the kernel's occupancy at TRACE_THREADS and `smem` bytes of shared
// memory.  Queried once per kernel instance, device and shared-memory size.
int resident_blocks(const void* kernel, int dev, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int cur = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&cur);
  if (cur != dev) cudaSetDevice(dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TRACE_THREADS, smem);
  if (cur != dev) cudaSetDevice(cur);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  known.emplace(key, blocks);
  return blocks;
}

}  // namespace

// nrays, next: the ray count and the persistent schedule's lane counter,
// both zeroed by the caller on the stream; dev: the device of the tensors;
// blocks: the persistent grid's size (0: the blocks resident at once; a
// positive count forces a smaller grid)
extern "C" int trace_launch(const float* gtab, int G, const float* mtab, int M,
                            const float* ltab, const float* scal, unsigned int seed,
                            const float* origin, const float* direction,
                            const unsigned int* sample, int n, float* radiance,
                            unsigned long long* nrays, unsigned long long* next, int max_depth,
                            int nee, int rr, int rr_start, int vol, int hg, int vol_nee, int surf,
                            const float* mtri, const float* maabb, const float* mnorm,
                            const float* muv, const int* mdesc, int n_mesh, int dev, int blocks,
                            void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_depth <= 0)  // no bounce: no radiance, no rays
    return (int)cudaMemsetAsync(radiance, 0, sizeof(float) * 3 * (size_t)n, s);
  const size_t smem = sizeof(float) * (size_t)(G * pt::GCOLS + M * pt::MCOLS + G * pt::LCOLS);
  const pt::MeshTables mesh{mtri, maabb, mnorm, muv, mdesc, n_mesh};
  // the instance: mesh sweep or not x vacuum, volumetric, volumetric + HG x
  // surface blocks or not
  const auto kernel = n_mesh > 0 ? (surf ? media_instance<true, true>(vol, hg)
                                         : media_instance<true, false>(vol, hg))
                                 : (surf ? media_instance<false, true>(vol, hg)
                                         : media_instance<false, false>(vol, hg));
  int grid = blocks > 0 ? blocks : resident_blocks((const void*)kernel, dev, smem);
  const int needed = (n + TRACE_THREADS - 1) / TRACE_THREADS;
  if (grid > needed) grid = needed;
  kernel<<<grid, TRACE_THREADS, smem, s>>>(gtab, G, mtab, M, ltab, scal, seed, origin, direction,
                                           sample, n, radiance, nrays, next, max_depth, nee, rr,
                                           rr_start, vol_nee, surf, mesh);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
