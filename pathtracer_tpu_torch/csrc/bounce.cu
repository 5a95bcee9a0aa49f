// One bounce per launch for Hopper (sm_90a): the per-bounce kernel of the
// wavefront engines.
//
// Replaces the TPU kernel pathtracer_tpu/ops/bounce_pallas.py:_bounce_kernel
// (launched by bounce_fused, :1637), analytic scenes without the optional
// material blocks.  The plain PyTorch version is
// pathtracer_tpu_torch/ops/bounce_fused.py:bounce_fused_plain, which runs
// ops/bounce.py:bounce_physics with a per-lane depth; this file runs the
// same pt::bounce as the trace kernels (trace_common.cuh), in its mask-free
// form, and repeats the plain version's arithmetic in the same order.
//
// Per lane it reads the 16 input planes (origin, direction, throughput,
// sample index, depth, emit state, medium (sigma_a rgb, sigma_s)) and
// writes the 19 outputs: contrib, next origin, next direction, throughput
// multiplier, terminate, emit state, the russian-roulette uniform and the
// medium.  Layout: vectors [N, 3] and the medium [N, 4] row-major, scalars
// [N], terminate as one byte (0/1); the uniforms are the per-lane
// hash_uniforms(seed, sample, depth, 11).  With the hg feature the medium
// is [N, 5]: one more plane in and out, the phase g (bounce_pallas.py:
// 1485-1488, bounce_fused :1661,1737).
//
// Participating media (the volumetric feature): the kVol / kHg instances
// run pt::bounce's media blocks, reading the lane's medium and writing the
// one its continuation travels through; the vacuum instance copies the
// medium through.  The replay variant runs the vacuum and the kVol
// instances (2r-v: the per-bounce differentiable engine's forward in media;
// hg stays on the lean engine, as in JAX).
//
// The emit_replay variant (the forward of the per-bounce differentiable
// engine, pathtracer_tpu/ops/bounce_grad.py:_fused_fwd_call) is the same
// kernel with two optional output pointers, replay_gid and replay_nee: when
// they are not null it also writes the winner geom as a float (-1 on a
// miss) and the NEE bit (1 where the connection counted, else 0), the
// discrete outcomes kernel 3 (csrc/bounce_grad.cu) replays.  Null pointers
// give the 19-output kernel of the wavefront engines.
//
// Output contract: every one of the 19 outputs is defined on every lane
// below n and equals the plain version's bit for bit, terminated lanes
// included: a miss samples material 0's BSDF at t = 1, a light hit its own
// material's, exactly as bounce_physics does (mask-free; the engines gate
// with their alive masks).  Lanes past n read and write nothing.
//
// Triangle meshes (kernel 2 with mesh_tables, bounce_pallas.py:1491-1494,
// 1568-1591, the in-kernel branch): as in trace.cu, a scene whose meshes
// total at most 4096 triangles passes their in-kernel tables, and the
// bounce's nearest hit and shadow ray sweep them.  As in trace.cu the
// kernel is built with and without the sweep and launched by n_mesh.  The
// mesh instances (2m, 2mt) find each lane's nearest triangle before its
// bounce, the whole block together (block_mesh_sweep, below), and hand the
// winner to pt::bounce; the shadow ray's sweep (mesh_occ) stays per lane
// inside it.  The mesh-merge variant for larger meshes is
// csrc/bounce_merge.cu.
//
// Optional surface physics (kernel 2 with the texture, bump, microfacet and
// ward blocks): the kSurf instances run pt::bounce's surface blocks, switched
// on by the feature bits `surf`, as in trace.cu.  The deferred-texel variant
// (bounce_pallas.py:1076-1119, its outputs :1544,1610,1741): a scene with
// image textures passes three more output planes, tex_u, tex_v and
// tex_slot, and the kTex instance writes the hit's texture-scaled UV (from
// JAX's polynomial atan2) and the atlas slot of an image-textured surface
// event, -1 elsewhere; the wrapper (ops/bounce_fused.py) fetches the
// bilinear texel and multiplies it into contrib and, on diffuse events, the
// throughput multiplier (:1772-1793).  The atlas stays outside the kernel,
// as on the TPU.  kTex is built with kSurf, with and without the in-kernel
// meshes (kernel 2mt: the mesh sweep also blends the winner's authored UV,
// and a mesh lane takes the box map of its object-space normal).
//
// Design: one thread per lane; the geom / material / light tables are
// copied once per block into shared memory and indexed by id (the TPU
// kernel's where-chains over every row become gathers with the same
// semantics, as in trace.cu).  Built with -fmad=false and without fast
// math, so it rounds as the op-by-op plain version does.
//
// What bounds it on the H100: bytes, on paper.  A lane moves 137 B (16
// four-byte planes in, 18 four-byte planes and one byte out), 87.7 MB per
// 640,000-lane launch, 0.026 ms at 3.35 TB/s; its counted operations (the
// sweep over the geoms and one shading, as one bounce of trace.cu) take
// about a third of that at the fp32 peak.  Measured by chip_smoke.py on an
// H100 80GB HBM3 at 700 W, a launch on the state of a mid-render super-step
// takes about 4x that bound: the lanes of a warp sit at different depths
// and materials, and the transcendental functions and the shadow sweeps
// are not counted.  Its time does not follow the share of lanes that hold
// a live path: 0.095-0.101 ms per launch of the replay variant at every
// bounce of the per-bounce scan of Cornell's 640,000 primary rays, from
// all of them alive to 34% (PERF.md, section 6).  A lane whose path ended
// re-runs the miss or the light hit that ended it, in step with its warp's
// live lanes and without shading, so it costs its warp nothing.  Three
// schedules that leave such lanes out were measured slower and are not
// kept: an alive plane whose dead lanes exit early (their branch diverges
// from the live lanes'), live lanes gathered into full warps across a span
// of 32 to 256 lanes (the gathered lanes load scattered planes, and a warp
// runs its batches one after another), and live lanes ordered first by two
// short kernels.
//
// The mesh instances spent most of a launch in the nearest-hit sweep: on
// smooth_mesh's super-step 10 (262,144 lanes, 10 chunks of 32 triangles)
// 0.16 ms against 0.034 for the same lanes without the meshes, on a
// 4,050-triangle vt grid (127 chunks) 0.55 ms against 0.04, though 3% of
// its lanes reach a chunk box.  A lane that grazes the grid reaches up to
// all 127 chunks and tests their 4,064 triangles one after another while
// its warp waits.  The block sweep shares each reaching lane's 32 tests of
// a chunk out over a warp: 2m 0.145-0.149 ms, 2mt 0.289-0.296 (PERF.md,
// section 6).  Lanes ordered by the first chunk their ray reaches (a key
// pass and lane_order's two kernels first) cut the chunks a warp sweeps
// fourfold but took 0.018 / 0.069 ms to order and were slower in every
// combination, so the lanes stay in index order.  What the grid has left is
// the blocks whose lanes all graze it: their tests are shared within the
// block, not across blocks.
//
// The media and surface instances: after its nearest hit a lane takes one
// of a few events, each with its own cost (the path ends; a surface event,
// with the NEE shadow sweep on a diffuse lobe; an in-medium scatter, with
// volumetric NEE's split sweep), and a warp runs every event its lanes
// take, one after another.  On milky's per-bounce step (2r-v, 640,000
// lanes) 95-98% of warps hold more than one event, and its two shadow
// sweeps are 40% of its 0.113 ms; on a pinned render's super-step 90-98% of
// the lanes end, and a launch of 2v, 2hg, 2s or 2t sits 1.25-1.35x above
// the same lanes' loads and stores alone (PERF.md, section 6).  So only
// 2r-v groups its lanes (bounce_kernel_grouped), on every bounce: each
// block of 128 lanes sweeps each lane's nearest hit, ranks its lanes by
// the event that hit gives (trace_common.cuh:event_key; a stable counting
// sort, block_rank), puts each lane's state in the slot of its rank in
// shared-memory planes, and shades slot s on thread s, storing every
// output at the lane's own index; a scatter lane skips the BSDF sample no
// output of it reads.  Each lane's arithmetic is the one-lane-per-thread
// instance's, so the outputs are the same bits.  2r-v took 0.107 ms per
// launch of milky's step against the one-lane instance's 0.113: 6-7%
// slower on the first two bounces (nearly every lane alive), 4-11% faster
// from the fourth, as a block's ended lanes gather into warps that finish
// at once (PERF.md, section 6).  Grouping the other instances, the outputs
// staged in shared memory and stored in index order, a resident-sized grid
// whose blocks walk the tiles of lanes, a block shading in place when each
// warp holds one event, and planes that keep only the winner (phase 2
// loading the lane again) were each measured slower, blocks of 256 no
// faster (PERF.md, section 6).

#include "bounce_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

using namespace pt;

constexpr int THREADS = 128;

// The mesh instances' nearest-triangle sweep, one block at a time: every
// lane of the block walks the chunks of every mesh in order and tests the
// box against its own running best (as mesh_sweep does); a chunk that no
// lane of the block reaches is skipped by all of them; otherwise its 32
// triangles are staged in shared memory, the reaching lanes are listed, and
// each warp takes a listed lane and tests its ray against the 32 triangles
// at once, one per thread, the first minimum found by a shuffle reduction.
// So a lane that reaches many chunks shares its triangle tests with the
// block's other threads instead of testing them one after another.  A lane
// takes the chunk's first minimum where it is below its best, as
// mesh_sweep's strict update in row order does, so the winner is the same.
// Every thread of the block calls it (valid false past n).
constexpr int SWEEP_FLOATS = 6 * THREADS + 9 * MESH_CHUNK + 5 * THREADS;

template <bool kUV>
__device__ MeshHit block_mesh_sweep(const float* g_tab, const MeshTables& M, V3 o, V3 d,
                                    bool valid, float* scratch) {
  constexpr unsigned FULL = 0xffffffffu;
  float* ray = scratch;                   // [6][THREADS]: object-space origin, direction
  float* stage = ray + 6 * THREADS;       // [MESH_CHUNK][9]: v0, e1, e2 of the chunk's rows
  float* hit_t = stage + 9 * MESH_CHUNK;  // [THREADS] per listed lane: the chunk's first minimum
  float* hit_u = hit_t + THREADS;
  float* hit_v = hit_u + THREADS;
  int* hit_j = reinterpret_cast<int*>(hit_v + THREADS);
  int* list = hit_j + THREADS;  // the lanes that reach the chunk, in no fixed order
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  SweepBest s;
  for (int k = 0; k < M.n; ++k) {
    const int* ds = M.desc + MESH_DESC * k;
    V3 oo, od;
    to_object(g_tab + ds[0] * GCOLS, o, d, oo, od);
    const V3 inv = v3(safe_recip(od.x), safe_recip(od.y), safe_recip(od.z));
    const float mine[6] = {oo.x, oo.y, oo.z, od.x, od.y, od.z};
    for (int f = 0; f < 6; ++f) ray[f * THREADS + tid] = mine[f];
    for (int c = ds[2]; c < ds[2] + ds[1]; ++c) {
      const bool reach = valid && chunk_reaches(M.aabb + 6 * c, oo, inv, s.best);
      if (tid == 0) s_count = 0;
      if (__syncthreads_count(reach) == 0) continue;
      const unsigned b = __ballot_sync(FULL, reach);
      int base = 0;
      if (lane == 0 && b != 0) base = atomicAdd(&s_count, __popc(b));
      base = __shfl_sync(FULL, base, 0);
      if (reach) list[base + __popc(b & ((1u << lane) - 1u))] = tid;
      for (int f = tid; f < 9 * MESH_CHUNK; f += THREADS)
        stage[f] = M.tri[12 * (c * MESH_CHUNK + f / 9) + f % 9];
      __syncthreads();
      const int count = s_count;
      for (int r = warp; r < count; r += THREADS / 32) {
        const int L = list[r];
        const V3 ro = v3(ray[L], ray[THREADS + L], ray[2 * THREADS + L]);
        const V3 rd = v3(ray[3 * THREADS + L], ray[4 * THREADS + L], ray[5 * THREADS + L]);
        float u, v;
        const float t = mt_tri(stage + 9 * lane, ro, rd, u, v);
        float m = t;
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
        const int j = __ffs(__ballot_sync(FULL, t == m)) - 1;
        if (lane == j) {
          hit_t[L] = m;
          hit_u[L] = u;
          hit_v[L] = v;
          hit_j[L] = j;
        }
      }
      __syncthreads();
      if (reach)
        sweep_take<kUV>(s, k, ds, c * MESH_CHUNK + hit_j[tid], hit_t[tid], hit_u[tid],
                        hit_v[tid]);
    }
  }
  return mesh_hit<kUV>(g_tab, M, o, d, s);
}

// kMesh = false compiles the analytic kernel: its mesh tables are a
// constant n = 0, and the sweep drops out of the code (and of the register
// budget) as in the kernels that never take meshes.  kVol / kHg compile the
// participating-media blocks in, kSurf the surface blocks, as in trace.cu;
// kTex writes the deferred texel's planes.
template <bool kMesh, bool kVol, bool kHg, bool kSurf, bool kTex>
__global__ void __launch_bounds__(THREADS)
bounce_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
              const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
              int nee, int n, const float* __restrict__ origin,
              const float* __restrict__ direction, const float* __restrict__ thr,
              const uint32_t* __restrict__ sample, const int32_t* __restrict__ depth,
              const float* __restrict__ prev, const float* __restrict__ medium,
              float* __restrict__ contrib, float* __restrict__ next_o,
              float* __restrict__ next_d, float* __restrict__ thr_mult,
              uint8_t* __restrict__ terminate, float* __restrict__ wspec,
              float* __restrict__ rru, float* __restrict__ out_medium,
              float* __restrict__ replay_gid, float* __restrict__ replay_nee, int vol_nee,
              int mw, int surf, float* __restrict__ tex_u, float* __restrict__ tex_v,
              float* __restrict__ tex_slot, MeshTables mesh) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < n;
  const int idx = valid ? t : 0;
  const Tables T{s_g, s_m, s_l, G, scal[0], scal[1] > 0.5f,
                 kMesh ? mesh : MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0},
                 kSurf ? surf : 0};
  MeshHit pre{};
  if constexpr (kMesh) {  // the block's sweep first, every thread of it
    const V3 o = v3(origin[3 * idx], origin[3 * idx + 1], origin[3 * idx + 2]);
    const V3 d = v3(direction[3 * idx], direction[3 * idx + 1], direction[3 * idx + 2]);
    pre = block_mesh_sweep<kTex>(s_g, mesh, o, d, valid, s_l + G * LCOLS);
  }
  if (!valid) return;
  bounce_lane<kVol, kHg, kSurf, kTex>(T, seed, nee, vol_nee, mw, (size_t)idx, origin, direction,
                                      thr, sample, depth, prev, medium, contrib, next_o, next_d,
                                      thr_mult, terminate, wspec, rru, out_medium, replay_gid,
                                      replay_nee, tex_u, tex_v, tex_slot, nullptr, nullptr,
                                      nullptr, 0, kMesh ? &pre : nullptr);
}

// Kernel 2's replay variant in media (2r-v: kVol with the replay planes,
// no hg, no surface features, no meshes), whose lanes of one warp take
// different events after their nearest hit: each block of GROUP_THREADS
// lanes sweeps each lane's nearest hit (lane_sweep), orders its lanes by
// the event that hit gives through the lane planes in shared memory
// (block_rank, planes_put), and shades slot s on thread s (slot_get,
// lane_shade), each output stored at the lane's own index.  Held to the
// one-lane-per-thread instance's 6 resident blocks of 128 lanes per SM
// (80 registers).
constexpr int GROUP_THREADS = 128;
constexpr int GROUP_BLOCKS = 6 * 128 / GROUP_THREADS;
// the block's shared memory beside the tables: the event counts
// (EVENT_KEYS + 1 keys, one column per warp) and the lane planes
constexpr int GROUP_WORDS =
    (EVENT_KEYS + 1) * (GROUP_THREADS / 32) + (LP_FLOATS + LP_INTS) * GROUP_THREADS;

// Each lane's rank in the block when its lanes are ordered by key, ties in
// thread order (a stable counting sort): every thread of the block calls it
// with its key (0 <= key <= EVENT_KEYS); cnt holds (EVENT_KEYS + 1) x warps
// ints, zeroed before the block's first barrier.  Each warp counts its keys
// with one match, and warp 0 turns the counts into the offsets of each
// (key, warp) group.
template <int NT>
__device__ int block_rank(int key, int* cnt) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int W = NT / 32;
  static_assert(EVENT_KEYS < 32, "one lane of warp 0 per key");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned peers = __match_any_sync(FULL, key);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (below == 0) cnt[key * W + warp] = __popc(peers);
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    if (lane <= EVENT_KEYS)
      for (int w = 0; w < W; ++w) {
        const int c = cnt[lane * W + w];
        cnt[lane * W + w] = total;
        total += c;
      }
    int incl = total;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane <= EVENT_KEYS)
      for (int w = 0; w < W; ++w) cnt[lane * W + w] += incl - total;
  }
  __syncthreads();
  return cnt[key * W + warp] + below;
}

__global__ void __launch_bounds__(GROUP_THREADS, GROUP_BLOCKS)
bounce_kernel_grouped(const float* __restrict__ gtab, int G, const float* __restrict__ mtab,
                      int M, const float* __restrict__ ltab, const float* __restrict__ scal,
                      uint32_t seed, int nee, int n, const float* __restrict__ origin,
                      const float* __restrict__ direction, const float* __restrict__ thr,
                      const uint32_t* __restrict__ sample, const int32_t* __restrict__ depth,
                      const float* __restrict__ prev, const float* __restrict__ medium,
                      float* __restrict__ contrib, float* __restrict__ next_o,
                      float* __restrict__ next_d, float* __restrict__ thr_mult,
                      uint8_t* __restrict__ terminate, float* __restrict__ wspec,
                      float* __restrict__ rru, float* __restrict__ out_medium,
                      float* __restrict__ replay_gid, float* __restrict__ replay_nee,
                      int vol_nee, int mw) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  int* s_cnt = reinterpret_cast<int*>(s_l + G * LCOLS);
  float* f = reinterpret_cast<float*>(s_cnt + (EVENT_KEYS + 1) * (GROUP_THREADS / 32));
  const LanePlanes P{f, reinterpret_cast<int*>(f + LP_FLOATS * GROUP_THREADS), GROUP_THREADS};
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  for (int i = threadIdx.x; i < (EVENT_KEYS + 1) * (GROUP_THREADS / 32); i += blockDim.x)
    s_cnt[i] = 0;
  __syncthreads();

  const int first = blockIdx.x * GROUP_THREADS, tid = threadIdx.x;
  const int lanes = n - first < GROUP_THREADS ? n - first : GROUP_THREADS;
  const Tables T{s_g, s_m, s_l, G, scal[0], scal[1] > 0.5f,
                 MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0}, 0};
  LaneIn L{};
  Nearest h{};
  const int key = tid < lanes ? lane_sweep(T, seed, mw, (size_t)(first + tid), origin, direction,
                                           thr, sample, depth, prev, medium, L, h)
                              : EVENT_KEYS;  // past n: last
  const int rank = block_rank<GROUP_THREADS>(key, s_cnt);
  if (tid < lanes) planes_put(P, rank, (size_t)(first + tid), L, h);
  __syncthreads();
  if (tid < lanes) {
    const size_t i = slot_get(P, tid, L, h);
    lane_shade(T, L, h, i, nee, vol_nee, mw, contrib, next_o, next_d, thr_mult, terminate, wspec,
               rru, out_medium, replay_gid, replay_nee);
  }
}

// the instance of one media case (vacuum, volumetric, volumetric + HG)
template <bool kMesh, bool kSurf, bool kTex>
decltype(&bounce_kernel<false, false, false, false, false>) media_instance(int vol, int hg) {
  return !vol ? bounce_kernel<kMesh, false, false, kSurf, kTex>
              : (hg ? bounce_kernel<kMesh, true, true, kSurf, kTex>
                    : bounce_kernel<kMesh, true, false, kSurf, kTex>);
}

}  // namespace

// tex_u / tex_v / tex_slot not null: the deferred-texel variant (with surf;
// the wrapper checks it), with n_mesh > 0 kernel 2mt; 2r-v (the replay
// planes in media, nothing else) takes the grouped kernel
extern "C" int bounce_launch(const float* gtab, int G, const float* mtab, int M,
                             const float* ltab, const float* scal, unsigned int seed, int nee,
                             int n, const float* origin, const float* direction,
                             const float* thr, const unsigned int* sample, const int* depth,
                             const float* prev, const float* medium, float* contrib,
                             float* next_o, float* next_d, float* thr_mult,
                             unsigned char* terminate, float* wspec, float* rru,
                             float* out_medium, float* replay_gid, float* replay_nee, int vol,
                             int hg, int vol_nee, int mw, int surf, float* tex_u, float* tex_v,
                             float* tex_slot, const float* mtri, const float* maabb,
                             const float* mnorm, const float* muv, const int* mdesc, int n_mesh,
                             void* stream) {
  if (n <= 0) return 0;
  const size_t tables = (size_t)(G * GCOLS + M * MCOLS + G * LCOLS);
  if (replay_gid != nullptr && vol && !hg && !surf && tex_u == nullptr && n_mesh == 0) {
    bounce_kernel_grouped<<<(n + GROUP_THREADS - 1) / GROUP_THREADS, GROUP_THREADS,
           sizeof(float) * (tables + GROUP_WORDS), (cudaStream_t)stream>>>(
            gtab, G, mtab, M, ltab, scal, seed, nee, n, origin, direction, thr, sample, depth,
            prev, medium, contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium,
            replay_gid, replay_nee, vol_nee, mw);
    return (int)cudaGetLastError();
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  // the tables, and for the mesh instances the block sweep's scratch
  const size_t smem = sizeof(float) * (tables + (n_mesh > 0 ? SWEEP_FLOATS : 0));
  const MeshTables mesh{mtri, maabb, mnorm, muv, mdesc, n_mesh};
  // the instance: mesh sweep or not x media x surface blocks or not, and the
  // deferred texel
  const bool tex = tex_u != nullptr;
  decltype(&bounce_kernel<false, false, false, false, false>) kernel;
  if (tex)
    kernel = n_mesh > 0 ? media_instance<true, true, true>(vol, hg)
                        : media_instance<false, true, true>(vol, hg);
  else if (n_mesh > 0)
    kernel = surf ? media_instance<true, true, false>(vol, hg)
                  : media_instance<true, false, false>(vol, hg);
  else
    kernel = surf ? media_instance<false, true, false>(vol, hg)
                  : media_instance<false, false, false>(vol, hg);
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, nee, n, origin, direction, thr, sample, depth, prev,
      medium, contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium, replay_gid,
      replay_nee, vol_nee, mw, surf, tex_u, tex_v, tex_slot, mesh);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
