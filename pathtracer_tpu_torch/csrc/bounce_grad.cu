// The backward of one bounce for Hopper (sm_90a): the per-bounce
// differentiable engine's reverse kernel.
//
// Replaces the TPU kernel pathtracer_tpu/ops/bounce_grad.py:_bounce_bwd_kernel
// (launched by _fused_bwd_call, :260), the backward of bounce_fused_diff for
// analytic scenes.  Its forward is kernel 2's emit_replay variant
// (csrc/bounce.cu with the replay pointers set).  The plain PyTorch version
// is pathtracer_tpu_torch/ops/bounce_grad.py:bounce_bwd_plain:
// torch.autograd of ops/bounce.py:bounce_physics(replay=...) for one bounce.
//
// Per lane it reads 14 input planes (origin, direction, throughput, sample
// index, depth, emit state, and the forward's replay planes: winner geom as
// a float, -1 on a miss, and the NEE bit) and the cotangents of the four
// differentiable outputs (contrib, next origin, next direction, throughput
// multiplier), runs bounce_adj.cuh's physics_adj (the adjoint kernel 5 runs
// too) in double at the float forward's recomputed values, and writes
// d_origin, d_direction and d_throughput ([N, 3] each).  No sweep and no
// shadow ray run: the winner and the NEE bit are replayed, since both are
// comparisons and carry no cotangent.  In vacuum the medium passes through
// the bounce unchanged, so its cotangent passes through in the wrapper and
// the vacuum instance neither reads nor writes medium planes.  The kVol
// instance (kernel 3v, participating media; its forward is kernel 2's kVol
// instance with the replay planes, 2r-v) takes JAX's plane set
// (bounce_grad.py:97-117): the medium [N, 4] (sigma_a rgb, sigma_s) and the
// cotangent of the medium entered [N, 4] in, the medium's cotangent [N, 4]
// out, and runs bounce_adj.cuh's physics_adj_vol (the free path, the
// in-medium scatter, the attenuation, the medium switch and the volumetric
// NEE with its split sweep run again in float), which kernel 5v runs too.
// The kSurf instance (kernel 3s, the optional surface physics; its forward
// is kernel 2's kSurf instance with the replay planes, 2r-s) takes the
// surface feature bits `surf` and runs physics_adj<kSurf> (the texture's
// albedo columns, the bump, the Cook-Torrance and Ward lobes), as kernel 5s
// does; kVol x kSurf is the same template.
//
// Output contract: mask-free, as kernel 2's.  For any cotangents on any
// lane, misses and light hits included, the outputs are the adjoint of the
// bounce kernel 2 computed on that lane: a miss differentiates p = o + d and
// material 0's BSDF at the zero normal, a light hit its counted emission and
// its own material's BSDF.  Zero cotangents give exact zeros.  Lanes past n
// read and write nothing.
//
// Table cotangents: the row of K = 14 G + 28 M + 19 G + 2 floats (495 for
// Cornell) that autograd of ops/bounce.py:pack_tables carries to the scene.
// Each block zeroes its own row of `partial` (device memory) and its lanes
// add their cotangents there with float atomics (no fixed order within a
// block); bounce_adj.cuh's row_sum then adds the rows in a fixed tree
// spread over 32-column tiles and 64-row segments (two short launches; one
// thread per column over all 5,000 rows took 0.16 ms at 640,000 lanes).
// The TPU kernel accumulated into one SMEM row across its sequential grid;
// on the GPU the blocks run at once.
//
// Design: one thread per lane, the tables in shared memory, the adjoint in
// registers; a lane whose cotangents are all zero writes zeros and skips the
// adjoint.  What bounds it on the H100: bytes, on paper (140 B per lane: 23
// four-byte planes in, 9 out; 89.6 MB per 640,000-lane launch, 0.027 ms at
// 3.35 TB/s), but its adjoint is several times a bounce's shading
// arithmetic in double, and a live lane issues up to 59 float atomics, most
// of them to the same addresses as its warp's other lanes: every lane adds
// to its winner's geom row (the transform's 12 columns) and material row,
// and neighbouring pixels share a winner.  So in 3 and 3s each lane sums
// those 40 columns in double in shared memory (bounce_adj.cuh's RowSums),
// and after the lane its warp adds each column once, a shuffle sum in a
// fixed order, where all its lanes share the winner (else each lane adds
// its own): 3 on Cornell from 0.256 to 0.200 ms per launch in the
// per-bounce step, at 152 registers (158 before).  3v keeps every atomic:
// the sums took it to 180 registers, two blocks per SM, and slower.  3s
// first orders its lanes by the branch their adjoint takes (bounce_bwd_key,
// two short kernels of bounce_adj.cuh:lane_order, thread t on lane
// order[t]): its Cook-Torrance and Ward lobes otherwise make a warp run the
// union of its lanes' branches (in ward's step 0.047 + 0.015 ms of order
// against 0.076).  On 3 and 3v the order measured slower: their warps
// already hold neighbouring pixels on one surface, and ordered lanes load
// scattered planes.  Per-lane sums of NEE's light columns (kernel 5's
// LaneSums) measured slower on 3 and 3s beside the row sums, and within 3%
// either way without them.  A resident-sized grid, warp-aggregated atomics
// per call site, a per-atomic zero skip and __launch_bounds__(128, 4) were
// measured before and left out (PERF.md, section 6).  chip_smoke.py
// measures the body and the row sum apart.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "bounce_adj.cuh"

namespace pt {

// whether every cotangent of lane i is zero (with kVol the medium's too)
template <bool kVol>
PT_FN bool cotangents_zero(const float* __restrict__ g_contrib, const float* __restrict__ g_next_o,
                           const float* __restrict__ g_next_d,
                           const float* __restrict__ g_thr_mult,
                           const float* __restrict__ g_medium, size_t i) {
  bool zero = true;
  const float* cot[4] = {g_contrib, g_next_o, g_next_d, g_thr_mult};
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c) zero = zero && cot[k][3 * i + c] == 0.0f;
  if constexpr (kVol)
    for (int c = 0; c < 4; ++c) zero = zero && g_medium[4 * i + c] == 0.0f;
  return zero;
}

// one lane of kernel 3 (kVol: 3v, kSurf: 3s); also compiled as host C++ by
// tests/kernel_host_harness.cpp.  The table cotangents go to acc: the
// block's row, or its RowSums (the slots zeroed by the caller, who adds them
// to the row after the lane; the lane sets their winner rows).
template <bool kVol = false, bool kSurf = false, typename Acc = float*>
PT_FN void bounce_bwd_lane(const Tables& T, const RowLayout& R, uint32_t seed, int nee, size_t i,
                           const float* __restrict__ origin, const float* __restrict__ direction,
                           const float* __restrict__ thr, const uint32_t* __restrict__ sample,
                           const int32_t* __restrict__ depth, const float* __restrict__ prev,
                           const float* __restrict__ replay_gid,
                           const float* __restrict__ replay_nee,
                           const float* __restrict__ g_contrib, const float* __restrict__ g_next_o,
                           const float* __restrict__ g_next_d,
                           const float* __restrict__ g_thr_mult, float* __restrict__ d_origin,
                           float* __restrict__ d_direction, float* __restrict__ d_thr,
                           Acc& acc, int vol_nee = 1,
                           const float* __restrict__ medium = nullptr,
                           const float* __restrict__ g_medium = nullptr,
                           float* __restrict__ d_medium = nullptr) {
  // A lane whose cotangents are all zero (in the per-bounce engine, a lane
  // that died at an earlier bounce) has exact zeros for its adjoint and adds
  // nothing to the tables: it writes the zeros and skips the rest, as
  // kernel 5 skips a dead bounce.
  if (cotangents_zero<kVol>(g_contrib, g_next_o, g_next_d, g_thr_mult, g_medium, i)) {
    float* out[3] = {d_origin, d_direction, d_thr};
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c) out[k][3 * i + c] = 0.0f;
    if constexpr (kVol)
      for (int c = 0; c < 4; ++c) d_medium[4 * i + c] = 0.0f;
    return;
  }
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  const V3 t = v3(thr[3 * i], thr[3 * i + 1], thr[3 * i + 2]);
  const int dep = depth[i];
  const uint32_t base = bounce_base(seed, sample[i] * 0x85EBCA6Bu, dep);
  const Replay r = replay_bounce(T, o, d, (int)replay_gid[i]);
  row_owner(acc, R, r.gc, r.mid);
  const D3 gc = d3(g_contrib[3 * i], g_contrib[3 * i + 1], g_contrib[3 * i + 2]);
  const D3 gno = d3(g_next_o[3 * i], g_next_o[3 * i + 1], g_next_o[3 * i + 2]);
  const D3 gnd = d3(g_next_d[3 * i], g_next_d[3 * i + 1], g_next_d[3 * i + 2]);
  const D3 gtm = d3(g_thr_mult[3 * i], g_thr_mult[3 * i + 1], g_thr_mult[3 * i + 2]);
  D3 g_o = d3(0.0, 0.0, 0.0), g_d = g_o, g_t = g_o;
  if constexpr (kVol) {
    const float* mi = medium + 4 * i;
    const float* gm = g_medium + 4 * i;
    const Medium med{v3(mi[0], mi[1], mi[2]), mi[3], 0.0f};
    D3 g_sa = g_o;
    AD g_ss = 0.0;
    physics_adj_vol<kSurf>(T, R, r, vol_bounce<kSurf>(T, r, base, d, med), base, dep, nee,
                           vol_nee, o, d, t, med, prev[i], replay_nee[i] > 0.5f, true, gc, gno,
                           gnd, gtm, d3(gm[0], gm[1], gm[2]), gm[3], g_o, g_d, g_t, g_sa, g_ss,
                           acc);
    float* dm = d_medium + 4 * i;
    dm[0] = (float)g_sa.x;
    dm[1] = (float)g_sa.y;
    dm[2] = (float)g_sa.z;
    dm[3] = (float)g_ss;
  } else {
    physics_adj<kSurf>(T, R, r, base, dep, nee, o, d, t, prev[i], replay_nee[i] > 0.5f, gc, gno,
                       gnd, gtm, g_o, g_d, g_t, acc);
  }
  const D3* vec[3] = {&g_o, &g_d, &g_t};
  float* out[3] = {d_origin, d_direction, d_thr};
  for (int k = 0; k < 3; ++k) {
    out[k][3 * i] = (float)vec[k]->x;
    out[k][3 * i + 1] = (float)vec[k]->y;
    out[k][3 * i + 2] = (float)vec[k]->z;
  }
}

// ---- the lane order of kernel 3s ------------------------------------------

// A lane's key: the branch its adjoint takes, known before the launch from
// the forward's replay planes, the tables and the cotangents.  A miss, a
// light hit, a diffuse hit with its NEE connection, one without, a mirror or
// glossy surface, a Cook-Torrance or Ward one, glass.  A lane whose
// cotangents are all zero takes the largest key: those lanes run last, in
// whole warps that write zeros.
constexpr int KEY_MISS = 0, KEY_LIGHT = 1, KEY_NEE = 2, KEY_DIFFUSE = 3, KEY_MIRROR = 4,
              KEY_LOBE = 5, KEY_GLASS = 6, KEY_ZERO = ORDER_KEYS - 1;

// what a lane's key reads
struct BwdKeyIn {
  const float* gtab;
  const float* mtab;
  const float* replay_gid;
  const float* replay_nee;
  const float* g_contrib;
  const float* g_next_o;
  const float* g_next_d;
  const float* g_thr_mult;
};

PT_FN int bounce_bwd_key(const BwdKeyIn& k, size_t i) {
  if (cotangents_zero<false>(k.g_contrib, k.g_next_o, k.g_next_d, k.g_thr_mult, nullptr, i))
    return KEY_ZERO;
  const int gid = (int)k.replay_gid[i];
  if (gid < 0) return KEY_MISS;
  const float* mat = k.mtab + (int)k.gtab[gid * GCOLS + 13] * MCOLS;
  if (mat[9] > 0.0f) return KEY_LIGHT;
  if (mat[7] > 0.0f) return KEY_GLASS;
  if (mat[6] > 0.0f) return mat[24] > 0.5f ? KEY_LOBE : KEY_MIRROR;
  return k.replay_nee[i] > 0.5f ? KEY_NEE : KEY_DIFFUSE;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int THREADS = 128;

// The instances that sum their winner's geom and material rows per lane and
// once per warp (bounce_adj.cuh's RowSums): 3 and 3s.  3v's 167 registers
// rose to 180 with them, two blocks per SM: slower.
template <bool kVol, bool kSurf>
constexpr bool BWD_ROWS_ON = !kVol;
// The instance that orders its lanes by key (bounce_bwd_key): 3s, whose
// lobes diverge.  3 and 3v run their lanes in index order: neighbouring
// pixels share a winner, so a warp's loads stay coalesced and its row sums
// warp-uniform.
template <bool kVol, bool kSurf>
constexpr bool ORDER_ON = kSurf && !kVol;

template <bool kVol, bool kSurf>
__global__ void __launch_bounds__(THREADS)
bounce_bwd_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                  const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
                  int nee, int n, const float* __restrict__ origin,
                  const float* __restrict__ direction, const float* __restrict__ thr,
                  const uint32_t* __restrict__ sample, const int32_t* __restrict__ depth,
                  const float* __restrict__ prev, const float* __restrict__ replay_gid,
                  const float* __restrict__ replay_nee, const float* __restrict__ g_contrib,
                  const float* __restrict__ g_next_o, const float* __restrict__ g_next_d,
                  const float* __restrict__ g_thr_mult, float* __restrict__ d_origin,
                  float* __restrict__ d_direction, float* __restrict__ d_thr,
                  float* __restrict__ partial, int vol_nee, int surf,
                  const float* __restrict__ medium, const float* __restrict__ g_medium,
                  float* __restrict__ d_medium, const int* __restrict__ order) {
  extern __shared__ float smem[];
  const RowLayout R = row_layout(G, M);
  // the block's table row is its row of `partial`, in device memory: the
  // lanes' float atomics there are reductions resolved in L2, about twice
  // as fast here as the same atomics into a shared-memory row
  float* acc = partial + (size_t)blockIdx.x * R.k;
  load_tables(smem, gtab, G, mtab, M, ltab);
  for (int i = threadIdx.x; i < R.k; i += blockDim.x) acc[i] = 0.0f;
  // each thread's row sums, slot k at [k * THREADS + thread], after the tables
  constexpr bool kRows = BWD_ROWS_ON<kVol, kSurf>;
  RowSums rs{acc, reinterpret_cast<AD*>(smem + sums_offset(G, M)) + threadIdx.x, THREADS,
             ROW_NONE, ROW_NONE};
  if constexpr (kRows)
    for (int k = 0; k < ROW_SUMS; ++k) rs.s[k * THREADS] = 0.0;
  __syncthreads();
  const Tables T{smem, smem + G * GCOLS, smem + G * GCOLS + M * MCOLS, G, scal[0],
                 scal[1] > 0.5f, MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0},
                 kSurf ? surf : 0};

  // thread t takes lane order[t] where the launch orders its lanes
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int idx = order != nullptr && t < n ? order[t] : t;
  if (idx < n) {  // lanes past n contribute nothing
    if constexpr (kRows)
      bounce_bwd_lane<kVol, kSurf>(T, R, seed, nee, (size_t)idx, origin, direction, thr, sample,
                                   depth, prev, replay_gid, replay_nee, g_contrib, g_next_o,
                                   g_next_d, g_thr_mult, d_origin, d_direction, d_thr, rs,
                                   vol_nee, medium, g_medium, d_medium);
    else
      bounce_bwd_lane<kVol, kSurf>(T, R, seed, nee, (size_t)idx, origin, direction, thr, sample,
                                   depth, prev, replay_gid, replay_nee, g_contrib, g_next_o,
                                   g_next_d, g_thr_mult, d_origin, d_direction, d_thr, acc,
                                   vol_nee, medium, g_medium, d_medium);
  }
  // every thread of the warp, past n or on a lane that added nothing too
  if constexpr (kRows) warp_row_sums_add(rs);
}

// a lane's key for the lane order (bounce_adj.cuh:lane_order)
struct BwdKey {
  BwdKeyIn in;
  __device__ int operator()(size_t i) const { return bounce_bwd_key(in, i); }
};

// whether the instance (vol, surf) orders its lanes, and keeps row sums
bool ordered_instance(int vol, int surf) {
  return vol ? (surf ? ORDER_ON<true, true> : ORDER_ON<true, false>)
             : (surf ? ORDER_ON<false, true> : ORDER_ON<false, false>);
}

bool rows_instance(int vol, int surf) {
  return vol ? (surf ? BWD_ROWS_ON<true, true> : BWD_ROWS_ON<true, false>)
             : (surf ? BWD_ROWS_ON<false, true> : BWD_ROWS_ON<false, false>);
}

}  // namespace

// the rows of `partial` that bounce_bwd_launch needs for n lanes: one per
// block and the row sum's scratch
extern "C" int bounce_bwd_rows(int n) {
  const int blocks = (n + THREADS - 1) / THREADS;
  return blocks > 0 ? blocks + row_sum_scratch(blocks) : 1;
}

// the ints of order scratch that bounce_bwd_launch needs for n lanes of the
// instance (vol, surf): 0 where it runs its lanes in index order
extern "C" int bounce_bwd_order_ints(int n, int vol, int surf) {
  return ordered_instance(vol, surf) ? lane_order_ints(n > 0 ? n : 1) : 0;
}

// order_scratch: bounce_bwd_order_ints(n, vol, surf) ints for the lane order
// of the instances that order theirs, or null for the lanes in index order
// (one thread per lane, thread t on lane t)
extern "C" int bounce_bwd_launch(const float* gtab, int G, const float* mtab, int M,
                                 const float* ltab, const float* scal, unsigned int seed, int nee,
                                 int n, const float* origin, const float* direction,
                                 const float* thr, const unsigned int* sample, const int* depth,
                                 const float* prev, const float* replay_gid,
                                 const float* replay_nee, const float* g_contrib,
                                 const float* g_next_o, const float* g_next_d,
                                 const float* g_thr_mult, float* d_origin, float* d_direction,
                                 float* d_thr, float* partial, float* row, int vol, int vol_nee,
                                 int surf, const float* medium, const float* g_medium,
                                 float* d_medium, int* order_scratch, void* stream) {
  const RowLayout R = row_layout(G, M);
  const int blocks = (n + THREADS - 1) / THREADS;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaMemsetAsync(row, 0, sizeof(float) * R.k, s);
  // the tables, and the row sums of the instances that keep them
  const size_t smem = sizeof(float) * (rows_instance(vol, surf)
                                           ? sums_offset(G, M) + 2 * (size_t)ROW_SUMS * THREADS
                                           : table_floats(G, M));
  // the instance: vacuum or volumetric x surface blocks or not
  const auto kernel =
      vol ? (surf ? bounce_bwd_kernel<true, true> : bounce_bwd_kernel<true, false>)
          : (surf ? bounce_bwd_kernel<false, true> : bounce_bwd_kernel<false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int* order = nullptr;
  if (order_scratch != nullptr && ordered_instance(vol, surf)) {
    const BwdKeyIn in{gtab,     mtab,     replay_gid, replay_nee,
                      g_contrib, g_next_o, g_next_d,  g_thr_mult};
    const cudaError_t e = lane_order(BwdKey{in}, n, order_scratch, s);
    if (e != cudaSuccess) return (int)e;
    order = order_scratch + n;
  }
  kernel<<<blocks, THREADS, smem, s>>>(
      gtab, G, mtab, M, ltab, scal, seed, nee, n, origin, direction, thr, sample, depth, prev,
      replay_gid, replay_nee, g_contrib, g_next_o, g_next_d, g_thr_mult, d_origin, d_direction,
      d_thr, partial, vol_nee, surf, medium, g_medium, d_medium, order);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)row_sum(partial, blocks, R.k, partial + (size_t)blocks * R.k, row, s);
}

#endif  // __CUDACC__
