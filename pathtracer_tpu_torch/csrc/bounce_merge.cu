// One bounce per launch with an outside mesh winner, for Hopper (sm_90a):
// kernel 2's mesh-merge variant (2mm), for scenes whose meshes total more
// triangles than the in-kernel sweep takes.
//
// Replaces the TPU kernel pathtracer_tpu/ops/bounce_pallas.py:_bounce_kernel
// with mesh_merge (launched by bounce_fused, :1694-1810).  The plain PyTorch
// version is pathtracer_tpu_torch/ops/bounce_fused.py:bounce_fused_plain
// with mesh_in, which runs ops/bounce.py:bounce_physics(mesh_in=...).  Each
// lane runs pt::bounce<..., kMerge> (trace_common.cuh) through
// csrc/bounce_lane.cuh, as kernel 2 does, and repeats the plain version's
// arithmetic in the same order.
//
// Per lane it reads kernel 2's 16 input planes and the 8 merge planes
// mesh_in [8, n] (the nearest triangle's t, its hit point in the mesh's
// object space, its unit world normal and material id: ops/mesh.
// mesh_only_hit, kernels 9 and 10 or the LBVH traversal, before the launch),
// with image textures and authored vt also mesh_uv [3, n].  It merges that
// winner into its analytic sweep where it is nearer, shades as kernel 2 and
// writes kernel 2's 19 outputs (with kTex the texel's 3).  Under NEE the
// shadow ray is traced against the analytic geoms only and, on every lane,
// leaves with its pending term: deferred [11, n] (x, wi, its length, the NEE
// rgb, 1 where the candidate clears the analytic geoms); the wrapper tests
// the triangles (kernel 10 per mesh) and adds the term where both clear it.
// min(analytic, mesh) >= the bar exactly when both are, so the split is
// exact.  Volumetric NEE is not run: such scenes take the split route
// (render/common.py), as in JAX.
//
// Instances: vacuum, volumetric, volumetric + HG, each without and with the
// surface blocks (kSurf), and kSurf with the deferred texel (kTex).  They
// live in their own source so that nvcc builds them beside bounce.cu's.
//
// Design: one thread per lane, the tables in shared memory, as kernel 2;
// the new planes are plane-major ([k, n]), so neighbouring lanes read and
// write neighbouring words.  What bounds it on the H100: bytes.  A lane
// moves kernel 2's 137 bytes, 32 more in and, under NEE, 44 more out; with
// the texel and mesh_uv 24 more.  The triangle tests run outside.

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "bounce_lane.cuh"

namespace {

using namespace pt;

constexpr int THREADS = 128;

template <bool kVol, bool kHg, bool kSurf, bool kTex>
__global__ void __launch_bounds__(THREADS)
bounce_merge_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                    const float* __restrict__ ltab, const float* __restrict__ scal,
                    uint32_t seed, int nee, int n, const float* __restrict__ origin,
                    const float* __restrict__ direction, const float* __restrict__ thr,
                    const uint32_t* __restrict__ sample, const int32_t* __restrict__ depth,
                    const float* __restrict__ prev, const float* __restrict__ medium,
                    float* __restrict__ contrib, float* __restrict__ next_o,
                    float* __restrict__ next_d, float* __restrict__ thr_mult,
                    uint8_t* __restrict__ terminate, float* __restrict__ wspec,
                    float* __restrict__ rru, float* __restrict__ out_medium, int vol_nee, int mw,
                    int surf, float* __restrict__ tex_u, float* __restrict__ tex_v,
                    float* __restrict__ tex_slot, const float* __restrict__ mesh_in,
                    const float* __restrict__ mesh_uv, float* __restrict__ deferred) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Tables T{s_g, s_m, s_l, G, scal[0], scal[1] > 0.5f,
                 MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0}, kSurf ? surf : 0};
  bounce_lane<kVol, kHg, kSurf, kTex, true>(
      T, seed, nee, vol_nee, mw, (size_t)idx, origin, direction, thr, sample, depth, prev, medium,
      contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium, nullptr, nullptr,
      tex_u, tex_v, tex_slot, mesh_in, mesh_uv, deferred, (size_t)n);
}

// the instance of one media case (vacuum, volumetric, volumetric + HG)
template <bool kSurf, bool kTex>
decltype(&bounce_merge_kernel<false, false, false, false>) media_instance(int vol, int hg) {
  return !vol ? bounce_merge_kernel<false, false, kSurf, kTex>
              : (hg ? bounce_merge_kernel<true, true, kSurf, kTex>
                    : bounce_merge_kernel<true, false, kSurf, kTex>);
}

}  // namespace

// tex_u / tex_v / tex_slot not null: with the deferred texel (and surf; the
// wrapper checks it); mesh_uv may be null; deferred null without NEE
extern "C" int bounce_merge_launch(
    const float* gtab, int G, const float* mtab, int M, const float* ltab, const float* scal,
    unsigned int seed, int nee, int n, const float* origin, const float* direction,
    const float* thr, const unsigned int* sample, const int* depth, const float* prev,
    const float* medium, float* contrib, float* next_o, float* next_d, float* thr_mult,
    unsigned char* terminate, float* wspec, float* rru, float* out_medium, int vol, int hg,
    int vol_nee, int mw, int surf, float* tex_u, float* tex_v, float* tex_slot,
    const float* mesh_in, const float* mesh_uv, float* deferred, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = sizeof(float) * (size_t)(G * GCOLS + M * MCOLS + G * LCOLS);
  const auto kernel = tex_u != nullptr ? media_instance<true, true>(vol, hg)
                      : surf           ? media_instance<true, false>(vol, hg)
                                       : media_instance<false, false>(vol, hg);
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, nee, n, origin, direction, thr, sample, depth, prev,
      medium, contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium, vol_nee, mw,
      surf, tex_u, tex_v, tex_slot, mesh_in, mesh_uv, deferred);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
