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
// - One thread per lane; all bounces run in a loop inside the thread, and a
//   lane that dies leaves the loop.  That is exact: a dead lane adds neither
//   radiance nor rays.  Lanes past n start dead (no padding needed).
// - The geom / material / light tables are copied once per block into
//   shared memory and indexed by geom, material and light id: the TPU
//   kernel's where-chains over every row (it has no vector gather) become
//   gathers with the same semantics: strict t < best so the first minimum
//   wins, a miss keeps material 0, the light id is clipped to [0, G-1], the
//   geom type is compared as a float.  Misses and light hits terminate
//   without sampling a BSDF; only diffuse lanes sample a light and sweep the
//   shadow ray, and a shadow sweep is skipped when the connection cannot
//   count.  Each skip drops work whose result the JAX kernel masks away.
// - The ray count is reduced per warp and added with one 64-bit atomic per
//   warp: exact at any size (the TPU kernel sums a float across its
//   sequential grid).
// - Built with -fmad=false and without fast math: a*b+c is not contracted,
//   divisions and sqrtf are IEEE, and rsqrtf stands where JAX uses
//   lax.rsqrt, so the kernel rounds as the op-by-op plain version does.
// - The loop body, pt::bounce_step, lives in trace_common.cuh: the forward
//   kernel of the differentiable trace (trace_grad.cu) runs the same
//   function, so the two forwards agree bit for bit, and the per-bounce
//   kernel (bounce.cu) runs the same pt::bounce.
//
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
// per geom.  The loop is branchy and divergent (a warp runs the union of
// its lanes' material branches and lives as long as its longest path);
// this first kernel accepts that and keeps registers, not memory, as the
// working set.  With meshes the triangle tests dominate: a lane tests the
// 32 triangles of every chunk its ray reaches nearer than its best, and a
// warp runs the chunks any of its lanes reaches (on smooth_mesh's primary
// rays the nearest sweep took ~70% of the mesh instance's time before the
// winner moved out of the loop, the shadow sweep ~25%; chip_smoke.py's
// [mesh:time] measures it).  Sorting lanes by material or compacting live
// lanes is later work.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

// One lane's whole path: the bounce loop, the radiance and the number of
// bounces it traced.  With kVol the lane carries its medium in registers,
// starting in vacuum (kHg: with the phase g).  Also compiled as host C++
// by tests/kernel_host_harness.cpp.
template <bool kVol = false, bool kHg = false, bool kSurf = false>
PT_FN V3 trace_lane(const Tables& T, uint32_t seed, uint32_t s, V3 o, V3 d, int max_depth,
                    int nee, int rr, int rr_start, bool alive, unsigned int& bounces,
                    int vol_nee = 1) {
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  float prev_state = 0.0f;
  Medium med{};
  const uint32_t s_term = s * 0x85EBCA6Bu;
  for (int dep = 0; dep < max_depth && alive; ++dep) {
    ++bounces;
    int gid;
    bool nee_add;
    bounce_step<kVol, kHg, kSurf>(T, bounce_base(seed, s_term, dep), dep, nee, rr, rr_start, o, d,
                                  thr, prev_state, rad, alive, gid, nee_add, &med, vol_nee);
  }
  return rad;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

// kMesh = false compiles the analytic kernel: its mesh tables are a
// constant n = 0, and the sweep drops out of the code (and of the register
// budget) as in the kernels that never take meshes.  kVol / kHg compile the
// participating-media blocks in (pt::bounce); without them the code is the
// vacuum kernel's.  kSurf compiles the surface blocks in.
template <bool kMesh, bool kVol, bool kHg, bool kSurf>
__global__ void __launch_bounds__(128)
trace_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
             const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
             const float* __restrict__ origin, const float* __restrict__ direction,
             const uint32_t* __restrict__ sample, int n, float* __restrict__ radiance,
             unsigned long long* __restrict__ nrays, int max_depth, int nee, int rr,
             int rr_start, int vol_nee, int surf, MeshTables mesh) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const Tables T{s_g, s_m, s_l, G, scal[0], scal[1] > 0.5f,
                 kMesh ? mesh : MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0},
                 kSurf ? surf : 0};

  const bool alive = idx < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  uint32_t s = 0;
  if (alive) {
    o = v3(origin[3 * idx], origin[3 * idx + 1], origin[3 * idx + 2]);
    d = v3(direction[3 * idx], direction[3 * idx + 1], direction[3 * idx + 2]);
    s = sample[idx];
  }
  unsigned int bounces = 0;
  const V3 rad = trace_lane<kVol, kHg, kSurf>(T, seed, s, o, d, max_depth, nee, rr, rr_start, alive,
                                       bounces, vol_nee);

  if (idx < n) {
    radiance[3 * idx] = rad.x;
    radiance[3 * idx + 1] = rad.y;
    radiance[3 * idx + 2] = rad.z;
  }

  // exact ray count: warp sum, one 64-bit atomic per warp
  unsigned long long c = (unsigned long long)bounces * (nee ? 2ull : 1ull);
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

}  // namespace

extern "C" int trace_launch(const float* gtab, int G, const float* mtab, int M,
                            const float* ltab, const float* scal, unsigned int seed,
                            const float* origin, const float* direction,
                            const unsigned int* sample, int n, float* radiance,
                            unsigned long long* nrays, int max_depth, int nee, int rr,
                            int rr_start, int vol, int hg, int vol_nee, int surf,
                            const float* mtri, const float* maabb, const float* mnorm,
                            const float* muv, const int* mdesc, int n_mesh, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = sizeof(float) * (size_t)(G * pt::GCOLS + M * pt::MCOLS + G * pt::LCOLS);
  const pt::MeshTables mesh{mtri, maabb, mnorm, muv, mdesc, n_mesh};
  // the instance: mesh sweep or not x vacuum, volumetric, volumetric + HG x
  // surface blocks or not
  const auto kernel = n_mesh > 0 ? (surf ? media_instance<true, true>(vol, hg)
                                         : media_instance<true, false>(vol, hg))
                                 : (surf ? media_instance<false, true>(vol, hg)
                                         : media_instance<false, false>(vol, hg));
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, origin, direction, sample, n, radiance, nrays,
      max_depth, nee, rr, rr_start, vol_nee, surf, mesh);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
