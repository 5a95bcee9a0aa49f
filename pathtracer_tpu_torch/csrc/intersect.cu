// Analytic nearest hit, winner search and shadow-ray occlusion for Hopper
// (sm_90a): the intersection kernels of the split per-bounce route and of
// the lean differentiable scan.
//
// Replaces the TPU kernels pathtracer_tpu/ops/intersect_pallas.py:
// _nearest_hit_kernel (launched by nearest_hit_planes, :245),
// _winner_kernel (launched by winner_t_gid_planes, :174) and
// _occlusion_kernel (launched by occlusion_t_planes, :337), as
// intersect_scene_pallas, intersect_scene_lean and occlusion_scene_pallas
// call them for scenes of spheres and cubes.  The plain PyTorch versions are
// pathtracer_tpu_torch/ops/intersect.py:nearest_hit_plain,
// winner_t_gid_plain and occlusion_t_plain; this file repeats their
// arithmetic in the same order (-fmad=false, no fast math, rsqrtf where JAX
// has lax.rsqrt).
//
// nearest_kernel: the sweep of trace_common.cuh's pt::bounce (strict t <
// best, so the first minimum wins; a miss keeps t = BIG, gid 0 and mid 0)
// and the hit frame of the TPU kernel: p = o + t_safe d and the object-space
// point with t_safe = 1 on a miss, the sphere's radial or the cube's
// argmax-|coord| object normal, and the winner's inverse-transpose world
// normal normalized.  Writes t [N], gid [N], mid [N] and p, p_obj, n as
// [N, 3].
//
// winner_kernel (kernel 7): the nearest-hit sweep without the hit frame, the
// detached winner search of the lean scan: t [N] float32 (BIG on a miss) and
// gid [N] int32 (0 on a miss, as _winner_kernel and jnp.argmin give).
//
// occlusion_kernel: the min-t sweep of a shadow ray, t [N] (BIG = clear).
//
// Both: one thread per lane, the geom table in shared memory, lane-
// contiguous outputs; lanes past n write nothing.
//
// What bounds them on the H100: kernel 6 moves 72 B per lane (6 planes in,
// 12 out), 46 MB per 640,000-lane launch, 0.014 ms at 3.35 TB/s; kernel 8
// moves 28 B per lane, 0.005 ms, and its counted operations (about 80 per
// geom of the sweep) take a little longer at the fp32 peak for Cornell's 9
// geoms.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, both run
// at about 5x their bound; one thread per lane with the table in shared
// memory is the simple design, and making them fast is later work.  Kernel
// 7 moves 32 B per lane (0.006 ms) and its operations are kernel 8's.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

// one lane of kernel 6; also compiled as host C++ by
// tests/kernel_host_harness.cpp
PT_FN void nearest_lane(const float* g_tab, int G, size_t i, const float* __restrict__ origin,
                        const float* __restrict__ direction, float* __restrict__ t_out,
                        int32_t* __restrict__ gid_out, int32_t* __restrict__ mid_out,
                        float* __restrict__ p_out, float* __restrict__ pobj_out,
                        float* __restrict__ n_out) {
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  float best_t = BIG;
  int gid = 0;
  V3 w_o = v3(0.0f, 0.0f, 0.0f), w_d = w_o;
  for (int g = 0; g < G; ++g) {
    const float* m = g_tab + g * GCOLS;
    V3 oo, od;
    to_object(m, o, d, oo, od);
    float t = geom_t(m, oo, od);
    if (t < best_t) {
      best_t = t;
      gid = g;
      w_o = oo;
      w_d = od;
    }
  }
  const bool hit = best_t < BIG;
  const float* gw = g_tab + gid * GCOLS;
  const float t_safe = hit ? best_t : 1.0f;
  const V3 p = vadd(o, vscale(t_safe, d));
  const V3 p_obj = vadd(w_o, vscale(t_safe, w_d));
  const V3 n_obj = object_normal(hit && gw[12] == SPHERE, p_obj);
  const V3 n = vnormalize(world_normal_raw(gw, n_obj));
  t_out[i] = best_t;
  gid_out[i] = gid;
  mid_out[i] = hit ? (int32_t)gw[13] : 0;
  const V3* vec[3] = {&p, &p_obj, &n};
  float* out[3] = {p_out, pobj_out, n_out};
  for (int k = 0; k < 3; ++k) {
    out[k][3 * i] = vec[k]->x;
    out[k][3 * i + 1] = vec[k]->y;
    out[k][3 * i + 2] = vec[k]->z;
  }
}

// one lane of kernel 7: the winner's t and geom id
PT_FN void winner_lane(const float* g_tab, int G, size_t i, const float* __restrict__ origin,
                       const float* __restrict__ direction, float* __restrict__ t_out,
                       int32_t* __restrict__ gid_out) {
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  float best_t = BIG;
  int gid = 0;
  for (int g = 0; g < G; ++g) {
    const float* m = g_tab + g * GCOLS;
    V3 oo, od;
    to_object(m, o, d, oo, od);
    const float t = geom_t(m, oo, od);
    if (t < best_t) {
      best_t = t;
      gid = g;
    }
  }
  t_out[i] = best_t;
  gid_out[i] = gid;
}

// one lane of kernel 8
PT_FN float occlusion_lane(const float* g_tab, int G, size_t i, const float* __restrict__ origin,
                           const float* __restrict__ direction) {
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  float best_t = BIG;
  for (int g = 0; g < G; ++g) {
    const float* m = g_tab + g * GCOLS;
    V3 oo, od;
    to_object(m, o, d, oo, od);
    best_t = fminf(best_t, geom_t(m, oo, od));
  }
  return best_t;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
nearest_kernel(const float* __restrict__ gtab, int G, int n, const float* __restrict__ origin,
               const float* __restrict__ direction, float* __restrict__ t_out,
               int32_t* __restrict__ gid_out, int32_t* __restrict__ mid_out,
               float* __restrict__ p_out, float* __restrict__ pobj_out,
               float* __restrict__ n_out) {
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  nearest_lane(s_g, G, (size_t)idx, origin, direction, t_out, gid_out, mid_out, p_out,
               pobj_out, n_out);
}

__global__ void __launch_bounds__(THREADS)
winner_kernel(const float* __restrict__ gtab, int G, int n, const float* __restrict__ origin,
              const float* __restrict__ direction, float* __restrict__ t_out,
              int32_t* __restrict__ gid_out) {
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  winner_lane(s_g, G, (size_t)idx, origin, direction, t_out, gid_out);
}

__global__ void __launch_bounds__(THREADS)
occlusion_kernel(const float* __restrict__ gtab, int G, int n, const float* __restrict__ origin,
                 const float* __restrict__ direction, float* __restrict__ t_out) {
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  t_out[idx] = occlusion_lane(s_g, G, (size_t)idx, origin, direction);
}

}  // namespace

extern "C" int nearest_launch(const float* gtab, int G, int n, const float* origin,
                              const float* direction, float* t, int* gid, int* mid, float* p,
                              float* p_obj, float* normal, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  nearest_kernel<<<blocks, THREADS, sizeof(float) * G * GCOLS, (cudaStream_t)stream>>>(
      gtab, G, n, origin, direction, t, gid, mid, p, p_obj, normal);
  return (int)cudaGetLastError();
}

extern "C" int winner_launch(const float* gtab, int G, int n, const float* origin,
                             const float* direction, float* t, int* gid, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  winner_kernel<<<blocks, THREADS, sizeof(float) * G * GCOLS, (cudaStream_t)stream>>>(
      gtab, G, n, origin, direction, t, gid);
  return (int)cudaGetLastError();
}

extern "C" int occlusion_launch(const float* gtab, int G, int n, const float* origin,
                                const float* direction, float* t, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  occlusion_kernel<<<blocks, THREADS, sizeof(float) * G * GCOLS, (cudaStream_t)stream>>>(
      gtab, G, n, origin, direction, t);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
