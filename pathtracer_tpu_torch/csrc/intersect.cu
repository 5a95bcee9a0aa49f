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
// nearest_kernel (kernel 6): the sweep of trace_common.cuh's pt::bounce
// (strict t < best, so the first minimum wins; a miss keeps t = BIG, gid 0
// and mid 0) and the hit frame of the TPU kernel: p = o + t_safe d and the
// object-space point with t_safe = 1 on a miss, the sphere's radial or the
// cube's argmax-|coord| object normal, and the winner's inverse-transpose
// world normal normalized.  Writes t [N], hit [N] (t < BIG), gid [N], mid
// [N] and p, p_obj, n as [N, 3].
//
// winner_kernel (kernel 7): the nearest-hit sweep without the hit frame, the
// detached winner search of the lean scan: t [N] float32 (BIG on a miss) and
// gid [N] int32 (0 on a miss, as _winner_kernel and jnp.argmin give).
//
// occlusion_kernel (kernel 8): the min-t sweep of a shadow ray, t [N] (BIG
// = clear); one thread per lane, the [G, GCOLS] table in shared memory.
// Every exact test runs.  A padded world-box cull of each geom
// (tools/occlusion_cull.py: the box computed in the kernel in double, the
// exact test only where the ray enters it) leaves Cornell's shadow rays 2.2
// of 9 tests a lane but 5.4 to 5.9 a warp past the first bounce, and its
// nine box tests alone took 56% of this sweep's time on the H100; in each
// form measured (blocks staging their boxes, a resident grid staging them
// once, the smallest box first, a warp's surviving tests run one a thread)
// it was slower than this kernel on every launch (PERF.md, section 6).
//
// What bounds 6 and 7 on the H100 is the sweep's instruction issue.  Each
// geom's test issues about 100 (sphere) to 125 (cube) instructions a ray:
// the 33 multiplies and adds of the object-space ray and the test's own,
// none fused (-fmad=false), and each correctly rounded 1.0f / x about 15
// with safe_recip's selects, the range check and its branch (three in a
// cube).  For Cornell's 9 geoms that is about 1,000 a lane, 0.019-0.022 ms
// at 640,000 lanes at 4 warp instructions a clock on 132 SMs, against
// 0.013 ms for the counted operations at the rate the build issues them
// (33.5 T/s) and 0.006 / 0.014 ms for kernel 7's / 6's bytes.  So the
// design cuts what the sweep issues beside the arithmetic: two rays a
// thread (blocks of 128 threads take 256 lanes), the table in shared
// memory as rows of ROW floats read as four float4 once for both rays, the
// type test once for both; kernel 6 does not carry its winner's
// object-space ray through the sweep (six selects a geom) but recomputes it
// from the winner's row after it (the same operations, so the same bits),
// and writes the hit plane itself, so that its call is one launch.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_split --parts
// intersect), at 640,000 lanes: kernel 7 0.0249-0.0252 ms alone and kernel
// 6 0.0307-0.0308 (its call 0.0350-0.0352) against 0.0260-0.0262 and
// 0.0321-0.0322 (0.0400-0.0409) for the design they replace (one ray a
// thread, 14-float rows, the winner's ray carried, hit a second launch).  A
// resident-sized grid with the next rays loaded during the sweep, 4 rays a
// thread and kernel 6's frame staged through shared memory were slower.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

constexpr int ROW = 16;  // a geom's row in the kernels' shared copy: GCOLS floats and padding

// The sweep values of a geom's row (the inverse transform and the type):
// four 16-byte shared loads in the kernels' padded copy, scalar loads of
// the [G, GCOLS] table elsewhere.
template <int STRIDE>
PT_FN void sweep_row(const float* row, float (&m)[GCOLS]) {
#ifdef __CUDACC__
  if constexpr (STRIDE == ROW) {
    const float4* v = reinterpret_cast<const float4*>(row);
    const float4 a = v[0], b = v[1], c = v[2], e = v[3];
    const float vals[GCOLS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                               c.x, c.y, c.z, c.w, e.x, e.y};
    for (int k = 0; k < GCOLS; ++k) m[k] = vals[k];
    return;
  }
#endif
  for (int k = 0; k < GCOLS; ++k) m[k] = row[k];
}

// Kernels 6 and 7's sweep of R rays over the geom table `tab` (rows of
// STRIDE floats): each ray's nearest t and geom, in index order with
// strict < so that the first minimum wins a tie (BIG and geom 0 on a
// miss).  A geom's type is the same for every ray, so each row is read
// once for all R of them and only its primitive's test runs; a mesh slot
// never hits (trace_common.cuh:geom_t).
template <int R, int STRIDE>
PT_FN void sweep_winner(const float* tab, int G, const V3 (&o)[R], const V3 (&d)[R],
                        float (&best_t)[R], int (&gid)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = BIG;
    gid[r] = 0;
  }
  for (int g = 0; g < G; ++g) {
    float m[GCOLS];
    sweep_row<STRIDE>(tab + g * STRIDE, m);
    if (m[12] == SPHERE) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        V3 oo, od;
        to_object(m, o[r], d[r], oo, od);
        const float t = sphere_t(oo, od);
        if (t < best_t[r]) {
          best_t[r] = t;
          gid[r] = g;
        }
      }
    } else if (m[12] == CUBE) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        V3 oo, od;
        to_object(m, o[r], d[r], oo, od);
        const float t = cube_t(oo, od);
        if (t < best_t[r]) {
          best_t[r] = t;
          gid[r] = g;
        }
      }
    }
  }
}

// One ray's nearest hit with its frame (kernel 6's record).
struct HitRecord {
  float t;
  int32_t gid, mid;
  V3 p, p_obj, n;
};

// The record of a ray whose sweep found (best_t, gid), the winner's row
// being `gw`: p = o + t_safe d and the object-space point with t_safe = 1
// on a miss, the winner's object-space ray recomputed from its row (the
// sweep's operations, so its bits; zero on a miss, as the sweep's winner
// before any hit), the sphere's radial or the cube's argmax-|coord| object
// normal and the inverse-transpose world normal normalized.
PT_FN HitRecord hit_record(const float* gw, V3 o, V3 d, float best_t, int gid) {
  const bool hit = best_t < BIG;
  V3 w_o = v3(0.0f, 0.0f, 0.0f), w_d = w_o;
  if (hit) to_object(gw, o, d, w_o, w_d);
  const float t_safe = hit ? best_t : 1.0f;
  HitRecord h;
  h.t = best_t;
  h.gid = gid;
  h.mid = hit ? (int32_t)gw[13] : 0;
  h.p = vadd(o, vscale(t_safe, d));
  h.p_obj = vadd(w_o, vscale(t_safe, w_d));
  const V3 n_obj = object_normal(hit && gw[12] == SPHERE, h.p_obj);
  h.n = vnormalize(world_normal_raw(gw, n_obj));
  return h;
}

PT_FN V3 load_v3(const float* __restrict__ a, size_t i) {
  return v3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

PT_FN void store_v3(float* __restrict__ a, size_t i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

// one lane of kernel 6 (its sweep and record, one ray); also compiled as
// host C++ by tests/kernel_host_harness.cpp
PT_FN void nearest_lane(const float* g_tab, int G, size_t i, const float* __restrict__ origin,
                        const float* __restrict__ direction, float* __restrict__ t_out,
                        int32_t* __restrict__ gid_out, int32_t* __restrict__ mid_out,
                        float* __restrict__ p_out, float* __restrict__ pobj_out,
                        float* __restrict__ n_out) {
  const V3 o[1] = {load_v3(origin, i)}, d[1] = {load_v3(direction, i)};
  float best_t[1];
  int gid[1];
  sweep_winner<1, GCOLS>(g_tab, G, o, d, best_t, gid);
  const HitRecord h = hit_record(g_tab + gid[0] * GCOLS, o[0], d[0], best_t[0], gid[0]);
  t_out[i] = h.t;
  gid_out[i] = h.gid;
  mid_out[i] = h.mid;
  store_v3(p_out, i, h.p);
  store_v3(pobj_out, i, h.p_obj);
  store_v3(n_out, i, h.n);
}

// one lane of kernel 7 (its sweep, one ray): the winner's t and geom id; also
// compiled as host C++ by tests/kernel_host_harness.cpp
PT_FN void winner_lane(const float* g_tab, int G, size_t i, const float* __restrict__ origin,
                       const float* __restrict__ direction, float* __restrict__ t_out,
                       int32_t* __restrict__ gid_out) {
  const V3 o[1] = {load_v3(origin, i)}, d[1] = {load_v3(direction, i)};
  float best_t[1];
  int gid[1];
  sweep_winner<1, GCOLS>(g_tab, G, o, d, best_t, gid);
  t_out[i] = best_t[0];
  gid_out[i] = gid[0];
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
// rays per thread of kernels 6 and 7: each table row read from shared
// memory serves all of them
constexpr int RAYS = 2;
constexpr int SPAN = THREADS * RAYS;  // lanes per block of kernels 6 and 7

// the geom table copied into shared memory as rows of ROW floats
PT_FN void stage_rows(const float* __restrict__ gtab, int G, float* s_g) {
  for (int i = threadIdx.x; i < G * ROW; i += blockDim.x) {
    const int g = i / ROW, c = i % ROW;
    s_g[i] = c < GCOLS ? gtab[g * GCOLS + c] : 0.0f;
  }
}

// the RAYS rays of the thread whose first lane is `lane`: lanes lane +
// r * THREADS, those past n clamped to the last lane (swept, never stored)
PT_FN void load_rays(const float* __restrict__ origin, const float* __restrict__ direction,
                     int lane, int n, V3 (&o)[RAYS], V3 (&d)[RAYS]) {
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = min(lane + r * THREADS, n - 1);
    o[r] = load_v3(origin, i);
    d[r] = load_v3(direction, i);
  }
}

__global__ void __launch_bounds__(THREADS)
nearest_kernel(const float* __restrict__ gtab, int G, int n, const float* __restrict__ origin,
               const float* __restrict__ direction, float* __restrict__ t_out,
               bool* __restrict__ hit_out, int32_t* __restrict__ gid_out,
               int32_t* __restrict__ mid_out, float* __restrict__ p_out,
               float* __restrict__ pobj_out, float* __restrict__ n_out) {
  extern __shared__ float4 s_rows[];  // G rows of ROW floats
  float* s_g = reinterpret_cast<float*>(s_rows);
  stage_rows(gtab, G, s_g);
  __syncthreads();
  const int lane = blockIdx.x * SPAN + threadIdx.x;  // this thread's first lane
  if (lane >= n) return;
  V3 o[RAYS], d[RAYS];
  load_rays(origin, direction, lane, n, o, d);
  float best_t[RAYS];
  int gid[RAYS];
  sweep_winner<RAYS, ROW>(s_g, G, o, d, best_t, gid);
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = lane + r * THREADS;
    if (i >= n) break;
    const HitRecord h = hit_record(s_g + gid[r] * ROW, o[r], d[r], best_t[r], gid[r]);
    t_out[i] = h.t;
    hit_out[i] = h.t < BIG;
    gid_out[i] = h.gid;
    mid_out[i] = h.mid;
    store_v3(p_out, i, h.p);
    store_v3(pobj_out, i, h.p_obj);
    store_v3(n_out, i, h.n);
  }
}

__global__ void __launch_bounds__(THREADS)
winner_kernel(const float* __restrict__ gtab, int G, int n, const float* __restrict__ origin,
              const float* __restrict__ direction, float* __restrict__ t_out,
              int32_t* __restrict__ gid_out) {
  extern __shared__ float4 s_rows[];  // G rows of ROW floats
  float* s_g = reinterpret_cast<float*>(s_rows);
  stage_rows(gtab, G, s_g);
  __syncthreads();
  const int lane = blockIdx.x * SPAN + threadIdx.x;  // this thread's first lane
  if (lane >= n) return;
  V3 o[RAYS], d[RAYS];
  load_rays(origin, direction, lane, n, o, d);
  float best_t[RAYS];
  int gid[RAYS];
  sweep_winner<RAYS, ROW>(s_g, G, o, d, best_t, gid);
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = lane + r * THREADS;
    if (i >= n) break;
    t_out[i] = best_t[r];
    gid_out[i] = gid[r];
  }
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
                              const float* direction, float* t, bool* hit, int* gid, int* mid,
                              float* p, float* p_obj, float* normal, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + SPAN - 1) / SPAN;
  nearest_kernel<<<blocks, THREADS, sizeof(float) * G * ROW, (cudaStream_t)stream>>>(
      gtab, G, n, origin, direction, t, hit, gid, mid, p, p_obj, normal);
  return (int)cudaGetLastError();
}

extern "C" int winner_launch(const float* gtab, int G, int n, const float* origin,
                             const float* direction, float* t, int* gid, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + SPAN - 1) / SPAN;
  winner_kernel<<<blocks, THREADS, sizeof(float) * G * ROW, (cudaStream_t)stream>>>(
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
