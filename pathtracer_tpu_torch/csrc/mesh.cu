// Nearest triangle and shadow-ray occlusion of one mesh for Hopper (sm_90a):
// kernels 9 and 10 of the split per-bounce route.
//
// Replaces the TPU kernels pathtracer_tpu/ops/mesh_pallas.py:
// _mesh_nearest_kernel (launched by mesh_nearest_pallas, :125) and
// _mesh_min_kernel (launched by mesh_min_pallas, :156), as ops/intersect.py:
// mesh_query and mesh_occlusion_t call them for meshes of at most 8192
// triangles.  The plain PyTorch versions are pathtracer_tpu_torch/ops/
// mesh.py:mesh_nearest_plain and mesh_min_plain; this file repeats their
// arithmetic in the same order (-fmad=false, no fast math).
//
// mesh_nearest_kernel (kernel 9): per ray, Moeller-Trumbore against every
// triangle of a flat [T * 9] (v0, e1, e2) table in ascending order, with the
// 1e-12 determinant guard (trace_common.cuh:mt_tri); the winner changes only
// on a strict t < best, so the first minimum wins, as argmin.  Writes t [N]
// (BIG on a miss) and the winner's row [N] int32 (0 on a miss).
// mesh_min_kernel (kernel 10): the same loop keeping the minimum t alone.
// Rays are object-space [N, 3] origin and direction; no padding.
//
// Design: one thread per ray, the running best in registers (the TPU kernel
// keeps it in vector registers too, never forming the [N, T] t-matrix).  The
// table stays in device memory: at 8192 triangles it is 295 KB, more than a
// block's shared memory.  Every thread of a warp reads the same triangle at
// the same step, so each read is one broadcast from the L1 cache.
//
// What bounds them on the H100: operations.  A ray-triangle pair costs about
// 65 fp32 operations, 5.5e9 for 262,144 rays and 320 triangles (0.08 ms at
// 67 TFLOP/s) against 7 MB of rays in and t out (0.002 ms at 3.35 TB/s).
// Making them fast (culling, shared-memory tiles) is later work.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

// one ray of kernel 9; also compiled as host C++ by tests/kernel_host_harness.cpp
PT_FN void mesh_nearest_lane(const float* tab, int n_tris, V3 o, V3 d, float& t_out,
                             int32_t& i_out) {
  float bt = BIG;
  int bi = 0;
  for (int i = 0; i < n_tris; ++i) {
    float u, v;
    const float tc = mt_tri(tab + 9 * i, o, d, u, v);
    if (tc < bt) {
      bt = tc;
      bi = i;
    }
  }
  t_out = bt;
  i_out = bi;
}

// one ray of kernel 10
PT_FN float mesh_min_lane(const float* tab, int n_tris, V3 o, V3 d) {
  float bt = BIG;
  for (int i = 0; i < n_tris; ++i) {
    float u, v;
    bt = fminf(bt, mt_tri(tab + 9 * i, o, d, u, v));
  }
  return bt;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
mesh_nearest_kernel(const float* __restrict__ tab, int n_tris, int n,
                    const float* __restrict__ o_obj, const float* __restrict__ d_obj,
                    float* __restrict__ t_out, int32_t* __restrict__ i_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const V3 o = v3(o_obj[3 * idx], o_obj[3 * idx + 1], o_obj[3 * idx + 2]);
  const V3 d = v3(d_obj[3 * idx], d_obj[3 * idx + 1], d_obj[3 * idx + 2]);
  mesh_nearest_lane(tab, n_tris, o, d, t_out[idx], i_out[idx]);
}

__global__ void __launch_bounds__(THREADS)
mesh_min_kernel(const float* __restrict__ tab, int n_tris, int n,
                const float* __restrict__ o_obj, const float* __restrict__ d_obj,
                float* __restrict__ t_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const V3 o = v3(o_obj[3 * idx], o_obj[3 * idx + 1], o_obj[3 * idx + 2]);
  const V3 d = v3(d_obj[3 * idx], d_obj[3 * idx + 1], d_obj[3 * idx + 2]);
  t_out[idx] = mesh_min_lane(tab, n_tris, o, d);
}

}  // namespace

extern "C" int mesh_nearest_launch(const float* tab, int n_tris, int n, const float* o_obj,
                                   const float* d_obj, float* t, int* idx, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_nearest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tab, n_tris, n, o_obj,
                                                                     d_obj, t, idx);
  return (int)cudaGetLastError();
}

extern "C" int mesh_min_launch(const float* tab, int n_tris, int n, const float* o_obj,
                               const float* d_obj, float* t, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_min_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tab, n_tris, n, o_obj, d_obj,
                                                                 t);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
