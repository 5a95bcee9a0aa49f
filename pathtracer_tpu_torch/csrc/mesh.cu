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
// mesh_nearest_kernel (kernel 9): per ray, Moeller-Trumbore against the
// triangles of a flat [T * 9] (v0, e1, e2) table in ascending order, with
// the 1e-12 determinant guard (trace_common.cuh:mt_tri); the winner changes
// only on a strict t < best, so the first minimum wins, as argmin.  Writes
// t [N] (BIG on a miss) and the winner's row [N] int32 (0 on a miss).
// mesh_min_kernel (kernel 10): the same loop keeping the minimum t alone.
// Rays are object-space [N, 3] origin and direction; no padding.
//
// Chunk culling: the table's rows fall into chunks of SCAN_CHUNK = 128 (the
// LBVH's chunks where the mesh has one; the last chunk is short), each with
// a padded box [C, 6] (lo, hi; ops/mesh.pad_boxes).  A lane tests a chunk's
// triangles only where its ray's slab interval meets the padded box nearer
// than best * REACH_SLACK (trace_common.cuh:chunk_reaches, the in-kernel
// sweep's test); the plain versions apply the same test, so kernel and plain
// are equal on every lane.  Without boxes (a null pointer) every chunk is
// tested: the dense sweep, the oracle that checks what culling changes.
//
// Why the margin keeps a well-conditioned hit: the slab bounds are
// (lo - o) * (1 / d), three correctly rounded operations, so each carries a
// relative error below 2e-7 of itself, however far the origin is.  A
// triangle lies inside its chunk's box up to the rounding of e1 = v1 - v0
// (an ulp of the coordinates), which the pad, 1e-5 of the box's largest
// extent plus its largest |coordinate|, covers a hundred times.  The pad
// also moves the box's entry at least 1e-5 * scale / |d| before the hit in
// t, and REACH_SLACK (1 + 1e-6) lets an entry that rounds up to the running
// best through: a hit whose Moeller-Trumbore t is within 1e-6 of the exact
// one (a determinant |a| well above the 1e-12 guard, the ray not grazing
// the triangle's plane) always finds its chunk reached.  A triangle nearly
// parallel to the ray can give a t far from any box; no margin covers it,
// so the lanes where culled and dense differ are counted on the card
// (chip_smoke.py [mesh], [bigmesh]), not assumed away.
//
// Design: a block of 128 lanes walks the chunks in ascending order.  Each
// lane decides reach for itself; __syncthreads_or skips a chunk no lane of
// the block reaches (a block of primary rays that misses the mesh's root box
// tests no triangle); otherwise the block copies the chunk's rows into
// shared memory (128 x 9 floats, 4.6 KB, one coalesced pass) and the lanes
// that reach it run Moeller-Trumbore over the tile, every lane on the same
// row at the same step (a broadcast read).  The running best stays in
// registers, as the TPU kernel keeps it in vector registers.
//
// What bounds them on the H100: operations, counted from the data: a slab
// test per lane and chunk (~24) and ~65 per (lane, triangle) pair of the
// chunks each ray must test, those whose unpadded box it enters before its
// final t (chip_smoke.py counts them with the plain version's masks).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

constexpr int SCAN_CHUNK = 128;  // table rows per culling chunk: ops/accel.ACCEL_CHUNK
constexpr float REACH_SLACK = 1.000001f;  // a chunk's entry may round up to the best

// the chunk's box reaches this lane (no boxes: every chunk does)
PT_FN bool scan_reaches(const float* boxes, int c, V3 o, V3 inv, float best) {
  return boxes == nullptr || chunk_reaches(boxes + 6 * c, o, inv, best * REACH_SLACK);
}

// Moeller-Trumbore over `rows` rows (a chunk in the table or in shared
// memory) whose first is table row `row0`: strict t < best updates
template <bool kIndex>
PT_FN void scan_rows(const float* rows_tab, int rows, int row0, V3 o, V3 d, float& bt, int& bi) {
  for (int j = 0; j < rows; ++j) {
    float u, v;
    const float tc = mt_tri(rows_tab + 9 * j, o, d, u, v);
    if (kIndex) {
      if (tc < bt) {
        bt = tc;
        bi = row0 + j;
      }
    } else {
      bt = fminf(bt, tc);
    }
  }
}

// one ray of kernel 9 (kIndex) or 10 over the whole table; also compiled as
// host C++ by tests/kernel_host_harness.cpp
template <bool kIndex>
PT_FN void mesh_scan_lane(const float* tab, int n_tris, const float* boxes, V3 o, V3 d,
                          float& t_out, int32_t& i_out) {
  const V3 inv = v3(safe_recip(d.x), safe_recip(d.y), safe_recip(d.z));
  float bt = BIG;
  int bi = 0;
  for (int c = 0, row0 = 0; row0 < n_tris; ++c, row0 += SCAN_CHUNK) {
    if (!scan_reaches(boxes, c, o, inv, bt)) continue;
    const int rows = n_tris - row0 < SCAN_CHUNK ? n_tris - row0 : SCAN_CHUNK;
    scan_rows<kIndex>(tab + 9 * row0, rows, row0, o, d, bt, bi);
  }
  t_out = bt;
  i_out = bi;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int THREADS = SCAN_CHUNK;  // one lane per row of a tile

// one block's sweep: the body of both kernels
template <bool kIndex>
__device__ __forceinline__ void scan_block(const float* __restrict__ tab, int n_tris,
                                           const float* __restrict__ boxes, int n,
                                           const float* __restrict__ o_obj,
                                           const float* __restrict__ d_obj,
                                           float* __restrict__ t_out,
                                           int32_t* __restrict__ i_out) {
  __shared__ float tile[SCAN_CHUNK * 9];
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const bool live = idx < n;  // the block's last lanes still join its barriers
  V3 o = v3(0.0f, 0.0f, 0.0f), d = v3(0.0f, 0.0f, 1.0f);
  if (live) {
    o = v3(o_obj[3 * idx], o_obj[3 * idx + 1], o_obj[3 * idx + 2]);
    d = v3(d_obj[3 * idx], d_obj[3 * idx + 1], d_obj[3 * idx + 2]);
  }
  const V3 inv = v3(safe_recip(d.x), safe_recip(d.y), safe_recip(d.z));
  float bt = BIG;
  int bi = 0;
  for (int c = 0, row0 = 0; row0 < n_tris; ++c, row0 += SCAN_CHUNK) {
    const bool reach = live && scan_reaches(boxes, c, o, inv, bt);
    // a barrier too: every lane is done with the previous tile
    if (!__syncthreads_or(reach)) continue;
    const int rows = n_tris - row0 < SCAN_CHUNK ? n_tris - row0 : SCAN_CHUNK;
    const float* src = tab + 9 * row0;
    for (int k = threadIdx.x; k < 9 * rows; k += THREADS) tile[k] = src[k];
    __syncthreads();
    if (reach) scan_rows<kIndex>(tile, rows, row0, o, d, bt, bi);
  }
  if (live) {
    t_out[idx] = bt;
    if (kIndex) i_out[idx] = bi;
  }
}

__global__ void __launch_bounds__(THREADS)
mesh_nearest_kernel(const float* __restrict__ tab, int n_tris, const float* __restrict__ boxes,
                    int n, const float* __restrict__ o_obj, const float* __restrict__ d_obj,
                    float* __restrict__ t_out, int32_t* __restrict__ i_out) {
  scan_block<true>(tab, n_tris, boxes, n, o_obj, d_obj, t_out, i_out);
}

__global__ void __launch_bounds__(THREADS)
mesh_min_kernel(const float* __restrict__ tab, int n_tris, const float* __restrict__ boxes,
                int n, const float* __restrict__ o_obj, const float* __restrict__ d_obj,
                float* __restrict__ t_out) {
  scan_block<false>(tab, n_tris, boxes, n, o_obj, d_obj, t_out, nullptr);
}

}  // namespace

// boxes: [ceil(T / 128), 6] padded chunk boxes, or null for the dense sweep
extern "C" int mesh_nearest_launch(const float* tab, int n_tris, const float* boxes, int n,
                                   const float* o_obj, const float* d_obj, float* t, int* idx,
                                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_nearest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tab, n_tris, boxes, n, o_obj,
                                                                     d_obj, t, idx);
  return (int)cudaGetLastError();
}

extern "C" int mesh_min_launch(const float* tab, int n_tris, const float* boxes, int n,
                               const float* o_obj, const float* d_obj, float* t, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_min_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tab, n_tris, boxes, n, o_obj,
                                                                 d_obj, t);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
