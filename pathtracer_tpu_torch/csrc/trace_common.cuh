// Device functions shared by the kernels (trace.cu, trace_grad.cu,
// bounce.cu, intersect.cu, mesh.cu): the vector helpers, the counter-hash
// RNG, the analytic and triangle intersection, the in-kernel mesh sweep, the
// sampling blocks, one forward bounce and the trace loops' step.  The plain
// PyTorch versions are pathtracer_tpu_torch/ops/{rng,intersect,mesh_tables,
// bounce,trace}.py; this file repeats their arithmetic in the same order
// (built with -fmad=false and without fast math, so a*b+c is not contracted
// and the kernels round as the op-by-op plain versions do).
//
// PT_FN marks a function that the kernels inline (PT_HD one that the host
// launchers call too).  Without nvcc the same
// source compiles as plain C++ (host inline functions), which lets the
// per-lane arithmetic be checked on a machine without a GPU.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define PT_FN __device__ __forceinline__
#define PT_HD __host__ __device__ __forceinline__
#define PT_POPC(x) __popc(x)
#else
#define PT_FN inline
#define PT_HD inline
#define PT_POPC(x) __builtin_popcount(x)
#endif

namespace pt {

constexpr int GCOLS = 14;  // inverse-transform rows 0..2 (12), type, material id
constexpr int MCOLS = 28;  // material table (ops/bounce.py:pack_material_table)
constexpr int LCOLS = 19;  // forward rows 0..2 (12), cdf, emit rgb, axis scales

constexpr float BIG = 1e30f;
constexpr float T_MIN = 1e-4f;
constexpr float RAY_BIAS = 2e-4f;
constexpr float SHADOW_SLACK = (float)(4.0 * 2e-4);
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float SQRT_ONE_THIRD = (float)0.5773502691896257;
constexpr float INV_FOUR_PI = (float)(1.0 / (4.0 * 3.14159265358979323846));
constexpr float FOUR_PI = (float)(4.0 * 3.14159265358979323846);
constexpr float SPHERE = 0.0f;
constexpr float CUBE = 1.0f;
constexpr float HALF_PI = (float)(0.5 * 3.14159265358979323846);
constexpr float PI = (float)3.14159265358979323846;
constexpr float INV_TWO_PI = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr float ONE_MINUS_1E7 = (float)(1.0 - 1e-7);

// the surface feature bits of a launch (ops/trace.py:surface_bits): which of
// the kSurf instance's blocks run, as RenderConfig.features gates them
constexpr int SURF_TEXTURE = 1;
constexpr int SURF_BUMP = 2;
constexpr int SURF_MICROFACET = 4;
constexpr int SURF_WARD = 8;

struct V3 {
  float x, y, z;
};

PT_FN V3 v3(float x, float y, float z) { return V3{x, y, z}; }
PT_FN V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
PT_FN V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
PT_FN V3 vscale(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
PT_FN V3 vmul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
PT_FN float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PT_FN V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
PT_FN V3 vnormalize(V3 a) { return vscale(rsqrtf(fmaxf(vdot(a, a), 1e-24f)), a); }
PT_FN float fsign(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }
PT_FN float comp(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }

// ---- counter-hash RNG (ops/rng.py) ----------------------------------------

PT_FN uint32_t avalanche(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// hash base of one (sample, depth): s_term = sample * 0x85EBCA6B
PT_FN uint32_t bounce_base(uint32_t seed, uint32_t s_term, int dep) {
  return avalanche(seed ^ s_term ^ ((uint32_t)(dep + 1) * 0xC2B2AE35u));
}

PT_FN float uniform(uint32_t base, uint32_t slot) {
  uint32_t bits = avalanche(base ^ (slot * 0x27D4EB2Fu));
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// ---- intersection (ops/intersect.py) --------------------------------------

PT_FN float safe_recip(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x >= 0.0f ? 1e-12f : -1e-12f) : x);
}

PT_FN float sphere_t(V3 o, V3 d) {
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  float b = o.x * d.x + o.y * d.y + o.z * d.z;
  float c = o.x * o.x + o.y * o.y + o.z * o.z - 0.25f;
  float disc = b * b - a * c;
  bool valid = disc > 0.0f;
  float sq = sqrtf(valid ? disc : 1.0f);
  float inv_a = safe_recip(a);
  float t0 = (-b - sq) * inv_a;
  float t1 = (-b + sq) * inv_a;
  float t = t0 > T_MIN ? t0 : t1;
  return (valid && t > T_MIN) ? t : BIG;
}

PT_FN float cube_t(V3 o, V3 d) {
  float ix = safe_recip(d.x), iy = safe_recip(d.y), iz = safe_recip(d.z);
  float tlx = (-0.5f - o.x) * ix, thx = (0.5f - o.x) * ix;
  float tly = (-0.5f - o.y) * iy, thy = (0.5f - o.y) * iy;
  float tlz = (-0.5f - o.z) * iz, thz = (0.5f - o.z) * iz;
  float t_near = fmaxf(fmaxf(fminf(tlx, thx), fminf(tly, thy)), fminf(tlz, thz));
  float t_far = fminf(fminf(fmaxf(tlx, thx), fmaxf(tly, thy)), fmaxf(tlz, thz));
  bool valid = (t_far >= t_near) && (t_far > T_MIN);
  float t = t_near > T_MIN ? t_near : t_far;
  return (valid && t > T_MIN) ? t : BIG;
}

// object-space ray of one geom (its 14 table values)
PT_FN void to_object(const float* m, V3 o, V3 d, V3& oo, V3& od) {
  oo = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
          m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
          m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
  od = v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
          m[4] * d.x + m[5] * d.y + m[6] * d.z,
          m[8] * d.x + m[9] * d.y + m[10] * d.z);
}

PT_FN float geom_t(const float* m, V3 oo, V3 od) {
  if (m[12] == SPHERE) return sphere_t(oo, od);
  if (m[12] == CUBE) return cube_t(oo, od);
  return BIG;  // mesh slots never hit in the analytic sweep
}

// object-space normal at p_obj: the unit sphere's radial direction, the
// cube's argmax-|coord| face
PT_FN V3 object_normal(bool sphere, V3 p_obj) {
  if (sphere) {
    float inv_len = rsqrtf(fmaxf(vdot(p_obj, p_obj), 1e-24f));
    return vscale(inv_len, p_obj);
  }
  float axx = fabsf(p_obj.x), axy = fabsf(p_obj.y), axz = fabsf(p_obj.z);
  bool fx = (axx >= axy) && (axx >= axz);
  bool fy = !fx && (axy >= axz);
  return v3(fx ? fsign(p_obj.x) : 0.0f, fy ? fsign(p_obj.y) : 0.0f,
            (!fx && !fy) ? fsign(p_obj.z) : 0.0f);
}

// world normal before normalization: the inverse transform's transpose
PT_FN V3 world_normal_raw(const float* m, V3 n_obj) {
  return v3(m[0] * n_obj.x + m[4] * n_obj.y + m[8] * n_obj.z,
            m[1] * n_obj.x + m[5] * n_obj.y + m[9] * n_obj.z,
            m[2] * n_obj.x + m[6] * n_obj.y + m[10] * n_obj.z);
}

// ---- triangles (ops/intersect.py:mt_planes, ops/mesh_tables.py) -----------

// Moeller-Trumbore of one triangle whose first 9 floats are (v0, e1, e2):
// t (BIG on a miss) and the barycentrics u, v.  The rows of kernels 9 and 10
// (stride 9) and of the in-kernel tables (stride 12) both start so.
PT_FN float mt_tri(const float* tr, V3 o, V3 d, float& u, float& v) {
  const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
  const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
  const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
  const float hx = d.y * e2z - d.z * e2y;
  const float hy = d.z * e2x - d.x * e2z;
  const float hz = d.x * e2y - d.y * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(a) < 1e-12f ? (a >= 0.0f ? 1e-12f : -1e-12f) : a);
  const float sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (d.x * qx + d.y * qy + d.z * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  const bool ok = fabsf(a) > 1e-12f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                  t > T_MIN;
  return ok ? t : BIG;
}

constexpr int MESH_CHUNK = 32;  // triangles per culling chunk

// The in-kernel tables of a scene's meshes (ops/mesh_tables.KernelMeshes),
// in device memory: n = 0 for none.
struct MeshTables {
  const float* tri;   // [Tp, 12]: v0, e1, e2, face normal
  const float* aabb;  // [C, 6]: chunk box lo, hi
  const float* norm;  // [Tp, 9]: corner normals (zeros where a mesh has no vn)
  const float* uv;    // [Tp, 6]: corner UVs (zeros where a mesh has no vt)
  const int* desc;    // [n, 5]: geom index, chunks, first chunk, has normals, has UVs
  int n;
};
constexpr int MESH_DESC = 5;  // ints per mesh descriptor

// the ray's slab interval meets the chunk box nearer than `best`
PT_FN bool chunk_reaches(const float* box, V3 oo, V3 inv, float best) {
  const float t1x = (box[0] - oo.x) * inv.x, t2x = (box[3] - oo.x) * inv.x;
  const float t1y = (box[1] - oo.y) * inv.y, t2y = (box[4] - oo.y) * inv.y;
  const float t1z = (box[2] - oo.z) * inv.z, t2z = (box[5] - oo.z) * inv.z;
  const float tmin =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fmaxf(fminf(t1z, t2z), T_MIN));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return tmax >= tmin && tmin < best;
}

// A lane's mesh winner: the in-kernel sweep's, or (kernel 2mm) one found
// outside the kernel and read from the merge planes.
struct MeshHit {
  float t;          // BIG: no triangle
  V3 p_obj;         // hit point in the mesh's object space
  V3 normal;        // unit world normal
  int mid;          // material id
  float uv_u, uv_v;  // the authored UV (the deferred texel's)
  bool uv_valid;    // the winner's mesh has authored UVs
};

// A lane's running winner in a nearest-triangle sweep (mesh_sweep's, and
// kernel 2's block sweep in csrc/bounce.cu)
struct SweepBest {
  float best = BIG, bu = 0.0f, bv = 0.0f;
  int bk = -1, brow = 0;
  int uv_row = -1;  // kUV: the last winner whose mesh has UVs
  float uv_bu = 0.0f, uv_bv = 0.0f;
};

// A triangle of mesh k (descriptor ds) at row, or a chunk's first minimum
// over its triangles, with its barycentrics: it wins where strictly below
// the lane's best, so over a chunk's rows in order the first minimum wins.
template <bool kUV>
PT_FN void sweep_take(SweepBest& s, int k, const int* ds, int row, float t, float u, float v) {
  if (!(t < s.best)) return;
  s.best = t;
  s.bk = k;
  s.brow = row;
  s.bu = u;
  s.bv = v;
  if constexpr (kUV) {
    if (ds[4]) {
      s.uv_row = row;
      s.uv_bu = u;
      s.uv_bv = v;
    }
  }
}

// The winner of a triangle sweep shaded once: its hit point in its mesh's
// object space, its unit world normal (the clipped barycentric blend of the
// corner normals, or the face normal, through the geom's inverse
// transpose), its material and with kUV the blended UV of the last winner
// whose mesh has UVs (uv_row, -1 for none).  bk = -1: no triangle.
template <bool kUV>
PT_FN MeshHit mesh_hit(const float* g_tab, const MeshTables& M, V3 o, V3 d,
                       const SweepBest& s) {
  const float best = s.best, bu = s.bu, bv = s.bv, uv_bu = s.uv_bu, uv_bv = s.uv_bv;
  const int bk = s.bk, brow = s.brow, uv_row = s.uv_row;
  MeshHit h;
  h.t = best;
  h.p_obj = v3(0.0f, 0.0f, 0.0f);
  V3 nw = h.p_obj;
  h.mid = 0;
  h.uv_u = h.uv_v = 0.0f;
  h.uv_valid = false;
  if (bk >= 0) {
    const int* ds = M.desc + MESH_DESC * bk;
    const float* m = g_tab + ds[0] * GCOLS;
    V3 oo, od;
    to_object(m, o, d, oo, od);
    h.p_obj = vadd(oo, vscale(best, od));
    V3 n;
    if (ds[3]) {
      const float* nr = M.norm + 9 * brow;
      const float uc = fminf(fmaxf(bu, 0.0f), 1.0f);
      const float vc = fminf(fmaxf(bv, 0.0f), 1.0f);
      const float w0 = fminf(fmaxf(1.0f - uc - vc, 0.0f), 1.0f);
      n = v3(w0 * nr[0] + uc * nr[3] + vc * nr[6], w0 * nr[1] + uc * nr[4] + vc * nr[7],
             w0 * nr[2] + uc * nr[5] + vc * nr[8]);
    } else {
      const float* tr = M.tri + 12 * brow;
      n = v3(tr[9], tr[10], tr[11]);
    }
    nw = world_normal_raw(m, n);
    h.mid = (int)m[13];
    if constexpr (kUV) h.uv_valid = ds[4] != 0;
  }
  if constexpr (kUV) {
    if (uv_row >= 0) {
      const float* ur = M.uv + 6 * uv_row;
      const float uc = fminf(fmaxf(uv_bu, 0.0f), 1.0f);
      const float vc = fminf(fmaxf(uv_bv, 0.0f), 1.0f);
      const float w0 = fminf(fmaxf(1.0f - uc - vc, 0.0f), 1.0f);
      h.uv_u = w0 * ur[0] + uc * ur[2] + vc * ur[4];
      h.uv_v = w0 * ur[1] + uc * ur[3] + vc * ur[5];
    }
  }
  h.normal = vnormalize(nw);
  return h;
}

// The nearest triangle over every mesh (ops/mesh_tables.py:mesh_sweep): per
// mesh the ray in its geom's object space, per chunk the slab test against
// this lane's best, per triangle a strict t < best update, so the first
// minimum in index order wins.  The loop keeps only the winner (mesh, row,
// t, u, v); after it the winner's hit point, its normal (the clipped
// barycentric blend of the corner normals, or the face normal, through the
// geom's inverse transpose, normalized) and its material are computed once,
// from the same values in the same float order as the plain version, which
// computes them at every improvement.  kUV (kernel 2m's want_uv,
// bounce_pallas.py:430-473) also blends the corner UVs of the last winner
// whose mesh has them (a winner whose mesh has none keeps those earlier
// values and clears uv_valid).
template <bool kUV = false>
PT_FN MeshHit mesh_sweep(const float* g_tab, const MeshTables& M, V3 o, V3 d) {
  SweepBest s;
  for (int k = 0; k < M.n; ++k) {
    const int* ds = M.desc + MESH_DESC * k;
    V3 oo, od;
    to_object(g_tab + ds[0] * GCOLS, o, d, oo, od);
    const V3 inv = v3(safe_recip(od.x), safe_recip(od.y), safe_recip(od.z));
    for (int c = ds[2]; c < ds[2] + ds[1]; ++c) {
      if (!chunk_reaches(M.aabb + 6 * c, oo, inv, s.best)) continue;
      // unrolled by 4: 3% faster on smooth_mesh than the default, 9%
      // faster than none (PERF.md, section 6)
#pragma unroll 4
      for (int j = 0; j < MESH_CHUNK; ++j) {
        const int row = c * MESH_CHUNK + j;
        float u, v;
        const float tc = mt_tri(M.tri + 12 * row, oo, od, u, v);
        sweep_take<kUV>(s, k, ds, row, tc, u, v);
      }
    }
  }
  return mesh_hit<kUV>(g_tab, M, o, d, s);
}

// the shadow ray's nearest triangle t (ops/mesh_tables.py:mesh_occ), or the
// first t below `limit` it finds: its caller asks only whether t >= limit,
// and the running minimum only falls, so the sweep stops there
PT_FN float mesh_occ(const float* g_tab, const MeshTables& M, V3 x, V3 wi, float limit) {
  float occ = BIG;
  for (int k = 0; k < M.n; ++k) {
    const int* ds = M.desc + MESH_DESC * k;
    V3 oo, od;
    to_object(g_tab + ds[0] * GCOLS, x, wi, oo, od);
    const V3 inv = v3(safe_recip(od.x), safe_recip(od.y), safe_recip(od.z));
    for (int c = ds[2]; c < ds[2] + ds[1]; ++c) {
      if (!chunk_reaches(M.aabb + 6 * c, oo, inv, occ)) continue;
#pragma unroll 4
      for (int j = 0; j < MESH_CHUNK; ++j) {
        float u, v;
        occ = fminf(occ, mt_tri(M.tri + 12 * (c * MESH_CHUNK + j), oo, od, u, v));
        if (occ < limit) return occ;
      }
    }
  }
  return occ;
}

// volumetric NEE's shadow ray through the triangles, split by each mesh's
// material (ops/mesh_tables.py:mesh_occ_split): a mesh's nearest t, culled
// against that mesh's own running minimum, bounds the attenuated segment
// when the material is refractive (occ_re) and blocks otherwise (occ_op)
PT_FN void mesh_occ_split(const float* g_tab, const float* m_tab, const MeshTables& M, V3 x,
                          V3 wi, float& occ_op, float& occ_re) {
  for (int k = 0; k < M.n; ++k) {
    const int* ds = M.desc + MESH_DESC * k;
    const float* m = g_tab + ds[0] * GCOLS;
    V3 oo, od;
    to_object(m, x, wi, oo, od);
    const V3 inv = v3(safe_recip(od.x), safe_recip(od.y), safe_recip(od.z));
    float mt = BIG;
    for (int c = ds[2]; c < ds[2] + ds[1]; ++c) {
      if (!chunk_reaches(M.aabb + 6 * c, oo, inv, mt)) continue;
      for (int j = 0; j < MESH_CHUNK; ++j) {
        float u, v;
        mt = fminf(mt, mt_tri(M.tri + 12 * (c * MESH_CHUNK + j), oo, od, u, v));
      }
    }
    if (m_tab[(int)m[13] * MCOLS + 7] > 0.0f)
      occ_re = fminf(occ_re, mt);
    else
      occ_op = fminf(occ_op, mt);
  }
}

// ---- sampling blocks (ops/bounce.py) --------------------------------------

PT_FN V3 not_axis_vector(V3 n) {
  bool use_x = fabsf(n.x) < SQRT_ONE_THIRD;
  bool use_y = !use_x && (fabsf(n.y) < SQRT_ONE_THIRD);
  return v3(use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f, (use_x || use_y) ? 0.0f : 1.0f);
}

PT_FN void not_axis_frame(V3 n, V3& p1, V3& p2) {
  V3 not_n = not_axis_vector(n);
  p1 = vnormalize(vcross(n, not_n));
  p2 = vnormalize(vcross(n, p1));
}

PT_FN V3 cosine_hemisphere(V3 n, float xi1, float xi2) {
  float up = sqrtf(xi1);
  float over = sqrtf(fmaxf(1.0f - xi1, 0.0f));
  float around = xi2 * TWO_PI;
  V3 p1, p2;
  not_axis_frame(n, p1, p2);
  return vadd(vscale(up, n),
              vadd(vscale(cosf(around) * over, p1), vscale(sinf(around) * over, p2)));
}

PT_FN V3 rotate_about(V3 axis, float cos_angle, float phi) {
  float sin_angle = sqrtf(fmaxf(1.0f - cos_angle * cos_angle, 0.0f));
  V3 p1, p2;
  not_axis_frame(axis, p1, p2);
  return vadd(vscale(cos_angle, axis),
              vadd(vscale(cosf(phi) * sin_angle, p1), vscale(sinf(phi) * sin_angle, p2)));
}

PT_FN V3 reflect(V3 d_in, V3 n) { return vsub(d_in, vscale(2.0f * vdot(d_in, n), n)); }

struct Scatter {
  V3 origin, direction, thr;
  bool is_specular;
  bool transmitted;  // a dielectric transmission (the medium changes)
  bool entering;     // the ray came from outside
};

// the dielectric's lobe choice (Fresnel reflectance against u2)
PT_FN bool fresnel_reflects(float ior_i, float ior_t, float eta, float cos_i, bool refr_valid,
                            float u2) {
  float f_cos_i = fminf(fmaxf(cos_i, 0.0f), 1.0f);
  float f_sin2t = eta * eta * (1.0f - f_cos_i * f_cos_i);
  bool tir = f_sin2t > 1.0f;
  float f_cos_t = sqrtf(fmaxf(1.0f - f_sin2t, 1e-12f));
  float r_par = (ior_t * f_cos_i - ior_i * f_cos_t) / (ior_t * f_cos_i + ior_i * f_cos_t);
  float r_perp = (ior_i * f_cos_i - ior_t * f_cos_t) / (ior_i * f_cos_i + ior_t * f_cos_t);
  float fres_r = tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
  fres_r = refr_valid ? fres_r : 1.0f;
  return u2 < fres_r;
}

// ---- the optional surface blocks of the kSurf instances (ops/bounce.py) ----

// JAX's integer powers lower to repeated multiplication (x ** 5 is
// x * ((x*x) * (x*x)), x ** 3 is x * (x*x)); Ward's 1 / sqrt is a division,
// not rsqrtf, as there.

// Smith's G1 of the GGX distribution with alpha^2 = a2
PT_FN float smith_g1(float c, float a2) {
  c = fminf(fmaxf(c, 1e-6f), 1.0f);
  return 2.0f * c / (c + sqrtf(a2 + (1.0f - a2) * c * c));
}

// the Cook-Torrance GGX lobe (ops/bounce.py:ggx_planes): direction, weight
PT_FN void ggx_lobe(const float* mat, V3 n, V3 d_in, float cos_i, float u0, float u1, V3& dir,
                    V3& weight) {
  const float alpha = fminf(fmaxf(mat[25] * mat[25], 1e-4f), 1.0f);
  const float a2 = alpha * alpha;
  const float xi1 = fminf(fmaxf(u0, 1e-7f), ONE_MINUS_1E7);
  const float cos_h =
      sqrtf(fminf(fmaxf((1.0f - xi1) / (1.0f + (a2 - 1.0f) * xi1), 0.0f), 1.0f));
  const V3 h = rotate_about(n, cos_h, u1 * TWO_PI);
  dir = reflect(d_in, h);
  const float wo_dot_h = -vdot(d_in, h);
  const float cos_o = vdot(dir, n);
  const bool valid = cos_o > 0.0f && wo_dot_h > 0.0f;
  const float ci = fminf(fmaxf(cos_i, 1e-6f), 1.0f);
  const float g = smith_g1(ci, a2) * smith_g1(cos_o, a2);
  const float x = fmaxf(1.0f - wo_dot_h, 0.0f);
  const float f5 = x * ((x * x) * (x * x));
  const float w = g * wo_dot_h / fmaxf(ci * cos_h, 1e-6f);
  if (valid) {
    weight = v3(w * (mat[3] + (1.0f - mat[3]) * f5), w * (mat[4] + (1.0f - mat[4]) * f5),
                w * (mat[5] + (1.0f - mat[5]) * f5));
  } else {
    const float z = 0.0f * w;
    weight = v3(z, z, z);
  }
}

// the Ward lobe (ops/bounce.py:ward_planes): direction, weight
PT_FN void ward_lobe(const float* mat, V3 n, V3 d_in, float cos_i, float u0, float u1, V3& dir,
                     V3& weight) {
  const float ax_ = fminf(fmaxf(mat[25], 1e-3f), 1.0f);
  const float ay_ = fminf(fmaxf(mat[26] > 0.0f ? mat[26] : mat[25], 1e-3f), 1.0f);
  const float xi1 = fminf(fmaxf(u0, 1e-7f), ONE_MINUS_1E7);
  const float beta = TWO_PI * u1;
  const float cb = cosf(beta), sb = sinf(beta);
  const float d_inv = ax_ * ax_ * cb * cb + ay_ * ay_ * sb * sb;
  const float inv_len = 1.0f / sqrtf(fmaxf(d_inv, 1e-12f));
  const float cos_phi = ax_ * cb * inv_len;
  const float sin_phi = ay_ * sb * inv_len;
  const float tan2 = -logf(xi1) * d_inv;
  const float cos_th = 1.0f / sqrtf(1.0f + tan2);
  const float sin_th = sqrtf(fmaxf(1.0f - cos_th * cos_th, 0.0f));
  V3 t1, t2;
  not_axis_frame(n, t1, t2);
  const V3 h = vadd(vscale(cos_th, n),
                    vadd(vscale(sin_th * cos_phi, t1), vscale(sin_th * sin_phi, t2)));
  dir = reflect(d_in, h);
  const float wi_dot_h = -vdot(d_in, h);
  const float cos_o = vdot(dir, n);
  const bool valid = cos_o > 0.0f && wi_dot_h > 0.0f;
  const float w = wi_dot_h * (cos_th * (cos_th * cos_th)) *
                  sqrtf(fmaxf(cos_o, 0.0f) / fminf(fmaxf(cos_i, 1e-6f), 1.0f));
  if (valid) {
    weight = vscale(w, v3(mat[3], mat[4], mat[5]));
  } else {
    const float z = 0.0f * w;
    weight = v3(z, z, z);
  }
}

// floor-mod by 2 (torch.remainder, jnp.mod): fmodf truncates, so a negative
// cell would give -1
PT_FN float floor_mod2(float x) {
  float m = fmodf(x, 2.0f);
  if (m != 0.0f && m < 0.0f) m += 2.0f;
  return m;
}

// the checker / stripes pattern in the object space picks the second
// colour (image textures, type 3, are the deferred texel's)
PT_FN bool texture_second(const float* mat, V3 p_obj) {
  const float ts = mat[17], tt = mat[16];
  const float cx = floorf(p_obj.x * ts), cy = floorf(p_obj.y * ts), cz = floorf(p_obj.z * ts);
  const float pattern = tt > 1.5f ? floor_mod2(cx) : floor_mod2(cx + cy + cz);
  return tt > 0.5f && tt < 2.5f && pattern > 0.5f;
}

// the checker / stripes albedo
PT_FN V3 texture_albedo(const float* mat, V3 p_obj, V3 color) {
  return texture_second(mat, p_obj) ? v3(mat[18], mat[19], mat[20]) : color;
}

// the sinusoidal bump of the shading normal, on a lane whose bump scale is
// positive
PT_FN V3 bump_normal(const float* mat, V3 p_obj, V3 normal) {
  V3 t1, t2;
  not_axis_frame(normal, t1, t2);
  const float ph1 = p_obj.x * (float)12.9898 + p_obj.y * (float)78.233 + p_obj.z * (float)37.719;
  const float ph2 = p_obj.x * (float)93.989 + p_obj.y * (float)26.651 + p_obj.z * (float)61.312;
  const float amp = mat[22], bs = mat[21];
  return vnormalize(
      vadd(normal, vadd(vscale(amp * sinf(bs * ph1), t1), vscale(amp * sinf(bs * ph2), t2))));
}

// JAX's plane atan2 (ops/bounce.py:atan2_planes): an octant-reduced minimax
// polynomial, not libm
PT_FN float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ay > ax;
  const float r = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float z = r * r;
  const float p =
      r * ((float)0.99997726 +
           z * ((float)-0.33262347 +
                z * ((float)0.19354346 +
                     z * ((float)-0.11643287 + z * ((float)0.05265332 + z * (float)-0.01172120)))));
  float a = swap ? HALF_PI - p : p;
  a = x < 0.0f ? PI - a : a;
  return y < 0.0f ? -a : a;
}

PT_FN float asin_poly(float x) { return atan2_poly(x, sqrtf(fmaxf(1.0f - x * x, 0.0f))); }

// BSDF continuation sample at a non-emissive hit (ops/bounce.py:sample_bsdf)
// with the diffuse albedo `color`.  With kSurf and the microfacet bit of
// `surf`, a reflective lane whose BRDF model is 1 takes the Cook-Torrance
// lobe, 2 (with the Ward bit) the Ward lobe.
template <bool kSurf = false>
PT_FN Scatter sample_bsdf_c(const float* mat, V3 color, V3 p, V3 n_raw, V3 d_in, float u0,
                            float u1, float u2, int surf = 0) {
  float cos_raw = vdot(d_in, n_raw);
  bool entering = cos_raw < 0.0f;
  V3 n = entering ? n_raw : vscale(-1.0f, n_raw);
  float cos_i = fabsf(cos_raw);

  bool is_refractive = mat[7] > 0.0f;
  bool is_reflective = !is_refractive && (mat[6] > 0.0f);
  bool is_ct = false;
  if constexpr (kSurf) is_ct = (surf & SURF_MICROFACET) && is_reflective && mat[24] > 0.5f;
  bool is_glossy = is_reflective && (mat[10] > 0.0f) && !is_ct;

  Scatter s;
  s.is_specular = is_refractive || is_reflective;
  s.transmitted = false;
  s.entering = entering;
  float bias = RAY_BIAS;
  if (is_refractive) {
    V3 d_mirror = reflect(d_in, n);
    float ior = mat[8];
    float ior_i = entering ? 1.0f : ior;
    float ior_t = entering ? ior : 1.0f;
    float eta = ior_i / fmaxf(ior_t, 1e-6f);
    float r_cos_i = -vdot(d_in, n);
    float sin2_t = eta * eta * fmaxf(1.0f - r_cos_i * r_cos_i, 0.0f);
    bool refr_valid = sin2_t <= 1.0f;
    float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-12f));
    V3 d_refr = vnormalize(vadd(vscale(eta, d_in), vscale(eta * r_cos_i - cos_t, n)));
    bool choose_reflect = fresnel_reflects(ior_i, ior_t, eta, cos_i, refr_valid, u2);
    s.direction = choose_reflect ? d_mirror : d_refr;
    s.thr = v3(mat[3], mat[4], mat[5]);
    s.transmitted = !choose_reflect && refr_valid;
    if (s.transmitted) bias = -RAY_BIAS;
  } else if (kSurf && is_ct) {
    if ((surf & SURF_WARD) && mat[24] > 1.5f)
      ward_lobe(mat, n, d_in, cos_i, u0, u1, s.direction, s.thr);
    else
      ggx_lobe(mat, n, d_in, cos_i, u0, u1, s.direction, s.thr);
  } else if (is_glossy) {
    V3 d_mirror = reflect(d_in, n);
    float exp_n = fmaxf(mat[10], 1e-6f);
    float cos_alpha = expf(logf(fmaxf(u0, 1e-9f)) / (exp_n + 1.0f));
    V3 d_glossy = rotate_about(d_mirror, cos_alpha, u1 * TWO_PI);
    float gco = vdot(d_glossy, n);
    float weight =
        gco > 0.0f ? (exp_n + 2.0f) / (exp_n + 1.0f) * fminf(fmaxf(gco, 0.0f), 1.0f) : 0.0f;
    s.direction = d_glossy;
    s.thr = vscale(weight, v3(mat[3], mat[4], mat[5]));
  } else if (is_reflective) {
    s.direction = reflect(d_in, n);
    s.thr = v3(mat[3], mat[4], mat[5]);
  } else {
    s.direction = cosine_hemisphere(n, u0, u1);
    s.thr = color;
  }
  s.origin = vadd(p, vscale(bias, n));
  return s;
}

// the base lobes with the material's own albedo
PT_FN Scatter sample_bsdf(const float* mat, V3 p, V3 n_raw, V3 d_in, float u0, float u1,
                          float u2) {
  return sample_bsdf_c<false>(mat, v3(mat[0], mat[1], mat[2]), p, n_raw, d_in, u0, u1, u2);
}

// the light pick and the object-space point and normal on it
// (ops/bounce.py:sample_lights); the world transforms are applied by the
// callers
PT_FN int sample_light_obj(const float* s_g, const float* s_l, int G, float u0, float u1,
                           float u2, float u3, V3& lp_obj, V3& ln_obj) {
  int lid = 0;
  for (int g = 0; g < G; ++g) lid += (u0 > s_l[g * LCOLS + 12]) ? 1 : 0;
  lid = lid < 0 ? 0 : (lid > G - 1 ? G - 1 : lid);
  const float* L = s_l + lid * LCOLS;
  const float* li = s_g + lid * GCOLS;
  float sx = L[16], sy = L[17], sz = L[18];
  if (li[12] == SPHERE) {
    float z = 1.0f - 2.0f * u2;
    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    float phi = TWO_PI * u3;
    ln_obj = v3(r * cosf(phi), r * sinf(phi), z);
    lp_obj = vscale(0.5f, ln_obj);
  } else {
    float fa0 = 2.0f * sy * sz, fa1 = 2.0f * sx * sz, fa2 = 2.0f * sx * sy;
    float ftot = fmaxf(fa0 + fa1 + fa2, 1e-20f);
    float c0 = fa0 / ftot;
    float c1 = (fa0 + fa1) / ftot;
    int axis = (u1 > c0 ? 1 : 0) + (u1 > c1 ? 1 : 0);
    bool lo = u2 < 0.5f;
    float side = lo ? -0.5f : 0.5f;
    float cc1 = (lo ? u2 * 2.0f : (u2 - 0.5f) * 2.0f) - 0.5f;
    float cc2 = u3 - 0.5f;
    bool ax0 = axis == 0, ax1 = axis == 1, ax2 = axis == 2;
    lp_obj = v3(ax0 ? side : (ax1 ? cc2 : cc1), ax1 ? side : (ax2 ? cc2 : cc1),
                ax2 ? side : (ax0 ? cc2 : cc1));
    float sgn = fsign(side);
    ln_obj = v3(ax0 ? sgn : 0.0f, ax1 ? sgn : 0.0f, ax2 ? sgn : 0.0f);
  }
  return lid;
}

PT_FN V3 light_position(const float* L, V3 lp_obj) {
  return v3(L[0] * lp_obj.x + L[1] * lp_obj.y + L[2] * lp_obj.z + L[3],
            L[4] * lp_obj.x + L[5] * lp_obj.y + L[6] * lp_obj.z + L[7],
            L[8] * lp_obj.x + L[9] * lp_obj.y + L[10] * lp_obj.z + L[11]);
}

// ---- one bounce (ops/bounce.py:bounce_physics) ----------------------------

struct Tables {
  const float* g;  // [G, GCOLS]
  const float* m;  // [M, MCOLS]
  const float* l;  // [G, LCOLS]
  int G;
  float total_area;  // scal[0]
  bool any_light;    // scal[1] > 0.5
  MeshTables mesh;   // the in-kernel triangle sweep; mesh.n = 0 for none
  int surf = 0;      // the surface feature bits (SURF_*) of a kSurf instance
};

// The medium a lane travels through (render/common.py's medium_sigma):
// sigma_a rgb, sigma_s and, with the hg feature, the Henyey-Greenstein g;
// zeros are vacuum.
struct Medium {
  V3 a;
  float s;
  float g;
};

// What one bounce resolves: bounce_physics's outputs plus the two discrete
// outcomes the differentiable trace stores as residuals.
struct Bounce {
  V3 contrib, next_o, next_d, thr_mult;
  bool terminate;  // a miss, or a light hit that no in-medium scatter precedes
  float wspec;     // emit-state code of this bounce's event
  int gid;         // winner geom, -1 on a miss
  bool nee_add;    // the NEE connection counted
  Medium medium;   // the medium the continuation travels through
  float tex_u, tex_v, tex_slot;  // kTex: the deferred texel's scaled UV and atlas slot
  // kMerge under NEE: the deferred shadow ray (x, wi, its length), the
  // pending term and 1 where the candidate clears the analytic geoms
  V3 sh_x, sh_wi, nee_rgb;
  float sh_dist, cand_vis;
};

// The light pick of one bounce (uniforms 4..7): world point, unit normal
// and emitted rgb (ops/bounce.py:sample_lights)
struct LightSample {
  V3 lp, ln, emit;
};

PT_FN LightSample light_sample(const Tables& T, uint32_t base) {
  V3 lp_obj, ln_obj;
  const int lid = sample_light_obj(T.g, T.l, T.G, uniform(base, 4), uniform(base, 5),
                                   uniform(base, 6), uniform(base, 7), lp_obj, ln_obj);
  const float* L = T.l + lid * LCOLS;
  LightSample ls;
  ls.lp = light_position(L, lp_obj);
  ls.ln = vnormalize(world_normal_raw(T.g + lid * GCOLS, ln_obj));
  ls.emit = v3(L[13], L[14], L[15]);
  return ls;
}

// Volumetric NEE's shadow ray, split (ops/intersect.py:occlusion_split_t):
// the nearest refractive geom or mesh bounds the attenuated segment
// (occ_re), the nearest other one blocks (occ_op); BIG for none.
PT_FN void occ_split(const Tables& T, V3 x, V3 wi, float& occ_op, float& occ_re) {
  occ_op = BIG;
  occ_re = BIG;
  for (int g = 0; g < T.G; ++g) {
    const float* m = T.g + g * GCOLS;
    V3 oo, od;
    to_object(m, x, wi, oo, od);
    const float t = geom_t(m, oo, od);
    if (T.m[(int)m[13] * MCOLS + 7] > 0.0f)
      occ_re = fminf(occ_re, t);
    else
      occ_op = fminf(occ_op, t);
  }
  if (T.mesh.n > 0) mesh_occ_split(T.g, T.m, T.mesh, x, wi, occ_op, occ_re);
}

// The analytic nearest hit of a ray, as bounce's sweep finds it: its
// distance (BIG on a miss), winner geom (0 on a miss) and the ray in the
// winner's object space (zeros on a miss).  Kernel 2's grouped kernel
// finds it before its block regroups the lanes, then shades with kShade.
// bounce keeps its own copy of the loop: calling this one from it changed
// the registers ptxas gave the other kernels' instances (2m 72 to 86).
struct Nearest {
  float best_t;
  int gid;
  V3 w_o, w_d;
};

PT_FN Nearest nearest_hit(const Tables& T, V3 o, V3 d) {
  Nearest h{BIG, 0, v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f)};
  for (int g = 0; g < T.G; ++g) {
    const float* m = T.g + g * GCOLS;
    V3 oo, od;
    to_object(m, o, d, oo, od);
    const float t = geom_t(m, oo, od);
    if (t < h.best_t) {
      h.best_t = t;
      h.gid = g;
      h.w_o = oo;
      h.w_d = od;
    }
  }
  return h;
}

// The event a lane's nearest hit gives in 2r-v's instance (kVol, no hg, no
// surface features), the key by which kernel 2's grouped kernel orders a
// block's lanes: EV_ENDS (a miss, or a light hit that no in-medium scatter
// precedes), EV_SCATTER (the free path, bounce's own expression, ends
// first: volumetric NEE's split sweep), and EV_SURFACE + the surface's lobe
// (diffuse, the one that takes the NEE shadow sweep; mirror; Phong glossy;
// glass).  EVENT_KEYS is the count, and the key of a lane past n.
// tools/kernel_split.event_keys counts a wider key over every instance's
// lanes (surface lobes, bump and texture), equal to this one on these.
constexpr int EV_ENDS = 0, EV_SCATTER = 1, EV_SURFACE = 2, EV_LOBES = 4;
constexpr int EVENT_KEYS = EV_SURFACE + EV_LOBES;

PT_FN int event_key(const Tables& T, uint32_t base, const Medium& med, const Nearest& h) {
  const bool hit = h.best_t < BIG;
  if (hit && med.s > 0.0f &&
      -logf(fminf(fmaxf(1.0f - uniform(base, 8), 1e-7f), 1.0f)) / fmaxf(med.s, 1e-12f) <
          h.best_t)
    return EV_SCATTER;
  const float* mat = T.m + (hit ? (int)T.g[h.gid * GCOLS + 13] : 0) * MCOLS;
  if (!hit || mat[9] > 0.0f) return EV_ENDS;
  const int lobe = mat[7] > 0.0f ? 3 : (mat[6] > 0.0f ? (mat[10] > 0.0f ? 2 : 1) : 0);
  return EV_SURFACE + lobe;
}

// One bounce of a lane at depth `dep` with emit state `prev_state`.
//
// kMaskFree = false (the trace loops): a lane that terminates here (miss or
// light hit) returns with only contrib, terminate, gid and nee_add set; the
// continuation is left undefined, since the loop ends the path.
//
// kMaskFree = true (the per-bounce kernel): every output is defined on every
// lane, as in bounce_physics: a miss samples material 0's BSDF at t = 1
// with a zero normal, and a light hit samples the light's own material.
// Only NEE stays gated, as there: it counts on non-emissive hits only.
//
// kVol (the volumetric feature, bounce_pallas.py:1140-1168,1323-1470): an
// exponential free path in the medium `med` (uniform 8) that ends before
// the surface is an in-medium scatter.  It is computed before the emittance:
// a scatter lane is neither counted at a light nor ended by it, takes no
// surface NEE, and continues from the scatter point in an isotropic
// direction (uniforms 9, 10) or, with kHg, a Henyey-Greenstein one about d
// where the medium's g is nonzero.  The segment travelled attenuates the
// throughput (Beer-Lambert) before the emittance and both NEE terms.  With
// vol_nee a scatter lane connects to the light sample through the
// straight-line transmittance: refractive geoms (and meshes) bound the
// attenuated segment, opaque ones block.  A transmission into a material
// takes its medium, out of one returns to vacuum.  kVol = false is vacuum
// transport and compiles to the code without media; `med` passes through.
//
// kSurf (the texture, bump, microfacet and ward features, bounce_pallas.py:
// 645-706,756-783,1054-1074,1121-1138): the blocks T.surf names run, each
// selected per lane on the material columns, in JAX's order: the checker /
// stripes albedo in the winner's object space (the analytic one, or the
// mesh's) before the emittance, the bump of the shading normal before NEE
// and the BSDF, and the Cook-Torrance / Ward lobes in the BSDF.  The albedo
// feeds the emittance, NEE and the diffuse multiplier.  kTex (kernel 2's
// deferred-texel variant, :1076-1119, with kSurf) also writes the
// texture-scaled UV of the hit, from the polynomial atan2, and the atlas slot
// of an image-textured surface event (-1 otherwise); the caller multiplies
// the texel in.  On a mesh lane the UV is the box map of M^T n_world, M the
// forward rows of the lane's analytic winner (geom 0 on an analytic miss,
// as JAX's kernel takes it, :1088-1100), or the authored UV where the
// winner's mesh has one (with in-kernel meshes: kernel 2m's UV sweep).
// Without them the code is the base one.
//
// kMerge (kernel 2's mesh-merge variant, 2mm, :1027-1036,1263-1275,1359):
// the mesh winner `ext` was found outside the kernel and merges in as the
// in-kernel sweep's does.  Under NEE the shadow ray is traced against the
// analytic geoms only, and leaves with its pending term on every lane
// (sh_x, sh_wi, sh_dist, nee_rgb, cand_vis) instead of being added: the
// caller tests the triangles.  Volumetric NEE does not run (its callers
// send such scenes to the split route).
//
// pre (kernel 2's mesh instances, csrc/bounce.cu): the in-kernel sweep's
// winner, found before the bounce by the block's sweep; null runs
// mesh_sweep here.
//
// kShade (kernel 2's grouped kernel, csrc/bounce.cu): the bounce after
// its analytic nearest hit `near`, which nearest_hit found first (no
// meshes); a lane that scatters in the medium skips the BSDF sample, which
// no output of such a lane reads.
template <bool kMaskFree, bool kVol = false, bool kHg = false, bool kSurf = false,
          bool kTex = false, bool kMerge = false, bool kShade = false>
PT_FN Bounce bounce(const Tables& T, uint32_t base, int dep, int nee, V3 o, V3 d, V3 thr,
                    float prev_state, Medium med = Medium{}, int vol_nee = 1,
                    const MeshHit& ext = MeshHit{}, const MeshHit* pre = nullptr,
                    const Nearest* near = nullptr) {
  Bounce b;
  b.contrib = v3(0.0f, 0.0f, 0.0f);
  b.next_o = b.next_d = b.thr_mult = b.contrib;
  b.wspec = 0.0f;
  b.gid = -1;
  b.nee_add = false;
  b.medium = med;

  // ---- nearest hit: the first minimum wins
  float best_t = BIG;
  int gid = 0;
  V3 w_o = v3(0.0f, 0.0f, 0.0f), w_d = w_o;
  if constexpr (kShade) {
    best_t = near->best_t;
    gid = near->gid;
    w_o = near->w_o;
    w_d = near->w_d;
  } else {
  for (int g = 0; g < T.G; ++g) {
    const float* m = T.g + g * GCOLS;
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
  }
  const bool a_hit = best_t < BIG;  // the analytic winner
  // the mesh winner merges in where it is nearer: its distance, material,
  // point and normal win; gid stays the analytic winner's, as in JAX
  MeshHit mh;
  bool mb = false;
  if (kMerge || T.mesh.n > 0) {
    if constexpr (kMerge)
      mh = ext;
    else
      mh = pre != nullptr ? *pre : mesh_sweep<kTex>(T.g, T.mesh, o, d);
    mb = mh.t < best_t;
    if (mb) best_t = mh.t;
  }
  const bool hit = best_t < BIG;
  b.terminate = true;
  if (!kMaskFree && !hit) return b;  // miss: the path ends with nothing added
  if (hit) b.gid = gid;

  const float* gw = T.g + gid * GCOLS;  // geom 0's row on a miss
  const float* mat = T.m + (mb ? mh.mid : (a_hit ? (int)gw[13] : 0)) * MCOLS;
  const bool emissive = mat[9] > 0.0f;
  V3 color = v3(mat[0], mat[1], mat[2]);
  V3 p_obj_s = color;  // kSurf: the winner's object-space hit point
  if constexpr (kSurf) {
    p_obj_s = mb ? mh.p_obj : vadd(w_o, vscale(hit ? best_t : 1.0f, w_d));
    if (T.surf & SURF_TEXTURE) color = texture_albedo(mat, p_obj_s, color);
  }
  if constexpr (kTex) {
    const V3 q = p_obj_s;
    const float u_sph = atan2_poly(q.z, q.x) * INV_TWO_PI + 0.5f;
    const float v_sph = asin_poly(fminf(fmaxf(q.y * 2.0f, -1.0f), 1.0f)) * INV_PI + 0.5f;
    float sx = fabsf(q.x), sy = fabsf(q.y), sz = fabsf(q.z);
    if (mb) {
      // a mesh lane's box map: the dominant axis of M^T n_world
      const float* f = T.l + gid * LCOLS;
      const V3 n = mh.normal;
      sx = fabsf(f[0] * n.x + f[4] * n.y + f[8] * n.z);
      sy = fabsf(f[1] * n.x + f[5] * n.y + f[9] * n.z);
      sz = fabsf(f[2] * n.x + f[6] * n.y + f[10] * n.z);
    }
    const bool ax0 = sx >= sy && sx >= sz;
    const bool ax2 = !ax0 && !(sy >= sz);
    const float u_box = (ax0 ? q.z : q.x) + 0.5f;
    const float v_box = (ax2 ? q.y : (ax0 ? q.y : q.z)) + 0.5f;
    const bool sph = a_hit && gw[12] == SPHERE;
    float uu = sph ? u_sph : u_box, vv = sph ? v_sph : v_box;
    if (mb && mh.uv_valid) {  // the authored vt wins
      uu = mh.uv_u;
      vv = mh.uv_v;
    }
    b.tex_u = uu * mat[17];
    b.tex_v = vv * mat[17];
    b.tex_slot = (mat[16] > 2.5f && hit) ? mat[23] : -1.0f;
  }

  // ---- volumetric free path and the segment's attenuation
  float free_path = BIG;
  bool vol_scatter = false;
  V3 atten = v3(1.0f, 1.0f, 1.0f);
  if (kVol) {
    if (med.s > 0.0f)
      free_path = -logf(fminf(fmaxf(1.0f - uniform(base, 8), 1e-7f), 1.0f)) / fmaxf(med.s, 1e-12f);
    vol_scatter = hit && free_path < best_t;
    if (kTex && vol_scatter) b.tex_slot = -1.0f;  // no surface event this bounce
    const float seg = vol_scatter ? free_path : (hit ? best_t : 0.0f);
    atten = v3(expf(-med.a.x * seg), expf(-med.a.y * seg), expf(-med.a.z * seg));
    thr = vmul(thr, atten);
  }

  if (hit && emissive && !vol_scatter) {
    // light hit: counted on primary rays and after specular events with
    // NEE, always without
    bool count = !nee || dep == 0 || fabsf(prev_state - 1.0f) < 0.5f;
    if (count) b.contrib = vscale(mat[9], vmul(thr, color));
  }
  b.terminate = !hit || (emissive && !vol_scatter);
  if (!kMaskFree && b.terminate) return b;

  const float t_safe = hit ? best_t : 1.0f;
  const V3 p = vadd(o, vscale(t_safe, d));
  V3 normal;
  if (mb) {
    normal = mh.normal;
  } else {
    const V3 p_obj = vadd(w_o, vscale(t_safe, w_d));
    const V3 n_obj = object_normal(a_hit && gw[12] == SPHERE, p_obj);
    normal = vnormalize(world_normal_raw(gw, n_obj));
  }
  if constexpr (kSurf) {
    if ((T.surf & SURF_BUMP) && mat[21] > 0.0f) normal = bump_normal(mat, p_obj_s, normal);
  }

  const Scatter sc = kShade && vol_scatter
                         ? Scatter{}
                         : sample_bsdf_c<kSurf>(mat, color, p, normal, d, uniform(base, 0),
                                                uniform(base, 1), uniform(base, 2), T.surf);

  // ---- next-event estimation at diffuse surface hits
  if constexpr (kMerge) {
    // every lane's shadow ray and pending term leave (mask-free); the
    // triangles' occlusion is the caller's
    if (nee) {
      const LightSample ls = light_sample(T, base);
      const V3 n_shade = vscale(fsign(-vdot(normal, d)), normal);
      const V3 x = vadd(p, vscale(RAY_BIAS, n_shade));
      const V3 to_light = vsub(ls.lp, x);
      const float dist2 = vdot(to_light, to_light);
      const float dist = sqrtf(fmaxf(dist2, 1e-12f));
      const V3 wi = vscale(1.0f / dist, to_light);
      const float cos_x = vdot(n_shade, wi);
      const float cos_y = -vdot(ls.ln, wi);
      bool cand = hit && !emissive && !sc.is_specular && !vol_scatter && T.any_light &&
                  cos_x > 0.0f && cos_y > 0.0f;
      if (cand) {
        float occ_t = BIG;
        for (int g = 0; g < T.G; ++g) {
          const float* m = T.g + g * GCOLS;
          V3 oo, od;
          to_object(m, x, wi, oo, od);
          occ_t = fminf(occ_t, geom_t(m, oo, od));
        }
        cand = occ_t >= dist - SHADOW_SLACK;
      }
      const float pdf_area = 1.0f / fmaxf(T.total_area, 1e-20f);
      const float gterm = cos_x * cos_y / fmaxf(dist2, 1e-12f);
      const float nee_scale = gterm / fmaxf(pdf_area, 1e-20f) * INV_PI;
      b.sh_x = x;
      b.sh_wi = wi;
      b.sh_dist = dist;
      b.nee_rgb = vscale(nee_scale, vmul(vmul(thr, color), ls.emit));
      b.cand_vis = cand ? 1.0f : 0.0f;
    }
  } else if (nee && hit && !emissive && !sc.is_specular && !vol_scatter && T.any_light) {
    const LightSample ls = light_sample(T, base);
    const V3 n_shade = vscale(fsign(-vdot(normal, d)), normal);
    const V3 x = vadd(p, vscale(RAY_BIAS, n_shade));
    const V3 to_light = vsub(ls.lp, x);
    const float dist2 = vdot(to_light, to_light);
    const float dist = sqrtf(fmaxf(dist2, 1e-12f));
    const V3 wi = vscale(1.0f / dist, to_light);
    const float cos_x = vdot(n_shade, wi);
    const float cos_y = -vdot(ls.ln, wi);
    if (cos_x > 0.0f && cos_y > 0.0f) {
      float occ_t = BIG;
      for (int g = 0; g < T.G; ++g) {
        const float* m = T.g + g * GCOLS;
        V3 oo, od;
        to_object(m, x, wi, oo, od);
        occ_t = fminf(occ_t, geom_t(m, oo, od));
      }
      // min(analytic, mesh) clears the bar only if both do: the triangles
      // are swept only for a shadow ray the analytic geoms leave clear
      if (T.mesh.n > 0 && occ_t >= dist - SHADOW_SLACK)
        occ_t = fminf(occ_t, mesh_occ(T.g, T.mesh, x, wi, dist - SHADOW_SLACK));
      if (occ_t >= dist - SHADOW_SLACK) {
        const float pdf_area = 1.0f / fmaxf(T.total_area, 1e-20f);
        float gterm = cos_x * cos_y / fmaxf(dist2, 1e-12f);
        float nee_scale = gterm / fmaxf(pdf_area, 1e-20f) * INV_PI;
        b.contrib = vadd(b.contrib, vscale(nee_scale, vmul(vmul(thr, color), ls.emit)));
        b.nee_add = true;
      }
    }
  }

  b.next_o = sc.origin;
  b.next_d = sc.direction;
  b.thr_mult = sc.thr;
  b.wspec = sc.is_specular ? (fabsf(prev_state - 2.0f) < 0.5f ? 2.0f : 1.0f) : 0.0f;
  if (!kVol) return b;

  if (!vol_scatter) {
    // a surface event: its multiplier after the attenuation; a
    // transmission enters the material's medium or leaves to vacuum
    b.thr_mult = vmul(atten, sc.thr);
    if (sc.transmitted) {
      const bool in = sc.entering;
      b.medium.a = in ? v3(mat[11], mat[12], mat[13]) : v3(0.0f, 0.0f, 0.0f);
      b.medium.s = in ? mat[14] * mat[15] : 0.0f;
      b.medium.g = in ? mat[27] : 0.0f;
    }
    return b;
  }

  // ---- in-medium scatter: the continuation leaves the scatter point in
  // the same medium
  const V3 vol_pos = vadd(o, vscale(free_path, d));
  const float u9 = uniform(base, 9);
  const float vz = 1.0f - 2.0f * u9;
  const float vr = sqrtf(fmaxf(1.0f - vz * vz, 0.0f));
  const float vphi = TWO_PI * uniform(base, 10);
  V3 vol_dir = v3(vr * cosf(vphi), vr * sinf(vphi), vz);
  const float g_c = fminf(fmaxf(med.g, -0.999f), 0.999f);
  if (kHg && med.g != 0.0f) {
    // Henyey-Greenstein about d (ops/bsdf.py:henyey_greenstein); g == 0
    // keeps the uniform sphere's sample
    const bool near0 = fabsf(g_c) < 1e-3f;
    const float safe_g = near0 ? 1.0f : g_c;
    const float frac = (1.0f - g_c * g_c) / (1.0f - g_c + 2.0f * g_c * u9);
    const float cos_hg = (1.0f + g_c * g_c - frac * frac) / (2.0f * safe_g);
    const float cos_t = fminf(fmaxf(near0 ? 1.0f - 2.0f * u9 : cos_hg, -1.0f), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    V3 t1, t2;
    not_axis_frame(d, t1, t2);
    vol_dir = vadd(vscale(cos_t, d),
                   vadd(vscale(sin_t * cosf(vphi), t1), vscale(sin_t * sinf(vphi), t2)));
  }

  // ---- volumetric NEE: the light sample connected to the scatter point
  float vol_state = 1.0f;
  if (!kMerge && nee && vol_nee && T.any_light) {
    const LightSample ls = light_sample(T, base);
    const V3 to_l = vsub(ls.lp, vol_pos);
    const float d2v = vdot(to_l, to_l);
    const float distv = sqrtf(fmaxf(d2v, 1e-12f));
    const V3 wiv = vscale(1.0f / distv, to_l);
    const float cos_yv = -vdot(ls.ln, wiv);
    if (cos_yv > 0.0f) {
      float occ_op, occ_re;
      occ_split(T, vol_pos, wiv, occ_op, occ_re);
      if (occ_op >= distv - SHADOW_SLACK) {
        const float seg_v = fminf(occ_re, distv);
        const V3 transmit = v3(expf(-(med.a.x + med.s) * seg_v), expf(-(med.a.y + med.s) * seg_v),
                               expf(-(med.a.z + med.s) * seg_v));
        float phase = INV_FOUR_PI;
        if (kHg) {
          const float cos_th = vdot(d, wiv);
          const float denomp = fmaxf(1.0f + g_c * g_c - 2.0f * g_c * cos_th, 1e-6f);
          phase = (1.0f - g_c * g_c) / (FOUR_PI * denomp * sqrtf(denomp));
        }
        const float pdf_area_v = 1.0f / fmaxf(T.total_area, 1e-20f);
        const float scale_v = phase * cos_yv / fmaxf(d2v, 1e-12f) / fmaxf(pdf_area_v, 1e-20f);
        b.contrib = vadd(b.contrib, vscale(scale_v, vmul(vmul(thr, transmit), ls.emit)));
        vol_state = 2.0f;  // the next specular chain does not count the light again
      }
    }
  }
  b.next_o = vol_pos;
  b.next_d = vol_dir;
  b.thr_mult = atten;
  b.wspec = vol_state;
  return b;
}

// ---- the trace loops' step (ops/trace.py:step_update) ----------------------

// One bounce of an alive lane.  Updates the carries (o, d, thr, prev_state,
// and with kVol the medium *med) and the radiance; clears `alive` when the
// path ends, leaving the carries as they were at its death (a
// russian-roulette death keeps the rescaled throughput, as the plain
// step_update does).  Reports the winner geom (-1 on a miss) and whether the
// NEE connection counted: the residuals of the differentiable trace.
template <bool kVol = false, bool kHg = false, bool kSurf = false>
PT_FN void bounce_step(const Tables& T, uint32_t base, int dep, int nee, int rr, int rr_start,
                       V3& o, V3& d, V3& thr, float& prev_state, V3& rad, bool& alive,
                       int& gid_out, bool& nee_add, Medium* med = nullptr, int vol_nee = 1) {
  Medium m_in{};
  if constexpr (kVol) m_in = *med;
  const Bounce b = bounce<false, kVol, kHg, kSurf>(T, base, dep, nee, o, d, thr, prev_state,
                                                   m_in, vol_nee);
  gid_out = b.gid;
  nee_add = b.nee_add;
  rad = vadd(rad, b.contrib);  // + 0 where nothing counted: exact
  if (b.terminate) {
    alive = false;
    return;
  }

  // ---- continuation, russian roulette
  thr = vmul(thr, b.thr_mult);
  if (rr && dep >= rr_start) {
    float p_rr = fminf(fmaxf(fmaxf(fmaxf(thr.x, thr.y), thr.z), 0.05f), 1.0f);
    bool survive = uniform(base, 3) < p_rr;
    float inv_p = 1.0f / p_rr;
    thr = vscale(inv_p, thr);
    if (!survive) {
      alive = false;
      return;
    }
  }
  o = b.next_o;
  d = b.next_d;
  prev_state = b.wspec;
  if constexpr (kVol) *med = b.medium;
}

}  // namespace pt
