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
//
// What bounds it on the H100: operations, not bytes.  A lane reads 28 bytes
// (origin, direction, sample) and writes 12, about 26 MB per 640,000-lane
// iteration (~8 us at 3.35 TB/s), while every bounce costs two sweeps over
// all geoms (nearest hit and shadow ray) of roughly 50-70 fp32 operations
// per geom.  The loop is branchy and divergent (a warp runs the union of
// its lanes' material branches and lives as long as its longest path);
// this first kernel accepts that and keeps registers, not memory, as the
// working set.  Sorting lanes by material or compacting live lanes is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr float SPHERE = 0.0f;
constexpr float CUBE = 1.0f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 vscale(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 vmul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  return vscale(rsqrtf(fmaxf(vdot(a, a), 1e-24f)), a);
}
__device__ __forceinline__ float fsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ---- counter-hash RNG (ops/rng.py) ----------------------------------------

__device__ __forceinline__ uint32_t avalanche(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t base, uint32_t slot) {
  uint32_t bits = avalanche(base ^ (slot * 0x27D4EB2Fu));
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// ---- intersection (ops/intersect.py) --------------------------------------

__device__ __forceinline__ float safe_recip(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x >= 0.0f ? 1e-12f : -1e-12f) : x);
}

__device__ __forceinline__ float sphere_t(V3 o, V3 d) {
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

__device__ __forceinline__ float cube_t(V3 o, V3 d) {
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
__device__ __forceinline__ void to_object(const float* m, V3 o, V3 d, V3& oo, V3& od) {
  oo = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
          m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
          m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
  od = v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
          m[4] * d.x + m[5] * d.y + m[6] * d.z,
          m[8] * d.x + m[9] * d.y + m[10] * d.z);
}

__device__ __forceinline__ float geom_t(const float* m, V3 oo, V3 od) {
  if (m[12] == SPHERE) return sphere_t(oo, od);
  if (m[12] == CUBE) return cube_t(oo, od);
  return BIG;  // mesh slots never hit in the analytic sweep
}

// ---- sampling blocks (ops/bounce.py) --------------------------------------

__device__ __forceinline__ void not_axis_frame(V3 n, V3& p1, V3& p2) {
  bool use_x = fabsf(n.x) < SQRT_ONE_THIRD;
  bool use_y = !use_x && (fabsf(n.y) < SQRT_ONE_THIRD);
  V3 not_n = v3(use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f, (use_x || use_y) ? 0.0f : 1.0f);
  p1 = vnormalize(vcross(n, not_n));
  p2 = vnormalize(vcross(n, p1));
}

__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float xi1, float xi2) {
  float up = sqrtf(xi1);
  float over = sqrtf(fmaxf(1.0f - xi1, 0.0f));
  float around = xi2 * TWO_PI;
  V3 p1, p2;
  not_axis_frame(n, p1, p2);
  return vadd(vscale(up, n),
              vadd(vscale(cosf(around) * over, p1), vscale(sinf(around) * over, p2)));
}

__device__ __forceinline__ V3 rotate_about(V3 axis, float cos_angle, float phi) {
  float sin_angle = sqrtf(fmaxf(1.0f - cos_angle * cos_angle, 0.0f));
  V3 p1, p2;
  not_axis_frame(axis, p1, p2);
  return vadd(vscale(cos_angle, axis),
              vadd(vscale(cosf(phi) * sin_angle, p1), vscale(sinf(phi) * sin_angle, p2)));
}

struct Scatter {
  V3 origin, direction, thr;
  bool is_specular;
};

// BSDF continuation sample at a non-emissive hit (ops/bounce.py:sample_bsdf)
__device__ __forceinline__ Scatter sample_bsdf(const float* mat, V3 p, V3 n_raw, V3 d_in,
                                               float u0, float u1, float u2) {
  float cos_raw = vdot(d_in, n_raw);
  bool entering = cos_raw < 0.0f;
  V3 n = entering ? n_raw : vscale(-1.0f, n_raw);
  float cos_i = fabsf(cos_raw);

  bool is_refractive = mat[7] > 0.0f;
  bool is_reflective = !is_refractive && (mat[6] > 0.0f);
  bool is_glossy = is_reflective && (mat[10] > 0.0f);

  Scatter s;
  s.is_specular = is_refractive || is_reflective;
  float bias = RAY_BIAS;
  if (is_refractive) {
    V3 d_mirror = vsub(d_in, vscale(2.0f * vdot(d_in, n), n));
    float ior = mat[8];
    float ior_i = entering ? 1.0f : ior;
    float ior_t = entering ? ior : 1.0f;
    float eta = ior_i / fmaxf(ior_t, 1e-6f);
    float r_cos_i = -vdot(d_in, n);
    float sin2_t = eta * eta * fmaxf(1.0f - r_cos_i * r_cos_i, 0.0f);
    bool refr_valid = sin2_t <= 1.0f;
    float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-12f));
    V3 d_refr = vnormalize(vadd(vscale(eta, d_in), vscale(eta * r_cos_i - cos_t, n)));
    float f_cos_i = fminf(fmaxf(cos_i, 0.0f), 1.0f);
    float f_sin2t = eta * eta * (1.0f - f_cos_i * f_cos_i);
    bool tir = f_sin2t > 1.0f;
    float f_cos_t = sqrtf(fmaxf(1.0f - f_sin2t, 1e-12f));
    float r_par = (ior_t * f_cos_i - ior_i * f_cos_t) / (ior_t * f_cos_i + ior_i * f_cos_t);
    float r_perp = (ior_i * f_cos_i - ior_t * f_cos_t) / (ior_i * f_cos_i + ior_t * f_cos_t);
    float fres_r = tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
    fres_r = refr_valid ? fres_r : 1.0f;
    bool choose_reflect = u2 < fres_r;
    s.direction = choose_reflect ? d_mirror : d_refr;
    s.thr = v3(mat[3], mat[4], mat[5]);
    if (!choose_reflect && refr_valid) bias = -RAY_BIAS;
  } else if (is_glossy) {
    V3 d_mirror = vsub(d_in, vscale(2.0f * vdot(d_in, n), n));
    float exp_n = fmaxf(mat[10], 1e-6f);
    float cos_alpha = expf(logf(fmaxf(u0, 1e-9f)) / (exp_n + 1.0f));
    V3 d_glossy = rotate_about(d_mirror, cos_alpha, u1 * TWO_PI);
    float gco = vdot(d_glossy, n);
    float weight =
        gco > 0.0f ? (exp_n + 2.0f) / (exp_n + 1.0f) * fminf(fmaxf(gco, 0.0f), 1.0f) : 0.0f;
    s.direction = d_glossy;
    s.thr = vscale(weight, v3(mat[3], mat[4], mat[5]));
  } else if (is_reflective) {
    s.direction = vsub(d_in, vscale(2.0f * vdot(d_in, n), n));
    s.thr = v3(mat[3], mat[4], mat[5]);
  } else {
    s.direction = cosine_hemisphere(n, u0, u1);
    s.thr = v3(mat[0], mat[1], mat[2]);
  }
  s.origin = vadd(p, vscale(bias, n));
  return s;
}

// area-weighted light point (ops/bounce.py:sample_lights): world position,
// normal and emitted rgb of the picked light
__device__ __forceinline__ void sample_light(const float* s_g, const float* s_l, int G,
                                             float u0, float u1, float u2, float u3,
                                             V3& lp, V3& ln, V3& emit) {
  int lid = 0;
  for (int g = 0; g < G; ++g) lid += (u0 > s_l[g * LCOLS + 12]) ? 1 : 0;
  lid = min(max(lid, 0), G - 1);
  const float* L = s_l + lid * LCOLS;
  const float* li = s_g + lid * GCOLS;
  emit = v3(L[13], L[14], L[15]);
  float sx = L[16], sy = L[17], sz = L[18];

  V3 lp_obj, ln_obj;
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
  lp = v3(L[0] * lp_obj.x + L[1] * lp_obj.y + L[2] * lp_obj.z + L[3],
          L[4] * lp_obj.x + L[5] * lp_obj.y + L[6] * lp_obj.z + L[7],
          L[8] * lp_obj.x + L[9] * lp_obj.y + L[10] * lp_obj.z + L[11]);
  ln = vnormalize(v3(li[0] * ln_obj.x + li[4] * ln_obj.y + li[8] * ln_obj.z,
                     li[1] * ln_obj.x + li[5] * ln_obj.y + li[9] * ln_obj.z,
                     li[2] * ln_obj.x + li[6] * ln_obj.y + li[10] * ln_obj.z));
}

__global__ void __launch_bounds__(128)
trace_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
             const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
             const float* __restrict__ origin, const float* __restrict__ direction,
             const uint32_t* __restrict__ sample, int n, float* __restrict__ radiance,
             unsigned long long* __restrict__ nrays, int max_depth, int nee, int rr,
             int rr_start) {
  extern __shared__ float smem[];
  float* s_g = smem;
  float* s_m = s_g + G * GCOLS;
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) s_g[i] = gtab[i];
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const float total_area = scal[0];
  const bool any_light = scal[1] > 0.5f;
  const float pdf_area = 1.0f / fmaxf(total_area, 1e-20f);

  bool alive = idx < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  uint32_t s = 0;
  if (alive) {
    o = v3(origin[3 * idx], origin[3 * idx + 1], origin[3 * idx + 2]);
    d = v3(direction[3 * idx], direction[3 * idx + 1], direction[3 * idx + 2]);
    s = sample[idx];
  }
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  float prev_state = 0.0f;
  unsigned int bounces = 0;
  const uint32_t s_term = s * 0x85EBCA6Bu;

  for (int dep = 0; dep < max_depth && alive; ++dep) {
    ++bounces;
    const uint32_t base = avalanche(seed ^ s_term ^ ((uint32_t)(dep + 1) * 0xC2B2AE35u));

    // ---- nearest hit: the first minimum wins
    float best_t = BIG;
    int gid = 0;
    V3 w_o = v3(0.0f, 0.0f, 0.0f), w_d = w_o;
    for (int g = 0; g < G; ++g) {
      const float* m = s_g + g * GCOLS;
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
    if (!(best_t < BIG)) break;  // miss: the path ends with nothing added

    const float* gw = s_g + gid * GCOLS;
    const float* mat = s_m + (int)gw[13] * MCOLS;
    const bool emissive = mat[9] > 0.0f;
    const V3 color = v3(mat[0], mat[1], mat[2]);
    if (emissive) {
      // light hit: counted on primary rays and after specular events with
      // NEE, always without; the path ends here
      bool count = !nee || dep == 0 || fabsf(prev_state - 1.0f) < 0.5f;
      if (count) rad = vadd(rad, vscale(mat[9], vmul(thr, color)));
      break;
    }

    const float t_safe = best_t;
    const V3 p = vadd(o, vscale(t_safe, d));
    const V3 p_obj = vadd(w_o, vscale(t_safe, w_d));
    V3 n_obj;
    if (gw[12] == SPHERE) {
      float inv_len = rsqrtf(fmaxf(vdot(p_obj, p_obj), 1e-24f));
      n_obj = vscale(inv_len, p_obj);
    } else {
      float axx = fabsf(p_obj.x), axy = fabsf(p_obj.y), axz = fabsf(p_obj.z);
      bool fx = (axx >= axy) && (axx >= axz);
      bool fy = !fx && (axy >= axz);
      n_obj = v3(fx ? fsign(p_obj.x) : 0.0f, fy ? fsign(p_obj.y) : 0.0f,
                 (!fx && !fy) ? fsign(p_obj.z) : 0.0f);
    }
    const V3 normal = vnormalize(v3(gw[0] * n_obj.x + gw[4] * n_obj.y + gw[8] * n_obj.z,
                                    gw[1] * n_obj.x + gw[5] * n_obj.y + gw[9] * n_obj.z,
                                    gw[2] * n_obj.x + gw[6] * n_obj.y + gw[10] * n_obj.z));

    const Scatter sc = sample_bsdf(mat, p, normal, d, uniform(base, 0), uniform(base, 1),
                                   uniform(base, 2));

    // ---- next-event estimation at diffuse hits
    if (nee && !sc.is_specular && any_light) {
      V3 lp, ln, emit;
      sample_light(s_g, s_l, G, uniform(base, 4), uniform(base, 5), uniform(base, 6),
                   uniform(base, 7), lp, ln, emit);
      const V3 n_shade = vscale(fsign(-vdot(normal, d)), normal);
      const V3 x = vadd(p, vscale(RAY_BIAS, n_shade));
      const V3 to_light = vsub(lp, x);
      const float dist2 = vdot(to_light, to_light);
      const float dist = sqrtf(fmaxf(dist2, 1e-12f));
      const V3 wi = vscale(1.0f / dist, to_light);
      const float cos_x = vdot(n_shade, wi);
      const float cos_y = -vdot(ln, wi);
      if (cos_x > 0.0f && cos_y > 0.0f) {
        float occ_t = BIG;
        for (int g = 0; g < G; ++g) {
          const float* m = s_g + g * GCOLS;
          V3 oo, od;
          to_object(m, x, wi, oo, od);
          occ_t = fminf(occ_t, geom_t(m, oo, od));
        }
        if (occ_t >= dist - SHADOW_SLACK) {
          float gterm = cos_x * cos_y / fmaxf(dist2, 1e-12f);
          float nee_scale = gterm / fmaxf(pdf_area, 1e-20f) * INV_PI;
          rad = vadd(rad, vscale(nee_scale, vmul(vmul(thr, color), emit)));
        }
      }
    }

    // ---- continuation, russian roulette
    thr = vmul(thr, sc.thr);
    if (rr && dep >= rr_start) {
      float p_rr = fminf(fmaxf(fmaxf(fmaxf(thr.x, thr.y), thr.z), 0.05f), 1.0f);
      bool survive = uniform(base, 3) < p_rr;
      float inv_p = 1.0f / p_rr;
      thr = vscale(inv_p, thr);
      if (!survive) break;
    }
    o = sc.origin;
    d = sc.direction;
    prev_state = sc.is_specular ? (fabsf(prev_state - 2.0f) < 0.5f ? 2.0f : 1.0f) : 0.0f;
  }

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

}  // namespace

extern "C" int trace_launch(const float* gtab, int G, const float* mtab, int M,
                            const float* ltab, const float* scal, unsigned int seed,
                            const float* origin, const float* direction,
                            const unsigned int* sample, int n, float* radiance,
                            unsigned long long* nrays, int max_depth, int nee, int rr,
                            int rr_start, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = sizeof(float) * (size_t)(G * GCOLS + M * MCOLS + G * LCOLS);
  trace_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, origin, direction, sample, n, radiance, nrays,
      max_depth, nee, rr, rr_start);
  return (int)cudaGetLastError();
}
