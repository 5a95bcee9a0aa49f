// Full-depth differentiable trace for Hopper (sm_90a): the forward with
// residuals and the reverse loop.
//
// Replaces the TPU kernels pathtracer_tpu/ops/trace_grad.py:_tfwd_kernel
// (launched by _tfwd_call) and _tbwd_kernel (launched by _tbwd_call).  The
// plain PyTorch versions are pathtracer_tpu_torch/ops/trace_grad.py:
// tfwd_plain and tbwd_plain.
//
// trace_fwd_kernel: csrc/trace.cu's loop (the same pt::bounce_step, so its
// radiance and ray count equal the trace kernel's bit for bit), and at
// every bounce the lane's carries entering the bounce and the two discrete
// outcomes the bounce resolved, stored lane-contiguous as resid[depth][13][n]
// (planes o(3) d(3) thr(3) prev_state alive gid nee_add).  A lane that has
// died stores the carries it died with, alive 0, gid -1 and NEE bit 0.
// The scenes are vacuum: no medium carries are stored.
//
// trace_bwd_kernel: one thread per lane walks the bounces from depth-1 down
// to 0.  A dead bounce is the identity on the carry cotangents and adds
// nothing to the tables, so it is skipped.  For a live bounce it reloads
// the residuals, recomputes the bounce with the winner replayed (no sweep,
// no shadow ray: both are comparisons and carry no cotangent) and runs the
// hand-written adjoint of bounce_physics(replay) and step_update: the
// winner's sphere quadratic or cube slab, hit and object point, the sphere
// and cube normals, the inverse-transpose normal and its rsqrt normalize,
// the emission under the emit-state code, the sampled directions (Lambert
// through the tangent frame, mirror, Phong glossy, Fresnel dielectric), the
// NEE connection (light position, light normal, emission, total area) and
// the russian-roulette multiply with p detached.  Only the branch the lane
// took is differentiated, so the unselected branches' 0 * inf of a
// where-graph cannot appear.  Ties of min/max split the cotangent in half
// and clamps pass it at their bounds, as torch's autograd does.  The table
// cotangents of a block's lanes go into a shared-memory row with float
// atomics (their order within the block is not fixed: the row varies in
// its last bits from run to run); trace_bwd_reduce then sums the per-block
// rows in block order.
//
// What bounds them on the H100: the forward moves 40 B per lane plus 52 B
// per lane and bounce of residuals (266 MB per 640,000-lane iteration at
// depth 8, ~0.08 ms at 3.35 TB/s) against the trace kernel's two sweeps per
// bounce.  The reverse reads the alive plane of every bounce and the other
// 12 planes of a live one, and replays one intersection per live bounce,
// but its adjoint is several times the forward's shading arithmetic, and
// its shared-memory atomics serialize where a block's lanes hit the same
// geom.  This first version keeps the bounce loop rolled and the state in
// registers; ptxas reports its registers and spills in chip_smoke.py's
// build phase.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

constexpr int N_RESID = 13;
constexpr int R_O = 0, R_D = 3, R_THR = 6, R_STATE = 9, R_ALIVE = 10, R_GID = 11, R_NEE = 12;

// offsets of the tables in the flat cotangent row
struct RowLayout {
  int om, ol, os, k;  // material, light, scalars, total length (geoms at 0)
};

PT_HD RowLayout row_layout(int G, int M) {
  RowLayout r;
  r.om = G * GCOLS;
  r.ol = r.om + M * MCOLS;
  r.os = r.ol + G * LCOLS;
  r.k = r.os + 2;
  return r;
}

PT_FN void acc_add(float* acc, int i, float v) {
#ifdef __CUDA_ARCH__
  atomicAdd(acc + i, v);
#else
  acc[i] += v;
#endif
}

// ---- forward with residuals -----------------------------------------------

PT_FN void fwd_lane(const Tables& T, uint32_t seed, uint32_t s, V3 o, V3 d, int max_depth,
                    int nee, int rr, int rr_start, bool valid, float* resid, size_t n,
                    size_t idx, V3& rad, unsigned int& bounces) {
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  float prev_state = 0.0f;
  bool alive = valid;
  const uint32_t s_term = s * 0x85EBCA6Bu;
  for (int dep = 0; dep < max_depth; ++dep) {
    int gid = -1;
    bool nee_add = false;
    float* r = resid + (size_t)dep * N_RESID * n + idx;
    if (valid) {
      r[(R_O + 0) * n] = o.x;
      r[(R_O + 1) * n] = o.y;
      r[(R_O + 2) * n] = o.z;
      r[(R_D + 0) * n] = d.x;
      r[(R_D + 1) * n] = d.y;
      r[(R_D + 2) * n] = d.z;
      r[(R_THR + 0) * n] = thr.x;
      r[(R_THR + 1) * n] = thr.y;
      r[(R_THR + 2) * n] = thr.z;
      r[R_STATE * n] = prev_state;
      r[R_ALIVE * n] = alive ? 1.0f : 0.0f;
    }
    if (alive) {
      ++bounces;
      bounce_step(T, bounce_base(seed, s_term, dep), dep, nee, rr, rr_start, o, d, thr,
                  prev_state, rad, alive, gid, nee_add);
    }
    if (valid) {
      r[R_GID * n] = (float)gid;
      r[R_NEE * n] = nee_add ? 1.0f : 0.0f;
    }
  }
}

// ---- adjoint helpers ------------------------------------------------------
//
// The forward values are recomputed in float, exactly as the forward ran
// (autograd differentiates at those very values); the adjoint's products
// and sums run in double.  The float32 gradient of a path is
// ill-conditioned on a few lanes (large terms that cancel); in double the
// kernel's own rounding drops out.  Its reference is tbwd_plain with
// dtype=float64: float64 autograd at the float32 forward's values.

typedef double AD;

struct D3 {
  AD x, y, z;
};

PT_FN D3 d3(AD x, AD y, AD z) { return D3{x, y, z}; }
PT_FN D3 up(V3 a) { return d3(a.x, a.y, a.z); }
PT_FN D3 dadd(D3 a, D3 b) { return d3(a.x + b.x, a.y + b.y, a.z + b.z); }
PT_FN D3 dsub(D3 a, D3 b) { return d3(a.x - b.x, a.y - b.y, a.z - b.z); }
PT_FN D3 dscale(AD s, D3 a) { return d3(s * a.x, s * a.y, s * a.z); }
PT_FN D3 dmul(D3 a, D3 b) { return d3(a.x * b.x, a.y * b.y, a.z * b.z); }
PT_FN AD ddot(D3 a, D3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PT_FN D3 dcross(D3 a, D3 b) {
  return d3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
PT_FN AD dcomp(D3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
PT_FN void acc_d(float* acc, int i, AD v) { acc_add(acc, i, (float)v); }

// y = x * rsqrt(max(x.x, 1e-24)): the cotangent of x from that of y
PT_FN D3 normalize_adj(V3 xf, D3 gy) {
  const float s = vdot(xf, xf);
  const AD r = rsqrtf(fmaxf(s, 1e-24f));
  const D3 x = up(xf);
  D3 gx = dscale(r, gy);
  if (s >= 1e-24f) gx = dsub(gx, dscale(r * r * r * ddot(gy, x), x));
  return gx;
}

// max(a, b) / min(a, b): the winner takes the cotangent, a tie splits it
PT_FN void max_adj(float a, float b, AD g, AD& ga, AD& gb) {
  if (a > b) {
    ga += g;
  } else if (a < b) {
    gb += g;
  } else {
    ga += 0.5 * g;
    gb += 0.5 * g;
  }
}

PT_FN void min_adj(float a, float b, AD g, AD& ga, AD& gb) {
  if (a < b) {
    ga += g;
  } else if (a > b) {
    gb += g;
  } else {
    ga += 0.5 * g;
    gb += 0.5 * g;
  }
}

// tangent frame (p1, p2) about n: n's cotangent from p1's and p2's
PT_FN void frame_adj(V3 n, D3 g_p1, D3 g_p2, D3& g_n) {
  const V3 not_n = not_axis_vector(n);
  const V3 c1 = vcross(n, not_n);
  const V3 p1 = vnormalize(c1);
  const V3 c2 = vcross(n, p1);
  const D3 g_c2 = normalize_adj(c2, g_p2);  // c2 = n x p1
  g_n = dadd(g_n, dcross(up(p1), g_c2));
  g_p1 = dadd(g_p1, dcross(g_c2, up(n)));
  const D3 g_c1 = normalize_adj(c1, g_p1);  // c1 = n x not_n
  g_n = dadd(g_n, dcross(up(not_n), g_c1));
}

PT_FN void cosine_hemisphere_adj(V3 n, float xi1, float xi2, D3 g_out, D3& g_n) {
  const float up_ = sqrtf(xi1);
  const float over = sqrtf(fmaxf(1.0f - xi1, 0.0f));
  const float around = xi2 * TWO_PI;
  g_n = dadd(g_n, dscale(up_, g_out));
  frame_adj(n, dscale((AD)(cosf(around) * over), g_out),
            dscale((AD)(sinf(around) * over), g_out), g_n);
}

PT_FN void rotate_about_adj(V3 axis, float ca, float phi, D3 g_out, D3& g_axis, AD& g_ca) {
  const float arg = 1.0f - ca * ca;
  const float sa = sqrtf(fmaxf(arg, 0.0f));
  V3 p1, p2;
  not_axis_frame(axis, p1, p2);
  const AD cp = cosf(phi), sp = sinf(phi);
  g_axis = dadd(g_axis, dscale(ca, g_out));
  g_ca += ddot(g_out, up(axis));
  const AD g_sa = cp * ddot(g_out, up(p1)) + sp * ddot(g_out, up(p2));
  if (arg > 0.0f) g_ca -= g_sa * (AD)ca / (AD)sa;
  frame_adj(axis, dscale(cp * sa, g_out), dscale(sp * sa, g_out), g_axis);
}

// m = d - (2 d.n) n
PT_FN void reflect_adj(V3 d_in, V3 n, D3 g_m, D3& g_din, D3& g_n) {
  const D3 d = up(d_in), nn = up(n);
  const AD k = 2.0f * vdot(d_in, n);
  const AD g_k = -ddot(g_m, nn);
  g_din = dadd(g_din, dadd(g_m, dscale(2.0 * g_k, nn)));
  g_n = dadd(g_n, dsub(dscale(2.0 * g_k, d), dscale(k, g_m)));
}

PT_FN void sphere_t_adj(V3 of, V3 df, AD g_t, D3& g_o, D3& g_d) {
  const float af = df.x * df.x + df.y * df.y + df.z * df.z;
  const float bf = of.x * df.x + of.y * df.y + of.z * df.z;
  const float cf = of.x * of.x + of.y * of.y + of.z * of.z - 0.25f;
  const float sqf = sqrtf(bf * bf - af * cf);  // a hit: disc > 0
  const float inv_af = safe_recip(af);
  const AD sg = (-bf - sqf) * inv_af > T_MIN ? -1.0 : 1.0;  // t = (-b + sg sq) / a
  const D3 o = up(of), d = up(df);
  const AD a = af, b = bf, c = cf, sq = sqf, inv_a = inv_af;
  const AD g_in = g_t * inv_a;
  const AD g_inv_a = g_t * (-b + sg * sq);
  const AD g_disc = sg * g_in * 0.5 / sq;
  const AD g_b = -g_in + 2.0 * b * g_disc;
  AD g_a = -c * g_disc;
  const AD g_c = -a * g_disc;
  if (!(fabsf(af) < 1e-12f)) g_a -= g_inv_a * inv_a * inv_a;
  g_o = dadd(g_o, dadd(dscale(2.0 * g_c, o), dscale(g_b, d)));
  g_d = dadd(g_d, dadd(dscale(2.0 * g_a, d), dscale(g_b, o)));
}

PT_FN void cube_t_adj(V3 o, V3 d, AD g_t, D3& g_o, D3& g_d) {
  const float oc[3] = {o.x, o.y, o.z};
  const float dc[3] = {d.x, d.y, d.z};
  float tl[3], th[3], lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = safe_recip(dc[k]);
    tl[k] = (-0.5f - oc[k]) * inv;
    th[k] = (0.5f - oc[k]) * inv;
    lo[k] = fminf(tl[k], th[k]);
    hi[k] = fmaxf(tl[k], th[k]);
  }
  AD g_tl[3] = {0.0, 0.0, 0.0}, g_th[3] = {0.0, 0.0, 0.0};
  AD g_e[3] = {0.0, 0.0, 0.0}, g_q = 0.0;
  const float t_near = fmaxf(fmaxf(lo[0], lo[1]), lo[2]);
  if (t_near > T_MIN) {  // t = max(max(lo0, lo1), lo2)
    max_adj(fmaxf(lo[0], lo[1]), lo[2], g_t, g_q, g_e[2]);
    max_adj(lo[0], lo[1], g_q, g_e[0], g_e[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) min_adj(tl[k], th[k], g_e[k], g_tl[k], g_th[k]);
  } else {  // t = min(min(hi0, hi1), hi2)
    min_adj(fminf(hi[0], hi[1]), hi[2], g_t, g_q, g_e[2]);
    min_adj(hi[0], hi[1], g_q, g_e[0], g_e[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) max_adj(tl[k], th[k], g_e[k], g_tl[k], g_th[k]);
  }
  AD go[3], gd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const AD inv = safe_recip(dc[k]);
    go[k] = -(g_tl[k] + g_th[k]) * inv;
    const AD g_inv = g_tl[k] * (-0.5 - (AD)oc[k]) + g_th[k] * (0.5 - (AD)oc[k]);
    gd[k] = fabsf(dc[k]) < 1e-12f ? 0.0 : -g_inv * inv * inv;
  }
  g_o = dadd(g_o, d3(go[0], go[1], go[2]));
  g_d = dadd(g_d, d3(gd[0], gd[1], gd[2]));
}

// BSDF sample at a non-emissive hit: the cotangents of the throughput
// multiplier, the origin and the direction -> those of p, the raw normal,
// the incoming direction and the material row (acc offset macc)
PT_FN void bsdf_adj(const float* mat, int macc, V3 n_raw, V3 d_in, float u0, float u1,
                    float u2, D3 g_mult, D3 g_org, D3 g_dir, D3& g_p, D3& g_nraw, D3& g_din,
                    float* acc) {
  const float cos_raw = vdot(d_in, n_raw);
  const bool entering = cos_raw < 0.0f;
  const V3 n = entering ? n_raw : vscale(-1.0f, n_raw);
  const float cos_i = fabsf(cos_raw);
  const bool is_refractive = mat[7] > 0.0f;
  const bool is_reflective = !is_refractive && (mat[6] > 0.0f);
  const bool is_glossy = is_reflective && (mat[10] > 0.0f);
  D3 g_n = d3(0.0, 0.0, 0.0);
  float bias = RAY_BIAS;

  if (is_refractive) {
    const float ior = mat[8];
    const float ior_i = entering ? 1.0f : ior;
    const float ior_t = entering ? ior : 1.0f;
    const float eta_f = ior_i / fmaxf(ior_t, 1e-6f);
    const float rci_f = -vdot(d_in, n);
    const float m1_f = 1.0f - rci_f * rci_f;
    const float sin2_f = eta_f * eta_f * fmaxf(m1_f, 0.0f);
    const bool refr_valid = sin2_f <= 1.0f;
    const float a2_f = 1.0f - sin2_f;
    const bool choose_reflect = fresnel_reflects(ior_i, ior_t, eta_f, cos_i, refr_valid, u2);
    acc_d(acc, macc + 3, g_mult.x);
    acc_d(acc, macc + 4, g_mult.y);
    acc_d(acc, macc + 5, g_mult.z);
    if (choose_reflect) {
      reflect_adj(d_in, n, g_dir, g_din, g_n);
    } else {
      if (refr_valid) bias = -RAY_BIAS;
      const D3 d = up(d_in), nn = up(n);
      const float cos_t_f = sqrtf(fmaxf(a2_f, 1e-12f));
      const float h_f = eta_f * rci_f - cos_t_f;
      const AD mt = fmaxf(ior_t, 1e-6f);
      const AD eta = eta_f, r_cos_i = rci_f, cos_t = cos_t_f, h = h_f;
      const AD mm = fmaxf(m1_f, 0.0f);
      const D3 g_v = normalize_adj(vadd(vscale(eta_f, d_in), vscale(h_f, n)), g_dir);
      g_din = dadd(g_din, dscale(eta, g_v));
      g_n = dadd(g_n, dscale(h, g_v));
      const AD g_h = ddot(g_v, nn);
      AD g_eta = ddot(g_v, d) + g_h * r_cos_i;
      AD g_rci = g_h * eta;
      const AD g_sin2 = a2_f >= 1e-12f ? g_h * 0.5 / cos_t : 0.0;  // cos_t = sqrt(1 - sin2)
      g_eta += g_sin2 * mm * 2.0 * eta;
      if (m1_f >= 0.0f) g_rci += g_sin2 * (eta * eta) * (-2.0 * r_cos_i);
      g_din = dsub(g_din, dscale(g_rci, nn));
      g_n = dsub(g_n, dscale(g_rci, d));
      AD g_ior;
      if (entering)
        g_ior = ior_t >= 1e-6f ? -g_eta * (AD)ior_i / (mt * mt) : 0.0;
      else
        g_ior = g_eta / mt;
      acc_d(acc, macc + 8, g_ior);
    }
  } else if (is_glossy) {
    const V3 dm = reflect(d_in, n);
    const float spec_exp = mat[10];
    const float exp_f = fmaxf(spec_exp, 1e-6f);
    const float ca = expf(logf(fmaxf(u0, 1e-9f)) / (exp_f + 1.0f));
    const float phi = u1 * TWO_PI;
    const V3 dg = rotate_about(dm, ca, phi);
    const float gco = vdot(dg, n);
    const float e1_f = exp_f + 1.0f;
    const AD exp_n = exp_f, e1 = e1_f, lg = logf(fmaxf(u0, 1e-9f));
    const AD q = (exp_f + 2.0f) / e1_f;
    const AD cc = fminf(fmaxf(gco, 0.0f), 1.0f);
    const AD weight = gco > 0.0f ? q * cc : 0.0;
    const D3 spec = d3(mat[3], mat[4], mat[5]);
    acc_d(acc, macc + 3, weight * g_mult.x);
    acc_d(acc, macc + 4, weight * g_mult.y);
    acc_d(acc, macc + 5, weight * g_mult.z);
    const AD g_w = ddot(g_mult, spec);
    D3 g_dg = g_dir;
    AD g_exp = 0.0;
    if (gco > 0.0f) {
      const AD g_q = g_w * cc;
      if (gco <= 1.0f) {
        const AD g_gco = g_w * q;
        g_dg = dadd(g_dg, dscale(g_gco, up(n)));
        g_n = dadd(g_n, dscale(g_gco, up(dg)));
      }
      g_exp += g_q / e1 - g_q * (exp_n + 2.0) / (e1 * e1);
    }
    D3 g_dm = d3(0.0, 0.0, 0.0);
    AD g_ca = 0.0;
    rotate_about_adj(dm, ca, phi, g_dg, g_dm, g_ca);
    g_exp += g_ca * (AD)ca * (-lg / (e1 * e1));
    reflect_adj(d_in, n, g_dm, g_din, g_n);
    if (spec_exp >= 1e-6f) acc_d(acc, macc + 10, g_exp);
  } else if (is_reflective) {
    acc_d(acc, macc + 3, g_mult.x);
    acc_d(acc, macc + 4, g_mult.y);
    acc_d(acc, macc + 5, g_mult.z);
    reflect_adj(d_in, n, g_dir, g_din, g_n);
  } else {
    acc_d(acc, macc + 0, g_mult.x);
    acc_d(acc, macc + 1, g_mult.y);
    acc_d(acc, macc + 2, g_mult.z);
    cosine_hemisphere_adj(n, u0, u1, g_dir, g_n);
  }
  // origin = p + bias * n
  g_p = dadd(g_p, g_org);
  g_n = dadd(g_n, dscale(bias, g_org));
  g_nraw = entering ? dadd(g_nraw, g_n) : dsub(g_nraw, g_n);
}

// NEE connection that counted (its radiance cotangent g_rad) -> cotangents
// of p, the normal, the throughput, and the material, light, geom and
// scalar tables
PT_FN void nee_adj(const Tables& T, const RowLayout& R, const float* mat, int macc, V3 pf,
                   V3 normal, V3 d, V3 thr_f, float u4, float u5, float u6, float u7, D3 g_rad,
                   D3& g_p, D3& g_normal, D3& g_thr, float* acc) {
  V3 lp_obj, ln_obj;
  const int lid = sample_light_obj(T.g, T.l, T.G, u4, u5, u6, u7, lp_obj, ln_obj);
  const float* L = T.l + lid * LCOLS;
  const float* li = T.g + lid * GCOLS;
  const V3 lnw = world_normal_raw(li, ln_obj);
  // the connection exactly as the forward computed it (float) ...
  const float sgn_f = fsign(-vdot(normal, d));
  const V3 n_shade_f = vscale(sgn_f, normal);
  const V3 tl_f = vsub(light_position(L, lp_obj), vadd(pf, vscale(RAY_BIAS, n_shade_f)));
  const float dist2_f = vdot(tl_f, tl_f);
  const float dist_f = sqrtf(fmaxf(dist2_f, 1e-12f));
  const float rd_f = 1.0f / dist_f;
  const V3 wi_f = vscale(rd_f, tl_f);
  const V3 ln_f = vnormalize(lnw);
  const float cos_x_f = vdot(n_shade_f, wi_f);
  const float cos_y_f = -vdot(ln_f, wi_f);
  const float md_f = fmaxf(dist2_f, 1e-12f);
  const float cxy_f = cos_x_f * cos_y_f;
  const float gterm_f = cxy_f / md_f;
  const float ma_f = fmaxf(T.total_area, 1e-20f);
  const float pdf_f = 1.0f / ma_f;
  const float mp_f = fmaxf(pdf_f, 1e-20f);
  const float ns_f = gterm_f / mp_f * INV_PI;
  const V3 tc_f = vmul(thr_f, v3(mat[0], mat[1], mat[2]));
  // ... and in double for the adjoint
  const AD sgn = sgn_f, dist = dist_f, rd = rd_f, cos_x = cos_x_f, cos_y = cos_y_f,
           md = md_f, cxy = cxy_f, gterm = gterm_f, ma = ma_f, mp = mp_f, ns = ns_f;
  const D3 n_shade = up(n_shade_f), tl = up(tl_f), wi = up(wi_f), ln = up(ln_f);
  const D3 lpo = up(lp_obj), lno = up(ln_obj);
  const D3 emit = d3(L[13], L[14], L[15]);
  const D3 thr = up(thr_f);
  const D3 color = d3(mat[0], mat[1], mat[2]);
  const D3 tc = up(tc_f);
  const D3 tce = up(vmul(tc_f, v3(L[13], L[14], L[15])));

  // nee_rgb = ns * ((thr * color) * emit)
  const AD g_ns = ddot(g_rad, tce);
  const D3 g_tce = dscale(ns, g_rad);
  const D3 g_tc = dmul(g_tce, emit);
  const int lacc = R.ol + lid * LCOLS;
  acc_d(acc, lacc + 13, g_tce.x * tc.x);
  acc_d(acc, lacc + 14, g_tce.y * tc.y);
  acc_d(acc, lacc + 15, g_tce.z * tc.z);
  g_thr = dadd(g_thr, dmul(g_tc, color));
  acc_d(acc, macc + 0, g_tc.x * thr.x);
  acc_d(acc, macc + 1, g_tc.y * thr.y);
  acc_d(acc, macc + 2, g_tc.z * thr.z);
  // ns = gterm / max(1 / max(area, 1e-20), 1e-20) / pi
  const AD g_a = g_ns * (AD)INV_PI;
  const AD g_gterm = g_a / mp;
  if (pdf_f >= 1e-20f && T.total_area >= 1e-20f) {
    const AD g_mp = -g_a * gterm / (mp * mp);
    acc_d(acc, R.os + 0, -g_mp / (ma * ma));
  }
  // gterm = cos_x cos_y / max(dist2, 1e-12)
  const AD g_cxy = g_gterm / md;
  AD g_dist2 = dist2_f >= 1e-12f ? -g_gterm * cxy / (md * md) : 0.0;
  const AD g_cos_x = g_cxy * cos_y;
  const AD g_cos_y = g_cxy * cos_x;
  D3 g_nsh = dscale(g_cos_x, wi);
  const D3 g_wi = dsub(dscale(g_cos_x, n_shade), dscale(g_cos_y, ln));
  const D3 g_ln = dscale(-g_cos_y, wi);
  // wi = (1 / dist) tl, dist = sqrt(max(dist2, 1e-12)), dist2 = tl.tl
  D3 g_tl = dscale(rd, g_wi);
  const AD g_dist = -ddot(g_wi, tl) / (dist * dist);
  if (dist2_f >= 1e-12f) g_dist2 += g_dist * 0.5 / dist;
  g_tl = dadd(g_tl, dscale(2.0 * g_dist2, tl));
  // tl = lp - x, x = p + bias n_shade, n_shade = sgn normal
  g_p = dsub(g_p, g_tl);
  g_nsh = dsub(g_nsh, dscale((AD)RAY_BIAS, g_tl));
  g_normal = dadd(g_normal, dscale(sgn, g_nsh));
  // lp = F lp_obj + f3 (light table rows 0..11)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const AD gi = dcomp(g_tl, i);
    acc_d(acc, lacc + 4 * i + 0, gi * lpo.x);
    acc_d(acc, lacc + 4 * i + 1, gi * lpo.y);
    acc_d(acc, lacc + 4 * i + 2, gi * lpo.z);
    acc_d(acc, lacc + 4 * i + 3, gi);
  }
  // ln = normalize(Li^T ln_obj) (the light geom's inverse rows)
  const D3 g_lnw = normalize_adj(lnw, g_ln);
  const int gacc = lid * GCOLS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const AD nj = dcomp(lno, j);
    acc_d(acc, gacc + 4 * j + 0, g_lnw.x * nj);
    acc_d(acc, gacc + 4 * j + 1, g_lnw.y * nj);
    acc_d(acc, gacc + 4 * j + 2, g_lnw.z * nj);
  }
}

// One live bounce in reverse: the cotangents of the bounce's outputs
// (g_rad of the radiance increment; g_o, g_d, g_thr of the next carries)
// become those of its inputs (g_o, g_d, g_thr, in place) and of the tables
// (added to acc)
PT_FN void bounce_adj(const Tables& T, const RowLayout& R, uint32_t base, int dep, int nee,
                      int rr, int rr_start, V3 o, V3 d, V3 thr, float prev_state, int gid,
                      bool nee_add, D3 g_rad, D3& g_o, D3& g_d, D3& g_thr, float* acc) {
  if (gid < 0) return;  // miss: the path ends, the carries pass through
  const float* gw = T.g + gid * GCOLS;
  const float* mat = T.m + (int)gw[13] * MCOLS;
  const int macc = R.om + (int)gw[13] * MCOLS;
  if (mat[9] > 0.0f) {
    // light hit: the path ends, the carries pass through; the emission
    // e * (thr * color) counts under the emit-state code
    if (!nee || dep == 0 || fabsf(prev_state - 1.0f) < 0.5f) {
      const AD e = mat[9];
      const D3 color = d3(mat[0], mat[1], mat[2]), th = up(thr);
      const D3 g_tc = dscale(e, g_rad);
      acc_d(acc, macc + 9, ddot(g_rad, dmul(th, color)));
      acc_d(acc, macc + 0, g_tc.x * th.x);
      acc_d(acc, macc + 1, g_tc.y * th.y);
      acc_d(acc, macc + 2, g_tc.z * th.z);
      g_thr = dadd(g_thr, dmul(g_tc, color));
    }
    return;
  }

  // ---- recompute the replayed bounce (float, as the forward ran)
  const bool sphere = gw[12] == SPHERE;
  V3 oo, od;
  to_object(gw, o, d, oo, od);
  const float t = geom_t(gw, oo, od);
  const V3 p = vadd(o, vscale(t, d));
  const V3 p_obj = vadd(oo, vscale(t, od));
  const V3 n_obj = object_normal(sphere, p_obj);
  const V3 nw = world_normal_raw(gw, n_obj);
  const V3 normal = vnormalize(nw);
  const float u0 = uniform(base, 0), u1 = uniform(base, 1), u2 = uniform(base, 2);
  const Scatter sc = sample_bsdf(mat, p, normal, d, u0, u1, u2);

  // ---- step_update: thr2 = (thr * mult) [* 1/p], next o/d if it survives
  const V3 tm = vmul(thr, sc.thr);
  bool survive = true;
  AD inv_p = 1.0;
  if (rr && dep >= rr_start) {
    const float p_rr = fminf(fmaxf(fmaxf(fmaxf(tm.x, tm.y), tm.z), 0.05f), 1.0f);
    survive = uniform(base, 3) < p_rr;
    inv_p = 1.0f / p_rr;
  }
  const D3 g_tm = dscale(inv_p, g_thr);
  D3 g_thr_in = dmul(g_tm, up(sc.thr));
  const D3 g_mult = dmul(g_tm, up(thr));
  const D3 zero = d3(0.0, 0.0, 0.0);
  const D3 g_org = survive ? g_o : zero;
  const D3 g_dir = survive ? g_d : zero;
  D3 g_o_in = survive ? zero : g_o;
  D3 g_d_in = survive ? zero : g_d;

  // ---- BSDF and NEE
  D3 g_p = zero, g_normal = zero;
  bsdf_adj(mat, macc, normal, d, u0, u1, u2, g_mult, g_org, g_dir, g_p, g_normal, g_d_in, acc);
  if (nee && nee_add)
    nee_adj(T, R, mat, macc, p, normal, d, thr, uniform(base, 4), uniform(base, 5),
            uniform(base, 6), uniform(base, 7), g_rad, g_p, g_normal, g_thr_in, acc);

  // ---- normal = normalize(M3^T n_obj)
  const D3 g_nw = normalize_adj(nw, g_normal);
  const int gacc = gid * GCOLS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const AD nj = comp(n_obj, j);
    acc_d(acc, gacc + 4 * j + 0, g_nw.x * nj);
    acc_d(acc, gacc + 4 * j + 1, g_nw.y * nj);
    acc_d(acc, gacc + 4 * j + 2, g_nw.z * nj);
  }
  D3 g_pobj = zero;
  if (sphere) {  // a cube's normal is a sign: no cotangent
    const D3 g_nobj = d3(gw[0] * g_nw.x + gw[1] * g_nw.y + gw[2] * g_nw.z,
                         gw[4] * g_nw.x + gw[5] * g_nw.y + gw[6] * g_nw.z,
                         gw[8] * g_nw.x + gw[9] * g_nw.y + gw[10] * g_nw.z);
    g_pobj = normalize_adj(p_obj, g_nobj);
  }

  // ---- p_obj = oo + t od, p = o + t d, t of the winner
  D3 g_oo = g_pobj;
  D3 g_od = dscale(t, g_pobj);
  const AD g_t = ddot(g_pobj, up(od)) + ddot(g_p, up(d));
  g_o_in = dadd(g_o_in, g_p);
  g_d_in = dadd(g_d_in, dscale(t, g_p));
  if (sphere)
    sphere_t_adj(oo, od, g_t, g_oo, g_od);
  else
    cube_t_adj(oo, od, g_t, g_oo, g_od);

  // ---- oo = M3 o + m3, od = M3 d (geom table rows 0..11)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const AD goi = dcomp(g_oo, i), gdi = dcomp(g_od, i);
    acc_d(acc, gacc + 4 * i + 0, goi * o.x + gdi * d.x);
    acc_d(acc, gacc + 4 * i + 1, goi * o.y + gdi * d.y);
    acc_d(acc, gacc + 4 * i + 2, goi * o.z + gdi * d.z);
    acc_d(acc, gacc + 4 * i + 3, goi);
  }
  g_o_in = dadd(g_o_in, d3(gw[0] * g_oo.x + gw[4] * g_oo.y + gw[8] * g_oo.z,
                           gw[1] * g_oo.x + gw[5] * g_oo.y + gw[9] * g_oo.z,
                           gw[2] * g_oo.x + gw[6] * g_oo.y + gw[10] * g_oo.z));
  g_d_in = dadd(g_d_in, d3(gw[0] * g_od.x + gw[4] * g_od.y + gw[8] * g_od.z,
                           gw[1] * g_od.x + gw[5] * g_od.y + gw[9] * g_od.z,
                           gw[2] * g_od.x + gw[6] * g_od.y + gw[10] * g_od.z));
  g_o = g_o_in;
  g_d = g_d_in;
  g_thr = g_thr_in;
}

// the reverse loop of one lane: its origin and direction cotangents
PT_FN void bwd_lane(const Tables& T, const RowLayout& R, uint32_t seed, uint32_t s,
                    const float* resid, size_t n, size_t idx, int max_depth, int nee, int rr,
                    int rr_start, V3 g_rad_f, V3& g_o_out, V3& g_d_out, float* acc) {
  const uint32_t s_term = s * 0x85EBCA6Bu;
  const D3 g_rad = up(g_rad_f);
  D3 g_thr = d3(0.0, 0.0, 0.0);
  D3 g_o = g_thr, g_d = g_thr;  // the loop's final carries are discarded
  for (int dep = max_depth - 1; dep >= 0; --dep) {
    const float* r = resid + (size_t)dep * N_RESID * n + idx;
    if (!(r[R_ALIVE * n] > 0.5f)) continue;  // dead: identity, no table cotangent
    const V3 o = v3(r[(R_O + 0) * n], r[(R_O + 1) * n], r[(R_O + 2) * n]);
    const V3 d = v3(r[(R_D + 0) * n], r[(R_D + 1) * n], r[(R_D + 2) * n]);
    const V3 thr = v3(r[(R_THR + 0) * n], r[(R_THR + 1) * n], r[(R_THR + 2) * n]);
    bounce_adj(T, R, bounce_base(seed, s_term, dep), dep, nee, rr, rr_start, o, d, thr,
               r[R_STATE * n], (int)r[R_GID * n], r[R_NEE * n] > 0.5f, g_rad, g_o, g_d, g_thr,
               acc);
  }
  g_o_out = v3((float)g_o.x, (float)g_o.y, (float)g_o.z);
  g_d_out = v3((float)g_d.x, (float)g_d.y, (float)g_d.z);
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 128;
constexpr int REDUCE_THREADS = 256;

__device__ void load_tables(float* smem, const float* gtab, int G, const float* mtab, int M,
                            const float* ltab) {
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) smem[i] = gtab[i];
  float* s_m = smem + G * GCOLS;
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
}

__global__ void __launch_bounds__(FWD_THREADS)
trace_fwd_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                 const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
                 const float* __restrict__ origin, const float* __restrict__ direction,
                 const uint32_t* __restrict__ sample, int n, float* __restrict__ radiance,
                 unsigned long long* __restrict__ nrays, float* __restrict__ resid,
                 int max_depth, int nee, int rr, int rr_start) {
  extern __shared__ float smem[];
  load_tables(smem, gtab, G, mtab, M, ltab);
  __syncthreads();
  const Tables T{smem, smem + G * GCOLS, smem + G * GCOLS + M * MCOLS, G, scal[0],
                 scal[1] > 0.5f};

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = idx < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o, rad = o;
  uint32_t s = 0;
  if (valid) {
    o = v3(origin[3 * idx], origin[3 * idx + 1], origin[3 * idx + 2]);
    d = v3(direction[3 * idx], direction[3 * idx + 1], direction[3 * idx + 2]);
    s = sample[idx];
  }
  unsigned int bounces = 0;
  fwd_lane(T, seed, s, o, d, max_depth, nee, rr, rr_start, valid, resid, (size_t)n,
           (size_t)(valid ? idx : 0), rad, bounces);
  if (valid) {
    radiance[3 * idx] = rad.x;
    radiance[3 * idx + 1] = rad.y;
    radiance[3 * idx + 2] = rad.z;
  }
  // exact ray count: warp sum, one 64-bit atomic per warp
  unsigned long long c = (unsigned long long)bounces * (nee ? 2ull : 1ull);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(nrays, c);
}

__global__ void __launch_bounds__(BWD_THREADS)
trace_bwd_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                 const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
                 const uint32_t* __restrict__ sample, int n, const float* __restrict__ resid,
                 const float* __restrict__ g_radiance, float* __restrict__ d_origin,
                 float* __restrict__ d_direction, float* __restrict__ partial, int max_depth,
                 int nee, int rr, int rr_start) {
  extern __shared__ float smem[];
  const RowLayout R = row_layout(G, M);
  float* s_acc = smem + G * GCOLS + M * MCOLS + G * LCOLS;
  load_tables(smem, gtab, G, mtab, M, ltab);
  for (int i = threadIdx.x; i < R.k; i += blockDim.x) s_acc[i] = 0.0f;
  __syncthreads();
  const Tables T{smem, smem + G * GCOLS, smem + G * GCOLS + M * MCOLS, G, scal[0],
                 scal[1] > 0.5f};

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {  // lanes past n contribute nothing
    const V3 g_rad = v3(g_radiance[3 * idx], g_radiance[3 * idx + 1], g_radiance[3 * idx + 2]);
    V3 g_o, g_d;
    bwd_lane(T, R, seed, sample[idx], resid, (size_t)n, (size_t)idx, max_depth, nee, rr,
             rr_start, g_rad, g_o, g_d, s_acc);
    d_origin[3 * idx] = g_o.x;
    d_origin[3 * idx + 1] = g_o.y;
    d_origin[3 * idx + 2] = g_o.z;
    d_direction[3 * idx] = g_d.x;
    d_direction[3 * idx + 1] = g_d.y;
    d_direction[3 * idx + 2] = g_d.z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R.k; i += blockDim.x)
    partial[(size_t)blockIdx.x * R.k + i] = s_acc[i];
}

// row[i] = sum of the blocks' partial rows, in block order
__global__ void __launch_bounds__(REDUCE_THREADS)
trace_bwd_reduce(const float* __restrict__ partial, int nblocks, int k, float* __restrict__ row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * k + i];
  row[i] = s;
}

size_t table_floats(int G, int M) { return (size_t)(G * GCOLS + M * MCOLS + G * LCOLS); }

}  // namespace

extern "C" int trace_fwd_launch(const float* gtab, int G, const float* mtab, int M,
                                const float* ltab, const float* scal, unsigned int seed,
                                const float* origin, const float* direction,
                                const unsigned int* sample, int n, float* radiance,
                                unsigned long long* nrays, float* resid, int max_depth, int nee,
                                int rr, int rr_start, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + FWD_THREADS - 1) / FWD_THREADS;
  const size_t smem = sizeof(float) * table_floats(G, M);
  trace_fwd_kernel<<<blocks, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, origin, direction, sample, n, radiance, nrays, resid,
      max_depth, nee, rr, rr_start);
  return (int)cudaGetLastError();
}

// the number of blocks (rows of `partial`) the reverse kernel runs for n lanes
extern "C" int trace_bwd_blocks(int n) { return (n + BWD_THREADS - 1) / BWD_THREADS; }

extern "C" int trace_bwd_launch(const float* gtab, int G, const float* mtab, int M,
                                const float* ltab, const float* scal, unsigned int seed,
                                const unsigned int* sample, int n, const float* resid,
                                const float* g_radiance, float* d_origin, float* d_direction,
                                float* partial, float* row, int max_depth, int nee, int rr,
                                int rr_start, void* stream) {
  const RowLayout R = row_layout(G, M);
  const int blocks = trace_bwd_blocks(n);
  if (n <= 0) return (int)cudaMemsetAsync(row, 0, sizeof(float) * R.k, (cudaStream_t)stream);
  const size_t smem = sizeof(float) * (table_floats(G, M) + R.k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        trace_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trace_bwd_kernel<<<blocks, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, sample, n, resid, g_radiance, d_origin, d_direction,
      partial, max_depth, nee, rr, rr_start);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  trace_bwd_reduce<<<(R.k + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0,
                     (cudaStream_t)stream>>>(partial, blocks, R.k, row);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
