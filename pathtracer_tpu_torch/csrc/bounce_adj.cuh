// The hand-written adjoint of one replayed bounce, shared by the reverse
// kernels: csrc/trace_grad.cu (kernel 5, the full-depth reverse loop, which
// adds the adjoint of the carry update) and csrc/bounce_grad.cu (kernel 3,
// the per-bounce backward).  The plain version it is held to is
// torch.autograd of ops/bounce.py:bounce_physics(replay=...) in float64 at
// the float32 bounce's values (ops/trace_grad.py:tbwd_plain and
// ops/bounce_grad.py:bounce_bwd_plain with dtype=torch.float64).
//
// The forward values are recomputed in float, exactly as the forward ran
// (autograd differentiates at those very values); the adjoint's products
// and sums run in double.  The float32 gradient of a path is
// ill-conditioned on a few lanes (large terms that cancel); in double the
// kernel's own rounding drops out.
//
// Only the branch a lane took is differentiated, so the unselected
// branches' 0 * inf of a where-graph cannot appear.  Ties of min/max split
// the cotangent in half and clamps pass it at their bounds, as torch's
// autograd does; the square root of a clamped quantity passes zero where
// the quantity is not positive (ops/bsdf.py:sqrt0).  Table cotangents go to
// a flat row (geom, material, light tables and the two scalars, RowLayout)
// through acc_add: a float atomic into the block's row of `partial`, in
// device memory, on the card (kernels 3 and 5), a plain add in the host
// build; kernel 5 first sums NEE's light and scalar columns per lane
// (LaneSums), kernel 3 its winner's geom and material columns (RowSums).
// row_sum then adds the blocks' rows in a fixed tree.
//
// The surface blocks (the kSurf instances: texture, bump, microfacet and
// ward, bounce_pallas.py:645-706,756-783,1054-1074,1121-1138) have their
// adjoints here too.  The checker or stripes choice is piecewise constant:
// the albedo's cotangent goes to the columns the lane selected, the
// material's colour (0-2) or texture_color2 (18-20), and the texture scale
// gets none.  The bump differentiates its normalize, amp sin(bs ph)
// (columns 21-22) and the tangent frame; its phase reaches the object-space
// hit point and through it the winner's transform.  The Cook-Torrance and
// Ward lobes differentiate the sampled direction and the weight with
// respect to the shading normal, the incoming direction, the specular
// colour (3-5) and the roughness (25, and 26 for Ward's second axis).

#pragma once

#include "trace_common.cuh"

namespace pt {

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

// Kernel 5's own sums of the columns that a lane's NEE connections add to
// at every bounce: the sampled light's 12 position columns, its emission
// (3) and the 9 normal columns of its geom row, for the first light the
// lane samples, and the total-area scalar.  Where a scene has one light
// every lane adds to these same 25 columns.  The lane sums them in double
// across its bounces (slot k at s[k * stride]) and they reach the row once
// at its end (lane_sums_add, or on the card a warp's sum: trace_grad.cu); a
// connection to another light adds to the row at once.  With kSums false
// (kernel 3, one bounce per lane, and the media and surface instances of
// kernel 5, where the sums measured slower) every column goes to the row.
constexpr int LS_POS = 0, LS_EMIT = 12, LS_NRM = 15, LS_AREA = 24, LANE_SUMS = 25;

// The reverse kernels' lane orders (lane_order, at the end of this file): a
// lane's key is in [0, ORDER_KEYS), and the lanes run grouped by key in
// increasing order.
constexpr int ORDER_KEYS = 256;

struct LaneSums {
  AD* s;       // the lane's slots, slot k at s[k * stride]
  int stride;
  int lid;     // the light whose columns the light slots hold, -1 while none
};

// whether the columns of light lid go to the lane sums: they hold lid's,
// or none yet (lid's from now on)
template <bool kSums>
PT_FN bool sums_take(LaneSums* ls, int lid) {
  if constexpr (kSums) {
    if (ls->lid < 0) ls->lid = lid;
    return ls->lid == lid;
  }
  return false;
}

// column col's cotangent v: into slot `slot` of the lane sums where `hot`,
// else into the row
template <bool kSums, typename Acc>
PT_FN void acc_sum(Acc acc, LaneSums* ls, bool hot, int slot, int col, AD v) {
  if (kSums && hot)
    ls->s[slot * ls->stride] += v;
  else
    acc_d(acc, col, v);
}

// the row column of lane-sum slot k, for the sums' light lid
PT_HD int lane_sum_col(const RowLayout& R, int k, int lid) {
  if (k < LS_EMIT) return R.ol + lid * LCOLS + k;
  if (k < LS_NRM) return R.ol + lid * LCOLS + 13 + (k - LS_EMIT);
  if (k < LS_AREA) return lid * GCOLS + 4 * ((k - LS_NRM) / 3) + (k - LS_NRM) % 3;
  return R.os;
}

// a lane's sums into the row, each nonzero slot once
PT_FN void lane_sums_add(float* acc, const RowLayout& R, const LaneSums& ls) {
  for (int k = 0; k < LANE_SUMS; ++k) {
    const AD v = ls.s[k * ls.stride];
    if (v != 0.0 && (k == LS_AREA || ls.lid >= 0)) acc_d(acc, lane_sum_col(R, k, ls.lid), v);
  }
}

// Kernel 3's own sums of its winner's rows: the geom row's 12 transform
// columns (the normal's and the winner's t's cotangents) and the 28 columns
// of its material row (the BSDF's, the emission's and NEE's albedo).  Every
// live lane adds to them once per bounce, and a warp's lanes mostly share a
// winner (neighbouring pixels), so the lane sums them in double (slot k at
// s[k * stride]) and the warp adds them to the row once where all its lanes
// share the winner (warp_row_sums_add), else each lane adds its own.  Every
// other column goes to the row at once.  g0 and m0 are the columns of the
// lane's geom and material rows, ROW_NONE before the lane has a winner.
constexpr int RS_GEOM = 12, ROW_SUMS = RS_GEOM + MCOLS;
constexpr int ROW_NONE = -(1 << 30);

struct RowSums {
  float* row;  // the block's row
  AD* s;       // the lane's slots, slot k at s[k * stride]
  int stride;
  int g0, m0;  // the row columns of the lane's winner geom and material rows
};

PT_FN void acc_d(const RowSums& a, int i, AD v) {
  const unsigned gk = (unsigned)(i - a.g0), mk = (unsigned)(i - a.m0);
  if (gk < (unsigned)RS_GEOM)
    a.s[gk * a.stride] += v;
  else if (mk < (unsigned)MCOLS)
    a.s[(RS_GEOM + mk) * a.stride] += v;
  else
    acc_d(a.row, i, v);
}

// the row column of row-sum slot k
PT_HD int row_sum_col(const RowSums& a, int k) {
  return k < RS_GEOM ? a.g0 + k : a.m0 + k - RS_GEOM;
}

// the lane's winner rows for its row sums, from its replayed winner (a miss
// adds to geom 0's and material 0's rows, as the adjoint does); a plain row
// has none
PT_FN void row_owner(float*, const RowLayout&, int, int) {}
PT_FN void row_owner(RowSums& a, const RowLayout& R, int gc, int mid) {
  a.g0 = gc * GCOLS;
  a.m0 = R.om + mid * MCOLS;
}

// a lane's row sums into the row, each nonzero slot once
PT_FN void row_sums_add(const RowSums& a) {
  if (a.g0 == ROW_NONE) return;
  for (int k = 0; k < ROW_SUMS; ++k) {
    const AD v = a.s[k * a.stride];
    if (v != 0.0) acc_d(a.row, row_sum_col(a, k), v);
  }
}

// kExact (the kSurf instances): the derivative of a square root, a
// reciprocal square root or a reciprocal from its result in double at the
// float argument, and of a product from the float product, as the float64
// reference takes them (autograd keeps those results in float64 and the
// operands' float32 values).  The bump multiplies the shading normal's
// cotangent by its phase's ~10^3, and the hit point's components then cancel
// along the normal: without it the float results' last bits show in the
// small components of d_direction.  Without kExact (the vacuum and media
// instances) the adjoint takes the float results, as it always has.

// y = x * rsqrt(max(x.x, 1e-24)): the cotangent of x from that of y
template <bool kExact = false>
PT_FN D3 normalize_adj(V3 xf, D3 gy) {
  const float s = vdot(xf, xf);
  const AD r = rsqrtf(fmaxf(s, 1e-24f));
  const D3 x = up(xf);
  D3 gx = dscale(r, gy);
  if (s >= 1e-24f) {
    const AD rr = kExact ? 1.0 / sqrt((AD)s) : r;
    gx = dsub(gx, dscale(rr * rr * rr * ddot(gy, x), x));
  }
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
template <bool kExact = false>
PT_FN void frame_adj(V3 n, D3 g_p1, D3 g_p2, D3& g_n) {
  const V3 not_n = not_axis_vector(n);
  const V3 c1 = vcross(n, not_n);
  const V3 p1 = vnormalize(c1);
  const V3 c2 = vcross(n, p1);
  const D3 g_c2 = normalize_adj<kExact>(c2, g_p2);  // c2 = n x p1
  g_n = dadd(g_n, dcross(up(p1), g_c2));
  g_p1 = dadd(g_p1, dcross(g_c2, up(n)));
  const D3 g_c1 = normalize_adj<kExact>(c1, g_p1);  // c1 = n x not_n
  g_n = dadd(g_n, dcross(up(not_n), g_c1));
}

template <bool kExact = false>
PT_FN void cosine_hemisphere_adj(V3 n, float xi1, float xi2, D3 g_out, D3& g_n) {
  const float up_ = sqrtf(xi1);
  const float over = sqrtf(fmaxf(1.0f - xi1, 0.0f));
  const float around = xi2 * TWO_PI;
  g_n = dadd(g_n, dscale(up_, g_out));
  frame_adj<kExact>(n, dscale((AD)(cosf(around) * over), g_out),
                    dscale((AD)(sinf(around) * over), g_out), g_n);
}

template <bool kExact = false>
PT_FN void rotate_about_adj(V3 axis, float ca, float phi, D3 g_out, D3& g_axis, AD& g_ca) {
  const float arg = 1.0f - ca * ca;
  const float sa = sqrtf(fmaxf(arg, 0.0f));
  V3 p1, p2;
  not_axis_frame(axis, p1, p2);
  const float cpf = cosf(phi), spf = sinf(phi);
  const AD cp = cpf, sp = spf;
  g_axis = dadd(g_axis, dscale(ca, g_out));
  g_ca += ddot(g_out, up(axis));
  const AD g_sa = cp * ddot(g_out, up(p1)) + sp * ddot(g_out, up(p2));
  if (arg > 0.0f) g_ca -= g_sa * (AD)ca / (kExact ? sqrt((AD)arg) : (AD)sa);
  if constexpr (kExact)
    frame_adj<true>(axis, dscale((AD)(cpf * sa), g_out), dscale((AD)(spf * sa), g_out), g_axis);
  else
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

// The slab's and the quadratic's adjoints.  kExact takes the derivatives of
// the reciprocals and the square root in double of their float arguments,
// as the float64 reference takes them: with the bump, the object-space
// point's cotangent is large and cancels against the distance's along the
// normal, and the float results' last bits would show.
template <bool kExact = false>
PT_FN void sphere_t_adj(V3 of, V3 df, AD g_t, D3& g_o, D3& g_d) {
  const float af = df.x * df.x + df.y * df.y + df.z * df.z;
  const float bf = of.x * df.x + of.y * df.y + of.z * df.z;
  const float cf = of.x * of.x + of.y * of.y + of.z * of.z - 0.25f;
  const float sqf = sqrtf(bf * bf - af * cf);  // a hit: disc > 0
  const float inv_af = safe_recip(af);
  const AD sg = (-bf - sqf) * inv_af > T_MIN ? -1.0 : 1.0;  // t = (-b + sg sq) / a
  const D3 o = up(of), d = up(df);
  const AD a = af, b = bf, c = cf, inv_a = inv_af;
  const AD sq = kExact ? sqrt((AD)(bf * bf - af * cf)) : (AD)sqf;
  const AD g_in = g_t * inv_a;
  const AD g_inv_a = g_t * (kExact ? (AD)(sg < 0.0 ? -bf - sqf : -bf + sqf) : -b + sg * sq);
  const AD g_disc = sg * g_in * 0.5 / sq;
  const AD g_b = -g_in + 2.0 * b * g_disc;
  AD g_a = -c * g_disc;
  const AD g_c = -a * g_disc;
  if (!(fabsf(af) < 1e-12f)) g_a -= kExact ? g_inv_a / (a * a) : g_inv_a * inv_a * inv_a;
  g_o = dadd(g_o, dadd(dscale(2.0 * g_c, o), dscale(g_b, d)));
  g_d = dadd(g_d, dadd(dscale(2.0 * g_a, d), dscale(g_b, o)));
}

template <bool kExact = false>
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
    const AD g_inv = kExact ? g_tl[k] * (AD)(-0.5f - oc[k]) + g_th[k] * (AD)(0.5f - oc[k])
                            : g_tl[k] * (-0.5 - (AD)oc[k]) + g_th[k] * (0.5 - (AD)oc[k]);
    gd[k] = fabsf(dc[k]) < 1e-12f ? 0.0
                                  : (kExact ? -g_inv / ((AD)dc[k] * dc[k]) : -g_inv * inv * inv);
  }
  g_o = dadd(g_o, d3(go[0], go[1], go[2]));
  g_d = dadd(g_d, d3(gd[0], gd[1], gd[2]));
}

// ---- the Cook-Torrance and Ward lobes (kSurf) ------------------------------

// Smith's G1 (smith_g1) at c_in: its cotangent g_g -> those of c_in and a2
PT_FN void smith_g1_adj(float c_in, float a2, AD g_g, AD& g_c_in, AD& g_a2) {
  const float c = fminf(fmaxf(c_in, 1e-6f), 1.0f);
  const float om = 1.0f - a2;
  const float omc = om * c;
  const float inner = a2 + omc * c;
  const float sq = sqrtf(inner);
  const float den = c + sq;
  const AD g_den = -g_g * (AD)(2.0f * c) / ((AD)den * den);
  AD g_c = 2.0 * g_g / den + g_den;
  const AD g_inner = g_den * 0.5 / sqrt((AD)inner);  // inner >= a2 >= 1e-8
  const AD g_omc = g_inner * c;
  g_c += g_inner * omc + g_omc * om;
  g_a2 += g_inner - g_omc * c;
  if (c_in >= 1e-6f && c_in <= 1.0f) g_c_in += g_c;
}

// The Cook-Torrance GGX lobe (ggx_lobe) recomputed in float, and its
// adjoint, the kSurf instances' only (kExact's conventions throughout): the
// cotangents of its weight (g_w3; only where the sample is valid, the
// weight being 0 elsewhere) and its direction -> those of the shading
// normal n, the incoming direction, cos_i and the material's specular
// colour (columns 3-5) and roughness (25)
template <typename Acc>
PT_FN void ggx_adj(const float* mat, int macc, V3 n, V3 d_in, float cos_i, float u0, float u1,
                   D3 g_w3, D3 g_dir, D3& g_n, D3& g_din, AD& g_cos_i, Acc acc) {
  const float rough = mat[25];
  const float rr = rough * rough;
  const float alpha = fminf(fmaxf(rr, 1e-4f), 1.0f);
  const float a2 = alpha * alpha;
  const float xi1 = fminf(fmaxf(u0, 1e-7f), ONE_MINUS_1E7);
  const float den_q = 1.0f + (a2 - 1.0f) * xi1;
  const float q = (1.0f - xi1) / den_q;
  const float cos_h = sqrtf(fminf(fmaxf(q, 0.0f), 1.0f));
  const float phi = u1 * TWO_PI;
  const V3 h = rotate_about(n, cos_h, phi);
  const V3 dir = reflect(d_in, h);
  const float wdh = -vdot(d_in, h);
  const float cos_o = vdot(dir, n);
  const float ci = fminf(fmaxf(cos_i, 1e-6f), 1.0f);
  AD g_a2 = 0.0, g_cos_h = 0.0, g_ci = 0.0;
  D3 g_h = d3(0.0, 0.0, 0.0);
  if (cos_o > 0.0f && wdh > 0.0f) {
    // weight = w * (s + (1 - s) f5), w = g wo.h / max(ci cos_h, 1e-6)
    const float g1i = smith_g1(ci, a2), g1o = smith_g1(cos_o, a2);
    const float g = g1i * g1o;
    const float x = fmaxf(1.0f - wdh, 0.0f);
    const float x2 = x * x;
    const float x4 = x2 * x2;
    const float f5 = x * x4;
    const float dw = fmaxf(ci * cos_h, 1e-6f);
    const float gw = g * wdh;
    const float w = gw / dw;
    AD g_w = 0.0, g_f5 = 0.0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sk = mat[3 + k];
      const AD gk = dcomp(g_w3, k);
      g_w += gk * (AD)(sk + (1.0f - sk) * f5);
      acc_d(acc, macc + 3 + k, gk * (AD)w * (1.0 - (AD)f5));
      g_f5 += gk * (AD)w * (AD)(1.0f - sk);
    }
    const AD g_gw = g_w / dw;
    const AD g_dw = -g_w * (AD)gw / ((AD)dw * dw);
    if (ci * cos_h >= 1e-6f) {
      g_ci += g_dw * cos_h;
      g_cos_h += g_dw * ci;
    }
    AD g_wdh = g_gw * g;
    const AD g_g = g_gw * wdh;
    // f5 = x (x2 x2), x = max(1 - wo.h, 0)
    const AD g_x4 = g_f5 * x;
    const AD g_x2 = 2.0 * g_x4 * x2;
    const AD g_x = g_f5 * x4 + 2.0 * g_x2 * x;
    if (1.0f - wdh >= 0.0f) g_wdh -= g_x;
    AD g_co = 0.0;
    smith_g1_adj(ci, a2, g_g * g1o, g_ci, g_a2);
    smith_g1_adj(cos_o, a2, g_g * g1i, g_co, g_a2);
    // cos_o = dir . n, wo.h = -d_in . h
    g_dir = dadd(g_dir, dscale(g_co, up(n)));
    g_n = dadd(g_n, dscale(g_co, up(dir)));
    g_h = dscale(-g_wdh, up(d_in));
    g_din = dsub(g_din, dscale(g_wdh, up(h)));
  }
  if (cos_i >= 1e-6f && cos_i <= 1.0f) g_cos_i += g_ci;
  // dir = reflect(d_in, h), h = rotate_about(n, cos_h, phi)
  reflect_adj(d_in, h, g_dir, g_din, g_h);
  rotate_about_adj<true>(n, cos_h, phi, g_h, g_n, g_cos_h);
  // cos_h = sqrt(clamp(q, 0, 1)), q = (1 - xi1) / (1 + (a2 - 1) xi1)
  if (q > 0.0f && q <= 1.0f) {
    const AD g_q = g_cos_h * 0.5 / sqrt((AD)q);
    g_a2 -= g_q * (AD)(1.0f - xi1) / ((AD)den_q * den_q) * xi1;
  }
  // a2 = alpha^2, alpha = clamp(r^2, 1e-4, 1)
  if (rr >= 1e-4f && rr <= 1.0f) acc_d(acc, macc + 25, 2.0 * g_a2 * alpha * 2.0 * rough);
}

// The Ward lobe (ward_lobe) recomputed in float, and its adjoint, as
// ggx_adj's (kExact's conventions): the roughness columns 25 and, where it is positive, 26
template <typename Acc>
PT_FN void ward_adj(const float* mat, int macc, V3 n, V3 d_in, float cos_i, float u0, float u1,
                    D3 g_w3, D3 g_dir, D3& g_n, D3& g_din, AD& g_cos_i, Acc acc) {
  const float rx = mat[25], ry = mat[26];
  const float ax = fminf(fmaxf(rx, 1e-3f), 1.0f);
  const float ay_in = ry > 0.0f ? ry : rx;
  const float ay = fminf(fmaxf(ay_in, 1e-3f), 1.0f);
  const float xi1 = fminf(fmaxf(u0, 1e-7f), ONE_MINUS_1E7);
  const float beta = TWO_PI * u1;
  const float cb = cosf(beta), sb = sinf(beta);
  const float d_inv = ax * ax * cb * cb + ay * ay * sb * sb;
  const float sq = sqrtf(fmaxf(d_inv, 1e-12f));
  const float inv_len = 1.0f / sq;
  const float acb = ax * cb, asb = ay * sb;
  const float cos_phi = acb * inv_len;
  const float sin_phi = asb * inv_len;
  const float lg = -logf(xi1);
  const float tan2 = lg * d_inv;
  const float sq1 = sqrtf(1.0f + tan2);
  const float cos_th = 1.0f / sq1;
  const float s2 = 1.0f - cos_th * cos_th;
  const float sin_th = sqrtf(fmaxf(s2, 0.0f));
  V3 t1, t2;
  not_axis_frame(n, t1, t2);
  const float ca = sin_th * cos_phi, cs = sin_th * sin_phi;
  const V3 h = vadd(vscale(cos_th, n), vadd(vscale(ca, t1), vscale(cs, t2)));
  const V3 dir = reflect(d_in, h);
  const float wdh = -vdot(d_in, h);
  const float cos_o = vdot(dir, n);
  AD g_cos_th = 0.0;
  D3 g_h = d3(0.0, 0.0, 0.0);
  if (cos_o > 0.0f && wdh > 0.0f) {
    // weight = w spec, w = (wi.h cos_th^3) sqrt(max(cos_o, 0) / clamp(cos_i))
    const float ct2 = cos_th * cos_th;
    const float c3 = cos_th * ct2;
    const float ci = fminf(fmaxf(cos_i, 1e-6f), 1.0f);
    const float ratio = fmaxf(cos_o, 0.0f) / ci;
    const float sr = sqrtf(ratio);
    const float p1 = wdh * c3;
    const float w = p1 * sr;
    const AD g_w = ddot(g_w3, d3(mat[3], mat[4], mat[5]));
    acc_d(acc, macc + 3, g_w3.x * w);
    acc_d(acc, macc + 4, g_w3.y * w);
    acc_d(acc, macc + 5, g_w3.z * w);
    const AD g_p1 = g_w * sr;
    const AD g_wdh = g_p1 * c3;
    const AD g_c3 = g_p1 * wdh;
    g_cos_th += g_c3 * ct2 + 2.0 * (g_c3 * cos_th) * cos_th;
    AD g_co = 0.0;
    if (ratio > 0.0f) {
      const AD g_ratio = g_w * p1 * 0.5 / sqrt((AD)ratio);
      g_co = g_ratio / ci;
      if (cos_i >= 1e-6f && cos_i <= 1.0f)
        g_cos_i -= g_ratio * (AD)fmaxf(cos_o, 0.0f) / ((AD)ci * ci);
    }
    g_dir = dadd(g_dir, dscale(g_co, up(n)));
    g_n = dadd(g_n, dscale(g_co, up(dir)));
    g_h = dscale(-g_wdh, up(d_in));
    g_din = dsub(g_din, dscale(g_wdh, up(h)));
  }
  reflect_adj(d_in, h, g_dir, g_din, g_h);
  // h = cos_th n + (sin_th cos_phi t1 + sin_th sin_phi t2), (t1, t2) the frame of n
  g_cos_th += ddot(g_h, up(n));
  g_n = dadd(g_n, dscale(cos_th, g_h));
  const AD g_ca = ddot(g_h, up(t1)), g_cs = ddot(g_h, up(t2));
  frame_adj<true>(n, dscale(ca, g_h), dscale(cs, g_h), g_n);
  const AD g_sin_th = g_ca * cos_phi + g_cs * sin_phi;
  const AD g_cos_phi = g_ca * sin_th, g_sin_phi = g_cs * sin_th;
  // sin_th = sqrt(max(1 - cos_th^2, 0)), cos_th = 1 / sqrt(1 + tan2)
  if (s2 > 0.0f) g_cos_th -= 2.0 * (g_sin_th * 0.5 / sqrt((AD)s2)) * cos_th;
  const AD g_tan2 = -g_cos_th / ((AD)sq1 * sq1) * 0.5 / sqrt((AD)(1.0f + tan2));
  AD g_dinv = g_tan2 * lg;
  // cos_phi = (ax cb) / len, sin_phi = (ay sb) / len, len = sqrt(max(d_inv, 1e-12))
  AD g_ax = g_cos_phi * inv_len * cb, g_ay = g_sin_phi * inv_len * sb;
  const AD g_inv = g_cos_phi * acb + g_sin_phi * asb;
  if (d_inv >= 1e-12f) g_dinv -= g_inv / ((AD)sq * sq) * 0.5 / sqrt((AD)fmaxf(d_inv, 1e-12f));
  // d_inv = ((ax ax) cb) cb + ((ay ay) sb) sb
  g_ax += 2.0 * (g_dinv * cb * cb) * ax;
  g_ay += 2.0 * (g_dinv * sb * sb) * ay;
  if (rx >= 1e-3f && rx <= 1.0f) acc_d(acc, macc + 25, g_ax);
  if (ay_in >= 1e-3f && ay_in <= 1.0f) acc_d(acc, macc + (ry > 0.0f ? 26 : 25), g_ay);
}

// BSDF sample at a non-emissive hit: the cotangents of the throughput
// multiplier, the origin and the direction -> those of p, the raw normal,
// the incoming direction and the material row (acc offset macc; the
// diffuse albedo's at cacc).  kSurf adds the Cook-Torrance and Ward lobes
// the microfacet and ward bits of `surf` switch on (sample_bsdf_c).
template <bool kSurf = false, typename Acc>
PT_FN void bsdf_adj(const float* mat, int macc, int cacc, V3 n_raw, V3 d_in, float u0, float u1,
                    float u2, int surf, D3 g_mult, D3 g_org, D3 g_dir, D3& g_p, D3& g_nraw,
                    D3& g_din, Acc acc) {
  const float cos_raw = vdot(d_in, n_raw);
  const bool entering = cos_raw < 0.0f;
  const V3 n = entering ? n_raw : vscale(-1.0f, n_raw);
  const float cos_i = fabsf(cos_raw);
  const bool is_refractive = mat[7] > 0.0f;
  const bool is_reflective = !is_refractive && (mat[6] > 0.0f);
  bool is_ct = false;
  if constexpr (kSurf) is_ct = (surf & SURF_MICROFACET) && is_reflective && mat[24] > 0.5f;
  const bool is_glossy = is_reflective && (mat[10] > 0.0f) && !is_ct;
  D3 g_n = d3(0.0, 0.0, 0.0);
  AD g_cos_i = 0.0;
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
      const D3 g_v = normalize_adj<kSurf>(vadd(vscale(eta_f, d_in), vscale(h_f, n)), g_dir);
      g_din = dadd(g_din, dscale(eta, g_v));
      g_n = dadd(g_n, dscale(h, g_v));
      const AD g_h = ddot(g_v, nn);
      AD g_eta = ddot(g_v, d) + g_h * r_cos_i;
      AD g_rci = g_h * eta;
      // cos_t = sqrt(max(1 - sin2, 1e-12))
      const AD g_sin2 =
          a2_f >= 1e-12f ? g_h * 0.5 / (kSurf ? sqrt((AD)fmaxf(a2_f, 1e-12f)) : cos_t) : 0.0;
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
  } else if (kSurf && is_ct) {
    if ((surf & SURF_WARD) && mat[24] > 1.5f)
      ward_adj(mat, macc, n, d_in, cos_i, u0, u1, g_mult, g_dir, g_n, g_din, g_cos_i, acc);
    else
      ggx_adj(mat, macc, n, d_in, cos_i, u0, u1, g_mult, g_dir, g_n, g_din, g_cos_i, acc);
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
      g_exp += g_q / e1 - g_q * (kSurf ? (AD)(exp_f + 2.0f) : exp_n + 2.0) / (e1 * e1);
    }
    D3 g_dm = d3(0.0, 0.0, 0.0);
    AD g_ca = 0.0;
    rotate_about_adj<kSurf>(dm, ca, phi, g_dg, g_dm, g_ca);
    const AD ca_d = kSurf ? exp((AD)(logf(fmaxf(u0, 1e-9f)) / e1_f)) : (AD)ca;
    g_exp += g_ca * ca_d * (-lg / (e1 * e1));
    reflect_adj(d_in, n, g_dm, g_din, g_n);
    if (spec_exp >= 1e-6f) acc_d(acc, macc + 10, g_exp);
  } else if (is_reflective) {
    acc_d(acc, macc + 3, g_mult.x);
    acc_d(acc, macc + 4, g_mult.y);
    acc_d(acc, macc + 5, g_mult.z);
    reflect_adj(d_in, n, g_dir, g_din, g_n);
  } else {
    acc_d(acc, cacc + 0, g_mult.x);
    acc_d(acc, cacc + 1, g_mult.y);
    acc_d(acc, cacc + 2, g_mult.z);
    cosine_hemisphere_adj<kSurf>(n, u0, u1, g_dir, g_n);
  }
  // origin = p + bias * n
  g_p = dadd(g_p, g_org);
  g_n = dadd(g_n, dscale(bias, g_org));
  g_nraw = entering ? dadd(g_nraw, g_n) : dsub(g_nraw, g_n);
  if constexpr (kSurf) {
    // cos_i = |d_in . n_raw| (the lobes' weights)
    const AD g_raw = cos_raw > 0.0f ? g_cos_i : (cos_raw < 0.0f ? -g_cos_i : 0.0);
    g_din = dadd(g_din, dscale(g_raw, up(n_raw)));
    g_nraw = dadd(g_nraw, dscale(g_raw, up(d_in)));
  }
}

// The light sample's point lp = F lp_obj + f (light table rows 0..11 of
// `lid`) and unit normal ln = normalize(Li^T ln_obj) (the light geom's
// inverse rows, lnw before the normalize): their cotangents -> the tables'
// (into the lane sums where `hot`)
template <bool kExact = false, bool kSums = false, typename Acc>
PT_FN void light_adj(const RowLayout& R, int lid, V3 lp_obj, V3 ln_obj, V3 lnw, D3 g_lp, D3 g_ln,
                     Acc acc, LaneSums* ls = nullptr, bool hot = false) {
  const D3 lpo = up(lp_obj), lno = up(ln_obj);
  const int lacc = R.ol + lid * LCOLS;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const AD gi = dcomp(g_lp, i);
    acc_sum<kSums>(acc, ls, hot, LS_POS + 4 * i + 0, lacc + 4 * i + 0, gi * lpo.x);
    acc_sum<kSums>(acc, ls, hot, LS_POS + 4 * i + 1, lacc + 4 * i + 1, gi * lpo.y);
    acc_sum<kSums>(acc, ls, hot, LS_POS + 4 * i + 2, lacc + 4 * i + 2, gi * lpo.z);
    acc_sum<kSums>(acc, ls, hot, LS_POS + 4 * i + 3, lacc + 4 * i + 3, gi);
  }
  const D3 g_lnw = normalize_adj<kExact>(lnw, g_ln);
  const int gacc = lid * GCOLS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const AD nj = dcomp(lno, j);
    acc_sum<kSums>(acc, ls, hot, LS_NRM + 3 * j + 0, gacc + 4 * j + 0, g_lnw.x * nj);
    acc_sum<kSums>(acc, ls, hot, LS_NRM + 3 * j + 1, gacc + 4 * j + 1, g_lnw.y * nj);
    acc_sum<kSums>(acc, ls, hot, LS_NRM + 3 * j + 2, gacc + 4 * j + 2, g_lnw.z * nj);
  }
}

// NEE connection that counted (its radiance cotangent g_rad) -> cotangents
// of p, the normal, the throughput, and the material, light, geom and
// scalar tables; the albedo is read from col, its cotangent goes to cacc;
// kSums: the light's and the scalar's columns to the lane sums ls
template <bool kExact = false, bool kSums = false, typename Acc>
PT_FN void nee_adj(const Tables& T, const RowLayout& R, const float* col, int cacc, V3 pf,
                   V3 normal, V3 d, V3 thr_f, float u4, float u5, float u6, float u7, D3 g_rad,
                   D3& g_p, D3& g_normal, D3& g_thr, Acc acc, LaneSums* ls = nullptr) {
  V3 lp_obj, ln_obj;
  const int lid = sample_light_obj(T.g, T.l, T.G, u4, u5, u6, u7, lp_obj, ln_obj);
  const bool hot = sums_take<kSums>(ls, lid);
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
  const V3 tc_f = vmul(thr_f, v3(col[0], col[1], col[2]));
  // ... and in double for the adjoint
  const AD sgn = sgn_f, dist = dist_f, rd = rd_f, cos_x = cos_x_f, cos_y = cos_y_f,
           md = md_f, cxy = cxy_f, gterm = gterm_f, ma = ma_f, mp = mp_f, ns = ns_f;
  const D3 n_shade = up(n_shade_f), tl = up(tl_f), wi = up(wi_f), ln = up(ln_f);
  const D3 emit = d3(L[13], L[14], L[15]);
  const D3 thr = up(thr_f);
  const D3 color = d3(col[0], col[1], col[2]);
  const D3 tc = up(tc_f);
  const D3 tce = up(vmul(tc_f, v3(L[13], L[14], L[15])));

  // nee_rgb = ns * ((thr * color) * emit)
  const AD g_ns = ddot(g_rad, tce);
  const D3 g_tce = dscale(ns, g_rad);
  const D3 g_tc = dmul(g_tce, emit);
  const int lacc = R.ol + lid * LCOLS;
  acc_sum<kSums>(acc, ls, hot, LS_EMIT + 0, lacc + 13, g_tce.x * tc.x);
  acc_sum<kSums>(acc, ls, hot, LS_EMIT + 1, lacc + 14, g_tce.y * tc.y);
  acc_sum<kSums>(acc, ls, hot, LS_EMIT + 2, lacc + 15, g_tce.z * tc.z);
  g_thr = dadd(g_thr, dmul(g_tc, color));
  acc_d(acc, cacc + 0, g_tc.x * thr.x);
  acc_d(acc, cacc + 1, g_tc.y * thr.y);
  acc_d(acc, cacc + 2, g_tc.z * thr.z);
  // ns = gterm / max(1 / max(area, 1e-20), 1e-20) / pi
  const AD g_a = g_ns * (AD)INV_PI;
  const AD g_gterm = g_a / mp;
  if (pdf_f >= 1e-20f && T.total_area >= 1e-20f) {
    const AD g_mp = -g_a * gterm / (mp * mp);
    acc_sum<kSums>(acc, ls, true, LS_AREA, R.os + 0, -g_mp / (ma * ma));
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
  if (dist2_f >= 1e-12f) g_dist2 += g_dist * 0.5 / (kExact ? sqrt((AD)md_f) : dist);
  g_tl = dadd(g_tl, dscale(2.0 * g_dist2, tl));
  // tl = lp - x, x = p + bias n_shade, n_shade = sgn normal
  g_p = dsub(g_p, g_tl);
  g_nsh = dsub(g_nsh, dscale((AD)RAY_BIAS, g_tl));
  g_normal = dadd(g_normal, dscale(sgn, g_nsh));
  light_adj<kExact, kSums>(R, lid, lp_obj, ln_obj, lnw, g_tl, g_ln, acc, ls, hot);
}

// ---- one replayed bounce ----------------------------------------------------

// The geometry of a bounce whose winner is replayed (gid, -1 on a miss):
// bounce_physics(replay=...)'s values, which equal pt::bounce<true>'s when
// the replay came from that bounce.  On a miss the lane keeps geom 0's row,
// material 0, t = 1 and a zero object-space ray, so p = o + d and the
// normal is zero.
struct Replay {
  bool rhit, hit, sphere;  // replayed a hit; the recompute hits; winner is a sphere
  int gc, mid;             // the winner's row (geom 0 on a miss) and material
  const float* gw;
  const float* mat;
  V3 oo, od;  // the winner's object-space ray
  float t;    // the winner's t, 1 on a miss
  V3 p, p_obj, n_obj, nw, normal;
};

PT_FN Replay replay_bounce(const Tables& T, V3 o, V3 d, int gid) {
  Replay r;
  r.rhit = gid >= 0;
  r.gc = r.rhit ? gid : 0;
  r.gw = T.g + r.gc * GCOLS;
  to_object(r.gw, o, d, r.oo, r.od);
  const float t_re = geom_t(r.gw, r.oo, r.od);
  r.hit = r.rhit && t_re < BIG;
  r.t = r.hit ? t_re : 1.0f;
  r.mid = r.hit ? (int)r.gw[13] : 0;
  r.mat = T.m + r.mid * MCOLS;
  r.sphere = r.hit && r.gw[12] == SPHERE;
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  r.p = vadd(o, vscale(r.t, d));
  r.p_obj = vadd(r.rhit ? r.oo : zero, vscale(r.t, r.rhit ? r.od : zero));
  r.n_obj = object_normal(r.sphere, r.p_obj);
  r.nw = world_normal_raw(r.gw, r.n_obj);
  r.normal = vnormalize(r.nw);
  return r;
}

PT_FN bool emission_counts(int nee, int dep, float prev_state) {
  return !nee || dep == 0 || fabsf(prev_state - 1.0f) < 0.5f;
}

// contrib = e * (thr * color) of a light hit whose emission counted; the
// albedo `color` is read from col and its cotangent goes to cacc (the
// material's own colour, or with a texture the columns the lane selected)
template <typename Acc>
PT_FN void emission_adj(const float* mat, int macc, const float* col, int cacc, V3 thr,
                        D3 g_contrib, D3& g_thr, Acc acc) {
  const AD e = mat[9];
  const D3 color = d3(col[0], col[1], col[2]), th = up(thr);
  const D3 g_tc = dscale(e, g_contrib);
  acc_d(acc, macc + 9, ddot(g_contrib, dmul(th, color)));
  acc_d(acc, cacc + 0, g_tc.x * th.x);
  acc_d(acc, cacc + 1, g_tc.y * th.y);
  acc_d(acc, cacc + 2, g_tc.z * th.z);
  g_thr = dadd(g_thr, dmul(g_tc, color));
}

// The winner's part of a replayed bounce's adjoint: the cotangents of the hit
// point p, the unit normal and, with kT, of the winner's t itself (g_t_in:
// the volumetric segment's attenuation) and, with kP, of the object-space
// hit point (g_pobj_in: the bump's phase) -> those of o, d and the winner's
// geom row.  A miss (t = 1, zero normal) passes p's to o and d only.
template <bool kT = false, bool kP = false, typename Acc>
PT_FN void winner_adj(const Replay& r, V3 o, V3 d, D3 g_p, D3 g_normal, D3& g_o, D3& g_d,
                      Acc acc, AD g_t_in = 0.0, D3 g_pobj_in = D3{0.0, 0.0, 0.0}) {
  const float* gw = r.gw;
  const D3 zero = d3(0.0, 0.0, 0.0);
  // ---- normal = normalize(M3^T n_obj)
  const D3 g_nw = normalize_adj<kP>(r.nw, g_normal);
  const int gacc = r.gc * GCOLS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const AD nj = comp(r.n_obj, j);
    acc_d(acc, gacc + 4 * j + 0, g_nw.x * nj);
    acc_d(acc, gacc + 4 * j + 1, g_nw.y * nj);
    acc_d(acc, gacc + 4 * j + 2, g_nw.z * nj);
  }
  D3 g_pobj = zero;
  if (r.sphere) {  // a cube's normal is a sign, a miss's zero: no cotangent
    const D3 g_nobj = d3(gw[0] * g_nw.x + gw[1] * g_nw.y + gw[2] * g_nw.z,
                         gw[4] * g_nw.x + gw[5] * g_nw.y + gw[6] * g_nw.z,
                         gw[8] * g_nw.x + gw[9] * g_nw.y + gw[10] * g_nw.z);
    g_pobj = normalize_adj<kP>(r.p_obj, g_nobj);
  }
  if constexpr (kP) g_pobj = dadd(g_pobj, g_pobj_in);  // a miss's p_obj reaches nothing

  // ---- p_obj = oo + t od, p = o + t d, t of the winner (1 on a miss)
  D3 g_oo = g_pobj;
  D3 g_od = dscale(r.t, g_pobj);
  AD g_t = ddot(g_pobj, up(r.od)) + ddot(g_p, up(d));
  if constexpr (kT) g_t += g_t_in;
  g_o = dadd(g_o, g_p);
  g_d = dadd(g_d, dscale(r.t, g_p));
  if (!r.rhit) return;  // no winner: nothing reaches a geom row
  if (r.hit) {
    if (r.sphere)
      sphere_t_adj<kP>(r.oo, r.od, g_t, g_oo, g_od);
    else
      cube_t_adj<kP>(r.oo, r.od, g_t, g_oo, g_od);
  }

  // ---- oo = M3 o + m3, od = M3 d (geom table rows 0..11)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const AD goi = dcomp(g_oo, i), gdi = dcomp(g_od, i);
    acc_d(acc, gacc + 4 * i + 0, goi * o.x + gdi * d.x);
    acc_d(acc, gacc + 4 * i + 1, goi * o.y + gdi * d.y);
    acc_d(acc, gacc + 4 * i + 2, goi * o.z + gdi * d.z);
    acc_d(acc, gacc + 4 * i + 3, goi);
  }
  g_o = dadd(g_o, d3(gw[0] * g_oo.x + gw[4] * g_oo.y + gw[8] * g_oo.z,
                     gw[1] * g_oo.x + gw[5] * g_oo.y + gw[9] * g_oo.z,
                     gw[2] * g_oo.x + gw[6] * g_oo.y + gw[10] * g_oo.z));
  g_d = dadd(g_d, d3(gw[0] * g_od.x + gw[4] * g_od.y + gw[8] * g_od.z,
                     gw[1] * g_od.x + gw[5] * g_od.y + gw[9] * g_od.z,
                     gw[2] * g_od.x + gw[6] * g_od.y + gw[10] * g_od.z));
}

// ---- the surface blocks of a replayed bounce (kSurf) ------------------------

// The surface blocks of a replayed bounce, recomputed in float as
// pt::bounce<..., kSurf> ran them (T.surf names the blocks): the diffuse
// albedo's three columns (the material's colour, or texture_color2 where the
// checker or stripes pattern picks it) and the shading normal (bumped where
// the material's bump scale is positive).  Without kSurf: the material's
// colour and the geometric normal.
struct SurfReplay {
  const float* col;  // the albedo's columns in the material row
  int ccol;          // their offset in the row: 0 or 18
  bool bump;         // the bump ran
  V3 normal;         // the shading normal
};

template <bool kSurf>
PT_FN SurfReplay surf_replay(const Tables& T, const Replay& r) {
  SurfReplay s{r.mat, 0, false, r.normal};
  if constexpr (kSurf) {
    if ((T.surf & SURF_TEXTURE) && texture_second(r.mat, r.p_obj)) {
      s.col = r.mat + 18;
      s.ccol = 18;
    }
    s.bump = (T.surf & SURF_BUMP) && r.mat[21] > 0.0f;
    if (s.bump) s.normal = bump_normal(r.mat, r.p_obj, r.normal);
  }
  return s;
}

PT_FN V3 albedo(const SurfReplay& s) { return v3(s.col[0], s.col[1], s.col[2]); }

// The bump's adjoint (bump_normal): the bumped normal's cotangent -> that
// of the geometric normal (returned), of the object-space hit point (added
// to g_pobj) and of the material's bump scale and amplitude (columns 21,
// 22).  The phases reach ~10^3 rad: their cosines are taken in double of
// the float arguments, as the float64 reference takes them.
template <typename Acc>
PT_FN D3 bump_adj(const float* mat, int macc, V3 p_obj, V3 normal, D3 g_nb, D3& g_pobj,
                  Acc acc) {
  V3 t1, t2;
  not_axis_frame(normal, t1, t2);
  const float ph1 = p_obj.x * (float)12.9898 + p_obj.y * (float)78.233 + p_obj.z * (float)37.719;
  const float ph2 = p_obj.x * (float)93.989 + p_obj.y * (float)26.651 + p_obj.z * (float)61.312;
  const float amp = mat[22], bs = mat[21];
  const float x1 = bs * ph1, x2 = bs * ph2;
  const float s1 = sinf(x1), s2 = sinf(x2);
  const float a1 = amp * s1, a2 = amp * s2;
  const V3 v = vadd(normal, vadd(vscale(a1, t1), vscale(a2, t2)));
  const D3 g_v = normalize_adj<true>(v, g_nb);
  const AD g_a1 = ddot(g_v, up(t1)), g_a2 = ddot(g_v, up(t2));
  D3 g_n = g_v;
  frame_adj<true>(normal, dscale(a1, g_v), dscale(a2, g_v), g_n);
  acc_d(acc, macc + 22, g_a1 * s1 + g_a2 * s2);
  const AD g_x1 = g_a1 * amp * cos((AD)x1), g_x2 = g_a2 * amp * cos((AD)x2);
  acc_d(acc, macc + 21, g_x1 * ph1 + g_x2 * ph2);
  const AD g_ph1 = g_x1 * bs, g_ph2 = g_x2 * bs;
  g_pobj = dadd(g_pobj, d3(g_ph1 * 12.9898 + g_ph2 * 93.989, g_ph1 * 78.233 + g_ph2 * 26.651,
                           g_ph1 * 37.719 + g_ph2 * 61.312));
  return g_n;
}

// The adjoint of bounce_physics(replay) alone, mask-free: the cotangents of
// its outputs (contrib, next origin, next direction, throughput multiplier)
// become those of its inputs, added to g_o, g_d, g_thr, and of the tables,
// added to acc.  Every lane is defined: a miss differentiates p = o + d and
// material 0's BSDF at the zero normal, a light hit its emission (when it
// counted) and its own material's BSDF.  The medium passes through and is
// not seen here.  kSurf: the textured albedo feeds the emission, the
// diffuse lobe and NEE, the bumped normal the BSDF and NEE, and the bump's
// adjoint turns the shading normal's cotangent into the geometric normal's
// and the object-space point's.  kSums: NEE's light and scalar columns to
// the lane sums ls (kernel 5).
template <bool kSurf = false, bool kSums = false, typename Acc>
PT_FN void physics_adj(const Tables& T, const RowLayout& R, const Replay& r, uint32_t base,
                       int dep, int nee, V3 o, V3 d, V3 thr, float prev_state, bool nee_add,
                       D3 g_contrib, D3 g_next_o, D3 g_next_d, D3 g_thr_mult, D3& g_o, D3& g_d,
                       D3& g_thr, Acc acc, LaneSums* ls = nullptr) {
  const int macc = R.om + r.mid * MCOLS;
  const SurfReplay s = surf_replay<kSurf>(T, r);
  const int cacc = macc + s.ccol;
  if (r.hit && r.mat[9] > 0.0f && emission_counts(nee, dep, prev_state))
    emission_adj(r.mat, macc, s.col, cacc, thr, g_contrib, g_thr, acc);

  // ---- BSDF and NEE
  const D3 zero = d3(0.0, 0.0, 0.0);
  D3 g_p = zero, g_normal = zero;
  bsdf_adj<kSurf>(r.mat, macc, cacc, s.normal, d, uniform(base, 0), uniform(base, 1),
                  uniform(base, 2), T.surf, g_thr_mult, g_next_o, g_next_d, g_p, g_normal, g_d,
                  acc);
  if (nee && nee_add)
    nee_adj<kSurf, kSums>(T, R, s.col, cacc, r.p, s.normal, d, thr, uniform(base, 4),
                          uniform(base, 5), uniform(base, 6), uniform(base, 7), g_contrib, g_p,
                          g_normal, g_thr, acc, ls);
  D3 g_pobj = zero;
  if constexpr (kSurf) {
    if (s.bump) g_normal = bump_adj(r.mat, macc, r.p_obj, r.normal, g_normal, g_pobj, acc);
  }
  winner_adj<false, kSurf>(r, o, d, g_p, g_normal, g_o, g_d, acc, 0.0, g_pobj);
}

// ---- participating media (the kVol instances of kernels 3 and 5) -----------

// The media part of a replayed bounce, recomputed in float as
// pt::bounce<kVol> ran it (bounce_pallas.py:1140-1168): the exponential
// free path, whether the lane scatters in the medium before its surface,
// the segment travelled and its Beer-Lambert attenuation, and on a surface
// event the BSDF sample.
struct VolBounce {
  float lnum;       // -log(clip(1 - u8)): the free path's numerator
  float free_path;  // BIG in a medium that does not scatter
  bool vs;          // an in-medium scatter before the surface
  float seg;        // the segment travelled: the free path, the winner's t, 0 on a miss
  V3 atten;         // exp(-sigma_a seg)
  SurfReplay s;     // the surface blocks (kSurf)
  Scatter sc;       // the surface event's BSDF sample (unset where vs)
  V3 thr_mult;      // atten, times sc.thr on a surface event
};

template <bool kSurf = false>
PT_FN VolBounce vol_bounce(const Tables& T, const Replay& r, uint32_t base, V3 d, Medium med) {
  VolBounce v;
  v.s = surf_replay<kSurf>(T, r);
  v.lnum = -logf(fminf(fmaxf(1.0f - uniform(base, 8), 1e-7f), 1.0f));
  v.free_path = med.s > 0.0f ? v.lnum / fmaxf(med.s, 1e-12f) : BIG;
  v.vs = r.hit && v.free_path < r.t;
  v.seg = v.vs ? v.free_path : (r.hit ? r.t : 0.0f);
  v.atten = v3(expf(-med.a.x * v.seg), expf(-med.a.y * v.seg), expf(-med.a.z * v.seg));
  v.thr_mult = v.atten;
  if (!v.vs) {
    v.sc = sample_bsdf_c<kSurf>(r.mat, albedo(v.s), r.p, v.s.normal, d, uniform(base, 0),
                                uniform(base, 1), uniform(base, 2), T.surf);
    v.thr_mult = vmul(v.atten, v.sc.thr);
  }
  return v;
}

// Volumetric NEE at the scatter point o + fp d (bounce_pallas.py:1375-1450),
// isotropic phase: the light connection and its split sweep recomputed in
// float as pt::bounce ran them (the sweep detached: visibility is a
// comparison, the boundary distance occ_re a constant), and where the term
// counted the adjoint of
//   contrib += phase cos_yv / max(d2v, 1e-12) / max(1 / max(area, 1e-20), 1e-20)
//              * ((thr_a * exp(-(sigma_a + sigma_s) min(occ_re, distv))) * emit)
// into the cotangents of o, d, the free path, the attenuated throughput,
// the medium and the tables.
template <typename Acc>
PT_FN void vol_nee_adj(const Tables& T, const RowLayout& R, uint32_t base, V3 o, V3 d, float fp,
                       V3 thr_a, Medium med, D3 g_rad, D3& g_o, D3& g_d, AD& g_fp, D3& g_thr_a,
                       D3& g_sa, AD& g_ss, Acc acc) {
  V3 lp_obj, ln_obj;
  const int lid = sample_light_obj(T.g, T.l, T.G, uniform(base, 4), uniform(base, 5),
                                   uniform(base, 6), uniform(base, 7), lp_obj, ln_obj);
  const float* L = T.l + lid * LCOLS;
  const V3 lnw = world_normal_raw(T.g + lid * GCOLS, ln_obj);
  const V3 ln = vnormalize(lnw);
  const V3 vol_pos = vadd(o, vscale(fp, d));
  const V3 to_l = vsub(light_position(L, lp_obj), vol_pos);
  const float d2v = vdot(to_l, to_l);
  const float distv = sqrtf(fmaxf(d2v, 1e-12f));
  const float rd = 1.0f / distv;
  const V3 wiv = vscale(rd, to_l);
  const float cos_yv = -vdot(ln, wiv);
  if (!(cos_yv > 0.0f)) return;
  float occ_op, occ_re;
  occ_split(T, vol_pos, wiv, occ_op, occ_re);
  if (!(occ_op >= distv - SHADOW_SLACK)) return;
  const float seg_v = fminf(occ_re, distv);
  const V3 sig_t = v3(med.a.x + med.s, med.a.y + med.s, med.a.z + med.s);
  const V3 transmit = v3(expf(-sig_t.x * seg_v), expf(-sig_t.y * seg_v), expf(-sig_t.z * seg_v));
  const float md = fmaxf(d2v, 1e-12f);
  const float ma = fmaxf(T.total_area, 1e-20f);
  const float pdf = 1.0f / ma;
  const float mp = fmaxf(pdf, 1e-20f);
  const float a1 = INV_FOUR_PI * cos_yv;
  const float a2 = a1 / md;
  const float scale_v = a2 / mp;
  const V3 tt = vmul(thr_a, transmit);
  const V3 emit = v3(L[13], L[14], L[15]);

  // contrib = scale_v * (tt * emit), tt = thr_a * transmit
  const AD g_scale = ddot(g_rad, up(vmul(tt, emit)));
  const D3 g_tt = dmul(dscale(scale_v, g_rad), up(emit));
  const int lacc = R.ol + lid * LCOLS;
  acc_d(acc, lacc + 13, scale_v * g_rad.x * tt.x);
  acc_d(acc, lacc + 14, scale_v * g_rad.y * tt.y);
  acc_d(acc, lacc + 15, scale_v * g_rad.z * tt.z);
  g_thr_a = dadd(g_thr_a, dmul(g_tt, up(transmit)));
  const D3 g_tr = dmul(g_tt, up(thr_a));
  // transmit = exp(-sig_t seg_v), sig_t = sigma_a + sigma_s
  const D3 e = dmul(g_tr, up(transmit));
  const D3 g_sig = dscale(-(AD)seg_v, e);
  g_sa = dadd(g_sa, g_sig);
  g_ss += g_sig.x + g_sig.y + g_sig.z;
  const AD g_segv = -ddot(e, up(sig_t));
  // seg_v = min(occ_re, distv), occ_re detached
  AD g_occ = 0.0, g_distv = 0.0;
  min_adj(occ_re, distv, g_segv, g_occ, g_distv);
  // scale_v = ((phase cos_yv) / md) / mp, mp = max(1 / max(area, 1e-20), 1e-20)
  const AD g_a2 = g_scale / mp;
  const AD g_a1 = g_a2 / md;
  AD g_d2v = d2v >= 1e-12f ? -g_a2 * a1 / ((AD)md * md) : 0.0;
  const AD g_cos = g_a1 * (AD)INV_FOUR_PI;
  if (pdf >= 1e-20f && T.total_area >= 1e-20f) {
    const AD g_mp = -g_scale * a2 / ((AD)mp * mp);
    acc_d(acc, R.os + 0, -g_mp / ((AD)ma * ma));
  }
  // cos_yv = -ln . wiv
  const D3 g_ln = dscale(-g_cos, up(wiv));
  const D3 g_wiv = dscale(-g_cos, up(ln));
  // wiv = (1 / distv) to_l, distv = sqrt(max(d2v, 1e-12)), d2v = to_l . to_l
  D3 g_tl = dscale(rd, g_wiv);
  g_distv -= ddot(g_wiv, up(to_l)) / ((AD)distv * distv);
  if (d2v >= 1e-12f) g_d2v += g_distv * 0.5 / distv;
  g_tl = dadd(g_tl, dscale(2.0 * g_d2v, up(to_l)));
  // to_l = lp - vol_pos, vol_pos = o + fp d
  g_o = dsub(g_o, g_tl);
  g_d = dsub(g_d, dscale(fp, g_tl));
  g_fp -= ddot(g_tl, up(d));
  light_adj(R, lid, lp_obj, ln_obj, lnw, g_tl, g_ln, acc);
}

// The adjoint of bounce_physics(replay) with the volumetric feature
// (kernels 3v and 5v), mask-free as physics_adj: the cotangents of contrib,
// the next origin and direction, the throughput multiplier and the medium
// entered (g_ma, g_ms) become those of o, d, thr, the medium (g_sa, g_ss;
// added) and the tables.  A lane that scatters in the medium
// differentiates its free path (through the scatter point, the
// attenuation and the volumetric NEE); its direction comes from uniforms
// alone.  A surface event differentiates physics_adj's terms at the
// attenuated throughput, the attenuation over the winner's t and the
// medium switch of a transmission.  Only the branch the lane took is
// differentiated, so the 0 * inf of a 1e30 free path never arises.
// `bsdf` false skips the BSDF sample and the medium switch (kernel 5 on a
// light hit, whose continuation has no cotangent).  The replay planes are
// the forward's: nee_add is 0 on a lane that scatters.  kSurf: a surface
// event differentiates the surface blocks as physics_adj<kSurf> does (v.s).
template <bool kSurf = false, typename Acc>
PT_FN void physics_adj_vol(const Tables& T, const RowLayout& R, const Replay& r,
                           const VolBounce& v, uint32_t base, int dep, int nee, int vol_nee, V3 o,
                           V3 d, V3 thr, Medium med, float prev_state, bool nee_add, bool bsdf,
                           D3 g_contrib, D3 g_next_o, D3 g_next_d, D3 g_thr_mult, D3 g_ma,
                           AD g_ms, D3& g_o, D3& g_d, D3& g_thr, D3& g_sa, AD& g_ss, Acc acc) {
  const D3 zero = d3(0.0, 0.0, 0.0);
  const V3 thr_a = vmul(thr, v.atten);  // the throughput the bounce's terms see
  D3 g_thr_a = zero, g_atten = zero, g_p = zero, g_normal = zero;
  AD g_fp = 0.0;
  const int macc = R.om + r.mid * MCOLS;
  const int cacc = macc + v.s.ccol;
  D3 g_pobj = zero;
  if (!v.vs) {
    if (r.hit && r.mat[9] > 0.0f && emission_counts(nee, dep, prev_state))
      emission_adj(r.mat, macc, v.s.col, cacc, thr_a, g_contrib, g_thr_a, acc);
    if (bsdf) {
      // thr_mult = atten * sc.thr
      g_atten = dmul(g_thr_mult, up(v.sc.thr));
      bsdf_adj<kSurf>(r.mat, macc, cacc, v.s.normal, d, uniform(base, 0), uniform(base, 1),
                      uniform(base, 2), T.surf, dmul(g_thr_mult, up(v.atten)), g_next_o,
                      g_next_d, g_p, g_normal, g_d, acc);
      // the medium entered: the material's on a transmission inwards (its
      // absorption, has_scatter * scatter_coeff), vacuum outwards, else
      // the same
      if (!v.sc.transmitted) {
        g_sa = dadd(g_sa, g_ma);
        g_ss += g_ms;
      } else if (v.sc.entering) {
        acc_d(acc, macc + 11, g_ma.x);
        acc_d(acc, macc + 12, g_ma.y);
        acc_d(acc, macc + 13, g_ma.z);
        acc_d(acc, macc + 14, g_ms * r.mat[15]);
        acc_d(acc, macc + 15, g_ms * r.mat[14]);
      }
    }
    if (nee && nee_add)
      nee_adj<kSurf>(T, R, v.s.col, cacc, r.p, v.s.normal, d, thr_a, uniform(base, 4),
              uniform(base, 5), uniform(base, 6), uniform(base, 7), g_contrib, g_p, g_normal,
              g_thr_a, acc);
    if constexpr (kSurf) {
      if (v.s.bump) g_normal = bump_adj(r.mat, macc, r.p_obj, r.normal, g_normal, g_pobj, acc);
    }
  } else {
    // next origin: the scatter point o + fp d; the medium stays
    g_o = dadd(g_o, g_next_o);
    g_d = dadd(g_d, dscale(v.free_path, g_next_o));
    g_fp += ddot(g_next_o, up(d));
    g_atten = g_thr_mult;
    g_sa = dadd(g_sa, g_ma);
    g_ss += g_ms;
    if (nee && vol_nee && T.any_light)
      vol_nee_adj(T, R, base, o, d, v.free_path, thr_a, med, g_contrib, g_o, g_d, g_fp, g_thr_a,
                  g_sa, g_ss, acc);
  }
  // thr_a = thr * atten, atten = exp(-sigma_a seg)
  g_thr = dadd(g_thr, dmul(g_thr_a, up(v.atten)));
  g_atten = dadd(g_atten, dmul(g_thr_a, up(thr)));
  const D3 ga = dmul(g_atten, up(v.atten));
  g_sa = dsub(g_sa, dscale(v.seg, ga));
  const AD g_seg = -ddot(ga, up(med.a));
  if (v.vs) {
    // seg = fp = lnum / max(sigma_s, 1e-12)
    g_fp += g_seg;
    const float ms = fmaxf(med.s, 1e-12f);
    if (med.s >= 1e-12f) g_ss -= g_fp * v.lnum / ((AD)ms * ms);
  } else {
    winner_adj<true, kSurf>(r, o, d, g_p, g_normal, g_o, g_d, acc, r.hit ? g_seg : 0.0, g_pobj);
  }
}

}  // namespace pt

#ifdef __CUDACC__

namespace pt {

// the geom, material and light tables of a block into shared memory
__device__ __forceinline__ void load_tables(float* smem, const float* gtab, int G,
                                            const float* mtab, int M, const float* ltab) {
  for (int i = threadIdx.x; i < G * GCOLS; i += blockDim.x) smem[i] = gtab[i];
  float* s_m = smem + G * GCOLS;
  for (int i = threadIdx.x; i < M * MCOLS; i += blockDim.x) s_m[i] = mtab[i];
  float* s_l = s_m + M * MCOLS;
  for (int i = threadIdx.x; i < G * LCOLS; i += blockDim.x) s_l[i] = ltab[i];
}

PT_HD size_t table_floats(int G, int M) { return (size_t)(G * GCOLS + M * MCOLS + G * LCOLS); }

// The row sum of the reverse kernels (3 and 5): row[j] = the sum over the
// blocks' partial rows of column j.  A block of row_sum_segments takes 32
// neighbouring columns (a warp reads 128 contiguous bytes of a row) and one
// segment of rows; its 8 warps add the segment's rows w, w + 8, ... in order
// and then the 8 sums in warp order.  Up to ROW_SUM_SEG rows that is the
// whole sum; above, a first pass writes one row per segment to scratch and a
// second adds those in segment order.  Every order is fixed, so the row does
// not change from run to run given the partial rows.
constexpr int ROW_SUM_COLS = 32;
constexpr int ROW_SUM_WARPS = 8;
constexpr int ROW_SUM_SEG = 64;  // partial rows per segment of the first pass

__global__ void __launch_bounds__(ROW_SUM_COLS * ROW_SUM_WARPS)
row_sum_segments(const float* __restrict__ in, int nrows, int k, int seg,
                 float* __restrict__ out) {
  __shared__ float part[ROW_SUM_WARPS][ROW_SUM_COLS];
  const int j = blockIdx.x * ROW_SUM_COLS + threadIdx.x;
  const int r0 = blockIdx.y * seg, r1 = min(r0 + seg, nrows);
  float s = 0.0f;
  if (j < k)
    for (int r = r0 + threadIdx.y; r < r1; r += ROW_SUM_WARPS) s += in[(size_t)r * k + j];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < k) {
    float t = part[0][threadIdx.x];
    for (int w = 1; w < ROW_SUM_WARPS; ++w) t += part[w][threadIdx.x];
    out[(size_t)blockIdx.y * k + j] = t;
  }
}

// the place of a reverse kernel's per-lane sums in its shared memory, in
// floats: after the tables, at an 8-byte boundary
__host__ __device__ __forceinline__ size_t sums_offset(int G, int M) {
  return (table_floats(G, M) + 1) & ~(size_t)1;
}

// The row sums of a whole warp into the row (every thread of the warp calls
// it): where every lane that ran has the same winner geom and material rows,
// each slot is summed over the warp with shuffles in a fixed order and added
// once; else each lane adds its own (row_sums_add).
__device__ __forceinline__ void warp_row_sums_add(const RowSums& a) {
  constexpr unsigned FULL = 0xffffffffu;
  const int g0 = __reduce_max_sync(FULL, a.g0), m0 = __reduce_max_sync(FULL, a.m0);
  if (g0 == ROW_NONE) return;  // no lane of the warp ran its adjoint
  if (!__all_sync(FULL, a.g0 == ROW_NONE || (a.g0 == g0 && a.m0 == m0))) {
    row_sums_add(a);
    return;
  }
  const RowSums w{a.row, a.s, a.stride, g0, m0};
  for (int k = 0; k < ROW_SUMS; ++k) {
    AD v = a.s[k * a.stride];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if ((threadIdx.x & 31) == 0 && v != 0.0) acc_d(a.row, row_sum_col(w, k), v);
  }
}

// ---- the lane order of the reverse kernels (5v, 5s, 3s) --------------------

constexpr int ORDER_THREADS = ORDER_KEYS;  // the place pass scans the counts one per thread

// The lane order's first pass: each lane's key, key_of(i) in [0,
// ORDER_KEYS), and the keys' counts, a block's in shared memory and then
// added to counts[]
template <typename Key>
__global__ void __launch_bounds__(ORDER_THREADS)
lane_order_keys(Key key_of, int n, int* __restrict__ keys, int* __restrict__ counts) {
  __shared__ int s_count[ORDER_KEYS];
  s_count[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int key = key_of((size_t)i);
    keys[i] = key;
    atomicAdd(&s_count[key], 1);
  }
  __syncthreads();
  if (s_count[threadIdx.x]) atomicAdd(&counts[threadIdx.x], s_count[threadIdx.x]);
}

// The second pass: order[] holds the lanes grouped by key in increasing key
// order.  A warp's lanes of one key take consecutive places in lane order
// (one atomic per warp and key on fill[]), so the reverse kernel's loads
// stay in runs; the warps' runs are in no fixed order.
__global__ void __launch_bounds__(ORDER_THREADS)
lane_order_place(const int* __restrict__ keys, const int* __restrict__ counts, int n,
                 int* __restrict__ fill, int* __restrict__ order) {
  __shared__ int s_scan[ORDER_KEYS];
  s_scan[threadIdx.x] = counts[threadIdx.x];
  __syncthreads();
  for (int off = 1; off < ORDER_KEYS; off <<= 1) {  // inclusive scan of the counts
    const int add = threadIdx.x >= off ? s_scan[threadIdx.x - off] : 0;
    __syncthreads();
    s_scan[threadIdx.x] += add;
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int key = i < n ? keys[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (i < n && lane == leader) base = atomicAdd(&fill[key], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (i < n) {
    const int start = s_scan[key] - counts[key];  // the exclusive scan
    order[start + base + __popc(peers & ((1u << lane) - 1u))] = i;
  }
}

// the ints of scratch that the lane order of n lanes needs
inline int lane_order_ints(int n) { return 2 * n + 2 * ORDER_KEYS; }

// The lane order of n >= 1 lanes by key_of into scratch (lane_order_ints(n)
// ints: the keys, the order, the counts and the fill counters)
template <typename Key>
cudaError_t lane_order(Key key_of, int n, int* scratch, cudaStream_t stream) {
  int* keys = scratch;
  int* order = keys + n;
  int* counts = order + n;
  int* fill = counts + ORDER_KEYS;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * 2 * ORDER_KEYS, stream);
  if (e != cudaSuccess) return e;
  const int blocks = (n + ORDER_THREADS - 1) / ORDER_THREADS;
  lane_order_keys<<<blocks, ORDER_THREADS, 0, stream>>>(key_of, n, keys, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lane_order_place<<<blocks, ORDER_THREADS, 0, stream>>>(keys, counts, n, fill, order);
  return cudaGetLastError();
}

// rows of scratch that row_sum needs beside `nrows` partial rows
inline int row_sum_scratch(int nrows) {
  const int segs = (nrows + ROW_SUM_SEG - 1) / ROW_SUM_SEG;
  return segs > 1 ? segs : 0;
}

// row = the sum of the nrows >= 1 partial rows of k floats, with
// row_sum_scratch(nrows) rows of scratch
inline cudaError_t row_sum(const float* partial, int nrows, int k, float* scratch, float* row,
                           cudaStream_t stream) {
  const dim3 block(ROW_SUM_COLS, ROW_SUM_WARPS);
  const int tiles = (k + ROW_SUM_COLS - 1) / ROW_SUM_COLS;
  const int segs = (nrows + ROW_SUM_SEG - 1) / ROW_SUM_SEG;
  if (segs > 1) {
    row_sum_segments<<<dim3(tiles, segs), block, 0, stream>>>(partial, nrows, k, ROW_SUM_SEG,
                                                              scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    partial = scratch;
    nrows = segs;
  }
  row_sum_segments<<<dim3(tiles, 1), block, 0, stream>>>(partial, nrows, k, nrows, row);
  return cudaGetLastError();
}

}  // namespace pt

#endif  // __CUDACC__
