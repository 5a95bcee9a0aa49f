// One lane of the per-bounce kernel (csrc/bounce.cu) and of its mesh-merge
// variant (csrc/bounce_merge.cu): reads a lane's planes, runs pt::bounce in
// its mask-free form and writes every output.  The grouped kernel of
// csrc/bounce.cu (2r-v) runs the same lane in two phases (lane_sweep,
// lane_shade) with the lane's state in shared-memory planes between them.  Also
// compiled as host C++ by tests/kernel_host_harness.cpp.

#pragma once

#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

// one lane of the per-bounce kernel; also compiled as host C++ by
// tests/kernel_host_harness.cpp.  The medium rows are mw = 4 or 5 wide
// (the phase g in column 4); the output g column is the medium entered with
// kHg, 0 with kVol alone (its g is never read), and passes through in
// vacuum.  kMerge (csrc/bounce_merge.cu) reads the lane's outside mesh
// winner from the planes mesh_in [8, n] (t, hit point, world normal,
// material id) and, where not null, mesh_uv [3, n] (u, v, 1 where valid),
// and under NEE writes the deferred shadow ray to deferred [11, n] (x, wi,
// its length, the NEE rgb, 1 where the analytic geoms leave it clear).
// pre: the lane's in-kernel mesh winner, found before the lane by kernel
// 2's block sweep (bounce.cu), or null to sweep here.
template <bool kVol = false, bool kHg = false, bool kSurf = false, bool kTex = false,
          bool kMerge = false>
PT_FN void bounce_lane(const Tables& T, uint32_t seed, int nee, int vol_nee, int mw, size_t i,
                       const float* __restrict__ origin, const float* __restrict__ direction,
                       const float* __restrict__ thr, const uint32_t* __restrict__ sample,
                       const int32_t* __restrict__ depth, const float* __restrict__ prev,
                       const float* __restrict__ medium, float* __restrict__ contrib,
                       float* __restrict__ next_o, float* __restrict__ next_d,
                       float* __restrict__ thr_mult, uint8_t* __restrict__ terminate,
                       float* __restrict__ wspec, float* __restrict__ rru,
                       float* __restrict__ out_medium, float* __restrict__ replay_gid,
                       float* __restrict__ replay_nee, float* __restrict__ tex_u = nullptr,
                       float* __restrict__ tex_v = nullptr,
                       float* __restrict__ tex_slot = nullptr,
                       const float* __restrict__ mesh_in = nullptr,
                       const float* __restrict__ mesh_uv = nullptr,
                       float* __restrict__ deferred = nullptr, size_t n = 0,
                       const MeshHit* pre = nullptr) {
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  const V3 t = v3(thr[3 * i], thr[3 * i + 1], thr[3 * i + 2]);
  const int dep = depth[i];
  const uint32_t base = bounce_base(seed, sample[i] * 0x85EBCA6Bu, dep);
  const float* mi = medium + (size_t)mw * i;
  Medium med{};
  if constexpr (kVol) med = Medium{v3(mi[0], mi[1], mi[2]), mi[3], mw > 4 ? mi[4] : 0.0f};
  MeshHit ext{};
  if constexpr (kMerge) {
    ext.t = mesh_in[i];
    ext.p_obj = v3(mesh_in[n + i], mesh_in[2 * n + i], mesh_in[3 * n + i]);
    ext.normal = v3(mesh_in[4 * n + i], mesh_in[5 * n + i], mesh_in[6 * n + i]);
    ext.mid = (int)mesh_in[7 * n + i];
    if (mesh_uv != nullptr) {
      ext.uv_u = mesh_uv[i];
      ext.uv_v = mesh_uv[n + i];
      ext.uv_valid = mesh_uv[2 * n + i] > 0.5f;
    }
  }
  const Bounce b = bounce<true, kVol, kHg, kSurf, kTex, kMerge>(T, base, dep, nee, o, d, t,
                                                                prev[i], med, vol_nee, ext, pre);
  const V3* vec[4] = {&b.contrib, &b.next_o, &b.next_d, &b.thr_mult};
  float* out[4] = {contrib, next_o, next_d, thr_mult};
  for (int k = 0; k < 4; ++k) {
    out[k][3 * i] = vec[k]->x;
    out[k][3 * i + 1] = vec[k]->y;
    out[k][3 * i + 2] = vec[k]->z;
  }
  terminate[i] = b.terminate ? 1 : 0;
  wspec[i] = b.wspec;
  rru[i] = uniform(base, 3);
  float* mo = out_medium + (size_t)mw * i;
  if constexpr (kVol) {
    mo[0] = b.medium.a.x;
    mo[1] = b.medium.a.y;
    mo[2] = b.medium.a.z;
    mo[3] = b.medium.s;
    if (mw > 4) mo[4] = kHg ? b.medium.g : 0.0f;
  } else {
    for (int k = 0; k < mw; ++k) mo[k] = mi[k];  // vacuum: the medium passes through
  }
  if (replay_gid != nullptr) {
    replay_gid[i] = (float)b.gid;
    replay_nee[i] = b.nee_add ? 1.0f : 0.0f;
  }
  if constexpr (kTex) {
    tex_u[i] = b.tex_u;
    tex_v[i] = b.tex_v;
    tex_slot[i] = b.tex_slot;
  }
  if constexpr (kMerge) {
    if (deferred != nullptr) {
      const float planes[11] = {b.sh_x.x,      b.sh_x.y,      b.sh_x.z,      b.sh_wi.x,
                                b.sh_wi.y,     b.sh_wi.z,     b.sh_dist,     b.nee_rgb.x,
                                b.nee_rgb.y,   b.nee_rgb.z,   b.cand_vis};
      for (int k = 0; k < 11; ++k) deferred[k * n + i] = planes[k];
    }
  }
}

// ---- kernel 2's grouped instance (csrc/bounce.cu:bounce_kernel_grouped,
// 2r-v: kVol with the replay planes, no hg, no surface features, no
// meshes): a block's lanes between the two phases, one shared-memory plane
// per value, a lane's slot its rank in the block's event order

// A lane's inputs, as bounce_lane reads them
struct LaneIn {
  V3 o, d, t;
  int dep;
  uint32_t base;
  float prev;
  Medium med;
};

constexpr int LP_FLOATS = 21;  // o, d, thr, prev, medium (4), best_t, w_o, w_d
constexpr int LP_INTS = 4;     // the lane's index, depth, RNG base, winner geom

struct LanePlanes {
  float* f;   // [LP_FLOATS][slots]
  int* ints;  // [LP_INTS][slots]
  int slots;
  PT_HD float& at(int k, int s) const { return f[k * slots + s]; }
  PT_HD int& in(int k, int s) const { return ints[k * slots + s]; }
};

// phase 1: lane i's inputs and nearest hit; returns its event key.  The
// medium's g column (mw = 5) is not read: without hg no bounce reads it.
PT_FN int lane_sweep(const Tables& T, uint32_t seed, int mw, size_t i,
                     const float* __restrict__ origin, const float* __restrict__ direction,
                     const float* __restrict__ thr, const uint32_t* __restrict__ sample,
                     const int32_t* __restrict__ depth, const float* __restrict__ prev,
                     const float* __restrict__ medium, LaneIn& L, Nearest& h) {
  L.o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  L.d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  L.t = v3(thr[3 * i], thr[3 * i + 1], thr[3 * i + 2]);
  L.dep = depth[i];
  L.base = bounce_base(seed, sample[i] * 0x85EBCA6Bu, L.dep);
  L.prev = prev[i];
  const float* mi = medium + (size_t)mw * i;
  L.med = Medium{v3(mi[0], mi[1], mi[2]), mi[3], 0.0f};
  h = nearest_hit(T, L.o, L.d);
  return event_key(T, L.base, L.med, h);
}

PT_FN void planes_put(const LanePlanes& P, int s, size_t i, const LaneIn& L, const Nearest& h) {
  const float f[LP_FLOATS] = {L.o.x,     L.o.y,     L.o.z,     L.d.x,    L.d.y,    L.d.z,
                              L.t.x,     L.t.y,     L.t.z,     L.prev,   L.med.a.x, L.med.a.y,
                              L.med.a.z, L.med.s,   h.best_t,  h.w_o.x,  h.w_o.y,  h.w_o.z,
                              h.w_d.x,   h.w_d.y,   h.w_d.z};
  for (int k = 0; k < LP_FLOATS; ++k) P.at(k, s) = f[k];
  P.in(0, s) = (int)i;
  P.in(1, s) = L.dep;
  P.in(2, s) = (int)L.base;
  P.in(3, s) = h.gid;
}

// phase 2's inputs: the lane in slot s; returns its index
PT_FN size_t slot_get(const LanePlanes& P, int s, LaneIn& L, Nearest& h) {
  L.o = v3(P.at(0, s), P.at(1, s), P.at(2, s));
  L.d = v3(P.at(3, s), P.at(4, s), P.at(5, s));
  L.t = v3(P.at(6, s), P.at(7, s), P.at(8, s));
  L.prev = P.at(9, s);
  L.med = Medium{v3(P.at(10, s), P.at(11, s), P.at(12, s)), P.at(13, s), 0.0f};
  h = Nearest{P.at(14, s), P.in(3, s), v3(P.at(15, s), P.at(16, s), P.at(17, s)),
              v3(P.at(18, s), P.at(19, s), P.at(20, s))};
  L.dep = P.in(1, s);
  L.base = (uint32_t)P.in(2, s);
  return (size_t)P.in(0, s);
}

// phase 2: lane i shaded after its nearest hit h (pt::bounce with kShade),
// every output stored at its own index, as bounce_lane stores them in its
// kVol instance with the replay planes (its own copy: bounce_lane keeps
// the code the other instances compile as before)
PT_FN void lane_shade(const Tables& T, const LaneIn& L, const Nearest& h, size_t i, int nee,
                      int vol_nee, int mw, float* __restrict__ contrib,
                      float* __restrict__ next_o, float* __restrict__ next_d,
                      float* __restrict__ thr_mult, uint8_t* __restrict__ terminate,
                      float* __restrict__ wspec, float* __restrict__ rru,
                      float* __restrict__ out_medium, float* __restrict__ replay_gid,
                      float* __restrict__ replay_nee) {
  const Bounce b = bounce<true, true, false, false, false, false, true>(
      T, L.base, L.dep, nee, L.o, L.d, L.t, L.prev, L.med, vol_nee, MeshHit{}, nullptr, &h);
  const V3* vec[4] = {&b.contrib, &b.next_o, &b.next_d, &b.thr_mult};
  float* out[4] = {contrib, next_o, next_d, thr_mult};
  for (int k = 0; k < 4; ++k) {
    out[k][3 * i] = vec[k]->x;
    out[k][3 * i + 1] = vec[k]->y;
    out[k][3 * i + 2] = vec[k]->z;
  }
  terminate[i] = b.terminate ? 1 : 0;
  wspec[i] = b.wspec;
  rru[i] = uniform(L.base, 3);
  float* mo = out_medium + (size_t)mw * i;
  mo[0] = b.medium.a.x;
  mo[1] = b.medium.a.y;
  mo[2] = b.medium.a.z;
  mo[3] = b.medium.s;
  if (mw > 4) mo[4] = 0.0f;
  replay_gid[i] = (float)b.gid;
  replay_nee[i] = b.nee_add ? 1.0f : 0.0f;
}

}  // namespace pt
