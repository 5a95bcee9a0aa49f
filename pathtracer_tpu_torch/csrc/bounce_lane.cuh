// One lane of the per-bounce kernel (csrc/bounce.cu) and of its mesh-merge
// variant (csrc/bounce_merge.cu): reads a lane's planes, runs pt::bounce in
// its mask-free form and writes every output.  Also compiled as host C++ by
// tests/kernel_host_harness.cpp.

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

}  // namespace pt
