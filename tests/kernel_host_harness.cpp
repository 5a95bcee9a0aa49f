// Host build of the kernels' per-lane code, for
// tests/test_torch_kernel_host.py.  The sources of pathtracer_tpu_torch/
// csrc/ compile without nvcc (their PT_FN functions become host inline
// functions, their kernels drop out); these C entry points run their lanes
// one after another over a wavefront, with the same arguments as the CUDA
// launchers: the trace (trace.cu), the forward with residuals and the
// reverse lanes (trace_grad.cu; vol picks their kVol instances, 4v and 5v,
// and the surface bits surf their kSurf ones, 4s and 5s) and the reverse
// kernel's lane keys, one bounce
// (bounce.cu) and its backward (bounce_grad.cu; vol: 3v, with the medium
// planes; surf: 3s; in a given lane order) and 3s's lane keys, the nearest
// hit, winner search and occlusion
// (intersect.cu), and the nearest triangle and triangle occlusion (mesh.cu,
// chunk-culled with the padded boxes, or dense without).
// host_trace_sched runs kernel 1 under a host emulation of its persistent
// schedule (trace.cu:persistent_paths): warps of 32 lanes in lockstep
// sharing one lane counter, refilled by rank.
// host_mesh_sweep and host_mesh_occ run the in-kernel triangle sweep and
// the shadow ray's sweep (trace_common.cuh) on one ray per lane.
// The trace and the bounce take the in-kernel mesh tables as the launchers
// do (n_mesh = 0 for none), the media flags (volumetric, hg, vol_nee)
// that pick their kVol / kHg instance and the surface feature bits that pick
// the kSurf one; the bounce also the medium's width and the deferred texel's
// three output planes (null for none: with them, the kTex instance, with
// meshes kernel 2mt).  host_bounce_merge runs the lanes of the mesh-merge
// variant (bounce_merge.cu) with its merge, mesh-UV and deferred planes.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libhost.so \
//       tests/kernel_host_harness.cpp

#include <math.h>

#include <vector>

// the card's rsqrtf; the host has none
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }

#include "../pathtracer_tpu_torch/csrc/trace_grad.cu"
#include "../pathtracer_tpu_torch/csrc/trace.cu"
#include "../pathtracer_tpu_torch/csrc/bounce.cu"
#include "../pathtracer_tpu_torch/csrc/bounce_grad.cu"
#include "../pathtracer_tpu_torch/csrc/intersect.cu"
#include "../pathtracer_tpu_torch/csrc/mesh.cu"

using namespace pt;

// The persistent schedule of kernel 1 (trace.cu:persistent_paths) on the
// host: `threads` threads in warps of 32, each warp's lanes in lockstep,
// every warp taking its new lanes from one counter.  The warps take their
// passes in an uneven order (warp w sits out round k where
// (k + w) % (w % 3 + 2) == 0), so the counter is taken in changing orders.
// step(p) runs one bounce of path p; returns the bounces.
template <typename Step>
static unsigned long long host_schedule(int n, int threads, const float* origin,
                                        const float* direction, const unsigned* sample,
                                        Step step) {
  const int warps = (threads + 31) / 32;
  std::vector<Path> path(32 * (size_t)warps);
  for (Path& p : path) p.alive = false;
  std::vector<char> drained(warps, 0), done(warps, 0);
  unsigned long long next = 0, bounces = 0;
  for (int round = 0, left = warps; left > 0; ++round) {
    for (int w = 0; w < warps; ++w) {
      if (done[w] || (round + w) % (w % 3 + 2) == 0) continue;
      Path* lanes = &path[32 * (size_t)w];
      uint32_t free = 0;
      if (!drained[w])
        for (int l = 0; l < 32; ++l) free |= lanes[l].alive ? 0u : 1u << l;
      if (free) {
        const unsigned long long base = next;
        next += PT_POPC(free);
        drained[w] = base + PT_POPC(free) >= (unsigned long long)n;
        for (int l = 0; l < 32; ++l) {
          const unsigned long long mine = base + refill_rank(free, l);
          if (!lanes[l].alive && mine < (unsigned long long)n)
            lanes[l] = path_start((int)mine, origin, direction, sample);
        }
      }
      bool any = false;
      for (int l = 0; l < 32; ++l) any = any || lanes[l].alive;
      if (!any) {
        done[w] = 1;
        --left;
        continue;
      }
      for (int l = 0; l < 32; ++l) {
        if (!lanes[l].alive) continue;
        step(lanes[l]);
        ++bounces;
      }
    }
  }
  return bounces;
}

extern "C" void host_fwd(const float* gtab, int G, const float* mtab, const float* ltab,
                         const float* scal, unsigned seed, const float* origin,
                         const float* direction, const unsigned* sample, int n, float* radiance,
                         unsigned long long* nrays, float* resid, int depth, int nee, int rr,
                         int rr_start, int vol, int vol_nee, int surf) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, surf};
  auto lane = vol ? (surf ? fwd_lane<true, true> : fwd_lane<true, false>)
                  : (surf ? fwd_lane<false, true> : fwd_lane<false, false>);
  unsigned long long total = 0;
  for (int i = 0; i < n; ++i) {
    V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
    V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    V3 rad = v3(0.0f, 0.0f, 0.0f);
    unsigned bounces = 0;
    lane(T, seed, sample[i], o, d, depth, nee, rr, rr_start, true, resid, (size_t)n, (size_t)i,
         rad, bounces, vol_nee);
    radiance[3 * i] = rad.x;
    radiance[3 * i + 1] = rad.y;
    radiance[3 * i + 2] = rad.z;
    total += (unsigned long long)bounces * (nee ? 2 : 1);
  }
  *nrays = total;
}

extern "C" void host_bwd(const float* gtab, int G, const float* mtab, int M, const float* ltab,
                         const float* scal, unsigned seed, const unsigned* sample, int n,
                         const float* resid, const float* g_radiance, float* d_origin,
                         float* d_direction, float* row, int depth, int nee, int rr,
                         int rr_start, int vol, int vol_nee, int surf) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, surf};
  const RowLayout R = row_layout(G, M);
  auto lane = vol ? (surf ? bwd_lane<true, true> : bwd_lane<true, false>)
                  : (surf ? bwd_lane<false, true> : bwd_lane<false, false>);
  for (int k = 0; k < R.k; ++k) row[k] = 0.0f;
  for (int i = 0; i < n; ++i) {
    V3 g_rad = v3(g_radiance[3 * i], g_radiance[3 * i + 1], g_radiance[3 * i + 2]);
    V3 g_o, g_d;
    AD sums[LANE_SUMS] = {};
    LaneSums ls{sums, 1, -1};
    lane(T, R, seed, sample[i], resid, (size_t)n, (size_t)i, depth, nee, rr, rr_start, g_rad, g_o,
         g_d, row, &ls, vol_nee);
    lane_sums_add(row, R, ls);
    d_origin[3 * i] = g_o.x;
    d_origin[3 * i + 1] = g_o.y;
    d_origin[3 * i + 2] = g_o.z;
    d_direction[3 * i] = g_d.x;
    d_direction[3 * i + 1] = g_d.y;
    d_direction[3 * i + 2] = g_d.z;
  }
}

// the reverse kernel's lane keys (lane_key; vol picks the media key)
extern "C" void host_lane_keys(const float* gtab, const float* mtab, const float* resid, int n,
                               int depth, int vol, int* keys) {
  for (int i = 0; i < n; ++i)
    keys[i] = vol ? lane_key<true>(gtab, mtab, resid, (size_t)n, (size_t)i, depth)
                  : lane_key<false>(gtab, mtab, resid, (size_t)n, (size_t)i, depth);
}

// threads = 0: the lanes one by one in index order (trace_lane); else the
// persistent schedule on that many threads
static void trace_lanes(const float* gtab, int G, const float* mtab, const float* ltab,
                        const float* scal, unsigned seed, const float* origin,
                        const float* direction, const unsigned* sample, int n, float* radiance,
                        unsigned long long* nrays, int depth, int nee, int rr, int rr_start,
                        int vol, int hg, int vol_nee, int surf, const float* mtri,
                        const float* maabb, const float* mnorm, const float* muv,
                        const int* mdesc, int n_mesh, int threads) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f,
                 MeshTables{mtri, maabb, mnorm, muv, mdesc, n_mesh}, surf};
  const LoopArgs A{seed, depth, nee, rr, rr_start, vol_nee};
  auto lane = !vol ? (surf ? trace_lane<false, false, true> : trace_lane<false, false, false>)
              : hg ? (surf ? trace_lane<true, true, true> : trace_lane<true, true, false>)
                   : (surf ? trace_lane<true, false, true> : trace_lane<true, false, false>);
  auto step = !vol ? (surf ? trace_step<false, false, true> : trace_step<false, false, false>)
              : hg ? (surf ? trace_step<true, true, true> : trace_step<true, true, false>)
                   : (surf ? trace_step<true, false, true> : trace_step<true, false, false>);
  unsigned long long total = 0;
  if (threads == 0) {
    for (int i = 0; i < n; ++i) total += lane(T, A, i, origin, direction, sample, radiance);
  } else {
    total = host_schedule(n, threads, origin, direction, sample,
                          [&](Path& p) { step(T, A, p, radiance); });
  }
  *nrays = total * (nee ? 2 : 1);
}

extern "C" void host_trace(const float* gtab, int G, const float* mtab, const float* ltab,
                           const float* scal, unsigned seed, const float* origin,
                           const float* direction, const unsigned* sample, int n,
                           float* radiance, unsigned long long* nrays, int depth, int nee,
                           int rr, int rr_start, int vol, int hg, int vol_nee, int surf,
                           const float* mtri, const float* maabb, const float* mnorm,
                           const float* muv, const int* mdesc, int n_mesh) {
  trace_lanes(gtab, G, mtab, ltab, scal, seed, origin, direction, sample, n, radiance, nrays,
              depth, nee, rr, rr_start, vol, hg, vol_nee, surf, mtri, maabb, mnorm, muv, mdesc,
              n_mesh, 0);
}

extern "C" void host_trace_sched(const float* gtab, int G, const float* mtab, const float* ltab,
                                 const float* scal, unsigned seed, const float* origin,
                                 const float* direction, const unsigned* sample, int n,
                                 float* radiance, unsigned long long* nrays, int depth, int nee,
                                 int rr, int rr_start, int vol, int hg, int vol_nee, int surf,
                                 const float* mtri, const float* maabb, const float* mnorm,
                                 const float* muv, const int* mdesc, int n_mesh, int threads) {
  trace_lanes(gtab, G, mtab, ltab, scal, seed, origin, direction, sample, n, radiance, nrays,
              depth, nee, rr, rr_start, vol, hg, vol_nee, surf, mtri, maabb, mnorm, muv, mdesc,
              n_mesh, threads);
}

extern "C" void host_bounce(const float* gtab, int G, const float* mtab, const float* ltab,
                            const float* scal, unsigned seed, int nee, int n,
                            const float* origin, const float* direction, const float* thr,
                            const unsigned* sample, const int* depth, const float* prev,
                            const float* medium, float* contrib, float* next_o, float* next_d,
                            float* thr_mult, unsigned char* terminate, float* wspec, float* rru,
                            float* out_medium, float* replay_gid, float* replay_nee, int vol,
                            int hg, int vol_nee, int mw, int surf, float* tex_u, float* tex_v,
                            float* tex_slot, const float* mtri, const float* maabb,
                            const float* mnorm, const float* muv, const int* mdesc,
                            int n_mesh) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f,
                 MeshTables{mtri, maabb, mnorm, muv, mdesc, n_mesh}, surf};
  decltype(&bounce_lane<false, false>) lane;
  if (tex_u != nullptr)
    lane = !vol ? bounce_lane<false, false, true, true>
                : (hg ? bounce_lane<true, true, true, true> : bounce_lane<true, false, true, true>);
  else if (surf)
    lane = !vol ? bounce_lane<false, false, true>
                : (hg ? bounce_lane<true, true, true> : bounce_lane<true, false, true>);
  else
    lane = !vol ? bounce_lane<false, false> : (hg ? bounce_lane<true, true>
                                                  : bounce_lane<true, false>);
  for (int i = 0; i < n; ++i)
    lane(T, seed, nee, vol_nee, mw, (size_t)i, origin, direction, thr, sample, depth, prev,
         medium, contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium,
         replay_gid, replay_nee, tex_u, tex_v, tex_slot, nullptr, nullptr, nullptr, 0);
}

extern "C" void host_bounce_merge(const float* gtab, int G, const float* mtab, const float* ltab,
                                  const float* scal, unsigned seed, int nee, int n,
                                  const float* origin, const float* direction, const float* thr,
                                  const unsigned* sample, const int* depth, const float* prev,
                                  const float* medium, float* contrib, float* next_o,
                                  float* next_d, float* thr_mult, unsigned char* terminate,
                                  float* wspec, float* rru, float* out_medium, int vol, int hg,
                                  int vol_nee, int mw, int surf, float* tex_u, float* tex_v,
                                  float* tex_slot, const float* mesh_in, const float* mesh_uv,
                                  float* deferred) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f,
                 MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0}, surf};
  decltype(&bounce_lane<false, false, false, false, true>) lane;
  if (tex_u != nullptr)
    lane = !vol ? bounce_lane<false, false, true, true, true>
                : (hg ? bounce_lane<true, true, true, true, true>
                      : bounce_lane<true, false, true, true, true>);
  else if (surf)
    lane = !vol ? bounce_lane<false, false, true, false, true>
                : (hg ? bounce_lane<true, true, true, false, true>
                      : bounce_lane<true, false, true, false, true>);
  else
    lane = !vol ? bounce_lane<false, false, false, false, true>
                : (hg ? bounce_lane<true, true, false, false, true>
                      : bounce_lane<true, false, false, false, true>);
  for (int i = 0; i < n; ++i)
    lane(T, seed, nee, vol_nee, mw, (size_t)i, origin, direction, thr, sample, depth, prev,
         medium, contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium, nullptr,
         nullptr, tex_u, tex_v, tex_slot, mesh_in, mesh_uv, deferred, (size_t)n);
}

extern "C" void host_nearest(const float* gtab, int G, int n, const float* origin,
                             const float* direction, float* t, int* gid, int* mid, float* p,
                             float* p_obj, float* normal) {
  for (int i = 0; i < n; ++i)
    nearest_lane(gtab, G, (size_t)i, origin, direction, t, gid, mid, p, p_obj, normal);
}

extern "C" void host_occlusion(const float* gtab, int G, int n, const float* origin,
                               const float* direction, float* t) {
  for (int i = 0; i < n; ++i) t[i] = occlusion_lane(gtab, G, (size_t)i, origin, direction);
}

extern "C" void host_winner(const float* gtab, int G, int n, const float* origin,
                            const float* direction, float* t, int* gid) {
  for (int i = 0; i < n; ++i) winner_lane(gtab, G, (size_t)i, origin, direction, t, gid);
}

// kernel 3's lanes in the order `order` (null: index order), as the kernel
// runs them: in the vacuum and surface instances each lane's winner rows
// summed in its row sums (RowSums) and added to the row after the lane
extern "C" void host_bounce_bwd(const float* gtab, int G, const float* mtab, int M,
                                const float* ltab, const float* scal, unsigned seed, int nee,
                                int n, const float* origin, const float* direction,
                                const float* thr, const unsigned* sample, const int* depth,
                                const float* prev, const float* replay_gid,
                                const float* replay_nee, const float* g_contrib,
                                const float* g_next_o, const float* g_next_d,
                                const float* g_thr_mult, float* d_origin, float* d_direction,
                                float* d_thr, float* row, int vol, int vol_nee, int surf,
                                const float* medium, const float* g_medium, float* d_medium,
                                const int* order) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, surf};
  const RowLayout R = row_layout(G, M);
  auto vol_lane = surf ? bounce_bwd_lane<true, true> : bounce_bwd_lane<true, false>;
  auto lane =
      surf ? bounce_bwd_lane<false, true, RowSums> : bounce_bwd_lane<false, false, RowSums>;
  for (int k = 0; k < R.k; ++k) row[k] = 0.0f;
  for (int t = 0; t < n; ++t) {
    const int i = order != nullptr ? order[t] : t;
    AD rows[ROW_SUMS] = {};
    RowSums rs{row, rows, 1, ROW_NONE, ROW_NONE};
    if (vol)
      vol_lane(T, R, seed, nee, (size_t)i, origin, direction, thr, sample, depth, prev,
               replay_gid, replay_nee, g_contrib, g_next_o, g_next_d, g_thr_mult, d_origin,
               d_direction, d_thr, row, vol_nee, medium, g_medium, d_medium);
    else
      lane(T, R, seed, nee, (size_t)i, origin, direction, thr, sample, depth, prev, replay_gid,
           replay_nee, g_contrib, g_next_o, g_next_d, g_thr_mult, d_origin, d_direction, d_thr,
           rs, vol_nee, medium, g_medium, d_medium);
    row_sums_add(rs);
  }
}

// kernel 3s's lane keys (bounce_grad.cu:bounce_bwd_key)
extern "C" void host_bounce_bwd_keys(const float* gtab, const float* mtab, int n,
                                     const float* replay_gid, const float* replay_nee,
                                     const float* g_contrib, const float* g_next_o,
                                     const float* g_next_d, const float* g_thr_mult, int* keys) {
  const BwdKeyIn in{gtab,      mtab,     replay_gid, replay_nee,
                    g_contrib, g_next_o, g_next_d,   g_thr_mult};
  for (int i = 0; i < n; ++i) keys[i] = bounce_bwd_key(in, (size_t)i);
}

// boxes: the padded chunk boxes, or null for the dense sweep
extern "C" void host_mesh_nearest(const float* tab, int n_tris, const float* boxes, int n,
                                  const float* o_obj, const float* d_obj, float* t, int* idx) {
  for (int i = 0; i < n; ++i)
    mesh_scan_lane<true>(tab, n_tris, boxes, v3(o_obj[3 * i], o_obj[3 * i + 1], o_obj[3 * i + 2]),
                         v3(d_obj[3 * i], d_obj[3 * i + 1], d_obj[3 * i + 2]), t[i], idx[i]);
}

extern "C" void host_mesh_min(const float* tab, int n_tris, const float* boxes, int n,
                              const float* o_obj, const float* d_obj, float* t) {
  for (int i = 0; i < n; ++i) {
    int32_t unused;
    mesh_scan_lane<false>(tab, n_tris, boxes, v3(o_obj[3 * i], o_obj[3 * i + 1], o_obj[3 * i + 2]),
                          v3(d_obj[3 * i], d_obj[3 * i + 1], d_obj[3 * i + 2]), t[i], unused);
  }
}

// pt::mesh_sweep (kUV with uv != 0) per lane: t, the object-space hit point,
// the unit normal, the material and (u, v, 1 where the winner's mesh has UVs)
extern "C" void host_mesh_sweep(const float* gtab, const float* mtri, const float* maabb,
                                const float* mnorm, const float* muv, const int* mdesc,
                                int n_mesh, int uv, int n, const float* origin,
                                const float* direction, float* t, float* p_obj, float* normal,
                                int* mid, float* uvs) {
  const MeshTables M{mtri, maabb, mnorm, muv, mdesc, n_mesh};
  for (int i = 0; i < n; ++i) {
    const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
    const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    const MeshHit h = uv ? mesh_sweep<true>(gtab, M, o, d) : mesh_sweep<false>(gtab, M, o, d);
    t[i] = h.t;
    const V3* vec[2] = {&h.p_obj, &h.normal};
    float* out[2] = {p_obj, normal};
    for (int k = 0; k < 2; ++k) {
      out[k][3 * i] = vec[k]->x;
      out[k][3 * i + 1] = vec[k]->y;
      out[k][3 * i + 2] = vec[k]->z;
    }
    mid[i] = h.mid;
    uvs[3 * i] = h.uv_u;
    uvs[3 * i + 1] = h.uv_v;
    uvs[3 * i + 2] = h.uv_valid ? 1.0f : 0.0f;
  }
}

// pt::mesh_occ per lane: the shadow ray's nearest triangle t, or the first t
// below the lane's limit
extern "C" void host_mesh_occ(const float* gtab, const float* mtri, const float* maabb,
                              const float* mnorm, const float* muv, const int* mdesc, int n_mesh,
                              int n, const float* x, const float* wi, const float* limit,
                              float* occ) {
  const MeshTables M{mtri, maabb, mnorm, muv, mdesc, n_mesh};
  for (int i = 0; i < n; ++i)
    occ[i] = mesh_occ(gtab, M, v3(x[3 * i], x[3 * i + 1], x[3 * i + 2]),
                      v3(wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]), limit[i]);
}
