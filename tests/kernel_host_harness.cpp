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
// sharing one lane counter, refilled by rank.  host_fwd_packed runs kernel
// 4 block by block with its live paths packed (trace_grad.cu:
// trace_fwd_kernel_packed), host_bounce_blocks kernel 2's mesh instances
// with each block's triangle sweep shared (bounce.cu:block_mesh_sweep),
// host_bounce_grouped its grouped kernel (2r-v) with each block's lanes
// ordered by the event their nearest hit gives, and host_event_keys that
// event's key per lane.
// host_mesh_sweep and host_mesh_occ run the in-kernel triangle sweep and
// the shadow ray's sweep (trace_common.cuh) on one ray per lane.
// host_camera runs the camera kernel's lanes (camera.cu): the primary ray
// of each pixel and global sample.
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

#include <algorithm>
#include <vector>

// the card's rsqrtf; the host has none
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }

#include "../pathtracer_tpu_torch/csrc/trace_grad.cu"
#include "../pathtracer_tpu_torch/csrc/trace.cu"
#include "../pathtracer_tpu_torch/csrc/bounce.cu"
#include "../pathtracer_tpu_torch/csrc/bounce_grad.cu"
#include "../pathtracer_tpu_torch/csrc/intersect.cu"
#include "../pathtracer_tpu_torch/csrc/mesh.cu"
#include "../pathtracer_tpu_torch/csrc/camera.cu"

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

// Kernel 4 (trace_grad.cu:trace_fwd_kernel_packed) block by block as the card
// runs it: `threads` paths per block in the path planes; at each bounce
// every path's record, the live paths listed in path order, the listed
// paths' bounces (here from the last listed to the first), every path's
// outcome; a block whose paths have all ended writes its remaining records
// at once.
template <bool kVol, bool kSurf>
static void fwd_blocks(const Tables& T, unsigned seed, const float* origin,
                       const float* direction, const unsigned* sample, int n, float* radiance,
                       unsigned long long* nrays, float* resid, int depth, int nee, int rr,
                       int rr_start, int vol_nee, int threads) {
  std::vector<float> f(P_FLOATS<kVol> * (size_t)threads);
  std::vector<int> ints(P_INTS * (size_t)threads);
  const PathPlanes P{f.data(), ints.data(), threads};
  unsigned long long total = 0;
  for (int b0 = 0; b0 < n; b0 += threads) {
    auto valid = [&](int p) { return b0 + p < n; };
    for (int p = 0; p < threads; ++p) {
      const int i = valid(p) ? b0 + p : 0;
      path_init<kVol>(P, p, valid(p), v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]),
                      v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]),
                      valid(p) ? sample[i] : 0u);
    }
    unsigned int bounces = 0;
    for (int dep = 0; dep < depth; ++dep) {
      int live = 0;
      for (int p = 0; p < threads; ++p) {
        path_record<kVol>(P, p, valid(p), resid, (size_t)n, (size_t)(b0 + p), dep);
        if (P.in(P_ALIVE, p)) P.in(P_LIST, live++) = p;
      }
      if (live == 0) {
        for (int rest = dep; rest < depth; ++rest)
          for (int p = 0; p < threads; ++p) {
            if (rest > dep)
              path_record<kVol>(P, p, valid(p), resid, (size_t)n, (size_t)(b0 + p), rest);
            path_outcome<kVol>(P, p, valid(p), resid, (size_t)n, (size_t)(b0 + p), rest);
          }
        break;
      }
      for (int t = live - 1; t >= 0; --t)
        path_step<kVol, kSurf>(T, P, P.in(P_LIST, t), seed, dep, nee, rr, rr_start, vol_nee,
                               bounces);
      for (int p = 0; p < threads; ++p)
        path_outcome<kVol>(P, p, valid(p), resid, (size_t)n, (size_t)(b0 + p), dep);
    }
    for (int p = 0; p < threads && valid(p); ++p)
      for (int k = 0; k < 3; ++k) radiance[3 * (b0 + p) + k] = P.at(P_RAD + k, p);
    total += bounces;
  }
  *nrays = total * (nee ? 2 : 1);
}

extern "C" void host_fwd_packed(const float* gtab, int G, const float* mtab, const float* ltab,
                                const float* scal, unsigned seed, const float* origin,
                                const float* direction, const unsigned* sample, int n,
                                float* radiance, unsigned long long* nrays, float* resid,
                                int depth, int nee, int rr, int rr_start, int vol, int vol_nee,
                                int surf, int threads) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, surf};
  auto run = vol ? (surf ? fwd_blocks<true, true> : fwd_blocks<true, false>)
                 : (surf ? fwd_blocks<false, true> : fwd_blocks<false, false>);
  run(T, seed, origin, direction, sample, n, radiance, nrays, resid, depth, nee, rr, rr_start,
      vol_nee, threads);
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
         replay_gid, replay_nee, tex_u, tex_v, tex_slot, nullptr, nullptr, nullptr, 0, nullptr);
}

// Kernel 2's block sweep (bounce.cu:block_mesh_sweep) over the rays of one
// block's lanes: each lane walks the chunks of every mesh in order against
// its own best; a chunk that no lane reaches is skipped; for one that some
// reach, every lane's test comes first, then each reaching lane (from the
// last listed to the first) takes the chunk's first minimum over its 32
// triangles, as the card's warps compute it (the minimum, then the lowest
// row that gives it).
template <bool kUV>
static void host_block_sweep(const float* g_tab, const MeshTables& M, const V3* o, const V3* d,
                             int lanes, MeshHit* out) {
  std::vector<SweepBest> s(lanes);
  std::vector<V3> oo(lanes), od(lanes), inv(lanes);
  std::vector<char> reach(lanes);
  for (int k = 0; k < M.n; ++k) {
    const int* ds = M.desc + MESH_DESC * k;
    for (int l = 0; l < lanes; ++l) {
      to_object(g_tab + ds[0] * GCOLS, o[l], d[l], oo[l], od[l]);
      inv[l] = v3(safe_recip(od[l].x), safe_recip(od[l].y), safe_recip(od[l].z));
    }
    for (int c = ds[2]; c < ds[2] + ds[1]; ++c) {
      bool any = false;
      for (int l = 0; l < lanes; ++l) {
        reach[l] = chunk_reaches(M.aabb + 6 * c, oo[l], inv[l], s[l].best);
        any = any || reach[l];
      }
      if (!any) continue;
      for (int l = lanes - 1; l >= 0; --l) {
        if (!reach[l]) continue;
        float t[MESH_CHUNK], u[MESH_CHUNK], v[MESH_CHUNK], m = BIG;
        for (int j = 0; j < MESH_CHUNK; ++j) {
          t[j] = mt_tri(M.tri + 12 * (c * MESH_CHUNK + j), oo[l], od[l], u[j], v[j]);
          m = fminf(m, t[j]);
        }
        int j = 0;
        while (t[j] != m) ++j;
        sweep_take<kUV>(s[l], k, ds, c * MESH_CHUNK + j, m, u[j], v[j]);
      }
    }
  }
  for (int l = 0; l < lanes; ++l)
    out[l] = mesh_hit<kUV>(g_tab, M, o[l], d[l], s[l]);
}

// kernel 2's mesh instances as the card runs them: blocks of `threads`
// lanes, each block's nearest-triangle sweep first (host_block_sweep), then
// every lane's bounce with its winner.  A non-null `order` deals the lanes
// to the blocks in that order (block b takes lanes order[b * threads ...]):
// a lane's winner must not depend on which lanes share its block.
extern "C" void host_bounce_blocks(const float* gtab, int G, const float* mtab,
                                   const float* ltab, const float* scal, unsigned seed, int nee,
                                   int n, const float* origin, const float* direction,
                                   const float* thr, const unsigned* sample, const int* depth,
                                   const float* prev, const float* medium, float* contrib,
                                   float* next_o, float* next_d, float* thr_mult,
                                   unsigned char* terminate, float* wspec, float* rru,
                                   float* out_medium, int surf, float* tex_u, float* tex_v,
                                   float* tex_slot, const float* mtri, const float* maabb,
                                   const float* mnorm, const float* muv, const int* mdesc,
                                   int n_mesh, const int* order, int threads) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f,
                 MeshTables{mtri, maabb, mnorm, muv, mdesc, n_mesh}, surf};
  const bool tex = tex_u != nullptr;
  auto lane = tex ? bounce_lane<false, false, true, true>
                  : (surf ? bounce_lane<false, false, true> : bounce_lane<false, false>);
  std::vector<V3> o(threads), d(threads);
  std::vector<MeshHit> hits(threads);
  for (int b0 = 0; b0 < n; b0 += threads) {
    const int lanes = n - b0 < threads ? n - b0 : threads;
    for (int p = 0; p < lanes; ++p) {
      const int i = order != nullptr ? order[b0 + p] : b0 + p;
      o[p] = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
      d[p] = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    }
    if (tex)
      host_block_sweep<true>(gtab, T.mesh, o.data(), d.data(), lanes, hits.data());
    else
      host_block_sweep<false>(gtab, T.mesh, o.data(), d.data(), lanes, hits.data());
    for (int p = 0; p < lanes; ++p)
      lane(T, seed, nee, 1, 4, (size_t)(order != nullptr ? order[b0 + p] : b0 + p), origin,
           direction, thr, sample, depth, prev, medium, contrib, next_o, next_d, thr_mult,
           terminate, wspec, rru, out_medium, nullptr, nullptr, tex_u, tex_v, tex_slot, nullptr,
           nullptr, nullptr, 0, &hits[p]);
  }
}

// kernel 2's grouped kernel (bounce.cu:bounce_kernel_grouped, 2r-v: kVol
// with the replay planes, no hg, no surface features) as the card runs it:
// blocks of `threads` lanes; each lane's sweep and event key (lane_sweep)
// and its state put in the lane planes at its rank, the block's lanes
// ordered by key with ties in block order (as block_rank's counting sort),
// then each slot read out (slot_get) and shaded (lane_shade, here from the
// last slot to the first) with its outputs at the lane's own index.  A
// non-null `order` deals the lanes to the blocks in that order, as
// host_bounce_blocks does.
extern "C" void host_bounce_grouped(const float* gtab, int G, const float* mtab,
                                    const float* ltab, const float* scal, unsigned seed, int nee,
                                    int n, const float* origin, const float* direction,
                                    const float* thr, const unsigned* sample, const int* depth,
                                    const float* prev, const float* medium, float* contrib,
                                    float* next_o, float* next_d, float* thr_mult,
                                    unsigned char* terminate, float* wspec, float* rru,
                                    float* out_medium, float* replay_gid, float* replay_nee,
                                    int vol_nee, int mw, const int* order, int threads) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, 0};
  std::vector<float> f(LP_FLOATS * (size_t)threads);
  std::vector<int> ints(LP_INTS * (size_t)threads), key(threads), count(EVENT_KEYS + 1);
  const LanePlanes P{f.data(), ints.data(), threads};
  std::vector<LaneIn> L(threads);
  std::vector<Nearest> h(threads);
  for (int b0 = 0; b0 < n; b0 += threads) {
    const int lanes = n - b0 < threads ? n - b0 : threads;
    auto index = [&](int p) { return (size_t)(order != nullptr ? order[b0 + p] : b0 + p); };
    std::fill(count.begin(), count.end(), 0);
    for (int p = 0; p < lanes; ++p) {
      key[p] = lane_sweep(T, seed, mw, index(p), origin, direction, thr, sample, depth, prev,
                          medium, L[p], h[p]);
      ++count[key[p]];
    }
    for (int k = 0, run = 0; k <= EVENT_KEYS; ++k) {
      const int c = count[k];
      count[k] = run;
      run += c;
    }
    std::vector<size_t> lane(lanes);
    for (int p = 0; p < lanes; ++p) planes_put(P, count[key[p]]++, index(p), L[p], h[p]);
    for (int s = 0; s < lanes; ++s) lane[s] = slot_get(P, s, L[s], h[s]);
    for (int s = lanes - 1; s >= 0; --s)
      lane_shade(T, L[s], h[s], lane[s], nee, vol_nee, mw, contrib, next_o, next_d, thr_mult,
                 terminate, wspec, rru, out_medium, replay_gid, replay_nee);
  }
}

// each lane's event key (trace_common.cuh:event_key) after its nearest hit
extern "C" void host_event_keys(const float* gtab, int G, const float* mtab, const float* ltab,
                                const float* scal, unsigned seed, int n, const float* origin,
                                const float* direction, const unsigned* sample, const int* depth,
                                const float* medium, int mw, int* keys) {
  const Tables T{gtab, mtab, ltab, G, scal[0], scal[1] > 0.5f, MeshTables{}, 0};
  for (int i = 0; i < n; ++i) {
    const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
    const V3 d = v3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    const uint32_t base = bounce_base(seed, sample[i] * 0x85EBCA6Bu, depth[i]);
    const float* mi = medium + (size_t)mw * i;
    keys[i] = event_key(T, base, Medium{v3(mi[0], mi[1], mi[2]), mi[3], 0.0f},
                        nearest_hit(T, o, d));
  }
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
         nullptr, tex_u, tex_v, tex_slot, mesh_in, mesh_uv, deferred, (size_t)n, nullptr);
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

extern "C" void host_camera(const float* frame, unsigned seed, const long long* pixel,
                            const long long* sample, int n, long long w, long long h, int jitter,
                            float* origin, float* direction) {
  for (int i = 0; i < n; ++i) {
    V3 o, d;
    camera_lane(frame, seed, pixel[i], sample[i], w, h, jitter, o, d);
    origin[3 * i] = o.x;
    origin[3 * i + 1] = o.y;
    origin[3 * i + 2] = o.z;
    direction[3 * i] = d.x;
    direction[3 * i + 1] = d.y;
    direction[3 * i + 2] = d.z;
  }
}
