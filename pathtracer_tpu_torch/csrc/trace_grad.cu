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
// (planes o(3) d(3) thr(3) prev_state alive gid nee_add).  Which thread
// runs a path's bounce does not change it: the uniforms are keyed by the
// path's sample and depth, so the packed instances store the same bits.  A lane that has
// died stores the carries it died with, alive 0, gid -1 and NEE bit 0.
// The kVol instance (kernel 4v, participating media) runs
// pt::bounce_step<kVol>, carries the medium and stores JAX's 17 planes,
// resid[depth][17][n]: o(3) d(3) thr(3) sigma_a(3) sigma_s prev_state alive
// gid nee_add (trace_grad.py:74-76); a dead lane's medium is the one it
// died in.
//
// trace_bwd_kernel: one thread per lane walks the bounces from depth-1 down
// to 0.  A dead bounce is the identity on the carry cotangents and adds
// nothing to the tables, so it is skipped.  For a live bounce it reloads
// the residuals, recomputes the bounce with the winner replayed (no sweep,
// no shadow ray: both are comparisons and carry no cotangent) and runs the
// hand-written adjoint of step_update (the russian-roulette multiply with p
// detached) around bounce_adj.cuh's physics_adj, the adjoint of
// bounce_physics(replay) that kernel 3 (csrc/bounce_grad.cu) runs too: the
// winner's sphere quadratic or cube slab, hit and object point, the sphere
// and cube normals, the inverse-transpose normal and its rsqrt normalize,
// the emission under the emit-state code, the sampled directions (Lambert
// through the tangent frame, mirror, Phong glossy, Fresnel dielectric) and
// the NEE connection (light position, light normal, emission, total area).
// The kVol instance (kernel 5v) reads the 17 planes and runs the medium's
// adjoint too (bounce_adj.cuh's physics_adj_vol): the free path and the
// in-medium scatter, the Beer-Lambert attenuation over the segment (on a
// light hit too: its emission is attenuated), the medium switch of a
// transmission and the volumetric NEE, whose split sweep it runs again in
// float as the forward did (only the surface NEE bit is replayed); the
// cotangents of sigma_a and sigma_s flow back through the medium carry
// (next medium = out medium where the lane lives on, the old one where it
// died) to the material table's absorption, has_scatter and
// scatter_coeff columns.  vol_nee reaches both kernels.
// The kSurf instances (kernels 4s and 5s, the optional surface physics)
// run pt::bounce_step<..., kSurf> forward, with the surface feature bits
// `surf` as trace.cu takes them, and physics_adj<kSurf> in reverse: the
// textured albedo's cotangent to the columns the lane's checker or stripes
// cell picked, the bump's to the object-space hit point and the bump
// columns, the Cook-Torrance and Ward lobes' to the shading normal, the
// incoming direction, the specular colour and the roughness.  JAX adds no
// residual planes for the surface blocks: 13 planes stay (17 with kVol,
// whose instance with kSurf is the same template).
// The table cotangents: each block zeroes its own row of `partial`, in
// device memory, and its lanes add to it with float atomics, which L2
// resolves as reductions (their order within the block is not fixed: the
// row varies in its last bits from run to run).  In the vacuum instance
// (kernel 5) the columns that every NEE bounce adds to (its first light's
// position, emission and normal columns and the total-area scalar: 25 of
// the up to 59 atomics of a live bounce, the same 25 on every lane of a
// one-light scene) are summed per lane in double in shared memory across
// its bounces (bounce_adj.cuh's LaneSums) and reach the row once per warp,
// a shuffle sum in a fixed order, after the loop.  A lane whose radiance
// cotangent is zero writes zeros and skips the loop.  bounce_adj.cuh's
// row_sum then adds the per-block rows (5,000 at 640,000 lanes) in a fixed
// tree spread over 32-column tiles and 64-row segments, two short launches.
//
// The media and surface instances (5v, 5s) first order their lanes: a lane
// takes a key of one bit per bounce, set where it takes the instance's
// costly branch (lane_key: in a scattering medium, where the free path's
// and the volumetric NEE's adjoints run; on a Cook-Torrance or Ward
// material), two short kernels group the lanes by key (bounce_adj.cuh:
// lane_order, which kernel 3s shares), and thread t of the reverse kernel
// takes lane order[t].  A warp otherwise runs the union of its lanes'
// branches: one lane that scatters in the medium makes the whole warp wait
// for its volumetric NEE adjoint.
//
// What bounds them on the H100: the forward moves 40 B per lane plus 52 B
// per lane and bounce of residuals (266 MB per 640,000-lane iteration at
// depth 8, ~0.08 ms at 3.35 TB/s; 68 B with the medium planes) against the
// trace kernel's two sweeps per bounce.  Every thread stores its own path's
// record at each bounce, so a warp's 32 lanes store each plane together,
// four full 32-byte sectors.  With one path per thread a warp ran until its
// longest path ended: on Cornell's primary rays 68% of the thread-bounces
// of the warps that ran held a live path.  So 4 and 4v keep a block's paths
// in shared memory and, at each bounce, pack the live ones into the
// block's first warps, which run their bounces (the path planes above; 94% of
// the thread-bounces live on blocks of 256): 4 from 0.60 to 0.545 ms, 4v
// from 0.98 to 0.89.  The barriers leave the rest: a block's warps wait for
// its slowest packed warp at every bounce.  4s keeps one path per thread:
// its paths are short (2.7 bounces of 8 on ward) and packing measured 10%
// slower (PERF.md, section 6).  The trace kernel's persistent schedule
// (trace.cu) measured slower still: its refills take one to three lanes at
// a time, the lanes of a warp sit at different bounces, and a path's dead
// bounces become single-lane stores (0.96 ms against 0.60 on Cornell).
// The reverse reads the alive plane
// of every bounce and the other 12 (16) planes of a live one, and replays
// one intersection per live bounce; its operations, the float recompute
// and an adjoint in double several times the forward's shading (5v also
// re-runs the volumetric NEE's split sweep at a scatter), bound it on
// paper about as much as its bytes.  On the card it ran far above both:
// its table atomics into a shared-memory row took 64% of kernel 5's time,
// and divergence between a warp's lanes about half of 5v's and 5s's once
// the row had moved to device memory (PERF.md, section 6).  The
// bounce loop stays rolled and the state in registers; ptxas reports
// registers and spills in chip_smoke.py's build phase.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "bounce_adj.cuh"

namespace pt {

// residual planes per bounce: o(3) d(3) thr(3) [sigma_a(3) sigma_s] prev_state
// alive gid nee_add
constexpr int R_O = 0, R_D = 3, R_THR = 6, R_SA = 9, R_SS = 12;
template <bool kVol>
constexpr int N_RESID = kVol ? 17 : 13;
template <bool kVol>
constexpr int R_STATE = N_RESID<kVol> - 4;  // the emit-state plane; alive, gid, nee_add follow

// ---- forward with residuals -----------------------------------------------

// one path of one thread, all its bounces: kernel 4s, and the index-order
// reference of tests/kernel_host_harness.cpp for the packed instances
template <bool kVol = false, bool kSurf = false>
PT_FN void fwd_lane(const Tables& T, uint32_t seed, uint32_t s, V3 o, V3 d, int max_depth,
                    int nee, int rr, int rr_start, bool valid, float* resid, size_t n,
                    size_t idx, V3& rad, unsigned int& bounces, int vol_nee = 1) {
  constexpr int NR = N_RESID<kVol>, RS = R_STATE<kVol>;
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  float prev_state = 0.0f;
  Medium med{};
  bool alive = valid;
  const uint32_t s_term = s * 0x85EBCA6Bu;
  for (int dep = 0; dep < max_depth; ++dep) {
    int gid = -1;
    bool nee_add = false;
    float* r = resid + (size_t)dep * NR * n + idx;
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
      if constexpr (kVol) {
        r[(R_SA + 0) * n] = med.a.x;
        r[(R_SA + 1) * n] = med.a.y;
        r[(R_SA + 2) * n] = med.a.z;
        r[R_SS * n] = med.s;
      }
      r[RS * n] = prev_state;
      r[(RS + 1) * n] = alive ? 1.0f : 0.0f;
    }
    if (alive) {
      ++bounces;
      if constexpr (kVol)
        bounce_step<true, false, kSurf>(T, bounce_base(seed, s_term, dep), dep, nee, rr,
                                        rr_start, o, d, thr, prev_state, rad, alive, gid,
                                        nee_add, &med, vol_nee);
      else
        bounce_step<false, false, kSurf>(T, bounce_base(seed, s_term, dep), dep, nee, rr,
                                         rr_start, o, d, thr, prev_state, rad, alive, gid,
                                         nee_add);
    }
    if (valid) {
      r[(RS + 2) * n] = (float)gid;
      r[(RS + 3) * n] = nee_add ? 1.0f : 0.0f;
    }
  }
}

// ---- the forward kernel's block of packed paths ---------------------------
//
// trace_fwd_kernel_packed keeps its block's paths (one per thread, the same
// index range as one path per thread) in shared memory, one plane per carry.  At
// each bounce every thread stores its own path's record (path_record, at
// the path's own index: the stores stay coalesced), the live paths are
// listed in path order, the first `live` threads each run one listed
// path's bounce (path_step) and every thread then stores its path's
// outcome (path_outcome).  A warp so runs bounces only while it has listed
// paths, not until the longest of its own 32 ends.  The host harness
// (tests/kernel_host_harness.cpp) runs these same functions block by block.

// the carry planes of a block's paths: origin, direction, throughput, emit
// state, radiance and with kVol the medium (sigma_a rgb, sigma_s); then
// int planes: the sample index, alive, the bounce's winner and NEE bit, and
// the list of live paths
constexpr int P_O = 0, P_D = 3, P_THR = 6, P_STATE = 9, P_RAD = 10, P_SA = 13, P_SS = 16;
template <bool kVol>
constexpr int P_FLOATS = kVol ? 17 : 13;
constexpr int P_SAMPLE = 0, P_ALIVE = 1, P_GID = 2, P_NEE = 3, P_LIST = 4, P_INTS = 5;

// a block's path planes: carry k of path p at f[k * threads + p], int
// plane k at i[k * threads + p]
struct PathPlanes {
  float* f;
  int* i;
  int threads;
  PT_FN float& at(int k, int p) const { return f[k * threads + p]; }
  PT_FN int& in(int k, int p) const { return i[k * threads + p]; }
};

// the shared-memory floats of a block's path planes
template <bool kVol>
PT_HD size_t path_floats(int threads) {
  return (size_t)(P_FLOATS<kVol> + P_INTS) * threads;
}

// path p of a block starts a ray (valid: below n), with unit throughput,
// emit state 0 and the vacuum medium
template <bool kVol>
PT_FN void path_init(const PathPlanes& P, int p, bool valid, V3 o, V3 d, uint32_t s) {
  const float v[P_RAD + 3] = {o.x, o.y, o.z, d.x, d.y, d.z, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f,
                              0.0f};
  for (int k = 0; k < P_RAD + 3; ++k) P.at(k, p) = v[k];
  if constexpr (kVol)
    for (int k = P_SA; k <= P_SS; ++k) P.at(k, p) = 0.0f;
  P.in(P_SAMPLE, p) = (int)s;
  P.in(P_ALIVE, p) = valid ? 1 : 0;
}

// bounce dep's record of path p at lane idx: the carries entering it and
// alive (a dead path's are those it died with); its winner and NEE bit are
// reset for path_step
template <bool kVol>
PT_FN void path_record(const PathPlanes& P, int p, bool valid, float* resid, size_t n,
                       size_t idx, int dep) {
  constexpr int NR = N_RESID<kVol>, RS = R_STATE<kVol>;
  P.in(P_GID, p) = -1;
  P.in(P_NEE, p) = 0;
  if (!valid) return;
  float* r = resid + (size_t)dep * NR * n + idx;
  for (int k = 0; k < 9; ++k) r[(size_t)k * n] = P.at(P_O + k, p);  // o, d, thr
  if constexpr (kVol)
    for (int k = 0; k < 4; ++k) r[(size_t)(R_SA + k) * n] = P.at(P_SA + k, p);
  r[(size_t)RS * n] = P.at(P_STATE, p);
  r[(size_t)(RS + 1) * n] = (float)P.in(P_ALIVE, p);
}

// bounce dep's outcome of path p at lane idx: the winner (-1 on a miss or
// a dead path) and the NEE bit
template <bool kVol>
PT_FN void path_outcome(const PathPlanes& P, int p, bool valid, float* resid, size_t n,
                        size_t idx, int dep) {
  constexpr int NR = N_RESID<kVol>, RS = R_STATE<kVol>;
  if (!valid) return;
  float* r = resid + (size_t)dep * NR * n + idx;
  r[(size_t)(RS + 2) * n] = (float)P.in(P_GID, p);
  r[(size_t)(RS + 3) * n] = (float)P.in(P_NEE, p);
}

// bounce dep of the live path p, whoever runs it: fwd_lane's bounce on the
// path's carries, written back to its planes; one more bounce counted
template <bool kVol, bool kSurf>
PT_FN void path_step(const Tables& T, const PathPlanes& P, int p, uint32_t seed, int dep, int nee,
                     int rr, int rr_start, int vol_nee, unsigned int& bounces) {
  V3 o = v3(P.at(P_O, p), P.at(P_O + 1, p), P.at(P_O + 2, p));
  V3 d = v3(P.at(P_D, p), P.at(P_D + 1, p), P.at(P_D + 2, p));
  V3 thr = v3(P.at(P_THR, p), P.at(P_THR + 1, p), P.at(P_THR + 2, p));
  V3 rad = v3(P.at(P_RAD, p), P.at(P_RAD + 1, p), P.at(P_RAD + 2, p));
  float prev_state = P.at(P_STATE, p);
  Medium med{};
  if constexpr (kVol)
    med = Medium{v3(P.at(P_SA, p), P.at(P_SA + 1, p), P.at(P_SA + 2, p)), P.at(P_SS, p), 0.0f};
  bool alive = true;
  int gid = -1;
  bool nee_add = false;
  const uint32_t base = bounce_base(seed, (uint32_t)P.in(P_SAMPLE, p) * 0x85EBCA6Bu, dep);
  ++bounces;
  if constexpr (kVol)
    bounce_step<true, false, kSurf>(T, base, dep, nee, rr, rr_start, o, d, thr, prev_state, rad,
                                    alive, gid, nee_add, &med, vol_nee);
  else
    bounce_step<false, false, kSurf>(T, base, dep, nee, rr, rr_start, o, d, thr, prev_state, rad,
                                     alive, gid, nee_add);
  const float v[P_RAD + 3] = {o.x,   o.y,   o.z,        d.x,   d.y,   d.z,  thr.x,
                              thr.y, thr.z, prev_state, rad.x, rad.y, rad.z};
  for (int k = 0; k < P_RAD + 3; ++k) P.at(k, p) = v[k];
  if constexpr (kVol) {
    P.at(P_SA, p) = med.a.x;
    P.at(P_SA + 1, p) = med.a.y;
    P.at(P_SA + 2, p) = med.a.z;
    P.at(P_SS, p) = med.s;
  }
  P.in(P_ALIVE, p) = alive ? 1 : 0;
  P.in(P_GID, p) = gid;
  P.in(P_NEE, p) = nee_add ? 1 : 0;
}

// ---- reverse ---------------------------------------------------------------

// The instances that sum NEE's light and scalar columns per lane
// (bounce_adj.cuh's LaneSums): the vacuum one, kernel 5.  On 5v and 5s the
// sums measured slower than the row's atomics alone (PERF.md, section 6).
template <bool kVol, bool kSurf>
constexpr bool LANE_SUMS_ON = !kVol && !kSurf;

// One live bounce in reverse: the cotangents of the bounce's outputs
// (g_rad of the radiance increment; g_o, g_d, g_thr of the next carries)
// become those of its inputs (g_o, g_d, g_thr, in place) and of the tables
// (added to acc).  This is the adjoint of step_update with p detached; the
// bounce itself is bounce_adj.cuh's physics_adj.  A miss or a light hit
// ends the path, so the carries pass through and only a counted emission
// adds to the cotangents.  kSurf: the surface blocks (physics_adj<kSurf>).
template <bool kSurf = false>
PT_FN void bounce_adj(const Tables& T, const RowLayout& R, uint32_t base, int dep, int nee,
                      int rr, int rr_start, V3 o, V3 d, V3 thr, float prev_state, int gid,
                      bool nee_add, D3 g_rad, D3& g_o, D3& g_d, D3& g_thr, float* acc,
                      LaneSums* ls) {
  if (gid < 0) return;  // miss: the path ends, the carries pass through
  const Replay r = replay_bounce(T, o, d, gid);
  const SurfReplay s = surf_replay<kSurf>(T, r);
  if (r.mat[9] > 0.0f) {
    // light hit: the path ends, the carries pass through; the emission
    // e * (thr * color) counts under the emit-state code
    if (emission_counts(nee, dep, prev_state)) {
      const int macc = R.om + r.mid * MCOLS;
      emission_adj(r.mat, macc, s.col, macc + s.ccol, thr, g_rad, g_thr, acc);
    }
    return;
  }
  const Scatter sc = sample_bsdf_c<kSurf>(r.mat, albedo(s), r.p, s.normal, d, uniform(base, 0),
                                          uniform(base, 1), uniform(base, 2), T.surf);

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

  // ---- the bounce
  physics_adj<kSurf, LANE_SUMS_ON<false, kSurf>>(T, R, r, base, dep, nee, o, d, thr, prev_state,
                                                 nee_add, g_rad, g_org, g_dir, g_mult, g_o_in,
                                                 g_d_in, g_thr_in, acc, ls);
  g_o = g_o_in;
  g_d = g_d_in;
  g_thr = g_thr_in;
}

// One live bounce in reverse with the volumetric feature (kernel 5v): as
// bounce_adj, and the medium's cotangents g_sa, g_ss chained like the other
// carries'.  A miss adds nothing; a light hit reached without an in-medium
// scatter ends the path with its emission, attenuated over the winner's t.
template <bool kSurf = false>
PT_FN void bounce_adj_vol(const Tables& T, const RowLayout& R, uint32_t base, int dep, int nee,
                          int vol_nee, int rr, int rr_start, V3 o, V3 d, V3 thr, Medium med,
                          float prev_state, int gid, bool nee_add, D3 g_rad, D3& g_o, D3& g_d,
                          D3& g_thr, D3& g_sa, AD& g_ss, float* acc) {
  if (gid < 0) return;  // miss: the path ends, the carries pass through
  const Replay r = replay_bounce(T, o, d, gid);
  const VolBounce v = vol_bounce<kSurf>(T, r, base, d, med);
  const D3 zero = d3(0.0, 0.0, 0.0);
  if (!v.vs && r.mat[9] > 0.0f) {
    // light hit: the carries pass through, the emission counts (or not)
    physics_adj_vol<kSurf>(T, R, r, v, base, dep, nee, vol_nee, o, d, thr, med, prev_state,
                           false, false, g_rad, zero, zero, zero, zero, 0.0, g_o, g_d, g_thr,
                           g_sa, g_ss, acc);
    return;
  }

  // ---- step_update: thr2 = (thr * mult) [* 1/p]; the next o, d, medium if
  // it survives, the old ones if russian roulette ends it
  const V3 tm = vmul(thr, v.thr_mult);
  bool survive = true;
  AD inv_p = 1.0;
  if (rr && dep >= rr_start) {
    const float p_rr = fminf(fmaxf(fmaxf(fmaxf(tm.x, tm.y), tm.z), 0.05f), 1.0f);
    survive = uniform(base, 3) < p_rr;
    inv_p = 1.0f / p_rr;
  }
  const D3 g_tm = dscale(inv_p, g_thr);
  D3 g_thr_in = dmul(g_tm, up(v.thr_mult));
  const D3 g_mult = dmul(g_tm, up(thr));
  D3 g_o_in = survive ? zero : g_o, g_d_in = survive ? zero : g_d;
  D3 g_sa_in = survive ? zero : g_sa;
  AD g_ss_in = survive ? 0.0 : g_ss;
  physics_adj_vol<kSurf>(T, R, r, v, base, dep, nee, vol_nee, o, d, thr, med, prev_state,
                         nee_add, true, g_rad, survive ? g_o : zero, survive ? g_d : zero,
                         g_mult, survive ? g_sa : zero, survive ? g_ss : 0.0, g_o_in, g_d_in,
                         g_thr_in, g_sa_in, g_ss_in, acc);
  g_o = g_o_in;
  g_d = g_d_in;
  g_thr = g_thr_in;
  g_sa = g_sa_in;
  g_ss = g_ss_in;
}

// the reverse loop of one lane: its origin and direction cotangents; the
// table cotangents go to acc, and in the LANE_SUMS_ON instance the light's
// and the scalar's to the lane sums ls (zeroed by the caller, who adds them
// to the row after the loop)
template <bool kVol = false, bool kSurf = false>
PT_FN void bwd_lane(const Tables& T, const RowLayout& R, uint32_t seed, uint32_t s,
                    const float* resid, size_t n, size_t idx, int max_depth, int nee, int rr,
                    int rr_start, V3 g_rad_f, V3& g_o_out, V3& g_d_out, float* acc,
                    LaneSums* ls, int vol_nee = 1) {
  constexpr int NR = N_RESID<kVol>, RS = R_STATE<kVol>;
  if (g_rad_f.x == 0.0f && g_rad_f.y == 0.0f && g_rad_f.z == 0.0f) {
    // no cotangent: exact zeros, and nothing added to the tables
    g_o_out = g_d_out = v3(0.0f, 0.0f, 0.0f);
    return;
  }
  const uint32_t s_term = s * 0x85EBCA6Bu;
  const D3 g_rad = up(g_rad_f);
  D3 g_thr = d3(0.0, 0.0, 0.0);
  D3 g_o = g_thr, g_d = g_thr;  // the loop's final carries are discarded
  D3 g_sa = g_thr;
  AD g_ss = 0.0;
  for (int dep = max_depth - 1; dep >= 0; --dep) {
    const float* r = resid + (size_t)dep * NR * n + idx;
    if (!(r[(RS + 1) * n] > 0.5f)) continue;  // dead: identity, no table cotangent
    const V3 o = v3(r[(R_O + 0) * n], r[(R_O + 1) * n], r[(R_O + 2) * n]);
    const V3 d = v3(r[(R_D + 0) * n], r[(R_D + 1) * n], r[(R_D + 2) * n]);
    const V3 thr = v3(r[(R_THR + 0) * n], r[(R_THR + 1) * n], r[(R_THR + 2) * n]);
    const uint32_t base = bounce_base(seed, s_term, dep);
    if constexpr (kVol) {
      const Medium med{v3(r[(R_SA + 0) * n], r[(R_SA + 1) * n], r[(R_SA + 2) * n]), r[R_SS * n],
                       0.0f};
      bounce_adj_vol<kSurf>(T, R, base, dep, nee, vol_nee, rr, rr_start, o, d, thr, med,
                            r[RS * n], (int)r[(RS + 2) * n], r[(RS + 3) * n] > 0.5f, g_rad, g_o,
                            g_d, g_thr, g_sa, g_ss, acc);
    } else {
      bounce_adj<kSurf>(T, R, base, dep, nee, rr, rr_start, o, d, thr, r[RS * n],
                        (int)r[(RS + 2) * n], r[(RS + 3) * n] > 0.5f, g_rad, g_o, g_d, g_thr,
                        acc, ls);
    }
  }
  g_o_out = v3((float)g_o.x, (float)g_o.y, (float)g_o.z);
  g_d_out = v3((float)g_d.x, (float)g_d.y, (float)g_d.z);
}

// ---- the lane order of the media and surface instances (5v, 5s) ----------

constexpr int ORDER_BOUNCES = 8;  // the bounces a lane's key looks at
static_assert(1 << ORDER_BOUNCES == ORDER_KEYS, "a key holds one bit per bounce");

// A lane's key: bit d set where the lane lives at bounce d and takes its
// instance's costly branch there: in a scattering medium (kVol, kernel 5v:
// the free path's and the volumetric NEE's adjoints; ops/trace_grad.py:
// lane_keys_plain), on a Cook-Torrance or Ward material (kernel 5s: the
// lobe's adjoint).  It reads the residual planes and the tables alone.
template <bool kVol>
PT_FN int lane_key(const float* gtab, const float* mtab, const float* resid, size_t n, size_t idx,
                   int max_depth) {
  constexpr int NR = N_RESID<kVol>, RS = R_STATE<kVol>;
  int key = 0;
  for (int dep = 0; dep < max_depth && dep < ORDER_BOUNCES; ++dep) {
    const float* r = resid + (size_t)dep * NR * n + idx;
    if (!(r[(RS + 1) * n] > 0.5f)) break;  // dead from here on
    bool costly;
    if constexpr (kVol) {
      costly = r[R_SS * n] > 0.0f;
    } else {
      const int gid = (int)r[(RS + 2) * n];
      costly = gid >= 0 && mtab[(int)gtab[gid * GCOLS + 13] * MCOLS + 24] > 0.5f;
    }
    key |= (costly ? 1 : 0) << dep;
  }
  return key;
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

// The forward's instances that pack their live paths per block (4 and 4v,
// trace_fwd_kernel_packed): 4s's one path per thread (trace_fwd_kernel)
// measured faster, its paths short (2.7 bounces of 8 on ward).  The block:
// 256 paths for 4 (0.545 ms against 0.561 on 128), 128 for 4v, whose 96
// registers left two blocks of 256 per SM (0.935 ms on 256 against 0.89).
// A block's idle warps wait at its barriers, so more resident blocks hide
// them: 4 held to four blocks per SM (0.526 ms against 0.547 on its own 80
// registers, 0.668 on 85), 4v to six (0.868 against 0.89; PERF.md,
// section 6).
template <bool kVol, bool kSurf>
constexpr bool FWD_PACKED = !kSurf;
constexpr int FWD_THREADS = 128;  // trace_fwd_kernel
template <bool kVol>
constexpr int PACKED_THREADS = kVol ? 128 : 256;
template <bool kVol>
constexpr int PACKED_BLOCKS = kVol ? 6 : 4;  // resident per SM, at least
constexpr int BWD_THREADS = 128;

// The lane sums of a whole warp into the row (every thread of the warp
// calls it): where every lane's light slots hold one light, or none, each
// slot is summed over the warp with shuffles in a fixed order and added
// once; else each lane adds its own (lane_sums_add).
__device__ __forceinline__ void warp_sums_add(float* acc, const RowLayout& R, const LaneSums& ls) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lid = __reduce_max_sync(FULL, ls.lid);
  if (!__all_sync(FULL, ls.lid < 0 || ls.lid == lid)) {
    lane_sums_add(acc, R, ls);
    return;
  }
  for (int k = 0; k < LANE_SUMS; ++k) {
    AD v = ls.s[k * ls.stride];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if ((threadIdx.x & 31) == 0 && v != 0.0 && (k == LS_AREA || lid >= 0))
      acc_d(acc, lane_sum_col(R, k, lid), v);
  }
}

// the tables of a block's kernel: no meshes, the surface bits of a kSurf
// instance
template <bool kSurf>
__device__ __forceinline__ Tables block_tables(const float* smem, int G, int M, const float* scal,
                                               int surf) {
  return Tables{smem, smem + G * GCOLS, smem + G * GCOLS + M * MCOLS, G, scal[0],
                scal[1] > 0.5f, MeshTables{nullptr, nullptr, nullptr, nullptr, nullptr, 0},
                kSurf ? surf : 0};
}

// one path per thread, all its bounces (4s)
template <bool kVol, bool kSurf>
__global__ void __launch_bounds__(FWD_THREADS)
trace_fwd_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                 const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
                 const float* __restrict__ origin, const float* __restrict__ direction,
                 const uint32_t* __restrict__ sample, int n, float* __restrict__ radiance,
                 unsigned long long* __restrict__ nrays, float* __restrict__ resid,
                 int max_depth, int nee, int rr, int rr_start, int vol_nee, int surf) {
  extern __shared__ float smem[];
  load_tables(smem, gtab, G, mtab, M, ltab);
  __syncthreads();
  const Tables T = block_tables<kSurf>(smem, G, M, scal, surf);

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
  fwd_lane<kVol, kSurf>(T, seed, s, o, d, max_depth, nee, rr, rr_start, valid, resid, (size_t)n,
                        (size_t)(valid ? idx : 0), rad, bounces, vol_nee);
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

// the block's paths in its path planes, the live ones packed into its
// first warps at every bounce (4, 4v)
template <bool kVol, bool kSurf>
__global__ void __launch_bounds__(PACKED_THREADS<kVol>, PACKED_BLOCKS<kVol>)
trace_fwd_kernel_packed(const float* __restrict__ gtab, int G, const float* __restrict__ mtab,
                        int M, const float* __restrict__ ltab, const float* __restrict__ scal,
                        uint32_t seed, const float* __restrict__ origin,
                        const float* __restrict__ direction, const uint32_t* __restrict__ sample,
                        int n, float* __restrict__ radiance,
                        unsigned long long* __restrict__ nrays, float* __restrict__ resid,
                        int max_depth, int nee, int rr, int rr_start, int vol_nee, int surf) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int THREADS = PACKED_THREADS<kVol>, WARPS = THREADS / 32;
  extern __shared__ float smem[];
  __shared__ int warp_live[WARPS];
  load_tables(smem, gtab, G, mtab, M, ltab);
  const Tables T = block_tables<kSurf>(smem, G, M, scal, surf);
  float* planes = smem + table_floats(G, M);
  const PathPlanes P{planes, reinterpret_cast<int*>(planes + P_FLOATS<kVol> * THREADS), THREADS};

  // thread p holds path p of the block, lane idx: its record and outcome
  const int p = threadIdx.x, lane = p & 31, warp = p >> 5;
  const int idx = blockIdx.x * blockDim.x + p;
  const bool valid = idx < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  uint32_t s = 0;
  if (valid) {
    o = v3(origin[3 * idx], origin[3 * idx + 1], origin[3 * idx + 2]);
    d = v3(direction[3 * idx], direction[3 * idx + 1], direction[3 * idx + 2]);
    s = sample[idx];
  }
  path_init<kVol>(P, p, valid, o, d, s);
  __syncthreads();
  const size_t at = (size_t)(valid ? idx : 0);
  unsigned int bounces = 0;
  for (int dep = 0; dep < max_depth; ++dep) {
    path_record<kVol>(P, p, valid, resid, (size_t)n, at, dep);
    // the live paths in path order: a warp's count, then each live path's place
    const bool live = P.in(P_ALIVE, p) != 0;
    const unsigned ballot = __ballot_sync(FULL, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (total == 0) {  // every path of the block has ended: the rest are dead records
      path_outcome<kVol>(P, p, valid, resid, (size_t)n, at, dep);
      for (int rest = dep + 1; rest < max_depth; ++rest) {
        path_record<kVol>(P, p, valid, resid, (size_t)n, at, rest);
        path_outcome<kVol>(P, p, valid, resid, (size_t)n, at, rest);
      }
      break;
    }
    if (live) P.in(P_LIST, before + __popc(ballot & ((1u << lane) - 1u))) = p;
    __syncthreads();
    // the first `total` threads run the listed paths' bounces; the warps
    // past them wait at the barrier
    if (p < total)
      path_step<kVol, kSurf>(T, P, P.in(P_LIST, p), seed, dep, nee, rr, rr_start, vol_nee,
                             bounces);
    __syncthreads();
    path_outcome<kVol>(P, p, valid, resid, (size_t)n, at, dep);
  }
  if (valid) {
    radiance[3 * idx] = P.at(P_RAD, p);
    radiance[3 * idx + 1] = P.at(P_RAD + 1, p);
    radiance[3 * idx + 2] = P.at(P_RAD + 2, p);
  }
  // exact ray count: warp sum, one 64-bit atomic per warp
  unsigned long long c = (unsigned long long)bounces * (nee ? 2ull : 1ull);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(FULL, c, off);
  if (lane == 0 && c) atomicAdd(nrays, c);
}

using FwdKernel = decltype(&trace_fwd_kernel<false, true>);  // 4s's, launched anyway

// the forward's instance: its kernel, threads per block and the
// shared-memory bytes of its path planes (beside the tables)
template <bool kVol, bool kSurf>
FwdKernel fwd_instance(int& threads, size_t& path_bytes) {
  if constexpr (FWD_PACKED<kVol, kSurf>) {
    threads = PACKED_THREADS<kVol>;
    path_bytes = sizeof(float) * path_floats<kVol>(threads);
    return trace_fwd_kernel_packed<kVol, kSurf>;
  } else {
    threads = FWD_THREADS;
    path_bytes = 0;
    return trace_fwd_kernel<kVol, kSurf>;
  }
}

template <bool kVol, bool kSurf>
__global__ void __launch_bounds__(BWD_THREADS)
trace_bwd_kernel(const float* __restrict__ gtab, int G, const float* __restrict__ mtab, int M,
                 const float* __restrict__ ltab, const float* __restrict__ scal, uint32_t seed,
                 const uint32_t* __restrict__ sample, int n, const float* __restrict__ resid,
                 const float* __restrict__ g_radiance, float* __restrict__ d_origin,
                 float* __restrict__ d_direction, float* __restrict__ partial, int max_depth,
                 int nee, int rr, int rr_start, int vol_nee, int surf,
                 const int* __restrict__ order) {
  extern __shared__ float smem[];
  const RowLayout R = row_layout(G, M);
  // the block's table row is its row of `partial`, in device memory: the
  // lanes' float atomics there are reductions resolved in L2
  float* acc = partial + (size_t)blockIdx.x * R.k;
  load_tables(smem, gtab, G, mtab, M, ltab);
  for (int i = threadIdx.x; i < R.k; i += blockDim.x) acc[i] = 0.0f;
  // kernel 5: each thread's lane sums, slot k at [k * BWD_THREADS + thread],
  // after the tables
  constexpr bool kSums = LANE_SUMS_ON<kVol, kSurf>;
  LaneSums ls{nullptr, BWD_THREADS, -1};
  if constexpr (kSums) {
    ls.s = reinterpret_cast<AD*>(smem + sums_offset(G, M)) + threadIdx.x;
    for (int k = 0; k < LANE_SUMS; ++k) ls.s[k * BWD_THREADS] = 0.0;
  }
  __syncthreads();
  const Tables T = block_tables<kSurf>(smem, G, M, scal, surf);

  // thread t takes lane order[t] where the instance orders its lanes
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int idx = order != nullptr && t < n ? order[t] : t;
  if (idx < n) {  // lanes past n contribute nothing
    const V3 g_rad = v3(g_radiance[3 * idx], g_radiance[3 * idx + 1], g_radiance[3 * idx + 2]);
    V3 g_o, g_d;
    bwd_lane<kVol, kSurf>(T, R, seed, sample[idx], resid, (size_t)n, (size_t)idx, max_depth, nee,
                          rr, rr_start, g_rad, g_o, g_d, acc, &ls, vol_nee);
    d_origin[3 * idx] = g_o.x;
    d_origin[3 * idx + 1] = g_o.y;
    d_origin[3 * idx + 2] = g_o.z;
    d_direction[3 * idx] = g_d.x;
    d_direction[3 * idx + 1] = g_d.y;
    d_direction[3 * idx + 2] = g_d.z;
  }
  if constexpr (kSums) warp_sums_add(acc, R, ls);
}

// A lane's key for the lane order (bounce_adj.cuh:lane_order): lane_key on
// the residuals
template <bool kVol>
struct ResidKey {
  const float* gtab;
  const float* mtab;
  const float* resid;
  int n, max_depth;
  __device__ int operator()(size_t i) const {
    return lane_key<kVol>(gtab, mtab, resid, (size_t)n, i, max_depth);
  }
};

// The lane order of n lanes by lane_key into scratch (lane_order_ints(n)
// ints: the keys, the order, the counts and the fill counters)
cudaError_t resid_lane_order(const float* gtab, const float* mtab, const float* resid, int n,
                             int max_depth, int vol, int* scratch, cudaStream_t stream) {
  return vol ? lane_order(ResidKey<true>{gtab, mtab, resid, n, max_depth}, n, scratch, stream)
             : lane_order(ResidKey<false>{gtab, mtab, resid, n, max_depth}, n, scratch, stream);
}

}  // namespace

// surf: the surface feature bits (0 runs the instance without the surface
// blocks, any other value the kSurf one)
extern "C" int trace_fwd_launch(const float* gtab, int G, const float* mtab, int M,
                                const float* ltab, const float* scal, unsigned int seed,
                                const float* origin, const float* direction,
                                const unsigned int* sample, int n, float* radiance,
                                unsigned long long* nrays, float* resid, int max_depth, int nee,
                                int rr, int rr_start, int vol, int vol_nee, int surf,
                                void* stream) {
  if (n <= 0) return 0;
  int threads;
  size_t path_bytes;
  const FwdKernel kernel =
      vol ? (surf ? fwd_instance<true, true>(threads, path_bytes)
                  : fwd_instance<true, false>(threads, path_bytes))
          : (surf ? fwd_instance<false, true>(threads, path_bytes)
                  : fwd_instance<false, false>(threads, path_bytes));
  const int blocks = (n + threads - 1) / threads;
  // the tables, then the block's path planes where it packs its paths
  const size_t smem = sizeof(float) * table_floats(G, M) + path_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, origin, direction, sample, n, radiance, nrays, resid,
      max_depth, nee, rr, rr_start, vol_nee, surf);
  return (int)cudaGetLastError();
}

// the ints of scratch that the lane order of n lanes needs (lane_order_launch;
// trace_bwd_launch's media and surface instances)
extern "C" int lane_order_ints(int n) { return pt::lane_order_ints(n); }

// the keys (scratch[0, n)) and the order (scratch[n, 2n)) of n lanes'
// residuals: vol picks the media key, else the surface one
extern "C" int lane_order_launch(const float* gtab, const float* mtab, const float* resid, int n,
                                 int max_depth, int vol, int* scratch, void* stream) {
  if (n <= 0) return 0;
  return (int)resid_lane_order(gtab, mtab, resid, n, max_depth, vol, scratch,
                               (cudaStream_t)stream);
}

// the rows of `partial` that trace_bwd_launch needs for n lanes: one per
// block and the row sum's scratch
extern "C" int trace_bwd_rows(int n) {
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  return blocks > 0 ? blocks + row_sum_scratch(blocks) : 1;
}

extern "C" int trace_bwd_launch(const float* gtab, int G, const float* mtab, int M,
                                const float* ltab, const float* scal, unsigned int seed,
                                const unsigned int* sample, int n, const float* resid,
                                const float* g_radiance, float* d_origin, float* d_direction,
                                float* partial, float* row, int max_depth, int nee, int rr,
                                int rr_start, int vol, int vol_nee, int surf, int* order_scratch,
                                void* stream) {
  const RowLayout R = row_layout(G, M);
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  if (n <= 0) return (int)cudaMemsetAsync(row, 0, sizeof(float) * R.k, (cudaStream_t)stream);
  // the tables, and the lane sums in the instance that keeps them
  const size_t smem = sizeof(float) * (vol || surf ? table_floats(G, M)
                                       : sums_offset(G, M) + 2 * LANE_SUMS * BWD_THREADS);
  const auto kernel = vol ? (surf ? trace_bwd_kernel<true, true> : trace_bwd_kernel<true, false>)
                          : (surf ? trace_bwd_kernel<false, true> : trace_bwd_kernel<false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the media and surface instances take their lanes grouped by lane_key
  const int* order = nullptr;
  if (vol || surf) {
    const cudaError_t e = resid_lane_order(gtab, mtab, resid, n, max_depth, vol, order_scratch,
                                           (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    order = order_scratch + n;
  }
  kernel<<<blocks, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      gtab, G, mtab, M, ltab, scal, seed, sample, n, resid, g_radiance, d_origin, d_direction,
      partial, max_depth, nee, rr, rr_start, vol_nee, surf, order);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)row_sum(partial, blocks, R.k, partial + (size_t)blocks * R.k, row,
                      (cudaStream_t)stream);
}

#endif  // __CUDACC__