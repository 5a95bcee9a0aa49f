"""Device times of the per-bounce adjoint (kernels 3, 3v and 3s, the adjoint
body and the table row sum apart), of the full-depth reverse kernels' row
sum (5, 5v and 5s), of the full-depth forward loop (kernels 1 and 4 and
their instances), of kernel 1m, and of the steps and the iteration that
run them, for one or more checkouts in turns on one card:

    python -m pathtracer_tpu_torch.tools.kernel_split [--parts PARTS] [NAME=DIR ...]

Each ``NAME=DIR`` is a checkout (its ``pathtracer_tpu_torch/``, ``scenes/``
and ``chip_smoke.py``, as ``git archive`` unpacks them); with none, this
checkout.  They run in the order given (``a=P b=C b=C a=P`` for parent /
change / change / parent), each in a process of its own that builds its
kernels from its own sources (``tools/in_turns``).  Each process prints
``[split]`` lines for the parts that ``--parts`` names (comma-separated;
``adjoint,forward,1m,steps`` by default):

- adjoint: kernel 3 on Cornell 800x800, 3v on milky 800x800 (vol_nee
  on) and 3s on ward 512x512, each on the state after two bounces (640,000,
  640,000 and 262,144 lanes; seeded cotangents), and kernels 5 / 5v / 5s on
  the same scenes' iteration-0 residuals: per launch the device time of the
  body (``bounce_bwd_kernel`` / ``trace_bwd_kernel``) and of the row sum
  (every kernel named ``row_sum``) and, for 5v and 5s, of the lane order
  before it (``lane_order``), from the profiler over 10 calls, twice, which
  must keep every launch of the body and the row sum (``_profiled_split``);
- forward: kernels 1 (Cornell 800x800, russian roulette off and on from
  bounce 3), 1v (fog and glass_dof at 800x800), 1hg (sss 512x512), 1s
  (ward 512x512, textured 800x800), 1m (smooth_mesh 512x512), 1m-vol (the
  fog cube around the icosphere, ``scene/variants.fog_mesh_scene``, 512x512)
  and 4 (Cornell), 4v (milky 800x800, vol_nee on), 4s (ward 512x512) on an
  iteration's primary rays, depth 8, NEE: each launch's device time
  (``chip_smoke.queued_ms``, the median of 10, twice) and the mean
  bounces a lane traced (the ray count over the lanes, halved for NEE's
  shadow rays), whose share of the depth is the share of lane-bounces that
  hold a live path; Cornell's render iteration around kernel 1 by host
  clock, ten repeats, with the device's busy time and idle share from a
  profile of three;
- 1m: kernel 1m on smooth_mesh's 262,144 primary rays at 512x512, depth
  8, NEE (``chip_smoke.queued_ms``, the median of 10, twice), and the
  megakernel iteration around it by host clock, five repeats;
- steps: the per-bounce and full-depth gradient steps of Cornell, milky
  and ward (4 spp, depth 8, target zeros) by host clock ending in a
  synchronize, ten repeats each, with the time until the step returns
  (the host's part, before the synchronize); from one profiled step the
  device's busy time (every kernel), its idle share against the median
  step, and the adjoint kernel's body and row sum per launch.

- perbounce: kernels 2 and 3 where the engines launch them (Cornell 800x800,
  depth 8, NEE): kernel 2's device time summed over the pinned 8-spp render
  (every launch, from the profiler, twice), per launch at super-step 10 and
  2r's at each bounce of the per-bounce scan of the primary rays (with the
  share of lanes alive; ``chip_smoke.queued_ms``, twice); the per-bounce
  gradient step of Cornell, milky and ward (4 spp) by host clock, ten
  repeats, and from two profiled steps its device busy time, idle share,
  2r's total (every ``bounce_kernel`` launch) and kernel 3's body, row sum
  and lane order per launch; kernels 3 / 3v / 3s isolated on the state
  after two bounces with the engine's cotangents (zero on the lanes that
  died), body, row sum and lane order apart (``_profiled_split``); 3s also
  in index order (``ordered=False``) where the checkout orders its lanes;
- rows: kernel 2's instances 2v, 2hg (sss), 2m (smooth_mesh), 2s (ward),
  2t (textured_image), each at 512x512 on the pinned engine's super-step 10
  (2 spp), and kernels 6 and 8 on Cornell's (800x800, 8 spp) and 7 on the
  same rays: ``chip_smoke.queued_ms``, twice;
- 2m: kernel 2's mesh instances where the pinned engine launches them,
  each at super-step 10 of a 2-spp render at 512x512: 2m on smooth_mesh
  (320 triangles, 10 chunks) and 2mt on a vt grid of ``GRID_CELLS`` squared
  cells (``scene/variants.grid_obj``, 4,050 triangles, 127 chunks) in
  ``variants.textured_mesh_scene``: the launch's device time
  (``chip_smoke.queued_ms``, twice, and profiled over 10 calls), the same
  state without the in-kernel meshes (the analytic instance: neither
  triangle sweep), and from ``chunk_reach`` the share of lanes and of warps
  whose ray reaches a chunk box and the chunks a warp sweeps together, in
  index order and with its lanes ordered by the first chunk they reach;
- packing: kernels 4 (Cornell 800x800), 4v (milky 800x800) and 4s (ward
  512x512) on an iteration's primary rays (``chip_smoke.queued_ms``,
  twice), the share of lanes alive at each bounce (the residuals' alive
  plane) and the live share of the thread-bounces that warps run: in index
  order (a warp runs while one of its lanes lives) and with the live paths
  of each block of 128 or 256 packed into its first warps.

- events: kernel 2's analytic media and surface instances where the
  engines launch them: 2v and 2hg (sss), 2s (ward), 2t (textured_image),
  2v-s (kVol x kSurf: ``scene/variants.milky_ward_scene``, 800x800) and
  the vacuum instance 2 (Cornell 800x800) at the pinned engine's
  super-step 10 (2 spp, 512x512 but milky_ward and Cornell; the state
  captured with the plain bounce), and the replay instances 2r-v (milky
  800x800, vol_nee on), 2r-s (ward 512x512) and 2r (Cornell) at each
  bounce of the per-bounce scan of the primary rays
  (``chip_smoke.queued_ms``, twice), with the per-bounce step of each (4
  spp) profiled twice for 2r's device time over its 32 launches; for each
  state, from :func:`event_keys` on its planes, the share of lanes of each
  event (:data:`EVENT_CLASSES`) and the share of warps of 32 that hold more
  than one event and more than one key (:func:`mixed_warps`): in index
  order and with each block of 128 or 256 lanes ordered by key, as the
  grouped kernel (2r-v) shades them.

- intersect: kernels 6, 7 and 8 (``csrc/intersect.cu``) on the rays of
  Cornell's super-step 10 (800x800, pinned 8 spp, 640,000 lanes), each
  whole and on a one-row table of a mesh slot, which the sweep skips (the
  planes-only floor: the rays loaded and every output stored).
  Kernel 7 also on the rays of launches :data:`LEAN_LAUNCHES` of a 1-spp
  lean step (``RenderConfig(grad_fused=False)``), with the sizes of all
  its launches (``chip_smoke.queued_ms``, twice each).  Kernel 8 where the
  routes launch it, on the shadow rays that a hook on
  ``ops/intersect_cuda.occlusion_t_cuda`` captures (:func:`capture_shadow`:
  launches :data:`SHADOW_SPLIT_LAUNCHES` of Cornell's 2-spp split render and
  one launch of a 1-spp lean step on sss and on smooth_mesh) and on the
  super-step 10 lanes above: equal to plain, its call and the kernel alone,
  and the share of its exact tests that the padded world-box cull leaves
  per lane and per warp (:func:`cull_counts`, the cull of this tool's own
  checkout counted on each checkout's rays); then the split route's 2-spp
  render, its wall time and its device time per super-step.  Then each kernel's
  resources (``cuobjdump -res-usage``) and its SASS counted by
  :data:`SASS_CLASSES`, whole and in the geom loop (:func:`sass_loop`),
  with ``--listing-dir DIR`` the whole listing written to
  ``DIR/intersect_sass_<checkout>.txt``. This part alone builds only the
  libraries it launches and prints no other registers.

Every process also prints the registers and spills of every instance of
kernels 1, 2, 3, 4 and 5 (none when its libraries were built earlier).

A ``NAME=variant:V`` checkout is a copy of this checkout under
``build/kernel_split/V`` with the source edits of ``VARIANTS[V]``
(``NAME=variant:V@DIR``: a copy of the checkout ``DIR``): a
variant measured for timing only (``noshadow``: kernel 2 without the
surface NEE's shadow sweep and volumetric NEE's ``occ_split``;
``planesonly``: kernel 2 loading its planes and storing outputs made from
them, with no bounce, the card's floor for its bytes; ``group256``: 2r-v's
grouped kernel on blocks of 256 lanes; ``norows``: kernel 3 without its row
sums; ``nomeshocc``: the bounce's shadow ray without its triangle sweep
``mesh_occ``, which kernel 1m shares and the ``2m`` part does not run;
``fwd128``: kernel 4 packing blocks of 128 paths, not 256; ``surfpacked``:
kernel 4s packing its live paths too; ``fwdfree``: kernel 4's packed
instances free to take the registers they want, not held to four blocks
of 256 (4) and six of 128 (4v) per SM; ``lanesweep``: kernel 2's mesh
instances with each lane sweeping the triangles on its own, as kernel 1m
does, instead of the block's sweep).

Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ADJOINT_SCENES = (("3", "cornell.txt", None), ("3v", "milky.txt", None),
                  ("3s", "ward.txt", (512, 512)))


PROFILE_TRIES = 3  # profiles of one measurement while records are missing
ADJOINT_THREADS = 128  # lanes per block of kernels 3 and 5, each block one partial row


def _row_sum_per_call(names, lanes: int):
    """Row-sum launches per call of a checkout's reverse kernel, told by the
    names the profiler kept: ``block_row_sum`` (the older design) once;
    ``row_sum_segments`` once up to 64 partial rows, twice above."""
    if any("row_sum_segments" in k for k in names):
        return 1 if -(-lanes // ADJOINT_THREADS) <= 64 else 2
    return 1 if any("block_row_sum" in k for k in names) else None


def _profiled_split(cs, fn, body: str, lanes: int, reps: int = 10) -> tuple:
    """Per call of ``fn`` at ``lanes`` lanes: the body kernel's device ms,
    the row sum's (its launches summed), the row-sum launches per call and
    the lane order's ms (kernels 5v and 5s; its two launches summed, 0
    where none ran), from a profile of ``reps`` calls that kept every
    launch of the body and the row sum, taken again while one is missing
    (up to ``PROFILE_TRIES`` times)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        run, _ = cs.profiled(fn, reps)
        b_us, b_n = (sum(v[j] for k, v in run.items() if body in k) for j in (0, 1))
        r_us, r_n = (sum(v[j] for k, v in run.items() if "row_sum" in k) for j in (0, 1))
        per = _row_sum_per_call(run, lanes)
        o_us = sum(v[0] for k, v in run.items() if "lane_order" in k)
        if b_n == reps and per is not None and r_n == reps * per:
            return b_us / 1e3 / reps, r_us / 1e3 / reps, per, o_us / 1e3 / reps
    raise RuntimeError(f"the profiler kept {b_n} launches of {body} and {r_n} of the row sum "
                       f"for {reps} calls")


PARTS = ("adjoint", "forward", "1m", "steps", "perbounce", "rows", "2m", "packing", "events",
         "intersect")
DEFAULT_PARTS = ("adjoint", "forward", "1m", "steps")
# variant copies of this checkout: name -> (file, text, replacement) edits
VARIANTS = {
    "norows": (("pathtracer_tpu_torch/csrc/bounce_grad.cu",
                "constexpr bool BWD_ROWS_ON = !kVol;", "constexpr bool BWD_ROWS_ON = false;"),),
    "nomeshocc": (("pathtracer_tpu_torch/csrc/trace_common.cuh",
                   "if (T.mesh.n > 0 && occ_t >= dist - SHADOW_SLACK)",
                   "if (false && T.mesh.n > 0 && occ_t >= dist - SHADOW_SLACK)"),),
    "fwd128": (("pathtracer_tpu_torch/csrc/trace_grad.cu",
                "constexpr int PACKED_THREADS = kVol ? 128 : 256;",
                "constexpr int PACKED_THREADS = 128;"),),
    "surfpacked": (("pathtracer_tpu_torch/csrc/trace_grad.cu",
                    "constexpr bool FWD_PACKED = !kSurf;", "constexpr bool FWD_PACKED = true;"),),
    "fwdfree": (("pathtracer_tpu_torch/csrc/trace_grad.cu",
                 "constexpr int PACKED_BLOCKS = kVol ? 6 : 4;",
                 "constexpr int PACKED_BLOCKS = 1;"),),
    "noshadow": (("pathtracer_tpu_torch/csrc/trace_common.cuh",
                  """      float occ_t = BIG;
      for (int g = 0; g < T.G; ++g) {
        const float* m = T.g + g * GCOLS;
        V3 oo, od;
        to_object(m, x, wi, oo, od);
        occ_t = fminf(occ_t, geom_t(m, oo, od));
      }
      // min(analytic, mesh)""",
                  """      float occ_t = BIG;
      for (int g = 0; g < 0; ++g) {
        const float* m = T.g + g * GCOLS;
        V3 oo, od;
        to_object(m, x, wi, oo, od);
        occ_t = fminf(occ_t, geom_t(m, oo, od));
      }
      // min(analytic, mesh)"""),
                 ("pathtracer_tpu_torch/csrc/trace_common.cuh",
                  "occ_split(T, vol_pos, wiv, occ_op, occ_re);", "occ_op = occ_re = BIG;")),
    "planesonly": (("pathtracer_tpu_torch/csrc/bounce.cu",
                    "if (replay_gid != nullptr && vol && !hg",
                    "if (false && replay_gid != nullptr && vol && !hg"),
                   ("pathtracer_tpu_torch/csrc/bounce_lane.cuh",
                    """  const Bounce b = bounce<true, kVol, kHg, kSurf, kTex, kMerge>(T, base, dep, nee, o, d, t,
                                                                prev[i], med, vol_nee, ext, pre);""",
                    """  Bounce b{};
  b.contrib = o;
  b.next_o = d;
  b.next_d = t;
  b.thr_mult = o;
  b.terminate = dep & 1;
  b.wspec = prev[i];
  b.gid = dep;
  b.nee_add = dep & 2;
  b.medium = med;
  b.tex_u = b.tex_v = b.tex_slot = prev[i];""")),
    "group256": (("pathtracer_tpu_torch/csrc/bounce.cu", "constexpr int GROUP_THREADS = 128;",
                  "constexpr int GROUP_THREADS = 256;"),),
    "rays1": (("pathtracer_tpu_torch/csrc/intersect.cu", "constexpr int RAYS = 2;",
               "constexpr int RAYS = 1;"),),
    "rays4": (("pathtracer_tpu_torch/csrc/intersect.cu", "constexpr int RAYS = 2;",
               "constexpr int RAYS = 4;"),),
    "lanesweep": (("pathtracer_tpu_torch/csrc/bounce.cu",
                   "if constexpr (kMesh) {  // the block's sweep first",
                   "if constexpr (false) {  // the block's sweep first"),
                  ("pathtracer_tpu_torch/csrc/bounce.cu",
                   "nullptr, 0, kMesh ? &pre : nullptr);", "nullptr, 0, nullptr);")),
}
GRID_CELLS = 45  # the 2m part's vt grid: 2 * 45^2 = 4,050 triangles, under the in-kernel cap
# the packing part's launches: label, scene, resolution
PACKING_CASES = (("4", "cornell", None), ("4v", "milky", None), ("4s", "ward", (512, 512)))
# the forward part's launches: label, kernel (1 or 4), scene, resolution,
# russian roulette from bounce 3
FORWARD_CASES = (
    ("1", 1, "cornell", None, False), ("1 rr", 1, "cornell", None, True),
    ("1v", 1, "fog", (800, 800), False), ("1v", 1, "glass_dof", None, False),
    ("1hg", 1, "sss", (512, 512), False), ("1s", 1, "ward", (512, 512), False),
    ("1s", 1, "textured", None, False), ("1m", 1, "smooth_mesh", (512, 512), False),
    ("1m-vol", 1, "fog_mesh_glass", (512, 512), False),
    ("4", 4, "cornell", None, False), ("4v", 4, "milky", None, False),
    ("4s", 4, "ward", (512, 512), False),
)


# the event keys counted over kernel 2's lanes: csrc/trace_common.cuh:event_key's
# (2r-v's grouped kernel) widened to the surface instances' lobes, bump and texture
EV_ENDS, EV_SCATTER, EV_SURFACE, EV_LOBES = 0, 1, 2, 6
EVENT_KEYS = EV_SURFACE + 4 * EV_LOBES
# the events by their cost: the path ends; a surface event without a shadow
# sweep (a specular lobe, or NEE off); one with the NEE shadow sweep (a
# diffuse lobe under NEE); an in-medium scatter (volumetric NEE's split sweep)
EVENT_CLASSES = ("ends", "surface", "surface with NEE", "scatter")
# the events part's super-step rows: label, scene, spp, resolution
EVENT_ROWS = (("2v", "sss", (512, 512)), ("2hg", "sss", (512, 512)), ("2s", "ward", (512, 512)),
              ("2t", "textured_image", (512, 512)), ("2v-s", "milky_ward", None),
              ("2", "cornell", None))
# its per-bounce rows: label, scene, resolution
EVENT_SCANS = (("2r-v", "milky", None), ("2r-s", "ward", (512, 512)), ("2r", "cornell", None))


def milky_ward_text() -> str:
    """``scene/variants.milky_ward_scene``'s text, built here from
    ``scenes/milky.txt`` so that a checkout that predates it runs it too."""
    with open(os.path.join("scenes", "milky.txt")) as f:
        text = f.read()
    marker = "MATERIAL 4  // milky glass"
    return text.replace(marker, "BRDF        ward 0.2 0.5\n\n" + marker)


def event_keys(tables, origin, direction, sample, depth, medium, seed: int,
               features=frozenset()):
    """Each lane's event key (int64 ``[N]``) on analytic scenes, a wider key
    than ``csrc/trace_common.cuh:event_key`` (whose lanes, 2r-v's, take
    lobes 0-3 with no bump or texture: its ``EV_SURFACE + lobe``):
    ``EV_SCATTER``
    where the medium's free path (``medium [N, >= 4]``, with ``volumetric``
    in ``features``) ends before the nearest hit, ``EV_ENDS`` on a miss or a
    light hit, else ``EV_SURFACE + 4 * lobe + 2 * bump + texture`` (lobes:
    diffuse, mirror, Phong glossy, glass, Cook-Torrance, Ward; bump and
    texture with their features)."""
    import torch

    from pathtracer_tpu_torch.ops.intersect import BIG, T_MIN, sweep
    from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes

    gtab, mtab = tables[0], tables[1]
    n = origin.shape[0]
    best_t, gid, _ = sweep(gtab, tuple(origin.unbind(-1)), tuple(direction.unbind(-1)), T_MIN)
    hit = best_t < BIG
    mat = mtab[torch.where(hit, gtab[gid, 13].to(torch.int64), 0)]
    dep = torch.as_tensor(depth, dtype=torch.int32, device=origin.device).expand(n)
    scatter = torch.zeros_like(hit)
    if "volumetric" in features:
        u8 = hash_uniforms_planes(seed, sample, dep, 11)[8]
        ss = medium[:, 3]
        free = torch.where(ss > 0.0, -torch.log(torch.clamp(1.0 - u8, 1e-7, 1.0))
                           / torch.clamp(ss, min=1e-12), BIG)
        scatter = hit & (free < best_t)
    refr = mat[:, 7] > 0.0
    refl = ~refr & (mat[:, 6] > 0.0)
    ct = refl & (mat[:, 24] > 0.5) if "microfacet" in features else torch.zeros_like(refl)
    ward = ct & (mat[:, 24] > 1.5) if "ward" in features else torch.zeros_like(ct)
    glossy = refl & ~ct & (mat[:, 10] > 0.0)
    lobe = torch.where(refr, 3, torch.where(ward, 5, torch.where(ct, 4, torch.where(
        glossy, 2, torch.where(refl, 1, 0)))))
    bump = (mat[:, 21] > 0.0) if "bump" in features else torch.zeros_like(hit)
    tex = (mat[:, 16] > 0.5) if "texture" in features else torch.zeros_like(hit)
    surface = EV_SURFACE + 4 * lobe + 2 * bump.long() + tex.long()
    ends = ~hit | (mat[:, 9] > 0.0)
    return torch.where(scatter, EV_SCATTER, torch.where(ends, EV_ENDS, surface)).long()


def event_classes(keys, nee: bool = True):
    """Each lane's index in :data:`EVENT_CLASSES` from its event key."""
    import torch

    diffuse = (keys >= EV_SURFACE) & ((keys - EV_SURFACE) // 4 == 0)
    return torch.where(keys == EV_SCATTER, 3, torch.where(
        keys == EV_ENDS, 0, torch.where(diffuse & nee, 2, 1)))


def mixed_warps(keys, block=None) -> float:
    """The share of warps (32 consecutive lanes, the last one partial) whose
    lanes hold more than one key: in index order, or with each ``block`` of
    consecutive lanes first ordered by key, ties in index order (kernel 2's
    grouped kernel, ``csrc/bounce.cu:block_rank``)."""
    import torch

    n = keys.shape[0]
    k = keys
    if block:
        pad = (-n) % block
        k = torch.cat([k, k.new_full((pad,), int(k.max()) + 1)]) if pad else k
        k = torch.sort(k.view(-1, block), dim=-1, stable=True).values.reshape(-1)[:n]
    pad = (-n) % 32
    if pad:
        k = torch.cat([k, k[-1:].expand(pad)])
    w = k.view(-1, 32)
    return float((w.max(-1).values != w.min(-1).values).double().mean())


def _event_summary(keys, nee: bool = True) -> str:
    """The events line's shares: of lanes per class, of mixed warps."""
    import torch

    cls = event_classes(keys, nee)
    shares = ", ".join(f"{name} {float((cls == c).double().mean()):.4f}"
                       for c, name in enumerate(EVENT_CLASSES))
    warps = "; ".join(f"{what} {mixed_warps(cls, b):.4f} [{mixed_warps(keys, b):.4f}]"
                      for what, b in (("index order", None), ("blocks of 128", 128),
                                      ("blocks of 256", 256)))
    return (f"events: {shares}; {len(torch.unique(keys))} keys; warps holding more than one "
            f"event [key]: {warps}")


def events(cs, card: str, here: str) -> None:
    """The ``events`` part (the module's docstring)."""
    import dataclasses

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    seed = key_to_seed(prng_key(0))

    def desc_of(name, res):
        if name == "milky_ward":
            desc = parse_scene_text(milky_ward_text(), name=name, scene_dir="scenes")
        else:
            desc = load_scene(os.path.join("scenes", f"{name}.txt"))
        return dataclasses.replace(desc, resolution=res) if res else desc

    for label, name, res in EVENT_ROWS:
        scene = desc_of(name, res).scene_for_frame(0, device=dev)
        cfg = RenderConfig(wavefront=True, iters_per_launch=2, max_depth=8, nee=True)
        feats = resolve_features(cfg, scene.materials).features
        if label == "2v":
            feats = tuple(f for f in feats if f != "hg")
        # the state captured with the plain bounce, so that every checkout
        # (and a variant whose kernel does no bounce) times the same lanes
        captured = {}
        kernel, bounce_fused.bounce_fused_cuda = (bounce_fused.bounce_fused_cuda,
                                                  bounce_fused.bounce_fused_plain)
        try:
            cs.capturing_render(scene, 2, cfg, dev, captured)
        finally:
            bounce_fused.bounce_fused_cuda = kernel
        tables = [t.contiguous() for t in pack_tables(scene)]
        medium = captured["medium"]
        if label == "2v":
            medium = medium[:, :4]
        medium = medium.contiguous()
        margs = (tables, captured["origin"], captured["direction"], captured["throughput"],
                 captured["sample"], captured["depth"], captured["prev"], medium, seed)
        kw = dict(nee=True, features=frozenset(feats), tex_defer=scene.textures is not None)
        ms = [cs.queued_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, **kw))
              for _ in range(2)]
        keys = event_keys(tables, *margs[1:3], margs[4], margs[5], medium, seed, feats)
        print(f"[split] {here} events kernel {label} {name} super-step {cs.CAPTURE_STEP} "
              f"({margs[1].shape[0]} lanes): {ms[0]:.4f} / {ms[1]:.4f} ms of device time "
              f"(queued); {_event_summary(keys)}; on {card}", flush=True)

    base = RenderConfig(wavefront=False, nee=True, max_depth=8, grad_full_trace=False)
    for label, name, res in EVENT_SCANS:
        params, static = diff.params_from_description(desc_of(name, res), 0, device=dev)
        target = torch.zeros((static.resolution[0] * static.resolution[1], 3), **f32)

        def step():
            return diff.loss_and_grad_rays(params, static, target, 4, prng_key(0), base,
                                           device=dev)

        step()
        torch.cuda.synchronize()
        for rep in range(2):
            run, _ = cs.profiled(step)
            r2, n2 = _device_sum(run, "bounce_kernel")
            print(f"[split] {here} events step {label} {name} per-bounce 4 spp, repeat {rep}: "
                  f"2r {r2:.4f} ms of device time in {n2} launches ({r2 / max(n2, 1):.4f} per "
                  f"launch); on {card}", flush=True)
        with torch.no_grad():
            scn = diff.build_scene(params, static)
            tabs = [t.contiguous() for t in pack_tables(scn)]
            feats = frozenset(resolve_features(base, params.materials).features)
            w, h = static.resolution
            n = w * h
            lanes = torch.arange(n, dtype=torch.int64, device=dev)
            rays = generate_camera_rays(scn.camera, lanes, camera_uniforms(seed, lanes))
            st = dict(origin=rays.origin, direction=rays.direction,
                      throughput=torch.ones((n, 3), **f32), prev=torch.zeros(n, **f32),
                      medium=torch.zeros((n, 4), **f32))
            on = torch.ones(n, dtype=torch.bool, device=dev)
            for dep in range(8):
                # the depth as a plane already on the card: an int would be
                # copied in by the wrapper, waiting out queued_ms's sleep
                depth = torch.full((n,), dep, dtype=torch.int32, device=dev)
                sargs = (tabs, st["origin"], st["direction"], st["throughput"], lanes, depth,
                         st["prev"], st["medium"], seed)
                kw = dict(nee=True, features=feats)
                ms = [cs.queued_ms(lambda: bounce_fused.bounce_fused_cuda(
                    *sargs, emit_replay=True, **kw)) for _ in range(2)]
                keys = event_keys(tabs, st["origin"], st["direction"], lanes, depth,
                                  st["medium"], seed, feats)
                print(f"[split] {here} events kernel {label} {name} bounce {dep} of the scan, "
                      f"{int(on.sum())} of {n} lanes alive: {ms[0]:.4f} / {ms[1]:.4f} ms of "
                      f"device time (queued); {_event_summary(keys)}; on {card}", flush=True)
                r = bounce_fused.bounce_fused_cuda(*sargs, **kw)
                on = on & ~r.terminate
                a = on[:, None]
                st = dict(origin=torch.where(a, r.next_origin, st["origin"]),
                          direction=torch.where(a, r.next_direction, st["direction"]),
                          throughput=torch.where(a, st["throughput"] * r.throughput_mult,
                                                 st["throughput"]),
                          prev=r.was_specular,
                          medium=r.next_medium if "volumetric" in feats else st["medium"])


def _device_sum(run: dict, name: str) -> tuple:
    """``(device ms, launches)`` of the kernels whose names hold ``name`` in
    a ``chip_smoke.profiled`` table."""
    return (sum(v[0] for k, v in run.items() if name in k) / 1e3,
            sum(v[1] for k, v in run.items() if name in k))


def perbounce(cs, card: str, here: str) -> None:
    """The ``perbounce`` part (the module's docstring)."""
    import dataclasses
    import functools
    import inspect
    import time

    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.scene.parser import load_scene

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    seed = key_to_seed(prng_key(0))
    # a checkout whose kernel 3s orders its lanes takes `ordered`
    ordered_k3 = "ordered" in inspect.signature(bounce_grad.bounce_bwd_cuda).parameters
    k2 = bounce_fused.bounce_fused_cuda
    k3 = bounce_grad.bounce_bwd_cuda

    def desc_of(name, res=None):
        desc = load_scene(os.path.join("scenes", name))
        return dataclasses.replace(desc, resolution=res) if res else desc

    # ---- kernel 2 over the pinned 8-spp render, and at super-step 10
    scene = desc_of("cornell.txt").scene_for_frame(0, device=dev)
    pinned = RenderConfig(wavefront=True, iters_per_launch=8, max_depth=8, nee=True)
    render(scene, 8, pinned, device=dev)
    torch.cuda.synchronize()
    for rep in range(2):
        run, wall = cs.profiled(lambda: render(scene, 8, pinned, device=dev))
        ms, n = _device_sum(run, "bounce_kernel")
        busy = sum(v[0] for v in run.values()) / 1e3
        print(f"[split] {here} perbounce kernel 2, pinned 8-spp render cornell 800x800, repeat "
              f"{rep}: {ms:.4f} ms of device time in {n} launches ({ms / max(n, 1):.4f} per "
              f"launch); device busy {busy:.4f} ms of {wall:.4f} ms profiled; on {card}",
              flush=True)
    captured = {}
    cs.capturing_render(scene, 8, pinned, dev, captured)
    tables = [t.contiguous() for t in pack_tables(scene)]
    margs = (tables, captured["origin"], captured["direction"], captured["throughput"],
             captured["sample"], captured["depth"], captured["prev"], captured["medium"], seed)
    n = margs[1].shape[0]
    ms = [cs.queued_ms(lambda: k2(*margs, nee=True)) for _ in range(2)]
    print(f"[split] {here} perbounce kernel 2 at super-step {cs.CAPTURE_STEP}, {n} lanes: "
          f"{ms[0]:.4f} / {ms[1]:.4f} ms of device time (queued); on {card}", flush=True)

    # ---- kernel 2's replay variant (2r) at each bounce of the per-bounce
    # scan of Cornell's primary rays, its alive share thinning as paths end
    with torch.no_grad():
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        st = dict(origin=rays.origin, direction=rays.direction,
                  throughput=torch.ones((n, 3), **f32), prev=torch.zeros(n, **f32))
        medium = torch.zeros((n, 4), **f32)
        on = torch.ones(n, dtype=torch.bool, device=dev)
        for dep in range(8):
            depth = torch.full((n,), dep, dtype=torch.int32, device=dev)
            sargs = (tables, st["origin"], st["direction"], st["throughput"], pixel, depth,
                     st["prev"], medium, seed)
            ms = [cs.queued_ms(lambda: k2(*sargs, nee=True, emit_replay=True))
                  for _ in range(2)]
            print(f"[split] {here} perbounce kernel 2r at bounce {dep} of the scan, "
                  f"{int(on.sum())} of {n} lanes alive: {ms[0]:.4f} / {ms[1]:.4f} ms of "
                  f"device time (queued); on {card}", flush=True)
            r = k2(*sargs, nee=True)
            on = on & ~r.terminate
            a = on[:, None]
            st = dict(origin=torch.where(a, r.next_origin, st["origin"]),
                      direction=torch.where(a, r.next_direction, st["direction"]),
                      throughput=torch.where(a, st["throughput"] * r.throughput_mult,
                                             st["throughput"]),
                      prev=r.was_specular)

    # ---- the per-bounce steps, kernel 3 ordered and (where the checkout
    # has it) in index order
    base = RenderConfig(wavefront=False, nee=True, max_depth=8, grad_full_trace=False)
    for label, name, res in (("3", "cornell.txt", None), ("3v", "milky.txt", None),
                             ("3s", "ward.txt", (512, 512))):
        k3_variants = [("as is", {})]
        if ordered_k3 and label == "3s":
            k3_variants.append(("index order", dict(ordered=False)))
        params, static = diff.params_from_description(desc_of(name, res), 0, device=dev)
        target = torch.zeros((static.resolution[0] * static.resolution[1], 3), **f32)
        for vlabel, kw in k3_variants:
            bounce_grad.bounce_bwd_cuda = functools.partial(k3, **kw)
            try:
                def step():
                    return diff.loss_and_grad_rays(params, static, target, 4, prng_key(0), base,
                                                   device=dev)

                step()
                torch.cuda.synchronize()
                walls = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                wall = sorted(walls)[len(walls) // 2]
                for rep in range(2):
                    run, _ = cs.profiled(step)
                    busy = sum(v[0] for v in run.values()) / 1e3
                    r2, n2 = _device_sum(run, "bounce_kernel")
                    b3, n3 = _device_sum(run, "bounce_bwd_kernel")
                    rs, nrs = _device_sum(run, "row_sum")
                    lo, nlo = _device_sum(run, "lane_order")
                    print(f"[split] {here} perbounce step {label} {vlabel} {name} 4 spp, repeat "
                          f"{rep}: median {wall:.4f} ms of "
                          + " / ".join(f"{t:.4f}" for t in walls) + f" ms; device busy "
                          f"{busy:.4f} ms, idle share {1 - busy / wall:.3f}; 2r {r2:.4f} ms in "
                          f"{n2} launches; kernel {label} body {b3 / max(n3, 1):.4f} ms x {n3}, "
                          f"row sum {rs / max(nrs, 1):.4f} ms x {nrs}, lane order "
                          f"{lo / max(n3, 1):.4f} ms per launch ({nlo} kernels); on {card}",
                          flush=True)
            finally:
                bounce_grad.bounce_bwd_cuda = k3

        # ---- isolated, on the state after two bounces with the engine's cotangents
        with torch.no_grad():
            scn = diff.build_scene(params, static)
            tabs = [t.contiguous() for t in pack_tables(scn)]
            feats = frozenset(resolve_features(base, params.materials).features)
            w, h = static.resolution
            n = w * h
            lanes = torch.arange(n, dtype=torch.int64, device=dev)
            rays = generate_camera_rays(scn.camera, lanes, camera_uniforms(seed, lanes))
            medium = torch.zeros((n, 4), **f32)
            st = dict(origin=rays.origin, direction=rays.direction,
                      throughput=torch.ones((n, 3), **f32), prev=torch.zeros(n, **f32),
                      medium=medium)
            on = torch.ones(n, dtype=torch.bool, device=dev)
            for dep in range(2):
                r = k2(tabs, st["origin"], st["direction"], st["throughput"], lanes, dep,
                       st["prev"], st["medium"], seed, nee=True, features=feats)
                on = on & ~r.terminate
                a = on[:, None]
                st = dict(origin=torch.where(a, r.next_origin, st["origin"]),
                          direction=torch.where(a, r.next_direction, st["direction"]),
                          throughput=torch.where(a, st["throughput"] * r.throughput_mult,
                                                 st["throughput"]),
                          prev=r.was_specular,
                          medium=r.next_medium if "volumetric" in feats else medium)
            args2 = (tabs, st["origin"], st["direction"], st["throughput"], lanes, 2, st["prev"])
            _, rgid, rnee = k2(*args2, st["medium"], seed, emit_replay=True, nee=True,
                               features=feats)
            rng = np.random.default_rng(0)
            a = on[:, None]
            cots = [torch.where(a, torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev), 0.0) for _ in range(4)]
            bkw = dict(nee=True, features=feats)
            if "volumetric" in feats:
                g_med = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).to(dev)
                bkw.update(medium=st["medium"], g_medium=torch.where(a, g_med, 0.0))
            bargs = (*args2, rgid, rnee, *cots, seed)
            for vlabel, kw in k3_variants:
                for rep in range(2):
                    body, rsum, per, order = _profiled_split(
                        cs, lambda: k3(*bargs, **bkw, **kw), "bounce_bwd_kernel", n)
                    print(f"[split] {here} perbounce isolated {label} {vlabel} {name} after two "
                          f"bounces, {int(on.sum())} of {n} lanes alive, repeat {rep}: body "
                          f"{body:.4f} ms, row sum {rsum:.4f} ms ({per:g} launches), lane order "
                          f"{order:.4f} ms; on {card}", flush=True)


def rows(cs, card: str, here: str) -> None:
    """The ``rows`` part (the module's docstring)."""
    import dataclasses

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.scene.structs import Rays

    dev = torch.device("cuda")
    seed = key_to_seed(prng_key(0))
    for label, name, spp, res in (("2v", "sss", 2, (512, 512)), ("2hg", "sss", 2, (512, 512)),
                                  ("2m", "smooth_mesh", 2, (512, 512)),
                                  ("2s", "ward", 2, (512, 512)),
                                  ("2t", "textured_image", 2, (512, 512)),
                                  ("2", "cornell", 8, None)):
        desc = load_scene(os.path.join("scenes", f"{name}.txt"))
        desc = dataclasses.replace(desc, resolution=res) if res else desc
        scene = desc.scene_for_frame(0, device=dev)
        cfg = RenderConfig(wavefront=True, iters_per_launch=spp, max_depth=8, nee=True)
        feats = resolve_features(cfg, scene.materials).features
        if label == "2v":
            feats = tuple(f for f in feats if f != "hg")
        captured = {}
        cs.capturing_render(scene, spp, cfg, dev, captured)
        tables = [t.contiguous() for t in pack_tables(scene)]
        medium = captured["medium"]
        if label == "2v":
            medium = medium[:, :4].contiguous()
        margs = (tables, captured["origin"], captured["direction"], captured["throughput"],
                 captured["sample"], captured["depth"], captured["prev"], medium, seed)
        kw = dict(nee=True, features=frozenset(feats), tex_defer=scene.textures is not None,
                  mesh=scene.mesh_tables)
        ms = [cs.queued_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, **kw))
              for _ in range(2)]
        print(f"[split] {here} rows kernel {label} {name} super-step {cs.CAPTURE_STEP} "
              f"({margs[1].shape[0]} lanes): {ms[0]:.4f} / {ms[1]:.4f} ms of device time "
              f"(queued); on {card}", flush=True)
        if label == "2":
            rays = Rays(captured["origin"], captured["direction"])
            for klabel, fn in (("6", intersect_cuda.nearest_hit_cuda),
                               ("7", intersect_cuda.winner_t_gid_cuda),
                               ("8", intersect_cuda.occlusion_t_cuda)):
                ms = [cs.queued_ms(lambda: fn(rays, tables[0])) for _ in range(2)]
                print(f"[split] {here} rows kernel {klabel} {name} super-step "
                      f"{cs.CAPTURE_STEP} ({margs[1].shape[0]} lanes): {ms[0]:.4f} / "
                      f"{ms[1]:.4f} ms of device time (queued); on {card}", flush=True)


ISECT_KERNELS = ("nearest_kernel", "winner_kernel", "occlusion_kernel")  # kernels 6, 7, 8
LEAN_LAUNCHES = (0, 3, 7)  # the lean step's kernel-7 launches whose rays the intersect part keeps
# SASS opcodes by the unit or kind of work they are, for the intersect part's counts
SASS_CLASSES = (
    ("fp32 add/mul/fma", ("FADD", "FMUL", "FFMA")),
    ("fp32 compare/select/min-max", ("FSETP", "FSEL", "FMNMX", "FSET", "FCHK")),
    ("mufu", ("MUFU",)),
    ("shared loads", ("LDS",)),
    ("constant loads", ("LDC", "ULDC")),
    ("global loads", ("LDG",)),
    ("global stores", ("STG",)),
    ("branches and calls", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC", "BREAK", "EXIT")),
)


def sass_functions(listing: str) -> dict:
    """``cuobjdump -sass`` output cut into ``{function: [(address, opcode,
    text)]}``; a branch's label target (``.L_x_N``) is turned into the
    address of the instruction that follows the label."""
    import re

    funcs, labels, name = {}, {}, None
    pending = []
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and name is not None:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", line)
        if m and name is not None:
            addr, text = int(m.group(1), 16), m.group(2)
            for label in pending:
                labels[name][label] = addr
            pending = []
            words = text.split()
            op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            funcs[name].append((addr, op.split(".")[0], text))
    for name, insts in funcs.items():
        funcs[name] = [(a, op, re.sub(r"`\((\.L_x_\d+)\)",
                                      lambda m: hex(labels[name].get(m.group(1), -1)), text))
                       for a, op, text in insts]
    return funcs


def sass_loop(insts) -> tuple:
    """The address range of a function's loop that holds the most MUFU
    instructions (the geom sweep, with its reciprocals and square roots):
    ``(first, last)`` of a backward branch's target and the branch, or None
    where no backward branch holds one."""
    import re

    best, best_mufu = None, 0
    for addr, op, text in insts:
        m = re.search(r"BRA\S*\s+(?:\S+,\s*)?(0x[0-9a-f]+)", text)
        if op != "BRA" or m is None or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        mufu = sum(1 for a, o, _ in insts if lo <= a <= addr and o == "MUFU")
        if mufu > best_mufu:
            best, best_mufu = (lo, addr), mufu
    return best


def sass_counts(insts) -> dict:
    """Instructions by :data:`SASS_CLASSES` (``"other"``: integer, moves,
    predicates), and ``"all"``."""
    out = {label: 0 for label, _ in SASS_CLASSES}
    out["other"] = 0
    for _, op, _ in insts:
        label = next((lb for lb, ops in SASS_CLASSES if op in ops), "other")
        out[label] += 1
    out["all"] = len(insts)
    return out


def intersect(cs, card: str, here: str, listing_dir: str = "") -> None:
    """The ``intersect`` part (the module's docstring)."""
    import collections
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import _build, intersect_cuda
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.intersect import nearest_hit_plain, winner_t_gid_plain
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.scene.structs import Rays

    with ThreadPoolExecutor(5) as pool:  # what the captures and the lean steps launch
        list(pool.map(_build.load, ("intersect", "bounce", "trace_grad", "trace", "mesh")))
    dev = torch.device("cuda")
    desc = load_scene(os.path.join("scenes", "cornell.txt"))
    scene = desc.scene_for_frame(0, device=dev)
    captured = {}
    cs.capturing_render(scene, 8, RenderConfig(wavefront=True, iters_per_launch=8, max_depth=8,
                                               nee=True), dev, captured)
    gtab = pack_tables(scene)[0].contiguous()
    # a one-row table whose geom is a mesh slot (type 2): the analytic sweep
    # skips it, so a launch on it loads the rays and stores every output
    # with no sweep (the kernel's planes-only floor)
    slot = gtab[:1].clone()
    slot[0, 12] = 2.0
    rays = Rays(captured["origin"], captured["direction"])
    n = rays.origin.shape[0]
    got, want = intersect_cuda.nearest_hit_cuda(rays, gtab), nearest_hit_plain(rays, gtab)
    wt, wg = intersect_cuda.winner_t_gid_cuda(rays, gtab)
    pt, pg = winner_t_gid_plain(rays, gtab)
    same = all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("t", "hit", "geom_id", "material_id"))
    frame = torch.ones(n, dtype=torch.bool, device=dev)
    for f in ("position", "position_obj", "normal"):
        frame &= (getattr(got, f) == getattr(want, f)).all(-1)
    print(f"[split] {here} intersect check: kernel 6 t / hit / gid / mid equal to plain {same}, "
          f"frame bit-equal on {float(frame.double().mean()):.6f} of lanes; kernel 7 t / gid "
          f"equal {torch.equal(wt, pt)} / {torch.equal(wg, pg)}; on {card}", flush=True)
    for label, fn, name in zip("678", (intersect_cuda.nearest_hit_cuda,
                                        intersect_cuda.winner_t_gid_cuda,
                                        intersect_cuda.occlusion_t_cuda), ISECT_KERNELS):
        whole = [cs.queued_ms(lambda: fn(rays, gtab)) for _ in range(2)]
        planes = [cs.queued_ms(lambda: fn(rays, slot)) for _ in range(2)]
        alone = []
        for table in (gtab, slot):
            run, _ = cs.profiled(lambda: fn(rays, table), 10)
            ms, launches = _device_sum(run, name)
            alone.append(f"{ms / max(launches, 1):.4f} x {launches}")
        print(f"[split] {here} intersect kernel {label} cornell super-step {cs.CAPTURE_STEP} "
              f"({n} lanes, {gtab.shape[0]} geoms): {whole[0]:.4f} / {whole[1]:.4f} ms of "
              f"device time (queued, the wrapper's call); planes only {planes[0]:.4f} / "
              f"{planes[1]:.4f}; the kernel alone (profiled over 10 calls) {alone[0]}, planes "
              f"only {alone[1]}; on {card}", flush=True)

    # kernel 7 where the lean step launches it: one 1-spp step on Cornell
    params, static = diff.params_from_description(desc, 0, device=dev)
    target = torch.zeros((static.resolution[0] * static.resolution[1], 3), device=dev)
    kept, sizes = {}, []
    winner = intersect_cuda.winner_t_gid_cuda

    def recording(r, g):
        if len(sizes) in LEAN_LAUNCHES:
            kept[len(sizes)] = (Rays(r.origin.clone(), r.direction.clone()), g.clone())
        sizes.append(r.origin.shape[0])
        return winner(r, g)

    intersect_cuda.winner_t_gid_cuda = recording
    try:
        diff.loss_and_grad_rays(params, static, target, 1, prng_key(0),
                                RenderConfig(grad_fused=False, nee=True, max_depth=8),
                                device=dev)
        torch.cuda.synchronize()
    finally:
        intersect_cuda.winner_t_gid_cuda = winner
    for k, (r, g) in sorted(kept.items()):
        ms = [cs.queued_ms(lambda: winner(r, g)) for _ in range(2)]
        print(f"[split] {here} intersect kernel 7 lean step launch {k} of {len(sizes)} "
              f"({r.origin.shape[0]} lanes; sizes {sorted(set(sizes))}): {ms[0]:.4f} / "
              f"{ms[1]:.4f} ms of device time (queued); on {card}", flush=True)

    occlusion_part(cs, card, here, dev, rays, gtab)

    # registers and the SASS of the built library
    lib = _build.compile_kernel("intersect")[0]
    tool = os.path.join(os.path.dirname(os.path.dirname(_build.nvcc_path())), "bin",
                        "cuobjdump")
    tool = tool if os.path.exists(tool) else "cuobjdump"
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True).stdout
    lines = res.splitlines()
    for i, line in enumerate(lines):
        name = next((k for k in ISECT_KERNELS if k in line), None)
        if name and i + 1 < len(lines):
            print(f"[split] {here} intersect resources {name}: {lines[i + 1].strip()}",
                  flush=True)
    listing = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    if listing_dir:
        os.makedirs(listing_dir, exist_ok=True)
        with open(os.path.join(listing_dir, f"intersect_sass_{here}.txt"), "w") as f:
            f.write(listing)
    for fname, insts in sass_functions(listing).items():
        name = next((k for k in ISECT_KERNELS if k in fname), None)
        if name is None:
            continue
        loop = sass_loop(insts)
        body = [x for x in insts if loop and loop[0] <= x[0] <= loop[1]]
        ops = collections.Counter(op for _, op, _ in body)
        print(f"[split] {here} intersect sass {name}: {sass_counts(insts)} in the kernel; geom "
              f"loop {'none' if loop is None else f'0x{loop[0]:x}-0x{loop[1]:x}'}: "
              f"{sass_counts(body)}; opcodes {dict(ops.most_common())}", flush=True)


def cull_model():
    """``tools/occlusion_cull.py`` of the checkout that holds this tool,
    loaded apart, so that its cull counts on the rays of any checkout, one
    that predates it too."""
    import importlib.util

    path = os.path.join(ROOT, "pathtracer_tpu_torch", "tools", "occlusion_cull.py")
    spec = importlib.util.spec_from_file_location("_occlusion_cull", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def warp_share(need, pairs: bool = False) -> float:
    """The share of (warp, geom) pairs whose test a warp runs, where any of
    its lanes needs it (``need`` ``[N, G]``).  A warp holds 32 consecutive
    lanes, or with ``pairs`` the 64 lanes of 32 threads of two rays each
    (kernels 6 and 7's shape: thread t of a block of 128 takes lanes t and
    t + 128 of its span of 256)."""
    import torch

    n, g = need.shape
    span = 256 if pairs else 32
    pad = (-n) % span
    if pad:
        need = torch.cat([need, need.new_zeros((pad, g))])
    if not pairs:
        return float(need.view(-1, 32, g).any(1).double().mean())
    # [spans, 2 halves, 4 warps, 32 lanes, G] -> a warp's two halves together
    return float(need.view(-1, 2, 4, 32, g).any(3).any(1).double().mean())


def cull_counts(rays, gtab) -> str:
    """The share of kernel 8's exact tests (spheres and cubes, lanes times
    geoms) that remain under the padded world-box cull, per lane, per warp
    of 32 lanes and per warp of 64 (two rays a thread), and with a geom also
    skipped where its box starts beyond the ray's running minimum, in index
    order and smallest box (surface area) first; with the sane share of
    lanes."""
    import torch

    from pathtracer_tpu_torch.ops.intersect import BIG, T_MIN, geom_t

    mod = cull_model()
    boxes, r0 = mod.cull_boxes(gtab)
    enters, t_near, sane = mod.box_entries(rays, boxes, r0)
    analytic = ((gtab[:, 12] == 0.0) | (gtab[:, 12] == 1.0)).to(enters.device)
    need = enters & analytic[None, :]
    ga = int(analytic.sum())
    per = need.shape[1] / ga  # the shares over analytic geoms
    lane = float(need.double().mean()) * per
    w32, w64 = warp_share(need) * per, warp_share(need, pairs=True) * per
    # ordered: skip a geom whose box starts beyond the minimum found so far
    o, d = rays.origin.float(), rays.direction.float()
    comp = (o.unbind(-1), d.unbind(-1))
    ext = (boxes[:, 3:] - boxes[:, :3]).double()
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    shares = []
    for order in (range(gtab.shape[0]), torch.argsort(area.cpu(), stable=True).tolist()):
        best = torch.full((o.shape[0],), BIG, device=o.device)
        ordered = torch.zeros_like(need)
        for g in order:
            if not bool(analytic[g]):
                continue
            run = need[:, g] & ((t_near[:, g] <= best) | ~sane)
            ordered[:, g] = run
            t_g = geom_t(gtab[g], *comp[0], *comp[1], T_MIN, float(gtab[g, 12]))[0]
            best = torch.where(run, torch.minimum(best, t_g), best)
        shares.append((float(ordered.double().mean()) * per, warp_share(ordered) * per))
    return (f"{ga} analytic geoms, tests left per lane {lane:.4f} ({lane * ga:.3f} a lane), per "
            f"warp of 32 {w32:.4f} ({w32 * ga:.3f}), per warp of 64 {w64:.4f} "
            f"({w64 * ga:.3f}); with the running minimum per lane / warp in index order "
            f"{shares[0][0]:.4f} / {shares[0][1]:.4f}, smallest box first {shares[1][0]:.4f} / "
            f"{shares[1][1]:.4f}; sane lanes {float(sane.double().mean()):.6f}, r0 {r0:.4f}")


SHADOW_SPLIT_LAUNCHES = (0, 3, 7, 10)  # the split render's kernel-8 launches the part keeps
SHADOW_LEAN_LAUNCH = 3  # the lean steps' kernel-8 launch the part keeps
SHADOW_RES = (512, 512)  # the lean steps' scenes (sss, smooth_mesh), chip_smoke.py's widths


def capture_shadow(cs, dev) -> tuple:
    """Kernel 8's inputs where the routes launch it: ``({label: (rays,
    gtab)}, the split render's launches)``: launches
    :data:`SHADOW_SPLIT_LAUNCHES` of Cornell's 2-spp split render (800x800,
    pinned, depth 8, NEE) and launch :data:`SHADOW_LEAN_LAUNCH` of a 1-spp
    lean step on sss and on smooth_mesh (512x512)."""
    import dataclasses

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.scene.structs import Rays

    occ = intersect_cuda.occlusion_t_cuda
    kept, calls, keep = {}, [], {}

    def recording(r, g):
        if len(calls) in keep:
            kept[keep[len(calls)]] = (Rays(r.origin.clone(), r.direction.clone()), g.clone())
        calls.append(r.origin.shape[0])
        return occ(r, g)

    intersect_cuda.occlusion_t_cuda = recording
    try:
        keep.update({k: f"cornell split launch {k}" for k in SHADOW_SPLIT_LAUNCHES})
        scene = load_scene(os.path.join("scenes", "cornell.txt")).scene_for_frame(0, device=dev)
        split = RenderConfig(wavefront=True, fused=False, iters_per_launch=2, max_depth=8,
                             nee=True)
        cs.counted_render(scene, 2, split, dev)
        split_launches = len(calls)
        for name in ("sss", "smooth_mesh"):
            calls.clear()
            keep.clear()
            keep[SHADOW_LEAN_LAUNCH] = f"{name} lean launch {SHADOW_LEAN_LAUNCH}"
            desc = dataclasses.replace(load_scene(os.path.join("scenes", f"{name}.txt")),
                                       resolution=SHADOW_RES)
            params, static = diff.params_from_description(desc, 0, device=dev)
            target = torch.zeros((SHADOW_RES[0] * SHADOW_RES[1], 3), device=dev)
            diff.loss_and_grad_rays(params, static, target, 1, prng_key(0),
                                    RenderConfig(grad_fused=False, nee=True, max_depth=8),
                                    device=dev)
            torch.cuda.synchronize()
    finally:
        intersect_cuda.occlusion_t_cuda = occ
    return kept, split_launches


def occlusion_part(cs, card: str, here: str, dev, usual, gtab) -> None:
    """The intersect part's kernel 8 lines: on the usual lanes (Cornell's
    super-step 10 bounce rays, ``usual``) and on the shadow rays of
    :func:`capture_shadow`, kernel 8 checked equal to plain, its device time
    as the wrapper's call (queued, twice) and alone (the profiler over 10
    calls), and :func:`cull_counts`; then the split route's 2-spp render:
    wall time (five repeats) and, from two profiles, its device busy time
    per super-step and kernel 8's total."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import occlusion_t_plain
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.scene.parser import load_scene

    shadow, launches = capture_shadow(cs, dev)
    cases = {f"cornell super-step {cs.CAPTURE_STEP} (bounce rays)": (usual, gtab), **shadow}
    fn = intersect_cuda.occlusion_t_cuda
    for label, (r, g) in cases.items():
        same = torch.equal(fn(r, g), occlusion_t_plain(r, g))
        call = [cs.queued_ms(lambda: fn(r, g)) for _ in range(2)]
        run, _ = cs.profiled(lambda: fn(r, g), 10)
        ms, n_alone = _device_sum(run, "occlusion_kernel")
        print(f"[split] {here} occlusion kernel 8 {label} ({r.origin.shape[0]} lanes, "
              f"{g.shape[0]} geoms): equal to plain {same}; call {call[0]:.4f} / {call[1]:.4f} "
              f"ms (queued), alone {ms / max(n_alone, 1):.4f} x {n_alone} (profiler); cull: "
              f"{cull_counts(r, g)}; on {card}", flush=True)

    scene = load_scene(os.path.join("scenes", "cornell.txt")).scene_for_frame(0, device=dev)
    split = RenderConfig(wavefront=True, fused=False, iters_per_launch=2, max_depth=8, nee=True)
    walls = [cs.counted_render(scene, 2, split, dev)[5] * 1e3 for _ in range(5)]
    busy = []
    for _ in range(2):
        wavefront.super_steps = 0
        run, _ = cs.profiled(lambda: render(scene, 2, split, device=dev))
        steps = wavefront.super_steps
        k8, n8 = _device_sum(run, "occlusion_kernel")
        busy.append(f"busy {sum(v[0] for v in run.values()) / 1e3 / steps:.4f} ms per "
                    f"super-step of {steps}, kernel 8 {k8:.4f} ms over {n8}")
    print(f"[split] {here} occlusion split route cornell 2 spp ({launches} kernel-8 launches): "
          f"wall {' '.join(f'{w:.2f}' for w in sorted(walls))} ms; {'; '.join(busy)}; "
          f"on {card}", flush=True)


def chunk_reach(km, gtab, origin, direction):
    """``[N, C]`` bool: lane i's ray reaches chunk c's box with nothing
    nearer found yet (``csrc/trace_common.cuh:chunk_reaches`` at ``best =
    BIG``), each mesh's chunks in its geom's object space.  A lane that
    reaches no chunk tests no triangle in the nearest-hit sweep."""
    import torch

    from pathtracer_tpu_torch.ops.intersect import BIG, safe_recip, to_object
    from pathtracer_tpu_torch.ops.mesh_tables import chunk_reaches

    boxes = km.aabb.view(-1, 6)
    cols = []
    for g, n_chunks, first, _, _ in km.descs:
        obj = to_object(gtab[g].unbind(-1), *origin.unbind(-1), *direction.unbind(-1))
        oo, inv = obj[:3], tuple(safe_recip(c) for c in obj[3:])
        big = torch.full_like(oo[0], BIG)
        cols += [chunk_reaches(boxes[c].unbind(-1), oo, inv, big)
                 for c in range(first, first + n_chunks)]
    return torch.stack(cols, dim=-1)


def warp_chunks(reach, order=None) -> float:
    """The mean over warps (32 consecutive lanes, or 32 consecutive entries
    of ``order``) of the chunks that some lane of the warp reaches: the
    chunks a warp sweeps together."""
    import torch

    if order is not None:
        reach = reach[order]
    pad = (-reach.shape[0]) % 32
    if pad:
        reach = torch.cat([reach, reach.new_zeros((pad, reach.shape[1]))])
    return float(reach.view(-1, 32, reach.shape[1]).any(1).sum(-1).double().mean())


def live_shares(alive) -> dict:
    """The live share of the thread-bounces that warps run, from the alive
    plane of every bounce (``[depth, N]`` bool): ``"index"``, one path per
    thread (a warp runs a bounce while one of its 32 lanes lives), and per
    block size b of 128 and 256, its live paths packed into its first
    ceil(live / 32) warps."""
    import torch

    depth, n = alive.shape
    pad = torch.nn.functional.pad(alive, (0, (-n) % 256))
    live = int(alive.sum())
    out = {"index": live / (int(pad.view(depth, -1, 32).any(-1).sum()) * 32)}
    for b in (128, 256):
        warps = -(-pad.view(depth, -1, b).sum(-1) // 32)
        out[b] = live / (int(warps.sum()) * 32)
    return out


def mesh_bounce(cs, card: str, here: str) -> None:
    """The ``2m`` part (the module's docstring)."""
    import dataclasses

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
    from pathtracer_tpu_torch.scene.variants import grid_obj, textured_mesh_scene

    dev = torch.device("cuda")
    seed = key_to_seed(prng_key(0))
    grid = os.path.join(ROOT, "build", "kernel_split", f"grid{GRID_CELLS}.obj")
    os.makedirs(os.path.dirname(grid), exist_ok=True)
    with open(grid, "w") as f:
        f.write(grid_obj(GRID_CELLS))
    for label, name in (("2m", "smooth_mesh"), ("2mt", f"vt grid {GRID_CELLS}")):
        if label == "2m":
            desc = load_scene(os.path.join("scenes", "smooth_mesh.txt"))
        else:
            desc = parse_scene_text(textured_mesh_scene(grid), name="vt_grid",
                                    scene_dir="scenes")
        desc = dataclasses.replace(desc, resolution=(512, 512))
        scene = desc.scene_for_frame(0, device=dev)
        km = scene.mesh_tables
        cfg = RenderConfig(wavefront=True, iters_per_launch=2, max_depth=8, nee=True)
        captured = {}
        cs.capturing_render(scene, 2, cfg, dev, captured)
        tables = [t.contiguous() for t in pack_tables(scene)]
        margs = (tables, captured["origin"], captured["direction"], captured["throughput"],
                 captured["sample"], captured["depth"], captured["prev"],
                 captured["medium"].contiguous(), seed)
        feats = frozenset(resolve_features(cfg, scene.materials).features)
        kw = dict(nee=True, features=feats, tex_defer=scene.textures is not None, mesh=km)
        n = margs[1].shape[0]

        def launch(**extra):
            return bounce_fused.bounce_fused_cuda(*margs, **{**kw, **extra})

        ms = [cs.queued_ms(launch) for _ in range(2)]
        run, _ = cs.profiled(launch, 10)
        body, nb = _device_sum(run, "bounce_kernel")
        bare = cs.queued_ms(lambda: launch(mesh=None))
        reach = chunk_reach(km, tables[0], margs[1], margs[2])
        lanes = reach.any(-1)
        warps = float(torch.nn.functional.pad(lanes, (0, (-n) % 32)).view(-1, 32).any(-1)
                      .double().mean())
        first = torch.where(lanes, reach.int().argmax(-1) + 1, 0)
        by_first = torch.sort(first, stable=True).indices
        print(f"[split] {here} 2m kernel {label} {name} super-step {cs.CAPTURE_STEP} ({n} lanes, "
              f"{reach.shape[1]} chunks): {ms[0]:.4f} / {ms[1]:.4f} ms of device time (queued; "
              f"without the meshes {bare:.4f}); profiled: {body / max(nb, 1):.4f} ms x {nb}; "
              f"lanes whose ray reaches a chunk {float(lanes.double().mean()):.4f}, warps "
              f"{warps:.4f}; chunks per lane {float(reach.sum(-1).double().mean()):.3f}, "
              f"per warp in index order {warp_chunks(reach):.3f}, ordered by first chunk "
              f"{warp_chunks(reach, by_first):.3f}; on {card}", flush=True)


def path_packing(cs, card: str, here: str) -> None:
    """The ``packing`` part (the module's docstring)."""
    import dataclasses

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene

    dev = torch.device("cuda")
    seed = key_to_seed(prng_key(0))
    base = RenderConfig(wavefront=False, nee=True, max_depth=8)
    for label, name, res in PACKING_CASES:
        desc = load_scene(os.path.join("scenes", f"{name}.txt"))
        desc = dataclasses.replace(desc, resolution=res) if res else desc
        scene = desc.scene_for_frame(0, device=dev)
        feats = frozenset(resolve_features(base, scene.materials).features)
        tables = [t.contiguous() for t in pack_tables(scene)]
        n = scene.camera.width * scene.camera.height
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        fargs = (*tables, seed, rays.origin, rays.direction, pixel)
        fkw = dict(max_depth=8, nee=True, rr=False, rr_start=3, features=feats)

        def launch():
            return trace_grad.tfwd_cuda(*fargs, **fkw)

        _, nrays, resid = launch()
        ms = [cs.queued_ms(launch) for _ in range(2)]
        alive = resid[:, resid.shape[1] - 3] > 0.5  # [depth, N]: the alive plane
        del resid
        share = live_shares(alive)
        print(f"[split] {here} packing kernel {label} {name} {n} lanes: {ms[0]:.4f} / "
              f"{ms[1]:.4f} ms of device time (queued); {int(nrays) / n / 2:.4f} bounces per "
              f"lane of 8; live lanes per bounce " + " ".join(
                  f"{float(x) / n:.4f}" for x in alive.sum(-1))
              + f"; live share of the warps' thread-bounces: index order "
              f"{share['index']:.4f}, packed in blocks of 128 {share[128]:.4f}, of 256 "
              f"{share[256]:.4f}; on {card}", flush=True)


def measure(card: str, parts: str = ",".join(DEFAULT_PARTS), listing_dir: str = "") -> None:
    """In a checkout: print its ``[split]`` lines for the comma-separated
    ``parts`` (the module's docstring); ``listing_dir``: where the
    intersect part writes its SASS listing."""
    import dataclasses
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import _build, bounce_fused, bounce_grad, trace, trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene

    parts = parts.split(",")
    if parts == ["intersect"]:  # builds only what it launches
        intersect(cs, card, os.path.basename(os.getcwd()), listing_dir)
        return
    reports = _build.build_all()
    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    seed = key_to_seed(prng_key(0))
    rng = np.random.default_rng(0)
    base = RenderConfig(wavefront=False, nee=True, max_depth=8)
    here = os.path.basename(os.getcwd())

    def desc_of(name, res):
        desc = load_scene(os.path.join("scenes", name))
        return dataclasses.replace(desc, resolution=res) if res else desc

    def timed(fn, reps=5):
        # host-clock ms of each call ending in a synchronize, and until it returned
        fn()
        torch.cuda.synchronize()
        walls, hosts = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            hosts.append((t1 - t0) * 1e3)
        return walls, hosts

    for label, name, res in ADJOINT_SCENES if "adjoint" in parts else ():
        desc = desc_of(name, res)
        params, static = diff.params_from_description(desc, 0, device=dev)
        feats = frozenset(resolve_features(base, params.materials).features)
        with torch.no_grad():
            scene = diff.build_scene(params, static)
            tables = [t.contiguous() for t in pack_tables(scene)]
            w, h = static.resolution
            n = w * h
            lanes = torch.arange(n, dtype=torch.int64, device=dev)
            rays = generate_camera_rays(scene.camera, lanes, camera_uniforms(seed, lanes))
            medium = torch.zeros((n, 4), **f32)
            st = dict(origin=rays.origin, direction=rays.direction,
                      throughput=torch.ones((n, 3), **f32),
                      depth=torch.zeros(n, dtype=torch.int32, device=dev),
                      prev=torch.zeros(n, **f32), medium=medium)
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            for dep in range(2):
                r = bounce_fused.bounce_fused_cuda(
                    tables, st["origin"], st["direction"], st["throughput"], lanes, dep,
                    st["prev"], st["medium"], seed, nee=True, features=feats)
                alive = alive & ~r.terminate
                a = alive[:, None]
                st = dict(origin=torch.where(a, r.next_origin, st["origin"]),
                          direction=torch.where(a, r.next_direction, st["direction"]),
                          throughput=torch.where(a, st["throughput"] * r.throughput_mult,
                                                 st["throughput"]),
                          depth=torch.full((n,), dep + 1, dtype=torch.int32, device=dev),
                          prev=r.was_specular,
                          medium=r.next_medium if "volumetric" in feats else medium)
            args2 = (tables, st["origin"], st["direction"], st["throughput"], lanes,
                     st["depth"], st["prev"])
            _, rgid, rnee = bounce_fused.bounce_fused_cuda(*args2, st["medium"], seed,
                                                           emit_replay=True, nee=True,
                                                           features=feats)
            cots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                    for _ in range(4)]
            bkw = dict(nee=True, features=feats)
            if "volumetric" in feats:
                g_med = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).to(dev)
                bkw.update(medium=st["medium"], g_medium=g_med)
            b2 = (*args2, rgid, rnee, *cots, seed)
            kw = dict(max_depth=8, nee=True, rr=False, rr_start=base.rr_start, features=feats)
            _, _, resid = trace_grad.tfwd_cuda(*tables, seed, rays.origin, rays.direction,
                                               lanes, **kw)
            g_rad = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
            b5 = (*tables, seed, lanes, resid, g_rad)
            for rep in range(2):
                body, rsum, rlaunch, _ = _profiled_split(
                    cs, lambda: bounce_grad.bounce_bwd_cuda(*b2, **bkw), "bounce_bwd_kernel", n)
                b5_ms, r5_ms, r5_launch, o5_ms = _profiled_split(
                    cs, lambda: trace_grad.tbwd_cuda(*b5, **kw), "trace_bwd_kernel", n)
                print(f"[split] {here} adjoint {label} {name} {n} lanes, repeat {rep}: body "
                      f"{body:.4f} ms, row sum {rsum:.4f} ms ({rlaunch:g} launches); kernel "
                      f"{label.replace('3', '5')} body {b5_ms:.4f} ms, row sum {r5_ms:.4f} ms "
                      f"({r5_launch:g} launches), lane order {o5_ms:.4f} ms; on {card}",
                      flush=True)
            del resid, b5, b2

    if "forward" in parts:
        # ---- kernels 1 and 4 and their instances on an iteration's primary rays
        from pathtracer_tpu_torch.scene.parser import parse_scene_text
        from pathtracer_tpu_torch.scene.variants import fog_mesh_scene

        for label, kernel, name, res, rr in FORWARD_CASES:
            if name == "fog_mesh_glass":
                desc = parse_scene_text(fog_mesh_scene(True), name=name, scene_dir="scenes")
                desc = dataclasses.replace(desc, resolution=res)
            else:
                desc = desc_of(f"{name}.txt", res)
            scene = desc.scene_for_frame(0, device=dev)
            feats = frozenset(resolve_features(base, scene.materials).features)
            tables = [t.contiguous() for t in pack_tables(scene)]
            n = scene.camera.width * scene.camera.height
            pixel = torch.arange(n, dtype=torch.int64, device=dev)
            rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
            fargs = (*tables, seed, rays.origin, rays.direction, pixel)
            fkw = dict(max_depth=8, nee=True, rr=rr, rr_start=3, features=feats)
            if kernel == 1:
                fkw["mesh"] = scene.mesh_tables

                def launch():
                    return trace.trace_cuda(*fargs, **fkw)
            else:
                def launch():
                    return trace_grad.tfwd_cuda(*fargs, **fkw)
            nrays = int(launch()[1])
            ms = [cs.queued_ms(launch) for _ in range(2)]
            print(f"[split] {here} forward {label} {name} {n} lanes{' rr' if rr else ''}: "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms of device time; {nrays / n / 2:.4f} bounces "
                  f"per lane of 8; on {card}", flush=True)
            if (label, rr) == ("1", False):
                # the main path's iteration around kernel 1: host clock, device busy, idle share
                cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=8)
                rcfg = resolve_features(cfg, scene.materials)
                acc0 = torch.zeros((n, 3), **f32)

                def iteration():
                    return render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables)

                walls, _ = timed(iteration, reps=10)
                wall = sorted(walls)[len(walls) // 2]
                run, _ = cs.profiled(iteration, 3)
                busy = sum(us for us, _ in run.values()) / 1e3 / 3
                print(f"[split] {here} forward iteration cornell 800x800: median {wall:.4f} ms of "
                      + " / ".join(f"{t:.4f}" for t in walls) + f" ms; device busy {busy:.4f} ms, "
                      f"idle share {1 - busy / wall:.3f}; on {card}", flush=True)

    if "1m" in parts:
        # ---- kernel 1m on smooth_mesh's primary rays, and its iteration
        scene = desc_of("smooth_mesh.txt", (512, 512)).scene_for_frame(0, device=dev)
        cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=8)
        mseed = key_to_seed(prng_key(cfg.seed))
        tables = [t.contiguous() for t in pack_tables(scene)]
        n = scene.camera.width * scene.camera.height
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays0 = generate_camera_rays(scene.camera, pixel, camera_uniforms(mseed, pixel))
        targs = (*tables, mseed, rays0.origin, rays0.direction, pixel)
        tkw = dict(max_depth=8, nee=True, rr=False, rr_start=cfg.rr_start,
                   mesh=scene.mesh_tables)
        k1 = [cs.queued_ms(lambda: trace.trace_cuda(*targs, **tkw)) for _ in range(2)]
        print(f"[split] {here} 1m smooth_mesh {n} primary rays: {k1[0]:.4f} / {k1[1]:.4f} ms "
              f"of device time; on {card}", flush=True)
        rcfg = resolve_features(cfg, scene.materials)
        acc0 = torch.zeros((n, 3), **f32)
        it, _ = timed(lambda: render_chunk(scene, acc0, 0, mseed, rcfg, 1, tables=tables))
        print(f"[split] {here} step mesh:time iteration smooth_mesh 512x512: "
              + " / ".join(f"{t:.4f}" for t in it) + f" ms; on {card}", flush=True)

    if "steps" in parts:
        # the gradient steps: per-bounce (kernels 2r and 3) and full-depth
        # (kernels 4 and 5), their time and the adjoint's device time inside them
        for label, name, res in (("grad:perbounce", "cornell.txt", None),
                                 ("grad:vol", "milky.txt", None),
                                 ("grad:surf", "ward.txt", (512, 512))):
            params, static = diff.params_from_description(desc_of(name, res), 0, device=dev)
            target = torch.zeros((static.resolution[0] * static.resolution[1], 3), **f32)
            for engine, scfg, body in (
                    ("per-bounce", dataclasses.replace(base, grad_full_trace=False),
                     "bounce_bwd_kernel"),
                    ("full-depth", base, "trace_bwd_kernel")):
                def step(scfg=scfg):
                    return diff.loss_and_grad_rays(params, static, target, 4, prng_key(0),
                                                   scfg, device=dev)

                walls, hosts = timed(step, reps=10)
                wall = sorted(walls)[len(walls) // 2]
                run, _ = cs.profiled(step)
                busy = sum(us for us, _ in run.values()) / 1e3
                b_us, b_n = (sum(v[j] for k, v in run.items() if body in k) for j in (0, 1))
                r_us, r_n = (sum(v[j] for k, v in run.items() if "row_sum" in k) for j in (0, 1))
                o_us, o_n = (sum(v[j] for k, v in run.items() if "lane_order" in k)
                             for j in (0, 1))
                print(f"[split] {here} step {label} {engine} {name} 4 spp: median {wall:.4f} ms of "
                      + " / ".join(f"{t:.4f}" for t in walls) + f" ms; returned after a median "
                      f"{sorted(hosts)[len(hosts) // 2]:.4f} ms; profiled step: device busy "
                      f"{busy:.4f} ms, idle share {1 - busy / wall:.3f}; device time per launch: "
                      f"body {b_us / 1e3 / max(b_n, 1):.4f} ms x {b_n}, row sum "
                      f"{r_us / 1e3 / max(r_n, 1):.4f} ms x {r_n}, lane order "
                      f"{o_us / 1e3 / max(o_n, 1):.4f} ms x {o_n}; on {card}", flush=True)

    if "perbounce" in parts:
        perbounce(cs, card, here)
    if "rows" in parts:
        rows(cs, card, here)
    if "2m" in parts:
        mesh_bounce(cs, card, here)
    if "packing" in parts:
        path_packing(cs, card, here)
    if "events" in parts:
        events(cs, card, here)
    if "intersect" in parts:
        intersect(cs, card, here, listing_dir)

    inst = cs.ptxas_instances(reports)
    regs = {f"3 vol={v} surf={s}": cs.instance_regs(inst, "bounce_grad", "bounce_bwd_kernel",
                                                     v, s)
            for v in (False, True) for s in (False, True)}
    regs.update({f"2 mesh={m} vol={v} hg={g} surf={s} tex={t}":
                 cs.instance_regs(inst, "bounce", "bounce_kernel", m, v, g, s, t)
                 for m in (False, True) for v, g in ((False, False), (True, False), (True, True))
                 for s, t in ((False, False), (True, False), (True, True))})
    regs["2r-v grouped"] = cs.instance_regs(inst, "bounce", "bounce_kernel_grouped")
    regs.update({f"5 vol={v} surf={s}": cs.instance_regs(inst, "trace_grad", "trace_bwd_kernel",
                                                         v, s)
                 for v in (False, True) for s in (False, True)})
    regs.update({f"1 mesh={m} vol={v} hg={g} surf={s}":
                 cs.instance_regs(inst, "trace", "trace_kernel", m, v, g, s)
                 for m in (False, True) for v, g in ((False, False), (True, False), (True, True))
                 for s in (False, True)})
    # kernel 4's instances without the surface blocks pack their paths
    # (trace_fwd_kernel_packed) where the checkout has that kernel
    packed = any("trace_fwd_kernel_packed" in entry for _, entry in inst)
    regs.update({f"4 vol={v} surf={s}": cs.instance_regs(
        inst, "trace_grad", "trace_fwd_kernel_packed" if packed and not s else "trace_fwd_kernel",
        v, s) for v in (False, True) for s in (False, True)})
    print(f"[split] {here} regs (registers, spill store / load bytes): {regs}", flush=True)


def variant_copy(name: str, src: str = ROOT, tag: str = "") -> str:
    """A copy of the checkout ``src``'s package, scenes and smoke script
    under ``build/kernel_split/<name><tag>`` with ``VARIANTS[name]``'s edits;
    its path."""
    import shutil

    dest = os.path.join(ROOT, "build", "kernel_split", name + tag)
    shutil.rmtree(dest, ignore_errors=True)
    for sub in ("pathtracer_tpu_torch", "scenes"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dest, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(src, "chip_smoke.py"), dest)
    for path, old, new in VARIANTS[name]:
        with open(os.path.join(dest, path)) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {path} holds {src.count(old)} of {old!r}")
        with open(os.path.join(dest, path), "w") as f:
            f.write(src.replace(old, new))
    return dest


def main() -> int:
    from pathtracer_tpu_torch.tools.in_turns import card, run_in_turns

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*",
                    help="NAME=DIR (a checkout), NAME=variant:V (VARIANTS[V] on this checkout) "
                         "or NAME=variant:V@DIR (on the checkout DIR), each in turn")
    ap.add_argument("--parts", default=",".join(DEFAULT_PARTS),
                    help=f"comma-separated, of {', '.join(PARTS)}")
    ap.add_argument("--listing-dir", default="",
                    help="where the intersect part writes each checkout's SASS listing of "
                         "csrc/intersect.cu")
    args = ap.parse_args()
    unknown = set(args.parts.split(",")) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    line = card()
    print(line, flush=True)
    named = [c.split("=", 1) for c in args.checkouts] or [("this", ROOT)]
    made = {}
    for i, (name, path) in enumerate(named):
        if path.startswith("variant:"):
            v, _, src = path[len("variant:"):].partition("@")
            if v not in VARIANTS:
                ap.error(f"unknown variant {v!r}, of {sorted(VARIANTS)}")
            if (v, src) not in made:
                made[v, src] = variant_copy(v, src or ROOT, f"-{len(made)}" if src else "")
            named[i] = (name, made[v, src])
    listing = os.path.abspath(args.listing_dir) if args.listing_dir else ""
    return run_in_turns(named, __file__, "measure", [line, args.parts, listing],
                        shown=("[split]",))


if __name__ == "__main__":
    sys.exit(main())
