"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out-dir DIR]

Phases (any failure exits non-zero):

1. build every kernel of ``pathtracer_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print ptxas' register / spill
   report; every kernel instance whose registers the script reads and every
   kernel name its profiles match (``EXPECTED_INSTANCES``,
   ``PROFILED_NAMES``) must be among the compiled symbols;
2. drive the main path: Cornell at its full 800x800, depth 8, NEE, through
   ``pathtracer_tpu_torch.render.integrator.render`` on the card, with the
   launch counters zeroed just before; every kernel of the path must have
   launched (the trace kernel once per progressive iteration);
3. hold each kernel against its plain PyTorch version on the card, on the
   main path's own inputs (the 640,000 primary rays of an iteration):
   equal ray counts, radiance within rtol = atol = 2e-6 on at least 99.9%
   of lanes, and the image sum within 1e-5 relative; the persistent grid
   forced to ``SMALL_GRID`` blocks bit-equal to the resident grid, and the
   kernel with russian roulette from bounce 3 against its plain version at
   the same bars;
4. time the kernel (CUDA events over a steady window, and its device time
   queued behind a sleep, ``queued_ms``, twice; with russian roulette once)
   and its plain version, and print ms per iteration, Mrays/s and the mean
   bounces per lane (each phase prints them beside its trace kernel's time:
   their share of the depth is the share of lane-bounces that hold a live
   path) beside the card's name and power limit;
5. check the output: finite image of the expected shape, and the port's
   render of the ``cornell_96`` golden configuration against
   ``tests/golden/cornell_96.npy``; write the PNG, and run the CLI once;
6. ``[grad]``, the differentiable step: ``render.diff.loss_and_grad_rays``
   at Cornell 800x800, depth 8, NEE, 4 spp, target zeros, with the launch
   counters zeroed just before: the forward-with-residuals and the reverse
   kernel must each have launched once per progressive iteration, every
   gradient be finite and the loss positive.  Then the forward kernel
   against its plain version on the 640,000 primary rays of an iteration
   (equal ray counts; radiance and every residual plane bit-equal; radiance
   bit-equal to the trace kernel's), and the
   reverse kernel against its plain version on the same residuals and a
   seeded radiance cotangent: every component of d_origin / d_direction
   within rtol = atol = 1e-5 of the float64 reference's (``tbwd_plain``
   with ``dtype=torch.float64``: float64 autograd at the float32 bounce's
   values) on at least 99.9% of lanes, the float32 plain version's share
   and the worst lanes against both printed beside it; each table
   cotangent within 1e-4 of the largest magnitude in its table of the
   float32 plain version's, since the sums over 640,000 lanes run in
   another order.  Then the worst contention for the reverse kernel's
   table row: all 640,000 lanes aimed within 1e-3 of the point the centre
   pixel hits, every first hit on that geom, through the forward and the
   reverse kernel, held to the float64 reference at ``hold_adjoint``'s
   bars.  Times by CUDA events: the step, both kernels (the forward's
   device time too, queued), both plain versions and the fwd+bwd Mrays/s;
   the reverse kernel's body and its table row sum apart on both lane
   sets (device time per call, twice; the row sum within 0.02 ms at
   640,000 lanes) (rays of one forward pass over the step's time,
   ``bench.py``'s convention); the reverse kernel's bound counts its float
   recompute at the fp32 rate and its double adjoint at the fp64 rate
   (``adjoint_bound``); the step's profile (device busy and idle share);
   the inverse-rendering example on the card, whose loss must fall and wall
   error shrink;
7. ``[grad:perbounce]`` and ``[grad:lean]``, the other two differentiable
   engines at the same width: ``loss_and_grad_rays`` with
   ``RenderConfig(grad_full_trace=False)`` (kernel 2 with replay planes and
   kernel 3 once per bounce: 32 launches each per 4-spp depth-8 step, no
   kernel 4 or 5) and with ``RenderConfig(grad_fused=False)`` (kernel 4
   once per iteration for the forward, keeping each bounce's winner and
   NEE bit; the backward's lean scan replays them and runs kernel 7 once
   per bounce, 32 launches, and no kernel 8, so its checkpoint recompute
   ran no search), each with the counters zeroed just before; every gradient
   finite, the loss within 1e-5 relative and every leaf within 5e-4 *
   max(gscale, 1) of the full-depth step's (russian roulette is off, so the
   physics and samples are the same).  Then on the 640,000 primary rays and
   on the state after three bounces: kernel 2's replay planes equal its
   plain version's on every lane (its other planes bit-equal to the
   wavefront kernel's), kernel 7's t and gid equal on every lane, and kernel
   3 on seeded cotangents on every lane against ``bounce_bwd_plain``'s
   float64 reference: d_origin / d_direction / d_throughput within rtol =
   atol = 1e-5 on at least 99.9% of lanes (the float32 plain version's
   share printed beside it), each table cotangent within 1e-4 of its
   table's largest magnitude, and on the engine's cotangents after three
   bounces (zero on the lanes that died); then the worst contention for
   kernel 3's
   table row: all 640,000 lanes aimed within 1e-3 of the point the centre
   pixel hits, every one on that geom, held to the float64 reference at
   ``hold_adjoint``'s bars.  Times by CUDA events: each new kernel at
   640,000 lanes with its plain version and its bound (kernel 2's replay
   variant's device time too, queued, twice), and kernel 3's body
   and row sum apart (device time, twice, on the state after three bounces
   and on the one-geom lanes); each step's ms,
   fwd+bwd Mrays/s, profiled idle share and peak memory;
8. ``[wavefront]``, the wavefront engines (``render(...,
   RenderConfig(wavefront=True))``) at Cornell 800x800, depth 8, NEE, each
   run through the entry point with the launch counters zeroed just before:
   (a) the pinned engine at 8 spp launches the per-bounce kernel once per
   super-step and nothing else, traces the megakernel's ray count, and its
   accumulator is within rtol = atol = 2e-4 of the megakernel's on at least
   99.9% of entries with the sums within 1e-5 relative; (b) the free-slot
   queue engine (capacity 2^18, 2 spp), the same checks; (c) the split
   route (``fused=False``, 2 spp) launches the nearest-hit and occlusion
   kernels once per super-step each and no per-bounce kernel, and its
   accumulator is within 2e-4 of the fused route's on at least 99.5% of
   entries with the sums within 2e-5; (d) kernels 2, 6, 7 and 8 against
   their plain versions on the 640,000 primary rays and on the state of a
   mid-render super-step (mixed depths and emit states): kernel 2's
   terminate, emit state, russian-roulette uniform and medium equal on
   every lane and its float planes within 2e-6 on at least 99.9% of lanes;
   kernel 6's t, hit, gid and mid equal, its frame within 2e-6 on at least
   99.9% of lanes (the bit-equal share printed); kernel 7's t and gid equal
   to plain and to kernel 6's; kernel 8's t equal on every lane, and on
   the shadow rays the split route of (c) launched it on at super-step 10
   (captured by a hook on its wrapper), with the share of its exact tests
   that a padded world-box cull (``tools/occlusion_cull.py``) would skip,
   per lane and per warp, and its device time there; (e) times: each
   kernel at 640,000 lanes beside its plain version and its bound (kernel
   2's device time too, queued, twice; kernels 6 and 8 with their
   operations at the issue rate too; kernel 8 on (d)'s shadow rays, its
   bound counted from a box cull's tests and the exact tests that hit, and
   on the super-step's bounce rays beside it), the
   renders' wall time, super-steps and Mrays/s, and the 8-spp pinned render
   profiled (device busy and idle share, per super-step); and the CLI with
   ``--engine wavefront``;
9. ``[mesh]``, triangle meshes: ``scenes/smooth_mesh.txt`` (a 320-triangle
   icosphere with authored normals) at ``bench.py``'s 512x512, depth 8,
   NEE, each run through ``render`` with the counters zeroed just before:
   (a) the megakernel at 32 spp launches kernel 1's mesh variant once per
   iteration and nothing else, finite image, PNG written; (b) kernel 1m
   against its plain version on the 262,144 primary rays of an iteration:
   equal ray counts and radiance bit-equal on every lane (the lanes that
   differ, the share within 2e-6 and the sum's difference are printed);
   (c) the split route
   (``fused=False``, 2 spp) launches kernels 6, 8, 9 and 10 once per bounce
   each, the megakernel's ray count, at least 99.5% of accumulator entries
   within 2e-4 of the megakernel's, sums within 2e-5; (d) the pinned
   wavefront engine (2 spp) launches kernel 2m once per super-step, the same
   ray count, 99.9% within 2e-4, sums within 1e-5; (e) kernels 9 and 10,
   culled by the mesh's padded chunk boxes and dense (no boxes, the
   oracle), equal their plain versions on every lane (t, index, misses) on
   the mesh's object-space primary rays and a mid-render super-step's at
   320 triangles, and on a 5,120-triangle displaced icosphere in file
   order, and the lanes where culled and dense differ are counted and
   printed with their conditioning; (f) kernel 2m, whose blocks sweep the
   triangles together, equals its plain version (each lane sweeping on its
   own) in every output on every lane, primary rays and that super-step;
   (g) the ``smooth_mesh_96`` golden rendered on the
   card within a mean 0.8/255 of the PNG; (h) times and bounds (kernels 9
   and 10: device time twice, the dense sweep's, and a bound counted from
   the triangle tests these rays need, which must read below the time;
   kernel 1m's device time twice; kernel 2m's twice and its bound counted
   from the slab and triangle tests of its sweeps on these lanes, which
   must read below the time),
   kernels 9 and 10's registers and shared memory; (i) the CLI
   on smooth_mesh takes ``engine=megakernel``;
10. ``[vol]``, participating media, each render through ``render`` with
    the counters zeroed just before: (a) ``scenes/sss.txt`` at
    ``bench.py``'s 512x512, depth 8, NEE, 32 spp on the megakernel launches
    kernel 1's hg instance once per iteration and nothing else, finite
    image, PNG written; (b) kernel 1 against ``trace_plain`` bit for bit on
    every primary ray of sss (hg), fog (volumetric NEE) and glass_dof at
    its own 800x800 (Beer-Lambert only), equal ray counts; (c) the pinned
    and queue wavefront engines and the split route at 2 spp on sss and fog
    (kernel 2's instance once per super-step; the split route kernels 6 and
    8 once per bounce), the megakernel's ray counts, accumulators within
    rtol = atol = 2e-4 of the megakernel's on at least 99.9% of entries,
    sums within 2e-5; (d) kernel 2's vol and hg instances bit-equal to
    ``bounce_fused_plain`` in every output on sss's primary rays and on
    the captured super-step of the sss and fog renders (lanes inside a
    medium); (e) kernel 1m's vol instance (``pt::mesh_occ_split``) bit for
    bit on a scene the script writes (``scene/variants.fog_mesh_scene``:
    smooth_mesh's icosphere inside fog's scattering cube, glass and opaque), and through
    ``render``; (f) the ``sss_96`` golden (95% of entries within 1e-5,
    sum within 2e-5, PNG mean 0.8/255) and the ``glass_dof_128`` PNG
    (mean 0.8/255) on the card; (g) times by CUDA events (kernel 2's
    instances also by device time, ``queued_ms``), bounds, and each
    instance's registers and spills from ``[build]`` (Cornell's kernel 1
    must keep 72 registers); (h) the CLI on sss takes ``engine=megakernel``;
11. ``[surf]``, optional surface physics, each render through ``render``
    with the counters zeroed just before: (a) ``scenes/ward.txt`` at
    ``bench.py``'s 512x512, depth 8, NEE, 32 spp on the megakernel launches
    kernel 1's surface instance (1s) once per iteration and nothing else,
    and 1s equals ``trace_plain`` bit for bit on all 262,144 primary lanes;
    (b) the same on a GGX copy of ward that the script writes
    (``variants.ggx_ward_scene``: its sphere Cook-Torrance); (c) on
    textured at its 800x800 (checker, bump) and a striped copy
    (``variants.striped_scene``);
    (d) ``scenes/textured_image.txt`` at 512x512, 32 spp through ``render``:
    the per-bounce scan, kernel 2's deferred-texel variant (2t) 8 times per
    iteration and nothing else, and 2t bit-equal to its plain version on
    every output plane (the UV and the atlas slot included) on the primary
    rays and on the inputs of the scan's bounce 3; kernel 2's surface
    instance (2s) bit-equal on ward's primary rays; (e) the pinned and queue
    engines and the split route at 2 spp on the three scenes (kernels 2s /
    2t once per super-step; the split route kernels 6 and 8 once per
    bounce), the megakernel's ray counts, accumulators within rtol = atol =
    2e-4 of the megakernel route's on at least 99.9% of entries with sums
    within 2e-5 (textured's split route, whose bump frame is JAX's split
    path's: 99% and 1e-4, ray counts within 1e-5), and 2s bit-equal on the
    pinned engine's
    super-step 10 of ward and textured; kernel 2's kVol x kSurf instance,
    with and without the replay planes, bit-equal on every output plane on
    that super-step of ``variants.milky_ward_scene`` (512x512: milky's
    medium beside a Ward sphere); (f) the ``ward_96`` golden (95% of
    entries within 1e-5, sum within 2e-5, PNG mean 0.8/255) and the
    ``textured_image_96`` PNG (mean 0.8/255, 99.9% of pixels within 2.5/255)
    on the card; (g) times by CUDA events and each new kernel's device time
    from the profiler, bounds, each new instance's registers and spills,
    Cornell's kernel 1's registers (72) and time;
    (h) the CLI's auto engine on textured_image (``engine=wavefront``);
12. ``[bigmesh]``, meshes above the in-kernel cap and image textures on
    meshes, each render through ``render`` with the counters zeroed just
    before: (a) displace_demo's geometry at 5,120 triangles
    (``scene/variants.bigmesh_scene``) at 512x512, depth 8, NEE, 32 spp on the
    megakernel route, which is the per-bounce scan: kernels 9, 2mm and 10
    once per bounce each (256 each) and nothing else; (b) kernel 2mm
    bit-equal to its plain version on every plane (the 11 deferred ones
    too) on scan bounce 3 and the primary rays, both fed the same merge
    planes; (c) the pinned and queue engines and the split route at 2 spp
    against the megakernel route (99.9% of entries within 2e-4, sums
    1e-5), equal ray counts; (d) the same geometry at 20,480 triangles (the
    LBVH traversal) and (e) an image texture on a vt grid of 8,450
    triangles (``variants.grid_obj``, 2mm with mesh_uv), each at 256x256
    and 1 spp, and on a vt quad (``variants.quad_obj``, kernel 2mt) at
    512x512 and 2 spp, the megakernel route against the split route at
    the same bars, the kernels bit-equal to plain; (f) one lean
    ``loss_and_grad_rays`` step with mesh vertex leaves on smooth_mesh at
    512x512, 4 spp (kernel 1m forward) and on the 5,120-triangle scene at
    256x256, 2 spp (2mm forward): launch counts, finite nonzero vertex
    gradients, time, idle share, peak memory, and the pixels whose lean
    re-trace parts from the forward (iteration 0; no replay outside the
    fused scope); (g) kernels 9 and 10, culled and dense, bit-equal to
    their plain versions on scan bounce 3's rays and its shadow rays, the
    lanes where culled and dense differ counted; times by CUDA events and
    device time (9 and 10 twice, beside the dense sweep's, with bounds
    counted from the inputs), the iteration's wall and busy time and idle
    share, bounds, registers (Cornell's kernels 1 and 2 keep 72 and 56) and
    the CLI's auto engine on the 5,120-triangle scene
    (``engine=wavefront``);
13. ``[grad:vol]``, differentiable participating media, each step through
    ``render.diff.loss_and_grad_rays`` with the counters zeroed just before:
    (a) ``scenes/milky.txt`` at its 800x800, depth 8, NEE, vol_nee on, 4 spp,
    target zeros, on the full-depth engine (kernels 4v and 5v, 4 launches
    each), the per-bounce engine (2r-v and 3v, 32 each) and the lean one
    (kernel 4v forward, kernel 7 in the backward, which replays the
    forward's winners, NEE bits and rays), each step's ms,
    fwd+bwd Mrays/s, profiled idle share, peak memory, launches and the
    medium leaves' gradients; the per-bounce and lean steps' losses within
    1e-5 relative and every leaf within 5e-4 of the largest gradient of the
    full-depth step's, and no pixel whose replayed lean re-trace parts
    from the forward over the 4 iterations; (b) on milky's iteration-0 inputs at full width
    (640,000 lanes) with vol_nee on, and on a 65,536-lane window around the
    milky sphere with vol_nee off: 4v's radiance and 17
    residual planes equal to ``tfwd_plain``'s (its radiance to kernel 1v's),
    5v against ``tbwd_plain``'s float64 reference, 2r-v equal to plain in
    every output and replay plane and 3v against ``bounce_bwd_plain``'s
    float64 reference (the medium's planes too) on the primary rays and the
    state after two bounces: every component within rtol = atol = 1e-5 on
    at least 99.99% of lanes, every table cotangent within 1e-4 of itself
    plus 1e-6 of its table's largest, the lanes beyond the bar printed with
    their paths; the lane order 5v runs before its body (keys equal to
    ``lane_keys_plain``'s, the order a permutation of the lanes sorting
    them; ``hold_lane_order``), with its device time beside the plain
    version's and ``torch.sort``'s; each kernel's device time from the
    profiler (5v and 3v: body and row sum apart, twice), its plain
    version's and its bound at full width (5v's as 5's); (c)
    ``scenes/fog.txt`` at
    its 200x200 on the three engines at (a)'s bars; (d) the lean steps of
    sss at 512x512 (kernel 1hg forward; profiled) and of fog's cube around
    the icosphere (kernel 1m-vol forward), each with its parted pixels of
    iteration 0 (no replay outside the fused scope); the new instances'
    registers,
    and Cornell's kernels 3, 4 and 5 take exactly 152, 64 and 168 (3 with
    no spill);
14. ``[grad:surf]``, differentiable surface physics, each step through
    ``render.diff.loss_and_grad_rays`` with the counters zeroed just
    before: (a) ``scenes/ward.txt`` at ``bench.py``'s 512x512 and
    ``textured.txt`` at its 800x800, depth 8, NEE, 4 spp, target zeros, on
    the full-depth engine (kernels 4s and 5s, 4 launches each; ward's step
    profiled), the per-bounce engine (2r-s and 3s, 32 each) and the lean
    one (kernel 4s forward, kernel 7 in the backward, which replays the
    forward's winners, NEE bits and rays): every gradient finite, the three
    losses equal, each leaf of the per-bounce step within 5e-4 of the
    full-depth step's largest entry of that leaf, and each leaf of the
    lean step too, over every pixel; the pixels whose replayed re-trace
    still parts from the forward counted and printed with their paths
    (none on ward), and on textured, over the pixels that keep the path,
    the lean step's albedo leaves held leaf by leaf as before the replay
    (the docstring of ``hold_engines`` says why);
    ``textured_image.txt`` at 512x512 on the
    lean engine (kernel 2t forward, 8 launches per iteration) with a
    finite, nonzero gradient on the atlas's texels and its parted pixels of
    iteration 0; (b) 4s and 2r-s
    bit-equal to their plain versions and 5s and 3s against the float64
    references (99.99% of lanes at 1e-5, the tables at their bars; the
    lanes beyond printed with their paths) on ward's 262,144 and
    textured's 640,000 iteration-0 lanes, 2r-s and 3s also on the state
    after two bounces (3s in key order bit-equal to index order on every
    lane), and 5s's lane order on ward's lanes as 5v's; (c) each kernel's
    device time on ward's inputs (5s and 3s: body and row sum apart, twice;
    3s's lane order added to its time), its plain version's and its bound
    (the Ward lobe counted on the lanes that sample it; 5s's as 5's); the
    new instances' registers, Cornell's 3 / 4 / 5 at 152 / 64 / 168 and 3s
    at 168 with 20 B of spill;
15. ``[rng]``, threefry (``fast_rng=False``): its bounce draw (``[N, 11]``,
    per-lane depths) and camera draw (``[N, 4]``) on 640,000 CUDA lanes of
    seeded sample indices (some past 2^31) bit-equal to the CPU's, each
    with its device time and launches beside the counter hash's;
16. ``[slowrng]``: Cornell at its 800x800, depth 8, NEE, 2 spp through
    ``render`` with ``RenderConfig(fast_rng=False)`` and the counters zeroed
    just before: the per-bounce scan on the split route, kernels 6 and 8
    once per bounce (16 each) and nothing else; finite image; one
    iteration's wall time, device busy time, idle share and threefry's
    share of the device time (its draws' device time from ``[rng]``); at
    200x200 the card's render against the CPU's plain split route (ray
    counts equal, 99.5% of entries within 2e-4, sums within 2e-5);
17. ``[grad:slowrng]``: one lean ``loss_and_grad_rays`` step at 200x200,
    depth 8, 1 spp with ``fast_rng=False`` (the forward's split route,
    kernels 6 and 8, and the backward's lean re-trace, kernels 7 and 8,
    once per bounce: 8, 16 and 8 launches), profiled, its loss within 1e-5
    relative and every leaf within 5e-4 of the largest gradient of the
    CPU's step;
18. ``[motion]``: ``render/motion.render_motion`` of frames 0-1 of
    ``scenes/animation.txt`` at its 400x400, depth 8, NEE, 8 spp (kernel 1
    once per iteration and nothing else) and of ``deform_demo.txt`` at its
    320x320, 2 spp (kernel 1m, the lerped 20-triangle mesh in the
    in-kernel sweep), each with the counters zeroed just before; finite
    images; one iteration's wall and device time; at 64x64 the card's
    motion renders against the CPU's (ray counts equal, 99.5% within 2e-4,
    sums within 2e-5);
19. ``[debug]``: Cornell at its 800x800, depth 8, NEE, 2 spp on the
    megakernel engine with ``RenderConfig(debug=True)``, one iteration per
    chunk, the counters zeroed just before: the per-bounce scan, kernel 2
    once per bounce (16) and no kernel 1; the alive histogram starts at
    2 x 640,000, never rises and counts the rays (a shadow ray per alive
    lane); the accumulator against kernel 1's render of the same seed
    (99.9% of entries within 1e-5 relative, sums within 2e-5; the entries
    bit-equal counted); a NaN in material 1's colour raises the finite
    check's ``RuntimeError`` for the window ``[0, 1)`` on the megakernel
    and on the pinned engine;
20. ``[ckpt]``: Cornell 800x800 on the megakernel, 4 spp in chunks of 2
    with a checkpoint (``utils/checkpoint.save``) written from
    ``progress_fn`` at 2, loaded and resumed to 4: bit-equal to the straight
    render; then the CLI in a subprocess at 200x200, ``--spp 4 --checkpoint
    --checkpoint-every 2 --preview-every 2 --debug``: exit 0 on ``cuda``,
    the preview, the image and a checkpoint at 4 spp written;
21. ``[interactive]``: ``render/interactive.interactive_loop`` on Cornell
    800x800 with the script ``w j refine 1 save quit``, previews of 1 spp
    and a full render of 2, the counters zeroed just before: kernel 1 six
    times (three previews, one refine, two for the save); the 2-spp
    preview accumulator bit-equal to a fresh 2-spp render of the rig's
    camera and the ``.full.png`` equal to its PNG; a preview's wall time;
22. ``[sharded]``: Cornell at its 800x800, depth 8, NEE, at full width on
    ``SHARDS`` = 4 shards of ``cuda:0`` (``parallel/mesh.make_mesh([cuda:0]
    * 4)``; one card, so no NCCL group of several ranks): ``render_sharded``
    2 spp on the pinned engine with the counters zeroed just before, kernel
    2 once per super-step of each shard and nothing else; the gathered
    accumulator bit-equal to ``render(..., RenderConfig(wavefront=True))``'s
    on the card (each pixel sums its samples in iteration order) and the
    int64 ray counts equal; ``per_device_ray_counts`` and their min / max;
    the queue engine's sharded render against its single-device render
    (99.99% of entries within 1e-5; ``index_add_`` flushes in no fixed
    order); one 4-spp ``loss_and_grad_sharded`` step on the full-depth
    engine (kernels 4 and 5 four times per shard) against ``[grad]``'s
    single-device step (the loss within 1e-5 relative, every leaf within
    rtol = 2e-3, atol = 1e-5); the CLI in a subprocess at 200x200, 4 spp,
    ``--sharded`` with ``WORLD_SIZE=1 RANK=0`` and a free ``MASTER_PORT``
    (a one-rank NCCL group: the ray count and the image gather go through
    NCCL), its PNG within one 8-bit quantum of the single-device image; the
    parts' times;
23. ``[native]``: ``utils/native.py``'s library built with g++ on this
    machine (``available()`` true; built beside the kernels in phase 1 and
    timed there), ``scenes/cornell.txt`` parsed natively equal to the
    Python parse, an 800x800 PNG written natively and read back equal, the
    native and Python parse and encode host times, and
    ``utils/metrics.device_memory_stats()`` after ``[sharded]``;
24. print the kernels' JSON line, then ``{"ok": true, "device": ...}``.

The rendered PNGs and the profile table go to ``--out-dir`` (default
``renders/chip_smoke``).

Imports nothing of JAX and nothing of ``pathtracer_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 and fp64 outside the
# tensor cores (both count a fused multiply-add as two operations)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# the rate at which these builds can issue counted fp32 operations: with
# -fmad=false each multiply or add is an instruction of its own, so half the
# FMA-counted peak (132 SMs x 128 lanes at 1.98 GHz).  Kernels 6, 7 and 8
# print their operation bound at both rates; the JSON line keeps the peak's.
FP32_UNFUSED_OPS_PER_S = 33.5e12

# fp32 operations per lane of csrc/trace.cu, counted by hand from the source
# (multiply, add, compare, select, min/max, sqrt, rsqrt, divide, sin, cos
# each one): the object-space transform of one geom, the sphere and cube
# tests, and the shading of one non-emissive hit (hit point and frame,
# diffuse BSDF sample, light sample and NEE geometry).  Shadow-ray sweeps
# are left out: which lanes trace them depends on the data and the kernel
# does not count them, so the bound below is a lower bound.
OPS_TO_OBJECT = 33
OPS_SPHERE = 37 + 2
OPS_CUBE = 46 + 2
OPS_SHADE = 270
# fp32 operations of one live bounce of csrc/trace_grad.cu's reverse kernel
# beyond the replayed intersection (OPS_TO_OBJECT + one primitive), counted
# by hand for a diffuse hit with a counted NEE connection, the common case:
# the recomputed shading (OPS_SHADE) and its adjoint (tangent frame 130,
# NEE connection with its light sample 210, normal and inverse-transpose 45,
# hit point and intersection 60, object-space ray 60, table accumulation 45)
OPS_BWD_ADJOINT = 550


def adjoint_bound(fp32_ops: int, fp64_ops: int, nbytes: int) -> tuple:
    """The bound of a full-depth reverse kernel (5, 5v, 5s) in ms and what
    sets it: the larger of its bytes at the HBM rate and its operations, the
    float forward's recompute at the fp32 rate plus the double adjoint's at
    the fp64 rate.  A lower bound: the peaks count a fused multiply-add as
    two operations and the kernels, built with ``-fmad=false``, fuse none."""
    t_ops = fp32_ops / FP32_OPS_PER_S + fp64_ops / FP64_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# kernel 1's persistent grid forced to this many blocks in the checks (the
# launcher's block count; 0 takes the blocks resident at once)
SMALL_GRID = 7

# Cornell's kernel 1: its registers and spill store bytes, pinned (28 B of
# spill since the persistent schedule, none before; PERF.md, section 7)
TRACE_CORNELL_REGS = (72, 28)
# kernels 3 (Cornell) and 3s: registers and spill store bytes, pinned.  The
# per-lane sums of the winner's rows (RowSums) took 3 from 158 to 152
# registers and 3s from none to 20 B of spill at its 168 (PERF.md, section 6)
BWD3_REGS = (152, 0)
BWD3S_REGS = (168, 20)
# the designs of the kernels redesigned last, named in the kernels line
DESIGNS = {
    "bounce_mesh": "block sweep: a block's lanes sweep the triangles together, a chunk no lane "
                   "reaches skipped, a reaching lane's 32 tests on a warp (bounce.cu)",
    "bounce_mesh_tex": "block sweep, as bounce_mesh",
    "trace_fwd_resid": "live paths packed into a block's first warps at each bounce, blocks of "
                       "256 (trace_grad.cu:trace_fwd_kernel_packed)",
    "trace_fwd_resid_vol": "live paths packed per block, blocks of 128",
    "trace_fwd_resid_surf": "one path per thread (packing measured slower)",
    "nearest_hit": "two rays a thread, each 16-float table row read once for both; the "
                   "winner's object-space ray recomputed after the sweep; the hit plane written "
                   "in the kernel (intersect.cu)",
    "winner": "two rays a thread, each 16-float table row read once for both (intersect.cu)",
}
# Cornell's kernel 4: its registers, pinned.  72 with one path per thread;
# packing the live paths per block, held to four blocks of 256 per SM,
# leaves it 64 (PERF.md, section 6)
FWD4_REGS = (64,)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _counters() -> dict:
    """Every kernel wrapper's launch counter: name -> (module, attribute)."""
    from pathtracer_tpu_torch.ops import (
        bounce_fused,
        bounce_grad,
        intersect_cuda,
        mesh,
        trace,
        trace_grad,
    )

    return {
        "trace": (trace, "launches"),
        "trace_vol": (trace, "vol_launches"),
        "trace_hg": (trace, "hg_launches"),
        "trace_mesh": (trace, "mesh_launches"),
        "trace_mesh_vol": (trace, "mesh_vol_launches"),
        "trace_surf": (trace, "surf_launches"),
        "bounce_surf": (bounce_fused, "surf_launches"),
        "bounce_tex": (bounce_fused, "tex_launches"),
        "bounce_mesh_tex": (bounce_fused, "mesh_tex_launches"),
        "bounce_merge": (bounce_fused, "merge_launches"),
        "bounce_mesh": (bounce_fused, "mesh_launches"),
        "bounce_vol": (bounce_fused, "vol_launches"),
        "bounce_hg": (bounce_fused, "hg_launches"),
        "mesh_nearest": (mesh, "nearest_launches"),
        "mesh_min": (mesh, "min_launches"),
        "trace_fwd_resid": (trace_grad, "fwd_launches"),
        "trace_bwd": (trace_grad, "bwd_launches"),
        "trace_fwd_resid_vol": (trace_grad, "fwd_vol_launches"),
        "trace_bwd_vol": (trace_grad, "bwd_vol_launches"),
        "trace_fwd_resid_surf": (trace_grad, "fwd_surf_launches"),
        "trace_bwd_surf": (trace_grad, "bwd_surf_launches"),
        "bounce": (bounce_fused, "launches"),
        "bounce_replay": (bounce_fused, "replay_launches"),
        "bounce_replay_vol": (bounce_fused, "replay_vol_launches"),
        "bounce_replay_surf": (bounce_fused, "replay_surf_launches"),
        "bounce_bwd": (bounce_grad, "launches"),
        "bounce_bwd_vol": (bounce_grad, "vol_launches"),
        "bounce_bwd_surf": (bounce_grad, "surf_launches"),
        "nearest_hit": (intersect_cuda, "nearest_launches"),
        "winner": (intersect_cuda, "winner_launches"),
        "occlusion": (intersect_cuda, "occlusion_launches"),
    }


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in _counters().items()}


def only(**launched) -> dict:
    """The counts of a run that launched ``launched`` and nothing else."""
    return {name: launched.get(name, 0) for name in _counters()}


def close_fraction(got, want, tol: float = 1e-5) -> float:
    """Share of lanes (rows of ``[N, 3]``) whose every component is within
    rtol = atol = ``tol`` of ``want``'s, compared in float64."""
    close = got.double().isclose(want.double(), rtol=tol, atol=tol)
    return float(close.all(-1).double().mean())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls (after one
    warm-up call), from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# idle host time at both ends of a profile: late in a long process the
# profiler dropped the records of the kernels run first after it started
# (all ten of ten short calls after three minutes) unless it waited first
PROFILE_PAD_S = 0.05


def profile_events(fn, reps: int = 1):
    """Run ``fn()`` ``reps`` times under the profiler: ``(events, wall ms
    per call)``, ``events`` the device kernels as ``(start us, name, device
    us)``.  Only the device is traced: host operators and ``key_averages``'
    grouping took minutes for the half a million events of a lean gradient
    step."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        time.sleep(PROFILE_PAD_S)
    events = [(e.time_range.start, e.name,
               getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
              for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return events, wall_ms


def profiled(fn, reps: int = 1):
    """:func:`profile_events` summed: ``(kernels, wall ms per call)``,
    ``kernels`` per device kernel name its ``[device us, launches]`` over
    all the calls."""
    events, wall_ms = profile_events(fn, reps)
    kernels = {}
    for _, name, us in events:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += us
        k[1] += 1
    return kernels, wall_ms


def top_kernels(kernels: dict, count: int) -> list:
    """The ``count`` entries of :func:`profiled`'s ``kernels`` with the most
    device time: ``(name, us, launches)``."""
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:count]
    return [(name, us, launches) for name, (us, launches) in ranked]


def write_kernel_table(kernels: dict, path: str) -> None:
    """The 30 kernels with the most device time, with launches, and the
    total over all."""
    with open(path, "w") as f:
        f.write(f"{'device ms':>12} {'launches':>9} {'ms/launch':>10}  kernel\n")
        for name, us, launches in top_kernels(kernels, 30):
            f.write(f"{us / 1e3:12.4f} {launches:9d} {us / 1e3 / launches:10.4f}  {name}\n")
        f.write(f"{sum(v[0] for v in kernels.values()) / 1e3:12.4f} "
                f"{sum(v[1] for v in kernels.values()):9d} {'':10}  all kernels\n")


PROFILE_TRIES = 3  # profiles of one measurement while records are missing


def device_ms(fn, kernels, reps: int = 10, per_call: int = 1) -> dict:
    """Per kernel of ``kernels`` (substrings of kernel names): its mean
    device time in ms per launch and its launch count over ``reps`` calls of
    ``fn()``, from the profiler (after one warm-up call): without the host
    time of the wrapper, which CUDA events around back-to-back calls of a
    short kernel include.  Each kernel launches ``per_call`` times per call;
    the profiler may drop some launches' records, and the mean is over those
    it kept; a profile that kept none of one kernel is taken again (up to
    ``PROFILE_TRIES`` times)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        run, _ = profiled(fn, reps)
        kept = {k: [sum(v[j] for name, v in run.items() if k in name) for j in (0, 1)]
                for k in kernels}
        if all(n for _, n in kept.values()):
            break
    out = {}
    for k, (us, n) in kept.items():
        check(0 < n <= reps * per_call, f"the profiler kept {n} launches of {k} for {reps} calls")
        out[k] = (us / 1e3 / max(n, 1), n)
    return out


def queued_ms(fn, reps: int = 10) -> float:
    """The median device time in ms of one ``fn()`` over ``reps`` calls
    (after a warm-up call), by CUDA events recorded just before and after
    it while a queued ``torch.cuda._sleep`` keeps the card busy, so that the
    host's time to enqueue the call is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


ADJOINT_THREADS = 128  # lanes per block of kernels 3 and 5, each block one partial row
ROW_SUM_SEG = 64  # bounce_adj.cuh:row_sum launches once up to 64 partial rows, twice above


def row_sum_launches(lanes: int) -> int:
    """Launches of ``bounce_adj.cuh:row_sum`` per reverse-kernel call."""
    return 1 if -(-lanes // ADJOINT_THREADS) <= ROW_SUM_SEG else 2


def whole_calls(events, body: str, per_call: int) -> tuple:
    """``events`` (``(start us, name, device us)`` of one profile's body and
    row-sum kernels) cut into calls in launch order: the calls of which the
    profiler kept the body and exactly ``per_call`` row sums, as ``(body
    us, row-sum us)``, and the number of records outside them (a call that
    lost a record, or one that launched a kernel too often)."""
    seq = sorted(events)
    calls, loose, i = [], 0, 0
    while i < len(seq):
        group = seq[i:i + per_call + 1]
        rest = seq[i + per_call + 1:i + per_call + 2]
        if (len(group) == per_call + 1 and body in group[0][1]
                and not any(body in name for _, name, _ in group[1:])
                and all(body in name for _, name, _ in rest)):
            calls.append((group[0][2], sum(us for _, _, us in group[1:])))
            i += per_call + 1
        else:
            loose += 1
            i += 1
    return calls, loose


def body_and_row_sum(fn, body: str, lanes: int, reps: int = 10) -> tuple:
    """An adjoint kernel's device ms per call of ``fn()`` at ``lanes``
    lanes: its body (the kernel whose name holds ``body``) and its table row
    sum (the ``row_sum_launches(lanes)`` kernels named ``row_sum`` after
    it), means over the calls the profiler kept whole (``whole_calls``) in
    a profile of ``2 * reps`` calls: late in a long process it loses some
    calls' records (one to four of ten in ``[grad:vol]`` and
    ``[grad:surf]``).  The profile is taken again while fewer than ``reps``
    are whole (up to ``PROFILE_TRIES`` times, the best one used); fewer
    still, or a kernel launched more often than the calls need, fail the
    run."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = row_sum_launches(lanes)
    n_calls = 2 * reps
    best = ([], 0)
    for _ in range(PROFILE_TRIES):
        events, _ = profile_events(fn, n_calls)
        mine = [e for e in events if body in e[1] or "row_sum" in e[1]]
        n_body = sum(body in name for _, name, _ in mine)
        check(n_body <= n_calls and len(mine) - n_body <= n_calls * per,
              f"{body}: {n_body} bodies and {len(mine) - n_body} row sums in {n_calls} calls")
        calls, loose = whole_calls(mine, body, per)
        best = max(best, (calls, loose), key=lambda c: len(c[0]))
        if len(calls) < n_calls:
            print(f"[profile] {body}: {len(calls)} of {n_calls} calls kept whole, {loose} "
                  f"records outside them", flush=True)
        if len(calls) >= reps:
            break
    calls = best[0]
    check(len(calls) >= reps,
          f"the profiler kept {len(calls)} of {n_calls} calls of {body} whole")
    n = max(len(calls), 1)
    return sum(b for b, _ in calls) / 1e3 / n, sum(r for _, r in calls) / 1e3 / n


ROW_SUM_BAR_MS = 0.02  # the row sum's device time per call at 640,000 lanes


def adjoint_split(tag: str, label: str, fn, body: str, lanes: int, card: str) -> float:
    """Print an adjoint kernel's body and row sum apart, twice (device time
    per call); at 640,000 lanes the row sum must stay within
    ``ROW_SUM_BAR_MS``.  Returns the body's mean device ms per launch, the
    measure of the kernel's ``ms`` in the JSON line."""
    two = [body_and_row_sum(fn, body, lanes) for _ in range(2)]
    print(f"{tag} {label} at {lanes} lanes: body {two[0][0]:.4f} / {two[1][0]:.4f} ms, row sum "
          f"{two[0][1]:.4f} / {two[1][1]:.4f} ms of device time per call (two repeats); on {card}")
    if lanes >= 640_000:
        check(max(r for _, r in two) <= ROW_SUM_BAR_MS,
              f"{label}: row sum {max(r for _, r in two):.4f} ms above {ROW_SUM_BAR_MS} ms")
    return sum(b for b, _ in two) / 2


def profile_step(step, step_ms: float, out_dir: str, name: str, kernels) -> str:
    """Profile one ``step()``: writes the kernel table and returns the
    summary (device busy and idle share against ``step_ms``, time per named
    kernel)."""
    t0 = time.perf_counter()
    run, prof_ms = profiled(step)
    prof_s = time.perf_counter() - t0
    busy_ms = sum(us for us, _ in run.values()) / 1e3
    named = {k: sum(us for n, (us, _) in run.items() if k in n) / 1e3 for k in kernels}
    write_kernel_table(run, os.path.join(out_dir, f"profile_{name}.txt"))
    return (
        f"device busy {busy_ms:.4f} ms of {step_ms:.4f} ms unprofiled ({prof_ms:.4f} ms "
        f"profiled): idle share {1 - busy_ms / step_ms:.3f}; "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in named.items())
        + f"; everything else {busy_ms - sum(named.values()):.4f} ms in "
        f"{sum(launches for _, launches in run.values())} kernel launches; the profile "
        f"took {prof_s:.1f} s with its parse"
    )


def grad_phase(desc, dev, card: str, out_dir: str):
    """Phase 6: the differentiable step on the card.  Returns the JSON
    entries of its two kernels, and the step's loss and gradients."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import intersect_cuda, trace, trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.structs import Rays

    params, static = diff.params_from_description(desc, 0, device=dev)
    w, h = static.resolution
    n = w * h
    cfg = RenderConfig(wavefront=False, nee=True, max_depth=8)
    gspp = 4
    key = prng_key(0)
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def step():
        return diff.loss_and_grad_rays(params, static, target, gspp, key, cfg, device=dev)

    # ---- the main path: one gradient step through the entry point
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, rays = step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = grads.leaves()
    big = sorted(leaves, key=lambda k: -float(leaves[k].abs().max()))[:4]
    print(
        f"[grad] loss_and_grad_rays cornell {w}x{h} d{cfg.max_depth} nee spp={gspp}: "
        f"{first_s:.3f} s (first step), loss {float(loss):.6g}, rays {int(rays)}, peak memory "
        f"{peak_gb:.3f} GB, launches {launches}; largest |grad|: "
        + ", ".join(f"{k} {float(leaves[k].abs().max()):.4g}" for k in big)
    )
    check(launches == only(trace_fwd_resid=gspp, trace_bwd=gspp),
          f"gradient step launches {launches}")
    bad = [k for k, v in leaves.items() if not bool(torch.isfinite(v).all())]
    check(not bad, f"non-finite gradients in {bad}")
    check(float(loss) > 0 and np.isfinite(float(loss)), f"loss {float(loss)}")

    # ---- each kernel against its plain version on the main path's inputs
    seed = key_to_seed(key)
    kw = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
              rr_start=cfg.rr_start)
    with torch.no_grad():
        scene = diff.build_scene(params, static)
        tables = [t.contiguous() for t in pack_tables(scene)]
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        sample = pixel  # iteration 0
        rays0 = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
        args = (*tables, seed, rays0.origin, rays0.direction, sample)
        rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, **kw)
        rad_t, nr_t = trace.trace_cuda(*args, **kw)
        rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, **kw)
        torch.cuda.synchronize()
        fwd_err = float((rad_k - rad_p).abs().max())
        same = torch.equal(rad_k, rad_p) and torch.equal(res_k, res_p)
        print(
            f"[grad:check] forward kernel (live paths packed per block): rays {int(nr_k)} (trace "
            f"kernel {int(nr_t)}, plain {int(nr_p)}); radiance bit-equal to the trace kernel: "
            f"{bool(torch.equal(rad_k, rad_t))}; radiance and all {res_k.shape[1]} residual "
            f"planes equal to plain: {same}; max abs radiance err {fwd_err:.3g}, max abs "
            f"residual err {float((res_k - res_p).abs().max()):.3g}"
        )
        check(torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t),
              "forward kernel differs from the trace kernel")
        check(int(nr_k) == int(nr_p), "forward kernel and plain ray counts differ")
        check(same, "forward kernel differs from its plain version")

        g_rad = torch.from_numpy(
            np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
        ).to(dev)
        bargs = (*tables, seed, sample, res_k, g_rad)
        got = trace_grad.tbwd_cuda(*bargs, **kw)
        want = trace_grad.tbwd_plain(*bargs, **kw)
        ref = trace_grad.tbwd_plain(*bargs, dtype=torch.float64, **kw)
        torch.cuda.synchronize()
        worst = {}
        for name, g, wt, rf in zip(("d_gtab", "d_mtab", "d_ltab", "d_scal"), got[:4], want[:4],
                                   ref[:4]):
            err = float((g - wt).abs().max())
            scale = float(wt.abs().max())
            worst[name] = (err, float((g.double() - rf).abs().max()), scale)
            check(bool(torch.isfinite(g).all()), f"{name} not finite")
            check(err <= 1e-4 * max(scale, 1e-30), f"{name}: {err:.3g} against max {scale:.3g}")
        print(
            "[grad:check] reverse kernel, table cotangents: "
            + "; ".join(f"{k} worst {e:.3g} against float32 plain, {e64:.3g} against float64 "
                        f"reference, of max {m:.4g}" for k, (e, e64, m) in worst.items())
        )
        fracs = {}
        bwd_err = 0.0
        for name, g, wt, rf in zip(("d_origin", "d_direction"), got[4:], want[4:], ref[4:]):
            check(bool(torch.isfinite(g).all()), f"{name} not finite")
            gd, wd = g.double(), wt.double()
            fracs[name] = (close_fraction(gd, rf), close_fraction(wd, rf), close_fraction(gd, wd))
            bwd_err = max(bwd_err, float((gd - rf).abs().max()))
            # the lanes furthest past the bar against the float64 reference,
            # and the float32 plain version on the same lanes
            for ref_name, x in (("kernel", gd), ("float32 plain", wd)):
                excess = ((x - rf).abs() / (1e-5 + 1e-5 * rf.abs())).amax(-1)
                for i in excess.topk(3).indices.tolist():
                    print(
                        f"[grad:check] {name} worst lanes of the {ref_name}: lane {i}: |kernel - "
                        f"float64| {float((gd[i] - rf[i]).abs().max()):.3g}, |float32 plain - "
                        f"float64| {float((wd[i] - rf[i]).abs().max()):.3g}, |kernel - float32 "
                        f"plain| {float((gd[i] - wd[i]).abs().max()):.3g}, largest |component| "
                        f"{float(rf[i].abs().max()):.4g}"
                    )
        print(
            "[grad:check] reverse kernel, lanes with every component within rtol = atol = 1e-5: "
            + "; ".join(f"{k}: kernel vs float64 reference {a:.6f}, float32 plain vs float64 "
                        f"reference {b:.6f}, kernel vs float32 plain {c:.6f}"
                        for k, (a, b, c) in fracs.items())
            + f"; max abs err against the float64 reference {bwd_err:.3g}"
        )
        check(min(a for a, _, _ in fracs.values()) >= 0.999,
              "reverse kernel beyond 1e-5 of the float64 reference on > 0.1% of lanes")

        # ---- the worst contention for the reverse kernel's table row: every
        # lane aimed within 1e-3 of the point the centre pixel hits, so that
        # all first hits are on that geom, through the forward and reverse at
        # full depth (the light's columns take every NEE bounce's adds anyway)
        centre = (h // 2) * w + w // 2
        ct, cg = intersect_cuda.winner_t_gid_cuda(
            Rays(rays0.origin[centre:centre + 1], rays0.direction[centre:centre + 1]), tables[0])
        aim = rays0.origin[centre] + ct[0] * rays0.direction[centre]
        orng = np.random.default_rng(29)
        jitter = torch.from_numpy(orng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32))
        to = aim + jitter.to(dev) - rays0.origin
        one_dir = (to / to.norm(dim=-1, keepdim=True)).contiguous()
        _, og = intersect_cuda.winner_t_gid_cuda(Rays(rays0.origin, one_dir), tables[0])
        print(f"[grad:check] one geom: all {n} lanes hit geom {int(cg[0])} first: "
              f"{bool((og == cg[0]).all())}")
        check(bool((og == cg[0]).all()), "the one-geom lanes do not all hit one geom")
        _, _, ores = trace_grad.tfwd_cuda(*tables, seed, rays0.origin, one_dir, sample, **kw)
        og_rad = torch.from_numpy(orng.standard_normal((n, 3)).astype(np.float32)).to(dev)
        oargs = (*tables, seed, sample, ores, og_rad)
        # the row at its bar; the lanes at kernel 5's bar above (99.9%): the
        # lanes' d_direction is the small difference of terms up to 1e5 on
        # more of them than on camera rays (99.94% of them within it on an
        # H100; a lane's cotangents do not depend on the row's design)
        bwd_err = max(bwd_err, hold_adjoint(
            "kernel 5, every lane on one geom", trace_grad.tbwd_cuda(*oargs, **kw),
            trace_grad.tbwd_plain(*oargs, dtype=torch.float64, **kw), ("d_origin", "d_direction"),
            lambda j: trace_grad.lane_events(tables[0], seed, sample, ores, j), min_share=0.999))

        # ---- times
        f_ms = cuda_ms(lambda: trace_grad.tfwd_cuda(*args, **kw), reps=10)
        f_dev = [queued_ms(lambda: trace_grad.tfwd_cuda(*args, **kw)) for _ in range(2)]
        b_ms = cuda_ms(lambda: trace_grad.tbwd_cuda(*bargs, **kw), reps=10)
        fp_ms = cuda_ms(lambda: trace_grad.tfwd_plain(*args, **kw), reps=1)
        bp_ms = cuda_ms(lambda: trace_grad.tbwd_plain(*bargs, **kw), reps=1)
        adjoint_split("[grad:time]", "kernel 5, Cornell's iteration 0",
                      lambda: trace_grad.tbwd_cuda(*bargs, **kw), "trace_bwd_kernel", n, card)
        adjoint_split("[grad:time]", "kernel 5, every lane on one geom",
                      lambda: trace_grad.tbwd_cuda(*oargs, **kw), "trace_bwd_kernel", n, card)
    step_ms = cuda_ms(step, reps=3)
    mrays = int(rays) / step_ms / 1e3

    summary = profile_step(step, step_ms, out_dir, "grad_step",
                           ("trace_fwd_kernel", "trace_bwd_kernel", "row_sum"))
    print(f"[grad:profile] step: {summary}")

    # ---- bounds, from this run's inputs
    lane_bounces = int(nr_k) // (2 if cfg.nee else 1)
    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    table_bytes = sum(t.numel() * 4 for t in tables)
    f_ops = lane_bounces * (sweep + OPS_SHADE)
    # origin, direction, sample in; radiance and every residual plane out
    f_bytes = n * (12 + 12 + 4 + 12) + cfg.max_depth * trace_grad.N_RESID * n * 4 + table_bytes
    b_ops = lane_bounces * (OPS_TO_OBJECT + min(OPS_SPHERE, OPS_CUBE) + OPS_SHADE)
    b_ops64 = lane_bounces * OPS_BWD_ADJOINT
    # in: the alive plane of every bounce, the other residual planes (o, d,
    # thr, emit state, gid, NEE bit) of the live ones, sample and radiance
    # cotangent; out: d_origin, d_direction and the table cotangents
    b_resid = cfg.max_depth * n * 4 + lane_bounces * (trace_grad.N_RESID - 1) * 4
    b_bytes = b_resid + n * (4 + 12 + 12 + 12) + table_bytes + sum(t.numel() * 4 for t in got[:4])

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    f_bound, f_by = bound(f_ops, f_bytes)
    b_bound, b_by = adjoint_bound(b_ops, b_ops64, b_bytes)
    print(f"[card] {card}")
    print(
        f"[grad:time] step {step_ms:.4f} ms ({mrays:.1f} fwd+bwd Mrays/s: {int(rays)} rays of one "
        f"forward pass over the step); forward kernel {f_ms:.4f} ms/iteration ("
        f"{f_dev[0]:.4f} / {f_dev[1]:.4f} ms of device time, queued, twice; "
        f"{lane_bounces / n:.4f} bounces per lane of {cfg.max_depth}; plain "
        f"{fp_ms:.3f} ms), bound {f_bound:.4f} ms by {f_by} ({f_ops} fp32 ops, {f_bytes} bytes); "
        f"reverse kernel {b_ms:.4f} ms/iteration (plain {bp_ms:.3f} ms), bound {b_bound:.4f} ms "
        f"by {b_by} ({b_ops} fp32 and {b_ops64} fp64 ops, {b_bytes} bytes); on {card}"
    )

    # ---- the inverse-rendering example on the card
    ex = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.examples.inverse_rendering",
         "--res", "64", "--steps", "20"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    lines = ex.stdout.strip().splitlines()
    print(f"[grad:example] exit {ex.returncode}: {' | '.join(lines[-4:])} {ex.stderr.strip()[-2000:]}")
    check(ex.returncode == 0 and lines, "inverse-rendering example failed")
    summary = json.loads(lines[-1])
    check(summary["loss_last"] < summary["loss_first"] and summary["err_end"] < summary["err_start"],
          f"inverse rendering did not converge: {summary}")

    common = {"route": "cuda", "source": "pathtracer_tpu_torch/csrc/trace_grad.cu", "library_ms": None}
    return loss, grads, [
        {"name": "trace_fwd_resid", **common,
         "replaces": "pathtracer_tpu/ops/trace_grad.py:115",
         "launches": launches["trace_fwd_resid"], "max_abs_err": fwd_err, "ms": f_ms,
         "plain_ms": fp_ms, "bound_ms": f_bound, "bound_by": f_by},
        {"name": "trace_bwd", **common,
         "replaces": "pathtracer_tpu/ops/trace_grad.py:190",
         "launches": launches["trace_bwd"], "max_abs_err": bwd_err, "ms": b_ms,
         "plain_ms": bp_ms, "bound_ms": b_bound, "bound_by": b_by},
    ]


def grad_engines_phase(desc, dev, card: str, out_dir: str, full_loss, full_grads) -> list:
    """Phase 7: the per-bounce and lean differentiable engines on the card,
    held to the full-depth step (``full_loss``, ``full_grads``).  Returns the
    JSON entries of kernel 2's replay variant and kernels 3 and 7."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.intersect import winner_t_gid_plain
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.structs import Rays

    params, static = diff.params_from_description(desc, 0, device=dev)
    w, h = static.resolution
    n = w * h
    gspp, depth = 4, 8
    key = prng_key(0)
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    base = RenderConfig(wavefront=False, nee=True, max_depth=depth)
    engines = {
        "perbounce": (dataclasses.replace(base, grad_full_trace=False),
                      only(bounce_replay=gspp * depth, bounce_bwd=gspp * depth),
                      ("bounce_kernel", "bounce_bwd_kernel", "row_sum")),
        # the lean forward on kernel 4 keeps each bounce's winner, NEE bit and ray,
        # which the re-trace replays: no shadow ray
        "lean": (dataclasses.replace(base, grad_fused=False),
                 only(trace_fwd_resid=gspp, winner=gspp * depth),
                 ("trace_fwd_kernel", "winner_kernel")),
    }
    full = full_grads.leaves()
    gscale = max(float(v.abs().max()) for v in full.values())
    steps = {}
    for name, (cfg, expect, kernels) in engines.items():
        def step(cfg=cfg):
            return diff.loss_and_grad_rays(params, static, target, gspp, key, cfg, device=dev)

        # ---- the main path: one gradient step through the entry point
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, rays = step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        leaves = grads.leaves()
        worst, worst_leaf = max((float((leaves[k] - full[k]).abs().max()), k) for k in full)
        loss_rel = abs(float(loss) - float(full_loss)) / abs(float(full_loss))
        print(
            f"[grad:{name}] loss_and_grad_rays cornell {w}x{h} d{depth} nee spp={gspp}: "
            f"{first_s:.3f} s (first step), loss {float(loss):.9g} (full-depth step "
            f"{float(full_loss):.9g}, {loss_rel:.3g} relative), rays {int(rays)}, peak memory "
            f"{peak_gb:.3f} GB, launches {launches}; worst leaf against the full-depth step "
            f"{worst_leaf}, {worst:.3g} (bar {5e-4 * max(gscale, 1.0):.4g})"
        )
        check(launches == expect, f"{name} step launches {launches}, expected {expect}")
        bad = [k for k, v in leaves.items() if not bool(torch.isfinite(v).all())]
        check(not bad, f"{name}: non-finite gradients in {bad}")
        check(loss_rel <= 1e-5, f"{name}: loss {float(loss)} against {float(full_loss)}")
        for k in full:
            err = float((leaves[k] - full[k]).abs().max())
            check(err <= 5e-4 * max(gscale, 1.0), f"{name}: {k} off by {err:.3g}")
        step_ms = cuda_ms(step, reps=2)
        summary = profile_step(step, step_ms, out_dir, f"grad_{name}_step", kernels)
        print(f"[grad:{name}:profile] step: {summary}")
        steps[name] = dict(launches=launches, ms=step_ms, rays=int(rays), peak_gb=peak_gb)

    # ---- kernels against their plain versions: the primary rays of
    # iteration 0 and the state after three bounces of the same rays
    seed = key_to_seed(key)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.no_grad():
        scene = diff.build_scene(params, static)
        tables = [t.contiguous() for t in pack_tables(scene)]
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays0 = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        medium = torch.zeros((n, 4), **f32)
        state = dict(origin=rays0.origin, direction=rays0.direction,
                     throughput=torch.ones((n, 3), **f32), sample=pixel,
                     depth=torch.zeros(n, dtype=torch.int32, device=dev),
                     prev=torch.zeros(n, **f32))
        states = {"primary": state}
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for dep in range(3):  # the scan's carry update, without russian roulette
            res = bounce_fused.bounce_fused_cuda(
                tables, state["origin"], state["direction"], state["throughput"], pixel, dep,
                state["prev"], medium, seed, nee=True)
            alive = alive & ~res.terminate
            a = alive[:, None]
            state = dict(origin=torch.where(a, res.next_origin, state["origin"]),
                         direction=torch.where(a, res.next_direction, state["direction"]),
                         throughput=torch.where(a, state["throughput"] * res.throughput_mult,
                                                state["throughput"]),
                         sample=pixel, depth=torch.full((n,), dep + 1, dtype=torch.int32,
                                                        device=dev),
                         prev=res.was_specular)
        states["after 3 bounces"] = state
        print(f"[grad:check] after 3 bounces: {int(alive.sum())} of {n} paths alive")
        rng = np.random.default_rng(0)
        r_err = b_err = w_err = 0.0
        for label, s in states.items():
            args = (tables, s["origin"], s["direction"], s["throughput"], s["sample"],
                    s["depth"], s["prev"])
            got, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, seed, nee=True,
                                                             emit_replay=True)
            plain, pgid, pnee = bounce_fused.bounce_fused_plain(*args, medium, seed, nee=True,
                                                                emit_replay=True)
            wave = bounce_fused.bounce_fused_cuda(*args, medium, seed, nee=True)
            rays = Rays(s["origin"], s["direction"])
            wt, wg = intersect_cuda.winner_t_gid_cuda(rays, tables[0])
            pt, pg = winner_t_gid_plain(rays, tables[0])
            torch.cuda.synchronize()
            same_wave = all(torch.equal(getattr(got, f.name), getattr(wave, f.name))
                            for f in dataclasses.fields(got))
            for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
                r_err = max(r_err, float((getattr(got, f) - getattr(plain, f)).abs().max()))
            w_err = max(w_err, float((wt - pt).abs().max()))
            print(f"[grad:check] {label}: kernel 2 replay planes equal to plain: gid "
                  f"{torch.equal(rgid, pgid)}, NEE bit {torch.equal(rnee, pnee)} "
                  f"({int((rgid < 0).sum())} misses, {int(rnee.sum())} NEE connections); other "
                  f"planes bit-equal to the wavefront kernel's: {same_wave}; kernel 7 t / gid "
                  f"equal to plain: {torch.equal(wt, pt)} / {torch.equal(wg, pg)}")
            check(torch.equal(rgid, pgid) and torch.equal(rnee, pnee) and same_wave,
                  f"kernel 2's replay variant differs ({label})")
            check(torch.equal(wt, pt) and torch.equal(wg, pg), f"kernel 7 differs ({label})")

            cots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                    for _ in range(4)]
            bargs = (*args, rgid, rnee, *cots, seed)
            got_b = bounce_grad.bounce_bwd_cuda(*bargs, nee=True)
            want_b = bounce_grad.bounce_bwd_plain(*bargs, nee=True)
            ref_b = bounce_grad.bounce_bwd_plain(*bargs, nee=True, dtype=torch.float64)
            torch.cuda.synchronize()
            shares = []
            for nm, g, wt32, rf in zip(("d_origin", "d_direction", "d_throughput"), got_b[4:],
                                       want_b[4:], ref_b[4:]):
                check(bool(torch.isfinite(g).all()), f"kernel 3 {nm} not finite ({label})")
                shares.append((nm, close_fraction(g, rf), close_fraction(wt32, rf)))
                b_err = max(b_err, float((g.double() - rf).abs().max()))
            tab = []
            for nm, g, rf in zip(("d_gtab", "d_mtab", "d_ltab", "d_scal"), got_b[:4], ref_b[:4]):
                err, scale = float((g.double() - rf).abs().max()), float(rf.abs().max())
                tab.append((nm, err, scale))
                check(bool(torch.isfinite(g).all()) and err <= 1e-4 * max(scale, 1e-30),
                      f"kernel 3 {nm}: {err:.3g} against max {scale:.3g} ({label})")
            print(f"[grad:check] {label}: kernel 3, lanes within rtol = atol = 1e-5 of the "
                  f"float64 reference: "
                  + "; ".join(f"{nm} kernel {a:.6f}, float32 plain {b:.6f}" for nm, a, b in shares)
                  + "; tables: " + "; ".join(f"{nm} worst {e:.3g} of max {m:.4g}"
                                             for nm, e, m in tab))
            check(min(a for _, a, _ in shares) >= 0.999,
                  f"kernel 3 beyond 1e-5 of the float64 reference on > 0.1% of lanes ({label})")

        # ---- kernel 3 on the engine's cotangents after three bounces: zero
        # on the lanes that died (they write zeros and add nothing), so that
        # warps of live and dead lanes sum their winner rows as in the step
        ms_ = states["after 3 bounces"]
        args = (tables, ms_["origin"], ms_["direction"], ms_["throughput"], ms_["sample"],
                ms_["depth"], ms_["prev"])
        ecots = [torch.where(alive[:, None], c, 0.0) for c in cots]
        eargs = (*args, rgid, rnee, *ecots, seed)
        b_err = max(b_err, hold_adjoint(
            "kernel 3, the engine's cotangents after 3 bounces",
            bounce_grad.bounce_bwd_cuda(*eargs, nee=True),
            bounce_grad.bounce_bwd_plain(*eargs, nee=True, dtype=torch.float64),
            ("d_origin", "d_direction", "d_throughput"), lambda j: f"alive {bool(alive[j])}",
            min_share=0.999))

        # ---- times at 640,000 lanes on the state after three bounces
        args = (tables, ms_["origin"], ms_["direction"], ms_["throughput"], ms_["sample"],
                ms_["depth"], ms_["prev"])
        bargs = (*args, rgid, rnee, *cots, seed)
        mrays = Rays(ms_["origin"], ms_["direction"])
        r_dev = [queued_ms(lambda: bounce_fused.bounce_fused_cuda(*args, medium, seed, nee=True,
                                                                  emit_replay=True))
                 for _ in range(2)]
        r_ms = cuda_ms(lambda: bounce_fused.bounce_fused_cuda(*args, medium, seed, nee=True,
                                                              emit_replay=True), reps=50)
        rp_ms = cuda_ms(lambda: bounce_fused.bounce_fused_plain(*args, medium, seed, nee=True,
                                                                emit_replay=True), reps=2)
        b_ms = cuda_ms(lambda: bounce_grad.bounce_bwd_cuda(*bargs, nee=True), reps=20)
        bp_ms = cuda_ms(lambda: bounce_grad.bounce_bwd_plain(*bargs, nee=True), reps=2)
        adjoint_split("[grad:perbounce:time]", "kernel 3, Cornell after three bounces",
                      lambda: bounce_grad.bounce_bwd_cuda(*bargs, nee=True), "bounce_bwd_kernel",
                      n, card)

        # ---- the worst contention for the table atomics: every lane aimed
        # within 1e-3 of the centre pixel's hit point, so that all of them
        # hit one geom and add to the same table entries
        centre = (h // 2) * w + w // 2
        ct, cg = intersect_cuda.winner_t_gid_cuda(
            Rays(rays0.origin[centre:centre + 1], rays0.direction[centre:centre + 1]), tables[0])
        aim = rays0.origin[centre] + ct[0] * rays0.direction[centre]
        jitter = torch.from_numpy(rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)).to(dev)
        to = aim + jitter - rays0.origin
        one_dir = (to / to.norm(dim=-1, keepdim=True)).contiguous()
        ones = torch.ones((n, 3), **f32)
        zeros_n = torch.zeros(n, **f32)
        depth0 = torch.zeros(n, dtype=torch.int32, device=dev)
        one_args = (tables, rays0.origin, one_dir, ones, pixel, depth0, zeros_n)
        _, ogid, onee = bounce_fused.bounce_fused_cuda(*one_args, medium, seed, nee=True,
                                                       emit_replay=True)
        print(f"[grad:check] one geom: all {n} lanes hit geom {int(cg[0])}: "
              f"{bool((ogid == cg[0].float()).all())}, {int(onee.sum())} NEE connections")
        check(bool((ogid == cg[0].float()).all()), "the one-geom lanes do not all hit one geom")
        ocots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                 for _ in range(4)]
        oargs = (*one_args, ogid, onee, *ocots, seed)
        b_err = max(b_err, hold_adjoint(
            "kernel 3, every lane on one geom", bounce_grad.bounce_bwd_cuda(*oargs, nee=True),
            bounce_grad.bounce_bwd_plain(*oargs, nee=True, dtype=torch.float64),
            ("d_origin", "d_direction", "d_throughput"),
            lambda j: f"NEE bit {int(onee[j])}"))
        adjoint_split("[grad:perbounce:time]", "kernel 3, every lane on one geom",
                      lambda: bounce_grad.bounce_bwd_cuda(*oargs, nee=True), "bounce_bwd_kernel",
                      n, card)
        w_ms = cuda_ms(lambda: intersect_cuda.winner_t_gid_cuda(mrays, tables[0]), reps=50)
        wp_ms = cuda_ms(lambda: winner_t_gid_plain(mrays, tables[0]), reps=3)

    # ---- bounds, from this run's inputs (every one of the 640,000 lanes is computed)
    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    table_bytes = sum(t.numel() * 4 for t in tables)
    row_bytes = sum(t.numel() * 4 for t in got_b[:4])

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    # kernel 2 with replay: 16 planes in (64 B), 20 float planes and a terminate byte out (81 B)
    r_bound = bound(n * (sweep + OPS_SHADE), n * (64 + 81) + table_bytes)
    # kernel 3: o, d, thr, sample, depth, emit state, two replay planes and four
    # [N, 3] cotangents in (104 B), d_o, d_d, d_thr out (36 B), and the table row;
    # operations: the replayed intersection, the shading and its adjoint
    b_bound = bound(n * (OPS_TO_OBJECT + min(OPS_SPHERE, OPS_CUBE) + OPS_SHADE + OPS_BWD_ADJOINT),
                    n * (104 + 36) + table_bytes + row_bytes)
    # kernel 7: origin and direction in (24 B), t and gid out (8 B)
    w_bound = bound(n * sweep, n * (24 + 8) + tables[0].numel() * 4)
    print(f"[card] {card}")
    for name, st in steps.items():
        print(f"[grad:{name}:time] step {st['ms']:.4f} ms ({st['rays'] / st['ms'] / 1e3:.1f} "
              f"fwd+bwd Mrays/s: {st['rays']} rays of one forward pass over the step), peak "
              f"memory {st['peak_gb']:.3f} GB; on {card}")
    print(
        f"[grad:engines:time] at {n} lanes, the state after 3 bounces: kernel 2 with replay "
        f"{r_ms:.4f} ms ({r_dev[0]:.4f} / {r_dev[1]:.4f} ms of device time, queued, twice; plain "
        f"{rp_ms:.3f} ms, bound {r_bound[0]:.4f} ms by {r_bound[1]}); "
        f"kernel 3 {b_ms:.4f} ms (plain {bp_ms:.3f} ms, bound {b_bound[0]:.4f} ms by "
        f"{b_bound[1]}); kernel 7 {w_ms:.4f} ms (plain {wp_ms:.3f} ms, bound {w_bound[0]:.4f} "
        f"ms by {w_bound[1]}, its operations at the issue rate "
        f"{n * sweep / FP32_UNFUSED_OPS_PER_S * 1e3:.4f}); on {card}"
    )
    pb, ln = steps["perbounce"]["launches"], steps["lean"]["launches"]
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "bounce_replay", **common, "source": "pathtracer_tpu_torch/csrc/bounce.cu",
         "replaces": "pathtracer_tpu/ops/bounce_grad.py:226", "launches": pb["bounce_replay"],
         "max_abs_err": r_err, "ms": r_ms, "plain_ms": rp_ms, "bound_ms": r_bound[0],
         "bound_by": r_bound[1]},
        {"name": "bounce_bwd", **common, "source": "pathtracer_tpu_torch/csrc/bounce_grad.cu",
         "replaces": "pathtracer_tpu/ops/bounce_grad.py:91", "launches": pb["bounce_bwd"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": bp_ms, "bound_ms": b_bound[0],
         "bound_by": b_bound[1]},
        {"name": "winner", **common, "source": "pathtracer_tpu_torch/csrc/intersect.cu",
         "replaces": "pathtracer_tpu/ops/intersect_pallas.py:151", "launches": ln["winner"],
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": wp_ms, "bound_ms": w_bound[0],
         "bound_by": w_bound[1]},
    ]


# fp32 operations of kernel 6's hit frame beyond the sweep, counted by hand
# from csrc/intersect.cu: the world and object-space points (12), the
# object normal (sphere: normalize 9; cube: compares and signs, ~12), the
# inverse-transpose (15) and its normalization (9)
OPS_FRAME = 48
CAPTURE_STEP = 10  # the super-step whose state [wavefront] and [mesh] hold the kernels on


def counted_render(scene, spp: int, cfg, dev):
    """One render through the entry point, every launch counter zeroed just
    before: ``(image, accum, stats, launches, super-steps, wall s)``.  With
    ``captured`` (a dict), the inputs of the wavefront engines' bounce at
    super-step :data:`CAPTURE_STEP` are copied into it."""
    import torch

    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.integrator import render

    zero_counts()
    wavefront.super_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, acc, st = render(scene, spp, cfg, device=dev)
    torch.cuda.synchronize()
    return img, acc, st, read_counts(), wavefront.super_steps, time.perf_counter() - t0


def capturing_render(scene, spp: int, cfg, dev, captured: dict):
    """:func:`counted_render` of a wavefront engine that also copies the
    inputs of its bounce at super-step :data:`CAPTURE_STEP` into
    ``captured``; the wrapper only copies, so the render is unchanged."""
    from pathtracer_tpu_torch.render import wavefront

    shade = wavefront.shade_bounce

    def recording(scn, rays, thr, sample, depth, prev, seed_, cfg_, medium_sigma=None,
                  tables=None):
        if wavefront.super_steps == CAPTURE_STEP:
            captured.update(origin=rays.origin.clone(), direction=rays.direction.clone(),
                            throughput=thr.clone(), sample=sample.clone(), depth=depth.clone(),
                            prev=prev.clone(), medium=medium_sigma.clone())
        return shade(scn, rays, thr, sample, depth, prev, seed_, cfg_,
                     medium_sigma=medium_sigma, tables=tables)

    wavefront.shade_bounce = recording
    try:
        return counted_render(scene, spp, cfg, dev)
    finally:
        wavefront.shade_bounce = shade


def capturing_shadow(fn, captured: dict, at: int = CAPTURE_STEP):
    """``fn()`` with kernel 8's wrapper (``ops/intersect_cuda.occlusion_t_cuda``)
    recording: the shadow rays and geom table of its launch number ``at``
    are copied into ``captured`` (``rays``, ``gtab``); the wrapper only
    copies, so the run and its launch counts are unchanged."""
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.scene.structs import Rays

    occ, calls = intersect_cuda.occlusion_t_cuda, [0]

    def recording(rays, gtab):
        if calls[0] == at:
            captured.update(rays=Rays(rays.origin.clone(), rays.direction.clone()),
                            gtab=gtab.clone())
        calls[0] += 1
        return occ(rays, gtab)

    intersect_cuda.occlusion_t_cuda = recording
    try:
        return fn()
    finally:
        intersect_cuda.occlusion_t_cuda = occ


# fp32 operations of tools/occlusion_cull.py's padded world-box cull,
# counted by hand: a ray's three reciprocals and its sanity test, and one
# world slab test against a geom's padded box with the type test
OPS_CULL_RAY = 18
OPS_BOX = 26


def occlusion_work(rays, gtab) -> dict:
    """The work of kernel 8's function on ``rays`` under the padded
    world-box cull of ``tools/occlusion_cull.py`` (kernel 8 runs every
    test; the cull measured slower, PERF.md section 6): ``lanes``, the
    ``boxes`` (lanes x geoms slab tests), the exact tests the cull leaves
    (``runs``) and those that ``hit`` (t below BIG: no conservative cull
    can skip them), the shares of the exact tests (spheres and cubes) it
    skips per lane and per warp of 32 lanes (a warp runs a test where any
    of its lanes does), and ``ops``: the operations of the cull and of the
    exact tests that hit, the least such a sweep must do."""
    import torch

    from pathtracer_tpu_torch.ops.intersect import BIG, T_MIN, geom_t
    from pathtracer_tpu_torch.tools.occlusion_cull import needed_tests

    runs = needed_tests(rays, gtab)
    n, g = runs.shape
    analytic = ((gtab[:, 12] == 0.0) | (gtab[:, 12] == 1.0)).to(runs.device)
    comps = (rays.origin.unbind(-1), rays.direction.unbind(-1))
    hit_ops = 0
    hits = 0
    for k, row in enumerate(gtab.unbind(0)):
        if bool(analytic[k]):
            t = geom_t(row, *comps[0], *comps[1], T_MIN, float(row[12]))[0]
            h = int((t < BIG).sum())
            hits += h
            hit_ops += h * (OPS_TO_OBJECT + (OPS_SPHERE if float(row[12]) == 0.0 else OPS_CUBE))
    pad = torch.zeros(((-n) % 32, g), dtype=torch.bool, device=runs.device)
    warps = torch.cat([runs, pad]).view(-1, 32, g).any(1)
    tests = int(analytic.sum())
    return dict(lanes=n, boxes=n * g, runs=int(runs.sum()), hit=hits,
                lane_skip=1.0 - int(runs.sum()) / (n * tests),
                warp_skip=1.0 - int(warps.sum()) / (warps.shape[0] * tests),
                ops=n * (OPS_CULL_RAY + g * OPS_BOX) + hit_ops)


def check_close(tag: str, acc, ref, min_share: float, sum_tol: float, what: str) -> None:
    """Fail unless at least ``min_share`` of ``acc``'s entries are within
    rtol = atol = 2e-4 of ``ref``'s and the sums within ``sum_tol``."""
    import torch

    share = float(torch.isclose(acc, ref, rtol=2e-4, atol=2e-4).float().mean())
    sum_rel = float((acc.double().sum() - ref.double().sum()).abs() / ref.double().sum())
    print(f"[{tag}:check] {what}: {share:.6f} of entries within 2e-4, sums within "
          f"{sum_rel:.3g} relative")
    check(share >= min_share and sum_rel <= sum_tol, f"{what} beyond the bar")


def wavefront_phase(scene, dev, card: str, out_dir: str, mega: dict) -> list:
    """Phase 7: the wavefront engines on the card.  ``mega`` holds the
    megakernel's accumulators and ray counts at 8 and 2 spp.  Returns the
    JSON entries of kernels 2, 6 and 8."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.intersect import (
        nearest_hit_plain,
        occlusion_t_plain,
        winner_t_gid_plain,
    )
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.scene.structs import Rays

    w, h = scene.camera.width, scene.camera.height
    n = w * h
    base = dict(max_depth=8, nee=True)

    def run(spp, cfg):
        return counted_render(scene, spp, cfg, dev)[1:]

    def close_to(acc, ref, min_share, sum_tol, what):
        check_close("wavefront", acc, ref, min_share, sum_tol, what)

    # ---- (a) pinned engine, 8 spp; the state of one mid-render super-step
    # is kept for (d)
    captured = {}
    pinned = RenderConfig(wavefront=True, iters_per_launch=8, **base)
    _, acc_a, st_a, launch_a, steps_a, wall_a = capturing_render(scene, 8, pinned, dev, captured)
    print(f"[wavefront] (a) pinned {w}x{h} d8 nee spp=8: {wall_a:.3f} s, {steps_a} super-steps, "
          f"rays {st_a['rays_traced']}, launches {launch_a}")
    check(launch_a == only(bounce=steps_a), f"pinned engine launches {launch_a}")
    check(st_a["rays_traced"] == mega["rays8"], "pinned and megakernel ray counts differ")
    close_to(acc_a, mega["acc8"], 0.999, 1e-5, "(a) pinned vs megakernel, 8 spp")
    check(bool(torch.isfinite(acc_a).all()), "non-finite pinned accumulator")

    # ---- (b) free-slot queue engine, 2 spp
    queue = RenderConfig(wavefront=True, wavefront_pinned=False, wavefront_capacity=1 << 18,
                         iters_per_launch=2, **base)
    acc_b, st_b, launch_b, steps_b, wall_b = run(2, queue)
    print(f"[wavefront] (b) queue capacity {1 << 18}, spp=2: {wall_b:.3f} s, {steps_b} "
          f"super-steps, rays {st_b['rays_traced']}, launches {launch_b}")
    check(launch_b == only(bounce=steps_b), f"queue engine launches {launch_b}")
    check(st_b["rays_traced"] == mega["rays2"], "queue and megakernel ray counts differ")
    close_to(acc_b, mega["acc2"], 0.999, 1e-5, "(b) queue vs megakernel, 2 spp")

    # ---- (c) split route (kernels 6 and 8), pinned, 2 spp, against the
    # fused route's pinned render at the same spp; kernel 8's shadow rays of
    # super-step 10 are kept for (d)
    split = dataclasses.replace(pinned, fused=False, iters_per_launch=2)
    shadow = {}
    acc_c, st_c, launch_c, steps_c, wall_c = capturing_shadow(lambda: run(2, split), shadow)
    print(f"[wavefront] (c) split route, pinned, spp=2: {wall_c:.3f} s, {steps_c} super-steps, "
          f"rays {st_c['rays_traced']}, launches {launch_c}")
    check(launch_c == only(nearest_hit=steps_c, occlusion=steps_c),
          f"split route launches {launch_c}")
    acc_a2, st_a2, _, steps_a2, wall_a2 = run(2, dataclasses.replace(pinned, iters_per_launch=2))
    print(f"[wavefront] fused route, pinned, spp=2: {wall_a2:.3f} s, {steps_a2} super-steps, "
          f"rays {st_a2['rays_traced']}")
    close_to(acc_c, acc_a2, 0.995, 2e-5, "(c) split vs fused route, 2 spp")

    # ---- (d) kernels against their plain versions: the primary rays and
    # the captured mid-render super-step
    check(bool(captured), "no super-step state captured")
    seed = key_to_seed(prng_key(0))
    tables = [t.contiguous() for t in pack_tables(scene)]
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    rays0 = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
    f32 = dict(dtype=torch.float32, device=dev)
    states = {
        "primary": dict(origin=rays0.origin, direction=rays0.direction,
                        throughput=torch.ones((n, 3), **f32), sample=pixel,
                        depth=torch.zeros(n, dtype=torch.int32, device=dev),
                        prev=torch.zeros(n, **f32), medium=torch.zeros((n, 4), **f32)),
        f"super-step {CAPTURE_STEP}": captured,
    }
    mid = captured
    print(f"[wavefront:check] super-step {CAPTURE_STEP}: depths "
          f"{torch.bincount(mid['depth'].long()).tolist()}, emit states "
          f"{[int((mid['prev'] == v).sum()) for v in (0.0, 1.0, 2.0)]}")
    b_err = n_err = o_err = 0.0
    for label, s in states.items():
        args = (tables, s["origin"], s["direction"], s["throughput"], s["sample"], s["depth"],
                s["prev"], s["medium"], seed)
        got = bounce_fused.bounce_fused_cuda(*args, nee=True)
        want = bounce_fused.bounce_fused_plain(*args, nee=True)
        rays = Rays(s["origin"], s["direction"])
        hit_k, hit_p = intersect_cuda.nearest_hit_cuda(rays, tables[0]), nearest_hit_plain(rays, tables[0])
        occ_k, occ_p = intersect_cuda.occlusion_t_cuda(rays, tables[0]), occlusion_t_plain(rays, tables[0])
        win_k = intersect_cuda.winner_t_gid_cuda(rays, tables[0])
        win_p = winner_t_gid_plain(rays, tables[0])
        torch.cuda.synchronize()
        exact = (torch.equal(got.terminate, want.terminate)
                 and torch.equal(got.was_specular, want.was_specular)
                 and torch.equal(got.rr_uniform, want.rr_uniform)
                 and torch.equal(got.next_medium, want.next_medium))
        close = torch.ones(n, dtype=torch.bool, device=dev)
        same = torch.ones(n, dtype=torch.bool, device=dev)
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            a, b = getattr(got, f), getattr(want, f)
            close &= torch.isclose(a, b, rtol=2e-6, atol=2e-6).all(-1)
            same &= (a == b).all(-1)
            b_err = max(b_err, float((a - b).abs().max()))
        b_share = float(close.float().mean())
        ids_equal = (torch.equal(hit_k.t, hit_p.t) and torch.equal(hit_k.geom_id, hit_p.geom_id)
                     and torch.equal(hit_k.material_id, hit_p.material_id)
                     and torch.equal(hit_k.hit, hit_p.hit))
        win_equal = (torch.equal(win_k[0], win_p[0]) and torch.equal(win_k[1], win_p[1])
                     and torch.equal(win_k[0], hit_k.t) and torch.equal(win_k[1], hit_k.geom_id))
        frame = torch.ones(n, dtype=torch.bool, device=dev)
        frame_same = torch.ones(n, dtype=torch.bool, device=dev)
        for f in ("position", "position_obj", "normal"):
            a, b = getattr(hit_k, f), getattr(hit_p, f)
            frame &= torch.isclose(a, b, rtol=2e-6, atol=2e-6).all(-1)
            frame_same &= (a == b).all(-1)
            n_err = max(n_err, float((a - b).abs().max()))
        o_err = max(o_err, float((occ_k - occ_p).abs().max()))
        print(
            f"[wavefront:check] {label}, {n} lanes: kernel 2 terminate / emit state / rr "
            f"uniform / medium equal: {exact}; lanes with every plane within 2e-6 {b_share:.6f}, "
            f"bit-equal {float(same.float().mean()):.6f}; kernel 6 t / hit / gid / mid equal: "
            f"{ids_equal}, frame within 2e-6 {float(frame.float().mean()):.6f}, bit-equal "
            f"{float(frame_same.double().mean()):.6f}; kernel 7 t / gid equal to plain and to "
            f"kernel 6's: {win_equal}; kernel 8 t equal: {torch.equal(occ_k, occ_p)}"
        )
        check(exact and b_share >= 0.999, f"kernel 2 differs from its plain version ({label})")
        check(ids_equal and float(frame.float().mean()) >= 0.999,
              f"kernel 6 differs from its plain version ({label})")
        check(win_equal, f"kernel 7 differs from its plain version or kernel 6 ({label})")
        check(torch.equal(occ_k, occ_p), f"kernel 8 differs from its plain version ({label})")

    # ---- kernel 8 on the shadow rays the split route of (c) launched it on
    check(bool(shadow), "no shadow rays captured")
    srays, sgtab = shadow["rays"], shadow["gtab"]
    occ_k, occ_p = intersect_cuda.occlusion_t_cuda(srays, sgtab), occlusion_t_plain(srays, sgtab)
    torch.cuda.synchronize()
    o_err = max(o_err, float((occ_k - occ_p).abs().max()))
    k8_work = occlusion_work(srays, sgtab)
    k8_dev = [queued_ms(lambda: intersect_cuda.occlusion_t_cuda(srays, sgtab)) for _ in range(2)]
    print(f"[wavefront:check] split route super-step {CAPTURE_STEP}'s shadow rays, "
          f"{k8_work['lanes']} lanes: kernel 8 t equal to plain: {torch.equal(occ_k, occ_p)}; "
          f"a padded world-box cull would skip {k8_work['lane_skip']:.4f} of its exact tests "
          f"per lane, {k8_work['warp_skip']:.4f} per warp of 32 ({k8_work['runs']} left, "
          f"{k8_work['hit']} hit); {k8_dev[0]:.4f} / {k8_dev[1]:.4f} ms of device time (queued, "
          f"twice); on {card}")
    check(torch.equal(occ_k, occ_p), "kernel 8 differs from its plain version (shadow rays)")

    # ---- (e) times at 640,000 lanes, on the captured super-step's state
    margs = (tables, mid["origin"], mid["direction"], mid["throughput"], mid["sample"],
             mid["depth"], mid["prev"], mid["medium"], seed)
    mrays = Rays(mid["origin"], mid["direction"])
    k2_ms = cuda_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, nee=True), reps=50)
    k2_dev = [queued_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, nee=True))
              for _ in range(2)]
    k2p_ms = cuda_ms(lambda: bounce_fused.bounce_fused_plain(*margs, nee=True), reps=2)
    k6_ms = cuda_ms(lambda: intersect_cuda.nearest_hit_cuda(mrays, tables[0]), reps=50)
    k6p_ms = cuda_ms(lambda: nearest_hit_plain(mrays, tables[0]), reps=3)
    k8_ms = cuda_ms(lambda: intersect_cuda.occlusion_t_cuda(srays, sgtab), reps=50)
    k8p_ms = cuda_ms(lambda: occlusion_t_plain(srays, sgtab), reps=3)
    k8u_ms = cuda_ms(lambda: intersect_cuda.occlusion_t_cuda(mrays, tables[0]), reps=50)
    _, st_t, _, steps_t, wall_t = run(8, pinned)  # the pinned render again, unwrapped
    # where a super-step's time goes: the same 8-spp render, profiled
    wavefront.super_steps = 0
    kernels_run, prof_ms = profiled(lambda: render(scene, 8, pinned, device=dev))
    steps_p = wavefront.super_steps
    busy_ms = sum(us for us, _ in kernels_run.values()) / 1e3
    k2_prof = sum(us for k, (us, _) in kernels_run.items() if "bounce_kernel" in k) / 1e3
    write_kernel_table(kernels_run, os.path.join(out_dir, "profile_wavefront_8spp.txt"))
    wall_ms = wall_t * 1e3  # the unprofiled run of the same render
    print(
        f"[wavefront:profile] pinned 8-spp render, {steps_p} super-steps: {wall_ms:.4f} ms "
        f"unprofiled ({prof_ms:.4f} ms profiled), device busy {busy_ms:.4f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; per super-step: wall {wall_ms / steps_p:.4f} ms, kernel 2 "
        f"{k2_prof / steps_p:.4f} ms, other device work {(busy_ms - k2_prof) / steps_p:.4f} ms "
        f"in {sum(c for _, c in kernels_run.values()) / steps_p:.1f} kernel launches; top: "
        + "; ".join(f"{k[:40]} x{c} {us / 1e3:.4f} ms" for k, us, c in top_kernels(kernels_run, 5))
    )

    # ---- bounds, from this run's inputs (all 640,000 lanes are computed)
    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    table_bytes = sum(t.numel() * 4 for t in tables)

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    # kernel 2: 16 planes in (64 B), 18 float planes and a terminate byte out (73 B)
    k2_bound = bound(n * (sweep + OPS_SHADE), n * (64 + 73) + table_bytes)
    # kernel 6: origin and direction in (24 B); t, hit, gid, mid, p, p_obj, n out (49 B)
    k6_bound = bound(n * (sweep + OPS_FRAME), n * (24 + 49) + tables[0].numel() * 4)
    # kernel 8 on the shadow rays: origin and direction in, t out; its
    # operations a box cull's and the exact tests that hit (occlusion_work)
    ns = k8_work["lanes"]
    k8_bound = bound(k8_work["ops"], ns * (24 + 4) + sgtab.numel() * 4)
    k6_issue = n * (sweep + OPS_FRAME) / FP32_UNFUSED_OPS_PER_S * 1e3
    k8_issue = k8_work["ops"] / FP32_UNFUSED_OPS_PER_S * 1e3
    print(f"[card] {card}")
    print(
        f"[wavefront:time] pinned 8 spp: {steps_t} super-steps, {wall_t * 1e3:.4f} ms "
        f"({wall_t * 1e3 / 8:.4f} ms per spp, {st_t['rays_traced'] / wall_t / 1e6:.1f} Mrays/s); "
        f"queue 2 spp {wall_b * 1e3:.4f} ms ({st_b['rays_traced'] / wall_b / 1e6:.1f} Mrays/s); "
        f"split route 2 spp {wall_c * 1e3:.4f} ms ({st_c['rays_traced'] / wall_c / 1e6:.1f} "
        f"Mrays/s); fused route 2 spp {wall_a2 * 1e3:.4f} ms; launches per 8-spp render: kernel 2 "
        f"{launch_a['bounce']}; per 2-spp split render: kernels 6 and 8 "
        f"{launch_c['nearest_hit']} each; on {card}"
    )
    print(
        f"[wavefront:time] at {n} lanes: kernel 2 {k2_ms:.4f} ms ({k2_dev[0]:.4f} / "
        f"{k2_dev[1]:.4f} ms of device time, queued, twice; plain {k2p_ms:.3f} ms, bound "
        f"{k2_bound[0]:.4f} ms by {k2_bound[1]}); kernel 6 {k6_ms:.4f} ms (plain {k6p_ms:.3f} ms, "
        f"bound {k6_bound[0]:.4f} ms by {k6_bound[1]}, its operations at the issue rate "
        f"{k6_issue:.4f}); kernel 8 on the split route's shadow rays ({ns} lanes) {k8_ms:.4f} "
        f"ms (plain {k8p_ms:.3f} ms, bound {k8_bound[0]:.4f} ms by {k8_bound[1]}: "
        f"{k8_work['boxes']} box tests and the {k8_work['hit']} exact tests that hit, at the "
        f"issue rate {k8_issue:.4f}), on the super-step's bounce rays {k8u_ms:.4f} ms; on {card}"
    )

    # ---- the CLI with the wavefront engine
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/cornell.txt",
         "--spp", "2", "--engine", "wavefront", "--out",
         os.path.join(out_dir, "cli_cornell_wavefront.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[wavefront:cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0 and "engine=wavefront" in cli.stdout, "wavefront CLI run failed")

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "bounce", **common, "source": "pathtracer_tpu_torch/csrc/bounce.cu",
         "replaces": "pathtracer_tpu/ops/bounce_pallas.py:1477", "launches": launch_a["bounce"],
         "max_abs_err": b_err, "ms": k2_ms, "plain_ms": k2p_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1]},
        {"name": "nearest_hit", **common, "source": "pathtracer_tpu_torch/csrc/intersect.cu",
         "replaces": "pathtracer_tpu/ops/intersect_pallas.py:83",
         "launches": launch_c["nearest_hit"], "max_abs_err": n_err, "ms": k6_ms,
         "plain_ms": k6p_ms, "bound_ms": k6_bound[0], "bound_by": k6_bound[1]},
        {"name": "occlusion", **common, "source": "pathtracer_tpu_torch/csrc/intersect.cu",
         "replaces": "pathtracer_tpu/ops/intersect_pallas.py:193",
         "launches": launch_c["occlusion"], "max_abs_err": o_err, "ms": k8_ms,
         "plain_ms": k8p_ms, "bound_ms": k8_bound[0], "bound_by": k8_bound[1]},
    ]


MESH_RES = (512, 512)  # bench.py's smooth_mesh row
MESH_SPP = 32
OPS_MT = 66  # one ray-triangle Moeller-Trumbore test and the running-best update
OPS_AABB = 26  # one chunk-box slab test of the in-kernel sweep
OPS_MESH_RAY = OPS_TO_OBJECT + 18  # a mesh's object-space ray and its reciprocal direction


def mesh_bounce_work(tables, km, s, seed: int, features=frozenset()) -> dict:
    """The triangle work of kernel 2's mesh instances (2m, 2mt) on the
    bounce state ``s`` under NEE, counted from the plain versions as kernels
    9 and 10's bounds are.  The nearest-hit sweep: a slab test of every
    chunk box per lane and the 32 pair tests of each chunk the culled sweep
    enters (``mesh_sweep``'s ``reached``).  The shadow ray, which the kernel
    sweeps where the analytic geoms leave it clear (the merge variant's
    deferred ray and ``cand_vis``, ``bounce_fused_plain`` with the sweep's
    winner merged in): where the mesh does not block it, a slab test of
    every chunk box and the pair tests of each chunk it enters by its final
    t; where the mesh blocks it, none (the sweep stops at the first blocker):
    a lower bound.  Returns the counts, the shares of lanes and warps
    whose ray reaches a chunk and the most chunks one lane enters."""
    import torch

    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.ops.intersect import safe_recip, to_object
    from pathtracer_tpu_torch.ops.mesh_tables import (MESH_CHUNK, chunk_reaches, mesh_occ,
                                                      mesh_sweep)

    o, d = s["origin"].unbind(-1), s["direction"].unbind(-1)
    hit = mesh_sweep(km, tables[0], o, d)
    chunks = km.aabb.numel() // 6
    mesh_in = torch.stack([hit["et"], *hit["epo"], *hit["en"], hit["emid"].to(torch.float32)])
    _, deferred = bounce_fused.bounce_fused_plain(
        tables, s["origin"], s["direction"], s["throughput"], s["sample"], s["depth"], s["prev"],
        s["medium"].contiguous(), seed, nee=True, features=features,
        mesh_in=mesh_in.contiguous())
    cand = deferred[10] > 0.5
    x, wi = deferred[0:3, cand], deferred[3:6, cand]
    limit = deferred[6, cand] - SHADOW_SLACK
    occ = mesh_occ(km, tables[0], x.unbind(0), wi.unbind(0))
    clear = occ >= limit
    reach_by = torch.nextafter(occ, torch.full_like(occ, float("inf")))
    shadow_pairs = 0
    boxes = km.aabb.view(-1, 6)
    for g, n_chunks, first, _, _ in km.descs:
        obj = to_object(tables[0][g].unbind(-1), *x.unbind(0), *wi.unbind(0))
        inv = tuple(safe_recip(c) for c in obj[3:])
        for c in range(first, first + n_chunks):
            shadow_pairs += int((chunk_reaches(boxes[c].unbind(-1), obj[:3], inv, reach_by)
                                 & clear).sum()) * MESH_CHUNK
    reaching = hit["reached"] > 0
    n = reaching.shape[0]
    warps = torch.nn.functional.pad(reaching, (0, (-n) % 32)).view(-1, 32).any(-1)
    return dict(slab=n * chunks + int(clear.sum()) * chunks,
                pairs=int(hit["reached"].sum()) * MESH_CHUNK + shadow_pairs,
                shadow_rays=int(cand.sum()), blocked=int((~clear).sum()),
                lanes_reaching=float(reaching.double().mean()),
                warps_reaching=float(warps.double().mean()),
                most_chunks=int(hit["reached"].max()))


SHADOW_SLACK = 4 * 2e-4  # trace_common.cuh: a shadow ray is clear up to this short of the light


def mesh_kernel_resources(reports: dict) -> dict:
    """Kernels 9 and 10's registers and shared memory, ptxas's own words
    (``Used N registers, ... smem``) from ``_build.build_all``'s report of
    ``csrc/mesh.cu``."""
    out, entry = {}, None
    for line in reports.get("mesh", "").splitlines():
        if "Compiling entry function" in line:
            entry = "9" if "mesh_nearest_kernel" in line else "10" if "mesh_min_kernel" in line \
                else None
        elif "Used" in line and "registers" in line and entry is not None:
            out[entry] = line.split("info    :")[-1].strip()
            entry = None
    return out or {"9 and 10": "not in this build's report (a reused library)"}


def hold_mesh_kernels(tag, label, tab, boxes, o, d, k9_err: float, k10_err: float):
    """Kernels 9 and 10 (``ops/mesh``) on the rays ``o``, ``d`` against
    their plain versions, culled (``boxes``) and dense, bit for bit on
    every lane; the lanes where culled and dense differ are counted and
    printed with the dense winner's conditioning |a| / (|e1| |h|).
    Returns the largest |t| errors of 9 and 10 on the hits, with the ones
    given."""
    import torch

    from pathtracer_tpu_torch.ops import mesh

    got = {}
    for sweep, bx in (("culled", boxes), ("dense", None)):
        t_k, i_k = mesh.mesh_nearest_cuda(tab, bx, o, d)
        occ_k = mesh.mesh_min_cuda(tab, bx, o, d)
        t_p, i_p = mesh.mesh_nearest_plain(tab, bx, o, d)
        occ_p = mesh.mesh_min_plain(tab, bx, o, d)
        torch.cuda.synchronize()
        hit = t_p < mesh.BIG
        if bool(hit.any()):
            k9_err = max(k9_err, float((t_k - t_p).abs()[hit].max()))
            k10_err = max(k10_err, float((occ_k - occ_p).abs()[hit].max()))
        equal = (torch.equal(t_k, t_p), torch.equal(i_k, i_p), torch.equal(occ_k, occ_p))
        print(f"{tag} {label}, {sweep}, {o.shape[0]} rays, {int(hit.sum())} hits: kernel 9 t / "
              f"index equal to plain {equal[0]} / {equal[1]}, kernel 10 t equal {equal[2]}")
        check(all(equal), f"kernels 9 / 10 ({sweep}) differ from their plain versions ({label})")
        got[sweep] = (t_k, i_k, occ_k)
    (tc, ic, oc), (td, idn, od) = got["culled"], got["dense"]
    differ = (tc != td) | (ic != idn) | (oc != od)
    lanes = differ.nonzero()[:16, 0]
    rows = tab.view(-1, 9)[idn[lanes].long()]
    h = torch.linalg.cross(d[lanes], rows[:, 6:9], dim=-1)
    cond = (rows[:, 3:6] * h).sum(-1).abs() / (rows[:, 3:6].norm(dim=-1) * h.norm(dim=-1))
    print(f"{tag} {label}: culled differs from dense on {int(differ.sum())} of {o.shape[0]} "
          f"lanes" + "".join(f"; lane {j} t {float(tc[j]):.9g} vs {float(td[j]):.9g}, "
                             f"conditioning {float(c):.3g}"
                             for j, c in zip(lanes.tolist(), cond.tolist())))
    return k9_err, k10_err


def time_mesh_kernels(tab, boxes, bare, o, d) -> dict:
    """Kernels 9 and 10 on the rays ``o``, ``d``: their device time (the
    median of ten launches, :func:`queued_ms`, twice), the dense sweep's, the
    culled plain version's (CUDA events), and the bound counted from
    these inputs: a slab test per lane and chunk and a Moeller-Trumbore
    test per (lane, triangle) of every chunk whose bare box (``bare``) the
    ray enters at or before its final t (the plain version's masks), over
    67 TFLOP/s, against the rays in, the results out and the table and
    boxes once, over 3.35 TB/s."""
    import torch

    from pathtracer_tpu_torch.ops import mesh
    from pathtracer_tpu_torch.ops.intersect import safe_recip
    from pathtracer_tpu_torch.ops.mesh_tables import chunk_reaches

    n, n_tris = o.shape[0], tab.numel() // 9
    t_final = mesh.mesh_nearest_plain(tab, boxes, o, d)[0]
    inv = tuple(safe_recip(c) for c in d.unbind(-1))
    reach_by = torch.nextafter(t_final, torch.full_like(t_final, float("inf")))
    pairs = 0
    for c in range(bare.shape[0]):
        rows = min(mesh.SCAN_CHUNK, n_tris - c * mesh.SCAN_CHUNK)
        pairs += int(chunk_reaches(bare[c].unbind(-1), o.unbind(-1), inv, reach_by).sum()) * rows
    ops = n * bare.shape[0] * OPS_AABB + pairs * OPS_MT
    static_bytes = tab.numel() * 4 + boxes.numel() * 4
    out = {}
    for key, culled, dense, plain, out_bytes in (
            ("9", lambda: mesh.mesh_nearest_cuda(tab, boxes, o, d),
             lambda: mesh.mesh_nearest_cuda(tab, None, o, d),
             lambda: mesh.mesh_nearest_plain(tab, boxes, o, d), 8),
            ("10", lambda: mesh.mesh_min_cuda(tab, boxes, o, d),
             lambda: mesh.mesh_min_cuda(tab, None, o, d),
             lambda: mesh.mesh_min_plain(tab, boxes, o, d), 4)):
        t_ops = ops / FP32_OPS_PER_S
        t_bytes = (n * (24 + out_bytes) + static_bytes) / HBM_BYTES_PER_S
        out[key] = dict(
            ms=queued_ms(culled), ms2=queued_ms(culled), dense_ms=queued_ms(dense),
            plain_ms=cuda_ms(plain, reps=2),
            bound=(max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"),
            pairs=pairs, all_pairs=n * n_tris, rays=n, tris=n_tris)
    return out


def print_mesh_times(tag, where, mt: dict, card: str) -> None:
    for key, v in mt.items():
        print(f"{tag} kernel {key} at {where}: {v['ms']:.4f} / {v['ms2']:.4f} ms of device time "
              f"(two repeats; the dense sweep {v['dense_ms']:.4f} ms; plain {v['plain_ms']:.3f} "
              f"ms), bound {v['bound'][0]:.4f} ms by {v['bound'][1]}, counted from "
              f"{v['pairs']} needed ray-triangle tests of the {v['all_pairs']} pairs; on {card}")
        check(v["bound"][0] < v["ms"], f"kernel {key}'s counted bound reads below its time")


def mesh_phase(dev, card: str, out_dir: str, reports: dict) -> list:
    """Phase 9, ``[mesh]``: smooth_mesh (a 320-triangle icosphere with
    authored normals) at ``bench.py``'s width through every forward engine,
    and kernels 9, 10 and the mesh variants of 1 and 2 against their plain
    versions.  Returns their JSON entries."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, mesh, trace
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.mesh_tables import MESH_CHUNK, mesh_sweep
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.scene.displace import displace_mesh
    from pathtracer_tpu_torch.scene.obj import load_obj
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.scene.structs import Rays
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    path = os.path.join(ROOT, "scenes", "smooth_mesh.txt")
    desc = dataclasses.replace(load_scene(path), resolution=MESH_RES)
    scene = desc.scene_for_frame(0, device=dev)
    (m0,) = scene.meshes
    km = scene.mesh_tables
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=8)
    seed = key_to_seed(prng_key(cfg.seed))

    def run(spp, rcfg):
        return counted_render(scene, spp, rcfg, dev)

    def close_to(acc, ref, min_share, sum_tol, what):
        check_close("mesh", acc, ref, min_share, sum_tol, what)

    # ---- (a) the megakernel through the entry point at bench.py's width
    spp = MESH_SPP
    img, acc, st, launches, _, wall = run(spp, cfg)
    print(f"[mesh] smooth_mesh {w}x{h} d{cfg.max_depth} nee spp={spp}, {m0.tri_verts.shape[0]} "
          f"triangles: {wall:.3f} s, rays {st['rays_traced']}, launches {launches}")
    check(launches == only(trace_mesh=spp), f"mesh megakernel launches {launches}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
          and bool((acc >= 0).all()), "mesh render: bad image")
    save_image(os.path.join(out_dir, "chip_smoke_smooth_mesh.png"), img.cpu().numpy())
    _, acc2, st2, _, _, _ = run(2, cfg)  # the megakernel at 2 spp, for (c) and (d)

    # ---- (b) kernel 1m against its plain version on one iteration's primary rays
    tables = [t.contiguous() for t in pack_tables(scene)]
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    rays0 = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
    targs = (*tables, seed, rays0.origin, rays0.direction, pixel)
    kw = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=False, rr_start=cfg.rr_start, mesh=km)
    rad_k, nr_k = trace.trace_cuda(*targs, **kw)
    rad_p, nr_p = trace.trace_plain(*targs, **kw)
    torch.cuda.synchronize()
    diff = (rad_k - rad_p).abs()
    differ = (rad_k != rad_p).any(-1)
    within = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    sum_rel = float((rad_k.double().sum() - rad_p.double().sum()).abs() / rad_p.double().sum())
    k1_err = float(diff.max())
    print(f"[mesh:check] (b) kernel 1m on {n} primary rays: rays kernel {int(nr_k)} plain "
          f"{int(nr_p)}; lanes bit-equal {1 - float(differ.float().mean()):.6f} "
          f"({int(differ.sum())} differ: {differ.nonzero()[:8, 0].tolist()}), within 2e-6 "
          f"{within:.6f}, max abs err {k1_err:.3g}, sum rel {sum_rel:.3g}")
    check(int(nr_k) == int(nr_p), "kernel 1m and plain ray counts differ")
    check(int(differ.sum()) == 0, f"kernel 1m differs from its plain version on "
          f"{int(differ.sum())} lanes")

    # ---- (c) the split route (kernels 6, 8, 9, 10) through the entry point
    split = dataclasses.replace(cfg, fused=False, iters_per_launch=2)
    _, acc_c, st_c, launch_c, _, wall_c = run(2, split)
    per = 2 * cfg.max_depth
    print(f"[mesh] (c) split route spp=2: {wall_c:.3f} s, rays {st_c['rays_traced']}, launches "
          f"{launch_c}")
    check(launch_c == only(nearest_hit=per, occlusion=per, mesh_nearest=per, mesh_min=per),
          f"split route launches {launch_c}")
    check(st_c["rays_traced"] == st2["rays_traced"], "split route and megakernel ray counts differ")
    close_to(acc_c, acc2, 0.995, 2e-5, "(c) split route vs megakernel, 2 spp")

    # ---- (d) the pinned wavefront engine on kernel 2m; the state of one
    # mid-render super-step is kept for (e) and (f)
    captured = {}
    pinned = RenderConfig(wavefront=True, max_depth=8, nee=True, iters_per_launch=2)
    _, acc_d, st_d, launch_d, steps_d, wall_d = capturing_render(scene, 2, pinned, dev, captured)
    print(f"[mesh] (d) pinned wavefront spp=2: {wall_d:.3f} s, {steps_d} super-steps, rays "
          f"{st_d['rays_traced']}, launches {launch_d}")
    check(launch_d == only(bounce_mesh=steps_d), f"pinned engine launches {launch_d}")
    check(st_d["rays_traced"] == st2["rays_traced"], "pinned and megakernel ray counts differ")
    close_to(acc_d, acc2, 0.999, 1e-5, "(d) pinned vs megakernel, 2 spp")
    check(bool(captured), "no super-step state captured")

    # ---- (e) kernels 9 and 10 against their culled plain versions, bit for
    # bit, and the dense sweep (kernel and plain, no boxes) as the oracle
    def object_rays(o, d):
        return mesh.object_rays(Rays(o, d), tables[0], m0.geom_index)

    ico = load_obj(os.path.join(ROOT, "scenes", "assets", "ico.obj"))
    big = mesh.pack_tri_table(torch.from_numpy(displace_mesh(ico, 0.06, 4, "sin", 9.0)).to(dev))
    o_p, d_p = object_rays(rays0.origin, rays0.direction)
    o_m, d_m = object_rays(captured["origin"], captured["direction"])
    cases = {"primary, T=320": (m0.scan_table, m0.scan_boxes, o_p, d_p),
             f"super-step {CAPTURE_STEP}, T=320": (m0.scan_table, m0.scan_boxes, o_m, d_m),
             f"primary, T={big.numel() // 9} (file order)": (big, mesh.table_boxes(big), o_p, d_p)}
    k9_err = k10_err = 0.0
    for label, (tab, boxes, o, d) in cases.items():
        k9_err, k10_err = hold_mesh_kernels("[mesh:check] (e)", label, tab, boxes, o, d,
                                            k9_err, k10_err)

    # ---- (f) kernel 2m against its plain version: every output on every lane
    f32 = dict(dtype=torch.float32, device=dev)
    primary = dict(origin=rays0.origin, direction=rays0.direction,
                   throughput=torch.ones((n, 3), **f32), sample=pixel,
                   depth=torch.zeros(n, dtype=torch.int32, device=dev),
                   prev=torch.zeros(n, **f32), medium=torch.zeros((n, 4), **f32))
    k2_err = 0.0
    for label, s in (("primary", primary), (f"super-step {CAPTURE_STEP}", captured)):
        bargs = (tables, s["origin"], s["direction"], s["throughput"], s["sample"], s["depth"],
                 s["prev"], s["medium"], seed)
        got = bounce_fused.bounce_fused_cuda(*bargs, nee=True, mesh=km)
        want = bounce_fused.bounce_fused_plain(*bargs, nee=True, mesh=km)
        torch.cuda.synchronize()
        same = {f.name: torch.equal(getattr(got, f.name), getattr(want, f.name))
                for f in dataclasses.fields(got)}
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            k2_err = max(k2_err, float((getattr(got, f) - getattr(want, f)).abs().max()))
        print(f"[mesh:check] (f) kernel 2m (the block's sweep), {label}, "
              f"{s['origin'].shape[0]} lanes: outputs equal {same}; max abs err {k2_err:.3g}")
        check(all(same.values()), f"kernel 2m differs from its plain version ({label})")

    # ---- (g) the smooth_mesh_96 golden, rendered on the card
    gscene = dataclasses.replace(desc, resolution=(96, 96)).scene_for_frame(0, device=dev)
    gimg, _, _ = render(gscene, 16, cfg, device=dev)
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "smooth_mesh_96.png")))
    gdiff = (gimg.cpu() - png.float() / 255.0).abs()
    print(f"[mesh:golden] smooth_mesh_96: mean abs {float(gdiff.mean()) * 255:.4f}/255, max "
          f"{float(gdiff.max()) * 255:.4f}/255")
    check(float(gdiff.mean()) * 255 <= 0.8, "smooth_mesh_96 golden beyond its mean bar")

    # ---- (h) times by CUDA events, bounds from this run's inputs
    rcfg = resolve_features(cfg, scene.materials)
    acc0 = torch.zeros((n, 3), **f32)

    def iteration():
        render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables)

    iter_ms = cuda_ms(iteration, reps=5)
    summary = profile_step(iteration, iter_ms, out_dir, "mesh_iteration", ("trace_kernel",))
    k1_ms = cuda_ms(lambda: trace.trace_cuda(*targs, **kw), reps=10)
    k1_dev = [queued_ms(lambda: trace.trace_cuda(*targs, **kw)) for _ in range(2)]
    k1p_ms = cuda_ms(lambda: trace.trace_plain(*targs, **kw), reps=1)
    margs = (tables, captured["origin"], captured["direction"], captured["throughput"],
             captured["sample"], captured["depth"], captured["prev"], captured["medium"], seed)
    k2_ms = cuda_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, nee=True, mesh=km), reps=20)
    k2_dev = [queued_ms(lambda: bounce_fused.bounce_fused_cuda(*margs, nee=True, mesh=km))
              for _ in range(2)]
    k2p_ms = cuda_ms(lambda: bounce_fused.bounce_fused_plain(*margs, nee=True, mesh=km), reps=1)
    k2_work = mesh_bounce_work(tables, km, captured, seed)
    mt = time_mesh_kernels(m0.scan_table, m0.scan_boxes, mesh.mesh_chunk_boxes(m0, pad=False),
                           o_p, d_p)

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE if t == 1 else 0)
                for t in types)
    mesh_ops = OPS_MESH_RAY + OPS_AABB * km.aabb.numel() // 6  # per lane-bounce, a lower bound

    def tri_tests(o, d):  # the triangles the sweep tests for these rays, from its plain version
        reached = mesh_sweep(km, tables[0], o.unbind(-1), d.unbind(-1))["reached"]
        return int(reached.sum()) * MESH_CHUNK

    k1_tris = tri_tests(rays0.origin, rays0.direction)  # bounce 0 only: a lower bound
    table_bytes = sum(t.numel() * 4 for t in tables) + sum(
        t.numel() * 4 for t in (km.tri, km.aabb, km.norm, km.desc))
    lane_bounces = int(nr_k) // 2
    k1_bound = bound(lane_bounces * (sweep + OPS_SHADE + mesh_ops) + k1_tris * OPS_MT,
                     n * (12 + 12 + 4 + 12) + table_bytes)
    # the bounce's triangle sweeps are counted by mesh_bounce_work
    k2_bound = bound(n * (sweep + OPS_SHADE + OPS_MESH_RAY) + k2_work["slab"] * OPS_AABB
                     + k2_work["pairs"] * OPS_MT, n * (64 + 73) + table_bytes)
    print(f"[card] {card}")
    print(f"[mesh:profile] render iteration: {summary}")
    print(
        f"[mesh:time] iteration {iter_ms:.4f} ms ({int(nr_k) / iter_ms / 1e3:.1f} Mrays/s); kernel "
        f"1m {k1_ms:.4f} ms/iteration by events, {k1_dev[0]:.4f} / {k1_dev[1]:.4f} ms of device "
        f"time (two repeats; {int(nr_k) / k1_dev[0] / 1e3:.1f} Mrays/s; {lane_bounces / n:.4f} "
        f"bounces per lane of {cfg.max_depth}; plain {k1p_ms:.3f} "
        f"ms), bound {k1_bound[0]:.4f} ms by {k1_bound[1]} (a lower bound: the analytic part, "
        f"the chunk-box tests and the {k1_tris} triangle tests of bounce 0, not those of later "
        f"bounces or of shadow rays); kernel 2m {k2_ms:.4f} ms by events at {n} lanes of "
        f"super-step {CAPTURE_STEP}, {k2_dev[0]:.4f} / {k2_dev[1]:.4f} ms of device time (queued, "
        f"twice; plain {k2p_ms:.3f} ms), bound {k2_bound[0]:.4f} ms by {k2_bound[1]} "
        f"({k2_work['slab']} slab tests and {k2_work['pairs']} triangle tests, "
        f"{k2_work['shadow_rays']} shadow rays swept, {k2_work['blocked']} of them blocked by the "
        f"mesh and counted as none: a lower bound; {k2_work['lanes_reaching']:.4f} of lanes and "
        f"{k2_work['warps_reaching']:.4f} of warps reach a chunk, at most "
        f"{k2_work['most_chunks']} chunks for one lane); on {card}"
    )
    check(k2_bound[0] < k2_dev[0], "kernel 2m's counted bound reads above its time")
    print_mesh_times("[mesh:time]", f"smooth_mesh's {n} primary rays x 320 triangles", mt, card)
    print(f"[mesh:regs] {mesh_kernel_resources(reports)}")

    # ---- (i) the CLI on smooth_mesh takes the megakernel
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/smooth_mesh.txt",
         "--spp", "2", "--out", os.path.join(out_dir, "cli_smooth_mesh.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[mesh:cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0 and "engine=megakernel" in cli.stdout, "mesh CLI run failed")

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "trace_mesh", **common, "source": "pathtracer_tpu_torch/csrc/trace.cu",
         "replaces": "pathtracer_tpu/ops/trace_pallas.py:62", "launches": launches["trace_mesh"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1p_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1]},
        {"name": "bounce_mesh", **common, "source": "pathtracer_tpu_torch/csrc/bounce.cu",
         "replaces": "pathtracer_tpu/ops/bounce_pallas.py:1477",
         "launches": launch_d["bounce_mesh"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2p_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1]},
        {"name": "mesh_nearest", **common, "source": "pathtracer_tpu_torch/csrc/mesh.cu",
         "replaces": "pathtracer_tpu/ops/mesh_pallas.py:88",
         "launches": launch_c["mesh_nearest"], "max_abs_err": k9_err, "ms": mt["9"]["ms"],
         "plain_ms": mt["9"]["plain_ms"], "bound_ms": mt["9"]["bound"][0],
         "bound_by": mt["9"]["bound"][1]},
        {"name": "mesh_min", **common, "source": "pathtracer_tpu_torch/csrc/mesh.cu",
         "replaces": "pathtracer_tpu/ops/mesh_pallas.py:107",
         "launches": launch_c["mesh_min"], "max_abs_err": k10_err, "ms": mt["10"]["ms"],
         "plain_ms": mt["10"]["plain_ms"], "bound_ms": mt["10"]["bound"][0],
         "bound_by": mt["10"]["bound"][1]},
    ]


VOL_RES = (512, 512)  # bench.py's sss row
VOL_SPP = 32
# fp32 operations of the media blocks per lane-bounce, counted by hand from
# trace_common.cuh: the free path (log, divide, compare: 8), the segment's
# attenuation (3 exp, 6 multiply: 9) and the surface event's medium switch
# (8); an in-medium scatter or its light connection is data-dependent and
# left out, so the bounds below stay lower bounds
OPS_VOL = 25


def ptxas_instances(reports: dict) -> dict:
    """``{(source, mangled entry): (registers, spill store bytes, spill load
    bytes)}`` from ``_build.build_all``'s ptxas reports."""
    import re

    out = {}
    for name, report in reports.items():
        entry = spill = None
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                out[(name, entry)] = (int(m.group(1)), *(spill or (0, 0)))
                entry = spill = None
    return out


# The kernel instances whose registers this script reads (instance_regs:
# source, kernel, template flags) and the kernel names its profiles match:
# [build] checks each against the symbols the build compiled, so that a
# renamed kernel or a dropped instance fails there, by its name.
EXPECTED_INSTANCES = (
    *(("trace", "trace_kernel", f) for f in (
        (0, 0, 0, 0), (0, 1, 0, 0), (0, 1, 1, 0), (1, 1, 0, 0), (1, 1, 1, 0), (0, 0, 0, 1),
        (0, 1, 0, 1), (0, 1, 1, 1), (1, 0, 0, 1), (1, 1, 0, 1), (1, 1, 1, 1))),
    *(("bounce", "bounce_kernel", f) for f in (
        (0, 0, 0, 0, 0), (0, 1, 0, 0, 0), (0, 1, 1, 0, 0), (0, 0, 0, 1, 0), (0, 1, 0, 1, 0),
        (0, 1, 1, 1, 0), (1, 0, 0, 1, 0), (1, 1, 0, 1, 0), (1, 1, 1, 1, 0), (0, 0, 0, 1, 1),
        (0, 1, 0, 1, 1), (0, 1, 1, 1, 1), (1, 0, 0, 1, 1), (1, 1, 0, 1, 1), (1, 1, 1, 1, 1))),
    ("bounce", "bounce_kernel_grouped", ()),
    *(("bounce_merge", "bounce_merge_kernel", f) for f in (
        (0, 0, 0, 0), (0, 0, 1, 0), (0, 0, 1, 1), (1, 0, 0, 0), (1, 1, 0, 0), (1, 0, 1, 0),
        (1, 1, 1, 0), (1, 0, 1, 1), (1, 1, 1, 1))),
    *(("bounce_grad", "bounce_bwd_kernel", f) for f in ((0, 0), (1, 0), (0, 1), (1, 1))),
    *(("trace_grad", "trace_bwd_kernel", f) for f in ((0, 0), (1, 0), (0, 1), (1, 1))),
    *(("trace_grad", "trace_fwd_kernel", f) for f in ((0, 1), (1, 1))),
    *(("trace_grad", "trace_fwd_kernel_packed", f) for f in ((0, 0), (1, 0))),
)
PROFILED_NAMES = ("trace_kernel", "bounce_kernel", "bounce_merge_kernel", "bounce_bwd_kernel",
                  "trace_fwd_kernel", "trace_fwd_kernel_packed", "trace_bwd_kernel", "row_sum",
                  "lane_order", "nearest_kernel", "winner_kernel", "occlusion_kernel",
                  "mesh_nearest_kernel", "mesh_min_kernel")


# the design of kernel 2's analytic media and surface instances, in the
# JSON entries that run them: 2r-v groups its lanes by event, the others
# keep one lane per thread (grouping measured slower there, PERF.md)
KERNEL2_GROUPED = ("grouped on every launch: each 128-lane block's lanes shaded in the order of "
                   "the event their nearest hit gives (csrc/bounce.cu:bounce_kernel_grouped)")
KERNEL2_PER_LANE = "one lane per thread, in index order (csrc/bounce.cu:bounce_kernel)"


def missing_kernels(reports: dict) -> list:
    """The entries of :data:`EXPECTED_INSTANCES` and :data:`PROFILED_NAMES`
    that no compiled symbol holds, from ``_build.build_all``'s ptxas reports.
    A source reused from an earlier build reports nothing: its instances are
    not checked, nor the profiled names then (:func:`unchecked_sources`)."""
    instances = ptxas_instances(reports)
    built = {src for src, _ in instances}
    missing = [f"{src}:{kernel}" + (f"<{','.join(str(int(f)) for f in flags)}>" if flags else "")
               for src, kernel, flags in EXPECTED_INSTANCES
               if src in built and instance_regs(instances, src, kernel, *flags) is None]
    if all(report for report in reports.values()):
        missing += [name for name in PROFILED_NAMES
                    if not any(name in entry for _, entry in instances)]
    return missing


def unchecked_sources(reports: dict) -> list:
    """The sources of ``_build.build_all``'s reports that were reused from
    an earlier build: no ptxas report, so :func:`missing_kernels` cannot
    check their kernels."""
    return sorted(name for name, report in reports.items() if not report)


def instance_regs(instances: dict, source: str, kernel: str, *flags: bool):
    """Registers and spills of the instance of ``trace_kernel`` /
    ``bounce_kernel`` with these template flags (``kMesh, kVol, kHg,
    kSurf[, kTex]``), or of the kernel ``kernel`` that is no template when
    no flags are given; None when the report has no such entry (a library
    reused from an earlier build prints none)."""
    tag = "I" + "".join(f"Lb{int(b)}E" for b in flags) + "E" if flags else "E"
    for (src, entry), regs in instances.items():
        if src == source and f"{kernel}{tag}" in entry:
            return regs
    return None


def vol_phase(dev, card: str, out_dir: str, reports: dict, cornell_ms: float) -> list:
    """Phase 10, ``[vol]``: participating media.  sss at ``bench.py``'s
    width on the megakernel (kernel 1's hg instance), kernel 1 against its
    plain version on sss, fog and glass_dof, the wavefront engines and the
    split route on sss and fog, kernel 2's vol and hg instances, kernel 1m
    with the triangle split, the sss_96 and glass_dof_128 goldens, times and
    bounds, the CLI.  Returns the JSON entries of the new instances."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, trace
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.mesh_tables import MESH_CHUNK, mesh_sweep
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import features_for_materials
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
    from pathtracer_tpu_torch.scene.variants import fog_mesh_scene
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    scenes_dir = os.path.join(ROOT, "scenes")

    def scene_of(name, res=None):
        if name.startswith("fog_mesh"):
            desc = parse_scene_text(fog_mesh_scene(name.endswith("glass")), name=name,
                                    scene_dir=scenes_dir)
        else:
            desc = load_scene(os.path.join(scenes_dir, f"{name}.txt"))
        if res is not None:
            desc = dataclasses.replace(desc, resolution=res)
        return desc.scene_for_frame(0, device=dev)

    base = dict(max_depth=8, nee=True)
    seed = key_to_seed(prng_key(0))
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- (a) sss through the entry point at bench.py's width: kernel 1's
    # hg instance once per iteration and nothing else
    sss = scene_of("sss", VOL_RES)
    w, h = sss.camera.width, sss.camera.height
    cfg = RenderConfig(iters_per_launch=8, **base)
    img, acc, st, launch_a, _, wall_a = counted_render(sss, VOL_SPP, cfg, dev)
    feats = features_for_materials(sss.materials)
    print(f"[vol] (a) sss {w}x{h} d8 nee spp={VOL_SPP}, features {feats}: {wall_a:.3f} s, rays "
          f"{st['rays_traced']}, launches {launch_a}")
    check(launch_a == only(trace_hg=VOL_SPP), f"sss megakernel launches {launch_a}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
          and bool((acc >= 0).all()) and float(acc.sum()) > 0, "sss render: bad image")
    save_image(os.path.join(out_dir, "chip_smoke_sss.png"), img.cpu().numpy())

    # ---- (b) kernel 1 against its plain version on every lane: sss (hg),
    # fog (volumetric NEE), glass_dof at its own 800x800 (Beer-Lambert only)
    def primary(scene):
        n = scene.camera.width * scene.camera.height
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        return rays, pixel

    trace_args = {}
    k1_err = {}
    for name, scene in (("sss", sss), ("fog", scene_of("fog")), ("glass_dof", scene_of("glass_dof")),
                        ("fog_mesh_glass", scene_of("fog_mesh_glass")),
                        ("fog_mesh_opaque", scene_of("fog_mesh_opaque"))):
        tables = [t.contiguous() for t in pack_tables(scene)]
        rays, pixel = primary(scene)
        kw = dict(max_depth=8, nee=True, rr=False, rr_start=3, mesh=scene.mesh_tables,
                  features=frozenset(features_for_materials(scene.materials)))
        targs = (*tables, seed, rays.origin, rays.direction, pixel)
        rad_k, nr_k = trace.trace_cuda(*targs, **kw)
        rad_p, nr_p = trace.trace_plain(*targs, **kw)
        torch.cuda.synchronize()
        differ = (rad_k != rad_p).any(-1)
        k1_err[name] = float((rad_k - rad_p).abs().max())
        tag = "(e) kernel 1m" if scene.meshes else "(b) kernel 1"
        print(f"[vol:check] {tag} on {name} ({sorted(kw['features'])}), {pixel.numel()} primary "
              f"rays: rays kernel {int(nr_k)} plain {int(nr_p)}; lanes that differ "
              f"{int(differ.sum())}; max abs err {k1_err[name]:.3g}; radiance sum "
              f"{float(rad_k.double().sum()):.6g}")
        check(int(nr_k) == int(nr_p), f"kernel 1 and plain ray counts differ on {name}")
        check(int(differ.sum()) == 0, f"kernel 1 differs from plain on {name}")
        check(float(rad_p.sum()) > 0, f"{name}: no radiance")
        trace_args[name] = (scene, targs, kw, int(nr_k))

    # ---- (c) the wavefront engines and the split route against the
    # megakernel, 2 spp; the state of super-step CAPTURE_STEP is kept for (d)
    captured = {}
    engine_launch = {}
    for name, res in (("sss", VOL_RES), ("fog", None)):
        scene = sss if name == "sss" else trace_args["fog"][0]
        hg = "hg" in features_for_materials(scene.materials)
        inst = "hg" if hg else "vol"
        mega_cfg = RenderConfig(iters_per_launch=2, **base)
        _, acc_m, st_m, launch_m, _, wall_m = counted_render(scene, 2, mega_cfg, dev)
        check(launch_m == only(**{f"trace_{inst}": 2}), f"{name} megakernel launches {launch_m}")
        engine_launch[f"trace_{inst}"] = launch_m[f"trace_{inst}"]
        cap = {}
        runs = (("pinned", RenderConfig(wavefront=True, iters_per_launch=2, **base)),
                ("queue", RenderConfig(wavefront=True, wavefront_pinned=False,
                                       wavefront_capacity=1 << 16, iters_per_launch=2, **base)),
                ("split", RenderConfig(fused=False, iters_per_launch=2, **base)))
        for engine, ecfg in runs:
            if engine == "pinned":
                _, acc_e, st_e, launch_e, steps, wall_e = capturing_render(scene, 2, ecfg, dev, cap)
            else:
                _, acc_e, st_e, launch_e, steps, wall_e = counted_render(scene, 2, ecfg, dev)
            print(f"[vol] (c) {name} {engine}, spp=2: {wall_e:.3f} s, {steps} super-steps, rays "
                  f"{st_e['rays_traced']}, launches {launch_e}")
            if engine == "split":
                per = 2 * 8  # a bounce of each path slot: 2 spp x depth 8
                check(launch_e == only(nearest_hit=per, occlusion=per),
                      f"{name} split route launches {launch_e}")
            else:
                check(launch_e == only(**{f"bounce_{inst}": steps}),
                      f"{name} {engine} launches {launch_e}")
                engine_launch.setdefault(f"bounce_{inst}", launch_e[f"bounce_{inst}"])
            check(st_e["rays_traced"] == st_m["rays_traced"],
                  f"{name} {engine} and megakernel ray counts differ")
            check_close("vol", acc_e, acc_m, 0.999, 2e-5, f"(c) {name} {engine} vs megakernel")
        check(bool(cap), f"{name}: no super-step state captured")
        in_medium = int((cap["medium"][:, 3] > 0).sum())
        print(f"[vol:check] {name} super-step {CAPTURE_STEP}: {cap['medium'].shape[0]} lanes, "
              f"{in_medium} inside a scattering medium")
        check(in_medium > 0, f"{name}: no lane of super-step {CAPTURE_STEP} is in a medium")
        captured[name] = cap

    # ---- (d) kernel 2's vol and hg instances against bounce_fused_plain on
    # every lane: primary rays and the captured super-steps (sss's state
    # runs both instances: its first four medium columns feed the vol one)
    k2_err = {"vol": 0.0, "hg": 0.0}
    sss_tables = [t.contiguous() for t in pack_tables(sss)]
    fog_tables = [t.contiguous() for t in pack_tables(trace_args["fog"][0])]
    rays0, pixel0 = primary(sss)
    n0 = pixel0.numel()
    prim = dict(origin=rays0.origin, direction=rays0.direction,
                throughput=torch.ones((n0, 3), **f32), sample=pixel0,
                depth=torch.zeros(n0, dtype=torch.int32, device=dev),
                prev=torch.zeros(n0, **f32), medium=torch.zeros((n0, 5), **f32))
    cases = [("hg", "sss primary", sss_tables, prim),
             ("hg", f"sss super-step {CAPTURE_STEP}", sss_tables, captured["sss"]),
             ("vol", f"sss super-step {CAPTURE_STEP}", sss_tables, captured["sss"]),
             ("vol", f"fog super-step {CAPTURE_STEP}", fog_tables, captured["fog"])]
    bargs = {}
    for inst, label, tables, s in cases:
        feats2 = frozenset({"volumetric", "hg"} if inst == "hg" else {"volumetric"})
        med = s["medium"] if inst == "hg" else s["medium"][:, :4].contiguous()
        args = (tables, s["origin"], s["direction"], s["throughput"], s["sample"], s["depth"],
                s["prev"], med, seed)
        got = bounce_fused.bounce_fused_cuda(*args, nee=True, features=feats2)
        want = bounce_fused.bounce_fused_plain(*args, nee=True, features=feats2)
        torch.cuda.synchronize()
        same = {f.name: torch.equal(getattr(got, f.name), getattr(want, f.name))
                for f in dataclasses.fields(got)}
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            k2_err[inst] = max(k2_err[inst], float((getattr(got, f) - getattr(want, f)).abs().max()))
        changed = int((want.next_medium != med).any(-1).sum())
        print(f"[vol:check] (d) kernel 2 {inst}, {label}, {med.shape[0]} lanes ({changed} change "
              f"medium): outputs equal {same}")
        check(all(same.values()), f"kernel 2 {inst} differs from plain ({label})")
        if "super-step" in label:  # the first such state of each instance is timed in (g)
            bargs.setdefault(inst, (args, feats2, label))

    # ---- (f) the sss_96 and glass_dof_128 goldens on the card
    gimg, gacc, _ = render(scene_of("sss", (96, 96)), 24,
                           RenderConfig(iters_per_launch=8, **base), device=dev)
    golden = torch.from_numpy(np.load(os.path.join(ROOT, "tests", "golden", "sss_96.npy"))).to(dev)
    frac = float(((gacc - golden).abs() <= 1e-5 * (golden.abs() + 1e-3)).float().mean())
    gsum = float((gacc.double().sum() - golden.double().sum()).abs() / golden.double().sum())
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "sss_96.png"))).to(dev)
    png_mean = float((gimg - png.float() / 255.0).abs().mean()) * 255.0
    print(f"[vol:golden] sss_96: {frac:.5f} of entries within 1e-5 rel, sum rel {gsum:.3g}, "
          f"PNG mean abs {png_mean:.4f}/255")
    check(frac >= 0.95 and gsum <= 2e-5 and png_mean <= 0.8, "sss_96 golden beyond its bar")
    gimg, _, _ = render(scene_of("glass_dof", (128, 128)), 32,
                        RenderConfig(iters_per_launch=8, **base), device=dev)
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "glass_dof_128.png")))
    gdiff = (gimg.cpu() - png.float() / 255.0).abs()
    print(f"[vol:golden] glass_dof_128: PNG mean abs {float(gdiff.mean()) * 255:.4f}/255, max "
          f"{float(gdiff.max()) * 255:.4f}/255")
    check(float(gdiff.mean()) * 255 <= 0.8, "glass_dof_128 golden beyond its mean bar")

    # ---- (e) kernel 1m's vol instance through the entry point
    fm = trace_args["fog_mesh_glass"][0]
    _, acc_e, _, launch_e, _, _ = counted_render(fm, 2, RenderConfig(iters_per_launch=2, **base),
                                                 dev)
    print(f"[vol] (e) fog_mesh_glass megakernel spp=2: launches {launch_e}")
    check(launch_e == only(trace_mesh_vol=2) and bool(torch.isfinite(acc_e).all()),
          f"fog_mesh megakernel launches {launch_e}")
    engine_launch["trace_mesh_vol"] = launch_e["trace_mesh_vol"]

    # ---- (g) times by CUDA events, bounds from this run's inputs, registers
    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    def sweep_ops(scene):
        return sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE if t == 1 else 0)
                   for t in scene.geoms.type.tolist())

    timing = {}
    for key, name in (("trace_hg", "sss"), ("trace_vol", "glass_dof"),
                      ("trace_mesh_vol", "fog_mesh_glass")):
        scene, targs, kw, nrays = trace_args[name]
        ms = cuda_ms(lambda: trace.trace_cuda(*targs, **kw), reps=10)
        p_ms = cuda_ms(lambda: trace.trace_plain(*targs, **kw), reps=1)
        n = targs[5].shape[0]
        tbytes = sum(t.numel() * 4 for t in targs[:4])
        lane_bounces = nrays // 2
        ops = lane_bounces * (sweep_ops(scene) + OPS_SHADE + OPS_VOL)
        if scene.meshes:  # the triangle tables, read once, and [mesh]'s count of their tests
            km = scene.mesh_tables
            tbytes += sum(t.numel() * 4 for t in (km.tri, km.aabb, km.norm, km.desc))
            reached = mesh_sweep(km, targs[0], targs[5].unbind(-1), targs[6].unbind(-1))["reached"]
            ops += (lane_bounces * (OPS_MESH_RAY + OPS_AABB * km.aabb.numel() // 6)
                    + int(reached.sum()) * MESH_CHUNK * OPS_MT)
        timing[key] = (ms, p_ms, bound(ops, n * (12 + 12 + 4 + 12) + tbytes), name, n,
                       f"; {lane_bounces / n:.4f} bounces per lane of {kw['max_depth']}")
    device = {}
    for inst in ("vol", "hg"):
        args, feats2, label = bargs[inst]
        n = args[1].shape[0]
        mw = args[7].shape[1]
        ms = cuda_ms(lambda: bounce_fused.bounce_fused_cuda(*args, nee=True, features=feats2),
                     reps=20)
        d_ms = queued_ms(lambda: bounce_fused.bounce_fused_cuda(*args, nee=True,
                                                                features=feats2))
        p_ms = cuda_ms(lambda: bounce_fused.bounce_fused_plain(*args, nee=True, features=feats2),
                       reps=2)
        tbytes = sum(t.numel() * 4 for t in args[0])
        # 12 planes and the medium in, 14 float planes, the medium and the
        # terminate byte out
        timing[f"bounce_{inst}"] = (ms, p_ms, bound(n * (sweep_ops(sss) + OPS_SHADE + OPS_VOL),
                                                    n * (48 + 4 * mw + 57 + 4 * mw) + tbytes),
                                    label, n, f"; {d_ms:.4f} ms of device time (queued)")
        device[f"bounce_{inst}"] = d_ms
    rcfg = dataclasses.replace(cfg, features=tuple(feats))
    acc0 = torch.zeros((n0, 3), **f32)
    iter_ms = cuda_ms(lambda: render_chunk(sss, acc0, 0, seed, rcfg, 1, tables=sss_tables),
                      reps=5)
    summary = profile_step(lambda: render_chunk(sss, acc0, 0, seed, rcfg, 1, tables=sss_tables),
                           iter_ms, out_dir, "sss_iteration", ("trace_kernel",))
    instances = ptxas_instances(reports)
    regs = {
        "trace": instance_regs(instances, "trace", "trace_kernel", 0, 0, 0, 0),
        "trace_vol": instance_regs(instances, "trace", "trace_kernel", 0, 1, 0, 0),
        "trace_hg": instance_regs(instances, "trace", "trace_kernel", 0, 1, 1, 0),
        "trace_mesh_vol": instance_regs(instances, "trace", "trace_kernel", 1, 1, 0, 0),
        "trace_mesh_hg": instance_regs(instances, "trace", "trace_kernel", 1, 1, 1, 0),
        "bounce": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 0, 0),
        "bounce_vol": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 0, 0, 0),
        "bounce_hg": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 1, 0, 0),
    }
    print(f"[card] {card}")
    print(f"[vol:regs] registers, spill store / load bytes per instance: {regs}")
    check(regs["trace"] is None or regs["trace"][:2] == TRACE_CORNELL_REGS,
          f"Cornell's kernel 1 uses {regs['trace']} registers and spill bytes, not "
          f"{TRACE_CORNELL_REGS}")
    print(f"[vol:time] sss iteration {iter_ms:.4f} ms ({trace_args['sss'][3] / iter_ms / 1e3:.1f} "
          f"Mrays/s); Cornell's kernel 1 {cornell_ms:.4f} ms/iteration in this run; on {card}")
    print(f"[vol:profile] sss render iteration: {summary}")
    for key, (ms, p_ms, (b_ms, b_by), where, n, per_lane) in timing.items():
        print(f"[vol:time] {key} at {n} lanes of {where}: {ms:.4f} ms{per_lane} (plain "
              f"{p_ms:.3f} ms), "
              f"bound {b_ms:.4f} ms by {b_by} (a lower bound: in-medium scatters, light "
              f"connections, shadow rays and triangle tests after bounce 0 left out); on {card}")

    # ---- (h) the CLI on sss takes the megakernel
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/sss.txt",
         "--spp", "2", "--out", os.path.join(out_dir, "cli_sss.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[vol:cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0 and "engine=megakernel" in cli.stdout, "sss CLI run failed")

    launches = {**engine_launch, "trace_hg": launch_a["trace_hg"]}  # (a) is the main path
    common = {"route": "cuda", "library_ms": None}
    entries = []
    for key, source, replaces, err in (
        ("trace_hg", "trace.cu", "pathtracer_tpu/ops/trace_pallas.py:62", k1_err["sss"]),
        ("trace_vol", "trace.cu", "pathtracer_tpu/ops/trace_pallas.py:62",
         max(k1_err["fog"], k1_err["glass_dof"])),
        ("trace_mesh_vol", "trace.cu", "pathtracer_tpu/ops/trace_pallas.py:62",
         max(k1_err["fog_mesh_glass"], k1_err["fog_mesh_opaque"])),
        ("bounce_vol", "bounce.cu", "pathtracer_tpu/ops/bounce_pallas.py:1477", k2_err["vol"]),
        ("bounce_hg", "bounce.cu", "pathtracer_tpu/ops/bounce_pallas.py:1477", k2_err["hg"]),
    ):
        ms, p_ms, (b_ms, b_by), _, _, _ = timing[key]
        entries.append({"name": key, **common, "source": f"pathtracer_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches[key], "max_abs_err": err,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
        if key in device:
            entries[-1].update(device_ms=device[key], design=KERNEL2_PER_LANE)
    return entries


SURF_RES = (512, 512)  # bench.py's ward and textured_image rows
SURF_SPP = 32
SCAN_CAPTURE_DEPTH = 3  # the bounce of the textured_image scan whose inputs (d) holds 2t on
# fp32 operations of the texture block per lane-bounce, counted by hand from
# trace_common.cuh:texture_albedo (3 multiplies, 3 floors, 2 adds, 2 floor-mods
# of 3 each, 6 compares and selects: 20); the bump, the Cook-Torrance and Ward
# lobes and the deferred texel's UV run only on the lanes whose material
# selects them and are left out, so the bounds below are lower bounds
OPS_TEXTURE = 20


def surf_phase(dev, card: str, out_dir: str, reports: dict, cornell_ms: float) -> list:
    """Phase 11, ``[surf]``: optional surface physics.  ward at
    ``bench.py``'s width on the megakernel (kernel 1s), kernel 1s against
    its plain version on ward, its GGX copy, textured and its striped copy;
    textured_image through ``render`` (kernel 2t once per bounce of the
    scan) and kernel 2t against its plain version; the wavefront engines and
    the split route on the three scenes, and kernel 2s; the ward_96 and
    textured_image_96 goldens; times, bounds and registers; the CLI.
    Returns the JSON entries of the new kernels."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, trace
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import megakernel
    from pathtracer_tpu_torch.render.features import features_for_materials
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
    from pathtracer_tpu_torch.scene.variants import (
        ggx_ward_scene,
        milky_ward_scene,
        striped_scene,
    )
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    scenes_dir = os.path.join(ROOT, "scenes")

    def scene_of(name, res=None):
        if name == "ggx_ward":
            desc = parse_scene_text(ggx_ward_scene(), name=name)
        elif name == "milky_ward":
            desc = parse_scene_text(milky_ward_scene(), name=name, scene_dir=scenes_dir)
        elif name == "striped":
            desc = parse_scene_text(striped_scene(), name=name, scene_dir=scenes_dir)
        else:
            desc = load_scene(os.path.join(scenes_dir, f"{name}.txt"))
        if res is not None:
            desc = dataclasses.replace(desc, resolution=res)
        return desc.scene_for_frame(0, device=dev)

    base = dict(max_depth=8, nee=True)
    seed = key_to_seed(prng_key(0))
    f32 = dict(dtype=torch.float32, device=dev)

    def feats_of(scene):
        return frozenset(features_for_materials(scene.materials))

    def tables_of(scene):
        return [t.contiguous() for t in pack_tables(scene)]

    def primary(scene):
        """The primary rays of iteration 0 and the bounce state they start."""
        n = scene.camera.width * scene.camera.height
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        return dict(origin=rays.origin, direction=rays.direction,
                    throughput=torch.ones((n, 3), **f32), sample=pixel,
                    depth=torch.zeros(n, dtype=torch.int32, device=dev),
                    prev=torch.zeros(n, **f32), medium=torch.zeros((n, 4), **f32))

    # ---- (a) ward through the entry point at bench.py's width: kernel 1s
    # once per iteration and nothing else
    ward = scene_of("ward", SURF_RES)
    w, h = ward.camera.width, ward.camera.height
    cfg = RenderConfig(iters_per_launch=8, **base)
    img, acc, st, launch_a, _, wall_a = counted_render(ward, SURF_SPP, cfg, dev)
    print(f"[surf] (a) ward {w}x{h} d8 nee spp={SURF_SPP}, features {sorted(feats_of(ward))}: "
          f"{wall_a:.3f} s, rays {st['rays_traced']}, launches {launch_a}")
    check(launch_a == only(trace_surf=SURF_SPP), f"ward megakernel launches {launch_a}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
          and bool((acc >= 0).all()) and float(acc.sum()) > 0, "ward render: bad image")
    save_image(os.path.join(out_dir, "chip_smoke_ward.png"), img.cpu().numpy())

    # ---- (a)-(c) kernel 1s against its plain version on every primary lane:
    # ward (the Ward lobes), its GGX copy (a Cook-Torrance lane beside the
    # Ward ones), textured at its 800x800 (checker, bump) and its striped copy
    trace_args = {}
    k1_err = 0.0
    for tag, name, scene in (("(a)", "ward", ward),
                             ("(b)", "ggx_ward", scene_of("ggx_ward", SURF_RES)),
                             ("(c)", "textured", scene_of("textured")),
                             ("(c)", "striped", scene_of("striped"))):
        p = primary(scene)
        kw = dict(max_depth=8, nee=True, rr=False, rr_start=3, features=feats_of(scene))
        targs = (*tables_of(scene), seed, p["origin"], p["direction"], p["sample"])
        zero_counts()
        rad_k, nr_k = trace.trace_cuda(*targs, **kw)
        launched = read_counts()
        rad_p, nr_p = trace.trace_plain(*targs, **kw)
        torch.cuda.synchronize()
        differ = (rad_k != rad_p).any(-1)
        k1_err = max(k1_err, float((rad_k - rad_p).abs().max()))
        print(f"[surf:check] {tag} kernel 1s on {name} ({sorted(kw['features'])}, bits "
              f"{trace.surface_bits(kw['features'])}), {p['sample'].numel()} primary rays: rays "
              f"kernel {int(nr_k)} plain {int(nr_p)}; lanes that differ {int(differ.sum())}; "
              f"radiance sum {float(rad_k.double().sum()):.6g}")
        check(launched == only(trace_surf=1), f"kernel 1s launches {launched} on {name}")
        check(int(nr_k) == int(nr_p), f"kernel 1s and plain ray counts differ on {name}")
        check(int(differ.sum()) == 0, f"kernel 1s differs from plain on {name}")
        check(float(rad_p.sum()) > 0, f"{name}: no radiance")
        trace_args[name] = (scene, targs, kw, int(nr_k))

    # ---- (d) textured_image through the entry point: its megakernel route is
    # the per-bounce scan, kernel 2t once per bounce (8 per iteration); the
    # inputs of one mid-render bounce are kept
    timg = scene_of("textured_image", SURF_RES)
    captured = {}
    shade = megakernel.shade_bounce

    def recording(scn, rays, thr, sample, depth, prev, seed_, cfg_, medium_sigma=None,
                  tables=None):
        if depth == SCAN_CAPTURE_DEPTH and not captured:
            captured.update(origin=rays.origin.clone(), direction=rays.direction.clone(),
                            throughput=thr.clone(), sample=sample.clone(),
                            depth=torch.full(sample.shape, depth, dtype=torch.int32, device=dev),
                            prev=prev.clone(), medium=medium_sigma.clone())
        return shade(scn, rays, thr, sample, depth, prev, seed_, cfg_,
                     medium_sigma=medium_sigma, tables=tables)

    megakernel.shade_bounce = recording
    try:
        img_d, acc_d, st_d, launch_d, _, wall_d = counted_render(timg, SURF_SPP, cfg, dev)
    finally:
        megakernel.shade_bounce = shade
    print(f"[surf] (d) textured_image {SURF_RES[0]}x{SURF_RES[1]} d8 nee spp={SURF_SPP}: "
          f"{wall_d:.3f} s, rays {st_d['rays_traced']}, launches {launch_d}")
    check(launch_d == only(bounce_tex=8 * SURF_SPP), f"textured_image launches {launch_d}")
    check(bool(torch.isfinite(acc_d).all()) and bool((acc_d >= 0).all())
          and float(acc_d.sum()) > 0, "textured_image render: bad image")
    check(bool(captured), "no scan bounce captured")
    save_image(os.path.join(out_dir, "chip_smoke_textured_image.png"), img_d.cpu().numpy())

    k2_err = {"surf": 0.0, "tex": 0.0}
    bargs = {}

    def hold_bounce(inst, label, scene, s):
        """Kernel 2s (2t) against its plain version on the bounce state
        ``s``: every output plane equal on every lane."""
        tex = inst == "tex"
        feats = feats_of(scene)
        args = (tables_of(scene), s["origin"], s["direction"], s["throughput"], s["sample"],
                s["depth"], s["prev"], s["medium"].contiguous(), seed)
        zero_counts()
        got = bounce_fused.bounce_fused_cuda(*args, nee=True, features=feats, tex_defer=tex)
        launched = read_counts()
        want = bounce_fused.bounce_fused_plain(*args, nee=True, features=feats, tex_defer=tex)
        torch.cuda.synchronize()
        same, extra = {}, ""
        if tex:
            same = {k: torch.equal(a, b) for k, a, b in zip(("u", "v", "slot"), got[1:], want[1:])}
            extra = f" ({int((want[3] >= 0).sum())} image-textured surface events)"
            got, want = got[0], want[0]
        same.update({f.name: torch.equal(getattr(got, f.name), getattr(want, f.name))
                     for f in dataclasses.fields(got)})
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            k2_err[inst] = max(k2_err[inst],
                               float((getattr(got, f) - getattr(want, f)).abs().max()))
        print(f"[surf:check] kernel 2{inst[0]} on {label}, {s['origin'].shape[0]} lanes{extra}: "
              f"outputs equal {same}")
        check(launched == only(**{f"bounce_{inst}": 1}), f"kernel 2{inst[0]} launches {launched}")
        check(all(same.values()), f"kernel 2{inst[0]} differs from plain ({label})")
        if "primary" not in label:  # the first mid-render state of each is timed in (g)
            bargs.setdefault(inst, (args, feats, label))

    hold_bounce("tex", "textured_image primary rays", timg, primary(timg))
    hold_bounce("tex", f"textured_image scan bounce {SCAN_CAPTURE_DEPTH}", timg, captured)
    hold_bounce("surf", "ward primary rays", ward, primary(ward))

    # ---- (e) the pinned and queue engines and the split route at 2 spp on
    # the three scenes against the megakernel route; the pinned engine's
    # super-step CAPTURE_STEP holds kernel 2s on ward and textured
    engine_launch = {"trace_surf": launch_a["trace_surf"], "bounce_tex": launch_d["bounce_tex"]}
    for name, scene in (("ward", ward), ("textured", trace_args["textured"][0]),
                        ("textured_image", timg)):
        tex = scene.textures is not None
        _, acc_m, st_m, launch_m, _, _ = counted_render(
            scene, 2, RenderConfig(iters_per_launch=2, **base), dev)
        check(launch_m == (only(bounce_tex=16) if tex else only(trace_surf=2)),
              f"{name} megakernel launches {launch_m}")
        cap = {}
        runs = (("pinned", RenderConfig(wavefront=True, iters_per_launch=2, **base)),
                ("queue", RenderConfig(wavefront=True, wavefront_pinned=False,
                                       wavefront_capacity=1 << 16, iters_per_launch=2, **base)),
                ("split", RenderConfig(fused=False, iters_per_launch=2, **base)))
        for engine, ecfg in runs:
            if engine == "pinned":
                _, acc_e, st_e, launch_e, steps, wall_e = capturing_render(scene, 2, ecfg, dev,
                                                                           cap)
            else:
                _, acc_e, st_e, launch_e, steps, wall_e = counted_render(scene, 2, ecfg, dev)
            print(f"[surf] (e) {name} {engine}, spp=2: {wall_e:.3f} s, {steps} super-steps, rays "
                  f"{st_e['rays_traced']}, launches {launch_e}")
            bar, rays_tol = (0.999, 2e-5), 0.0
            if engine == "split":
                check(launch_e == only(nearest_hit=16, occlusion=16),
                      f"{name} split route launches {launch_e}")
                if name == "textured":
                    # JAX's split path builds the bump frame apart from the
                    # kernel's (a 0.577 threshold, t2 left unnormalized), so
                    # a few bumped paths end at another bounce
                    bar, rays_tol = (0.99, 1e-4), 1e-5
            else:
                inst = "bounce_tex" if tex else "bounce_surf"
                check(launch_e == only(**{inst: steps}), f"{name} {engine} launches {launch_e}")
                engine_launch.setdefault(inst, launch_e[inst])
            check(abs(st_e["rays_traced"] - st_m["rays_traced"]) <= rays_tol * st_m["rays_traced"],
                  f"{name} {engine} and megakernel ray counts differ")
            check_close("surf", acc_e, acc_m, *bar, f"(e) {name} {engine} vs megakernel")
        check(bool(cap), f"{name}: no super-step state captured")
        if not tex:
            hold_bounce("surf", f"{name} super-step {CAPTURE_STEP}", scene, cap)

    # ---- (e) kernel 2's kVol x kSurf instance and its replay variant on the
    # pinned engine's super-step CAPTURE_STEP of milky_ward (milky's medium
    # beside a Ward sphere, scene/variants.milky_ward_scene): every output
    # plane equal to plain
    mward = scene_of("milky_ward", SURF_RES)
    cap = {}
    _, _, _, launch_e, steps, _ = capturing_render(
        mward, 2, RenderConfig(wavefront=True, iters_per_launch=2, **base), dev, cap)
    check(launch_e == only(bounce_surf=steps) and bool(cap),
          f"milky_ward pinned launches {launch_e}")
    mfeats = feats_of(mward)
    margs = (tables_of(mward), cap["origin"], cap["direction"], cap["throughput"], cap["sample"],
             cap["depth"], cap["prev"], cap["medium"].contiguous(), seed)
    for replay in (False, True):
        zero_counts()
        got = bounce_fused.bounce_fused_cuda(*margs, nee=True, features=mfeats,
                                             emit_replay=replay)
        launched = read_counts()
        want = bounce_fused.bounce_fused_plain(*margs, nee=True, features=mfeats,
                                               emit_replay=replay)
        torch.cuda.synchronize()
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        same = {f.name: torch.equal(getattr(got[0], f.name), getattr(want[0], f.name))
                for f in dataclasses.fields(got[0])}
        same.update({k: torch.equal(a, b) for k, a, b in zip(("replay_gid", "replay_nee"),
                                                             got[1:], want[1:])})
        in_med = int((cap["medium"][:, 3] > 0).sum())
        print(f"[surf:check] (e) kernel 2 kVol x kSurf{' (replay)' if replay else ''} on "
              f"milky_ward super-step {CAPTURE_STEP} ({sorted(mfeats)}), {margs[1].shape[0]} "
              f"lanes, {in_med} in a scattering medium: outputs equal {same}")
        counter = "bounce_replay_surf" if replay else "bounce_surf"
        check(launched == only(**{counter: 1}), f"kernel 2 kVol x kSurf launches {launched}")
        check(all(same.values()) and in_med > 0,
              f"kernel 2 kVol x kSurf differs from plain (replay {replay})")

    # ---- (f) the ward_96 and textured_image_96 goldens on the card
    gcfg = RenderConfig(iters_per_launch=8, **base)
    gimg, gacc, _ = render(scene_of("ward", (96, 96)), 16, gcfg, device=dev)
    golden = torch.from_numpy(np.load(os.path.join(ROOT, "tests", "golden", "ward_96.npy"))).to(dev)
    frac = float(((gacc - golden).abs() <= 1e-5 * (golden.abs() + 1e-3)).float().mean())
    gsum = float((gacc.double().sum() - golden.double().sum()).abs() / golden.double().sum())
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "ward_96.png"))).to(dev)
    png_mean = float((gimg - png.float() / 255.0).abs().mean()) * 255.0
    print(f"[surf:golden] ward_96: {frac:.5f} of entries within 1e-5 rel, sum rel {gsum:.3g}, "
          f"PNG mean abs {png_mean:.4f}/255")
    check(frac >= 0.95 and gsum <= 2e-5 and png_mean <= 0.8, "ward_96 golden beyond its bar")
    gimg, _, _ = render(scene_of("textured_image", (96, 96)), 16, gcfg, device=dev)
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden",
                                                 "textured_image_96.png"))).to(dev)
    gdiff = (gimg - png.float() / 255.0).abs()
    within = float((gdiff.amax(-1) <= 2.5 / 255.0).float().mean())
    print(f"[surf:golden] textured_image_96: PNG mean abs {float(gdiff.mean()) * 255:.4f}/255, "
          f"max {float(gdiff.max()) * 255:.4f}/255, pixels within 2.5/255 {within:.5f}")
    check(float(gdiff.mean()) * 255 <= 0.8 and within >= 0.999,
          "textured_image_96 golden beyond its bar")

    # ---- (g) times by CUDA events, bounds from this run's inputs, registers
    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    def sweep_ops(scene):
        return sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE if t == 1 else 0)
                   for t in scene.geoms.type.tolist())

    def surf_ops(feats):
        return OPS_SHADE + (OPS_TEXTURE if "texture" in feats else 0)

    timing = {}
    for key, name in (("trace_surf", "ward"), ("trace_surf textured", "textured")):
        scene, targs, kw, nrays = trace_args[name]
        ms = cuda_ms(lambda: trace.trace_cuda(*targs, **kw), reps=10)
        d_ms = device_ms(lambda: trace.trace_cuda(*targs, **kw),
                         ["trace_kernel"])["trace_kernel"][0]
        p_ms = cuda_ms(lambda: trace.trace_plain(*targs, **kw), reps=1)
        n = targs[5].shape[0]
        tbytes = sum(t.numel() * 4 for t in targs[:4])
        ops = nrays // 2 * (sweep_ops(scene) + surf_ops(kw["features"]))
        where = f"{name} ({nrays // 2 / n:.4f} bounces per lane of {kw['max_depth']})"
        timing[key] = (ms, d_ms, p_ms, bound(ops, n * (12 + 12 + 4 + 12) + tbytes), where, n)
    for inst in ("surf", "tex"):
        args, feats, label = bargs[inst]
        tex = inst == "tex"
        n = args[1].shape[0]
        scene = timg if tex else ward

        def launch():
            return bounce_fused.bounce_fused_cuda(*args, nee=True, features=feats, tex_defer=tex)

        ms = cuda_ms(launch, reps=20)
        d_ms = device_ms(launch, ["bounce_kernel"])["bounce_kernel"][0]
        p_ms = cuda_ms(lambda: bounce_fused.bounce_fused_plain(*args, nee=True, features=feats,
                                                               tex_defer=tex), reps=2)
        tbytes = sum(t.numel() * 4 for t in args[0])
        # 12 planes and the 4-wide medium in; 14 float planes, the medium, the
        # terminate byte and, with the deferred texel, 3 more planes out
        nbytes = n * (48 + 16 + 57 + 16 + (12 if tex else 0)) + tbytes
        timing[f"bounce_{inst}"] = (ms, d_ms, p_ms,
                                    bound(n * (sweep_ops(scene) + surf_ops(feats)), nbytes),
                                    label, n)
    rcfg = dataclasses.replace(cfg, features=tuple(sorted(feats_of(ward))))
    ward_tables = tables_of(ward)
    acc0 = torch.zeros((w * h, 3), **f32)
    iter_ms = cuda_ms(lambda: render_chunk(ward, acc0, 0, seed, rcfg, 1, tables=ward_tables),
                      reps=5)
    summary = profile_step(lambda: render_chunk(ward, acc0, 0, seed, rcfg, 1, tables=ward_tables),
                           iter_ms, out_dir, "ward_iteration", ("trace_kernel",))
    ti_cfg = dataclasses.replace(cfg, features=tuple(sorted(feats_of(timg))))
    ti_tables = tables_of(timg)
    ti_ms = cuda_ms(lambda: render_chunk(timg, acc0, 0, seed, ti_cfg, 1, tables=ti_tables),
                    reps=3)
    instances = ptxas_instances(reports)
    regs = {
        "trace (Cornell)": instance_regs(instances, "trace", "trace_kernel", 0, 0, 0, 0),
        "trace_surf": instance_regs(instances, "trace", "trace_kernel", 0, 0, 0, 1),
        "trace_surf_vol": instance_regs(instances, "trace", "trace_kernel", 0, 1, 0, 1),
        "trace_surf_hg": instance_regs(instances, "trace", "trace_kernel", 0, 1, 1, 1),
        "trace_surf_mesh": instance_regs(instances, "trace", "trace_kernel", 1, 0, 0, 1),
        "trace_surf_mesh_vol": instance_regs(instances, "trace", "trace_kernel", 1, 1, 0, 1),
        "trace_surf_mesh_hg": instance_regs(instances, "trace", "trace_kernel", 1, 1, 1, 1),
        "bounce_surf": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 1, 0),
        "bounce_surf_vol": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 0, 1, 0),
        "bounce_surf_hg": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 1, 1, 0),
        "bounce_surf_mesh": instance_regs(instances, "bounce", "bounce_kernel", 1, 0, 0, 1, 0),
        "bounce_surf_mesh_vol": instance_regs(instances, "bounce", "bounce_kernel", 1, 1, 0, 1,
                                              0),
        "bounce_surf_mesh_hg": instance_regs(instances, "bounce", "bounce_kernel", 1, 1, 1, 1, 0),
        "bounce_tex": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 1, 1),
        "bounce_tex_vol": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 0, 1, 1),
        "bounce_tex_hg": instance_regs(instances, "bounce", "bounce_kernel", 0, 1, 1, 1, 1),
    }
    print(f"[card] {card}")
    print(f"[surf:regs] registers, spill store / load bytes per instance: {regs}")
    check(regs["trace (Cornell)"] is None or regs["trace (Cornell)"][:2] == TRACE_CORNELL_REGS,
          f"Cornell's kernel 1 uses {regs['trace (Cornell)']} registers and spill bytes, not "
          f"{TRACE_CORNELL_REGS}")
    print(f"[surf:time] Cornell's kernel 1 {cornell_ms:.4f} ms/iteration in this run; ward "
          f"iteration {iter_ms:.4f} ms ({trace_args['ward'][3] / iter_ms / 1e3:.1f} Mrays/s); "
          f"textured_image iteration (8 bounces of the scan) {ti_ms:.4f} ms; on {card}")
    print(f"[surf:profile] ward render iteration: {summary}")
    for key, (ms, d_ms, p_ms, (b_ms, b_by), where, n) in timing.items():
        print(f"[surf:time] {key} at {n} lanes of {where}: {ms:.4f} ms by events, "
              f"{d_ms:.4f} ms of device time (plain {p_ms:.3f} ms), bound {b_ms:.4f} ms by "
              f"{b_by} (a lower bound: the bump, the lobes, the UV and shadow rays left out); "
              f"on {card}")

    # ---- (h) the CLI's auto engine on textured_image (the wavefront engine,
    # as JAX's CLI picks for image textures)
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/textured_image.txt",
         "--spp", "2", "--out", os.path.join(out_dir, "cli_textured_image.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[surf:cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0 and "engine=wavefront" in cli.stdout,
          "textured_image CLI run failed")

    common = {"route": "cuda", "library_ms": None}
    entries = []
    for key, source, err in (("trace_surf", "trace.cu", k1_err),
                             ("bounce_surf", "bounce.cu", k2_err["surf"]),
                             ("bounce_tex", "bounce.cu", k2_err["tex"])):
        ms, d_ms, p_ms, (b_ms, b_by), _, _ = timing[key]
        replaces = ("pathtracer_tpu/ops/trace_pallas.py:62" if key == "trace_surf"
                    else "pathtracer_tpu/ops/bounce_pallas.py:1477")
        entries.append({"name": key, **common, "source": f"pathtracer_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": engine_launch[key], "max_abs_err": err,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
        if key != "trace_surf":
            entries[-1].update(device_ms=d_ms, design=KERNEL2_PER_LANE)
    return entries


BIG_RES = (512, 512)  # bench.py's smooth_mesh row's width, on displace_demo's geometry
BIG_SPP = 32
# (d) and (e)'s vt grid are above kernel 9's 8,192 triangles: their winner and
# shadow rays take the LBVH traversal, plain PyTorch over every lane for each
# chunk of 64 triangles with a host sync per chunk, so they run at a quarter
# of the lanes and 1 spp; the 2mm gradient step runs at TRAVERSAL_RES, 2 spp,
# as the lean step is plain PyTorch per bounce around its kernels
TRAVERSAL_RES = (256, 256)
TRAVERSAL_SPP = 1


def bigmesh_phase(dev, card: str, out_dir: str, reports: dict) -> list:
    """Phase 12, ``[bigmesh]``: meshes above the in-kernel cap and image
    textures on meshes.  displace_demo's geometry at 5,120 triangles through
    every forward engine (kernel 2mm per bounce, kernels 9 and 10 around
    it), 2mm against its plain version, 20,480 triangles (the LBVH
    traversal), an image texture on a vt grid of 8,450 triangles (2mm with
    mesh_uv) and on a 2-triangle quad (2mt), one lean gradient step with
    mesh vertex leaves on smooth_mesh (kernel 1m forward) and on the
    5,120-triangle scene (2mm forward), times, bounds, registers and the
    CLI.  Returns the JSON entries of 2mm and 2mt."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, mesh
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.mesh import object_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff, megakernel
    from pathtracer_tpu_torch.render.features import features_for_materials
    from pathtracer_tpu_torch.render.integrator import render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
    from pathtracer_tpu_torch.scene.structs import Rays
    from pathtracer_tpu_torch.scene.variants import (bigmesh_scene, grid_obj, quad_obj,
                                                     textured_mesh_scene)
    from pathtracer_tpu_torch.utils.imageio import save_image

    scenes_dir = os.path.join(ROOT, "scenes")
    obj_dir = os.path.join(out_dir, "bigmesh_assets")
    os.makedirs(obj_dir, exist_ok=True)
    grid_path, quad_path = os.path.join(obj_dir, "grid65.obj"), os.path.join(obj_dir, "quad.obj")
    with open(grid_path, "w") as f:
        f.write(grid_obj(65))
    with open(quad_path, "w") as f:
        f.write(quad_obj(True))

    def scene_of(text, res, name):
        desc = dataclasses.replace(parse_scene_text(text, name=name, scene_dir=scenes_dir),
                                   resolution=res)
        return desc.scene_for_frame(0, device=dev)

    base = dict(max_depth=8, nee=True)
    seed = key_to_seed(prng_key(0))
    f32 = dict(dtype=torch.float32, device=dev)
    t_last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"[bigmesh:wall] {part} {now - t_last[0]:.1f} s")
        t_last[0] = now

    def feats_of(scene):
        return frozenset(features_for_materials(scene.materials)) | {"glossy"}

    def tables_of(scene):
        return [t.contiguous() for t in pack_tables(scene)]

    def primary(scene):
        n = scene.camera.width * scene.camera.height
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        return dict(origin=rays.origin, direction=rays.direction,
                    throughput=torch.ones((n, 3), **f32), sample=pixel,
                    depth=torch.zeros(n, dtype=torch.int32, device=dev),
                    prev=torch.zeros(n, **f32), medium=torch.zeros((n, 4), **f32))

    # ---- (a) the 5,120-triangle scene through the entry point: the
    # megakernel route is the per-bounce scan, each bounce kernel 9 (the
    # mesh winner), kernel 2mm and kernel 10 (the deferred shadow rays) once;
    # the inputs of scan bounce SCAN_CAPTURE_DEPTH are kept
    big = scene_of(bigmesh_scene(4), BIG_RES, "bigmesh")
    n_tris = big.meshes[0].tri_verts.shape[0]
    w, h = BIG_RES
    n = w * h
    cfg = RenderConfig(iters_per_launch=8, **base)
    captured = {}
    shade = megakernel.shade_bounce

    def recording(scn, rays, thr, sample, depth, prev, seed_, cfg_, medium_sigma=None,
                  tables=None):
        if depth == SCAN_CAPTURE_DEPTH and not captured:
            captured.update(origin=rays.origin.clone(), direction=rays.direction.clone(),
                            throughput=thr.clone(), sample=sample.clone(),
                            depth=torch.full(sample.shape, depth, dtype=torch.int32, device=dev),
                            prev=prev.clone(), medium=medium_sigma.clone())
        return shade(scn, rays, thr, sample, depth, prev, seed_, cfg_,
                     medium_sigma=medium_sigma, tables=tables)

    megakernel.shade_bounce = recording
    try:
        img, acc, st, launch_a, _, wall_a = counted_render(big, BIG_SPP, cfg, dev)
    finally:
        megakernel.shade_bounce = shade
    per_iter = cfg.max_depth
    print(f"[bigmesh] (a) displaced icosahedron, {n_tris} triangles, {w}x{h} d8 nee "
          f"spp={BIG_SPP}: {wall_a:.3f} s, rays {st['rays_traced']}, launches {launch_a}")
    check(n_tris == 5120, f"{n_tris} triangles, expected 5120")
    check(launch_a == only(bounce_merge=per_iter * BIG_SPP, mesh_nearest=per_iter * BIG_SPP,
                           mesh_min=per_iter * BIG_SPP), f"big mesh megakernel launches {launch_a}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
          and bool((acc >= 0).all()) and float(acc.sum()) > 0, "big mesh render: bad image")
    check(bool(captured), "no scan bounce captured")
    save_image(os.path.join(out_dir, "chip_smoke_bigmesh.png"), img.cpu().numpy())

    # ---- (b) kernel 2mm against its plain version on the primary rays and
    # on scan bounce SCAN_CAPTURE_DEPTH: both take the same merge planes
    k2_err = {"merge": 0.0, "mesh_tex": 0.0}
    bargs = {}

    def hold_bounce(inst, label, scene, s):
        """Kernel 2mm (2mt) against its plain version on the bounce state
        ``s``: every output plane equal on every lane."""
        feats = feats_of(scene)
        tables = tables_of(scene)
        tex = scene.textures is not None
        kw = dict(nee=True, features=feats, tex_defer=tex)
        if inst == "merge":
            with_uv = tex and any(m.tri_uv is not None for m in scene.meshes)
            kw["mesh_in"], kw["mesh_uv"] = bounce_fused.merge_planes(
                scene, s["origin"], s["direction"], tables[0], with_uv)
        else:
            kw["mesh"] = scene.mesh_tables
        args = (tables, s["origin"], s["direction"], s["throughput"], s["sample"], s["depth"],
                s["prev"], s["medium"].contiguous(), seed)
        zero_counts()
        got = bounce_fused.bounce_fused_cuda(*args, **kw)
        launched = read_counts()
        want = bounce_fused.bounce_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        (got, *g_extra), (want, *w_extra) = got, want
        names = (["u", "v", "slot"] if tex else []) + (["deferred"] if inst == "merge" else [])
        same = {k: torch.equal(a, b) for k, a, b in zip(names, g_extra, w_extra)}
        same.update({f.name: torch.equal(getattr(got, f.name), getattr(want, f.name))
                     for f in dataclasses.fields(got)})
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            k2_err[inst] = max(k2_err[inst],
                               float((getattr(got, f) - getattr(want, f)).abs().max()))
        extra = ""
        if inst == "merge":
            extra = (f", {int((kw['mesh_in'][0] < 1e29).sum())} lanes on the mesh, "
                     f"{int(w_extra[-1][10].sum())} deferred candidates")
        if tex:
            extra += f", {int((w_extra[2] >= 0).sum())} image-textured events"
        print(f"[bigmesh:check] kernel 2{'mm' if inst == 'merge' else 'mt'} on {label}, "
              f"{s['origin'].shape[0]} lanes{extra}: outputs equal {same}")
        check(launched == only(**{f"bounce_{inst}": 1}), f"kernel 2 {inst} launches {launched}")
        check(all(same.values()), f"kernel 2 {inst} differs from plain ({label})")
        bargs.setdefault(inst, (args, kw, label, scene))

    hold_bounce("merge", f"bounce {SCAN_CAPTURE_DEPTH} of the scan", big, captured)
    hold_bounce("merge", "the primary rays", big, primary(big))
    lap("(a), (b)")

    # ---- (c) the pinned and queue engines and the split route at 2 spp
    # against the megakernel route
    _, acc_m, st_m, launch_m, _, _ = counted_render(
        big, 2, RenderConfig(iters_per_launch=2, **base), dev)
    check(launch_m == only(bounce_merge=16, mesh_nearest=16, mesh_min=16),
          f"big mesh megakernel launches at 2 spp {launch_m}")
    engine_launch = {"bounce_merge": launch_a["bounce_merge"]}
    for engine, ecfg, bar in (
            ("pinned", RenderConfig(wavefront=True, iters_per_launch=2, **base), (0.999, 1e-5)),
            ("queue", RenderConfig(wavefront=True, wavefront_pinned=False,
                                   wavefront_capacity=1 << 16, iters_per_launch=2, **base),
             (0.999, 1e-5)),
            ("split", RenderConfig(fused=False, iters_per_launch=2, **base), (0.999, 1e-5))):
        _, acc_e, st_e, launch_e, steps, wall_e = counted_render(big, 2, ecfg, dev)
        print(f"[bigmesh] (c) {engine}, spp=2: {wall_e:.3f} s, {steps} super-steps, rays "
              f"{st_e['rays_traced']}, launches {launch_e}")
        if engine == "split":
            check(launch_e == only(nearest_hit=16, occlusion=16, mesh_nearest=16, mesh_min=16),
                  f"big mesh split route launches {launch_e}")
        else:
            check(launch_e == only(bounce_merge=steps, mesh_nearest=steps, mesh_min=steps),
                  f"big mesh {engine} launches {launch_e}")
        check(st_e["rays_traced"] == st_m["rays_traced"],
              f"big mesh {engine} and megakernel ray counts differ")
        check_close("bigmesh", acc_e, acc_m, *bar, f"(c) {engine} vs megakernel, 2 spp")
    lap("(c)")

    # ---- (d) 20,480 triangles (the LBVH traversal, no kernel 9 or 10)
    huge = scene_of(bigmesh_scene(5), TRAVERSAL_RES, "bigmesh5")
    t_d = {}
    per_d = per_iter * TRAVERSAL_SPP
    for engine, ecfg in (("megakernel", RenderConfig(iters_per_launch=TRAVERSAL_SPP, **base)),
                         ("split", RenderConfig(fused=False, iters_per_launch=TRAVERSAL_SPP,
                                                **base))):
        _, acc_e, st_e, launch_e, _, wall_e = counted_render(huge, TRAVERSAL_SPP, ecfg, dev)
        print(f"[bigmesh] (d) {huge.meshes[0].tri_verts.shape[0]} triangles "
              f"{TRAVERSAL_RES[0]}x{TRAVERSAL_RES[1]} {engine}, spp={TRAVERSAL_SPP}: "
              f"{wall_e:.3f} s, rays {st_e['rays_traced']}, launches {launch_e}")
        want = (only(bounce_merge=per_d) if engine == "megakernel"
                else only(nearest_hit=per_d, occlusion=per_d))
        check(launch_e == want, f"20,480-triangle {engine} launches {launch_e}")
        t_d[engine] = (acc_e, st_e["rays_traced"])
    check(t_d["megakernel"][1] == t_d["split"][1], "20,480 triangles: ray counts differ")
    check_close("bigmesh", t_d["split"][0], t_d["megakernel"][0], 0.999, 1e-5,
                "(d) 20,480 triangles, split route vs megakernel")
    lap("(d)")

    # ---- (e) image textures on meshes: the vt grid above the cap (2mm with
    # mesh_uv and the texel) and the quad in the in-kernel sweep (2mt)
    for name, path, inst, res, spp in (
            ("vt grid", grid_path, "merge", TRAVERSAL_RES, TRAVERSAL_SPP),
            ("vt quad", quad_path, "mesh_tex", BIG_RES, 2)):
        scene = scene_of(textured_mesh_scene(path), res, name)
        accs = {}
        for engine, ecfg in (("megakernel", RenderConfig(iters_per_launch=spp, **base)),
                             ("split", RenderConfig(fused=False, iters_per_launch=spp, **base))):
            _, acc_e, st_e, launch_e, _, wall_e = counted_render(scene, spp, ecfg, dev)
            print(f"[bigmesh] (e) {name} ({scene.meshes[0].tri_verts.shape[0]} triangles) "
                  f"{res[0]}x{res[1]} {engine}, spp={spp}: {wall_e:.3f} s, rays "
                  f"{st_e['rays_traced']}, launches {launch_e}")
            if engine == "megakernel":
                check(launch_e[f"bounce_{inst}"] == per_iter * spp,
                      f"{name}: kernel 2 {inst} launches {launch_e}")
                engine_launch.setdefault(f"bounce_{inst}", launch_e[f"bounce_{inst}"])
            accs[engine] = (acc_e, st_e["rays_traced"])
        check(accs["megakernel"][1] == accs["split"][1], f"{name}: ray counts differ")
        check_close("bigmesh", accs["split"][0], accs["megakernel"][0], 0.999, 1e-5,
                    f"(e) {name}, split route vs megakernel")
        hold_bounce(inst, f"{name} primary rays", scene, primary(scene))
    lap("(e)")

    # ---- (g) times by CUDA events and profiler device time, bounds from this
    # run's inputs, registers, and the CLI
    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    def sweep_ops(scene):
        return sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE if t == 1 else 0)
                   for t in scene.geoms.type.tolist())

    timing = {}
    for inst in ("merge", "mesh_tex"):
        args, kw, label, scene = bargs[inst]
        ln = args[1].shape[0]
        tex = kw["tex_defer"]

        def launch(args=args, kw=kw):
            return bounce_fused.bounce_fused_cuda(*args, **kw)

        ms = cuda_ms(launch, reps=20)
        kname = "bounce_merge_kernel" if inst == "merge" else "bounce_kernel"
        d_ms = device_ms(launch, [kname])[kname][0]
        p_ms = cuda_ms(lambda args=args, kw=kw: bounce_fused.bounce_fused_plain(*args, **kw),
                       reps=2)
        tbytes = sum(t.numel() * 4 for t in args[0])
        ops = ln * (sweep_ops(scene) + OPS_SHADE + (OPS_TEXTURE if tex else 0))
        if inst == "merge":
            # kernel 2's 16 planes in and 18 float planes and a byte out, the
            # 8 merge planes, 11 deferred ones under NEE, with the texel 3 out
            # and mesh_uv 3 in
            nbytes = ln * (53 * 4 + 1 + (24 if tex else 0)) + tbytes
        else:
            # kernel 2's planes and the texel's 3 out; the sweeps counted by
            # mesh_bounce_work
            km = scene.mesh_tables
            tbytes += sum(t.numel() * 4 for t in (km.tri, km.aabb, km.norm, km.uv, km.desc))
            nbytes = ln * (48 + 16 + 57 + 16 + 12) + tbytes
            state = dict(zip(("origin", "direction", "throughput", "sample", "depth", "prev",
                              "medium"), args[1:8]))
            work = mesh_bounce_work(args[0], km, state, seed, kw["features"])
            ops += (ln * OPS_MESH_RAY + work["slab"] * OPS_AABB + work["pairs"] * OPS_MT)
        timing[f"bounce_{inst}"] = (ms, d_ms, p_ms, bound(ops, nbytes), label, ln)
    # kernels 9 and 10 inside this path: the mesh winner of scan bounce
    # SCAN_CAPTURE_DEPTH's rays and the deferred shadow rays of that bounce
    m0 = big.meshes[0]
    big_tables = tables_of(big)
    o_obj, d_obj = object_rays(Rays(captured["origin"], captured["direction"]), big_tables[0],
                               m0.geom_index)
    kw_merge = bargs["merge"][1]
    deferred = bounce_fused.bounce_fused_cuda(*bargs["merge"][0], **kw_merge)[-1]
    s_obj, s_dir = object_rays(Rays(deferred[0:3].T.contiguous(), deferred[3:6].T.contiguous()),
                               big_tables[0], m0.geom_index)
    o_obj, d_obj, s_obj, s_dir = (x.contiguous() for x in (o_obj, d_obj, s_obj, s_dir))
    bare = mesh.mesh_chunk_boxes(m0, pad=False)
    for label, (o, d) in ((f"scan bounce {SCAN_CAPTURE_DEPTH}", (o_obj, d_obj)),
                          (f"scan bounce {SCAN_CAPTURE_DEPTH}'s shadow rays", (s_obj, s_dir))):
        hold_mesh_kernels("[bigmesh:check] (g)", label, m0.scan_table, m0.scan_boxes, o, d, 0.0,
                          0.0)
    mt9 = time_mesh_kernels(m0.scan_table, m0.scan_boxes, bare, o_obj, d_obj)["9"]
    mt10 = time_mesh_kernels(m0.scan_table, m0.scan_boxes, bare, s_obj, s_dir)["10"]
    acc0 = torch.zeros((n, 3), **f32)
    rcfg = dataclasses.replace(cfg, features=tuple(sorted(feats_of(big))))
    iter_ms = cuda_ms(lambda: render_chunk(big, acc0, 0, seed, rcfg, 1, tables=big_tables), reps=3)
    in_path = ("bounce_merge_kernel", "mesh_nearest_kernel", "mesh_min_kernel")
    summary = profile_step(lambda: render_chunk(big, acc0, 0, seed, rcfg, 1, tables=big_tables),
                           iter_ms, out_dir, "bigmesh_iteration", in_path)
    per_launch = device_ms(lambda: render_chunk(big, acc0, 0, seed, rcfg, 1, tables=big_tables),
                           in_path, reps=1, per_call=per_iter)
    instances = ptxas_instances(reports)
    regs = {
        "trace (Cornell)": instance_regs(instances, "trace", "trace_kernel", 0, 0, 0, 0),
        "bounce (Cornell)": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 0, 0),
        "bounce_surf": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 1, 0),
        "bounce_tex": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 1, 1),
        "bounce_mesh_tex": instance_regs(instances, "bounce", "bounce_kernel", 1, 0, 0, 1, 1),
        "bounce_mesh_tex_vol": instance_regs(instances, "bounce", "bounce_kernel", 1, 1, 0, 1, 1),
        "bounce_mesh_tex_hg": instance_regs(instances, "bounce", "bounce_kernel", 1, 1, 1, 1, 1),
    }
    for vol, hg, surf, tex in ((0, 0, 0, 0), (0, 0, 1, 0), (0, 0, 1, 1), (1, 0, 0, 0),
                               (1, 1, 0, 0), (1, 0, 1, 0), (1, 1, 1, 0), (1, 0, 1, 1),
                               (1, 1, 1, 1)):
        tag = "bounce_merge" + "".join(f"_{k}" for k, on in (("vol", vol), ("hg", hg),
                                                              ("surf", surf), ("tex", tex)) if on)
        regs[tag] = instance_regs(instances, "bounce_merge", "bounce_merge_kernel",
                                  vol, hg, surf, tex)
    print(f"[card] {card}")
    print(f"[bigmesh:regs] registers, spill store / load bytes per instance: {regs}")
    # registers, and for kernel 1 its spill store bytes too
    for key, want in (("trace (Cornell)", TRACE_CORNELL_REGS), ("bounce (Cornell)", (56,)),
                      ("bounce_surf", (56,)), ("bounce_tex", (64,))):
        check(regs[key] is None or regs[key][:len(want)] == want,
              f"{key} uses {regs[key]} registers and spill bytes, not {want} as before")
    print(f"[bigmesh:time] iteration of the 5,120-triangle scene at {w}x{h} (8 bounces of the "
          f"scan, each kernels 9, 2mm, 10) {iter_ms:.4f} ms "
          f"({st_m['rays_traced'] / 2 / iter_ms / 1e3:.1f} Mrays/s); device time per launch "
          f"in the iteration: "
          + "; ".join(f"{k} {v[0]:.4f} ms x{v[1]}" for k, v in per_launch.items())
          + f"; on {card}")
    print_mesh_times("[bigmesh:time]", f"{o_obj.shape[0]} rays of scan bounce "
                     f"{SCAN_CAPTURE_DEPTH} x {m0.scan_table.numel() // 9} triangles",
                     {"9": mt9}, card)
    print_mesh_times("[bigmesh:time]", f"scan bounce {SCAN_CAPTURE_DEPTH}'s {s_obj.shape[0]} "
                     f"shadow rays", {"10": mt10}, card)
    print(f"[bigmesh:profile] iteration: {summary}")
    for key, (ms, d_ms, p_ms, (b_ms, b_by), where, ln) in timing.items():
        print(f"[bigmesh:time] {key} at {ln} lanes of {where}: {ms:.4f} ms by events, "
              f"{d_ms:.4f} ms of device time (plain {p_ms:.3f} ms), bound {b_ms:.4f} ms by "
              f"{b_by}; on {card}")
    lap("(g) times")

    # ---- (f) one lean gradient step with mesh vertex leaves: smooth_mesh
    # (the forward on kernel 1m) and the 5,120-triangle scene (2mm).  It runs
    # after (g)'s short profiles: one started just after the profile of a
    # lean step (tens of thousands of launches) kept no kernel at all
    for name, desc, gspp in (
            ("smooth_mesh", dataclasses.replace(load_scene(os.path.join(scenes_dir,
                                                                        "smooth_mesh.txt")),
                                                resolution=BIG_RES), 4),
            ("bigmesh", dataclasses.replace(parse_scene_text(bigmesh_scene(4), name="bigmesh",
                                                             scene_dir=scenes_dir),
                                            resolution=TRAVERSAL_RES), 2)):
        params, static = diff.params_from_description(desc, 0, device=dev)
        gn = static.resolution[0] * static.resolution[1]
        target = torch.zeros((gn, 3), **f32)
        gcfg = RenderConfig(wavefront=False, **base)
        per = gspp * base["max_depth"]

        def step(params=params, static=static, target=target, gspp=gspp, gcfg=gcfg):
            return diff.loss_and_grad_rays(params, static, target, gspp, prng_key(0), gcfg,
                                           device=dev)

        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, rays = step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        vg = grads.mesh_verts[0]
        expect = (only(trace_mesh=gspp, winner=per, occlusion=per, mesh_nearest=per, mesh_min=per)
                  if name == "smooth_mesh" else
                  only(bounce_merge=per, winner=per, occlusion=per, mesh_nearest=2 * per,
                       mesh_min=2 * per))
        print(f"[bigmesh] (f) lean loss_and_grad_rays {name} {static.resolution[0]}x"
              f"{static.resolution[1]} d8 nee spp={gspp}, {vg.shape[0]} triangles as leaves: "
              f"{first_s:.3f} s (first step), loss {float(loss):.9g}, rays {int(rays)}, peak "
              f"memory {peak_gb:.3f} GB, vertex gradients max {float(vg.abs().max()):.4g}, "
              f"launches {launches}")
        check(launches == expect, f"{name} lean step launches {launches}, expected {expect}")
        check(float(loss) > 0 and bool(torch.isfinite(vg).all()) and float(vg.abs().max()) > 0,
              f"{name}: vertex gradients not finite and nonzero")
        bad = [k for k, v in grads.leaves().items() if not bool(torch.isfinite(v).all())]
        check(not bad, f"{name}: non-finite gradients in {bad}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        kernels = (("trace_kernel",) if name == "smooth_mesh" else ("bounce_merge_kernel",)) + (
            "winner_kernel", "occlusion_kernel", "mesh_nearest_kernel", "mesh_min_kernel")
        summary = profile_step(step, step_ms, out_dir, f"bigmesh_{name}_step", kernels)
        print(f"[bigmesh:profile] lean step on {name}: {step_ms:.4f} ms, "
              f"{int(rays) / step_ms / 1e3:.1f} fwd+bwd Mrays/s; {summary}")
        lean_parted_pixels("[bigmesh] (f)", name, params, static, gcfg, 1)
    lap("(f)")

    # the CLI's auto engine on the 5,120-triangle scene: the wavefront engine
    scene_file = os.path.join(obj_dir, "bigmesh.txt")
    with open(scene_file, "w") as f:
        f.write(bigmesh_scene(4).replace("assets/ico.obj",
                                         os.path.join(scenes_dir, "assets", "ico.obj")))
    png = os.path.join(out_dir, "cli_bigmesh.png")
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", f"scene={scene_file}", "--spp", "2",
         "--engine", "auto", "--out", png],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[bigmesh:cli] exit {cli.returncode}: {cli.stdout.strip()} "
          f"{cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0 and "engine=wavefront" in cli.stdout
          and os.path.exists(os.path.join(out_dir, "cli_bigmesh.0.png")),
          "the CLI on the 5,120-triangle scene failed")
    lap("(g) CLI")

    common = {"route": "cuda", "library_ms": None,
              "replaces": "pathtracer_tpu/ops/bounce_pallas.py:1477"}
    entries = []
    for key, source, err in (("bounce_merge", "bounce_merge.cu", k2_err["merge"]),
                             ("bounce_mesh_tex", "bounce.cu", k2_err["mesh_tex"])):
        ms, _, p_ms, (b_ms, b_by), _, _ = timing[key]
        entries.append({"name": key, **common, "source": f"pathtracer_tpu_torch/csrc/{source}",
                        "launches": engine_launch[key], "max_abs_err": err, "ms": ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
    return entries


def grad_step(tag, shown, dev, spp: int, out_dir: str, label, desc, cfg, expect,
              kernels=None) -> dict:
    """One ``loss_and_grad_rays`` step of ``spp`` iterations, target zeros,
    through the entry point with the counters zeroed just before: its
    launches checked against ``expect``, every gradient finite, its time
    after a warm-up step, the material leaves ``shown`` printed, and with
    ``kernels`` one profiled step (idle share).  The phases bind the first
    five arguments (``functools.partial``)."""
    import torch

    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    params, static = diff.params_from_description(desc, 0, device=dev)
    n = static.resolution[0] * static.resolution[1]
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def step():
        return diff.loss_and_grad_rays(params, static, target, spp, prng_key(0), cfg, device=dev)

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, rays = step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == expect, f"{label} step launches {launches}, expected {expect}")
    bad = [k for k, v in grads.leaves().items() if not bool(torch.isfinite(v).all())]
    check(not bad and float(loss) > 0, f"{label}: loss {float(loss)}, non-finite {bad}")
    t0 = time.perf_counter()  # the first step was the warm-up
    step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    name = tag.strip("[]").replace(":", "_") + "_" + label.replace(" ", "_")
    summary = (profile_step(step, step_ms, out_dir, name, kernels) if kernels
               else "idle share not measured (one profile per scene)")
    leaves = {k: [round(v, 6) for v in getattr(grads.materials, k).flatten().tolist()]
              for k in shown}
    print(f"{tag} {label} {static.resolution[0]}x{static.resolution[1]} d{cfg.max_depth} nee "
          f"vol_nee={cfg.vol_nee} spp={spp}: {step_ms:.4f} ms ({first_s:.3f} s first), "
          f"{int(rays) / step_ms / 1e3:.1f} fwd+bwd Mrays/s, loss {float(loss):.9g}, peak "
          f"memory {peak_gb:.3f} GB, launches {launches}; gradients {leaves}; {summary}")
    return dict(loss=loss, grads=grads, ms=step_ms, launches=launches, params=params,
                static=static)


def lean_parted_pixels(tag, label, params, static, cfg, iterations: int, shown: int = 8):
    """The pixels whose lean re-trace parts from the lean forward in any of
    ``iterations`` iterations (``render/diff.lean_parted``: radiances apart
    beyond float32 rounding), the first ``shown`` printed with their
    iteration, radiances and, in the fused scope (the re-trace replays the
    forward), their forward paths (``ops/trace_grad.lane_events``)."""
    import torch

    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.integrator import camera_sample

    cfg_fwd, _ = diff.lean_cfgs(cfg, params.materials)
    scene = diff.build_scene(params, static)
    replayed = trace_grad.replay_scope(scene, cfg_fwd)
    seed = key_to_seed(prng_key(0))
    feats = frozenset(cfg_fwd.features)
    parted = None
    for it in range(iterations):
        p, fwd, back = diff.lean_parted(params, static, it, prng_key(0), cfg)
        parted = p if parted is None else parted | p
        lanes = p.nonzero()[:max(shown, 0), 0].tolist()
        shown -= len(lanes)
        paths = {}
        if replayed and lanes:
            pix = torch.arange(p.shape[0], dtype=torch.int64, device=p.device)
            tables = pack_tables(scene)
            with torch.no_grad():
                rays, sample = camera_sample(scene, pix, it, seed, cfg_fwd)
                _, _, resid = trace_grad.tfwd_cuda(
                    *tables, seed, rays.origin, rays.direction, sample, max_depth=cfg.max_depth,
                    nee=cfg.nee, rr=cfg.russian_roulette, rr_start=cfg.rr_start, features=feats,
                    vol_nee=cfg.vol_nee)
            paths = {j: trace_grad.lane_events(tables[0], seed, sample, resid, j, feats)
                     for j in lanes}
        for j in lanes:
            print(f"{tag} {label} lean: pixel {j} parts in iteration {it}, radiance "
                  f"{fwd[j].tolist()} forward, {back[j].tolist()} re-trace"
                  + (f"; the forward's path {paths[j]}" if j in paths else ""))
    print(f"{tag} {label} lean: its re-trace "
          + ("replaying the forward's winners, NEE bits and rays" if replayed
             else "with its own searches (no replay outside the fused scope)")
          + f" parts from its forward on {int(parted.sum())} of {parted.numel()} pixels over "
          f"{iterations} iteration(s)")
    return parted


def hold_adjoint(tag, got, ref, names, path, min_share: float = 0.9999) -> float:
    """An adjoint kernel's ``got`` against its float64 reference ``ref``
    (four table cotangents, then ``[N, k]`` lane planes named ``names``):
    the tables at their bars (1e-4 of themselves plus 1e-6 of their
    table's largest), each lane component within rtol = atol = 1e-5 on
    ``min_share`` of lanes; prints the worst lane of each plane and up to
    four lanes beyond the bar with ``path(lane)``.  Returns the max abs
    err."""
    import torch

    shares = {}
    for nm, g, rf in zip(("d_gtab", "d_mtab", "d_ltab", "d_scal"), got[:4], ref[:4]):
        bar = 1e-4 * rf.abs() + 1e-6 * float(rf.abs().max())
        ok = bool(torch.isfinite(g).all()) and bool(((g.double() - rf).abs() <= bar).all())
        check(ok, f"{tag}: {nm} beyond 1e-4 of itself plus 1e-6 of its table's largest")
    for nm, g, rf in zip(names, got[4:], ref[4:]):
        check(bool(torch.isfinite(g).all()), f"{tag}: {nm} not finite")
        close = torch.isclose(g.double(), rf, rtol=1e-5, atol=1e-5).all(-1)
        shares[nm] = float(close.double().mean())
        excess = ((g.double() - rf).abs() / (1e-5 + 1e-5 * rf.abs())).amax(-1)
        beyond = (excess > 1).nonzero()[:, 0]
        i = int(excess.argmax())
        print(f"[grad:check] {tag}: {nm} worst lane {i}: |kernel - float64| "
              f"{float((g[i].double() - rf[i]).abs().max()):.3g}, largest |component| "
              f"{float(rf[i].abs().max()):.4g}, {float(excess[i]):.3g} times the bar; "
              f"{beyond.numel()} lanes beyond it")
        for j in beyond[:4].tolist():
            c = int((g[j].double() - rf[j]).abs().argmax())
            print(f"[grad:check] {tag}: {nm}[{c}] lane {j}: kernel {float(g[j, c]):.9g}, "
                  f"float64 {float(rf[j, c]):.9g}; path {path(j)}")
    worst = max(float((g.double() - rf).abs().max()) for g, rf in zip(got, ref))
    print(f"[grad:check] {tag}: lanes within rtol = atol = 1e-5 of the float64 reference "
          f"{shares}; tables within their bars; max abs err {worst:.3g}")
    check(min(shares.values()) >= min_share,
          f"{tag}: beyond 1e-5 of the float64 reference on > {1 - min_share:.2%} of lanes")
    return worst


def hold_lane_order(tag: str, label: str, tables, resid, feats, depth: int, card: str) -> float:
    """The lane order that kernels 5v and 5s run first (``trace_grad.
    lane_order_cuda``) on ``resid``: its keys equal ``lane_keys_plain``'s on
    every lane, its order is a permutation of the lanes, and the keys in
    that order are the plain keys sorted.  Prints its device time (queued,
    twice) beside the plain version's (the keys and a stable argsort), one
    ``torch.sort`` of the keys (the library call that orders them) and the
    bound (the key planes read, keys and order written).  Returns the device
    ms."""
    import torch

    from pathtracer_tpu_torch.ops import trace_grad

    def order():
        return trace_grad.lane_order_cuda(tables[0], tables[1], resid, feats, depth)

    def plain():
        keys = trace_grad.lane_keys_plain(tables[0], tables[1], resid, feats, depth)
        return keys, torch.argsort(keys, stable=True)

    keys, got = order()
    want, want_order = plain()
    torch.cuda.synchronize()
    n = resid.shape[2]
    perm = torch.equal(torch.sort(got.long()).values, torch.arange(n, device=got.device))
    ok = torch.equal(keys, want) and perm and torch.equal(keys[got.long()], want[want_order])
    costly = int((want > 0).sum())
    print(f"{tag} lane order {label}, {n} lanes: keys equal to plain, the order a permutation "
          f"sorting them: {ok}; {costly} lanes with a costly bounce, "
          f"{len(torch.unique(want))} keys")
    check(ok, f"the lane order differs from its plain version ({label})")
    ms = [queued_ms(order) for _ in range(2)]
    plain_ms = cuda_ms(plain, reps=3)
    library_ms = cuda_ms(lambda: torch.sort(want, stable=True), reps=10)
    # per bounce up to the key's: the alive plane and one more (sigma_s or gid)
    planes = 2 * min(depth, trace_grad.ORDER_BOUNCES)
    bound = (n * planes * 4 + n * 4 * 2) / HBM_BYTES_PER_S * 1e3
    print(f"{tag} lane order {label}: {ms[0]:.4f} / {ms[1]:.4f} ms of device time (queued, "
          f"twice; plain {plain_ms:.3f} ms, torch.sort of the keys {library_ms:.4f} ms), bound "
          f"{bound:.4f} ms by bytes; on {card}")
    return sum(ms) / 2


GRAD_VOL_SPP = 4
GRAD_VOL_WINDOW = 256  # (b)'s vol_nee=False repeat: a 256x256 window of milky's primary rays
# fp32 operations of the adjoint's media blocks per live lane-bounce beyond
# OPS_BWD_ADJOINT, counted by hand from bounce_adj.cuh for a surface event
# (the free path 8, attenuation and its adjoint 24, the medium switch 8); an
# in-medium scatter's volumetric NEE and its sweep are data-dependent and
# left out, so the bounds stay lower bounds
OPS_BWD_VOL = 40


def grad_vol_phase(dev, card: str, out_dir: str, reports: dict) -> list:
    """Phase 13, ``[grad:vol]``: differentiable participating media.
    milky at its 800x800 on the three gradient engines, kernels 4v, 5v, 2r-v
    and 3v against their plain versions, fog on the three engines, the lean
    steps of sss and of fog around the icosphere, times, bounds and
    registers.  Returns the JSON entries of the four new instances."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda, trace
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
    from pathtracer_tpu_torch.scene.structs import Rays
    from pathtracer_tpu_torch.scene.variants import fog_mesh_scene

    scenes_dir = os.path.join(ROOT, "scenes")
    t_last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"[grad:vol:wall] {part} {now - t_last[0]:.1f} s")
        t_last[0] = now

    spp, depth = GRAD_VOL_SPP, 8
    per = spp * depth
    base = RenderConfig(wavefront=False, nee=True, max_depth=depth)
    engines = {
        "full-depth": (base, only(trace_fwd_resid_vol=spp, trace_bwd_vol=spp),
                       ("trace_fwd_kernel", "trace_bwd_kernel", "row_sum")),
        "per-bounce": (dataclasses.replace(base, grad_full_trace=False),
                       only(bounce_replay_vol=per, bounce_bwd_vol=per),
                       ("bounce_kernel", "bounce_bwd_kernel", "row_sum")),
        "lean": (dataclasses.replace(base, grad_fused=False),
                 only(trace_fwd_resid_vol=spp, winner=per),
                 ("trace_fwd_kernel", "winner_kernel")),
    }
    medium_leaves = ("absorption_coefficient", "reduced_scatter_coefficient", "has_scatter",
                     "phase_g")
    step = functools.partial(grad_step, "[grad:vol]", medium_leaves, dev, spp, out_dir)

    def hold_engines(label, steps):
        """The per-bounce and lean steps against the full-depth one: the loss
        within 1e-5 relative, every leaf within 5e-4 of the largest
        gradient."""
        full = steps["full-depth"]
        fl = full["grads"].leaves()
        gscale = max(float(v.abs().max()) for v in fl.values())
        for name in ("per-bounce", "lean"):
            st = steps[name]
            leaves = st["grads"].leaves()
            worst, worst_leaf = max((float((leaves[k] - fl[k]).abs().max()), k) for k in fl)
            loss_rel = abs(float(st["loss"]) - float(full["loss"])) / abs(float(full["loss"]))
            print(f"[grad:vol] {label} {name} against full-depth: loss {loss_rel:.3g} relative, "
                  f"worst leaf {worst_leaf} {worst:.3g} (bar {5e-4 * gscale:.4g})")
            check(loss_rel <= 1e-5, f"{label} {name}: loss {loss_rel:.3g} relative")
            check(worst <= 5e-4 * gscale, f"{label} {name}: {worst_leaf} off by {worst:.3g}")

    # ---- (a) milky at its 800x800 on the three engines
    milky = load_scene(os.path.join(scenes_dir, "milky.txt"))
    steps = {name: step(f"milky {name}", milky, cfg, expect, kernels)
             for name, (cfg, expect, kernels) in engines.items()}
    hold_engines("milky", steps)
    milky_parted = lean_parted_pixels("[grad:vol]", "milky", steps["lean"]["params"],
                                      steps["lean"]["static"], engines["lean"][0], spp)
    check(not bool(milky_parted.any()),
          f"milky: the replayed lean re-trace parts on {int(milky_parted.sum())} pixels")
    engine_launch = {"trace_fwd_resid_vol": steps["full-depth"]["launches"]["trace_fwd_resid_vol"],
                     "trace_bwd_vol": steps["full-depth"]["launches"]["trace_bwd_vol"],
                     "bounce_replay_vol": steps["per-bounce"]["launches"]["bounce_replay_vol"],
                     "bounce_bwd_vol": steps["per-bounce"]["launches"]["bounce_bwd_vol"]}
    lap("(a)")

    # ---- (b) each new kernel against its plain version on the main path's
    # inputs: milky's iteration 0 at its full width (pixel = sample, 640,000
    # lanes) and the wavefront's state after two bounces, vol_nee on as the
    # steps of (a) run it; the vol_nee=False repeat on a 256x256 window
    # around the milky sphere.  The times and bounds are the full width's.
    params, static = diff.params_from_description(milky, 0, device=dev)
    cfg = resolve_features(base, params.materials)
    feats = frozenset(cfg.features)
    seed = key_to_seed(prng_key(0))
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in engine_launch}
    with torch.no_grad():
        scene = diff.build_scene(params, static)
        tables = [t.contiguous() for t in pack_tables(scene)]
        w, h = static.resolution
        n_full = w * h
        pixel = torch.arange(n_full, dtype=torch.int64, device=dev)
        rays_all = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
        _, gid = intersect_cuda.winner_t_gid_cuda(rays_all, tables[0])
        scatterers = [g for g, m in enumerate(scene.geoms.material_id.tolist())
                      if float(scene.materials.has_scatter[m]) > 0]
        on_sphere = torch.isin(gid, torch.tensor(scatterers, device=dev))
        on = on_sphere.nonzero()[:, 0]
        cy, cx = int((on // w).float().median()), int((on % w).float().median())
        half = GRAD_VOL_WINDOW // 2
        y0, x0 = min(max(cy - half, 0), h - GRAD_VOL_WINDOW), min(max(cx - half, 0),
                                                               w - GRAD_VOL_WINDOW)
        window = ((torch.arange(GRAD_VOL_WINDOW, device=dev)[:, None] + y0) * w
                  + torch.arange(GRAD_VOL_WINDOW, device=dev)[None, :] + x0).reshape(-1)
        print(f"[grad:vol] (b) vol_nee=True on all {n_full} lanes, {int(on_sphere.sum())} of "
              f"them on the milky sphere; vol_nee=False on {window.numel()} lanes at rows "
              f"{y0}.., columns {x0}.., {int(on_sphere[window].sum())} of them on the sphere")

        timing_args = {}
        for vol_nee, lanes in ((True, pixel), (False, window)):
            n = lanes.numel()
            o0, d0 = rays_all.origin[lanes].contiguous(), rays_all.direction[lanes].contiguous()
            kw = dict(max_depth=depth, nee=True, rr=False, rr_start=base.rr_start,
                      features=feats, vol_nee=vol_nee)
            args = (*tables, seed, o0, d0, lanes)
            rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, **kw)
            rad_t, nr_t = trace.trace_cuda(*args, **kw)
            rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, **kw)
            torch.cuda.synchronize()
            same = torch.equal(rad_k, rad_p) and torch.equal(res_k, res_p)
            print(f"[grad:check] 4v vol_nee={vol_nee}, {n} lanes: rays {int(nr_k)} (kernel 1v "
                  f"{int(nr_t)}, plain {int(nr_p)}); radiance and all {res_k.shape[1]} residual "
                  f"planes equal to plain: {same}; radiance equal to kernel 1v: "
                  f"{torch.equal(rad_k, rad_t)}; lane-bounces in the medium "
                  f"{int((res_k[:, trace_grad.R_SS] > 0).sum())}")
            check(same and torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t) == int(nr_p),
                  f"kernel 4v differs from its plain version (vol_nee={vol_nee})")
            err["trace_fwd_resid_vol"] = max(err["trace_fwd_resid_vol"],
                                             float((rad_k - rad_p).abs().max()))
            del rad_t, rad_p, res_p
            g_rad = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
            bargs = (*tables, seed, lanes, res_k, g_rad)
            got = trace_grad.tbwd_cuda(*bargs, **kw)
            ref = trace_grad.tbwd_plain(*bargs, dtype=torch.float64, **kw)
            torch.cuda.synchronize()
            err["trace_bwd_vol"] = max(err["trace_bwd_vol"], hold_adjoint(
                f"5v vol_nee={vol_nee}", got, ref, ("d_origin", "d_direction"),
                lambda j: trace_grad.lane_events(tables[0], seed, lanes, res_k, j, feats)))
            del ref
            if vol_nee:
                timing_args["4v"] = (args, kw, int(nr_k))
                timing_args["5v"] = (bargs, kw, got)
                hold_lane_order("[grad:vol:check]", "milky", tables, res_k, feats, depth, card)

            # 2r-v and 3v: the primary rays, and the state after two bounces
            # (the scan's carry update, the medium carried)
            medium = torch.zeros((n, 4), **f32)
            state = dict(origin=o0, direction=d0, throughput=torch.ones((n, 3), **f32),
                         depth=torch.zeros(n, dtype=torch.int32, device=dev),
                         prev=torch.zeros(n, **f32), medium=medium)
            states = {"primary": state}
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            for dep in range(2):
                res = bounce_fused.bounce_fused_cuda(
                    tables, state["origin"], state["direction"], state["throughput"], lanes, dep,
                    state["prev"], state["medium"], seed, nee=True, features=feats,
                    vol_nee=vol_nee)
                alive = alive & ~res.terminate
                a = alive[:, None]
                state = dict(origin=torch.where(a, res.next_origin, state["origin"]),
                             direction=torch.where(a, res.next_direction, state["direction"]),
                             throughput=torch.where(a, state["throughput"] * res.throughput_mult,
                                                    state["throughput"]),
                             depth=torch.full((n,), dep + 1, dtype=torch.int32, device=dev),
                             prev=res.was_specular, medium=res.next_medium)
            states["after 2 bounces"] = state
            for label, st in states.items():
                args2 = (tables, st["origin"], st["direction"], st["throughput"], lanes,
                         st["depth"], st["prev"])
                rkw = dict(nee=True, features=feats, vol_nee=vol_nee)
                got2, rgid, rnee = bounce_fused.bounce_fused_cuda(*args2, st["medium"], seed,
                                                                  emit_replay=True, **rkw)
                plain2, pgid, pnee = bounce_fused.bounce_fused_plain(*args2, st["medium"], seed,
                                                                     emit_replay=True, **rkw)
                torch.cuda.synchronize()
                same = (torch.equal(rgid, pgid) and torch.equal(rnee, pnee)
                        and all(torch.equal(getattr(got2, f.name), getattr(plain2, f.name))
                                for f in dataclasses.fields(got2)))
                for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
                    err["bounce_replay_vol"] = max(err["bounce_replay_vol"], float(
                        (getattr(got2, f) - getattr(plain2, f)).abs().max()))
                in_med = int((st["medium"][:, 3] > 0).sum())
                print(f"[grad:check] 2r-v vol_nee={vol_nee} {label}, {n} lanes: every output and "
                      f"the replay planes equal to plain: {same}; {in_med} lanes in a scattering "
                      f"medium, {int((rgid < 0).sum())} misses, {int(rnee.sum())} NEE "
                      f"connections")
                check(same, f"kernel 2r-v differs from its plain version ({label})")
                cots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                        for _ in range(4)]
                g_med = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).to(dev)
                b2 = (*args2, rgid, rnee, *cots, seed)
                bkw = dict(nee=True, features=feats, medium=st["medium"], g_medium=g_med,
                           vol_nee=vol_nee)
                got3 = bounce_grad.bounce_bwd_cuda(*b2, **bkw)
                ref3 = bounce_grad.bounce_bwd_plain(*b2, dtype=torch.float64, **bkw)
                torch.cuda.synchronize()

                def path(j, st=st, rgid=rgid, rnee=rnee):
                    return (f"sigma_s {float(st['medium'][j, 3]):.6g}, gid {int(rgid[j])}, "
                            f"NEE bit {int(rnee[j])}")

                err["bounce_bwd_vol"] = max(err["bounce_bwd_vol"], hold_adjoint(
                    f"3v vol_nee={vol_nee} {label}", got3, ref3,
                    ("d_origin", "d_direction", "d_throughput", "d_medium"), path))
                del ref3
                if vol_nee and label != "primary":
                    timing_args["2r-v"] = (args2, st["medium"], rkw)
                    timing_args["3v"] = (b2, bkw, got3)
        lap("(b)")

        # ---- times: each kernel's device time from the profiler, its plain
        # version by CUDA events, its bound from this run's inputs
        args, kw, nrays4 = timing_args["4v"]
        bargs, _, got5 = timing_args["5v"]
        args2, med2, rkw = timing_args["2r-v"]
        b2, bkw, got3 = timing_args["3v"]
        dev_ms = {}
        dev_ms["4v"] = device_ms(lambda: trace_grad.tfwd_cuda(*args, **kw),
                                 ["trace_fwd_kernel"])["trace_fwd_kernel"][0]
        dev_ms["5v"] = adjoint_split("[grad:vol:time]", "kernel 5v, milky's iteration 0",
                                     lambda: trace_grad.tbwd_cuda(*bargs, **kw),
                                     "trace_bwd_kernel", n_full, card)
        dev_ms["2r-v"] = device_ms(lambda: bounce_fused.bounce_fused_cuda(
            *args2, med2, seed, emit_replay=True, **rkw), ["bounce_kernel"])["bounce_kernel"][0]
        dev_ms["3v"] = adjoint_split("[grad:vol:time]", "kernel 3v, milky after two bounces",
                                     lambda: bounce_grad.bounce_bwd_cuda(*b2, **bkw),
                                     "bounce_bwd_kernel", n_full, card)
        plain_ms = {
            "4v": cuda_ms(lambda: trace_grad.tfwd_plain(*args, **kw), reps=1),
            "5v": cuda_ms(lambda: trace_grad.tbwd_plain(*bargs, **kw), reps=1),
            "2r-v": cuda_ms(lambda: bounce_fused.bounce_fused_plain(
                *args2, med2, seed, emit_replay=True, **rkw), reps=1),
            "3v": cuda_ms(lambda: bounce_grad.bounce_bwd_plain(*b2, **bkw), reps=1),
        }
    lap("(b) times")

    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    table_bytes = sum(t.numel() * 4 for t in tables)
    row_bytes = sum(t.numel() * 4 for t in got5[:4])

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    lane_bounces, n = nrays4 // 2, n_full
    adj = OPS_TO_OBJECT + min(OPS_SPHERE, OPS_CUBE) + OPS_SHADE + OPS_BWD_ADJOINT + OPS_BWD_VOL
    planes = trace_grad.N_RESID_VOL
    bounds = {
        # origin, direction, sample in; radiance and the 17 planes per bounce out
        "4v": bound(lane_bounces * (sweep + OPS_SHADE + OPS_VOL),
                    n * (12 + 12 + 4 + 12) + depth * planes * n * 4 + table_bytes),
        # the alive plane of every bounce, the other 16 planes of the live
        # ones, sample and radiance cotangent in; d_origin, d_direction, the
        # row out; the float recompute and the double adjoint apart
        "5v": adjoint_bound(lane_bounces * (adj - OPS_BWD_ADJOINT - OPS_BWD_VOL),
                            lane_bounces * (OPS_BWD_ADJOINT + OPS_BWD_VOL),
                            depth * n * 4 + lane_bounces * (planes - 1) * 4
                            + n * (4 + 12 + 12 + 12) + table_bytes + row_bytes),
        # 16 planes in (64 B); 20 float planes and a terminate byte out (81 B)
        "2r-v": bound(n * (sweep + OPS_SHADE + OPS_VOL), n * (64 + 81) + table_bytes),
        # o, d, thr, sample, depth, emit state, two replay planes, four [N, 3]
        # cotangents, the medium and its cotangent in (136 B); d_o, d_d, d_thr,
        # d_medium out (52 B); the tables and the row
        "3v": bound(n * adj, n * (136 + 52) + table_bytes + row_bytes),
    }

    # ---- (c) fog at its 200x200 on the three engines
    fog = load_scene(os.path.join(scenes_dir, "fog.txt"))
    fog_steps = {name: step(f"fog {name}", fog, cfg, expect)
                 for name, (cfg, expect, _) in engines.items()}
    hold_engines("fog", fog_steps)
    lap("(c)")

    # ---- (d) two lean steps: sss at 512x512 (the hg instance forward) and
    # fog's cube around the icosphere (media in a mesh scene, 1m-vol forward)
    sss = dataclasses.replace(load_scene(os.path.join(scenes_dir, "sss.txt")),
                              resolution=VOL_RES)
    st = step("sss lean", sss, base, only(trace_hg=spp, winner=per, occlusion=per),
              ("trace_kernel", "winner_kernel", "occlusion_kernel"))
    lean = dataclasses.replace(base, grad_fused=False)
    lean_parted_pixels("[grad:vol]", "sss", st["params"], st["static"], lean, 1)
    fog_mesh = parse_scene_text(fog_mesh_scene(True), name="fog_mesh_glass", scene_dir=scenes_dir)
    st = step("fog_mesh_glass lean", fog_mesh, base,
              only(trace_mesh_vol=spp, winner=per, occlusion=per, mesh_nearest=per,
                   mesh_min=2 * per))
    lean_parted_pixels("[grad:vol]", "fog_mesh_glass", st["params"], st["static"], lean, 1)
    lap("(d)")

    # ---- registers: the new instances, and the vacuum ones keep theirs
    instances = ptxas_instances(reports)
    regs = {
        "4": instance_regs(instances, "trace_grad", "trace_fwd_kernel_packed", False, False),
        "4v": instance_regs(instances, "trace_grad", "trace_fwd_kernel_packed", True, False),
        "5": instance_regs(instances, "trace_grad", "trace_bwd_kernel", False, False),
        "5v": instance_regs(instances, "trace_grad", "trace_bwd_kernel", True, False),
        "3": instance_regs(instances, "bounce_grad", "bounce_bwd_kernel", False, False),
        "3v": instance_regs(instances, "bounce_grad", "bounce_bwd_kernel", True, False),
        "2r-v": instance_regs(instances, "bounce", "bounce_kernel_grouped"),
    }
    print(f"[grad:vol:regs] registers, spill store / load bytes per instance: {regs}")
    # the vacuum instances' registers, pinned: 4 at FWD4_REGS; 5 and 3 went
    # from 156 and 140 to 148 and 136 when their light and winner adjoints
    # were factored out for the media instances to share, and 3 to 158 with
    # its table row in device memory and the skip of zero-cotangent lanes,
    # then to 152 with its row sums; 5 to 168 with its row in device memory
    # and the lane sums of NEE's light columns (each still three blocks per
    # SM; PERF.md)
    for key, want in (("4", FWD4_REGS), ("5", (168,)), ("3", BWD3_REGS)):
        check(regs[key] is None or regs[key][:len(want)] == want,
              f"Cornell's kernel {key} uses {regs[key]} registers and spill bytes, not {want}")
    print(f"[card] {card}")
    for key in ("4v", "5v", "2r-v", "3v"):
        per_lane = f", {lane_bounces / n:.4f} bounces per lane of {depth}" if key == "4v" else ""
        print(f"[grad:vol:time] kernel {key}: {dev_ms[key]:.4f} ms of device time at {n} lanes"
              f"{per_lane} (plain {plain_ms[key]:.3f} ms), bound {bounds[key][0]:.4f} ms by "
              f"{bounds[key][1]}; on {card}")

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": name, **common, "source": f"pathtracer_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": engine_launch[name], "max_abs_err": err[name],
         "ms": dev_ms[key], "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1], **({"design": KERNEL2_GROUPED} if key == "2r-v" else {})}
        for name, key, src, rep in (
            ("trace_fwd_resid_vol", "4v", "trace_grad.cu", "pathtracer_tpu/ops/trace_grad.py:115"),
            ("trace_bwd_vol", "5v", "trace_grad.cu", "pathtracer_tpu/ops/trace_grad.py:190"),
            ("bounce_replay_vol", "2r-v", "bounce.cu", "pathtracer_tpu/ops/bounce_grad.py:226"),
            ("bounce_bwd_vol", "3v", "bounce_grad.cu", "pathtracer_tpu/ops/bounce_grad.py:91"),
        )
    ]


GRAD_SURF_SPP = 4
# fp32 operations of the Ward lobe per lane-bounce that samples it, counted
# by hand from trace_common.cuh:ward_lobe (the clamps and the azimuth 20,
# the half-vector's angles 17, the tangent frame 28, the half vector and
# the reflection 24, the weight 18: 107), and of its adjoint beyond
# OPS_BWD_ADJOINT (bounce_adj.cuh:ward_adj: the recomputed lobe, the
# weight's and the angles' adjoints 60, the frame's 130, the reflection's
# 20: 317); the times and bounds of [grad:surf] are ward's, whose brushed
# floor and sphere take this lobe on the lanes counted from the run's
# winners
OPS_WARD = 107
OPS_WARD_ADJ = 317


def grad_surf_phase(dev, card: str, out_dir: str, reports: dict) -> list:
    """Phase 14, ``[grad:surf]``: differentiable surface physics.  ward at
    ``bench.py``'s 512x512 and textured at its 800x800 on the three gradient
    engines, textured_image at 512x512 on the lean engine (the atlas a
    leaf), kernels 4s, 5s, 2r-s and 3s against their plain versions on
    ward's and textured's iteration-0 lanes, times, bounds and registers.
    Returns the JSON entries of the four new instances."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, trace, trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.parser import load_scene

    scenes_dir = os.path.join(ROOT, "scenes")
    t_last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"[grad:surf:wall] {part} {now - t_last[0]:.1f} s")
        t_last[0] = now

    spp, depth = GRAD_SURF_SPP, 8
    per = spp * depth
    base = RenderConfig(wavefront=False, nee=True, max_depth=depth)
    engines = {
        "full-depth": (base, only(trace_fwd_resid_surf=spp, trace_bwd_surf=spp),
                       ("trace_fwd_kernel", "trace_bwd_kernel", "row_sum")),
        "per-bounce": (dataclasses.replace(base, grad_full_trace=False),
                       only(bounce_replay_surf=per, bounce_bwd_surf=per),
                       ("bounce_kernel", "bounce_bwd_kernel", "row_sum")),
        "lean": (dataclasses.replace(base, grad_fused=False),
                 only(trace_fwd_resid_surf=spp, winner=per),
                 ("trace_fwd_kernel", "winner_kernel")),
    }
    surface_leaves = ("texture_color2", "bump_scale", "bump_amp", "specular_color", "roughness",
                      "roughness_y")

    step = functools.partial(grad_step, "[grad:surf]", surface_leaves, dev, spp, out_dir)

    def masked_grads(params, static, cfg, weight):
        """The gradient of the mean squared error (target zeros) over the
        pixels ``weight`` keeps, by the engine of ``cfg``, through
        ``render_linear`` as ``loss_and_grad`` runs it."""
        names, values = zip(*params.leaves().items())
        leaves = [v.detach().requires_grad_(True) for v in values]
        hw = None if params.textures is None else params.textures.hw
        p = diff.SceneParams.from_leaves(dict(zip(names, leaves)), hw)
        with torch.enable_grad():
            img = diff.render_linear(p, static, spp, prng_key(0), cfg)
            loss = torch.mean(weight[:, None] * img ** 2)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), {k: torch.zeros_like(x) if g is None else g
                                      for k, g, x in zip(names, grads, leaves)}

    albedo = ("materials.color", "materials.specular_color", "materials.emittance",
              "materials.texture_color2")

    def leaf_errs(got, want):
        """Each leaf's largest |got - want| over its bar, 5e-4 of its own
        largest |want| entry (of the largest gradient, for a leaf that
        ``want`` gives none)."""
        gscale = max(float(v.abs().max()) for v in want.values())
        out = {}
        for k, w in want.items():
            scale = float(w.abs().max()) or gscale
            out[k] = float((got[k] - w).abs().max()) / (5e-4 * scale)
        return out

    def hold_engines(label, steps):
        """The three engines' losses equal; every leaf of the per-bounce and
        the lean steps within 5e-4 of the full-depth step's largest entry of
        that leaf, over every pixel.  The lean step's forward is kernel 4s
        and its backward replays each bounce's winner, NEE bit and ray, so
        it differentiates the paths the forward counted at the forward's
        values; the pixels whose replayed re-trace still parts from the
        forward are counted and printed with their paths (ward: none).  On
        textured the lean albedo leaves are also held over the pixels that
        keep the path, as before the replay; there the float32 forward's
        last bits still decide the geometry, camera and bump derivatives of
        the bumped sphere's re-hits for every engine alike, against their
        float64 derivative (``tests/test_torch_surface_diff.py::
        test_textured_gradient_against_float64_paths``; ROADMAP queue 3,
        open)."""
        full = steps["full-depth"]
        fl = full["grads"].leaves()
        gscale = max(float(v.abs().max()) for v in fl.values())
        for name in ("per-bounce", "lean"):
            st = steps[name]
            leaves = st["grads"].leaves()
            worst, worst_leaf = max((float((leaves[k] - fl[k]).abs().max()), k) for k in fl)
            rel = leaf_errs(leaves, fl)
            k_rel = max(rel, key=rel.get)
            print(f"[grad:surf] {label} {name} against full-depth: loss {float(st['loss']):.9g} "
                  f"vs {float(full['loss']):.9g}, worst leaf {worst_leaf} {worst:.3g} (the "
                  f"gscale bar {5e-4 * gscale:.4g}); leaf by leaf, the worst {k_rel} at "
                  f"{rel[k_rel]:.3g} of its bar")
            check(float(st["loss"]) == float(full["loss"]), f"{label} {name}: loss differs")
            check(rel[k_rel] <= 1.0, f"{label} {name}: {k_rel} at {rel[k_rel]:.3g} of its bar")
        params, static = full["params"], full["static"]
        parted = lean_parted_pixels("[grad:surf]", label, params, static,
                                    dataclasses.replace(base, grad_fused=False), spp)
        if label == "ward":
            check(not bool(parted.any()), f"ward: the replayed lean re-trace parts on "
                  f"{int(parted.sum())} pixels")
            return int(parted.sum())
        print(f"[grad:surf] {label} lean: {int(parted.sum())} parted pixels under replay "
              f"(2,642 when the re-trace ran its own searches)")
        weight = (~parted).float()
        ml_full, mg_full = masked_grads(params, static, base, weight)
        ml_lean, mg_lean = masked_grads(params, static, dataclasses.replace(base, grad_fused=False),
                                        weight)
        rel = leaf_errs(mg_lean, mg_full)
        k_held = max(albedo, key=rel.get)
        print(f"[grad:surf] {label} lean over the {int((~parted).sum())} pixels whose replayed "
              f"re-trace keeps the path: the loss {ml_lean:.9g} vs {ml_full:.9g}; the albedo "
              f"leaves, of each leaf's bar: " + ", ".join(f"{k} {rel[k]:.3g}" for k in albedo))
        check(ml_lean == ml_full and rel[k_held] <= 1.0,
              f"{label} lean over the pixels it keeps: {k_held} at {rel[k_held]:.3g} of its bar")
        check(float(parted.float().mean()) <= 0.01, f"{label}: the lean re-trace parts on > 1%")
        return int(parted.sum())

    # ---- (a) ward at 512x512 and textured at its 800x800 on the three
    # engines (ward's full-depth step profiled), textured_image on the lean
    # engine with the atlas a leaf
    ward = dataclasses.replace(load_scene(os.path.join(scenes_dir, "ward.txt")),
                               resolution=SURF_RES)
    textured = load_scene(os.path.join(scenes_dir, "textured.txt"))
    steps, parted = {}, {}
    for sname, desc in (("ward", ward), ("textured", textured)):
        steps[sname] = {
            name: step(f"{sname} {name}", desc, cfg, expect,
                       kernels if (sname, name) == ("ward", "full-depth") else None)
            for name, (cfg, expect, kernels) in engines.items()}
        parted[sname] = hold_engines(sname, steps[sname])
    engine_launch = {
        "trace_fwd_resid_surf": steps["ward"]["full-depth"]["launches"]["trace_fwd_resid_surf"],
        "trace_bwd_surf": steps["ward"]["full-depth"]["launches"]["trace_bwd_surf"],
        "bounce_replay_surf": steps["ward"]["per-bounce"]["launches"]["bounce_replay_surf"],
        "bounce_bwd_surf": steps["ward"]["per-bounce"]["launches"]["bounce_bwd_surf"]}
    timg = dataclasses.replace(load_scene(os.path.join(scenes_dir, "textured_image.txt")),
                               resolution=SURF_RES)
    st = step("textured_image lean", timg, base, only(bounce_tex=per, winner=per, occlusion=per))
    lean_parted_pixels("[grad:surf]", "textured_image", st["params"], st["static"],
                       dataclasses.replace(base, grad_fused=False), 1)
    g_tex = st["grads"].textures.data
    shown = int((g_tex.abs().sum(-1) > 0).sum())
    print(f"[grad:surf] textured_image: atlas {tuple(g_tex.shape)}, {shown} texels with a "
          f"gradient, largest |gradient| {float(g_tex.abs().max()):.4g}")
    check(bool(torch.isfinite(g_tex).all()) and shown > 0, "textured_image: no texel gradient")
    lap("(a)")

    # ---- (b) each new kernel against its plain version on the main path's
    # inputs: the iteration-0 lanes (pixel = sample) of ward and textured,
    # and for 2r-s and 3s the wavefront's state after two bounces.  The
    # times and bounds are ward's.
    seed = key_to_seed(prng_key(0))
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    err = {k: 0.0 for k in engine_launch}
    timing_args = {}

    with torch.no_grad():
        for sname, desc in (("ward", ward), ("textured", textured)):
            params = steps[sname]["full-depth"]["params"]
            scene = diff.build_scene(params, diff.params_from_description(desc, 0, device=dev)[1])
            cfg = resolve_features(base, params.materials)
            feats = frozenset(cfg.features)
            tables = [t.contiguous() for t in pack_tables(scene)]
            w, h = scene.camera.width, scene.camera.height
            n = w * h
            lanes = torch.arange(n, dtype=torch.int64, device=dev)
            rays = generate_camera_rays(scene.camera, lanes, camera_uniforms(seed, lanes))
            o0, d0 = rays.origin.contiguous(), rays.direction.contiguous()
            kw = dict(max_depth=depth, nee=True, rr=False, rr_start=base.rr_start, features=feats)
            args = (*tables, seed, o0, d0, lanes)
            rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, **kw)
            rad_t, nr_t = trace.trace_cuda(*args, **kw)
            rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, **kw)
            torch.cuda.synchronize()
            same = torch.equal(rad_k, rad_p) and torch.equal(res_k, res_p)
            print(f"[grad:check] 4s {sname} {sorted(feats)}, {n} lanes: rays {int(nr_k)} (kernel "
                  f"1s {int(nr_t)}, plain {int(nr_p)}); radiance and all {res_k.shape[1]} "
                  f"residual planes equal to plain: {same}; radiance equal to kernel 1s: "
                  f"{torch.equal(rad_k, rad_t)}")
            check(same and torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t) == int(nr_p),
                  f"kernel 4s differs from its plain version ({sname})")
            err["trace_fwd_resid_surf"] = max(err["trace_fwd_resid_surf"],
                                              float((rad_k - rad_p).abs().max()))
            del rad_t, rad_p, res_p
            g_rad = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
            bargs = (*tables, seed, lanes, res_k, g_rad)
            got = trace_grad.tbwd_cuda(*bargs, **kw)
            ref = trace_grad.tbwd_plain(*bargs, dtype=torch.float64, **kw)
            torch.cuda.synchronize()
            err["trace_bwd_surf"] = max(err["trace_bwd_surf"], hold_adjoint(
                f"5s {sname}", got, ref, ("d_origin", "d_direction"),
                lambda j, t=tables[0], r=res_k, ls=lanes, f=feats: trace_grad.lane_events(
                    t, seed, ls, r, j, f)))
            del ref
            if sname == "ward":
                # the live lane-bounces whose winner's material samples the Ward lobe
                tail = trace_grad.tail_plane(feats)
                gid = res_k[:, tail + 2].long()
                ward_mat = (tables[1][:, 6] > 0) & (tables[1][:, 24] > 1.5)
                on_ward = ((res_k[:, tail + 1] > 0.5) & (gid >= 0)
                           & ward_mat[tables[0][gid.clamp(min=0), 13].long()])
                timing_args["4s"] = (args, kw, int(nr_k), int(on_ward.sum()))
                timing_args["5s"] = (bargs, kw, got)
                hold_lane_order("[grad:surf:check]", "ward", tables, res_k, feats, depth, card)

            # 2r-s and 3s: the primary rays, and the state after two bounces
            medium = torch.zeros((n, 4), **f32)
            state = dict(origin=o0, direction=d0, throughput=torch.ones((n, 3), **f32),
                         depth=torch.zeros(n, dtype=torch.int32, device=dev),
                         prev=torch.zeros(n, **f32))
            states = {"primary": state}
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            for dep in range(2):
                res = bounce_fused.bounce_fused_cuda(
                    tables, state["origin"], state["direction"], state["throughput"], lanes, dep,
                    state["prev"], medium, seed, nee=True, features=feats)
                alive = alive & ~res.terminate
                a = alive[:, None]
                state = dict(origin=torch.where(a, res.next_origin, state["origin"]),
                             direction=torch.where(a, res.next_direction, state["direction"]),
                             throughput=torch.where(a, state["throughput"] * res.throughput_mult,
                                                    state["throughput"]),
                             depth=torch.full((n,), dep + 1, dtype=torch.int32, device=dev),
                             prev=res.was_specular)
            states["after 2 bounces"] = state
            for label, st in states.items():
                args2 = (tables, st["origin"], st["direction"], st["throughput"], lanes,
                         st["depth"], st["prev"])
                rkw = dict(nee=True, features=feats)
                got2, rgid, rnee = bounce_fused.bounce_fused_cuda(*args2, medium, seed,
                                                                  emit_replay=True, **rkw)
                plain2, pgid, pnee = bounce_fused.bounce_fused_plain(*args2, medium, seed,
                                                                     emit_replay=True, **rkw)
                torch.cuda.synchronize()
                same = (torch.equal(rgid, pgid) and torch.equal(rnee, pnee)
                        and all(torch.equal(getattr(got2, f.name), getattr(plain2, f.name))
                                for f in dataclasses.fields(got2)))
                for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
                    err["bounce_replay_surf"] = max(err["bounce_replay_surf"], float(
                        (getattr(got2, f) - getattr(plain2, f)).abs().max()))
                print(f"[grad:check] 2r-s {sname} {label}, {n} lanes: every output and the "
                      f"replay planes equal to plain: {same}; {int((rgid < 0).sum())} misses, "
                      f"{int(rnee.sum())} NEE connections")
                check(same, f"kernel 2r-s differs from its plain version ({sname} {label})")
                cots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                        for _ in range(4)]
                b2 = (*args2, rgid, rnee, *cots, seed)
                bkw = dict(nee=True, features=feats)
                got3 = bounce_grad.bounce_bwd_cuda(*b2, **bkw)
                ref3 = bounce_grad.bounce_bwd_plain(*b2, dtype=torch.float64, **bkw)
                torch.cuda.synchronize()

                def path(j, st=st, rgid=rgid, rnee=rnee, gtab=tables[0]):
                    gid = int(rgid[j])
                    mid = int(gtab[gid, 13]) if gid >= 0 else -1
                    return (f"depth {int(st['depth'][j])}, gid {gid}, material {mid}, NEE bit "
                            f"{int(rnee[j])}")

                err["bounce_bwd_surf"] = max(err["bounce_bwd_surf"], hold_adjoint(
                    f"3s {sname} {label}", got3, ref3,
                    ("d_origin", "d_direction", "d_throughput"), path))
                del ref3
                # 3s orders its lanes by branch: in index order every lane's
                # outputs are the same
                index3 = bounce_grad.bounce_bwd_cuda(*b2, ordered=False, **bkw)
                torch.cuda.synchronize()
                same3 = all(torch.equal(a, b) for a, b in zip(got3[4:], index3[4:]))
                print(f"[grad:check] 3s {sname} {label}: lanes in key order bit-equal to index "
                      f"order: {same3}")
                check(same3, f"3s's lane order changes a lane's outputs ({sname} {label})")
                del index3
                if sname == "ward" and label != "primary":
                    mids = tables[0][rgid.long().clamp(min=0), 13].long()
                    on_ward2 = int(((rgid >= 0) & ward_mat[mids]).sum())
                    timing_args["2r-s"] = (args2, medium, rkw, on_ward2)
                    timing_args["3s"] = (b2, bkw, got3)
            if sname == "ward":
                ward_scene, ward_tables, n_ward = scene, tables, n
        lap("(b)")

        # ---- (c) times: each kernel's device time from the profiler on
        # ward's inputs, its plain version by CUDA events, its bound from
        # this run's inputs
        args, kw, nrays4, ward4 = timing_args["4s"]
        bargs, _, got5 = timing_args["5s"]
        args2, med2, rkw, ward2 = timing_args["2r-s"]
        b2, bkw, got3 = timing_args["3s"]
        dev_ms = {
            "4s": device_ms(lambda: trace_grad.tfwd_cuda(*args, **kw),
                            ["trace_fwd_kernel"])["trace_fwd_kernel"][0],
            "5s": adjoint_split("[grad:surf:time]", "kernel 5s, ward's iteration 0",
                                lambda: trace_grad.tbwd_cuda(*bargs, **kw), "trace_bwd_kernel",
                                n_ward, card),
            "2r-s": device_ms(lambda: bounce_fused.bounce_fused_cuda(
                *args2, med2, seed, emit_replay=True, **rkw),
                ["bounce_kernel"])["bounce_kernel"][0],
            "3s": adjoint_split("[grad:surf:time]", "kernel 3s, ward after two bounces",
                                lambda: bounce_grad.bounce_bwd_cuda(*b2, **bkw),
                                "bounce_bwd_kernel", n_ward, card),
        }
        # 3s's lane order (two short kernels before it) counts in its time
        order3 = device_ms(lambda: bounce_grad.bounce_bwd_cuda(*b2, **bkw), ["lane_order"],
                           per_call=2)["lane_order"][0] * 2
        print(f"[grad:surf:time] kernel 3s's lane order {order3:.4f} ms of device time per "
              f"call; on {card}")
        dev_ms["3s"] += order3
        plain_ms = {
            "4s": cuda_ms(lambda: trace_grad.tfwd_plain(*args, **kw), reps=1),
            "5s": cuda_ms(lambda: trace_grad.tbwd_plain(*bargs, **kw), reps=1),
            "2r-s": cuda_ms(lambda: bounce_fused.bounce_fused_plain(
                *args2, med2, seed, emit_replay=True, **rkw), reps=1),
            "3s": cuda_ms(lambda: bounce_grad.bounce_bwd_plain(*b2, **bkw), reps=1),
        }
    lap("(c) times")

    types = ward_scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    table_bytes = sum(t.numel() * 4 for t in ward_tables)
    row_bytes = sum(t.numel() * 4 for t in got5[:4])

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    lane_bounces, n = nrays4 // 2, n_ward
    adj = OPS_TO_OBJECT + min(OPS_SPHERE, OPS_CUBE) + OPS_SHADE + OPS_BWD_ADJOINT
    planes = trace_grad.N_RESID
    print(f"[grad:surf] ward: {ward4} of {lane_bounces} live lane-bounces of iteration 0 and "
          f"{ward2} of the {n} lanes after two bounces sample the Ward lobe")
    bounds = {
        # origin, direction, sample in; radiance and the 13 planes per bounce out
        "4s": bound(lane_bounces * (sweep + OPS_SHADE) + ward4 * OPS_WARD,
                    n * (12 + 12 + 4 + 12) + depth * planes * n * 4 + table_bytes),
        # the alive plane of every bounce, the other 12 planes of the live
        # ones, sample and radiance cotangent in; d_origin, d_direction, the
        # row out; the float recompute and the double adjoint apart
        "5s": adjoint_bound(lane_bounces * (adj - OPS_BWD_ADJOINT) + ward4 * OPS_WARD,
                            lane_bounces * OPS_BWD_ADJOINT + ward4 * (OPS_WARD_ADJ - OPS_WARD),
                            depth * n * 4 + lane_bounces * (planes - 1) * 4
                            + n * (4 + 12 + 12 + 12) + table_bytes + row_bytes),
        # 16 planes in (64 B); 20 float planes and a terminate byte out (81 B)
        "2r-s": bound(n * (sweep + OPS_SHADE) + ward2 * OPS_WARD, n * (64 + 81) + table_bytes),
        # o, d, thr, sample, depth, emit state, two replay planes, four [N, 3]
        # cotangents in (120 B); d_o, d_d, d_thr out (36 B); the tables and the row
        "3s": bound(n * adj + ward2 * OPS_WARD_ADJ, n * (120 + 36) + table_bytes + row_bytes),
    }

    # ---- registers: the new instances, and the vacuum ones keep theirs
    instances = ptxas_instances(reports)
    regs = {
        "4s": instance_regs(instances, "trace_grad", "trace_fwd_kernel", False, True),
        "5s": instance_regs(instances, "trace_grad", "trace_bwd_kernel", False, True),
        "4v-s": instance_regs(instances, "trace_grad", "trace_fwd_kernel", True, True),
        "5v-s": instance_regs(instances, "trace_grad", "trace_bwd_kernel", True, True),
        "3s": instance_regs(instances, "bounce_grad", "bounce_bwd_kernel", False, True),
        "3v-s": instance_regs(instances, "bounce_grad", "bounce_bwd_kernel", True, True),
        "2r-s": instance_regs(instances, "bounce", "bounce_kernel", 0, 0, 0, 1, 0),
        "4": instance_regs(instances, "trace_grad", "trace_fwd_kernel_packed", False, False),
        "5": instance_regs(instances, "trace_grad", "trace_bwd_kernel", False, False),
        "3": instance_regs(instances, "bounce_grad", "bounce_bwd_kernel", False, False),
    }
    print(f"[grad:surf:regs] registers, spill store / load bytes per instance: {regs}")
    for key, want in (("4", FWD4_REGS), ("5", (168,)), ("3", BWD3_REGS), ("3s", BWD3S_REGS)):
        check(regs[key] is None or regs[key][:len(want)] == want,
              f"kernel {key} uses {regs[key]} registers and spill bytes, not {want}")
    print(f"[card] {card}")
    for key in ("4s", "5s", "2r-s", "3s"):
        per_lane = f", {lane_bounces / n:.4f} bounces per lane of {depth}" if key == "4s" else ""
        print(f"[grad:surf:time] kernel {key}: {dev_ms[key]:.4f} ms of device time at {n} lanes "
              f"of ward{per_lane} (plain {plain_ms[key]:.3f} ms), bound {bounds[key][0]:.4f} ms "
              f"by {bounds[key][1]}; on {card}")

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": name, **common, "source": f"pathtracer_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": engine_launch[name], "max_abs_err": err[name],
         "ms": dev_ms[key], "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1], **({"design": KERNEL2_PER_LANE} if key == "2r-s" else {})}
        for name, key, src, rep in (
            ("trace_fwd_resid_surf", "4s", "trace_grad.cu",
             "pathtracer_tpu/ops/trace_grad.py:115"),
            ("trace_bwd_surf", "5s", "trace_grad.cu", "pathtracer_tpu/ops/trace_grad.py:190"),
            ("bounce_replay_surf", "2r-s", "bounce.cu", "pathtracer_tpu/ops/bounce_grad.py:226"),
            ("bounce_bwd_surf", "3s", "bounce_grad.cu", "pathtracer_tpu/ops/bounce_grad.py:91"),
        )
    ]


SLOW_RES_CHECK = (200, 200)  # the slow-RNG renders and step held to the CPU's plain route
SLOW_SPP = 2
MOTION_SPP = 8
MOTION_CHECK_RES = (64, 64)


def slow_rng_phase(desc, dev, card: str, out_dir: str) -> None:
    """Phases 15-17: threefry (``fast_rng=False``).  ``[rng]``: its bounce
    and camera draws on CUDA tensors bit-equal to the CPU's at 640,000
    lanes, their device time and launches.  ``[slowrng]``: Cornell at its
    800x800, 2 spp through ``render``, which takes the scan on the split
    route: kernels 6 and 8 once per bounce and nothing else; the
    iteration's wall and device time and threefry's share of it; at 200x200
    the card's render against the CPU's plain split route.
    ``[grad:slowrng]``: one lean step at 200x200, 1 spp (kernels 6 and 8 in
    the forward, 7 and 8 in the backward's re-trace, once per bounce), its
    loss and leaves against the CPU's step."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops.camera import camera_uniforms
    from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.common import bounce_uniforms
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.utils.imageio import save_image

    seed = KeyedSeed(prng_key(0))
    scene = desc.scene_for_frame(0, device=dev)
    w, h = scene.camera.width, scene.camera.height
    n = w * h

    # ---- [rng] threefry on the card == on the CPU, bit for bit
    gen = torch.Generator().manual_seed(17)
    sample = torch.randint(0, 1 << 32, (n,), generator=gen, dtype=torch.int64)
    sample[:4] = torch.tensor([0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    depth = torch.randint(0, 8, (n,), generator=gen, dtype=torch.int32)
    draws = {
        "bounce": lambda s, d, fast: bounce_uniforms(seed, s, d, fast_rng=fast),
        "camera": lambda s, d, fast: camera_uniforms(seed, s, fast_rng=fast),
    }
    s_dev, d_dev = sample.to(dev), depth.to(dev)
    rng_ms = {}
    for name, draw in draws.items():
        got = draw(s_dev, d_dev, False)
        want = draw(sample, depth, False)
        equal = torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        timed = {}
        for fast in (False, True):
            run, _ = profiled(lambda: draw(s_dev, d_dev, fast), reps=3)
            timed[fast] = (sum(us for us, _ in run.values()) / 1e3 / 3,
                           sum(c for _, c in run.values()) // 3)
        rng_ms[name] = timed[False][0]
        print(f"[rng] threefry {name} uniforms {tuple(got.shape)} on the card bit-equal to the "
              f"CPU's: {equal}; {timed[False][0]:.4f} ms of device time in {timed[False][1]} "
              f"launches per draw (the counter hash: {timed[True][0]:.4f} ms in "
              f"{timed[True][1]}); on {card}")
        check(equal, f"threefry {name} uniforms differ between the card and the CPU")

    # ---- [slowrng] the full-width render through the entry point
    cfg = RenderConfig(max_depth=8, nee=True, fast_rng=False, iters_per_launch=SLOW_SPP)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, acc, stats = render(scene, SLOW_SPP, cfg, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    bounces = SLOW_SPP * cfg.max_depth
    print(f"[slowrng] cornell {w}x{h} d8 nee fast_rng=False spp={SLOW_SPP}: {wall_s:.3f} s, rays "
          f"{stats['rays_traced']}, launches {launches}")
    check(launches == only(nearest_hit=bounces, occlusion=bounces),
          f"slow-RNG render launches {launches}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
          and bool((acc >= 0).all()) and stats["rays_traced"] >= SLOW_SPP * n,
          "slow-RNG render: bad image, accumulator or ray count")
    save_image(os.path.join(out_dir, "chip_smoke_cornell_slowrng.png"), img.cpu().numpy())
    rcfg = resolve_features(cfg, scene.materials)
    acc0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def iteration():
        return render_chunk(scene, acc0, 0, seed, rcfg, 1)

    iter_ms = cuda_ms(iteration, reps=3)
    run, prof_ms = profiled(iteration)
    busy_ms = sum(us for us, _ in run.values()) / 1e3
    named = {k: sum(us for name, (us, _) in run.items() if k in name) / 1e3
             for k in ("nearest_kernel", "occlusion_kernel")}
    rng_iter = cfg.max_depth * rng_ms["bounce"] + rng_ms["camera"]
    write_kernel_table(run, os.path.join(out_dir, "profile_slowrng_iteration.txt"))
    print(f"[slowrng:time] iteration {iter_ms:.4f} ms wall ({prof_ms:.4f} profiled), device busy "
          f"{busy_ms:.4f} ms, idle share {1 - busy_ms / iter_ms:.3f}, "
          f"{sum(c for _, c in run.values())} launches; "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in named.items())
          + f"; threefry {rng_ms['bounce']:.4f} ms per bounce, {rng_iter:.4f} ms per iteration "
          f"(8 bounces and the camera), {rng_iter / busy_ms:.3f} of the device time; on {card}")
    small = dataclasses.replace(desc, resolution=SLOW_RES_CHECK)
    _, acc_k, st_k = render(small.scene_for_frame(0, device=dev), SLOW_SPP, cfg, device=dev)
    _, acc_p, st_p = render(small.scene_for_frame(0, device="cpu"), SLOW_SPP, cfg, device="cpu")
    check(st_k["rays_traced"] == st_p["rays_traced"], "slow-RNG ray counts differ card vs CPU")
    check_close("slowrng", acc_k.cpu(), acc_p, 0.995, 2e-5,
                f"{SLOW_RES_CHECK[0]}x{SLOW_RES_CHECK[1]} card vs the CPU's plain split route")

    # ---- [grad:slowrng] one lean step through the entry point
    gcfg = RenderConfig(wavefront=False, nee=True, max_depth=8, fast_rng=False)
    step = grad_step("[grad:slowrng]", ("color",), dev, 1, out_dir, "lean", small, gcfg,
                     only(nearest_hit=8, occlusion=16, winner=8),
                     kernels=("nearest_kernel", "winner_kernel", "occlusion_kernel"))
    params, static = diff.params_from_description(small, 0, device="cpu")
    target = torch.zeros((static.resolution[0] * static.resolution[1], 3))
    loss_p, grads_p, _ = diff.loss_and_grad_rays(params, static, target, 1, prng_key(0), gcfg,
                                                 device="cpu")
    got, want = step["grads"].leaves(), grads_p.leaves()
    gscale = max(float(v.abs().max()) for v in want.values())
    worst, leaf = max((float((got[k].cpu() - want[k]).abs().max()), k) for k in want)
    loss_rel = abs(float(step["loss"]) - float(loss_p)) / abs(float(loss_p))
    print(f"[grad:slowrng:check] loss card {float(step['loss']):.9g} CPU {float(loss_p):.9g} "
          f"({loss_rel:.3g} relative); worst leaf {leaf} {worst:.3g} of gscale {gscale:.4g}")
    check(loss_rel <= 1e-5 and worst <= 5e-4 * max(gscale, 1.0),
          "slow-RNG lean step: card and CPU apart beyond the lean bars")


def motion_phase(dev, card: str, out_dir: str) -> None:
    """Phase 18, ``[motion]``: ``render/motion.render_motion`` of
    ``scenes/animation.txt``'s frames 0-1 at its 400x400, depth 8, NEE, 8
    spp, with the counters zeroed just before: kernel 1 once per iteration
    and nothing else; ``deform_demo.txt`` (lerped vertices, 20 triangles) at
    its 320x320, 2 spp: kernel 1m once per iteration; at 64x64 the card's
    motion renders against the CPU's plain ones; the iteration's time."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
    from pathtracer_tpu_torch.render.motion import render_motion, shutter_time
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils.imageio import save_image

    cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=MOTION_SPP)
    for name, spp, counter in (("animation", MOTION_SPP, "trace"),
                               ("deform_demo", SLOW_SPP, "trace_mesh")):
        desc = load_scene(os.path.join(ROOT, "scenes", f"{name}.txt"))
        w, h = desc.resolution
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, acc, stats = render_motion(desc, 0, spp, cfg, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counts()
        print(f"[motion] {name} {w}x{h} d8 nee frames 0-1 spp={spp}: {wall_s:.3f} s, rays "
              f"{stats['rays_traced']}, launches {launches}")
        check(launches == only(**{counter: spp}), f"{name} motion launches {launches}")
        check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all())
              and stats["rays_traced"] >= spp * w * h, f"{name} motion: bad image or rays")
        save_image(os.path.join(out_dir, f"chip_smoke_{name}_motion.png"), img.cpu().numpy())
        wall_ms = cuda_ms(lambda: render_motion(desc, 0, 1, cfg, device=dev), reps=2)
        run, _ = profiled(lambda: render_motion(desc, 0, 1, cfg, device=dev))
        busy_ms = sum(us for us, _ in run.values()) / 1e3
        seed = KeyedSeed(prng_key(0))
        t0 = time.perf_counter()
        for it in range(100):
            shutter_time(seed, it)
        t_ms = (time.perf_counter() - t0) * 10
        print(f"[motion:time] {name}: one iteration {wall_ms:.4f} ms wall (scene build, tables, "
              f"camera, kernel), device busy {busy_ms:.4f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; the shutter time {t_ms:.4f} ms on the host; on {card}")
        small = dataclasses.replace(desc, resolution=MOTION_CHECK_RES)
        _, acc_k, st_k = render_motion(small, 0, SLOW_SPP, cfg, device=dev)
        _, acc_p, st_p = render_motion(small, 0, SLOW_SPP, cfg, device="cpu")
        check(st_k["rays_traced"] == st_p["rays_traced"], f"{name}: ray counts differ")
        check_close("motion", acc_k.cpu(), acc_p, 0.995, 2e-5,
                    f"{name} {MOTION_CHECK_RES[0]}x{MOTION_CHECK_RES[1]} card vs CPU")


DEBUG_SPP = 2
CKPT_SPP = 4
CKPT_CLI_RES = (200, 200)


def _within_golden(acc, ref):
    """Entries within 1e-5 relative, as ``[golden]`` holds them."""
    return (acc - ref).abs() <= 1e-5 * (ref.abs() + 1e-3)


def debug_phase(desc, dev, card: str) -> None:
    """Phase 19, ``[debug]``: the debug engine at full width (the module
    docstring lists the checks)."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render.integrator import render

    scene = desc.scene_for_frame(0, device=dev)
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    cfg = RenderConfig(max_depth=8, nee=True, debug=True, iters_per_launch=1)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, acc, stats = render(scene, DEBUG_SPP, cfg, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    hist = stats["alive_per_bounce"]
    print(f"[debug] cornell {w}x{h} d8 nee spp={DEBUG_SPP} debug=True: {wall_s:.3f} s, rays "
          f"{stats['rays_traced']}, alive per bounce {hist}, launches {launches}")
    check(launches == only(bounce=DEBUG_SPP * cfg.max_depth),
          f"debug render launches {launches}")
    check(len(hist) == cfg.max_depth and hist[0] == DEBUG_SPP * n
          and all(a >= b for a, b in zip(hist, hist[1:]))
          and sum(hist) * 2 == stats["rays_traced"], f"debug histogram {hist}")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(acc).all()),
          "debug render: bad image or accumulator")
    _, ref, ref_stats = render(scene, DEBUG_SPP, dataclasses.replace(cfg, debug=False),
                               device=dev)
    share = float(_within_golden(acc, ref).float().mean())
    sum_rel = float((acc.double().sum() - ref.double().sum()).abs() / ref.double().sum())
    equal = int((acc == ref).sum())
    print(f"[debug:check] against kernel 1's render of the seed: {share:.6f} of entries within "
          f"1e-5 relative, {equal} of {acc.numel()} bit-equal, sums within {sum_rel:.3g}; rays "
          f"{stats['rays_traced']} against {ref_stats['rays_traced']}")
    check(share >= 0.999 and sum_rel <= 2e-5, "the debug scan and kernel 1 apart")
    color = scene.materials.color.clone()
    color[1, 0] = float("nan")
    bad = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, color=color))
    for engine, extra in (("megakernel", {}), ("pinned", dict(wavefront=True))):
        try:
            render(bad, DEBUG_SPP, dataclasses.replace(cfg, **extra), device=dev)
            message = "no error"
        except RuntimeError as e:  # the finite check's, checked by its message below
            message = str(e)
        print(f"[debug:nan] {engine}: {message}")
        check(message == "debug: non-finite accumulator after spp window [0, 1)",
              f"{engine}: a NaN material did not raise the finite check")
    warm = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, DEBUG_SPP, cfg, device=dev)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    print(f"[debug:time] the debug render at {DEBUG_SPP} spp {wall_s * 1e3:.4f} ms wall (the "
          f"counted run), then {warm[0]:.4f} / {warm[1]:.4f}; on {card}")


def ckpt_phase(desc, dev, card: str, out_dir: str) -> None:
    """Phase 20, ``[ckpt]``: a checkpoint and its resume at full width,
    then the CLI's checkpoint, preview and debug flags in a subprocess."""
    import re

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.utils import checkpoint as ckpt

    scene = desc.scene_for_frame(0, device=dev)
    cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=2)
    path = os.path.join(out_dir, "chip_smoke_ckpt.npz")
    save_s = []

    def progress(done, acc):
        if done == 2:
            t0 = time.perf_counter()
            ckpt.save(path, acc, done, 0, cfg.seed)
            save_s.append(time.perf_counter() - t0)

    zero_counts()
    _, straight, st = render(scene, CKPT_SPP, cfg, progress_fn=progress, device=dev)
    t0 = time.perf_counter()
    state = ckpt.load(path)
    acc = torch.from_numpy(state["accum"]).to(dev)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, resumed, st2 = render(scene, CKPT_SPP - state["spp_done"], cfg, accum=acc,
                             start_iteration=state["spp_done"], device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = read_counts()
    same = bool(torch.equal(resumed, straight))
    print(f"[ckpt] cornell {scene.camera.width}x{scene.camera.height} {CKPT_SPP} spp in "
          f"chunks of 2, checkpoint at "
          f"{state['spp_done']} ({save_s[0] * 1e3:.1f} ms to write, {load_s * 1e3:.1f} ms to "
          f"load onto the card), resumed to {CKPT_SPP} in {resume_s * 1e3:.1f} ms: bit-equal "
          f"to the straight render: {same}; launches {launches}; on {card}")
    check(state["spp_done"] == 2 and state["frame"] == 0 and state["accum"].shape == (
        scene.camera.width * scene.camera.height, 3), f"checkpoint state {state['spp_done']}")
    check(same, "the resumed accumulator differs from the straight render")
    check(launches == only(trace=CKPT_SPP + CKPT_SPP - state["spp_done"]),
          f"checkpoint renders launches {launches}")

    text = open(os.path.join(ROOT, "scenes", "cornell.txt")).read()
    scene_file = os.path.join(out_dir, "cornell_ckpt_cli.txt")
    with open(scene_file, "w") as f:
        f.write(re.sub(r"RES\s+\d+\s+\d+", "RES %d %d" % CKPT_CLI_RES, text))
    ck = os.path.join(out_dir, "cli_ckpt.npz")
    out = os.path.join(out_dir, "cli_ckpt.png")
    for stale in (ck, out.replace(".png", ".0.png"), out.replace(".png", ".0.preview.png")):
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", f"scene={scene_file}", "--spp",
         str(CKPT_SPP), "--checkpoint", ck, "--checkpoint-every", "2", "--preview-every", "2",
         "--debug", "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    cli_s = time.perf_counter() - t0
    print(f"[ckpt:cli] exit {cli.returncode} in {cli_s:.1f} s: {cli.stdout.strip()} "
          f"{cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0, "CLI run with --checkpoint --debug failed")
    check("device=cuda" in cli.stdout and "engine=megakernel" in cli.stdout,
          "the CLI did not run the megakernel on cuda")
    state = ckpt.load(ck)
    check(state is not None and state["spp_done"] == CKPT_SPP and state["frame"] == 0,
          "the CLI's checkpoint is missing or not at the full spp")
    for written in (out.replace(".png", ".0.png"), out.replace(".png", ".0.preview.png")):
        check(os.path.exists(written), f"the CLI did not write {written}")


def interactive_phase(desc, dev, card: str, out_dir: str) -> None:
    """Phase 21, ``[interactive]``: the camera REPL on a scripted stdin."""
    import io

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.render.interactive import interactive_loop
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    cfg = RenderConfig(max_depth=8, nee=True)
    out = os.path.join(out_dir, "chip_smoke_interactive.png")
    log, state = io.StringIO(), {}
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renders = interactive_loop(desc, 0, cfg, preview_spp=1, out_path=out, full_spp=2,
                               stdin=io.StringIO("w j refine 1 save quit\n"), stdout=log,
                               device=dev, state=state)
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    print("[interactive] " + " | ".join(line.strip() for line in log.getvalue().splitlines()))
    print(f"[interactive] {renders} renders in {wall_s:.3f} s, launches {launches}")
    check(launches == only(trace=6), f"interactive launches {launches}")
    scene = desc.scene_for_frame(0, device=dev)
    moved = dataclasses.replace(scene, camera=state["rig"].camera(scene.camera))
    img, fresh, _ = render(moved, 2, cfg, device=dev)
    same = state["spp"] == 2 and bool(torch.equal(state["accum"], fresh))
    want = os.path.join(out_dir, "chip_smoke_interactive_fresh.png")
    save_image(want, img.cpu().numpy())
    png_same = bool((load_png(out.replace(".png", ".full.png")) == load_png(want)).all())
    print(f"[interactive:check] the 2-spp preview bit-equal to a fresh render of the rig's "
          f"camera: {same}; the .full.png equal to its PNG: {png_same}")
    check(same and png_same, "the interactive preview or save differs from a fresh render")

    def preview():
        t0 = time.perf_counter()
        im, _, _ = render(moved, 1, cfg, device=dev)
        save_image(out, im.cpu().numpy())
        return (time.perf_counter() - t0) * 1e3

    times = [preview() for _ in range(3)]
    print(f"[interactive:time] a 1-spp preview (render, read back, PNG written) "
          f"{', '.join(f'{t:.2f}' for t in times)} ms wall; on {card}")


SHARDS = 4  # shards of cuda:0 in [sharded]: one card, several shards
SHARDED_SPP = 2
SHARDED_CLI_RES = (200, 200)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_phase(desc, dev, card: str, out_dir: str, full_loss, full_grads) -> None:
    """Phase 22, ``[sharded]``: the multi-shard render and gradient on
    ``SHARDS`` shards of one card, and the CLI's ``--sharded`` through a
    one-rank NCCL group (the module docstring lists the checks)."""
    import re

    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.parallel.mesh import make_mesh
    from pathtracer_tpu_torch.parallel.sharded import (
        gather_image,
        per_device_ray_counts,
        render_sharded,
    )
    from pathtracer_tpu_torch.render import diff, wavefront
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return out

    scene = desc.scene_for_frame(0, device=dev)
    w, h = scene.camera.width, scene.camera.height
    mesh = make_mesh([dev] * SHARDS)
    cfg = RenderConfig(wavefront=True, max_depth=8, nee=True, iters_per_launch=SHARDED_SPP)
    zero_counts()
    steps0 = wavefront.super_steps
    _, blocks, st = timed("pinned render", lambda: render_sharded(scene, SHARDED_SPP, cfg,
                                                                  mesh=mesh))
    launches, steps = read_counts(), wavefront.super_steps - steps0
    _, whole, st1 = timed("single-device pinned render",
                          lambda: render(scene, SHARDED_SPP, cfg, device=dev))
    same = bool(torch.equal(gather_image(blocks, mesh), whole))
    counts = timed("per_device_ray_counts",
                   lambda: per_device_ray_counts(scene, SHARDED_SPP, cfg, mesh))
    print(f"[sharded] cornell {w}x{h} d8 nee spp={SHARDED_SPP} on {SHARDS} shards of "
          f"{mesh.devices[0]} (pinned): kernel 2 {launches['bounce']} launches over {steps} super-steps of the "
          f"{SHARDS} shards, launches {launches}; rays {st['rays_traced']} against the single "
          f"device's {st1['rays_traced']}; accumulator bit-equal to the single-device pinned "
          f"render: {same}; rays per shard {counts.tolist()}, min / max "
          f"{counts.min() / counts.max():.4f}")
    check(launches == only(bounce=steps) and steps > 0, f"sharded render launches {launches}")
    check(same, "the sharded accumulator differs from the single-device render")
    check(st["rays_traced"] == st1["rays_traced"] == int(counts.sum()),
          "sharded and single-device ray counts differ")

    qcfg = dataclasses.replace(cfg, wavefront_pinned=False)
    _, qblocks, qst = timed("queue render", lambda: render_sharded(scene, SHARDED_SPP, qcfg,
                                                                   mesh=mesh))
    _, qwhole, qst1 = render(scene, SHARDED_SPP, qcfg, device=dev)
    qshare = close_fraction(gather_image(qblocks, mesh).reshape(-1, 1), qwhole.reshape(-1, 1))
    print(f"[sharded] queue engine on {SHARDS} shards: rays {qst['rays_traced']} against "
          f"{qst1['rays_traced']}, {qshare:.6f} of entries within 1e-5 of the single-device "
          f"render")
    check(qst["rays_traced"] == qst1["rays_traced"] and qshare >= 0.9999,
          "the sharded queue render differs from the single-device one")

    params, static = diff.params_from_description(desc, 0, device=dev)
    gcfg = RenderConfig(wavefront=False, nee=True, max_depth=8)
    target = diff.scatter_target(torch.zeros((w * h, 3), device=dev), mesh)
    zero_counts()
    loss, grads = timed("gradient step", lambda: diff.loss_and_grad_sharded(
        params, static, target, 4, prng_key(0), gcfg, mesh))
    glaunches = read_counts()
    loss_rel = abs(float(loss) - float(full_loss)) / abs(float(full_loss))
    want, got = full_grads.leaves(), grads.leaves()
    apart = [k for k in want if not torch.allclose(got[k], want[k], rtol=2e-3, atol=1e-5)]
    print(f"[sharded:grad] loss_and_grad_sharded 4 spp on {SHARDS} shards (full-depth): kernel 4 "
          f"{glaunches['trace_fwd_resid']} launches, kernel 5 {glaunches['trace_bwd']}; loss "
          f"{float(loss):.8g} against {float(full_loss):.8g} ({loss_rel:.3g} relative); leaves "
          f"beyond rtol 2e-3, atol 1e-5 of the single-device step's: {apart or 'none'}")
    check(glaunches == only(trace_fwd_resid=4 * SHARDS, trace_bwd=4 * SHARDS),
          f"sharded step launches {glaunches}")
    check(loss_rel <= 1e-5 and not apart, "the sharded gradient differs from the single device's")

    text = open(os.path.join(ROOT, "scenes", "cornell.txt")).read()
    scene_file = os.path.join(out_dir, "cornell_sharded_cli.txt")
    with open(scene_file, "w") as f:
        f.write(re.sub(r"RES\s+\d+\s+\d+", "RES %d %d" % SHARDED_CLI_RES, text))
    out = os.path.join(out_dir, "cli_sharded.png")
    if os.path.exists(out.replace(".png", ".0.png")):
        os.remove(out.replace(".png", ".0.png"))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0")
    cli = timed("CLI subprocess", lambda: subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", f"scene={scene_file}", "--spp", "4",
         "--sharded", "--out", out], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300))
    print(f"[sharded:cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0, "the CLI with --sharded failed")
    check("devices=1 (sharded, 1 process(es))" in cli.stdout, "the CLI did not run sharded")
    small = dataclasses.replace(desc, resolution=SHARDED_CLI_RES).scene_for_frame(0, device=dev)
    img, _, _ = render(small, 4, RenderConfig(wavefront=True, max_depth=8), device=dev)
    want_png = os.path.join(out_dir, "cli_sharded_single.png")
    save_image(want_png, img.cpu().numpy())
    quanta = int(abs(load_png(out.replace(".png", ".0.png")).astype(int)
                     - load_png(want_png).astype(int)).max())
    print(f"[sharded:cli] the NCCL run's PNG against the single-device image: at most {quanta} "
          f"8-bit quanta apart")
    check(quanta <= 1, "the sharded CLI image is more than one quantum from the single device's")
    print("[sharded:time] " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in parts.items())
          + f"; on {card}")


def native_phase(card: str, out_dir: str, build_s: float) -> None:
    """Phase 23, ``[native]``: the native host library built with g++ on
    this machine, its parse and PNG encoder against the Python versions,
    their host times, and the card's memory after ``[sharded]``."""
    import numpy as np

    from pathtracer_tpu_torch.scene import parser
    from pathtracer_tpu_torch.utils import imageio, metrics, native

    check(native.available(), "the native library did not build")
    text = open(os.path.join(ROOT, "scenes", "cornell.txt")).read()
    a, b = native.parse_scene_text(text), parser.parse_scene_text(text)
    same = all(
        np.array_equal(getattr(a, f), getattr(b, f)) if isinstance(getattr(a, f), np.ndarray)
        else getattr(a, f) == getattr(b, f)
        for f in ("frames", "iterations", "image_name", "resolution", "fovy", "eye", "view",
                  "up", "aperture", "focal_distance", "geom_type", "geom_material",
                  "translations", "rotations", "scales")
    ) and sorted(a.materials) == sorted(b.materials) and all(
        np.array_equal(a.materials[k], b.materials[k]) for k in a.materials)
    rgb = (np.random.default_rng(0).random((800, 800, 3)) * 255).astype(np.uint8)
    path = os.path.join(out_dir, "chip_smoke_native.png")
    wrote = native.write_png(path, rgb)
    back = imageio.load_png(path)
    png_same = wrote and bool((back == rgb).all())

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    t_native = host_ms(lambda: native.parse_scene_text(text), 50)
    t_python = host_ms(lambda: parser.parse_scene_text(text), 50)
    e_native = host_ms(lambda: native.write_png(path, rgb), 3)
    e_python = host_ms(lambda: imageio.encode_png(rgb), 3)
    print(f"[native] {native.library_path()} built with g++ in {build_s:.2f} s; cornell parsed "
          f"natively equal to the Python parse: {same}; an 800x800 PNG written and read back "
          f"equal: {png_same}")
    print(f"[native:time] parse cornell.txt native {t_native:.4f} ms, Python {t_python:.4f} ms; "
          f"encode an 800x800 PNG native {e_native:.2f} ms (written), Python {e_python:.2f} ms "
          f"(bytes only); host times on the machine of {card}")
    print(f"[native:memory] device_memory_stats() after [sharded]: {metrics.device_memory_stats()}")
    check(same, "the native parse differs from the Python parse")
    check(png_same, "the native PNG did not read back equal")


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=os.path.join(ROOT, "renders", "chip_smoke"))
    out_dir = parser.parse_args().out_dir
    t_start = time.perf_counter()

    def wall(done: str) -> None:
        print(f"[wall] {time.perf_counter() - t_start:.1f} s since the start, {done} done")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import _build, trace, trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils import native
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"

    # ---- 1. build: the kernels with nvcc, the native host library with g++ beside them
    def timed_native():
        t0 = time.perf_counter()
        return native.available(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_job = pool.submit(timed_native)
        reports = _build.build_all()
        native_ok, native_build_s = native_job.result()
    print(f"[build] {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f} s; per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
          + f"; the native host library (g++, at the same time): available {native_ok} in "
          f"{native_build_s:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build:{name}] {line.strip()}")
    missing = missing_kernels(reports)
    unchecked = unchecked_sources(reports)
    print(f"[build] the {len(EXPECTED_INSTANCES)} kernel instances and {len(PROFILED_NAMES)} "
          f"kernel names this script matches, against the built symbols: missing "
          f"{missing or 'none'}; " + (
              f"not checked (reused from an earlier build, no ptxas report): "
              f"{', '.join(unchecked)}, and the kernel names" if unchecked
              else "every source compiled and checked"))
    check(not missing, f"kernels this script matches are not built: {', '.join(missing)}")

    # ---- 2. the main path at full width
    desc = load_scene(os.path.join(ROOT, "scenes", "cornell.txt"))
    scene = desc.scene_for_frame(0, device=dev)
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=4)
    spp = 8
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, accum, stats = render(scene, spp, cfg, device=dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    main_launches = read_counts()
    print(
        f"[main] cornell {w}x{h} d{cfg.max_depth} nee spp={spp}: {render_s:.3f} s, "
        f"rays {stats['rays_traced']}, launches {main_launches}"
    )
    check(main_launches == only(trace=spp), f"forward main path launches {main_launches}")
    check(tuple(img.shape) == (h, w, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(accum).all()), "non-finite accumulator")
    check(bool((accum >= 0).all()), "negative radiance")
    save_image(os.path.join(out_dir, "chip_smoke_cornell.png"), img.cpu().numpy())
    _, acc2, stats2 = render(scene, 2, cfg, device=dev)  # the megakernel at 2 spp, for [wavefront]
    mega = {"acc8": accum, "rays8": stats["rays_traced"], "acc2": acc2,
            "rays2": stats2["rays_traced"]}

    # ---- 3. kernel vs plain on the card, on the main path's inputs
    seed = key_to_seed(prng_key(cfg.seed))
    tables = pack_tables(scene)
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    kw = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=False, rr_start=cfg.rr_start)
    worst_abs = 0.0
    for it in (0, 1):
        sample = it * n + pixel
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
        args = (*tables, seed, rays.origin, rays.direction, sample)
        rad_k, nr_k = trace.trace_cuda(*args, **kw)
        rad_p, nr_p = trace.trace_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = (rad_k - rad_p).abs()
        beyond = (diff > 2e-6 + 2e-6 * rad_p.abs()).any(-1)
        n_beyond = int(beyond.sum())
        sum_rel = float((rad_k.double().sum() - rad_p.double().sum()).abs() / rad_p.double().sum())
        worst_abs = max(worst_abs, float(diff.max()))
        print(
            f"[check] iteration {it}: rays kernel {int(nr_k)} plain {int(nr_p)}; lanes beyond "
            f"2e-6: {n_beyond} of {n}; max abs err {float(diff.max()):.3g}; sum rel {sum_rel:.3g}"
        )
        check(int(nr_k) == int(nr_p), "ray counts differ")
        check(n_beyond <= n // 1000, f"{n_beyond} lanes beyond tolerance (> 0.1%)")
        check(sum_rel <= 1e-5, f"image sum differs by {sum_rel:.3g} relative")
    # the persistent schedule: the grid forced small gives the resident grid's
    # radiance and ray count bit for bit; with russian roulette from bounce 3
    # (shorter, more uneven paths) the kernel against the plain version
    rad_s, nr_s = trace.trace_cuda(*args, blocks=SMALL_GRID, **kw)
    rr_kw = dict(kw, rr=True)
    rad_rk, nr_rk = trace.trace_cuda(*args, **rr_kw)
    rad_rp, nr_rp = trace.trace_plain(*args, **rr_kw)
    torch.cuda.synchronize()
    rr_beyond = int(((rad_rk - rad_rp).abs() > 2e-6 + 2e-6 * rad_rp.abs()).any(-1).sum())
    worst_abs = max(worst_abs, float((rad_rk - rad_rp).abs().max()))
    print(f"[check] {SMALL_GRID} blocks: radiance and rays bit-equal to the resident grid's: "
          f"{bool(torch.equal(rad_s, rad_k)) and int(nr_s) == int(nr_k)}; russian roulette from "
          f"bounce {cfg.rr_start}: rays kernel {int(nr_rk)} plain {int(nr_rp)}, lanes beyond "
          f"2e-6: {rr_beyond} of {n}")
    check(torch.equal(rad_s, rad_k) and int(nr_s) == int(nr_k),
          "the forced small grid differs from the resident grid")
    check(int(nr_rk) == int(nr_rp) and rr_beyond <= n // 1000,
          "russian roulette: kernel and plain version differ")

    # ---- 4. timing on the main path's shapes
    rays_per_iter = int(nr_k)
    k_ms = cuda_ms(lambda: trace.trace_cuda(*args, **kw), reps=20)
    k_dev = [queued_ms(lambda: trace.trace_cuda(*args, **kw)) for _ in range(2)]
    p_ms = cuda_ms(lambda: trace.trace_plain(*args, **kw), reps=2)
    rcfg = resolve_features(cfg, scene.materials)
    acc0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    iter_ms = cuda_ms(lambda: render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables), reps=5)
    cam_ms = cuda_ms(
        lambda: generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel)), reps=5
    )
    # where one render iteration's device time goes, and how idle the card is
    kernels_run, wall_ms = profiled(
        lambda: render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables), reps=3)
    busy_ms = sum(us for us, _ in kernels_run.values()) / 1e3 / 3
    write_kernel_table(kernels_run, os.path.join(out_dir, "profile_render_iteration.txt"))
    print(
        f"[profile] render iteration: device busy {busy_ms:.4f} ms; wall {iter_ms:.4f} ms "
        f"unprofiled ({wall_ms:.4f} ms profiled); idle share {1 - busy_ms / iter_ms:.3f}; top: "
        + "; ".join(f"{k[:40]} x{c // 3} {us / 1e3 / 3:.4f} ms"
                    for k, us, c in top_kernels(kernels_run, 4))
        + f"; {sum(c for _, c in kernels_run.values()) // 3} kernels per iteration"
    )
    lane_bounces = rays_per_iter // (2 if cfg.nee else 1)
    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    ops = lane_bounces * (sweep + OPS_SHADE)
    bytes_moved = n * (12 + 12 + 4 + 12) + sum(t.numel() * 4 for t in tables)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = "operations" if ops / FP32_OPS_PER_S > bytes_moved / HBM_BYTES_PER_S else "bytes"
    rr_dev = queued_ms(lambda: trace.trace_cuda(*args, **rr_kw))
    print(f"[card] {card}")
    print(
        f"[time] trace kernel {k_ms:.4f} ms/iteration ({rays_per_iter / k_ms / 1e3:.1f} Mrays/s), "
        f"{k_dev[0]:.4f} / {k_dev[1]:.4f} ms of device time (queued, twice), "
        f"{lane_bounces / n:.4f} bounces per lane of {cfg.max_depth}; with russian roulette "
        f"{rr_dev:.4f} ms, {int(nr_rk) // 2 / n:.4f} bounces per lane; plain {p_ms:.3f} ms, "
        f"camera rays {cam_ms:.4f} ms, render iteration {iter_ms:.4f} ms "
        f"({rays_per_iter / iter_ms / 1e3:.1f} Mrays/s); bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops} fp32 ops, {bytes_moved} bytes); on {card}"
    )

    # ---- 5. golden check of the port's render on the card, CLI entry point
    golden_desc = dataclasses.replace(desc, resolution=(96, 96))
    gscene = golden_desc.scene_for_frame(0, device=dev)
    gimg, gacc, _ = render(
        gscene, 16, RenderConfig(nee=True, max_depth=8, iters_per_launch=8), device=dev
    )
    golden = torch.from_numpy(
        np.load(os.path.join(ROOT, "tests", "golden", "cornell_96.npy"))
    ).to(dev)
    within = (gacc - golden).abs() <= 1e-5 * (golden.abs() + 1e-3)
    frac = float(within.float().mean())
    gsum_rel = float((gacc.double().sum() - golden.double().sum()).abs() / golden.double().sum())
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "cornell_96.png"))).to(dev)
    png_mean = float((gimg - png.float() / 255.0).abs().mean()) * 255.0
    print(
        f"[golden] cornell_96: {frac:.5f} of entries within 1e-5 rel, sum rel {gsum_rel:.3g}, "
        f"PNG mean abs {png_mean:.3f}/255"
    )
    check(frac >= 0.95 and gsum_rel <= 1e-4 and png_mean <= 0.8, "golden cornell_96 check failed")

    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/cornell.txt",
         "--spp", "2", "--device", "cuda", "--out", os.path.join(out_dir, "cli_cornell.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0, "CLI run failed")
    wall("phases 1-5")

    # ---- 6. the differentiable step
    full_loss, full_grads, grad_kernels = grad_phase(desc, dev, card, out_dir)
    wall("[grad]")

    # ---- 7. the per-bounce and lean differentiable engines
    engine_kernels = grad_engines_phase(desc, dev, card, out_dir, full_loss, full_grads)
    wall("[grad:perbounce] and [grad:lean]")

    # ---- 8. the wavefront engines
    wave_kernels = wavefront_phase(scene, dev, card, out_dir, mega)
    wall("[wavefront]")

    # ---- 9. triangle meshes
    mesh_kernels = mesh_phase(dev, card, out_dir, reports)
    wall("[mesh]")

    # ---- 10. participating media
    vol_kernels = vol_phase(dev, card, out_dir, reports, k_ms)
    wall("[vol]")

    # ---- 11. optional surface physics
    surf_kernels = surf_phase(dev, card, out_dir, reports, k_ms)
    wall("[surf]")

    # ---- 12. meshes above the in-kernel cap, image textures on meshes
    bigmesh_kernels = bigmesh_phase(dev, card, out_dir, reports)
    wall("[bigmesh]")

    # ---- 13. differentiable participating media
    grad_vol_kernels = grad_vol_phase(dev, card, out_dir, reports)
    wall("[grad:vol]")

    # ---- 14. differentiable surface physics
    grad_surf_kernels = grad_surf_phase(dev, card, out_dir, reports)
    wall("[grad:surf]")

    # ---- 15-17. threefry (fast_rng=False): the draws, the split route, the lean step
    slow_rng_phase(desc, dev, card, out_dir)
    wall("[rng], [slowrng] and [grad:slowrng]")

    # ---- 18. motion blur
    motion_phase(dev, card, out_dir)
    wall("[motion]")

    # ---- 19. the debug engine
    debug_phase(desc, dev, card)
    wall("[debug]")

    # ---- 20. checkpoints and resume, and the CLI's flags
    ckpt_phase(desc, dev, card, out_dir)
    wall("[ckpt]")

    # ---- 21. the interactive camera
    interactive_phase(desc, dev, card, out_dir)
    wall("[interactive]")

    # ---- 22. multi-shard render and gradient, the CLI's --sharded
    sharded_phase(desc, dev, card, out_dir, full_loss, full_grads)
    wall("[sharded]")

    # ---- 23. the native host library and the metrics module
    native_phase(card, out_dir, native_build_s)
    wall("[native]")

    # ---- 24. results
    kernels = [
        {
            "name": "trace",
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/trace.cu",
            "replaces": "pathtracer_tpu/ops/trace_pallas.py:62",
            "launches": main_launches["trace"],
            "max_abs_err": worst_abs,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
        *grad_kernels,
        *engine_kernels,
        *wave_kernels,
        *mesh_kernels,
        *vol_kernels,
        *surf_kernels,
        *bigmesh_kernels,
        *grad_vol_kernels,
        *grad_surf_kernels,
    ]
    for entry in kernels:
        if entry["name"] in DESIGNS:
            entry["design"] = DESIGNS[entry["name"]]
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
