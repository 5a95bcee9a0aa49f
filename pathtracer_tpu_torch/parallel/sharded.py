"""Multi-GPU rendering: the pixels split over the shards of a mesh.

Port of ``pathtracer_tpu/parallel/sharded.py:1-259``.  Shard ``d`` of
``D`` owns the strided pixels ``d + D*j``: wavefront decay is spatially
correlated, so interleaved pixels give every shard the same distribution
of path lengths.  Each shard runs its own wavefront engine
(``render/wavefront.py``) on its pixels with ``pixel_offset=d``,
``pixel_stride=D`` and ``n_global_pixels=N``; every uniform is keyed by
the global sample index, so the shards trace exactly the samples of the
single-device render.  Rays never cross shards, so the render needs no
collective but the ray count's sum, and the image's gather at readout.

The accumulator is device-major: global row ``d*(N/D) + j`` holds pixel
``d + D*j``.  A process holds its shards' blocks, a list of ``[N/D, 3]``
float32 tensors, one per local shard on its device
(:func:`make_accum`); :func:`gather_image` folds them back to pixel order
and :func:`scatter_accum` is its inverse, so a pixel-ordered checkpoint
resumes on any layout.

Differences from JAX, by PyTorch's idiom: one process per GPU meets the
others in ``torch.distributed`` (``parallel/mesh.py``); a process may own
several shards, which run on its local devices, one thread per distinct
device so that the devices work at the same time (the shards of one device
run one after another).
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
from pathtracer_tpu_torch.ops.tonemap import tonemap
from pathtracer_tpu_torch.parallel.mesh import all_gather_cat, all_reduce_sum, make_mesh
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.wavefront import render_samples_pinned, render_samples_wavefront


def to_device(obj, device):
    """``obj`` (a tensor, or a dataclass or tuple holding tensors, such as a
    :class:`~pathtracer_tpu_torch.scene.structs.Scene`) with every tensor
    on ``device``; ``obj`` itself where nothing moves."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def shard_rows(n_pixels: int, mesh) -> int:
    """``N/D``, the pixels of one shard; raises ``ValueError`` when ``D``
    does not divide ``N`` (``sharded.py:161-167``)."""
    if n_pixels % mesh.size:
        raise ValueError(f"n_pixels={n_pixels} not divisible by devices={mesh.size}")
    return n_pixels // mesh.size


def make_accum(n_pixels: int, mesh) -> list:
    """Zeroed blocks of this process's shards, each ``[N/D, 3]`` float32 on
    its device."""
    rows = shard_rows(n_pixels, mesh)
    return [torch.zeros((rows, 3), dtype=torch.float32, device=d) for d in mesh.devices]


def gather_image(accum, mesh) -> torch.Tensor:
    """Pixel-ordered ``[N, 3]`` from the device-major accumulator: this
    process's blocks (gathered from every process, so every rank must
    call it) or a whole device-major ``[N, 3]`` tensor.  On the first
    local device."""
    first = mesh.devices[0]
    if not isinstance(accum, (list, tuple)):
        blocks = torch.as_tensor(accum).to(first).reshape(mesh.size, -1, 3)
    else:
        local = torch.stack([a.to(first) for a in accum])
        blocks = all_gather_cat(local).reshape(mesh.size, -1, 3)
    # row d*(N/D)+j holds pixel d + D*j: transpose the (D, N/D) view
    return blocks.transpose(0, 1).reshape(-1, 3)


def scatter_accum(accum_flat, mesh) -> list:
    """This process's blocks of a pixel-ordered ``[N, 3]`` accumulator (a
    tensor or a numpy array, e.g. a checkpoint's): the inverse of
    :func:`gather_image` (``sharded.py:188-204``)."""
    flat = torch.as_tensor(accum_flat, dtype=torch.float32)
    shard_rows(flat.shape[0], mesh)
    by_shard = flat.reshape(-1, mesh.size, 3)  # [N/D, D, 3]: pixel d + D*j at [j, d]
    return [by_shard[:, d].to(dev).contiguous() for d, dev in zip(mesh.shard_ids, mesh.devices)]


def _by_device(mesh):
    """``{device: [local shard index, ...]}`` in mesh order."""
    groups: dict = {}
    for i, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(i)
    return groups


def _run_shards(mesh, fn) -> list:
    """``fn(i)`` for every local shard ``i``, in a list.  The shards of one
    device run in turn; distinct devices each get a thread, so that one
    device's host syncs do not hold back the others' launches."""
    groups = _by_device(mesh)
    out = [None] * mesh.n_local

    def run(device, shards):
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            for i in shards:
                out[i] = fn(i)

    if len(groups) == 1:
        run(*next(iter(groups.items())))
        return out
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        for f in [pool.submit(run, d, s) for d, s in groups.items()]:
            f.result()
    return out


def _replicas(scene, mesh) -> dict:
    """``{device: (scene, tables)}``, the scene once per distinct device of
    the mesh."""
    out = {}
    for d in _by_device(mesh):
        s = scene if scene.device == d else to_device(scene, d)
        out[d] = (s, pack_tables(s))
    return out


def _shard_chunk(scene, tables, accum_local, start_iteration: int, n_iters: int, seed, cfg,
                 d: int, n_dev: int):
    """One shard's chunk on its wavefront engine (``sharded.py:47-75``)."""
    n_local = accum_local.shape[0]
    strided = dict(pixel_offset=d, pixel_stride=n_dev, n_global_pixels=n_local * n_dev,
                   tables=tables)
    if cfg.wavefront_pinned:
        return render_samples_pinned(scene, accum_local, start_iteration, n_iters, seed, cfg,
                                     **strided)
    return render_samples_wavefront(scene, accum_local, start_iteration * n_local,
                                    n_iters * n_local, seed, cfg, **strided)


def render_chunk_sharded(scene, accum, start_iteration: int, seed, cfg: RenderConfig,
                         n_iters: int, mesh):
    """One chunk of ``n_iters`` iterations on every shard of this process:
    ``(accum blocks, rays_traced int64 [])``, the rays summed over the
    local shards and over the processes (every rank must call it)."""
    replicas = _replicas(scene, mesh)

    def shard(i):
        dev = mesh.devices[i]
        s, tables = replicas[dev]
        return _shard_chunk(s, tables, accum[i], start_iteration, n_iters, seed, cfg,
                            mesh.shard_ids[i], mesh.size)

    results = _run_shards(mesh, shard)
    first = mesh.devices[0]
    rays = sum(n.to(first) for _, n in results)
    return [a for a, _ in results], all_reduce_sum(rays)


def per_device_ray_counts(scene, spp: int, cfg: RenderConfig, mesh, base_key=None) -> np.ndarray:
    """The rays each shard traces for ``spp`` iterations on the pinned
    engine, a ``[D]`` int64 array in shard order: the load-balance
    evidence behind the strided layout (``sharded.py:101-135``)."""
    seed = KeyedSeed(base_key if base_key is not None else prng_key(cfg.seed))
    pinned = dataclasses.replace(resolve_features(cfg, scene.materials), wavefront_pinned=True)
    accum = make_accum(scene.camera.width * scene.camera.height, mesh)
    replicas = _replicas(scene, mesh)

    def shard(i):
        s, tables = replicas[mesh.devices[i]]
        return _shard_chunk(s, tables, accum[i], 0, spp, seed, pinned, mesh.shard_ids[i],
                            mesh.size)[1]

    first = mesh.devices[0]
    local = torch.stack([n.to(first) for n in _run_shards(mesh, shard)])
    return all_gather_cat(local).reshape(-1).cpu().numpy()


def render_sharded(scene, spp: int, cfg: RenderConfig | None = None, mesh=None, base_key=None,
                   progress_fn=None, accum=None, start_iteration: int = 0):
    """Progressive render of ``spp`` samples per pixel over the mesh's
    shards; returns ``(image [H, W, 3], accum blocks, stats)`` with
    ``stats["rays_traced"]`` and ``stats["spp"]``, the image and the rays
    those of the single-device wavefront render (``sharded.py:207-259``).
    ``accum`` / ``start_iteration`` resume a render: the blocks of an
    earlier call, or a pixel-ordered ``[N, 3]`` accumulator (a tensor or a
    numpy array, e.g. a checkpoint's), which is scattered first.
    ``progress_fn(done, accum)`` receives the blocks: :func:`gather_image`
    them before use (on every rank).  ``cfg`` defaults to the wavefront
    engine; every rank of a process group must call this."""
    cfg = resolve_features(cfg or RenderConfig(wavefront=True), scene.materials)
    mesh = mesh or make_mesh()
    seed = KeyedSeed(base_key if base_key is not None else prng_key(cfg.seed))
    w, h = scene.camera.width, scene.camera.height
    if accum is None:
        accum = make_accum(w * h, mesh)
    elif not isinstance(accum, (list, tuple)):
        accum = scatter_accum(accum, mesh)
    accum = list(accum)
    done, rays = 0, 0
    while done < spp:
        chunk = min(cfg.iters_per_launch, spp - done)
        accum, n = render_chunk_sharded(scene, accum, start_iteration + done, seed, cfg, chunk,
                                        mesh)
        rays += int(n)
        done += chunk
        if progress_fn is not None:
            progress_fn(done, accum)
    img = tonemap(gather_image(accum, mesh).reshape(h, w, 3), start_iteration + spp)
    return img, accum, {"rays_traced": rays, "spp": spp}
