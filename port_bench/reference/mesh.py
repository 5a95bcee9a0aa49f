"""Plain reference for triangle meshes: OBJ files, scenes that place them,
the nearest hit and the shadow sweep over their triangles, and the path loop.

The scene language names a mesh object by its ``.obj`` file in place of
``sphere`` or ``cube``; the object's TRS places the mesh's own coordinates
as it places a unit primitive.  What is computed, as the program documents
it (``scene/obj.py``, ``ops/mesh_tables.py``) and worked out again here:

* the OBJ file: ``v`` positions, ``vn`` normals (each made unit length) and
  ``f`` faces of any arity, fan-triangulated from the first corner, with
  ``v/vt/vn`` index syntax and negative indices counting back from the end;
  a mesh has normals only where every face corner names one;
* a mesh's triangles in the Morton order of their float32 centroids (30-bit
  codes of 10-bit cells on the centroids' own box, cells truncated, a
  stable sort): the order in which a sweep meets them, which decides a tie;
* the ray in the mesh's object space (the geom's inverse transform), the
  Moeller-Trumbore distance of every triangle and a strict ``t < best``, so
  the first of equal distances in that order wins; a triangle wins over the
  analytic geoms only where strictly nearer;
* the winner's shading normal: the barycentric blend of its corner normals
  (barycentrics clipped to [0, 1]), or where the mesh has none the face
  normal ``cross(v1 - v0, v2 - v0)``, through the geom's inverse transpose
  and made unit length;
* the shadow ray of next-event estimation blocked by the nearest triangle
  of any mesh as by the analytic geoms.

Everything else of a bounce is ``plain.py``'s: the camera, the RNG, the
analytic sweep, the materials, the BSDF, the light sample and the tone map.
Scenes in vacuum with non-emissive meshes only.  Every triangle is tested
(no culling structure), in blocks of lanes by triangles so that the planes
stay small.  Computed in the working float type ``dt`` as ``plain.py`` is,
and without gradients.  Imports nothing of the program.
"""

from __future__ import annotations

import os

import torch

from port_bench.reference import plain
from port_bench.reference import scene as ref_scene

MESH = 2
TRI_BLOCK = 64  # triangles tested together per block of lanes


# ---------------------------------------------------------------------------
# OBJ files and scenes with mesh objects
# ---------------------------------------------------------------------------

def read_obj(path: str) -> dict:
    """``{"verts": [T, 3, 3] float32, "norm": [T, 3, 3] float32 or None}``
    of the triangles of ``path`` in file order."""
    verts, norms, tris, tri_norms = [], [], [], []
    all_norms = True

    def index(tok: str, n: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn" and len(parts) >= 4:
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f" and len(parts) >= 4:
                corners = [tok.split("/") for tok in parts[1:]]
                vi = [index(c[0], len(verts)) for c in corners]
                ni = [index(c[2], len(norms)) if len(c) >= 3 and c[2] else None
                      for c in corners]
                for k in range(1, len(vi) - 1):
                    tris.append([vi[0], vi[k], vi[k + 1]])
                    fan = [ni[0], ni[k], ni[k + 1]]
                    all_norms = all_norms and None not in fan
                    tri_norms.append(fan)
    if not tris:
        raise ValueError(f"{path}: no faces")
    v = torch.tensor(verts, dtype=torch.float32)
    out = {"verts": v[torch.tensor(tris)], "norm": None}
    if norms and all_norms:
        n = torch.tensor(norms, dtype=torch.float32)[torch.tensor(tri_norms)]
        length = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2])
        out["norm"] = n / torch.clamp(length, min=1e-12)[..., None]
    return out


def morton_order(verts):
    """The permutation of ``[T, 3, 3]`` triangles into the Morton order of
    their centroids (stable)."""
    cent = (verts[:, 0] + verts[:, 1] + verts[:, 2]) / 3.0
    lo, hi = cent.amin(dim=0), cent.amax(dim=0)
    cells = torch.clamp((cent - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0, 0.0, 1023.0)
    cells = cells.to(torch.int64)
    code = torch.zeros(verts.shape[0], dtype=torch.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((cells[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.sort(code, stable=True).indices


def parse(text: str, resolution, scene_dir=None) -> dict:
    """``scene.parse``'s dict of a scene whose objects may be meshes: their
    geoms typed :data:`MESH`, and ``"meshes"``: per mesh object ``{"geom",
    "verts", "norm"}`` with the triangles in Morton order.  A mesh file is
    found as named, else relative to ``scene_dir``."""
    lines, paths, after_object, n_objects = [], {}, False, 0
    for line in text.splitlines():
        toks = line.split("//", 1)[0].split()
        if toks and after_object:
            after_object = False
            if toks[0].lower().endswith(".obj"):
                paths[n_objects - 1] = toks[0]
                line = "cube"
        elif toks and toks[0].upper() == "OBJECT":
            after_object, n_objects = True, n_objects + 1
        lines.append(line)
    sc = ref_scene.parse("\n".join(lines) + "\n", resolution)
    meshes = []
    for g, token in sorted(paths.items()):
        if sc["materials"]["emittance"][sc["mat_ids"][g]] > 0.0:
            raise ValueError(f"an emissive mesh ({token}) is not in the reference")
        path = token if os.path.exists(token) else os.path.join(scene_dir or ".", token)
        obj = read_obj(path)
        order = morton_order(obj["verts"])
        sc["types"][g] = MESH
        meshes.append({"geom": g, "verts": obj["verts"][order],
                       "norm": None if obj["norm"] is None else obj["norm"][order]})
    sc["meshes"] = meshes
    return sc


def mesh_tables(sc: dict, device, dt=torch.float32) -> list:
    """Per mesh its geom and its triangles in ``dt`` on ``device``: ``v0``,
    the edges ``e1``, ``e2`` and the face normal ``fn`` (``[T, 3]`` each),
    and the corner normals ``norm`` (``[T, 9]``) or None."""
    out = []
    for m in sc["meshes"]:
        v = m["verts"].to(device)
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        fn = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                          e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                          e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
        norm = None if m["norm"] is None else m["norm"].reshape(-1, 9).to(device, dt)
        out.append(dict(geom=m["geom"], v0=v[:, 0].to(dt), e1=e1.to(dt), e2=e2.to(dt),
                        fn=fn.to(dt), norm=norm))
    return out


# ---------------------------------------------------------------------------
# the triangle sweeps
# ---------------------------------------------------------------------------

def _mt(o, d, v0, e1, e2):
    """Moeller-Trumbore ``(t, u, v)`` planes ``[N, B]`` of rays ``o``, ``d``
    (3-tuples of ``[N]``) against triangles ``[B, 3]``: ``t`` is BIG where
    the ray misses or meets the triangle no farther than ``T_MIN``."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    v0x, v0y, v0z = (v0[None, :, k] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    hx, hy, hz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = plain._safe_recip(a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((torch.abs(a) > 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > plain.T_MIN))
    return torch.where(ok, t, plain.BIG), u, v


def _object_ray(gtab, g: int, o, d):
    obj = plain._to_object(gtab[g].unbind(-1), *o, *d)
    return obj[:3], obj[3:]


def mesh_nearest(meshes, gtab, o, d):
    """The nearest triangle of every mesh: ``(t [N] (BIG: none), unit world
    normal (3-tuple), material id [N] int64)``."""
    et = torch.full_like(o[0], plain.BIG)
    zero = torch.zeros_like(o[0])
    nw = (zero, zero, zero)
    emid = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    for m in meshes:
        oo, od = _object_ray(gtab, m["geom"], o, d)
        bt = torch.full_like(o[0], plain.BIG)
        bi = torch.zeros_like(emid)
        bu, bv = zero, zero
        for lo in range(0, m["v0"].shape[0], TRI_BLOCK):
            sl = slice(lo, lo + TRI_BLOCK)
            t, u, v = _mt(oo, od, m["v0"][sl], m["e1"][sl], m["e2"][sl])
            tb, jb = torch.min(t, dim=1)  # the first minimum of the block
            better = tb < bt
            bt = torch.where(better, tb, bt)
            bi = torch.where(better, lo + jb, bi)
            bu = torch.where(better, u.gather(1, jb[:, None])[:, 0], bu)
            bv = torch.where(better, v.gather(1, jb[:, None])[:, 0], bv)
        if m["norm"] is not None:
            uc, vc = torch.clamp(bu, 0.0, 1.0), torch.clamp(bv, 0.0, 1.0)
            w0 = torch.clamp(1.0 - uc - vc, 0.0, 1.0)
            nr = m["norm"][bi].unbind(-1)
            n = tuple(w0 * nr[k] + uc * nr[3 + k] + vc * nr[6 + k] for k in range(3))
        else:
            n = m["fn"][bi].unbind(-1)
        r = gtab[m["geom"]].unbind(-1)
        n = (r[0] * n[0] + r[4] * n[1] + r[8] * n[2], r[1] * n[0] + r[5] * n[1] + r[9] * n[2],
             r[2] * n[0] + r[6] * n[1] + r[10] * n[2])
        better = bt < et
        et = torch.where(better, bt, et)
        nw = plain.vwhere(better, n, nw)
        emid = torch.where(better, r[13].to(torch.int64), emid)
    return et, plain.vnormalize(nw), emid


def mesh_occluded_t(meshes, gtab, x, wi):
    """The nearest triangle distance along shadow rays (BIG: clear)."""
    occ = torch.full_like(x[0], plain.BIG)
    for m in meshes:
        oo, od = _object_ray(gtab, m["geom"], x, wi)
        for lo in range(0, m["v0"].shape[0], TRI_BLOCK):
            sl = slice(lo, lo + TRI_BLOCK)
            occ = torch.minimum(occ, _mt(oo, od, m["v0"][sl], m["e1"][sl], m["e2"][sl])[0]
                                .amin(dim=1))
    return occ


# ---------------------------------------------------------------------------
# one bounce and the path loop
# ---------------------------------------------------------------------------

def bounce(o, d, thr, tabs, info, meshes, u, depth: int, prev_state, *, nee: bool):
    """``plain.bounce`` in vacuum with the meshes: the analytic sweep skips
    the mesh geoms, a strictly nearer triangle takes the hit's distance,
    material and normal, and the shadow ray sweeps the triangles too."""
    gtab, mtab, ltab, svals = tabs
    ana = info["analytic"]
    best_t, gid, w = plain.nearest(gtab[ana], [info["gtypes"][g] for g in ana], o, d)
    gid = torch.tensor(ana, dtype=torch.int64, device=gid.device)[gid]
    win = plain.rows(gtab, gid).unbind(-1)
    hit = best_t < plain.BIG
    sph = hit & (win[12] == float(ref_scene.SPHERE))
    t_safe = torch.where(hit, best_t, 1.0)
    p_obj = (w[0] + t_safe * w[3], w[1] + t_safe * w[4], w[2] + t_safe * w[5])
    normal = plain._world_normal(win, plain._object_normal(sph, p_obj))
    mid = torch.where(hit, win[13].to(torch.int64), 0)
    et, en, emid = mesh_nearest(meshes, gtab, o, d)
    mb = et < best_t
    best_t = torch.where(mb, et, best_t)
    mid = torch.where(mb, emid, mid)
    normal = plain.vwhere(mb, en, normal)
    hit = best_t < plain.BIG
    t_safe = torch.where(hit, best_t, 1.0)
    p = plain.vadd(o, plain.vscale(t_safe, d))
    mat = plain._material(mtab, mid)
    emissive = mat["emittance"] > 0.0
    emitted = plain.vscale(mat["emittance"], plain.vmul(thr, mat["color"]))
    emit_mask = hit & emissive
    if nee and depth != 0:
        emit_mask = emit_mask & (torch.abs(prev_state - 1.0) < 0.5)
    contrib = plain.vwhere(emit_mask, emitted, (0.0, 0.0, 0.0))
    sc = plain._bsdf(mat, p, normal, d, u[0], u[1], u[2])
    if nee:
        ls = plain._light_sample(gtab, ltab, svals, info["cdf"], u[4], u[5], u[6], u[7])
        n_shade = plain.vscale(torch.sign(-plain.vdot(normal, d)), normal)
        x = plain.vadd(p, plain.vscale(plain.RAY_BIAS, n_shade))
        to_light = plain.vsub(ls["position"], x)
        dist2 = plain.vdot(to_light, to_light)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = plain.vscale(1.0 / dist, to_light)
        cos_x = plain.vdot(n_shade, wi)
        cos_y = -plain.vdot(ls["normal"], wi)
        diffuse = hit & (~emissive) & (~sc["specular"])
        candidate = diffuse & ls["valid"] & (cos_x > 0) & (cos_y > 0)
        occ = torch.minimum(plain._occluded_t(gtab, info["gtypes"], x, wi, info["keep"]),
                            mesh_occluded_t(meshes, gtab, x, wi))
        add = candidate & (occ >= dist - 4.0 * plain.RAY_BIAS)
        gterm = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        pdf_area = 1.0 / torch.clamp(svals[0], min=1e-20)
        scale = gterm / torch.clamp(pdf_area, min=1e-20) * plain.INV_PI
        rgb = plain.vscale(scale, plain.vmul(plain.vmul(thr, mat["color"]), ls["emit"]))
        contrib = plain.vadd(contrib, plain.vwhere(add, rgb, (0.0, 0.0, 0.0)))
    wspec = torch.where(sc["specular"],
                        torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0), 0.0)
    return dict(contrib=contrib, next_o=sc["origin"], next_d=sc["direction"],
                thr_mult=sc["thr"], terminate=(~hit) | emissive, wspec=wspec.to(prev_state.dtype))


def trace(tabs, info, meshes, seed: int, origin, direction, sample_idx, *, max_depth: int,
          nee: bool):
    """``plain.trace`` with the meshes: ``(radiance [N, 3], rays int64 [])``."""
    dt = origin.dtype
    n = origin.shape[0]
    o, d = tuple(origin.unbind(-1)), tuple(direction.unbind(-1))
    ones = torch.ones(n, dtype=dt, device=origin.device)
    thr = (ones, ones, ones)
    prev_state = torch.zeros_like(ones)
    radiance = torch.zeros((n, 3), dtype=dt, device=origin.device)
    lanes = torch.arange(n, device=origin.device)
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    for dep in range(max_depth):
        if lanes.numel() == 0:
            break
        nrays = nrays + lanes.numel() * (2 if nee else 1)
        u = plain.uniforms(seed, sample_idx[lanes], dep, plain.N_UNIFORMS, dt)
        out = bounce(o, d, thr, tabs, info, meshes, u, dep, prev_state, nee=nee)
        alive = ~out["terminate"]
        radiance = radiance.index_add(0, lanes, torch.stack(out["contrib"], dim=-1))
        thr = tuple(torch.where(alive, t * m, t) for t, m in zip(thr, out["thr_mult"]))
        keep = alive.nonzero()[:, 0]
        lanes = lanes[keep]
        prev_state = out["wspec"][keep]
        o = tuple(c[keep] for c in out["next_o"])
        d = tuple(c[keep] for c in out["next_d"])
        thr = tuple(c[keep] for c in thr)
    return radiance, nrays


def render_pixels(sc: dict, lv: dict, pixel, iterations, key, cfg: dict, dt=torch.float32,
                  lanes: int = 1 << 20):
    """``drive.render_pixels`` of a scene with meshes: ``(accum [K, 3] in
    dt, rays int)``, the radiance of ``pixel`` summed over ``iterations``
    in order from zero; about ``lanes`` paths traced at a time."""
    from port_bench.reference import drive

    if drive.is_volumetric(sc):
        raise ValueError("media with meshes are not in the reference")
    seed = plain.key_seed(key)
    iterations = list(iterations)
    cam = sc["camera"]
    out = torch.zeros((pixel.shape[0], 3), dtype=dt, device=pixel.device)
    rays = 0
    with torch.no_grad():
        tabs, info = drive.scene_tables(sc, lv, dt)
        info["analytic"] = [g for g, t in enumerate(info["gtypes"]) if t != MESH]
        info["keep"] = [t != MESH for t in info["gtypes"]]
        meshes = mesh_tables(sc, pixel.device, dt)
        per = max(1, lanes // max(1, len(iterations)))
        for lo in range(0, pixel.shape[0], per):
            pix = pixel[lo:lo + per]
            acc = torch.zeros((pix.shape[0], 3), dtype=dt, device=pix.device)
            step = max(1, lanes // pix.shape[0])
            for i0 in range(0, len(iterations), step):
                its = iterations[i0:i0 + step]
                lane_pix = pix.repeat(len(its))
                lane_it = torch.tensor(its, dtype=torch.int64, device=pix.device)
                lane_it = lane_it.repeat_interleave(pix.shape[0])
                o, d, sidx = plain.camera_rays(drive.camera_of(lv), cam["width"], cam["height"],
                                               lane_pix, lane_it, seed, dt,
                                               jitter=bool(cfg["jitter"]))
                rad, n = trace(tabs, info, meshes, seed, o, d, sidx,
                               max_depth=int(cfg["max_depth"]), nee=bool(cfg["nee"]))
                for r in rad.reshape(len(its), pix.shape[0], 3):
                    acc = acc + r
                rays += int(n)
            out[lo:lo + per] = acc
    return out, rays
