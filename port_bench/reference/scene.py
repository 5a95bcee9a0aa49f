"""Plain reference: the scene DSL and the tables the path tracer reads.

A parser of the scene language the benchmark's configurations are written
in (materials, one camera frame, spheres and cubes), and the tables built
from it: the TRS transforms, the 14-column geom table, the 28-column
material table, the 19-column light table and the two scalars.  Written
for the benchmark: it imports nothing of the program under test, so what
the program derives from the same scene text is worked out again here.
Every table is built with torch operations from float32 tensors, so the
tables are differentiable in the scene's parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERE, CUBE = 0, 1

MATERIAL_KEYS = (
    ("RGB", "color", 3), ("SPECEX", "specular_exponent", 1), ("SPECRGB", "specular_color", 3),
    ("REFL", "has_reflective", 1), ("REFR", "has_refractive", 1),
    ("REFRIOR", "index_of_refraction", 1), ("SCATTER", "has_scatter", 1),
    ("ABSCOEFF", "absorption_coefficient", 3), ("RSCTCOEFF", "reduced_scatter_coefficient", 1),
    ("EMITTANCE", "emittance", 1),
)
# the optional surface and phase columns, which these scenes leave at rest
EXT_DEFAULTS = {
    "texture_type": 0.0, "texture_scale": 1.0, "texture_color2": [0.0, 0.0, 0.0],
    "bump_scale": 0.0, "bump_amp": 0.0, "texture_image": -1.0, "brdf_model": 0.0,
    "roughness": 0.0, "roughness_y": 0.0, "phase_g": 0.0,
}
# the material table's column order: 28 columns
TABLE_FIELDS = (
    "color", "specular_color", "has_reflective", "has_refractive", "index_of_refraction",
    "emittance", "specular_exponent", "absorption_coefficient", "has_scatter",
    "reduced_scatter_coefficient", "texture_type", "texture_scale", "texture_color2",
    "bump_scale", "bump_amp", "texture_image", "brdf_model", "roughness", "roughness_y",
    "phase_g",
)


def parse(text: str, resolution) -> dict:
    """Scene text -> ``{"materials": {field: [M] or [M, 3]}, "camera": {...},
    "types": [G], "mat_ids": [G], "trans" / "rotat" / "scale": [G, 3]}``
    (numpy float32), with the camera at ``resolution`` (w, h).  Only frame 0
    and analytic objects: anything else raises."""
    toks = [line.split("//", 1)[0].split() for line in text.splitlines()]
    toks = [t for t in toks if t]
    mats, objs, cam = [], [], None
    i = 0
    while i < len(toks):
        head = toks[i][0].upper()
        if head == "MATERIAL":
            m = dict(EXT_DEFAULTS)
            for k in range(len(MATERIAL_KEYS)):
                key, field, width = MATERIAL_KEYS[k]
                row = toks[i + 1 + k]
                if row[0].upper() != key:
                    raise ValueError(f"material line {row[0]!r}, expected {key}")
                vals = [float(v) for v in row[1:1 + width]]
                m[field] = vals if width == 3 else vals[0]
            i += 1 + len(MATERIAL_KEYS)
            if i < len(toks) and toks[i][0].upper() in ("TEXTURE", "BUMP", "BRDF", "PHASE"):
                raise ValueError(f"material extension {toks[i][0]} is not in the reference")
            mats.append(m)
        elif head == "CAMERA":
            cam = {"aperture": 0.0, "focal": 0.0}
            i += 1
            while i < len(toks) and toks[i][0].upper() in ("RES", "FOVY", "ITERATIONS", "FILE",
                                                           "APERTURE", "FOCAL", "FRAME"):
                key = toks[i][0].upper()
                if key == "FOVY":
                    cam["fovy"] = float(toks[i][1])
                elif key in ("APERTURE", "FOCAL"):
                    cam[key.lower()] = float(toks[i][1])
                elif key == "FRAME":
                    if int(toks[i][1]) == 0:
                        for row in toks[i + 1:i + 4]:
                            cam[row[0].lower()] = [float(v) for v in row[1:4]]
                    i += 3
                i += 1
        elif head == "OBJECT":
            kind = toks[i + 1][0].lower()
            if kind not in ("sphere", "cube"):
                raise ValueError(f"object type {kind!r} is not in the reference")
            obj = {"type": SPHERE if kind == "sphere" else CUBE, "material": int(toks[i + 2][1])}
            i += 3
            while i < len(toks) and toks[i][0].upper() == "FRAME":
                frame = int(toks[i][1])
                for row in toks[i + 1:i + 4]:
                    if frame == 0:
                        obj[row[0].lower()] = [float(v) for v in row[1:4]]
                i += 4
            objs.append(obj)
        else:
            raise ValueError(f"unexpected token {toks[i][0]!r}")
    if cam is None or not objs:
        raise ValueError("a scene needs a CAMERA and at least one OBJECT")
    w, h = resolution
    materials = {}
    for f in [f for _, f, _ in MATERIAL_KEYS] + list(EXT_DEFAULTS):
        materials[f] = np.array([m[f] for m in mats], np.float32)
    cam.update(width=int(w), height=int(h), fov=fov_of(cam["fovy"], w, h))
    return {
        "materials": materials, "camera": cam,
        "types": [o["type"] for o in objs], "mat_ids": [o["material"] for o in objs],
        "trans": np.array([o["trans"] for o in objs], np.float32),
        "rotat": np.array([o["rotat"] for o in objs], np.float32),
        "scale": np.array([o["scale"] for o in objs], np.float32),
    }


def fov_of(fovy_deg: float, width: int, height: int) -> tuple:
    """(fovx, fovy) in degrees, fovx from fovy and the aspect ratio."""
    xscaled = math.tan(math.radians(fovy_deg)) * width / height
    return (math.degrees(math.atan(xscaled)), float(fovy_deg))


def leaves(sc: dict, device) -> dict:
    """The scene's float parameters as float32 tensors on ``device``: the
    material fields ``materials.<field>``, ``translations``, ``rotations``,
    ``scales`` and the camera's ``cam_position``, ``cam_view``, ``cam_up``,
    ``cam_fov``, ``cam_aperture``, ``cam_focal``."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).clone()

    cam = sc["camera"]
    out = {f"materials.{k}": f32(v) for k, v in sc["materials"].items()}
    out.update(translations=f32(sc["trans"]), rotations=f32(sc["rotat"]), scales=f32(sc["scale"]),
               cam_position=f32(cam["eye"]), cam_view=f32(cam["view"]), cam_up=f32(cam["up"]),
               cam_fov=f32(cam["fov"]), cam_aperture=f32(cam["aperture"]),
               cam_focal=f32(cam["focal"]))
    return out


def _mat3_mul(a, b):
    return torch.stack([torch.stack([a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                                     + a[..., i, 2] * b[..., 2, j] for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def _mat3_apply(m, v):
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                        + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def _affine(lin, trans):
    top = torch.cat([lin, trans[..., :, None]], dim=-1)
    bottom = torch.zeros(lin.shape[:-2] + (1, 4), dtype=lin.dtype, device=lin.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transforms(translation, rotation_deg, scale):
    """``([G, 4, 4] object->world, [G, 4, 4] world->object)`` of X, Y, Z
    rotations (degrees), then the axis scales, then the translation."""
    rad = rotation_deg * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)

    def mat3(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat3([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat3([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat3([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    r = _mat3_mul(_mat3_mul(rx, ry), rz)
    m = _affine(r * scale[..., None, :], translation)
    inv3 = r.transpose(-1, -2) / scale[..., :, None]
    return m, _affine(inv3, -_mat3_apply(inv3, translation))


def _axis_scales(fwd):
    lin = fwd[:, :3, :3]
    return torch.sqrt(lin[:, 0, :] * lin[:, 0, :] + lin[:, 1, :] * lin[:, 1, :]
                      + lin[:, 2, :] * lin[:, 2, :])


def _light_areas(fwd, types, emissive):
    s = _axis_scales(fwd)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    cube = 2.0 * (sx * sy + sy * sz + sz * sx)
    p = 1.6075
    a, b, c = sx / 2, sy / 2, sz / 2
    ellipsoid = (4.0 * math.pi) * (((a * b) ** p + (b * c) ** p + (c * a) ** p) / 3.0) ** (1.0 / p)
    return torch.where(emissive, torch.where(types == SPHERE, ellipsoid, cube), 0.0)


def tables(lv: dict, types, mat_ids):
    """``(geom [G, 14], material [M, 28], light [G, 19], scalars [2])`` from
    the leaves, differentiable in them."""
    dev = lv["translations"].device
    fwd, inv = transforms(lv["translations"], lv["rotations"], lv["scales"])
    g = len(types)
    t_types = torch.tensor(types, dtype=torch.int64, device=dev)
    mid = torch.tensor(mat_ids, dtype=torch.int64, device=dev)
    gtab = torch.cat([inv.reshape(g, 16)[:, :12], t_types.to(torch.float32)[:, None],
                      mid.to(torch.float32)[:, None]], dim=-1)
    cols = []
    for f in TABLE_FIELDS:
        v = lv[f"materials.{f}"]
        cols.append(v if v.dim() == 2 else v[:, None])
    mtab = torch.cat(cols, dim=-1)
    emissive = lv["materials.emittance"][mid] > 0.0
    areas = _light_areas(fwd, t_types, emissive)
    total = torch.clamp(torch.sum(areas), min=1e-20)
    cdf = torch.cumsum(areas, dim=0) / total
    emit = lv["materials.color"][mid] * lv["materials.emittance"][mid][:, None]
    ltab = torch.cat([fwd.reshape(g, 16)[:, :12], cdf[:, None], emit, _axis_scales(fwd)], dim=-1)
    total_area = torch.sum(areas)
    scal = torch.stack([total_area, (total_area > 0).to(torch.float32)])
    return gtab, mtab, ltab, scal
