"""Parser for the scene DSL.

Port of ``pathtracer_tpu/scene/parser.py:57-525``: ``MATERIAL`` blocks with
their 10 fixed property lines and the TEXTURE / BUMP / PHASE / BRDF
extension lines, the ``CAMERA`` block with optional APERTURE / FOCAL, and
``OBJECT`` blocks with per-frame TRS, the DISPLACE extension and per-frame
FILE overrides. Mesh objects load their OBJ file relative to the scene file
(``:240-300,346-360``): the triangles, displaced when the object says
DISPLACE, one vertex array per frame where FILE lines deform the mesh (the
topology must match), and the authored ``vt`` / ``vn`` attributes of
undisplaced meshes. ``TEXTURE <file>.png`` images load relative to the
scene file too (``:207-217``), decoded to linear light, one atlas slot per
distinct path. :func:`load_scene` takes the native parser
(``utils/native.py``) for a scene it covers, as JAX's does (``:497-517``).
"""

from __future__ import annotations

import os
import warnings
from typing import List

import numpy as np

from pathtracer_tpu_torch.ops.texture import decode_srgb
from pathtracer_tpu_torch.scene.displace import displace_mesh
from pathtracer_tpu_torch.scene.obj import load_obj_full
from pathtracer_tpu_torch.scene.structs import CUBE, MESH, SPHERE, SceneDescription
from pathtracer_tpu_torch.utils.imageio import load_png

_MATERIAL_KEYS = {
    "RGB": ("color", 3),
    "SPECEX": ("specular_exponent", 1),
    "SPECRGB": ("specular_color", 3),
    "REFL": ("has_reflective", 1),
    "REFR": ("has_refractive", 1),
    "REFRIOR": ("index_of_refraction", 1),
    "SCATTER": ("has_scatter", 1),
    "ABSCOEFF": ("absorption_coefficient", 3),
    "RSCTCOEFF": ("reduced_scatter_coefficient", 1),
    "EMITTANCE": ("emittance", 1),
}

_EXT_DEFAULTS = {
    "texture_type": 0.0,
    "texture_scale": 1.0,
    "texture_color2": [0.0, 0.0, 0.0],
    "bump_scale": 0.0,
    "bump_amp": 0.0,
    "texture_image": -1.0,
    "brdf_model": 0.0,
    "roughness": 0.0,
    "roughness_y": 0.0,
    "phase_g": 0.0,
}


class SceneParseError(ValueError):
    pass


def _tokenize(line: str) -> List[str]:
    if "//" in line:
        line = line.split("//", 1)[0]
    return line.split()


def _parse_material_ext(mat, advance, peek, name):
    """Optional extension lines after a material's 10 fixed lines."""
    while True:
        nxt = peek()
        if nxt is None:
            return
        k = nxt[0].upper()
        if k == "TEXTURE":
            advance()
            kind = nxt[1].lower()
            if kind.endswith(".png"):
                mat["texture_type"] = 3.0
                mat["_texture_path"] = nxt[1]
                mat["texture_scale"] = float(nxt[2]) if len(nxt) > 2 else 1.0
            else:
                mat["texture_type"] = {"none": 0.0, "checker": 1.0, "stripes": 2.0}[kind]
                mat["texture_scale"] = float(nxt[2])
                if len(nxt) >= 6:
                    mat["texture_color2"] = [float(v) for v in nxt[3:6]]
        elif k == "BUMP":
            advance()
            mat["bump_scale"] = float(nxt[1])
            mat["bump_amp"] = float(nxt[2])
        elif k == "PHASE":
            advance()
            g = float(nxt[1])
            if not -1.0 < g < 1.0:
                raise SceneParseError(f"{name}: PHASE g must be in (-1, 1), got {g}")
            mat["phase_g"] = g
        elif k == "BRDF":
            advance()
            model = nxt[1].lower()
            if model in ("cooktorrance", "cook-torrance", "ggx"):
                mat["brdf_model"] = 1.0
                mat["roughness"] = float(nxt[2])
            elif model == "ward":
                mat["brdf_model"] = 2.0
                mat["roughness"] = float(nxt[2])
                mat["roughness_y"] = float(nxt[3]) if len(nxt) >= 4 else float(nxt[2])
            elif model == "phong":
                mat["brdf_model"] = 0.0
            else:
                raise SceneParseError(f"{name}: unknown BRDF model {nxt[1]!r}")
        else:
            return


def parse_scene_text(text: str, name: str = "<string>", scene_dir=None) -> SceneDescription:
    """Parse scene DSL text; assets load relative to ``scene_dir`` (else the
    working directory)."""
    lines = text.splitlines()
    pos = 0

    def peek():
        nonlocal pos
        while pos < len(lines):
            toks = _tokenize(lines[pos])
            if toks:
                return toks
            pos += 1
        return None

    def advance():
        nonlocal pos
        toks = peek()
        if toks is None:
            raise SceneParseError(f"{name}: unexpected end of file")
        pos += 1
        return toks

    materials: List[dict] = []
    camera = None
    objects: List[dict] = []

    while peek() is not None:
        toks = advance()
        head = toks[0].upper()
        if head == "MATERIAL":
            mat_id = int(toks[1])
            if mat_id != len(materials):
                raise SceneParseError(f"{name}: MATERIAL ids must be sequential, got {mat_id}")
            mat: dict = {}
            for _ in range(len(_MATERIAL_KEYS)):
                ptoks = advance()
                key = ptoks[0].upper()
                if key not in _MATERIAL_KEYS:
                    raise SceneParseError(f"{name}: unknown material key {key}")
                field, width = _MATERIAL_KEYS[key]
                vals = [float(v) for v in ptoks[1 : 1 + width]]
                mat[field] = vals if width == 3 else vals[0]
            _parse_material_ext(mat, advance, peek, name)
            if mat.get("phase_g", 0.0) != 0.0 and mat.get("has_scatter", 0.0) <= 0.0:
                warnings.warn(
                    f"{name}: MATERIAL {mat_id} sets PHASE {mat['phase_g']} but "
                    "SCATTER is 0 — the phase function only applies inside a "
                    "scattering medium; set SCATTER 1 for it to take effect",
                    stacklevel=2,
                )
            materials.append(mat)
        elif head == "CAMERA":
            camera = _parse_camera(advance, peek, name)
        elif head == "OBJECT":
            obj_id = int(toks[1])
            if obj_id != len(objects):
                raise SceneParseError(f"{name}: OBJECT ids must be sequential, got {obj_id}")
            objects.append(_parse_object(advance, peek, name))
        else:
            raise SceneParseError(f"{name}: unexpected token {toks[0]!r}")

    if camera is None:
        raise SceneParseError(f"{name}: no CAMERA block")
    if not objects:
        raise SceneParseError(f"{name}: no OBJECT blocks")

    n_frames = len(camera["eye"])
    for obj in objects:
        if len(obj["trans"]) != n_frames:
            raise SceneParseError(
                f"{name}: object frame count {len(obj['trans'])} != camera "
                f"frame count {n_frames}"
            )
        if obj["material"] >= len(materials):
            raise SceneParseError(f"{name}: object references missing material")

    # resolve image-texture paths into atlas slots (deduped by path)
    tex_paths: List[str] = []
    for m in materials:
        p = m.pop("_texture_path", None)
        if p is None:
            continue
        full = _resolve_asset(p, scene_dir, "texture")
        if full not in tex_paths:
            tex_paths.append(full)
        m["texture_image"] = float(tex_paths.index(full))

    all_fields = [f for f, _ in _MATERIAL_KEYS.values()] + list(_EXT_DEFAULTS)
    mat_soa = {
        field: np.array(
            [m.get(field, _EXT_DEFAULTS.get(field, 0.0)) for m in materials],
            dtype=np.float32,
        )
        for field in all_fields
    }

    def per_frame(key):
        return np.array(
            [[o[key][f] for o in objects] for f in range(n_frames)], np.float32
        )

    return SceneDescription(
        frames=n_frames,
        iterations=camera["iterations"],
        image_name=camera["file"],
        resolution=tuple(camera["res"]),
        fovy=camera["fovy"],
        eye=np.array(camera["eye"], np.float32),
        view=np.array(camera["view"], np.float32),
        up=np.array(camera["up"], np.float32),
        aperture=camera["aperture"],
        focal_distance=camera["focal"],
        geom_type=np.array([o["type"] for o in objects], np.int32),
        geom_material=np.array([o["material"] for o in objects], np.int32),
        translations=per_frame("trans"),
        rotations=per_frame("rotat"),
        scales=per_frame("scale"),
        materials=mat_soa,
        texture_images=tuple(decode_srgb(load_png(p)) for p in tex_paths),
        **_load_meshes(objects, name, scene_dir),
    )


def _resolve_asset(token: str, scene_dir, kind: str = "mesh") -> str:
    for cand in (token, os.path.join(scene_dir or ".", token)):
        if os.path.exists(cand):
            return os.path.abspath(cand)
    raise SceneParseError(f"{kind} file not found: {token!r}")


def _load_meshes(objects, name, scene_dir) -> dict:
    """The mesh fields of :class:`SceneDescription`: ``mesh_tris`` (per
    object ``[T, 3, 3]`` or None), ``mesh_tris_frames`` (per object a tuple
    of per-frame arrays where FILE lines deform it, else None) and
    ``mesh_attrs`` (per object ``(uv, norm)`` of an undisplaced mesh with
    authored attributes, else None)."""

    def finish(o, tris):
        if o["displace"] is not None:
            amount, levels, mode, arg = o["displace"]
            tris = displace_mesh(tris, amount, levels, mode, arg)
        return tris

    mesh_data = tuple(
        load_obj_full(_resolve_asset(o["mesh_path"], scene_dir)) if o["type"] == MESH else None
        for o in objects
    )
    mesh_tris = tuple(
        None if md is None else finish(o, md.verts) for o, md in zip(objects, mesh_data)
    )
    # displacement regenerates the geometry, so a displaced mesh drops its
    # authored attributes
    mesh_attrs = tuple(
        (md.uv, md.norm)
        if md is not None and o["displace"] is None and (md.uv is not None or md.norm is not None)
        else None
        for o, md in zip(objects, mesh_data)
    )
    mesh_tris_frames = []
    for g, o in enumerate(objects):
        if o["type"] != MESH or not any(f is not None for f in o["frame_files"]):
            mesh_tris_frames.append(None)
            continue
        per_frame = []
        for f, override in enumerate(o["frame_files"]):
            tris = mesh_tris[g]
            if override is not None:
                tris = finish(o, load_obj_full(_resolve_asset(override, scene_dir)).verts)
            if tris.shape != mesh_tris[g].shape:
                raise SceneParseError(
                    f"{name}: deforming mesh frame {f} has {tris.shape[0]} triangles, "
                    f"frame 0 has {mesh_tris[g].shape[0]} — topology must match"
                )
            per_frame.append(tris)
        mesh_tris_frames.append(tuple(per_frame))
    return dict(mesh_tris=mesh_tris, mesh_tris_frames=tuple(mesh_tris_frames),
                mesh_attrs=mesh_attrs)


def _parse_camera(advance, peek, name):
    cam = {
        "res": None, "fovy": None, "iterations": None, "file": None,
        "aperture": 0.0, "focal": 0.0, "eye": [], "view": [], "up": [],
    }
    while True:
        toks = peek()
        if toks is None:
            break
        key = toks[0].upper()
        if key == "RES":
            advance()
            cam["res"] = (int(float(toks[1])), int(float(toks[2])))
        elif key == "FOVY":
            advance()
            cam["fovy"] = float(toks[1])
        elif key == "ITERATIONS":
            advance()
            cam["iterations"] = int(float(toks[1]))
        elif key == "FILE":
            advance()
            cam["file"] = toks[1]
        elif key == "APERTURE":
            advance()
            cam["aperture"] = float(toks[1])
        elif key == "FOCAL":
            advance()
            cam["focal"] = float(toks[1])
        elif key == "FRAME":
            advance()
            if int(toks[1]) != len(cam["eye"]):
                raise SceneParseError(f"{name}: camera frames must be sequential")
            frame = {}
            for _ in range(3):
                ptoks = advance()
                frame[ptoks[0].upper()] = [float(v) for v in ptoks[1:4]]
            cam["eye"].append(frame["EYE"])
            cam["view"].append(frame["VIEW"])
            cam["up"].append(frame["UP"])
        else:
            break
    for req in ("res", "fovy", "iterations", "file"):
        if cam[req] is None:
            raise SceneParseError(f"{name}: CAMERA missing {req.upper()}")
    if not cam["eye"]:
        raise SceneParseError(f"{name}: CAMERA has no frames")
    return cam


def _parse_object(advance, peek, name):
    type_tok = advance()[0]
    low = type_tok.lower()
    if low == "sphere":
        gtype = SPHERE
    elif low == "cube":
        gtype = CUBE
    elif low.endswith(".obj"):
        gtype = MESH
    else:
        raise SceneParseError(f"{name}: unknown object type {type_tok!r}")

    mat_toks = advance()
    if mat_toks[0].lower() != "material":
        raise SceneParseError(f"{name}: expected 'material', got {mat_toks[0]!r}")

    obj = {
        "type": gtype,
        "material": int(mat_toks[1]),
        "mesh_path": type_tok if gtype == MESH else None,
        "displace": None,
        "trans": [], "rotat": [], "scale": [], "frame_files": [],
    }
    nxt = peek()
    if nxt is not None and nxt[0].upper() == "DISPLACE":
        advance()
        if gtype != MESH:
            raise SceneParseError(f"{name}: DISPLACE only applies to meshes")
        mode, arg = "sin", 8.0
        if len(nxt) > 3:
            mode = nxt[3].lower()
            if mode not in ("sin",):
                raise SceneParseError(f"{name}: unknown DISPLACE mode {nxt[3]!r}")
            if len(nxt) > 4:
                arg = float(nxt[4])
        obj["displace"] = (float(nxt[1]), int(nxt[2]), mode, arg)
    while True:
        toks = peek()
        if toks is None or toks[0].upper() != "FRAME":
            break
        advance()
        if int(toks[1]) != len(obj["trans"]):
            raise SceneParseError(f"{name}: object frames must be sequential")
        frame = {}
        frame_file = None
        while len(frame) < 3 or (peek() and peek()[0].upper() == "FILE"):
            ptoks = advance()
            key = ptoks[0].upper()
            if key == "FILE":
                if gtype != MESH:
                    raise SceneParseError(f"{name}: per-frame FILE only applies to meshes")
                frame_file = ptoks[1]
                continue
            frame[key] = [float(v) for v in ptoks[1:4]]
        obj["trans"].append(frame["TRANS"])
        obj["rotat"].append(frame["ROTAT"])
        obj["scale"].append(frame["SCALE"])
        obj["frame_files"].append(frame_file)
    if not obj["trans"]:
        raise SceneParseError(f"{name}: object has no frames")
    return obj


# the extension keywords the native parser does not know; ".obj" catches
# mesh scenes and per-frame FILE lines (parser.py:504-513)
_NATIVE_UNKNOWN = ("TEXTURE", "BUMP", "BRDF", "PHASE", "DISPLACE")


def load_scene(path: str) -> SceneDescription:
    """Load a scene DSL file: with the native parser when the library is
    available and the scene has no extension keyword, no ``.obj`` and no
    mesh geom (``parser.py:497-517``), else in Python."""
    from pathtracer_tpu_torch.utils import native

    with open(path, "r") as f:
        text = f.read()
    name = os.path.basename(path)
    has_ext = any(k in text for k in _NATIVE_UNKNOWN) or ".obj" in text.lower()
    if not has_ext and native.available():
        desc = native.parse_scene_text(text, name=name)
        if not (desc.geom_type == MESH).any():
            return desc
    return parse_scene_text(text, name=name, scene_dir=os.path.dirname(os.path.abspath(path)))
