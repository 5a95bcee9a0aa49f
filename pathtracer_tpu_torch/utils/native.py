"""ctypes bridge to the native C++ host library (``native/src/ptnative.cpp``).

Port of ``pathtracer_tpu/utils/native.py:1-190`` over the same C ABI: the
scene-DSL parser and the PNG / BMP encoders, host code whose results are
those of the Python parser (``scene/parser.py``) and encoders
(``utils/imageio.py``).  At first use the source is compiled with the
flags of ``native/Makefile`` (``g++ -O2 -fPIC -std=c++17 -Wall -shared
-lz``) into ``build/native/libptnative-<hash>.so``, the hash covering the
source and the flags, as ``ops/_build.py`` builds the kernels; a library an
earlier process built is reused.  Nothing is written under ``native/``
(its ``libptnative.so`` belongs to the JAX package's loader).  When the
build fails the Python versions serve, as in JAX, and the compiler's
errors are given once in a ``RuntimeWarning``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "native", "src", "ptnative.cpp")
BUILD_DIR = os.path.join(ROOT, "build", "native")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lz")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where this source and these flags build: ``build/native/
    libptnative-<hash>.so``."""
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libptnative-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless this source's build exists; returns its
    path.  Raises ``RuntimeError`` with the compiler's errors."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: another process may build the same file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib):
    """Declare the C ABI's signatures (``native.py:45-72``)."""
    ip = ctypes.POINTER(ctypes.c_int)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.pt_parse_scene.restype = ctypes.c_void_p
    lib.pt_parse_scene.argtypes = [ctypes.c_char_p]
    lib.pt_scene_error.restype = ctypes.c_char_p
    lib.pt_scene_error.argtypes = [ctypes.c_void_p]
    for name in ("pt_num_materials", "pt_num_objects", "pt_num_frames", "pt_iterations"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("pt_fovy", "pt_aperture", "pt_focal"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.pt_image_name.restype = ctypes.c_char_p
    lib.pt_image_name.argtypes = [ctypes.c_void_p]
    lib.pt_free_scene.restype = None
    lib.pt_free_scene.argtypes = [ctypes.c_void_p]
    for name in ("pt_resolution", "pt_materials", "pt_objects", "pt_object_frames",
                 "pt_camera_frames"):
        getattr(lib, name).restype = None
    lib.pt_resolution.argtypes = [ctypes.c_void_p, ip]
    lib.pt_materials.argtypes = [ctypes.c_void_p, fp]
    lib.pt_objects.argtypes = [ctypes.c_void_p, ip, ip]
    lib.pt_object_frames.argtypes = [ctypes.c_void_p, fp, fp, fp]
    lib.pt_camera_frames.argtypes = [ctypes.c_void_p, fp, fp, fp]
    for name in ("pt_write_png", "pt_write_bmp"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                warnings.warn(f"the native library is not available, the Python parser and "
                              f"encoders serve: {e}", RuntimeWarning, stacklevel=3)
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def parse_scene_text(text: str, name: str = "<native>"):
    """Native scene parse -> the port's ``SceneDescription``, as
    ``scene/parser.parse_scene_text`` gives it for a scene without
    extension keywords or meshes; raises its ``SceneParseError``."""
    from pathtracer_tpu_torch.scene.parser import SceneParseError
    from pathtracer_tpu_torch.scene.structs import SceneDescription

    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    handle = lib.pt_parse_scene(text.encode())
    try:
        err = lib.pt_scene_error(handle)
        if err:
            raise SceneParseError(f"{name}: {err.decode()}")
        n_mat = lib.pt_num_materials(handle)
        n_obj = lib.pt_num_objects(handle)
        n_frames = lib.pt_num_frames(handle)
        wh = np.zeros(2, np.int32)
        lib.pt_resolution(handle, wh.ctypes.data_as(ip))
        mats = np.zeros((n_mat, 16), np.float32)
        lib.pt_materials(handle, mats.ctypes.data_as(fp))
        types = np.zeros(n_obj, np.int32)
        gmats = np.zeros(n_obj, np.int32)
        lib.pt_objects(handle, types.ctypes.data_as(ip), gmats.ctypes.data_as(ip))
        trans = np.zeros((n_frames, n_obj, 3), np.float32)
        rotat = np.zeros_like(trans)
        scale = np.zeros_like(trans)
        lib.pt_object_frames(handle, trans.ctypes.data_as(fp), rotat.ctypes.data_as(fp),
                             scale.ctypes.data_as(fp))
        eye = np.zeros((n_frames, 3), np.float32)
        view = np.zeros_like(eye)
        up = np.zeros_like(eye)
        lib.pt_camera_frames(handle, eye.ctypes.data_as(fp), view.ctypes.data_as(fp),
                             up.ctypes.data_as(fp))
        materials = {
            "color": mats[:, 0:3].copy(),
            "specular_exponent": mats[:, 3].copy(),
            "specular_color": mats[:, 4:7].copy(),
            "has_reflective": mats[:, 7].copy(),
            "has_refractive": mats[:, 8].copy(),
            "index_of_refraction": mats[:, 9].copy(),
            "has_scatter": mats[:, 10].copy(),
            "absorption_coefficient": mats[:, 11:14].copy(),
            "reduced_scatter_coefficient": mats[:, 14].copy(),
            "emittance": mats[:, 15].copy(),
            # the extension keywords' defaults: a scene with any of them takes
            # the Python parser (scene/parser.load_scene)
            "texture_type": np.zeros(n_mat, np.float32),
            "texture_scale": np.ones(n_mat, np.float32),
            "texture_color2": np.zeros((n_mat, 3), np.float32),
            "bump_scale": np.zeros(n_mat, np.float32),
            "bump_amp": np.zeros(n_mat, np.float32),
            "texture_image": np.full(n_mat, -1.0, np.float32),
            "brdf_model": np.zeros(n_mat, np.float32),
            "roughness": np.zeros(n_mat, np.float32),
            "roughness_y": np.zeros(n_mat, np.float32),
            "phase_g": np.zeros(n_mat, np.float32),
        }
        no_mesh = (None,) * n_obj
        return SceneDescription(
            frames=n_frames,
            iterations=lib.pt_iterations(handle),
            image_name=lib.pt_image_name(handle).decode(),
            resolution=(int(wh[0]), int(wh[1])),
            fovy=float(lib.pt_fovy(handle)),
            eye=eye,
            view=view,
            up=up,
            aperture=float(lib.pt_aperture(handle)),
            focal_distance=float(lib.pt_focal(handle)),
            geom_type=types,
            geom_material=gmats,
            translations=trans,
            rotations=rotat,
            scales=scale,
            materials=materials,
            mesh_tris=no_mesh,
            mesh_tris_frames=no_mesh,
            mesh_attrs=no_mesh,
        )
    finally:
        lib.pt_free_scene(handle)


def _write(fn_name: str, path: str, rgb8: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    if rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {rgb8.shape}")
    h, w, _ = rgb8.shape
    return bool(getattr(lib, fn_name)(path.encode(), rgb8.ctypes.data_as(ctypes.c_char_p), w, h))


def write_png(path: str, rgb8: np.ndarray) -> bool:
    """Write ``rgb8`` ``[H, W, 3]`` uint8 as a PNG; False when the library
    is not available or the write failed."""
    return _write("pt_write_png", path, rgb8)


def write_bmp(path: str, rgb8: np.ndarray) -> bool:
    """Write ``rgb8`` as a 24-bit BMP; False as :func:`write_png`."""
    return _write("pt_write_bmp", path, rgb8)
