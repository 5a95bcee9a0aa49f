"""The port's native host library (``pathtracer_tpu_torch/utils/native.py``):
``tests/test_native.py`` for the port.

The library builds from ``native/src/ptnative.cpp`` with g++ into
``build/native/``; the tracked ``native/libptnative.so`` (the JAX
loader's) stays as it is.  The native parse equals the port's Python
parse field for field and JAX's native parse; parse errors raise the
port's ``SceneParseError``; the PNG encoder round-trips and the BMP equals
the port's encoder byte for byte.  ``load_scene`` and ``save_image`` take
the native path only under JAX's conditions
(``pathtracer_tpu/scene/parser.py:497-517``, ``utils/imageio.py:72-80``).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import hashlib
import os

import numpy as np
import pytest

from pathtracer_tpu.utils import native as jax_native
from pathtracer_tpu_torch.scene import parser
from pathtracer_tpu_torch.utils import imageio, native

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell.txt")
TRACKED = os.path.join(ROOT, "native", "libptnative.so")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), f.name
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                assert x[k].dtype == y[k].dtype, k
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, (f.name, x, y)


def test_library_builds_under_build_native_and_leaves_native_alone():
    before = _sha(TRACKED)
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.abspath(os.path.join(ROOT, "build", "native"))
    assert os.path.basename(path).startswith("libptnative-") and os.path.exists(path)
    assert _sha(TRACKED) == before
    assert native.build() == path  # the build is reused


@pytest.mark.parametrize("scene", ["cornell", "animation"])
def test_native_parse_equals_python_parse(scene):
    text = open(os.path.join(ROOT, "scenes", f"{scene}.txt")).read()
    _assert_same(native.parse_scene_text(text), parser.parse_scene_text(text))


def test_native_parse_equals_jax_native_parse():
    text = open(CORNELL).read()
    mine, theirs = native.parse_scene_text(text), jax_native.parse_scene_text(text)
    for f in ("frames", "iterations", "image_name", "resolution", "fovy", "aperture",
              "focal_distance"):
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in ("geom_type", "geom_material", "translations", "rotations", "scales", "eye",
              "view", "up"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f), err_msg=f)
    assert sorted(mine.materials) == sorted(theirs.materials)
    for k in mine.materials:
        np.testing.assert_array_equal(mine.materials[k], theirs.materials[k], err_msg=k)


def test_parser_error_reporting():
    with pytest.raises(parser.SceneParseError, match="bad.txt"):
        native.parse_scene_text("MATERIAL 5\nRGB 1 1 1\n", name="bad.txt")


def test_png_roundtrip(tmp_path):
    img = (np.random.default_rng(1).random((21, 13, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "n.png")
    assert native.write_png(p, img)
    np.testing.assert_array_equal(imageio.load_png(p), img)
    with pytest.raises(ValueError, match="H, W, 3"):
        native.write_png(p, img[..., :2])


def test_bmp_matches_python_encoder(tmp_path):
    img = (np.random.default_rng(2).random((7, 5, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "n.bmp")
    assert native.write_bmp(p, img)
    assert open(p, "rb").read() == imageio.encode_bmp(img)


def test_save_image_takes_native_encoders(tmp_path, monkeypatch):
    calls = []
    for name in ("write_png", "write_bmp"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda p, rgb, _r=real, _n=name: calls.append(_n)
                            or _r(p, rgb))
    img01 = np.random.default_rng(3).random((9, 9, 3)).astype(np.float32)
    p = imageio.save_image(str(tmp_path / "x.png"), img01)
    q = imageio.save_image(str(tmp_path / "x.bmp"), img01)
    assert calls == ["write_png", "write_bmp"]
    back = imageio.load_png(p).astype(np.float32) / 255.0
    np.testing.assert_allclose(back, img01, atol=1 / 255.0 + 1e-6)
    rgb = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    assert open(q, "rb").read() == imageio.encode_bmp(rgb)
    # without the library the numpy encoders write the same pixels
    monkeypatch.setattr(native, "available", lambda: False)
    r = imageio.save_image(str(tmp_path / "y.png"), img01)
    assert calls == ["write_png", "write_bmp"]
    np.testing.assert_array_equal(imageio.load_png(r), imageio.load_png(p))


@pytest.mark.parametrize("scene,takes_native", [
    ("cornell", True), ("animation", True),
    ("textured", False),  # TEXTURE lines
    ("ward", False),  # BRDF lines
    ("smooth_mesh", False),  # an .obj mesh
])
def test_load_scene_takes_native_under_jax_conditions(scene, takes_native, monkeypatch):
    calls = []
    real = native.parse_scene_text
    monkeypatch.setattr(native, "parse_scene_text",
                        lambda text, name="<native>": calls.append(name) or real(text, name))
    desc = parser.load_scene(os.path.join(ROOT, "scenes", f"{scene}.txt"))
    assert calls == ([f"{scene}.txt"] if takes_native else [])
    if takes_native:
        _assert_same(desc, parser.parse_scene_text(open(os.path.join(ROOT, "scenes",
                                                                     f"{scene}.txt")).read()))


def test_failed_build_warns_once_and_python_serves(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed for .*broken.cpp"):
        assert not native.available()
    assert not native.available()  # tried once: no second warning, no second build
    desc = parser.load_scene(CORNELL)
    assert desc.resolution == (800, 800)
    assert not os.listdir(tmp_path / "build")
