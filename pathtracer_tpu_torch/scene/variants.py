"""Scene variants built from the repository's ``scenes/``, shared by
``chip_smoke.py`` and the port's tests: each function returns the text of a
scene file (or of an OBJ mesh).  Parse a scene that names assets with
``scene_dir=SCENES_DIR``."""

import os

import numpy as np

SCENES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "scenes")


def ggx_ward_scene() -> str:
    """The scene text of ``chip_smoke.py``'s ``[surf]`` (b):
    ``scenes/ward.txt`` with its sphere (material 3) turned Cook-Torrance GGX at roughness 0.25, so that a GGX
    lane and the Ward floor's lanes are selected per lane in one launch."""
    with open(os.path.join(SCENES_DIR, "ward.txt")) as f:
        text = f.read()
    assert text.count("BRDF ward 0.25\n") == 1
    return text.replace("BRDF ward 0.25\n", "BRDF cooktorrance 0.25\n")


def milky_ward_scene() -> str:
    """``scenes/milky.txt`` with its mirror sphere (material 3) turned
    anisotropic Ward (alpha 0.2 / 0.5): a scene whose lanes take the
    scattering medium and a surface feature in one launch, kernel 2's
    ``kVol`` x ``kSurf`` instance."""
    with open(os.path.join(SCENES_DIR, "milky.txt")) as f:
        text = f.read()
    marker = "MATERIAL 4  // milky glass"
    assert text.count(marker) == 1
    return text.replace(marker, "BRDF        ward 0.2 0.5\n\n" + marker)


def striped_scene() -> str:
    """The scene text of ``chip_smoke.py``'s ``[surf]`` (c):
    ``scenes/textured.txt`` with stripes (scale 3) on its red wall, so that the stripes pattern, on cells of
    both signs, runs beside the checker floor and walls."""
    with open(os.path.join(SCENES_DIR, "textured.txt")) as f:
        text = f.read()
    marker = "\nMATERIAL 2  // green diffuse"
    assert text.count(marker) == 1
    return text.replace(marker, "TEXTURE     stripes 3 .9 .8 .1\n" + marker)


def bigmesh_scene(levels: int = 4) -> str:
    """The scene text of ``chip_smoke.py``'s ``[bigmesh]``:
    ``scenes/displace_demo.txt`` with its icosahedron subdivided ``levels`` times (4: 5,120 triangles, above the
    in-kernel cap of 4,096; 5: 20,480, above kernel 9's 8,192, so the LBVH
    traversal).  Parse it with ``scene_dir`` set to ``scenes/``."""
    with open(os.path.join(SCENES_DIR, "displace_demo.txt")) as f:
        text = f.read()
    assert text.count("DISPLACE    0.06 3 sin 9\n") == 1
    return text.replace("DISPLACE    0.06 3 sin 9\n", f"DISPLACE    0.06 {levels} sin 9\n")


def grid_obj(cells: int) -> str:
    """OBJ text of a rippled ``cells`` x ``cells`` grid over the unit square
    (2 cells^2 triangles) with authored ``vt``: each vertex's UV is twice
    its (x, y) offset from the corner, so it is neither the box map nor
    within one tile."""
    c = np.linspace(-0.5, 0.5, cells + 1)
    x, y = np.meshgrid(c, c, indexing="xy")
    z = 0.05 * np.sin(6.0 * x) * np.cos(6.0 * y)
    lines = [f"v {a:.6f} {b:.6f} {h:.6f}" for a, b, h in zip(x.ravel(), y.ravel(), z.ravel())]
    lines += [f"vt {2.0 * (a + 0.5):.6f} {2.0 * (b + 0.5):.6f}" for a, b in zip(x.ravel(), y.ravel())]
    row = cells + 1
    for j in range(cells):
        for i in range(cells):
            a, b = j * row + i + 1, j * row + i + 2
            d, e = a + row, b + row
            lines += [f"f {a}/{a} {b}/{b} {e}/{e}", f"f {a}/{a} {e}/{e} {d}/{d}"]
    return "\n".join(lines) + "\n"


def quad_obj(authored_uv: bool) -> str:
    """The 2-triangle quad of ``tests/test_mesh_attrs.py:232-250``: with
    ``authored_uv`` its ``vt`` are the box map's turned 90 degrees."""
    vt = "vt 0 1\nvt 0 0\nvt 1 0\nvt 1 1\n" if authored_uv else ""
    face = "f 1/1 2/2 3/3 4/4\n" if authored_uv else "f 1 2 3 4\n"
    return "v -0.5 -0.5 0\nv 0.5 -0.5 0\nv 0.5 0.5 0\nv -0.5 0.5 0\n" + vt + face


def textured_mesh_scene(obj_path: str, bump: bool = False) -> str:
    """The scene text of ``chip_smoke.py``'s ``[bigmesh]`` (e):
    ``scenes/textured_image.txt`` (the image texture ``scenes/assets/quadrants.png``) with the mesh at
    ``obj_path`` (an absolute path) as geom 5, in the image-textured
    material, turned and scaled unevenly in front of the back wall (geom 1);
    ``bump`` adds a bump to that material.  Parse it with ``scene_dir`` set
    to ``scenes/``."""
    with open(os.path.join(SCENES_DIR, "textured_image.txt")) as f:
        text = f.read()
    if bump:
        marker = "TEXTURE     assets/quadrants.png 1\n"
        assert text.count(marker) == 1
        text = text.replace(marker, marker + "BUMP        18 .35\n")
    return text + (f"\nOBJECT 5\n{obj_path}\nmaterial 1\nframe 0\nTRANS 0.3 2.4 2.5\n"
                   "ROTAT 30 40 10\nSCALE 2.5 1.2 1.8\n")


def fog_mesh_scene(refractive: bool) -> str:
    """The scene text of ``chip_smoke.py``'s ``[vol]`` (e):
    ``scenes/fog.txt``'s lamp, index-matched scattering cube and backdrop, with smooth_mesh's
    icosphere (320 triangles, authored normals) inside the cube, in a glass
    material (refractive, Beer-Lambert) or an opaque diffuse one.  Parse it
    with ``scene_dir`` set to ``scenes/``."""
    mesh_mat = ("RGB 0 0 0\nSPECEX 0\nSPECRGB 1 1 1\nREFL 0\nREFR 1\nREFRIOR 1.5\nSCATTER 0\n"
                "ABSCOEFF .3 .1 .3\nRSCTCOEFF 0\nEMITTANCE 0" if refractive else
                "RGB .7 .5 .3\nSPECEX 0\nSPECRGB 1 1 1\nREFL 0\nREFR 0\nREFRIOR 0\nSCATTER 0\n"
                "ABSCOEFF 0 0 0\nRSCTCOEFF 0\nEMITTANCE 0")
    return f"""
MATERIAL 0
RGB .9 .9 .9
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
SCATTER 0
ABSCOEFF 0 0 0
RSCTCOEFF 0
EMITTANCE 40

MATERIAL 1
RGB 1 1 1
SPECEX 0
SPECRGB 1 1 1
REFL 0
REFR 1
REFRIOR 1.0
SCATTER 1
ABSCOEFF .01 .01 .01
RSCTCOEFF 0.8
EMITTANCE 0

MATERIAL 2
RGB .4 .4 .45
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
SCATTER 0
ABSCOEFF 0 0 0
RSCTCOEFF 0
EMITTANCE 0

MATERIAL 3
{mesh_mat}

CAMERA
RES 200 200
FOVY 40
ITERATIONS 64
FILE fog_mesh.png
frame 0
EYE 0 0 8
VIEW 0 0 -1
UP 0 1 0

OBJECT 0
sphere
material 0
frame 0
TRANS 2 2.5 -1
ROTAT 0 0 0
SCALE .4 .4 .4

OBJECT 1
cube
material 1
frame 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 6 6 6

OBJECT 2
cube
material 2
frame 0
TRANS 0 0 -8
ROTAT 0 0 0
SCALE 14 14 .3

OBJECT 3
assets/ico_smooth.obj
material 3
frame 0
TRANS -.6 -.4 .5
ROTAT 0 25 0
SCALE 2.5 2.5 2.5
"""
