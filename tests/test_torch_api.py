"""The port's top-level names: every name the JAX package exports
(``pathtracer_tpu.__all__``) is exported by ``pathtracer_tpu_torch`` too,
so code written against the reference's top-level names imports."""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import importlib

import pytest

import pathtracer_tpu
import pathtracer_tpu_torch


def test_jax_names_are_a_subset_of_the_ports():
    missing = sorted(set(pathtracer_tpu.__all__) - set(pathtracer_tpu_torch.__all__))
    assert not missing, f"names the port does not export: {missing}"


@pytest.mark.parametrize("name", sorted(pathtracer_tpu.__all__))
def test_each_name_imports(name):
    """``from pathtracer_tpu_torch import <name>`` works and gives the
    port's own object, not the reference's."""
    obj = getattr(importlib.import_module("pathtracer_tpu_torch"), name)
    assert obj is not None
    assert getattr(obj, "__module__", "pathtracer_tpu_torch").startswith("pathtracer_tpu_torch")


def test_the_reference_names_import_in_one_statement():
    from pathtracer_tpu_torch import (  # noqa: F401
        Camera,
        Geoms,
        Materials,
        Rays,
        Scene,
        parse_scene_text,
        render_chunk,
    )
