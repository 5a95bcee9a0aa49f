"""Optional-physics feature resolution.

Port of ``pathtracer_tpu/render/diff.py:405-463``
(``features_for_materials``, ``resolve_features``): the minimal
``RenderConfig.features`` tuple for a concrete material table.  Every render
entry point applies it, so a plain scene (Cornell resolves to ``()``) runs
the base physics only.
"""

from __future__ import annotations

import dataclasses

from pathtracer_tpu_torch.config import RenderConfig

_DEFAULT_FEATURES = RenderConfig().features


def features_for_materials(materials) -> tuple:
    """The minimal feature tuple for ``materials`` (a ``Materials``)."""

    def arr(x):
        return x.detach().cpu().numpy()

    feats = []
    if (arr(materials.texture_type) > 0).any():
        feats.append("texture")
    if (arr(materials.bump_scale) > 0).any():
        feats.append("bump")
    if (arr(materials.has_scatter) > 0).any() or (
        arr(materials.absorption_coefficient) > 0
    ).any():
        feats.append("volumetric")
    if (
        (arr(materials.specular_exponent) > 0) & (arr(materials.has_reflective) > 0)
    ).any():
        feats.append("glossy")
    if (arr(materials.brdf_model) > 0).any():
        feats.append("microfacet")
    if (arr(materials.brdf_model) > 1.5).any():
        feats.append("ward")
    if ((arr(materials.has_scatter) > 0) & (arr(materials.phase_g) != 0)).any():
        feats.append("hg")
    return tuple(feats)


def resolve_features(cfg: RenderConfig, materials) -> RenderConfig:
    """Apply ``auto_features``; a non-default ``features`` tuple is an
    explicit pin and is kept."""
    if not cfg.auto_features or cfg.features != _DEFAULT_FEATURES:
        return cfg
    return dataclasses.replace(cfg, features=features_for_materials(materials))
