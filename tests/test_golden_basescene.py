"""Golden-image parity on the reference's own shipped scene
(resources/Scenes/BaseScene, loaded by io.binscene — the binary
scene::FromFile format, Scene.cpp:551-651).

The goldens were produced by scripts/make_goldens.py on the CPU test
backend and visually compared against the reference gallery
(resources/Gallery/BaseSceneRaw.png / BaseSceneDenoised.png) — comparison
notes in PARITY.md. This test fails on ANY pixel drift of the raw 1spp
trace or the 6-stage denoised output.
"""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.io.binscene import load_reference_scene
from svgf_jax.render.pipeline import render_frame
from svgf_jax.render.types import TemporalState

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "basescene.npz")
BASESCENE = "/root/reference/resources/Scenes/BaseScene"


@pytest.mark.skipif(not os.path.exists(BASESCENE), reason="reference scene absent")
def test_basescene_matches_golden():
    g = np.load(GOLDEN)
    W, H, frames = int(g["width"]), int(g["height"]), int(g["frames"])
    cfg = RenderConfig(
        width=W, height=H, state_dtype="float32",
        tracing=TracingConfig(bounces=3),
        svgf=SVGFConfig(spatial_filter_steps=5),
    )
    scene = load_reference_scene(BASESCENE)
    for c in scene.cameras:
        c.aspect = W / H
    arrays = scene.flatten()
    rf = jax.jit(functools.partial(render_frame, config=cfg))
    state = TemporalState.initial(H, W, jnp.float32)
    for _ in range(frames):
        out, state = rf(arrays, state)

    raw = np.asarray(out.radiance)
    final = np.asarray(out.final)
    # goldens stored f16: tolerance = f16 quantization + fp reassociation
    np.testing.assert_allclose(raw, g["raw"].astype(np.float32),
                               atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(final, g["final"].astype(np.float32),
                               atol=2e-3, rtol=1e-2)
