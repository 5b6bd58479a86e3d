"""Generate committed golden renders of the reference's own BaseScene
(resources/Scenes/BaseScene) through the full 6-stage pipeline.

Run on the CPU backend (the test backend) for bit-stable goldens:
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/make_goldens.py

Outputs tests/goldens/basescene.npz (raw + final, f16) and PNG previews for
visual comparison against resources/Gallery/BaseScene{Raw,Denoised}.png
(recorded in PARITY.md).
"""
import os
import functools

import numpy as np
import jax
import jax.numpy as jnp

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.io.binscene import load_reference_scene
from svgf_jax.render.pipeline import render_frame
from svgf_jax.render.types import TemporalState
from svgf_jax.utils.image import write_png
from svgf_jax.utils.jax_cache import enable_compilation_cache

enable_compilation_cache()

W, H = 320, 180
FRAMES = 3

cfg = RenderConfig(
    width=W, height=H, state_dtype="float32",
    tracing=TracingConfig(bounces=3),
    svgf=SVGFConfig(spatial_filter_steps=5),
)

scene = load_reference_scene("/root/reference/resources/Scenes/BaseScene")
for c in scene.cameras:
    c.aspect = W / H
arrays = scene.flatten()

rf = jax.jit(functools.partial(render_frame, config=cfg))
state = TemporalState.initial(H, W, jnp.float32)
for _ in range(FRAMES):
    out, state = rf(arrays, state)

raw = np.asarray(out.radiance)
final = np.asarray(out.final)
assert np.isfinite(raw).all() and np.isfinite(final).all()
print("raw mean", raw.mean(), "final mean", final.mean())

os.makedirs("tests/goldens", exist_ok=True)
np.savez_compressed(
    "tests/goldens/basescene.npz",
    raw=raw.astype(np.float16),
    final=final.astype(np.float16),
    frames=FRAMES, width=W, height=H,
)
write_png("tests/goldens/basescene_raw.png",
          np.clip(raw, 0, 1) ** (1 / 2.2))
write_png("tests/goldens/basescene_final.png", np.clip(final, 0, 1))
print("goldens written")
