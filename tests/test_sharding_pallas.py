"""End-to-end coverage of the sharded main path: the row-mesh sharded frame
at the main path's fp16 state, 5 a-trous iterations (the 16-step halo is
wider than an 8-row band, so the band gather path runs too) and TAA,
against the unsharded frame.

Runs on the virtual 8-device CPU mesh (conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.parallel import make_row_mesh, make_sharded_step
from svgf_jax.render.pipeline import render_frame
from svgf_jax.render.types import TemporalState
from svgf_jax.scenes import cornell_box

W, H = 64, 64
NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= NDEV
    return make_row_mesh(NDEV)


@pytest.fixture(scope="module")
def scene_arrays():
    scene = cornell_box(aspect=W / H)
    for c in scene.cameras:
        c.aspect = W / H
    return scene.flatten()


def make_config():
    return RenderConfig(
        width=W, height=H, state_dtype="float16",
        svgf=SVGFConfig(spatial_filter_steps=5),
        tracing=TracingConfig(bounces=2),
    )


def test_sharded_pallas_frame_matches_unsharded(mesh, scene_arrays):
    """Two frames (second exercises reprojection with live history) through
    BOTH the sharded band path and the unsharded path."""
    cfg = make_config()

    # unsharded reference (whole frame)
    state_u = TemporalState.initial(H, W, jnp.float16)
    step_u = jax.jit(lambda s: render_frame(scene_arrays, s, cfg))
    out_u1, state_u = step_u(state_u)
    out_u2, state_u = step_u(state_u)

    # sharded path (band stencils + ppermute halos)
    step_s = make_sharded_step(cfg, mesh)
    state_s = TemporalState.initial(H, W, jnp.float16)
    out_s1, state_s = step_s(scene_arrays, state_s)
    out_s2, state_s = step_s(scene_arrays, state_s)

    # trace is bitwise-reproducible (global-lane RNG); temporal/moments/
    # a-trous agree to float-reassociation tolerance; TAA's YUV clamp is
    # fusion-sensitive on boundary pixels (see test_sharding.py)
    np.testing.assert_allclose(
        np.asarray(out_s1.radiance), np.asarray(out_u1.radiance), atol=1e-6
    )
    for tap in ("temporal", "moments_filtered", "atrous"):
        a = np.asarray(getattr(out_s2, tap))
        b = np.asarray(getattr(out_u2, tap))
        np.testing.assert_allclose(a, b, atol=3e-5, err_msg=tap)
    d = np.abs(np.asarray(out_s2.final) - np.asarray(out_u2.final))
    assert d.mean() < 1e-4
    assert (d > 5e-3).mean() == 0.0

    # carried state agrees too (next frame's temporal inputs), to one fp16
    # rounding step: a reassociation-level f32 difference may round to the
    # neighbouring fp16 value (one ulp at 1.0 is 9.8e-4)
    for a, b in ((state_s.color, state_u.color), (state_s.moments, state_u.moments)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=1e-3)
    assert (np.asarray(state_s.history_len)
            == np.asarray(state_u.history_len)).all()
