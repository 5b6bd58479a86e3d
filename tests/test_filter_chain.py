"""pipeline.filter_chain across frames: stage wiring, state precision,
pass-through pixels and unbounded reprojection."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.ops.geometry import to_srgb
from svgf_jax.render import svgf
from svgf_jax.render.pipeline import filter_chain, render_frame
from svgf_jax.render.types import GBuffer, TemporalState
from svgf_jax.scenes import cornell_box

H, W = 24, 136


def make_config(**kw):
    return RenderConfig(
        width=W, height=H, state_dtype="float32",
        svgf=kw.pop("svgf", SVGFConfig(spatial_filter_steps=3)),
        tracing=kw.pop("tracing", TracingConfig(bounces=2)),
        **kw,
    )


def make_frame_inputs(seed=0, with_background=False, max_motion=(6, 40)):
    """Radiance + G-buffer + a warmed-up TemporalState on the same geometry."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(1, 5, (H, W)).astype(np.float32)
    inst = rng.integers(0, 3, (H, W)).astype(np.int32)
    if with_background:
        mask = rng.uniform(size=(H, W)) < 0.2
        depth = np.where(mask, 0.0, depth)
        n = np.where(mask[..., None], 0.0, n)
        inst = np.where(mask, -1, inst)
    my, mx = max_motion
    motion = np.stack(
        [np.trunc(rng.uniform(-mx, mx, (H, W))),
         np.trunc(rng.uniform(-my, my, (H, W)))], axis=-1,
    ).astype(np.float32)
    gbuf = GBuffer.zeros(H, W)._replace(
        depth=jnp.asarray(depth),
        depth_deriv=jnp.asarray(rng.uniform(1e-4, 1e-2, (H, W)), jnp.float32),
        normal=jnp.asarray(n, jnp.float32),
        instance=jnp.asarray(inst),
        motion=jnp.asarray(motion),
    )
    radiance = jnp.asarray(rng.uniform(0, 1, (H, W, 3)), jnp.float32)
    state = TemporalState.initial(H, W, jnp.float32)._replace(
        color=jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32),
        moments=jnp.asarray(rng.uniform(0, 0.5, (H, W, 2)), jnp.float32),
        history_len=jnp.asarray(rng.integers(1, 24, (H, W)).astype(np.int32)),
        taa_history=jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32),
        gbuffer=gbuf,
    )
    return radiance, gbuf, state


def chain_outputs(radiance, gbuf, state, config):
    tres, moments_out, atrous_out, final, feedback = jax.jit(
        lambda v: filter_chain(v, gbuf, state, config))(radiance)
    return {
        "temporal": tres.color, "t_moments": tres.moments,
        "t_hist": tres.history_len, "t_valid": tres.reprojected,
        "moments": moments_out, "atrous": atrous_out,
        "final": final, "feedback": feedback,
    }


@pytest.mark.parametrize("case", ["plain", "background", "no_atrous_no_taa"])
def test_filter_chain_stage_wiring(case):
    """filter_chain wires the stages as the reference does (App.cu:469-522):
    temporal -> moments -> a-trous (step 1, 2, 4, ...) -> TAA against the
    previous TAA output; the feedback is a-trous iteration 0, or the
    temporal output when there is no a-trous iteration."""
    radiance, gbuf, state = make_frame_inputs(
        seed={"plain": 0, "background": 5, "no_atrous_no_taa": 2}[case],
        with_background=case == "background")
    sv = (SVGFConfig(spatial_filter_steps=0, enable_taa=False)
          if case == "no_atrous_no_taa" else SVGFConfig(spatial_filter_steps=3))
    cfg = make_config(svgf=sv)
    out = chain_outputs(radiance, gbuf, state, cfg)

    tres = svgf.temporal_filter(radiance, state.color, gbuf, state.gbuffer,
                                state.moments, state.history_len, 0.8, 0.9, 24)
    mom = svgf.filter_moments(tres.color, tres.moments, gbuf, tres.history_len,
                              10.0, 128.0)
    x, first = mom, tres.color
    for k in range(sv.spatial_filter_steps):
        x = svgf.atrous_iteration(x, gbuf, 1 << k, 10.0, 128.0)
        if k == 0:
            first = x
    if sv.enable_taa:
        final = svgf.taa(x, state.taa_history)
    else:
        final = np.concatenate([np.asarray(to_srgb(jnp.clip(x[..., :3], 0, 1))),
                                np.ones((H, W, 1), np.float32)], -1)
    # the chain runs jitted, the composition above eagerly: XLA fuses them
    # differently, and the variance-guided weights (phi_l ~ 1/sqrt(var))
    # amplify the reassociation on near-zero-variance pixels
    for k, want in (("temporal", tres.color), ("t_hist", tres.history_len),
                    ("moments", mom), ("atrous", x), ("feedback", first),
                    ("final", final)):
        np.testing.assert_allclose(np.asarray(out[k], np.float32),
                                   np.asarray(want, np.float32), atol=2e-4, err_msg=k)


def shifted_state(motion, seed=1):
    """Previous G-buffer = current geometry shifted by `motion` (x, y), so
    every on-screen reprojection target matches."""
    radiance, gbuf, state = make_frame_inputs(seed=seed, max_motion=(0, 0))
    mx, my = motion
    r, c = np.mgrid[0:H, 0:W]
    src = (np.clip(r - my, 0, H - 1), np.clip(c - mx, 0, W - 1))
    prev = gbuf._replace(**{
        f: jnp.asarray(np.asarray(getattr(gbuf, f))[src])
        for f in ("depth", "normal", "instance")
    })
    gbuf = gbuf._replace(
        motion=jnp.asarray(np.broadcast_to(np.float32([mx, my]), (H, W, 2))))
    on_screen = ((r + my >= 0) & (r + my < H) & (c + mx >= 0) & (c + mx < W))
    return radiance, gbuf, state._replace(gbuffer=prev), on_screen


@pytest.mark.parametrize("motion", [(0, 12), (-90, 12), (70, 0), (0, -20)])
def test_filter_chain_large_motion_reprojected(motion):
    """Motion beyond |dy| = 8 rows or |dx| = 63 columns per frame is
    reprojected like any other (the reference gathers anywhere,
    Filter.cuh:230-232): every on-screen target is valid."""
    radiance, gbuf, state, on_screen = shifted_state(motion)
    out = chain_outputs(radiance, gbuf, state, make_config())
    np.testing.assert_array_equal(np.asarray(out["t_valid"]), on_screen)
    hist = np.asarray(out["t_hist"])
    assert (hist[on_screen] >= 2).all() and (hist[~on_screen] == 1).all()
    assert np.isfinite(np.asarray(out["final"])).all()


def test_filter_chain_background_and_edges_pass_through():
    """Invalid-depth pixels pass through the moments fallback and every
    a-trous iteration (Filter.cuh:554-558)."""
    radiance, gbuf, state = make_frame_inputs(seed=7, with_background=True)
    out = chain_outputs(radiance, gbuf, state, make_config())
    bg = np.asarray(gbuf.depth) == 0.0
    assert bg.any()
    temporal = np.asarray(out["temporal"])
    np.testing.assert_array_equal(np.asarray(out["moments"])[bg], temporal[bg])
    np.testing.assert_allclose(np.asarray(out["atrous"])[bg],
                               np.clip(temporal[bg], 0, 1), atol=1e-7)


def test_fp16_state_matches_f32():
    """Three orbit frames with fp16 state (the reference's storage,
    App.cu:763-773) stay within fp16 rounding of the f32-state frames."""
    scene = cornell_box(aspect=W / H)
    scene.cameras[0].aspect = W / H
    arrays = scene.flatten()

    def run(dtype):
        cfg = dataclasses.replace(make_config(), state_dtype=dtype)
        step = jax.jit(lambda s: render_frame(arrays, s, cfg))
        state = TemporalState.initial(H, W, jnp.dtype(dtype))
        for _ in range(3):
            out, state = step(state)
        return out

    a, b = run("float16"), run("float32")
    for tap in ("temporal", "atrous", "final"):
        d = np.abs(np.asarray(getattr(a, tap), np.float32)
                   - np.asarray(getattr(b, tap)))
        assert d.mean() < 2e-3, (tap, d.mean())
        assert d.max() < 5e-2, (tap, d.max())


def test_bench_inputs_stay_finite():
    """bench.py's steady-state orbit frame: finite through the whole chain,
    with a mostly horizontal pan and a ~3% short-history band."""
    import bench

    radiance, gbuf, state = bench.make_bench_inputs(64, 128)
    m = np.asarray(gbuf.motion)
    assert np.abs(m[..., 0]).min() >= 1 and np.abs(m[..., 1]).max() <= 2
    cfg = RenderConfig(width=128, height=64,
                       svgf=SVGFConfig(spatial_filter_steps=5))
    out = chain_outputs(radiance, gbuf, state, cfg)
    for k, v in out.items():
        assert np.isfinite(np.asarray(v, np.float32)).all(), k
    short = (np.asarray(state.history_len) < 4).mean()
    assert 0.01 < short < 0.1
