"""End-to-end pipeline tests: full 6-stage frame on the Cornell box."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax import DebugOutput, RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.core.camera import orbit_frame
from svgf_jax.render.pipeline import Renderer, render_frame
from svgf_jax.render.types import TemporalState
from svgf_jax.scenes import cornell_box

W, H = 64, 48


def make_config(**kw):
    svgf = kw.pop("svgf", SVGFConfig(spatial_filter_steps=3))
    tracing = kw.pop("tracing", TracingConfig(bounces=2))
    return RenderConfig(width=W, height=H, svgf=svgf, tracing=tracing,
                        state_dtype="float32", **kw)


@pytest.fixture(scope="module")
def renderer():
    cfg = make_config()
    return Renderer(cornell_box(aspect=W / H), cfg)


def test_frame_is_finite_and_bounded(renderer):
    out = renderer.step()
    fin = np.asarray(out.final)
    assert np.isfinite(fin).all()
    assert fin.min() >= 0.0 and fin.max() <= 1.0
    rad = np.asarray(out.radiance)
    assert np.isfinite(rad).all()
    assert rad.max() <= renderer.config.tracing.clamp + 1e-3
    # at this aspect the view extends past the box opening at the sides, but
    # the central region is fully covered
    inst = np.asarray(out.gbuffer.instance)
    assert (inst >= 0).mean() > 0.6
    assert (inst[:, W // 4 : 3 * W // 4] >= 0).all()


def test_temporal_accumulation_reduces_noise(renderer):
    outs = [renderer.step() for _ in range(6)]
    assert int(np.asarray(renderer.state.history_len).max()) >= 6
    # denoised output is much smoother than the raw 1spp input
    raw_std = np.asarray(outs[-1].radiance).std()
    dn_std = np.asarray(outs[-1].atrous[..., :3]).std()
    assert dn_std < raw_std
    # consecutive denoised frames are temporally stable
    d = np.abs(np.asarray(outs[-1].final) - np.asarray(outs[-2].final)).mean()
    assert d < 0.05


def test_motion_vectors_on_orbit():
    cfg = make_config()
    r = Renderer(cornell_box(aspect=W / H), cfg)
    r.step()
    r.update_camera(orbit_frame([0, 0, 0], 3.4, theta=0.06, phi=0.0))
    out = r.step()
    motion = np.asarray(out.gbuffer.motion)
    inst = np.asarray(out.gbuffer.instance)
    # camera rotated: covered pixels must carry nonzero motion
    assert np.abs(motion[inst >= 0]).max() > 0.5
    # most pixels should still reproject successfully (small rotation)
    hist = np.asarray(r.state.history_len)
    assert (hist >= 2).mean() > 0.5


def test_debug_taps():
    base = make_config()
    scene = cornell_box(aspect=W / H)
    for cam in scene.cameras:
        cam.aspect = W / H
    arrays = scene.flatten()
    state = TemporalState.initial(H, W, jnp.float32)
    for tap in [DebugOutput.RAW, DebugOutput.NORMAL, DebugOutput.DEPTH,
                DebugOutput.VARIANCE, DebugOutput.BARYCENTRIC]:
        cfg = dataclasses.replace(base, debug_output=tap)
        out, _ = jax.jit(functools.partial(render_frame, config=cfg))(arrays, state)
        img = np.asarray(out.image)
        assert img.shape == (H, W, 3)
        assert np.isfinite(img).all()


def test_spp_batch_reduces_variance():
    cfg1 = make_config(tracing=TracingConfig(bounces=2, batch=1))
    cfg4 = make_config(tracing=TracingConfig(bounces=2, batch=4))
    scene = cornell_box(aspect=W / H)
    for cam in scene.cameras:
        cam.aspect = W / H
    arrays = scene.flatten()
    state = TemporalState.initial(H, W, jnp.float32)
    out1, _ = jax.jit(functools.partial(render_frame, config=cfg1))(arrays, state)
    out4, _ = jax.jit(functools.partial(render_frame, config=cfg4))(arrays, state)
    # 4spp raw radiance has lower high-frequency noise than 1spp
    def hf(x):
        x = np.asarray(x).mean(-1)
        return np.abs(np.diff(x, axis=1)).mean()

    assert hf(out4.radiance) < hf(out1.radiance)


def test_gradients_wrt_materials():
    """BASELINE config #5 core: d(pixels)/d(material albedo) exists."""
    cfg = make_config(svgf=SVGFConfig(spatial_filter_steps=2, enable_taa=False))
    scene = cornell_box(aspect=W / H)
    for cam in scene.cameras:
        cam.aspect = W / H
    arrays = scene.flatten()
    state = TemporalState.initial(H, W, jnp.float32)

    def loss(colours):
        arr = dataclasses.replace(arrays, mat_colour=colours)
        out, _ = render_frame(arr, state, cfg)
        return jnp.mean(out.final ** 2)

    g = jax.jit(jax.grad(loss))(arrays.mat_colour)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # white-wall albedo definitely affects the image
    assert np.abs(g[0]).max() > 0.0


def test_pallas_kernel_path_matches_xla():
    """The perf path (keep_taps=False, the main-path setting) renders the
    same frame as the debug path that keeps every stage's taps."""
    scene = cornell_box(aspect=W / H).flatten()
    cfg_x = make_config()
    cfg_p = make_config(keep_taps=False)
    state = TemporalState.initial(H, W, jnp.float32)
    out_x, st_x = render_frame(scene, state, cfg_x)
    out_p, st_p = render_frame(scene, jax.tree.map(jnp.copy, state), cfg_p)
    assert out_p.atrous is None and out_p.radiance is None
    np.testing.assert_array_equal(np.asarray(st_p.history_len),
                                  np.asarray(st_x.history_len))
    # the same program minus the extra outputs: XLA may fuse it differently,
    # so isolated pixels may differ at float-reassociation level
    for a, b in ((out_p.final, out_x.final),
                 (st_p.color, st_x.color), (st_p.taa_history, st_x.taa_history)):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.mean() < 5e-5
        assert (d > 5e-2).mean() < 1e-4
