"""Multi-chip sharding tests on the virtual 8-device CPU mesh:
sharded filters == unsharded filters, and the full sharded frame runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.parallel import make_row_mesh, make_sharded_step, make_train_step
from svgf_jax.render import svgf
from svgf_jax.render.pipeline import render_frame
from svgf_jax.render.types import GBuffer, TemporalState
from svgf_jax.scenes import cornell_box

W, H = 64, 64
NDEV = 8


def make_config(**kw):
    return RenderConfig(
        width=W, height=H, state_dtype="float32",
        svgf=kw.pop("svgf", SVGFConfig(spatial_filter_steps=3)),
        tracing=kw.pop("tracing", TracingConfig(bounces=2)),
        **kw,
    )


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


def random_gbuffer(h, w, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return GBuffer.zeros(h, w)._replace(
        depth=jnp.asarray(rng.uniform(1, 3, (h, w)), jnp.float32),
        depth_deriv=jnp.asarray(rng.uniform(1e-4, 1e-2, (h, w)), jnp.float32),
        normal=jnp.asarray(n, jnp.float32),
        instance=jnp.zeros((h, w), jnp.int32),
    )


def test_sharded_stencils_match_unsharded(mesh):
    """Halo-exchanged band filters == full-image filters, bit-for-bit-ish."""
    from svgf_jax.parallel.sharded import _atrous_band, _moments_filter_band, _taa_band

    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32)
    mom = jnp.asarray(rng.uniform(0, 1, (H, W, 2)), jnp.float32)
    hist = jnp.asarray(rng.integers(1, 10, (H, W)), jnp.int32)
    g = random_gbuffer(H, W)
    cfg = make_config()

    ref_m = svgf.filter_moments(img, mom, g, hist, 10.0, 128.0)
    ref_a1 = svgf.atrous_iteration(img, g, 1, 10.0, 128.0)
    ref_a4 = svgf.atrous_iteration(img, g, 4, 10.0, 128.0)
    ref_t = svgf.taa(img, img)

    axis = mesh.axis_names[0]
    P = jax.sharding.PartitionSpec
    rows = P(axis)
    gspec = GBuffer(*([rows] * 9))

    def sharded(fn):
        return jax.jit(
            jax.shard_map(
                fn, mesh=mesh, in_specs=(rows, rows, gspec, rows),
                out_specs=rows, check_vma=False,
            )
        )

    out_m = sharded(
        lambda i, m, gb, hh: _moments_filter_band(i, m, gb, hh, cfg, axis)
    )(img, mom, g, hist)
    np.testing.assert_allclose(np.asarray(out_m), np.asarray(ref_m), atol=2e-5)

    out_a1 = sharded(lambda i, m, gb, hh: _atrous_band(i, gb, 1, cfg, axis))(
        img, mom, g, hist
    )
    np.testing.assert_allclose(np.asarray(out_a1), np.asarray(ref_a1), atol=2e-5)

    # step 4 -> halo 8 == band height: exercises the gather fallback
    out_a4 = sharded(lambda i, m, gb, hh: _atrous_band(i, gb, 4, cfg, axis))(
        img, mom, g, hist
    )
    np.testing.assert_allclose(np.asarray(out_a4), np.asarray(ref_a4), atol=2e-5)

    out_t = sharded(lambda i, m, gb, hh: _taa_band(i, i, cfg, axis))(img, mom, g, hist)
    # TAA's YUV neighborhood clamp is fp-fusion-sensitive: pixels sitting on
    # the clamp boundary can flip under different XLA fusions, so a handful
    # of pixels differ at the 1e-3 level; the field must still agree closely
    d = np.abs(np.asarray(out_t) - np.asarray(ref_t))
    assert d.mean() < 1e-4
    assert (d > 5e-3).mean() == 0.0


def test_sharded_frame_runs_and_is_sane(mesh, scene_arrays):
    cfg = make_config()
    step = make_sharded_step(cfg, mesh)
    state = TemporalState.initial(H, W, jnp.float32)
    out, state = step(scene_arrays, state)
    out2, state = step(scene_arrays, state)
    img = np.asarray(out2.final)
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 and img.min() >= 0.0
    assert int(np.asarray(state.history_len).max()) == 2
    assert int(np.asarray(state.frame_idx)) == 2
    # covered pixels produce light
    assert img.mean() > 0.05


def test_sharded_frame_matches_unsharded_exactly(mesh, scene_arrays):
    """Full sharded frames == unsharded frames. The counter-based RNG hashes
    GLOBAL pixel ids (ops.sampling.RngStream), so even the trace stage is
    partition-independent; filters use exact halo exchange."""
    cfg = make_config()
    step = make_sharded_step(cfg, mesh)
    s_state = TemporalState.initial(H, W, jnp.float32)
    for _ in range(3):
        s_out, s_state = step(scene_arrays, s_state)

    u_state = TemporalState.initial(H, W, jnp.float32)
    rf = jax.jit(functools.partial(render_frame, config=cfg))
    for _ in range(3):
        u_out, u_state = rf(scene_arrays, u_state)

    np.testing.assert_allclose(
        np.asarray(s_out.final), np.asarray(u_out.final), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_out.radiance), np.asarray(u_out.radiance), atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(s_state.history_len), np.asarray(u_state.history_len)
    )


def test_tiled_2d_frame_matches_unsharded(scene_arrays):
    """2-D (2x4) tile mesh == unsharded, full pipeline (VERDICT r2 item 6)."""
    from svgf_jax.parallel import make_tile_mesh, make_tiled_step

    cfg = make_config()
    mesh2 = make_tile_mesh(2, 4)
    step = make_tiled_step(cfg, mesh2)
    s_state = TemporalState.initial(H, W, jnp.float32)
    for _ in range(2):
        s_out, s_state = step(scene_arrays, s_state)

    u_state = TemporalState.initial(H, W, jnp.float32)
    rf = jax.jit(functools.partial(render_frame, config=cfg))
    for _ in range(2):
        u_out, u_state = rf(scene_arrays, u_state)

    np.testing.assert_allclose(
        np.asarray(s_out.final), np.asarray(u_out.final), atol=2e-5
    )
    np.testing.assert_array_equal(
        np.asarray(s_state.history_len), np.asarray(u_state.history_len)
    )


def test_tiled_2d_no_allgather_when_tiles_cover_halos():
    """When every tile is larger than every stencil halo, the stencils move
    data only through neighbor ppermutes (collective-permute): the only
    all-gathers in the compiled tiled step are the exact (unbounded)
    temporal reprojection's — one per previous-frame plane (colour,
    moments, history, depth, instance, normal) and mesh axis."""
    import re

    from svgf_jax.parallel import make_tile_mesh, make_tiled_step

    w2, h2 = 256, 128          # 2x4 mesh -> 64x64 tiles > halos (8, 63)
    cfg = RenderConfig(
        width=w2, height=h2, state_dtype="float32",
        svgf=SVGFConfig(spatial_filter_steps=3),
        tracing=TracingConfig(bounces=1),
    )
    scene = cornell_box(aspect=w2 / h2)
    for c in scene.cameras:
        c.aspect = w2 / h2
    arrays = scene.flatten()

    mesh2 = make_tile_mesh(2, 4)
    step = make_tiled_step(cfg, mesh2)
    state = TemporalState.initial(h2, w2, jnp.float32)
    txt = step.lower(arrays, state).compile().as_text()
    ags = re.findall(r"all-gather(?:-start)?\(", txt)
    assert 0 < len(ags) <= 6 * 2, f"unexpected all-gathers: {len(ags)}"
    assert "collective-permute" in txt  # the halos ride ppermute

    # and the tiled step matches the unsharded frame
    s_out, s_state = step(arrays, state)
    u_out, _ = jax.jit(functools.partial(render_frame, config=cfg))(
        arrays, TemporalState.initial(h2, w2, jnp.float32)
    )
    np.testing.assert_allclose(
        np.asarray(s_out.final), np.asarray(u_out.final), atol=2e-5
    )


def test_tiled_train_step_matches_unsharded_grads(scene_arrays):
    """Sharded (host x chip) grads == unsharded grads (VERDICT r2 item 5)."""
    import dataclasses as dc

    from svgf_jax.parallel import make_tile_mesh, make_tiled_train_step

    cfg = make_config(svgf=SVGFConfig(spatial_filter_steps=2, enable_taa=False))
    params = {"mat_colour": scene_arrays.mat_colour,
              "cam_frame": scene_arrays.cam_frame}
    target = jnp.zeros((H, W, 3))

    def base_loss(p):
        sc = dc.replace(scene_arrays, **p)
        st = TemporalState.initial(H, W, jnp.float32)
        out, _ = render_frame(sc, st, cfg)
        return jnp.mean((out.final - target) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(base_loss))(params)

    mesh2 = make_tile_mesh(2, 4)
    train = make_tiled_train_step(cfg, mesh2, param_fields=tuple(params))
    state = TemporalState.initial(H, W, jnp.float32)
    loss, grads, _ = train(params, scene_arrays, state, target)

    # one shared tolerance/assert policy with __graft_entry__.dryrun_multichip
    from svgf_jax.parallel.checks import assert_sharded_parity

    assert_sharded_parity("tiled-2x4", loss, grads, ref_loss, ref_grads)


def test_sharded_train_step(mesh, scene_arrays):
    cfg = make_config(svgf=SVGFConfig(spatial_filter_steps=2, enable_taa=False))
    train = make_train_step(cfg, mesh)
    state = TemporalState.initial(H, W, jnp.float32)
    params = {"mat_colour": scene_arrays.mat_colour,
              "mat_emission": scene_arrays.mat_emission}
    target = jnp.zeros((H, W, 3))
    loss, grads, state = train(params, scene_arrays, state, target)
    assert np.isfinite(float(loss))
    g = np.asarray(grads["mat_colour"])
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0
