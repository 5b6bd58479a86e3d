"""SVGF filter-chain unit tests: invariants + reference-quirk checks."""

import jax
import jax.numpy as jnp
import numpy as np

from svgf_jax.ops.geometry import to_srgb
from svgf_jax.render.svgf import (
    atrous_chain,
    atrous_iteration,
    filter_moments,
    taa,
    temporal_filter,
    wavelet_steps,
)
from svgf_jax.render.types import GBuffer

atrous_iteration = jax.jit(atrous_iteration, static_argnames=("step",))
temporal_filter = jax.jit(temporal_filter)
filter_moments = jax.jit(filter_moments)
taa = jax.jit(taa)
atrous_chain = jax.jit(atrous_chain, static_argnames=("steps",))

H, W = 32, 48


def flat_gbuffer(h=H, w=W, depth=2.0, normal=(0.0, 0.0, 1.0)):
    g = GBuffer.zeros(h, w)
    return g._replace(
        depth=jnp.full((h, w), depth),
        depth_deriv=jnp.full((h, w), 1e-4),
        normal=jnp.broadcast_to(jnp.asarray(normal), (h, w, 3)).astype(jnp.float32),
        instance=jnp.zeros((h, w), jnp.int32),
    )


def test_atrous_preserves_constant():
    img = jnp.concatenate(
        [jnp.full((H, W, 3), 0.5), jnp.full((H, W, 1), 0.04)], axis=-1
    )
    out = atrous_iteration(img, flat_gbuffer(), step=1, phi_colour=10.0, phi_normal=128.0)
    np.testing.assert_allclose(out[..., :3], 0.5, atol=1e-6)
    # variance shrinks: sum(w^2 v) / (sum w)^2 < v for >1 taps
    assert float(out[..., 3].mean()) < 0.04
    assert float(out[..., 3].min()) > 0.0


def test_atrous_smooths_noise():
    rng = np.random.default_rng(0)
    noise = jnp.asarray(
        np.concatenate(
            [0.5 + 0.2 * rng.standard_normal((H, W, 3)), 0.04 * np.ones((H, W, 1))], -1
        ),
        jnp.float32,
    )
    out = atrous_iteration(noise, flat_gbuffer(), step=1, phi_colour=10.0, phi_normal=128.0)
    assert float(jnp.std(out[..., 0])) < float(jnp.std(jnp.clip(noise[..., 0], 0, 1)))


def test_atrous_respects_normal_edges():
    # left half normal +z, right half +x: no bleeding across the edge
    g = flat_gbuffer()
    nx = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (H, W, 3))
    mask = (jnp.arange(W) >= W // 2)[None, :, None]
    g = g._replace(normal=jnp.where(mask, nx, g.normal).astype(jnp.float32))
    img = jnp.where(
        mask, jnp.asarray([1.0, 0, 0, 0.01]), jnp.asarray([0, 0, 1.0, 0.01])
    ).astype(jnp.float32) * jnp.ones((H, W, 4))
    out = atrous_iteration(img, g, step=1, phi_colour=10.0, phi_normal=128.0)
    # a pixel at the left of the edge keeps zero red; right keeps zero blue
    np.testing.assert_allclose(out[:, W // 2 - 1, 0], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[:, W // 2, 2], 0.0, atol=1e-5)


def test_atrous_invalid_depth_passthrough():
    g = flat_gbuffer()._replace(depth=jnp.zeros((H, W)))  # depth 0 = invalid
    img = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (H, W, 4)), jnp.float32)
    out = atrous_iteration(img, g, step=2, phi_colour=10.0, phi_normal=128.0)
    np.testing.assert_allclose(out, jnp.clip(img, 0, 1), atol=1e-6)


def test_atrous_input_clamped():
    # imageLoad clamps to [0,1] (Filter.cuh:71-83) — HDR input saturates
    img = jnp.concatenate([jnp.full((H, W, 3), 7.0), jnp.zeros((H, W, 1))], -1)
    out = atrous_iteration(img, flat_gbuffer(), step=1, phi_colour=10.0, phi_normal=128.0)
    np.testing.assert_allclose(out[..., :3], 1.0, atol=1e-6)


def test_wavelet_feedback_is_iteration0():
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32)
    g = flat_gbuffer()
    it0 = atrous_iteration(img, g, 1, 10.0, 128.0)
    final, feedback = atrous_chain(img, g, steps=wavelet_steps(3), phi_colour=10.0,
                                   phi_normal=128.0)
    np.testing.assert_allclose(feedback, it0, atol=1e-6)
    assert not np.allclose(final, it0)


def test_temporal_accumulation_static_camera():
    g = flat_gbuffer()
    prev_color = jnp.zeros((H, W, 4))
    prev_moments = jnp.zeros((H, W, 2))
    prev_history = jnp.zeros((H, W), jnp.int32)
    rng = np.random.default_rng(3)
    mean = 0.3
    cols = []
    state = (prev_color, prev_moments, prev_history)
    for _ in range(16):
        cur = jnp.asarray(
            np.clip(mean + 0.1 * rng.standard_normal((H, W, 3)), 0, 1), jnp.float32
        )
        res = temporal_filter(
            cur, state[0], g, g, state[1], state[2],
            depth_threshold=0.8, normal_threshold=0.9, history_base_length=24,
        )
        state = (res.color, res.moments, res.history_len)
        cols.append(np.asarray(res.color[..., :3]).mean())
    # history increments each frame
    assert int(res.history_len[0, 0]) == 16
    assert bool(res.reprojected.all())
    # accumulated mean approaches the true mean
    assert abs(cols[-1] - mean) < 0.02
    # variance estimate is positive and small
    v = float(res.color[..., 3].mean())
    assert 0.0 <= v < 0.05


def test_temporal_disocclusion_resets():
    g = flat_gbuffer()
    g_other = g._replace(instance=jnp.ones((H, W), jnp.int32))  # mesh-id mismatch
    cur = jnp.full((H, W, 3), 0.7)
    res = temporal_filter(
        cur, jnp.full((H, W, 4), 0.1), g, g_other,
        jnp.zeros((H, W, 2)), jnp.full((H, W), 9, jnp.int32),
        depth_threshold=0.8, normal_threshold=0.9, history_base_length=24,
    )
    assert not bool(res.reprojected.any())
    assert int(res.history_len.max()) == 1
    np.testing.assert_allclose(res.color[..., :3], 0.7, atol=1e-6)


def test_temporal_depth_rejection():
    g = flat_gbuffer(depth=2.0)
    g_far = flat_gbuffer(depth=4.0)
    cur = jnp.full((H, W, 3), 0.5)
    res = temporal_filter(
        cur, jnp.full((H, W, 4), 0.9), g, g_far,
        jnp.zeros((H, W, 2)), jnp.full((H, W), 5, jnp.int32),
        depth_threshold=0.8, normal_threshold=0.9, history_base_length=24,
    )
    assert not bool(res.reprojected.any())
    # within threshold: accepted
    g_near = flat_gbuffer(depth=2.5)
    res2 = temporal_filter(
        cur, jnp.full((H, W, 4), 0.9), g, g_near,
        jnp.zeros((H, W, 2)), jnp.full((H, W), 5, jnp.int32),
        depth_threshold=0.8, normal_threshold=0.9, history_base_length=24,
    )
    assert bool(res2.reprojected.all())
    assert int(res2.history_len.max()) == 6


def test_temporal_motion_reprojection():
    # shift the scene 3 pixels right: motion = prev - cur = (-3, 0)
    g = flat_gbuffer()
    g = g._replace(motion=jnp.broadcast_to(jnp.asarray([-3.0, 0.0]), (H, W, 2)))
    prev_color = jnp.zeros((H, W, 4)).at[:, 10, :3].set(1.0)
    cur = jnp.zeros((H, W, 3))
    res = temporal_filter(
        cur, prev_color, g, flat_gbuffer(),
        jnp.zeros((H, W, 2)), jnp.full((H, W), 1, jnp.int32),
        depth_threshold=0.8, normal_threshold=0.9, history_base_length=24,
    )
    # pixel 13 samples prev pixel 10 (history 2 -> alpha 1/2 -> 0.5)
    np.testing.assert_allclose(res.color[:, 13, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(res.color[:, 10, 0], 0.0, atol=1e-6)


def test_filter_moments_passthrough_long_history():
    rng = np.random.default_rng(4)
    color = jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32)
    mom = jnp.asarray(rng.uniform(0, 1, (H, W, 2)), jnp.float32)
    out = filter_moments(
        color, mom, flat_gbuffer(), jnp.full((H, W), 8, jnp.int32), 10.0, 128.0
    )
    np.testing.assert_allclose(out, color, atol=1e-6)


def test_filter_moments_short_history_boost():
    # uniform scene, history 1 -> spatial variance with 4/h boost
    lum = 0.25
    color = jnp.concatenate([jnp.full((H, W, 3), lum), jnp.zeros((H, W, 1))], -1)
    # moments consistent with constant luminance => spatial variance 0
    l = 0.2126 * lum + 0.7152 * lum + 0.0722 * lum
    mom = jnp.broadcast_to(jnp.asarray([l, l * l]), (H, W, 2))
    out = filter_moments(
        color, mom, flat_gbuffer(), jnp.ones((H, W), jnp.int32), 10.0, 128.0
    )
    np.testing.assert_allclose(out[..., :3], lum, atol=1e-5)
    np.testing.assert_allclose(out[..., 3], 0.0, atol=1e-5)


def test_taa_constant_is_srgb_identity():
    c = 0.5
    filtered = jnp.concatenate([jnp.full((H, W, 3), c), jnp.ones((H, W, 1))], -1)
    out = taa(filtered, filtered)
    expect = float(to_srgb(jnp.asarray(c)))
    # the PAL-YUV encode/decode matrices are not exact inverses (~1e-3
    # roundtrip error — true of the reference as well, Filter.cuh:267-285)
    np.testing.assert_allclose(out[..., :3], expect, atol=2e-3)
    np.testing.assert_allclose(out[..., 3], 1.0, atol=1e-6)


def test_gradients_flow_through_filters():
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.uniform(0.1, 0.9, (H, W, 4)), jnp.float32)
    g = flat_gbuffer()

    def loss(x):
        out, _ = atrous_chain(x, g, steps=wavelet_steps(2), phi_colour=10.0,
                              phi_normal=128.0)
        # local window keeps the loss magnitude small so fp32 finite
        # differences below stay above rounding noise
        return jnp.sum(out[2:12, 2:12, :3] ** 2)

    grad = jax.grad(loss)(img)
    assert bool(jnp.all(jnp.isfinite(grad)))
    assert float(jnp.abs(grad[..., :3]).max()) > 0.0

    # finite-difference check on one pixel
    eps = 1e-2
    d = jnp.zeros_like(img).at[5, 7, 1].set(eps)
    fd = (loss(img + d) - loss(img - d)) / (2 * eps)
    np.testing.assert_allclose(fd, grad[5, 7, 1], rtol=3e-2, atol=1e-3)
