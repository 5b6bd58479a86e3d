"""Camera-pose gradients (north star: gradients w.r.t. materials, lights,
CAMERA). Ray generation (render/gbuffer.py:27) is smooth in cam_frame;
discrete hit ids are treated as constants (SURVEY §7.1).

The finite-difference check masks out silhouette/occlusion edge pixels:
pathwise gradients deliberately exclude visibility-boundary terms (hit
selection is stop-grad — reparameterized edge sampling is out of scope,
PARITY.md), so FD and analytic gradients only agree where the integrand is
locally smooth. On the interior mask they agree to ~1%."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.render.gbuffer import raster_gbuffer
from svgf_jax.render.pipeline import render_frame
from svgf_jax.render.types import TemporalState
from svgf_jax.scenes.cornell import cornell_box

W, H = 40, 32


def make_setup():
    config = RenderConfig(
        width=W, height=H, state_dtype="float32",
        tracing=TracingConfig(bounces=1),
        svgf=SVGFConfig(spatial_filter_steps=1),
    )
    scene = cornell_box()
    scene.cameras[0].aspect = W / H
    return config, scene.flatten()


def interior_mask(arrays, h, w):
    """Pixels >= 2px away from instance-id or depth edges at the base camera."""
    g0 = raster_gbuffer(arrays, 0, h, w)
    inst = np.asarray(g0.instance)
    depth = np.asarray(g0.depth)
    edge = np.zeros((h, w), bool)
    edge[:, 1:] |= inst[:, 1:] != inst[:, :-1]
    edge[:, :-1] |= inst[:, 1:] != inst[:, :-1]
    edge[1:, :] |= inst[1:, :] != inst[:-1, :]
    edge[:-1, :] |= inst[1:, :] != inst[:-1, :]
    edge[:, 1:] |= np.abs(depth[:, 1:] - depth[:, :-1]) > 0.1
    edge[1:, :] |= np.abs(depth[1:, :] - depth[:-1, :]) > 0.1
    for _ in range(2):
        e2 = edge.copy()
        e2[1:, :] |= edge[:-1, :]; e2[:-1, :] |= edge[1:, :]
        e2[:, 1:] |= edge[:, :-1]; e2[:, :-1] |= edge[:, 1:]
        edge = e2
    return jnp.asarray(~edge, jnp.float32)[..., None]


def test_camera_gradient_finite_and_nonzero():
    """Full 2-frame (temporal path on) pipeline: grads finite and useful."""
    config, arrays = make_setup()
    target = jnp.zeros((H, W, 3), jnp.float32)

    def loss(cam_frame):
        sc = dataclasses.replace(arrays, cam_frame=cam_frame)
        state = TemporalState.initial(config.height, config.width, jnp.float32)
        out1, state = render_frame(sc, state, config)       # frame 0
        out2, _ = render_frame(sc, state, config)           # frame 1 (temporal on)
        return jnp.mean((out2.final - target) ** 2)

    g = np.asarray(jax.jit(jax.grad(loss))(arrays.cam_frame))
    assert np.isfinite(g).all(), "non-finite camera gradient"
    assert np.abs(g).max() > 0, "camera gradient is identically zero"


def test_camera_gradient_finite_difference():
    """FD == analytic on the interior (edge-masked) pixels, full pipeline."""
    config, arrays = make_setup()
    mask = interior_mask(arrays, H, W)
    assert float(mask.sum()) > 30
    target = jnp.zeros((H, W, 3), jnp.float32)

    def loss(cam_frame):
        sc = dataclasses.replace(arrays, cam_frame=cam_frame)
        state = TemporalState.initial(config.height, config.width, jnp.float32)
        out, _ = render_frame(sc, state, config)
        return jnp.sum(mask * (out.final - target) ** 2) / jnp.sum(mask)

    g = np.asarray(jax.jit(jax.grad(loss))(arrays.cam_frame))
    assert np.isfinite(g).all()
    jloss = jax.jit(loss)
    f = np.asarray(arrays.cam_frame)
    for comp in (0, 2):  # x and z translation
        eps = 1e-3
        fp = f.copy(); fp[0, comp, 3] += eps
        fm = f.copy(); fm[0, comp, 3] -= eps
        fd = (float(jloss(jnp.asarray(fp))) - float(jloss(jnp.asarray(fm)))) / (2 * eps)
        an = float(g[0, comp, 3])
        assert np.isfinite(fd)
        denom = max(abs(fd), abs(an), 1e-6)
        assert abs(fd - an) / denom < 0.15, (
            f"cam grad mismatch comp {comp}: fd={fd:.6g} analytic={an:.6g}"
        )
