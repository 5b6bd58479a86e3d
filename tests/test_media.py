"""Participating media (reference Common.cuh:977-1013, 1141-1187;
PathTrace.cuh:187-202, 295-335) and opacity pass-through (:219-226):
unit tests for the transmittance/phase estimators plus analytic
integration tests through the wavefront tracer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax.core.camera import Camera, look_at_frame
from svgf_jax.core.scene import Instance, Material, MaterialType, Scene, Shape
from svgf_jax.ops import media as M
from svgf_jax.render.pathtrace import pathtrace

DENSITY = jnp.array([0.5, 1.0, 2.0])


def test_transmittance_pdf_normalizes():
    """Interior pdf mass + surface (survival) point mass must be 1."""
    K = 20000
    maxd = 3.0
    xs = jnp.linspace(0.0, maxd, K, endpoint=False) + maxd / (2 * K)
    d = jnp.tile(DENSITY[None, :], (K, 1))
    pdf = M.sample_transmittance_pdf(d, xs, jnp.full((K,), maxd))
    mass_in = float(jnp.sum(pdf)) * (maxd / K)
    mass_out = float(
        M.sample_transmittance_pdf(DENSITY[None], jnp.array([maxd]), jnp.array([maxd]))[0]
    )
    assert abs(mass_in + mass_out - 1.0) < 1e-3


def test_sample_transmittance_survival_fraction():
    """P(sampled distance reaches the surface) == mean_c exp(-d_c * L)."""
    R, maxd = 200_000, 3.0
    k1, k2 = jax.random.split(jax.random.key(1))
    dist = M.sample_transmittance(
        jnp.tile(DENSITY[None], (R, 1)),
        jnp.full((R,), maxd),
        jax.random.uniform(k1, (R,)),
        jax.random.uniform(k2, (R,)),
    )
    frac = float(jnp.mean(dist >= maxd - 1e-6))
    expect = float(jnp.mean(jnp.exp(-DENSITY * maxd)))
    assert abs(frac - expect) < 0.01


@pytest.mark.parametrize("g", [0.0, 0.6, -0.4])
def test_phase_sampler_mean_cosine(g):
    """HG's mean scattering cosine is exactly g (Common.cuh:1145-1163)."""
    R = 200_000
    outgoing = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (R, 1))
    ruv = jax.random.uniform(jax.random.key(2), (R, 2))
    dirs = M.sample_phase(
        jnp.ones((R, 3)), jnp.full((R,), g), outgoing, ruv
    )
    # cos(theta) is measured against the continuation direction -outgoing
    mean_cos = float(jnp.mean(jnp.sum(dirs * (-outgoing), axis=-1)))
    assert abs(mean_cos - g) < 0.02


def test_eval_phase_over_pdf_is_scattering_times_density():
    """EvalPhase / SamplePhasePDF == ScatteringColour * Density — the quirked
    exponent (PARITY.md) cancels in the ratio."""
    R = 64
    k = jax.random.key(3)
    outgoing = jax.random.normal(k, (R, 3))
    outgoing = outgoing / jnp.linalg.norm(outgoing, axis=-1, keepdims=True)
    incoming = jax.random.normal(jax.random.fold_in(k, 1), (R, 3))
    incoming = incoming / jnp.linalg.norm(incoming, axis=-1, keepdims=True)
    scat = jnp.tile(jnp.array([[0.2, 0.5, 0.9]]), (R, 1))
    dens = jnp.tile(DENSITY[None], (R, 1))
    g = jnp.full((R,), 0.3)
    ratio = M.eval_phase(scat, dens, g, outgoing, incoming) / M.sample_phase_pdf(
        dens, g, outgoing, incoming
    )[..., None]
    np.testing.assert_allclose(np.asarray(ratio), np.asarray(scat * dens), rtol=1e-5)


def _quad_z(z, half, flip=False):
    """Quad in the z=z plane, CCW from +z (normal +z) unless flipped."""
    p = np.array(
        [[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    if flip:
        idx = idx[:, ::-1].copy()
    return p, idx


def _straight_rays(R, z0=3.0):
    ro = jnp.tile(jnp.array([[0.0, 0.0, z0]]), (R, 1))
    rd = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (R, 1))
    return ro, rd


def test_absorbing_slab_beer_lambert():
    """Rays crossing a 1-unit absorbing VOLUMETRIC slab toward an emitter
    must attenuate by exp(-density * L) = colour^L per channel (density is
    -log(colour)/transmission_depth, Common.cuh:1466-1470)."""
    colour = np.array([0.5, 0.6, 0.7], np.float32)
    emission = np.array([4.0, 4.0, 4.0], np.float32)
    scene = Scene()
    fp, fi = _quad_z(0.5, 4.0)
    bp, bi = _quad_z(-0.5, 4.0)
    lp, li = _quad_z(-2.0, 4.0)
    scene.shapes += [
        Shape(positions=fp, indices=fi, name="front"),
        Shape(positions=bp, indices=bi, name="back"),
        Shape(positions=lp, indices=li, name="light"),
    ]
    scene.materials += [
        Material(
            colour=tuple(colour), material_type=MaterialType.VOLUMETRIC,
            transmission_depth=1.0,  # scattering_colour=0 -> pure absorption
        ),
        Material(colour=(0.0, 0.0, 0.0), emission=tuple(emission)),
    ]
    scene.instances += [
        Instance(shape=0, material=0, name="front"),
        Instance(shape=1, material=0, name="back"),
        Instance(shape=2, material=1, name="light"),
    ]
    scene.cameras.append(Camera(frame=look_at_frame([0, 0, 3], [0, 0, 0])))
    arrays = scene.flatten()
    assert arrays.meta.has_media

    R = 8192
    ro, rd = _straight_rays(R)
    rad, _, _ = jax.jit(
        lambda ro, rd: pathtrace(arrays, ro, rd, jax.random.key(7), bounces=4, clamp=100.0)
    )(ro, rd)
    mean = np.asarray(jnp.mean(rad, axis=0))
    expect = emission * np.exp(-(-np.log(colour)) * 1.0)  # = emission * colour
    np.testing.assert_allclose(mean, expect, rtol=0.06)


def test_scattering_slab_adds_inscatter_and_stays_finite():
    """With a non-zero scattering colour, in-volume scatter events engage the
    phase/light mixture estimator (PathTrace.cuh:308-335); radiance must be
    finite, non-negative, and above the pure-absorption level."""
    scene = Scene()
    fp, fi = _quad_z(0.5, 4.0)
    bp, bi = _quad_z(-0.5, 4.0)
    lp, li = _quad_z(-2.0, 4.0)
    scene.shapes += [
        Shape(positions=fp, indices=fi, name="front"),
        Shape(positions=bp, indices=bi, name="back"),
        Shape(positions=lp, indices=li, name="light"),
    ]

    def mk(scatter):
        return Material(
            colour=(0.3, 0.3, 0.3), material_type=MaterialType.VOLUMETRIC,
            transmission_depth=1.0, scattering_colour=scatter, anisotropy=0.4,
        )

    scene.materials += [mk((0.8, 0.8, 0.8)), Material(emission=(4.0, 4.0, 4.0))]
    scene.instances += [
        Instance(shape=0, material=0, name="front"),
        Instance(shape=1, material=0, name="back"),
        Instance(shape=2, material=1, name="light"),
    ]
    scene.cameras.append(Camera(frame=look_at_frame([0, 0, 3], [0, 0, 0])))
    arrays = scene.flatten()

    R = 8192
    ro, rd = _straight_rays(R)
    rad, _, _ = jax.jit(
        lambda ro, rd: pathtrace(arrays, ro, rd, jax.random.key(9), bounces=6, clamp=100.0)
    )(ro, rd)
    rad = np.asarray(rad)
    assert np.isfinite(rad).all()
    assert (rad >= 0).all()
    absorption_only = 4.0 * 0.3  # emission * colour^L
    assert float(rad.mean()) > absorption_only


def test_opacity_passthrough_expectation():
    """A plane with opacity o in front of an emitter transmits (1-o) of it
    in expectation (PathTrace.cuh:219-226: pass when rand >= opacity)."""
    opacity = 0.25
    scene = Scene()
    pp, pi = _quad_z(0.0, 4.0)
    lp, li = _quad_z(-2.0, 4.0)
    scene.shapes += [
        Shape(positions=pp, indices=pi, name="plane"),
        Shape(positions=lp, indices=li, name="light"),
    ]
    scene.materials += [
        Material(colour=(0.0, 0.0, 0.0), opacity=opacity),
        Material(emission=(4.0, 4.0, 4.0)),
    ]
    scene.instances += [
        Instance(shape=0, material=0, name="plane"),
        Instance(shape=1, material=1, name="light"),
    ]
    scene.cameras.append(Camera(frame=look_at_frame([0, 0, 3], [0, 0, 0])))
    arrays = scene.flatten()
    assert arrays.meta.has_opacity

    R = 16384
    ro, rd = _straight_rays(R)
    rad, _, _ = jax.jit(
        lambda ro, rd: pathtrace(arrays, ro, rd, jax.random.key(11), bounces=3, clamp=100.0)
    )(ro, rd)
    mean = float(jnp.mean(rad))
    assert abs(mean - 4.0 * (1.0 - opacity)) < 0.12


def test_media_gradients_finite():
    """Gradients w.r.t. the medium colour (which drives density) must be
    finite through transmittance sampling and the volume-stack wheres."""
    scene = Scene()
    fp, fi = _quad_z(0.5, 4.0)
    bp, bi = _quad_z(-0.5, 4.0)
    lp, li = _quad_z(-2.0, 4.0)
    scene.shapes += [
        Shape(positions=fp, indices=fi, name="front"),
        Shape(positions=bp, indices=bi, name="back"),
        Shape(positions=lp, indices=li, name="light"),
    ]
    scene.materials += [
        Material(
            colour=(0.5, 0.6, 0.7), material_type=MaterialType.VOLUMETRIC,
            transmission_depth=1.0, scattering_colour=(0.5, 0.5, 0.5),
        ),
        Material(emission=(4.0, 4.0, 4.0)),
    ]
    scene.instances += [
        Instance(shape=0, material=0, name="front"),
        Instance(shape=1, material=0, name="back"),
        Instance(shape=2, material=1, name="light"),
    ]
    scene.cameras.append(Camera(frame=look_at_frame([0, 0, 3], [0, 0, 0])))
    arrays = scene.flatten()

    import dataclasses

    R = 512
    ro, rd = _straight_rays(R)

    def loss(mat_colour):
        sc = dataclasses.replace(arrays, mat_colour=mat_colour)
        rad, _, _ = pathtrace(sc, ro, rd, jax.random.key(13), bounces=4, clamp=100.0)
        return jnp.mean(rad)

    g = jax.jit(jax.grad(loss))(arrays.mat_colour)
    assert bool(jnp.all(jnp.isfinite(g)))
