"""Participating media: exponential transmittance sampling (Beer-Lambert)
and the Henyey-Greenstein phase function (reference Common.cuh:977-1013,
1141-1185).

Reference quirk reproduced deliberately (see PARITY.md): `EvalPhase` /
`SamplePhasePDF` compute `Denom = pow(1+g^2-2g cos, 1.5)` and then divide by
`Denom * sqrt(Denom)` (Common.cuh:1170-1173, 1183-1186) — an effective
exponent of 2.25 instead of Henyey-Greenstein's 1.5. Both functions share
the formula, so the `EvalPhase / SamplePhasePDF` ratio still reduces to
`ScatteringColour * Density` exactly; only the MIS mixture denominator
(0.5*phase + 0.5*light, PathTrace.cuh:328-331) sees the biased value.
`sample_phase` itself draws from the *true* HG inverse CDF
(Common.cuh:1145-1163), matching the reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from svgf_jax.ops.geometry import MAX_LENGTH, PI, basis_from_z, dot

_EPS = 1e-18


def sample_transmittance(density, max_distance, rl, rd):
    """Distance to the next medium event (Common.cuh:978-991).

    Picks one of the 3 colour channels with `rl`, then inverts the
    exponential CDF with `rd`; clamped to the surface distance.
    density: (R,3); max_distance, rl, rd: (R,). Returns (R,).
    """
    channel = jnp.clip((rl * 3.0).astype(jnp.int32), 0, 2)
    d = jnp.take_along_axis(density, channel[..., None], axis=-1)[..., 0]
    dist = jnp.where(
        d == 0.0, MAX_LENGTH, -jnp.log1p(-rd) / jnp.maximum(d, _EPS)
    )
    return jnp.minimum(dist, max_distance)


def eval_transmittance(density, distance):
    """Beer-Lambert attenuation exp(-density*distance) (Common.cuh:993-997)."""
    return jnp.exp(-density * distance[..., None])


def sample_transmittance_pdf(density, distance, max_distance):
    """Channel-averaged exponential pdf (Common.cuh:999-1013): inside the
    medium mean(d*exp(-d*x)); at the surface the residual mass
    mean(exp(-d*max))."""
    pdf_in = jnp.mean(density * jnp.exp(-density * distance[..., None]), axis=-1)
    pdf_out = jnp.mean(jnp.exp(-density * max_distance[..., None]), axis=-1)
    return jnp.where(distance < max_distance, pdf_in, pdf_out)


def _phase_function(anisotropy, cosine):
    """The reference's (quirked, exponent-2.25) HG lobe shape
    (Common.cuh:1170-1173)."""
    x = 1.0 + anisotropy * anisotropy - 2.0 * anisotropy * cosine
    # floor 1e-4, not a tiny eps: the effective divisor is x^2.25 and its
    # backward squares it again — x below ~1e-4 (|g| -> 1 forward scatter)
    # would underflow fp32 to 0 and NaN the gradient. phase(1e-4) is already
    # astronomically peaked; the forward clamp is physically irrelevant.
    denom = jnp.maximum(x, 1e-4) ** 1.5
    return (1.0 - anisotropy * anisotropy) / (
        4.0 * PI * denom * jnp.sqrt(denom)
    )


def sample_phase(density, anisotropy, outgoing, ruv):
    """Draw a scatter direction from the true HG inverse CDF around
    -outgoing (Common.cuh:1145-1163). Returns 0 where density == 0."""
    g = anisotropy
    iso = jnp.abs(g) < 1e-3
    safe_g = jnp.where(iso, 1.0, g)  # keep the untaken branch finite
    square = (1.0 - g * g) / (1.0 + g - 2.0 * g * ruv[..., 1])
    cos_theta = jnp.where(
        iso,
        1.0 - 2.0 * ruv[..., 1],
        (1.0 + g * g - square * square) / (2.0 * safe_g),
    )
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * ruv[..., 0]
    local = jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )
    bx, by, bz = basis_from_z(-outgoing)
    direction = local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz
    zero = jnp.all(density == 0.0, axis=-1)
    return jnp.where(zero[..., None], 0.0, direction)


def eval_phase(scattering, density, anisotropy, outgoing, incoming):
    """ScatteringColour * Density * phase(cos) (Common.cuh:1165-1176)."""
    cosine = -dot(outgoing, incoming)
    pf = _phase_function(anisotropy, cosine)
    zero = jnp.all(density == 0.0, axis=-1)
    return jnp.where(zero[..., None], 0.0, scattering * density * pf[..., None])


def sample_phase_pdf(density, anisotropy, outgoing, incoming):
    """(Common.cuh:1178-1187)."""
    cosine = -dot(outgoing, incoming)
    pf = _phase_function(anisotropy, cosine)
    zero = jnp.all(density == 0.0, axis=-1)
    return jnp.where(zero, 0.0, pf)
