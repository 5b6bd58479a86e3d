"""Light sampling + environment evaluation (reference Common.cuh:348-459,
635-715, 1493-1517).

The reference loops over lights per-thread at runtime; here the (static)
light list is unrolled at trace time — each light contributes one masked
vectorized block, and instance lights re-trace against their own BVH only
(intersect_scene(only_instance=...), exactly like the reference's
IntersectInstance in SampleLightsPDF).
"""

from __future__ import annotations

import jax.numpy as jnp

from svgf_jax.ops.geometry import (
    MAX_LENGTH,
    PI,
    dot,
    normalize,
    transform_direction,
    transform_point,
)
from svgf_jax.ops.intersect import intersect_scene
from svgf_jax.ops.sampling import (
    sample_discrete,
    sample_discrete_pdf,
    sample_sphere,
    sample_triangle_uv,
    sample_uniform_index,
)


def _interp(tri_attr, prim, u, v):
    """Barycentric interpolation: a1*u + a2*v + a0*(1-u-v)."""
    a = tri_attr[prim]  # (R, 3, C)
    w0 = (1.0 - u - v)[..., None]
    return a[:, 1] * u[..., None] + a[:, 2] * v[..., None] + a[:, 0] * w0


def eval_environment(scene, direction):
    """Sum of all environments' equirect emission along `direction`
    (Common.cuh:1493-1517). Nearest-texel lookup, no sRGB (Linear=false)."""
    R = direction.shape[0]
    total = jnp.zeros((R, 3), jnp.float32)
    for e in range(scene.meta.n_envs):
        wd = transform_direction(scene.env_inv_transform[e], direction)
        tex_id = scene.meta.env_tex[e]
        if tex_id >= 0:
            tx = jnp.arctan2(wd[..., 0], wd[..., 2]) / (2.0 * PI)
            tx = jnp.where(tx < 0, tx + 1.0, tx)
            ty = jnp.arccos(jnp.clip(wd[..., 1], -1.0, 1.0)) / PI
            h, w = scene.env_textures.shape[1:3]
            px = jnp.clip((tx * w).astype(jnp.int32), 0, w - 1)
            py = jnp.clip((ty * h).astype(jnp.int32), 0, h - 1)
            col = scene.env_textures[tex_id][py, px]
        else:
            col = jnp.ones((R, 3), jnp.float32)
        total = total + scene.env_emission[e] * col
    return total


def sample_lights(scene, position, rand_l, rand_el, rand_uv):
    """SampleLights (Common.cuh:413-459): direction toward a sampled light.

    Returns (direction, zero_mask) — direction is vec3(0) when no light
    could be sampled (the caller breaks the path, PathTrace.cuh:241).
    """
    R = position.shape[0]
    meta = scene.meta
    if meta.n_lights == 0:
        return jnp.zeros((R, 3), jnp.float32)
    lid = sample_uniform_index(meta.n_lights, rand_l)
    out = jnp.zeros((R, 3), jnp.float32)
    for l in range(meta.n_lights):
        mask = lid == l
        if meta.light_instance[l] >= 0:
            inst = meta.light_instance[l]
            elem = sample_discrete(
                scene.lights_cdf, meta.light_cdf_start[l], meta.light_cdf_count[l], rand_el
            )
            uv = sample_triangle_uv(rand_uv) if meta.light_cdf_count[l] > 0 else rand_uv
            prim = meta.light_tri_start[l] + elem
            lp = _interp(scene.tri_pos, prim, uv[..., 0], uv[..., 1])
            lp = transform_point(scene.inst_transform[inst], lp)
            d = normalize(lp - position)
        else:
            env = meta.light_env[l]
            tex_id = meta.env_tex[env]
            if tex_id >= 0:
                h, w = scene.env_textures.shape[1:3]
                s = sample_discrete(
                    scene.lights_cdf, meta.light_cdf_start[l], meta.light_cdf_count[l], rand_el
                )
                u = ((s % w).astype(jnp.float32) + 0.5) / w
                v = ((s // w).astype(jnp.float32) + 0.5) / h
                local = jnp.stack(
                    [
                        jnp.cos(u * 2.0 * PI) * jnp.sin(v * PI),
                        jnp.cos(v * PI),
                        jnp.sin(u * 2.0 * PI) * jnp.sin(v * PI),
                    ],
                    axis=-1,
                )
                d = transform_direction(scene.env_transform[env], local)
            else:
                d = sample_sphere(rand_uv)
        out = jnp.where(mask[..., None], d, out)
    return out


def _instance_light_pdf(scene, l, inst, position, direction, ok, prim, u, v):
    """Solid-angle pdf term of instance light `l` given a hit on it at
    (prim, u, v) along `direction` from `position` (Common.cuh:666-692)."""
    prim = jnp.clip(prim, 0, scene.tri_pos.shape[0] - 1)
    lp = _interp(scene.tri_pos, prim, u, v)
    lp = transform_point(scene.inst_transform[inst], lp)
    ln = _interp(scene.tri_nrm, prim, u, v)
    # NOTE: the reference transforms the light normal by Transform,
    # not NormalTransform (Common.cuh:675) — reproduced.
    ln = transform_direction(scene.inst_transform[inst], ln)
    area = scene.light_area[l]
    d2 = jnp.sum((lp - position) ** 2, axis=-1)
    # Double-where: mask BOTH operands of the division so the untaken
    # branch never divides by the 1e-18 floor (0*inf NaN in backward).
    denom = jnp.abs(dot(ln, direction)) * area + 1e-18
    return jnp.where(ok, d2, 0.0) / jnp.where(ok, denom, 1.0)


def _env_light_pdf(scene, l, position, direction):
    """Environment light pdf term (Common.cuh:694-713). No tracing needed."""
    meta = scene.meta
    env = meta.light_env[l]
    tex_id = meta.env_tex[env]
    if tex_id >= 0:
        wd = transform_direction(scene.env_inv_transform[env], direction)
        tx = jnp.arctan2(wd[..., 2], wd[..., 0]) / (2.0 * PI)
        tx = jnp.where(tx < 0, tx + 1.0, tx)
        ty = jnp.arccos(jnp.clip(wd[..., 1], -1.0, 1.0)) / PI
        h, w = scene.env_textures.shape[1:3]
        u = jnp.clip((tx * w).astype(jnp.int32), 0, w - 1)
        v = jnp.clip((ty * h).astype(jnp.int32), 0, h - 1)
        prob = sample_discrete_pdf(
            scene.lights_cdf,
            meta.light_cdf_start[l],
            meta.light_cdf_count[l],
            v * w + u,
        )
        angle = (2.0 * PI / w) * (PI / h) * jnp.sin(
            PI * (v.astype(jnp.float32) + 0.5) / h
        )
        return prob / jnp.maximum(angle, 1e-18)
    return jnp.full(position.shape[:-1], 1.0 / (4.0 * PI), jnp.float32)


def sample_lights_pdf_from_hit(scene, position, direction, hit):
    """Light-sampler pdf of `direction`, derived from an EXISTING full-scene
    hit along that ray instead of fresh per-light `only_instance` re-traces
    (the reference's SampleLightsPDF hot spot, Common.cuh:635-715 — flagged
    by its own comment; VERDICT r2 item 2).

    Semantics vs the re-tracing form (PARITY.md): an instance light
    contributes its term iff the ray's NEAREST scene hit lands on it. This
    is identical in every case where the term matters (the MIS contribution
    is nonzero only when the hit surface is emissive — i.e. IS the nearest
    hit), and differs only in the MIS weight when several lights overlap
    along one occluded ray. Environment terms are exact (no trace needed).
    """
    R = position.shape[0]
    meta = scene.meta
    pdf = jnp.zeros((R,), jnp.float32)
    for l in range(meta.n_lights):
        if meta.light_instance[l] >= 0:
            inst = meta.light_instance[l]
            ok = (hit.dist < MAX_LENGTH) & (hit.instance == inst)
            pdf = pdf + _instance_light_pdf(
                scene, l, inst, position, direction, ok, hit.prim, hit.u, hit.v
            )
        else:
            pdf = pdf + _env_light_pdf(scene, l, position, direction)
    if meta.n_lights > 0:
        pdf = pdf / meta.n_lights
    return pdf


def sample_lights_pdf(scene, position, direction):
    """SampleLightsPDF (Common.cuh:635-715): solid-angle pdf of sampling
    `direction` from `position` via the light sampler.

    Instance lights re-trace against ONLY that instance's BVH (one bounce —
    the reference's accumulation loop is capped at 1, Common.cuh:646)."""
    R = position.shape[0]
    meta = scene.meta
    pdf = jnp.zeros((R,), jnp.float32)
    for l in range(meta.n_lights):
        if meta.light_instance[l] >= 0:
            inst = meta.light_instance[l]
            hit = intersect_scene(scene, position, direction, only_instance=inst)
            ok = hit.dist < MAX_LENGTH
            pdf = pdf + _instance_light_pdf(
                scene, l, inst, position, direction, ok, hit.prim, hit.u, hit.v
            )
        else:
            pdf = pdf + _env_light_pdf(scene, l, position, direction)
    if meta.n_lights > 0:
        pdf = pdf / meta.n_lights
    return pdf
