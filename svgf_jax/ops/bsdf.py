"""BSDF library — matte / PBR / glass / volumetric, sample/eval/pdf + delta
variants, vectorized over shading points (reference Common.cuh:720-1323).

Dispatch strategy: every lane evaluates every (cheap, elementwise) lobe of
the material types a scene uses, and the result is selected by
material-type masks — vectorized lockstep evaluation instead of the
reference's per-thread branch dispatch (Common.cuh:1197-1323).

All inputs are batched: normal/outgoing/incoming (R,3); material fields (R,)
or (R,3) gathered per-lane from the scene's material arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svgf_jax.ops.geometry import (
    PI,
    basis_from_z,
    dot,
    normalize,
    reflect,
    refract,
    safe_sqrt,
)
from svgf_jax.ops.sampling import (
    sample_hemisphere_cosine,
    sample_hemisphere_cosine_pdf,
)

MATTE, PBR, VOLUMETRIC, GLASS, SUBSURFACE = 0, 1, 2, 3, 4
MIN_ROUGHNESS = 0.03 * 0.03   # Common.cuh:24
IOR = 1.5                     # hard-coded in every dispatcher (Common.cuh:1205 etc.)


class MaterialPoint(NamedTuple):
    """EvalMaterial output (Common.cuh:1440-1479): per-lane shading params."""

    mtype: jax.Array        # (R,) i32
    colour: jax.Array       # (R,3)
    emission: jax.Array     # (R,3)
    roughness: jax.Array    # (R,) squared + MIN_ROUGHNESS-cut
    metallic: jax.Array     # (R,)
    opacity: jax.Array      # (R,)
    anisotropy: jax.Array   # (R,)
    scattering: jax.Array   # (R,3)
    density: jax.Array      # (R,3)


def eval_material_point(scene, mat_idx, tex_colour=None, tex_emission=None,
                        tex_roughness=None, tex_alpha=None) -> MaterialPoint:
    """Gather + derive shading params per lane (Common.cuh:1440-1479).

    Texture factors default to 1 — the reference's scene-texture fetch is
    stubbed to vec4(1) (Common.cuh:1386-1394, README "doesn't really work
    with textured meshes"); pass explicit factors to enable real textures
    (the tracer does when SceneMeta.textures_enabled). `tex_alpha` is the
    colour texture's alpha, folded into opacity (Common.cuh:1458).
    """
    m = jnp.clip(mat_idx, 0, scene.mat_type.shape[0] - 1)
    (colour, emission, rough, metal, opacity, aniso, scat, tdepth) = (
        t[m] for t in (
            scene.mat_colour, scene.mat_emission, scene.mat_roughness,
            scene.mat_metallic, scene.mat_opacity, scene.mat_anisotropy,
            scene.mat_scattering, scene.mat_transmission_depth,
        )
    )
    if tex_colour is not None:
        colour = colour * tex_colour
    if tex_emission is not None:
        emission = emission * tex_emission
    if tex_roughness is not None:
        rough = rough * tex_roughness[..., 1]
        metal = metal * tex_roughness[..., 2]
    if tex_alpha is not None:
        opacity = opacity * tex_alpha
    rough = rough * rough
    mtype = scene.mat_type[m]
    rough = jnp.where(mtype == VOLUMETRIC, 0.0, rough)
    rough = jnp.where(rough < MIN_ROUGHNESS, 0.0, rough)
    density = -jnp.log(jnp.clip(colour, 1e-4, 1.0)) / jnp.maximum(tdepth, 1e-9)[..., None]
    has_density = (mtype == VOLUMETRIC) | (mtype == GLASS) | (mtype == SUBSURFACE)
    density = jnp.where(has_density[..., None], density, 0.0)
    return MaterialPoint(
        mtype=mtype,
        colour=colour,
        emission=emission,
        roughness=rough,
        metallic=metal,
        opacity=opacity,
        anisotropy=aniso,
        scattering=scat,
        density=density,
    )


def is_delta(mp: MaterialPoint):
    """(Common.cuh:1189-1195)."""
    r0 = mp.roughness == 0.0
    return ((mp.mtype == PBR) & r0) | ((mp.mtype == GLASS) & r0) | (mp.mtype == VOLUMETRIC)


def is_volumetric(mp: MaterialPoint):
    """(Common.cuh:1485-1491)."""
    return (mp.mtype == VOLUMETRIC) | (mp.mtype == GLASS) | (mp.mtype == SUBSURFACE)


def eval_emission(mp: MaterialPoint, normal, outgoing):
    """(Common.cuh:1481-1483)."""
    return jnp.where((dot(normal, outgoing) >= 0)[..., None], mp.emission, 0.0)


# ---------------------------------------------------------------------------
# microfacet helpers (Common.cuh:741-834)
# ---------------------------------------------------------------------------


def eta_to_reflectivity(eta):
    return ((eta - 1.0) ** 2) / ((eta + 1.0) ** 2)


def fresnel_schlick(specular, normal, outgoing):
    cosine = dot(normal, outgoing)
    f = specular + (1.0 - specular) * jnp.clip(1.0 - jnp.abs(cosine), 0.0, 1.0)[..., None] ** 5
    zero = jnp.all(specular == 0.0, axis=-1, keepdims=True)
    return jnp.where(zero, 0.0, f)


def fresnel_dielectric(eta, normal, outgoing):
    """(Common.cuh:753-773)."""
    cosw = jnp.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / eta2
    tir = cos2t < 0.0
    t0 = safe_sqrt(cos2t)  # clamped derivative: TIR lanes otherwise NaN grads
    t1 = eta * t0
    t2 = eta * cosw
    rs = (cosw - t1) / (cosw + t1 + 1e-18)
    rp = (t0 - t2) / (t0 + t2 + 1e-18)
    return jnp.where(tir, 1.0, (rs * rs + rp * rp) / 2.0)


def sample_microfacet(roughness, normal, rn):
    """GGX-style half-vector sampling (Common.cuh:776-794)."""
    phi = 2.0 * PI * rn[..., 0]
    theta = jnp.arctan(roughness * jnp.sqrt(rn[..., 1] / jnp.maximum(1.0 - rn[..., 1], 1e-9)))
    st = jnp.sin(theta)
    ct = jnp.cos(theta)
    local = jnp.stack([jnp.cos(phi) * st, jnp.sin(phi) * st, ct], axis=-1)
    bx, by, bz = basis_from_z(normal)
    return normalize(local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz)


def microfacet_distribution(roughness, normal, halfway):
    """(Common.cuh:797-805)."""
    cosine = dot(normal, halfway)
    c2 = cosine * cosine
    r2 = roughness * roughness
    d = c2 * r2 + 1.0 - c2
    return jnp.where(cosine <= 0, 0.0, r2 / (PI * d * d + 1e-18))


def _shadowing1(roughness, normal, halfway, direction):
    cosine = dot(normal, direction)
    c2 = cosine * cosine
    cosh = dot(halfway, direction)
    r2 = roughness * roughness
    # safe_sqrt: the argument is exactly 0 for r2 == 0, c2 == 0 lanes
    # (matte lanes share this code path via the masked dispatch) and plain
    # sqrt's derivative there is inf -> 0*inf NaN at the mask.
    g = 2.0 / (safe_sqrt(((r2 * (1.0 - c2)) + c2) / jnp.maximum(c2, 1e-18)) + 1.0)
    return jnp.where(cosine * cosh <= 0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return _shadowing1(roughness, normal, halfway, outgoing) * _shadowing1(
        roughness, normal, halfway, incoming
    )


def sample_microfacet_pdf(roughness, normal, halfway):
    cosine = dot(normal, halfway)
    return jnp.where(
        cosine < 0, 0.0, microfacet_distribution(roughness, normal, halfway) * cosine
    )


def _up_normal(normal, outgoing):
    return jnp.where((dot(normal, outgoing) <= 0)[..., None], -normal, normal)


def _same_hemisphere(normal, outgoing, incoming):
    return dot(normal, outgoing) * dot(normal, incoming) >= 0


# ---------------------------------------------------------------------------
# matte (Common.cuh:919-942)
# ---------------------------------------------------------------------------


def eval_matte(colour, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    val = colour / PI * jnp.abs(dot(normal, incoming))[..., None]
    return jnp.where(ok[..., None], val, 0.0)


def sample_matte(normal, outgoing, rn):
    return sample_hemisphere_cosine(_up_normal(normal, outgoing), rn)


def sample_matte_pdf(normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    return jnp.where(
        ok, sample_hemisphere_cosine_pdf(_up_normal(normal, outgoing), incoming), 0.0
    )


# ---------------------------------------------------------------------------
# PBR metallic-roughness (Common.cuh:839-916)
# ---------------------------------------------------------------------------


def _reflectivity(colour, metallic):
    base = eta_to_reflectivity(jnp.full_like(colour, IOR))
    return base + (colour - base) * metallic[..., None]


def eval_pbr(colour, roughness, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f1 = fresnel_schlick(refl, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_schlick(refl, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cosine = jnp.abs(dot(up, incoming))
    # NOTE: the reference multiplies Diffuse by the cosine TWICE
    # (Common.cuh:876-880) — reproduced deliberately.
    diffuse = colour * (1.0 - metallic[..., None]) * (1.0 - f1) / PI * cosine[..., None]
    denom = 4.0 * dot(up, outgoing) * dot(up, incoming)
    # double-where: degenerate (grazing) lanes never divide by the floor
    bad = jnp.abs(denom) < 1e-18
    specular = f * (jnp.where(bad, 0.0, d * g) / jnp.where(bad, 1.0, denom))[..., None]
    return jnp.where(ok[..., None], (diffuse + specular) * cosine[..., None], 0.0)


def sample_pbr(colour, roughness, metallic, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f_mean = jnp.mean(fresnel_schlick(refl, up, outgoing), axis=-1)
    halfway = sample_microfacet(roughness, up, rn)
    spec_in = reflect(-outgoing, halfway)
    spec_ok = _same_hemisphere(up, outgoing, spec_in)
    diff_in = sample_hemisphere_cosine(up, rn)
    use_spec = rnl < f_mean
    incoming = jnp.where(use_spec[..., None], spec_in, diff_in)
    bad = use_spec & ~spec_ok
    return jnp.where(bad[..., None], 0.0, incoming)


def sample_pbr_pdf(colour, roughness, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    refl = _reflectivity(colour, metallic)
    f = jnp.mean(fresnel_schlick(refl, up, outgoing), axis=-1)
    pdf = f * sample_microfacet_pdf(roughness, up, halfway) / (
        4.0 * jnp.maximum(jnp.abs(dot(outgoing, halfway)), 1e-18)
    ) + (1.0 - f) * sample_hemisphere_cosine_pdf(up, incoming)
    return jnp.where(ok, pdf, 0.0)


# delta (mirror) PBR (Common.cuh:854-861, 883-895, 908-916)


def eval_pbr_delta(colour, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f = fresnel_schlick(refl, up, incoming)
    cosine = jnp.abs(dot(up, incoming))
    denom = 4.0 * dot(up, outgoing) * dot(up, incoming)
    bad = jnp.abs(denom) < 1e-18
    val = jnp.where(bad[..., None], 0.0, f) / jnp.where(bad, 1.0, denom)[
        ..., None
    ] * cosine[..., None]
    return jnp.where(ok[..., None], val, 0.0)


def sample_pbr_delta(normal, outgoing):
    up = _up_normal(normal, outgoing)
    incoming = reflect(-outgoing, up)
    ok = _same_hemisphere(up, outgoing, incoming)
    return jnp.where(ok[..., None], incoming, 0.0)


def sample_pbr_delta_pdf(colour, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    refl = _reflectivity(colour, metallic)
    f = jnp.mean(fresnel_schlick(refl, up, outgoing), axis=-1)
    return jnp.where(ok, f / (4.0 * jnp.maximum(jnp.abs(dot(outgoing, halfway)), 1e-18)), 0.0)


# ---------------------------------------------------------------------------
# glass, rough + delta (Common.cuh:1016-1139)
# ---------------------------------------------------------------------------


def eval_glass(roughness, normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    rel_ior = jnp.where(entering, IOR, 1.0 / IOR)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0

    # reflection branch
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(rel_ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    denom_r = jnp.abs(4.0 * dot(normal, outgoing) * dot(normal, incoming))
    bad_r = denom_r < 1e-18
    refl = jnp.where(bad_r, 0.0, f_r * d_r * g_r) / jnp.where(
        bad_r, 1.0, denom_r
    ) * jnp.abs(dot(normal, incoming))

    # transmission branch
    h_t = -normalize(rel_ior[..., None] * incoming + outgoing) * jnp.where(
        entering, 1.0, -1.0
    )[..., None]
    f_t = fresnel_dielectric(rel_ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, incoming)
    num = jnp.abs(dot(outgoing, h_t) * dot(incoming, h_t))
    den = jnp.abs(dot(outgoing, normal) * dot(incoming, normal))
    den2 = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    bad_t = (den < 1e-18) | (den2 < 1e-18)
    trans = (
        jnp.where(bad_t, 0.0, num) / jnp.where(bad_t, 1.0, den)
        * (1.0 - f_t) * d_t * g_t
        / jnp.where(bad_t, 1.0, den2 + 1e-18)
        * jnp.abs(dot(normal, incoming))
    )

    val = jnp.where(same, refl, trans)
    return jnp.repeat(val[..., None], 3, axis=-1)


def sample_glass(roughness, normal, outgoing, rnl, rn):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    halfway = sample_microfacet(roughness, up, rn)
    f = fresnel_dielectric(jnp.where(entering, IOR, 1.0 / IOR), halfway, outgoing)
    refl_in = reflect(-outgoing, halfway)
    refl_ok = _same_hemisphere(up, outgoing, refl_in)
    refr_in = refract(-outgoing, halfway, jnp.where(entering, 1.0 / IOR, IOR))
    refr_ok = ~_same_hemisphere(up, outgoing, refr_in)
    use_refl = rnl < f
    incoming = jnp.where(use_refl[..., None], refl_in, refr_in)
    ok = jnp.where(use_refl, refl_ok, refr_ok)
    return jnp.where(ok[..., None], incoming, 0.0)


def sample_glass_pdf(roughness, normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    rel_ior = jnp.where(entering, IOR, 1.0 / IOR)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0

    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(rel_ior, h_r, outgoing) * sample_microfacet_pdf(
        roughness, up, h_r
    ) / (4.0 * jnp.maximum(jnp.abs(dot(outgoing, h_r)), 1e-18))

    h_t = -normalize(rel_ior[..., None] * incoming + outgoing) * jnp.where(
        entering, 1.0, -1.0
    )[..., None]
    den2 = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    bad2 = den2 < 1e-18
    pdf_t = (
        jnp.where(
            bad2,
            0.0,
            (1.0 - fresnel_dielectric(rel_ior, h_t, outgoing))
            * sample_microfacet_pdf(roughness, up, h_t)
            * jnp.abs(dot(h_t, incoming)),
        )
        / jnp.where(bad2, 1.0, den2 + 1e-18)
    )
    return jnp.where(same, pdf_r, pdf_t)


def eval_glass_delta(normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    rel_ior = jnp.where(entering, IOR, 1.0 / IOR)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0
    val = jnp.where(same, f, (1.0 / (rel_ior * rel_ior)) * (1.0 - f))
    return jnp.repeat(val[..., None], 3, axis=-1)


def sample_glass_delta(normal, outgoing, rnl):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    rel_ior = jnp.where(entering, IOR, 1.0 / IOR)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    refl = reflect(-outgoing, up)
    refr = refract(-outgoing, up, 1.0 / rel_ior)
    return jnp.where((rnl < f)[..., None], refl, refr)


def sample_glass_delta_pdf(normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0
    up = jnp.where(entering[..., None], normal, -normal)
    rel_ior = jnp.where(entering, IOR, 1.0 / IOR)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0
    return jnp.where(same, f, 1.0 - f)


# ---------------------------------------------------------------------------
# volumetric boundary pass-through (Common.cuh:946-975)
# ---------------------------------------------------------------------------


def eval_volumetric(normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0
    return jnp.where(opposite[..., None], 1.0, 0.0) * jnp.ones_like(normal)


def sample_volumetric(outgoing):
    return -outgoing


def sample_volumetric_pdf(normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0
    return jnp.where(opposite, 1.0, 0.0)


# ---------------------------------------------------------------------------
# dispatchers (Common.cuh:1197-1323)
# ---------------------------------------------------------------------------


ALL_TYPES = (MATTE, PBR, VOLUMETRIC, GLASS, SUBSURFACE)


def _sel_used(mtype, lobes, used, zero, vec: bool):
    """Select per material type, evaluating ONLY the lobes whose types occur
    in the (static) scene — an all-matte scene compiles none of the
    microfacet/glass machinery, matching the per-thread switch's zero cost
    for untaken cases (Common.cuh:1197-1267). `lobes` maps type -> thunk;
    SUBSURFACE shares the GLASS lobes."""
    used = set(used)
    if SUBSURFACE in used:
        used.add(GLASS)
        used.discard(SUBSURFACE)
    keys = [t for t in (MATTE, PBR, VOLUMETRIC, GLASS) if t in used]
    if not keys:
        keys = [MATTE]
    out = None
    for t in keys:
        val = lobes[t]()
        if out is None:
            if len(keys) == 1:
                return val
            out = val
            continue
        m = mtype == t
        if t == GLASS:
            m = m | (mtype == SUBSURFACE)
        out = jnp.where(m[..., None] if vec else m, val, out)
    return out


def eval_bsdf_cos(mp: MaterialPoint, normal, outgoing, incoming,
                  types_used=ALL_TYPES):
    return _sel_used(
        mp.mtype,
        {
            MATTE: lambda: eval_matte(mp.colour, normal, outgoing, incoming),
            PBR: lambda: eval_pbr(mp.colour, mp.roughness, mp.metallic, normal,
                                  outgoing, incoming),
            VOLUMETRIC: lambda: eval_volumetric(normal, outgoing, incoming),
            GLASS: lambda: eval_glass(mp.roughness, normal, outgoing, incoming),
        },
        types_used, None, vec=True,
    )


def sample_bsdf_cos(mp: MaterialPoint, normal, outgoing, rnl, rn,
                    types_used=ALL_TYPES):
    return _sel_used(
        mp.mtype,
        {
            MATTE: lambda: sample_matte(normal, outgoing, rn),
            PBR: lambda: sample_pbr(mp.colour, mp.roughness, mp.metallic,
                                    normal, outgoing, rnl, rn),
            VOLUMETRIC: lambda: sample_volumetric(outgoing),
            GLASS: lambda: sample_glass(mp.roughness, normal, outgoing, rnl, rn),
        },
        types_used, None, vec=True,
    )


def sample_bsdf_cos_pdf(mp: MaterialPoint, normal, outgoing, incoming,
                        types_used=ALL_TYPES):
    return _sel_used(
        mp.mtype,
        {
            MATTE: lambda: sample_matte_pdf(normal, outgoing, incoming),
            PBR: lambda: sample_pbr_pdf(mp.colour, mp.roughness, mp.metallic,
                                        normal, outgoing, incoming),
            VOLUMETRIC: lambda: sample_volumetric_pdf(normal, outgoing, incoming),
            GLASS: lambda: sample_glass_pdf(mp.roughness, normal, outgoing,
                                            incoming),
        },
        types_used, None, vec=False,
    )


def _has_delta(types_used) -> bool:
    """Delta lobes exist only for PBR/GLASS/SUBSURFACE/VOLUMETRIC materials
    (is_delta, Common.cuh:1189-1195) — matte-only scenes compile them out."""
    return any(t in types_used for t in (PBR, GLASS, SUBSURFACE, VOLUMETRIC))


def eval_delta(mp: MaterialPoint, normal, outgoing, incoming,
               types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return jnp.zeros_like(normal)
    val = _sel_used(
        mp.mtype,
        {
            MATTE: lambda: jnp.zeros_like(normal),
            PBR: lambda: eval_pbr_delta(mp.colour, mp.metallic, normal,
                                        outgoing, incoming),
            VOLUMETRIC: lambda: eval_volumetric(normal, outgoing, incoming),
            GLASS: lambda: eval_glass_delta(normal, outgoing, incoming),
        },
        # MATTE must stay in the dispatch so matte lanes select zero
        tuple(set(types_used) | {MATTE}), None, vec=True,
    )
    return jnp.where((mp.roughness != 0.0)[..., None], 0.0, val)


def sample_delta(mp: MaterialPoint, normal, outgoing, rnl, types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return jnp.zeros_like(normal)
    val = _sel_used(
        mp.mtype,
        {
            MATTE: lambda: jnp.zeros_like(normal),
            PBR: lambda: sample_pbr_delta(normal, outgoing),
            VOLUMETRIC: lambda: sample_volumetric(outgoing),
            GLASS: lambda: sample_glass_delta(normal, outgoing, rnl),
        },
        tuple(set(types_used) | {MATTE}), None, vec=True,
    )
    return jnp.where((mp.roughness != 0.0)[..., None], 0.0, val)


def sample_delta_pdf(mp: MaterialPoint, normal, outgoing, incoming,
                     types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return jnp.zeros_like(normal[..., 0])
    val = _sel_used(
        mp.mtype,
        {
            MATTE: lambda: jnp.zeros_like(normal[..., 0]),
            PBR: lambda: sample_pbr_delta_pdf(mp.colour, mp.metallic, normal,
                                              outgoing, incoming),
            VOLUMETRIC: lambda: sample_volumetric_pdf(normal, outgoing, incoming),
            GLASS: lambda: sample_glass_delta_pdf(normal, outgoing, incoming),
        },
        tuple(set(types_used) | {MATTE}), None, vec=False,
    )
    return jnp.where(mp.roughness != 0.0, 0.0, val)
