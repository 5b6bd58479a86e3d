"""Wavefront path tracer (reference src/PathTrace.cuh).

The reference runs a divergent per-thread megakernel with a bounce loop,
nested traces, and data-dependent breaks. The design here is *wavefront*:
every bounce is one vectorized step over the whole pixel batch — all lanes
intersect together, all lanes shade together, termination is a mask. This
keeps every op dense and gives XLA whole-image fusion freedom
(SURVEY.md §7.2 step 3).

Faithful reproductions:
  * MIS estimator structure (PathTrace.cuh:148-351): NEE with power
    heuristic + shadow trace, BSDF sample whose intersection is REUSED as
    the next bounce's hit, delta materials sampled separately, Russian
    roulette after bounce 3, radiance clamp.
  * emission only added when the previous bounce did not already account
    for it via MIS (UseMisIntersection, :230-233).
  * the MIS bsdf branch uses raw Material.Emission for the hit (no
    orientation test, :276) while the NEE branch uses EvalEmission (:256).
  * simpler BSDF/LIGHT/BOTH estimators (PathTrace.cuh:353-556).

Participating media (PathTrace.cuh:187-202, 295-335) and opacity
pass-through (:219-226) are wavefronted too, gated on the static scene
flags `meta.has_media` / `meta.has_opacity` so plain surface scenes compile
none of that machinery: per-lane medium state (inside flag + the active
volume's density/scattering/anisotropy), transmittance-sampled scatter
distance, 50/50 phase-vs-light direction with the mixed pdf, and the
volume-stack toggle on transmissive boundary crossings.

Documented deviations:
  * deterministic jax.random fields instead of time-seeded PCG
    (PathTrace.cuh:589-592) — required for reproducibility and gradients;
  * a zero light-pdf kills the NEE contribution instead of producing the
    reference's NaN-then-scrub-to-black behavior (Common.cuh:245 quirk);
  * when the MIS-sample condition fails the next bounce re-traces instead
    of reusing a stale MisIntersection (reference keeps a stale flag);
  * an opacity pass-through consumes a bounce (the reference replays the
    bounce index, `Bounce--; continue`, up to 128 times :220-226 — a
    data-dependent trip count that cannot be a fixed wavefront step);
    raise `bounces` to compensate for heavily-transparent scenes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svgf_jax.config import SamplingMode
from svgf_jax.ops import bsdf as B
from svgf_jax.ops import texture as T
from svgf_jax.ops.geometry import (
    MAX_LENGTH,
    dot,
    normalize,
    transform_direction,
    transform_point,
    transform_vector,
)
from svgf_jax.ops.intersect import Hit, intersect_scene
from svgf_jax.ops import media as M
from svgf_jax.ops.lights import (
    _interp,
    eval_environment,
    sample_lights,
    sample_lights_pdf,
    sample_lights_pdf_from_hit,
)
from svgf_jax.ops.sampling import RngStream, power_heuristic


class _Shade(NamedTuple):
    position: jax.Array   # (R,3) world shading position
    normal: jax.Array     # (R,3) shading normal (flipped toward outgoing; glass keeps)
    mp: B.MaterialPoint


def _shading_point(scene, hit: Hit, outgoing) -> _Shade:
    """Geometry + material evaluation at a hit (Common.cuh:1422-1479).

    When SceneMeta.textures_enabled, the per-material texture slots are
    sampled at the interpolated UV (EvalTexCoord, Common.cuh:1375-1384) and
    folded into the material point exactly like EvalMaterial
    (Common.cuh:1440-1479: colour/emission sRGB->linear, roughness.y /
    metallic.z channels, colour alpha -> opacity); the normal map applies
    through the tangent frame (Common.cuh:1405-1418, PathTrace.cuh:182-185).
    With textures disabled this compiles to exactly the reference's vec4(1)
    stub behavior (Common.cuh:1391)."""
    prim = jnp.clip(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = jnp.clip(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = jnp.clip(hit.material, 0, scene.mat_type.shape[0] - 1)
    tp, tn = scene.tri_pos[prim], scene.tri_nrm[prim]
    m_t, m_n = scene.inst_transform[inst], scene.inst_normal_transform[inst]
    w0 = (1.0 - hit.u - hit.v)[..., None]
    p_obj = tp[:, 1] * hit.u[..., None] + tp[:, 2] * hit.v[..., None] + tp[:, 0] * w0
    n_obj = tn[:, 1] * hit.u[..., None] + tn[:, 2] * hit.v[..., None] + tn[:, 0] * w0
    pos = transform_point(m_t, p_obj)
    n = normalize(transform_vector(m_n, n_obj))
    if scene.meta.textures_enabled:
        uv = _interp(scene.tri_uv, prim, hit.u, hit.v)
        tex_col = T.eval_texture(scene.textures, scene.mat_colour_tex[mat], uv,
                                 linear=True)
        tex_emi = T.eval_texture(scene.textures, scene.mat_emission_tex[mat], uv,
                                 linear=True)[..., :3]
        tex_rgh = T.eval_texture(scene.textures, scene.mat_roughness_tex[mat], uv,
                                 linear=False)
        mp = B.eval_material_point(
            scene, mat,
            tex_colour=tex_col[..., :3], tex_emission=tex_emi,
            tex_roughness=tex_rgh, tex_alpha=tex_col[..., 3],
        )
        if scene.meta.has_normal_maps:
            tan = _interp(scene.tri_tan, prim, hit.u, hit.v)
            n = T.apply_normal_map(
                scene.textures, scene.mat_normal_tex[mat], uv, n, tan,
                m_n, transform_direction, normalize,
            )
    else:
        mp = B.eval_material_point(scene, mat)
    # EvalShadingNormal (Common.cuh:1433-1438): glass keeps the normal,
    # everything else flips it toward the outgoing direction
    flip = (dot(n, outgoing) < 0) & (mp.mtype != B.GLASS)
    n = jnp.where(flip[..., None], -n, n)
    return _Shade(position=pos, normal=n, mp=mp)


def _emission_at_hit(scene, hit: Hit, outgoing):
    """EvalEmission at a secondary hit (NEE branch, PathTrace.cuh:253-256).

    Without textures only the shading normal and mat_emission matter, so
    this skips the full _shading_point (position transform, colour /
    roughness / density derivation) — the same normal-interp + flip +
    orientation-test math, ~half the per-bounce gather cost."""
    if scene.meta.textures_enabled:
        sh = _shading_point(scene, hit, outgoing)
        return B.eval_emission(sh.mp, sh.normal, outgoing)
    prim = jnp.clip(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = jnp.clip(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = jnp.clip(hit.material, 0, scene.mat_type.shape[0] - 1)
    tn = scene.tri_nrm[prim]
    m_n = scene.inst_normal_transform[inst]
    w0 = (1.0 - hit.u - hit.v)[..., None]
    n_obj = tn[:, 1] * hit.u[..., None] + tn[:, 2] * hit.v[..., None] + tn[:, 0] * w0
    n = normalize(transform_vector(m_n, n_obj))
    mtype = scene.mat_type[mat]
    flip = (dot(n, outgoing) < 0) & (mtype != B.GLASS)
    n = jnp.where(flip[..., None], -n, n)
    emission = scene.mat_emission[mat]
    return jnp.where((dot(n, outgoing) >= 0)[..., None], emission, 0.0)


def _offset_origin(position, normal, incoming):
    """Ray origin shift (PathTrace.cuh:240, 304)."""
    side = jnp.where(dot(normal, incoming) > 0, 1.0, -1.0)
    return position + side[..., None] * normal * 1e-3


class PathState(NamedTuple):
    radiance: jax.Array   # (R,3)
    weight: jax.Array     # (R,3)
    active: jax.Array     # (R,) bool
    use_mis: jax.Array    # (R,) bool
    ro: jax.Array         # (R,3)
    rd: jax.Array         # (R,3)
    # medium stack (depth 1, like the reference's single VolumeMaterial,
    # PathTrace.cuh:158-159): XLA DCEs these when meta.has_media is False
    in_volume: jax.Array       # (R,) bool
    vol_density: jax.Array     # (R,3)
    vol_scattering: jax.Array  # (R,3)
    vol_anisotropy: jax.Array  # (R,)


def _sample_medium(state: PathState, hit: Hit, rng: RngStream):
    """Transmittance-sample a scatter distance for in-volume lanes
    (PathTrace.cuh:187-202). Returns (state, stay_in_volume, distance)."""
    R = state.ro.shape[0]
    in_vol = state.active & state.in_volume
    dist = M.sample_transmittance(
        state.vol_density, hit.dist, rng.uniform((R,)), rng.uniform((R,))
    )
    # the event distance is a *sample*: pathwise gradients treat it as a
    # constant (SURVEY.md §7.1 — stop-grad sampled/discrete choices; the
    # boundary/score term is omitted, standard for differentiable volume
    # rendering). Differentiating through it re-enters the traversal
    # geometry and NaNs.
    dist = jax.lax.stop_gradient(dist)
    w = M.eval_transmittance(state.vol_density, dist) / jnp.maximum(
        M.sample_transmittance_pdf(state.vol_density, dist, hit.dist), 1e-18
    )[..., None]
    weight = jnp.where(in_vol[..., None], state.weight * w, state.weight)
    stay = in_vol & (dist < hit.dist)
    return state._replace(weight=weight), stay, dist


def _volume_scatter(scene, state: PathState, dist, rng: RngStream):
    """In-volume scatter event (PathTrace.cuh:308-335): 50/50 phase-function
    vs light-direction sampling, weighted by the mixed pdf. Returns
    (position, incoming, weight_multiplier, broke)."""
    R = state.ro.shape[0]
    pos = state.ro + state.rd * dist[..., None]
    outgoing = -state.rd
    use_phase = rng.uniform((R,)) > 0.5
    rng.uniform((R,))  # the reference's unused RNL draw (Common.cuh:1145)
    dir_p = M.sample_phase(
        state.vol_density, state.vol_anisotropy, outgoing, rng.uniform2((R,))
    )
    dir_l = sample_lights(
        scene, pos, rng.uniform((R,)), rng.uniform((R,)), rng.uniform2((R,))
    )
    incoming = jnp.where(use_phase[..., None], dir_p, dir_l)
    broke = jnp.all(incoming == 0.0, axis=-1)
    ppdf = M.sample_phase_pdf(
        state.vol_density, state.vol_anisotropy, outgoing, incoming
    )
    lpdf = sample_lights_pdf(scene, pos, incoming)
    w = M.eval_phase(
        state.vol_scattering, state.vol_density, state.vol_anisotropy,
        outgoing, incoming,
    ) / jnp.maximum(0.5 * ppdf + 0.5 * lpdf, 1e-18)[..., None]
    return pos, incoming, w, broke


# Optional measurement probe: when set to a list (scripts/measure_balance.py
# sets it around a traced call), pathtrace appends each bounce's post-RR
# active mask — the raw data for the SURVEY §2.7 ray load-balance evidence
# (live-lane imbalance across shard bands). None in production.
_ACTIVE_PROBE: list | None = None


def set_active_probe(lst) -> None:
    global _ACTIVE_PROBE
    _ACTIVE_PROBE = lst


def pathtrace(
    scene,
    ro,
    rd,
    key,
    bounces: int = 3,
    clamp: float = 10.0,
    mode: SamplingMode = SamplingMode.MIS,
    first_hit: Hit | None = None,
    lane0=0,
    lane_ids=None,
):
    """Trace one sample per lane. Returns (radiance (R,3), first_normal
    (R,3), rays_traced () i32).

    rays_traced counts the ACTIVE lanes of every intersect_scene invocation
    (measured, not a formula); masked-off lanes are not counted.

    lane0 / lane_ids: global lane ids (chunked / band / 2-D-tile rendering) —
    random draws hash (seed, site, lane id), so any partition of the frame
    reproduces exactly the pixels the whole frame would (ops.sampling
    .RngStream). lane_ids (explicit array) wins over lane0 (contiguous).
    """
    R = ro.shape[0]
    if lane_ids is None:
        lane_ids = jnp.uint32(lane0) + jnp.arange(R, dtype=jnp.uint32)
    else:
        lane_ids = lane_ids.astype(jnp.uint32)
    state = PathState(
        radiance=jnp.zeros((R, 3), jnp.float32),
        weight=jnp.ones((R, 3), jnp.float32),
        active=jnp.ones((R,), jnp.bool_),
        use_mis=jnp.zeros((R,), jnp.bool_),
        ro=ro,
        rd=rd,
        in_volume=jnp.zeros((R,), jnp.bool_),
        vol_density=jnp.zeros((R, 3), jnp.float32),
        vol_scattering=jnp.zeros((R, 3), jnp.float32),
        vol_anisotropy=jnp.zeros((R,), jnp.float32),
    )
    first_normal = jnp.zeros((R, 3), jnp.float32)
    nrays = jnp.zeros((), jnp.int32)

    if first_hit is not None:
        hit = first_hit
    else:
        hit = intersect_scene(scene, ro, rd)
        nrays = nrays + R
    for b in range(bounces):
        rng = RngStream(jax.random.fold_in(key, b), lane_ids)
        if mode == SamplingMode.MIS:
            state, next_hit, has_next, nb = _bounce_mis(scene, state, hit, rng, b)
        else:
            state, next_hit, has_next, nb = _bounce_simple(scene, state, hit, rng, b, mode)
        nrays = nrays + nb
        if b == 0:
            sh0 = _shading_point(scene, hit, -rd)
            first_normal = jnp.where(
                (hit.dist < MAX_LENGTH)[..., None], sh0.normal, 0.0
            )
        # Russian roulette after bounce 3 (PathTrace.cuh:340-345)
        if b > 3:
            rr = jnp.minimum(0.99, jnp.max(state.weight, axis=-1))
            u = rng.uniform((R,))
            kill = u >= rr
            survive = state.active & ~kill
            state = state._replace(
                active=survive,
                weight=jnp.where(
                    survive[..., None],
                    state.weight / jnp.maximum(rr, 1e-6)[..., None],
                    state.weight,
                ),
            )
        dead = (jnp.max(state.weight, axis=-1) <= 0.0) | ~jnp.all(
            jnp.isfinite(state.weight), axis=-1
        )
        state = state._replace(active=state.active & ~dead)
        if _ACTIVE_PROBE is not None:
            _ACTIVE_PROBE.append(state.active)
        if b + 1 < bounces:
            if has_next is None:
                # MIS: _bounce_mis already traced every active lane's next
                # ray inside its batched intersect — no re-trace step
                hit = next_hit
            else:
                retrace = state.active & ~has_next
                traced = intersect_scene(scene, state.ro, state.rd,
                                         active=retrace)
                nrays = nrays + jnp.sum(retrace.astype(jnp.int32))
                hit = jax.tree.map(
                    lambda a, t: jnp.where(
                        has_next if a.ndim == 1 else has_next[..., None], a, t
                    ),
                    next_hit,
                    traced,
                )

    radiance = state.radiance
    radiance = jnp.where(
        jnp.all(jnp.isfinite(radiance), axis=-1, keepdims=True), radiance, 0.0
    )
    m = jnp.max(radiance, axis=-1)
    # denominator floored at `clamp` (the branch is only taken for m > clamp)
    # so the untaken branch's backward stays finite — 1e-18 floors overflow
    scale = jnp.where(m > clamp, clamp / jnp.maximum(m, clamp), 1.0)
    return radiance * scale[..., None], first_normal, nrays


def pathtrace_chunked(
    scene,
    ro,
    rd,
    key,
    bounces: int = 3,
    clamp: float = 10.0,
    mode: SamplingMode = SamplingMode.MIS,
    first_hit: Hit | None = None,
    num_chunks: int = 1,
    lane0=0,
    lane_ids=None,
):
    """Run the wavefront in `num_chunks` sequential chunks via lax.map.

    Peak device memory of the shading stage scales with the live lane
    count, so a large frame is processed as a pipeline of smaller
    wavefronts (the body compiles once). Chunk lanes carry their global
    lane ids, so the chunked result is BIT-IDENTICAL to the unchunked one
    (counter-based RNG).
    """
    R = ro.shape[0]
    if lane_ids is None:
        lane_ids = jnp.uint32(lane0) + jnp.arange(R, dtype=jnp.uint32)
    else:
        lane_ids = lane_ids.astype(jnp.uint32)
    if num_chunks <= 1:
        return pathtrace(scene, ro, rd, key, bounces, clamp, mode, first_hit,
                         lane_ids=lane_ids)
    # NOTE: returns (radiance (R,3), first_normal (R,3), rays_traced () i32)
    # like pathtrace; chunk ray counts are summed.
    rc = -(-R // num_chunks)
    pad = rc * num_chunks - R

    def pad_r(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)

    ro_r = pad_r(ro).reshape(num_chunks, rc, 3)
    rd_r = pad_r(rd).reshape(num_chunks, rc, 3)
    ids_r = pad_r(lane_ids).reshape(num_chunks, rc)
    fh_r = (
        jax.tree.map(lambda x: pad_r(x).reshape(num_chunks, rc), first_hit)
        if first_hit is not None
        else None
    )

    def body(args):
        ids_c, ro_c, rd_c, fh_c = args
        rad, n, nr = pathtrace(
            scene, ro_c, rd_c, key,
            bounces, clamp, mode, fh_c, lane_ids=ids_c,
        )
        return rad, n, nr

    rad, n, nr = jax.lax.map(body, (ids_r, ro_r, rd_r, fh_r))
    return rad.reshape(-1, 3)[:R], n.reshape(-1, 3)[:R], jnp.sum(nr)


def _handle_miss(scene, state: PathState, hit: Hit):
    miss = state.active & (hit.dist >= MAX_LENGTH)
    if scene.meta.n_envs > 0:
        env = eval_environment(scene, state.rd)
        radiance = state.radiance + jnp.where(miss[..., None], state.weight * env, 0.0)
    else:
        radiance = state.radiance
    return state._replace(radiance=radiance, active=state.active & ~miss)


def _bounce_mis(scene, state: PathState, hit: Hit, rng: RngStream, bounce: int):
    R = state.ro.shape[0]
    state = _handle_miss(scene, state, hit)
    act = state.active

    # medium event: in-volume lanes may scatter before reaching the surface
    if scene.meta.has_media:
        state, stay, vol_dist = _sample_medium(state, hit, rng)
    else:
        stay = jnp.zeros((R,), jnp.bool_)
        vol_dist = hit.dist
    surf = act & ~stay

    outgoing = -state.rd
    sh = _shading_point(scene, hit, outgoing)
    mp, normal, position = sh.mp, sh.normal, sh.position

    # opacity pass-through (PathTrace.cuh:219-226)
    if scene.meta.has_opacity:
        passthrough = surf & (mp.opacity < 1.0) & (rng.uniform((R,)) >= mp.opacity)
        shade = surf & ~passthrough
    else:
        passthrough = jnp.zeros((R,), jnp.bool_)
        shade = surf

    # emission (only when the MIS bsdf branch didn't already account for it)
    emit = B.eval_emission(mp, normal, outgoing)
    add_emit = shade & ~state.use_mis
    radiance = state.radiance + jnp.where(add_emit[..., None], state.weight * emit, 0.0)

    delta = B.is_delta(mp)
    weight = state.weight

    # ---------------- NEE branch (PathTrace.cuh:238-260) ----------------
    # The shadow hit is reused for the light pdf (sample_lights_pdf_from_hit)
    # instead of fresh per-light re-traces — the reference's own flagged hot
    # spot (Common.cuh:635 "not efficient"). The shadow and MIS-sample rays
    # are BATCHED into one 2R-lane intersect below (same scene, two ray
    # sets): at 1080p each intersect call carries ~1 ms of fixed dispatch /
    # layout cost, so one kernel sweep instead of two nearly halves the
    # per-bounce trace time. RNG draw order is unchanged (the traces consume
    # no randomness), so results are bitwise identical per lane.
    dir_l = sample_lights(
        scene, position, rng.uniform((R,)), rng.uniform((R,)), rng.uniform2((R,))
    )
    l_zero = jnp.all(dir_l == 0.0, axis=-1)
    shifted_l = _offset_origin(position, normal, dir_l)
    bsdf_l = B.eval_bsdf_cos(mp, normal, outgoing, dir_l, scene.meta.mat_types_used)
    pre_l = shade & ~delta & ~l_zero & jnp.any(bsdf_l != 0.0, axis=-1)
    nrays = jnp.sum(pre_l.astype(jnp.int32))

    # ------------- BSDF-sample directions (PathTrace.cuh:261-268) --------
    dir_b = B.sample_bsdf_cos(mp, normal, outgoing, rng.uniform((R,)), rng.uniform2((R,)), scene.meta.mat_types_used)
    b_zero = jnp.all(dir_b == 0.0, axis=-1)
    shifted_b = _offset_origin(position, normal, dir_b)
    bsdf_b = B.eval_bsdf_cos(mp, normal, outgoing, dir_b, scene.meta.mat_types_used)
    bpdf_b = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_b, scene.meta.mat_types_used)
    pre_b = (
        shade & ~delta & ~l_zero & ~b_zero & (bpdf_b > 0)
        & jnp.any(bsdf_b != 0.0, axis=-1)
    )
    # the NEXT bounce flies dir_b for EVERY continuing non-delta lane, even
    # when the MIS contribution is zero (bpdf<=0 / zero BSDF — the reference
    # keeps the sampled direction, :261-284), so the traced set is the
    # superset trace_b and mis_hit IS the next bounce's hit — no re-trace.
    trace_b = shade & ~delta & ~l_zero & ~b_zero
    nrays = nrays + jnp.sum(trace_b.astype(jnp.int32))

    # ---------------- delta branch (PathTrace.cuh:286-292) --------------
    # (moved before the batched trace: the trace consumes no randomness and
    # RNG sites depend only on uniform() call ORDER, which is unchanged)
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform((R,)), scene.meta.mat_types_used)
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d, scene.meta.mat_types_used)
    w_delta = weight * B.eval_delta(mp, normal, outgoing, dir_d, scene.meta.mat_types_used) / jnp.maximum(
        pdf_d, 1e-18
    )[..., None]
    d_zero = jnp.all(dir_d == 0.0, axis=-1)

    # ---------------- merge directions (pre-trace) ----------------------
    incoming = jnp.where(delta[..., None], dir_d, dir_b)
    # lanes break when their sampled direction is zero (:241,:264)
    broke = jnp.where(delta, d_zero, b_zero | l_zero)
    new_ro = _offset_origin(position, normal, incoming)

    in_volume = state.in_volume
    vol_density, vol_scattering, vol_anisotropy = (
        state.vol_density, state.vol_scattering, state.vol_anisotropy
    )
    vw = None
    if scene.meta.has_media:
        # volume-stack toggle on transmissive crossings (PathTrace.cuh:295-302)
        enter = (
            shade & ~broke & B.is_volumetric(mp)
            & (dot(normal, outgoing) * dot(normal, incoming) < 0)
        )
        in_volume = jnp.where(enter, ~state.in_volume, state.in_volume)
        vol_density = jnp.where(enter[..., None], mp.density, vol_density)
        vol_scattering = jnp.where(enter[..., None], mp.scattering, vol_scattering)
        vol_anisotropy = jnp.where(enter, mp.anisotropy, vol_anisotropy)

        # in-volume scatter event replaces the surface interaction
        vpos, vdir, vw, vbroke = _volume_scatter(scene, state, vol_dist, rng)
        # sample_lights_pdf in the scatter event re-traces every area light
        # over all R lanes (only_instance walks, Common.cuh:635-715)
        nrays = nrays + _n_area_lights(scene) * R
        incoming = jnp.where(stay[..., None], vdir, incoming)
        new_ro = jnp.where(stay[..., None], vpos, new_ro)
        broke = jnp.where(stay, vbroke, broke)

    if scene.meta.has_opacity:
        # pass through the surface, direction unchanged (PathTrace.cuh:222-226)
        incoming = jnp.where(passthrough[..., None], state.rd, incoming)
        new_ro = jnp.where(
            passthrough[..., None], position + state.rd * 1e-2, new_ro
        )
        broke = jnp.where(passthrough, False, broke)

    # ---- ONE batched intersect: [NEE shadow | bsdf sample | other-next].
    # Segment 3 exists only for scenes that can produce delta / in-volume /
    # pass-through continuation rays (static meta flags); everywhere else
    # the bsdf segment IS the next bounce's hit.
    needs_seg3 = (
        scene.meta.has_media
        or scene.meta.has_opacity
        or any(t in scene.meta.mat_types_used
               for t in (B.PBR, B.GLASS, B.VOLUMETRIC))
    )
    if needs_seg3:
        seg3 = act & ~broke & (delta | stay | passthrough)
        nrays = nrays + jnp.sum(seg3.astype(jnp.int32))
        hitN = intersect_scene(
            scene,
            jnp.concatenate([shifted_l, shifted_b, new_ro], axis=0),
            jnp.concatenate([dir_l, dir_b, incoming], axis=0),
            active=jnp.concatenate([pre_l, trace_b, seg3], axis=0),
        )
        seg3_hit = jax.tree.map(lambda x: x[2 * R :], hitN)
    else:
        seg3 = None
        hitN = intersect_scene(
            scene,
            jnp.concatenate([shifted_l, shifted_b], axis=0),
            jnp.concatenate([dir_l, dir_b], axis=0),
            active=jnp.concatenate([pre_l, trace_b], axis=0),
        )
        seg3_hit = None
    shadow = jax.tree.map(lambda x: x[:R], hitN)
    mis_hit = jax.tree.map(lambda x: x[R : 2 * R], hitN)

    lpdf_l = sample_lights_pdf_from_hit(scene, shifted_l, dir_l, shadow)
    bpdf_l = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_l, scene.meta.mat_types_used)
    # Double-where: guard the division's backward for lpdf_l == 0 lanes.
    safe_l = lpdf_l > 0
    misw_l = jnp.where(safe_l, power_heuristic(lpdf_l, bpdf_l), 0.0) / jnp.where(
        safe_l, jnp.maximum(lpdf_l, 1e-18), 1.0
    )
    nee_ok = pre_l & safe_l & (misw_l != 0)
    shadow_miss = shadow.dist >= MAX_LENGTH
    if scene.meta.n_envs > 0:
        emis_miss = eval_environment(scene, dir_l)
    else:
        emis_miss = jnp.zeros((R, 3), jnp.float32)
    emis_hit = _emission_at_hit(scene, shadow, -dir_l)
    emis = jnp.where(shadow_miss[..., None], emis_miss, emis_hit)
    radiance = radiance + jnp.where(
        nee_ok[..., None], weight * bsdf_l * emis * misw_l[..., None], 0.0
    )

    # ---------------- BSDF-sample branch (PathTrace.cuh:261-284) --------
    # Same reuse: the MIS intersection (from the batched trace above)
    # supplies the light pdf of dir_b.
    lpdf_b = sample_lights_pdf_from_hit(scene, shifted_b, dir_b, mis_hit)
    safe_b = bpdf_b > 0
    misw_b = jnp.where(safe_b, power_heuristic(bpdf_b, lpdf_b), 0.0) / jnp.where(
        safe_b, jnp.maximum(bpdf_b, 1e-18), 1.0
    )
    mis_cond = pre_b & (misw_b != 0)
    mis_miss = mis_hit.dist >= MAX_LENGTH
    if scene.meta.n_envs > 0:
        emis_b = jnp.where(
            mis_miss[..., None], eval_environment(scene, dir_b), 0.0
        )
    else:
        emis_b = jnp.zeros((R, 3), jnp.float32)
    # raw Material.Emission at the hit — no orientation test (:276)
    hm = jnp.clip(mis_hit.material, 0, scene.mat_type.shape[0] - 1)
    emis_b = jnp.where(
        mis_miss[..., None], emis_b, scene.mat_emission[hm]
    )
    radiance = radiance + jnp.where(
        mis_cond[..., None], weight * bsdf_b * emis_b * misw_b[..., None], 0.0
    )
    w_bsdf = weight * jnp.where(safe_b[..., None], bsdf_b, 0.0) / jnp.where(
        safe_b, jnp.maximum(bpdf_b, 1e-18), 1.0
    )[..., None]

    # ---------------- weight / flag merge (post-trace) ------------------
    new_weight = jnp.where(
        delta[..., None], w_delta, jnp.where(mis_cond[..., None], w_bsdf, weight)
    )
    use_mis = jnp.where(delta, False, mis_cond)
    if scene.meta.has_media:
        new_weight = jnp.where(stay[..., None], state.weight * vw, new_weight)
        use_mis = jnp.where(stay, False, use_mis)
    if scene.meta.has_opacity:
        new_weight = jnp.where(passthrough[..., None], state.weight, new_weight)
        use_mis = jnp.where(passthrough, False, use_mis)

    active = act & ~broke
    new_state = PathState(
        radiance=radiance,
        weight=jnp.where(act[..., None], new_weight, state.weight),
        active=active,
        use_mis=jnp.where(act, use_mis, state.use_mis),
        ro=jnp.where(act[..., None], new_ro, state.ro),
        rd=jnp.where(act[..., None], incoming, state.rd),
        in_volume=jnp.where(act, in_volume, state.in_volume),
        vol_density=vol_density,
        vol_scattering=vol_scattering,
        vol_anisotropy=vol_anisotropy,
    )
    # every active lane's next hit is already traced: dir_b lanes reuse the
    # MIS segment (new_ro == shifted_b, incoming == dir_b for them — the
    # identical ray), delta/volume/pass-through lanes come from segment 3.
    if needs_seg3:
        m3 = delta | stay | passthrough
        next_hit = jax.tree.map(
            lambda a, b: jnp.where(m3 if a.ndim == 1 else m3[..., None], a, b),
            seg3_hit, mis_hit,
        )
    else:
        next_hit = mis_hit
    return new_state, next_hit, None, nrays


def _n_area_lights(scene) -> int:
    """Static count of instance (area) lights — each costs one
    only_instance re-trace inside sample_lights_pdf (Common.cuh:635-715)."""
    meta = scene.meta
    return sum(1 for l in range(meta.n_lights) if meta.light_instance[l] >= 0)


def _bounce_simple(scene, state: PathState, hit: Hit, rng: RngStream, bounce: int,
                   mode: SamplingMode):
    """BSDF / LIGHT / BOTH estimators (PathTrace.cuh:353-556), with the same
    media (:396-411, :504-540) and opacity (:430-437) handling as MIS."""
    R = state.ro.shape[0]
    state = _handle_miss(scene, state, hit)
    act = state.active

    if scene.meta.has_media:
        state, stay, vol_dist = _sample_medium(state, hit, rng)
    else:
        stay = jnp.zeros((R,), jnp.bool_)
        vol_dist = hit.dist
    surf = act & ~stay

    outgoing = -state.rd
    sh = _shading_point(scene, hit, outgoing)
    mp, normal, position = sh.mp, sh.normal, sh.position

    if scene.meta.has_opacity:
        passthrough = surf & (mp.opacity < 1.0) & (rng.uniform((R,)) >= mp.opacity)
        shade = surf & ~passthrough
    else:
        passthrough = jnp.zeros((R,), jnp.bool_)
        shade = surf

    emit = B.eval_emission(mp, normal, outgoing)
    radiance = state.radiance + jnp.where(shade[..., None], state.weight * emit, 0.0)

    delta = B.is_delta(mp)

    # light-sampling estimator
    dir_l = sample_lights(
        scene, position, rng.uniform((R,)), rng.uniform((R,)), rng.uniform2((R,))
    )
    l_zero = jnp.all(dir_l == 0.0, axis=-1)
    # per-area-light only_instance re-traces over all R lanes
    nrays = jnp.asarray(_n_area_lights(scene) * R, jnp.int32)
    lpdf = sample_lights_pdf(scene, position, dir_l)
    w_light = B.eval_bsdf_cos(mp, normal, outgoing, dir_l, scene.meta.mat_types_used) / jnp.maximum(lpdf, 1e-18)[
        ..., None
    ]
    light_bad = l_zero | (lpdf <= 0)

    # bsdf-sampling estimator
    dir_b = B.sample_bsdf_cos(mp, normal, outgoing, rng.uniform((R,)), rng.uniform2((R,)), scene.meta.mat_types_used)
    b_zero = jnp.all(dir_b == 0.0, axis=-1)
    bpdf = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_b, scene.meta.mat_types_used)
    w_bsdf = B.eval_bsdf_cos(mp, normal, outgoing, dir_b, scene.meta.mat_types_used) / jnp.maximum(bpdf, 1e-18)[
        ..., None
    ]

    if mode == SamplingMode.LIGHT:
        use_light = jnp.ones((R,), jnp.bool_)
    elif mode == SamplingMode.BSDF:
        use_light = jnp.zeros((R,), jnp.bool_)
    else:  # BOTH: 50/50 per lane (PathTrace.cuh:469)
        use_light = rng.uniform((R,)) > 0.5

    incoming_nd = jnp.where(use_light[..., None], dir_l, dir_b)
    w_nd = jnp.where(use_light[..., None], w_light, w_bsdf)
    broke_nd = jnp.where(use_light, light_bad, b_zero)

    # delta branch
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform((R,)), scene.meta.mat_types_used)
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d, scene.meta.mat_types_used)
    w_delta = B.eval_delta(mp, normal, outgoing, dir_d, scene.meta.mat_types_used) / jnp.maximum(pdf_d, 1e-18)[
        ..., None
    ]
    d_zero = jnp.all(dir_d == 0.0, axis=-1)

    incoming = jnp.where(delta[..., None], dir_d, incoming_nd)
    w_mult = jnp.where(delta[..., None], w_delta, w_nd)
    broke = jnp.where(delta, d_zero, broke_nd)
    new_ro = _offset_origin(position, normal, incoming)
    new_weight = state.weight * w_mult

    in_volume = state.in_volume
    vol_density, vol_scattering, vol_anisotropy = (
        state.vol_density, state.vol_scattering, state.vol_anisotropy
    )
    if scene.meta.has_media:
        enter = (
            shade & ~broke & B.is_volumetric(mp)
            & (dot(normal, outgoing) * dot(normal, incoming) < 0)
        )
        in_volume = jnp.where(enter, ~state.in_volume, state.in_volume)
        vol_density = jnp.where(enter[..., None], mp.density, vol_density)
        vol_scattering = jnp.where(enter[..., None], mp.scattering, vol_scattering)
        vol_anisotropy = jnp.where(enter, mp.anisotropy, vol_anisotropy)

        vpos, vdir, vw, vbroke = _volume_scatter(scene, state, vol_dist, rng)
        nrays = nrays + _n_area_lights(scene) * R
        incoming = jnp.where(stay[..., None], vdir, incoming)
        new_weight = jnp.where(stay[..., None], state.weight * vw, new_weight)
        new_ro = jnp.where(stay[..., None], vpos, new_ro)
        broke = jnp.where(stay, vbroke, broke)

    if scene.meta.has_opacity:
        incoming = jnp.where(passthrough[..., None], state.rd, incoming)
        new_weight = jnp.where(passthrough[..., None], state.weight, new_weight)
        new_ro = jnp.where(
            passthrough[..., None], position + state.rd * 1e-2, new_ro
        )
        broke = jnp.where(passthrough, False, broke)

    new_state = PathState(
        radiance=radiance,
        weight=jnp.where(act[..., None], new_weight, state.weight),
        active=act & ~broke,
        use_mis=state.use_mis,
        ro=jnp.where(act[..., None], new_ro, state.ro),
        rd=jnp.where(act[..., None], incoming, state.rd),
        in_volume=jnp.where(act, in_volume, state.in_volume),
        vol_density=vol_density,
        vol_scattering=vol_scattering,
        vol_anisotropy=vol_anisotropy,
    )
    return new_state, Hit.none((R,)), jnp.zeros((R,), jnp.bool_), nrays
