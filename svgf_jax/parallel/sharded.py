"""Multi-chip image-space data parallelism.

The frame is sharded by rows over a 1-D device mesh (`tiles_y` chips). Per
frame each chip:
  - traces its own row band (scene/BVH/materials replicated — a few MB,
    SURVEY.md §5),
  - temporal-reprojects against an all-gathered previous frame (motion
    vectors may point anywhere on screen),
  - runs the stencil filters on halo-extended bands (ppermute halo
    exchange; widths 3, then 2*step per a-trous iteration, then 1 for TAA).

The halo boundary policies in parallel.halo make the sharded filters
bit-compatible with the unsharded ones (tested in tests/test_sharding.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from svgf_jax.config import RenderConfig
from svgf_jax.ops.geometry import to_srgb
from svgf_jax.render import svgf
from svgf_jax.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_jax.render.pathtrace import pathtrace_chunked
from svgf_jax.render.types import FrameOutputs, GBuffer, TemporalState


def make_row_mesh(n_devices: int | None = None, axis: str = "ty") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(devs[:n], (axis,))


def _gather_rows(x, axis):
    """all_gather row-sharded band -> full image (tiled along rows)."""
    return jax.lax.all_gather(x, axis, tiled=True)


def _moments_filter_band(color, moments, gbuf, history, cfg, axis):
    from svgf_jax.parallel.halo import crop_halo, with_row_halo

    fm = svgf.filter_moments
    halo = 3
    hs = color.shape[0]
    if halo >= hs:
        # degenerate tiny bands: gather, compute, slice
        idx = jax.lax.axis_index(axis)
        full_c = _gather_rows(color, axis)
        full_m = _gather_rows(moments, axis)
        full_h = _gather_rows(history, axis)
        full_g = jax.tree.map(lambda v: _gather_rows(v, axis), gbuf)
        out = fm(full_c, full_m, full_g, full_h,
                 cfg.svgf.phi_colour, cfg.svgf.phi_normal)
        return jax.lax.dynamic_slice_in_dim(out, idx * hs, hs, axis=0)
    ext = lambda v: with_row_halo(v, halo, axis, "zero")
    g_ext = gbuf._replace(
        depth=ext(gbuf.depth), depth_deriv=ext(gbuf.depth_deriv), normal=ext(gbuf.normal),
        position=ext(gbuf.position), motion=ext(gbuf.motion), uv=ext(gbuf.uv),
        instance=ext(gbuf.instance), prim=ext(gbuf.prim), material=ext(gbuf.material),
    )
    out = fm(
        ext(color), ext(moments), g_ext,
        with_row_halo(jnp.maximum(history, 1), halo, axis, "zero"),
        cfg.svgf.phi_colour, cfg.svgf.phi_normal,
    )
    return crop_halo(out, halo)


def _atrous_band(img, gbuf, step, cfg, axis):
    from svgf_jax.parallel.halo import crop_halo, with_row_halo

    fa = svgf.atrous_iteration
    halo = 2 * step
    hs = img.shape[0]
    if halo >= hs:
        idx = jax.lax.axis_index(axis)
        full_i = _gather_rows(img, axis)
        full_g = jax.tree.map(lambda v: _gather_rows(v, axis), gbuf)
        out = fa(full_i, full_g, step,
                 cfg.svgf.phi_colour, cfg.svgf.phi_normal)
        return jax.lax.dynamic_slice_in_dim(out, idx * hs, hs, axis=0)
    ext = lambda v: with_row_halo(v, halo, axis, "zero")
    g_ext = gbuf._replace(
        depth=ext(gbuf.depth), depth_deriv=ext(gbuf.depth_deriv), normal=ext(gbuf.normal),
        position=ext(gbuf.position), motion=ext(gbuf.motion), uv=ext(gbuf.uv),
        instance=ext(gbuf.instance), prim=ext(gbuf.prim), material=ext(gbuf.material),
    )
    out = fa(ext(img), g_ext, step,
             cfg.svgf.phi_colour, cfg.svgf.phi_normal)
    return crop_halo(out, halo)


def _taa_band(filtered, history, cfg, axis):
    from svgf_jax.parallel.halo import crop_halo, with_row_halo

    halo = 1
    ext_f = with_row_halo(filtered, halo, axis, "edge")
    ext_h = with_row_halo(history, halo, axis, "edge")
    return crop_halo(svgf.taa(ext_f, ext_h), halo)


def _interleave_a2a(axis: str, hs: int, w: int, n: int):
    """Deterministic ray load-balancing reshard (SURVEY §2.7; VERDICT r3
    item 7). Row-band shards have wildly uneven live-lane counts after
    bounce 0 (measured on BaseScene: 98% imbalance at bounce 0, >400% later
    — scripts/measure_balance.py): sky bands go dead while interior bands
    stay hot. One all_to_all re-deals rows round-robin so every shard traces
    every n-th GLOBAL row — a uniform sample of the image — then a second
    all_to_all deals the radiance back. Data-independent (no sort, no
    dynamic shapes), 2 collectives per frame, and per-pixel results are
    bitwise unchanged (lane ids travel with the rays, RNG keys on them).

    Returns (fwd, inv) over (hs*w, ...) lane arrays/trees."""

    def fwd_leaf(x):
        ch = x.shape[1:]
        v = jnp.swapaxes(x.reshape((hs // n, n, w) + ch), 0, 1)
        v = jax.lax.all_to_all(v, axis, 0, 0)
        return v.reshape((hs * w,) + ch)

    def inv_leaf(x):
        ch = x.shape[1:]
        v = x.reshape((n, hs // n, w) + ch)
        v = jax.lax.all_to_all(v, axis, 0, 0)
        return jnp.swapaxes(v, 0, 1).reshape((hs * w,) + ch)

    return (lambda t: jax.tree.map(fwd_leaf, t),
            lambda t: jax.tree.map(inv_leaf, t))


def _frame_body(scene, color, moments, history_len, taa_history, prev_gbuf,
                frame_idx, config: RenderConfig, axis: str):
    """One frame on one shard's row band. All image args are (Hs, W, ...)."""
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    h_total, w = config.height, config.width
    hs = h_total // n
    row0 = idx * hs
    cam = config.tracing.current_camera
    sdtype = jnp.dtype(config.state_dtype)

    gbuf = raster_gbuffer(scene, cam, hs, w, row0=row0, h_total=h_total)
    # band-exact depth derivative: the forward difference at the band's last
    # row needs the NEXT band's first row ("edge" at the true image bottom
    # reproduces the unsharded clamp) — keeps sharded == unsharded bitwise
    from svgf_jax.parallel.halo import with_row_halo as _wrh

    _z = gbuf.depth
    _ze = _wrh(_z, 1, axis, "edge")[1:]
    _dzy = jnp.abs(_ze[1:] - _ze[:-1])
    _dzx = jnp.abs(jnp.diff(_z, axis=1, append=_z[:, -1:]))
    gbuf = gbuf._replace(
        depth_deriv=jnp.where(_z > 0.0, jnp.maximum(_dzx, _dzy), 0.0)
    )

    # Counter-based RNG keyed by GLOBAL pixel id: every shard draws exactly
    # the values the unsharded frame would, so sharded == unsharded holds
    # bitwise for the trace stage too (ops.sampling.RngStream).
    from svgf_jax.ops.sampling import RngStream

    key = jax.random.fold_in(jax.random.key(config.seed), frame_idx)
    lane0 = row0 * w
    lane_ids = jnp.uint32(lane0) + jnp.arange(hs * w, dtype=jnp.uint32)
    balance = config.trace_balance and n > 1 and hs % n == 0
    a2a_fwd, a2a_inv = (
        _interleave_a2a(axis, hs, w, n) if balance else (None, None)
    )
    radiance = jnp.zeros((hs * w, 3), jnp.float32)
    for s in range(config.tracing.batch):
        skey = jax.random.fold_in(key, s)
        jstream = RngStream(jax.random.fold_in(skey, 987), lane_ids)
        jitter = jstream.uniform2((hs * w,)).reshape(hs, w, 2) * 2 - 1
        ro, rd = camera_rays(scene.cam_frame[cam], scene.cam_proj[cam], hs, w,
                             jitter=jitter, row0=row0, h_total=h_total)
        first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
        ids = lane_ids
        if balance:
            ro, rd, ids = a2a_fwd((ro, rd, lane_ids))
            if first_hit is not None:
                first_hit = a2a_fwd(first_hit)
        sample, _, _nr = pathtrace_chunked(
            scene, ro, rd, skey,
            bounces=config.tracing.bounces, clamp=config.tracing.clamp,
            mode=config.tracing.sampling_mode, first_hit=first_hit,
            num_chunks=config.trace_chunks, lane_ids=ids,
        )
        if balance:
            sample = a2a_inv(sample)
        radiance = radiance + sample / config.tracing.batch
    radiance = radiance.reshape(hs, w, 3)

    # temporal reprojection across shards: exact gather against the
    # all-gathered previous frame (motion vectors may point anywhere on
    # screen, Filter.cuh:230-232)
    prev_color_full = _gather_rows(color.astype(jnp.float32), axis)
    prev_moments_full = _gather_rows(moments.astype(jnp.float32), axis)
    prev_history_full = _gather_rows(history_len, axis)
    prev_gbuf_full = GBuffer.zeros(1, 1)._replace(
        depth=_gather_rows(prev_gbuf.depth.astype(jnp.float32), axis),
        instance=_gather_rows(prev_gbuf.instance, axis),
        normal=_gather_rows(prev_gbuf.normal.astype(jnp.float32), axis),
        motion=jnp.zeros((h_total, w, 2)), position=jnp.zeros((h_total, w, 3)),
        depth_deriv=jnp.zeros((h_total, w)), uv=jnp.zeros((h_total, w, 2)),
        prim=jnp.zeros((h_total, w), jnp.int32), material=jnp.zeros((h_total, w), jnp.int32),
    )
    tres = svgf.temporal_filter(
        radiance, prev_color_full, gbuf, prev_gbuf_full,
        prev_moments_full, prev_history_full,
        depth_threshold=config.svgf.depth_threshold,
        normal_threshold=config.svgf.normal_threshold,
        history_base_length=config.svgf.history_length,
        row0=row0,
    )

    moments_out = _moments_filter_band(
        tres.color, tres.moments, gbuf, tres.history_len, config, axis
    )

    out = moments_out
    feedback = tres.color if config.svgf.spatial_filter_steps == 0 else None
    for i in range(config.svgf.spatial_filter_steps):
        out = _atrous_band(out, gbuf, 1 << i, config, axis)
        if i == 0:
            feedback = out
    atrous_out = out

    if config.svgf.enable_taa:
        final = _taa_band(atrous_out, taa_history.astype(jnp.float32), config, axis)
    else:
        rgb = jnp.clip(atrous_out[..., :3], 0.0, 1.0)
        final = jnp.concatenate([to_srgb(rgb), jnp.ones((hs, w, 1))], axis=-1)

    new_gbuf = jax.tree.map(
        lambda x: x.astype(sdtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, gbuf
    )
    return (
        radiance,
        tres.color,
        moments_out,
        atrous_out,
        final,
        feedback.astype(sdtype),
        tres.moments.astype(sdtype),
        tres.history_len,
        final.astype(sdtype),
        new_gbuf,
    )


def make_sharded_step(config: RenderConfig, mesh: Mesh):
    """Build a jitted sharded frame step: (scene, state) -> (outputs, state).

    State image leaves are row-sharded over the mesh; the scene is
    replicated. Donation gives in-place ping-pong behavior per chip.
    """
    axis = mesh.axis_names[0]
    rep = P()
    rows = P(axis)

    gbuf_specs = GBuffer(*([rows] * 9))

    body = functools.partial(_frame_body, config=config, axis=axis)
    smapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rows, rows, rows, rows, gbuf_specs, rep),
        out_specs=(rows, rows, rows, rows, rows, rows, rows, rows, rows, gbuf_specs),
        check_vma=False,
    )

    def step(scene, state: TemporalState):
        (radiance, temporal, moments_f, atrous, final,
         color_s, moments_s, history_s, taa_s, gbuf_s) = smapped(
            scene, state.color, state.moments, state.history_len,
            state.taa_history, state.gbuffer, state.frame_idx,
        )
        new_state = TemporalState(
            color=color_s, moments=moments_s, history_len=history_s,
            taa_history=taa_s, gbuffer=gbuf_s, frame_idx=state.frame_idx + 1,
        )
        outputs = FrameOutputs(
            image=final[..., :3], radiance=radiance, temporal=temporal,
            moments_filtered=moments_f, atrous=atrous, final=final[..., :3],
            gbuffer=gbuf_s,
        )
        return outputs, new_state

    return jax.jit(step, donate_argnums=(1,))


def render_frame_sharded(scene, state: TemporalState, config: RenderConfig, mesh: Mesh):
    return make_sharded_step(config, mesh)(scene, state)


def make_train_step(
    config: RenderConfig,
    mesh: Mesh,
    param_fields: tuple = ("mat_colour", "mat_emission"),
):
    """Differentiable sharded step: gradient of an image loss w.r.t. any
    SceneArrays leaves named in `param_fields` (replicated params —
    shard_map's backward inserts the cross-chip psum for them automatically,
    the DP grad-sync analogue).

    Differentiable groups (north star: materials, lights, CAMERA):
      materials — "mat_colour", "mat_emission", "mat_roughness", ...
      lights    — "mat_emission" (area lights are emissive materials),
                  "env_emission"
      camera    — "cam_frame" (ray generation render/gbuffer.py:27 is smooth;
                  discrete hit ids are constants per SURVEY §7.1)
    """
    step = make_sharded_step(config, mesh)

    def loss_fn(params, scene, state, target):
        scene = dataclasses.replace(scene, **params)
        out, new_state = step(scene, state)
        return jnp.mean((out.final - target) ** 2), new_state

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def train_step(params, scene, state, target):
        (loss, new_state), grads = grad_fn(params, scene, state, target)
        return loss, grads, new_state

    return jax.jit(train_step)


def init_params(scene, param_fields: tuple = ("mat_colour", "mat_emission")):
    """Extract the trainable leaves for make_train_step."""
    return {f: getattr(scene, f) for f in param_fields}
