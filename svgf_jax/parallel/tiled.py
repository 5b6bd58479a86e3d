"""2-D tile-mesh image parallelism: shard the frame over a (ty, tx) device
mesh — rows over `ty`, columns over `tx`. The mesh is an algorithmic tile
layout only: every device reaches every other at the same rate (the four
cards of one host are joined all to all by NVLink), so which axis a device
sits on does not matter for bandwidth.

Why 2-D (SURVEY §5): with many devices a pure row mesh leaves thin bands
(135 rows at 1080p on 8) and the a-trous halo (2*step, up to 32 rows) starts
rivaling the band itself; square-ish tiles keep the halo/compute ratio flat.

The stencils run on 2-D halo-extended tiles exchanged via ppermute (rows
first, then columns on the row-extended tile, which carries the corners).
The counter-based RNG (ops.sampling.RngStream) hashes GLOBAL pixel ids, so a
tile renders exactly the pixels the unsharded frame would — tiled output ==
unsharded output (tests/test_sharding.py).

Filters here are the plain stencils of render.svgf, as in the unsharded
and row-mesh paths.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from svgf_jax.config import RenderConfig
from svgf_jax.ops.geometry import to_srgb
from svgf_jax.ops.sampling import RngStream
from svgf_jax.render import svgf
from svgf_jax.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_jax.render.pathtrace import pathtrace_chunked
from svgf_jax.render.types import FrameOutputs, GBuffer, TemporalState


def make_mesh_from_config(mesh_cfg) -> Mesh:
    """MeshConfig -> device mesh: a (ty, tx) tile mesh when tiles_x > 1,
    else the 1-D row mesh (config.py MeshConfig drives real code paths)."""
    from svgf_jax.parallel.sharded import make_row_mesh

    if mesh_cfg.tiles_x > 1:
        return make_tile_mesh(mesh_cfg.tiles_y, mesh_cfg.tiles_x,
                              (mesh_cfg.axis_y, mesh_cfg.axis_x))
    return make_row_mesh(mesh_cfg.tiles_y, mesh_cfg.axis_y)


def make_step_from_config(config: RenderConfig, mesh: Mesh | None = None):
    """Sharded frame step matching the mesh rank: rows (1-D) or 2-D tiles."""
    from svgf_jax.parallel.sharded import make_sharded_step

    if mesh is None:
        mesh = make_mesh_from_config(config.mesh)
    if len(mesh.axis_names) == 2 and mesh.devices.shape[1] > 1:
        return make_tiled_step(config, mesh)
    if len(mesh.axis_names) == 2:
        import numpy as np
        from svgf_jax.parallel.sharded import make_row_mesh
        mesh = Mesh(np.asarray(mesh.devices).reshape(-1), (mesh.axis_names[0],))
    return make_sharded_step(config, mesh)


def make_tile_mesh(tiles_y: int, tiles_x: int,
                   axes: tuple[str, str] = ("ty", "tx")) -> Mesh:
    """Devices laid out (tiles_y, tiles_x) in jax.devices() order."""
    devs = jax.devices()
    n = tiles_y * tiles_x
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    import numpy as np
    return Mesh(np.asarray(devs[:n]).reshape(tiles_y, tiles_x), axes)


def _gather_full(x, ay, ax):
    """Tile -> full image (rows over ay, cols over ax)."""
    x = jax.lax.all_gather(x, ay, axis=0, tiled=True)
    return jax.lax.all_gather(x, ax, axis=1, tiled=True)


def _extend_gbuf(gbuf, ext):
    return gbuf._replace(
        depth=ext(gbuf.depth), depth_deriv=ext(gbuf.depth_deriv),
        normal=ext(gbuf.normal), position=ext(gbuf.position),
        motion=ext(gbuf.motion), uv=ext(gbuf.uv),
        instance=ext(gbuf.instance), prim=ext(gbuf.prim),
        material=ext(gbuf.material),
    )


def _band_depth_deriv(z, ay, ax):
    """Tile-exact depth derivative: forward differences with the neighbor
    tile's first row/column ("edge" at the true image border reproduces the
    unsharded clamp, render/gbuffer.py:106-109)."""
    from svgf_jax.parallel.halo import with_col_halo, with_row_halo

    ze_r = with_row_halo(z, 1, ay, "edge")[1:]          # (hs+1, ws) self + next row
    dzy = jnp.abs(ze_r[1:] - ze_r[:-1])
    ze_c = with_col_halo(z, 1, ax, "edge")[:, 1:]       # (hs, ws+1)
    dzx = jnp.abs(ze_c[:, 1:] - ze_c[:, :-1])
    return jnp.maximum(dzx, dzy)


def _frame_body_2d(scene, color, moments, history_len, taa_history, prev_gbuf,
                   frame_idx, config: RenderConfig, ay: str, ax: str):
    """One frame on one (hs, ws) tile. All image args are tile-local."""
    ny = jax.lax.axis_size(ay)
    nx = jax.lax.axis_size(ax)
    iy = jax.lax.axis_index(ay)
    ix = jax.lax.axis_index(ax)
    h_total, w_total = config.height, config.width
    hs, ws = h_total // ny, w_total // nx
    row0, col0 = iy * hs, ix * ws
    cam = config.tracing.current_camera
    sdtype = jnp.dtype(config.state_dtype)

    gbuf = raster_gbuffer(scene, cam, hs, ws, row0=row0, h_total=h_total,
                          col0=col0, w_total=w_total)
    gbuf = gbuf._replace(depth_deriv=jnp.where(
        gbuf.depth > 0.0, _band_depth_deriv(gbuf.depth, ay, ax), 0.0
    ))

    # global lane ids (rows of the full image) — RNG == unsharded
    rr = jax.lax.broadcasted_iota(jnp.uint32, (hs, ws), 0) + jnp.uint32(row0)
    cc = jax.lax.broadcasted_iota(jnp.uint32, (hs, ws), 1) + jnp.uint32(col0)
    lane_ids = (rr * jnp.uint32(w_total) + cc).reshape(-1)

    key = jax.random.fold_in(jax.random.key(config.seed), frame_idx)
    radiance = jnp.zeros((hs * ws, 3), jnp.float32)
    for s in range(config.tracing.batch):
        skey = jax.random.fold_in(key, s)
        jstream = RngStream(jax.random.fold_in(skey, 987), lane_ids)
        jitter = jstream.uniform2((hs * ws,)).reshape(hs, ws, 2) * 2 - 1
        ro, rd = camera_rays(scene.cam_frame[cam], scene.cam_proj[cam], hs, ws,
                             jitter=jitter, row0=row0, h_total=h_total,
                             col0=col0, w_total=w_total)
        first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
        sample, _, _nr = pathtrace_chunked(
            scene, ro, rd, skey,
            bounces=config.tracing.bounces, clamp=config.tracing.clamp,
            mode=config.tracing.sampling_mode, first_hit=first_hit,
            num_chunks=config.trace_chunks, lane_ids=lane_ids,
        )
        radiance = radiance + sample / config.tracing.batch
    radiance = radiance.reshape(hs, ws, 3)

    # temporal reprojection: exact gather against the all-gathered previous
    # frame (motion vectors may point anywhere on screen, Filter.cuh:230-232)
    from svgf_jax.parallel.halo import crop_tile_halo, with_tile_halo

    prev_color_full = _gather_full(color.astype(jnp.float32), ay, ax)
    prev_moments_full = _gather_full(moments.astype(jnp.float32), ay, ax)
    prev_history_full = _gather_full(history_len, ay, ax)
    prev_gbuf_full = GBuffer.zeros(1, 1)._replace(
        depth=_gather_full(prev_gbuf.depth.astype(jnp.float32), ay, ax),
        instance=_gather_full(prev_gbuf.instance, ay, ax),
        normal=_gather_full(prev_gbuf.normal.astype(jnp.float32), ay, ax),
        motion=jnp.zeros((h_total, w_total, 2)),
        position=jnp.zeros((h_total, w_total, 3)),
        depth_deriv=jnp.zeros((h_total, w_total)),
        uv=jnp.zeros((h_total, w_total, 2)),
        prim=jnp.zeros((h_total, w_total), jnp.int32),
        material=jnp.zeros((h_total, w_total), jnp.int32),
    )
    tres = svgf.temporal_filter(
        radiance, prev_color_full, gbuf, prev_gbuf_full,
        prev_moments_full, prev_history_full,
        depth_threshold=config.svgf.depth_threshold,
        normal_threshold=config.svgf.normal_threshold,
        history_base_length=config.svgf.history_length,
        row0=row0, col0=col0,
    )

    def run_moments():
        halo = 3
        hs_, ws_ = tres.color.shape[:2]
        if halo >= hs_ or halo >= ws_:
            full_c = _gather_full(tres.color, ay, ax)
            full_m = _gather_full(tres.moments, ay, ax)
            full_h = _gather_full(tres.history_len, ay, ax)
            full_g = jax.tree.map(lambda v: _gather_full(v, ay, ax), gbuf)
            out = svgf.filter_moments(full_c, full_m, full_g, full_h,
                                      config.svgf.phi_colour, config.svgf.phi_normal)
            out = jax.lax.dynamic_slice_in_dim(out, iy * hs_, hs_, axis=0)
            return jax.lax.dynamic_slice_in_dim(out, ix * ws_, ws_, axis=1)
        ext = lambda v: with_tile_halo(v, halo, ay, ax, "zero")
        out = svgf.filter_moments(
            ext(tres.color), ext(tres.moments), _extend_gbuf(gbuf, ext),
            with_tile_halo(jnp.maximum(tres.history_len, 1), halo, ay, ax, "zero"),
            config.svgf.phi_colour, config.svgf.phi_normal,
        )
        return crop_tile_halo(out, halo)

    moments_out = run_moments()

    def run_atrous(img, step):
        halo = 2 * step
        hs_, ws_ = img.shape[:2]
        if halo >= hs_ or halo >= ws_:
            full_i = _gather_full(img, ay, ax)
            full_g = jax.tree.map(lambda v: _gather_full(v, ay, ax), gbuf)
            out = svgf.atrous_iteration(full_i, full_g, step,
                                        config.svgf.phi_colour,
                                        config.svgf.phi_normal)
            out = jax.lax.dynamic_slice_in_dim(out, iy * hs_, hs_, axis=0)
            return jax.lax.dynamic_slice_in_dim(out, ix * ws_, ws_, axis=1)
        ext = lambda v: with_tile_halo(v, halo, ay, ax, "zero")
        out = svgf.atrous_iteration(ext(img), _extend_gbuf(gbuf, ext), step,
                                    config.svgf.phi_colour, config.svgf.phi_normal)
        return crop_tile_halo(out, halo)

    out = moments_out
    feedback = tres.color if config.svgf.spatial_filter_steps == 0 else None
    for i in range(config.svgf.spatial_filter_steps):
        out = run_atrous(out, 1 << i)
        if i == 0:
            feedback = out
    atrous_out = out

    if config.svgf.enable_taa:
        ext_e = lambda v: with_tile_halo(v, 1, ay, ax, "edge")
        final = crop_tile_halo(
            svgf.taa(ext_e(atrous_out), ext_e(taa_history.astype(jnp.float32))), 1
        )
    else:
        rgb = jnp.clip(atrous_out[..., :3], 0.0, 1.0)
        final = jnp.concatenate([to_srgb(rgb), jnp.ones((hs, ws, 1))], axis=-1)

    new_gbuf = jax.tree.map(
        lambda x: x.astype(sdtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        gbuf,
    )
    return (
        radiance, tres.color, moments_out, atrous_out, final,
        feedback.astype(sdtype), tres.moments.astype(sdtype), tres.history_len,
        final.astype(sdtype), new_gbuf,
    )


def make_tiled_step(config: RenderConfig, mesh: Mesh):
    """Jitted 2-D-tiled frame step: (scene, state) -> (outputs, state).

    State image leaves are (ty, tx)-sharded; the scene is replicated."""
    ay, ax = mesh.axis_names
    rep = P()
    tiles = P(ay, ax)
    gbuf_specs = GBuffer(*([tiles] * 9))

    body = functools.partial(_frame_body_2d, config=config, ay=ay, ax=ax)
    smapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, tiles, tiles, tiles, tiles, gbuf_specs, rep),
        out_specs=(tiles,) * 9 + (gbuf_specs,),
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


def make_tiled_train_step(
    config: RenderConfig,
    mesh: Mesh,
    param_fields: tuple = ("mat_colour", "mat_emission"),
):
    """Differentiable 2-D-tiled step (DP grad-sync analogue over BOTH axes:
    shard_map's backward inserts the psum across the whole mesh)."""
    step = make_tiled_step(config, mesh)

    def loss_fn(params, scene, state, target):
        scene = dataclasses.replace(scene, **params)
        out, new_state = step(scene, state)
        return jnp.mean((out.final - target) ** 2), new_state

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def train_step(params, scene, state, target):
        (loss, new_state), grads = grad_fn(params, scene, state, target)
        return loss, grads, new_state

    return jax.jit(train_step)
