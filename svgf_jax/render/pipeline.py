"""Frame pipeline — the orchestrator (reference application::Render, App.cu:539-690).

One pure function `render_frame(scene, state, config) -> (FrameOutputs,
TemporalState)` runs the six reference stages:

    Rasterize -> Trace -> TemporalFilter -> FilterMoments -> WaveletFilter -> TAA

with the reference's exact data flow, including the iteration-0 wavelet
feedback into next frame's temporal history (Filter.cuh:619-622) and the
steps==0 case where the temporal output itself is the feedback.

`Renderer` wraps it with jit + donated state (the ping-pong buffers of
App.cu:374 become donated pytree leaves).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from svgf_jax.config import DebugOutput, RenderConfig
from svgf_jax.ops.geometry import to_srgb
from svgf_jax.ops.sampling import RngStream
from svgf_jax.render import svgf
from svgf_jax.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_jax.render.pathtrace import pathtrace_chunked
from svgf_jax.render.types import FrameMetrics, FrameOutputs, TemporalState


def filter_chain(radiance, gbuf, state: TemporalState, config: RenderConfig):
    """Stages 3-6 of the reference pipeline (TemporalFilter -> FilterMoments
    -> WaveletFilter -> TAA, App.cu:469-522) on one frame's radiance.

    This is THE filter code path — render_frame and bench.py both call it,
    so the benchmark always measures what the pipeline runs. Returns
    (temporal_result, moments_out, atrous_out, final, feedback) where
    `feedback` is what goes back into next frame's temporal history
    (a-trous iteration 0, Filter.cuh:619-622).
    """
    h, w = radiance.shape[:2]

    # ---- 3. Temporal filter ----
    with jax.named_scope("temporal"):
        tres = svgf.temporal_filter(
            radiance,
            state.color.astype(jnp.float32),
            gbuf,
            state.gbuffer,
            state.moments.astype(jnp.float32),
            state.history_len,
            depth_threshold=config.svgf.depth_threshold,
            normal_threshold=config.svgf.normal_threshold,
            history_base_length=config.svgf.history_length,
        )

    # ---- 4. Spatial moments fallback ----
    with jax.named_scope("filter_moments"):
        moments_out = svgf.filter_moments(
            tres.color, tres.moments, gbuf, tres.history_len,
            config.svgf.phi_colour, config.svgf.phi_normal,
        )

    # ---- 5. A-trous wavelet chain ----
    steps = svgf.wavelet_steps(config.svgf.spatial_filter_steps)
    with jax.named_scope("wavelet"):
        if steps:
            atrous_out, feedback = svgf.atrous_chain(
                moments_out, gbuf, steps,
                config.svgf.phi_colour, config.svgf.phi_normal,
            )
        else:
            # steps==0: RenderBuffer keeps the temporal output (no
            # iteration-0 write)
            atrous_out, feedback = moments_out, tres.color

    # ---- 6. TAA + sRGB (the main path's tonemap) ----
    with jax.named_scope("taa"):
        if config.svgf.enable_taa:
            final = svgf.taa(atrous_out, state.taa_history.astype(jnp.float32))
        else:
            rgb = jnp.clip(atrous_out[..., :3], 0.0, 1.0)
            final = jnp.concatenate(
                [to_srgb(rgb), jnp.ones((h, w, 1), jnp.float32)], axis=-1
            )

    return tres, moments_out, atrous_out, final, feedback


def render_frame(scene, state: TemporalState, config: RenderConfig):
    h, w = config.height, config.width
    cam = config.tracing.current_camera
    sdtype = jnp.dtype(config.state_dtype)

    # ---- 1. Rasterize (primary visibility) ----
    with jax.named_scope("gbuffer"):
        gbuf = raster_gbuffer(scene, cam, h, w, num_chunks=config.trace_chunks)

    # ---- 2. Trace (1spp x batch path tracing) ----
    key = jax.random.fold_in(jax.random.key(config.seed), state.frame_idx)
    radiance = jnp.zeros((h * w, 3), jnp.float32)
    rays_traced = jnp.asarray(h * w, jnp.int32)  # the G-buffer primary pass
    with jax.named_scope("trace"):
        for s in range(config.tracing.batch):
            skey = jax.random.fold_in(key, s)
            jstream = RngStream(
                jax.random.fold_in(skey, 987),
                jnp.arange(h * w, dtype=jnp.uint32),
            )
            jitter = jstream.uniform2((h * w,)).reshape(h, w, 2) * 2.0 - 1.0
            ro, rd = camera_rays(
                scene.cam_frame[cam], scene.cam_proj[cam], h, w, jitter=jitter
            )
            first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
            sample, _, nr = pathtrace_chunked(
                scene,
                ro,
                rd,
                skey,
                bounces=config.tracing.bounces,
                clamp=config.tracing.clamp,
                mode=config.tracing.sampling_mode,
                first_hit=first_hit,
                num_chunks=config.trace_chunks,
            )
            radiance = radiance + sample / config.tracing.batch
            rays_traced = rays_traced + nr
    radiance = radiance.reshape(h, w, 3)

    taps = config.keep_taps or config.debug_output != DebugOutput.FINAL
    tres, moments_out, atrous_out, final, feedback = filter_chain(
        radiance, gbuf, state, config
    )
    new_state = TemporalState(
        color=feedback.astype(sdtype),
        moments=tres.moments.astype(sdtype),
        history_len=tres.history_len,
        taa_history=final.astype(sdtype),
        gbuffer=jax.tree.map(
            lambda x: x.astype(sdtype)
            if jnp.issubdtype(x.dtype, jnp.floating)
            else x,
            gbuf,
        ),
        frame_idx=state.frame_idx + 1,
    )
    image = _select_tap(config.debug_output, radiance, tres, moments_out,
                        atrous_out, final, gbuf)
    # structured per-frame metrics (SURVEY §5 observability).
    # rays_traced is MEASURED: active lanes of every intersect
    # invocation, accumulated inside the trace (render/pathtrace.py)
    # + the primary pass.
    metrics = FrameMetrics(
        disoccluded_pct=100.0
        * (1.0 - jnp.mean(tres.reprojected.astype(jnp.float32))),
        mean_history=jnp.mean(tres.history_len.astype(jnp.float32)),
        mean_variance=jnp.mean(tres.color[..., 3]),
        coverage_pct=100.0
        * jnp.mean((gbuf.instance >= 0).astype(jnp.float32)),
        rays_traced=rays_traced,
    )

    outputs = FrameOutputs(
        image=image,
        radiance=radiance if taps else None,
        temporal=tres.color if taps else None,
        moments_filtered=moments_out if taps else None,
        atrous=atrous_out if taps else None,
        final=final[..., :3],
        gbuffer=gbuf if taps else None,
        metrics=metrics,
    )
    return outputs, new_state


def _select_tap(tap: DebugOutput, radiance, tres, moments_out, atrous_out, final, gbuf):
    """Debug render-graph taps (reference SVGFDebugOutputEnum, App.h:92-105)."""
    if tap == DebugOutput.FINAL:
        return final[..., :3]
    if tap == DebugOutput.RAW:
        return radiance
    if tap == DebugOutput.NORMAL:
        return gbuf.normal * 0.5 + 0.5
    if tap == DebugOutput.MOTION:
        m = gbuf.motion
        return jnp.concatenate([jnp.abs(m), jnp.zeros(m.shape[:-1] + (1,))], -1)
    if tap == DebugOutput.POSITION:
        return gbuf.position
    if tap == DebugOutput.BARYCENTRIC:
        u, v = gbuf.uv[..., 0], gbuf.uv[..., 1]
        return jnp.stack([u, v, 1.0 - u - v], -1)
    if tap == DebugOutput.TEMPORAL:
        return tres.color[..., :3]
    if tap == DebugOutput.ATROUS:
        return atrous_out[..., :3]
    if tap == DebugOutput.MOMENTS:
        m = tres.moments
        return jnp.concatenate([m, jnp.zeros(m.shape[:-1] + (1,))], -1)
    if tap == DebugOutput.VARIANCE:
        return jnp.repeat(tres.color[..., 3:4], 3, axis=-1)
    if tap == DebugOutput.DEPTH:
        d = gbuf.depth / jnp.maximum(jnp.max(gbuf.depth), 1e-6)
        return jnp.repeat(d[..., None], 3, axis=-1)
    raise ValueError(f"unknown tap {tap}")


class Renderer:
    """Stateful convenience wrapper: owns the flattened scene + jitted step.

    The reference `application` singleton's per-frame loop (App.cu:692-734)
    becomes: `out, _ = renderer.step()` per frame; camera updates go through
    `renderer.update_camera(frame)` (PreviousFrame handling matches
    EndFrame, App.cu:372).
    """

    def __init__(self, scene, config: RenderConfig):
        self.scene = scene
        self.config = config
        for cam in scene.cameras:
            cam.aspect = config.width / config.height
        self.arrays = scene.flatten()
        self.state = TemporalState.initial(
            config.height, config.width, jnp.dtype(config.state_dtype)
        )
        self._step = jax.jit(
            functools.partial(render_frame, config=config), donate_argnums=(1,)
        )

    def update_camera(self, new_frame, index: int | None = None):
        idx = self.config.tracing.current_camera if index is None else index
        cam = self.scene.cameras[idx].advance(new_frame)
        self.scene.cameras[idx] = cam
        self.arrays = dataclasses.replace(
            self.arrays,
            cam_frame=self.arrays.cam_frame.at[idx].set(jnp.asarray(cam.frame)),
            cam_prev_frame=self.arrays.cam_prev_frame.at[idx].set(
                jnp.asarray(cam.previous_frame)
            ),
        )

    # ---- incremental scene edits (core.edits; reference BVH.cpp:491-583,
    # Scene.cpp:447-451, AssetLoader.cpp:11-55) ----

    def update_material(self, index: int, material) -> None:
        from svgf_jax.core.edits import update_material

        self.arrays = update_material(self.scene, self.arrays, index, material)

    def update_instance_transform(self, index: int, transform) -> None:
        from svgf_jax.core.edits import update_instance_transform

        self.arrays = update_instance_transform(
            self.scene, self.arrays, index, transform
        )

    def add_asset(self, path: str) -> None:
        from svgf_jax.core.edits import add_asset

        self.scene, self.arrays = add_asset(self.scene, path)

    def step(self) -> FrameOutputs:
        out, self.state = self._step(self.arrays, self.state)
        return out

    def render_sequence(self, camera_frames) -> list:
        """Offline driver loop: render one frame per camera pose."""
        outs = []
        for f in camera_frames:
            self.update_camera(f)
            outs.append(self.step())
        return outs
