"""Frame-level pytrees: G-buffer and temporal state.

The reference keeps this state in mutable ping-pong GPU buffers
(App.h:129-150, flipped in EndFrame App.cu:374). Here it is an explicit
functional pytree threaded through `render_frame`; buffer donation restores
the in-place behavior under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GBuffer(NamedTuple):
    """Primary-visibility targets (reference G-buffer, App.cu:746-778).

    Encoding follows the reference:
      depth == 0 marks an invalid/background pixel (GetDepth, Filter.cuh:199-207)
      instance == -1 marks background (reference uses the UV.w clear value)
    """

    position: jax.Array     # (H, W, 3) world-space hit position
    normal: jax.Array       # (H, W, 3) world-space shading-geometry normal
    motion: jax.Array       # (H, W, 2) pixel-space motion vector (prev - cur)
    depth: jax.Array        # (H, W) camera distance; 0 = invalid
    depth_deriv: jax.Array  # (H, W) max |screen-space depth derivative|
    uv: jax.Array           # (H, W, 2) barycentric (u, v) at the hit
    instance: jax.Array     # (H, W) i32; -1 = background
    prim: jax.Array         # (H, W) i32 global triangle id
    material: jax.Array     # (H, W) i32

    @staticmethod
    def zeros(h: int, w: int, dtype=jnp.float32) -> "GBuffer":
        f = lambda c=None: jnp.zeros((h, w) + (() if c is None else (c,)), dtype)
        i = lambda: jnp.full((h, w), -1, jnp.int32)
        return GBuffer(
            position=f(3), normal=f(3), motion=f(2), depth=f(), depth_deriv=f(),
            uv=f(2), instance=i(), prim=i(), material=i(),
        )


class TemporalState(NamedTuple):
    """Cross-frame state (the reference's ping-pong buffer set).

    color:       RenderBuffer of the previous frame — radiance RGB + variance A.
                 NOTE: after a full frame this holds the *iteration-0 a-trous
                 output* (the SVGF temporal-feedback trick, Filter.cuh:619-622).
    moments:     first/second luminance moments (fp16 x2 in the reference).
    history_len: per-pixel EMA history length (u8 in the reference).
    taa_history: previous TAA output (see svgf.taa for the reference's
                 buffer-aliasing quirk).
    gbuffer:     previous frame's G-buffer (for reprojection validity tests).
    frame_idx:   frame counter (feeds the RNG; replaces the reference's
                 wall-clock Time seed, PathTrace.cuh:589).
    """

    color: jax.Array        # (H, W, 4)
    moments: jax.Array      # (H, W, 2)
    history_len: jax.Array  # (H, W) i32 (capped at history_length <= 255)
    taa_history: jax.Array  # (H, W, 4)
    gbuffer: GBuffer
    frame_idx: jax.Array    # () i32

    @staticmethod
    def initial(h: int, w: int, dtype=jnp.float16) -> "TemporalState":
        return TemporalState(
            color=jnp.zeros((h, w, 4), dtype),
            moments=jnp.zeros((h, w, 2), dtype),
            history_len=jnp.zeros((h, w), jnp.int32),
            taa_history=jnp.zeros((h, w, 4), dtype),
            gbuffer=GBuffer.zeros(h, w, dtype),
            frame_idx=jnp.int32(0),
        )


class FrameMetrics(NamedTuple):
    """Structured per-frame observability (SURVEY §5 metrics/logging: the
    reference only has a frame-time print, App.cu:730; these are the
    quantities its GUI debug taps let a human eyeball)."""

    disoccluded_pct: jax.Array   # () f32 — % pixels failing reprojection
    mean_history: jax.Array      # () f32 — mean temporal history length
    mean_variance: jax.Array     # () f32 — mean per-pixel variance estimate
    coverage_pct: jax.Array      # () f32 — % pixels with a primary hit
    rays_traced: jax.Array       # () i32 — scene-intersection count x lanes


class FrameOutputs(NamedTuple):
    """Everything a frame produces — the debug-tap surface (App.h:92-105)."""

    image: jax.Array        # selected tap (sRGB for FINAL)
    radiance: jax.Array     # raw 1spp path-traced radiance (H, W, 3)
    temporal: jax.Array     # after temporal accumulation (H, W, 4) rgb+var
    moments_filtered: jax.Array  # after spatial moments fallback (H, W, 4)
    atrous: jax.Array       # after the wavelet chain (H, W, 4)
    final: jax.Array        # after TAA + sRGB (H, W, 3)
    gbuffer: GBuffer
    metrics: FrameMetrics | None = None
