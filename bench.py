"""Benchmark: 1080p SVGF denoise (full filter chain) ms/frame on one GPU.

Baseline: the reference claims ~6 ms/frame for the filter stages on an
unspecified NVIDIA GPU (reference README.md:7; BASELINE.md). vs_baseline is
baseline_ms / our_ms (>1 = faster than the reference claim).

What is measured: `svgf_jax.render.pipeline.filter_chain` — the EXACT code
path render_frame runs (temporal -> moments -> 5x a-trous -> TAA) — on a
steady-state orbit frame: a smooth depth/normal G-buffer with depth edges, a
smooth, mostly horizontal orbit-camera motion field (tens of pixels),
previous-frame state matching the current G-buffer (reprojection mostly
valid), history at the cap except a ~3% disoccluded band (history 1-3,
exercising the moments fallback). Then the whole 1080p Cornell frame, the
trace alone, and the 104.9k-triangle stress-scene intersect.

Timing: host clock around work that ends in `block_until_ready`; min and
median of the repetitions after a compile/warm-up call. Runs on a GPU only:
without one it exits non-zero. Prints the card's name and power limit on
stderr and exactly ONE JSON line on stdout.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_dist(fn, *args, reps=10):
    """(min, median) seconds of `reps` calls of fn(*args) after one warm-up.
    Pass every large input as an argument: arrays a jitted function closes
    over become constants that XLA folds at compile time."""
    import jax

    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[0], samples[len(samples) // 2]


def make_bench_inputs(h, w):
    """Steady-state orbit frame: smooth geometry + depth edges + smooth
    motion + warmed-up temporal state."""
    import jax.numpy as jnp

    from svgf_jax.render.types import GBuffer, TemporalState

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w, yy / h

    # smooth depth with a few object edges (instance changes + depth jumps).
    # Instance bands run HORIZONTAL: the mostly-horizontal orbit motion then
    # crosses an instance/depth edge only near the few band boundaries, so
    # the realized temporal-rejection rate stays at the documented ~3-6%
    # (diagonal bands made reprojection cross an edge almost everywhere,
    # silently inflating the moments-fallback share far past the documented
    # disocclusion contract — r5 fix).
    depth = 2.0 + 1.5 * np.sin(3 * u * np.pi) * np.cos(2 * v * np.pi) + v
    instance = (np.floor(6 * v) % 4).astype(np.int32)
    depth = depth + 0.7 * instance
    depth_deriv = np.abs(np.gradient(depth, axis=1)) + 1e-4

    theta = 0.7 * u + 0.2 * v
    nrm = np.stack(
        [np.sin(theta), np.cos(theta), 0.5 + 0.3 * np.sin(5 * v)], axis=-1
    )
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    # orbit-camera motion: mostly-horizontal pan with parallax by depth
    mx = np.trunc(28.0 / depth * (0.8 + 0.4 * u))
    my = np.trunc(4.0 * (v - 0.5))
    motion = np.stack([mx, my], axis=-1).astype(np.float32)

    gbuf = GBuffer.zeros(h, w)._replace(
        depth=jnp.asarray(depth, jnp.float32),
        depth_deriv=jnp.asarray(depth_deriv, jnp.float32),
        normal=jnp.asarray(nrm, jnp.float32),
        instance=jnp.asarray(instance),
        motion=jnp.asarray(motion),
    )

    # history at cap except a disoccluded band (the screen edge revealed by
    # the pan + a moving-object band), ~3% of pixels
    hist = np.full((h, w), 24, np.int32)
    band = slice(int(0.55 * w), int(0.58 * w))
    hist[:, band] = rng.integers(1, 4, (h, hist[:, band].shape[1]))
    radiance = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)

    state = TemporalState.initial(h, w, jnp.float32)._replace(
        color=jnp.asarray(rng.uniform(0, 1, (h, w, 4)), jnp.float32),
        moments=jnp.asarray(rng.uniform(0, 0.5, (h, w, 2)), jnp.float32),
        history_len=jnp.asarray(hist),
        taa_history=jnp.asarray(rng.uniform(0, 1, (h, w, 4)), jnp.float32),
        gbuffer=gbuf,  # previous == current geometry: reprojection validates
    )
    return jnp.asarray(radiance), gbuf, state


# trace-stage wavefront chunks at 1080p (render.pathtrace.pathtrace_chunked)
TRACE_CHUNKS = 8


def main():
    import jax

    from svgf_jax.config import RenderConfig, SVGFConfig
    from svgf_jax.render.pipeline import filter_chain
    from svgf_jax.utils.device import card_line, device_record, require_gpu
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    require_gpu()
    log(card_line())

    w, h = 1920, 1080
    config = RenderConfig(width=w, height=h,
                          svgf=SVGFConfig(spatial_filter_steps=5))
    radiance, gbuf, state = make_bench_inputs(h, w)

    def chain(cfg):
        return jax.jit(lambda v, g, s: filter_chain(v, g, s, cfg)[3][..., :3])

    filter_s, filter_s_med = timed_dist(chain(config), radiance, gbuf, state,
                                        reps=12)
    log(f"filter chain: {filter_s*1e3:.3f} ms/frame min, "
        f"{filter_s_med*1e3:.3f} med (12 reps)")

    stage_ms = {}
    for key, sv in (
        ("temporal_moments_ms", SVGFConfig(spatial_filter_steps=0, enable_taa=False)),
        ("temporal_moments_atrous5_ms", SVGFConfig(spatial_filter_steps=5, enable_taa=False)),
    ):
        cfg = dataclasses.replace(config, svgf=sv)
        stage_ms[key] = timed_dist(chain(cfg), radiance, gbuf, state)[0] * 1e3
        log(f"  {key:28s} {stage_ms[key]:.3f} ms")

    trace_stats = bench_trace(w, h)

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import bench_large

    large = bench_large.run(n=230)

    baseline_ms = 6.0
    filter_ms = filter_s * 1e3
    print(json.dumps({
        "metric": "svgf_denoise_1080p",
        "value": filter_ms,
        "unit": "ms/frame",
        "vs_baseline": baseline_ms / filter_ms,
        "value_median": filter_s_med * 1e3,
        "reps": 12,
        "stages": stage_ms,
        **trace_stats,
        "large_scene": large,
        "device": device_record(),
    }))


def bench_trace(w, h):
    """Time render_frame (all six stages) and the trace stage alone at 1080p
    on the Cornell box; report ms/frame and Mrays/s.

    Mrays/s uses the MEASURED ray count (FrameMetrics.rays_traced: active
    lanes of every intersect invocation accumulated inside the trace), not
    a per-pixel formula.
    """
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState
    from svgf_jax.scenes.cornell import cornell_box

    config = RenderConfig(
        width=w, height=h,
        tracing=TracingConfig(batch=1, bounces=3, clamp=10.0),
        svgf=SVGFConfig(spatial_filter_steps=5),
        trace_chunks=TRACE_CHUNKS,
        state_dtype="float16",
        keep_taps=False,   # perf path: don't keep every stage live (config.py)
    )
    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    arrays = scene.flatten()

    def timed_frames(cfg):
        def frame(st):
            out, new = render_frame(arrays, st, cfg)
            return new, out.metrics.rays_traced

        step = jax.jit(frame, donate_argnums=(0,))
        t0 = time.perf_counter()
        state, nrays = jax.block_until_ready(
            step(TemporalState.initial(h, w, jnp.dtype(cfg.state_dtype))))
        compile_s = time.perf_counter() - t0
        best = 1e9
        for _ in range(7):
            t0 = time.perf_counter()
            state, nrays = jax.block_until_ready(step(state))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3, int(nrays), compile_s

    log("compiling 1080p render_frame (cornell)...")
    frame_ms, _, compile_s = timed_frames(config)
    log(f"render_frame compile+first run: {compile_s:.1f}s")
    cfg_t = dc.replace(
        config, svgf=SVGFConfig(spatial_filter_steps=0, enable_taa=False)
    )
    trace_ms, total_rays, _ = timed_frames(cfg_t)
    mrays = total_rays / (trace_ms * 1e-3) / 1e6
    log(f"1080p frame (6 stages, cornell): {frame_ms:.2f} ms/frame")
    log(f"1080p trace+gbuffer: {trace_ms:.2f} ms  "
        f"({total_rays/1e6:.1f} Mrays measured -> {mrays:.1f} Mrays/s)")
    return {
        "compile_s_render_frame_1080p": compile_s,
        "frame_ms_1080p_cornell": frame_ms,
        "trace_ms_1080p_cornell": trace_ms,
        "mrays_per_s": mrays,
        "rays_per_frame_measured": total_rays,
        "trace_chunks": TRACE_CHUNKS,
    }


if __name__ == "__main__":
    main()
