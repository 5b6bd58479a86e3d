"""Trace-stage profiling on the GPU.

Sweeps trace_chunks (the serial lax.map wavefront split) and isolates the
G-buffer pass vs the path-trace bounces at 1080p on the Cornell box.
Methodology matches bench.py (block_until_ready, min of reps).

Usage: python scripts/profile_trace.py [chunks ...]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.render.gbuffer import raster_gbuffer
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState
    from svgf_jax.scenes.cornell import cornell_box

    from svgf_jax.utils.device import card_line, require_gpu
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    require_gpu()
    print(card_line())

    w, h = 1920, 1080
    chunk_list = [int(a) for a in sys.argv[1:]] or [32, 8, 4, 2, 1]
    print(f"devices: {jax.devices()}  frame: {w}x{h}")

    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    arrays = scene.flatten()

    def timeit(step, state, reps=3):
        state = jax.block_until_ready(step(state))
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            state = jax.block_until_ready(step(state))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    for nc in chunk_list:
        cfg = RenderConfig(
            width=w, height=h,
            tracing=TracingConfig(batch=1, bounces=3, clamp=10.0),
            svgf=SVGFConfig(spatial_filter_steps=0, enable_taa=False),
            trace_chunks=nc,
            state_dtype="float16",
            keep_taps=False,
        )

        def trace_only(st, cfg=cfg):
            out, new = render_frame(arrays, st, cfg)
            return new

        step = jax.jit(trace_only, donate_argnums=(0,))
        print(f"compiling trace_chunks={nc} ...", flush=True)
        t0 = time.perf_counter()
        ms = timeit(step, TemporalState.initial(h, w, jnp.float16))
        print(f"  trace_chunks={nc}: {ms:8.2f} ms  (compile+run total "
              f"{time.perf_counter()-t0:.0f}s)", flush=True)

    # G-buffer alone (best chunk count from above sweep applies similarly)
    for nc in (chunk_list[-1],):
        gb = jax.jit(lambda: raster_gbuffer(arrays, 0, h, w, num_chunks=nc))
        jax.block_until_ready(gb())
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(gb())
            best = min(best, time.perf_counter() - t0)
        print(f"gbuffer alone (chunks={nc}): {best*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
