"""Per-stage filter-chain profiling on the GPU.

Times each SVGF stage in isolation (block_until_ready, min of reps — same
methodology as bench.py) so the hotspot is always visible. Mirrors the
reference's per-frame timer prints (App.cu:697-731).

Usage: python scripts/profile_stages.py [height width]
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    from svgf_jax.render import svgf
    from svgf_jax.render.types import GBuffer
    from svgf_jax.utils.device import card_line, require_gpu
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    require_gpu()
    h = int(sys.argv[1]) if len(sys.argv) > 1 else 1080
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 1920
    print(f"{card_line()}  frame: {w}x{h}")

    rng = np.random.default_rng(0)
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    gbuf = GBuffer.zeros(h, w)._replace(
        depth=jnp.asarray(rng.uniform(1.0, 5.0, (h, w)), jnp.float32),
        depth_deriv=jnp.asarray(rng.uniform(1e-4, 1e-2, (h, w)), jnp.float32),
        normal=jnp.asarray(n, jnp.float32),
        instance=jnp.zeros((h, w), jnp.int32),
        motion=jnp.asarray(rng.uniform(-2, 2, (h, w, 2)), jnp.float32),
    )
    img = jnp.asarray(rng.uniform(0, 1, (h, w, 4)), jnp.float32)
    prev_moments = jnp.asarray(rng.uniform(0, 0.5, (h, w, 2)), jnp.float32)
    prev_hist = jnp.asarray(rng.integers(1, 24, (h, w)), jnp.int32)

    # every input is a jit argument: closed-over arrays would become
    # constants that XLA folds at compile time, timing less than the stage
    args = (img, gbuf, prev_moments, prev_hist)

    def report(name, fn, reps=10):
        f = jax.jit(fn)
        jax.block_until_ready(f(*args))   # compile
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            best = min(best, time.perf_counter() - t0)
        print(f"{name:34s} {best * 1e3:8.3f} ms")

    report("temporal (packed gather)", lambda c4, g, pm, ph: svgf.temporal_filter(
        c4[..., :3], c4, g, g, pm, ph, 0.8, 0.9, 24).color)
    report("moments 7x7", lambda c4, g, pm, ph: svgf.filter_moments(
        c4, pm, g, ph, 10.0, 128.0))
    for s in (1, 16):
        report(f"atrous step={s}", lambda c4, g, pm, ph, s=s: svgf.atrous_iteration(
            c4, g, s, 10.0, 128.0))
    report("atrous chain x5", lambda c4, g, pm, ph: svgf.atrous_chain(
        c4, g, svgf.wavelet_steps(5), 10.0, 128.0)[0])
    report("taa", lambda c4, g, pm, ph: svgf.taa(c4, c4))


if __name__ == "__main__":
    main()
