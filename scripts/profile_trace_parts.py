"""Microbenchmark the trace-stage building blocks on the GPU.

Times each component of a bounce (intersect, shading-point eval, light
sampling, BSDF eval, RNG draws) in isolation at a fixed lane count: K
iterations inside one jit (each perturbs its input so XLA cannot hoist the
work), block_until_ready as the completion barrier.

Usage: python scripts/profile_trace_parts.py [R] [K]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    from svgf_jax.utils.device import card_line, require_gpu
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    require_gpu()
    print(card_line())

    from svgf_jax.ops import bsdf as B
    from svgf_jax.ops import intersect as I
    from svgf_jax.ops.lights import sample_lights, sample_lights_pdf_from_hit
    from svgf_jax.ops.sampling import RngStream
    from svgf_jax.render.gbuffer import camera_rays
    from svgf_jax.render.pathtrace import _shading_point
    from svgf_jax.scenes.cornell import cornell_box

    R = int(sys.argv[1]) if len(sys.argv) > 1 else 1920 * 1080 // 8
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    print(f"devices: {jax.devices()}  R={R}  K={K}")

    scene = cornell_box()
    scene.cameras[0].aspect = 16 / 9
    arrays = scene.flatten()
    h = max(R // 1920, 1)
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, 1920)
    ro, rd = ro[:R], rd[:R]
    if ro.shape[0] < R:
        reps = -(-R // ro.shape[0])
        ro = jnp.tile(ro, (reps, 1))[:R]
        rd = jnp.tile(rd, (reps, 1))[:R]
    key = jax.random.key(0)
    ids = jnp.arange(R, dtype=jnp.uint32)

    hit0 = jax.jit(lambda ro, rd: I.intersect_scene(arrays, ro, rd))(ro, rd)
    jax.block_until_ready(hit0)

    def timed(name, make_body, x0):
        """make_body: v -> v (same shape); K reps inside one jit."""
        f = jax.jit(
            lambda x: jax.lax.fori_loop(0, K, lambda i, v: make_body(v), x)
        )
        jax.block_until_ready(f(x0))
        best = 1e9
        for _ in range(6):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x0))
            best = min(best, time.perf_counter() - t0)
        print(f"{name:38s} {best / K * 1e3:9.3f} ms/iter", flush=True)

    # 1. intersect — perturb origin each iter to defeat CSE
    def isect(v):
        hit = I.intersect_scene(arrays, ro + v[:, None] * 1e-6, rd)
        return hit.dist
    timed("intersect_scene (dense)", isect, jnp.zeros((R,)))

    def isect_masked(v):
        act = v > 0.5  # all False
        hit = I.intersect_scene(arrays, ro + v[:, None] * 1e-6, rd, active=act)
        return hit.dist
    timed("intersect_scene (all-inactive)", isect_masked, jnp.zeros((R,)))

    # 2. shading point (gathers + material eval)
    def shade(v):
        h2 = hit0._replace(dist=hit0.dist + v * 1e-6)
        sh = _shading_point(arrays, h2, -rd)
        return sh.position[:, 0] + sh.normal[:, 1] + sh.mp.colour[:, 0]
    timed("_shading_point", shade, jnp.zeros((R,)))

    # 3. light sampling
    def lights(v):
        rng = RngStream(key, ids)
        pos = ro + rd * (hit0.dist * 0.5 + v)[:, None]
        d = sample_lights(arrays, pos, rng.uniform((R,)), rng.uniform((R,)),
                          rng.uniform2((R,)))
        return d[:, 0]
    timed("sample_lights", lights, jnp.zeros((R,)))

    def lights_pdf(v):
        pos = ro + rd * (hit0.dist * 0.5 + v)[:, None]
        p = sample_lights_pdf_from_hit(arrays, pos, rd, hit0)
        return p
    timed("sample_lights_pdf_from_hit", lights_pdf, jnp.zeros((R,)))

    # 4. BSDF eval+sample+pdf
    sh = jax.jit(lambda h, d: _shading_point(arrays, h, -d))(hit0, rd)
    jax.block_until_ready(sh)
    mt = arrays.meta.mat_types_used

    def bsdf(v):
        rng = RngStream(key, ids)
        d = B.sample_bsdf_cos(sh.mp, sh.normal, -rd, rng.uniform((R,)),
                              rng.uniform2((R,)), mt)
        e = B.eval_bsdf_cos(sh.mp, sh.normal, -rd, d, mt)
        p = B.sample_bsdf_cos_pdf(sh.mp, sh.normal, -rd, d, mt)
        return e[:, 0] + p + v * 0.0
    timed("bsdf sample+eval+pdf", bsdf, jnp.zeros((R,)))

    # 5. rng draws (12 per bounce-ish)
    def rngs(v):
        rng = RngStream(key, ids)
        acc = v
        for _ in range(6):
            acc = acc + rng.uniform((R,))
        return acc
    timed("12x rng uniform draws", rngs, jnp.zeros((R,)))

    # 6. one full MIS bounce (everything above composed, incl. 2 traces)
    from svgf_jax.render.pathtrace import PathState, _bounce_mis

    def bounce(v):
        st = PathState(
            radiance=jnp.zeros((R, 3)), weight=jnp.ones((R, 3)),
            active=jnp.ones((R,), bool), use_mis=jnp.zeros((R,), bool),
            ro=ro + v[:, None] * 1e-6, rd=rd,
            in_volume=jnp.zeros((R,), bool), vol_density=jnp.zeros((R, 3)),
            vol_scattering=jnp.zeros((R, 3)), vol_anisotropy=jnp.zeros((R,)),
        )
        rng = RngStream(key, ids)
        st2, _, _, _ = _bounce_mis(arrays, st, hit0, rng, 1)
        return st2.radiance[:, 0]
    timed("one full MIS bounce", bounce, jnp.zeros((R,)))


if __name__ == "__main__":
    main()
