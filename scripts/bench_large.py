"""Large-scene benchmark: the scene-BVH intersector (ops.intersect
.traverse_scene_bvh) on a 100k+ triangle scene.

Reports Mrays/s for 1080p primary rays (coherent) and a hemisphere-scrambled
bounce-style batch (incoherent), plus a correctness check of a random ray
subsample against float64 numpy ground truth. Writes one JSON line.

Usage: python scripts/bench_large.py [n]   (default n=230 -> 104,882 tris)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(n: int = 230, reps: int = 5) -> dict:
    """Build the stress terrain, measure the scene intersector, return the
    result dict (called in-process by bench.py)."""
    import jax
    import jax.numpy as jnp

    from svgf_jax.render.gbuffer import camera_rays
    from svgf_jax.ops.intersect import intersect_scene
    from svgf_jax.scenes.stress import stress_scene

    w, h = 1920, 1080
    t0 = time.time()
    sc = stress_scene(n=n, aspect=w / h)
    arr = sc.flatten()
    log(f"scene: {arr.meta.n_world_tris} world tris, "
        f"{arr.wbvh_skip.shape[0]} scene-BVH nodes "
        f"(built in {time.time()-t0:.1f}s)")

    ro, rd = camera_rays(arr.cam_frame[0], arr.cam_proj[0], h, w)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    R = ro.shape[0]

    fn = jax.jit(lambda a, o, d: intersect_scene(a, o, d).dist)
    log("compiling primary intersect...")
    t0 = time.time()
    dist = jax.block_until_ready(fn(arr, ro, rd))
    log(f"compile+first run: {time.time()-t0:.1f}s")
    best = 1e9
    for _ in range(reps):
        t1 = time.perf_counter()
        dist = jax.block_until_ready(fn(arr, ro, rd))
        best = min(best, time.perf_counter() - t1)
    mrays_primary = R / best / 1e6
    log(f"primary: {best*1e3:.2f} ms for {R/1e6:.2f} Mrays "
        f"-> {mrays_primary:.1f} Mrays/s")

    # incoherent batch: same origins, directions scrambled across the frame
    # (a pessimistic stand-in for post-bounce rays)
    key = jax.random.key(0)
    perm = jax.random.permutation(key, R)
    hitp = ro + rd * jnp.minimum(dist, 10.0)[:, None]
    rd2 = rd[perm]
    ro2 = hitp - rd2 * 0.0  # origins at first-hit points, scrambled dirs
    best2 = 1e9
    jax.block_until_ready(fn(arr, ro2, rd2))
    for _ in range(3):
        t1 = time.perf_counter()
        jax.block_until_ready(fn(arr, ro2, rd2))
        best2 = min(best2, time.perf_counter() - t1)
    mrays_scrambled = R / best2 / 1e6
    log(f"scrambled: {best2*1e3:.2f} ms -> {mrays_scrambled:.1f} Mrays/s")

    # correctness: 512-ray random subsample vs float64 numpy ground truth
    idx = np.random.default_rng(0).choice(R, 512, replace=False)
    sub_d = np.asarray(dist)[idx]
    w9 = np.asarray(arr.world_tris9, np.float64)
    wi = np.asarray(arr.world_tri_inst)
    o64 = np.asarray(ro)[idx].astype(np.float64)
    d64 = np.asarray(rd)[idx].astype(np.float64)
    v0, v1, v2 = w9[0:3].T, w9[3:6].T, w9[6:9].T
    e1, e2 = v1 - v0, v2 - v0
    hh = np.cross(d64[:, None, :], e2[None])
    a = (e1[None] * hh).sum(-1)
    par = np.abs(a) < 1e-12
    f = 1.0 / np.where(par, 1.0, a)
    s = o64[:, None, :] - v0[None]
    u = f * (s * hh).sum(-1)
    q = np.cross(s, e1[None])
    v = f * (q * d64[:, None, :]).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    hit = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    hit &= (wi >= 0)[None]
    ref = np.where(hit, t, 1e30).min(axis=1)
    hits = ref < 1e29
    agree = ((sub_d < 1e29) == hits).mean()
    rel = np.abs(sub_d[hits] - ref[hits]) / ref[hits]
    log(f"correctness: hit agreement {agree*100:.2f}%, "
        f"max rel dist err {rel.max():.2e}")

    return {
        "metric": "scene_bvh_intersect_1080p",
        "tris": int(arr.meta.n_world_tris),
        "mrays_per_s_primary": mrays_primary,
        "mrays_per_s_scrambled": mrays_scrambled,
        "hit_agreement": float(agree),
        "max_rel_dist_err": float(rel.max()),
    }


def main():
    from svgf_jax.utils.device import card_line, device_record, require_gpu
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    require_gpu()
    log(card_line())
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 230
    print(json.dumps({**run(n), "device": device_record()}))


if __name__ == "__main__":
    main()
