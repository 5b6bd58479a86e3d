"""Measure live-lane imbalance across row-shard bands per bounce
(VERDICT r3 item 7; SURVEY §2.7 names ray load balancing / all_to_all
reshard as a first-class concern — this script produces the evidence for
whether the reshard is needed).

Method: trace the reference BaseScene (or the Cornell box fallback) once,
recording each bounce's post-RR active mask via pathtrace's probe. Split the
mask into the row bands an N-way row mesh would own; report each bounce's
live-lane fraction per band and the imbalance (max-mean)/mean. An
all_to_all reshard pays one full wavefront-state exchange per bounce — only
worth it if imbalance exceeds ~15% while the absolute live fraction is
still high.

Usage: JAX_PLATFORMS=cpu python scripts/measure_balance.py [bands] [h] [w]
Prints one JSON line.
"""

import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    from svgf_jax.render import pathtrace as pt
    from svgf_jax.render.gbuffer import camera_rays
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()

    bands = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 360
    w = int(sys.argv[3]) if len(sys.argv) > 3 else 640
    bounces = 5

    try:
        from svgf_jax.io.binscene import load_reference_scene

        scene = load_reference_scene(
            "/root/reference/resources/Scenes/BaseScene"
        )
        name = "BaseScene"
    except Exception:
        from svgf_jax.scenes import cornell_box

        scene = cornell_box()
        name = "cornell"
    scene.cameras[0].aspect = w / h
    arr = scene.flatten()

    ro, rd = camera_rays(arr.cam_frame[0], arr.cam_proj[0], h, w)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    key = jax.random.key(0)

    def run():
        acc: list = []
        pt.set_active_probe(acc)
        try:
            rad, _, nr = pt.pathtrace(arr, ro, rd, key, bounces=bounces)
        finally:
            pt.set_active_probe(None)
        return rad, jnp.stack(acc)  # (bounces, R) active masks

    rad, masks = jax.jit(run)()
    masks = np.asarray(masks).reshape(bounces, h, w)

    rows_per = h // bands
    per_bounce = []
    for b in range(bounces):
        frac = [
            float(masks[b, k * rows_per : (k + 1) * rows_per].mean())
            for k in range(bands)
        ]
        # the same lanes under the round-robin row interleave the sharded
        # trace uses when config.trace_balance is on (parallel.sharded
        # _interleave_a2a): band k = global rows congruent k (mod bands)
        frac_i = [float(masks[b, k::bands].mean()) for k in range(bands)]
        mean = float(np.mean(frac))
        imb = 0.0 if mean == 0 else (max(frac) - mean) / mean
        imb_i = 0.0 if mean == 0 else (max(frac_i) - mean) / mean
        per_bounce.append(
            {"bounce": b, "live_frac_mean": round(mean, 4),
             "live_frac_per_band": [round(f, 4) for f in frac],
             "imbalance": round(imb, 4),
             "imbalance_interleaved": round(imb_i, 4)}
        )
        print(f"bounce {b}: live {mean*100:5.1f}% "
              f"imbalance banded {imb*100:5.1f}% -> interleaved "
              f"{imb_i*100:5.1f}%", file=sys.stderr)

    worst = max(p["imbalance"] for p in per_bounce)
    worst_i = max(p["imbalance_interleaved"] for p in per_bounce)
    print(json.dumps({
        "metric": "row_shard_live_lane_imbalance",
        "scene": name, "bands": bands, "h": h, "w": w,
        "per_bounce": per_bounce,
        "worst_imbalance": round(worst, 4),
        "worst_imbalance_interleaved": round(worst_i, 4),
    }))


if __name__ == "__main__":
    main()
