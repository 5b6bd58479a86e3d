"""Quantitative gallery parity (VERDICT r3 item 8): pose a camera to match
`reference/resources/Gallery/BaseSceneDenoised.png`, render through the full
pipeline, and report SSIM/PSNR.

The gallery screenshot was hand-navigated in the reference GUI (PARITY.md),
so the pose is recovered by a two-stage grid search over look_at poses
scored by masked MSE at thumbnail resolution (the transform-gizmo arrows
baked into the screenshot are masked out; the white quad is the real light).
cam_frame is a traced input, so the search reuses ONE compiled render.

Usage: python scripts/gallery_match.py [out_png]
Prints one JSON line with the pose and the SSIM/PSNR numbers.
"""

import dataclasses
import itertools
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

GALLERY = "/root/reference/resources/Gallery/BaseSceneDenoised.png"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.core.camera import look_at_frame
    from svgf_jax.io.binscene import load_reference_scene
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState
    from svgf_jax.utils.image import psnr, read_png, ssim, to_uint8, write_png
    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()

    gal = read_png(GALLERY)[..., :3].astype(np.float32) / 255.0
    gh, gw = gal.shape[:2]
    aspect = gw / gh

    # search resolution (cheap) and report resolution
    sw, sh = 192, 112
    rw, rh = 858, 500

    scene = load_reference_scene("/root/reference/resources/Scenes/BaseScene")
    scene.cameras[0].aspect = aspect
    arrays = scene.flatten()

    def gal_at(w, h):
        ys = (np.arange(h) + 0.5) * gh / h
        xs = (np.arange(w) + 0.5) * gw / w
        return gal[ys.astype(int)][:, xs.astype(int)]

    def mask_at(w, h):
        """True where comparable: exclude the gizmo-arrow overlay box."""
        m = np.ones((h, w), bool)
        y0, y1 = 0, int(0.075 * h)
        x0, x1 = int(0.39 * w), int(0.53 * w)
        m[y0:y1, x0:x1] = False
        return m

    def make_step(w, h):
        cfg = RenderConfig(
            width=w, height=h, state_dtype="float32",
            tracing=TracingConfig(bounces=3, batch=1),
            svgf=SVGFConfig(spatial_filter_steps=5),
        )

        def render(cam_frame):
            arr = dataclasses.replace(
                arrays, cam_frame=arrays.cam_frame.at[0].set(cam_frame),
                cam_prev_frame=arrays.cam_prev_frame.at[0].set(cam_frame),
            )
            st = TemporalState.initial(h, w, jnp.float32)
            for _ in range(3):   # temporal warm-up, static camera
                out, st = render_frame(arr, st, cfg)
            return out.final[..., :3]

        return jax.jit(render)

    step = make_step(sw, sh)
    target_s = gal_at(sw, sh)
    mask_s = mask_at(sw, sh)[..., None]

    def score(frame):
        img = np.asarray(step(jnp.asarray(frame, jnp.float32)))
        return float(np.mean(((img - target_s) ** 2) * mask_s))

    # stage 1: coarse orbit grid around the object cluster (the gallery
    # shot is a WIDE view — the cluster fills ~1/3 of the frame height)
    best = (1e9, None, None)
    targets = [(0.4, 0.3, 0.0), (0.8, 0.3, 0.0), (0.6, 0.6, 0.0)]
    n_evals = 0
    for (tx, ty, tz), d, ey, ex in itertools.product(
        targets, (4.5, 6.0, 7.5, 9.0, 11.0), (1.0, 1.8, 2.6), (-1.5, 0.0, 1.5)
    ):
        eye = [tx + ex, ey, tz + d]
        f = look_at_frame(eye=eye, target=[tx, ty, tz])
        s = score(f)
        n_evals += 1
        if s < best[0]:
            best = (s, eye, [tx, ty, tz])
            log(f"stage1 best {s:.5f} eye={eye} target={[tx, ty, tz]}")

    # stage 2: local refinement around the stage-1 winner
    s0, eye0, tgt0 = best
    for de in itertools.product((-0.5, 0.0, 0.5), repeat=3):
        for dt in itertools.product((-0.25, 0.0, 0.25), repeat=2):
            eye = [eye0[0] + de[0], eye0[1] + de[1], eye0[2] + de[2]]
            tgt = [tgt0[0] + dt[0], tgt0[1] + dt[1], tgt0[2]]
            f = look_at_frame(eye=eye, target=tgt)
            s = score(f)
            n_evals += 1
            if s < best[0]:
                best = (s, eye, tgt)
                log(f"stage2 best {s:.5f} eye={eye} target={tgt}")

    s_best, eye, tgt = best
    log(f"search done: {n_evals} renders, masked MSE {s_best:.5f}")

    # final render + metrics at report resolution
    frame = look_at_frame(eye=eye, target=tgt)
    step_r = make_step(rw, rh)
    img = np.asarray(step_r(jnp.asarray(frame, jnp.float32)))
    target_r = gal_at(rw, rh)
    m = mask_at(rw, rh)
    img_m = img * m[..., None]
    tgt_m = target_r * m[..., None]
    out_png = sys.argv[1] if len(sys.argv) > 1 else "gallery_match.png"
    write_png(out_png, to_uint8(img))

    result = {
        "metric": "gallery_parity_basescene",
        "eye": [round(v, 3) for v in eye],
        "target": [round(v, 3) for v in tgt],
        "ssim_masked": round(ssim(img_m, tgt_m), 4),
        "psnr_masked_db": round(psnr(img_m, tgt_m), 2),
        "render": out_png,
        "report_resolution": [rw, rh],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
