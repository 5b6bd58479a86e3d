#!/usr/bin/env python
"""Offline orbit-render driver — the replacement for the reference's
interactive GUI loop (App.cu:692-734 + orbit camera CameraController.cpp).

Renders N frames orbiting the scene, writing PNGs of the selected debug tap,
with optional temporal-state checkpointing/resume.

Usage:
  python scripts/render_orbit.py --scene cornell --frames 24 --out /tmp/orbit
  python scripts/render_orbit.py --scene /root/reference/resources/Scenes/BaseScene \
      --width 800 --height 450 --frames 60 --out /tmp/base --resume /tmp/base/ckpt.npz
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--orbit-degrees", type=float, default=45.0)
    ap.add_argument("--out", default="/tmp/orbit")
    ap.add_argument("--tap", default="FINAL")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--config", default=None, help="RenderConfig JSON file")
    args = ap.parse_args()

    from svgf_jax.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()

    from svgf_jax import DebugOutput, RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.core.camera import orbit_frame
    from svgf_jax.io import load_checkpoint, save_checkpoint
    from svgf_jax.render.pipeline import Renderer
    from svgf_jax.utils.image import write_png

    if args.config:
        cfg = RenderConfig.from_json(open(args.config).read())
    else:
        cfg = RenderConfig(
            width=args.width, height=args.height,
            tracing=TracingConfig(bounces=args.bounces),
            svgf=SVGFConfig(spatial_filter_steps=args.steps),
            debug_output=DebugOutput[args.tap],
            # production-loop settings (bench.py-matched): chunked wavefront
            # + no per-stage tap materialization unless a tap was asked for
            trace_chunks=8 if args.width * args.height >= 512 * 512 else 1,
            keep_taps=DebugOutput[args.tap] != DebugOutput.FINAL,
        )

    if args.scene == "cornell":
        from svgf_jax.scenes import cornell_box

        scene = cornell_box(aspect=cfg.width / cfg.height)
        target, distance = np.array([0.0, 0.0, 0.0]), 3.4
    elif args.scene == "default":
        from svgf_jax.scenes import default_scene

        scene = default_scene(aspect=cfg.width / cfg.height)
        target, distance = np.array([0.0, 0.0, 0.0]), 4.0
    else:
        from svgf_jax.io import load_reference_scene

        scene = load_reference_scene(args.scene)
        # orbit around the scene centroid at its current camera distance
        eye = scene.cameras[0].frame[:3, 3]
        target = np.zeros(3)
        distance = float(np.linalg.norm(eye - target))

    os.makedirs(args.out, exist_ok=True)
    r = Renderer(scene, cfg)
    if args.resume and os.path.exists(args.resume):
        r.state = load_checkpoint(args.resume, dtype=cfg.state_dtype)
        print(f"resumed from {args.resume} at frame {int(r.state.frame_idx)}", flush=True)

    start = int(r.state.frame_idx)
    theta0 = 0.0
    for k in range(args.frames):
        f = start + k
        theta = theta0 + np.radians(args.orbit_degrees) * f / max(args.frames, 1)
        r.update_camera(orbit_frame(target, distance, theta=theta, phi=0.15))
        t0 = time.time()
        out = r.step()
        img = np.asarray(out.image)
        dt = time.time() - t0
        write_png(os.path.join(args.out, f"frame_{f:04d}.png"), img)
        print(f"frame {f}: {dt*1000:.1f} ms  mean={img.mean():.4f}", flush=True)

    save_checkpoint(os.path.join(args.out, "ckpt.npz"), r.state)
    print(f"checkpoint saved; resume with --resume {args.out}/ckpt.npz")


if __name__ == "__main__":
    main()
