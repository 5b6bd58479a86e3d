"""Smoke test of the whole system on one NVIDIA GPU (four with --four).

Drives the main path through the entry points a user calls (Renderer,
render_frame, the sharded steps) and checks the results against the plain
references. The path holds no hand-written kernel: every stage is XLA's
compilation of the plain JAX code.

  1. cornell  — the Cornell box at 1920x1080, 1 spp, 3 bounces, 5 a-trous
                iterations, TAA, fp16 state: 4 static and 4 orbit frames
                through Renderer, temporal state carried across;
  2. stress   — the 104,884-triangle stress scene at 1920x1080, 2 frames
                through render_frame; primary hits on 4096 pixels against a
                float64 NumPy brute-force intersection;
  3. filter   — the filter chain at 1920x1080 on bench.py's steady-state
                frame: each stage timed, and the chain checked against the
                composition of its stages;
  4. gradient — one value_and_grad through render_frame over material
                albedo, emission and the camera, one albedo component
                checked against a central difference.
  --four      — only the four-card path: the row-sharded and 2x2-tiled
                1080p frames and the sharded train step, each against the
                single-card result, with each shard on its own card.

Every phase prints one line: its wall time, its compile time (first call
minus a steady call; "warm" when the phase's compiles were served by the
persistent compilation cache and wrote nothing to it, else "cold"), and the
process's peak_bytes_in_use so far. The first line is the card's name and power limit
(nvidia-smi); the last line is one JSON object. Without a GPU, or when any
phase fails, the script exits non-zero and prints no result line.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from svgf_jax import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.utils.device import card_line, device_record, peak_bytes, require_gpu
from svgf_jax.utils.jax_cache import enable_compilation_cache

W, H = 1920, 1080
# trace-stage wavefront chunks at 1080p (bench.py uses the same value)
TRACE_CHUNKS = 8
TRACING = TracingConfig(batch=1, bounces=3, clamp=10.0)

# Tolerances, with their reasons:
# * filter chain vs the composition of its stages, max |diff|: the same f32
#   code fused differently; the variance-guided weights (phi_l ~ 1/sqrt(var))
#   amplify reassociation on near-zero-variance pixels.
CHAIN_ATOL = 1e-3
# * sharded frame vs the single-card frame: the loss-level policy of
#   parallel/checks.py, plus a bound on the pixels that differ at all — a
#   ray through a shared triangle edge may resolve to the other triangle
#   under another fusion of the same f32 arithmetic, and the filters then
#   spread that one pixel over their footprint.
SHARDED_PIXEL_FRAC = 2e-3
# * primary hits vs float64: instance and triangle agree except where a ray
#   passes through a shared edge (both neighbours are valid hits there).
HIT_MATCH_MIN = 0.995
HIT_T_RTOL = 1e-4
# * central difference on one albedo component (the counter-based RNG
#   replays identical paths at +-eps; albedo moves no path, so the frame is
#   smooth in it except at the [0, 1] clamps — 0.3% measured on the CPU).
FD_EPS = 1e-2
FD_RTOL = 0.02


def log(*a):
    print(*a, flush=True)


# persistent-compilation-cache events of this process (jax.monitoring)
_CACHE_EVENTS = {"hits": 0, "writes": 0}


def _count_cache_event(event: str, **_):
    if event == "/jax/compilation_cache/cache_hits":
        _CACHE_EVENTS["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":  # a miss is written
        _CACHE_EVENTS["writes"] += 1


jax.monitoring.register_event_listener(_count_cache_event)


class Phase:
    """Times one phase and prints its line; a failure propagates."""

    def __init__(self, name: str):
        self.name = name
        self.compile_s = 0.0
        self.info: dict = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.cache0 = dict(_CACHE_EVENTS)
        return self

    def first_and_steady(self, fn, *args, reps: int = 3):
        """Run fn(*args) once (compile + run) and `reps` times more; adds
        first - best to the phase's compile time. Returns (out, best_s)."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        best = first
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        self.compile_s += max(first - best, 0.0)
        return out, best

    def run_frames(self, step, n: int):
        """Call the stateful `step()` n >= 2 times: the first call compiles.
        Returns (outputs of every call, best steady seconds)."""
        outs, times = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            outs.append(jax.block_until_ready(step()))
            times.append(time.perf_counter() - t0)
        best = min(times[1:])
        self.compile_s += max(times[0] - best, 0.0)
        return outs, best

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            log(f"phase {self.name}: FAILED {exc_type.__name__}: {exc}")
            return False
        hits = _CACHE_EVENTS["hits"] - self.cache0["hits"]
        writes = _CACHE_EVENTS["writes"] - self.cache0["writes"]
        cache = "warm" if hits > 0 and writes == 0 else "cold"
        log(f"phase {self.name}: ok wall_s={time.perf_counter() - self.t0:.1f} "
            f"compile_s={self.compile_s:.1f} ({cache}, cache hits={hits} "
            f"writes={writes}) "
            f"peak_bytes_in_use={peak_bytes()} {json.dumps(self.info)}")
        return False


def cornell_config(**kw) -> RenderConfig:
    """The main-path frame: 1 spp, 3 bounces, 5 a-trous iterations, TAA,
    fp16 state; keep_taps=False unless a phase needs the G-buffer."""
    kw = {"keep_taps": False, **kw}
    return RenderConfig(
        width=W, height=H, tracing=TRACING,
        svgf=SVGFConfig(spatial_filter_steps=5, enable_taa=True),
        state_dtype="float16", trace_chunks=TRACE_CHUNKS, **kw,
    )


def cornell_scene():
    from svgf_jax.scenes import cornell_box

    return cornell_box(aspect=W / H)


# ---------------------------------------------------------------------------
# phase 1: 1080p Cornell frames through Renderer
# ---------------------------------------------------------------------------


def phase_cornell(ph: Phase, frames: int = 4):
    from svgf_jax.core.camera import orbit_frame
    from svgf_jax.render.gbuffer import raster_gbuffer
    from svgf_jax.render.pipeline import Renderer

    r = Renderer(cornell_scene(), cornell_config())
    _, best = ph.run_frames(r.step, 4)
    # orbit on from those 4 static frames: temporal state carries across
    for k in range(1, frames + 1):
        r.update_camera(orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.02 * k, phi=0.0))
        out = jax.block_until_ready(r.step())
    final = np.asarray(out.final)
    assert final.shape == (H, W, 3) and np.isfinite(final).all()
    assert final.min() >= 0.0 and final.max() <= 1.0
    hist = np.asarray(r.state.history_len)
    assert hist.max() == 4 + frames, hist.max()

    gb = jax.jit(lambda a: raster_gbuffer(a, 0, H, W, num_chunks=TRACE_CHUNKS))(r.arrays)
    inst, depth = np.asarray(gb.instance), np.asarray(gb.depth)
    hit = inst >= 0
    ph.info.update(frame_ms=best * 1e3, orbit_frames=frames,
                   hit_fraction=float(hit.mean()),
                   depth_min=float(depth[hit].min()), depth_max=float(depth[hit].max()),
                   coverage_pct=float(out.metrics.coverage_pct),
                   rays_traced=int(out.metrics.rays_traced),
                   disoccluded_pct=float(out.metrics.disoccluded_pct))
    # the box spans depths 2.4-4.7 from this camera, instances 0-5; at 16:9
    # the view extends past the box opening at the sides, so about 64% of
    # the pixels hit and the central half of the columns all do
    assert 0.6 < hit.mean() < 0.7 and hit[:, W // 4: 3 * W // 4].all(), ph.info
    assert 2.4 <= depth[hit].min() and depth[hit].max() <= 4.7, ph.info
    assert set(np.unique(inst[hit])) <= set(range(6)), ph.info


# ---------------------------------------------------------------------------
# phase 2: the 104,884-triangle stress scene
# ---------------------------------------------------------------------------


def brute_f64(arr, ro, rd, chunk: int = 128):
    """Float64 Moller-Trumbore nearest hit over the world soup, in ray
    chunks: (t, soup column), t = 1e30 for a miss."""
    w9 = np.asarray(arr.world_tris9, np.float64)
    wi = np.asarray(arr.world_tri_inst)
    v0, v1, v2 = w9[0:3].T, w9[3:6].T, w9[6:9].T
    e1, e2 = v1 - v0, v2 - v0
    ts, cols = [], []
    for i in range(0, ro.shape[0], chunk):
        o = np.asarray(ro[i:i + chunk], np.float64)
        d = np.asarray(rd[i:i + chunk], np.float64)
        h = np.cross(d[:, None, :], e2[None])
        a = (e1[None] * h).sum(-1)
        par = np.abs(a) < 1e-12
        f = 1.0 / np.where(par, 1.0, a)
        s = o[:, None, :] - v0[None]
        u = f * (s * h).sum(-1)
        q = np.cross(s, e1[None])
        v = f * (q * d[:, None, :]).sum(-1)
        t = f * (e2[None] * q).sum(-1)
        ok = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
        t = np.where(ok & (wi >= 0)[None], t, 1e30)
        ts.append(t.min(1))
        cols.append(t.argmin(1))
    return np.concatenate(ts), np.concatenate(cols)


def phase_stress(ph: Phase, n: int = 230, samples: int = 4096):
    from svgf_jax.ops import intersect as I
    from svgf_jax.render.gbuffer import camera_rays
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState
    from svgf_jax.scenes.stress import stress_scene

    t0 = time.perf_counter()
    arr = stress_scene(n=n, aspect=W / H).flatten()
    ph.info.update(tris=int(arr.meta.n_world_tris),
                   scene_build_s=time.perf_counter() - t0)
    cfg = cornell_config(keep_taps=True)
    step = jax.jit(functools.partial(render_frame, config=cfg), donate_argnums=(1,))
    frame = {"state": TemporalState.initial(H, W, jnp.float16)}

    def advance():
        out, frame["state"] = step(arr, frame["state"])
        return out

    outs, best = ph.run_frames(advance, 2)
    out = outs[-1]
    final = np.asarray(out.final)
    assert np.isfinite(final).all() and 0.0 <= final.min() and final.max() <= 1.0

    ro, rd = camera_rays(arr.cam_frame[0], arr.cam_proj[0], H, W)
    walk = jax.jit(lambda a, o, d: I.scene_bvh_walk(
        a, (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]),
        I.Hit.none((o.shape[0],)), jnp.ones((o.shape[0],), bool))[1])
    steps = int(walk(arr, ro, rd))

    idx = np.random.default_rng(0).choice(H * W, samples, replace=False)
    ref_t, ref_col = brute_f64(arr, np.asarray(ro)[idx], np.asarray(rd)[idx])
    g = out.gbuffer
    inst = np.asarray(g.instance).reshape(-1)[idx]
    prim = np.asarray(g.prim).reshape(-1)[idx]
    depth = np.asarray(g.depth).reshape(-1)[idx]
    hits = ref_t < 1e29
    assert ((inst >= 0) == hits).all(), "hit/miss sets differ"
    ref_inst = np.asarray(arr.world_tri_inst)[ref_col]
    ref_prim = np.asarray(arr.world_tri_prim)[ref_col]
    same = (inst == ref_inst) & (prim == ref_prim)
    rel = np.abs(depth - ref_t) / np.maximum(ref_t, 1e-6)
    ph.info.update(frame_ms=best * 1e3, bvh_walk_steps_primary=steps,
                   bvh_nodes=int(arr.wbvh_skip.shape[0]),
                   hit_fraction=float(hits.mean()),
                   prim_match=float(same[hits].mean()),
                   max_rel_t_err=float(rel[hits].max()))
    assert same[hits].mean() >= HIT_MATCH_MIN, ph.info
    assert (rel[hits & same] < HIT_T_RTOL).all(), ph.info
    assert (rel[hits] < 2e-3).all(), ph.info


# ---------------------------------------------------------------------------
# phase 3: the filter chain at 1920x1080
# ---------------------------------------------------------------------------


def phase_filter(ph: Phase):
    import bench
    from svgf_jax.render import svgf
    from svgf_jax.render.pipeline import filter_chain

    radiance, gbuf, state = bench.make_bench_inputs(H, W)
    cfg = cornell_config()
    chain = jax.jit(lambda v, g, s: filter_chain(v, g, s, cfg))
    (tres, mom, atrous, final, feedback), best = ph.first_and_steady(
        chain, radiance, gbuf, state, reps=10)
    ph.info["filter_chain_ms"] = best * 1e3

    def temporal(v, g, s):
        return svgf.temporal_filter(v, s.color, g, s.gbuffer, s.moments,
                                    s.history_len, 0.8, 0.9, 24)

    stages = {
        "temporal": (jax.jit(temporal), (radiance, gbuf, state)),
        "moments": (jax.jit(lambda c, m, g, h: svgf.filter_moments(
            c, m, g, h, 10.0, 128.0)), (tres.color, tres.moments, gbuf, tres.history_len)),
        "atrous5": (jax.jit(lambda x, g: svgf.atrous_chain(
            x, g, svgf.wavelet_steps(5), 10.0, 128.0)), (mom, gbuf)),
        "taa": (jax.jit(svgf.taa), (atrous, state.taa_history)),
    }
    outs = {}
    for name, (fn, args) in stages.items():
        outs[name], t = ph.first_and_steady(fn, *args, reps=10)
        ph.info[f"{name}_ms"] = t * 1e3
    err = max(float(jnp.max(jnp.abs(a - b))) for a, b in (
        (outs["moments"], mom), (outs["atrous5"][0], atrous),
        (outs["atrous5"][1], feedback), (outs["taa"], final)))
    ph.info.update(stage_composition_max_abs_diff=err, tolerance=CHAIN_ATOL)
    assert np.isfinite(np.asarray(final)).all() and err < CHAIN_ATOL, ph.info


# ---------------------------------------------------------------------------
# phase 4: gradient step
# ---------------------------------------------------------------------------


# Reduced to 512x288: the backward pass keeps every bounce's and every filter
# stage's residuals live (memory and compile time both grow with the frame),
# and the gradient's semantics do not depend on the size.
GRAD_W, GRAD_H = 512, 288


def gradient_setup():
    """(params, scene arrays, config) of the gradient step: the main-path
    frame at GRAD_W x GRAD_H with TAA off — TAA's min/max neighbourhood
    clamp makes the loss piecewise in the albedo, which a central difference
    cannot follow (the train-step tests also run without it)."""
    from svgf_jax.scenes import cornell_box

    sc = cornell_box(aspect=GRAD_W / GRAD_H)
    sc.cameras[0].aspect = GRAD_W / GRAD_H
    arrays = sc.flatten()
    cfg = dataclasses.replace(
        cornell_config(), width=GRAD_W, height=GRAD_H, trace_chunks=1,
        svgf=SVGFConfig(spatial_filter_steps=5, enable_taa=False))
    params = {"mat_colour": arrays.mat_colour, "mat_emission": arrays.mat_emission,
              "cam_frame": arrays.cam_frame}
    return params, arrays, cfg


def frame_loss(params, arrays, cfg):
    """Mean squared distance of one frame from grey (the loss the sharded
    train step computes against a grey target)."""
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState

    out, _ = render_frame(dataclasses.replace(arrays, **params),
                          TemporalState.initial(cfg.height, cfg.width, jnp.float16), cfg)
    return jnp.mean((out.final - 0.5) ** 2)


def phase_gradient(ph: Phase):
    params, arrays, cfg = gradient_setup()
    loss = functools.partial(frame_loss, cfg=cfg)
    vg = jax.jit(jax.value_and_grad(loss))
    (val, grads), _ = ph.first_and_steady(vg, params, arrays, reps=1)
    for k, g in grads.items():
        g = np.asarray(g)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k

    f = jax.jit(loss)

    def bumped(e):
        p = {**params, "mat_colour": params["mat_colour"].at[0, 0].add(e)}
        return float(f(p, arrays))

    fd = (bumped(FD_EPS) - bumped(-FD_EPS)) / (2 * FD_EPS)
    an = float(grads["mat_colour"][0, 0])
    ph.info.update(loss=float(val), dloss_dalbedo=an, central_difference=fd,
                   size=f"{cfg.width}x{cfg.height}")
    assert abs(an - fd) <= FD_RTOL * abs(fd), ph.info


# ---------------------------------------------------------------------------
# --four: the sharded paths against one card
# ---------------------------------------------------------------------------


def phase_four(ph: Phase):
    from svgf_jax.parallel import (
        make_row_mesh, make_sharded_step, make_tile_mesh, make_tiled_step,
        make_train_step,
    )
    from svgf_jax.parallel.checks import assert_sharded_parity
    from svgf_jax.render.pipeline import Renderer
    from svgf_jax.render.types import TemporalState

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}"
    cfg = cornell_config()

    # the single-card reference: phase 1's Renderer frames
    frames = {}
    r = Renderer(cornell_scene(), cfg)
    outs, best = ph.run_frames(r.step, 3)
    ref = outs[1].final              # frame 2: live history
    ph.info["single_frame_ms"] = best * 1e3

    for tag, step in (("row4", make_sharded_step(cfg, make_row_mesh(4))),
                      ("tile2x2", make_tiled_step(cfg, make_tile_mesh(2, 2)))):
        st = {"state": TemporalState.initial(H, W, jnp.float16)}

        def advance(step=step):
            out, st["state"] = step(r.arrays, st["state"])
            return out

        outs, best = ph.run_frames(advance, 3)
        final = outs[1].final
        devices = {s.device for s in final.addressable_shards}
        assert devices == set(devs[:4]), (tag, devices)
        d = np.abs(np.asarray(final) - np.asarray(ref))
        ph.info[f"{tag}_frame_ms"] = best * 1e3
        ph.info[f"{tag}_max_abs_diff"] = float(d.max())
        ph.info[f"{tag}_frac_diff_gt_1e-2"] = float((d > 1e-2).mean())
        frames[tag] = final

    # the sharded train step against phase 4's single-card gradient, over
    # make_train_step's default fields (material albedo and emission); the
    # camera gradient is the one a ray through a shared triangle edge can
    # move (see SHARDED_PIXEL_FRAC)
    all_params, arrays, gcfg = gradient_setup()
    ref_loss, ref_all = jax.jit(jax.value_and_grad(
        functools.partial(frame_loss, cfg=gcfg)))(all_params, arrays)
    fields = ("mat_colour", "mat_emission")
    params = {k: all_params[k] for k in fields}
    ref_grads = {k: ref_all[k] for k in fields}
    train = make_train_step(gcfg, make_row_mesh(4), param_fields=fields)
    target = jnp.full((gcfg.height, gcfg.width, 3), 0.5, jnp.float32)
    (loss, grads, _), best = ph.first_and_steady(
        lambda: train(params, arrays,
                      TemporalState.initial(gcfg.height, gcfg.width, jnp.float16),
                      target), reps=1)
    ph.info.update(train4_ms=best * 1e3, train4_loss=float(loss),
                   single_loss=float(ref_loss))

    # every number is measured before the first check, so a failing run
    # still reports them all
    mse = lambda x: jnp.mean((x - 0.5) ** 2)
    for tag, final in frames.items():
        assert_sharded_parity(tag, mse(final), {}, mse(ref), {})
        assert ph.info[f"{tag}_frac_diff_gt_1e-2"] < SHARDED_PIXEL_FRAC, ph.info
    assert_sharded_parity("train4", loss, grads, ref_loss, ref_grads)


def main(argv) -> int:
    four = "--four" in argv
    require_gpu()
    log(card_line())
    cache_dir = enable_compilation_cache()
    log(f"devices: {device_record()} cache: {cache_dir} trace_chunks: {TRACE_CHUNKS}")
    phases = ([("four", phase_four)] if four else
              [("cornell", phase_cornell), ("stress", phase_stress),
               ("filter", phase_filter), ("gradient", phase_gradient)])
    for name, fn in phases:
        with Phase(name) as ph:
            fn(ph)
    record = device_record()
    if four:
        record["count"] = 4
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
