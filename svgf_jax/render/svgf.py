"""SVGF denoiser — the heart of the framework (reference src/Filter.cuh).

Pure-JAX reference implementations of the four filter stages, written as
static-shift stencils (roll + elementwise) that XLA fuses.

Reference quirks deliberately reproduced (SURVEY.md §7.3.4):
  * imageLoad/imageStore clamp everything to [0,1] (Filter.cuh:55-83) — the
    whole filter chain operates on clamped values, variance included;
  * motion vectors are truncated toward zero when computing the reprojected
    pixel (ivec2 cast, Filter.cuh:232);
  * history < 4 triggers the 7x7 spatial moments fallback with a 4/h
    variance boost (Filter.cuh:444-516);
  * the a-trous kernel filters variance with SQUARED weights through the
    alpha channel and renormalizes by sumW^2 (Filter.cuh:606-615);
  * a-trous iteration 0's output is fed back as next frame's temporal input
    (Filter.cuh:619-622).

Documented fixes (reference behavior followed only under flags):
  * TAA history: the reference wires TAA's history to FilterBuffer[1], which
    the wavelet ping-pong has already overwritten, so TAA never accumulates
    across frames (App.cu:491-522). We feed true previous-frame TAA output.
  * TAA's bilinear textureSample has an early `return c00` (Filter.cuh:102)
    making it point sampling with a (W-1)/W coordinate shrink; we use exact
    point sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svgf_jax.ops.geometry import luminance, to_srgb
from svgf_jax.render.types import GBuffer

INVALID_DEPTH = 1e30


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def load01(img):
    """imageLoad clamp (Filter.cuh:71-83): values clamped to [0,1] on read."""
    return jnp.clip(img.astype(jnp.float32), 0.0, 1.0)


def store01(img):
    """imageStore clamp (Filter.cuh:55-69)."""
    return jnp.clip(img, 0.0, 1.0)


def get_depth(depth):
    """GetDepth (Filter.cuh:199-207): depth==0 -> 1e30 sentinel."""
    return jnp.where(depth == 0.0, INVALID_DEPTH, depth.astype(jnp.float32))


def _shift(x, dy: int, dx: int):
    """Value of x at (r+dy, c+dx); border values are garbage (mask with _inside)."""
    return jnp.roll(x, shift=(-dy, -dx), axis=(0, 1))


def _inside(h: int, w: int, dy: int, dx: int):
    """Mask: is (r+dy, c+dx) inside the image."""
    r = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return (r + dy >= 0) & (r + dy < h) & (c + dx >= 0) & (c + dx < w)


def compute_weight(z_c, z_p, phi_depth, n_c, n_p, phi_normal, l_c, l_p, phi_l):
    """Edge-stopping weight (Filter.cuh:407-427), shared by moments + a-trous."""
    w_normal = jnp.power(jnp.clip(jnp.sum(n_c * n_p, axis=-1), 0.0, 1.0), phi_normal)
    w_z = jnp.where(phi_depth == 0.0, 0.0, jnp.abs(z_c - z_p) / jnp.where(phi_depth == 0.0, 1.0, phi_depth))
    w_l = jnp.abs(l_c - l_p) / phi_l
    return jnp.exp(-jnp.maximum(w_l, 0.0) - jnp.maximum(w_z, 0.0)) * w_normal


def _gather2d(img, py, px):
    """img[(py, px)] for integer index maps py/px of shape (H, W)."""
    h, w = img.shape[:2]
    py = jnp.clip(py, 0, h - 1)
    px = jnp.clip(px, 0, w - 1)
    flat = img.reshape((h * w,) + img.shape[2:])
    return flat[py * w + px]


# ---------------------------------------------------------------------------
# 1. temporal filter (Filter.cuh:359-404 + LoadPreviousData :225-258)
# ---------------------------------------------------------------------------


class TemporalResult(NamedTuple):
    color: jax.Array        # (H, W, 4) rgb + variance, clamped to [0,1]
    moments: jax.Array      # (H, W, 2)
    history_len: jax.Array  # (H, W) i32
    reprojected: jax.Array  # (H, W) bool — debug/metrics tap (disocclusion mask)


def temporal_filter(
    current: jax.Array,          # (H, W, >=3) current 1spp radiance
    prev_color: jax.Array,       # (H, W, 4) previous integrated color (+var)
    gbuf: GBuffer,
    prev_gbuf: GBuffer,
    prev_moments: jax.Array,     # (H, W, 2)
    prev_history: jax.Array,     # (H, W) i32
    depth_threshold: float,
    normal_threshold: float,
    history_base_length: int,
    row0=0,
    col0=0,
) -> TemporalResult:
    """`row0`/`col0`: global position of this band/tile's first pixel
    (sharded path). The prev_* arrays and prev_gbuf cover the FULL image
    (unsharded, or the all-gathered previous state)."""
    h, w = current.shape[:2]
    h_prev, w_prev = prev_color.shape[:2]
    cur = load01(current[..., :3])

    # --- reprojection (LoadPreviousData) ---
    motion = gbuf.motion.astype(jnp.float32)
    r = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row0
    c = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + col0
    # ivec2 cast truncates toward zero (Filter.cuh:232); motion is (x, y)
    px = c + motion[..., 0].astype(jnp.int32)
    py = r + motion[..., 1].astype(jnp.int32)
    on_screen = (px >= 0) & (px < w_prev) & (py >= 0) & (py < h_prev)

    # ONE packed gather for all previous-frame state. int channels ride as
    # f32 exactly (instance ids and history < 2^24).
    packed_prev = jnp.concatenate(
        [
            prev_gbuf.depth.astype(jnp.float32)[..., None],
            prev_gbuf.instance.astype(jnp.float32)[..., None],
            prev_gbuf.normal.astype(jnp.float32),
            prev_color.astype(jnp.float32)[..., :4],
            prev_history.astype(jnp.float32)[..., None],
            prev_moments.astype(jnp.float32),
        ],
        axis=-1,
    )
    prev = _gather2d(packed_prev, py, px)

    z_cur = get_depth(gbuf.depth)
    z_prev = jnp.where(prev[..., 0] == 0.0, INVALID_DEPTH, prev[..., 0])
    depth_ok = jnp.abs(z_prev - z_cur) <= depth_threshold

    mesh_ok = gbuf.instance.astype(jnp.float32) == prev[..., 1]

    n_cur = gbuf.normal.astype(jnp.float32)
    normal_ok = jnp.sum(n_cur * prev[..., 2:5], axis=-1) >= normal_threshold

    valid = on_screen & depth_ok & mesh_ok & normal_ok

    prev_col = load01(prev[..., 5:8])
    hist_prev = prev[..., 9].astype(jnp.int32)
    mom_prev = prev[..., 10:12]

    history = jnp.where(
        valid, jnp.minimum(history_base_length, hist_prev + 1), 1
    ).astype(jnp.int32)
    alpha = jnp.where(valid, 1.0 / history.astype(jnp.float32), 1.0)

    lum = luminance(cur)
    mom_cur = jnp.stack([lum, lum * lum], axis=-1)
    mom_prev = jnp.where(valid[..., None], mom_prev, 0.0)
    moments = mom_prev + (mom_cur - mom_prev) * alpha[..., None]
    variance = jnp.maximum(0.0, moments[..., 1] - moments[..., 0] ** 2)

    prev_col = jnp.where(valid[..., None], prev_col, 0.0)
    new_col = prev_col + (cur - prev_col) * alpha[..., None]

    out = store01(jnp.concatenate([new_col, variance[..., None]], axis=-1))
    return TemporalResult(
        color=out, moments=moments, history_len=history, reprojected=valid
    )


# ---------------------------------------------------------------------------
# 2. spatial moments fallback (Filter.cuh:430-525)
# ---------------------------------------------------------------------------


def filter_moments(
    color: jax.Array,        # (H, W, 4) temporal output (rgb + var)
    moments: jax.Array,      # (H, W, 2)
    gbuf: GBuffer,
    history_len: jax.Array,  # (H, W) i32
    phi_colour: float,
    phi_normal: float,
) -> jax.Array:
    """7x7 cross-bilateral re-estimation of illumination + variance for
    pixels with history < 4; pass-through otherwise."""
    h, w = color.shape[:2]
    illum = color.astype(jnp.float32)  # read raw (Half4ToVec4, no clamp :450)
    mom = moments.astype(jnp.float32)
    l_center = luminance(illum[..., :3])
    z = get_depth(gbuf.depth)
    zd = gbuf.depth_deriv.astype(jnp.float32)
    n = gbuf.normal.astype(jnp.float32)
    phi_depth = jnp.maximum(zd, 1e-8) * 3.0

    # Tap loop as lax.scan over a static tap table: identical sequential
    # accumulation order (bit-exact vs the unrolled form) but a ~49x smaller
    # traced graph — XLA:CPU compile of the BACKWARD pass through the
    # gbuffer-dependent edge weights is superlinear in op count.
    radius = 3
    taps = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    tap_dy = jnp.array([t[0] for t in taps], jnp.int32)
    tap_dx = jnp.array([t[1] for t in taps], jnp.int32)
    tap_dist = jnp.array(
        [float((dx * dx + dy * dy) ** 0.5) for dy, dx in taps], jnp.float32
    )

    def body(carry, tap):
        sum_w, sum_illum, sum_mom = carry
        dy, dx, dist = tap
        inside = _inside(h, w, dy, dx)
        illum_p = _shift(illum[..., :3], dy, dx)
        mom_p = _shift(mom, dy, dx)
        l_p = luminance(illum_p)
        z_p = _shift(z, dy, dx)
        n_p = _shift(n, dy, dx)
        wgt = compute_weight(
            z, z_p, phi_depth * dist, n, n_p, phi_normal, l_center, l_p, phi_colour
        )
        wgt = jnp.where(inside, wgt, 0.0)
        return (
            sum_w + wgt,
            sum_illum + illum_p * wgt[..., None],
            sum_mom + mom_p * wgt[..., None],
        ), None

    init = (
        jnp.zeros((h, w), jnp.float32),
        jnp.zeros((h, w, 3), jnp.float32),
        jnp.zeros((h, w, 2), jnp.float32),
    )
    (sum_w, sum_illum, sum_mom), _ = jax.lax.scan(
        body, init, (tap_dy, tap_dx, tap_dist)
    )

    sum_w = jnp.maximum(sum_w, 1e-6)
    f_illum = sum_illum / sum_w[..., None]
    f_mom = sum_mom / sum_w[..., None]
    hist = jnp.maximum(history_len.astype(jnp.float32), 1.0)
    variance = (f_mom[..., 1] - f_mom[..., 0] ** 2) * (4.0 / hist)
    fallback = jnp.concatenate([f_illum, variance[..., None]], axis=-1)

    short_history = history_len < 4
    # documented fix: invalid-depth (background) pixels pass through, matching
    # the a-trous kernel's invalid-depth behavior (Filter.cuh:554-558); the
    # reference's `zCenter.x < 0` env check (:454) can never fire (z is 1e30).
    use_fallback = short_history & (z < INVALID_DEPTH)
    return jnp.where(use_fallback[..., None], fallback, illum)


# ---------------------------------------------------------------------------
# 3. a-trous wavelet iteration (Filter.cuh:527-624)
# ---------------------------------------------------------------------------

_KERNEL_1D = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # Filter.cuh:540


def atrous_iteration(
    img: jax.Array,          # (H, W, 4) rgb + variance
    gbuf: GBuffer,
    step: int,
    phi_colour: float,
    phi_normal: float,
) -> jax.Array:
    """One 5x5 edge-stopping wavelet iteration with dilation `step`."""
    h, w = img.shape[:2]
    center = load01(img)                       # imageLoad clamps (:543)
    l_center = luminance(center[..., :3])
    variance = center[..., 3]
    z = get_depth(gbuf.depth)
    zd = gbuf.depth_deriv.astype(jnp.float32)
    n = gbuf.normal.astype(jnp.float32)

    eps_var = 1e-10
    phi_l = phi_colour * jnp.sqrt(jnp.maximum(0.0, eps_var + variance))
    phi_depth = jnp.maximum(zd, 1e-6) * step

    # Tap loop as lax.scan over the static 24-tap table (same sequential
    # accumulation order as the unrolled loop -> bit-exact; see the note in
    # filter_moments about XLA:CPU backward compile cost).
    taps = [(dy, dx) for dy in (-2, -1, 0, 1, 2) for dx in (-2, -1, 0, 1, 2)
            if not (dx == 0 and dy == 0)]
    tap_oy = jnp.array([dy * step for dy, _ in taps], jnp.int32)
    tap_ox = jnp.array([dx * step for _, dx in taps], jnp.int32)
    tap_kernel = jnp.array(
        [_KERNEL_1D[abs(dx)] * _KERNEL_1D[abs(dy)] for dy, dx in taps], jnp.float32
    )
    tap_dist = jnp.array(
        [float((dx * dx + dy * dy) ** 0.5) for dy, dx in taps], jnp.float32
    )

    def body(carry, tap):
        sum_w, sum_c = carry
        oy, ox, kernel, dist = tap
        inside = _inside(h, w, oy, ox)
        pix = load01(_shift(img, oy, ox))
        l_p = luminance(pix[..., :3])
        z_p = _shift(z, oy, ox)
        n_p = _shift(n, oy, ox)
        wgt = compute_weight(
            z, z_p, phi_depth * dist, n, n_p, phi_normal, l_center, l_p, phi_l
        )
        wgt = jnp.where(inside, wgt * kernel, 0.0)
        # variance channel uses squared weights (:606-608)
        w4 = jnp.stack([wgt, wgt, wgt, wgt * wgt], axis=-1)
        return (sum_w + wgt, sum_c + w4 * pix), None

    # center pre-accumulated with weight 1 (:565-568)
    (sum_w, sum_c), _ = jax.lax.scan(
        body,
        (jnp.ones((h, w), jnp.float32), center),
        (tap_oy, tap_ox, tap_kernel, tap_dist),
    )

    norm = jnp.stack([sum_w, sum_w, sum_w, sum_w * sum_w], axis=-1)
    filtered = sum_c / norm

    # invalid depth -> pass-through (:554-558)
    return jnp.where((z >= INVALID_DEPTH)[..., None], center, filtered)


def wavelet_steps(n: int) -> tuple:
    """Dilations of the reference's wavelet loop (App.cu:491-514): 1, 2, 4, ..."""
    return tuple(1 << i for i in range(n))


def atrous_chain(img, gbuf: GBuffer, steps: tuple, phi_colour: float,
                 phi_normal: float):
    """A-trous iterations at the dilations `steps` (wavelet_steps(n) for the
    full wavelet loop). Returns (final, first) where `first` is the first
    iteration's output — fed back into next frame's temporal history
    (Filter.cuh:619-622)."""
    out = first = img
    for k, step in enumerate(steps):
        out = atrous_iteration(out, gbuf, step, phi_colour, phi_normal)
        if k == 0:
            first = out
    return out, first


# ---------------------------------------------------------------------------
# 4. TAA + sRGB (Filter.cuh:288-357)
# ---------------------------------------------------------------------------


# PAL YUV matrices unrolled to scalar arithmetic: an f32 einsum may run at
# reduced precision (TF32) under default matmul precision (~1e-3 relative
# error on the U/V channels, which the decode amplifies near zero).
_YUV_ENC = (
    (0.299, 0.587, 0.114),
    (-0.14713, -0.28886, 0.436),
    (0.615, -0.51499, -0.10001),
)
_YUV_DEC = (
    (1.0, 0.0, 1.13983),
    (1.0, -0.39465, -0.58060),
    (1.0, 2.03211, 0.0),
)


def _encode_pal_yuv(rgb):
    rgb = jnp.maximum(rgb, 0.0)
    rgb = rgb * rgb
    ch = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    return jnp.stack(
        [m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in _YUV_ENC], axis=-1
    )


def _decode_pal_yuv(yuv):
    ch = [yuv[..., 0], yuv[..., 1], yuv[..., 2]]
    rgb = jnp.stack(
        [m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in _YUV_DEC], axis=-1
    )
    return jnp.sqrt(jnp.maximum(rgb, 1e-12))  # eps keeps sqrt' finite at 0


def taa(
    filtered: jax.Array,   # (H, W, 4) wavelet output
    history: jax.Array,    # (H, W, 4) previous TAA output (see module docstring)
) -> jax.Array:
    """Temporal antialiasing + sRGB conversion (the main path's tonemap)."""
    h, w = filtered.shape[:2]
    last = load01(history)
    in0 = load01(filtered)[..., :3]

    mix_rate = jnp.minimum(last[..., 3], 0.5)
    aa = last[..., :3]
    aa = aa * aa + (in0 * in0 - aa * aa) * mix_rate[..., None]
    aa = jnp.sqrt(jnp.maximum(aa, 1e-12))

    neigh = []
    for dy, dx in [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]:
        # border: clamped point sampling (imageLoad coordinate clamp :73-74)
        p = jnp.pad(filtered[..., :3], ((1, 1), (1, 1), (0, 0)), mode="edge")
        neigh.append(load01(p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]))

    aa_yuv = _encode_pal_yuv(aa)
    in_yuv = [_encode_pal_yuv(in0)] + [_encode_pal_yuv(x) for x in neigh]
    first5 = jnp.stack(in_yuv[:5])
    rest4 = jnp.stack(in_yuv[5:])
    min_c = jnp.min(first5, axis=0)
    max_c = jnp.max(first5, axis=0)
    min_c = 0.5 * min_c + 0.5 * jnp.minimum(jnp.min(rest4, axis=0), min_c)
    max_c = 0.5 * max_c + 0.5 * jnp.maximum(jnp.max(rest4, axis=0), max_c)

    aa_yuv = jnp.clip(aa_yuv, min_c, max_c)
    # NOTE: the reference computes an adaptive mixRate here (Filter.cuh:340-346)
    # but stores alpha=1 (:350-353), so the stored history always reads back
    # mixRate=min(1,0.5)=0.5 — the adaptive rate is dead code. Reproduced.

    rgb = _decode_pal_yuv(aa_yuv)
    ok = jnp.all(jnp.isfinite(rgb), axis=-1, keepdims=True)
    rgb = jnp.where(ok, rgb, 0.0)  # NaN scrub (:351)
    out = jnp.concatenate(
        [to_srgb(rgb), jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)], axis=-1
    )
    return store01(out)
