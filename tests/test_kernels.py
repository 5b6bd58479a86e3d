"""The filter stages and the dense intersector against NumPy references.

render.svgf is the system's one implementation of the SVGF stages; each
stage is checked here against a float64 NumPy transcription of the
reference shaders (Filter.cuh), and the dense intersector against a float64
brute force."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax.render import svgf
from svgf_jax.render.types import GBuffer

# odd sizes: every stencil footprint crosses the image border somewhere
H, W = 24, 37


def make_inputs(seed=0, with_background=False, h=H, w=W):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(1, 5, (h, w)).astype(np.float32)
    if with_background:
        mask = rng.uniform(size=(h, w)) < 0.2
        depth = np.where(mask, 0.0, depth)   # invalid/background pixels
        n = np.where(mask[..., None], 0.0, n)
    g = GBuffer.zeros(h, w)._replace(
        depth=jnp.asarray(depth),
        depth_deriv=jnp.asarray(rng.uniform(1e-4, 1e-2, (h, w)), jnp.float32),
        normal=jnp.asarray(n, jnp.float32),
        instance=jnp.zeros((h, w), jnp.int32),
    )
    img = jnp.asarray(rng.uniform(0, 1, (h, w, 4)), jnp.float32)
    return img, g


def _f64(x):
    return np.asarray(x, np.float64)


def _lum(x):
    return 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]


def _tap(x, dy, dx):
    """x at (r+dy, c+dx) and whether that pixel is inside the image."""
    h, w = x.shape[:2]
    r, c = np.mgrid[0:h, 0:w]
    rr, cc = r + dy, c + dx
    inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    return x[np.clip(rr, 0, h - 1), np.clip(cc, 0, w - 1)], inside


def _weight(z_c, z_p, phi_depth, n_c, n_p, phi_normal, l_c, l_p, phi_l):
    """Edge-stopping weight (Filter.cuh:407-427)."""
    w_n = np.clip((n_c * n_p).sum(-1), 0, 1) ** phi_normal
    w_z = np.where(phi_depth == 0, 0.0,
                   np.abs(z_c - z_p) / np.where(phi_depth == 0, 1.0, phi_depth))
    return np.exp(-np.maximum(np.abs(l_c - l_p) / phi_l, 0) - np.maximum(w_z, 0)) * w_n


def atrous_numpy(img, g, step, phi_colour=10.0, phi_normal=128.0):
    """Float64 transcription of one a-trous iteration (Filter.cuh:527-624)."""
    c = np.clip(_f64(img), 0, 1)
    z = np.where(_f64(g.depth) == 0, 1e30, _f64(g.depth))
    n = _f64(g.normal)
    l_c = _lum(c)
    phi_l = phi_colour * np.sqrt(np.maximum(0, 1e-10 + c[..., 3]))
    phi_d = np.maximum(_f64(g.depth_deriv), 1e-6) * step
    k1 = (1.0, 2.0 / 3.0, 1.0 / 6.0)
    sum_w, acc = np.ones(z.shape), c.copy()
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy == 0 and dx == 0:
                continue
            p, inside = _tap(c, dy * step, dx * step)
            wgt = _weight(z, _tap(z, dy * step, dx * step)[0],
                          phi_d * np.hypot(dx, dy), n, _tap(n, dy * step, dx * step)[0],
                          phi_normal, l_c, _lum(p), phi_l) * k1[abs(dx)] * k1[abs(dy)]
            wgt = np.where(inside, wgt, 0.0)
            sum_w = sum_w + wgt
            acc = acc + p * np.stack([wgt, wgt, wgt, wgt * wgt], -1)
    out = acc / np.stack([sum_w, sum_w, sum_w, sum_w * sum_w], -1)
    return np.where((z >= 1e30)[..., None], c, out)


def moments_numpy(color, moments, g, history, phi_colour=10.0, phi_normal=128.0):
    """Float64 transcription of the 7x7 moments fallback (Filter.cuh:430-525)."""
    c, m = _f64(color), _f64(moments)
    z = np.where(_f64(g.depth) == 0, 1e30, _f64(g.depth))
    n = _f64(g.normal)
    l_c = _lum(c)
    phi_d = np.maximum(_f64(g.depth_deriv), 1e-8) * 3.0
    sum_w, s_c, s_m = np.zeros(z.shape), np.zeros(c.shape[:2] + (3,)), np.zeros(m.shape)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            p, inside = _tap(c, dy, dx)
            wgt = _weight(z, _tap(z, dy, dx)[0], phi_d * np.hypot(dx, dy), n,
                          _tap(n, dy, dx)[0], phi_normal, l_c, _lum(p), phi_colour)
            wgt = np.where(inside, wgt, 0.0)
            sum_w = sum_w + wgt
            s_c = s_c + p[..., :3] * wgt[..., None]
            s_m = s_m + _tap(m, dy, dx)[0] * wgt[..., None]
    sum_w = np.maximum(sum_w, 1e-6)[..., None]
    f_c, f_m = s_c / sum_w, s_m / sum_w
    hist = np.asarray(history)
    var = (f_m[..., 1] - f_m[..., 0] ** 2) * (4.0 / np.maximum(hist, 1))
    fallback = np.concatenate([f_c, var[..., None]], -1)
    use = (hist < 4) & (z < 1e30)
    return np.where(use[..., None], fallback, c)


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_atrous_pallas_matches_reference(step):
    img, g = make_inputs()
    out = svgf.atrous_iteration(img, g, step, 10.0, 128.0)
    np.testing.assert_allclose(np.asarray(out), atrous_numpy(img, g, step), atol=2e-5)


def test_atrous_pallas_background_passthrough():
    img, g = make_inputs(seed=3, with_background=True)
    out = svgf.atrous_iteration(img, g, 2, 10.0, 128.0)
    np.testing.assert_allclose(np.asarray(out), atrous_numpy(img, g, 2), atol=2e-5)


def test_atrous_pallas_nonsquare_phi():
    img, g = make_inputs(seed=5)
    # non-power-of-two phi_normal: the general pow path
    out = svgf.atrous_iteration(img, g, 1, 7.5, 100.0)
    np.testing.assert_allclose(np.asarray(out), atrous_numpy(img, g, 1, 7.5, 100.0),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# moments fallback (Filter.cuh:430-525)
# ---------------------------------------------------------------------------


def make_moments_inputs(seed=0, with_background=False, h=H, w=W):
    rng = np.random.default_rng(seed)
    img, g = make_inputs(seed, with_background, h, w)
    moments = jnp.asarray(rng.uniform(0, 0.6, (h, w, 2)), jnp.float32)
    history = jnp.asarray(rng.integers(1, 10, (h, w)), jnp.int32)
    return img, moments, g, history


def test_moments_pallas_matches_reference():
    img, moments, g, history = make_moments_inputs()
    out = svgf.filter_moments(img, moments, g, history, 10.0, 128.0)
    np.testing.assert_allclose(np.asarray(out), moments_numpy(img, moments, g, history),
                               atol=2e-5)


def test_moments_pallas_background_and_long_history():
    img, moments, g, history = make_moments_inputs(seed=7, with_background=True)
    # long-history pixels must pass through untouched (Filter.cuh:518-523)
    history = jnp.where(history > 5, 100, history)
    out = svgf.filter_moments(img, moments, g, history, 10.0, 128.0)
    np.testing.assert_allclose(np.asarray(out), moments_numpy(img, moments, g, history),
                               atol=2e-5)
    long = np.asarray(history) >= 4
    np.testing.assert_array_equal(np.asarray(out)[long], np.asarray(img)[long])


def test_moments_pallas_steady_state_skip():
    """History >= 4 everywhere: the fallback leaves every pixel untouched."""
    img, moments, g, _ = make_moments_inputs(seed=9)
    history = jnp.full((H, W), 24, jnp.int32)
    out = svgf.filter_moments(img, moments, g, history, 10.0, 128.0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(img))


# ---------------------------------------------------------------------------
# a-trous chain: sizes, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(5, 7), (13, 130)])
def test_stencils_tile_edges(hw):
    """Images smaller than the dilated footprint and wide, short ones: the
    inside-masks exclude every out-of-image tap."""
    h, w = hw
    img, moments, g, history = make_moments_inputs(seed=11, with_background=True,
                                                   h=h, w=w)
    out, first = svgf.atrous_chain(img, g, (1, 2), 10.0, 128.0)
    ref_first = atrous_numpy(img, g, 1)
    np.testing.assert_allclose(np.asarray(first), ref_first, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out), atrous_numpy(first, g, 2), atol=2e-5)
    out_m = svgf.filter_moments(img, moments, g, history, 10.0, 128.0)
    np.testing.assert_allclose(np.asarray(out_m), moments_numpy(img, moments, g, history),
                               atol=2e-5)


def _central_difference(f, x, idx, eps):
    e = np.zeros(x.shape, np.float32)
    e[idx] = eps
    return (float(f(x + e)) - float(f(x - e))) / (2 * eps)


def test_atrous_custom_vjp_equals_reference_gradient():
    """The a-trous chain's gradient w.r.t. the image and the normals matches
    central differences (the pipeline's gradient path through the filter)."""
    img, g = make_inputs(seed=13, with_background=True, h=16, w=20)
    ct = jnp.asarray(np.random.default_rng(0).standard_normal((16, 20, 4)),
                     jnp.float32)

    def loss(x, n):
        out, first = svgf.atrous_chain(x, g._replace(normal=n), (1, 2), 10.0, 128.0)
        return jnp.sum(out * ct) + jnp.sum(first * ct)

    gx, gn = jax.jit(jax.grad(loss, argnums=(0, 1)))(img, g.normal)
    f_img = jax.jit(lambda x: loss(x, g.normal))
    f_nrm = jax.jit(lambda n: loss(img, n))
    for idx in ((3, 4, 0), (8, 9, 3), (12, 15, 1)):
        fd = _central_difference(f_img, img, idx, 1e-3)
        assert abs(float(gx[idx]) - fd) <= 2e-2 * abs(fd) + 2e-3, (idx, gx[idx], fd)
    valid = np.argwhere(np.asarray(g.depth) > 0)[5]
    idx = (int(valid[0]), int(valid[1]), 2)
    fd = _central_difference(f_nrm, g.normal, idx, 1e-3)
    assert abs(float(gn[idx]) - fd) <= 2e-2 * abs(fd) + 2e-3, (idx, gn[idx], fd)


def test_moments_custom_vjp_equals_reference_gradient():
    """The moments fallback's gradient w.r.t. colour and moments matches
    central differences on short-history pixels."""
    img, moments, g, history = make_moments_inputs(seed=17, h=16, w=20)
    history = jnp.minimum(history, 3)
    ct = jnp.asarray(np.random.default_rng(1).standard_normal((16, 20, 4)),
                     jnp.float32)

    def loss(x, m):
        return jnp.sum(svgf.filter_moments(x, m, g, history, 10.0, 128.0) * ct)

    gx, gm = jax.jit(jax.grad(loss, argnums=(0, 1)))(img, moments)
    f_img = jax.jit(lambda x: loss(x, moments))
    f_mom = jax.jit(lambda m: loss(img, m))
    for idx in ((3, 4, 0), (8, 9, 1)):
        fd = _central_difference(f_img, img, idx, 1e-3)
        assert abs(float(gx[idx]) - fd) <= 2e-2 * abs(fd) + 2e-3, (idx, gx[idx], fd)
    for idx in ((5, 6, 0), (10, 2, 1)):
        fd = _central_difference(f_mom, moments, idx, 1e-3)
        assert abs(float(gm[idx]) - fd) <= 2e-2 * abs(fd) + 2e-3, (idx, gm[idx], fd)


def test_filter_stencils_dispatch():
    """atrous_chain runs the reference's dilation schedule: iteration k of
    the wavelet loop uses step 2^k, and `first` is iteration 0's output."""
    assert svgf.wavelet_steps(5) == (1, 2, 4, 8, 16)
    assert svgf.wavelet_steps(0) == ()
    img, g = make_inputs(seed=19)
    out, first = svgf.atrous_chain(img, g, svgf.wavelet_steps(3), 10.0, 128.0)
    x = img
    for s in (1, 2, 4):
        x = svgf.atrous_iteration(x, g, s, 10.0, 128.0)
        if s == 1:
            np.testing.assert_array_equal(np.asarray(first), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


# ---------------------------------------------------------------------------
# temporal reprojection (Filter.cuh:359-404, plain XLA gather)
# ---------------------------------------------------------------------------


def temporal_numpy(cur, prev_color, g, prev_g, prev_moments, prev_hist,
                   dth=0.8, nth=0.9, hist_len=24):
    """Float64 NumPy reference of svgf.temporal_filter (unbounded gather)."""
    cur = np.clip(np.asarray(cur, np.float64)[..., :3], 0, 1)
    h, w = cur.shape[:2]
    m = np.asarray(g.motion)
    r, c = np.mgrid[0:h, 0:w]
    px = c + np.trunc(m[..., 0]).astype(int)
    py = r + np.trunc(m[..., 1]).astype(int)
    on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pyc, pxc = np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)

    def fix(z):
        return np.where(z == 0.0, 1e30, z)

    z_prev = fix(np.asarray(prev_g.depth, np.float64)[pyc, pxc])
    z_cur = fix(np.asarray(g.depth, np.float64))
    ok = on & (np.abs(z_prev - z_cur) <= dth)
    ok &= np.asarray(g.instance) == np.asarray(prev_g.instance)[pyc, pxc]
    n_prev = np.asarray(prev_g.normal, np.float64)[pyc, pxc]
    ok &= (np.asarray(g.normal, np.float64) * n_prev).sum(-1) >= nth
    hist = np.where(ok, np.minimum(hist_len, np.asarray(prev_hist)[pyc, pxc] + 1), 1)
    alpha = np.where(ok, 1.0 / hist, 1.0)[..., None]
    lum = 0.2126 * cur[..., 0] + 0.7152 * cur[..., 1] + 0.0722 * cur[..., 2]
    mom_prev = np.where(ok[..., None],
                        np.asarray(prev_moments, np.float64)[pyc, pxc], 0.0)
    mom = mom_prev + (np.stack([lum, lum * lum], -1) - mom_prev) * alpha
    var = np.maximum(0.0, mom[..., 1] - mom[..., 0] ** 2)
    prev_rgb = np.asarray(prev_color, np.float64)[pyc, pxc][..., :3]
    col_prev = np.where(ok[..., None], np.clip(prev_rgb, 0, 1), 0.0)
    col = col_prev + (cur - col_prev) * alpha
    color = np.clip(np.concatenate([col, var[..., None]], -1), 0, 1)
    return color, mom, hist, ok


TH, TW = 24, 136   # wide enough for |dx| > 63 to stay on screen


def make_temporal_inputs(seed, motion):
    """Current frame = previous frame shifted by `motion` (x, y), so every
    pixel whose reprojection lands on screen finds matching geometry."""
    rng = np.random.default_rng(seed)
    mx, my = motion
    n = rng.standard_normal((TH, TW, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    prev_g = GBuffer.zeros(TH, TW)._replace(
        depth=jnp.asarray(rng.uniform(1, 5, (TH, TW)), jnp.float32),
        normal=jnp.asarray(n, jnp.float32),
        instance=jnp.asarray(rng.integers(0, 3, (TH, TW)), jnp.int32),
    )
    r, c = np.mgrid[0:TH, 0:TW]
    src = (np.clip(r + int(my), 0, TH - 1), np.clip(c + int(mx), 0, TW - 1))

    def shift(x):
        return jnp.asarray(np.asarray(x)[src])

    g = prev_g._replace(
        depth=shift(prev_g.depth), normal=shift(prev_g.normal),
        instance=shift(prev_g.instance),
        motion=jnp.asarray(np.broadcast_to(np.float32([mx, my]), (TH, TW, 2))),
    )
    cur = jnp.asarray(rng.uniform(0, 1, (TH, TW, 3)), jnp.float32)
    prev_color = jnp.asarray(rng.uniform(0, 1, (TH, TW, 4)), jnp.float32)
    prev_moments = jnp.asarray(rng.uniform(0, 0.5, (TH, TW, 2)), jnp.float32)
    prev_hist = jnp.asarray(rng.integers(1, 24, (TH, TW)), jnp.int32)
    return cur, prev_color, g, prev_g, prev_moments, prev_hist


def assert_temporal_matches_numpy(args):
    out = svgf.temporal_filter(*args, 0.8, 0.9, 24)
    color, mom, hist, ok = temporal_numpy(*args)
    np.testing.assert_array_equal(np.asarray(out.reprojected), ok)
    np.testing.assert_array_equal(np.asarray(out.history_len), hist)
    np.testing.assert_allclose(np.asarray(out.color), color, atol=2e-6)
    np.testing.assert_allclose(np.asarray(out.moments), mom, atol=2e-6)
    return out


def test_temporal_pallas_matches_reference():
    """Mixed geometry: the previous depth differs on ~30% of pixels."""
    cur, prev_color, g, prev_g, prev_moments, prev_hist = make_temporal_inputs(0, (3, -2))
    keep = np.random.default_rng(5).uniform(size=(TH, TW)) < 0.7
    prev_g = prev_g._replace(depth=jnp.where(keep, prev_g.depth, prev_g.depth + 2.0))
    out = assert_temporal_matches_numpy(
        (cur, prev_color, g, prev_g, prev_moments, prev_hist))
    assert 0.2 < np.asarray(out.reprojected).mean() < 0.9


def test_temporal_pallas_band_halo_layout():
    """Large motion (|dy| > 8 rows, |dx| > 63 columns) reprojects exactly:
    the gather has no motion bound (Filter.cuh:230-232)."""
    args = make_temporal_inputs(3, (-90, 12))
    out = assert_temporal_matches_numpy(args)
    on_screen = np.zeros((TH, TW), bool)
    on_screen[: TH - 12, 90:] = True
    np.testing.assert_array_equal(np.asarray(out.reprojected), on_screen)


def test_temporal_pallas_out_of_bound_motion_is_disocclusion():
    """Motion that leaves the screen is a failed reprojection: history 1 and
    the temporal colour is the clipped current radiance."""
    args = make_temporal_inputs(4, (TW, 0))
    out = assert_temporal_matches_numpy(args)
    assert not bool(np.asarray(out.reprojected).any())
    assert int(np.asarray(out.history_len).max()) == 1
    np.testing.assert_allclose(np.asarray(out.color[..., :3]),
                               np.clip(np.asarray(args[0]), 0, 1), atol=1e-6)


# ---------------------------------------------------------------------------
# TAA + sRGB (Filter.cuh:288-357)
# ---------------------------------------------------------------------------


def taa_numpy(filtered, history):
    """Float64 NumPy reference of svgf.taa (YUV neighbourhood clamp + sRGB)."""
    f = np.asarray(filtered, np.float64)
    last = np.clip(np.asarray(history, np.float64), 0, 1)
    in0 = np.clip(f[..., :3], 0, 1)
    mix = np.minimum(last[..., 3], 0.5)[..., None]
    aa = last[..., :3]
    aa = np.sqrt(np.maximum(aa * aa + (in0 * in0 - aa * aa) * mix, 1e-12))
    enc, dec = np.array(svgf._YUV_ENC), np.array(svgf._YUV_DEC)

    def yuv(x):
        return (np.maximum(x, 0) ** 2) @ enc.T

    h, w = f.shape[:2]
    p = np.pad(f[..., :3], ((1, 1), (1, 1), (0, 0)), mode="edge")

    def nb(dy, dx):
        return yuv(np.clip(p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w], 0, 1))

    first5 = np.stack([yuv(in0), nb(0, 1), nb(0, -1), nb(1, 0), nb(-1, 0)])
    rest4 = np.stack([nb(1, 1), nb(1, -1), nb(-1, 1), nb(-1, -1)])
    lo, hi = first5.min(0), first5.max(0)
    lo = 0.5 * lo + 0.5 * np.minimum(rest4.min(0), lo)
    hi = 0.5 * hi + 0.5 * np.maximum(rest4.max(0), hi)
    rgb = np.sqrt(np.maximum(np.clip(yuv(aa), lo, hi) @ dec.T, 1e-12))
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * np.maximum(rgb, 0.0031308) ** (1 / 2.4) - 0.055)
    return np.clip(srgb, 0, 1)


def test_taa_pallas_matches_reference():
    rng = np.random.default_rng(11)
    filt = jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32)
    hist = jnp.asarray(rng.uniform(0, 1, (H, W, 4)), jnp.float32)
    out = np.asarray(svgf.taa(filt, hist))
    np.testing.assert_array_equal(out[..., 3], 1.0)
    # tolerance: the YUV decode takes sqrt near zero, which amplifies float32
    # rounding (d/dx sqrt -> inf at 0)
    np.testing.assert_allclose(out[..., :3], taa_numpy(filt, hist), atol=5e-4)


# ---------------------------------------------------------------------------
# dense intersector vs float64 ground truth
# ---------------------------------------------------------------------------


def assert_hits_agree(got, ref_t, tmax=1e29):
    """Hit/miss verdicts agree except on a vanishing fraction of rays (f32
    rays through a shared triangle edge can fall into the crack between
    the two triangles), and t agrees wherever both hit."""
    hits = ref_t < 1e29
    agree = (got < tmax) == hits
    assert agree.mean() > 0.99, f"hit/miss differ on {(~agree).mean():.2%}"
    both = hits & agree
    np.testing.assert_allclose(got[both], ref_t[both], rtol=1e-4)
    return both


@pytest.fixture(scope="module")
def cornell_arrays():
    from svgf_jax.scenes.cornell import cornell_box

    scene = cornell_box()
    scene.cameras[0].aspect = 1.0
    return scene.flatten()


def test_intersect_pallas_matches_dense(cornell_arrays):
    from f64_ref import brute_f64
    from svgf_jax.ops.intersect import intersect_dense
    from svgf_jax.render.gbuffer import camera_rays

    arrays = cornell_arrays
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], 32, 32)
    rd2 = jax.random.normal(jax.random.key(3), rd.shape)
    rd2 = rd2 / jnp.linalg.norm(rd2, axis=-1, keepdims=True)
    for rdir in (rd, rd2):
        hit = intersect_dense(arrays, ro, rdir)
        ref_t, ref_col = brute_f64(arrays, ro, rdir)
        both = assert_hits_agree(np.asarray(hit.dist), ref_t)
        # the winning instance agrees except where two triangles tie in t
        inst = np.asarray(arrays.world_tri_inst)[ref_col]
        assert (np.asarray(hit.instance) == inst)[both].mean() > 0.99


def test_intersect_pallas_only_instance_and_tmax(cornell_arrays):
    from f64_ref import brute_f64
    from svgf_jax.ops.intersect import intersect_dense
    from svgf_jax.render.gbuffer import camera_rays

    arrays = cornell_arrays
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], 24, 24)
    for inst in (0, 1):
        got = np.asarray(intersect_dense(arrays, ro, rd, only_instance=inst).dist)
        ref_t, _ = brute_f64(arrays, ro, rd, only_instance=inst)
        assert_hits_agree(got, ref_t)
    tmax = np.full(ro.shape[0], 3.0)
    got = np.asarray(intersect_dense(arrays, ro, rd, tmax=jnp.asarray(tmax)).dist)
    ref_t, _ = brute_f64(arrays, ro, rd, tmax=tmax)
    assert_hits_agree(got, ref_t, tmax=3.0)


def test_intersect_pallas_gradients_flow(cornell_arrays):
    """t must stay differentiable w.r.t. the ray origin (camera path)."""
    from svgf_jax.ops.intersect import intersect_dense
    from svgf_jax.render.gbuffer import camera_rays

    arrays = cornell_arrays
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], 16, 16)

    def loss(o):
        h = intersect_dense(arrays, o, rd)
        return jnp.sum(jnp.where(h.dist < 1e29, h.dist, 0.0))

    g = np.asarray(jax.grad(loss)(ro))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0
