"""BVH build + traversal: structure invariants and BVH == brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

import functools

import jax
import jax.numpy as jnp

import svgf_jax.ops.intersect as intersect_mod
from svgf_jax.accel.bvh import MAX_LEAF, build_blas
from svgf_jax.ops.intersect import intersect_brute_force
from svgf_jax.scenes import cornell_box

intersect_brute_force = jax.jit(intersect_brute_force)


@pytest.fixture(params=["dense", "bvh"])
def intersect_scene(request, monkeypatch):
    """Exercise BOTH intersectors (dense soup + threaded BVH)."""
    if request.param == "bvh":
        monkeypatch.setattr(intersect_mod, "DENSE_MAX_TRIS", 0)
    return jax.jit(
        intersect_mod.intersect_scene, static_argnames=("any_hit", "only_instance")
    )


def random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, size=(n, 1, 3))
    offs = rng.uniform(-0.15, 0.15, size=(n, 3, 3))
    return (base + offs).astype(np.float32)


def test_blas_structure():
    tris = random_tris(257)
    blas = build_blas(tris)
    n = blas.n_nodes
    # every triangle appears exactly once in leaf order
    assert sorted(blas.tri_order.tolist()) == list(range(257))
    # leaves are capped
    assert blas.tri_count.max() <= MAX_LEAF
    # skip links point forward and within [0, n]
    assert (blas.skip > np.arange(n)).all()
    assert (blas.skip <= n).all()
    # parent AABBs contain children (DFS order: children follow parent)
    for i in range(n):
        if blas.tri_count[i] == 0:
            j = i + 1  # first child
            assert (blas.node_min[i] <= blas.node_min[j] + 1e-6).all()
            assert (blas.node_max[i] >= blas.node_max[j] - 1e-6).all()


def test_blas_leaf_bounds_contain_tris():
    tris = random_tris(64, seed=3)
    blas = build_blas(tris)
    for i in range(blas.n_nodes):
        c = int(blas.tri_count[i])
        if c > 0:
            ids = blas.tri_order[int(blas.tri_first[i]) : int(blas.tri_first[i]) + c]
            t = tris[ids]
            assert (t.min(axis=(0, 1)) >= blas.node_min[i] - 1e-5).all()
            assert (t.max(axis=(0, 1)) <= blas.node_max[i] + 1e-5).all()


@pytest.fixture(scope="module")
def cornell_arrays():
    return cornell_box().flatten()


def _camera_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 3.4]], np.float32), (n, 1))
    d = np.stack(
        [
            rng.uniform(-0.4, 0.4, n),
            rng.uniform(-0.4, 0.4, n),
            -np.ones(n),
        ],
        axis=-1,
    )
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(d, jnp.float32)


def test_bvh_matches_brute_force(cornell_arrays, intersect_scene):
    ro, rd = _camera_rays(512)
    h_bvh = intersect_scene(cornell_arrays, ro, rd)
    h_ref = intersect_brute_force(cornell_arrays, ro, rd)
    np.testing.assert_allclose(h_bvh.dist, h_ref.dist, rtol=1e-5, atol=1e-5)
    hit = np.asarray(h_ref.valid)
    # same primitive & instance on hits (ignoring exact ties)
    same = np.asarray(h_bvh.prim == h_ref.prim) | ~hit
    assert same.mean() > 0.999
    np.testing.assert_array_equal(
        np.asarray(h_bvh.instance)[hit], np.asarray(h_ref.instance)[hit]
    )


def test_bvh_random_dirs_match(cornell_arrays, intersect_scene):
    rng = np.random.default_rng(7)
    n = 512
    ro = jnp.asarray(rng.uniform(-0.9, 0.9, size=(n, 3)), jnp.float32)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd = jnp.asarray(rd, jnp.float32)
    h_bvh = intersect_scene(cornell_arrays, ro, rd)
    h_ref = intersect_brute_force(cornell_arrays, ro, rd)
    np.testing.assert_allclose(h_bvh.dist, h_ref.dist, rtol=1e-4, atol=1e-5)


def test_any_hit_consistency(cornell_arrays, intersect_scene):
    ro, rd = _camera_rays(256, seed=2)
    h_any = intersect_scene(cornell_arrays, ro, rd, any_hit=True)
    h_close = intersect_scene(cornell_arrays, ro, rd)
    # any-hit must report a hit iff closest-hit does
    np.testing.assert_array_equal(np.asarray(h_any.valid), np.asarray(h_close.valid))


def test_tmax_occlusion(cornell_arrays, intersect_scene):
    # rays from the center toward the light: unoccluded until the light quad
    n = 8
    ro = jnp.tile(jnp.array([[0.0, -0.5, 0.5]], jnp.float32), (n, 1))
    rd = jnp.tile(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    h = intersect_scene(cornell_arrays, ro, rd)
    assert bool(h.valid.all())
    # limiting tmax below the first hit yields a miss (dist stays at tmax)
    h2 = intersect_scene(cornell_arrays, ro, rd, tmax=jnp.asarray(0.1))
    np.testing.assert_allclose(np.asarray(h2.dist), 0.1)


def test_scene_bvh_large_mesh_matches_brute_force():
    """>16k-triangle scene exercises the stitched TLAS+BLAS world walk
    (has_scene_bvh); spot-check against brute force (VERDICT #5)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from svgf_jax.core.camera import Camera
    from svgf_jax.core.scene import Instance, Material, Scene, Shape
    from svgf_jax.ops.intersect import (
        DENSE_MAX_TRIS,
        intersect_brute_force,
        intersect_scene,
    )

    rng = np.random.default_rng(7)
    # bumpy grid mesh: (G-1)^2 * 2 triangles
    G = 100  # 19,602 tris > DENSE_MAX_TRIS
    xs, ys = np.meshgrid(np.linspace(-2, 2, G), np.linspace(-2, 2, G))
    zs = 0.35 * np.sin(3 * xs) * np.cos(2 * ys)
    P = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    quad = np.arange(G * G).reshape(G, G)
    a, b, c, d = quad[:-1, :-1], quad[:-1, 1:], quad[1:, :-1], quad[1:, 1:]
    F = np.concatenate(
        [np.stack([a, b, c], -1).reshape(-1, 3), np.stack([b, d, c], -1).reshape(-1, 3)]
    ).astype(np.int32)

    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = [0.3, 0.1, 1.5]
    t2[:3, :3] *= 0.5
    scene = Scene(
        cameras=[Camera()],
        shapes=[Shape(positions=P, indices=F)],
        instances=[Instance(shape=0, material=0),
                   Instance(shape=0, material=1, transform=t2)],
        materials=[Material(colour=(1, 0, 0)), Material(colour=(0, 1, 0))],
    )
    arrays = scene.flatten()
    assert arrays.meta.n_world_tris > DENSE_MAX_TRIS
    assert arrays.meta.has_scene_bvh

    R = 128
    ro = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    ro[:, 2] = 3.0
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    fast = jax.jit(intersect_scene)(arrays, jnp.asarray(ro), jnp.asarray(rd))
    slow = jax.jit(intersect_brute_force)(arrays, jnp.asarray(ro), jnp.asarray(rd))
    hit_frac = float(jnp.mean(fast.valid))
    assert hit_frac > 0.25
    np.testing.assert_array_equal(np.asarray(fast.valid), np.asarray(slow.valid))
    ok = np.asarray(fast.valid)
    np.testing.assert_allclose(
        np.asarray(fast.dist)[ok], np.asarray(slow.dist)[ok], rtol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(fast.instance)[ok], np.asarray(slow.instance)[ok]
    )
    np.testing.assert_array_equal(np.asarray(fast.prim)[ok], np.asarray(slow.prim)[ok])
