"""Scene-BVH traversal (large scenes) vs float64 ground truth.

Scenes above ops.intersect.DENSE_MAX_TRIS walk the stitched two-level scene
BVH (traverse_scene_bvh). The baseline is the float64 Moller-Trumbore of
f64_ref; an edge flip is allowed only when the distances agree to 2e-3
relative.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from f64_ref import brute_f64
from svgf_jax.ops.intersect import DENSE_MAX_TRIS, intersect_scene


@pytest.fixture(scope="module")
def scene_arrays():
    from svgf_jax.scenes.stress import stress_scene

    sc = stress_scene(n=96)  # 18,050 world tris: just over DENSE_MAX_TRIS
    arr = sc.flatten()
    return sc, arr


@pytest.fixture(scope="module")
def camera_ray_batch(scene_arrays):
    from svgf_jax.render.gbuffer import camera_rays

    _, arr = scene_arrays
    ro, rd = camera_rays(arr.cam_frame[0], arr.cam_proj[0], 16, 32)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def up_rays(R, y0):
    """Rays from a line at height y0 looking straight up (at the light)."""
    up = jnp.concatenate([jnp.zeros((R, 1)), jnp.ones((R, 1)), jnp.zeros((R, 1))], 1)
    o = jnp.asarray(np.stack([np.linspace(-1.2, 1.2, R), np.full(R, y0),
                              np.linspace(-0.9, 0.9, R)], axis=1), jnp.float32)
    return o, up


def test_scene_bvh_shapes(scene_arrays):
    """The scene BVH is built for large scenes and is a well-formed threaded
    tree over the world soup."""
    _, arr = scene_arrays
    assert arr.meta.n_world_tris > DENSE_MAX_TRIS and arr.meta.has_scene_bvh
    n = arr.wbvh_skip.shape[0]
    skip = np.asarray(arr.wbvh_skip)
    assert (skip > np.arange(n)).all() and (skip <= n).all()
    leaf = np.asarray(arr.wbvh_leaf_tri)
    cols = leaf[leaf >= 0]
    assert cols.size == arr.meta.n_world_tris
    np.testing.assert_array_equal(np.sort(cols), np.arange(arr.meta.n_world_tris))
    b = np.asarray(arr.wbvh_bounds6)
    assert (b[:3] <= b[3:]).all()


def test_scene_bvh_matches_f64_truth(scene_arrays, camera_ray_batch):
    _, arr = scene_arrays
    ro, rd = camera_ray_batch
    hit = intersect_scene(arr, ro, rd)
    ref_t, _ = brute_f64(arr, ro, rd)
    got = np.asarray(hit.dist)
    hits = ref_t < 1e29
    assert ((got < 1e29) == hits).all(), "hit/miss sets differ"
    rel = np.abs(got[hits] - ref_t[hits]) / ref_t[hits]
    assert rel.max() < 2e-3, f"max rel dist err {rel.max()}"
    # the overwhelming majority must be exact (non-edge) matches
    assert (rel < 1e-5).mean() > 0.95


def test_scene_bvh_only_instance_and_tmax(scene_arrays, camera_ray_batch):
    _, arr = scene_arrays
    R = camera_ray_batch[0].shape[0]
    o, up = up_rays(R, 0.5)
    h_only = intersect_scene(arr, o, up, only_instance=1)
    tmax = jnp.full((R,), 1.5, jnp.float32)
    h_tmax = intersect_scene(arr, o, up, tmax=tmax)
    act = jnp.arange(R) % 2 == 0
    h_act = intersect_scene(arr, o, up, active=act)

    ref_t, _ = brute_f64(arr, o, up, only_instance=1)
    got = np.asarray(h_only.dist)
    hits = ref_t < 1e29
    assert ((got < 1e29) == hits).all()
    assert np.allclose(got[hits], ref_t[hits], rtol=2e-3)
    assert (np.asarray(h_only.instance)[hits] == 1).all()

    ref_t2, _ = brute_f64(arr, o, up, tmax=np.full(R, 1.5))
    got2 = np.asarray(h_tmax.dist)
    assert ((got2 < 1.5) == (ref_t2 < 1e29)).all()

    # inactive rays keep the miss sentinel
    d_act = np.asarray(h_act.dist)
    assert (d_act[1::2] >= 1e29).all()
    assert (d_act[0::2] < 1e29).any()


def test_scene_bvh_edit_updates_bounds(scene_arrays):
    """An instance-transform edit rebuilds the scene BVH: closest-hit rays
    see the moved light."""
    import dataclasses

    from svgf_jax.core.edits import update_instance_transform

    sc, arr = scene_arrays
    sc2 = dataclasses.replace(sc)  # same shapes/instances lists
    t = np.eye(4, dtype=np.float32)
    t[1, 3] = 1.2  # light drops from 2.5 to 1.2
    t[0, 0] = t[2, 2] = 1.5
    arr2 = update_instance_transform(sc2, arr, 1, t)
    assert not np.array_equal(np.asarray(arr.wbvh_bounds6),
                              np.asarray(arr2.wbvh_bounds6))

    o, up = up_rays(64, 0.6)
    o = o.at[:, 0].multiply(0.4).at[:, 2].set(0.0)
    h = intersect_scene(arr2, o, up)
    ref_t, _ = brute_f64(arr2, o, up)
    hits = ref_t < 1e29
    assert hits.any()
    got = np.asarray(h.dist)
    assert ((got < 1e29) == hits).all()
    assert np.allclose(got[hits], ref_t[hits], rtol=2e-3)
    assert (np.asarray(h.instance)[hits] == 1).all()
