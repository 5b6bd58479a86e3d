"""Native C++ builder == NumPy reference builder (traversal-equivalent)."""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax.accel import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    if not native.available():
        r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("native toolchain unavailable")
        native._TRIED = False  # re-probe
    if not native.available():
        pytest.skip("native lib missing")


def random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, size=(n, 1, 3))
    return (base + rng.uniform(-0.15, 0.15, size=(n, 3, 3))).astype(np.float32)


def test_native_blas_structure():
    tris = random_tris(333)
    res = native.build_blas_native(tris)
    assert res is not None
    node_min, node_max, skip, leaf_tri = res
    n = 2 * 333 - 1
    assert node_min.shape == (n, 3)
    # every triangle in exactly one leaf
    leaves = leaf_tri[leaf_tri >= 0]
    assert sorted(leaves.tolist()) == list(range(333))
    # skip links strictly forward
    assert (skip > np.arange(n)).all()
    assert (skip <= n).all()
    # leaf bounds contain their triangle
    for i in range(n):
        t = leaf_tri[i]
        if t >= 0:
            assert (tris[t].min(0) >= node_min[i] - 1e-5).all()
            assert (tris[t].max(0) <= node_max[i] + 1e-5).all()


def test_native_traversal_matches_brute_force(monkeypatch):
    """A scene flattened with the native builder traces identically."""
    import svgf_jax.ops.intersect as intersect_mod
    from svgf_jax.ops.intersect import intersect_brute_force
    from svgf_jax.scenes import cornell_box

    monkeypatch.setenv("SVGF_NATIVE", "1")
    monkeypatch.setattr(intersect_mod, "DENSE_MAX_TRIS", 0)  # force BVH path
    arrays = cornell_box().flatten()
    rng = np.random.default_rng(11)
    n = 256
    ro = jnp.asarray(rng.uniform(-0.9, 0.9, (n, 3)), jnp.float32)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    h1 = jax.jit(intersect_mod.intersect_scene)(arrays, ro, jnp.asarray(rd, jnp.float32))
    h2 = jax.jit(intersect_brute_force)(arrays, ro, jnp.asarray(rd, jnp.float32))
    np.testing.assert_allclose(np.asarray(h1.dist), np.asarray(h2.dist), rtol=1e-4, atol=1e-5)


def test_native_tangents_match_numpy():
    from svgf_jax.core.scene import _lengyel_tangents

    rng = np.random.default_rng(5)
    V, F = 64, 100
    pos = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    nrm = rng.normal(size=(V, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm.astype(np.float32)
    uv = rng.uniform(0, 1, (V, 2)).astype(np.float32)
    idx = rng.integers(0, V, (F, 3)).astype(np.int32)
    ref = _lengyel_tangents(pos, nrm, uv, idx.astype(np.int64))
    out = native.tangents_native(pos, nrm, uv, idx)
    assert out is not None
    np.testing.assert_allclose(out, ref, atol=2e-5)
