"""Incremental scene edits (core/edits.py — reference sceneBVH updates,
BVH.cpp:491-583, scene::UploadMaterial Scene.cpp:447-451). Asserts that
only the touched arrays change (by buffer identity) and that results match
a from-scratch flatten."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from svgf_jax.core.edits import update_instance_transform, update_material
from svgf_jax.core.scene import Material, MaterialType
from svgf_jax.scenes.cornell import cornell_box


def _identity_map(a, b):
    """Field name -> same-object? for two SceneArrays."""
    out = {}
    for f in dataclasses.fields(a):
        if f.name == "meta":
            continue
        out[f.name] = getattr(a, f.name) is getattr(b, f.name)
    return out


def test_update_material_buffer_identity():
    scene = cornell_box()
    arrays = scene.flatten()
    new_mat = dataclasses.replace(
        scene.materials[0] if dataclasses.is_dataclass(scene.materials[0]) else None,
        colour=(0.9, 0.1, 0.1), roughness=0.4, material_type=MaterialType.PBR,
        metallic=0.3,
    )
    edited = update_material(scene, arrays, 0, new_mat)
    ident = _identity_map(arrays, edited)
    changed = {k for k, same in ident.items() if not same}
    assert changed == {
        "mat_emission", "mat_colour", "mat_roughness", "mat_metallic",
        "mat_anisotropy", "mat_opacity", "mat_scattering",
        "mat_transmission_depth", "mat_type",
    }
    # values match a from-scratch flatten
    fresh = scene.flatten()
    np.testing.assert_allclose(
        np.asarray(edited.mat_colour), np.asarray(fresh.mat_colour)
    )
    np.testing.assert_array_equal(
        np.asarray(edited.mat_type), np.asarray(fresh.mat_type)
    )


def test_update_material_rejects_emissive_toggle():
    scene = cornell_box()
    arrays = scene.flatten()
    glow = dataclasses.replace(scene.materials[0], emission=(5.0, 5.0, 5.0))
    with pytest.raises(AssertionError):
        update_material(scene, arrays, 0, glow)


def test_update_instance_transform_matches_flatten():
    scene = cornell_box()
    arrays = scene.flatten()
    # move a non-emissive instance
    idx = next(
        i for i, inst in enumerate(scene.instances)
        if not any(e > 0 for e in scene.materials[inst.material].emission)
    )
    t = np.asarray(scene.instances[idx].transform, np.float32).copy()
    t[:3, 3] += [0.25, 0.0, -0.1]
    edited = update_instance_transform(scene, arrays, idx, t)

    ident = _identity_map(arrays, edited)
    changed = {k for k, same in ident.items() if not same}
    assert "inst_transform" in changed and "world_tris9" in changed
    # untouched heavyweights keep identity
    for k in ("tri_pos", "bvh_bounds6", "tri_verts9", "mat_colour", "textures"):
        assert ident[k], f"{k} was rebuilt unnecessarily"

    fresh = scene.flatten()  # scene.instances already carries the new t
    for k in ("inst_transform", "inst_inv_transform", "inst_normal_transform",
              "world_tris9", "inst_aabb_min", "inst_aabb_max", "lights_cdf"):
        np.testing.assert_allclose(
            np.asarray(getattr(edited, k)), np.asarray(getattr(fresh, k)),
            rtol=1e-5, atol=1e-6, err_msg=k,
        )


def test_update_emissive_instance_rebuilds_light_cdf():
    scene = cornell_box()
    arrays = scene.flatten()
    idx = next(
        i for i, inst in enumerate(scene.instances)
        if any(e > 0 for e in scene.materials[inst.material].emission)
    )
    t = np.asarray(scene.instances[idx].transform, np.float32).copy()
    t[:3, :3] *= 2.0  # scale the light: CDF areas change
    edited = update_instance_transform(scene, arrays, idx, t)
    fresh = scene.flatten()
    np.testing.assert_allclose(
        np.asarray(edited.lights_cdf), np.asarray(fresh.lights_cdf), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(edited.light_area), np.asarray(fresh.light_area), rtol=1e-5
    )
    assert not np.allclose(np.asarray(edited.light_area),
                           np.asarray(arrays.light_area))


def test_edit_during_render_no_retrace():
    """A material edit between frames must not retrace the jitted step."""
    import jax

    from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.render.pipeline import Renderer

    config = RenderConfig(
        width=32, height=24, state_dtype="float32",
        tracing=TracingConfig(bounces=1),
        svgf=SVGFConfig(spatial_filter_steps=1),
    )
    r = Renderer(cornell_box(), config)
    out1 = r.step()
    r.update_material(
        0, dataclasses.replace(r.scene.materials[0], colour=(0.9, 0.2, 0.2))
    )
    out2 = r.step()
    assert r._step._cache_size() == 1, "material edit retraced the step"
    d = np.abs(np.asarray(out2.radiance) - np.asarray(out1.radiance)).max()
    assert d > 1e-4, "edit had no effect"


def test_remove_and_readd_instance():
    """remove_instance / add_instance (reference sceneBVH::RemoveInstance /
    AddInstance, BVH.cpp:519-547): render sanity after delete, and re-adding
    restores the original image."""
    import functools
    import jax
    from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
    from svgf_jax.core.edits import add_instance, remove_instance
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState

    w, h = 32, 24
    cfg = RenderConfig(width=w, height=h, state_dtype="float32",
                       tracing=TracingConfig(bounces=1),
                       svgf=SVGFConfig(spatial_filter_steps=1))
    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    arrays0 = scene.flatten()
    rf = jax.jit(functools.partial(render_frame, config=cfg))
    img0, _ = rf(arrays0, TemporalState.initial(h, w, jnp.float32))
    base = np.asarray(img0.final)

    # delete the tall box (a non-emissive interior instance)
    victim = 4
    removed = scene.instances[victim]
    scene, arrays1 = remove_instance(scene, victim)
    assert arrays1.inst_shape.shape[0] == arrays0.inst_shape.shape[0] - 1
    img1, _ = rf(arrays1, TemporalState.initial(h, w, jnp.float32))
    a1 = np.asarray(img1.final)
    assert np.isfinite(a1).all()
    assert np.abs(a1 - base).max() > 1e-3  # the scene visibly changed

    # re-add -> identical flattened topology -> identical image
    scene, arrays2 = add_instance(scene, removed)
    img2, _ = rf(arrays2, TemporalState.initial(h, w, jnp.float32))
    a2 = np.asarray(img2.final)
    # instance order changed (victim now last) but geometry/material layout
    # is the same scene; pixels must match up to instance-id-dependent RNG
    assert np.isfinite(a2).all()
    assert np.abs(a2 - base).mean() < 2e-2


def test_add_shape_and_duplicate():
    """add_shape appends + instances a shape (reference sceneBVH::AddShape,
    BVH.cpp:549-583); duplicate_instance mirrors the GUI duplicate button."""
    from svgf_jax.core.edits import add_shape, duplicate_instance
    from svgf_jax.core.scene import Shape

    scene = cornell_box()
    n_sh, n_in = len(scene.shapes), len(scene.instances)
    tri = Shape(
        positions=np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        indices=np.asarray([[0, 1, 2]], np.int32),
    )
    scene, arrays, sid = add_shape(scene, tri, material=0)
    assert sid == n_sh
    assert len(scene.instances) == n_in + 1
    assert arrays.meta.n_world_tris >= 1

    scene, arrays2 = duplicate_instance(scene, n_in)
    assert len(scene.instances) == n_in + 2
    assert arrays2.inst_shape.shape[0] == n_in + 2
