"""Incremental scene edits — the reference's live-update path
(sceneBVH::UpdateTLAS/UpdateMaterial/AddInstance/RemoveInstance/AddShape,
BVH.cpp:491-583; scene::UploadMaterial, Scene.cpp:447-451; asset import into
a live scene, AssetLoader.cpp:11-55).

Every function takes the host `Scene` plus its current flattened
`SceneArrays` and returns a new `SceneArrays` in which ONLY the touched
leaves are replaced — untouched leaves keep their jax.Array identity, so a
jitted `render_frame` closed over the same SceneMeta does not retrace and
XLA re-uses the resident buffers (the analogue of the reference's partial
`updateData` memcpys, Buffer.cpp:58-76).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from svgf_jax.core.lights import build_lights


def _is_emissive(material) -> bool:
    return any(e > 0.0 for e in material.emission)


def _light_arrays(scene, arrays):
    """Rebuild the light CDF arrays (reference lights::Build,
    Tracing.cpp:93-161). The light SET must be unchanged (same SceneMeta);
    only CDF values / areas may differ (e.g. an emissive instance moved)."""
    lights = build_lights(scene)
    assert lights.instance.shape[0] == arrays.meta.n_lights, (
        "light set changed — use Scene.flatten() (static SceneMeta differs)"
    )
    dtype = arrays.lights_cdf.dtype
    return dict(
        lights_cdf=jnp.asarray(lights.cdf, dtype),
        light_area=jnp.asarray(lights.total, dtype),
    )


def update_material(scene, arrays, index: int, material):
    """Edit one material (reference scene::UploadMaterial partial memcpy,
    Scene.cpp:447-451). Mutates scene.materials[index]; returns new arrays.

    If the edit toggles the emissive set or the media/opacity capability
    flags, the static SceneMeta changes and a full `scene.flatten()` is
    required instead (this function asserts that it is not).
    """
    old = scene.materials[index]
    assert _is_emissive(old) == _is_emissive(material), (
        "emissive set changed — light topology is static; re-flatten"
    )
    scene.materials[index] = material
    m = material
    f = arrays.mat_colour.dtype
    upd = dict(
        mat_emission=arrays.mat_emission.at[index].set(jnp.asarray(m.emission, f)),
        mat_colour=arrays.mat_colour.at[index].set(jnp.asarray(m.colour, f)),
        mat_roughness=arrays.mat_roughness.at[index].set(m.roughness),
        mat_metallic=arrays.mat_metallic.at[index].set(m.metallic),
        mat_anisotropy=arrays.mat_anisotropy.at[index].set(m.anisotropy),
        mat_opacity=arrays.mat_opacity.at[index].set(m.opacity),
        mat_scattering=arrays.mat_scattering.at[index].set(
            jnp.asarray(m.scattering_colour, f)
        ),
        mat_transmission_depth=arrays.mat_transmission_depth.at[index].set(
            m.transmission_depth
        ),
        mat_type=arrays.mat_type.at[index].set(int(m.material_type)),
    )
    if _is_emissive(material):
        # emission magnitude affects nothing in the CDF (area-weighted), but
        # keep parity with the reference GUI which rebuilds lights on
        # emissive-instance edits (GUI.cpp:1171-1174)
        upd.update(_light_arrays(scene, arrays))
    return dataclasses.replace(arrays, **upd)


def update_instance_transform(scene, arrays, index: int, transform):
    """Move one instance (reference sceneBVH::UpdateTLAS, BVH.cpp:509-518 +
    the GUI gizmo path GUI.cpp:1151-1178): recomputes the instance matrices,
    its world-soup triangle block, its world AABB, the stitched scene BVH
    (when present), and the light CDF when the instance is emissive.
    Everything else keeps buffer identity.
    """
    from svgf_jax.accel.bvh import _transform_aabbs, build_scene_bvh

    t = np.asarray(transform, np.float32)
    scene.instances[index].transform = t
    inst = scene.instances[index]
    sh = scene.shapes[inst.shape]
    f = arrays.inst_transform.dtype

    inv = np.linalg.inv(t.astype(np.float64)).astype(np.float32)
    upd = dict(
        inst_transform=arrays.inst_transform.at[index].set(jnp.asarray(t, f)),
        inst_inv_transform=arrays.inst_inv_transform.at[index].set(
            jnp.asarray(inv, f)
        ),
        inst_normal_transform=arrays.inst_normal_transform.at[index].set(
            jnp.asarray(inv.T, f)
        ),
    )

    # world-soup block (dense path + scene-BVH leaves read these)
    start, count = arrays.meta.inst_world_range[index]
    pw = sh.tri_pos.astype(np.float64) @ t[:3, :3].astype(np.float64).T + t[:3, 3]
    new9 = pw.reshape(count, 9).T.astype(np.float32)
    upd["world_tris9"] = arrays.world_tris9.at[:, start : start + count].set(
        jnp.asarray(new9, f)
    )
    lo, hi = _transform_aabbs(
        sh.blas.root_min[None], sh.blas.root_max[None], t.astype(np.float64)
    )
    upd["inst_aabb_min"] = arrays.inst_aabb_min.at[index].set(jnp.asarray(lo[0], f))
    upd["inst_aabb_max"] = arrays.inst_aabb_max.at[index].set(jnp.asarray(hi[0], f))

    if arrays.meta.has_scene_bvh:
        i_lo = np.array(arrays.inst_aabb_min)  # writable host copies
        i_hi = np.array(arrays.inst_aabb_max)
        i_lo[index], i_hi[index] = lo[0], hi[0]
        sbvh = build_scene_bvh(
            i_lo, i_hi,
            np.asarray([i.shape for i in scene.instances], np.int32),
            np.stack([np.asarray(i.transform, np.float32) for i in scene.instances]),
            [s.blas for s in scene.shapes],
            np.asarray([r[0] for r in arrays.meta.inst_world_range], np.int32),
        )
        assert sbvh.n_nodes == arrays.wbvh_skip.shape[0]
        upd["wbvh_bounds6"] = jnp.asarray(
            np.concatenate([sbvh.node_min.T, sbvh.node_max.T], axis=0), f
        )
        upd["wbvh_skip"] = jnp.asarray(sbvh.skip, jnp.int32)
        upd["wbvh_leaf_tri"] = jnp.asarray(sbvh.leaf_tri, jnp.int32)

    if _is_emissive(scene.materials[inst.material]):
        upd.update(_light_arrays(scene, arrays))
    return dataclasses.replace(arrays, **upd)


def remove_instance(scene, index: int):
    """Delete one instance (reference sceneBVH::RemoveInstance,
    BVH.cpp:519-534 + scene::RemoveInstance, Scene.cpp:441-445 + the GUI
    delete button, GUI.cpp:170-196).

    Removing an instance re-indexes the TLAS/world soup and can change the
    light set, i.e. the static SceneMeta — so, like the reference (which
    rebuilds the TLAS and re-uploads the instance buffers), this returns a
    full re-flatten; the jitted step retraces once for the new topology.
    """
    scene.instances.pop(index)
    return scene, scene.flatten()


def duplicate_instance(scene, index: int):
    """Duplicate one instance (GUI.cpp:198-215): same shape/material, same
    transform — the gizmo then moves the copy."""
    import copy

    scene.instances.append(copy.deepcopy(scene.instances[index]))
    return scene, scene.flatten()


def add_instance(scene, instance):
    """Append an instance of an existing shape (reference
    sceneBVH::AddInstance, BVH.cpp:536-547)."""
    assert 0 <= instance.shape < len(scene.shapes), "unknown shape index"
    assert 0 <= instance.material < len(scene.materials), "unknown material"
    scene.instances.append(instance)
    return scene, scene.flatten()


def add_shape(scene, shape, material: int | None = None, transform=None):
    """Append a shape (+ optionally an instance of it) — reference
    sceneBVH::AddShape, BVH.cpp:549-583 (which re-uploads the whole BLAS
    buffer set; here the re-flatten rebuilds the same concatenated arrays).
    Returns (scene, arrays, shape_index)."""
    scene.shapes.append(shape)
    shape_index = len(scene.shapes) - 1
    if material is not None:
        from svgf_jax.core.scene import Instance

        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(
            transform, np.float32
        )
        scene.instances.append(
            Instance(transform=t, shape=shape_index, material=material)
        )
    return scene, scene.flatten(), shape_index


def add_asset(scene, path: str):
    """Import an asset into a live scene (reference LoadAsset,
    AssetLoader.cpp:11-55) and re-flatten.

    Appending shapes/instances changes the static SceneMeta and every
    concatenated buffer (the reference likewise re-uploads the whole BLAS
    buffer set on AddShape, BVH.cpp:549-583), so this returns a full
    re-flatten — the jitted step retraces once for the new topology.
    """
    from svgf_jax.io.assets import load_asset

    load_asset(path, scene)
    return scene, scene.flatten()
