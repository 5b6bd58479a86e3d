"""Asset IO: reference binary scene, OBJ, glTF, npz round-trip, checkpoints."""

import base64
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from svgf_jax.io import (
    load_asset,
    load_checkpoint,
    load_gltf,
    load_obj,
    load_reference_scene,
    load_scene_npz,
    save_checkpoint,
    save_scene_npz,
)
from svgf_jax.render.types import TemporalState
from svgf_jax.scenes import cornell_box

REF_SCENE = "/root/reference/resources/Scenes/BaseScene"


@pytest.mark.skipif(not os.path.exists(REF_SCENE), reason="reference not mounted")
def test_load_reference_binary_scene():
    s = load_reference_scene(REF_SCENE)
    assert len(s.cameras) == 1
    assert len(s.shapes) == 14
    assert len(s.instances) == 9
    assert len(s.materials) == 12
    total = sum(sh.n_triangles for sh in s.shapes)
    assert total == 5672
    # flattens into device arrays (BVH build etc.)
    arrays = s.flatten()
    assert arrays.meta.n_world_tris > 0
    assert arrays.meta.n_lights >= 1  # the emissive "Light" instance
    # all shapes have sane geometry
    for sh in s.shapes:
        assert np.isfinite(sh.tri_pos).all()


def test_obj_loader(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\nf 2/2/1 4/1/1 3/3/1\n"
    )
    shape = load_obj(str(obj))
    assert shape.n_triangles == 2
    shape.preprocess()
    assert np.allclose(shape.tri_nrm, [0, 0, 1])


def _tiny_gltf(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    buf = pos.tobytes() + idx.tobytes() + b"\x00\x00"
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, -2], "name": "tri"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.25, 0.125, 1.0],
                                                 "metallicFactor": 0.0, "roughnessFactor": 1.0}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{
            "byteLength": len(buf),
            "uri": "data:application/octet-stream;base64," + base64.b64encode(buf).decode(),
        }],
    }
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(doc))
    return str(p)


def test_gltf_loader(tmp_path):
    scene = load_gltf(_tiny_gltf(tmp_path))
    assert len(scene.shapes) == 1
    assert len(scene.instances) == 1
    assert scene.shapes[0].n_triangles == 1
    np.testing.assert_allclose(scene.instances[0].transform[:3, 3], [0, 0, -2])
    np.testing.assert_allclose(scene.materials[0].colour, [0.5, 0.25, 0.125])


def test_asset_dispatch(tmp_path):
    from svgf_jax.core.scene import Scene

    path = _tiny_gltf(tmp_path)
    s = load_asset(path, Scene())
    assert len(s.instances) == 1


def test_scene_npz_roundtrip(tmp_path):
    s = cornell_box()
    path = str(tmp_path / "scene.npz")
    save_scene_npz(path, s)
    s2 = load_scene_npz(path)
    assert len(s2.shapes) == len(s.shapes)
    assert len(s2.instances) == len(s.instances)
    a1 = s.flatten()
    a2 = s2.flatten()
    np.testing.assert_allclose(np.asarray(a1.tri_pos), np.asarray(a2.tri_pos))
    np.testing.assert_allclose(np.asarray(a1.mat_colour), np.asarray(a2.mat_colour))
    np.testing.assert_allclose(np.asarray(a1.cam_frame), np.asarray(a2.cam_frame))


def test_checkpoint_roundtrip(tmp_path):
    state = TemporalState.initial(16, 24, jnp.float32)
    state = state._replace(
        color=state.color + 0.25,
        history_len=state.history_len + 3,
        frame_idx=jnp.int32(7),
    )
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    s2 = load_checkpoint(path)
    np.testing.assert_allclose(np.asarray(s2.color), 0.25)
    assert int(s2.frame_idx) == 7
    assert int(s2.history_len[0, 0]) == 3


def test_binscene_write_read_roundtrip(tmp_path):
    """Reference-binary writer (scene::ToFile, Scene.cpp:515-549) round-trips
    through our reader: same geometry, materials, instances, camera."""
    from svgf_jax.io.binscene import load_reference_scene, save_reference_scene

    s = cornell_box()
    path = str(tmp_path / "scene.bin")
    save_reference_scene(s, path)
    s2 = load_reference_scene(path)
    assert len(s2.shapes) == len(s.shapes)
    assert len(s2.instances) == len(s.instances)
    assert len(s2.materials) == len(s.materials)
    a1 = s.flatten()
    a2 = s2.flatten()
    np.testing.assert_allclose(np.asarray(a1.tri_pos), np.asarray(a2.tri_pos),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(a1.mat_colour), np.asarray(a2.mat_colour))
    np.testing.assert_allclose(np.asarray(a1.mat_emission), np.asarray(a2.mat_emission))
    np.testing.assert_allclose(np.asarray(a1.inst_transform),
                               np.asarray(a2.inst_transform), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a1.cam_frame), np.asarray(a2.cam_frame),
                               atol=1e-6)
    assert a1.meta.n_lights == a2.meta.n_lights
