"""PLY/STL/OFF loaders (io.plyloader, io.stlloader) + asset dispatch."""

import struct

import numpy as np
import pytest

from svgf_jax.io.plyloader import load_ply
from svgf_jax.io.stlloader import load_off, load_stl

# a unit right tetrahedron: 4 vertices, 4 faces
TET_V = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32
)
TET_F = np.array(
    [[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32
)


def _check_tet(shape, welded=False):
    shape.preprocess()
    assert shape.tri_pos.shape == (4, 3, 3)
    # area sum is weld/order independent
    v = shape.tri_pos
    area = 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1
    ).sum()
    assert np.isclose(area, 1.5 + np.sqrt(3) / 2, atol=1e-5)  # 3 right + oblique
    if not welded:
        np.testing.assert_allclose(
            np.sort(shape.positions, axis=0), np.sort(TET_V, axis=0)
        )


def test_ply_ascii(tmp_path):
    p = tmp_path / "tet.ply"
    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {len(TET_V)}",
        "property float x", "property float y", "property float z",
        f"element face {len(TET_F)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    for v in TET_V:
        lines.append(" ".join(str(float(x)) for x in v))
    for f in TET_F:
        lines.append("3 " + " ".join(str(int(i)) for i in f))
    p.write_text("\n".join(lines) + "\n")
    shape = load_ply(str(p))
    np.testing.assert_allclose(shape.positions, TET_V)
    np.testing.assert_array_equal(shape.indices, TET_F)
    _check_tet(shape)


def test_ply_binary_little_endian(tmp_path):
    p = tmp_path / "tet_bin.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(TET_V)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        f"element face {len(TET_F)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode()
    body = b""
    nrm = TET_V / np.maximum(np.linalg.norm(TET_V, axis=1, keepdims=True), 1)
    for v, n in zip(TET_V, nrm):
        body += struct.pack("<6f", *v, *n)
    for f in TET_F:
        body += struct.pack("<B3i", 3, *f)
    p.write_bytes(header + body)
    shape = load_ply(str(p))
    np.testing.assert_allclose(shape.positions, TET_V)
    np.testing.assert_array_equal(shape.indices, TET_F)
    np.testing.assert_allclose(shape.normals, nrm, atol=1e-6)


def test_ply_quad_fan(tmp_path):
    p = tmp_path / "quad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
        "4 0 1 2 3\n"
    )
    shape = load_ply(str(p))
    assert shape.indices.shape == (2, 3)  # triangulated fan


def test_stl_binary(tmp_path):
    p = tmp_path / "tet.stl"
    data = b"\0" * 80 + struct.pack("<I", len(TET_F))
    for f in TET_F:
        tri = TET_V[f]
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        n = n / max(np.linalg.norm(n), 1e-9)
        data += struct.pack("<3f", *n)
        for v in tri:
            data += struct.pack("<3f", *v)
        data += struct.pack("<H", 0)
    p.write_bytes(data)
    shape = load_stl(str(p))
    assert shape.positions.shape == (4, 3)  # welded back to 4 vertices
    _check_tet(shape, welded=True)


def test_stl_ascii(tmp_path):
    p = tmp_path / "tet_ascii.stl"
    out = ["solid tet"]
    for f in TET_F:
        tri = TET_V[f]
        out.append(" facet normal 0 0 0\n  outer loop")
        for v in tri:
            out.append(f"   vertex {v[0]} {v[1]} {v[2]}")
        out.append("  endloop\n endfacet")
    out.append("endsolid tet")
    p.write_text("\n".join(out))
    shape = load_stl(str(p))
    assert shape.positions.shape == (4, 3)
    _check_tet(shape, welded=True)


def test_off(tmp_path):
    p = tmp_path / "tet.off"
    lines = ["OFF", f"{len(TET_V)} {len(TET_F)} 0"]
    for v in TET_V:
        lines.append(" ".join(str(float(x)) for x in v))
    for f in TET_F:
        lines.append("3 " + " ".join(str(int(i)) for i in f))
    p.write_text("\n".join(lines) + "\n")
    shape = load_off(str(p))
    np.testing.assert_allclose(shape.positions, TET_V)
    np.testing.assert_array_equal(shape.indices, TET_F)


@pytest.mark.parametrize("ext", ["ply", "stl", "off"])
def test_dispatch_and_flatten(tmp_path, ext):
    from svgf_jax.core.scene import Material, Scene
    from svgf_jax.io.assets import load_asset

    p = tmp_path / f"tet.{ext}"
    if ext == "ply":
        test_ply_ascii.__wrapped__(tmp_path) if hasattr(
            test_ply_ascii, "__wrapped__"
        ) else test_ply_ascii(tmp_path)
    elif ext == "stl":
        test_stl_binary(tmp_path)
        p = tmp_path / "tet.stl"
    else:
        test_off(tmp_path)
    scene = Scene()
    scene.materials.append(Material())
    scene = load_asset(str(p), scene, material=0)
    assert len(scene.shapes) == 1 and len(scene.instances) == 1
    from svgf_jax.core.camera import Camera

    scene.cameras.append(Camera())
    arr = scene.flatten()
    assert arr.meta.n_world_tris == 4
