"""Texture subsystem tests — atlas stacking, sampling semantics
(reference textureSample/EvalTexture, Common.cuh:1329-1394), material
folding (EvalMaterial, Common.cuh:1440-1479), normal mapping
(EvalNormalMap, Common.cuh:1405-1418), and the parity default (fetch
stubbed to vec4(1), Common.cuh:1391)."""

import numpy as np
import jax.numpy as jnp
import pytest

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_jax.core.scene import Material, MaterialType
from svgf_jax.core.textures import build_texture_stack, to_rgba_u8
from svgf_jax.ops.texture import eval_texture, sample_texture, to_linear
from svgf_jax.scenes.cornell import cornell_box


def checkerboard(n=8, size=32):
    yy, xx = np.mgrid[0:size, 0:size]
    c = (((yy * n // size) + (xx * n // size)) % 2).astype(np.uint8) * 255
    img = np.stack([c, c, c, np.full_like(c, 255)], axis=-1)
    return img


def test_stack_and_sample_nearest():
    img = checkerboard(n=2, size=4)  # 2x2 blocks of 2px
    stack = jnp.asarray(build_texture_stack([img], size=4))
    # sample the center of each quadrant; nearest semantics
    uv = jnp.asarray([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9], [0.9, 0.9]])
    ids = jnp.zeros(4, jnp.int32)
    out = sample_texture(stack, ids, uv)
    # checkerboard: (0,0)=0, (1,0)=255, (0,1)=255, (1,1)=0
    np.testing.assert_allclose(out[:, 0], [0.0, 1.0, 1.0, 0.0], atol=1e-6)
    assert np.all(out[:, 3] == 1.0)


def test_wrap_semantics():
    """Negative coords mirrored as 1-c then frac (Common.cuh:1333-1337)."""
    img = np.zeros((4, 4, 4), np.uint8)
    img[0, :, 0] = 255  # top row red
    stack = jnp.asarray(build_texture_stack([img], size=4))
    ids = jnp.zeros(3, jnp.int32)
    # v=-0.9 -> 1-(-0.9)=1.9 -> frac 0.9 (bottom); v=1.1 -> frac 0.1 (top)
    uv = jnp.asarray([[0.5, -0.9], [0.5, 1.1], [0.5, 0.05]])
    out = sample_texture(stack, ids, uv)
    np.testing.assert_allclose(out[:, 0], [0.0, 1.0, 1.0], atol=1e-6)


def test_eval_texture_invalid_id_and_linear():
    img = np.full((2, 2, 4), 128, np.uint8)
    stack = jnp.asarray(build_texture_stack([img], size=2))
    uv = jnp.asarray([[0.5, 0.5], [0.5, 0.5]])
    ids = jnp.asarray([0, -1], jnp.int32)
    lin = eval_texture(stack, ids, uv, linear=True)
    raw = eval_texture(stack, ids, uv, linear=False)
    # INVALID_ID -> vec4(1) (Common.cuh:1388)
    np.testing.assert_allclose(lin[1], 1.0, atol=1e-6)
    np.testing.assert_allclose(raw[1], 1.0, atol=1e-6)
    # sRGB transfer on rgb only; alpha untouched (Common.cuh:204-211)
    srgb = 128.0 / 255.0
    expect = ((srgb + 0.055) / 1.055) ** 2.4
    np.testing.assert_allclose(lin[0, :3], expect, rtol=1e-5)
    np.testing.assert_allclose(lin[0, 3], srgb, rtol=1e-5)
    np.testing.assert_allclose(raw[0, :3], srgb, rtol=1e-5)


def test_to_rgba_u8_variants():
    g = np.random.default_rng(0).uniform(size=(3, 5)).astype(np.float32)
    assert to_rgba_u8(g).shape == (3, 5, 4)
    rgb = np.zeros((3, 5, 3), np.uint8)
    out = to_rgba_u8(rgb)
    assert out.shape == (3, 5, 4) and np.all(out[..., 3] == 255)


def _textured_cornell(texture, mat_kw=None):
    scene = cornell_box()
    scene.textures = [texture]
    scene.textures_enabled = True
    for k, v in (mat_kw or {}).items():
        setattr(scene.materials[0], k, v)
    return scene


def test_textured_render_differs():
    """A colour texture must change the render; the parity default
    (textures_enabled=False = the reference's vec4(1) stub) must not."""
    from svgf_jax.render.pipeline import render_frame
    from svgf_jax.render.types import TemporalState

    config = RenderConfig(
        width=64, height=48, state_dtype="float32",
        tracing=TracingConfig(bounces=2),
        svgf=SVGFConfig(spatial_filter_steps=1),
    )
    base = cornell_box()
    out_plain, _ = render_frame(
        base.flatten(), TemporalState.initial(48, 64, jnp.float32), config
    )

    tex = checkerboard(n=4, size=16)
    textured = _textured_cornell(tex, mat_kw={"colour_texture": 0})
    arrays = textured.flatten()
    assert arrays.meta.textures_enabled
    out_tex, _ = render_frame(
        arrays, TemporalState.initial(48, 64, jnp.float32), config
    )

    # textures DISABLED (stub parity): identical to the untextured scene
    stub = _textured_cornell(tex, mat_kw={"colour_texture": 0})
    stub.textures_enabled = False
    out_stub, _ = render_frame(
        stub.flatten(), TemporalState.initial(48, 64, jnp.float32), config
    )
    np.testing.assert_allclose(
        np.asarray(out_stub.radiance), np.asarray(out_plain.radiance), atol=1e-6
    )
    diff = np.abs(np.asarray(out_tex.radiance) - np.asarray(out_plain.radiance))
    assert diff.max() > 0.01, "colour texture had no effect on the render"


def test_alpha_texture_sets_has_opacity():
    """ADVICE.md: colour textures with alpha < 1 must compile in the
    opacity pass-through (reference Point.Opacity = Material.Opacity *
    ColourTexture.w, Common.cuh:1458)."""
    tex = checkerboard(n=2, size=8)
    tex[..., 3] = 128
    scene = _textured_cornell(tex, mat_kw={"colour_texture": 0})
    arrays = scene.flatten()
    assert arrays.meta.has_opacity
    # opaque texture -> flag driven by material opacity only
    scene2 = _textured_cornell(checkerboard(n=2, size=8),
                               mat_kw={"colour_texture": 0})
    assert not scene2.flatten().meta.has_opacity


def test_normal_map_changes_first_normal():
    from svgf_jax.ops.intersect import intersect_scene
    from svgf_jax.render.pathtrace import _shading_point

    # a normal map tilting everything toward +x in tangent space
    nm = np.zeros((4, 4, 4), np.uint8)
    nm[..., 0] = 255   # tangent x = +1
    nm[..., 1] = 128   # y ~ 0
    nm[..., 2] = 128   # z ~ 0
    nm[..., 3] = 255
    scene = _textured_cornell(nm, mat_kw={"normal_texture": 0})
    arrays = scene.flatten()
    assert arrays.meta.has_normal_maps

    ro = jnp.asarray([[0.0, 1.0, 3.0]])
    rd = jnp.asarray([[0.0, 0.0, -1.0]])  # hits the back wall
    hit = intersect_scene(arrays, ro, rd)
    sh = _shading_point(arrays, hit, -rd)

    plain = cornell_box().flatten()
    hit_p = intersect_scene(plain, ro, rd)
    sh_p = _shading_point(plain, hit_p, -rd)
    assert float(jnp.abs(sh.normal - sh_p.normal).max()) > 0.1
    # still unit length
    np.testing.assert_allclose(
        float(jnp.linalg.norm(sh.normal[0])), 1.0, rtol=1e-5
    )


def test_gltf_texture_import(tmp_path):
    """glTF with an embedded (data-URI) PNG texture round-trips into
    scene.textures + material slots (reference GLTFLoader.cpp:16-71)."""
    import base64
    import json

    from svgf_jax.io.gltf import load_gltf
    from svgf_jax.utils.image import write_png

    png_path = tmp_path / "t.png"
    write_png(str(png_path), checkerboard(n=2, size=8)[..., :3])
    with open(png_path, "rb") as f:
        png_b64 = base64.b64encode(f.read()).decode()

    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    buf = pos.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode(),
                     "byteLength": len(buf)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(buf)}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]}],
        "images": [{"uri": f"data:image/png;base64,{png_b64}"}],
        "textures": [{"source": 0}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
        }}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "material": 0}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    p = tmp_path / "scene.gltf"
    p.write_text(json.dumps(doc))
    scene = load_gltf(str(p))
    assert len(scene.textures) == 1
    assert scene.textures[0].shape[2] in (3, 4)
    assert scene.materials[0].colour_texture == 0
    assert scene.materials[0].emission_texture == -1


def test_scene_npz_texture_roundtrip(tmp_path):
    from svgf_jax.io.serialization import load_scene_npz, save_scene_npz

    scene = _textured_cornell(checkerboard(n=2, size=8),
                              mat_kw={"colour_texture": 0})
    p = str(tmp_path / "s.npz")
    save_scene_npz(p, scene)
    back = load_scene_npz(p)
    assert len(back.textures) == 1
    assert back.textures_enabled
    assert back.materials[0].colour_texture == 0
    np.testing.assert_array_equal(back.textures[0], scene.textures[0])


def test_hdr_roundtrip(tmp_path):
    from svgf_jax.utils.image import read_hdr, write_hdr

    img = np.abs(
        np.random.default_rng(0).normal(1.0, 2.0, (9, 17, 3))
    ).astype(np.float32)
    p = str(tmp_path / "t.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    tol = img.max(axis=-1, keepdims=True) / 128.0  # RGBE shared-exponent precision
    assert np.all(np.abs(back - img) <= tol)
