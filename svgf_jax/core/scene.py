"""Scene data model + flattening to device arrays.

Host side mirrors the reference scene (Scene.h:172-226): lists of cameras /
instances / shapes / materials / environments with the same semantics
(shape::PreProcess normals/tangents, Scene.cpp:111-217; instance transforms,
Scene.cpp:355-373). Device side is a single `SceneArrays` pytree of SoA
jnp arrays — the analogue of the reference's flattened GPU buffers
(BVH.cpp:419-488, Scene.cpp:478-481) — replicated across chips.
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np

from svgf_jax.accel.bvh import BLAS, FlatBVH, build_blas, flatten_blases
from svgf_jax.core.camera import Camera
from svgf_jax.core.lights import build_lights

INVALID_ID = -1


class MaterialType(enum.IntEnum):
    """Reference Scene.h:11-15."""

    MATTE = 0
    PBR = 1
    VOLUMETRIC = 2
    GLASS = 3
    SUBSURFACE = 4


@dataclasses.dataclass
class Material:
    """Reference material POD (Scene.h:69-89)."""

    emission: tuple = (0.0, 0.0, 0.0)
    colour: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    metallic: float = 0.0
    anisotropy: float = 0.0
    material_type: MaterialType = MaterialType.MATTE
    opacity: float = 1.0
    scattering_colour: tuple = (0.0, 0.0, 0.0)
    transmission_depth: float = 0.01
    emission_texture: int = INVALID_ID
    colour_texture: int = INVALID_ID
    roughness_texture: int = INVALID_ID
    normal_texture: int = INVALID_ID


@dataclasses.dataclass
class Shape:
    """A triangle mesh. PreProcess follows reference Scene.cpp:163-285."""

    positions: np.ndarray                  # (V, 3) f32
    indices: np.ndarray                    # (F, 3) i32
    normals: np.ndarray | None = None      # (V, 3)
    uvs: np.ndarray | None = None          # (V, 2)
    tangents: np.ndarray | None = None     # (V, 4)
    name: str = "shape"

    # filled by preprocess():
    tri_pos: np.ndarray | None = None      # (F, 3, 3)
    tri_nrm: np.ndarray | None = None      # (F, 3, 3)
    tri_uv: np.ndarray | None = None       # (F, 3, 2)
    tri_tan: np.ndarray | None = None      # (F, 3, 4)
    blas: BLAS | None = None

    def preprocess(self) -> "Shape":
        P = np.asarray(self.positions, dtype=np.float32)
        F = np.asarray(self.indices, dtype=np.int64)
        if self.normals is None:
            # flat per-face normals scattered to vertices (Scene.cpp:166-180)
            N = np.zeros_like(P)
            v0, v1, v2 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
            fn = np.cross(v1 - v0, v2 - v0)
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            N[F[:, 0]] = fn
            N[F[:, 1]] = fn
            N[F[:, 2]] = fn
            self.normals = N
        if self.uvs is None:
            self.uvs = np.zeros((P.shape[0], 2), dtype=np.float32)
        if self.tangents is None:
            import os

            self.tangents = None
            if os.environ.get("SVGF_NATIVE", "1") != "0":
                from svgf_jax.accel.native import tangents_native

                self.tangents = tangents_native(
                    P, np.asarray(self.normals, np.float32),
                    np.asarray(self.uvs, np.float32), F.astype(np.int32),
                )
            if self.tangents is None:
                self.tangents = _lengyel_tangents(
                    P, np.asarray(self.normals), np.asarray(self.uvs), F
                )

        self.tri_pos = P[F]                                   # (F,3,3)
        self.tri_nrm = np.asarray(self.normals, np.float32)[F]
        self.tri_uv = np.asarray(self.uvs, np.float32)[F]
        self.tri_tan = np.asarray(self.tangents, np.float32)[F]
        self.blas = build_blas(self.tri_pos)
        return self

    @property
    def n_triangles(self) -> int:
        return int(np.asarray(self.indices).shape[0])


def _lengyel_tangents(P: np.ndarray, N: np.ndarray, UV: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Per-vertex tangents, Lengyel's method (reference Scene.cpp:111-161)."""
    tan1 = np.zeros((P.shape[0], 3), dtype=np.float64)
    tan2 = np.zeros((P.shape[0], 3), dtype=np.float64)
    v1, v2, v3 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
    w1, w2, w3 = UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]]
    e1 = (v2 - v1).astype(np.float64)
    e2 = (v3 - v1).astype(np.float64)
    s1 = (w2 - w1).astype(np.float64)
    s2 = (w3 - w1).astype(np.float64)
    det = s1[:, 0] * s2[:, 1] - s2[:, 0] * s1[:, 1]
    r = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    sdir = (s2[:, 1:2] * e1 - s1[:, 1:2] * e2) * r
    tdir = (s1[:, 0:1] * e2 - s2[:, 0:1] * e1) * r
    for k in range(3):
        np.add.at(tan1, F[:, k], sdir)
        np.add.at(tan2, F[:, k], tdir)
    n = N.astype(np.float64)
    t = tan1
    ortho = t - n * np.sum(n * t, axis=-1, keepdims=True)
    norm = np.linalg.norm(ortho, axis=-1, keepdims=True)
    # degenerate UVs: fall back to an arbitrary perpendicular
    fallback = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9,
                                    np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]])))
    ortho = np.where(norm > 1e-12, ortho, fallback)
    ortho /= np.maximum(np.linalg.norm(ortho, axis=-1, keepdims=True), 1e-20)
    w = np.where(np.sum(np.cross(n, t) * tan2, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([ortho, w[:, None]], axis=-1).astype(np.float32)


@dataclasses.dataclass
class Instance:
    """Reference instance (Scene.h:104-115): transform + shape/material refs."""

    shape: int
    material: int
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    name: str = "instance"


@dataclasses.dataclass
class Environment:
    """IBL environment (Scene.h:161-170)."""

    emission: tuple = (1.0, 1.0, 1.0)
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    emission_texture: int = INVALID_ID


# ---------------------------------------------------------------------------
# Device-side flattened scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene topology — baked into the jit trace.

    Light/environment structure must be static so device code can emit one
    specialized branch per light (the reference's per-thread dynamic loops
    over lights, Common.cuh:635-715, become static unrolls here).
    """

    n_instances: int
    n_lights: int
    n_envs: int
    light_instance: tuple      # per light: instance id or -1
    light_env: tuple           # per light: environment id or -1
    light_cdf_start: tuple
    light_cdf_count: tuple
    light_tri_start: tuple     # per light: global triangle base of its shape (-1 env)
    env_tex: tuple             # per environment: emission texture id or -1
    n_world_tris: int = 0      # unpadded world-triangle-soup size
    inst_world_range: tuple = ()  # per instance: (start, count) in the soup
    # static capability flags: when False the tracer compiles the media /
    # opacity machinery out entirely (zero cost for plain surface scenes)
    has_media: bool = False    # any VOLUMETRIC/GLASS/SUBSURFACE material
    has_opacity: bool = False  # any material with opacity < 1
    # scene-texture fetch. The reference STUBS this to vec4(1)
    # (Common.cuh:1391) — textures_enabled=False is the parity default;
    # True compiles real atlas sampling into the tracer (PARITY.md).
    textures_enabled: bool = False
    has_normal_maps: bool = False  # any material with a normal texture
    # True when the stitched scene BVH is the closest-hit path (soup larger
    # than the dense-intersector crossover, ops.intersect.DENSE_MAX_TRIS)
    has_scene_bvh: bool = False
    # material types present in the scene: the BSDF dispatchers only compile
    # the lobes a scene actually uses (an all-matte scene skips the whole
    # microfacet/glass machinery — the reference's per-thread switch costs
    # nothing per absent case, Common.cuh:1197-1267; lockstep lanes would
    # otherwise pay for every lobe on every lane)
    mat_types_used: tuple = (0, 1, 2, 3, 4)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Everything the device kernels need, as replicated SoA arrays."""

    meta: SceneMeta = dataclasses.field(metadata=dict(static=True))

    # triangles (all shapes concatenated)
    tri_pos: jax.Array       # (T, 3, 3) f32
    tri_nrm: jax.Array       # (T, 3, 3) f32
    tri_uv: jax.Array        # (T, 3, 2) f32
    tri_tan: jax.Array       # (T, 3, 4) f32
    # threaded BVH (see accel.bvh.FlatBVH)
    bvh_node_min: jax.Array  # (N, 3) f32
    bvh_node_max: jax.Array  # (N, 3) f32
    bvh_skip: jax.Array      # (N,) i32
    bvh_tri_first: jax.Array # (N,) i32
    bvh_tri_count: jax.Array # (N,) i32
    bvh_tri_order: jax.Array # (O,) i32
    # traversal mirrors: row-major component arrays so every gather inside
    # the traversal loop reads (R,) columns
    bvh_bounds6: jax.Array   # (6, N) f32: min_xyz, max_xyz rows
    bvh_leaf_tri: jax.Array  # (N,) i32: global triangle id at leaf, -1 internal
    tri_verts9: jax.Array    # (9, T) f32: v0xyz, v1xyz, v2xyz rows
    # dense-intersector world-space triangle soup (every instance's triangles
    # pre-transformed to world space, padded to a multiple of 128 with
    # degenerate triangles): zero-gather (rays x tri-chunk) intersection for
    # small scenes
    world_tris9: jax.Array   # (9, TW) f32
    world_tri_inst: jax.Array  # (TW,) i32, -1 = padding
    world_tri_mat: jax.Array   # (TW,) i32
    world_tri_prim: jax.Array  # (TW,) i32 — object-space global triangle id
    # stitched two-level scene BVH (accel.bvh.build_scene_bvh): TLAS
    # hierarchy over instances + world-transformed BLAS subtrees, one flat
    # skip-linked array — the traversal form of the reference IntersectTLAS
    # (PathTrace.cuh:90-142). Built when the soup exceeds the dense-path
    # crossover (meta.has_scene_bvh); a 1-node placeholder otherwise.
    wbvh_bounds6: jax.Array  # (6, NW) f32: min_xyz, max_xyz rows
    wbvh_skip: jax.Array     # (NW,) i32
    wbvh_leaf_tri: jax.Array # (NW,) i32 — world-soup column at leaf, -1 internal
    # per-instance world AABBs (8-corner transform, Scene.cpp:355-373) —
    # used for instance culling in the per-instance traversal path
    inst_aabb_min: jax.Array # (I, 3) f32
    inst_aabb_max: jax.Array # (I, 3) f32
    shape_node_start: jax.Array  # (S,) i32
    shape_node_count: jax.Array  # (S,) i32
    shape_tri_start: jax.Array   # (S,) i32 — global triangle base per shape
    shape_tri_count: jax.Array   # (S,) i32
    # instances
    inst_transform: jax.Array    # (I, 4, 4) f32
    inst_inv_transform: jax.Array
    inst_normal_transform: jax.Array
    inst_shape: jax.Array        # (I,) i32
    inst_material: jax.Array     # (I,) i32
    # materials
    mat_emission: jax.Array      # (M, 3)
    mat_colour: jax.Array        # (M, 3)
    mat_roughness: jax.Array     # (M,)
    mat_metallic: jax.Array      # (M,)
    mat_anisotropy: jax.Array    # (M,)
    mat_opacity: jax.Array       # (M,)
    mat_scattering: jax.Array    # (M, 3)
    mat_transmission_depth: jax.Array  # (M,)
    mat_type: jax.Array          # (M,) i32
    # per-material texture slots (reference material POD, Scene.h:69-89)
    mat_emission_tex: jax.Array  # (M,) i32, INVALID_ID = none
    mat_colour_tex: jax.Array    # (M,) i32
    mat_roughness_tex: jax.Array # (M,) i32
    mat_normal_tex: jax.Array    # (M,) i32
    # stacked scene-texture atlas (core.textures.build_texture_stack) —
    # the stacked form of the reference's 8192^2 atlas (TextureArrayCu.cu:24-84)
    textures: jax.Array          # (K, S, S, 4) u8
    # lights
    light_instance: jax.Array    # (L,) i32 (INVALID_ID for env lights)
    light_env: jax.Array         # (L,) i32
    light_cdf_start: jax.Array   # (L,) i32
    light_cdf_count: jax.Array   # (L,) i32
    lights_cdf: jax.Array        # (C,) f32
    light_area: jax.Array        # (L,) f32 — total area (last CDF entry)
    # environments
    env_transform: jax.Array     # (E, 4, 4)
    env_inv_transform: jax.Array # (E, 4, 4)
    env_emission: jax.Array      # (E, 3)
    env_tex: jax.Array           # (E,) i32
    env_textures: jax.Array      # (K, He, We, 3) f32 equirect maps
    # cameras
    cam_frame: jax.Array         # (C, 4, 4)
    cam_prev_frame: jax.Array    # (C, 4, 4)
    cam_proj: jax.Array          # (C, 4, 4)

    @property
    def n_triangles(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def n_instances(self) -> int:
        return self.inst_shape.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_instance.shape[0]

    @property
    def n_environments(self) -> int:
        return self.env_emission.shape[0]


@dataclasses.dataclass
class Scene:
    """Host-side scene container (reference scene struct, Scene.h:172-226)."""

    cameras: list = dataclasses.field(default_factory=list)
    shapes: list = dataclasses.field(default_factory=list)
    instances: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    environments: list = dataclasses.field(default_factory=list)
    env_textures: list = dataclasses.field(default_factory=list)  # (He,We,3) float arrays
    textures: list = dataclasses.field(default_factory=list)      # (H,W,4) u8/float images
    # Real scene-texture sampling. False (default) reproduces the reference's
    # vec4(1) fetch stub (Common.cuh:1391); True enables the atlas machinery.
    textures_enabled: bool = False

    def preprocess(self) -> "Scene":
        for s in self.shapes:
            if s.blas is None:
                s.preprocess()
        return self

    def flatten(self, dtype=jnp.float32) -> SceneArrays:
        """Build every flattened device buffer (reference scene::PreProcess)."""
        self.preprocess()
        shapes = self.shapes

        tri_pos = np.concatenate([s.tri_pos for s in shapes], axis=0)
        tri_nrm = np.concatenate([s.tri_nrm for s in shapes], axis=0)
        tri_uv = np.concatenate([s.tri_uv for s in shapes], axis=0)
        tri_tan = np.concatenate([s.tri_tan for s in shapes], axis=0)
        flat: FlatBVH = flatten_blases([s.blas for s in shapes], [s.n_triangles for s in shapes])

        inst_t = np.stack([np.asarray(i.transform, np.float32) for i in self.instances])
        inst_inv = np.stack([np.linalg.inv(t) for t in inst_t]).astype(np.float32)
        inst_nrm = np.stack([np.linalg.inv(t).T for t in inst_t]).astype(np.float32)

        mats = self.materials
        lights = build_lights(self)

        env_t = (
            np.stack([np.asarray(e.transform, np.float32) for e in self.environments])
            if self.environments
            else np.zeros((0, 4, 4), np.float32)
        )
        env_inv = (
            np.stack([np.linalg.inv(t) for t in env_t]).astype(np.float32)
            if self.environments
            else np.zeros((0, 4, 4), np.float32)
        )
        if self.env_textures:
            envs = [np.asarray(t, np.float32) for t in self.env_textures]
            if len({e.shape for e in envs}) > 1:
                # mixed resolutions: resize to the largest (the reference
                # resizes every env map into a fixed atlas slot, Scene.cpp:643)
                from svgf_jax.core.textures import resize_nearest

                he = max(e.shape[0] for e in envs)
                we = max(e.shape[1] for e in envs)
                envs = [resize_nearest(e, he, we) for e in envs]
            et = np.stack(envs)
        else:
            et = np.zeros((1, 1, 2, 3), np.float32)  # placeholder, never indexed

        cam_frame = np.stack([c.frame for c in self.cameras])
        cam_prev = np.stack([c.previous_frame for c in self.cameras])
        cam_proj = np.stack([c.projection for c in self.cameras])

        # world-space triangle soup for the dense intersector
        from svgf_jax.ops.intersect import DENSE_MAX_TRIS as _DENSE_MAX

        total_world = sum(
            self.shapes[i.shape].n_triangles for i in self.instances
        )
        ws9, ws_inst, ws_mat, ws_prim, inst_ws = [], [], [], [], []
        cursor = 0
        for i, inst in enumerate(self.instances):
            sh = self.shapes[inst.shape]
            t = np.asarray(inst.transform, np.float64)
            pw = sh.tri_pos.astype(np.float64) @ t[:3, :3].T + t[:3, 3]  # (F,3,3)
            prim = np.arange(sh.n_triangles, dtype=np.int32)
            ws9.append(pw.reshape(pw.shape[0], 9).T.astype(np.float32))
            n = sh.n_triangles
            ws_inst.append(np.full(n, i, np.int32))
            ws_mat.append(np.full(n, inst.material, np.int32))
            ws_prim.append(prim + int(flat.shape_tri_start[inst.shape]))
            inst_ws.append((cursor, n))
            cursor += n
        world9 = np.concatenate(ws9, axis=1) if ws9 else np.zeros((9, 0), np.float32)
        tw = world9.shape[1]
        tw_pad = max(128, -(-tw // 128) * 128)
        pad = tw_pad - tw
        world9 = np.pad(world9, ((0, 0), (0, pad)))
        w_inst = np.pad(np.concatenate(ws_inst) if ws_inst else np.zeros(0, np.int32),
                        (0, pad), constant_values=-1)
        w_mat = np.pad(np.concatenate(ws_mat) if ws_mat else np.zeros(0, np.int32),
                       (0, pad))
        w_prim = np.pad(np.concatenate(ws_prim) if ws_prim else np.zeros(0, np.int32),
                        (0, pad))
        # per-instance world AABBs (8-corner transform of the BLAS root box,
        # reference scene::CalculateInstanceTransform, Scene.cpp:355-373)
        from svgf_jax.accel.bvh import _transform_aabbs, build_scene_bvh

        DENSE_MAX_TRIS = _DENSE_MAX

        if self.instances:
            roots_lo = np.stack(
                [self.shapes[i.shape].blas.root_min for i in self.instances]
            )
            roots_hi = np.stack(
                [self.shapes[i.shape].blas.root_max for i in self.instances]
            )
            i_lo = np.zeros((len(self.instances), 3), np.float32)
            i_hi = np.zeros((len(self.instances), 3), np.float32)
            for k, i in enumerate(self.instances):
                lo, hi = _transform_aabbs(
                    roots_lo[k : k + 1], roots_hi[k : k + 1],
                    np.asarray(i.transform, np.float64),
                )
                i_lo[k], i_hi[k] = lo[0], hi[0]
        else:
            i_lo = np.zeros((0, 3), np.float32)
            i_hi = np.zeros((0, 3), np.float32)

        has_scene_bvh = tw > DENSE_MAX_TRIS
        if has_scene_bvh:
            sbvh = build_scene_bvh(
                i_lo, i_hi,
                np.asarray([i.shape for i in self.instances], np.int32),
                np.stack([np.asarray(i.transform, np.float32) for i in self.instances]),
                [s.blas for s in self.shapes],
                np.asarray([r[0] for r in inst_ws], np.int32),
            )
            wbvh_bounds6 = np.concatenate([sbvh.node_min.T, sbvh.node_max.T], axis=0)
            wbvh_skip = sbvh.skip
            wbvh_leaf = sbvh.leaf_tri
        else:
            wbvh_bounds6 = np.zeros((6, 1), np.float32)
            wbvh_skip = np.ones((1,), np.int32)
            wbvh_leaf = np.full((1,), -1, np.int32)

        light_tri_start = tuple(
            int(flat.shape_tri_start[self.instances[int(li)].shape]) if li >= 0 else -1
            for li in lights.instance
        )

        from svgf_jax.core.textures import build_texture_stack, texture_alpha_min

        tex_on = bool(self.textures_enabled and self.textures)
        tex_stack = build_texture_stack(self.textures if tex_on else [])
        tex_alpha = texture_alpha_min(self.textures) if tex_on else []

        meta = SceneMeta(
            n_instances=len(self.instances),
            n_lights=int(lights.instance.shape[0]),
            n_envs=len(self.environments),
            light_instance=tuple(int(x) for x in lights.instance),
            light_env=tuple(int(x) for x in lights.environment),
            light_cdf_start=tuple(int(x) for x in lights.cdf_start),
            light_cdf_count=tuple(int(x) for x in lights.cdf_count),
            light_tri_start=light_tri_start,
            env_tex=tuple(int(e.emission_texture) for e in self.environments),
            n_world_tris=tw,
            inst_world_range=tuple(inst_ws),
            has_media=any(
                m.material_type in (MaterialType.VOLUMETRIC, MaterialType.GLASS,
                                    MaterialType.SUBSURFACE)
                for m in self.materials
            ),
            # The reference folds the colour texture's alpha into opacity
            # (Point.Opacity = Material.Opacity * ColourTexture.w,
            # Common.cuh:1458) — with textures enabled, materials whose
            # colour texture carries alpha < 1 also need the pass-through
            # machinery compiled in.
            has_opacity=any(
                m.opacity < 1.0
                or (
                    tex_on
                    and 0 <= m.colour_texture < len(tex_alpha)
                    and tex_alpha[m.colour_texture] < 1.0
                )
                for m in self.materials
            ),
            textures_enabled=tex_on,
            has_normal_maps=tex_on
            and any(m.normal_texture >= 0 for m in self.materials),
            has_scene_bvh=has_scene_bvh,
            mat_types_used=tuple(
                sorted({int(m.material_type) for m in self.materials})
            ) or (0,),
        )
        # Instance ids ride through f32 channels in the temporal filter
        # (render/svgf.py mesh_ok); keep them far below 2^24.
        assert len(self.instances) < 65536, (
            f"{len(self.instances)} instances; ids must fit u16/f32 exactly"
        )

        f32 = lambda x: jnp.asarray(x, dtype)
        i32 = lambda x: jnp.asarray(x, jnp.int32)
        return SceneArrays(
            meta=meta,
            tri_pos=f32(tri_pos),
            tri_nrm=f32(tri_nrm),
            tri_uv=f32(tri_uv),
            tri_tan=f32(tri_tan),
            bvh_node_min=f32(flat.node_min),
            bvh_node_max=f32(flat.node_max),
            bvh_skip=i32(flat.skip),
            bvh_tri_first=i32(flat.tri_first),
            bvh_tri_count=i32(flat.tri_count),
            bvh_tri_order=i32(flat.tri_order),
            bvh_bounds6=f32(
                np.concatenate([flat.node_min.T, flat.node_max.T], axis=0)
            ),
            bvh_leaf_tri=i32(
                np.where(
                    flat.tri_count > 0,
                    flat.tri_order[np.clip(flat.tri_first, 0, max(len(flat.tri_order) - 1, 0))],
                    -1,
                )
            ),
            tri_verts9=f32(tri_pos.reshape(tri_pos.shape[0], 9).T),
            world_tris9=f32(world9),
            world_tri_inst=i32(w_inst),
            world_tri_mat=i32(w_mat),
            world_tri_prim=i32(w_prim),
            wbvh_bounds6=f32(wbvh_bounds6),
            wbvh_skip=i32(wbvh_skip),
            wbvh_leaf_tri=i32(wbvh_leaf),
            inst_aabb_min=f32(i_lo),
            inst_aabb_max=f32(i_hi),
            shape_node_start=i32(flat.shape_node_start),
            shape_node_count=i32(flat.shape_node_count),
            shape_tri_start=i32(flat.shape_tri_start),
            shape_tri_count=i32([s.n_triangles for s in shapes]),
            inst_transform=f32(inst_t),
            inst_inv_transform=f32(inst_inv),
            inst_normal_transform=f32(inst_nrm),
            inst_shape=i32([i.shape for i in self.instances]),
            inst_material=i32([i.material for i in self.instances]),
            mat_emission=f32([m.emission for m in mats]),
            mat_colour=f32([m.colour for m in mats]),
            mat_roughness=f32([m.roughness for m in mats]),
            mat_metallic=f32([m.metallic for m in mats]),
            mat_anisotropy=f32([m.anisotropy for m in mats]),
            mat_opacity=f32([m.opacity for m in mats]),
            mat_scattering=f32([m.scattering_colour for m in mats]),
            mat_transmission_depth=f32([m.transmission_depth for m in mats]),
            mat_type=i32([int(m.material_type) for m in mats]),
            mat_emission_tex=i32([m.emission_texture for m in mats]),
            mat_colour_tex=i32([m.colour_texture for m in mats]),
            mat_roughness_tex=i32([m.roughness_texture for m in mats]),
            mat_normal_tex=i32([m.normal_texture for m in mats]),
            textures=jnp.asarray(tex_stack),
            light_instance=i32(lights.instance),
            light_env=i32(lights.environment),
            light_cdf_start=i32(lights.cdf_start),
            light_cdf_count=i32(lights.cdf_count),
            lights_cdf=f32(lights.cdf),
            light_area=f32(lights.total),
            env_transform=f32(env_t),
            env_inv_transform=f32(env_inv),
            env_emission=f32(
                [e.emission for e in self.environments] if self.environments else np.zeros((0, 3))
            ),
            env_tex=i32(
                [e.emission_texture for e in self.environments] if self.environments else []
            ),
            env_textures=f32(et),
            cam_frame=f32(cam_frame),
            cam_prev_frame=f32(cam_prev),
            cam_proj=f32(cam_proj),
        )

    def with_camera(self, index: int, camera: Camera) -> "Scene":
        cams = list(self.cameras)
        cams[index] = camera
        return dataclasses.replace(self, cameras=cams)
