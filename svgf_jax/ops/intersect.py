"""Scene intersection — stackless threaded-BVH traversal, vectorized over rays.

The reference traverses a two-level BVH with a per-thread 64-deep stack
(PathTrace.cuh:90-142, Common.cuh:550-620). Here traversal is written in
plain JAX over the whole ray batch:

  * each shape's BVH is laid out in DFS order with skip links (accel.bvh);
    traversal state per ray is ONE int (current node) + the running hit —
    a `lax.while_loop` of gathers + elementwise math over the whole ray
    batch, which runs until the slowest ray finishes;
  * the instance level is a static Python loop over instances (object-space
    ray transform per instance, reference IntersectInstance Common.cuh:623-631);
    scenes here have few instances, and every ray traverses the same shape in
    lockstep, so there is no instance divergence at all.

Object-space ray directions are deliberately NOT normalized, so the hit
parameter t stays in world units and compares correctly across instances
(matches reference Common.cuh:627).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svgf_jax.ops.geometry import (
    MAX_LENGTH,
    ray_aabb_comp,
    ray_triangle,
    ray_triangle_comp,
    transform_point,
    transform_point3,
    transform_vector,
    transform_vector3,
)


class Hit(NamedTuple):
    """Per-ray intersection record (reference sceneIntersection, Common.cuh:146-162)."""

    dist: jax.Array      # (R,) f32, MAX_LENGTH = miss
    u: jax.Array         # (R,) f32 barycentric
    v: jax.Array         # (R,) f32
    prim: jax.Array      # (R,) i32 global triangle id
    instance: jax.Array  # (R,) i32
    material: jax.Array  # (R,) i32

    @staticmethod
    def none(shape) -> "Hit":
        z = jnp.zeros(shape, jnp.int32)
        return Hit(
            dist=jnp.full(shape, MAX_LENGTH, jnp.float32),
            u=jnp.zeros(shape, jnp.float32),
            v=jnp.zeros(shape, jnp.float32),
            prim=z,
            instance=z,
            material=z,
        )

    @property
    def valid(self):
        return self.dist < MAX_LENGTH


def traverse_shape(scene, shape_id, ro, rd, hit: Hit, instance_id, material_id,
                   active, any_hit: bool = False) -> Hit:
    """Threaded-BVH traversal of one shape for a batch of object-space rays.

    ro / rd are component tuples of (R,) arrays; single-triangle leaves
    (accel.bvh.MAX_LEAF == 1) keep the leaf test on (R,) arrays as well.

    shape_id / instance_id / material_id: scalar traced ints. `active` masks
    rays that participate; inactive rays keep their current hit untouched.
    """
    node_start = scene.shape_node_start[shape_id]
    node_count = scene.shape_node_count[shape_id]

    inv_rd = tuple(1.0 / d for d in rd)
    R = ro[0].shape[0]
    node0 = jnp.where(active, jnp.zeros(R, jnp.int32), node_count)

    def cond(state):
        node, _ = state
        return jnp.any(node < node_count)

    def body(state):
        node, h = state
        live = node < node_count
        g = node_start + jnp.minimum(node, node_count - 1)  # clamped global node id
        b = scene.bvh_bounds6[:, g]                         # (6, R)
        lo = (b[0], b[1], b[2])
        hi = (b[3], b[4], b[5])
        t_box = ray_aabb_comp(ro, inv_rd, lo, hi, h.dist)
        box_hit = live & (t_box < MAX_LENGTH)

        leaf_tri = scene.bvh_leaf_tri[g]                    # (R,)
        is_leaf = leaf_tri >= 0
        tri = jnp.maximum(leaf_tri, 0)
        v = scene.tri_verts9[:, tri]                        # (9, R)
        t, u, vv, m = ray_triangle_comp(
            ro, rd, (v[0], v[1], v[2]), (v[3], v[4], v[5]), (v[6], v[7], v[8])
        )
        closer = box_hit & is_leaf & m & (t < h.dist)
        h = Hit(
            dist=jnp.where(closer, t, h.dist),
            u=jnp.where(closer, u, h.u),
            v=jnp.where(closer, vv, h.v),
            prim=jnp.where(closer, tri, h.prim),
            instance=jnp.where(closer, instance_id, h.instance),
            material=jnp.where(closer, material_id, h.material),
        )

        # --- next node: descend on internal hit, else follow skip link ---
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, scene.bvh_skip[g])
        if any_hit:
            nxt = jnp.where(closer, node_count, nxt)  # first hit ends the lane
        nxt = jnp.where(live, nxt, node)
        return nxt, h

    _, hit = jax.lax.while_loop(cond, body, (node0, hit))
    return hit


# Scenes whose world-triangle soup is at most this big use the dense
# intersector (a broadcast + reduce over every triangle); larger ones walk the
# scene BVH. The crossover has not been measured on the GPU yet (PERF.md).
DENSE_MAX_TRIS = 16384


def traverse_scene_bvh(scene, ro, rd, hit: Hit, active, any_hit: bool = False) -> Hit:
    """Stitched two-level scene-BVH traversal (reference IntersectTLAS,
    PathTrace.cuh:90-142, as ONE flat skip-linked world-space walk —
    accel.bvh.build_scene_bvh).

    ro / rd are component tuples of (R,) WORLD-space arrays — no per-node
    instance transforms: the TLAS levels and the spliced BLAS levels both
    store world AABBs, and leaves index the pre-transformed triangle soup.
    Per-ray state stays a single int; every step is gathers + elementwise
    math over the whole batch (see module docstring).
    """
    return scene_bvh_walk(scene, ro, rd, hit, active, any_hit)[0]


def scene_bvh_walk(scene, ro, rd, hit: Hit, active, any_hit: bool = False):
    """traverse_scene_bvh plus its while-loop trip count: (hit, steps).

    The loop runs until the slowest ray finishes, so `steps` is the number
    of whole-batch iterations the walk costs."""
    node_count = scene.wbvh_skip.shape[0]
    inv_rd = tuple(1.0 / d for d in rd)
    R = ro[0].shape[0]
    node0 = jnp.where(active, jnp.zeros(R, jnp.int32), node_count)

    def cond(state):
        node, _, _ = state
        return jnp.any(node < node_count)

    def body(state):
        node, h, steps = state
        live = node < node_count
        g = jnp.minimum(node, node_count - 1)
        b = scene.wbvh_bounds6[:, g]                        # (6, R)
        t_box = ray_aabb_comp(ro, inv_rd, (b[0], b[1], b[2]), (b[3], b[4], b[5]),
                              h.dist)
        box_hit = live & (t_box < MAX_LENGTH)

        leaf_tri = scene.wbvh_leaf_tri[g]                   # (R,) soup column
        is_leaf = leaf_tri >= 0
        tri = jnp.maximum(leaf_tri, 0)
        v = scene.world_tris9[:, tri]                       # (9, R)
        t, u, vv, m = ray_triangle_comp(
            ro, rd, (v[0], v[1], v[2]), (v[3], v[4], v[5]), (v[6], v[7], v[8])
        )
        closer = box_hit & is_leaf & m & (t < h.dist)
        h = Hit(
            dist=jnp.where(closer, t, h.dist),
            u=jnp.where(closer, u, h.u),
            v=jnp.where(closer, vv, h.v),
            prim=jnp.where(closer, scene.world_tri_prim[tri], h.prim),
            instance=jnp.where(closer, scene.world_tri_inst[tri], h.instance),
            material=jnp.where(closer, scene.world_tri_mat[tri], h.material),
        )
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, scene.wbvh_skip[g])
        if any_hit:
            nxt = jnp.where(closer, node_count, nxt)
        nxt = jnp.where(live, nxt, node)
        return nxt, h, steps + 1

    _, hit, steps = jax.lax.while_loop(cond, body, (node0, hit, jnp.int32(0)))
    return hit, steps


def intersect_dense(scene, ro, rd, active=None, any_hit: bool = False,
                    tmax=None, only_instance=None) -> Hit:
    """Dense intersection against the pre-transformed world triangle soup.

    Every op is a (R, 128) broadcast over ray components x triangle chunks —
    no gathers inside the loop; XLA fuses each chunk into one pass.
    """
    R = ro.shape[0]
    tw = scene.world_tris9.shape[1]
    if only_instance is not None:
        start, count = scene.meta.inst_world_range[only_instance]
        c0 = (start // 128) * 128
        c1 = -(-(start + count) // 128) * 128
    else:
        c0, c1 = 0, tw
    n_chunks = (c1 - c0) // 128

    roc = tuple(ro[:, k][:, None] for k in range(3))   # (R, 1) each
    rdc = tuple(rd[:, k][:, None] for k in range(3))

    t0 = jnp.full((R,), MAX_LENGTH, jnp.float32)
    if tmax is not None:
        t0 = jnp.broadcast_to(tmax, (R,)).astype(jnp.float32)
    carry0 = (t0, jnp.zeros((R,), jnp.float32), jnp.zeros((R,), jnp.float32),
              jnp.zeros((R,), jnp.int32))

    def chunk_step(c, carry):
        tb, ub, vb, ib = carry
        off = c0 + c * 128
        v = jax.lax.dynamic_slice(scene.world_tris9, (0, off), (9, 128))
        ids = jax.lax.dynamic_slice(scene.world_tri_inst, (off,), (128,))
        valid_tri = ids >= 0
        if only_instance is not None:
            valid_tri = ids == only_instance
        row = lambda k: v[k][None, :]                   # (1, 128)
        t, u, vv, m = ray_triangle_comp(
            roc, rdc,
            (row(0), row(1), row(2)), (row(3), row(4), row(5)), (row(6), row(7), row(8)),
        )                                                # (R, 128)
        t = jnp.where(m & valid_tri[None, :], t, MAX_LENGTH)
        j = jnp.argmin(t, axis=-1)
        sel = lambda a: jnp.take_along_axis(a, j[:, None], axis=-1)[:, 0]
        tc = sel(t)
        closer = tc < tb
        return (
            jnp.where(closer, tc, tb),
            jnp.where(closer, sel(u), ub),
            jnp.where(closer, sel(vv), vb),
            jnp.where(closer, off + j.astype(jnp.int32), ib),
        )

    tb, ub, vb, ib = jax.lax.fori_loop(0, n_chunks, chunk_step, carry0)
    ok = tb < (t0 if tmax is not None else MAX_LENGTH)
    ib = jnp.clip(ib, 0, tw - 1)
    hit = Hit(
        dist=tb,
        u=ub,
        v=vb,
        prim=scene.world_tri_prim[ib],
        instance=jnp.where(ok, scene.world_tri_inst[ib], 0),
        material=scene.world_tri_mat[ib],
    )
    if active is not None:
        hit = Hit(
            dist=jnp.where(active, hit.dist, t0),
            u=hit.u, v=hit.v, prim=hit.prim,
            instance=hit.instance, material=hit.material,
        )
    return hit


def intersect_scene(scene, ro, rd, active=None, any_hit: bool = False,
                    tmax=None, only_instance=None) -> Hit:
    """Closest-hit (or any-hit) intersection of world-space rays with the scene.

    ro, rd: (R, 3). `only_instance`: restrict to one instance id (static int) —
    used by SampleLightsPDF, which re-traces against each light instance
    (reference Common.cuh:635-715 via IntersectInstance).

    Dispatches to the dense soup intersector for small scenes (static
    decision baked into the trace) and to the threaded-BVH traversal
    otherwise.
    """
    if 0 < scene.meta.n_world_tris <= DENSE_MAX_TRIS:
        return intersect_dense(scene, ro, rd, active=active, any_hit=any_hit,
                               tmax=tmax, only_instance=only_instance)
    R = ro.shape[0]
    hit = Hit.none((R,))
    if tmax is not None:
        hit = hit._replace(dist=jnp.broadcast_to(tmax, (R,)).astype(jnp.float32))
    if active is None:
        active = jnp.ones((R,), jnp.bool_)

    # decompose to component tuples once
    roc = (ro[:, 0], ro[:, 1], ro[:, 2])
    rdc = (rd[:, 0], rd[:, 1], rd[:, 2])

    if scene.meta.has_scene_bvh and only_instance is None:
        # stitched TLAS+BLAS world walk: one traversal per ray regardless of
        # instance count (the many-instance fast path)
        return traverse_scene_bvh(scene, roc, rdc, hit, active, any_hit=any_hit)

    inv_rdc = tuple(1.0 / d for d in rdc)

    def step(h, i):
        # instance culling against the TLAS leaf AABB (the role of the
        # reference's TLAS interior tests, PathTrace.cuh:103-141): rays
        # missing this instance's world box skip its BLAS walk entirely
        lo = scene.inst_aabb_min[i]
        hi = scene.inst_aabb_max[i]
        t_box = ray_aabb_comp(
            roc, inv_rdc, (lo[0], lo[1], lo[2]), (hi[0], hi[1], hi[2]), h.dist
        )
        act_i = active & (t_box < MAX_LENGTH)
        inv = scene.inst_inv_transform[i]
        ro_o = transform_point3(inv, roc)
        rd_o = transform_vector3(inv, rdc)  # NOT normalized (world-unit t)
        h = traverse_shape(
            scene, scene.inst_shape[i], ro_o, rd_o, h,
            i, scene.inst_material[i], act_i, any_hit=any_hit,
        )
        return h, None

    if only_instance is not None:
        hit, _ = step(hit, jnp.int32(only_instance))
        return hit
    # scan (not a Python loop) so the traversal while_loop compiles ONCE
    n_inst = scene.inst_shape.shape[0]
    hit, _ = jax.lax.scan(step, hit, jnp.arange(n_inst, dtype=jnp.int32))
    return hit


def intersect_brute_force(scene, ro, rd) -> Hit:
    """Reference-check intersector: test every triangle of every instance.

    Validates the BVH traversal in tests; O(rays * tris) per instance.
    """
    R = ro.shape[0]
    hit = Hit.none((R,))
    T = scene.tri_pos.shape[0]
    tri_ids = jnp.arange(T, dtype=jnp.int32)
    n_inst = scene.inst_shape.shape[0]

    def step(hit, i):
        inv = scene.inst_inv_transform[i]
        ro_o = transform_point(inv, ro)
        rd_o = transform_vector(inv, rd)
        s = scene.inst_shape[i]
        t_start = scene.shape_tri_start[s]
        t_count = scene.shape_tri_count[s]
        own = (tri_ids >= t_start) & (tri_ids < t_start + t_count)      # (T,)
        v = scene.tri_pos                                               # (T,3,3)
        t, u, vv, m = ray_triangle(
            ro_o[:, None, :], rd_o[:, None, :],
            v[None, :, 0, :], v[None, :, 1, :], v[None, :, 2, :],
        )
        t = jnp.where(own[None, :] & m, t, MAX_LENGTH)                  # (R,T)
        jbest = jnp.argmin(t, axis=-1)
        tbest = jnp.take_along_axis(t, jbest[:, None], axis=-1)[:, 0]
        closer = tbest < hit.dist
        sel = lambda a: jnp.take_along_axis(a, jbest[:, None], axis=-1)[:, 0]
        hit = Hit(
            dist=jnp.where(closer, tbest, hit.dist),
            u=jnp.where(closer, sel(u), hit.u),
            v=jnp.where(closer, sel(vv), hit.v),
            prim=jnp.where(closer, jbest.astype(jnp.int32), hit.prim),
            instance=jnp.where(closer, i, hit.instance),
            material=jnp.where(closer, scene.inst_material[i], hit.material),
        )
        return hit, None

    hit, _ = jax.lax.scan(step, hit, jnp.arange(n_inst, dtype=jnp.int32))
    return hit
