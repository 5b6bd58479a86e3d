"""Geometry primitives (jnp, batched over rays).

Semantics mirror the reference device library:
  - Moller-Trumbore triangle test: Common.cuh:509-536
  - slab AABB test: Common.cuh:538-548
  - transforms / basis: Common.cuh:299-329
All functions operate on batched arrays: rays are (..., 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Geometry contractions run at full f32: under default precision a GPU may
# use TF32 (~3 significant digits), which moves hit points and motion vectors.
HIGHEST = jax.lax.Precision.HIGHEST

MAX_LENGTH = 1e30
PI = 3.14159  # the reference uses PI_F = 3.14159 (Common.cuh:22)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt(max(x, 0)) with a clamped derivative.

    Plain `sqrt(max(x, 0))` has derivative inf at x == 0 — and max()'s
    backward passes that inf through for every CLAMPED lane (x < 0, e.g.
    total internal reflection in fresnel_dielectric), so a downstream
    `where` mask turns it into 0*inf = NaN. Forward is exact; the
    derivative is 0.5/sqrt(max(x, 1e-12)), and 0 for clamped lanes.
    """
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = safe_sqrt(x)
    d = jnp.where(x > 0.0, 0.5 / jnp.sqrt(jnp.maximum(x, 1e-12)), 0.0)
    return y, d * dx


@jax.custom_jvp
def _unit(v):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, 1e-30)


@_unit.defjvp
def _unit_jvp(primals, tangents):
    """Jacobian of v/|v| with degenerate lanes (|v| ~ 0) given ZERO tangent
    instead of the ~1/|v| blowup — a zero input direction is always a
    masked/broken lane and its huge cotangent otherwise overflows to inf
    upstream (then 0*inf = NaN at the mask)."""
    (v,), (dv,) = primals, tangents
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    y = v / jnp.maximum(n, 1e-30)
    ok = n > 1e-9
    ns = jnp.where(ok, n, 1.0)
    dy = jnp.where(ok, (dv - y * jnp.sum(y * dv, axis=-1, keepdims=True)) / ns, 0.0)
    return y, dy


def normalize(v, eps=0.0):
    if eps != 0.0:
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return v / jnp.maximum(n, eps)
    return _unit(v)


def transform_point(m, p):
    """(...,4,4) @ (...,3) -> (...,3), w=1, no perspective divide (Common.cuh:299)."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=HIGHEST) + m[..., :3, 3]


def transform_direction(m, d):
    """w=0 transform + normalize (Common.cuh:305-309)."""
    return normalize(jnp.einsum("...ij,...j->...i", m[..., :3, :3], d, precision=HIGHEST))


def transform_vector(m, d):
    """w=0 transform, NO normalize (used for object-space ray dirs, Common.cuh:627)."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], d, precision=HIGHEST)


def basis_from_z(z):
    """Pixar orthonormal basis (Common.cuh:317-329). Returns (x, y, z) unit vecs."""
    z = normalize(z)
    sign = jnp.where(z[..., 2] > 0, 1.0, -1.0)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = jnp.stack(
        [1.0 + sign * z[..., 0] ** 2 * a, sign * b, -sign * z[..., 0]], axis=-1
    )
    y = jnp.stack([b, sign + z[..., 1] ** 2 * a, -z[..., 1]], axis=-1)
    return x, y, z


def reflect(d, n):
    """GLSL reflect: d - 2*dot(n,d)*n."""
    return d - 2.0 * dot(n, d)[..., None] * n


def refract(d, n, eta):
    """GLSL refract(I, N, eta); returns 0 on total internal reflection.

    eta may be a scalar or a per-lane (...,) array.
    """
    eta = jnp.asarray(eta)
    cosi = dot(n, d)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta[..., None] * d - (eta * cosi + safe_sqrt(k))[..., None] * n
    return jnp.where((k < 0.0)[..., None], 0.0, refr)


def ray_triangle(ro, rd, v0, v1, v2):
    """Moller-Trumbore (Common.cuh:509-536).

    Returns (t, u, v, hit_mask); t = MAX_LENGTH when missed.
    Shapes: ro/rd (...,3), v0/v1/v2 (...,3) broadcastable.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    h = jnp.cross(rd, e2)
    a = dot(e1, h)
    parallel = jnp.abs(a) < 1e-8
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = ro - v0
    u = f * dot(s, h)
    q = jnp.cross(s, e1)
    v = f * dot(rd, q)
    t = f * dot(e2, q)
    hit = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    return jnp.where(hit, t, MAX_LENGTH), u, v, hit


def ray_aabb(ro, inv_rd, lo, hi, tmax):
    """Slab test (Common.cuh:538-548). Returns entry t or MAX_LENGTH."""
    t1 = (lo - ro) * inv_rd
    t2 = (hi - ro) * inv_rd
    tmin_v = jnp.minimum(t1, t2)
    tmax_v = jnp.maximum(t1, t2)
    tn = jnp.max(tmin_v, axis=-1)
    tf = jnp.min(tmax_v, axis=-1)
    hit = (tf >= tn) & (tn < tmax) & (tf > 0)
    return jnp.where(hit, tn, MAX_LENGTH)


# ---------------------------------------------------------------------------
# Componentwise (SoA) variants — used inside traversal loops, which keep
# every loop tensor (R,). Every operand is a tuple of three (R,) arrays.
# ---------------------------------------------------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def transform_point3(m, p):
    """m: (4,4); p: component tuple -> component tuple (w=1, no divide)."""
    return tuple(
        m[i, 0] * p[0] + m[i, 1] * p[1] + m[i, 2] * p[2] + m[i, 3] for i in range(3)
    )


def transform_vector3(m, d):
    """w=0 transform, no normalize (object-space ray dirs)."""
    return tuple(m[i, 0] * d[0] + m[i, 1] * d[1] + m[i, 2] * d[2] for i in range(3))


def ray_triangle_comp_raw(ro, rd, v0, v1, v2):
    """Moller-Trumbore on component tuples, UNMASKED: returns raw (t, u, v)
    even outside the triangle / behind the origin. Used to re-derive
    differentiable hit params for a triangle already selected by a kernel
    (the selection may disagree on borderline lanes by an ulp; the raw value
    keeps the kernel's verdict authoritative)."""
    e1 = sub3(v1, v0)
    e2 = sub3(v2, v0)
    h = cross3(rd, e2)
    a = dot3(e1, h)
    parallel = jnp.abs(a) < 1e-8
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = sub3(ro, v0)
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(rd, q)
    t = f * dot3(e2, q)
    return t, u, v


def ray_triangle_comp(ro, rd, v0, v1, v2):
    """Moller-Trumbore on component tuples. Returns (t, u, v, hit)."""
    e1 = sub3(v1, v0)
    e2 = sub3(v2, v0)
    h = cross3(rd, e2)
    a = dot3(e1, h)
    parallel = jnp.abs(a) < 1e-8
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = sub3(ro, v0)
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(rd, q)
    t = f * dot3(e2, q)
    hit = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    return jnp.where(hit, t, MAX_LENGTH), u, v, hit


def ray_aabb_comp(ro, inv_rd, lo, hi, tmax):
    """Slab test on component tuples. Returns entry t or MAX_LENGTH."""
    tn = jnp.full_like(ro[0], -MAX_LENGTH)
    tf = jnp.full_like(ro[0], MAX_LENGTH)
    for k in range(3):
        t1 = (lo[k] - ro[k]) * inv_rd[k]
        t2 = (hi[k] - ro[k]) * inv_rd[k]
        tn = jnp.maximum(tn, jnp.minimum(t1, t2))
        tf = jnp.minimum(tf, jnp.maximum(t1, t2))
    hit = (tf >= tn) & (tn < tmax) & (tf > 0)
    return jnp.where(hit, tn, MAX_LENGTH)


def luminance(rgb):
    """Rec.709 (Filter.cuh:260-263)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def to_srgb(c):
    """sRGB transfer (Filter.cuh:145-148).

    The power-branch base is clamped away from 0 so the untaken branch's
    backward pass stays finite (0*inf=NaN would otherwise poison grads).
    """
    c = jnp.maximum(c, 0.0)
    safe = jnp.maximum(c, 0.0031308)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(safe, 1.0 / 2.4) - 0.055)


def from_srgb(c):
    """Common.cuh ToLinear (inverse sRGB)."""
    safe = jnp.maximum(c, 1e-4)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((safe + 0.055) / 1.055, 2.4))


def is_finite3(v):
    return jnp.all(jnp.isfinite(v), axis=-1)
