"""Sampling utilities: deterministic RNG fields, discrete CDF sampling,
MIS heuristics (reference Common.cuh:256-295, 348-459, 1571-1574).

The reference seeds a PCG stream from wall-clock time per pixel
(PathTrace.cuh:589-592) — non-deterministic across runs. Here every random
draw is a *counter-based hash field*: value = hash(seed, use-site, lane id),
where the lane id is the GLOBAL pixel index. This is the same design as the
reference's per-pixel PCG (Common.cuh:257-295) but with a fixed seed, so
renders are bit-reproducible AND every draw is independent of how the frame
is chunked (pathtrace_chunked) or sharded across chips (parallel.sharded) —
a band renders exactly the pixels the full frame would.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svgf_jax.ops.geometry import PI, basis_from_z, dot, normalize

_GOLDEN = jnp.uint32(0x9E3779B9)


def _lowbias32(x):
    """Wellons' lowbias32 integer hash (public domain) — the PCG-quality
    per-lane mixer; uint32 ops wrap mod 2^32 by definition."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def key_to_seed32(key: jax.Array) -> jax.Array:
    """Collapse a jax PRNG key to a uint32 stream seed."""
    data = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    return _lowbias32(data[0] ^ _lowbias32(data[-1]))


class RngStream:
    """Hands out independent uniform fields: one per call site, hashed per
    global lane id. Call order is static under jit (python-side counter), so
    every use site gets a stable, distinct stream — the analogue of the
    reference's per-site RNG advances, without the time dependence and
    without any dependence on batch/chunk/shard boundaries.
    """

    def __init__(self, key: jax.Array, lane_ids: jax.Array | None = None):
        self.seed = key_to_seed32(key) if jnp.issubdtype(
            key.dtype, jax.dtypes.prng_key
        ) else jnp.asarray(key, jnp.uint32)
        self.lane = None if lane_ids is None else lane_ids.astype(jnp.uint32)
        self._n = 0

    def uniform(self, shape) -> jax.Array:
        self._n += 1
        site = _lowbias32(jnp.uint32(self._n) * _GOLDEN ^ self.seed)
        if self.lane is None:
            lane = jnp.arange(shape[0], dtype=jnp.uint32)
        else:
            lane = self.lane
            assert lane.shape == tuple(shape), (lane.shape, shape)
        h = _lowbias32(lane * _GOLDEN + jnp.uint32(1) ^ site)
        # top 24 bits -> mantissa-exact [0, 1)
        return (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))

    def uniform2(self, shape) -> jax.Array:
        return jnp.stack([self.uniform(shape), self.uniform(shape)], axis=-1)


def hash_uniform(key: jax.Array, lane_ids: jax.Array, site: int = 1) -> jax.Array:
    """One-off counter-based uniform field at explicit lane ids."""
    s = RngStream(key, lane_ids)
    s._n = site - 1
    return s.uniform(lane_ids.shape)


def power_heuristic(pdf0, pdf1):
    """(Common.cuh:1571-1574), in the overflow-stable ratio form.

    pdf0^2/(pdf0^2+pdf1^2) overflows fp32 for pdf ~ 1e20 (grazing light
    samples), yielding inf/inf = NaN that the reference scrubs to black
    (PathTrace.cuh:348) and that poisons gradients. 1/(1+(pdf1/pdf0)^2) has
    the correct limits everywhere: ratio overflow -> heuristic 0.
    """
    # Double-where: pdf0 <= 0 lanes divide by 1, not a tiny floor. A floor
    # f < ~1.1e-19 is fatal in backward: f^2 underflows to 0 in fp32 (XLA may
    # flush subnormals) and the division's backward computes x/f^2 = x/0 = NaN.
    ok = pdf0 > 0.0
    r = jnp.where(ok, pdf1, 0.0) / jnp.where(ok, jnp.maximum(pdf0, 1e-18), 1.0)
    # clamp: r^2 = inf would make d(ph)/dr = -2r/(1+r^2)^2 = inf/inf = NaN;
    # ph(1e9) ~ 1e-18 so the forward value is unchanged for all purposes.
    r = jnp.minimum(r, 1e9)
    ph = 1.0 / (1.0 + r * r)
    return jnp.where(ok, ph, 0.0)


def sample_uniform_index(size: int, rand):
    """clamp(int(rand*size), 0, size-1) (Common.cuh:235-239)."""
    return jnp.clip((rand * size).astype(jnp.int32), 0, size - 1)


def sample_triangle_uv(ruv):
    """Uniform triangle barycentrics (Common.cuh:229-234)."""
    s = jnp.sqrt(ruv[..., 0])
    return jnp.stack([1.0 - s, ruv[..., 1] * s], axis=-1)


def sample_sphere(ruv):
    """(Common.cuh:399-405)."""
    z = 2.0 * ruv[..., 1] - 1.0
    r = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    phi = 2.0 * PI * ruv[..., 0]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def sample_hemisphere_cosine(normal, ruv):
    """(Common.cuh:721-729)."""
    z = jnp.sqrt(ruv[..., 1])
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * ruv[..., 0]
    local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    bx, by, bz = basis_from_z(normal)
    return normalize(
        local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz
    )


def sample_hemisphere_cosine_pdf(normal, direction):
    """(Common.cuh:731-738)."""
    cosw = dot(normal, direction)
    return jnp.where(cosw <= 0, 0.0, cosw / PI)


def upper_bound_segment(cdf: jax.Array, start, count, x):
    """Vectorized std::upper_bound over a CDF segment (Common.cuh:348-371).

    Finds the first index in [start, start+count) with cdf[idx] > x, via a
    fixed-iteration lockstep binary search (each lane may have a different
    segment). Returns indices relative to the whole `cdf` array.
    """
    n = cdf.shape[0]
    lo = jnp.broadcast_to(start, x.shape).astype(jnp.int32)
    hi = (lo + count).astype(jnp.int32)
    import math

    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        live = lo < hi
        mid = (lo + hi) // 2
        v = cdf[jnp.clip(mid, 0, n - 1)]
        right = live & (x >= v)
        lo = jnp.where(right, mid + 1, lo)
        hi = jnp.where(live & ~right, mid, hi)
    # reference post-adjust (:365-367)
    v_lo = cdf[jnp.clip(lo, 0, n - 1)]
    lo = jnp.where((lo < start + count) & (v_lo <= x), lo + 1, lo)
    return lo


def sample_discrete(cdf: jax.Array, start, count, rand):
    """SampleDiscrete (Common.cuh:374-387): returns index in [0, count)."""
    n = cdf.shape[0]
    last = cdf[jnp.clip(start + count - 1, 0, n - 1)]
    r = jnp.clip(rand * last, 0.0, last - 1e-5)
    idx = upper_bound_segment(cdf, start, count, r) - start
    return jnp.clip(idx, 0, count - 1)


def sample_discrete_pdf(cdf: jax.Array, start, count, idx):
    """(Common.cuh:407-411): probability mass of element idx."""
    n = cdf.shape[0]
    hi = cdf[jnp.clip(start + idx, 0, n - 1)]
    lo = jnp.where(idx == 0, 0.0, cdf[jnp.clip(start + idx - 1, 0, n - 1)])
    last = cdf[jnp.clip(start + count - 1, 0, n - 1)]
    return (hi - lo) / last
