"""Halo exchange for row-sharded image stencils.

The a-trous footprint grows as 2*step per iteration (Filter.cuh:576), so a
row band sharded per chip needs its neighbors' border rows before each
stencil — the image-space analogue of context-parallel ring passing
(SURVEY.md §5). Implemented with `jax.lax.ppermute` over the mesh axis.

Boundary policies (must reproduce the unsharded filters bit-for-bit):
  * "zero": missing neighbors contribute zero rows. The weighted filters
    (moments, a-trous) exclude out-of-image taps via inside-masks; a zero
    NORMAL makes the edge-stopping weight saturate to 0 (0^phi_normal), so
    zero-filled halos reproduce the exclusion exactly.
  * "edge": missing neighbors contribute the shard's own edge row — the
    imageLoad coordinate clamp (Filter.cuh:73-74) used by TAA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exchange_row_halo(x, halo: int, axis_name: str, boundary: str = "zero"):
    """Return (top_halo, bottom_halo): `halo` rows from the shards above and
    below this one along `axis_name`. x: (Hs, ...) local band."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if n == 1:
        top = jnp.zeros_like(x[:halo])
        bot = jnp.zeros_like(x[:halo])
        if boundary == "edge":
            top = jnp.repeat(x[:1], halo, axis=0)
            bot = jnp.repeat(x[-1:], halo, axis=0)
        return top, bot

    # shard i sends its BOTTOM rows to i+1 (becomes i+1's top halo)
    down = [(i, i + 1) for i in range(n - 1)]
    top = jax.lax.ppermute(x[-halo:], axis_name, down)  # zeros for shard 0
    # shard i sends its TOP rows to i-1 (becomes i-1's bottom halo)
    up = [(i, i - 1) for i in range(1, n)]
    bot = jax.lax.ppermute(x[:halo], axis_name, up)     # zeros for shard n-1

    if boundary == "edge":
        top = jnp.where(idx == 0, jnp.repeat(x[:1], halo, axis=0), top)
        bot = jnp.where(idx == n - 1, jnp.repeat(x[-1:], halo, axis=0), bot)
    return top, bot


def with_row_halo(x, halo: int, axis_name: str, boundary: str = "zero"):
    """Band extended with exchanged halos: (Hs + 2*halo, ...)."""
    top, bot = exchange_row_halo(x, halo, axis_name, boundary)
    return jnp.concatenate([top, x, bot], axis=0)


def crop_halo(x, halo: int):
    return x[halo:-halo] if halo > 0 else x


def exchange_col_halo(x, halo: int, axis_name: str, boundary: str = "zero"):
    """Column-axis twin of exchange_row_halo: (left_halo, right_halo), each
    `halo` columns wide. x: (Hs, Ws, ...) local tile."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if n == 1:
        left = jnp.zeros_like(x[:, :halo])
        right = jnp.zeros_like(x[:, :halo])
        if boundary == "edge":
            left = jnp.repeat(x[:, :1], halo, axis=1)
            right = jnp.repeat(x[:, -1:], halo, axis=1)
        return left, right

    right_send = [(i, i + 1) for i in range(n - 1)]
    left = jax.lax.ppermute(x[:, -halo:], axis_name, right_send)
    left_send = [(i, i - 1) for i in range(1, n)]
    right = jax.lax.ppermute(x[:, :halo], axis_name, left_send)

    if boundary == "edge":
        left = jnp.where(idx == 0, jnp.repeat(x[:, :1], halo, axis=1), left)
        right = jnp.where(
            idx == n - 1, jnp.repeat(x[:, -1:], halo, axis=1), right
        )
    return left, right


def with_col_halo(x, halo: int, axis_name: str, boundary: str = "zero"):
    """Tile extended with exchanged column halos: (Hs, Ws + 2*halo, ...)."""
    left, right = exchange_col_halo(x, halo, axis_name, boundary)
    return jnp.concatenate([left, x, right], axis=1)


def with_tile_halo(x, halo: int, axis_y: str, axis_x: str, boundary: str = "zero"):
    """2-D halo: rows first, then columns ON THE ROW-EXTENDED tile — the
    second exchange forwards the first's halo rows, so corner blocks arrive
    without explicit diagonal sends (the standard two-pass trick)."""
    return with_col_halo(with_row_halo(x, halo, axis_y, boundary), halo,
                         axis_x, boundary)


def crop_tile_halo(x, halo: int):
    return x[halo:-halo, halo:-halo] if halo > 0 else x
