from svgf_jax.parallel.distributed import init_distributed
from svgf_jax.parallel.halo import (
    exchange_col_halo,
    exchange_row_halo,
    with_col_halo,
    with_row_halo,
    with_tile_halo,
)
from svgf_jax.parallel.sharded import (
    make_row_mesh,
    render_frame_sharded,
    make_sharded_step,
    make_train_step,
)
from svgf_jax.parallel.tiled import (
    make_mesh_from_config,
    make_step_from_config,
    make_tile_mesh,
    make_tiled_step,
    make_tiled_train_step,
)

__all__ = [
    "exchange_col_halo",
    "exchange_row_halo",
    "init_distributed",
    "make_mesh_from_config",
    "make_row_mesh",
    "make_step_from_config",
    "make_tile_mesh",
    "make_tiled_step",
    "make_tiled_train_step",
    "render_frame_sharded",
    "make_sharded_step",
    "make_train_step",
    "with_col_halo",
    "with_row_halo",
    "with_tile_halo",
]
