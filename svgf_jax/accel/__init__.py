from svgf_jax.accel.bvh import BLAS, build_blas, build_tlas, flatten_blases, FlatBVH

__all__ = ["BLAS", "build_blas", "build_tlas", "flatten_blases", "FlatBVH"]
