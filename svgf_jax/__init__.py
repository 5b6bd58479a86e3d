"""svgf_jax — a real-time path tracing + SVGF denoising framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
CUDA/OpenGL SVGF renderer (jacquespillet/SVGF): a hybrid 1spp path tracer with
a G-buffer primary-visibility pass, spatiotemporal variance-guided filtering
(Schied et al. 2017), TAA, scene/BVH management, and multi-device
image-space parallelism — differentiable end-to-end.

Layer map (reference -> here):
  L1 device memory/interop   -> jax.Array + donation (XLA manages memory)
  L2 scene model & asset IO  -> svgf_jax.core  (+ svgf_jax.io loaders)
  L3 acceleration structures -> svgf_jax.accel (host build, device traversal)
  L4 device kernels          -> svgf_jax.ops / svgf_jax.render
  L5 orchestrator            -> svgf_jax.render.pipeline.Renderer
  L6 GUI                     -> offline drivers + debug taps (svgf_jax.utils)
  parallelism (new)          -> svgf_jax.parallel (mesh/sharding/halo exchange)
"""

__version__ = "0.1.0"

from svgf_jax.config import RenderConfig, SVGFConfig, TracingConfig, SamplingMode, DebugOutput

__all__ = [
    "RenderConfig",
    "SVGFConfig",
    "TracingConfig",
    "SamplingMode",
    "DebugOutput",
]
