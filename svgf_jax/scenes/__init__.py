from svgf_jax.scenes.cornell import cornell_box
from svgf_jax.scenes.default_scene import default_scene

__all__ = ["cornell_box", "default_scene"]
