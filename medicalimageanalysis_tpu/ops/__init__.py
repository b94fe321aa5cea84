"""Device-side compute kernels (JAX/XLA) and the geometry core."""

from ..runtime import setup_jax_cache as _setup_jax_cache
_setup_jax_cache()
