"""The benchmark of `tinyfaces_tpu_torch` on one NVIDIA H100 (see README.md).

Nothing under this folder imports `jax`, `jaxlib` or the JAX package; only
the drivers import the port, and `reference/` imports nothing of it.
"""
