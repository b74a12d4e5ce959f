from gendr_jax.ops import distributions, tconorms  # noqa: F401
