"""YAML config composition (a copy of the JAX package's config tree)."""
