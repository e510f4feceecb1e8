"""Marker tables (copies of what the JAX package's `markers/` holds)."""
