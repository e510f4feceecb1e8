"""Marker tables and layouts (the port of the JAX package's `markers/`)."""
