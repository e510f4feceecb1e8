"""Inspection artifacts written to disk (the port of the JAX package's
`tools/`)."""
