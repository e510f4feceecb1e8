"""Host-side helpers (logging, rotations)."""
