"""Host-side helpers (logging, rotations, profiler spans)."""
