"""The benchmark's plain reference: the SMPL-family forward model and the
latent-marker transport in plain PyTorch, float64 by default. It imports
nothing of the program under test."""

from .body import PRECISIONS, Body, rodrigues, round_tf32
from .markers import (frame_vertices, marker_coefficients, place_markers,
                      vertex_normals)
from .stageii import Subject

__all__ = ["PRECISIONS", "Body", "Subject", "frame_vertices",
           "marker_coefficients", "place_markers", "rodrigues",
           "round_tf32", "vertex_normals"]
