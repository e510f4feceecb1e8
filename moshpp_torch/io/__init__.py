"""File formats the port reads and writes without JAX."""
from moshpp_torch.io.model_loader import load_surface_model, load_dmpl_eigvecs
from moshpp_torch.io.mocap import MocapSession, read_mocap, write_mocap_c3d
from moshpp_torch.io.c3d import read_c3d, write_c3d
from moshpp_torch.io.ply import read_ply, write_ply
from moshpp_torch.io.amass import (load_as_amass_npz,
                                   load_as_amass_npz_legacy,
                                   turn_fullpose_into_parts)
