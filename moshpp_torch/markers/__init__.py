"""Marker tables and layouts (the port of the JAX package's `markers/`)."""
from moshpp_torch.markers.vids import (
    all_marker_vids,
    marker_type_labels,
    general_labels_map,
    smplh2smplx_vids,
    smplx2smplh_vids,
    smplx_eyeball_vids,
)
from moshpp_torch.markers.layout import (
    marker_layout_load,
    marker_layout_write,
    marker_meta_filter,
    merge_marker_layouts,
    marker_meta_smplh2smplx,
    marker_meta_smplx2smplh,
)
from moshpp_torch.markers.autogen import marker_labels_to_marker_layout
from moshpp_torch.markers.randomize import (
    find_vertex_neighbours,
    randomize_marker_layout_vids,
    vertex_adjacency,
)
