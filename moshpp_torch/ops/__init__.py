# `knn` and `rodrigues` below are the functions: their modules are
# `sys.modules["moshpp_torch.ops.knn"]` etc., or `from ... import`.
from moshpp_torch.ops.rodrigues import rodrigues, rodrigues_inverse
from moshpp_torch.ops.rigid_align import kabsch
from moshpp_torch.ops.surface import face_normals, vertex_normals
from moshpp_torch.ops.knn import knn, nearest_vertex
from moshpp_torch.ops.marker_transform import (marker_coeffs,
                                               reconstruct_markers)
from moshpp_torch.ops.point_mesh import (
    closest_point_on_triangles,
    point_to_mesh_distance,
    signed_point_to_mesh_distance,
)
from moshpp_torch.ops.robustifiers import gmof, signed_sqrt
