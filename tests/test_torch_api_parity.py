"""The JAX package's public contract (tests/test_api_parity.py,
docs/MIGRATION.md) in the port: every name it promises resolves in
`moshpp_torch` to a function or a class, not to a submodule of that name
(`moshpp_torch.ops.knn` is the function once `ops/__init__` exports it),
and the head's `MoSh` has every method of the contract."""

import importlib
import inspect

import pytest

CONTRACT = {
    "pipeline.head": ("MoSh", "run_moshpp_once"),
    "config": ("prepare_cfg",),
    "pipeline.jobs": ("universal_mosh_jobs_filter",),
    "pipeline": ("run_moshpp_fleet", "FleetReport", "mosh_stagei_solve",
                 "mosh_stageii_solve", "StageIOptions", "StageIIOptions",
                 "prepare_stageii_problem"),
    "io.amass": ("load_as_amass_npz", "load_as_amass_npz_legacy",
                 "turn_fullpose_into_parts"),
    "solver": ("dogleg_solve", "batched_dogleg_solve", "DoglegOptions",
               "SolveResult"),
    "models": ("SurfaceModel", "lbs_forward", "forward_kinematics",
               "fullpose_from_pose", "pose_part_ids", "MODEL_TYPE_INFO",
               "RigidObjectModel", "rigid_object_forward",
               "make_synthetic_model"),
    "io": ("load_surface_model", "load_dmpl_eigvecs", "MocapSession",
           "read_mocap", "write_mocap_c3d", "read_c3d", "write_c3d",
           "read_ply", "write_ply"),
    "priors": ("MaxMixturePrior", "gmm_prior_residual", "make_gmm_prior",
               "load_gmm_prior", "MahalanobisPrior", "mahalanobis_residual",
               "load_horse_prior", "horse_joint_angle_residual",
               "load_dog_prior"),
    "priors.gm_prior": ("fit_graphical_lasso_prior", "SubjectPriorCache"),
    "ops": ("marker_coeffs", "reconstruct_markers",
            "closest_point_on_triangles", "point_to_mesh_distance",
            "signed_point_to_mesh_distance", "gmof", "signed_sqrt",
            "vertex_normals", "face_normals", "kabsch", "knn",
            "nearest_vertex", "rodrigues", "rodrigues_inverse"),
    "ops.scan2mesh": ("sample_from_mesh", "scan_to_mesh", "mesh_to_scan",
                      "pts_to_mesh", "clamped_signed_pts_to_mesh"),
    "ops.marker_transform": ("select_frame_indices",),
    "pipeline.frame_picker": ("load_marker_sessions_manual",
                              "load_marker_sessions_random",
                              "load_marker_sessions_random_strict"),
    "markers": ("marker_layout_load", "marker_layout_write",
                "marker_meta_filter", "merge_marker_layouts",
                "marker_labels_to_marker_layout", "all_marker_vids",
                "general_labels_map", "marker_type_labels",
                "smplh2smplx_vids", "smplx2smplh_vids", "smplx_eyeball_vids",
                "marker_meta_smplh2smplx", "marker_meta_smplx2smplh",
                "find_vertex_neighbours", "randomize_marker_layout_vids"),
    "tools.visualization": ("marker_layout_as_mesh", "marker_layout_to_c3d",
                            "export_pose_estimate", "play_mocap_trajectories",
                            "phase_snapshot_writer"),
    "parallel": ("frame_mesh", "pad_frames", "mosh_stageii_solve_sharded"),
    "parallel.multihost": ("initialize_multihost",),
    "cli": ("main", "build_parser"),
}
MOSH_METHODS = ("prepare_cfg", "mosh_stagei", "mosh_stageii",
                "load_as_amass_npz", "load_as_amass_npz_legacy",
                "dump_stagei_marker_layout", "prepare_stagei_frames")


def test_contract_matches_jaxs():
    """CONTRACT is tests/test_api_parity.py's, name for name."""
    import ast
    import os
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "test_api_parity.py")).read()
    theirs = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "_has"):
            mod, *names = [a.value for a in node.args]
            theirs.setdefault(mod.replace("moshpp_tpu.", "", 1),
                              set()).update(names)
    assert theirs == {k: set(v) for k, v in CONTRACT.items()}


@pytest.mark.parametrize("module", sorted(CONTRACT))
def test_names_resolve_to_functions_or_classes(module):
    """Each name is there and of the JAX name's kind: a function or a class
    where JAX's is callable (never a module), else data (the model-type
    table, the lazily loaded vertex tables) of the same kind."""
    mod = importlib.import_module(f"moshpp_torch.{module}")
    ref = importlib.import_module(f"moshpp_tpu.{module}")
    missing = [n for n in CONTRACT[module] if not hasattr(mod, n)]
    assert not missing, f"moshpp_torch.{module} missing: {missing}"
    for n in CONTRACT[module]:
        obj, jobj = getattr(mod, n), getattr(ref, n)
        assert not inspect.ismodule(obj), f"{module}.{n} is a module"
        if callable(jobj):
            assert inspect.isfunction(obj) or inspect.isclass(obj), (
                f"{module}.{n}: {type(obj)}")
        else:
            assert isinstance(obj, dict) == isinstance(jobj, dict), n
            assert not callable(obj), n


def test_mosh_methods():
    from moshpp_torch.pipeline.head import MoSh
    for meth in MOSH_METHODS:
        assert callable(getattr(MoSh, meth, None)), meth


@pytest.mark.parametrize("family", ["smpl", "smplh", "smplx", "mano",
                                    "animal_horse", "animal_dog", "object"])
def test_model_family_registered(family):
    from moshpp_torch.models import MODEL_TYPE_INFO
    assert family in MODEL_TYPE_INFO


def test_knn_and_rodrigues_modules_stay_reachable():
    """With the functions exported under the submodules' names, the modules
    are still `sys.modules` entries and `from ... import` still reaches
    their private names."""
    import sys
    from moshpp_torch.ops import knn, rodrigues
    assert inspect.isfunction(knn) and inspect.isfunction(rodrigues)
    assert inspect.ismodule(sys.modules["moshpp_torch.ops.knn"])
    from moshpp_torch.ops.knn import _sq_dists, smallest_k  # noqa: F401
    from moshpp_torch.ops.rodrigues import rodrigues_inverse  # noqa: F401
