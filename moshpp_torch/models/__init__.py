from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            effective_weights,
                                            forward_kinematics,
                                            fullpose_from_pose, lbs_forward,
                                            pose_part_ids,
                                            surface_model_from_arrays)
from moshpp_torch.models.object_model import (RigidObjectModel,
                                              rigid_object_forward)
from moshpp_torch.models.synthetic import (make_synthetic_model,
                                           synthetic_model_arrays)
