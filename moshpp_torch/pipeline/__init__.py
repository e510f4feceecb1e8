"""MoSh++'s two solves: stage i (shape, latent markers and poses from a few
frames) and stage ii (every frame's pose with those held fixed)."""
from moshpp_torch.pipeline.stagei import (StageIOptions, StageIResult,
                                          mosh_stagei_solve,
                                          mosh_stagei_solve_batched,
                                          stagei_result_from_arrays)
from moshpp_torch.pipeline.stageii import (StageIIOptions, StageIIResult,
                                           mosh_stageii_solve,
                                           prepare_stageii_problem)
