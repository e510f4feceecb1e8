"""MoSh++'s two solves: stage i (shape, latent markers and poses from a few
frames) and stage ii (every frame's pose with those held fixed); the head
(`head.py`) and the fleet (`fleet.py`) drive them from mocap files."""
from moshpp_torch.pipeline.stagei import (StageIOptions, StageIResult,
                                          mosh_stagei_solve,
                                          mosh_stagei_solve_batched,
                                          stagei_result_from_arrays)
from moshpp_torch.pipeline.stageii import (StageIIOptions, StageIIReport,
                                           StageIIResult,
                                           mosh_stageii_solve,
                                           prepare_stageii_problem)
from moshpp_torch.pipeline.fleet import (FleetReport, JobResult,
                                         run_moshpp_fleet)
