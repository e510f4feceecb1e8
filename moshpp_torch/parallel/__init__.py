"""Stage ii over several devices (`sharding.py`) and several processes
(`multihost.py`): the port of `moshpp_tpu/parallel/`."""
from moshpp_torch.parallel.sharding import (
    FrameMesh,
    frame_mesh,
    pad_frames,
    mosh_stageii_solve_sharded,
)
from moshpp_torch.parallel.multihost import (
    distribute_jobs,
    global_frame_mesh,
    initialize_multihost,
    mosh_stageii_solve_multihost,
)
