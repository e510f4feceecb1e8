"""Fleet-scale job filtering (port of `moshpp_tpu/pipeline/jobs.py`;
reference: `tools/run_tools.py:45-67`).

MoSh jobs are dicts of dotlist config overrides. The filter deduplicates
stage-i work per subject key and skips jobs whose stage-ii output already
exists — the filesystem-cache idempotent-rerun model that gives crash
resilience without a coordinator (SURVEY.md §5).
"""

from __future__ import annotations

import copy
import os
from typing import List

from moshpp_torch.config.config import prepare_cfg


def universal_mosh_jobs_filter(total_jobs: List[dict], only_stagei: bool = False,
                               determine_shape_for_each_seq: bool = False) -> List[dict]:
    filtered = []
    exclude_keys = set()
    for job in total_jobs:
        split = job["mocap.fname"].split("/")
        key = "_".join(split[-3:-1])
        cfg = prepare_cfg(**copy.deepcopy(job))
        if cfg["moshpp.perseq_mosh_stagei"]:
            key += f"_{split[-1]}"
        if cfg["mocap.subject_id"] >= 0 and cfg["mocap.multi_subject"]:
            key += f"_{cfg['mocap.session_name']}_{cfg['mocap.subject_name']}"

        if key in exclude_keys:
            continue
        if os.path.exists(cfg["dirs.stageii_fname"]):
            continue  # complete
        if not os.path.exists(cfg["dirs.stagei_fname"]) and not determine_shape_for_each_seq:
            exclude_keys.add(key)  # one job claims the shared stage-i
        if only_stagei and os.path.exists(cfg["dirs.stagei_fname"]):
            continue
        filtered.append(job)
    return filtered
