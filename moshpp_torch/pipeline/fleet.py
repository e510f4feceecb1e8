"""Fleet runner: solve many mocap sequences with job dedup + idempotent
caching (port of `moshpp_tpu/pipeline/fleet.py`).

The reference has no in-repo driver — fleets are SOMA scripts that call
`run_moshpp_once` per process and rely on `universal_mosh_jobs_filter` +
filesystem caches for claiming/crash resilience (`run_tools.py:45-67`,
`mosh_head.py:211,272`). This module packages that loop: filter, run, record —
and, unlike a single filter pass, it *re-filters until the job list drains*:
the filter defers all-but-one sequence of a subject while the shared stage-i
is unsolved, so those deferred jobs run on a later pass once the claiming job
has produced it. Workers default to in-process sequential execution (one
process owns the card); `processes > 1` fans out the way the reference
fleet does, over spawn-mode worker processes (CUDA does not survive a
fork), each solving on the `device` it is given.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

from moshpp_torch.pipeline.jobs import universal_mosh_jobs_filter
from moshpp_torch.utils.logging import get_logger


@dataclass
class JobResult:
    job: dict
    status: str                      # ok | failed | filtered | pending
    elapsed_s: float = 0.0
    stageii_fname: Optional[str] = None
    error: Optional[str] = None


@dataclass
class FleetReport:
    results: List[JobResult] = field(default_factory=list)

    @property
    def num_ok(self) -> int:
        return sum(r.status == "ok" for r in self.results)

    @property
    def num_failed(self) -> int:
        return sum(r.status == "failed" for r in self.results)

    @property
    def num_filtered(self) -> int:
        return sum(r.status == "filtered" for r in self.results)

    @property
    def num_pending(self) -> int:
        return sum(r.status == "pending" for r in self.results)

    def summary(self) -> str:
        s = (f"{self.num_ok} ok, {self.num_failed} failed, "
             f"{self.num_filtered} filtered/cached")
        if self.num_pending:
            s += f", {self.num_pending} not attempted"
        return s + f" of {len(self.results)}"


def _run_one(job: dict, device: str) -> JobResult:
    from moshpp_torch.pipeline.head import run_moshpp_once

    t0 = time.perf_counter()
    try:
        mp = run_moshpp_once(copy.deepcopy(job), device=device)
        return JobResult(job=job, status="ok",
                         elapsed_s=time.perf_counter() - t0,
                         stageii_fname=getattr(mp, "stageii_fname", None))
    except Exception:                                   # noqa: BLE001
        return JobResult(job=job, status="failed",
                         elapsed_s=time.perf_counter() - t0,
                         error=traceback.format_exc(limit=12))


def _run_indexed(item, device: str):
    i, job = item
    return i, _run_one(job, device)


def _run_pass(todo, processes, stop_on_error, logger, report, device):
    """Run one filtered batch; returns True if the fleet should stop."""
    if processes <= 1:
        for i, job in enumerate(todo):
            r = _run_one(job, device)
            report.results.append(r)
            logger.info("fleet %d/%d %s (%.1fs): %s", i + 1, len(todo),
                        r.status, r.elapsed_s, job.get("mocap.fname"))
            if r.status == "failed":
                logger.warning("fleet failure:\n%s", r.error)
                if stop_on_error:
                    return True
        return False

    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    stop = False
    n_before = len(report.results)
    with ctx.Pool(processes=processes, maxtasksperchild=4) as pool:
        for i, r in pool.imap_unordered(
                functools.partial(_run_indexed, device=device),
                list(enumerate(todo))):
            # the parent's own job: the fleet tells attempted jobs by
            # identity, and a worker returns a copy
            r = dataclasses.replace(r, job=todo[i])
            report.results.append(r)
            logger.info("fleet %d/%d %s (%.1fs): %s",
                        len(report.results) - n_before, len(todo),
                        r.status, r.elapsed_s, r.job.get("mocap.fname"))
            if r.status == "failed" and stop_on_error:
                pool.terminate()
                stop = True
                break
    return stop


def run_moshpp_fleet(jobs: List[dict], processes: int = 1,
                     only_stagei: bool = False,
                     determine_shape_for_each_seq: bool = False,
                     stop_on_error: bool = False,
                     device: str = "cuda") -> FleetReport:
    """Filter jobs, run them on `device` (re-filtering until the list
    drains), return a per-job report.

    Idempotent: sequences whose stage results exist on disk are filtered out,
    and a crashed fleet rerun resumes from the stage caches. Jobs the filter
    *defers* (waiting on a sibling's shared stage-i) run on a later pass once
    it exists. Failures don't kill the fleet unless `stop_on_error`; jobs
    never attempted when it stops are reported as `pending`.
    """
    logger = get_logger()
    report = FleetReport()

    remaining = list(jobs)
    npass = 0
    while remaining:
        todo = universal_mosh_jobs_filter(
            remaining, only_stagei=only_stagei,
            determine_shape_for_each_seq=determine_shape_for_each_seq)
        if not todo:
            # everything left is complete/cached on disk
            for j in remaining:
                report.results.append(JobResult(job=j, status="filtered"))
            break
        npass += 1
        logger.info("fleet pass %d: %d of %d remaining jobs runnable",
                    npass, len(todo), len(remaining))
        stopped = _run_pass(todo, processes, stop_on_error, logger, report,
                            device)
        attempted = {id(r.job) for r in report.results}
        remaining = [j for j in remaining if id(j) not in attempted]
        if stopped:
            for j in remaining:
                report.results.append(JobResult(job=j, status="pending"))
            break
        # termination: todo is a non-empty subset of remaining and every
        # attempted job leaves remaining, so each pass strictly shrinks it
        # (a failed stage-i claimant's sibling becomes the claimant next
        # pass rather than being deferred forever)
    return report
