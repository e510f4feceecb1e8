"""`correct` comes out false when the timed path is broken underneath, and
for the control (the reference in TF32 in the program's place); true on
the sound program. The run's look for a chip is skipped (the CPU runs the
program's plain versions, the cells cut to a 642-vertex mesh and 24
frames); `control.py` reads the same at the cells' own sizes on the card.

The faults are `harness/faults.py`'s, one a run.
"""

import pytest

import bench_common  # noqa: F401
from bench_common import run_tiny, tiny_cell
from harness import faults

CELLS = ["smplh.capture4k", "smplx_face80.capture4k"]


@pytest.fixture
def restore_program():
    saved = faults.saved_program()
    yield
    faults.restore(saved)


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    res, _ = run_tiny(tiny_cell(name))
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, restore_program):
    res, lines = run_tiny(tiny_cell(name), hook=faults.FAULTS[fault])
    assert res["correct"] is False, lines
    assert res["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    from harness import judge
    from harness.program import Program
    from harness.world import make_world
    cell = tiny_cell(name)
    w = make_world(cell.config, cell.traffic, 4, "cpu", str(tmp_path))
    p = Program(w, "cpu")
    outs = [p.solve(w.obs[0], w.mask)]
    j = judge.Judge(w)
    sound = judge.checks(j.assess(outs, [0]), cell.limits)
    ctl = judge.checks(j.assess(j.control_outputs(outs), [0]), cell.limits)
    assert judge.passed(sound)
    assert not judge.passed(ctl)
    for k in ("sim_gap_mm", "pose_gap_mrad"):
        assert ctl[k]["value"] > 3 * sound[k]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smplh.capture4k"])
def test_control_and_faults_at_the_cells_size_on_the_card(name, tmp_path,
                                                          restore_program):
    """At the cell's own size, one solve: sound within the cell's limits,
    the control and every fault not."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from harness import judge
    from harness.program import Program
    from harness.spec import load_cell
    from harness.world import make_world
    cell = load_cell(name, bench_common.BENCH)
    w = make_world(cell.config, cell.traffic, 7, "cuda:0", str(tmp_path))
    p = Program(w, "cuda:0")
    outs = [p.solve(w.obs[0], w.mask)]
    broken = {}
    saved = faults.saved_program()
    for fname, hook in faults.FAULTS.items():
        hook(p)
        try:
            broken[fname] = p.solve(w.obs[0], w.mask)
        finally:
            faults.restore(saved, p)
    j = judge.Judge(w)
    assert judge.passed(judge.checks(j.assess(outs, [0]), cell.limits))
    assert not judge.passed(judge.checks(
        j.assess(j.control_outputs(outs), [0]), cell.limits))
    for fname, o in broken.items():
        assert not judge.passed(judge.checks(j.assess([o], [0]),
                                             cell.limits)), fname
