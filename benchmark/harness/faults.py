"""Faults planted underneath the timed path, for the check that `correct`
comes out false on each (`tests/test_bench_faults.py` on the CPU,
`control.py --faults` on the card at a cell's own size). Each takes the
harness's `Program` and breaks it in place; `restore()` mends the
program's module.

- `unchanged_state`: every dogleg solve returns its start unchanged;
- `half_batch`: half of the frames left out, the other half's answers
  copied in;
- `altered_kernel_marker`: one marker of the forward kernel's output
  moved 10 mm, in the system and in the trial cost;
- `altered_answer`: the returned translation moved 2 mm after the solve.

The exchange between chips has no fault: every cell runs on one chip.
"""

import torch

PATCHED = ("batched_system_solve", "marker_sim_and_jacobian", "marker_sim")


def saved_program():
    from moshpp_torch.pipeline import stageii
    return {k: getattr(stageii, k) for k in PATCHED}


def restore(saved, program=None) -> None:
    """Mend the program's module, and `program`'s own `solve`."""
    from moshpp_torch.pipeline import stageii
    for k, v in saved.items():
        setattr(stageii, k, v)
    if program is not None:
        program.__dict__.pop("solve", None)


def _unchanged_state(program):
    from moshpp_torch.solver.gauss_newton import SolveResult

    def solve(system, x0, aux, options, *a, **k):
        n = x0.shape[0]
        return SolveResult(x=x0, cost=system.cost_fn(x0, aux),
                           iterations=torch.zeros(n, dtype=torch.int32,
                                                  device=x0.device),
                           converged=torch.zeros(n, dtype=torch.bool,
                                                 device=x0.device),
                           host_syncs=1)
    program._stageii.batched_system_solve = solve


def _half_batch(program):
    inner = program.solve

    def solve(obs, mask):
        h = obs.shape[0] // 2
        out = inner(obs[:h], mask[:h])
        for k, v in out.items():
            if torch.is_tensor(v):
                out[k] = torch.cat([v, v[:obs.shape[0] - h]])
        return out
    program.solve = solve


def _altered_kernel_marker(program):
    st = program._stageii
    rows, sim = st.marker_sim_and_jacobian, st.marker_sim

    def shift(m):
        m = m.clone()
        m[:, 0, 0] += 0.01
        return m

    def rows_shifted(model, tables, x):
        s, j = rows(model, tables, x)
        return shift(s), j
    st.marker_sim_and_jacobian = rows_shifted
    st.marker_sim = lambda model, tables, x: shift(sim(model, tables, x))


def _altered_answer(program):
    inner = program.solve

    def solve(obs, mask):
        out = inner(obs, mask)
        out["trans"] = out["trans"] + 0.002
        return out
    program.solve = solve


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_kernel_marker": _altered_kernel_marker,
          "altered_answer": _altered_answer}
