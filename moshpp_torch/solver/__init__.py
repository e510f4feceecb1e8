from moshpp_torch.solver.gauss_newton import (
    DoglegOptions,
    SolveResult,
    dogleg_solve,
    batched_dogleg_solve,
)
