from otamg_torch.opt.admm import WarmStart1, warmup_class1  # noqa: F401
from otamg_torch.opt.apd import SolveResult, solve_class1  # noqa: F401
from otamg_torch.opt.newton import (  # noqa: F401
    NewtonSolveResult,
    make_pcg_solver,
)
