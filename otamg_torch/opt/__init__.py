from otamg_torch.opt.admm import (  # noqa: F401
    WarmStart1,
    WarmStart2,
    warmup_class1,
    warmup_class2,
)
from otamg_torch.opt.apd import (  # noqa: F401
    SolveResult,
    make_class1_step,
    solve_class1,
    solve_class1_chunked,
    solve_class1_fused,
)
from otamg_torch.opt.apd2 import (  # noqa: F401
    Solve2Result,
    default_class2_options,
    make_class2_step,
    solve_class2,
    solve_class2_chunked,
    solve_class2_fused,
)
from otamg_torch.opt.newton import (  # noqa: F401
    NewtonSolveResult,
    make_pcg_solver,
)
