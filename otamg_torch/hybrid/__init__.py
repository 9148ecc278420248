from otamg_torch.hybrid.solver import (  # noqa: F401
    build_he_solver,
    make_hybrid_amg_solver,
)
