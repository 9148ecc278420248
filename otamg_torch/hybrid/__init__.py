from otamg_torch.hybrid.pot import (  # noqa: F401
    make_pot_amg_solver,
    make_pot_direct_solver,
    make_pot_pcg_solver,
)
from otamg_torch.hybrid.solver import (  # noqa: F401
    build_he_solver,
    make_aug_pcg_solver,
    make_direct_solver,
    make_hybrid_amg_solver,
)
