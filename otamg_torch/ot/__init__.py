from otamg_torch.ot import operators, problems  # noqa: F401
from otamg_torch.ot.operators import (  # noqa: F401
    apply_A,
    apply_asat,
    apply_At,
    apply_H,
    apply_Ht,
    asat_diags,
    feasibility_polish,
    inv_aat,
    inv_hht,
    kkt_class1,
    kkt_class2,
    prox_box,
    prox_nonneg,
)
from otamg_torch.ot.problems import (  # noqa: F401
    Class1Problem,
    Class2Problem,
    assignment_problem,
    capacitated_problem,
    load_class1_mat,
    load_class2_mat,
    random_class1,
    random_class2,
)
