from otamg_torch.ot.operators import (  # noqa: F401
    apply_A,
    apply_asat,
    apply_At,
    asat_diags,
    inv_aat,
    kkt_class1,
    prox_box,
)
from otamg_torch.ot.problems import (  # noqa: F401
    Class1Problem,
    load_class1_mat,
    random_class1,
)
