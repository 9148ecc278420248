from otamg_torch.sparse.containers import COO, CSR, spgemm  # noqa: F401
from otamg_torch.sparse.kernels import ell_spmv, ell_spmv_plain  # noqa: F401
from otamg_torch.sparse.ot_assembly import asat_coo  # noqa: F401
