from otamg_torch.sparse.containers import CSR  # noqa: F401
from otamg_torch.sparse.kernels import ell_spmv, ell_spmv_plain  # noqa: F401
