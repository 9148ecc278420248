from otamg_torch.krylov.pcg import (PCGResult, make_preconditioner,  # noqa: F401
                                    pcg, pcg_matrix)
