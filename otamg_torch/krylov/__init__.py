from otamg_torch.krylov.pcg import PCGResult, pcg  # noqa: F401
