from otamg_torch.diag.metrics import RunLog, plot_run, solver_report  # noqa: F401
