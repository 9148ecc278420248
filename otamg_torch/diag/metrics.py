"""Metrics, logging and regression plots (port of ``otamg/diag/metrics.py``;
SURVEY.md section 5.1/5.5).

The reference logs per-iteration printf records (``Class1/
APD_SsN_Class1.m:75-92``) and draws three terminal plots: KKT/objective
decay, SsN counts, and AMG min/avg/max per outer iteration (``:277-334``).
Here the per-iteration records are structured (JSONL) and the same three
plots are produced as regression artifacts with matplotlib when available.
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

import numpy as np


class RunLog:
    """Structured per-iteration record sink with optional JSONL output."""

    def __init__(self, path: Optional[str] = None):
        self.records: list[dict[str, Any]] = []
        self.path = path
        self._fh = open(path, "w") if path else None
        self.t0 = time.perf_counter()

    def log(self, **kv) -> None:
        kv.setdefault("t", round(time.perf_counter() - self.t0, 6))
        self.records.append(kv)
        if self._fh:
            self._fh.write(json.dumps(kv) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def solver_report(res) -> dict[str, Any]:
    """Summary block mirroring the reference's terminal counters
    (``SumAMG/TotalAMG/FailAMG/MaxAMG``, ``Class1/APD_SsN_Class1.m:94-97``)."""
    itnum = np.asarray(res.solver_itnum)
    valid = itnum[:, 2] >= 0 if itnum.size else np.zeros(0, bool)
    return {
        "converged": bool(res.converged),
        "iters": int(res.iters),
        "wall_time_s": float(res.wall_time),
        "objective": float(res.fxk[-1]),
        "ssn_total": int(np.sum(res.ssn_itnum)) if len(res.ssn_itnum) else 0,
        "inner_max": int(itnum[valid, 2].max()) if valid.any() else 0,
        "inner_sum": int(getattr(res, "inner_total", 0)),
        "fail_count": int(res.fail_count),
        "restarts": int(np.sum(res.restarts)) if len(res.restarts) else 0,
    } | _info_block(res)


def _info_block(res) -> dict[str, Any]:
    """The reference's ``info = [num_comp, it_num]`` from the final outer
    iteration's last Newton solve (``Hybrid_AMG.m:113``): component count
    and the ordinal of the last >100-node (AMG-solved) component."""
    nc = getattr(res, "info_ncomp", None)
    ll = getattr(res, "info_last", None)
    if nc is None or ll is None or len(np.atleast_1d(nc)) == 0:
        return {}
    nc = np.asarray(nc)
    ll = np.asarray(ll)
    # Outer iterations whose SsN loop exits at entry run no Newton solve
    # and record ncomp=0; report the most recent iteration that did solve.
    hits = np.nonzero(nc > 0)[0]
    i = hits[-1] if hits.size else -1
    return {"ncomp": int(nc[i]), "last_large": int(ll[i])}


def plot_run(res, out_prefix: str) -> list[str]:
    """The reference's three diagnostic panels as PNG artifacts
    (``Class1/APD_SsN_Class1.m:277-334``).  Returns written paths;
    no-op (returns []) if matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return []

    paths = []
    kx = np.asarray(res.kkt_x if hasattr(res, "kkt_x") else res.kkt[:, 0])
    kl = np.asarray(res.kkt_l if hasattr(res, "kkt_l") else res.kkt[:, -1])
    kx = kx[1:] / (1 + kx[0])
    kl = kl[1:] / (1 + kl[0])
    fxk = np.asarray(res.fxk)
    efxk = np.abs(fxk - fxk[-1])[1:]

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    it = np.arange(1, len(kx) + 1)
    axes[0].loglog(it[: len(efxk)], np.maximum(efxk, 1e-300), "k-d",
                   label=r"$|f(x_k)-f^*|$", ms=3)
    axes[0].loglog(it, np.maximum(kx, 1e-300), "b-^",
                   label=r"KKT$(x_k)$", ms=3)
    axes[0].loglog(it, np.maximum(kl, 1e-300), "r-o",
                   label=r"KKT$(\lambda_k)$", ms=3)
    axes[0].set_xlabel("$k$")
    axes[0].legend(fontsize=8)
    axes[1].semilogy(np.maximum(np.asarray(res.ssn_itnum), 1e-1), "b-^",
                     ms=3)
    axes[1].set_xlabel("$k$")
    axes[1].set_ylabel("#SsN")
    itnum = np.asarray(res.solver_itnum)
    if itnum.size:
        axes[2].semilogy(np.maximum(itnum[:, 2], 1e-1), "r-o", ms=3,
                         label="max")
        axes[2].semilogy(np.maximum(itnum[:, 1], 1e-1), "b-^", ms=3,
                         label="avg")
        axes[2].semilogy(np.maximum(itnum[:, 0], 1e-1), "k-d", ms=3,
                         label="min")
        axes[2].legend(fontsize=8)
    axes[2].set_xlabel("$k$")
    axes[2].set_ylabel("#inner")
    fig.tight_layout()
    path = f"{out_prefix}_convergence.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    paths.append(path)
    return paths
