"""The JAX package's solves on the CPU in f64: the references for the
port's runs on the card.

    JAX_PLATFORMS=cpu python cpu_reference.py --size 500
    JAX_PLATFORMS=cpu python cpu_reference.py --grid 64

``--size``: solves ``random_class1(PRNGKey(0), size, size)`` with the
options ``chip_smoke.py`` gives the port (AMG inner solver, F-cycle,
fuse_deep, f64) and prints one JSON line: converged, outer iterations,
fail_count, the final objective, the total inner iterations and the wall
seconds on this CPU (compilation included).

``--grid``: the sparse-AMG solve ``chip_smoke.py`` runs on the card
(``amg_solve_matrix`` on the grid x grid 5-point Laplacian + 0.01 I as an
ELL CSR, ``AMGOptions(maxit=100)``, right-hand side from
``default_rng(0)``), by the JAX package and by the port on the CPU; one
JSON line with each one's iterations and relative residual.
"""

from __future__ import annotations

import argparse
import json
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--grid", type=int, default=0)
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    if args.grid:
        grid_reference(args.grid)
        return
    from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
    from otamg.opt import solve_class1
    from otamg.ot import random_class1

    prob = random_class1(jax.random.PRNGKey(0), args.size, args.size)
    opts = APDOptions(inner_solver=InnerSolver.AMG,
                      amg=AMGOptions(cycle=Cycle.F, fuse_deep=True))
    t0 = time.perf_counter()
    res = solve_class1(prob, opts)
    print(json.dumps({
        "size": args.size, "backend": jax.default_backend(),
        "converged": res.converged, "iters": res.iters,
        "fail_count": res.fail_count, "fxk": float(res.fxk[-1]),
        "inner_total": res.inner_total,
        "seconds": time.perf_counter() - t0}))


def grid_reference(nx: int) -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from otamg.amg.hierarchy import amg_solve_matrix as jax_solve
    from otamg.config import AMGOptions
    from otamg.sparse import CSR as JaxCSR
    from otamg_torch.amg.hierarchy import amg_solve_matrix as port_solve
    from otamg_torch.config import AMGOptions as PortAMGOptions

    A = chip_smoke.grid_csr(nx, 0.01, torch.float64, "cpu")
    b = np.random.default_rng(0).standard_normal(nx * nx)
    jcsr = JaxCSR(A.shape, jnp.asarray(A.indptr.numpy()),
                  jnp.asarray(A.ell_cols.numpy()),
                  jnp.asarray(A.ell_vals.numpy()))
    t0 = time.perf_counter()
    rj = jax_solve(jcsr, jnp.asarray(b), AMGOptions(maxit=100))
    tj = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = port_solve(A, torch.as_tensor(b), PortAMGOptions(maxit=100))
    tt = time.perf_counter() - t0
    print(json.dumps({
        "grid": nx, "jax_iters": int(rj.iters),
        "jax_rel_res": float(rj.rel_res), "jax_seconds": tj,
        "port_iters": rt.iters, "port_rel_res": float(rt.rel_res),
        "port_seconds": tt,
        "x_rel_diff": float(np.abs(np.asarray(rj.x) - rt.x.numpy()).max()
                            / np.abs(np.asarray(rj.x)).max())}))


if __name__ == "__main__":
    main()
