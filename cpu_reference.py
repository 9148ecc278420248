"""The JAX package's solves on the CPU in f64: the references for the
port's runs on the card.

    JAX_PLATFORMS=cpu python cpu_reference.py --size 500 [--port]
                                              [--solve-dtype float32]
                                              [--dtype float32]
    JAX_PLATFORMS=cpu python cpu_reference.py --class2 --size 500 [--port]
                                              [--newton-parity] [--polish]
                                              [--verbose] [--solve-dtype
                                              float32] [--dtype float32]
    JAX_PLATFORMS=cpu python cpu_reference.py --grid 64 [--maxit 30]
    JAX_PLATFORMS=cpu python cpu_reference.py --sparse-setup 1048576 [--port]
    JAX_PLATFORMS=cpu python cpu_reference.py --cli
    JAX_PLATFORMS=cpu python cpu_reference.py --size 1024 --repairs
                                              [--solve-dtype float32]

``--size``: solves ``random_class1(PRNGKey(0), size, size)`` with the
options ``chip_smoke.py`` gives the port (AMG inner solver, F-cycle,
fuse_deep, f64) and prints one JSON line: converged, outer iterations,
fail_count, the final objective, the total inner iterations, the final
relative KKT residuals and the wall seconds on this CPU (compilation
included).  ``--solve-dtype float32`` runs the Newton solves in the
mixed-precision configuration (fp32 hierarchy, f64 refinement);
``--dtype float32`` makes the plan fp32 (the dual state stays f64);
with ``--port`` the line adds the mixed path's refinement counts.  With ``--class2`` it solves
``random_class2(PRNGKey(0), size, size)`` with ``chip_smoke.py``'s
Class-2 options (AMG inner solver, ``maxit=40, smoth=10``, F-cycle,
fuse_deep, ``ssn_tol1=1e-10``, no feasibility polish) and adds whether
the polish was used, the SsN steps of every outer iteration and the
objective after each; ``--port`` runs the port's ``solve_class1`` or
``solve_class2`` on the CPU in place of the JAX package's, with the same
dtypes, ``--newton-parity`` runs the port's
solve and hands every one of its Newton systems to the JAX package's
POT-AMG solver as well (the same inputs and key), adding the number of
systems, those whose inner iterations differ and the largest relative
difference of the two solutions; ``--verbose`` prints the solve's
per-iteration lines (KKT residuals, objective, SsN steps, inner
iterations) before the JSON line; ``--polish`` turns the feasibility
polish on.

``--grid``: the sparse-AMG solve ``chip_smoke.py`` runs on the card
(``amg_solve_matrix`` on the grid x grid 5-point Laplacian + 0.01 I as an
ELL CSR, ``AMGOptions(maxit=--maxit)``, 100 by default, right-hand side
from ``default_rng(0)``), by the JAX package and by the port on the CPU;
one JSON line with each one's iterations and relative residual.

``--sparse-setup N``: the sparse-setup AMG solve ``chip_smoke.py`` runs
on the card: the 1-D Laplacian + 0.01 I of N rows as an ELL CSR (cap 3),
``setup_hierarchy_sparse(agg=2, dense_crossover=1024)`` and
``amg_solve`` with ``AMGOptions(cycle=F, maxit=60, retol=1e-10,
coarse_target=64)``, right-hand side from ``default_rng(3)``; one JSON
line with the level sizes, iterations, relative residual and the setup
and solve seconds (``--port``: the port's solve on the CPU).

``--repairs`` (Class 1, the JAX package's solve) adds how often the
setup's ``lax.cond`` of the defect repair (``otamg/amg/hierarchy.py:
941``) took the ideal branch: ``repairs`` (levels rebuilt),
``repair_tests`` (coarsenings) and ``newton_solves``, counted by a host
callback wrapped around the package's ``lax.cond``, which is left as it
is.

``--cli``: the JAX package's CLI reports that ``chip_smoke.py``'s cli
phase is held to (``CLI_REF``), one JSON line: ``python -m otamg.cli
class1 --m 256 --n 256 --inner amg --cycle f`` and ``class2 --m 128 --n
128 --inner amg --cycle f``, each run as a subprocess on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--grid", type=int, default=0)
    ap.add_argument("--class2", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--newton-parity", action="store_true")
    ap.add_argument("--polish", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--solve-dtype", default=None, choices=["float32"])
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--maxit", type=int, default=100)
    ap.add_argument("--sparse-setup", type=int, default=0)
    ap.add_argument("--cli", action="store_true")
    ap.add_argument("--repairs", action="store_true")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    if args.cli:
        cli_reference()
        return
    if args.sparse_setup:
        sparse_setup_reference(args.sparse_setup, args.port)
        return
    if args.grid:
        grid_reference(args.grid, args.maxit)
        return
    if args.class2:
        class2_reference(args.size, args.port or args.newton_parity,
                         args.newton_parity, args.polish, args.verbose,
                         args.solve_dtype, args.dtype)
        return
    if args.port:
        import torch

        import chip_smoke
        from otamg_torch.opt import solve_class1
        from otamg_torch.ot import random_class1
        from otamg_torch.random import PRNGKey

        prob = random_class1(PRNGKey(0), args.size, args.size,
                             dtype=getattr(torch, args.dtype), device="cpu")
        opts = chip_smoke.class1_opts(args.solve_dtype)
    else:
        import jax.numpy as jnp

        from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
        from otamg.opt import solve_class1
        from otamg.ot import random_class1

        prob = random_class1(jax.random.PRNGKey(0), args.size, args.size,
                             dtype=getattr(jnp, args.dtype))
        opts = APDOptions(inner_solver=InnerSolver.AMG,
                          solve_dtype=args.solve_dtype,
                          amg=AMGOptions(cycle=Cycle.F, fuse_deep=True))
    repairs = count_repairs() if args.repairs and not args.port else None
    t0 = time.perf_counter()
    res = solve_class1(prob, opts, verbose=args.verbose)
    print(json.dumps({
        "size": args.size,
        "backend": "port-cpu" if args.port else jax.default_backend(),
        "solve_dtype": args.solve_dtype, "dtype": args.dtype,
        "converged": res.converged, "iters": res.iters,
        "fail_count": res.fail_count, "fxk": float(res.fxk[-1]),
        "inner_total": res.inner_total,
        "rel_kkt": [float(res.kkt_x[-1] / (1 + res.kkt_x[0])),
                    float(res.kkt_l[-1] / (1 + res.kkt_l[0]))],
        **refine_counts(args.port),
        **({} if repairs is None else dict(
            repairs=repairs["fired"], repair_tests=repairs["tests"],
            newton_solves=int(res.ssn_itnum.sum()))),
        "seconds": time.perf_counter() - t0,
        "ssn_itnum": [int(v) for v in res.ssn_itnum]}))


def class2_reference(size: int, port: bool, parity: bool, polish: bool,
                     verbose: bool, solve_dtype=None,
                     dtype: str = "float64") -> None:
    solver, extra = None, {}
    if port:
        import torch

        import chip_smoke
        from otamg_torch.opt import solve_class2
        from otamg_torch.ot import random_class2
        from otamg_torch.random import PRNGKey

        prob = random_class2(PRNGKey(0), size, size,
                             dtype=getattr(torch, dtype), device="cpu")
        opts = chip_smoke.class2_opts(solve_dtype)
        if parity:
            solver, extra = newton_parity(prob, opts)
    else:
        import jax.numpy as jnp

        from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
        from otamg.opt.apd2 import solve_class2
        from otamg.ot import random_class2

        prob = random_class2(jax.random.PRNGKey(0), size, size,
                             dtype=getattr(jnp, dtype))
        opts = APDOptions(inner_solver=InnerSolver.AMG, ssn_tol1=1e-10,
                          solve_dtype=solve_dtype,
                          amg=AMGOptions(maxit=40, smoth=10, cycle=Cycle.F,
                                         fuse_deep=True), feas_polish=False)
    opts = dataclasses.replace(opts, feas_polish=polish)
    t0 = time.perf_counter()
    res = solve_class2(prob, opts, solver=solver, verbose=verbose)
    print(json.dumps({
        **extra, "class": 2, "size": size,
        "backend": "port-cpu" if port else jax.default_backend(),
        "solve_dtype": solve_dtype, "dtype": dtype,
        "converged": res.converged, "iters": res.iters,
        "fail_count": res.fail_count, "fxk": float(res.fxk[-1]),
        "polished": res.polished, "inner_total": res.inner_total,
        "rel_kkt": (res.kkt[-1] / (1 + res.kkt[0])).tolist(),
        **refine_counts(port),
        "seconds": time.perf_counter() - t0,
        "ssn_itnum": [int(v) for v in res.ssn_itnum],
        "fxk_trajectory": [float(v) for v in res.fxk]}))


def count_repairs() -> dict:
    """Count the defect repair's branches in the JAX package's setup:
    its one ``lax.cond`` (``otamg/amg/hierarchy.py:941``) is wrapped, as
    the module looks it up, so that a host callback sees each
    predicate.  Returns the running counts, ``fired`` and ``tests``."""
    import types

    from jax import lax

    from otamg.amg import hierarchy

    counts = {"fired": 0, "tests": 0}

    def seen(pred):
        counts["tests"] += 1
        counts["fired"] += int(pred)

    def cond(pred, *a, **kw):
        jax.debug.callback(seen, pred)
        return lax.cond(pred, *a, **kw)

    proxy = types.SimpleNamespace(**{k: getattr(lax, k) for k in dir(lax)
                                     if not k.startswith("__")})
    proxy.cond = cond
    hierarchy.lax = proxy
    return counts


def refine_counts(port: bool) -> dict:
    """The port's mixed-path counts of the run (none for the JAX
    package's)."""
    if not port:
        return {}
    import dataclasses as dc

    from otamg_torch.hybrid.solver import refine_counts as counts

    return {"refine": dc.asdict(counts)}


def newton_parity(prob, opts):
    """A Newton solver for the port's ``solve_class2`` that solves each
    system with the port's POT-AMG solver and, on the same inputs, with
    the JAX package's; returns it and the dict it fills."""
    import jax.numpy as jnp
    import numpy as np

    from otamg.config import AMGOptions, Cycle
    from otamg.hybrid.pot import make_pot_amg_solver as jax_pot
    from otamg_torch.hybrid.pot import make_pot_amg_solver as port_pot

    a = opts.amg
    jsolve = jax.jit(jax_pot(
        *(jnp.asarray(t.numpy()) for t in (prob.p, prob.q, prob.Phi)),
        AMGOptions(maxit=a.maxit, smoth=a.smoth, cycle=Cycle[a.cycle.name],
                   fuse_deep=a.fuse_deep), solve_dtype=opts.solve_dtype))
    tsolve = port_pot(prob.p, prob.q, prob.Phi, a,
                      solve_dtype=opts.solve_dtype)
    out = {"systems": 0, "iters_differ": [], "zeta_max_rel_diff": 0.0}

    def solve(S, tvec, bk1, tk, rhs, key):
        rt = tsolve(S, tvec, bk1, tk, rhs, key)
        rj = jsolve(*(jnp.asarray(t.numpy()) for t in (S, tvec, bk1, tk,
                                                       rhs)),
                    jnp.asarray(key.numpy().astype(np.uint32)))
        zj = np.asarray(rj.zeta)
        d = float(np.abs(rt.zeta.numpy() - zj).max() / np.abs(zj).max())
        out["zeta_max_rel_diff"] = max(out["zeta_max_rel_diff"], d)
        if int(rt.iters) != int(rj.iters):
            out["iters_differ"].append(
                [out["systems"], int(rt.iters), int(rj.iters)])
        out["systems"] += 1
        return rt

    return solve, out


def grid_reference(nx: int, maxit: int) -> None:
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
    rj = jax_solve(jcsr, jnp.asarray(b), AMGOptions(maxit=maxit))
    tj = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = port_solve(A, torch.as_tensor(b), PortAMGOptions(maxit=maxit))
    tt = time.perf_counter() - t0
    print(json.dumps({
        "grid": nx, "maxit": maxit, "jax_iters": int(rj.iters),
        "jax_rel_res": float(rj.rel_res), "jax_seconds": tj,
        "port_iters": int(rt.iters), "port_rel_res": float(rt.rel_res),
        "port_seconds": tt,
        "x_rel_diff": float(np.abs(np.asarray(rj.x) - rt.x.numpy()).max()
                            / np.abs(np.asarray(rj.x)).max())}))


def sparse_setup_reference(N: int, port: bool) -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke

    A = chip_smoke.laplacian_1d_csr(N, 0.01, torch.float64, "cpu")
    b = np.random.default_rng(3).standard_normal(N)
    t0 = time.perf_counter()
    if port:
        from otamg_torch.amg import hierarchy as h
        from otamg_torch.random import PRNGKey

        lv0, rest = h.setup_hierarchy_sparse(
            A, chip_smoke.sparse_setup_opts(), PRNGKey(0), agg=2,
            dense_crossover=1024)
        t1 = time.perf_counter()
        res = h.amg_solve(lv0, rest, torch.as_tensor(b), torch.zeros(
            N, dtype=torch.float64), chip_smoke.sparse_setup_opts())
        x = res.x.numpy()
    else:
        from otamg.amg import hierarchy as h
        from otamg.config import AMGOptions, Cycle
        from otamg.sparse import CSR

        opts = AMGOptions(cycle=Cycle.F, maxit=60, retol=1e-10,
                          coarse_target=64)
        csr = CSR((N, N), *(jnp.asarray(t.numpy()) for t in (
            A.indptr, A.ell_cols, A.ell_vals)))
        lv0, rest = h.setup_hierarchy_sparse(csr, opts,
                                             jax.random.PRNGKey(0), agg=2,
                                             dense_crossover=1024)
        t1 = time.perf_counter()
        res = h.amg_solve(lv0, rest, jnp.asarray(b), jnp.zeros(N), opts)
        x = np.asarray(res.x)
    t2 = time.perf_counter()
    print(json.dumps({
        "N": N, "backend": "port-cpu" if port else jax.default_backend(),
        "levels": [int(h._lvl_size(lv)) for lv in (lv0, *rest)],
        "iters": int(res.iters), "rel_res": float(res.rel_res),
        "x_head": [float(v) for v in x[:4]],
        "setup_seconds": t1 - t0, "solve_seconds": t2 - t1}))


def cli_reference() -> None:
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", OTAMG_NO_COMPILE_CACHE="1")
    out = {}
    for name, argv in (("class1", ["class1", "--m", "256", "--n", "256",
                                   "--inner", "amg", "--cycle", "f"]),
                       ("class2", ["class2", "--m", "128", "--n", "128",
                                   "--inner", "amg", "--cycle", "f"])):
        run = subprocess.run([sys.executable, "-m", "otamg.cli", *argv],
                             capture_output=True, text=True, env=env,
                             check=False)
        out[name] = json.loads(run.stdout.strip().splitlines()[-1])
        out[name]["rc"] = run.returncode
    print(json.dumps(out))


if __name__ == "__main__":
    main()
