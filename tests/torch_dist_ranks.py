"""The rank side of the port's multi-process CPU tests
(``tests/test_torch_dist.py``, ``tests/test_torch_multiproc.py``).

Each function runs in one of ``world`` processes spawned by
``torch.multiprocessing`` (gloo, a ``file://`` rendezvous), computes its
cases from inputs made with numpy from fixed seeds, and pickles a dict
of numpy results to ``{outdir}/rank{rank}.pkl``; a failing case stores
its error text instead.  This module imports no JAX, so a spawned rank
starts with torch alone.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch


def _start(rank: int, world: int, url: str):
    torch.set_num_threads(1)
    from otamg_torch.dist import init_multihost, make_mesh

    init_multihost(url, world, rank, "cpu")
    return make_mesh()


def _finish(rank: int, outdir: str, out: dict) -> None:
    import torch.distributed as dist

    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def _case(out: dict, name: str, fn) -> None:
    """``out[name] = fn()``, or the error text if it raises."""
    try:
        out[name] = fn()
    except Exception:  # noqa: BLE001 - the test reads the text
        out[name] = "ERROR " + traceback.format_exc()


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# Inputs, made the same way on the JAX side of the tests
# ---------------------------------------------------------------------------


def spmv_inputs():
    rng = np.random.default_rng(3)
    N = 64
    A = rng.standard_normal((N, N))
    A[rng.uniform(size=(N, N)) >= 0.2] = 0.0
    return A, rng.standard_normal(N)


def banded_inputs(halo: int = 3, seed: int = 4):
    rng = np.random.default_rng(seed)
    N = 64
    A = np.zeros((N, N))
    for i in range(N):
        lo, hi = max(0, i - halo), min(N, i + halo + 1)
        A[i, lo:hi] = rng.standard_normal(hi - lo)
    return A, rng.standard_normal(N)


def assembly_inputs():
    rng = np.random.default_rng(7)
    m, n = 40, 24
    p = rng.uniform(0.5, 1.5, m)
    q = rng.uniform(0.5, 1.5, n)
    S = (rng.uniform(size=(m, n)) < 0.3).astype(np.float64)
    tvec = (rng.uniform(size=n + m) < 0.5).astype(np.float64)
    return S, tvec, 1e-3, 0.8, p, q


def galerkin_inputs():
    rng = np.random.default_rng(8)
    N, c = 64, 24
    A = rng.standard_normal((N, N))
    return (A + A.T) / 2, rng.standard_normal((N, c))


def spgemm_inputs(seed: int, density: float):
    rng = np.random.default_rng(seed)
    N = 64
    A = rng.standard_normal((N, N)) * (rng.uniform(size=(N, N)) < density)
    B = rng.standard_normal((N, N)) * (rng.uniform(size=(N, N)) < density)
    return A, B


def grid_laplacian(nx: int, shift: float = 0.01) -> np.ndarray:
    """The 5-point Laplacian + ``shift`` I of an ``nx x nx`` grid."""
    N = nx * nx
    A = np.zeros((N, N))
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            A[k, k] = 4.0 + shift
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < nx:
                    A[k, ii * nx + jj] = -1.0
    return A


def laplacian_1d(N: int, shift: float = 0.01) -> np.ndarray:
    return (np.diag(np.full(N, 2.0 + shift)) - np.diag(np.ones(N - 1), 1)
            - np.diag(np.ones(N - 1), -1))


GRID_NX = 16            # the halo solve: 16 x 16 grid, halo 16
EXPLICIT_WORLDS = (2,)  # explicit_dist against the plain sharded solve
SPARSE_N = 1024         # the sparse-setup solve: 1-D Laplacian
SPARSE_CROSSOVER = 256


def amg_opts(torch_side: bool = True):
    cfg = __import__("otamg_torch.config" if torch_side else "otamg.config",
                     fromlist=["AMGOptions"])
    return cfg.AMGOptions(maxit=30)


def class2_opts():
    """The Class-2 defaults, cut to 15 outer iterations (of 48 to
    convergence at 32 x 24): every collective costs a context switch
    on a loaded CPU."""
    import dataclasses

    from otamg_torch.opt.apd2 import default_class2_options

    return dataclasses.replace(default_class2_options(), maxit=15)


def sparse_opts(torch_side: bool = True):
    cfg = __import__("otamg_torch.config" if torch_side else "otamg.config",
                     fromlist=["AMGOptions"])
    return cfg.AMGOptions(cycle=cfg.Cycle.F, maxit=30, retol=1e-10,
                          coarse_target=32)


# ---------------------------------------------------------------------------
# tests/test_torch_dist.py
# ---------------------------------------------------------------------------


BLOCKED = ("chunk1", "chunk3", "chunk8", "fused")
"""The blocked drivers of the sharded solves: chunked with ``chunk``
1, 3 and 8, and fused."""
def labels_mask():
    """A 40 x 36 mask of several components."""
    rng = np.random.default_rng(12)
    return (rng.uniform(size=(40, 36))
            * (rng.uniform(size=(40, 36)) < 0.04))


def front_arrays(seed: int = 9, m: int = 40, n: int = 36,
                 density: float = 0.05):
    """``(S, tvec, bk1, tk, p, q)`` of a Class-1 Newton system on a
    random active set (``tvec`` 0 on half the nodes)."""
    rng = np.random.default_rng(seed)
    S = (rng.uniform(size=(m, n)) < density).astype(float)
    p, q = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, n)
    tvec = (rng.uniform(size=n + m) < 0.5).astype(float)
    return S, tvec, np.float64(1e-3), np.float64(0.5), p, q


def labels_rank(rank: int, world: int, url: str, outdir: str) -> None:
    """On this rank's rows of :func:`labels_mask`: the labels of the
    gathered mask (one ``label_rounds`` call, the card's form) and of
    the sharded loop (a minimum and a gather a round, the CPU's); and
    the labels, ``ncomp`` and ``last`` of the sharded ``newton_front`` of
    :func:`front_arrays`."""
    mesh = _start(rank, world, url)
    from otamg_torch.amg.graph import connected_components_bipartite
    from otamg_torch.amg.kernels import label_rounds
    from otamg_torch.config import AMGOptions, Cycle
    from otamg_torch.dist import api
    from otamg_torch.hybrid.solver import newton_front
    from otamg_torch.random import PRNGKey

    out: dict = {}

    def rows(a):
        r0, r1 = mesh.rows(a.shape[0])
        return T(a)[r0:r1].contiguous()

    def front():
        S, tvec, bk1, tk, p, q = front_arrays()
        fr = newton_front(rows(S), T(tvec), T(bk1), T(tk), rows(p), T(q),
                          AMGOptions(cycle=Cycle.F, fuse_deep=True,
                                     coarse_target=6), PRNGKey(9))
        return fr.labels.numpy(), int(fr.ncomp), int(fr.last)

    E = labels_mask()
    with api.use_mesh(mesh):
        _case(out, "gathered", lambda: label_rounds(
            api.all_gather_rows(rows(E)))[0].numpy())
        _case(out, "per_round",
              lambda: connected_components_bipartite(rows(E)).numpy())
        _case(out, "front", front)
    _finish(rank, outdir, out)


def refine_rank(rank: int, world: int, url: str, outdir: str) -> None:
    """The blocked mixed Newton solve (``exit_every`` 3) of
    :func:`front_arrays`' system on this rank's rows, the right-hand side
    of ``tests/test_torch_refine_graph.py::system``: the replicated
    solution, ``iters``, and the refinement's rounds and cycles."""
    mesh = _start(rank, world, url)
    from otamg_torch.config import AMGOptions, Cycle
    from otamg_torch.dist import api
    from otamg_torch.hybrid.solver import build_he_solver, refine_counts
    from otamg_torch.random import PRNGKey

    def rows(a):
        r0, r1 = mesh.rows(a.shape[0])
        return T(a)[r0:r1].contiguous()

    def blocked():
        S, tvec, bk1, tk, p, q = front_arrays()
        rhs = np.random.default_rng(1).standard_normal(tvec.shape[0])
        refine_counts.reset()
        he, _, _ = build_he_solver(rows(S), T(tvec), T(bk1), T(tk), rows(p),
                                   T(q), AMGOptions(cycle=Cycle.F,
                                                    fuse_deep=True,
                                                    coarse_target=6),
                                   PRNGKey(3), "float32", 10, 3)
        zeta, iters, _ = he(T(rhs), PRNGKey(5))
        return (zeta.numpy(), int(iters), refine_counts.rounds,
                refine_counts.cycles)

    out: dict = {}
    with api.use_mesh(mesh):
        _case(out, "blocked", blocked)
    _finish(rank, outdir, out)


PARTS = ("main", "blocked1", "blocked2")
"""The groups of cases :func:`dist_rank` runs, each world spawned once
per part so that the parts run side by side: the ``dist/`` functions
and the loop solves, then the Class-1 and the Class-2 solves of the
blocked drivers."""


def blocked_driver(cls: int, name: str):
    """``solve(prob, opts)`` of the Class-``cls`` blocked driver
    ``name`` (an entry of :data:`BLOCKED`)."""
    import functools

    from otamg_torch import opt

    if name == "fused":
        return getattr(opt, f"solve_class{cls}_fused")
    return functools.partial(getattr(opt, f"solve_class{cls}_chunked"),
                             chunk=int(name[len("chunk"):]))


def dist_rank(rank: int, world: int, url: str, outdir: str,
              part: str = "main") -> None:
    """The cases of ``part`` (an entry of :data:`PARTS`)."""
    mesh = _start(rank, world, url)
    from otamg_torch import dist as tdist
    from otamg_torch.amg import hierarchy as th
    from otamg_torch.config import APDOptions, InnerSolver
    from otamg_torch.dist.api import all_gather_rows as gather
    from otamg_torch.opt import solve_class1
    from otamg_torch.opt.apd2 import solve_class2
    from otamg_torch.ot import random_class1, random_class2
    from otamg_torch.random import PRNGKey
    from otamg_torch.sparse import CSR

    out: dict = {}
    N = lambda t: t.numpy()

    def rows(a):
        r0, r1 = mesh.rows(a.shape[0])
        return T(a)[r0:r1].contiguous()

    def spmv_allgather():
        A, x = spmv_inputs()
        csr = CSR.from_dense(T(A), row_cap=A.shape[0])
        r0, r1 = mesh.rows(A.shape[0])
        y = tdist.spmv_allgather(mesh, csr.ell_cols[r0:r1],
                                 csr.ell_vals[r0:r1], rows(x))
        return N(gather(y, mesh))

    def spmv_halo():
        A, x = banded_inputs()
        csr = CSR.from_dense(T(A), row_cap=7)
        r0, r1 = mesh.rows(A.shape[0])
        y = tdist.spmv_halo(mesh, csr.ell_cols[r0:r1], csr.ell_vals[r0:r1],
                            rows(x), halo=3)
        return N(gather(y, mesh))

    def asat():
        S, tvec, bk1, tk, p, q = assembly_inputs()
        d1, d2 = tdist.asat_diags_sharded(mesh, rows(S), rows(p), T(q))
        return N(d1), N(gather(d2, mesh))

    def transform():
        S, tvec, bk1, tk, p, q = assembly_inputs()
        E, g, kdiag = tdist.transform_sharded(mesh, rows(S), T(tvec), bk1,
                                              tk, rows(p), T(q))
        return N(gather(E, mesh)), N(g), N(kdiag)

    def galerkin():
        A, Pr = galerkin_inputs()
        return N(tdist.galerkin_sharded(mesh, rows(A), T(Pr)))

    def spgemm_plain():
        A, B = spgemm_inputs(9, 0.1)
        ca = CSR.from_dense(T(A), row_cap=16)
        cb = CSR.from_dense(T(B), row_cap=16)
        r0, r1 = mesh.rows(A.shape[0])
        cc, cv, need = tdist.spgemm_rowsharded(
            mesh, ca.ell_cols[r0:r1], ca.ell_vals[r0:r1], cb.ell_cols,
            cb.ell_vals)
        return N(gather(cc, mesh)), N(gather(cv, mesh)), int(need)

    def spgemm_chain():
        A, _ = spgemm_inputs(11, 0.08)
        A2 = A @ A
        out_cap = max(2 * int(np.max(((A2 @ A) != 0).sum(axis=1))),
                      2 * int(np.max((A2 != 0).sum(axis=1))))
        ca = CSR.from_dense(T(A), row_cap=16)
        r0, r1 = mesh.rows(A.shape[0])
        cc, cv, need = tdist.spgemm_rowsharded(
            mesh, ca.ell_cols[r0:r1], ca.ell_vals[r0:r1], ca.ell_cols,
            ca.ell_vals, out_cap=out_cap)
        cc2, cv2, need2 = tdist.spgemm_rowsharded(
            mesh, cc, cv, ca.ell_cols, ca.ell_vals, out_cap=out_cap)
        return (N(gather(cc2, mesh)), N(gather(cv2, mesh)), int(need),
                int(need2), out_cap)

    def spgemm_overflow():
        A, _ = spgemm_inputs(13, 0.2)
        ca = CSR.from_dense(T(A), row_cap=24)
        tight = max(2, int(np.max(((A @ A) != 0).sum(axis=1))) // 2)
        r0, r1 = mesh.rows(A.shape[0])
        _, _, need = tdist.spgemm_rowsharded(
            mesh, ca.ell_cols[r0:r1], ca.ell_vals[r0:r1], ca.ell_cols,
            ca.ell_vals, out_cap=tight)
        return int(need), tight

    def halo_solve():
        A = grid_laplacian(GRID_NX)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        csr = CSR.from_dense(T(A), row_cap=5)
        res = th.amg_solve_matrix(csr, T(b), amg_opts(),
                                  dist=(mesh, GRID_NX))
        return N(res.x), int(res.iters), float(res.rel_res)

    def sparse_setup_solve():
        A = laplacian_1d(SPARSE_N)
        b = np.random.default_rng(3).standard_normal(SPARSE_N)
        csr = CSR.from_dense(T(A), row_cap=3)
        opts = sparse_opts()
        lv0, rest = th.setup_hierarchy_sparse(
            csr, opts, PRNGKey(0), agg=2, dense_crossover=SPARSE_CROSSOVER,
            dist=(mesh, 1))
        res = th.amg_solve(lv0, rest, rows(b), torch.zeros(lv0.dg.shape[0],
                                                            dtype=torch.float64),
                           opts)
        return (N(gather(res.x, mesh)), int(res.iters), float(res.rel_res),
                type(lv0).__name__)

    def halo_violation():
        A, _ = banded_inputs()
        csr = CSR.from_dense(T(A), row_cap=7)
        try:
            th.setup_hierarchy_sparse(csr, sparse_opts(), PRNGKey(0),
                                      dist=(mesh, 1))
        except ValueError as exc:
            return str(exc)
        return "no error"

    def m_not_divisible():
        prob = random_class1(PRNGKey(0), 31, 8,
                             device="cpu")
        try:
            tdist.shard_class1(prob, mesh)
        except ValueError as exc:
            return str(exc)
        return "no error"

    def class1(inner, key=42, maxit=40, solve=solve_class1, **kw):
        prob = random_class1(PRNGKey(key), 32, 24, device="cpu")
        r = solve(tdist.shard_class1(prob, mesh),
                  APDOptions(inner_solver=InnerSolver[inner], maxit=maxit,
                             **kw))
        return dict(converged=r.converged, iters=r.iters, kkt_x=r.kkt_x,
                    kkt_l=r.kkt_l, fxk=r.fxk, fail_count=r.fail_count,
                    ssn=r.ssn_itnum, inner=r.solver_itnum,
                    X=N(gather(r.X, mesh)), lam=N(r.lam))

    def class2(solve=solve_class2):
        prob = random_class2(PRNGKey(7), 32, 24, mu_frac=0.6, device="cpu")
        r = solve(tdist.shard_class2(prob, mesh), class2_opts())
        return dict(converged=r.converged, iters=r.iters, kkt=r.kkt,
                    fxk=r.fxk, fail_count=r.fail_count,
                    ssn=r.ssn_itnum, inner=r.solver_itnum, lam=N(r.lam),
                    X=N(gather(r.X, mesh)))

    if part != "main":
        # The blocked drivers, held to the loop cases of the "main" part.
        for name in BLOCKED:
            if part == "blocked1":
                for inner in ("PCG", "AMG"):
                    _case(out, f"class1_{inner}_{name}", lambda: class1(
                        inner, solve=blocked_driver(1, name)))
            else:
                _case(out, f"class2_{name}",
                      lambda: class2(blocked_driver(2, name)))
        _finish(rank, outdir, out)
        return

    for name, fn in (
            ("spmv_allgather", spmv_allgather), ("spmv_halo", spmv_halo),
            ("asat", asat), ("transform", transform),
            ("galerkin", galerkin), ("spgemm_plain", spgemm_plain),
            ("spgemm_chain", spgemm_chain),
            ("spgemm_overflow", spgemm_overflow),
            ("halo_solve", halo_solve),
            ("sparse_setup_solve", sparse_setup_solve),
            ("halo_violation", halo_violation),
            ("m_not_divisible", m_not_divisible),
            ("class1_PCG", lambda: class1("PCG")),
            ("class1_AMG", lambda: class1("AMG")),
            ("class2", class2)) + ((
                ("class1_implicit", lambda: class1("AMG", 43, 10)),
                ("class1_explicit", lambda: class1("AMG", 43, 10,
                                                   explicit_dist=True)))
                if world in EXPLICIT_WORLDS else ()):
        _case(out, name, fn)
    _finish(rank, outdir, out)


# ---------------------------------------------------------------------------
# tests/test_torch_multiproc.py
# ---------------------------------------------------------------------------


CKPT_SIZE = (32, 24)


def checkpoint_rank(rank: int, world: int, url: str, outdir: str,
                    ckdir: str, phase: str, driver: str = "loop") -> None:
    """``phase`` "full" solves uninterrupted, "cut" stops at iteration 20
    with checkpoints every 10 (the chunked driver: at its chunk
    boundaries, chunk 10), "resume" resumes from the latest; ``driver``
    "loop" or "chunked" (chunk 8 when it resumes)."""
    mesh = _start(rank, world, url)
    from otamg_torch.config import APDOptions, InnerSolver
    from otamg_torch.dist import shard_class1
    from otamg_torch.dist.api import all_gather_rows
    from otamg_torch.opt import solve_class1, solve_class1_chunked
    from otamg_torch.ot import random_class1
    from otamg_torch.random import PRNGKey

    out: dict = {}

    def run():
        prob = shard_class1(random_class1(PRNGKey(5), *CKPT_SIZE,
                                          device="cpu"), mesh)
        maxit = 20 if phase == "cut" else 60
        opts = APDOptions(inner_solver=InnerSolver.AMG, maxit=maxit)
        kw = dict(checkpoint_dir=None if phase == "full" else ckdir,
                  resume=phase == "resume")
        if driver == "chunked":
            r = solve_class1_chunked(prob, opts,
                                     chunk=10 if phase == "cut" else 8, **kw)
        else:
            r = solve_class1(prob, opts, checkpoint_every=10, **kw)
        return dict(converged=r.converged, iters=r.iters, fxk=r.fxk,
                    X=all_gather_rows(r.X, mesh).numpy(), lam=r.lam.numpy())

    _case(out, phase, run)
    _finish(rank, outdir, out)


def spawn(fn, world: int, tmpdir: str, *args, tag: str = ""):
    """Run ``fn(rank, world, url, outdir, *args)`` on ``world`` spawned
    ranks; returns ``(context, outdir)``.  :func:`collect` joins them.
    ``tag`` tells apart groups of the same ``fn`` and world."""
    import torch.multiprocessing as mp

    name = f"{world}_{fn.__name__}{tag}"
    outdir = os.path.join(tmpdir, f"out{name}")
    os.makedirs(outdir, exist_ok=True)
    url = "file://" + os.path.join(tmpdir, f"rdv{name}")
    ctx = mp.start_processes(fn, args=(world, url, outdir, *args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, outdir


def collect(ctx, outdir: str, world: int, timeout: float = 600) -> list:
    """Join the ranks of :func:`spawn`; their result dicts by rank."""
    import time

    t_end = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, t_end - time.monotonic())):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out
