"""Hybrid Newton-system solvers (port of ``otamg/hybrid/solver.py``).

The SsN Jacobian system ``He zeta = z`` (``He = bk1 I + (T + H0)/tk``) is
transformed by the similarity ``Q0 = diag(q, -p)`` into ``Ae u = f`` with
``Ae = diag(g) - E/tk``, ``E_ij = p_i^2 q_j^2 s_ij`` and
``g = bk1 [q^2; p^2] + (k + a0diag)/tk`` (``Hybrid_AMG.m:16-24``): the
graph Laplacian of the bipartite active-set graph plus a diagonal.  All
graph components are solved at once in one masked hierarchy whose
projections act per component through the labels.

With ``solve_dtype="float32"`` the hierarchy is built and cycled in
fp32 and the solution is refined in the problem's precision: the kernel
coordinate of each near-singular component is solved exactly in f64, and
each refinement round runs one fp32 correction solve through the
deflated cycle (``build_he_solver``).

The same transform serves the nullspace-augmented PCG
(``make_aug_pcg_solver``); ``make_direct_solver`` assembles the Jacobian
densely.

Everything a Newton solve runs before its cycles, the transform, the
components and the AMG setup, is its front (:func:`newton_front`): it
reads nothing on the host on a card, where the chunked and fused drivers
replay it as one CUDA graph per :func:`front_signature`.

Under an active mesh (a row-sharded problem, :mod:`otamg_torch.dist`)
``S``, ``p`` and ``E`` are this rank's rows: the transform is
:func:`otamg_torch.dist.transform_sharded`, the components are found on
the sharded ``E`` (on a card on the whole ``E``, gathered once for them
and the setup) and the hierarchy is the sharded one of
:func:`otamg_torch.amg.hierarchy.setup_hierarchy`; ``zeta`` comes out
replicated.  The dense direct solvers need the whole ``S`` and refuse a
mesh.
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import torch

from otamg_torch import random as jr
from otamg_torch.amg.graph import connected_components_bipartite, segment_sum
from otamg_torch.amg.hierarchy import (_level0_ops, _lvl_size,
                                       _make_solve_cycle, _scalar,
                                       _solve_step, amg_solve,
                                       capacity_schedule, reads_nothing,
                                       setup_draws, setup_flat,
                                       setup_hierarchy_generic, setup_unflat,
                                       solve_retol, solve_start)
from otamg_torch.config import AMGOptions, PCGOptions
from otamg_torch.device import fetch
from otamg_torch.dist import api
from otamg_torch.dist.assembly import transform_sharded
from otamg_torch.graphs import (AMG_CYCLES, REFINE_CYCLES, Captured,
                                GraphCache, State, cond_counts, run_region,
                                when)
from otamg_torch.krylov.pcg import pcg
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
from otamg_torch.ot import operators as op
from otamg_torch.sparse.segment import SegmentPlan, segment_plan


def _transform(S, tvec, bk1, tk, rhs, p, q, mesh=None):
    """Shared Q0-transform pieces (``Hybrid_AMG.m:16-24``); over this
    rank's rows through :func:`transform_sharded` on ``mesh`` (the active
    mesh by default)."""
    mesh = mesh if mesh is not None else api.current_mesh()
    if mesh is not None:
        E, g, kdiag = transform_sharded(mesh, S, tvec, bk1, tk, p, q)
        q0 = torch.cat([q, -api.all_gather_rows(p, mesh)])
        return E, g, kdiag, q0 * rhs, q0
    p2 = p * p
    q2 = q * q
    q0 = torch.cat([q, -p])
    qp2 = torch.cat([q2, p2])
    E = (p2[:, None] * q2[None, :]) * S
    a0diag = torch.cat([E.sum(dim=0), E.sum(dim=1)])
    kdiag = qp2 * tvec
    g = bk1 * qp2 + (kdiag + a0diag) / tk
    f = q0 * rhs
    return E, g, kdiag, f, q0


def _component_info(E, kdiag, exit_every: int = 1):
    """Component labels and per-component near-singularity flags
    (``Hybrid_AMG.m:33-40,60-66``: a component is near-singular iff the
    ``K`` diagonal vanishes on it), the component count, and ``last``:
    the 1-based ordinal (in increasing root-label order) of the last
    component with more than 100 nodes (``Hybrid_AMG.m:51,80,113``).
    ``exit_every`` is label propagation's read interval."""
    N = kdiag.shape[0]
    labels = connected_components_bipartite(E, exit_every=exit_every)
    nsp = segment_sum(kdiag, labels, N)[labels] == 0
    roots = labels == torch.arange(N, device=labels.device)
    ncomp = roots.sum()
    sizes = segment_sum(torch.ones(N, dtype=torch.int64,
                                   device=labels.device), labels, N)
    ordinal = torch.cumsum(roots.to(torch.int64), 0)
    last = torch.where(roots & (sizes > 100), ordinal, 0).amax()
    return labels, nsp, ncomp, last


def _a0diag_hi(S, p, q):
    """Exact ``A0`` diagonal: column/row sums of
    ``E_ij = p_i^2 q_j^2 s_ij``."""
    p2 = p * p
    q2 = q * q
    col, row = api.psum(S.T @ p2), api.all_gather_rows(p2 * (S @ q2))
    return torch.cat([q2 * col, row])


class RefineCounts:
    """What the mixed-precision Newton solves did since the last
    ``reset()``: ``solves``, refinement ``rounds`` (one fp32 correction
    solve each), rounds ``reverted`` by the safeguard, and correction
    ``cycles`` summed over the rounds.  The refinement loop counts its
    rounds on the host (:meth:`add`); the blocked refinement
    (:class:`Refinement`) adds them to a tensor on its device
    (:meth:`on`) without a read.  A count sums both when it is read."""

    def __init__(self):
        self.totals: dict = {}
        self.reset()

    def reset(self) -> None:
        self.solves = 0
        self.host = [0, 0, 0]
        for t in self.totals.values():
            t.zero_()

    def add(self, rounds: int, reverted: int, cycles: int) -> None:
        for i, v in enumerate((rounds, reverted, cycles)):
            self.host[i] += v

    def on(self, device) -> torch.Tensor:
        """The ``(rounds, reverted, cycles)`` totals kept on ``device``."""
        t = self.totals.get(device)
        if t is None:
            t = self.totals[device] = torch.zeros(3, dtype=torch.int64,
                                                  device=device)
        return t

    def _count(self, i: int) -> int:
        return self.host[i] + sum(int(t[i]) for t in self.totals.values())

    rounds = property(lambda self: self._count(0))
    reverted = property(lambda self: self._count(1))
    cycles = property(lambda self: self._count(2))


refine_counts = RefineCounts()


def make_hybrid_amg_solver(p: torch.Tensor, q: torch.Tensor,
                           opts: AMGOptions, twogrid: bool = False,
                           solve_dtype=None, refine: int = 10,
                           exit_every: int = 1,
                           dist_mesh=None) -> NewtonSolver:
    """Newton solver through the hybrid AMG path (``inner_solver=4``).
    ``twogrid=True`` is the two-level variant of ``Hybrid_twogrid.m``:
    one coarse level solved by Jacobi-PCG capped at 100 iterations
    (``twogrid_bigph.m:98-99``), deliberately inexact.  With
    ``solve_dtype`` (``"float32"``) the hierarchy runs in that dtype and
    up to ``refine`` rounds of refinement bring the solution to the
    problem's precision (:func:`build_he_solver`).  ``exit_every`` is
    the read interval of every loop of the Newton solve (label
    propagation, MIS rounds, AMG iterations).  ``dist_mesh`` (the
    ``explicit_dist`` option) names the mesh of the transform
    (:func:`build_he_solver`) and turns ``fuse_deep`` off, as the JAX
    package does."""
    if twogrid:
        opts = dataclasses.replace(
            opts, max_levels=2, coarse_solver="pcg",
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))
    if dist_mesh is not None and opts.fuse_deep:
        opts = dataclasses.replace(opts, fuse_deep=False)

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        k_setup, k_solve = jr.split(key)
        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, k_setup, solve_dtype,
                                                refine, exit_every,
                                                dist_mesh)
        zeta, iters, rel = he_solve(rhs, k_solve)
        return NewtonSolveResult(zeta, iters, rel, ncomp, last)

    return solve


class Front(NamedTuple):
    """What a Newton solve builds before its cycles (:func:`newton_front`):
    the transform's ``E`` (this rank's rows), ``g`` and ``kdiag``, the
    similarity ``q0`` and the whole ``p``; the component ``labels``,
    ``nsp``, ``ncomp`` and ``last`` of :func:`_component_info`; with
    ``opts.bigph`` the hierarchy ``lv1``, ``dense`` and the deep matrix
    ``deep`` of :func:`otamg_torch.amg.hierarchy.setup_solve` (None
    otherwise); and ``graph``, the front's CUDA graph where it was
    replayed (its static inputs ``S``, ``tvec``, ``bk1``, ``tk``, ``p``,
    ``q`` and the draws are ``graph.inputs``), else None."""

    E: torch.Tensor
    g: torch.Tensor
    kdiag: torch.Tensor
    q0: torch.Tensor
    p: torch.Tensor
    labels: torch.Tensor
    nsp: torch.Tensor
    ncomp: torch.Tensor
    last: torch.Tensor
    lv1: object = None
    dense: tuple | None = None
    deep: torch.Tensor | None = None
    graph: Captured | None = None


# The Newton solve's front (newton_front), one graph per front_signature.
front_graphs = GraphCache()


def front_signature(inputs, opts: AMGOptions, lo, dist_mesh,
                    mesh=None) -> tuple:
    """The key of a captured front: the shapes, dtypes and devices of its
    inputs (``S``, ``tvec``, ``bk1``, ``tk``, ``p``, ``q`` and the
    setup's draws), the options, the solve dtype ``lo`` (the deflated
    cycle where it is below ``S``'s), whether the transform runs on an
    explicit mesh, and the live mesh (group, rank and size; None for no
    collective)."""
    where = (None if mesh is None
             else (mesh.group, mesh.rank, mesh.size))
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
            opts, lo, dist_mesh is not None, where)


def _front(S, tvec, bk1, tk, p, q, opts: AMGOptions, lo, draws,
           exit_every: int, dist_mesh) -> list:
    """:func:`newton_front`'s work from the setup's staged ``draws``, as
    one flat list of tensors: the first nine fields of :class:`Front`,
    then :func:`otamg_torch.amg.hierarchy.setup_flat`'s list with
    ``opts.bigph``.  On a card the whole ``E`` is gathered once under a
    mesh, for the components and the setup."""
    hi = S.dtype
    E, g, kdiag, _, q0 = _transform(S, tvec, bk1, tk, torch.zeros_like(tvec),
                                    p, q, dist_mesh)
    pf = api.all_gather_rows(p)   # the whole p for the duals
    E_all = None
    if E.is_cuda:
        E_all = api.all_gather_rows(E)
        with api.use_mesh(None):
            labels, nsp, ncomp, last = _component_info(E_all, kdiag)
    else:
        labels, nsp, ncomp, last = _component_info(E, kdiag, exit_every)
    out = [E, g, kdiag, q0, pf, labels, nsp, ncomp, last]
    if opts.bigph:
        # bk1*Q + K/tk equals Ae @ (component indicator) exactly: the
        # analytic form of the kernel-projection quantities.
        gk = bk1 * torch.cat([q * q, pf * pf]) + kdiag / tk
        out += setup_flat(E.to(lo), g.to(lo), 1.0 / tk, labels, nsp, opts,
                          draws, gk.to(lo), lo != hi,
                          None if E_all is None else E_all.to(lo))
    return out


def newton_front(S, tvec, bk1, tk, p, q, opts: AMGOptions, key,
                 solve_dtype=None, exit_every: int = 1,
                 dist_mesh=None) -> Front:
    """Everything :func:`build_he_solver` runs before its ``he_solve``:
    the transform (:func:`_transform`, on ``dist_mesh`` or the active
    mesh), the components (:func:`_component_info`; on a card one launch
    of the ``labels`` kernel) and, with ``opts.bigph``, the hierarchy and
    its deep matrix in ``solve_dtype`` (:func:`otamg_torch.amg.hierarchy.
    setup_solve`, its draws made from ``key`` beforehand).  Reads nothing
    on the host on a card.  With ``exit_every > 1`` and ``opts.bigph`` on
    a card the whole front is one CUDA graph (:data:`front_graphs`),
    captured at the first solve of its :func:`front_signature` and
    replayed for every later one, with a live mesh's collectives inside:
    the fields are then the graph's outputs, written anew by the next
    replay.  The loop driver and the CPU run the same code eagerly, with
    the same bits; ``exit_every`` is the CPU's label-propagation read
    interval."""
    lo = S.dtype if solve_dtype is None else getattr(torch, solve_dtype)
    draws = setup_draws(S, opts, key) if opts.bigph else None
    if exit_every > 1 and opts.bigph and S.is_cuda:
        mesh = api.live_mesh()
        # A Python number would be baked into the graph: an input instead.
        scalar = lambda x: x if isinstance(x, torch.Tensor) else _scalar(x, S)
        inputs = [S, tvec, scalar(bk1), scalar(tk), p, q, draws]

        def run(inputs):
            return _front(*inputs[:6], opts, lo, inputs[6], exit_every,
                          dist_mesh)

        blk = front_graphs.get(front_signature(inputs, opts, lo, dist_mesh,
                                               mesh), inputs, run, mesh)
        blk.load(inputs)
        blk.replay()
        front_graphs.replays += 1
        out = blk.outputs
    else:
        blk = None
        out = _front(S, tvec, bk1, tk, p, q, opts, lo, draws, exit_every,
                     dist_mesh)
    front = Front(*out[:9], graph=blk)
    if not opts.bigph:
        return front
    m, n = api.global_rows(S), S.shape[1]
    lv1, dense, deep = setup_unflat(
        out[9:], len(capacity_schedule(m, n + m, opts)))
    return front._replace(lv1=lv1, dense=dense, deep=deep)


def build_he_solver(S, tvec, bk1, tk, p, q, opts: AMGOptions, key,
                    solve_dtype=None, refine: int = 10, exit_every: int = 1,
                    dist_mesh=None):
    """Build the hierarchy once and return ``(he_solve, ncomp, last)``,
    where ``he_solve(rhs, key) -> (zeta, iters, rel)`` solves
    ``He zeta = rhs`` and may be called again against the same ``He``.

    With ``solve_dtype`` below the problem's dtype (the mixed path), the
    hierarchy is built from ``E``, ``g``, ``1/tk`` and the analytic
    ``gk`` cast once to it, and ``he_solve`` works in deflated
    coordinates ``u = Y a + w``: ``a`` is each near-singular component's
    kernel coordinate, solved exactly in the problem's precision from the
    1-D equation ``bk1 (xi^T Q xi) a = xi^T (f - Ae w)``, and ``w`` is
    kernel-free.  Up to ``refine`` rounds each take the true residual
    through the structured operator and add one correction solve of the
    deflated fp32 cycle; a round that does not lower the residual is
    reverted and ends the loop.  Unlike the JAX package, the correction
    solve's right-hand side is scaled by a power of two to unit norm.
    ``iters`` is the most correction cycles of any round, a 0-d int64
    tensor on the device.  ``exit_every`` is the read interval of the
    loops inside (:func:`otamg_torch.amg.hierarchy.amg_solve`).
    ``dist_mesh`` is the mesh of the transform (the active one by
    default).

    The rounds run in one of two ways, with the same result bit for bit.
    With ``exit_every == 1`` (the loop driver), a loop on the host: one
    read before the rounds and one after each, besides each correction
    solve's own (:func:`amg_solve`).  With ``exit_every > 1`` and a
    bigph hierarchy whose cycle reads nothing (the direct or fused
    coarse solve; not the two-grid PCG), the regions of
    :class:`Refinement`: one read a block of ``exit_every`` cycles and
    none of the rounds' own, on a card CUDA graphs over the front's
    buffers.  The non-bigph hierarchy and the two-grid cycle keep the
    loop on every driver.

    The transform, the components and the bigph hierarchy with its deep
    matrix are the front of :func:`newton_front`, which reads nothing on
    the host; with ``exit_every > 1`` on a card they are one CUDA graph
    replay, and every ``he_solve`` of this Newton system (Class 2 makes
    two) uses them."""
    hi = S.dtype
    lo = hi if solve_dtype is None else getattr(torch, solve_dtype)
    fr = newton_front(S, tvec, bk1, tk, p, q, opts, key, solve_dtype,
                      exit_every, dist_mesh)
    q0, labels, nsp = fr.q0, fr.labels, fr.nsp
    ncomp, last = fr.ncomp, fr.last
    p_rows, p = p, fr.p
    # amg_solve's options: the interval, named only for a blocked solve
    # (1 is the default), and the bigph setup's deep matrix.
    solve_kw = {} if exit_every == 1 else dict(exit_every=exit_every)
    if opts.bigph:
        lv1, dense = fr.lv1, fr.dense
        solve_kw["deep"] = fr.deep
    else:
        # Non-bigph mode (``Class_AMG.m:72``): assemble the dense Ae
        # (replicated, from the gathered E) and run the generic
        # weighted-Jacobi/MIS hierarchy.
        E = api.all_gather_rows(fr.E)
        n, m = q.shape[0], p.shape[0]
        Ae = torch.zeros(n + m, n + m, dtype=lo, device=E.device)
        Ae[:n, n:] = E.T
        Ae[n:, :n] = E
        Ae = (Ae * torch.as_tensor(-1.0 / tk, dtype=lo, device=E.device)
              + torch.diag(fr.g.to(lo)))
        lv1, dense = setup_hierarchy_generic(Ae, opts, key, labels, nsp)

    def draw_guess(f, kguess):
        # Random initial guess scaled as the reference's bk1*tk*rand
        # (Hybrid_AMG.m:69), drawn in the solve dtype.
        return (bk1 * tk) * jr.uniform(kguess, f.shape, lo, f.device)

    if lo == hi:
        def he_solve(rhs, kguess):
            f = q0 * rhs
            r = amg_solve(lv1, dense, f, draw_guess(f, kguess), opts,
                          **solve_kw)
            return q0 * r.x, r.iters, r.rel_res

        return he_solve, ncomp, last

    if (exit_every > 1 and opts.bigph
            and reads_nothing(lv1, dense, fr.deep,
                              opts.coarse_solver == "direct")):
        return (Refinement(fr, (S, bk1, tk, p_rows, q), opts, refine,
                           exit_every, lo), ncomp, last)

    km = KernelModes(fr, S, bk1, tk, p_rows, q)
    k = types.SimpleNamespace()
    km.setup(k)
    zeros_lo = torch.zeros(tvec.shape[0], dtype=lo, device=S.device)

    def he_solve(rhs, kguess):
        refine_counts.solves += 1
        km.start(k, rhs)
        w = draw_guess(k.f, kguess).to(hi)
        rel = torch.linalg.vector_norm(km.residual(k, w)[2]) / k.safe_nf
        rounds, iters = 0, 0
        go = fetch(rel > opts.retol)
        while go and rounds < refine:
            wd, _, r = km.residual(k, w)
            scale = unit_scale(r)
            cor = amg_solve(lv1, dense, (r * scale).to(lo), zeros_lo, opts,
                            deflated=True, **solve_kw)
            w2 = correct(wd, cor.x, scale)
            rel2 = torch.linalg.vector_norm(km.residual(k, w2)[2]) / k.safe_nf
            ok, go, cycles = fetch(torch.stack([
                (rel2 < rel).to(torch.int64),
                (rel2 > opts.retol).to(torch.int64), cor.iters]))
            iters = max(iters, cycles)
            refine_counts.add(1, 1 - ok, cycles)
            cond_counts.add(REFINE_CYCLES, cycles)
            if ok:
                w, rel, rounds = w2, rel2, rounds + 1
            else:
                # Safeguard: a correction that does not lower the true
                # residual is reverted and ends the loop.
                w, rounds = wd, refine
        wd, a, _ = km.residual(k, w)
        return (q0 * (wd + a),
                torch.full((), iters, dtype=torch.int64, device=rhs.device),
                rel)

    return he_solve, ncomp, last


def unit_scale(r: torch.Tensor) -> torch.Tensor:
    """The power of two that scales ``r`` to unit norm (1 for a zero
    ``r``).  The correction solve sees ``r`` so scaled: the same fp32
    roundings, but no squares in its norms that underflow (a residual of
    1e-20 is common at small bk1, and a backend that flushes subnormals
    would see a zero residual there)."""
    nr = torch.linalg.vector_norm(r)
    return torch.exp2(-torch.round(torch.log2(torch.where(nr > 0, nr, 1.0))))


def correct(wd: torch.Tensor, x: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """A refinement round's new iterate: the deflated iterate ``wd`` plus
    the correction solve's ``x`` scaled back by ``scale``.  Both
    refinements form it here, so a test can put in a bad correction."""
    return wd + x.to(wd.dtype) / scale


class KernelModes:
    """The mixed Newton solve's algebra in the problem's precision, on
    the tensors of its front ``fr`` and the system's ``S``, ``bk1``,
    ``tk``, this rank's ``p_rows`` and ``q``.  Its quantities are kept on
    ``k``, a namespace or a region's :class:`~otamg_torch.graphs.State`:
    :meth:`setup` sets the Newton system's, :meth:`start` a right-hand
    side's."""

    def __init__(self, fr: Front, S, bk1, tk, p_rows, q):
        self.fr, self.S, self.bk1, self.tk = fr, S, bk1, tk
        self.p_rows, self.q = p_rows, q
        self.n, self.N = q.shape[0], fr.kdiag.shape[0]

    def setup(self, k) -> None:
        """The exact ``Ae`` diagonal ``ghi`` and the kernel-mode
        quantities; the component labels are fixed for the Newton solve,
        so one plan of them serves every sum."""
        fr, bk1, q, N = self.fr, self.bk1, self.q, self.N
        k.qp2 = torch.cat([q * q, fr.p * fr.p])
        k.ghi = bk1 * k.qp2 + (fr.kdiag + _a0diag_hi(self.S, self.p_rows, q)
                               ) / self.tk
        k.p2, k.q2 = self.p_rows * self.p_rows, q * q
        k.nsp_f = fr.nsp.to(self.S.dtype)
        for name, t in zip(SegmentPlan._fields, segment_plan(fr.labels, N)):
            setattr(k, "plan_" + name, t)
        k.qsum = self.segsum(k, k.qp2 * k.nsp_f)
        k.den = bk1 * k.qsum
        k.safe_den = torch.where(k.den > 0, k.den, 1.0)

    def start(self, k, rhs) -> None:
        """``f``, its safe norm and its sums over the components."""
        k.f = self.fr.q0 * rhs
        nf = torch.linalg.vector_norm(k.f)
        k.safe_nf = torch.where(nf > 0, nf, 1.0)
        k.segf = self.segsum(k, k.f * k.nsp_f)

    def segsum(self, k, x):
        plan = SegmentPlan(*(getattr(k, "plan_" + name)
                             for name in SegmentPlan._fields))
        return segment_sum(x, self.fr.labels, self.N, plan)

    def ae_hi(self, k, v):
        """``Ae v`` through the structured operator: two masked GEMVs."""
        S, n = self.S, self.n
        ev2 = k.q2 * api.psum(S.T @ (k.p2 * api.local_rows(v[n:])))
        ev1 = api.all_gather_rows(k.p2 * (S @ (k.q2 * v[:n])))
        return k.ghi * v - torch.cat([ev2, ev1]) / self.tk

    def deflate(self, k, w):
        labels, nsp = self.fr.labels, self.fr.nsp
        mean = self.segsum(k, k.qp2 * w * k.nsp_f)
        mean = torch.where(k.qsum > 0,
                           mean / torch.where(k.qsum > 0, k.qsum, 1.0), 0.0)
        return w - torch.where(nsp, mean[labels], 0.0) * k.nsp_f

    def residual(self, k, w):
        """``(wd, a, r)``: ``w`` deflated, its kernel coordinates ``a(wd)``
        per node, and ``r = f - bk1 Q Y a - Ae wd``; no intermediate grows
        with ``a`` as ``bk1 -> 0``."""
        labels, nsp, bk1 = self.fr.labels, self.fr.nsp, self.bk1
        wd = self.deflate(k, w)
        segw = self.segsum(k, k.qp2 * wd * k.nsp_f)
        a = torch.where(k.den > 0, (k.segf - bk1 * segw) / k.safe_den, 0.0)
        a = torch.where(nsp, a[labels], 0.0)
        return wd, a, k.f - bk1 * k.qp2 * a * k.nsp_f - self.ae_hi(k, wd)


# The blocked refinement's regions, one graph per (front graph, refine,
# exit_every, region).
refine_graphs = GraphCache()

# What the block carries from step to step: the rounds' state, and what
# a round's start sets (its iterate and scale, and the correction
# solve's b, safe0 and amg_solve state).
_ROUND = ("w", "rel", "rounds", "iters", "go_r")
_START = ("wd", "scale", "b", "safe0", "x", "cr", "crel", "it", "go_c")


class Refinement:
    """The refinement rounds of a mixed ``he_solve`` (:func:`build_he_solver`)
    on the blocked drivers, as two regions over a
    :class:`~otamg_torch.graphs.State` that read nothing on the host:

    * ``head``: the Newton system's kernel-mode quantities
      (:class:`KernelModes`), the right-hand side's, the guess's
      residual, and the first round's start: the residual scaled to unit
      norm (:func:`unit_scale`) and the correction solve's first state
      from a zero guess, as :func:`otamg_torch.amg.hierarchy.amg_solve`
      makes it;
    * ``block``: ``exit_every`` steps, each one cycle of the correction
      solve where it goes on (amg_solve's step) and, where it has
      stopped and the rounds go on, the round's end, accepted or
      reverted as the loop does it, and the next round's start, each
      under :func:`otamg_torch.graphs.when` (on a card conditional
      nodes: a step after the rounds' exit runs nothing); then the
      solution at the iterate so far and the flags of the correction and
      the rounds.

    ``he_solve`` reads the flags after each block: one read a block,
    none of the rounds' own, and the rounds run on inside a block.  The
    result is the loop's bit for bit, its rounds, reverts and cycles
    counted on the device (:data:`refine_counts`).  On a card each
    region is one CUDA graph of :data:`refine_graphs`, captured against
    the buffers of the front's CUDA graph in place (the front is not
    copied) and a state of its own, keyed by the front's graph,
    ``refine`` and ``exit_every``; elsewhere the regions run as they
    are.  ``he_solve`` returns copies: the next solve rewrites the
    state."""

    def __init__(self, fr: Front, args, opts: AMGOptions, refine: int,
                 exit_every: int, lo):
        S, bk1, tk, p_rows, q = args
        self.captured = fr.graph is not None
        if self.captured:
            S, _, bk1, tk, p_rows, q = fr.graph.inputs[:6]
        self.opts, self.refine, self.exit_every = opts, refine, exit_every
        self.lo, self.fr, self.bk1, self.tk = lo, fr, bk1, tk
        self.km = KernelModes(fr, S, bk1, tk, p_rows, q)
        self.mesh = api.live_mesh()
        self.sig = (fr.graph, refine, exit_every)
        self.st = (refine_graphs.state(self.sig, lambda: State(S.device))
                   if self.captured else State(S.device))
        self.counts = refine_counts.on(S.device)
        self.cycle = _make_solve_cycle(_lvl_size(fr.lv1), len(fr.dense),
                                       opts, True)
        self.mv0 = _level0_ops(fr.lv1)[0]
        self.retol_eff = solve_retol(opts, lo)

    def __call__(self, rhs, kguess):
        refine_counts.solves += 1
        st = self.st
        u = jr.uniform(kguess, rhs.shape, self.lo)
        st.rhs = rhs
        st.u = u.pin_memory() if self.captured else u
        self.run("head", self.head)
        while True:
            self.run("block", self.block)
            if not any(fetch(st.flags)):
                break
        return st.zeta.clone(), st.iters.clone(), st.rel.clone()

    def run(self, name: str, fn) -> None:
        if self.captured:
            run_region(refine_graphs, (self.sig, name), fn, self.st,
                       self.mesh, keep=(self.counts,))
        else:
            fn(self.st)

    def begin(self, st, wd, r) -> list:
        """A round's start from its deflated iterate ``wd`` and residual
        ``r``: the values of :data:`_START`."""
        scale = unit_scale(r)
        b = (r * scale).to(self.lo)
        (x, cr, crel, it, go), safe0 = solve_start(self.fr.lv1, b,
                                                   torch.zeros_like(b),
                                                   st.az)
        return [wd, scale, b, safe0, x, cr, crel, it, go]

    def head(self, st) -> None:
        km, opts = self.km, self.opts
        km.setup(st)
        km.start(st, st.rhs)
        # The guess as the loop draws it (Hybrid_AMG.m:69).
        st.w = ((self.bk1 * self.tk) * st.u).to(st.f.dtype)
        wd, _, r = km.residual(st, st.w)
        st.rel = torch.linalg.vector_norm(r) / st.safe_nf
        st.rounds = st.iters = torch.zeros((), dtype=torch.int64,
                                           device=r.device)
        go = ((st.rel > opts.retol) if self.refine > 0
              else torch.zeros((), dtype=torch.bool, device=r.device))
        st.go_r = go
        # A times the correction solve's zero guess.
        st.az = self.mv0(self.fr.lv1, torch.zeros_like(st.u))
        for name, v in zip(_START, self.begin(st, wd, r)):
            setattr(st, name, v & go if name == "go_c" else v)

    def step(self, st) -> None:
        """One step of the block on the state's buffers in place, where
        the correction or the rounds go on (:func:`when`; in a captured
        block conditional nodes): the correction cycle where it goes on
        and then, where it has stopped and the rounds go on, the round's
        end and the next round's start (:meth:`end_round`)."""
        fr, opts = self.fr, self.opts
        cycle = [st.x, st.cr, st.crel, st.it, st.go_c]
        outs = [*(getattr(st, name) for name in _ROUND + _START),
                self.counts]

        def advance():
            _solve_step(self.cycle, self.mv0, fr.lv1, fr.dense, fr.deep,
                        st.b, st.safe0, self.retol_eff, opts.maxit, cycle,
                        count=(AMG_CYCLES, REFINE_CYCLES))
            when(st.go_r & ~st.go_c, lambda: self.end_round(st), outs)

        when(st.go_c | st.go_r, advance, outs)

    def end_round(self, st) -> None:
        """A round's end, accepted or reverted as the loop does it, with
        its counts, and where the rounds go on the next round's start."""
        opts, refine = self.opts, self.refine
        w2 = correct(st.wd, st.x, st.scale)
        wd2, _, r2 = self.km.residual(st, w2)
        rel2 = torch.linalg.vector_norm(r2) / st.safe_nf
        ok = rel2 < st.rel
        rounds = torch.where(ok, st.rounds + 1, refine)
        self.counts.add_(torch.stack([torch.ones_like(st.it),
                                      (~ok).to(torch.int64), st.it]))
        st.iters = torch.maximum(st.iters, st.it)
        st.w = torch.where(ok, w2, st.wd)
        st.rel = torch.where(ok, rel2, st.rel)
        st.rounds = rounds
        st.go_r = ok & (rel2 > opts.retol) & (rounds < refine)

        def start():
            for name, new in zip(_START, self.begin(st, wd2, r2)):
                setattr(st, name, new)

        when(st.go_r, start, [getattr(st, name) for name in _START])

    def block(self, st) -> None:
        for _ in range(self.exit_every):
            self.step(st)
        wd, a, _ = self.km.residual(st, st.w)
        st.zeta = self.fr.q0 * (wd + a)
        st.flags = torch.stack([st.go_c, st.go_r])


def make_aug_pcg_solver(p: torch.Tensor, q: torch.Tensor,
                        opts: PCGOptions) -> NewtonSolver:
    """Nullspace-augmented PCG (``aug_PCG.m``, ``inner_solver=3``) on the
    bordered system ``[[Y^T QK Y, Y^T QK], [QK Y, Ae]]``, ``Y`` the
    component indicator matrix: matrix-free through segment sums over
    the component labels, the coarse unknowns carried at their
    component-root positions of an N-padded vector (identity on the
    other positions)."""
    n = q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        E, g, kdiag, f, q0 = _transform(S, tvec, bk1, tk, rhs, p, q)
        N = g.shape[0]
        labels, _, ncomp, _ = _component_info(E, kdiag)
        roots = labels == torch.arange(N, device=labels.device)
        plan = segment_plan(labels, N)  # every PCG iteration's sum
        pf = api.all_gather_rows(p)
        qk = bk1 * torch.cat([q * q, pf * pf]) + kdiag / tk  # bk1 Q + K/tk
        inv_tk = 1.0 / tk

        def ae_mv(v):
            v1, v2 = v[:n], v[n:]
            Etv2, Ev1 = api.row_rmatvec(E, v2), api.row_matvec(E, v1)
            return torch.cat([g[:n] * v1 - inv_tk * Etv2,
                              g[n:] * v2 - inv_tk * Ev1])

        def aug_mv(x):
            U, u = x[:N], x[N:]
            Yu = U[labels]
            top = segment_sum(qk * (Yu + u), labels, N, plan)
            top = torch.where(roots, top, U)
            return torch.cat([top, qk * Yu + ae_mv(u)])

        diag_aug = torch.cat([torch.where(
            roots, segment_sum(qk, labels, N, plan), 1.0), g])
        aug_f = torch.cat([torch.where(
            roots, segment_sum(f, labels, N, plan), 0.0), f])
        r = pcg(aug_mv, aug_f, lambda v: v / diag_aug,
                retol=opts.retol, maxit=opts.maxit)
        U, u = r.x[:N], r.x[N:]
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(q0 * (U[labels] + u), r.iters, r.res,
                                 ncomp, zero)

    return solve


def refuse_mesh(what: str) -> None:
    """Raise under an active mesh: ``what`` needs the whole plan."""
    if api.current_mesh() is not None:
        raise NotImplementedError(f"{what} assembles the whole Jacobian "
                                  "and does not run on a row-sharded "
                                  "problem")


def dense_asat(S: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """``H0 = A diag(s) A^T`` assembled as an ``(n + m, n + m)`` matrix
    (``ASAt.m``)."""
    d1, d2 = op.asat_diags(S, p, q)
    off = (q[:, None] * S.T) * p[None, :]   # diag(q) Y^T diag(p), (n, m)
    return torch.cat([torch.cat([torch.diag(d1), off], 1),
                      torch.cat([off.T, torch.diag(d2)], 1)])


def spd_solve(J: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``J^{-1} rhs`` through a Cholesky factorization (what
    ``jax.scipy.linalg.solve(..., assume_a="pos")`` does)."""
    L = torch.linalg.cholesky(J)
    return torch.cholesky_solve(rhs[:, None], L)[:, 0]


def make_direct_solver(p: torch.Tensor, q: torch.Tensor) -> NewtonSolver:
    """Dense direct solve of ``Jk zeta = rhs`` (``inner_solver=1``,
    ``Class1/APD_SsN_Class1.m:143-145``): materializes the (n+m)^2
    Jacobian; an oracle for small systems."""
    N = p.shape[0] + q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        refuse_mesh("the dense direct Newton solver")
        I = torch.eye(N, dtype=S.dtype, device=S.device)
        Jk = bk1 * I + (torch.diag(tvec) + dense_asat(S, p, q)) / tk
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(spd_solve(Jk, rhs), 1,
                                 torch.zeros((), dtype=S.dtype,
                                             device=S.device), zero, zero)

    return solve
