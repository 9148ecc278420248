"""AMG hierarchy: setup, cycles and the classical solve loop (port of
``otamg/amg/hierarchy.py``).

* **Level 1 is structured.**  The fine operator of the Newton system is
  ``Ae = diag(g) - E/tk`` on the bipartite node set (q-side then p-side),
  with ``E`` the ``(m, n)`` masked-dense edge-weight matrix; matvecs, the
  block Gauss-Seidel smoother and the level-1 ideal interpolation are
  GEMVs/GEMMs on ``E``.  The generic hierarchy instead starts from a dense
  level or, for a sparse operator, a :class:`CSRLevel` whose matvecs run
  the ELL SpMV kernel.  The sparse-setup hierarchy
  (:func:`setup_hierarchy_sparse`) adds :class:`AggCSRLevel` levels
  below it, whose matvecs run the same kernel.
* **Coarse levels are capacity-padded dense.**  Each level has a static
  capacity with an activity mask, as in the JAX package, so the two
  packages' level arrays compare shape for shape.
* **One hierarchy for all graph components**, with per-component
  kernel-projected smoothing through segment sums over component labels.
  Every level carries a :class:`~otamg_torch.sparse.segment.SegmentPlan`
  of its labels, made once at setup, so each sum of a sweep, a deflation
  or a coarse solve is one kernel launch with no sort (the bipartite
  level's is a pair plan: one launch sums both halves).
* **Cycles run off a visit tape**, the unrolled V/W/F recursion, executed
  here by a Python loop; ``fuse_deep`` replaces the tape below level 0 by
  one dense matrix per hierarchy.

* **The deflated cycle** (``deflated=True``) serves the correction
  solves of the mixed-precision Newton solver: instead of solving for the
  kernel coordinate of each near-singular component, every sweep and the
  coarse solve project it out, and the f64 algebra around the solve
  (``otamg_torch.hybrid.solver.build_he_solver``) handles it exactly.

The row-sharded fine level (``HaloCSRLevel``) waits for the port of
``otamg.dist``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from otamg_torch import random as jr
from otamg_torch.amg.graph import mis_dense, segment_sum, strength_dense
from otamg_torch.config import AMGOptions, Cycle
from otamg_torch.device import fetch
from otamg_torch.krylov.pcg import pcg
from otamg_torch.sparse.kernels import ell_spmv
from otamg_torch.sparse.segment import SegmentPlan, segment_plan, segment_sum2


class BipartiteLevel(NamedTuple):
    """Finest level: ``A = diag(g) - E/tk`` over n q-side + m p-side nodes."""

    E: torch.Tensor        # (m, n) nonnegative edge weights
    g: torch.Tensor        # (n + m,) diagonal
    inv_tk: torch.Tensor   # () 1/tk
    W: torch.Tensor        # (n, m) ideal-interpolation block to level 2
    labels: torch.Tensor   # (n + m,) int64 component labels
    nsp: torch.Tensor      # (n + m,) near-singular-component mask
    Axi: torch.Tensor      # (n + m,) A @ 1 (kernel-projected smoothing)
    xx: torch.Tensor       # (n + m,) per-node xi^T A xi of its component
    Exi1: torch.Tensor     # (m,) E @ nsp[:n], carried by the fused smoother
    Etxi2: torch.Tensor    # (n,) E^T @ nsp[n:]
    plan: SegmentPlan      # pair plan of labels (split n), for segment_sum2


class DenseLevel(NamedTuple):
    A: torch.Tensor        # (c, c) padded dense operator (identity padding)
    active: torch.Tensor   # (c,) bool
    P: torch.Tensor        # (c_prev, c) prolongation from previous level
    labels: torch.Tensor   # (c,) component labels (original fine node ids)
    nsp: torch.Tensor      # (c,) bool
    Axi: torch.Tensor      # (c,)
    xx: torch.Tensor       # (c,)
    evecs: torch.Tensor    # (c, c) eigenvectors of A, coarsest level only
    #                        ((0, 0) elsewhere)
    einv: torch.Tensor     # (c,) filtered inverse eigenvalues: 1/lambda_i
    #                        where lambda_i > 4 eps lambda_max, else 0 (see
    #                        otamg.amg.hierarchy.DenseLevel for why an
    #                        exact coarse solve is unstable)
    plan: SegmentPlan      # plan of labels into the fine level's N slots


class CSRLevel(NamedTuple):
    """Sparse fine level of the generic hierarchy: the solve-phase
    matvecs run the ELL SpMV kernel, setup densifies once."""

    ell_cols: torch.Tensor  # (N, row_cap) int32 padded column indices
    ell_vals: torch.Tensor  # (N, row_cap) padded values
    dg: torch.Tensor        # (N,) diagonal of A
    labels: torch.Tensor    # (N,) component labels
    nsp: torch.Tensor       # (N,) near-singular mask
    Axi: torch.Tensor       # (N,)
    xx: torch.Tensor        # (N,)
    plan: SegmentPlan       # plan of labels into the fine level's N slots


class AggCSRLevel(NamedTuple):
    """Sparse level of the sparse-setup hierarchy, made by consecutive-
    block aggregation of its parent (:func:`setup_hierarchy_sparse`): the
    fields of :class:`CSRLevel` plus the aggregation factor ``agg`` of the
    transfer from the parent.  Restriction is a block row-sum and
    prolongation a repeat, so no interpolation matrix is formed."""

    ell_cols: torch.Tensor  # (N, row_cap) int32 padded column indices
    ell_vals: torch.Tensor  # (N, row_cap) padded values
    dg: torch.Tensor        # (N,) diagonal of A
    labels: torch.Tensor    # (N,) component labels
    nsp: torch.Tensor       # (N,) near-singular mask
    Axi: torch.Tensor       # (N,)
    xx: torch.Tensor        # (N,)
    plan: SegmentPlan       # plan of labels into the fine level's N slots
    agg: int                # aggregation factor from the parent level


def _leaves(lv) -> list:
    """A level's tensors in field order, its plan's spliced in."""
    return [t for f in lv for t in (f if isinstance(f, SegmentPlan) else (f,))]


def _from_leaves(cls, leaves):
    """The level of type ``cls`` whose :func:`_leaves` are ``leaves``."""
    it = iter(leaves)
    return cls(*(SegmentPlan(*(next(it) for _ in SegmentPlan._fields))
                 if f == "plan" else next(it) for f in cls._fields))


def _lvl_size(lv) -> int:
    """Node count of a level object of any type."""
    if isinstance(lv, BipartiteLevel):
        return lv.g.shape[0]
    if isinstance(lv, (CSRLevel, AggCSRLevel)):
        return lv.dg.shape[0]
    return lv.A.shape[0]


# ---------------------------------------------------------------------------
# Level operations
# ---------------------------------------------------------------------------


def csr_matvec(lv: CSRLevel | AggCSRLevel, v: torch.Tensor) -> torch.Tensor:
    """Sparse-level SpMV; on a card every call launches the ELL kernel,
    whatever the dtype or size."""
    return ell_spmv(lv.ell_cols, lv.ell_vals, v)


def csr_smooth_apply(lv: CSRLevel, r: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    """Weighted Jacobi, as :func:`dense_smooth_apply`."""
    del transpose
    return 0.5 * r / lv.dg


def bip_matvec(lv: BipartiteLevel, v: torch.Tensor) -> torch.Tensor:
    n = lv.W.shape[0]
    v1, v2 = v[:n], v[n:]
    out1 = lv.g[:n] * v1 - lv.inv_tk * (lv.E.T @ v2)
    out2 = lv.g[n:] * v2 - lv.inv_tk * (lv.E @ v1)
    return torch.cat([out1, out2])


def bip_smooth_apply(lv: BipartiteLevel, r: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    """Block Gauss-Seidel ``R^{-1}`` (or its transpose) for the bigraph
    split (``Class_AMG.m:48-59``)."""
    n = lv.W.shape[0]
    r1, r2 = r[:n], r[n:]
    g1, g2 = lv.g[:n], lv.g[n:]
    if not transpose:
        e1 = r1 / g1
        e2 = (r2 + lv.inv_tk * (lv.E @ e1)) / g2
    else:
        e2 = r2 / g2
        e1 = (r1 + lv.inv_tk * (lv.E.T @ e2)) / g1
    return torch.cat([e1, e2])


def dense_matvec(lv: DenseLevel, v: torch.Tensor) -> torch.Tensor:
    return lv.A @ v


def dense_smooth_apply(lv: DenseLevel, r: torch.Tensor,
                       transpose: bool) -> torch.Tensor:
    """Weighted Jacobi ``R^{-1} = 0.5 diag(A)^{-1}``
    (``Class_AMG.m:72,84``; symmetric)."""
    del transpose
    return 0.5 * r / torch.diagonal(lv.A)


def _level0_ops(lv):
    """(matvec, smooth_apply) pair for a level object of any type."""
    if isinstance(lv, BipartiteLevel):
        return bip_matvec, bip_smooth_apply
    if isinstance(lv, (CSRLevel, AggCSRLevel)):
        return csr_matvec, csr_smooth_apply
    return dense_matvec, dense_smooth_apply


def _deflate(e, xi, lv, safe_cnt, nseg: int):
    """``e`` minus its mean over every near-singular component of the
    level ``lv``."""
    mean = segment_sum(e * xi, lv.labels, nseg, lv.plan) / safe_cnt
    return e - xi * torch.where(lv.nsp, mean[lv.labels], 0.0)


def _projected_smooth(matvec, smooth_apply, lv, e, r, smoth_it: int,
                      transpose: bool, nseg: int, deflated: bool = False):
    """``smoth_it`` sweeps of per-component kernel-projected smoothing
    (generalizes ``MG_Vcycle.m:14-24``): each sweep corrects the
    residual's mean over every near-singular component exactly along the
    component's constant vector; other components get the plain sweep
    ``e += R (r - A e)``.

    ``deflated=True`` (the mixed-precision correction solves) projects
    the component mean out after every plain sweep instead of solving for
    it: in fp32 the coarse matrices carry roundoff of ~eps |A| in their
    kernel-mode curvature, which at small ``bk1`` dwarfs the true
    curvature, so a solved kernel coordinate would grow from cycle to
    cycle."""
    xi = lv.nsp.to(r.dtype)
    if deflated:
        cnt = segment_sum(xi, lv.labels, nseg, lv.plan)
        safe_cnt = torch.where(cnt > 0, cnt, 1.0)
        for _ in range(smoth_it):
            e = e + smooth_apply(lv, r - matvec(lv, e), transpose)
            e = _deflate(e, xi, lv, safe_cnt, nseg)
        return e
    safe_xx = torch.where(torch.abs(lv.xx) > 0, lv.xx, 1.0)
    for _ in range(smoth_it):
        g = r - matvec(lv, e)
        xig = segment_sum(g * xi, lv.labels, nseg, lv.plan)
        coef = torch.where(lv.nsp, xig[lv.labels] / safe_xx, 0.0)
        e = e + (xi * coef + smooth_apply(lv, g - lv.Axi * coef, transpose))
    return e


def _projected_smooth_bip(lv: BipartiteLevel, e, r, smoth_it: int,
                          transpose: bool, nseg: int, deflated: bool,
                          e_is_zero: bool):
    """Fused form of :func:`_projected_smooth` for the bipartite fine
    level, the solver's hot loop.  The edge products ``u = E e1`` and
    ``w = E^T e2`` are carried across sweeps and updated from each
    sweep's corrections, so a sweep does exactly the two directed
    products its Gauss-Seidel order forces.  ``e_is_zero`` marks the
    pre-smoothing entry, where the carried products start at zero.
    ``deflated`` projects each component mean out after the sweep, and
    the carried products take the projection through ``Exi1``/``Etxi2``
    (``E`` has no edge across components).  Each per-component sum over
    the two halves is one :func:`segment_sum2` over the level's pair
    plan."""
    n = lv.W.shape[0]
    m = lv.E.shape[0]
    itk = lv.inv_tk
    g1d, g2d = lv.g[:n], lv.g[n:]
    r1, r2 = r[:n], r[n:]
    lab1, lab2 = lv.labels[:n], lv.labels[n:]
    nsp1, nsp2 = lv.nsp[:n], lv.nsp[n:]
    xi1 = nsp1.to(r.dtype)
    xi2 = nsp2.to(r.dtype)
    if e_is_zero:
        e1 = torch.zeros(n, dtype=r.dtype, device=r.device)
        e2 = torch.zeros(m, dtype=r.dtype, device=r.device)
        u = torch.zeros(m, dtype=r.dtype, device=r.device)
        w = torch.zeros(n, dtype=r.dtype, device=r.device)
    else:
        e1, e2 = e[:n], e[n:]
        u = lv.E @ e1
        w = lv.E.T @ e2

    def directed(gp1, gp2):
        """One Gauss-Seidel block sweep: ``(d1, d2, E d1, E^T d2)``."""
        if not transpose:
            d1 = gp1 / g1d
            t = lv.E @ d1
            d2 = (gp2 + itk * t) / g2d
            tw = lv.E.T @ d2
        else:
            d2 = gp2 / g2d
            tw = lv.E.T @ d2
            d1 = (gp1 + itk * tw) / g1d
            t = lv.E @ d1
        return d1, d2, t, tw

    if deflated:
        cnt = segment_sum2(xi1, xi2, lv.labels, nseg, lv.plan)
        safe_cnt = torch.where(cnt > 0, cnt, 1.0)
        for _ in range(smoth_it):
            d1, d2, t, tw = directed(r1 - g1d * e1 + itk * w,
                                     r2 - g2d * e2 + itk * u)
            e1, e2 = e1 + d1, e2 + d2
            mean = segment_sum2(e1 * xi1, e2 * xi2, lv.labels, nseg,
                                lv.plan) / safe_cnt
            m1 = torch.where(nsp1, mean[lab1], 0.0)
            m2 = torch.where(nsp2, mean[lab2], 0.0)
            e1, e2 = e1 - xi1 * m1, e2 - xi2 * m2
            u = u + t - m2 * lv.Exi1
            w = w + tw - m1 * lv.Etxi2
        return torch.cat([e1, e2])
    xx1, xx2 = lv.xx[:n], lv.xx[n:]
    sxx1 = torch.where(torch.abs(xx1) > 0, xx1, 1.0)
    sxx2 = torch.where(torch.abs(xx2) > 0, xx2, 1.0)
    Axi1, Axi2 = lv.Axi[:n], lv.Axi[n:]
    for _ in range(smoth_it):
        gg1 = r1 - g1d * e1 + itk * w
        gg2 = r2 - g2d * e2 + itk * u
        xig = segment_sum2(gg1 * xi1, gg2 * xi2, lv.labels, nseg, lv.plan)
        c1 = torch.where(nsp1, xig[lab1] / sxx1, 0.0)
        c2 = torch.where(nsp2, xig[lab2] / sxx2, 0.0)
        d1, d2, t, tw = directed(gg1 - Axi1 * c1, gg2 - Axi2 * c2)
        e1 = e1 + xi1 * c1 + d1
        e2 = e2 + xi2 * c2 + d2
        u = u + c2 * lv.Exi1 + t
        w = w + c1 * lv.Etxi2 + tw
    return torch.cat([e1, e2])


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _coarse_target(nfine: int) -> int:
    """Reference depth rule (``Class_AMG.m:76``)."""
    return 1 + int(math.floor(nfine ** (1.0 / 3.0)))


def capacity_schedule(m: int, nfine: int, opts: AMGOptions) -> list[int]:
    """Static per-level capacities of the dense levels (level 2 is exactly
    the p-side size ``m``; deeper levels shrink by ``coarsen_ratio``)."""
    caps = [m]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(nfine))
    while caps[-1] > target and len(caps) < opts.max_levels - 1:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    return caps


def setup_hierarchy(E, g, inv_tk, labels, nsp, opts: AMGOptions,
                    key: torch.Tensor, gk=None, exit_every: int = 1):
    """Build the full hierarchy for ``Ae = diag(g) - E/tk``
    (``Class_AMG.m:41-85`` with the level-1 bigraph ideal interpolation
    of ``transfer.m:19-25``).  ``gk`` is the non-Laplacian part of the
    diagonal, ``bk1 Q + K/tk``, from which the kernel-projection
    quantities are built without cancellation; without it a matvec
    evaluates them.  ``exit_every`` is the MIS rounds' read interval
    (:func:`otamg_torch.amg.graph.mis_dense`)."""
    m, n = E.shape
    N = n + m
    dtype = E.dtype
    nseg = N
    inv_tk = torch.as_tensor(inv_tk, dtype=dtype, device=E.device)

    # level 1: ideal interpolation W = -Aff^{-1} Afc = diag(1/g1) E^T/tk
    g1 = g[:n]
    W = (E.T / g1[:, None]) * inv_tk
    # isnsp row normalization (transfer.m:22-24), relative guard.
    rowsum = W.sum(dim=1)
    norm_mask = nsp[:n] & (torch.abs(rowsum) > 0.01)
    W = torch.where(norm_mask[:, None],
                    W / torch.where(norm_mask, rowsum, 1.0)[:, None], W)
    # Kernel-projection validity: every nsp q-row whose component
    # persists on the p-side must sum to 1 after normalization.
    pcount = segment_sum(torch.ones(m, dtype=torch.int64, device=E.device),
                         labels[n:], nseg)
    relevant = nsp[:n] & (pcount[labels[:n]] > 0)
    defect1 = torch.where(relevant, torch.abs(W.sum(dim=1) - 1.0),
                          0.0).amax()
    ok = defect1 < 0.1

    # Fused-smoother projection products E @ xi, E^T @ xi.
    xi1 = nsp[:n].to(dtype)
    xi2 = nsp[n:].to(dtype)
    ones = torch.ones(N, dtype=dtype, device=E.device)
    lv1 = BipartiteLevel(E, g, inv_tk, W, labels, nsp, torch.zeros_like(ones),
                         ones, E @ xi1, E.T @ xi2,
                         segment_plan(labels, nseg, split=n))
    if gk is None:
        Axi1 = bip_matvec(lv1, ones)
        xxseg = segment_sum(Axi1, labels, nseg)
        axi2 = None
    else:
        Axi1 = gk.to(dtype)
        xxseg = segment_sum(Axi1, labels, nseg)
        # Exact restriction of Axi through P = [W; I].
        axi2 = W.T @ Axi1[:n] + Axi1[n:]
    lv1 = lv1._replace(Axi=Axi1, xx=xxseg[labels])

    # level 2: Galerkin P^T Ae P with P = [W; I]  (m x m dense)
    G1W = g1[:, None] * W
    A2 = (W.T @ G1W - inv_tk * (W.T @ E.T) - inv_tk * (E @ W)
          + torch.diag(g[n:]))
    A2 = 0.5 * (A2 + A2.T)
    caps = capacity_schedule(m, N, opts)
    dense_levels = _build_dense_chain(
        A2, torch.ones(m, dtype=torch.bool, device=E.device), labels[n:],
        nsp[n:], caps, opts, key, nseg, axi0=axi2, xxseg=xxseg, ok0=ok,
        exit_every=exit_every)
    return lv1, dense_levels


def _build_dense_chain(A0, act0, lab0, nsp0, caps, opts: AMGOptions,
                       key: torch.Tensor, nseg: int,
                       axi0=None, xxseg=None, ok0=True,
                       exit_every: int = 1, plan_nseg=None) -> tuple:
    """Chain of padded dense levels (MIS coarsening) from ``A0`` at
    capacity ``caps[0]``, ending with the eigendecomposed coarsest level.
    Each level's labels get a plan into ``plan_nseg`` slots (default
    ``nseg``), the solve's ``nseg``.

    With ``axi0``/``xxseg`` the kernel-projection quantities propagate
    analytically (``Axi_{l+1} = P^T Axi_l``, ``xx`` level-invariant per
    component).  ``ok0`` and each level's interpolation defect gate the
    projection: once a prolongation breaks ``P 1_c = 1_f`` on a
    persisting near-singular component, that level and all below it run
    plain smoothing."""
    dtype = A0.dtype
    dev = A0.device
    dense_levels = []
    A_cur, act_cur, lab_cur, nsp_cur = A0, act0, lab0, nsp0
    ok_cur = torch.as_tensor(ok0, dtype=torch.bool, device=dev)
    axi_cur = axi0
    P_cur = torch.zeros(0, 0, dtype=dtype, device=dev)
    plan_nseg = nseg if plan_nseg is None else plan_nseg
    no_vec = torch.zeros(0, 0, dtype=dtype, device=dev)
    no_val = torch.zeros(0, dtype=dtype, device=dev)

    for li, cap in enumerate(caps):
        last = li == len(caps) - 1
        if last:
            # Coarsest level: eigendecomposed once per hierarchy; each
            # visit applies the spectrally filtered inverse.  A level
            # that is not finite (a zero coarse diagonal in fp32) gets NaN
            # eigenpairs, as from jnp.linalg.eigh, where torch would
            # raise; the solve's NaN guard then reverts the cycle.
            finite = torch.isfinite(A_cur).all()
            lam, evecs = torch.linalg.eigh(torch.where(finite, A_cur, 0.0))
            lam = torch.where(finite, lam, torch.nan)
            evecs = torch.where(finite, evecs, torch.nan)
            factor = (4.0 if dtype == torch.float64
                      else float(opts.coarse_cutoff_ulps))
            cutoff = factor * torch.finfo(dtype).eps * lam.abs().amax()
            einv = torch.where(lam > cutoff,
                               1.0 / torch.where(lam > cutoff, lam, 1.0), 0.0)
        else:
            evecs, einv = no_vec, no_val
        lvd = DenseLevel(A_cur, act_cur, P_cur, lab_cur, nsp_cur & ok_cur,
                         torch.zeros(cap, dtype=dtype, device=dev),
                         torch.ones(cap, dtype=dtype, device=dev),
                         evecs, einv, segment_plan(lab_cur, plan_nseg))
        if axi_cur is None:
            xi = act_cur.to(dtype)
            Axi = dense_matvec(lvd, xi)
            xx = segment_sum(xi * Axi, lab_cur, nseg)
            lvd = lvd._replace(Axi=Axi, xx=xx[lab_cur])
        else:
            lvd = lvd._replace(Axi=axi_cur, xx=xxseg[lab_cur])
        dense_levels.append(lvd)
        if last:
            break
        key, sub = jr.split(key)
        (A_cur, act_cur, lab_cur, nsp_cur, P_cur, defect) = _coarsen_dense(
            A_cur, act_cur, lab_cur, nsp_cur, caps[li + 1], opts, sub, nseg,
            exit_every)
        ok_cur = ok_cur & (defect < 0.1)
        if axi_cur is not None:
            axi_cur = P_cur.T @ axi_cur
    return tuple(dense_levels)


def setup_hierarchy_generic(A, opts: AMGOptions, key: torch.Tensor,
                            labels=None, nsp=None):
    """Generic (non-bigph) hierarchy for an SPD matrix: weighted-Jacobi
    smoothing and MIS/standard-interpolation coarsening from level 1
    down (``Class_AMG.m:72`` + ``transfer.m:30-66``).

    ``A`` is a dense ``(N, N)`` tensor or a
    :class:`otamg_torch.sparse.CSR`.  With a CSR the one-time setup
    densifies, but level 0 stays a :class:`CSRLevel`, so every
    solve-phase fine matvec runs the ELL SpMV kernel.  Returns
    ``(chain[0], chain[1:])`` for :func:`amg_solve`."""
    from otamg_torch.sparse.containers import CSR

    csr = A if isinstance(A, CSR) else None
    if csr is not None:
        A = csr.to_dense()
    N = A.shape[0]
    if labels is None:
        labels = torch.zeros(N, dtype=torch.int64, device=A.device)
    if nsp is None:
        nsp = torch.zeros(N, dtype=torch.bool, device=A.device)
    caps = [N]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(N))
    while caps[-1] > target and len(caps) < opts.max_levels:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    chain = _build_dense_chain(A, torch.ones(N, dtype=torch.bool,
                                             device=A.device),
                               labels, nsp, caps, opts, key, N)
    head = chain[0]
    if csr is not None and len(chain) > 1:
        head = CSRLevel(csr.ell_cols, csr.ell_vals, torch.diagonal(head.A),
                        head.labels, head.nsp, head.Axi, head.xx, head.plan)
    return head, chain[1:]


def _agg_galerkin_ell(cols, vals, k: int, out_cap: int):
    """Galerkin product for unit consecutive-block aggregation on ELL:
    with ``P[i, i // k] = 1`` every fine entry ``(i, j, v)`` maps to the
    coarse entry ``(i // k, j // k, v)``: rows grouped ``k`` at a time,
    columns divided, duplicates merged.  Returns ``(cols, vals,
    ngroups_max, Nc)``."""
    from otamg_torch.dist.assembly import ell_row_sum_duplicates

    N, rc = cols.shape
    Nc = -(-N // k)
    pad = Nc * k - N
    if pad:
        cols = torch.nn.functional.pad(cols, (0, 0, 0, pad))
        vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    gc = (cols // k).reshape(Nc, k * rc)
    gv = vals.reshape(Nc, k * rc)
    out_c, out_v, ngmax = ell_row_sum_duplicates(gc, gv, out_cap)
    return out_c, out_v, ngmax, Nc


def setup_hierarchy_sparse(csr, opts: AMGOptions, key: torch.Tensor,
                           agg: int = 2, dense_crossover: int = 1024):
    """Sparse-setup hierarchy for large SPD operators (``N >~ 1e5``),
    where the generic path's setup-time densification
    (:func:`setup_hierarchy_generic`) no longer fits memory.

    Above ``dense_crossover`` the operator is coarsened by unit
    consecutive-block aggregation (factor ``agg``): the Galerkin product
    is an ELL reshape and merge (:func:`_agg_galerkin_ell`), restriction
    a block row-sum and prolongation a repeat, an O(nnz) setup.  At or
    below the crossover the operator is densified and the reference
    MIS/standard-interpolation chain (``transfer.m:41-66``) takes over,
    ending in the eigensolved coarse level.  Meant for Laplacian-like
    banded operators with a trivial near-kernel: labels and ``nsp`` are
    not tracked through the aggregation levels.  Every matvec of the
    fine :class:`CSRLevel` and of each :class:`AggCSRLevel` runs the ELL
    SpMV kernel.  Raises ``ValueError`` when an aggregated row holds
    more distinct columns than its capacity (the operator is not banded
    enough)."""
    cols, vals = csr.ell_cols, csr.ell_vals
    N = cols.shape[0]
    dtype, dev = vals.dtype, vals.device

    def mk_sparse_level(c, v, n, k):
        z = torch.zeros(n, dtype=torch.int64, device=dev)
        f = torch.zeros(n, dtype=torch.bool, device=dev)
        one = torch.ones(n, dtype=dtype, device=dev)
        hit = c == torch.arange(n, dtype=c.dtype, device=dev)[:, None]
        dg = (v * hit).sum(dim=1)
        plan = segment_plan(z, N)
        if k is None:
            return CSRLevel(c, v, dg, z, f, one, one, plan)
        return AggCSRLevel(c, v, dg, z, f, one, one, plan, k)

    head = mk_sparse_level(cols, vals, N, None)
    chain: list = []
    c, v, n = cols, vals, N
    while n > dense_crossover:
        out_cap = c.shape[1] + 2
        c, v, ngmax, n = _agg_galerkin_ell(c, v, agg, out_cap)
        ngmax = int(fetch(ngmax))
        if ngmax > out_cap:
            raise ValueError(
                f"aggregation Galerkin overflow: {ngmax} distinct coarse "
                f"columns > capacity {out_cap} (operator not banded enough "
                f"for the sparse path)")
        if n > dense_crossover:
            chain.append(mk_sparse_level(c, v, n, agg))

    # Densify the crossover operator and hand over to the dense chain.
    rows = torch.arange(n, device=dev)[:, None].expand(c.shape)
    Ad = torch.zeros(n, n, dtype=dtype, device=dev).index_put_(
        (rows, c.long()), v, accumulate=True)
    caps = [n]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(N))
    while caps[-1] > target and len(caps) < opts.max_levels:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    dchain = list(_build_dense_chain(
        Ad, torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int64, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev), caps, opts, key, n,
        plan_nseg=N))
    # The dense head's transfer from the last sparse level is the unit
    # aggregation matrix (at most agg * crossover rows); the identity
    # when no aggregation happened (N already at the crossover).
    nf_prev = _lvl_size(chain[-1]) if chain else N
    eye = torch.eye(n, dtype=dtype, device=dev)
    P_agg = eye if nf_prev == n else eye.repeat_interleave(agg, 0)[:nf_prev]
    dchain[0] = dchain[0]._replace(P=P_agg)
    return head, tuple(chain) + tuple(dchain)


def _coarsen_dense(A, active, labels, nsp, cap_next: int,
                   opts: AMGOptions, key: torch.Tensor, nseg: int,
                   exit_every: int = 1):
    """One MIS + standard-interpolation + Galerkin coarsening step
    (``transfer.m:41-66``) on a padded dense level.  Also returns the
    interpolation defect: the worst deviation from 1 of a near-singular
    row's prolongation sum, over rows whose component keeps a C node.
    A defect >= 0.1 rebuilds the level with ideal interpolation (one
    host read per level)."""
    c = A.shape[0]
    dtype = A.dtype
    dev = A.device
    As = strength_dense(A, active) >= opts.theta
    isC, isF = mis_dense(As, active, key, exit_every=exit_every)

    dinv = 1.0 / torch.diagonal(A)
    fc_mask = isF[:, None] & isC[None, :]
    # Compaction: C columns in index order; overflow beyond the static
    # capacity is demoted (rare: MIS targets N/2).
    perm = torch.argsort((~isC).to(torch.uint8), stable=True)
    colidx = perm[:cap_next]
    keep = torch.arange(cap_next, device=dev) < isC.sum()
    labels_next = labels[colidx]
    nsp_next = nsp[colidx] & keep
    kept_flag = torch.zeros(c, dtype=torch.bool, device=dev)
    kept_flag[colidx] = keep
    ccount = segment_sum(kept_flag.to(torch.int64), labels, nseg)
    relevant = active & nsp & (ccount[labels] > 0) & ~kept_flag

    def ideal_W():
        # Ideal interpolation W = -Aff^{-1} Afc on the F subsystem.
        ff = isF[:, None] & isF[None, :]
        Aff = torch.where(ff, A, 0.0) + torch.diag((~isF).to(dtype))
        Afc = torch.where(fc_mask, A, 0.0)
        W = -torch.linalg.solve(Aff, Afc)
        return torch.where(isF[:, None], W, 0.0) * isC[None, :]

    def standard_W():
        # Standard interpolation; the reference's always-true guard makes
        # the effective weight 0.5 regardless of `inter` (transfer.m:54-56).
        strong_ff = As & isF[:, None] & isF[None, :]
        AFFs = torch.where(strong_ff, A, 0.0) + torch.diag(
            torch.where(isF, torch.diagonal(A), 0.0))
        W1 = torch.where(fc_mask, -A * dinv[:, None], 0.0)
        W2 = -dinv[:, None] * (AFFs @ W1)
        return W1 + 0.5 * W2

    def finish(W):
        """Normalization -> truncated P -> Galerkin -> defect."""
        rowsum = W.sum(dim=1)
        norm_mask = isF & nsp & (torch.abs(rowsum) > 0.01)
        W = torch.where(norm_mask[:, None],
                        W / torch.where(norm_mask, rowsum, 1.0)[:, None], W)
        P_full = W + torch.diag(isC.to(dtype))
        P = P_full[:, colidx] * keep[None, :].to(dtype)
        Ac = P.T @ (A @ P)
        Ac = 0.5 * (Ac + Ac.T)
        Ac = Ac + torch.diag((~keep).to(dtype))
        defect = torch.where(relevant, torch.abs(P.sum(dim=1) - 1.0),
                             0.0).amax()
        return Ac, P, defect

    if opts.inter >= 2:
        Ac, P, defect = finish(ideal_W())
    else:
        Ac, P, defect = finish(standard_W())
        # Defect repair: when standard interpolation breaks P 1_c = 1_f
        # on a persisting near-singular component, rebuild the level with
        # ideal interpolation.
        if fetch(defect >= 0.1):
            Ac, P, defect = finish(ideal_W())
    return Ac, keep, labels_next, nsp_next, P, defect


# ---------------------------------------------------------------------------
# Cycles: a visit tape run by a Python loop
# ---------------------------------------------------------------------------


def _gen_tape(num_levels: int, gamma: int) -> list[tuple[str, int]]:
    """Unroll the cycle recursion into an (op, level) sequence.
    ``gamma``: 1 = V, 2 = W, 3 = F (W's revisit structure with the second
    child visit run as a V-cycle)."""
    ops: list[tuple[str, int]] = []
    last = num_levels - 1

    def visit(l: int, g: int) -> None:
        if l == last:
            ops.append(("coarse", l))
            return
        ops.append(("pre", l))
        ops.append(("down", l))
        visit(l + 1, g)
        if g >= 2 and l + 1 != last:
            # warm-started revisit (MG_Wcycle.m:28-30); F demotes it to V.
            visit(l + 1, 1 if g == 3 else g)
        ops.append(("up", l))

    visit(0, gamma)
    return ops


def _coarse_solve(lv, r, nseg: int, deflated: bool, coarse_retol: float,
                  coarse_maxit: int, coarse_direct: bool):
    """Coarsest-level solve: the spectrally filtered direct solve from the
    setup-time eigendecomposition, or Jacobi-PCG (``MG_Vcycle.m:43``).
    ``deflated`` keeps the direct solve's correction kernel-free too."""
    if coarse_direct and isinstance(lv, DenseLevel) \
            and lv.evecs.shape[0] > 0:
        e_c = lv.evecs @ (lv.einv * (lv.evecs.T @ r))
        if deflated:
            xi = lv.nsp.to(e_c.dtype)
            cnt = segment_sum(xi, lv.labels, nseg, lv.plan)
            e_c = _deflate(e_c, xi, lv, torch.where(cnt > 0, cnt, 1.0), nseg)
        return e_c
    if isinstance(lv, BipartiteLevel):
        dg = lv.g
        mv = lambda v: bip_matvec(lv, v)
    else:
        dg = torch.diagonal(lv.A)
        mv = lambda v: dense_matvec(lv, v)
    return pcg(mv, r, lambda v: v / dg, retol=coarse_retol,
               maxit=coarse_maxit).x


def make_cycle(num_dense: int, smoth_it: int, gamma: int, nseg: int,
               coarse_retol: float = 1e-11, coarse_maxit: int = 10_000,
               coarse_direct: bool = True, deflated: bool = False):
    """Build ``cycle(lv1, dense_levels, r, deep_D=None) -> e`` running one
    V/W/F cycle off the visit tape, with ``cycle.build_deep(lv1, dense,
    dtype)`` materializing the tape below level 0 as one dense matrix
    (``fuse_deep``).  ``deflated`` selects the kernel-free smoothers and
    coarse solve (see :func:`_projected_smooth`)."""
    tape = _gen_tape(num_dense + 1, gamma)
    can_fuse = num_dense >= 2

    def cycle(lv1, dense: Sequence[DenseLevel], r0: torch.Tensor,
              deep_D: torch.Tensor | None = None):
        levels = [lv1] + list(dense)
        bip0 = isinstance(lv1, BipartiteLevel)

        def lvl_matvec(l, v):
            return _level0_ops(levels[l])[0](levels[l], v)

        def lvl_smooth(l, e, r, transpose, e_is_zero=False):
            if l == 0 and bip0:
                return _projected_smooth_bip(levels[0], e, r, smoth_it,
                                             transpose, nseg, deflated,
                                             e_is_zero)
            mv, sm = _level0_ops(levels[l])
            return _projected_smooth(mv, sm, levels[l], e, r, smoth_it,
                                     transpose, nseg, deflated)

        def restrict(l, rr):
            if l == 0 and bip0:
                n = lv1.W.shape[0]
                return rr[n:] + lv1.W.T @ rr[:n]
            child = levels[l + 1]
            if isinstance(child, AggCSRLevel):
                # Consecutive-block aggregation: P^T is a block row-sum.
                k, nc = child.agg, child.dg.shape[0]
                rr = torch.nn.functional.pad(rr, (0, nc * k - rr.shape[0]))
                return rr.view(nc, k).sum(dim=1)
            return child.P.T @ rr

        def prolong(l, ec):
            if l == 0 and bip0:
                return torch.cat([lv1.W @ ec, ec])
            child = levels[l + 1]
            if isinstance(child, AggCSRLevel):
                return ec.repeat_interleave(child.agg)[:_lvl_size(levels[l])]
            return child.P @ ec

        es = [torch.zeros(_lvl_size(lv), dtype=r0.dtype, device=r0.device)
              for lv in levels]
        rs = [r0] + [None] * len(dense)

        def run(kind, l):
            if kind == "pre":
                # Level 0 is visited once per cycle from a zeroed e.
                es[l] = lvl_smooth(l, es[l], rs[l], False,
                                   e_is_zero=(l == 0))
            elif kind == "down":
                rs[l + 1] = restrict(l, rs[l] - lvl_matvec(l, es[l]))
                es[l + 1] = torch.zeros_like(es[l + 1])
            elif kind == "up":
                es[l] = lvl_smooth(l, es[l] + prolong(l, es[l + 1]), rs[l],
                                   True)
            else:
                es[l] = _coarse_solve(levels[l], rs[l], nseg, deflated,
                                      coarse_retol, coarse_maxit,
                                      coarse_direct)

        if deep_D is not None:
            # The whole deep tape is the precomputed linear map deep_D.
            run("pre", 0)
            run("down", 0)
            es[1] = deep_D @ rs[1]
            run("up", 0)
        else:
            for kind, l in tape:
                run(kind, l)
        return es[0]

    def _deep_algebraic(dense: Sequence[DenseLevel], dtype):
        """Bottom-up algebraic build of ``D`` (``e1 = D @ r1``): a
        projected Jacobi sweep is ``e' = G1 e + B1 r``, a smoothing phase
        its ``smoth_it``-fold composite, a visit the two-grid composition
        ``C = Gp (Hp + P D_next P^T (I - A Hp)) + Hp``, a warm-started
        W/F revisit ``D = C + C' (I - A C)``, and the coarse solve
        ``evecs diag(einv) evecs^T``.  Deflated, a sweep is ``Q (I - K A)``
        and ``Q diag(K)`` with ``Q`` the projector that removes the
        component means, and the coarse solve is followed by ``Q``."""
        phase_cache: dict = {}
        node_cache: dict = {}

        def proj_parts(lv):
            xi = lv.nsp.to(dtype)
            return xi, ((lv.labels[:, None] == lv.labels[None, :]).to(dtype)
                        * xi[None, :])

        def mean_projector(lv):
            """``Pm`` with ``Q = I - Pm``: the component-mean operator on
            the near-singular nodes."""
            xi, xmat = proj_parts(lv)
            cnt = xmat.sum(dim=1)   # the component's count, per node
            return (xi / torch.where(cnt > 0, cnt, 1.0))[:, None] * xmat

        def phase_ops(idx):
            if idx in phase_cache:
                return phase_cache[idx]
            lv = dense[idx]
            A = lv.A.to(dtype)
            I = torch.eye(A.shape[0], dtype=dtype, device=A.device)
            K = 0.5 / torch.diagonal(A)
            if deflated:
                Pm = mean_projector(lv)
                IKA = I - K[:, None] * A
                G1 = IKA - Pm @ IKA
                B1 = torch.diag(K) - Pm * K[None, :]
            else:
                xi, xmat = proj_parts(lv)
                safe_xx = torch.where(torch.abs(lv.xx) > 0, lv.xx,
                                      1.0).to(dtype)
                Wm = (xi / safe_xx)[:, None] * xmat
                B1 = xi[:, None] * Wm + K[:, None] * (
                    I - lv.Axi.to(dtype)[:, None] * Wm)
                G1 = I - B1 @ A
            Gp, Hp = I, torch.zeros_like(I)
            for _ in range(smoth_it):
                Gp = G1 @ Gp
                Hp = G1 @ Hp + B1
            phase_cache[idx] = (Gp, Hp)
            return Gp, Hp

        last = len(dense) - 1

        def visit(idx, g):
            key = ("v", idx, g)
            if key not in node_cache:
                Gp, Hp = phase_ops(idx)
                Dn = deep(idx + 1, g)
                A = dense[idx].A.to(dtype)
                P = dense[idx + 1].P.to(dtype)
                I = torch.eye(A.shape[0], dtype=dtype, device=A.device)
                T = P.T @ (I - A @ Hp)
                node_cache[key] = Gp @ (Hp + P @ (Dn @ T)) + Hp
            return node_cache[key]

        def deep(idx, g):
            key = ("d", idx, g)
            if key not in node_cache:
                if idx == last:
                    lv = dense[idx]
                    D = (lv.evecs * lv.einv[None, :]) @ lv.evecs.T
                    if deflated:
                        D = D - mean_projector(lv).to(D.dtype) @ D
                    D = D.to(dtype)
                else:
                    D = visit(idx, g)
                    if g >= 2:
                        C2 = visit(idx, 1 if g == 3 else g)
                        A = dense[idx].A.to(dtype)
                        I = torch.eye(A.shape[0], dtype=dtype,
                                      device=A.device)
                        D = D + C2 @ (I - A @ D)
                node_cache[key] = D
            return node_cache[key]

        return deep(0, gamma)

    def build_deep(lv1, dense: Sequence[DenseLevel], dtype):
        """The deep sub-tape as a ``(cap1, cap1)`` matrix, or None when
        fusing cannot pay (fewer than 2 dense levels), a deep level is
        sparse or the coarse solve is PCG; the full tape then runs (the
        same linear map)."""
        del lv1
        if not can_fuse or not coarse_direct \
                or not all(isinstance(lv, DenseLevel) for lv in dense) \
                or dense[-1].evecs.shape[0] == 0:
            return None
        return _deep_algebraic(dense, dtype)

    cycle.build_deep = build_deep
    return cycle


# ---------------------------------------------------------------------------
# Classical solve loop (Class_AMG.m:86-109)
# ---------------------------------------------------------------------------


class AMGSolveResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor    # () int64, on the device of x
    rel_res: torch.Tensor


def _solve_step(cycle, mv0, lv1, dense, deep_D, b, safe0, retol_eff: float,
                maxit: int, state):
    """One iteration of :func:`amg_solve` on ``state = (x, r, rel, it,
    go)``, frozen where ``go`` is False."""
    x, r, rel, it, go = state
    # The residual is carried: the post-update residual of one iteration
    # is the next one's r.
    x_new = x + cycle(lv1, dense, r, deep_D)
    r_new = b - mv0(lv1, x_new)
    res = torch.linalg.vector_norm(r_new)
    nr = torch.linalg.vector_norm(r)
    bad = ~torch.isfinite(res)
    grew = bad | (res > nr)
    x1 = torch.where(grew, x, x_new)
    r1 = torch.where(grew, r, r_new)
    rel1 = torch.where(grew, rel, res / safe0)
    rho = torch.where(bad, 2.0, res / nr)
    it1 = it + 1
    done = (rel1 <= retol_eff) | (rho > 1.0) | (it1 >= maxit)
    return (torch.where(go, x1, x), torch.where(go, r1, r),
            torch.where(go, rel1, rel), torch.where(go, it1, it),
            go & ~done)


class _Captured:
    """A block of solve iterations captured as one CUDA graph, with the
    static buffers it reads (the hierarchy, ``b``, ``safe0``) and the
    state it advances in place."""

    def __init__(self, inputs, state, run_block):
        self.inputs = [t.clone() for t in inputs]
        self.state = [t.clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # Warm-up outside the capture (cuBLAS workspaces, the kernels'
            # first-call set-up).
            for dst, src in zip(self.state, run_block(self.inputs,
                                                      self.state)):
                dst.copy_(src)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for dst, src in zip(self.state, run_block(self.inputs,
                                                      self.state)):
                dst.copy_(src)


class GraphCache:
    """The captured AMG solve blocks, one per tape signature (level
    shapes and dtypes, cycle, ``deflated``, ``fuse_deep``, block size and
    stopping rule); ``captures`` and ``replays`` count since ``clear``."""

    def __init__(self):
        self.blocks: dict = {}
        self.captures = 0
        self.replays = 0

    def clear(self) -> None:
        self.blocks.clear()
        self.captures = self.replays = 0


amg_graphs = GraphCache()


def _capturable(lv1, dense, b, deep_D, coarse_direct: bool) -> bool:
    """The cycle makes no host read: the bipartite level over dense
    levels with the direct (or fused) coarse solve, on a card."""
    return (b.is_cuda and isinstance(lv1, BipartiteLevel)
            and all(isinstance(lv, DenseLevel) for lv in dense)
            and (deep_D is not None
                 or (coarse_direct and len(dense) > 0
                     and dense[-1].evecs.shape[0] > 0)))


def amg_solve(lv1, dense: Sequence[DenseLevel], b: torch.Tensor,
              guess: torch.Tensor, opts: AMGOptions,
              deflated: bool = False, exit_every: int = 1) -> AMGSolveResult:
    """Stationary iteration ``x += cycle(b - A x)`` with relative-residual
    stopping and the divergence guard (``Class_AMG.m:95-106``): a cycle
    whose residual grows, or is not finite, is reverted and ends the
    loop.  ``deflated=True`` keeps every iterate kernel-free (the
    mixed-precision correction solves).  Below f64 the relative
    tolerance is floored at 4 eps of ``b``'s dtype.

    The iterations run in blocks of ``exit_every`` with one host read a
    block; the iterations after the exit inside a block leave ``x``,
    ``rel`` and the count ``iters`` (kept on the device) as the exit set
    them, so the block size does not change the result.  On a card with
    ``exit_every > 1``, a bipartite hierarchy and a direct coarse solve,
    the block is one CUDA graph (:data:`amg_graphs`), captured at the
    first solve of its signature and replayed for every later one: each
    solve copies its hierarchy into the graph's static buffers."""
    nseg = b.shape[0]
    gamma = {Cycle.V: 1, Cycle.W: 2, Cycle.F: 3}[opts.cycle]
    coarse_direct = opts.coarse_solver == "direct"
    cycle = make_cycle(len(dense), opts.smoth, gamma, nseg,
                       opts.coarse_pcg.retol, opts.coarse_pcg.maxit,
                       coarse_direct, deflated)
    deep_D = (cycle.build_deep(lv1, dense, b.dtype)
              if opts.fuse_deep else None)
    mv0 = _level0_ops(lv1)[0]

    r = b - mv0(lv1, guess)
    res0 = torch.linalg.vector_norm(r)
    safe0 = torch.where(res0 == 0, 1.0, res0)
    retol_eff = max(opts.retol, 4 * torch.finfo(b.dtype).eps)
    state = (guess, r, torch.ones((), dtype=b.dtype, device=b.device),
             torch.zeros((), dtype=torch.int64, device=b.device), res0 != 0)

    if exit_every > 1 and _capturable(lv1, dense, b, deep_D, coarse_direct):
        nlv1 = len(_leaves(lv1))
        nd = len(_leaves(dense[0]))

        def run_block(inputs, st):
            lv = _from_leaves(BipartiteLevel, inputs[:nlv1])
            dl = [_from_leaves(DenseLevel,
                               inputs[nlv1 + i * nd:nlv1 + (i + 1) * nd])
                  for i in range(len(dense))]
            dD = inputs[-3] if deep_D is not None else None
            for _ in range(exit_every):
                st = _solve_step(cycle, mv0, lv, dl, dD, inputs[-2],
                                 inputs[-1], retol_eff, opts.maxit, st)
            return st

        inputs = [*_leaves(lv1), *(t for lv in dense for t in _leaves(lv)),
                  *([deep_D] if deep_D is not None else []), b, safe0]
        sig = (tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
               deep_D is not None, opts.smoth, gamma, deflated, exit_every,
               retol_eff, opts.maxit)
        blk = amg_graphs.blocks.get(sig)
        if blk is None:
            blk = amg_graphs.blocks[sig] = _Captured(inputs, state,
                                                     run_block)
            amg_graphs.captures += 1
        for dst, src in zip(blk.inputs, inputs):
            dst.copy_(src)
        for dst, src in zip(blk.state, state):
            dst.copy_(src)
        while True:
            blk.graph.replay()
            amg_graphs.replays += 1
            if not fetch(blk.state[4]):
                break
        x, _, rel, it, _ = (t.clone() for t in blk.state)
        return AMGSolveResult(x, it, rel)

    while True:
        for _ in range(exit_every):
            state = _solve_step(cycle, mv0, lv1, dense, deep_D, b, safe0,
                                retol_eff, opts.maxit, state)
        if not fetch(state[4]):
            break
    x, _, rel, it, _ = state
    return AMGSolveResult(x, it, rel)


def amg_solve_matrix(A, b: torch.Tensor, opts: AMGOptions = AMGOptions(),
                     guess=None, key=None) -> AMGSolveResult:
    """Generic AMG solve of ``A x = b`` for an SPD dense tensor or a
    :class:`otamg_torch.sparse.CSR` (``Class_AMG.m`` with ``bigph=0``).
    With a CSR every fine-level matvec of the solve is the ELL SpMV."""
    if key is None:
        key = jr.PRNGKey(0)
    if guess is None:
        guess = torch.zeros_like(b)
    lv0, rest = setup_hierarchy_generic(A, opts, key)
    return amg_solve(lv0, rest, b, guess, opts)
