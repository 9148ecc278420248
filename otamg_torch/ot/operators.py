"""Matrix-free OT operators, Class 1 (port of ``otamg/ot/operators.py``).

The constraint matrix ``A = [I_n (x) p^T ; q^T (x) I_m]`` is applied on the
``(m, n)`` plan matrix ``X``: every application is a GEMV or a rank-2
outer-product update.  Dual vectors are flat ``(n + m,)`` tensors with the
``n`` block first (reference layout ``y = [r-part; l-part]``).

``out_dtype`` asks for the reductions into the dual space in a higher
precision: with an fp32 plan the loop drivers carry the dual state and
every O(mn) reduction in f64, as the JAX package does.  The operands are
cast before the multiply (an f32*f32 product is exact in f64), so this
is the JAX package's f64-accumulated product up to the order of the
sums; the cast of an ``(m, n)`` operand is a temporary f64 copy of it.
The chunked reductions the JAX package needs for the TPU's emulated f64
are plain torch reductions here (``sum_chunked`` is ``torch.sum``).  The
Class-2 operators act on the partial-OT primal ``(X, y, z)`` through
``H = [G, IY, IZ]`` with ``G = [A; phi^T]`` and an ``(n + m + 1,)`` dual.
"""

from __future__ import annotations

import torch


def split_dual(y: torch.Tensor, n: int):
    """Split a flat dual vector into its (n,) and (m,) blocks."""
    return y[:n], y[n:]


def _hi(out_dtype, *ts):
    """``ts`` cast to ``out_dtype`` (unchanged when it is None)."""
    return ts if out_dtype is None else tuple(t.to(out_dtype) for t in ts)


def apply_A(X: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
            out_dtype=None):
    """``A @ vec(X)`` = ``[X^T p; X q]`` (reference ``Ax.m``), accumulated
    in ``out_dtype`` when given."""
    X, p, q = _hi(out_dtype, X, p, q)
    return torch.cat([X.T @ p, X @ q])


def vdot_hi(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Dot product of two tensors of any shape, flattened, accumulated in
    ``out_dtype`` when given."""
    a, b = _hi(out_dtype, a.reshape(-1), b.reshape(-1))
    return torch.dot(a, b)


def norm_hi(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """2-norm of a tensor of any shape, flattened, accumulated in
    ``out_dtype`` when given."""
    return torch.sqrt(vdot_hi(a, a, out_dtype))


def apply_At(y: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """``unvec(A^T y)`` = ``p yn^T + ym q^T`` (reference ``Aty.m``)."""
    yn, ym = split_dual(y, q.shape[0])
    return torch.outer(p, yn) + torch.outer(ym, q)


def asat_diags(S: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Diagonal blocks of ``H0 = A diag(s) A^T`` (reference
    ``ASAt.m:9-19``): ``d1 = S^T (p*p)`` (n,), ``d2 = S (q*q)`` (m,)."""
    return S.T @ (p * p), S @ (q * q)


def apply_asat(z: torch.Tensor, S: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor, d1=None, d2=None) -> torch.Tensor:
    """Matrix-free ``H0 @ z`` with ``H0 = A diag(s) A^T``::

        out1 = d1*z1 + q * (S^T (p*z2))
        out2 = p * (S (q*z1)) + d2*z2
    """
    n = q.shape[0]
    if d1 is None or d2 is None:
        d1, d2 = asat_diags(S, p, q)
    z1, z2 = split_dual(z, n)
    out1 = d1 * z1 + q * (S.T @ (p * z2))
    out2 = p * (S @ (q * z1)) + d2 * z2
    return torch.cat([out1, out2])


def prox_box(X: torch.Tensor, gama: torch.Tensor) -> torch.Tensor:
    """Projection onto ``[0, gama]`` (reference ``prox`` lambda,
    ``Class1/APD_SsN_Class1.m:29``); ``gama`` may be a 0-d ``inf``."""
    return torch.minimum(torch.clamp_min(X, 0.0), gama)


def prox_nonneg(X: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant
    (``Class2/APD_SsN_Class2.m:25``)."""
    return torch.clamp_min(X, 0.0)


def inv_aat(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
            sg1, sg2=None) -> torch.Tensor:
    """Closed-form ``(diag(sg1 I_n, sg2 I_m) + A A^T)^{-1} x``
    (reference ``invAAt.m:17-18``): two scaled identities plus a rank-1
    coupling, inverted exactly in O(m + n)."""
    if sg2 is None:
        sg2 = sg1
    n = q.shape[0]
    np2 = torch.dot(p, p)
    nq2 = torch.dot(q, q)
    vn, vm = split_dual(x, n)
    den = sg1 * sg2 + sg1 * nq2 + sg2 * np2
    qvn = torch.dot(q, vn)
    pvm = torch.dot(p, vm)
    yn = vn / (sg1 + np2) + (np2 / (sg1 + np2) * qvn - pvm) * q / den
    ym = vm / (sg2 + nq2) + (nq2 / (sg2 + nq2) * pvm - qvn) * p / den
    return torch.cat([yn, ym])


def inv_hht(v: torch.Tensor, p: torch.Tensor, q: torch.Tensor, sg,
            Phi: torch.Tensor) -> torch.Tensor:
    """Closed-form ``(sg I + H H^T)^{-1} v`` for ``H = [G, IY, IZ]``,
    ``G = [A; phi^T]`` (reference ``Class2/invHHt.m:8-17``): the extra
    row/column over :func:`inv_aat` is eliminated by the 2x2 block Schur
    complement with scalar ``s = t - l^T V l``, ``l = A phi``."""
    t = sg + vdot_hi(Phi, Phi)
    el = apply_A(Phi, p, q)
    Vl = inv_aat(el, p, q, sg + 1.0)
    s = t - torch.dot(el, Vl)
    v1, v2 = v[:-1], v[-1]
    Vv1 = inv_aat(v1, p, q, sg + 1.0)
    elVv1 = torch.dot(el, Vv1)
    y1 = s * Vv1 + elVv1 * Vl - v2 * Vl
    y2 = v2 - elVv1
    return torch.cat([y1, y2[None]]) / s


def apply_H(X: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
            p: torch.Tensor, q: torch.Tensor, Phi: torch.Tensor,
            out_dtype=None):
    """``H @ (vec(X), y, z)`` = ``[A vec(X) + [y; z]; <phi, x>]``
    (reference ``Class2/APD_SsN_Class2.m:60``), accumulated in
    ``out_dtype`` when given."""
    yz, = _hi(out_dtype, torch.cat([y, z]))
    top = apply_A(X, p, q, out_dtype) + yz
    return torch.cat([top, vdot_hi(Phi, X, out_dtype)[None]])


def apply_Ht(lam: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
             Phi: torch.Tensor):
    """``H^T lam`` split into its plan part ``G^T lam`` as ``(m, n)`` and
    its slack part ``lam[:n+m]`` (reference
    ``Class2/APD_SsN_Class2.m:124``)."""
    lam_nm, lam_last = lam[:-1], lam[-1]
    return apply_At(lam_nm, p, q) + lam_last * Phi, lam_nm


def feasibility_polish(X: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                       p: torch.Tensor, q: torch.Tensor, Phi: torch.Tensor,
                       b: torch.Tensor, rounds: int = 8,
                       lam: torch.Tensor | None = None):
    """Feasibility rounding of the partial-OT primal ``u = (X, y, z)``
    onto ``{H u = b, u >= 0}``, the tail safeguard of
    ``otamg.ot.operators.feasibility_polish`` (no reference analogue):

    1. scale each column/row of ``X`` down to its marginal (never
       increases an entry, keeps the support);
    2. restore the phi-row mass ``phi^T x = mu``: a deficit is added along
       the remaining row/column slacks (capped so no marginal overfills),
       a surplus removed by a global scale;
    3. the slacks absorb the one-sided marginal gaps exactly.

    With ``lam`` the rounding is dual-aware: columns/rows whose duals are
    above 1e-5 are filled exactly to their marginals, and the mass
    rebalance moves only doubly-unsaturated entries.  The caller
    re-measures the full KKT on the result.  Its loops run a fixed
    ``rounds`` with no host read."""
    n = q.shape[0]
    m = p.shape[0]
    bl, bm, mu = b[:n], b[n:-1], b[-1]
    if lam is not None:
        sat_c = lam[:n] > 1e-5
        sat_r = lam[n:n + m] > 1e-5
    else:
        sat_c = torch.zeros(n, dtype=torch.bool, device=X.device)
        sat_r = torch.zeros(m, dtype=torch.bool, device=X.device)

    def nz(v):
        return torch.where(v > 0, v, 1.0)

    for _ in range(rounds):
        # 1. scale-down, then exact fill-up of the saturated columns and
        # rows (Sinkhorn-like alternation over the rounds).
        col = X.T @ p
        X = X * torch.clamp_max(bl / nz(col), 1.0)[None, :]
        row = X @ q
        X = X * torch.clamp_max(bm / nz(row), 1.0)[:, None]
        col = X.T @ p
        X = X * torch.where(sat_c & (col > 0), bl / nz(col), 1.0)[None, :]
        row = X @ q
        X = X * torch.where(sat_r & (row > 0), bm / nz(row), 1.0)[:, None]
        mass = vdot_hi(Phi, X)
        if lam is not None:
            # 2a. mass correction through the doubly-unsaturated entries,
            # clamped to [0, fmax] so no entry goes negative and no
            # unsaturated marginal overfills.
            U = (~sat_r)[:, None] & (~sat_c)[None, :]
            Mu = vdot_hi(Phi * U, X)
            want = mu - (mass - Mu)
            f = torch.where(Mu > 0, want / nz(Mu), 1.0)
            XU = torch.where(U, X, 0.0)
            colU = XU.T @ p
            rowU = XU @ q
            col = X.T @ p
            row = X @ q
            fmax_c = torch.where(colU > 0, 1.0 + (bl - col) / nz(colU),
                                 torch.inf).amin()
            fmax_r = torch.where(rowU > 0, 1.0 + (bm - row) / nz(rowU),
                                 torch.inf).amin()
            fmax = torch.clamp_min(torch.minimum(fmax_c, fmax_r), 1.0)
            f = torch.minimum(torch.clamp_min(f, 0.0), fmax)
            X = torch.where(U, X * f, X)
        else:
            # 2b. a deficit is added along the row/column slack product,
            # capped so no marginal overfills; a surplus is removed by a
            # global scale.
            deficit = mu - mass
            col = X.T @ p
            row = X @ q
            cs = torch.clamp_min(bl - col, 0.0)
            rs = torch.clamp_min(bm - row, 0.0)
            D = (rs / p)[:, None] * cs[None, :]
            denom = vdot_hi(Phi, D)
            add = torch.where(denom > 0, deficit / nz(denom), 0.0)
            srs = torch.sum(rs)
            qcs = torch.dot(q, cs)
            cap = torch.minimum(
                torch.where(srs > 0, 1.0 / nz(srs), torch.inf),
                torch.where(qcs > 0, p.amin() / nz(qcs), torch.inf))
            add = torch.minimum(add, cap)
            scale = torch.where(mass > 0, mu / nz(mass), 1.0)
            X = torch.where(deficit >= 0, X + add * D, X * scale)
    # 3. slacks absorb the marginal gaps.
    y = prox_nonneg(bl - X.T @ p)
    z = prox_nonneg(bm - X @ q)
    return X, y, z


def kkt_class1(X, lam, C, b, p, q, gama, out_dtype=None):
    """Primal/dual KKT residual norms for Class 1
    (reference ``Class1/APD_SsN_Class1.m:63-65``)::

        KKT(lam) = || A x - b ||
        KKT(x)   = || x - prox(x - c - A^T lam) ||

    ``lam`` may be in a higher precision than the plan; the plan-space
    algebra runs in the plan's precision, and the norms accumulate in
    ``out_dtype`` when given."""
    hb, = _hi(out_dtype, b)
    kkt_l = torch.linalg.vector_norm(apply_A(X, p, q, out_dtype) - hb)
    R = X - prox_box(X - C - apply_At(lam.to(X.dtype), p, q), gama)
    return norm_hi(R, out_dtype), kkt_l


def kkt_class2(X, y, z, lam, C, b, p, q, Phi, out_dtype=None):
    """Four KKT residual norms ``(x, y, z, lam)`` for Class 2
    (reference ``Class2/APD_SsN_Class2.m:56-59``), with the precisions of
    :func:`kkt_class1`."""
    n = q.shape[0]
    hb, = _hi(out_dtype, b)
    kkt_l = torch.linalg.vector_norm(apply_H(X, y, z, p, q, Phi, out_dtype)
                                     - hb)
    lam = lam.to(X.dtype)
    lam_n, lam_m = lam[:n], lam[n:n + X.shape[0]]
    kkt_z = norm_hi(z - prox_nonneg(z - lam_m), out_dtype)
    kkt_y = norm_hi(y - prox_nonneg(y - lam_n), out_dtype)
    Gt, _ = apply_Ht(lam, p, q, Phi)
    kkt_x = norm_hi(X - prox_nonneg(X - C - Gt), out_dtype)
    return kkt_x, kkt_y, kkt_z, kkt_l
