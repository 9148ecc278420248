"""A-ADMM warm starts (port of ``otamg/opt/admm.py``).

Accelerated ADMM producing the initial primal-dual pair for the APD loop
(reference ``Class1/warmup_class1.m``, ``Class2/warmup_class2.m``).
Every iteration is closed form: the x-update solves its KKT system
exactly through the O(m+n) ``inv_aat`` / ``inv_hht`` — no inner
iteration and no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otamg_torch.ot import operators as op
from otamg_torch.ot.problems import Class1Problem, Class2Problem


class WarmStart1(NamedTuple):
    X: torch.Tensor      # (m, n) primal plan
    lam: torch.Tensor    # (n + m,) equality multipliers


class WarmStart2(NamedTuple):
    X: torch.Tensor      # (m, n)
    y: torch.Tensor      # (n,)
    z: torch.Tensor      # (m,)
    lam: torch.Tensor    # (n + m + 1,)


def warmup_class1(prob: Class1Problem, maxit: int = 100) -> WarmStart1:
    """Reference ``warmup_class1.m:2`` driven for a fixed ``maxit``
    iterations (the drivers use 100, ``Class1/APD_SsN_Class1.m:55,59``).
    The step sizes are host floats: they depend on the iteration count
    only."""
    p, q, C, gama = prob.p, prob.q, prob.C, prob.gama
    m, n = prob.m, prob.n
    b = prob.b
    Atb = op.apply_At(b, p, q)
    # State of warmup_class1.m:28-30: the multiplier of [Ax=b; x=w] is
    # split into lam1 (n+m,) and its (m, n) block Lam2.
    zeros = torch.zeros_like(C)
    X, V, W, Pi, Lam2 = zeros, zeros, zeros, zeros, zeros
    lam1 = torch.zeros(n + m, dtype=C.dtype, device=C.device)
    gk, bk = 1.0, 1.0
    muf = 0.0
    for _ in range(maxit):
        # warmup_class1.m:57-60
        ak = bk
        bk1 = bk / (1 + ak)
        gk1 = (gk + muf * ak) / (1 + ak)
        etafk = (1 + ak) * gk + muf * ak
        sgk = 1.0 / bk1
        etagk = (1 + ak) * bk
        # warmup_class1.m:62-63
        wwk = (ak * Pi + W) / (1 + ak)
        wxk = (ak * gk * V + (gk + muf * ak) * X) / etafk
        # warmup_class1.m:65-67
        hlk1 = lam1 - (op.apply_A(X, p, q) - b) / bk
        hLk2 = Lam2 - (X - W) / bk - (ak / bk) * (Pi - W)
        cAw = -Atb - W
        cAlk = op.apply_At(hlk1, p, q) + hLk2
        dd = etafk * wxk - ak ** 2 * (C + cAlk + sgk * cAw)
        # warmup_class1.m:69-70 — closed-form KKT solve via invAAt
        tt = sgk * ak ** 2
        sg = 1 + etafk / tt
        X1 = (dd - op.apply_At(
            op.inv_aat(op.apply_A(dd, p, q), p, q, sg), p, q)) / (etafk + tt)
        # warmup_class1.m:71-75
        V1 = X1 + (X1 - X) / ak
        bLk2 = Lam2 + (ak / bk) * (V1 - Pi)
        W1 = op.prox_box(wwk - ak ** 2 / etagk * (-bLk2), gama)
        Pi1 = W1 + (W1 - W) / ak
        lam1 = lam1 + (ak / bk) * (op.apply_A(V1, p, q) - b)
        Lam2 = Lam2 + (ak / bk) * (V1 - Pi1)
        gk, bk, X, V, W, Pi = gk1, bk1, X1, V1, W1, Pi1
    return WarmStart1(X, lam1)


def warmup_class2(prob: Class2Problem, maxit: int = 100) -> WarmStart2:
    """Reference ``warmup_class2.m`` for the partial-OT three-block
    operator ``H = [G, IY, IZ]``, driven for a fixed ``maxit``
    iterations; the x-update goes through ``inv_hht``.  Slack blocks
    ``(y; z)`` travel as one ``(n + m,)`` vector."""
    p, q, C, Phi = prob.p, prob.q, prob.C, prob.Phi
    m, n = prob.m, prob.n
    b = prob.b
    Htb_X, Htb_s = op.apply_Ht(b, p, q, Phi)

    def Hu(X, u_s):
        return op.apply_H(X, u_s[:n], u_s[n:], p, q, Phi)

    zeros = torch.zeros_like(C)
    zeros_s = torch.zeros(n + m, dtype=C.dtype, device=C.device)
    X, VX, WX, PiX, Lam2X = zeros, zeros, zeros, zeros, zeros
    u_s, v_s, w_s, pi_s, lam2s = zeros_s, zeros_s, zeros_s, zeros_s, zeros_s
    lam1 = torch.zeros(n + m + 1, dtype=C.dtype, device=C.device)
    gk, bk = 1.0, 1.0
    muf = 0.0
    for _ in range(maxit):
        ak = bk
        bk1 = bk / (1 + ak)
        gk1 = (gk + muf * ak) / (1 + ak)
        etafk = (1 + ak) * gk + muf * ak
        sgk = 1.0 / bk1
        etagk = (1 + ak) * bk
        # warmup_class2.m:64-66
        wwX = (ak * PiX + WX) / (1 + ak)
        ww_s = (ak * pi_s + w_s) / (1 + ak)
        wuX = (ak * gk * VX + (gk + muf * ak) * X) / etafk
        wu_s = (ak * gk * v_s + (gk + muf * ak) * u_s) / etafk
        # warmup_class2.m:68-72
        hlk1 = lam1 - (Hu(X, u_s) - b) / bk
        hLk2X = Lam2X - (X - WX) / bk - (ak / bk) * (PiX - WX)
        hlk2s = lam2s - (u_s - w_s) / bk - (ak / bk) * (pi_s - w_s)
        cAwX = -Htb_X - WX
        cAw_s = -Htb_s - w_s
        HtX, Ht_s = op.apply_Ht(hlk1, p, q, Phi)
        ddX = etafk * wuX - ak ** 2 * (C + (HtX + hLk2X) + sgk * cAwX)
        dd_s = etafk * wu_s - ak ** 2 * (Ht_s + hlk2s + sgk * cAw_s)
        # warmup_class2.m:74-77 — closed form via invHHt
        tt = sgk * ak ** 2
        sg = 1 + etafk / tt
        ff = op.inv_hht(Hu(ddX, dd_s), p, q, sg, Phi)
        HtfX, Htf_s = op.apply_Ht(ff, p, q, Phi)
        X1 = (ddX - HtfX) / (etafk + tt)
        u_s1 = (dd_s - Htf_s) / (etafk + tt)
        # warmup_class2.m:79-86
        VX1 = X1 + (X1 - X) / ak
        v_s1 = u_s1 + (u_s1 - u_s) / ak
        b0 = Hu(VX1, v_s1) - b
        bLk2X = Lam2X + (ak / bk) * (VX1 - PiX)
        blk2s = lam2s + (ak / bk) * (v_s1 - pi_s)
        WX1 = op.prox_nonneg(wwX - ak ** 2 / etagk * (-bLk2X))
        w_s1 = op.prox_nonneg(ww_s - ak ** 2 / etagk * (-blk2s))
        PiX1 = WX1 + (WX1 - WX) / ak
        pi_s1 = w_s1 + (w_s1 - w_s) / ak
        lam1 = lam1 + (ak / bk) * b0
        Lam2X = Lam2X + (ak / bk) * (VX1 - PiX1)
        lam2s = lam2s + (ak / bk) * (v_s1 - pi_s1)
        gk, bk = gk1, bk1
        X, u_s, VX, v_s, WX, w_s, PiX, pi_s = (X1, u_s1, VX1, v_s1, WX1,
                                               w_s1, PiX1, pi_s1)
    return WarmStart2(X, u_s[:n], u_s[n:], lam1)
