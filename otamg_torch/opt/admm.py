"""A-ADMM warm start, Class 1 (port of ``otamg/opt/admm.py``).

Accelerated ADMM producing the initial pair ``(x0, lambda0)`` for the APD
loop (reference ``Class1/warmup_class1.m``).  Every iteration is closed
form: the x-update solves its KKT system exactly through the O(m+n)
``inv_aat`` — no inner iteration and no host read.  ``warmup_class2`` is
a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otamg_torch.ot import operators as op
from otamg_torch.ot.problems import Class1Problem


class WarmStart1(NamedTuple):
    X: torch.Tensor      # (m, n) primal plan
    lam: torch.Tensor    # (n + m,) equality multipliers


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
