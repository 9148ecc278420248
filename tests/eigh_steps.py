"""``otamg_torch/csrc/coarse_eigh.cu``'s method step by step in torch ops
on the CPU, for the tests (:func:`coarse_eigh_steps_plain`).  The port
itself runs ``torch.linalg.eigh`` on the CPU
(``otamg_torch.amg.kernels.coarse_eigh_plain``) and the kernel on a card;
this module lets the CPU tests check the kernel's method, its cluster
handling above all, where no card is present."""

from __future__ import annotations

import torch


# The method's constants; ``otamg_torch/csrc/coarse_eigh.cu`` has the same.
EIGH_LANES = 4          # points a multisection round tests per eigenvalue
EIGH_MAX_ROUNDS = 64    # multisection rounds before info = 1
EIGH_MAX_ITS = 5        # inverse iterations before info = 1
EIGH_EXTRA = 1          # iterations after the growth test first passes
EIGH_NU_MIN = 1 / 16    # least norm a clustered vector keeps through MGS
EIGH_RETRIES = 3        # solves that may restore it before info = 1
_FUDGE = 2.1            # xSTEBZ's widening of the Gershgorin interval


def _start_vector(rows: torch.Tensor, slot: int, dtype) -> torch.Tensor:
    """The inverse iteration's start vector of eigenvalue slot ``slot``
    on ``rows``: a murmur3 finaliser of ``(row, slot)``, 24 bits mapped
    to [-1, 1) (exact in f32 and f64, as in the kernel)."""
    m = 0xFFFFFFFF
    h = (rows * 2654435761 + slot * 2246822519 + 3266489917) & m
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & m
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & m
    h = h ^ (h >> 16)
    return (h >> 8).to(dtype) * 2.0 ** -23 - 1.0


def _tridiagonalize(A: torch.Tensor):
    """Householder reduction of the symmetric matrix whose lower triangle
    ``A`` holds (LAPACK ``xSYTD2``, lower): ``(d, e, tau, R)`` with
    ``A = Q T Q^T``, ``Q = H_0 ... H_{n-3}``, ``H_k = I - tau_k v_k
    v_k^T`` on rows ``k+1..n-1``, and ``v_k`` (its first entry 1) in
    ``R[k, k+1:]``.  The update of step k is ``A22 -= v w^T + w v^T``
    with ``p = tau A22 v`` and ``w = p - tau/2 (p^T v) v``, here on the
    whole square (the kernel updates the lower triangle); a zero column
    gives ``tau = 0`` and no update."""
    n = A.shape[0]
    R = torch.tril(A) + torch.tril(A, -1).T
    d, e = A.new_zeros(n), A.new_zeros(n)
    tau = A.new_zeros(n)
    for k in range(n - 2):
        x = R[k, k + 1:]
        alpha = x[0].clone()
        ss = (x[1:] * x[1:]).sum()
        d[k] = R[k, k]
        if ss == 0:
            e[k], t = alpha, 0.0
            x[0] = 1.0
        else:
            beta = -torch.copysign(torch.sqrt(alpha * alpha + ss), alpha)
            e[k], t = beta, (beta - alpha) / beta
            x[1:] = x[1:] * (1.0 / (alpha - beta))
            x[0] = 1.0
        tau[k] = t
        if t != 0:
            v = x
            B = R[k + 1:, k + 1:]
            p = t * (B @ v)
            w = p - (0.5 * t * (p @ v)) * v
            B -= v[:, None] * w[None, :] + w[:, None] * v[None, :]
    if n >= 2:
        d[n - 2], e[n - 2] = R[n - 2, n - 2], R[n - 1, n - 2]
    if n >= 1:
        d[n - 1] = R[n - 1, n - 1]
    return d, e, tau, R


def _split(d, e):
    """xSTEBZ's splitting: ``e_i`` becomes 0 where ``e_i^2 <= |d_i
    d_{i+1}| ulp^2 + safemin``.  Returns ``(e, e2, pivmin, first, last)``,
    ``first``/``last`` the bounds of each row's block."""
    n = d.shape[0]
    fi = torch.finfo(d.dtype)
    ulp, tiny = fi.eps, fi.tiny
    e = e.clone()
    e2 = e * e
    split = torch.zeros(n, dtype=torch.bool)
    if n > 1:
        split[:n - 1] = (d[:-1] * d[1:]).abs() * (ulp * ulp) + tiny > e2[:n - 1]
    split[n - 1] = True
    e = torch.where(split, 0.0, e)
    e2 = torch.where(split, 0.0, e2)
    pivmin = tiny * max(1.0, float(e2.max()) if n else 1.0)
    first, last = torch.empty(n, dtype=torch.int64), torch.empty(
        n, dtype=torch.int64)
    b0 = 0
    for i in range(n):
        if split[i]:
            first[b0:i + 1], last[b0:i + 1] = b0, i
            b0 = i + 1
    return e, e2, pivmin, first, last


def _sturm(d, e2, x, b0, b1, pivmin):
    """xSTEBZ's count of the eigenvalues of the block ``b0..b1`` of T at
    or below ``x`` (any shape)."""
    q = d[b0] - x
    q = torch.where(q.abs() < pivmin, -pivmin, q)
    cnt = (q <= 0).to(torch.int64)
    for i in range(b0 + 1, b1 + 1):
        q = (d[i] - e2[i - 1] / q) - x
        q = torch.where(q.abs() < pivmin, -pivmin, q)
        cnt += q <= 0
    return cnt


def _bisect(d, e, e2, pivmin, first, last):
    """Every eigenvalue of the split T by multisection on Sturm counts,
    block by block (slot ``s`` is eigenvalue ``s - first[s]`` of its
    block, ascending; a 1x1 block's is its ``d``): each round tests
    :data:`EIGH_LANES` evenly spaced points of the interval and keeps
    the piece that holds the eigenvalue, until its width is under
    xSTEBZ's ``max(ulp tnorm, pivmin, 2 ulp max(|lo|, |hi|))`` or stops
    shrinking.  ``(lam, converged)``."""
    n = d.shape[0]
    ulp = torch.finfo(d.dtype).eps
    L = EIGH_LANES
    frac = torch.arange(1, L + 1, dtype=d.dtype)
    lam = d.clone()
    ok = True
    b0 = 0
    while b0 < n:
        b1 = int(last[b0])
        nb = b1 - b0 + 1
        if nb > 1:
            ea = e[b0:b1 + 1].abs()  # e[b1] is 0: the block's end
            left = torch.cat([ea.new_zeros(1), ea[:-1]])
            gl = float((d[b0:b1 + 1] - left - ea).min())
            gu = float((d[b0:b1 + 1] + left + ea).max())
            tnorm = max(abs(gl), abs(gu))
            atol = max(ulp * tnorm, pivmin)
            gl -= _FUDGE * tnorm * ulp * nb + _FUDGE * 2 * pivmin
            gu += _FUDGE * tnorm * ulp * nb + _FUDGE * pivmin
            kk = torch.arange(nb)
            lo = torch.full((nb,), gl, dtype=d.dtype)
            hi = torch.full((nb,), gu, dtype=d.dtype)
            done = torch.zeros(nb, dtype=torch.bool)
            for r in range(EIGH_MAX_ROUNDS + 1):
                tol = torch.clamp_min(
                    2 * ulp * torch.maximum(lo.abs(), hi.abs()), atol)
                done |= (hi - lo) < tol
                if bool(done.all()) or r == EIGH_MAX_ROUNDS:
                    break
                x = lo[:, None] + frac[None, :] * ((hi - lo) / (L + 1))[:, None]
                above = _sturm(d, e2, x, b0, b1, pivmin) > kk[:, None]
                at = torch.where(above.any(dim=1),
                                 above.int().argmax(dim=1), L)
                xs = torch.cat([lo[:, None], x, hi[:, None]], dim=1)
                nlo = xs.gather(1, at[:, None])[:, 0]
                nhi = xs.gather(1, at[:, None] + 1)[:, 0]
                moved = (nlo != lo) | (nhi != hi)
                lo = torch.where(done, lo, nlo)
                hi = torch.where(done, hi, nhi)
                done |= ~moved
            ok = ok and bool(done.all())
            lam[b0:b1 + 1] = 0.5 * (lo + hi)
        b0 = b1 + 1
    return lam, ok


def _factor(dd, ee, x):
    """xLAGTF's LU with partial pivoting of ``T_b - x I`` (``T_b`` the
    block with diagonal ``dd`` and off-diagonal ``ee``), for every shift
    of ``x`` at once: ``(u, u1, u2, l, piv)``, rows by shifts, with U's
    diagonal, first and second superdiagonals, L's multipliers and the
    row swaps."""
    nb = dd.shape[0]
    u, u1, u2, l = (x.new_zeros(nb, x.shape[0]) for _ in range(4))
    piv = torch.zeros(nb, x.shape[0], dtype=torch.bool)
    a = dd[0] - x
    b = ee[0].expand_as(x).clone()
    scale1 = a.abs() + b.abs()
    for r in range(nb - 1):
        c = ee[r]
        an = dd[r + 1] - x
        bn = (ee[r + 1] if r < nb - 2 else ee.new_zeros(())).expand_as(x)
        scale2 = c.abs() + an.abs() + bn.abs()
        piv1 = torch.where(a == 0, 0.0, a.abs() / scale1)
        piv2 = c.abs() / scale2
        keep = piv2 <= piv1
        # No swap: L's multiplier c / a.
        l_k = c / a
        an_k = an - l_k * b
        # Swap rows r and r + 1.
        mult = a / c
        an_s = b - mult * an
        d2_s = bn
        u[r] = torch.where(keep, a, c)
        u1[r] = torch.where(keep, b, an)
        u2[r] = torch.where(keep, 0.0, d2_s)
        l[r] = torch.where(keep, l_k, mult)
        piv[r] = ~keep
        scale1 = torch.where(keep, scale2, scale1)
        a = torch.where(keep, an_k, an_s)
        b = torch.where(keep, bn, -mult * d2_s)
    u[nb - 1] = a
    return u, u1, u2, l, piv


def _solve(y, u, u1, u2, l, piv, tol):
    """xLAGTS (job -1) with the factors of :func:`_factor`, in place on
    ``y`` (rows by shifts): L's row swaps and multipliers, then U, where
    a pivot under 1 whose quotient would overflow (or a zero one) grows
    by ``tol``, doubling, as xLAGTS does."""
    nb = y.shape[0]
    tiny = torch.finfo(y.dtype).tiny
    big = 1.0 / tiny
    for k in range(1, nb):
        ya, yb = y[k - 1].clone(), y[k].clone()
        y[k - 1] = torch.where(piv[k - 1], yb, ya)
        y[k] = torch.where(piv[k - 1], ya - l[k - 1] * yb,
                           yb - l[k - 1] * ya)
    for k in range(nb - 1, -1, -1):
        t = y[k].clone()
        if k + 1 < nb:
            t = t - u1[k] * y[k + 1]
        if k + 2 < nb:
            t = t - u2[k] * y[k + 2]
        ak = u[k].clone()
        pert = torch.where(ak >= 0, tol, -tol)
        while True:
            a = ak.abs()
            grow = (a < 1) & torch.where(a < tiny,
                                         (a == 0) | (t.abs() * tiny > a),
                                         t.abs() > a * big)
            if not bool(grow.any()):
                break
            ak = torch.where(grow, ak + pert, ak)
            pert = torch.where(grow, 2 * pert, pert)
        sub = ak.abs() < tiny
        t = torch.where(sub, t * big, t)
        ak = torch.where(sub, ak * big, ak)
        y[k] = t / ak
    return y


def _unit(y):
    """``y / ||y||_2`` with its first entry of largest magnitude positive
    (xSTEIN's sign), per column."""
    jmax = y.abs().argmax(dim=0)
    top = y.gather(0, jmax[None, :])[0]
    ymax = top.abs()
    ss = ((y / ymax) ** 2).sum(dim=0)
    return y * (torch.sign(top) / (ymax * torch.sqrt(ss)))


def _mgs(z, Z):
    """``z`` minus its components along the columns of ``Z``, modified
    Gram-Schmidt, twice."""
    for _ in range(2):
        for i in range(Z.shape[1]):
            z = z - (Z[:, i] @ z) * Z[:, i]
    return z


def _block_vectors(dd, ee, x, b0):
    """Eigenvectors of the block ``T_b`` for its shifts ``x`` (ascending,
    xSTEIN's perturbation applied), in rows of the block: inverse
    iteration from :func:`_start_vector`, each shift on its own, then
    modified Gram-Schmidt inside each cluster (neighbouring shifts within
    ``1e-3 ||T_b||_1``), in order, with a further solve where a vector
    keeps less than :data:`EIGH_NU_MIN` of its norm.  ``(Z, ok)``."""
    nb, ns = dd.shape[0], x.shape[0]
    dt = dd.dtype
    eps = torch.finfo(dt).eps
    left = torch.cat([ee.new_zeros(1), ee[:-1]])
    onenrm = float((dd.abs() + left.abs() + ee.abs()).max())
    ortol = 1e-3 * onenrm
    dtpcrt = (0.1 / nb) ** 0.5
    u, u1, u2, l, piv = _factor(dd, ee, x)
    tol = eps * torch.maximum(torch.maximum(u.abs(), u1.abs()),
                              u2.abs()).amax(dim=0)
    tol = torch.where(tol == 0, eps, tol)
    # xSTEIN scales each right-hand side to this infinity norm.
    scl = nb * onenrm * torch.clamp_min(u[nb - 1].abs(), eps)
    factors = (u, u1, u2, l, piv, tol)
    rows = torch.arange(b0, b0 + nb)
    y = torch.stack([_start_vector(rows, b0 + j, dt) for j in range(ns)],
                    dim=1)
    nrmchk = torch.zeros(ns, dtype=torch.int64)
    active = torch.ones(ns, dtype=torch.bool)
    for _ in range(EIGH_MAX_ITS):
        x1 = _solve(y * (scl / y.abs().amax(dim=0)), *factors)
        nrmchk += active & (x1.abs().amax(dim=0) >= dtpcrt)
        y = torch.where(active, x1, y)
        active = active & (nrmchk < EIGH_EXTRA + 1)
        if not bool(active.any()):
            break
    ok = not bool(active.any())
    Z = _unit(y)
    j0 = 0
    for j in range(1, ns + 1):
        if j < ns and abs(float(x[j] - x[j - 1])) <= ortol:
            continue
        for jj in range(j0 + 1, j):
            z, ref = Z[:, jj], 1.0
            for attempt in range(EIGH_RETRIES + 1):
                z = _mgs(z, Z[:, j0:jj])
                nu = float(torch.linalg.vector_norm(z)) / ref
                if nu >= EIGH_NU_MIN:
                    break
                if attempt == EIGH_RETRIES:
                    ok = False
                    break
                zmax = z.abs().max()
                if zmax == 0:
                    z, zmax = _start_vector(rows, b0 + jj, dt), 1.0
                z = _solve((z * (scl[jj] / zmax))[:, None],
                           *(f[..., jj:jj + 1] for f in factors))[:, 0]
                ref = float(torch.linalg.vector_norm(z))
            Z[:, jj] = _unit(z[:, None])[:, 0]
        j0 = j
    return Z, ok


def _perturb(lam, first):
    """xSTEIN's shifts: inside a block, a shift closer than ``10 eps
    |x|`` above the previous one moves up to that distance."""
    eps = torch.finfo(lam.dtype).eps
    x = lam.clone()
    for s in range(1, lam.shape[0]):
        if first[s] != s:
            pertol = 10 * abs(eps * float(x[s]))
            if float(x[s] - x[s - 1]) < pertol:
                x[s] = x[s - 1] + pertol
    return x


def coarse_eigh_steps_plain(A: torch.Tensor):
    """``csrc/coarse_eigh.cu``'s method step by step in torch ops
    (``otamg_torch.amg.kernels.coarse_eigh`` runs ``coarse_eigh_plain``
    on the CPU):
    Householder tridiagonalisation, xSTEBZ's splitting, multisection on
    Sturm counts block by block, xSTEIN's inverse iteration with
    modified Gram-Schmidt inside clusters, the eigenpairs sorted, then
    the reflectors applied to the eigenvectors.  ``(lam, V, info)``."""
    n = A.shape[0]
    d, e, tau, R = _tridiagonalize(A.cpu())
    e, e2, pivmin, first, last = _split(d, e)
    lam, ok = _bisect(d, e, e2, pivmin, first, last)
    x = _perturb(lam, first)
    Z = d.new_zeros(n, n)
    b0 = 0
    while b0 < n:
        b1 = int(last[b0])
        if b1 == b0:
            Z[b0, b0] = 1.0
        else:
            Zb, okb = _block_vectors(d[b0:b1 + 1], e[b0:b1 + 1],
                                     x[b0:b1 + 1], b0)
            Z[b0:b1 + 1, b0:b1 + 1] = Zb
            ok = ok and okb
        b0 = b1 + 1
    order = sorted(range(n), key=lambda s: (float(lam[s]), s))
    lam, V = lam[order], Z[:, order]
    for k in range(n - 3, -1, -1):
        if tau[k] != 0:
            v = R[k, k + 1:]
            V[k + 1:] -= tau[k] * v[:, None] * (v @ V[k + 1:])[None, :]
    info = torch.tensor(0 if ok else 1, dtype=torch.int32)
    return lam.to(A.device), V.to(A.device), info.to(A.device)
