"""The method of ``otamg_torch/csrc/bip_smooth.cu`` in torch ops, so the
CPU tests check its algorithm where the kernel cannot run: the same
partition of ``E``'s rows over a cluster of 16 blocks, the same products
(a warp a row: 32 lanes over the columns, then a butterfly; a block's
share of ``E^T y`` summed over its rows in order, the 16 shares added in
block order), the same chunked segmented scan over the level's pair plan
for the segment sums, and the same sweep algebra.  The kernel contracts
products and sums into fused multiply-adds where this form rounds twice,
so the two agree to rounding, not bit for bit."""

from __future__ import annotations

import torch

BLOCKS = 16    # the cluster
THREADS = 512  # a block
LANES = 32


def row_dots(E: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``E x`` a warp a row: lane ``l`` sums columns ``l, l + 32, ...`` in
    order, then five butterfly steps (``v += v[lane ^ o]``), lane 0's
    value."""
    m, n = E.shape
    W = -(-n // LANES)
    Ep = E.new_zeros(m, W * LANES)
    Ep[:, :n] = E
    xp = x.new_zeros(W * LANES)
    xp[:n] = x
    acc = E.new_zeros(m, LANES)
    for w in range(W):
        acc = acc + Ep[:, w * LANES:(w + 1) * LANES] * \
            xp[w * LANES:(w + 1) * LANES]
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, 0]


def col_shares(E: torch.Tensor, y: torch.Tensor, R: int) -> torch.Tensor:
    """``(16, n)``: block ``b``'s share of ``E^T y``, its rows ``[b R, b R
    + R)`` summed in order."""
    m, n = E.shape
    Ep = E.new_zeros(BLOCKS * R, n)
    Ep[:m] = E
    yp = y.new_zeros(BLOCKS * R)
    yp[:m] = y
    Eb, yb = Ep.view(BLOCKS, R, n), yp.view(BLOCKS, R)
    acc = E.new_zeros(BLOCKS, n)
    for k in range(R):
        acc = acc + Eb[:, k, :] * yb[:, k, None]
    return acc


def add_shares(shares: torch.Tensor) -> torch.Tensor:
    """The 16 shares added in block order."""
    out = torch.zeros_like(shares[0])
    for b in range(BLOCKS):
        out = out + shares[b]
    return out


def _scan(acc, f, width: int):
    """Inclusive segmented scan of ``(f, acc)`` along the last axis of
    ``width`` lanes, by the kernel's shuffle steps."""
    lane = torch.arange(width)
    o = 1
    while o < width:
        vo = torch.roll(acc, o, dims=-1)
        fo = torch.roll(f, o, dims=-1)
        take = lane >= o
        acc = torch.where(take & ~f, vo + acc, acc)
        f = torch.where(take, f | fo, f)
        o <<= 1
    return acc, f


def segment_sums(vals: torch.Tensor, order: torch.Tensor,
                 offsets: torch.Tensor, nseg: int) -> torch.Tensor:
    """The segment sums of ``vals`` (one a node) over the plan: thread
    ``t`` scans positions ``[t K, t K + K)`` in order (a run's first
    position restarts the sum), the 512 chunk sums are scanned a warp at
    a time and then over the 16 warps' sums, and a segment's total is
    its last position's prefix plus, where its run started in an earlier
    chunk, the sum carried into that chunk."""
    off = offsets.long()
    L = int(off[nseg])
    K = max(1, -(-L // THREADS))
    v = vals.new_zeros(THREADS * K)
    v[:L] = vals[order[:L].long()]
    flag = torch.zeros(THREADS * K, dtype=torch.bool)
    lo, hi = off[:-1], off[1:]
    flag[lo[lo < hi]] = True
    v, flag = v.view(THREADS, K), flag.view(THREADS, K)
    acc = vals.new_zeros(THREADS)
    f = torch.zeros(THREADS, dtype=torch.bool)
    sc = vals.new_zeros(THREADS, K)
    for k in range(K):
        acc = torch.where(flag[:, k], torch.zeros_like(acc), acc)
        f = f | flag[:, k]
        acc = acc + v[:, k]
        sc[:, k] = acc
    warps = THREADS // LANES
    A, F = _scan(acc.view(warps, LANES), f.view(warps, LANES), LANES)
    wt, wf = _scan(A[:, -1], F[:, -1], warps)
    prev_w = torch.cat([vals.new_zeros(1), wt[:-1]])
    has_prev = torch.arange(warps) > 0
    A = torch.where(has_prev[:, None] & ~F, prev_w[:, None] + A, A)
    carry = torch.cat([prev_w[:, None], A[:, :-1]], dim=1).reshape(-1)
    sc = sc.reshape(-1)
    tot = vals.new_zeros(nseg)
    nonempty = lo < hi
    q = (hi - 1).clamp_min(0)
    t = q // K
    whole = lo >= t * K
    tot = torch.where(whole, sc[q], carry[t] + sc[q])
    return torch.where(nonempty, tot, torch.zeros_like(tot))


def bip_smooth_steps_plain(lv, e, r, smoth_it: int, transpose: bool,
                           nseg: int, deflated: bool, e_is_zero: bool):
    """``kernels.bip_smooth_plain``'s result by the kernel's method (one
    block's view: every block holds the same state)."""
    E = lv.E
    m, n = E.shape
    N = n + m
    R = -(-m // BLOCKS)
    dt = r.dtype
    itk = lv.inv_tk
    g = lv.g
    xi = lv.nsp.to(dt)
    lab = lv.labels.long()
    inside = (lab >= 0) & (lab < nseg)
    labc = lab.clamp(0, nseg - 1)
    order, offsets = lv.plan.order, lv.plan.offsets

    def at_label(v):
        return torch.where(inside, v[labc], torch.zeros_like(r))

    def coef(tot):
        x = lv.xx
        sx = torch.where((x > 0) | (x < 0), x, torch.ones_like(x))
        return torch.where(lv.nsp, at_label(tot) / sx, torch.zeros_like(r))

    if e_is_zero:
        e = torch.zeros(N, dtype=dt)
        p = torch.zeros(N, dtype=dt)
    else:
        e = e.clone()
        p = torch.cat([add_shares(col_shares(E, e[n:], R)),
                       row_dots(E, e[:n])])
    if deflated:
        cnt = segment_sums(xi, order, offsets, nseg)
        cnt = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    Etx = torch.cat([lv.Etxi2, lv.Exi1])
    for _ in range(smoth_it):
        d = (r - g * e) + itk * p
        c = torch.zeros_like(r)
        if not deflated:
            tot = segment_sums(d * xi, order, offsets, nseg)
            c = coef(tot)
            d = d - lv.Axi * c
        if not transpose:
            d1 = d[:n] / g[:n]
            t = row_dots(E, d1)
            d2 = (d[n:] + itk * t) / g[n:]
            tw = add_shares(col_shares(E, d2, R))
        else:
            d2 = d[n:] / g[n:]
            tw = add_shares(col_shares(E, d2, R))
            d1 = (d[:n] + itk * tw) / g[:n]
            t = row_dots(E, d1)
        d = torch.cat([d1, d2])
        prod = torch.cat([tw, t])
        if deflated:
            e = e + d
            p = p + prod
            tot = segment_sums(e * xi, order, offsets, nseg)
            mk = torch.where(lv.nsp & inside, at_label(tot) / at_label(cnt),
                             torch.zeros_like(r))
            e = torch.where(lv.nsp & inside, e - mk, e)
            p = torch.where(lv.nsp & inside, p - mk * Etx, p)
        else:
            e = (e + xi * c) + d
            p = (p + c * Etx) + prod
    return e
