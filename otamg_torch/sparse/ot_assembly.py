"""Sparse assembly of the OT KKT block ``H0 = A diag(s) A^T`` (reference
``ASAt.m``) into a padded COO (port of ``otamg/sparse/ot_assembly.py``).

The structured solver path never forms ``H0``; this is its assembled
form for the general sparse pipeline.  The off-diagonal blocks' pattern
is the active-set mask, so assembly is a masked scatter.
"""

from __future__ import annotations

import torch

from otamg_torch.sparse.containers import COO


def asat_coo(S: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
             capacity: int | None = None) -> COO:
    """``H0`` as an ``(n+m) x (n+m)`` padded COO, node order [n-block;
    m-block] as ``ASAt.m:14-19``:
    ``H0 = [[diag(Y^T p^2), diag(q) Y^T diag(p)],
            [diag(p) Y diag(q), diag(Y q^2)]]``.
    Capacity defaults to ``2 m n + n + m`` (the dense mask's worst case);
    the nonzeros come first in row-major order."""
    m, n = S.shape
    N = n + m
    dev = S.device
    if capacity is None:
        capacity = 2 * m * n + N
    d1 = S.T @ (p * p)
    d2 = S @ (q * q)
    # off-diagonal entries q_j p_i s_ij at (j, n+i) and (n+i, j)
    v_up = (q[:, None] * S.T * p[None, :]).reshape(-1)
    jj = torch.arange(n, dtype=torch.int32, device=dev)
    ii = n + torch.arange(m, dtype=torch.int32, device=dev)
    rows_up = jj.repeat_interleave(m)
    cols_up = ii.repeat(n)
    rows = torch.cat([jj, ii, rows_up, cols_up])
    cols = torch.cat([jj, ii, cols_up, rows_up])
    vals = torch.cat([d1, d2, v_up, v_up])
    merged = COO((N, N), rows, cols, vals,
                 torch.tensor(vals.shape[0], device=dev)).sum_duplicates()
    # compact the nonzeros to the front within the capacity
    nz = merged.vals != 0
    order = torch.argsort((~nz).to(torch.uint8), stable=True)[:capacity]
    nnz = nz.sum()
    keep = torch.arange(capacity, device=dev) < nnz
    return COO((N, N), torch.where(keep, merged.rows[order], 0),
               torch.where(keep, merged.cols[order], 0),
               torch.where(keep, merged.vals[order], 0),
               nnz.clamp(max=capacity))
