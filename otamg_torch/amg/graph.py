"""Graph algorithms for AMG setup (port of ``otamg/amg/graph.py``).

* :func:`connected_components_bipartite` — min-label propagation with
  pointer jumping on the bipartite edge mask (replaces ``dmperm``,
  ``components.m:36``).
* :func:`strength_dense` — ``AMG/strength.m`` (symmetrized case 2) on a
  capacity-padded dense matrix with an activity mask.
* :func:`mis_dense` — the approximate-MIS C/F splitting of
  ``AMG/mis_set.m``, vectorised.

Each data-dependent loop reads one flag from the device per round.  The
random draws are :mod:`otamg_torch.random`'s, so the port picks the same
coarse points as the JAX package from the same key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otamg_torch import random as jr
from otamg_torch.device import fetch


def segment_sum(data: torch.Tensor, labels: torch.Tensor,
                nseg: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over int64 ``labels``."""
    out = torch.zeros(nseg, dtype=data.dtype, device=data.device)
    return out.index_add_(0, labels, data)


def connected_components_bipartite(E_mask: torch.Tensor,
                                   max_rounds: int = 64) -> torch.Tensor:
    """Component labels of the bipartite graph whose edges are
    ``E_mask[i, j] != 0`` between row node ``n + i`` and column node ``j``.

    Columns are nodes ``0..n-1``, rows ``n..n+m-1``.  Returns an
    ``(n + m,)`` int64 tensor; each label is the smallest node index in
    its component.
    """
    m, n = E_mask.shape
    has_edge = E_mask != 0
    big = n + m
    L = torch.arange(n + m, dtype=torch.int64, device=E_mask.device)
    for _ in range(max_rounds):
        lc, lr = L[:n], L[n:]
        # Hook: pull the minimum neighbour label across the edges.
        lr2 = torch.minimum(lr, torch.where(has_edge, lc[None, :],
                                            big).amin(dim=1))
        lc2 = torch.minimum(lc, torch.where(has_edge, lr2[:, None],
                                            big).amin(dim=0))
        L2 = torch.cat([lc2, lr2])
        # Compress: pointer-jump twice so label chains halve each round.
        L2 = L2[L2]
        L2 = L2[L2]
        changed = fetch(torch.any(L2 != L))
        L = L2
        if not changed:
            break
    return L


def component_stats(labels: torch.Tensor, weights: torch.Tensor):
    """Per-node component size and per-node sum of ``weights`` over the
    node's component."""
    N = labels.shape[0]
    sizes = segment_sum(torch.ones_like(weights), labels, N)
    wsums = segment_sum(weights, labels, N)
    return sizes[labels], wsums[labels]


def strength_dense(A: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Strength of connection (``AMG/strength.m``, symmetrized case 2):
    ``S_ij = a0_ij / min(maxrow_i, maxrow_j)`` with ``A0 = D - A``.
    Padded rows/columns give 0."""
    N = A.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=A.device)
    offmask = active[:, None] & active[None, :] & ~eye
    A0 = torch.where(offmask, -A, 0.0)
    max_row = torch.where(offmask, A0, -torch.inf).amax(dim=1)
    max_row = torch.where(max_row <= 0, torch.inf, max_row)
    denom = torch.minimum(max_row[:, None], max_row[None, :])
    return torch.where(offmask, A0 / denom, 0.0)


class CFSplit(NamedTuple):
    isC: torch.Tensor
    isF: torch.Tensor   # undecided leftovers are neither C nor F


def mis_dense(As: torch.Tensor, active: torch.Tensor, key: torch.Tensor,
              max_rounds: int = 64) -> CFSplit:
    """Approximate-MIS C/F splitting (``AMG/mis_set.m``), dense/masked:
    the random bail-out when too few nodes are connected (``:30-34``),
    random degree tie-breaking (``:35``), greedy local-max rounds
    (``:42-65``) stopping at ``|C| >= N/2`` or ``<= N0`` undecided, the
    isolated-node F assignment (``:40``) and the strength-isolated
    override to C (``:67``).  As in the JAX package the counts and draws
    are float32."""
    N = As.shape[0]
    dev = As.device
    f32 = torch.float32
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    connected = (deg0 > 0).sum().to(f32)
    kb, kt = jr.split(key)
    bail = fetch(connected < 0.25 * torch.sqrt(Ncnt))

    if bail:
        # Too few connected nodes: pick ~N0 random active coarse nodes.
        score = jr.uniform(kb, (N,), f32, dev)
        score = torch.where(active, score, torch.inf)
        rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
        isC = active & (rank < N0.to(rank.dtype))
        isF = active & ~isC
    else:
        tie = torch.tensor(0.1, dtype=f32) * jr.uniform(kt, (N,), f32)
        deg = torch.where(deg0 > 0, deg0 + tie.to(dev), 0.0)
        isF = active & (deg0 == 0)
        isC = torch.zeros(N, dtype=torch.bool, device=dev)
        isU = active & ~isF
        for _ in range(max_rounds):
            go = ((isC.sum() < Ncnt / 2) & (isU.sum() > N0))
            if not fetch(go):
                break
            isS = deg > 0
            # Local max degree within the selected subgraph survives.
            nbrmax = torch.where(As & isS[None, :], deg[None, :],
                                 -torch.inf).amax(dim=1)
            sel = isS & (deg > nbrmax)
            isC = isC | sel
            nbrC = torch.any(As & isC[None, :], dim=1)
            isF = isF | (nbrC & active & ~isC)
            isU = active & ~(isF | isC)
            deg = torch.where(isU, deg, 0.0)
            # <= N0 undecided left: absorb them into C (mis_set.m:60-63).
            absorb = isU.sum() <= N0
            isC = isC | (absorb & isU)
            isU = isU & ~absorb
        # Tiny-level guard: an empty C set would zero every deeper level,
        # so the undecided nodes are absorbed into C.
        isC = isC | (~torch.any(isC) & isU)
        isF = isF & ~isC
    # Strength-isolated nodes are forced to C (mis_set.m:67).
    iso = active & ~torch.any(As, dim=1)
    return CFSplit(isC | iso, isF & ~iso)
