"""Graph algorithms for AMG setup (port of ``otamg/amg/graph.py``).

* :func:`connected_components_bipartite` — min-label propagation with
  pointer jumping on the bipartite edge mask (replaces ``dmperm``,
  ``components.m:36``).
* :func:`strength_dense` — ``AMG/strength.m`` (symmetrized case 2) on a
  capacity-padded dense matrix with an activity mask.
* :func:`mis_dense` — the approximate-MIS C/F splitting of
  ``AMG/mis_set.m``, vectorised.

Each data-dependent loop reads one flag from the device per block of
``exit_every`` rounds (1: every round).  Rounds past the exit inside a
block change nothing (label propagation is at its fixpoint; the MIS
state is frozen by ``torch.where``), so the block size never changes the
result.  The random draws are :mod:`otamg_torch.random`'s, so the port
picks the same coarse points as the JAX package from the same key.
:func:`segment_sum` is :func:`otamg_torch.sparse.segment.segment_sum`,
deterministic on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otamg_torch import random as jr
from otamg_torch.device import fetch
from otamg_torch.sparse.segment import segment_sum  # noqa: F401


def connected_components_bipartite(E_mask: torch.Tensor,
                                   max_rounds: int = 64,
                                   exit_every: int = 1) -> torch.Tensor:
    """Component labels of the bipartite graph whose edges are
    ``E_mask[i, j] != 0`` between row node ``n + i`` and column node ``j``.

    Columns are nodes ``0..n-1``, rows ``n..n+m-1``.  Returns an
    ``(n + m,)`` int64 tensor; each label is the smallest node index in
    its component.  The rounds run in blocks of ``exit_every`` with one
    read each: a round at the fixpoint leaves the labels as they are.
    """
    m, n = E_mask.shape
    has_edge = E_mask != 0
    L = torch.arange(n + m, dtype=torch.int64, device=E_mask.device)
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(exit_every, max_rounds - rounds)):
            L2 = label_round(has_edge, L)
            changed = torch.any(L2 != L)
            L = L2
            rounds += 1
        if not fetch(changed):
            break
    return L


def label_round(has_edge: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """One round of :func:`connected_components_bipartite`: hook each
    node to its smallest neighbour label, then jump pointers twice."""
    m, n = has_edge.shape
    lc, lr = L[:n], L[n:]
    # Hook: pull the minimum neighbour label across the edges.
    lr2 = torch.minimum(lr, torch.where(has_edge, lc[None, :],
                                        n + m).amin(dim=1))
    lc2 = torch.minimum(lc, torch.where(has_edge, lr2[:, None],
                                        n + m).amin(dim=0))
    L2 = torch.cat([lc2, lr2])
    # Compress: pointer-jump twice so label chains halve each round.
    L2 = L2[L2]
    return L2[L2]


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
              max_rounds: int = 64, exit_every: int = 1) -> CFSplit:
    """Approximate-MIS C/F splitting (``AMG/mis_set.m``), dense/masked:
    the random bail-out when too few nodes are connected (``:30-34``),
    random degree tie-breaking (``:35``), greedy local-max rounds
    (``:42-65``) stopping at ``|C| >= N/2`` or ``<= N0`` undecided, the
    isolated-node F assignment (``:40``) and the strength-isolated
    override to C (``:67``).  As in the JAX package the counts and draws
    are float32.

    With ``exit_every > 1`` the rounds run in blocks of that many, the
    state frozen once the round test fails, with one read a block; the
    bail-out test rides on the first block's read (the block's rounds are
    discarded when it bails)."""
    N = As.shape[0]
    dev = As.device
    f32 = torch.float32
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    connected = (deg0 > 0).sum().to(f32)
    kb, kt = jr.split(key)
    bail_t = connected < 0.25 * torch.sqrt(Ncnt)
    bail = exit_every == 1 and fetch(bail_t)

    if not bail:
        tie = torch.tensor(0.1, dtype=f32) * jr.uniform(kt, (N,), f32)
        deg = torch.where(deg0 > 0, deg0 + tie.to(dev), 0.0)
        isF = active & (deg0 == 0)
        isC = torch.zeros(N, dtype=torch.bool, device=dev)
        isU = active & ~isF

        def go_of(isC, isU):
            return (isC.sum() < Ncnt / 2) & (isU.sum() > N0)

        def mis_round(isC, isF, isU, deg):
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
            return isC, isF, isU, deg

        go = go_of(isC, isU)
        if exit_every == 1:
            for _ in range(max_rounds):
                if not fetch(go):
                    break
                isC, isF, isU, deg = mis_round(isC, isF, isU, deg)
                go = go_of(isC, isU)
        else:
            rounds, more = 0, True
            while more and rounds < max_rounds or rounds == 0:
                first = rounds == 0
                for _ in range(min(exit_every, max_rounds - rounds)):
                    new = mis_round(isC, isF, isU, deg)
                    isC, isF, isU, deg = (torch.where(go, a, b) for a, b in
                                          zip(new, (isC, isF, isU, deg)))
                    go = go_of(isC, isU)
                    rounds += 1
                if first:
                    bail, more = fetch(torch.stack([bail_t, go]))
                else:
                    more = fetch(go)
                if bail or max_rounds == 0:
                    break
    if bail:
        # Too few connected nodes: pick ~N0 random active coarse nodes.
        score = jr.uniform(kb, (N,), f32, dev)
        score = torch.where(active, score, torch.inf)
        rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
        isC = active & (rank < N0.to(rank.dtype))
        isF = active & ~isC
    else:
        # Tiny-level guard: an empty C set would zero every deeper level,
        # so the undecided nodes are absorbed into C.
        isC = isC | (~torch.any(isC) & isU)
        isF = isF & ~isC
    # Strength-isolated nodes are forced to C (mis_set.m:67).
    iso = active & ~torch.any(As, dim=1)
    return CFSplit(isC | iso, isF & ~iso)
