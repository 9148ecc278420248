"""Graph algorithms for AMG setup (port of ``otamg/amg/graph.py``).

* :func:`connected_components_bipartite` — min-label propagation with
  pointer jumping on the bipartite edge mask (replaces ``dmperm``,
  ``components.m:36``); on a card one launch of the ``labels`` kernel
  (:func:`otamg_torch.amg.kernels.label_rounds`) that reads nothing on
  the host.
* :func:`strength_dense` — ``AMG/strength.m`` (symmetrized case 2) on a
  capacity-padded dense matrix with an activity mask.
* :func:`mis_dense` — the approximate-MIS C/F splitting of
  ``AMG/mis_set.m``, vectorised; its greedy rounds are one launch of the
  ``mis`` kernel on a card (:func:`otamg_torch.amg.kernels.mis_rounds`)
  and read nothing on the host.

On the CPU label propagation reads one flag from the device per block
of ``exit_every`` rounds (1: every round).  Rounds past the exit inside
a block change nothing (label propagation is at its fixpoint), so the
block size never changes the result.  Under a mesh the flag is
replicated there: it comes from labels reduced over the ranks (a
minimum and a gather in every round), so every rank leaves the loop
after the same block and makes the same collectives.  On a card every
rank gathers the mask once and runs the kernel on the whole of it.  The random draws are :mod:`otamg_torch.random`'s,
so the port picks the same coarse points as the JAX package from the
same key.
:func:`segment_sum` is :func:`otamg_torch.sparse.segment.segment_sum`,
deterministic on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otamg_torch import random as jr
from otamg_torch.amg.kernels import label_round, label_rounds, mis_rounds
from otamg_torch.device import fetch
from otamg_torch.dist import api
from otamg_torch.sparse.segment import segment_sum  # noqa: F401


def connected_components_bipartite(E_mask: torch.Tensor,
                                   max_rounds: int = 64,
                                   exit_every: int = 1) -> torch.Tensor:
    """Component labels of the bipartite graph whose edges are
    ``E_mask[i, j] != 0`` between row node ``n + i`` and column node ``j``.

    Columns are nodes ``0..n-1``, rows ``n..n+m-1``.  Returns an
    ``(n + m,)`` int64 tensor; each label is the smallest node index in
    its component.  On a card the rounds are one :func:`label_rounds`
    launch on the whole mask (gathered once under a mesh), whatever
    ``exit_every``.  On the CPU they run in blocks of ``exit_every`` with
    one read each: a round at the fixpoint leaves the labels as they
    are.  Under a mesh ``E_mask`` is this rank's rows and the labels are
    replicated (:func:`label_round`).
    """
    if E_mask.is_cuda:
        return label_rounds(api.all_gather_rows(E_mask), max_rounds)[0]
    has_edge = E_mask != 0
    n = E_mask.shape[1]
    m = api.global_rows(E_mask)
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
    are float32, and the draws are ``key``'s
    (:func:`otamg_torch.random.mis_draws`).  :func:`mis_split` is the same
    from draws made beforehand, with the rounds run and the bail-out
    flag."""
    draws = jr.to_device(jr.mis_draws(key, As.shape[0]), As.device)
    return mis_split(As, active, draws, max_rounds)[0]


def mis_split(As, active, draws, max_rounds: int = 64):
    """``(CFSplit, rounds, bail)`` of :func:`mis_dense`, with no host
    read on a card.  The greedy rounds are one :func:`mis_rounds` launch
    there (on the CPU the plain loop, which reads its go-flag every
    round); the bail-out and the greedy outcome are both
    made, and ``bail`` picks one, as the branches of JAX's ``lax.cond``
    would."""
    f32 = torch.float32
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    connected = (deg0 > 0).sum().to(f32)
    bail = connected < 0.25 * torch.sqrt(Ncnt)
    tie, score = draws[0], draws[1]
    deg = torch.where(deg0 > 0, deg0 + tie, 0.0)
    isC, isF, isU, rounds = mis_rounds(As, active, deg, Ncnt, N0,
                                       max_rounds)
    # Tiny-level guard: an empty C set would zero every deeper level, so
    # the undecided nodes are absorbed into C.
    isC = isC | (~torch.any(isC) & isU)
    isF = isF & ~isC
    # Too few connected nodes: pick ~N0 random active coarse nodes.
    score = torch.where(active, score, torch.inf)
    rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
    bail_C = active & (rank < N0.to(rank.dtype))
    isC = torch.where(bail, bail_C, isC)
    isF = torch.where(bail, active & ~bail_C, isF)
    # Strength-isolated nodes are forced to C (mis_set.m:67).
    iso = active & ~torch.any(As, dim=1)
    return CFSplit(isC | iso, isF & ~iso), rounds, bail
