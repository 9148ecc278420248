"""``otamg_torch/csrc/mis.cu``'s method step by step in torch ops on the
CPU, for the tests (:func:`mis_rounds_steps_plain`).  The port itself
runs the plain rounds loop on the CPU
(``otamg_torch.amg.kernels.mis_rounds_plain``) and the kernel on a card;
this module lets the CPU tests check the kernel's method, its bits and
its exchanges between the blocks of a cluster above all, where no card
is present.

Masks are rows of 32-bit words held in int64 tensors: bit ``j % 32`` of
word ``j // 32`` stands for node ``j``."""

from __future__ import annotations

import torch

_BIT = torch.arange(32, dtype=torch.int64)


def pack(flags: torch.Tensor, W: int) -> torch.Tensor:
    """``(..., c)`` bool -> ``(..., W)`` words."""
    c = flags.shape[-1]
    out = torch.zeros(*flags.shape[:-1], 32 * W, dtype=torch.int64)
    out[..., :c] = flags.to(torch.int64)
    return (out.view(*flags.shape[:-1], W, 32) << _BIT).sum(-1)


def unpack(words: torch.Tensor, c: int) -> torch.Tensor:
    """``(..., W)`` words -> ``(..., c)`` bool."""
    return ((words[..., None] >> _BIT) & 1).bool().flatten(-2)[..., :c]


def popcount(words: torch.Tensor) -> int:
    return int(((words[..., None] >> _BIT) & 1).sum())


def _f32(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.float32)


def mis_rounds_steps_plain(As, active, deg, Ncnt, N0, blocks: int = 16,
                           max_rounds: int = 64):
    """The kernel's ``(isC, isF, isU, rounds)`` with ``blocks`` blocks in
    its cluster, each with a panel of ``32 ceil(c / (32 blocks))`` rows
    (``otamg_torch.amg.kernels.mis_layout``'s; where the panels live does
    not change the method, and other cluster sizes test the exchanges
    where the panels cut c otherwise).  Each block keeps its own copy of the state: the degrees,
    the masks C, S (selectable), U, F and A, of which C and S are kept
    whole by the exchanges and U and F only on its own rows.  The
    go-test comes before any read of ``As``; then each block packs the
    rows of its panel that are U or S once, and a round is pass 1 over
    its S rows, the exchange of its words of C, pass 2 over its rows in
    U but not C, the update of its words of U and S and their counts,
    and the exchange of its words of S and the counts.  After a call,
    ``mis_rounds_steps_plain.panel_reads`` is 1 if the panels were read,
    else 0, and ``.s_is_u`` says for each round whether every block's S
    was the whole U at its start."""
    c, nb = As.shape[0], blocks
    W = -(-c // 32)
    rows = 32 * -(-c // (32 * nb))
    half = Ncnt / 2
    r0 = [min(c, b * rows) for b in range(nb)]
    r1 = [min(c, r + rows) for r in r0]
    own = [slice(a // 32, a // 32 + -(-(e - a) // 32))
           for a, e in zip(r0, r1)]
    A = pack(active, W)
    F0 = pack(active & (deg == 0), W)
    state = [dict(C=torch.zeros(W, dtype=torch.int64), S=pack(deg > 0, W),
                  U=A & ~F0, F=F0.clone()) for _ in range(nb)]
    ctot, utot = 0, popcount(A & ~F0)
    go = bool((_f32(ctot) < half) & (_f32(utot) > N0))
    rounds, absorbed = 0, False
    mis_rounds_steps_plain.panel_reads = 0
    mis_rounds_steps_plain.s_is_u = []
    if go and max_rounds > 0:
        # Only the rows a round can visit: U or S at the start.
        visit = unpack(A & ~F0 | pack(deg > 0, W), c)[:, None]
        panels = [pack(As[a:e] & visit[a:e], W) for a, e in zip(r0, r1)]
        mis_rounds_steps_plain.panel_reads = 1
    while go and rounds < max_rounds:
        U = torch.zeros(W, dtype=torch.int64)
        for b in range(nb):
            U[own[b]] = state[b]["U"][own[b]]
        mis_rounds_steps_plain.s_is_u.append(
            all(torch.equal(st["S"], U) for st in state))
        # Pass 1: each block's S rows.
        for b, st in enumerate(state):
            mine = unpack(st["S"], c)[r0[b]:r1[b]]
            nbr = unpack(panels[b][mine] & st["S"], c)
            m = torch.where(nbr, deg, -torch.inf).amax(dim=1)
            sel = torch.zeros(r1[b] - r0[b], dtype=torch.bool)
            sel[mine] = deg[r0[b]:r1[b]][mine] > m
            st["C"][own[b]] |= pack(sel, own[b].stop - own[b].start)
        for b, st in enumerate(state):
            for p, peer in enumerate(state):
                if p != b:
                    peer["C"][own[b]] = st["C"][own[b]]
        # Pass 2: each block's rows in U but not C.
        counts = []
        for b, st in enumerate(state):
            mine = unpack(st["U"] & ~st["C"], c)[r0[b]:r1[b]]
            hit = torch.zeros(r1[b] - r0[b], dtype=torch.bool)
            hit[mine] = (panels[b][mine] & st["C"]).ne(0).any(dim=1)
            st["F"][own[b]] |= pack(hit, own[b].stop - own[b].start)
            w = own[b]
            st["U"][w] = A[w] & ~(st["F"][w] | st["C"][w])
            st["S"][w] &= st["U"][w]
            counts.append((popcount(st["C"][w]), popcount(st["U"][w])))
        for b, st in enumerate(state):
            for p, peer in enumerate(state):
                if p != b:
                    peer["S"][own[b]] = st["S"][own[b]]
        ctot = sum(cc for cc, _ in counts)
        utot = sum(cu for _, cu in counts)
        # At most N0 undecided: they join C, and the rounds end.
        absorbed = bool(_f32(utot) <= N0)
        if absorbed:
            ctot, utot = ctot + utot, 0
        go = bool((_f32(ctot) < half) & (_f32(utot) > N0))
        rounds += 1
    isC = torch.zeros(c, dtype=torch.bool)
    isF, isU = torch.zeros_like(isC), torch.zeros_like(isC)
    for b, st in enumerate(state):
        rng = slice(r0[b], r1[b])
        u = unpack(st["U"], c)[rng]
        isC[rng] = unpack(st["C"], c)[rng] | (absorbed & u)
        isF[rng] = unpack(st["F"], c)[rng]
        isU[rng] = u & (not absorbed)
    return isC, isF, isU, torch.tensor(rounds, dtype=torch.int32)
