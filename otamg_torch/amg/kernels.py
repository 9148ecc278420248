"""The AMG setup's CUDA kernels and their plain PyTorch versions.

* :func:`mis_rounds` — the greedy local-max rounds of the MIS C/F
  splitting (:func:`otamg_torch.amg.graph.mis_dense`) until its go-test
  fails, in one launch of ``otamg_torch/csrc/mis.cu`` with no host read:
  the Hopper form of the ``lax.while_loop`` of
  ``otamg/amg/graph.py::mis_dense``, with ``As`` packed once into bits
  in the shared memory of a thread-block cluster or in a global
  workspace (:func:`mis_layout`; ``tests/mis_steps.py`` is the same
  method in torch ops).  Every step is a comparison or an integer count
  tested against the same f32 thresholds, so the kernel gives the plain
  loop's split bit for bit.
* :func:`coarse_eigh` — the eigendecomposition of the coarsest dense
  level in one launch of one block (``otamg_torch/csrc/coarse_eigh.cu``:
  Householder tridiagonalisation, multisection on Sturm counts, inverse
  iteration, back-transformation; ``tests/eigh_steps.py`` is the same
  method in torch ops) whose ``info`` stays on the card, where
  ``torch.linalg.eigh`` checks its ``info`` with a host sync
  (``otamg/amg/hierarchy.py``'s ``jnp.linalg.eigh`` runs inside the
  jit).  Its eigenpairs are not ``torch.linalg.eigh``'s bits: they agree
  to the tolerance a backward-stable eigensolver gives.

* :func:`label_rounds` — the rounds of label propagation
  (:func:`otamg_torch.amg.graph.connected_components_bipartite`) until
  one changes nothing, in one launch of ``otamg_torch/csrc/labels.cu``
  with no host read: the Hopper form of the ``lax.while_loop`` of
  ``otamg/amg/graph.py::connected_components_bipartite``, with ``E != 0``
  packed once into row and column bits in the shared memory of a
  thread-block cluster or in a global workspace (:func:`label_layout`).
  Every step is a minimum or a gather of integers, so the kernel gives
  the plain loop's labels and round count bit for bit.

* :func:`bip_smooth` — every sweep of one call of the bipartite level's
  kernel-projected block Gauss-Seidel smoother (the hot loop of every AMG
  cycle), in one launch of ``otamg_torch/csrc/bip_smooth.cu``: the Hopper
  form of XLA's fusion of ``otamg/amg/hierarchy.py::
  _projected_smooth_bip``, whose torch-op form
  (:func:`bip_smooth_plain`) is ~39 launches a sweep.  A cluster of 16
  blocks splits the two products a sweep over the rows of ``E``, with
  ``E``'s rows in the blocks' shared memory or read from global memory
  (:func:`bip_smooth_layout`; ``tests/bip_smooth_steps.py`` is the same
  method in torch ops).  Its sums run in a fixed order of its own: it
  agrees with the plain version to rounding, and with itself bit for
  bit.

None is a Pallas kernel of the JAX package: they replace XLA
operations, so that the whole front of a Newton solve can run as one
CUDA graph and an AMG cycle in a few launches.  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel
(built at first use, see :mod:`otamg_torch.cuda_build`) or raises.
``mis_rounds.launches``, ``coarse_eigh.launches``,
``label_rounds.launches`` and ``bip_smooth.launches`` count the
launches.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from otamg_torch.dist import api
from otamg_torch.sparse.segment import segment_sum2

_CODE = {torch.float32: 0, torch.float64: 1}
# The largest dynamic shared memory a block may opt into on Hopper.
SMEM_MAX = 232_448


def _stream():
    return getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda i: torch.cuda.current_stream(i).cuda_stream)


@functools.cache
def _bound(name: str):
    """(launch, error string, raw current stream) of ``csrc/<name>.cu``,
    bound at the first call."""
    from otamg_torch import cuda_build

    lib = cuda_build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_char_p]
    launch.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string, _stream()


def _launch(name: str, fmt: str, *args):
    launch, error_string, _ = _bound(name)
    err = launch(struct.pack(fmt, *args))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + error_string(err).decode())


# ---------------------------------------------------------------------------
# MIS rounds
# ---------------------------------------------------------------------------


def mis_go(isC, isU, Ncnt, N0):
    """The rounds' go-test: ``|C| < Ncnt/2`` and more than ``N0``
    undecided."""
    return (isC.sum() < Ncnt / 2) & (isU.sum() > N0)


def mis_round(As, active, isC, isF, isU, deg, N0):
    """One greedy round of ``AMG/mis_set.m:42-65`` in torch ops: keep
    each selectable node whose degree beats every strong neighbour's,
    make the neighbours of C nodes F, and absorb the undecided into C
    once at most ``N0`` are left.  Returns ``(isC, isF, isU, deg)``."""
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


def mis_rounds_plain(As, active, deg, Ncnt, N0, max_rounds: int = 64):
    """The greedy rounds in torch ops: ``(isC, isF, isU, rounds)``.
    ``deg`` is the f32 degree with the random ties added (0 on nodes with
    no strong connection, which start as F).  :func:`mis_round` runs
    while :func:`mis_go` holds, read on the host after every round, at
    most ``max_rounds`` times."""
    isF = active & (deg == 0)
    isC = torch.zeros_like(active)
    isU = active & ~isF
    done = 0
    while done < max_rounds and bool(mis_go(isC, isU, Ncnt, N0)):
        isC, isF, isU, deg = mis_round(As, active, isC, isF, isU, deg, N0)
        done += 1
    return isC, isF, isU, torch.tensor(done, dtype=torch.int32,
                                       device=As.device)


# csrc/mis.cu's cluster size, the same at every c (PERF.md gives the
# times on an H100 of one block and of smaller clusters); the words of shared memory its state
# takes besides the bit panel of ceil(c/32) words a row: the degrees (32 a
# word of nodes), the masks C, S, U, F and A, two counts a block and a
# reduction's scratch.
MIS_BLOCKS = 16
_MIS_STATE = (37, 2 * MIS_BLOCKS + 32 + 2)


def mis_layout(c: int) -> tuple:
    """Where ``csrc/mis.cu`` keeps the bits of ``As`` for ``c`` nodes:
    ``(layout, blocks, rows a block, shared bytes, workspace words)``.
    One cluster of :data:`MIS_BLOCKS` blocks; each packs its panel of
    ``rows`` rows (a multiple of 32; the last blocks may have fewer or
    none) into ``ceil(c/32)`` words a row.  Layout 0 keeps each panel in
    its block's shared memory (up to c = 5,120), layout 1 the panels in
    a global workspace of ``blocks * rows * ceil(c/32)`` 32-bit words (up
    to c = 50,176, where the state fills a block's shared memory).  Only
    the rows that are undecided or selectable at the start are
    packed."""
    W = -(-c // 32)
    rows = 32 * -(-c // (32 * MIS_BLOCKS))
    state = 4 * (_MIS_STATE[0] * W + _MIS_STATE[1])
    if state + 4 * rows * W <= SMEM_MAX:
        return 0, MIS_BLOCKS, rows, state + 4 * rows * W, 0
    if state <= SMEM_MAX:
        return 1, MIS_BLOCKS, rows, state, MIS_BLOCKS * rows * W
    raise ValueError(f"mis_rounds: {c} nodes exceed a block's shared "
                     "memory")


def mis_rounds(As, active, deg, Ncnt, N0, max_rounds: int = 64):
    """:func:`mis_rounds_plain`'s ``(isC, isF, isU, rounds)``; on a card
    one launch of ``csrc/mis.cu`` that tests the go-condition on the
    device after every round, in the layout :func:`mis_layout` gives.
    ``As`` is the ``(c, c)`` bool
    strong-connection matrix, ``active`` ``(c,)`` bool, ``deg`` ``(c,)``
    f32, ``Ncnt`` and ``N0`` 0-d f32; ``rounds`` is a 0-d int32
    tensor."""
    if not As.is_cuda:
        return mis_rounds_plain(As, active, deg, Ncnt, N0, max_rounds)
    c = As.shape[0]
    dev = As.get_device()
    ok = (As.shape == (c, c) and As.dtype is torch.bool
          and active.shape == (c,) and active.dtype is torch.bool
          and deg.shape == (c,) and deg.dtype is torch.float32
          and Ncnt.shape == () and N0.shape == ()
          and Ncnt.dtype is torch.float32 and N0.dtype is torch.float32
          and all(t.is_contiguous() and t.get_device() == dev
                  for t in (As, active, deg, Ncnt, N0)))
    if not ok:
        raise ValueError("mis_rounds: As (c, c) bool, active (c,) bool, "
                         "deg (c,) f32, Ncnt and N0 0-d f32, contiguous, "
                         "on one card")
    layout, nb, rows, smem, nws = mis_layout(c)
    isC = torch.empty(c, dtype=torch.bool, device=As.device)
    isF, isU = torch.empty_like(isC), torch.empty_like(isC)
    rounds = torch.empty((), dtype=torch.int32, device=As.device)
    if not c:
        return isC, isF, isU, rounds.zero_()
    ws = torch.empty(nws, dtype=torch.int32, device=As.device) if nws else None
    _launch("mis", "=18q", As.data_ptr(), active.data_ptr(), deg.data_ptr(),
            Ncnt.data_ptr(), N0.data_ptr(), isC.data_ptr(), isF.data_ptr(),
            isU.data_ptr(), rounds.data_ptr(), c, max_rounds,
            _bound("mis")[2](dev), dev, 0 if ws is None else ws.data_ptr(),
            layout, nb, rows, smem)
    mis_rounds.launches += 1
    return isC, isF, isU, rounds


mis_rounds.launches = 0


# ---------------------------------------------------------------------------
# Coarsest eigendecomposition
# ---------------------------------------------------------------------------


def coarse_eigh_plain(A: torch.Tensor):
    """``torch.linalg.eigh(A)`` and a zero ``info``: ``(lam, V, info)``."""
    lam, V = torch.linalg.eigh(A)
    return lam, V, torch.zeros((), dtype=torch.int32, device=A.device)


def eigh_layout(n: int, itemsize: int) -> tuple:
    """Where ``csrc/coarse_eigh.cu`` keeps its state for an ``n x n``
    matrix of ``itemsize``-byte values: ``(layout, shared bytes,
    workspace values)``.  Shared memory always holds T, the eigenvalues
    and the shifts, the tridiagonalisation's products and partial sums
    (15 n values) and five ints a row; layout 0 adds the matrix's lower
    triangle in rows of ``n | 1`` values (f64 up to n = 161, f32 up to
    231), layout 1 keeps it in the global workspace (f64 up to n = 1,659,
    f32 up to 2,904).  The workspace holds the inverse iteration's
    factors and iterates (6 n^2 values and n^2 bytes), and the matrix in
    layout 1."""
    small = itemsize * 15 * n + 4 * (5 * n + 16)
    ws = 6 * n * n + -(-n * n // itemsize)
    mat = n * (n | 1)
    if small + itemsize * mat <= SMEM_MAX:
        return 0, small + itemsize * mat, ws
    if small <= SMEM_MAX:
        return 1, small, ws + mat
    raise ValueError(f"coarse_eigh: n = {n} exceeds one block's shared "
                     "memory")


def coarse_eigh(A: torch.Tensor):
    """Eigenvalues (ascending), eigenvectors (columns) and ``info`` of a
    symmetric f32 or f64 matrix: :func:`coarse_eigh_plain` on the CPU,
    one launch of ``csrc/coarse_eigh.cu`` on a card (the method of
    ``tests/eigh_steps.py``, with the matrix in shared memory or
    the workspace, see :func:`eigh_layout`; ``info`` 0, or 1 when a
    multisection or an inverse iteration did not converge).  Only the
    lower triangle is read."""
    if not A.is_cuda:
        return coarse_eigh_plain(A)
    n = A.shape[0]
    if not (A.dim() == 2 and A.shape == (n, n) and A.dtype in _CODE
            and A.is_contiguous()):
        raise ValueError("coarse_eigh: a contiguous square f32 or f64 "
                         "matrix")
    layout, smem, nws = eigh_layout(n, A.element_size())
    dev = A.get_device()
    lam = A.new_empty(n)
    V = A.new_empty(n, n)
    info = torch.empty((), dtype=torch.int32, device=A.device)
    ws = A.new_empty(nws)
    _launch("coarse_eigh", "=11q", A.data_ptr(), lam.data_ptr(),
            V.data_ptr(), info.data_ptr(), n, _CODE[A.dtype], smem,
            _bound("coarse_eigh")[2](dev), dev, ws.data_ptr(), layout)
    coarse_eigh.launches += 1
    return lam, V, info


coarse_eigh.launches = 0


# ---------------------------------------------------------------------------
# Label propagation
# ---------------------------------------------------------------------------


def label_round(has_edge: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """One round of label propagation: hook each node to its smallest
    neighbour label, then jump pointers twice.  Under a mesh the row
    minimum is local (then gathered) and the column minimum a minimum
    over the ranks; the jumps run on the replicated labels."""
    n = has_edge.shape[1]
    N = L.shape[0]
    lc, lr = L[:n], api.local_rows(L[n:])
    # Hook: pull the minimum neighbour label across the edges.
    lr2 = torch.minimum(lr, torch.where(has_edge, lc[None, :],
                                        N).amin(dim=1))
    lc2 = torch.minimum(lc, api.pmin(torch.where(has_edge, lr2[:, None],
                                                 N).amin(dim=0)))
    L2 = torch.cat([lc2, api.all_gather_rows(lr2)])
    # Compress: pointer-jump twice so label chains halve each round.
    L2 = L2[L2]
    return L2[L2]


def label_rounds_plain(has_edge: torch.Tensor, max_rounds: int = 64):
    """The rounds in torch ops on the whole ``(m, n)`` bool mask:
    ``(labels, rounds)``, the ``(n + m,)`` int64 labels (columns first)
    and the 0-d int32 count.  :func:`label_round` runs until a round
    changes nothing, read on the host after every round, at most
    ``max_rounds`` times."""
    m, n = has_edge.shape
    L = torch.arange(n + m, dtype=torch.int64, device=has_edge.device)
    done = 0
    with api.use_mesh(None):
        while done < max_rounds:
            L2 = label_round(has_edge, L)
            changed = bool(torch.any(L2 != L))
            L = L2
            done += 1
            if not changed:
                break
    return L, torch.tensor(done, dtype=torch.int32, device=has_edge.device)


# csrc/labels.cu's cluster size; its codes for E's dtype.
LABEL_BLOCKS = 16
_LABEL_CODE = {torch.float32: 0, torch.float64: 1}


def label_layout(m: int, n: int) -> tuple:
    """Where ``csrc/labels.cu`` keeps the bits of an ``(m, n)`` mask:
    ``(layout, blocks, rows a block, columns a block, shared bytes,
    workspace words)``.  One cluster of :data:`LABEL_BLOCKS` blocks, each
    with four int32 label vectors of ``N = n + m`` in its shared memory
    (three the peers write in turn, and the jumps' snapshot), owns a
    panel of ``rows`` rows of ``ceil(n/32)`` words and ``cols`` columns
    of ``ceil(m/32)`` words (multiples of 32; the last blocks may own
    fewer or none).  Layout 0 keeps the panels in the blocks' shared
    memory (square masks up to 2,896 a side), layout 1 in a global
    workspace of ``m ceil(n/32) + n ceil(m/32)`` 32-bit words (up to N =
    14,528, where the label vectors fill a block's shared memory).
    Raises past that."""
    N = n + m
    Wn, Wm = -(-n // 32), -(-m // 32)
    rows = 32 * -(-m // (32 * LABEL_BLOCKS))
    cols = 32 * -(-n // (32 * LABEL_BLOCKS))
    state = 4 * 4 * N
    panels = 4 * (rows * Wn + cols * Wm)
    if state + panels <= SMEM_MAX:
        return 0, LABEL_BLOCKS, rows, cols, state + panels, 0
    if state <= SMEM_MAX:
        return 1, LABEL_BLOCKS, rows, cols, state, m * Wn + n * Wm
    raise ValueError(f"label_rounds: {N} nodes exceed a block's shared "
                     "memory")


def label_rounds(E: torch.Tensor, max_rounds: int = 64):
    """:func:`label_rounds_plain`'s ``(labels, rounds)`` of the mask
    ``E != 0``; on a card one launch of ``csrc/labels.cu`` that tests
    for a change on the device after every round, in the layout
    :func:`label_layout` gives.  ``E`` is the whole ``(m, n)`` f32 or f64
    matrix, contiguous, with ``m, n > 0``."""
    if not E.is_cuda:
        return label_rounds_plain(E != 0, max_rounds)
    if not (E.dim() == 2 and E.dtype in _LABEL_CODE and E.is_contiguous()
            and min(E.shape) > 0 and max_rounds >= 0):
        raise ValueError("label_rounds: E a contiguous (m, n) f32 or f64 "
                         "matrix with m, n > 0, and max_rounds >= 0")
    m, n = E.shape
    layout, nb, rows, cols, smem, nws = label_layout(m, n)
    dev = E.get_device()
    labels = torch.empty(n + m, dtype=torch.int64, device=E.device)
    rounds = torch.empty((), dtype=torch.int32, device=E.device)
    ws = torch.empty(nws, dtype=torch.int32, device=E.device) if nws else None
    _launch("labels", "=15q", E.data_ptr(), labels.data_ptr(),
            rounds.data_ptr(), m, n, max_rounds, _bound("labels")[2](dev),
            dev, 0 if ws is None else ws.data_ptr(), layout, nb, rows, cols,
            smem, _LABEL_CODE[E.dtype])
    label_rounds.launches += 1
    return labels, rounds


label_rounds.launches = 0


# ---------------------------------------------------------------------------
# The bipartite smoother
# ---------------------------------------------------------------------------


def bip_smooth_plain(lv, e, r, smoth_it: int, transpose: bool, nseg: int,
                     deflated: bool, e_is_zero: bool):
    """``smoth_it`` sweeps of the kernel-projected block Gauss-Seidel
    smoother on the bipartite level ``lv`` (a ``BipartiteLevel``) in
    torch ops: the fused form of ``hierarchy._projected_smooth`` there,
    the solver's hot loop (``otamg/amg/hierarchy.py::
    _projected_smooth_bip``).  The edge products ``u = E e1`` and
    ``w = E^T e2`` are carried across sweeps and updated from each
    sweep's corrections, so a sweep does exactly the two directed
    products its Gauss-Seidel order forces.  ``e_is_zero`` marks the
    pre-smoothing entry, where the carried products start at zero.
    ``deflated`` projects each component mean out after the sweep, and
    the carried products take the projection through ``Exi1``/``Etxi2``
    (``E`` has no edge across components).  Each per-component sum over
    the two halves is one :func:`segment_sum2` over the level's pair
    plan."""
    n = lv.W.shape[0]
    m = lv.g.shape[0] - n
    itk = lv.inv_tk
    Emv = lambda x: api.row_matvec(lv.E, x)     # E x, (m,)
    Etmv = lambda y: api.row_rmatvec(lv.E, y)   # E^T y, (n,)
    g1d, g2d = lv.g[:n], lv.g[n:]
    r1, r2 = r[:n], r[n:]
    lab1, lab2 = lv.labels[:n], lv.labels[n:]
    nsp1, nsp2 = lv.nsp[:n], lv.nsp[n:]
    xi1 = nsp1.to(r.dtype)
    xi2 = nsp2.to(r.dtype)
    if e_is_zero:
        e1 = torch.zeros(n, dtype=r.dtype, device=r.device)
        e2 = torch.zeros(m, dtype=r.dtype, device=r.device)
        u = torch.zeros(m, dtype=r.dtype, device=r.device)
        w = torch.zeros(n, dtype=r.dtype, device=r.device)
    else:
        e1, e2 = e[:n], e[n:]
        w, u = api.row_rmatvec(lv.E, e2), api.row_matvec(lv.E, e1)

    def directed(gp1, gp2):
        """One Gauss-Seidel block sweep: ``(d1, d2, E d1, E^T d2)``."""
        if not transpose:
            d1 = gp1 / g1d
            t = Emv(d1)
            d2 = (gp2 + itk * t) / g2d
            tw = Etmv(d2)
        else:
            d2 = gp2 / g2d
            tw = Etmv(d2)
            d1 = (gp1 + itk * tw) / g1d
            t = Emv(d1)
        return d1, d2, t, tw

    if deflated:
        cnt = segment_sum2(xi1, xi2, lv.labels, nseg, lv.plan)
        safe_cnt = torch.where(cnt > 0, cnt, 1.0)
        for _ in range(smoth_it):
            d1, d2, t, tw = directed(r1 - g1d * e1 + itk * w,
                                     r2 - g2d * e2 + itk * u)
            e1, e2 = e1 + d1, e2 + d2
            mean = segment_sum2(e1 * xi1, e2 * xi2, lv.labels, nseg,
                                lv.plan) / safe_cnt
            m1 = torch.where(nsp1, mean[lab1], 0.0)
            m2 = torch.where(nsp2, mean[lab2], 0.0)
            e1, e2 = e1 - xi1 * m1, e2 - xi2 * m2
            u = u + t - m2 * lv.Exi1
            w = w + tw - m1 * lv.Etxi2
        return torch.cat([e1, e2])
    xx1, xx2 = lv.xx[:n], lv.xx[n:]
    sxx1 = torch.where(torch.abs(xx1) > 0, xx1, 1.0)
    sxx2 = torch.where(torch.abs(xx2) > 0, xx2, 1.0)
    Axi1, Axi2 = lv.Axi[:n], lv.Axi[n:]
    for _ in range(smoth_it):
        gg1 = r1 - g1d * e1 + itk * w
        gg2 = r2 - g2d * e2 + itk * u
        xig = segment_sum2(gg1 * xi1, gg2 * xi2, lv.labels, nseg, lv.plan)
        c1 = torch.where(nsp1, xig[lab1] / sxx1, 0.0)
        c2 = torch.where(nsp2, xig[lab2] / sxx2, 0.0)
        d1, d2, t, tw = directed(gg1 - Axi1 * c1, gg2 - Axi2 * c2)
        e1 = e1 + xi1 * c1 + d1
        e2 = e2 + xi2 * c2 + d2
        u = u + c2 * lv.Exi1 + t
        w = w + c1 * lv.Etxi2 + tw
    return torch.cat([e1, e2])


# csrc/bip_smooth.cu's cluster size and block width.
BIP_BLOCKS = 16
_BIP_THREADS = 512


def _align16(x: int) -> int:
    return (x + 15) & ~15


def bip_smooth_layout(m: int, n: int, nseg: int, itemsize: int) -> tuple:
    """Where ``csrc/bip_smooth.cu`` keeps an ``(m, n)`` level of
    ``itemsize``-byte values summed into ``nseg`` components: ``(layout,
    rows a block, shared bytes, workspace bytes, state bytes)``.  One
    cluster of :data:`BIP_BLOCKS` blocks; each owns ``rows = ceil(m /
    16)`` rows of ``E`` (the last blocks may own fewer or none) and keeps
    the whole state: ``e``, the carried products, the sweep's direction
    and the scan's prefixes (``n + m`` values each), two sums a component,
    the exchanged shares of ``E^T y`` (two buffers of ``n``) and rows'
    values (two of ``2 rows``), the scan's 512 + 16 carries, 16 ints and
    a flag byte a node.  Layout 0 adds the block's rows of ``E`` to its
    shared memory (500^2 in f64 and f32), layout 1 reads ``E`` from global
    memory (1024^2), layout 2 keeps each block's state in a global
    workspace too (``n + m`` past ~3,900 in f64, ~7,800 in f32)."""
    rows = -(-m // BIP_BLOCKS)
    N = n + m
    vals = 4 * N + 2 * nseg + 2 * n + 4 * rows + _BIP_THREADS + 16
    state = _align16(_align16(vals * itemsize) + 4 * 16 + N)
    panel = _align16(rows * n * itemsize)
    if panel + state <= SMEM_MAX:
        return 0, rows, panel + state, 0, state
    if state <= SMEM_MAX:
        return 1, rows, state, 0, state
    return 2, rows, 0, BIP_BLOCKS * state, state


def bip_smooth(lv, e, r, smoth_it: int, transpose: bool, nseg: int,
               deflated: bool, e_is_zero: bool):
    """:func:`bip_smooth_plain`'s result; on a card one launch of
    ``csrc/bip_smooth.cu`` for all ``smoth_it`` sweeps, in the layout
    :func:`bip_smooth_layout` gives.  The level's tensors, ``r`` and
    (unless ``e_is_zero``) ``e`` are contiguous, of one dtype (f32 or
    f64) and on one card; ``labels`` int64 in ``[0, nseg)``, ``nsp``
    bool, the pair plan's ``order`` and ``offsets`` int32 over ``nseg``
    components.  ``inv_tk`` is read on the card only.  Its sums are not
    the plain version's bits: each is taken in a fixed order of its own,
    the same on every call."""
    if not r.is_cuda:
        return bip_smooth_plain(lv, e, r, smoth_it, transpose, nseg,
                                deflated, e_is_zero)
    E = lv.E
    dt = r.dtype
    m, n = E.shape if E.dim() == 2 else (0, 0)
    N = n + m
    dev = r.get_device()
    vecs = (r, lv.g, lv.Axi, lv.xx) + (() if e_is_zero else (e,))
    tensors = (E, lv.inv_tk, lv.Exi1, lv.Etxi2, lv.labels, lv.nsp,
               lv.plan.order, lv.plan.offsets, *vecs)
    ok = (dt in _CODE and m > 0 and n > 0 and nseg > 0 and smoth_it >= 0
          and all(t.dtype is dt for t in (E, lv.inv_tk, lv.Exi1, lv.Etxi2,
                                          *vecs))
          and all(t.shape == (N,) for t in (*vecs, lv.labels, lv.nsp,
                                            lv.plan.order))
          and lv.inv_tk.shape == () and lv.Exi1.shape == (m,)
          and lv.Etxi2.shape == (n,) and lv.labels.dtype is torch.int64
          and lv.nsp.dtype is torch.bool
          and lv.plan.order.dtype is torch.int32
          and lv.plan.offsets.dtype is torch.int32
          and lv.plan.offsets.shape == (nseg + 1,)
          and all(t.is_cuda and t.get_device() == dev and t.is_contiguous()
                  for t in tensors))
    if not ok:
        raise ValueError("bip_smooth: a bipartite level with E (m, n), m, "
                         "n > 0, its vectors, r and e (n + m,) of one "
                         "dtype (f32 or f64), int64 labels, bool nsp, an "
                         "int32 pair plan over nseg > 0 components, "
                         "contiguous, on one card")
    layout, rows, smem, nws, state = bip_smooth_layout(
        m, n, nseg, E.element_size())
    out = torch.empty_like(r)
    ws = (torch.empty(nws, dtype=torch.uint8, device=r.device) if nws
          else None)
    _launch("bip_smooth", "=30q", E.data_ptr(), lv.g.data_ptr(),
            r.data_ptr(), 0 if e_is_zero else e.data_ptr(),
            lv.inv_tk.data_ptr(), lv.labels.data_ptr(), lv.nsp.data_ptr(),
            lv.Axi.data_ptr(), lv.xx.data_ptr(), lv.Exi1.data_ptr(),
            lv.Etxi2.data_ptr(), lv.plan.order.data_ptr(),
            lv.plan.offsets.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(), m, n, nseg, smoth_it,
            int(transpose), int(deflated), int(e_is_zero), layout, rows,
            smem, state, _bound("bip_smooth")[2](dev), dev, _CODE[dt],
            bip_smooth_runs(r.device).data_ptr())
    bip_smooth.launches += 1
    return out


bip_smooth.launches = 0
_RUNS: dict = {}


def bip_smooth_runs(device) -> torch.Tensor:
    """The card's count of :func:`bip_smooth`'s kernel runs on
    ``device`` (int64, 0-d): the kernel adds 1 at each run, so the runs
    of a captured graph's replays and of the conditional bodies that run
    are counted too, where ``bip_smooth.launches`` counts the wrapper's
    launches.  Made at the first call, which cannot be inside a capture
    (a region's warm-up runs first); ``.zero_()`` resets it."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    runs = _RUNS.get(dev)
    if runs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bip_smooth: the first call is inside a "
                               "CUDA-graph capture")
        runs = _RUNS[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return runs
