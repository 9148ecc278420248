"""Drive the PyTorch/CUDA port (``otamg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and seconds:

1. device   — the card's name and power limit (from ``nvidia-smi``);
2. build    — compile every CUDA kernel of ``otamg_torch/csrc``;
3. kernel   — ``ell_spmv`` against ``ell_spmv_plain`` on the card, f32
   and f64, at shapes that reach every variant (2-D and 3-D stencils,
   cap 1, random rows of 33 and 200, a row-sliced misaligned view)
   and at edge sizes, with per shape: the variant, ``ms`` (CUDA events
   around 100 back-to-back calls, over 100), ``device_ms`` (the same
   calls captured in a CUDA graph and replayed), ``host_us`` (the
   wrapper's host time per call), the bound and the share of it reached,
   the plain version's time and a ``torch.sparse_csr_tensor @ x`` call's
   as a yardstick; then ``segment_sum`` (the deterministic segment sum
   of ``otamg_torch/csrc/segment_sum.cu``) over a segment plan made
   beforehand, against its plain version, ``index_add_``, at the shapes
   of the paths, with its time beside the plan's build (``segment_plan``,
   torch ops), the call without a plan and ``index_add_``'s, and the
   pair form ``segment_sum2`` at the bipartite level's halves against
   the two sums it replaces; then the front's kernels on the first Newton
   solve of Class-1 500x500 and 1024x1024 and Class-2 500x500
   (one-iteration loop-driver solves record their inputs): every
   coarsest capacity of the sizes
   solved here within the eigh kernel's shared memory; ``mis_rounds``
   (``csrc/mis.cu``) against its plain version on each level's strength
   graph, on a bail-out case, on synthetic level-1 graphs of 100, 2,048
   and 4,096 nodes (the bits in the cluster's shared memory) and 6,144
   (the bits in a global workspace) and on a deep level of 128 nodes,
   equal splits and rounds, each row with its layout, blocks, active
   nodes and strong neighbours a row;
   ``coarse_eigh`` (``csrc/coarse_eigh.cu``) against
   ``torch.linalg.eigh`` at n = 8, 64, 99, 123, 128 in f64 and f32, at
   191, 256, 400 and 600, where the matrix is in global memory in f64, and
   on a clustered matrix at 123 and 400, to stated tolerances; each
   with ``ms``, ``device_ms``, the bound and the plain version's (and
   eigh's) time; ``label_rounds`` (``csrc/labels.cu``) against
   ``label_rounds_plain`` bit for bit, labels and rounds, on the three
   first Newton masks, the 500 + 500 permuted path at the 64-round cap
   (3 labels left), random 2,048 and 3,072 (bits in the workspace) masks
   and an empty and a full mask, each with its layout, rounds, labels
   left, ``ms``, ``device_ms``, ``host_us``, the plain version's time and
   the bound; and the Newton solve's front itself (``newton_front``:
   transform, components, setup) eagerly under
   ``torch.cuda.set_sync_debug_mode("error")``, then captured and
   replayed, equal to the eager front bit for bit with no read or sync
   around the replay, with the eager and replay times (the replay's host
   time split) and the defect repair's extra device ms; then
   ``bip_smooth`` (``csrc/bip_smooth.cu``, the bipartite smoother)
   against ``bip_smooth_plain`` on the levels and vectors of the first
   smoothing calls of those solves and of a mixed Class-1 500x500 one
   (fp32, deflated) and at the layouts' edges (:func:`phase_bip_smooth`);
4. sparse   — ``amg_solve_matrix`` on the 128x128 grid Laplacian + 0.01 I
   as an ELL ``CSR`` (the path that runs the kernel), 30 iterations, with
   its launches, checked against the same solve through the plain SpMV;
5. class1   — ``solve_class1`` (AMG inner solver, F-cycle, fuse_deep):
   a 24x20 problem checked against ``scipy.optimize.linprog`` and against
   the port on the CPU, then 256x256, 500x500 (one cold and one warm
   run) and 1024x1024 once, each held to the JAX package's CPU f64 run
   (``CLASS1_REF``), with its numbers (``run_numbers``: host reads, all
   syncs and the others with their sites, per outer iteration; setup
   replays, repairs, MIS rounds, launches);
6. class2   — ``solve_class2`` (the same AMG inner solver with the
   Class-2 budget ``maxit=40, smoth=10``, ``ssn_tol1=1e-10``, no
   feasibility polish): ``random_class2(PRNGKey(7), 20, 16,
   mu_frac=0.6)`` with the Class-2 defaults checked against
   ``scipy.optimize.linprog`` and against the port on the CPU, then
   500x500 once and 1024x1024 once through the chunked driver, each held
   to the JAX package's CPU f64 run (``CLASS2_REF``);
   setup_graph — the chunked (``chunk=8``) and fused drivers, each Newton
   solve one replay of the front's CUDA graph (transform, components,
   setup) and the AMG block's, each SsN step at least one replay of the
   outer step's regions, beside the loop runs of phases 5 and 6 (the
   same front and step, eager): Class-1 500x500 chunked twice and fused,
   1024x1024 chunked and fused, Class-2 500x500 chunked, each bit for bit
   its loop run's trajectory, with one front replay a Newton solve, at
   most one capture a signature (each step region captured by the first
   run of its signature), no plain label round on the card, and the
   run's numbers;
7. mixed    — the same Class-1 and Class-2 solves with
   ``solve_dtype="float32"`` (fp32 AMG hierarchy, exact kernel deflation,
   f64 refinement; ``bench.py``'s configuration on an accelerator):
   Class-1 500x500 and 1024x1024 and Class-2 500x500 once each, held to
   the JAX package's CPU run of the same problem and
   options (``MIXED_REF``) and printed beside the f64 run's seconds from
   this call, with the refinement rounds, reverted rounds and mean
   correction cycles; then the blocked drivers (Class-1 500x500 chunked
   twice and fused, 1024x1024 chunked and fused, Class-2 500x500
   chunked), whose refinement rounds run as CUDA graphs over the front's
   buffers, each held to ``MIXED_REF`` and to its loop run bit for bit
   (trajectory and refinement counts) and printed beside the f64 run of
   its driver from this call, with its reads, the refinement's reads
   and block replays a ``he_solve`` and its captures and replays; fails
   if a correction solve runs op by op there, or a refinement region is
   captured more than once a signature.  Fails if TF32 matmuls are on;
   conditional — JAX's ``lax.cond`` (the defect repair) and the exits of
   its ``while_loop``s (``amg_solve``, the Armijo search, the mixed
   refinement) as CUDA-graph conditional nodes (``otamg_torch.graphs.
   when``, ``csrc/conditional.cu``): one graph holding one node replayed
   with its predicate true, false and true, bit for bit the body's
   output, the untouched buffer and the select form's (the plain
   version), with the node's device ms taken and skipped, the select
   form's and the bound; then every blocked run of setup_graph and mixed
   (each held there) with the bodies that ran (repairs built, AMG
   cycles, refinement cycles, Armijo trials) beside its loop run's, the
   repairs the setups' stats count and the inner iterations: the same
   counts as the loop, a repair built for each fired, an AMG cycle an
   inner iteration in f64 (none past an exit); then device ms by form,
   select against conditional nodes: the front at 500^2 and 1024^2 with
   its first key and with the first key whose setup fires the repair,
   each bit for bit the eager front, and an AMG block (from its first
   state and past its exit) and an Armijo block of a 3-iteration
   Class-1 500^2 chunked solve, equal in both forms;
8. roofline — the bytes model of the warm Class-1 500x500 f64 run of
   phase 5 (``otamg_torch.diag.roofline``) against the card's memory
   bandwidth; reported, not held;
9. sparse_setup — ``setup_hierarchy_sparse`` + ``amg_solve`` (F-cycle)
   on the 1-D Laplacian + 0.01 I of ``SPARSE_SETUP_N`` rows, every sparse
   level's matvec through the ELL kernel: setup and solve seconds, the
   levels, the launches by level size, held to the same solve through
   the plain SpMV and to the JAX package's CPU run
   (``SPARSE_SETUP_REF``), with the ``segment_sum`` launches of the
   solve, then the kernel timed at the fine and the first aggregation
   level's shapes;
10. cli     — ``otamg_torch.cli.main`` in this process: Class 1 256x256
   and Class 2 128x128 (AMG, F-cycle), each uninterrupted, stopped at
   20 iterations with ``--checkpoint`` and resumed with ``--resume
   --driver chunked`` (the loop driver's checkpoint), held to the JAX
   package's CLI on the CPU (``CLI_REF``); a
   ``--profile`` run whose trace must exist; ``python -m
   otamg_torch.cli info`` as a subprocess;
11. dist     — ``otamg_torch.dist`` on a process group of one rank with
   NCCL, made in this process: (a) ``spmv_allgather`` and ``spmv_halo``
   on the 1-D Laplacian of 1,048,576 rows against ``ell_spmv`` on the
   same rows, bit for bit, with their times beside the kernel's and its
   bound; (b) ``asat_diags_sharded``, ``transform_sharded`` and
   ``galerkin_sharded`` at 500x500 against their unsharded
   counterparts, bit for bit; (c) ``amg_solve_matrix(dist=(mesh, 128))``
   on phase 4's grid (phase 4's iterations, ``x`` to 1e-12) and
   ``setup_hierarchy_sparse(dist=(mesh, 1))`` + ``amg_solve`` at
   ``SPARSE_SETUP_N`` (phase 9's levels and cycles, ``x`` to 1e-12 of
   phase 9's); (d) Class-1 sharded through the loop driver, 500x500 with
   ``explicit_dist`` off and 256x256 with it on, each held to
   ``CLASS1_REF``, its seconds beside phase 5's run of its size; (e) Class-2 256x256 sharded beside
   the unsharded run in the same phase (iterations, failures, SsN steps,
   objective to 1e-10; 15 outer iterations of the 54 to convergence);
   (f) the CLI's ``--shard --coordinator`` on one
   process, as a subprocess; (g) where the machine has 2 or more cards,
   ``min(4, count)`` NCCL ranks on Class-1 1024x1024 held to
   ``CLASS1_REF``; on one card a line says it was not run; (h) the
   chunked (``chunk=8``) and fused drivers on (d)'s sharded Class-1
   500x500 problem, each held to ``CLASS1_REF`` and to (d)'s sharded
   loop run bit for bit (objectives, SsN steps, failures), and the
   chunked driver on (e)'s sharded Class-2 problem held to its sharded
   loop run bit for bit, each with its eager and replayed collectives
   (the AMG block's CUDA graph holds the level's NCCL collectives, the
   front's graph the transform's and the one gather of ``E``, the step's
   regions its sums) and graph captures and replays; fails unless a
   captured block, a captured front and a captured step region hold a
   collective, each Newton solve replays one front and each SsN step
   the step's regions; (i) the chunked driver's mixed Class-1 500x500
   solve on the sharded problem held to ``MIXED_REF`` and to phase 7's
   unsharded chunked mixed run in its counts (the sharded smoother is
   the plain one by configuration, the unsharded one the kernel: their
   bits differ by rounding), and over 15 outer iterations bit for bit
   to the sharded loop run, refinement counts included, its refinement
   regions captured with their collectives.

Then a line with each path's ``label_rounds`` launches (fails where a path
that runs its own front launched none, or any path ran a plain label
round on the card), a line with each path's ``bip_smooth`` launches and
runs counted on the card (fails where a single-card path ran none, or
ran the plain smoother on the card; the sharded paths run the plain one
by configuration), one JSON line listing every kernel (``ell_spmv``,
``segment_sum``, ``mis_rounds``, ``coarse_eigh``, ``label_rounds``,
``set_if`` and ``bip_smooth``, each with its launches by path), the
card's name and power limit, and the last line ``{"ok": true, "device":
{...}}``.  Any failure raises and
exits nonzero; without CUDA the script exits nonzero before printing
any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import glob
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPS = 100    # launches per timed run
ROUNDS = 5    # timed runs; the median is kept
# Non-tensor-core FP64/FP32 peaks (FLOP/s) from NVIDIA's data sheet; the
# memory bandwidth by card name is otamg_torch.diag.roofline.hbm_rate.
_PEAK = {torch.float64: 34e12, torch.float32: 67e12}


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def zero_counts():
    """Set the launch counts of ``segment_sum``, ``mis_rounds``,
    ``coarse_eigh``, ``label_rounds``, ``bip_smooth`` and ``set_if`` to
    0, the card's count of ``bip_smooth``'s runs too, and the counts of
    plain label-propagation rounds and plain smoothing calls on a card
    tensor (:func:`count_plain_rounds`, :func:`count_plain_smooth`)."""
    from otamg_torch import graphs
    from otamg_torch.amg.kernels import (bip_smooth, bip_smooth_runs,
                                         coarse_eigh, label_rounds,
                                         mis_rounds)
    from otamg_torch.sparse.segment import segment_sum

    segment_sum.launches = mis_rounds.launches = coarse_eigh.launches = 0
    label_rounds.launches = count_plain_rounds.calls = 0
    bip_smooth.launches = count_plain_smooth.calls = 0
    bip_smooth_runs("cuda").zero_()
    graphs.cond_launches.clear()


def counts() -> int:
    """The ``segment_sum`` kernels' launches since :func:`zero_counts`."""
    from otamg_torch.sparse.segment import segment_sum

    return segment_sum.launches


def set_if_launches() -> int:
    """The ``set_if`` kernel's launches since :func:`zero_counts`: one a
    conditional node captured (a replay re-runs it)."""
    from otamg_torch import graphs

    return sum(graphs.cond_launches.values())


def setup_counts() -> dict:
    """The front's kernels' and the smoother's launches since
    :func:`zero_counts` (``bip_smooth_runs``: the smoother kernel's runs
    counted on the card, replays included), and the plain rounds and
    smoothing calls run on a card tensor (none on any path but the
    sharded ones, whose smoother is plain by configuration)."""
    from otamg_torch.amg.kernels import (bip_smooth, bip_smooth_runs,
                                         coarse_eigh, label_rounds,
                                         mis_rounds)

    return dict(mis_rounds=mis_rounds.launches,
                coarse_eigh=coarse_eigh.launches,
                label_rounds=label_rounds.launches,
                plain_label_rounds_on_card=count_plain_rounds.calls,
                bip_smooth=bip_smooth.launches,
                bip_smooth_runs=int(bip_smooth_runs("cuda")),
                plain_bip_smooth_on_card=count_plain_smooth.calls)


def count_plain_rounds():
    """Count the rounds of the plain label-propagation loop that
    ``connected_components_bipartite`` runs on a card tensor (it runs
    the kernel there: the count stays 0 on every path) in
    ``count_plain_rounds.calls``."""
    from otamg_torch.amg import graph

    plain = graph.label_round

    def counted(has_edge, L):
        if has_edge.is_cuda:
            count_plain_rounds.calls += 1
        return plain(has_edge, L)

    graph.label_round = counted


count_plain_rounds.calls = 0


def count_plain_smooth():
    """Count the plain smoothing calls that ``_projected_smooth_bip``
    makes on a card tensor (it launches the kernel there with no live
    mesh: the count stays 0 on every path but the sharded ones) in
    ``count_plain_smooth.calls``."""
    from otamg_torch.amg import hierarchy

    plain = hierarchy.bip_smooth_plain

    def counted(lv, e, r, *a, **kw):
        if r.is_cuda:
            count_plain_smooth.calls += 1
        return plain(lv, e, r, *a, **kw)

    hierarchy.bip_smooth_plain = counted


count_plain_smooth.calls = 0


def count_refinement():
    """Count the mixed refinement's host reads (``fetch`` of
    ``hybrid/solver.py``: the loop's rounds, the blocked refinement's
    blocks) in ``count_refinement.reads``, and in
    ``count_refinement.eager`` the ``amg_solve`` calls of
    ``hybrid/solver.py`` on a card tensor: in a mixed run the loop's
    correction solves, each round's op by op (none on the blocked
    drivers, whose rounds run inside the refinement's CUDA graphs)."""
    from otamg_torch.hybrid import solver

    fetch, amg_solve = solver.fetch, solver.amg_solve

    def counted_fetch(x):
        count_refinement.reads += 1
        return fetch(x)

    def counted_solve(lv1, dense, b, *a, **kw):
        if b.is_cuda:
            count_refinement.eager += 1
        return amg_solve(lv1, dense, b, *a, **kw)

    solver.fetch, solver.amg_solve = counted_fetch, counted_solve


count_refinement.reads = count_refinement.eager = 0


class SyncCount:
    """The card's host syncs inside a ``with`` block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (each read
    of a card tensor, each copy from pageable host memory to the card,
    each other synchronising call): ``total`` and ``sites``, the count by
    ``site(filename, lineno)``, by default the source line that made the
    sync."""

    def __init__(self, site=None):
        self.site = site or (lambda f, n: f"{os.path.basename(f)}:{n}")

    def __enter__(self):
        self.sites = collections.Counter()
        self._caught = warnings.catch_warnings()
        self._caught.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if "synchroniz" in str(message):
                self.sites[self.site(filename, lineno)] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._caught.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.sites.values())


def cuda_ms(fn, reps: int = REPS) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; median of ``ROUNDS`` runs.
    Where the host enqueues slower than the device runs, this is the
    host's rate."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(ROUNDS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int = REPS) -> float:
    """Device milliseconds per call of ``fn()`` alone: ``reps`` calls
    captured in one CUDA graph, replayed between two events, divided by
    ``reps``; median of ``ROUNDS`` replays.  Captured through
    ``graphs.capture``, so that ``graphs.when`` in ``fn`` makes
    conditional nodes."""
    from otamg_torch import graphs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graphs.capture(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(ROUNDS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def host_us(fn, reps: int = REPS) -> float:
    """Host microseconds per call of ``fn()``: ``time.perf_counter`` over
    ``reps`` calls with no synchronisation; median of ``ROUNDS`` runs."""
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def grid_csr(nx: int, shift: float, dtype, dev):
    """The ``nx``x``nx`` 5-point Laplacian + ``shift`` I as an ELL CSR
    built from the stencil, columns ascending and padding (column 0,
    value 0) last, as ``CSR.from_dense`` lays it out."""
    from otamg_torch.sparse import CSR

    N = nx * nx
    k = torch.arange(N, device=dev)
    i, j = k // nx, k % nx
    nb = torch.stack([k - nx, k - 1, k, k + 1, k + nx], 1)
    ok = torch.stack([i > 0, j > 0, torch.ones_like(i, dtype=torch.bool),
                      j < nx - 1, i < nx - 1], 1)
    val = torch.full((N, 5), -1.0, dtype=dtype, device=dev)
    val[:, 2] = 4.0 + shift
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    ok = torch.gather(ok, 1, order)
    cols = torch.where(ok, torch.gather(nb, 1, order), 0).to(torch.int32)
    vals = torch.where(ok, torch.gather(val, 1, order), 0.0)
    counts = ok.sum(1).to(torch.int32)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0).to(torch.int32)])
    return CSR((N, N), indptr, cols.contiguous(), vals.contiguous())


def stencil_ell(nx: int, dim: int, points: int, dtype, dev):
    """ELL arrays of the ``points``-point Laplacian on an ``nx``^``dim``
    grid (5 or 9 points in 2-D, 7 or 27 in 3-D), in natural order; a
    neighbour outside the grid keeps its slot with column -1 and value
    -1, which the kernel must drop."""
    offs = [o for o in itertools.product((-1, 0, 1), repeat=dim)
            if points == 3 ** dim or sum(map(abs, o)) <= 1]
    k = torch.arange(nx ** dim, device=dev)
    idx = [(k // nx ** (dim - 1 - a)) % nx for a in range(dim)]
    cols, vals = [], []
    for o in offs:
        inside = torch.ones_like(k, dtype=torch.bool)
        c = torch.zeros_like(k)
        for a, d in enumerate(o):
            ia = idx[a] + d
            inside &= (ia >= 0) & (ia < nx)
            c = c * nx + ia
        cols.append(torch.where(inside, c, -1))
        vals.append(torch.full_like(k, len(offs) - 1 if not any(o) else -1,
                                    dtype=dtype))
    return (torch.stack(cols, 1).to(torch.int32).contiguous(),
            torch.stack(vals, 1).contiguous())


def random_ell(N: int, cap: int, dtype, dev, gen):
    """Random columns in [-64, N + 64) (out of range on both sides) and
    normal values."""
    cols = torch.randint(-64, N + 64, (N, cap), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn(N, cap, generator=gen, device=dev, dtype=dtype)
    if not ((cols < 0).any() and (cols >= N).any()):
        raise AssertionError("random columns hold no out-of-range slot")
    return cols, vals


def kernel_shapes(dtype, dev, gen):
    """(name, cols, vals, x) of every shape the kernel phase checks; they
    reach every variant of ``plan``."""
    def vec(n):
        return torch.randn(n, generator=gen, device=dev, dtype=dtype)

    for nx in (128, 1024):
        A = grid_csr(nx, 0.01, dtype, dev)
        yield f"grid{nx}", A.ell_cols, A.ell_vals, vec(nx * nx)
    # Row-sliced views: at cap 5 their pointers sit off 16-byte bounds.
    yield "grid1024_view1", A.ell_cols[1:], A.ell_vals[1:], vec(nx * nx)
    N = 1024 * 1024
    yield ("diag1m", torch.arange(N, device=dev, dtype=torch.int32)[:, None],
           torch.randn(N, 1, generator=gen, device=dev, dtype=dtype), vec(N))
    yield "grid1024_9pt", *stencil_ell(1024, 2, 9, dtype, dev), vec(N)
    for points in (7, 27):
        cols, vals = stencil_ell(64, 3, points, dtype, dev)
        yield f"stencil{points}_64", cols, vals, vec(64 ** 3)
    for cap in (33, 200):
        yield f"random{cap}", *random_ell(65536, cap, dtype, dev, gen), \
            vec(65536)


def library_csr(cols, vals, n):
    """The same operator as a torch sparse CSR tensor (out-of-range
    slots dropped), for the yardstick call only."""
    valid = (cols >= 0) & (cols < n)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=cols.device),
                      torch.cumsum(valid.sum(1), 0)])
    return torch.sparse_csr_tensor(crow, cols[valid].long(), vals[valid],
                                   size=(cols.shape[0], n),
                                   check_invariants=False)


def spmv_bound(card, cols, vals, x):
    """(bound ms, bound_by, bytes): each input read once, y written once,
    2 flops per slot."""
    from otamg_torch.diag.roofline import hbm_rate

    N, cap = cols.shape
    s = vals.element_size()
    nbytes = N * cap * (4 + s) + N * s + x.shape[0] * s
    t_bytes = nbytes / hbm_rate(card)
    t_ops = 2 * N * cap / _PEAK[vals.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def held_to_plain(name, y, cols, vals, x, rtol):
    """Max abs error of ``y`` against the plain version; raises where a
    row is off by more than ``rtol`` of its sum of absolute terms."""
    from otamg_torch.sparse import ell_spmv_plain

    yp = ell_spmv_plain(cols, vals, x)
    scale = ell_spmv_plain(cols, vals.abs(), x.abs())
    err = (y - yp).abs()
    bad = int((err > rtol * scale + 1e-300).sum())
    if bad or not torch.isfinite(y).all():
        raise AssertionError(f"ell_spmv {name}: {bad} rows differ from the "
                             f"plain version beyond rtol {rtol}")
    return float(err.max()) if err.numel() else 0.0


def check_kernel(name, card, cols, vals, x, rtol):
    """``ell_spmv`` against its plain version on the same inputs, then
    its times beside the plain version's and the library call's."""
    from otamg_torch.sparse import ell_spmv, ell_spmv_plain
    from otamg_torch.sparse.kernels import VARIANTS, plan

    y = ell_spmv(cols, vals, x)
    torch.cuda.synchronize()
    max_err = held_to_plain(name, y, cols, vals, x, rtol)
    bound_ms, bound_by, nbytes = spmv_bound(card, cols, vals, x)
    lib = library_csr(cols, vals, x.shape[0])
    ms = cuda_ms(lambda: ell_spmv(cols, vals, x))
    row = dict(
        shape=name, N=cols.shape[0], cap=cols.shape[1], n=x.shape[0],
        dtype=str(vals.dtype).split(".")[-1],
        variant=VARIANTS[plan(cols.shape[1])],
        rtol=rtol, max_abs_err=max_err, ms=ms,
        device_ms=graph_ms(lambda: ell_spmv(cols, vals, x)),
        host_us=host_us(lambda: ell_spmv(cols, vals, x)),
        plain_ms=cuda_ms(lambda: ell_spmv_plain(cols, vals, x)),
        library_ms=cuda_ms(lambda: lib @ x), bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / ms, bytes=nbytes)
    emit("kernel", **row)
    return row


def phase_kernels(card, dev):
    from otamg_torch.sparse import ell_spmv
    from otamg_torch.sparse.kernels import VARIANTS, plan

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for name, cols, vals, x in kernel_shapes(dtype, dev, gen):
            rows[(name, dtype)] = check_kernel(name, card, cols, vals, x,
                                               rtol)
    # Every variant plan() can pick was run above.
    ran = {r["variant"] for r in rows.values()}
    reachable = {VARIANTS[plan(cap)] for cap in range(257)}
    if reachable - ran:
        raise AssertionError(f"variants never checked: {reachable - ran}")
    # Edges: a row count that is no multiple of any tile, cap 0, no rows.
    for N, cap in ((1, 1), (4099, 3), (333, 0), (0, 5), (777, 65)):
        n = max(N, 1)
        cols = torch.randint(-2, n + 2, (N, cap), generator=gen, device=dev,
                             dtype=torch.int32)
        vals = torch.randn(N, cap, generator=gen, device=dev,
                           dtype=torch.float64)
        x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        y = ell_spmv(cols, vals, x)
        torch.cuda.synchronize()
        held_to_plain(f"edge{N}x{cap}", y, cols, vals, x, 1e-12)
    return rows


def segment_bound(card, L, nseg, dtype):
    """(bound ms, bound_by): data and int64 labels read once, the result
    written once; one add per element."""
    from otamg_torch.diag.roofline import hbm_rate

    s = torch.empty((), dtype=dtype).element_size()
    t_bytes = (L * (s + 8) + nseg * s) / hbm_rate(card)
    t_ops = L / _PEAK.get(dtype, _PEAK[torch.float64])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def segment_shapes(dev, gen):
    """(name, data, labels, nseg) at the shapes the paths give
    ``segment_sum``: the component sums of a 500x500, a 1024x1024 and a
    2048x2048 Newton system (one big component and a few small ones) and
    their dense levels, the mixed path's fp32 sweeps, an int64 count,
    random labels, and the sparse-setup smoother's 1,048,576 nodes in one
    segment (a tiled call)."""
    for N in (1000, 2048):
        for L in (N // 2, N):
            yield (f"components{N}_L{L}",
                   torch.randn(L, generator=gen, device=dev,
                               dtype=torch.float64), comps(L, dev), N)
    yield ("components4096_L4096", torch.randn(4096, generator=gen,
                                               device=dev,
                                               dtype=torch.float64),
           comps(4096, dev), 4096)
    yield ("components1000_f32", torch.randn(500, generator=gen, device=dev,
                                             dtype=torch.float32),
           comps(500, dev), 1000)
    yield ("count1000_i64", torch.ones(1000, dtype=torch.int64, device=dev),
           torch.randint(0, 40, (1000,), generator=gen, device=dev), 1000)
    yield ("random16384", torch.randn(16384, generator=gen, device=dev,
                                      dtype=torch.float64),
           torch.randint(0, 16384, (16384,), generator=gen, device=dev),
           16384)
    N = 1 << 20
    yield ("one_segment_1m", torch.randn(N, generator=gen, device=dev,
                                         dtype=torch.float64),
           torch.zeros(N, dtype=torch.int64, device=dev), N)


def comps(L, dev):
    """One big component and 8 singletons: the labels of a Newton
    system's nodes (or of a dense level's)."""
    lab = torch.zeros(L, dtype=torch.int64, device=dev)
    lab[L - 8:] = torch.arange(L - 8, L, device=dev)
    return lab


def segment_row(name, card, fn, plan_fn, noplan_fn, plain_fn, library_fn,
                cpu, scale, L, nseg, dtype, exact):
    """Checks and times of one shape: ``fn()`` the sum over a plan made
    beforehand, ``plan_fn()`` the plan alone, ``noplan_fn()`` the call
    without a plan, ``plain_fn()`` the plain version (``index_add_`` on
    the card), ``library_fn()`` one PyTorch call of the same function;
    ``cpu`` the CPU's sums, ``scale`` the terms' absolute sums."""
    got, again, noplan, plain = fn(), fn(), noplan_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (got.double() - plain.double()).abs()
    # index_add_ on the card rounds in its own order: its sums are held
    # to the kernel's within ~4 ulp of the terms' absolute sum.
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    row = dict(shape=name, L=L, nseg=nseg, dtype=str(dtype).split(".")[-1],
               variant="exact" if exact else "tiled", rtol=rtol,
               max_abs_err=float(err.max()),
               equal_to_cpu=torch.equal(got.cpu(), cpu),
               repeat_equal=torch.equal(got, again),
               noplan_equal=torch.equal(noplan, got))
    ok = (row["repeat_equal"] and row["noplan_equal"]
          and bool((err <= rtol * scale + 1e-300).all())
          and (not exact or row["equal_to_cpu"]))
    bound_ms, bound_by = segment_bound(card, L, nseg, dtype)
    ms = cuda_ms(fn)
    row.update(ms=ms, device_ms=graph_ms(fn), host_us=host_us(fn),
               plan_ms=cuda_ms(plan_fn),
               noplan_ms=cuda_ms(noplan_fn),
               plain_ms=cuda_ms(plain_fn), library_ms=cuda_ms(library_fn),
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms)
    return row, ok


def phase_segment_sum(card, dev):
    """The deterministic ``segment_sum`` against its plain version
    (``index_add_``) on the same inputs, over a plan made beforehand:
    equal to the CPU's sums bit for bit where the call is exact, within
    1e-12 of the terms' absolute sum where it is tiled, equal to itself
    across calls and to the call without a plan; its time (events around
    100 calls; ``device_ms`` the same calls as a CUDA graph, which also
    shows it is capture-safe) beside the plan's build (``plan_ms``), the
    call without a plan, the plain version's and one
    ``torch.index_add`` call's (``library_ms``).  Then the pair form
    ``segment_sum2`` at the bipartite level's halves, against the two
    sums it replaces."""
    from otamg_torch.sparse.segment import (exact, segment_plan, segment_sum,
                                            segment_sum2, segment_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for name, data, labels, nseg in segment_shapes(dev, gen):
        L = data.shape[0]
        plan = segment_plan(labels, nseg)
        zeros = torch.zeros(nseg, dtype=data.dtype, device=dev)
        row, ok = segment_row(
            name, card, lambda: segment_sum(data, labels, nseg, plan),
            lambda: segment_plan(labels, nseg),
            lambda: segment_sum(data, labels, nseg),
            lambda: segment_sum_plain(data, labels, nseg),
            lambda: torch.index_add(zeros, 0, labels, data),
            segment_sum_plain(data.cpu(), labels.cpu(), nseg),
            segment_sum_plain(data.abs(), labels, nseg).double(), L, nseg,
            data.dtype, exact(nseg, L))
        emit("segment_sum", **row)
        if not ok:
            raise AssertionError(f"segment_sum {name} differs from its "
                                 "plain version or from itself")
        rows[name] = row
    # The pair form at the bipartite level's halves (n = m).
    for N in (1000, 2048):
        n = N // 2
        labels = comps(N, dev)
        ab = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
        a, b = ab[:n], ab[n:]
        plan = segment_plan(labels, N, split=n)
        zeros = torch.zeros(N, dtype=ab.dtype, device=dev)
        two = lambda: (segment_sum(a, labels[:n], N)
                       + segment_sum(b, labels[n:], N))
        cpu = (segment_sum_plain(a.cpu(), labels[:n].cpu(), N)
               + segment_sum_plain(b.cpu(), labels[n:].cpu(), N))
        name = f"pair{N}_{n}x{n}"
        row, ok = segment_row(
            name, card, lambda: segment_sum2(a, b, labels, N, plan),
            lambda: segment_plan(labels, N, split=n),
            lambda: segment_sum2(a, b, labels, N),
            lambda: (segment_sum_plain(a, labels[:n], N)
                     + segment_sum_plain(b, labels[n:], N)),
            lambda: torch.index_add(zeros, 0, labels, ab), cpu,
            segment_sum_plain(ab.abs(), labels, N).double(), N, N, ab.dtype,
            exact(N, n))
        # the two sums it replaces, bit for bit (both exact)
        row["equal_to_two_sums"] = torch.equal(
            segment_sum2(a, b, labels, N, plan), two())
        emit("segment_sum2", **row)
        if not (ok and row["equal_to_two_sums"]):
            raise AssertionError(f"segment_sum2 {name} differs from the two "
                                 "sums or from itself")
        rows[name] = row
    return rows


def phase_sparse_amg(dev):
    """The sparse-AMG path: every fine matvec is the ELL kernel.  Returns
    its ``ell_spmv`` launches and its result."""
    from otamg_torch.amg import hierarchy
    from otamg_torch.config import AMGOptions
    from otamg_torch.sparse import ell_spmv, ell_spmv_plain

    nx = 128
    A = grid_csr(nx, 0.01, torch.float64, dev)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(nx * nx),
                        device=dev)
    opts = AMGOptions(maxit=SPARSE_MAXIT)
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    res = hierarchy.amg_solve_matrix(A, b, opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ell_spmv.launches
    if launches == 0:
        raise AssertionError("the sparse-AMG solve launched no ell_spmv")
    true_rel = float(torch.linalg.vector_norm(A.matvec(res.x) - b)
                     / torch.linalg.vector_norm(b))
    # The same solve with every fine matvec through the plain SpMV.
    hierarchy.ell_spmv = ell_spmv_plain
    try:
        ref = hierarchy.amg_solve_matrix(A, b, opts)
    finally:
        hierarchy.ell_spmv = ell_spmv
    dx = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    rel = float(res.rel_res)
    emit("sparse_amg", N=nx * nx, iters=int(res.iters), rel_res=rel,
         true_rel_res=true_rel, plain_iters=int(ref.iters),
         x_rel_vs_plain=dx,
         seconds=secs, ell_spmv_launches=launches)
    if dx > 1e-8 or ref.iters != res.iters:
        raise AssertionError(f"kernel and plain solves differ: {dx:.2e}")
    if not rel <= SPARSE_REL_RES:
        raise AssertionError(f"sparse-AMG rel_res {rel:.3e} above "
                             f"{SPARSE_REL_RES:.1e}")
    return launches, res


# The generic (bigph=0) hierarchy with default options stalls near 1e-3 on
# the 2-D grid Laplacian: in 100 iterations the JAX package on the CPU
# reaches 1.18e-3 on the 64x64 grid, and the port the same.  The card's
# solve runs SPARSE_MAXIT iterations, in which the JAX package on the CPU
# reaches 1.079e-2 on the 64x64 grid, and the port the same
# (cpu_reference.py --grid 64 --maxit 30); the 128x128 solve must do at
# least as well (see PERF.md).
SPARSE_MAXIT = 30
SPARSE_REL_RES = 1.1e-2


# The JAX package's solves on the CPU of random_class1(PRNGKey(0), N, N)
# with class1_opts() in f64 (cpu_reference.py --size N).
CLASS1_REF = {
    256: dict(converged=True, iters=52, fail_count=0,
              fxk=1.151894055677567),
    500: dict(converged=True, iters=55, fail_count=0,
              fxk=1.0810500251100321),
    1024: dict(converged=True, iters=51, fail_count=0,
               fxk=1.1383636551928127),
}


def held_to_class1_reference(size, res):
    """The numbers of a Class-1 f64 solve beside the JAX CPU run's;
    raises unless ``converged``, the outer iterations and ``fail_count``
    are equal and the objective agrees to 1e-8."""
    ref = CLASS1_REF[size]
    row = dict(converged=res.converged, iters=res.iters,
               fail_count=res.fail_count, fxk=float(res.fxk[-1]),
               ssn_total=int(res.ssn_itnum.sum()),
               inner_total=res.inner_total,
               fxk_rel_vs_cpu=abs(res.fxk[-1] - ref["fxk"]) / ref["fxk"],
               cpu=ref)
    if not (res.converged == ref["converged"] and res.iters == ref["iters"]
            and res.fail_count == ref["fail_count"]
            and row["fxk_rel_vs_cpu"] <= 1e-8):
        emit(f"class1_{size}_mismatch", **row,
             ssn_itnum=[int(v) for v in res.ssn_itnum])
        raise AssertionError(f"Class-1 {size}x{size} differs from the JAX "
                             "CPU f64 run")
    return row


def class1_opts(solve_dtype=None):
    """``bench.py``'s Class-1 options: AMG inner solver, F-cycle,
    fuse_deep, and the Newton solves in ``solve_dtype``."""
    from otamg_torch.config import AMGOptions, APDOptions, Cycle, InnerSolver

    return APDOptions(inner_solver=InnerSolver.AMG, solve_dtype=solve_dtype,
                      amg=AMGOptions(cycle=Cycle.F, fuse_deep=True))


def path_state() -> dict:
    """The counters a run's numbers are taken from (host reads, the
    setup's stats, the bodies of ``when`` that ran, the CUDA graphs'
    captures and replays, the kernels' launches)."""
    from otamg_torch.amg.hierarchy import amg_graphs, setup_stats
    from otamg_torch.device import fetch
    from otamg_torch.hybrid.solver import front_graphs, refine_graphs
    from otamg_torch.opt.regions import step_graphs

    from otamg_torch import graphs

    setups, repairs, rounds, bails = setup_stats.read()
    bodies = {f"bodies_{k}": v for k, v in graphs.cond_counts.read().items()}
    return dict(reads=fetch.reads, setups=setups, repairs=repairs,
                set_if=set_if_launches(), **bodies,
                rounds=rounds, bails=bails,
                front_captures=front_graphs.captures,
                front_replays=front_graphs.replays,
                refine_captures=refine_graphs.captures,
                refine_replays=refine_graphs.replays,
                refine_reads=count_refinement.reads,
                eager_correction_solves=count_refinement.eager,
                amg_captures=amg_graphs.captures,
                amg_replays=amg_graphs.replays,
                step_captures=step_graphs.captures,
                step_replays=step_graphs.replays, segment_sum=counts(),
                **setup_counts())


# The numbers of the last run_class1 or run_class2 call (run_numbers).
LAST = {}


def run_numbers(res, before, sync, secs) -> dict:
    """A run's numbers from the counters before it, its syncs and its
    seconds: per outer iteration the host reads (``fetch``), all syncs
    and the syncs besides the reads (copies from pageable memory and
    other hidden syncs, with their top sites); per Newton solve the
    front's CUDA graph replays (transform, components and setup), the
    AMG block's, the defect repairs; per
    SsN step (one Newton solve each) the outer step's region replays;
    the MIS rounds per setup; the bodies of ``when`` that ran
    (``bodies``: repairs built, AMG cycles, refinement cycles, Armijo
    trials) beside the solve's inner iterations; the kernels' launches."""
    from otamg_torch.graphs import COND_NAMES

    d = {k: v - before[k] for k, v in path_state().items()}
    iters = max(res.iters, 1)
    newton = max(int(res.ssn_itnum.sum()), 1)
    return dict(
        seconds=secs, newton_solves=newton, setups=d["setups"],
        host_reads_per_outer_iter=d["reads"] / iters,
        syncs_per_outer_iter=sync.total / iters,
        other_syncs_per_outer_iter=(sync.total - d["reads"]) / iters,
        other_sync_sites={k: v for k, v in sync.sites.most_common(8)
                          if not k.startswith("device.py")},
        front_captures=d["front_captures"],
        front_replays_per_newton_solve=d["front_replays"] / newton,
        amg_captures=d["amg_captures"],
        amg_replays_per_newton_solve=d["amg_replays"] / newton,
        step_captures=d["step_captures"],
        step_replays=d["step_replays"],
        step_replays_per_ssn_step=d["step_replays"] / newton,
        repairs=d["repairs"], repairs_per_newton_solve=d["repairs"] / newton,
        mis_rounds_per_setup=d["rounds"] / max(d["setups"], 1),
        mis_bails=d["bails"],
        refine_captures=d["refine_captures"],
        refine_replays=d["refine_replays"],
        refine_reads=d["refine_reads"],
        eager_correction_solves=d["eager_correction_solves"],
        bodies={k: d[f"bodies_{k}"] for k in COND_NAMES},
        inner_iters=int(res.inner_total),
        launches={k: d[k] for k in ("segment_sum", "mis_rounds",
                                    "coarse_eigh", "label_rounds",
                                    "plain_label_rounds_on_card",
                                    "bip_smooth", "bip_smooth_runs",
                                    "plain_bip_smooth_on_card",
                                    "set_if")})


def run_class1(m, n, dev, opts, solve=None):
    """(result, seconds, host reads per outer iteration) of ``solve``
    (the loop driver by default) on ``random_class1(PRNGKey(0), m, n)``;
    the rest of its numbers in :data:`LAST`."""
    from otamg_torch.opt import solve_class1
    from otamg_torch.ot import random_class1
    from otamg_torch.random import PRNGKey

    prob = random_class1(PRNGKey(0), m, n, device=dev)
    torch.cuda.synchronize()
    before = path_state()
    with SyncCount() as sync:
        t0 = time.perf_counter()
        res = (solve or solve_class1)(prob, opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    X = res.X
    if not (X.shape == (m, n) and bool(torch.isfinite(X).all())
            and bool((X >= 0).all())):
        raise AssertionError(f"{m}x{n}: plan is not finite and nonnegative")
    LAST.clear()
    LAST.update(run_numbers(res, before, sync, secs))
    return res, secs, LAST["host_reads_per_outer_iter"]


def phase_class1(dev):
    from scipy.optimize import linprog

    from otamg_torch.config import AMGOptions, APDOptions, Cycle, InnerSolver
    from otamg_torch.opt import solve_class1
    from otamg_torch.ot import random_class1
    from otamg_torch.random import PRNGKey

    # Small problem: the card against the CPU and against an LP solver.
    small = APDOptions(inner_solver=InnerSolver.AMG, amg=AMGOptions(
        cycle=Cycle.F, fuse_deep=True, coarse_target=6))
    t0 = time.perf_counter()
    on_card = solve_class1(random_class1(PRNGKey(42), 24, 20, device=dev),
                           small)
    cpu_prob = random_class1(PRNGKey(42), 24, 20, device="cpu")
    on_cpu = solve_class1(cpu_prob, small)
    m, n = 24, 20
    A_eq = np.vstack([np.kron(np.eye(n), np.ones((1, m))),
                      np.kron(np.ones((1, n)), np.eye(m))])
    lp = linprog(cpu_prob.C.numpy().ravel(order="F"), A_eq=A_eq,
                 b_eq=cpu_prob.b.numpy(), bounds=(0, None), method="highs")
    k = min(len(on_card.fxk), len(on_cpu.fxk))
    fx_rel = float(np.max(np.abs(on_card.fxk[:k] - on_cpu.fxk[:k])
                          / np.abs(on_cpu.fxk[:k])))
    lp_rel = abs(on_card.fxk[-1] - lp.fun) / abs(lp.fun)
    emit("class1_small", m=m, n=n, iters=on_card.iters,
         cpu_iters=on_cpu.iters, fail_count=on_card.fail_count,
         fxk_rel_vs_cpu=fx_rel, fxk_rel_vs_linprog=lp_rel,
         seconds=time.perf_counter() - t0)
    if not (on_card.converged and on_card.iters == on_cpu.iters
            and fx_rel <= 1e-8 and lp_rel < 1e-5):
        raise AssertionError("24x20 solve on the card disagrees with the "
                             "CPU run or with linprog")

    opts = class1_opts()
    runs = {}
    res, secs, reads = run_class1(256, 256, dev, opts)
    runs[(256, "once")] = secs
    emit("class1_256", seconds=secs, host_reads_per_outer_iter=reads,
         **held_to_class1_reference(256, res))
    for label in ("cold", "warm"):
        # The main path's launches: the counts set to 0 just before the
        # run and read just after.
        zero_counts()
        res, secs, reads = run_class1(500, 500, dev, opts)
        launches = dict(segment_sum=counts(), **setup_counts())
        runs[(500, label)] = secs
        warm = (res, secs, reads, dict(LAST))
        emit("class1_500", run=label, **LAST,
             **held_to_class1_reference(500, res))
    plain = (launches["plain_label_rounds_on_card"]
             + launches["plain_bip_smooth_on_card"])
    if plain or not all(v for k, v in launches.items()
                        if not k.startswith("plain_")):
        raise AssertionError(f"the Class-1 solve left a kernel unlaunched or "
                             f"ran plain label rounds: {launches}")
    res, secs, reads = run_class1(1024, 1024, dev, opts)
    loop1024 = (res, secs, reads, dict(LAST))
    emit("class1_1024", **LAST, **held_to_class1_reference(1024, res))
    runs[(1024, "once")] = secs
    return runs, warm, launches, loop1024


def class2_opts(solve_dtype=None):
    """``bench.py``'s Class-2 options (the budget ``maxit=40, smoth=10``,
    ``ssn_tol1=1e-10``, no polish), the Newton solves in
    ``solve_dtype``."""
    from otamg_torch.config import AMGOptions, APDOptions, Cycle, InnerSolver

    return APDOptions(inner_solver=InnerSolver.AMG, ssn_tol1=1e-10,
                      solve_dtype=solve_dtype,
                      amg=AMGOptions(maxit=40, smoth=10, cycle=Cycle.F,
                                     fuse_deep=True), feas_polish=False)


def run_class2(m, n, dev, opts, solve=None):
    """As :func:`run_class1`, for ``random_class2(PRNGKey(0), m, n)``."""
    from otamg_torch.opt import solve_class2
    from otamg_torch.ot import random_class2
    from otamg_torch.random import PRNGKey

    prob = random_class2(PRNGKey(0), m, n, device=dev)
    torch.cuda.synchronize()
    before = path_state()
    with SyncCount() as sync:
        t0 = time.perf_counter()
        res = (solve or solve_class2)(prob, opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    ok = all(t.shape == s and bool(torch.isfinite(t).all())
             and bool((t >= 0).all())
             for t, s in ((res.X, (m, n)), (res.y, (n,)), (res.z, (m,))))
    if not ok:
        raise AssertionError(f"{m}x{n}: x, y, z are not finite and "
                             "nonnegative")
    mass = float((prob.Phi * res.X).sum())
    if res.converged and abs(mass - float(prob.mu)) > 1e-4 * float(prob.mu):
        raise AssertionError(f"{m}x{n}: <phi, x> = {mass} misses mu")
    LAST.clear()
    LAST.update(run_numbers(res, before, sync, secs))
    return res, secs, LAST["host_reads_per_outer_iter"]


def class2_lp(prob):
    """The Class-2 LP over ``(x, y, z)`` for ``linprog``."""
    m, n = prob.m, prob.n
    A = np.vstack([np.kron(np.eye(n), prob.p.numpy()[None, :]),
                   np.kron(prob.q.numpy()[None, :], np.eye(m))])
    G = np.vstack([A, prob.Phi.numpy().ravel(order="F")[None, :]])
    IY = np.vstack([np.eye(n), np.zeros((m + 1, n))])
    IZ = np.vstack([np.zeros((n, m)), np.eye(m), np.zeros((1, m))])
    c = np.concatenate([prob.C.numpy().ravel(order="F"), np.zeros(n + m)])
    return c, np.hstack([G, IY, IZ]), prob.b.numpy()


def phase_class2(dev):
    from scipy.optimize import linprog

    from otamg_torch.opt import solve_class2
    from otamg_torch.opt.apd2 import default_class2_options
    from otamg_torch.ot import random_class2
    from otamg_torch.random import PRNGKey

    # Small problem: the card against the CPU and against an LP solver.
    small = default_class2_options()
    m, n = 20, 16
    t0 = time.perf_counter()
    on_card = solve_class2(random_class2(PRNGKey(7), m, n, mu_frac=0.6,
                                         device=dev), small)
    cpu_prob = random_class2(PRNGKey(7), m, n, mu_frac=0.6, device="cpu")
    on_cpu = solve_class2(cpu_prob, small)
    c, A_eq, b_eq = class2_lp(cpu_prob)
    lp = linprog(c, A_eq=A_eq, b_eq=b_eq, bounds=(0, None), method="highs")
    k = min(len(on_card.fxk), len(on_cpu.fxk))
    fx_rel = float(np.max(np.abs(on_card.fxk[:k] - on_cpu.fxk[:k])
                          / np.abs(on_cpu.fxk[:k])))
    lp_rel = abs(on_card.fxk[-1] - lp.fun) / abs(lp.fun)
    emit("class2_small", m=m, n=n, iters=on_card.iters,
         cpu_iters=on_cpu.iters, fail_count=on_card.fail_count,
         cpu_fail_count=on_cpu.fail_count, fxk_rel_vs_cpu=fx_rel,
         fxk_rel_vs_linprog=lp_rel, seconds=time.perf_counter() - t0)
    if not (on_card.converged and on_card.iters == on_cpu.iters
            and on_card.fail_count == on_cpu.fail_count
            and fx_rel <= 1e-8 and lp_rel < 1e-5):
        raise AssertionError("20x16 Class-2 solve on the card disagrees "
                             "with the CPU run or with linprog")

    opts = class2_opts()
    runs = {}
    res, secs, reads = run_class2(500, 500, dev, opts)
    runs[(500, "once")] = secs
    loop500 = (res, secs, reads, dict(LAST))
    emit("class2_500", run="once", **LAST, **held_to_reference(500, res),
         fxk_trajectory=res.fxk.tolist(), ssn_itnum=res.ssn_itnum.tolist())
    # 1024x1024 through the chunked driver (the loop driver's trajectory
    # in about a third of its time, phase setup_graph).
    from otamg_torch.opt import solve_class2_chunked

    res, secs, reads = run_class2(1024, 1024, dev, opts,
                                  lambda p, o: solve_class2_chunked(p, o))
    emit("class2_1024", driver="chunked", seconds=secs,
         host_reads_per_outer_iter=reads, **held_to_reference(1024, res))
    runs[(1024, "once")] = secs
    return runs, loop500


# The JAX package's solves of random_class2(PRNGKey(0), N, N) with
# class2_opts() on the CPU in f64 (cpu_reference.py --class2 --size N):
# outcome, objective and the SsN steps of the outer iterations up to the
# first one whose Newton solve ends at the 40-cycle cap.  From there on the
# AMG residual sits at the f64 rounding floor (retol 1e-11) and the order
# of the sums decides single SsN steps and cap hits: the port on the CPU
# parts from JAX at iteration 64 at 500x500, the card at 65, and the
# card's own runs differ (index_add_ sums in no fixed order).  At 500x500
# the solve does not reach KKT 1e-6 in 100 iterations (ROADMAP.md Queue 3).
CLASS2_REF = {
    500: dict(converged=False, iters=100, fail_count=30,
              fxk=0.3628284827948543,
              ssn_head=[4, 10, 8, 5, 7, 4, 3, 4, 7, 7, 6, 7, 9, 6, 7, 3, 4,
                        3, 2, 3, 2, 1, 2, 1, 1, 1, 1, 4, 2, 2]),
    1024: dict(converged=True, iters=60, fail_count=45,
               fxk=0.3842261085246217,
               ssn_head=[5, 10, 5, 4, 6, 6, 3, 4, 5, 6, 8, 11, 9, 9, 6, 6,
                         9, 5, 4]),
}
# A converged run may end this many outer iterations from the reference's:
# the feasibility residual crosses 1e-6 at 4-8% an iteration, and the
# rounding-driven tail moves it.
ITERS_SLACK = 3


def held_to_reference(size, res):
    """The numbers of a Class-2 solve beside the JAX CPU f64 run's;
    raises unless ``converged`` is equal, the outer iterations equal (or,
    converged, within ``ITERS_SLACK``), the objective agrees to 1e-8, the
    x/y/z residuals are at target and the SsN steps equal the reference's
    through its head."""
    ref = CLASS2_REF[size]
    head = ref["ssn_head"]
    rel = res.kkt[-1] / (1 + res.kkt[0])
    ssn = [int(v) for v in res.ssn_itnum]
    row = dict(converged=res.converged, iters=res.iters,
               fail_count=res.fail_count, fxk=float(res.fxk[-1]),
               polished=res.polished, inner_total=res.inner_total,
               rel_kkt=rel.tolist(),
               fxk_rel_vs_cpu=abs(res.fxk[-1] - ref["fxk"]) / ref["fxk"],
               ssn_head_equal=ssn[:len(head)] == head,
               cpu={k: v for k, v in ref.items() if k != "ssn_head"})
    slack = ITERS_SLACK if ref["converged"] else 0
    if not (res.converged == ref["converged"]
            and abs(res.iters - ref["iters"]) <= slack
            and row["fxk_rel_vs_cpu"] <= 1e-8 and rel[:3].max() <= 1e-6
            and row["ssn_head_equal"]):
        emit(f"class2_{size}_mismatch", **row, ssn_itnum=ssn)
        raise AssertionError(f"Class-2 {size}x{size} differs from the JAX "
                             "CPU f64 run")
    return row


def clone_level(lv):
    """A copy of a level (a NamedTuple of tensors and of a plan)."""
    return type(lv)(*(clone_level(f) if isinstance(f, tuple) else f.clone()
                      for f in lv))


class Recorder:
    """Inside a ``with`` block, the inputs of the first ``mis_rounds``
    call of each size (``mis``), the first ``coarse_eigh`` call of each
    size (``eigh``), the first ``label_rounds`` call's mask (``mask``),
    the first 8 ``newton_front`` calls (``setup``: args and keywords)
    and the first ``_projected_smooth_bip`` call of each ``(transpose,
    e_is_zero, deflated)`` (``smooth``: the level, ``e``, ``r``,
    ``smoth_it``, ``nseg``), cloned, where the package's modules look
    them up."""

    def __enter__(self):
        from otamg_torch.amg import graph, hierarchy
        from otamg_torch.hybrid import solver

        self.mis, self.eigh, self.setup, self.mask = {}, {}, [], []
        self.smooth = {}
        self.saved = [(graph, "mis_rounds"), (hierarchy, "coarse_eigh"),
                      (solver, "newton_front"), (graph, "label_rounds"),
                      (hierarchy, "_projected_smooth_bip")]
        mis, eigh, setup, labels, smooth = (getattr(m, a)
                                            for m, a in self.saved)
        keep = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

        def smooth_rec(lv, e, r, smoth_it, transpose, nseg, deflated,
                       e_is_zero):
            key = (transpose, e_is_zero, deflated)
            if key not in self.smooth:
                self.smooth[key] = (clone_level(lv), e.clone(), r.clone(),
                                    smoth_it, nseg)
            return smooth(lv, e, r, smoth_it, transpose, nseg, deflated,
                          e_is_zero)

        def mis_rec(*a, **kw):
            self.mis.setdefault(a[0].shape[0], tuple(map(keep, a[:5])))
            return mis(*a, **kw)

        def eigh_rec(A):
            self.eigh.setdefault(A.shape[0], A.clone())
            return eigh(A)

        def setup_rec(*a, **kw):
            if len(self.setup) < 8:
                self.setup.append((tuple(map(keep, a)), dict(kw)))
            return setup(*a, **kw)

        def labels_rec(E, *a, **kw):
            if not self.mask:
                self.mask.append(E.clone())
            return labels(E, *a, **kw)

        self.saved = [(m, a, getattr(m, a)) for m, a in self.saved]
        graph.mis_rounds = mis_rec
        hierarchy.coarse_eigh = eigh_rec
        solver.newton_front = setup_rec
        graph.label_rounds = labels_rec
        hierarchy._projected_smooth_bip = smooth_rec
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


# The method's operations a round: the local max and the C-neighbour
# pass each AND every 32-bit word of As's bits with a mask word once.
# The card's rate for 32-bit logic is 64 lanes an SM a clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), half its 128 fp32 lanes, whose FMAs count twice in
# the 67 TFLOP/s: a quarter of that figure.
_WORD_RATE = _PEAK[torch.float32] / 4


def mis_bound(card, c, rounds):
    """(bound ms, bound_by): As, active and deg read once, three flags
    written; 2 c ceil(c/32) word operations a round of this run."""
    from otamg_torch.diag.roofline import hbm_rate

    t_bytes = (c * c + 5 * c + 3 * c + 8) / hbm_rate(card)
    t_ops = 2 * c * -(-c // 32) * rounds / _WORD_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# The card's peak for the eigensolver's f64 and f32 work: 67 TFLOP/s,
# f64 on the tensor cores (DMMA) and f32 off them (NVIDIA's data sheet).
_EIGH_PEAK = 67e12


def eigh_bound(card, n, dtype):
    """(bound ms, bound_by): the kernel's method needs ~(4/3) n^3 flops
    to tridiagonalise and 2 n^3 to back-transform (the Sturm counts and
    the inverse iteration are O(n^2) a round or a vector), at
    :data:`_EIGH_PEAK`; A read once, the eigenpairs written once."""
    from otamg_torch.diag.roofline import hbm_rate

    s = torch.empty((), dtype=dtype).element_size()
    t_bytes = ((2 * n * n + n) * s + 4) / hbm_rate(card)
    t_ops = (10 / 3) * n ** 3 / _EIGH_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Synthetic level-1 graphs (``level1_graph``): one of the size of the
# CLI's small problems' levels (12 of the cluster's 16 blocks own no
# row), two whose first coarsening a 2048^2 and a 4096^2 plan would give
# (the bits in the cluster's shared memory) and one past them (the bits
# in the global workspace); and a deep level of 128 nodes (``deep_graph``).
MIS_SYNTHETIC = (100, 2048, 4096, 6144)
MIS_DEEP = 128
MIS_DENSITY = 0.2


def mis_args(As, active, tie):
    """``(As, active, deg, Ncnt, N0)`` as ``mis_split`` hands them to
    ``mis_rounds``, with the degrees' ties ``tie``."""
    f32 = torch.float32
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    return As, active, torch.where(deg0 > 0, deg0 + tie, 0.0), Ncnt, N0


def level1_graph(c, dev):
    """:func:`mis_args` of a graph shaped like a plan's first
    coarsening: every node active, each pair strongly connected with
    probability :data:`MIS_DENSITY` (a generator seeded with ``c``;
    symmetric, no diagonal), the degrees' ties ``mis_draws(PRNGKey(c))``."""
    from otamg_torch import random as jr

    gen = torch.Generator(device=dev).manual_seed(c)
    up = torch.triu(torch.rand(c, c, generator=gen, device=dev)
                    < MIS_DENSITY, 1)
    tie = jr.to_device(jr.mis_draws(jr.PRNGKey(c), c), dev)[0]
    return mis_args(up | up.T, torch.ones(c, dtype=torch.bool, device=dev),
                    tie)


def deep_graph(c, dev):
    """:func:`mis_args` of a graph shaped like a plan's deeper levels:
    about 15% of the nodes active (three at least), each tied to one or
    two other active nodes (a generator seeded with ``c``), the ties
    ``mis_draws(PRNGKey(c))``."""
    from otamg_torch import random as jr

    gen = torch.Generator().manual_seed(c)
    active = torch.rand(c, generator=gen) < 0.15
    active[:3] = True
    idx = active.nonzero().flatten()
    As = torch.zeros(c, c, dtype=torch.bool)
    for i in idx.tolist():
        others = idx[idx != i]
        k = 1 + int(torch.randint(2, (), generator=gen))
        j = others[torch.randperm(len(others), generator=gen)[:k]]
        As[i, j] = As[j, i] = True
    tie = jr.to_device(jr.mis_draws(jr.PRNGKey(c), c), dev)[0]
    return mis_args(As.to(dev), active.to(dev), tie)


def mis_checks(card, dev, recs):
    """``mis_rounds`` against ``mis_rounds_plain`` on the card, on the
    strength graphs of the first Newton solve's hierarchies (``recs``:
    size -> Recorder), on a graph whose MIS bails out (the whole
    split, bail-out selection included, against the CPU's) and on the
    synthetic graphs of :data:`MIS_SYNTHETIC` and :data:`MIS_DEEP`: equal
    splits and rounds;
    times, layout, active nodes and strong neighbours a row at each
    shape."""
    from otamg_torch import random as jr
    from otamg_torch.amg.graph import mis_split
    from otamg_torch.amg.kernels import (mis_layout, mis_rounds,
                                         mis_rounds_plain)

    cases = [(f"class1_{size}_c{c}", args) for size, rec in recs.items()
             for c, args in sorted(rec.mis.items(), reverse=True)]
    # Two strong edges among 500 nodes: too few connected nodes, so the
    # MIS bails out (and its rounds stop at once).
    As = torch.zeros(500, 500, dtype=torch.bool, device=dev)
    As[0, 1] = As[1, 0] = As[2, 3] = As[3, 2] = True
    active = torch.ones(500, dtype=torch.bool, device=dev)
    draws = jr.to_device(jr.mis_draws(jr.PRNGKey(11), 500), dev)
    got, want = mis_split(As, active, draws), mis_split(
        As.cpu(), active.cpu(), draws.cpu())
    bail_ok = all(torch.equal(a.cpu(), b) for a, b in
                  zip((*got[0], got[1], got[2]),
                      (*want[0], want[1], want[2])))
    cases.append(("bail_c500", mis_args(As, active, draws[0])))
    cases += [(f"synthetic_c{c}", level1_graph(c, dev))
              for c in MIS_SYNTHETIC]
    cases.append((f"deep_c{MIS_DEEP}", deep_graph(MIS_DEEP, dev)))
    rows = {}
    for name, args in cases:
        k = mis_rounds(*args)
        p = mis_rounds_plain(*args)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(k, p))
        c, rounds = args[0].shape[0], int(k[3])
        layout, blocks = mis_layout(c)[:2]
        bound_ms, bound_by = mis_bound(card, c, rounds)
        ms = cuda_ms(lambda: mis_rounds(*args))
        row = dict(shape=name, c=c, rounds=rounds, layout=layout,
                   blocks=blocks, active=int(args[1].sum()),
                   strong_per_row=float(args[0].sum()) / c,
                   equal_to_plain=equal,
                   max_abs_err=0.0 if equal else 1.0, ms=ms,
                   device_ms=graph_ms(lambda: mis_rounds(*args)),
                   plain_ms=cuda_ms(lambda: mis_rounds_plain(*args), 10),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms)
        if name == "bail_c500":
            row["bail_split_equal_to_cpu"] = bail_ok
            row["bailed"] = bool(got[2])
        emit("mis_rounds", **row)
        if not (equal and (name != "bail_c500" or (bail_ok and got[2]))):
            raise AssertionError(f"mis_rounds {name} differs from its plain "
                                 "version")
        rows[name] = row
    return rows


EIGH_C = 30


def clustered_matrix(n, gen, dev):
    """``Q diag(lam) Q^T``, ``Q`` orthogonal from a seeded Gaussian:
    eigenvalues spread over [1, 10], 3.0 six times and 0 four times."""
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device=dev,
                                       dtype=torch.float64))
    lam = torch.linspace(1.0, 10.0, n, dtype=torch.float64, device=dev)
    lam[:4] = 0.0
    lam[10:16] = 3.0
    return (Q * lam) @ Q.T


def eigh_checks(card, dev, recs):
    """``coarse_eigh`` against ``torch.linalg.eigh`` at n = 8, 64, 99,
    123 and 128, f64 and f32: the coarsest matrices of the first Newton
    solve's hierarchies at 1024^2 (99) and 500^2 (123), random symmetric
    ones at the other sizes.  Random symmetric ones at n = 191 (Class 1
    8192^2's coarsest capacity), 256, 400 and 600 keep the matrix in the
    global workspace in f64 (:func:`otamg_torch.amg.kernels.eigh_layout`;
    600 also takes the back-transformation from global memory),
    and the clustered matrix (:func:`clustered_matrix`) at n = 123 and
    400 leaves clusters for the inverse iteration's Gram-Schmidt.  Held,
    in 1-norms, with ``c = 30``, the
    threshold of LAPACK's own eigensolver tests (``xSYT21``'s ratios
    ``||A V - V diag(lam)|| / (n ulp ||A||)`` and ``||V^T V - I|| / (n
    ulp)``): ``info`` 0; eigenvalues within ``c n eps ||A||``; ``||A V -
    V diag(lam)|| <= c n eps ||A||`` and ``||V^T V - I|| <= c n eps``;
    the filtered coarse solve
    ``V diag(einv) V^T r`` (the setup's cutoff rule) within
    ``10 n eps kappa`` of eigh's, ``kappa`` = ``||A||`` over the least
    eigenvalue kept."""
    from otamg_torch.amg.kernels import (coarse_eigh, coarse_eigh_plain,
                                         eigh_layout)
    from otamg_torch.config import AMGOptions

    gen = torch.Generator(device=dev).manual_seed(13)
    mats = [("coarsest level", A) for rec in recs.values()
            for A in rec.eigh.values()]
    for n in (8, 64, 128, 191, 256, 400, 600):
        B = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
        mats.append(("random symmetric", 0.5 * (B + B.T)))
    mats += [("clustered", clustered_matrix(n, gen, dev)) for n in (123, 400)]
    rows = {}
    for source, A0 in sorted(mats, key=lambda m: (m[1].shape[0], m[0])):
        n = A0.shape[0]
        for dtype in (torch.float64, torch.float32):
            A = A0.to(dtype).contiguous()
            lam, V, info = coarse_eigh(A)
            ref_lam, ref_V = torch.linalg.eigh(A)
            eps = torch.finfo(dtype).eps
            nA = float(ref_lam.abs().max())
            A64, V64, lam64 = A.double(), V.double(), lam.double()
            nA1 = float(torch.linalg.matrix_norm(A64, ord=1))
            lam_err = float((lam64 - ref_lam.double()).abs().max())
            res = float(torch.linalg.matrix_norm(A64 @ V64 - V64 * lam64,
                                                 ord=1)) / nA1
            orth = float(torch.linalg.matrix_norm(
                V64.T @ V64 - torch.eye(n, dtype=torch.float64, device=dev),
                ord=1))
            factor = (4.0 if dtype == torch.float64
                      else AMGOptions().coarse_cutoff_ulps)
            r = torch.randn(n, generator=gen, device=dev,
                            dtype=torch.float64).to(dtype)

            def filtered(lam, V):
                cut = factor * eps * lam.abs().amax()
                einv = torch.where(lam > cut, 1.0 / torch.where(
                    lam > cut, lam, 1.0), 0.0)
                return (V @ (einv * (V.T @ r))).double(), cut

            x, _ = filtered(lam, V)
            x_ref, cut = filtered(ref_lam, ref_V)
            kept = ref_lam[ref_lam > cut]
            kappa = nA / float(kept.min()) if kept.numel() else 1.0
            x_err = float((x - x_ref).norm() / x_ref.norm().clamp_min(1e-300))
            tol = EIGH_C * n * eps
            ok = (int(info) == 0 and lam_err <= tol * nA
                  and res <= tol and orth <= tol
                  and x_err <= 10 * n * eps * kappa)
            bound_ms, bound_by = eigh_bound(card, n, dtype)
            reps = REPS if n <= 128 else 10
            ms = cuda_ms(lambda: coarse_eigh(A), reps)
            name = str(dtype).split(".")[-1]
            row = dict(n=n, dtype=name,
                       layout=eigh_layout(n, A.element_size())[0],
                       source=source, info=int(info), max_abs_err=lam_err,
                       lam_tol=tol * nA, residual=res,
                       residual_tol=tol, orthogonality=orth,
                       coarse_solve_rel_err=x_err,
                       coarse_solve_tol=10 * n * eps * kappa, kappa=kappa,
                       ms=ms,
                       device_ms=graph_ms(lambda: coarse_eigh(A), reps),
                       plain_ms=cuda_ms(lambda: coarse_eigh_plain(A), reps),
                       library_ms=cuda_ms(lambda: torch.linalg.eigh(A),
                                          reps),
                       bound_ms=bound_ms, bound_by=bound_by,
                       share_of_bound=bound_ms / ms)
            emit("coarse_eigh", **row)
            if not ok:
                raise AssertionError(f"coarse_eigh {source} n={n} {dtype} "
                                     "misses its tolerances")
            rows[(source, n, dtype)] = row
    return rows


def setup_sizes_checked():
    """Every Class-1/2 size this script solves has its coarsest capacity
    within the eigh kernel's shared memory (``coarse_target`` 128;
    layout 0, the matrix in shared memory, holds f64 up to n = 161), so
    every setup of the path runs its fast layout."""
    from otamg_torch.amg.hierarchy import capacity_schedule
    from otamg_torch.amg.kernels import eigh_layout

    amg = class1_opts().amg
    caps = {N: capacity_schedule(N, 2 * N, amg)[-1]
            for N in (128, 256, *SETUP_SIZES)}
    emit("coarsest_capacity", **{str(k): v for k, v in caps.items()})
    if any(eigh_layout(c, 8)[0] for c in caps.values()):
        raise AssertionError(f"a coarsest level past the eigh kernel's "
                             f"shared memory: {caps}")
    return caps


def ideal_branch_ms(dense, dev):
    """Device ms of the defect repair's extra work at each coarsening of
    a hierarchy (``dense``: its levels): the ideal interpolation's
    ``solve_ex`` of a c x c system with c right-hand sides and the
    repaired level's Galerkin product, on the level's matrix with an
    alternating C/F split, replayed in a CUDA graph."""
    out = []
    for lv, nxt in zip(dense[:-1], dense[1:]):
        A = lv.A
        c, cn = A.shape[0], nxt.A.shape[0]
        isF = torch.arange(c, device=dev) % 2 == 1
        isC = ~isF
        ff = isF[:, None] & isF[None, :]
        Aff = torch.where(ff, A, 0.0) + torch.diag((~isF).to(A.dtype))
        Afc = torch.where(isF[:, None] & isC[None, :], A, 0.0)
        P = torch.zeros(c, cn, dtype=A.dtype, device=dev)

        def branch():
            W = -torch.linalg.solve_ex(Aff, Afc, check_errors=False).result
            Pn = (W + torch.diag(isC.to(A.dtype)))[:, :cn] + P
            return 0.5 * (Pn.T @ (A @ Pn))

        out.append(graph_ms(branch, 10))
    return out


def front_checks(dev, recs):
    """The first Newton solve's front (``newton_front``'s recorded
    arguments: transform, components, setup) at 500^2 and 1024^2:
    eagerly under ``torch.cuda.set_sync_debug_mode("error")`` (no sync at
    all), then captured and replayed, equal to the eager front (every
    tensor, the levels and the deep matrix) bit for bit with no host
    read or sync around the replay; the eager front's wall ms, the
    replay's wall and device ms, the replay's host microseconds (the
    draws' hashing, the graph launch, the whole call), and the defect
    repair's extra device ms per Newton solve (:func:`ideal_branch_ms`)
    beside the replay's."""
    from otamg_torch import random as jr
    from otamg_torch.amg import hierarchy
    from otamg_torch.device import fetch
    from otamg_torch.hybrid import solver

    rows = {}
    for size, rec in recs.items():
        # S, tvec, bk1, tk, p, q, opts, key and the solve dtype.
        args = rec.setup[0][0][:9]
        front = lambda k=1: solver.newton_front(*args, exit_every=k)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = front()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        solver.front_graphs.clear()
        for _ in range(2):
            reads0 = fetch.reads
            with SyncCount() as sync:
                got = front(8)
            reads = fetch.reads - reads0
        flat = lambda fr: [*fr[:9], *(t for lv in (fr.lv1, *fr.dense)
                                      for t in hierarchy._leaves(lv)),
                           fr.deep]
        equal = all(torch.equal(a, b) for a, b in zip(flat(got),
                                                      flat(eager)))
        blk = next(iter(solver.front_graphs.blocks.values()))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            blk.graph.replay()
        ev[1].record()
        ev[1].synchronize()
        replay_device = ev[0].elapsed_time(ev[1]) / 10
        ideal = ideal_branch_ms(eager.dense, dev)
        levels = [lv.A.shape[0] for lv in eager.dense]
        # The replay's host time, split: the draws' hashing, the graph
        # launch alone, the whole call.
        host = dict(draws_us=host_us(lambda: jr.setup_draws(args[7],
                                                            levels[:-1]), 20),
                    graph_launch_us=host_us(blk.graph.replay, 20),
                    call_us=host_us(lambda: front(8), 20))
        row = dict(size=size, levels=levels, replay_host=host,
                   equal_to_eager=equal, reads_around_replay=reads,
                   syncs_around_replay=sync.total,
                   ncomp=int(eager.ncomp), last=int(eager.last),
                   eager_ms=cuda_ms(front, 5),
                   replay_ms=cuda_ms(lambda: front(8), 10),
                   replay_device_ms=replay_device,
                   ideal_branch_ms_by_level=ideal,
                   ideal_branch_ms=sum(ideal),
                   ideal_share_of_replay=sum(ideal) / replay_device)
        emit("front_capture", **row)
        if not (equal and reads == 0 and sync.total == 0):
            raise AssertionError(f"the captured {size}x{size} front differs "
                                 "from the eager one or syncs")
        rows[size] = row
    solver.front_graphs.clear()
    return rows


# The method's integer operations a round: a minimum for each edge in
# each hook and the two jumps' gathers, at the 32-bit logic rate.
def label_bound(card, E, rounds):
    """(bound ms, bound_by): E read once, the labels and the round count
    written once; ``rounds`` x (2 nnz + 2 N) integer operations."""
    from otamg_torch.diag.roofline import hbm_rate

    m, n = E.shape
    N = n + m
    t_bytes = (m * n * E.element_size() + 8 * N + 4) / hbm_rate(card)
    t_ops = rounds * (2 * int((E != 0).sum()) + 2 * N) / _WORD_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def permuted_path(k, seed=0):
    """A bipartite path of ``k`` columns and ``k`` rows, column ``t`` -
    row ``t`` - column ``t + 1``, with the column and row indices
    randomly permuted (numpy ``default_rng(seed)``, the columns'
    permutation drawn first); the same as
    ``tests/test_torch_components.py``'s."""
    rng = np.random.default_rng(seed)
    pc, pr = rng.permutation(k), rng.permutation(k)
    E = np.zeros((k, k))
    E[pr, pc] = 1.0
    E[pr[:-1], pc[1:]] = 1.0
    return E


# The random masks' sizes and densities (a few edges a node: many
# components, several rounds); 3,072 keeps its bits in the workspace.
LABEL_RANDOM = ((2048, 0.0015), (3072, 0.001))


def label_checks(card, dev, masks):
    """``label_rounds`` against ``label_rounds_plain`` on the card, bit
    for bit (labels and rounds): on the first Newton masks of the paths
    (``masks``: name -> E), the 500 + 500 permuted path at the 64-round
    cap (3 labels left), the random masks of :data:`LABEL_RANDOM`, an
    empty and a full 500 x 500 mask; each with its layout, rounds,
    labels left, times and bound."""
    from otamg_torch.amg.kernels import (label_layout, label_rounds,
                                         label_rounds_plain)

    gen = torch.Generator(device=dev).manual_seed(17)
    cases = dict(masks)
    cases["path_500"] = torch.as_tensor(permuted_path(500), device=dev)
    for k, d in LABEL_RANDOM:
        cases[f"random_{k}"] = (torch.rand(k, k, generator=gen, device=dev)
                                < d).to(torch.float64)
    cases["empty_500"] = torch.zeros(500, 500, dtype=torch.float64,
                                     device=dev)
    cases["full_500"] = torch.ones(500, 500, dtype=torch.float64, device=dev)
    rows = {}
    for name, E in cases.items():
        k = label_rounds(E)
        p = label_rounds_plain(E != 0)
        torch.cuda.synchronize()
        equal = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        m, n = E.shape
        rounds = int(k[1])
        bound_ms, bound_by = label_bound(card, E, rounds)
        ms = cuda_ms(lambda: label_rounds(E))
        row = dict(shape=name, m=m, n=n, dtype=str(E.dtype).split(".")[-1],
                   layout=label_layout(m, n)[0], rounds=rounds,
                   labels_left=int(torch.unique(k[0]).numel()),
                   edges=int((E != 0).sum()), equal_to_plain=equal,
                   max_abs_err=float((k[0] - p[0]).abs().max()), ms=ms,
                   device_ms=graph_ms(lambda: label_rounds(E)),
                   host_us=host_us(lambda: label_rounds(E)),
                   plain_ms=cuda_ms(lambda: label_rounds_plain(E != 0), 10),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms)
        emit("label_rounds", **row)
        capped = name != "path_500" or (rounds == 64
                                         and row["labels_left"] == 3)
        if not (equal and capped):
            raise AssertionError(f"label_rounds {name} differs from its plain "
                                 "version (or the path missed the cap)")
        rows[name] = row
    return rows


# bip_smooth's tolerance, of the plain result's largest entry: sums in
# another order (the CPU tests see up to 1e-13 (f64) and 1e-7 (f32,
# deflated) of the norm between the two methods).
SMOOTH_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def smooth_bound(card, lv, smoth_it, deflated, e_is_zero):
    """(bound ms, bound_by): what the call reads, once each (E; r, g,
    labels, nsp and the plan's order, n + m each; Axi and xx where it is
    not deflated, e where it is not zero; Exi1, Etxi2 and the plan's
    offsets), and the result written once; 4 smoth_it m n operations at
    the type's peak."""
    from otamg_torch.diag.roofline import hbm_rate

    E = lv.E
    m, n = E.shape
    N = n + m
    item = E.element_size()
    vecs = 2 + 2 * (not deflated) + (not e_is_zero) + 1   # + the result
    nbytes = (m * n * item + N * (vecs * item + 8 + 1 + 4)
              + (m + n) * item + 4 * lv.plan.offsets.numel())
    t_bytes = nbytes / hbm_rate(card)
    t_ops = 4 * smoth_it * m * n / _PEAK[E.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def synthetic_level(m, n, kind, dtype, dev, seed=0):
    """A bipartite level on the card as the setup makes one (components
    in three blocks, ``empty`` or ``full``; ``g = bk1 qp2 + (kdiag +
    a0diag) / tk`` with ``kdiag`` zero on the components of even root
    label, ``Axi = A 1``), for the layouts' edges."""
    from otamg_torch.amg.graph import connected_components_bipartite
    from otamg_torch.amg.hierarchy import BipartiteLevel
    from otamg_torch.sparse.segment import segment_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64
    if kind == "empty":
        E = torch.zeros(m, n, dtype=f64, device=dev)
    elif kind == "full":
        E = 0.5 + torch.rand(m, n, generator=gen, device=dev, dtype=f64)
    else:
        gr = torch.randint(0, 3, (m,), generator=gen, device=dev)
        gc = torch.randint(0, 3, (n,), generator=gen, device=dev)
        keep = (gr[:, None] == gc[None, :]) & (
            torch.rand(m, n, generator=gen, device=dev) < 0.3)
        E = torch.where(keep, 0.1 + torch.rand(m, n, generator=gen,
                                               device=dev, dtype=f64), 0.0)
    N = n + m
    itk = torch.tensor(1 / 0.7, dtype=f64, device=dev)
    labels = connected_components_bipartite(E)
    near = labels[labels] % 2 == 0
    qp2 = 0.5 + 1.5 * torch.rand(N, generator=gen, device=dev, dtype=f64)
    kdiag = torch.where(near, 0.0, 0.1 + torch.rand(N, generator=gen,
                                                    device=dev, dtype=f64))
    g = 1e-3 * qp2 + (kdiag + torch.cat([E.sum(0), E.sum(1)])) * itk
    seg = torch.zeros(N, dtype=f64, device=dev).index_add_(0, labels, kdiag)
    nsp = seg[labels] == 0
    Axi = g - itk * torch.cat([E.sum(0), E.sum(1)])
    xx = torch.zeros(N, dtype=f64, device=dev).index_add_(0, labels, Axi)
    xi = nsp.to(f64)
    T = lambda t: t.to(dtype).contiguous()
    return BipartiteLevel(T(E), T(g), T(itk), T(torch.zeros(n, m,
                                                             device=dev)),
                          labels, nsp, T(Axi), T(xx[labels]), T(E @ xi[:n]),
                          T(E.T @ xi[n:]), segment_plan(labels, N, split=n))


def layout_edges(dtype) -> tuple:
    """The largest square level whose rows of ``E`` fit the blocks'
    shared memory (layout 0) in ``dtype``, and the next size (layout
    1)."""
    from otamg_torch.amg.kernels import bip_smooth_layout

    item = torch.tensor([], dtype=dtype).element_size()
    k = 16
    while bip_smooth_layout(k + 16, k + 16, 2 * k + 32, item)[0] == 0:
        k += 16
    while bip_smooth_layout(k + 1, k + 1, 2 * k + 2, item)[0] == 0:
        k += 1
    return k, k + 1


def captured_replay(call):
    """``call()``'s result from a replay of its capture (``graphs.
    capture``, after a warm-up on the capture's stream)."""
    from otamg_torch import graphs

    out = torch.zeros_like(call())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(call())
    torch.cuda.current_stream().wait_stream(side)
    with graphs.capture(graph):
        out.copy_(call())
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return out


def phase_bip_smooth(card, dev, recs, rec2):
    """``bip_smooth`` (``csrc/bip_smooth.cu``) against ``bip_smooth_plain``
    on the card: on the bipartite levels of the first Newton solves of
    Class-1 500^2 and 1024^2 and Class-2 500^2 (10 sweeps) and of the
    mixed Class-1 500^2 run (fp32, deflated), with the vectors of their
    first pre-smoothing (``e`` zero) and post-smoothing (transposed)
    calls, the other two orders on the 500^2 level, deflated in f64 there
    too; and on synthetic levels at the layouts' edges (the largest
    layout-0 square and the next size, in f64 and f32, and 2,048^2 f64 in
    layout 2), an empty mask (every node its own component) and a full
    one.  Each with its layout, the largest error against the plain
    result's largest entry and its tolerance (:data:`SMOOTH_TOL`), equal
    bits in two calls and between a captured replay and the eager call,
    ``ms``, ``device_ms``, ``host_us``, the bound and its share, the plain
    version's time and that of its ``2 smoth_it`` ``torch.mv`` calls
    alone (``mv_ms``; no one library call computes a sweep)."""
    from otamg_torch.amg.kernels import (bip_smooth, bip_smooth_layout,
                                         bip_smooth_plain)

    t0 = time.perf_counter()
    with Recorder() as mixed:
        run_class1(500, 500, dev, dataclasses.replace(class1_opts("float32"),
                                                      maxit=1))
    paths = {"class1_500": recs[500].smooth, "class1_1024": recs[1024].smooth,
             "class2_500": rec2.smooth,
             "mixed_500": mixed.smooth}
    cases = {}
    for path, calls in paths.items():
        for (transpose, e_is_zero, deflated), call in calls.items():
            name = (f"{path}_{'post' if transpose else 'pre'}"
                    f"{'_deflated' if deflated else ''}")
            cases[name] = (*call[:4], transpose, call[4], deflated,
                           e_is_zero)
    lv, e, r, _, _, nseg, _, _ = cases["class1_500_post"]
    for transpose, e_is_zero in ((False, False), (True, True)):
        cases[f"class1_500_t{int(transpose)}_z{int(e_is_zero)}"] = (
            lv, e, r, 5, transpose, nseg, False, e_is_zero)
    cases["class1_500_deflated_f64"] = (lv, e, r, 5, True, nseg, True, False)
    gen = torch.Generator(device=dev).manual_seed(23)
    synth = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype is torch.float64 else "f32"
        for k in layout_edges(dtype):
            synth.append((f"edge_{k}_{tag}", k, k, "components", dtype))
    synth += [("layout2_2048_f64", 2048, 2048, "components", torch.float64),
              ("empty_500", 500, 500, "empty", torch.float64),
              ("full_500", 500, 500, "full", torch.float64)]
    for name, m, n, kind, dtype in synth:
        lv = synthetic_level(m, n, kind, dtype, dev)
        N = n + m
        e = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
        r = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
        cases[name] = (lv, e.to(dtype), r.to(dtype), 5, False, N,
                       dtype is torch.float32, False)
    rows = {}
    for name, args in cases.items():
        lv, e, r, smoth_it, transpose, nseg, deflated, e_is_zero = args
        m, n = lv.E.shape
        dtype = lv.E.dtype
        call = lambda: bip_smooth(*args)
        got = call()
        again = call()
        want = bip_smooth_plain(*args)
        replayed = captured_replay(call)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        rel = err / scale if scale else err
        item = lv.E.element_size()
        layout = bip_smooth_layout(m, n, nseg, item)[0]
        bound_ms, bound_by = smooth_bound(card, lv, smoth_it, deflated,
                                          e_is_zero)
        ms = cuda_ms(call)
        E = lv.E
        x, y = r[:n].clone(), r[n:].clone()

        def mvs():
            for _ in range(smoth_it):
                torch.mv(E, x)
                torch.mv(E.T, y)

        row = dict(shape=name, m=m, n=n, nseg=nseg,
                   dtype=str(dtype).split(".")[-1], layout=layout,
                   smoth_it=smoth_it, transpose=transpose, deflated=deflated,
                   e_is_zero=e_is_zero, nsp=int(lv.nsp.sum()),
                   components=int(torch.unique(lv.labels).numel()),
                   max_abs_err=err, max_rel_err=rel, tol=SMOOTH_TOL[dtype],
                   finite=bool(torch.isfinite(got).all()),
                   equal_twice=bool(torch.equal(got, again)),
                   replay_equal_eager=bool(torch.equal(replayed, got)),
                   ms=ms, device_ms=graph_ms(call), host_us=host_us(call),
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms,
                   plain_ms=cuda_ms(lambda: bip_smooth_plain(*args), 10),
                   mv_ms=cuda_ms(mvs, 10), library_ms=None)
        emit("bip_smooth", **row)
        if not (row["finite"] and rel <= row["tol"] and row["equal_twice"]
                and row["replay_equal_eager"]):
            raise AssertionError(f"bip_smooth {name} differs from its plain "
                                 "version, is not finite or not "
                                 "deterministic")
        rows[name] = row
    need = {"class1_500_pre", "class1_500_post", "class1_1024_pre",
            "class2_500_pre", "mixed_500_pre_deflated",
            "mixed_500_post_deflated"}
    if not need <= set(rows) or rows["class2_500_pre"]["smoth_it"] != 10 \
            or rows["mixed_500_pre_deflated"]["dtype"] != "float32":
        raise AssertionError(f"bip_smooth: the recorded calls {sorted(rows)}")
    emit("bip_smooth_checks", cases=len(rows),
         layouts=sorted({r["layout"] for r in rows.values()}),
         seconds=time.perf_counter() - t0)
    return rows


# The Class-1 sizes whose first Newton solve feeds the setup checks.
SETUP_SIZES = (500, 1024)


def phase_setup_kernels(card, dev):
    """The front's kernels and its CUDA graph on the first Newton solve
    of Class-1 500^2 and 1024^2 and, for the labels, Class-2 500^2: a
    one-iteration loop-driver solve of each records the inputs
    (:class:`Recorder`), then :func:`mis_checks`, :func:`eigh_checks`,
    :func:`label_checks` and :func:`front_checks`; also returns the
    recordings."""
    caps = setup_sizes_checked()
    recs = {}
    for size in SETUP_SIZES:
        with Recorder() as rec:
            run_class1(size, size, dev, dataclasses.replace(class1_opts(),
                                                            maxit=1))
        recs[size] = rec
    with Recorder() as rec2:
        run_class2(500, 500, dev, dataclasses.replace(class2_opts(), maxit=1))
    coarsest = {size: sorted(rec.eigh) for size, rec in recs.items()}
    if coarsest != {size: [caps[size]] for size in SETUP_SIZES}:
        raise AssertionError(f"coarsest levels {coarsest}, capacity "
                             f"schedule {caps}")
    masks = {f"class1_{size}": rec.mask[0] for size, rec in recs.items()}
    masks["class2_500"] = rec2.mask[0]
    return (mis_checks(card, dev, recs), eigh_checks(card, dev, recs),
            label_checks(card, dev, masks), front_checks(dev, recs), recs,
            rec2)


def same_run(res, base) -> bool:
    """Bit for bit the same trajectory: iterations, failures, SsN steps
    and every objective."""
    return bool(res.iters == base.iters and res.fail_count == base.fail_count
                and np.array_equal(res.ssn_itnum, base.ssn_itnum)
                and np.array_equal(res.fxk, base.fxk))


def phase_setup_graph(dev, loops):
    """The chunked (``chunk=8``) and fused drivers, whose Newton solves
    replay the front's CUDA graph (transform, components, setup) and the
    AMG block's, beside the loop driver's runs of phases 5 and 6
    (``loops``: (class, size) -> (result, seconds, reads, numbers)), which
    run the same front eagerly: Class-1
    500^2 chunked twice (the first captures) and fused, 1024^2 chunked
    and fused, Class-2 500^2 chunked.  Each held bit for bit to its loop
    run (iterations, failures, SsN steps, every objective) and to its
    reference, with one front replay and at least one AMG block replay per
    Newton solve, exactly one front capture and one AMG block capture per
    signature (the runs of one class and size share both), at least one
    replay of the outer step's regions per SsN step, each region
    captured by the first run of its signature only (chunk 8 and the
    fused driver share it), and at most half the loop's host reads per
    outer iteration (Class 2: fewer).  Returns each run's launches and
    its seconds by (class, size, driver)."""
    from otamg_torch.amg.hierarchy import amg_graphs
    from otamg_torch.hybrid.solver import front_graphs
    from otamg_torch.opt.regions import step_graphs

    amg_graphs.clear()
    front_graphs.clear()
    step_graphs.clear()
    launches, walls = {}, {}
    # (class, size) -> [front captures, AMG block captures, the step's
    # region captures by run]
    captures = {}
    runs = ((1, 500, "chunked"), (1, 500, "chunked_warm"), (1, 500, "fused"),
            (1, 1024, "chunked"), (1, 1024, "fused"), (2, 500, "chunked"))
    for cls, size, name in runs:
        solve = blocked_solve(cls, name)
        base, base_s, base_reads, base_nums = loops[(cls, size)]
        if cls == 1:
            res, secs, reads = run_class1(size, size, dev, class1_opts(),
                                          solve)
            ref = held_to_class1_reference(size, res)
        else:
            res, secs, reads = run_class2(size, size, dev, class2_opts(),
                                          solve)
            ref = held_to_reference(size, res)
        nums = dict(LAST)
        launches[f"class{cls}_{size}_{name}"] = nums["launches"]
        walls[(cls, size, name)] = secs
        row = dict(same_as_loop=same_run(res, base), loop=base_nums,
                   bodies_held=bodies_held(f"class{cls}_{size}_{name}", cls,
                                           nums, base_nums, f64=True),
                   **nums, **ref)
        emit(f"setup_graph_class{cls}_{size}", driver=name, **row)
        few_reads = (reads <= base_reads / 2 if cls == 1
                     else reads < base_reads)
        got = captures.setdefault((cls, size), [0, 0, []])
        got[0] += nums["front_captures"]
        got[1] += nums["amg_captures"]
        got[2].append(nums["step_captures"])
        if not (row["same_as_loop"] and few_reads and row["bodies_held"]
                and nums["front_replays_per_newton_solve"] == 1.0
                and nums["amg_replays_per_newton_solve"] >= 1.0
                and nums["step_replays_per_ssn_step"] >= 1.0
                and nums["setups"] == nums["newton_solves"]
                and nums["launches"]["plain_label_rounds_on_card"] == 0):
            raise AssertionError(f"Class-{cls} {size}x{size} {name} driver "
                                 "differs from the loop driver, runs other "
                                 "bodies than the loop's or does not "
                                 "replay one front and the AMG block a "
                                 "Newton solve and the step's regions an "
                                 "SsN step")
    emit("setup_graph_caches", front_captures=front_graphs.captures,
         front_replays=front_graphs.replays, amg_captures=amg_graphs.captures,
         amg_replays=amg_graphs.replays, step_captures=step_graphs.captures,
         step_replays=step_graphs.replays,
         step_regions=sorted({name for _, name in step_graphs.blocks}),
         captures_by_run={f"class{c}_{n}": v for (c, n), v in captures.items()})
    if any(v[:2] != [1, 1] or not v[2][0] or any(v[2][1:])
           for v in captures.values()):
        raise AssertionError(f"not one front, one AMG block and one capture "
                             f"of each step region per signature: {captures}")
    return launches, walls


# The bodies of ``when`` of every blocked run beside its loop run's, for
# the conditional phase: path -> row.
BODIES = {}


def bodies_held(path, cls, nums, base, f64) -> bool:
    """A blocked run's bodies of ``when`` (``nums["bodies"]``) against
    its loop run's (``base``): the same four counts, a repair built for
    each one the setups' stats count, and no cycle past an exit (f64
    Class 1: an AMG cycle an inner iteration; mixed: an AMG cycle a
    refinement cycle, and those the refinement's count).  Kept in
    :data:`BODIES`."""
    got, loop = nums["bodies"], base["bodies"]
    checks = [got == loop, got["repairs"] == nums["repairs"],
              loop["repairs"] == base["repairs"]]
    if f64 and cls == 1:
        checks += [got["amg_cycles"] == nums["inner_iters"],
                   loop["amg_cycles"] == base["inner_iters"]]
    if not f64:
        checks += [got["amg_cycles"] == got["refine_cycles"]
                   == nums["refine_counts"][3]]
    if nums["front_captures"]:
        checks.append(nums["launches"]["set_if"] > 0)
    BODIES[path] = dict(bodies=got, loop_bodies=loop,
                        repairs_fired=nums["repairs"],
                        inner_iters=nums["inner_iters"],
                        newton_solves=nums["newton_solves"],
                        set_if_launches=nums["launches"]["set_if"],
                        held=all(checks))
    return all(checks)


def blocked_solve(cls, name):
    """``solve(prob, opts)`` of the Class-``cls`` blocked driver ``name``
    (``chunked`` and ``chunked_warm``: chunk 8; ``fused``)."""
    from otamg_torch import opt

    if name == "fused":
        return getattr(opt, f"solve_class{cls}_fused")
    chunked = getattr(opt, f"solve_class{cls}_chunked")
    return lambda p, o: chunked(p, o, chunk=8)


def refine_numbers() -> tuple:
    """``(solves, rounds, reverted, cycles)`` of ``refine_counts``."""
    from otamg_torch.hybrid.solver import refine_counts as c

    return c.solves, c.rounds, c.reverted, c.cycles


def run_mixed(cls, size, dev, solve=None):
    """(result, seconds, numbers) of a mixed run (``run_class1`` or
    ``run_class2`` with ``solve_dtype="float32"``), the refinement's
    counts among its numbers."""
    from otamg_torch.hybrid.solver import refine_counts

    refine_counts.reset()
    if cls == 1:
        res, secs, _ = run_class1(size, size, dev, class1_opts("float32"),
                                  solve)
    else:
        res, secs, _ = run_class2(size, size, dev, class2_opts("float32"),
                                  solve)
    nums = dict(LAST, refine_counts=refine_numbers())
    return res, secs, nums


def phase_mixed(dev, f64_seconds, f64_blocked):
    """``bench.py``'s configuration on an accelerator: the Newton solves
    with ``solve_dtype="float32"`` (fp32 hierarchy, exact kernel
    deflation, f64 refinement), each run held to the JAX package's CPU
    run of the same problem and options (``MIXED_REF``), beside the f64
    run's seconds of the same driver from this call (``f64_seconds[(class,
    size, run)]`` of the loop, ``f64_blocked[(class, size, driver)]`` of
    the blocked drivers).  The loop driver's runs first (Class-1 500^2,
    1024^2, Class-2 500^2), then the blocked drivers' (Class-1 500^2
    chunked twice and fused, 1024^2 chunked and fused, Class-2 500^2
    chunked), whose refinement rounds run as the CUDA graphs of
    ``Refinement``: each held to its loop run bit for bit (iterations,
    failures, SsN steps, every objective and the refinement's solves,
    rounds, reverted rounds and cycles), with no correction solve run op
    by op, the refinement's reads equal to its block replays (at most
    the blocks plus one a Newton solve), one front replay a Newton solve
    and each refinement region captured once per signature (chunk 8 and
    the fused driver share them).  Returns the chunked Class-1 500^2
    mixed run (result and refinement counts) and each blocked run's
    launches."""
    from otamg_torch.hybrid.solver import refine_graphs

    tf32 = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())
    emit("mixed_tf32", **tf32)
    if tf32["allow_tf32"] or tf32["float32_matmul_precision"] != "highest":
        raise AssertionError(f"TF32 matmuls are on ({tf32}): the fp32 "
                             "hierarchy needs true fp32")
    loops = {}
    # (class, size, the f64 run of this call it is put beside)
    for cls, size, f64_run in ((1, 500, "warm"), (1, 1024, "once"),
                               (2, 500, "once")):
        res, secs, nums = run_mixed(cls, size, dev)
        loops[(cls, size)] = (res, nums)
        solves, rounds, reverted, cycles = nums["refine_counts"]
        emit("mixed", **{"class": cls}, size=size, driver="loop",
             seconds=secs, f64_seconds=f64_seconds[(cls, size, f64_run)],
             host_reads_per_outer_iter=nums["host_reads_per_outer_iter"],
             newton_solves=solves, refine_rounds=rounds,
             reverted_rounds=reverted,
             rounds_per_solve=rounds / max(solves, 1),
             mean_correction_cycles=cycles / max(rounds, 1),
             refine_reads_per_he_solve=nums["refine_reads"]
             / max(solves, 1),
             eager_correction_solves=nums["eager_correction_solves"],
             **held_to_mixed_reference(cls, size, res))
    refine_graphs.clear()
    launches, captured = {}, set()
    for cls, size, name in ((1, 500, "chunked"), (1, 500, "chunked_warm"),
                            (1, 500, "fused"), (1, 1024, "chunked"),
                            (1, 1024, "fused"), (2, 500, "chunked")):
        base, base_nums = loops[(cls, size)]
        res, secs, nums = run_mixed(cls, size, dev, blocked_solve(cls, name))
        if name == "chunked" and (cls, size) == (1, 500):
            chunked500 = (res, nums["refine_counts"])
        launches[f"mixed_class{cls}_{size}_{name}"] = nums["launches"]
        solves = max(nums["refine_counts"][0], 1)
        blocks = nums["refine_replays"] - nums["refine_counts"][0]
        row = dict(
            same_as_loop=same_run(res, base),
            same_refine_counts=nums["refine_counts"]
            == base_nums["refine_counts"],
            bodies_held=bodies_held(f"mixed_class{cls}_{size}_{name}", cls,
                                    nums, base_nums, f64=False),
            loop_seconds=base_nums["seconds"],
            f64_seconds=f64_blocked[(cls, size, name)],
            refine_reads_per_he_solve=nums["refine_reads"] / solves,
            refine_read_bound_per_he_solve=(blocks + solves) / solves,
            loop_refine_reads_per_he_solve=base_nums["refine_reads"]
            / solves,
            refine_blocks_per_he_solve=blocks / solves, **nums,
            **held_to_mixed_reference(cls, size, res))
        emit(f"mixed_class{cls}_{size}", driver=name, **row)
        sig = (cls, size)
        want_captures = 0 if sig in captured else 2
        captured.add(sig)
        if not (row["same_as_loop"] and row["same_refine_counts"]
                and row["bodies_held"]
                and nums["eager_correction_solves"] == 0
                and nums["refine_reads"] == blocks
                and nums["refine_captures"] == want_captures
                and nums["front_replays_per_newton_solve"] == 1.0
                and nums["launches"]["plain_label_rounds_on_card"] == 0):
            raise AssertionError(
                f"mixed Class-{cls} {size}x{size} {name} differs from its "
                "loop run or runs other bodies, runs a correction solve op "
                "by op, reads besides "
                "its refinement blocks or does not capture each refinement "
                "region once per signature")
    emit("mixed_refine_caches", refine_captures=refine_graphs.captures,
         refine_replays=refine_graphs.replays,
         regions=sorted({name for _, name in refine_graphs.blocks}))
    return chunked500, launches


# The JAX package's solves on the CPU of random_class1/2(PRNGKey(0), N, N)
# with class1_opts("float32") / class2_opts("float32") and f64 plans
# (cpu_reference.py --solve-dtype float32 [--class2] --size N).
# Class-2 500x500 does not reach KKT 1e-6 in 100 iterations, as in f64.
MIXED_REF = {
    (1, 500): dict(converged=True, iters=55, fail_count=0,
                   fxk=1.0810500251146964),
    (1, 1024): dict(converged=True, iters=51, fail_count=0,
                    fxk=1.1383636551928087),
    (2, 500): dict(converged=False, iters=100, fail_count=0,
                   fxk=0.36282848278939284),
}


def held_to_mixed_reference(cls, size, res):
    """The numbers of a mixed-precision solve beside the JAX CPU run's;
    raises unless ``converged`` is equal, the outer iterations equal (or,
    converged, within ``ITERS_SLACK``), the objective agrees to 1e-8 and
    the plan's (Class 2: and the slacks') KKT residuals are at target."""
    ref = MIXED_REF[(cls, size)]
    if cls == 1:
        rel = np.asarray([res.kkt_x[-1] / (1 + res.kkt_x[0]),
                          res.kkt_l[-1] / (1 + res.kkt_l[0])])
        at_target = rel[0] <= 1e-6
    else:
        rel = res.kkt[-1] / (1 + res.kkt[0])
        at_target = rel[:3].max() <= 1e-6
    row = dict(converged=res.converged, iters=res.iters,
               fail_count=res.fail_count, fxk=float(res.fxk[-1]),
               inner_total=res.inner_total, rel_kkt=rel.tolist(),
               fxk_rel_vs_cpu=abs(res.fxk[-1] - ref["fxk"]) / ref["fxk"],
               cpu=ref)
    slack = ITERS_SLACK if ref["converged"] else 0
    if not (res.converged == ref["converged"]
            and abs(res.iters - ref["iters"]) <= slack
            and row["fxk_rel_vs_cpu"] <= 1e-8 and at_target):
        emit(f"mixed_class{cls}_{size}_mismatch", **row,
             ssn_itnum=[int(v) for v in res.ssn_itnum])
        raise AssertionError(f"mixed Class-{cls} {size}x{size} differs "
                             "from the JAX CPU run")
    return row


def laplacian_1d_csr(N: int, shift: float, dtype, dev):
    """The 1-D Laplacian + ``shift`` I of ``N`` rows as an ELL CSR of cap
    3, laid out as scipy's CSR rows (columns ascending, padding (column
    0, value 0) last): ``tests/test_amg.py``'s sparse-setup operator."""
    from otamg_torch.sparse import CSR

    i = torch.arange(N, device=dev)
    nb = torch.stack([i - 1, i, i + 1], 1)
    ok = (nb >= 0) & (nb < N)
    val = torch.tensor([-1.0, 2.0 + shift, -1.0], dtype=dtype,
                       device=dev).expand(N, 3)
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    ok = torch.gather(ok, 1, order)
    cols = torch.where(ok, torch.gather(nb, 1, order), 0).to(torch.int32)
    vals = torch.where(ok, torch.gather(val, 1, order), 0.0)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(ok.sum(1), 0).to(torch.int32)])
    return CSR((N, N), indptr, cols.contiguous(), vals.contiguous())


def sparse_setup_opts():
    """The sparse-setup solve's options: F-cycle (W's tape grows as 2^L
    over the ~17 levels), 60 cycles, relative residual 1e-10."""
    from otamg_torch.config import AMGOptions, Cycle

    return AMGOptions(cycle=Cycle.F, maxit=60, retol=1e-10,
                      coarse_target=64)


def sparse_setup_solve(A, b):
    """(levels, AMG result, setup s, solve s) of the sparse-setup path."""
    from otamg_torch.amg import hierarchy
    from otamg_torch.random import PRNGKey

    opts = sparse_setup_opts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv0, rest = hierarchy.setup_hierarchy_sparse(A, opts, PRNGKey(0), agg=2,
                                                 dense_crossover=1024)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = hierarchy.amg_solve(lv0, rest, b, torch.zeros_like(b), opts)
    torch.cuda.synchronize()
    return (lv0, *rest), res, t1 - t0, time.perf_counter() - t1


def phase_sparse_setup(card, dev):
    """The sparse-setup hierarchy at ``SPARSE_SETUP_N`` rows: every
    matvec of its CSR and aggregation levels is the ELL kernel.  Returns
    the path's ``ell_spmv`` launches, the kernel's timed rows and the
    path's ``segment_sum`` launches."""
    from otamg_torch.amg import hierarchy
    from otamg_torch.sparse import ell_spmv, ell_spmv_plain

    N = SPARSE_SETUP_N
    A = laplacian_1d_csr(N, 0.01, torch.float64, dev)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(N),
                        device=dev)
    by_rows = collections.Counter()

    def counted(cols, vals, x):
        by_rows[cols.shape[0]] += 1
        return ell_spmv(cols, vals, x)

    hierarchy.ell_spmv = counted
    ell_spmv.launches = 0
    zero_counts()
    try:
        levels, res, setup_s, solve_s = sparse_setup_solve(A, b)
        launches = ell_spmv.launches
        seg_launches = counts()
    finally:
        hierarchy.ell_spmv = ell_spmv
    if launches == 0 or launches != sum(by_rows.values()):
        raise AssertionError(f"sparse-setup solve: {launches} ell_spmv "
                             f"launches, {sum(by_rows.values())} calls")
    true_rel = float(torch.linalg.vector_norm(A.matvec(res.x) - b)
                     / torch.linalg.vector_norm(b))
    # The same setup and solve with every sparse matvec the plain SpMV.
    hierarchy.ell_spmv = ell_spmv_plain
    try:
        _, ref, plain_setup_s, plain_solve_s = sparse_setup_solve(A, b)
    finally:
        hierarchy.ell_spmv = ell_spmv
    dx = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    sizes = [hierarchy._lvl_size(lv) for lv in levels]
    caps = [lv.ell_cols.shape[1] for lv in levels if hasattr(lv, "ell_cols")]
    rel = float(res.rel_res)
    big = sum(v for k, v in by_rows.items() if k > 100_000)
    row = dict(N=N, levels=sizes, sparse_caps=caps,
               kinds=[type(lv).__name__ for lv in levels],
               setup_seconds=setup_s, solve_seconds=solve_s,
               iters=int(res.iters), rel_res=rel, true_rel_res=true_rel,
               plain_iters=int(ref.iters), x_rel_vs_plain=dx,
               plain_setup_seconds=plain_setup_s,
               plain_solve_seconds=plain_solve_s,
               ell_spmv_launches=launches,
               launches_by_rows={str(k): v for k, v in sorted(by_rows.items())},
               launches_per_cycle=launches / max(int(res.iters), 1),
               share_of_launches_above_100k_rows=big / launches,
               segment_sum_launches=seg_launches,
               segment_sum_launches_per_cycle=seg_launches
               / max(int(res.iters), 1),
               cpu=SPARSE_SETUP_REF)
    emit("sparse_setup", **row)
    if dx > 1e-8 or ref.iters != res.iters:
        raise AssertionError(f"sparse-setup kernel and plain solves differ: "
                             f"{dx:.2e}, {res.iters} / {ref.iters} cycles")
    if not (abs(res.iters - SPARSE_SETUP_REF["iters"]) <= 1
            and rel <= 2 * SPARSE_SETUP_REF["rel_res"]
            and sizes == SPARSE_SETUP_REF["levels"]):
        raise AssertionError("sparse-setup solve differs from the JAX CPU "
                             "run (SPARSE_SETUP_REF)")
    # The kernel alone at the fine level's and the first aggregation
    # level's shapes (these launches are not the path's).
    gen = torch.Generator(device=dev).manual_seed(1)
    timed = {}
    for name, lv in (("sparse_setup_fine", levels[0]),
                     ("sparse_setup_agg1", levels[1])):
        x = torch.randn(lv.ell_cols.shape[0], generator=gen, device=dev,
                        dtype=torch.float64)
        timed[name] = check_kernel(name, card, lv.ell_cols, lv.ell_vals, x,
                                   1e-12)
    return launches, timed, seg_launches, res


# The JAX package's run of the same problem and options on the CPU
# (cpu_reference.py --sparse-setup 1048576): level sizes, cycles and the
# relative residual; the card must reach the same levels, cycles within
# 1, and a residual no worse than twice the JAX run's.
SPARSE_SETUP_N = 1_048_576
SPARSE_SETUP_REF = dict(
    levels=[1048576, 524288, 262144, 131072, 65536, 32768, 16384, 8192,
            4096, 2048, 1024, 640, 400, 250, 157, 99, 62],
    iters=28, rel_res=4.6101198948481603e-11)


def run_cli(argv):
    """(exit code, report, seconds) of ``otamg_torch.cli.main(argv)`` in
    this process; the report is the last line it prints."""
    from otamg_torch.cli import main as cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), secs


def held_to_cli_reference(name, rep, slack):
    """Raises unless ``rep`` has the JAX CLI report's ``converged`` and
    ``fail_count``, its iterations (within ``slack``) and its objective
    to 1e-8."""
    ref = CLI_REF[name]
    rel = abs(rep["objective"] - ref["objective"]) / abs(ref["objective"])
    if not (rep["converged"] == ref["converged"]
            and abs(rep["iters"] - ref["iters"]) <= slack
            and rep["fail_count"] == ref["fail_count"] and rel <= 1e-8):
        raise AssertionError(f"CLI {name} report {rep} differs from the JAX "
                             f"CLI's {ref}")
    return rel


def phase_cli():
    """The CLI in this process: uninterrupted, stopped with
    ``--checkpoint`` and resumed, for both classes; a profiled run; the
    ``info`` subcommand as a subprocess."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, slack in (
                ("class1", ["class1", "--m", "256", "--n", "256", "--inner",
                            "amg", "--cycle", "f"], 0),
                ("class2", ["class2", "--m", "128", "--n", "128", "--inner",
                            "amg", "--cycle", "f"], ITERS_SLACK)):
            ck = os.path.join(tmp, name)
            rc, full, secs = run_cli(argv)
            rc_p, part, secs_p = run_cli(argv + ["--maxit", "20",
                                                 "--checkpoint", ck])
            steps = sorted(os.listdir(ck))
            # The loop driver's checkpoint, resumed by the chunked one.
            rc_r, resumed, secs_r = run_cli(argv + ["--checkpoint", ck,
                                                    "--resume", "--driver",
                                                    "chunked"])
            row = dict(argv=argv, rc=[rc, rc_p, rc_r], full=full,
                       stopped=part, resumed=resumed, checkpoint_files=steps,
                       seconds=[secs, secs_p, secs_r], cpu=CLI_REF[name])
            emit(f"cli_{name}", **row)
            if not (rc == rc_r == 0 and rc_p == 1
                    and "step_20.npz" in steps):
                raise AssertionError(f"CLI {name}: exit codes {row['rc']}, "
                                     f"checkpoint files {steps}")
            row["objective_rel_vs_cpu"] = [
                held_to_cli_reference(name, r, slack)
                for r in (full, resumed)]
            if name == "class1" and not (
                    (resumed["converged"], resumed["iters"])
                    == (full["converged"], full["iters"])
                    and abs(resumed["objective"] - full["objective"])
                    <= 1e-8 * abs(full["objective"])):
                raise AssertionError("resumed Class-1 CLI run differs from "
                                     "the uninterrupted one")
        tdir = os.path.join(tmp, "trace")
        # Two outer iterations keep the trace small (a whole 64x64 solve
        # writes ~200 MB).
        rc, rep, secs = run_cli(["class1", "--m", "64", "--n", "64",
                                 "--inner", "amg", "--cycle", "f",
                                 "--maxit", "2", "--profile", tdir])
        traces = glob.glob(os.path.join(tdir, "trace_*.json"))
        if rc != 1 or rep["iters"] != 2 or len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}, rc {rc}")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        emit("cli_profile", rc=rc, seconds=secs, trace_events=len(events),
             kernel_events=kernels,
             trace_bytes=os.path.getsize(traces[0]))
    info = subprocess.run([sys.executable, "-m", "otamg_torch.cli", "info"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300,
                          check=False)
    rep = json.loads(info.stdout) if info.returncode == 0 else None
    emit("cli_info", rc=info.returncode, info=rep)
    if not (rep and rep["backend"] == "cuda" and rep["kernels_built"]):
        raise AssertionError(f"cli info: {info.stdout} {info.stderr}")


# The JAX package's CLI on the CPU (cpu_reference.py --cli, which runs
# `python -m otamg.cli class1 --m 256 --n 256 --inner amg --cycle f` and
# `class2 --m 128 --n 128 --inner amg --cycle f`).
CLI_REF = {
    "class1": dict(converged=True, iters=52, fail_count=0,
                   objective=1.151894055643113),
    "class2": dict(converged=True, iters=47, fail_count=0,
                   objective=0.1929885433797761),
}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def counted_launches(fn):
    """``(fn(), ell_spmv launches, segment_sum launches)``: both counts
    set to 0 just before ``fn`` and read just after (the setup kernels'
    in ``counted_launches.setup``).  The collectives ``fn`` ran are in ``counted_launches.collectives`` (all of them),
    ``.eager`` (issued one by one) and ``.replayed`` (held in the AMG
    block's CUDA graphs, counted at each replay)."""
    from otamg_torch.dist.api import collectives
    from otamg_torch.sparse import ell_spmv

    ell_spmv.launches = 0
    zero_counts()
    collectives.reset()
    out = fn()
    torch.cuda.synchronize()
    counted_launches.eager = collectives.eager
    counted_launches.replayed = collectives.replayed
    counted_launches.collectives = collectives.total
    counted_launches.setup = setup_counts()
    return out, ell_spmv.launches, counts()


def dist_spmv_checks(card, dev, mesh):
    """(a): both row-partitioned SpMVs on one rank against the kernel on
    the same rows, bit for bit, and their times."""
    from otamg_torch.dist import spmv_allgather, spmv_halo
    from otamg_torch.sparse import ell_spmv

    N = SPARSE_SETUP_N
    A = laplacian_1d_csr(N, 0.01, torch.float64, dev)
    cols, vals = A.ell_cols, A.ell_vals
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev, dtype=torch.float64)
    calls = {"spmv_allgather": lambda: spmv_allgather(mesh, cols, vals, x),
             "spmv_halo": lambda: spmv_halo(mesh, cols, vals, x, 1)}
    want = ell_spmv(cols, vals, x)
    bound_ms, bound_by, nbytes = spmv_bound(card, cols, vals, x)
    row = dict(N=N, cap=3, dtype="float64", bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes,
               ell_spmv_ms=cuda_ms(lambda: ell_spmv(cols, vals, x)))
    launches = 0
    for name, fn in calls.items():
        y, n, _ = counted_launches(fn)
        launches += n
        row[name] = dict(equal_to_ell_spmv=torch.equal(y, want),
                         max_abs_err=float((y - want).abs().max()),
                         launches=n, ms=cuda_ms(fn), host_us=host_us(fn))
        if not (row[name]["equal_to_ell_spmv"] and n >= 1):
            raise AssertionError(f"{name} on one rank differs from ell_spmv "
                                 f"or launched no kernel ({n})")
    emit("dist_spmv", **row)
    return launches


def dist_collective_times(dev, mesh):
    """The time of one collective on the group: a sum and a gather of
    the vector sizes the solves use (events around 100 calls)."""
    from otamg_torch.dist.api import all_gather_rows, pmin, psum

    row = {}
    for n in (1, 500, 2048):
        v = torch.ones(n, device=dev, dtype=torch.float64)
        row[str(n)] = dict(psum_ms=cuda_ms(lambda: psum(v, mesh)),
                           psum_host_us=host_us(lambda: psum(v, mesh)),
                           gather_ms=cuda_ms(lambda: all_gather_rows(v, mesh)),
                           pmin_ms=cuda_ms(lambda: pmin(v, mesh)))
    emit("dist_collectives", **row)


def dist_assembly_checks(dev, mesh):
    """(b): the sharded assembly on one rank at 500x500 against the
    unsharded functions, bit for bit."""
    from otamg_torch.dist import (asat_diags_sharded, galerkin_sharded,
                                  transform_sharded)
    from otamg_torch.hybrid.solver import _transform
    from otamg_torch.ot import operators as op

    g = torch.Generator(device=dev).manual_seed(11)
    m = n = 500

    def rnd(*shape):
        return torch.rand(*shape, generator=g, device=dev,
                          dtype=torch.float64)

    p, q = 0.5 + rnd(m), 0.5 + rnd(n)
    S = (rnd(m, n) < 0.3).to(torch.float64)
    tvec = (rnd(n + m) < 0.5).to(torch.float64)
    A = rnd(m, m)
    A = A + A.T
    P = rnd(m, 128)
    checks = {
        "asat_diags_sharded": (asat_diags_sharded(mesh, S, p, q),
                               op.asat_diags(S, p, q)),
        "transform_sharded": (transform_sharded(mesh, S, tvec, 1e-3, 0.8, p,
                                                q),
                              _transform(S, tvec, 1e-3, 0.8,
                                         torch.zeros_like(tvec), p, q)[:3]),
        "galerkin_sharded": ((galerkin_sharded(mesh, A, P),),
                             (P.T @ (A @ P),))}
    row = {name: all(torch.equal(a, b) for a, b in zip(*pair))
           for name, pair in checks.items()}
    emit("dist_assembly", m=m, n=n, **row)
    if not all(row.values()):
        raise AssertionError(f"sharded assembly differs on one rank: {row}")


def dist_halo_checks(dev, mesh, base, sparse_res):
    """(c): the halo-exchange fine level on one rank beside phase 4's
    grid solve (``base``) and phase 9's sparse-setup solve."""
    from otamg_torch.amg import hierarchy
    from otamg_torch.config import AMGOptions
    from otamg_torch.random import PRNGKey

    nx = 128
    A = grid_csr(nx, 0.01, torch.float64, dev)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(nx * nx),
                        device=dev)
    opts = AMGOptions(maxit=SPARSE_MAXIT)
    t0 = time.perf_counter()
    res, n_spmv, n_seg = counted_launches(
        lambda: hierarchy.amg_solve_matrix(A, b, opts, dist=(mesh, nx)))
    dx = float((res.x - base.x).abs().max() / base.x.abs().max())
    row = dict(grid=dict(N=nx * nx, halo=nx, iters=int(res.iters),
                         unsharded_iters=int(base.iters), x_rel=dx,
                         seconds=time.perf_counter() - t0,
                         ell_spmv_launches=n_spmv,
                         segment_sum_launches=n_seg,
                         collectives=counted_launches.collectives))
    if not (int(res.iters) == int(base.iters) and dx <= 1e-12 and n_spmv):
        raise AssertionError(f"halo grid solve differs: {row}")
    N = SPARSE_SETUP_N
    A = laplacian_1d_csr(N, 0.01, torch.float64, dev)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(N),
                        device=dev)
    sopts = sparse_setup_opts()

    def sparse():
        t0 = time.perf_counter()
        lv0, rest = hierarchy.setup_hierarchy_sparse(
            A, sopts, PRNGKey(0), agg=2, dense_crossover=1024,
            dist=(mesh, 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r0, r1 = mesh.rows(N)
        res = hierarchy.amg_solve(lv0, rest, b[r0:r1],
                                  torch.zeros_like(b[r0:r1]), sopts)
        torch.cuda.synchronize()
        return (lv0, *rest), res, t1 - t0, time.perf_counter() - t1

    (levels, res, setup_s, solve_s), n_spmv2, n_seg2 = counted_launches(
        sparse)
    sizes = [hierarchy._lvl_size(lv) for lv in levels]
    dx = float((res.x - sparse_res.x).abs().max()
               / sparse_res.x.abs().max())
    row["sparse_setup"] = dict(
        N=N, halo=1, head=type(levels[0]).__name__, levels=sizes,
        iters=int(res.iters), unsharded_iters=int(sparse_res.iters),
        rel_res=float(res.rel_res), x_rel=dx, setup_seconds=setup_s,
        solve_seconds=solve_s, ell_spmv_launches=n_spmv2,
        segment_sum_launches=n_seg2,
        collectives=counted_launches.collectives)
    emit("dist_halo", **row)
    if not (sizes == SPARSE_SETUP_REF["levels"]
            and int(res.iters) == int(sparse_res.iters) and dx <= 1e-12
            and levels[0].__class__.__name__ == "HaloCSRLevel" and n_spmv2):
        raise AssertionError(f"halo sparse-setup solve differs: {row}")
    return {"dist_halo_grid": n_spmv, "dist_sparse_setup": n_spmv2}, {
        "dist_halo_grid": n_seg, "dist_sparse_setup": n_seg2}


def dist_class_checks(dev, mesh, runs1, warm1):
    """(d) and (e): the sharded loop solves on one rank; Class 1 at
    500x500 beside phase 5's warm run (``warm1``), and with
    ``explicit_dist`` at 256x256 (it turns ``fuse_deep`` off, which
    doubles a solve's time) beside phase 5's run of that size."""
    from otamg_torch.dist import shard_class2
    from otamg_torch.opt import solve_class2

    seg, loops, setupk = {}, {}, {}
    opts = class1_opts()
    for size, explicit, label in ((500, False, "warm"), (256, True, "once")):
        o = dataclasses.replace(opts, explicit_dist=explicit)
        (res, secs, reads), _, n_seg = counted_launches(
            lambda: run_class1(size, size, dev, o,
                               lambda p, oo: solve_class1_sharded(p, oo,
                                                                  mesh)))
        seg[f"dist_class1{'_explicit' if explicit else ''}"] = n_seg
        setupk[f"dist_class1{'_explicit' if explicit else ''}"] = \
            counted_launches.setup
        extra = {}
        if not explicit:
            loops[1] = (res, secs, reads, counted_launches.collectives)
            # Reported, not held: at one rank the trajectory is phase 5's.
            extra["same_trajectory_as_unsharded"] = bool(
                np.array_equal(res.fxk, warm1[0].fxk)
                and np.array_equal(res.ssn_itnum, warm1[0].ssn_itnum))
        emit(f"dist_class1_{size}", explicit_dist=explicit, seconds=secs,
             unsharded_seconds=runs1[(size, label)],
             host_reads_per_outer_iter=reads, segment_sum_launches=n_seg,
             collectives=counted_launches.collectives,
             **held_to_class1_reference(size, res), **extra)
        if not n_seg:
            raise AssertionError("the sharded Class-1 solve launched no "
                                 "segment_sum kernel")
    # 15 outer iterations (of 54 to convergence) keep the phase short: a
    # collective costs 0.1-0.4 ms of host time at one rank, and an outer
    # iteration here makes thousands.  tests/test_torch_dist.py holds
    # sharded Class-2 solves at 2 and 4 ranks on the CPU.
    o2 = dataclasses.replace(class2_opts(), maxit=15)
    base, base_s, _ = run_class2(256, 256, dev, o2)
    (res, secs, reads), _, n_seg = counted_launches(
        lambda: run_class2(256, 256, dev, o2, lambda p, oo: solve_class2(
            shard_class2(p, mesh), oo)))
    seg["dist_class2"] = n_seg
    setupk["dist_class2"] = counted_launches.setup
    loops[2] = (res, secs, reads, counted_launches.collectives)
    rel = abs(res.fxk[-1] - base.fxk[-1]) / abs(base.fxk[-1])
    row = dict(converged=res.converged, iters=res.iters,
               fail_count=res.fail_count, fxk=float(res.fxk[-1]),
               unsharded=dict(converged=base.converged, iters=base.iters,
                              fail_count=base.fail_count,
                              fxk=float(base.fxk[-1]), seconds=base_s),
               same_ssn_itnum=bool(np.array_equal(res.ssn_itnum,
                                                  base.ssn_itnum)),
               fxk_rel_vs_unsharded=rel, seconds=secs,
               host_reads_per_outer_iter=reads, segment_sum_launches=n_seg,
               collectives=counted_launches.collectives)
    emit("dist_class2_256", **row)
    if not ((res.converged, res.iters, res.fail_count)
            == (base.converged, base.iters, base.fail_count)
            and row["same_ssn_itnum"] and rel <= 1e-10 and n_seg):
        raise AssertionError("the sharded Class-2 256x256 solve differs "
                             "from the unsharded one")
    return seg, loops, setupk


def dist_blocked_checks(dev, mesh, loops):
    """(h): the chunked (``chunk=8``) and fused drivers on the sharded
    problems of (d) and (e), at one rank: Class-1 500x500 chunked and
    fused, each held to ``CLASS1_REF`` and to the sharded loop run of
    (d) bit for bit (objectives, SsN steps, failures), and Class-2
    256x256 chunked (15 outer iterations) held to (e)'s sharded loop run
    bit for bit.  Each row: seconds, host reads per outer iteration,
    eager and replayed collectives, graph captures and replays (the AMG
    block's, the setup's and the outer step's regions'), and
    ``segment_sum`` launches.  Fails unless a captured AMG block holds a
    collective and is replayed, unless each Newton solve replays one
    captured front, whose graph holds the transform's collectives and
    the one gather of ``E`` (for the labels and the setup), and unless
    each SsN step replays the step's regions, whose graphs hold the
    step's collectives."""
    from otamg_torch.amg.hierarchy import amg_graphs
    from otamg_torch.dist import shard_class2
    from otamg_torch.hybrid.solver import front_graphs
    from otamg_torch.opt import (solve_class1_chunked, solve_class1_fused,
                                 solve_class2_chunked)
    from otamg_torch.opt.regions import step_graphs

    def class1(solve):
        return lambda: run_class1(500, 500, dev, class1_opts(),
                                  lambda p, o: solve_class1_sharded(
                                      p, o, mesh, solve))

    o2 = dataclasses.replace(class2_opts(), maxit=15)
    chunked = lambda solve: lambda p, o: solve(p, o, chunk=8)
    runs = ((1, "chunked", class1(chunked(solve_class1_chunked))),
            (1, "fused", class1(solve_class1_fused)),
            (2, "chunked", lambda: run_class2(
                256, 256, dev, o2, lambda p, o: solve_class2_chunked(
                    shard_class2(p, mesh), o, chunk=8))))
    amg_graphs.clear()
    front_graphs.clear()
    step_graphs.clear()
    spmv, seg, setupk = {}, {}, {}
    for cls, name, run in runs:
        base, base_s, base_reads, base_coll = loops[cls]
        captures0, replays0 = amg_graphs.captures, amg_graphs.replays
        (res, secs, reads), n_spmv, n_seg = counted_launches(run)
        spmv[f"dist_class{cls}_{name}"] = n_spmv
        seg[f"dist_class{cls}_{name}"] = n_seg
        setupk[f"dist_class{cls}_{name}"] = counted_launches.setup
        newton = max(int(res.ssn_itnum.sum()), 1)
        row = dict(driver=name, seconds=secs, loop_seconds=base_s,
                   host_reads_per_outer_iter=reads, loop_reads=base_reads,
                   eager_collectives=counted_launches.eager,
                   replayed_collectives=counted_launches.replayed,
                   loop_collectives=base_coll,
                   captures=amg_graphs.captures - captures0,
                   replays=amg_graphs.replays - replays0,
                   replays_per_newton_solve=(amg_graphs.replays - replays0)
                   / newton,
                   graph_collectives=amg_graphs.captured_collectives,
                   front_captures=LAST["front_captures"],
                   front_replays_per_newton_solve=LAST[
                       "front_replays_per_newton_solve"],
                   front_graph_collectives=front_graphs.captured_collectives,
                   step_captures=LAST["step_captures"],
                   step_replays=LAST["step_replays"],
                   step_replays_per_ssn_step=LAST[
                       "step_replays_per_ssn_step"],
                   step_graph_collectives=step_graphs.captured_collectives,
                   segment_sum_launches=n_seg,
                   same_as_loop=bool(
                       np.array_equal(res.fxk, base.fxk)
                       and np.array_equal(res.ssn_itnum, base.ssn_itnum)
                       and res.fail_count == base.fail_count
                       and res.iters == base.iters),
                   iters=res.iters, fail_count=res.fail_count,
                   fxk=float(res.fxk[-1]))
        if cls == 1:
            row.update(held_to_class1_reference(500, res))
        emit(f"dist_{name}_class{cls}_{500 if cls == 1 else 256}", **row)
        # A run that replays the front and the AMG block an earlier run
        # captured launches its segment sums inside those replays.
        if not (row["same_as_loop"] and (n_seg or not row["front_captures"])
                and row["replays"] > 0
                and counted_launches.replayed > 0
                and row["front_replays_per_newton_solve"] == 1.0
                and row["step_replays_per_ssn_step"] >= 1.0
                and counted_launches.setup["plain_label_rounds_on_card"]
                == 0):
            raise AssertionError(f"sharded Class-{cls} {name} driver differs "
                                 "from the sharded loop run, replayed no "
                                 "collective, not one front a Newton solve "
                                 "or not the step's regions an SsN step")
    if not (amg_graphs.captured_collectives
            and front_graphs.captured_collectives
            and step_graphs.captured_collectives):
        raise AssertionError("no captured AMG block, front or step region "
                             "holds a collective")
    return spmv, seg, setupk


# The outer iterations of the sharded mixed loop run that the sharded
# chunked run is held to bit for bit (of 55 to convergence): the loop's
# collectives cost 0.1-0.4 host ms each at one rank.
DIST_MIXED_OUTER = 15


def dist_mixed_check(dev, mesh, chunked500):
    """(i): the chunked (``chunk=8``) driver's mixed Class-1 500x500 solve
    on the sharded problem, at one rank, held to ``MIXED_REF`` and to the
    unsharded chunked mixed run of phase 7 (``chunked500``: its result and
    refinement counts) in converged, iterations and failures, with the
    refinement's regions captured under the mesh (its collectives inside)
    and no correction solve op by op; and, over the first
    :data:`DIST_MIXED_OUTER` outer iterations, the sharded chunked run
    bit for bit to the sharded loop run (iterations, failures, SsN steps,
    every objective and the refinement's counts).  Under a live mesh the
    smoother is the plain one by configuration, where the unsharded runs
    launch the ``bip_smooth`` kernel, so the sharded trajectory equals
    the unsharded one to rounding only (reported, not held).  Returns
    the full run's ``ell_spmv``, ``segment_sum`` and setup kernels'
    launches."""
    from otamg_torch.hybrid.solver import refine_graphs
    from otamg_torch.opt import solve_class1_chunked

    base, base_counts = chunked500
    refine_graphs.clear()
    chunked = lambda q, oo: solve_class1_chunked(q, oo, chunk=8)
    (out, n_spmv, n_seg) = counted_launches(lambda: run_mixed(
        1, 500, dev, lambda p, o: solve_class1_sharded(p, o, mesh,
                                                       chunked)))
    res, _, nums = out
    setup = counted_launches.setup
    row = dict(driver="chunked", same_as_unsharded=same_run(res, base),
               same_refine_counts_as_unsharded=(nums["refine_counts"]
                                                == base_counts),
               same_counts_as_unsharded=(
                   (res.converged, res.iters, res.fail_count)
                   == (base.converged, base.iters, base.fail_count)),
               eager_collectives=counted_launches.eager,
               replayed_collectives=counted_launches.replayed,
               refine_graph_collectives=refine_graphs.captured_collectives,
               segment_sum_launches=n_seg, **nums,
               **held_to_mixed_reference(1, 500, res))
    # The blocked rounds under the mesh against the loop's, bit for bit.
    short = lambda solve: run_mixed(
        1, 500, dev, lambda p, o: solve_class1_sharded(
            p, dataclasses.replace(o, maxit=DIST_MIXED_OUTER), mesh,
            solve))
    loop_res, loop_s, loop_nums = short(None)
    blk_res, blk_s, blk_nums = short(chunked)
    row.update(outer_held=DIST_MIXED_OUTER,
               same_as_sharded_loop=same_run(blk_res, loop_res),
               same_refine_counts_as_sharded_loop=(
                   blk_nums["refine_counts"] == loop_nums["refine_counts"]),
               sharded_loop_seconds=loop_s, sharded_chunked_seconds=blk_s)
    emit("dist_mixed_chunked_class1_500", **row)
    if not (row["same_counts_as_unsharded"] and row["same_as_sharded_loop"]
            and row["same_refine_counts_as_sharded_loop"]
            and nums["refine_captures"] == 2
            and refine_graphs.captured_collectives > 0
            and nums["eager_correction_solves"] == 0):
        raise AssertionError("sharded mixed chunked Class-1 500x500 differs "
                             "from the unsharded run in its counts or from "
                             "the sharded loop run, or its refinement "
                             "graphs hold no collective")
    return n_spmv, n_seg, setup


def solve_class1_sharded(prob, opts, mesh, solve=None):
    """``solve`` (``solve_class1`` by default) on ``prob`` row-sharded
    over ``mesh``; the result's plan gathered whole."""
    from otamg_torch.dist import shard_class1
    from otamg_torch.dist.api import all_gather_rows
    from otamg_torch.opt import solve_class1

    res = (solve or solve_class1)(shard_class1(prob, mesh), opts)
    return dataclasses.replace(res, X=all_gather_rows(res.X, mesh))


def dist_cli_check():
    """(f): the CLI's ``--shard`` on a group of one process."""
    argv = [sys.executable, "-m", "otamg_torch.cli", "class1", "--m", "256",
            "--n", "256", "--shard", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "1",
            "--process-id", "0"]
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600,
                         check=False)
    rep = (json.loads(out.stdout.strip().splitlines()[-1])
           if out.returncode == 0 else None)
    emit("dist_cli", argv=argv[1:], rc=out.returncode, report=rep,
         stderr_tail=out.stderr[-300:], seconds=time.perf_counter() - t0)
    if not (rep and rep["converged"]
            and "multi-host: process 0/1 (nccl)" in out.stderr):
        raise AssertionError(f"sharded CLI: {out.stderr[-2000:]}")


def _multirank_class1(rank, world, url, out):
    """One rank of (g): Class-1 1024x1024 sharded over ``world`` cards."""
    from otamg_torch.dist import init_multihost, make_mesh

    init_multihost(url, world, rank)
    try:
        res, secs, reads = run_class1(
            1024, 1024, torch.device("cuda", rank), class1_opts(),
            lambda p, o: solve_class1_sharded(p, o, make_mesh()))
        if rank == 0:
            row = held_to_class1_reference(1024, res)
            with open(out, "w") as fh:
                json.dump(dict(seconds=secs, host_reads_per_outer_iter=reads,
                               **row), fh)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def dist_multirank_check():
    """(g): ``min(4, count)`` NCCL ranks, one card each, where the
    machine has two or more cards."""
    count = torch.cuda.device_count()
    if count < 2:
        emit("dist_multirank", run=False,
             reason=f"{count} card: a multi-rank run needs one card a rank "
                    "(NCCL takes no two ranks on one card)")
        return
    import torch.multiprocessing as mp

    world = min(4, count)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        mp.start_processes(_multirank_class1,
                           args=(world, f"127.0.0.1:{free_port()}", out),
                           nprocs=world, start_method="spawn")
        with open(out) as fh:
            row = json.load(fh)
    emit("dist_multirank", run=True, world=world,
         wall_seconds=time.perf_counter() - t0, **row)


def phase_dist(card, dev, runs1, warm1, grid_res, sparse_res, chunked500):
    """Phase 11: ``otamg_torch.dist`` on a one-rank NCCL group, beside
    the unsharded runs of phases 4, 5 and 9, and the blocked drivers
    beside its own sharded loop runs.  Returns the ``ell_spmv``,
    ``segment_sum`` and setup kernels' launches of its paths."""
    import torch.distributed as dist

    from otamg_torch.dist import init_multihost, make_mesh

    t0 = time.perf_counter()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_mesh()
        emit("dist_group", backend=dist.get_backend(), size=mesh.size,
             device=str(mesh.device), seconds=time.perf_counter() - t0)
        spmv = {"dist_spmv": dist_spmv_checks(card, dev, mesh)}
        dist_collective_times(dev, mesh)
        dist_assembly_checks(dev, mesh)
        halo_spmv, seg = dist_halo_checks(dev, mesh, grid_res, sparse_res)
        spmv.update(halo_spmv)
        seg_class, loops, setupk = dist_class_checks(dev, mesh, runs1, warm1)
        seg.update(seg_class)
        blocked_spmv, blocked_seg, blocked_setupk = dist_blocked_checks(
            dev, mesh, loops)
        spmv.update(blocked_spmv)
        seg.update(blocked_seg)
        setupk.update(blocked_setupk)
        name = "dist_mixed_class1_chunked"
        spmv[name], seg[name], setupk[name] = dist_mixed_check(dev, mesh,
                                                               chunked500)
    finally:
        dist.destroy_process_group()
    dist_cli_check()
    dist_multirank_check()
    return spmv, seg, setupk


# The unit check's body: out = 2 x + 1 over this many f64.
COND_N = 1 << 22


def cond_unit(card, dev):
    """One conditional node of ``graphs.when`` (the ``set_if`` launch of
    ``csrc/conditional.cu`` and the IF node) whose body writes ``out = 2
    x + 1`` in place: one graph holding it, replayed with ``pred`` true,
    false and true again, gives the body's output, then the buffer as it
    was, then the body's output, bit for bit the same graph captured in
    the select form (``graphs.select_form``, the plain version).  Times,
    each a graph of ``REPS`` such nodes replayed between events: ``ms``
    with ``pred`` true, ``skip_ms`` false, ``plain_ms`` the select form;
    the bound: ``x`` read and ``out`` written once."""
    from otamg_torch import graphs
    from otamg_torch.diag.roofline import hbm_rate

    graphs.prepare(torch.device("cuda", torch.cuda.current_device()))
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(COND_N, dtype=torch.float64, generator=gen).to(dev)
    out = torch.empty_like(x)
    pred = torch.ones((), dtype=torch.bool, device=dev)

    def node():
        graphs.when(pred, lambda: torch.mul(x, 2, out=out).add_(1), [out])

    def replays(graph):
        got = []
        for p in (True, False, True):
            pred.fill_(p)
            out.fill_(-1.0)
            graph.replay()
            got.append(out.clone())
        return got

    res = {}
    for form in ("if_node", "select"):
        ctx = (graphs.select_form() if form == "select"
               else contextlib.nullcontext())
        with ctx:
            graph = torch.cuda.CUDAGraph()
            with graphs.capture(graph):
                node()
        res[form] = replays(graph)
        del graph
    want = 2 * x + 1
    ok = (torch.equal(res["if_node"][0], want)
          and bool((res["if_node"][1] == -1.0).all())
          and torch.equal(res["if_node"][2], want)
          and all(torch.equal(a, b) for a, b in zip(res["if_node"],
                                                    res["select"])))
    err = max(float((a - b).abs().max()) for a, b in zip(res["if_node"],
                                                         res["select"]))
    pred.fill_(True)
    ms = graph_ms(node)
    pred.fill_(False)
    skip_ms = graph_ms(node)
    pred.fill_(True)
    with graphs.select_form():
        plain_ms = graph_ms(node)
    row = dict(n=COND_N, dtype="float64", equal_to_select=ok,
               max_abs_err=err, ms=ms, skip_ms=skip_ms, plain_ms=plain_ms,
               bound_ms=2 * COND_N * 8 / hbm_rate(card) * 1e3,
               bound_by="bytes", library_ms=None)
    emit("conditional_unit", **row)
    if not ok:
        raise AssertionError("a conditional node's replays differ from its "
                             "body's output or from the select form")
    return row


def repairs_of(args) -> int:
    """The defect repairs that the eager ``newton_front(*args)`` fires."""
    from otamg_torch.amg.hierarchy import setup_stats
    from otamg_torch.hybrid import solver

    before = setup_stats.read()[1]
    solver.newton_front(*args)
    return setup_stats.read()[1] - before


def front_cases(systems, tries: int = 48) -> dict:
    """Two sets of ``newton_front``'s arguments: the first Newton
    system's (``systems[0]``), and the first that does the opposite
    (fires the defect repair where it does not, or not where it does)
    of the other recorded systems, then of the first with the keys
    ``PRNGKey(1000 + i)``, ``i < tries``: ``{"repair": (args, what),
    "no_repair": ...}``, ``what`` the recorded system's index or the
    key's ``1000 + i``; a case is left out where none gives it."""
    from otamg_torch import random as jr

    fires = repairs_of(systems[0]) > 0
    cases = {"repair" if fires else "no_repair": (systems[0], 0)}
    others = [(a, f"system {j}") for j, a in enumerate(systems) if j]
    others += [((*systems[0][:7], jr.PRNGKey(1000 + i), *systems[0][8:]),
                f"key {1000 + i}") for i in range(tries)]
    for a, what in others:
        if (repairs_of(a) > 0) != fires:
            cases["no_repair" if fires else "repair"] = (a, what)
            break
    return cases


def replay_device_ms(replay, reps: int = 10, before=None) -> float:
    """Device ms of ``replay()``: events around it, ``before()`` (a
    reload, not timed) ahead of each; the median of ``reps``."""
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def held_pools() -> set:
    """The private memory pools (CUDA graphs' and their conditional
    bodies') that hold memory after ``empty_cache``."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {tuple(seg["segment_pool_id"])
            for seg in torch.cuda.memory_snapshot()} - {(0, 0)}


def front_forms(recs):
    """The Newton solve's front (``newton_front``, one CUDA graph) at
    Class-1 500^2 and 1024^2 on the first Newton system of the loop run
    (``recs``), with and without a defect repair (:func:`front_cases`),
    each captured in the select form and with the conditional nodes: the
    replay's device ms, the repairs built in it, and its outputs bit for
    bit the eager front's.  Once the fronts are dropped
    (``front_graphs.clear``), no memory pool of their conditional bodies
    (``graphs.capture``'s, one a graph with a node) holds memory after
    ``empty_cache``: the body pools and the graphs' own that held memory
    after the captures, those left, and the reserved memory before and
    after (a graph's own pool may keep a workspace that torch caches for
    the capture's stream)."""
    rows = {}
    pools = held_pools()
    reserved = torch.cuda.memory_reserved()
    made, bodies = set(), set()
    handle = torch.cuda.graph_pool_handle

    def body_pool():
        # graphs.capture makes a body pool with this call (the graphs'
        # own pools are made inside torch).
        pool = handle()
        bodies.add(tuple(pool))
        return pool

    torch.cuda.graph_pool_handle = body_pool
    try:
        front_rows(recs, rows, pools, made)
    finally:
        torch.cuda.graph_pool_handle = handle
    left = held_pools() & made
    emit("conditional_pools", body_pools=len(made & bodies),
         body_pools_left=len(left & bodies),
         graph_pools=len(made - bodies), graph_pools_left=len(left - bodies),
         reserved_mib_before=reserved / 2**20,
         reserved_mib_after=torch.cuda.memory_reserved() / 2**20)
    if not made & bodies or left & bodies:
        raise AssertionError(f"{len(left & bodies)} of the "
                             f"{len(made & bodies)} memory pools of the "
                             "fronts' conditional bodies hold memory after "
                             "front_graphs.clear()")
    return rows


def front_rows(recs, rows, pools, made):
    """:func:`front_forms`' captures and replays: a row a size into
    ``rows``, and into ``made`` the memory pools outside ``pools`` that
    hold memory after each form's captures."""
    from otamg_torch import graphs
    from otamg_torch.amg import hierarchy
    from otamg_torch.hybrid import solver

    def flat(fr):
        return [t.clone() for t in (*fr[:9], *(
            t for lv in (fr.lv1, *fr.dense) for t in hierarchy._leaves(lv)),
            fr.deep)]

    for size, rec in recs.items():
        args = rec.setup[0][0][:9]
        found = front_cases([a[:9] for a, _ in rec.setup])
        cases = {name: a for name, (a, _) in found.items()}
        eager = {name: flat(solver.newton_front(*a))
                 for name, a in cases.items()}
        row = dict(size=size, cases={name: what for name, (_, what)
                                     in found.items()})
        for form in ("select", "if_node"):
            solver.front_graphs.clear()
            ctx = (graphs.select_form() if form == "select"
                   else contextlib.nullcontext())
            with ctx:
                solver.newton_front(*args, exit_every=8)
            for name, a in cases.items():
                before = graphs.cond_counts.read()["repairs"]
                fr = solver.newton_front(*a, exit_every=8)
                built = graphs.cond_counts.read()["repairs"] - before
                same = all(torch.equal(u, v)
                           for u, v in zip(flat(fr), eager[name]))
                ms = replay_device_ms(fr.graph.graph.replay)
                row[f"{form}_{name}"] = dict(device_ms=ms,
                                             repairs_built=built,
                                             equal_to_eager=same)
                if not same:
                    raise AssertionError(f"the {size}x{size} front ({form}, "
                                         f"{name}) differs from the eager "
                                         "one")
            fr = None
            made |= held_pools() - pools
        solver.front_graphs.clear()
        emit("conditional_front", **row)
        rows[size] = row


def block_forms(dev):
    """An AMG block and an Armijo block, each captured in the select
    form and with the conditional nodes by a 3-iteration Class-1 500^2
    chunked solve (equal bit for bit in the two forms): the AMG block's
    replay from the last solve's first state (``exit_every`` steps, the
    exit possibly inside) and from a state past its exit, and the
    Armijo block (``trials``) from the state the solve's last one found,
    each with its device ms and the bodies it ran (the block's first
    trial runs outside its nodes, and is not counted here)."""
    from otamg_torch import graphs
    from otamg_torch.amg.hierarchy import amg_graphs
    from otamg_torch.graphs import run_region
    from otamg_torch.hybrid.solver import front_graphs
    from otamg_torch.opt import regions
    from otamg_torch.opt.regions import step_graphs

    opts = dataclasses.replace(class1_opts(), maxit=3)
    rows, results = {}, {}
    load = graphs.Captured.load
    for form in ("select", "if_node"):
        for cache in (amg_graphs, front_graphs, step_graphs):
            cache.clear()
        loaded, trial_state = {}, {}

        def recorded(self, inputs, loaded=loaded):
            loaded[id(self)] = [t.clone() for t in inputs]
            load(self, inputs)

        def region(cache, key, fn, st, *a, **kw):
            if key[1] == "trials":
                trial_state.update(key=key, values=[
                    (t, t.clone()) for t in st.buffers()])
            return run_region(cache, key, fn, st, *a, **kw)

        graphs.Captured.load = recorded
        regions.run_region = region
        try:
            with (graphs.select_form() if form == "select"
                  else contextlib.nullcontext()):
                results[form], _, _ = run_class1(
                    500, 500, dev, opts, blocked_solve(1, "chunked"))
        finally:
            graphs.Captured.load = load
            regions.run_region = run_region
        blk = next(iter(amg_graphs.blocks.values()))
        start = loaded[id(blk)]

        def ran(fn, slot):
            before = graphs.cond_counts.read()[slot]
            fn()
            torch.cuda.synchronize()
            return graphs.cond_counts.read()[slot] - before

        def exited():
            blk.load(start)
            blk.inputs[-1].fill_(False)

        row = dict(
            amg_block_ms=replay_device_ms(blk.replay,
                                          before=lambda: blk.load(start)),
            amg_block_cycles=ran(lambda: (blk.load(start), blk.replay()),
                                 "amg_cycles"),
            amg_exited_ms=replay_device_ms(blk.replay, before=exited),
            amg_exited_cycles=ran(lambda: (exited(), blk.replay()),
                                  "amg_cycles"))
        if trial_state:
            blk_t = step_graphs.blocks[trial_state["key"]]

            def restore():
                for t, v in trial_state["values"]:
                    t.copy_(v)

            row.update(armijo_block_ms=replay_device_ms(blk_t.replay,
                                                        before=restore),
                       armijo_trials_run=ran(lambda: (restore(),
                                                      blk_t.replay()),
                                             "armijo_trials"),
                       armijo_block_size=8)
        rows[form] = row
    for cache in (amg_graphs, front_graphs, step_graphs):
        cache.clear()
    same = same_run(results["if_node"], results["select"])
    emit("conditional_blocks", equal_forms=same, **rows)
    if not same:
        raise AssertionError("the blocked solve in the select form and with "
                             "conditional nodes differ")
    return rows


def phase_conditional(card, dev, recs):
    """JAX's ``lax.cond`` and ``while_loop`` exits as CUDA-graph
    conditional nodes: :func:`cond_unit`; the bodies of every blocked
    run of phases setup_graph and mixed beside its loop run's
    (:data:`BODIES`, each held there); :func:`front_forms` and
    :func:`block_forms`.  Returns the ``set_if`` kernel's row."""
    row = cond_unit(card, dev)
    held = all(v["held"] for v in BODIES.values())
    emit("conditional_solves", held=held, runs=BODIES)
    if not held or not BODIES:
        raise AssertionError(f"bodies of a blocked run not held: {BODIES}")
    front_forms(recs)
    block_forms(dev)
    return row



def phase_roofline(card, res, secs):
    """The bytes model of a Class-1 solve (``class1_opts()``) against
    the card's memory bandwidth; reported, not held."""
    from otamg_torch.amg.hierarchy import capacity_schedule
    from otamg_torch.diag.roofline import roofline_report, solve_bytes_model

    amg = class1_opts().amg
    m = n = 500
    caps = capacity_schedule(m, m + n, amg)
    model = solve_bytes_model(m, n, res.iters, int(res.ssn_itnum.sum()),
                              res.inner_total, amg.smoth, 3, caps,
                              amg.fuse_deep, plan_itemsize=8,
                              solve_itemsize=8)
    emit("roofline", size=500, run="warm", iters=res.iters,
         ssn_total=int(res.ssn_itnum.sum()), cycles_total=res.inner_total,
         caps=caps, seconds=secs, card=card,
         **roofline_report(model, secs, torch.device("cuda")))


# The keys of a path's launches in ``setupk``.
SETUP_KEYS = ("mis_rounds", "coarse_eigh", "label_rounds",
              "plain_label_rounds_on_card", "bip_smooth", "bip_smooth_runs",
              "plain_bip_smooth_on_card")
# The paths whose runs launch the labels kernel themselves.
LABEL_PATHS = ("class1", "class2", "mixed", "class1_500_chunked",
               "class1_1024_chunked", "class2_500_chunked", "dist_class1",
               "dist_class1_explicit", "dist_class2", "dist_class1_chunked",
               "dist_class2_chunked")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from otamg_torch import cuda_build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    emit("device", nvidia_smi=smi_line, kind=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = cuda_build.build_all(verbose=True)
    emit("build", seconds=build_s)
    count_plain_rounds()
    count_plain_smooth()
    count_refinement()

    t0 = time.perf_counter()
    rows = phase_kernels(card, dev)
    seg_rows = phase_segment_sum(card, dev)
    mis_rows, eigh_rows, label_rows, _, recs, rec2 = phase_setup_kernels(
        card, dev)
    smooth_rows = phase_bip_smooth(card, dev, recs, rec2)
    emit("kernel_checks", seconds=time.perf_counter() - t0)
    # Each path's launches: counts set to 0 just before it, read after.
    seg, setupk = {}, {}
    zero_counts()
    launches = {}
    launches["sparse_amg"], grid_res = phase_sparse_amg(dev)
    seg["sparse_amg"] = counts()
    t0 = time.perf_counter()
    runs1, warm1, class1_launches, loop1024 = phase_class1(dev)
    seg["class1"] = class1_launches["segment_sum"]
    setupk["class1"] = class1_launches
    emit("class1", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    zero_counts()
    runs2, warm2 = phase_class2(dev)
    seg["class2"] = counts()
    setupk["class2"] = setup_counts()
    emit("class2", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    graph_launches, blocked64 = phase_setup_graph(dev, {(1, 500): warm1,
                                                        (1, 1024): loop1024,
                                                        (2, 500): warm2})
    for name, n in graph_launches.items():
        seg[name] = n["segment_sum"]
        setupk[name] = {k: n[k] for k in SETUP_KEYS}
    condk = {name: n["set_if"] for name, n in graph_launches.items()}
    emit("setup_graph", seconds=time.perf_counter() - t0)
    f64 = {(1,) + k: v for k, v in runs1.items()}
    f64.update({(2,) + k: v for k, v in runs2.items()})
    t0 = time.perf_counter()
    zero_counts()
    chunked500, mixed_launches = phase_mixed(dev, f64, blocked64)
    setupk["mixed"] = setup_counts()
    for name, n in mixed_launches.items():
        seg[name] = n["segment_sum"]
        setupk[name] = {k: n[k] for k in SETUP_KEYS}
    condk.update({name: n["set_if"] for name, n in mixed_launches.items()})
    emit("mixed_all", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cond_row = phase_conditional(card, dev, recs)
    emit("conditional", seconds=time.perf_counter() - t0)
    phase_roofline(card, *warm1[:2])
    zero_counts()
    launches["sparse_setup"], _, seg["sparse_setup"], sparse_res = \
        phase_sparse_setup(card, dev)
    setupk["sparse_setup"] = setup_counts()
    t0 = time.perf_counter()
    phase_cli()
    emit("cli", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    dist_spmv, dist_seg, dist_setupk = phase_dist(card, dev, runs1, warm1,
                                                  grid_res, sparse_res,
                                                  chunked500)
    launches.update(dist_spmv)
    seg.update(dist_seg)
    setupk.update(dist_setupk)
    emit("dist_all", seconds=time.perf_counter() - t0)

    # Every path of the Newton solve launched the labels kernel (the
    # fused and warm blocked runs replay the front their chunked run
    # captured, kernel and all), and no path ran the plain rounds on the
    # card.
    unlabelled = [k for k in LABEL_PATHS if not setupk[k]["label_rounds"]]
    plain = {k: v["plain_label_rounds_on_card"] for k, v in setupk.items()
             if v["plain_label_rounds_on_card"]}
    emit("label_rounds_paths", launches={k: v["label_rounds"]
                                         for k, v in setupk.items()},
         unlabelled=unlabelled, plain_rounds_on_card=plain)
    if unlabelled or plain:
        raise AssertionError(f"paths without a label_rounds launch "
                             f"{unlabelled} or with plain rounds {plain}")
    # Every single-card path ran the smoother kernel (the warm and fused
    # blocked runs in the AMG block's replays, counted on the card) and
    # no plain smoother on the card; the sharded paths run the plain one
    # by configuration.
    single = [k for k in setupk if not k.startswith("dist_")
              and k != "sparse_setup"]
    unsmoothed = [k for k in single if not setupk[k]["bip_smooth_runs"]]
    plain_smooth = {k: setupk[k]["plain_bip_smooth_on_card"] for k in single
                    if setupk[k]["plain_bip_smooth_on_card"]}
    emit("bip_smooth_paths",
         launches={k: v["bip_smooth"] for k, v in setupk.items()},
         runs_on_card={k: v["bip_smooth_runs"] for k, v in setupk.items()},
         plain_on_card={k: v["plain_bip_smooth_on_card"]
                        for k, v in setupk.items()},
         plain_by_configuration=sorted(k for k in setupk
                                       if k.startswith("dist_")),
         unsmoothed=unsmoothed, plain_single_card=plain_smooth)
    if unsmoothed or plain_smooth:
        raise AssertionError(f"single-card paths without a bip_smooth run "
                             f"{unsmoothed} or with the plain smoother on "
                             f"the card {plain_smooth}")
    main_row = rows[("grid128", torch.float64)]
    seg_row = seg_rows["components1000_L500"]
    mis_row = mis_rows["class1_500_c500"]
    eigh_row = eigh_rows[("coarsest level", 123, torch.float64)]
    label_row = label_rows["class1_500"]
    smooth_row = smooth_rows["class1_500_pre"]
    print(json.dumps({"kernels": [{
        "name": "ell_spmv", "route": "cuda",
        "source": "otamg_torch/csrc/ell_spmv.cu",
        "replaces": "otamg/sparse/kernels.py:124",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["device_ms"], "host_us": main_row["host_us"],
        "variant": main_row["variant"]}, {
        "name": "segment_sum", "route": "cuda",
        "source": "otamg_torch/csrc/segment_sum.cu",
        "replaces": "otamg/amg/hierarchy.py:404 (jax.ops.segment_sum, an "
                    "XLA scatter-add; no Pallas kernel)",
        "launches": seg["class1"], "launches_by_path": seg,
        "max_abs_err": seg_row["max_abs_err"], "ms": seg_row["ms"],
        "plain_ms": seg_row["plain_ms"], "bound_ms": seg_row["bound_ms"],
        "bound_by": seg_row["bound_by"],
        "library_ms": seg_row["library_ms"],
        "device_ms": seg_row["device_ms"], "plan_ms": seg_row["plan_ms"],
        "noplan_ms": seg_row["noplan_ms"], "host_us": seg_row["host_us"],
        "pair_ms": seg_rows["pair1000_500x500"]["ms"],
        "pair_device_ms": seg_rows["pair1000_500x500"]["device_ms"],
        "variant": seg_row["variant"]}, {
        "name": "mis_rounds", "route": "cuda",
        "source": "otamg_torch/csrc/mis.cu",
        "replaces": "otamg/amg/graph.py:99 (the lax.while_loop of "
                    "mis_dense's rounds; no Pallas kernel)",
        "launches": setupk["class1"]["mis_rounds"],
        "launches_by_path": {k: v["mis_rounds"] for k, v in setupk.items()},
        "max_abs_err": mis_row["max_abs_err"], "ms": mis_row["ms"],
        "plain_ms": mis_row["plain_ms"], "bound_ms": mis_row["bound_ms"],
        "bound_by": mis_row["bound_by"], "library_ms": None,
        "device_ms": mis_row["device_ms"], "shape": mis_row["shape"],
        "rounds": mis_row["rounds"]}, {
        "name": "coarse_eigh", "route": "cuda",
        "source": "otamg_torch/csrc/coarse_eigh.cu",
        "replaces": "otamg/amg/hierarchy.py:600 (jnp.linalg.eigh of the "
                    "coarsest level; no Pallas kernel)",
        "launches": setupk["class1"]["coarse_eigh"],
        "launches_by_path": {k: v["coarse_eigh"] for k, v in setupk.items()},
        "max_abs_err": eigh_row["max_abs_err"], "ms": eigh_row["ms"],
        "plain_ms": eigh_row["plain_ms"], "bound_ms": eigh_row["bound_ms"],
        "bound_by": eigh_row["bound_by"],
        "library_ms": eigh_row["library_ms"],
        "device_ms": eigh_row["device_ms"], "n": eigh_row["n"],
        "dtype": eigh_row["dtype"]}, {
        "name": "label_rounds", "route": "cuda",
        "source": "otamg_torch/csrc/labels.cu",
        "replaces": "otamg/amg/graph.py:64 (the lax.while_loop of "
                    "connected_components_bipartite; no Pallas kernel)",
        "launches": setupk["class1"]["label_rounds"],
        "launches_by_path": {k: v["label_rounds"] for k, v in setupk.items()},
        "max_abs_err": label_row["max_abs_err"], "ms": label_row["ms"],
        "plain_ms": label_row["plain_ms"], "bound_ms": label_row["bound_ms"],
        "bound_by": label_row["bound_by"], "library_ms": None,
        "device_ms": label_row["device_ms"], "shape": label_row["shape"],
        "rounds": label_row["rounds"]}, {
        "name": "set_if", "route": "cuda",
        "source": "otamg_torch/csrc/conditional.cu",
        "replaces": "otamg/amg/hierarchy.py:941 (the lax.cond of the "
                    "defect repair) and the exits of the lax.while_loops "
                    "of otamg/amg/hierarchy.py:1429, otamg/opt/apd.py:291, "
                    "otamg/opt/apd2.py:302 and otamg/hybrid/solver.py:293; "
                    "no Pallas kernel",
        "launches": condk["class1_500_chunked"], "launches_by_path": condk,
        "max_abs_err": cond_row["max_abs_err"], "ms": cond_row["ms"],
        "plain_ms": cond_row["plain_ms"], "bound_ms": cond_row["bound_ms"],
        "bound_by": cond_row["bound_by"], "library_ms": None,
        "skip_ms": cond_row["skip_ms"], "n": cond_row["n"]}, {
        "name": "bip_smooth", "route": "cuda",
        "source": "otamg_torch/csrc/bip_smooth.cu",
        "replaces": "otamg/amg/hierarchy.py:320 (XLA's fusion of "
                    "_projected_smooth_bip, two lax.fori_loops; no Pallas "
                    "kernel)",
        "launches": setupk["class1"]["bip_smooth"],
        "launches_by_path": {k: v["bip_smooth"] for k, v in setupk.items()},
        "runs_on_card_by_path": {k: v["bip_smooth_runs"]
                                 for k, v in setupk.items()},
        "max_abs_err": smooth_row["max_abs_err"], "ms": smooth_row["ms"],
        "plain_ms": smooth_row["plain_ms"],
        "bound_ms": smooth_row["bound_ms"],
        "bound_by": smooth_row["bound_by"], "library_ms": None,
        "mv_ms": smooth_row["mv_ms"],
        "device_ms": smooth_row["device_ms"],
        "host_us": smooth_row["host_us"], "layout": smooth_row["layout"],
        "shape": smooth_row["shape"]}]}))
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
