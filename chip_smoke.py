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
   the two sums it replaces;
4. sparse   — ``amg_solve_matrix`` on the 128x128 grid Laplacian + 0.01 I
   as an ELL ``CSR`` (the path that runs the kernel), 30 iterations, with
   its launches, checked against the same solve through the plain SpMV;
5. class1   — ``solve_class1`` (AMG inner solver, F-cycle, fuse_deep):
   a 24x20 problem checked against ``scipy.optimize.linprog`` and against
   the port on the CPU, then 256x256, 500x500 (one cold and two warm
   runs) and 1024x1024 once, each held to the JAX package's CPU f64 run
   (``CLASS1_REF``), with the host reads per outer iteration;
6. class2   — ``solve_class2`` (the same AMG inner solver with the
   Class-2 budget ``maxit=40, smoth=10``, ``ssn_tol1=1e-10``, no
   feasibility polish): ``random_class2(PRNGKey(7), 20, 16,
   mu_frac=0.6)`` with the Class-2 defaults checked against
   ``scipy.optimize.linprog`` and against the port on the CPU, then
   500x500 (one cold and one warm run, whose failures and SsN steps are
   compared with each other) and 1024x1024 once through the chunked
   driver, each held to the JAX package's CPU f64 run (``CLASS2_REF``);
   drivers  — the chunked (``chunk=8``) and fused drivers beside the warm
   loop runs of phases 5 and 6: Class-1 500x500 chunked twice and fused,
   each with the loop run's iterations, failures and SsN steps, the
   objective to 1e-10 of it and at most half its host reads per outer
   iteration; Class-2 500x500 chunked once, with the loop run's
   iterations and failures; the AMG block's CUDA graph captures and
   replays per Newton solve;
7. mixed    — the same Class-1 and Class-2 solves with
   ``solve_dtype="float32"`` (fp32 AMG hierarchy, exact kernel deflation,
   f64 refinement; ``bench.py``'s configuration on an accelerator):
   Class-1 500x500 cold and warm and 1024x1024 once, Class-2 500x500
   once, each held to the JAX package's CPU run of the same problem and
   options (``MIXED_REF``) and printed beside the f64 run's seconds from
   this call, with the refinement rounds, reverted rounds and mean
   correction cycles.  Fails if TF32 matmuls are on;
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
   otamg_torch.cli info`` as a subprocess.

Then one JSON line listing every kernel (``ell_spmv`` and
``segment_sum``, each with its launches by path), the card's name and
power limit, and the last line ``{"ok": true, "device": {...}}``.  Any failure
raises and exits nonzero; without CUDA the script exits nonzero before
printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

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
    """Set the ``segment_sum`` kernels' launch count to 0."""
    from otamg_torch.sparse.segment import segment_sum

    segment_sum.launches = 0


def counts() -> int:
    """The ``segment_sum`` kernels' launches since :func:`zero_counts`."""
    from otamg_torch.sparse.segment import segment_sum

    return segment_sum.launches


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
    ``reps``; median of ``ROUNDS`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    """The sparse-AMG path: every fine matvec is the ELL kernel."""
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
    return launches


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


def run_class1(m, n, dev, opts, solve=None):
    """(result, seconds, host reads per outer iteration) of ``solve``
    (the loop driver by default) on ``random_class1(PRNGKey(0), m, n)``."""
    from otamg_torch.device import fetch
    from otamg_torch.opt import solve_class1
    from otamg_torch.ot import random_class1
    from otamg_torch.random import PRNGKey

    prob = random_class1(PRNGKey(0), m, n, device=dev)
    torch.cuda.synchronize()
    reads0 = fetch.reads
    t0 = time.perf_counter()
    res = (solve or solve_class1)(prob, opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    X = res.X
    if not (X.shape == (m, n) and bool(torch.isfinite(X).all())
            and bool((X >= 0).all())):
        raise AssertionError(f"{m}x{n}: plan is not finite and nonnegative")
    return res, secs, (fetch.reads - reads0) / max(res.iters, 1)


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
    emit("class1_256", seconds=secs, host_reads_per_outer_iter=reads,
         **held_to_class1_reference(256, res))
    for label in ("cold", "warm", "warm"):
        # The main path's launches: the count set to 0 just before the
        # run and read just after.
        zero_counts()
        res, secs, reads = run_class1(500, 500, dev, opts)
        launches = counts()
        runs.setdefault((500, label), secs)
        warm = (res, secs, reads)
        emit("class1_500", run=label, seconds=secs,
             host_reads_per_outer_iter=reads,
             segment_sum_launches=launches,
             **held_to_class1_reference(500, res))
    if launches == 0:
        raise AssertionError("the Class-1 solve launched no segment_sum "
                             "kernel")
    res, secs, reads = run_class1(1024, 1024, dev, opts)
    emit("class1_1024", seconds=secs, host_reads_per_outer_iter=reads,
         **held_to_class1_reference(1024, res))
    runs[(1024, "once")] = secs
    return runs, warm, launches


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
    from otamg_torch.device import fetch
    from otamg_torch.opt import solve_class2
    from otamg_torch.ot import random_class2
    from otamg_torch.random import PRNGKey

    prob = random_class2(PRNGKey(0), m, n, device=dev)
    torch.cuda.synchronize()
    reads0 = fetch.reads
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
    return res, secs, (fetch.reads - reads0) / max(res.iters, 1)


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
    runs, loop500 = {}, []
    for label in ("cold", "warm"):
        res, secs, reads = run_class2(500, 500, dev, opts)
        runs[(500, label)] = secs
        loop500.append((res, secs, reads))
        extra = ({"fxk_trajectory": res.fxk.tolist(),
                  "ssn_itnum": res.ssn_itnum.tolist()}
                 if label == "cold" else {})
        emit("class2_500", run=label, seconds=secs,
             host_reads_per_outer_iter=reads,
             **held_to_reference(500, res), **extra)
    # Two runs of one solve on the card: with the deterministic segment
    # sum they walk the same path (reported, not held).
    a, b = loop500[0][0], loop500[1][0]
    emit("class2_500_repeat", fail_count=[a.fail_count, b.fail_count],
         iters=[a.iters, b.iters], same_ssn_itnum=bool(
             np.array_equal(a.ssn_itnum, b.ssn_itnum)),
         same_fxk=bool(np.array_equal(a.fxk, b.fxk)))
    # 1024x1024 through the chunked driver (the loop driver's trajectory
    # in about half its time, phase drivers).
    from otamg_torch.opt import solve_class2_chunked

    res, secs, reads = run_class2(1024, 1024, dev, opts,
                                  lambda p, o: solve_class2_chunked(p, o))
    emit("class2_1024", driver="chunked", seconds=secs,
         host_reads_per_outer_iter=reads, **held_to_reference(1024, res))
    runs[(1024, "once")] = secs
    return runs, loop500[1]


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


def phase_drivers(dev, loop1, loop2):
    """The chunked (``chunk=8``) and fused drivers beside the loop
    driver's warm runs of this call (``loop1``: Class-1 500x500,
    ``loop2``: Class-2 500x500, each ``(result, seconds, reads)``).
    Class 1: chunked twice (the first captures the AMG block's CUDA
    graph) and fused, each with the loop run's iterations, failures and
    SsN steps, ``CLASS1_REF``, the objective to 1e-10 of the loop run's
    and at most half its host reads per outer iteration.  Class 2:
    chunked once, with the loop run's iterations and failures and
    ``CLASS2_REF``.  Reports the graph captures (at most one per tape
    signature) and replays per Newton solve, and the path's
    ``segment_sum`` launches."""
    from otamg_torch.amg.hierarchy import amg_graphs
    from otamg_torch.opt import (solve_class1_chunked, solve_class1_fused,
                                 solve_class2_chunked)

    chunked1 = lambda p, o: solve_class1_chunked(p, o, chunk=8)
    chunked2 = lambda p, o: solve_class2_chunked(p, o, chunk=8)
    amg_graphs.clear()
    zero_counts()
    base, base_s, base_reads = loop1
    out = {"loop": dict(seconds=base_s, host_reads_per_outer_iter=base_reads)}
    for name, solve in (("chunked", chunked1), ("chunked_warm", chunked1),
                        ("fused", solve_class1_fused)):
        replays0 = amg_graphs.replays
        res, secs, reads = run_class1(500, 500, dev, class1_opts(), solve)
        rel = abs(res.fxk[-1] - base.fxk[-1]) / abs(base.fxk[-1])
        row = dict(seconds=secs, host_reads_per_outer_iter=reads,
                   fxk_rel_vs_loop=rel, captures=amg_graphs.captures,
                   replays_per_newton_solve=(amg_graphs.replays - replays0)
                   / max(int(res.ssn_itnum.sum()), 1),
                   same_ssn_itnum=bool(np.array_equal(res.ssn_itnum,
                                                      base.ssn_itnum)),
                   **held_to_class1_reference(500, res))
        out[name] = row
        emit("drivers_class1_500", driver=name, loop_seconds=base_s,
             loop_reads=base_reads, **row)
        if not ((res.iters, res.fail_count) == (base.iters, base.fail_count)
                and row["same_ssn_itnum"] and rel <= 1e-10
                and reads <= base_reads / 2 and amg_graphs.captures <= 1
                and amg_graphs.replays > replays0):
            raise AssertionError(f"Class-1 500x500 {name} driver differs "
                                 "from the loop driver")
    launches = counts()
    res2l, secs2l, reads2l = loop2
    captures0 = amg_graphs.captures
    replays0 = amg_graphs.replays
    res, secs, reads = run_class2(500, 500, dev, class2_opts(), chunked2)
    row = dict(seconds=secs, host_reads_per_outer_iter=reads,
               loop_seconds=secs2l, loop_reads=reads2l,
               loop_fail_count=res2l.fail_count,
               captures=amg_graphs.captures - captures0,
               replays_per_newton_solve=(amg_graphs.replays - replays0)
               / max(int(res.ssn_itnum.sum()), 1),
               same_ssn_itnum=bool(np.array_equal(res.ssn_itnum,
                                                  res2l.ssn_itnum)),
               **held_to_reference(500, res))
    out["class2_chunked"] = row
    emit("drivers_class2_500", driver="chunked", **row)
    if not ((res.iters, res.fail_count) == (res2l.iters, res2l.fail_count)
            and row["captures"] <= 1 and reads < reads2l):
        raise AssertionError("Class-2 500x500 chunked driver differs from "
                             "the loop driver")
    return out, launches


def phase_mixed(dev, f64_seconds):
    """``bench.py``'s configuration on an accelerator: the Newton solves
    with ``solve_dtype="float32"`` (fp32 hierarchy, exact kernel
    deflation, f64 refinement), each run held to the JAX package's CPU
    run of the same problem and options (``MIXED_REF``), beside the f64
    run's seconds from this call (``f64_seconds[(class, size, run)]``)."""
    from otamg_torch.hybrid.solver import refine_counts

    tf32 = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())
    emit("mixed_tf32", **tf32)
    if tf32["allow_tf32"] or tf32["float32_matmul_precision"] != "highest":
        raise AssertionError(f"TF32 matmuls are on ({tf32}): the fp32 "
                             "hierarchy needs true fp32")
    for cls, size, label in ((1, 500, "cold"), (1, 500, "warm"),
                             (1, 1024, "once"), (2, 500, "once")):
        refine_counts.reset()
        if cls == 1:
            res, secs, reads = run_class1(size, size, dev,
                                          class1_opts("float32"))
        else:
            res, secs, reads = run_class2(size, size, dev,
                                          class2_opts("float32"))
        c = refine_counts
        emit("mixed", **{"class": cls}, size=size, run=label, seconds=secs,
             f64_seconds=f64_seconds[(cls, size, label)],
             host_reads_per_outer_iter=reads, newton_solves=c.solves,
             refine_rounds=c.rounds, reverted_rounds=c.reverted,
             rounds_per_solve=c.rounds / max(c.solves, 1),
             mean_correction_cycles=c.cycles / max(c.rounds, 1),
             **held_to_mixed_reference(cls, size, res))


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
    return launches, timed, seg_launches


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

    from otamg_torch.sparse import ell_spmv

    t0 = time.perf_counter()
    rows = phase_kernels(card, dev)
    seg_rows = phase_segment_sum(card, dev)
    emit("kernel_checks", seconds=time.perf_counter() - t0)
    # Each path's launches: counts set to 0 just before it, read after.
    seg = {}
    zero_counts()
    launches = {"sparse_amg": phase_sparse_amg(dev)}
    seg["sparse_amg"] = counts()
    t0 = time.perf_counter()
    runs1, warm1, seg["class1"] = phase_class1(dev)
    emit("class1", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    zero_counts()
    runs2, warm2 = phase_class2(dev)
    seg["class2"] = counts()
    emit("class2", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, seg["drivers"] = phase_drivers(dev, warm1, warm2)
    emit("drivers", seconds=time.perf_counter() - t0)
    f64 = {(1,) + k: v for k, v in runs1.items()}
    f64.update({(2,) + k: v for k, v in runs2.items()})
    f64[(2, 500, "once")] = f64[(2, 500, "warm")]
    t0 = time.perf_counter()
    phase_mixed(dev, f64)
    emit("mixed_all", seconds=time.perf_counter() - t0)
    phase_roofline(card, *warm1[:2])
    launches["sparse_setup"], _, seg["sparse_setup"] = phase_sparse_setup(
        card, dev)
    t0 = time.perf_counter()
    phase_cli()
    emit("cli", seconds=time.perf_counter() - t0)

    main_row = rows[("grid128", torch.float64)]
    seg_row = seg_rows["components1000_L500"]
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
        "variant": seg_row["variant"]}]}))
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
