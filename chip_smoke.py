"""Drive the PyTorch/CUDA port (``otamg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and seconds:

1. device   — the card's name and power limit (from ``nvidia-smi``);
2. build    — compile every CUDA kernel of ``otamg_torch/csrc``;
3. kernel   — ``ell_spmv`` against ``ell_spmv_plain`` on the card at
   three shapes, f32 and f64, with its time (median of 20 calls, CUDA
   events), its bound, the plain version's time and one
   ``torch.sparse_csr_tensor @ x`` call as a yardstick;
4. sparse   — ``amg_solve_matrix`` on the 128x128 grid Laplacian + 0.01 I
   as an ELL ``CSR`` (the path that runs the kernel), with its launches,
   checked against the same solve through the plain SpMV;
5. class1   — ``solve_class1`` (AMG inner solver, F-cycle, fuse_deep):
   a 24x20 problem checked against ``scipy.optimize.linprog`` and against
   the port on the CPU, then 500x500 (one cold and two warm runs) and
   1024x1024 once, with the host reads per outer iteration.

Then one JSON line listing every kernel, and the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits nonzero;
without CUDA the script exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 20
# Device memory bandwidth (bytes/s) and non-tensor-core FP64/FP32 peaks
# (FLOP/s) from NVIDIA's data sheets, by the name nvidia-smi reports.
_HBM = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
_PEAK = {torch.float64: 34e12, torch.float32: 67e12}


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def hbm_rate(name: str) -> float:
    for tag, rate in _HBM:
        if tag in name:
            return rate
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def library_csr(cols, vals, n):
    """The same operator as a torch sparse CSR tensor (out-of-range
    slots dropped), for the yardstick call only."""
    valid = (cols >= 0) & (cols < n)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=cols.device),
                      torch.cumsum(valid.sum(1), 0)])
    return torch.sparse_csr_tensor(crow, cols[valid].long(), vals[valid],
                                   size=(cols.shape[0], n),
                                   check_invariants=False)


def check_kernel(name, card, cols, vals, x, rtol):
    """``ell_spmv`` against its plain version on the same inputs; the
    error is held against the row sums of absolute terms."""
    from otamg_torch.sparse import ell_spmv, ell_spmv_plain

    y = ell_spmv(cols, vals, x)
    torch.cuda.synchronize()
    yp = ell_spmv_plain(cols, vals, x)
    scale = ell_spmv_plain(cols, vals.abs(), x.abs())
    err = (y - yp).abs()
    bad = int((err > rtol * scale + 1e-300).sum())
    if bad or not torch.isfinite(y).all():
        raise AssertionError(f"ell_spmv {name}: {bad} rows differ from the "
                             f"plain version beyond rtol {rtol}")
    N, cap = cols.shape
    n = x.shape[0]
    s = vals.element_size()
    nbytes = N * cap * (4 + s) + N * s + n * s
    flops = 2 * N * cap
    bound_ms = max(nbytes / hbm_rate(card), flops / _PEAK[vals.dtype]) * 1e3
    lib = library_csr(cols, vals, n)
    row = dict(
        shape=name, N=N, cap=cap, n=n, dtype=str(vals.dtype).split(".")[-1],
        rtol=rtol, max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: ell_spmv(cols, vals, x)),
        plain_ms=cuda_ms(lambda: ell_spmv_plain(cols, vals, x)),
        library_ms=cuda_ms(lambda: lib @ x), bound_ms=bound_ms,
        bound_by=("bytes" if nbytes / hbm_rate(card)
                  >= flops / _PEAK[vals.dtype] else "operations"),
        bytes=nbytes)
    emit("kernel", **row)
    return row


def phase_kernels(card, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for nx in (128, 1024):
            A = grid_csr(nx, 0.01, dtype, dev)
            x = torch.randn(nx * nx, generator=gen, device=dev, dtype=dtype)
            rows[(nx * nx, 5, dtype)] = check_kernel(
                f"grid{nx}", card, A.ell_cols, A.ell_vals, x, rtol)
        N, cap = 65536, 200
        cols = torch.randint(-64, N + 64, (N, cap), generator=gen,
                             device=dev, dtype=torch.int32)
        vals = torch.randn(N, cap, generator=gen, device=dev, dtype=dtype)
        x = torch.randn(N, generator=gen, device=dev, dtype=dtype)
        if not ((cols < 0).any() and (cols >= N).any()):
            raise AssertionError("random columns hold no out-of-range slot")
        rows[(N, cap, dtype)] = check_kernel("random200", card, cols, vals,
                                             x, rtol)
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
    opts = AMGOptions(maxit=100)
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
    emit("sparse_amg", N=nx * nx, iters=res.iters, rel_res=rel,
         true_rel_res=true_rel, plain_iters=ref.iters, x_rel_vs_plain=dx,
         seconds=secs, ell_spmv_launches=launches)
    if dx > 1e-8 or ref.iters != res.iters:
        raise AssertionError(f"kernel and plain solves differ: {dx:.2e}")
    if not rel <= SPARSE_REL_RES:
        raise AssertionError(f"sparse-AMG rel_res {rel:.3e} above "
                             f"{SPARSE_REL_RES:.0e}")
    return launches


# The generic (bigph=0) hierarchy with default options does not reach 1e-6
# in 100 iterations on the 2-D grid Laplacian: the JAX package on the CPU
# reaches 1.18e-3 on the 64x64 grid with the same options, and the port
# the same.  The 128x128 solve must do at least as well (see PERF.md).
SPARSE_REL_RES = 1.2e-3


def class1_opts():
    from otamg_torch.config import AMGOptions, APDOptions, Cycle, InnerSolver

    return APDOptions(inner_solver=InnerSolver.AMG,
                      amg=AMGOptions(cycle=Cycle.F, fuse_deep=True))


def run_class1(m, n, dev, opts):
    from otamg_torch.device import fetch
    from otamg_torch.opt import solve_class1
    from otamg_torch.ot import random_class1
    from otamg_torch.random import PRNGKey

    prob = random_class1(PRNGKey(0), m, n, device=dev)
    torch.cuda.synchronize()
    reads0 = fetch.reads
    t0 = time.perf_counter()
    res = solve_class1(prob, opts)
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
    runs = []
    for label in ("cold", "warm", "warm"):
        res, secs, reads = run_class1(500, 500, dev, opts)
        if not res.converged:
            raise AssertionError(f"500x500 {label} run did not converge")
        runs.append(secs)
        emit("class1_500", run=label, iters=res.iters,
             fail_count=res.fail_count, fxk=float(res.fxk[-1]),
             seconds=secs, host_reads_per_outer_iter=reads,
             inner_total=res.inner_total)
    res, secs, reads = run_class1(1024, 1024, dev, opts)
    emit("class1_1024", iters=res.iters, fail_count=res.fail_count,
         converged=res.converged, fxk=float(res.fxk[-1]), seconds=secs,
         host_reads_per_outer_iter=reads, inner_total=res.inner_total)
    if not res.converged:
        raise AssertionError("1024x1024 run did not converge")
    return runs


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

    t0 = time.perf_counter()
    rows = phase_kernels(card, dev)
    emit("kernel_checks", seconds=time.perf_counter() - t0)
    launches = phase_sparse_amg(dev)
    phase_class1(dev)

    main_row = rows[(128 * 128, 5, torch.float64)]
    print(json.dumps({"kernels": [{
        "name": "ell_spmv", "route": "cuda",
        "source": "otamg_torch/csrc/ell_spmv.cu",
        "replaces": "otamg/sparse/kernels.py:40",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
