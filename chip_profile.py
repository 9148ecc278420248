"""Where the time of one warm Class-1 or Class-2 solve goes on the card.

    python3 chip_profile.py [--class2] [--size 500] [--outer 10]
                            [--solve-dtype float32] [--out TABLE.txt]

Runs ``otamg_torch``'s ``solve_class1`` (AMG inner solver, F-cycle,
fuse_deep, f64) on ``random_class1(PRNGKey(0), size, size)``, or with
``--class2`` ``solve_class2`` on ``random_class2(PRNGKey(0), size,
size)`` with ``chip_smoke.py``'s Class-2 options (with ``--solve-dtype
float32`` the Newton solves run the mixed-precision configuration), once
whole to warm up,
then profiles the first ``--outer`` outer iterations of the same solve
under ``torch.profiler`` (a whole solve launches ~1e6 kernels, whose
trace takes the profiler minutes to digest).  Prints one JSON line: the
card (``nvidia-smi`` name and power limit), the whole warm-up solve's
outcome and seconds, the window's wall seconds, the device's busy time
(the union of kernel intervals), its idle share, the kernel launches and
host reads per outer iteration, the mixed path's refinement rounds and
reverted rounds in the window, and the operators with the most device
time.  With ``--out`` the profiler's full table is written to that file.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch


def busy_us(events) -> float:
    """Union of the device kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--outer", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--class2", action="store_true")
    ap.add_argument("--solve-dtype", default=None, choices=["float32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from otamg_torch.device import fetch
    from otamg_torch.hybrid.solver import refine_counts
    from otamg_torch.opt import solve_class1, solve_class2
    from otamg_torch.ot import random_class1, random_class2
    from otamg_torch.random import PRNGKey

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.class2:
        opts, solve = chip_smoke.class2_opts(args.solve_dtype), solve_class2
        prob = random_class2(PRNGKey(0), args.size, args.size, device="cuda")
    else:
        opts, solve = chip_smoke.class1_opts(args.solve_dtype), solve_class1
        prob = random_class1(PRNGKey(0), args.size, args.size, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = solve(prob, opts)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    window = dataclasses.replace(opts, maxit=args.outer)
    torch.cuda.synchronize()
    reads0 = fetch.reads
    refine_counts.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(prob, window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    reads = fetch.reads - reads0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(kernels) / 1e6
    averages = prof.key_averages()
    top = sorted(averages, key=lambda a: -a.self_device_time_total)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(averages.table(sort_by="self_device_time_total",
                                      row_limit=40))
    print(json.dumps({
        "class": 2 if args.class2 else 1, "size": args.size,
        "solve_dtype": args.solve_dtype,
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "full_solve": {
            "converged": full.converged, "iters": full.iters,
            "fail_count": full.fail_count, "fxk": float(full.fxk[-1]),
            "polished": getattr(full, "polished", False),
            "inner_total": full.inner_total, "seconds": full_s},
        "outer_iters_profiled": res.iters,
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "kernel_launches": len(kernels),
        "launches_per_outer_iter": len(kernels) / res.iters,
        "host_reads_per_outer_iter": reads / res.iters,
        "refine_rounds": refine_counts.rounds,
        "reverted_rounds": refine_counts.reverted,
        "newton_solves": refine_counts.solves,
        "top_ops_self_device_ms": [
            [a.key, a.self_device_time_total / 1e3, a.count]
            for a in top[:12]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
