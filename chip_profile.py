"""Where the time of one warm Class-1 or Class-2 solve goes on the card.

    python3 chip_profile.py [--class2] [--size 500] [--outer 10]
                            [--solve-dtype float32] [--out TABLE.txt]
                            [--driver loop|chunked|fused] [--chunk 8]
    python3 chip_profile.py --sparse-setup 1048576

Runs ``otamg_torch``'s ``solve_class1`` (AMG inner solver, F-cycle,
fuse_deep, f64) on ``random_class1(PRNGKey(0), size, size)``, or with
``--class2`` ``solve_class2`` on ``random_class2(PRNGKey(0), size,
size)`` with ``chip_smoke.py``'s Class-2 options (with ``--solve-dtype
float32`` the Newton solves run the mixed-precision configuration;
``--driver`` picks the loop, chunked or fused driver), once whole to
warm up, then profiles the first ``--outer`` outer iterations of the
same solve under ``torch.profiler`` (a whole solve launches ~1e6
kernels, whose trace takes the profiler minutes to digest).  Prints one
JSON line: the card (``nvidia-smi`` name and power limit), the whole
warm-up solve's outcome and seconds, the window's wall seconds, the
device's busy time (the union of kernel intervals), its idle share, the
kernel launches and host reads per outer iteration, the mixed path's
refinement rounds and reverted rounds in the window, the operators with
the most device time, and ``layers``: per layer of the solve, its
launches (kernel and graph launches as the host issues them), host
microseconds, device microseconds and host reads, each per outer
iteration and exclusive of the layers nested in it.

The layers are ``torch.profiler.record_function`` ranges that this
script installs by wrapping the package's module-level functions where
the calling modules look them up (the package itself has no ranges):
``_transform``, ``_component_info``, ``label_propagation``
(``connected_components_bipartite``), ``setup_hierarchy`` (MIS,
coarsening, ``eigh``), ``deep_matrix`` (``build_deep``), ``amg_solve``,
``he_solve`` (the guess draw and, mixed, the refinement rounds around
the correction solves), ``build_he_solver`` (the rest of a Newton
system's set-up), ``merit`` (the Armijo merit), ``outer_step`` (the rest
of the SsN step and the outer step) and ``driver`` (the rest).  A launch
belongs to the innermost range open on the host when it is issued, and
a kernel's device time to its launch (by the profiler's correlation
id).  With ``--sparse-setup N`` the script profiles ``chip_smoke.py``'s
sparse-setup solve at ``N`` rows instead (one warm-up run first), with
the ranges ``setup_hierarchy_sparse``, ``amg_solve``, ``smoother``,
``coarse_solve`` and ``ell_spmv``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch


def busy_us(events) -> float:
    """Union of the device kernel intervals, in microseconds (the caller
    leaves out the device spans the profiler draws for host ranges)."""
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


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
COPIES = ("cudaMemcpyAsync", "cudaMemsetAsync")

# (module, attribute, range): the functions wrapped in a range, where
# their callers look them up.
SOLVE_LAYERS = (
    ("otamg_torch.hybrid.solver", "_transform", "_transform"),
    ("otamg_torch.hybrid.solver", "_component_info", "_component_info"),
    ("otamg_torch.hybrid.solver", "connected_components_bipartite",
     "label_propagation"),
    ("otamg_torch.hybrid.solver", "setup_hierarchy", "setup_hierarchy"),
    ("otamg_torch.hybrid.solver", "amg_solve", "amg_solve"),
    ("otamg_torch.opt.apd", "_merit", "merit"),
    ("otamg_torch.opt.apd2", "_merit2", "merit"),
)
SPARSE_LAYERS = (
    ("otamg_torch.amg.hierarchy", "_projected_smooth", "smoother"),
    ("otamg_torch.amg.hierarchy", "_coarse_solve", "coarse_solve"),
    ("otamg_torch.amg.hierarchy", "ell_spmv", "ell_spmv"),
)
# Reads of each module's loop exits.
FETCH_USERS = ("otamg_torch.amg.graph", "otamg_torch.amg.hierarchy",
               "otamg_torch.hybrid.solver", "otamg_torch.opt.apd",
               "otamg_torch.opt.apd2")


class Layers:
    """Installs the ranges; counts host reads by innermost range."""

    def __init__(self):
        self.stack = ["driver"]
        self.reads = collections.Counter()
        self.saved = []

    def ranged(self, name, fn):
        layers = self

        def wrapped(*a, **kw):
            layers.stack.append(name)
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                layers.stack.pop()

        return wrapped

    def patch(self, modname, attr, new):
        mod = importlib.import_module(modname)
        self.saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    def install(self, table):
        for modname, attr, name in table:
            fn = getattr(importlib.import_module(modname), attr, None)
            if fn is not None:
                self.patch(modname, attr, self.ranged(name, fn))

    def install_solve(self):
        self.install(SOLVE_LAYERS)
        from otamg_torch.amg import hierarchy
        from otamg_torch.hybrid import pot, solver
        from otamg_torch.opt import apd, apd2

        make_cycle = hierarchy.make_cycle

        def cycle_with_ranges(*a, **kw):
            cyc = make_cycle(*a, **kw)
            cyc.build_deep = self.ranged("deep_matrix", cyc.build_deep)
            return cyc

        self.patch("otamg_torch.amg.hierarchy", "make_cycle",
                   cycle_with_ranges)
        for mod in (solver, pot):
            build = mod.build_he_solver

            def build_ranged(*a, _build=build, **kw):
                he_solve, ncomp, last = _build(*a, **kw)
                return self.ranged("he_solve", he_solve), ncomp, last

            self.patch(mod.__name__, "build_he_solver",
                       self.ranged("build_he_solver", build_ranged))
        for mod, attr in ((apd, "make_class1_step"),
                          (apd2, "make_class2_step")):
            def make_ranged(*a, _make=getattr(mod, attr), **kw):
                return self.ranged("outer_step", _make(*a, **kw))

            self.patch(mod.__name__, attr, make_ranged)

    def install_fetch(self):
        from otamg_torch.device import fetch

        def counted(x):
            self.reads[self.stack[-1]] += 1
            return fetch(x)

        for modname in FETCH_USERS:
            self.patch(modname, "fetch", counted)

    def restore(self):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved.clear()


def layer_table(prof, reads, per: float, names) -> dict:
    """Per range: launches, exclusive host and device microseconds and
    host reads, each divided by ``per``; from the profiler's raw events:
    ranges nest on one host thread, so one sweep in time order finds the
    innermost range of each launch, and a kernel's device time goes to
    its launch's range through the correlation id."""
    evs = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges, launches, kernels = [], [], []
    for e in evs:
        if e.device_type() == cpu:
            if e.name() in names:
                ranges.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.name() in LAUNCHES or e.name() in COPIES:
                launches.append((e.start_ns(), e.correlation_id(),
                                 e.name()))
        elif not (e.is_user_annotation() or e.name() in names):
            # A device span of a host range is no kernel.
            kernels.append((e.correlation_id(), e.duration_ns()))
    ranges.sort(key=lambda r: (r[0], -r[1]))
    launches.sort()
    host = collections.Counter()
    nl = collections.Counter()
    graphs = collections.Counter()
    owner = {}
    stack = []   # [end, name, child_ns]
    ri = 0

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, name, child, start = stack.pop()
            host[name] += (end - start) - child
            if stack:
                stack[-1][2] += end - start

    for t, corr, what in launches + [(float("inf"), None, None)]:
        while ri < len(ranges) and ranges[ri][0] <= t:
            close_until(ranges[ri][0])
            stack.append([ranges[ri][1], ranges[ri][2], 0, ranges[ri][0]])
            ri += 1
        close_until(t)
        if corr is None:
            break
        name = stack[-1][1] if stack else "driver"
        owner[corr] = name
        if what in LAUNCHES:
            nl[name] += 1
            graphs[name] += int(what == "cudaGraphLaunch")
    dev = collections.Counter()
    for corr, dur in kernels:
        if corr in owner:
            dev[owner[corr]] += dur
    keys = sorted(set(nl) | set(host) | set(reads) | set(dev),
                  key=lambda k: -nl[k])
    return {k: dict(launches=nl[k] / per, graph_launches=graphs[k] / per,
                    host_us=host[k] / 1e3 / per, device_us=dev[k] / 1e3 / per,
                    host_reads=reads[k] / per) for k in keys}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_sparse_setup(N: int) -> dict:
    """The sparse-setup solve of ``chip_smoke.py`` at ``N`` rows, warm,
    profiled by layer."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    A = chip_smoke.laplacian_1d_csr(N, 0.01, torch.float64, "cuda")
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(N),
                        device="cuda")
    chip_smoke.sparse_setup_solve(A, b)
    layers = Layers()
    layers.install(SPARSE_LAYERS + (
        ("otamg_torch.amg.hierarchy", "setup_hierarchy_sparse",
         "setup_hierarchy_sparse"),
        ("otamg_torch.amg.hierarchy", "amg_solve", "amg_solve")))
    layers.install_fetch()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, res, setup_s, solve_s = chip_smoke.sparse_setup_solve(A, b)
            wall = time.perf_counter() - t0
    finally:
        layers.restore()
    names = {n for *_, n in SPARSE_LAYERS} | {"setup_hierarchy_sparse",
                                              "amg_solve"}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in names]
    busy = busy_us(kernels) / 1e6
    return {"sparse_setup": N, "card": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line(), "cycles": int(res.iters),
            "rel_res": float(res.rel_res), "setup_s": setup_s,
            "solve_s": solve_s, "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "layers_per_cycle": layer_table(prof, layers.reads,
                                            max(int(res.iters), 1), names)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--outer", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--class2", action="store_true")
    ap.add_argument("--solve-dtype", default=None, choices=["float32"])
    ap.add_argument("--driver", default="loop",
                    choices=["loop", "chunked", "fused"])
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--sparse-setup", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.sparse_setup:
        print(json.dumps(profile_sparse_setup(args.sparse_setup)))
        return 0
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from otamg_torch.device import fetch
    from otamg_torch.hybrid.solver import refine_counts
    from otamg_torch.ot import random_class1, random_class2
    from otamg_torch.random import PRNGKey

    smi = smi_line()
    solve = driver(args)
    if args.class2:
        opts = chip_smoke.class2_opts(args.solve_dtype)
        prob = random_class2(PRNGKey(0), args.size, args.size, device="cuda")
    else:
        opts = chip_smoke.class1_opts(args.solve_dtype)
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
    layers = Layers()
    layers.install_solve()
    layers.install_fetch()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = solve(prob, window)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        layers.restore()
    reads = fetch.reads - reads0
    names = {n for *_, n in SOLVE_LAYERS} | {
        "deep_matrix", "he_solve", "build_he_solver", "outer_step"}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in names]
    busy = busy_us(kernels) / 1e6
    averages = prof.key_averages()
    top = sorted((a for a in averages if a.key not in names),
                 key=lambda a: -a.self_device_time_total)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(averages.table(sort_by="self_device_time_total",
                                      row_limit=40))
    print(json.dumps({
        "class": 2 if args.class2 else 1, "size": args.size,
        "solve_dtype": args.solve_dtype, "driver": args.driver,
        "chunk": args.chunk if args.driver == "chunked" else None,
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
        "layers_per_outer_iter": layer_table(prof, layers.reads, res.iters,
                                             names),
        "top_ops_self_device_ms": [
            [a.key, a.self_device_time_total / 1e3, a.count]
            for a in top[:12]]}))
    return 0


def driver(args):
    """``solve(prob, opts)`` of the chosen driver and class."""
    from otamg_torch import opt

    if args.driver == "loop":
        return opt.solve_class2 if args.class2 else opt.solve_class1
    if args.driver == "fused":
        return opt.solve_class2_fused if args.class2 else opt.solve_class1_fused
    chunked = opt.solve_class2_chunked if args.class2 \
        else opt.solve_class1_chunked
    return lambda prob, opts: chunked(prob, opts, chunk=args.chunk)


if __name__ == "__main__":
    sys.exit(main())
