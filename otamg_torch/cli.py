"""Command-line driver of the port (port of ``otamg/cli.py``).

Usage::

    python -m otamg_torch.cli class1 [--mat PATH | --m M --n N] [--inner amg]
    python -m otamg_torch.cli class2 [--mat PATH | --m M --n N] [--mu-frac F]
    python -m otamg_torch.cli info

The same subcommands, flags and report as the JAX package's CLI: the
solve's ``solver_report`` as one JSON line on stdout, per-iteration
records to ``--log`` (JSONL), the diagnostic panels to ``--plot`` (PNG),
and exit code 0 if the solve converged.  The solve runs on CUDA unless
``--device cpu`` is given; without a card the CLI exits nonzero rather
than run on the CPU.  ``--driver`` picks the loop, chunked (``--chunk``
iterations a read) or fused driver, all on one trajectory; the
multi-process flags of the JAX CLI are not offered.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def _common(sub):
    sub.add_argument("--mat", help=".mat fixture path (reference format)")
    sub.add_argument("--m", type=int, default=128)
    sub.add_argument("--n", type=int, default=128)
    sub.add_argument("--inner", default="amg",
                     choices=["direct", "pcg", "aug_pcg", "amg", "twogrid"])
    sub.add_argument("--maxit", type=int, default=100)
    sub.add_argument("--kkt-tol", type=float, default=1e-6)
    sub.add_argument("--seed", type=int, default=0)
    sub.add_argument("--cycle", default="w", choices=["v", "w", "f"],
                     help="AMG cycle: w = reference W-cycle (default), "
                          "v = V-cycle, f = F-cycle (W's revisit "
                          "structure with V revisits)")
    sub.add_argument("--fp32", action="store_true",
                     help="fp32 plan storage (the dual state stays f64)")
    sub.add_argument("--solve-dtype", default=None,
                     choices=["float32", "float64"],
                     help="dtype of the Newton solves; float32 selects the "
                          "mixed path (fp32 AMG hierarchy, f64 "
                          "refinement).  Default: the plan's dtype (f64) on "
                          "every device.  The JAX CLI picks float32 on an "
                          "accelerator because the TPU emulates f64; on "
                          "the H100 the mixed path measured 1.10-2.08x "
                          "slower than f64 (PERF.md, Findings)")
    sub.add_argument("--driver", default="loop",
                     choices=["loop", "chunked", "fused"],
                     help="outer-loop driver, all on one trajectory: loop "
                          "(every loop exit one host read, metrics read "
                          "each iteration), chunked (loop exits read once "
                          "per block of --chunk tests, the AMG cycles of a "
                          "block one CUDA graph, records read once per "
                          "--chunk iterations, checkpoints at chunk "
                          "boundaries) or fused (blocks of 8, records read "
                          "once per solve, no checkpoints)")
    sub.add_argument("--chunk", type=int, default=8,
                     help="iterations per records read, and tests per loop "
                          "exit read, for --driver chunked")
    sub.add_argument("--device", default="cuda",
                     help="device of the solve (default cuda; cpu runs "
                          "on the CPU)")
    sub.add_argument("--log", help="JSONL per-iteration record path")
    sub.add_argument("--plot", help="PNG plot prefix")
    sub.add_argument("--checkpoint", help="checkpoint directory (.npz)")
    sub.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint in "
                          "--checkpoint")
    sub.add_argument("--verbose", "-v", action="store_true")
    sub.add_argument("--feas-polish", action="store_true",
                     help="class2: enable the feasibility-polish tail "
                          "safeguard (projection onto {Hu=b} when only "
                          "the feasibility residual stalls)")
    sub.add_argument("--profile",
                     help="write a torch.profiler Chrome trace of the solve "
                          "into this directory (view in Perfetto)")


def _dtype(args):
    import torch

    return torch.float32 if args.fp32 else torch.float64


def _opts(args, class2=False):
    from otamg_torch.config import AMGOptions, APDOptions, Cycle, InnerSolver

    inner = InnerSolver[args.inner.upper()]
    ssn_tol1 = 1e-10 if class2 else 1e-11
    if args.fp32:
        ssn_tol1 = max(ssn_tol1, 1e-7)  # fp32-storage floor
    cycle = Cycle[args.cycle.upper()]
    # Class-2 AMG budget: maxit 40, smoth 10 (Class2/APD_SsN_Class2.m:80-81)
    amg = (AMGOptions(maxit=40, smoth=10, cycle=cycle) if class2
           else AMGOptions(cycle=cycle))
    return APDOptions(maxit=args.maxit, kkt_tol=args.kkt_tol,
                      inner_solver=inner, ssn_tol1=ssn_tol1,
                      seed=args.seed, solve_dtype=args.solve_dtype, amg=amg,
                      feas_polish=args.feas_polish)


def _maybe_profile(args):
    """``--profile DIR``: a torch.profiler trace around the solve."""
    if not args.profile:
        return contextlib.nullcontext()
    from otamg_torch.diag.profiling import trace

    print(f"profiling to {args.profile}", file=sys.stderr)
    return trace(args.profile)


def _report(args, res, records) -> None:
    from otamg_torch.diag.metrics import RunLog, plot_run, solver_report

    print(json.dumps(solver_report(res)))
    if args.log:
        log = RunLog(args.log)
        for rec in records:
            log.log(**rec)
        log.close()
    if args.plot:
        for p in plot_run(res, args.plot):
            print(f"wrote {p}", file=sys.stderr)


def _warn_fused_checkpoint(args) -> None:
    if args.checkpoint and args.driver == "fused":
        print("warning: --checkpoint is ignored with --driver fused (the "
              "whole solve is one device program); use loop (per-"
              "iteration) or chunked (per-chunk)", file=sys.stderr)


def cmd_class1(args) -> int:
    from otamg_torch.opt import (solve_class1, solve_class1_chunked,
                                 solve_class1_fused)
    from otamg_torch.ot import load_class1_mat, random_class1
    from otamg_torch.random import PRNGKey

    if args.mat:
        prob = load_class1_mat(args.mat, dtype=_dtype(args), device=args.dev)
    else:
        prob = random_class1(PRNGKey(args.seed), args.m, args.n,
                             dtype=_dtype(args), device=args.dev)
    _warn_fused_checkpoint(args)
    with _maybe_profile(args):
        if args.driver == "chunked":
            res = solve_class1_chunked(prob, _opts(args), chunk=args.chunk,
                                       verbose=args.verbose,
                                       checkpoint_dir=args.checkpoint,
                                       resume=args.resume)
        elif args.driver == "fused":
            res = solve_class1_fused(prob, _opts(args))
        else:
            res = solve_class1(prob, _opts(args), verbose=args.verbose,
                               checkpoint_dir=args.checkpoint,
                               resume=args.resume)
    _report(args, res, (dict(it=k, kkt_x=float(res.kkt_x[k]),
                             kkt_l=float(res.kkt_l[k]),
                             fxk=float(res.fxk[k]))
                        for k in range(len(res.kkt_x))))
    if args.checkpoint:
        from otamg_torch.diag.checkpoint import save_result

        save_result(args.checkpoint, res)
    return 0 if res.converged else 1


def cmd_class2(args) -> int:
    from otamg_torch.opt.apd2 import (solve_class2, solve_class2_chunked,
                                      solve_class2_fused)
    from otamg_torch.ot import load_class2_mat, random_class2
    from otamg_torch.random import PRNGKey

    if args.mat:
        prob = load_class2_mat(args.mat, dtype=_dtype(args), device=args.dev)
    else:
        prob = random_class2(PRNGKey(args.seed), args.m, args.n,
                             dtype=_dtype(args), mu_frac=args.mu_frac,
                             device=args.dev)
    _warn_fused_checkpoint(args)
    with _maybe_profile(args):
        if args.driver == "chunked":
            res = solve_class2_chunked(prob, _opts(args, class2=True),
                                       chunk=args.chunk,
                                       verbose=args.verbose,
                                       checkpoint_dir=args.checkpoint,
                                       resume=args.resume)
        elif args.driver == "fused":
            res = solve_class2_fused(prob, _opts(args, class2=True))
        else:
            res = solve_class2(prob, _opts(args, class2=True),
                               verbose=args.verbose,
                               checkpoint_dir=args.checkpoint,
                               resume=args.resume)
    _report(args, res, (dict(it=k, kkt_x=float(res.kkt[k, 0]),
                             kkt_y=float(res.kkt[k, 1]),
                             kkt_z=float(res.kkt[k, 2]),
                             kkt_l=float(res.kkt[k, 3]),
                             fxk=float(res.fxk[k]))
                        for k in range(res.kkt.shape[0])))
    return 0 if res.converged else 1


def cmd_info(args) -> int:
    """Versions, devices and whether the CUDA kernels are built (no
    build is started)."""
    import torch

    import otamg_torch
    from otamg_torch import cuda_build

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": otamg_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "kernels_built": not cuda_build.stale(),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="otamg_torch")
    subs = ap.add_subparsers(dest="cmd", required=True)
    s1 = subs.add_parser("class1", help="OT / assignment / capacitated")
    _common(s1)
    s2 = subs.add_parser("class2", help="partial OT")
    _common(s2)
    s2.add_argument("--mu-frac", type=float, default=0.6)
    subs.add_parser("info", help="environment report")
    args = ap.parse_args(argv)
    if args.cmd != "info":
        from otamg_torch.device import resolve

        # CUDA unless the caller names another device; no fallback.
        try:
            args.dev = resolve(None if args.device == "cuda"
                               else args.device)
        except RuntimeError as exc:
            print(f"otamg_torch: {exc}", file=sys.stderr)
            return 2
    return {"class1": cmd_class1, "class2": cmd_class2,
            "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
