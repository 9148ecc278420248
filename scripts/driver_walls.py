"""Warm wall seconds of the APD drivers on the card, to compare two trees
on one card in turns.

    PYTHONPATH=TREE python3 scripts/driver_walls.py [--size 500] [--class2]
        [--drivers loop,chunked,fused] [--reps 1]
        [--solve-dtype float64,float32]

Solves ``random_class1(PRNGKey(0), size, size)`` (``--class2``:
``random_class2``) with ``chip_smoke.py``'s options through each driver
(chunked: ``chunk=8``) and each Newton-solve dtype of ``--solve-dtype``
(``float64``: the problem's, f64; ``float32``: the mixed path, fp32
hierarchy and f64 refinement), in turns by driver, once to warm up
(kernel builds, graph captures) and then ``--reps`` times, each timed by
the host clock around the solve and a ``torch.cuda.synchronize()``.  ``otamg_torch`` is imported from
``sys.path``, so ``PYTHONPATH`` names the tree that is timed.  Prints one
JSON line: the card (``nvidia-smi`` name and power limit), the package's
path, and per driver (``driver`` for f64, ``driver/float32`` for mixed)
its walls, iterations, SsN steps and last objective.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.append(str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--class2", action="store_true")
    ap.add_argument("--drivers", default="loop,chunked,fused")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--solve-dtype", default="float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("driver_walls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import otamg_torch
    from otamg_torch import opt
    from otamg_torch.ot import random_class1, random_class2
    from otamg_torch.random import PRNGKey

    if args.class2:
        make, options = random_class2, chip_smoke.class2_opts
        solves = dict(loop=opt.solve_class2, fused=opt.solve_class2_fused,
                      chunked=lambda p, o: opt.solve_class2_chunked(
                          p, o, chunk=8))
    else:
        make, options = random_class1, chip_smoke.class1_opts
        solves = dict(loop=opt.solve_class1, fused=opt.solve_class1_fused,
                      chunked=lambda p, o: opt.solve_class1_chunked(
                          p, o, chunk=8))
    prob = make(PRNGKey(0), args.size, args.size, device="cuda")
    out = {}
    for name in args.drivers.split(","):
        for dtype in args.solve_dtype.split(","):
            opts = options(None if dtype == "float64" else dtype)
            walls = []
            for _ in range(args.reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solves[name](prob, opts)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            key = name if dtype == "float64" else f"{name}/{dtype}"
            out[key] = dict(warmup_s=walls[0], walls_s=walls[1:],
                            iters=res.iters, ssn=int(res.ssn_itnum.sum()),
                            fxk=float(res.fxk[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "package": otamg_torch.__file__,
                      "class": 2 if args.class2 else 1, "size": args.size,
                      "drivers": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
