"""Time every variant of the ELL SpMV kernel at the shapes that set
``otamg_torch.sparse.kernels.plan``'s cap boundaries.

    python3 ell_spmv_sweep.py [--out chiprun_out/ell_spmv_sweep.jsonl]

Builds ``otamg_torch/csrc/ell_spmv.cu``, then for f32 and f64 and each
shape runs every variant (``slab1``, ``slab4`` and ``warp``), holds it against ``ell_spmv_plain`` and prints one JSON
line: the variant, its device time per call (CUDA graph replay,
``chip_smoke.graph_ms``), its time per call with the host in the loop
(``chip_smoke.cuda_ms``), the bound, and the ``torch.sparse_csr @ x``
call's time beside it, and the share of the bound the device time
reaches.  The variant ``plan`` picks is marked ``planned``.

Back-to-back calls on one operator find whatever of it fits in the 50 MB
L2 still there.  So for every shape of at least 16 MB the planned variant
and the library call are also timed ``cold``, cycling through enough
copies of the operator (at least 256 MB in all) that each call finds its
own copy evicted: the kernel by graph replay (``cold_device_ms``) and by
events (``cold_ms``), the library call by events (``cold_library_ms``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import sys

import torch

import chip_smoke

COLD_BYTES = 256e6


def shapes(dtype, dev, gen):
    yield from chip_smoke.kernel_shapes(dtype, dev, gen)
    for cap in (9, 16, 64, 99):
        yield (f"random{cap}", *chip_smoke.random_ell(65536, cap, dtype,
                                                      dev, gen),
               torch.randn(65536, generator=gen, device=dev, dtype=dtype))


def cycled(fns):
    """One callable that calls ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/ell_spmv_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ell_spmv_sweep: no CUDA device", file=sys.stderr)
        return 1
    from otamg_torch import cuda_build
    from otamg_torch.sparse.kernels import VARIANTS, WARP, _launch, plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    cuda_build.build_all(verbose=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for name, cols, vals, x in shapes(dtype, dev, gen):
            N, cap = cols.shape
            bound_ms, _, nbytes = chip_smoke.spmv_bound(card, cols, vals, x)
            lib = chip_smoke.library_csr(cols, vals, x.shape[0])
            library_ms = chip_smoke.cuda_ms(lambda: lib @ x)
            for code in [g for g in (1, 4) if cap <= 32] + [WARP]:
                def run(code=code):
                    return _launch(cols, vals, x, code)

                y = run()
                torch.cuda.synchronize()
                err = chip_smoke.held_to_plain(f"{name}/{VARIANTS[code]}", y,
                                               cols, vals, x, rtol)
                row = dict(
                    shape=name, N=N, cap=cap,
                    dtype=str(dtype).split(".")[-1],
                    variant=VARIANTS[code], planned=code == plan(cap),
                    device_ms=chip_smoke.graph_ms(run),
                    ms=chip_smoke.cuda_ms(run), bound_ms=bound_ms,
                    library_ms=library_ms, max_abs_err=err)
                row["device_share_of_bound"] = bound_ms / row["device_ms"]
                if row["planned"] and nbytes >= 16e6 and \
                        cols.storage_offset() == 0:
                    copies = [(cols.clone(), vals.clone(), x.clone())
                              for _ in range(int(-(-COLD_BYTES // nbytes)))]
                    libs = [(chip_smoke.library_csr(c, v, x.shape[0]), xx)
                            for c, v, xx in copies]
                    row["cold_copies"] = len(copies)
                    kernel_call = cycled(
                        [lambda c=c, v=v, xx=xx: _launch(c, v, xx, code)
                         for c, v, xx in copies])
                    row["cold_device_ms"] = chip_smoke.graph_ms(kernel_call)
                    row["cold_ms"] = chip_smoke.cuda_ms(kernel_call)
                    row["cold_library_ms"] = chip_smoke.cuda_ms(cycled(
                        [lambda m=m, xx=xx: m @ xx for m, xx in libs]))
                    row["cold_device_share_of_bound"] = (
                        bound_ms / row["cold_device_ms"])
                    del copies, libs
                lines.append(json.dumps(row))
                print(lines[-1], flush=True)
    out.write_text("\n".join(lines) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
