"""Where the coarsest eigendecomposition kernel spends its time, by phase.

    python3 scripts/eigh_phase_profile.py

On the card, builds ``otamg_torch/csrc/coarse_eigh.cu`` with
``-DEIGH_STAMPS`` (thread 0 reads ``clock64()`` after each phase's
barrier) into ``otamg_torch/_build/libcoarse_eigh_phases.so`` (the
port's own library is not touched), and for
the coarsest levels of the first Newton solve of Class 1 at 500x500 and
1024x1024 (one-iteration loop-driver solves, as ``chip_smoke.py``'s
setup checks record them) and random symmetric matrices at n = 64,
128, 191 and 400, in f64 and f32, prints one JSON line: the call's ms
(CUDA events, one warm call), the SM clock the stamps imply, and the
microseconds of each phase (tridiagonalisation, splitting,
multisection, shifts and ranks, inverse iteration, clusters,
back-transformation).  Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import struct
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("tridiagonalise", "split", "multisection", "shifts_ranks",
          "inverse_iteration", "clusters", "back_transform")


def build():
    """The kernel built with ``-DEIGH_STAMPS``: its C entry point, which
    takes the stamps' address as args[11]."""
    from otamg_torch import cuda_build

    cuda_build.BUILD.mkdir(exist_ok=True)
    lib = cuda_build.BUILD / "libcoarse_eigh_phases.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DEIGH_STAMPS", "-o", str(lib),
                    str(ROOT / "otamg_torch/csrc/coarse_eigh.cu")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).coarse_eigh_launch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def coarsest_levels(dev):
    """The coarsest level's matrix of the first Newton solve's setup at
    Class-1 500^2 and 1024^2 (``chip_smoke.Recorder``)."""
    import dataclasses

    import chip_smoke

    out = []
    for size in (500, 1024):
        with chip_smoke.Recorder() as rec:
            chip_smoke.run_class1(size, size, dev, dataclasses.replace(
                chip_smoke.class1_opts(), maxit=1))
        out += [(f"class1_{size}_coarsest", A) for A in rec.eigh.values()]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("eigh_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    from otamg_torch.amg import kernels as tk

    fn = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    mats = coarsest_levels(dev)
    for n in (64, 128, 191, 400):
        B = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
        mats.append((f"random{n}", 0.5 * (B + B.T)))
    for name, A0 in mats:
        for dtype in (torch.float64, torch.float32):
            A = A0.to(dtype).contiguous()
            n = A.shape[0]
            layout, smem, nws = tk.eigh_layout(n, A.element_size())
            lam, V = A.new_empty(n), A.new_empty(n, n)
            info = torch.empty((), dtype=torch.int32, device=dev)
            ws = A.new_empty(nws)
            st = torch.zeros(8, dtype=torch.int64, device=dev)
            args = struct.pack(
                "=12q", A.data_ptr(), lam.data_ptr(), V.data_ptr(),
                info.data_ptr(), n, tk._CODE[dtype], smem,
                torch.cuda.current_stream().cuda_stream, 0, ws.data_ptr(),
                layout, st.data_ptr())
            if fn(args) != 0:
                raise RuntimeError("launch failed")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(args)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            s = st.tolist()
            total = s[7] - s[0]
            us = {p: (s[i + 1] - s[i]) / total * ms * 1e3
                  for i, p in enumerate(PHASES)}
            print(json.dumps(dict(
                matrix=name, n=n, dtype=str(dtype).split(".")[-1],
                layout=layout, info=int(info), ms=ms,
                sm_ghz=total / (ms * 1e-3) / 1e9, phase_us=us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
