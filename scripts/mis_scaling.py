"""``mis_rounds`` on synthetic strength graphs of growing size.

    python3 scripts/mis_scaling.py [--sizes 500 1024 2048 4096 6144]

On the card, for each size c a graph shaped like the first coarsening
of a Class-1 plan of c x c (``chip_smoke.level1_graph``: every node
active, each pair strongly connected with probability 0.2, symmetric,
no diagonal; the degrees' tie-breaks are ``mis_draws(PRNGKey(c))``)
goes through ``otamg_torch.amg.kernels.mis_rounds`` and its plain
version.
One JSON line a size: rounds, whether the split equals the plain one bit
for bit, ``ms`` (CUDA events around 100 calls), ``device_ms`` (the same
calls replayed from a CUDA graph), whether one captured call's replay
gives the eager split, the plain version's ms, the bound of
``chip_smoke.mis_bound``, and the layout where the package has
``mis_layout``; first a line with the card's name and power limit from
``nvidia-smi``.  Exits nonzero without a card or when a split differs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[500, 1024, 2048, 4096, 6144])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mis_scaling: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from otamg_torch.amg import kernels as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"nvidia_smi": smi, "kind": card,
                      "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    ok = True
    for c in args.sizes:
        g = chip_smoke.level1_graph(c, dev)
        run = lambda: tk.mis_rounds(*g)  # noqa: E731
        k = run()
        p = tk.mis_rounds_plain(*g)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(k, p))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        graph.replay()
        torch.cuda.synchronize()
        captured = all(torch.equal(a, b) for a, b in zip(out, k))
        rounds = int(k[3])
        bound_ms, bound_by = chip_smoke.mis_bound(card, c, rounds)
        row = dict(c=c, active=int(g[1].sum()),
                   strong_per_row=float(g[0].sum()) / c, rounds=rounds,
                   equal_to_plain=equal, captured_equal=captured,
                   ms=chip_smoke.cuda_ms(run),
                   device_ms=chip_smoke.graph_ms(run),
                   plain_ms=chip_smoke.cuda_ms(
                       lambda: tk.mis_rounds_plain(*g), 5),
                   bound_ms=bound_ms, bound_by=bound_by)
        if hasattr(tk, "mis_layout"):
            row.update(zip(("layout", "blocks"),
                           tk.mis_layout(c)[:2]))
        print(json.dumps(row), flush=True)
        ok &= equal and captured
        del g, k, p, out, graph
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
