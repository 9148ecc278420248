"""Whether a thread-block-cluster kernel runs inside a conditional node's
body graph on the card.

    python3 scripts/cluster_if_probe.py

Every AMG step of the chunked and fused drivers runs inside the body of
an IF node (``otamg_torch.graphs.when``), so a kernel launched from the
step (the smoother) is captured into that body.  This probe captures
``label_rounds`` (``csrc/labels.cu``: one cluster of 16 blocks, launched
with ``cudaLaunchKernelEx``) inside a ``when`` body, once at depth 1 and
once inside a nested node (depth 2), replays the graph with the
predicates true and false, and compares the labels with the eager call
bit for bit (a skipped body leaves its outputs as they were).  Prints
one JSON line with the card (``nvidia-smi`` name and power limit) and
each case's outcome; exits 1 if a case failed.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_if_probe: no CUDA device", file=sys.stderr)
        return 1
    from otamg_torch import graphs
    from otamg_torch.amg import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    E = torch.where(torch.rand(500, 500, generator=gen) < 0.004,
                    torch.rand(500, 500, generator=gen), 0.0).double()
    E = E.to(dev)
    want, want_rounds = kernels.label_rounds(E)
    out = torch.full_like(want, -7)
    rounds = torch.full_like(want_rounds, -7)
    outer = torch.ones((), dtype=torch.bool, device=dev)
    inner = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        L, r = kernels.label_rounds(E)
        out.copy_(L)
        rounds.copy_(r)

    def nested():
        graphs.when(inner, body, [out, rounds])

    cases = {}
    for name, fn in (("depth1", body), ("depth2", nested)):
        graphs.prepare(dev)
        torch.cuda.synchronize()
        # Warm-up on the capture's side stream, as graphs.Captured does.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graphs.when(outer, fn, [out, rounds])
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        try:
            with graphs.capture(g):
                graphs.when(outer, fn, [out, rounds])
        except RuntimeError as err:
            cases[name] = {"captured": False, "error": str(err)}
            continue
        res = {"captured": True}
        for taken in (True, False):
            out.fill_(-7)
            rounds.fill_(-7)
            outer.fill_(taken)
            launches = kernels.label_rounds.launches
            g.replay()
            torch.cuda.synchronize()
            if taken:
                ok = bool(torch.equal(out, want)) and bool(
                    torch.equal(rounds, want_rounds))
            else:
                ok = bool((out == -7).all()) and int(rounds) == -7
            res["taken" if taken else "skipped"] = ok
            # A replay launches through the graph, not the wrapper.
            res["wrapper_launches_at_replay"] = (
                kernels.label_rounds.launches - launches)
        outer.fill_(True)
        cases[name] = res
        del g
    ok = all(c.get("taken") and c.get("skipped") for c in cases.values())
    print(json.dumps({"probe": "cluster_kernel_in_if_node",
                      "card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "ok": ok, "cases": cases}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
