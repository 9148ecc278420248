"""End-to-end roofline accounting for the OT solves (port of
``otamg/diag/roofline.py``).

A bytes-moved model assembled from the solver's own iteration counters
(outer iterations, SsN steps, AMG cycles) and the static hierarchy
shape, divided by measured wall time.  The model counts the principal
memory traffic:

* **Fine-level smoothing** — the fused bipartite smoother reads ``E``
  twice per sweep (``hierarchy.py::_projected_smooth_bip``); each cycle
  runs 2 phases x ``smoth`` sweeps plus ~2 extra E-passes (residual
  matvec + restriction/prolongation touching E through W).
* **Deep-level traffic** — per cycle, each dense-level visit moves its
  ``cap^2`` operator a fixed number of times; visit counts come from the
  real cycle tape (``hierarchy._gen_tape``).  With ``fuse_deep`` the
  per-cycle deep traffic is one ``cap1^2`` GEMV and the tape is paid
  once per Newton solve (the D build).
* **Setup** — per Newton solve: building ``E`` from the active set,
  ideal interpolation, the Galerkin chain.
* **Outer O(mn) work** — ~8 plan-sized passes per outer iteration and
  ~12 per SsN step.

The model is a principal-traffic lower bound (index arrays, small
vectors and scalar reads are ignored).  The peak it is divided by is the
card's memory bandwidth (:func:`hbm_rate`), never the TPU constant of the
JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Device memory bandwidth (bytes/s) from NVIDIA's data sheets, by a tag
# of the name nvidia-smi and torch.cuda.get_device_name report; the
# first tag found in the name wins.
HBM_BYTES_PER_S = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12),
                   ("H100", 3.35e12))

# O(mn)-pass coefficients (counted from otamg/opt/apd.py).
_OUTER_MN_PASSES = 8
_SSN_MN_PASSES = 12
# Per-visit dense-level operator passes: pre+post smoothing phases read
# A twice per sweep via matvec+apply, plus residual/transfer touches.
_DENSE_VISIT_PASSES = lambda smoth: 2 * smoth * 2 + 4
_FINE_CYCLE_PASSES = lambda smoth: 2 * smoth * 2 + 2


def hbm_rate(name: str) -> float:
    """The memory bandwidth (bytes/s) of the card called ``name``."""
    for tag, rate in HBM_BYTES_PER_S:
        if tag in name:
            return rate
    raise ValueError(f"no memory bandwidth on record for {name!r}")


def _deep_tape_visits(num_dense: int, gamma: int) -> dict[int, int]:
    """Per-dense-level smoothing-visit counts of one cycle, from the
    real tape (level 1..num_dense; the coarsest solve is counted like a
    visit)."""
    from otamg_torch.amg.hierarchy import _gen_tape

    visits: dict[int, int] = {}
    for kind, lvl in _gen_tape(num_dense + 1, gamma):
        if kind in ("pre", "coarse") and lvl >= 1:
            visits[lvl] = visits.get(lvl, 0) + 1
    return visits


def solve_bytes_model(m: int, n: int, iters: int, ssn_total: int,
                      cycles_total: int, smoth: int, gamma: int,
                      caps: Sequence[int], fuse_deep: bool,
                      plan_itemsize: int = 8,
                      solve_itemsize: int = 4) -> float:
    """Modelled device-memory bytes moved by one end-to-end solve.

    ``caps`` is the dense-level capacity schedule
    (``hierarchy.capacity_schedule``); ``cycles_total`` the summed AMG
    cycle count over all Newton solves (``SolveResult.inner_total``);
    ``ssn_total`` the summed SsN iterations (= number of Newton solves,
    each with one setup).
    """
    mn = m * n
    E_bytes = mn * solve_itemsize
    newton_solves = ssn_total

    fine = cycles_total * _FINE_CYCLE_PASSES(smoth) * E_bytes

    visits = _deep_tape_visits(len(caps), gamma)
    tape_bytes = sum(v * _DENSE_VISIT_PASSES(smoth)
                     * caps[l - 1] ** 2 * solve_itemsize
                     for l, v in visits.items())
    if fuse_deep and len(caps) >= 2:
        # One D GEMV per cycle + the algebraic build per Newton solve
        # (~smoth phase-power GEMMs + ~10 composition GEMMs per level).
        build_bytes = ((smoth + 10) * sum(c * c for c in caps)
                       * solve_itemsize)
        deep = (cycles_total * caps[0] ** 2 * solve_itemsize
                + newton_solves * build_bytes)
    else:
        deep = cycles_total * tape_bytes

    # Setup per Newton solve: E assembly from the active set, ideal
    # interpolation + level-2 Galerkin (~4 E passes), deep Galerkin chain
    # (~6 passes over each cap^2) + coarse eigendecomposition.
    setup = newton_solves * (
        (mn * plan_itemsize + 5 * E_bytes)
        + 8 * sum(c * c for c in caps) * solve_itemsize)

    outer = ((iters * _OUTER_MN_PASSES + ssn_total * _SSN_MN_PASSES)
             * mn * plan_itemsize)

    return float(fine + deep + setup + outer)


def roofline_report(model_bytes: float, wall_s: float, peak) -> dict:
    """Achieved GB/s of a measured wall time and its share of the peak.
    ``peak`` is the memory bandwidth in bytes/s, a card's name, or a CUDA
    ``torch.device`` whose name is looked up (:func:`hbm_rate`)."""
    if isinstance(peak, torch.device):
        if peak.type != "cuda":
            raise ValueError(f"no memory bandwidth for a {peak.type} device")
        peak = torch.cuda.get_device_name(peak)
    rate = hbm_rate(peak) if isinstance(peak, str) else float(peak)
    gbps = model_bytes / wall_s / 1e9 if wall_s > 0 else 0.0
    return {"model_bytes": float(model_bytes), "model_gbps": gbps,
            "peak_gbps": rate / 1e9, "roofline_frac": gbps * 1e9 / rate}
