"""Checkpoint / resume of the APD solver state (port of the single-process
part of ``otamg/diag/checkpoint.py``).

State captured per outer iteration k: ``(X, V, lam, bk, key, k, resk)``
— enough to resume the APD loop exactly (``resk``, the previous raw KKT
residual, feeds the restart heuristic ``Class1/APD_SsN_Class1.m:245``).

A checkpoint is ``step_{k}.npz`` under the checkpoint directory, holding
``k`` and the named arrays: the layout of the JAX package's NumPy
fallback.  The key (:func:`otamg_torch.random.PRNGKey`, an int64 pair) is
stored as it is.  On load, an array named in the ``template`` comes back
on the template's device and in its dtype (an fp32 plan stays fp32, its
f64 dual stays f64); any other array comes back on the CPU in the dtype
it was saved in.

The multi-process layout (``step_{k}.proc{p}of{n}.npz``, one file of
shards per process) waits for ``otamg_torch.dist``: :func:`load_dict`
refuses a directory that holds only such files.
"""

from __future__ import annotations

import glob
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class APDState(NamedTuple):
    X: Any
    V: Any
    lam: Any
    bk: Any
    key: Any
    k: int
    resk: Any = None  # previous raw KKT residual (restart heuristic)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_dict(path: str, step: int, tree: dict) -> str:
    """Persist a flat dict of arrays for outer-iteration ``step``; the
    file appears under its final name only once it is whole."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step}.npz")
    tmp = os.path.join(path, f".step_{step}.{os.getpid()}.tmp.npz")
    np.savez(tmp, k=step, **{k: _numpy(v) for k, v in tree.items()})
    os.replace(tmp, target)
    return target


def load_dict(path: str, step: Optional[int] = None,
              template: Optional[dict] = None) -> dict:
    """The arrays of checkpoint ``step`` (the latest by default) as
    tensors, plus ``k``; see the module docstring for devices and
    dtypes."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    npz = os.path.join(path, f"step_{step}.npz")
    if not os.path.exists(npz):
        procs = glob.glob(os.path.join(glob.escape(path),
                                       f"step_{step}.proc*of*.npz"))
        if procs:
            raise NotImplementedError(
                f"{path} holds step {step} only as multi-process shard "
                f"files ({len(procs)} step_{step}.proc*of*.npz); restoring "
                f"them waits for otamg_torch.dist")
        raise FileNotFoundError(f"no checkpoint of step {step} under {path}")
    template = template or {}
    out: dict[str, Any] = {}
    with np.load(npz) as d:
        for name in d.files:
            if name == "k":
                continue
            t = template.get(name)
            if isinstance(t, torch.Tensor):
                out[name] = torch.as_tensor(d[name], dtype=t.dtype,
                                            device=t.device)
            else:
                out[name] = torch.as_tensor(d[name])
        out["k"] = int(d["k"])
    return out


def save_state(path: str, state: APDState) -> str:
    tree = dict(X=state.X, V=state.V, lam=state.lam, bk=state.bk,
                key=state.key)
    if state.resk is not None:
        tree["resk"] = state.resk
    return save_dict(path, state.k, tree)


def load_state(path: str, step: Optional[int] = None,
               template: Optional[dict] = None) -> APDState:
    d = load_dict(path, step, template)
    return APDState(d["X"], d["V"], d["lam"], d["bk"], d["key"], d["k"],
                    d.get("resk"))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            steps.append(int(name.split("_")[1].split(".")[0]))
    return max(steps) if steps else None


def save_result(path: str, res) -> str:
    """Persist a finished solve (primal/dual + records)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, "result.npz")
    np.savez(target, X=_numpy(res.X), lam=_numpy(res.lam),
             fxk=np.asarray(res.fxk), converged=res.converged,
             iters=res.iters)
    return target
