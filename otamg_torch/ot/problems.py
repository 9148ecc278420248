"""Class-1 problem container, ``.mat`` ingest and the synthetic generator
(port of ``otamg/ot/problems.py``).

``Class2Problem``, ``random_class2``, ``assignment_problem`` and
``capacitated_problem`` are later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Class1Problem:
    """OT / assignment / capacity-constrained transport:
    ``min <c,x> s.t. A x = b, 0 <= x <= gama``
    (reference ``Class1/APD_SsN_Class1.m:1-11``).

    ``C`` and ``gama`` are the ``(m, n)`` matrix forms of the vectorised
    ``c``/``gama`` (MATLAB vec is column-major).  ``b = [r; l]`` with the
    ``n``-block first.  ``gama`` is a 0-d tensor (``inf`` = plain OT) or
    an ``(m, n)`` tensor.
    """

    C: torch.Tensor      # (m, n) cost
    r: torch.Tensor      # (n,) column marginal
    l: torch.Tensor      # (m,) row marginal
    p: torch.Tensor      # (m,) row weights
    q: torch.Tensor      # (n,) column weights
    gama: torch.Tensor   # () or (m, n) capacity

    @property
    def m(self) -> int:
        return self.C.shape[0]

    @property
    def n(self) -> int:
        return self.C.shape[1]

    @property
    def b(self) -> torch.Tensor:
        return torch.cat([self.r, self.l])


def _unvec(x: np.ndarray, m: int, n: int) -> np.ndarray:
    """MATLAB column-major ``vec^{-1}``."""
    return np.asarray(x).reshape((m, n), order="F")


def _validate_weights(p, q) -> None:
    """Reference guard (``Hybrid_AMG.m:19``): zero weights are rejected at
    ingest, since the Q0 similarity transform divides by them."""
    if np.any(np.asarray(p) == 0) or np.any(np.asarray(q) == 0):
        raise ValueError("there exist zero elements in p or q "
                         "(reference Hybrid_AMG.m:19)")


def load_class1_mat(path: str, dtype=torch.float64,
                    device=None) -> Class1Problem:
    """Ingest a reference ``data1-*.mat`` fixture (keys ``c, gama, l, m,
    n, p, q, r``)."""
    import scipy.io as sio

    dev = resolve(device)
    d = sio.loadmat(path)
    m = int(np.asarray(d["m"]).squeeze())
    n = int(np.asarray(d["n"]).squeeze())
    _validate_weights(d["p"], d["q"])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=dev)
    return Class1Problem(C=t(_unvec(d["c"], m, n)), r=t(d["r"].ravel()),
                         l=t(d["l"].ravel()), p=t(d["p"].ravel()),
                         q=t(d["q"].ravel()), gama=t(_unvec(d["gama"], m, n)))


def random_class1(key: torch.Tensor, m: int, n: int, dtype=torch.float64,
                  balanced: bool = True, gama=np.inf,
                  device=None) -> Class1Problem:
    """Synthetic OT instance: uniform cost/marginals, unit weights,
    marginals rescaled to equal mass.  Draws exactly what
    ``otamg.ot.random_class1`` draws from the same key."""
    dev = resolve(device)
    kc, kr, kl = jr.split(key, 3)
    C = jr.uniform(kc, (m, n), dtype, dev)
    r = jr.uniform(kr, (n,), dtype, dev)
    l = jr.uniform(kl, (m,), dtype, dev)
    if balanced:
        l = l * (torch.sum(r) / torch.sum(l))
    return Class1Problem(C=C, r=r, l=l,
                         p=torch.ones(m, dtype=dtype, device=dev),
                         q=torch.ones(n, dtype=dtype, device=dev),
                         gama=torch.tensor(gama, dtype=dtype, device=dev))
