"""Problem containers, ``.mat`` ingest and the synthetic generators
(port of ``otamg/ot/problems.py``).

Every constructor and loader takes ``device``; ``None`` means CUDA and
raises without it.  The generators draw exactly what the JAX package's
draw from the same key.
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


@dataclasses.dataclass(frozen=True)
class Class2Problem:
    """Partial OT: ``min <c,x> s.t. G x + IY y + IZ z = b, x,y,z >= 0``
    with ``G = [A; phi^T]`` and mass budget ``mu``
    (reference ``Class2/APD_SsN_Class2.m:1-8``)."""

    C: torch.Tensor      # (m, n) cost
    r: torch.Tensor      # (n,)
    l: torch.Tensor      # (m,)
    p: torch.Tensor      # (m,)
    q: torch.Tensor      # (n,)
    Phi: torch.Tensor    # (m, n) budget weights (the reference: all ones)
    mu: torch.Tensor     # () mass budget

    @property
    def m(self) -> int:
        return self.C.shape[0]

    @property
    def n(self) -> int:
        return self.C.shape[1]

    @property
    def b(self) -> torch.Tensor:
        return torch.cat([self.r, self.l, self.mu.reshape(1)])


def _unvec(x: np.ndarray, m: int, n: int) -> np.ndarray:
    """MATLAB column-major ``vec^{-1}``."""
    return np.asarray(x).reshape((m, n), order="F")


def _validate_weights(p, q) -> None:
    """Reference guard (``Hybrid_AMG.m:19``): zero weights are rejected at
    ingest, since the Q0 similarity transform divides by them."""
    if np.any(np.asarray(p) == 0) or np.any(np.asarray(q) == 0):
        raise ValueError("there exist zero elements in p or q "
                         "(reference Hybrid_AMG.m:19)")


def _load_mat(path: str, dtype, device):
    """A reference ``.mat`` fixture: the fields both classes share
    (``C, r, l, p, q``) as tensors, a reader of any other ``(m, n)``
    plane (column-major ``vec``) and one of any other array."""
    import scipy.io as sio

    dev = resolve(device)
    d = sio.loadmat(path)
    m = int(np.asarray(d["m"]).squeeze())
    n = int(np.asarray(d["n"]).squeeze())
    _validate_weights(d["p"], d["q"])

    def array(key):
        return torch.as_tensor(np.ascontiguousarray(d[key]).squeeze(),
                               dtype=dtype, device=dev)

    def plane(key):
        return torch.as_tensor(np.ascontiguousarray(_unvec(d[key], m, n)),
                               dtype=dtype, device=dev)

    shared = dict(C=plane("c"), r=array("r").reshape(-1),
                  l=array("l").reshape(-1), p=array("p").reshape(-1),
                  q=array("q").reshape(-1))
    return shared, plane, array


def load_class1_mat(path: str, dtype=torch.float64,
                    device=None) -> Class1Problem:
    """Ingest a reference ``data1-*.mat`` fixture (keys ``c, gama, l, m,
    n, p, q, r``)."""
    shared, plane, _ = _load_mat(path, dtype, device)
    return Class1Problem(**shared, gama=plane("gama"))


def load_class2_mat(path: str, dtype=torch.float64,
                    device=None) -> Class2Problem:
    """Ingest a reference ``data4-*.mat`` fixture (the Class-1 keys and
    ``phi, mu``)."""
    shared, plane, array = _load_mat(path, dtype, device)
    return Class2Problem(**shared, Phi=plane("phi"), mu=array("mu"))


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


def assignment_problem(key: torch.Tensor, n: int, dtype=torch.float64,
                       device=None) -> Class1Problem:
    """Assignment problem (reference header case 1,
    ``Class1/APD_SsN_Class1.m:12``): ``gama = inf``, unit marginals."""
    dev = resolve(device)
    C = jr.uniform(key, (n, n), dtype, dev)
    ones = torch.ones(n, dtype=dtype, device=dev)
    return Class1Problem(C=C, r=ones, l=ones, p=ones, q=ones,
                         gama=torch.tensor(np.inf, dtype=dtype, device=dev))


def capacitated_problem(key: torch.Tensor, m: int, n: int,
                        cap_scale: float = 2.0, dtype=torch.float64,
                        device=None) -> Class1Problem:
    """Capacity-constrained transport (reference header case 3,
    ``Class1/APD_SsN_Class1.m:14``): the elementwise capacity is
    ``cap_scale`` times the product coupling's largest entry, so it
    binds."""
    base = random_class1(key, m, n, dtype=dtype, device=device)
    level = torch.outer(base.l, base.r).amax() / torch.sum(base.r)
    return dataclasses.replace(
        base, gama=torch.full((m, n), cap_scale, dtype=dtype,
                              device=base.C.device) * level)


def random_class2(key: torch.Tensor, m: int, n: int, dtype=torch.float64,
                  mu_frac: float | None = None,
                  device=None) -> Class2Problem:
    """Synthetic partial-OT instance (recipe of
    ``Class2/APD_SsN_Class2.m:13-18``): uniform cost and marginals, unit
    weights and budget weights, ``mu = frac * min(<r,q>, <l,p>)`` with
    ``frac`` drawn when ``mu_frac`` is None."""
    dev = resolve(device)
    kc, kr, kl, km = jr.split(key, 4)
    C = jr.uniform(kc, (m, n), dtype, dev)
    r = jr.uniform(kr, (n,), dtype, dev)
    l = jr.uniform(kl, (m,), dtype, dev)
    p = torch.ones(m, dtype=dtype, device=dev)
    q = torch.ones(n, dtype=dtype, device=dev)
    cap = torch.minimum(torch.dot(r, q), torch.dot(l, p))
    frac = (jr.uniform(km, (), dtype, dev) if mu_frac is None
            else torch.tensor(mu_frac, dtype=dtype, device=dev))
    return Class2Problem(C=C, r=r, l=l, p=p, q=q,
                         Phi=torch.ones(m, n, dtype=dtype, device=dev),
                         mu=frac * cap)
