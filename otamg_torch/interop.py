"""Carry state across from the JAX package.

Turns the JAX package's objects, handed over as numpy arrays, into the
port's objects, so both packages can compute on identical state: a
problem, a CSR matrix, hierarchy levels and a PRNG key.  The caller
converts on its side (``np.asarray(x)`` on each field); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from otamg_torch.amg.hierarchy import BipartiteLevel, DenseLevel
from otamg_torch.device import resolve
from otamg_torch.ot.problems import Class1Problem, Class2Problem
from otamg_torch.sparse.containers import CSR
from otamg_torch.sparse.segment import segment_plan

def _tensor(a, dev, name: str = "") -> torch.Tensor:
    a = np.asarray(a)
    if name == "labels":
        # the port indexes with int64 labels
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=dev)


def key(k) -> torch.Tensor:
    """A raw JAX key (uint32 pair) as the port's int64 key, on the CPU."""
    return torch.as_tensor(np.asarray(k).astype(np.int64))


def problem(C, r, l, p, q, gama, device=None) -> Class1Problem:
    dev = resolve(device)
    return Class1Problem(*(_tensor(a, dev) for a in (C, r, l, p, q, gama)))


def problem2(C, r, l, p, q, Phi, mu, device=None) -> Class2Problem:
    dev = resolve(device)
    return Class2Problem(*(_tensor(a, dev) for a in (C, r, l, p, q, Phi, mu)))


def csr(indptr, ell_cols, ell_vals, shape, device=None) -> CSR:
    dev = resolve(device)
    return CSR(tuple(int(s) for s in shape),
               _tensor(np.asarray(indptr).astype(np.int32), dev),
               _tensor(np.asarray(ell_cols).astype(np.int32), dev),
               _tensor(ell_vals, dev))


def _level(cls, fields: Mapping, dev, nseg: int, split=None):
    """The level from the JAX package's fields; its segment plan, which
    has no JAX counterpart, made from its labels."""
    kw = {f: _tensor(fields[f], dev, f) for f in cls._fields if f != "plan"}
    return cls(**kw, plan=segment_plan(kw["labels"], nseg, split))


def bipartite_level(fields: Mapping, device=None) -> BipartiteLevel:
    """A :class:`BipartiteLevel` from its fields (``lv._asdict()``)."""
    return _level(BipartiteLevel, fields, resolve(device),
                  np.asarray(fields["g"]).shape[0],
                  np.asarray(fields["W"]).shape[0])


def dense_level(fields: Mapping, nseg: int, device=None) -> DenseLevel:
    """A :class:`DenseLevel` from its fields (``lv._asdict()``), its plan
    into ``nseg`` slots (the fine level's node count)."""
    return _level(DenseLevel, fields, resolve(device), nseg)


def hierarchy(lv1: Mapping, dense: Sequence[Mapping], device=None):
    """``(BipartiteLevel, (DenseLevel, ...))`` from field mappings."""
    head = bipartite_level(lv1, device)
    nseg = head.g.shape[0]
    return head, tuple(dense_level(d, nseg, device) for d in dense)
