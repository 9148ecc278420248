"""The outer step of the blocked drivers as regions with no host read
(the port of the JAX step's ``fused=True``, whose SsN and Armijo loops
run on the device).

With ``exit_every > 1`` :func:`otamg_torch.opt.apd.make_class1_step` and
:func:`otamg_torch.opt.apd2.make_class2_step` run the step between its
host reads as a few regions (:meth:`Regions.ssn`):

* ``head``: the step's scalars, ``W``, ``wlk``, the SsN entry test
  beside the previous step's convergence flag, and the first SsN step's
  ``pre`` (``A^T lam``, ``z``, ``S``, ``F`` and the Newton right-hand
  side);
* ``first``: ``A^T zeta``, the merit at the old iterate and the first
  Armijo trial (the full step);
* ``trials``: the next ``exit_every`` trials, the first one's index an
  input, each after the first under :func:`otamg_torch.graphs.when` (on
  a card a conditional node): none runs after an accepted one or after
  trial ``ll_max``;
* ``accept_pre`` and ``accept_tail``: the accepted trial, the reject
  selects and the counters, then the next SsN step's ``pre`` or the
  step's tail (the new iterate, the restart and the record);
* ``tail``: the tail alone, when the SsN loop takes no step.

The Newton solve runs between ``pre`` and ``first``, as in the loop
driver.  Each region is a plain function over a :class:`State`, the
static buffers of one :func:`step_signature`, and reads no host value:
the numbers the host knows (``k``, the restart draw, the first trial of
an Armijo block) are inputs, filled in on the device.  On a card each
region is one CUDA graph of :data:`step_graphs`, captured the first
time its signature runs and replayed after; on the CPU the same
functions run as they are.
The host reads are the loop of blocks': the entry test with the
convergence flag, one read per Armijo block, and the Newton solve's.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.device import fetch
from otamg_torch.graphs import (ARMIJO_TRIALS, GraphCache, State,
                                cond_counts, run_region, when)

# The outer step's regions, one graph per (step_signature, region).
step_graphs = GraphCache()


def step_signature(cls: int, inputs, exit_every: int, consts: tuple,
                   mesh=None) -> tuple:
    """The key of a step's regions: the class, the shapes, dtypes and
    devices of the problem's tensors, the Armijo block size, the option
    values the regions hold as constants (``consts``, with
    ``capacitated`` for Class 1) and the live mesh (group, rank and
    size; None for no collective)."""
    where = (None if mesh is None
             else (mesh.group, mesh.rank, mesh.size))
    return (cls, tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
            exit_every, consts, where)


def ssn_counters(dev):
    """Zeroed ``(it_min, it_sum, it_max, fail)`` device counters."""
    big = torch.full((), np.iinfo(np.int32).max, dtype=torch.int64,
                     device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return big, zero, zero, zero


def count_solve(counters, iters, solver_maxit: int):
    """The counters after one Newton solve of ``iters`` iterations (an
    int or a device tensor)."""
    it_min, it_sum, it_max, fail = counters
    iters = torch.as_tensor(iters, dtype=torch.int64, device=it_min.device)
    return (torch.minimum(it_min, iters), it_sum + iters,
            torch.maximum(it_max, iters),
            fail + (iters >= solver_maxit).to(torch.int64))


def armijo_steps(opts) -> list[float]:
    """The backtracking steps ``1, delta, delta^2, ...`` of trials
    ``0 .. ll_max``, each the product of its predecessor and ``delta``,
    as the loop forms them."""
    steps = [1.0]
    for _ in range(opts.ll_max):
        steps.append(steps[-1] * opts.delta)
    return steps


class StepFns(NamedTuple):
    """A class's region functions over a :class:`State`."""

    head: Callable      # the step's scalars, the entry flags, ``pre``
    pre: Callable       # an SsN step's set-up of its Newton system
    prepare: Callable   # what the trials need of the Newton step
    trial: Callable     # (st, step, step_lo, nu_step) -> (accept, done, nF)
    accept: Callable    # the trial at ``st.step`` and the reject selects
    tail: Callable      # the new iterate, the restart and the record
    solve: Callable     # (st, key) -> the Newton solve's result


class Regions:
    """The regions of one step over the :class:`State` of its signature
    ``sig``.  On a card each is one CUDA graph of :data:`step_graphs`,
    captured the first time with the live ``mesh`` (its collectives
    with it) and replayed after; a failed capture raises.  Elsewhere
    each runs as it is, on a state of its own."""

    def __init__(self, sig, device, mesh, opts, exit_every: int,
                 solver_maxit: int):
        self.sig, self.mesh = sig, mesh
        self.opts, self.exit_every = opts, exit_every
        self.solver_maxit = solver_maxit
        self.captured = device.type == "cuda"
        self.st = (step_graphs.state(sig, lambda: State(device))
                   if self.captured else State(device))
        # Trial ll's step and nu * step, as the loop forms them, padded
        # for a block that runs past ll_max.
        steps = armijo_steps(opts)
        steps += [steps[-1]] * (exit_every - 1)
        self.table = torch.tensor([steps, [opts.nu * s for s in steps]],
                                  dtype=torch.float64)

    def own(self, token, data: dict) -> None:
        """Copy the problem's tensors ``data`` and the Armijo table into
        the state unless it holds ``token``'s already."""
        if self.st.owner is not token:
            self.load(armijo=self.table, **data)
            object.__setattr__(self.st, "owner", token)

    def load(self, **values) -> None:
        """Copy each value into its buffer: device tensors on the
        stream, host tensors from pinned memory without blocking the
        host, Python numbers by a fill (floats into an f64 buffer)."""
        st = self.st
        for name, v in values.items():
            if not isinstance(v, torch.Tensor):
                buf = st.__dict__.get(name)
                if buf is not None:
                    buf.fill_(v)
                    continue
                v = torch.tensor(v, dtype=(torch.float64
                                           if isinstance(v, float) else None))
            if self.captured and not v.is_cuda:
                v = v.pin_memory()
            setattr(st, name, v)

    def run(self, name: str, fn) -> None:
        if self.captured:
            run_region(step_graphs, (self.sig, name), fn, self.st, self.mesh)
        else:
            fn(self.st)

    def ssn(self, fns: StepFns, key) -> int | None:
        """The SsN loop: ``head``, then per SsN step the Newton solve,
        the Armijo search and ``accept`` with the next ``pre`` or the
        tail.  The number of SsN steps, or None when the entry read
        finds ``st.conv`` (the previous step converged) set."""
        st, opts = self.st, self.opts

        def accept_pre(st):
            self.accept(fns, st)
            fns.pre(st)

        def accept_tail(st):
            self.accept(fns, st)
            fns.tail(st)

        self.run("head", fns.head)
        done, stop = fetch(st.flags)
        if stop:
            return None
        it = 0
        while not done:
            key, sub = jr.split(key)
            sol = fns.solve(st, sub)
            self.load(zeta=sol.zeta, iters=sol.iters, ncomp_s=sol.ncomp,
                      last_s=sol.last)
            done = self.armijo(fns)
            it += 1
            done = done or it >= opts.ssn_maxit
            if done:
                self.run("accept_tail", accept_tail)
            else:
                self.run("accept_pre", accept_pre)
        if it == 0:
            self.run("tail", fns.tail)
        return it

    def accept(self, fns: StepFns, st) -> None:
        fns.accept(st)
        st.it_min, st.it_sum, st.it_max, st.fail = count_solve(
            (st.it_min, st.it_sum, st.it_max, st.fail), st.iters,
            self.solver_maxit)
        st.ncomp, st.last = st.ncomp_s, st.last_s

    def armijo(self, fns: StepFns) -> bool:
        """The Armijo search of :func:`otamg_torch.opt.apd.armijo` in
        blocks: the first trial (the full step) alone, then
        ``exit_every`` trials a block, each block one read of its
        acceptance and exit tests.  The accepted trial (trial
        ``ll_max`` when none passes) leaves its step in ``st.step`` and
        its ``||F||`` in ``st.nF_sel``; returns its exit test.  A block's
        trials after an accepted one or after trial ``ll_max`` do not run
        (:func:`when`), and read as not accepted."""
        opts, E = self.opts, self.exit_every

        def first(st):
            fns.prepare(st)
            accept, done, nF = fns.trial(st, 1.0, 1.0, opts.nu * 1.0)
            st.flags = torch.stack([accept, done])
            st.step = torch.ones((), dtype=nF.dtype, device=nF.device)
            st.nF_sel = nF

        def block(st):
            idx = st.ll + torch.arange(E, device=st.ll.device)
            steps, nu_steps = st.armijo.index_select(1, idx)
            last = idx >= opts.ll_max
            steps_lo = steps.to(st.zeta.dtype)
            # A trial that does not run leaves a false accept.
            st.accept = torch.zeros(E, dtype=torch.bool, device=idx.device)
            st.done = torch.zeros(E, dtype=torch.bool, device=idx.device)
            st.nFs = torch.zeros(E, dtype=st.nFk_old.dtype,
                                 device=idx.device)

            def run_trial(j):
                out = fns.trial(st, steps[j], steps_lo[j], nu_steps[j])
                for dst, src in zip((st.accept[j], st.done[j], st.nFs[j]),
                                    out):
                    dst.copy_(src)
                # Trial j + 1 runs unless this one is accepted or is
                # the last.
                st.more = ~out[0] & ~last[j]

            # Trial j runs where every earlier one of the block failed
            # and none of them was the last (:func:`when`; captured, a
            # conditional node).
            run_trial(0)
            for j in range(1, E):
                when(st.more, functools.partial(run_trial, j),
                     [st.accept, st.done, st.nFs, st.more],
                     count=(ARMIJO_TRIALS,))
            st.flags_blk = torch.stack([st.accept, st.done], 1).reshape(-1)
            j = torch.argmax((st.accept | last).to(torch.int32))
            st.step = steps.index_select(0, j.reshape(1))[0]
            st.nF_sel = st.nFs.index_select(0, j.reshape(1))[0]

        self.run("first", first)
        cond_counts.add(ARMIJO_TRIALS)
        got = fetch(self.st.flags)
        ll, n = 0, 1
        while True:
            for j in range(n):
                if got[2 * j] or ll + j >= opts.ll_max:
                    return bool(got[2 * j + 1])
            ll, n = ll + n, E
            self.load(ll=ll)
            self.run("trials", block)
            cond_counts.add(ARMIJO_TRIALS)   # the block's first trial
            got = fetch(self.st.flags_blk)
