"""CUDA graphs of regions that read nothing on the host.

A region is a function of device tensors whose kernels, and the
collectives of a live mesh, can be recorded once and replayed: the AMG
block of :func:`otamg_torch.amg.hierarchy.amg_solve`, the Newton solve's
front (:func:`otamg_torch.hybrid.solver.newton_front`), its mixed
refinement rounds and the regions of an outer step
(:mod:`otamg_torch.opt.regions`).  Each user keeps its regions in a
:class:`GraphCache`, one graph per signature; a region runs once outside
the capture (the warm-up) before it is captured.  Regions that pass
values to each other through static buffers keep them in a
:class:`State` and run through :func:`run_region`.
"""

from __future__ import annotations

import torch

from otamg_torch.dist import api


class Captured:
    """A region captured as one CUDA graph: ``run(inputs)`` on static
    copies of ``inputs``, whose outputs (``self.outputs``) stay in the
    graph's pool and are written anew at each replay.  ``mesh`` is the
    live mesh the region's collectives run on (None: it has none),
    active during the warm-up and the capture; ``collectives`` counts
    what the graph holds, added to ``api.collectives.replayed`` at each
    replay.  ``keep`` are tensors that ``run`` may update in place: the
    warm-up leaves them as it found them, so the first replay starts
    from the same values as the warm-up did."""

    def __init__(self, inputs, run, mesh=None, keep=()):
        self.inputs = [t.clone() for t in inputs]
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with api.use_mesh(mesh or api.current_mesh()):
            with torch.cuda.stream(side):
                # Warm-up outside the capture (cuBLAS and cuSOLVER
                # workspaces, the kernels' first-call set-up, and the
                # mesh's NCCL communicator, which a capture cannot
                # create).
                run(self.inputs)
                for dst, src in zip(keep, saved):
                    dst.copy_(src)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # NCCL's watchdog thread polls the events of the warm-up's
            # collectives; only this thread's calls join the capture.
            mode = "global" if mesh is None else "thread_local"
            with api.collectives.capture() as held, \
                    torch.cuda.graph(self.graph, capture_error_mode=mode):
                self.outputs = run(self.inputs)
        self.collectives = held[0]

    def load(self, inputs) -> None:
        """Copy ``inputs`` into the static inputs (from pinned host
        memory without blocking the host)."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)

    def replay(self) -> None:
        self.graph.replay()
        api.collectives.replayed += self.collectives


class GraphCache:
    """Captured regions, one per signature; ``captures`` and ``replays``
    count since ``clear``, and ``captured_collectives`` the collectives
    of the regions captured.  ``states`` holds the static buffers that
    several regions share (:meth:`state`); ``clear`` drops them with the
    graphs that read them."""

    def __init__(self):
        self.blocks: dict = {}
        self.states: dict = {}
        self.captures = self.replays = self.captured_collectives = 0

    def clear(self) -> None:
        self.blocks.clear()
        self.states.clear()
        self.captures = self.replays = self.captured_collectives = 0

    def get(self, sig, inputs, run, mesh=None, keep=()) -> Captured:
        """The region of ``sig``, captured from ``inputs`` and ``run``
        the first time."""
        blk = self.blocks.get(sig)
        if blk is None:
            blk = self.blocks[sig] = Captured(inputs, run, mesh, keep)
            self.captures += 1
            self.captured_collectives += blk.collectives
        return blk

    def state(self, sig, make):
        """The buffers shared by the regions of ``sig``, made by
        ``make()`` the first time."""
        st = self.states.get(sig)
        if st is None:
            st = self.states[sig] = make()
        return st


class State:
    """The static buffers that a signature's regions share.  ``st.name =
    value`` copies ``value`` into the buffer ``name``, made on the
    state's device the first time (never inside a capture); a buffer
    keeps its shape and dtype.  ``owner`` is the user whose data the
    buffers hold."""

    def __init__(self, device):
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "owner", None)

    def __setattr__(self, name, value):
        buf = self.__dict__.get(name)
        if buf is None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(f"state: {name} made in a capture")
            self.__dict__[name] = value.to(self.device, copy=True)
        elif buf.shape != value.shape or buf.dtype != value.dtype:
            raise ValueError(f"state: {name} is {buf.dtype} "
                             f"{tuple(buf.shape)}, got {value.dtype} "
                             f"{tuple(value.shape)}")
        else:
            buf.copy_(value, non_blocking=True)

    def buffers(self) -> list:
        return [t for t in self.__dict__.values()
                if isinstance(t, torch.Tensor)]


def run_region(cache: GraphCache, key, fn, st: State, mesh=None,
               keep=()) -> None:
    """``fn(st)`` as the CUDA graph ``key`` of ``cache``, captured the
    first time with the live ``mesh`` (the warm-up leaves ``st``'s
    buffers and ``keep`` as it found them) and replayed."""
    blk = cache.blocks.get(key)
    if blk is None:
        blk = cache.get(key, [], lambda _: fn(st) or [], mesh,
                        keep=[*st.buffers(), *keep])
    blk.replay()
    cache.replays += 1
