"""CUDA graphs of regions that read nothing on the host.

A region is a function of device tensors whose kernels, and the
collectives of a live mesh, can be recorded once and replayed: the AMG
block of :func:`otamg_torch.amg.hierarchy.amg_solve`, the Newton solve's
setup (:func:`otamg_torch.amg.hierarchy.setup_solve`) and the regions of
an outer step (:mod:`otamg_torch.opt.regions`).  Each user keeps its
regions in a :class:`GraphCache`, one graph per signature; a region runs
once outside the capture (the warm-up) before it is captured.
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
