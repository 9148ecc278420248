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

A branch on a device value inside a region is :func:`when`: a
conditional (IF) node of the graph, whose body runs at a replay only
where its predicate holds (JAX's ``lax.cond`` and the exits of its
``lax.while_loop``).  :data:`cond_counts` counts the bodies that ran.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import weakref

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
        # The warm-up runs each body of :func:`when` in the select form,
        # on the stream that captures it; its counts are not kept.
        keep = [*keep, prepare(torch.device("cuda",
                                            torch.cuda.current_device()))]
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with api.use_mesh(mesh or api.current_mesh()):
            with torch.cuda.stream(side), _warming_up():
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
            with api.collectives.capture() as held, capture(self.graph,
                                                            mode):
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


# Slots of :data:`cond_counts`: the bodies of :func:`when` on the Newton
# solve's path.
REPAIRS, AMG_CYCLES, REFINE_CYCLES, ARMIJO_TRIALS = range(4)
COND_NAMES = ("repairs", "amg_cycles", "refine_cycles", "armijo_trials")
MAX_DEPTH = 3   # nesting of conditional nodes, at most


class CondCounts:
    """The bodies that ran since ``reset``, by slot (:data:`COND_NAMES`):
    defect repairs built, AMG cycles (of ``amg_solve`` and of the
    blocked refinement's correction solves), the blocked refinement's
    correction cycles, and Armijo trials.  :func:`when` adds to a tensor
    on each device without a read (made the first time outside a
    capture: a captured region's graph holds it); what the host knows
    it counts with :meth:`add`.  :meth:`read` sums both."""

    def __init__(self):
        self.totals: dict = {}
        self.reset()

    def reset(self) -> None:
        self.host = [0] * len(COND_NAMES)
        for t in self.totals.values():
            t.zero_()

    def on(self, device) -> torch.Tensor:
        """The int64 counts kept on ``device``."""
        t = self.totals.get(device)
        if t is None:
            if (device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("cond_counts: made in a capture")
            t = self.totals[device] = torch.zeros(
                len(COND_NAMES), dtype=torch.int64, device=device)
        return t

    def add(self, slot: int, n: int = 1) -> None:
        self.host[slot] += n

    def read(self) -> dict:
        sums = list(self.host)
        for t in self.totals.values():
            sums = [a + int(b) for a, b in zip(sums, t.tolist())]
        return dict(zip(COND_NAMES, sums))


cond_counts = CondCounts()

# when's state: the select form forced, whether the select forms under
# way take their bodies (a 0-d bool tensor; None: no select under way),
# the capture under way (:func:`capture`), the nesting depth of bodies
# and the warm-up.
_form = {"select": False, "taken": None, "capture": None, "depth": 0,
         "warmup": False}
# The helper kernel's launches (one a conditional node captured).
cond_launches = collections.Counter()


@contextlib.contextmanager
def select_form():
    """Run every :func:`when` in its select form, on the CPU and inside a
    capture too: the plain version that tests and ``chip_smoke.py`` hold
    the conditional nodes to (a graph captured under it keeps the
    selects)."""
    was = _form["select"]
    _form["select"] = True
    try:
        yield
    finally:
        _form["select"] = was


def when(pred: torch.Tensor, body, outs, count=()) -> None:
    """``body()`` where the 0-d bool tensor ``pred`` holds: ``body``
    writes its results in place into ``outs``, buffers made before the
    call, and into nothing else.  ``count`` are the slots of
    :data:`cond_counts` that a run of the body adds 1 to.

    * Inside a CUDA-graph capture (:func:`capture`), the body is a
      conditional (IF) node that runs at a replay only where ``pred``
      holds; a node that cannot be made raises.  ``pred`` is held as long
      as the capture's graph.
      Under a live mesh (collectives of a process group, which NCCL has
      not been shown to capture inside a node's body) the select form.
    * On the CPU, a Python ``if`` on ``pred``.
    * Eager on a card, and under :func:`select_form` everywhere: the
      select form.  The body runs, and ``outs`` and the counts take its
      results where ``pred`` holds and keep their values elsewhere.  No
      host read.

    A tensor the body makes is not written where it is skipped: what is
    read after the call is in ``outs``.  ``outs`` must not overlap."""
    if _form["select"]:
        when_select(pred, body, outs, count)
    elif pred.device.type == "cpu":
        if _holds(pred):
            body()
            _count(pred.device, count)
    elif torch.cuda.is_current_stream_capturing() and api.live_mesh() is None:
        _if_node(pred, body, count)
    else:
        when_select(pred, body, outs, count)


def _holds(pred: torch.Tensor) -> bool:
    """The CPU's branch of :func:`when`: its one read of a predicate (on
    a card a conditional node reads it on the device)."""
    return bool(pred)


def when_select(pred: torch.Tensor, body, outs, count=()) -> None:
    """:func:`when`'s select form, its plain version.  The counts add
    whether the body is taken here and in every select around it."""
    at = pred.untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() == at for t in outs):
        pred = pred.clone()     # the body writes it
    saved = [t.clone() for t in outs]
    outer = _form["taken"]
    _form["taken"] = pred if outer is None else outer & pred
    try:
        with _body_stream(pred.device):
            body()
            _count(pred.device, count)
    finally:
        _form["taken"] = outer
    for dst, old in zip(outs, saved):
        torch.where(pred, dst, old, out=dst)


def _count(device, count) -> None:
    if count:
        counts = cond_counts.on(device)
        taken = 1 if _form["taken"] is None else _form["taken"]
        for slot in count:
            counts[slot].add_(taken)


# ---------------------------------------------------------------------------
# Conditional nodes on the card (csrc/conditional.cu)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _warming_up():
    was = _form["warmup"]
    _form["warmup"] = True
    try:
        yield
    finally:
        _form["warmup"] = was


@contextlib.contextmanager
def _body_stream(device):
    """In a capture's warm-up, where the capture makes conditional
    nodes: the select form's body runs on the stream that will capture
    it.  Without that, ``torch.linalg.solve_ex`` (cuSOLVER, fp32, the
    largest levels of a setup) allocated with ``cudaMallocAsync`` when it
    first ran on that stream inside the capture, which makes memory
    nodes, and a node's body takes none.  Elsewhere nothing."""
    if not (_form["warmup"] and device.type == "cuda"
            and api.live_mesh() is None):
        yield
        return
    cur = torch.cuda.current_stream(device)
    side = _sides(device.index)[_form["depth"]]
    side.wait_stream(cur)
    _form["depth"] += 1
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        _form["depth"] -= 1
        cur.wait_stream(side)


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, mode: str = "global"):
    """``torch.cuda.graph(graph, capture_error_mode=mode)``, in which
    :func:`when` makes conditional nodes (one made in another capture
    raises).  The bodies, nested or not, allocate from one memory pool of
    their own (the graph's pool takes only the graph's own stream), made
    at the first node: a graph without a node has none.  The pool and the
    nodes' predicates are held until ``graph`` is dropped; then the pool
    goes back to the allocator, which frees its memory at its next
    ``empty_cache``, as it does the graph's pool."""
    held = {"preds": [], "pool": None}
    with torch.cuda.graph(graph, capture_error_mode=mode):
        was = _form["capture"]
        _form["capture"] = held
        try:
            yield
        finally:
            _form["capture"] = was
            if held["pool"] is not None:
                torch._C._cuda_endAllocateToPool(*held["pool"])
                weakref.finalize(graph, _release, held["pool"],
                                 held["preds"]).atexit = False


def _release(pool, preds) -> None:
    """A dropped graph's body pool back to the allocator (``preds``, the
    predicates its replays read, go with it)."""
    torch._C._cuda_releasePool(*pool)


@functools.cache
def _lib():
    """``csrc/conditional.cu``, built and bound at the first call."""
    from otamg_torch import cuda_build

    lib = cuda_build.load("conditional")
    u64, p64 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
    for name, args in (("cond_begin", [u64, u64, p64]),
                       ("cond_node", [u64, u64, p64]),
                       ("cond_stream", [p64]),
                       ("cond_capture", [u64, u64, ctypes.c_int]),
                       ("cond_end", [u64])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    lib.cond_error_string.argtypes = [ctypes.c_int]
    lib.cond_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"when: {what}: "
                           f"{_lib().cond_error_string(err).decode()}")


@functools.cache
def _sides(index: int) -> list:
    """The streams that capture the bodies on card ``index``, one a
    depth of nesting, made before any capture."""
    out = []
    with torch.cuda.device(index):
        for _ in range(MAX_DEPTH):
            ptr = ctypes.c_uint64()
            _check(_lib().cond_stream(ctypes.byref(ptr)), "stream")
            out.append(torch.cuda.ExternalStream(ptr.value))
    return out


def prepare(device) -> torch.Tensor:
    """Make what a capture of :func:`when` on the card ``device`` needs
    and must not make inside it (the bodies' streams, the counts), and
    return the counts' tensor."""
    _sides(device.index)
    return cond_counts.on(device)


def _if_node(pred: torch.Tensor, body, count) -> None:
    """:func:`when` inside a capture: the set_if launch, the IF node and
    its body captured into the node's body graph."""
    lib, index = _lib(), pred.device.index
    held = _form["capture"]
    if held is None:
        raise RuntimeError("when: a conditional node is made only in a "
                           "capture of graphs.capture")
    if _form["depth"] >= MAX_DEPTH:
        raise RuntimeError(f"when: more than {MAX_DEPTH} nested nodes")
    if held["pool"] is None:
        # This thread's allocations on the streams that the graph's own
        # capture does not hold (the bodies') go to the pool until the
        # capture ends.
        held["pool"] = index, torch.cuda.graph_pool_handle()
        torch._C._cuda_beginAllocateCurrentThreadToPool(*held["pool"])
    held["preds"].append(pred)
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    handle, graph = ctypes.c_uint64(), ctypes.c_uint64()
    _check(lib.cond_begin(stream, pred.data_ptr(), ctypes.byref(handle)),
           "condition")
    cond_launches[pred.device] += 1
    _check(lib.cond_node(stream, handle, ctypes.byref(graph)), "node")
    side = _sides(index)[_form["depth"]]
    # Thread-local: only this thread's calls are held to the capture.
    _check(lib.cond_capture(side.cuda_stream, graph, 1), "body capture")
    _form["depth"] += 1
    try:
        with torch.cuda.stream(side):
            body()
            _count(pred.device, count)
    finally:
        _form["depth"] -= 1
        _check(lib.cond_end(side.cuda_stream), "body capture end")
