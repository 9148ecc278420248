"""Segment sums: the deterministic CUDA kernel and its plain PyTorch
version (``jax.ops.segment_sum``).

``segment_sum(data, labels, nseg)`` adds each ``data[j]`` into slot
``labels[j]`` of a length-``nseg`` result; labels outside ``[0, nseg)``
are dropped.  On a CPU tensor it is :func:`segment_sum_plain`,
``index_add_``, which adds in index order.  On a CUDA tensor it launches
``otamg_torch/csrc/segment_sum.cu`` (built at first use, see
:mod:`otamg_torch.cuda_build`), whose sums come in a fixed order, where
``index_add_`` on the card adds with atomics in no fixed order: two runs
of one solve on the card then walk the same path.

Labels that stay fixed across many sums (a hierarchy's component labels)
get a :class:`SegmentPlan` once, from :func:`segment_plan` (torch ops,
on the labels' device): the positions sorted by label, each segment's
run, and the tiles of the runs longer than :data:`LANE_MAX`.  A sum with
a plan is one launch that reads no labels, sorts nothing and allocates
only its result, so it can be captured in a CUDA graph.  With ``nseg *
L`` at most :data:`SCAN_LIMIT` (an *exact* call) every segment is summed
from 0 in index order, so the card's sums equal the CPU's bit for bit;
above it runs longer than :data:`LANE_MAX` are summed by fixed trees over
tiles of :data:`TILE`, deterministic but not in the CPU's order.
:func:`segment_sum2` sums two vectors over the two halves of one labels
vector in one launch.  A call without a plan runs the ``scan`` kernel
when it is exact (one launch, the CPU's order) and otherwise builds a
plan first.  On the CPU the plan is ignored.  There is no fallback: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

SCAN_LIMIT = 1 << 24
LANE_MAX = 32      # csrc/segment_sum.cu::kLaneMax
TILE = 4096        # csrc/segment_sum.cu::kTile
TILE_FIELDS = 7    # csrc/segment_sum.cu::kTileFields
_CODE = {torch.float32: 0, torch.float64: 1, torch.int64: 2}


class SegmentPlan(NamedTuple):
    """The labels of a segment sum, sorted once (:func:`segment_plan`).
    Its shapes depend only on the labels' length and ``nseg``."""

    order: torch.Tensor     # (L,) int32 positions by segment, each run in
    #                         index order; dropped positions last
    offsets: torch.Tensor   # (nseg + 1,) int32 run bounds in ``order``
    mid: torch.Tensor       # (nseg,) int32: where each run passes into the
    #                         second half (pair plans); (0,) otherwise
    tiles: torch.Tensor     # (cap, TILE_FIELDS) int32: the tiles of the
    #                         segments with a run past LANE_MAX (segment,
    #                         lo, hi, first tile, tiles of the first half,
    #                         tiles, in index order); segment -1 unused.
    #                         (0, TILE_FIELDS) in an exact plan
    partials: torch.Tensor  # float64 scratch, written before it is read:
    #                         a slot a tile, or a run of an exact pair plan
    counts: torch.Tensor    # int32 scratch, 0 between calls: a slot a
    #                         tile, or a segment of an exact pair plan


def exact(nseg: int, L: int) -> bool:
    """A sum of ``L`` elements into ``nseg`` slots is taken in the CPU's
    order on the card."""
    return nseg * L <= SCAN_LIMIT


def _halves_exact(nseg: int, L: int, split) -> tuple:
    """Whether each half of a plan's sums is exact (a single plan's second
    half is empty)."""
    n_a = L if split is None else split
    return exact(nseg, n_a), split is None or exact(nseg, L - split)


def segment_plan(labels: torch.Tensor, nseg: int,
                 split: int | None = None) -> SegmentPlan:
    """The plan of ``labels`` for sums into ``nseg`` slots, on the
    labels' device, made once per labels tensor: one stable
    ``torch.sort`` of the keys ``2 label + half`` (dropped labels ``2
    nseg``), one ``torch.searchsorted`` and, unless the plan is exact,
    the tile list.  With
    ``split`` it is a pair plan for :func:`segment_sum2` over
    ``labels[:split]`` and ``labels[split:]``.  An exact plan (each half
    exact) has no tile list: the kernel finds its long runs."""
    L = labels.shape[0]
    if L >= 1 << 31 or nseg >= 1 << 30:
        raise ValueError(f"segment_plan: {L} labels into {nseg} slots do "
                         "not fit int32 positions")
    dev = labels.device
    i32 = torch.int32
    lab = labels.long()
    valid = (lab >= 0) & (lab < nseg)
    # Each run's first-half positions come before its second-half ones.
    key = 2 * lab
    if split is not None:
        key = key + (torch.arange(L, device=dev) >= split)
    skey, order = torch.sort(torch.where(valid, key, 2 * nseg), stable=True)
    cuts = torch.searchsorted(skey, torch.arange(2 * nseg + 1, device=dev))
    offsets = cuts[0::2]
    mid = cuts[1::2] if split is not None else cuts[:0]
    if all(_halves_exact(nseg, L, split)):
        # Exact: the kernel finds the long runs itself; a pair's two sums
        # of a segment meet in scratch (a slot a run, a counter a segment).
        pair = split is not None
        tiles = torch.zeros((0, TILE_FIELDS), dtype=i32, device=dev)
        nparts, ncounts = 2 * nseg * pair, nseg * pair
    else:
        tiles = _tile_list(offsets, mid if split is not None
                           else offsets[1:], nseg, L, split).to(i32)
        nparts = ncounts = tiles.shape[0]
    # partials: scratch every tile or run writes before it is read
    return SegmentPlan(order.to(i32), offsets.to(i32), mid.to(i32), tiles,
                       torch.zeros(nparts, dtype=torch.float64, device=dev),
                       torch.zeros(ncounts, dtype=i32, device=dev))


def tile_capacity(L: int) -> int:
    """Room for the tiles of any labels of length ``L``: at most ``L //
    (LANE_MAX + 1)`` segments have a run past ``LANE_MAX``, and each has
    at most ``len / TILE + 2`` tiles (two runs, each with a partial
    tile)."""
    return L // TILE + 2 * (L // (LANE_MAX + 1)) + 1


def _tile_list(offsets, mid, nseg: int, L: int, split):
    """The tiles of a plan that is not exact: those of the segments with
    a run longer than :data:`LANE_MAX`.  Each run of such a
    segment is one tile in an exact half (summed in order) and tiles of
    ``TILE`` positions otherwise.  The used tiles come first in a list of
    :func:`tile_capacity` entries, so its shape depends on ``L`` alone;
    made without a host read."""
    ex_a, ex_b = _halves_exact(nseg, L, split)
    dev = offsets.device
    cap = tile_capacity(L)
    unused = torch.tensor([-1] + [0] * (TILE_FIELDS - 1), device=dev)
    if nseg == 0:
        return unused.repeat(cap, 1)
    lo, hi = offsets[:-1], offsets[1:]
    len_a, len_b = mid - lo, hi - mid
    long_ = (len_a > LANE_MAX) | (len_b > LANE_MAX)

    def ntiles(length, ex):
        return (length > 0) * (1 if ex else -(-length // TILE))

    k_a = ntiles(len_a, ex_a) * long_
    k = k_a + ntiles(len_b, ex_b) * long_
    cum = torch.cumsum(k, 0)
    t = torch.arange(cap, device=dev)
    s = torch.searchsorted(cum, t, right=True).clamp_max(nseg - 1)
    first = cum[s] - k[s]
    j = t - first
    in_b = j >= k_a[s]
    jj = torch.where(in_b, j - k_a[s], j)
    run_lo = torch.where(in_b, mid[s], lo[s])
    run_hi = torch.where(in_b, hi[s], mid[s])
    seq = torch.where(in_b, ex_b, ex_a)
    t_lo = torch.where(seq, run_lo, run_lo + jj * TILE)
    t_hi = torch.where(seq, run_hi, torch.minimum(t_lo + TILE, run_hi))
    desc = torch.stack([s, t_lo, t_hi, first, k_a[s], k[s], seq.long()],
                       dim=1)
    return torch.where((t < cum[-1])[:, None], desc, unused)


def segment_sum_plain(data: torch.Tensor, labels: torch.Tensor,
                      nseg: int) -> torch.Tensor:
    """``index_add_`` into zeros: the CPU's order."""
    out = torch.zeros(nseg, dtype=data.dtype, device=data.device)
    return out.index_add_(0, labels.long(), data)


def _runs(plan: SegmentPlan, lo, hi):
    """(positions, segments) of the runs ``[lo[s], hi[s])`` in plan
    order."""
    nseg = plan.offsets.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(nseg, device=lo.device),
                                  hi - lo)
    start = torch.repeat_interleave(lo - torch.cumsum(hi - lo, 0)
                                    + (hi - lo), hi - lo)
    pos = torch.arange(seg.shape[0], device=lo.device) + start
    return plan.order.long()[pos], seg


def segment_sum_plan_plain(a: torch.Tensor, plan: SegmentPlan,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """``index_add_`` over ``plan.order``: the sum of ``a`` over a plan,
    or with ``b`` the pair sum over a pair plan (each half's sum, then
    their add); the CPU's order, as :func:`segment_sum_plain`."""
    nseg = plan.offsets.shape[0] - 1
    off = plan.offsets.long()
    out = torch.zeros(nseg, dtype=a.dtype, device=a.device)
    if b is None:
        pos, seg = _runs(plan, off[:-1], off[1:])
        return out.index_add_(0, seg, a[pos])
    mid = plan.mid.long()
    pos, seg = _runs(plan, off[:-1], mid)
    out.index_add_(0, seg, a[pos])
    pos, seg = _runs(plan, mid, off[1:])
    n = a.shape[0]
    return out + torch.zeros_like(out).index_add_(0, seg, b[pos - n])


# The kernels take their arguments packed as int64: one ctypes argument
# costs the host far less than 16.
_SCAN_ARGS = struct.Struct("<8q").pack
_PLAN_ARGS = struct.Struct("<16q").pack


@functools.cache
def _bound():
    """(scan, plan, error string, raw current stream), bound at the
    first call."""
    from otamg_torch import cuda_build

    lib = cuda_build.load("segment_sum")
    for fn in (lib.segment_sum_scan, lib.segment_sum_plan):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    lib.segment_sum_error_string.argtypes = [ctypes.c_int]
    lib.segment_sum_error_string.restype = ctypes.c_char_p
    stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda i: torch.cuda.current_stream(i).cuda_stream)
    return (lib.segment_sum_scan, lib.segment_sum_plan,
            lib.segment_sum_error_string, stream)


def _check(data: torch.Tensor, name: str):
    if data.dtype not in _CODE:
        raise TypeError(f"{name}: data must be float32, float64 or int64, "
                        f"got {data.dtype}")
    if data.dim() != 1:
        raise ValueError(f"{name}: data must be 1-D, got "
                         f"{tuple(data.shape)}")


def _raise_on(err: int, error_string):
    if err != 0:
        raise RuntimeError("segment_sum launch failed: "
                           + error_string(err).decode())


def _launch_plan(a, b, plan: SegmentPlan, nseg: int,
                 pair: bool) -> torch.Tensor:
    _, run, error_string, stream = _bound()
    dev = a.get_device()
    out = a.new_empty(nseg)
    if nseg == 0:
        return out
    err = run(_PLAN_ARGS(
        a.data_ptr(), b.data_ptr(), a.shape[0], plan.order.data_ptr(),
        plan.offsets.data_ptr(), plan.mid.data_ptr() if pair else 0,
        plan.tiles.data_ptr(), plan.tiles.shape[0], plan.partials.data_ptr(),
        plan.counts.data_ptr(), out.data_ptr(), nseg, pair, _CODE[a.dtype],
        stream(dev), dev))
    _raise_on(err, error_string)
    segment_sum.launches += 1
    return out


def segment_sum(data: torch.Tensor, labels: torch.Tensor, nseg: int,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """Segment sum of 1-D ``data`` (float32, float64 or int64) over
    integer ``labels`` into ``nseg`` slots; CUDA kernel on a card (over
    ``plan`` where given, a plan of ``labels`` made by
    :func:`segment_plan`), :func:`segment_sum_plain` on the CPU.
    ``segment_sum.launches`` counts kernel launches."""
    if not data.is_cuda:
        if labels.is_cuda:
            raise ValueError("segment_sum: data on the CPU, labels on a "
                             "card")
        return segment_sum_plain(data, labels, nseg)
    _check(data, "segment_sum")
    L = data.shape[0]
    if plan is None:
        if labels.device != data.device or labels.shape != data.shape:
            raise ValueError("segment_sum: labels must match data's shape "
                             "and device")
        if not exact(nseg, L):
            plan = segment_plan(labels, nseg)
        else:
            scan, _, error_string, stream = _bound()
            data = data.contiguous()
            labels = labels.to(torch.int64).contiguous()
            dev = data.get_device()
            out = data.new_empty(nseg)
            if nseg == 0:
                return out
            _raise_on(scan(_SCAN_ARGS(
                data.data_ptr(), labels.data_ptr(), out.data_ptr(), L, nseg,
                _CODE[data.dtype], stream(dev), dev)), error_string)
            segment_sum.launches += 1
            return out
    if plan.order.shape[0] != L or plan.offsets.shape[0] != nseg + 1 \
            or plan.mid.shape[0] != 0:
        raise ValueError(f"segment_sum: the plan is not one of {L} labels "
                         f"into {nseg} slots")
    data = data.contiguous()
    return _launch_plan(data, data, plan, nseg, False)


def segment_sum2(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
                 nseg: int, plan: SegmentPlan | None = None) -> torch.Tensor:
    """``segment_sum(a, labels[:n], nseg) + segment_sum(b, labels[n:],
    nseg)`` with ``n = len(a)``, to the bit, in one launch on a card
    (over ``plan``, a pair plan ``segment_plan(labels, nseg, split=n)``;
    made here when not given).  Each half is summed in its own order,
    then the two are added once; on the CPU the two plain sums."""
    n = a.shape[0]
    if not a.is_cuda:
        return (segment_sum_plain(a, labels[:n], nseg)
                + segment_sum_plain(b, labels[n:], nseg))
    _check(a, "segment_sum2")
    _check(b, "segment_sum2")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError("segment_sum2: a and b differ in dtype or device")
    L = n + b.shape[0]
    if plan is None:
        plan = segment_plan(labels, nseg, split=n)
    if plan.order.shape[0] != L or plan.mid.shape[0] != nseg \
            or plan.offsets.shape[0] != nseg + 1:
        raise ValueError(f"segment_sum2: the plan is not a pair plan of "
                         f"{L} labels into {nseg} slots")
    return _launch_plan(a.contiguous(), b.contiguous(), plan, nseg, True)


segment_sum.launches = 0
