"""Segment sums: the deterministic CUDA kernel and its plain PyTorch
version (``jax.ops.segment_sum``).

``segment_sum(data, labels, nseg)`` adds each ``data[j]`` into slot
``labels[j]`` of a length-``nseg`` result.  On a CPU tensor it is
:func:`segment_sum_plain`, ``index_add_``, which adds in index order.  On
a CUDA tensor it launches ``otamg_torch/csrc/segment_sum.cu`` (built at
first use, see :mod:`otamg_torch.cuda_build`), whose sums come in a fixed
order, where ``index_add_`` on the card adds with atomics in no fixed
order: two runs of one solve on the card then walk the same path.  With
``nseg * L`` at most :data:`SCAN_LIMIT` the ``scan`` variant runs (one
launch, the CPU's order, so the card's sums equal the CPU's); above it
the labels are sorted and the ``sorted`` variant adds each segment's run
tile by tile in a fixed order.  Neither synchronises with the host, so
both run under CUDA graph capture.  There is no fallback: a failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SCAN_LIMIT = 1 << 24
_SORTED_TILE = 2048   # csrc/segment_sum.cu::kSortedTile
_CODE = {torch.float32: 0, torch.float64: 1, torch.int64: 2}


def segment_sum_plain(data: torch.Tensor, labels: torch.Tensor,
                      nseg: int) -> torch.Tensor:
    """``index_add_`` into zeros: the CPU's order."""
    out = torch.zeros(nseg, dtype=data.dtype, device=data.device)
    return out.index_add_(0, labels.long(), data)


@functools.cache
def _bound():
    """(scan, sorted, error string, raw current stream), bound at the
    first call."""
    from otamg_torch import cuda_build

    lib = cuda_build.load("segment_sum")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.segment_sum_scan.argtypes = [p, p, p, i64, i64, i32, p, i32]
    lib.segment_sum_sorted.argtypes = [p, p, p, p, p, p, p, i64, i64, i32,
                                       p, i32]
    lib.segment_sum_scan.restype = lib.segment_sum_sorted.restype = i32
    lib.segment_sum_error_string.argtypes = [i32]
    lib.segment_sum_error_string.restype = ctypes.c_char_p
    stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda i: torch.cuda.current_stream(i).cuda_stream)
    return (lib.segment_sum_scan, lib.segment_sum_sorted,
            lib.segment_sum_error_string, stream)


def segment_sum(data: torch.Tensor, labels: torch.Tensor,
                nseg: int) -> torch.Tensor:
    """Segment sum of 1-D ``data`` (float32, float64 or int64) over
    integer ``labels`` in ``[0, nseg)``; CUDA kernel on a card,
    :func:`segment_sum_plain` on the CPU.  ``segment_sum.launches``
    counts kernel launches."""
    if not data.is_cuda:
        if labels.is_cuda:
            raise ValueError("segment_sum: data on the CPU, labels on a "
                             "card")
        return segment_sum_plain(data, labels, nseg)
    if labels.device != data.device:
        raise ValueError("segment_sum: data and labels lie on different "
                         "devices")
    if data.dtype not in _CODE:
        raise TypeError(f"segment_sum: data must be float32, float64 or "
                        f"int64, got {data.dtype}")
    if data.dim() != 1 or labels.shape != data.shape:
        raise ValueError(f"segment_sum: shapes data {tuple(data.shape)}, "
                         f"labels {tuple(labels.shape)}")
    scan, sorted_, error_string, stream = _bound()
    data = data.contiguous()
    labels = labels.to(torch.int64).contiguous()
    dev = data.get_device()
    out = data.new_empty(nseg)
    L = data.shape[0]
    if nseg * L <= SCAN_LIMIT:
        err = scan(data.data_ptr(), labels.data_ptr(), out.data_ptr(), L,
                   nseg, _CODE[data.dtype], stream(dev), dev)
    else:
        ordered, order = torch.sort(labels, stable=True)
        offsets = torch.searchsorted(
            ordered, torch.arange(nseg + 1, device=data.device))
        tiles = data.new_empty((2, -(-L // _SORTED_TILE)))
        err = sorted_(data.data_ptr(), order.data_ptr(), ordered.data_ptr(),
                      offsets.data_ptr(), tiles[0].data_ptr(),
                      tiles[1].data_ptr(), out.data_ptr(), L, nseg,
                      _CODE[data.dtype], stream(dev), dev)
    if err != 0:
        raise RuntimeError("segment_sum launch failed: "
                           + error_string(err).decode())
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
