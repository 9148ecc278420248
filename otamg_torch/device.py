"""Device choice and counted host reads.

Entry points run on CUDA unless the caller names another device: a
problem constructor or loader given ``device=None`` asks for ``cuda`` and
raises where there is none, rather than falling back to the CPU.  Solvers
run on the device of the tensors they are given.

Every data-dependent loop exit in the port reads one small tensor from
the device.  Those reads go through :func:`fetch`, which counts them in
``fetch.reads`` so a run can report its host syncs per outer iteration.
A read of a CUDA tensor while the current stream is being captured into
a CUDA graph raises: a captured region must not depend on the host.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA, which must
    be present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "otamg_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def fetch(x: torch.Tensor):
    """Read a small tensor to the host as Python numbers (``x.tolist()``:
    a scalar for a 0-d tensor); one counted device sync.  Raises inside a
    CUDA graph capture."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("fetch: a host read inside a CUDA graph capture")
    fetch.reads += 1
    return x.tolist()


fetch.reads = 0
