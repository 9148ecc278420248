"""Row-pointer sparse matrix with an ELL padded view (port of ``CSR`` in
``otamg/sparse/containers.py``).

``COO``, ``BSR``, ``CSR.from_coo`` and ``spgemm`` are a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from otamg_torch.sparse.kernels import ell_spmv


@dataclasses.dataclass(frozen=True)
class CSR:
    """``ell_cols``/``ell_vals`` have shape ``(nrows, row_cap)``; short
    rows are padded with column 0 / value 0.  ``ell_cols`` is int32 and
    contiguous, the layout :func:`otamg_torch.sparse.kernels.ell_spmv`
    takes; ``indptr`` supports host-side interop and conversions."""

    shape: tuple
    indptr: torch.Tensor     # (nrows + 1,) int32
    ell_cols: torch.Tensor   # (nrows, row_cap) int32
    ell_vals: torch.Tensor   # (nrows, row_cap)

    @property
    def row_cap(self) -> int:
        return self.ell_cols.shape[1]

    @classmethod
    def from_dense(cls, A: torch.Tensor, row_cap: int | None = None) -> "CSR":
        nr, nc = A.shape
        cap = row_cap if row_cap is not None else nc
        nz = A != 0
        counts = nz.sum(dim=1).to(torch.int32)
        indptr = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=A.device),
                            torch.cumsum(counts, 0).to(torch.int32)])
        # per row: nonzero columns first (stable), padded with 0
        order = torch.argsort(torch.logical_not(nz).to(torch.uint8), dim=1,
                              stable=True)[:, :cap]
        keep = (torch.arange(cap, device=A.device)[None, :]
                < counts[:, None])
        cols = torch.where(keep, order, 0).to(torch.int32).contiguous()
        vals = torch.where(keep, torch.gather(A, 1, order), 0).contiguous()
        return cls((nr, nc), indptr, cols, vals)

    def to_dense(self) -> torch.Tensor:
        nr, nc = self.shape
        out = torch.zeros(nr, nc, dtype=self.ell_vals.dtype,
                          device=self.ell_vals.device)
        rows = torch.arange(nr, device=out.device)[:, None].expand(
            self.ell_cols.shape)
        return out.index_put_((rows, self.ell_cols.long()), self.ell_vals,
                              accumulate=True)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """ELL SpMV through :func:`ell_spmv` (the CUDA kernel on a card)."""
        return ell_spmv(self.ell_cols, self.ell_vals, x)

    def diag(self) -> torch.Tensor:
        n = min(self.shape)
        hit = self.ell_cols[:n] == torch.arange(
            n, dtype=torch.int32, device=self.ell_cols.device)[:, None]
        return torch.where(hit, self.ell_vals[:n], 0).sum(dim=1)
