"""Capacity-padded sparse containers (port of
``otamg/sparse/containers.py``).

* :class:`COO` — coordinate triples with a fixed capacity and a count of
  valid leading entries; padding entries are ``(0, 0, 0)``.  The
  assembly format.
* :class:`CSR` — row pointers plus an ELL padded view (``row_cap``
  entries per row), the layout the ELL SpMV kernel takes.
* :func:`spgemm` — ``COO @ CSR`` by expansion, sort and merge.

Shapes stay static as in the JAX package, so the two packages' arrays
compare slot for slot.  ``BSR`` is not ported: no solver path uses it.
"""

from __future__ import annotations

import dataclasses

import torch

from otamg_torch.sparse.kernels import ell_spmv
from otamg_torch.sparse.segment import segment_sum

_KEY_PAD = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class COO:
    shape: tuple          # (nrows, ncols)
    rows: torch.Tensor    # (cap,) int32
    cols: torch.Tensor    # (cap,) int32
    vals: torch.Tensor    # (cap,); padding entries are 0 at (0, 0)
    nnz: torch.Tensor     # () int64 — number of valid leading entries

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    def _valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.rows.device) < self.nnz

    @classmethod
    def from_dense(cls, A: torch.Tensor, capacity: int | None = None
                   ) -> "COO":
        """The nonzeros of ``A`` in row-major order in the leading
        slots."""
        nr, nc = A.shape
        dev = A.device
        r = torch.arange(nr, dtype=torch.int32, device=dev).repeat_interleave(
            nc)
        c = torch.arange(nc, dtype=torch.int32, device=dev).repeat(nr)
        v = A.reshape(-1)
        nz = v != 0
        nnz = nz.sum()
        cap = capacity if capacity is not None else nr * nc
        order = torch.argsort((~nz).to(torch.uint8), stable=True)[:cap]
        keep = torch.arange(cap, device=dev) < nnz
        return cls((nr, nc), torch.where(keep, r[order], 0),
                   torch.where(keep, c[order], 0),
                   torch.where(keep, v[order], 0), nnz.clamp(max=cap))

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.vals, accumulate=True)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A @ x`` by gather and segment sum (padding adds 0 to
        row 0)."""
        return segment_sum(self.vals * x[self.cols.long()], self.rows,
                            self.shape[0])

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        return segment_sum(self.vals * y[self.rows.long()], self.cols,
                            self.shape[1])

    def transpose(self) -> "COO":
        """Swap rows/cols and re-canonicalize to row-major order."""
        valid = self._valid()
        key = self.cols.long() * self.shape[0] + self.rows.long()
        order = torch.argsort(torch.where(valid, key, _KEY_PAD), stable=True)
        vo = valid[order]
        return COO((self.shape[1], self.shape[0]),
                   torch.where(vo, self.cols[order], 0),
                   torch.where(vo, self.rows[order], 0),
                   torch.where(vo, self.vals[order], 0), self.nnz)

    def sum_duplicates(self) -> "COO":
        """Canonicalize: sort by (row, col) and merge duplicate entries."""
        nc = self.shape[1]
        cap = self.capacity
        dev = self.rows.device
        valid = self._valid()
        key = torch.where(valid, self.rows.long() * nc + self.cols.long(),
                          _KEY_PAD)
        order = torch.argsort(key, stable=True)
        k, vo = key[order], valid[order]
        v = torch.where(vo, self.vals[order], 0)
        # only valid entries can start a group; padding joins the last
        is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            k[1:] != k[:-1]]) & vo
        gid = torch.where(vo, torch.cumsum(is_new, 0) - 1, cap - 1)
        sums = segment_sum(v, gid, cap)
        # representative key of each group: its first (sorted) entry
        pos = torch.arange(cap, device=dev)
        first = torch.full((cap,), cap, dtype=torch.int64, device=dev)
        first = first.scatter_reduce_(0, gid, pos, "amin")
        ngroups = is_new.sum()
        gvalid = pos < ngroups
        gkey = torch.where(gvalid, k[first.clamp(max=cap - 1)], 0)
        return COO(self.shape,
                   torch.where(gvalid, gkey // nc, 0).to(torch.int32),
                   torch.where(gvalid, gkey % nc, 0).to(torch.int32),
                   torch.where(gvalid, sums, 0), ngroups)


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

    @classmethod
    def from_coo(cls, coo: COO, row_cap: int) -> "CSR":
        """Merge duplicates and lay the rows out in ELL slots; entries
        past ``row_cap`` in a row are dropped (``indptr`` keeps the full
        counts).  Unlike the JAX package, whose padding entries' scatter
        to slot ``(0, 0)`` can overwrite row 0's first column, only real
        entries reach the ELL arrays."""
        c = coo.sum_duplicates()
        nr, nc = c.shape
        dev = c.rows.device
        valid = c._valid()
        counts = segment_sum(valid.to(torch.int64), c.rows, nr)
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(counts, 0)])
        rows = c.rows.long()
        # position within the row = global index - row start (sorted)
        pos = torch.arange(c.capacity, device=dev) - indptr[rows]
        inbound = valid & (pos < row_cap)
        # everything else lands in one slot past the end, then dropped
        slot = torch.where(inbound, rows * row_cap + pos, nr * row_cap)
        cols = torch.zeros(nr * row_cap + 1, dtype=torch.int32, device=dev)
        vals = torch.zeros(nr * row_cap + 1, dtype=c.vals.dtype, device=dev)
        cols = cols.index_put_((slot,), c.cols)
        vals = vals.index_put_((slot,), torch.where(inbound, c.vals, 0),
                               accumulate=True)
        return cls((nr, nc), indptr.to(torch.int32),
                   cols[:-1].view(nr, row_cap),
                   vals[:-1].view(nr, row_cap))

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


def spgemm(A: COO, B: CSR, out_capacity: int) -> COO:
    """Sparse product ``C = A @ B`` by expansion, sort and compress (the
    SpGEMM MATLAB performs inside ``transfer.m:66``'s Galerkin product):
    every valid A entry ``(i, k, v)`` expands against the valid slots of
    row ``k`` of B's ELL view, and :meth:`COO.sum_duplicates` merges the
    products; the first ``out_capacity`` merged entries are kept."""
    cap_a = A.capacity
    R = B.row_cap
    dev = A.rows.device
    k = A.cols.long()
    # A product slot is real only where both the A entry and the B slot
    # are: padded B slots would make spurious (i, 0) groups.
    b_counts = (B.indptr[1:] - B.indptr[:-1])[k]
    valid = (A._valid()[:, None]
             & (torch.arange(R, device=dev)[None, :] < b_counts[:, None]))
    rows = torch.where(valid, A.rows[:, None], 0)
    cols = torch.where(valid, B.ell_cols[k], 0)
    vals = torch.where(valid, A.vals[:, None] * B.ell_vals[k], 0)
    # valid products to the front, so the expanded count is exact
    flat_valid = valid.reshape(-1)
    order = torch.argsort((~flat_valid).to(torch.uint8), stable=True)
    expanded = COO((A.shape[0], B.shape[1]), rows.reshape(-1)[order],
                   cols.reshape(-1)[order], vals.reshape(-1)[order],
                   flat_valid.sum())
    merged = expanded.sum_duplicates()
    return COO(merged.shape, merged.rows[:out_capacity],
               merged.cols[:out_capacity], merged.vals[:out_capacity],
               merged.nnz.clamp(max=out_capacity))
