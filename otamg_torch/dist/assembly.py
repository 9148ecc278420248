"""ELL assembly helpers (port of ``ell_row_sum_duplicates`` of
``otamg/dist/assembly.py``)."""

from __future__ import annotations

import torch


def _group_slots(cols: torch.Tensor, vals: torch.Tensor, out_cap: int):
    """Each row sorted by column, with the output slot of every entry:
    its merged group's index, or ``out_cap`` (one column past the output,
    dropped) for the padding group and for groups past the capacity.
    Returns ``(cols, vals, slot, ngroups_max)``, the first three sorted."""
    # Zero-valued entries carry nothing: they join the padding column.
    cols = torch.where(vals == 0, 0, cols)
    order = torch.argsort(cols, dim=1, stable=True)
    cs = torch.gather(cols, 1, order)
    vs = torch.gather(vals, 1, order)
    is_new = torch.cat([torch.ones_like(cs[:, :1], dtype=torch.bool),
                        cs[:, 1:] != cs[:, :-1]], dim=1)
    gid = torch.cumsum(is_new, dim=1) - 1
    # A row's group 0 is padding only iff it sits at column 0 and sums to
    # 0 (a real group summing to 0 merges to a zero entry anyway): it is
    # shifted out, so real groups start at slot 0, and not counted.
    g0_sum = torch.where(gid == 0, vs, 0).sum(dim=1)
    pad_only = (cs[:, 0] == 0) & (g0_sum == 0)
    gid = gid - pad_only[:, None].to(gid.dtype)
    ngroups_max = gid[:, -1].max() + 1
    # torch has no drop-mode scatter: the padding group (-1) and every
    # group at or past the capacity go to the extra column out_cap.
    slot = torch.where((gid < 0) | (gid >= out_cap), out_cap, gid)
    return cs, vs, slot, ngroups_max


def ell_row_sum_duplicates(cols: torch.Tensor, vals: torch.Tensor,
                           out_cap: int):
    """Per-row duplicate merge for ELL blocks: sort each row by column,
    sum runs of equal columns, and compress the merged entries into
    ``out_cap`` leading slots; trailing slots stay padding (column 0,
    value 0).

    Returns ``(out_cols, out_vals, ngroups_max)``, the last a 0-d tensor:
    the real distinct-column count of the worst row (the padding group
    excluded).  ``ngroups_max > out_cap`` means real merged entries were
    dropped, and the caller must refuse the result."""
    cs, vs, slot, ngroups_max = _group_slots(cols, vals, out_cap)
    R = cols.shape[0]
    out_c = torch.zeros(R, out_cap + 1, dtype=cols.dtype, device=cols.device)
    out_v = torch.zeros(R, out_cap + 1, dtype=vals.dtype, device=vals.device)
    out_c = out_c.scatter_(1, slot, cs)
    out_v = out_v.scatter_add_(1, slot, vs)
    return (out_c[:, :out_cap].contiguous(), out_v[:, :out_cap].contiguous(),
            ngroups_max)
