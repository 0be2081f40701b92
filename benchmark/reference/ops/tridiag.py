"""Batched tridiagonal (Thomas) solver, plain PyTorch.

Counterpart of `vic_tpu/ops/tridiag.py:16`: forward elimination and back
substitution along the last axis, a Python loop over the nodes in the
order of operations of the two `lax.scan`s there. On the card the lake's
column solves run it inside the lake kernels (`csrc/thomas.cuh`); this is
their plain version.
"""
from __future__ import annotations

import torch


def thomas_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Solve tridiagonal systems along the LAST axis.

    dl: sub-diagonal [..., n] (dl[..., 0] ignored); d: main diagonal;
    du: super-diagonal (du[..., n-1] ignored); b: right-hand side."""
    n = d.shape[-1]
    cp_prev = torch.zeros_like(d[..., 0])
    dp_prev = torch.zeros_like(d[..., 0])
    cps, dps = [], []
    for i in range(n):
        m = d[..., i] - dl[..., i] * cp_prev
        cp_prev = du[..., i] / m
        dp_prev = (b[..., i] - dl[..., i] * dp_prev) / m
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(d[..., 0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, -1)
