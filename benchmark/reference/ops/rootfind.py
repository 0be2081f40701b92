"""Batched Brent root finding, plain PyTorch.

Counterpart of `vic_tpu/ops/rootfind.py:43-207`: every lane of the batch
carries its own bracket, convergence flag and fallback. The residual is
evaluated on the whole batch each iteration and per-lane branches are
`torch.where` masks; the loops exit once every active lane brackets or has
converged, which costs one device-to-host sync per iteration on a GPU.

This is the plain version that the CUDA Brent kernels (`csrc/brent.cuh`,
one thread per lane) are checked against. `batched_bisection` is
`vic_tpu/ops/rootfind.py:210`'s fixed-count bisection; it takes any Python
callable and runs on any device. The bisection kernel (`csrc/bisection.cu`)
runs it on the residuals the kernel library compiles
(`physics.bisection`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

MAXTRIES = 5       # bracket-expansion attempts (root_brent.c:32-36)
TSTEP = 10.0       # bracket expansion step
F32_TOL = 1e-4     # absolute tolerance addend for float32 (rootfind.py:107-111)


class RootResult(NamedTuple):
    root: torch.Tensor        # solution (midpoint of [lo, hi] if unbracketed)
    converged: torch.Tensor   # bool per lane
    bracketed: torch.Tensor   # bool per lane
    iterations: object        # int (plain: max over lanes) or int32 per lane


def _any(b, votes):
    """b.any() over the batch, or over every share's batch with votes (a
    parallel.votes.Member)."""
    got = bool(b.any())
    return got if votes is None else votes.any(got)


def expand_brackets(f: Callable, lo, hi, max_tries: int = MAXTRIES,
                    tstep: float = TSTEP, active=None, votes=None):
    """Widen [lo, hi] by `tstep` on each side, up to `max_tries` times, on
    active lanes that do not yet bracket a sign change
    (root_brent.c:183-244). Returns (lo, hi, f_lo, f_hi, bracketed).
    votes: a parallel.votes.Member where the batch is one share of a split
    block and f's value depends on the whole block (the node sweep): then
    every share widens while any share's lane needs it."""
    f_lo = f(lo)
    f_hi = f(hi)
    act = torch.ones_like(f_lo, dtype=torch.bool) if active is None \
        else active
    for _ in range(max_tries):
        need = (f_lo * f_hi >= 0.0) & act
        if not _any(need, votes):
            break
        lo = torch.where(need, lo - tstep, lo)
        hi = torch.where(need, hi + tstep, hi)
        f_lo = torch.where(need, f(lo), f_lo)
        f_hi = torch.where(need, f(hi), f_hi)
    bracketed = f_lo * f_hi < 0.0
    if active is not None:
        bracketed = bracketed & active
    return lo, hi, f_lo, f_hi, bracketed


def batched_brent(f: Callable, lo, hi, max_iter: int = 60,
                  max_tries: int = MAXTRIES, tol: float = None,
                  active=None, votes=None) -> RootResult:
    """Roots of `f` lane-wise on [lo, hi] by Brent's method, after bracket
    expansion. Converged when |0.5*(c-b)| <= 2*eps*|b| + tol or f(b) == 0.
    Unbracketed or inactive lanes return the midpoint of the ORIGINAL
    [lo, hi] with converged=False, for the caller's TFALLBACK. votes: as
    expand_brackets'; every share iterates while any share's lane is
    live."""
    eps = torch.finfo(lo.dtype).eps
    if tol is None:
        tol = 1e-7 if lo.dtype == torch.float64 else F32_TOL
    a, b, fa, fb, bracketed = expand_brackets(f, lo, hi, max_tries,
                                              active=active, votes=votes)
    c, fc = a, fa
    d = b - a
    e = b - a
    done = ~bracketed
    i = 0
    while i < max_iter and _any(~done, votes):
        # rearrange so b is the best iterate and [b, c] brackets the root
        # (root_brent.c:249-263) -- on every lane, frozen ones included
        same_side = fb * fc > 0.0
        c = torch.where(same_side, a, c)
        fc = torch.where(same_side, fa, fc)
        d = torch.where(same_side, b - a, d)
        e = torch.where(same_side, d, e)

        swap = torch.abs(fc) < torch.abs(fb)
        a, b, c, fa, fb, fc = (torch.where(swap, b, a),
                               torch.where(swap, c, b),
                               torch.where(swap, b, c),
                               torch.where(swap, fb, fa),
                               torch.where(swap, fc, fb),
                               torch.where(swap, fb, fc))

        tol_i = 2.0 * eps * torch.abs(b) + tol
        m = 0.5 * (c - b)
        done = done | (torch.abs(m) <= tol_i) | (fb == 0.0)

        use_bisect = (torch.abs(e) < tol_i) | (torch.abs(fa) <= torch.abs(fb))
        s = fb / torch.where(fa == 0.0, 1.0, fa)
        is_secant = a == c
        p_sec = 2.0 * m * s
        q_sec = 1.0 - s
        q_iq = fa / torch.where(fc == 0.0, 1.0, fc)
        r_iq = fb / torch.where(fc == 0.0, 1.0, fc)
        p_iq = s * (2.0 * m * q_iq * (q_iq - r_iq) - (b - a) * (r_iq - 1.0))
        q_iq2 = (q_iq - 1.0) * (r_iq - 1.0) * (s - 1.0)
        p = torch.where(is_secant, p_sec, p_iq)
        q = torch.where(is_secant, q_sec, q_iq2)
        q = torch.where(p > 0.0, -q, q)
        p = torch.abs(p)

        interp_ok = ((2.0 * p < 3.0 * m * q - torch.abs(tol_i * q))
                     & (p < torch.abs(0.5 * e * q)))
        take_interp = ~use_bisect & interp_ok
        e_new = torch.where(take_interp, d, m)
        d_new = torch.where(take_interp, p / torch.where(q == 0.0, 1.0, q), m)

        step = torch.where(torch.abs(d_new) > tol_i, d_new,
                           torch.where(m > 0.0, tol_i, -tol_i))
        b_next = b + step
        fb_next = f(b_next)

        # frozen lanes (done, or never bracketed) keep their state
        frozen = done | ~bracketed
        a = torch.where(frozen, a, b)
        fa = torch.where(frozen, fa, fb)
        b = torch.where(frozen, b, b_next)
        fb = torch.where(frozen, fb, fb_next)
        d = torch.where(frozen, d, d_new)
        e = torch.where(frozen, e, e_new)
        i += 1

    tol_f = 2.0 * eps * torch.abs(b) + tol
    converged = bracketed & ((torch.abs(0.5 * (c - b)) <= tol_f) | (fb == 0.0))
    root = torch.where(bracketed, b, 0.5 * (lo + hi))
    return RootResult(root=root, converged=converged, bracketed=bracketed,
                      iterations=i)


def batched_bisection(f: Callable, lo, hi, n_iter: int = 40,
                      active=None) -> RootResult:
    """Fixed-count bisection of `f` lane-wise on [lo, hi]
    (vic_tpu/ops/rootfind.py:210-234): n_iter halvings keeping the left
    half where f(lo)*f(mid) <= 0, the root the midpoint of the final
    bracket, converged = bracketed = f(lo)*f(hi) < 0 at the start; lanes
    that do not bracket are bisected all the same. Plain PyTorch, any
    device. With `active`, inactive lanes return the midpoint of [lo, hi]
    unbracketed, as the bisection kernel does."""
    lo0, hi0 = lo, hi
    f_lo = f(lo)
    bracketed = f_lo * f(hi) < 0.0
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        go_left = f_lo * f_mid <= 0.0   # f_mid == 0: shrink hi onto the root
        lo, hi, f_lo = (torch.where(go_left, lo, mid),
                        torch.where(go_left, mid, hi),
                        torch.where(go_left, f_lo, f_mid))
    root = 0.5 * (lo + hi)
    if active is not None:
        bracketed = bracketed & active
        root = torch.where(active, root, 0.5 * (lo0 + hi0))
    return RootResult(root=root, converged=bracketed, bracketed=bracketed,
                      iterations=n_iter)
