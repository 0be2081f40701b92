"""Fixed-count bisection on the snowpack and bare-glacier residuals.

vic_tpu's `batched_bisection` (`vic_tpu/ops/rootfind.py:210`) takes any
callable; its port, `ops.rootfind.batched_bisection`, does too and runs on
any device. A CUDA kernel cannot take a Python callable, so the bisection
kernel (`kernels.bisection`, `csrc/bisection.cu`) runs the residuals the
kernel library compiles: the snowpack surface balance
(`snow.snow_energy_terms(t).rest`, with SPATIAL_SNOW's advected sensible
heat where `snow_cover_fract` is given) and the bare-glacier one
(`glacier.glacier_energy_terms(t).rest`). `bisection` picks the plain
version for CPU tensors and the kernel for CUDA tensors. No step of either
package calls it.
"""
from __future__ import annotations

from .. import kernels
from ..ops.rootfind import batched_bisection
from .glacier import glacier_energy_terms
from .snow import snow_energy_terms

# residual name -> the plain residual's terms at t
RESIDUALS = {"snowpack": snow_energy_terms, "glacier": glacier_energy_terms}


def bisection_plain(residual, lo, hi, active, n_iter=40, *, dt, **inputs):
    """Plain version of the `bisection` kernel: batched_bisection on the
    named residual's `.rest` with `inputs`, inactive lanes masked."""
    if residual not in RESIDUALS:
        raise ValueError(f"bisection: residual {residual!r} is not one of "
                         f"{sorted(RESIDUALS)}")
    terms = RESIDUALS[residual]
    return batched_bisection(lambda t: terms(t, dt=dt, **inputs).rest, lo,
                             hi, n_iter, active=active)


def bisection(residual, lo, hi, active, n_iter=40, *, dt, **inputs):
    """`bisection_plain` for CPU tensors, the `bisection` kernel for CUDA
    tensors."""
    solve = bisection_plain if lo.device.type == "cpu" else kernels.bisection
    return solve(residual, lo, hi, active, n_iter, dt=dt, **inputs)
