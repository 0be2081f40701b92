"""The roofline of the program's kernel calls: the table of peaks and the
bytes and FP32 operations a call needs, whatever implements it.

A frozen copy of `chip_smoke.py`'s arithmetic (`nbytes`, `bound`,
`brent_work`, `fd_brent_work`, `runoff_work`, `sweep_ops`, `sweep_work`
and their operation counts), with one change: every byte is counted once.
A call's bytes are the distinct elements of every tensor it is handed and
of every tensor it returns, each read or written once; the smoke's
`streamed` charged the node sweeps' repeated passes beyond the L2 cache.
The operations are the least these inputs need, whatever implements the
call, and never the call's own iteration, solve or sweep counts: a root
solve on a lane that needs one is charged its two bracket ends and one
step (MIN_SOLVE_EVALS residual evaluations), a node profile one sweep, and
each lane the evaluations its outputs are formed from (EXTRA_EVALS). A
call that iterates less is then faster against the same charge.

`work(name, args, kwargs, result)` gives (bytes, operations) of one call
of `vic_tpu_torch.kernels.<name>`, or None for a kernel this arithmetic
cannot count; such calls are left out of both sums of the roofline.
"""
from __future__ import annotations

import dataclasses

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MIN_SOLVE_EVALS = 3               # a root solve: two bracket ends, one step
MIN_SWEEPS = 1                    # a node profile: one sweep over its nodes
# FP32 operations (+ - * / and each libm call counted as one) of one
# residual evaluation plus one Brent iteration's own ~30, counted from the
# residuals of the kernels' sources
RESIDUAL_OPS = {"glacier_brent": 55 + 30, "snowpack_brent": 55 + 30,
                "canopy_brent": 70 + 30, "surface_brent": 150 + 30}
FUSION_OPS = 20                   # the fusion term of K5 and K7
RUNOFF_OPS_PER_LAYER_HOUR = 30
RUNOFF_ARNO_OPS = 30              # the infiltration curve, 3 powf
SWEEP_OPS_PER_NODE = 20           # t_lin and the bookkeeping
NODE_RESIDUAL_OPS = 30            # SoilThermalEqn with its unfrozen water
FD_RESIDUAL_OPS = 150 + FUSION_OPS + 30
DRY_ET_OPS = 20 + 10 * 3          # DIST_PRCP's dry column in a residual
MIN_SWQ_EB_THRES = 0.0010         # m: K2 leaves thinner packs unsolved
# residual evaluations on every lane besides the solve: K5's terms at the
# root, K1's and K2's at 0 C and at the accepted temperature
EXTRA_EVALS = {"surface_brent": 1, "snowpack_brent": 2, "glacier_brent": 2}


def bound_s(bytes_moved: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the FP32 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def tensors_in(obj, seen=None):
    """Every tensor reachable from obj through tuples, lists, dicts and
    dataclasses."""
    if seen is None:
        seen = []
    if isinstance(obj, torch.Tensor):
        seen.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            tensors_in(v, seen)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            tensors_in(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            tensors_in(getattr(obj, f.name), seen)
    return seen


def distinct_bytes(tensors) -> int:
    """Bytes of the distinct elements of the tensors, each once: a view
    broadcast along an axis (stride 0) holds one element along it, and a
    tensor handed twice counts once."""
    keys = set()
    total = 0
    for t in tensors:
        shape = tuple(t.shape)
        stride = tuple(t.stride())
        key = (t.data_ptr(), shape, stride, t.dtype)
        if key in keys:
            continue
        keys.add(key)
        n = 1
        for size, st in zip(shape, stride):
            if st != 0:
                n *= size
        total += n * t.element_size()
    return total


def call_bytes(args, kwargs, result) -> int:
    """Each input byte of a call read once, each output byte written once."""
    return (distinct_bytes(tensors_in((args, kwargs)))
            + distinct_bytes(tensors_in(result)))


def brent_evals(name, active, kwargs, res) -> float:
    """Residual evaluations one lane-Brent call (K1, K2, K3, K5) needs at
    the least: MIN_SOLVE_EVALS on the lanes of `active` (every lane where
    it is None) that need a solve, and the terms' evaluations on every
    lane. K1 and K2 take the lanes that melt at 0 C (the answer's
    `melt_cond`, the same from any implementation) and K2 its thin packs
    (an input) out of the solve."""
    shape = res.root.shape
    act = (torch.ones(shape, dtype=torch.bool, device=res.root.device)
           if active is None else active.expand(shape))
    if name in ("snowpack_brent", "glacier_brent"):
        act = act & ~res.melt_cond
    if name == "snowpack_brent":
        act = act & ~(kwargs["surface_swq"] <= MIN_SWQ_EB_THRES).expand(shape)
    return (float(act.sum()) * MIN_SOLVE_EVALS
            + res.root.numel() * EXTRA_EVALS.get(name, 0))


def sweep_ops(t0, fs_active, nlayer) -> float:
    """FP32 operations of one sweep: every interior node, plus the residual
    evaluations of the nodes below 0 C where frozen soil is active (2 for
    nodes above the soil-layer count, 2 + 16 for deeper nodes)."""
    nn = t0.shape[-1]
    cold = (t0[..., 1:nn - 1] < 0.0) & fs_active.reshape(
        fs_active.shape + (1,) * (t0.dim() - fs_active.dim()))
    evals = torch.where(torch.arange(1, nn - 1, device=t0.device) < nlayer,
                        2.0, 18.0)
    return (t0[..., 0].numel() * (nn - 2) * SWEEP_OPS_PER_NODE
            + float((cold * evals).sum()) * NODE_RESIDUAL_OPS)


def work(name, args, kwargs, result):
    """(bytes, FP32 operations) of one call of kernels.<name>, or None."""
    if name in ("glacier_brent", "snowpack_brent", "canopy_brent"):
        ops = brent_evals(name, args[2], kwargs, result) * RESIDUAL_OPS[name]
    elif name == "surface_brent":
        kw = kwargs["eb_kwargs"]
        per_eval = RESIDUAL_OPS[name] + (FUSION_OPS if kw.get("frozen_soil")
                                         else 0)
        if kw.get("dist_dry") is not None:
            per_eval += DRY_ET_OPS
        ops = brent_evals(name, args[2], kw, result) * per_eval
    elif name == "runoff_hourly":
        moist = result.moist
        dt_hours = args[-1] if len(args) == 15 else kwargs["dt_hours"]
        lanes, nl = moist[..., 0].numel(), moist.shape[-1]
        ops = lanes * (dt_hours * nl * RUNOFF_OPS_PER_LAYER_HOUR
                       + 2 * RUNOFF_ARNO_OPS)
    elif name == "node_sweep":
        t0, fs_active = args[0], args[7]
        ops = MIN_SWEEPS * sweep_ops(t0, fs_active, kwargs["nlayer"])
    elif name == "fd_surface_brent":
        # the batch-wide Brent: each of its residual evaluations solves the
        # node profile of every lane
        kw = kwargs["eb_kwargs"]
        solve = kw["fd_solve"]
        per_eval = FD_RESIDUAL_OPS + (DRY_ET_OPS if kw.get("dist_dry")
                                      is not None else 0)
        ops = MIN_SOLVE_EVALS * (
            result.root.numel() * per_eval
            + MIN_SWEEPS * sweep_ops(solve.t0, solve.fs_active,
                                     solve.nlayer))
    else:
        return None
    return call_bytes(args, kwargs, result), float(ops)
