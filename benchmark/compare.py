"""The plain reference over what a run's window produced, and the numbers
that decide `correct`.

The reference is `benchmark/reference`, a frozen copy of the program's
plain PyTorch path (its CPU path, the kernel branches taken out), run on
the card in float32. It rebuilds from the benchmark's own inputs whatever
the program's set-up derived from them: the prepared parameters, the node
geometry, the water-table curves and the initial state.

What is compared (the configuration's "check"):
- with `sample_cells`, a sample of that many cells drawn from the seed,
  every record of the checked block and its final state (cells whose
  columns share nothing, so a sample's columns are the whole batch's);
- with `records`, every cell and the first that many records of the block
  (cells whose solves stop on tests over the whole batch: the reference
  runs the whole batch, so its stops are the program's); with
  `last_records` besides, the block's last that many records and its
  final state too, which the reference steps from the program's own state
  before them (the records between are the same step and are not
  followed: the reference's plain node solve is too slow for them).

The numbers, each with its limit in the configuration's "limits":
- out_rel_max: the largest gap of an output value (every OUTVAR but
  OUT_WATER_ERROR) from the reference's, relative to the reference's value
  with a floor of REL_FLOOR of the variable's largest magnitude;
- out_off_share: the share of those values whose relative gap passes
  OFF_TOL;
- water_error_gap_mm: the largest gap of OUT_WATER_ERROR, in mm;
- state_off_share: as out_off_share over every field of the block's
  final state (only where the block's final state is compared). The
  state's largest relative gap is not compared: its flags (snow present,
  melting) are 0 or 1, so one flag that a sound run tips the other way
  reads as large a gap as the control does.
A value that is NaN on one side only counts as an infinite gap.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from . import gen
from .reference import config as ref_config
from .reference import model as ref_model
from .reference import prepare as ref_prepare
from .reference import state as ref_state
from .reference import timeaxis as ref_timeaxis
from .reference.physics import frozen_soil as ref_frozen
from .reference.physics import hydrology_misc as ref_hydro

REL_FLOOR = 1e-3
OFF_TOL = 1e-3
WATER_ERROR = "OUT_WATER_ERROR"


def global_fields(cfg: dict, traffic: dict, n_rec: int) -> dict:
    """The GlobalParams fields of a cell (both sides build theirs from
    them)."""
    y, m, d = traffic["start"]
    return dict(cfg["global_params"], startyear=y, startmonth=m, startday=d,
                nrecs=n_rec)


def check_cells(cfg: dict, traffic: dict, seed: int):
    """The cells compared: a sorted sample drawn from the seed, or None for
    every cell."""
    n = cfg["check"].get("sample_cells")
    if not n or n >= traffic["n_cell"]:
        return None
    rng = np.random.default_rng(gen.run_seeds(seed)[2])
    return np.sort(rng.choice(traffic["n_cell"], n, replace=False))


def check_records(cfg: dict, traffic: dict) -> int:
    n = traffic["block_records"]
    return min(cfg["check"].get("records") or n, n)


def check_tail(cfg: dict, traffic: dict) -> int:
    """The block's last records compared from the program's own state
    before them: 0 where the first records compared are the whole block."""
    return min(cfg["check"].get("last_records") or 0,
               traffic["block_records"] - check_records(cfg, traffic))


def domain_subset(domain, cells):
    """The domain's cells `cells`: every per-cell array sliced."""
    if cells is None:
        return domain
    n = domain.n_cell

    def cut(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name)[cells]
            for f in dataclasses.fields(obj) if f.init
            and isinstance(getattr(obj, f.name), np.ndarray)
            and getattr(obj, f.name).shape[:1] == (n,)})
    return dataclasses.replace(domain, soil=cut(domain.soil),
                               hru=cut(domain.hru), bands=cut(domain.bands),
                               cell_valid=domain.cell_valid[cells])


def lower_precision(obj):
    """obj with every float32 tensor in bfloat16 (the control's precision:
    the nearest below the float32 the configuration states)."""
    def low(t):
        return (t.to(torch.bfloat16) if isinstance(t, torch.Tensor)
                and t.dtype == torch.float32 else t)
    if isinstance(obj, dict):
        return {k: low(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: low(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return low(obj)


def run_reference(cfg: dict, traffic: dict, domain, forcing, device,
                  cells=None, n_rec=None, lower=False, first=0, start=None):
    """The reference over the compared cells and the records [first,
    first + n_rec) of the block: (outputs as {name: [n_rec, n, ...]
    float32 array}, final state as {field: array}). start: the state
    before record `first` as {field: array} (state_arrays of the
    program's), else the cold start; lower: run it in bfloat16 (the
    control)."""
    n_rec = n_rec or traffic["block_records"]
    gp = ref_config.GlobalParams(**global_fields(cfg, traffic, n_rec))
    dom = domain_subset(domain, cells)
    forc = {k: (v[first:first + n_rec] if cells is None
                else v[first:first + n_rec, cells])
            for k, v in forcing.items()}
    params = ref_prepare.prepare_domain(dom, gp, device)
    geom = (ref_frozen.build_node_geometry(dom.soil, gp).to(device)
            if gp.frozen_soil or not gp.quick_flux else None)
    zwt = ref_hydro.zwt_curves_to(ref_hydro.build_zwt_curves(dom.soil),
                                  device)
    state = ref_state.initial_state(dom, gp, device, geom=geom)
    if start is not None:
        state = state_from_arrays(state, start)
    ax = ref_timeaxis.make_time_axis(gp.startyear, gp.startmonth,
                                     gp.startday, 0, first + n_rec, gp.dt)
    stack = ref_model.make_forcing_stack(forc, ax, device)
    stack["month"] = stack["month"][first:]
    stack["day_in_year"] = stack["day_in_year"][first:]
    if lower:
        params, state, zwt, stack = map(lower_precision,
                                        (params, state, zwt, stack))
        geom = lower_precision(geom) if geom is not None else None
    step = ref_model.make_step(params, gp, geom, zwt,
                               outvars=cfg["outvars"])
    per_rec = []
    with torch.no_grad():
        for i in range(n_rec):
            state, outs = step(state, {k: v[i] for k, v in stack.items()})
            per_rec.append({k: v.float().cpu() for k, v in outs.items()})
    outs = {k: torch.stack([o[k] for o in per_rec]).numpy()
            for k in per_rec[0]}
    final = state_arrays(state)
    del step, params, geom, zwt, stack, state, per_rec
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return outs, final


def state_from_arrays(state, arrays: dict):
    """The reference's state with every field that `arrays` holds taken
    from it, in the field's own type and place."""
    return dataclasses.replace(state, **{
        f.name: torch.as_tensor(arrays[f.name]).to(
            dtype=getattr(state, f.name).dtype,
            device=getattr(state, f.name).device)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
        and f.name in arrays})


def state_arrays(state, cells=None) -> dict:
    """{field: float64 host array} of a model state's tensors, at `cells`."""
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if not isinstance(t, torch.Tensor):
            continue
        if cells is not None:
            t = t[torch.as_tensor(cells, device=t.device)]
        out[f.name] = t.detach().to(torch.float64).cpu().numpy()
    return out


def rel_gaps(got: dict, ref: dict, names):
    """(largest relative gap, share of values off by more than OFF_TOL)
    over the arrays `names` of got and ref."""
    worst, off, total = 0.0, 0, 0
    for k in names:
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        if g.shape != r.shape:
            return float("inf"), 1.0
        gap = relative_gap(g, r)
        worst = max(worst, float(gap.max()) if gap.size else 0.0)
        off += int((gap > OFF_TOL).sum())
        total += gap.size
    return worst, (off / total if total else 0.0)


def relative_gap(g, r):
    """|g - r| / max(|r|, REL_FLOOR * max|r|) elementwise; NaN on one side
    only is an infinite gap, on both sides none."""
    nan_g, nan_r = np.isnan(g), np.isnan(r)
    finite = ~(nan_g | nan_r)
    scale = np.abs(r[finite]).max() if finite.any() else 0.0
    floor = max(REL_FLOOR * scale, np.finfo(np.float32).tiny)
    gap = np.zeros(g.shape)
    gap[finite] = (np.abs(g[finite] - r[finite])
                   / np.maximum(np.abs(r[finite]), floor))
    gap[nan_g ^ nan_r] = np.inf
    return gap


def numbers(prog_out: dict, ref_out: dict, prog_state=None,
            ref_state_=None) -> dict:
    """The compared numbers of a checked block (see the module's
    docstring)."""
    names = sorted(k for k in ref_out if k != WATER_ERROR)
    missing = set(ref_out) - set(prog_out)
    if missing:
        return {"out_rel_max": float("inf"), "out_off_share": 1.0,
                "water_error_gap_mm": float("inf")}
    rmax, roff = rel_gaps(prog_out, ref_out, names)
    we_g = np.asarray(prog_out[WATER_ERROR], np.float64)
    we_r = np.asarray(ref_out[WATER_ERROR], np.float64)
    if we_g.shape != we_r.shape:
        we = float("inf")
    else:
        d = np.abs(we_g - we_r)
        d[np.isnan(we_g) ^ np.isnan(we_r)] = np.inf
        we = float(np.nanmax(d)) if d.size else 0.0
    out = {"out_rel_max": rmax, "out_off_share": roff,
           "water_error_gap_mm": we}
    if prog_state is not None and ref_state_ is not None:
        fields = sorted(ref_state_)
        if set(fields) - set(prog_state):
            out.update(state_off_share=1.0)
        else:
            out.update(state_off_share=rel_gaps(prog_state, ref_state_,
                                                fields)[1])
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(k in nums and nums[k] <= lim for k, lim in limits.items())
