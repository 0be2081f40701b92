"""Top-level run driver of the port: `python -m vic_tpu_torch -g <file>`.

A copy of `vic_tpu/driver.py` (the reference main program, vicNl.c:36-654:
init sequencing -> cell loop -> time loop -> state save -> output write)
on the port's step. Sequencing mirrors vicNl.c: read global params -> veg
library -> soil cells -> veg/band params per cell -> forcing ingest ->
initial state (cold or warm) -> records in chunks -> aggregate + write
outputs -> save state.

The parameters, forcing and cold-start state are built on the host; each
block of cells moves to the device, and the step (`model.make_step`) runs
there record by record, each record chunk's outputs moving back to the
host as it ends. Chunks start at the glacier mass-balance interval
boundaries, where the fit is taken and the accumulator reset.

With several devices (`devices=[...]`, `--device cuda:0,cuda:1`) each cell
block is split into equal shares, one a device (`parallel/sharding.py`),
each with its own step, and the shares' outputs and state are joined on the
host. Where the step stops a loop on a test over the whole batch
(CLOSE_ENERGY's pass loop; with QUICK_FLUX off the node sweep and the Brent
around it), each share runs its records in a host thread of its own, on a
CUDA stream of its own, and every such test is voted over the shares
(`parallel/votes.py`), so the split run takes the one-device run's
decisions; an error in one share aborts the others' votes and is raised.
Otherwise one host thread runs the records share by share.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import trace
from .config import GlobalParams, parse_global_param_file
from .params import Domain
from .timeaxis import TimeAxis, time_axis_from_params

@dataclass
class RunResult:
    outputs: dict          # aggregated [n_out, n_cell(, k)] host arrays
    final_state: object    # ModelState on the CPU
    timeaxis: TimeAxis
    elapsed_s: float       # the record loop over every cell block
    cell_steps_per_s: float
    gmb_results: list = None   # GmbResult per accumulation interval
    # seconds of each stage: "params" (parameter files), "forcing" (ingest
    # with MTCLIM), "run", "write" (outputs and state), each timed on the
    # host's clock inside its vic.driver.<stage> span
    stage_s: dict = None
    peak_device_bytes: int = 0
    forcing: dict = None   # the [n_rec, n_cell] host forcing the run used


@dataclass
class _Share:
    """One device's share of a cell block: its step, carried state, host
    forcing and, where the shares run in threads, CUDA stream."""
    device: torch.device
    step: object
    state: object
    forcing: dict
    stream: object = None


def load_domain(gp: GlobalParams) -> Domain:
    """Build the Domain from reference-format parameter files
    (vicNl.c:237-282 readSoilData + initializeCell)."""
    from .io.snowband import default_bands, read_snowband_file
    from .io.soil import read_soil_file
    from .io.veg import build_hru_params, read_veglib, read_vegparam_cell_tiles

    soil = read_soil_file(gp.soil_file, gp, max_cells=gp.max_cells)
    veglib = read_veglib(gp.veglib_file)
    tiles = read_vegparam_cell_tiles(gp.veg_file, gp)
    hru = build_hru_params(tiles, soil.gridcel, veglib, gp, soil.depth)
    if gp.snow_band > 1 and gp.snowband_file:
        bands = read_snowband_file(gp.snowband_file, soil, gp.snow_band)
    else:
        bands = default_bands(soil, 1)
    return Domain(soil=soil, veglib=veglib, hru=hru, bands=bands)


def load_forcing(gp: GlobalParams, domain: Domain, timeaxis: TimeAxis,
                 device="cpu") -> dict:
    """Read per-cell forcing files into float64 [n_rec, n_cell] arrays
    (read_forcing_data.c / read_atmos_data.c; file naming prefix_lat_lng
    from make_in_and_outfiles.c:13). Daily PREC/TMAX/TMIN sets go through
    MTCLIM and the disaggregation, whose solar geometry runs on `device`."""
    from .forcing.ingest import ingest_forcing
    return ingest_forcing(gp, domain, timeaxis, device)


def load_state_any(path: str, gp, domain, template):
    """Warm-start state from a state file of any format (the reference's
    ASCII or BINARY, NetCDF in the reference's or vic_tpu's schema, npz),
    the format sniffed from the file's first bytes
    (io.state_io.load_state)."""
    from .io.state_io import load_state
    return load_state(path, gp, template, domain)


def batch_wide_stops(gp) -> bool:
    """Whether the step stops a loop on a test over the whole batch:
    CLOSE_ENERGY's pass loop, or with QUICK_FLUX off the node sweep and
    the Brent around it."""
    return bool(gp.close_energy or not gp.quick_flux)


def _on(device, stream=None):
    """A context that makes `device` the current CUDA device (the kernels'
    occupancy queries and launches follow it) and `stream`, if given, its
    current stream; nothing for the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if stream is not None:
        stack.enter_context(torch.cuda.stream(stream))
    return stack


def _synchronize(shares):
    """Waits for all the work of every CUDA device the shares run on."""
    for dev in dict.fromkeys(sh.device for sh in shares):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_simulation(gp: GlobalParams, domain: Optional[Domain] = None,
                   forcing: Optional[dict] = None,
                   init_state_path: Optional[str] = None,
                   initial=None,
                   chunk_recs: int = 0, chunk_cells: int = 0,
                   write_output: bool = True,
                   progress: bool = True, device="cuda",
                   devices=None) -> RunResult:
    """Execute the full simulation on `device` (the CUDA device unless the
    caller names another). domain/forcing default to file ingest per the
    global parameter settings; `initial` is a ModelState to start from.

    chunk_recs: records per chunk (0 = all), besides the chunk starts at
    the glacier mass-balance interval boundaries. chunk_cells (or
    GlobalParams.cell_chunk / CELL_CHUNK): cap on the cells per block;
    larger domains run block by block, the last block padded with clones of
    its last cell so every block has one shape. The batch-wide stops (the
    node sweep's count, the CLOSE_ENERGY passes) run over each block, so a
    run matches vic_tpu's only with equal chunk_cells.
    devices: a list of devices, in place of `device`. With more than one,
    each block is padded with clones of its last cell to a multiple of
    their count and split into equal shares, device d taking the d-th
    (vic_tpu's cell mesh); the glacier mass-balance fit runs over the
    whole block, and the batch-wide stops (batch_wide_stops) over every
    share, each share in a thread and on a stream of its own (shares on
    one card divide its co-resident blocks between K6's and K7's
    cooperative grids). kernels.launches counts the launches of every
    device; peak_device_bytes is the largest device's peak."""
    from .cells import pad_cell_tree, slice_cell_tree, unpad_cell_tree
    from .model import make_forcing_stack, make_step
    from .output import aggregate_outputs
    from .physics.hydrology_misc import build_zwt_curves, zwt_curves_to
    from .parallel.sharding import (gather_cell_axis, pad_cells,
                                    shard_cell_axis)
    from .parallel.votes import ShareGroup
    from .prepare import lake_params_from_numpy, prepare_domain
    from .state import initial_state

    devs = [torch.device(d) for d in (devices or [device])]
    device = devs[0]
    on_cuda = device.type == "cuda"
    used = list(dict.fromkeys(devs))     # each device once
    stage_s = {}

    # NF sub-stepping: when SNOW_STEP < TIME_STEP the reference runs
    # snow/energy physics NF times per model step. The port, like vic_tpu,
    # runs the WHOLE column at SNOW_STEP resolution and aggregates outputs
    # back to the requested OUT_STEP.
    if gp.snow_step < gp.dt:
        if gp.out_step < gp.dt:
            gp = gp.replace(out_step=gp.dt)
        nf = gp.dt // gp.snow_step
        gp = gp.replace(dt=gp.snow_step,
                        nrecs=(gp.nrecs * nf if gp.nrecs > 0 else gp.nrecs))

    timeaxis = time_axis_from_params(gp)
    with trace.span("vic.driver.params"):
        t0 = time.perf_counter()
        if domain is None:
            domain = load_domain(gp)
        stage_s["params"] = time.perf_counter() - t0
    with trace.span("vic.driver.forcing"):
        t0 = time.perf_counter()
        if forcing is None:
            forcing = load_forcing(gp, domain, timeaxis, device)
        else:
            n_have = len(next(iter(forcing.values())))
            if n_have != timeaxis.nrecs:
                raise ValueError(
                    f"supplied forcing has {n_have} records but the time "
                    f"axis needs {timeaxis.nrecs} (dt={gp.dt} h after NF "
                    f"sub-stepping — pre-stacked forcing must be at "
                    f"SNOW_STEP resolution, or set snow_step == dt)")
        stage_s["forcing"] = time.perf_counter() - t0

    if gp.output_force:
        # OUTPUT_FORCE disaggregation-only mode (vicNl.c:420-490): run the
        # forcing pipeline and write disaggregated forcings, skip the model.
        return write_disaggregated_forcings(gp, domain, forcing, timeaxis)

    above_treeline = None
    if gp.compute_treeline:
        from .physics.hydrology_misc import (compute_treeline,
                                             july_avg_temperature)
        july_t = (domain.soil.avg_july_air_temp if gp.july_tavg_supplied
                  else july_avg_temperature(forcing["air_temp"],
                                            timeaxis.month))
        if np.isfinite(july_t).all():
            above_treeline = compute_treeline(july_t, domain.bands.tfactor)

    # host copies of every per-cell tree; each cell block moves to `device`
    params = prepare_domain(domain, gp, "cpu", above_treeline=above_treeline)
    geom = None
    if gp.frozen_soil or not gp.quick_flux:
        # the node profile drives the ground-heat method whenever QUICK_FLUX
        # is FALSE, frozen or not (func_surf_energy_bal.c:167-242)
        from .physics.frozen_soil import build_node_geometry
        geom = build_node_geometry(domain.soil, gp)
    zwt_curves = build_zwt_curves(domain.soil)

    lake_params = None
    if gp.lakes:
        if gp.lakeparam_file and os.path.exists(gp.lakeparam_file):
            from .io.lakeparam import read_lakeparam_file
            lp = read_lakeparam_file(gp.lakeparam_file, domain.soil, gp)
        else:
            from .physics.lake import make_lake_params
            lp = make_lake_params(domain.soil, gp)
        lake_params = lake_params_from_numpy(lp, "cpu")

    # cold-start surface temperature = first-step air temperature, clamped
    # >= -1 C inside initial_state (initialize_model_state.c:138-147)
    air0 = np.asarray(forcing["air_temp"])[0] if "air_temp" in forcing \
        else None
    state = initial_state(domain, gp, "cpu", surf_temp_init=air0,
                          lake_params=lake_params,
                          geom=geom.to("cpu") if geom is not None else None)
    if initial is not None:
        state = initial.to("cpu")
    elif gp.init_state and (init_state_path or gp.init_state_file):
        state = load_state_any(init_state_path or gp.init_state_file, gp,
                               domain, state)

    # output pruning: with an explicit OUTVAR configuration the step returns
    # only the requested variables (+ OUT_WATER_ERROR, always kept)
    outvars = None
    if gp.outfiles:
        outvars = {v for of in gp.outfiles for v in of.varnames}
    n_rec = timeaxis.nrecs

    # glacier mass-balance accumulation schedule: chunk boundaries at each
    # accumulation-interval start so we can fit + reset
    # (accumulateGlacierMassBalance.c)
    gmb_boundaries = set()
    use_gmb = gp.glacier_id >= 0 and gp.glacier_accum_start_year > 0
    if use_gmb:
        from .physics.gmb import GmbAccumulator
        probe = GmbAccumulator(gp)
        for r in range(n_rec - 1):
            if probe.boundary(int(timeaxis.year[r + 1]),
                              int(timeaxis.month[r + 1]),
                              int(timeaxis.day[r + 1])):
                gmb_boundaries.add(r + 1)

    chunk = chunk_recs if chunk_recs > 0 else n_rec
    starts = sorted(set(range(0, n_rec, chunk)) | gmb_boundaries)

    # cell blocks (vicNl.c:514-517): cells run in blocks of <= cc, the last
    # padded to cc with clone cells so every block has one shape; with n
    # devices a block is padded on to a multiple of n (n_run) and split
    n_cell_real = domain.n_cell
    cc = chunk_cells if chunk_cells > 0 else gp.cell_chunk
    cc = n_cell_real if cc <= 0 else min(cc, n_cell_real)
    n_dev = len(devs)
    # the shares vote on the batch-wide stops from threads of their own
    threaded = n_dev > 1 and batch_wide_stops(gp)
    n_run = pad_cells(cc, n_dev)
    n_share = n_run // n_dev
    check_memory_budget(gp, domain, chunk, n_cell=n_share,
                        progress=progress, device=device)
    if progress and n_dev > 1:
        print(f"  cells split over {n_dev} devices: {n_share} a device "
              f"({cc} a block, +{n_run - cc} pad)", file=sys.stderr)
    if progress and cc < n_cell_real:
        print(f"  cell chunking: {n_cell_real} cells in blocks of {cc}",
              file=sys.stderr)

    def run_block(b0, b1, st):
        """All records for cells [b0:b1): returns (final state on the CPU,
        outs np dict [n_rec, b1-b0, ...], gmb results)."""
        nb = b1 - b0
        n_pad = n_run - nb
        trees = [slice_cell_tree(t, b0, b1, n_cell_real)
                 for t in (params, geom, zwt_curves, lake_params)]
        frc = slice_cell_tree(forcing, b0, b1, n_cell_real, axis=1)
        st = slice_cell_tree(st, b0, b1, n_cell_real)
        if n_pad > 0:
            trees = [pad_cell_tree(t, nb, n_pad) for t in trees]
            st = pad_cell_tree(st, nb, n_pad)
            frc = pad_cell_tree(frc, nb, n_pad, axis=1)
        block_prm = trees[0]
        group = ShareGroup(n_dev, devs) if threaded else None
        shares = []
        for d, (dev, prm, gm, zw, lkp, s, f) in enumerate(zip(
                devs, *(shard_cell_axis(t, n_run, n_dev) for t in trees),
                shard_cell_axis(st, n_run, n_dev),
                shard_cell_axis(frc, n_run, n_dev, axis=1))):
            with _on(dev):
                prm = prm.to(dev)
                gm = gm.to(dev) if gm is not None else None
                zw = zwt_curves_to(zw, dev)
                lkp = lkp.to(dev) if lkp is not None else None
                step = make_step(prm, gp, gm, zw, lkp, outvars=outvars,
                                 votes=group.member(d) if group else None)
                stream = (torch.cuda.Stream(dev)
                          if threaded and dev.type == "cuda" else None)
                shares.append(_Share(dev, step, s.to(dev), f, stream))
        try:
            return run_shares(shares, group, block_prm, b0, b1)
        finally:
            if group is not None:
                group.close()

    def run_records(sh, stack, rec, n):
        """Share sh's records 0..n of `stack`, its outputs into rec."""
        with _on(sh.device, sh.stream):
            for i in range(n):
                sh.state, outs = sh.step(
                    sh.state, {k: v[i] for k, v in stack.items()})
                rec.append(outs)

    def run_shares(shares, group, block_prm, b0, b1):
        """The records of the shares of cells [b0:b1), chunk by chunk
        (run_block)."""
        nb = b1 - b0
        gmb = None
        if use_gmb:
            from .physics.gmb import GmbAccumulator
            gmb = GmbAccumulator(gp)
        all_outs = []
        for si, start in enumerate(starts):
            end = starts[si + 1] if si + 1 < len(starts) else n_rec
            sub_ax = TimeAxis(*[a[start:end] for a in
                                (timeaxis.year, timeaxis.month, timeaxis.day,
                                 timeaxis.hour, timeaxis.day_in_year)])
            stacks = [make_forcing_stack(
                {k: v[start:end] for k, v in sh.forcing.items()}, sub_ax,
                sh.device) for sh in shares]
            recs = [[] for _ in shares]
            if group is not None:
                # each share in its thread, on its stream, voting the
                # batch-wide stops with the others; the default streams'
                # work (the block's move, the stacks) done before, theirs
                # after
                group.restart()
                _synchronize(shares)
                group.run([
                    (lambda sh=sh, stack=stack, rec=rec:
                     run_records(sh, stack, rec, end - start))
                    for sh, stack, rec in zip(shares, stacks, recs)])
                _synchronize(shares)
            else:
                # record by record, device by device, with no
                # synchronization: a device runs its record while the host
                # launches the next's
                for i in range(end - start):
                    for sh, stack, rec in zip(shares, stacks, recs):
                        with _on(sh.device):
                            sh.state, outs = sh.step(
                                sh.state,
                                {k: v[i] for k, v in stack.items()})
                        rec.append(outs)
            # keys sorted, as vic_tpu's scan returns its output dict (a
            # pytree): the writers' variable order follows them
            with trace.span("vic.driver.copy"):
                outs = gather_cell_axis(
                    [{k: torch.stack([o[k] for o in rec]).cpu().numpy()
                      for k in sorted(rec[0])} for rec in recs], n_share,
                    axis=1)
            all_outs.append({k: a[:, :nb] if a.ndim >= 2
                             and a.shape[1] == n_run else a
                             for k, a in outs.items()})
            if gmb is not None and end in gmb_boundaries | {n_rec}:
                # the fit over the whole block, every device's cells
                cum = gather_cell_axis(
                    [sh.state.glac_cum_mass_balance for sh in shares],
                    n_share)
                res = gmb.maybe_emit(
                    timeaxis, end - 1, cum[:nb].numpy(),
                    block_prm.band_elev[:nb].numpy(),
                    block_prm.is_glacier[:nb].numpy())
                if res is not None:
                    for sh in shares:
                        sh.state = dataclasses.replace(
                            sh.state, glac_cum_mass_balance=torch.zeros_like(
                                sh.state.glac_cum_mass_balance))
                    if progress:
                        print(f"  GMB fit at {res.date}: b0={res.b0}, "
                              f"b1={res.b1}, b2={res.b2}", file=sys.stderr)
            if progress:
                print(f"  cells {b0}..{b1} records {start}..{end} done",
                      file=sys.stderr)
        st = unpad_cell_tree(
            gather_cell_axis([sh.state for sh in shares], n_share), n_run,
            nb)
        outs = {k: np.concatenate([o[k] for o in all_outs], axis=0)
                for k in all_outs[0]}
        return st, outs, gmb.results if gmb is not None else []

    if on_cuda:
        for d in used:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    block_states, block_outs, gmb_results = [], [], []
    with trace.span("vic.driver.run"):
        t0 = time.perf_counter()
        for b0 in range(0, n_cell_real, cc):
            with trace.span("vic.driver.block"):
                bst, bouts, bres = run_block(b0, min(b0 + cc, n_cell_real),
                                             state)
            block_states.append(bst)
            block_outs.append(bouts)
            gmb_results.extend(bres)
        if on_cuda:
            for d in used:
                torch.cuda.synchronize(d)
        elapsed = time.perf_counter() - t0
    stage_s["run"] = elapsed
    peak = max(torch.cuda.max_memory_allocated(d) for d in used) \
        if on_cuda else 0

    if len(block_states) == 1:
        state = block_states[0]
        outs = block_outs[0]
    else:
        state = dataclasses.replace(block_states[0], **{
            f.name: torch.cat([getattr(s, f.name) for s in block_states])
            for f in dataclasses.fields(block_states[0])})
        outs = {k: np.concatenate([o[k] for o in block_outs], axis=1)
                for k in block_outs[0]}
    steps_per_out = max(1, gp.out_step // gp.dt)
    agg = aggregate_outputs(outs, steps_per_out, alma=gp.alma_output,
                            out_dt_sec=gp.out_step * 3600.0)

    if progress and on_cuda:
        print(f"  peak device memory: {peak / 1e9:.2f} GB", file=sys.stderr)

    with trace.span("vic.driver.write"):
        t0 = time.perf_counter()
        if write_output:
            write_outputs(gp, domain, timeaxis, agg, steps_per_out)

        if gp.save_state and gp.state_name:
            from .io.state_io import save_state
            date = (int(timeaxis.year[-1]), int(timeaxis.month[-1]),
                    int(timeaxis.day[-1]))
            save_state(_state_path(gp, date), state, gp, domain, date=date,
                       fmt=gp.state_format, geom=geom,
                       lake_params=lake_params)
        stage_s["write"] = time.perf_counter() - t0

    n_cell = domain.n_cell
    return RunResult(outputs=agg, final_state=state, timeaxis=timeaxis,
                     elapsed_s=elapsed,
                     cell_steps_per_s=n_cell * n_rec / max(elapsed, 1e-9),
                     gmb_results=gmb_results, stage_s=stage_s,
                     peak_device_bytes=peak, forcing=forcing)


def write_disaggregated_forcings(gp, domain, forcing, timeaxis) -> RunResult:
    """OUTPUT_FORCE mode: emit the disaggregated forcing set
    (write_forcing_file.c), chunked over time (DISAGG_WRITE_CHUNK_SIZE)."""
    t0 = time.perf_counter()
    from .forcing.mtclim import svp_mtclim
    outs = {
        "OUT_PREC": forcing["prec"],
        "OUT_AIR_TEMP": forcing["air_temp"],
        "OUT_SHORTWAVE": forcing["shortwave"],
        "OUT_LONGWAVE": forcing["longwave"],
        "OUT_PRESSURE": forcing["pressure"] / 1000.0,
        "OUT_VP": forcing["vp"] / 1000.0,
        "OUT_DENSITY": forcing["density"],
        "OUT_WIND": forcing["wind"],
        "OUT_REL_HUMID": 100.0 * forcing["vp"]
        / np.maximum(svp_mtclim(forcing["air_temp"]), 1e-10),
    }
    lats, lons = domain.soil.lat, domain.soil.lng
    n_rec = timeaxis.nrecs
    if gp.output_format.upper() == "NETCDF":
        from .output import NetCDFOutputWriter
        path = os.path.join(gp.result_dir, gp.netcdf_output_filename)
        w = NetCDFOutputWriter(path, lats, lons, list(outs.keys()),
                               nlayer=gp.nlayer,
                               compress=5 if gp.compress else 0)
        chunk = max(1, gp.disagg_write_chunk_size)
        tvals = np.arange(n_rec, dtype=float) * (gp.dt / 24.0)
        for start in range(0, n_rec, chunk):
            end = min(start + chunk, n_rec)
            sub = {k: v[start:end] for k, v in outs.items()}
            w.write_all(sub, tvals[start:end])
        w.close()
    else:
        from .output import AsciiOutputWriter
        w = AsciiOutputWriter(gp.result_dir, "full_data", lats, lons,
                              list(outs.keys()),
                              grid_decimal=gp.grid_decimal,
                              compress=gp.compress)
        w.write_all(outs, timeaxis)
        w.close()
    elapsed = time.perf_counter() - t0
    return RunResult(outputs=outs, final_state=None, timeaxis=timeaxis,
                     elapsed_s=elapsed,
                     cell_steps_per_s=domain.n_cell * n_rec
                     / max(elapsed, 1e-9), gmb_results=[])


def _state_path(gp, date):
    y, m, d = date
    suffix = f"_{y:04d}{m:02d}{d:02d}"
    base = gp.state_name
    if gp.state_format.upper() == "NETCDF" and not base.endswith(".nc"):
        return base + suffix + ".nc"
    return base + suffix


def check_memory_budget(gp, domain, chunk_recs, n_cell=None, progress=True,
                        device="cpu"):
    """Device memory estimate (vicNl.c:218-235 MAX_MEMORY governor).

    The reference warns when cells * 96 kB exceeds MAX_MEMORY GB. Here the
    dominant terms are the carried state, the device-resident forcing chunk
    and the chunk's stacked outputs; a 2x factor covers temporaries. Warns
    (never aborts) with a suggested --chunk, against MAX_MEMORY or else the
    CUDA device's memory. n_cell overrides the domain cell count (a cell
    block's budget)."""
    if n_cell is None:
        n_cell = domain.n_cell
    max_hru = domain.hru.mask.shape[1]
    nl, nn = gp.nlayer, max(gp.nnode, 3)
    state_b = n_cell * max_hru * (4 * (30 + 6 * nl + nn))
    forcing_b = chunk_recs * n_cell * 9 * 4
    outputs_b = chunk_recs * n_cell * (90 + 3 * nl + nn) * 4
    est_gb = 2.0 * (state_b + forcing_b + outputs_b) / 1e9

    budget_gb = gp.max_memory if gp.max_memory > 0 else None
    if budget_gb is None and torch.device(device).type == "cuda":
        budget_gb = torch.cuda.get_device_properties(
            torch.device(device)).total_memory / 1e9
    if budget_gb and est_gb > budget_gb and progress:
        good_chunk = max(1, int(chunk_recs * budget_gb / max(est_gb, 1e-9)))
        print(f"WARNING: estimated device memory {est_gb:.2f} GB exceeds "
              f"budget {budget_gb:.2f} GB "
              f"(MAX_MEMORY governor, vicNl.c:218-235); "
              f"consider --chunk {good_chunk}", file=sys.stderr)
    return est_gb


def write_outputs(gp, domain, timeaxis, agg, steps_per_out):
    """Dispatch to the configured output format (WriteOutputContext.c)."""
    var_names = list(agg.keys())
    if gp.outfiles:
        sel = [v for of in gp.outfiles for v in of.varnames]
        var_names = [v for v in var_names if v in sel] or var_names
    lats, lons = domain.soil.lat, domain.soil.lng
    n_out = len(next(iter(agg.values())))
    out_ax = TimeAxis(*[a[::steps_per_out][:n_out] for a in
                        (timeaxis.year, timeaxis.month, timeaxis.day,
                         timeaxis.hour, timeaxis.day_in_year)])

    if gp.output_format.upper() == "NETCDF":
        from .io import native
        if not native.netcdf_found():
            raise RuntimeError("NETCDF output requested but libnetcdf "
                               "missing")
        path = os.path.join(gp.result_dir, gp.netcdf_output_filename)
        # output-interval timestamps (days since simulation start)
        tvals = np.arange(n_out, dtype=float) * (gp.out_step / 24.0)
        kw = dict(nlayer=gp.nlayer, nnode=max(gp.nnode, 3),
                  nband=max(gp.snow_band, 1),
                  global_attrs=dict(gp.netcdf_attributes),
                  compress=5 if gp.compress else 0)
        # the parser keeps NETCDF_OUTPUT_SHARDS as text (vic_tpu's keyword
        # table lists it with the paths)
        n_shards = int(gp.output_shards)
        if n_shards > 1:
            # one file a block of cells (parallel/io_shards.py); merge with
            # tools/merge_output_shards_torch.py
            from .parallel.io_shards import write_sharded_netcdf
            write_sharded_netcdf(path, lats, lons,
                                 {v: agg[v] for v in var_names}, tvals,
                                 n_shards, **kw)
            return
        from .output import NetCDFOutputWriter
        w = NetCDFOutputWriter(path, lats, lons, var_names, **kw)
        w.write_all(agg, tvals)
    elif gp.output_format.upper() == "BINARY":
        from .output import BinaryOutputWriter
        w = BinaryOutputWriter(gp.result_dir, "fluxes", lats, lons, var_names,
                               grid_decimal=gp.grid_decimal, nrecs=n_out,
                               out_dt=gp.out_step if gp.out_step else gp.dt,
                               start_date=(int(out_ax.year[0]),
                                           int(out_ax.month[0]),
                                           int(out_ax.day[0]),
                                           int(out_ax.hour[0])),
                               alma_output=gp.alma_output,
                               outvar_specs=gp.outvar_specs)
        w.write_all(agg, out_ax)
    else:
        from .output import AsciiOutputWriter
        w = AsciiOutputWriter(gp.result_dir, "fluxes", lats, lons, var_names,
                              grid_decimal=gp.grid_decimal,
                              compress=gp.compress)
        w.write_all(agg, out_ax)
    w.close()


def run_main(argv=None) -> Optional[RunResult]:
    """The CLI (cmd_proc.c: vicNl -g <global-file>): parses `argv`, runs,
    prints the run's summary and returns its RunResult (None for -v/-o)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="vic_tpu_torch",
        description="VIC-GL hydrologic model, PyTorch/CUDA port")
    ap.add_argument("-g", "--global-file",
                    help="global parameter file (reference grammar)")
    ap.add_argument("-o", "--options", action="store_true",
                    help="print run options and exit (display_current_settings)")
    ap.add_argument("-v", "--version", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help="records per chunk (device memory bound)")
    ap.add_argument("--cell-chunk", type=int, default=0,
                    help="max cells per block; larger domains run block "
                         "by block")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the step (default cuda), or a "
                         "comma-separated list (cuda:0,cuda:1) to split "
                         "the cells over")
    args = ap.parse_args(argv)

    if args.version:
        from . import __version__
        print(f"vic_tpu_torch {__version__}")
        return None
    if not args.global_file:
        ap.error("the following arguments are required: -g/--global-file")
    gp = parse_global_param_file(args.global_file)
    if args.options:
        for k, v in sorted(vars(gp).items()):
            print(f"{k:32s} {v}")
        return None
    res = run_simulation(gp, chunk_recs=args.chunk,
                         chunk_cells=args.cell_chunk,
                         devices=args.device.split(","))
    print(f"Model execution time: {res.elapsed_s:.3f} s "
          f"({res.cell_steps_per_s:.0f} cell-steps/s)", file=sys.stderr)
    return res


def main(argv=None) -> int:
    """`python -m vic_tpu_torch`: run_main, exit status 0."""
    run_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
