"""Python bindings of the CUDA kernels (csrc/*.cu).

Each wrapper takes CUDA tensors only: it checks device and dtype, passes
each lane input of K1-K5, K7-K15 and K17 as its view broadcast to the lanes, a
data pointer and element strides (`_lane_inputs`, csrc/lanes.cuh), so no
input is copied, allocates the outputs, launches on the current stream,
raises if the launch was refused, and adds one to its entry of `launches`.
The plain PyTorch versions live beside each call site (physics/glacier.py,
snow.py, canopy_snow.py, runoff.py, surface.py, frozen_soil.py,
blowing_snow.py, canopy_air.py, lake.py, bisection.py); the call sites pick
one or the other by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.rootfind import MAXTRIES, RootResult
from . import build

# launches of each kernel since the last reset_launches(): calls of its
# wrapper that reached the device (K6's one call is 11 device launches at
# max_sweeps = 10: a sweep launch each and a finishing one; K7's one call is
# a whole Brent solve, a fixed sequence of launches with K6 calls inside)
launches = {"glacier_brent": 0, "snowpack_brent": 0, "canopy_brent": 0,
            "runoff_hourly": 0, "surface_brent": 0, "node_sweep": 0,
            "fd_surface_brent": 0, "blowing_snow": 0, "canopy_air_step": 0,
            "lake_open_water": 0, "lake_under_ice": 0, "lake_ice_brent": 0,
            "lake_depth": 0, "affine_surface_brent": 0, "mass_release": 0,
            "implicit_profile": 0, "bisection": 0}

# per-lane float inputs of each Brent residual, in the C functors' order
GLACIER_INPUTS = ("ra", "z_ref", "roughness", "air_dens", "vp_air",
                  "longwave_in", "lv", "pressure", "rain_m", "net_short",
                  "vpd", "wind", "old_tsurf", "ice_depth_mm", "tair")
SNOWPACK_INPUTS = ("ra", "z_ref", "roughness", "air_dens", "vp_air",
                   "longwave_in", "lv", "pressure", "rain_m", "net_short",
                   "vpd", "wind", "old_tsurf", "snow_depth", "snow_density",
                   "surf_water", "surface_swq", "tair", "tgrnd",
                   "blowing_flux", "snow_cover_fract")
# K2's flag: SPATIAL_SNOW's advected sensible heat in the residual
SNOWPACK_FLAGS = ("spatial",)
CANOPY_INPUTS = ("lai_ra_over", "air_dens", "vp_air", "pressure", "le",
                 "tcanopy", "vpd", "rainfall_m", "net_short_over",
                 "long_over_in", "long_under_out", "int_rain", "ra_plain",
                 "wdew_mm", "prec_mm", "wdmax_mm", "rarc", "elevation")
CANOPY_FLAGS = ("has_csnow",)


def reset_launches():
    for k in launches:
        launches[k] = 0


def _expand(x, shape, device, dtype, name):
    """x expanded to `shape` (a view); raises unless x is a tensor of
    `dtype` on `device` that broadcasts to `shape`."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    return x.expand(shape)


def _lanes(x, shape, device, dtype, name):
    """x expanded to `shape`, contiguous (see _expand)."""
    return _expand(x, shape, device, dtype, name).contiguous()


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _lane_inputs(items, shape, device):
    """The inputs of a K1-K5 kernel over the lanes `shape` ([n_cell,
    max_hru], or [n] as one cell) as csrc/lanes.cuh reads them. items:
    (name, tensor, dtype, nl), nl > 0 for an input with a trailing layer
    axis. Each input is broadcast to the lanes as a view and passed as its
    data pointer and its element strides along the cell, HRU and layer axes
    (0 along an axis it is broadcast over): nothing is copied. Returns (the
    views, pointer array, int32 stride array of 3 per input)."""
    if len(shape) not in (1, 2):
        raise ValueError(f"lanes must be [n_cell, max_hru], got {shape}")
    views, strides = [], []
    for name, x, dtype, nl in items:
        x = _expand(x, shape + ((nl,) if nl else ()), device, dtype, name)
        if len(shape) == 1:
            x = x.unsqueeze(0)
        views.append(x)
        strides += [x.stride(0), x.stride(1), x.stride(2) if nl else 0]
    return views, _ptrs(views), (ctypes.c_int32 * len(strides))(*strides)


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launches[name] += 1


def _brent_call(name, float_names, flag_names, lo, hi, active, inputs):
    """The lanes of a one-thread-per-lane root finder (K1-K3, K12, K17):
    returns (the views to keep alive; the C arguments from the float and
    mask inputs' pointers, strides and counts to the lanes per cell, lo and
    hi; the outputs, a RootResult; the lane count)."""
    device = lo.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, tuple(float_names) + tuple(flag_names))
    shape = torch.broadcast_shapes(lo.shape, hi.shape, active.shape)
    f32, flag = torch.float32, torch.bool
    lo_c = _lanes(lo, shape, device, f32, "lo")
    hi_c = _lanes(hi, shape, device, f32, "hi")
    fin, f_ptr, f_stride = _lane_inputs(
        [(k, inputs[k], f32, 0) for k in float_names], shape, device)
    masks, m_ptr, m_stride = _lane_inputs(
        [("active", active, flag, 0)]
        + [(k, inputs[k], flag, 0) for k in flag_names], shape, device)
    outs = RootResult(torch.empty(shape, dtype=f32, device=device),
                      torch.empty(shape, dtype=flag, device=device),
                      torch.empty(shape, dtype=flag, device=device),
                      torch.empty(shape, dtype=torch.int32, device=device))
    args = (f_ptr, f_stride, len(fin), m_ptr, m_stride, len(masks),
            shape[-1], lo_c.data_ptr(), hi_c.data_ptr())
    return (fin, masks, lo_c, hi_c), args, outs, outs.root.numel()


def _out_ptrs(outs):
    return tuple(t.data_ptr() for t in outs)


def _brent(name, float_names, flag_names, lo, hi, active, dt, max_iter,
           max_tries, inputs):
    _views, args, outs, n = _brent_call(name, float_names, flag_names, lo,
                                        hi, active, inputs)
    if n:
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = getattr(build.load(), name)(
            *args, float(dt), int(max_iter), int(max_tries), n,
            *_out_ptrs(outs), stream)
        _check_launch(name, err)
    return outs


def glacier_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K1: expand-then-Brent on the glacier surface residual, one thread per
    lane. Same arguments and result as physics.glacier.glacier_brent_plain
    (iterations per lane)."""
    return _brent("glacier_brent", GLACIER_INPUTS, (), lo, hi, active, dt,
                  max_iter, max_tries, inputs)


def _snowpack_inputs(inputs, device):
    """K2's inputs with SPATIAL_SNOW's coverage and flag: a zero and False
    on `device` where snow_cover_fract is None or not given."""
    scf = inputs.get("snow_cover_fract")
    return dict(inputs, snow_cover_fract=(
        torch.zeros((), dtype=torch.float32, device=device) if scf is None
        else scf), spatial=(torch.zeros if scf is None else torch.ones)(
            (), dtype=torch.bool, device=device))


def snowpack_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K2: expand-then-Brent on the snowpack surface residual, with
    SPATIAL_SNOW's advected sensible heat where snow_cover_fract is given.
    Same arguments and result as physics.snow.snowpack_brent_plain."""
    return _brent("snowpack_brent", SNOWPACK_INPUTS, SNOWPACK_FLAGS, lo, hi,
                  active, dt, max_iter, max_tries,
                  _snowpack_inputs(inputs, lo.device))


def canopy_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K3: expand-then-Brent on the canopy foliage residual. Same arguments
    and result as physics.canopy_snow.canopy_brent_plain."""
    return _brent("canopy_brent", CANOPY_INPUTS, CANOPY_FLAGS, lo, hi,
                  active, dt, max_iter, max_tries, inputs)


# K17's residuals: name -> (C code, float inputs, flags)
BISECTION_RESIDUALS = {"snowpack": (0, SNOWPACK_INPUTS, SNOWPACK_FLAGS),
                       "glacier": (1, GLACIER_INPUTS, ())}


def bisection(residual, lo, hi, active, n_iter=40, *, dt, **inputs):
    """K17: vic_tpu's fixed-count bisection (ops/rootfind.py:210) on one of
    the residuals the library compiles, "snowpack" (K2's, SPATIAL_SNOW's
    term where snow_cover_fract is given) or "glacier" (K1's), one thread
    per lane. Same arguments and result as
    physics.bisection.bisection_plain (iterations per lane: n_iter, 0 on
    inactive lanes)."""
    name = "bisection"
    if residual not in BISECTION_RESIDUALS:
        raise ValueError(f"{name}: residual {residual!r} is not one of "
                         f"{sorted(BISECTION_RESIDUALS)}")
    code, floats, flags = BISECTION_RESIDUALS[residual]
    if residual == "snowpack":
        inputs = _snowpack_inputs(inputs, lo.device)
    _views, args, outs, n = _brent_call(name, floats, flags, lo, hi, active,
                                        inputs)
    if n:
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = build.load().bisection(code, *args, float(dt), int(n_iter), n,
                                     *_out_ptrs(outs), stream)
        _check_launch(name, err)
    return outs


def mass_release(int_snow, temp_int_storage, n_iter=8):
    """K15: vic_tpu's 8-round canopy snow release (canopy_snow.py:126), one
    thread per lane. Same arguments and result as
    physics.canopy_snow.mass_release_plain: (int_snow, temp_int_storage,
    released, drip), each of the inputs' broadcast shape."""
    name = "mass_release"
    device = int_snow.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    shape = torch.broadcast_shapes(int_snow.shape, temp_int_storage.shape)
    f32 = torch.float32
    fin, f_ptr, f_stride = _lane_inputs(
        [("int_snow", int_snow, f32, 0),
         ("temp_int_storage", temp_int_storage, f32, 0)], shape, device)
    outs = tuple(torch.empty(shape, dtype=f32, device=device)
                 for _ in range(4))
    n = outs[0].numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().mass_release(
            f_ptr, f_stride, len(fin), shape[-1], int(n_iter), n,
            *_out_ptrs(outs), stream)
        _check_launch(name, err)
    return outs


def runoff_hourly(liq0, ice, evap_hr, resid_mm, max_moist, ksat_hr, expt,
                  dt_runoff, dt_inflow, dsmax_hr, ds, ws, c_expt,
                  dt_hours: int):
    """K4: the hourly drainage/baseflow loop, one thread per lane. Same
    arguments and result as physics.runoff.runoff_hourly_plain: layer
    arrays broadcast to [..., nl], the rest to [...]; returns
    (liq [..., nl], runoff_extra, baseflow)."""
    name = "runoff_hourly"
    device = liq0.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    layer = dict(liq0=liq0, ice=ice, evap_hr=evap_hr, resid_mm=resid_mm,
                 max_moist=max_moist, ksat_hr=ksat_hr, expt=expt)
    lane = dict(dt_runoff=dt_runoff, dt_inflow=dt_inflow, dsmax_hr=dsmax_hr,
                ds=ds, ws=ws, c_expt=c_expt)
    lshape = torch.broadcast_shapes(*(t.shape for t in layer.values()))
    shape = torch.broadcast_shapes(lshape[:-1],
                                   *(t.shape for t in lane.values()))
    lshape = shape + lshape[-1:]
    nl = lshape[-1]
    f32 = torch.float32
    fin, f_ptr, f_stride = _lane_inputs(
        [(k, t, f32, nl) for k, t in layer.items()]
        + [(k, t, f32, 0) for k, t in lane.items()], shape, device)
    liq = torch.empty(lshape, dtype=f32, device=device)
    runoff_extra = torch.empty(shape, dtype=f32, device=device)
    baseflow = torch.empty(shape, dtype=f32, device=device)
    n = runoff_extra.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().runoff_hourly(
            f_ptr, f_stride, len(fin), shape[-1], nl, int(dt_hours), n,
            liq.data_ptr(),
            runoff_extra.data_ptr(), baseflow.data_ptr(), stream)
        _check_launch(name, err)
    return liq, runoff_extra, baseflow


# K5's inputs, in the order of csrc/surface_brent.cuh's enums
SURFACE_INPUTS = (
    "ts_old", "t1_old", "t2", "d1", "d2", "kappa1", "kappa2", "cs1", "cs2",
    "dp", "tair", "vpd", "vp_air", "shortwave_net_bare", "long_bare_in",
    "atmos_density", "atmos_pressure", "latent_heat_le", "ra_under", "z_ref",
    "displacement", "roughness", "wind", "lai", "wdew", "wdmax", "rarc",
    "ra_canopy", "rainfall", "resid_moist0", "moist0", "ice0", "max_moist0",
    "depth0", "snow_coverage", "surf_atten", "kappa_snow", "tsnow_surf",
    "melt_energy", "inc_swq", "inc_surf_water", "inc_density",
    "inc_old_tsurf", "inc_advection0", "inc_lw_snow_in",
    "inc_net_short_snow_cov", "inc_cov", "inc_blowing_flux", "pen_slope",
    "pen_lv", "pen_gamma", "pen_r_air", "arno_beta", "rc1")
SURFACE_LAYER_INPUTS = ("root", "gsm_l", "rc2", "w1", "cap")
SURFACE_MASKS = ("active", "inc_mask", "overstory_snowing", "is_veg",
                 "case1")
# DIST_PRCP's dry column and wet fraction, after K5's layered inputs and
# masks (csrc/surface_brent.cuh DryIn, DryLayerIn, kCase1Dry)
DRY_INPUTS = ("wdew_dry", "rainfall_dry", "moist0_dry", "ice0_dry",
              "arno_beta_dry", "rc1_dry", "mu_wet")
DRY_LAYER_INPUTS = ("gsm_l_dry", "rc2_dry", "w1_dry", "cap_dry")
DRY_MASKS = ("case1_dry",)


def surface_inputs(eb_kwargs):
    """K5's inputs from physics.surface.surf_energy_terms' keyword
    arguments: {name: tensor} over SURFACE_INPUTS, SURFACE_LAYER_INPUTS and
    SURFACE_MASKS but `active`, and with DIST_PRCP (dist_dry) over
    DRY_INPUTS, DRY_LAYER_INPUTS and DRY_MASKS."""
    kw = eb_kwargs
    pre = kw["evap_pre"]
    named = {k: kw[k] for k in SURFACE_INPUTS + SURFACE_LAYER_INPUTS
             + SURFACE_MASKS if k in kw}
    for k in ("moist", "ice", "max_moist", "depth"):
        named[f"{k}0"] = kw[f"{k}_l"][..., 0]
    named.update({f"inc_{k}": v for k, v in kw["inc_terms"].items()})
    named.update(zip(("pen_slope", "pen_lv", "pen_gamma", "pen_r_air"),
                     pre["coeffs"]))
    transp = ("rc1", "gsm_l", "rc2", "w1", "cap", "case1")
    named.update(arno_beta=pre["arno_beta"],
                 **{k: pre["transp"][k] for k in transp})
    dry = kw.get("dist_dry")
    if dry is not None:
        pre_d = kw["evap_pre_dry"]
        named.update(wdew_dry=dry["wdew"], rainfall_dry=dry["rainfall"],
                     moist0_dry=dry["moist_l"][..., 0],
                     ice0_dry=dry["ice_l"][..., 0],
                     arno_beta_dry=pre_d["arno_beta"], mu_wet=kw["mu_wet"],
                     **{f"{k}_dry": pre_d["transp"][k] for k in transp})
    return named


def _surface_lanes(name, lo, hi, active, eb_kwargs, extra=()):
    """The inputs of K5, K7 and K14 from the residual's keyword arguments,
    as _lane_inputs passes them, the float inputs `extra` ((name, tensor,
    dtype, nl) items) last: (lanes shape, layers, DIST_PRCP's dry column
    read, the views to keep alive, float pointers, strides, count, mask
    pointers, strides, count). Without DIST_PRCP the dry column's inputs,
    and without FROZEN_SOIL the fusion's, are zeros the kernels never
    read."""
    device = lo.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    if eb_kwargs.get("evap_pre") is None:
        raise ValueError(f"{name}: needs the hoisted evap_pre terms")
    shape = torch.broadcast_shapes(lo.shape, hi.shape, active.shape)
    named = dict(surface_inputs(eb_kwargs), active=active)
    nl = named["root"].shape[-1]
    f32, flag = torch.float32, torch.bool
    dist = eb_kwargs.get("dist_dry") is not None
    if not dist:
        named.update(dict.fromkeys(DRY_INPUTS + DRY_LAYER_INPUTS, torch.zeros(
            (), dtype=f32, device=device)), case1_dry=torch.zeros(
                (), dtype=flag, device=device))
    floats = ([(k, named[k], f32, 0) for k in SURFACE_INPUTS]
              + [(k, named[k], f32, nl) for k in SURFACE_LAYER_INPUTS]
              + [(k, named[k], f32, 0) for k in DRY_INPUTS]
              + [(k, named[k], f32, nl) for k in DRY_LAYER_INPUTS])
    masks = [(k, named[k], flag, 0) for k in SURFACE_MASKS + DRY_MASKS]
    frozen = bool(eb_kwargs.get("frozen_soil"))
    zero = torch.zeros((), dtype=f32, device=device)
    floats += [(k, eb_kwargs[k] if frozen else zero, f32, 0)
               for k in FD_SURFACE_INPUTS]
    masks.append(("fs_active", eb_kwargs["fs_active"] if frozen
                  else torch.zeros((), dtype=flag, device=device), flag, 0))
    fin, f_ptr, f_stride = _lane_inputs(floats + list(extra), shape, device)
    mviews, m_ptr, m_stride = _lane_inputs(masks, shape, device)
    return (shape, nl, dist, (fin, mviews), f_ptr, f_stride, len(fin), m_ptr,
            m_stride, len(mviews))


def surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K5: expand-then-Brent on the QUICK_FLUX soil-surface residual, with
    FROZEN_SOIL's fusion term where eb_kwargs["frozen_soil"], one thread
    per lane. Same arguments and result as
    physics.surface.surface_brent_plain (iterations per lane)."""
    name = "surface_brent"
    if eb_kwargs.get("fd_solve") is not None \
            or eb_kwargs.get("fd_interp") is not None:
        raise ValueError(f"{name}: solves the QUICK_FLUX residual only")
    shape, nl, dist, _views, f_ptr, f_stride, nf, m_ptr, m_stride, nm = \
        _surface_lanes(name, lo, hi, active, eb_kwargs)
    device, f32 = lo.device, torch.float32
    lo_c = _lanes(lo, shape, device, f32, "lo")
    hi_c = _lanes(hi, shape, device, f32, "hi")
    root = torch.empty(shape, dtype=f32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    bracketed = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    n = root.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().surface_brent(
            f_ptr, f_stride, nf, m_ptr, m_stride, nm, shape[-1],
            nl, int(dist), lo_c.data_ptr(), hi_c.data_ptr(),
            float(eb_kwargs["delta_t"]),
            int(eb_kwargs.get("grnd_flux_type", 1)),
            int(bool(eb_kwargs.get("frozen_soil"))), int(max_iter), MAXTRIES,
            n, root.data_ptr(), converged.data_ptr(), bracketed.data_ptr(),
            iterations.data_ptr(), stream)
        _check_launch(name, err)
    return RootResult(root, converged, bracketed, iterations)


# FROZEN_SOIL's fusion inputs and frozen-soil mask of K5, K7 and K14, after
# K5's others (csrc/surface_brent.cuh FdIn, kFsActive)
FD_SURFACE_INPUTS = ("moist0_vol", "max_moist0_vol", "ice0_vol", "bubble0",
                     "expt0")
# K7's launches (csrc/fd_surface_brent.cu Op) and its state's float rows
(_FD_EVAL_LO, _FD_EVAL_HI, _FD_EVAL_LO_NEED, _FD_EVAL_HI_NEED, _FD_EXPAND,
 _FD_INIT, _FD_PROPOSE, _FD_ACCEPT, _FD_FINISH) = range(9)
_FD_ROWS, _FD_A, _FD_B, _FD_BNEXT = 11, 0, 1, 10


def fd_surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K7: the batch-wide Brent of physics.surface.surface_brent_plain on
    the finite-difference residual, its state on the device. Every residual
    evaluation is one eb_kwargs["fd_solve"] call (K6 on CUDA) at the
    candidates of all lanes and one residual launch; the host reads one
    flag per expansion round and per Brent iteration, as the plain loop.
    Same arguments and result as surface_brent_plain (iterations: the
    loop's trip count)."""
    name = "fd_surface_brent"
    fd_solve = eb_kwargs.get("fd_solve")
    if fd_solve is None:
        raise ValueError(f"{name}: solves the finite-difference residual "
                         "only (fd_solve)")
    shape, nl, dist, _views, f_ptr, f_stride, nf, m_ptr, m_stride, nm = \
        _surface_lanes(name, lo, hi, active, eb_kwargs)
    device, f32 = lo.device, torch.float32
    lo_c = _lanes(lo, shape, device, f32, "lo")
    hi_c = _lanes(hi, shape, device, f32, "hi")
    root = torch.empty(shape, dtype=f32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    bracketed = torch.empty(shape, dtype=torch.bool, device=device)
    n = root.numel()
    if not n:
        return RootResult(root, converged, bracketed, 0)
    state = torch.empty((_FD_ROWS,) + tuple(shape), dtype=f32, device=device)
    state[_FD_A].copy_(lo_c)
    state[_FD_B].copy_(hi_c)
    lane_flags = torch.zeros((3,) + tuple(shape), dtype=torch.uint8,
                             device=device)
    votes = torch.zeros(MAXTRIES + int(max_iter) + 1, dtype=torch.int32,
                        device=device)
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    args = dict(dt=float(eb_kwargs["delta_t"]),
                gft=int(eb_kwargs.get("grnd_flux_type", 1)),
                frozen=int(bool(eb_kwargs.get("frozen_soil"))))

    def launch(op, nodes=None, vote=0):
        nn = 0
        if nodes is not None:
            if nodes.dtype != f32 or not nodes.is_contiguous() \
                    or tuple(nodes.shape[:-1]) != tuple(shape):
                raise ValueError(f"{name}: node profile {nodes.dtype} "
                                 f"{tuple(nodes.shape)}, expected a "
                                 f"contiguous float32 {tuple(shape)} + (nn,)")
            nn = nodes.shape[-1]
        err = lib.fd_surface_brent(
            op, f_ptr, f_stride, nf, m_ptr, m_stride, nm, shape[-1], nl,
            int(dist), args["dt"], args["gft"], args["frozen"],
            state.data_ptr(), lane_flags.data_ptr(),
            nodes.data_ptr() if nodes is not None else None, nn,
            votes.data_ptr() + 4 * vote, n, lo_c.data_ptr(),
            hi_c.data_ptr(), root.data_ptr(), converged.data_ptr(),
            bracketed.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {err}")

    def evaluate(op, row):
        # the node profile at every lane's candidate, then the residual
        launch(op, nodes=fd_solve(state[row]).temp)

    # bracket expansion (ops/rootfind.expand_brackets)
    evaluate(_FD_EVAL_LO, _FD_A)
    evaluate(_FD_EVAL_HI, _FD_B)
    for t in range(MAXTRIES):
        launch(_FD_EXPAND, vote=t)
        if not int(votes[t]):
            break
        evaluate(_FD_EVAL_LO_NEED, _FD_A)
        evaluate(_FD_EVAL_HI_NEED, _FD_B)
    # Brent (ops/rootfind.batched_brent), one vote per iteration: is any
    # lane not done
    launch(_FD_INIT, vote=MAXTRIES)
    i = 0
    while i < max_iter and int(votes[MAXTRIES + i]):
        launch(_FD_PROPOSE, vote=MAXTRIES + 1 + i)
        evaluate(_FD_ACCEPT, _FD_BNEXT)
        i += 1
    launch(_FD_FINISH)
    _check_launch(name, 0)
    return RootResult(root, converged, bracketed, i)


# K14's inputs after K7's: the bracket ends of the two probes and the probe
# profiles (csrc/affine_surface_brent.cu AffIn)
AFFINE_INPUTS = ("ts_a", "ts_b", "probe_lo", "probe_hi")


def affine_surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K14: expand-then-Brent on the finite-difference residual whose nodes
    1-2 are interpolated affinely between two probe profiles,
    eb_kwargs["fd_interp"] = (ts_a, t_a, ts_b, t_b), one thread per lane.
    Same arguments and result as physics.surface.surface_brent_plain on
    that residual (iterations per lane)."""
    name = "affine_surface_brent"
    fd_interp = eb_kwargs.get("fd_interp")
    if fd_interp is None or eb_kwargs.get("fd_solve") is not None:
        raise ValueError(f"{name}: solves the affine two-probe residual "
                         "only (fd_interp, no fd_solve)")
    ts_a, t_a, ts_b, t_b = fd_interp
    nn = t_a.shape[-1]
    f32 = torch.float32
    extra = [("ts_a", ts_a, f32, 0), ("ts_b", ts_b, f32, 0),
             ("probe_lo", t_a, f32, nn), ("probe_hi", t_b, f32, nn)]
    shape, nl, dist, _views, f_ptr, f_stride, nf, m_ptr, m_stride, nm = \
        _surface_lanes(name, lo, hi, active, eb_kwargs, extra=extra)
    device = lo.device
    lo_c = _lanes(lo, shape, device, f32, "lo")
    hi_c = _lanes(hi, shape, device, f32, "hi")
    root = torch.empty(shape, dtype=f32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    bracketed = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    n = root.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().affine_surface_brent(
            f_ptr, f_stride, nf, m_ptr, m_stride, nm, shape[-1], nl,
            int(dist), nn, lo_c.data_ptr(), hi_c.data_ptr(),
            float(eb_kwargs["delta_t"]),
            int(eb_kwargs.get("grnd_flux_type", 1)),
            int(bool(eb_kwargs.get("frozen_soil"))), int(max_iter), MAXTRIES,
            n, root.data_ptr(), converged.data_ptr(), bracketed.data_ptr(),
            iterations.data_ptr(), stream)
        _check_launch(name, err)
    return RootResult(root, converged, bracketed, iterations)


# the node counts K6 runs (csrc/node_sweep.cu): 3 to the reference's
# MAX_NODES
SWEEP_MIN_NODES, SWEEP_MAX_NODES = 3, 50
SWEEP_LANE_INPUTS = ("t0", "kappa", "cs", "moist_node", "ice0_node")
# [n_cell, nn] geometry, then the [n_cell] EXP_TRANS terms
SWEEP_GEOMETRY = ("alpha", "beta", "gamma", "e_coef", "solver_max_moist",
                  "solver_bubble", "solver_expt", "zp1")
SWEEP_CELL_GEOMETRY = ("exp_a", "bexp")


# K16's [n_cell, nn] geometry, in csrc/implicit_profile.cu's order
IMPLICIT_GEOMETRY = ("alpha", "beta", "gamma", "e_lin", "max_moist_node",
                     "bubble_term_node", "power_node")


def implicit_profile(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
                     fs_active, *, dt_sec, noflux, frozen, max_nr=12,
                     relax=None):
    """K16: the IMPLICIT soil-heat solve of every lane (Newton-Raphson with
    a Thomas solve per step), one thread per lane, at 3 to 50 nodes. Same
    arguments and result as
    physics.frozen_soil.solve_t_profile_implicit_plain."""
    from ..physics.frozen_soil import ProfileResult
    name = "implicit_profile"
    device = t0.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    f32 = torch.float32
    c, h, nn = t0.shape
    if not SWEEP_MIN_NODES <= nn <= SWEEP_MAX_NODES:
        raise ValueError(f"{name}: runs {SWEEP_MIN_NODES} to "
                         f"{SWEEP_MAX_NODES} nodes, got nnode={nn}")
    named = dict(t0=t0, kappa=kappa, cs=cs, moist_node=moist_node,
                 ice0_node=ice0_node)
    lane = [_lanes(named[k], t0.shape, device, f32, k)
            for k in SWEEP_LANE_INPUTS]
    geo = [_lanes(getattr(geom, k), (c, nn), device, f32, k)
           for k in IMPLICIT_GEOMETRY]
    surf = _lanes(surf_temp, (c, h), device, f32, "surf_temp")
    fs = _lanes(fs_active, (c,), device, torch.bool, "fs_active")
    temp = torch.empty(t0.shape, dtype=f32, device=device)
    fbcount = torch.empty(t0.shape, dtype=torch.int32, device=device)
    n = c * h
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().implicit_profile(
            _ptrs(lane), _ptrs(geo), surf.data_ptr(), fs.data_ptr(), n, h,
            nn, int(bool(frozen)), int(bool(noflux)), int(max_nr),
            int(relax is not None), float(relax or 0.0), float(dt_sec),
            float(2.0 * dt_sec), temp.data_ptr(), fbcount.data_ptr(), stream)
        _check_launch(name, err)
    return ProfileResult(temp=temp, fbcount=fbcount, iterations=int(max_nr))


def node_sweep(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
               fs_active, *, nlayer, dt_sec, noflux, frozen, max_sweeps,
               exp_trans=False):
    """K6: the Gauss-Seidel node sweep of every lane, the batch-wide sweep
    count decided on the device, at 3 to 50 nodes on linear or (exp_trans)
    EXP_TRANS spacing. Same arguments and result as
    physics.frozen_soil.solve_t_profile_explicit_plain (the sweep count as
    an int32 0-d tensor)."""
    from ..physics.frozen_soil import ProfileResult
    name = "node_sweep"
    device = t0.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    f32, i32 = torch.float32, torch.int32
    c, h, nn = t0.shape
    if not SWEEP_MIN_NODES <= nn <= SWEEP_MAX_NODES:
        raise ValueError(f"{name}: runs {SWEEP_MIN_NODES} to "
                         f"{SWEEP_MAX_NODES} nodes, got nnode={nn}")
    named = dict(t0=t0, kappa=kappa, cs=cs, moist_node=moist_node,
                 ice0_node=ice0_node)
    lane = [_lanes(named[k], t0.shape, device, f32, k)
            for k in SWEEP_LANE_INPUTS]
    geo = ([_lanes(getattr(geom, k), (c, nn), device, f32, k)
            for k in SWEEP_GEOMETRY]
           + [_lanes(getattr(geom, k), (c,), device, f32, k)
              for k in SWEEP_CELL_GEOMETRY])
    surf = _lanes(surf_temp, (c, h), device, f32, "surf_temp")
    fs = _lanes(fs_active, (c,), device, torch.bool, "fs_active")
    temp = torch.empty(t0.shape, dtype=f32, device=device)
    fbcount = torch.empty(t0.shape, dtype=i32, device=device)
    sweeps = torch.zeros((), dtype=i32, device=device)
    n = c * h
    if n:
        work_t = torch.empty(t0.shape, dtype=f32, device=device)
        work_fb = torch.empty(t0.shape, dtype=i32, device=device)
        lastdiff = torch.empty((c, h), dtype=f32, device=device)
        control = torch.empty((2, max(int(max_sweeps), 1)), dtype=i32,
                              device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().node_sweep(
            _ptrs(lane), _ptrs(geo), surf.data_ptr(), fs.data_ptr(), n, h, nn,
            int(nlayer), int(frozen), int(noflux), int(bool(exp_trans)),
            int(max_sweeps), float(dt_sec), float(2.0 * dt_sec),
            float(4.0 * dt_sec), work_t.data_ptr(),
            work_fb.data_ptr(), lastdiff.data_ptr(), control[0].data_ptr(),
            control[1].data_ptr(), temp.data_ptr(), fbcount.data_ptr(),
            sweeps.data_ptr(), stream)
        _check_launch(name, err)
    return ProfileResult(temp=temp, fbcount=fbcount, iterations=sweeps)


# K8's inputs, in the order of csrc/blowing_snow.cu's In, and its mask
BLOWING_INPUTS = ("tair", "last_snow", "surf_water_m", "wind_2m", "ls",
                  "air_dens", "eact", "z0_snow", "snowdepth", "lag_one",
                  "sigma_slope", "fetch", "displacement", "roughness")
BLOWING_MASKS = ("is_bare",)
# calc_blowing_snow's arguments that its arithmetic never reads
BLOWING_UNUSED = ("pressure", "zrh", "tsnow")


def blowing_snow(*, dt_sec, quad_nodes, log_terms, **inputs):
    """K8: calc_blowing_snow of every lane, one thread per lane. Same
    arguments and result as physics.blowing_snow.calc_blowing_snow_plain:
    (flux, transport), each of the lanes' broadcast shape."""
    name = "blowing_snow"
    device = inputs["tair"].device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    expected = set(BLOWING_INPUTS + BLOWING_MASKS + BLOWING_UNUSED)
    if set(inputs) != expected:
        raise TypeError(f"{name}: missing inputs "
                        f"{sorted(expected - set(inputs))}, unexpected "
                        f"{sorted(set(inputs) - expected)}")
    shape = torch.broadcast_shapes(*(inputs[k].shape for k in
                                     BLOWING_INPUTS + BLOWING_MASKS))
    f32 = torch.float32
    fin, f_ptr, f_stride = _lane_inputs(
        [(k, inputs[k], f32, 0) for k in BLOWING_INPUTS], shape, device)
    masks, m_ptr, m_stride = _lane_inputs(
        [(k, inputs[k], torch.bool, 0) for k in BLOWING_MASKS], shape,
        device)
    nodes = _lanes(quad_nodes, (16,), device, f32, "quad_nodes")
    logs = _lanes(log_terms, (20,), device, f32, "log_terms")
    flux = torch.empty(shape, dtype=f32, device=device)
    transport = torch.empty(shape, dtype=f32, device=device)
    n = flux.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().blowing_snow(
            f_ptr, f_stride, len(fin), m_ptr, m_stride, len(masks),
            shape[-1], float(dt_sec), nodes.data_ptr(), logs.data_ptr(), n,
            flux.data_ptr(), transport.data_ptr(), stream)
        _check_launch(name, err)
    return flux, transport


# K9's inputs, in the order of csrc/canopy_air.cu's In and Mask
CANOPY_AIR_INPUTS = ("canopy_sensible", "soil_sensible", "pack_sensible",
                     "cov_w", "tair", "air_dens", "ra_over", "tc", "tc_prev",
                     "g_prev")
CANOPY_AIR_MASKS = ("iter_mask", "lane_mask")


def canopy_air_step(*, it, **inputs):
    """K9: one CLOSE_ENERGY pass's canopy-air update on every lane and the
    batch's largest masked change, reduced on the device. Same arguments and
    result as physics.canopy_air.canopy_air_step_plain: (tc_next, g,
    live_max as a 0-d float32 tensor, NaN if any change is NaN)."""
    name = "canopy_air_step"
    device = inputs["tc"].device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    expected = set(CANOPY_AIR_INPUTS + CANOPY_AIR_MASKS)
    if set(inputs) != expected:
        raise TypeError(f"{name}: missing inputs "
                        f"{sorted(expected - set(inputs))}, unexpected "
                        f"{sorted(set(inputs) - expected)}")
    shape = torch.broadcast_shapes(*(t.shape for t in inputs.values()))
    f32 = torch.float32
    fin, f_ptr, f_stride = _lane_inputs(
        [(k, inputs[k], f32, 0) for k in CANOPY_AIR_INPUTS], shape, device)
    masks, m_ptr, m_stride = _lane_inputs(
        [(k, inputs[k], torch.bool, 0) for k in CANOPY_AIR_MASKS], shape,
        device)
    tc_next = torch.empty(shape, dtype=f32, device=device)
    g = torch.empty(shape, dtype=f32, device=device)
    live_bits = torch.zeros((), dtype=torch.int32, device=device)
    n = tc_next.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().canopy_air_step(
            f_ptr, f_stride, len(fin), m_ptr, m_stride, len(masks),
            shape[-1], int(it), n, tc_next.data_ptr(), g.data_ptr(),
            live_bits.data_ptr(), stream)
        _check_launch(name, err)
    return tc_next, g, live_bits.view(f32)


# the lake kernels K10-K13 (one thread per lake; lanes [n_cell])
LAKE_NN = 20
# K10's and K11's per-lake inputs after the layered temp, z, zhalf and
# surface, in the order of csrc/lake_open_water.cu's and
# csrc/lake_under_ice.cu's In
OPEN_WATER_INPUTS = ("surfdz", "dz", "lat", "tcutoff", "tair", "wind",
                     "pressure", "vp", "air_density", "longwave",
                     "shortwave_net", "wind_h", "fracprv", "lvolume")
UNDER_ICE_INPUTS = ("surfdz", "dz", "tcutoff", "sw_ice", "hice", "sdepth")
# water_under_ice's arguments that only enter its molecular-only
# diffusivity, which discards them
UNDER_ICE_UNUSED = ("lat", "wind")
# K12's residual inputs (csrc/lake_ice_brent.cu IceResidual); blowing_flux
# is a zero broadcast to the lakes without BLOWING
ICE_EB_INPUTS = ("ra", "z_ref", "roughness", "wind", "net_short",
                 "longwave_in", "air_dens", "lv", "tair", "pressure", "vpd",
                 "vp_air", "rain_m", "surf_water", "tcutoff", "avgcond",
                 "sw_conducted", "blowing_flux")


def _column_lanes(name, temp, grid, active, named, keys):
    """The inputs of K10/K11 as _lane_inputs passes them over the lakes:
    temp, the grid's z, zhalf and surface (layered), the per-lake `keys` of
    `named`, and the masks active, grid.mask, grid.last."""
    device = temp.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    if temp.dim() != 2 or temp.shape[1] != LAKE_NN:
        raise ValueError(f"{name}: temp must be [n_cell, {LAKE_NN}], got "
                         f"{tuple(temp.shape)}")
    shape = (temp.shape[0],)
    f32, flag = torch.float32, torch.bool
    floats = ([("temp", temp, f32, LAKE_NN), ("z", grid.z, f32, LAKE_NN),
               ("zhalf", grid.zhalf, f32, LAKE_NN),
               ("surface", grid.surface, f32, LAKE_NN + 1)]
              + [(k, named[k], f32, 0) for k in keys])
    masks = [("active", active, flag, 0), ("mask", grid.mask, flag, LAKE_NN),
             ("last", grid.last, flag, LAKE_NN)]
    fin, f_ptr, f_stride = _lane_inputs(floats, shape, device)
    mviews, m_ptr, m_stride = _lane_inputs(masks, shape, device)
    return shape, (fin, mviews), f_ptr, f_stride, len(fin), m_ptr, \
        m_stride, len(mviews)


def _check_names(name, inputs, expected):
    if set(inputs) != set(expected):
        raise TypeError(f"{name}: missing inputs "
                        f"{sorted(set(expected) - set(inputs))}, unexpected "
                        f"{sorted(set(inputs) - set(expected))}")


def lake_open_water(*, temp, grid, dt_sec, active, **inputs):
    """K10: the open-water skin-temperature fixed point and the mix of its
    column, one thread per lake. Same arguments and result as
    physics.lake.lake_open_water_plain: (WaterEBResult, t_open), with the
    iterations each lake ran."""
    from ..physics.lake import WaterEBResult
    name = "lake_open_water"
    _check_names(name, inputs, set(OPEN_WATER_INPUTS) - {"surfdz", "dz"})
    named = dict(inputs, surfdz=grid.surfdz, dz=grid.dz)
    shape, _views, f_ptr, f_stride, nf, m_ptr, m_stride, nm = _column_lanes(
        name, temp, grid, active, named, OPEN_WATER_INPUTS)
    device, n = temp.device, shape[0]
    t_out = torch.empty((n, LAKE_NN), dtype=torch.float32, device=device)
    t_open = torch.empty_like(t_out)
    sc = torch.empty((10, n), dtype=torch.float32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_open_water(
            f_ptr, f_stride, nf, m_ptr, m_stride, nm, n, float(dt_sec), n,
            t_out.data_ptr(), t_open.data_ptr(), sc.data_ptr(),
            converged.data_ptr(), iterations.data_ptr(), stream)
        _check_launch(name, err)
    return WaterEBResult(t_out, *sc.unbind(0), converged, iterations), t_open


def lake_under_ice(*, temp, grid, dt_sec, active, **inputs):
    """K11: the ice/water interface flux fixed point of the column under
    lake ice, its column solved and mixed every iteration, one thread per
    lake. Same arguments and result as physics.lake.water_under_ice_plain
    (UnderIceResult, with the iterations each lake ran)."""
    from ..physics.lake import UnderIceResult
    name = "lake_under_ice"
    _check_names(name, inputs, (set(UNDER_ICE_INPUTS) - {"surfdz", "dz"})
                 | set(UNDER_ICE_UNUSED))
    named = dict(inputs, surfdz=grid.surfdz, dz=grid.dz)
    shape, _views, f_ptr, f_stride, nf, m_ptr, m_stride, nm = _column_lanes(
        name, temp, grid, active, named, UNDER_ICE_INPUTS)
    device, n = temp.device, shape[0]
    t_out = torch.empty((n, LAKE_NN), dtype=torch.float32, device=device)
    sc = torch.empty((3, n), dtype=torch.float32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_under_ice(
            f_ptr, f_stride, nf, m_ptr, m_stride, nm, n, float(dt_sec), n,
            t_out.data_ptr(), sc.data_ptr(), converged.data_ptr(),
            iterations.data_ptr(), stream)
        _check_launch(name, err)
    qw, delta_h, e_bot = sc.unbind(0)
    return UnderIceResult(temp=t_out, qw=qw, delta_h=delta_h,
                          energy_out_bottom=e_bot, converged=converged,
                          iterations=iterations)


def lake_ice_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K12: expand-then-Brent on the lake snow/ice surface residual, one
    thread per lake. Same arguments and result as
    physics.lake.lake_ice_brent_plain (iterations per lake)."""
    return _brent("lake_ice_brent", ICE_EB_INPUTS, (), lo, hi, active, dt,
                  max_iter, max_tries, inputs)


def lake_depth(z, basin, maxdepth, volume):
    """K13: the depth of each lake's liquid volume by 30 bisection steps on
    its basin (z, basin [n_cell, 21]). Same result as
    physics.lake.depth_from_volume_plain."""
    name = "lake_depth"
    device = volume.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    shape = tuple(volume.shape)
    if len(shape) != 1:
        raise ValueError(f"{name}: volume must be [n_cell], got {shape}")
    f32 = torch.float32
    fin, f_ptr, f_stride = _lane_inputs(
        [("z", z, f32, LAKE_NN + 1), ("basin", basin, f32, LAKE_NN + 1),
         ("maxdepth", maxdepth, f32, 0), ("volume", volume, f32, 0)], shape,
        device)
    depth = torch.empty(shape, dtype=f32, device=device)
    n = shape[0]
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_depth(f_ptr, f_stride, len(fin), n, n,
                                      depth.data_ptr(), stream)
        _check_launch(name, err)
    return depth
