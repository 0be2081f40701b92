"""Python bindings of the CUDA kernels (csrc/*.cu).

Each wrapper takes CUDA tensors only: it checks device and dtype, passes
each lane input of K1-K5, K7-K15 and K17 as its data pointer and the
element strides of its broadcast to the lanes, all of a call's in one int64
table (`_lane_inputs`, csrc/lanes.cuh), so no input is copied and no view
is made, allocates the outputs, launches on the current stream,
raises if the launch was refused, and adds one to its entry of `launches`
(under a lock: the shares of a split block launch from threads of their
own); each call is a vic.kernel.<name> span (`trace.kernel`). What a
wrapper keeps between calls is kept per device and stream.
The plain PyTorch versions live beside each call site (physics/glacier.py,
snow.py, canopy_snow.py, runoff.py, surface.py, frozen_soil.py,
blowing_snow.py, canopy_air.py, lake.py, bisection.py); the call sites pick
one or the other by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..ops.rootfind import MAXTRIES, RootResult
from . import build

# launches of each kernel since the last reset_launches() (trace.launches:
# the calls of its wrapper that reached the device), a key a wrapper
launches = trace.launches
reset_launches = trace.reset_launches

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


def _check_input(x, device, dtype, name):
    """Raises unless x is a tensor of `dtype` on `device`."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")


def _lanes(x, shape, device, dtype, name):
    """x expanded to `shape`, contiguous; raises unless x is a tensor of
    `dtype` on `device` that broadcasts to `shape`."""
    _check_input(x, device, dtype, name)
    return x.expand(shape).contiguous()


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _broadcast_strides(x, target, name):
    """The element strides of x broadcast to `target` (x.expand(target)
    .stride()), worked out from its shape and strides: 0 along an axis it
    is broadcast over. Raises as expand does where x does not broadcast."""
    size = x.shape
    if size == target:
        return x.stride()
    lead = len(target) - len(size)
    if lead < 0:
        raise RuntimeError(f"{name}: shape {tuple(size)} does not broadcast "
                           f"to {tuple(target)}")
    out = [0] * len(target)
    stride = x.stride()
    for a, s in enumerate(size):
        if s == target[lead + a]:
            out[lead + a] = stride[a]
        elif s != 1:
            raise RuntimeError(f"{name}: shape {tuple(size)} does not "
                               f"broadcast to {tuple(target)}")
    return out


def _lane_inputs(floats, masks, shape, device):
    """The lane table of a kernel over the lanes `shape` ([n_cell,
    max_hru], or [n] as one cell), as csrc/lanes.cuh reads it: for each
    (name, tensor, nl) of the float inputs, then of the masks (nl > 0 for
    an input with a trailing layer axis), its data pointer and its element
    strides along the cell, HRU and layer axes (0 along an axis it is
    broadcast over), four int64 an input, in one numpy array whose address
    goes to the C function; nothing is copied and no view is made. Raises
    unless each input is a float32 (mask: bool) tensor on `device` that
    broadcasts to the lanes."""
    if len(shape) not in (1, 2):
        raise ValueError(f"lanes must be [n_cell, max_hru], got {shape}")
    shape = tuple(shape)
    # what each input's strides are padded with to (cell, HRU, layer)
    head = (0,) if len(shape) == 1 else ()
    table = []
    for dtype, items in ((torch.float32, floats), (torch.bool, masks)):
        for name, x, nl in items:
            _check_input(x, device, dtype, name)
            if nl:
                table += (x.data_ptr(), *head,
                          *_broadcast_strides(x, shape + (nl,), name))
            else:
                table += (x.data_ptr(), *head,
                          *_broadcast_strides(x, shape, name), 0)
    return np.array(table, np.int64)


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    trace.count_launch(name)


def _lane_outputs(shape, device, floats=0, flags=0):
    """A RootResult's four outputs over the lanes `shape`, `floats` more
    float32 and `flags` more bool values a lane, all slices of one
    allocation: (RootResult, the floats as one flat [floats * lanes]
    tensor, the flags as [flags, *shape])."""
    n = 1
    for d in shape:
        n *= d
    f = 4 + 4 * floats     # root, then the floats
    buf = torch.empty((f + 6 + flags) * n, dtype=torch.uint8, device=device)
    root = RootResult(buf[:4 * n].view(torch.float32).view(shape),
                      buf[f * n + 4 * n:f * n + 5 * n].view(torch.bool)
                      .view(shape),
                      buf[f * n + 5 * n:f * n + 6 * n].view(torch.bool)
                      .view(shape),
                      buf[f * n:f * n + 4 * n].view(torch.int32).view(shape))
    return (root, buf[4 * n:f * n].view(torch.float32),
            buf[f * n + 6 * n:].view(torch.bool).view((flags,) + shape))


def _root_outputs(shape, device):
    """A RootResult's four outputs over the lanes `shape` as slices of one
    allocation: root, converged, bracketed, iterations."""
    return _lane_outputs(shape, device)[0]


# csrc/lane_brent.cuh's refusal where no block of a lane kernel (K1, K2,
# K3, K5, K12, K14, K17) fits on an SM
_NO_RESIDENT_BLOCK = -3


def _check_lane_brent(name, err):
    """_check_launch, naming the refusal of csrc/lane_brent.cuh's launch."""
    if err == _NO_RESIDENT_BLOCK:
        raise RuntimeError(f"{name}: no block of the kernel fits on an SM "
                           "(cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           "gave 0); the launch was refused")
    _check_launch(name, err)


def _brent_call(name, float_names, flag_names, lo, hi, active, inputs):
    """The lanes of a root finder on csrc/lane_brent.cuh's driver (K1-K3,
    K17): returns (the lane table, which the call must keep alive; the C
    arguments: the table of the float inputs, lo and hi last, and the masks
    (active first), their counts, the lanes per cell; the lanes' shape).
    Every input is read where it lies."""
    device = lo.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, tuple(float_names) + tuple(flag_names))
    shape = torch.broadcast_shapes(lo.shape, hi.shape, active.shape)
    floats = [(k, inputs[k], 0) for k in float_names]
    floats += [("lo", lo, 0), ("hi", hi, 0)]
    masks = [("active", active, 0)] + [(k, inputs[k], 0)
                                       for k in flag_names]
    table = _lane_inputs(floats, masks, shape, device)
    args = (table.ctypes.data, len(floats), len(masks), shape[-1])
    return table, args, shape


def _out_ptrs(outs):
    return tuple(t.data_ptr() for t in outs)


# K1's outputs after the terms (csrc/vic_kernels.cu GlacierOut, GlacierFlag)
GLACIER_OUTPUTS = ("melt_mm", "surf_temp", "cold_content", "vapor_flux")
GLACIER_FLAGS = ("melt_cond", "fbflag")


@trace.kernel("glacier_brent")
def glacier_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K1: glacier.glacier_ablation's solve of the bare-ice balance in one
    launch: on every lane the balance at 0 C, its melt test and the melt
    it gives; then expand-then-Brent on the residual on the lanes of
    `active` (None: every lane) that do not melt at 0 C, compacted and
    dealt to persistent threads (csrc/lane_brent.cuh); then on every lane
    the terms at the accepted temperature (0 C where the ice melts, else
    the root, else old_tsurf) and the surface temperature, cold content,
    vapour loss and fallback flag formed from it. Same arguments and
    result as physics.glacier.glacier_brent_plain, a
    physics.glacier.GlacierSolve."""
    from ..physics.glacier import GlacierEBTerms, GlacierSolve
    name = "glacier_brent"
    device = lo.device
    if active is None:
        active = _const(device, torch.bool, True)
    _keep, args, shape = _brent_call(name, GLACIER_INPUTS, (), lo, hi,
                                     active, inputs)
    nt = len(GlacierEBTerms._fields)
    outs, floats, flags = _lane_outputs(
        shape, device, floats=nt + len(GLACIER_OUTPUTS),
        flags=len(GLACIER_FLAGS))
    floats = floats.view((-1,) + tuple(shape))
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().glacier_brent(
            *args, float(dt), int(max_iter), int(max_tries), n,
            *_out_ptrs(outs), floats.data_ptr(), flags.data_ptr(), stream)
        _check_lane_brent(name, err)
    return GlacierSolve(
        *outs, **dict(zip(GLACIER_FLAGS, flags)),
        **dict(zip(GLACIER_OUTPUTS, floats[nt:])),
        terms=GlacierEBTerms(*floats[:nt]))


def _snowpack_inputs(inputs, device):
    """K2's and K17's inputs with SPATIAL_SNOW's coverage and flag: a zero
    and False on `device` where snow_cover_fract is None or not given, and
    a zero blowing-snow flux where blowing_flux is None (the constants made
    once, _const)."""
    scf = inputs.get("snow_cover_fract")
    spatial = scf is not None
    blowing = inputs.get("blowing_flux")
    return dict(inputs, snow_cover_fract=(
        scf if spatial else _const(device, torch.float32, 0.0)),
        blowing_flux=(_const(device, torch.float32, 0.0) if blowing is None
                      else blowing),
        spatial=_const(device, torch.bool, spatial))


@trace.kernel("snowpack_brent")
def snowpack_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K2: snow.snow_melt's solve of the snowpack surface balance in one
    launch, with SPATIAL_SNOW's advected sensible heat where
    snow_cover_fract is given: on every lane the balance's terms at 0 C
    and the melt test (their rest is 0); then expand-then-Brent on the
    residual on the lanes of `active` (None: every lane) that neither melt
    at 0 C nor are thin (surface_swq <= MIN_SWQ_EB_THRES), compacted and
    dealt to persistent threads (csrc/lane_brent.cuh); then on every lane
    the terms at the accepted temperature (the root, else old_tsurf). Same
    arguments and result as physics.snow.snowpack_brent_plain, a
    physics.snow.SnowpackSolve."""
    from ..physics.snow import SnowEBTerms, SnowpackSolve
    name = "snowpack_brent"
    device = lo.device
    if active is None:
        active = _const(device, torch.bool, True)
    _keep, args, shape = _brent_call(
        name, SNOWPACK_INPUTS, SNOWPACK_FLAGS, lo, hi, active,
        _snowpack_inputs(inputs, device))
    nt = len(SnowEBTerms._fields)
    outs, terms, flags = _lane_outputs(shape, device, floats=2 * nt,
                                       flags=1)
    terms = terms.view((2 * nt,) + tuple(shape))
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().snowpack_brent(
            *args, float(dt), int(max_iter), int(max_tries), n,
            *_out_ptrs(outs), terms[0].data_ptr(), terms[nt].data_ptr(),
            flags[0].data_ptr(), stream)
        _check_lane_brent(name, err)
    return SnowpackSolve(*outs, melt_cond=flags[0],
                         terms0=SnowEBTerms(*terms[:nt]),
                         terms_b=SnowEBTerms(*terms[nt:]))


@trace.kernel("canopy_brent")
def canopy_brent(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """K3: expand-then-Brent on the canopy foliage residual, the active
    lanes compacted and dealt to persistent threads (csrc/lane_brent.cuh).
    Same arguments and result as physics.canopy_snow.canopy_brent_plain."""
    name = "canopy_brent"
    _keep, args, shape = _brent_call(name, CANOPY_INPUTS, CANOPY_FLAGS, lo,
                                     hi, active, inputs)
    outs = _root_outputs(shape, lo.device)
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = build.load().canopy_brent(*args, float(dt), int(max_iter),
                                        int(max_tries), n, *_out_ptrs(outs),
                                        stream)
        _check_lane_brent(name, err)
    return outs


# K17's residuals: name -> (C code, float inputs, flags)
BISECTION_RESIDUALS = {"snowpack": (0, SNOWPACK_INPUTS, SNOWPACK_FLAGS),
                       "glacier": (1, GLACIER_INPUTS, ())}


@trace.kernel("bisection")
def bisection(residual, lo, hi, active, n_iter=40, *, dt, **inputs):
    """K17: vic_tpu's fixed-count bisection (ops/rootfind.py:210) on one of
    the residuals the library compiles, "snowpack" (K2's, SPATIAL_SNOW's
    term where snow_cover_fract is given) or "glacier" (K1's), the active
    lanes packed into whole warps of persistent blocks from one queue for
    the grid (csrc/lane_brent.cuh's lane_queue_kernel with the
    BisectionLane stepper). Same arguments and result as
    physics.bisection.bisection_plain (iterations per lane: n_iter, 0 on
    inactive lanes)."""
    name = "bisection"
    if residual not in BISECTION_RESIDUALS:
        raise ValueError(f"{name}: residual {residual!r} is not one of "
                         f"{sorted(BISECTION_RESIDUALS)}")
    code, floats, flags = BISECTION_RESIDUALS[residual]
    if residual == "snowpack":
        inputs = _snowpack_inputs(inputs, lo.device)
    _keep, args, shape = _brent_call(name, floats, flags, lo, hi, active,
                                     inputs)
    outs = _root_outputs(shape, lo.device)
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = build.load().bisection(code, *args, float(dt), int(n_iter), n,
                                     *_out_ptrs(outs), stream)
        _check_lane_brent(name, err)
    return outs


def _mass_release_lanes(int_snow, temp_int_storage):
    """K15's lanes: (their shape, the lane table of its two inputs)."""
    name = "mass_release"
    device = int_snow.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    shape = torch.broadcast_shapes(int_snow.shape, temp_int_storage.shape)
    table = _lane_inputs([("int_snow", int_snow, 0),
                          ("temp_int_storage", temp_int_storage, 0)], [],
                         shape, device)
    return shape, table


@trace.kernel("mass_release")
def mass_release(int_snow, temp_int_storage, n_iter=8):
    """K15: vic_tpu's 8-round canopy snow release (canopy_snow.py:126):
    four lanes a thread with float4 loads and stores where both inputs are
    lane-contiguous and 16-byte aligned, else one lane a thread through the
    lane table (`mass_release_route`). Same arguments and result as
    physics.canopy_snow.mass_release_plain: (int_snow, temp_int_storage,
    released, drip), each of the inputs' broadcast shape, the four rows of
    one allocation."""
    name = "mass_release"
    shape, table = _mass_release_lanes(int_snow, temp_int_storage)
    n = math.prod(shape)
    ld = -(-n // 4) * 4          # rows of whole float4s
    buf = torch.empty((4, ld), dtype=torch.float32, device=int_snow.device)
    outs = buf[:, :n].view((4,) + tuple(shape)).unbind(0)
    if n:
        stream = torch.cuda.current_stream(int_snow.device).cuda_stream
        err = build.load().mass_release(
            table.ctypes.data, 2, shape[-1], int(n_iter), n, buf.data_ptr(),
            ld, stream)
        _check_launch(name, err)
    return outs


def mass_release_route(int_snow, temp_int_storage):
    """The path K15 takes on these inputs: "vector" (both lane-contiguous
    and 16-byte aligned) or "table"; the kernel library decides, as the
    launch does."""
    shape, table = _mass_release_lanes(int_snow, temp_int_storage)
    path = build.load().mass_release_route(table.ctypes.data, 2, shape[-1],
                                           math.prod(shape))
    if path < 0:
        raise ValueError(f"mass_release: the kernel refuses lanes {shape}")
    return "vector" if path else "table"


# K4's inputs, in csrc/vic_kernels.cu's RunoffIn order: layered, then one
# value a lane
RUNOFF_LAYER_INPUTS = ("moist", "soil_ice", "layer_evap", "max_moist_l",
                       "resid_fract", "depth", "ksat", "expt")
RUNOFF_LANE_INPUTS = ("ppt", "b_infilt", "ds", "dsmax", "ws", "c_expt")


@trace.kernel("runoff_hourly")
def runoff_hourly(moist, soil_ice, layer_evap, ppt, max_moist_l,
                  resid_fract, depth, ksat, expt, b_infilt, ds, dsmax, ws,
                  c_expt, dt_hours: int):
    """K4: the whole of runoff.runoff_step in one launch, one thread a
    lane: the residual moisture and ARNO's surface runoff, the hourly
    drainage/baseflow loop, the final moisture's saturated area, the
    clamps and the bottom layer's evap. Same arguments and result as
    physics.runoff.runoff_step_plain, a physics.runoff.RunoffResult whose
    fields are slices of one allocation: layer arrays broadcast to
    [..., nl], the rest to [...]."""
    from ..physics.runoff import RunoffResult
    name = "runoff_hourly"
    device = moist.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    layer = dict(zip(RUNOFF_LAYER_INPUTS, (moist, soil_ice, layer_evap,
                                          max_moist_l, resid_fract, depth,
                                          ksat, expt)))
    lane = dict(zip(RUNOFF_LANE_INPUTS, (ppt, b_infilt, ds, dsmax, ws,
                                        c_expt)))
    lshape = torch.broadcast_shapes(*(t.shape for t in layer.values()))
    shape = torch.broadcast_shapes(lshape[:-1],
                                   *(t.shape for t in lane.values()))
    nl = lshape[-1]
    floats = ([(k, t, nl) for k, t in layer.items()]
              + [(k, t, 0) for k, t in lane.items()])
    table = _lane_inputs(floats, [], shape, device)
    n = math.prod(shape)
    buf = torch.empty((2 * nl + 3) * n, dtype=torch.float32, device=device)
    lanes = tuple(shape)

    def layered(first):
        return buf[first * n:(first + nl) * n].view(lanes + (nl,))

    def row(k):
        return buf[(nl + k) * n:(nl + k + 1) * n].view(lanes)

    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().runoff_hourly(
            table.ctypes.data, len(floats), shape[-1], nl, int(dt_hours), n,
            buf.data_ptr(), stream)
        _check_launch(name, err)
    return RunoffResult(moist=layered(0), runoff=row(0), baseflow=row(1),
                        asat=row(2), layer_evap=layered(nl + 3))


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


_consts = {}


def _const(device, dtype, value):
    """A 0-d `value` of `dtype` on `device`, made once: the stand-in for an
    input a kernel never reads or a flag broadcast to its lanes, without a
    fill launch per call. Its fill is waited for, as other streams read
    it."""
    key = (device, dtype, value)
    if key not in _consts:
        const = torch.full((), value, dtype=dtype, device=device)
        if const.is_cuda:
            torch.cuda.current_stream(device).synchronize()
        _consts[key] = const
    return _consts[key]


def _surface_lanes(name, lo, hi, active, eb_kwargs, extra=()):
    """The inputs of K5, K7 and K14 from the residual's keyword arguments,
    as _lane_inputs passes them, the float inputs `extra` ((name, tensor,
    nl) items) last: (lanes shape, layers, DIST_PRCP's dry column read,
    the lane table, float count, mask count). Without DIST_PRCP the dry
    column's inputs, and without FROZEN_SOIL the fusion's, are zeros the
    kernels never read."""
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
        named.update(dict.fromkeys(DRY_INPUTS + DRY_LAYER_INPUTS,
                                   _const(device, f32, 0.0)),
                     case1_dry=_const(device, flag, False))
    floats = ([(k, named[k], 0) for k in SURFACE_INPUTS]
              + [(k, named[k], nl) for k in SURFACE_LAYER_INPUTS]
              + [(k, named[k], 0) for k in DRY_INPUTS]
              + [(k, named[k], nl) for k in DRY_LAYER_INPUTS])
    masks = [(k, named[k], 0) for k in SURFACE_MASKS + DRY_MASKS]
    frozen = bool(eb_kwargs.get("frozen_soil"))
    floats += [(k, eb_kwargs[k] if frozen else _const(device, f32, 0.0), 0)
               for k in FD_SURFACE_INPUTS]
    masks.append(("fs_active", eb_kwargs["fs_active"] if frozen
                  else _const(device, flag, False), 0))
    floats += extra
    table = _lane_inputs(floats, masks, shape, device)
    return shape, nl, dist, table, len(floats), len(masks)


# K5's bracket, its last float inputs (csrc/surface_brent.cu BoundIn)
SURFACE_BOUNDS = ("lo", "hi")
# the terms K5 writes at the accepted temperature, n floats each, in the
# order of csrc/surface_brent.cu's Term and, with DIST_PRCP, DryTerm: fields
# of physics.surface.SurfEBResult (layer_evap and, with DIST_PRCP,
# layer_evap_dry follow them as [lanes, nl] each)
SURFACE_TERMS = ("error", "t1", "grnd_flux", "delta_h", "fusion",
                 "latent_heat", "latent_heat_sub", "sensible_heat",
                 "snow_flux", "net_long_bare", "evap", "canopy_evap_mm",
                 "throughfall", "wdew_new", "refreeze_energy", "delta_cc",
                 "inc_vapor_flux")
SURFACE_DRY_TERMS = ("canopy_evap_mm_dry", "throughfall_dry", "wdew_new_dry",
                     "evap_dry")


@trace.kernel("surface_brent")
def surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K5: expand-then-Brent on the QUICK_FLUX soil-surface residual, with
    FROZEN_SOIL's fusion term where eb_kwargs["frozen_soil"], the active
    lanes compacted and dealt to persistent threads (csrc/lane_brent.cuh),
    and on every lane the balance's terms at the accepted temperature (the
    root, else TFALLBACK's eb_kwargs["ts_old"]). Same arguments and result
    as physics.surface.surface_brent_plain, a physics.surface.SurfaceSolve
    (iterations per lane; net_short_bare is the input itself, as there)."""
    from ..physics.surface import SurfaceSolve, SurfEBResult
    name = "surface_brent"
    if eb_kwargs.get("fd_solve") is not None \
            or eb_kwargs.get("fd_interp") is not None:
        raise ValueError(f"{name}: solves the QUICK_FLUX residual only")
    shape, nl, dist, table, nf, nm = _surface_lanes(
        name, lo, hi, active, eb_kwargs,
        extra=[(k, t, 0) for k, t in zip(SURFACE_BOUNDS, (lo, hi))])
    device = lo.device
    nt = len(SURFACE_TERMS) + (len(SURFACE_DRY_TERMS) if dist else 0)
    nlt = nl * (2 if dist else 1)
    outs, flat, _ = _lane_outputs(shape, device, floats=nt + nlt)
    n = outs.root.numel()
    terms = flat[:nt * n].view((nt,) + tuple(shape))
    layer = flat[nt * n:].view((nlt // nl,) + tuple(shape) + (nl,))
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().surface_brent(
            table.ctypes.data, nf, nm, shape[-1], nl, int(dist),
            float(eb_kwargs["delta_t"]),
            int(eb_kwargs.get("grnd_flux_type", 1)),
            int(bool(eb_kwargs.get("frozen_soil"))), int(max_iter), MAXTRIES,
            n, *_out_ptrs(outs), flat.data_ptr(), layer.data_ptr(), stream)
        _check_lane_brent(name, err)
    named = dict(zip(SURFACE_TERMS + SURFACE_DRY_TERMS, terms))
    if dist:
        named["layer_evap_dry"] = layer[1]
    return SurfaceSolve(*outs, terms=SurfEBResult(
        net_short_bare=eb_kwargs["shortwave_net_bare"],
        layer_evap=layer[0], **named))


# FROZEN_SOIL's fusion inputs and frozen-soil mask of K5, K7 and K14, after
# K5's others (csrc/surface_brent.cuh FdIn, kFsActive)
FD_SURFACE_INPUTS = ("moist0_vol", "max_moist0_vol", "ice0_vol", "bubble0",
                     "expt0")
# the float rows of K7's Brent state (csrc/fd_surface_brent.cu Row)
_FD_ROWS = 11


class FdRootResult(NamedTuple):
    """K7's result: RootResult's fields, iterations the Brent loop's trip
    count, then its profile solves (residual evaluations of every lane)
    and the sweeps of all of them; the counts int32 0-d device tensors,
    also added by the launch to trace's k7_trips, k7_solves, k7_sweeps."""
    root: torch.Tensor
    converged: torch.Tensor
    bracketed: torch.Tensor
    iterations: torch.Tensor
    solves: torch.Tensor
    sweeps: torch.Tensor


@trace.kernel("fd_surface_brent")
def fd_surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K7: the batch-wide Brent of physics.surface.surface_root_plain on
    the finite-difference residual as ONE cooperative launch: every
    residual evaluation solves the node profile of eb_kwargs["fd_solve"]
    (a physics.frozen_soil.NodeSolve) at the candidates of all lanes with
    K6's sweeps inside the same launch, and every decision of the loop is
    taken on the device, over every share of the NodeSolve's share group
    where it has one (`votes`: the launch then waits for the other shares
    at each decision, and the call for the launch). Same arguments as
    surface_root_plain; returns an FdRootResult."""
    from ..physics.frozen_soil import NodeSolve
    name = "fd_surface_brent"
    shape, nl, dist, table, nf, nm = _surface_lanes(name, lo, hi, active,
                                                    eb_kwargs)
    solve = eb_kwargs.get("fd_solve")
    if not isinstance(solve, NodeSolve):
        raise ValueError(f"{name}: solves the finite-difference residual "
                         "only: eb_kwargs['fd_solve'] must be a "
                         "physics.frozen_soil.NodeSolve, got "
                         f"{type(solve).__name__}")
    if tuple(solve.t0.shape[:-1]) != tuple(shape):
        raise ValueError(f"{name}: node profile lanes "
                         f"{tuple(solve.t0.shape[:-1])}, Brent lanes "
                         f"{tuple(shape)}")
    device, f32 = lo.device, torch.float32
    lo_c = _lanes(lo, shape, device, f32, "lo")
    hi_c = _lanes(hi, shape, device, f32, "hi")
    root = torch.empty(shape, dtype=f32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    bracketed = torch.empty(shape, dtype=torch.bool, device=device)
    n = root.numel()
    if not n:
        return FdRootResult(root, converged, bracketed,
                            *torch.zeros(3, dtype=torch.int32, device=device))
    counts = torch.empty(3, dtype=torch.int32, device=device)
    fields = solve._asdict()
    votes = fields.pop("votes")
    _sweep_views, sweep_args = _node_solve_args(name, **fields,
                                                fallbacks=False)
    max_iter, max_sweeps = int(max_iter), int(solve.max_sweeps)
    n_ctl = ((2 + 2 * MAXTRIES + max_iter) * 2 * max_sweeps + MAXTRIES
             + max_iter + 1)
    state = torch.empty((_FD_ROWS, n), dtype=f32, device=device)
    lane_flags = torch.empty((3, n), dtype=torch.uint8, device=device)
    ctl = torch.empty(n_ctl, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    group = votes.launch_table() if votes is not None else None
    err = build.load().fd_surface_brent(
        table.ctypes.data, nf, nm, shape[-1], nl, int(dist),
        float(eb_kwargs["delta_t"]), int(eb_kwargs.get("grnd_flux_type", 1)),
        int(bool(eb_kwargs.get("frozen_soil"))), max_iter, MAXTRIES,
        *sweep_args, state.data_ptr(), lane_flags.data_ptr(), ctl.data_ptr(),
        n_ctl, n, lo_c.data_ptr(), hi_c.data_ptr(), root.data_ptr(),
        converged.data_ptr(), bracketed.data_ptr(), *_out_ptrs(counts),
        trace.device_counter(device, "k7_trips"), _COOP_BLOCKS,
        _table_ptr(group), stream)
    _check_coop(name, err)
    if votes is not None:
        votes.settle(name)
    return FdRootResult(root, converged, bracketed, *counts)


# K14's inputs after K7's: the bracket ends of the two probes, the probe
# profiles and the Brent's bracket (csrc/affine_surface_brent.cu AffIn)
AFFINE_INPUTS = ("ts_a", "ts_b", "probe_lo", "probe_hi", "lo", "hi")


@trace.kernel("affine_surface_brent")
def affine_surface_brent(lo, hi, active, *, max_iter, eb_kwargs):
    """K14: expand-then-Brent on the finite-difference residual whose nodes
    1-2 are interpolated affinely between two probe profiles,
    eb_kwargs["fd_interp"] = (ts_a, t_a, ts_b, t_b), the active lanes
    compacted and dealt to persistent threads (csrc/lane_brent.cuh). Same
    arguments and result as physics.surface.surface_root_plain on that
    residual (iterations per lane)."""
    name = "affine_surface_brent"
    fd_interp = eb_kwargs.get("fd_interp")
    if fd_interp is None or eb_kwargs.get("fd_solve") is not None:
        raise ValueError(f"{name}: solves the affine two-probe residual "
                         "only (fd_interp, no fd_solve)")
    ts_a, t_a, ts_b, t_b = fd_interp
    nn = t_a.shape[-1]
    extra = [("ts_a", ts_a, 0), ("ts_b", ts_b, 0), ("probe_lo", t_a, nn),
             ("probe_hi", t_b, nn), ("lo", lo, 0), ("hi", hi, 0)]
    shape, nl, dist, table, nf, nm = _surface_lanes(
        name, lo, hi, active, eb_kwargs, extra=extra)
    outs = _root_outputs(shape, lo.device)
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = build.load().affine_surface_brent(
            table.ctypes.data, nf, nm, shape[-1], nl, int(dist), nn,
            float(eb_kwargs["delta_t"]),
            int(eb_kwargs.get("grnd_flux_type", 1)),
            int(bool(eb_kwargs.get("frozen_soil"))), int(max_iter), MAXTRIES,
            n, *_out_ptrs(outs), stream)
        _check_lane_brent(name, err)
    return outs


# the node counts K6 runs (csrc/node_sweep.cu): 3 to the reference's
# MAX_NODES
SWEEP_MIN_NODES, SWEEP_MAX_NODES = 3, 50
SWEEP_LANE_INPUTS = ("t0", "kappa", "cs", "moist_node", "ice0_node")
# [n_cell, nn] geometry, then the [n_cell] EXP_TRANS terms
SWEEP_GEOMETRY = ("alpha", "beta", "gamma", "e_coef", "solver_max_moist",
                  "solver_bubble", "solver_expt", "zp1")
SWEEP_CELL_GEOMETRY = ("exp_a", "bexp")
# the node-major coefficient rows of K6's scratch (csrc/node_sweep.cuh Coef)
_SWEEP_COEFS = 7


# K16's [n_cell, nn] geometry, in csrc/implicit_profile.cu's order
IMPLICIT_GEOMETRY = ("alpha", "beta", "gamma", "e_lin", "max_moist_node",
                     "bubble_term_node", "power_node")
# K16's node-major scratch, one buffer a (device, stream), grown to the
# largest call's and reused: the calls on one stream run one after another
_IMPLICIT_SCRATCH = {}


def _implicit_scratch(nn, n, device, stream):
    """K16's scratch for n lanes of nn nodes: the rows the library asks
    for (csrc/implicit_profile.cu implicit_profile_scratch_rows; none where
    the node count runs in registers) times nn times n floats, or None."""
    floats = build.load().implicit_profile_scratch_rows(nn) * nn * n
    if not floats:
        return None
    buf = _IMPLICIT_SCRATCH.get((device, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=torch.float32, device=device)
        _IMPLICIT_SCRATCH[(device, stream)] = buf
    return buf


@trace.kernel("implicit_profile")
def implicit_profile(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
                     fs_active, *, dt_sec, noflux, frozen, max_nr=12,
                     relax=None):
    """K16: the IMPLICIT soil-heat solve of every lane (Newton-Raphson with
    a Thomas solve per step), one thread per lane, at 3 to 50 nodes (3, 5
    and 10 in registers, any other on node-major scratch). Same
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
        work = _implicit_scratch(nn, n, device, stream)
        err = build.load().implicit_profile(
            _ptrs(lane), _ptrs(geo), surf.data_ptr(), fs.data_ptr(), n, h,
            nn, int(bool(frozen)), int(bool(noflux)), int(max_nr),
            int(relax is not None), float(relax or 0.0), float(dt_sec),
            float(2.0 * dt_sec), temp.data_ptr(), fbcount.data_ptr(), stream,
            None if work is None else work.data_ptr())
        _check_launch(name, err)
    return ProfileResult(temp=temp, fbcount=fbcount, iterations=int(max_nr))


# the grid of K6's and K7's cooperative launches: 0 for as many blocks as
# are co-resident on the device (at most one per 128 lanes)
_COOP_BLOCKS = 0
# their C interface's refusals (csrc/node_sweep.cuh)
_NO_COOPERATIVE_LAUNCH, _GRID_NOT_CO_RESIDENT = -1, -2


def _table_ptr(table):
    """The address of a C table (a numpy int64 array), or None."""
    return None if table is None else table.ctypes.data


def _check_coop(name, err):
    """_check_launch, naming the refusals of a cooperative launch."""
    if err == _NO_COOPERATIVE_LAUNCH:
        raise RuntimeError(f"{name}: the device has no cooperative launch "
                           "(cudaDevAttrCooperativeLaunch is 0), which the "
                           "kernel's grid-wide synchronisation needs")
    if err == _GRID_NOT_CO_RESIDENT:
        raise RuntimeError(f"{name}: a grid of {_COOP_BLOCKS} blocks is not "
                           "co-resident on the device; the cooperative "
                           "launch was refused")
    _check_launch(name, err)


def _node_solve_args(name, t0, kappa, cs, moist_node, ice0_node, geom,
                     fs_active, nlayer, dt_sec, noflux, frozen, max_sweeps,
                     exp_trans, *, fallbacks):
    """The node solve's C arguments (csrc/node_sweep.cuh fill_sweep_args,
    kernels.build's _NODE_SOLVE) from solve_t_profile_explicit's arguments
    but surf_temp, in physics.frozen_soil.NodeSolve's order, and the views
    and scratch they point to: (views, args). fallbacks: scratch for the
    fallback counts (K6; K7 does not return them)."""
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
    fs = _lanes(fs_active, (c,), device, torch.bool, "fs_active")
    n = c * h
    # csrc/node_sweep.cuh Work: the node-major coefficients (Coef), the
    # no-flux coefficient, the iterate, the fallback counts, the last change
    work = [torch.empty((_SWEEP_COEFS, nn, n), dtype=f32, device=device),
            torch.empty(n, dtype=f32, device=device),
            torch.empty((nn, n), dtype=f32, device=device),
            torch.empty((nn, n), dtype=i32, device=device) if fallbacks
            else None,
            torch.empty(n, dtype=f32, device=device)]
    work_ptrs = (ctypes.c_void_p * len(work))(
        *[w.data_ptr() if w is not None else None for w in work])
    args = (_ptrs(lane), _ptrs(geo), fs.data_ptr(), nn, int(nlayer),
            int(frozen), int(noflux), int(bool(exp_trans)), int(max_sweeps),
            float(dt_sec), float(2.0 * dt_sec), float(4.0 * dt_sec),
            work_ptrs)
    return (lane, geo, fs, work), args


@trace.kernel("node_sweep")
def node_sweep(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
               fs_active, *, nlayer, dt_sec, noflux, frozen, max_sweeps,
               exp_trans=False, votes=None):
    """K6: the Gauss-Seidel node sweep of every lane as ONE cooperative
    launch, the batch-wide sweep count decided on the device (over every
    share of `votes`' share group where it is one: the launch then waits
    for the other shares at each sweep, and the call for the launch), at 3
    to 50 nodes on linear or (exp_trans) EXP_TRANS spacing. Same arguments
    and result as physics.frozen_soil.solve_t_profile_explicit_plain (the
    sweep count as an int32 0-d tensor, also added by the launch to
    trace's k6_sweeps)."""
    from ..physics.frozen_soil import ProfileResult
    name = "node_sweep"
    _views, args = _node_solve_args(
        name, t0, kappa, cs, moist_node, ice0_node, geom, fs_active,
        nlayer=nlayer, dt_sec=dt_sec, noflux=noflux, frozen=frozen,
        max_sweeps=max_sweeps, exp_trans=exp_trans, fallbacks=True)
    device, i32 = t0.device, torch.int32
    c, h, _ = t0.shape
    surf = _lanes(surf_temp, (c, h), device, torch.float32, "surf_temp")
    temp = torch.empty(t0.shape, dtype=torch.float32, device=device)
    fbcount = torch.empty(t0.shape, dtype=i32, device=device)
    n = c * h
    if not n:
        return ProfileResult(temp=temp, fbcount=fbcount,
                             iterations=torch.zeros((), dtype=i32,
                                                    device=device))
    sweeps = torch.empty((), dtype=i32, device=device)
    ctl = torch.empty(2 * max(int(max_sweeps), 1), dtype=i32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    group = votes.launch_table() if votes is not None else None
    err = build.load().node_sweep(
        *args, surf.data_ptr(), n, h, ctl.data_ptr(), temp.data_ptr(),
        fbcount.data_ptr(), sweeps.data_ptr(),
        trace.device_counter(device, "k6_sweeps"), _COOP_BLOCKS,
        _table_ptr(group), stream)
    _check_coop(name, err)
    if votes is not None:
        votes.settle(name)
    return ProfileResult(temp=temp, fbcount=fbcount, iterations=sweeps)


# K8's inputs, in the order of csrc/blowing_snow.cu's In, and its mask
BLOWING_INPUTS = ("tair", "last_snow", "surf_water_m", "wind_2m", "ls",
                  "air_dens", "eact", "z0_snow", "snowdepth", "lag_one",
                  "sigma_slope", "fetch", "displacement", "roughness")
BLOWING_MASKS = ("is_bare",)
# calc_blowing_snow's arguments that its arithmetic never reads
BLOWING_UNUSED = ("pressure", "zrh", "tsnow")


@trace.kernel("blowing_snow")
def blowing_snow(*, dt_sec, quad_nodes, log_terms, **inputs):
    """K8: calc_blowing_snow of every lane in one launch, the snow lanes
    of each block's chunk compacted and their (lane, wind increment) items
    dealt to its threads. Same arguments and result as
    physics.blowing_snow.calc_blowing_snow_plain: (flux, transport), each
    of the lanes' broadcast shape."""
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
    table = _lane_inputs([(k, inputs[k], 0) for k in BLOWING_INPUTS],
                         [(k, inputs[k], 0) for k in BLOWING_MASKS], shape,
                         device)
    nodes = _lanes(quad_nodes, (16,), device, f32, "quad_nodes")
    logs = _lanes(log_terms, (20,), device, f32, "log_terms")
    flux = torch.empty(shape, dtype=f32, device=device)
    transport = torch.empty(shape, dtype=f32, device=device)
    n = flux.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().blowing_snow(
            table.ctypes.data, len(BLOWING_INPUTS), len(BLOWING_MASKS),
            shape[-1], float(dt_sec), nodes.data_ptr(), logs.data_ptr(), n,
            flux.data_ptr(), transport.data_ptr(), stream)
        _check_launch(name, err)
    return flux, transport


# K9's inputs, in the order of csrc/canopy_air.cu's In and Mask; the
# final update reads the first seven and the first mask
CANOPY_AIR_INPUTS = ("canopy_sensible", "soil_sensible", "pack_sensible",
                     "cov_w", "tair", "air_dens", "ra_over", "tc", "tc_prev",
                     "g_prev")
CANOPY_AIR_MASKS = ("iter_mask", "lane_mask")
CANOPY_AIR_FINAL_INPUTS = CANOPY_AIR_INPUTS[:7]
# the inputs that stay the same over a record's passes
CANOPY_AIR_RECORD = ("tair", "air_dens", "ra_over", "iter_mask", "lane_mask")


class _CanopyAirScratch:
    """What K9 keeps on a device and stream between calls (the shares of a
    split block on one card each have their own): its accumulator and ticket
    (two int32, zeroed once; every launch leaves them 0), the pinned host
    word the last block writes the batch's largest change to, with its
    device address, the event recorded after the last launch, and the lane
    table of the last call's record inputs (rows written once a record,
    the per-pass rows patched)."""

    def __init__(self, device):
        self.acc = torch.zeros(2, dtype=torch.int32, device=device)
        self.host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self.host_bits = self.host.numpy()
        dev = ctypes.c_void_p()
        err = build.load().canopy_air_host_word(
            ctypes.c_void_p(self.host.data_ptr()), ctypes.byref(dev))
        if err != 0:
            raise RuntimeError("canopy_air_step: the pinned host word has no "
                               f"device address (CUDA error {err})")
        self.host_dev = dev.value
        self.event = torch.cuda.Event()
        self.last = None        # the live_max tensor of the last launch
        self.record = None      # (record tensors, shape, lane table)


# K9's scratch of each (device, stream)
_canopy_air = {}


def _canopy_air_table(inputs, shape, device, scratch):
    """K9's lane table: the record inputs' rows from the last call when its
    tensors are these very tensors at this lane shape (identical rows),
    else written anew; the per-pass rows written into it."""
    record = tuple(inputs[k] for k in CANOPY_AIR_RECORD)
    cached = scratch.record
    if cached is None or cached[1] != shape or any(
            a is not b for a, b in zip(cached[0], record)):
        table = _lane_inputs([(k, inputs[k], 0) for k in CANOPY_AIR_INPUTS],
                             [(k, inputs[k], 0) for k in CANOPY_AIR_MASKS],
                             shape, device)
        scratch.record = (record, shape, table)
        return table
    table = cached[2]
    per_pass = [(k, inputs[k], 0) for k in CANOPY_AIR_INPUTS
                if k not in CANOPY_AIR_RECORD]
    rows = _lane_inputs(per_pass, [], shape, device).reshape(-1, 4)
    table.reshape(-1, 4)[[CANOPY_AIR_INPUTS.index(k)
                          for k, _, _ in per_pass]] = rows
    return table


@trace.kernel("canopy_air_step")
def canopy_air_step(*, it, **inputs):
    """K9: one CLOSE_ENERGY pass's canopy-air update on every lane and the
    batch's largest masked change, reduced on the device. Same arguments and
    result as physics.canopy_air.canopy_air_step_plain: (tc_next, g,
    live_max as a 0-d float32 tensor, NaN if any change is NaN). One launch:
    no fill (the kernel leaves its accumulator at 0) and no copy; the
    largest change also goes to a pinned host word, which
    `canopy_air_largest_change(live_max)` reads after an event."""
    name = "canopy_air_step"
    device = inputs["tc"].device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, CANOPY_AIR_INPUTS + CANOPY_AIR_MASKS)
    shape = torch.broadcast_shapes(*(t.shape for t in inputs.values()))
    stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream)
    scratch = _canopy_air.get(key)
    if scratch is None:
        scratch = _canopy_air[key] = _CanopyAirScratch(device)
    table = _canopy_air_table(inputs, shape, device, scratch)
    f32 = torch.float32
    out = torch.empty((2,) + tuple(shape), dtype=f32, device=device)
    live_bits = torch.empty((), dtype=torch.int32, device=device)
    n = out[0].numel()
    if n:
        err = build.load().canopy_air_step(
            table.ctypes.data, len(CANOPY_AIR_INPUTS), len(CANOPY_AIR_MASKS),
            shape[-1], int(it), n, out[0].data_ptr(), out[1].data_ptr(),
            scratch.acc.data_ptr(), live_bits.data_ptr(), scratch.host_dev,
            stream.cuda_stream)
        _check_launch(name, err)
        scratch.event.record(stream)
    live_max = live_bits.view(f32)
    scratch.last = live_max
    return out[0], out[1], live_max


def canopy_air_largest_change(live_max):
    """The batch's largest change of a K9 launch as a Python float: for the
    last launch on its device and the current stream, its pinned host word
    after its event (no copy launched); else the tensor's value."""
    device = live_max.device
    scratch = _canopy_air.get(
        (device, torch.cuda.current_stream(device).cuda_stream))
    if scratch is None or scratch.last is not live_max:
        return float(live_max)
    scratch.event.synchronize()
    return float(scratch.host_bits.view(np.float32)[0])


@trace.kernel("canopy_air_final")
def canopy_air_final(**inputs):
    """K9's final update: on the settled pass, calc_atmos_energy_bal's
    Tcanopy on the iterated lanes (Tair elsewhere), its fallback flag
    there, and the atmospheric sensible heat (the understory's elsewhere),
    in one launch. Same arguments and result as
    physics.canopy_air.canopy_air_final_plain: (tcanopy, fbflag,
    sensible)."""
    name = "canopy_air_final"
    device = inputs["tair"].device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, CANOPY_AIR_FINAL_INPUTS + ("iter_mask",))
    shape = torch.broadcast_shapes(*(t.shape for t in inputs.values()))
    table = _lane_inputs(
        [(k, inputs[k], 0) for k in CANOPY_AIR_FINAL_INPUTS],
        [("iter_mask", inputs["iter_mask"], 0)], shape, device)
    n = 1
    for d in shape:
        n *= d
    buf = torch.empty(9 * n, dtype=torch.uint8, device=device)
    floats = buf[:8 * n].view(torch.float32).view((2,) + tuple(shape))
    fbflag = buf[8 * n:].view(torch.bool).view(shape)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().canopy_air_final(
            table.ctypes.data, len(CANOPY_AIR_FINAL_INPUTS), 1, shape[-1], n,
            floats[0].data_ptr(), fbflag.data_ptr(), floats[1].data_ptr(),
            stream)
        _check_launch(name, err)
    return floats[0], fbflag, floats[1]


# the lake kernels K10-K13 (K10, K11 one warp per lake, K12 on the lane
# driver, K13 one thread per lake; lanes [n_cell])
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
# the fields of K12's residual after dt (csrc/lake_ice_melt.cu IceResidual,
# physics.lake.ice_energy_terms' keyword arguments), which its prologue forms
ICE_EB_INPUTS = ("ra", "z_ref", "roughness", "wind", "net_short",
                 "longwave_in", "air_dens", "lv", "tair", "pressure", "vpd",
                 "vp_air", "rain_m", "surf_water", "tcutoff", "avgcond",
                 "sw_conducted", "blowing_flux")
# K12's float inputs, lake_ice_melt's arguments in the order of
# csrc/lake_ice_melt.cu's In (blowing_flux a zero broadcast to the lakes
# without BLOWING), and its outputs after the terms (IceOut)
ICE_MELT_INPUTS = ("swq", "surf_temp", "pack_temp", "surf_water",
                   "pack_water", "lake_ice_m", "hice", "rainfall_mm",
                   "snowfall_mm", "tair", "wind", "vp_air", "vpd", "pressure",
                   "air_dens", "longwave_in", "net_short", "tcutoff", "ra",
                   "z_ref", "roughness", "blowing_flux")
ICE_MELT_OUTPUTS = ("swq", "surf_temp", "pack_temp", "surf_water",
                    "pack_water", "melt_m", "ice_melt_m", "lake_ice_m",
                    "vapor_flux", "cold_content", "sw_under_ice")


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
    floats = ([("temp", temp, LAKE_NN), ("z", grid.z, LAKE_NN),
               ("zhalf", grid.zhalf, LAKE_NN),
               ("surface", grid.surface, LAKE_NN + 1)]
              + [(k, named[k], 0) for k in keys])
    masks = [("active", active, 0), ("mask", grid.mask, LAKE_NN),
             ("last", grid.last, LAKE_NN)]
    table = _lane_inputs(floats, masks, shape, device)
    return shape, table, len(floats), len(masks)


def _check_names(name, inputs, expected):
    if set(inputs) != set(expected):
        raise TypeError(f"{name}: missing inputs "
                        f"{sorted(set(expected) - set(inputs))}, unexpected "
                        f"{sorted(set(inputs) - set(expected))}")


@trace.kernel("lake_open_water")
def lake_open_water(*, temp, grid, dt_sec, active, **inputs):
    """K10: the open-water skin-temperature fixed point and the mix of its
    column, one warp per lake. Same arguments and result as
    physics.lake.lake_open_water_plain: (WaterEBResult, t_open), with the
    iterations each lake ran."""
    from ..physics.lake import WaterEBResult
    name = "lake_open_water"
    _check_names(name, inputs, set(OPEN_WATER_INPUTS) - {"surfdz", "dz"})
    named = dict(inputs, surfdz=grid.surfdz, dz=grid.dz)
    shape, table, nf, nm = _column_lanes(name, temp, grid, active, named,
                                         OPEN_WATER_INPUTS)
    device, n = temp.device, shape[0]
    t_out = torch.empty((n, LAKE_NN), dtype=torch.float32, device=device)
    t_open = torch.empty_like(t_out)
    sc = torch.empty((10, n), dtype=torch.float32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_open_water(
            table.ctypes.data, nf, nm, n, float(dt_sec), n,
            t_out.data_ptr(), t_open.data_ptr(), sc.data_ptr(),
            converged.data_ptr(), iterations.data_ptr(), stream)
        _check_launch(name, err)
    return WaterEBResult(t_out, *sc.unbind(0), converged, iterations), t_open


@trace.kernel("lake_under_ice")
def lake_under_ice(*, temp, grid, dt_sec, active, **inputs):
    """K11: the ice/water interface flux fixed point of the column under
    lake ice, its column solved and mixed every iteration, one warp per
    lake. Same arguments and result as physics.lake.water_under_ice_plain
    (UnderIceResult, with the iterations each lake ran)."""
    from ..physics.lake import UnderIceResult
    name = "lake_under_ice"
    _check_names(name, inputs, (set(UNDER_ICE_INPUTS) - {"surfdz", "dz"})
                 | set(UNDER_ICE_UNUSED))
    named = dict(inputs, surfdz=grid.surfdz, dz=grid.dz)
    shape, table, nf, nm = _column_lanes(name, temp, grid, active, named,
                                         UNDER_ICE_INPUTS)
    device, n = temp.device, shape[0]
    t_out = torch.empty((n, LAKE_NN), dtype=torch.float32, device=device)
    sc = torch.empty((3, n), dtype=torch.float32, device=device)
    converged = torch.empty(shape, dtype=torch.bool, device=device)
    iterations = torch.empty(shape, dtype=torch.int32, device=device)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_under_ice(
            table.ctypes.data, nf, nm, n, float(dt_sec), n,
            t_out.data_ptr(), sc.data_ptr(), converged.data_ptr(),
            iterations.data_ptr(), stream)
        _check_launch(name, err)
    qw, delta_h, e_bot = sc.unbind(0)
    return UnderIceResult(temp=t_out, qw=qw, delta_h=delta_h,
                          energy_out_bottom=e_bot, converged=converged,
                          iterations=iterations)


@trace.kernel("lake_ice_melt")
def lake_ice_melt(*, dt_sec, max_iter=30, blowing_flux=0.0, active=None,
                  **inputs):
    """K12: the whole of lake_ice_melt in one launch on
    csrc/lane_brent.cuh: on every lake the fresh snow's distribution,
    icerad, the balance at 0 C and the melt and thin tests; then
    expand-then-Brent on the ice balance from old_tsurf -/+ SNOW_DT on the
    lakes of `active` (None: every lake) whose snow neither melts nor is
    thin, compacted and dealt to persistent threads; then on every lake the
    balance at the accepted temperature and the state update. Same
    arguments and result as physics.lake.lake_ice_melt_plain (an
    IceMeltResult whose `solve` holds the Brent's outputs, iterations per
    lake)."""
    from ..physics.lake import IceEBTerms, IceMeltResult
    name = "lake_ice_melt"
    device = inputs["swq"].device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, ICE_MELT_INPUTS[:-1])
    named = dict(inputs)
    named["blowing_flux"] = (blowing_flux if isinstance(blowing_flux,
                                                        torch.Tensor)
                             else _const(device, torch.float32,
                                         float(blowing_flux)))
    if active is None:
        active = _const(device, torch.bool, True)
    shape = torch.broadcast_shapes(active.shape,
                                   *(named[k].shape for k in ICE_MELT_INPUTS))
    table = _lane_inputs([(k, named[k], 0) for k in ICE_MELT_INPUTS],
                         [("active", active, 0)], shape, device)
    nt = len(IceEBTerms._fields)
    outs, floats, flags = _lane_outputs(
        shape, device, floats=nt + len(ICE_MELT_OUTPUTS), flags=1)
    floats = floats.view((-1,) + tuple(shape))
    n = outs.root.numel()
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_ice_melt(
            table.ctypes.data, len(ICE_MELT_INPUTS), 1, shape[-1],
            float(dt_sec), int(max_iter), MAXTRIES, n, *_out_ptrs(outs),
            floats.data_ptr(), flags.data_ptr(), stream)
        _check_lane_brent(name, err)
    terms = IceEBTerms(*floats[:nt])
    return IceMeltResult(**dict(zip(ICE_MELT_OUTPUTS, floats[nt:])),
                         qnet=terms.rest, surf_temp_fbflag=flags[0],
                         terms=terms, solve=outs)


@trace.kernel("lake_depth")
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
    table = _lane_inputs(
        [("z", z, LAKE_NN + 1), ("basin", basin, LAKE_NN + 1),
         ("maxdepth", maxdepth, 0), ("volume", volume, 0)], [], shape,
        device)
    depth = torch.empty(shape, dtype=f32, device=device)
    n = shape[0]
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_depth(table.ctypes.data, 4, n, n,
                                      depth.data_ptr(), stream)
        _check_launch(name, err)
    return depth


# lake_water_balance's float inputs, in the order of
# csrc/lake_water_balance.cu's In: (name, where it is read from, axes:
# "c" per lake, "b" the basin's levels, "l" per lane, "ll" per lane and
# soil layer)
LAKE_BALANCE_INPUTS = (
    ("z", "lp", "b"), ("basin", "lp", "b"), ("maxdepth", "lp", "c"),
    ("mindepth", "lp", "c"), ("minvolume", "lp", "c"),
    ("maxvolume", "lp", "c"), ("wfrac", "lp", "c"),
    ("volume", "st", "c"), ("ice_area", "st", "c"), ("swe", "st", "c"),
    ("volume", "s1", "c"), ("ice_water_eq", "s1", "c"), ("swe", "s1", "c"),
    ("evap_m3", "res", "c"), ("ice_throughfall_m3", "res", "c"),
    ("store_dump_m3", "res", "c"), ("snowmelt_m3", "res", "c"),
    ("new_ice_area", "res", "c"), ("sarea", "res", "c"),
    ("precip_in_m3", "res", "c"), ("vapor_flux_m3", "res", "c"),
    ("runoff_in_m3", "kw", "c"), ("baseflow_in_m3", "kw", "c"),
    ("ds", "kw", "c"), ("dsmax", "kw", "c"), ("ws_arno", "kw", "c"),
    ("c_expt", "kw", "c"), ("wetland_rel_moist", "kw", "l"),
    ("wetland_moist", "kw", "ll"), ("wetland_max_moist", "kw", "ll"))
LAKE_BALANCE_KWARGS = ("runoff_in_m3", "baseflow_in_m3", "ds", "dsmax",
                       "ws_arno", "dt_sec", "c_expt", "wetland_moist",
                       "wetland_max_moist", "wetland_rel_moist", "active",
                       "lane_mask")
# its per-lake outputs (csrc/lake_water_balance.cu Out)
LAKE_BALANCE_OUTPUTS = ("volume", "evap_m3", "runoff_out_m3",
                        "baseflow_out_m3", "recharge_m3", "max_newfraction",
                        "depth", "sarea", "water_error_mm")


@trace.kernel("lake_water_balance")
def lake_water_balance(lp, st, res, **inputs):
    """The lakes' water balance after solve_lake, one thread per lake: the
    HRU lanes' passes in order (gains and evaporation cap, new extent,
    flooding recharge of the lane's wetland soil, lake-bed baseflow, weir
    and growth caps, dry test), each lane's final and largest new fraction,
    the final depth and area and the closure telemetry, in one launch. Same
    arguments and result as physics.lake.lake_water_balance_plain (a
    physics.lake.WaterBalance)."""
    from ..physics.lake import WaterBalance
    name = "lake_water_balance"
    device = st.volume.device
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors required, got {device}")
    _check_names(name, inputs, LAKE_BALANCE_KWARGS)
    lane_mask = inputs["lane_mask"]
    if lane_mask.dim() != 2 or lane_mask.shape[0] != st.volume.shape[0]:
        raise ValueError(f"{name}: lane_mask must be [n_cell, lanes], got "
                         f"{tuple(lane_mask.shape)}")
    n, n_lane = lane_mask.shape
    f32 = torch.float32
    wetland = inputs["wetland_moist"] is not None
    nl = inputs["wetland_moist"].shape[-1] if wetland else 0
    zero, one = _const(device, f32, 0.0), _const(device, f32, 1.0)
    named = dict(inputs)
    if inputs["c_expt"] is None:
        named["c_expt"] = _const(device, f32, 2.0)
    if not wetland:
        named.update(wetland_moist=zero, wetland_max_moist=zero)
    if not wetland or inputs["wetland_rel_moist"] is None:
        named["wetland_rel_moist"] = one
    sources = {"lp": lp, "st": st, "s1": res.state, "res": res}
    table = []
    for key, where, axes in LAKE_BALANCE_INPUTS:
        x = (named[key] if where == "kw"
             else getattr(sources[where], key))
        _check_input(x, device, f32, key)
        if axes == "c":
            table += (x.data_ptr(), *_broadcast_strides(x, (n,), key), 0, 0)
        elif axes == "b":
            s = _broadcast_strides(x, (n, LAKE_NN + 1), key)
            table += (x.data_ptr(), s[0], 0, s[1])
        elif axes == "l":
            table += (x.data_ptr(), *_broadcast_strides(x, (n, n_lane), key),
                      0)
        else:
            table += (x.data_ptr(),
                      *_broadcast_strides(x, (n, n_lane, max(nl, 1)), key))
    for key, x, shape in (("has_lake", lp.has_lake, (n,)),
                          ("active", inputs["active"], (n,)),
                          ("lane_mask", lane_mask, (n, n_lane))):
        _check_input(x, device, torch.bool, key)
        s = _broadcast_strides(x, shape, key)
        table += (x.data_ptr(), *s, *(0,) * (3 - len(s)))
    table = np.array(table, np.int64)
    k = len(LAKE_BALANCE_OUTPUTS)
    buf = torch.empty(k * n + n * n_lane * (2 + nl), dtype=f32,
                      device=device)
    out = buf[:k * n].view(k, n)
    lanes = buf[k * n:k * n + 2 * n * n_lane].view(2, n, n_lane)
    dmoist = buf[k * n + 2 * n * n_lane:].view(n, n_lane, nl)
    if n:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.load().lake_water_balance(
            table.ctypes.data, len(LAKE_BALANCE_INPUTS), 3, n_lane, nl,
            float(inputs["dt_sec"]), n, out.data_ptr(), lanes[0].data_ptr(),
            lanes[1].data_ptr(), dmoist.data_ptr(), stream)
        _check_launch(name, err)
    return WaterBalance(*out.unbind(0), lane_nf=lanes[0],
                        lane_maxnf=lanes[1],
                        wetland_dmoist_mm=dmoist if wetland else None)
