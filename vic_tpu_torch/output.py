"""Output engine: variable registry, temporal aggregation, and format writers.

A copy of `vic_tpu/output.py`, the reference output stack:
- variable metadata registry — variable_mapping.c:59-243 (units / NetCDF
  name / CF standard_name / long_name / cell_methods) and
  output_list_utils.c (aggregation types);
- temporal aggregation by AGG_TYPE END/SUM/AVG with rate variables divided by
  the output interval — put_data.c:665-710;
- NetCDF-4 writer: single file for all cells, dims (time[, depth|node], lat,
  lon), per-variable deflate, time-major all-cells-per-step writes —
  WriteOutputNetCDF.c:163-445;
- packed BINARY writer — WriteOutputBinary.c:99-293;
- ASCII writer: legacy per-cell ``fluxes_<lat>_<lon>`` files —
  WriteOutputAscii.c.

The step's per-record output dict (keyed by the reference OUT_* ids, moved
to the host as numpy) is aggregated in numpy and written through the
port's native vicio NetCDF layer or plain file writes. The BINARY and
ASCII writers write each cell's file in one piece, byte for byte what
vic_tpu's writers write record by record.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

# aggregation methods (output_list_utils.c AGG_TYPE_*)
AGG_SUM = "sum"    # accumulate over output interval (fluxes in mm)
AGG_AVG = "avg"    # average over output interval
AGG_END = "end"    # instantaneous value at end of interval (states)


@dataclass(frozen=True)
class OutVarMeta:
    units: str
    nc_name: str
    standard_name: str
    long_name: str
    cell_methods: str
    agg: str = AGG_AVG
    dim: Optional[str] = None   # extra dimension: "layer" | "node" | None


_M = OutVarMeta

# Registry lifted from variable_mapping.c:59-243 (subset currently produced by
# the model; extend as physics lands). Water fluxes aggregate by SUM, states
# by END, energy/met by AVG — put_data.c conventions.
OUTVAR_META: Dict[str, OutVarMeta] = {
    # water states
    "OUT_SWE": _M("mm", "SWE", "lwe_thickness_of_surface_snow_amount",
                  "Snow water equivalent in snow pack", "time: point area: mean",
                  AGG_END),
    "OUT_SNOW_DEPTH": _M("cm", "SNOW_DEPTH", "surface_snow_thickness",
                         "Snow depth", "time: point area: mean", AGG_END),
    "OUT_SNOW_COVER": _M("1", "SNOW_COVER", "surface_snow_area_fraction",
                         "Snow area fraction", "time: point area: sum", AGG_END),
    "OUT_SNOW_CANOPY": _M("mm", "SNOW_CANOPY", "",
                          "Snow interception storage in canopy",
                          "time: point area: mean", AGG_END),
    "OUT_WDEW": _M("mm", "WDEW", "lwe_thickness_of_canopy_water_amount",
                   "Total moisture interception storage in canopy",
                   "time: point area: mean", AGG_END),
    "OUT_SOIL_MOIST": _M("mm", "SOIL_MOIST",
                         "lwe_thickness_of_soil_moisture_content",
                         "Soil total moisture content for soil layer",
                         "time: point area: mean", AGG_END, dim="layer"),
    "OUT_SOIL_LIQ": _M("mm", "SOIL_LIQ",
                       "lwe_thickness_of_liquid_water_content_of_soil_layer",
                       "Water content of soil layer", "time: point area: mean",
                       AGG_END, dim="layer"),
    "OUT_SOIL_ICE": _M("mm", "SOIL_ICE",
                       "lwe_thickenss_of_frozen_water_content_of_soil_layer",
                       "Soil ice content of soil layer",
                       "time: point area: mean", AGG_END, dim="layer"),
    "OUT_SOIL_MOIST_TOT": _M("mm", "SOIL_MOIST_TOT", "soil_moisture_content",
                             "Total soil moisture content",
                             "time: point area: mean", AGG_END),
    "OUT_ROOTMOIST": _M("mm", "ROOTMOIST", "", "Root zone soil moisture",
                        "time: point area: mean", AGG_END),
    "OUT_SOIL_WET": _M("1", "SOIL_WET", "",
                       "Vertical average soil wetness", "time: point area: mean",
                       AGG_END),
    "OUT_ASAT": _M("1", "ASAT", "", "Saturated area fraction",
                   "time: point area: sum", AGG_END),
    # water fluxes
    "OUT_PREC": _M("mm", "PREC", "lwe_thickness_of_precipitation_amount",
                   "Precipitation", "time: mean area: mean", AGG_SUM),
    "OUT_RAINF": _M("mm", "RAINF", "thickness_of_rainfall_amount", "Rainfall",
                    "time: mean area: mean", AGG_SUM),
    "OUT_SNOWF": _M("mm", "SNOWF", "lwe_thickness_of_snowfall_amount",
                    "Snowfall", "time: mean area: mean", AGG_SUM),
    "OUT_EVAP": _M("mm", "EVAP", "lwe_thickness_of_water_evaporation_amount",
                   "Total net evaporation", "time: mean area: mean", AGG_SUM),
    "OUT_EVAP_BARE": _M("mm", "EVAP_BARE",
                        "lwe_thickness_of_water_evaporation_amount_from_soil",
                        "Net evaporation from bare soil",
                        "time: mean area: mean", AGG_SUM),
    "OUT_EVAP_CANOP": _M("mm", "EVAP_CANOP",
                         "lwe_thickness_of_water_evaporation_amount_from_canopy",
                         "Net evaporation from canopy interception",
                         "time: mean area: mean", AGG_SUM),
    "OUT_TRANSP_VEG": _M("mm", "TRANSP_VEG", "thickness_of_transpiration_amount",
                         "Transpiration", "time: mean area: mean", AGG_SUM),
    "OUT_SUB_SNOW": _M("mm", "SUB_SNOW",
                       "lwe_thickness_of_surface_snow_sublimation_amount",
                       "Total net sublimation from snow pack",
                       "time: mean area: mean", AGG_SUM),
    "OUT_RUNOFF": _M("mm", "RUNOFF", "thickness_of_surface_runoff_amount",
                     "Surface runoff", "time: mean area: mean", AGG_SUM),
    "OUT_BASEFLOW": _M("mm", "BASEFLOW", "lwe_thickness_of_baseflow_amount",
                       "Baseflow out of the bottom layer",
                       "time: mean area: mean", AGG_SUM),
    "OUT_INFLOW": _M("mm", "INFLOW", "", "Moisture that reaches top of soil column",
                     "time: mean area: mean", AGG_SUM),
    "OUT_SNOW_MELT": _M("mm", "SNOW_MELT", "thickness_of_surface_snow_melt_amount",
                        "Snow melt", "time: mean area: mean", AGG_SUM),
    "OUT_WATER_ERROR": _M("mm", "WATER_ERROR", "", "Water budget error",
                          "time: mean area: mean", AGG_SUM),
    "OUT_PET_SATSOIL": _M("mm", "PET_SATSOIL",
                          "lwe_thickness_of_water_potential_evaporation_amount",
                          "Potential evap from saturated bare soil",
                          "time: mean area: mean", AGG_SUM),
    "OUT_PET_H2OSURF": _M("mm", "PET_H20SURF",
                          "lwe_thickness_of_water_potential_evaporation_amount",
                          "Potential evap from open water",
                          "time: mean area: mean", AGG_SUM),
    "OUT_PET_SHORT": _M("mm", "PET_SHORT",
                        "lwe_thickness_of_water_potential_evaporation_amount",
                        "Potential evap from short reference crop",
                        "time: mean area: mean", AGG_SUM),
    "OUT_PET_TALL": _M("mm", "PET_TALL",
                       "lwe_thickness_of_water_potential_evaporation_amount",
                       "Potential evap from tall reference crop",
                       "time: mean area: mean", AGG_SUM),
    "OUT_PET_NATVEG": _M("mm", "PET_NATVEG",
                         "lwe_thickness_of_water_potential_evaporation_amount",
                         "Potential evap from current vegetation",
                         "time: mean area: mean", AGG_SUM),
    "OUT_PET_VEGNOCR": _M("mm", "PET_VEGNOCR",
                          "lwe_thickness_of_water_potential_evaporation_amount",
                          "Potential evap, no canopy resistance",
                          "time: mean area: mean", AGG_SUM),
    # energy fluxes
    "OUT_NET_SHORT": _M("W m-2", "NET_SHORT", "net_downward_shortwave_flux_in_air",
                        "Net downward shortwave flux", "time: mean area: mean"),
    "OUT_NET_LONG": _M("W m-2", "NET_LONG", "net_downward_longwave_flux_in_air",
                       "Net downward longwave flux", "time: mean area: mean"),
    "OUT_LATENT": _M("W m-2", "LATENT", "surface_upward_latent_heat_flux",
                     "Net upward latent heat flux", "time: mean area: mean"),
    "OUT_LATENT_SUB": _M("W m-2", "LATENT_SUB", "",
                         "Net upward latent heat flux from sublimation",
                         "time: mean area: mean"),
    "OUT_SENSIBLE": _M("W m-2", "SENSIBLE", "surface_upward_sensible_heat_flux",
                       "Net upward sensible heat flux", "time: mean area: mean"),
    "OUT_GRND_FLUX": _M("W m-2", "GRND_FLUX",
                        "downward_heat_flux_at_ground_level_in_soil",
                        "Net heat flux into ground", "time: mean area: mean"),
    "OUT_DELTAH": _M("W m-2", "DELTAH", "", "Rate of change in heat storage",
                     "time: mean area: mean"),
    "OUT_FUSION": _M("W m-2", "FUSION", "",
                     "Net energy used to melt/freeze soil moisture",
                     "time: mean area: mean"),
    "OUT_SNOW_FLUX": _M("W m-2", "SNOW_FLUX",
                        "downward_heat_flux_at_ground_level_in_snow",
                        "Energy flux through snow pack", "time: mean area: mean"),
    "OUT_ADVECTION": _M("W m-2", "ADVECTION", "", "Advected energy",
                        "time: mean area: mean"),
    "OUT_DELTACC": _M("W m-2", "DELTACC", "",
                      "Rate of change in cold content in snow pack",
                      "time: mean area: mean"),
    "OUT_RFRZ_ENERGY": _M("W m-2", "RFRZ_ENERGY", "",
                          "Net energy used to refreeze liquid water in snowpack",
                          "time: mean area: mean"),
    "OUT_MELT_ENERGY": _M("W m-2", "MELT_ENERGY", "surface_snow_melt_heat_flux",
                          "Energy of fusion (melting) in snowpack",
                          "time: mean area: mean"),
    "OUT_ENERGY_ERROR": _M("W m-2", "ENERGY_ERROR", "", "Energy budget error",
                           "time: mean area: mean"),
    # temperatures / surface states
    "OUT_SURF_TEMP": _M("degree_Celsius", "SURF_TEMP", "surface_temperature",
                        "Average surface temperature", "time: point area: mean",
                        AGG_AVG),
    "OUT_RAD_TEMP": _M("K", "RAD_TEMP", "", "Average radiative surface temperature",
                       "time: point area: mean"),
    "OUT_BARESOILT": _M("degree_Celsius", "BARESOILT", "",
                        "Bare soil surface temperature", "time: point area: mean"),
    "OUT_SNOW_SURF_TEMP": _M("degree_Celsius", "SNOW_SURF_TEMP",
                             "surface_temperature_where_snow",
                             "Snow surface temperature", "time: point area: mean"),
    "OUT_SNOW_PACK_TEMP": _M("degree_Celsius", "SNOW_PACK_TEMP", "",
                             "Snow pack temperature", "time: point area: mean"),
    "OUT_SOIL_TEMP": _M("degree_Celsius", "SOIL_TEMP", "soil_temperature",
                        "Soil temperature for each layer",
                        "time: point area: mean", AGG_AVG, dim="layer"),
    "OUT_SOIL_TNODE": _M("degree_Celsius", "SOIL_TNODE", "",
                         "Soil temperature for each thermal node",
                         "time: point area: mean", AGG_AVG, dim="node"),
    "OUT_ALBEDO": _M("1", "ALBEDO", "surface_albedo", "Average surface albedo",
                     "time: point area: mean"),
    "OUT_SALBEDO": _M("1", "SALBEDO", "surface_albedo_assuming_deep_snow",
                      "Snow pack albedo", "time: point area: mean"),
    "OUT_SURFT_FBFLAG": _M("", "SURFT_FBFLAG", "",
                           "Surface temperature fallback count",
                           "time: point area: mean", AGG_SUM),
    "OUT_SNOWT_FBFLAG": _M("", "SNOWT_FBFLAG", "",
                           "Snow surface temperature fallback count",
                           "time: point area: mean", AGG_SUM),
    # met echo
    "OUT_AIR_TEMP": _M("degree_Celsius", "AIR_TEMP", "air_temperature",
                       "Air temperature", "time: mean area: mean"),
    "OUT_WIND": _M("m s-1", "WIND", "wind_speed", "Near surface wind speed",
                   "time: mean area: mean"),
    "OUT_SHORTWAVE": _M("W m-2", "SHORTWAVE", "downwelling_shortwave_flux_in_air",
                        "Incoming shortwave", "time: mean area: mean"),
    "OUT_LONGWAVE": _M("W m-2", "LONGWAVE", "downwelling_longwave_flux_in_air",
                       "Incoming longwave", "time: mean area: mean"),
    "OUT_DENSITY": _M("kg m-3", "DENSITY", "air_density",
                      "Near surface atmospheric density", "time: mean area: mean"),
    "OUT_PRESSURE": _M("kPa", "PRESSURE", "surface_air_pressure",
                       "Near surface atmospheric pressure",
                       "time: mean area: mean"),
    "OUT_VP": _M("kPa", "VP", "water_vapor_partial_pressure_in_air",
                 "Near surface vapor pressure", "time: mean area: mean"),
    "OUT_VPD": _M("kPa", "VPD", "water_vapor_saturation_deficit_in_air",
                  "Near surface vapor pressure deficit", "time: mean area: mean"),
    "OUT_REL_HUMID": _M("1", "REL_HUMID", "relative_humidity",
                        "Relative humidity", "time: mean area: mean"),
    # band-resolved variables (variable_mapping.c:176-205)
    "OUT_SWE_BAND": _M("mm", "SWE_BAND", "lwe_thickness_of_surface_snow_amount",
                       "Snow water equivalent per band", "time: point area: mean",
                       AGG_END, dim="band"),
    "OUT_SNOW_DEPTH_BAND": _M("cm", "SNOW_DEPTH_BAND", "surface_snow_thickness",
                              "Snow depth per band", "time: point area: mean",
                              AGG_END, dim="band"),
    "OUT_SNOW_CANOPY_BAND": _M("mm", "SNOW_CANOPY_BAND", "",
                               "Canopy snow storage per band",
                               "time: point area: mean", AGG_END, dim="band"),
    "OUT_SNOW_COVER_BAND": _M("1", "SNOW_COVER_BAND",
                              "surface_snow_area_fraction",
                              "Snow area fraction per band",
                              "time: point area: sum", AGG_END, dim="band"),
    "OUT_ALBEDO_BAND": _M("1", "ALBEDO_BAND", "surface_albedo",
                          "Surface albedo per band", "time: point area: mean",
                          AGG_AVG, dim="band"),
    "OUT_LATENT_BAND": _M("W m-2", "LATENT_BAND",
                          "surface_upward_latent_heat_flux",
                          "Latent heat flux per band", "time: mean area: mean",
                          AGG_AVG, dim="band"),
    "OUT_SENSIBLE_BAND": _M("W m-2", "SENSIBLE_BAND",
                            "surface_upward_sensible_heat_flux",
                            "Sensible heat flux per band",
                            "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_NET_SHORT_BAND": _M("W m-2", "NET_SHORT_BAND",
                             "net_downward_shortwave_flux_in_air",
                             "Net shortwave per band", "time: mean area: mean",
                             AGG_AVG, dim="band"),
    "OUT_NET_LONG_BAND": _M("W m-2", "NET_LONG_BAND",
                            "net_downward_longwave_flux_in_air",
                            "Net longwave per band", "time: mean area: mean",
                            AGG_AVG, dim="band"),
    "OUT_SNOW_MELT_BAND": _M("mm", "SNOW_MELT_BAND",
                             "thickness_of_surface_snow_melt_amount",
                             "Snow melt per band", "time: mean area: mean",
                             AGG_SUM, dim="band"),
    "OUT_GLAC_MELT_BAND": _M("mm", "GLAC_MELT_BAND", "",
                             "Glacier ice melt per band",
                             "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_WAT_STOR_BAND": _M("mm", "GLAC_WAT_STOR_BAND", "",
                                 "Glacier water storage per band",
                                 "time: point area: mean", AGG_END,
                                 dim="band"),
    "OUT_AREA_BAND": _M("1", "AREA_BAND", "", "Band area fraction",
                        "time: point area: sum", AGG_END, dim="band"),
    "OUT_ELEV_BAND": _M("m", "ELEV_BAND", "", "Band elevation",
                        "time: point area: median", AGG_END, dim="band"),
    # lake variables (variable_mapping.c:62-67)
    "OUT_LAKE_DEPTH": _M("m", "LAKE_DEPTH", "", "Lake depth",
                         "time: point area: point", AGG_END),
    # vic-tpu extensions: per-step lake closure telemetry (the reference
    # folds the lake into calc_water_balance_error)
    "OUT_LAKE_WATER_ERROR": _M("mm", "LAKE_WATER_ERROR", "",
                               "Lake water budget residual over lake area",
                               "time: mean area: mean", AGG_SUM),
    "OUT_LAKE_ENERGY_ERROR": _M("W m-2", "LAKE_ENERGY_ERROR", "",
                                "Lake energy budget residual",
                                "time: mean area: mean", AGG_AVG),
    "OUT_LAKE_VOLUME": _M("m3", "LAKE_VOLUME", "", "Lake volume",
                          "time: point area: sum", AGG_END),
    "OUT_LAKE_SURF_AREA": _M("m2", "LAKE_SURF_AREA", "", "Lake surface area",
                             "time: point area: sum", AGG_END),
    "OUT_LAKE_ICE_FRACT": _M("1", "LAKE_ICE_FRACT", "",
                             "Fractional coverage of lake ice",
                             "time: point area: sum", AGG_END),
    "OUT_LAKE_ICE_HEIGHT": _M("cm", "LAKE_ICE_HEIGHT", "",
                              "Thickness of lake ice",
                              "time: point area: mean", AGG_END),
    "OUT_LAKE_SURF_TEMP": _M("degree_Celsius", "LAKE_SURF_TEMP", "",
                             "Lake surface temperature",
                             "time: point area: mean"),
    "OUT_LAKE_RCHRG": _M("mm", "LAKE_RCHRG", "",
                         "Recharge from lake to surrounding wetland",
                         "time: mean area: mean", AGG_SUM),
    "OUT_LAKE_EVAP": _M("mm", "LAKE_EVAP", "", "Net evaporation from lake",
                        "time: mean area: mean", AGG_SUM),
    # extra fluxes
    "OUT_SUB_BLOWING": _M("mm", "SUB_BLOWING", "",
                          "Net sublimation of blowing snow",
                          "time: mean area: mean", AGG_SUM),
    "OUT_SUB_CANOP": _M("mm", "SUB_CANOP", "",
                        "Net sublimation from snow stored in canopy",
                        "time: mean area: mean", AGG_SUM),
    "OUT_TFOL_FBFLAG": _M("", "TFOL_FBFLAG", "",
                          "Foliage temperature fallback count",
                          "time: point area: mean", AGG_SUM),
    "OUT_VEGT": _M("degree_Celsius", "VEGT", "canopy_temperature",
                   "Average vegetation canopy temperature",
                   "time: point area: mean"),
    # CLOSE_ENERGY canopy-air balance (calc_atmos_energy_bal.c;
    # vicNl_def.h:451 OUT_TCAN_FBFLAG)
    "OUT_TCANOPY": _M("degree_Celsius", "TCANOPY", "",
                      "Canopy air temperature",
                      "time: point area: mean"),
    "OUT_TCAN_FBFLAG": _M("", "TCAN_FBFLAG", "",
                          "Tcanopy fallback count",
                          "time: point area: mean", AGG_SUM),
    # water table (compute_zwt.c; names per variable_mapping.c)
    "OUT_ZWT": _M("cm", "ZWT", "", "Water table position (method 1)",
                  "time: point area: mean", AGG_END),
    "OUT_ZWT2": _M("cm", "ZWT2", "", "Water table position (method 2, top N-1 lumped)",
                   "time: point area: mean", AGG_END),
    "OUT_ZWT3": _M("cm", "ZWT3", "", "Water table position (method 3, all layers lumped)",
                   "time: point area: mean", AGG_END),
    "OUT_ZWTL": _M("cm", "ZWTL", "", "Water table position per soil layer",
                   "time: point area: mean", AGG_END, dim="layer"),
    # PCIC glacier variables (vicNl_def.h:525-547)
    "OUT_GLAC_WAT_STOR": _M("mm", "GLAC_WAT_STOR", "", "Glacier water storage",
                            "time: point area: mean", AGG_END),
    "OUT_GLAC_AREA": _M("1", "GLAC_AREA", "", "Glacier surface area fraction",
                        "time: point area: sum", AGG_END),
    "OUT_GLAC_MELT": _M("mm", "GLAC_MELT", "", "Glacier ice melt",
                        "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_SUB": _M("mm", "GLAC_SUB", "", "Net sublimation of glacier ice",
                       "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_INFLOW": _M("mm", "GLAC_INFLOW", "", "Glacier water inflow",
                          "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_OUTFLOW": _M("mm", "GLAC_OUTFLOW", "", "Glacier water outflow",
                           "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_SURF_TEMP": _M("degree_Celsius", "GLAC_SURF_TEMP", "",
                             "Glacier surface temperature",
                             "time: point area: mean"),
    "OUT_GLAC_MBAL": _M("mm", "GLAC_MBAL", "", "Glacier mass balance",
                        "time: point area: mean", AGG_END),
    "OUT_GLAC_OUTFLOW_COEF": _M("1", "GLAC_OUTFLOW_COEF", "",
                                "Glacier outflow coefficient",
                                "time: point area: mean", AGG_END),
    "OUT_GLAC_ACCUM": _M("mm", "GLAC_ACCUM", "",
                         "Glacier ice accumulation from firn-to-ice conversion",
                         "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_IMBAL": _M("mm", "GLAC_IMBAL", "", "Glacier ice mass balance",
                         "time: mean area: mean", AGG_SUM),
    "OUT_GLAC_DELTACC": _M("W m-2", "GLAC_DELTACC", "",
                           "Rate of change of glacier surface cold content",
                           "time: mean area: mean", AGG_AVG),
    "OUT_GLAC_FLUX": _M("W m-2", "GLAC_FLUX", "",
                        "Energy flux through glacier surface layer",
                        "time: mean area: mean", AGG_AVG),
    "OUT_GLAC_MELT_ENERGY": _M("W m-2", "GLAC_MELT_ENERGY", "",
                               "Energy used to thaw glacier ice",
                               "time: mean area: mean", AGG_AVG),
    "OUT_GLAC_TSURF_FBFLAG": _M("1", "GLAC_TSURF_FBFLAG", "",
                                "Glacier surface temperature fallback flag",
                                "time: sum area: mean", AGG_SUM),
    # extended met / soil diagnostics (vicNl_def.h:351-564)
    "OUT_QAIR": _M("kg kg-1", "QAIR", "specific_humidity",
                   "Specific humidity", "time: mean area: mean", AGG_AVG),
    "OUT_TSKC": _M("1", "TSKC", "cloud_area_fraction", "Cloud cover fraction",
                   "time: mean area: mean", AGG_AVG),
    "OUT_SOIL_LIQ_TOT": _M("mm", "SOIL_LIQ_TOT", "",
                           "Total column liquid soil moisture",
                           "time: point area: mean", AGG_END),
    "OUT_SOIL_ICE_TOT": _M("mm", "SOIL_ICE_TOT", "",
                           "Total column frozen soil moisture",
                           "time: point area: mean", AGG_END),
    "OUT_SMLIQFRAC": _M("1", "SMLIQFRAC", "",
                        "Liquid fraction of soil moisture per layer",
                        "time: point area: mean", AGG_END, dim="layer"),
    "OUT_SMFROZFRAC": _M("1", "SMFROZFRAC", "",
                         "Frozen fraction of soil moisture per layer",
                         "time: point area: mean", AGG_END, dim="layer"),
    "OUT_POROSITY": _M("1", "POROSITY", "soil_porosity",
                       "Effective soil porosity per layer",
                       "time: point area: mean", AGG_END, dim="layer"),
    "OUT_SOIL_DEPTH": _M("m", "SOIL_DEPTH", "", "Soil layer thickness",
                         "time: point area: mean", AGG_END, dim="layer"),
    "OUT_DELSOILMOIST": _M("mm", "DELSOILMOIST", "",
                           "Change in soil moisture",
                           "time: sum area: mean", AGG_SUM),
    "OUT_DELSWE": _M("mm", "DELSWE", "",
                     "Change in snow water equivalent",
                     "time: sum area: mean", AGG_SUM),
    "OUT_DELINTERCEPT": _M("mm", "DELINTERCEPT", "",
                           "Change in canopy interception storage",
                           "time: sum area: mean", AGG_SUM),
    "OUT_SURFSTOR": _M("mm", "SURFSTOR", "",
                       "Surface liquid water storage (lake)",
                       "time: point area: mean", AGG_END),
    "OUT_DELSURFSTOR": _M("mm", "DELSURFSTOR", "",
                          "Change in surface liquid water storage",
                          "time: sum area: mean", AGG_SUM),
    "OUT_REFREEZE": _M("mm", "REFREEZE", "",
                       "Refreezing of water in the snowpack",
                       "time: sum area: mean", AGG_SUM),
    "OUT_SUB_SURFACE": _M("mm", "SUB_SURFACE", "",
                          "Net sublimation from snow pack surface",
                          "time: sum area: mean", AGG_SUM),
    "OUT_ADV_SENS": _M("W m-2", "ADV_SENS", "",
                       "Net sensible flux advected to snow pack",
                       "time: mean area: mean", AGG_AVG),
    "OUT_AERO_COND": _M("m s-1", "AERO_COND", "",
                        "Scene aerodynamic conductance",
                        "time: mean area: mean", AGG_AVG),
    "OUT_AERO_COND1": _M("m s-1", "AERO_COND1", "",
                         "Surface aerodynamic conductance",
                         "time: mean area: mean", AGG_AVG),
    "OUT_AERO_COND2": _M("m s-1", "AERO_COND2", "",
                         "Overstory aerodynamic conductance",
                         "time: mean area: mean", AGG_AVG),
    "OUT_AERO_RESIST1": _M("s m-1", "AERO_RESIST1", "",
                           "Surface aerodynamic resistance",
                           "time: mean area: mean", AGG_AVG),
    "OUT_AERO_RESIST2": _M("s m-1", "AERO_RESIST2", "",
                           "Overstory aerodynamic resistance",
                           "time: mean area: mean", AGG_AVG),
    "OUT_SOILT_FBFLAG": _M("1", "SOILT_FBFLAG", "",
                           "Soil node temperature fallback flag",
                           "time: sum area: mean", AGG_SUM, dim="node"),
    "OUT_FDEPTH": _M("cm", "FDEPTH", "", "Freezing front depth",
                     "time: point area: mean", AGG_END, dim="front"),
    "OUT_TDEPTH": _M("cm", "TDEPTH", "", "Thawing front depth",
                     "time: point area: mean", AGG_END, dim="front"),
    "OUT_SUBSIDENCE": _M("mm", "SUBSIDENCE", "",
                         "Excess-ice subsidence (absent upstream: always 0)",
                         "time: sum area: mean", AGG_SUM),
    "OUT_SURF_FROST_FRAC": _M("1", "SURF_FROST_FRAC", "",
                              "Fraction of surface area with frozen soil",
                              "time: mean area: mean", AGG_AVG),
    # band-resolved energy / glacier set
    "OUT_ADVECTION_BAND": _M("W m-2", "ADVECTION_BAND", "",
                             "Advected energy to snow pack",
                             "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_ADV_SENS_BAND": _M("W m-2", "ADV_SENS_BAND", "",
                            "Advected sensible heat to snow pack",
                            "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_DELTACC_BAND": _M("W m-2", "DELTACC_BAND", "",
                           "Rate of change of snow cold content",
                           "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_GRND_FLUX_BAND": _M("W m-2", "GRND_FLUX_BAND", "",
                             "Ground heat flux", "time: mean area: mean",
                             AGG_AVG, dim="band"),
    "OUT_IN_LONG_BAND": _M("W m-2", "IN_LONG_BAND", "",
                           "Incoming longwave at surface",
                           "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_LATENT_SUB_BAND": _M("W m-2", "LATENT_SUB_BAND", "",
                              "Latent heat of sublimation",
                              "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_MELT_ENERGY_BAND": _M("W m-2", "MELT_ENERGY_BAND", "",
                               "Energy of snow melt/thaw",
                               "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_RFRZ_ENERGY_BAND": _M("W m-2", "RFRZ_ENERGY_BAND", "",
                               "Net refreeze energy in snowpack",
                               "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_SNOW_FLUX_BAND": _M("W m-2", "SNOW_FLUX_BAND", "",
                             "Energy flux through snow pack",
                             "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_SNOW_PACKT_BAND": _M("degree_Celsius", "SNOW_PACKT_BAND", "",
                              "Snow pack temperature",
                              "time: point area: mean", AGG_AVG, dim="band"),
    "OUT_SNOW_SURFT_BAND": _M("degree_Celsius", "SNOW_SURFT_BAND", "",
                              "Snow surface temperature",
                              "time: point area: mean", AGG_AVG, dim="band"),
    "OUT_GLAC_ACCUM_BAND": _M("mm", "GLAC_ACCUM_BAND", "",
                              "Glacier firn-to-ice accumulation",
                              "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_AREA_BAND": _M("1", "GLAC_AREA_BAND", "",
                             "Glacier surface area fraction",
                             "time: point area: sum", AGG_END, dim="band"),
    "OUT_GLAC_IMBAL_BAND": _M("mm", "GLAC_IMBAL_BAND", "",
                              "Glacier ice mass balance",
                              "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_INFLOW_BAND": _M("mm", "GLAC_INFLOW_BAND", "",
                               "Glacier water inflow",
                               "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_MBAL_BAND": _M("mm", "GLAC_MBAL_BAND", "",
                             "Glacier mass balance",
                             "time: point area: mean", AGG_END, dim="band"),
    "OUT_GLAC_OUTFLOW_BAND": _M("mm", "GLAC_OUTFLOW_BAND", "",
                                "Glacier water outflow",
                                "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_SUB_BAND": _M("mm", "GLAC_SUB_BAND", "",
                            "Net sublimation of glacier ice",
                            "time: mean area: mean", AGG_SUM, dim="band"),
    "OUT_GLAC_DELTACC_BAND": _M("W m-2", "GLAC_DELTACC_BAND", "",
                                "Rate of change of glacier cold content",
                                "time: mean area: mean", AGG_AVG, dim="band"),
    "OUT_GLAC_FLUX_BAND": _M("W m-2", "GLAC_FLUX_BAND", "",
                             "Energy flux through glacier surface layer",
                             "time: mean area: mean", AGG_AVG, dim="band"),
    # extended lake diagnostics (put_data.c lake section)
    "OUT_LAKE_AREA_FRAC": _M("1", "LAKE_AREA_FRAC", "",
                             "Lake area as fraction of grid cell",
                             "time: point area: mean", AGG_END),
    "OUT_LAKE_ICE": _M("mm", "LAKE_ICE", "", "Moisture stored as lake ice",
                       "time: point area: mean", AGG_END),
    "OUT_LAKE_ICE_TEMP": _M("degree_Celsius", "LAKE_ICE_TEMP", "",
                            "Lake ice temperature",
                            "time: point area: mean", AGG_END),
    "OUT_LAKE_SWE": _M("m", "LAKE_SWE", "", "SWE on lake ice (per ice area)",
                       "time: point area: mean", AGG_END),
    "OUT_LAKE_SWE_V": _M("m3", "LAKE_SWE_V", "", "Volumetric SWE on lake ice",
                         "time: point area: mean", AGG_END),
    "OUT_LAKE_DSWE": _M("mm", "LAKE_DSWE", "",
                        "Change in SWE on lake ice over grid cell",
                        "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_DSWE_V": _M("m3", "LAKE_DSWE_V", "",
                          "Volumetric change in SWE on lake ice",
                          "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_DSTOR": _M("mm", "LAKE_DSTOR", "",
                         "Change in lake storage over grid cell",
                         "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_DSTOR_V": _M("m3", "LAKE_DSTOR_V", "",
                           "Volumetric change in lake storage",
                           "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_MOIST": _M("mm", "LAKE_MOIST", "",
                         "Liquid water stored in lake over grid cell",
                         "time: point area: mean", AGG_END),
    "OUT_LAKE_BF_IN": _M("mm", "LAKE_BF_IN", "", "Baseflow into lake",
                         "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_BF_IN_V": _M("m3", "LAKE_BF_IN_V", "",
                           "Volumetric baseflow into lake",
                           "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_BF_OUT": _M("mm", "LAKE_BF_OUT", "", "Baseflow out of lake",
                          "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_BF_OUT_V": _M("m3", "LAKE_BF_OUT_V", "",
                            "Volumetric baseflow out of lake",
                            "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_CHAN_IN": _M("mm", "LAKE_CHAN_IN", "",
                           "Channel inflow into lake (no routing: 0)",
                           "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_CHAN_IN_V": _M("m3", "LAKE_CHAN_IN_V", "",
                             "Volumetric channel inflow into lake",
                             "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_CHAN_OUT": _M("mm", "LAKE_CHAN_OUT", "",
                            "Channel outflow from lake",
                            "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_CHAN_OUT_V": _M("m3", "LAKE_CHAN_OUT_V", "",
                              "Volumetric channel outflow from lake",
                              "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_EVAP_V": _M("m3", "LAKE_EVAP_V", "",
                          "Volumetric net lake evaporation",
                          "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_PREC_V": _M("m3", "LAKE_PREC_V", "",
                          "Volumetric precipitation onto lake",
                          "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_RCHRG_V": _M("m3", "LAKE_RCHRG_V", "",
                           "Volumetric lake-to-wetland recharge",
                           "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_RO_IN": _M("mm", "LAKE_RO_IN", "", "Runoff into lake",
                         "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_RO_IN_V": _M("m3", "LAKE_RO_IN_V", "",
                           "Volumetric runoff into lake",
                           "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_VAPFLX": _M("mm", "LAKE_VAPFLX", "",
                          "Sublimation from lake snow (folded into evap: 0)",
                          "time: sum area: mean", AGG_SUM),
    "OUT_LAKE_VAPFLX_V": _M("m3", "LAKE_VAPFLX_V", "",
                            "Volumetric sublimation from lake snow",
                            "time: sum area: mean", AGG_SUM),
    "OUT_SOIL_TNODE_WL": _M("degree_Celsius", "SOIL_TNODE_WL", "",
                            "Soil node temperature under wetland",
                            "time: point area: mean", AGG_AVG, dim="node"),
    "OUT_ZSUM_NODE": _M("m", "ZSUM_NODE", "", "Thermal node depth",
                        "time: point area: mean", AGG_END, dim="node"),
    "OUT_SURF_COND": _M("m s-1", "SURF_COND", "",
                        "Surface conductance (never filled upstream: 0)",
                        "time: mean area: mean", AGG_AVG),
    # cost telemetry: CLOSE_ENERGY fixed-point trip count (max lane)
    "OUT_TCANOPY_ITER": _M("1", "TCANOPY_ITER", "",
                           "CLOSE_ENERGY canopy iteration count",
                           "time: mean area: mean", AGG_AVG),
    # derived members of the default fluxes file (put_data.c:959-1013)
    "OUT_R_NET": _M("W m-2", "R_NET", "surface_net_radiation",
                    "Net downward radiation flux",
                    "time: mean area: mean", AGG_AVG),
    "OUT_IN_LONG": _M("W m-2", "IN_LONG", "downwelling_longwave_flux_in_air",
                      "Incoming longwave at ground surface (under veg)",
                      "time: mean area: mean", AGG_AVG),
    "OUT_AERO_RESIST": _M("s m-1", "AERO_RESIST", "",
                          "Scene aerodynamic resistance",
                          "time: mean area: mean", AGG_AVG),
}

def aggregate_outputs(outs: Dict[str, np.ndarray], steps_per_out: int,
                      alma: bool = False, out_dt_sec: float = 86400.0
                      ) -> Dict[str, np.ndarray]:
    """Temporal aggregation of stacked per-record outputs [n_rec, ...] into
    output intervals (put_data.c:665-710). SUM accumulates, AVG means, END
    takes the interval's last record. With ALMA_OUTPUT, accumulated water
    fluxes (mm) are converted to mean rates (mm/s) by dividing by the output
    interval (put_data.c:689-710)."""
    if steps_per_out <= 1:
        out = dict(outs)
        if alma:
            for name, arr in out.items():
                meta = OUTVAR_META.get(name)
                if meta and meta.agg == AGG_SUM and meta.units == "mm":
                    out[name] = np.asarray(arr) / out_dt_sec
        return out
    out = {}
    for name, arr in outs.items():
        arr = np.asarray(arr)
        n_rec = arr.shape[0]
        n_out = n_rec // steps_per_out
        trimmed = arr[:n_out * steps_per_out]
        grouped = trimmed.reshape((n_out, steps_per_out) + arr.shape[1:])
        meta = OUTVAR_META.get(name)
        agg = meta.agg if meta else AGG_AVG
        if agg == AGG_SUM:
            out[name] = grouped.sum(axis=1)
            if alma and meta and meta.units == "mm":
                out[name] = out[name] / out_dt_sec
        elif agg == AGG_END:
            out[name] = grouped[:, -1]
        else:
            out[name] = grouped.mean(axis=1)
    # scene resistance is re-derived from the AGGREGATED conductance
    # (put_data.c:681), not averaged
    if "OUT_AERO_RESIST" in out and "OUT_AERO_COND" in out:
        out["OUT_AERO_RESIST"] = 1.0 / np.maximum(out["OUT_AERO_COND"],
                                                  1e-30)
    return out


class NetCDFOutputWriter:
    """Time-major all-cells NetCDF-4 output (WriteOutputNetCDF.c:163-445).

    One file for the whole domain: dims (time, [layer|node,] lat, lon). Cells
    are scattered onto the lat/lon grid; missing cells filled with 1e20.
    """
    FILL = 1.0e20

    def __init__(self, path: str, lats: np.ndarray, lons: np.ndarray,
                 var_names, nlayer: int = 3, nnode: int = 3, nband: int = 1,
                 global_attrs: Optional[dict] = None, compress: int = 0,
                 time_units: str = "days since 1900-01-01"):
        from .io.native import NetCDFFile
        self.lat_axis = np.unique(np.round(lats, 6))
        self.lon_axis = np.unique(np.round(lons, 6))
        self.lat_idx = np.searchsorted(self.lat_axis, np.round(lats, 6))
        self.lon_idx = np.searchsorted(self.lon_axis, np.round(lons, 6))
        self.var_names = [v for v in var_names if v in OUTVAR_META]
        self.nlayer, self.nnode = nlayer, nnode
        self.t = 0

        f = NetCDFFile(path, "w")
        f.def_dim("time", None)
        f.def_dim("depth", nlayer)
        f.def_dim("node", nnode)
        f.def_dim("band", max(nband, 1))
        f.def_dim("front", 3)   # MAX_FRONTS (user_def.h:112)
        f.def_dim("lat", len(self.lat_axis))
        f.def_dim("lon", len(self.lon_axis))
        f.def_var("time", np.float64, ("time",),
                  attrs={"units": time_units, "calendar": "standard"})
        f.def_var("lat", np.float64, ("lat",),
                  attrs={"units": "degrees_north", "standard_name": "latitude"})
        f.def_var("lon", np.float64, ("lon",),
                  attrs={"units": "degrees_east", "standard_name": "longitude"})
        for name in self.var_names:
            m = OUTVAR_META[name]
            dims = ("time",) + (("depth",) if m.dim == "layer" else
                                ("node",) if m.dim == "node" else
                                ("band",) if m.dim == "band" else
                                ("front",) if m.dim == "front" else ()) \
                + ("lat", "lon")
            attrs = {"units": m.units, "long_name": m.long_name,
                     "cell_methods": m.cell_methods, "_FillValue_doc": self.FILL}
            if m.standard_name:
                attrs["standard_name"] = m.standard_name
            f.def_var(m.nc_name, np.float32, dims, deflate=compress,
                      attrs=attrs)
        if global_attrs:
            for k, v in global_attrs.items():
                f.put_att(k, v)
        f.put_att("Conventions", "CF-1.6")
        f.put_att("model", "vic-tpu")   # as vic_tpu writes it
        f.enddef()
        f.put("lat", self.lat_axis)
        f.put("lon", self.lon_axis)
        self.f = f

    def _scatter(self, cellvals: np.ndarray) -> np.ndarray:
        """[n_cell(, k)] -> [(k,) nlat, nlon] grid with fill."""
        if cellvals.ndim == 1:
            grid = np.full((len(self.lat_axis), len(self.lon_axis)), self.FILL,
                           np.float32)
            grid[self.lat_idx, self.lon_idx] = cellvals
        else:
            k = cellvals.shape[1]
            grid = np.full((k, len(self.lat_axis), len(self.lon_axis)),
                           self.FILL, np.float32)
            grid[:, self.lat_idx, self.lon_idx] = cellvals.T
        return grid

    def write_step(self, outs: Dict[str, np.ndarray], time_value: float):
        """Write one output record for all cells (write_data_all_cells)."""
        self.f.put("time", np.array([time_value]), start=(self.t,))
        for name in self.var_names:
            m = OUTVAR_META[name]
            grid = self._scatter(np.asarray(outs[name], np.float32))
            self.f.put(m.nc_name, grid[None], start=(self.t,) + (0,) * grid.ndim)
        self.t += 1

    def write_all(self, outs: Dict[str, np.ndarray], time_values: np.ndarray):
        for i, tv in enumerate(time_values):
            step = {k: np.asarray(v)[i] for k, v in outs.items()
                    if k in self.var_names or k in OUTVAR_META}
            self.write_step(step, float(tv))

    def close(self):
        self.f.close()


# OUT_TYPE_* enum (vicNl_def.h:580-586) -> (code, little-endian numpy dtype)
OUT_TYPES = {
    "OUT_TYPE_DEFAULT": (0, "<f4"),
    "OUT_TYPE_CHAR": (1, "<i1"),
    "OUT_TYPE_SINT": (2, "<i2"),
    "OUT_TYPE_USINT": (3, "<u2"),
    "OUT_TYPE_INT": (4, "<i4"),
    "OUT_TYPE_FLOAT": (5, "<f4"),
    "OUT_TYPE_DOUBLE": (6, "<f8"),
}


class BinaryOutputWriter:
    """Per-cell packed binary flux files, byte-faithful to the reference
    (WriteOutputBinary.c:99-293):

    header = 4x 0xFFFF (u16) | Nbytes (u16) |
             part1: Nbytes1 (u16), nrecs (i4), out_dt (i4),
                    year/month/day/hour (4x i4), ALMA_OUTPUT (i1),
                    Nvars (i1 — date fields INCLUDED) |
             part2: Nbytes2 (u16), then per field {len (i1), name, type (i1),
                    mult (f4)} for YEAR/MONTH/DAY[/HOUR] and each data
                    variable element.
    data   = per record: date as 3 (daily) or 4 (sub-daily) i4, then each
             variable element cast to its OUT_TYPE_* dtype.

    Reference quirks replicated for byte-compatibility:
    - Nbytes/Nbytes2 count ONLY the date-field entries: the size loop over
      data variables is commented out upstream ("as part of making Binary
      output mode go away", WriteOutputBinary.c:181-190) while the write
      loop still emits the entries, so the recorded header size undershoots
      the real one.
    - The per-variable header name is the STALE tmp_str from the last date
      field ("HOUR" sub-daily / "DAY" daily): the sprintf that would set it
      is commented out (WriteOutputBinary.c:281-284).
    - Data values are written UNMULTIPLIED: the mult is applied only in
      prepareDataForWriting(), which only write_header() calls — per-record
      write_data() casts raw aggdata (the classic 4.1.2 value*mult packing
      does not survive in this fork).
    Per-variable type/mult come from OUTVAR specs (parse_output_info.c
    grammar); defaults are OUT_TYPE_FLOAT / 1 (set_output_defaults.c).
    """

    def __init__(self, result_dir: str, prefix: str, lats, lons, var_names,
                 grid_decimal: int = 4, nrecs: int = 0, out_dt: int = 24,
                 start_date=(0, 1, 1, 0), alma_output: bool = False,
                 outvar_specs: dict = None):
        import os
        self.paths = []
        self.var_names = [v for v in var_names if v in OUTVAR_META]
        self.nrecs = nrecs
        self.out_dt = out_dt
        self.start_date = start_date
        self.alma = alma_output
        self.specs = outvar_specs or {}
        fmt = f"%.{grid_decimal}f"
        os.makedirs(result_dir, exist_ok=True)
        for la, lo in zip(lats, lons):
            self.paths.append(os.path.join(
                result_dir, f"{prefix}_{fmt % la}_{fmt % lo}"))

    def _var_type_mult(self, name):
        spec = self.specs.get(name)
        tname = getattr(spec, "type", "*") if spec is not None else "*"
        if tname not in OUT_TYPES or tname == "OUT_TYPE_DEFAULT":
            tname = "OUT_TYPE_FLOAT"
        mult = getattr(spec, "multiplier", 1.0) if spec is not None else 1.0
        # set_output_var: mult == 0 keeps the default 1
        return tname, (mult if mult else 1.0)

    def _header(self, nelem):
        import struct
        subdaily = self.out_dt < 24
        date_fields = [("YEAR",), ("MONTH",), ("DAY",)] + \
            ([("HOUR",)] if subdaily else [])
        nbytes1 = 2 + 4 + 4 + 4 * 4 + 1 + 1
        nbytes2 = 2 + sum(1 + len(n[0]) + 1 + 4 for n in date_fields)
        nbytes = 4 * 2 + 2 + nbytes1 + nbytes2       # quirk: data vars absent
        # Nvars counts VARIABLES + date fields even though the entry list
        # below is per ELEMENT (WriteOutputBinary.c:224-231 vs :279-292)
        nvars = len(self.var_names) + len(date_fields)
        y, m, d, h = self.start_date
        out = struct.pack("<4H", 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF)
        out += struct.pack("<HH", nbytes, nbytes1)
        out += struct.pack("<ii4ibB", self.nrecs, self.out_dt, y, m, d, h,
                           1 if self.alma else 0, nvars & 0xFF)
        out += struct.pack("<H", nbytes2)
        for (nm,) in date_fields:
            out += struct.pack("<b", len(nm)) + nm.encode()
            out += struct.pack("<bf", OUT_TYPES["OUT_TYPE_INT"][0], 1.0)
        stale = date_fields[-1][0]                   # "HOUR" or "DAY" quirk
        for name in self.var_names:
            tname, mult = self._var_type_mult(name)
            for _ in range(nelem[name]):
                out += struct.pack("<b", len(stale)) + stale.encode()
                out += struct.pack("<bf", OUT_TYPES[tname][0], float(mult))
        return out

    def write_all(self, outs, timeaxis):
        n_rec = len(timeaxis.year)
        subdaily = self.out_dt < 24
        date_cols = [np.asarray(timeaxis.year, np.int32),
                     np.asarray(timeaxis.month, np.int32),
                     np.asarray(timeaxis.day, np.int32)]
        if subdaily:
            date_cols.append(np.asarray(timeaxis.hour, np.int32))
        date_block = np.stack(date_cols, 1).astype("<i4")
        nelem = {}
        for name in self.var_names:
            v = np.asarray(outs[name])
            nelem[name] = 1 if v.ndim <= 2 else int(np.prod(v.shape[2:]))
        header = self._header(nelem)
        # one record = the date, then each variable's elements in its type
        rec = np.dtype([("date", "<i4", (len(date_cols),))] + [
            (f"v{i}", OUT_TYPES[self._var_type_mult(name)[0]][1],
             (nelem[name],)) for i, name in enumerate(self.var_names)])
        values = [np.asarray(outs[name])[:n_rec] for name in self.var_names]
        for ci, path in enumerate(self.paths):
            table = np.empty(n_rec, rec)
            table["date"] = date_block
            for i, v in enumerate(values):
                vc = (v[:, ci] if v.ndim >= 2 else v).reshape(n_rec, -1)
                if rec[f"v{i}"].base.kind == "i":
                    vc = np.trunc(vc)                # C cast truncates
                table[f"v{i}"] = vc.astype(rec[f"v{i}"].base)
            with open(path, "wb") as fh:
                fh.write(header)
                fh.write(table.tobytes())

    def close(self):
        pass


def read_binary_output(path):
    """Parse a reference-format packed binary flux file
    (WriteOutputBinary.c header spec above). Returns (meta, date[n,3|4],
    columns[list of np arrays]) — used by tests to round-trip both our own
    files and C-binary samples."""
    import struct
    raw = open(path, "rb").read()
    assert raw[:8] == b"\xff\xff" * 4, "bad identifier"
    nbytes, nbytes1 = struct.unpack_from("<HH", raw, 8)
    nrecs, out_dt, y, m, d, h, alma, nvars = struct.unpack_from(
        "<ii4ibB", raw, 12)
    off = 12 + (nbytes1 - 2)
    (nbytes2,) = struct.unpack_from("<H", raw, off)
    off += 2

    def read_field(off):
        (ln,) = struct.unpack_from("<b", raw, off)
        off += 1
        nm = raw[off:off + ln].decode()
        off += ln
        ty, mult = struct.unpack_from("<bf", raw, off)
        off += 5
        return (nm, ty, mult), off

    dtypes = {0: "<f4", 1: "<i1", 2: "<i2", 3: "<u2", 4: "<i4", 5: "<f4",
              6: "<f8"}
    # date fields: fixed count from out_dt (the header's Nvars counts
    # VARIABLES + date fields while the entry list is per ELEMENT — another
    # byte of the orphaned upstream writer that can't be trusted)
    n_date = 4 if out_dt < 24 else 3
    fields = []
    for _ in range(n_date):
        f, off = read_field(off)
        fields.append(f)
    # data-variable element entries: the header sizes (Nbytes/Nbytes2)
    # exclude them (WriteOutputBinary.c:181-190 commented out), so parse
    # until the remaining bytes are exactly nrecs whole data records
    data_fields = []
    rec_bytes = n_date * 4
    while nrecs == 0 or len(raw) - off != nrecs * rec_bytes:
        f, off = read_field(off)
        data_fields.append(f)
        rec_bytes += np.dtype(dtypes[f[1]]).itemsize
        if nrecs == 0 and (len(raw) - off) % max(rec_bytes, 1) == 0:
            break
        if off >= len(raw):
            raise ValueError("unparseable packed binary header")
    fields += data_fields
    rec_fmt = [("date", "<i4", n_date)] + [
        (f"v{i}", dtypes[ty]) for i, (_, ty, _m) in enumerate(data_fields)]
    arr = np.frombuffer(raw[off:], dtype=np.dtype(rec_fmt))
    meta = dict(nrecs=nrecs, out_dt=out_dt, start=(y, m, d, h),
                alma=bool(alma), fields=fields, nbytes=nbytes,
                nbytes1=nbytes1, nbytes2=nbytes2)
    cols = [arr[f"v{i}"] for i in range(len(data_fields))]
    return meta, arr["date"], cols


class AsciiOutputWriter:
    """Legacy per-cell ASCII flux files (WriteOutputAscii.c): one
    ``<prefix>_<lat>_<lon>`` file per cell, date columns + variables.

    compress=True gzips each file (extension ``.gz``) — the analog of the
    reference's COMPRESS forking ``system("gzip")`` per closed flux file
    (compress_files.c:24), done in-process instead of via a subshell."""

    def __init__(self, result_dir: str, prefix: str, lats, lons, var_names,
                 grid_decimal: int = 4, compress: bool = False):
        import os
        self.compress = compress
        self.var_names = [v for v in var_names if v in OUTVAR_META]
        fmt = f"%.{grid_decimal}f"
        os.makedirs(result_dir, exist_ok=True)
        self.paths = [os.path.join(result_dir,
                                   f"{prefix}_{fmt % la}_{fmt % lo}")
                      + (".gz" if compress else "")
                      for la, lo in zip(lats, lons)]

    def write_all(self, outs, timeaxis):
        import gzip
        n_rec = len(timeaxis.year)
        dates = [f"{timeaxis.year[i]:04d} {timeaxis.month[i]:02d} "
                 f"{timeaxis.day[i]:02d} {timeaxis.hour[i]:02d}"
                 for i in range(n_rec)]
        values = [np.asarray(outs[name])[:n_rec] for name in self.var_names]
        for ci, path in enumerate(self.paths):
            cols = [(v[:, ci] if v.ndim >= 2 else v).reshape(n_rec, -1)
                    for v in values]
            table = (np.concatenate(cols, 1) if cols
                     else np.zeros((n_rec, 0)))
            row = " ".join(["%.6f"] * table.shape[1])
            lines = [d + (" " + row % tuple(r) if table.shape[1] else "")
                     for d, r in zip(dates, table.astype(np.float64)
                                     .tolist())]
            text = "\n".join(lines) + "\n"
            if self.compress:
                with gzip.open(path, "wt") as fh:
                    fh.write(text)
            else:
                with open(path, "w") as fh:
                    fh.write(text)

    def close(self):
        pass
