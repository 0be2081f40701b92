"""Distributed precipitation (DIST_PRCP): the wet/dry column transfers.

Counterpart of `vic_tpu/physics/dist_prcp.py`. With DIST_PRCP every HRU
carries a wet and a dry soil column and canopy store; rain falls on the
wet fraction mu only, at intensity P/mu (dist_prec.c:82,
surface_fluxes.c:420), and cell values are the mu-weighted average of the
two (put_data.c:282-330). When mu changes, water moves between the columns
so that the mu-weighted total is kept:

- at a storm's onset both columns take the old-weighted average
  (initialize_new_storm.c:101-125);
- mid-storm the growing side absorbs the shrinking side's share
  (redistribute_during_storm.c:140-167), clamped to the layer maximum.
"""
from __future__ import annotations

import torch

_SMALL = 1e-12


def average_for_storm(wet, dry, mu_old):
    """Storm-onset averaging: both columns take mu_old*wet +
    (1-mu_old)*dry."""
    avg = mu_old * wet + (1.0 - mu_old) * dry
    return avg, avg


def redistribute_for_storm(wet, dry, max_val, mu_old, mu_new):
    """Mid-storm redistribution. A shrinking wet fraction hands its share
    to the dry column, a growing one takes part of the dry column; mu_new at
    0 or 1 collapses both to the average. Both are clamped to max_val."""
    W = torch.where
    interior = ((1.0 - mu_new) > _SMALL) & (mu_new > _SMALL)
    shrink = (mu_old > mu_new) & interior
    grow = ~shrink & interior
    dry_shrunk = (((mu_old - mu_new) * wet + (1.0 - mu_old) * dry)
                  / torch.clamp(1.0 - mu_new, min=_SMALL))
    wet_grown = (((mu_new - mu_old) * dry + mu_old * wet)
                 / torch.clamp(mu_new, min=_SMALL))
    avg = (1.0 - mu_old) * dry + mu_old * wet
    new_wet = W(shrink, wet, W(grow, wet_grown, avg))
    new_dry = W(shrink, dry_shrunk, W(grow, dry, avg))
    return torch.minimum(new_wet, max_val), torch.minimum(new_dry, max_val)


def storm_transfer(wet, dry, max_val, mu_old, mu_new, avg_mask, redist_mask):
    """Both transfers under their masks (mu_old, mu_new and the masks
    broadcast to wet/dry). Returns the new (wet, dry)."""
    W = torch.where
    a_wet, a_dry = average_for_storm(wet, dry, mu_old)
    r_wet, r_dry = redistribute_for_storm(wet, dry, max_val, mu_old, mu_new)
    return (W(avg_mask, a_wet, W(redist_mask, r_wet, wet)),
            W(avg_mask, a_dry, W(redist_mask, r_dry, dry)))
