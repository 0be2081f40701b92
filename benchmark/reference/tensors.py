"""Dataclasses of tensors: device moves and numpy round trips."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def as_tensor(a, device) -> torch.Tensor:
    """numpy/array-like -> tensor with the port's dtypes: float32 for every
    floating array, bool for masks, int32 for integer fields."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        dtype = torch.float32
    elif a.dtype.kind == "b":
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = torch.int32
    else:
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return torch.tensor(a, dtype=dtype, device=device)


class TensorDataclass:
    """Mixin for dataclasses whose every field is a tensor."""

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, arrays: dict, device):
        """Build from a {field name: array} dict holding exactly the fields."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = set(names) - set(arrays)
        extra = set(arrays) - set(names)
        if missing or extra:
            raise KeyError(f"{cls.__name__}: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        return cls(**{n: as_tensor(arrays[n], device) for n in names})

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}
