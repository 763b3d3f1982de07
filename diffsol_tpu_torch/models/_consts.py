"""Array constants of a model's closures, as float64 (or boolean) tensors
on whatever device the state lives on.  The equations run on the CPU in
the tests and when they are traced for a kernel, and on the card in the
eager and lockstep solvers; each constant is copied to a device once."""

from __future__ import annotations

import numpy as np
import torch


class DeviceConsts:
    """``consts(like)["name"]`` is the constant ``name`` on ``like``'s
    device."""

    def __init__(self, **arrays):
        self._host = {
            k: torch.tensor(np.array(v)) for k, v in arrays.items()
        }
        self._on = {}

    def __call__(self, like: torch.Tensor) -> dict:
        dev = like.device
        if dev.type == "cpu":
            return self._host
        got = self._on.get(dev)
        if got is None:
            got = self._on[dev] = {k: v.to(dev) for k, v in self._host.items()}
        return got
