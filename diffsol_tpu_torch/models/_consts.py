"""Array constants of a model's closures, as float64 (or boolean) tensors,
float32 for a float32 problem, on whatever device the state lives on.  The equations run on the CPU in
the tests and when they are traced for a kernel, and on the card in the
eager and lockstep solvers; each constant is copied to a device once."""

from __future__ import annotations

import numpy as np
import torch


class DeviceConsts:
    """``consts(like)["name"]`` is the constant ``name`` on ``like``'s
    device, a float constant in float32 where ``like`` is float32."""

    def __init__(self, **arrays):
        self._host = {
            k: torch.tensor(np.array(v)) for k, v in arrays.items()
        }
        self._on = {}

    def __call__(self, like: torch.Tensor) -> dict:
        dev = like.device
        # a float32 problem gets its float constants in float32
        f32 = like.dtype == torch.float32
        if dev.type == "cpu" and not f32:
            return self._host
        got = self._on.get((dev, f32))
        if got is None:
            got = self._on[(dev, f32)] = {
                k: v.to(dev, torch.float32 if f32 and v.is_floating_point() else v.dtype)
                for k, v in self._host.items()}
        return got
