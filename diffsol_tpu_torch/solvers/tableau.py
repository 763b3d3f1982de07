"""Butcher tableaus (counterpart of ``diffsol_tpu.solvers.tableau``; this
package keeps its own copy, plain numpy, so that it imports nothing of the
JAX package).

Same built-in methods and coefficients as the reference
(reference crates/diffsol/src/ode_solver/tableau.rs): TR-BDF2 (order 2 SDIRK,
gamma = 2 - sqrt(2), with continuous-extension beta matrix), ESDIRK34
(order 3), and TSIT45 (Tsitouras 5(4) explicit pair with 4th-order dense
output).  Users can supply custom tableaus.

Coefficients are stored as nested tuples so a Tableau is hashable; the
steppers turn them into tensors once, on the device they run on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _t(x) -> tuple:
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim == 1:
        return tuple(arr.tolist())
    return tuple(tuple(row) for row in arr.tolist())


@dataclass(frozen=True)
class Tableau:
    """a: (s, s) stage matrix; b: weights; c: abscissae; d = b - b_hat
    (embedded-error weights); beta: optional (s, poly_order) dense-output
    polynomial matrix; order: order of the main method."""

    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    d: Tuple[float, ...]
    order: int
    beta: Optional[Tuple[Tuple[float, ...], ...]] = None

    @property
    def s(self) -> int:
        return len(self.c)

    @property
    def skip_first_stage(self) -> bool:
        """FSAL / explicit-first-stage: row 0 of `a` is zero and c[0] == 0
        (reference runge_kutta.rs:286-288)."""
        return all(v == 0.0 for v in self.a[0]) and self.c[0] == 0.0

    @property
    def is_sdirk(self) -> bool:
        gamma = self.a[-1][-1]
        return gamma != 0.0


def tr_bdf2() -> Tableau:
    """TR-BDF2 (Bank et al. 1985; Hosea & Shampine 1996), continuous
    extension from Jorgensen et al. 2018 (arXiv:1803.01613)."""
    gamma = 2.0 - math.sqrt(2.0)
    d = gamma / 2.0
    w = math.sqrt(2.0) / 4.0
    a = [[0.0, 0.0, 0.0], [d, d, 0.0], [w, w, d]]
    b = [w, w, d]
    b_hat = [(1.0 - w) / 3.0, (3.0 * w + 1.0) / 3.0, d / 3.0]
    dd = [bi - bhi for bi, bhi in zip(b, b_hat)]
    beta = [[2.0 * w, -w], [2.0 * w, -w], [gamma - 1.0, 2.0 * w]]
    c = [0.0, gamma, 1.0]
    return Tableau(a=_t(a), b=_t(b), c=_t(c), d=_t(dd), order=2, beta=_t(beta))


def esdirk34() -> Tableau:
    """Third-order ESDIRK from Jorgensen et al. 2018 (arXiv:1803.01613)."""
    gamma = 0.435866521508459
    a = [
        [0.0, 0.0, 0.0, 0.0],
        [gamma, gamma, 0.0, 0.0],
        [0.1407377747247062, -0.1083655513813208, gamma, 0.0],
        [0.102399400619911, -0.3768784522555561, 0.8386125301271861, gamma],
    ]
    b = list(a[3])
    c = [0.0, 0.871733043016918, 0.4682387448518444, 1.0]
    d = [
        -0.05462549724041394,
        -0.49420889362599496,
        0.22193449973506466,
        0.32689989113134427,
    ]
    return Tableau(a=_t(a), b=_t(b), c=_t(c), d=_t(d), order=3, beta=None)


def tsit45() -> Tableau:
    """Tsitouras 5(4) explicit pair with 4th-order continuous extension."""
    c = [0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0]
    b = [
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ]
    d = [
        -0.001780011052225777,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ]
    a = np.zeros((7, 7))
    a[2, 1] = 0.335480655492357
    a[3, 1] = -6.359448489975075
    a[4, 1] = -11.74888356406283
    a[5, 1] = -12.92096931784711
    a[3, 2] = 4.362295432869581
    a[4, 2] = 7.495539342889836
    a[5, 2] = 8.159367898576159
    a[4, 3] = -0.09249506636175525
    a[5, 3] = -0.071584973281401
    a[5, 4] = -0.02826905039406838
    for i in range(1, 7):
        a[i, 0] = c[i] - a[i, 1:i].sum()
    a[6, :6] = b[:6]
    beta = [
        [1.0, -2.76370619727483, 2.91325546182191, -1.05308849772902],
        [0.0, 0.1317, -0.2234, 0.1017],
        [0.0, 3.93029623689475, -5.9410338721315, 2.49062728565125],
        [0.0, -12.4110771669337, 30.3381886302823, -16.5481028892449],
        [0.0, 37.509313416511, -88.1789048947664, 47.3795219628193],
        [0.0, -27.8965262891973, 65.0918946747937, -34.8706578614966],
        [0.0, 1.5, -4.0, 2.5],
    ]
    return Tableau(a=_t(a), b=_t(b), c=_t(c), d=_t(d), order=4, beta=_t(beta))
