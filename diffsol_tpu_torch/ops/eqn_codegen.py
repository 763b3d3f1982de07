"""User equations -> CUDA device functions (the role ``ops/dfinterp.py``
plays for the Pallas kernels).

The fused kernel evaluates the user's per-member ``rhs(t, y, p)`` and
``init(t, p)`` inside CUDA, but users write plain torch.  So each callable
is traced ONCE on float64 tensors with ``make_fx`` into an aten graph and
lowered into a tiny scalar IR: with n <= 8 states every array unrolls into
scalar operations.  Python float literals and tensor constants are lifted
at float64, exactly as written.

From the IR this module emits CUDA C++ device functions templated on the
scalar type, so one body serves ``double`` (values) and ``Dual<double>``
(forward-mode tangents with the rules of ``DualAlgebra``,
dfinterp.py:344); n seeded evaluations give the Jacobian's columns.  The
same IR has a plain torch evaluator (value and dual), so the CPU tests
check the IR against the callable and against ``torch.func.jacfwd``.

Scope: + - * /, neg, pow by an integer, exp, log, sqrt, sin, cos, tanh,
indexing, slicing, stack/cat and shape plumbing.  Anything else, and any
data-dependent Python control flow, raises :class:`UnsupportedForKernel`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

F64 = torch.float64
_UNARY = ("neg", "exp", "log", "sqrt", "sin", "cos", "tanh")
_BINARY = ("add", "sub", "mul", "div")


class UnsupportedForKernel(Exception):
    """The problem or its equations are outside the fused kernel's scope;
    callers fall back to the lockstep path."""


@dataclass(frozen=True)
class ScalarIR:
    """Straight-line scalar program.  ``nodes[k]`` is ``(op, *args)``:
    ``("t",)``, ``("y", i)``, ``("p", i)``, ``("c", value)``, a unary op
    ``(name, a)``, a binary op ``(name, a, b)`` or ``("powi", a, k)`` with
    ``k >= 1``; ``a``/``b`` index earlier nodes.  ``outputs`` index the
    nodes of the result vector."""

    nodes: tuple
    outputs: tuple


@dataclass(frozen=True)
class ModelIR:
    rhs: ScalarIR
    init: Optional[ScalarIR]  # None: the kernel gets y0 from the host
    nstates: int
    nparams: int


class _Builder:
    def __init__(self):
        self.nodes = []
        self.index = {}  # common-subexpression table

    def add(self, node) -> int:
        key = node if node[0] != "c" else ("c", float(node[1]).hex())
        k = self.index.get(key)
        if k is None:
            k = len(self.nodes)
            self.nodes.append(node)
            self.index[key] = k
        return k

    def const(self, v) -> int:
        return self.add(("c", float(v)))


def _obj(shape, fill):
    a = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        a[idx] = fill(idx)
    return a


def _map1(fn, a):
    return _obj(a.shape, lambda idx: fn(a[idx]))


def _map2(fn, a, b):
    a, b = np.broadcast_arrays(a, b)
    return _obj(a.shape, lambda idx: fn(a[idx], b[idx]))


def trace_ir(fn: Callable, arg_kinds, arg_sizes) -> ScalarIR:
    """Trace ``fn`` on float64 tensors into a :class:`ScalarIR`.

    ``arg_kinds`` names each positional argument ("t", "y" or "p") and
    ``arg_sizes`` gives its length (None for the 0-d time)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    examples = [
        torch.zeros((), dtype=F64) if s is None else torch.zeros(s, dtype=F64)
        for s in arg_sizes
    ]
    try:
        gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*examples)
    except UnsupportedForKernel:
        raise
    except Exception as e:  # data-dependent control flow, unknown ops, ...
        raise UnsupportedForKernel(
            f"could not trace {getattr(fn, '__name__', fn)!r}: {e}"
        ) from e

    b = _Builder()
    env = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, kind, size in zip(placeholders, arg_kinds, arg_sizes):
        if size is None:
            env[node] = _obj((), lambda idx: b.add((kind,)))
        else:
            env[node] = _obj((size,), lambda idx, kind=kind: b.add((kind, idx[0])))

    def val(a):
        if hasattr(a, "op"):  # an fx node
            return env[a]
        if isinstance(a, (bool, int, float)):
            return _obj((), lambda idx: b.const(a))
        raise UnsupportedForKernel(f"argument {a!r} in traced equations")

    def binary(op, x, y):
        return _map2(lambda u, v: b.add((op, u, v)), val(x), val(y))

    def powi(x, k):
        if k == 0:
            return b.const(1.0)
        return b.add(("powi", x, k))

    out_nodes = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            const = getattr(gm, node.target).detach().to(F64).cpu().numpy()
            env[node] = _obj(const.shape, lambda idx, c=const: b.const(c[idx]))
            continue
        if node.op == "output":
            out_nodes = node.args[0]
            break
        if node.op != "call_function":
            raise UnsupportedForKernel(f"fx node {node.op!r}")
        name = str(node.target)
        args, kw = node.args, node.kwargs
        base = name.split(".")[1] if name.startswith("aten.") else name
        if kw.get("alpha", 1) != 1 or kw.get("rounding_mode") is not None:
            raise UnsupportedForKernel(f"{name} with {dict(kw)}")
        if base in _BINARY:
            res = binary(base, args[0], args[1])
        elif base == "rsub":
            res = binary("sub", args[1], args[0])
        elif base in _UNARY:
            res = _map1(lambda u, op=base: b.add((op, u)), val(args[0]))
        elif base == "pow" and not hasattr(args[1], "op"):
            k = float(args[1])
            if not k.is_integer():
                raise UnsupportedForKernel(f"pow by non-integer {k}")
            k = int(k)
            if k >= 0:
                res = _map1(lambda u: powi(u, k), val(args[0]))
            else:
                one = b.const(1.0)
                res = _map1(lambda u: b.add(("div", one, powi(u, -k))),
                            val(args[0]))
        elif base == "select":
            a = val(args[0])
            res = a[(slice(None),) * int(args[1]) + (int(args[2]),)]
        elif base == "slice":
            a = val(args[0])
            dim = int(args[1]) if len(args) > 1 else 0
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            end = args[3] if len(args) > 3 and args[3] is not None else a.shape[dim]
            step = args[4] if len(args) > 4 else 1
            sl = [slice(None)] * a.ndim
            sl[dim] = slice(int(start), min(int(end), a.shape[dim]), int(step))
            res = a[tuple(sl)]
        elif base == "stack":
            res = np.stack([val(x) for x in args[0]],
                           axis=int(args[1]) if len(args) > 1 else 0)
        elif base == "cat":
            res = np.concatenate([val(x) for x in args[0]],
                                 axis=int(args[1]) if len(args) > 1 else 0)
        elif base in ("view", "reshape", "_unsafe_view"):
            res = val(args[0]).reshape(tuple(int(s) for s in args[1]))
        elif base == "unsqueeze":
            res = np.expand_dims(val(args[0]), int(args[1]))
        elif base == "squeeze":
            a = val(args[0])
            res = (np.squeeze(a) if len(args) == 1
                   else np.squeeze(a, axis=tuple(np.atleast_1d(args[1]))))
        elif base == "expand":
            a = val(args[0])
            shape = tuple(int(s) if s != -1 else a.shape[i - (len(args[1]) - a.ndim)]
                          for i, s in enumerate(args[1]))
            res = np.broadcast_to(a, shape)
        elif base in ("permute",):
            res = np.transpose(val(args[0]), tuple(int(d) for d in args[1]))
        elif base in ("t", "transpose"):
            a = val(args[0])
            res = a.T if base == "t" else np.swapaxes(a, int(args[1]), int(args[2]))
        elif base in ("ones", "zeros", "full", "scalar_tensor"):
            shape = () if base == "scalar_tensor" else tuple(int(s) for s in args[0])
            fill = {"ones": 1.0, "zeros": 0.0}.get(base)
            if fill is None:
                fill = float(args[0] if base == "scalar_tensor" else args[1])
            res = _obj(shape, lambda idx, v=fill: b.const(v))
        elif base in ("ones_like", "zeros_like", "full_like"):
            fill = {"ones_like": 1.0, "zeros_like": 0.0}.get(base)
            fill = float(args[1]) if fill is None else fill
            res = _obj(val(args[0]).shape, lambda idx, v=fill: b.const(v))
        elif base in ("clone", "alias", "detach", "lift_fresh_copy",
                      "_to_copy", "contiguous"):
            dt = kw.get("dtype")
            if dt is not None and dt not in (torch.float64, torch.float32):
                raise UnsupportedForKernel(f"{name} to {dt}")
            res = val(args[0])
        else:
            raise UnsupportedForKernel(
                f"operation {name} is outside the fused kernel's scope"
            )
        if not isinstance(res, np.ndarray):
            res = _obj((), lambda idx, r=res: r)
        env[node] = res

    out = out_nodes[0] if isinstance(out_nodes, (tuple, list)) else out_nodes
    outs = val(out).reshape(-1)
    return ScalarIR(nodes=tuple(b.nodes), outputs=tuple(int(o) for o in outs))


def trace_model(rhs: Callable, init: Optional[Callable], nstates: int,
                nparams: int) -> ModelIR:
    """Trace a problem's member ``rhs(t, y, p)`` and, unless ``init`` is
    None (the banded kernel takes its initial state from the host),
    ``init(t, p)``."""
    rhs_ir = trace_ir(rhs, ("t", "y", "p"), (None, nstates, nparams))
    init_ir = None if init is None else trace_ir(init, ("t", "p"), (None, nparams))
    for name, ir in (("rhs", rhs_ir), ("init", init_ir)):
        if ir is not None and len(ir.outputs) != nstates:
            raise UnsupportedForKernel(
                f"{name} returns {len(ir.outputs)} values for {nstates} states"
            )
    return ModelIR(rhs=rhs_ir, init=init_ir, nstates=nstates, nparams=nparams)


def op_count(ir: ScalarIR) -> int:
    """Floating-point operations of one evaluation of ``ir`` (a power by k
    counts k-1 multiplies, each unary function one)."""
    return sum(node[2] - 1 if node[0] == "powi" else 1
               for node in ir.nodes if node[0] not in ("t", "y", "p", "c"))


# ---------------------------------------------------------------------------
# plain torch evaluator (value and dual)
# ---------------------------------------------------------------------------

def _eval(ir: ScalarIR, t, y, p, ty=None):
    """Evaluate ``ir``; with ``ty`` (the tangent of y) in dual arithmetic.
    Returns (values, tangents-or-None), each (..., nout)."""
    dual = ty is not None
    shape = torch.broadcast_shapes(
        t.shape, () if y is None else y.shape[:-1], p.shape[:-1])
    dev = p.device
    zero = torch.zeros(shape, dtype=F64, device=dev)
    vals, tans = [], []
    for node in ir.nodes:
        op = node[0]
        dv = None
        if op == "t":
            v = t + zero
            dv = zero
        elif op == "y":
            v = y[..., node[1]] + zero
            dv = ty[..., node[1]] + zero if dual else None
        elif op == "p":
            v = p[..., node[1]] + zero
            dv = zero
        elif op == "c":
            v = zero + node[1]
            dv = zero
        elif op == "powi":
            a, k = node[1], node[2]
            v, dv = vals[a], tans[a] if dual else None
            for _ in range(k - 1):
                if dual:
                    v, dv = v * vals[a], v * tans[a] + dv * vals[a]
                else:
                    v = v * vals[a]
        elif op in _BINARY:
            a, c = node[1], node[2]
            va, vb = vals[a], vals[c]
            if op == "add":
                v = va + vb
                dv = tans[a] + tans[c] if dual else None
            elif op == "sub":
                v = va - vb
                dv = tans[a] - tans[c] if dual else None
            elif op == "mul":
                v = va * vb
                dv = va * tans[c] + tans[a] * vb if dual else None
            else:
                v = va / vb
                dv = (tans[a] - v * tans[c]) / vb if dual else None
        else:
            a = node[1]
            x = vals[a]
            dx = tans[a] if dual else None
            if op == "neg":
                v = -x
                dv = -dx if dual else None
            elif op == "exp":
                v = torch.exp(x)
                dv = v * dx if dual else None
            elif op == "log":
                v = torch.log(x)
                dv = dx / x if dual else None
            elif op == "sqrt":
                v = torch.sqrt(x)
                dv = dx / (v * 2.0) if dual else None
            elif op == "sin":
                v = torch.sin(x)
                dv = torch.cos(x) * dx if dual else None
            elif op == "cos":
                v = torch.cos(x)
                dv = -(torch.sin(x) * dx) if dual else None
            elif op == "tanh":
                v = torch.tanh(x)
                dv = (1.0 - v * v) * dx if dual else None
            else:
                raise UnsupportedForKernel(f"IR op {op!r}")
        vals.append(v)
        tans.append(dv)
    out = torch.stack([vals[o] for o in ir.outputs], dim=-1)
    if not dual:
        return out, None
    return out, torch.stack([tans[o] for o in ir.outputs], dim=-1)


def eval_rhs(ir: ScalarIR, t, y, p):
    """Value of a traced ``rhs`` for (..., n) states and (..., np) params."""
    return _eval(ir, torch.as_tensor(t, dtype=F64, device=p.device), y, p)[0]


def eval_init(ir: ScalarIR, t, p):
    return _eval(ir, torch.as_tensor(t, dtype=F64, device=p.device), None, p)[0]


def jacobian(ir: ScalarIR, t, y, p):
    """(..., n, n) Jacobian of a traced ``rhs`` from n seeded dual
    evaluations (column c from the seed e_c), as the kernel computes it."""
    t = torch.as_tensor(t, dtype=F64, device=p.device)
    n = y.shape[-1]
    cols = []
    for c in range(n):
        seed = torch.zeros_like(y)
        seed[..., c] = 1.0
        cols.append(_eval(ir, t, y, p, ty=seed)[1])
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# CUDA emission
# ---------------------------------------------------------------------------

def _c_double(v: float) -> str:
    if math.isnan(v):
        return "(0.0 / 0.0)"
    if math.isinf(v):
        return "(1.0 / 0.0)" if v > 0 else "(-1.0 / 0.0)"
    return repr(float(v))  # shortest repr that round-trips exactly


def _emit_body(ir: ScalarIR) -> list:
    lines = []
    for k, node in enumerate(ir.nodes):
        op = node[0]
        if op == "t":
            e = "t"
        elif op in ("y", "p"):
            e = f"{op}[{node[1]}]"
        elif op == "c":
            e = f"T({_c_double(node[1])})"
        elif op == "powi":
            e = " * ".join([f"v{node[1]}"] * node[2])
        elif op in _BINARY:
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            e = f"v{node[1]} {sym} v{node[2]}"
        elif op == "neg":
            e = f"-v{node[1]}"
        else:
            e = f"dsol_{op}(v{node[1]})"
        lines.append(f"  const T v{k} = {e};")
    for i, o in enumerate(ir.outputs):
        lines.append(f"  out[{i}] = v{o};")
    return lines


def emit_cuda_header(model: ModelIR, name: str = "model") -> str:
    """The generated model header: ``MODEL_N``, ``MODEL_NP`` and the
    templated ``model_rhs`` (and, if traced, ``model_init``) device
    functions.

    ``model_rhs<T>(t, y, p, out)`` reads ``y[i]`` and assigns ``out[i]``
    through whatever types it is given: plain arrays in the small-n
    kernel, where a member's state lives in registers, and strided
    accessors in the banded kernel, which keeps a member's n-vectors in
    global scratch with the members fastest (csrc/fused_band_bdf.cuh), so
    the unrolled body reads and writes that layout directly, with no
    per-thread copy of the state."""
    lines = [
        f"// Generated from the traced equations of {name!r}; do not edit.",
        "#pragma once",
        '#include "dual.cuh"',
        f"#define MODEL_N {model.nstates}",
        f"#define MODEL_NP {model.nparams}",
        "namespace diffsol_model {",
        "template <typename T, typename Y, typename O>",
        "__device__ __forceinline__ void model_rhs(const T& t, Y y, "
        "const T* p, O out) {",
        "  (void)t; (void)y; (void)p;",
        *_emit_body(model.rhs),
        "}",
    ]
    if model.init is not None:
        lines += [
            "template <typename T>",
            "__device__ __forceinline__ void model_init(const T& t, const T* p, "
            "T* out) {",
            "  (void)t; (void)p;",
            *_emit_body(model.init),
            "}",
        ]
    lines += ["}  // namespace diffsol_model", ""]
    return "\n".join(lines)

