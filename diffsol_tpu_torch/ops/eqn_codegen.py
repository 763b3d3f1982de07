"""User equations -> CUDA device functions (the role ``ops/dfinterp.py``
plays for the Pallas kernels).

The fused kernel evaluates the user's per-member ``rhs(t, y, p)`` and
``init(t, p)`` (and, where the problem has them, the mass diagonal
``(t, p)`` and ``root``, ``reset`` and ``out`` ``(t, y, p)``) inside CUDA,
but users write plain torch.  So each callable
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

Scope (the primitive set of dfinterp.py:21-29): + - * /, neg, pow (by an
integer, by any constant, or by a traced exponent), exp, expm1, log,
log1p, sqrt, rsqrt, sin, cos, tan, sinh, cosh, tanh, sigmoid, abs, sign,
maximum and minimum (with DualAlgebra's tangents, dfinterp.py:384-397 and
:494-499: abs flips the tangent only where x < 0, maximum and minimum take
the first operand's on a tie, sign has none), comparisons
and their and/or/not feeding ``where`` (whose mask may also be a constant
boolean tensor), indexing, slicing, stack/cat, ``diag`` of a vector with
``diagonal`` (a mass written as a matrix) and shape plumbing.  For the
2-D method-of-lines models (what ``ops/dfinterp_vec.py`` adds for the
banded Pallas kernel: rev, pad, dot_general, concatenate) also ``roll``,
``flip``, ``index``/``index_select``/``gather`` by constant integer
tensors, zero and reflection padding, ``sum`` over given dimensions and
``mm``/``bmm``/``mv``/``dot`` (what ``matmul`` and ``einsum`` become) as
unrolled sums of products, whose products by a literal 0 fold away (so a
DiffSL model's constant matrix contracted with the state keeps only its
band's products).  Anything else, and any data-dependent Python control
flow, raises :class:`UnsupportedForKernel`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

F64 = torch.float64
# "f32" is a cast to float32 (``OdeBuilder.dtype``'s wrapper around each
# callable): the value and its tangent rounded to float, as torch's
# ``_to_copy`` and its jvp round them; what follows it stays double
_UNARY = ("neg", "exp", "expm1", "log", "log1p", "sqrt", "rsqrt", "sin", "cos",
          "tan", "sinh", "cosh", "tanh", "sigmoid", "abs", "sign", "f32")
_BINARY = ("add", "sub", "mul", "div")
# maximum / minimum keep the operand the comparison picks, value and
# tangent (DualAlgebra.maximum / minimum, dfinterp.py:389-397)
_MINMAX = ("maximum", "minimum")
# comparisons and logic give boolean nodes, which only ``where`` consumes
_COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")
_LOGIC = {"logical_and": "and", "bitwise_and": "and", "logical_or": "or",
          "bitwise_or": "or", "logical_not": "not", "bitwise_not": "not"}
_BOOL_OPS = _COMPARE + ("and", "or", "not", "cb")
_LEAVES = ("t", "y", "p", "c", "cb")


class UnsupportedForKernel(Exception):
    """The problem or its equations are outside the fused kernel's scope;
    callers fall back to the lockstep path."""


@dataclass(frozen=True)
class ScalarIR:
    """Straight-line scalar program.  ``nodes[k]`` is ``(op, *args)``:
    ``("t",)``, ``("y", i)``, ``("p", i)``, ``("c", value)``, ``("cb", flag)``
    (a boolean constant), a unary op
    ``(name, a)``, a binary op ``(name, a, b)``, ``("powi", a, k)`` with an
    integer ``k >= 1``, ``("powc", a, k)`` with any constant ``k``,
    ``("pow", a, b)``, a boolean node (a comparison ``(name, a, b)``,
    ``("and", a, b)``, ``("or", a, b)``, ``("not", a)``) or
    ``("where", m, a, b)`` with a boolean ``m``; ``a``/``b`` index earlier
    nodes.  ``outputs`` index the nodes of the result vector."""

    nodes: tuple
    outputs: tuple


@dataclass(frozen=True)
class ModelIR:
    rhs: ScalarIR
    init: Optional[ScalarIR]  # None: the kernel gets y0 from the host
    nstates: int
    nparams: int
    # the mass diagonal: a program of (t, p), or the constant values when
    # it depends on neither (then the algebraic rows are static); both None
    # for the identity
    mass: Optional[ScalarIR] = None
    mass_const: Optional[tuple] = None
    root: Optional[ScalarIR] = None
    reset: Optional[ScalarIR] = None
    out: Optional[ScalarIR] = None


class _Builder:
    def __init__(self):
        self.nodes = []
        self.index = {}  # common-subexpression table

    def _literal(self, k):
        node = self.nodes[k]
        return node[1] if node[0] == "c" else None

    def _fold(self, node):
        """The node an arithmetic node with a literal 0 or 1 operand
        reduces to, else None: x*0 -> 0, 0/x -> 0, 0+x -> x, x*1 -> x,
        x/1 -> x, x-0 -> x; a cast of a literal to float32 to the rounded
        literal.  A constant matrix contracted with the state
        (a DiffSL Laplacian, A_ij * u_j) unrolls into n^2 products, nearly
        all by a literal 0; folded, it keeps the band's.  The result changes
        only where x is not finite (0 * inf is NaN, not 0), where the step
        fails anyway, and the kernel and its plain version share the IR."""
        op = node[0]
        if op == "f32":  # a literal rounds here, once
            a = self._literal(node[1])
            return None if a is None else self.const(float(np.float32(a)))
        if op not in _BINARY:
            return None
        a, b = self._literal(node[1]), self._literal(node[2])
        if op == "mul" and (a == 0.0 or b == 0.0):
            return self.const(0.0)
        if op == "div" and a == 0.0:
            return self.const(0.0)
        if (op == "add" and a == 0.0) or (op == "mul" and a == 1.0):
            return node[2]
        if ((op in ("add", "sub") and b == 0.0)
                or (op in ("mul", "div") and b == 1.0)):
            return node[1]
        return None

    def add(self, node) -> int:
        folded = self._fold(node)
        if folded is not None:
            return folded
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
        if isinstance(a, bool):
            raise UnsupportedForKernel("a Python bool in traced equations")
        if isinstance(a, (int, float)):
            return _obj((), lambda idx: b.const(a))
        raise UnsupportedForKernel(f"argument {a!r} in traced equations")

    def binary(op, x, y):
        return _map2(lambda u, v: b.add((op, u, v)), val(x), val(y))

    def powi(x, k):
        if k == 0:
            return b.const(1.0)
        return b.add(("powi", x, k))

    def index_of(a):
        """A constant integer tensor used as an index."""
        arr = val(a)
        if arr.dtype != np.int64:
            raise UnsupportedForKernel("indexing by a traced value")
        return arr

    def fold_sum(a, axes):
        """Sum over ``axes``, left to right, as unrolled adds."""
        for ax in sorted((d % a.ndim for d in axes), reverse=True):
            parts = [np.take(a, i, axis=ax) for i in range(a.shape[ax])]
            acc = parts[0] if parts else _obj(
                a.shape[:ax] + a.shape[ax + 1:], lambda idx: b.const(0.0))
            for part in parts[1:]:
                acc = _map2(lambda u, v: b.add(("add", u, v)), acc, part)
            a = acc
        return a

    def contract(x, y):
        """(..., m, k) @ (..., k, n) as unrolled sums of products."""
        prod = _map2(lambda u, v: b.add(("mul", u, v)),
                     x[..., :, :, None], y[..., None, :, :])
        return fold_sum(prod, [prod.ndim - 2])

    out_nodes = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            const = getattr(gm, node.target).detach().cpu()
            if const.dtype == torch.bool:  # a mask of ``where``
                cb = const.numpy()
                env[node] = _obj(cb.shape, lambda idx, c=cb: b.add(("cb", bool(c[idx]))))
            elif not const.dtype.is_floating_point:  # indices: kept as numbers
                env[node] = const.numpy().astype(np.int64)
            else:
                cf = const.to(F64).numpy()
                env[node] = _obj(cf.shape, lambda idx, c=cf: b.const(c[idx]))
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
        if base in _BINARY or base in _MINMAX:
            res = binary(base, args[0], args[1])
        elif base == "rsub":
            res = binary("sub", args[1], args[0])
        elif base in _UNARY:
            res = _map1(lambda u, op=base: b.add((op, u)), val(args[0]))
        elif base == "pow" and not hasattr(args[1], "op"):
            k = float(args[1])
            if not k.is_integer():
                res = _map1(lambda u: b.add(("powc", u, k)), val(args[0]))
            elif k >= 0:
                res = _map1(lambda u: powi(u, int(k)), val(args[0]))
            else:
                one = b.const(1.0)
                res = _map1(lambda u: b.add(("div", one, powi(u, -int(k)))),
                            val(args[0]))
        elif base == "pow":  # a traced exponent (and any base)
            res = binary("pow", args[0], args[1])
        elif base in _COMPARE:
            res = binary(base, args[0], args[1])
        elif base in _LOGIC and len(args) == 2:
            res = binary(_LOGIC[base], args[0], args[1])
        elif base in _LOGIC:
            res = _map1(lambda u: b.add(("not", u)), val(args[0]))
        elif base == "where" and len(args) == 3:
            m, x, y = np.broadcast_arrays(val(args[0]), val(args[1]), val(args[2]))
            def select(idx):
                mask = b.nodes[m[idx]]
                if mask[0] == "cb":  # a constant mask picks its branch now
                    return x[idx] if mask[1] else y[idx]
                return b.add(("where", m[idx], x[idx], y[idx]))

            res = _obj(m.shape, select)
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
        elif base == "roll":
            dims = tuple(int(d) for d in (args[2] if len(args) > 2 else ()))
            shifts = tuple(int(k) for k in args[1])
            a = val(args[0])
            res = (np.roll(a, shifts, axis=dims) if dims
                   else np.roll(a.reshape(-1), shifts[0]).reshape(a.shape))
        elif base == "flip":
            res = np.flip(val(args[0]), axis=tuple(int(d) for d in args[1]))
        elif base == "index":
            res = val(args[0])[tuple(slice(None) if i is None else index_of(i)
                                     for i in args[1])]
        elif base == "index_select":
            res = np.take(val(args[0]), index_of(args[2]), axis=int(args[1]))
        elif base == "gather":
            res = np.take_along_axis(val(args[0]), index_of(args[2]), axis=int(args[1]))
        elif base in ("constant_pad_nd", "reflection_pad1d", "reflection_pad2d"):
            a = val(args[0])
            pads = [int(k) for k in args[1]]
            if min(pads) < 0:
                raise UnsupportedForKernel(f"{name} with negative padding")
            fill = b.const(float(args[2]) if len(args) > 2 else 0.0)
            for k in range(len(pads) // 2):  # pairs run from the last axis back
                ax = a.ndim - 1 - k
                lo, hi = pads[2 * k], pads[2 * k + 1]
                if base == "constant_pad_nd":
                    def block(width):
                        return _obj(a.shape[:ax] + (width,) + a.shape[ax + 1:],
                                    lambda idx: fill)
                    a = np.concatenate([block(lo), a, block(hi)], axis=ax)
                else:
                    src = np.pad(np.arange(a.shape[ax]), (lo, hi), mode="reflect")
                    a = np.take(a, src, axis=ax)
            res = a
        elif base == "sum":
            a = val(args[0])
            if kw.get("dtype") not in (None, torch.float64):
                raise UnsupportedForKernel(f"{name} to {kw.get('dtype')}")
            axes = list(range(a.ndim)) if len(args) < 2 else [int(d) for d in args[1]]
            res = fold_sum(a, axes)
            if len(args) > 2 and args[2]:  # keepdim
                for ax in sorted(d % a.ndim for d in axes):
                    res = np.expand_dims(res, ax)
        elif base in ("mm", "bmm"):
            res = contract(val(args[0]), val(args[1]))
        elif base == "mv":
            res = contract(val(args[0]), val(args[1])[:, None])[..., 0]
        elif base == "dot":
            res = contract(val(args[0])[None, :], val(args[1])[:, None])[0, 0]
        elif base == "eye":
            rows = int(args[0])
            cols = int(args[1]) if len(args) > 1 else rows
            one, zero = b.const(1.0), b.const(0.0)
            res = _obj((rows, cols), lambda idx: one if idx[0] == idx[1] else zero)
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
        elif base == "diag_embed" and len(args) == 1 and val(args[0]).ndim == 1:
            a = val(args[0])
            zero = b.const(0.0)
            res = _obj((a.shape[0],) * 2,
                       lambda idx: a[idx[0]] if idx[0] == idx[1] else zero)
        elif base == "diagonal" and val(args[0]).ndim == 2 and (
                len(args) < 2 or int(args[1]) == 0):
            res = np.diagonal(val(args[0]))
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
            if dt == torch.float32:
                res = _map1(lambda u: b.add(("f32", u)), res)
        else:
            raise UnsupportedForKernel(
                f"operation {name} is outside the fused kernel's scope"
            )
        if not isinstance(res, np.ndarray):
            res = _obj((), lambda idx, r=res: r)
        env[node] = res

    out = out_nodes[0] if isinstance(out_nodes, (tuple, list)) else out_nodes
    outs = val(out).reshape(-1)
    ir = ScalarIR(nodes=tuple(b.nodes), outputs=tuple(int(o) for o in outs))
    _check_types(ir, getattr(fn, "__name__", fn))
    return ir


def _check_types(ir: ScalarIR, name) -> None:
    """Booleans feed only logic and the mask of ``where``; results and
    every arithmetic operand are real."""
    is_bool = [node[0] in _BOOL_OPS for node in ir.nodes]
    for node in ir.nodes:
        op, args = node[0], node[1:]
        if op in _LEAVES:
            continue
        if op in ("powi", "powc"):
            args = args[:1]
        if op in ("and", "or", "not"):
            want = [True] * len(args)
        elif op == "where":
            want = [True, False, False]
        else:
            want = [False] * len(args)
        if [is_bool[a] for a in args] != want:
            raise UnsupportedForKernel(
                f"{name!r} mixes boolean and real values in {op!r}")
    if any(is_bool[o] for o in ir.outputs):
        raise UnsupportedForKernel(f"{name!r} returns a boolean")


def trace_model(rhs: Callable, init: Optional[Callable], nstates: int,
                nparams: int, *, mass_diag: Optional[Callable] = None,
                mass_const=None, root: Optional[Callable] = None,
                reset: Optional[Callable] = None,
                out: Optional[Callable] = None) -> ModelIR:
    """Trace a problem's member ``rhs(t, y, p)`` and, unless ``init`` is
    None (the banded kernel takes its initial state from the host),
    ``init(t, p)``; beside them whichever of ``mass_diag(t, p)`` (not
    traced when the caller found it constant and passes ``mass_const``),
    ``root``, ``reset`` and ``out`` ``(t, y, p)`` the problem has."""
    def typ(fn):
        return None if fn is None else trace_ir(
            fn, ("t", "y", "p"), (None, nstates, nparams))

    rhs_ir = typ(rhs)
    init_ir = None if init is None else trace_ir(init, ("t", "p"), (None, nparams))
    mass_ir = None
    if mass_const is not None:
        mass_const = tuple(float(v) for v in mass_const)
    elif mass_diag is not None:
        mass_ir = trace_ir(mass_diag, ("t", "p"), (None, nparams))
    reset_ir = typ(reset)
    for name, ir in (("rhs", rhs_ir), ("init", init_ir), ("mass", mass_ir),
                     ("reset", reset_ir)):
        if ir is not None and len(ir.outputs) != nstates:
            raise UnsupportedForKernel(
                f"{name} returns {len(ir.outputs)} values for {nstates} states"
            )
    return ModelIR(rhs=rhs_ir, init=init_ir, nstates=nstates, nparams=nparams,
                   mass=mass_ir, mass_const=mass_const, root=typ(root),
                   reset=reset_ir, out=typ(out))


def op_count(ir: ScalarIR) -> int:
    """Floating-point operations of one evaluation of ``ir`` (a power by
    an integer k counts k-1 multiplies, every other node one)."""
    return sum(node[2] - 1 if node[0] == "powi" else 1
               for node in ir.nodes if node[0] not in _LEAVES)


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
        elif op == "cb":
            v = torch.full(shape, node[1], dtype=torch.bool, device=dev)
        elif op == "powi":
            a, k = node[1], node[2]
            v, dv = vals[a], tans[a] if dual else None
            for _ in range(k - 1):
                if dual:
                    v, dv = v * vals[a], v * tans[a] + dv * vals[a]
                else:
                    v = v * vals[a]
        elif op == "powc":
            a, k = node[1], node[2]
            v = torch.pow(vals[a], k)
            dv = k * torch.pow(vals[a], k - 1.0) * tans[a] if dual else None
        elif op == "pow":
            a, c = node[1], node[2]
            va, vb = vals[a], vals[c]
            v = torch.pow(va, vb)
            dv = (v * (tans[c] * torch.log(va) + vb * tans[a] / va)
                  if dual else None)
        elif op in _COMPARE:
            v = getattr(torch, op)(vals[node[1]], vals[node[2]])
        elif op == "and":
            v = vals[node[1]] & vals[node[2]]
        elif op == "or":
            v = vals[node[1]] | vals[node[2]]
        elif op == "not":
            v = ~vals[node[1]]
        elif op == "where":
            m, a, c = node[1], node[2], node[3]
            v = torch.where(vals[m], vals[a], vals[c])
            dv = torch.where(vals[m], tans[a], tans[c]) if dual else None
        elif op in _MINMAX:
            a, c = node[1], node[2]
            take = (vals[a] >= vals[c]) if op == "maximum" else (vals[a] <= vals[c])
            v = torch.where(take, vals[a], vals[c])
            dv = torch.where(take, tans[a], tans[c]) if dual else None
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
            elif op == "expm1":
                v = torch.expm1(x)
                dv = (v + 1.0) * dx if dual else None
            elif op == "log":
                v = torch.log(x)
                dv = dx / x if dual else None
            elif op == "log1p":
                v = torch.log1p(x)
                dv = dx / (x + 1.0) if dual else None
            elif op == "rsqrt":
                v = torch.rsqrt(x)
                dv = -(v * dx) / (x * 2.0) if dual else None
            elif op == "tan":
                v = torch.tan(x)
                dv = (1.0 + v * v) * dx if dual else None
            elif op == "sinh":
                v = torch.sinh(x)
                dv = torch.cosh(x) * dx if dual else None
            elif op == "cosh":
                v = torch.cosh(x)
                dv = torch.sinh(x) * dx if dual else None
            elif op == "sigmoid":
                v = torch.sigmoid(x)
                dv = v * (1.0 - v) * dx if dual else None
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
            elif op == "abs":
                # the tangent flips only where x < 0: +dx at x = 0
                # (DualAlgebra.abs_), where torch's derivative gives 0
                v = torch.abs(x)
                dv = torch.where(x < 0.0, -dx, dx) if dual else None
            elif op == "sign":
                v = torch.sign(x)
                dv = zero if dual else None
            elif op == "f32":
                v = x.float().double()
                dv = dx.float().double() if dual else None
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
    """Value of a traced ``(t, p)`` program (``init`` or the mass
    diagonal)."""
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


def _node_inputs(node) -> tuple:
    """The earlier nodes a node reads."""
    op = node[0]
    if op in _LEAVES:
        return ()
    if op in ("powi", "powc"):
        return (node[1],)
    return tuple(node[1:])


def _output_order(ir: ScalarIR) -> list:
    """``ir``'s nodes in the order of a depth-first walk from each output
    in turn, each output (``("out", i)``) right after the nodes it needs
    that are not yet emitted.  Nodes no output needs are left out."""
    done = [False] * len(ir.nodes)
    order = []
    for i, o in enumerate(ir.outputs):
        stack = [(o, False)]
        while stack:
            k, ready = stack.pop()
            if done[k]:
                continue
            if ready:
                done[k] = True
                order.append(k)
                continue
            stack.append((k, True))
            stack.extend((a, False) for a in reversed(_node_inputs(ir.nodes[k]))
                         if not done[a])
        order.append(("out", i))
    return order


def _emit_body(ir: ScalarIR, stream_outputs: bool = False) -> list:
    """The body's C++ lines: every node in IR order and then the outputs,
    or, with ``stream_outputs``, in :func:`_output_order` (each output
    stored as soon as its operands are, so few values are live at once;
    ``out`` must not alias ``y``)."""
    lines = []
    seq = (_output_order(ir) if stream_outputs
           else list(range(len(ir.nodes))) + [("out", i) for i in range(len(ir.outputs))])
    for k in seq:
        if isinstance(k, tuple):
            lines.append(f"  out[{k[1]}] = v{ir.outputs[k[1]]};")
            continue
        node = ir.nodes[k]
        op = node[0]
        if op == "t":
            e = "t"
        elif op in ("y", "p"):
            e = f"{op}[{node[1]}]"
        elif op == "c":
            e = f"T({_c_double(node[1])})"
        elif op == "cb":
            e = "true" if node[1] else "false"
        elif op == "powi":
            e = " * ".join([f"v{node[1]}"] * node[2])
        elif op == "powc":
            e = f"dsol_powc(v{node[1]}, {_c_double(node[2])})"
        elif op == "pow":
            e = f"dsol_pow(v{node[1]}, v{node[2]})"
        elif op in _COMPARE:
            e = f"dsol_{op}(v{node[1]}, v{node[2]})"
        elif op in ("and", "or"):
            e = f"v{node[1]} {'&&' if op == 'and' else '||'} v{node[2]}"
        elif op == "not":
            e = f"!v{node[1]}"
        elif op == "where":
            e = f"dsol_where(v{node[1]}, v{node[2]}, v{node[3]})"
        elif op in _MINMAX:
            e = f"dsol_{op}(v{node[1]}, v{node[2]})"
        elif op in _BINARY:
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            e = f"v{node[1]} {sym} v{node[2]}"
        elif op == "neg":
            e = f"-v{node[1]}"
        else:
            e = f"dsol_{op}(v{node[1]})"
        lines.append(f"  const {'bool' if op in _BOOL_OPS else 'T'} v{k} = {e};")
    return lines


def _emit_tyo(fn_name: str, ir: ScalarIR, stream_outputs: bool = False) -> list:
    """A ``(t, y, p) -> out`` device function, generic in its accessors."""
    return [
        "template <typename T, typename Y, typename O>",
        f"__device__ __forceinline__ void {fn_name}(const T& t, Y y, "
        "const T* p, O out) {",
        "  (void)t; (void)y; (void)p;",
        *_emit_body(ir, stream_outputs),
        "}",
    ]


def emit_cuda_header(model: ModelIR, name: str = "model", nquad: int = 0,
                     out_in_err: bool = False, mixed: bool = False,
                     stream_outputs: bool = False) -> str:
    """The generated model header: ``MODEL_N``, ``MODEL_NP``, the
    compile-time switches of the small-n kernel and the templated device
    functions ``model_rhs`` and, where the model has them, ``model_init``,
    ``model_mass`` (the mass diagonal), ``model_root``, ``model_reset`` and
    ``model_out``.  ``nquad`` is the number of quadrature rows of the solve
    (0: nothing is integrated; without ``model_out`` the state itself is),
    ``out_in_err`` whether they join the error test, and ``mixed`` whether
    the small-n kernel keeps its Newton matrix path in float
    (``precision="mixed"``).  A problem with none of these gets the
    switches at 0, and the kernel instantiates as it does for a plain ODE.

    ``model_rhs<T>(t, y, p, out)`` reads ``y[i]`` and assigns ``out[i]``
    through whatever types it is given: plain arrays in the small-n
    kernel, where a member's state lives in registers, and strided
    accessors in the banded kernel, which keeps a member's n-vectors in
    global scratch with the members fastest (csrc/fused_band_bdf.cuh), so
    the unrolled body reads and writes that layout directly, with no
    per-thread copy of the state.  ``stream_outputs`` orders ``model_rhs``
    output by output (:func:`_output_order`), for the banded kernel, whose
    rhs of hundreds of states would otherwise hold every intermediate of
    one operation over all states live at once."""
    has_mass = model.mass is not None or model.mass_const is not None
    lines = [
        f"// Generated from the traced equations of {name!r}; do not edit.",
        "#pragma once",
        '#include "dual.cuh"',
        f"#define MODEL_N {model.nstates}",
        f"#define MODEL_NP {model.nparams}",
        f"#define MODEL_HAS_MASS {int(has_mass)}",
        f"#define MODEL_NROOT {len(model.root.outputs) if model.root else 0}",
        f"#define MODEL_HAS_RESET {int(model.reset is not None)}",
        f"#define MODEL_NQUAD {int(nquad)}",
        f"#define MODEL_HAS_OUT {int(model.out is not None)}",
        f"#define MODEL_OUT_IN_ERR {int(bool(out_in_err))}",
        f"#define MODEL_MIXED {int(bool(mixed))}",
        "namespace diffsol_model {",
        *_emit_tyo("model_rhs", model.rhs, stream_outputs),
    ]
    for fn_name, ir in (("model_root", model.root), ("model_reset", model.reset),
                        ("model_out", model.out)):
        if ir is not None:
            lines += _emit_tyo(fn_name, ir)
    if has_mass:
        # a constant diagonal is literal assignments, which fold into the
        # kernel (and make its algebraic-row tests static)
        body = (_emit_body(model.mass) if model.mass is not None else
                [f"  out[{i}] = T({_c_double(v)});"
                 for i, v in enumerate(model.mass_const)])
        lines += [
            "template <typename T>",
            "__device__ __forceinline__ void model_mass(const T& t, const T* p, "
            "T* out) {",
            "  (void)t; (void)p;",
            *body,
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

