"""DiffSL model text to torch callables (counterpart of
``diffsol_tpu.diffsl``; reference crates/diffsol/src/ode_equations/
diffsl.rs:38-330 and the external diffsl crate).

The front end is the JAX package's, copied here so that this package
imports nothing of it: the tokenizer, the AST and the parser, the
reference and length helpers, the evaluator of the tensor expressions,
and ``compile_diffsl``'s numpy constant folding, state-dependency
analysis and state layout.  The evaluator takes an array module: numpy
when ``compile_diffsl`` folds the constant tensors, and a small shim with
numpy's names over torch (:class:`_TorchNp`) when the callables run.

``DiffslModel.make_callables`` yields float64 torch closures ``rhs``,
``init`` and, as the model has them, ``mass``, ``root``, ``out``,
``reset`` and ``reset_n``.  They are plain torch: the eager and lockstep
solvers ``vmap`` and ``jvp`` them, and the fused tiers trace them with
``make_fx`` into the kernels' scalar IR (:mod:`.ops.eqn_codegen`).  The
folded constants live on the device of the call's arguments
(:class:`.models._consts.DeviceConsts`), and literals stay Python floats,
so a trace lifts them as constants.

Language subset (what the reference's own DiffSL models use):

* tensor definitions ``name { ... }`` / ``name_i { ... }`` /
  ``name_ij { ... }`` (rank from the subscript);
* scalar entries, labeled entries (``x = 1``), indexed entries
  ``(3): v``, range entries ``(0:5): v`` / ``(0..5): v``, labeled range
  entries ``(0:n): c2 = 1.0e5``;
* 2-D keyed entries ``(i, j): v`` and diagonal-run range pairs
  ``(0..n, 1..n+1): v`` (ranges of equal length zip along a band; a
  length-1 range broadcasts); a keyed tensor's shape is inferred from its
  highest keyed index;
* arithmetic ``+ - * / ^``, unary minus, calls (sin, cos, tan, exp, log,
  sqrt, abs, pow, tanh, sinh, cosh, sigmoid, heaviside, min, max, ...);
* implicit contraction: within each product term, indices that do not
  appear in the destination tensor's subscript are summed (``F_i { A_ij
  * u_j }`` is a mat-vec; ``b_i { xx_i * yy_i }`` stays elementwise);
  inside function arguments everything is elementwise;
* special tensors ``in_i`` (parameters with defaults), ``u_i`` (states and
  initial values), ``dudt_i``, ``M_i`` (the mass action, linear in the
  dudt labels), ``F_i``, ``out_i``, ``stop_i`` (root functions),
  ``reset_i``; ``t`` in every expression.

The model-index built-in ``N`` (reference diffsl.rs ``set_model_index``;
diffsol-c ode_solver_type.rs:66 sets it to the index of the root that
fired before each reset) rides as a hidden trailing state (dy/dt = 0,
mass 1, init 0); the index-aware ``reset_n(t, y, p, k)`` sets it to ``k``
and then applies the reset, and the drivers call it with the fired root's
index.  ``r_i[N]`` selects between sub-models.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .models._consts import DeviceConsts

__all__ = ["parse", "compile_diffsl", "DiffslModel", "DiffslError"]

F64 = torch.float64

SPECIAL = ("in", "u", "dudt", "M", "F", "out", "stop", "reset")

_FUNCS = {
    "sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp", "log": "log",
    "ln": "log", "log10": "log10", "sqrt": "sqrt", "abs": "abs",
    "tanh": "tanh", "sinh": "sinh", "cosh": "cosh", "asin": "arcsin",
    "acos": "arccos", "atan": "arctan", "floor": "floor", "ceil": "ceil",
    "sign": "sign", "arcsinh": "arcsinh", "asinh": "arcsinh",
    "arccosh": "arccosh", "acosh": "arccosh", "arctanh": "arctanh",
    "atanh": "arctanh",
}
_FUNCS2 = {"pow": "power", "min": "minimum", "max": "maximum",
           "atan2": "arctan2", "copysign": "copysign"}


class DiffslError(ValueError):
    """Raised on DiffSL parse or semantic errors."""


# --------------------------------------------------------------------------
# lexer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>(\d+\.(?!\.)\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<name>[A-Za-z][A-Za-z0-9_]*)
  | (?P<dotdot>\.\.)
  | (?P<op>[{}(),;:=+\-*/^\[\]])
    """,
    re.VERBOSE,
)


def _tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise DiffslError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        val = m.group()
        if val == ";":
            # the reference grammar accepts ';' as a tensor-element
            # separator interchangeably with ',' (e.g. the lorenz example's
            # F_i { ...; ...; }); normalize at the lexer
            val = ","
        toks.append((kind, val))
    toks.append(("eof", ""))
    return toks


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Num:
    v: float


@dataclass(frozen=True)
class Ref:
    """Identifier reference, optionally subscripted: u_i -> Ref('u', 'i').

    ``slc`` is an optional element-range slice ``x_i[a:b]`` (pybamm-
    generated models slice state segments into electrode regions)."""

    name: str
    idx: str  # "" for bare references
    slc: Optional[tuple] = None  # (start, stop) or None


@dataclass(frozen=True)
class Call:
    fn: str
    args: tuple


@dataclass(frozen=True)
class Bin:
    op: str  # + - * / ^
    l: object
    r: object


@dataclass(frozen=True)
class Neg:
    x: object


@dataclass(frozen=True)
class Entry:
    """One entry of a tensor block."""

    expr: object = None
    label: Optional[str] = None
    # 1-D range (start, stop) or 2-D ((r0, r1), (c0, c1)); None = inferred
    rng: Optional[tuple] = None


@dataclass(frozen=True)
class TensorDef:
    name: str
    idx: str  # subscript letters ("", "i", "ij")
    entries: tuple


_IDX_SUFFIX = re.compile(r"^(.*[A-Za-z0-9])_([ijklmn]{1,3})$")


def _split_subscript(name: str):
    m = _IDX_SUFFIX.match(name)
    if m:
        return m.group(1), m.group(2)
    return name, ""


class _Parser:
    def __init__(self, src: str):
        self.toks = _tokenize(src)
        self.pos = 0

    def peek(self, k=0):
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, val):
        kind, v = self.next()
        if v != val:
            raise DiffslError(f"expected {val!r}, got {v!r}")
        return v

    # ---- model ----
    def model(self):
        defs = []
        while self.peek()[0] != "eof":
            defs.append(self.tensor_def())
        return defs

    def tensor_def(self):
        kind, raw = self.next()
        if kind != "name":
            raise DiffslError(f"expected tensor name, got {raw!r}")
        name, idx = _split_subscript(raw)
        self.expect("{")
        entries = []
        while self.peek()[1] != "}":
            entries.append(self.entry(rank=len(idx)))
            if self.peek()[1] == ",":
                self.next()
        self.expect("}")
        return TensorDef(name, idx, tuple(entries))

    # ---- entries ----
    def entry(self, rank: int):
        rng = None
        if self.peek()[1] == "(" and self._looks_like_range():
            rng = self.range_spec()
        label = None
        if (
            self.peek()[0] == "name"
            and self.peek(1)[1] == "="
        ):
            label = self.next()[1]
            self.next()  # '='
        expr = self.expr()
        return Entry(expr=expr, label=label, rng=rng)

    def _looks_like_range(self):
        """Lookahead: '(' INT [(:|..) INT] [',' INT [(:|..) INT]] ')' ':'"""
        i = self.pos
        toks = self.toks

        def at(j):
            return toks[min(j, len(toks) - 1)]

        if at(i)[1] != "(":
            return False
        j = i + 1
        for _ in range(2):  # up to two range components
            if at(j)[0] != "num" or "." in at(j)[1]:
                return False
            j += 1
            if at(j)[1] == ":" or at(j)[0] == "dotdot":
                j += 1
                if at(j)[0] != "num" or "." in at(j)[1]:
                    return False
                j += 1
            if at(j)[1] == ",":
                j += 1
                continue
            break
        if at(j)[1] != ")":
            return False
        return at(j + 1)[1] == ":"

    def range_spec(self):
        self.expect("(")
        parts = [self._one_range()]
        if self.peek()[1] == ",":
            self.next()
            parts.append(self._one_range())
        self.expect(")")
        self.expect(":")
        return tuple(parts)

    def _one_range(self):
        kind, v = self.next()
        if kind != "num":
            raise DiffslError(f"expected integer in range, got {v!r}")
        start = int(v)
        if self.peek()[1] == ":" or self.peek()[0] == "dotdot":
            self.next()
            kind, v = self.next()
            if kind != "num":
                raise DiffslError(f"expected integer in range, got {v!r}")
            return (start, int(v))
        return (start, start + 1)

    # ---- expressions (precedence climbing) ----
    def expr(self):
        return self._add()

    def _add(self):
        node = self._mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = Bin(op, node, self._mul())
        return node

    def _mul(self):
        node = self._unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = Bin(op, node, self._unary())
        return node

    def _unary(self):
        if self.peek()[1] == "-":
            self.next()
            return Neg(self._unary())
        if self.peek()[1] == "+":
            self.next()
            return self._unary()
        return self._pow()

    def _pow(self):
        node = self._atom()
        if self.peek()[1] == "^":
            self.next()
            return Bin("^", node, self._unary())
        return node

    def _atom(self):
        kind, v = self.next()
        if kind == "num":
            return Num(float(v))
        if v == "(":
            node = self.expr()
            self.expect(")")
            return node
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                while self.peek()[1] != ")":
                    args.append(self.expr())
                    if self.peek()[1] == ",":
                        self.next()
                self.expect(")")
                return Call(v, tuple(args))
            base, idx = _split_subscript(v)
            slc = None
            if self.peek()[1] == "[":
                self.next()
                k1, a = self.next()
                if k1 == "num" and self.peek()[1] == ":":
                    self.next()
                    k2, b = self.next()
                    if k2 != "num":
                        raise DiffslError(
                            f"expected integer in slice, got {b!r}"
                        )
                    self.expect("]")
                    slc = ("slice", int(a), int(b))
                elif k1 == "num":
                    self.expect("]")
                    slc = ("index", Num(float(a)))
                elif k1 == "name":
                    # dynamic index by an identifier (the model-index
                    # built-in: r_i[N])
                    self.expect("]")
                    slc = ("index", Ref(*_split_subscript(a)))
                else:
                    raise DiffslError(f"bad subscript {a!r} in []")
            return Ref(base, idx, slc)
        raise DiffslError(f"unexpected token {v!r} in expression")


def parse(src: str) -> list:
    """Parse DiffSL source into a list of TensorDef."""
    return _Parser(src).model()


# --------------------------------------------------------------------------
# semantic analysis + evaluation
# --------------------------------------------------------------------------


def _refs(node, out):
    if isinstance(node, Ref):
        out.add(node.name)
        if node.slc is not None and node.slc[0] == "index":
            _refs(node.slc[1], out)  # dynamic index: r_i[N]
    elif isinstance(node, Call):
        for a in node.args:
            _refs(a, out)
    elif isinstance(node, Bin):
        _refs(node.l, out)
        _refs(node.r, out)
    elif isinstance(node, Neg):
        _refs(node.x, out)
    return out


def _tensor_refs(td: TensorDef):
    out = set()
    for e in td.entries:
        _refs(e.expr, out)
    return out



# --------------------------------------------------------------------------
# numpy's names over torch
# --------------------------------------------------------------------------


def _is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor)


class _TorchNp:
    """The array module :class:`_Eval` calls, as numpy names over torch.

    A tensor passes through untouched (``torch.as_tensor`` on a traced or
    batched tensor breaks ``make_fx``, ``vmap`` and ``jvp``); a Python
    number stays a Python number where numpy's semantics allow it, and
    becomes a tensor of the problem's dtype on ``device`` where a torch
    function needs one."""

    def __init__(self, device, dtype=F64):
        self.device = device
        self.dtype = dtype

    def tensor(self, a) -> torch.Tensor:
        if _is_tensor(a):
            return a
        if np.ndim(a) == 0:  # a fill on the device, no host copy
            return torch.full((), float(a), dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    def stack(self, parts):
        if not any(_is_tensor(a) for a in parts):  # literals: one copy
            return torch.tensor(parts, dtype=self.dtype, device=self.device)
        return torch.stack([self.tensor(a) for a in parts])

    def asarray(self, a):
        if _is_tensor(a):
            return a
        if np.ndim(a) == 0:
            return float(a)
        return self.tensor(a)

    def transpose(self, a, perm):
        return a.permute(tuple(perm))

    def sum(self, a, axis):
        return torch.sum(a, dim=tuple(axis))

    def reshape(self, a, shape):
        return self.tensor(a).reshape(shape)

    def broadcast_to(self, a, shape):
        return self.tensor(a).expand(shape)

    def concatenate(self, parts):
        return torch.cat([self.tensor(a) for a in parts])

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def where(self, m, a, b):
        if not _is_tensor(m):
            m = torch.as_tensor(bool(m), device=self.device)
        return torch.where(m, self.tensor(a), self.tensor(b))

    def power(self, a, b):
        if not (_is_tensor(a) or _is_tensor(b)):
            return float(np.power(np.float64(a), np.float64(b)))
        return torch.pow(a, b)

    def divide(self, a, b):
        if not (_is_tensor(a) or _is_tensor(b)):
            return float(np.float64(a) / np.float64(b))
        return a / b

    def __getattr__(self, name):
        fn = _TORCH_FNS.get(name)
        if fn is None:
            raise AttributeError(name)
        return lambda *args: fn(*(self.tensor(a) for a in args))


# numpy's names (diffsl's _FUNCS and _FUNCS2 targets) -> torch
_TORCH_FNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
    "log": torch.log, "log10": torch.log10, "sqrt": torch.sqrt,
    "abs": torch.abs, "tanh": torch.tanh, "sinh": torch.sinh,
    "cosh": torch.cosh, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "floor": torch.floor, "ceil": torch.ceil,
    "sign": torch.sign, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "minimum": torch.minimum,
    "maximum": torch.maximum, "arctan2": torch.atan2,
    "copysign": torch.copysign,
}


class _Eval:
    """Evaluate an expression tree to (array, letters).

    ``letters`` names the axes of ``array`` (e.g. "ij").  ``dest`` is the
    destination tensor's subscript: inside every product term, letters not
    in ``dest`` are contracted (implicit summation over indices absent from
    the assignment target -- the DiffSL convention; A_ij * u_j sums j while
    xx_i * yy_i stays elementwise because i IS the destination index).
    """

    def __init__(self, xp, env, dims, dest):
        self.xp = xp  # numpy or a _TorchNp
        self.env = env  # name -> (array, rank)
        self.dims = dims  # letter -> size (filled as discovered)
        self.dest = dest

    def _align(self, vals):
        """Broadcast (arr, letters) values to a common letter string.  A
        scalar broadcasts as it is."""
        letters = ""
        for _a, ls in vals:
            for c in ls:
                if c not in letters:
                    letters += c
        out = []
        for a, ls in vals:
            if not ls:
                out.append(a)
                continue
            a = self.xp.asarray(a)
            # current order -> target order
            perm_src = [ls.index(c) for c in letters if c in ls]
            a = self.xp.transpose(a, perm_src) if a.ndim > 1 else a
            shape = []
            src_axis = 0
            for c in letters:
                if c in ls:
                    shape.append(a.shape[src_axis])
                    src_axis += 1
                else:
                    shape.append(1)
            out.append(self.xp.reshape(a, tuple(shape)))
        return out, letters

    def _contract(self, a, letters):
        """Sum axes whose letters are not in the destination subscript."""
        keep = [c for c in letters if c in self.dest]
        drop_axes = tuple(
            k for k, c in enumerate(letters) if c not in self.dest
        )
        if drop_axes:
            a = self.xp.sum(a, axis=drop_axes)
        return a, "".join(keep)

    def _einsum_term(self, factors):
        """A product term that contracts, as one ``torch.einsum`` over its
        factors with indices, scaled by the product of its scalar factors
        and then divided by its divisors with indices, so that ``A_ij *
        u_j`` over a batch of members is a batched mat-vec, not an (n, n)
        product a member, and ``D * A_ij * u_j / (h * h)`` scales each row
        once.  The same product in another order: it rounds apart from the
        elementwise chain by a few ulps of the terms.  None where the
        elementwise chain must stay: nothing to contract, or a divisor that
        carries a contracted index."""
        letters = ""
        for (_a, ls), _inv in factors:
            for c in ls:
                if c not in letters:
                    letters += c
        dropped = [c for c in letters if c not in self.dest]
        if not dropped or any(inv and set(ls) & set(dropped)
                              for (_a, ls), inv in factors):
            return None
        lead = [(a, ls) for (a, ls), inv in factors if ls and not inv]
        keep = "".join(c for c in letters if c in self.dest)
        inner = "".join(c for c in letters if any(c in ls for _a, ls in lead)
                        and c in self.dest)
        acc = torch.einsum(",".join(ls for _a, ls in lead) + "->" + inner,
                           *(a for a, _ls in lead))
        scale = None
        for (a, ls), inv in factors:
            if ls:
                continue
            if inv:
                scale = self.xp.divide(1.0 if scale is None else scale, a)
            else:
                scale = a if scale is None else scale * a
        if scale is not None:
            acc = acc * scale
        val = (acc, inner)
        for (a, ls), inv in factors:
            if ls and inv:
                (x, y), now = self._align([val, (a, ls)])
                val = (self.xp.divide(x, y), now)
        acc, now = val
        if now != keep:
            acc = acc.permute(tuple(now.index(c) for c in keep))
        return acc, keep

    def eval(self, node, top: bool = True):
        """Evaluate ``node``; ``top`` marks TERM-level position (the entry
        top and the spine of its +/- tree).  Implicit contraction over
        indices absent from the destination happens only at term level --
        at the top of each additive term and of each product chain there.
        Inside function arguments, powers and nested factors everything is
        pure elementwise broadcasting (a pybamm-DFN expression like
        ``c_ij * pow(K - f(u_j), 0.5)`` must keep j alive until the
        enclosing product with the _ij tensor)."""
        xp = self.xp
        if isinstance(node, Num):
            return xp.asarray(node.v), ""
        if isinstance(node, Neg):
            a, ls = self.eval(node.x, top)
            return -a, ls
        if isinstance(node, Ref):
            if node.name not in self.env:
                raise DiffslError(f"undefined identifier {node.name!r}")
            arr, rank = self.env[node.name]
            if rank == 0 and len(node.idx) == 1:
                # a length-1 segment label referenced as a vector
                # (pybamm M_i lists scalar dudt labels as `name_i`)
                return xp.reshape(xp.asarray(arr), (1,)), node.idx
            if len(node.idx) not in (rank, 0):
                raise DiffslError(
                    f"{node.name} has rank {rank}, subscripted _{node.idx}"
                )
            if rank == 0:
                return xp.asarray(arr), ""
            if not node.idx:
                if rank == 1 and np.prod(np.shape(arr)) == 1:
                    return xp.reshape(xp.asarray(arr), ()), ""
                raise DiffslError(
                    f"rank-{rank} tensor {node.name!r} referenced without "
                    "a subscript"
                )
            arr = xp.asarray(arr)
            if node.slc is not None:
                if rank != 1:
                    raise DiffslError(
                        f"slice on rank-{rank} tensor {node.name!r}"
                    )
                if node.slc[0] == "slice":
                    _tag, a, b = node.slc
                    if not 0 <= a <= b <= int(arr.shape[0]):
                        raise DiffslError(
                            f"slice [{a}:{b}] out of range for "
                            f"{node.name!r} (length {int(arr.shape[0])})"
                        )
                    arr = arr[a:b]
                else:  # dynamic element index: r_i[N]
                    iv, ils = self.eval(node.slc[1], top=False)
                    if ils:
                        raise DiffslError(
                            f"index into {node.name!r} must be a scalar"
                        )
                    if xp is np:
                        return xp.asarray(arr[int(iv)]), ""
                    # truncate toward zero, clamp into range, take
                    idx = torch.clamp(xp.tensor(iv).to(torch.int64), 0,
                                      int(arr.shape[0]) - 1)
                    return arr[idx], ""
            for c, size in zip(node.idx, arr.shape):
                if self.dims.setdefault(c, size) != size:
                    raise DiffslError(
                        f"index {c} bound to sizes {self.dims[c]} and {size}"
                    )
            return arr, node.idx
        if isinstance(node, Call):
            # Function arguments are NON-top positions: no contraction
            # happens inside an expression.  The reference compiler
            # translates each tensor element to ONE loop nest that
            # evaluates the whole scalar expression at a multi-index and
            # accumulates into the (possibly contracted) target -- so
            # F_i { exp(A_ij * u_j) } is sum_j exp(A_ij u_j), and a
            # repeated index inside an argument is ELEMENTWISE, not an
            # early contraction (the reference's pybamm DFN depends on
            # this, pybamm_dfn.diffsl:5333).
            vals = [self.eval(a, top=False) for a in node.args]
            arrs, letters = self._align(vals)
            if node.fn in _FUNCS and len(arrs) == 1:
                return getattr(xp, _FUNCS[node.fn])(arrs[0]), letters
            if node.fn in _FUNCS2 and len(arrs) == 2:
                return getattr(xp, _FUNCS2[node.fn])(*arrs), letters
            if node.fn == "sigmoid" and len(arrs) == 1:
                return xp.divide(1.0, 1.0 + xp.exp(-arrs[0])), letters
            if node.fn == "heaviside" and len(arrs) == 1:
                return xp.where(arrs[0] >= 0, 1.0, 0.0), letters
            raise DiffslError(
                f"unknown function {node.fn!r}/{len(arrs)} args"
            )
        if isinstance(node, Bin):
            if node.op in ("*", "/"):
                # Einstein summation is per product TERM, not per binary
                # node: flatten the whole * / chain, combine ALL factors on
                # the union index set, THEN contract once at the chain top
                # (A_ij * u_j * w_j must be sum_j A_ij u_j w_j, not
                # (A@u)_i * sum w).  Factors are NON-top positions: an
                # additive or function subexpression inside keeps all its
                # indices for this chain's contraction.
                factors = []

                def flatten(nd, inverted):
                    if isinstance(nd, Bin) and nd.op in ("*", "/"):
                        flatten(nd.l, inverted)
                        flatten(nd.r, inverted ^ (nd.op == "/"))
                    else:
                        factors.append((self.eval(nd, top=False), inverted))

                flatten(node, False)
                if top and xp is not np:
                    term = self._einsum_term(factors)
                    if term is not None:
                        return term
                arrs, letters = self._align([v for v, _inv in factors])
                acc = arrs[0]  # leftmost factor is never inverted
                for a, (_v, inv) in zip(arrs[1:], factors[1:]):
                    acc = xp.divide(acc, a) if inv else acc * a
                if top:
                    return self._contract(acc, letters)
                return acc, letters
            lv = self.eval(node.l, top)
            rv = self.eval(node.r, top)
            if node.op == "^":
                # a power applies WITHIN a term (u_i ^ 2 is sum u_i^2 at a
                # scalar destination, not (sum u)^2): combine elementwise,
                # contraction happens at the enclosing term/entry level
                (la, ra), letters = self._align([lv, rv])
                return xp.power(la, ra), letters
            # additive at term level: each side is its own term -> contract
            # independently; in nested positions, pure broadcasting
            if top:
                lv = self._contract(*lv)
                rv = self._contract(*rv)
            (la, ra), letters = self._align([lv, rv])
            if node.op == "+":
                return la + ra, letters
            return la - ra, letters
        raise DiffslError(f"cannot evaluate node {node!r}")


def _entry_length(arr_letters, rng):
    if rng is not None:
        (a, b) = rng[0]
        return b - a
    arr, letters = arr_letters
    if letters == "":
        return 1
    if len(letters) == 1:
        return int(np.shape(arr)[0])
    raise DiffslError("vector entry evaluated to rank > 1")


def _eval_vector(td: TensorDef, ev: _Eval):
    """Evaluate a rank-1 tensor definition to a flat array.

    Returns (array, segments) where segments = [(label, start, length)].
    """
    xp = ev.xp
    pieces = []
    segments = []
    pos = 0
    for e in td.entries:
        # index letters are scoped PER ENTRY: different entries of one
        # vector may bind i to different segment lengths (pybamm models
        # tile F_i from 400-, 60- and 20-row blocks)
        ev_e = _Eval(xp, ev.env, {}, ev.dest)
        val = ev_e.eval(e.expr)
        val = ev_e._contract(*val)
        n = _entry_length(val, e.rng)
        arr, letters = val
        if e.rng is not None:
            start = e.rng[0][0]
            if start != pos:
                raise DiffslError(
                    f"{td.name}: range starts at {start}, expected {pos} "
                    "(entries must tile the tensor contiguously)"
                )
        if letters and int(np.shape(arr)[0]) != n:
            raise DiffslError(
                f"{td.name}: entry length {np.shape(arr)[0]} != range {n}"
            )
        pieces.append((arr, letters, n))
        if e.label:
            segments.append((e.label, pos, n))
        pos += n
    return _join(xp, pieces), segments


def _join(xp, pieces):
    """The flat vector of (array, letters, length) entries.  A run of
    single scalar entries becomes one array (stacked, or one copy of its
    literals), a scalar over a range is broadcast, so a vector of k scalar
    entries costs two operations, not 2k + 1."""
    out, run = [], []
    for arr, letters, n in pieces + [(None, "", 0)]:
        if not letters and n == 1:
            run.append(arr)
            continue
        if run:
            out.append(xp.stack(run))
            run = []
        if letters:
            out.append(arr)
        elif n:
            out.append(xp.broadcast_to(xp.reshape(arr, (1,)), (n,)))
    return xp.concatenate(out) if out else xp.zeros((0,))


def _eval_matrix(td: TensorDef, ev: _Eval):
    """Evaluate a rank-2 tensor definition to a dense array.

    Keyed entries use diagonal-run semantics: ``(a..b, c..d)`` zips the two
    ranges (equal lengths; a length-1 range broadcasts), placing ``v`` along
    that band -- this is how heat1d writes its tridiagonal A_ij
    (reference test_models/heat1d.rs:38-42).
    """
    xp = ev.xp
    keyed = [e for e in td.entries if e.rng is not None]
    unkeyed = [e for e in td.entries if e.rng is None]
    if unkeyed and keyed:
        raise DiffslError(f"{td.name}: mixed keyed and unkeyed 2-D entries")
    if unkeyed:
        if len(unkeyed) != 1:
            raise DiffslError(f"{td.name}: one unkeyed 2-D entry allowed")
        arr, letters = ev.eval(unkeyed[0].expr)
        if letters != td.idx:
            raise DiffslError(
                f"{td.name}: 2-D entry has letters {letters!r}, "
                f"want {td.idx!r}"
            )
        return arr

    # all-literal keyed entries are built with numpy once
    nrow = max(r[0][1] for r in (e.rng for e in keyed))
    ncol = max(r[1][1] if len(r) > 1 else r[0][1]
               for r in (e.rng for e in keyed))
    rows, cols, vals = [], [], []
    traced_parts = []
    for e in keyed:
        r = e.rng
        (r0, r1) = r[0]
        (c0, c1) = r[1] if len(r) > 1 else r[0]
        nr, nc = r1 - r0, c1 - c0
        if nr != nc and 1 not in (nr, nc):
            raise DiffslError(
                f"{td.name}: range pair lengths {nr} x {nc} cannot zip"
            )
        cnt = max(nr, nc)
        ridx = np.arange(r0, r1) if nr > 1 else np.full(cnt, r0)
        cidx = np.arange(c0, c1) if nc > 1 else np.full(cnt, c0)
        lit = None
        if isinstance(e.expr, Num):
            lit = e.expr.v
        elif isinstance(e.expr, Neg) and isinstance(e.expr.x, Num):
            lit = -e.expr.x.v
        if lit is not None:
            rows.append(ridx)
            cols.append(cidx)
            vals.append(np.full(cnt, lit))
        else:
            # keyed entries assign scalars: evaluate with an empty
            # destination so any term indices fully contract
            ev0 = _Eval(ev.xp, ev.env, dict(ev.dims), "")
            arr, letters = ev0._contract(*ev0.eval(e.expr))
            if letters:
                raise DiffslError(
                    f"{td.name}: keyed 2-D entries must be scalars"
                )
            traced_parts.append((ridx, cidx, arr, cnt))
    mat = np.zeros((nrow, ncol))
    if rows:
        mat[np.concatenate(rows), np.concatenate(cols)] = np.concatenate(vals)
    if xp is np:
        for ridx, cidx, arr, _cnt in traced_parts:
            mat = _npset(mat, ridx, cidx, arr)
        return mat
    out = xp.tensor(mat)
    for ridx, cidx, arr, cnt in traced_parts:
        index = (torch.as_tensor(ridx, device=out.device),
                 torch.as_tensor(cidx, device=out.device))
        out = out.index_put(index, xp.broadcast_to(xp.reshape(arr, (1,)), (cnt,)))
    return out


def _npset(mat, ridx, cidx, arr):
    mat = np.array(mat)
    mat[ridx, cidx] = arr
    return mat


def _deps(name, by_name, order, memo):
    """Every name ``name``'s definition reads, through the intermediate
    tensors of ``order``."""
    if name not in memo:
        memo[name] = set()
        refs = _tensor_refs(by_name[name])
        out = set(refs)
        for r in refs:
            if r in order:
                out |= _deps(r, by_name, order, memo)
        memo[name] = out
    return memo[name]


# --------------------------------------------------------------------------
# model compilation
# --------------------------------------------------------------------------


@dataclass
class DiffslModel:
    """A parsed and analysed DiffSL model.

    ``compile_diffsl`` produces it; :meth:`make_callables` yields the torch
    closures that plug into :class:`diffsol_tpu_torch.problem.OdeBuilder`
    (the reference's DiffSl equations object, diffsl.rs:290-330).
    """

    source: str
    defs: list
    order: list  # evaluation order of intermediate tensor names
    param_labels: list  # [(name, start, len)] from in_i
    default_params: np.ndarray
    state_segments: list  # [(label, start, len)] from u_i
    dudt_segments: list
    nstates: int
    has_mass: bool
    has_root: bool
    has_out: bool
    has_reset: bool
    state_dep: set = field(default_factory=set)  # transitively state-dep
    constants: dict = field(default_factory=dict)
    # model references the `N` built-in: the model index rides as a hidden
    # trailing state (nstates reports the DSL count; callables carry +1)
    uses_n: bool = False

    # ---- serialization (reference solve_serialization.rs role) ----
    def serialize(self) -> str:
        """Portable JSON form, the JAX package's format: the source is the
        model, and text either package wrote loads in the other."""
        return json.dumps(
            {
                "format": "diffsol_tpu.diffsl.v1",
                "source": self.source,
                "default_params": [float(x) for x in self.default_params],
                "nstates": self.nstates,
            }
        )

    @staticmethod
    def deserialize(text: str) -> "DiffslModel":
        d = json.loads(text)
        if d.get("format") != "diffsol_tpu.diffsl.v1":
            raise DiffslError(f"unknown serialization format {d.get('format')}")
        return compile_diffsl(d["source"])

    # ---- callables ----
    def make_callables(self) -> dict:
        """The torch closures ``rhs(t, y, p)``, ``init(t, p)`` and,
        as the model has them, ``mass(t, p)``, ``root``, ``out``, ``reset``
        ``(t, y, p)`` and ``reset_n(t, y, p, k)``.

        The mass is the exact Jacobian of the linear mass action; when the
        action reads neither t nor a parameter it is computed once, here,
        and kept with the folded constants.  They compute in the dtype of
        ``p`` (float64, or float32 for ``OdeBuilder.dtype(torch.float32)``),
        the folded constants and literals included."""
        by_name = {td.name: td for td in self.defs}
        param_labels = self.param_labels
        state_segs = self.state_segments
        dudt_segs = self.dudt_segments
        n = self.nstates
        # `N` rides as a hidden trailing state (dy/dt = 0, mass diag 1),
        # updated to the fired root's index by the index-aware reset
        uses_n = self.uses_n
        n_full = n + 1 if uses_n else n
        ranks = {k: v[1] for k, v in self.constants.items()}
        consts = DeviceConsts(**{k: v[0] for k, v in self.constants.items()})
        order = self.order
        state_dep = self.state_dep

        def base_env(t, p):
            c = consts(p)
            env = {k: (c[k], r) for k, r in ranks.items()}
            env["t"] = (t, 0)
            env["pi"] = (math.pi, 0)
            for name, start, ln in param_labels:
                if ln == 1:
                    env[name] = (p[start], 0)
                else:
                    env[name] = (p[start:start + ln], 1)
            return env

        def eval_intermediates(env, xp, skip_state_deps=False):
            for name in order:
                if skip_state_deps and name in state_dep:
                    continue
                td = by_name[name]
                # index letters are scoped per tensor definition
                ev = _Eval(xp, env, {}, td.idx)
                if len(td.idx) <= 1:
                    arr, _segs = _eval_vector(td, ev)
                    if td.idx == "":
                        arr = arr.reshape(())
                    env[name] = (arr, len(td.idx))
                else:
                    env[name] = (_eval_matrix(td, ev), 2)
            return env

        def bind_state(env, y):
            base = y[:n]
            env["u"] = (base, 1)
            if uses_n:
                env["N"] = (y[n], 0)
            for name, start, ln in state_segs:
                env[name] = (
                    (base[start], 0) if ln == 1
                    else (base[start:start + ln], 1)
                )
            return env

        def eval_special(tdname, env, xp):
            td = by_name[tdname]
            arr, _ = _eval_vector(td, _Eval(xp, env, {}, td.idx))
            return arr

        def hidden_zero(like):
            return torch.zeros((1,), dtype=like.dtype, device=like.device)

        def init(t, p):
            xp = _TorchNp(p.device, p.dtype)
            env = eval_intermediates(base_env(t, p), xp, skip_state_deps=True)
            td = by_name["u"]
            arr, _ = _eval_vector(td, _Eval(xp, env, {}, td.idx or "i"))
            arr = arr.reshape((n,))
            if uses_n:
                arr = torch.cat([arr, hidden_zero(arr)])
            return arr

        def rhs(t, y, p):
            xp = _TorchNp(y.device, y.dtype)
            yf = y.reshape((n_full,))
            env = eval_intermediates(bind_state(base_env(t, p), yf), xp)
            f = eval_special("F", env, xp).reshape((n,))
            if uses_n:
                f = torch.cat([f, hidden_zero(f)])
            return f.reshape(y.shape)

        callables = {"rhs": rhs, "init": init}

        if self.has_mass:
            def mass_action(t, p, v):
                xp = _TorchNp(v.device, v.dtype)
                vf = v.reshape((n_full,))
                vb = vf[:n]
                env = base_env(t, p)
                env["dudt"] = (vb, 1)
                for name, start, ln in dudt_segs:
                    env[name] = (
                        (vb[start], 0) if ln == 1
                        else (vb[start:start + ln], 1)
                    )
                env = eval_intermediates(env, xp, skip_state_deps=True)
                m = eval_special("M", env, xp)
                if uses_n:  # hidden index row is differential: M v = v
                    m = torch.cat([m, vf[n:]])
                return m

            def mass_jac(t, p):
                # M_i is linear in dudt: the matrix is its exact Jacobian
                return torch.func.jacfwd(lambda v: mass_action(t, p, v))(
                    torch.zeros((n_full,), dtype=p.dtype, device=p.device))

            moving = {"t", "N"} | {pl[0] for pl in param_labels}
            if _deps("M", by_name, order, {}) & moving:
                mass = mass_jac
            else:
                fixed = DeviceConsts(mass=_static_mass(
                    mass_action, torch.as_tensor(self.default_params), n_full))

                def mass(t, p):
                    return fixed(p)["mass"]

            callables["mass"] = mass

        def make_state_fn(tdname):
            def f(t, y, p):
                xp = _TorchNp(y.device, y.dtype)
                env = bind_state(base_env(t, p), y.reshape((n_full,)))
                return eval_special(tdname, eval_intermediates(env, xp), xp)

            return f

        if self.has_root:
            callables["root"] = make_state_fn("stop")
        if self.has_out:
            callables["out"] = make_state_fn("out")
        if self.has_reset:
            if uses_n:
                plain = make_state_fn("reset")

                def reset(t, y, p):
                    # evaluated with the CURRENT hidden index (for API
                    # callers; the drivers apply reset_n at events)
                    yf = y.reshape((n_full,))
                    return torch.cat([plain(t, y, p), yf[n:]])

                def reset_n(t, y, p, k):
                    # reference protocol: N <- index of the fired root,
                    # THEN the reset applies (ode_solver_type.rs:66)
                    yf = y.reshape((n_full,))
                    kf = torch.as_tensor(k, dtype=yf.dtype, device=yf.device).reshape((1,))
                    xp = _TorchNp(yf.device, yf.dtype)
                    env = bind_state(base_env(t, p), yf)
                    env["N"] = (kf[0], 0)
                    vals = eval_special("reset", eval_intermediates(env, xp), xp)
                    return torch.cat([vals, kf])

                callables["reset"] = reset
                callables["reset_n"] = reset_n
            else:
                callables["reset"] = make_state_fn("reset")

        return callables


def _static_mass(mass_action, p, n: int, chunk: int = 64) -> np.ndarray:
    """The (n, n) matrix of a mass action that reads neither t nor p:
    its columns M e_k from forward-mode probes, ``chunk`` at a time."""
    t = torch.zeros((), dtype=F64)
    zero = torch.zeros((n,), dtype=F64)
    eye = torch.eye(n, dtype=F64)

    def column(e):
        return torch.func.jvp(lambda v: mass_action(t, p, v), (zero,), (e,))[1]

    cols = [torch.func.vmap(column)(eye[k:k + chunk]) for k in range(0, n, chunk)]
    return torch.cat(cols).T.contiguous().numpy()


def compile_diffsl(source: str) -> DiffslModel:
    """Parse + analyse DiffSL source (reference build_from_diffsl path,
    builder.rs `build_from_diffsl` -> diffsl.rs:239-330)."""
    defs = parse(source)
    by_name = {}
    for td in defs:
        if td.name in by_name:
            raise DiffslError(f"duplicate tensor {td.name!r}")
        by_name[td.name] = td

    if "u" not in by_name or "F" not in by_name:
        raise DiffslError("a DiffSL model needs `u` (states) and `F` (rhs)")

    # the model-index built-in `N` (reference diffsl.rs set_model_index +
    # diffsol-c ode_solver_type.rs:66: N is set to the index of the root
    # that fired, before the reset applies): carried as a HIDDEN trailing
    # state (dy/dt = 0) updated by the index-aware reset
    uses_n = any(
        "N" in _tensor_refs(td) for td in defs if "N" not in by_name
    )

    # ---- in_i: parameter labels + defaults ----
    param_labels, defaults = [], []
    if "in" in by_name:
        pos = 0
        ev = _Eval(np, {"pi": (np.pi, 0)}, {}, "i")
        for e in by_name["in"].entries:
            if e.label is None:
                raise DiffslError("in_i entries must be `name = default`")
            arr, letters = ev.eval(e.expr)
            ln = 1 if letters == "" else int(np.shape(arr)[0])
            param_labels.append((e.label, pos, ln))
            defaults.extend(np.ravel(arr).tolist() if ln > 1 else [float(arr)])
            pos += ln
    default_params = np.asarray(defaults, dtype=np.float64)

    # ---- classify constant tensors (fold with numpy at build time) ----
    state_labels = {e.label for e in by_name["u"].entries if e.label}
    dudt_labels = set()
    if "dudt" in by_name:
        dudt_labels = {e.label for e in by_name["dudt"].entries if e.label}
    dynamic = (
        {"t", "u", "dudt", "N"}
        | state_labels
        | dudt_labels
        | {pl[0] for pl in param_labels}
        | set(SPECIAL)
    )
    constants = {}
    order = []
    const_env = {"pi": (np.pi, 0)}
    for td in defs:
        if td.name in SPECIAL:
            continue
        refs = _tensor_refs(td)
        if refs & dynamic or any(r not in const_env and r not in constants
                                 for r in refs if r != "pi"):
            dynamic.add(td.name)
            order.append(td.name)
            continue
        env = dict(const_env)
        env.update(constants)
        ev = _Eval(np, env, {}, td.idx)
        try:
            if len(td.idx) <= 1:
                arr, _segs = _eval_vector(td, ev)
                if td.idx == "":
                    arr = np.reshape(arr, ())
                constants[td.name] = (np.asarray(arr), len(td.idx))
            else:
                constants[td.name] = (np.asarray(_eval_matrix(td, ev)), 2)
        except DiffslError:
            dynamic.add(td.name)
            order.append(td.name)

    # transitive state-dependency: tensors that (directly or through other
    # tensors) read u/dudt or their labels cannot be evaluated at init time
    state_roots = {"u", "dudt", "N"} | state_labels | dudt_labels
    state_dep = set()
    for td in defs:
        if td.name in SPECIAL:
            continue
        if _tensor_refs(td) & (state_roots | state_dep):
            state_dep.add(td.name)

    # ---- state layout ----
    # evaluate u with constants only to size the state vector; entries may
    # reference constant tensors (heat2d: y = init_i)
    env = dict(const_env)
    env.update(constants)
    for name, start, ln in param_labels:
        v = default_params[start:start + ln]
        env[name] = (v[0], 0) if ln == 1 else (v, 1)
    env["t"] = (np.asarray(0.0), 0)
    # intermediates that u might need and that are param-only
    for name in order:
        td = by_name[name]
        if name in state_dep:
            continue
        ev = _Eval(np, env, {}, td.idx)
        try:
            if len(td.idx) <= 1:
                arr, _ = _eval_vector(td, ev)
                env[name] = (
                    np.reshape(arr, ()) if td.idx == "" else arr,
                    len(td.idx),
                )
            else:
                env[name] = (_eval_matrix(td, ev), 2)
        except DiffslError:
            pass
    ev = _Eval(np, env, {}, by_name["u"].idx or "i")
    y0, state_segments = _eval_vector(by_name["u"], ev)
    nstates = int(np.shape(y0)[0])

    dudt_segments = []
    if "dudt" in by_name:
        ev = _Eval(np, env, {}, by_name["dudt"].idx or "i")
        _d0, dudt_segments = _eval_vector(by_name["dudt"], ev)

    return DiffslModel(
        source=source,
        defs=defs,
        order=order,
        param_labels=param_labels,
        default_params=default_params,
        state_segments=state_segments,
        dudt_segments=dudt_segments,
        nstates=nstates,
        has_mass="M" in by_name,
        has_root="stop" in by_name,
        has_out="out" in by_name,
        has_reset="reset" in by_name,
        state_dep=state_dep,
        constants=constants,
        uses_n=uses_n,
    )
