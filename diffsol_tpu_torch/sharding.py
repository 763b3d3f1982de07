"""The member axis of an ensemble sharded over a device mesh (counterpart
of the JAX package's ``NamedSharding(mesh, P(axis))`` and of the
collectives XLA inserts for it, diffsol_tpu/ensemble.py:276-322, :452-518).

The program runs SPMD, one process a device, as under ``torchrun``: every
rank calls the entry point with the same global batch, as a JAX user passes
the global array, and solves the contiguous block of members that
``NamedSharding(mesh, P(axis))`` places on its coordinate along ``axis``
of a ``torch.distributed.device_mesh.DeviceMesh``; the mesh's other
dimensions are replicas.  Every rank gets the whole result back.

A :class:`MemberAxis` travels with the solve (a lockstep problem carries it
as ``OdeProblem.member_axis``) and gives it

* the split of a global batch into the rank's block, and the gather of the
  blocks back into the global batch along a member dimension;
* the reductions over members that a lockstep solve makes, every one a
  max (the error, Newton, order and initial-step norms) or the first
  index of the max (the worst member).  Each is ONE all-gather of the
  ranks' partial results, reduced on every rank in rank order by the same
  torch op an unsharded solve applies to the whole batch (``amax`` keeps
  a NaN, ``argmax`` takes the first maximum), so every rank takes the
  same decision from the same numbers, bit for bit.

The matrix-free Krylov tier's lockstep GMRES is one GMRES over the joint
B n system: its dot products and norms are sums over every member, each
the ranks' partial sums added in rank order on every rank
(:meth:`MemberAxis.sum`).  A sum reorders the unsharded one's terms, so a
sharded Krylov solve agrees with the unsharded one to roundoff, and every
rank holds the same bits as every other.

A :class:`StateAxis` is a second mesh dimension over the states of each
member (the JAX package's ``P("sp", ...)`` on the state dimension of a
large method-of-lines problem): the rank holds the contiguous block of
columns of its members' (B, n) state, the user's callables see each
member's whole state (one all-gather of the blocks a call,
:class:`StateShardedEquations`) and the norms' mean over states runs on
the gathered terms.  An implicit solve gathers, then solves whole, as
XLA's partitioner does with a sequential band LU: every rank builds and
factors the whole member iteration matrix from the gathered state, solves
it on the gathered residual and keeps its block
(:meth:`StateAxis.whole_solve`).  So an explicit or an implicit solve
takes the unsharded one's steps bit for bit.

An unsharded solve has no member axis (None) and makes no collective.  JAX
refuses a batch that the mesh axis does not divide (its ``device_put`` and
``jit(in_shardings=)`` raise ``ValueError``), and so does :meth:`MemberAxis.of`:
every block has the same size.  Gloo's collectives run on host memory, so
over a gloo group a card's tensors are staged through the host; NCCL's run
on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .equations import OdeEquations

F64 = torch.float64


def mesh_device(mesh, device=None) -> torch.device:
    """The rank's device on ``mesh``: the current card for a CUDA mesh, the
    CPU for a CPU mesh.  A ``device`` the caller also passed must say the
    same (a ``"cuda"`` without an index does), or this raises."""
    if mesh.device_type == "cuda":
        on = torch.device("cuda", torch.cuda.current_device())
    else:
        on = torch.device(mesh.device_type)
    if device is not None:
        asked = torch.device(device)
        if asked.type != on.type or asked.index not in (None, on.index):
            raise ValueError(f"device={device!r} contradicts the mesh: this rank "
                             f"solves on {on}")
    return on


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh dimension named ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no dimension {axis!r} (its dimensions: {names})")
    return mesh.size(names.index(axis))


class _Blocks:
    """The rank's contiguous block of a dimension of ``size`` entries
    sharded ``count`` ways over the process group ``group``: entries
    ``offset .. offset + local - 1``, where ``index`` is the rank's
    coordinate on the axis."""

    WHAT = ""  # the dimension's name in the error of :meth:`of`

    def __init__(self, group, index: int, count: int, size: int):
        self.group = group
        self.index = index
        self.count = count
        self.local = size // count
        self.offset = index * self.local
        # where the collectives run: gloo's on host memory, NCCL's on the card
        self.device = (torch.device("cpu") if dist.get_backend(group) == "gloo"
                       else torch.device("cuda", torch.cuda.current_device()))

    @classmethod
    def of(cls, mesh, axis: str, size: int):
        """The axis of ``size`` entries over the mesh dimension named
        ``axis``; a size the axis does not divide raises ``ValueError``, as
        JAX's ``NamedSharding(mesh, P(axis))`` does."""
        count = axis_size(mesh, axis)
        if size % count:
            raise ValueError(
                f"the sharding P({axis!r}) over a mesh axis of size {count} implies "
                f"that the global size of the {cls.WHAT} dimension should be divisible by "
                f"{count}, but it is equal to {size}")
        return cls(mesh.get_group(axis), mesh.get_local_rank(axis), count, size)

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(count, *t.shape): every rank's ``t``, in rank order, on ``t``'s
        device (a bool gathers as uint8)."""
        on, dtype = t.device, t.dtype
        src = (t.to(torch.uint8) if dtype == torch.bool else t).to(self.device).contiguous()
        out = src.new_empty((self.count,) + tuple(src.shape))
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return out.to(device=on, dtype=dtype)


class MemberAxis(_Blocks):
    """The rank's block of a global batch of members: members ``offset ..
    offset + local - 1`` (:meth:`of` with the batch's size)."""

    WHAT = "batch"

    # ---- blocks -------------------------------------------------------------
    def split(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's block of the global ``x`` along ``dim``."""
        return x.narrow(dim, self.offset, self.local)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The global tensor from every rank's block of it along ``dim``."""
        parts = self._all_gather(x.movedim(dim, 0))
        return parts.flatten(0, 1).movedim(0, dim)

    def partials(self, values) -> torch.Tensor:
        """(count, m) float64 on the host: the ranks' ``values`` (m 0-d
        tensors or numbers) side by side, in one collective."""
        dev = next((v.device for v in values if isinstance(v, torch.Tensor)), self.device)
        row = torch.stack([torch.as_tensor(v, dtype=F64, device=dev).reshape(())
                           for v in values])
        return self._all_gather(row).cpu()

    # ---- reductions over members ---------------------------------------------
    def max(self, local: torch.Tensor) -> torch.Tensor:
        """The max over all members of the rank's ``local.amax()``, a 0-d
        host tensor of ``local``'s dtype (the partials' float64 holds it
        exactly)."""
        return self.partials([local.amax()])[:, 0].amax().to(local.dtype)

    def max_and_argmax(self, flat: torch.Tensor, others=()):
        """``(max, first global index of it, [max of each of others])`` of
        the (local,) member values ``flat`` and of the 0-d maxima
        ``others``, in one collective.  The first rank whose block holds the
        max holds its first index, so this is ``argmax`` over the whole
        batch."""
        parts = self.partials([flat.amax(), self.offset + torch.argmax(flat)]
                              + list(others))
        r = int(torch.argmax(parts[:, 0]))
        return (parts[r, 0], int(parts[r, 1]),
                [parts[:, 2 + j].amax() for j in range(len(others))])

    def from_first(self, values) -> list:
        """The first rank's ``values`` (numbers) on every rank."""
        return self.partials(values)[0].tolist()

    def sum(self, local: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of their partial sums ``local`` (any
        shape), added in rank order on every rank: one all-gather, on
        ``local``'s device and in its dtype."""
        parts = self._all_gather(local)
        total = parts[0]
        for r in range(1, self.count):
            total = total + parts[r]
        return total


class StateAxis(_Blocks):
    """The rank's block of the ``n`` states of each member: columns
    ``offset .. offset + local - 1`` of the member-major (B, n) state
    (:meth:`of` with n).  It splits and gathers states only; the
    reductions over members stay the :class:`MemberAxis`'s."""

    WHAT = "state"

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The rank's block of the states of ``x`` (its last dimension)."""
        return x.narrow(dim, self.offset, self.local)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every member's whole states from the ranks' blocks of them, laid
        out as an unsharded state is (contiguous along the states): a
        reduction over them then takes the unsharded one's order."""
        parts = self._all_gather(x.movedim(dim, -1))  # (count, ..., local)
        return parts.movedim(0, -2).flatten(-2).movedim(-1, dim)

    def whole_solve(self, solve: Callable) -> Callable:
        """A linear solve ``solve(factors, b)`` of whole members made to
        take and return the rank's block of ``b`` (any leading axes): the
        blocks are gathered, the whole members solved against the whole
        factors every rank holds, and the rank keeps its block."""
        def blocks(factors, b):
            return self.split(solve(factors, self.gather(b)))

        return blocks


@dataclass(frozen=True, eq=False)
class StateShardedEquations(OdeEquations):
    """The lockstep equations of a problem whose states are sharded over
    ``saxis``: built by :func:`shard_states` from the lifted equations of
    whole members, each callable gathers the members' whole states and
    calls the user's.  ``rhs``, ``init`` and the resets return the rank's
    block; the root function and ``out`` their (B, nroots) and (B, nout)
    values, the same on every rank; ``rhs_jac`` the whole members' (B, n,
    n) matrix or (B, nb, n) band.  The mass is whole for the iteration
    matrix (``mass_repr``) and applied to a block as the block of the
    whole product (``mass_mul``).  ``rhs_whole`` and :meth:`mass_mul_whole`
    act on whole states, for a Jacobian that must not differentiate
    through a collective (the consistent initial conditions')."""

    saxis: Optional[object] = None
    rhs_whole: Optional[Callable] = None

    def mass_mul(self, t, p, v):
        if self.mass is None:
            return v
        if self.mass_diag_fn is not None:
            return v * self.saxis.split(self.mass_diag_fn(t, p))
        return self.saxis.split(self.mass_mul_whole(t, p, self.saxis.gather(v)))

    def mass_mul_whole(self, t, p, v):
        return OdeEquations.mass_mul(self, t, p, v)


def shard_states(eqn: OdeEquations, saxis: StateAxis) -> StateShardedEquations:
    """The lifted lockstep equations ``eqn`` of whole members over the
    state axis ``saxis`` (:class:`StateShardedEquations`).  Nothing here
    differentiates through a gather: the Jacobian is the user's, on the
    gathered state."""
    gather, split = saxis.gather, saxis.split

    def rhs(t, Y, Pb):
        return split(eqn.rhs(t, gather(Y), Pb))

    def init(t, Pb):
        return split(eqn.init(t, Pb)).contiguous()

    def jac(t, Y, Pb):
        return eqn.rhs_jac(t, gather(Y), Pb)

    if hasattr(eqn.rhs_jac, "jvp_probes"):
        jac.jvp_probes = eqn.rhs_jac.jvp_probes

    def whole(f):
        return None if f is None else (lambda t, Y, Pb: f(t, gather(Y), Pb))

    def block(f):
        return None if f is None else (lambda t, Y, Pb, *i: split(f(t, gather(Y), Pb, *i)))

    kept = {f.name: getattr(eqn, f.name) for f in fields(OdeEquations)}
    kept.update(rhs=rhs, init=init, rhs_jac=jac, root=whole(eqn.root), out=whole(eqn.out),
                reset=block(eqn.reset), reset_n=block(eqn.reset_n))
    return StateShardedEquations(**kept, saxis=saxis, rhs_whole=eqn.rhs)


def not_on_sharded_state(what: str) -> NotImplementedError:
    """The error for what a state-sharded problem does not run."""
    return NotImplementedError(
        f"{what} over a sharded state is not ported (ROADMAP 20f: the sensitivity "
        "rows' jvp through the sharded rhs, the Krylov and block-diagonal tiers and "
        "the member-time lift over a state sharded across ranks); BdfSolver, "
        "SdirkSolver and ErkSolver without sensitivities run it on the dense and "
        "banded tiers")


def refuse_state_axis(problem, what: str) -> None:
    """Raise :func:`not_on_sharded_state` when ``problem``'s states are
    sharded."""
    if getattr(problem, "state_axis", None) is not None:
        raise not_on_sharded_state(what)
