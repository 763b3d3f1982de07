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

An unsharded solve has no member axis (None) and makes no collective.  JAX
refuses a batch that the mesh axis does not divide (its ``device_put`` and
``jit(in_shardings=)`` raise ``ValueError``), and so does :meth:`MemberAxis.of`:
every block has the same size.  Gloo's collectives run on host memory, so
over a gloo group a card's tensors are staged through the host; NCCL's run
on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


class MemberAxis:
    """The rank's block of a global batch of ``nbatch`` members sharded
    ``count`` ways over the process group ``group``: members
    ``offset .. offset + local - 1``, where ``index`` is the rank's
    coordinate on the axis."""

    def __init__(self, group, index: int, count: int, nbatch: int):
        self.group = group
        self.index = index
        self.count = count
        self.local = nbatch // count
        self.offset = index * self.local
        # where the collectives run: gloo's on host memory, NCCL's on the card
        self.device = (torch.device("cpu") if dist.get_backend(group) == "gloo"
                       else torch.device("cuda", torch.cuda.current_device()))

    @classmethod
    def of(cls, mesh, axis: str, nbatch: int) -> "MemberAxis":
        """The member axis of ``nbatch`` members over the mesh dimension
        named ``axis``; a batch the axis does not divide raises
        ``ValueError``, as JAX's ``NamedSharding(mesh, P(axis))`` does."""
        count = axis_size(mesh, axis)
        if nbatch % count:
            raise ValueError(
                f"the sharding P({axis!r}) over a mesh axis of size {count} implies "
                f"that the global size of the batch dimension should be divisible by "
                f"{count}, but it is equal to {nbatch}")
        return cls(mesh.get_group(axis), mesh.get_local_rank(axis), count, nbatch)

    # ---- blocks -------------------------------------------------------------
    def split(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's block of the global ``x`` along ``dim``."""
        return x.narrow(dim, self.offset, self.local)

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(count, *t.shape): every rank's ``t``, in rank order, on ``t``'s
        device (a bool gathers as uint8)."""
        on, dtype = t.device, t.dtype
        src = (t.to(torch.uint8) if dtype == torch.bool else t).to(self.device).contiguous()
        out = src.new_empty((self.count,) + tuple(src.shape))
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return out.to(device=on, dtype=dtype)

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
