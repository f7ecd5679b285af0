"""The active mesh, and the one data-plane collective of tensor-parallel
serving.

Port of ``repro.distributed.context``'s mesh stack.  The serving steps run
their model under ``activate_mesh(placement.mesh)``; a model whose config
names a ``tp_axis`` asks :func:`tp_rank` which slice of heads or experts
is its own and :func:`all_gather_tiled` for the other ranks' slices.  The
gather is a concatenation in rank order, never a reduction, so a rank's
outputs carry the bits one device computes.  Outside an active mesh both
raise: a model that finds a sharded cache with no group to gather over
must not run on its slice alone.

``stats`` counts the gathers and their bytes; with ``stats.timing`` set,
each gather on the card is bracketed by CUDA events, read with
:meth:`CollectiveStats.device_ms` after a synchronisation.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

_STACK: list = []


@contextlib.contextmanager
def activate_mesh(mesh):
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh():
    return _STACK[-1] if _STACK else None


def _mesh_for(axis: str):
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise RuntimeError(f"tensor-parallel model code needs an active mesh with axis "
                           f"{axis!r} (serve the model through a Placement's steps)")
    return mesh


def tp_group(axis: str = "model"):
    """This rank's process group along ``axis`` of the active mesh (None on
    an axis of one rank)."""
    return _mesh_for(axis).group(axis)


def tp_rank(axis: str = "model") -> int:
    """This rank's index along ``axis`` of the active mesh."""
    return _mesh_for(axis).axis_index(axis)


class CollectiveStats:
    """Counts of the tiled all-gathers (calls, bytes received), and with
    ``timing`` their device time from CUDA events."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._events: list = []

    def device_ms(self) -> float:
        """Summed device time of the timed gathers (synchronises)."""
        if not self._events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


stats = CollectiveStats()


def all_gather_tiled(x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (the reference's ``all_gather(..., tiled=True)``).  NCCL gathers
    into one tensor; gloo through its list form."""
    n = _mesh_for(axis).shape[axis]
    if n == 1:
        return x
    group = tp_group(axis)
    xt = x.movedim(dim, 0).contiguous()
    timed = stats.timing and xt.is_cuda
    if timed:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=xt.dtype, device=xt.device)
        with warnings.catch_warnings():  # renamed in newer releases, same collective
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, xt, group=group)
    else:
        parts = [torch.empty_like(xt) for _ in range(n)]
        dist.all_gather(parts, xt, group=group)
        out = torch.cat(parts, 0)
    if timed:
        ev[1].record()
        stats._events.append(ev)
    stats.calls += 1
    stats.bytes += out.numel() * out.element_size()
    return out.movedim(0, dim)
