"""Device placement for the serving engine: the tensor-parallel group of one
replica, and the data-parallel replica policy.

Port of ``repro.serve.placement``, the one module of the serving side that
knows the topology.  ``Engine`` and ``Scheduler`` stay topology-free: they
hand their step functions and caches a :class:`Placement` and their
admitted requests to a :class:`ReplicaPlacer`.

Contract (the reference's):

* the pool shards on the KV-head axis over a ``('model',)`` mesh of ``tp``
  ranks (``distributed.sharding.serve_pool_partition``): each rank
  allocates its ``Hkv/tp`` heads of every pool leaf and never the whole
  pool; page tables, tokens and positions are host-side and equal on every
  rank; the weights are replicated, broadcast from the group's first rank —
  serving TP is KV, attention and expert parallelism, not weight sharding;
* each data-parallel replica owns a disjoint group of ``tp`` ranks
  (``launch.mesh.make_serve_meshes``) with its own pool, prefix cache and
  telemetry; replicas share no data-plane traffic;
* head and expert slices and tiled all-gathers only, never a reduction
  across ranks, so a sharded engine's tokens equal one device's bit for bit.

One process drives one rank: every rank of a group runs the same engine on
the same submits, so their host decisions agree by construction; the
engine broadcasts the host inputs that could differ (a tick's clock, a
submit's arrival time).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import P, _fit, serve_pool_partition
from repro_torch.launch.mesh import make_serve_meshes, world_rank


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """The user's knob on :class:`~repro_torch.serve.engine.EngineConfig`:
    ``tp`` ranks shard each replica's pool, attention and experts; ``dp``
    replicas run on disjoint rank groups
    (``serve.replica.ReplicatedEngine``)."""

    tp: int = 1
    dp: int = 1

    def __post_init__(self):
        if self.tp < 1 or self.dp < 1:
            raise ValueError(f"tp/dp must be >= 1, got tp={self.tp} dp={self.dp}")


class Placement:
    """One replica's placement on this rank: its ``('model',)`` mesh of
    ``tp`` ranks, this rank's index there (``rank``), the group's process
    group (``group``) and this rank's device.  ``tp == 1`` is the no-op
    placement: no mesh, no group, nothing broadcast."""

    AXIS = "model"

    def __init__(self, tp: int = 1, mesh=None):
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.tp = tp
        self.mesh = self.group = self.device = None
        self.rank = 0
        if tp == 1:
            return
        self.mesh = mesh if mesh is not None else make_serve_meshes(tp, 1)[0]
        if self.mesh.size != tp:
            raise ValueError(f"placement mesh has {self.mesh.size} ranks, want tp={tp}")
        if not self.mesh.contains_this_rank():
            raise ValueError(f"rank {world_rank()} is not in the placement's group "
                             f"{self.mesh.ranks.tolist()}; build data-parallel replicas "
                             f"with serve.replica.make_engine")
        self.rank = self.mesh.axis_index(self.AXIS)
        self.group = self.mesh.group(self.AXIS)
        self.device = self.mesh.device

    # -- the pool ----------------------------------------------------------

    def pool_specs(self, pool: dict) -> dict:
        """Head-axis PartitionSpecs of a pool's leaves (replicated at tp 1)."""
        if self.tp == 1:
            return {k: P(*([None] * len(v.shape))) for k, v in pool.items()}
        return serve_pool_partition(pool, self.mesh)

    def local_heads(self, heads: int) -> int:
        """The heads of an ``heads``-head pool leaf this rank holds:
        ``heads / tp`` when tp divides it, else all of them (replicated,
        as ``serve_pool_partition`` leaves it)."""
        if self.tp == 1 or _fit(self.mesh, heads, self.AXIS) is None:
            return heads
        return heads // self.tp

    def shard_pool(self, pool: dict) -> dict:
        """This rank's slice of a whole pool: every leaf's head block (axis
        3), contiguous.  The engine allocates its pools local from the start
        (``PagedCache(placement=...)``); this gives a one-device pool's
        counterpart, to compare with."""
        specs = self.pool_specs(pool)
        out = {}
        for name, leaf in pool.items():
            if specs[name][3] is None:  # replicated: all of it
                out[name] = leaf
                continue
            h = leaf.shape[3] // self.tp
            out[name] = leaf[:, :, :, self.rank * h:(self.rank + 1) * h].contiguous()
        return out

    # -- replication -------------------------------------------------------

    def replicate(self, tree):
        """Broadcast every tensor leaf of ``tree`` (in place) from the
        group's first rank, so the replicated weights are that rank's bit
        for bit; returns ``tree``."""
        if self.tp == 1:
            return tree
        return broadcast_tree(tree, self.mesh.first_rank, self.group)

    def broadcast_float(self, x: float) -> float:
        """``x`` as the group's first rank holds it."""
        if self.tp == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=self.mesh.first_rank, group=self.group)
        return float(t.item())

    def all_gather_ints(self, values: list[int]) -> list[list[int]]:
        """Every rank's ``values`` (int64, one length on every rank), in rank
        order."""
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        if self.tp == 1:
            return [t.tolist()]
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t, group=self.group)
        return [p.tolist() for p in parts]


def broadcast_tree(tree, src: int, group=None):
    """Broadcast every tensor leaf of ``tree`` in place from world rank
    ``src`` over ``group`` (the world by default); returns ``tree``."""
    for leaf in _tensor_leaves(tree):
        dist.broadcast(_bytes_view(leaf), src=src, group=group)
    return tree


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return []


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, so any dtype broadcasts on any backend."""
    if not t.is_contiguous():
        raise ValueError("replicate() broadcasts contiguous tensors in place")
    return t.reshape(-1).view(torch.uint8)


class ReplicaPlacer:
    """Places admitted requests onto DP replicas from their slot and page
    inventories: most free pages first (pages are the scarce, fragmenting
    resource), free slots break ties, round-robin breaks exact ties so equal
    replicas interleave instead of piling onto replica 0."""

    def __init__(self, n_replicas: int):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n = n_replicas
        self._rr = 0

    def place(self, free_pages, free_slots) -> int:
        """free_pages/free_slots: per-replica inventories (len == n)."""
        assert len(free_pages) == self.n and len(free_slots) == self.n
        order = [(self._rr + i) % self.n for i in range(self.n)]
        best = max(order, key=lambda r: (free_pages[r], free_slots[r]))
        self._rr = (best + 1) % self.n
        return best
