"""Device meshes over torch.distributed ranks: the port of the JAX package's
parallel/mesh.py, with the collectives the sharded table and argument use.

The framework's parallel axes (as in the JAX package):
  shard — the generator table partitioned by point and the inner-product
          argument's vectors by row (parallel/sharded_serial,
          parallel/sharded_ipa); the per-rank window sums are combined
          across it
  batch — data parallelism over independent witnesses (no sharded path
          uses it yet)

A Mesh lays the world's ranks out as a (shard, batch) grid, rank r at
shard r // n_batch and batch r % n_batch (the JAX package's
devices.reshape(n_shard, n_batch)); each axis is a torch.distributed
subgroup, and each rank names its own device.

Transport follows the process group's backend, which distributed.initialize
takes as an argument: NCCL moves CUDA tensors directly; gloo moves CPU
tensors, so a CUDA tensor given to a collective over gloo is copied to the
host and back here (several ranks on one card, where NCCL cannot put two
ranks on one device; the window sums are a few KB).
"""
import datetime
import os
import secrets

import torch
import torch.distributed as dist

from ..utils import rng

# every process group and subgroup gets a finite timeout: ranks whose
# collectives diverge fail instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

_active = None


class Mesh:
    """The world's ranks as a (shard, batch) grid.  `shape` maps each axis to
    its size, `index` to this rank's position on it; `device` is this rank's
    device, `backend` the process group's.  `traffic` counts this rank's
    collectives: name -> [calls, bytes it put in] (what PERF.md reads as
    collectives per IPA round and bytes gathered per MSM)."""

    def __init__(self, n_shard: int, n_batch: int, device,
                 timeout=DEFAULT_TIMEOUT):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_shard < 1 or n_batch < 1 or n_shard * n_batch != world:
            raise ValueError(f"mesh {n_shard} x {n_batch} over a world of "
                             f"{world} ranks")
        self.shape = {"shard": n_shard, "batch": n_batch}
        self.index = {"shard": rank // n_batch, "batch": rank % n_batch}
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.traffic = {}
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        # torch.distributed.new_group must be called by every rank for every
        # group, in the same order
        self._axes = {}
        for axis, lines in (
                ("shard", [[s * n_batch + b for s in range(n_shard)]
                           for b in range(n_batch)]),
                ("batch", [[s * n_batch + b for b in range(n_batch)]
                           for s in range(n_shard)])):
            for ranks in lines:
                group = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    self._axes[axis] = (ranks, group)

    def ranks(self, axis: str = "shard"):
        """The global ranks along `axis` through this rank, in axis order."""
        return self._axes[axis][0]

    def group(self, axis: str = "shard"):
        return self._axes[axis][1]


def make_mesh(n_shard: int = None, n_batch: int = 1, device=None,
              timeout=DEFAULT_TIMEOUT) -> Mesh:
    """A (shard, batch) mesh over the initialized world (all of it: n_shard
    defaults to world // n_batch).  `device` defaults to the card of this
    process's LOCAL_RANK (one card per rank); several ranks on one card, or
    on the CPU, pass it."""
    if n_shard is None:
        n_shard = dist.get_world_size() // n_batch
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(n_shard, n_batch, device, timeout)


def activate(mesh) -> None:
    """Make `mesh` the framework-wide mesh: generator tables (and with them
    every prover/verifier table MSM and the inner-product argument) shard
    over its "shard" axis when it has more than one rank.  None returns to
    one device.

    Over more than one shard this is a collective (every rank of the shard
    axis calls it): shard 0's 32 fresh secret bytes key every rank's
    unseeded blindings (utils/rng.share_key), so that the ranks' host
    programs draw the same blindings, and their verifiers the same
    batching scalar, as the sharded MSMs need."""
    global _active
    key = None
    if mesh is not None and mesh.shape["shard"] > 1:
        mine = torch.frombuffer(bytearray(secrets.token_bytes(32)),
                                dtype=torch.uint8)
        key = all_gather(mesh, mine.to(mesh.device))[0].cpu().numpy() \
            .tobytes()
    rng.share_key(key)
    _active = mesh


def active_mesh():
    return _active


# ---------------------------------------------------------------------------
# collectives

def _wire(mesh, x, name):
    """x as the backend moves it (on the host for gloo), counted in
    mesh.traffic under `name`."""
    calls = mesh.traffic.setdefault(name, [0, 0])
    calls[0] += 1
    calls[1] += x.numel() * x.element_size()
    return x.cpu() if mesh.backend == "gloo" else x


def all_gather(mesh, x, axis: str = "shard"):
    """x of every rank along `axis` -> [D, *x.shape] on x's device, in axis
    order."""
    t = _wire(mesh, x, "all_gather").contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.stack(parts).to(x.device)


def all_reduce(mesh, x, op: str, axis: str = "shard"):
    """The sum or max ("sum", "max") of x over the ranks along `axis`, on
    x's device (x itself is left as it was)."""
    t = _wire(mesh, x, "all_reduce").clone()
    dist.all_reduce(t, _OPS[op], group=mesh.group(axis))
    return t.to(x.device)


def exchange(mesh, x, src_of, axis: str = "shard"):
    """Point to point along `axis`: position i gets the x of position
    src_of[i], and sends its own x to every other position j with
    src_of[j] == i (one batch of isend / irecv)."""
    me, ranks, group = mesh.index[axis], mesh.ranks(axis), mesh.group(axis)
    t = _wire(mesh, x, "exchange").contiguous()
    out = t if src_of[me] == me else torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[j], group)
           for j, src in enumerate(src_of) if src == me and j != me]
    if src_of[me] != me:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src_of[me]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)
