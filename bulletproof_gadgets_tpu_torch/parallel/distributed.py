"""Process-group initialization and host-aware meshes: the port of the JAX
package's parallel/distributed.py, on torch.distributed.

Topology model, as in the JAX package:

  hosts  x  local cards
  (network)  (NVLink)

The shard axis is laid out host-major (consecutive shard indices on the
same host first), so the all-gather of per-rank window sums stays within a
host where it can; the window sums are a few KB whatever the table size.

Launch, one process per card (torchrun sets the env:// variables that
`initialize()` reads with no arguments):

    torchrun --nnodes 2 --nproc-per-node 8 --rdzv-endpoint host0:29500 \
        your_prover.py

with each process calling `initialize()` and then
`mesh.activate(multihost_mesh())` before it proves.  Several ranks on one
card, or on the CPU, use the gloo backend and a mesh on that device
(`mesh.make_mesh(device=...)`); `run_ranks` starts such a world on one
host.
"""
import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT, make_mesh


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, backend: str = None,
               timeout=DEFAULT_TIMEOUT) -> bool:
    """torch.distributed.init_process_group with a finite `timeout`.

    coordinator "host:port" (TCP) or an init URL ("tcp://host:port",
    "file:///path"), with num_processes and process_id; with none of the
    three, the env:// variables that torchrun sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), and with neither, nothing happens and
    it returns False (one process).  backend: "nccl" (the default: one card
    per rank) or "gloo" (the CPU, and several ranks on one card)."""
    if coordinator is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init, world = "env://", {}
    elif None in (coordinator, num_processes, process_id):
        raise ValueError("coordinator, num_processes and process_id go "
                         "together")
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world = {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend or "nccl", init_method=init,
                            timeout=timeout, **world)
    return True


def multihost_mesh(n_batch: int = 1, timeout=DEFAULT_TIMEOUT):
    """The mesh over every process of the world, one card each: torchrun
    numbers ranks host by host, so the shard axis is host-major as it
    stands; this process's card is cuda:LOCAL_RANK."""
    return make_mesh(n_batch=n_batch, device=torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", 0))), timeout=timeout)


def _rank_main(fn, rank, world, init, backend, pg_timeout, args, results):
    try:
        initialize(init, world, rank, backend=backend, timeout=pg_timeout)
        out = (rank, True, fn(rank, world, *args))
    except Exception:                 # reported to run_ranks, which raises
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world: int, rendezvous: str, args=(), backend="gloo",
              timeout: float = 300.0, pg_timeout=DEFAULT_TIMEOUT):
    """fn(rank, world, *args) in `world` spawned processes on this host,
    each with its process group initialized (`backend`; a file store at the
    path `rendezvous`, which must not exist yet) -> each rank's result, in
    rank order.  fn must be a module-level function, its arguments and
    result picklable.  A rank that raises, exits without a result, or gives
    none within `timeout` seconds fails the call at once: every rank is
    killed and RuntimeError (TimeoutError) raised with the rank's
    traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.abspath(rendezvous)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, world, init, backend, pg_timeout, args, results))
        for rank in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" gave no result within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks' exit codes {codes} after their "
                               "results")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [got[r] for r in range(world)]
