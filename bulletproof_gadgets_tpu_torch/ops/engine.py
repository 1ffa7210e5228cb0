"""Device engine wiring: installs the device MSM (ops/msm_serial) as the
core backends for one explicit torch device.

`register(device, msm_layout)` sets core.msm's generic backend (MSMs of at
least MIN_DEVICE_MSM points) and its generator-table factory, both running
their bucket accumulation in `msm_layout` (ops/msm_serial.LAYOUTS; the
JAX package's BPG_TPU_MSM_ROWS / BPG_TPU_MSM_RCHUNK switches, here an
argument).  Tables are cached by content, device and layout, so the prover
and the verifier of one circuit size share one device-resident source.
With a mesh active (parallel/mesh.activate) whose shard axis has more than
one rank, the factory builds parallel/sharded_serial.ShardedGeneratorTable
on the mesh's device instead, cached per mesh too; a mesh of one shard
keeps GeneratorTable.
Nothing registers itself at import: the entry points (lang.prove.prove,
lang.verify.verify, lang.batch.prove_batch) call `use(device)`, which
registers CUDA unless a device was given or registered before, and keeps
the registered layout.
"""
import torch

from ..core import msm as core_msm
from ..parallel import mesh as mesh_mod
from ..parallel.sharded_serial import ShardedGeneratorTable
from . import msm_serial

MIN_DEVICE_MSM = 192

_table_cache = {}
_TABLE_CACHE_MAX = 3
_device = None          # the registered device
_layout = "rows"        # the registered MSM layout


def _table_key(G, H, B, B_blinding):
    """Content-derived cache key: endpoint coordinates pin the generator
    vectors (they are deterministic SHAKE256 chains, so (len, first, last)
    identifies the slice)."""
    return (len(G),
            G[0].X if G else 0, G[-1].X if G else 0,
            H[0].X if H else 0, H[-1].X if H else 0,
            B.X, B.Y, B_blinding.X, B_blinding.Y)


def table_factory(G, H, B, B_blinding, device, layout):
    mesh = mesh_mod.active_mesh()
    if mesh is not None and mesh.shape["shard"] == 1:
        mesh = None                       # one shard: one device's table
    key = _table_key(G, H, B, B_blinding) + (
        str(device) if mesh is None else mesh, layout)
    t = _table_cache.get(key)
    if t is None:
        t = (msm_serial.GeneratorTable(G, H, B, B_blinding, device, layout)
             if mesh is None else
             ShardedGeneratorTable(G, H, B, B_blinding, mesh, layout))
        if len(_table_cache) >= _TABLE_CACHE_MAX:
            _table_cache.pop(next(iter(_table_cache)))
        _table_cache[key] = t
    return t


def register(device, msm_layout: str = "rows") -> torch.device:
    """Route core.msm's device work to `device` ('cuda', 'cuda:1', 'cpu'),
    its bucket accumulation in `msm_layout` (one of msm_serial.LAYOUTS).
    CUDA that is asked for and not there raises: no silent CPU run."""
    global _device, _layout
    msm_serial.check_layout(msm_layout)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    core_msm.set_backend(
        lambda ks, points: msm_serial.msm(ks, points, device, msm_layout),
        MIN_DEVICE_MSM)
    core_msm.set_table_factory(
        lambda G, H, B, B_blinding: table_factory(G, H, B, B_blinding,
                                                  device, msm_layout))
    _device, _layout = device, msm_layout
    return device


def use(device=None) -> torch.device:
    """The device of an entry point: `device` when given (registered now,
    with the layout registered before), else the one registered before,
    else CUDA (which raises where CUDA is missing: the port never falls
    back to the CPU unasked)."""
    if device is not None or _device is None:
        return register("cuda" if device is None else device, _layout)
    return _device
