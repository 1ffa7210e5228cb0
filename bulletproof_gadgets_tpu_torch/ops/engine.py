"""Device engine wiring: installs the device MSM (ops/msm_serial) as the
core backends for one explicit torch device.

`register(device)` sets core.msm's generic backend (MSMs of at least
MIN_DEVICE_MSM points) and its generator-table factory.  Tables are cached
by content, so the prover and the verifier of one circuit size share one
device-resident source.  Nothing registers itself at import.
"""
import torch

from ..core import msm as core_msm
from . import msm_serial

MIN_DEVICE_MSM = 192

_table_cache = {}
_TABLE_CACHE_MAX = 3


def _table_key(G, H, B, B_blinding):
    """Content-derived cache key: endpoint coordinates pin the generator
    vectors (they are deterministic SHAKE256 chains, so (len, first, last)
    identifies the slice)."""
    return (len(G),
            G[0].X if G else 0, G[-1].X if G else 0,
            H[0].X if H else 0, H[-1].X if H else 0,
            B.X, B.Y, B_blinding.X, B_blinding.Y)


def table_factory(G, H, B, B_blinding, device):
    key = _table_key(G, H, B, B_blinding) + (str(device),)
    t = _table_cache.get(key)
    if t is None:
        t = msm_serial.GeneratorTable(G, H, B, B_blinding, device)
        if len(_table_cache) >= _TABLE_CACHE_MAX:
            _table_cache.pop(next(iter(_table_cache)))
        _table_cache[key] = t
    return t


def register(device) -> torch.device:
    """Route core.msm's device work to `device` ('cuda', 'cuda:1', 'cpu').
    CUDA that is asked for and not there raises: no silent CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    core_msm.set_backend(
        lambda ks, points: msm_serial.msm(ks, points, device), MIN_DEVICE_MSM)
    core_msm.set_table_factory(
        lambda G, H, B, B_blinding: table_factory(G, H, B, B_blinding,
                                                  device))
    return device
