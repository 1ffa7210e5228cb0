"""Multi-rank serial-bucket MSM: the port of the JAX package's
parallel/sharded_serial.py.

The generator table [G | H | B | B_blinding] is partitioned by point
across the mesh's "shard" axis.  Rank d of D holds G and H rows
lo_d .. lo_{d+1} - 1 with lo_d = d*N // D, and the last rank also B and
B_blinding; its source is msm_serial.prep_source of its own points, with
its own identity row.  (The JAX package cuts the table into contiguous
slices of m/D points, whose IPA halves then need a resharding concatenate;
here an IPA round's rows and the table rows they weight sit on the same
rank, parallel/sharded_ipa.)

Each rank runs the single-device pipeline on its points up to the window
sums (msm_serial.window_sums_t: schedule, K1 (K2 past the slot budget),
K3, K4, and K7 over its own point chunks); the [4, NL, k*W] window sums,
a few KB whatever the table size, are all-gathered, added in rank order by
one K7 launch (msm_serial.point_sum on [D, 4, NL, k*W]; the JAX package's
_combine_ws tree of padd_cols), and K5 runs Horner on every rank, so every
rank holds the same points.  Window sums over disjoint point subsets add
exactly (the group law), so the points, and the proofs, are those of one
device.  Uneven N / D gives uneven slices; only the window sums must have
one shape on every rank.

The pool excess (msm_serial.msm_digits_t's) is all-reduced with max and
read with the points: a positive excess on any rank raises on every rank.
Not ported: the JAX package's re-run with the safe plan (the port's plan is
the safe bound), its host-scheduled route and BPG_TPU_SHARD_SCHED.
"""
import numpy as np
import torch

from . import mesh as mesh_mod
from ..core.scalar import L
from ..ops import msm_serial, ristretto_device
from ..ops.msm import signed_digits


class ShardedGeneratorTable:
    """msm_serial.GeneratorTable over a mesh's "shard" axis: the same
    interface (`supports_digits`, `N`, `m`, `layout`, `msm_digits`,
    `msm_digits_enc_launch` / `_finish`, `msm_many`), with `src` this
    rank's source rows, `cols` the table columns they hold (int64, on the
    mesh's device; `cols_host` on the host) and `mesh`."""

    supports_digits = True

    def __init__(self, G, H, B, B_blinding, mesh, layout: str = "rows"):
        assert len(H) == len(G)
        pts = list(G) + list(H) + [B, B_blinding]
        self._place(len(G), mesh, layout)
        self.src = torch.from_numpy(msm_serial.prep_source(
            [pts[c] for c in self.cols_host])).to(mesh.device)

    @classmethod
    def from_rows(cls, rows: np.ndarray, mesh,
                  device=None) -> "ShardedGeneratorTable":
        """This rank's shard of the whole table's source rows made
        elsewhere ([2m+1, ROW], msm_serial.prep_source's layout), on
        `device` (default: the mesh's), in the rows layout (as
        GeneratorTable.from_rows)."""
        m = (rows.shape[0] - 1) // 2
        t = cls.__new__(cls)
        t._place((m - 2) // 2, mesh, "rows")
        c = t.cols_host
        t.src = torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [rows[c], rows[m + c], rows[2 * m:]]))).to(
                device if device is not None else mesh.device)
        return t

    def _place(self, n: int, mesh, layout):
        msm_serial.check_layout(layout)
        d, rank = mesh.shape["shard"], mesh.index["shard"]
        if n < d:
            raise ValueError(f"{n} generators over {d} ranks: each rank "
                             "needs one")
        self.N, self.m, self.mesh, self.layout = n, 2 * n + 2, mesh, layout
        lo, hi = rank * n // d, (rank + 1) * n // d
        cols = [np.arange(lo, hi), np.arange(n + lo, n + hi)]
        if rank == d - 1:
            cols.append(np.array([2 * n, 2 * n + 1]))
        self.cols_host = np.concatenate(cols)
        self.cols = torch.from_numpy(self.cols_host).to(mesh.device)

    # -- this rank's columns -------------------------------------------------
    def local(self, digits_t):
        """Digits int8 [k*W, m] of the whole table (the same on every rank)
        -> this rank's columns, [k*W, len(cols)]."""
        if digits_t.dim() != 2 or digits_t.shape[1] != self.m:
            raise ValueError(f"digits {tuple(digits_t.shape)}: expected "
                             f"[k*W, {self.m}]")
        return digits_t.index_select(1, self.cols.to(digits_t.device))

    def msm_local(self, digits_local, live_cols=None):
        """This rank's digits int8 [k*W, len(cols)] (live_cols: host ints
        over the same columns, as msm_serial.msm_digits_t) -> (int32
        [4, NL, k] points, the same on every rank, excess: the most lanes by
        which any rank's pool passed its bound)."""
        k = digits_local.shape[0] // msm_serial.W
        ws, excess = msm_serial.window_sums_t(
            digits_local, self.src, len(self.cols_host), layout=self.layout,
            live_cols=live_cols)
        total = msm_serial.point_sum(mesh_mod.all_gather(self.mesh, ws))
        return (msm_serial.horner(total, k),
                mesh_mod.all_reduce(self.mesh, excess, "max"))

    def msm_local_enc(self, digits_local, live_cols=None):
        """msm_local's points compressed on the device: (uint8 [k, 32]
        encodings, excess), finished by msm_digits_enc_finish."""
        cols, excess = self.msm_local(digits_local, live_cols)
        return ristretto_device.ristretto_compress(cols), excess

    # -- GeneratorTable's interface ------------------------------------------
    def msm_digits(self, digits_t):
        """Device digits int8 [k*W, m] of the whole table -> k host points
        (one readback, the pool check with it)."""
        return msm_serial.points_from_cols(*self.msm_local(self.local(
            digits_t)))

    def msm_digits_enc_launch(self, digits_t):
        """Device digits int8 [k*W, m] -> their MSM's encodings, uint8
        [k, 32] on the device, with its pool excess (finish with
        msm_digits_enc_finish)."""
        return self.msm_local_enc(self.local(digits_t))

    msm_digits_enc_finish = staticmethod(
        msm_serial.GeneratorTable.msm_digits_enc_finish)

    def msm_many(self, vectors):
        """vectors: k lists of m ints (any residue mod L) -> k points."""
        for v in vectors:
            if len(v) != self.m:
                raise ValueError(f"vector of {len(v)} scalars, table of "
                                 f"{self.m} points")
        digits = np.concatenate([signed_digits([x % L for x in vec],
                                               msm_serial.C)
                                 for vec in vectors], axis=1)   # [m, k*W]
        return self.msm_digits(torch.from_numpy(np.ascontiguousarray(
            digits.T, dtype=np.int8)).to(self.src.device))
