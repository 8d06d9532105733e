"""Row-sharded sparse matrix with a halo exchange.

Counterpart of ``hypredrive_tpu/parallel/dist_matrix.py``.  Rows are
block-partitioned over the mesh's shards (the reference's ParCSR
decomposition); each shard holds a local device matrix whose columns
address its extended local vector ``[x_local | halos]``, filled by the
static schedule of :mod:`.halo`.  Each rank keeps only its own shards, on
its own device (``mesh.py``).  The JAX package's ``shard_map`` body is
written here with a leading axis over the rank's k shards:

1. ``xs = x.reshape(k, m)`` (x is the rank's block of the global vector);
2. for each halo distance d, ``buf = gather(xs, 1, send_idx[d])``: shard
   i's buffer goes to shard (i + d) mod n, as ``ppermute`` sends it.  On
   one rank that is ``roll(buf, d, 0)``; across ranks the rows whose
   target lies on another rank go by one ``all_to_all_single`` and each
   shard picks its row from ``[buf | received]``
   (:func:`.halo.rank_exchange`);
3. ``x_ext = cat([xs, recv…], 1)``;
4. ``y_s = E_s.matvec(x_ext[s])`` for every local shard: the DIA kernel,
   then the CSR kernel (``ops/device_matrix.py``), two launches a shard.

Shard structure: each shard keeps the diagonals its own census picks
(``ops/device_matrix.py::_select_diagonals``); their union is
``dia_offsets`` and equals the JAX package's.  The JAX package pins every
shard to that union so that one ``shard_map`` program serves them all;
here each shard is its own launch, so nothing needs the pin, and on small
coarse levels the union exceeds the DIA kernel's 48 diagonals (73 on the
third level of a 12³ Laplacian over 8 shards).  A shard's halo columns lie
past ``local_max`` and land in its CSR remainder unless they form
diagonals.  Unlike a single-device ``EllMatrix``, a shard is never stored
dense, even below ``DENSE_MAX_ELEMENTS``: every shard of every level runs
on the hand-written kernels, as the JAX package's shards run its sparse
path.

Vectors are plain tensors: the rank's rows of the global vector padded to
``shape`` (identity pad rows for square operators), so the same Krylov
code runs on one device and on the mesh.  Every rank runs the same host
setup and builds the same halo plan; no message is sent before a matvec.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..core.trace import count, span
from ..ops import epilogue
from ..ops.csr import row_partition
from ..ops.device_matrix import EllMatrix, _select_diagonals
from .halo import RankExchange, build_halo_plan, rank_exchange
from .mesh import Mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class DistEllMatrix:
    """Row-sharded sparse matrix (square or rectangular).

    shards:    one ``EllMatrix`` (rows_max × ext_size) per shard of this
               rank
    send_idx:  per halo distance, (k, S_d) int64 local indices of the
               values each of this rank's k shards sends (padded with 0)
    send_plan: the same for every shard of the mesh, (n_shards, S_d)
               host arrays: the static schedule every rank holds
    exchange:  per halo distance, None on one rank, else its cross-rank
               part (:class:`.halo.RankExchange`, rows on the device)
    """

    shards: Tuple[EllMatrix, ...]
    send_idx: Tuple[torch.Tensor, ...]
    mesh: Mesh
    dia_offsets: Tuple[int, ...]     # union of the shards' DIA offsets
    offsets: Tuple[int, ...]         # halo shard distances
    shape: Tuple[int, int]           # padded global shape
    orig_shape: Tuple[int, int]      # before padding
    nnz: int
    local_max: int                   # padded col-shard size (x_ext locals)
    ext_size: int
    send_plan: Tuple[np.ndarray, ...]
    exchange: Tuple[Optional[RankExchange], ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    # ------------------------------------------------------------------
    # construction (host)
    # ------------------------------------------------------------------

    @classmethod
    def from_csr(cls, A, mesh: Mesh,
                 dtype: torch.dtype = torch.float64) -> "DistEllMatrix":
        """Partition a host CSR matrix over the mesh's shards.

        Square matrices are padded with identity rows/cols to a multiple
        of n_shards (padded entries stay exactly zero through solves);
        rectangular operators (P/R) pad rows and columns independently.
        The span ``operator_build`` times it.
        """
        with span("operator_build"):
            A = sp.csr_matrix(A)
            n_shards = mesh.n_shards
            n_rows, n_cols = A.shape
            rows_pad = _round_up(n_rows, n_shards)
            cols_pad = _round_up(n_cols, n_shards)
            square = n_rows == n_cols

            if rows_pad != n_rows or cols_pad != n_cols:
                A = A.copy()
                A.resize((rows_pad, cols_pad))
                if square:
                    extra = np.arange(n_rows, rows_pad)
                    A = (A + sp.coo_matrix(
                        (np.ones(len(extra)), (extra, extra)),
                        shape=(rows_pad, cols_pad))).tocsr()
            A.sort_indices()

            row_off = row_partition(rows_pad, n_shards)
            col_off = row_partition(cols_pad, n_shards)

            subs = []
            for s in range(n_shards):
                lo, hi = int(row_off[s]), int(row_off[s + 1])
                sub = sp.csr_matrix(A[lo:hi])
                sub.sort_indices()
                subs.append(sub)
            return cls._from_local_blocks(
                subs, mesh, col_off, (rows_pad, cols_pad), (n_rows, n_cols),
                int(A.nnz), dtype)

    @classmethod
    def from_parts(cls, parts, mesh: Mesh, n_cols: int,
                   dtype: torch.dtype = torch.float64) -> "DistEllMatrix":
        """Build directly from per-shard row blocks (global columns) — the
        distributed-setup path: the global matrix is never assembled.  All
        parts must have equal row counts and the global row/col sizes must
        be multiples of n_shards (the dist setup's bucket padding
        guarantees this)."""
        n_shards = mesh.n_shards
        if len(parts) != n_shards:
            raise ValueError(f"need {n_shards} parts, got {len(parts)}")
        rows_each = parts[0].shape[0]
        if any(p.shape[0] != rows_each for p in parts):
            raise ValueError("parts must have equal row counts")
        rows_pad = rows_each * n_shards
        if n_cols % n_shards:
            raise ValueError("global column count must divide n_shards")
        col_off = row_partition(n_cols, n_shards)
        subs = []
        for p in parts:
            sub = sp.csr_matrix(p)
            if sub.shape[1] != n_cols:
                sub = sub.copy()
                sub.resize((sub.shape[0], n_cols))
            sub.sort_indices()
            subs.append(sub)
        nnz = int(sum(p.nnz for p in subs))
        return cls._from_local_blocks(
            subs, mesh, col_off, (rows_pad, n_cols), (rows_pad, n_cols),
            nnz, dtype)

    @classmethod
    def _from_local_blocks(cls, subs, mesh, col_off, pad_shape,
                           orig_shape, nnz, dtype) -> "DistEllMatrix":
        n_shards = mesh.n_shards
        rows_pad, _ = pad_shape
        rows_max = rows_pad // n_shards

        # per-shard needed columns → halo plan
        needed = [np.unique(sub.indices) for sub in subs]
        plan, recv_pos = build_halo_plan(n_shards, col_off, needed)

        # remap each shard's columns into x_ext positions
        locals_remapped = []
        for s in range(n_shards):
            sub = subs[s]
            g = sub.indices.astype(np.int64)
            local = (g >= col_off[s]) & (g < col_off[s + 1])
            mapped = np.empty(len(g), dtype=np.int64)
            mapped[local] = g[local] - col_off[s]
            if (~local).any():
                rp = recv_pos[s]
                mapped[~local] = np.array(
                    [rp[int(c)] for c in g[~local]], dtype=np.int64)
            # copy data/indptr: loc.sort_indices() below permutes data in
            # place, and sharing it would silently corrupt the caller's
            # part matrices (the from_parts path passes caller-owned CSR
            # blocks)
            loc = sp.csr_matrix(
                (sub.data.copy(), mapped, sub.indptr.copy()),
                shape=(rows_max, plan.ext_size))
            loc.sort_indices()
            locals_remapped.append(loc)
        return cls.from_local(locals_remapped, plan.send_idx, plan.offsets,
                              mesh, pad_shape, orig_shape, nnz,
                              plan.local_max, dtype)

    @classmethod
    def from_local(cls, locals_ext: Sequence[sp.csr_matrix], send_idx,
                   offsets: Tuple[int, ...], mesh: Mesh, shape, orig_shape,
                   nnz: int, local_max: int, dtype: torch.dtype
                   ) -> "DistEllMatrix":
        """From every shard's local block in x_ext columns (canonical CSR,
        rows_max × ext_size) and the halo schedule (per distance an
        (n_shards, S_d) index array); each shard keeps the diagonals of
        its own census, their union is ``dia_offsets``.  Only this rank's
        shards go to its device."""
        splits = [_select_diagonals(loc, None) for loc in locals_ext]
        mine = mesh.shard_range
        shards = tuple(EllMatrix.from_split(
            locals_ext[s].shape, int(locals_ext[s].nnz), splits[s], dtype,
            mesh.device) for s in mine)
        union = tuple(sorted(set().union(*(set(sp_[0]) for sp_ in splits))))
        plan = tuple(np.asarray(i, dtype=np.int64) for i in send_idx)
        local_idx = tuple(torch.as_tensor(p[mine.start:mine.stop],
                                          device=mesh.device) for p in plan)
        exchange = tuple(_exchange_of(mesh, d) for d in offsets)
        return cls(shards=shards, send_idx=local_idx, mesh=mesh,
                   dia_offsets=union, offsets=tuple(offsets),
                   shape=tuple(shape), orig_shape=tuple(orig_shape),
                   nnz=int(nnz), local_max=int(local_max),
                   ext_size=int(locals_ext[0].shape[1]), send_plan=plan,
                   exchange=exchange)

    # ------------------------------------------------------------------
    # device
    # ------------------------------------------------------------------

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """The halo exchange: (k, ext_size) x_ext of this rank's k shards
        from its block x of the global vector."""
        # the column partition is even (n_shards divides shape[1]), so
        # every shard's locals fill local_max exactly
        xs = x.reshape(len(self.shards), self.local_max)
        parts = [xs]
        for d, idx, ex in zip(self.offsets, self.send_idx, self.exchange):
            buf = torch.gather(xs, 1, idx)
            if ex is None:
                # ppermute i → (i + d) mod n
                parts.append(torch.roll(buf, d, 0))
            else:
                parts.append(self._cross(buf, ex))
        return torch.cat(parts, 1) if len(parts) > 1 else xs

    def _cross(self, buf: torch.Tensor, ex: RankExchange) -> torch.Tensor:
        """One distance's shift across ranks: the rows bound for other
        ranks go by one ``all_to_all_single``; each shard then takes its
        row of ``[buf | received]``."""
        import torch.distributed as dist

        send = buf.index_select(0, ex.send_rows)
        recv = buf.new_empty((sum(ex.recv_split), buf.shape[1]))
        dist.all_to_all_single(recv, send, list(ex.recv_split),
                               list(ex.send_split), group=self.mesh.group)
        # what this rank sends to others; a captured body adds it on
        # every replay (device_loop)
        count("halo_bytes", send.numel() * send.element_size())
        count("halo_msgs", sum(1 for k in ex.send_split if k))
        return torch.cat([buf, recv]).index_select(0, ex.recv_src)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for this rank's block x of a global x of length
        shape[1]; y is this rank's block of the result."""
        x_ext = self.extend(x)
        return torch.cat([E.matvec(x_ext[s])
                          for s, E in enumerate(self.shards)])

    # the cycles' steps (ops/epilogue.py): the torch chains around matvec,
    # uncounted; no kernel epilogue spans the halo exchange
    residual = epilogue.residual_plain
    cheby_step = epilogue.cheby_step_plain
    jacobi_step = epilogue.jacobi_step_plain
    matvec_add = epilogue.matvec_add_plain

    def diagonal(self) -> torch.Tensor:
        """This rank's block of diag(A) of a square matrix (shard s's row r
        has its diagonal entry at x_ext position r)."""
        return torch.cat([E.diagonal() for E in self.shards])

    def row_l1_norms(self) -> torch.Tensor:
        return torch.cat([E.row_l1_norms() for E in self.shards])

    def ext_columns(self) -> List[np.ndarray]:
        """Per shard of this rank, the global column of every x_ext
        position (pad slots of a send buffer map to the sender's first
        column)."""
        n_sh, m = self.n_shards, self.local_max
        out = []
        for s in self.mesh.shard_range:
            cols = [np.arange(s * m, (s + 1) * m)]
            for d, idx in zip(self.offsets, self.send_plan):
                src = (s - d) % n_sh
                cols.append(src * m + idx[src])
            out.append(np.concatenate(cols))
        return out

    def to_csr(self) -> sp.csr_matrix:
        """Host copy of this rank's rows of the padded global matrix, in
        global columns (the whole matrix on one rank; parity tests)."""
        blocks = []
        for E, cols in zip(self.shards, self.ext_columns()):
            loc = E.to_csr().tocoo()
            blocks.append(sp.csr_matrix(
                (loc.data, (loc.row, cols[loc.col])),
                shape=(loc.shape[0], self.shape[1])))
        A = sp.csr_matrix(sp.vstack(blocks))
        A.sort_indices()
        return A


def _exchange_of(mesh: Mesh, d: int) -> Optional[RankExchange]:
    """The cross-rank part of the shift by d on this rank, its rows on the
    device (None on one rank, where the shift is a roll)."""
    if mesh.world == 1:
        return None
    ex = rank_exchange(mesh.n_shards, mesh.world, mesh.rank, d)
    return replace(ex, send_rows=torch.as_tensor(ex.send_rows,
                                                 device=mesh.device),
                   recv_src=torch.as_tensor(ex.recv_src, device=mesh.device))


def pad_vector(v, n_pad: int, mesh: Mesh,
               dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Host vector → this rank's block of the zero-padded global vector,
    on the mesh's device."""
    out = np.zeros(n_pad, dtype=np.float64)
    out[:len(v)] = np.asarray(v)
    return torch.as_tensor(mesh.local(out), dtype=dtype, device=mesh.device)


def mesh_ops(mesh: Optional[Mesh], dtype: torch.dtype, device):
    """(op, vec) uploads of host operators and per-row vectors: without a
    mesh an ``EllMatrix`` and a tensor on ``device``; with one a
    ``DistEllMatrix`` and this rank's block of a vector padded with 1.0 to
    a multiple of the shard count (the per-row scalings of identity pad
    rows)."""
    if mesh is None:
        def op(M):
            return EllMatrix.from_csr(sp.csr_matrix(M), dtype=dtype,
                                      device=device)

        def vec(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return op, vec

    def op(M):
        return DistEllMatrix.from_csr(sp.csr_matrix(M), mesh, dtype=dtype)

    def vec(v):
        padded = np.ones(_round_up(len(v), mesh.n_shards))
        padded[:len(v)] = v
        return torch.as_tensor(mesh.local(padded), dtype=dtype,
                               device=mesh.device)
    return op, vec
