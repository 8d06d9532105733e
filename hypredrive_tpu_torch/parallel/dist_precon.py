"""Distributed preconditioner setup: MGR and block-Jacobi ILU on row
shards.

Counterpart of ``hypredrive_tpu/parallel/dist_precon.py``; the host
arithmetic is copied, the levels are uploaded as
:class:`~.dist_matrix.DistEllMatrix` operators on the mesh's device:

* ``setup_mgr_dist`` — dofmap-driven F/C splitting over sharded rows.  The
  split is row-local (each shard classifies its rows from its dofmap
  slice); transfers use the diagonal families (injection / jacobi /
  l1-jacobi / rowsum), whose P/R rows are row-local given the globally
  known diagonal; the Galerkin triple product is accumulated like the AMG
  RAP; the coarsest level is a distributed AMG hierarchy (dist_setup) or
  Jacobi.  F-relaxation uses the full-space masked kinds of
  ``precon/mgr.py::_f_relax``.
* ``build_bj_ilu_dist`` — block-Jacobi ILU(0): each shard factors its own
  diagonal block (the reference's bj-ilu0 is per-rank block Jacobi, ref:
  include/internal/ilu.h types bj-*), and the factors become
  block-diagonal row-sharded operators applied with Jacobi-iterated
  triangular sweeps (``precon/ilu.py::tri_jacobi_apply``) — no halo
  traffic.

Configs outside the distributed-MGR subset warn and fall back, as the JAX
package's do (its behaviour, not a fallback of this port).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import row_partition
from .dist_setup import (_bucket_pad, _diag_of_parts, _fetch_rows,
                         offsets_of, repartition_rows)


def setup_mgr_dist(A_parts: Sequence[sp.csr_matrix], args,
                   dofmap: np.ndarray, mesh, dtype=torch.float64,
                   dof_labels: Optional[dict] = None):
    """Distributed MGR setup → an ``mgr.MGRState`` whose levels hold
    row-sharded operators.  Supported per-level surface: f_dofs by
    int/label, injection/diagonal prolongations+restrictions, masked
    Jacobi / AMG / ILU F-relaxation, Galerkin coarse operator, coarsest =
    distributed AMG or Jacobi."""
    from ..config.sections import AMG_SCHEMA, MGR_LEVEL_SCHEMA
    from ..core.logging import logger
    from ..precon.mgr import MGRLevel, MGRState, _resolve_f_dofs
    from .dist_matrix import DistEllMatrix, pad_vector
    from .dist_setup import setup_hierarchy_dist, supports_dist_setup

    n_sh = mesh.n_shards
    dofmap = np.asarray(dofmap)

    def dist(parts, n_cols):
        return DistEllMatrix.from_parts(parts, mesh, n_cols, dtype=dtype)

    def vec(v, n):
        return pad_vector(v, n, mesh, dtype=dtype)

    # pad the fine level to a multiple of n_shards (identity pad rows get
    # a dof label no f_dofs list selects: -1)
    off_in = offsets_of(A_parts)
    n0 = int(off_in[-1])
    n_pad = -(-n0 // n_sh) * n_sh
    new_off = row_partition(n_pad, n_sh)
    A_parts = repartition_rows(A_parts, off_in, new_off, n_rows_pad=n_pad)
    dofmap_l = np.full(n_pad, -1, dtype=np.int64)
    dofmap_l[:n0] = dofmap
    off = new_off

    raw_levels = dict(args.get("level") or {})
    keys = sorted(int(k) for k in raw_levels) if raw_levels else [0]
    n_levels = int(args.get("num_levels", -1))
    if n_levels > 0:
        keys = keys[:n_levels]
    # distributed-MGR subset (mirrors supports_dist_setup): diagonal
    # families run as masked Jacobi; AMG and ILU F-relax run as full-space
    # embeddings (A_ff ⊕ I); anything else warns and runs masked Jacobi
    _DIST_F_JACOBI = {"none", "single", "jacobi", "l1-jacobi", "v(1,0)"}
    level_cfgs = []
    for key in keys:
        errors: List[str] = []
        parsed = MGR_LEVEL_SCHEMA.parse(raw_levels.get(key) or {},
                                        f"mgr:level:{key}", errors)
        f_rlx = parsed.f_relaxation
        g_rlx = parsed.g_relaxation
        if isinstance(f_rlx, dict) and len(f_rlx) == 1:
            f_name = next(iter(f_rlx))
            f_sub = f_rlx[f_name] or {}
        else:
            f_name = f_rlx if isinstance(f_rlx, str) else "<nested>"
            f_sub = {}
        g_name = g_rlx if isinstance(g_rlx, str) else "<nested>"
        unsupported = []
        if f_name in _DIST_F_JACOBI:
            f_kind = "masked-jacobi"
        elif f_name == "amg":
            f_kind = "masked-amg"
        elif f_name == "ilu":
            f_kind = "masked-ilu"
        else:
            f_kind = "masked-jacobi"
            unsupported.append(f"f_relaxation: {f_name}")
        if g_name != "none":
            unsupported.append(f"g_relaxation: {g_name}")
        if unsupported:
            logger.warn(
                f"mgr:level:{key} {', '.join(unsupported)} outside the "
                "distributed-MGR subset; falling back to masked-Jacobi "
                "F-relax / no G-relax on the mesh (host path honors the "
                "full config)", obj="mgr-dist")
        level_cfgs.append({
            "f_dofs": parsed.f_dofs,
            "prolongation_type": int(parsed.prolongation_type),
            "restriction_type": int(parsed.restriction_type),
            "f_sweeps": max(1, int(parsed.num_sweeps)),
            "f_kind": f_kind,
            "f_sub": f_sub,
        })

    levels = []
    for cfg in level_cfgs:
        n = int(off[-1])
        f_dofs = _resolve_f_dofs(cfg.get("f_dofs", [0]), dof_labels)
        f_mask_np = np.isin(dofmap_l, f_dofs)
        c_mask_np = ~f_mask_np
        nC = int(c_mask_np.sum())
        if nC == 0 or nC == n:
            break
        # global coarse numbering: C points keep global order
        coarse_idx = np.cumsum(c_mask_np) - 1

        diag = _diag_of_parts(A_parts, off)
        p_type = int(cfg.get("prolongation_type", 2))
        r_type = int(cfg.get("restriction_type", 0))

        def scale_vec(kind_code):
            # per-F-row scaling of the transfer weights
            if kind_code == 1:      # l1-jacobi: Σ|A_ff[f,:]|
                l1 = np.zeros(n)
                for s, A_s in enumerate(A_parts):
                    lo = int(off[s])
                    rows = np.repeat(np.arange(A_s.shape[0]),
                                     np.diff(A_s.indptr))
                    m = f_mask_np[rows + lo] & f_mask_np[A_s.indices]
                    np.add.at(l1, rows[m] + lo, np.abs(A_s.data[m]))
                return np.where(l1 != 0, 1.0 / l1, 0.0)
            if kind_code in (13, 14):  # rowsum / absrowsum over A_ff
                rs = np.zeros(n)
                for s, A_s in enumerate(A_parts):
                    lo = int(off[s])
                    rows = np.repeat(np.arange(A_s.shape[0]),
                                     np.diff(A_s.indptr))
                    m = f_mask_np[rows + lo] & f_mask_np[A_s.indices]
                    v = A_s.data[m] if kind_code == 13 \
                        else np.abs(A_s.data[m])
                    np.add.at(rs, rows[m] + lo, v)
                return np.where(rs != 0, 1.0 / rs, 0.0)
            return np.where(diag != 0, 1.0 / diag, 0.0)

        # P rows are row-local: C row c -> e_{coarse(c)}; F row f ->
        # −scale_f · A[f, C] restricted to C columns
        P_parts = []
        dinv_p = scale_vec(p_type)
        for s, A_s in enumerate(A_parts):
            lo, hi = int(off[s]), int(off[s + 1])
            rows = np.repeat(np.arange(A_s.shape[0]), np.diff(A_s.indptr))
            grows = rows + lo
            pr, pc, pv = [], [], []
            if p_type != 0:
                m = f_mask_np[grows] & c_mask_np[A_s.indices]
                pr.append(rows[m])
                pc.append(coarse_idx[A_s.indices[m]])
                pv.append(-dinv_p[grows[m]] * A_s.data[m])
            loc_c = np.flatnonzero(c_mask_np[lo:hi])
            pr.append(loc_c)
            pc.append(coarse_idx[loc_c + lo])
            pv.append(np.ones(len(loc_c)))
            P_s = sp.csr_matrix(
                (np.concatenate(pv),
                 (np.concatenate(pr), np.concatenate(pc))),
                shape=(hi - lo, nC))
            P_s.sort_indices()
            P_parts.append(P_s)

        # R rows live on coarse owners: injection (C rows of I) plus the
        # diagonal family −A[C, F]·D_ff⁻¹ (row-local in A's C rows)
        dinv_r = scale_vec(r_type)
        R_rows = []      # per fine shard: (c_global_row, fine_col, val)
        for s, A_s in enumerate(A_parts):
            lo = int(off[s])
            rows = np.repeat(np.arange(A_s.shape[0]), np.diff(A_s.indptr))
            grows = rows + lo
            rr, rc, rv = [], [], []
            if r_type != 0:
                m = c_mask_np[grows] & f_mask_np[A_s.indices]
                rr.append(coarse_idx[grows[m]])
                rc.append(A_s.indices[m])
                rv.append(-A_s.data[m] * dinv_r[A_s.indices[m]])
            loc_c = np.flatnonzero(c_mask_np[lo:int(off[s + 1])])
            rr.append(coarse_idx[loc_c + lo])
            rc.append(loc_c + lo)
            rv.append(np.ones(len(loc_c)))
            R_rows.append((np.concatenate(rr), np.concatenate(rc),
                           np.concatenate(rv)))

        npad_c = _bucket_pad(nC, n_sh)
        c_off = row_partition(npad_c, n_sh)
        # assemble R parts by coarse owner
        R_parts = []
        for t in range(n_sh):
            c0, c1 = int(c_off[t]), int(c_off[t + 1])
            br, bc, bv = [], [], []
            for rr, rc, rv in R_rows:
                m = (rr >= c0) & (rr < c1)
                br.append(rr[m] - c0)
                bc.append(rc[m])
                bv.append(rv[m])
            R_t = sp.csr_matrix(
                (np.concatenate(bv),
                 (np.concatenate(br), np.concatenate(bc))),
                shape=(c1 - c0, n))
            R_t.sort_indices()
            R_parts.append(R_t)

        # coarse operator: Galerkin R·A·P with boundary accumulation
        X_parts = []     # per fine shard: A_s @ P  (n_s × nC)
        for s, A_s in enumerate(A_parts):
            need = np.unique(A_s.indices.astype(np.int64))
            P_need = _fetch_rows(P_parts, off, need)
            indptr = np.zeros(n + 1, np.int64)
            cnt = np.zeros(n, np.int64)
            cnt[need] = np.diff(P_need.indptr)
            np.cumsum(cnt, out=indptr[1:])
            P_glob = sp.csr_matrix(
                (P_need.data, P_need.indices, indptr), shape=(n, nC))
            X_parts.append(sp.csr_matrix(A_s @ P_glob))
        Ac_parts = []
        for t in range(n_sh):
            c0, c1 = int(c_off[t]), int(c_off[t + 1])
            R_t = R_parts[t]
            need = np.unique(R_t.indices.astype(np.int64))
            X_need = _fetch_rows(X_parts, off, need)
            indptr = np.zeros(n + 1, np.int64)
            cnt = np.zeros(n, np.int64)
            cnt[need] = np.diff(X_need.indptr)
            np.cumsum(cnt, out=indptr[1:])
            X_glob = sp.csr_matrix(
                (X_need.data, X_need.indices, indptr), shape=(n, nC))
            Ac_t = sp.csr_matrix(R_t @ X_glob)
            Ac_t.resize((Ac_t.shape[0], npad_c))
            # identity pad rows for the bucket range
            if c1 > nC:
                ext_lo = max(c0, nC)
                rows = np.arange(ext_lo - c0, c1 - c0)
                Ac_t = sp.csr_matrix(Ac_t + sp.coo_matrix(
                    (np.ones(c1 - ext_lo),
                     (rows, np.arange(ext_lo, c1))),
                    shape=(c1 - c0, npad_c)))
            Ac_t.sort_indices()
            Ac_parts.append(Ac_t)
        # pad P columns to the bucket
        P_padded = []
        for P_s in P_parts:
            P_s = P_s.copy()
            P_s.resize((P_s.shape[0], npad_c))
            P_padded.append(sp.csr_matrix(P_s))

        # F-relaxation state
        f_kind = cfg.get("f_kind", "masked-jacobi")
        if f_kind in ("masked-amg", "masked-ilu"):
            # full-space embedding Ã = A_ff ⊕ I: F rows keep their F-F
            # entries, C rows (and pad rows) become identity — the
            # component then applies with zero gather/scatter
            Aff_parts = []
            for s, A_s in enumerate(A_parts):
                lo = int(off[s])
                rows = np.repeat(np.arange(A_s.shape[0]),
                                 np.diff(A_s.indptr))
                keep = f_mask_np[rows + lo] & f_mask_np[A_s.indices]
                blk = sp.csr_matrix(
                    (A_s.data[keep], (rows[keep], A_s.indices[keep])),
                    shape=A_s.shape)
                loc_c = np.flatnonzero(~f_mask_np[lo:int(off[s + 1])])
                blk = sp.csr_matrix(blk + sp.coo_matrix(
                    (np.ones(len(loc_c)), (loc_c, loc_c + lo)),
                    shape=A_s.shape))
                blk.sort_indices()
                Aff_parts.append(blk)
            fmask_dev = vec(f_mask_np.astype(np.float64), n)
            if f_kind == "masked-amg":
                perrs: List[str] = []
                f_args = AMG_SCHEMA.parse(dict(cfg.get("f_sub") or {}),
                                          "mgr:f_relax:amg", perrs)
                if perrs:
                    from ..core.errors import ErrorCode, HypredrvError

                    raise HypredrvError("; ".join(perrs),
                                        ErrorCode.INVALID_VAL)
                if not supports_dist_setup(f_args):
                    logger.warn(
                        "mgr f_relaxation:amg sub-config outside the "
                        "distributed-setup subset; falling back to the "
                        "default AMG options for the F-space hierarchy",
                        obj="mgr-dist")
                    f_args = AMG_SCHEMA.defaults()
                sub_state = setup_hierarchy_dist(Aff_parts, f_args, mesh,
                                                 dtype=dtype)
            else:
                sub_state = build_bj_ilu_dist(Aff_parts, mesh, dtype=dtype)
            f_state = (fmask_dev, sub_state)
        else:
            # masked-Jacobi F-relax (exact full-space formulation)
            dinv = np.where(diag != 0, 1.0 / diag, 0.0)
            f_state = (vec(f_mask_np * dinv, n),)
            f_kind = "masked-jacobi"
        no_idx = torch.zeros(1, dtype=torch.int64, device=mesh.device)
        levels.append(MGRLevel(
            A=dist(A_parts, n), f_idx=no_idx, c_idx=no_idx,
            P=dist(P_padded, npad_c), R=dist(R_parts, n),
            f_state=f_state, g_state=None, f_kind=f_kind, g_kind="none",
            f_sweeps=max(1, int(cfg.get("f_sweeps", 1))),
            pre=True, post=False,
        ))
        # next level state
        A_parts = Ac_parts
        off = c_off
        new_dof = np.full(npad_c, -1, dtype=np.int64)
        new_dof[coarse_idx[c_mask_np]] = dofmap_l[c_mask_np]
        dofmap_l = new_dof

    # coarsest: distributed AMG on the remaining operator; any other kind
    # is Jacobi (D⁻¹, one sweep) on the mesh, as in the JAX package
    cls_cfg = args.get("coarsest_level", "def")
    kind = (cls_cfg.get("type", "amg")
            if isinstance(cls_cfg, dict) else str(cls_cfg)) or "amg"
    if kind in ("amg", "def"):
        coarsest_state = setup_hierarchy_dist(A_parts, AMG_SCHEMA.defaults(),
                                              mesh, dtype=dtype)
        coarsest_kind = "amg"
    else:
        diag = _diag_of_parts(A_parts, off)
        dinv = np.where(diag != 0, 1.0 / diag, 0.0)
        coarsest_state = (vec(dinv, int(off[-1])), 1, None)
        coarsest_kind = "jacobi"

    return MGRState(
        levels=tuple(levels),
        coarsest_state=coarsest_state,
        coarsest_kind=coarsest_kind,
        cycle_type=1,
        max_iter=max(1, int(args.get("max_iter", 1))),
    )


def build_bj_ilu_dist(A_parts: Sequence[sp.csr_matrix], mesh,
                      dtype=torch.float64, l_iters: int = 5,
                      u_iters: int = 5):
    """Block-Jacobi ILU(0) over row shards: factor each shard's own
    diagonal block with the compiled ILU(0), apply z = U⁻¹L⁻¹r with
    Jacobi-iterated triangular sweeps.  Returns a ``TriJacobiState`` whose
    L and U are block-diagonal DistEllMatrix operators."""
    from ..precon.ilu import TriJacobiState, ilu0_factor
    from .dist_matrix import DistEllMatrix, pad_vector

    n_sh = mesh.n_shards
    off_in = offsets_of(A_parts)
    n0 = int(off_in[-1])
    n_pad = -(-n0 // n_sh) * n_sh
    new_off = row_partition(n_pad, n_sh)
    A_parts = repartition_rows(A_parts, off_in, new_off, n_rows_pad=n_pad)

    L_parts, U_parts = [], []
    u_diag = np.zeros(n_pad)
    for s, A_s in enumerate(A_parts):
        lo, hi = int(new_off[s]), int(new_off[s + 1])
        blk = sp.csr_matrix(A_s[:, lo:hi])       # own diagonal block
        L_s, U_s = ilu0_factor(blk)
        u_diag[lo:hi] = U_s.diagonal()
        # strict lower part, global columns
        Ls = sp.csr_matrix(sp.tril(L_s, -1))
        Ls = sp.csr_matrix(
            (Ls.data, Ls.indices + lo, Ls.indptr), shape=(hi - lo, n_pad))
        Us = sp.csr_matrix(
            (U_s.data, U_s.indices + lo, U_s.indptr), shape=(hi - lo, n_pad))
        L_parts.append(Ls)
        U_parts.append(Us)

    return TriJacobiState(
        L=DistEllMatrix.from_parts(L_parts, mesh, n_pad, dtype=dtype),
        U=DistEllMatrix.from_parts(U_parts, mesh, n_pad, dtype=dtype),
        u_dinv=pad_vector(np.where(u_diag != 0, 1.0 / u_diag, 1.0), n_pad,
                          mesh, dtype=dtype),
        l_iters=int(l_iters), u_iters=int(u_iters))
