"""MGR — multigrid reduction for multiphysics block systems.

Counterpart of ``hypredrive_tpu/precon/mgr.py`` (ref: src/internal/mgr.c)
for one device.  Setup runs on the host with the JAX package's arithmetic
(copied): per-level ``f_dofs`` (int labels or ``dof_labels`` names) pick
the F rows to eliminate; the A_ff/A_fc/A_cf/A_cc blocks give the
prolongation (injection / (ℓ1-)Jacobi / blk-Jacobi / rowsum) and the
restriction (injection / Jacobi / column-lumped / blk-Jacobi / AIR); the
coarse operator is the Galerkin RAP or the diagonal Schur reduction; the
F-relaxation, global relaxation and coarsest solver are components
(``components.py``), with the per-component reuse keep flags.

Apply runs on the device: every level's A, P and R is an
:class:`~hypredrive_tpu_torch.ops.device_matrix.EllMatrix` (the DIA and CSR
kernels), the F-point gather/scatter is ``index_select``/``index_add`` with
int64 F indices on the device.  ``record_function`` spans
``mgr_L{l}_pre/post`` group device time per level in a profile.

The distributed F-relaxations of the JAX package (``masked-*`` kinds,
built only by its mesh setup) are not part of this single-device port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import record_function

from ..core.errors import ErrorCode, HypredrvError
from ..core.logging import log
from ..ops.device_matrix import EllMatrix
from .base import Preconditioner, precon_matrix
from .components import apply_component, build_component


@dataclass
class MGRLevel:
    A: EllMatrix                 # full operator at this level
    f_idx: torch.Tensor          # F row indices (int64, device)
    c_idx: torch.Tensor          # C row indices (int64, device)
    P: EllMatrix                 # (n, nc)
    R: EllMatrix                 # (nc, n)
    f_state: object              # F-relaxation component state
    g_state: object              # global relaxation component state
    f_kind: str = "jacobi"
    g_kind: str = "none"
    f_sweeps: int = 1
    pre: bool = True             # relax before the coarse correction
    post: bool = False           # relax after it (cycle_smooth_pos)


@dataclass
class MGRState:
    levels: Tuple[MGRLevel, ...]
    coarsest_state: object
    coarsest_kind: str = "amg"
    cycle_type: int = 1          # 1 = V, 2 = W
    max_iter: int = 1


# ---------------------------------------------------------------------------
# apply (device)
# ---------------------------------------------------------------------------

def _f_relax(level: MGRLevel, x, b):
    """x_F += B_ff (b − A x)_F, f_sweeps times."""
    for _ in range(level.f_sweeps):
        r = b - level.A.matvec(x)
        ef = apply_component(level.f_kind, level.f_state,
                             r.index_select(0, level.f_idx))
        x = x.index_add(0, level.f_idx, ef)
    return x


def _g_relax(level: MGRLevel, x, b):
    r = b - level.A.matvec(x)
    return x + apply_component(level.g_kind, level.g_state, r)


def _mgr_cycle(state: MGRState, lvl: int, b):
    levels = state.levels
    if lvl == len(levels):
        return apply_component(state.coarsest_kind, state.coarsest_state, b)
    level = levels[lvl]
    x = torch.zeros_like(b)

    # (pre, post) relaxation pattern applies to BOTH F-relax and global
    # smoothing (ref: HYPRE_MGRSetFRelaxCycle + SetGlobalSmoothCycle with
    # the same cycle_smooth_pos, mgr.c:3793-3795)
    with record_function(f"mgr_L{lvl}_pre"):
        if level.pre:
            if level.g_kind != "none":
                x = _g_relax(level, x, b)
            if level.f_kind != "none":
                x = _f_relax(level, x, b)
        r = b - level.A.matvec(x)
        rc = level.R.matvec(r)
    ec = _mgr_cycle(state, lvl + 1, rc)
    if state.cycle_type == 2 and lvl + 1 < len(levels):
        # W-cycle second visit
        rc2 = rc - levels[lvl + 1].A.matvec(ec)
        ec = ec + _mgr_cycle(state, lvl + 1, rc2)
    with record_function(f"mgr_L{lvl}_post"):
        x = x + level.P.matvec(ec)
        if level.post:
            if level.f_kind != "none":
                x = _f_relax(level, x, b)
            if level.g_kind != "none":
                x = _g_relax(level, x, b)
    return x


def mgr_apply(state: MGRState, r):
    z = _mgr_cycle(state, 0, r)
    for _ in range(state.max_iter - 1):
        resid = r - state.levels[0].A.matvec(z)
        z = z + _mgr_cycle(state, 0, resid)
    return z


# ---------------------------------------------------------------------------
# setup (host)
# ---------------------------------------------------------------------------

def _resolve_f_dofs(f_dofs, dof_labels: dict) -> List[int]:
    """f_dofs ints or symbolic names (ref: mgr.c:420-505 + dof_labels map,
    containers.h:120-139)."""
    out = []
    for v in (f_dofs if isinstance(f_dofs, (list, tuple)) else [f_dofs]):
        if isinstance(v, str) and not v.lstrip("-").isdigit():
            key = v.strip().lower()
            labels = {str(k).lower(): int(val)
                      for k, val in (dof_labels or {}).items()}
            if key not in labels:
                raise HypredrvError(f"unknown dof label '{v}'",
                                    ErrorCode.INVALID_VAL)
            out.append(labels[key])
        else:
            out.append(int(v))
    return out


def _block_diag_inv(A_ff: sp.csr_matrix, bsize: int) -> sp.spmatrix:
    """Block-diagonal inverse of A_ff with bsize×bsize blocks along the
    diagonal (ref: hypre MGR block-Jacobi transfers; assumes the
    interleaved dof ordering the reference assumes, so a cell's F dofs
    are consecutive in the F submatrix)."""
    nF = A_ff.shape[0]
    if bsize <= 1 or nF % bsize != 0:
        diag_ff = A_ff.diagonal()
        return sp.diags(np.where(diag_ff != 0, 1.0 / diag_ff, 0.0))
    from .amg.air import _csr_fetch

    nb = nF // bsize
    base = np.arange(nb)[:, None, None] * bsize
    r = base + np.arange(bsize)[None, :, None]
    c = base + np.arange(bsize)[None, None, :]
    blocks = _csr_fetch(A_ff, np.broadcast_to(r, (nb, bsize, bsize)),
                        np.broadcast_to(c, (nb, bsize, bsize)))
    try:
        inv = np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(blocks)
    inv = np.where(np.isfinite(inv), inv, 0.0)
    return sp.bsr_matrix((inv, np.arange(nb), np.arange(nb + 1)),
                         shape=(nF, nF)).tocsr()


def _build_transfers(A_ff, A_fc, A_cf, A_cc, p_type: int, r_type: int,
                     nF: int, nC: int, bsize: int = 1):
    """W_p: (nF, nC) prolongation weights; W_r: (nC, nF) restriction.

    AIR restrictions (r_type 4/5) are handled by the caller on the full
    operator (they need the global stencil); everything else is local to
    the blocks."""
    diag_ff = A_ff.diagonal()
    dinv = np.where(diag_ff != 0, 1.0 / diag_ff, 0.0)

    # prolongation (ref vocab: injection=0 l1-jacobi=1 jacobi=2
    # classical-mod=3 approx-inv=4 blk-jacobi=12 rowsum=13 absrowsum=14)
    if p_type == 0:
        W_p = sp.csr_matrix((nF, nC))
    elif p_type == 1:
        l1 = np.asarray(np.abs(A_ff).sum(axis=1)).ravel()
        d = np.where(l1 != 0, 1.0 / l1, 0.0)
        W_p = -sp.diags(d) @ A_fc
    elif p_type == 12:
        # true block-Jacobi: −inv(blkdiag(A_ff))·A_fc (ref: mgr.c
        # blk-jacobi prolongation, bsize = #F functions per cell)
        W_p = -_block_diag_inv(A_ff, bsize) @ A_fc
    elif p_type in (13,):
        rs = np.asarray(A_ff.sum(axis=1)).ravel()
        d = np.where(rs != 0, 1.0 / rs, 0.0)
        W_p = -sp.diags(d) @ A_fc
    elif p_type in (14,):
        rs = np.asarray(np.abs(A_ff).sum(axis=1)).ravel()
        d = np.where(rs != 0, 1.0 / rs, 0.0)
        W_p = -sp.diags(d) @ A_fc
    else:  # jacobi family (2,3,4 → diagonal approximation)
        W_p = -sp.diags(dinv) @ A_fc

    # restriction (injection=0 jacobi=2 approx-inv=3 air=4/5 blk=12
    # cpr-like=13 columped=14 columped-partial=15)
    if r_type == 0:
        W_r = sp.csr_matrix((nC, nF))
    elif r_type == 12:
        # true block-Jacobi restriction: −A_cf·inv(blkdiag(A_ff))
        W_r = -A_cf @ _block_diag_inv(A_ff, bsize)
    elif r_type == 13 and bsize > 1:
        # cpr-like: quasi-IMPES row-sum lumping within the cell block
        # (ref: mgr.c cpr-like restriction)
        W_r = -A_cf @ _block_diag_inv(A_ff, bsize)
    elif r_type in (14, 15):
        # column-lumped: D = diag(colsum(A_ff))
        cs = np.asarray(A_ff.sum(axis=0)).ravel()
        d = np.where(cs != 0, 1.0 / cs, 0.0)
        W_r = -A_cf @ sp.diags(d)
    else:  # jacobi/approx-inv → diagonal
        W_r = -A_cf @ sp.diags(dinv)

    return sp.csr_matrix(W_p), sp.csr_matrix(W_r)


def _assemble_P(W_p, f_rows, c_rows, n, nC):
    Wc = W_p.tocoo()
    rows = np.concatenate([c_rows, f_rows[Wc.row]])
    cols = np.concatenate([np.arange(nC), Wc.col])
    vals = np.concatenate([np.ones(nC), Wc.data])
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, nC))
    P.sort_indices()
    return P


def _assemble_R(W_r, f_rows, c_rows, n, nC):
    Wc = W_r.tocoo()
    rows = np.concatenate([np.arange(nC), Wc.row])
    cols = np.concatenate([c_rows, f_rows[Wc.col]])
    vals = np.concatenate([np.ones(nC), Wc.data])
    R = sp.csr_matrix((vals, (rows, cols)), shape=(nC, n))
    R.sort_indices()
    return R


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("on", "yes", "true", "1")
    return bool(v)


def _component_reuse_keep(reuse_cfg, setup_index: int) -> bool:
    """Static component-reuse policy (ref: MGRComponentReuseShouldKeep,
    src/internal/mgr.c:2293): keep the cached component unless this
    setup falls on a rebuild boundary."""
    if not reuse_cfg or not _truthy(reuse_cfg.get("enabled", False)):
        return False
    if setup_index == 0:
        return False
    freq = int(reuse_cfg.get("frequency", 0) or 0)
    if _truthy(reuse_cfg.get("always", freq == 0)):
        return True
    return setup_index % max(1, freq) != 0


def _component_with_reuse(cfg_value, A_sub, dtype, dofmap, cache, key,
                          setup_index, device):
    """build_component with an optional per-component ``reuse:`` block
    (ref: MGRComponentReuse_args, include/internal/mgr.h:43-50,83-85,
    109-111): a kept component skips its entire setup."""
    reuse_cfg = None
    cfgv = cfg_value
    if isinstance(cfgv, dict) and "reuse" in cfgv:
        cfgv = dict(cfgv)
        reuse_cfg = cfgv.pop("reuse") or {}
        if len(cfgv) == 1 and next(iter(cfgv)) in ("type",):
            cfgv = cfgv["type"]
    sig = (A_sub.shape[0], A_sub.nnz)
    if cache is not None and _component_reuse_keep(reuse_cfg, setup_index):
        ent = cache.get(key)
        if ent is not None and ent[2] == sig:
            return ent[0], ent[1]
    kind, state = build_component(cfgv, A_sub, dtype, dofmap=dofmap,
                                  device=device)
    if cache is not None and reuse_cfg is not None:
        cache[key] = (kind, state, sig)
    return kind, state


def setup_mgr(A_host: sp.csr_matrix, args, dofmap: Optional[np.ndarray],
              dtype: torch.dtype = torch.float64,
              dof_labels: Optional[dict] = None,
              component_cache: Optional[dict] = None, setup_index: int = 0,
              device: torch.device = torch.device("cpu"),
              fine_matrix: Optional[EllMatrix] = None) -> MGRState:
    """Build the MGR hierarchy on the host and upload it to ``device``.
    ``fine_matrix`` is reused as level 0's A when it has the right dtype
    and device."""
    if dofmap is None:
        raise HypredrvError("MGR requires a dofmap (per-row dof labels)",
                            ErrorCode.MISSING_KEY)
    device = torch.device(device)
    if fine_matrix is not None and (fine_matrix.dtype != dtype
                                    or fine_matrix.device != device):
        fine_matrix = None
    A_l = sp.csr_matrix(A_host)
    A_l.sort_indices()
    labels = np.asarray(dofmap).copy()

    level_cfgs = dict(args.get("level") or {})
    if not level_cfgs:
        raise HypredrvError("MGR config needs at least one level",
                            ErrorCode.MISSING_KEY)
    n_levels = int(args.get("num_levels", -1))
    keys = sorted(int(k) for k in level_cfgs)
    if n_levels > 0:
        keys = keys[:n_levels]

    from ..config.sections import MGR_LEVEL_SCHEMA

    coarse_th = float(args.get("coarse_th", 0.0))
    cycle_code, smooth_pos = _parse_cycle(
        args.get("cycle", "v"), int(args.get("cycle_smooth_pos", 1)))
    pre = smooth_pos in (1, 3)
    post = smooth_pos in (2, 3)

    def upload(M):
        return EllMatrix.from_csr(M, dtype=dtype, device=device)

    levels: List[MGRLevel] = []
    for li, key in enumerate(keys):
        errors: List[str] = []
        cfg = MGR_LEVEL_SCHEMA.parse(level_cfgs[key] or {},
                                     f"mgr:level:{key}", errors)
        if errors:
            raise HypredrvError("; ".join(errors), ErrorCode.INVALID_VAL)

        f_labels = _resolve_f_dofs(cfg.f_dofs, dof_labels)
        f_mask = np.isin(labels, f_labels)
        if not f_mask.any() or f_mask.all():
            raise HypredrvError(
                f"mgr level {key}: f_dofs {f_labels} select "
                f"{int(f_mask.sum())} of {len(labels)} rows",
                ErrorCode.INVALID_VAL)
        f_rows = np.flatnonzero(f_mask)
        c_rows = np.flatnonzero(~f_mask)
        nF, nC = len(f_rows), len(c_rows)
        n = A_l.shape[0]

        A_ff = sp.csr_matrix(A_l[f_rows][:, f_rows])
        A_fc = sp.csr_matrix(A_l[f_rows][:, c_rows])
        A_cf = sp.csr_matrix(A_l[c_rows][:, f_rows])
        A_cc = sp.csr_matrix(A_l[c_rows][:, c_rows])

        p_type = int(cfg.prolongation_type)
        r_type = int(cfg.restriction_type)
        # block size for blk-jacobi/cpr-like transfers: the number of
        # distinct F labels per cell, validated against the label layout
        # (interleaved ordering => the F labels repeat with period bsize);
        # a non-uniform layout degrades the transfer to diagonal, with a
        # warning
        bsize = len(set(f_labels))
        if bsize > 1:
            f_lab = np.asarray(labels)[f_rows]
            uniform = (nF % bsize == 0) and bool(
                np.all(f_lab.reshape(-1, bsize) == f_lab[:bsize]))
            if not uniform:
                if p_type == 12 or r_type in (12, 13):
                    log(2, f"mgr level {key}: non-uniform dof-label "
                           f"layout (nF={nF}, {bsize} F labels) — "
                           "blk-jacobi/cpr-like transfer degrades to "
                           "diagonal")
                bsize = 1
        W_p, W_r = _build_transfers(A_ff, A_fc, A_cf, A_cc, p_type, r_type,
                                    nF, nC, bsize)
        P = _assemble_P(W_p, f_rows, c_rows, n, nC)
        if r_type in (4, 5):
            # approximate ideal restriction on the full level operator
            # (ref vocab: mgr.c:1671-1680 air_1/air_1.5) through the lAIR
            # batched local solves (precon/amg/air.py)
            from .amg.air import lair_restriction

            cf_vec = np.ones(n, dtype=np.int64)
            cf_vec[f_rows] = -1
            R = lair_restriction(A_l, cf_vec, strong_th=0.25,
                                 distance=1 if r_type == 4 else 2)
        else:
            R = _assemble_R(W_r, f_rows, c_rows, n, nC)

        # coarse operator (ref vocab: rap=0 non-galerkin=1 cpr-like-diag=2)
        ctype = int(cfg.coarse_level_type)
        if ctype == 0:
            A_c = sp.csr_matrix(R @ A_l @ P)
        else:
            # Schur-like reduction with diagonal F inverse
            diag_ff = A_ff.diagonal()
            dinv = sp.diags(np.where(diag_ff != 0, 1.0 / diag_ff, 0.0))
            A_c = sp.csr_matrix(A_cc - A_cf @ dinv @ A_fc)
        if coarse_th > 0:
            A_c.data[np.abs(A_c.data) < coarse_th] = 0.0
            A_c.eliminate_zeros()
        A_c.sort_indices()

        # components (per-component reuse: a `reuse:` block beside the
        # method key keeps the cached solver across setups)
        f_kind, f_state = _component_with_reuse(
            cfg.f_relaxation, A_ff, dtype, labels[f_rows],
            component_cache, ("lvl", li, "f"), setup_index, device)
        g_kind, g_state = _component_with_reuse(
            cfg.g_relaxation, A_l, dtype, labels,
            component_cache, ("lvl", li, "g"), setup_index, device)

        levels.append(MGRLevel(
            A=(fine_matrix if li == 0 and fine_matrix is not None
               else upload(A_l)),
            f_idx=torch.as_tensor(f_rows, dtype=torch.int64, device=device),
            c_idx=torch.as_tensor(c_rows, dtype=torch.int64, device=device),
            P=upload(P), R=upload(R),
            f_state=f_state, g_state=g_state,
            f_kind=f_kind, g_kind=g_kind,
            f_sweeps=max(1, int(cfg.num_sweeps)),
            pre=pre, post=post,
        ))
        A_l = A_c
        labels = labels[c_rows]

    # coarsest solver (ref: MGRcls args; "def"/-1 → AMG)
    cls_cfg = args.get("coarsest_level", "def")
    if isinstance(cls_cfg, str) and cls_cfg.strip().lower() in ("def", ""):
        cls_cfg = "amg"
    coarsest_kind, coarsest_state = _component_with_reuse(
        cls_cfg, A_l, dtype, labels, component_cache, ("coarsest",),
        setup_index, device)

    return MGRState(
        levels=tuple(levels),
        coarsest_state=coarsest_state,
        coarsest_kind=coarsest_kind,
        cycle_type=cycle_code,
        max_iter=max(1, int(args.get("max_iter", 1))),
    )


def _parse_cycle(value, smooth_pos_default: int):
    """'v'|'w'|1|2|'v(1,0)'|'v(0,1)'|'v(1,1)'|'w(...)' →
    (cycle_code 1|2, smooth_pos 1|2|3) (ref: MGRCycleSet, mgr.c:611-673)."""
    if isinstance(value, (int, float)):
        code = int(value)
        if code not in (1, 2):
            raise HypredrvError(f"invalid MGR cycle {value!r}",
                                ErrorCode.INVALID_VAL)
        return code, smooth_pos_default
    s = str(value).strip().lower()
    table = {
        "v": (1, smooth_pos_default), "w": (2, smooth_pos_default),
        "1": (1, smooth_pos_default), "2": (2, smooth_pos_default),
        "v(1,0)": (1, 1), "v(0,1)": (1, 2), "v(1,1)": (1, 3),
        "w(1,0)": (2, 1), "w(0,1)": (2, 2), "w(1,1)": (2, 3),
    }
    if s not in table:
        raise HypredrvError(
            f"invalid MGR cycle '{value}' (expected 1, 2, v, w, v(1,0), "
            "v(0,1), v(1,1), w(1,0), w(0,1), or w(1,1))",
            ErrorCode.INVALID_VAL)
    return table[s]


def mgr_summary(state: MGRState) -> str:
    lines = ["MGR hierarchy:"]
    for i, lv in enumerate(state.levels):
        lines.append(
            f"  level {i}: n={lv.A.shape[0]} nF={lv.f_idx.shape[0]} "
            f"f_relax={lv.f_kind} g_relax={lv.g_kind}")
    lines.append(f"  coarsest: {state.coarsest_kind} "
                 f"(n={state.levels[-1].P.shape[1]})")
    return "\n".join(lines)


class MGRPrecon(Preconditioner):
    method = "mgr"

    def __init__(self, args, input_args=None):
        super().__init__(args, input_args)
        self._component_cache = {}
        self._setup_count = 0

    def setup(self, system):
        A_host, fine = precon_matrix(system)
        self.state = setup_mgr(
            A_host, self.args, system.dofmap, dtype=system.dtype,
            dof_labels=system.dof_labels,
            component_cache=self._component_cache,
            setup_index=self._setup_count, device=system.device,
            fine_matrix=fine)
        self._setup_count += 1
        log(2, mgr_summary(self.state))
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return mgr_apply(self.state, r)
