"""Pre-solve diagonal scaling.

Counterpart of ``hypredrive_tpu/linsys/scaling.py`` (ref:
src/internal/scaling.c types :43-66, ScalingTransformSystem :950,
error-preserving restore src/HYPREDRV.c:142-157).

Scaled system:  (Sl·A·Sr)·(Sr⁻¹x) = Sl·b.  ``apply`` rewrites the device
matrix (``EllMatrix.scale``, same structure), its host copy, the
preconditioning matrix, b, x and xref; ``undo`` restores the originals and
maps the solved x back.  The scaling vectors live on the system's device.

Types (vocab SCALING_TYPE):
  rhs_l2                    Sl = I/‖b‖₂, Sr = I
  dofmap_mag                Sl = Sr = S, s_i = 1/√(max |a_jj| over label)
  dofmap_custom             Sl = Sr = S, s_i = w(label i)  (congruence)
  dofmap_row_custom         Sl = S, Sr = I
  dofmap_col_custom         Sl = I, Sr = S
  dofmap_similarity_custom  Sl = S, Sr = S⁻¹  (similarity)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..core.errors import ErrorCode, HypredrvError
from ..ops.vectors import norm2


@dataclass
class ScalingContext:
    sl: Optional[torch.Tensor]      # left scaling vector (None = identity)
    sr: Optional[torch.Tensor]      # right scaling vector
    saved_A: object = None
    saved_A_host: object = None
    saved_M_host: object = None
    saved_b: object = None
    saved_xref: object = None

    @classmethod
    def compute(cls, system, args) -> "ScalingContext":
        stype = args.get("type", 0)
        n = system.num_rows

        def vec(a):
            return torch.as_tensor(a, dtype=system.dtype,
                                   device=system.device)

        if stype == 0:  # rhs_l2
            bnorm = float(norm2(system.b))
            s = 1.0 / bnorm if bnorm > 0 else 1.0
            return cls(sl=vec(np.full(n, s)), sr=None)

        if system.dofmap is None:
            raise HypredrvError(
                "dofmap-based scaling requires a dofmap", ErrorCode.INVALID_ARG)
        labels = np.asarray(system.dofmap)

        if stype == 1:  # dofmap_mag
            diag = np.abs(system.A.diagonal().cpu().numpy())
            s = np.ones(n)
            for lab in np.unique(labels):
                mask = labels == lab
                mag = diag[mask].max()
                if mag > 0:
                    s[mask] = 1.0 / np.sqrt(mag)
            sv = vec(s)
            return cls(sl=sv, sr=sv)

        # custom-weight variants
        weights = list(args.get("custom_values") or [])
        if not weights:
            raise HypredrvError(
                "custom scaling requires solver:scaling:custom_values",
                ErrorCode.MISSING_KEY)
        uniq = np.unique(labels)
        if len(weights) < len(uniq):
            raise HypredrvError(
                f"scaling custom_values has {len(weights)} entries for "
                f"{len(uniq)} dof labels", ErrorCode.INVALID_VAL)
        wmap = {int(lab): float(weights[i]) for i, lab in enumerate(uniq)}
        s = np.array([wmap[int(lab)] for lab in labels])
        sv = vec(s)

        if stype == 2:   # dofmap_custom: S A S
            return cls(sl=sv, sr=sv)
        if stype == 3:   # dofmap_row_custom: S A
            return cls(sl=sv, sr=None)
        if stype == 4:   # dofmap_col_custom: A S
            return cls(sl=None, sr=sv)
        if stype == 5:   # dofmap_similarity_custom: S A S⁻¹
            return cls(sl=sv, sr=1.0 / sv)
        raise HypredrvError(f"unknown scaling type {stype}",
                            ErrorCode.INVALID_VAL)

    # -- transform ---------------------------------------------------------

    def apply(self, system):
        self.saved_A = system.A
        self.saved_A_host = system.A_host
        self.saved_M_host = system.M_host
        self.saved_b = system.b
        self.saved_xref = system.xref

        system.A = system.A.scale(self.sl, self.sr)
        if system.A_host is not None:
            system.A_host = _scale_csr(system.A_host, self.sl, self.sr)
        if system.M_host is not None:
            system.M_host = _scale_csr(system.M_host, self.sl, self.sr)
        if self.sl is not None:
            system.b = self.sl * system.b
        if self.sr is not None:
            # x' = Sr⁻¹ x
            system.x = system.x / self.sr
            if system.xref is not None:
                system.xref = system.xref / self.sr

    def undo(self, system):
        """Restore A/M/b/xref and map x back (error-preserving restore)."""
        if self.sr is not None:
            system.x = self.sr * system.x
        system.A = self.saved_A
        system.A_host = self.saved_A_host
        system.M_host = self.saved_M_host
        system.b = self.saved_b
        system.xref = self.saved_xref


def _scale_csr(A, sl, sr):
    out = A.copy()
    if sl is not None:
        out = sp.diags(sl.cpu().numpy()) @ out
    if sr is not None:
        out = out @ sp.diags(sr.cpu().numpy())
    out = sp.csr_matrix(out)
    out.sort_indices()
    return out
