"""Dense eigenspectrum computation.

Counterpart of ``hypredrive_tpu/linsys/eigspec.py`` (ref:
src/internal/eigspec.c: gather A, or M⁻¹A through a precon-apply callback,
to a dense matrix, run dgeev/dsyev, write the eigenvalues as ASCII and the
eigenvectors as binary).  The dense matrix stays on the host, as the
feature is a diagnostic for small systems; with a set-up preconditioner
each column of M⁻¹A is one preconditioner apply on the system's device.
"""

from __future__ import annotations

import numpy as np
import torch


def preconditioned_dense(A: np.ndarray, precon, dtype, device) -> np.ndarray:
    """M⁻¹A column by column: one ``precon.apply`` per column of A on
    ``device``, each column read back to the host."""
    out = np.empty_like(A)
    for j in range(A.shape[1]):
        col = torch.as_tensor(A[:, j], dtype=dtype, device=device)
        out[:, j] = precon.apply(col).cpu().numpy()
    return out


def compute_eigenspectrum(system, eig_args, precon=None):
    """Returns the eigenvalues (and writes the files eig_args names)."""
    A = np.asarray(system.A_host.todense())
    if eig_args.get("preconditioned") and precon is not None:
        A = preconditioned_dense(A, precon, system.dtype, system.device)

    hermitian = bool(eig_args.get("hermitian"))
    want_vectors = bool(eig_args.get("vectors"))
    v = None
    if hermitian:
        if want_vectors:
            w, v = np.linalg.eigh(A)
        else:
            w = np.linalg.eigvalsh(A)
    elif want_vectors:
        w, v = np.linalg.eig(A)
    else:
        w = np.linalg.eigvals(A)

    prefix = eig_args.get("output_prefix") or "eigspec"
    with open(f"{prefix}_eigenvalues.txt", "w") as f:
        f.write(f"{len(w)}\n")
        for lam in w:
            if np.iscomplexobj(w):
                f.write(f"{lam.real:.15e} {lam.imag:.15e}\n")
            else:
                f.write(f"{lam:.15e}\n")
    if v is not None:
        np.asarray(v).astype(np.complex128 if np.iscomplexobj(v)
                             else np.float64).tofile(
            f"{prefix}_eigenvectors.bin")
    return w
