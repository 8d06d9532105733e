"""Distributed execution on one device: row shards with a halo exchange.

Counterpart of ``hypredrive_tpu/parallel``: the reference's MPI domain
decomposition (hypre ParCSR row partitioning + halo exchange) as ``n``
row shards on one ``torch.device`` — a halo schedule of shard shifts
(``halo.py``), row-sharded DIA + CSR operators (``dist_matrix.py``), the
distributed AMG setup (``dist_setup.py``) and the distributed MGR and
block-Jacobi ILU setups (``dist_precon.py``).  Global vectors are padded
tensors, so the Krylov cores and the cycles run unchanged on the mesh.
"""

from .dist_matrix import DistEllMatrix, mesh_ops, pad_vector
from .mesh import Mesh, make_mesh

__all__ = ["make_mesh", "Mesh", "DistEllMatrix", "mesh_ops", "pad_vector"]
