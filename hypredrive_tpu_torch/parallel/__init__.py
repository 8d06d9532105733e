"""Distributed execution: row shards with a halo exchange, one rank per
card.

Counterpart of ``hypredrive_tpu/parallel``: the reference's MPI domain
decomposition (hypre ParCSR row partitioning + halo exchange) as ``n``
row shards over the ranks of a ``torch.distributed`` group, each rank on
its own device (``mesh.py``; without a group every shard on one device)
— a halo schedule of shard shifts (``halo.py``), row-sharded DIA + CSR
operators (``dist_matrix.py``), the distributed AMG setup
(``dist_setup.py``) and the distributed MGR and block-Jacobi ILU setups
(``dist_precon.py``).  Vectors are the rank's blocks of padded global
vectors, so the Krylov cores and the cycles run unchanged on the mesh;
their reductions go over the mesh's group.
"""

from .dist_matrix import DistEllMatrix, mesh_ops, pad_vector
from .mesh import Mesh, make_mesh

__all__ = ["make_mesh", "Mesh", "DistEllMatrix", "mesh_ops", "pad_vector"]
