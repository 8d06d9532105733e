"""ingest_s: the mean host wall of ``set_matrix_from_csr`` and
``set_dofmap`` per system of the window (the new values converted and
uploaded, the dofmap set), in s.  Moves system_s.  Nothing where the run
brings no new system per solve."""


def read(ctx):
    systems = getattr(ctx, "systems", None)
    if not systems:
        return None
    return sum(s["ingest_s"] for s in systems) / len(systems)
