"""The systems a cell solves, one generator per file, made here from a
configuration's ``problem`` section: ``<kind>.py`` for its ``kind``, whose
``build(**arguments)`` returns (the host CSR matrix, the dofmap or None).
The program and the reference get the same matrix.  A new kind of system
is a new file here, found by its name."""
