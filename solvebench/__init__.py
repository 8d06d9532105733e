"""The benchmark of ``hypredrive_tpu_torch``: time to a solution per
right-hand side, on one H100 or four (``README.md``)."""
