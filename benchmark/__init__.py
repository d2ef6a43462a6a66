"""The benchmark of ``curve_gaussian_tpu_torch``: training views per second
of the program's graphed training chunk on an H100, cell by cell, with a
plain reference that decides ``correct``.  ``run.py`` runs one cell."""
