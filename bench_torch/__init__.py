"""The benchmark of the PyTorch/CUDA port (``art_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to
one configuration, one cell or one metric sits in a file of its own, found
by its name: ``configs/<config>.json``, ``cells/<cell>.json`` (the traffic
and the limits of the check), ``entries/<entry>.py`` (the engine path a
cell drives), ``metrics/<metric>.py`` (one reader a metric),
``roofline/<kernel>.py`` (a kernel's operations and bytes) and
``reference/<name>.py`` (a configuration's plain reference).  Nothing here
imports ``jax`` or ``art_tpu``; only the entries import ``art_tpu_torch``.
"""
