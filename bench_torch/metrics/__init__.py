"""One reader a metric, ``<metric>.py`` with ``read(run)``: the metric's
value from the run (``harness.Run``), or None where the run holds nothing
to read, and the harness then leaves the metric out of its line."""
