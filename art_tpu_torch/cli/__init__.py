"""The `art` and `artest` command lines of the port (``--backend=cuda``)."""
