"""Deterministic test signals, stream stats and checksums, copied from
``art_tpu/utils``."""
