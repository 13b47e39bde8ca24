"""Deterministic test signals, copied from ``art_tpu/utils``."""
