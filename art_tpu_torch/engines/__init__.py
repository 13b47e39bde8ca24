"""The host engines, copied from ``art_tpu/engines``."""
