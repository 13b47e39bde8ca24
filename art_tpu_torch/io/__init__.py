"""WAV container I/O, copied from ``art_tpu/io``."""
