"""The host layer of the port: flags, filter design and the float64
consume/emit accounting, copied from ``art_tpu/core``."""
