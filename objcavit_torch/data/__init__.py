"""Device-side data transforms of the port (objcavit_tpu.data)."""
