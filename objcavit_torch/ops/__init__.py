"""Plain tensor ops of the port (NHWC, as in objcavit_tpu.ops)."""
