"""The port's data layer (objcavit_tpu.data): device-side augmentation, the
eval datasets and the loader."""
