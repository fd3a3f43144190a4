"""The port's data layer (objcavit_tpu.data): device-side augmentation, the
datasets with their samplers, the host core's binding and the loader."""
