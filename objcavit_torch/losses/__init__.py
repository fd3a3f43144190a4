"""Depth losses of the port (objcavit_tpu.losses)."""

from objcavit_torch.losses.losses import LossWrapper, bins_chamfer_loss, mse_loss, silog_loss

__all__ = ["LossWrapper", "bins_chamfer_loss", "mse_loss", "silog_loss"]
