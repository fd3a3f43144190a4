"""Depth-eval metrics as a state of fp32 0-d tensors (torchmetrics parity).

Port of ``objcavit_tpu/metrics/metrics.py``. The reference keeps 16
torchmetrics objects (metrics/*.py: 5 error metrics and 3 delta thresholds,
each pixel-weighted and as a per-image running average) and updates them
with boolean-selected tensors. Here the state is a dict of fp32 0-d tensors
on the predictions' device, and an update is a fixed-shape masked reduction.

  pixel family: state = (sum of per-pixel terms, valid pixel count)
    abs_rel  = sum(|gt - pred| / gt) / n                 (AbsRel.py:50-56)
    sq_rel   = sum((gt - pred)^2 / gt) / n               (SqRel.py)
    rmse     = sqrt(sum((gt - pred)^2) / n)              (RMSE.py)
    rmse_log = sqrt(sum((ln gt - ln pred)^2) / n)        (RMSELog.py)
    log10    = sum(|log10 gt - log10 pred|) / n          (Log10.py)
    acc_k    = sum(max(gt/pred, pred/gt) < 1.25^k) / n   (AccThresh.py)
  running-average family: state = (running_avg, update count); each update
  folds in its masked mean as avg <- (val + avg * count) / (count + 1)
  (AbsRel.py:21-27).

Two behaviours of the reference are kept: the running-average rmse_log
takes no square root (RMSELog.py's RunningAvg), and an update with no valid
pixel leaves the running averages as they are. The cross-process reduction
(``metrics_reduce``/``metrics_sync``) comes with the distributed port.

``metrics_preprocess`` is metrics/MetricsPreprocess.py: the upsample
(bilinear, align_corners=True, fp32, the plain ``ops/resize.py``, never
kernel 1), nan -> min_depth, +-inf -> max_depth, the validity mask
(min < gt <= max) and the Garg and Eigen crops.
"""

from __future__ import annotations

import dataclasses

import torch

from objcavit_torch.ops.resize import resize_bilinear

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "acc_1", "acc_2", "acc_3")

_THRESHOLDS = {"acc_1": 1.25, "acc_2": 1.25**2, "acc_3": 1.25**3}


def metrics_init(device) -> dict[str, torch.Tensor]:
    """The zeroed state: four fp32 0-d tensors per metric on ``device``."""
    return {f"{name}{suffix}": torch.zeros((), dtype=torch.float32, device=device)
            for name in METRIC_NAMES
            for suffix in ("/total", "/count", "_ra/avg", "_ra/count")}


def _per_pixel_terms(pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
    diff = gt - pred
    log_diff = torch.log(gt) - torch.log(pred)
    ratio = torch.maximum(gt / pred, pred / gt)
    terms = {
        "abs_rel": diff.abs() / gt,
        "sq_rel": diff * diff / gt,
        "rmse": diff * diff,
        "rmse_log": log_diff * log_diff,
        "log10": (torch.log10(gt) - torch.log10(pred)).abs(),
    }
    for name, thr in _THRESHOLDS.items():
        terms[name] = (ratio < thr).float()
    return terms


def metrics_update(state: dict[str, torch.Tensor], depth_pred: torch.Tensor,
                   depth_gt: torch.Tensor, mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Fold one (pred, gt, mask) batch into the state; returns a new state.

    All three share one shape; only pixels where ``mask`` is True count. One
    call is one torchmetrics ``update`` on the masked selection.
    """
    n = mask.float().sum()
    safe_n = n.clamp(min=1.0)
    has_px = n > 0.0
    terms = _per_pixel_terms(depth_pred.float(), depth_gt.float())
    new = dict(state)
    for name in METRIC_NAMES:
        total = torch.where(mask, terms[name], 0.0).sum()
        new[f"{name}/total"] = state[f"{name}/total"] + total
        new[f"{name}/count"] = state[f"{name}/count"] + n
        val = total / safe_n
        if name == "rmse":
            val = torch.sqrt(val)
        # rmse_log's running average takes no square root (RMSELog.py)
        avg, cnt = state[f"{name}_ra/avg"], state[f"{name}_ra/count"]
        # an update with no valid pixel is skipped, not folded in as a 0
        new[f"{name}_ra/avg"] = torch.where(has_px, (val + avg * cnt) / (cnt + 1.0), avg)
        new[f"{name}_ra/count"] = torch.where(has_px, cnt + 1.0, cnt)
    return new


def metrics_compute(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The 16 values: 8 pixel-weighted and 8 running averages ('_ra')."""
    out = {}
    for name in METRIC_NAMES:
        v = state[f"{name}/total"] / state[f"{name}/count"].clamp(min=1.0)
        if name in ("rmse", "rmse_log"):
            v = torch.sqrt(v)
        out[name] = v
        out[f"{name}_ra"] = state[f"{name}_ra/avg"]
    return out


@dataclasses.dataclass(frozen=True)
class MetricsPreprocessConfig:
    min_depth: float
    max_depth: float
    garg_crop: bool = False
    eigen_crop: bool = False
    dataset: str = "nyu"


def eval_crop(gt_h: int, gt_w: int, cfg: MetricsPreprocessConfig) -> tuple[slice, slice] | None:
    """The (rows, cols) box that the Garg or Eigen crop keeps, or None."""
    if cfg.garg_crop:
        return (slice(int(0.40810811 * gt_h), int(0.99189189 * gt_h)),
                slice(int(0.03594771 * gt_w), int(0.96405229 * gt_w)))
    if cfg.eigen_crop:
        if cfg.dataset == "kitti":
            return (slice(int(0.3324324 * gt_h), int(0.91351351 * gt_h)),
                    slice(int(0.0359477 * gt_w), int(0.96405229 * gt_w)))
        return slice(45, 471), slice(41, 601)
    return None


def metrics_preprocess(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                       cfg: MetricsPreprocessConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample and clean the prediction; build the evaluation mask.

    Both NHWC (N, H, W, 1). Returns (fp32 prediction at the GT's size, bool
    mask of the GT's shape).
    """
    gt_h, gt_w = depth_gt.shape[1], depth_gt.shape[2]
    depth_pred = resize_bilinear(depth_pred.float(), gt_h, gt_w, align_corners=True)
    depth_pred = torch.nan_to_num(depth_pred, nan=cfg.min_depth, posinf=cfg.max_depth,
                                  neginf=cfg.max_depth)
    mask = (depth_gt > cfg.min_depth) & (depth_gt <= cfg.max_depth)
    box = eval_crop(gt_h, gt_w, cfg)
    if box is not None:
        keep = torch.zeros((gt_h, gt_w), dtype=torch.bool, device=mask.device)
        keep[box] = True
        mask = mask & keep[None, :, :, None]
    return depth_pred, mask
