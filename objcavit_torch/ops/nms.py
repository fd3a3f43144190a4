"""Fixed-shape non-max suppression, batched, on the tensors' device.

Port of ``objcavit_tpu/ops/nms.py``:

  1. the top ``pre_topk`` candidates by confidence (scores under
     ``conf_thres`` become 0.0);
  2. a K x K IoU matrix, masked to same-class pairs unless ``agnostic``;
  3. greedy suppression as a fixed-point iteration (``_greedy_keep``);
  4. a padded (max_det,) result with a validity mask, and ``n_candidates``,
     the anchors above ``conf_thres`` before the pool cut.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values, and
most scores are equal here (every score under the threshold is exactly 0.0
and every suppressed one -1.0), so the padded slots' boxes, classes and
``nms_idx`` come from those ties. ``torch.topk`` does not promise that
order; a stable descending sort does, so every slot, valid or not, matches
the JAX package.
"""

from __future__ import annotations

import torch

# greedy-NMS steps between two convergence checks: each check reads one
# bool back to the host, and real detections converge in 2-5 steps
STEPS_PER_CHECK = 4


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (..., K, 4) xyxy -> (..., K, K) IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def _greedy_keep(iou: torch.Tensor, cand: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Exact greedy-NMS keep mask, (..., K, K) IoU in score order and (..., K)
    candidates -> (..., K) bool.

    Greedy suppression is the unique fixed point of
    f(x)[i] = cand[i] & ~any_{j<i}(x[j] & iou[i, j] > thr): once ranks < i
    are fixed, one more step fixes rank i, so iterating f from any start
    reaches it within K steps. f leaves a fixed point unchanged, so the loop
    may run ``STEPS_PER_CHECK`` steps between checks and still stop on the
    exact answer; a check compares the last two steps (one host sync).

    While ``torch.export`` traces, the loop is JAX's ``lax.while_loop``
    (``objcavit_tpu/ops/nms.py``) as ``torch.while_loop``: one step of f a
    turn until two steps agree or K steps ran, with no host sync. It stops
    on the same fixed point.
    """
    k = cand.shape[-1]
    lower = torch.ones((k, k), dtype=torch.bool, device=cand.device).tril(-1)
    sup = (iou > iou_thres) & lower  # sup[i, j]: kept j would suppress i

    def f(x):
        return cand & ~(sup & x[..., None, :]).any(-1)

    if torch.compiler.is_exporting():
        def cond(x, prev, it):
            return (x != prev).any() & (it < k)

        def body(x, prev, it):
            # clone: a loop's outputs may not alias its inputs
            return f(x), x.clone(), it + 1

        it = torch.ones((), dtype=torch.int64, device=cand.device)
        return torch.while_loop(cond, body, (f(cand), cand, it))[0]
    x = cand
    for _ in range(0, k + 1, STEPS_PER_CHECK):
        for _ in range(STEPS_PER_CHECK):
            prev, x = x, f(x)
        if torch.equal(x, prev):
            break
    return x


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: lower index first among ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def batched_nms(boxes_xyxy: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                conf_thres: float, iou_thres: float, pre_topk: int = 256, max_det: int = 100,
                agnostic: bool = False) -> dict:
    """(B, A, 4), (B, A), (B, A) -> dict of (B, max_det) ``boxes_xyxy``,
    ``scores``, ``classes``, ``nms_idx`` (index into the A anchors),
    ``valid``, and ``n_candidates`` (B,) int32. ``n_candidates > pre_topk``
    means the pool dropped the lowest-confidence candidates."""
    score = torch.where(scores >= conf_thres, scores, torch.zeros_like(scores))
    n_candidates = (score > 0.0).sum(-1).to(torch.int32)
    top_score, idx = stable_topk(score, pre_topk)
    top_boxes = torch.gather(boxes_xyxy, 1, idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(classes, 1, idx)

    iou = _iou_matrix(top_boxes)
    if not agnostic:  # class-aware: only same-class detections suppress each other
        iou = torch.where(top_cls[..., :, None] == top_cls[..., None, :], iou,
                          torch.zeros_like(iou))
    keep = _greedy_keep(iou, top_score > 0.0, iou_thres)
    kept_score = torch.where(keep, top_score, torch.full_like(top_score, -1.0))
    k = min(max_det, pre_topk)
    out_score, out_idx = stable_topk(kept_score, k)
    if k < max_det:  # pad up to the requested fixed shape
        pad = max_det - k
        out_score = torch.cat([out_score, out_score.new_full((out_score.shape[0], pad), -1.0)], 1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros((out_idx.shape[0], pad))], 1)
    valid = out_score > 0.0
    return {
        "boxes_xyxy": torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(valid, out_score, torch.zeros_like(out_score)),
        "classes": torch.gather(top_cls, 1, out_idx),
        "nms_idx": torch.gather(idx, 1, out_idx),
        "valid": valid,
        "n_candidates": n_candidates,
    }


def xywh_to_xyxy(xywh: torch.Tensor) -> torch.Tensor:
    half = xywh[..., 2:4] / 2
    return torch.cat([xywh[..., 0:2] - half, xywh[..., 0:2] + half], dim=-1)


def xyxy_to_xywh(xyxy: torch.Tensor) -> torch.Tensor:
    wh = xyxy[..., 2:4] - xyxy[..., 0:2]
    return torch.cat([xyxy[..., 0:2] + wh / 2, wh], dim=-1)
