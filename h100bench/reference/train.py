"""The reference train step: device-side augmentation, the model in training
mode, SILog + bins chamfer, backward, clipping by global norm, AdamW under
the one-cycle schedule; plain PyTorch and fp32.

The augmentation is the published recipe (a horizontal flip on one coin for
the image and the depth, a per-image gamma in [0.9, 1.1), Planckian jitter
with p 0.5 at a blackbody temperature in [3000, 15000) K, ImageNet
normalisation), drawing ``torch.rand((4, B))`` from the step's generator
before the model's dropout draws, as the measured step does. The chamfer
distance is the dense one: every bin centre against every valid target of
its image, one image at a time. The optimizer and schedule are
``torch.optim.AdamW`` and ``OneCycleLR`` with the settings the params file
states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.model import IMAGENET_MEAN, IMAGENET_STD


def planckian_gains(t: torch.Tensor):
    """Channel gains (r/g, b/g) of blackbodies at ``t`` kelvin, from the
    Planckian-locus polynomials for CIE xy, then XYZ -> linear sRGB."""
    invt = 1e3 / t
    invt2, invt3 = invt * invt, invt * invt * invt
    x = torch.where(t < 4000.0,
                    -0.2661239 * invt3 - 0.2343589 * invt2 + 0.8776956 * invt + 0.179910,
                    -3.0258469 * invt3 + 2.1070379 * invt2 + 0.2226347 * invt + 0.240390)
    x2, x3 = x * x, x * x * x
    y = torch.where(t < 2222.0, -1.1063814 * x3 - 1.34811020 * x2 + 2.18555832 * x - 0.20219683,
                    torch.where(t < 4000.0,
                                -0.9549476 * x3 - 1.37418593 * x2 + 2.09137015 * x - 0.16748867,
                                3.0817580 * x3 - 5.87338670 * x2 + 3.75112997 * x - 0.37001483))
    big_x, big_z = x / y, (1.0 - x - y) / y
    r = (3.2404542 * big_x - 1.5371385 - 0.4985314 * big_z).clamp(min=1e-6)
    g = (-0.9692660 * big_x + 1.8760108 + 0.0415560 * big_z).clamp(min=1e-6)
    b = (0.0556434 * big_x - 0.2040259 + 1.0572252 * big_z).clamp(min=1e-6)
    return r / g, b / g


def augment(generator, image, depth):
    """image (B, H, W, 3) in [0, 1], depth (B, H, W, 1) -> (normalised image, depth)."""
    u = torch.rand((4, image.shape[0]), generator=generator, device=image.device)
    flip = (u[0] < 0.5).view(-1, 1, 1, 1)
    image = torch.where(flip, image.flip(2), image)
    depth = torch.where(flip, depth.flip(2), depth)
    gamma = 1.0 + (u[1].view(-1, 1, 1, 1) - 0.5) * 0.2
    image = torch.pow(image.clamp(min=0.0), gamma)
    gain_r, gain_b = planckian_gains(3000.0 + 12000.0 * u[3])
    gain = torch.stack([gain_r, torch.ones_like(gain_r), gain_b], dim=-1)
    gain = torch.where((u[2] < 0.5)[:, None], gain, 1.0)
    image = (image * gain[:, None, None, :]).clamp(0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return (image - mean) / std, depth


def silog(pred, gt, mask, alpha: float = 10.0, lam: float = 0.85):
    """Scale-invariant log loss, the prediction upsampled to the GT's size
    (bilinear, align_corners=True)."""
    pred = F.interpolate(pred.permute(0, 3, 1, 2), size=gt.shape[1:3], mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)
    g = torch.where(mask, torch.log(pred) - torch.log(gt), 0.0)
    n = mask.sum().float()
    return alpha * torch.sqrt((g * g).sum() / n - lam / (n * n) * g.sum() ** 2)


def chamfer(edges, gt, mask):
    """Squared-L2 chamfer distance between each image's bin centres and its
    valid GT depths, point means, averaged over the images with a target."""
    centers = 0.5 * (edges[:, 1:] + edges[:, :-1])
    total_x = total_y = torch.zeros((), device=gt.device)
    rows = 0
    for c, y, m in zip(centers, gt.reshape(gt.shape[0], -1), mask.reshape(gt.shape[0], -1)):
        y = y[m]
        if y.numel() == 0:
            continue
        d = (c[:, None] - y[None, :]) ** 2  # (K, T)
        total_x = total_x + d.min(dim=1).values.mean()
        total_y = total_y + d.min(dim=0).values.mean()
        rows += 1
    rows = max(rows, 1)
    return total_x / rows + total_y / rows


def loss_fn(model, batch, objects, generator, min_depth: float, coeffs=(1.0, 0.1)):
    image, depth = augment(generator, batch["image"], batch["depth"])
    inputs = (image,)
    if model.takes_objects:
        inputs += (objects["features"], objects["xywh"], objects["valid"])
    pred, edges = model(*inputs, generator=generator)
    mask = depth > min_depth
    return coeffs[0] * silog(pred, depth, mask) + coeffs[1] * chamfer(edges, depth, mask)


def optimizer(model, lr: float, wd: float, total_steps: int, div_factor: float,
              final_div_factor: float):
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=total_steps, pct_start=0.3, anneal_strategy="cos",
        cycle_momentum=True, base_momentum=0.85, max_momentum=0.95, div_factor=div_factor,
        final_div_factor=final_div_factor)
    return opt, sched


def steps(model, batches, objects, generator, recipe: dict):
    """Run ``len(batches)`` steps from the model's current weights. ->
    (the losses, each leaf's first clipped gradient, the norm of each leaf's
    change after the last step), by parameter name."""
    opt, sched = optimizer(model, recipe["lr"], recipe["wd"], recipe["total_steps"],
                           recipe["div_factor"], recipe["final_div_factor"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads = [], None
    model.train()
    for batch, objs in zip(batches, objects):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, objs, generator, recipe["min_depth"], recipe["coeffs"])
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), recipe["clip"])
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        opt.step()
        sched.step()
        losses.append(float(loss.detach()))
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    return losses, grads, change
