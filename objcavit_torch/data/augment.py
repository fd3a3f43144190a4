"""Device-side batched augmentation, and the ImageNet normalisation after it.

Port of ``objcavit_tpu/data/augment.py::augment_batch``, split in two:

* ``draw_augment``: the random draws, from an explicit ``torch.Generator``
  on the batch's device: a flip coin, a gamma draw, a Planckian on/off coin
  and a blackbody temperature per image;
* ``augment_with``: a deterministic function of the batch and those draws.
  A test feeds it the very values JAX draws, so the two compare exactly.

What it does (the reference's kornia step and normalisation):

* horizontal flip with p 0.5, the image and the depth on one coin (the
  object boxes are not flipped, as in the JAX train step);
* per-image gamma in [0.9, 1.1);
* Planckian jitter with p 0.5: channel gains r/g and b/g of a blackbody at
  T ~ U[3000 K, 15000 K), from the Planckian-locus polynomials for CIE xy;
* ImageNet normalisation.

Layout NHWC; takes [0, 1] images, returns normalised ones.
"""

from __future__ import annotations

import torch

from objcavit_torch.parallel.collectives import rand_rows
from objcavit_torch.serving import IMAGENET_MEAN, IMAGENET_STD


def draw_augment(b: int, generator: torch.Generator | None, device) -> dict[str, torch.Tensor]:
    """The draws of one batch of ``b`` images, as ``augment_with`` takes them;
    in a process group, this rank's images of the global batch's draws
    (``parallel/collectives.py::rand_rows``)."""
    u = rand_rows((4, b), generator, device, dim=1)
    return {
        "flip": u[0] < 0.5,
        "gamma_u": u[1],
        "planck_on": u[2] < 0.5,
        "temperature": 3000.0 + 12000.0 * u[3],
    }


def planckian_gains(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel gains (r/g, b/g) of blackbody temperatures ``t`` in kelvin,
    with green normalised to 1 (``objcavit_tpu/data/augment.py:27-61``)."""
    invt = 1e3 / t
    invt2 = invt * invt
    invt3 = invt2 * invt
    x = torch.where(
        t < 4000.0,
        -0.2661239 * invt3 - 0.2343589 * invt2 + 0.8776956 * invt + 0.179910,
        -3.0258469 * invt3 + 2.1070379 * invt2 + 0.2226347 * invt + 0.240390,
    )
    x2, x3 = x * x, x * x * x
    y = torch.where(
        t < 2222.0,
        -1.1063814 * x3 - 1.34811020 * x2 + 2.18555832 * x - 0.20219683,
        torch.where(
            t < 4000.0,
            -0.9549476 * x3 - 1.37418593 * x2 + 2.09137015 * x - 0.16748867,
            3.0817580 * x3 - 5.87338670 * x2 + 3.75112997 * x - 0.37001483,
        ),
    )
    # xyY (Y = 1) -> XYZ -> linear sRGB
    big_x = x / y
    big_z = (1.0 - x - y) / y
    r = 3.2404542 * big_x - 1.5371385 + (-0.4985314) * big_z
    g = -0.9692660 * big_x + 1.8760108 + 0.0415560 * big_z
    b = 0.0556434 * big_x - 0.2040259 + 1.0572252 * big_z
    r = torch.clamp(r, min=1e-6)
    g = torch.clamp(g, min=1e-6)
    b = torch.clamp(b, min=1e-6)
    return r / g, b / g


def augment_with(image: torch.Tensor, depth: torch.Tensor, flip: torch.Tensor,
                 gamma_u: torch.Tensor, planck_on: torch.Tensor,
                 temperature: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """image (B, H, W, 3) in [0, 1], depth (B, H, W, 1), and per image: flip
    and planck_on (bool), gamma_u in [0, 1), temperature in kelvin ->
    (normalised image, depth)."""
    f = flip.view(-1, 1, 1, 1)
    image = torch.where(f, image.flip(2), image)
    depth = torch.where(f, depth.flip(2), depth)

    gamma = 1.0 + (gamma_u.view(-1, 1, 1, 1) - 0.5) * 0.2
    image = torch.pow(torch.clamp(image, min=0.0), gamma)

    gain_r, gain_b = planckian_gains(temperature)
    gain = torch.stack([gain_r, torch.ones_like(gain_r), gain_b], dim=-1)
    gain = torch.where(planck_on[:, None], gain, 1.0)
    image = torch.clamp(image * gain[:, None, None, :], 0.0, 1.0)

    mean = torch.tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
    return (image - mean) / std, depth


def augment_batch(generator: torch.Generator | None, image: torch.Tensor,
                  depth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw from ``generator``, then augment and normalise the batch."""
    return augment_with(image, depth, **draw_augment(image.shape[0], generator, image.device))
