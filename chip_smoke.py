#!/usr/bin/env python3
"""Drive objcavit_torch's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA kernels from ``objcavit_torch/csrc`` with nvcc,
   one process per source, all at once, and prints the ptxas registers and
   spills of kernels 1, 2, 5's forward, 7, 8 and 10;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (TF32 off), then both timed in turns with CUDA events:
   kernel 1 (resize) at the flagship's four decoder upsamples, bare and in
   its concat form (the upsample and the skip into the decoder's concat
   buffer, the skip bit for bit; beside the bare kernel + ``torch.cat``, the
   route it replaced), both as CUDA-graph replays; kernel 2 (factored bins
   head) at the server's shape, two calls bitwise equal, and kernel 3 (the
   bins head with one shared weight) at (8, 240, 320, 128), both as
   CUDA-graph replays, with their exps' count and time on the SFU beside the
   bound; kernel 4 (bins expectation) forward and backward at
   the train step's (8, 56576, 256), kernel 6 (the detect head) at the three
   levels of NYU 480x640 and of KITTI 352x1216, batch 8 (and, checked but
   not timed, on grids whose block shares start or end at a row tile's
   edge, at NYU level 0 and a small shape), kernel 5
   (attention) forward and backward at (8, 300, 4, 32) with the served
   masks, at S = 221 and 1200, at Sq != Sk and on fully masked rows, the
   forward with and without its residual (bitwise the same), each
   backward on the route its shape takes (one cluster launch up to 512
   keys and queries: every case but S = 1200), both timed at S = 300 and
   at the train step's S = 221 (the forward as a served call, without the
   residual, and as a train step's); and the shapes ``do_final_upscale``
   gives kernels 1, 2, 4 and 5 (phase 13's paths): kernel 1's bare form at
   the fifth upsample, (8, 240, 320, 128) -> 480x640 (with that stage's
   route, the bare form then ``torch.cat`` with the 3-channel image,
   logged), kernel 2 at (8, 480, 640, 128), kernel 4 at (8, 226304, 256),
   kernel 5 at 1200 queries against 1000 masked keys (checked with the
   cases above) and timed at S 1200 and S 884 on its long routes (the
   forward and the backward past 512 keys: wgmma warpgroups fed by TMA),
   with each one's exps and their time on the SFU alone logged beside its
   bound. Each
   kernel's bound (the larger of its bytes over 3.35 TB/s and its
   operations over the card's peak for their type; tensor-core and
   CUDA-core operations run at once, so the larger of their two times) is
   computed from its
   shapes, and where one PyTorch call computes the same function it is
   timed beside it (``library_ms``, used nowhere in the port). Kernels 5
   and 6 take tens of microseconds a call, so theirs are timed as CUDA-graph
   replays, the card alone (kernel 5 also as eager calls, in the log):
   ``F.interpolate`` for kernel 1, the dense head's GEMM for kernel 6,
   ``F.scaled_dot_product_attention`` for kernel 5. Then the encoder's
   kernels at B5's shapes at 480x640, batch 8: kernel 8 (the fused MBConv
   head; the build prints its ptxas registers and spills) at the eight
   shapes of the 32 stride-1 MBConv blocks (``utils/mbconv_ab.py``'s
   ``MBCONV_SHAPES`` and ``mbconv_bound``), kernel 9
   (its (H, W, B, C) form) at stages 1 and 5, kernel 10 (the depthwise conv
   alone, ``csrc/dw_silu_pool.cu``) with and without the pool at k 3 and
   5, with cuDNN's depthwise conv + bias beside it (a part of the
   function, logged), kernel 7 (the SE-gate
   project) at the seven shapes of its route and stage 6's 3072 -> 512;
   each held against its plain version by ``kernel_io``'s checks, timed as
   CUDA-graph replays, kernel 7 beside one ``torch.baddbmm``; and kernel 7
   at the six shapes of EfficientNet-V2-M's MBConv blocks that those lack
   (``V2M_SE_SHAPES``), checked and timed the same way and summed with two
   of those over a V2-M forward's 44 launches;
4. slice: the flagship server (GraphBins-B5, bf16, BN folded, 480x640, 300
   object slots, random weights from seed 0) answers requests of 8 uint8
   frames, with detector-style object slots and with the no-detection
   sentinel. Launch counters, zeroed just before, must show 4 resize
   launches, all in the concat form, and 1 bins launch per forward; depth
   must be finite and in range; each kernel's output in those forwards must
   match its plain version on the very tensors the forward gave it (each
   concat buffer's skip slice bit for bit); kernel 1's bare form, driven on
   a served forward's four upsample inputs, must give the concat form's
   upsamples bit for bit; and ObjCAViT's outputs
   must stay close to an fp32 run of the same weights (plain versions, no
   kernel) on a small input. Then the served rate and peak memory.
5. unfactored head: ``ops.bins.bins_head_depth`` at inference, bf16, on
   (8, 240, 320, 128) range maps, the route of kernel 3 (no model of this
   slice takes it: GraphBins's head is the factored one); and kernels 9 and
   10, driven as functions on B5's stage-1 tensors (no model takes them);
5a. attention-kernel server: the flagship server with ``attn_impl="kernel"``
   answers 4 requests of 8 frames at 480x640: 10 kernel-5 launches, 4
   resize and 1 bins launch per forward; each kernel's output in those
   forwards must match its plain version on its own tensors, and no served
   kernel-5 forward may write the residual (no backward reads it); ObjCAViT's
   outputs must stay close to an fp32 run of the same weights (the plain
   route). Then the served rate and ObjCAViT's stage time on each route;
5b. encoder-kernel server: the flagship server with ``encoder_impl="kernel"``
   answers 4 requests of 8 frames at 480x640: 32 kernel-8 and 7 kernel-7
   launches, 4 resize and 1 bins launch per forward; each kernel's output
   in those forwards must match its plain version on its own tensors; the
   encoder's five outputs must stay within a rel L2 bound of an fp32 plain
   run of the same weights on a small input. Then the served rate, p50,
   peak memory and the encoder's stage time on each route;
6. fused: the fused server (``build_fused_flagship``: GraphBins-B5 and
   YOLOv7-seg, bf16, BN folded, 1203 classes, the class table from the
   full-width CLIP text tower, random weights, 480x640, 300 slots) answers
   4 requests of 8 uint8 frames on the class-max head. Launch counters,
   zeroed just before, must show 3 kernel-6, 4 resize and 1 bins launches
   per request; each kernel's output in those requests must match its
   plain version on the very tensors the request gave it; depth finite and
   in range; every frame must keep detections out of a full NMS pool. Then
   the detector's bf16 kernel route against fp32 plain, the automatic head
   gate (dense at 480x640, kernel 6 at KITTI 352x1216 with 418 slots), one
   request each with det_topk=128, det_stride=2 and det_scale=0.5, the
   stage split, and the served rate of both head routes;
7. train: the flagship train step (``build_flagship_train``: GraphBins-B5,
   bs 8, 416x544, 221 slots, bf16 compute on fp32 parameters, dropout 0.1,
   device-side augmentation, silog + 0.1 bins chamfer, AdamW under
   OneCycle, clip 0.1) takes a warm-up step, then 6 steps. Every loss must
   be finite; the launch counters, zeroed just before, must show one kernel-4
   forward and one backward per step and no launch of kernels 1-3; kernel
   4's forward and backward outputs in the first of them must match their
   plain versions on the very tensors the step gave them; one step's
   gradients on the bf16 kernel route must stay close to an fp32 step of the
   same weights and batch (plain versions, no kernel) on a small input.
   Then ms/step, img/s, peak memory and the stage split.
7a. attention-kernel train step: the same step with ``attn_impl="kernel"``,
   a warm-up step and 3 counted steps: 10 kernel-5 forward and 9 backward
   launches (nothing reads the cross-attention's object branch), and one
   kernel-4 forward and backward, per step; kernel 5's
   forward and backward and kernel 4's outputs in one recorded step must
   match their plain versions on its tensors, each forward having written
   its residual (the served phases 5a and 8 must write none); the bf16
   gradients must stay
   close to an fp32 plain-route step's; the regressor's and the first image
   attention's gradient errors are logged beside the plain route's (a
   "watch" line). In phases 3, 7a and 8 every kernel-5 backward must take
   the cluster route (``fused_mha_bwd.cluster_launches``);
8. AdaBins-B5 (``params/nyu_adabins_enet-b5.yaml``: 256 bins, 0.001-10 m)
   on kernel 5's route: the server (bf16, BN folded, 480x640) answers 4
   requests of 8 frames with 4 kernel-5, 4 resize and 1 bins launch per
   forward, each output matching its plain version, depth finite and in
   range; then one train step at bs 8, 416x544 with 4 + 4 kernel-5
   launches and one kernel-4 forward and backward, each kernel-5 output
   matching its plain version.
9. validate and predict: the -v/-i entry points through
   ``objcavit_torch.cli.main`` on a reference-layout ``.ckpt`` of a seeded
   random GraphBins-B5 and copies of the flagship's params file (the data
   root points at nothing: the 16 synthetic 480x640 NYU images, with
   basicParams.yaml's Eigen crop). (a) ``-v --bf16`` with the zeros
   provider (300 slots): 16 x 4 kernel-1 concat launches and 16 kernel-2
   launches, the first flip-TTA forward's kernel outputs against their
   plain versions on its own tensors, validation_output.txt read back, the
   per-image latency (wall and CUDA events after a warm-up, and the device's
   busy time from a trace); (a') ``-v`` in fp32 with TF32 off: no launch,
   the 16 metrics within a stated bound of (a)'s; (b) ``-v --debug --bf16``
   on the 'clip' config with random YOLOv7-seg and CLIP towers: the
   provider runs on the image and re-detects its mirror; (c) ``-i --debug
   --bf16`` on it: prediction_metrics.csv's pinned header and every
   per-image file.
10. fit: the train entry point (``cli.main(['-c', cfg, '--bf16'])``, a run
   without -v/-i: ``Trainer.fit``) on a copy of the flagship's params file
   (its nyu section from basicParams.yaml) over 32 train and 16 eval NYU
   frames written in the dataset's layout, the clip provider on random
   towers, warm-started from a .ckpt: (a) 2 epochs of 4 steps (bs 8,
   416x544, the new sampler's rotation and the card's augmentation, 221
   slots): one kernel-4 forward and backward a step, one recorded step's
   against the plain versions; 2 eval steps an epoch (kernel 1's concat
   form 4 and kernel 2 once each, the first held against the plain
   versions) and, where TensorBoard imports, the train figure's forward;
   wall and device ms a step, the idle share, the validation's share; (b)
   --resume to 3 epochs: the same version dir, step 8 -> 12, the rebuilt
   schedule's LRs, AdamW's moments; (c) use_swa, 10 epochs of one step: 2
   averaged, the BN refresh's kernel-4 forward, last.ckpt the refreshed
   average; (d) -v --bf16 on the run's hparams.yaml: it restores the run's
   last.ckpt, and its metrics are within phase 9's bound of the last
   in-fit validation's.
11. model options: ObjCAViT's other options on GraphBins-B5 (``learned``,
   ``grid_random``, ``grid_random_roi_align``, ``learned_bbox_wh`` with
   ``no_obj_sa``, with ``use_2_saca``), each on kernel 5's route: (a) the
   bf16 server (BN folded, 480x640, 300 slots) answers a request of 8 frames
   with detector-style slots and one with the sentinel: kernel 5's forward
   launches as the options give them (``attention_launches``: 10, 6 or 20 a
   forward), 4 kernel-1 concat and 1 kernel-2 launches a forward, each
   kernel's output against its plain version on its own tensors, depth
   finite and in range, ObjCAViT's outputs within the rel L2 bound of an
   fp32 run of the same weights; the served rate and ObjCAViT's stage time;
   (b) one train step at bs 8, 416x544, 221 slots: kernel 5's forward and
   backward launches (every attention but the last SACA's object
   cross-attention has a backward), one kernel-4 forward and backward,
   kernels 5 and 4 against their plain versions, a finite loss; (c) -v
   --debug --bf16 through ``cli.main`` on copies of three of the options'
   params files (random towers, the synthetic NYU images), each writing
   validation_output.txt; and a KITTI grid_random_roi_align model built
   (on the meta device) with its 1872-row table.
12. V2 encoders: GraphBins on EfficientNet-V2-M
   (``params/nyu_graphbins_enet-v2-m_ocv_pos_learned_emb_128_1.yaml``'s
   model: ``learned``, embedding 128) on kernel 5's route: (a) the bf16
   server (BN folded, 480x640, 300 slots) on each encoder route answers 4
   requests of 8 frames: 44 kernel-7 launches a forward on
   ``encoder_impl="kernel"`` (one per MBConv block) and none on the plain
   route, never a kernel-8 launch, 4 kernel-1 concat, 1 kernel-2 and 10
   kernel-5 launches a forward; each kernel's output against its plain
   version on its own tensors, depth finite and in range, the encoder's
   five outputs within phase 5b's rel L2 bound of an fp32 plain run; the
   served rate, p50, peak memory and the encoder's stage time on each
   route; (b) one train step at bs 8, 416x544, 221 slots: 10 + 9 kernel-5
   and 1 + 1 kernel-4 launches, each against its plain version, a finite
   loss; (c) -v --debug --bf16 through ``cli.main`` on copies of that
   params file and of AdaBins-V2-S's
   (``params/nyu_efficientnet-v2-s_clip_0.1_lossfixed.yaml``), each
   writing validation_output.txt.
13. final upscale and drop path: (a) AdaBins-B5 with ``do_final_upscale``
   (``params/nyu_efficientnet-b5_final_upscale_1.yaml``'s model: bf16, BN
   folded, 480x640, full-resolution depth, miniViT over 1200 tokens of a
   1200-row table) on each attention route answers 2 requests of 8 frames:
   per forward kernel 1's concat form 4 times and its bare form once (the
   fifth upsample, whose skip is the image), kernel 2 once, kernel 5's
   forward 4 times on its route (the long forward) and none on the
   plain one; each output against its plain version on its own tensors;
   the served rate, p50, peak memory and a trace's device time and idle
   share; (b) its train step at bs 8, 416x544 on kernel 5's route: 1 + 1
   kernel-4 and 4 + 4 kernel-5 launches, every backward on the long
   route (S 884), each against its plain version, a finite loss; (c) -v
   --debug --bf16 through ``cli.main`` on a copy of that params file; (d)
   GraphBins-B5 with ``do_final_upscale`` on kernel 5's route at 1000
   slots (a sentinel request and one with detector-style slots: kernel
   5's masked long forward against its plain version) and its train
   step at 884 slots (10 + 9 launches); (e) GraphBins-B5 with
   ``drop_path_rate`` 0.2: train-mode losses on one batch (dropout 0, no
   augmentation) equal for one generator seed, another for another seed,
   and equal for both at rate 0; one full train step; the server on
   ``encoder_impl="kernel"`` launches kernels 8 and 7 32 + 7 times a
   forward and gives the depth of the same weights at rate 0 bit for bit.
   Alone: ``import chip_smoke as cs; cs.phase_device(); cs.phase_build();
   cs.phase_final_upscale()``.
14. the host core and profiling: (a) ``objcavit_torch/csrc/preprocess.cpp``,
   which g++ built at first use (phase 10's loader), built again into a scratch
   directory and timed, with the host's CPU; each entry point of
   ``data/native.py`` against its plain numpy version at full sizes (the
   rotations at NYU's 427x565 and KITTI's 352x1216, the augment at
   416x544, ``hflip``, ``assemble_batch`` of 8 at 416x544 and KITTI's
   352x704, bit for bit the core's per-sample path), both timed on the
   host; (b) host ms a batch of 8 from NYU 480x640 and KITTI 375x1242
   frames: the old_dl sampler per sample, ``get_batch`` on one decode
   thread and on one a core (each batch first held bit for bit against the
   per-sample one), the new sampler per sample on the core's rotations and
   on the plain numpy ones; (c) phase 10 (a)'s fit on the flagship's
   old_dl twin (``..._clip_old_dl_1.yaml``): every train batch from
   ``get_batch`` (counted), 8 + 8 kernel-4 launches and kernels 1 and 2 as
   in phase 10, kernel 4's recorded step and the first eval step against
   their plain versions, the step times, the idle share and the second
   epoch's breakdown beside phase 10 (a)'s; (d) ``profiling.trace``
   around 3 of its steps writes a trace holding an ``annotate`` range and
   kernel 4's kernels, and ``device_memory_stats()``'s peak is
   ``torch.cuda.max_memory_allocated``. Alone (after the build):
   ``cs.phase_host_core(cs.phase_fit()["stats"]["epoch"])``.
15. distributed (``objcavit_torch/parallel``): (a) ``cli.main --bf16`` on
   phase 10's data and warm start, 1 epoch of 4 steps, under the OBJCAVIT_*
   env of a world of one over NCCL and without it, both with PyTorch's
   deterministic algorithms: the step's gradient reducer on NCCL, kernel
   4's launches and kernels 1 and 2's in the validation, the two fits'
   parameters, BN statistics and metrics bit for bit, wall ms a step of
   each; (b) two processes on the card over gloo, started by
   ``parallel.launch`` (``python3 chip_smoke.py --dist-rank SPEC``, one a
   rank): ``Trainer(attn_impl="kernel", bf16).fit()`` of GraphBins-B5 at
   global bs 8 (4 a rank), 416x544, 221 clip slots, 1 epoch of 2 steps and
   one validation; each step's 10 + 9 kernel-5 and 1 + 1 kernel-4 launches,
   one recorded launch of each against its plain version, the same losses,
   parameters (a digest) and metrics on both ranks, one version dir whose
   files rank 0 alone wrote; then the first step on one process over the
   same global batch against the ranks' reduced one, by named group: the
   plain route in fp64 within rel L2 1e-5, in fp32 within 2x one
   process's own fp32 distance from fp64 (train-mode BNs magnify where the
   batch sums are cut), the bf16 kernel route's loss within 1e-3 and its
   gradients within the bf16 check's bounds.
   Alone (after the build): ``cs.phase_distributed()``.
16. export (``objcavit_torch/serving_export.py``): three servers exported
   on the card (``export_pipeline``, ``save_artifact``; each export's
   seconds and its program's and weights' bytes printed): (a) the flagship
   on kernel 5's route and kernels 7 and 8's, bs 8 (kernel 1's concat form,
   2, 5 up to 512 keys, 7 and 8); (b) the fused server on the plain routes
   with the class-max head, bs 8 (kernel 6 and the ``torch.while_loop``
   NMS in the program); (c) AdaBins-B5 with do_final_upscale on kernel 5's
   route, bs 1 (its long route at S 1200, kernel 1's bare form, kernel 2 at
   full resolution). Each eager server answers one counted request, and
   each graph's ``objcavit::`` ops must be its launches. Then one fresh
   process (``python3 chip_smoke.py --load-artifacts SPEC``, which stops
   before this script's imports of the model code) loads the three with
   ``ServingArtifact`` and must import no model, server or JAX module,
   give each eager depth bit for bit (else name the first kernel launch
   whose inputs or outputs differ, ``first_difference``, and hold the depth
   within phase 9's bound), and launch what eager launched; served img/s,
   p50 and one trace's device time and idle share of artifact and eager
   side by side. Alone (after the build): ``cs.phase_export()``.

17. tensor parallelism (``objcavit_torch/parallel/tp.py``): two processes
   on the card over gloo (``python3 chip_smoke.py --tp-rank SPEC`` each,
   through ``parallel.launch``) as a 1 x 2 process grid, the flagship's
   attention stacks split over its model axis (2 of 4 heads and 512 of 1024
   FFN columns a rank), then one process for reference: (a) the server on
   kernel 5's route and kernels 7 and 8's, bf16, BN folded, 480x640, 300
   slots, bs 8: 10 kernel-5 launches a request on each rank at B 8, H 2
   (the first request's held against the plain version), 32 + 7 of kernels
   8 and 7, 4 of kernel 1's concat form and 1 of kernel 2; the depth bit
   for bit on both ranks and within ``TP_SERVE_REL`` of one process's; (b)
   the flagship step at bs 8, 416x544, 221 slots: the first step's gathered
   gradients against one process's on the same batch and draws, in fp64 on
   the plain route and in bf16 on kernel 5's route (``TP_STEP_BOUNDS``),
   then 3 bf16 steps, 10 + 9 kernel-5 and 1 + 1 kernel-4 launches each on
   each rank, the split parameters' shapes kept through the updates; (c)
   wall ms a request and a step of the ranks beside one process's, a
   one-card gloo time. Alone (after the build): ``cs.phase_tp()``.

18. spatial serving (``objcavit_torch/parallel/spatial.py``), in phase 17's
   two ranks: the flagship (attention replicated) on kernel 5's route and
   kernels 7 and 8's as a 1 x 2 grid's ``DepthPipeline(spatial=True)``:
   bands of 256 and 224 of the 480 rows, (a) bs 1 and (b) bs 8, each
   request 4 launches of kernel 1's row-window form (in its concat layout),
   32 of kernel 8's halo form, 7 of kernel 7, 10 of kernel 5 at (B, 4
   heads) on the gathered tokens and 1 of kernel 2 on each rank, the first
   request's launches of the two new forms and of kernel 5 held against
   their plain versions; the depth bit for bit on both ranks and within
   ``TP_SERVE_REL`` of one process's server on the same frames; (c) wall ms
   a request of the ranks beside one process's, a one-card gloo time;
   AdaBins-B5 served spatially at bs 1 (4 kernel-5 launches) against one
   process's. Phase 3 times both new forms at rank 0's band shapes
   (``check_row_window_kernels``). Alone (after the build): ``cs.phase_tp()``.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import functools
import hashlib
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import bins_expectation as kexp
from objcavit_torch.kernels import build
from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.kernels import se_project as kse
from objcavit_torch.utils import profiling

COUNTERS = {
    "resize": kresize.resize_bilinear_align_corners,  # either form of kernel 1
    "resize_rows": kresize.resize_bilinear_align_corners_rows,  # its row-window form
    "bins": kbins.conv_bins_depth_batched,
    "bins_shared": kbins.conv_bins_depth,
    "bins_expectation_fwd": kexp.bins_expectation_fwd,
    "bins_expectation_bwd": kexp.bins_expectation_bwd,
    "detect_head": kdetect.fused_detect_head,
    "attention_fwd": kattn.fused_mha_fwd,
    "attention_bwd": kattn.fused_mha_bwd,
    "se_project": kse.se_gate_project,
    "mbconv_head": kmb.mbconv_expand_dw_pool,
    "mbconv_rows": kmb.mbconv_expand_dw_pool_rows,  # kernel 8's halo form
    "mbconv_bs": kmb.mbconv_bs_expand_dw_pool,
    "dw_conv": kmb.dw_conv_silu_pool,
}


def log(msg: str) -> None:
    print(msg, flush=True)


# the backward's launches on its cluster route (one launch a call; longer
# sequences take the long route): every backward on the main paths
# (S 132 to 300) must take it
CLUSTER_COUNTER = "attention_bwd_cluster"
# kernel 1's launches in its concat form: every served upsample takes it
# (the decoder writes its concat buffers), unless a phase says otherwise
CONCAT_COUNTER = "resize_concat"


def zero_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    kattn.fused_mha_bwd.cluster_launches = 0
    kresize.resize_bilinear_align_corners.concat_launches = 0
    kresize.resize_bilinear_align_corners_rows.concat_launches = 0


def read_counters() -> dict:
    return {**{name: fn.launches for name, fn in COUNTERS.items()},
            CLUSTER_COUNTER: kattn.fused_mha_bwd.cluster_launches,
            CONCAT_COUNTER: kresize.resize_bilinear_align_corners.concat_launches}


LOADER_FLAG = "--load-artifacts"


def load_artifacts(spec_path: str) -> None:
    """Phase 16's loading process (``chip_smoke.py --load-artifacts SPEC``):
    each artifact the spec names is loaded by ``ServingArtifact`` alone and
    run on the parent's frames; what it saw goes to the spec's ``out`` file:
    the depth against the parent's eager depth, one request's kernel
    launches, the seconds to load and to run the first request, the served
    rate and p50, one trace's device time and idle share, and the modules of
    the model code, the servers or JAX that this process imported (none may
    be). TF32 is off, as in the parent."""
    from objcavit_torch.serving_export import ServingArtifact

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"cases": {}}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        art = ServingArtifact.load(case["dir"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        io_ = torch.load(case["io"], map_location="cuda", weights_only=True)
        frames, want = io_["frames"].cpu(), io_["depth"]
        zero_counters()
        t0 = time.perf_counter()
        depth = art(frames)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counters()
        diff = (depth.float() - want.float()).abs()
        rate = profiling.served_rate(art, [frames], n_req=case["requests"], n_lat=case["latencies"])
        traced = profiling.trace_calls(lambda: art(frames), n_req=3)
        traced.pop("top")
        out["cases"][case["name"]] = {
            "equal": bool(torch.equal(depth, want)), "max_abs_diff": float(diff.max()),
            "out_of_bound": int((diff > case["atol"] + case["rtol"] * want.abs()).sum()),
            "shape": list(depth.shape), "dtype": str(depth.dtype), "launches": launches,
            "load_s": load_s, "first_s": first_s, "rate": rate, "trace": traced}
        print(json.dumps({"loaded": case["name"], "load_s": round(load_s, 3),
                          "equal": out["cases"][case["name"]]["equal"]}), flush=True)
        del art, depth, want, io_
        torch.cuda.empty_cache()
    out["modules"] = sorted(m for m in sys.modules if m == "objcavit_torch.serving"
                            or m.startswith(("objcavit_torch.models", "objcavit_tpu", "jax")))
    with open(spec["out"], "w") as f:
        json.dump(out, f)


# the loading process stops here, before the imports of the model code below
if __name__ == "__main__" and sys.argv[1:2] == [LOADER_FLAG]:
    load_artifacts(sys.argv[2])
    sys.exit(0)

import torch.nn.functional as F  # noqa: E402
import yaml  # noqa: E402

import objcavit_torch.training.loop as eval_loop
from objcavit_torch import cli
from objcavit_torch.losses import LossWrapper
from objcavit_torch.models.yolov7 import n_anchors
from objcavit_torch.ops.bins import bins_head_depth
from objcavit_torch.ops.resize import interp_taps
from objcavit_torch.utils.mbconv_ab import DW_CASES, MBCONV_SHAPES, cudnn_depthwise, mbconv_bound
from objcavit_torch.utils.resize_se_ab import RESIZE_SHAPES, SE_SHAPES
from objcavit_torch.serving_export import (
    ServingArtifact,
    export_pipeline,
    graph_ops,
    save_artifact,
)
from objcavit_torch.serving import (
    DepthPipeline,
    FusedDepthPipeline,
    build_adabins_pipeline,
    build_flagship_pipeline,
    build_fused_flagship,
    image_seq_len,
)
from objcavit_torch.data import native
from objcavit_torch.data import preprocess as pp
from objcavit_torch.language.provider import YoloClipObjectProvider
from objcavit_torch.metrics import METRIC_NAMES
from objcavit_torch.models.layers import MultiHeadAttention, TransformerEncoderLayer
from objcavit_torch.parallel import make_grid, tp_gather_state_dict, tp_shard_model
from objcavit_torch.parallel.collectives import GradientReducer
from objcavit_torch.parallel.tp import tp_specs
from objcavit_torch.parallel.distributed import (
    initialize_distributed,
    process_index,
    rank_device,
    shutdown_distributed,
)
from objcavit_torch.parallel.launch import free_port, launch
from objcavit_torch.training import checkpoint as ckpt_module
from objcavit_torch.training.checkpoint import checkpoint_dict
from objcavit_torch.training.optim import build_optimizer
from objcavit_torch.training.steps import build_model, make_train_loss_fn
from objcavit_torch.utils.attention_ab import SERVED_VALID, attention_inputs, bwd_cost
from objcavit_torch.utils.attention_ab import fwd_bound as attn_fwd_bound
from objcavit_torch.utils.bins_ab import bins_cost, max_sm_mhz, sfu_ms
from objcavit_torch.utils.benchkit import (
    TRAIN_LOSSES,
    build_adabins_model,
    build_adabins_train,
    build_detector,
    build_flagship_model,
    build_flagship_train,
    init_weights_,
)
from objcavit_torch.utils.kernel_io import (
    attention_plain_outputs,
    attention_cancelling_terms,
    bins_expectation_plain_outputs,
    bins_operands,
    detect_head_errors,
    exact_fold_units,
    mbconv_head_errors,
    plain_outputs,
    record_attention_io,
    record_bins_expectation_io,
    record_detect_head_io,
    record_encoder_kernel_io,
    record_kernel_io,
    record_resize_rows_io,
    resize_rows_errors,
    se_project_errors,
    share_edge_grids,
    skip_mismatches,
)
from objcavit_torch.utils.profile_stages import (
    fused_stage_split,
    route_split,
    served_rate,
    stage_split,
    trace,
    train_stage_split,
)

BATCH = 8
EVAL_DIMS = (480, 640)
# RESIZE_SHAPES (the flagship's decoder upsamples at 480x640, with their
# skips' channels) and SE_SHAPES (kernel 7's) come from utils/resize_se_ab.py
BINS_SHAPE = (BATCH, 240, 320, 128)  # decoder features at half resolution
TRAIN_DIMS = (416, 544)
TRAIN_SLOTS = 221  # min(max_det 1000, the 13 x 17 image tokens at 416x544)
# kernel 4's logits at the train step: (B, 208 x 272 pixels, 256 bins)
EXP_SHAPE = (BATCH, (TRAIN_DIMS[0] // 2) * (TRAIN_DIMS[1] // 2), 256)
# kernel vs plain: both lerp in fp32 and round to bf16 once, but the kernel's
# FMAs round differently from the plain version's separate multiply and add,
# so a value next to a bf16 rounding boundary may land one bf16 ulp
# (<= 2^-7 relative) away
RESIZE_RTOL, RESIZE_ATOL = 2.0 ** -7, 1e-5
# both sum the same bf16-exact products in fp32 (128 terms, other order) and
# the kernel's exp is __expf: a few fp32 ulps of the depth
BINS_RTOL, BINS_ATOL = 1e-5, 1e-5
# kernel 4 vs plain. Forward: fp32 sums of 256 terms in another order and
# __expf, as kernel 2. Backward: dlogits is rounded to bf16 on both sides,
# so two fp32 values a few ulps apart may round one bf16 ulp (<= 2^-7
# relative) apart, and p (c - depth) g carries the forward's depth error
# (<= 1e-4 m at 10 m) times |g|; dcenters sums p g over 56,576 rows per
# image in another order (block partials vs PyTorch's reduction)
EXP_RTOL, EXP_ATOL = 1e-5, 1e-5
DLOGITS_RTOL, DLOGITS_ATOL_PER_G = 2.0 ** -7, 1e-4
DCENTERS_RTOL, DCENTERS_ATOL_PER_MAX = 1e-4, 1e-5
# kernel 6 at the fused server's levels, (B, S, Cin): NYU 480x640's three,
# then KITTI 352x1216's three; 1203 classes, 32 mask coefficients
DETECT_SHAPES = {"NYU 480x640": [(BATCH, 4800, 256), (BATCH, 1200, 512), (BATCH, 300, 1024)],
                 "KITTI 352x1216": [(BATCH, 6688, 256), (BATCH, 1672, 512), (BATCH, 418, 1024)]}
NUM_CLASSES, NM = 1203, 32
# kernel 6 on grids whose shares start or end at a row tile's edge
# (share_edge_grids): NYU level 0 and a small shape, (B, S, Cin, nc)
DETECT_EDGE_SHAPES = [(BATCH, 4800, 256, NUM_CLASSES), (3, 111, 256, 130)]
# kernel 6 vs plain: both round fp32 sums of the same bf16 products (Cin
# terms, other order) plus the fp32 bias to bf16 once, so a value next to a
# rounding boundary may land one bf16 ulp (<= 2^-7 relative) away; beside
# that, kernel_io.detect_head_errors allows the fp32 accumulation bound of
# the sum (Cin 2^-23 sum |x w|) and checks the argmax tie-aware
DETECT_RTOL, DETECT_ATOL = 2.0 ** -7, 1e-5
KITTI_DIMS, KITTI_SLOTS = (352, 1216), 418  # 11 x 38 image tokens
# the detector's y5 and coef, bf16 kernel route vs the same weights in fp32
# (plain versions, no TF32), rel L2 on 2x384x352: bf16 keeps 8 bits
# through ~100 conv layers; the random detector is built in SiLU's
# near-linear range (benchkit.DETECTOR_BN_AFFINE), where the CPU measures
# 0.013-0.016 at 2x128x160 (GraphBins' features: 0.003 on an H100); 0.1
# still fails a wrong or missing head (rel L2 ~1)
DETECT_REL_BOUND = 0.1
# the served depth must spread over at least this many bins tolerances, or
# the bins check on served tensors could not tell a right depth from a flat one
MIN_SPREAD_IN_TOLERANCES = 10
# bf16 model vs the same weights in fp32, on the card: bf16 keeps 8
# significant bits (2^-9 relative rounding) through ~100 layers. Measured on
# an H100: rel L2 0.0030 on ObjCAViT's image features, 0.0069 on its queries
FEATURE_REL_BOUND = 0.02
# one train step's gradients, bf16 kernel route vs fp32 plain route, rel L2
# per named group. The deep groups sit behind train-mode BatchNorms, whose
# backward subtracts the batch mean of the incoming gradient and so
# magnifies its bf16 rounding: on the CPU, at efficientnet-tiny, JAX's own
# bf16 step lands 0.006 (conv_out), 0.018 (regressor), 0.42 (decoder.conv2)
# and 0.21 (stem) from its fp32 step (tests/test_torch_train.py); at B5 on
# an H100 the port measured 0.011, 0.019, 0.70 and 0.71. The deep groups'
# bound of 0.9 still fails a missing gradient (1.0) or a flipped one (2.0).
TRAIN_GRAD_GROUPS = {
    "conv_out": (("conv_out.",), 0.05),
    # the first image self-attention's projections, what kernel 5's backward
    # feeds. Measured on an H100 on the seed's weights: 0.148 on kernel 5's
    # route, 0.112 on the plain route, which rounds the weights to bf16
    # before the product with V (JAX's own rounding point); a missing
    # gradient gives 1.0, a flipped one 2.0
    "image attention 0": (("objcavit.saca_1.image_transformer_encoder.layers.0.self_attn.",),
                          0.3),
    # the bins regressor's: its upstream gradient partly cancels, so bf16's
    # rounding shows more or less with the weights. Measured on an H100 at
    # 0.015-0.158 across the states a few training steps reach (0.158 failed
    # a bound of 0.1); the check now runs on the seed's weights, where it is
    # reproducible. A missing gradient gives 1.0, a flipped one 2.0
    "regressor": (("objcavit.regressor.",), 0.3),
    "decoder.conv2": (("dense_feature_extractor.decoder.conv2.",), 0.9),
    "encoder stem": (("dense_feature_extractor.encoder.original_model.conv_stem.",
                      "dense_feature_extractor.encoder.original_model.bn1."), 0.9),
}
# kernel 5 vs plain: both take the fp32 products of the same bf16 values, an
# fp32 softmax and fp32 weights (the kernel's split in two bf16 terms keeps
# ~16 bits of each), and round to bf16 once; sums run in another order and
# the kernel's exp is __expf, so a value next to a bf16 rounding boundary
# may land one bf16 ulp (<= 2^-7 relative) away, and a gradient entry that
# cancels (ds sums to zero over the keys) misses by a few fp32 ulps of the
# tensor's largest entry: atol 1e-4 max|plain|
ATTN_RTOL, ATTN_ATOL_PER_MAX = 2.0 ** -7, 1e-4
ATTN_HEADS, HEAD_DIM = 4, 32
# phase 11's backward outputs: an output that cancels as a whole has no
# large entry to scale atol by. Under use_2_saca the second SACA's layer-0
# inputs are the first SACA's cross-attention averages, nearly equal over
# the rows at random weights, so the keys are nearly equal, ds = P (dP - D)
# ~ 0 and all of dq is ~1e-11 of rounding noise (an H100 read it 1 fp32 ulp
# of its terms from the plain version's). Where an output's largest entry
# is under one bf16 ulp of the largest term it sums
# (kernel_io.attention_cancelling_terms; the tiny GraphBins' step on the
# CPU read 2e-6 to 3e-3 of it on 8 outputs under use_2_saca, 4 under both
# options and none under the other options), atol is 16 fp32 ulps of that
# term, at most 2.5x the old 1e-4 max|plain| on an output just under the
# line; every other output keeps the check of phases 5 and 7
ATTN_TERM_ULPS = 2.0 ** -19
# a flagship train step runs 10 attention forwards and 9 backwards: the
# output of the cross-attention's object branch (cross_attn_im_obj) is
# discarded, as in the reference, so autograd never runs its backward
ATTN_BWD_PER_STEP = 9
# (label, B, Sq, Sk, mask): the served self-attention at 480x640 with the
# served objects' masks, the train step's S, the longest S JAX states
# (do_final_upscale), Sq != Sk, and image 0 fully masked
ATTN_CASES = [("flagship 480x640", BATCH, 300, 300, "served"),
              ("train 416x544", BATCH, 221, 221, "served"),
              ("S 1200", 2, 1200, 1200, "none"),
              ("Sq != Sk", BATCH, 300, 77, "served"),
              ("fully masked rows", BATCH, 300, 300, "full"),
              # ObjCAViT under do_final_upscale: 1200 image tokens against
              # 1000 masked object slots (the long forward and backward)
              ("final upscale 1200x1000", BATCH, 1200, 1000, "served")]
GRAPH_CALLS = 20  # kernel 5's calls in one timed CUDA graph
# phase 13, do_final_upscale: the fifth upsample's input (B, Hi, Wi, C) and
# output size, whose skip is the 3-channel image (kernel 1's bare form, then
# torch.cat); kernel 2 at full resolution; kernel 4 at the full-resolution
# train step; kernel 5 at miniViT's tokens, served (S 1200) and trained
# (S 884), both on its long routes
FU_RESIZE = (BATCH, 240, 320, 128, *EVAL_DIMS)
FU_BINS_SHAPE = (BATCH, *EVAL_DIMS, 128)
FU_EXP_SHAPE = (BATCH, TRAIN_DIMS[0] * TRAIN_DIMS[1], 256)
FU_TOKENS, FU_TRAIN_TOKENS = 1200, 884
# kernel 8 at B5's stride-1 MBConv blocks at 480x640 (MBCONV_SHAPES: H, W,
# k, Cin, M, blocks of that shape in a forward; 32 blocks) and its bound
# (mbconv_bound) come from the kernel's profiler, utils/mbconv_ab.py
MBCONV_BS_SHAPES = [MBCONV_SHAPES[0], MBCONV_SHAPES[5]]  # kernel 9: stages 1 and 5
# kernel 10's cases (DW_CASES: H, W, k, C, with the pool) come from
# utils/mbconv_ab.py, its profiler
# kernels 7-10 vs plain: one bf16 ulp, plus what kernel_io's checks add: the
# fp32 accumulation bound of the Cin- or M-term sum (and of the k^2-term
# depthwise), the expanded band's elements within that bound of a bf16
# rounding boundary (each may round one ulp apart), SiLU's slope and
# __expf's error; the pool, an fp32 sum of H x W values in another order
# (kernel 8's longest chain of adds is 26 + 5 + the tile count, at most 186
# adds here, ~1.1e-5 of sum |y|; kernel 10's a lane's outputs of an item, at
# most 60 x 10 at B5's shapes, then the warps and the items, ~3.6e-5), is
# held to 1e-4 sum |y| plus those bounds
MB_RTOL, MB_ATOL, POOL_RTOL = 2.0 ** -7, 1e-5, 1e-4
# the encoder's five outputs, bf16 on the kernel route vs the same weights
# in fp32 on the plain route, rel L2 on 2x384x352: bf16 keeps 8 bits through
# 39 blocks (the bf16 plain route is logged beside it)
ENCODER_REL_BOUND = 0.03
MBCONV_PER_FORWARD, SE_PROJECT_PER_FORWARD = 32, 7
# kernel 7 at EfficientNet-V2-M's MBConv shapes that SE_SHAPES lacks, at
# 480x640: (H, W, M, O, skip, launches in a V2-M forward): stage 3's first
# block (80 -> 160, stride 2) and its six others (160 -> 160, the skip),
# stage 4's first (160 -> 176) and its 13 others (176 -> 176), stage 5's 17
# after its first (304 -> 304) and stage 6's first (304 -> 512). With
# SE_SHAPES' 1056 -> 304 (stage 5's first) once and 3072 -> 512 (stage 6's
# others) four times they are V2-M's 44 launches
V2M_SE_SHAPES = [(30, 40, 320, 160, False, 1), (30, 40, 640, 160, True, 6),
                 (30, 40, 960, 176, False, 1), (30, 40, 1056, 176, True, 13),
                 (15, 20, 1824, 304, True, 17), (15, 20, 1824, 512, False, 1)]
V2M_FROM_SE_SHAPES = {(15, 20, 1056, 304, False): 1, (15, 20, 3072, 512, True): 4}
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/ms, and dense
# operations/ms on the tensor cores in bf16 and on the CUDA cores in fp32
HBM_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_OPS_PER_MS = {"bf16": 989e12 / 1e3, "fp32": 67e12 / 1e3}
# phase 9: the -v/-i entry points on the flagship's params file, with
# params/basicParams.yaml's dataset sections (NYU: Eigen crop, 480x640);
# the data root points at nothing, so the 16 synthetic NYU images are used
REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_PARAMS = os.path.join(
    REPO, "params", "nyu_graphbins_enet-b5_ocv_pos_learned_bbox_wh_emb_128_lang_name_synset_def_"
    "wn_rel_sz_clip_1.yaml")
BASIC_PARAMS = os.path.join(REPO, "params", "basicParams.yaml")
VALIDATE_IMAGES = 16
# conv_out's random weights times this: with PyTorch's default init the
# depth of a random model spreads over ~1 mm; the CPU tests scale by 10 too
EVAL_LOGIT_SCALE = 10.0
# kernel launches of one eval forward: kernel 1's concat form at the four
# up-stages, kernel 2 once
EVAL_RESIZE, EVAL_BINS = 4, 1
# the 16 metrics of the bf16 validate (kernels) vs the fp32 one (plain
# versions, TF32 off) on the same checkpoint and images: bf16 keeps 8 bits
# and ObjCAViT's outputs stay within 0.02 rel L2 of fp32 (FEATURE_REL_BOUND),
# so each metric, a mean over ~1.7M pixels of a smooth function of the
# depth (or a fraction of pixels under a threshold), moves by at most 2% of
# its value, plus 1e-3 for the threshold fractions near 0
EVAL_METRIC_RTOL, EVAL_METRIC_ATOL = 0.02, 1e-3
NUMBER = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    max_abs = float(err.max())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements out of tolerance, max abs err {max_abs}")
    return max_abs


def expect_launches(what: str, **want: int) -> dict:
    got = read_counters()
    want = {**{name: want.get(name, 0) for name in COUNTERS},
            CLUSTER_COUNTER: want.get(CLUSTER_COUNTER, want.get("attention_bwd", 0)),
            CONCAT_COUNTER: want.get(CONCAT_COUNTER, want.get("resize", 0))}
    log(f"  {what}: launches {got}")
    if got != want:
        raise AssertionError(f"{what}: want launches {want}, got {got}")
    return got


def time_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_times(kernel, plain, iters: int = 20, rounds: int = 6) -> tuple[float, float]:
    """Median ms per call of each, timed in turns (plain, kernel, kernel, plain, ...)."""
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for r in range(rounds):
        pair = [(kernel, tk), (plain, tp)]
        for fn, out in (pair if r % 2 else pair[::-1]):
            out.append(time_ms(fn, iters))
    return statistics.median(tk), statistics.median(tp)


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    out = build.build(ptxas_verbose=True)
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({build.LIB_PATH.name})")
    for line in out.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
    log_ptxas(out)


# kernels whose ptxas registers and spills get a line of their own: the
# label, the mangled name's pattern and how its template arguments read
PTXAS_KERNELS = (("kernel 1", r"resize_kernelILi(\d+)E", "CV {}"),
                 ("kernel 2", r"conv_bins_depth_kernelILi(\d+)E", "KSTEPS {}"),
                 ("kernel 5 forward", r"attn_fwd_resident_kernelE", "resident"),
                 ("kernel 5 cluster backward", r"attn_bwd_cluster_kernelE", "cluster"),
                 ("kernel 5 long forward", r"attn_fwd_long_kernelE", "long"),
                 ("kernel 5 long backward", r"attn_bwd_(long|rowsum)_kernelE", "{}"),
                 ("kernel 7", r"se_project_kernelILi(\d+)ELi(\d+)E", "MT {} NT {}"),
                 ("kernel 8", r"mbconv_kernelILi(\d)ELi(\d)E", "k{} row tiles {}"),
                 ("kernel 10", r"dw_silu_pool_kernelILi(\d)E", "k{}"))


def log_ptxas(out: str) -> None:
    """One line per kernel of PTXAS_KERNELS: each instantiation's registers
    and spills, as ptxas reported them."""
    for label, pattern, fmt in PTXAS_KERNELS:
        name, found, spills = None, [], ""
        for line in out.splitlines():
            if "Compiling entry" in line:
                m = re.search(pattern, line)
                name = fmt.format(*m.groups()) if m else None
            elif name and "spill stores" in line:
                spills = line.strip()
            elif name and "Used" in line and "registers" in line:
                found.append(f"{name}: {line.split('Used')[1].split(',')[0].strip()}, {spills}")
                name = None
        log(f"{label} ptxas: " + ("; ".join(found) if found else "not reported"))


def bound(nbytes: float, bf16: float = 0.0, fp32: float = 0.0) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over its
    memory rate and the operations' time, ``bf16`` on the tensor cores and
    ``fp32`` on the CUDA cores. The two units run at once, so the operations
    take the larger of their two times, not the sum."""
    by_bytes = nbytes / HBM_BYTES_PER_MS
    by_ops = max(bf16 / PEAK_OPS_PER_MS["bf16"], fp32 / PEAK_OPS_PER_MS["fp32"])
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def total_of(parts: list[tuple[int, dict]], err: float) -> dict:
    """A kernel's entry over several shapes: ``weight`` launches of each
    part's times and bound summed (None where no part has the time), labelled
    by what bounds the larger share of the summed bound."""
    total = {"max_abs_err": err}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        times = [w * part[key] for w, part in parts if part.get(key) is not None]
        total[key] = sum(times) if times else None
    by_ops = sum(w * part["bound_ms"] for w, part in parts if part["bound_by"] == "operations")
    total["bound_by"] = "operations" if 2 * by_ops > total["bound_ms"] else "bytes"
    return total


def captured(fn, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph. A replay runs
    them back to back with no host work between, so events around it time
    the card alone; a call of tens of microseconds, as kernel 5's, is
    otherwise timed at the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capturing stream, as capture asks
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def library_time(fn, iters: int = 20, rounds: int = 3) -> float:
    """Median ms per call of one PyTorch call, the kernel's yardstick."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(time_ms(fn, iters) for _ in range(rounds))


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    resize, resize_err, concat, concat_err, old_route = [], 0.0, [], 0.0, 0.0
    for hi, wi, c, ho, wo, cs in RESIZE_SHAPES:
        x = torch.randn((BATCH, hi, wi, c), generator=g, device=dev).to(torch.bfloat16)
        kernel = lambda: kresize.resize_bilinear_align_corners(x, ho, wo)  # noqa: E731
        plain = lambda: kresize.resize_bilinear_align_corners_plain(x, ho, wo)  # noqa: E731
        err = check_close(f"resize {(hi, wi, c)}->{(ho, wo)}", kernel(), plain(),
                          RESIZE_RTOL, RESIZE_ATOL)
        ms, plain_ms = graph_times(kernel, plain)
        lib_ms = library_time(lambda: F.interpolate(x.permute(0, 3, 1, 2), size=(ho, wo),
                                                    mode="bilinear", align_corners=True))
        # bytes: the input read once, the output written once; 3 lerps of
        # 2 fp32 operations an output element
        part = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                **bound(2 * BATCH * c * (hi * wi + ho * wo), fp32=6 * BATCH * c * ho * wo)}
        log(f"kernel resize ({BATCH},{hi},{wi},{c})->({ho},{wo}): max_abs_err {err} "
            f"(rtol 2^-7, atol 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA-graph "
            f"replays), F.interpolate {lib_ms:.4f} ms, bound {part['bound_ms']:.4f} ms")
        resize_err = max(resize_err, err)
        resize.append((1, part))

        # the concat form, as the decoder runs it, beside its plain version
        # (resize, then torch.cat) and the route it replaced (the bare kernel,
        # then torch.cat); no one PyTorch call computes it: library_ms null
        skip = torch.randn((BATCH, ho, wo, cs), generator=g, device=dev).to(torch.bfloat16)
        kernel = lambda: kresize.resize_bilinear_align_corners_into_concat(x, skip)  # noqa: E731
        plain = lambda: kresize.resize_into_concat_plain(x, skip)  # noqa: E731
        bare_cat = lambda: torch.cat(  # noqa: E731
            [kresize.resize_bilinear_align_corners(x, ho, wo), skip], -1)
        got = kernel()
        err = check_close(f"resize into concat {(hi, wi, c)}->{(ho, wo)} + {cs}", got[..., :c],
                          kresize.resize_bilinear_align_corners_plain(x, ho, wo),
                          RESIZE_RTOL, RESIZE_ATOL)
        if not torch.equal(got[..., c:].view(torch.int16), skip.view(torch.int16)):
            raise AssertionError(f"resize into concat {(hi, wi, c)}: the skip slice is not the skip")
        ms, plain_ms = graph_times(kernel, plain)
        _, cat_ms = graph_times(kernel, bare_cat)
        part = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                **bound(2 * BATCH * (c * hi * wi + cs * ho * wo + (c + cs) * ho * wo),
                        fp32=6 * BATCH * c * ho * wo)}
        log(f"kernel resize into concat ({BATCH},{hi},{wi},{c})->({ho},{wo}) + skip {cs}: "
            f"max_abs_err {err}, skip bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bare kernel + torch.cat {cat_ms:.4f} ms, bound {part['bound_ms']:.4f} ms")
        concat_err = max(concat_err, err)
        concat.append((1, part))
        old_route += cat_ms
        del x, skip, got

    bare, cat = total_of(resize, resize_err), total_of(concat, concat_err)
    log(f"kernel 1 a forward (4 launches): bare {bare['ms']:.4f} ms (bound "
        f"{bare['bound_ms']:.4f}); concat form {cat['ms']:.4f} ms (bound {cat['bound_ms']:.4f}), "
        f"plain {cat['plain_ms']:.4f} ms, bare kernel + torch.cat {old_route:.4f} ms")

    b, h, w, c = BINS_SHAPE
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=g, device=dev)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=g, device=dev)
    centers = torch.sort(0.001 + 10 * torch.rand((b, 256), generator=g, device=dev), dim=1).values
    kernel = lambda: kbins.conv_bins_depth_batched(x, wts, bias, centers)  # noqa: E731
    plain = lambda: kbins.conv_bins_depth_batched_plain(x, wts, bias, centers)  # noqa: E731
    first = kernel()
    err = check_close("bins", first, plain(), BINS_RTOL, BINS_ATOL)
    if not torch.equal(first, kernel()):
        raise AssertionError("bins: two calls of kernel 2 differ")
    ms, plain_ms = graph_times(kernel, plain)
    # x, the weights, bias and centres read once, fp32 depth written once;
    # the (B, S, C) x (C, 256) products on the tensor cores
    # (bins_ab.bins_cost). No one PyTorch call computes conv, softmax and
    # expectation together: library_ms null. The exps, one a logit, are
    # logged beside the bound, with their time on the SFU alone
    cost = bins_cost(b, h * w, c, shared_w=False)
    bins_bound = bound(cost["bytes"], bf16=cost["flops"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    log(f"kernel bins {BINS_SHAPE}: max_abs_err {err} (rtol 1e-5, atol 1e-5), two calls "
        f"bitwise equal; kernel {ms:.5f} ms, plain {plain_ms:.4f} ms (CUDA-graph replays), bound "
        f"{bins_bound['bound_ms']:.5f} ms ({bins_bound['bound_by']}); {cost['exps']} exps, "
        f"{sfu_ms(cost['exps'], n_sm, mhz):.5f} ms on the SFU alone (16 ex2 a clock an SM at "
        f"{mhz:.0f} MHz)")
    out = {"resize": total_of(resize, resize_err), "resize_concat": total_of(concat, concat_err),
           "bins": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **bins_bound}}

    shared = wts[0].contiguous()  # one (C, 256) weight for the batch
    kernel = lambda: kbins.conv_bins_depth(x, shared, bias, centers)  # noqa: E731
    plain = lambda: kbins.conv_bins_depth_plain(x, shared, bias, centers)  # noqa: E731
    err = check_close("bins shared W", kernel(), plain(), BINS_RTOL, BINS_ATOL)
    ms, plain_ms = graph_times(kernel, plain)
    cost = bins_cost(b, h * w, c, shared_w=True)
    shared_bound = bound(cost["bytes"], bf16=cost["flops"])
    log(f"kernel bins, shared W (kernel 3) {BINS_SHAPE}: max_abs_err {err} (rtol 1e-5, "
        f"atol 1e-5); kernel {ms:.5f} ms, plain {plain_ms:.4f} ms (CUDA-graph replays), bound "
        f"{shared_bound['bound_ms']:.5f} ms; {cost['exps']} exps, "
        f"{sfu_ms(cost['exps'], n_sm, mhz):.5f} ms on the SFU alone")
    out["bins_shared"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": None, **shared_bound}
    del x, wts
    out.update(check_bins_expectation(g, dev))
    out["detect_head"] = check_detect_head(g, dev)
    out.update(check_attention(g, dev))
    out.update(check_encoder_kernels(g))
    out.update(check_final_upscale_kernels(g, dev, out.pop("attention_long")))
    out.update(check_row_window_kernels(g))
    return out


def band_rows(rows: int) -> tuple[int, int]:
    """Rank 0's rows [0, hi) at a level of ``rows`` rows of the 480: its
    band of SPATIAL_BANDS' first 256."""
    return 0, rows * SPATIAL_BANDS[0][1] // EVAL_DIMS[0]


def check_row_window_kernels(gen) -> dict:
    """Phase 18's two new kernel forms at rank 0's band shapes (the 256 top
    rows of 480), batch 8, each against its plain version and timed beside
    it as CUDA-graph replays, with its bound (bytes over 3.35 TB/s, or its
    operations): kernel 1's row-window form at the four upsamples (the whole
    low-resolution input, the band's output rows beside the skip's band:
    the input rows its taps reach read once, the skip band read and the
    window written once) and kernel 8's halo form at the eight shapes of the
    32 stride-1 MBConv blocks (the band and the k // 2 rows below it read
    once, the band's y written once; the expand's products on the halo rows
    too). No one PyTorch call computes either: library_ms null."""
    rows, err_rows = [], 0.0
    for hi, wi, c, ho, wo, cs in RESIZE_SHAPES:
        y0, y1 = band_rows(ho)
        x = torch.randn((BATCH, hi, wi, c), generator=gen, device="cuda").to(torch.bfloat16)
        skip = torch.randn((BATCH, y1 - y0, wo, cs), generator=gen,
                           device="cuda").to(torch.bfloat16)
        kernel = lambda: kresize.resize_bilinear_align_corners_rows(  # noqa: E731
            x, ho, wo, y0, y1, skip)
        plain = lambda: kresize.resize_rows_plain(x, ho, wo, y0, y1, skip)  # noqa: E731
        record = {"args": (x, ho, wo, y0, y1, skip), "out": kernel()}
        errs = resize_rows_errors(record)
        if errs["bad"]:
            raise AssertionError(f"kernel 1 rows {(hi, wi, c)}->{(ho, wo)} [{y0}, {y1}): {errs}")
        ms, plain_ms = graph_times(kernel, plain)
        lo_tap, hi_tap, _ = interp_taps(hi, ho, True)
        in_rows = int(hi_tap[y1 - 1]) - int(lo_tap[y0]) + 1
        part = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                **bound(2 * BATCH * (c * in_rows * wi + cs * (y1 - y0) * wo
                                     + (c + cs) * (y1 - y0) * wo),
                        fp32=6 * BATCH * c * (y1 - y0) * wo)}
        log(f"kernel resize rows ({BATCH},{hi},{wi},{c})->({ho},{wo}) rows [{y0}, {y1}) + skip "
            f"{cs}: max_abs_err {errs['y']}, skip bit for bit; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (CUDA-graph replays), bound {part['bound_ms']:.4f} ms")
        rows.append((1, part))
        err_rows = max(err_rows, errs["y"])
        del x, skip, record
    halo, err_halo = [], 0.0
    for h, w, k, cin, m, blocks in MBCONV_SHAPES:
        _, n = band_rows(h)
        p = k // 2
        args = mbconv_inputs(gen, BATCH, n + p, w, cin, m, k)
        y, pool = kmb.mbconv_expand_dw_pool_rows(*args, k, 0, p)
        torch.cuda.synchronize()
        errs = mbconv_head_errors(*args, k, y, pool, MB_RTOL, MB_ATOL, POOL_RTOL, rows=(0, p))
        if errs["bad"]:
            raise AssertionError(f"kernel 8 halo form {(n, w, k, cin, m)}: {errs}")
        ms, plain_ms = graph_times(lambda: kmb.mbconv_expand_dw_pool_rows(*args, k, 0, p),
                                   lambda: kmb.mbconv_expand_dw_pool_rows_plain(*args, k, 0, p))
        part = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                **bound(2 * BATCH * w * ((n + p) * cin + n * m) + 2 * (cin + k * k) * m + 8 * m
                        + 4 * BATCH * m, bf16=2 * BATCH * (n + p) * w * cin * m,
                        fp32=2 * k * k * BATCH * n * w * m)}
        log(f"kernel mbconv head, halo form ({BATCH},{n}+{p},{w},{cin}) k{k} -> M {m} rows [0, "
            f"{n}) (x{blocks} a forward): max_abs_err y {errs['y']} pool {errs['pool']}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA-graph replays), bound "
            f"{part['bound_ms']:.4f} ms ({part['bound_by']})")
        halo.append((blocks, part))
        err_halo = max(err_halo, errs["y"])
        del args, y, pool
    out = {"resize_rows": total_of(rows, err_rows), "mbconv_rows": total_of(halo, err_halo)}
    r, mb = out["resize_rows"], out["mbconv_rows"]
    log(f"kernel 1's row-window form, rank 0's band of a forward (4 launches): {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; kernel 8's halo form "
        f"(32 launches): {mb['ms']:.4f} ms, plain {mb['plain_ms']:.4f} ms, bound "
        f"{mb['bound_ms']:.4f} ms ({mb['bound_by']})")
    return out


def check_final_upscale_kernels(gen: torch.Generator, dev, long_errs: dict) -> dict:
    """Kernels 1, 2, 4 and 5 at the shapes do_final_upscale gives them
    (``FU_*``), each against its plain version, timed beside it, with its
    bound: kernel 1's bare form at the fifth upsample (and that stage's
    route, the bare form then ``torch.cat`` with the image, logged), kernel
    2 on full-resolution features, kernel 4 at the full-resolution train
    step, kernel 5's forward at miniViT's served S 1200 and its backward at
    the train step's S 884; ``long_errs`` are kernel 5's largest errors
    over ``ATTN_CASES`` beyond 512 keys, on those routes."""
    b, hi, wi, c, ho, wo = FU_RESIZE
    x = torch.randn((b, hi, wi, c), generator=gen, device=dev).to(torch.bfloat16)
    image = torch.randn((b, ho, wo, 3), generator=gen, device=dev).to(torch.bfloat16)
    kernel = lambda: kresize.resize_bilinear_align_corners(x, ho, wo)  # noqa: E731
    plain = lambda: kresize.resize_bilinear_align_corners_plain(x, ho, wo)  # noqa: E731
    err = check_close(f"resize {FU_RESIZE}", kernel(), plain(), RESIZE_RTOL, RESIZE_ATOL)
    ms, plain_ms = graph_times(kernel, plain)
    lib_ms = library_time(lambda: F.interpolate(x.permute(0, 3, 1, 2), size=(ho, wo),
                                                mode="bilinear", align_corners=True))
    stage = captured(lambda: torch.cat([kernel(), image], -1), GRAPH_CALLS)
    stage_ms = library_time(stage.replay, iters=3) / GRAPH_CALLS
    del stage
    out = {"resize_final": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms,
                            **bound(2 * b * c * (hi * wi + ho * wo), fp32=6 * b * c * ho * wo)}}
    log(f"kernel resize, the final upsample ({b},{hi},{wi},{c})->({ho},{wo}): max_abs_err {err} "
        f"(rtol 2^-7, atol 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA-graph "
        f"replays), F.interpolate {lib_ms:.4f} ms, bound {out['resize_final']['bound_ms']:.4f} ms; "
        f"the stage's route (bare form + torch.cat with the 3-channel image) {stage_ms:.4f} ms")
    del x, image

    b, h, w, c = FU_BINS_SHAPE
    x = torch.randn((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=gen, device=dev)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=gen, device=dev)
    centers = torch.sort(0.001 + 10 * torch.rand((b, 256), generator=gen, device=dev), dim=1).values
    kernel = lambda: kbins.conv_bins_depth_batched(x, wts, bias, centers)  # noqa: E731
    plain = lambda: kbins.conv_bins_depth_batched_plain(x, wts, bias, centers)  # noqa: E731
    err = check_close(f"bins {FU_BINS_SHAPE}", kernel(), plain(), BINS_RTOL, BINS_ATOL)
    ms, plain_ms = graph_times(kernel, plain)
    cost = bins_cost(b, h * w, c, shared_w=False)
    out["bins_final"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         **bound(cost["bytes"], bf16=cost["flops"])}
    log(f"kernel bins at full resolution {FU_BINS_SHAPE}: max_abs_err {err} (rtol 1e-5, atol "
        f"1e-5); kernel {ms:.5f} ms, plain {plain_ms:.4f} ms (CUDA-graph replays), bound "
        f"{out['bins_final']['bound_ms']:.5f} ms ({out['bins_final']['bound_by']})")
    del x, wts

    exp = check_bins_expectation(gen, dev, FU_EXP_SHAPE)
    out["bins_expectation_fwd_final"] = exp["bins_expectation_fwd"]
    out["bins_expectation_bwd_final"] = exp["bins_expectation_bwd"]
    fwd = time_attention(gen, BATCH, FU_TOKENS, FU_TOKENS, "none")["fwd"]
    bwd = time_attention(gen, BATCH, FU_TRAIN_TOKENS, FU_TRAIN_TOKENS, "none")["bwd"]
    out["attention_fwd_final"] = {"max_abs_err": long_errs["fwd"], **fwd}
    out["attention_bwd_final"] = {"max_abs_err": long_errs["bwd"], **bwd}
    # the long routes' exps beside their bound: one a score each time a
    # route computes P (the forward once; the backward's row sum, key-tile
    # and query-tile blocks once each), with their time on the SFU alone
    n_sm, mhz = torch.cuda.get_device_properties(0).multi_processor_count, max_sm_mhz()
    for name, entry, s, per_score in (("forward", fwd, FU_TOKENS, 1),
                                      ("backward", bwd, FU_TRAIN_TOKENS, 3)):
        exps = per_score * BATCH * ATTN_HEADS * s * s
        log(f"kernel attention's long {name} (S {s}): {entry['ms']:.5f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}); {exps} exps ({per_score} a "
            f"score), {sfu_ms(exps, n_sm, mhz):.5f} ms on the SFU alone (16 ex2 a clock an SM "
            f"at {mhz:.0f} MHz); SDPA {entry['library_ms']:.5f} ms")
    return out


def check_attention_pairs(name: str, pairs, terms: dict | None = None) -> float:
    """Kernel 5's outputs against the plain version's, at the stated
    tolerances (atol scales with the largest plain entry, or, for the
    outputs that cancel, which ``terms`` names, is at least ATTN_TERM_ULPS
    of the largest of the terms the output sums)."""
    return max(check_close(f"{name} {n}", got, want, ATTN_RTOL, max(
        ATTN_ATOL_PER_MAX * float(want.float().abs().max()),
        ATTN_TERM_ULPS * (terms or {}).get(n, 0.0))) for n, got, want in pairs)


def check_attention(gen: torch.Generator, dev) -> dict:
    """Kernel 5 forward and backward against the plain versions at every
    ``ATTN_CASES`` case, each backward on the route its shape takes (the
    cluster route at every case up to 512 keys and queries); a fully masked
    row must be uniform over its keys. The largest errors of the cases
    beyond 512 keys (the long forward and backward) are
    returned apart too ('attention_long'). Then times at the flagship's served
    case and the train step's: the forward against the plain forward and
    SDPA with the same additive mask, the backward against the plain
    backward formula and SDPA's backward (autograd of one SDPA call); each
    as eager calls and replayed from CUDA graphs. The summary takes the
    forward at the served S 300 and the backward at the train step's S 221,
    the shapes the main paths launch them at."""
    errs, long_errs = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, sq, sk, mask_kind in ATTN_CASES:
        q, k, v, g, mask = attention_inputs(gen, b, sq, sk, mask_kind)
        bias = kattn.mask_bias(mask)
        c0 = kattn.fused_mha_bwd.cluster_launches
        out, stats = kattn.fused_mha_fwd(q, k, v, bias)
        served, none = kattn.fused_mha_fwd(q, k, v, bias, residual=False)
        grads = kattn.fused_mha_bwd(q, k, v, bias, g, stats)
        torch.cuda.synchronize()
        if none is not None or not torch.equal(served, out):
            raise AssertionError(f"attention {label}: the forward without a residual differs")
        route = "cluster" if kattn.fused_mha_bwd.cluster_launches > c0 else "long"
        if route != kattn.bwd_route(sq, sk):
            raise AssertionError(f"attention {label}: the backward took the {route} route")
        err_f = check_attention_pairs(f"attention {label}", [
            ("out", out, kattn.mha_fused_plain(q, k, v, bias))])
        err_b = check_attention_pairs(f"attention {label}", zip(
            ("dq", "dk", "dv"), grads, kattn.mha_fused_bwd_plain(q, k, v, bias, g)))
        if mask_kind == "full":
            uniform = v[0].float().mean(0).expand(sq, ATTN_HEADS, HEAD_DIM)
            check_close(f"attention {label}: the masked image", out[0], uniform, 2.0 ** -7, 1e-3)
        log(f"kernel attention {label} (B {b}, Sq {sq}, Sk {sk}, H {ATTN_HEADS}, D {HEAD_DIM}, "
            f"mask {mask_kind}): max_abs_err forward {err_f}, backward {err_b} (rtol 2^-7, "
            f"atol 1e-4 max|plain|), the forward without a residual bitwise the same; forward "
            f"plan {kattn.fwd_plan(b * ATTN_HEADS, sq, sk, n_sm)}, backward route {route}")
        del served
        errs["fwd"], errs["bwd"] = max(errs["fwd"], err_f), max(errs["bwd"], err_b)
        if max(sq, sk) > kattn.RESIDENT_MAX_KEYS:
            long_errs["fwd"], long_errs["bwd"] = (max(long_errs["fwd"], err_f),
                                                  max(long_errs["bwd"], err_b))
        del q, k, v, g, out, stats, grads
    timed = {label: time_attention(gen, b, sq, sk, mask_kind)
             for label, b, sq, sk, mask_kind in ATTN_CASES[:2]}
    fwd, bwd = timed[ATTN_CASES[0][0]]["fwd"], timed[ATTN_CASES[1][0]]["bwd"]
    return {"attention_fwd": {"max_abs_err": errs["fwd"], **fwd},
            "attention_bwd": {"max_abs_err": errs["bwd"], **bwd}, "attention_long": long_errs}


def time_attention(gen: torch.Generator, b: int, sq: int, sk: int, mask_kind: str) -> dict:
    """Kernel 5's forward and backward at one case, timed against the plain
    versions and SDPA: {"fwd": times and bound, "bwd": times and bound}."""
    q, k, v, g, mask = attention_inputs(gen, b, sq, sk, mask_kind)
    bias = kattn.mask_bias(mask)
    _, stats = kattn.fused_mha_fwd(q, k, v, bias)
    # SDPA takes (B, H, S, D) and the additive mask in q's dtype; never
    # called by the port
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
    gs = g.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)

    def sdpa_fwd_bwd():
        # autograd runs a backward on its forward's stream, so a captured
        # backward needs its forward in the same capture
        return torch.autograd.grad(sdpa(), (qs, ks, vs), gs)

    # the forward as a served request launches it (no residual), and as a
    # train step does (the residual written, for the backward)
    calls = {"fwd": lambda: kattn.fused_mha_fwd(q, k, v, bias, residual=False),
             "fwd_plain": lambda: kattn.mha_fused_plain(q, k, v, bias),
             "fwd_train": lambda: kattn.fused_mha_fwd(q, k, v, bias),
             "bwd": lambda: kattn.fused_mha_bwd(q, k, v, bias, g, stats),
             "bwd_plain": lambda: kattn.mha_fused_bwd_plain(q, k, v, bias, g),
             "sdpa": sdpa, "sdpa_fwd_bwd": sdpa_fwd_bwd}
    # eager calls, the host's launch rate included
    eager = dict(zip(("fwd", "fwd_plain"), compare_times(calls["fwd"], calls["fwd_plain"])))
    eager.update(zip(("bwd", "bwd_plain"), compare_times(calls["bwd"], calls["bwd_plain"])))
    eager["sdpa"] = library_time(sdpa)
    sdpa_out = sdpa()
    eager["sdpa_bwd"] = library_time(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), gs,
                                                                 retain_graph=True))
    del sdpa_out
    # the card alone: each function's GRAPH_CALLS calls replayed from a CUDA
    # graph; SDPA's backward is its forward plus backward less its forward
    graphs = {name: captured(fn, GRAPH_CALLS) for name, fn in calls.items()}
    per_call = {}
    for kernel, plain in (("fwd", "fwd_plain"), ("bwd", "bwd_plain")):
        tk, tp = compare_times(graphs[kernel].replay, graphs[plain].replay, iters=3)
        per_call[kernel], per_call[plain] = tk / GRAPH_CALLS, tp / GRAPH_CALLS
    for name in ("sdpa", "sdpa_fwd_bwd", "fwd_train"):
        per_call[name] = library_time(graphs[name].replay, iters=3) / GRAPH_CALLS
    del graphs
    lib_bwd = per_call["sdpa_fwd_bwd"] - per_call["sdpa"]
    # bytes, each input read once and each output written once: the served
    # forward reads q, k, v and the bias and writes o (a train step's also
    # the residual: each row's max and log-sum, fp32; attention_ab.fwd_bound);
    # the backward's bytes and five products are attention_ab.bwd_cost's.
    # Operations: the forward's two products
    fwd_bound = attn_fwd_bound(b, ATTN_HEADS, sq, sk, residual=False)
    bwd_bytes, bwd_ops = bwd_cost(b, ATTN_HEADS, sq, sk)
    bwd_bound = bound(bwd_bytes, bf16=bwd_ops)
    log(f"kernel attention (B {b}, S {sq}, H {ATTN_HEADS}, D {HEAD_DIM}) timed, CUDA-graph "
        f"replays of {GRAPH_CALLS} calls: forward {per_call['fwd']:.5f} ms (no residual; "
        f"{per_call['fwd_train']:.5f} ms writing it), plain "
        f"{per_call['fwd_plain']:.4f} ms, SDPA {per_call['sdpa']:.5f} ms, bound "
        f"{fwd_bound['bound_ms']:.5f} ms ({fwd_bound['bound_by']}); backward "
        f"{per_call['bwd']:.5f} ms, plain {per_call['bwd_plain']:.4f} ms, SDPA's backward "
        f"{lib_bwd:.5f} ms (forward plus backward {per_call['sdpa_fwd_bwd']:.5f} ms), bound "
        f"{bwd_bound['bound_ms']:.5f} ms ({bwd_bound['bound_by']}); eager calls: forward "
        f"{eager['fwd']:.4f} ms, plain {eager['fwd_plain']:.4f} ms, SDPA {eager['sdpa']:.4f} ms; "
        f"backward {eager['bwd']:.4f} ms, plain {eager['bwd_plain']:.4f} ms, SDPA's backward "
        f"{eager['sdpa_bwd']:.4f} ms")
    return {"fwd": {"ms": per_call["fwd"], "plain_ms": per_call["fwd_plain"],
                    "library_ms": per_call["sdpa"], **fwd_bound},
            "bwd": {"ms": per_call["bwd"], "plain_ms": per_call["bwd_plain"],
                    "library_ms": lib_bwd, **bwd_bound}}


def graph_times(kernel, plain) -> tuple[float, float]:
    """ms per call of ``kernel`` and ``plain``, each as CUDA-graph replays of
    GRAPH_CALLS calls (the card alone), timed in turns."""
    gk, gp = captured(kernel, GRAPH_CALLS), captured(plain, GRAPH_CALLS)
    tk, tp = compare_times(gk.replay, gp.replay, iters=3)
    del gk, gp
    return tk / GRAPH_CALLS, tp / GRAPH_CALLS


def mbconv_inputs(gen, b: int, h: int, w: int, cin: int, m: int, k: int, batch_minor=False):
    """bf16 x ~ N(0, 1) (NHWC, or (H, W, B, C)), we ~ N(0, 1/Cin) and wd ~
    N(0, 0.09) bf16, be ~ N(0, 1) (silu(be) far from zero, so a halo left
    unzeroed shows) and bd ~ N(0, 0.09) fp32."""
    shape = (h, w, b, cin) if batch_minor else (b, h, w, cin)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    we = (torch.randn((cin, m), generator=gen, device="cuda") / cin ** 0.5).to(torch.bfloat16)
    be = torch.randn(m, generator=gen, device="cuda")
    wd = (0.3 * torch.randn((k, k, 1, m), generator=gen, device="cuda")).to(torch.bfloat16)
    bd = 0.3 * torch.randn(m, generator=gen, device="cuda")
    return x, we, be, wd, bd


def check_mbconv(name: str, x, we, be, wd, bd, k, y, pool) -> dict:
    """Kernel 8's (10's with ``we`` None) outputs against the plain version
    on the same tensors, x and y NHWC."""
    errs = mbconv_head_errors(x, we, be, wd, bd, k, y, pool, MB_RTOL, MB_ATOL, POOL_RTOL)
    if errs["bad"]:
        raise AssertionError(f"{name}: {errs['bad']} values out of tolerance: {errs}")
    return errs


def check_se_project(name: str, dw, gate, kern, bias, skip, out) -> dict:
    errs = se_project_errors(dw, gate, kern, bias, skip, out, MB_RTOL, MB_ATOL)
    if errs["bad"]:
        raise AssertionError(f"{name}: {errs['bad']} values out of tolerance: {errs}")
    return errs


def check_encoder_kernels(gen) -> dict:
    """Kernels 8, 9, 10 and 7 at B5's shapes (see the module note). Kernel
    8's and 7's totals are one forward's launches (each shape times its
    blocks); 9's and 10's the sum over their cases."""
    mb, errs_mb = [], 0.0
    for h, w, k, cin, m, blocks in MBCONV_SHAPES:
        args = mbconv_inputs(gen, BATCH, h, w, cin, m, k)
        y, pool = kmb.mbconv_expand_dw_pool(*args, k)
        torch.cuda.synchronize()
        errs = check_mbconv(f"kernel 8 {(h, w, k, cin, m)}", *args, k, y, pool)
        ms, plain_ms = graph_times(lambda: kmb.mbconv_expand_dw_pool(*args, k),
                                   lambda: kmb.mbconv_expand_dw_pool_plain(*args, k))
        part = {"ms": ms, "plain_ms": plain_ms,
                **mbconv_bound(BATCH * h * w, cin, m, k, expand=True, with_pool=True)}
        log(f"kernel mbconv head ({BATCH},{h},{w},{cin}) k{k} -> M {m} (x{blocks} a forward): "
            f"max_abs_err y {errs['y']} pool {errs['pool']}, {errs['flips']} band values within "
            f"the expand's bound of a rounding boundary; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms (CUDA-graph replays), bound {part['bound_ms']:.4f} ms ({part['bound_by']})")
        mb.append((blocks, part))
        errs_mb = max(errs_mb, errs["y"])
        del args, y, pool

    bs, errs_bs = [], 0.0
    for h, w, k, cin, m, _ in MBCONV_BS_SHAPES:
        x_t, we, be, wd, bd = mbconv_inputs(gen, BATCH, h, w, cin, m, k, batch_minor=True)
        y_t, pool = kmb.mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, k)
        torch.cuda.synchronize()
        errs = check_mbconv(f"kernel 9 {(h, w, BATCH, cin)}", x_t.permute(2, 0, 1, 3), we, be, wd,
                            bd, k, y_t.permute(2, 0, 1, 3), pool)
        ms, plain_ms = graph_times(lambda: kmb.mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, k),
                                   lambda: kmb.mbconv_bs_expand_dw_pool_plain(x_t, we, be, wd, bd, k))
        part = {"ms": ms, "plain_ms": plain_ms,
                **mbconv_bound(BATCH * h * w, cin, m, k, expand=True, with_pool=True)}
        log(f"kernel mbconv head, (H, W, B, C) ({h},{w},{BATCH},{cin}) k{k} -> M {m}: max_abs_err "
            f"y {errs['y']} pool {errs['pool']}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {part['bound_ms']:.4f} ms ({part['bound_by']})")
        bs.append((1, part))
        errs_bs = max(errs_bs, errs["y"])
        del x_t, y_t, pool

    dw, errs_dw = [], 0.0
    for h, w, k, c, with_pool in DW_CASES:
        x, _, _, wd, bd = mbconv_inputs(gen, BATCH, h, w, c, c, k)
        y, pool = kmb.dw_conv_silu_pool(x, wd, bd, k, with_pool)
        torch.cuda.synchronize()
        errs = check_mbconv(f"kernel 10 {(h, w, c, k, with_pool)}", x, None, None, wd, bd, k, y,
                            pool)
        ms, plain_ms = graph_times(lambda: kmb.dw_conv_silu_pool(x, wd, bd, k, with_pool),
                                   lambda: kmb.dw_conv_silu_pool_plain(x, wd, bd, k, with_pool))
        # a part of the function, for context: cuDNN's depthwise conv with
        # its bias alone (no SiLU, no pool), never called by the port
        conv = cudnn_depthwise(x, wd, bd, k)
        gconv = captured(conv, GRAPH_CALLS)
        cudnn_ms = library_time(gconv.replay, iters=3) / GRAPH_CALLS
        del gconv
        part = {"ms": ms, "plain_ms": plain_ms,
                **mbconv_bound(BATCH * h * w, c, c, k, expand=False, with_pool=with_pool)}
        plan = kmb.dw_plan(BATCH, h, w, c, k,
                           torch.cuda.get_device_properties(0).multi_processor_count)
        log(f"kernel depthwise ({BATCH},{h},{w},{c}) k{k} pool {with_pool}: max_abs_err y "
            f"{errs['y']} pool {errs.get('pool')}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cuDNN's depthwise conv + bias alone (a part of the function) {cudnn_ms:.4f} ms, "
            f"bound {part['bound_ms']:.4f} ms ({part['bound_by']}); plan strip {plan.strip_w} "
            f"segment {plan.seg_rows} warps {plan.warps} stages {plan.stages} grid {plan.grid} "
            f"items {plan.items}")
        dw.append((1, part))
        errs_dw = max(errs_dw, errs["y"])
        del x, y, pool

    se, v2, errs_se = [], [], 0.0
    for h, w, m, o, with_skip, launches in SE_SHAPES:
        part, err = time_se_project(gen, h, w, m, o, with_skip, launches)
        se.append((launches, part))
        if (h, w, m, o, with_skip) in V2M_FROM_SE_SHAPES:
            v2.append((V2M_FROM_SE_SHAPES[h, w, m, o, with_skip], part))
        errs_se = max(errs_se, err)
    errs_v2 = errs_se
    for h, w, m, o, with_skip, launches in V2M_SE_SHAPES:
        part, err = time_se_project(gen, h, w, m, o, with_skip, launches, "V2-M")
        v2.append((launches, part))
        errs_v2 = max(errs_v2, err)
    assert sum(n for n, _ in v2) == V2M_SE_PROJECT, "V2-M's kernel-7 shapes miss launches"
    out = {"mbconv_head": total_of(mb, errs_mb), "mbconv_bs": total_of(bs, errs_bs),
           "dw_conv": total_of(dw, errs_dw), "se_project": total_of(se, errs_se)}
    v2_eager = sum(n * part["eager_ms"] for n, part in v2)
    mb, se, v2 = out["mbconv_head"], out["se_project"], total_of(v2, errs_v2)
    log(f"kernel 8 a forward (32 launches): {mb['ms']:.4f} ms, plain {mb['plain_ms']:.4f} ms, "
        f"bound {mb['bound_ms']:.4f} ms ({mb['bound_by']}); kernel 7 a forward (7 launches): "
        f"{se['ms']:.4f} ms, plain {se['plain_ms']:.4f} ms, baddbmm {se['library_ms']:.4f} ms, "
        f"bound {se['bound_ms']:.4f} ms ({se['bound_by']}); kernel 7 a V2-M forward (its eight "
        f"shapes, 44 launches): {v2['ms']:.4f} ms, plain {v2['plain_ms']:.4f} ms, "
        f"baddbmm {v2['library_ms']:.4f} ms, bound {v2['bound_ms']:.4f} ms ({v2['bound_by']}), "
        f"eager calls {v2_eager:.4f} ms")
    return out


def time_se_project(gen, h: int, w: int, m: int, o: int, with_skip: bool, launches: int,
                    model: str = "B5") -> tuple[dict, float]:
    """Kernel 7 at one shape, batch 8: checked against its plain version,
    timed beside it as CUDA-graph replays and beside one ``torch.baddbmm``;
    returns its times and bound, and its max abs error."""
    dw_out = torch.randn((BATCH, h, w, m), generator=gen, device="cuda").to(torch.bfloat16)
    gate = torch.rand((BATCH, m), generator=gen, device="cuda").to(torch.bfloat16)
    kern = (torch.randn((m, o), generator=gen, device="cuda") / m ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
    skip = (torch.randn((BATCH, h, w, o), generator=gen, device="cuda").to(torch.bfloat16)
            if with_skip else None)
    out = kse.se_gate_project(dw_out, gate, kern, bias, skip)
    torch.cuda.synchronize()
    errs = check_se_project(f"kernel 7 {(h, w, m, o, with_skip)}", dw_out, gate, kern, bias,
                            skip, out)
    ms, plain_ms = graph_times(lambda: kse.se_gate_project(dw_out, gate, kern, bias, skip),
                               lambda: kse.se_gate_project_plain(dw_out, gate, kern, bias, skip))
    # the yardstick: one cuBLAS call on operands made beforehand, never
    # called by the port
    lib_in = (bias.to(torch.bfloat16) + skip.reshape(BATCH, h * w, o) if with_skip
              else bias.to(torch.bfloat16))
    lib_w = gate[:, :, None] * kern
    lib_a = dw_out.reshape(BATCH, h * w, m)
    library = lambda: torch.baddbmm(lib_in, lib_a, lib_w)  # noqa: E731
    lib_ms = library_time(library, iters=20)
    # eager calls one after another: where a call's host work outlasts its
    # device time, these time the host's rate, the wrapper's included
    eager_ms, eager_lib_ms = compare_times(
        lambda: kse.se_gate_project(dw_out, gate, kern, bias, skip), library, iters=50, rounds=2)
    n = BATCH * h * w
    part = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "eager_ms": eager_ms,
            **bound(2 * n * m + 2 * BATCH * m + 2 * m * o + 4 * o + 2 * n * o * (1 + with_skip),
                    bf16=2 * n * m * o)}
    log(f"kernel se project ({BATCH},{h},{w},{m}) -> O {o} skip {with_skip} (x{launches} a "
        f"{model} forward): max_abs_err {errs['out']}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, baddbmm {lib_ms:.4f} ms, bound {part['bound_ms']:.4f} ms ({part['bound_by']}); "
        f"eager calls {eager_ms:.4f} ms a call, baddbmm's {eager_lib_ms:.4f}")
    return part, errs["out"]


def check_detect_head_outputs(name: str, flat, packed, out) -> dict:
    errs = detect_head_errors(flat, packed, out, DETECT_RTOL, DETECT_ATOL)
    if errs["bad"]:
        raise AssertionError(f"{name}: {errs['bad']} elements out of tolerance: {errs}")
    return errs


def check_detect_head(gen: torch.Generator, dev) -> dict:
    """Kernel 6 at the fused server's level shapes: features ~N(0, 1) and
    weights ~N(0, 1/Cin), so logits are of order 1 as the detector's are.
    Kernel, plain version and the dense head's GEMM are timed as CUDA-graph
    replays (a level's kernel takes tens of microseconds); ms and plain_ms
    are the sum over the three NYU levels (one request), and the KITTI
    request's sum is logged beside it."""
    no = 5 + NUM_CLASSES + NM
    parts, err = [], 0.0
    for place, shapes in DETECT_SHAPES.items():
        sums = collections.Counter()
        for b, s, cin in shapes:
            flat = torch.randn((b, s, cin), generator=gen, device=dev).to(torch.bfloat16)
            w = torch.randn((3 * no, cin), generator=gen, device=dev) / cin ** 0.5
            bias = 0.1 * torch.randn(3 * no, generator=gen, device=dev)
            packed = kdetect.pack_detect_head(w, bias, NUM_CLASSES, NM, torch.bfloat16)
            errs = check_detect_head_outputs(f"detect head {(b, s, cin)}", flat, packed,
                                             kdetect.fused_detect_head(flat, packed))
            ms, plain_ms = graph_times(lambda: kdetect.fused_detect_head(flat, packed),
                                       lambda: kdetect.fused_detect_head_plain(flat, packed))
            # the dense head's one GEMM (all 3 no logits of every position)
            wd, bd = w.to(torch.bfloat16), bias.to(torch.bfloat16)
            gemm = captured(lambda: F.linear(flat, wd, bd), GRAPH_CALLS)
            lib_ms = library_time(gemm.replay, iters=3) / GRAPH_CALLS
            del gemm
            flops = 2 * b * s * cin * 3 * no
            # flat and the weights read once; y5 and coef (bf16), cls_max (fp32)
            # and cls_arg (int32) written once
            part = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    **bound(2 * b * s * cin + 2 * 3 * no * cin + 4 * 3 * no
                            + b * s * 3 * (2 * (5 + NM) + 8), bf16=flops)}
            log(f"kernel detect head {place} ({b},{s},{cin}) nc {NUM_CLASSES}: max_abs_err y5 "
                f"{errs['y5']} coef {errs['coef']} cls_max {errs['cls_max']} (rtol 2^-7, atol "
                f"1e-5); cls_arg equal off near-ties, {errs['near_ties']} near-ties of "
                f"{errs['rows']} rows; CUDA-graph replays of {GRAPH_CALLS} calls: kernel "
                f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, dense "
                f"head GEMM {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), bound "
                f"{part['bound_ms']:.4f} ms ({part['bound_by']})")
            err = max(err, errs["y5"], errs["coef"], errs["cls_max"])
            sums.update({k: part[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
            if place == "NYU 480x640":
                parts.append((1, part))
            del flat, packed
        log(f"kernel detect head, {place} request of {BATCH} (3 launches): kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, dense head GEMM "
            f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")
    # the share edges: grids in which a block's share starts at a row tile's
    # last unit and one ends at a row tile's first unit, where a consumer
    # warpgroup hands feature tiles back (checked, not timed)
    for b, s, cin, nc in DETECT_EDGE_SHAPES:
        no_e = 5 + nc + NM
        flat = torch.randn((b, s, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3 * no_e, cin), generator=gen, device=dev) / cin ** 0.5
        bias = 0.1 * torch.randn(3 * no_e, generator=gen, device=dev)
        packed = kdetect.pack_detect_head(w, bias, nc, NM, torch.bfloat16)
        grids = share_edge_grids(b * s, cin, packed.wcls.shape[1])
        if not grids:
            raise AssertionError(f"detect head {(b, s, cin)}: no share-edge grid")
        for grid in grids:
            errs = check_detect_head_outputs(f"detect head {(b, s, cin)} nc {nc} on {grid} blocks",
                                             flat, packed,
                                             kdetect._fused_detect_head_on_grid(flat, packed, grid))
            err = max(err, errs["y5"], errs["coef"], errs["cls_max"])
            log(f"kernel detect head share edges ({b},{s},{cin}) nc {nc}, {grid} blocks: "
                f"max_abs_err y5 {errs['y5']} coef {errs['coef']} cls_max {errs['cls_max']}")
        del flat, packed
    return total_of(parts, err)


def close_backward(name: str, dlogits, dcenters, want_dl, want_dc, g) -> tuple[float, float]:
    """Kernel 4's backward outputs against the plain backward's, at the
    stated tolerances (dlogits' absolute part scales with |g|)."""
    err_dl = check_close(f"{name} dlogits", dlogits, want_dl, DLOGITS_RTOL,
                         DLOGITS_ATOL_PER_G * float(g.abs().max()))
    err_dc = check_close(f"{name} dcenters", dcenters, want_dc, DCENTERS_RTOL,
                         DCENTERS_ATOL_PER_MAX * float(want_dc.abs().max()))
    return err_dl, err_dc


def check_bins_expectation(gen: torch.Generator, dev, shape=EXP_SHAPE) -> dict:
    """Kernel 4 at a train step's ``shape`` (B, pixels, bins): forward
    against the plain forward, backward against the plain backward formula;
    times against the plain forward, and against autograd's backward of it
    (softmax and matmul keeping fp32 probabilities), which is what PyTorch
    runs without the kernel."""
    b, s, k = shape
    logits = (2.0 * torch.randn((b, s, k), generator=gen, device=dev)).to(torch.bfloat16)
    centers = torch.sort(0.001 + 10 * torch.rand((b, k), generator=gen, device=dev), dim=1).values
    g = torch.randn((b, s), generator=gen, device=dev)
    kernel = lambda: kexp.bins_expectation_fwd(logits, centers)  # noqa: E731
    plain = lambda: kexp.bins_expectation_plain(logits, centers)  # noqa: E731
    err = check_close("bins expectation forward", kernel(), plain(), EXP_RTOL, EXP_ATOL)
    ms, plain_ms = compare_times(kernel, plain)
    # bf16 logits read once, fp32 depth written once; per logit an exp and
    # ~4 fp32 operations on the CUDA cores. No one PyTorch call computes a
    # softmax and its expectation: library_ms null
    fwd_bound = bound(2 * b * s * k + 4 * b * k + 4 * b * s, fp32=5 * b * s * k)
    log(f"kernel bins expectation forward {shape}: max_abs_err {err} (rtol 1e-5, atol "
        f"1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{fwd_bound['bound_ms']:.4f} ms")
    fwd = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **fwd_bound}

    dl, dc = kexp.bins_expectation_bwd(logits, centers, g)
    err_dl, err_dc = close_backward("bins expectation backward", dl, dc,
                                    *kexp.bins_expectation_bwd_plain(logits, centers, g), g)
    del dl, dc
    lg, cg = logits.detach().requires_grad_(), centers.detach().requires_grad_()
    out = kexp.bins_expectation_plain(lg, cg)
    kernel = lambda: kexp.bins_expectation_bwd(logits, centers, g)  # noqa: E731
    plain = lambda: torch.autograd.grad(out, (lg, cg), g, retain_graph=True)  # noqa: E731
    ms, plain_ms = compare_times(kernel, plain, iters=10)
    # logits and g read once, dlogits and dcenters written once
    bwd_bound = bound(4 * b * s * k + 4 * b * k + 4 * b * s + 4 * b * k, fp32=8 * b * s * k)
    log(f"kernel bins expectation backward {shape}: max_abs_err dlogits {err_dl} (rtol "
        f"2^-7, atol 1e-4 max|g|), dcenters {err_dc} (rtol 1e-4, atol 1e-5 max|dcenters|); "
        f"kernel {ms:.4f} ms, plain (autograd of the plain forward) {plain_ms:.4f} ms, bound "
        f"{bwd_bound['bound_ms']:.4f} ms")
    return {"bins_expectation_fwd": fwd,
            "bins_expectation_bwd": {"max_abs_err": err_dl, "ms": ms, "plain_ms": plain_ms,
                                     "library_ms": None, **bwd_bound}}


def make_provider(rng: np.random.Generator, n_obj: int):
    """A stand-in detector: per image a different number of valid slots (one
    image fills all of them), boxes inside the frame, CLIP-scale features."""
    counts = [min(c, n_obj) for c in SERVED_VALID]

    def provider(normed: np.ndarray) -> dict:
        b = normed.shape[0]
        feats = np.zeros((b, n_obj, 512), np.float32)
        xywh = np.full((b, n_obj, 4), -1.0, np.float32)
        valid = np.zeros((b, n_obj), bool)
        for i in range(b):
            k = counts[i % len(counts)]
            feats[i, :k] = 0.05 * rng.standard_normal((k, 512))
            xywh[i, :k] = np.stack([rng.uniform(0, EVAL_DIMS[1], k), rng.uniform(0, EVAL_DIMS[0], k),
                                    rng.uniform(8, 300, k), rng.uniform(8, 300, k)], -1)
            valid[i, :k] = True
        return {"features": feats, "xywh": xywh, "valid": valid}

    return provider


def check_depth(name: str, depth: torch.Tensor, lo: float, hi: float, batch: int = BATCH,
                dims: tuple[int, int] = EVAL_DIMS, full_res: bool = False) -> None:
    """Finite fp32 depth within [lo, hi] at half the frames' size, or at
    their size (``full_res``: do_final_upscale)."""
    shape = (batch, *(dims if full_res else (dims[0] // 2, dims[1] // 2)), 1)
    if tuple(depth.shape) != shape or depth.dtype != torch.float32:
        raise AssertionError(f"{name}: depth {depth.dtype} {tuple(depth.shape)}, want fp32 {shape}")
    if not torch.isfinite(depth).all():
        raise AssertionError(f"{name}: non-finite depth")
    # bin widths are normalised in bf16, so the last bin edge may pass
    # max_depth by the rounding of their sum (<= 2^-8 relative)
    dmin, dmax = float(depth.min()), float(depth.max())
    if dmin < lo or dmax > hi * (1 + 2.0 ** -8):
        raise AssertionError(f"{name}: depth in [{dmin}, {dmax}], outside [{lo}, {hi}]")
    log(f"  {name}: depth {tuple(depth.shape)} in [{dmin:.4f}, {dmax:.4f}] m, "
        f"std {float(depth.std()):.4f}")


def check_served_kernels(model, records: list[dict]) -> None:
    """Each kernel's output in the served forwards against its plain version
    on the same inputs, at the kernel phase's tolerances, and how many of
    kernel 2's units took its exact fold (three chains of products, not
    one: ``exact_fold_units``)."""
    exact = units = 0
    for i, rec in enumerate(records):
        resize, (depth, plain_depth) = plain_outputs(model, rec)
        n_exact, n_units = exact_fold_units(*bins_operands(model, rec)[:3])
        exact, units = exact + n_exact, units + n_units
        errs = [check_close(f"request {i} resize {j + 1}", y, want, RESIZE_RTOL, RESIZE_ATOL)
                for j, (y, want) in enumerate(resize)]
        if skip_mismatches(rec):
            raise AssertionError(f"request {i}: a concat buffer's skip slice is not the skip")
        err = check_close(f"request {i} bins", depth, plain_depth, BINS_RTOL, BINS_ATOL)
        spread = float(plain_depth.max() - plain_depth.min())
        band = BINS_ATOL + BINS_RTOL * float(plain_depth.abs().max())
        log(f"  request {i}: served kernels vs plain on their own inputs: resize max abs err "
            f"{max(errs)}, skip slices bit for bit, bins max abs err {err} (depth spread {spread:.5f} m, "
            f"{spread / band:.0f}x the bins tolerance)")
        if spread < MIN_SPREAD_IN_TOLERANCES * band:
            raise AssertionError(f"request {i}: depth too flat to check the bins kernel")
    log(f"  kernel 2's units on the exact fold over {len(records)} requests: {exact} of {units} "
        f"({exact / max(units, 1):.4%})")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def check_attention_records(what: str, records: list[dict], residual: bool,
                            cancelling: bool = False) -> None:
    """Each recorded kernel-5 launch against the plain version on its own
    tensors; each forward must have written a residual where a backward may
    read it (``residual``: a train step) and none where none can (a served
    request, under no_grad). With ``cancelling``, a backward output that
    cancels has an atol of at least ATTN_TERM_ULPS of the largest of the
    terms it sums (``kernel_io.attention_cancelling_terms``)."""
    wrong = [i for i, rec in enumerate(records) if rec["kind"] == "fwd"
             and rec["residual"] != residual]
    if wrong:
        raise AssertionError(f"{what}: kernel-5 forwards {wrong} "
                             f"{'skipped' if residual else 'wrote'} the residual")
    errs, cancelled = collections.defaultdict(float), []
    for i, rec in enumerate(records):
        terms = attention_cancelling_terms(rec) if cancelling and rec["kind"] == "bwd" else None
        if terms:
            cancelled.extend(f"{i} {n}" for n in terms)
        errs[rec["kind"]] = max(errs[rec["kind"]], check_attention_pairs(
            f"{what} kernel-5 {rec['kind']} {i}", attention_plain_outputs(rec), terms))
    kinds = collections.Counter(rec["kind"] for rec in records)
    log(f"  {what}: kernel 5 vs plain on its own tensors, {dict(kinds)} launches (residual "
        f"{'written' if residual else 'skipped'} on every forward): max abs err "
        + ", ".join(f"{k} {v}" for k, v in errs.items())
        + (f"; outputs that cancel: {', '.join(cancelled) or 'none'}" if cancelling else ""))


def check_against_fp32(model, rng: np.random.Generator, **options) -> None:
    """The same weights in fp32 (the plain versions, which an fp32 model runs
    on the card, and cuDNN convs without TF32) against the bf16 kernel path,
    on a small input with objects: ObjCAViT's outputs, i.e. the encoder, the
    decoder with its four upsamples, and the transformer. ``options`` are
    ObjCAViT's options the model was built with."""
    small = (384, 352)
    ref_model = build_flagship_pipeline(dtype=torch.float32, seed=0,
                                        attn_impl=model.attn_impl, **options).model
    small_frames = rng.integers(0, 256, (2, *small, 3), dtype=np.uint8)
    outs = []
    for m in (model, ref_model):
        provider = make_provider(np.random.default_rng(5), image_seq_len(*small))
        with record_kernel_io(m) as rec:
            DepthPipeline(m, eval_dims=small, provider=provider)(small_frames)
        outs.append(rec[0]["bins_inputs"])
    (_, feat, queries), (_, feat_ref, queries_ref) = outs
    rels = {"feat": rel_l2(feat, feat_ref), "queries": rel_l2(queries, queries_ref)}
    log(f"  bf16 kernels vs fp32 plain, 2x{small}: ObjCAViT outputs rel L2 err "
        f"{', '.join(f'{k} {v:.5f}' for k, v in rels.items())} (bound {FEATURE_REL_BOUND})")
    if not max(rels.values()) < FEATURE_REL_BOUND:
        raise AssertionError("the bf16 kernel path strays from the fp32 reference")


def phase_slice(attn_impl: str = "plain") -> dict:
    """The flagship server with its attention on the route ``attn_impl``."""
    t0 = time.perf_counter()
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   attn_impl=attn_impl)
    model = pipe.model
    log(f"slice: GraphBins-B5 bf16 folded, {attn_impl} attention, {pipe.n_obj_max} slots, built "
        f"in {time.perf_counter() - t0:.2f} s")
    if pipe.n_obj_max != 300:
        raise AssertionError(f"expected 300 object slots at 480x640, got {pipe.n_obj_max}")
    rng = np.random.default_rng(1234)
    with_objects = DepthPipeline(model, eval_dims=EVAL_DIMS,
                                 provider=make_provider(rng, pipe.n_obj_max))
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    routes = [("objects", with_objects), ("sentinel", pipe), ("objects", with_objects),
              ("sentinel", pipe)]

    pipe(frames[0])  # warm-up: cuDNN set-up, library load
    torch.cuda.synchronize()
    zero_counters()
    with record_kernel_io(model) as records, record_attention_io() as attn_records:
        depths = [server(f) for (_, server), f in zip(routes, frames)]
    torch.cuda.synchronize()
    n = len(routes)
    attn = 10 * n if attn_impl == "kernel" else 0
    launches = expect_launches(f"{n} requests of {BATCH} frames", resize=4 * n, bins=n,
                               attention_fwd=attn)
    for i, ((route, _), depth) in enumerate(zip(routes, depths)):
        check_depth(f"request {i} ({route})", depth, model.min_depth, model.max_depth)
    slots = with_objects.provider(np.zeros((BATCH, 1, 1, 3), np.float32))["valid"].sum(1)
    log(f"  valid object slots per image on the objects route: {slots.tolist()}")
    check_served_kernels(model, records)
    if attn_impl == "kernel":
        check_attention_records("served requests", attn_records, residual=False)
    launches["resize_bare"] = drive_bare_resize(records[-1])
    del records, attn_records

    check_against_fp32(model, rng)

    # served rate: host uint8 frames in, device depth out, one request at a time
    torch.cuda.reset_peak_memory_stats()
    n_req = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_req):
        pipe(frames[i % len(frames)])
    torch.cuda.synchronize()
    served = n_req * BATCH / (time.perf_counter() - t0)
    latencies = []
    for i in range(11):
        t1 = time.perf_counter()
        pipe(frames[i % len(frames)])
        torch.cuda.synchronize()
        latencies.append(1000 * (time.perf_counter() - t1))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  served {served:.2f} img/s over {n_req} requests of {BATCH} (sentinel route); "
        f"p50 {statistics.median(latencies):.2f} ms per request; peak memory {peak_gib:.3f} GiB")
    if attn_impl == "kernel":
        log_route_splits(pipe, build_flagship_pipeline, frames[1])
    return launches


def drive_bare_resize(record: dict) -> int:
    """Kernel 1's bare form, which no model takes (the decoder writes its
    concat buffers), driven as a function on a served forward's four
    upsample inputs. Each output must equal the concat form's upsample
    slice bit for bit: one kernel, one arithmetic."""
    torch.cuda.synchronize()
    zero_counters()
    with torch.no_grad():
        outs = [kresize.resize_bilinear_align_corners(x.contiguous(), y.shape[1], y.shape[2])
                for x, y in record["resize"]]
    torch.cuda.synchronize()
    launches = expect_launches("kernel 1's bare form on a served forward's inputs", resize=4,
                               resize_concat=0)
    for j, (out, (_, y)) in enumerate(zip(outs, record["resize"])):
        if not torch.equal(out.view(torch.int16), y.contiguous().view(torch.int16)):
            raise AssertionError(f"upsample {j + 1}: the bare form differs from the concat form")
    log("  kernel 1's bare form on the served inputs: bit for bit the concat form's upsamples")
    return launches["resize"]


def log_route_splits(pipe, build, frames) -> None:
    """The stage split of ``pipe`` (kernel 5's route) and of a server that
    ``build`` makes with the same seed, so the same weights, on the plain
    route, timed in turns."""
    plain = build(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0, attn_impl="plain")
    splits = route_split({"plain": plain, "kernel": pipe}, frames, "attn_impl", iters=12, warmup=4)
    for route, split in splits.items():
        log(f"  stage split, {route} attention, ms (CUDA events, mean of two medians of 8): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))


def phase_unfactored_head() -> dict:
    """``ops.bins.bins_head_depth`` at inference in bf16: kernel 3."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, w, c = BINS_SHAPE
    maps = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    widths = torch.rand((b, 256), generator=gen, device="cuda") + 0.1
    widths = widths / widths.sum(1, keepdim=True)
    weight = 0.1 * torch.randn((256, c, 1, 1), generator=gen, device="cuda")
    bias = 0.1 * torch.randn(256, generator=gen, device="cuda")
    torch.cuda.synchronize()
    zero_counters()
    with torch.no_grad():
        depth, _ = bins_head_depth(widths, maps, weight, bias, 0.001, 10.0, train=False)
    torch.cuda.synchronize()
    log(f"unfactored head: bins_head_depth, eval, bf16 range maps {BINS_SHAPE}")
    launches = expect_launches("unfactored head", bins_shared=1)
    if not torch.isfinite(depth).all() or depth.shape != (b, h, w, 1):
        raise AssertionError(f"unfactored head: bad depth {tuple(depth.shape)}")
    return launches


def phase_encoder_functions() -> dict:
    """Kernels 9 and 10, which no model takes, driven as functions on B5's
    stage-1 tensors at 480x640, batch 8: the (H, W, B, C) MBConv head and
    the depthwise with its pool."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, w, k, cin, m, _ = MBCONV_SHAPES[0]
    x_t, we, be, wd, bd = mbconv_inputs(gen, BATCH, h, w, cin, m, k, batch_minor=True)
    x = torch.randn((BATCH, h, w, m), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    zero_counters()
    with torch.no_grad():
        y_t, pool_t = kmb.mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, k)
        y, pool = kmb.dw_conv_silu_pool(x, wd, bd, k)
    torch.cuda.synchronize()
    log(f"encoder functions: kernel 9 on ({h},{w},{BATCH},{cin}), kernel 10 on "
        f"({BATCH},{h},{w},{m})")
    launches = expect_launches("encoder functions", mbconv_bs=1, dw_conv=1)
    for name, out, shape in (("kernel 9", (y_t, pool_t), (h, w, BATCH, m)),
                             ("kernel 10", (y, pool), (BATCH, h, w, m))):
        if tuple(out[0].shape) != shape or out[1].shape != (BATCH, m) \
                or not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"{name}: bad outputs {tuple(out[0].shape)}")
    return launches


def check_encoder_records(what: str, records: list[dict]) -> None:
    """Each recorded kernel-8 and kernel-7 launch against the plain version
    on its own tensors."""
    errs, flips = collections.defaultdict(float), 0
    for i, rec in enumerate(records):
        if rec["kind"] == "mbconv_head":
            e = check_mbconv(f"{what} kernel-8 call {i}", *rec["args"], *rec["out"])
            errs["kernel 8 y"] = max(errs["kernel 8 y"], e["y"])
            errs["kernel 8 pool"] = max(errs["kernel 8 pool"], e["pool"])
            flips += e["flips"]
        else:
            e = check_se_project(f"{what} kernel-7 call {i}", *rec["args"], rec["out"])
            errs["kernel 7"] = max(errs["kernel 7"], e["out"])
    kinds = collections.Counter(rec["kind"] for rec in records)
    log(f"  {what}: kernels 8 and 7 vs plain on their own tensors, {dict(kinds)} launches: max "
        f"abs err " + ", ".join(f"{k} {v}" for k, v in errs.items())
        + f"; {flips} band values within the expand's bound of a rounding boundary")


def check_encoder_against_fp32(model, **overrides) -> None:
    """The encoder's five outputs on the bf16 kernel route against the same
    weights in fp32 on the plain route (cuDNN without TF32), on 2x384x352;
    the bf16 plain route is logged beside them. ``overrides`` are the
    flagship builder's, as the model was built with them."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    image = torch.randn((2, 384, 352, 3), generator=gen, device="cuda")
    enc = lambda m: m.dense_feature_extractor.encoder["original_model"]  # noqa: E731
    rels = {}
    with torch.inference_mode():
        ref = enc(build_flagship_pipeline(dtype=torch.float32, seed=0, **overrides).model)(image)
        for route in ("kernel", "plain"):
            m = model if route == "kernel" else build_flagship_pipeline(seed=0, **overrides).model
            rels[route] = [rel_l2(g, w) for g, w in zip(enc(m)(image.bfloat16()), ref)]
    log("  encoder outputs, bf16 vs fp32 plain route, 2x384x352, rel L2 by level: kernel route "
        + ", ".join(f"{v:.5f}" for v in rels["kernel"]) + "; bf16 plain route "
        + ", ".join(f"{v:.5f}" for v in rels["plain"]) + f" (bound {ENCODER_REL_BOUND})")
    if not max(rels["kernel"]) < ENCODER_REL_BOUND:
        raise AssertionError("the encoder's kernel route strays from the fp32 reference")


def phase_encoder_route() -> dict:
    """The flagship server on the encoder's kernel route (see the module note)."""
    t0 = time.perf_counter()
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   encoder_impl="kernel")
    model = pipe.model
    routes = collections.Counter(
        model.dense_feature_extractor.encoder["original_model"].block_routes())
    log(f"encoder-kernel server: GraphBins-B5 bf16 folded, encoder_impl {model.encoder_impl}, "
        f"block routes {dict(routes)}; built in {time.perf_counter() - t0:.2f} s")
    if routes != {"mbconv_head": MBCONV_PER_FORWARD, "se_project": SE_PROJECT_PER_FORWARD}:
        raise AssertionError(f"B5's block routes: {dict(routes)}")
    rng = np.random.default_rng(2468)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    with record_kernel_io(model) as records, record_encoder_kernel_io() as enc_records:
        depths = [pipe(f) for f in frames]
    torch.cuda.synchronize()
    n = len(frames)
    launches = expect_launches(f"encoder kernel route, {n} requests of {BATCH} frames",
                               resize=4 * n, bins=n, mbconv_head=MBCONV_PER_FORWARD * n,
                               se_project=SE_PROJECT_PER_FORWARD * n)
    for i, depth in enumerate(depths):
        check_depth(f"request {i}", depth, model.min_depth, model.max_depth)
    check_served_kernels(model, records)
    check_encoder_records("served requests", enc_records)
    del records, enc_records, depths
    check_encoder_against_fp32(model)
    r = served_rate(pipe, frames[:2])
    log(f"  served {r['img_per_s']:.2f} img/s over 20 requests of {BATCH}; p50 {r['p50_ms']:.2f} "
        f"ms, p90 {r['p90_ms']:.2f} ms per request; peak memory {r['peak_gib']:.3f} GiB")
    plain = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0)
    splits = route_split({"plain": plain, "kernel": pipe}, frames[1], "encoder_impl", iters=12,
                         warmup=4)
    for route, split in splits.items():
        log(f"  stage split, {route} encoder, ms (CUDA events, mean of two medians of 8): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return launches


def check_train_kernels(record: dict) -> None:
    """Kernel 4's outputs in a recorded train step against its plain
    versions on the same tensors."""
    pairs = bins_expectation_plain_outputs(record)
    err = check_close("train step bins expectation forward", *pairs["depth"], EXP_RTOL, EXP_ATOL)
    (dl, want_dl), (dc, want_dc) = pairs["dlogits"], pairs["dcenters"]
    err_dl, err_dc = close_backward("train step bins expectation backward", dl, dc, want_dl,
                                    want_dc, record["g"])
    plain_depth = pairs["depth"][1]
    spread = float(plain_depth.max() - plain_depth.min())
    band = EXP_ATOL + EXP_RTOL * float(plain_depth.abs().max())
    log(f"  recorded step: kernel 4 vs plain on its own tensors: depth max abs err {err}, "
        f"dlogits {err_dl}, dcenters {err_dc}; depth spread {spread:.5f} m, "
        f"{spread / band:.0f}x the forward tolerance; max|g| {float(record['g'].abs().max()):.3e}")
    if spread < MIN_SPREAD_IN_TOLERANCES * band:
        raise AssertionError("train step: depth too flat to check kernel 4")


def check_train_against_fp32(model, rng: np.random.Generator) -> dict:
    """One step's gradients on the bf16 kernel route against the same
    weights in fp32 (plain versions, cuDNN without TF32) on a small input,
    with the same draws of augmentation and dropout (one generator seed).
    On kernel 5's route the bf16 step launches it 10 + 9 times; the fp32
    step takes its plain version."""
    attn = 1 if model.attn_impl == "kernel" else 0
    small, b, n_obj = (384, 352), 2, 64
    batch = {
        "image": torch.as_tensor(rng.uniform(0, 1, (b, *small, 3)).astype(np.float32), device="cuda"),
        "depth": torch.as_tensor(rng.uniform(0.01, 9.0, (b, *small, 1)).astype(np.float32),
                                 device="cuda"),
    }
    valid = np.zeros((b, n_obj), bool)
    valid[0, :40], valid[1, :5] = True, True
    objects = {
        "features": torch.as_tensor((0.02 * rng.standard_normal((b, n_obj, 512))).astype(np.float32),
                                    device="cuda"),
        "xywh": torch.as_tensor(rng.uniform(0, 350, (b, n_obj, 4)).astype(np.float32), device="cuda"),
        "valid": torch.as_tensor(valid, device="cuda"),
    }
    names, params = zip(*model.named_parameters())
    grads, losses = {}, {}
    for dtype, want in ((torch.bfloat16, 1), (torch.float32, 0)):
        loss_fn = make_train_loss_fn(model, LossWrapper(*TRAIN_LOSSES), model.min_depth,
                                     augment_on_device=True, compute_dtype=dtype)
        zero_counters()
        loss = loss_fn(batch, objects, torch.Generator(device="cuda").manual_seed(7))
        g = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        expect_launches(f"{dtype} step on 2x{small}", bins_expectation_fwd=want,
                        bins_expectation_bwd=want, attention_fwd=10 * attn * want,
                        attention_bwd=ATTN_BWD_PER_STEP * attn * want)
        grads[dtype] = {n: t for n, t in zip(names, g) if t is not None}
        losses[dtype] = float(loss.detach())
    rels = {}
    for group, (prefixes, _) in TRAIN_GRAD_GROUPS.items():
        keys = [n for n in grads[torch.float32] if n.startswith(prefixes)]
        if not keys:
            raise AssertionError(f"no gradient in group {group}")
        got = torch.cat([grads[torch.bfloat16][n].float().ravel() for n in keys])
        want = torch.cat([grads[torch.float32][n].float().ravel() for n in keys])
        rels[group] = rel_l2(got, want)
    log(f"  bf16 kernel route vs fp32 plain route, one step on 2x{small}: loss "
        f"{losses[torch.bfloat16]:.6f} vs {losses[torch.float32]:.6f}; gradient rel L2 "
        + ", ".join(f"{k} {v:.5f} (bound {TRAIN_GRAD_GROUPS[k][1]})" for k, v in rels.items()))
    if any(rels[k] > TRAIN_GRAD_GROUPS[k][1] for k in rels):
        raise AssertionError("the bf16 train step's gradients stray from the fp32 reference")
    if not abs(losses[torch.bfloat16] - losses[torch.float32]) <= 0.01 * abs(losses[torch.float32]):
        raise AssertionError("the bf16 train step's loss strays from the fp32 reference")
    return rels


def phase_train(attn_impl: str = "plain", n_timed: int = 5) -> tuple[dict, dict]:
    """The flagship train step with its attention on the route ``attn_impl``:
    -> (the counted steps' launches, the gradient groups' rel L2 from fp32)."""
    t0 = time.perf_counter()
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                n_obj=TRAIN_SLOTS, seed=0, attn_impl=attn_impl)
    model = step.model
    if image_seq_len(*TRAIN_DIMS) != TRAIN_SLOTS:
        raise AssertionError(f"expected {TRAIN_SLOTS} image tokens at {TRAIN_DIMS}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train: GraphBins-B5, {n_params} fp32 parameters, bf16 compute, {attn_impl} attention, "
        f"bs {BATCH} at {TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}, {TRAIN_SLOTS} slots; built in "
        f"{time.perf_counter() - t0:.2f} s")
    # on the seed's weights: after a few steps they differ from run to run
    # (cuDNN's backward sums in any order), and the gradients' rounding with them
    rels = check_train_against_fp32(model, np.random.default_rng(99))
    t0 = time.perf_counter()
    losses = [step(batch, objects)]  # warm-up: cuDNN set-up
    torch.cuda.synchronize()
    log(f"  warm-up step {1000 * (time.perf_counter() - t0):.1f} ms")
    zero_counters()
    with record_bins_expectation_io() as records, record_attention_io() as attn_records:
        losses.append(step(batch, objects))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        losses.append(step(batch, objects))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = n_timed + 1
    attn = n if attn_impl == "kernel" else 0
    launches = expect_launches(f"{n} train steps", bins_expectation_fwd=n, bins_expectation_bwd=n,
                               attention_fwd=10 * attn, attention_bwd=ATTN_BWD_PER_STEP * attn)
    values = torch.stack(losses).tolist()
    log(f"  losses {values}")
    if not all(np.isfinite(values)):
        raise AssertionError("train: a loss is not finite")
    log(f"  {1000 * dt / n_timed:.2f} ms/step, {BATCH * n_timed / dt:.2f} img/s over {n_timed} "
        f"steps; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if len(records) != 1 or "dcenters" not in records[0]:
        raise AssertionError(f"train: recorded {len(records)} kernel-4 calls, want 1 with its backward")
    check_train_kernels(records[0])
    if attn_impl == "kernel":
        check_attention_records("recorded step", attn_records, residual=True)
    del records, attn_records
    split = train_stage_split(step, batch, objects, iters=6, warmup=1)
    log("  stage split, ms (CUDA events, median of 5 steps): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return launches, rels


def phase_adabins() -> int:
    """AdaBins-B5 on kernel 5's route: the server, then one train step;
    returns kernel 5's forward launches in the 4 counted requests."""
    t0 = time.perf_counter()
    pipe = build_adabins_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                  attn_impl="kernel")
    model, lo, hi = pipe.model, pipe.model.min_depth, pipe.model.max_depth
    log(f"adabins: AdaBins-B5 bf16 folded, kernel attention, {model.conv_out[0].out_channels} "
        f"bins in [{lo}, {hi}] m; built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(8642)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    with record_kernel_io(model) as records, record_attention_io() as attn_records:
        depths = [pipe(f) for f in frames]
    torch.cuda.synchronize()
    n = len(frames)
    launches = expect_launches(f"adabins, {n} requests of {BATCH} frames", resize=4 * n, bins=n,
                               attention_fwd=4 * n)["attention_fwd"]
    for i, depth in enumerate(depths):
        check_depth(f"adabins request {i}", depth, lo, hi)
    check_served_kernels(model, records)
    check_attention_records("adabins requests", attn_records, residual=False)
    del records, attn_records
    r = served_rate(pipe, frames[:2])
    log(f"  served {r['img_per_s']:.2f} img/s over 20 requests of {BATCH}; p50 "
        f"{r['p50_ms']:.2f} ms, p90 {r['p90_ms']:.2f} ms per request; peak memory "
        f"{r['peak_gib']:.3f} GiB")
    log_route_splits(pipe, build_adabins_pipeline, frames[1])
    del pipe, model

    step, batch = build_adabins_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1], seed=0,
                                      attn_impl="kernel")
    zero_counters()
    t0 = time.perf_counter()
    with record_attention_io() as attn_records:
        loss = float(step(batch, None))
    torch.cuda.synchronize()
    log(f"  adabins train step, bs {BATCH} at {TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}: loss {loss:.6f}, "
        f"{1000 * (time.perf_counter() - t0):.1f} ms (the first step of this model)")
    expect_launches("adabins train step", bins_expectation_fwd=1, bins_expectation_bwd=1,
                    attention_fwd=4, attention_bwd=4)
    if not np.isfinite(loss):
        raise AssertionError("adabins train: the loss is not finite")
    check_attention_records("adabins train step", attn_records, residual=True)
    return launches


def serve_checked(pipe, frames, what: str, lo: float, hi: float, **launches) -> None:
    """One request through a fused server, with its launch counts and depth."""
    zero_counters()
    depth = pipe(frames)
    torch.cuda.synchronize()
    expect_launches(what, **launches)
    check_depth(what, depth, lo, hi, frames.shape[0], pipe.eval_dims)


def check_detector_against_fp32(detector, rng: np.random.Generator) -> None:
    """The detector's bf16 kernel route against the same weights in fp32
    (the plain versions), y5 and coef of each level, on 2x384x352."""
    ref = build_detector(NUM_CLASSES, dtype=torch.float32, seed=1)
    image = torch.as_tensor(rng.uniform(0, 1, (2, 384, 352, 3)).astype(np.float32), device="cuda")
    with torch.inference_mode():
        zero_counters()
        got, _ = detector(image, class_max=True, with_proto=False)
        want, _ = ref(image, class_max=True, with_proto=False)
        torch.cuda.synchronize()
    expect_launches("detector bf16 vs fp32, 2x384x352", detect_head=3)
    rels = {f"{k}{i}": rel_l2(g[k], w[k]) for i, (g, w) in enumerate(zip(got, want))
            for k in ("y5", "coef")}
    log("  detector bf16 kernel route vs fp32 plain route, 2x384x352: rel L2 "
        + ", ".join(f"{k} {v:.5f}" for k, v in rels.items()) + f" (bound {DETECT_REL_BOUND})")
    if not max(rels.values()) < DETECT_REL_BOUND:
        raise AssertionError("the bf16 detector strays from the fp32 reference")


def phase_fused() -> int:
    """The fused server (see the module note); returns kernel 6's launches
    in the 4 counted requests."""
    t0 = time.perf_counter()
    pipe = build_fused_flagship(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                class_max_head=True)
    model, lo, hi = pipe.model, pipe.model.min_depth, pipe.model.max_depth
    log(f"fused: GraphBins-B5 + YOLOv7-seg ({NUM_CLASSES} classes) bf16 folded, class table "
        f"{tuple(pipe.class_table.shape)}, {pipe.n_obj_max} slots, {n_anchors(*EVAL_DIMS)} "
        f"anchors; built in {time.perf_counter() - t0:.2f} s")
    if pipe.n_obj_max != 300 or pipe.class_table.shape != (NUM_CLASSES + 1, 512):
        raise AssertionError("fused: expected 300 slots and a (1204, 512) class table")
    rng = np.random.default_rng(4321)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    detections, run = [], pipe._detections
    pipe._detections = lambda x: detections.append(run(x)) or detections[-1]
    zero_counters()
    with record_kernel_io(model) as records, record_detect_head_io() as det_records:
        depths = [pipe(f) for f in frames]
    torch.cuda.synchronize()
    del pipe._detections
    n = len(frames)
    launches = expect_launches(f"fused, {n} requests of {BATCH} frames, class-max head",
                               resize=4 * n, bins=n, detect_head=3 * n)["detect_head"]
    for i, depth in enumerate(depths):
        check_depth(f"fused request {i}", depth, lo, hi)
    for i, det in enumerate(detections):
        kept = det["valid"].sum(1).tolist()
        cand = det["n_candidates"].tolist()
        log(f"  request {i}: valid detections per image {kept}; n_candidates {cand}; "
            f"pre_topk {det['pre_topk']}")
        if min(kept) < 1 or min(cand) < det["pre_topk"]:
            raise AssertionError("fused: NMS must run on a full pool and keep detections")
    check_served_kernels(model, records)
    for i, rec in enumerate(det_records):
        errs = check_detect_head_outputs(f"fused call {i} detect head", rec["flat"],
                                         rec["packed"], rec["out"])
        if i % 3 == 0 or i == len(det_records) - 1:
            log(f"  served kernel 6 call {i} {tuple(rec['flat'].shape)} vs plain on its own "
                f"tensors: max abs err y5 {errs['y5']} coef {errs['coef']} cls_max "
                f"{errs['cls_max']}; {errs['near_ties']} near-ties of {errs['rows']} rows")
    del records, det_records, detections

    check_detector_against_fp32(pipe.detector, np.random.default_rng(77))

    pipe.class_max_head = None  # the automatic gate: dense at 18,900 anchors
    serve_checked(pipe, frames[1], "fused, automatic gate at 480x640 (dense head)", lo, hi,
                  resize=4, bins=1)
    kitti = FusedDepthPipeline(model, pipe.detector, pipe.class_table, eval_dims=KITTI_DIMS)
    if kitti.n_obj_max != KITTI_SLOTS or not kitti.uses_class_max():
        raise AssertionError(f"KITTI: {kitti.n_obj_max} slots, class-max {kitti.uses_class_max()}")
    kitti_frames = rng.integers(0, 256, (4, *KITTI_DIMS, 3), dtype=np.uint8)
    kitti(kitti_frames)  # warm-up at the new size
    serve_checked(kitti, kitti_frames, f"fused KITTI {KITTI_DIMS}, {n_anchors(*KITTI_DIMS)} "
                  f"anchors, automatic gate", lo, hi, resize=4, bins=1, detect_head=3)
    for knob in ({"det_topk": 128}, {"det_stride": 2}, {"det_scale": 0.5}):
        other = FusedDepthPipeline(model, pipe.detector, pipe.class_table, eval_dims=EVAL_DIMS,
                                   **knob)
        other(frames[2])  # warm-up
        serve_checked(other, frames[3], f"fused with {knob}", lo, hi, resize=4, bins=1)

    for head in (True, False):
        pipe.class_max_head = head
        route = "class-max kernel" if head else "dense head"
        split = fused_stage_split(pipe, frames[0], iters=11, warmup=3)
        log(f"  stage split, {route}, ms (CUDA events, median of 8): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        r = served_rate(pipe, frames[:2])
        log(f"  served {r['img_per_s']:.2f} img/s over 20 requests of {BATCH} ({route}); "
            f"p50 {r['p50_ms']:.2f} ms, p90 {r['p90_ms']:.2f} ms per request; peak memory "
            f"{r['peak_gib']:.3f} GiB")
    return launches


@contextlib.contextmanager
def instrumented_eval_steps():
    """While open, each eval step the trainer makes is timed (synchronised
    before and after: wall ms and the CUDA events' span) and its first call
    records what kernels 1 and 2 got (``record_kernel_io``). Yields a dict:
    'times' [(wall_ms, event_ms)], 'records', 'step' and 'args' (the last
    step and its arguments, to trace it again)."""
    real = eval_loop.make_eval_step
    seen: dict = {"times": [], "records": []}

    def make(model, *args, **kwargs):
        step = real(model, *args, **kwargs)

        def timed(*step_args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if seen["records"]:
                out = step(*step_args)
            else:
                with record_kernel_io(model) as records:
                    out = step(*step_args)
                seen["records"] = records
            end.record()
            torch.cuda.synchronize()
            seen["times"].append((1000 * (time.perf_counter() - t0), start.elapsed_time(end)))
            seen.update(step=step, args=step_args, model=model)
            return out

        return timed

    eval_loop.make_eval_step = make
    try:
        yield seen
    finally:
        eval_loop.make_eval_step = real


def write_eval_files(tmp: str) -> dict[str, str]:
    """A reference-layout .ckpt of a seeded random GraphBins-B5
    (learned_bbox_wh, 256 bins) and two copies of the flagship's params file
    that validate it on synthetic data: 'zeros' sets the zeros provider
    (deterministic slots, 300 at 480x640), 'clip' keeps YOLOv7-seg + CLIP
    with random towers (allow_random_detector)."""
    with open(FLAGSHIP_PARAMS) as f:
        cfg = yaml.safe_load(f)
    args = cli.load_args(FLAGSHIP_PARAMS)
    args.nyu = cli.load_args(BASIC_PARAMS).nyu
    model = init_weights_(build_model(args), torch.Generator().manual_seed(0))
    with torch.no_grad():  # spread the bin logits, so depth varies over the image
        model.conv_out[0].weight.mul_(EVAL_LOGIT_SCALE)
    ckpt = os.path.join(tmp, "run", "checkpoints", "last.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    torch.save(checkpoint_dict(model), ckpt)
    cfg["basic"]["val_checkpoint"] = ckpt
    cfg["paths"] = {"run_dir": os.path.join(tmp, "runs"), "data_dir": os.path.join(tmp, "no_data")}
    paths = {}
    for name, strategy in (("zeros", "control_obj_zeros_512"), ("clip", "clip")):
        cfg["graphbins"]["objcavit"]["language_embedding_strategy"] = strategy
        cfg["allow_random_detector"] = name == "clip"
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    log(f"validate: GraphBins-B5 checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB, configs "
        f"from {os.path.basename(FLAGSHIP_PARAMS)}")
    return paths


def read_validation_output(path: str) -> dict[str, float]:
    """The 16 metrics of validation_output.txt's log block (each also in
    the dict before it: 32 numbers, all finite). The run's name comes
    first, and may hold numbers of its own ('clip_0.1')."""
    with open(path) as f:
        text = f.read()
    numbers = [float(x) for x in NUMBER.findall(text[text.index("[{"):])]
    names = list(METRIC_NAMES) + [f"{k}_ra" for k in METRIC_NAMES]
    if len(numbers) != 2 * len(names) or not all(np.isfinite(numbers)):
        raise AssertionError(f"{path}: want 32 finite numbers, read {numbers}")
    return dict(zip(names, numbers[len(names):]))


def run_cli(what: str, argv: list[str], basic: str = BASIC_PARAMS,
            **launches) -> tuple[object, dict]:
    """One cli.main run on the card (the dataset sections of ``basic``) with
    the counters zeroed just before; its launches must be ``launches``."""
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with instrumented_eval_steps() as seen:
        out = cli.main(argv, basic_params_path=basic)
    torch.cuda.synchronize()
    seen["seconds"] = time.perf_counter() - t0
    seen["launches"] = expect_launches(what, **launches)
    return out, seen


def log_latency(what: str, seen: dict) -> dict:
    """Per-image latency after the first (warm-up) image: median and spread
    of wall and CUDA-event ms, and the device's busy ms per image from one
    trace of 5 more steps on the last image."""
    wall = [t[0] for t in seen["times"][1:]]
    span = [t[1] for t in seen["times"][1:]]
    traced = trace(lambda: seen["step"](*seen["args"]), n_req=5)
    stats = {"wall_p50": statistics.median(wall), "wall_min": min(wall), "wall_max": max(wall),
             "event_p50": statistics.median(span), "busy": traced["device_busy_ms_per_request"],
             "idle": traced["idle_share"], "kernels": traced["device_kernels_per_request"]}
    log(f"  {what}: per image over {len(wall)} images after a warm-up (bs 1, flip-TTA, "
        f"synchronised): wall p50 {stats['wall_p50']:.3f} ms (min {stats['wall_min']:.3f}, max "
        f"{stats['wall_max']:.3f}), CUDA-event span p50 {stats['event_p50']:.3f} ms; traced: device "
        f"busy {stats['busy']:.3f} ms, {stats['kernels']:.0f} kernels, idle share "
        f"{stats['idle']:.3f}; whole run {seen['seconds']:.2f} s "
        f"({1000 * seen['seconds'] / len(seen['times']):.1f} ms an image with data, objects, "
        f"build and restore)")
    log("  top device ops of a traced eval step:\n" + traced["top"])
    return stats


def phase_validate() -> dict:
    """The -v/-i entry points through ``cli.main``: (a) -v --bf16 on the
    zeros config, 16 images, each forward 4 + 1 kernel launches, the first
    one's kernel outputs against their plain versions; (a') -v in fp32,
    TF32 off, no launch, metrics within the bound of (a)'s; (b) -v --debug
    --bf16 on the clip config (random YOLOv7-seg, NMS, phrases, CLIP, a
    re-detect for the mirror); (c) -i --debug --bf16 on the clip config."""
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = write_eval_files(tmp)
        out_dir = os.path.join(tmp, "run")

        bf16, seen = run_cli(f"(a) -v --bf16, {VALIDATE_IMAGES} images", [
            "-c", cfgs["zeros"], "-v", "--bf16"], resize=VALIDATE_IMAGES * EVAL_RESIZE,
            bins=VALIDATE_IMAGES * EVAL_BINS)
        launches = seen["launches"]
        if len(seen["times"]) != VALIDATE_IMAGES:
            raise AssertionError(f"(a): {len(seen['times'])} eval steps, want {VALIDATE_IMAGES}")
        check_depth("(a) first flip-TTA forward", seen["records"][0]["depth"], 0.001, 10.0,
                    batch=2)
        check_served_kernels(seen["model"], seen["records"])
        written = read_validation_output(os.path.join(out_dir, "validation_output.txt"))
        if any(abs(written[k] - bf16[k]) > 1e-6 * abs(bf16[k]) for k in bf16):
            raise AssertionError("(a): validation_output.txt disagrees with the returned metrics")
        latency = log_latency("(a) bf16", seen)
        del seen

        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        fp32, seen = run_cli(f"(a') -v fp32, TF32 off, {VALIDATE_IMAGES} images",
                             ["-c", cfgs["zeros"], "-v"])
        latency["fp32_wall_p50"] = statistics.median(t[0] for t in seen["times"][1:])
        del seen
        gaps = {k: abs(bf16[k] - fp32[k]) for k in fp32}
        log("  (a) bf16 vs (a') fp32 metrics: " + ", ".join(
            f"{k} {bf16[k]:.5f}/{fp32[k]:.5f}" for k in fp32))
        bad = [k for k, g in gaps.items() if g > EVAL_METRIC_ATOL + EVAL_METRIC_RTOL * abs(fp32[k])]
        worst = max(gaps, key=lambda k: gaps[k] / (EVAL_METRIC_ATOL + EVAL_METRIC_RTOL * abs(fp32[k])))
        log(f"  largest gap relative to its bound ({EVAL_METRIC_RTOL} rel + {EVAL_METRIC_ATOL}): "
            f"{worst} {gaps[worst]:.6f}; fp32 wall p50 {latency['fp32_wall_p50']:.3f} ms an image")
        if bad:
            raise AssertionError(f"bf16 metrics stray from fp32's: {bad}")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        calls = collections.Counter()
        real_call = YoloClipObjectProvider.__call__

        def counted(self, images):
            calls["provider"] += 1
            return real_call(self, images)

        YoloClipObjectProvider.__call__ = counted
        try:
            clip_metrics, _ = run_cli("(b) -v --debug --bf16, clip config, 1 image", [
                "-c", cfgs["clip"], "-v", "--debug", "--bf16"], resize=EVAL_RESIZE, bins=EVAL_BINS)
            if calls["provider"] != 2 or not all(np.isfinite(v) for v in clip_metrics.values()):
                raise AssertionError(f"(b): provider calls {calls['provider']} (want 2: the image "
                                     f"and its mirror), metrics {clip_metrics}")
            log(f"  (b) the YOLOv7-seg + CLIP provider ran on the image and re-detected its "
                f"mirror; abs_rel {clip_metrics['abs_rel']:.5f}")
            rows, _ = run_cli("(c) -i --debug --bf16, clip config, 1 image", [
                "-c", cfgs["clip"], "-i", "--debug", "--bf16"], resize=EVAL_RESIZE, bins=EVAL_BINS)
        finally:
            YoloClipObjectProvider.__call__ = real_call
        pred_dir = os.path.join(out_dir, "predict_output")
        with open(os.path.join(pred_dir, "prediction_metrics.csv"), newline="") as f:
            table = list(csv.reader(f))
        header = (["", "batch_idx", "image_filename", "depth_gt_filename"] + list(METRIC_NAMES)
                  + [f"{k}_ra" for k in METRIC_NAMES] + ["loss"])
        files = sorted(os.listdir(pred_dir))
        want_files = sorted(["prediction_metrics.csv"] + [
            f"0_{k}" for k in ("im.png", "dets.png", "depth_gt.png", "depth_pred.png",
                               "depth_gt_raw.npy", "depth_pred_raw.npy")])
        if table[0] != header or len(table) != 2 or files != want_files:
            raise AssertionError(f"(c): header {table[0]}, {len(table) - 1} rows, files {files}")
        log(f"  (c) prediction_metrics.csv: pinned header, 1 row; files {files}")
    return {"launches": launches, "latency": latency}


# phase 10: fit through the CLI on the flagship's params file (its nyu
# section from basicParams.yaml), on NYU frames written in the dataset's
# layout: 32 train and 16 eval frames, 480x640, RGB and uint16 depth in mm
FIT_TRAIN, FIT_EVAL, FIT_SWA_TRAIN = 32, 16, 8
FIT_EPOCHS, FIT_RESUME_EPOCHS, FIT_SWA_EPOCHS = 2, 3, 10
FIT_STEPS = FIT_TRAIN // BATCH  # steps an epoch
FIT_EVAL_STEPS = FIT_EVAL // BATCH  # in-fit validation steps an epoch (a 2B forward each)
FIT_TRACED_STEPS = 3
FIT_LR = 0.000357  # the flagship params file's optimizer.lr
# (d) holds -v at bs 1 against the last in-fit validation at bs 8 at phase
# 9's bf16 bound (EVAL_METRIC_RTOL + EVAL_METRIC_ATOL): the same weights
# and images, but the convolutions' algorithms differ with the batch, and a
# bf16 rounding that moves an image's bins can move all its pixels at once;
# across H100 calls the widest gap read 3.5e-5 to 3.6e-4, and once over
# 1e-3 (sq_rel; PERF.md §6). Which checkpoint -v restored is checked
# directly, not through the metrics


def write_frame(image_path: str, depth_path: str, dims: tuple[int, int],
                rng: np.random.Generator, depth_scale: float) -> None:
    """A random uint8 RGB frame and a smooth depth field in 0.5-9.5 m, in
    ``depth_scale`` units a metre in 16 bits, as the datasets store them."""
    from PIL import Image

    for path in (image_path, depth_path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (*dims, 3), dtype=np.uint8)).save(image_path)
    coarse = torch.as_tensor(rng.uniform(0.5, 9.5, (1, 1, 6, 8)), dtype=torch.float32)
    depth = F.interpolate(coarse, size=dims, mode="bilinear", align_corners=True)
    Image.fromarray((depth_scale * depth[0, 0].numpy()).astype(np.uint16)).save(depth_path)


def write_fit_files(tmp: str, params: str = FLAGSHIP_PARAMS) -> dict[str, str]:
    """The frames, the split files, a basicParams.yaml whose nyu section
    reads them, a warm-start .ckpt (write_eval_files' seeded B5) and the
    params files of the three fits, copies of ``params``: 'fit' (2 epochs),
    'resume' (the same run to 3), 'swa' (use_swa over 8 train frames, 10
    epochs of one step, validated every 5)."""
    rng = np.random.default_rng(10)
    data = os.path.join(tmp, "data")

    splits = {}
    for split, sub, n in (("train", "sync", FIT_TRAIN), ("eval", "official_splits/test", FIT_EVAL)):
        lines = []
        for i in range(n):
            img, dep = f"scene_{i % 4}/rgb_{i:05d}.png", f"scene_{i % 4}/sync_depth_{i:05d}.png"
            # depth in mm
            write_frame(os.path.join(data, "nyu", sub, img), os.path.join(data, "nyu", sub, dep),
                        EVAL_DIMS, rng, 1000.0)
            lines.append(f"/{img} /{dep} 518.8579")
        splits[split] = os.path.join(tmp, f"nyu_{split}.txt")
        with open(splits[split], "w") as f:
            f.write("\n".join(lines) + "\n")
    splits["swa"] = os.path.join(tmp, "nyu_train_swa.txt")
    with open(splits["train"]) as f, open(splits["swa"], "w") as g:
        g.writelines(f.readlines()[:FIT_SWA_TRAIN])

    with open(BASIC_PARAMS) as f:
        basic = yaml.safe_load(f)
    basic["nyu"].update(filenames_file_train=splits["train"], filenames_file_eval=splits["eval"])
    paths = {"basic": os.path.join(tmp, "basicParams.yaml")}
    with open(paths["basic"], "w") as f:
        yaml.safe_dump(basic, f)
    cfg_args = cli.load_args(params)
    cfg_args.nyu = cli.load_args(paths["basic"]).nyu
    model = init_weights_(build_model(cfg_args), torch.Generator().manual_seed(0))
    with torch.no_grad():  # spread the bin logits, as write_eval_files does
        model.conv_out[0].weight.mul_(EVAL_LOGIT_SCALE)
    warm = os.path.join(tmp, "warm.ckpt")
    torch.save(checkpoint_dict(model), warm)
    del model
    with open(params) as f:
        cfg = yaml.safe_load(f)
    cfg["nyu"] = basic["nyu"]
    cfg["paths"] = {"run_dir": os.path.join(tmp, "runs"), "data_dir": data}
    cfg["allow_random_detector"] = True
    cfg["basic"].update(name="fit", from_checkpoint=warm)
    for name, epochs in (("fit", FIT_EPOCHS), ("resume", FIT_RESUME_EPOCHS)):
        cfg["basic"]["max_epochs"] = epochs
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    cfg["basic"].update(name="swa", max_epochs=FIT_SWA_EPOCHS, validate_every=5)
    cfg["optimizer"]["use_swa"] = True
    cfg["nyu"] = {**basic["nyu"], "filenames_file_train": splits["swa"]}
    paths["swa"] = os.path.join(tmp, "swa.yaml")
    with open(paths["swa"], "w") as f:
        yaml.safe_dump(cfg, f)
    log(f"fit: {FIT_TRAIN} train and {FIT_EVAL} eval NYU frames at {EVAL_DIMS[0]}x{EVAL_DIMS[1]}, "
        f"configs from {os.path.basename(params)} (clip provider, random towers)")
    return paths


@contextlib.contextmanager
def instrumented_fit(record_step: int = 1):
    """While open, each train step the trainer makes is timed (synchronised
    before and after: wall ms and the CUDA events' span) with its LR; step
    ``record_step`` records kernel 4's I/O; the in-fit validation's steps
    are instrumented as phase 9's (``instrumented_eval_steps``, the last
    validation's first step recorded). Steps, validations, train figures
    and checkpoint saves land on a timeline of (kind, start s, end s),
    synchronised at their ends. Yields a dict: 'times', 'lrs', 'losses',
    'records', 'spans', 'eval' (instrumented_eval_steps' dict), and 'step'
    and 'args' of the last step."""
    seen: dict = {"times": [], "lrs": [], "losses": [], "records": [], "spans": []}
    patched = []

    def span(owner, name: str, kind: str, before=None) -> None:
        real = getattr(owner, name)

        def timed(*args, **kwargs):
            if before is not None:
                before()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            seen["spans"].append((kind, t0, time.perf_counter()))
            return out

        patched.append((owner, name, real))
        setattr(owner, name, timed)

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(*step_args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if len(seen["times"]) == record_step:
                with record_bins_expectation_io() as records:
                    loss = step(*step_args)
                seen["records"] = records
            else:
                loss = step(*step_args)
            end.record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            seen["spans"].append(("steps", t0, t1))
            seen["times"].append((1000 * (t1 - t0), start.elapsed_time(end)))
            seen["lrs"].append(step.last_lr)
            timed.last_lr = step.last_lr  # what fit logs as lr-AdamW
            seen["losses"].append(float(loss))
            seen.update(step=step, args=step_args)
            return loss

        timed.last_lr = None
        return timed

    real_make = eval_loop.make_train_step
    eval_loop.make_train_step = make
    # the last validation's first step is recorded: the checks after the fit
    # read the weights it ran on
    span(eval_loop.Trainer, "_run_eval", "validation",
         before=lambda: seen["eval"].__setitem__("records", []))
    span(eval_loop.Trainer, "_log_train_figure", "train figure")
    span(eval_loop.CheckpointManager, "save", "checkpoint save")
    try:
        with instrumented_eval_steps() as evals:
            seen["eval"] = evals
            yield seen
    finally:
        eval_loop.make_train_step = real_make
        for owner, name, real in patched:
            setattr(owner, name, real)


def epoch_breakdown(spans: list) -> dict[str, float]:
    """Seconds of the last epoch (from the previous epoch's checkpoint save
    to its own) by kind; the rest is the wait for the loader's batches."""
    saves = [t1 for kind, _, t1 in spans if kind == "checkpoint save"]
    lo, hi = saves[-2], saves[-1]
    parts = collections.Counter()
    for kind, t0, t1 in spans:
        if lo <= t0 and t1 <= hi:
            parts[kind] += t1 - t0
    return {"epoch": hi - lo, **parts, "loader wait and the rest": hi - lo - sum(parts.values())}


def run_fit(what: str, argv: list[str], basic: str, **launches) -> tuple[dict, dict]:
    """One training run of cli.main on the card with the counters zeroed
    just before; its launches must be ``launches``. -> (the fit's last
    metrics, the instrumentation's dict)."""
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with instrumented_fit() as seen:
        _model, metrics = cli.main(argv, basic_params_path=basic)
        del _model
    torch.cuda.synchronize()
    seen["seconds"] = time.perf_counter() - t0
    seen["launches"] = expect_launches(what, **launches)
    losses = seen["losses"]
    log(f"  {what}: {len(losses)} steps, losses {losses}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(list(metrics.values()))):
        raise AssertionError(f"{what}: a loss or a metric is not finite")
    return metrics, seen


def onecycle_lrs(total: int) -> list[float]:
    """The LR of each of ``total`` updates on the port's OneCycle path."""
    optimizer, scheduler = build_optimizer(torch.nn.ParameterList([torch.nn.Parameter(
        torch.zeros(1))]), FIT_LR, 0.1, total)
    lrs = []
    for _ in range(total):
        lrs.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    return lrs


def has_tensorboard() -> bool:
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        return False
    return True


def fit_eval_launches(epochs: int, validations: int, figures: int) -> dict:
    """Kernels 1 and 2's launches in a fit: each validation's eval steps
    and, where TensorBoard imports (``figures`` 1), each epoch's train
    figure, a forward each."""
    forwards = validations * FIT_EVAL_STEPS + figures * epochs
    return {"resize": EVAL_RESIZE * forwards, "bins": EVAL_BINS * forwards}


def phase_fit() -> dict:
    """``python -m objcavit_torch.cli -c <cfg> --bf16`` (Trainer.fit) at the
    flagship's width: GraphBins-B5, bs 8 at 416x544 with rotation and the
    card's augmentation, 221 slots from random YOLOv7-seg + CLIP towers,
    warm-started from a .ckpt. (a) 2 epochs of 4 steps: kernel 4 forward and
    backward every step, one recorded step held against the plain versions;
    kernels 1 and 2 in the in-fit validation (2 eval steps an epoch, 16-image
    flip-TTA forwards), the first held against the plain versions; the
    train figure's forward where TensorBoard imports; wall and device ms a
    step and the idle share (a trace of 3 more steps); the last
    validation's first step held against the plain versions. (b) --resume to 3
    epochs: the same version_0, step 8 -> 12, the LR of each resumed update
    the 12-step schedule's, AdamW's moments restored. (c) use_swa over 10
    epochs of one step: 2 averaged epochs, the BN refresh's kernel-4
    forward, last.ckpt the average with the refreshed statistics. (d) -v
    --bf16 on the run's hparams.yaml: it restores the run's last.ckpt (the
    path, and the model's entries equal to the file's), and its metrics
    are within phase 9's bf16 bound of the last in-fit validation's."""
    # TF32 off, as from phase 3 on in a whole run: with it, the clip
    # provider's random detector gives other slots at bs 1 than at bs 8
    # (utils/detector_batch.py), and (d) would compare two inputs
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    writer = has_tensorboard()
    fig = 1 if writer else 0
    log(f"fit: a TensorBoard writer {'exists' if writer else 'does not import'}: train figures "
        f"{'on' if writer else 'off'}")
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = write_fit_files(tmp)
        run = os.path.join(tmp, "runs", "fit", "version_0")

        def val_launches(epochs: int, validations: int) -> dict:
            return fit_eval_launches(epochs, validations, fig)

        steps = FIT_EPOCHS * FIT_STEPS
        metrics, seen = run_fit(f"(a) fit --bf16, {FIT_EPOCHS} epochs of {FIT_STEPS} steps", [
            "-c", cfgs["fit"], "--bf16"], cfgs["basic"], bins_expectation_fwd=steps,
            bins_expectation_bwd=steps, **val_launches(FIT_EPOCHS, FIT_EPOCHS))
        launches = seen["launches"]
        if len(seen["records"]) != 1 or "dcenters" not in seen["records"][0]:
            raise AssertionError("(a): no recorded kernel-4 step with its backward")
        check_train_kernels(seen["records"][0])
        check_served_kernels(seen["eval"]["model"], seen["eval"]["records"])
        wall = [t[0] for t in seen["times"][1:]]
        span = [t[1] for t in seen["times"][1:]]
        epoch = epoch_breakdown(seen["spans"])
        # more steps on the last batch, past the schedule's end: without the
        # scheduler (its host-side step launches nothing)
        seen["step"].scheduler = None
        traced = trace(lambda: seen["step"](*seen["args"]), n_req=FIT_TRACED_STEPS)
        stats = {"wall_p50": statistics.median(wall), "wall_min": min(wall),
                 "wall_max": max(wall), "event_p50": statistics.median(span),
                 "busy": traced["device_busy_ms_per_request"], "idle": traced["idle_share"],
                 "kernels": traced["device_kernels_per_request"],
                 "val_share": epoch["validation"] / epoch["epoch"], "seconds": seen["seconds"],
                 "epoch": epoch}
        log(f"  (a) per step over {len(wall)} steps after the first (bs {BATCH}, "
            f"{TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}, synchronised): wall p50 {stats['wall_p50']:.3f} ms "
            f"(min {stats['wall_min']:.3f}, max {stats['wall_max']:.3f}), CUDA-event span p50 "
            f"{stats['event_p50']:.3f} ms; traced ({FIT_TRACED_STEPS} steps): device busy "
            f"{stats['busy']:.3f} ms, {stats['kernels']:.0f} kernels, idle share "
            f"{stats['idle']:.3f}; whole run {seen['seconds']:.2f} s")
        log("  (a) the second epoch, s: " + ", ".join(f"{k} {v:.3f}" for k, v in epoch.items())
            + f"; the validation's share {stats['val_share']:.3f}")
        log("  top device ops of a traced fit step:\n" + traced["top"])
        del seen

        steps = (FIT_RESUME_EPOCHS - FIT_EPOCHS) * FIT_STEPS
        resumed, seen = run_fit("(b) fit --resume --bf16 to 3 epochs", [
            "-c", cfgs["resume"], "--bf16", "--resume"], cfgs["basic"],
            bins_expectation_fwd=steps, bins_expectation_bwd=steps,
            **val_launches(FIT_RESUME_EPOCHS - FIT_EPOCHS, FIT_RESUME_EPOCHS - FIT_EPOCHS))
        versions = sorted(os.listdir(os.path.dirname(run)))
        ckpt = torch.load(os.path.join(run, "checkpoints", "last.ckpt"), map_location="cpu",
                          weights_only=False)
        state = ckpt["optimizer_states"][0]["state"]
        counts = {float(s["step"]) for s in state.values()}
        want_lrs = onecycle_lrs(FIT_RESUME_EPOCHS * FIT_STEPS)[FIT_EPOCHS * FIT_STEPS:]
        log(f"  (b) versions {versions}, step {ckpt['global_step']}, AdamW step counts {counts}, "
            f"LRs {seen['lrs']} (the 12-step schedule's {want_lrs})")
        if (versions != ["version_0"] or ckpt["global_step"] != FIT_RESUME_EPOCHS * FIT_STEPS
                or counts != {float(FIT_RESUME_EPOCHS * FIT_STEPS)}
                or not sum(float(s["exp_avg_sq"].abs().sum()) for s in state.values()) > 0
                or any(abs(a - b) > 1e-12 * b for a, b in zip(seen["lrs"], want_lrs))
                or len(seen["lrs"]) != len(want_lrs)):
            raise AssertionError("(b): the resumed run did not continue the killed one")
        del ckpt, state, seen

        refreshed = {}
        real_refresh = eval_loop.Trainer._refresh_swa_batch_stats

        def refresh(self, *args, **kwargs):
            refreshed["before"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()
                                   if k.endswith(("running_mean", "running_var"))}
            real_refresh(self, *args, **kwargs)
            refreshed["after"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()
                                  if k.endswith(("running_mean", "running_var"))}

        eval_loop.Trainer._refresh_swa_batch_stats = refresh
        try:
            _, seen = run_fit(f"(c) fit --bf16 use_swa, {FIT_SWA_EPOCHS} epochs of 1 step", [
                "-c", cfgs["swa"], "--bf16"], cfgs["basic"],
                bins_expectation_fwd=FIT_SWA_EPOCHS + 1, bins_expectation_bwd=FIT_SWA_EPOCHS,
                **val_launches(FIT_SWA_EPOCHS, 2))
        finally:
            eval_loop.Trainer._refresh_swa_batch_stats = real_refresh
        swa_dir = os.path.join(tmp, "runs", "swa", "version_0", "checkpoints")
        with open(os.path.join(swa_dir, "meta.json")) as f:
            meta = json.load(f)
        last = torch.load(os.path.join(swa_dir, "last.ckpt"), map_location="cpu",
                          weights_only=False)["state_dict"]
        average = torch.load(os.path.join(swa_dir, "swa.ckpt"), map_location="cpu",
                             weights_only=True)["state_dict"]
        same_avg = all(torch.equal(last[k], v) for k, v in average.items())
        same_stats = all(torch.equal(last[f"model.{k}"], v.cpu())
                         for k, v in refreshed["after"].items())
        moved = sum(not torch.equal(refreshed["before"][k], v) for k, v in refreshed["after"].items())
        log(f"  (c) meta {meta}; last.ckpt holds the average: {same_avg}, the refreshed "
            f"statistics: {same_stats} ({moved} of {len(refreshed['after'])} moved by the refresh)")
        if meta.get("swa_count") != 2 or not same_avg or not same_stats or not moved:
            raise AssertionError("(c): the SWA run's checkpoint is not the refreshed average")
        del last, average, seen

        hparams = os.path.join(run, "hparams.yaml")
        restored = []
        real_restore = eval_loop.restore_checkpoint

        def restore(path, model, *args, **kwargs):
            restored.append(os.path.realpath(path))
            return real_restore(path, model, *args, **kwargs)

        eval_loop.restore_checkpoint = restore
        try:
            validated, seen = run_cli("(d) -v --bf16 on the fit's hparams.yaml", [
                "-c", hparams, "-v", "--bf16"], cfgs["basic"], resize=FIT_EVAL * EVAL_RESIZE,
                bins=FIT_EVAL * EVAL_BINS)
        finally:
            eval_loop.restore_checkpoint = real_restore
        check_served_kernels(seen["model"], seen["records"])
        last_ckpt = os.path.realpath(os.path.join(run, "checkpoints", "last.ckpt"))
        saved = torch.load(last_ckpt, map_location="cpu", weights_only=False)["state_dict"]
        held = {k: v for k, v in seen["model"].state_dict().items()
                if not k.endswith("num_batches_tracked")}
        same = all(torch.equal(v.cpu(), saved[f"model.{k}"]) for k, v in held.items())
        log(f"  (d) -v restored {restored}; its model equals last.ckpt's {len(held)} entries: "
            f"{same}")
        if restored != [last_ckpt] or not same:
            raise AssertionError("(d): -v did not validate the fit's last.ckpt")
        del saved, held, seen
    rel = {k: abs(validated[k] - resumed[k]) / abs(resumed[k]) for k in METRIC_NAMES}
    log(f"  (d) -v (bs 1) vs the last in-fit validation (bs 8), relative gap (bound "
        f"{EVAL_METRIC_RTOL} rel + {EVAL_METRIC_ATOL}): " + ", ".join(
            f"{k} {validated[k]!r}/{resumed[k]!r} {rel[k]:.3e}" for k in METRIC_NAMES))
    bad = [k for k in METRIC_NAMES if not abs(validated[k] - resumed[k])
           <= EVAL_METRIC_ATOL + EVAL_METRIC_RTOL * abs(resumed[k])]
    if bad:
        raise AssertionError(f"(d): -v strays from the fit's validation: {bad}")
    return {"launches": launches, "stats": stats}


# phase 11: ObjCAViT's other options on GraphBins-B5 at full width, on
# kernel 5's route
OPTIONS = {
    "learned": {"pos_strategy": "learned"},
    "grid_random": {"pos_strategy": "grid_random"},
    "grid_random_roi_align": {"pos_strategy": "grid_random_roi_align"},
    "learned_bbox_wh + no_obj_sa": {"no_obj_sa": True},
    "learned_bbox_wh + use_2_saca": {"use_2_saca": True},
}
# (c): the CLI's -v on copies of these params files
OPTION_PARAMS = (
    "nyu_graphbins_enet-b5_ocv_pos_grid_random_roi_align_emb_128_old_dl_1.yaml",
    "nyu_graphbins_enet-b5_ocv_pos_learned_emb_128_no_obj_sa_old_dl_1.yaml",
    "nyu_graphbins_enet-b5_ocv_pos_learned_bbox_wh_emb_128_lang_name_synset_def_wn_rel_sz_clip"
    "_use_2_saca_1.yaml",
)
# built only: KITTI's grid table, one row per 16-pixel patch of the larger
# full-resolution size (376x1241: 24 x 78 = 1872)
KITTI_GRID_PARAMS = "kitti_graphbins_enet-b5_ocv_pos_grid_random_roi_align_emb_128_old_dl_1.yaml"
KITTI_GRID_ROWS = 1872


def attention_launches(no_obj_sa: bool = False, use_2_saca: bool = False, **_) -> tuple[int, int]:
    """Kernel 5's (forward, backward) launches of one forward and one train
    step, from ObjCAViT's options: a SACA runs 4 image self-attentions, 4
    object ones (none under no_obj_sa) and 2 cross-attentions; use_2_saca
    runs two SACAs. The last SACA's object branch (cross_attn_im_obj) gives
    an output nothing reads, so a step runs its backward for every
    attention but that one; under use_2_saca the first SACA's object branch
    feeds the second and has its backward."""
    fwd = (4 + (0 if no_obj_sa else 4) + 2) * (2 if use_2_saca else 1)
    return fwd, fwd - 1


def serve_option(label: str, options: dict) -> dict:
    """(a) for one option: the B5 bf16 server on kernel 5's route answers a
    request with detector-style slots and one with the sentinel; each
    forward's launches, its kernels against their plain versions on its
    own tensors, depth, ObjCAViT's outputs against fp32; then the served
    rate and ObjCAViT's stage time."""
    t0 = time.perf_counter()
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   attn_impl="kernel", **options)
    model = pipe.model
    rng = np.random.default_rng(2468)
    with_objects = DepthPipeline(model, eval_dims=EVAL_DIMS,
                                 provider=make_provider(rng, pipe.n_obj_max))
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(2)]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    log(f"options, {label}: GraphBins-B5 bf16 folded, kernel attention, {pipe.n_obj_max} slots; "
        f"built and warmed up in {time.perf_counter() - t0:.2f} s")
    fwd, _ = attention_launches(**options)
    zero_counters()
    with record_kernel_io(model) as records, record_attention_io() as attn_records:
        depths = [with_objects(frames[0]), pipe(frames[1])]
    torch.cuda.synchronize()
    launches = expect_launches(f"{label}: 2 requests of {BATCH} frames", resize=8, bins=2,
                               attention_fwd=2 * fwd)
    for route, depth in zip(("objects", "sentinel"), depths):
        check_depth(f"{label} ({route})", depth, model.min_depth, model.max_depth)
    check_served_kernels(model, records)
    check_attention_records(f"{label} requests", attn_records, residual=False)
    del records, attn_records
    check_against_fp32(model, rng, **options)
    rate = served_rate(pipe, frames, n_req=10, n_lat=5)
    split = stage_split(pipe, frames[1], iters=8, warmup=2)
    log(f"  {label}: served {rate['img_per_s']:.2f} img/s over 10 requests of {BATCH} (sentinel "
        f"route), p50 {rate['p50_ms']:.2f} ms of 5; ObjCAViT stage {split['objcavit']:.3f} ms of "
        f"{split['total']:.3f} (CUDA events, median of 6)")
    return launches


def train_option(label: str, options: dict) -> dict:
    """(b) for one option: one train step of GraphBins-B5 at bs 8, 416x544,
    221 slots on kernel 5's route: its launches, kernel 5's and kernel 4's
    outputs against their plain versions, a finite loss."""
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                n_obj=TRAIN_SLOTS, seed=0, attn_impl="kernel",
                                                **options)
    fwd, bwd = attention_launches(**options)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with record_bins_expectation_io() as records, record_attention_io() as attn_records:
        loss = float(step(batch, objects))
    torch.cuda.synchronize()
    launches = expect_launches(f"{label}: one train step", bins_expectation_fwd=1,
                               bins_expectation_bwd=1, attention_fwd=fwd, attention_bwd=bwd)
    log(f"  {label}: train step (the first) loss {loss:.6f}, "
        f"{1000 * (time.perf_counter() - t0):.1f} ms")
    if not np.isfinite(loss):
        raise AssertionError(f"{label}: the train loss is not finite")
    check_train_kernels(records[0])
    check_attention_records(f"{label} step", attn_records, residual=True, cancelling=True)
    return launches


def write_option_files(tmp: str, names=OPTION_PARAMS) -> dict[str, str]:
    """Copies of the params files ``names`` that validate a seeded random
    model of each (its conv_out spread as phase 9's) on the 16 synthetic
    NYU images, with random YOLOv7-seg and CLIP towers where the file asks
    for clip. A GraphBins file that names no language strategy (the V2-M
    one predates the language keys, which neither CLI runs without) gets
    the zeros provider, which needs no other key."""
    paths = {}
    for name in names:
        src = os.path.join(REPO, "params", name)
        with open(src) as f:
            cfg = yaml.safe_load(f)
        if cfg["model"]["name"] == "graphbins":
            cfg["graphbins"]["objcavit"].setdefault("language_embedding_strategy",
                                                    "control_obj_zeros_512")
        args = cli.load_args(src)
        args.nyu = cli.load_args(BASIC_PARAMS).nyu  # the sections -v reads
        model = init_weights_(build_model(args), torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.conv_out[0].weight.mul_(EVAL_LOGIT_SCALE)
        run = os.path.join(tmp, name[:-5])
        ckpt = os.path.join(run, "checkpoints", "last.ckpt")
        os.makedirs(os.path.dirname(ckpt))
        torch.save(checkpoint_dict(model), ckpt)
        del model
        cfg["basic"]["val_checkpoint"] = ckpt
        cfg["paths"] = {"run_dir": os.path.join(tmp, "runs"),
                        "data_dir": os.path.join(tmp, "no_data")}
        cfg["allow_random_detector"] = True
        paths[name] = os.path.join(tmp, name)
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def phase_options() -> dict:
    """ObjCAViT's other options: (a) serving and (b) a train step of each on
    kernel 5's route, (c) -v --debug --bf16 through the CLI on three params
    files, and the KITTI grid table's rows. Returns the kernel launches of
    (a) and (b), summed over the options."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    served, trained = collections.Counter(), collections.Counter()
    for label, options in OPTIONS.items():
        served.update(serve_option(label, options))
        trained.update(train_option(label, options))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg in write_option_files(tmp).items():
            metrics, _ = run_cli(f"(c) -v --debug --bf16, {name}", ["-c", cfg, "-v", "--debug",
                                                                   "--bf16"],
                                 resize=EVAL_RESIZE, bins=EVAL_BINS)
            out = os.path.join(tmp, name[:-5], "validation_output.txt")
            written = read_validation_output(out)
            if any(abs(written[k] - metrics[k]) > 1e-6 * abs(metrics[k]) for k in metrics):
                raise AssertionError(f"{name}: validation_output.txt disagrees with the metrics")
            log(f"  {name}: validation_output.txt written; abs_rel {metrics['abs_rel']:.5f}")
    args = cli.load_args(os.path.join(REPO, "params", KITTI_GRID_PARAMS))
    with torch.device("meta"):
        rows = build_model(args).objcavit.positional_encoder.positional_encodings.shape[0]
    log(f"  {KITTI_GRID_PARAMS}: built, grid table of {rows} rows")
    if rows != KITTI_GRID_ROWS:
        raise AssertionError(f"KITTI's grid table has {rows} rows, want {KITTI_GRID_ROWS}")
    log(f"options: {time.perf_counter() - t0:.1f} s")
    return {"served": dict(served), "trained": dict(trained)}


# phase 12: GraphBins on EfficientNet-V2-M, the model of V2M_PARAMS, on
# kernel 5's route; its kernel-7 launches a forward (one per MBConv block:
# 7 + 14 + 18 + 5; its 13 FusedMBConv blocks stay cuDNN convs)
V2M_PARAMS = "nyu_graphbins_enet-v2-m_ocv_pos_learned_emb_128_1.yaml"
V2M = {"encoder_name": "efficientnet-v2-m", "pos_strategy": "learned"}
V2M_SE_PROJECT, V2M_FUSED = 44, 13
# (c): the CLI's -v on copies of these params files (AdaBins-V2-S's too)
V2_PARAMS = (V2M_PARAMS, "nyu_efficientnet-v2-s_clip_0.1_lossfixed.yaml")


def serve_v2(impl: str, frames: list) -> tuple[DepthPipeline, dict]:
    """(a) on the encoder route ``impl``: the V2-M server answers
    ``frames``; each forward's launches, its kernels against their plain
    versions on their own tensors, depth; then the served rate."""
    t0 = time.perf_counter()
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   attn_impl="kernel", encoder_impl=impl, **V2M)
    model = pipe.model
    routes = collections.Counter(
        model.dense_feature_extractor.encoder["original_model"].block_routes())
    want = ({"se_project": V2M_SE_PROJECT, "plain": V2M_FUSED} if impl == "kernel"
            else {"plain": V2M_SE_PROJECT + V2M_FUSED})
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    log(f"V2 encoders: GraphBins-V2-M bf16 folded, kernel attention, encoder_impl {impl}, "
        f"{pipe.n_obj_max} slots, block routes {dict(routes)}; built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    if routes != want or pipe.n_obj_max != 300:
        raise AssertionError(f"V2-M's block routes {dict(routes)}, want {want}; "
                             f"{pipe.n_obj_max} slots")
    zero_counters()
    with record_kernel_io(model) as records, record_encoder_kernel_io() as enc_records, \
            record_attention_io() as attn_records:
        depths = [pipe(f) for f in frames]
    torch.cuda.synchronize()
    n = len(frames)
    launches = expect_launches(f"V2-M, {impl} encoder, {n} requests of {BATCH} frames",
                               resize=4 * n, bins=n, attention_fwd=10 * n,
                               se_project=V2M_SE_PROJECT * n if impl == "kernel" else 0)
    for i, depth in enumerate(depths):
        check_depth(f"request {i}", depth, model.min_depth, model.max_depth)
    check_served_kernels(model, records)
    check_attention_records("V2-M requests", attn_records, residual=False)
    if impl == "kernel":
        check_encoder_records("V2-M requests", enc_records)
        check_encoder_against_fp32(model, attn_impl="kernel", **V2M)
    del records, enc_records, attn_records, depths
    r = served_rate(pipe, frames[:2], n_req=10, n_lat=5)
    t = trace(lambda: pipe(frames[1]), n_req=3)
    log(f"  {impl} encoder: served {r['img_per_s']:.2f} img/s over 10 requests of {BATCH}; p50 "
        f"{r['p50_ms']:.2f} ms of 5 requests; peak memory {r['peak_gib']:.3f} GiB; traced (3 "
        f"requests): {t['window_ms_per_request']:.3f} ms a request, device busy "
        f"{t['device_busy_ms_per_request']:.3f} ms, {t['device_kernels_per_request']:.0f} kernels, "
        f"idle share {t['idle_share']:.3f}; device ms by kind: "
        + ", ".join(f"{k} {v:.3f}" for k, v in t["device_ms_per_request_by_kind"].items()))
    return pipe, launches


def phase_v2() -> dict:
    """The V2 encoders: (a) the GraphBins-V2-M server on both encoder
    routes and their stage splits, (b) its train step, (c) -v --debug --bf16
    through the CLI on the GraphBins-V2-M and AdaBins-V2-S params files.
    Returns the kernel launches of (a) and (b), summed."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rng = np.random.default_rng(1357)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    launches = collections.Counter()
    pipes = {}
    for impl in ("plain", "kernel"):
        pipes[impl], served = serve_v2(impl, frames)
        launches.update(served)
    splits = route_split(pipes, frames[1], "encoder_impl", iters=8, warmup=2)
    for route, split in splits.items():
        log(f"  stage split, V2-M, {route} encoder, ms (CUDA events, mean of two medians of 6): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    del pipes
    torch.cuda.empty_cache()
    launches.update(train_option("V2-M", V2M))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg in write_option_files(tmp, V2_PARAMS).items():
            metrics, _ = run_cli(f"(c) -v --debug --bf16, {name}", ["-c", cfg, "-v", "--debug",
                                                                   "--bf16"],
                                 resize=EVAL_RESIZE, bins=EVAL_BINS)
            written = read_validation_output(os.path.join(tmp, name[:-5], "validation_output.txt"))
            if any(abs(written[k] - metrics[k]) > 1e-6 * abs(metrics[k]) for k in metrics):
                raise AssertionError(f"{name}: validation_output.txt disagrees with the metrics")
            log(f"  {name}: validation_output.txt written; abs_rel {metrics['abs_rel']:.5f}")
    log(f"V2 encoders: {time.perf_counter() - t0:.1f} s")
    return dict(launches)


# phase 13: do_final_upscale (the one params file that sets it: AdaBins-B5)
# and drop_path_rate
FINAL_UPSCALE_PARAMS = "nyu_efficientnet-b5_final_upscale_1.yaml"
FU = {"do_final_upscale": True}
FU_SLOTS = 1000  # min(max_det 1000, the 1200 full-resolution tokens at 480x640)
# kernel 1 a final-upscale forward: the concat form at up1..up4, the bare
# form at the fifth stage (its skip, the image, has 3 channels)
FU_CONCAT, FU_BARE = 4, 1
DROP_PATH_RATE = 0.2


def log_served(what: str, pipe, frames: list) -> None:
    """The served rate, p50 and peak memory of ``pipe`` over ``frames``, and
    one trace's device time and idle share."""
    r = served_rate(pipe, frames, n_req=6, n_lat=5)
    t = trace(lambda: pipe(frames[0]), n_req=3)
    log(f"  {what}: served {r['img_per_s']:.2f} img/s over 6 requests of {BATCH}; p50 "
        f"{r['p50_ms']:.2f} ms of 5 requests; peak memory {r['peak_gib']:.3f} GiB; traced (3 "
        f"requests): {t['window_ms_per_request']:.3f} ms a request, device busy "
        f"{t['device_busy_ms_per_request']:.3f} ms, {t['device_kernels_per_request']:.0f} kernels, "
        f"idle share {t['idle_share']:.3f}; device ms by kind: "
        + ", ".join(f"{k} {v:.3f}" for k, v in t["device_ms_per_request_by_kind"].items()))


def serve_final_upscale(what: str, pipe, frames: list, served=None) -> dict:
    """Requests of ``frames`` (after a warm-up on the first) through a
    do_final_upscale server ``pipe`` (``served`` with objects, if given,
    for the even requests): each forward's launches (kernel 1's concat form
    4 and bare form 1, kernel 2 once, kernel 5's forward as the model's
    route gives it), full-resolution depth, each kernel's output against its
    plain version on its own tensors; then the served rate and a trace."""
    model = pipe.model
    heads = model.transformer_head
    attn = 0 if model.attn_impl != "kernel" else (10 if model.takes_objects else 4)
    servers = [served if served is not None and i % 2 == 0 else pipe for i in range(len(frames))]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    with record_kernel_io(model) as records, record_attention_io() as attn_records:
        depths = [server(f) for server, f in zip(servers[1:], frames[1:])]
    torch.cuda.synchronize()
    n = len(depths)
    launches = expect_launches(f"{what}, {n} requests of {BATCH} frames",
                               resize=(FU_CONCAT + FU_BARE) * n, resize_concat=FU_CONCAT * n,
                               bins=n, attention_fwd=attn * n)
    for i, depth in enumerate(depths):
        check_depth(f"{what} request {i}", depth, model.min_depth, model.max_depth,
                    len(frames[0]), full_res=True)
    if len(records[0]["resize"]) != FU_CONCAT + FU_BARE:
        raise AssertionError(f"{what}: recorded {len(records[0]['resize'])} upsamples")
    check_served_kernels(model, records)
    if attn:
        check_attention_records(f"{what} requests", attn_records, residual=False)
    log(f"  {what}: {type(heads).__name__} over {FU_TOKENS} tokens, {pipe.n_obj_max} slots")
    del records, attn_records, depths
    log_served(what, pipe, frames[1:])
    return launches


def train_final_upscale(what: str, step, batch, objects) -> dict:
    """One train step of a do_final_upscale model on kernel 5's route at bs
    8, 416x544: kernel 4 once forward and once backward, kernel 5's forward
    and backward as the model gives them, every backward on the long
    route (S 884); each launch against its plain version, a finite loss."""
    model = step.model
    fwd = 10 if model.takes_objects else 4
    bwd = ATTN_BWD_PER_STEP if model.takes_objects else 4
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with record_bins_expectation_io() as records, record_attention_io() as attn_records:
        loss = float(step(batch, objects))
    torch.cuda.synchronize()
    launches = expect_launches(f"{what} train step", bins_expectation_fwd=1,
                               bins_expectation_bwd=1, attention_fwd=fwd, attention_bwd=bwd,
                               attention_bwd_cluster=0)
    log(f"  {what} train step (the first), bs {BATCH} at {TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}, "
        f"{FU_TRAIN_TOKENS} tokens: loss {loss:.6f}, {1000 * (time.perf_counter() - t0):.1f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not np.isfinite(loss):
        raise AssertionError(f"{what}: the train loss is not finite")
    check_train_kernels(records[0])
    check_attention_records(f"{what} step", attn_records, residual=True)
    return launches


def swap_drop_path_rates(model, rates) -> list[float]:
    """Give the encoder's blocks the drop_path_rates ``rates`` (an iterable,
    one a block, in order); returns the rates they had."""
    enc = model.dense_feature_extractor.encoder["original_model"]
    blocks = [blk for stage in enc.stages() for blk in stage]
    old = [blk.drop_path_rate for blk in blocks]
    for blk, rate in zip(blocks, rates):
        blk.drop_path_rate = rate
    return old


def phase_drop_path() -> dict:
    """(e) GraphBins-B5 with drop_path_rate 0.2: in training, forward losses
    on one batch (dropout 0, no augmentation, so stochastic depth draws
    alone) equal for one generator seed and differ for another, and equal
    for both seeds at rate 0; one full train step; at inference the server
    on ``encoder_impl="kernel"`` launches kernels 8 and 7 32 + 7 times a
    forward and gives the depth of the same weights at rate 0 bit for bit.
    cuDNN runs deterministic algorithms throughout, so equal draws give
    equal sums."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return drop_path_checks()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def drop_path_checks() -> dict:
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                n_obj=TRAIN_SLOTS, seed=0, dropout_rate=0.0,
                                                drop_path_rate=DROP_PATH_RATE)
    model = step.model
    loss_fn = make_train_loss_fn(model, LossWrapper(*TRAIN_LOSSES), model.min_depth,
                                 augment_on_device=False, compute_dtype=torch.bfloat16)

    def loss(seed):
        with torch.no_grad():
            return float(loss_fn(batch, objects, torch.Generator(device="cuda").manual_seed(seed)))

    drawn = [loss(7), loss(7), loss(8)]
    saved = swap_drop_path_rates(model, itertools.repeat(0.0))
    at_zero = [loss(7), loss(8)]
    swap_drop_path_rates(model, saved)
    log(f"drop path: GraphBins-B5, drop_path_rate {DROP_PATH_RATE} (block rates "
        f"{min(r for r in saved if r > 0):.5f}..{max(saved):.5f}), train-mode losses, seeds 7, "
        f"7, 8: {drawn}; at rate 0, seeds 7, 8: {at_zero}")
    if drawn[0] != drawn[1] or drawn[0] == drawn[2] or at_zero[0] != at_zero[1]:
        raise AssertionError("drop path: the losses do not follow the generator's seed")
    zero_counters()
    full = float(step(batch, objects))
    torch.cuda.synchronize()
    launches = collections.Counter(expect_launches("drop path train step",
                                                   bins_expectation_fwd=1, bins_expectation_bwd=1))
    log(f"  one train step with drop path, augmentation and the generator: loss {full:.6f}")
    if not np.isfinite(full):
        raise AssertionError("drop path: the train loss is not finite")
    del step, batch, objects, model

    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   encoder_impl="kernel", drop_path_rate=DROP_PATH_RATE)
    frames = np.random.default_rng(97).integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8)
    pipe(frames)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    depth = pipe(frames)
    torch.cuda.synchronize()
    launches.update(expect_launches("drop path server, encoder_impl kernel", resize=4, bins=1,
                                    mbconv_head=MBCONV_PER_FORWARD,
                                    se_project=SE_PROJECT_PER_FORWARD))
    saved = swap_drop_path_rates(pipe.model, itertools.repeat(0.0))
    at_zero = pipe(frames)
    swap_drop_path_rates(pipe.model, saved)
    if not torch.equal(depth, at_zero):
        raise AssertionError("drop path: the eval forward differs from the same weights at rate 0")
    log("  eval forward on the encoder's kernel route: 32 + 7 kernel-8 and kernel-7 launches, "
        "the depth of the same weights at rate 0 bit for bit")
    return dict(launches)


def phase_final_upscale() -> dict:
    """Phase 13: (a) AdaBins-B5 with do_final_upscale served on both
    attention routes, (b) its train step, (c) -v --debug --bf16 on its
    params file, (d) GraphBins-B5 with do_final_upscale served at 1000
    slots and one train step, (e) drop_path_rate (``phase_drop_path``).
    Returns the kernel launches of (a)-(d) ('final': kernels 1, 2, 4 and 5
    at the full-resolution shapes; kernel 1's concat form at the four
    flagship upsamples) and of (e) ('drop_path', at the flagship's
    shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rng = np.random.default_rng(4321)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(3)]
    final = collections.Counter()
    for impl in ("kernel", "plain"):
        pipe = build_adabins_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                      attn_impl=impl, **FU)
        rows = pipe.model.adaptive_bins_layer.patch_transformer.positional_encodings.shape[0]
        if rows != FU_TOKENS or pipe.n_obj_max != FU_SLOTS:
            raise AssertionError(f"AdaBins-B5 final upscale: {rows} table rows, "
                                 f"{pipe.n_obj_max} slots")
        final.update(serve_final_upscale(f"(a) AdaBins-B5 final upscale, {impl} attention", pipe,
                                         frames))
        del pipe
    torch.cuda.empty_cache()
    step, batch = build_adabins_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1], seed=0,
                                      attn_impl="kernel", **FU)
    final.update(train_final_upscale("(b) AdaBins-B5 final upscale", step, batch, None))
    del step, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg in write_option_files(tmp, (FINAL_UPSCALE_PARAMS,)).items():
            metrics, seen = run_cli(f"(c) -v --debug --bf16, {name}",
                                    ["-c", cfg, "-v", "--debug", "--bf16"],
                                    resize=EVAL_RESIZE + FU_BARE, resize_concat=EVAL_RESIZE,
                                    bins=EVAL_BINS)
            written = read_validation_output(os.path.join(tmp, name[:-5], "validation_output.txt"))
            if any(abs(written[k] - metrics[k]) > 1e-6 * abs(metrics[k]) for k in metrics):
                raise AssertionError(f"{name}: validation_output.txt disagrees with the metrics")
            log(f"  {name}: validation_output.txt written; abs_rel {metrics['abs_rel']:.5f}")
            final.update(seen["launches"])
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   attn_impl="kernel", **FU)
    if pipe.n_obj_max != FU_SLOTS:
        raise AssertionError(f"GraphBins-B5 final upscale: {pipe.n_obj_max} slots")
    with_objects = DepthPipeline(pipe.model, eval_dims=EVAL_DIMS,
                                 provider=make_provider(rng, FU_SLOTS))
    final.update(serve_final_upscale("(d) GraphBins-B5 final upscale, kernel attention", pipe,
                                     frames, with_objects))
    del pipe, with_objects
    torch.cuda.empty_cache()
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                seed=0, attn_impl="kernel", **FU)
    if objects["valid"].shape[1] != FU_TRAIN_TOKENS:
        raise AssertionError(f"GraphBins-B5 final upscale: {objects['valid'].shape[1]} train slots")
    final.update(train_final_upscale("(d) GraphBins-B5 final upscale", step, batch, objects))
    del step, batch, objects
    torch.cuda.empty_cache()
    drop = phase_drop_path()
    torch.cuda.empty_cache()
    log(f"final upscale and drop path: {time.perf_counter() - t0:.1f} s")
    return {"final": dict(final), "drop_path": drop}


# phase 14: the host core (csrc/preprocess.cpp, built by g++ at first use,
# through data/native.py) and profiling; the fit is phase 10 (a)'s on the
# flagship's old_dl twin, whose train batches DepthDataset.get_batch reads
OLD_DL_PARAMS = os.path.join(
    REPO, "params", "nyu_graphbins_enet-b5_ocv_pos_learned_bbox_wh_emb_128_lang_name_synset_def_"
    "wn_rel_sz_clip_old_dl_1.yaml")
HOST_REPEATS = 5  # a host time is the median of this many calls or batches
NYU_STAGE_A = (427, 565)  # NYU's boundary crop of a 480x640 frame
# a KITTI frame, and its dimensions_train; the kb crop is KITTI_DIMS
KITTI_FRAME, KITTI_TRAIN_DIMS = (375, 1242), (352, 704)
# tests/test_native.py's bounds of the core against its numpy versions: the
# bilinear rotate 1e-4 and the augment 1e-5 on [0, 1] values (5e-5 once
# ImageNet-normalised, ~4.4x); the nearest rotate may move 1e-3 of the
# pixels (a sample point within rounding of a pixel boundary)
CORE_ROTATE_ATOL, CORE_AUGMENT_ATOL, CORE_NORMALISED_ATOL = 1e-4, 1e-5, 5e-5
CORE_NEAREST_MISMATCH = 1e-3
PROFILED_STEPS = 3


def host_ms(fn, repeats: int = HOST_REPEATS) -> float:
    """Median wall ms of ``repeats`` calls of ``fn()`` after one more."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1000 * (time.perf_counter() - t0))
    return statistics.median(times)


def check_core(name: str, core, plain, check) -> dict:
    """One entry point of the core against its plain version on the same
    inputs (``check(core_out, plain_out)`` raises or returns its error),
    both timed on the host."""
    err = check(core(), plain())
    row = {"name": name, "core_ms": host_ms(core), "plain_ms": host_ms(plain), "err": err}
    log(f"  (a) {name}: core {row['core_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms "
        f"({row['plain_ms'] / row['core_ms']:.2f}x); {err}")
    return row


def within(atol: float):
    def check(got, want):
        got, want = (np.asarray(a) for a in (got, want))
        err = float(np.abs(got - want).max())
        if got.shape != want.shape or not err <= atol:
            raise AssertionError(f"shapes {got.shape}, {want.shape}; max abs err {err} > {atol}")
        return f"max abs err {err:.3g} (bound {atol})"
    return check


def nearest_check(got, want):
    moved = float(np.mean(got != want))
    if got.shape != want.shape or not moved <= CORE_NEAREST_MISMATCH:
        raise AssertionError(f"shapes {got.shape}, {want.shape}; {moved} of the pixels moved")
    return f"{moved:.2e} of the pixels moved (bound {CORE_NEAREST_MISMATCH})"


def batches_check(atol: float):
    """A batch pass's (images, depths) against another's: images within
    ``atol`` (0: bit for bit), depths bit for bit."""
    def check(got, want):
        err = within(atol)(got[0], want[0])
        if not np.array_equal(got[1], want[1]):
            raise AssertionError("the depths differ")
        return err + "; depths bit for bit"
    return check


def check_core_entry_points() -> list[dict]:
    """(a) Each entry point of the core against its plain numpy version at
    the pipelines' full sizes: the rotations at NYU's and KITTI's stage-A
    shapes, the augment at NYU's crop, ``hflip``, and ``assemble_batch`` of
    8 at NYU's and KITTI's crops, which must also equal the core's
    per-sample path bit for bit."""
    rng = np.random.default_rng(14)
    rows = []
    for label, (h, w) in (("NYU", NYU_STAGE_A), ("KITTI", KITTI_DIMS)):
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        dep = rng.uniform(0.5, 9.5, (h, w, 1)).astype(np.float32)
        rows.append(check_core(f"rotate_bilinear {label} {h}x{w}x3, 1.7 deg",
                               lambda: native.rotate_bilinear(img, 1.7),
                               lambda: pp.rotate_bilinear(img, 1.7), within(CORE_ROTATE_ATOL)))
        rows.append(check_core(f"rotate_nearest {label} {h}x{w}x1, 1.7 deg",
                               lambda: native.rotate_nearest(dep, 1.7),
                               lambda: pp.rotate_nearest(dep, 1.7), nearest_check))
    crop = rng.uniform(0, 1, (*TRAIN_DIMS, 3)).astype(np.float32)
    c3 = np.array([0.93, 1.02, 1.07], np.float32)
    for normalise, atol in ((False, CORE_AUGMENT_ATOL), (True, CORE_NORMALISED_ATOL)):
        args = (crop, True, True, 1.05, 1.1, c3, normalise)
        rows.append(check_core(f"augment_normalize {TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}x3, "
                               f"{'normalised' if normalise else '[0, 1]'}",
                               lambda: native.augment_normalize(*args),
                               lambda: pp.augment_normalize(*args), within(atol)))
    depth = rng.uniform(0.5, 9.5, (*TRAIN_DIMS, 1)).astype(np.float32)
    rows.append(check_core(f"hflip {TRAIN_DIMS[0]}x{TRAIN_DIMS[1]}x1", lambda: native.hflip(depth),
                           lambda: depth[:, ::-1].copy(), within(0.0)))
    for label, (h, w), (oh, ow) in (("NYU", NYU_STAGE_A, TRAIN_DIMS),
                                    ("KITTI", KITTI_DIMS, KITTI_TRAIN_DIMS)):
        images = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(BATCH)]
        depths = [rng.uniform(0.5, 9.5, (h, w, 1)).astype(np.float32) for _ in range(BATCH)]
        crops = np.stack([rng.integers(0, (h - oh + 1, w - ow + 1)) for _ in range(BATCH)])
        draws = (rng.random(BATCH) > 0.5, rng.random(BATCH) > 0.5,
                 rng.uniform(0.9, 1.1, BATCH), rng.uniform(0.75, 1.25, BATCH),
                 rng.uniform(0.9, 1.1, (BATCH, 3)))
        core = native.assemble_batch(images, depths, crops, *draws, oh, ow)
        per_sample = (np.stack([native.augment_normalize(
            images[i][y:y + oh, x:x + ow], draws[0][i], draws[1][i], draws[2][i], draws[3][i],
            draws[4][i]) for i, (y, x) in enumerate(crops)]),
            np.stack([native.hflip(depths[i][y:y + oh, x:x + ow]) if draws[0][i]
                      else depths[i][y:y + oh, x:x + ow] for i, (y, x) in enumerate(crops)]))
        log(f"  (a) assemble_batch {label}: the core's per-sample path, "
            f"{batches_check(0.0)(core, per_sample)}")
        rows.append(check_core(
            f"assemble_batch {label} {BATCH}x{oh}x{ow} from {h}x{w}",
            lambda: native.assemble_batch(images, depths, crops, *draws, oh, ow),
            lambda: pp.assemble_batch(images, depths, crops, *draws, oh, ow),
            batches_check(CORE_NORMALISED_ATOL)))
    return rows


@contextlib.contextmanager
def plain_rotates():
    """The new sampler on the plain numpy rotations while open: the port's
    host path before its core."""
    real = native.rotate_bilinear, native.rotate_nearest
    native.rotate_bilinear, native.rotate_nearest = pp.rotate_bilinear, pp.rotate_nearest
    try:
        yield
    finally:
        native.rotate_bilinear, native.rotate_nearest = real


def write_host_frames(tmp: str) -> dict[str, dict]:
    """BATCH NYU (480x640) and KITTI (375x1242) train frames written as
    write_fit_files writes them, and each dataset's config (basicParams.yaml's
    section over them) for each sampler: {'nyu old_dl': cfg, ...}."""
    rng = np.random.default_rng(1400)
    with open(BASIC_PARAMS) as f:
        basic = yaml.safe_load(f)
    data = os.path.join(tmp, "data")
    cfgs = {}
    for name, dims, scale, focal in (("nyu", EVAL_DIMS, 1000.0, 518.8579),
                                     ("kitti", KITTI_FRAME, 256.0, 721.5377)):
        section = basic[name]
        lines = []
        for i in range(BATCH):
            img, dep = f"scene/{i:05d}_rgb.png", f"scene/{i:05d}_depth.png"
            image_root = section.get("data_path", section.get("train_path"))
            depth_root = section.get("gt_path", section.get("train_path"))
            write_frame(os.path.join(data, section["base_path"], image_root, img),
                        os.path.join(data, section["base_path"], depth_root, dep), dims, rng,
                        scale)
            lines.append(f"{img} {dep} {focal}")
        split = os.path.join(tmp, f"{name}_train.txt")
        with open(split, "w") as f:
            f.write("\n".join(lines) + "\n")
        for old_dl in (True, False):
            cfgs[f"{name} {'old_dl' if old_dl else 'new'}"] = {
                "basic": {"dataset": name, "use_adabins_dataloader": old_dl},
                "paths": {"data_dir": data},
                name: {**section, "filenames_file_train": split}}
    return cfgs


def time_host_batches() -> dict[str, float]:
    """(b) Host ms a batch of BATCH (median of HOST_REPEATS; the frames'
    reads warm) on NYU and KITTI frames: old_dl per-sample ``get``,
    ``get_batch`` on one decode thread and on one a core (both first held
    bit for bit against the per-sample batch), the new sampler per sample
    on the core and on the plain numpy rotations (the port before its
    core)."""
    from objcavit_torch.config import Config
    from objcavit_torch.data.dataset import DepthDataset

    idxs = np.arange(BATCH)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, cfg in write_host_frames(tmp).items():
            ds = DepthDataset(Config(cfg), "train")

            def per_sample(seed: int = 0):
                rng = np.random.default_rng(seed)
                samples = [ds.get(int(i), rng) for i in idxs]
                return tuple(np.stack([s[k] for s in samples]) for k in ("image", "depth"))

            def whole(seed: int = 0):
                batch, _ = ds.get_batch(idxs, np.random.default_rng(seed))
                return batch["image"], batch["depth"]

            if label.endswith("new"):
                times[f"{label}, per-sample get, core rotations"] = host_ms(per_sample)
                with plain_rotates():
                    times[f"{label}, per-sample get, numpy rotations"] = host_ms(per_sample)
                continue
            times[f"{label}, per-sample get"] = host_ms(per_sample)
            want = per_sample(7)
            for threads in (1, None):
                ds.decode_threads = threads
                what = f"{label}, get_batch, {threads or os.cpu_count()} decode threads"
                log(f"  (b) {what} against per-sample get: {batches_check(0.0)(whole(7), want)}")
                times[what] = host_ms(whole)
    for what, ms in times.items():
        log(f"  (b) {what}: {ms:.3f} ms a batch of {BATCH}")
    return times


def read_trace_file(logdir: str) -> str:
    files = os.listdir(logdir)
    if len(files) != 1:
        raise AssertionError(f"(d): the trace directory holds {files}")
    with open(os.path.join(logdir, files[0])) as f:
        return f.read()


def phase_host_core(flagship_epoch: dict) -> dict:
    """Phase 14: (a) the core's build (g++, timed into a scratch directory)
    and each entry point against its plain version at full sizes; (b) host
    ms a batch on each sampler and batch path; (c) phase 10 (a)'s fit on the
    flagship's old_dl twin, whose every train batch must come from
    ``get_batch``, with its launches, kernel 4's recorded step, the eval
    records, the step times, the idle share and the second epoch's
    breakdown beside ``flagship_epoch`` (phase 10 (a)'s); (d)
    ``profiling.trace`` around 3 of its steps writes a trace holding an
    ``annotate`` range and kernel 4's kernels, and ``device_memory_stats``
    reads the allocator's peak. Returns the fit's launches."""
    from objcavit_torch.data.dataset import DepthDataset

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    info = build.cpu_info()
    cpu = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "model name")
                    if k in info)
    log(f"host core: CPU {cpu or build.host_cpu()}, {os.cpu_count()} cores; the library in "
        f"{build.HOST_LIB_PATH.parent.name}/ was built at first use: "
        f"{build.HOST_LIB_PATH.is_file()}")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        line = build.build_host(os.path.join(tmp, build.HOST_LIB_PATH.name))
        log(f"  (a) build, again into a scratch directory: {time.perf_counter() - t1:.2f} s: "
            f"{line}")
    check_core_entry_points()
    time_host_batches()

    writer = has_tensorboard()
    fig = 1 if writer else 0
    served = collections.Counter()
    real_get_batch, real_get = DepthDataset.get_batch, DepthDataset.get

    def get_batch(self, idxs, rng):
        out = real_get_batch(self, idxs, rng)
        served["get_batch" if out is not None else "get_batch None"] += 1
        return out

    def get(self, idx, rng):
        served[f"get, {self.mode}"] += 1
        return real_get(self, idx, rng)

    DepthDataset.get_batch, DepthDataset.get = get_batch, get
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfgs = write_fit_files(tmp, OLD_DL_PARAMS)
            steps = FIT_EPOCHS * FIT_STEPS
            _metrics, seen = run_fit(
                f"(c) fit --bf16 on the old_dl twin, {FIT_EPOCHS} epochs of {FIT_STEPS} steps",
                ["-c", cfgs["fit"], "--bf16"], cfgs["basic"], bins_expectation_fwd=steps,
                bins_expectation_bwd=steps, **fit_eval_launches(FIT_EPOCHS, FIT_EPOCHS, fig))
    finally:
        DepthDataset.get_batch, DepthDataset.get = real_get_batch, real_get
    # the fit draws one train batch to initialise (JAX's order), then its
    # steps'; the eval split's get_batch gives None, and its frames are read
    # one by one
    want = {"get_batch": steps + 1, "get_batch None": FIT_EPOCHS * FIT_EVAL_STEPS,
            "get, online_eval": FIT_EPOCHS * FIT_EVAL}
    log(f"  (c) train batches from get_batch: {served['get_batch']}; reads {dict(served)}")
    if dict(served) != want:
        raise AssertionError(f"(c): want the dataset's reads {want}, got {dict(served)}")
    if len(seen["records"]) != 1 or "dcenters" not in seen["records"][0]:
        raise AssertionError("(c): no recorded kernel-4 step with its backward")
    check_train_kernels(seen["records"][0])
    check_served_kernels(seen["eval"]["model"], seen["eval"]["records"])
    wall = [t[0] for t in seen["times"][1:]]
    epoch = epoch_breakdown(seen["spans"])
    seen["step"].scheduler = None  # steps past the schedule's end
    traced = trace(lambda: seen["step"](*seen["args"]), n_req=FIT_TRACED_STEPS)
    log(f"  (c) per step over {len(wall)} steps after the first: wall p50 "
        f"{statistics.median(wall):.3f} ms (min {min(wall):.3f}, max {max(wall):.3f}); traced "
        f"({FIT_TRACED_STEPS} steps): device busy {traced['device_busy_ms_per_request']:.3f} ms, "
        f"idle share {traced['idle_share']:.3f}; whole run {seen['seconds']:.2f} s")
    for what, parts in (("old_dl twin (get_batch, the core's assembly)", epoch),
                        ("flagship, phase 10 (a) (new sampler, the core's rotations)",
                         flagship_epoch)):
        log(f"  (c) the second epoch, {what}, s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as logdir:
        zero_counters()
        with profiling.trace(logdir):
            for i in range(PROFILED_STEPS):
                with profiling.annotate(f"old_dl fit step {i}"):
                    seen["step"](*seen["args"])
            torch.cuda.synchronize()
        profiled = read_counters()
        text = read_trace_file(logdir)
    names = ["old_dl fit step 0", "bins_expectation_fwd_kernel", "bins_expectation_bwd_kernel"]
    missing = [n for n in names if n not in text]
    log(f"  (d) profiling.trace of {PROFILED_STEPS} steps: {len(text) / 2**20:.1f} MiB, holds "
        f"{[n for n in names if n in text]}; kernel-4 launches "
        f"{profiled['bins_expectation_fwd']} + {profiled['bins_expectation_bwd']}")
    if missing or not (profiled["bins_expectation_fwd"] == profiled["bins_expectation_bwd"]
                       == PROFILED_STEPS):
        raise AssertionError(f"(d): the trace lacks {missing}, or kernel 4 did not run")
    stats = profiling.device_memory_stats()["cuda:0"]
    peak = torch.cuda.max_memory_allocated(0)
    log(f"  (d) device_memory_stats: {stats}; max_memory_allocated {peak}")
    in_use = torch.cuda.memory_allocated(0)
    if (stats["peak_bytes_in_use"] != peak or stats["bytes_in_use"] != in_use
            or not in_use <= peak <= stats["bytes_limit"]):
        raise AssertionError("(d): device_memory_stats disagrees with torch.cuda's counters")
    launches = seen["launches"]
    del seen
    torch.cuda.empty_cache()
    log(f"host core: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 15: multi-process training (objcavit_torch/parallel). The machine has
# one card and NCCL refuses two ranks on one card: (a) is a world of one
# over NCCL through the entry point, (b) two processes on the card over gloo
DIST_TRAIN = 16  # (b)'s train frames: one epoch of 2 steps at global bs 8
DIST_RANKS = 2
DIST_TIMEOUT = 600  # seconds (b)'s two processes may take before they are killed
# (b)'s first step against one process's on the same global batch. On the
# plain route each is the same arithmetic but for where the sums over the
# batch are cut (the BN statistics, the losses, the gradient's mean over the
# ranks, cuDNN's algorithms at 4 images against 8):
# * in fp64 that leaves rounding of ~1e-8 (the bins head's plain softmax
#   stays fp32; the plain resize lerps in fp64 on fp64 tensors, where its
#   fp32 lerp had turned rounding into fp32 ulps that the BNs magnified to
#   ~1e-4): the loss and each named group's gradient within rel L2
#   DIST_FP64_REL;
# * in fp32 (TF32 off) the train-mode BNs' backward magnifies it: the first
#   H100 reading put decoder.conv2 and the encoder stem 2.7e-3 and 3.5e-3
#   apart, image attention 0 1.3e-4, conv_out and the regressor 2.7e-6 and
#   2.2e-6, 1.1-1.2 times one process's own fp32 distance from its fp64
#   step. Each group within DIST_FP32_FLOOR_X times that distance, plus
#   DIST_FP64_REL; the loss within DIST_FP64_REL;
# * in bf16 on kernel 5's route (the fit's own first step): the loss within
#   DIST_BF16_LOSS_REL, the gradients at the bf16 train check's bounds
#   (TRAIN_GRAD_GROUPS)
DIST_PLAIN_STEPS = {"fp64 plain": torch.float64, "fp32 plain": torch.float32}
DIST_FP64_REL = 1e-5
DIST_FP32_FLOOR_X = 2.0
DIST_BF16_LOSS_REL = 1e-3
# a rank's launches in (b): 2 train steps (kernel 4 1 + 1, kernel 5 10 + 9
# each), one validation of 2 eval steps on its 4 of each 8 images (kernel 5
# 10, kernel 1's concat form 4, kernel 2 1 each); no figure in a group
DIST_RANK_LAUNCHES = {"bins_expectation_fwd": 2, "bins_expectation_bwd": 2,
                      "attention_fwd": 4 * 10, "attention_bwd": 2 * ATTN_BWD_PER_STEP,
                      "resize": 2 * EVAL_RESIZE, "bins": 2 * EVAL_BINS}
DIST_STEP_LAUNCHES = {"bins_expectation_fwd": 1, "bins_expectation_bwd": 1,
                      "attention_fwd": 10, "attention_bwd": ATTN_BWD_PER_STEP}


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms and cuDNN's while open, so that two
    fits of one config give the same bits (cuDNN's backward and the index
    ops' atomics otherwise sum in any order). cuBLAS asks for its workspace
    setting in the env."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def distributed_env(world: int, rank: int):
    """The OBJCAVIT_* env of one process of ``world`` while open."""
    env = {"OBJCAVIT_COORDINATOR": f"127.0.0.1:{free_port()}",
           "OBJCAVIT_NUM_PROCESSES": str(world), "OBJCAVIT_PROCESS_ID": str(rank)}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)


def write_dist_configs(tmp: str, cfgs: dict) -> dict[str, str]:
    """Copies of phase 10's 'fit' config for 1 epoch: 'single' and 'group'
    (its 32 train frames, 4 steps), 'ranks' (the first DIST_TRAIN frames, 2
    steps)."""
    with open(cfgs["fit"]) as f:
        cfg = yaml.safe_load(f)
    split = os.path.join(tmp, "nyu_train_dist.txt")
    with open(cfg["nyu"]["filenames_file_train"]) as f, open(split, "w") as g:
        g.writelines(f.readlines()[:DIST_TRAIN])
    paths = {}
    for name in ("single", "group", "ranks"):
        cfg["basic"].update(name=f"dist_{name}", max_epochs=1)
        if name == "ranks":
            cfg["nyu"] = {**cfg["nyu"], "filenames_file_train": split}
        paths[name] = os.path.join(tmp, f"dist_{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def state_digest(model) -> str:
    """sha256 of every entry of the model's state dict, in order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def group_grads(model, grid=None) -> dict[str, torch.Tensor]:
    """Each TRAIN_GRAD_GROUPS group's gradients, concatenated, in fp32 or
    wider, on the host; of the whole model, joined over ``grid``'s model
    axis, where a grid splits it (``tp_gather_state_dict``)."""
    if grid is None:
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    else:
        grads = {n: g for n, g in tp_gather_state_dict(model, grid, grads=True).items()
                 if g is not None}
    out = {}
    for group, (prefixes, _) in TRAIN_GRAD_GROUPS.items():
        keys = [n for n in grads if n.startswith(prefixes)]
        if not keys:
            raise AssertionError(f"no gradient in group {group}")
        out[group] = torch.cat([grads[n].to(torch.promote_types(grads[n].dtype, torch.float32))
                                .ravel() for n in keys]).cpu()
    return out


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def to_card(tree, dev):
    if isinstance(tree, dict):
        return {k: to_card(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def dist_args(cfg: str, basic: str):
    """The config tree cli.main builds for a fit of ``cfg``."""
    args = cli.load_args(cfg, debug=False, log_debug=False, validate=False, inference=False)
    args.devices = None
    return cli.check_and_validate_args(args, basic_params_path=basic)


def first_step(args, attn_impl: str, dtype: torch.dtype, batch: dict, objects: dict,
               dev) -> dict:
    """The fit's first step on ``batch``: the warm-started model, in fp64
    (parameters too) where ``dtype`` is, the fit's generator seed,
    augmentation and dropout on; its loss and backward, the gradients
    through the group's reducer where there is a group. -> {'loss', 'grads'
    (group_grads)}."""
    model = build_model(args, attn_impl=attn_impl)
    eval_loop.restore_checkpoint(args.basic.from_checkpoint, model)
    if dtype == torch.float64:
        model.double()
        batch, objects = (
            {k: v.double() if v.is_floating_point() else v for k, v in tree.items()}
            for tree in (batch, objects))
    model.to(dev, memory_format=torch.channels_last)
    loss_fn = make_train_loss_fn(model, LossWrapper.from_args(args),
                                 args[args.basic.dataset].min_depth,
                                 augment_on_device=not args.basic.get("use_adabins_dataloader"),
                                 compute_dtype=dtype)
    loss = loss_fn(to_card(batch, dev), to_card(objects, dev),
                   torch.Generator(dev).manual_seed(eval_loop.TRAIN_SEED))
    loss.backward()
    if torch.distributed.is_initialized():
        GradientReducer(model.parameters())()
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()), "grads": group_grads(model)}
    del model, loss
    torch.cuda.empty_cache()
    return out


def dist_rank(spec_path: str) -> None:
    """One process of (b), started by ``parallel.launch`` with its rank's
    env: Trainer(attn_impl="kernel", bf16).fit() on the 'ranks' config over
    gloo, each step's launches counted, step 1's kernel-4 and kernel-5
    launches recorded and held against their plain versions, the first
    step's batch and reduced gradients kept, then an fp32 plain-route step
    on that batch; the files the rank wrote. Saves rank_<p>.pt."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo")
    rank = process_index()
    written, seen = [], {"launches": [], "losses": [], "times": [], "records": {}}
    real_save, real_config = ckpt_module._save_atomic, ckpt_module.save_config

    def save(obj, path):
        written.append(os.path.basename(path))
        real_save(obj, path)

    def save_config(cfg, path):
        written.append(os.path.basename(path))
        real_config(cfg, path)

    real_make = eval_loop.make_train_step
    real_all_reduce = torch.distributed.all_reduce
    small = {"on": True, "n": 0, "ms": 0.0}  # the step's all-reduces but the reducer's

    def all_reduce(*args, **kwargs):
        if not small["on"]:
            return real_all_reduce(*args, **kwargs)
        torch.cuda.synchronize()  # gloo waits for the tensor's producers anyway
        t0 = time.perf_counter()
        work = real_all_reduce(*args, **kwargs)
        torch.cuda.synchronize()
        small["n"] += 1
        small["ms"] += 1000 * (time.perf_counter() - t0)
        return work

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)
        reducer = step.grad_reducer
        seen["backend"] = reducer.backend

        def reduce_and_keep():
            torch.cuda.synchronize()
            small["on"] = False
            t0 = time.perf_counter()
            reducer()
            torch.cuda.synchronize()
            small["on"] = True
            seen.setdefault("reduce_ms", []).append(1000 * (time.perf_counter() - t0))
            seen.setdefault("grads", group_grads(step.model))  # the first step's, unclipped

        step.grad_reducer = reduce_and_keep

        def timed(batch, objects):
            seen.setdefault("batch", (to_host({k: v for k, v in batch.items() if k != "objects"}),
                                      to_host(objects)))
            before = read_counters()
            torch.cuda.synchronize()
            small.update(n=0, ms=0.0)
            t0 = time.perf_counter()
            if len(seen["losses"]) == 1:
                with record_bins_expectation_io() as exp, record_attention_io() as attn:
                    loss = step(batch, objects)
                seen["records"] = {"exp": exp, "attn": attn}
            else:
                loss = step(batch, objects)
            torch.cuda.synchronize()
            seen["times"].append(1000 * (time.perf_counter() - t0))
            seen.setdefault("small", []).append((small["n"], small["ms"]))
            after = read_counters()
            seen["launches"].append({k: after[k] - before[k] for k in DIST_STEP_LAUNCHES})
            seen["losses"].append(float(loss))
            timed.last_lr = step.last_lr
            return loss

        timed.last_lr = None
        return timed

    ckpt_module._save_atomic, ckpt_module.save_config = save, save_config
    eval_loop.make_train_step = make
    torch.distributed.all_reduce = all_reduce
    try:
        args = dist_args(spec["cfg"], spec["basic"])
        zero_counters()
        model, metrics = eval_loop.Trainer(args, dtype=torch.bfloat16, attn_impl="kernel").fit()
        torch.cuda.synchronize()
        launches = expect_launches(f"(b) rank {rank} fit", **DIST_RANK_LAUNCHES)
        digest = state_digest(model)
        del model
        for i, got in enumerate(seen["launches"]):
            if got != DIST_STEP_LAUNCHES:
                raise AssertionError(f"(b) rank {rank} step {i}: launches {got}")
        exp, attn = seen["records"]["exp"], seen["records"]["attn"]
        if len(exp) != 1 or "dcenters" not in exp[0] or not attn:
            raise AssertionError(f"(b) rank {rank}: no recorded kernel-4 and kernel-5 step")
        check_train_kernels(exp[0])
        check_attention_records(f"(b) rank {rank} recorded step", attn, residual=True)
        del seen["records"]
        batch, objects = seen["batch"]
        out = {"rank": rank, "launches": launches, "step_launches": seen["launches"],
               "losses": seen["losses"], "times": seen["times"], "reduce_ms": seen["reduce_ms"],
               "small": seen["small"], "metrics": metrics,
               "digest": digest, "written": written, "backend": seen["backend"],
               "batch": batch, "objects": objects,
               "bf16 kernel": {"loss": seen["losses"][0], "grads": seen["grads"]}}
        for label, dtype in DIST_PLAIN_STEPS.items():
            out[label] = first_step(args, "plain", dtype, batch, objects, rank_device())
        torch.save(out, os.path.join(spec["work"], f"rank_{rank}.pt"))
    finally:
        torch.distributed.all_reduce = real_all_reduce
        eval_loop.make_train_step = real_make
        ckpt_module._save_atomic, ckpt_module.save_config = real_save, real_config
        shutdown_distributed()


def interleave(parts: list, world: int):
    """The global batch from each rank's rows: rows [p::P] are rank p's."""
    if isinstance(parts[0], dict):
        return {k: interleave([p[k] for p in parts], world) for k in parts[0]}
    out = torch.empty((parts[0].shape[0] * world,) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype)
    for p, rows in enumerate(parts):
        out[p::world] = rows
    return out


def phase_distributed() -> dict:
    """Multi-process training through the train entry point. (a) cli.main
    --bf16 under the OBJCAVIT_* env of a world of one (NCCL) and without it,
    each 1 epoch of 4 steps on phase 10's data and warm start, both with
    deterministic algorithms: the group's backend NCCL and the step's
    gradient reducer on it, kernel 4's launches and kernels 1 and 2 in the
    validation; the parameters, BN statistics and metrics of the two fits
    bit for bit; wall ms a step of each. (b) two processes on the card over
    gloo (``parallel.launch``, ``dist_rank``): Trainer(attn_impl="kernel",
    bf16).fit() at global bs 8 (4 a rank), 416x544, 221 clip slots, 1 epoch
    of 2 steps and one validation: each step's 10 + 9 kernel-5 and 1 + 1
    kernel-4 launches, one recorded launch of each against its plain
    version, the same losses, parameters and metrics on both ranks bit for
    bit, one version dir whose files rank 0 alone wrote; then the first
    step on one process over the same global batch against the ranks'
    reduced one, by named group: on the plain route in fp64 and in fp32, on
    kernel 5's route in bf16, at the bounds stated at DIST_FP64_REL."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fig = 1 if has_tensorboard() else 0
    a_launches = {"bins_expectation_fwd": FIT_STEPS, "bins_expectation_bwd": FIT_STEPS,
                  **fit_eval_launches(1, 1, fig)}
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = write_fit_files(tmp)
        dist = write_dist_configs(tmp, cfgs)
        fits = {}
        with deterministic_algorithms():
            for name in ("single", "group"):
                env = distributed_env(1, 0) if name == "group" else contextlib.nullcontext()
                with env:
                    metrics, seen = run_fit(f"(a) fit --bf16 ({name}), 1 epoch of {FIT_STEPS} "
                                            f"steps", ["-c", dist[name], "--bf16"],
                                            cfgs["basic"], **a_launches)
                launches.update(seen["launches"])
                reducer = seen["step"].grad_reducer
                fits[name] = {"metrics": metrics, "wall": [t[0] for t in seen["times"][1:]],
                              "backend": None if reducer is None else reducer.backend,
                              "state": {k: v.detach().cpu().clone() for k, v in
                                        seen["step"].model.state_dict().items()}}
                check_train_kernels(seen["records"][0])
                del seen
        single, group = fits["single"], fits["group"]
        same = [k for k, v in single["state"].items() if torch.equal(v, group["state"][k])]
        log(f"  (a) the group's reducer backend {group['backend']!r} (single process: "
            f"{single['backend']!r}); {len(same)} of {len(single['state'])} state entries and "
            f"the metrics {'equal' if single['metrics'] == group['metrics'] else 'differ'} bit "
            f"for bit; wall ms a step after the first, p50 (min, max) of {len(group['wall'])}: "
            f"world of one {statistics.median(group['wall']):.3f} ({min(group['wall']):.3f}, "
            f"{max(group['wall']):.3f}), one process {statistics.median(single['wall']):.3f} "
            f"({min(single['wall']):.3f}, {max(single['wall']):.3f})")
        if (group["backend"] != "nccl" or single["backend"] is not None
                or len(same) != len(single["state"]) or single["metrics"] != group["metrics"]):
            raise AssertionError("(a): the world of one did not give the single-process fit")
        del fits, single, group

        work = os.path.join(tmp, "ranks")
        os.makedirs(work)
        spec = os.path.join(work, "spec.json")
        with open(spec, "w") as f:
            json.dump({"cfg": dist["ranks"], "basic": cfgs["basic"], "work": work}, f)
        out = io.StringIO()
        tb = time.perf_counter()
        rc = launch([sys.executable, os.path.abspath(__file__), "--dist-rank", spec], DIST_RANKS,
                    out=out, timeout=DIST_TIMEOUT)
        b_seconds = time.perf_counter() - tb
        text = out.getvalue()
        log("\n".join(line for line in text.splitlines()
                      if "(b) rank" in line or "recorded step" in line or "Error" in line))
        if rc != 0:
            raise AssertionError(f"(b): the ranks exited {rc}:\n{text[-6000:]}")
        ranks = [torch.load(os.path.join(work, f"rank_{r}.pt"), weights_only=False)
                 for r in range(DIST_RANKS)]
        for r in ranks:
            launches.update(r["launches"])
        r0 = ranks[0]
        run_root = os.path.join(tmp, "runs", "dist_ranks")
        versions = sorted(os.listdir(run_root))
        log(f"  (b) {DIST_RANKS} processes over gloo in {b_seconds:.1f} s: losses "
            f"{[r['losses'] for r in ranks]}, digests {[r['digest'][:16] for r in ranks]}, "
            f"backends {[r['backend'] for r in ranks]}; wall ms a step "
            f"{[[round(t, 3) for t in r['times']] for r in ranks]}, of which the gradient "
            f"reducer {[[round(t, 3) for t in r['reduce_ms']] for r in ranks]}, the other "
            f"all-reduces (BNs, losses, n_b; count, ms, each timed between syncs) "
            f"{[[(n, round(t, 3)) for n, t in r['small']] for r in ranks]}; versions "
            f"{versions}, "
            f"written {[sorted(r['written']) for r in ranks]}")
        if (any(r[k] != r0[k] for r in ranks for k in ("losses", "digest", "metrics"))
                or {r["backend"] for r in ranks} != {"gloo"} or versions != ["version_0"]
                or sorted(r0["written"]) != ["best.ckpt", "hparams.yaml", "last.ckpt"]
                or any(r["written"] for r in ranks[1:])):
            raise AssertionError("(b): the ranks disagree, or a rank other than 0 wrote")

        dev = torch.device("cuda")
        args = dist_args(dist["ranks"], cfgs["basic"])
        batch = interleave([r["batch"] for r in ranks], DIST_RANKS)
        objects = interleave([r["objects"] for r in ranks], DIST_RANKS)
        one = {label: first_step(args, "plain", dtype, batch, objects, dev)
               for label, dtype in DIST_PLAIN_STEPS.items()}
        one["bf16 kernel"] = first_step(args, "kernel", torch.bfloat16, batch, objects, dev)
        floor = {g: rel_l2(v, one["fp64 plain"]["grads"][g])
                 for g, v in one["fp32 plain"]["grads"].items()}
        log("  (b) one process's fp32 first step against its fp64 one, gradient rel L2: "
            + ", ".join(f"{g} {v:.3e}" for g, v in floor.items()))
        bounds = {"fp64 plain": (DIST_FP64_REL, {g: DIST_FP64_REL for g in floor}),
                  "fp32 plain": (DIST_FP64_REL, {g: DIST_FP32_FLOOR_X * v + DIST_FP64_REL
                                                 for g, v in floor.items()}),
                  "bf16 kernel": (DIST_BF16_LOSS_REL, {g: b for g, (_, b) in
                                                       TRAIN_GRAD_GROUPS.items()})}
        bad = []
        for label, (loss_bound, grad_bounds) in bounds.items():
            got, want = r0[label], one[label]
            rels = {g: rel_l2(got["grads"][g], want["grads"][g]) for g in want["grads"]}
            loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            log(f"  (b) first step, {DIST_RANKS} processes vs one on the same global batch, "
                f"{label}: loss {got['loss']!r} vs {want['loss']!r} (rel {loss_rel:.3e}, bound "
                f"{loss_bound}); gradient rel L2 " + ", ".join(
                    f"{g} {v:.3e} (bound {grad_bounds[g]:.3e})" for g, v in rels.items()))
            if loss_rel > loss_bound or any(v > grad_bounds[g] for g, v in rels.items()):
                bad.append(label)
        if bad:
            raise AssertionError(f"(b): the first step of {DIST_RANKS} processes strays from "
                                 f"one process's: {bad}")
    torch.cuda.empty_cache()
    log(f"distributed: {time.perf_counter() - t0:.1f} s")
    return dict(launches)


# the regressor's gradient rel L2 on the seed's weights, kernel 5's route
# against the plain route, as an H100 read them with the forward's planned
# key groups and the cluster backward: a gap to watch, not a bound (the
# check's bound is 0.3). With one key group (the first port's summation
# order) the kernel route read 0.11180; the groups change the fp32 rounding
# of the sums, not the forward's accuracy against fp64 (PERF.md §6)
# phase 16: export (objcavit_torch/serving_export.py). Each case: its
# builder's keyword arguments, its batch, and one request's launches
EXPORT_CASES = {
    "a": ("(a) GraphBins-B5, kernel attention and encoder", "flagship", BATCH,
          {"attn_impl": "kernel", "encoder_impl": "kernel"},
          {"resize": 4, "bins": 1, "attention_fwd": 10, "se_project": 7, "mbconv_head": 32}),
    "b": ("(b) fused GraphBins-B5 + YOLOv7-seg, class-max head", "fused", BATCH,
          {"class_max_head": True}, {"resize": 4, "bins": 1, "detect_head": 3}),
    "c": ("(c) AdaBins-B5 final upscale, kernel attention", "adabins", 1,
          {"attn_impl": "kernel", **FU},
          {"resize": EVAL_RESIZE + FU_BARE, CONCAT_COUNTER: EVAL_RESIZE, "bins": 1,
           "attention_fwd": 4}),
}
EXPORT_BUILDERS = {"flagship": build_flagship_pipeline, "fused": build_fused_flagship,
                   "adabins": build_adabins_pipeline}
# an exported graph's objcavit:: op -> the counter its CUDA implementation adds to
EXPORT_OP_COUNTERS = {"objcavit::resize_bilinear_ac": "resize",
                      "objcavit::resize_bilinear_ac_concat": "resize",
                      "objcavit::conv_bins_depth_batched": "bins",
                      "objcavit::attention_fwd": "attention_fwd",
                      "objcavit::detect_head": "detect_head",
                      "objcavit::se_project": "se_project",
                      "objcavit::mbconv_head": "mbconv_head"}
EXPORT_REQUESTS, EXPORT_LATENCIES = 10, 7  # served_rate's run and its timed requests
EXPORT_TIMEOUT = 420  # seconds the loading process may take
# the wrappers' CUDA launches, which an exported op's CUDA implementation
# calls too: where artifact and eager depth differ, the first launch whose
# inputs or outputs differ names where
LAUNCH_FUNCTIONS = ((kresize, "resize_cuda"), (kresize, "resize_into_concat_cuda"),
                    (kbins, "conv_bins_depth_batched_cuda"), (kattn, "fused_mha_fwd"),
                    (kdetect, "fused_detect_head_cuda"), (kse, "se_gate_project_cuda"),
                    (kmb, "mbconv_expand_dw_pool_cuda"))


def fingerprints(obj) -> list:
    """(fp64 sum, fp64 sum of squares) of each tensor in ``obj``."""
    tensors = [obj] if isinstance(obj, torch.Tensor) else [
        t for t in (obj if isinstance(obj, (tuple, list)) else ()) if isinstance(t, torch.Tensor)]
    return [(float(t.double().sum()), float(t.double().square().sum())) for t in tensors]


@contextlib.contextmanager
def record_launches():
    """While open, each served kernel launch (``LAUNCH_FUNCTIONS``) appends
    (its function, its inputs' and its outputs' fingerprints) to the
    yielded list."""
    seen, saved = [], []
    for module, name in LAUNCH_FUNCTIONS:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            seen.append((_name, fingerprints(list(args)), fingerprints(out)))
            return out

        # with the function's attributes: fused_mha_fwd counts its launches
        # on itself, by its module-level name
        functools.update_wrapper(wrapped, fn)
        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def first_difference(key: str, frames: np.ndarray) -> str:
    """Where case ``key``'s exported program first parts from its eager
    server: the first kernel launch whose inputs (then: whose outputs)
    differ, in launch order, from a new build and export of the same seed."""
    _, builder, _, kwargs, _ = EXPORT_CASES[key]
    pipe = EXPORT_BUILDERS[builder](dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0, **kwargs)
    program, weights = export_pipeline(pipe, frames.shape)
    module = program.module()
    with record_launches() as eager:
        pipe(frames)
    with record_launches() as exported, torch.inference_mode():
        module(weights, torch.from_numpy(frames).cuda())
    torch.cuda.synchronize()
    for i, (e, x) in enumerate(zip(eager, exported)):
        if e[0] != x[0] or e[1] != x[1]:
            return f"the inputs of launch {i} ({e[0]} eager, {x[0]} exported), after launch {i - 1}"
        if e[2] != x[2]:
            return f"the outputs of launch {i} ({e[0]}), on equal inputs"
    return f"no launch ({len(eager)} eager, {len(exported)} exported): after the last"


def phase_export() -> dict:
    """Phase 16: export. Three servers are exported on the card
    (``export_pipeline``, ``save_artifact``): (a) the flagship on kernel 5's
    and kernels 7 and 8's routes, bs 8; (b) the fused server on the plain
    routes with the class-max head (kernel 6) and the NMS loop, bs 8; (c)
    AdaBins-B5 with do_final_upscale on kernel 5's route, bs 1 (its long
    route at S 1200, kernel 1's bare form, kernel 2 at full resolution).
    Each eager server answers one counted request (its launches checked)
    and is traced once; each graph's objcavit:: ops must be those launches.
    Then one fresh process (``LOADER_FLAG``) loads
    the three artifacts with ``ServingArtifact`` alone and must import no
    model code, give each eager depth bit for bit (or, where not, name the
    first launch that differs and hold the depth within phase 9's bf16
    bound), launch what the eager server launched, and is timed (served
    rate, p50, one trace). Then each exported program (held here, as
    ``ServingArtifact`` runs it) and its eager server are timed in turns.
    Returns the eager and the loaded requests' launches summed, by
    kernels line: 'main' (a, b) and 'final' (c)."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rng = np.random.default_rng(1616)
    eager, frames_of, pipes, served = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"cases": [], "out": os.path.join(tmp, "loaded.json")}
        for key, (what, builder, batch, kwargs, want) in EXPORT_CASES.items():
            t1 = time.perf_counter()
            pipe = EXPORT_BUILDERS[builder](dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                            **kwargs)
            frames = frames_of[key] = rng.integers(0, 256, (batch, *EVAL_DIMS, 3),
                                                   dtype=np.uint8)
            pipe(frames)  # warm-up
            torch.cuda.synchronize()
            zero_counters()
            depth = pipe(frames)
            torch.cuda.synchronize()
            launches = expect_launches(f"{what}: eager, 1 request of {batch}", **want)
            check_depth(what, depth, pipe.model.min_depth, pipe.model.max_depth, batch,
                        EVAL_DIMS, full_res=builder == "adabins")
            t2 = time.perf_counter()
            program, weights = export_pipeline(pipe, frames.shape)
            export_s = time.perf_counter() - t2
            ops = graph_ops(program)
            per_counter = collections.Counter()
            for op, n in ops.items():
                per_counter[EXPORT_OP_COUNTERS[op]] += n
            if dict(per_counter) != {k: v for k, v in want.items() if k in COUNTERS}:
                raise AssertionError(f"{what}: the graph's ops {ops} are not the launches {want}")
            path = os.path.join(tmp, key)
            t2 = time.perf_counter()
            save_artifact(path, program, weights, extra_meta={"pipeline": builder})
            save_s = time.perf_counter() - t2
            sizes = {f: os.path.getsize(os.path.join(path, f))
                     for f in ("program.pt2", "weights.pt", "meta.json")}
            if not sizes["program.pt2"] < sizes["weights.pt"] / 10:
                raise AssertionError(f"{what}: the program carries weights: {sizes}")
            torch.save({"frames": torch.from_numpy(frames), "depth": depth.cpu()},
                       os.path.join(tmp, f"{key}_io.pt"))
            with open(os.path.join(path, "meta.json")) as f:
                served[key] = ServingArtifact(program, weights, json.load(f))
            del program, weights
            eager[key] = {"launches": launches, "trace": trace(lambda: pipe(frames), n_req=3)}
            log(f"  {what}: exported in {export_s:.2f} s, saved in {save_s:.2f} s; bytes: program "
                f"{sizes['program.pt2']}, weights {sizes['weights.pt']}, meta "
                f"{sizes['meta.json']}; graph ops {ops}; case built, checked and exported in "
                f"{time.perf_counter() - t1:.2f} s")
            spec["cases"].append({"name": key, "dir": path, "io": os.path.join(tmp, f"{key}_io.pt"),
                                  "requests": EXPORT_REQUESTS, "latencies": EXPORT_LATENCIES,
                                  "rtol": EVAL_METRIC_RTOL, "atol": EVAL_METRIC_ATOL})
            pipes[key] = pipe
            del depth
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), LOADER_FLAG, spec_path],
                              capture_output=True, text=True, timeout=EXPORT_TIMEOUT, cwd=REPO)
        loader_s = time.perf_counter() - t1
        for line in proc.stdout.splitlines():
            log(f"  [loader] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the loading process failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-6000:]}")
        with open(spec["out"]) as f:
            loaded = json.load(f)
        # the served rate of each exported program (the one the loading
        # process read back, held here) and its eager server, in turns
        # (eager, artifact, artifact, eager): the host's drift hits both
        for key, pipe in pipes.items():
            for side in ("eager", "artifact", "artifact", "eager"):
                eager[key].setdefault(side, []).append(served_rate(
                    pipe if side == "eager" else served[key], [frames_of[key]],
                    n_req=EXPORT_REQUESTS, n_lat=EXPORT_LATENCIES))
        del pipes, served
        torch.cuda.empty_cache()
    log(f"  loading process: {loader_s:.2f} s in all; model modules imported there: "
        f"{loaded['modules']}")
    if loaded["modules"]:
        raise AssertionError(f"the loading process imported model code: {loaded['modules']}")
    totals = {"main": collections.Counter(), "final": collections.Counter()}
    for key, (what, builder, batch, kwargs, want) in EXPORT_CASES.items():
        got, ref = loaded["cases"][key], eager[key]
        if got["launches"] != ref["launches"]:
            raise AssertionError(f"{what}: artifact launches {got['launches']}, eager "
                                 f"{ref['launches']}")
        if got["equal"]:
            agreement = "bit for bit"
        else:
            where = first_difference(key, frames_of[key])
            agreement = (f"NOT bit for bit: max abs diff {got['max_abs_diff']:.3e} m, first "
                         f"at {where}")
            if got["out_of_bound"]:
                raise AssertionError(f"{what}: {got['out_of_bound']} depth values of the artifact "
                                     f"out of phase 9's bound")
        rate = got["rate"]
        log(f"  {what}, artifact in the loading process: served {rate['img_per_s']:.2f} img/s "
            f"over {EXPORT_REQUESTS} requests of {batch}; p50 {rate['p50_ms']:.2f} ms of "
            f"{EXPORT_LATENCIES}; peak memory {rate['peak_gib']:.3f} GiB")
        for side in ("eager", "artifact"):
            rates = ref[side]
            log(f"  {what}, {side} in this process, in turns: served "
                + ", ".join(f"{r['img_per_s']:.2f}" for r in rates) + " img/s; p50 "
                + ", ".join(f"{r['p50_ms']:.2f}" for r in rates) + " ms")
        for side, t in (("eager", ref["trace"]), ("artifact", got["trace"])):
            log(f"  {what}, {side}: traced (3 requests): {t['window_ms_per_request']:.3f} ms a "
                f"request, device busy {t['device_busy_ms_per_request']:.3f} ms, "
                f"{t['device_kernels_per_request']:.0f} kernels, idle share "
                f"{t['idle_share']:.3f}")
        log(f"  {what}: artifact loaded in {got['load_s']:.2f} s, first request "
            f"{got['first_s']:.3f} s, depth {got['shape']} {got['dtype']} against eager: "
            f"{agreement}; launches {({k: v for k, v in got['launches'].items() if v})} "
            f"(as eager)")
        part = totals["final" if builder == "adabins" else "main"]
        part.update(ref["launches"])
        part.update(got["launches"])
    log(f"export: {time.perf_counter() - t0:.1f} s")
    return {k: dict(v) for k, v in totals.items()}


# phase 17: tensor parallelism of the attention stacks (objcavit_torch/parallel/
# tp.py) on a 1 x 2 process grid: two processes on the one card over gloo
# (NCCL refuses two ranks on one card), each holding 2 of the flagship's 4
# heads and 512 of its FFN's 1024 columns, against one process
TP_GRID = (1, 2)  # (n_data, n_model)
TP_TIMEOUT = 480  # seconds the two processes may take (phases 17 and 18) before they are killed
TP_FLAG = "--tp-rank"
TP_FFN = 1024  # the flagship's FFN width
TP_FRAMES_SEED = 1717
TP_REQUESTS = 2  # counted requests after a warm-up, the first one's kernel-5 launches checked
TP_TIMED = 3  # synchronised requests timed after them
TP_STEPS = 3  # bf16 steps on kernel 5's route: the first checked, the last two timed
TP_REQUEST_LAUNCHES = {"attention_fwd": 10, "resize": 4, "bins": 1, "mbconv_head": 32,
                       "se_project": 7}
TP_STEP_LAUNCHES = {"bins_expectation_fwd": 1, "bins_expectation_bwd": 1, "attention_fwd": 10,
                    "attention_bwd": ATTN_BWD_PER_STEP}
# (a)'s depth against one process's server on the same frames. The two runs
# differ only where the split reorders a sum: each rank rounds its half of
# out_proj's and linear2's products to bf16, the all-reduce adds the halves
# in bf16 and the bias follows (two roundings more than one process's one)
# at the 18 block outputs of a forward; every other op sees the same
# inputs. That is a few bf16 ulps at 18 places, far less rounding than the
# bf16 route as a whole carries, which phase 4 holds against fp32 at
# FEATURE_REL_BOUND on ObjCAViT's outputs: the depth's rel L2 is held there
TP_SERVE_REL = FEATURE_REL_BOUND
# (b)'s first step against one process's on the same batch and draws: in
# fp64 on the plain route at phase 15's DIST_FP64_REL (the bins head's
# softmax stays fp32 in an fp64 step, so a reordered fp64 sum may move an
# fp32 rounding); in bf16 on kernel 5's route, the loss at phase 15's
# DIST_BF16_LOSS_REL and the gradients at the bf16 train check's bounds
# (TRAIN_GRAD_GROUPS), as phase 15 (b) holds two processes against one
TP_STEP_BOUNDS = {"fp64 plain": (DIST_FP64_REL, {g: DIST_FP64_REL for g in TRAIN_GRAD_GROUPS}),
                  "bf16 kernel": (DIST_BF16_LOSS_REL, {g: b for g, (_, b) in
                                                       TRAIN_GRAD_GROUPS.items()})}

# phase 18: spatial serving on phase 17's 1 x 2 grid, the flagship's attention
# replicated: each rank's band of the 480 rows, 8 + 7 units of 32
SPATIAL_BANDS = [(0, 256), (256, 480)]
SPATIAL_REQUEST_LAUNCHES = {"resize_rows": 4, "mbconv_rows": 32, "se_project": 7,
                            "attention_fwd": 10, "bins": 1}
SPATIAL_ADABINS_LAUNCHES = {**SPATIAL_REQUEST_LAUNCHES, "attention_fwd": 4}
SPATIAL_BATCHES = (1, BATCH)  # (a) and (b): frames [:1] and [:8] of phase 17's first request
SPATIAL_TIMED = 2  # timed requests a batch, after the counted one
SPATIAL_BUDGET_S = 60.0  # past this many seconds on a rank, phase 18 times one request, not two
# (a) and (b)'s depth against one process's server on the same frames: the
# bands differ from the whole image only where a conv, cuDNN's choice of
# algorithm for the band's shape, or a sum (the SE means: each band's fp32
# sum, then the two added) rounds in another order, each a bf16 rounding or
# less at the place it happens, far less than the bf16 route carries against
# fp32 (phase 4, FEATURE_REL_BOUND): the depth's rel L2 is held there too
SPATIAL_SERVE_REL = TP_SERVE_REL


def check_split(what: str, model, grid) -> dict[str, tuple]:
    """Every attention holds ATTN_HEADS / n_model heads and every FFN
    TP_FFN / n_model columns, none replicated: -> the split parameters'
    local shapes."""
    blocks = [m for m in model.modules()
              if isinstance(m, (MultiHeadAttention, TransformerEncoderLayer))]
    heads = {m.in_proj_weight.shape[0] // 3 // HEAD_DIM for m in blocks
             if isinstance(m, MultiHeadAttention)}
    widths = {m.linear1.weight.shape[0] for m in blocks if isinstance(m, TransformerEncoderLayer)}
    if (any(m.tp is None for m in blocks) or heads != {ATTN_HEADS // grid.n_model}
            or widths != {TP_FFN // grid.n_model}):
        raise AssertionError(f"{what}: heads a rank {heads}, FFN columns a rank {widths}, "
                             f"{sum(m.tp is None for m in blocks)} blocks replicated")
    return {n: tuple(model.get_parameter(n).shape) for n in tp_specs(model, grid.n_model)}


def tp_serve(what: str, grid=None) -> dict:
    """(a): the flagship server on kernel 5's route and kernels 7 and 8's,
    bf16, BN folded, 480x640, 300 slots; split over ``grid``'s model axis
    where there is one. A warm-up request, TP_REQUESTS counted ones (their
    launches; the first one's kernel-5 launches against the plain version),
    then TP_TIMED timed ones. -> depths, launches, kernel 5's head counts,
    wall ms a request."""
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0,
                                   attn_impl="kernel", encoder_impl="kernel", grid=grid)
    if grid is not None:
        check_split(what, pipe.model, grid)
    rng = np.random.default_rng(TP_FRAMES_SEED)
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8)
              for _ in range(TP_REQUESTS)]
    pipe(frames[0])  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    with record_attention_io() as records:
        depths = [pipe(f) for f in frames]
    torch.cuda.synchronize()
    launches = expect_launches(f"(a) {what}, {TP_REQUESTS} requests of {BATCH}",
                               **{k: v * TP_REQUESTS for k, v in TP_REQUEST_LAUNCHES.items()})
    heads = sorted({tuple(r["q"].shape[::2]) for r in records})  # (B, H) of each launch
    check_attention_records(f"(a) {what}, request 0", records[:TP_REQUEST_LAUNCHES[
        "attention_fwd"]], residual=False)
    del records
    for i, depth in enumerate(depths):
        check_depth(f"(a) {what}, request {i}", depth, pipe.model.min_depth, pipe.model.max_depth)
    ms = []
    for i in range(TP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(frames[i % len(frames)])
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
    out = {"depths": [d.cpu() for d in depths], "launches": launches, "heads": heads, "ms": ms}
    if grid is None:  # phase 18's references: one process's server on its frames
        out["spatial"] = spatial_reference(pipe, frames[0])
    del pipe, depths
    torch.cuda.empty_cache()
    return out


def tp_first_step(attn_impl: str, dtype: torch.dtype, grid=None) -> dict:
    """(b)'s first step of the flagship train step (bs 8, 416x544, 221
    slots; seed 0's weights, batch and draws) on ``attn_impl`` in ``dtype``
    (parameters too where fp64), split over ``grid``'s model axis where
    there is one: -> its loss and the whole model's gradients by group."""
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                n_obj=TRAIN_SLOTS, seed=0, attn_impl=attn_impl)
    model = step.model
    if dtype == torch.float64:
        model.double()
        batch, objects = ({k: v.double() if v.is_floating_point() else v for k, v in t.items()}
                          for t in (batch, objects))
    if grid is not None:
        tp_shard_model(model, grid)
    loss_fn = make_train_loss_fn(model, LossWrapper(*TRAIN_LOSSES), model.min_depth,
                                 augment_on_device=True, compute_dtype=dtype)
    loss = loss_fn(batch, objects, torch.Generator(batch["image"].device).manual_seed(0))
    loss.backward()
    out = {"loss": float(loss.detach()), "grads": group_grads(model, grid)}
    del step, model, loss
    torch.cuda.empty_cache()
    return out


def tp_train(what: str, grid=None) -> dict:
    """(b): the first step in fp64 on the plain route, then TP_STEPS bf16
    steps of the flagship step on kernel 5's route, split over ``grid``'s
    model axis where there is one: each step's launches, the first step's
    loss and gradients (before the clipping) and its kernel-5 launches
    against the plain version, the split parameters' shapes after the
    updates, wall ms a step."""
    out = {"fp64 plain": tp_first_step("plain", torch.float64, grid)}
    step, batch, objects = build_flagship_train(batch=BATCH, h=TRAIN_DIMS[0], w=TRAIN_DIMS[1],
                                                n_obj=TRAIN_SLOTS, seed=0, attn_impl="kernel")
    local = {}
    if grid is not None:
        tp_shard_model(step.model, grid)  # the optimizer keeps its parameters, split in place
        local = check_split(what, step.model, grid)
    losses, ms, launches = [], [], collections.Counter()
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        before = read_counters()
        t0 = time.perf_counter()
        if i == 0:
            with record_attention_io() as records:
                loss = step.loss(batch, objects)
                loss.backward()
                reducer, step.grad_reducer = step.grad_reducer, None
                if reducer is not None:  # the update's reduction, before the gradients are read
                    reducer()
                grads = group_grads(step.model, grid)
                step.update()
                step.grad_reducer = reducer
        else:
            loss = step(batch, objects)
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        after = read_counters()
        got = {k: after[k] - before[k] for k in TP_STEP_LAUNCHES}
        if got != TP_STEP_LAUNCHES:
            raise AssertionError(f"(b) {what}, step {i}: launches {got}")
        launches.update({k: after[k] - before[k] for k in after})
        losses.append(float(loss.detach()))
    check_attention_records(f"(b) {what}, step 0", records, residual=True)
    del records
    moved = {n: tuple(step.model.get_parameter(n).shape) for n in local}
    if moved != local:
        raise AssertionError(f"(b) {what}: the split parameters changed shape in the update")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(b) {what}: a loss is not finite: {losses}")
    out.update({"bf16 kernel": {"loss": losses[0], "grads": grads}, "losses": losses,
                "ms": ms, "launches": dict(launches), "local": len(local)})
    del step
    torch.cuda.empty_cache()
    return out


def timed_requests(pipe, frames, n: int) -> list[float]:
    """Wall ms of ``n`` synchronised requests of ``frames``."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(frames)
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
    return ms


def spatial_reference(pipe, frames: np.ndarray) -> dict:
    """Phase 18's one-process references: ``pipe``'s (phase 17's one-process
    flagship server) depth and wall ms on each of SPATIAL_BATCHES' frames,
    and AdaBins-B5's depth at bs 1; the seconds they took."""
    t0, out = time.perf_counter(), {}
    for b in SPATIAL_BATCHES:
        out[f"bs {b}"] = {"depth": pipe(frames[:b]).cpu(),
                          "ms": timed_requests(pipe, frames[:b], SPATIAL_TIMED)}
    adabins = DepthPipeline(build_adabins_model(dtype=torch.bfloat16, seed=0, attn_impl="kernel",
                                                encoder_impl="kernel"), eval_dims=EVAL_DIMS)
    out["adabins"] = {"depth": adabins(frames[:1]).cpu(),
                      "ms": timed_requests(adabins, frames[:1], SPATIAL_TIMED)}
    del adabins
    out["seconds"] = time.perf_counter() - t0
    return out


def spatial_request(what: str, pipe, frames: np.ndarray, want: dict, heads: int,
                    timed: int = SPATIAL_TIMED) -> dict:
    """One counted request of phase 18 after a warm-up: its launches
    (``want``), the launches of the two new forms and of kernel 5 against
    their plain versions (kernel 5 at (B, ``heads``)), the depth's range;
    then ``timed`` timed requests. -> depth, launches, the new forms'
    largest errors, wall ms."""
    pipe(frames)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    with record_resize_rows_io() as resized, record_encoder_kernel_io() as encoder, \
            record_attention_io() as attn:
        depth = pipe(frames)
    torch.cuda.synchronize()
    launches = expect_launches(what, **want)
    errs = {"resize_rows": 0.0, "mbconv_rows": 0.0}
    if any(r["args"][5] is None for r in resized):
        raise AssertionError(f"{what}: a row-window launch without its skip (the concat layout)")
    for i, r in enumerate(resized):
        e = resize_rows_errors(r)
        if e["bad"]:
            raise AssertionError(f"{what}: kernel 1's row-window launch {i}: {e}")
        errs["resize_rows"] = max(errs["resize_rows"], e["y"])
    for i, r in enumerate(rec for rec in encoder if rec["kind"] == "mbconv_head_rows"):
        x, we, be, wd, bd, k, top, bottom = r["args"]
        e = mbconv_head_errors(x, we, be, wd, bd, k, *r["out"], MB_RTOL, MB_ATOL, POOL_RTOL,
                               rows=(top, bottom))
        if e["bad"]:
            raise AssertionError(f"{what}: kernel 8's halo-form launch {i}: {e}")
        errs["mbconv_rows"] = max(errs["mbconv_rows"], e["y"])
    got_heads = sorted({tuple(r["q"].shape[::2]) for r in attn})
    if got_heads != [(frames.shape[0], heads)]:
        raise AssertionError(f"{what}: kernel 5's (B, H) {got_heads}")
    check_attention_records(what, attn, residual=False)
    del resized, encoder, attn
    log(f"  {what}: kernel 1's row-window form max abs err {errs['resize_rows']}, kernel 8's "
        f"halo form {errs['mbconv_rows']} against their plain versions, every launch in "
        f"tolerance; kernel 5 at (B, H) {got_heads}")
    return {"depth": depth.cpu(), "launches": launches, "errs": errs,
            "ms": timed_requests(pipe, frames, timed)}


def spatial_rank(what: str, grid) -> dict:
    """Phase 18 on one rank of ``grid``: the flagship (attention replicated)
    and AdaBins-B5 on kernel 5's route and kernels 7 and 8's, served
    spatially; the plan's bands, then (a) bs 1, (b) bs 8 of phase 17's
    first request's frames and AdaBins at bs 1 (``spatial_request``; one
    timed request each, not SPATIAL_TIMED, once the rank has spent
    SPATIAL_BUDGET_S). -> each request's outputs, the rank's seconds."""
    t0 = time.perf_counter()
    model = build_flagship_model(dtype=torch.bfloat16, seed=0, attn_impl="kernel",
                                 encoder_impl="kernel")
    pipe = DepthPipeline(model, eval_dims=EVAL_DIMS, grid=grid, spatial=True)
    bands = pipe.bands().bands()
    if bands != SPATIAL_BANDS:
        raise AssertionError(f"(18) {what}: bands {bands}, want {SPATIAL_BANDS}")
    frames = np.random.default_rng(TP_FRAMES_SEED).integers(0, 256, (BATCH, *EVAL_DIMS, 3),
                                                            dtype=np.uint8)
    out = {}

    def timed() -> int:
        return SPATIAL_TIMED if time.perf_counter() - t0 < SPATIAL_BUDGET_S else 1

    for b in SPATIAL_BATCHES:
        out[f"bs {b}"] = spatial_request(f"(18) {what}, bs {b}", pipe, frames[:b],
                                         SPATIAL_REQUEST_LAUNCHES, ATTN_HEADS, timed())
    del pipe, model
    adabins = DepthPipeline(build_adabins_model(dtype=torch.bfloat16, seed=0, attn_impl="kernel",
                                                encoder_impl="kernel"),
                            eval_dims=EVAL_DIMS, grid=grid, spatial=True)
    out["adabins"] = spatial_request(f"(18) {what}, AdaBins-B5 bs 1", adabins, frames[:1],
                                     SPATIAL_ADABINS_LAUNCHES, ATTN_HEADS, timed())
    del adabins
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_rank(spec_path: str) -> None:
    """One process of phase 17, started by ``parallel.launch`` with its
    rank's env: joins a gloo group on the card, makes the 1 x 2 grid, runs
    (a) and (b) split over its model axis and saves rank_<p>.pt."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo")
    try:
        grid = make_grid(*TP_GRID)
        what = f"rank {process_index()} (model index {grid.model_index})"
        out = {"rank": process_index(), "serve": tp_serve(what, grid),
               "train": tp_train(what, grid), "spatial": spatial_rank(what, grid)}
        torch.save(out, os.path.join(spec["work"], f"rank_{process_index()}.pt"))
    finally:
        shutdown_distributed()


def phase_tp() -> dict:
    """Tensor parallelism: two processes on the card over gloo
    (``parallel.launch``, ``tp_rank``) as a 1 x 2 grid, the flagship split
    over its model axis (2 heads and 512 FFN columns a rank), then one
    process: (a) the server's depth, the same bits on both ranks and within
    TP_SERVE_REL of one process's, 10 kernel-5 launches a request at B 8, H
    2; (b) the first step's gathered gradients against one process's at
    TP_STEP_BOUNDS, 10 + 9 kernel-5 launches a step, the split kept through
    the updates; (c) wall ms a request and a step, ranks and one process
    (a one-card gloo time). -> the ranks' launches."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        spec = os.path.join(work, "spec.json")
        with open(spec, "w") as f:
            json.dump({"work": work}, f)
        out = io.StringIO()
        rc = launch([sys.executable, os.path.abspath(__file__), TP_FLAG, spec], TP_GRID[0] * TP_GRID[1],
                    out=out, timeout=TP_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        text = out.getvalue()
        log("\n".join(line for line in text.splitlines() if "(a) " in line or "(b) " in line
                      or "(18) " in line or "Error" in line))
        if rc != 0:
            raise AssertionError(f"tp: the ranks exited {rc}:\n{text[-6000:]}")
        ranks = [torch.load(os.path.join(work, f"rank_{r}.pt"), weights_only=False)
                 for r in range(TP_GRID[0] * TP_GRID[1])]
    t1 = time.perf_counter()
    one = {"serve": tp_serve("one process"), "train": tp_train("one process")}
    one_s = time.perf_counter() - t1
    r0 = ranks[0]
    bad = []
    for r in ranks[1:]:
        if not all(torch.equal(a, b) for a, b in zip(r["serve"]["depths"], r0["serve"]["depths"])):
            bad.append(f"(a) rank {r['rank']}'s depth differs from rank 0's")
        if r["train"]["losses"] != r0["train"]["losses"]:
            bad.append(f"(b) rank {r['rank']}'s losses differ from rank 0's")
    heads = {h for r in ranks for h in r["serve"]["heads"]}
    if heads != {(BATCH, ATTN_HEADS // TP_GRID[1])}:
        bad.append(f"kernel 5's (B, H) on the ranks {heads}")
    rels = [rel_l2(d, w) for d, w in zip(r0["serve"]["depths"], one["serve"]["depths"])]
    err = max(float((d - w).abs().max())
              for d, w in zip(r0["serve"]["depths"], one["serve"]["depths"]))
    log(f"  (a) depth: the ranks bit for bit {'NOT ' * any('(a) rank' in b for b in bad)}alike; "
        f"against one process's server, rel L2 {', '.join(f'{v:.3e}' for v in rels)} (bound {TP_SERVE_REL}), "
        f"max abs err {err:.4e} m; kernel 5's (B, H) on the ranks {sorted(heads)}, one process "
        f"{one['serve']['heads']}")
    if max(rels) > TP_SERVE_REL:
        bad.append("(a) depth")
    for label, (loss_bound, grad_bounds) in TP_STEP_BOUNDS.items():
        got, want = r0["train"][label], one["train"][label]
        grels = {g: rel_l2(got["grads"][g], want["grads"][g]) for g in want["grads"]}
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        log(f"  (b) first step, the 1 x 2 grid's gathered gradients vs one process's, {label}: "
            f"loss {got['loss']!r} vs {want['loss']!r} (rel {loss_rel:.3e}, bound {loss_bound}); "
            "gradient rel L2 " + ", ".join(f"{g} {v:.3e} (bound {grad_bounds[g]:.3e})"
                                           for g, v in grels.items()))
        if loss_rel > loss_bound or any(v > grad_bounds[g] for g, v in grels.items()):
            bad.append(f"(b) {label}")
    log(f"  (b) losses (the ranks' bit for bit alike, each step): ranks "
        f"{[r['train']['losses'] for r in ranks]}, one process "
        f"{one['train']['losses']}; {r0['train']['local']} split parameters a rank kept their "
        f"shapes through {TP_STEPS} updates")
    for part, unit in (("serve", "a request"), ("train", "a step")):
        log(f"  (c) wall ms {unit}, a one-card gloo time (not a claim): ranks "
            f"{[[round(t, 3) for t in r[part]['ms']] for r in ranks]}, one process "
            f"{[round(t, 3) for t in one[part]['ms']]}")
    log(f"tp: {time.perf_counter() - t0:.1f} s (the ranks {ranks_s:.1f}, one process "
        f"{one_s:.1f}; phase 18's share below)")
    bad += check_spatial(ranks, one["serve"]["spatial"])
    if bad:
        raise AssertionError(f"tp: {bad}")
    launches, spatial = collections.Counter(), collections.Counter()
    for r in ranks:
        launches.update(r["serve"]["launches"])
        launches.update(r["train"]["launches"])
        for key in ("bs 1", f"bs {BATCH}", "adabins"):
            spatial.update(r["spatial"][key]["launches"])
    torch.cuda.empty_cache()
    return {"tp": dict(launches), "spatial": dict(spatial)}


def check_spatial(ranks: list[dict], one: dict) -> list[str]:
    """Phase 18's checks across the ranks: each request's depth the same
    bits on both ranks and within SPATIAL_SERVE_REL of one process's; (c)
    the wall ms. -> what failed."""
    bad = []
    cases = [(f"bs {b}", f"({'ab'[i]}) bs {b}") for i, b in enumerate(SPATIAL_BATCHES)]
    for key, label in cases + [("adabins", "AdaBins-B5 bs 1")]:
        got = [r["spatial"][key]["depth"] for r in ranks]
        want = one[key]["depth"]
        same = all(torch.equal(g, got[0]) for g in got[1:])
        rel = rel_l2(got[0], want)
        check_depth(f"(18) {label}, rank 0", got[0], 0.001, 10.0, batch=want.shape[0])
        log(f"  (18) {label}: depth on the ranks {'bit for bit alike' if same else 'DIFFERS'}; "
            f"against one process's server rel L2 {rel:.3e} (bound {SPATIAL_SERVE_REL}), max "
            f"abs err {float((got[0] - want).abs().max()):.4e} m")
        log(f"  (18) (c) {label}: wall ms a request, a one-card gloo time (not a claim): ranks "
            f"{[[round(t, 3) for t in r['spatial'][key]['ms']] for r in ranks]}, one process "
            f"{[round(t, 3) for t in one[key]['ms']]}")
        if not same or rel > SPATIAL_SERVE_REL:
            bad.append(f"(18) {label}")
    ranks_s = max(r["spatial"]["seconds"] for r in ranks)
    log(f"spatial: {ranks_s + one['seconds']:.1f} s: {ranks_s:.1f} on the ranks (inside phase "
        f"17's launch), {one['seconds']:.1f} for the one-process references (inside its "
        f"one-process run)")
    return bad


WATCH_REGRESSOR = {"kernel": 0.11606, "plain": 0.09133}


def watch_gradients(plain: dict, kernel: dict) -> None:
    """Log the regressor's and the first image attention's gradient rel L2
    on kernel 5's route beside the plain route's, and whether the
    regressor's gap is wider than the stored reading's."""
    watched = WATCH_REGRESSOR
    old_gap = watched["kernel"] - watched["plain"]
    gap = kernel["regressor"] - plain["regressor"]
    log(f"watch: gradient rel L2 on the seed's weights, kernel 5's route vs the plain route: "
        f"regressor {kernel['regressor']:.5f} vs {plain['regressor']:.5f} (gap {gap:.5f}; "
        f"{watched['kernel']} vs {watched['plain']}, gap {old_gap:.5f}, stored), image "
        f"attention 0 {kernel['image attention 0']:.5f} vs {plain['image attention 0']:.5f}; "
        # the stored readings are rounded to 1e-5 each
        + ("WIDER than before" if gap > old_gap + 2e-5 else "no wider than before"))


def main() -> None:
    if sys.argv[1:2] == ["--dist-rank"]:  # one process of phase 15 (b)
        dist_rank(sys.argv[2])
        return
    if sys.argv[1:2] == [TP_FLAG]:  # one process of phase 17
        tp_rank(sys.argv[2])
        return
    name = phase_device()
    phase_build()
    kernels = phase_kernels()
    serving = phase_slice()
    unfactored = phase_unfactored_head()
    attn_serving = phase_slice("kernel")
    encoder_serving = phase_encoder_route()
    encoder_functions = phase_encoder_functions()
    fused = phase_fused()
    train, plain_rels = phase_train()
    attn_train, kernel_rels = phase_train("kernel", n_timed=2)
    watch_gradients(plain_rels, kernel_rels)
    adabins = phase_adabins()
    log(f"  kernel-5 launches: flagship server {attn_serving['attention_fwd']}, flagship train "
        f"{attn_train['attention_fwd']} + {attn_train['attention_bwd']}, adabins server {adabins}")
    validate = phase_validate()
    log(f"  validate path (-v --bf16, {VALIDATE_IMAGES} images): kernel-1 concat launches "
        f"{validate['launches'][CONCAT_COUNTER]}, kernel-2 launches {validate['launches']['bins']}")
    fit_phase = phase_fit()
    fit = fit_phase["launches"]
    log(f"  fit path ({FIT_EPOCHS} epochs of {FIT_STEPS} steps): kernel-4 launches "
        f"{fit['bins_expectation_fwd']} + {fit['bins_expectation_bwd']}, kernel-1 concat "
        f"{fit[CONCAT_COUNTER]}, kernel-2 {fit['bins']}; the kernels line counts kernel 4 over "
        f"the train phase and the fit")
    options = phase_options()
    served, trained = options["served"], options["trained"]
    log(f"  options paths ({len(OPTIONS)} options): served {served}, trained {trained}; the "
        f"kernels line adds them to kernels 1, 2, 4 and 5's counts")
    v2 = phase_v2()
    log(f"  V2 encoder paths: {v2}; the kernels line adds them to kernels 1, 2, 4, 5 and 7's "
        f"counts")
    final_upscale = phase_final_upscale()
    fu, dp = final_upscale["final"], final_upscale["drop_path"]
    log(f"  final-upscale paths: {fu}; the kernels line counts them in kernel 1's concat form "
        f"and in the final-upscale entries of kernels 1, 2, 4 and 5; drop-path paths: {dp}, "
        f"counted in kernels 1, 2, 4, 7 and 8's entries")
    host = phase_host_core(fit_phase["stats"]["epoch"])
    log(f"  old_dl fit path ({FIT_EPOCHS} epochs of {FIT_STEPS} steps): kernel-4 launches "
        f"{host['bins_expectation_fwd']} + {host['bins_expectation_bwd']}, kernel-1 concat "
        f"{host[CONCAT_COUNTER]}, kernel-2 {host['bins']}; the kernels line adds them to "
        f"kernels 1, 2 and 4's counts")
    dist = phase_distributed()
    log(f"  distributed paths ((a) two fits, (b) both ranks' fits): kernel-4 launches "
        f"{dist['bins_expectation_fwd']} + {dist['bins_expectation_bwd']}, kernel-5 "
        f"{dist['attention_fwd']} + {dist['attention_bwd']}, kernel-1 concat "
        f"{dist[CONCAT_COUNTER]}, kernel-2 {dist['bins']}; the kernels line adds them to "
        f"kernels 1, 2, 4 and 5's counts")
    exported = phase_export()
    ex, exf = exported["main"], exported["final"]
    log(f"  export paths (one eager and one loaded request of each artifact): (a) and (b) "
        f"{ex}, (c) {exf}; the kernels line adds (a) and (b) to kernels 1 (concat), 2, 5, 6, "
        f"7 and 8's counts and (c) to the final-upscale entries of kernels 1, 2 and 5 and to "
        f"kernel 1's concat form")
    tp_phase = phase_tp()
    tp, spatial = tp_phase["tp"], tp_phase["spatial"]
    log(f"  spatial paths (both ranks: bs 1, bs {BATCH} and AdaBins-B5 bs 1, a counted request "
        f"each): kernel 1's row-window form {spatial['resize_rows']}, kernel 8's halo form "
        f"{spatial['mbconv_rows']}, kernel-7 {spatial['se_project']}, kernel-5 "
        f"{spatial['attention_fwd']}, kernel-2 {spatial['bins']}; the kernels line adds them to "
        f"kernels 2, 5 and 7's counts")
    log(f"  tensor-parallel paths (both ranks: {TP_REQUESTS} counted requests, {TP_STEPS} bf16 "
        f"steps): kernel-5 launches {tp['attention_fwd']} + {tp['attention_bwd']}, kernel-4 "
        f"{tp['bins_expectation_fwd']} + {tp['bins_expectation_bwd']}, kernel-1 concat "
        f"{tp[CONCAT_COUNTER]}, kernel-2 {tp['bins']}, kernel-8 {tp['mbconv_head']}, kernel-7 "
        f"{tp['se_project']}; the kernels line adds them to kernels 1, 2, 4, 5, 7 and 8's counts")

    def entry(name, source, replaces, launches, key):
        return {"name": name, "route": "cuda", "source": f"objcavit_torch/csrc/{source}",
                "replaces": f"objcavit_tpu/ops/{replaces}", "launches": launches, **kernels[key]}

    print(json.dumps({"kernels": [
        entry("resize_bilinear_align_corners_into_concat (kernel 1's concat form)",
              "resize_bilinear.cu", "resize_pallas.py:104",
              serving["resize"] + served[CONCAT_COUNTER] + v2[CONCAT_COUNTER] + fu[CONCAT_COUNTER]
              + dp[CONCAT_COUNTER] + host[CONCAT_COUNTER] + dist[CONCAT_COUNTER]
              + ex.get(CONCAT_COUNTER, 0) + exf.get(CONCAT_COUNTER, 0) + tp[CONCAT_COUNTER],
              "resize_concat"),
        entry("resize_bilinear_align_corners_rows (kernel 1's row-window form in its concat "
              "layout: spatial serving, timed at rank 0's band, rows 0-255 of 480)",
              "resize_bilinear.cu", "resize_pallas.py:104", spatial["resize_rows"],
              "resize_rows"),
        entry("resize_bilinear_align_corners_nhwc_bf16 (kernel 1's bare form, a function path)",
              "resize_bilinear.cu", "resize_pallas.py:104", serving["resize_bare"], "resize"),
        entry("resize_bilinear_align_corners_nhwc_bf16 (kernel 1's bare form at the final "
              "upsample, (8, 240, 320, 128) -> 480x640, then torch.cat with the image)",
              "resize_bilinear.cu", "resize_pallas.py:104",
              fu["resize"] - fu[CONCAT_COUNTER] + exf["resize"] - exf[CONCAT_COUNTER],
              "resize_final"),
        entry("conv_bins_depth_batched", "bins_depth.cu", "pallas_bins.py:214",
              serving["bins"] + served["bins"] + v2["bins"] + dp["bins"] + host["bins"]
              + dist["bins"] + ex["bins"] + tp["bins"] + spatial["bins"], "bins"),
        entry("conv_bins_depth_batched (full resolution, (8, 480, 640, 128))", "bins_depth.cu",
              "pallas_bins.py:214", fu["bins"] + exf["bins"], "bins_final"),
        entry("conv_bins_depth (kernel 2, shared W)", "bins_depth.cu", "pallas_bins.py:163",
              unfactored["bins_shared"], "bins_shared"),
        entry("bins_expectation_fwd", "bins_expectation.cu", "pallas_bins.py:63",
              train["bins_expectation_fwd"] + fit["bins_expectation_fwd"]
              + trained["bins_expectation_fwd"] + v2["bins_expectation_fwd"]
              + dp["bins_expectation_fwd"] + host["bins_expectation_fwd"]
              + dist["bins_expectation_fwd"] + tp["bins_expectation_fwd"], "bins_expectation_fwd"),
        entry("bins_expectation_bwd", "bins_expectation.cu", "pallas_bins.py:91",
              train["bins_expectation_bwd"] + fit["bins_expectation_bwd"]
              + trained["bins_expectation_bwd"] + v2["bins_expectation_bwd"]
              + dp["bins_expectation_bwd"] + host["bins_expectation_bwd"]
              + dist["bins_expectation_bwd"] + tp["bins_expectation_bwd"], "bins_expectation_bwd"),
        entry("bins_expectation_fwd (full resolution, (8, 226304, 256))", "bins_expectation.cu",
              "pallas_bins.py:63", fu["bins_expectation_fwd"], "bins_expectation_fwd_final"),
        entry("bins_expectation_bwd (full resolution, (8, 226304, 256))", "bins_expectation.cu",
              "pallas_bins.py:91", fu["bins_expectation_bwd"], "bins_expectation_bwd_final"),
        entry("fused_detect_head", "detect_head.cu", "detect_head_pallas.py:65",
              fused + ex["detect_head"], "detect_head"),
        entry("fused_mha_fwd", "attention.cu", "pallas_attention.py:91",
              attn_serving["attention_fwd"] + served["attention_fwd"] + trained["attention_fwd"]
              + v2["attention_fwd"] + dist["attention_fwd"] + ex["attention_fwd"]
              + tp["attention_fwd"] + spatial["attention_fwd"], "attention_fwd"),
        entry("fused_mha_bwd", "attention.cu", "pallas_attention.py:108",
              attn_train["attention_bwd"] + trained["attention_bwd"] + v2["attention_bwd"]
              + dist["attention_bwd"] + tp["attention_bwd"], "attention_bwd"),
        entry("fused_mha_fwd (beyond 512 keys, the long route: final upscale, timed at "
              "S 1200)", "attention.cu", "pallas_attention.py:91",
              fu["attention_fwd"] + exf["attention_fwd"], "attention_fwd_final"),
        entry("fused_mha_bwd (beyond 512 keys, the long route: final upscale, timed at "
              "S 884)", "attention.cu", "pallas_attention.py:108", fu["attention_bwd"],
              "attention_bwd_final"),
        entry("se_gate_project", "se_project.cu", "se_project_pallas.py:80",
              encoder_serving["se_project"] + v2["se_project"] + dp["se_project"]
              + ex["se_project"] + tp["se_project"] + spatial["se_project"], "se_project"),
        entry("mbconv_expand_dw_pool", "mbconv_head.cu", "mbconv_pallas.py:153",
              encoder_serving["mbconv_head"] + dp["mbconv_head"] + ex["mbconv_head"]
              + tp["mbconv_head"], "mbconv_head"),
        entry("mbconv_expand_dw_pool_rows (kernel 8's halo form: spatial serving, a band and "
              "its k // 2 halo rows as one tensor, timed at rank 0's band)", "mbconv_head.cu",
              "mbconv_pallas.py:153", spatial["mbconv_rows"], "mbconv_rows"),
        entry("mbconv_bs_expand_dw_pool (kernel 8 on an (H, W, B, C) tensor map)", "mbconv_head.cu",
              "mbconv_bs.py:180", encoder_functions["mbconv_bs"], "mbconv_bs"),
        entry("dw_conv_silu_pool (a ring of input rows by TMA, rolling tap rows; a function path)",
              "dw_silu_pool.cu", "dw_pallas.py:88", encoder_functions["dw_conv"], "dw_conv"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
