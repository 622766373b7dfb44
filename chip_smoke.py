"""Smoke run of the u2seg_torch port on one CUDA card.

    python3 chip_smoke.py [--report PATH] [--phases k1,k3,k4,k5,serve,cpu,eval,eval_cpu,dataset_eval,dataset_eval_cpu,matcher,train,train_cpu,overfit,train_loop,ddp,ddp_cpu,train_net,train_net_cpu,pseudo,pseudo_cpu,zoo,zoo_cpu,augment,semisup,rotated,projects,projects_cpu,projects2,projects2_cpu,demo,export,analyze,tools_cpu]

Phases (each prints one or more lines; any failure raises and exits non-zero;
with no ``--phases`` all of them run, which is what the last line vouches for):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the port's CUDA kernels compiled from ``u2seg_torch/csrc`` (nvcc,
   sm_90a), one nvcc per source, all started together;
3. k1, kernel vs plain: the multilevel ROIAlign forward kernel against its
   plain PyTorch twin on the card, at the serving path's shapes (p2-p5 of an
   800x1216 image, C=256; R=1000 at s=7, R=100 at s=14), f32 with TF32 off
   at 1e-4 and bf16 at the AMP tolerance (rtol 0.05, atol 0.03); its time,
   the twin's, and the bound; once more at a narrow ragged width (C=72: the
   last chunk of channels is partly empty) for every dtype pair, and on
   boxes whose bins are taller than the stage buffer. The times are device
   times: the launches are captured into one CUDA graph, so no host code
   runs between them. Once with L2 warm (one launch repeated) and once with
   L2 exceeded (rotating over 4 copies of levels and output);
   k3: the backward kernel against autograd of the twin at the train path's
   shapes (b=2 at 800x1344; R=1024 at s=7, R=256 at s=14; f32 and bf16
   levels, f32 cotangent), the budget-edge boxes and R=0 included, and at
   C=72; its device time the same way (each launch first zero-fills 183 MB
   of gradient levels, which exceeds L2, so every launch finds its inputs
   cold); two runs on the same inputs (its atomics add in another order each
   time): max|run1 - run2| and the share of elements that differ, and the
   backward must raise under ``torch.use_deterministic_algorithms(True)``;
4. serve: the default Config() at full width (R50-FPN, 3-stage cascade over
   800 classes, masks, 28 sem-seg classes, bf16) with seeded weights serves 4
   requests (3 at 800x1216, 1 at 512x832, b=1); the forward kernel's launch
   count must grow by 4 per forward; then torch.profiler over warm forwards
   of each shape (device busy share, top kernels). Before it,
   ``u2seg_torch.entry.entry()`` (the flagship forward at 512x832) runs once;
5. cpu: the same forward at 512x832 in f32 (TF32 off) with
   pooler_impl="pallas" on both devices (the CPU runs the kernel's twin);
6. train: ``create_train_state`` + ``make_train_step`` at full width, b=2 at
   800x1344, 100 gt slots with 20 valid boxes and 64x64 mask patches, bf16:
   2 warm-up steps, then 4 steps with the launch counts set to 0 before them:
   finite losses with the 10 expected keys, finite non-zero gradients on the
   backbone, the RPN, each cascade stage, the mask and sem-seg heads, 4
   forward + 4 backward kernel launches per step, parameters changed; step
   time, peak memory, and torch.profiler's busy share and launches per step;
7. train_cpu: one train step of the tiny config in f32 (TF32 off) on the card
   (kernels) against the CPU (plain versions), with sampling sizes that take
   every candidate so that no random draw matters: losses, gradients and the
   updated BN statistics.

8. k4: the single-level window ROIAlign kernel (a span kernel, as K1)
   against its plain version on one level of the serving path (p3 of an
   800x1216 image: 100x152, C=256): R=1000 boxes that fit the 40 x 40 window
   plus budget-edge boxes, one over-long box, degenerate zero boxes, and R=0;
   s=7 and s=14, r=2; f32 (TF32 off, 1e-4 * max(1, max|plain|)) and bf16
   maps (rtol 0.05, atol 0.03); once more at C=72 (ragged last chunk) for
   each map type, and on bins taller than the stage buffer (boxes as large
   as the window at s=1-3: the global-memory path). Device times as for K1
   (CUDA graph, L2 warm and L2 exceeded), wrapper, plain and gather-pooler
   times, the byte bound, the shared memory the library reports against the
   wrapper's plan, and registers and spills from the ptxas log. No model
   path reaches this kernel (in the JAX package neither): its "path" is two
   calls of the public wrapper at these shapes, counted apart from the
   comparison launches;
9. k5: the two window-read probe kernels against their plain version at
   N=512 windows per shape, then ``profile_window_read.time_shapes`` (the
   probe's own path: five window shapes, N=8000) in ms and GB/s;
10. eval: ``DefaultPredictor`` at full width: 8 numpy-drawn uint8 scenes
   (480x640, 427x640, 640x480, 500x375, twice) through
   ``run_batched(batch_size=4)`` with the host render, with
   ``device_render=True`` and with ``device_resize=True`` too. Fails unless:
   (the fusion threshold, the fusion budget and the run budgets are set
   from calibration passes: seeded weights score low and unevenly and draw
   noisy semantic maps);
   4 forward-kernel launches per batch; one device-to-host copy per batch
   and no fallback on the device paths; device render == host render per
   image (semantic and panoptic maps on >= 99.9% of pixels, segment ids,
   kinds, categories and instance references equal); the device resize ==
   the host resize to 0.05 on 0..255; an image larger than the canvas takes
   the fallback and equals the host render exactly. Prints images/s, the
   stages of one batch, fetched bytes per image, launches per batch and
   peak memory;
11. eval_cpu: the tiny config in f32 through the predictor on the card
   (kernels) and on the CPU (plain versions), ``device_render=True,
   device_resize=True``: records, maps and segment tables;
12. train_loop: ``DefaultTrainer`` at full width (the default Config(), b=2
   at 800x1344, bf16) inside ``parallel.launch`` with one NCCL rank
   (``file://`` rendezvous): 6 steps from ``testing.fake_loader`` batches
   with ``build_hooks()`` + ``PreciseBN(period=4, num_iters=2)``, a
   checkpoint every 3 steps; then a second trainer ``resume_or_load``s and
   takes 2 more. Fails unless every total loss is finite, ``metrics.json``
   has a line per written iteration, the checkpoints exist and the resume
   starts at iteration 6 with the saved parameters exactly, each step
   launches K1 x4 and K3 x4 (PreciseBN's forwards 4 K1 each and no K3), and
   PreciseBN moved the running statistics. Prints IterationTimer's step time
   beside phase train's bare step, checkpoint size, save/load ms and peak
   memory;
13. ddp: two gloo ranks on the one card (spawned processes, their own CUDA
   contexts), the same config, b=1 per rank (global 2 at 800x1344), 2 steps
   of ``DefaultTrainer``: every parameter and BN buffer bit-identical on
   both ranks after each step (one checksum per tensor gathered on the
   CPU), finite losses, SyncBN statistics moved, K1/K3 4 + 4 per step on
   each rank; step time per rank;
14. ddp_cpu: ``entry.dryrun_multichip(2)``, one data-parallel step of the
   tiny config over two gloo processes on the CPU;
15. dataset_eval: the dataset evaluation path, ``run_panoptic_evaluation``
   at full width (the default Config(), bf16, seeded weights calibrated as
   in phase eval), on a synthetic COCO-format set that the phase writes into
   a temporary directory as PNG files written by Pillow (16 scenes, 480x640,
   427x640, 640x480 and 500x375, four of each, interleaved; an instances
   JSON with 2-6 boxes per image over real COCO thing ids; panoptic GT with
   stuff at cluster_num + supercategory; sem-seg GT in the contiguous-stuff
   encoding), registered in the port's catalogs. (a) A predictor that
   answers with the GT in cluster space must score bbox/AP = panoptic_seg/PQ
   = 100 (to 1e-4) and sem_seg/mIoU > 99 in ``auto`` mode; (b) the model
   through ``DefaultPredictor`` (device render and resize), as
   ``hungarian_matching`` then ``eval``, and (c) as ``auto``: (b) and (c)
   give equal metric dicts, their maps differ on at most 0.1% of pixels,
   both mapping files exist, 4 K1 launches and one device-to-host copy per
   batch, every metric finite or NaN exactly where the arithmetic gives NaN.
   Prints images/s end to end, ms per image of image decode, GT decode,
   predictor and each evaluator, peak memory;
16. dataset_eval_cpu: the tiny config in f32 through
   ``run_panoptic_evaluation`` on a 4-image set, on the card and on the CPU:
   semantic maps equal on >= 99% of pixels and panoptic maps on >= 98% (as
   in eval_cpu), summary metrics within 0.5 points;
17. train_net: training from files through ``u2seg_torch.tools.train_net.main``
   at full width (u2seg_R50_800.yaml, SyncBN on one rank, 3-stage cascade
   over 800 clusters, masks, 28 sem-seg classes, bf16; ims_per_batch 2, 4
   loader threads) on 32 files of ``testing.write_synthetic_u2seg_train``
   (480x640, 427x640, 640x480, 500x375; JPEG scenes, CutLER RLE and polygon
   instances, stuff maps), starting from ``model.weights`` (a file of the
   seeded model): 8 iterations, ``--resume`` to 10, then ``--eval-only
   --eval-mode auto`` on a 16-image synthetic val set with the last
   checkpoint as ``model.weights`` (test score threshold 0: an untrained
   model scores no class above 0.05; render budgets calibrated on the
   checkpoint first). Prints the loader alone (images/s at 0 and 4
   threads), the mapper's ms per image by stage on one thread, the step
   time from IterationTimer against phase train's bare step, the trainer's
   wait for data per step (``next()`` timed from outside the trainer), K1/K3
   launches per step, peak memory and the eval-only images/s. Fails unless
   the losses are finite, every step launches K1 x4 and K3 x4, the resumed
   run starts at iteration 8, the eval-only predictor holds the checkpoint's
   tensors (and not the seeded ones), two loaders of one seed give identical
   first 4 batches, and every mask patch lies in [0, 1] and every box inside
   its image;
18. train_net_cpu: ``train_net.main`` of the tiny config in f32 (TF32 off),
   2 steps from the same files on the card and with ``--device cpu``: equal
   loader batches, losses within rtol 1e-3 (phase train_cpu's tolerance);
19. pseudo: the pseudo-label pipeline through
   ``u2seg_torch.tools.generate_pseudo_labels.main`` (stages cluster, assign,
   panoptic, stuff, then supergt) on a synthetic set the phase writes into a
   temporary directory (``testing.write_synthetic_pseudo_inputs``: 256 scenes
   at the eval sizes with 8 CutLER-style RLE instances each, 2048 masked
   crops, 27-label STEGO maps, a GT panoptic JSON), ViT-B/16 (dim 768, depth
   12, 12 heads) from a seeded DINO state dict in the official names written
   as ``.pth`` and loaded through ``--dino-weights``, crop 224, batch 64,
   facet k, 800 clusters, k 20, 100 iterations, ``--select-json`` on. Fails
   unless the features are finite, the decode JSON has every crop with ids in
   [0, 800), the class-aware JSON keeps exactly the decoded keys, every
   panoptic PNG reads back equal to its map, the semantic PNGs hold only
   {0..27, 255}, and the supergt JSON maps every GT stuff category to one of
   the 15 ids 801..815 and keeps the thing categories. Then the clustering
   alone at N = 131072 features of D = 768 around 800 seeded centres: kNN
   (k 20), k-means++ and 100 Lloyd steps (K 800, cosine) twice from one
   generator seed, and the regularised selection: purity > 0.9, equal
   assignments. Prints stage 1's crops/s with the host's read + resize per
   crop, DINO's device ms per batch of 64, the kNN, seeding, Lloyd and
   selection seconds at N = 131072 beside their f32 bounds, assembly ms per
   image, peak memory. No hand kernel lies on this path (the JAX package's
   is XLA too);
20. pseudo_cpu: card against CPU in f32 (TF32 off): ViT-B/16 patch features
   of 16 crops (relative L2 <= 1e-4), kNN indices at N = 8192 (>= 99.9%
   equal), Lloyd from the same k-means++ centroids (assignments equal), and
   stages 2-5 with ``--device cuda`` and ``--device cpu`` from one decode
   JSON (every file equal byte for byte);
21. zoo: the detector families through ``model_zoo.get`` at full width (bf16,
   seeded weights, numpy-drawn scenes, the test score thresholds set to 0:
   seeded heads score below 0.05), b=2 at 800x1344: Mask R-CNN R50-FPN 1x,
   Keypoint R-CNN, RetinaNet, FCOS, and the RegNetX-4GF and Swin-T Mask
   R-CNNs (forward, then one loss + backward on 20 drawn boxes with 64x64
   mask patches and 17 keypoints each), Cascade Mask R-CNN and the GN Mask
   R-CNN with its 4conv1fc box head (forward); the ViTDet Mask R-CNN at b=2,
   1024x1024 (its pad bucket) and the R50 3x file over an MViT trunk at b=1,
   512x832 (forward, loss + backward). Prints ms per forward (synchronised,
   median of 5 after 3 warm ones), peak memory, a torch.profiler view of 2
   forwards (device busy share, launches, top kernels) and the device time
   of the trunk's attention; then every other zoo YAML, one b=1 forward at
   512x832. Fails unless the outputs are finite, every full-width forward
   keeps detections, every head's gradient is finite and non-zero, K1
   launches once per ROI pool of every forward (Mask R-CNN 2, Keypoint
   R-CNN 2, Cascade 4, the dense detectors 0) and K1 + K3 once per pool of
   every loss + backward (2 + 2), and all 31 zoo files build;
22. zoo_cpu: the six meta-architectures at a tiny config in f32 (TF32 off)
   on the card (kernels) and on the CPU (plain versions): the ROI heads,
   dense heads, RPN and sem-seg head on the CPU trunk's features, and one
   train forward's losses; Mask R-CNN over tiny ViTDet, Swin, MViT and
   RegNet trunks also compares the trunks' pyramids (see ``phase_zoo_cpu``
   for the tolerances);
23. augment: ``train_net.main`` on u2seg_R50_800.yaml with
   ``input.rotation_enabled=True`` (RandomRotation through the OpenCV-free
   warp of ``data/warp.py``), ims_per_batch 2, 4 loader threads, over the
   synthetic files of phase train_net, 4 steps: finite losses and 4 K1 + 4
   K3 launches per step. Prints the mapper's ms per image with and without
   rotation, the step time, the loader's wait, and ``RandomExtent`` on the
   same images (shapes and labels checked);
24. semisup: FixMatch on the port's DINO ViT-B/16 (f32, 224x224) with a
   linear head over 800 clusters: 8 labeled + 56 weak + 56 strong images per
   step (mu 7, one concatenated forward), the strong views from
   ``randaugment_mc`` on the host; 4 steps with the EMA, then 2 fine-tune
   steps with the trunk frozen (the trunk must be unchanged). Prints step
   ms, RandAugment ms per image and peak memory;
25. rotated: ``multilevel_roi_align_rotated`` on p2-p5 of an 800x1216 image
   (C=256, f32, R=1000, s=7) against the CPU at 1e-4 x max, ``nms_rotated``
   over 1000 f64 boxes exactly against the CPU, ``RotatedCOCOEvaluator`` on
   the ground truth given as predictions (AP 100); ms of each;
26. projects: ``ModulatedDeformConv`` 3x3 at res3 of an 800x1344 image (b=2,
   128 channels, 100x168) forward and backward, equal to ``F.conv2d`` at
   1e-4 with zero offsets and unit masks; DeepLabV3+ and Panoptic-DeepLab
   heads over the port's R50 trunk at b=2, 512x1024, 19 classes (forward,
   loss, backward, grouping and fusion, ids in range); Mask R-CNN with BN
   heads (``mask_rcnn_bn_head``, b=2 at 800x1344): one train step (2 K1 + 2
   K3), then an eval forward of its weights under ``BNBatchStats`` (2 K1);
   ShuffleBN over 2 gloo ranks on the card (each rank gets its own rows
   back);
27. projects_cpu: tiny configs of each new module on the card against the
   CPU (f32, TF32 off, 1e-4 x max; grouping and fusion exact);
28. projects2: the last project modules at full width, b=2 at 800x1344,
   seeded weights, each timed (median of 3 after a warm-up) with its peak
   memory: TensorMask at its published settings over the R50-FPN p2-p7
   (inference with 6000 candidates, NMS 0.5, 100 detections; loss +
   backward on 20 of 100 GT slots with 64x64 patches; SwapAlign2Nat at p7
   and its peak memory); over the zoo's Mask R-CNN R50-FPN 3x (bf16, 2 K1
   per forward): the DensePose chart heads over its 100 detections per
   image (IUV, 10 quantised), their losses plain and ``indep_aniso`` on 32
   foreground ROIs per image, the CSE heads (smpl_27554, pix2shape) loss +
   backward and nearest vertices on 10 ROIs, PointRend's subdivision, a
   training forward whose mask loss is PointSup's plus PointRend's point
   loss (2 K1 + 2 K3); a trident res4 stage of R50 forward + backward with
   the shared kernels' gradients against the sums of the branches' parts;
29. projects2_cpu: tiny configs of those modules on the card against the
   CPU (f32, TF32 off, 1e-4 x max; kept detections, IUV labels and nearest
   vertices exact);
30. demo: ``VisualizationDemo.run_on_image`` (the default Config() at full
   width, seeded calibrated weights, fusion threshold 0.05, a Hungarian
   instance mapping the phase writes) on four eval scenes (480x640,
   427x640, 640x480, 500x375): ms per image of predict, draw (the OpenCV-free
   visualizer) and write (Pillow JPEG), K1 launches per image (4); each
   drawing equals a visualizer's over the same fetched predictions; then
   ``u2seg_demo.main`` on one PNG file with ``--confidence-threshold 0.05``;
31. export: ``export_inference`` of that model at b=1, 800x1216 on the card
   (``torch.export``, K1 a registered op: 4 nodes), loaded in a fresh
   process that imports ``u2seg_torch.engine.export`` and no model code:
   export, save and load seconds, artifact MB, eager and loaded forward ms,
   4 K1 launches per loaded call, loaded outputs against the eager
   forward's (bit-equal, or the stated tolerance);
32. analyze: ``tools/analyze_model`` on the default Config() at 800x1344:
   parameters, GFLOPs per op kind, GB, seconds, 4 K1 launches;
33. tools_cpu: the tiny config in f32 (TF32 off, K1 on the card) exported
   and loaded on the card and on the CPU, and the demo on one image, card
   against CPU at ``eval_cpu``'s tolerances.

34. matcher (after dataset_eval_cpu): the host C++ of ``u2seg_torch/_native``
   built with g++ on the card's host (build seconds), then COCOeval on 64
   images at the eval scene sizes with 100 detections per image (4-12 GT
   over 8 categories, crowd GT, ellipse masks as RLE, boxes) through the C++
   functions and through their numpy twins (``PlainCOCOeval``): IoU
   matrices within 1e-12, dtm / gtm / dtIg equal, the 12 stats equal, for
   segm and bbox; the C++ encode / decode / area / merge equal the numpy
   codec. Prints ``evaluate()`` ms per image of both paths and
   dataset_eval's COCOeval ms (C++ path);
35. overfit (after train_cpu): K1 and K3 against their plain versions at the
   tiny config's shapes (levels 16x16 .. 2x2, smaller than a span); then
   ``u2seg_torch/dev/run_overfit.py`` on the card (the tiny config, lr 0.08,
   150 steps on one fixed batch: the JAX script's assertions, 4 K1 + 4 K3
   per step), and the default Config() at full width, 50 steps at lr 0.02
   on one fixed b=2 800x1344 batch (finite, last-5 mean below first-5 mean,
   4 + 4 launches per step). Prints both curves' first-5 / last-5 means, ms
   per step, peak memory and the launches.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. With no CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# device ms from a CUDA graph; the card's name and power limit
from u2seg_torch.dev.sweep_forward_plan import graph_ms, smi_line  # noqa: E402
from u2seg_torch.testing import scene  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Calibration of the random cls_score heads, as bench.py does it: scale each
# stage's cls_score weight and bias by TAU so the 801-way softmax is neither
# saturated (TAU=1: every stage one-hot on another class, averaged scores
# stuck at 1/3) nor flat. bench.py's TAU=0.12 was tuned on the JAX package's
# init; the port's seeded init draws other numbers, and at 0.12 no averaged
# score reaches the 0.05 test threshold. The port's own value is 0.3; phase
# 4 prints the score spread at both values.
BENCH_CLS_WEIGHT_TAU = 0.12
CLS_WEIGHT_TAU = 0.3
AMP_RTOL, AMP_ATOL = 0.05, 0.03
F32_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


NARROW_C = 72            # 64 + 8: the last chunk of channels is ragged
ROTATION = 4             # copies of levels and outputs that exceed L2 together


def narrow_boxes(rng, h: int, w: int, n: int = 120) -> torch.Tensor:
    """Boundary boxes, two boxes of thousands of pixels (on small levels the
    true dims clip their taps), one wholly outside the image (no weight at
    all), and random proposals."""
    extra = torch.tensor([[0.0, 0.0, 9000.0, 8000.0], [3.0, 2.0, 40.0, 30000.0],
                          [w + 50.0, h + 60.0, w + 90.0, h + 100.0]])
    return torch.cat([boundary_boxes(h, w), extra, random_proposals(rng, n, h, w)])


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def boundary_boxes(h: int, w: int) -> torch.Tensor:
    """Boxes that stress each routing branch; the budget-edge cases sit at
    the top real level (stride 32: SPAN_BUDGET=28 cells = 896 px)."""
    return torch.tensor([
        [10.0, 20.0, 122.0, 132.0],        # sqrt-area exactly 112
        [30.0, 5.0, 254.0, 229.0],         # exactly 224
        [0.0, 0.0, 448.0, 448.0],          # exactly 448
        [5.0, 10.0, 345.0, 30.0],          # long side -> window-fit bump
        [40.0, 2.0, 60.0, 220.0],          # tall thin -> bump
        [16.0, 20.0, 912.0, 916.0],        # exactly at budget on p5
        [5.0, 3.0, 955.0, 953.0],          # over budget on p5 -> virtual level
        [0.0, 0.0, 2000.0, 1900.0],        # over budget on the virtual level
        [50.0, 50.0, 50.0, 50.0],          # zero size
        [0.0, 0.0, 0.0, 0.0],              # zero box
        [w - 160.0, h - 110.0, w + 40.0, h + 20.0],   # past the image corner
        [12.5, 7.25, 44.75, 39.5],         # small, fractional
    ])


def random_proposals(rng, n: int, h: int, w: int) -> torch.Tensor:
    cx, cy = rng.rand(n) * w, rng.rand(n) * h
    bw = np.exp(rng.uniform(np.log(8), np.log(800), n))
    bh = bw * np.exp(rng.uniform(-1.2, 1.2, n))
    b = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return torch.from_numpy(b.astype(np.float32))


def work_of(rap, feats, boxes, bidx, s, strides, in_bytes, out_bytes):
    """Bytes (touched level cells read once, output written once, ROI inputs)
    and flops (2 per nonzero tap weight pair, per channel) this run needs."""
    ext, st = rap._append_virtual_level(feats, strides)
    dims = tuple((f.shape[1], f.shape[2]) for f in ext)
    wy, wx, idx, prep, _ = rap._ml_geometry(boxes, bidx, dims, st, s, 2, 224.0, 4)
    c = feats[0].shape[-1]
    touched = (wy != 0).any(1)[:, :, None] & (wx != 0).any(1)[:, None, :]
    cells = torch.unique(idx[touched]).numel()
    r_n = boxes.shape[0]
    nbytes = cells * c * in_bytes + r_n * s * s * c * out_bytes + r_n * 20
    ny = (wy != 0).sum(-1).reshape(r_n, s, 2).sum(-1).float()
    nx = (wx != 0).sum(-1).reshape(r_n, s, 2).sum(-1).float()
    flops = float((ny[:, :, None] * nx[:, None, :]).sum()) * 2 * c
    return nbytes, flops


def span_stats(rap, feats, boxes, s, strides):
    """What the span kernels touch: cells in all ROIs' spans (each block
    reads or writes its own span), the mean span, and the cells some bin
    touches on both axes (one vector atomic per 4 channels in the backward)."""
    ext, st = rap._append_virtual_level(feats, strides)
    dims = tuple((f.shape[1], f.shape[2]) for f in ext)
    wy, wx, _ = rap.dense_axis_weights(boxes, dims, st, s, 2)
    sp = rap.roi_spans(wy, wx)
    rows = (sp[:, 1] - sp[:, 0] + 1).clamp(min=0)
    cols = (sp[:, 3] - sp[:, 2] + 1).clamp(min=0)
    touched = ((wy != 0).any(1).sum(-1) * (wx != 0).any(1).sum(-1))
    return dict(span_cells=int((rows * cols).sum()), mean_rows=float(rows.float().mean()),
                mean_cols=float(cols.float().mean()), max_rows=int(rows.max()),
                max_cols=int(cols.max()), touched_cells=int(touched.sum()))


TALL_HW, TALL_C = (4096, 5120), 8     # virtual level 64 x 80: larger than the window


def tall_bins_case(dev):
    """Boxes far over the routing budget on a virtual level larger than the
    32 x 40 window: their samples past the window collapse onto its edge cell
    and, at s=2, one bin spans 17 rows of a 40-cell span, more than any stage
    buffer holds (the forward kernel's global-memory path)."""
    (h, w), strides = TALL_HW, (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(9)
    feats = [torch.randn(1, h // st, w // st, TALL_C, generator=gen, device=dev)
             for st in strides]
    boxes = torch.tensor([[0.0, 0.0, w, h], [100.0, 50.0, 5000.0, 4000.0],
                          [0.0, 0.0, 2560.0, h], [0.0, 0.0, w, 300.0],
                          [2000.0, 1000.0, 2100.0, 1090.0]], device=dev)
    bidx = torch.zeros(len(boxes), dtype=torch.int32, device=dev)
    return feats, boxes, bidx, strides


def tall_bins_forward_check(rap, dev):
    feats, boxes, bidx, strides = tall_bins_case(dev)
    worst = 0.0
    for s in (2, 7, 14):
        ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, strides)
        got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, strides)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        if err > F32_TOL * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"kernel disagrees with its plain version on bins "
                                 f"taller than the stage buffer: s={s}, max|diff| {err:.3e}")
    log(f"[kernel] {TALL_HW[0]}x{TALL_HW[1]} image, C={TALL_C}, boxes far over the budget "
        f"(window clip, bins taller than the stage buffer), s=2/7/14, f32: "
        f"max|kernel-plain| {worst:.3e} ok")
    return worst


def narrow_forward_check(rap, dev):
    """The forward kernel at C=72 on small levels (p5 is 7 x 11, narrower than
    the window), every dtype pair, s=7 and s=14."""
    h, w, strides = 224, 352, (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(7)
    base = [torch.randn(2, h // st, w // st, NARROW_C, generator=gen, device=dev)
            for st in strides]
    rng = np.random.RandomState(7)
    boxes = narrow_boxes(rng, h, w).to(dev)
    bidx = torch.from_numpy(rng.randint(0, 2, len(boxes)).astype(np.int32)).to(dev)
    worst = {"f32": 0.0, "bf16": 0.0}
    for s in (7, 14):
        for din in (torch.float32, torch.bfloat16):
            feats = [f.to(din) for f in base]
            ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, strides)
            scale = max(1.0, float(ref.abs().max()))
            for dout in (torch.float32, torch.bfloat16):
                got = rap.multilevel_roi_align_kernel(
                    feats, boxes, bidx, s, strides, out_dtype=dout).float()
                torch.cuda.synchronize()
                err = (got - ref).abs()
                if din == dout == torch.float32:
                    ok = bool((err <= F32_TOL * scale).all())
                    worst["f32"] = max(worst["f32"], float(err.max()))
                else:
                    ok = bool((err <= AMP_ATOL + AMP_RTOL * ref.abs()).all())
                    worst["bf16"] = max(worst["bf16"], float(err.max()))
                if not ok:
                    raise AssertionError(
                        f"kernel disagrees with its plain version at C={NARROW_C}: "
                        f"s={s} {din}->{dout}, max|diff| {float(err.max()):.3e}")
    log(f"[kernel] C={NARROW_C} (ragged last chunk), levels 56x88..7x11, {len(boxes)} boxes "
        f"incl. a box with no weight, s=7/14, 4 dtype pairs: max|kernel-plain| f32 "
        f"{worst['f32']:.3e} (tol {F32_TOL:g} * max(1, max|plain|)), with bf16 "
        f"{worst['bf16']:.3e} (atol {AMP_ATOL} + rtol {AMP_RTOL}) ok")
    return worst


def phase_kernel(dev):
    from u2seg_torch.ops import roi_align_ml as rap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w, c = 800, 1216, 256
    strides = (4, 8, 16, 32)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    base = [torch.randn(1, h // st, w // st, c, generator=g, device=dev)
            for st in strides]
    results = {}
    for s, n in ((7, 1000), (14, 100)):
        edge = boundary_boxes(h, w)
        boxes = torch.cat([edge, random_proposals(rng, n - len(edge), h, w)]).to(dev)
        bidx = torch.zeros(n, dtype=torch.int32, device=dev)
        rec = {"s": s, "R": n}
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in base]
            got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, strides,
                                                  out_dtype=dtype)
            ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, strides)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            scale = float(ref.abs().max())
            name = "f32" if dtype == torch.float32 else "bf16"
            rec[f"max_abs_err_{name}"] = float(err.max())
            rec[f"ref_max_{name}"] = scale
            rec[f"edge_err_{name}"] = float(err[:len(edge)].max())
            if dtype == torch.float32:
                ok = bool((err <= F32_TOL * max(scale, 1.0)).all())
                tol = f"{F32_TOL:g} * max(1, max|ref|)"
            else:
                ok = bool((err <= AMP_ATOL + AMP_RTOL * ref.abs()).all())
                tol = f"atol {AMP_ATOL} + rtol {AMP_RTOL}"
            log(f"[kernel] s={s} R={n} {name}: max|kernel-plain|={rec[f'max_abs_err_{name}']:.3e} "
                f"(budget-edge boxes {rec[f'edge_err_{name}']:.3e}, max|plain|={scale:.3f}, "
                f"tol {tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version ({name}, s={s})")
        # timing at the main path's dtype (bf16 levels -> bf16 pooled)
        sets = [[f.to(torch.bfloat16) for f in base] for _ in range(ROTATION)]
        feats = sets[0]
        args = [rap.prepare_launch(fs, boxes, bidx, s, 2, strides, 224.0, 4,
                                   torch.bfloat16) for fs in sets]
        out = rap.launch(args[0])
        threads, stage_bytes = rap.forward_plan(s)
        shared = rap.forward_shared_bytes(s, stage_bytes)
        if rap.kernel_shared_bytes(False, s) != shared:
            raise AssertionError("the library and the wrapper disagree on shared memory")
        fns = [lambda a=a: rap.launch(a) for a in args]
        rec["ms"] = graph_ms(fns[:1], iters=48)
        rec["cold_ms"] = graph_ms(fns, iters=48)
        rec["enqueue_ms"] = cuda_ms(fns[0], iters=200)
        rot_mb = ROTATION * (sum(f.numel() for f in feats) + out.numel()) * 2 / 1e6
        del args[1:], sets[1:], fns
        rec["wrapper_ms"] = cuda_ms(lambda: rap.multilevel_roi_align_kernel(
            feats, boxes, bidx, s, strides, out_dtype=torch.bfloat16), iters=20)
        rec["plain_ms"] = cuda_ms(lambda: rap.multilevel_roi_align_ref(
            feats, boxes, bidx, s, strides), iters=3, warmup=1)
        nbytes, flops = work_of(rap, feats, boxes, bidx, s, strides, 2, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   chunk=rap.CHUNK, threads=threads, shared_bytes=shared,
                   spans=span_stats(rap, feats, boxes, s, strides))
        sp = rec["spans"]
        log(f"[kernel] s={s} R={n} bf16 device time (48 launches in one CUDA graph, no "
            f"host code between them): {rec['ms']:.4f} ms with L2 warm (one launch "
            f"repeated; chunk {rap.CHUNK}, {threads} threads, {shared} B shared), "
            f"{rec['cold_ms']:.4f} ms with L2 exceeded (rotating over {ROTATION} copies of "
            f"levels and output, {rot_mb:.0f} MB); launched back to back through the "
            f"Python wrapper {rec['enqueue_ms']:.4f} ms per launch (the host's enqueue "
            f"rate where above the device time); wrapper (prep+kernel) "
            f"{rec['wrapper_ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> {rec['ms'] / rec['bound_ms']:.1f}x "
            f"its bound; spans: {sp['span_cells']} cells = "
            f"{sp['span_cells'] * c * 2 / 1e6:.1f} MB read by the blocks, mean "
            f"{sp['mean_rows']:.1f} x {sp['mean_cols']:.1f}, largest {sp['max_rows']} x "
            f"{sp['max_cols']}; library call: none (no single PyTorch op "
            f"computes this pooler; torchvision is not installed)")
        del args, sets
        results[s] = rec
    results["narrow"] = narrow_forward_check(rap, dev)
    results["tall_bins"] = tall_bins_forward_check(rap, dev)
    return results


# ---------------------------------------------------------------------------
# Phase 3b: the backward kernel against autograd of the plain version
# ---------------------------------------------------------------------------

TRAIN_HW = (800, 1344)       # the training bucket, per-device batch 2


def narrow_backward_check(rap, dev):
    """The backward kernel at C=72 on small levels, f32, s=7 and s=14, against
    autograd of the twin."""
    h, w, strides = 224, 352, (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(8)
    base = [torch.randn(2, h // st, w // st, NARROW_C, generator=gen, device=dev)
            for st in strides]
    rng = np.random.RandomState(8)
    boxes = narrow_boxes(rng, h, w).to(dev)
    bidx = torch.from_numpy(rng.randint(0, 2, len(boxes)).astype(np.int32)).to(dev)
    worst = 0.0
    for s in (7, 14):
        g = torch.randn(len(boxes), s, s, NARROW_C, generator=gen, device=dev)
        ext, st_ext = rap._append_virtual_level(base, strides)
        ext = [f.clone().requires_grad_() for f in ext]      # each level a leaf
        ref = torch.autograd.grad(
            rap._ref_ext(ext, boxes, bidx, s, st_ext, 2, 224.0, 4), ext, g)
        fa = rap._prepare_ext([f.detach() for f in ext], boxes, bidx, s, 2, st_ext,
                              224.0, 4, torch.float32)
        got = rap.multilevel_roi_align_backward(rap.prepare_backward(
            g, fa.roi_i, fa.roi_f, [tuple(f.shape) for f in ext], s, 2))
        torch.cuda.synchronize()
        for lvl, (a, b_) in enumerate(zip(got, ref)):
            err = float((a - b_).abs().max())
            worst = max(worst, err)
            if err > F32_TOL * max(1.0, float(b_.abs().max())):
                raise AssertionError(
                    f"K3 disagrees with its plain version at C={NARROW_C}: s={s} "
                    f"level {lvl}, max|diff| {err:.3e}")
    feats, tboxes, tbidx, _ = tall_bins_case(dev)
    ext, st_ext = rap._append_virtual_level(feats, strides)
    for s in (2, 7):
        g = torch.randn(len(tboxes), s, s, TALL_C, generator=gen, device=dev)
        leaves = [f.clone().requires_grad_() for f in ext]
        ref = torch.autograd.grad(
            rap._ref_ext(leaves, tboxes, tbidx, s, st_ext, 2, 224.0, 4), leaves, g)
        fa = rap._prepare_ext(ext, tboxes, tbidx, s, 2, st_ext, 224.0, 4, torch.float32)
        got = rap.multilevel_roi_align_backward(rap.prepare_backward(
            g, fa.roi_i, fa.roi_f, [tuple(f.shape) for f in ext], s, 2))
        torch.cuda.synchronize()
        for a, b_ in zip(got, ref):
            err = float((a - b_).abs().max())
            worst = max(worst, err)
            if err > F32_TOL * max(1.0, float(b_.abs().max())):
                raise AssertionError(f"K3 disagrees with its plain version on boxes far "
                                     f"over the budget: s={s}, max|diff| {err:.3e}")
    log(f"[k3] C={NARROW_C} (ragged last chunk), levels 56x88..7x11 + virtual, {len(boxes)} "
        f"boxes, s=7/14, f32, and the "
        f"{TALL_HW[0]}x{TALL_HW[1]} over-budget boxes at s=2/7: max|kernel-plain| "
        f"{worst:.3e} (tol {F32_TOL:g} * max(1, max|plain grad|)) ok")
    return worst


def phase_kernel_backward(dev):
    """K3 at the train step's shapes: b=2 at 800x1344, p2-p5 (+ the virtual
    level), C=256; R=1024 at s=7 (one cascade stage: 2 x 512 samples) and
    R=256 at s=14 (the mask branch: 2 x 128 foreground slots). The plain
    version is autograd of ``multilevel_roi_align_ref`` on the card.

    Tolerances. f32 levels (TF32 off): 1e-4 * max(1, max|plain grad|) -- the
    kernel sums with atomics, whose order changes from run to run, the plain
    version with index_put. bf16 levels: both accumulate in f32 and round
    once to bf16, so they differ by a bf16 rounding of nearly equal sums:
    rtol 0.05, atol 0.03 * max(1, max|plain grad|) / 8."""
    from u2seg_torch.ops import roi_align_ml as rap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (h, w), c, b = TRAIN_HW, 256, 2
    strides = (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.RandomState(3)
    base = [torch.randn(b, h // st, w // st, c, generator=gen, device=dev)
            for st in strides]
    results = {}
    for s, n in ((7, 1024), (14, 256)):
        edge = boundary_boxes(h, w)
        boxes = torch.cat([edge, random_proposals(rng, n - len(edge), h, w)]).to(dev)
        bidx = torch.from_numpy(rng.randint(0, b, n).astype(np.int32)).to(dev)
        g = torch.randn(n, s, s, c, generator=gen, device=dev)
        rec = {"s": s, "R": n}
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            feats_k = [f.to(dtype).clone().requires_grad_() for f in base]
            feats_p = [f.to(dtype).clone().requires_grad_() for f in base]
            before = rap.multilevel_roi_align_backward.launches
            out_k = rap.multilevel_roi_align_train(feats_k, boxes, bidx, s, strides)
            got = torch.autograd.grad(out_k, feats_k, g)
            if rap.multilevel_roi_align_backward.launches != before + 1:
                raise AssertionError("the train pooler's backward did not launch K3")
            out_p = rap.multilevel_roi_align_ref(feats_p, boxes, bidx, s, strides)
            ref = torch.autograd.grad(out_p, feats_p, g)
            torch.cuda.synchronize()
            fwd_err = float((out_k - out_p).detach().abs().max())
            errs, scales, ok = [], [], out_k.dtype == torch.float32
            for gk, gp in zip(got, ref):
                ok = ok and gk.dtype == dtype and gk.shape == gp.shape
                err = (gk.float() - gp.float()).abs()
                scale = max(1.0, float(gp.float().abs().max()))
                errs.append(float(err.max()))
                scales.append(scale)
                if dtype == torch.float32:
                    ok = ok and bool((err <= F32_TOL * scale).all())
                else:
                    ok = ok and bool((err <= AMP_ATOL * scale / 8
                                      + AMP_RTOL * gp.float().abs()).all())
            rec[f"max_abs_err_{name}"] = max(errs)
            rec[f"grad_max_{name}"] = max(scales)
            rec[f"level_err_{name}"] = errs
            log(f"[k3] s={s} R={n} {name}: max|kernel-plain| per level p2..p5 "
                f"{', '.join(f'{e:.2e}' for e in errs)} (max|plain grad| {max(scales):.2f}; "
                f"forward {fwd_err:.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version ({name}, s={s})")
        # R = 0: nothing to add, zero gradients of the right shapes
        feats0 = [f.clone().requires_grad_() for f in base]
        out0 = rap.multilevel_roi_align_train(
            feats0, boxes[:0], bidx[:0], s, strides)
        g0 = torch.autograd.grad(out0, feats0, g[:0])
        if out0.shape != (0, s, s, c) or any(float(t.abs().max()) != 0 for t in g0):
            raise AssertionError("K3 with R=0 did not give zero gradients")
        # timing at the train path's dtypes: bf16 levels, f32 cotangent
        feats = [f.to(torch.bfloat16) for f in base]
        ext, st_ext = rap._append_virtual_level(feats, strides)
        fa = rap._prepare_ext(ext, boxes, bidx, s, 2, st_ext, 224.0, 4, torch.float32)
        shapes = [tuple(f.shape) for f in ext]
        ba = rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, s, 2)
        shared = rap.backward_shared_bytes(s)
        if rap.kernel_shared_bytes(True, s) != shared:
            raise AssertionError("the library and the wrapper disagree on shared memory")
        rec["ms"] = graph_ms([lambda: rap.multilevel_roi_align_backward(ba)], iters=10)
        rec["fill_ms"] = graph_ms([lambda: [t.zero_() for t in ba.grads]], iters=10)
        rec["fwd_ms"] = cuda_ms(lambda: rap.launch(fa), iters=20)
        feats_p = [f.requires_grad_() for f in feats]
        out_p = rap.multilevel_roi_align_ref(feats_p, boxes, bidx, s, strides)
        rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out_p, feats_p, g, retain_graph=True), iters=3, warmup=1)
        del out_p
        _, flops = work_of(rap, feats, boxes, bidx, s, strides, 2, 4)
        nbytes = (g.numel() * 4 + n * 32
                  + sum(t.numel() for t in ba.grads) * 4)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   chunk=rap.CHUNK, threads=256, shared_bytes=shared,
                   spans=span_stats(rap, feats, boxes, s, strides))
        sp = rec["spans"]
        log(f"[k3] s={s} R={n} timing (bf16 levels, f32 cotangent; zero-fill of "
            f"{sum(t.numel() for t in ba.grads) * 4 / 1e6:.0f} MB + kernel, so every launch "
            f"finds L2 exceeded; device time of 10 launches in one CUDA graph): "
            f"{rec['ms']:.4f} ms (chunk {rap.CHUNK}, 256 threads, "
            f"{shared} B shared); the zero-fill alone (torch zero_) {rec['fill_ms']:.4f} ms; "
            f"plain (autograd of the twin) {rec['plain_ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB = "
            f"cotangent read once + every f32 gradient cell written once, "
            f"{flops / 1e9:.2f} GFLOP) -> {rec['ms'] / rec['bound_ms']:.1f}x its bound; "
            f"16-byte atomics {sp['touched_cells'] * c // 4}; forward kernel at these shapes (f32 out) "
            f"{rec['fwd_ms']:.4f} ms; library call: none (no single PyTorch op "
            f"computes the window transpose and its scatter)")
        rec["repeat"] = k3_repeatability(rap, ba, feats, boxes, bidx, g, s, strides)
        results[s] = rec
    results["narrow"] = narrow_backward_check(rap, dev)
    return results


def k3_repeatability(rap, ba, feats, boxes, bidx, g, s, strides):
    """K3 adds with atomics whose order changes from run to run: two runs on
    the same inputs (bf16 levels, f32 cotangent: the train path's types), its
    f32 level gradients and the bf16 gradients the model receives. Then the
    backward under torch's deterministic mode must raise."""
    runs = []
    for _ in range(2):
        runs.append([t.clone() for t in rap.multilevel_roi_align_backward(ba)])
    leaves = [f.detach().clone().requires_grad_() for f in feats]
    out = rap.multilevel_roi_align_train(leaves, boxes, bidx, s, strides)
    bf = [torch.autograd.grad(out, leaves, g, retain_graph=True) for _ in range(2)]
    torch.cuda.synchronize()

    def diff(a_list, b_list):
        d = [(a.float() - b.float()).abs() for a, b in zip(a_list, b_list)]
        n = sum(t.numel() for t in d)
        return dict(max_abs=max(float(t.max()) for t in d),
                    share=sum(int((t != 0).sum()) for t in d) / n,
                    grad_max=max(float(a.float().abs().max()) for a in a_list))

    rec = dict(f32=diff(*runs), bf16=diff(*bf))
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.autograd.grad(out, leaves, g)
        raised = False
    except RuntimeError as e:
        raised = "deterministic" in str(e)
    finally:
        torch.use_deterministic_algorithms(before)
    f, b = rec["f32"], rec["bf16"]
    ok = raised and f["max_abs"] <= F32_TOL * max(1.0, f["grad_max"])
    log(f"[k3] s={s} R={boxes.shape[0]} two runs on the same inputs: f32 level gradients "
        f"max|run1-run2| {f['max_abs']:.3e} (max|grad| {f['grad_max']:.2f}), "
        f"{f['share']:.3%} of elements differ; bf16 gradients max|run1-run2| "
        f"{b['max_abs']:.3e}, {b['share']:.4%} differ; under "
        f"torch.use_deterministic_algorithms(True) the backward raises: {raised} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K3 repeatability or its deterministic-mode check failed: {rec}")
    rec["raises"] = raised
    return rec


# ---------------------------------------------------------------------------
# Phase 4 / 5: the slice
# ---------------------------------------------------------------------------

def calibrate(model, tau: float = CLS_WEIGHT_TAU):
    with torch.no_grad():
        for m in model.roi_heads.box_predictor:
            m.cls_score.weight.mul_(tau)
            m.cls_score.bias.mul_(tau)
    return model


def score_spread(model, img, sz, tau: float) -> str:
    """Quantiles of each proposal's best averaged class score, and how many
    (proposal, class) pairs pass the test threshold, at calibration ``tau``."""
    sd = {k: v.clone() for k, v in model.roi_heads.state_dict().items()}
    with torch.no_grad():
        for m in model.roi_heads.box_predictor:
            m.cls_score.weight.mul_(tau / CLS_WEIGHT_TAU)
            m.cls_score.bias.mul_(tau / CLS_WEIGHT_TAU)
        f = model.features(img)
        props = model.proposal_generator(f, sz).proposal_boxes
        _, probs = model.roi_heads.forward_box(f, props, sz)
    model.roi_heads.load_state_dict(sd)
    best = probs[..., :-1].amax(-1).float().flatten()
    q = best.quantile(torch.tensor([0.05, 0.5, 0.95], device=best.device)).tolist()
    above = int((probs[..., :-1] > model.cfg.roi_heads.score_thresh_test).sum())
    return (f"TAU={tau}: best averaged class score q05/q50/q95 "
            f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}, pairs above "
            f"{model.cfg.roi_heads.score_thresh_test} {above}")


def phase_entry():
    from u2seg_torch.entry import entry

    forward, args = entry()
    boxes, scores, panoptic = forward(*args)
    torch.cuda.synchronize()
    ok = (boxes.shape == (1, 100, 4) and scores.shape == (1, 100)
          and panoptic.shape == (1, 128, 208) and bool(torch.isfinite(boxes).all()))
    log(f"[slice] entry(): boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}, "
        f"panoptic {tuple(panoptic.shape)} on {boxes.device} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("entry() returned unexpected outputs")


def phase_slice(dev):
    from u2seg_torch.config import Config
    from u2seg_torch.models.build import build_model
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k

    phase_entry()
    cfg = Config()
    model = calibrate(build_model(cfg, device=dev, seed=0))
    rng = np.random.RandomState(1)
    shapes = [(800, 1216)] * 3 + [(512, 832)]
    reqs = []
    for h, w in shapes:
        img = torch.from_numpy(scene(rng, h, w))[None].to(dev)
        reqs.append((img, torch.tensor([[h, w]], dtype=torch.int32, device=dev)))
    for h, w in sorted(set(shapes)):                      # warm-up per shape
        img, sz = next(r for r in reqs if r[0].shape[1:3] == (h, w))
        model(img, sz, combine=True)
    for tau in (BENCH_CLS_WEIGHT_TAU, CLS_WEIGHT_TAU):
        log(f"[slice] calibration on request 0, {score_spread(model, *reqs[0], tau)}")
    torch.cuda.synchronize()

    k.launches = 0                                        # the main path starts
    rows = []
    for i, (img, sz) in enumerate(reqs):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(img, sz, combine=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        det = out.detections
        n_det = int(det.valid.sum())
        n_seg = int(out.seg_valid.sum())
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        h, w = img.shape[1:3]
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (det.boxes, det.scores, det.mask_logits, out.sem_seg_logits))
        shapes_ok = (out.panoptic.shape == (1, h // 4, w // 4)
                     and out.sem_seg_logits.shape == (1, h // 4, w // 4, 28)
                     and det.boxes.shape == (1, 100, 4))
        log(f"[slice] request {i}: {h}x{w} latency {ms:.2f} ms, valid detections "
            f"{n_det}, fused segments {n_seg} "
            f"({int((out.seg_valid & out.seg_is_thing).sum())} things), "
            f"peak memory {peak:.0f} MiB")
        if not (finite and shapes_ok and n_det > 0):
            raise AssertionError(f"request {i}: finite={finite} shapes={shapes_ok} "
                                 f"detections={n_det}")
        rows.append(dict(h=h, w=w, ms=ms, detections=n_det, segments=n_seg,
                         peak_mib=peak))
    launches = k.launches                                 # the main path ends
    log(f"[slice] roi_align_ml launches: {launches} over {len(reqs)} forwards")
    if launches != 4 * len(reqs):
        raise AssertionError(f"expected {4 * len(reqs)} kernel launches, got {launches}")
    return rows, launches, model, reqs


def phase_profile(model, req, iters: int = 3):
    """torch.profiler over ``iters`` warm forwards of one request: wall time,
    summed device-kernel time (-> the device's busy share) and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    img, sz = req
    model(img, sz, combine=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(img, sz, combine=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    h, w = img.shape[1:3]
    log(f"[profile] {h}x{w} forward: wall {wall_ms:.2f} ms, device kernels "
        f"{dev_ms:.2f} ms -> busy {dev_ms / wall_ms:.3f}, idle {1 - dev_ms / wall_ms:.3f}; "
        f"{sum(e.count for e in kernels) / iters:.0f} kernel launches per forward")
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / iters
        rows.append(dict(name=e.key[:90], ms=ms, count=e.count / iters))
        log(f"[profile]   {ms:8.3f} ms  x{e.count / iters:5.0f}  {e.key[:90]}")
    return dict(h=h, w=w, wall_ms=wall_ms, device_ms=dev_ms, top=rows)


def phase_cpu_parity(dev):
    from u2seg_torch.config import Config
    from u2seg_torch.models.build import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.model.roi_heads.pooler_impl = "pallas"
    # every detection eligible for fusion, so instance painting is compared
    cfg.model.panoptic.instance_conf_thresh = cfg.model.roi_heads.score_thresh_test
    gpu = calibrate(build_model(cfg, device=dev, seed=0))
    cpu = calibrate(build_model(cfg, device="cpu", seed=0))
    h, w = 512, 832
    img = torch.from_numpy(scene(np.random.RandomState(2), h, w))[None]
    sz = torch.tensor([[h, w]], dtype=torch.int32)
    res = {}
    with torch.no_grad():
        fc, fg = cpu.features(img), gpu.features(img.to(dev))
        sc, sg = cpu.sem_seg_head(fc), gpu.sem_seg_head(fg).cpu()
        res["sem_err"] = float((sc - sg).abs().max() / sc.abs().max())
        pc = cpu.proposal_generator(fc, sz)
        pg = gpu.proposal_generator(fg, sz.to(dev))
        same = (pc.proposal_valid == pg.proposal_valid.cpu()).all(-1)
        box_err = (pc.proposal_boxes - pg.proposal_boxes.cpu()).abs().amax(-1)
        res["proposal_agree"] = float(((box_err < 1e-2) & pc.proposal_valid).sum()
                                      / pc.proposal_valid.sum())
        # cascade stages on the SAME (CPU) proposals on both devices
        _, prob_c = cpu.roi_heads.forward_box(fc, pc.proposal_boxes, sz)
        _, prob_g = gpu.roi_heads.forward_box(fg, pc.proposal_boxes.to(dev), sz.to(dev))
        res["cascade_score_err"] = float((prob_c - prob_g.cpu()).abs().max())
        oc = cpu(img, sz, combine=True)
        og = gpu(img.to(dev), sz.to(dev), combine=True)
    dc, dg = oc.detections, og.detections
    match = ((dc.classes == dg.classes.cpu()) & dc.valid & dg.valid.cpu()
             & ((dc.boxes - dg.boxes.cpu()).abs().amax(-1) < 0.5))
    res["det_agree"] = float(match.sum() / max(int(dc.valid.sum()), 1))
    res["detections"] = int(dc.valid.sum())
    res["things"] = int((oc.seg_valid & oc.seg_is_thing).sum())
    res["pan_agree"] = float((oc.panoptic == og.panoptic.cpu()).float().mean())
    log(f"[cpu] 512x832 f32 pooler=pallas: sem logits max|gpu-cpu|/max|cpu| "
        f"{res['sem_err']:.2e} (tol 1e-3); proposals equal (all valid flags "
        f"{bool(same.all())}, box diff < 0.01 px) {res['proposal_agree']:.4f} "
        f"(tol >= 0.95); averaged cascade scores on the same proposals "
        f"max|gpu-cpu| {res['cascade_score_err']:.2e} (tol 1e-4); final "
        f"detections agreeing (class, box < 0.5 px) {res['det_agree']:.4f} of "
        f"{res['detections']}; panoptic pixels agreeing {res['pan_agree']:.4f} "
        f"({res['things']} things painted on the CPU)")
    if not (res["sem_err"] <= 1e-3 and res["proposal_agree"] >= 0.95
            and res["cascade_score_err"] <= 1e-4):
        raise AssertionError(f"card and CPU disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 6 / 7: the training step
# ---------------------------------------------------------------------------

LOSS_KEYS = (["loss_sem_seg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"]
             + [f"loss_{k}_stage{i}" for i in range(3) for k in ("cls", "box_reg")])
GRAD_GROUPS = ["backbone.bottom_up", "backbone.fpn_", "proposal_generator",
               "roi_heads.box_head.0", "roi_heads.box_predictor.0",
               "roi_heads.box_head.1", "roi_heads.box_predictor.1",
               "roi_heads.box_head.2", "roi_heads.box_predictor.2",
               "roi_heads.mask_head", "sem_seg_head"]


def train_batch(cfg, b: int, h: int, w: int, n_real: int = 20, patch: int = 64):
    """A numpy-drawn training batch at the recipe's shapes: ``max_gt_instances``
    slots of which ``n_real`` hold a box, a class and a mask patch."""
    from u2seg_torch.engine.trainer import Batch
    from u2seg_torch.structures.instances import GtInstances

    rng = np.random.RandomState(0)
    g = cfg.model.max_gt_instances
    images = rng.rand(b, h, w, 3).astype(np.float32) * 255
    xy = rng.rand(b, g, 2) * np.array([w / 2, h / 2])
    wh = rng.rand(b, g, 2) * 200 + 16
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.zeros((b, g), bool)
    valid[:, :n_real] = True
    classes = rng.randint(0, cfg.model.roi_heads.num_classes, (b, g)).astype(np.int32)
    masks = (rng.rand(b, g, patch, patch) > 0.4).astype(np.float32)
    sem = rng.randint(0, cfg.model.sem_seg_head.num_classes, (b, h, w)).astype(np.int32)
    gt = GtInstances(torch.from_numpy(boxes), torch.from_numpy(classes),
                     torch.from_numpy(valid), torch.from_numpy(masks))
    return Batch(torch.from_numpy(images),
                 torch.tensor([[h, w]] * b, dtype=torch.int32), gt,
                 torch.from_numpy(sem))


def group_grad_norms(model):
    out = {}
    for prefix in GRAD_GROUPS:
        grads = [p.grad.float() for k, p in model.named_parameters()
                 if k.startswith(prefix) and p.grad is not None]
        if not grads:
            raise AssertionError(f"no gradient on {prefix}")
        out[prefix] = float(torch.sqrt(sum((g ** 2).sum() for g in grads)))
    return out


def phase_train(dev, steps: int = 4, warmup: int = 2):
    from torch.profiler import ProfilerActivity, profile

    from u2seg_torch.config import Config
    from u2seg_torch.engine.trainer import create_train_state, make_train_step
    from u2seg_torch.ops import roi_align_ml as rap

    cfg = Config()
    (h, w), b = TRAIN_HW, 2
    state = create_train_state(cfg, device=dev, seed=0)
    model = state.model
    step = make_train_step(model, state.optimizer)
    batch = train_batch(cfg, b, h, w).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    probes = {k: p.detach().clone() for k, p in model.named_parameters()
              if k.endswith(("stem.conv1.weight", "rpn_head.conv.weight",
                             "box_head.2.fc1.weight", "mask_head.deconv.weight",
                             "sem_seg_head.predictor.weight",
                             "res4.0.conv1.norm.bias"))}
    bn0 = model.backbone.bottom_up.stem.conv1.norm.running_mean.clone()
    for _ in range(warmup):
        step(batch, gen)
    torch.cuda.synchronize()

    rap.multilevel_roi_align_kernel.launches = 0          # the main path starts
    rap.multilevel_roi_align_backward.launches = 0
    rows = []
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        metrics = {k: float(v) for k, v in metrics.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        norms = group_grad_norms(model)
        ok = (sorted(metrics) == sorted(LOSS_KEYS + ["total_loss"])
              and all(np.isfinite(v) for v in metrics.values())
              and all(np.isfinite(v) and v > 0 for v in norms.values()))
        log(f"[train] step {i}: {ms:.1f} ms, total_loss {metrics['total_loss']:.4f} ("
            + ", ".join(f"{k[5:]} {metrics[k]:.4f}" for k in LOSS_KEYS)
            + f"), peak memory {peak:.0f} MiB {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train step {i}: losses {metrics}, gradient norms {norms}")
        rows.append(dict(ms=ms, peak_mib=peak, losses=metrics, grad_norms=norms))
    fwd = rap.multilevel_roi_align_kernel.launches        # the main path ends
    bwd = rap.multilevel_roi_align_backward.launches
    log("[train] clipped gradient norms of the last step: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rows[-1]["grad_norms"].items()))
    log(f"[train] kernel launches over {steps} steps: forward {fwd}, backward {bwd}")
    if fwd != 4 * steps or bwd != 4 * steps:
        raise AssertionError(f"expected {4 * steps} + {4 * steps} launches, got {fwd} + {bwd}")
    moved = {k: float((p.detach() - probes[k]).abs().max())
             for k, p in model.named_parameters() if k in probes}
    bn_moved = float((model.backbone.bottom_up.stem.conv1.norm.running_mean - bn0).abs().max())
    log("[train] parameters changed (max|delta| after "
        f"{warmup + steps} steps): " + ", ".join(f"{k} {v:.2e}" for k, v in moved.items())
        + f"; stem BN running_mean moved {bn_moved:.2e}; optimizer count "
        f"{state.step}, lr {state.optimizer.param_groups[0]['lr']:.3e}")
    if not (len(moved) == 6 and all(v > 0 for v in moved.values()) and bn_moved > 0):
        raise AssertionError(f"parameters did not change: {moved}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    kernels = [e for e in prof.key_averages()          # not the step annotation
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    n_launch = sum(e.count for e in kernels) / 2
    log(f"[train] profile of 2 steps: wall {wall_ms:.1f} ms/step, device kernels "
        f"{dev_ms:.1f} ms/step -> busy {dev_ms / wall_ms:.3f}, idle "
        f"{1 - dev_ms / wall_ms:.3f}; {n_launch:.0f} kernel launches per step")
    top = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / 2
        top.append(dict(name=e.key[:90], ms=ms, count=e.count / 2))
        log(f"[train]   {ms:8.3f} ms  x{e.count / 2:5.0f}  {e.key[:90]}")
    ours = {e.key: e.self_device_time_total / 1e3 / 2 for e in kernels
            if "roi_align_ml" in e.key}
    log(f"[train] the port's kernels in that profile (ms/step): {ours}")
    return dict(steps=rows, forward_launches=fwd, backward_launches=bwd,
                profile=dict(wall_ms=wall_ms, device_ms=dev_ms,
                             launches_per_step=n_launch, top=top, ours=ours))


def phase_train_cpu_parity(dev):
    """The train step of the tiny config on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch, f32 with TF32 off.

    (a) The heads on the SAME features (the CPU trunk's, copied to the card):
    sem-seg head, RPN, cascade and mask heads, both poolers' kernels against
    their plain versions inside the real train graph. Losses rtol 1e-4; the
    gradients w.r.t. the five feature maps (what the backward kernel
    produces, summed with the other heads' shares) <= 1e-3 * max|grad| each;
    over the feature maps and all 65 head parameters together a relative L2
    error <= 1e-4, and each tensor <= 5e-2 * max|grad|: the mask head's
    gradients are ~1e-6 (its predictor starts at 0.001) and a handful of its
    ~1e6 ReLU inputs lie within f32 noise of 0, opening on one device only.
    The levels are 16x16 down to 1x1 here, narrower than the kernels' 32 x 40
    window.
    (b) The whole step: each loss rtol 1e-3; BN running statistics rtol 1e-2
    with atol 1e-3 * max; the gradients' relative L2 error over all
    parameters <= 0.15. The two devices sum convolutions in other orders;
    train-mode BatchNorm over 8 samples (2 x 2 positions x 2 images at res5)
    amplifies that from layer to layer of the R50 trunk, and a ReLU input
    within that noise of 0 opens on one device only, so trunk gradients
    differ by percents while the losses agree to 1e-5: (b) can only show
    that nothing is grossly off, (a) is the sharp check."""
    from u2seg_torch.engine.trainer import create_train_state
    from u2seg_torch.testing import tiny_batch, tiny_spmd_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_spmd_config()
    m = cfg.model
    m.roi_heads.pooler_impl = "pallas"
    # every candidate is sampled, so the two devices' random keys do not matter
    m.rpn.batch_size_per_image, m.rpn.positive_fraction = 2048, 0.5
    m.roi_heads.batch_size_per_image, m.roi_heads.positive_fraction = 256, 0.5
    batch = tiny_batch(np.random.RandomState(0), b=2)
    # uniform mask patches: resampled 0/1 patches land exactly on the 0.5
    # target threshold, where the last f32 bit would decide per device
    batch.gt.masks = torch.from_numpy(
        np.random.RandomState(1).rand(*batch.gt.masks.shape).astype(np.float32))
    models = {name: create_train_state(cfg, device=device, seed=0).model
              for name, device in (("cpu", "cpu"), ("gpu", dev))}

    def grads_of(losses, model, extra=()):
        model.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        out = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
               if p.grad is not None}
        out.update({k: v.grad.detach().cpu() for k, v in extra})
        return {k: float(v.detach()) for k, v in losses.items()}, out

    def compare(c, g):
        errs = {k: float((g[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                for k, v in c.items()}
        num = sum(float(((g[k] - v) ** 2).sum()) for k, v in c.items())
        den = sum(float((v ** 2).sum()) for v in c.values())
        worst = max(errs, key=errs.get)
        return dict(l2=(num / den) ** 0.5, worst=errs[worst], worst_name=worst,
                    worst_feature=max([e for k, e in errs.items()
                                       if k.startswith("d/d")], default=0.0),
                    tight_share=sum(e <= 1e-3 for e in errs.values()) / len(errs),
                    n=len(errs))

    def loss_err(c, g):
        return max(abs(g[k] / c[k] - 1) for k in LOSS_KEYS)

    # (a) the heads on the same features
    with torch.no_grad():
        feats = models["cpu"].features(batch.images)
    head = {}
    for name, model in models.items():
        device = next(model.parameters()).device
        bt = batch.to(device)
        tf = {k: v.detach().clone().to(device).requires_grad_() for k, v in feats.items()}
        losses = model.losses_from_features(
            tf, bt.image_sizes, bt.gt, bt.sem_seg,
            torch.Generator(device=device).manual_seed(0))
        head[name] = grads_of(losses, model, [(f"d/d{k}", v) for k, v in tf.items()])
    res = {"head_loss_err": loss_err(head["cpu"][0], head["gpu"][0]),
           "head": compare(head["cpu"][1], head["gpu"][1])}
    h = res["head"]
    ok_a = (res["head_loss_err"] <= 1e-4 and h["worst_feature"] <= 1e-3
            and h["l2"] <= 1e-4 and h["worst"] <= 5e-2 and h["n"] == 70)
    log(f"[train-cpu] (a) heads on the same features, tiny config f32, pooler=pallas: "
        f"losses max|gpu/cpu-1| {res['head_loss_err']:.2e} (tol 1e-4); gradients of the "
        f"5 feature maps: worst {h['worst_feature']:.2e} of max|grad| (tol 1e-3); of all "
        f"{h['n']} tensors (+ 65 head parameters): relative L2 error {h['l2']:.2e} "
        f"(tol 1e-4), worst {h['worst']:.2e} ({h['worst_name']}; tol 5e-2), "
        f"{h['tight_share']:.1%} within 1e-3 {'ok' if ok_a else 'FAIL'}")

    # (b) the whole step
    whole = {}
    sd0 = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
    for name, model in models.items():
        device = next(model.parameters()).device
        model.load_state_dict(sd0)
        bt = batch.to(device)
        losses = model(bt.images, bt.image_sizes, gt=bt.gt, sem_seg_gt=bt.sem_seg,
                       train=True, generator=torch.Generator(device=device).manual_seed(0))
        whole[name] = grads_of(losses, model) + (
            {k: v.detach().cpu() for k, v in model.state_dict().items()
             if "running_" in k},)
    res["loss_err"] = loss_err(whole["cpu"][0], whole["gpu"][0])
    res["stats_ok"] = all(
        bool(torch.isclose(whole["gpu"][2][k], v, rtol=1e-2,
                           atol=1e-3 * float(v.abs().max())).all())
        for k, v in whole["cpu"][2].items())
    res["whole"] = w = compare(whole["cpu"][1], whole["gpu"][1])
    ok_b = res["loss_err"] <= 1e-3 and res["stats_ok"] and w["l2"] <= 0.15
    log(f"[train-cpu] (b) whole step: losses max|gpu/cpu-1| {res['loss_err']:.2e} "
        f"(tol 1e-3); BN running stats agree {res['stats_ok']} (rtol 1e-2); gradients of "
        f"{w['n']} tensors: relative L2 error {w['l2']:.2e} (tol 0.15), "
        f"{w['tight_share']:.1%} within 1e-3 * max|grad|, worst {w['worst']:.2e} "
        f"({w['worst_name']}) {'ok' if ok_b else 'FAIL'}")
    if not (ok_a and ok_b):
        raise AssertionError(f"card and CPU train steps disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# Phases 12-14: the hook-driven training loop, data parallelism
# ---------------------------------------------------------------------------

def full_width_loader(cfg, n: int, b: int = 2):
    """``n`` global batches of ``testing.fake_loader`` at the train bucket
    (800x1344, 20 gt boxes with 64x64 mask patches, the config's classes),
    drawn before training so the loop's step time holds no data drawing."""
    from u2seg_torch.testing import fake_loader

    (h, w) = TRAIN_HW
    loader = fake_loader(np.random.RandomState(0), b=b, h=h, w=w, g=20, patch=64,
                         num_classes=cfg.model.roi_heads.num_classes,
                         num_stuff=cfg.model.sem_seg_head.num_classes)
    return [next(loader) for _ in range(n)]


def kernel_counts():
    from u2seg_torch.ops import roi_align_ml as rap

    return (rap.multilevel_roi_align_kernel.launches,
            rap.multilevel_roi_align_backward.launches)


def reset_kernel_counts():
    from u2seg_torch.ops import roi_align_ml as rap

    rap.multilevel_roi_align_kernel.launches = 0
    rap.multilevel_roi_align_backward.launches = 0


def step_probe_hooks(record: dict):
    """Two hooks: the first (registered before every other hook) notes the
    kernel counts and the wall time around ``run_step`` and the BN
    statistics after it; the second (registered last) sees the statistics
    once every other hook, PreciseBN included, has run."""
    from u2seg_torch.engine.hooks import HookBase
    from u2seg_torch.engine.trainer import bn_running_stats

    class First(HookBase):
        def before_step(self):
            self._counts = kernel_counts()
            self._t0 = time.perf_counter()

        def after_step(self):
            ms = (time.perf_counter() - self._t0) * 1e3    # run_step synced (.tolist)
            k1, k3 = kernel_counts()
            record.setdefault("steps", []).append(dict(
                iter=self.trainer.iter, ms=ms, k1=k1 - self._counts[0],
                k3=k3 - self._counts[1]))
            record["stats_after_step"] = [t.clone() for t in bn_running_stats(self.trainer.model)]

    class Last(HookBase):
        def after_step(self):
            now = bn_running_stats(self.trainer.model)
            moved = max(float((a - b).abs().max())
                        for a, b in zip(now, record["stats_after_step"]))
            record.setdefault("hook_moved_stats", []).append((self.trainer.iter, moved))

    return First(), Last()


def phase_train_loop(dev, bare_ms=None, steps: int = 6, resumed_steps: int = 2):
    """``DefaultTrainer`` at full width (the default Config(), b=2 at
    800x1344, bf16) inside ``launch`` with one NCCL rank (``file://``
    rendezvous): 6 steps with the default hooks + PreciseBN(period=4,
    num_iters=2), checkpoints every 3 steps; then a second trainer resumes
    from the last checkpoint and takes 2 more steps."""
    import tempfile

    from u2seg_torch.config import Config
    from u2seg_torch.engine.precise_bn import PreciseBN
    from u2seg_torch.engine.train_loop import DefaultTrainer, batch_from_numpy
    from u2seg_torch.engine.trainer import bn_running_stats
    from u2seg_torch.parallel.launch import launch
    from u2seg_torch.parallel.mesh import shard_batch

    res = {}

    def main(out_dir):
        cfg = Config()
        cfg.output_dir = out_dir
        cfg.solver.checkpoint_period = 3
        data = full_width_loader(cfg, steps + 4 + resumed_steps)
        trainer = DefaultTrainer(cfg, data[:steps + 4])
        saves = []
        save = trainer.checkpointer.save

        def timed_save(name, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(name, state)
            saves.append((name, (time.perf_counter() - t0) * 1e3, os.path.getsize(path)))
            return path

        trainer.checkpointer.save = timed_save
        rec = {}
        first, last = step_probe_hooks(rec)
        trainer.register_hooks([first] + trainer.build_hooks()
                               + [PreciseBN(period=4, num_iters=2), last])
        torch.cuda.reset_peak_memory_stats(dev)
        reset_kernel_counts()                          # the main path starts
        trainer.train(max_iter=steps)
        k1, k3 = kernel_counts()                       # the main path ends
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        totals = [v for v, _ in trainer.storage.history("total_loss").values()]
        timer = [v * 1e3 for v, _ in trainer.storage.history("time").values()]
        with open(os.path.join(out_dir, "metrics.json")) as f:
            lines = [json.loads(l) for l in f]
        ckpt = trainer.checkpointer.get_checkpoint_file()

        second = DefaultTrainer(cfg, data[steps + 4:])
        second.checkpointer.save = timed_save
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = second.resume_or_load(resume=True)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        saved = second.checkpointer.load(ckpt, map_location="cpu")
        same_as_saved = all(torch.equal(v.cpu(), saved["model"][k])
                            for k, v in second.model.state_dict().items())
        same_params = all(torch.equal(v, dict(trainer.model.named_parameters())[k])
                          for k, v in second.model.named_parameters())
        start_iter, count = second.start_iter, second.state.step
        rec2 = {}
        first2, last2 = step_probe_hooks(rec2)
        second.register_hooks([first2] + second.build_hooks() + [last2])
        reset_kernel_counts()                          # the resumed path starts
        second.train(max_iter=steps + resumed_steps)
        k1_r, k3_r = kernel_counts()                   # the resumed path ends
        totals_r = [v for v, _ in second.storage.history("total_loss").values()]
        with open(os.path.join(out_dir, "metrics.json")) as f:
            lines_r = [json.loads(l) for l in f]

        # where the loop's time goes: the bare step on one of the loop's own
        # batches already on the card, and the upload of a batch alone
        def synced_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        on_card = shard_batch(second.mesh, batch_from_numpy(data[0]))
        bare_loop_data = [synced_ms(lambda: second.step_fn(on_card, second._generator))
                          for _ in range(3)]
        upload = [synced_ms(lambda: shard_batch(second.mesh, batch_from_numpy(d)))
                  for d in data[:3]]
        res.update(
            steps=rec["steps"], resumed_steps=rec2["steps"], totals=totals + totals_r,
            timer_ms=timer, peak_mib=peak, launches=dict(k1=k1, k3=k3),
            resumed_launches=dict(k1=k1_r, k3=k3_r), saves=saves, load_ms=load_ms,
            ckpt=ckpt, resumed=resumed, start_iter=start_iter, count=count,
            same_as_saved=same_as_saved, same_params=same_params,
            metrics_iters=[l["iteration"] for l in lines_r],
            metrics_iters_first=[l["iteration"] for l in lines],
            precise_bn_moved=dict(rec["hook_moved_stats"]),
            bn_stats=len(bn_running_stats(trainer.model)),
            bare_loop_data_ms=bare_loop_data, upload_ms=upload)

    with tempfile.TemporaryDirectory() as tmp:
        launch(main, backend="nccl", init_method="file://" + os.path.join(tmp, "rdv"),
               world_size=1, rank=0, args=(os.path.join(tmp, "out"),))
    steps_ok = all(r["k1"] == 4 and r["k3"] == 4 for r in res["steps"] + res["resumed_steps"])
    pbn_forwards = 2 * 2                     # after step 3 and at the end, 2 batches each
    launches_ok = (res["launches"] == dict(k1=4 * steps + 4 * pbn_forwards, k3=4 * steps)
                   and res["resumed_launches"] == dict(k1=4 * resumed_steps,
                                                       k3=4 * resumed_steps))
    moved = res["precise_bn_moved"]
    pbn_ok = moved.get(3, 0) > 0 and all(v == 0 for it, v in moved.items() if it != 3)
    timer_med = float(np.median(res["timer_ms"]))
    ok = (steps_ok and launches_ok and pbn_ok and res["resumed"]
          and all(np.isfinite(v) for v in res["totals"])
          and len(res["totals"]) == steps + resumed_steps
          and res["ckpt"] == f"model_{steps - 1:07d}"
          and [n for n, _, _ in res["saves"]] == ["model_0000002", "model_0000005",
                                                   "model_0000007"]
          and res["start_iter"] == steps and res["count"] == steps
          and res["same_as_saved"] and res["same_params"]
          and res["metrics_iters_first"] == [steps - 1]
          and res["metrics_iters"] == [steps - 1, steps + resumed_steps - 1])
    save_ms = [ms for _, ms, _ in res["saves"]]
    size_mb = res["saves"][0][2] / 1e6
    log(f"[train_loop] DefaultTrainer, default Config() at full width, b=2 at "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, 1 NCCL rank via launch(file://): {steps} steps + "
        f"PreciseBN(period 4, 2 batches) + checkpoints every 3; total losses "
        + ", ".join(f"{v:.4f}" for v in res["totals"][:steps])
        + f"; K1/K3 launches per step {[(r['k1'], r['k3']) for r in res['steps']]}, over the "
        f"run {res['launches']['k1']} / {res['launches']['k3']} (PreciseBN's {pbn_forwards} "
        f"forwards: 4 K1 each, no K3); PreciseBN moved the BN statistics by max "
        f"{moved.get(3, 0):.3e} after step 3 ({res['bn_stats']} running tensors)")
    log(f"[train_loop] step time from IterationTimer (median of steps 3-5, after its "
        f"3 warm-up steps): {timer_med:.1f} ms ({', '.join(f'{v:.1f}' for v in res['timer_ms'])})"
        + (f"; phase train's bare make_train_step in this run: median {bare_ms:.1f} ms "
           f"-> ratio {timer_med / bare_ms:.3f}" if bare_ms else "")
        + f"; run_step alone per step (ms): "
        + ", ".join(f"{r['ms']:.1f}" for r in res["steps"])
        + f"; peak memory {res['peak_mib']:.0f} MiB; the bare step on one of the loop's "
        f"batches, already on the card: {', '.join(f'{v:.1f}' for v in res['bare_loop_data_ms'])}"
        f" ms; a batch's upload alone: {', '.join(f'{v:.1f}' for v in res['upload_ms'])} ms")
    log(f"[train_loop] checkpoints {[n for n, _, _ in res['saves']]}: {size_mb:.1f} MB each, "
        f"save {', '.join(f'{v:.0f}' for v in save_ms)} ms, load (resume_or_load) "
        f"{res['load_ms']:.0f} ms; resumed at start_iter {res['start_iter']} (update count "
        f"{res['count']}), parameters equal the saved ones exactly: {res['same_as_saved']}, "
        f"equal the first trainer's: {res['same_params']}; 2 resumed steps: total losses "
        + ", ".join(f"{v:.4f}" for v in res["totals"][steps:])
        + f", K1/K3 launches {res['resumed_launches']}; metrics.json iterations "
        f"{res['metrics_iters']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train_loop failed: { {k: v for k, v in res.items()} }")
    res.update(timer_median_ms=timer_med, bare_ms=bare_ms, size_mb=size_mb, save_ms=save_ms)
    return res


DDP_WORLD, DDP_STEPS = 2, 2


def ddp_worker(rank: int, init: str, out_path: str):
    """One rank of phase ``ddp``: gloo, the full-width config, b=1 of a
    global b=2; after each step every parameter and BN buffer's checksum is
    gathered on the CPU and compared across the ranks."""
    from u2seg_torch.config import Config
    from u2seg_torch.engine.hooks import HookBase
    from u2seg_torch.engine.train_loop import DefaultTrainer
    from u2seg_torch.engine.trainer import bn_running_stats
    from u2seg_torch.parallel import comm
    from u2seg_torch.parallel.launch import launch

    def checksums(model):
        # the bits of every f32 tensor summed as integers: one number per tensor
        return torch.stack([t.detach().view(torch.int32).to(torch.int64).sum()
                            for t in model.state_dict().values()]).cpu().tolist()

    def main():
        import tempfile

        import torch.distributed.nn.functional as dist_fn

        # time the step's coalesced all-reduce and SyncBN's moment all-reduces
        coll = {"coalesced_ms": [], "syncbn_ms": 0.0, "syncbn_calls": 0}
        coalesced, moments = comm.all_reduce_mean_, dist_fn.all_reduce

        def timed_coalesced(tensors):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coalesced(tensors)
            torch.cuda.synchronize()
            coll["coalesced_ms"].append((time.perf_counter() - t0) * 1e3)

        def timed_moments(t, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = moments(t, *a, **k)
            torch.cuda.synchronize()
            coll["syncbn_ms"] += (time.perf_counter() - t0) * 1e3
            coll["syncbn_calls"] += 1
            return out

        comm.all_reduce_mean_, dist_fn.all_reduce = timed_coalesced, timed_moments
        cfg = Config()
        with tempfile.TemporaryDirectory() as tmp:
            cfg.output_dir = tmp
            trainer = DefaultTrainer(cfg, full_width_loader(cfg, DDP_STEPS, b=DDP_WORLD))
            stats0 = [t.clone() for t in bn_running_stats(trainer.model)]
            rec = {"identical_after_step": []}

            class Identical(HookBase):
                def after_step(self):
                    sums = comm.all_gather(checksums(self.trainer.model))
                    rec["identical_after_step"].append(all(s == sums[0] for s in sums))

            first, _ = step_probe_hooks(rec)
            trainer.register_hooks([first, Identical()])
            identical_at_start = len(set(map(tuple, comm.all_gather(
                checksums(trainer.model))))) == 1
            reset_kernel_counts()                      # the main path starts
            trainer.train(max_iter=DDP_STEPS)
            k1, k3 = kernel_counts()                   # the main path ends
            moved = max(float((a - b).abs().max())
                        for a, b in zip(bn_running_stats(trainer.model), stats0))
            totals = [v for v, _ in trainer.storage.history("total_loss").values()]
            res = dict(rank=comm.get_rank(), world=comm.get_world_size(),
                       device=str(trainer.device), steps=rec["steps"],
                       identical_after_step=rec["identical_after_step"],
                       identical_at_start=identical_at_start, totals=totals,
                       bn_moved=moved, launches=dict(k1=k1, k3=k3),
                       n_tensors=len(trainer.model.state_dict()), collectives=coll,
                       peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
        with open(out_path, "w") as f:
            json.dump(res, f)

    launch(main, backend="gloo", init_method=init, world_size=DDP_WORLD, rank=rank)


def phase_ddp(timeout: float = 600.0):
    """Two gloo ranks on the one card (spawned processes, each with its own
    CUDA context; NCCL refuses two ranks on one device), the full-width
    config, b=1 per rank (global 2 at 800x1344), 2 steps of
    ``DefaultTrainer``. The kernels are built before (phase build), so the
    ranks load them."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rdv")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(DDP_WORLD)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank",
                                   str(r), "--ddp-init", init, "--ddp-out", outs[r]],
                                  cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(DDP_WORLD)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                log(f"[ddp] rank {r} exited {p.returncode}:\n{text[-6000:]}")
                raise AssertionError(f"ddp rank {r} failed")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    ok = True
    for r in res:
        r_ok = (r["world"] == DDP_WORLD and r["identical_at_start"]
                and r["identical_after_step"] == [True] * DDP_STEPS
                and all(np.isfinite(v) for v in r["totals"]) and len(r["totals"]) == DDP_STEPS
                and r["bn_moved"] > 0
                and all(s["k1"] == 4 and s["k3"] == 4 for s in r["steps"])
                and r["launches"] == dict(k1=4 * DDP_STEPS, k3=4 * DDP_STEPS))
        ok = ok and r_ok
        log(f"[ddp] rank {r['rank']}/{r['world']} on {r['device']} (gloo, b=1 of a global 2 "
            f"at {TRAIN_HW[0]}x{TRAIN_HW[1]}): step ms "
            + ", ".join(f"{s['ms']:.1f}" for s in r["steps"])
            + f"; total losses {', '.join(f'{v:.4f}' for v in r['totals'])}; "
            f"{r['n_tensors']} parameters and buffers bit-identical on both ranks after each "
            f"step: {r['identical_after_step']}; SyncBN running statistics moved "
            f"{r['bn_moved']:.3e}; K1/K3 launches per step "
            f"{[(s['k1'], s['k3']) for s in r['steps']]}; peak memory {r['peak_mib']:.0f} MiB; "
            f"coalesced all-reduce of gradients + losses + BN statistics (synced) "
            f"{', '.join(f'{v:.1f}' for v in r['collectives']['coalesced_ms'])} ms per step; "
            f"SyncBN's forward moment all-reduces (synced each; their backward "
            f"all-reduces run inside autograd, untimed) "
            f"{r['collectives']['syncbn_calls']} calls, {r['collectives']['syncbn_ms']:.1f} ms "
            f"over the {DDP_STEPS} steps {'ok' if r_ok else 'FAIL'}")
    ok = ok and res[0]["totals"] == res[1]["totals"]
    log(f"[ddp] {DDP_WORLD} ranks, {DDP_STEPS} steps: {wall_s:.1f} s from spawn to exit; "
        f"averaged losses equal on both ranks: {res[0]['totals'] == res[1]['totals']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ddp failed: {res}")
    return dict(ranks=res, wall_s=wall_s)


def phase_ddp_cpu():
    """``entry.dryrun_multichip(2)``: one data-parallel step of the tiny
    config over two gloo processes on the CPU."""
    from u2seg_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(2)
    ok = "dryrun_multichip(2): ok" in out
    log(f"[ddp_cpu] entry.dryrun_multichip(2) in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dryrun_multichip(2) printed no result: {out}")
    return dict(output=out.strip())


# ---------------------------------------------------------------------------
# Phase 8: the single-level window ROIAlign kernel (K4)
# ---------------------------------------------------------------------------

def k4_work(ras, feat, boxes, s, r, scale, in_bytes):
    """Bytes (touched map cells read once, f32 output written once, ROI
    inputs) and flops (2 per non-zero tap weight pair, per channel)."""
    _, h, w, c = feat.shape
    meta, origin = ras._prep(boxes, h, w, s, r, scale)
    wy = ras._axis_weights(meta[:, 0], meta[:, 2], h, origin[:, 0], s, r)
    wx = ras._axis_weights(meta[:, 1], meta[:, 3], w, origin[:, 1], s, r)
    cells = torch.arange(ras.WIN, device=boxes.device)
    idx = ((origin[:, 0].long()[:, None] + cells)[:, :, None] * w
           + (origin[:, 1].long()[:, None] + cells)[:, None, :])
    touched = (wy != 0).any(1)[:, :, None] & (wx != 0).any(1)[:, None, :]
    n_cells = torch.unique(idx[touched]).numel()
    n_roi = boxes.shape[0]
    nbytes = n_cells * c * in_bytes + n_roi * s * s * c * 4 + n_roi * 20
    ny = (wy != 0).sum(-1).reshape(n_roi, s, r).sum(-1).float()
    nx = (wx != 0).sum(-1).reshape(n_roi, s, r).sum(-1).float()
    flops = float((ny[:, :, None] * nx[:, None, :]).sum()) * 2 * c
    return nbytes, flops


def k4_agrees(got, ref, dtype) -> bool:
    """The f32 tolerance for f32 maps, the AMP tolerance for bf16 maps."""
    err = (got - ref).abs()
    if dtype == torch.float32:
        return bool((err <= F32_TOL * max(1.0, float(ref.abs().max()))).all())
    return bool((err <= AMP_ATOL + AMP_RTOL * ref.abs()).all())


def k4_narrow_check(ras, dev):
    """K4 at C=72 (the last chunk of 64 channels holds 8) on a two-image p3
    map, for each map dtype, s=7 and s=14, with the edge boxes."""
    from u2seg_torch.dev.time_roi_align_single import K4_HW, K4_STRIDE, k4_boxes

    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.randn(2, *K4_HW, NARROW_C, generator=gen, device=dev)
    rng = np.random.RandomState(11)
    boxes = k4_boxes(rng, 200)[0].to(dev)
    bidx = torch.from_numpy(rng.randint(0, 2, len(boxes)).astype(np.int32)).to(dev)
    worst = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        feat = base.to(dtype)
        for s in (7, 14):
            got = ras.roi_align_single(feat, boxes, bidx, s, 1.0 / K4_STRIDE, 2)
            ref = ras.roi_align_single_ref(feat, boxes, bidx, s, 1.0 / K4_STRIDE, 2)
            torch.cuda.synchronize()
            worst[name] = max(worst.get(name, 0.0), float((got - ref).abs().max()))
            if not (k4_agrees(got, ref, dtype) and got.shape == (len(boxes), s, s, NARROW_C)):
                raise AssertionError(f"K4 disagrees with its plain version at C={NARROW_C}: "
                                     f"{name} map, s={s}, max|diff| {worst[name]:.3e}")
    log(f"[k4] C={NARROW_C} (ragged last chunk), 2 x 100x152 map, {len(boxes)} boxes with the "
        f"edge boxes, s=7/14: max|kernel-plain| f32 map {worst['f32']:.3e} (tol {F32_TOL:g} * "
        f"max(1, max|plain|)), bf16 map {worst['bf16']:.3e} (atol {AMP_ATOL} + rtol "
        f"{AMP_RTOL}) ok")
    return worst


def k4_tall_bins_check(ras, dev):
    """Boxes as tall and wide as the window at s=1, 2 and 3: a bin spans 8-22
    map rows under a span of up to 40 columns, more rows than the stage buffer
    holds (the kernel's global-memory path); for each map dtype."""
    from u2seg_torch.dev.time_roi_align_single import K4_HW, K4_STRIDE

    gen = torch.Generator(device=dev).manual_seed(12)
    base = torch.randn(1, *K4_HW, 64, generator=gen, device=dev)
    boxes = torch.tensor([[0.0, 0.0, 320.0, 320.0], [50.0, 30.0, 370.0, 330.0],
                          [400.0, 300.0, 720.0, 600.0], [8.0, 8.0, 40.0, 300.0],
                          [900.0, 500.0, 1216.0, 800.0]], device=dev)
    bidx = torch.zeros(len(boxes), dtype=torch.int32, device=dev)
    worst, fallback = {}, []
    for s in (1, 2, 3):
        wy, wx, _ = ras.pooled_axis_weights(boxes, *K4_HW, s, 2, 1.0 / K4_STRIDE)
        cells = torch.arange(ras.WIN, device=dev)
        lo = lambda m: torch.where(m, cells, ras.WIN).amin(-1)
        hi = lambda m: torch.where(m, cells, -1).amax(-1)
        bin_rows = (hi(wy != 0) - lo(wy != 0) + 1).amax(-1)    # the tallest bin per ROI
        span_x = hi((wx != 0).any(1)) - lo((wx != 0).any(1)) + 1
        stage = ras.launch_plan(s)[1]
        for dtype, name, nbytes in ((torch.float32, "f32", 4), (torch.bfloat16, "bf16", 2)):
            cap = stage // (64 * nbytes) // span_x.clamp(min=1)
            fallback.append(int((bin_rows > cap).sum()))
            feat = base.to(dtype)
            got = ras.roi_align_single(feat, boxes, bidx, s, 1.0 / K4_STRIDE, 2)
            ref = ras.roi_align_single_ref(feat, boxes, bidx, s, 1.0 / K4_STRIDE, 2)
            torch.cuda.synchronize()
            worst[name] = max(worst.get(name, 0.0), float((got - ref).abs().max()))
            if not k4_agrees(got, ref, dtype):
                raise AssertionError(f"K4 disagrees with its plain version on tall bins: "
                                     f"{name} map, s={s}, max|diff| {worst[name]:.3e}")
    if min(fallback) < 1:
        raise AssertionError(f"the tall-bin case missed the global-memory path: {fallback}")
    log(f"[k4] tall bins (boxes of 36-40 cells at s=1/2/3, C=64): ROIs with a bin taller than "
        f"the stage buffer per (s, dtype) {fallback}; max|kernel-plain| f32 map "
        f"{worst['f32']:.3e}, bf16 map {worst['bf16']:.3e} ok")
    return dict(worst, fallback_rois=fallback)


def ptxas_report(name: str):
    """Registers and spill bytes of each kernel in the ptxas log beside the
    built library: {"f32" or "bf16" (the map type): [registers, spill
    stores, spill loads]}."""
    from u2seg_torch import _cuda

    out, key = {}, None
    with open(_cuda.library_path(name) + ".log") as f:
        for line in f:
            if "Compiling entry function" in line:
                key = "bf16" if "bfloat16" in line else "f32"
                out[key] = [0, 0, 0]
            elif key and "spill stores" in line:
                nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
                out[key][1:] = nums[1:3]
            elif key and "Used" in line and "registers" in line:
                out[key][0] = int(line.split("Used")[1].split()[0])
    return out


def phase_k4(dev):
    from u2seg_torch.dev.time_roi_align_single import K4_HW, K4_STRIDE, k4_boxes
    from u2seg_torch.ops import roi_align_single as ras
    from u2seg_torch.ops.roi_align import roi_align

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (h, w), c, scale, r = K4_HW, 256, 1.0 / K4_STRIDE, 2
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.randn(1, h, w, c, generator=gen, device=dev)
    rng = np.random.RandomState(5)
    results = {"ptxas": ptxas_report("roi_align_single")}
    for s, n in ((7, 1000), (14, 1000)):
        boxes, n_edge = k4_boxes(rng, n)
        boxes = boxes.to(dev)
        bidx = torch.zeros(n, dtype=torch.int32, device=dev)
        rec = {"s": s, "R": n}
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            feat = base.to(dtype)
            before = ras.roi_align_single.launches
            got = ras.roi_align_single(feat, boxes, bidx, s, scale, r)
            if ras.roi_align_single.launches != before + 1:
                raise AssertionError("the K4 wrapper did not launch its kernel")
            ref = ras.roi_align_single_ref(feat, boxes, bidx, s, scale, r)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            top = float(ref.abs().max())
            ok = k4_agrees(got, ref, dtype)
            tol = (f"{F32_TOL:g} * max(1, max|plain|)" if dtype == torch.float32
                   else f"atol {AMP_ATOL} + rtol {AMP_RTOL}")
            ok = ok and got.dtype == torch.float32 and got.shape == (n, s, s, c)
            # the over-long box (index 3, 50 cells wide) lost its far columns,
            # as it does in the TPU kernel
            ok = ok and float(got[3, :, -1].abs().max()) == 0.0 and float(got[3, :, 0].abs().max()) > 0
            rec[f"max_abs_err_{name}"] = float(err.max())
            rec[f"edge_err_{name}"] = float(err[:n_edge].max())
            log(f"[k4] s={s} R={n} {name} map: max|kernel-plain|={float(err.max()):.3e} "
                f"(edge boxes {rec[f'edge_err_{name}']:.3e}, max|plain|={top:.3f}, tol {tol}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version ({name}, s={s})")
        feat = base.to(torch.bfloat16)
        before = ras.roi_align_single.launches
        empty = ras.roi_align_single(feat, boxes[:0], bidx[:0], s, scale, r)
        if empty.shape != (0, s, s, c) or ras.roi_align_single.launches != before:
            raise AssertionError("K4 with R=0 returned a wrong shape or launched")
        # device time at the serving path's dtype: bf16 map, f32 out
        threads, stage_bytes = ras.launch_plan(s)
        shared = ras.shared_bytes(s, stage_bytes)
        if ras.kernel_shared_bytes(s) != shared:
            raise AssertionError("the K4 library and its wrapper disagree on shared memory")
        args = [ras.prepare_launch(base.to(torch.bfloat16), boxes, bidx, s, r, scale)
                for _ in range(ROTATION)]
        fns = [lambda a=a: ras.launch(a) for a in args]
        rec["ms"] = graph_ms(fns[:1], iters=48)
        rec["cold_ms"] = graph_ms(fns, iters=48)
        rec["enqueue_ms"] = cuda_ms(fns[0], iters=50)
        rot_mb = ROTATION * (feat.numel() * 2 + args[0].out.numel() * 4) / 1e6
        del args, fns
        rec["wrapper_ms"] = cuda_ms(lambda: ras.roi_align_single(
            feat, boxes, bidx, s, scale, r), iters=20)
        rec["plain_ms"] = cuda_ms(lambda: ras.roi_align_single_ref(
            feat, boxes, bidx, s, scale, r), iters=3, warmup=1)
        rec["gather_ms"] = cuda_ms(lambda: roi_align(
            feat, boxes, bidx, s, scale, r), iters=5, warmup=1)
        nbytes, flops = k4_work(ras, feat, boxes, s, r, scale, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   threads=threads, stage_bytes=stage_bytes, shared_bytes=shared)
        log(f"[k4] s={s} R={n} bf16 map device time (48 launches in one CUDA graph, no host "
            f"code between them): {rec['ms']:.4f} ms with L2 warm (one launch repeated), "
            f"{rec['cold_ms']:.4f} ms with L2 exceeded (rotating over {ROTATION} copies of "
            f"map and output, {rot_mb:.0f} MB); plan: chunk {ras.CHUNK}, {threads} threads, "
            f"{stage_bytes} B stage, {shared} B shared; launched back to back through the "
            f"Python wrapper {rec['enqueue_ms']:.4f} ms per launch; wrapper (prep+kernel) "
            f"{rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, plain gather pooler "
            f"(ops/roi_align.py, other semantics for boxes past the window) "
            f"{rec['gather_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> {rec['ms'] / rec['bound_ms']:.1f}x "
            f"its bound; library call: none (torchvision is not installed)")
        results[s] = rec
    log(f"[k4] ptxas: registers, spill stores, spill loads (bytes) per map type "
        f"{results['ptxas']}")
    results["narrow"] = k4_narrow_check(ras, dev)
    results["tall_bins"] = k4_tall_bins_check(ras, dev)
    # the kernel's "path": no model path reaches it (in the JAX package only a
    # test calls it), so its path is the public wrapper at these shapes
    ras.roi_align_single.launches = 0                     # the path starts
    for s in (7, 14):
        out = ras.roi_align_single(feat, boxes, bidx, s, scale, r)
    torch.cuda.synchronize()
    results["launches"] = ras.roi_align_single.launches   # the path ends
    if results["launches"] != 2 or not bool(torch.isfinite(out).all()):
        raise AssertionError("K4's wrapper path did not launch twice")
    log(f"[k4] wrapper path (s=7, s=14 on p3): {results['launches']} launches; "
        f"0 per forward and 0 per train step (no model path calls this kernel)")
    return results


# ---------------------------------------------------------------------------
# Phase 9: the window-read probe kernels (K5)
# ---------------------------------------------------------------------------

def phase_k5(dev):
    from u2seg_torch.dev import profile_window_read as probe

    feat = probe.make_map(0, dev)
    bsz, h, w, c = feat.shape
    rng = np.random.RandomState(6)
    errs = {"3d": 0.0, "flat": 0.0}
    for name, mode, wy, wx in probe.SHAPES:
        oy, ox, b = probe.make_origins(rng, 512, feat.shape, wy, wx, mode, dev)
        if mode == "3d":
            ox = ox + 5              # the kernel aligns the origin down itself
        got = probe.window_sum(feat, oy, ox, b, wy, wx, mode)
        ref = probe.window_sum_ref(feat, oy, ox, b, wy, wx, mode)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = (got.shape == (64, 8, 128)
              and bool(torch.isclose(got, ref, rtol=1e-5, atol=1e-3).all()))
        errs[mode] = max(errs[mode], err)
        log(f"[k5] {name}: N=512, all 64 rows max|kernel-plain|={err:.3e} at max|plain| "
            f"{float(ref.abs().max()):.1f} (tol rtol 1e-5 + atol 1e-3: f32 sums in "
            f"another order) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 {mode} disagrees with its plain version ({name})")
    probe.window_sum.launches = {"3d": 0, "flat": 0}      # the probe's path starts
    rows = probe.time_shapes(feat)
    launches = dict(probe.window_sum.launches)            # the probe's path ends
    rng = np.random.RandomState(0)
    for row in rows:
        oy, ox, b = probe.make_origins(rng, probe.NUM_WINDOWS, feat.shape,
                                       row["wy"], row["wx"], row["mode"], dev)
        cells = ((b.long()[:, None, None] * h + oy.long()[:, None, None]
                  + torch.arange(row["wy"], device=dev)[None, :, None]) * w
                 + ox.long()[:, None, None]
                 + torch.arange(row["wx"], device=dev)[None, None, :])
        seen = torch.zeros(bsz * h * w, dtype=torch.bool, device=dev)
        seen[cells.reshape(-1)] = True
        n_out = probe.NUM_WINDOWS // probe.GROUP * probe.SLOTS * 4
        nbytes = int(seen.sum()) * c * 2 + n_out + probe.NUM_WINDOWS * 12
        flops = probe.NUM_WINDOWS * row["wy"] * row["wx"] * c
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        row["plain_ms"] = cuda_ms(lambda: probe.window_sum_ref(
            feat, oy, ox, b, row["wy"], row["wx"], row["mode"]), iters=1, warmup=1)
        row.update(distinct_bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[k5] {row['name']:24s} N={probe.NUM_WINDOWS}: {row['ms']:.4f} ms, "
            f"{row['gb_per_s']:.1f} GB/s of window bytes ({row['bytes'] / 1e9:.2f} GB; "
            f"{nbytes / 1e6:.1f} MB distinct -> bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}), plain {row['plain_ms']:.2f} ms")
    log(f"[k5] probe path launches: {launches}; 0 per forward and 0 per train step "
        f"(a dev probe); library call: none")
    if min(launches.values()) < 1:
        raise AssertionError("a probe kernel was never launched by the probe's path")
    return dict(rows=rows, launches=launches, max_abs_err=errs)


# ---------------------------------------------------------------------------
# Phase 10 / 11: the eval path
# ---------------------------------------------------------------------------

EVAL_SIZES = [(480, 640), (427, 640), (640, 480), (500, 375)] * 2
EVAL_MODES = {"host": {}, "device_render": {"device_render": True},
              "device_resize": {"device_render": True, "device_resize": True}}


def segment_keys(segments):
    return [(s["id"], s["isthing"], s["category_id"], s.get("instance_id"))
            for s in segments]


def map_agreement(a: dict, b: dict):
    return (float((a["sem_seg"] == b["sem_seg"]).mean()),
            float((a["panoptic"] == b["panoptic"]).mean()))


def staged_batch(pred, images, raw: bool):
    """One batch through the predictor's stages, with a synchronise after
    each: ms of prepare (host), upload, [device resize +] forward, render +
    pack, fetch (one copy), decode (host)."""
    t = {}
    sync = torch.cuda.synchronize

    def lap(name, t0):
        sync()
        t[name] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    prep = [pred._prepare_raw(im) if raw else pred._prepare(im) for im in images]
    lap("prepare", t0)
    t0 = time.perf_counter()
    stack = pred._upload(np.stack([p[0] for p in prep]))
    sizes = pred._upload(np.array([p[1] for p in prep], np.int32))
    osizes = pred._upload(np.array([p[2] for p in prep], np.int32))
    lap("upload", t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        if raw:
            from u2seg_torch.engine.device_render import resize_image_device
            stack = torch.stack([resize_image_device(stack[i], osizes[i], sizes[i],
                                                     prep[0][3])
                                 for i in range(len(images))])
        out = pred._fwd(stack, sizes)
    lap("forward", t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        tail = pred._render_tail(out, sizes, osizes)
    lap("render_pack", t0)
    t0 = time.perf_counter()
    host = tail[0].cpu()
    lap("fetch", t0)
    group = [(i, p[0], p[1], p[2]) for i, p in enumerate(prep)]
    t0 = time.perf_counter()
    results = list(pred._drain_rendered(group, len(images), tail))
    lap("decode", t0)
    t["decode"] = max(t["decode"] - t["fetch"], 0.0)   # the drain fetched again
    t["fetch_bytes"] = int(host.numel())
    return t, (stack, out, sizes, osizes), results


def count_launches(fn, iters: int = 1):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kernels) / iters,
            sum(e.self_device_time_total for e in kernels) / 1e3 / iters)


def calibrate_render(pred, imgs, bs: int, tag: str) -> float:
    """Calibration, as for the class scores: seeded weights put no averaged
    score above the default fusion threshold of 0.5, spread them unevenly
    over the images, and draw semantic argmax maps far noisier than a
    trained model's. (1) The fusion budget is the detection cap (100, default
    50), so no image can exceed it and fall back, however its scores lie.
    (2) A pass with the threshold out of reach and run budgets no map can
    exceed gives the scores of these very batches; the threshold becomes
    their median. (3) A second pass finds the high-water mark of runs per
    batch; the fetched prefix covers it with a quarter to spare, so the
    common case stays one copy per batch. Sets ``pred.cfg`` and returns the
    threshold."""
    from u2seg_torch.config import Config

    cfg = pred.cfg
    cfg.test.render_k_fuse = cfg.model.roi_heads.detections_per_image
    cfg.model.panoptic.instance_conf_thresh = 2.0
    cfg.test.render_max_runs, cfg.test.fetch_runs_per_image = 1 << 18, 1 << 19
    first = dict(pred.run_batched(enumerate(imgs), bs, device_render=True))
    scores = np.concatenate([r["instances"]["scores"] for r in first.values()])
    thresh = float(np.median(scores))
    cfg.model.panoptic.instance_conf_thresh = thresh
    log(f"[{tag}] instance_conf_thresh set to {thresh:.4f} (median of {len(scores)} "
        f"detection scores; default 0.5), render_k_fuse to {cfg.test.render_k_fuse} "
        f"(default {Config().test.render_k_fuse}); eligible per image "
        f"{[int((r['instances']['scores'] >= thresh).sum()) for r in first.values()]}")
    pred.fetch_stats = {"fetches": 0, "bytes": 0}
    list(pred.run_batched(enumerate(imgs), bs, device_render=True))
    high = pred.fetch_stats["runs_max_batch"]
    per_image = -(-int(high * 1.25 / bs) // 1024) * 1024
    cfg.test.fetch_runs_per_image = per_image
    cfg.test.render_max_runs = max(Config().test.render_max_runs, per_image)
    log(f"[{tag}] most runs in one batch of {bs}: {high}; fetch_runs_per_image set to "
        f"{per_image} (default {Config().test.fetch_runs_per_image}), render_max_runs "
        f"to {cfg.test.render_max_runs} (default {Config().test.render_max_runs})")
    pred.fetch_stats = {"fetches": 0, "bytes": 0}
    return thresh


def phase_eval(dev):
    from u2seg_torch.config import Config
    from u2seg_torch.engine.device_render import resize_image_device
    from u2seg_torch.engine.predictor import DefaultPredictor
    from u2seg_torch.models.build import build_model
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k1

    cfg = Config()
    pred = DefaultPredictor(cfg, model=calibrate(build_model(cfg, device=dev, seed=0)))
    if pred.device.type != "cuda":
        raise AssertionError("the predictor does not run on the card")
    rng = np.random.RandomState(4)
    imgs = [scene(rng, h, w).astype(np.uint8) for h, w in EVAL_SIZES]
    bs = 4
    n_batches = 2          # 4 wide + 4 tall images: one batch per bucket

    thresh = calibrate_render(pred, imgs, bs, "eval")
    out = pred._fwd(*[pred._upload(a) for a in (
        pred._prepare(imgs[0])[0][None], np.array([[800, 1067]], np.int32))])
    if out.sem_seg_logits.dtype != torch.float32 or out.detections.mask_logits is None:
        raise AssertionError("forward(combine=False) lacks what the render needs")
    for mode in ("device_render", "device_resize"):
        list(pred.run_batched(enumerate(imgs), bs, **EVAL_MODES[mode]))
    torch.cuda.synchronize()

    res, rows = {}, {}
    for mode, kw in EVAL_MODES.items():
        stats0 = dict(pred.fetch_stats)
        k1.launches = 0                                   # the main path starts
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[mode] = dict(pred.run_batched(enumerate(imgs), bs, **kw))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = k1.launches                            # the main path ends
        d = {k: pred.fetch_stats.get(k, 0) - stats0.get(k, 0)
             for k in ("fetches", "bytes", "fallbacks", "runs")}
        row = dict(images_per_s=len(imgs) / sec, seconds=sec, k1_launches=launches,
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                   runs_max_batch=pred.fetch_stats.get("runs_max_batch", 0), **d)
        rows[mode] = row
        log(f"[eval] {mode}: {len(imgs)} images in {sec:.3f} s = {row['images_per_s']:.2f} "
            f"images/s; forward-kernel launches {launches} over {n_batches} batches; "
            f"device-to-host copies {d['fetches']}, {d['bytes'] / len(imgs):.0f} bytes "
            f"per image, {d['runs']} runs (largest batch so far "
            f"{row['runs_max_batch']} of a {bs * cfg.test.fetch_runs_per_image} prefix), "
            f"fallbacks {d['fallbacks']}; peak memory {row['peak_mib']:.0f} MiB")
        if sorted(res[mode]) != list(range(len(imgs))):
            raise AssertionError(f"{mode}: results missing")
        if launches != 4 * n_batches:
            raise AssertionError(f"{mode}: expected {4 * n_batches} K1 launches, got {launches}")
        if mode != "host" and (d["fetches"] != n_batches or d["fallbacks"]):
            raise AssertionError(f"{mode}: {d['fetches']} copies for {n_batches} batches, "
                                 f"{d['fallbacks']} fallbacks")

    # device render == host render, per image
    worst = [1.0, 1.0]
    n_things = n_stuff = 0
    for i in range(len(imgs)):
        host, devr = res["host"][i], res["device_render"][i]
        sem_ok, pan_ok = map_agreement(host, devr)
        worst = [min(worst[0], sem_ok), min(worst[1], pan_ok)]
        same = segment_keys(host["segments"]) == segment_keys(devr["segments"])
        n_things += sum(s["isthing"] for s in host["segments"])
        n_stuff += sum(not s["isthing"] for s in host["segments"])
        finite = (host["sem_seg"].shape == EVAL_SIZES[i] == devr["panoptic"].shape
                  and np.isfinite(devr["instances"]["boxes"]).all()
                  and len(devr["instances"]["scores"]) > 0)
        if not (sem_ok >= 0.999 and pan_ok >= 0.999 and same and finite):
            raise AssertionError(f"image {i}: device render != host render (sem {sem_ok:.5f}, "
                                 f"pan {pan_ok:.5f}, segments equal {same})")
    log(f"[eval] device render vs host render over 8 images: semantic maps equal on >= "
        f"{worst[0]:.5f} of pixels, panoptic maps on >= {worst[1]:.5f} (tol 0.999), segment "
        f"tables equal; {n_things} thing and {n_stuff} stuff segments painted ok")
    if n_things == 0 or n_stuff == 0:
        raise AssertionError("the scenes painted no thing or no stuff segment")

    # device resize: the resize itself against the host's, then the results
    resize_err = 0.0
    for im in imgs[:4]:
        padded, hw, ohw = pred._prepare(im)
        raw, hw2, _, bucket = pred._prepare_raw(im)
        got = resize_image_device(
            pred._upload(raw), pred._upload(np.array(ohw, np.int32)),
            pred._upload(np.array(hw2, np.int32)), bucket).cpu().numpy()
        if hw2 != hw or got.shape != padded.shape:
            raise AssertionError("device and host resize disagree on shapes")
        resize_err = max(resize_err, float(np.abs(got - padded).max()))
    agree = [map_agreement(res["device_render"][i], res["device_resize"][i])
             for i in range(len(imgs))]
    log(f"[eval] device resize vs host resize: max|diff| {resize_err:.2e} on 0..255 (tol "
        f"0.05: f32 sample coordinates up to 1344, ~1e-4 px off the host's float64 "
        f"ones, across edges of up to 255 per px); results vs device_render mode: semantic maps equal on >= "
        f"{min(a[0] for a in agree):.4f} of pixels (tol 0.95: bf16 trunk on inputs that "
        f"differ by f32 rounding; panoptic ids are not compared here: one more or "
        f"less painted instance renumbers every later segment)")
    if resize_err > 0.05 or min(a[0] for a in agree) < 0.95:
        raise AssertionError("device resize disagrees with the host resize")

    # run_batched vs __call__ (b=1: other cuDNN algorithms in bf16)
    call_agree = []
    for i in (0, 2):
        single = pred(imgs[i])
        call_agree.append(map_agreement(single, res["host"][i]))
        if len(single["instances"]["scores"]) != len(res["host"][i]["instances"]["scores"]):
            raise AssertionError("__call__ and run_batched disagree on the detections")
    log(f"[eval] __call__ (b=1) vs run_batched (b=4), host render: semantic maps equal on "
        f">= {min(a[0] for a in call_agree):.4f} of pixels (tol 0.95)")
    if min(a[0] for a in call_agree) < 0.95:
        raise AssertionError("__call__ disagrees with run_batched")

    # an image larger than the canvas takes the fallback and equals the host render
    big = scene(np.random.RandomState(9), 700, 900).astype(np.uint8)
    f0 = pred.fetch_stats.get("fallbacks", 0)
    (_, via_dev), = list(pred.run_batched([("big", big)], bs, device_render=True,
                                          device_resize=True))
    (_, via_host), = list(pred.run_batched([("big", big)], bs))
    fell = pred.fetch_stats.get("fallbacks", 0) - f0
    same = (np.array_equal(via_dev["sem_seg"], via_host["sem_seg"])
            and np.array_equal(via_dev["panoptic"], via_host["panoptic"])
            and via_dev["segments"] == via_host["segments"])
    log(f"[eval] 700x900 image (canvas {tuple(cfg.test.render_canvas)}): fallbacks {fell}, "
        f"equal to the host render {same}")
    if fell != 1 or not same:
        raise AssertionError("the over-canvas image did not take the exact fallback")

    # the stages of one batch, serial, and launches per batch
    stages = {}
    wide = [imgs[0], imgs[1], imgs[4], imgs[5]]          # one bucket: 800x1344
    for mode, raw in (("device_render", False), ("device_resize", True)):
        staged_batch(pred, wide, raw)
        t, (stack, out, sizes, osizes), _ = staged_batch(pred, wide, raw)
        total = sum(v for k, v in t.items() if k != "fetch_bytes")
        stages[mode] = dict(t, total_ms=total)
        log(f"[eval] {mode}, one batch of 4 (800x1344), stages run one after another: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items() if k != "fetch_bytes")
            + f"; sum {total:.1f} ms = {4e3 / total:.2f} images/s serial, against "
            f"{rows[mode]['images_per_s']:.2f} images/s pipelined; fetched "
            f"{t['fetch_bytes'] / 4:.0f} bytes per image")
    fwd_n, fwd_ms = count_launches(lambda: pred._fwd(stack, sizes))
    with torch.no_grad():
        ren_n, ren_ms = count_launches(lambda: pred._render_tail(out, sizes, osizes))
    log(f"[eval] kernel launches per batch of 4: forward {fwd_n:.0f} ({fwd_ms:.1f} ms of "
        f"device kernels), render + RLE + pack {ren_n:.0f} ({ren_ms:.1f} ms)")
    return dict(modes=rows, stages=stages, thresh=thresh,
                launches_per_batch=dict(forward=fwd_n, render=ren_n,
                                        forward_device_ms=fwd_ms, render_device_ms=ren_ms),
                device_vs_host=dict(sem=worst[0], pan=worst[1]),
                resize_err=resize_err, things=n_things, stuff=n_stuff)


TINY_EVAL_SIZES = ((40, 80), (80, 40)) * 2


def tiny_eval_config():
    """The tiny config in f32 with TF32 off, buckets and budgets for 40x80 /
    80x40 images, the Pallas-semantics pooler (K1 on the card)."""
    from u2seg_torch.testing import tiny_spmd_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_spmd_config()
    cfg.model.roi_heads.pooler_impl = "pallas"
    cfg.model.panoptic.instance_conf_thresh = 0.1
    cfg.model.panoptic.stuff_area_limit = 64
    cfg.input.min_size_test, cfg.input.max_size_test = 64, 128
    cfg.input.pad_buckets = ((64, 128), (128, 64))
    cfg.test.render_canvas = (80, 80)
    cfg.test.render_max_runs = 8192
    cfg.test.raw_buckets = ((80, 80),)
    return cfg


def phase_eval_cpu(dev):
    """The tiny config in f32 (TF32 off) through ``run_batched(device_render=True,
    device_resize=True)`` on the card (kernels) and on the CPU (plain versions),
    same seed, same images. Tolerances: boxes of matching records within 0.5 px and
    classes equal on >= 90% of the CPU's records (proposal ties move a few, as in
    the ``cpu`` phase); semantic maps equal on >= 99% of pixels, panoptic on >= 98%;
    segment (kind, category) lists equal on >= 3 of the 4 images."""
    from u2seg_torch.engine.predictor import DefaultPredictor

    cfg = tiny_eval_config()
    rng = np.random.RandomState(7)
    imgs = [scene(rng, h, w).astype(np.uint8) for h, w in TINY_EVAL_SIZES]
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        pred = DefaultPredictor(cfg, device=device)
        out[name] = dict(pred.run_batched(enumerate(imgs), 2, device_render=True,
                                          device_resize=True))
        if pred.fetch_stats.get("fallbacks", 0):
            raise AssertionError(f"{name}: an image took the fallback")
    det_ok = det_n = seg_same = 0
    sem_ok, pan_ok = [], []
    for i in range(len(imgs)):
        c, g = out["cpu"][i], out["gpu"][i]
        cb, gb = c["instances"]["boxes"], g["instances"]["boxes"]
        cc, gc = c["instances"]["classes"], g["instances"]["classes"]
        for j in range(len(cb)):
            d = np.where(gc == cc[j], np.abs(gb - cb[j]).max(-1), np.inf)
            det_ok += bool(len(d) and d.min() < 0.5)
        det_n += len(cb)
        a, b = map_agreement(c, g)
        sem_ok.append(a)
        pan_ok.append(b)
        seg_same += ([(s["isthing"], s["category_id"]) for s in c["segments"]]
                     == [(s["isthing"], s["category_id"]) for s in g["segments"]])
    kinds = [s["isthing"] for r in out["cpu"].values() for s in r["segments"]]
    res = dict(det_agree=det_ok / max(det_n, 1), detections=det_n, sem=min(sem_ok),
               pan=min(pan_ok), segments_equal=seg_same, things=sum(kinds),
               stuff=len(kinds) - sum(kinds))
    log(f"[eval-cpu] tiny config f32, card vs CPU through the predictor: records agreeing "
        f"(class, box < 0.5 px) {res['det_agree']:.4f} of {det_n} (tol 0.9); semantic maps "
        f"equal on >= {res['sem']:.4f} of pixels (tol 0.99), panoptic >= {res['pan']:.4f} "
        f"(tol 0.98); segment lists equal on {seg_same} of {len(imgs)} images (tol 3); "
        f"{res['things']} thing and {res['stuff']} stuff segments on the CPU")
    if not (det_n > 0 and res["det_agree"] >= 0.9 and res["sem"] >= 0.99
            and res["pan"] >= 0.98 and seg_same >= 3):
        raise AssertionError(f"card and CPU predictors disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# Phases 15 / 16: the dataset evaluation path
# ---------------------------------------------------------------------------

DATASET_SIZES = [(480, 640), (427, 640), (640, 480), (500, 375)] * 4
DATASET_NAME = "chip_smoke_synthetic_val"


class serving:
    """``run_panoptic_evaluation`` builds its predictor with the module's
    ``DefaultPredictor``; inside this block that name gives ``pred``."""

    def __init__(self, pred):
        self.pred = pred

    def __enter__(self):
        from u2seg_torch.engine import predictor

        self._saved = predictor.DefaultPredictor
        predictor.DefaultPredictor = lambda cfg, device=None: self.pred
        return self.pred

    def __exit__(self, *exc):
        from u2seg_torch.engine import predictor

        predictor.DefaultPredictor = self._saved


class Recording:
    """A predictor's ``run_batched`` that keeps each pass's outputs by image
    id and the seconds the consumer spent waiting on it (the predictor's own
    work plus its waits for the threaded reads)."""

    def __init__(self, pred):
        self.pred, self.passes, self.seconds = pred, [], 0.0

    def run_batched(self, examples, **kw):
        outputs = {}
        self.passes.append(outputs)
        it = self.pred.run_batched(examples, **kw)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            self.seconds += time.perf_counter() - t0
            if item is None:
                return
            outputs[item[0]["image_id"]] = item[1]
            yield item


class Timers:
    """Wall seconds spent in the named functions and methods while active
    (threads add up). Patched on the module or class, so the driver's
    imports inside its call see the timed versions."""

    def __init__(self, targets):
        self.targets, self.seconds, self.calls = targets, {}, {}

    def __enter__(self):
        self._saved = []
        for key, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            self.seconds[key], self.calls[key] = 0.0, 0

            def timed(*a, _fn=fn, _key=key, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.seconds[_key] += time.perf_counter() - t0
                    self.calls[_key] += 1
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def dataset_timers():
    from u2seg_torch.data import image_io
    from u2seg_torch.evaluation.coco_evaluator import COCOEvaluator
    from u2seg_torch.evaluation.panoptic_evaluator import COCOPanopticEvaluator
    from u2seg_torch.evaluation.sem_seg_evaluator import SemSegEvaluator

    return Timers({
        "image_decode": (image_io, "read_image"),
        "sem_gt_decode": (image_io, "read_sem_seg"),
        "pan_gt_decode": (image_io, "read_panoptic_png"),
        "miou_process": (SemSegEvaluator, "process"),
        "miou_evaluate": (SemSegEvaluator, "evaluate"),
        "cocoeval_process": (COCOEvaluator, "process"),
        "cocoeval_evaluate": (COCOEvaluator, "evaluate"),
        "pq_process": (COCOPanopticEvaluator, "process"),
        "pq_evaluate": (COCOPanopticEvaluator, "evaluate"),
    })


def same_metrics(a, b, atol: float = 0.0) -> bool:
    """Equal keys; values equal within ``atol``, NaN where the other is NaN."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same_metrics(a[k], b[k], atol) for k in a))
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return abs(a - b) <= atol


def metric_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over the numeric leaves both finite."""
    out = 0.0
    for k in a.keys() & b.keys():
        if isinstance(a[k], dict):
            out = max(out, metric_diff(a[k], b[k]))
        elif not isinstance(a[k], str) and np.isfinite(a[k]) and np.isfinite(b[k]):
            out = max(out, abs(float(a[k]) - float(b[k])))
    return out


def pixel_disagreement(p: dict, q: dict) -> float:
    """Share of semantic + panoptic pixels that differ between two passes."""
    n = bad = 0
    for i in p:
        for key in ("sem_seg", "panoptic"):
            n += p[i][key].size
            bad += int((p[i][key] != q[i][key]).sum())
    return bad / max(n, 1)


def min_filter_boundary(label: np.ndarray) -> np.ndarray:
    """The boundary band by an independent route (a sliding-window minimum
    over the zero-padded map), for the NaN check below."""
    from numpy.lib.stride_tricks import sliding_window_view

    h, w = label.shape
    k = max(1, int(round(0.02 * np.sqrt(h ** 2 + w ** 2))))
    x = np.pad(label.astype(np.int64), k)
    x = sliding_window_view(x, 2 * k + 1, axis=0).min(-1)
    x = sliding_window_view(x, 2 * k + 1, axis=1).min(-1)
    return label.astype(np.int64) - x


def expected_nans(gt_maps, pred_maps, mapping, n: int = 16) -> set:
    """The sem_seg keys whose value the evaluator's arithmetic makes NaN,
    counted here from the maps: class i's IoU and ACC (and the min of IoU
    and B-IoU, which is NaN only when IoU is) when no pixel has GT i and a
    prediction below the extra bin n; its Boundary IoU when no pixel has
    boundary value i on one side and below n on the other."""
    from u2seg_torch.evaluation.sem_seg_evaluator import transfer_gt_to_supercategories

    pos_gt = np.zeros(n + 1, np.int64)
    b_pos = np.zeros(n + 1, np.int64)
    for gt, pred in zip(gt_maps, pred_maps):
        sup = transfer_gt_to_supercategories(gt.astype(np.int64))
        g = np.where(sup == 255, n, np.minimum(sup, n))
        remapped = np.full(pred.shape, n, np.int64)
        for p in np.unique(pred):
            m = mapping.get(int(p), -1)
            remapped[pred == p] = m if m != -1 else n
        pos_gt += np.bincount(g[remapped < n], minlength=n + 1)
        bp = np.minimum(min_filter_boundary(remapped), n)
        bg = np.minimum(min_filter_boundary(g), n)
        b_pos += np.bincount(bg[bp < n], minlength=n + 1)
        b_pos += np.bincount(bp[bg < n], minlength=n + 1)
    out = set()
    for i in range(n):
        if pos_gt[i] == 0:
            out |= {f"IoU-{i}", f"ACC-{i}", f"min(IoU, B-Iou)-{i}"}
        if b_pos[i] == 0:
            out.add(f"BoundaryIoU-{i}")
    return out


def check_finite(res: dict, nan_ok: set) -> list:
    """Keys that are not finite where they should be, or finite where the
    arithmetic gives NaN."""
    bad = []
    for task, vals in res.items():
        for k, v in vals.items():
            if isinstance(v, str):
                continue
            want_nan = task == "sem_seg" and k in nan_ok
            if (np.isnan(v) != want_nan) or (not want_nan and not np.isfinite(v)):
                bad.append(f"{task}/{k}={v}")
    return bad


def time_cocoeval(instances_json: str, outputs: dict, n_img: int) -> dict:
    """COCOeval's own host time (bbox) on the model's boxes. The protocol's
    vote keeps none of a seeded model's boxes, so its passes never reach
    COCOeval; here every box takes part, its cluster folded onto a COCO
    thing id, in supervised mode."""
    from u2seg_torch.data.builtin_meta import thing_ids
    from u2seg_torch.evaluation.coco_api import COCO
    from u2seg_torch.evaluation.coco_evaluator import COCOEvaluator

    things = thing_ids()
    ev = COCOEvaluator(COCO(instances_json), mode="supervised", tasks=("bbox",))
    n_det = 0
    for image_id, out in outputs.items():
        inst = dict(out["instances"])
        inst["classes"] = np.array([things[int(c) % len(things)] for c in inst["classes"]])
        n_det += len(inst["classes"])
        ev.process([{"image_id": image_id}], [{"instances": inst}])
    t0 = time.perf_counter()
    res = ev.evaluate()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"[dataset-eval] COCOeval (bbox, C++ matcher) on the model's {n_det} boxes of "
        f"{n_img} images, clusters folded onto COCO thing ids: {ms:.1f} ms on the host "
        f"({ms / n_img:.2f} ms per image), AP {res['bbox']['AP']:.4f}")
    return {"detections": n_det, "ms": ms, "ms_per_image": ms / n_img}


def phase_dataset_eval(dev):
    import tempfile

    from u2seg_torch.config import Config
    from u2seg_torch.data import image_io
    from u2seg_torch.engine.predictor import DefaultPredictor, run_panoptic_evaluation
    from u2seg_torch.evaluation.hungarian import load_mapping
    from u2seg_torch.models.build import build_model
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k1
    from u2seg_torch.testing import (
        OraclePredictor, register_synthetic_coco, write_synthetic_coco,
    )

    cfg = Config()
    n_img = len(DATASET_SIZES)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ds = write_synthetic_coco(os.path.join(root, "coco"), DATASET_SIZES,
                                  np.random.RandomState(11), cfg.datasets.cluster_num)
        register_synthetic_coco(DATASET_NAME, ds)
        cfg.datasets.test = (DATASET_NAME,)
        cfg.datasets.root = os.path.join(root, "datasets")   # names only, nothing read
        files = sorted(os.listdir(ds.image_dir))
        log(f"[dataset-eval] wrote {n_img} PNG scenes ({', '.join(f'{h}x{w}' for h, w in DATASET_SIZES[:4])}, "
            f"four of each), instances, panoptic and sem-seg GT in "
            f"{time.perf_counter() - t0:.2f} s")
        decode = {}
        for key, fn, sub in (("image", lambda p: image_io.read_image(p, "RGB"), ds.image_dir),
                             ("sem_gt", image_io.read_sem_seg, ds.sem_seg_dir),
                             ("pan_gt", image_io.read_panoptic_png, ds.panoptic_dir)):
            t0 = time.perf_counter()
            for f in files:
                fn(os.path.join(sub, f))
            decode[key] = (time.perf_counter() - t0) * 1e3 / n_img
        log(f"[dataset-eval] PNG decode (Pillow) on one thread, ms per image: scene (RGB) "
            f"{decode['image']:.1f}, sem-seg GT (gray) {decode['sem_gt']:.1f}, panoptic GT "
            f"(RGB -> id) {decode['pan_gt']:.1f}")

        # (a) the oracle: the ground truth in cluster space
        with serving(OraclePredictor(cfg.datasets.cluster_num)):
            oracle = run_panoptic_evaluation(
                cfg, "auto", matching_dir=os.path.join(root, "oracle"))[DATASET_NAME]
        ap, pq, miou = (oracle["bbox"]["AP"], oracle["panoptic_seg"]["PQ"],
                        oracle["sem_seg"]["mIoU"])
        log(f"[dataset-eval] oracle predictor, auto: bbox/AP {ap:.6f}, panoptic_seg/PQ "
            f"{pq:.6f} (tol 100 +- 1e-4), sem_seg/mIoU {miou:.6f} (tol > 99)")
        if abs(ap - 100) > 1e-4 or abs(pq - 100) > 1e-4 or not miou > 99:
            raise AssertionError(f"the oracle does not score 100: {oracle}")

        # the model at full width, calibrated on these very images
        pred = DefaultPredictor(cfg, model=calibrate(build_model(cfg, device=dev, seed=0)))
        imgs = [image_io.read_image(os.path.join(ds.image_dir, f), cfg.model.input_format)
                for f in files]
        bs = cfg.test.ims_per_batch
        n_batches = 2 * -(-(n_img // 2) // bs)            # two buckets, half each
        thresh = calibrate_render(pred, imgs, bs, "dataset-eval")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(pred.run_batched(enumerate(imgs), bs, device_render=cfg.test.device_render,
                              device_resize=cfg.test.device_resize))
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0

        runs, rows, launches_total = {}, {}, 0
        for label, modes in (("two_pass", ("hungarian_matching", "eval")), ("auto", ("auto",))):
            mdir = os.path.join(root, label)
            rec = Recording(pred)
            for mode in modes:
                stats0 = dict(pred.fetch_stats)
                rec.seconds = 0.0
                torch.cuda.reset_peak_memory_stats(dev)
                with dataset_timers() as tm, serving(rec):
                    k1.launches = 0                       # the main path starts
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = run_panoptic_evaluation(cfg, mode,
                                                  matching_dir=mdir)[DATASET_NAME]
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                    launches = k1.launches                # the main path ends
                launches_total += launches
                d = {k: pred.fetch_stats.get(k, 0) - stats0.get(k, 0)
                     for k in ("fetches", "fallbacks")}
                ms = {k: v * 1e3 / n_img for k, v in tm.seconds.items()}
                row = dict(images_per_s=n_img / sec, seconds=sec, k1_launches=launches,
                           batches=n_batches, copies=d["fetches"], fallbacks=d["fallbacks"],
                           stream_ms=rec.seconds * 1e3 / n_img,
                           predictor_alone_ms=alone_s * 1e3 / n_img,
                           peak_mib=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                           ms_per_image=ms, keys=sorted(res))
                rows[f"{label}:{mode}"] = row
                log(f"[dataset-eval] {label} pass {mode}: {n_img} images in {sec:.3f} s = "
                    f"{row['images_per_s']:.2f} images/s end to end (reads, GT, evaluation "
                    f"included); ms per image: image decode {ms['image_decode']:.1f}, GT decode "
                    f"{ms['sem_gt_decode'] + ms['pan_gt_decode']:.1f} (sem "
                    f"{ms['sem_gt_decode']:.1f}, panoptic {ms['pan_gt_decode']:.1f}; on "
                    f"{cfg.dataloader.num_workers} reader threads), predictor stream "
                    f"{row['stream_ms']:.1f} (waits for reads included; "
                    f"{row['predictor_alone_ms']:.1f} on decoded images), evaluator process: "
                    f"mIoU {ms['miou_process']:.1f}, COCO {ms['cocoeval_process']:.2f}, PQ "
                    f"{ms['pq_process']:.2f}; evaluate(): mIoU {ms['miou_evaluate']:.1f}, "
                    f"COCOeval {ms['cocoeval_evaluate']:.1f}, PQ {ms['pq_evaluate']:.1f}; K1 "
                    f"launches {launches} over {n_batches} batches, device-to-host copies "
                    f"{d['fetches']}, fallbacks {d['fallbacks']}; peak memory "
                    f"{row['peak_mib']:.0f} MiB; metrics {sorted(res)}")
                if launches != 4 * n_batches:
                    raise AssertionError(f"{mode}: expected {4 * n_batches} K1 launches, "
                                         f"got {launches}")
                if d["fetches"] != n_batches or d["fallbacks"]:
                    raise AssertionError(f"{mode}: {d['fetches']} copies for {n_batches} "
                                         f"batches, {d['fallbacks']} fallbacks")
                if sorted(rec.passes[-1]) != sorted(ds.image_ids):
                    raise AssertionError(f"{mode}: outputs missing")
            for f in ("instance_mapping.json", "semantic_mapping.json"):
                if not os.path.exists(os.path.join(mdir, f)):
                    raise AssertionError(f"{label}: {f} was not written")
            runs[label] = (res, rec.passes)

        two, auto = runs["two_pass"], runs["auto"]
        differ = max(pixel_disagreement(two[1][0], auto[1][0]),
                     pixel_disagreement(two[1][1], auto[1][0]))
        same = same_metrics(two[0], auto[0])
        log(f"[dataset-eval] two-pass (hungarian_matching, then eval) vs auto: metric dicts "
            f"{'equal' if same else 'DIFFER'} (largest difference {metric_diff(two[0], auto[0]):.3g}); "
            f"the three forwards' maps differ on {differ:.6f} of pixels (tol 0.001)")
        if differ > 1e-3:
            raise AssertionError("the forwards of the passes disagree")
        if not same:
            raise AssertionError(f"two-pass and auto disagree: {two[0]} vs {auto[0]}")
        gt = {i: image_io.read_sem_seg(os.path.join(ds.sem_seg_dir, f"{i:012d}.png"))
              for i in ds.image_ids}
        mapping = load_mapping(os.path.join(root, "auto", "semantic_mapping.json"))
        nan_ok = expected_nans([gt[i] for i in ds.image_ids],
                               [auto[1][0][i]["sem_seg"] for i in ds.image_ids], mapping)
        bad = check_finite(auto[0], nan_ok)
        flat = {f"{t}/{k}": v for t, vals in auto[0].items() for k, v in vals.items()
                if "-" not in k}
        log(f"[dataset-eval] model metrics (seeded weights, no meaning beyond the path): "
            + ", ".join(f"{k} {v:.4f}" for k, v in flat.items())
            + f"; NaN where expected: {len(nan_ok)} per-class keys; not so: {bad}")
        if bad:
            raise AssertionError(f"metrics not finite where they should be: {bad}")
        cocoeval = time_cocoeval(ds.instances_json, auto[1][0], n_img)
    from u2seg_torch.data.catalog import DatasetCatalog
    DatasetCatalog.remove(DATASET_NAME)
    return dict(rows=rows, decode_ms=decode, oracle=dict(ap=ap, pq=pq, miou=miou),
                thresh=thresh, pixels_differ=differ, launches=launches_total,
                metrics=flat, nan_keys=sorted(nan_ok), cocoeval=cocoeval)


def phase_dataset_eval_cpu(dev):
    """``run_panoptic_evaluation`` of the tiny config in f32 (TF32 off) on a
    4-image synthetic set, on the card (kernels) and on the CPU (plain
    versions), the same seeded weights, ``device_render=True,
    device_resize=True``. Tolerances: on every image the semantic maps equal
    on >= 99% of pixels and the panoptic maps on >= 98%, as in phase
    ``eval_cpu``; the summary metrics (keys without a class index) within
    0.5 points (measured: maps differ on 0.00004 of pixels, metrics by 0).
    The CPU's maps must be far enough from zero that zeroed maps from the
    card would fail the pixel gate; the per-class keys are printed by their
    largest difference only."""
    import tempfile

    from u2seg_torch.engine.predictor import DefaultPredictor, run_panoptic_evaluation
    from u2seg_torch.testing import register_synthetic_coco, write_synthetic_coco

    cfg = tiny_eval_config()
    cfg.datasets.cluster_num = 800        # stuff ids stay clear of COCO thing ids
    out, passes = {}, {}
    with tempfile.TemporaryDirectory() as root:
        ds = write_synthetic_coco(os.path.join(root, "coco"), TINY_EVAL_SIZES,
                                  np.random.RandomState(12), cfg.datasets.cluster_num)
        register_synthetic_coco(DATASET_NAME, ds)
        cfg.datasets.test = (DATASET_NAME,)
        cfg.datasets.root = os.path.join(root, "datasets")
        cfg.test.ims_per_batch = 2
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            with serving(Recording(DefaultPredictor(cfg, device=device))) as rec:
                out[name] = run_panoptic_evaluation(
                    cfg, "auto", device=device,
                    matching_dir=os.path.join(root, name))[DATASET_NAME]
            passes[name] = rec.passes[0]
            if rec.pred.fetch_stats.get("fallbacks", 0):
                raise AssertionError(f"{name}: an image took the fallback")
    from u2seg_torch.data.catalog import DatasetCatalog
    DatasetCatalog.remove(DATASET_NAME)
    cpu, gpu = passes["cpu"], passes["gpu"]
    differ = pixel_disagreement(cpu, gpu)
    agree = [map_agreement(cpu[i], gpu[i]) for i in cpu]
    sem, pan = min(a[0] for a in agree), min(a[1] for a in agree)
    zeroed = [map_agreement(cpu[i], {k: np.zeros_like(cpu[i][k])
                                     for k in ("sem_seg", "panoptic")}) for i in cpu]
    zsem, zpan = min(a[0] for a in zeroed), min(a[1] for a in zeroed)
    summary = {t: {k: v for k, v in vals.items() if "-" not in k}
               for t, vals in out["cpu"].items()}
    summary_gpu = {t: {k: v for k, v in vals.items() if "-" not in k}
                   for t, vals in out["gpu"].items()}
    ok = same_metrics(summary, summary_gpu, atol=0.5)
    res = dict(pixels_differ=differ, sem=sem, pan=pan, zeroed_sem=zsem, zeroed_pan=zpan,
               summary_diff=metric_diff(summary, summary_gpu),
               all_diff=metric_diff(out["cpu"], out["gpu"]), keys=sorted(out["cpu"]))
    log(f"[dataset-eval-cpu] tiny config f32, run_panoptic_evaluation card vs CPU: "
        f"semantic maps equal on >= {sem:.5f} of pixels (tol 0.99), panoptic >= {pan:.5f} "
        f"(tol 0.98), {differ:.5f} of all pixels differ; zeroed maps would agree on "
        f">= {zsem:.5f} / {zpan:.5f}; summary metrics {'agree' if ok else 'DISAGREE'} "
        f"(largest difference {res['summary_diff']:.4g}, tol 0.5 points; NaN where the "
        f"other is NaN), per-class keys differ by <= {res['all_diff']:.4g}; CPU: " + ", ".join(
            f"{t}/{k} {v:.3f}" for t, vals in summary.items() for k, v in vals.items()))
    if zsem >= 0.99 and zpan >= 0.98:
        raise AssertionError("the CPU's maps are nearly all zero: the pixel gate is blind")
    if not (sem >= 0.99 and pan >= 0.98):
        raise AssertionError(f"card and CPU maps disagree: {res}")
    if not ok:
        raise AssertionError(f"card and CPU evaluations disagree: {out}")
    return res



# ---------------------------------------------------------------------------
# training from files: train_net, --resume, --eval-only
# ---------------------------------------------------------------------------

TRAIN_NET_SIZES = EVAL_SIZES * 4          # 32 scenes, the eval phase's four sizes
TRAIN_NET_STEPS, TRAIN_NET_RESUMED = 8, 10
TRAIN_NET_VAL = "chip_smoke_train_net_val"
U2SEG_YAML = os.path.join(HERE, "configs", "COCO-PanopticSegmentation", "u2seg_R50_800.yaml")


class TimedLoader:
    """The train loader as ``DefaultTrainer`` draws from it: the wall time of
    each ``next()`` (the step's wait for data) and the kernel counts at each
    call, and every batch's mask patches and boxes checked on the way."""

    def __init__(self, loader, keep: bool = False):
        self.loader, self.keep = loader, keep
        self.waits, self.counts, self.batches, self.bad = [], [], [], []

    def __iter__(self):
        return self

    def __next__(self):
        self.counts.append(kernel_counts())
        t0 = time.perf_counter()
        b = next(self.loader)
        self.waits.append((time.perf_counter() - t0) * 1e3)
        valid, masks, boxes = b["gt_valid"], b["gt_masks"], b["gt_boxes"]
        hw = b["image_size"][:, None, :].astype(np.float32)
        inside = ((boxes[..., :2] >= 0) & (boxes[..., 2:] <= hw[..., ::-1])
                  & (boxes[..., 2:] > boxes[..., :2])).all(-1)
        if masks.min() < 0 or masks.max() > 1 or not inside[valid].all():
            self.bad.append(len(self.waits) - 1)
        if self.keep:
            self.batches.append(b)
        return b

    def close(self):
        getattr(self.loader, "close", lambda: None)()


class loader_probe:
    """Inside this block ``train_net.build_train_loader`` hands out its
    loader wrapped in a ``TimedLoader`` (``self.loaders``, in order)."""

    def __init__(self, keep: bool = False):
        self.keep, self.loaders = keep, []

    def __enter__(self):
        from u2seg_torch.tools import train_net

        self._saved = train_net.build_train_loader

        def build(cfg):
            self.loaders.append(TimedLoader(self._saved(cfg), self.keep))
            return self.loaders[-1]

        train_net.build_train_loader = build
        return self

    def __exit__(self, *exc):
        from u2seg_torch.tools import train_net

        train_net.build_train_loader = self._saved


def forget_dataset(name: str) -> None:
    """Drop the panoptic-separated dataset ``name`` and its ``_stuffonly``
    view from the port's catalogs: ``register_all_coco`` keeps the first
    registration of a name, and phase dataset_eval registers the U2Seg names
    under another (by now deleted) root."""
    from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog

    for n in (name, name.replace("_separated", "_stuffonly")):
        if n in DatasetCatalog:
            DatasetCatalog.remove(n)
        if n in MetadataCatalog.list():
            MetadataCatalog.remove(n)


def per_step_launches(tl: TimedLoader, end) -> list:
    """(K1, K3) launched by each step: a step runs between two draws."""
    marks = tl.counts + [end]
    return [(b[0] - a[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]


def mapper_stages(cfg, dicts) -> dict:
    """ms per image of ``DatasetMapper`` on one thread, by stage: file reads
    (image, sem-seg map), augment (sampling, which resizes the image to feed
    the next augmentation, then the image's own transform), instances (each
    mask decoded or rasterised, transformed and cut to its patch), and the
    rest (sem-seg transform, boxes, bucket rescale, padding, f32)."""
    from u2seg_torch.data import mapper as mapper_mod
    from u2seg_torch.data import transforms as T

    m = mapper_mod.DatasetMapper(cfg, is_train=True)
    rng = np.random.RandomState(0)
    with Timers({"read_image": (mapper_mod, "read_image"),
                 "read_sem_seg": (mapper_mod, "read_sem_seg"),
                 "sample": (T.AugmentationList, "get_transform"),
                 "apply_image": (T.TransformList, "apply_image"),
                 "instances": (mapper_mod.DatasetMapper, "_patch")}) as tm:
        t0 = time.perf_counter()
        for d in dicts:
            m(d, rng)
        total = time.perf_counter() - t0
    n = len(dicts)
    ms = {k: v * 1e3 / n for k, v in tm.seconds.items()}
    out = dict(read=ms["read_image"] + ms["read_sem_seg"],
               augment=ms["sample"] + ms["apply_image"], instances=ms["instances"],
               total=total * 1e3 / n, instances_per_image=tm.calls["instances"] / n)
    out["rest"] = out["total"] - out["read"] - out["augment"] - out["instances"]
    return out


def phase_train_net(dev, bare_ms=None):
    """``python -m u2seg_torch.tools.train_net`` at full width, called as
    ``train_net.main(argv)``: u2seg_R50_800.yaml with ims_per_batch 2 and 4
    loader threads, on 32 files of ``write_synthetic_u2seg_train`` (the eval
    sizes), starting from ``model.weights`` (a file of the seeded model), 8
    iterations, ``--resume`` to 10, then ``--eval-only --eval-mode auto`` on
    a 16-image synthetic val set with the last checkpoint as
    ``model.weights`` and the test score threshold at 0."""
    import tempfile

    from u2seg_torch.config import load_config
    from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic
    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.engine import predictor as tpred
    from u2seg_torch.engine.checkpoint import load_reference_state_dict
    from u2seg_torch.models.build import build_model
    from u2seg_torch.testing import (
        register_synthetic_coco, write_synthetic_coco, write_synthetic_u2seg_train,
    )
    from u2seg_torch.tools import benchmark, train_net

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "datasets")
        ds = write_synthetic_u2seg_train(data, TRAIN_NET_SIZES, 800, seed=21)
        forget_dataset(ds.dataset)
        val = write_synthetic_coco(os.path.join(tmp, "val"), DATASET_SIZES,
                                   np.random.RandomState(13), 800)
        register_synthetic_coco(TRAIN_NET_VAL, val)
        log(f"[train_net] wrote {len(TRAIN_NET_SIZES)} training scenes (JPEG, CutLER RLE "
            f"and polygon instances, 4-20 per image and one image of 105, one crowd "
            f"region, stuff maps) and a {len(DATASET_SIZES)}-image val set in "
            f"{time.perf_counter() - t0:.1f} s")
        out = os.path.join(tmp, "out")
        init = os.path.join(tmp, "init.pth")
        base = [f"datasets.root={data}", "solver.ims_per_batch=2",
                "dataloader.num_workers=4", f"output_dir={out}",
                f"datasets.train=[{ds.dataset}]"]
        cfg = load_config(U2SEG_YAML, base)
        torch.save({"model": build_model(cfg, device="cpu", seed=0).state_dict()}, init)

        # the loader alone and the mapper's stages
        loader_rows = {}
        for workers in (0, 4):
            cfg.dataloader.num_workers = workers
            loader_rows[workers] = benchmark.benchmark_data(cfg, iters=10)
        cfg.dataloader.num_workers = 4
        dicts = merge_to_panoptic(load_coco_json(ds.instances_json, ds.image_dir),
                                  load_sem_seg(ds.sem_seg_dir, ds.image_dir))
        stages = mapper_stages(cfg, dicts[:8])
        log(f"[train_net] the loader alone (benchmark --task data, 10 batches of 2 after one): "
            + ", ".join(f"{r['images_per_sec']:.1f} images/s at num_workers {w}"
                        for w, r in loader_rows.items())
            + f"; DatasetMapper on one thread, ms per image: read {stages['read']:.1f}, "
            f"augment {stages['augment']:.1f} (sampling resizes the image once, the "
            f"transform again), instances {stages['instances']:.1f} "
            f"({stages['instances_per_image']:.1f} masks), pad and the rest "
            f"{stages['rest']:.1f}; total {stages['total']:.1f}")
        same = []
        firsts = []
        for _ in range(2):
            it = train_net.build_train_loader(cfg)
            firsts.append([next(it) for _ in range(4)])
            it.close()
        for a, b in zip(*firsts):
            same.append(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a))
        log(f"[train_net] two loaders of one seed at 4 threads: first 4 batches "
            f"{'identical' if all(same) else 'DIFFER'}")
        if not all(same):
            raise AssertionError(f"two loaders of one seed differ: {same}")

        # train, resume, evaluate
        # flags first: the config overrides take the rest of the command line
        argv = lambda *flags: ["--config-file", U2SEG_YAML, *flags] + base
        torch.cuda.reset_peak_memory_stats(dev)
        with loader_probe() as probe:
            reset_kernel_counts()                        # the main path starts
            t0 = time.perf_counter()
            tr = train_net.main(argv("--max-iter", str(TRAIN_NET_STEPS))
                                + [f"model.weights={init}"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            end = kernel_counts()                        # the main path ends
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            steps = per_step_launches(probe.loaders[0], end)
            totals = [v for v, _ in tr.storage.history("total_loss").values()]
            timer = [v * 1e3 for v, _ in tr.storage.history("time").values()]
            waits = probe.loaders[0].waits
            bad = probe.loaders[0].bad
            probe.loaders[0].close()
            ckpt = tr.checkpointer.get_checkpoint_file()
            del tr
            torch.cuda.empty_cache()
            reset_kernel_counts()                        # the resumed path starts
            tr2 = train_net.main(argv("--resume", "--max-iter", str(TRAIN_NET_RESUMED)))
            end2 = kernel_counts()                       # the resumed path ends
            steps2 = per_step_launches(probe.loaders[1], end2)
            totals2 = [v for v, _ in tr2.storage.history("total_loss").values()]
            start2, ckpt2 = tr2.start_iter, tr2.checkpointer.get_checkpoint_file()
            bad += probe.loaders[1].bad
            waits2 = probe.loaders[1].waits
            probe.loaders[1].close()
            del tr2
            torch.cuda.empty_cache()
        last = os.path.join(out, ckpt2)
        res.update(loader=loader_rows, mapper_ms=stages, steps=steps, resumed_steps=steps2,
                   totals=totals + totals2, timer_ms=timer, wait_ms=waits + waits2,
                   peak_mib=peak, train_s=train_s, start_iter=start2, ckpts=[ckpt, ckpt2],
                   launches=dict(k1=sum(s[0] for s in steps + steps2),
                                 k3=sum(s[1] for s in steps + steps2)))
        timer_med = float(np.median(timer)) if timer else float("nan")
        log(f"[train_net] train_net.main, u2seg_R50_800.yaml at full width (SyncBN on one "
            f"rank, 800 clusters, bf16), b=2, 4 loader threads: {TRAIN_NET_STEPS} steps, "
            f"total losses " + ", ".join(f"{v:.4f}" for v in totals)
            + f"; then --resume from {ckpt}: start_iter {start2}, "
            + ", ".join(f"{v:.4f}" for v in totals2)
            + f"; K1/K3 launches per step {steps + steps2}; peak memory {peak:.0f} MiB")
        log(f"[train_net] step time from IterationTimer (steps 3-{TRAIN_NET_STEPS - 1}): median "
            f"{timer_med:.1f} ms ({', '.join(f'{v:.1f}' for v in timer)})"
            + (f"; phase train's bare step in this run: median {bare_ms:.1f} ms -> ratio "
               f"{timer_med / bare_ms:.3f}" if bare_ms else "")
            + f"; the trainer's wait for data per step (next() on the loader): "
            + ", ".join(f"{v:.1f}" for v in waits + waits2) + " ms")

        # --eval-only on the last checkpoint, render budgets calibrated on it.
        # Ten steps move the BN statistics far from the seeded init, and no
        # class score of an untrained 801-way softmax reaches 0.05: with no
        # detection no instance mapping is written, and the panoptic
        # evaluator of an auto run stops (ROADMAP.md section 3). The
        # threshold goes to 0: the top-2048 candidates still bound the work.
        ev = [f"model.weights={last}", f"datasets.test=[{TRAIN_NET_VAL}]",
              "model.roi_heads.score_thresh_test=0.0"]
        ecfg = load_config(U2SEG_YAML, base + ev)
        pred = tpred.DefaultPredictor(ecfg)
        imgs = [read_image(os.path.join(val.image_dir, f"{i:012d}.png"))
                for i in val.image_ids]
        thresh = calibrate_render(pred, imgs, ecfg.test.ims_per_batch, "train_net")
        t = ecfg.test
        ev += [f"model.panoptic.instance_conf_thresh={thresh}",
               f"test.render_k_fuse={t.render_k_fuse}", f"test.render_max_runs={t.render_max_runs}",
               f"test.fetch_runs_per_image={t.fetch_runs_per_image}"]
        del pred
        torch.cuda.empty_cache()
        built = []
        real = tpred.DefaultPredictor

        def recording(cfg, model=None, device=None):
            built.append(real(cfg, model=model, device=device))
            return built[-1]

        tpred.DefaultPredictor = recording
        try:
            reset_kernel_counts()                        # the eval-only path starts
            t0 = time.perf_counter()
            metrics = train_net.main(argv("--eval-only", "--eval-mode", "auto") + ev)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_k1 = kernel_counts()[0]                 # the eval-only path ends
        finally:
            tpred.DefaultPredictor = real
        saved = load_reference_state_dict(last)
        sd = {k: v.cpu() for k, v in built[0].model.state_dict().items()}
        on_ckpt = set(sd) == set(saved) and all(torch.equal(sd[k], saved[k]) for k in sd)
        seeded = build_model(ecfg, device="cpu", seed=0).state_dict()
        differ = sum(not torch.equal(sd[k], seeded[k]) for k in sd)
        flat = {f"{t_}/{k}": v for t_, vals in metrics[TRAIN_NET_VAL].items()
                for k, v in vals.items() if "-" not in k}
        n_val = len(DATASET_SIZES)
        res.update(eval_images_per_s=n_val / eval_s, eval_s=eval_s, eval_k1=eval_k1,
                   eval_on_checkpoint=on_ckpt, eval_differs_from_seeded=differ,
                   eval_metrics=flat)
        log(f"[train_net] --eval-only --eval-mode auto on {ckpt2}: {n_val} images in "
            f"{eval_s:.2f} s = {n_val / eval_s:.2f} images/s end to end (model build and "
            f"checkpoint load included), K1 launches {eval_k1}; the predictor held the "
            f"checkpoint's tensors: {on_ckpt} ({differ} of {len(sd)} differ from the seeded "
            f"init); metrics " + ", ".join(f"{k} {v:.4f}" for k, v in flat.items()))
    from u2seg_torch.data.catalog import DatasetCatalog
    DatasetCatalog.remove(TRAIN_NET_VAL)
    all_steps = res["steps"] + res["resumed_steps"]
    problems = []
    if not (len(res["totals"]) == TRAIN_NET_RESUMED and all(np.isfinite(res["totals"]))):
        problems.append(f"losses {res['totals']}")
    if any(s != (4, 4) for s in all_steps) or len(all_steps) != TRAIN_NET_RESUMED:
        problems.append(f"K1/K3 launches per step {all_steps}")
    if res["start_iter"] != TRAIN_NET_STEPS or res["ckpts"] != [
            f"model_{TRAIN_NET_STEPS - 1:07d}", f"model_{TRAIN_NET_RESUMED - 1:07d}"]:
        problems.append(f"resume: start_iter {res['start_iter']}, checkpoints {res['ckpts']}")
    if not (res["eval_on_checkpoint"] and res["eval_differs_from_seeded"] > 0):
        problems.append("--eval-only did not run on the checkpoint's tensors")
    if res["eval_k1"] < 4:
        problems.append(f"--eval-only launched K1 {res['eval_k1']} times")
    if bad:
        problems.append(f"patches outside [0, 1] or boxes outside their image in batches {bad}")
    bad_metrics = [k for k, v in res["eval_metrics"].items()
                   if not (np.isfinite(v) or np.isnan(v))]
    if "sem_seg/mIoU" not in res["eval_metrics"] or bad_metrics:
        problems.append(f"eval metrics {res['eval_metrics']}")
    log(f"[train_net] gates: finite losses, 4 + 4 launches per step, resume at "
        f"{TRAIN_NET_STEPS}, eval-only on the checkpoint, patches in [0, 1] and boxes "
        f"inside their image: {'ok' if not problems else 'FAIL ' + '; '.join(problems)}")
    if problems:
        raise AssertionError("train_net failed: " + "; ".join(problems))
    res.update(timer_median_ms=timer_med, bare_ms=bare_ms)
    return res


def tiny_train_net_config():
    """The tiny config of phase train_cpu (f32, TF32 off, the Pallas-semantics
    pooler, every candidate sampled) over 7 clusters and 28 stuff classes,
    trained from small files: 64x96 buckets keep the RPN's anchors under its
    2048 samples, so no random draw matters on either device."""
    from u2seg_torch.testing import tiny_spmd_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_spmd_config()
    m = cfg.model
    m.roi_heads.pooler_impl = "pallas"
    m.rpn.batch_size_per_image, m.rpn.positive_fraction = 2048, 0.5
    m.roi_heads.batch_size_per_image, m.roi_heads.positive_fraction = 256, 0.5
    m.sem_seg_head.num_classes = 28
    m.max_gt_instances = 24
    cfg.input.min_size_train, cfg.input.max_size_train = (48, 64), 96
    cfg.input.pad_buckets = ((64, 96), (96, 64))
    cfg.solver.ims_per_batch, cfg.solver.max_iter = 2, 2
    cfg.dataloader.num_workers = 2
    cfg.datasets.cluster_num = 7
    cfg.datasets.train = ("u2seg_7_train_panoptic_separated",)
    return cfg


def phase_train_net_cpu(dev):
    """``train_net.main`` of the tiny config, 2 steps, on the card and with
    ``--device cpu``, from the same files: the two loaders hand out the same
    batches, and each step's losses agree at phase train_cpu's tolerance
    (rtol 1e-3)."""
    import tempfile

    from u2seg_torch.config import save_config
    from u2seg_torch.testing import write_synthetic_u2seg_train
    from u2seg_torch.tools import train_net

    cfg = tiny_train_net_config()
    losses, batches, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "datasets")
        ds = write_synthetic_u2seg_train(data, [(60, 80), (48, 64), (80, 60), (64, 48)], 7, seed=0)
        cfg.datasets.root = data
        path = os.path.join(tmp, "tiny.yaml")
        save_config(cfg, path)
        for name, device in (("cpu", "cpu"), ("gpu", "cuda")):
            forget_dataset(ds.dataset)
            with loader_probe(keep=True) as probe:
                reset_kernel_counts()
                tr = train_net.main(["--config-file", path, "--device", device,
                                     f"output_dir={os.path.join(tmp, name)}"])
                launches[name] = kernel_counts()
            losses[name] = {k: [v for v, _ in h.values()]
                            for k, h in tr.storage.histories().items() if k.startswith(("loss", "total"))}
            batches[name] = probe.loaders[0].batches
            probe.loaders[0].close()
    same_batches = len(batches["cpu"]) == len(batches["gpu"]) == 2 and all(
        all(np.array_equal(a[k], b[k]) for k in a) for a, b in zip(batches["cpu"], batches["gpu"]))
    worst = max(abs(g - c) / max(abs(c), 1e-6) for k in losses["cpu"]
                for c, g in zip(losses["cpu"][k], losses["gpu"][k]))
    keys_ok = sorted(losses["cpu"]) == sorted(losses["gpu"]) == sorted(LOSS_KEYS + ["total_loss"])
    log(f"[train_net_cpu] tiny config f32, train_net.main 2 steps on the card and with --device "
        f"cpu: loader batches {'identical' if same_batches else 'DIFFER'}; largest relative "
        f"loss difference {worst:.2e} (tol 1e-3); card K1/K3 launches {launches['gpu']}; "
        f"total losses cpu {losses['cpu']['total_loss']} card {losses['gpu']['total_loss']}")
    if not (same_batches and keys_ok and worst <= 1e-3 and launches["gpu"] == (8, 8)):
        raise AssertionError(f"train_net card vs CPU: {losses}, {launches}")
    return dict(worst_rel=worst, launches=dict(k1=launches["gpu"][0], k3=launches["gpu"][1]))



PSEUDO_SIZES = EVAL_SIZES[:4] * 64        # 256 scenes, 8 instances each: 2048 crops
PSEUDO_CLUSTERS = 800
SCALE_N, SCALE_D, SCALE_K, SCALE_KNN, SCALE_ITERS = 131072, 768, 800, 20, 100


def gaussian_features(n: int, d: int, centres: int, spread: float, seed: int, dev):
    """n seeded rows of dimension d around ``centres`` standard normal centres
    (noise ``spread`` per coordinate), drawn on ``dev``; and their labels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn(centres, d, generator=g, device=dev)
    labels = torch.randint(0, centres, (n,), generator=g, device=dev)
    return c[labels] + spread * torch.randn(n, d, generator=g, device=dev), labels


def purity(labels: np.ndarray, assign: np.ndarray) -> float:
    """Share of rows whose found cluster's majority true label is theirs."""
    order = np.lexsort((labels, assign))
    a, l = assign[order], labels[order]
    pairs, counts = np.unique(np.stack([a, l]), axis=1, return_counts=True)
    best = np.zeros(a.max() + 1, np.int64)
    np.maximum.at(best, pairs[0], counts)
    return float(best.sum() / len(labels))


class panoptic_readback:
    """Inside this block every panoptic PNG the tool writes is read back at
    once and compared with the map it was written from (``self.bad`` lists
    the files that differ; ``self.seconds`` is the time the checks took)."""

    def __enter__(self):
        from u2seg_torch.data import image_io
        from u2seg_torch.pseudo import assembly

        self._saved, self.count, self.bad, self.seconds = assembly.write_panoptic_png, 0, [], 0.0

        def write(pan, path):
            self._saved(pan, path)
            t0 = time.perf_counter()
            self.count += 1
            if not np.array_equal(image_io.read_panoptic_png(path), pan):
                self.bad.append(path)
            self.seconds += time.perf_counter() - t0
        assembly.write_panoptic_png = write
        return self

    def __exit__(self, *exc):
        from u2seg_torch.pseudo import assembly

        assembly.write_panoptic_png = self._saved


def clustering_at_scale(dev) -> dict:
    """``knn`` + k-means++ + Lloyd + ``select_representatives_regularized`` at
    N = 131072, D = 768, K = 800, k = 20, 100 iterations, cosine, on features
    around 800 centres; the k-means twice from one generator seed."""
    from u2seg_torch.pseudo import kmeans as km

    feats, labels = gaussian_features(SCALE_N, SCALE_D, SCALE_K, 0.1, 5, dev)
    torch.cuda.synchronize()
    out, runs = {}, []
    t0 = time.perf_counter()
    dists, _ = km.knn(feats, SCALE_KNN)
    density = km.density_from_knn(dists)
    torch.cuda.synchronize()
    out["knn_s"] = time.perf_counter() - t0
    for _ in range(2):
        g = torch.Generator(device=dev).manual_seed(1)
        t0 = time.perf_counter()
        x = km._normalize(feats)
        init = km._kmeans_pp_init(x, SCALE_K, "cosine", g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, assign = km.lloyd(x, init, SCALE_ITERS, "cosine")
        torch.cuda.synchronize()
        runs.append((t1 - t0, time.perf_counter() - t1, assign.cpu().numpy()))
    out["seed_s"], out["lloyd_s"] = runs[0][0], runs[0][1]
    out["seed_s_2"], out["lloyd_s_2"] = runs[1][0], runs[1][1]
    out["repeat_equal"] = bool(np.array_equal(runs[0][2], runs[1][2]))
    out["purity"] = purity(labels.cpu().numpy(), runs[0][2])
    t0 = time.perf_counter()
    sel = km.select_representatives_regularized(
        feats, runs[0][2], np.maximum(density.cpu().numpy().astype(np.float64), 1e-12), SCALE_K)
    out["select_s"] = time.perf_counter() - t0
    out["selected"] = len(sel)
    # the bounds: each Lloyd step's assign and sums are an N x K x D product
    # each; the kNN an N x N x D one (f32 outside the tensor cores)
    out["knn_bound_s"] = 2 * SCALE_N * SCALE_N * SCALE_D / PEAK_F32_FLOPS
    out["lloyd_bound_s"] = SCALE_ITERS * 4 * SCALE_N * SCALE_K * SCALE_D / PEAK_F32_FLOPS
    return out


def phase_pseudo(dev):
    """``python -m u2seg_torch.tools.generate_pseudo_labels`` at full width,
    called as ``main(argv)``, stages cluster, assign, panoptic, stuff, then
    supergt, on 256 synthetic scenes (the eval sizes) with 8 CutLER-style
    RLE instances each (2048 crops), 27-label STEGO maps and a GT panoptic
    JSON: ViT-B/16 from a seeded DINO ``.pth`` (``--dino-weights``), crop
    224, batch 64, facet k, 800 clusters, k 20, 100 iterations, selection on;
    then the clustering alone at N = 131072."""
    import tempfile

    from u2seg_torch.data.builtin_meta import STUFF_TO_SUPERCATEGORY
    from u2seg_torch.data.image_io import read_sem_seg
    from u2seg_torch.pseudo import assembly
    from u2seg_torch.engine.checkpoint import load_reference_state_dict
    from u2seg_torch.pseudo.dino import DinoViT, load_dino_state_dict, seeded_dino_state
    from u2seg_torch.testing import write_synthetic_pseudo_inputs
    from u2seg_torch.tools import generate_pseudo_labels as tool

    k = PSEUDO_CLUSTERS
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ds = write_synthetic_pseudo_inputs(os.path.join(root, "data"), PSEUDO_SIZES,
                                           instances_per_image=8, seed=0)
        weights = os.path.join(root, "dino_vitbase16.pth")   # DINO's names, 224 px grid
        torch.save(seeded_dino_state(DinoViT(), seed=0).state_dict(), weights)
        log(f"[pseudo] wrote {len(PSEUDO_SIZES)} scenes' {len(ds.keys)} crops, RLE instances, "
            f"STEGO maps, GT panoptic JSON and a seeded ViT-B/16 .pth in "
            f"{time.perf_counter() - t0:.1f} s")
        out = os.path.join(root, "out")
        argv = ["--num-clusters", str(k), "--crops-dir", ds.crops_dir, "--dino-weights", weights,
                "--decode-json", os.path.join(out, "decode.json"),
                "--select-json", os.path.join(out, "select.json"),
                "--instances-json", ds.instances_json,
                "--output-json", os.path.join(out, "curated.json"),
                "--stego-dir", ds.stego_dir, "--panoptic-dir", os.path.join(out, "panoptic"),
                "--panoptic-json", os.path.join(out, "panoptic.json"),
                "--stuff-dir", os.path.join(out, "stuff"),
                "--gt-panoptic-json", ds.gt_panoptic_json,
                "--super-json", os.path.join(out, "super.json")]
        seen = {}
        embed = tool.embed_crops

        def recording(*a, **kw):
            seen["feats"], read_s = embed(*a, **kw)
            return seen["feats"], read_s

        tool.embed_crops = recording
        torch.cuda.reset_peak_memory_stats()
        try:
            with panoptic_readback() as rb, Timers({
                    "merge": (assembly, "merge_instances_and_stego"),
                    "to_semantic": (assembly, "panoptic_to_semantic")}) as tm:
                t0 = time.perf_counter()
                res = tool.main(["--stage", "all"] + argv)
                stage_s = time.perf_counter() - t0
                res.update(tool.main(["--stage", "supergt"] + argv))
        finally:
            tool.embed_crops = embed
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        feats = seen["feats"]
        cl = res["cluster"]
        n = cl["crops"]

        def load(name):
            with open(os.path.join(out, name)) as f:
                return json.load(f)

        decode, curated, gt, sup = (load("decode.json"), load("curated.json"),
                                    load(ds.gt_panoptic_json), load("super.json"))
        failures = []
        if tuple(feats.shape) != (len(ds.keys), 768) or not bool(torch.isfinite(feats).all()):
            failures.append(f"features {tuple(feats.shape)}, finite {bool(torch.isfinite(feats).all())}")
        if sorted(decode) != ds.keys or not all(0 <= v < k for v in decode.values()):
            failures.append("decode JSON: keys or ids")
        if sorted(f"{a['image_id']}_{a['id']}" for a in curated["annotations"]) != sorted(decode):
            failures.append("class-aware JSON keys")
        if rb.bad or rb.count != len(PSEUDO_SIZES):
            failures.append(f"panoptic PNGs read back: {rb.count} written, {len(rb.bad)} differ")
        stuff_dir = os.path.join(out, "stuff")
        values = set()
        for f in sorted(os.listdir(stuff_dir)):
            values |= set(np.unique(read_sem_seg(os.path.join(stuff_dir, f))).tolist())
        if not values <= set(range(28)) | {255} or len(os.listdir(stuff_dir)) != len(PSEUDO_SIZES):
            failures.append(f"semantic PNG values {sorted(values)}")
        for a, b in zip(gt["annotations"], sup["annotations"]):
            for s, t in zip(a["segments_info"], b["segments_info"]):
                c = s["category_id"]
                want = k + STUFF_TO_SUPERCATEGORY[c] if c in STUFF_TO_SUPERCATEGORY else c
                if t["category_id"] != want or (c in STUFF_TO_SUPERCATEGORY
                                                and not k < want <= k + 15):
                    failures.append(f"supergt: {c} -> {t['category_id']}")
        sel = load("select.json")

        # DINO alone: device ms per batch of 64 at 224 px, f32
        model = DinoViT()
        load_dino_state_dict(model, load_reference_state_dict(weights), grid_hw=(14, 14))
        model.to(dev).eval()
        x = torch.randn(64, 3, 224, 224, device=dev)
        with torch.no_grad():
            dino_ms = cuda_ms(lambda: model(x), iters=5)
        del model, x
    n_img = len(PSEUDO_SIZES)
    # stages panoptic and stuff per image, the read-back checks taken out
    assembly_ms = (res["panoptic"]["s"] - rb.seconds + res["stuff"]["s"]) * 1e3 / n_img
    stage1_s = cl["embed_s"] + cl["knn_s"] + cl["kmeans_s"] + cl["select_s"]
    log(f"[pseudo] generate_pseudo_labels.main, ViT-B/16 f32 crop 224 batch 64, {n} crops, "
        f"{k} clusters: stage 1 {n / stage1_s:.1f} crops/s ({stage1_s:.2f} s; model build + "
        f".pth load {cl['setup_s']:.2f} s before it): embed {cl['embed_s']:.2f} s, of which "
        f"read + resize on the host {cl['read_s'] * 1e3 / n:.2f} ms per crop; kNN "
        f"{cl['knn_s']:.3f} s, k-means {cl['kmeans_s']:.3f} s, selection {cl['select_s']:.3f} s "
        f"({len(sel['selected_keys'])} picked)")
    log(f"[pseudo] DINO ViT-B/16 alone: {dino_ms:.2f} ms per batch of 64 (device, f32, "
        f"17.6 GFLOP a crop: {64 * 17.6e9 / (dino_ms * 1e-3) / 1e12:.1f} TFLOP/s)")
    log(f"[pseudo] assembly {assembly_ms:.2f} ms per image over {n_img} (stage panoptic "
        f"{(res['panoptic']['s'] - rb.seconds) * 1e3 / n_img:.2f}, of which merge "
        f"{tm.seconds['merge'] * 1e3 / n_img:.2f}; stage stuff "
        f"{res['stuff']['s'] * 1e3 / n_img:.2f}, of which to semantic "
        f"{tm.seconds['to_semantic'] * 1e3 / n_img:.2f}); assign {res['assign']['s']:.2f} s, "
        f"supergt {res['supergt']['s']:.2f} s; stages 1-4 {stage_s:.1f} s; peak memory "
        f"{peak:.0f} MiB")

    torch.cuda.reset_peak_memory_stats()
    sc = clustering_at_scale(dev)
    scale_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[pseudo] clustering at N={SCALE_N}, D={SCALE_D}, K={SCALE_K}, k={SCALE_KNN}, "
        f"{SCALE_ITERS} iterations, cosine: kNN {sc['knn_s']:.3f} s (f32 bound "
        f"{sc['knn_bound_s']:.3f}), k-means++ {sc['seed_s']:.3f} / {sc['seed_s_2']:.3f} s, "
        f"Lloyd {sc['lloyd_s']:.3f} / {sc['lloyd_s_2']:.3f} s (bound {sc['lloyd_bound_s']:.3f}), "
        f"selection {sc['select_s']:.3f} s ({sc['selected']} picked); purity "
        f"{sc['purity']:.4f}; two runs of one seed {'equal' if sc['repeat_equal'] else 'DIFFER'}; "
        f"peak memory {scale_peak:.0f} MiB")
    if sc["purity"] <= 0.9 or not sc["repeat_equal"]:
        failures.append(f"at scale: purity {sc['purity']}, repeat {sc['repeat_equal']}")
    if failures:
        raise AssertionError(f"pseudo: {failures}")
    return dict(crops=n, stage1_s=stage1_s, crops_per_s=n / stage1_s, cluster=cl,
                dino_ms_per_64=dino_ms, assembly_ms_per_image=assembly_ms, stages_s=stage_s,
                peak_mib=peak, scale=sc, scale_peak_mib=scale_peak)


def phase_pseudo_cpu(dev):
    """Card against CPU, f32 with TF32 off: ViT-B/16 patch features of 16 crops
    (relative L2 <= 1e-4); kNN indices at N=8192, D=768 (>= 99.9% equal);
    Lloyd from the same k-means++ centroids (assignments equal); stages 2-5
    of the tool with ``--device cuda`` and ``--device cpu`` from one decode
    JSON (files equal byte for byte)."""
    import tempfile

    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.data.transforms import resize_bilinear_u8
    from u2seg_torch.pseudo import kmeans as km
    from u2seg_torch.pseudo.dino import (
        IMAGENET_MEAN, IMAGENET_STD, DinoViT, seeded_dino_state,
    )
    from u2seg_torch.testing import write_synthetic_pseudo_inputs
    from u2seg_torch.tools import generate_pseudo_labels as tool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    failures = []
    with tempfile.TemporaryDirectory() as root:
        ds = write_synthetic_pseudo_inputs(os.path.join(root, "data"), EVAL_SIZES[:2],
                                           instances_per_image=8, seed=3)
        crops = np.stack([resize_bilinear_u8(read_image(os.path.join(ds.crops_dir, kk + ".png")),
                                             224, 224) for kk in ds.keys])
        mean = torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)
        x = (torch.from_numpy(crops).permute(0, 3, 1, 2).float() / 255.0 - mean) / std
        model = seeded_dino_state(DinoViT(), seed=0).eval()
        with torch.no_grad():
            want = model(x)[1]
            got = model.to(dev)(x.to(dev))[1].cpu()
        del model
        feat_rel = float((got - want).norm() / want.norm())
        if feat_rel > 1e-4:
            failures.append(f"patch features {feat_rel}")

        feats, _ = gaussian_features(8192, 768, 64, 1.0, 7, cpu)
        _, idx_cpu = km.knn(feats, 20)
        _, idx_gpu = km.knn(feats.to(dev), 20)
        knn_equal = float((idx_gpu.cpu() == idx_cpu).float().mean())
        if knn_equal < 0.999:
            failures.append(f"kNN indices {knn_equal}")
        x = km._normalize(feats)
        init = km._kmeans_pp_init(x, 64, "cosine", torch.Generator().manual_seed(2))
        _, a_cpu = km.lloyd(x, init, 20)
        _, a_gpu = km.lloyd(x.to(dev), init.to(dev), 20)
        lloyd_equal = bool(torch.equal(a_gpu.cpu(), a_cpu))
        if not lloyd_equal:
            failures.append(f"Lloyd assignments differ on {int((a_gpu.cpu() != a_cpu).sum())}")

        decode = os.path.join(root, "decode.json")
        common = ["--num-clusters", "8", "--seed", "1", "--crops-dir", ds.crops_dir,
                  "--decode-json", decode, "--instances-json", ds.instances_json,
                  "--stego-dir", ds.stego_dir, "--gt-panoptic-json", ds.gt_panoptic_json]
        tool.main(["--stage", "cluster", "--kmeans-iters", "10"] + common)
        trees = {}
        for device in ("cuda", "cpu"):
            o = os.path.join(root, device)
            mine = ["--device", device, "--output-json", os.path.join(o, "curated.json"),
                    "--panoptic-dir", os.path.join(o, "panoptic"),
                    "--panoptic-json", os.path.join(o, "panoptic.json"),
                    "--stuff-dir", os.path.join(o, "stuff"),
                    "--super-json", os.path.join(o, "super.json")]
            os.makedirs(o)
            for stage in ("assign", "panoptic", "stuff", "supergt"):
                tool.main(["--stage", stage] + common + mine)
            trees[device] = {}
            for d, _, files in os.walk(o):
                for f in files:
                    with open(os.path.join(d, f), "rb") as fh:
                        trees[device][os.path.relpath(os.path.join(d, f), o)] = fh.read()
        files_equal = trees["cuda"] == trees["cpu"] and len(trees["cpu"]) == 3 + 2 * len(EVAL_SIZES[:2])
        if not files_equal:
            failures.append("assembly outputs differ")
    log(f"[pseudo_cpu] f32, TF32 off, card vs CPU: ViT-B/16 patch features of {len(ds.keys)} crops "
        f"relative L2 {feat_rel:.2e} (tol 1e-4); kNN indices N=8192 D=768 k=20 equal on "
        f"{knn_equal * 100:.3f}% (tol 99.9%); Lloyd from the same k-means++ centroids (K=64, "
        f"20 iterations): assignments {'equal' if lloyd_equal else 'DIFFER'}; stages 2-5 "
        f"--device cuda vs cpu: {len(trees['cpu'])} files {'equal' if files_equal else 'DIFFER'}")
    if failures:
        raise AssertionError(f"pseudo_cpu: {failures}")
    return dict(feat_rel=feat_rel, knn_equal=knn_equal, lloyd_equal=lloyd_equal,
                files_equal=files_equal)


# ---------------------------------------------------------------------------
# Phases 21 / 22: the detector families of the model zoo
# ---------------------------------------------------------------------------

ZOO_SMALL_HW = (512, 832)
ZOO_TIMED = 5
# (zoo file, loss + backward, batch, (H, W), backbone name put in its place)
ZOO_FULL = (("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml", True, 2, TRAIN_HW, None),
            ("COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml", True, 2, TRAIN_HW, None),
            ("COCO-Detection/retinanet_R_50_FPN_1x.yaml", True, 2, TRAIN_HW, None),
            ("COCO-Detection/fcos_R_50_FPN_1x.yaml", True, 2, TRAIN_HW, None),
            ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", False, 2, TRAIN_HW, None),
            ("Misc/mask_rcnn_R_50_FPN_3x_gn.yaml", False, 2, TRAIN_HW, None),
            ("Misc/mask_rcnn_regnetx_4gf_fpn_3x.yaml", True, 2, TRAIN_HW, None),
            ("Misc/mask_rcnn_swin_t_fpn_3x.yaml", True, 2, TRAIN_HW, None),
            # its LSJ pad bucket, which its pos_embed is made for
            ("ViTDet/mask_rcnn_vitdet_b_100ep.yaml", True, 2, (1024, 1024), None),
            # no zoo file names MViTFPN; its stage 0 attends from every
            # stride-4 token to a quarter of them (27 GB of f32 scores per
            # block at b=2, 800x1344), so it runs at b=1, 512x832
            ("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml", True, 1, ZOO_SMALL_HW,
             "MViTFPN"))
ATTENTION_MODULES = ("vit", "swin", "mvit")


def pools_per_forward(cfg) -> int:
    """K1 launches of one forward (or K1 and K3 of one loss + backward):
    one per ROI pool, 0 for the meta-architectures that pool nothing."""
    m = cfg.model
    if m.meta_architecture not in ("GeneralizedRCNN", "PanopticFPN"):
        return 0
    rh = m.roi_heads
    box = len(rh.cascade_ious) if rh.name == "CascadeROIHeads" else 1
    return box + int(rh.mask_on) + int(rh.keypoint_on)


def zoo_calibrate(m) -> None:
    """Seeded heads score below the 0.05 test thresholds (the R-CNN softmax
    over 81 classes is near uniform, the dense heads sit at their 0.01
    prior), so the thresholds of the model config ``m`` (which a built
    model's heads share) go to 0: every candidate enters the NMS."""
    m.roi_heads.score_thresh_test = 0.0
    m.retinanet.score_thresh = 0.0
    m.fcos.score_thresh = 0.0


def output_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    det = getattr(out, "detections", out)
    ts = [det.boxes, det.scores[det.valid]]          # empty slots score -inf
    ts += [t for t in (det.mask_logits, det.keypoints) if t is not None]
    if hasattr(out, "sem_seg_logits"):
        ts.append(out.sem_seg_logits)
    return ts


def forward_profile(fn, iters: int = 2) -> dict:
    """torch.profiler over ``iters`` warm calls of ``fn``: wall ms, summed
    device-kernel ms and the device's busy share per call, launches per
    call, the 3 kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return dict(wall_ms=wall, device_ms=dev_ms, busy=dev_ms / wall,
                launches=sum(e.count for e in kernels) / iters,
                top=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3 / iters)
                     for e in top])


def zoo_train_batch(cfg, b: int, h: int, w: int):
    """``train_batch`` with 17 keypoints per box (visible, inside it) for the
    keypoint configs."""
    batch = train_batch(cfg, b, h, w)
    if cfg.model.keypoint_on:
        rng = np.random.RandomState(3)
        boxes = batch.gt.boxes.numpy()
        u = rng.rand(*boxes.shape[:2], 17, 2)
        xy = boxes[..., None, :2] + u * (boxes[..., None, 2:] - boxes[..., None, :2])
        vis = np.full(xy.shape[:-1] + (1,), 2.0)
        batch.gt.keypoints = torch.from_numpy(np.concatenate([xy, vis], -1).astype(np.float32))
    return batch


def zoo_grad_groups(model):
    if hasattr(model, "roi_heads"):
        groups = (["backbone.net", "backbone.simfp_"] if hasattr(model.backbone, "net")
                  else ["backbone.bottom_up", "backbone.fpn_"])
        groups += ["proposal_generator", "roi_heads.box_head", "roi_heads.box_predictor"]
        groups += [f"roi_heads.{h}" for h in ("mask_head", "keypoint_head")
                   if hasattr(model.roi_heads, h)]
    else:
        groups = ["backbone.bottom_up", "backbone.fpn_", "backbone.top_block",
                  "head.cls_subnet", "head.bbox_subnet", "head.cls_score", "head.bbox_pred"]
        groups += ["head.ctrness"] if model.head.ctrness is not None else []
    out = {}
    for prefix in groups:
        grads = [p.grad.float() for k, p in model.named_parameters()
                 if k.startswith(prefix) and p.grad is not None]
        out[prefix] = float(torch.sqrt(sum((g ** 2).sum() for g in grads))) if grads else 0.0
    return out


def zoo_model(rel: str, backbone, dev):
    """``model_zoo.get`` of a zoo file, or its config with another backbone
    built through ``build_model``."""
    from u2seg_torch import model_zoo
    from u2seg_torch.models.build import build_model

    if backbone is None:
        return model_zoo.get(rel, device=dev)
    cfg = model_zoo.get_config(rel)
    cfg.model.backbone.name = backbone
    return build_model(cfg, device=dev), cfg


def attention_profile(fn) -> dict:
    """Device ms of the trunk's attention (``models.vit.attention``: q @ k^T,
    softmax, @ v, and the bias/mask adds) in one call of ``fn``: every
    attention call of it re-run alone on its own inputs (CUDA events, the
    mean of 3 runs after a warm one) and summed; 0 calls where the model
    has none."""
    import importlib

    mods = [importlib.import_module(f"u2seg_torch.models.{m}") for m in ATTENTION_MODULES]
    plain = mods[0].attention
    calls = []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    for m in mods:
        m.attention = recorded
    try:
        fn()
    finally:
        for m in mods:
            m.attention = plain
    with torch.no_grad():
        ms = sum(cuda_ms(lambda: plain(*a, **k), iters=3, warmup=1) for a, k in calls)
    return dict(calls=len(calls), ms=ms)


def phase_zoo(dev):
    """The detector families through ``model_zoo.get`` at full width (bf16,
    seeded weights, numpy-drawn scenes), each row of ZOO_FULL at its batch
    and size (b=2 at 800x1344; ViTDet at its 1024x1024 bucket; MViT b=1 at
    512x832): 3 warm forwards and ZOO_TIMED timed ones (each synchronised;
    the median is printed), peak memory, a profile of the forward and of the
    trunk's attention; then one ``model(..., train=True)`` loss +
    ``backward()`` on 20 drawn boxes with 64x64 mask patches (and 17
    keypoints each) where the row asks for it. Then every other YAML of the
    zoo: one b=1 forward at 512x832. Fails unless the outputs are finite,
    every full-width forward keeps detections, every head's gradient is
    finite and non-zero, K1 launches once per ROI pool of every forward and
    K1 + K3 once per pool of every loss + backward, and all 31 zoo files
    build."""
    from u2seg_torch import model_zoo
    from u2seg_torch.ops import roi_align_ml as rap

    k1, k3 = rap.multilevel_roi_align_kernel, rap.multilevel_roi_align_backward
    # PyTorch's defaults (earlier phases turn TF32 off): the dense heads'
    # f32 convs take TF32, matmuls stay f32
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    rows, failures = [], []
    launches = {"k1": 0, "k3": 0}

    def counted(fn, want_k1, want_k3=0, tag=""):
        k1.launches = k3.launches = 0                     # the main path starts
        out = fn()
        torch.cuda.synchronize()
        got = (k1.launches, k3.launches)                  # the main path ends
        launches["k1"] += got[0]
        launches["k3"] += got[1]
        if got != (want_k1, want_k3):
            failures.append(f"{tag}: K1/K3 launches {got}, expected {(want_k1, want_k3)}")
        return out

    t_phase = time.perf_counter()
    for rel, train, b, (h, w), backbone in ZOO_FULL:
        torch.cuda.empty_cache()
        model, cfg = zoo_model(rel, backbone, dev)
        name = f"{rel} ({backbone})" if backbone else rel
        zoo_calibrate(model.cfg)
        pools = pools_per_forward(cfg)
        rng = np.random.RandomState(4)
        img = torch.from_numpy(np.stack([scene(rng, h, w) for _ in range(b)])).to(dev)
        sz = torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev)
        for _ in range(3):
            model(img, sz)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(ZOO_TIMED):
            t0 = time.perf_counter()
            out = counted(lambda: model(img, sz), pools, tag=f"{name} forward {i}")
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        finite = all(bool(torch.isfinite(t).all()) for t in output_tensors(out))
        n_det = int(out.valid.sum())
        row = dict(config=rel, backbone=cfg.model.backbone.name, batch=b, hw=[h, w],
                   meta=cfg.model.meta_architecture, ms=float(np.median(times)),
                   ms_all=times, peak_mib=peak, detections=n_det, k1_per_forward=pools,
                   profile=forward_profile(lambda: model(img, sz)),
                   attention=attention_profile(lambda: model(img, sz)))
        prof, attn = row["profile"], row["attention"]
        msg = (f"[zoo] {name}: b={b} {h}x{w} bf16 forward {row['ms']:.2f} ms (median of "
               f"{ZOO_TIMED}; {min(times):.2f}-{max(times):.2f}), peak {peak:.0f} MiB, "
               f"{n_det} detections, K1 {pools} per forward; profiled {prof['wall_ms']:.1f} ms "
               f"with {prof['device_ms']:.2f} ms of kernels (busy {prof['busy']:.3f}), "
               f"{prof['launches']:.0f} launches, top: " + ", ".join(
                   f"{t['name'][:40]} {t['ms']:.2f}" for t in prof["top"])
               + (f"; trunk attention {attn['ms']:.2f} ms of device time in {attn['calls']} "
                  f"calls (each re-run alone)" if attn["calls"] else ""))
        if not (finite and n_det > 0):
            failures.append(f"{name}: finite={finite} detections={n_det}")
        if train:
            model.train()
            model.zero_grad(set_to_none=True)
            batch = zoo_train_batch(cfg, b, h, w).to(dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()

            def loss_and_backward():
                losses = model(batch.images, batch.image_sizes, gt=batch.gt, train=True,
                               generator=gen)
                sum(losses.values()).backward()
                return losses

            losses = counted(loss_and_backward, pools, pools, tag=f"{name} train")
            row["train_ms"] = (time.perf_counter() - t0) * 1e3
            row["train_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            row["losses"] = {k: float(v.detach()) for k, v in losses.items()}
            row["grad_norms"] = norms = zoo_grad_groups(model)
            ok = (all(np.isfinite(v) for v in row["losses"].values())
                  and all(np.isfinite(v) and v > 0 for v in norms.values()))
            if not ok:
                failures.append(f"{name} train: losses {row['losses']}, gradient norms {norms}")
            msg += (f"; loss + backward {row['train_ms']:.1f} ms (first call), peak "
                    f"{row['train_peak_mib']:.0f} MiB, K1/K3 {pools}/{pools}, losses "
                    + ", ".join(f"{k[5:]} {v:.4f}" for k, v in row["losses"].items())
                    + "; gradient norms " + ", ".join(f"{k} {v:.2e}" for k, v in norms.items()))
        log(msg + (" ok" if not failures else " FAIL"))
        rows.append(row)
        del model, out
    full_s = time.perf_counter() - t_phase

    others = []
    sh, sw = ZOO_SMALL_HW
    img = torch.from_numpy(scene(np.random.RandomState(5), sh, sw))[None].to(dev)
    sz = torch.tensor([[sh, sw]], dtype=torch.int32, device=dev)
    full = {row[0] for row in ZOO_FULL if row[4] is None}
    t0 = time.perf_counter()
    for rel in model_zoo.list_configs():
        if rel in full:
            continue
        model, cfg = model_zoo.get(rel, device=dev)
        out = counted(lambda: model(img, sz), pools_per_forward(cfg), tag=rel)
        if not all(bool(torch.isfinite(t).all()) for t in output_tensors(out)):
            failures.append(f"{rel}: non-finite outputs")
        others.append(rel)
        del model, out
        torch.cuda.empty_cache()
    others_s = time.perf_counter() - t0
    built = len(full) + len(others)
    log(f"[zoo] every other YAML: {len(others)} built, b=1 {sh}x{sw} forward each "
        f"({others_s:.1f} s with the builds); {built} of {len(model_zoo.list_configs())} "
        f"zoo files built in all")
    if built != 31 or len(model_zoo.list_configs()) != 31:
        failures.append(f"built {built} of {len(model_zoo.list_configs())} zoo files")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[zoo] K1 launches {launches['k1']}, K3 launches {launches['k3']} "
        f"({full_s:.1f} s for the full-width configs)")
    if failures:
        raise AssertionError(f"zoo: {failures}")
    return dict(rows=rows, others=others, built=built, launches=launches,
                full_s=full_s, others_s=others_s)


# narrow trunks of the four transformer and RegNet backbones (tiny_zoo_config)
TINY_TRUNKS = {
    "ViTDet": dict(vit_dim=64, vit_depth=3, vit_num_heads=2, vit_window_size=3,
                   vit_global_blocks=(1,)),
    "SwinFPN": dict(embed_dim=32, depths=(2, 2, 2, 2), trunk_num_heads=(1, 2, 2, 2)),
    "MViTFPN": dict(embed_dim=32, depths=(1, 2, 1, 1), trunk_num_heads=(1, 1, 2, 2)),
    "RegNetFPN": dict(regnet_w_a=8.0, regnet_w_0=8, regnet_w_m=2.0, regnet_depth=6,
                      regnet_group_width=8),
}


def tiny_zoo_config(meta: str, backbone: str = "ResNetFPN", hw=(128, 128), **heads):
    """A narrow config of one meta-architecture in f32 with the kernels'
    pooler: 8 bottleneck blocks (or a TINY_TRUNKS trunk, built for ``hw``),
    32-channel FPN, 7 box classes, 5 dense and stuff classes; sampling sizes
    that take every candidate; the test score thresholds at 0
    (``zoo_calibrate``)."""
    from u2seg_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.meta_architecture = meta
    m.compute_dtype = "float32"
    m.resnet.depth = 18
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.resnet.norm = "FrozenBN"
    m.fpn.out_channels = 32
    m.fpn.norm = ""
    m.rpn.pre_nms_topk_test = m.rpn.pre_nms_topk_train = 64
    m.rpn.post_nms_topk_test = m.rpn.post_nms_topk_train = 64
    m.rpn.batch_size_per_image, m.rpn.positive_fraction = 2048, 0.5
    rh = m.roi_heads
    rh.batch_size_per_image, rh.positive_fraction = 256, 0.5
    rh.pooler_impl = "pallas"
    rh.num_classes = 7
    rh.box_head.fc_dim = 64
    rh.mask_head.conv_dim = 32
    rh.keypoint_head.conv_dims = (16, 16)
    rh.detections_per_image = 20
    m.retinanet.num_classes = m.fcos.num_classes = 5
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    rh.name = heads.get("name", "StandardROIHeads")
    rh.mask_on = m.mask_on = heads.get("mask_on", True)
    rh.keypoint_on = m.keypoint_on = heads.get("keypoint_on", False)
    m.backbone.name = backbone
    for k, v in TINY_TRUNKS.get(backbone, {}).items():
        setattr(m.backbone, k, v)
    cfg.input.pad_buckets = (tuple(hw),)
    zoo_calibrate(m)
    return cfg


ZOO_CPU_CASES = (("mask_keypoint", "GeneralizedRCNN", {"keypoint_on": True}),
                 ("cascade_mask", "GeneralizedRCNN", {"name": "CascadeROIHeads"}),
                 ("retinanet", "RetinaNet", {}), ("fcos", "FCOS", {}),
                 ("rpn", "ProposalNetwork", {}), ("sem", "SemanticSegmentor", {}),
                 ("vitdet", "GeneralizedRCNN", {"backbone": "ViTDet"}),
                 ("swin", "GeneralizedRCNN", {"backbone": "SwinFPN"}),
                 ("mvit", "GeneralizedRCNN", {"backbone": "MViTFPN"}),
                 ("regnet", "GeneralizedRCNN", {"backbone": "RegNetFPN"}))


def phase_zoo_cpu(dev):
    """The six meta-architectures at a tiny config in f32 (TF32 off), on the
    card (kernels) and on the CPU (plain versions), from the same seeded
    weights and a b=2 128x128 batch with 3 gt boxes (mask patches, 17
    keypoints). (a) What follows the trunk on the CPU trunk's features: the
    ROI heads on the CPU's proposals (detections: validity and classes
    equal, boxes, scores, mask logits and keypoints rtol 1e-4 with atol 1e-4
    * max, phase cpu's cascade tolerance), the dense heads' detections (the
    same), the RPN's proposals (>= 95% within 0.01 px, phase cpu's), the
    sem-seg logits (1e-3 of max, phase cpu's). (b) The loss dict of one
    train forward, every candidate sampled: each loss rtol 1e-3 (phase
    train_cpu's whole-step tolerance). (c) For the four trunk twins (Mask
    R-CNN over tiny ViTDet, Swin, MViT and RegNet trunks): every pyramid
    level of the card's own trunk against the CPU's, 1e-4 of max."""
    from u2seg_torch.models.build import build_model
    from u2seg_torch.structures.instances import GtInstances

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(6)
    hw, b, g = 128, 2, 3
    images = torch.from_numpy((rng.rand(b, hw, hw, 3) * 255).astype(np.float32))
    sizes = torch.tensor([[hw, hw], [120, 100]], dtype=torch.int32)
    xy = rng.rand(b, g, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(b, g, 2) * 50 + 10], -1).astype(np.float32)
    kp = np.concatenate([boxes[..., None, :2] + rng.rand(b, g, 17, 2) * 10,
                         np.full((b, g, 17, 1), 2.0)], -1).astype(np.float32)
    gt = GtInstances(torch.from_numpy(boxes), torch.from_numpy(rng.randint(0, 5, (b, g))),
                     torch.ones(b, g, dtype=torch.bool),
                     torch.from_numpy(rng.rand(b, g, 32, 32).astype(np.float32)),
                     torch.from_numpy(kp))
    sem = torch.from_numpy(rng.randint(0, 5, (b, hw, hw)))
    res, failures = {}, []

    def rel_err(a, c):
        return float((a.float() - c.float()).abs().max()) / max(float(c.float().abs().max()), 1e-30)

    for case, meta, heads in ZOO_CPU_CASES:
        cfg = tiny_zoo_config(meta, **heads)
        cpu = build_model(cfg, device="cpu", seed=3)
        gpu = build_model(cfg, device=dev, seed=3)
        r = {}
        with torch.no_grad():
            fc = cpu.features(images)
            fg = {k: v.to(dev) for k, v in fc.items()}
            if "backbone" in heads:
                # the trunk and its pyramid on the card against the CPU
                own = gpu.features(images.to(dev))
                r["levels_err"] = max(rel_err(own[k].cpu(), fc[k]) for k in fc)
            if meta == "GeneralizedRCNN":
                p = cpu.proposal_generator(fc, sizes)
                args = (p.proposal_boxes, p.proposal_scores, p.proposal_valid)
                c = cpu.roi_heads(fc, *args, sizes)
                d = gpu.roi_heads(fg, *(a.to(dev) for a in args), sizes.to(dev)).to("cpu")
            elif meta in ("RetinaNet", "FCOS"):
                c = cpu._detector[0](fc, sizes)
                d = gpu._detector[0](fg, sizes.to(dev)).to("cpu")
            elif meta == "ProposalNetwork":
                c = cpu.proposal_generator(fc, sizes)
                d = gpu.proposal_generator(fg, sizes.to(dev))
                err = (c.proposal_boxes - d.proposal_boxes.cpu()).abs().amax(-1)
                r["proposal_agree"] = float(((err < 1e-2) & c.proposal_valid).sum()
                                            / c.proposal_valid.sum())
            else:
                c, d = cpu.sem_seg_head(fc), gpu.sem_seg_head(fg).cpu()
                r["sem_err"] = rel_err(d, c)
        if meta in ("GeneralizedRCNN", "RetinaNet", "FCOS"):
            r["equal_valid_classes"] = bool(torch.equal(c.valid, d.valid)
                                            and torch.equal(c.classes, d.classes))
            r["detections"] = int(c.valid.sum())
            for name in ("boxes", "scores", "mask_logits", "keypoints"):
                if getattr(c, name) is not None:
                    r[f"{name}_err"] = rel_err(getattr(d, name), getattr(c, name))
            ok = (r["equal_valid_classes"] and r["detections"] > 0
                  and all(v <= 1e-4 for k, v in r.items() if k.endswith("_err")))
        elif meta == "ProposalNetwork":
            ok = r["proposal_agree"] >= 0.95
        else:
            ok = r["sem_err"] <= 1e-3

        losses = {}
        for name, model in (("cpu", cpu), ("gpu", gpu)):
            device = next(model.parameters()).device
            model.train()
            if meta == "SemanticSegmentor":
                out = model(images.to(device), sizes.to(device), sem_seg_gt=sem.to(device),
                            train=True)
            else:
                out = model(images.to(device), sizes.to(device), gt=gt.to(device), train=True,
                            generator=torch.Generator(device=device).manual_seed(0))
            losses[name] = {k: float(v.detach()) for k, v in out.items()}
        r["loss_err"] = max(abs(losses["gpu"][k] / losses["cpu"][k] - 1) for k in losses["cpu"])
        r["losses"] = sorted(losses["cpu"])
        ok = ok and r["loss_err"] <= 1e-3 and sorted(losses["gpu"]) == r["losses"]
        log(f"[zoo_cpu] {case} ({meta}): " + ", ".join(
            f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()
            if k != "losses") + f"; losses {', '.join(r['losses'])} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(case)
        res[case] = r
        del cpu, gpu
    if failures:
        raise AssertionError(f"zoo_cpu: card and CPU disagree on {failures}: {res}")
    return res


# ---------------------------------------------------------------------------
# The twelfth slice: rotation augmentation, FixMatch, rotated boxes, the
# project heads and rethinking-BN
# ---------------------------------------------------------------------------

AUGMENT_STEPS = 4
SEMISUP_LABELED, SEMISUP_MU, SEMISUP_CLUSTERS, SEMISUP_SIDE = 8, 7, 800, 224
SEMISUP_STEPS, FINETUNE_STEPS = 4, 2
ROTATED_HW, ROTATED_R, ROTATED_NMS = (800, 1216), 1000, 1000
DEFORM_SHAPE = (2, 128, 100, 168)            # res3 of an 800x1344 image, b=2
DEEPLAB_HW, DEEPLAB_CLASSES = (512, 1024), 19  # DeepLab's Cityscapes crop
CITYSCAPES_THINGS = tuple(range(11, 19))     # person ... bicycle
MASK_RCNN_YAML = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def phase_augment(dev, steps: int = AUGMENT_STEPS):
    """``train_net.main`` on u2seg_R50_800.yaml with ``input.rotation_enabled
    =True`` (RandomRotation in [-30, 30] degrees, expand, after the resize),
    ims_per_batch 2, 4 loader threads, over 32 files of
    ``write_synthetic_u2seg_train``: ``steps`` iterations with finite losses
    and 4 K1 + 4 K3 launches each. Also the mapper's ms per image with and
    without rotation, and ``RandomExtent`` on the same images."""
    import tempfile

    from u2seg_torch.config import load_config
    from u2seg_torch.data import transforms as T
    from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic
    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.testing import write_synthetic_u2seg_train
    from u2seg_torch.tools import train_net

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "datasets")
        ds = write_synthetic_u2seg_train(data, TRAIN_NET_SIZES, 800, seed=21)
        forget_dataset(ds.dataset)
        base = [f"datasets.root={data}", "solver.ims_per_batch=2", "dataloader.num_workers=4",
                f"output_dir={os.path.join(tmp, 'out')}", f"datasets.train=[{ds.dataset}]"]
        rot = ["input.rotation_enabled=True"]
        cfg = load_config(U2SEG_YAML, base + rot)
        augs = T.build_augmentation(cfg.input, True).augs
        if not any(isinstance(a, T.RandomRotation) for a in augs):
            raise AssertionError(f"no RandomRotation in {augs}")
        dicts = merge_to_panoptic(load_coco_json(ds.instances_json, ds.image_dir),
                                  load_sem_seg(ds.sem_seg_dir, ds.image_dir))
        stages = {"rotation": mapper_stages(cfg, dicts[:8]),
                  "plain": mapper_stages(load_config(U2SEG_YAML, base), dicts[:8])}
        # RandomExtent on the same images: image linear, segmentation nearest
        ext, rng = T.RandomExtent((0.8, 1.2), (0.2, 0.2)), np.random.RandomState(0)
        ext_ms, ext_ok = [], True
        for d in dicts[:8]:
            img = read_image(d["file_name"])
            t0 = time.perf_counter()
            t = ext.get_transform(img, rng)
            out = t.apply_image(img)
            seg = t.apply_segmentation(np.zeros(img.shape[:2], np.uint8) + 7)
            ext_ms.append((time.perf_counter() - t0) * 1e3)
            ext_ok &= (out.shape == tuple(t.output_size) + (3,) and out.dtype == np.uint8
                       and seg.shape == tuple(t.output_size) and set(np.unique(seg)) <= {0, 7})
        res.update(mapper_ms=stages, extent_ms=float(np.mean(ext_ms)), extent_ok=bool(ext_ok))
        log(f"[augment] DatasetMapper on one thread, ms per image (8 images): with rotation "
            f"total {stages['rotation']['total']:.1f} (augment {stages['rotation']['augment']:.1f}, "
            f"instances {stages['rotation']['instances']:.1f}), without "
            f"{stages['plain']['total']:.1f} (augment {stages['plain']['augment']:.1f}, "
            f"instances {stages['plain']['instances']:.1f}); RandomExtent (image + segmentation) "
            f"{res['extent_ms']:.1f} ms per image, shapes and labels "
            f"{'ok' if ext_ok else 'WRONG'}")
        argv = ["--config-file", U2SEG_YAML, "--max-iter", str(steps)] + base + rot
        torch.cuda.reset_peak_memory_stats(dev)
        with loader_probe() as probe:
            reset_kernel_counts()                        # the main path starts
            t0 = time.perf_counter()
            tr = train_net.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            end = kernel_counts()                        # the main path ends
            per_step = per_step_launches(probe.loaders[0], end)
            totals = [v for v, _ in tr.storage.history("total_loss").values()]
            timer = [v * 1e3 for v, _ in tr.storage.history("time").values()]
            waits, bad = probe.loaders[0].waits, probe.loaders[0].bad
            probe.loaders[0].close()
            del tr
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    res.update(steps=per_step, totals=totals, timer_ms=timer, wait_ms=waits, train_s=train_s,
               peak_mib=peak, launches=dict(k1=sum(s[0] for s in per_step),
                                            k3=sum(s[1] for s in per_step)))
    problems = []
    if not (len(totals) == steps and all(np.isfinite(totals))):
        problems.append(f"losses {totals}")
    if len(per_step) != steps or any(s != (4, 4) for s in per_step):
        problems.append(f"K1/K3 launches per step {per_step}")
    if bad or not ext_ok:
        problems.append(f"batches out of range {bad}, extent ok {ext_ok}")
    log(f"[augment] train_net.main with input.rotation_enabled=True (u2seg_R50_800.yaml, bf16, "
        f"b=2, 4 loader threads): {steps} steps in {train_s:.1f} s (build included), total "
        f"losses " + ", ".join(f"{v:.4f}" for v in totals)
        + f"; IterationTimer ms " + ", ".join(f"{v:.1f}" for v in timer)
        + f"; the trainer's wait for data per step " + ", ".join(f"{v:.1f}" for v in waits)
        + f" ms; K1/K3 launches per step {per_step}; peak {peak:.0f} MiB "
        + ("ok" if not problems else "FAIL " + "; ".join(problems)))
    if problems:
        raise AssertionError("augment failed: " + "; ".join(problems))
    return res


def _normalise(images: np.ndarray, dev) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> f32 (N, 3, H, W) with the ImageNet statistics."""
    x = (images.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dev)


class _DinoClassifier(torch.nn.Module):
    """The port's DINO ViT and a linear head over the [CLS] feature."""

    def __init__(self, vit, head):
        super().__init__()
        self.vit, self.head = vit, head

    def forward(self, x):
        return self.head(self.vit(x)[0])


class _DinoTrunk(torch.nn.Module):
    def __init__(self, vit):
        super().__init__()
        self.vit = vit

    def forward(self, x):
        return self.vit(x)[0]


def phase_semisup(dev):
    """FixMatch on the port's DINO ViT-B/16 (dim 768, depth 12, 12 heads, f32,
    224x224) with a linear head over 800 clusters: 8 labeled images and 56
    weak + 56 strong unlabeled ones per step (mu = 7, one concatenated
    forward), the strong views from ``randaugment_mc`` on the host, 4 steps
    with the EMA; then 2 fine-tune steps with the trunk frozen. No hand
    kernel lies on this path (the JAX package's is XLA too)."""
    from u2seg_torch.pseudo.dino import DinoViT, seeded_dino_state
    from u2seg_torch.pseudo.semisup import (FixMatchConfig, make_finetune_train_step,
                                            make_fixmatch_train_step, randaugment_mc)

    rng = np.random.RandomState(31)
    side, nl, nu = SEMISUP_SIDE, SEMISUP_LABELED, SEMISUP_LABELED * SEMISUP_MU
    vit = seeded_dino_state(DinoViT(16, 768, 12, 12, facet="out", img_size=side), seed=0)
    head = torch.nn.Linear(vit.dim, SEMISUP_CLUSTERS)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=g) * 0.05)
        head.bias.zero_()
    model = _DinoClassifier(vit, head).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.03, momentum=0.9)
    # a low threshold: a seeded 800-way head is never 0.95 sure
    step = make_fixmatch_train_step(model, opt, FixMatchConfig(threshold=0.002))
    pool = np.stack([scene(rng, side, side) for _ in range(32)]).astype(np.uint8)
    labeled = pool[:nl]
    targets = torch.from_numpy(rng.randint(0, SEMISUP_CLUSTERS, nl)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rows, ra_s, ra_n = [], 0.0, 0
    for i in range(SEMISUP_STEPS):
        raw = pool[rng.randint(0, len(pool), nu)]
        weak = np.where(rng.rand(nu)[:, None, None, None] < 0.5, raw[:, :, ::-1], raw)
        t0 = time.perf_counter()
        strong = np.stack([randaugment_mc(w, rng) for w in weak])
        ra_s += time.perf_counter() - t0
        ra_n += nu
        xs = [_normalise(a, dev) for a in (labeled, weak, strong)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(xs[0], targets, xs[1], xs[2])
        torch.cuda.synchronize()
        rows.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                         **{k: float(v) for k, v in out.items()}))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    params = dict(model.named_parameters())
    ema_gap = max(float((step.ema_params[k] - p.detach()).abs().max()) for k, p in params.items())

    trunk, ft_head = _DinoTrunk(model.vit), torch.nn.Linear(vit.dim, SEMISUP_CLUSTERS).to(dev)
    ft_opt = torch.optim.SGD(list(trunk.parameters()) + list(ft_head.parameters()),
                             lr=0.01, momentum=0.9)
    ft = make_finetune_train_step(trunk, ft_head, ft_opt, freeze_backbone=True)
    before = {k: v.detach().clone() for k, v in trunk.state_dict().items()}
    head0 = ft_head.weight.detach().clone()
    ft_rows = []
    for i in range(FINETUNE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ft(xs[0], targets)
        torch.cuda.synchronize()
        ft_rows.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(m["loss"])))
    frozen = all(torch.equal(v, trunk.state_dict()[k]) for k, v in before.items())
    head_moved = not torch.equal(head0, ft_head.weight)
    res = dict(steps=rows, finetune=ft_rows, peak_mib=peak, ema_gap=ema_gap,
               randaugment_ms=ra_s * 1e3 / ra_n, trunk_frozen=frozen, head_moved=head_moved)
    ok = (all(np.isfinite(r["loss"]) and np.isfinite(r["loss_u"]) for r in rows)
          and all(np.isfinite(r["loss"]) for r in ft_rows) and frozen and head_moved
          and 0 < ema_gap < 1 and any(r["mask_rate"] > 0 for r in rows))
    log(f"[semisup] FixMatch, DINO ViT-B/16 (f32, {side}x{side}) + linear head over "
        f"{SEMISUP_CLUSTERS} clusters, {nl} labeled + {nu} weak + {nu} strong per step: step ms "
        + ", ".join(f"{r['ms']:.1f}" for r in rows) + "; loss "
        + ", ".join(f"{r['loss']:.4f}" for r in rows) + " (mask rate "
        + ", ".join(f"{r['mask_rate']:.3f}" for r in rows)
        + f"); RandAugmentMC on the host {res['randaugment_ms']:.2f} ms per image; EMA - params "
        f"max {ema_gap:.2e}; peak {peak:.0f} MiB; fine-tune with the trunk frozen, {nl} images: "
        + ", ".join(f"{r['ms']:.1f} ms loss {r['loss']:.4f}" for r in ft_rows)
        + f", trunk unchanged {frozen}, head moved {head_moved} " + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"semisup failed: {res}")
    del model, trunk
    torch.cuda.empty_cache()
    return res


def rotated_inputs(rng, n: int, h: int, w: int, dtype=np.float32) -> np.ndarray:
    """n rotated boxes (cx, cy, w, h, angle) over an h x w image, 8-400 px
    sides, any angle."""
    side = np.exp(rng.uniform(np.log(8), np.log(400), (n, 2)))
    return np.concatenate([rng.uniform(0, w, (n, 1)), rng.uniform(0, h, (n, 1)), side,
                           rng.uniform(-180, 180, (n, 1))], 1).astype(dtype)


def phase_rotated(dev):
    """``multilevel_roi_align_rotated`` on p2-p5 of an 800x1216 image (C=256,
    f32, R=1000, s=7) against the CPU at 1e-4 x max; ``nms_rotated`` over 1000
    boxes (f64, so that no IoU lies within rounding of the threshold on one
    device only) exactly against the CPU; ``RotatedCOCOEvaluator`` on the
    ground truth given as predictions (AP 100)."""
    from u2seg_torch.evaluation import RotatedCOCOEvaluator
    from u2seg_torch.evaluation.coco_api import COCO
    from u2seg_torch.ops.roi_align import multilevel_roi_align_rotated
    from u2seg_torch.structures.rotated_boxes import nms_rotated

    rng = np.random.RandomState(41)
    h, w = ROTATED_HW
    strides = (4, 8, 16, 32)
    feats = [torch.from_numpy(rng.randn(1, h // s, w // s, 256).astype(np.float32))
             for s in strides]
    rois = torch.from_numpy(rotated_inputs(rng, ROTATED_R, h, w))
    bidx = torch.zeros(ROTATED_R, dtype=torch.int32)
    dfeats = [f.to(dev) for f in feats]
    drois, dbidx = rois.to(dev), bidx.to(dev)
    fn = lambda: multilevel_roi_align_rotated(dfeats, drois, dbidx, 7, strides)  # noqa: E731
    got = fn()
    ms = cuda_ms(fn, iters=5)
    t0 = time.perf_counter()
    ref = multilevel_roi_align_rotated(feats, rois, bidx, 7, strides)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float((got.cpu() - ref).abs().max())
    pool_ok = err <= F32_TOL * float(ref.abs().max())

    boxes = rotated_inputs(rng, ROTATED_NMS, h, w, np.float64)
    boxes[:, 2:4] = np.minimum(boxes[:, 2:4], 160)
    boxes[:, :2] = boxes[:, :2] * 0.4 + 200              # crowded: many overlaps
    scores = rng.rand(ROTATED_NMS)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    nfn = lambda: nms_rotated(tb.to(dev), ts.to(dev), 0.5, 300)  # noqa: E731
    keep, valid = nfn()
    nms_ms = cuda_ms(nfn, iters=3, warmup=1)
    rkeep, rvalid = nms_rotated(tb, ts, 0.5, 300)
    nms_ok = torch.equal(keep.cpu(), rkeep) and torch.equal(valid.cpu(), rvalid)

    images, anns = [], []
    for img in range(1, 11):
        images.append({"id": img, "height": h, "width": w})
        for bb in rotated_inputs(rng, 20, h, w, np.float64):
            anns.append({"id": len(anns) + 1, "image_id": img, "category_id": 1 + len(anns) % 3,
                         "iscrowd": 0, "bbox": [float(v) for v in bb],
                         "area": float(bb[2] * bb[3])})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": i, "name": str(i)} for i in (1, 2, 3)]}
    ev = RotatedCOCOEvaluator(COCO(gt), mode="supervised")
    t0 = time.perf_counter()
    for img in images:
        mine = [a for a in anns if a["image_id"] == img["id"]]
        ev.process([{"image_id": img["id"]}], [{"instances": {
            "boxes": np.array([a["bbox"] for a in mine]),
            "scores": np.linspace(0.9, 0.1, len(mine)),
            "classes": np.array([a["category_id"] for a in mine])}}])
    ap = ev.evaluate()["bbox"]["AP"]
    eval_ms = (time.perf_counter() - t0) * 1e3
    ok = pool_ok and nms_ok and abs(ap - 100.0) < 1e-6
    res = dict(pool_ms=ms, pool_cpu_ms=cpu_ms, pool_max_abs_err=err, nms_ms=nms_ms,
               nms_kept=int(valid.sum()), eval_ms=eval_ms, ap=ap)
    log(f"[rotated] multilevel_roi_align_rotated p2-p5 of {h}x{w}, C=256 f32, R={ROTATED_R}, "
        f"s=7: {ms:.3f} ms on the card, {cpu_ms:.0f} ms on the CPU, max|card - CPU| {err:.2e} "
        f"(max|CPU| {float(ref.abs().max()):.2f}); nms_rotated of {ROTATED_NMS} f64 boxes at 0.5: "
        f"{nms_ms:.2f} ms, {res['nms_kept']} kept, equal to the CPU {nms_ok}; "
        f"RotatedCOCOEvaluator on the ground truth of 10 images x 20 boxes: AP {ap:.4f} in "
        f"{eval_ms:.0f} ms " + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"rotated failed: {res}")
    del dfeats
    torch.cuda.empty_cache()
    return res


def _deform_check(dev) -> dict:
    from u2seg_torch.ops.deform_conv import ModulatedDeformConv
    from u2seg_torch.weights import seeded_init

    b, c, h, w = DEFORM_SHAPE
    x = torch.randn(b, c, h, w, generator=torch.Generator().manual_seed(5)).to(dev)
    m = seeded_init(ModulatedDeformConv(c, c), seed=3).to(dev)
    with torch.no_grad():
        plain = torch.nn.functional.conv2d(x, m.weight, m.bias, padding=1)
        got = m(x)
    err = float((got - plain).abs().max())
    zero_ok = err <= F32_TOL * float(plain.abs().max())
    with torch.no_grad():                                  # learned offsets and masks
        m.offset_mask_conv.weight.normal_(0, 0.01)
    xg = x.clone().requires_grad_()

    def fwd_bwd():
        m.zero_grad(set_to_none=True)
        xg.grad = None
        y = m(xg)
        y.square().mean().backward()
        return y

    y = fwd_bwd()
    ms = cuda_ms(fwd_bwd, iters=3, warmup=1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: m(x), iters=3, warmup=1)
    grads_ok = all(torch.isfinite(t).all() and float(t.abs().max()) > 0
                   for t in (xg.grad, m.weight.grad, m.offset_mask_conv.weight.grad))
    return dict(zero_err=err, zero_ok=zero_ok, fwd_ms=fwd_ms, fwd_bwd_ms=ms,
                grads_ok=bool(grads_ok and torch.isfinite(y).all()))


def _deeplab_check(dev) -> dict:
    import torch.nn.functional as F

    from u2seg_torch.config import Config
    from u2seg_torch.models.resnet import ResNet
    from u2seg_torch.ops.aspp import resize_bilinear
    from u2seg_torch.projects.deeplab import DeepLabV3PlusHead, hard_pixel_mining_loss
    from u2seg_torch.projects.panoptic_deeplab import (PanopticDeepLabHead,
                                                       group_pixels_to_instances,
                                                       panoptic_deeplab_fusion)
    from u2seg_torch.weights import seeded_init

    rng = np.random.RandomState(51)
    h, w = DEEPLAB_HW
    trunk = seeded_init(ResNet(Config().model.resnet), seed=0).to(dev).train()
    images = _normalise(np.stack([scene(rng, h, w) for _ in range(2)]).astype(np.uint8), dev)
    targets = torch.from_numpy(rng.randint(0, DEEPLAB_CLASSES, (2, h, w))).to(dev)
    targets[:, :32] = 255
    out = {}
    v3p = seeded_init(DeepLabV3PlusHead(2048, 256, DEEPLAB_CLASSES), seed=1).to(dev).train()
    pdl = seeded_init(PanopticDeepLabHead(2048, 256, DEEPLAB_CLASSES), seed=2).to(dev).train()

    def deeplab():
        trunk.zero_grad(set_to_none=True)
        v3p.zero_grad(set_to_none=True)
        logits, losses = v3p(trunk(images), targets)
        losses["loss_sem_seg"].backward()
        return logits, losses

    def panoptic():
        trunk.zero_grad(set_to_none=True)
        pdl.zero_grad(set_to_none=True)
        sem, center, offset = pdl(trunk(images))
        loss = (hard_pixel_mining_loss(resize_bilinear(sem, (h, w)), targets)
                + F.mse_loss(torch.sigmoid(center), torch.zeros_like(center))
                + offset.abs().mean())
        loss.backward()
        return sem, center, offset, loss

    torch.cuda.reset_peak_memory_stats(dev)
    logits, losses = deeplab()
    out["deeplab_ms"] = cuda_ms(deeplab, iters=3, warmup=1)
    out["deeplab_loss"] = float(losses["loss_sem_seg"].detach())
    out["deeplab_ok"] = bool(logits.shape == (2, DEEPLAB_CLASSES, h, w)
                             and torch.isfinite(logits).all()
                             and all(p.grad is not None and torch.isfinite(p.grad).all()
                                     for p in v3p.parameters()))
    sem, center, offset, loss = panoptic()
    out["panoptic_ms"] = cuda_ms(panoptic, iters=3, warmup=1)
    out["panoptic_loss"] = float(loss.detach())
    out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    things = torch.zeros(DEEPLAB_CLASSES, dtype=torch.bool, device=dev)
    things[list(CITYSCAPES_THINGS)] = True
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pans, n_inst = [], []
        for i in range(2):
            thing_mask = things[sem[i].argmax(0)]
            ids, scores = group_pixels_to_instances(torch.sigmoid(center[i]), offset[i],
                                                    thing_mask, center_threshold=0.0)
            pans.append(panoptic_deeplab_fusion(sem[i], ids, things))
            n_inst.append(int(ids.max()))
        torch.cuda.synchronize()
        out["group_fuse_ms"] = (time.perf_counter() - t0) * 1e3 / 2
    labels = [p // 1000 for p in pans]
    inst = [p % 1000 for p in pans]
    out["instances"] = n_inst
    out["panoptic_ok"] = bool(torch.isfinite(loss) and all(
        int(l.min()) >= 0 and int(l.max()) < DEEPLAB_CLASSES and int(i.max()) <= 128
        for l, i in zip(labels, inst)) and max(n_inst) > 0)
    del trunk, v3p, pdl
    return out


def _bn_head_check(dev) -> dict:
    from u2seg_torch import model_zoo
    from u2seg_torch.models.build import build_model
    from u2seg_torch.projects.rethinking_bn import (BatchNormBatchStats, mask_rcnn_bn_head,
                                                    mask_rcnn_bn_head_batch_stats)
    from u2seg_torch.ops import roi_align_ml as rap

    k1, k3 = rap.multilevel_roi_align_kernel, rap.multilevel_roi_align_backward
    h, w = TRAIN_HW
    cfg = mask_rcnn_bn_head(model_zoo.get_config(MASK_RCNN_YAML))
    model = build_model(cfg, device=dev).train()
    pools = pools_per_forward(cfg)
    batch = zoo_train_batch(cfg, 2, h, w).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.001, momentum=0.9)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats(dev)
    k1.launches = k3.launches = 0                          # the main path starts
    t0 = time.perf_counter()
    losses = model(batch.images, batch.image_sizes, gt=batch.gt, train=True, generator=gen)
    sum(losses.values()).backward()
    opt.step()
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    train_launches = (k1.launches, k3.launches)            # the main path ends
    norms = zoo_grad_groups(model)
    stats = [m.running_mean for n, m in model.named_modules()
             if n.startswith("roi_heads.") and hasattr(m, "running_mean")]
    moved = max(float(s.abs().max()) for s in stats)
    # evaluate with batch statistics: the BN-head checkpoint loads as it is
    ecfg = mask_rcnn_bn_head_batch_stats(model_zoo.get_config(MASK_RCNN_YAML))
    emodel = build_model(ecfg, device=dev)
    emodel.load_state_dict(model.state_dict(), strict=True)
    zoo_calibrate(emodel.cfg)
    n_bs = sum(isinstance(m, BatchNormBatchStats) for m in emodel.modules())
    img = batch.images
    with torch.no_grad():
        k1.launches = k3.launches = 0                      # the eval path starts
        t0 = time.perf_counter()
        det = emodel(img, batch.image_sizes)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        eval_launches = (k1.launches, k3.launches)         # the eval path ends
    finite = all(bool(torch.isfinite(t).all()) for t in output_tensors(det))
    out = dict(train_ms=train_ms, eval_ms=eval_ms, dtype=cfg.model.compute_dtype,
               losses={k: float(v.detach()) for k, v in losses.items()},
               grad_norms=norms, stats_moved=moved, batch_stats_norms=n_bs,
               train_launches=train_launches, eval_launches=eval_launches, pools=pools,
               detections=int(det.valid.sum()), peak_mib=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    out["ok"] = bool(all(np.isfinite(v) for v in out["losses"].values())
                     and all(np.isfinite(v) and v > 0 for v in norms.values()) and moved > 0
                     and n_bs == 4 + 4 and finite and out["detections"] > 0
                     and train_launches == (pools, pools) and eval_launches == (pools, 0))
    del model, emodel
    return out


def shufflebn_worker(rank: int, init: str, out_path: str):
    """One rank of ShuffleBN in phase ``projects``: gloo with CUDA tensors;
    this rank's rows through ``batch_shuffle`` / ``batch_unshuffle`` and a
    BN in training mode through ``shuffled_bn``."""
    from u2seg_torch.ops.norms import BatchNorm2d
    from u2seg_torch.parallel import comm
    from u2seg_torch.parallel.launch import launch
    from u2seg_torch.projects import rethinking_bn as R

    def main():
        dev = torch.device("cuda", 0)
        g = torch.Generator().manual_seed(100 + rank)
        x = (torch.randn(8, 256, 14, 14, generator=g) * (1 + rank)).to(dev)
        back, perm = R.batch_shuffle(x, torch.Generator().manual_seed(7))
        back = R.batch_unshuffle(back, perm)
        bn = BatchNorm2d(256).to(dev).train()
        xg = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = R.shuffled_bn(bn, xg, torch.Generator().manual_seed(7))
        y.square().mean().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        perms = comm.all_gather(perm.cpu().tolist())
        res = dict(rank=comm.get_rank(), world=comm.get_world_size(), device=str(x.device),
                   own_rows_back=bool(torch.equal(back, x)), same_perm=perms[0] == perms[1],
                   finite=bool(torch.isfinite(y).all() and torch.isfinite(xg.grad).all()),
                   moved=float(bn.running_mean.abs().max()), ms=ms)
        with open(out_path, "w") as f:
            json.dump(res, f)

    launch(main, backend="gloo", init_method=init, world_size=DDP_WORLD, rank=rank)


def _shufflebn_check(timeout: float = 300.0) -> dict:
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rdv")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(DDP_WORLD)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank",
                                   str(r), "--ddp-init", init, "--ddp-out", outs[r],
                                   "--ddp-task", "shufflebn"],
                                  cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(DDP_WORLD)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                log(f"[projects] ShuffleBN rank {r} exited {p.returncode}:\n{text[-6000:]}")
                raise AssertionError(f"ShuffleBN rank {r} failed")
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    ok = all(r["own_rows_back"] and r["same_perm"] and r["finite"] and r["moved"] > 0
             and r["device"].startswith("cuda") for r in ranks)
    return dict(ranks=ranks, wall_s=wall_s, ok=ok)


def phase_projects(dev):
    """The project modules at full width: ``ModulatedDeformConv`` 3x3 at res3
    of an 800x1344 image (b=2, 128 channels, 100x168), forward and backward,
    equal to ``F.conv2d`` at 1e-4 with zero offsets and unit masks (TF32
    off); DeepLabV3+ and Panoptic-DeepLab heads over the port's R50 trunk at
    b=2, 512x1024, 19 classes (forward, loss, backward; grouping and
    fusion); Mask R-CNN with BN heads (``mask_rcnn_bn_head``, b=2 at
    800x1344): one train step with 2 K1 + 2 K3, then an eval forward of the
    same weights under ``BNBatchStats`` with 2 K1; ShuffleBN over 2 gloo
    ranks on the card."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {"deform": _deform_check(dev)}
        d = res["deform"]
        log(f"[projects] ModulatedDeformConv 3x3 on {DEFORM_SHAPE} f32: zero offsets and unit "
            f"masks vs F.conv2d max|diff| {d['zero_err']:.2e}; with learned offsets forward "
            f"{d['fwd_ms']:.2f} ms, forward + backward {d['fwd_bwd_ms']:.2f} ms, gradients "
            f"finite and non-zero {d['grads_ok']} "
            + ("ok" if d["zero_ok"] and d["grads_ok"] else "FAIL"))
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    res["deeplab"] = dl = _deeplab_check(dev)
    log(f"[projects] R50 trunk + DeepLabV3+ head, b=2 {DEEPLAB_HW[0]}x{DEEPLAB_HW[1]}, "
        f"{DEEPLAB_CLASSES} classes, f32: forward + hard-pixel-mining loss + backward "
        f"{dl['deeplab_ms']:.1f} ms (loss {dl['deeplab_loss']:.4f}); Panoptic-DeepLab head "
        f"{dl['panoptic_ms']:.1f} ms (loss {dl['panoptic_loss']:.4f}); grouping + fusion "
        f"{dl['group_fuse_ms']:.2f} ms per image, instances {dl['instances']}; peak "
        f"{dl['peak_mib']:.0f} MiB " + ("ok" if dl["deeplab_ok"] and dl["panoptic_ok"] else "FAIL"))
    torch.cuda.empty_cache()
    res["bn_head"] = bh = _bn_head_check(dev)
    log(f"[projects] Mask R-CNN with BN heads (4conv1fc box head, BN in box and mask heads), "
        f"b=2 {TRAIN_HW[0]}x{TRAIN_HW[1]} {bh['dtype']}: one train step {bh['train_ms']:.1f} ms (first "
        f"call), K1/K3 {bh['train_launches']}, losses "
        + ", ".join(f"{k[5:]} {v:.4f}" for k, v in bh["losses"].items())
        + f"; head BN statistics moved {bh['stats_moved']:.2e}; eval under BNBatchStats "
        f"({bh['batch_stats_norms']} norms, the BN checkpoint loaded strict) {bh['eval_ms']:.1f} "
        f"ms, K1/K3 {bh['eval_launches']}, {bh['detections']} detections; peak "
        f"{bh['peak_mib']:.0f} MiB " + ("ok" if bh["ok"] else "FAIL"))
    torch.cuda.empty_cache()
    res["shufflebn"] = sb = _shufflebn_check()
    log(f"[projects] ShuffleBN over {DDP_WORLD} gloo ranks on the card (8 x 256 x 14 x 14 per "
        f"rank): own rows back "
        + ", ".join(str(r["own_rows_back"]) for r in sb["ranks"])
        + f", one permutation {all(r['same_perm'] for r in sb['ranks'])}, shuffled BN "
        f"forward + backward ms " + ", ".join(f"{r['ms']:.1f}" for r in sb["ranks"])
        + f"; {sb['wall_s']:.1f} s from spawn to exit " + ("ok" if sb["ok"] else "FAIL"))
    problems = [k for k, ok in (("deform", d["zero_ok"] and d["grads_ok"]),
                                ("deeplab", dl["deeplab_ok"] and dl["panoptic_ok"]),
                                ("bn_head", bh["ok"]), ("shufflebn", sb["ok"])) if not ok]
    if problems:
        raise AssertionError(f"projects failed: {problems}: {res}")
    res["launches"] = dict(k1=bh["train_launches"][0] + bh["eval_launches"][0],
                           k3=bh["train_launches"][1])
    return res


def phase_projects_cpu(dev):
    """Tiny configs of each new module, f32 with TF32 off, on the card and on
    the CPU from the same weights and inputs: the deformable conv and its
    gradients, ASPP (GN, BN in training mode), the DeepLabV3+ and
    Panoptic-DeepLab heads with the loss, grouping and fusion (exact),
    ``BatchNormBatchStats``, the rotated IoU and ROIAlignRotated."""
    from u2seg_torch.ops.aspp import ASPP
    from u2seg_torch.ops.deform_conv import deform_conv2d
    from u2seg_torch.ops.norms import get_norm
    from u2seg_torch.ops.roi_align import roi_align_rotated
    from u2seg_torch.projects.deeplab import DeepLabV3PlusHead
    from u2seg_torch.projects.panoptic_deeplab import (PanopticDeepLabHead,
                                                       group_pixels_to_instances,
                                                       panoptic_deeplab_fusion)
    from u2seg_torch.structures.rotated_boxes import pairwise_iou_rotated
    from u2seg_torch.weights import seeded_init

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(61)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    errs = {}

    def rel(a, b):
        b = b.detach().cpu().float()
        return float((a.detach().cpu().float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    try:
        x, off, wt, mask = rnd(2, 6, 9, 11), rnd(2, 18, 9, 11) * 2, rnd(5, 6, 3, 3), torch.rand(2, 9, 9, 11, generator=g)
        outs = []
        for d in (cpu, dev):
            args = [t.clone().to(d).requires_grad_() for t in (x, off, wt, mask)]
            y = deform_conv2d(args[0], args[1], args[2], mask=args[3])
            y.square().sum().backward()
            outs.append([y] + [a.grad for a in args])
        errs["deform_conv2d (y, dx, doffsets, dweight, dmask)"] = max(
            rel(a, b) for a, b in zip(outs[1], outs[0]))
        for norm in ("GN", "BN"):
            m = seeded_init(ASPP(16, 8, dilations=(1, 2, 3), norm=norm), seed=1).train()
            xi = rnd(2, 16, 6, 10)
            ref = m(xi)
            got = m.to(dev)(xi.to(dev))
            errs[f"ASPP {norm} train"] = rel(got, ref)
        feats = {"res2": rnd(2, 8, 16, 24), "res5": rnd(2, 16, 2, 3)}
        targets = torch.randint(0, 5, (2, 64, 96), generator=g)
        head = seeded_init(DeepLabV3PlusHead(16, 8, 5, aspp_dim=16, low_dim=8, decoder_dim=16),
                           seed=2).train()
        ref, rl = head(feats, targets)
        got, gl = head.to(dev)({k: v.to(dev) for k, v in feats.items()}, targets.to(dev))
        errs["DeepLabV3+ logits"] = rel(got, ref)
        errs["DeepLabV3+ loss"] = rel(gl["loss_sem_seg"], rl["loss_sem_seg"])
        pan = seeded_init(PanopticDeepLabHead(16, 8, 5, decoder_dim=16, head_dim=8), seed=3)
        ref = pan(feats)
        got = pan.to(dev)({k: v.to(dev) for k, v in feats.items()})
        errs["Panoptic-DeepLab sem, center, offset"] = max(rel(a, b) for a, b in zip(got, ref))
        heat = torch.rand(24, 30, generator=g) * 0.6
        heat[5, 7] = heat[5, 8] = 0.9
        offs, thing = rnd(2, 24, 30) * 4, torch.rand(24, 30, generator=g) > 0.3
        logits, thing_cls = rnd(6, 24, 30), torch.tensor([True, False, True, True, False, False])
        ids_c, _ = group_pixels_to_instances(heat, offs, thing, max_centers=16)
        ids_d, _ = group_pixels_to_instances(heat.to(dev), offs.to(dev), thing.to(dev), max_centers=16)
        pan_c = panoptic_deeplab_fusion(logits, ids_c, thing_cls)
        pan_d = panoptic_deeplab_fusion(logits.to(dev), ids_d, thing_cls.to(dev))
        exact = torch.equal(ids_c, ids_d.cpu()) and torch.equal(pan_c, pan_d.cpu())
        n = get_norm("BNBatchStats", 8)
        xi = rnd(4, 8, 5, 6) * 2 + 1
        errs["BNBatchStats eval"] = rel(n.to(dev)(xi.to(dev)), n.cpu()(xi))
        b1, b2 = rotated_inputs(np.random.RandomState(3), 20, 64, 64), rotated_inputs(
            np.random.RandomState(4), 15, 64, 64)
        t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
        iou_err = float((pairwise_iou_rotated(t1.to(dev), t2.to(dev)).cpu()
                         - pairwise_iou_rotated(t1, t2)).abs().max())
        f = rnd(2, 16, 16, 8)
        bidx = torch.randint(0, 2, (20,), generator=g)
        errs["roi_align_rotated"] = rel(roi_align_rotated(f.to(dev), t1.to(dev), bidx.to(dev), 7, 0.25),
                                        roi_align_rotated(f, t1, bidx, 7, 0.25))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    ok = max(errs.values()) <= F32_TOL and exact and iou_err <= 1e-5
    log("[projects_cpu] card vs CPU, f32, TF32 off, max error / max|CPU|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; rotated IoU max|diff| {iou_err:.2e}; grouping ids and panoptic map equal {exact} "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"projects_cpu failed: {errs}, exact {exact}, iou {iou_err}")
    return dict(errors=errs, exact=exact, iou_err=iou_err)



# ---------------------------------------------------------------------------
# Phases 28-29: the last project modules (TensorMask, DensePose chart and
# CSE, PointRend, PointSup, TridentNet), composed with the port's models
# ---------------------------------------------------------------------------

PROJECTS2_TIMED = 3                     # ms: the median of 3 after a warm-up
MASK_RCNN_3X_YAML = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"
DP_ROIS_PER_IMAGE = 32                  # foreground ROIs of the DensePose losses
DP_SEGM = 128                           # the mapper's part raster
POINTSUP_POINTS = 10                    # annotated points per instance (PointSup, COCO)
POINTREND_ROIS = 32                     # per image: 64 ROIs of the point loss


def timed_ms(fn, iters: int = PROJECTS2_TIMED):
    """``fn()`` once to warm up, then ``iters`` synchronised calls -> (median
    ms, the last call's output)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def grads_finite_nonzero(*modules) -> bool:
    """Every gradient of the modules' parameters finite, and not all zero."""
    gs = [p.grad for m in modules for p in m.parameters() if p.grad is not None]
    return bool(gs) and all_finite(gs) and any(float(g.abs().max()) > 0 for g in gs)


def peak_mib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20


def _tensormask_check(dev) -> dict:
    """TensorMask at its published settings over the port's R50-FPN (p2-p7)."""
    from u2seg_torch import model_zoo
    from u2seg_torch.config import FPNConfig, ResNetConfig
    from u2seg_torch.models.fpn import FPN
    from u2seg_torch.projects.tensormask import TensorMask, TensorMaskConfig, swap_align2nat
    from u2seg_torch.weights import seeded_init

    h, w = TRAIN_HW
    # seeded classifiers sit at the 0.01 prior, under the 0.05 threshold:
    # every candidate enters the top-k (as zoo_calibrate does for RetinaNet)
    cfg = TensorMaskConfig(score_thresh=0.0)
    backbone = seeded_init(FPN(ResNetConfig(norm="FrozenBN"),
                               FPNConfig(norm="", top_block="p6p7")), seed=11).to(dev)
    model = seeded_init(TensorMask(cfg, 256), seed=12).to(dev)
    batch = zoo_train_batch(model_zoo.get_config(MASK_RCNN_3X_YAML), 2, h, w).to(dev)
    x = _normalise(batch.images.cpu().numpy(), dev)
    res = {}
    torch.cuda.reset_peak_memory_stats(dev)

    def infer():
        with torch.no_grad():
            return model(backbone(x), batch.image_sizes)

    res["infer_ms"], out = timed_ms(infer)
    res["infer_peak_mib"] = peak_mib(dev)
    res["infer_profile"] = forward_profile(infer, iters=1)
    res["detections"] = int(out["valid"].sum())
    res["infer_ok"] = all_finite([out["boxes"], out["scores"], out["mask_patches"]]) and (
        out["mask_patches"].shape == (2, cfg.max_detections, cfg.mask_out_size, cfg.mask_out_size))
    del out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    backbone.train()
    model.train()

    def step():
        backbone.zero_grad(set_to_none=True)
        model.zero_grad(set_to_none=True)
        losses = model(backbone(x), batch.image_sizes, gt=batch.gt, train=True)
        sum(losses.values()).backward()
        return {k: float(v.detach()) for k, v in losses.items()}

    res["train_ms"], res["losses"] = timed_ms(step)
    res["train_peak_mib"] = peak_mib(dev)
    res["train_ok"] = (all(np.isfinite(v) for v in res["losses"].values())
                       and res["losses"]["loss_mask"] > 0 and grads_finite_nonzero(model, backbone))
    backbone.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    # SwapAlign2Nat at p7 (lambda 32, 15 x 15 windows on the p2 grid)
    m = max(cfg.mask_sizes)
    pm = torch.randn(2, m * m, h // 4, w // 4, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        y = swap_align2nat(pm, 32)
    torch.cuda.synchronize()
    res["swap_p7_peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    res["swap_p7_in_mib"] = pm.numel() * 4 / 2 ** 20
    res["swap_p7_out_mib"] = y.numel() * 4 / 2 ** 20
    # the JAX package's second einsum: (N, H, W, V', U') in f32
    res["swap_p7_einsum_gib"] = 2 * (h // 4) * (w // 4) * (32 * m) ** 2 * 4 / 2 ** 30
    with torch.no_grad():
        res["swap_p7_ms"], _ = timed_ms(lambda: swap_align2nat(pm, 32))
    res["swap_ok"] = all_finite([y]) and tuple(y.shape) == (2, (32 * m) ** 2, -(-h // 128),
                                                             -(-w // 128))
    del backbone, model, pm, y
    return res


def _dp_gt(rng, gt, dev):
    """Packed DensePose GT on the GT slots that hold a box: 196 points with
    GT-box-relative coordinates, labels and U / V, and a blocky 128 x 128
    part raster."""
    b, g = gt.valid.shape
    p = 196
    blocks = rng.randint(0, 15, (b, g, DP_SEGM // 16, DP_SEGM // 16)).astype(np.uint8)
    arrs = {"dp_xy": rng.rand(b, g, p, 2).astype(np.float32),
            "dp_i": rng.randint(1, 25, (b, g, p)).astype(np.int64),
            "dp_u": rng.rand(b, g, p).astype(np.float32),
            "dp_v": rng.rand(b, g, p).astype(np.float32),
            "dp_point_valid": np.ones((b, g, p), bool),
            "dp_segm": np.repeat(np.repeat(blocks, 16, 2), 16, 3)}
    out = {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}
    out["dp_valid"] = gt.valid.clone()
    return out


def _rcnn_projects_check(dev) -> dict:
    """DensePose chart and CSE, PointRend and PointSup over the zoo's Mask
    R-CNN R50-FPN 3x (bf16, seeded, calibrated), b=2 at 800x1344."""
    from u2seg_torch import model_zoo
    from u2seg_torch.models.roi_heads import _take
    from u2seg_torch.ops import roi_align_ml as rap
    from u2seg_torch.projects import densepose as DP
    from u2seg_torch.projects import densepose_cse as CSE
    from u2seg_torch.projects import pointrend as PR
    from u2seg_torch.projects import pointsup as PS
    from u2seg_torch.projects.densepose_eval import quantize_chart_result
    from u2seg_torch.weights import seeded_init

    k1, k3 = rap.multilevel_roi_align_kernel, rap.multilevel_roi_align_backward
    h, w = TRAIN_HW
    model, cfg = model_zoo.get(MASK_RCNN_3X_YAML, device=dev)
    zoo_calibrate(cfg.model)
    dtype = model.compute_dtype
    rh, c = model.roi_heads, model.roi_heads.cfg
    batch = zoo_train_batch(cfg, 2, h, w).to(dev)
    gt, b = batch.gt, 2
    rng = np.random.RandomState(13)
    gen = torch.Generator(device=dev).manual_seed(13)
    res, launches = {}, {}
    captured = {}
    hook = rh.mask_head.register_forward_pre_hook(
        lambda mod, args: captured.__setitem__("fine", args[0]))

    def forward():
        with torch.no_grad():
            feats = model.features(batch.images)
            rpn = model.proposal_generator(feats, batch.image_sizes)
            return feats, rh(feats, rpn.proposal_boxes, rpn.proposal_scores, rpn.proposal_valid,
                             batch.image_sizes)

    torch.cuda.reset_peak_memory_stats(dev)
    k1.launches = k3.launches = 0                          # the main path starts
    res["rcnn_ms"], (feats, det) = timed_ms(forward)
    launches["forward"] = (k1.launches, k3.launches)       # the main path ends
    hook.remove()
    res["detections"] = int(det.valid.sum())
    feats = {k: v.detach() for k, v in feats.items()}

    # DensePose chart: inference over every detection, IUV, 10 quantised
    dp = seeded_init(DP.DensePoseHeads(DP.DensePoseConfig(), 256, dtype=dtype), seed=21).to(dev)

    def dp_infer():
        with torch.no_grad():
            out = dp(feats, det.boxes)
            return out, DP.densepose_chart_inference({k: v.flatten(0, 1) for k, v in out.items()})

    k1.launches = k3.launches = 0
    res["dp_infer_ms"], (dp_out, iuv) = timed_ms(dp_infer)
    launches["densepose_infer"] = (k1.launches, k3.launches)
    rois = [(i // 5, i % 5) for i in range(10)]
    t0 = time.perf_counter()
    quant = []
    for bi, ri in rois:
        x0, y0, x1, y1 = det.boxes[bi, ri].tolist()
        quant.append(quantize_chart_result(
            *(dp_out[k][bi, ri].permute(1, 2, 0).float().cpu().numpy()
              for k in ("coarse_segm", "fine_segm", "u", "v")),
            (int(max(x1 - x0, 1.0)), int(max(y1 - y0, 1.0)))))
    res["quantize_ms"] = (time.perf_counter() - t0) * 1e3 / len(rois)
    res["dp_infer_ok"] = (all_finite(dp_out.values()) and all_finite(iuv[1:])
                          and int(iuv[0].max()) <= 24 and all(q.dtype == np.uint8 for q in quant)
                          and tuple(dp_out["fine_segm"].shape) == (b, det.boxes.shape[1], 25, 112, 112))
    del dp_out, iuv

    # DensePose losses on 32 foreground ROIs per image (GT boxes jittered)
    dp_gt = _dp_gt(rng, gt, dev)
    n_real = int(gt.valid[0].sum())
    gt_idx = torch.arange(DP_ROIS_PER_IMAGE, device=dev).remainder(n_real).repeat(b, 1)
    jit = torch.from_numpy(rng.uniform(-0.1, 0.1, (b, DP_ROIS_PER_IMAGE, 4)).astype(np.float32)).to(dev)
    gbox = _take(gt.boxes, gt_idx)
    prop = gbox + jit * (gbox[..., 2:] - gbox[..., :2]).repeat(1, 1, 2)
    idx, live = DP.select_densepose_rois(torch.ones_like(gt_idx, dtype=torch.bool), gt_idx,
                                         dp_gt["dp_valid"], DP_ROIS_PER_IMAGE)
    roi_boxes = _take(prop, idx.long())
    roi_gt = DP.gather_densepose_gt_for_rois(dp_gt, gt.boxes, torch.gather(gt_idx, 1, idx.long()))
    for conf, name in (("", "plain"), ("indep_aniso", "indep_aniso")):
        head = seeded_init(DP.DensePoseHeads(DP.DensePoseConfig(uv_confidence=conf), 256,
                                             dtype=dtype), seed=22).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)

        def dp_step():
            head.zero_grad(set_to_none=True)
            losses = head(feats, roi_boxes, train=True, gt=roi_gt, roi_live=live)
            sum(losses.values()).backward()
            return {k: float(v.detach()) for k, v in losses.items()}

        k1.launches = k3.launches = 0
        ms, losses = timed_ms(dp_step)
        launches[f"densepose_loss_{name}"] = (k1.launches, k3.launches)
        res[f"dp_loss_{name}"] = dict(
            ms=ms, losses=losses, peak_mib=peak_mib(dev),
            ok=all(np.isfinite(v) for v in losses.values()) and grads_finite_nonzero(head))
        del head

    # DensePose CSE on the same ROIs: loss + backward, nearest vertices on 10
    ccfg = CSE.CSEConfig(pix2shape_enabled=True)
    cse = seeded_init(CSE.DensePoseCseHeads(ccfg, 256, dtype=dtype), seed=23).to(dev)
    embedder = seeded_init(CSE.Embedder(ccfg), seed=24).to(dev)
    s_out = 4 * 28
    flat = lambda x: x.flatten(0, 1)  # noqa: E731
    coords, inside = DP.remap_points_to_proposals(flat(roi_gt["dp_xy"]), flat(roi_gt["gt_boxes"]),
                                                  flat(roi_boxes))
    coords = coords.clamp(0.0, 1.0)
    n_roi, n_pt = coords.shape[:2]
    mesh = ccfg.meshes[0]
    pts = CSE.CsePoints(x=coords[..., 0], y=coords[..., 1],
                        vertex_ids=torch.randint(0, mesh.num_vertices, (n_roi, n_pt), device=dev,
                                                 generator=gen),
                        mesh_ids=torch.zeros((n_roi, n_pt), dtype=torch.long, device=dev),
                        valid=flat(roi_gt["dp_point_valid"]) & inside)
    cgt = DP.resample_coarse_segm_gt(flat(roi_gt["dp_segm"]), flat(roi_gt["gt_boxes"]),
                                     flat(roi_boxes), s_out)
    torch.cuda.reset_peak_memory_stats(dev)

    def cse_step():
        cse.zero_grad(set_to_none=True)
        embedder.zero_grad(set_to_none=True)
        losses = cse(feats, roi_boxes, train=True, points=pts, coarse_segm_gt=cgt, roi_live=live,
                     mesh_embeddings=[embedder(mesh.name)], generator=gen)
        sum(losses.values()).backward()
        return {k: float(v.detach()) for k, v in losses.items()}

    k1.launches = k3.launches = 0
    ms, losses = timed_ms(cse_step)
    launches["cse_loss"] = (k1.launches, k3.launches)
    res["cse_loss"] = dict(ms=ms, losses=losses, peak_mib=peak_mib(dev),
                           ok=all(np.isfinite(v) for v in losses.values()) and len(losses) == 3
                           and grads_finite_nonzero(cse, embedder))

    def nearest():
        with torch.no_grad():
            out = cse(feats, det.boxes[:, :5])
            return CSE.cse_nearest_vertices(flat(out["embedding"]), flat(out["coarse_segm"]),
                                            embedder(mesh.name))

    res["cse_nearest_ms"], (vid, fg) = timed_ms(nearest)
    res["cse_nearest_ok"] = (tuple(vid.shape) == (10, s_out, s_out) and int(vid.min()) >= 0
                             and int(vid.max()) < mesh.num_vertices and fg.dtype == torch.bool)
    del cse, embedder, pts, cgt

    # PointRend: subdivision over every detection's 28 x 28 logits, the fine
    # features the mask head's K1 pool (14 x 14 x 256)
    head = seeded_init(PR.PointHead(256, 1), seed=25).to(dev)
    fine = captured["fine"].permute(0, 3, 1, 2).float()
    coarse = flat(det.mask_logits).float()

    def refine():
        with torch.no_grad():
            return PR.refine_mask_inference(head, fine, coarse, 2, 196, 56)

    res["refine_ms"], refined = timed_ms(refine)
    res["refine_ok"] = all_finite([refined]) and tuple(refined.shape) == (fine.shape[0], 56, 56)
    del fine, coarse, captured["fine"], refined, feats, det

    # PointSup (10 points per instance) replacing the mask loss of a training
    # forward, and PointRend's point loss on 64 of its mask ROIs
    g = gt.valid.shape[1]
    rel = torch.from_numpy(rng.rand(b, g, POINTSUP_POINTS, 2).astype(np.float32)).to(dev)
    pt_xy = gt.boxes[:, :, None, :2] + rel * (gt.boxes[:, :, None, 2:] - gt.boxes[:, :, None, :2])
    inside_mask = PR.point_sample(gt.masks.flatten(0, 1)[:, None].float(), flat(rel))[..., 0] > 0.5
    pt_lab = torch.where(gt.valid[..., None], inside_mask.reshape(b, g, -1).float(),
                         torch.full_like(rel[..., 0], -1.0))
    model.train()
    torch.cuda.reset_peak_memory_stats(dev)

    def ps_step():
        model.zero_grad(set_to_none=True)
        head.zero_grad(set_to_none=True)
        feats = model.features(batch.images)
        rpn = model.proposal_generator(feats, batch.image_sizes, gt=gt, train=True, generator=gen)
        props = rh._sample(rpn.proposal_boxes, rpn.proposal_scores, rpn.proposal_valid, gt,
                           c.iou_thresholds[0], gen)
        pooled = rh._pool(feats, props.boxes, c.box_head.pooler_resolution,
                          c.box_head.pooler_sampling_ratio, train=True)
        scores, deltas = rh.box_predictor(rh.box_head(pooled.to(dtype)))
        losses = dict(rpn.losses)
        losses.update(rh._box_losses(scores, deltas, props, _take(gt.boxes, props.gt_idx),
                                     c.bbox_reg_weights))
        midx, mvalid = rh._select_mask_rois(props)
        mboxes = _take(props.boxes, midx)
        fine = rh._pool(feats, mboxes, c.mask_head.pooler_resolution,
                        c.mask_head.pooler_sampling_ratio, train=True)
        mgt = torch.gather(props.gt_idx, 1, midx)
        mcls = torch.clamp(torch.gather(props.gt_classes, 1, midx), 0, c.num_classes - 1)
        logits = rh.mask_head(fine.to(dtype), mcls.reshape(-1)).permute(0, 3, 1, 2)
        coords, labels = PS.prepare_point_targets(flat(mboxes), flat(_take(pt_xy, mgt)),
                                                  flat(_take(pt_lab, mgt)))
        losses["loss_mask_point_sup"] = PS.point_sup_mask_loss(
            logits, torch.zeros_like(mcls.reshape(-1)), coords, labels, mvalid.reshape(-1))
        cap, sel = midx.shape[1], slice(0, POINTREND_ROIS)
        rb, gb = flat(mboxes[:, sel]), flat(_take(gt.boxes, mgt[:, sel]))
        patch = flat(_take(gt.masks, mgt[:, sel])).float()

        def gt_at(p):
            img = rb[:, None, :2] + p * (rb[:, None, 2:] - rb[:, None, :2])
            r = (img - gb[:, None, :2]) / (gb[:, None, 2:] - gb[:, None, :2]).clamp(min=1e-6)
            return PR.point_sample(patch[:, None], r)[..., 0]

        fine_s = flat(fine.reshape(b, cap, *fine.shape[1:])[:, sel]).permute(0, 3, 1, 2)
        coarse_s = flat(logits.reshape(b, cap, *logits.shape[2:])[:, sel])
        losses["loss_mask_point_rend"] = PR.point_rend_mask_loss(
            head, fine_s.float(), coarse_s.float(), gt_at, 196, generator=gen)
        sum(losses.values()).backward()
        return {k: float(v.detach()) for k, v in losses.items()}

    k1.launches = k3.launches = 0                          # the main path starts
    ms, losses = timed_ms(ps_step)
    launches["pointsup_step"] = (k1.launches, k3.launches)  # the main path ends
    res["pointsup"] = dict(ms=ms, losses=losses, peak_mib=peak_mib(dev),
                           ok=all(np.isfinite(v) for v in losses.values())
                           and grads_finite_nonzero(model.roi_heads.mask_head, head))
    res["launches"] = launches
    del model, head
    return res


def _trident_check(dev) -> dict:
    """A trident res4 stage of R50 (6 blocks, 1024 out / 256 bottleneck,
    dilations 1, 2, 3, BN in training mode) on the res3 output of the port's
    R50 trunk, b=2 at 800x1344: forward + backward, and the shared kernels'
    gradients against the sums of the branches' parts (TF32 off)."""
    from u2seg_torch.config import ResNetConfig
    from u2seg_torch.models.resnet import ResNet
    from u2seg_torch.projects.tridentnet import make_trident_stage
    from u2seg_torch.weights import seeded_init

    h, w = TRAIN_HW
    trunk = seeded_init(ResNet(ResNetConfig(norm="FrozenBN", out_features=("res3",))),
                        seed=31).to(dev).eval()
    x = _normalise(np.random.RandomState(14).randint(0, 256, (2, h, w, 3)).astype(np.uint8), dev)
    with torch.no_grad():
        res3 = trunk(x)["res3"]
    del trunk, x
    stage = seeded_init(make_trident_stage(512, 6, 1024, 256, norm="BN"), seed=32).to(dev).train()
    gen = torch.Generator(device=dev).manual_seed(15)
    cots = [torch.randn(2, 1024, *res3.shape[2:], device=dev, generator=gen) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats(dev)

    def step():
        stage.zero_grad(set_to_none=True)
        outs = stage(res3)
        sum((o * cot).sum() for o, cot in zip(outs, cots)).backward()
        return [o.detach() for o in outs]

    ms, outs = timed_ms(step)
    res = dict(ms=ms, peak_mib=peak_mib(dev), out_shape=list(outs[0].shape),
               ok=all_finite(outs) and grads_finite_nonzero(stage))
    del outs
    kernels = [getattr(stage, f"trident_block{i}").trident.weight for i in range(6)]
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = stage(res3)
        terms = [(o * cot).sum() for o, cot in zip(outs, cots)]
        parts = [torch.autograd.grad(tm, kernels, retain_graph=True) for tm in terms]
        total = torch.autograd.grad(sum(terms), kernels)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    res["split_err"] = max(float((tot - sum(p[i] for p in parts)).abs().max())
                           / max(float(tot.abs().max()), 1e-30) for i, tot in enumerate(total))
    res["ok"] = res["ok"] and res["split_err"] <= F32_TOL
    del stage, res3, cots, outs, terms, parts, total
    return res


def phase_projects2(dev):
    """The last project modules at full width, b=2 at 800x1344 with seeded
    weights, each timed (median of 3 after a warm-up) with its peak memory:
    TensorMask (published settings over the R50-FPN p2-p7: inference with
    6000 candidates, NMS 0.5, 100 detections; loss + backward on 20 of 100
    GT slots with 64x64 patches; SwapAlign2Nat at p7); over the zoo's Mask
    R-CNN R50-FPN 3x (2 K1 per forward): DensePose chart heads over its 100
    detections per image (IUV, 10 quantised), their losses plain and
    ``indep_aniso`` on 32 foreground ROIs per image, CSE (smpl_27554,
    pix2shape) loss + backward and nearest vertices on 10 ROIs, PointRend's
    subdivision over the 28 x 28 mask logits, and a training forward whose
    mask loss is PointSup's (10 points per instance) plus PointRend's point
    loss on 64 ROIs (2 K1 + 2 K3); a trident res4 stage of R50 forward +
    backward. Fails unless every output, loss and gradient is finite and
    every launch count is the expected one."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        tm = _tensormask_check(dev)
        torch.cuda.empty_cache()
        rc = _rcnn_projects_check(dev)
        torch.cuda.empty_cache()
        tr = _trident_check(dev)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[projects2] TensorMask (R50-FPN p2-p7, 80 classes, windows 11 and 15, align + "
        f"bipyramid), b=2 {TRAIN_HW[0]}x{TRAIN_HW[1]} f32: inference {tm['infer_ms']:.1f} ms "
        f"({tm['detections']} detections, peak {tm['infer_peak_mib']:.0f} MiB; profiled: "
        f"{tm['infer_profile']['device_ms']:.1f} ms of kernels, busy {tm['infer_profile']['busy']:.2f}, "
        f"{tm['infer_profile']['launches']:.0f} launches, top "
        + "; ".join(f"{k['name'][:40]} {k['ms']:.2f} ms" for k in tm["infer_profile"]["top"])
        + f"); loss + backward "
        f"{tm['train_ms']:.1f} ms (" + ", ".join(f"{k[5:]} {v:.4f}" for k, v in tm["losses"].items())
        + f"; peak {tm['train_peak_mib']:.0f} MiB); SwapAlign2Nat at p7 (lambda 32) "
        f"{tm['swap_p7_ms']:.2f} ms, peak {tm['swap_p7_peak_mib']:.0f} MiB over its "
        f"{tm['swap_p7_in_mib']:.0f} MiB input and {tm['swap_p7_out_mib']:.0f} MiB output (the "
        f"einsum order's intermediate: {tm['swap_p7_einsum_gib']:.0f} GiB) "
        + ("ok" if tm["infer_ok"] and tm["train_ok"] and tm["swap_ok"] else "FAIL"))
    lc = rc["launches"]
    log(f"[projects2] Mask R-CNN R50-FPN 3x bf16 forward {rc['rcnn_ms']:.1f} ms ({rc['detections']} "
        f"detections), K1/K3 over its 4 calls {lc['forward']}; DensePose chart heads (8 x 512, "
        f"28 x 28 gather pool, 112 x 112 maps) over them {rc['dp_infer_ms']:.1f} ms + IUV, "
        f"K1/K3 {lc['densepose_infer']}, quantise {rc['quantize_ms']:.2f} ms per detection; "
        + "; ".join(f"losses {k[8:]} on {2 * DP_ROIS_PER_IMAGE} ROIs x 196 points "
                    f"{rc[k]['ms']:.1f} ms (" + ", ".join(f"{n[14:]} {v:.4f}" for n, v in rc[k]["losses"].items())
                    + f"; peak {rc[k]['peak_mib']:.0f} MiB)" for k in ("dp_loss_plain", "dp_loss_indep_aniso"))
        + " " + ("ok" if rc["dp_infer_ok"] and rc["dp_loss_plain"]["ok"]
                 and rc["dp_loss_indep_aniso"]["ok"] else "FAIL"))
    cl = rc["cse_loss"]
    log(f"[projects2] DensePose CSE (D 16, smpl_27554, pix2shape): loss + backward {cl['ms']:.1f} ms ("
        + ", ".join(f"{k[5:]} {v:.4f}" for k, v in cl["losses"].items())
        + f"; peak {cl['peak_mib']:.0f} MiB), K1/K3 {lc['cse_loss']}; nearest vertices on 10 ROIs "
        f"{rc['cse_nearest_ms']:.1f} ms " + ("ok" if cl["ok"] and rc["cse_nearest_ok"] else "FAIL"))
    ps = rc["pointsup"]
    log(f"[projects2] PointRend subdivision (2 x 196 points, to 56 x 56) over "
        f"{rc['detections']} ROIs {rc['refine_ms']:.1f} ms; a training forward with PointSup's "
        f"mask loss ({POINTSUP_POINTS} points per instance) and PointRend's point loss on "
        f"{2 * POINTREND_ROIS} ROIs: {ps['ms']:.1f} ms, K1/K3 over its 4 calls {lc['pointsup_step']}, "
        + ", ".join(f"{k[5:]} {v:.4f}" for k, v in ps["losses"].items())
        + f"; peak {ps['peak_mib']:.0f} MiB " + ("ok" if rc["refine_ok"] and ps["ok"] else "FAIL"))
    log(f"[projects2] trident res4 stage (6 blocks, 1024 / 256, dilations 1-3, BN) on R50 res3, "
        f"b=2 {TRAIN_HW[0]}x{TRAIN_HW[1]} f32: forward + backward {tr['ms']:.1f} ms, output "
        f"{tr['out_shape']}, peak {tr['peak_mib']:.0f} MiB; shared-kernel gradient vs the sum of "
        f"the branches' parts {tr['split_err']:.2e} " + ("ok" if tr["ok"] else "FAIL"))
    calls = PROJECTS2_TIMED + 1
    want = {"forward": (2 * calls, 0), "densepose_infer": (0, 0), "densepose_loss_plain": (0, 0),
            "densepose_loss_indep_aniso": (0, 0), "cse_loss": (0, 0),
            "pointsup_step": (2 * calls, 2 * calls)}
    problems = [k for k, ok in (
        ("tensormask", tm["infer_ok"] and tm["train_ok"] and tm["swap_ok"]),
        ("densepose", rc["dp_infer_ok"] and rc["dp_loss_plain"]["ok"]
         and rc["dp_loss_indep_aniso"]["ok"]),
        ("cse", cl["ok"] and rc["cse_nearest_ok"]), ("pointrend", rc["refine_ok"]),
        ("pointsup", ps["ok"]), ("trident", tr["ok"]), ("launches", lc == want),
        ("detections", rc["detections"] > 0 and tm["detections"] > 0)) if not ok]
    if problems:
        raise AssertionError(f"projects2 failed: {problems}: {tm} {rc} {tr}")
    return dict(tensormask=tm, rcnn=rc, trident=tr,
                launches=dict(k1=sum(v[0] for v in lc.values()), k3=sum(v[1] for v in lc.values())))


def phase_projects2_cpu(dev):
    """Tiny configs of this slice's modules, f32 with TF32 off, on the card
    and on the CPU from the same weights and inputs: SwapAlign2Nat (lambda
    1, 2, 4), TensorMask losses and inference (kept detections exact), the
    point head's subdivision and PointSup's loss, a trident block in
    training mode with its gradients, the DensePose chart heads (outputs,
    losses, IUV labels exact) and the CSE heads (losses at the CPU's picks,
    nearest vertices exact)."""
    from u2seg_torch.projects import densepose as DP
    from u2seg_torch.projects import densepose_cse as CSE
    from u2seg_torch.projects import pointrend as PR
    from u2seg_torch.projects import pointsup as PS
    from u2seg_torch.projects.tensormask import TensorMask, TensorMaskConfig, swap_align2nat
    from u2seg_torch.projects.tridentnet import TridentBlock
    from u2seg_torch.structures.instances import GtInstances
    from u2seg_torch.weights import seeded_init

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(71)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    errs, exact = {}, {}

    def rel(a, b):
        b = b.detach().cpu().float()
        return float((a.detach().cpu().float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def both(module):
        """The module on the CPU and a copy of it on the card."""
        import copy

        return module, copy.deepcopy(module).to(dev)

    def on(d, tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(d)
        if isinstance(tree, dict):
            return {k: on(d, v) for k, v in tree.items()}
        return tree

    try:
        for lam in (1, 2, 4):
            x = rnd(2, 9, 10, 13)
            errs[f"swap_align2nat lambda {lam}"] = rel(swap_align2nat(x.to(dev), lam),
                                                      swap_align2nat(x, lam))
        cfg = TensorMaskConfig(num_classes=5, in_features=("p2", "p3"), num_convs=1,
                               cls_channels=8, bbox_channels=8, mask_channels=8, mask_sizes=(3, 5),
                               topk_candidates=50, max_detections=10, max_fg=8, mask_out_size=14)
        tm = seeded_init(TensorMask(cfg, 6), seed=1)
        with torch.no_grad():                   # spread the classifier: no near ties
            tm.head.cls_score.weight.mul_(300.0)
        tm_c, tm_d = both(tm)
        feats = {"p2": rnd(2, 6, 16, 20), "p3": rnd(2, 6, 8, 10)}
        sizes = torch.tensor([[64, 80], [60, 72]], dtype=torch.int32)
        boxes = torch.tensor([[[9.0, 9.0, 19.0, 19.0], [30.0, 2.0, 42.0, 14.0],
                               [17.0, 17.0, 39.0, 39.0], [0.0, 0.0, 1.0, 1.0]],
                              [[41.0, 25.0, 51.0, 35.0], [4.0, 36.0, 20.0, 52.0],
                               [10.0, 8.0, 16.0, 14.0], [0.0, 0.0, 1.0, 1.0]]])
        gt = GtInstances(boxes, torch.randint(0, 5, (2, 4), generator=g),
                         torch.tensor([[True] * 3 + [False]] * 2), torch.rand(2, 4, 16, 16, generator=g))
        lc = tm_c(feats, sizes, gt=gt, train=True)
        ld = tm_d(on(dev, feats), sizes.to(dev), gt=gt.to(dev), train=True)
        errs["TensorMask losses"] = max(rel(ld[k], lc[k]) for k in lc)
        with torch.no_grad():
            oc, od = tm_c(feats, sizes), tm_d(on(dev, feats), sizes.to(dev))
        exact["TensorMask kept detections"] = int(oc["valid"].sum()) > 0 and all(
            torch.equal(oc[k], od[k].cpu()) for k in ("valid", "classes", "mask_src_boxes"))
        errs["TensorMask boxes, scores, patches"] = max(
            rel(od[k], oc[k]) for k in ("boxes", "scores", "mask_patches"))

        ph_c, ph_d = both(seeded_init(PR.PointHead(6, 1, hidden=16), seed=2))
        fine, coarse = rnd(3, 6, 14, 14), rnd(3, 16, 16) * 3
        errs["PointRend subdivision"] = rel(
            PR.refine_mask_inference(ph_d, fine.to(dev), coarse.to(dev), 2, 30, 56),
            PR.refine_mask_inference(ph_c, fine, coarse, 2, 30, 56))
        logits, coords = rnd(5, 3, 14, 14), torch.rand(5, 10, 2, generator=g)
        cls, lab = torch.randint(0, 3, (5,), generator=g), torch.randint(-1, 2, (5, 10), generator=g).float()
        valid = torch.tensor([True, True, False, True, True])
        errs["PointSup loss"] = rel(
            PS.point_sup_mask_loss(*(a.to(dev) for a in (logits, cls, coords, lab, valid))),
            PS.point_sup_mask_loss(logits, cls, coords, lab, valid))

        tb_c, tb_d = both(seeded_init(TridentBlock(8, 16, 4), seed=3).train())
        xs = [rnd(2, 8, 10, 12) for _ in range(3)]
        outs = []
        for m, d in ((tb_c, cpu), (tb_d, dev)):
            y = m([x.to(d) for x in xs])
            sum(o.square().sum() for o in y).backward()
            outs.append(list(y) + [m.trident.weight.grad, m.conv1.weight.grad]
                        + [n.running_mean for n in m.norms])
        errs["trident block (outputs, grads, BN stats)"] = max(rel(a, b) for a, b in zip(*outs[::-1]))

        pf = {f"p{i + 2}": rnd(2, 8, 32 // 2 ** i, 32 // 2 ** i) for i in range(4)}
        bx = torch.rand(2, 3, 4, generator=g) * 60
        bx[..., 2:] = bx[..., :2] + 40.0
        dcfg = DP.DensePoseConfig(num_stacked_convs=2, conv_head_dim=16, uv_confidence="iid_iso")
        dp_c, dp_d = both(seeded_init(DP.DensePoseHeads(dcfg, 8, pooler_resolution=7), seed=4))
        with torch.no_grad():
            oc, od = dp_c(pf, bx), dp_d(on(dev, pf), bx.to(dev))
        errs["DensePose chart outputs"] = max(rel(od[k], oc[k]) for k in oc)
        ic = DP.densepose_chart_inference({k: v.flatten(0, 1) for k, v in oc.items()})
        idv = DP.densepose_chart_inference({k: v.flatten(0, 1) for k, v in od.items()})
        exact["IUV labels"] = torch.equal(ic[0], idv[0].cpu())
        errs["IUV U, V"] = max(rel(idv[i], ic[i]) for i in (1, 2))
        p = 9
        # GT boxes off the proposals by non-integer amounts: integer ones put
        # the raster's nearest resampling on exact .5 ties, which a 1-ulp
        # difference between the devices' arithmetic rounds either way
        gtd = {"gt_boxes": bx + torch.rand(2, 3, 4, generator=g) * 4,
               "dp_xy": torch.rand(2, 3, p, 2, generator=g),
               "dp_i": torch.randint(0, 25, (2, 3, p), generator=g),
               "dp_u": torch.rand(2, 3, p, generator=g), "dp_v": torch.rand(2, 3, p, generator=g),
               "dp_point_valid": torch.rand(2, 3, p, generator=g) > 0.2,
               "dp_segm": torch.randint(0, 15, (2, 3, 16, 16), generator=g)}
        live = torch.tensor([[True, True, False], [True, False, True]])
        lc = dp_c(pf, bx, train=True, gt=gtd, roi_live=live)
        ld = dp_d(on(dev, pf), bx.to(dev), train=True, gt=on(dev, gtd), roi_live=live.to(dev))
        errs["DensePose chart losses"] = max(rel(ld[k], lc[k]) for k in lc)

        mesh = CSE.MeshSpec("smpl_27554", 40)
        ccfg = CSE.CSEConfig(embed_size=6, meshes=(mesh,), pix2shape_enabled=True,
                             pix2shape_num_pixels=15)
        cs_c, cs_d = both(seeded_init(CSE.DensePoseCseHeads(ccfg, 8, head_convs=2, head_dim=16,
                                                            pooler_resolution=7), seed=5))
        e_c, e_d = both(seeded_init(CSE.Embedder(ccfg), seed=6))
        n, s = 6, 28
        pts = CSE.CsePoints(torch.rand(n, p, generator=g), torch.rand(n, p, generator=g),
                            torch.randint(0, 40, (n, p), generator=g),
                            torch.zeros((n, p), dtype=torch.long), torch.rand(n, p, generator=g) > 0.2)
        cgt = torch.randint(0, 2, (n, s, s), generator=g)
        picks = CSE.pix2shape_picks(cgt > 0, 15, g)
        lc = cs_c(pf, bx, train=True, points=pts, coarse_segm_gt=cgt, roi_live=live,
                  mesh_embeddings=[e_c(mesh.name)], picks=picks)
        pts_d = CSE.CsePoints(*(a.to(dev) for a in (pts.x, pts.y, pts.vertex_ids, pts.mesh_ids,
                                                    pts.valid)))
        ld = cs_d(on(dev, pf), bx.to(dev), train=True, points=pts_d, coarse_segm_gt=cgt.to(dev),
                  roi_live=live.to(dev), mesh_embeddings=[e_d(mesh.name)], picks=picks.to(dev))
        errs["CSE losses"] = max(rel(ld[k], lc[k]) for k in lc)
        with torch.no_grad():
            oc, od = cs_c(pf, bx), cs_d(on(dev, pf), bx.to(dev))
            vc = CSE.cse_nearest_vertices(oc["embedding"].flatten(0, 1),
                                          oc["coarse_segm"].flatten(0, 1), e_c(mesh.name))
            vd = CSE.cse_nearest_vertices(od["embedding"].flatten(0, 1),
                                          od["coarse_segm"].flatten(0, 1), e_d(mesh.name))
        exact["nearest vertices"] = all(torch.equal(a, b.cpu()) for a, b in zip(vc, vd))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    ok = max(errs.values()) <= F32_TOL and all(exact.values())
    log("[projects2_cpu] card vs CPU, f32, TF32 off, max error / max|CPU|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "; equal: "
        + ", ".join(f"{k} {v}" for k, v in exact.items()) + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"projects2_cpu failed: {errs}, exact {exact}")
    return dict(errors=errs, exact=exact)



# ---------------------------------------------------------------------------
# Phases 30-33: the user-facing entry points (demo, export, analyze_model)
# ---------------------------------------------------------------------------

DEMO_SIZES = EVAL_SIZES[:4]             # 480x640, 427x640, 640x480, 500x375
EXPORT_HW = (800, 1216)
# a fresh process that loads an exported program with nothing of the model
# code path: argv = artifact dir, inputs .pt, outputs .pt
EXPORT_CHILD = r"""
import json, sys, time
import torch
from u2seg_torch.engine.export import load_exported
from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k1

path, inp, outp = sys.argv[1:4]
t0 = time.perf_counter()
fn = load_exported(path)
load_s = time.perf_counter() - t0
images, sizes = torch.load(inp)
for _ in range(2):
    fn(images, sizes)
torch.cuda.synchronize()
k1.launches = 0
outs = fn(images, sizes)
torch.cuda.synchronize()
launches = k1.launches
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(5):
    fn(images, sizes)
b.record()
torch.cuda.synchronize()
torch.save([o.cpu() for o in outs], outp)
print("CHILD " + json.dumps(dict(
    load_s=load_s, ms=a.elapsed_time(b) / 5, launches=launches,
    model_code_imported=any(m.startswith("u2seg_torch.models") for m in sys.modules))),
    flush=True)
"""


def demo_model(dev):
    """The default Config() at full width with seeded, calibrated weights,
    and the fusion threshold at 0.05 (``--confidence-threshold 0.05``):
    seeded heads score no instance above the default 0.5."""
    from u2seg_torch.config import Config
    from u2seg_torch.models.build import build_model

    cfg = Config()
    cfg.model.panoptic.instance_conf_thresh = cfg.model.roi_heads.score_thresh_test
    return cfg, calibrate(build_model(cfg, device=dev, seed=0))


def phase_demo(dev):
    """``VisualizationDemo.run_on_image`` (predict, Hungarian remap, draw)
    on four eval scenes, the image written with Pillow; then the CLI
    ``u2seg_demo.main`` on one file."""
    import tempfile

    from u2seg_torch.data.image_io import write_png
    from u2seg_torch.demo import u2seg_demo
    from u2seg_torch.demo.predictor import VisualizationDemo
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k1
    from u2seg_torch.utils.visualizer import Visualizer, write_image

    cfg, model = demo_model(dev)
    rng = np.random.RandomState(13)
    imgs = [scene(rng, h, w).astype(np.uint8) for h, w in DEMO_SIZES]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        with open(os.path.join(tmp, "instance_mapping.json"), "w") as f:
            json.dump({str(c): (7 * c) % 800 for c in range(800)}, f)
        demo = VisualizationDemo(cfg, tmp, device=dev, model=model)
        if demo.instance_mapping is None or demo.predictor.device.type != dev.type:
            raise AssertionError("the demo lacks its mapping or is not on the card")
        for im in imgs:                                   # warm-up, per bucket
            demo.run_on_image(im)
        torch.cuda.synchronize()
        rows = []
        k1.launches = 0                                   # the main path starts
        for i, im in enumerate(imgs):
            t0 = time.perf_counter()
            pred = demo.predictor(im)
            t1 = time.perf_counter()
            drawn = demo.draw(im, pred)
            t2 = time.perf_counter()
            write_image(os.path.join(tmp, f"demo_{i}.jpg"), drawn)
            t3 = time.perf_counter()
            # the drawing again, from a visualizer over the same fetched
            # predictions, on the host
            segs = [dict(s, category_id=demo.instance_mapping.get(s["category_id"],
                                                                   s["category_id"]))
                    for s in pred["segments"]]
            again = Visualizer(im, demo.metadata).draw_panoptic_seg(pred["panoptic"], segs)
            things = sum(s["isthing"] for s in pred["segments"])
            row = dict(h=im.shape[0], w=im.shape[1], predict_ms=(t1 - t0) * 1e3,
                       draw_ms=(t2 - t1) * 1e3, write_ms=(t3 - t2) * 1e3,
                       instances=len(pred["instances"]["scores"]), things=things,
                       segments=len(pred["segments"]), same=bool(np.array_equal(drawn, again)))
            rows.append(row)
            log(f"[demo] {row['h']}x{row['w']}: predict {row['predict_ms']:.1f} ms, draw "
                f"{row['draw_ms']:.1f} ms, write {row['write_ms']:.1f} ms; {row['instances']} "
                f"instances, {things} thing and {row['segments'] - things} stuff segments "
                f"drawn; equal to the visualizer over the same predictions: {row['same']} "
                f"({smi_line()})")
            if not (row["same"] and things > 0 and drawn.shape == im.shape):
                raise AssertionError(f"demo image {i}: {row}")
        launches = k1.launches                            # the main path ends
        log(f"[demo] K1 launches {launches} over {len(imgs)} images "
            f"({launches / len(imgs):.1f} per image; 4 expected)")
        if launches != 4 * len(imgs):
            raise AssertionError(f"expected {4 * len(imgs)} K1 launches, got {launches}")
        # the command line on one file (its own seeded model: no calibration)
        src = os.path.join(tmp, "scene.png")
        write_png(src, imgs[0])
        k1.launches = 0
        t0 = time.perf_counter()
        (_, pred, _), = u2seg_demo.main(["--config-file", "", "--input", src, "--output",
                                        os.path.join(tmp, "out"), "--confidence-threshold",
                                        "0.05"])
        cli_s = time.perf_counter() - t0
        cli_launches = k1.launches
        log(f"[demo] u2seg_demo.main on one file: {cli_s:.2f} s with the model build, "
            f"{len(pred['instances']['scores'])} instances, K1 launches {cli_launches}")
        if cli_launches != 4 or not os.path.exists(os.path.join(tmp, "out", "scene.png")):
            raise AssertionError("the demo's command line did not run its forward")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    med = {k: float(np.median([r[k] for r in rows])) for k in ("predict_ms", "draw_ms",
                                                              "write_ms")}
    log(f"[demo] median per image: predict {med['predict_ms']:.1f} ms, draw "
        f"{med['draw_ms']:.1f} ms, write {med['write_ms']:.1f} ms ({smi_line()})")
    return dict(rows=rows, median=med, launches=launches + cli_launches,
                k1=launches + cli_launches, cli_s=cli_s)


def flat_agreement(got, ref, names) -> dict:
    """Card vs card (or card vs CPU) flat outputs of an exported forward:
    max|a-b| / max|b| of every float output, the share of equal elements of
    every discrete one."""
    res = {}
    for name, a, b in zip(names, got, ref):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            res[name] = float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp(min=1e-30))
        else:
            res[name] = float((a == b).float().mean())
    return res


def phase_export(dev):
    """``export_inference`` of the default Config() at b=1, 800x1216 on the
    card, loaded in a fresh process that imports ``u2seg_torch`` and none of
    its model code: seconds, MB, eager against loaded forward ms, K1 launches
    per loaded call, outputs against the eager forward's."""
    import subprocess
    import tempfile

    from u2seg_torch.engine.export import export_inference, load_schema

    cfg, model = demo_model(dev)
    h, w = EXPORT_HW
    img = torch.from_numpy(scene(np.random.RandomState(14), h, w))[None].to(dev)
    sz = torch.tensor([[h, w]], dtype=torch.int32, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        t0 = time.perf_counter()
        program = export_inference(model, (1, h, w, 3), os.path.join(tmp, "a"), device=dev)
        total_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.export.save(program, os.path.join(tmp, "resave.pt2"))
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(tmp, "a", "model.pt2")) / 2 ** 20
        names = [o["name"] for o in load_schema(os.path.join(tmp, "a"))["outputs"]]
        k1_nodes = sum("multilevel_roi_align" in str(n.target) for n in program.graph.nodes)
        del program
        eager = [t for t in torch.utils._pytree.tree_leaves(model(img, sz, combine=True))]
        eager_ms = cuda_ms(lambda: model(img, sz, combine=True), iters=5)
        torch.save((img, sz), os.path.join(tmp, "in.pt"))
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, os.path.join(tmp, "a"),
                               os.path.join(tmp, "in.pt"), os.path.join(tmp, "out.pt")],
                              cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"loading the exported program failed:\n{proc.stderr[-4000:]}")
        child = json.loads(next(ln for ln in proc.stdout.splitlines()
                                if ln.startswith("CHILD "))[6:])
        loaded = torch.load(os.path.join(tmp, "out.pt"))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    agree = flat_agreement(loaded, eager, names)
    bit_equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(loaded, eager))
    res = dict(export_s=total_s - save_s, save_s=save_s, load_s=child["load_s"], mb=mb,
               eager_ms=eager_ms, loaded_ms=child["ms"], launches=child["launches"],
               k1=child["launches"], k1_nodes=k1_nodes, bit_equal=bit_equal, agree=agree,
               model_code_imported=child["model_code_imported"])
    log(f"[export] default Config() b=1 {h}x{w}: export {res['export_s']:.1f} s, save "
        f"{save_s:.1f} s, load in a fresh process {res['load_s']:.1f} s, artifact {mb:.1f} MB, "
        f"{k1_nodes} K1 nodes; forward eager {eager_ms:.2f} ms, loaded {child['ms']:.2f} ms; "
        f"K1 launches per loaded call {child['launches']}; model code imported by the loader: "
        f"{child['model_code_imported']} ({smi_line()})")
    log(f"[export] loaded vs eager outputs: bit-equal {bit_equal}; " + ", ".join(
        f"{k} {v:.3g}" for k, v in agree.items()) + " (floats: max|diff|/max; discrete: "
        "equal share. Tolerance: bit-equal, or sem logits <= 0.05 and detection slots "
        "(valid, class) >= 0.97, panoptic pixels >= 0.98, as in eval: the program runs "
        "the graph's decomposed ops, which may sum in another order, in bf16)")
    ok = bit_equal or (agree["sem_seg_logits"] <= 0.05 and min(
        agree["detections.valid"], agree["detections.classes"]) >= 0.97
        and agree["panoptic"] >= 0.98)
    if not ok or child["launches"] != 4 or k1_nodes != 4 or child["model_code_imported"]:
        raise AssertionError(f"export: {res}")
    return res


def phase_analyze(dev):
    """``tools/analyze_model`` on the default Config() at 800x1344."""
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k1
    from u2seg_torch.tools import analyze_model

    k1.launches = 0
    res = analyze_model.main(["--height", "800", "--width", "1344"])
    res["k1"] = k1.launches
    log(f"[analyze] default Config() at 800x1344: {res['parameters'] / 1e6:.2f} M "
        f"parameters, {res['flops'] / 1e9:.1f} GFLOPs (" + ", ".join(
            f"{k} {v / 1e9:.1f}" for k, v in sorted(res["flops_by_op"].items())) +
        f"), {res['bytes_accessed'] / 1e9:.1f} GB, {res['seconds']:.1f} s; K1 launches "
        f"{res['k1']} ({smi_line()})")
    if res["k1"] != 4 or not res["flops"] > 0:
        raise AssertionError(f"analyze_model: {res}")
    return {k: v for k, v in res.items() if k != "modules"}


def phase_tools_cpu(dev):
    """The tiny config in f32 (TF32 off), pooler_impl="pallas" (K1 on the
    card): ``export_inference`` + ``load_exported`` on the card and on the
    CPU, and the demo on one image, same seed, same input. Tolerances as in
    ``eval_cpu``: sem logits max|diff| / max <= 1e-4 (``cpu``'s 1e-3 at full
    width), detections agreeing (class, box < 0.5 px) on >= 90% of the CPU's,
    panoptic maps equal on >= 98% of pixels, drawn images on >= 98%."""
    import tempfile

    from u2seg_torch.demo.predictor import VisualizationDemo
    from u2seg_torch.engine.export import export_inference, load_exported
    from u2seg_torch.models.build import build_model

    cfg = tiny_eval_config()
    h, w = cfg.input.pad_buckets[0]
    img = torch.from_numpy(scene(np.random.RandomState(15), h, w))[None]
    sz = torch.tensor([[h, w - 8]], dtype=torch.int32)
    outs, demos = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_cpu_")
    try:
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            model = build_model(cfg, device=device, seed=3)
            path = os.path.join(tmp, name)
            export_inference(model, (1, h, w, 3), path, device=device)
            outs[name] = load_exported(path)(img.to(device), sz.to(device))
            demo = VisualizationDemo(cfg, device=device, model=model)
            demos[name] = demo.run_on_image(scene(np.random.RandomState(16), 40, 80)
                                            .astype(np.uint8))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    c, g = [t.cpu() for t in outs["cpu"]], [t.cpu() for t in outs["gpu"]]
    sem_err = float((c[5] - g[5]).abs().max() / c[5].abs().max())
    valid_c, valid_g = c[3][0], g[3][0]
    ok = 0
    for j in torch.nonzero(valid_c).flatten().tolist():
        d = ((g[0][0] - c[0][0][j]).abs().amax(-1) < 0.5) & (g[2][0] == c[2][0][j]) & valid_g
        ok += bool(d.any())
    det = ok / max(int(valid_c.sum()), 1)
    pan = float((c[6] == g[6]).float().mean())
    (pc, dc), (pg, dg) = demos["cpu"], demos["gpu"]
    demo_pan = float((pc["panoptic"] == pg["panoptic"]).mean())
    demo_px = float((dc == dg).all(-1).mean())
    res = dict(sem_err=sem_err, det_agree=det, detections=int(valid_c.sum()), pan=pan,
               demo_pan=demo_pan, demo_pixels=demo_px)
    log(f"[tools-cpu] tiny config f32, card vs CPU: exported program sem logits "
        f"max|diff|/max {sem_err:.2e} (tol 1e-4), detections agreeing {det:.4f} of "
        f"{res['detections']} (tol 0.9), panoptic pixels {pan:.4f} (tol 0.98); demo on one "
        f"image: panoptic pixels {demo_pan:.4f} (tol 0.98), drawn pixels {demo_px:.4f} "
        f"(tol 0.98)")
    if not (sem_err <= 1e-4 and res["detections"] > 0 and det >= 0.9 and pan >= 0.98
            and demo_pan >= 0.98 and demo_px >= 0.98):
        raise AssertionError(f"tools: card and CPU disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase matcher: the host C++ behind COCOeval against its numpy twins
# ---------------------------------------------------------------------------

MATCHER_IMAGES = 64
MATCHER_DETECTIONS = 100           # detections_per_image of U2Seg's test config
MATCHER_CATS = (1, 2, 3, 4, 5, 6, 7, 8)


def ellipse_mask(h: int, w: int, box) -> np.ndarray:
    """A filled ellipse inscribed in the XYWH ``box``, on an (h, w) canvas."""
    m = np.zeros((h, w), np.uint8)
    x, y, bw, bh = box
    x0, y0 = max(int(x), 0), max(int(y), 0)
    x1, y1 = min(int(np.ceil(x + bw)), w), min(int(np.ceil(y + bh)), h)
    if x1 <= x0 or y1 <= y0:
        return m
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32) + 0.5
    u = (xx - (x + bw / 2)) / (bw / 2)
    v = (yy - (y + bh / 2)) / (bh / 2)
    m[y0:y1, x0:x1] = u * u + v * v <= 1.0
    return m


def matcher_set(seed: int = 0):
    """64 images at the eval scene sizes, 4-12 GT per image over 8 categories
    (crowd ~10%), ellipse masks as compressed RLE; 100 detections per image:
    jittered GT (70%, a fifth of them in another category) and false
    positives, with score ties. Every detection has its box, its mask and
    the mask's area. Masks are encoded by the C++ ``encode``."""
    from u2seg_torch import _native

    rng = np.random.RandomState(seed)
    sizes = (EVAL_SIZES * (MATCHER_IMAGES // len(EVAL_SIZES) + 1))[:MATCHER_IMAGES]
    images, gts, dts, masks = [], [], [], []
    for i, (h, w) in enumerate(sizes):
        images.append({"id": i + 1, "height": h, "width": w})
        anns = []
        for _ in range(rng.randint(4, 13)):
            bw, bh = rng.uniform(12, 0.6 * w), rng.uniform(12, 0.6 * h)
            box = [rng.rand() * (w - bw), rng.rand() * (h - bh), bw, bh]
            m = ellipse_mask(h, w, box)
            enc = _native.encode(m)
            ann = {"id": len(gts) + 1, "image_id": i + 1,
                   "category_id": int(rng.choice(MATCHER_CATS)), "bbox": box,
                   "segmentation": {"size": enc["size"], "counts": enc["counts"].decode()},
                   "area": float(m.sum()), "iscrowd": int(rng.rand() < 0.1)}
            gts.append(ann)
            anns.append(ann)
            masks.append(m)
        for _ in range(MATCHER_DETECTIONS):
            if rng.rand() < 0.7:
                a = anns[rng.randint(len(anns))]
                box = (np.asarray(a["bbox"]) + rng.randn(4) * rng.choice([1.0, 6.0, 25.0])).tolist()
                cat = a["category_id"] if rng.rand() < 0.8 else int(rng.choice(MATCHER_CATS))
            else:
                bw, bh = rng.uniform(8, 0.5 * w), rng.uniform(8, 0.5 * h)
                box = [rng.rand() * (w - bw), rng.rand() * (h - bh), bw, bh]
                cat = int(rng.choice(MATCHER_CATS))
            box[2], box[3] = max(box[2], 2.0), max(box[3], 2.0)
            m = ellipse_mask(h, w, box)
            enc = _native.encode(m)
            dts.append({"image_id": i + 1, "category_id": cat, "bbox": box,
                        "segmentation": {"size": enc["size"], "counts": enc["counts"].decode()},
                        "area": float(m.sum()),
                        "score": float(rng.choice([0.9, 0.5, rng.rand()]))})
            if len(masks) < 400:
                masks.append(m)
    gt = {"images": images, "annotations": gts,
          "categories": [{"id": c, "name": str(c)} for c in MATCHER_CATS]}
    return gt, dts, masks


def codec_check(masks) -> dict:
    """The C++ encode / decode / area / merge against the numpy codec."""
    from u2seg_torch import _native
    from u2seg_torch.evaluation import rle

    for m in masks:
        enc = rle.encode(m)
        if (_native.encode(m)["counts"] != enc["counts"]
                or not np.array_equal(_native.decode(enc), m)
                or not _native.area(enc) == rle.area(enc) == int(m.sum())):
            raise AssertionError("the C++ RLE codec disagrees with the numpy codec")
    by_size = {}
    for m in masks:
        by_size.setdefault(m.shape, []).append(rle.encode(m))
    for group in by_size.values():
        for intersect in (False, True):
            if (_native.merge(group[:6], intersect)["counts"]
                    != rle.merge(group[:6], intersect)["counts"]):
                raise AssertionError("the C++ merge disagrees with the numpy merge")
    return {"masks": len(masks)}


def phase_matcher(report: dict):
    """The host matcher on the card's host: build, then COCOeval with the C++
    functions against COCOeval on their numpy twins (``PlainCOCOeval``)."""
    import copy

    from u2seg_torch import _native
    from u2seg_torch.evaluation.coco_api import COCO
    from u2seg_torch.evaluation.coco_eval_core import COCOeval, PlainCOCOeval

    t0 = time.perf_counter()
    built_before = os.path.exists(_native.library_path())
    path = _native.build()
    build_s = time.perf_counter() - t0
    log(f"[matcher] g++ {' '.join(_native.CXX_FLAGS)}: {os.path.basename(path)} "
        f"{'found' if built_before else 'built'} in {build_s:.2f} s")
    t0 = time.perf_counter()
    gt, dts, masks = matcher_set()
    set_s = time.perf_counter() - t0
    codec = codec_check(masks)
    log(f"[matcher] {MATCHER_IMAGES} images, {len(gt['annotations'])} GT "
        f"({sum(a['iscrowd'] for a in gt['annotations'])} crowd), {len(dts)} detections "
        f"({MATCHER_DETECTIONS} per image) drawn in {set_s:.1f} s; C++ encode, decode, area "
        f"and merge == numpy on {codec['masks']} masks ok")
    out = {"build_s": build_s, "built_before": built_before, "images": MATCHER_IMAGES,
           "detections": len(dts)}
    for kind in ("bbox", "segm"):
        evs, ms = [], []
        for cls in (COCOeval, PlainCOCOeval):
            coco_gt = COCO(copy.deepcopy(gt))
            ev = cls(coco_gt, coco_gt.loadRes(copy.deepcopy(dts)), iouType=kind)
            t0 = time.perf_counter()
            ev.evaluate()
            ms.append((time.perf_counter() - t0) * 1e3)
            ev.accumulate()
            ev.summarize()
            evs.append(ev)
        nat, plain = evs
        if nat.ious.keys() != plain.ious.keys():
            raise AssertionError(f"{kind}: the IoU matrices cover other (image, category) pairs")
        iou_err = max((float(np.abs(nat.ious[k] - plain.ious[k]).max())
                       for k in nat.ious if nat.ious[k].size), default=0.0)
        pairs = sum(v.size for v in nat.ious.values())
        same = len(nat.evalImgs) == len(plain.evalImgs) and all(
            (a is None) == (b is None) and (a is None or all(
                np.array_equal(a[f], b[f]) for f in ("dtMatches", "gtMatches", "dtIgnore")))
            for a, b in zip(nat.evalImgs, plain.evalImgs))
        ok = iou_err <= 1e-12 and same and np.array_equal(nat.stats, plain.stats)
        log(f"[matcher] {kind}: evaluate() C++ {ms[0]:.1f} ms ({ms[0] / MATCHER_IMAGES:.2f} "
            f"per image), numpy {ms[1]:.1f} ms ({ms[1] / MATCHER_IMAGES:.2f} per image), "
            f"x{ms[1] / ms[0]:.1f}; {pairs} IoU pairs, max|C++ - numpy| {iou_err:.1e}; "
            f"dtm/gtm/dtIg {'equal' if same else 'DIFFER'}; AP {nat.stats[0]:.4f} / "
            f"{plain.stats[0]:.4f}, 12 stats {'equal' if np.array_equal(nat.stats, plain.stats) else 'DIFFER'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kind}: the C++ matcher disagrees with its numpy twins")
        out[kind] = {"ms": ms[0], "plain_ms": ms[1], "ms_per_image": ms[0] / MATCHER_IMAGES,
                     "plain_ms_per_image": ms[1] / MATCHER_IMAGES, "iou_pairs": pairs,
                     "max_iou_err": iou_err, "stats": nat.stats.tolist()}
    if "dataset_eval" in report:
        ce = report["dataset_eval"]["cocoeval"]
        log(f"[matcher] dataset_eval's COCOeval (bbox, C++ matcher) on the model's "
            f"{ce['detections']} boxes: {ce['ms']:.1f} ms, {ce['ms_per_image']:.2f} ms per image")
        out["dataset_eval_cocoeval"] = ce
    return out


# ---------------------------------------------------------------------------
# Phase overfit: many train steps on one fixed batch must cut the loss
# ---------------------------------------------------------------------------

OVERFIT_STEPS = 150                 # the JAX package's dev/run_overfit_tpu.py
FULL_OVERFIT_STEPS = 50
TINY_HW = (64, 64)                  # testing.tiny_batch: FPN levels 16x16 .. 2x2


def tiny_pyramid_check(rap, dev) -> float:
    """K1 and K3 against their plain versions at the tiny config's shapes:
    b=8 at 64x64, p2-p5 of 16x16 .. 2x2 (+ the 1x1 virtual level), C=256,
    f32; R=256 at s=7 and R=64 at s=14 (GT-like boxes, proposals of 2-64
    px, a zero box, a box past the corner): the levels are smaller than a
    K1 span."""
    (h, w), strides, c = TINY_HW, (4, 8, 16, 32), 256
    gen = torch.Generator(device=dev).manual_seed(11)
    feats = [torch.randn(8, h // st, w // st, c, generator=gen, device=dev) for st in strides]
    rng = np.random.RandomState(11)
    worst = 0.0
    for s, n in ((7, 256), (14, 64)):
        cx, cy = rng.rand(n) * w, rng.rand(n) * h
        bw = np.exp(rng.uniform(np.log(2), np.log(64), n))
        bh = bw * np.exp(rng.uniform(-1.0, 1.0, n))
        b = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).clip(0, w)
        b[:2] = [[10.0, 10.0, 10.0, 10.0], [40.0, 44.0, 90.0, 100.0]]
        boxes = torch.from_numpy(b.astype(np.float32)).to(dev)
        bidx = torch.from_numpy(rng.randint(0, 8, n).astype(np.int32)).to(dev)
        ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, strides)
        got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, strides)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        if err > F32_TOL * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"K1 disagrees with its plain version at 64x64: s={s}, "
                                 f"max|diff| {err:.3e}")
        g = torch.randn(n, s, s, c, generator=gen, device=dev)
        ext, st_ext = rap._append_virtual_level(feats, strides)
        leaves = [f.clone().requires_grad_() for f in ext]
        ref_g = torch.autograd.grad(
            rap._ref_ext(leaves, boxes, bidx, s, st_ext, 2, 224.0, 4), leaves, g)
        fa = rap._prepare_ext(ext, boxes, bidx, s, 2, st_ext, 224.0, 4, torch.float32)
        got_g = rap.multilevel_roi_align_backward(rap.prepare_backward(
            g, fa.roi_i, fa.roi_f, [tuple(f.shape) for f in ext], s, 2))
        torch.cuda.synchronize()
        for lvl, (a, b_) in enumerate(zip(got_g, ref_g)):
            err = float((a - b_).abs().max())
            worst = max(worst, err)
            if err > F32_TOL * max(1.0, float(b_.abs().max())):
                raise AssertionError(f"K3 disagrees with its plain version at 64x64: s={s} "
                                     f"level {lvl}, max|diff| {err:.3e}")
    log(f"[overfit] K1 and K3 at the tiny shapes (b=8, levels 16x16..2x2 + 1x1, C=256, f32, "
        f"R=256 at s=7 / 64 at s=14): max|kernel-plain| {worst:.3e} "
        f"(tol {F32_TOL:g} * max(1, max|plain|)) ok")
    return worst


def curve_summary(losses) -> dict:
    return {"first5_mean": float(np.mean(losses[:5])), "last5_mean": float(np.mean(losses[-5:])),
            "finite": bool(np.isfinite(losses).all())}


def phase_overfit(dev):
    """(a) ``dev/run_overfit.run_overfit`` on the card: the tiny config, lr
    0.08, 150 steps, the JAX script's assertions; (b) the default Config()
    at full width, 50 steps at lr 0.02 (warmup 2) on one fixed
    ``train_batch(cfg, 2, 800, 1344)``: finite, last-5 mean below first-5."""
    from u2seg_torch.config import Config
    from u2seg_torch.dev.run_overfit import run_overfit
    from u2seg_torch.engine.trainer import create_train_state, make_train_step, sampling_seed
    from u2seg_torch.ops import roi_align_ml as rap

    check_err = tiny_pyramid_check(rap, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_counts()                                   # the main path starts
    tiny = run_overfit(OVERFIT_STEPS, 0.08, device=dev, log=None)
    k1, k3 = kernel_counts()                                # the main path ends
    tiny_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    losses = tiny["total_loss"]
    log("[overfit] tiny config (R50-FPN, 7 classes, f32, b=8 at 64x64), lr 0.08: total "
        + " ".join(f"{losses[i]:.3f}" for i in range(0, OVERFIT_STEPS, 10))
        + f" ... {losses[-1]:.3f}; rpn_cls {tiny['loss_rpn_cls'][0]:.3f} -> "
        f"{tiny['loss_rpn_cls'][-1]:.3f}")
    log(f"[overfit] tiny: first-5 mean {tiny['first5_mean']:.4f}, last-5 mean "
        f"{tiny['last5_mean']:.4f} (< 0.8 x), last loss_rpn_cls {tiny['loss_rpn_cls'][-1]:.4f} "
        f"(< 0.5); {tiny['seconds'] * 1e3 / OVERFIT_STEPS:.1f} ms per step, peak "
        f"{tiny_peak:.0f} MiB; K1 {k1}, K3 {k3} launches {'ok' if tiny['ok'] else 'FAIL'}")
    if not tiny["ok"]:
        raise AssertionError(f"the tiny config did not learn: {curve_summary(losses)}, "
                             f"last loss_rpn_cls {tiny['loss_rpn_cls'][-1]}")
    if k1 != 4 * OVERFIT_STEPS or k3 != 4 * OVERFIT_STEPS:
        raise AssertionError(f"expected {4 * OVERFIT_STEPS} + {4 * OVERFIT_STEPS} launches, "
                             f"got {k1} + {k3}")

    cfg = Config()
    cfg.solver.base_lr = 0.02
    cfg.solver.warmup_iters = 2
    (h, w), b = TRAIN_HW, 2
    state = create_train_state(cfg, device=dev, seed=0)
    step = make_train_step(state.model, state.optimizer)
    batch = train_batch(cfg, b, h, w).to(dev)
    gen = torch.Generator(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_counts()                                   # the main path starts
    full, ms = [], []
    for i in range(FULL_OVERFIT_STEPS):
        gen.manual_seed(sampling_seed(7, 0, i))
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        full.append(float(metrics["total_loss"]))           # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    fk1, fk3 = kernel_counts()                              # the main path ends
    full_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    fs = curve_summary(full)
    ok = fs["finite"] and fs["last5_mean"] < fs["first5_mean"]
    log("[overfit] full width (default Config(): R50-FPN, cascade over 800 classes, masks, "
        "28 sem-seg classes, bf16; b=2 at 800x1344), lr 0.02: total "
        + " ".join(f"{full[i]:.3f}" for i in range(0, FULL_OVERFIT_STEPS, 5))
        + f" ... {full[-1]:.3f}")
    log(f"[overfit] full width: first-5 mean {fs['first5_mean']:.4f}, last-5 mean "
        f"{fs['last5_mean']:.4f}; {float(np.median(ms[1:])):.1f} ms per step (median; first "
        f"{ms[0]:.1f}), peak {full_peak:.0f} MiB; K1 {fk1}, K3 {fk3} launches "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the full-width run did not learn: {fs}")
    if fk1 != 4 * FULL_OVERFIT_STEPS or fk3 != 4 * FULL_OVERFIT_STEPS:
        raise AssertionError(f"expected {4 * FULL_OVERFIT_STEPS} + {4 * FULL_OVERFIT_STEPS} "
                             f"launches, got {fk1} + {fk3}")
    del state, step, batch
    torch.cuda.empty_cache()
    tiny_out = {k: v for k, v in tiny.items() if k != "device"}
    return {"check_max_abs_err": check_err,
            "tiny": dict(tiny_out, peak_mib=tiny_peak,
                         ms_per_step=tiny["seconds"] * 1e3 / OVERFIT_STEPS),
            "full": dict(fs, total_loss=full, ms=ms, peak_mib=full_peak),
            "k1": k1 + fk1, "k3": k3 + fk3}


def main():
    all_phases = ["k1", "k3", "k4", "k5", "serve", "cpu", "eval", "eval_cpu",
                  "dataset_eval", "dataset_eval_cpu", "matcher", "train", "train_cpu",
                  "overfit", "train_loop",
                  "ddp", "ddp_cpu", "train_net", "train_net_cpu", "pseudo", "pseudo_cpu",
                  "zoo", "zoo_cpu", "augment", "semisup", "rotated", "projects", "projects_cpu",
                  "projects2", "projects2_cpu", "demo", "export", "analyze", "tools_cpu"]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write every number as JSON here")
    ap.add_argument("--phases", default=",".join(all_phases),
                    help="comma-separated subset of %(default)s")
    ap.add_argument("--ddp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ddp-init", help=argparse.SUPPRESS)
    ap.add_argument("--ddp-out", help=argparse.SUPPRESS)
    ap.add_argument("--ddp-task", default="train", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ddp_rank is not None:              # one rank of phase ddp or of ShuffleBN
        worker = shufflebn_worker if args.ddp_task == "shufflebn" else ddp_worker
        worker(args.ddp_rank, args.ddp_init, args.ddp_out)
        return
    phases = args.phases.split(",")
    if not set(phases) <= set(all_phases):
        ap.error(f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from u2seg_torch import _cuda

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | count "
        f"{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    paths = _cuda.build(["roi_align_ml", "roi_align_single", "window_probe"])
    build_s = time.perf_counter() - t_start
    log(f"[build] {len(paths)} kernel libraries built in {build_s:.1f} s")
    for name, p in paths.items():
        if os.path.exists(p + ".log"):
            with open(p + ".log") as f:
                for line in f:
                    if ("registers" in line or "Compiling entry" in line
                            or "spill" in line):
                        log(f"[build] {name}: {line.strip()}")

    report = {"smi": smi, "build_s": build_s, "phases": phases}
    if "k1" in phases:
        report["kernel"] = phase_kernel(dev)
    if "k3" in phases:
        report["kernel_backward"] = phase_kernel_backward(dev)
    if "k4" in phases:
        report["k4"] = phase_k4(dev)
    if "k5" in phases:
        report["k5"] = phase_k5(dev)
        torch.cuda.empty_cache()
    if "serve" in phases:
        rows, launches, model, reqs = phase_slice(dev)
        report.update(slice=rows, launches=launches, profile=[
            phase_profile(model, reqs[0]), phase_profile(model, reqs[-1])])
        del model, reqs
    if "cpu" in phases:
        report["cpu_parity"] = phase_cpu_parity(dev)
    if "eval" in phases:
        torch.cuda.empty_cache()
        report["eval"] = phase_eval(dev)
        torch.cuda.empty_cache()
    if "eval_cpu" in phases:
        report["eval_cpu"] = phase_eval_cpu(dev)
    if "dataset_eval" in phases:
        torch.cuda.empty_cache()
        report["dataset_eval"] = phase_dataset_eval(dev)
        torch.cuda.empty_cache()
    if "dataset_eval_cpu" in phases:
        report["dataset_eval_cpu"] = phase_dataset_eval_cpu(dev)
    if "matcher" in phases:
        report["matcher"] = phase_matcher(report)
    if "train" in phases:
        torch.cuda.empty_cache()
        report["train"] = phase_train(dev)
        torch.cuda.empty_cache()
    if "train_cpu" in phases:
        report["train_cpu_parity"] = phase_train_cpu_parity(dev)
    if "overfit" in phases:
        torch.cuda.empty_cache()
        report["overfit"] = phase_overfit(dev)
    if "train_loop" in phases:
        torch.cuda.empty_cache()
        bare = (float(np.median([r["ms"] for r in report["train"]["steps"]]))
                if "train" in report else None)
        report["train_loop"] = phase_train_loop(dev, bare)
        torch.cuda.empty_cache()
    if "ddp" in phases:
        report["ddp"] = phase_ddp()
    if "ddp_cpu" in phases:
        report["ddp_cpu"] = phase_ddp_cpu()
    if "train_net" in phases:
        torch.cuda.empty_cache()
        bare = (float(np.median([r["ms"] for r in report["train"]["steps"]]))
                if "train" in report else None)
        report["train_net"] = phase_train_net(dev, bare)
        torch.cuda.empty_cache()
    if "train_net_cpu" in phases:
        report["train_net_cpu"] = phase_train_net_cpu(dev)
    if "pseudo" in phases:
        torch.cuda.empty_cache()
        report["pseudo"] = phase_pseudo(dev)
        torch.cuda.empty_cache()
    if "pseudo_cpu" in phases:
        report["pseudo_cpu"] = phase_pseudo_cpu(dev)
    if "zoo" in phases:
        torch.cuda.empty_cache()
        report["zoo"] = phase_zoo(dev)
        torch.cuda.empty_cache()
    if "zoo_cpu" in phases:
        report["zoo_cpu"] = phase_zoo_cpu(dev)
    if "augment" in phases:
        torch.cuda.empty_cache()
        report["augment"] = phase_augment(dev)
        torch.cuda.empty_cache()
    if "semisup" in phases:
        report["semisup"] = phase_semisup(dev)
    if "rotated" in phases:
        report["rotated"] = phase_rotated(dev)
    if "projects" in phases:
        torch.cuda.empty_cache()
        report["projects"] = phase_projects(dev)
        torch.cuda.empty_cache()
    if "projects_cpu" in phases:
        report["projects_cpu"] = phase_projects_cpu(dev)
    if "projects2" in phases:
        torch.cuda.empty_cache()
        report["projects2"] = phase_projects2(dev)
        torch.cuda.empty_cache()
    if "projects2_cpu" in phases:
        report["projects2_cpu"] = phase_projects2_cpu(dev)
    if "demo" in phases:
        torch.cuda.empty_cache()
        report["demo"] = phase_demo(dev)
    if "export" in phases:
        torch.cuda.empty_cache()
        report["export"] = phase_export(dev)
    if "analyze" in phases:
        torch.cuda.empty_cache()
        report["analyze"] = phase_analyze(dev)
    if "tools_cpu" in phases:
        report["tools_cpu"] = phase_tools_cpu(dev)
    log(f"[done] phases {','.join(phases)} in {time.perf_counter() - t_start:.0f} s")

    if phases == all_phases:
        k1, k3, tr = report["kernel"], report["kernel_backward"], report["train"]
        k4, k5, ev = report["k4"], report["k5"], report["eval"]
        eval_launches = sum(m["k1_launches"] for m in ev["modes"].values())
        loops = [report["train_loop"]["launches"], report["train_loop"]["resumed_launches"],
                 report["ddp"]["ranks"][0]["launches"],         # rank 0's counts
                 report["train_net"]["launches"], report["train_net_cpu"]["launches"]]
        dataset_launches = (report["dataset_eval"]["launches"]
                            + report["train_net"]["eval_k1"])
        zoo = report["zoo"]["launches"]
        # the rotation-augmented training, the BN-head Mask R-CNN
        slice12 = [report["augment"]["launches"], report["projects"]["launches"]]
        # the demo, the loaded exported program, analyze_model
        slice13 = [report[p]["k1"] for p in ("demo", "export", "analyze")]
        # the Mask R-CNN under DensePose, PointRend, PointSup
        slice14 = report["projects2"]["launches"]
        # this slice's path: the overfit runs, tiny and full width
        slice15 = report["overfit"]
        fwd_launches = (report["launches"] + eval_launches + dataset_launches
                        + tr["forward_launches"] + sum(c["k1"] for c in loops) + zoo["k1"]
                        + sum(c["k1"] for c in slice12) + sum(slice13) + slice14["k1"]
                        + slice15["k1"])
        bwd_launches = (tr["backward_launches"] + sum(c["k3"] for c in loops) + zoo["k3"]
                        + sum(c["k3"] for c in slice12) + slice14["k3"] + slice15["k3"])
        if min(report["launches"], eval_launches, dataset_launches, tr["forward_launches"],
               tr["backward_launches"],
               *(c[k] for c in loops + slice12 + [slice14, slice15] for k in ("k1", "k3")),
               zoo["k1"], zoo["k3"], k4["launches"], *k5["launches"].values(), *slice13) < 1:
            raise AssertionError("a kernel of a main path was never launched")
        probe_rows = {r["mode"]: r for r in reversed(k5["rows"])}   # the 32 x 40 shapes
        report["record"] = {"kernels": [{
            "name": "roi_align_ml",
            "route": "cuda",
            "source": "u2seg_torch/csrc/roi_align_ml.cu",
            "replaces": "u2seg_tpu/ops/roi_align_pallas.py:435",
            "launches": fwd_launches,
            "max_abs_err": max(k1[s]["max_abs_err_f32"] for s in (7, 14)),
            "ms": k1[7]["ms"],
            "plain_ms": k1[7]["plain_ms"],
            "bound_ms": k1[7]["bound_ms"],
            "bound_by": k1[7]["bound_by"],
            "library_ms": None,
        }, {
            "name": "roi_align_ml_backward",
            "route": "cuda",
            "source": "u2seg_torch/csrc/roi_align_ml.cu",
            "replaces": "u2seg_tpu/ops/roi_align_pallas.py:1074",
            "launches": bwd_launches,
            "max_abs_err": max(k3[s]["max_abs_err_f32"] for s in (7, 14)),
            "ms": k3[7]["ms"],
            "plain_ms": k3[7]["plain_ms"],
            "bound_ms": k3[7]["bound_ms"],
            "bound_by": k3[7]["bound_by"],
            "library_ms": None,
        }, {
            "name": "roi_align_single",
            "route": "cuda",
            "source": "u2seg_torch/csrc/roi_align_single.cu",
            "replaces": "u2seg_tpu/ops/roi_align_pallas.py:62",
            "launches": k4["launches"],
            "max_abs_err": max(k4[s]["max_abs_err_f32"] for s in (7, 14)),
            "ms": k4[7]["ms"],
            "cold_ms": k4[7]["cold_ms"],
            "plain_ms": k4[7]["plain_ms"],
            "bound_ms": k4[7]["bound_ms"],
            "bound_by": k4[7]["bound_by"],
            "library_ms": None,
        }] + [{
            "name": f"window_sum_{mode}",
            "route": "cuda",
            "source": "u2seg_torch/csrc/window_probe.cu",
            "replaces": f"dev/profile_dma_flat.py:{line}",
            "launches": k5["launches"][mode],
            "max_abs_err": k5["max_abs_err"][mode],
            "ms": probe_rows[mode]["ms"],
            "plain_ms": probe_rows[mode]["plain_ms"],
            "bound_ms": probe_rows[mode]["bound_ms"],
            "bound_by": probe_rows[mode]["bound_by"],
            "library_ms": None,
        } for mode, line in (("3d", 50), ("flat", 70))]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if phases != all_phases:
        log("partial run: no result line")
        return
    log(json.dumps(report["record"]))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
