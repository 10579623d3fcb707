#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpuseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (H100), nvcc
and PyTorch built for CUDA.  It imports nothing of JAX.  Phases:

 1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
 2. builds the hand-written kernels from ``tpuseg_torch/kernels/csrc`` and
    the C++ host library from ``tpuseg_torch/io_native/native.cc``;
 3. holds each kernel against its plain PyTorch version on the card at
    every shape the serving and training paths hand it (UNet3d, features
    16, input 112x112x128), in float32 (TF32 off) and bfloat16 (the convs
    K2 and K3 run tensor-core kernels in both, f32 by 3xTF32), and times
    both: the conv's forward
    at its 10 shapes of the plain net, the
    GroupNorm+ReLU forward at its 18 shapes (the 4 packed ones are the
    same maps viewed as (N, 8V', F)), the conv's dX (the forward kernel on
    the transposed weight) at the 10 conv shapes with the channels
    swapped, its dW at the 10 conv shapes, the GroupNorm+ReLU backward at
    the 18 GroupNorm shapes, and the packed k3 conv (K3) at the packed
    twin's three shapes: one part of 8*16 channels, two parts of 128, and
    the packed_levels=2 shape (one part of 8*32 channels on 32x28x28); K3's
    backward in packed training, a part at a time: dX (K3 on dY with the
    flip-transposed fine weight) and dW (K2's dW kernel on the fine
    depth-to-space views) at the packed UNet3d's (1, 64, 56, 56) grid and
    the packed VNet3d's fully packed (1, 48, 48, 48) and (H, W) (1, 48, 24,
    24) grids, against autograd's plain versions and timed beside cuDNN's
    dense coarse dgrad and wgrad (with the transform's adjoint); the k4
    stride-2 stem's one-product weight gradient (``stem_dw_gemm``) beside
    cuDNN's wgrad at both nets' stems; then K2's f32 times by level
    (forward, dX, dW) and its worst dW error at level 0 beside the gate;
 4. runs the port's UNet at the golden file's sizes in float32 and holds
    it against what the JAX package produced
    (``tests/data/torch_port_golden.npz``): the probabilities of a 32^3
    forward, plain and through the packed twin at packed_levels 1 and 2,
    and the loss and every parameter gradient of one 16^3 train step; and
    the port's VNet3d against ``tests/data/torch_port_vnet_golden.npz``:
    a 32^3 forward's probabilities and one small sliding-window mask
    (uint8 HU codes, two batches, the mask bit-packed on the card);
 5. starts the port's ``SegServer`` through ``tpuseg_torch.serve``'s code
    path on a local port (seeded weights, 5 classes), sends three CT-like
    NIfTI volumes to ``POST /predict`` (served by the packed twin, the
    default), fetches each mask with ``GET /getresult`` and checks its
    shape, its labels, the kernel launch counts of the request and its
    agreement with the plain, unpacked net through the plain versions, the
    C++ host calls each request made (the NIfTI codec and the nearest
    resample; the linear resample of an int16 CT runs scipy, as in the JAX
    package) and its host ms by stage (``tools/profiling.py``
    ``request_stages``), and times the f32 forward four ways (packed twin
    and plain net, each with the kernels and with the plain versions);
 6. trains through ``tpuseg_torch.train``'s code path (``build`` and
    ``run``, as ``python -m tpuseg_torch.train`` does) on 3 training and 1
    validation seeded .npy volume of 128x112x112 with blob labels 0..4:
    2 epochs of 3 steps, f32, UNet3d features 16, 5 classes, dropout 0.2,
    MutilDiceLoss, Adam at 1e-3.  It checks every step's kernel launches,
    the loss, the best/ and latest/ checkpoints, a resumed third epoch (the
    saved step, epoch and Adam moments), one step's loss and parameter
    gradients against the same step through the plain versions (same
    weights, batch and dropout generator); then the mixed-precision path
    (``--train.compute_dtype bfloat16``, the conv on its tensor-core
    kernels) for 1 epoch of 3 steps with counts from 0, checking every
    step's launches; and times the f32 and bf16 train steps, kernels
    against plain.  Then packed training (``--train.packed_stem true``):
    the UNet3d at the same setting, 1 epoch of 3 steps in f32 and in bf16
    (per step K3 3 forward, 4 dX, 4 dW; K2 7 each way; K1 18 and 18; one
    stem GEMM; the eval step as the served forward), one packed f32 step
    against the plain net's through the plain versions (same weights, batch
    and generator: loss within 1e-5 relative, grads through phase 6's
    gate), bench.py's three variants timed interleaved (packed bf16, packed
    f32, plain f32; 10 steps a pass, min and median), the packed steps'
    device ms by kernel (``tools/profiling.py``) and peak memory; and the
    VNet3d at 96^3 (features 16, 2 classes): packed_levels 2 in f32 and
    bf16 (K3 5, K2 6, K1 34 each way, one stem GEMM) and the plain net (K2
    11, K1 34), 1 epoch of 3 steps each, with packed_levels 1 (K3 1, K2 10)
    timed beside them; then the rest of the trained 3D zoo (phase 6b, config
    5 and its neighbours: features 16, 2 classes): K1 at one channel per
    group without ReLU (STUNet3d's InstanceNorms) at C 16 @96^3 ... 256 @6^3,
    forward and backward, f32 and bf16, against its plain version and
    ``F.group_norm``; ResUNet3d and STUNet3d and their twins at features 8,
    32^3, against the JAX package's logits (``tests/data/
    torch_port_zoo_golden.npz``: ResUNet3d 1e-4 of the scale, STUNet3d
    JAX's own bars, logits 6e-2 and argmax >= 0.999); each net's eval
    forward (ResUNet3d, STUNet3d, UNet3dThin at 96^3, KiUNet3d at
    64x96x96; the twins too) in f32 and bf16 with its launches asserted,
    kernels against the plain versions (masks equal outside near-ties,
    probabilities within 1e-3, STUNet3d 1e-2; bf16 >= 0.99 agreement), the
    twins' masks against the plain net's (>= 0.9999 f32, >= 0.99 bf16),
    and timed; ``train.build`` / ``run`` of each net, plain and (ResUNet3d,
    STUNet3d) ``--train.packed_stem true``, f32 and bf16, 1 epoch of 3
    steps with every step's launches asserted (``ZOO_TRAIN_LAUNCHES``); the
    packed f32 step against the plain net's step in float64 through the
    plain versions (loss 1e-5 relative, grads through phase 6's gate; the
    plain net's f32 step, which STUNet3d's leaky ReLUs on 6^3 voxels make
    jump under rounding, printed beside it); and each net's step variants
    timed interleaved;
 7. K2's micro-benchmarks (``tpuseg_torch.benchmarks``) at the probes' full
    shapes (N 8, 96^3, C 16): every variant of the slab conv GEMM (K4
    ``dot_only``/``abuild``/``full``, K5 ``v0``/``v2``/``v3``/``v5``) and
    of the flat channels-last conv (K6, xcat prebuilt and built in the
    kernel) against its plain version on the same inputs, the plain
    version timed; the partial slab variants' one cuDNN conv3d of the same
    function checked and timed too, and cuDNN's bf16 conv of the whole
    conv as the whole-conv variants' yardstick; then, counts from 0,
    ``kmicro``, ``kmicro2``, ``kmicro3`` and ``kbench`` run as a user runs
    them (the bench path: the probes' lines, whose times are the kernels',
    and the 6-conv bf16 chains through K2 against cuDNN, whose one-layer
    difference is checked);
 8. sliding-window inference (``tpuseg_torch.infer.sliding_window``):
    VNet3d (features 16, 2 classes, seeded weights) over bench.py's
    primary, a 160x160x192 integer-HU CT, all 27 patches of 96^3 of the
    50 % grid in one batch: from a host-normalized f32 upload, from uint8
    HU codes normalized on the card with the mask bit-packed (the primary,
    path ``swin_vnet``), in bf16 from a bf16 upload (``swin_vnet_bf16``),
    and at 25 % overlap (12 patches); the packed VNet3d twin (packed_levels
    2, class-major packed probabilities into the packed merge) from the
    uint8 upload in f32 (``swin_vnet_packed``) and with the patches cast to
    bf16 on the bf16 copy (``swin_vnet_packed_bf16``, bench.py's
    ``run_primary``), and at packed_levels 1 in f32; the f32 mask against
    the same call through the plain versions and the uint8 mask against
    the f32 one (each >= 0.999), the packed twin's masks against the plain
    net's in the same dtype (>= 0.9999 f32, >= 0.99 bf16), one forward's
    launches per volume (plain K1 34, K2 11; packed K3 5, K2 6, K1 34, at
    packed_levels 1 K3 1, K2 10), volume wall times (interleaved), the
    forwards' and the merges' device ms, the packed forward's device ms by
    kernel, the upload and fetch, peak memory, busy shares, three volumes
    pipelined; one ``MutilVNet3dModel.inference`` (the packed twin);
    ``MutilUNet3dModel.inference_patch`` (features 16, 5 classes, patch
    128x112x112, batch 8, 8 patches) through the packed twin and the packed
    merge (``swin_unet``: K3 3 a forward), against the plain, unpacked net
    through the plain versions (>= 0.999); and K2 and K1 at the VNet3d's
    shapes at 27 patches, K3 at the packed VNet3d's two grids (fully packed
    and (H, W)) at 27 patches, and K1-K3 at the packed UNet3d's at 8, in
    f32 and bf16, against their plain versions, timed;
 9. the host layer and the evaluator: ``infer/volume.py``
    ``infer_volume_device`` (resize, percentile z-score, the plain UNet3d
    forward, argmax and the nearest resize back, all on the card; features
    16, 5 classes, 112x112x128) on phase 5's three volumes, with K2 10 and
    K1 18 launches a volume (path ``volume_device``), its masks on the
    network's grid, before the resize back, against the host pipeline's
    ``infer_volume`` on the same net (>= 0.99 over all voxels; the two
    routes' nearest resizes back round ties differently, each as in the
    JAX package), its output the nearest resize back of that grid mask,
    and against itself through the plain versions (>= 0.999), the input's
    shape and
    geometry, both pipelines timed interleaved with the device ms, busy
    share, upload and fetch; ``SegMetric3d`` on the first volume's two
    masks, the native KD-tree against scipy's cKDTree (all 9 metrics
    within 1e-9), timed; ``tools.evaluate`` over the served masks against
    the host pipeline's (3 rows and MEAN); ``train.build`` / ``run`` on
    phase 6's data with ``LovaszLoss`` and ``MutilClDiceLoss`` (5 classes)
    and ``BinaryLovaszLoss`` and ``BinaryClDiceLoss`` (1 class, labels
    binarised), 1 epoch of 3 steps each (paths ``train_<loss>``), every
    step's launches asserted, one step against the plain versions (loss
    1e-5 relative; given the plain path's gradient of the loss by the
    logits, the parameter gradients within phase 6's gate, which a bf16
    step, the control, must exceed; each step's distance from the step in
    float64, and the end-to-end gradients, which the losses' sorts and max
    pools make move under rounding, printed), step times;
    ``ssim`` and
    ``ms_ssim`` of two 128x112x112 volumes on the card against the CPU
    (1e-5);
10. augmentation, registration and TPDDNet, in f32: the augmenter's
    affine (``data/augment3d.py`` ``_apply``) on a 128x112x112 volume on the
    card against the same affine on the CPU with the same parameters
    (image within 1e-5 of its scale, masks >= 0.999 and, without rotation,
    equal; labels in the class set), the batch augmenter's ms,
    ``train.build`` / ``run`` at phase 6's setting with
    ``--data.online_augment true`` (path ``train_online_augment``, phase
    6's launches on every step, the augmenter run on the card once per
    training batch), ``DataAug3D`` (2 copies of 2 volumes, files and
    manifest); VNet3dRegistration (features 8) and TPDDNet at 1x32^3
    against the JAX package's outputs (``tests/data/
    torch_port_regtp_golden.npz``, 1e-4 of each output's scale);
    VNet3dRegistration (features 16) on a 1x128^3 ``synthetic_ct`` pair,
    the fixed image the moving one warped by a known smooth field: the
    forward through the kernels against the plain versions (moved image
    and ddf within 1e-4 of their scale; K2 9, K1 29 launches,
    ``fwd_vnet3dregistration``), 3 train steps of
    ``make_registration_trainer`` (``train_vnet3dregistration``, launches
    on every step), one step against the f64 step through the plain
    versions (``_kernel_step_gate``), and the ``trainregistration3d``
    recipe for 8 one-step epochs, whose loss must fall
    (``recipe_trainregistration3d``); TPDDNet (2 classes, 1x1x128^3): the
    eval forward through the kernels against the plain versions (argmax
    >= 0.999; K2 10, K1 18, ``fwd_tpddnet``), 3
    ``make_segmentation_trainer`` steps with MutilDiceLoss and the aux
    heads (``train_tpddnet``), one step against the f64 step; each
    path's step time, device ms by family and the cuDNN conv backward by
    shape, and peak memory;
11. the 2D, classification and GAN Model API (``tpuseg_torch.compat``), in
    f32: the golden file of this slice (``tests/data/
    torch_port_model_api_golden.npz``: UNet2d, VNet2d, ResNet2d / 3d logits
    of JAX in float64 within 1e-4 of their scale, the ResNet2d Grad-CAM,
    one GAN step whose gradients must be no farther from JAX's float64
    step than twice JAX's own f32 step) and the committed tpuseg run
    directory (``tests/data/tpuseg_run_unet2d``) read by MutilUNet2dModel
    and serving an image; K1 at UNet2d's 18 GroupNorm shapes at 8 x 512^2
    and the discriminator's six InstanceNorms (groups = C up to 1024 on 4
    x 4), forward and backward, against the plain versions beside
    ``F.group_norm``; K2 and K1 at ResNet3d's shapes at 2 x 96^3; then
    ``BinaryUNet2dModel`` and ``MutilVNet2dModel`` at 512^2, batch 8
    (``seg_unet2d``, ``seg_vnet2d``), ``MutilResNet2dModel`` at 28^2,
    batch 64, 10 classes (``cls_resnet2d``), ``MutilResNet3dModel`` at 2 x
    96^3 (``cls_resnet3d``) and ``Pixel2PixelGAN2dModel`` at 256^2, batch 4
    (``gan_pix2pix``): ``trainprocess`` for 2 steps and a validation
    batch from PNG files the port writes (or .npy volumes), K1 launched
    each way on every path, K2 only on ResNet3d's, a timed step (min and
    median, device ms by family, busy share, peak memory), one forward's
    launches (K2 0 / K1 18 UNet2d, 0 / 34 VNet2d, 0 / 17 ResNet2d, 5 / 17
    ResNet3d), ``inference`` on a 600 x 480 image, ``predict`` and
    ``Grad_CAM_Visual``;
12. the remaining entry points and the 2D MLP nets, in float32:
    ``tools/dataprep.py`` ``prepare_sampling_3d`` on three synthetic CT
    NIfTI volumes with label masks at KiPA's 112x112x128 (and at
    80x112x176 for the V-Net); the recipes ``trainmutilunet3d`` (one epoch:
    2 train steps and a validation step, ``recipe_unet3d``) and
    ``trainmutilvnet3d`` (176x112x80, 16 classes, ``recipe_vnet3d``; one
    step of its net on its first batch held to the f64 step through the
    plain versions, phase 10's gate), each step's launches checked;
    ``python -m tpuseg_torch.inference`` through its ``main`` on two
    volumes with the UNet3d run (the packed twin: K3 3, K2 7, K1 18 a
    volume, ``folder_unet3d``; masks against the plain net through the
    plain versions), ``inferencemutilvnet3d`` with the V-Net run (K2 11, K1
    34 a volume, ``folder_vnet3d``; masks against the same net through the
    plain versions) and
    ``inferencemutilvnet2d`` on 512^2 PNGs (K1 34 an image,
    ``folder_vnet2d``); ``SegmentationAug2D.run_offline`` on four 512^2 BMP
    pairs on the card against the same augmenter on the CPU (masks equal,
    images within one gray level); ``--train.profile true`` through
    ``train.build`` / ``run`` (the Chrome trace names K1's and K2's
    kernels); UNeXt2d and AmlpUNet2d (``models/unext2d.py``,
    ``models/amlp_unet2d.py``) against the golden file's JAX logits, then
    at 512^2, batch 8: one step's loss and gradients through the kernels
    against the plain versions' f64 step (phase 10's gate), three steps with K1's
    launches checked (7 / 6 each way, ``unext2d`` / ``amlp_unet2d``), a
    timed step;
13. the attention zoo, in float32: SMTSeg3d and VSNet
    (``models/smt.py``, ``models/vsnet.py``) against the golden file's JAX
    outputs; smt_t (15 classes, 128^3: ``smt``, K2 4 / K1 20 a forward),
    one eval forward each of smt_s, smt_b and smt_l at 128^3, and VSNet
    (feature_size 24, 96^3: ``vsnet``, K2 6 / K1 25, three of them over
    one channel) through the kernels against the plain versions
    (probabilities within 1e-4, masks equal outside near-ties); one step
    of each (``make_segmentation_trainer``, ``make_vsnet_trainer`` with
    both optional targets) against the plain versions' f64 step (phase
    10's gate), three steps with each step's launches checked, a timed
    step; K2 (forward, dX, dW) and K1 (forward, backward) at the shapes
    those forwards hand them against their plain versions, timed, and K2
    dW's signed mean error over its rms there;
14. parallelism: 2 processes on the one card (gloo over a file store, each
    naming cuda:0; NCCL refuses two ranks on one device, which the phase
    shows) make one world and three meshes of it.  Space 2: the z-sharded
    UNet3d (features 16, 5 classes, 128x112x112 split 64 + 64) train step
    in f32 and bf16, the packed x spatial UNet3d f32 step, and the VNet3d
    (96^3, 48 + 48) forward and f32 / bf16 steps: per rank the launches
    (K2 on the halo'd shards, K1 split, K3 for the packed twin) checked
    each step, the global loss and gradients against one process's step on
    the card (phase 10's gate against the f64 step through the plain
    versions, the bf16 step as the control), step ms per rank; data 2: a
    batch of 2 with MutilDiceLoss (pooled statistics) and LovaszLoss
    (gathered logits), dropout off, gated the same way; model 2: the
    UNet3d's 256-channel bottleneck kernels sharded, its step gated, a
    sharded checkpoint both ranks write restored in this process bit for
    bit, and ``pipeline_apply`` (2 stages) against
    ``sequential_reference``; ``spatial_partition_infer`` of a conv net
    against its whole forward; K1 split against its plain version on each
    rank's shard, forward and backward, in f32 and bf16, timed (on the
    2-rank line, whose gather gloo stages through the host, and on a line
    of one: the kernels) beside ``F.group_norm``; then NCCL at world 1
    through ``torchrun``'s environment variables (an all_reduce, one
    mesh-path train step).  The collectives' times are gloo's on one card,
    not NCCL's.

Before its last line it prints the stem GEMM's rows (``stem_dw_gemm``,
not a kernel of the package) and one JSON object with each kernel's
launches on the served, training (plain and packed, UNet3d and VNet3d, f32
and bf16; the zoo; online augmentation, registration and TPDDNet; the
Model API's 2D, classification and GAN paths; the recipes and the 2D MLP
nets; the attention nets; the parallel paths, with K1 split's entries),
bench, sliding-window, whole-volume and folder-inference paths (K3's dX and dW rows among them), error, times (one
forward's or train step's worth of calls: in f32, and for the conv's
tensor-core kernels in bf16), the least time the card could take for that work
and the time of the PyTorch library call that computes the same function
(for the conv's forward, dX and dW that call is the plain version itself;
for K3, cuDNN's dense coarse conv of the concatenated parts; for K1,
``F.group_norm`` on the same channels-last map, which lacks the ReLU, and
its autograd backward; for the
probe kernels, cuDNN's bf16 conv at the probe shape, beside their whole-conv
variant), each probe kernel's variants with their own library call,
and the card's ``nvidia-smi`` line; the last line is ``{"ok": true,
"device": {...}}``.  Any failed check, a missing card or a failed build
exits non-zero without that line.
"""
from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NEW_SIZE = (112, 112, 128)  # (x, y, z): the served UNet3d input
FEATURES, CLASSES = 16, 5
REQUEST_SIZES = ((160, 160, 96), (200, 180, 120), (112, 112, 128))  # (x, y, z)
# the kernels' launch counters (K3's dX is K3 on dY, its dW K2's dW kernel
# on the fine views, each counted apart from the forward's and K2's own)
KERNELS = ("conv3d_small", "conv3d_small_dx", "conv3d_small_dw",
           "fused_group_norm_relu", "fused_group_norm_relu_bwd",
           "packed_conv3d_structured", "packed_conv3d_structured_dx",
           "packed_conv3d_structured_dw")
# per request through the packed twin (packed_levels 1): the k3 convs of
# levels 1-2 inside conv3d_small's range, the ConvBlock GroupNorms (4 of
# them packed), and the packed level's three packed -> packed k3 convs;
# stem_dw_gemm counts the packed stem's one-product weight gradients
EXPECTED_LAUNCHES = {"conv3d_small": 7, "conv3d_small_dx": 0, "conv3d_small_dw": 0,
                     "fused_group_norm_relu": 18, "fused_group_norm_relu_bwd": 0,
                     "packed_conv3d_structured": 3, "packed_conv3d_structured_dx": 0,
                     "packed_conv3d_structured_dw": 0, "stem_dw_gemm": 0,
                     "slab_conv": 0, "flat_conv": 0}
# per train step (the plain net): K1 and K2 forward and backward
TRAIN_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES}, conv3d_small=10,
                      conv3d_small_dx=10, conv3d_small_dw=10, fused_group_norm_relu=18,
                      fused_group_norm_relu_bwd=18)
TRAIN_KERNELS = tuple(k for k in KERNELS if TRAIN_LAUNCHES[k])
# per packed UNet3d train step (packed_levels 1): the served forward's
# launches, each backward too; K3's dX and dW once a part (the decoder's
# two-part conv twice), the stem's dW one product
TRAIN_PACKED_LAUNCHES = dict(EXPECTED_LAUNCHES, conv3d_small_dx=7, conv3d_small_dw=7,
                             fused_group_norm_relu_bwd=18, packed_conv3d_structured_dx=4,
                             packed_conv3d_structured_dw=4, stem_dw_gemm=1)
# the VNet3d train step at 96^3: plain (K2 the 11 LUConvs at 16-64
# channels, K1 34) and packed at packed_levels 2 (K3 5, K2 6, K1 34); an
# eval step runs the forward's launches
VNET_TRAIN_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES}, conv3d_small=11,
                           conv3d_small_dx=11, conv3d_small_dw=11, fused_group_norm_relu=34,
                           fused_group_norm_relu_bwd=34)
VNET_TRAIN_PACKED_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES}, conv3d_small=6,
                                  conv3d_small_dx=6, conv3d_small_dw=6,
                                  fused_group_norm_relu=34, fused_group_norm_relu_bwd=34,
                                  packed_conv3d_structured=5, packed_conv3d_structured_dx=5,
                                  packed_conv3d_structured_dw=5, stem_dw_gemm=1)
VNET_TRAIN_DHW, VNET_CLASSES = (96, 96, 96), 2
# tolerance on max |kernel - plain|, relative to max(1, max |plain|):
# float32 sums the same products in another order (1e-4 leaves two decades
# over fp32 rounding of 27*64 terms); bfloat16 rounds the output to 8 bits,
# so the two may differ by one bf16 step (2**-8 ~ 3.9e-3) at the largest value
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# a train step's parameter gradients, each relative to its own max |g|.
# The 16^3 golden step against JAX: f32 sums in other orders.  The
# full-width step, kernels against plain: its deepest gradients are sums
# with heavy cancellation, and the plain path's own move when the image
# changes at rounding level (x * (1 + 1e-7 eps)), which phase 6 prints,
# reaches 1.4e-3 of them on an H100; the gate sits above that and below a
# bf16 step, the control, whose worst parameter lands near 0.4 there.
GOLDEN_GRAD_TOL = 1e-4
STEP_GRAD_TOL = 2e-2
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, bf16 dense on
# the tensor cores, HBM3; "tf32x3" is the rate of fp32-accurate products on
# the tensor cores by the 3xTF32 split (three TF32 passes at 495 TFLOP/s),
# which bounds the f32 routes of K2 and K3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
TRAIN_DHW = (128, 112, 112)  # (z, y, x) of the training volumes
# phase 8, the VNet3d sliding window of bench.py's primary: a 160x160x192
# (d, h, w) integer-HU CT, 96^3 patches, all 27 of the 50 % grid in one
# batch (12 in one batch at 25 %), VNet3d features 16, 2 classes
SWIN_VOL, SWIN_PATCH, SWIN_CLASSES, SWIN_BATCH = (160, 160, 192), (96, 96, 96), 2, 27
SWIN_HU_WINDOW = (100.0, -100.0)  # (upper, lower), "meanstd", as bench.py
# per 27-patch VNet3d forward: K2 takes the 3^3 LUConvs at 16-64 channels
# (down_tr32 2, down_tr64 3, up_tr128 3, up_tr64 2, up_tr32 1; the 128- and
# 256-channel levels and the Cin = 1 stem go to cuDNN), K1 every GroupNorm
# (in_tr 2, the DownTransitions 15, the UpTransitions 17)
SWIN_VNET_LAUNCHES = {k: 0 for k in EXPECTED_LAUNCHES}
SWIN_VNET_LAUNCHES.update(conv3d_small=11, fused_group_norm_relu=34)
# per 27-patch forward of the packed VNet3d twin at packed_levels 2: K3 the
# packed k3 convs (up_tr32's LUConv on the fully packed grid; down_tr32's
# and up_tr64's two each on the (H, W) grid), K2 the 24^3 level's 64-channel
# LUConvs (down_tr64 3, up_tr128 3), K1 every GroupNorm; at packed_levels 1
# K3 up_tr32's LUConv alone and K2 the 48^3 level's four besides
SWIN_VNET_PACKED_LAUNCHES = {k: 0 for k in EXPECTED_LAUNCHES}
SWIN_VNET_PACKED_LAUNCHES.update(packed_conv3d_structured=5, conv3d_small=6,
                                 fused_group_norm_relu=34)
SWIN_VNET_PACKED1_LAUNCHES = dict(SWIN_VNET_PACKED_LAUNCHES, packed_conv3d_structured=1,
                                  conv3d_small=10)
# the zoo phase: config 5 of BASELINE.md (bench_configs.py:358-372) and the
# rest of the trained 3D zoo at full width, features 16, 2 classes, one
# input channel; (d, h, w) of each net's volume
ZOO_FEATURES, ZOO_CLASSES = 16, 2
ZOO_DHW = {"resunet3d": (96, 96, 96), "stunet3d": (96, 96, 96),
           "kiunet3d": (64, 96, 96), "unet3dthin": (96, 96, 96)}
ZOO_TWINS = ("resunet3d", "stunet3d")


def _zoo_step(k2: int, k1: int, k3=(0, 0, 0), stem: int = 0) -> dict:
    """A train step's launches: K2 ``k2`` each way, K1 ``k1`` each way, K3
    forward / dX / dW ``k3``, ``stem`` stem GEMMs."""
    return dict({k: 0 for k in EXPECTED_LAUNCHES}, conv3d_small=k2, conv3d_small_dx=k2,
                conv3d_small_dw=k2, fused_group_norm_relu=k1, fused_group_norm_relu_bwd=k1,
                packed_conv3d_structured=k3[0], packed_conv3d_structured_dx=k3[1],
                packed_conv3d_structured_dw=k3[2], stem_dw_gemm=stem)


# per train step of each zoo net at features 16 (an eval step runs the
# forward's): K2 takes the stride-1 3^3 convs at 8-64 channels in and 2-64
# out, K1 every GroupNorm(8) and InstanceNorm.  ResUNet3d: K2 enc1 conv2,
# enc2 and enc3 2 each, dec1 conv2, dec2 and dec3 2 each; K1 the 18 block
# norms, 4 down and 4 up.  Its twin: K3 the level-0 encoder conv 2 and
# the decoder's two convs (the first of two parts: dX and dW a part), K2
# the 7 at levels 1-2.  STUNet3d: K2 the LUConvINs at 32 and 64 channels
# (2 + 2 down, 3 + 2 up) and the last one at 16; K1 the 2 stem, 4 x 4 down
# and 9 up norms.  Its twin: that last LUConvIN on K3.  KiUNet3d: K2 enc1,
# enc2, dec2, dec3, ki2 and final; K1 its 12 blocks.  UNet3dThin: as the
# UNet3d's encoder, K2 decoder3 conv2 and decoder2 and decoder1 2 each.
ZOO_TRAIN_LAUNCHES = {
    "resunet3d": _zoo_step(10, 26), "resunet3d_packed": _zoo_step(7, 26, (3, 4, 4), 1),
    "stunet3d": _zoo_step(10, 27), "stunet3d_packed": _zoo_step(9, 27, (1, 1, 1), 1),
    "kiunet3d": _zoo_step(6, 12), "unet3dthin": _zoo_step(10, 18)}
# the packed twin's mask against the plain net's in the same dtype: f32
# sums in other orders; bf16 rounds every layer of two different programs
PACKED_AGREE = {"float32": 0.9999, "bfloat16": 0.99}
# K3's grids: fully packed, and the packed VNet's level B (H and W packed)
FULL_AXES, HW_AXES = (True, True, True), (False, True, True)
# the UNet3d inference_patch: the reference KiPA net (features 16, 5
# classes) on patches of its image size (d, h, w) in batches of 8, a CT of
# (x, y, z) size and spacing that the 0.5 mm resample makes 168x168x192,
# two patches a side; one forward of the packed twin
SWIN_UNET_PATCH, SWIN_UNET_BATCH = (128, 112, 112), 8
SWIN_UNET_SIZE, SWIN_UNET_SPACING = (105, 105, 96), (0.8, 0.8, 1.0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_pair(torch, fn_a, fn_b, iters: int = 20):
    """Mean ms per call of fn_a and fn_b with CUDA events, timed in turns
    a, b, b, a after a warmup."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    for fn in (fn_a, fn_b):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    a1, b1, b2, a2 = run(fn_a), run(fn_b), run(fn_b), run(fn_a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def level_shape(level: int):
    x, y, z = NEW_SIZE
    return (z >> level, y >> level, x >> level)


def bound_ms(flops: float, nbytes: float, rate: str):
    """(least ms the card could take, "operations" or "bytes", the peak
    FLOP/s used) for work done at ``PEAK_FLOPS[rate]``."""
    t_ops, t_bytes = flops / PEAK_FLOPS[rate], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            PEAK_FLOPS[rate])


def counts(mods) -> dict:
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    return {"conv3d_small": conv3d.LAUNCHES, "conv3d_small_dx": conv3d.DX_LAUNCHES,
            "conv3d_small_dw": conv3d.DW_LAUNCHES,
            "fused_group_norm_relu": fused_norm.LAUNCHES,
            "fused_group_norm_relu_bwd": fused_norm.BWD_LAUNCHES,
            "packed_conv3d_structured": packed_conv.LAUNCHES,
            "packed_conv3d_structured_dx": packed_conv.DX_LAUNCHES,
            "packed_conv3d_structured_dw": packed_conv.DW_LAUNCHES,
            "stem_dw_gemm": mods["vnet_packed"].STEM_DW_PRODUCTS,
            "slab_conv": mods["slab_conv"].LAUNCHES, "flat_conv": mods["flat_conv"].LAUNCHES}


def reset_counts(mods) -> None:
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    conv3d.LAUNCHES = conv3d.DX_LAUNCHES = conv3d.DW_LAUNCHES = 0
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    packed_conv.LAUNCHES = packed_conv.DX_LAUNCHES = packed_conv.DW_LAUNCHES = 0
    mods["vnet_packed"].STEM_DW_PRODUCTS = 0
    mods["slab_conv"].LAUNCHES = mods["flat_conv"].LAUNCHES = 0


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, max(1, max |ref|)) in float32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, max(1.0, ref.float().abs().max().item())


def grad_errors(got: dict, ref: dict, floor: float = 0.0):
    """(worst max |got - ref| / max |ref| over the parameters, its name, the
    median over the parameters of max |ref|, the worst max |got - ref| /
    max(1, max |ref|)).  With ``floor`` > 0 a parameter's error is taken
    relative to max(max |ref|, floor x the largest max |ref|): a gradient
    that is zero in exact arithmetic (a conv bias feeding an InstanceNorm)
    holds only rounding."""
    worst, mags, worst_abs = (0.0, ""), [], 0.0
    top = floor * max(r.float().abs().max().item() for r in ref.values())
    for name, r in ref.items():
        mag = r.float().abs().max().item()
        err = (got[name].float() - r.float()).abs().max().item()
        worst = max(worst, (err / max(mag, top, 1e-30), name))
        worst_abs = max(worst_abs, err / max(1.0, mag))
        mags.append(mag)
    return worst[0], worst[1], float(np.median(mags)), worst_abs


def conv_cases():
    """(cin, cout, level, uses per forward) of the convs that take
    conv3d_small in UNet3d(features=16): ConvBlocks at levels 0-2."""
    f = FEATURES
    return [
        (f, f, 0, 2),            # enc1 conv2, dec1 conv2
        (2 * f, f, 0, 1),        # dec1 conv1
        (f, 2 * f, 1, 1),        # enc2 conv1
        (2 * f, 2 * f, 1, 2),    # enc2 conv2, dec2 conv2
        (4 * f, 2 * f, 1, 1),    # dec2 conv1
        (2 * f, 4 * f, 2, 1),    # enc3 conv1
        (4 * f, 4 * f, 2, 2),    # enc3 conv2, dec3 conv2
    ]


def norm_cases():
    """(channels, level, uses per forward) of the 18 ConvBlock GroupNorms."""
    f = FEATURES
    return [(f * 2 ** lvl, lvl, 4 if lvl < 4 else 2) for lvl in range(5)]


def packed_cases():
    """(c_fine of each part, out f, packed grid level, uses per served
    forward) of K3 in the packed twin: the finest level's two packed ->
    packed convs and its decoder's two-part conv at packed_levels 1, and
    the packed_levels=2 level-1 conv (not on the default path)."""
    f = FEATURES
    return [((f,), f, 1, 2), ((f, f), f, 1, 1), ((2 * f,), 2 * f, 2, 0)]


def packed_train_cases():
    """(path, c_fine, f, packed grid (N, D', H', W'), axes, uses per train
    step) of K3's backward: each part's dX (K3 on dY) and dW (K2's dW on the
    fine views).  The packed UNet3d (packed_levels 1, 112x112x128): the
    finest level's 16 -> 16 parts, four a step (encoder conv 2, the
    decoder's two-part conv 1, its conv 2); the packed VNet3d at 96^3
    (packed_levels 2): up_tr32's LUConv fully packed, four 32 -> 32 LUConvs
    on the (H, W) grid."""
    f = FEATURES
    d, h, w = level_shape(1)
    return [("unet", f, f, (1, d, h, w), FULL_AXES, 4),
            ("vnet", f, f, (1, 48, 48, 48), FULL_AXES, 1),
            ("vnet", 2 * f, 2 * f, (1, 48, 24, 24), HW_AXES, 4)]


def stem_cases():
    """(path, fine input (N, D, H, W, 1), uses per train step) of the k4
    stride-2 stem whose weight gradient is one product: the packed UNet3d
    and the packed VNet3d."""
    return [("unet", (1,) + TRAIN_DHW + (1,), 1), ("vnet", (1,) + VNET_TRAIN_DHW + (1,), 1)]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of fn with CUDA events, after a warmup."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_row(results, name, dtype_name, what, err, scale, ms, plain_ms,
               uses, bound, library_ms, library_note="", level=None, path=None):
    results[name].append(dict(dtype=dtype_name, uses=uses, max_abs_err=err, scale=scale,
                              ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                              bound_by=bound[1], peak_flops=bound[2],
                              library_ms=library_ms, level=level, path=path))
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms{library_note}"
    say(f"  {name} {dtype_name} {what}: max_abs_err {err:.3g} (scale {scale:.3g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound {bound[0]:.4f} ms "
        f"({bound[1]}, {bound[2] / 1e12:.0f} TFLOP/s)")
    if not err <= TOL[dtype_name] * scale:
        fail(f"{name} {dtype_name} {what}: error {err} > {TOL[dtype_name]} * {scale}")


def _off_the_kink(torch, x, gamma, beta, g, groups: int = 8):
    """g with zeros where the GroupNorm output lies within 1e-3 of the ReLU
    kink, where the kernel's and the plain statistics (equal to fp32
    rounding) may put an element on either side."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.double().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    v = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(n, -1, c) * gamma.double() \
        + beta.double()
    return g * (v.abs() > 1e-3).reshape(g.shape).to(g.dtype)


def phase_kernels(torch, mods):
    """Each kernel against its plain version at the path shapes, timed."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {name: [] for name in KERNELS + ("stem_dw_gemm",)}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
        # K2 runs f32 by 3xTF32 on the tensor cores
        k2_rate = "tf32x3" if dtype_name == "float32" else dtype_name
        for cin, cout, lvl, uses in conv_cases():
            d, h, w = level_shape(lvl)
            vox = d * h * w
            x = torch.randn((1, d, h, w, cin), generator=gen, device="cuda").to(dtype)
            g = torch.randn((1, d, h, w, cout), generator=gen, device="cuda").to(dtype)
            wt = torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda") \
                * (2.0 / (27 * cin)) ** 0.5
            flops = 2.0 * 27 * cin * cout * vox
            io = (cin + cout) * vox * size + 27 * cin * cout * 4
            what = f"{cin}->{cout} @{d}x{h}x{w}"
            # forward
            packed = conv3d.pack_weight(wt, dtype)  # once, as a layer does
            got = conv3d.conv3d_small(x, wt, packed)
            ref = conv3d.conv3d_small_plain(x, wt)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d.conv3d_small(x, wt, packed),
                                     lambda: conv3d.conv3d_small_plain(x, wt))
            _check_row(results, "conv3d_small", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
            # dX: the forward kernel on the transposed weight, channels swapped
            packed_t = conv3d.pack_weight_t(wt, dtype)
            got = conv3d._launch_dx(g, packed_t, cin)
            ref = conv3d.conv3d_small_dx_plain(g, wt)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dx(g, packed_t, cin),
                                     lambda: conv3d.conv3d_small_dx_plain(g, wt))
            _check_row(results, "conv3d_small_dx", dtype_name, f"{cout}->{cin} @{d}x{h}x{w}",
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
            # dW
            got = conv3d._launch_dw(x, g)
            ref = conv3d.conv3d_small_dw_plain(x, g)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dw(x, g),
                                     lambda: conv3d.conv3d_small_dw_plain(x, g))
            _check_row(results, "conv3d_small_dw", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
        for c, lvl, uses in norm_cases():
            d, h, w = level_shape(lvl)
            n_el = d * h * w * c
            x = torch.randn((1, d, h, w, c), generator=gen, device="cuda") * 2 + 0.5
            x = x.to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            g = torch.randn((1, d, h, w, c), generator=gen, device="cuda").to(dtype)
            g = _off_the_kink(torch, x, gamma, beta, g)
            what = f"C{c} @{d}x{h}x{w}"
            got = fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6)
            ref = fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                lambda: fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6))
            # library: F.group_norm (no ReLU) on the same map laid out as it
            # takes it, a contiguous (N, C, D, H, W) copy made before the
            # clock starts, and its backward through autograd
            xl = x.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
            gl, bl = (t.to(dtype).detach().requires_grad_() for t in (gamma, beta))
            library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl.detach(), 8, gl.detach(), bl.detach(), 1e-6))
            yl = torch.nn.functional.group_norm(xl, 8, gl, bl, 1e-6)
            g_lib = g.permute(0, 4, 1, 2, 3).contiguous()
            library_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, gl, bl), g_lib, retain_graph=True))
            del xl, gl, bl, yl, g_lib
            # about 10 flops per element (statistics, normalize, affine, ReLU)
            _check_row(results, "fused_group_norm_relu", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name), library_ms,
                       " (F.group_norm, no ReLU)")
            # backward: dx, dgamma, dbeta from the forward's statistics
            _, stats = fused_norm._launch(x, gamma, beta, 8, 1e-6, True)
            got = fused_norm._launch_backward(x, g, stats, gamma, beta, 8, True)
            ref = fused_norm.fused_group_norm_relu_backward_plain(x, gamma, beta, g, 8, 1e-6)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            err, scale = max(errs, key=lambda e: e[0] / e[1])
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm._launch_backward(x, g, stats, gamma, beta, 8, True),
                lambda: fused_norm.fused_group_norm_relu_backward_plain(
                    x, gamma, beta, g, 8, 1e-6))
            # about 20 flops per element over its two passes
            _check_row(results, "fused_group_norm_relu_bwd", dtype_name,
                       what + " (dx, dgamma, dbeta)", err, scale, ms, plain_ms, uses,
                       bound_ms(20.0 * n_el, 3 * n_el * size, dtype_name), library_bwd_ms,
                       " (F.group_norm's autograd backward, no ReLU)")
        for c_fines, f, lvl, uses in packed_cases():
            d, h, w = level_shape(lvl)
            npos = d * h * w
            parts = [torch.randn((1, d, h, w, 8 * c), generator=gen, device="cuda").to(dtype)
                     for c in c_fines]
            cin = sum(c_fines)
            wf = (torch.randn((3, 3, 3, cin, f), generator=gen, device="cuda")
                  * (2.0 / (27 * cin)) ** 0.5).cpu()
            splits = [sum(c_fines[:i]) for i in range(len(c_fines) + 1)]
            # dense packed kernels on the CPU (exact), as the model makes them
            w3s = [mods["pack_k3_to_k3_coarse"](wf[..., a:b, :]).cuda()
                   for a, b in zip(splits, splits[1:])]
            packed = packed_conv.pack_tc(w3s, dtype)  # once, as the model does
            got = packed_conv.packed_conv3d_structured(parts, w3s, packed=packed)
            ref = packed_conv.packed_conv3d_plain(parts, w3s)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(
                torch, lambda: packed_conv.packed_conv3d_structured(parts, w3s, packed=packed),
                lambda: packed_conv.packed_conv3d_plain(parts, w3s))
            # library: cuDNN's dense coarse conv of the concatenated input
            x_cat = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cat = torch.cat(w3s, dim=3).to(dtype).permute(4, 3, 0, 1, 2)
            library_ms = time_ms(
                torch, lambda: torch.nn.functional.conv3d(x_cat, w_cat, padding=1))
            # the work the function needs: each fine output reads 27 fine taps
            # of cin channels (the kernel's 64 * cin structural rows per
            # output channel are 64/27 of that, the rest products by zero)
            flops = 2.0 * npos * 8 * f * 27 * cin
            io = (8 * cin + 8 * f) * npos * size + 64 * cin * 8 * f * 4
            what = (f"{' + '.join(str(8 * c) for c in c_fines)}->{8 * f} "
                    f"@{d}x{h}x{w} packed")
            _check_row(results, "packed_conv3d_structured", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(flops, io, "tf32x3" if dtype_name == "float32" else dtype_name),
                       library_ms, " (cuDNN's dense coarse conv)")
        # K3's backward in training: dX (K3 on dY with the flip-transposed
        # fine weight) and dW (K2's dW kernel on the depth-to-space views),
        # one part at a time, each against the plain version of the same
        # function; the library call is cuDNN's dense coarse backward (dgrad,
        # and wgrad followed by the transform's adjoint onto the fine weight)
        pc = packed_conv
        for path, c, f, grid, axes, uses in packed_train_cases():
            p = pc.deltas(axes)
            npos = grid[0] * grid[1] * grid[2] * grid[3] * p
            x = torch.randn(grid + (p * c,), generator=gen, device="cuda").to(dtype)
            g = torch.randn(grid + (p * f,), generator=gen, device="cuda").to(dtype)
            wf = torch.randn((3, 3, 3, c, f), generator=gen, device="cuda") \
                * (2.0 / (27 * c)) ** 0.5
            w3 = pc.pack_k3_axes(wf, axes)
            flops = 2.0 * npos * 27 * c * f
            io = (c + f) * npos * size + 27 * c * f * 4
            rate = "tf32x3" if dtype_name == "float32" else dtype_name
            what = f"{p}x{c} -> {p}x{f} @{'x'.join(map(str, grid))} {'full' if all(axes) else 'HW'}"
            packed_t = pc.pack_tc_fine([pc.flip_t(wf)], dtype, axes)  # as the node makes it
            got = pc._launch_dx(g, packed_t, p * c, p)
            w3t = pc.pack_k3_axes(pc.flip_t(wf), axes)
            ref = pc.packed_conv3d_plain([g], [w3t])
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: pc._launch_dx(g, packed_t, p * c, p),
                                     lambda: pc.packed_conv3d_plain([g], [w3t]))
            g_cf, w3_oi = g.permute(0, 4, 1, 2, 3), w3.to(dtype).permute(4, 3, 0, 1, 2)
            x_shape = (grid[0], p * c) + grid[1:]
            library_ms = time_ms(torch, lambda: torch.nn.grad.conv3d_input(
                x_shape, w3_oi, g_cf, padding=1))
            _check_row(results, "packed_conv3d_structured_dx", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses, bound_ms(flops, io, rate),
                       library_ms, " (cuDNN's dense coarse dgrad)", path=path)
            x_fine, g_fine = pc.unpack_axes(x, axes), pc.unpack_axes(g, axes)
            got = pc._launch_dw(x_fine, g_fine)
            ref = mods["conv3d"].conv3d_small_dw_plain(x_fine, g_fine)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(
                torch, lambda: pc._launch_dw(x_fine, g_fine),
                lambda: mods["conv3d"].conv3d_small_dw_plain(x_fine, g_fine))
            w_lib = wf.detach().requires_grad_()
            w3_lib = pc.pack_k3_axes(w_lib, axes)
            x_cf = x.permute(0, 4, 1, 2, 3)

            def library(w_lib=w_lib, w3_lib=w3_lib, x_cf=x_cf, g_cf=g_cf):
                dw3 = torch.nn.grad.conv3d_weight(x_cf, tuple(w3_oi.shape), g_cf, padding=1)
                return torch.autograd.grad(w3_lib, w_lib, dw3.permute(2, 3, 4, 1, 0).float(),
                                           retain_graph=True)[0]

            lib_err = rel_err(library(), ref)[0]
            library_ms = time_ms(torch, library)
            _check_row(results, "packed_conv3d_structured_dw", dtype_name,
                       what + f" (dW on the fine views, library error {lib_err:.3g})",
                       *rel_err(got, ref), ms, plain_ms, uses, bound_ms(flops, io, rate),
                       library_ms, " (cuDNN's dense coarse wgrad + the adjoint)", path=path)
            del x, g, x_fine, g_fine, w3_lib, library
        # the stem's weight gradient as one product against cuDNN's wgrad
        # (the product sums in fp32: its bound is at the fp32 rate)
        vp = mods["vnet_packed"]
        for path, shape, uses in stem_cases():
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, 8 * FEATURES)
            g = torch.randn(out, generator=gen, device="cuda").to(dtype)
            got = vp.stem_dw_gemm(x, g)
            x_cf, g_cf = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            wshape = (8 * FEATURES, shape[-1], 4, 4, 4)

            def cudnn(x_cf=x_cf, g_cf=g_cf, wshape=wshape):
                return torch.nn.grad.conv3d_weight(x_cf, wshape, g_cf, stride=2, padding=1)

            ref = cudnn().permute(2, 3, 4, 1, 0)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: vp.stem_dw_gemm(x, g), cudnn)
            npos = out[1] * out[2] * out[3]
            _check_row(results, "stem_dw_gemm", dtype_name,
                       f"{'x'.join(map(str, shape))} -> {8 * FEATURES} one product",
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(2.0 * npos * 64 * shape[-1] * 8 * FEATURES,
                                (x.numel() + g.numel()) * size + 64 * 8 * FEATURES * 4,
                                "float32"), plain_ms, " (cuDNN's wgrad)", path=path)
            del x, g, x_cf, g_cf, cudnn
    # K2's f32 route by level: one forward's (or step's) calls at each
    # level, and the worst error over the scale (dW's at level 0 among them)
    by_level = {}
    for name in ("conv3d_small", "conv3d_small_dx", "conv3d_small_dw"):
        for r in results[name]:
            if r["dtype"] == "float32":
                cell = by_level.setdefault(r["level"], {}).setdefault(
                    name, {"ms": 0.0, "bound_ms": 0.0, "max_err_over_scale": 0.0})
                cell["ms"] += r["ms"] * r["uses"]
                cell["bound_ms"] += r["bound_ms"] * r["uses"]
                cell["max_err_over_scale"] = max(cell["max_err_over_scale"],
                                                 r["max_abs_err"] / r["scale"])
    say(f"  K2 f32 (3xTF32) by level, ms per forward's or step's calls: "
        f"{json.dumps(by_level)}; gate {TOL['float32']}")
    return results


def phase_golden(torch, mods):
    UNet, seeded_unet_params = mods["UNet"], mods["seeded_unet_params"]
    unet_params_from_jax = mods["unet_params_from_jax"]
    path = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
    if not os.path.isfile(path):
        fail(f"golden file missing: {path}")
    g = np.load(path)
    features, classes, in_ch = int(g["features"]), int(g["num_classes"]), int(g["in_ch"])
    weights = unet_params_from_jax(seeded_unet_params(int(g["seed"]), features, classes, in_ch))
    net = UNet(classes, features, in_channels=in_ch).cuda().eval()
    net.load_state_dict(weights, strict=True)
    with torch.inference_mode():
        _, probs = net(torch.from_numpy(g["x"]).cuda())
    probs = probs.cpu().numpy()
    err = float(np.abs(probs - g["probs"]).max())
    top2 = np.sort(g["probs"], axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < 1e-4
    mask = probs.argmax(-1).astype(np.uint8)
    bad = int(((mask != g["mask"]) & ~near_tie).sum())
    say(f"  golden {g['x'].shape[1:4]} features {features} classes {classes}: "
        f"probs max_abs_err {err:.3g} (tol 1e-4), mask mismatches outside "
        f"near-ties {bad}")
    if not err <= 1e-4 or bad:
        fail("golden mismatch")
    # the packed twin against JAX packed_unet3d_apply, through K3 and K1
    for lv in (1, 2):
        c0 = counts(mods)
        with torch.inference_mode():
            _, probs = mods["packed_unet3d_apply"](
                net, torch.from_numpy(g["x"]).cuda(), packed_levels=lv)
        launches = delta(counts(mods), c0)
        err = float(np.abs(probs.cpu().numpy() - g[f"packed_probs/{lv}"]).max())
        say(f"  golden packed twin, packed_levels {lv}: probs max_abs_err {err:.3g} "
            f"(tol 1e-4); launches {launches}")
        if not err <= 1e-4:
            fail(f"golden packed_levels {lv} mismatch")
        if launches["packed_conv3d_structured"] != 3 * lv:
            fail(f"packed_levels {lv} forward launched K3 "
                 f"{launches['packed_conv3d_structured']} times, not {3 * lv}")

    # the VNet3d golden file: the plain forward and one sliding-window mask
    # (uint8 HU codes, dequant and bit packing on the card, two batches)
    gv = np.load(os.path.join(ROOT, "tests", "data", "torch_port_vnet_golden.npz"))
    vnet = mods["VNet"](int(gv["num_classes"]), int(gv["features"]),
                        in_channels=int(gv["in_ch"])).cuda().eval()
    vnet.load_state_dict(mods["vnet_params_from_jax"](mods["seeded_vnet_params"](
        int(gv["seed"]), int(gv["features"]), int(gv["num_classes"]), int(gv["in_ch"]))),
        strict=True)
    with torch.inference_mode():
        _, probs = vnet(torch.from_numpy(gv["x"]).cuda())
    probs = probs.cpu().numpy()
    err = float(np.abs(probs - gv["probs"]).max())
    top2 = np.sort(gv["probs"], axis=-1)[..., -2:]
    bad = int(((probs.argmax(-1) != gv["mask"]) & ((top2[..., 1] - top2[..., 0]) >= 1e-4)).sum())
    codes, dq = mods["hu_code_volume"](gv["sw_hu"].astype(np.float32), *gv["sw_window"],
                                       "meanstd")
    c0 = counts(mods)
    sw_mask = mods["sliding_window_inference"](
        codes, tuple(int(v) for v in gv["sw_patch"]), lambda x: vnet(x)[1],
        int(gv["num_classes"]), batch_size=int(gv["sw_batch"]), return_mask=True,
        pack_mask=True, dequant=dq)
    launches = delta(counts(mods), c0)
    sw_bad = int(((sw_mask != gv["sw_mask"]) & ~gv["sw_near_tie"]).sum())
    say(f"  golden VNet3d {gv['x'].shape[1:4]} features {int(gv['features'])}: probs "
        f"max_abs_err {err:.3g} (tol 1e-4), mask mismatches outside near-ties {bad}; "
        f"sliding window {gv['sw_hu'].shape} (uint8 codes, 2 batches): mask mismatches "
        f"outside near-ties {sw_bad}; launches {launches}")
    if not err <= 1e-4 or bad or sw_bad:
        fail("VNet3d golden mismatch")
    if not launches["conv3d_small"] or not launches["fused_group_norm_relu"]:
        fail(f"the VNet3d golden sliding window missed a kernel: {launches}")

    # one train step (MutilDiceLoss, dropout 0) against the JAX grads
    net = UNet(classes, features, dropout=0.0, in_channels=in_ch)
    net.load_state_dict(weights, strict=True)
    trainer = mods["make_segmentation_trainer"](
        net, classes, "MutilDiceLoss", alpha=[1.0] * classes, device="cuda")
    c0 = counts(mods)
    m = trainer.train_step({"image": torch.from_numpy(g["train_x"]).cuda(),
                            "label": torch.from_numpy(g["train_label"]).cuda()})
    launches = delta(counts(mods), c0)
    loss_err = abs(m["loss"].item() - float(g["train_loss"]))
    worst, worst_name, median, _ = grad_errors(
        {n: p.grad for n, p in net.named_parameters()},
        {n: torch.from_numpy(g[f"grad/{n}"]).cuda() for n, _ in net.named_parameters()})
    say(f"  golden train step {g['train_x'].shape[1:4]}: loss {m['loss'].item():.6f} "
        f"vs {float(g['train_loss']):.6f} (err {loss_err:.3g}, tol 1e-5); worst grad "
        f"error / its max |g| {worst:.3g} ({worst_name}, tol {GOLDEN_GRAD_TOL}; median "
        f"max |g| {median:.3g}); launches {launches}")
    if not loss_err <= 1e-5 or not worst <= GOLDEN_GRAD_TOL:
        fail("golden train step mismatch")
    if not all(launches[k] > 0 for k in TRAIN_KERNELS):
        fail(f"golden train step missed a kernel: {launches}")


@contextlib.contextmanager
def plain_kernels(mods):
    """Route the models' kernel calls (the plain net's layers and the packed
    twin's) to their plain versions."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    routes = [
        (mods["layers"], "conv3d_small",
         lambda x, w, packed, packed_t: conv3d.conv3d_small_plain(x, w)),
        (mods["layers"], "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain),
        (mods["vnet_packed"], "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain),
        (mods["stunet_packed"], "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain),
        (mods["vnet_packed"], "packed_conv3d_structured",
         lambda parts, w3s, bias=None, relu=False, packed=None, axes=None:
             packed_conv.packed_conv3d_plain(parts, w3s, bias, relu)),
        # the trained K3: autograd through the plain version (cuDNN's dense
        # coarse conv and its backward)
        (mods["vnet_packed"], "packed_conv3d_train",
         lambda parts, w_fines, bias=None, axes=FULL_AXES: packed_conv.packed_conv3d_plain(
             parts, [packed_conv.pack_k3_axes(w, axes) for w in w_fines],
             None if bias is None else bias.repeat(packed_conv.deltas(axes)))),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, fn in routes:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def unpacked(model):
    """Serve ``model`` through the plain net, not the packed twin."""
    model.packed_inference = False
    try:
        yield
    finally:
        del model.packed_inference  # back to the class default


def phase_serve(torch, mods, workdir):
    serve, parse_cli, SegServer = mods["serve"], mods["parse_cli"], mods["SegServer"]
    read_nifti, write_nifti = mods["read_nifti"], mods["write_nifti"]
    synthetic_ct = mods["synthetic_ct"]
    cfg = parse_cli(["--model.num_classes", str(CLASSES), "--infer.new_size",
                     json.dumps(list(NEW_SIZE)), "--model.features", str(FEATURES)])
    model = serve.build_model(cfg, device="cuda")
    model.load_jax_params(mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1))
    t0 = time.perf_counter()
    server = SegServer(model, new_size=cfg.infer.new_size,
                       upload_dir=os.path.join(workdir, "uploads"),
                       result_dir=os.path.join(workdir, "results"))
    say(f"  server warmup {time.perf_counter() - t0:.3f} s")

    # device time of one forward at the served size: the packed twin (as
    # served) and the plain net, each with the kernels and the plain versions
    x = torch.randn((1, NEW_SIZE[2], NEW_SIZE[1], NEW_SIZE[0], 1),
                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")

    def fwd(packed: bool, kernels: bool):
        def run():
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                if not kernels:
                    stack.enter_context(plain_kernels(mods))
                if not packed:
                    stack.enter_context(unpacked(model))
                model._inference_probs(x)
        return run

    packed_k, plain_k = time_pair(torch, fwd(True, True), fwd(False, True), iters=10)
    packed_p, plain_p = time_pair(torch, fwd(True, False), fwd(False, False), iters=10)
    say(f"  UNet3d forward 1x{NEW_SIZE[2]}x{NEW_SIZE[1]}x{NEW_SIZE[0]} f32: packed twin "
        f"kernels {packed_k:.3f} ms, plain versions {packed_p:.3f} ms; plain net "
        f"kernels {plain_k:.3f} ms, plain versions {plain_p:.3f} ms")

    httpd = server.make_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED)
    served = []  # (file name, volume, served mask)
    try:
        reset_counts(mods)
        for i, size in enumerate(REQUEST_SIZES):
            vol = synthetic_ct(size, rng)
            name = f"case{i}.nii.gz"
            src = os.path.join(workdir, name)
            write_nifti(vol, src)
            with open(src, "rb") as f:
                body = f.read()
            c0, n0 = counts(mods), dict(mods["io_native"].CALLS)
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict?filename={name}", data=body,
                method="POST", headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answer = json.load(resp)
            predict_s = time.perf_counter() - t0
            launches = delta(counts(mods), c0)
            native = {k: v for k, v in delta(mods["io_native"].CALLS, n0).items() if v}
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/getresult?file={answer['result']}",
                    timeout=600) as resp:
                payload = resp.read()
            total_s = time.perf_counter() - t0
            out = os.path.join(workdir, "fetched_" + answer["result"])
            with open(out, "wb") as f:
                f.write(payload)
            served.append((name, vol, read_nifti(out)))
            mask = served[-1][2].array
            # the request's stages on the host clock, in the order the
            # server runs them (tools/profiling.py), on the same upload
            stages = mods["request_stages"](model, src, os.path.join(workdir, "staged.nii.gz"),
                                            cfg.infer.new_size)
            with plain_kernels(mods), unpacked(model):
                ref = model.inference(vol, cfg.infer.new_size).array
            agree = float((mask == ref).mean())
            labels = sorted(int(v) for v in np.unique(mask))
            say(f"  request {i} {size[0]}x{size[1]}x{size[2]} ({vol.array.dtype} CT): POST "
                f"/predict {predict_s * 1e3:.1f} ms, with GET /getresult "
                f"{total_s * 1e3:.1f} ms; launches {launches}; labels {labels}; agreement "
                f"with the plain net through the plain versions {agree:.6f}")
            say(f"    C++ host calls of the request {native} (the linear resample of an "
                f"int16 CT runs scipy, as in the JAX package); host ms by stage "
                + json.dumps({k: round(v, 3) for k, v in stages.items()}))
            if mask.shape != vol.array.shape:
                fail(f"mask shape {mask.shape} != volume {vol.array.shape}")
            if mask.min() < 0 or mask.max() > CLASSES - 1:
                fail(f"mask labels {labels} outside 0..{CLASSES - 1}")
            if launches != EXPECTED_LAUNCHES:
                fail(f"launches {launches} != {EXPECTED_LAUNCHES}")
            if not agree >= 0.999:
                fail(f"agreement {agree} < 0.999")
            if native.get("nifti_read_bytes", 0) < 2 or native.get("nifti_write_bytes", 0) < 1 \
                    or native.get("resample_nearest", 0) != 1:
                fail(f"the request did not take the C++ codec and nearest resample: {native}")
        path_launches = counts(mods)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return path_launches, served


def write_training_data(workdir: str, rng) -> tuple:
    """3 training and 1 validation (image, label) .npy pairs of TRAIN_DHW:
    labels 0..4 as a few ellipsoidal blobs per class, images the label plus
    noise; returns the two CSV manifests."""
    d, h, w = TRAIN_DHW
    zz, yy, xx = np.ogrid[:d, :h, :w]
    rows = []
    for i in range(4):
        label = np.zeros(TRAIN_DHW, np.uint8)
        for k in range(1, CLASSES):
            for _ in range(2):
                cz, cy, cx = rng.uniform(0.2, 0.8, 3) * (d, h, w)
                rz, ry, rx = rng.uniform(6, 18, 3)
                label[((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
                      + ((xx - cx) / rx) ** 2 < 1] = k
        image = (label * 0.5 + rng.standard_normal(TRAIN_DHW)).astype(np.float32)
        paths = (os.path.join(workdir, f"img{i}.npy"), os.path.join(workdir, f"lab{i}.npy"))
        np.save(paths[0], image)
        np.save(paths[1], label)
        rows.append(paths)
    manifests = []
    for name, part in (("train.csv", rows[:3]), ("val.csv", rows[3:])):
        path = os.path.join(workdir, name)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Image", "Mask"])
            writer.writerows(part)
        manifests.append(path)
    return tuple(manifests)


def _watch_steps(trainer, mods, record: list) -> None:
    """Record each train/eval step's kernel launches on ``record``."""
    for kind in ("train_step", "eval_step"):
        step = getattr(trainer, kind)

        def watched(batch, step=step, kind=kind):
            c0 = counts(mods)
            out = step(batch)
            record.append((kind, delta(counts(mods), c0)))
            return out

        setattr(trainer, kind, watched)


def phase_train(torch, mods, workdir):
    train, parse_cli = mods["train"], mods["parse_cli"]
    train_csv, val_csv = write_training_data(workdir, np.random.default_rng(SEED))
    model_dir = os.path.join(workdir, "run")
    flags = ["--model.num_classes", str(CLASSES), "--model.features", str(FEATURES),
             "--model.dropout", "0.2", "--data.image_size", json.dumps(list(NEW_SIZE)),
             "--data.train_csv", train_csv, "--data.val_csv", val_csv,
             "--train.loss_name", "MutilDiceLoss", "--train.optimizer", "adam",
             "--train.lr", "1e-3", "--train.model_dir", model_dir]

    # the training path: 2 epochs of 3 steps, counts from 0
    cfg = parse_cli(flags + ["--train.epochs", "2"])
    trainer, train_loader, val_loader = train.build(cfg, device="cuda")
    steps = []
    _watch_steps(trainer, mods, steps)
    reset_counts(mods)
    t0 = time.perf_counter()
    history = train.run(cfg, trainer, train_loader, val_loader)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    path_launches = counts(mods)
    eval_expect = {k: (v if k in ("conv3d_small", "fused_group_norm_relu") else 0)
                   for k, v in TRAIN_LAUNCHES.items()}
    say(f"  2 epochs x 3 steps + validation in {run_s:.2f} s; history {history}")
    for kind, launches in steps:
        expect = TRAIN_LAUNCHES if kind == "train_step" else eval_expect
        if launches != expect:
            fail(f"{kind} launches {launches} != {expect}")
    kinds = [k for k, _ in steps]
    say(f"  launches per train step {TRAIN_LAUNCHES} on all "
        f"{kinds.count('train_step')} train steps; eval steps {eval_expect} on all "
        f"{kinds.count('eval_step')}")
    if kinds.count("train_step") != 6 or kinds.count("eval_step") != 2:
        fail(f"steps {kinds}")
    if not all(np.isfinite(history["train_loss"])) or not all(
            np.isfinite(history["valdation_loss"])):
        fail(f"non-finite loss {history}")
    for name in ("best", "latest"):
        if sorted(os.listdir(os.path.join(model_dir, name))) != ["meta.json", "state.pt"]:
            fail(f"{name}/ checkpoint not written")

    # resume: a 3rd epoch starts at epoch 2 with the saved step and moments
    cfg3 = parse_cli(flags + ["--train.epochs", "3", "--train.resume", "true"])
    resumed, train_loader3, val_loader3 = train.build(cfg3, device="cuda")
    seen = {}
    first_step = resumed.train_step

    def spy(batch):
        if not seen:
            seen["step"] = resumed.step
            seen["moments"] = [(resumed.optimizer.state[p]["exp_avg"].clone(),
                                resumed.optimizer.state[p]["exp_avg_sq"].clone())
                               for p in resumed.model.parameters()]
        return first_step(batch)

    resumed.train_step = spy
    history3 = train.run(cfg3, resumed, train_loader3, val_loader3)
    same = all(torch.equal(trainer.optimizer.state[p]["exp_avg"], m)
               and torch.equal(trainer.optimizer.state[p]["exp_avg_sq"], v)
               for p, (m, v) in zip(trainer.model.parameters(), seen["moments"]))
    with open(os.path.join(model_dir, "latest", "meta.json")) as f:
        meta = json.load(f)
    say(f"  resume: started at step {seen['step']} with the saved Adam moments: {same}; "
        f"ran {len(history3['train_loss'])} epoch(s); latest now epoch {meta['epoch']} "
        f"step {meta['step']}")
    if seen["step"] != 6 or not same or len(history3["train_loss"]) != 1 \
            or meta["epoch"] != 3 or meta["step"] != 9:
        fail("resume did not continue from the saved state")

    # the mixed-precision training path (bf16 compute over f32 master
    # weights, K2 on the tensor cores): 1 epoch of 3 steps, counts from 0
    cfg_bf = parse_cli(flags[:-1] + [os.path.join(workdir, "run_bf16"), "--train.epochs",
                                     "1", "--train.compute_dtype", "bfloat16"])
    trainer_bf, train_loader_bf, val_loader_bf = train.build(cfg_bf, device="cuda")
    steps_bf = []
    _watch_steps(trainer_bf, mods, steps_bf)
    reset_counts(mods)
    history_bf = train.run(cfg_bf, trainer_bf, train_loader_bf, val_loader_bf)
    torch.cuda.synchronize()
    bf16_launches = counts(mods)
    for kind, launches in steps_bf:
        expect = TRAIN_LAUNCHES if kind == "train_step" else eval_expect
        if launches != expect:
            fail(f"bf16 {kind} launches {launches} != {expect}")
    kinds = [k for k, _ in steps_bf]
    say(f"  bf16 training: 1 epoch x 3 steps + validation, history {history_bf}; "
        f"launches per step as in f32 on all {kinds.count('train_step')} train steps "
        f"and {kinds.count('eval_step')} eval step")
    if kinds.count("train_step") != 3 or kinds.count("eval_step") != 1 \
            or not all(np.isfinite(history_bf["train_loss"])):
        fail(f"bf16 training steps {kinds}, history {history_bf}")

    # one step's loss and gradients, kernels against plain (same weights,
    # batch and dropout generator)
    batch = resumed._put(next(iter(train_loader3)))
    net = mods["UNet"](CLASSES, FEATURES, 0.2).cuda()
    net.load_state_dict(mods["unet_params_from_jax"](
        mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1)), strict=True)
    net.train()
    loss_fn = mods["build_loss"]("MutilDiceLoss", CLASSES, alpha=[1.0] * CLASSES)
    loss_and_grads = _step_grads(torch, mods, net, loss_fn, batch)
    image = batch["image"]
    eps = torch.randn(image.shape, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(SEED))
    loss_k, grads_k = loss_and_grads(image)
    with plain_kernels(mods):
        loss_p, grads_p = loss_and_grads(image)
        floor = grad_errors(loss_and_grads(image * (1 + 1e-7 * eps))[1], grads_p)
    worst, worst_name, median, worst_abs = grad_errors(grads_k, grads_p)
    control = grad_errors(loss_and_grads(image, torch.bfloat16)[1], grads_p)
    say(f"  step kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (tol 1e-4); "
        f"worst grad error / its max |g| {worst:.3g} ({worst_name}, tol "
        f"{STEP_GRAD_TOL}); / max(1, max |g|) {worst_abs:.3g} (tol 1e-3); median "
        f"max |g| {median:.3g}; plain vs plain on the image at rounding level "
        f"{floor[0]:.3g} ({floor[1]}); bf16 kernels control {control[0]:.3g} "
        f"({control[1]})")
    if not abs(loss_k - loss_p) <= 1e-4 or not worst <= STEP_GRAD_TOL \
            or not worst_abs <= 1e-3:
        fail("train step kernels vs plain mismatch")
    if not control[0] > STEP_GRAD_TOL:
        fail("the gradient tolerance does not tell a bf16 step from an f32 one")

    # step time, f32 and bf16, kernels against plain
    for dtype_name, owner in (("float32", resumed), ("bfloat16", trainer_bf)):
        m = owner.train_step(batch)
        if not np.isfinite(m["loss"].item()):
            fail(f"{dtype_name} train step loss {m['loss'].item()}")

        def plain_step(owner=owner):
            with plain_kernels(mods):
                owner.train_step(batch)

        ms, plain_ms = time_pair(torch, lambda owner=owner: owner.train_step(batch),
                                 plain_step, iters=5)
        say(f"  train step {dtype_name} 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]}: "
            f"kernels {ms:.3f} ms, plain {plain_ms:.3f} ms (loss {m['loss'].item():.5f})")
    ctx = dict(flags=flags, net=net, batch=batch, loss_fn=loss_fn, loss_p=loss_p,
               grads_p=grads_p, plain_trainer=resumed)
    return {"train": path_launches, "train_bf16": bf16_launches}, ctx


def _step_grads(torch, mods, net, loss_fn, batch):
    """fn(image, dtype=float32, dlogits=None) -> (loss, {name: grad}) of one
    train step of ``net`` on ``batch``'s labels, with the dropout generator
    of step 0; given ``dlogits``, the gradients backpropagate that gradient
    of the loss by the logits instead of the loss's own."""
    def loss_and_grads(image, dtype=torch.float32, dlogits=None):
        net.zero_grad(set_to_none=True)
        logits, _ = net(image.to(dtype), mods["step_generator"](SEED, 0, "cuda"))
        loss = loss_fn(logits.float(), batch["label"])
        if dlogits is None:
            loss.backward()
        else:
            logits.float().backward(dlogits)
        return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}
    return loss_and_grads


def write_vnet_training_data(workdir: str, rng, dhw=VNET_TRAIN_DHW,
                             prefix: str = "v") -> tuple:
    """3 training and 1 validation (image, label) .npy pairs of ``dhw``
    (VNET_TRAIN_DHW): a few ellipsoidal blobs of label 1, images the label
    plus noise; returns the two CSV manifests."""
    d, h, w = dhw
    zz, yy, xx = np.ogrid[:d, :h, :w]
    rows = []
    for i in range(4):
        label = np.zeros(dhw, np.uint8)
        for _ in range(3):
            cz, cy, cx = rng.uniform(0.2, 0.8, 3) * (d, h, w)
            rz, ry, rx = rng.uniform(6, 18, 3)
            label[((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
                  + ((xx - cx) / rx) ** 2 < 1] = 1
        image = (label * 0.5 + rng.standard_normal(dhw)).astype(np.float32)
        paths = (os.path.join(workdir, f"{prefix}img{i}.npy"),
                 os.path.join(workdir, f"{prefix}lab{i}.npy"))
        np.save(paths[0], image)
        np.save(paths[1], label)
        rows.append(paths)
    manifests = []
    for name, part in ((f"{prefix}train.csv", rows[:3]), (f"{prefix}val.csv", rows[3:])):
        path = os.path.join(workdir, name)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Image", "Mask"])
            writer.writerows(part)
        manifests.append(path)
    return tuple(manifests)


# device kernels by family, by a name fragment (the first that matches)
FAMILIES = (("K3", ("packed_conv_tc",)), ("K2", ("conv3d_",)), ("K1", ("gn_",)),
            ("cuDNN", ("cudnn", "convolve", "implicit_gemm", "fprop", "dgrad", "wgrad")),
            ("cuBLAS", ("gemm", "nvjet", "cutlass", "splitK")),
            ("gather and scatter", ("index", "gather", "scatter")),
            ("elementwise and reductions", ("elementwise", "reduce", "softmax", "cat")))


def kernel_families(split: dict) -> dict:
    """{kernel name: device ms} -> {family: device ms}, "other" for the rest."""
    out = {}
    for name, ms in split.items():
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        out[fam] = round(out.get(fam, 0.0) + ms, 4)
    return out


def _forward_only(launches: dict) -> dict:
    """A train step's expected launches -> its eval step's (the forward's)."""
    return {k: (v if k in ("conv3d_small", "fused_group_norm_relu",
                           "packed_conv3d_structured") else 0) for k, v in launches.items()}


def _run_training(torch, mods, cfg, expect: dict, tag: str):
    """``train.build`` and ``train.run`` of ``cfg`` (one epoch of 3 steps
    and a validation step) with counts from 0: every step's launches
    checked, finite losses, both checkpoints written.  Returns (trainer,
    the path's launches)."""
    train = mods["train"]
    trainer, train_loader, val_loader = train.build(cfg, device="cuda")
    steps = []
    _watch_steps(trainer, mods, steps)
    reset_counts(mods)
    t0 = time.perf_counter()
    history = train.run(cfg, trainer, train_loader, val_loader)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts(mods)
    for kind, got in steps:
        want = expect if kind == "train_step" else _forward_only(expect)
        if got != want:
            fail(f"{tag} {kind} launches {got} != {want}")
    kinds = [k for k, _ in steps]
    if kinds.count("train_step") != 3 or kinds.count("eval_step") != 1:
        fail(f"{tag} steps {kinds}")
    if not all(np.isfinite(history["train_loss"] + history["valdation_loss"])):
        fail(f"{tag} non-finite loss {history}")
    for name in ("best", "latest"):
        if sorted(os.listdir(os.path.join(cfg.train.model_dir, name))) != ["meta.json",
                                                                         "state.pt"]:
            fail(f"{tag}: {name}/ checkpoint not written")
    del trainer.train_step, trainer.eval_step  # the class's steps again
    say(f"  {tag}: 1 epoch x 3 steps + validation in {run_s:.2f} s, history {history}; "
        f"launches per train step {expect}, per eval step as its forward's, on every step")
    return trainer, launches


def _train_passes(torch, trainers: dict, batch, steps: int = 10, reps: int = 3):
    """ms per train step of each trainer, ``steps`` steps a pass, passes
    round-robin over the trainers (bench.py's ``interleaved_times``): ({name:
    min}, {name: median})."""
    fns = {name: (lambda tr=tr: [tr.train_step(batch) for _ in range(steps)])
           for name, tr in trainers.items()}
    for fn in fns.values():
        fn()
    mins, meds = interleaved(torch, fns, reps)
    return ({k: v * 1e3 / steps for k, v in mins.items()},
            {k: v * 1e3 / steps for k, v in meds.items()})


def phase_train_packed(torch, mods, workdir, ctx):
    """Packed training (``--train.packed_stem true``): the UNet3d at the
    reference KiPA setting in f32 and bf16, its f32 step against the plain
    net's (same weights, batch and dropout generator), the three step
    variants timed as bench.py times them, the packed step's device ms by
    kernel; then VNet3d at 96^3 (packed_levels 2 in f32 and bf16, the plain
    net, packed_levels 1 timed beside them).  Returns each path's
    launches."""
    parse_cli, vp = mods["parse_cli"], mods["vnet_packed"]
    flags, paths, trainers = ctx["flags"], {}, {}
    for tag, extra in (("train_packed", []),
                       ("train_packed_bf16", ["--train.compute_dtype", "bfloat16"])):
        cfg = parse_cli(flags[:-1] + [os.path.join(workdir, tag), "--train.epochs", "1",
                                      "--train.packed_stem", "true"] + extra)
        trainers[tag], paths[tag] = _run_training(torch, mods, cfg, TRAIN_PACKED_LAUNCHES,
                                                  tag)

    # one packed f32 step against the plain net's through the plain versions
    net, batch, loss_fn = ctx["net"], ctx["batch"], ctx["loss_fn"]
    net.zero_grad(set_to_none=True)
    logits, _ = mods["packed_unet3d_apply"](net, batch["image"],
                                            generator=mods["step_generator"](SEED, 0, "cuda"))
    loss = loss_fn(logits.float(), batch["label"])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    loss_k, loss_p = loss.item(), ctx["loss_p"]
    worst, worst_name, median, worst_abs = grad_errors(grads, ctx["grads_p"])
    say(f"  packed f32 step vs the plain net's (plain versions): loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (relative {abs(loss_k - loss_p) / abs(loss_p):.3g}, tol 1e-5); worst "
        f"grad error / its max |g| {worst:.3g} ({worst_name}, tol {STEP_GRAD_TOL}); / "
        f"max(1, max |g|) {worst_abs:.3g} (tol 1e-3); median max |g| {median:.3g}")
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) or not worst <= STEP_GRAD_TOL \
            or not worst_abs <= 1e-3:
        fail("packed train step vs the plain step mismatch")

    # bench.py's three variants, interleaved; the packed step's device ms
    mins, meds = _train_passes(torch, {"packed_bf16": trainers["train_packed_bf16"],
                                       "packed": trainers["train_packed"],
                                       "plain": ctx["plain_trainer"]}, batch)
    say(f"  UNet3d train step 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]} ms, 10 steps a "
        f"pass, 3 interleaved passes: min {json.dumps(mins)}, median {json.dumps(meds)}")
    for name, dtype in (("packed f32", torch.float32), ("packed bf16", torch.bfloat16)):
        split, _ = mods["train_step_kernel_split"](steps=2, dtype=dtype, packed_stem=True)
        top = dict(list(split.items())[:10])
        say(f"  {name} step device {sum(split.values()):.3f} ms by family "
            f"{json.dumps(kernel_families(split))}; by kernel (top 10): "
            f"{json.dumps({k[:60]: round(v, 4) for k, v in top.items()})}")
    torch.cuda.reset_peak_memory_stats()
    for name in ("train_packed", "train_packed_bf16"):
        trainers[name].train_step(batch)
    torch.cuda.synchronize()
    say(f"  peak memory of a packed f32 and a bf16 step: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del trainers

    # VNet3d at 96^3: packed_levels 2 in f32 and bf16, the plain net
    vtrain, vval = write_vnet_training_data(workdir, np.random.default_rng(SEED + 1))
    vflags = ["--model.name", "vnet3d", "--model.num_classes", str(VNET_CLASSES),
              "--model.features", str(FEATURES), "--model.dropout", "0.2",
              "--data.image_size", json.dumps(list(VNET_TRAIN_DHW)),
              "--data.train_csv", vtrain, "--data.val_csv", vval,
              "--train.loss_name", "MutilDiceLoss", "--train.optimizer", "adam",
              "--train.lr", "1e-3", "--train.epochs", "1"]
    vtrainers = {}
    for tag, extra, expect in (
            ("train_vnet_packed", ["--train.packed_stem", "true"], VNET_TRAIN_PACKED_LAUNCHES),
            ("train_vnet_packed_bf16", ["--train.packed_stem", "true",
                                        "--train.compute_dtype", "bfloat16"],
             VNET_TRAIN_PACKED_LAUNCHES),
            ("train_vnet", [], VNET_TRAIN_LAUNCHES)):
        cfg = parse_cli(vflags + ["--train.model_dir", os.path.join(workdir, tag)] + extra)
        vtrainers[tag], paths[tag] = _run_training(torch, mods, cfg, expect, tag)
    # packed_levels 1 beside them: the packed f32 trainer's model, another apply
    lv1, _, _ = mods["train"].build(parse_cli(
        vflags + ["--train.model_dir", os.path.join(workdir, "lv1"), "--train.packed_stem",
                  "true"]), device="cuda")

    def apply_lv1(model, image, train, generator):
        logits, probs = vp.packed_vnet3d_apply(model, image, packed_levels=1,
                                               generator=generator if train else None)
        return {"logits": logits, "probs": probs}

    lv1.apply_fn = apply_lv1
    vbatch = lv1._put(next(iter(mods["train"].DataLoader(mods["train"].SegDataset3D(
        *mods["train"].read_manifest_csv(vtrain), VNET_TRAIN_DHW, False), 1,
        shuffle=False))))
    c0 = counts(mods)
    lv1.train_step(vbatch)
    torch.cuda.synchronize()
    got = delta(counts(mods), c0)
    want = dict(VNET_TRAIN_PACKED_LAUNCHES, packed_conv3d_structured=1,
                packed_conv3d_structured_dx=1, packed_conv3d_structured_dw=1,
                conv3d_small=10, conv3d_small_dx=10, conv3d_small_dw=10)
    if got != want:
        fail(f"VNet3d packed_levels 1 train step launches {got} != {want}")
    mins, meds = _train_passes(torch, {"packed": vtrainers["train_vnet_packed"],
                                       "packed_bf16": vtrainers["train_vnet_packed_bf16"],
                                       "plain": vtrainers["train_vnet"], "packed_lv1": lv1},
                               vbatch)
    say(f"  VNet3d train step 1x{VNET_TRAIN_DHW[0]}^3 ms, 10 steps a pass, 3 interleaved "
        f"passes: min {json.dumps(mins)}, median {json.dumps(meds)}")
    return paths


def _zoo_net(torch, mods, name: str, features: int = ZOO_FEATURES, dropout: float = 0.2):
    """The port's ``name`` with ``seeded_*_params``' weights, on the card."""
    seeded, conv = mods["zoo_weights"][name]
    net = mods["build_model"](name, ZOO_CLASSES, features=features, dropout=dropout)
    net.load_state_dict(conv(seeded(SEED, features, ZOO_CLASSES, 1)), strict=True)
    return net.cuda()


def _zoo_instance_norm_rows(torch, mods):
    """K1 at one channel per group without ReLU, STUNet3d's InstanceNorms,
    at the net's five levels on 96^3 (C 16 at 96^3 ... 256 at 6^3; uses per
    forward), forward and backward in f32 and bf16 against its plain
    version, timed beside ``F.group_norm`` at C groups on a contiguous (N,
    C, D, H, W) copy and its autograd backward."""
    fused_norm = mods["fused_norm"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {"fused_group_norm_relu": [], "fused_group_norm_relu_bwd": []}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
        for c, side, uses in ((16, 96, 3), (32, 48, 6), (64, 24, 7), (128, 12, 7),
                              (256, 6, 4)):
            n_el = side ** 3 * c
            x = (torch.randn((1, side, side, side, c), generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            what = f"C{c} groups {c} no ReLU @{side}^3"

            def fwd():
                return fused_norm.fused_group_norm_relu(x, gamma, beta, c, 1e-6, False)

            def fwd_plain():
                return fused_norm.fused_group_norm_relu_plain(x, gamma, beta, c, 1e-6, False)

            got, ref = fwd(), fwd_plain()
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, fwd, fwd_plain)
            xl = x.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
            gl, bl = (t.to(dtype).detach().requires_grad_() for t in (gamma, beta))
            library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl.detach(), c, gl.detach(), bl.detach(), 1e-6))
            yl = torch.nn.functional.group_norm(xl, c, gl, bl, 1e-6)
            g_lib = g.permute(0, 4, 1, 2, 3).contiguous()
            library_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, gl, bl), g_lib, retain_graph=True))
            del xl, gl, bl, yl, g_lib
            _check_row(rows, "fused_group_norm_relu", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name),
                       library_ms, " (F.group_norm)")
            _, stats = fused_norm._launch(x, gamma, beta, c, 1e-6, False)

            def bwd():
                return fused_norm._launch_backward(x, g, stats, gamma, beta, c, False)

            def bwd_plain():
                return fused_norm.fused_group_norm_relu_backward_plain(
                    x, gamma, beta, g, c, 1e-6, False)

            got, ref = bwd(), bwd_plain()
            torch.cuda.synchronize()
            err, scale = max((rel_err(a, b) for a, b in zip(got, ref)),
                             key=lambda e: e[0] / e[1])
            ms, plain_ms = time_pair(torch, bwd, bwd_plain)
            _check_row(rows, "fused_group_norm_relu_bwd", dtype_name,
                       what + " (dx, dgamma, dbeta)", err, scale, ms, plain_ms, uses,
                       bound_ms(20.0 * n_el, 3 * n_el * size, dtype_name), library_bwd_ms,
                       " (F.group_norm's autograd backward)")
    return rows


def _masks_agree(torch, probs, ref, tol: float):
    """(share of equal argmax masks, voxels that differ where the reference's
    top two probabilities lie at least 2 * tol apart, max |probs - ref|)."""
    top2 = torch.topk(ref.float(), 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= 2 * tol
    a, b = probs.argmax(-1), ref.argmax(-1)
    return (float((a == b).float().mean()), int(((a != b) & clear).sum()),
            float((probs.float() - ref.float()).abs().max()))


def _zoo_golden(torch, mods):
    """ResUNet3d and STUNet3d (features 8, 1x32^3, seeded weights) and their
    twins on the card against the JAX package's logits, written on the CPU
    (``tests/data/torch_port_zoo_golden.npz``): ResUNet3d within 1e-4 of
    max(1, max |logits|) (its aux heads at the fingerprint's sampled
    entries), STUNet3d at JAX's own bars for its f32 twin (logits 6e-2,
    argmax agreement >= 0.999)."""
    gen_mod = mods["zoo_golden"]
    g = np.load(gen_mod.GOLDEN)
    for net, twin in (("resunet3d", mods["packed_resunet3d_apply"]),
                      ("stunet3d", mods["packed_stunet3d_apply"])):
        case = f"{net[:-2]}_fwd"
        (x,) = gen_mod.inputs(case)
        model = _zoo_net(torch, mods, net, features=gen_mod.FEATURES).eval()
        ref = g[f"{case}/logits"]
        for kind, fn in (("plain", model), ("twin", lambda t: twin(model, t))):
            c0 = counts(mods)
            with torch.inference_mode():
                out = fn(torch.from_numpy(x).cuda())
            launches = delta(counts(mods), c0)
            logits = out[0].float().cpu().numpy()
            err = float(np.abs(logits - ref).max())
            agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
            aux_err = 0.0
            for i, a in enumerate(out[2] if len(out) == 3 else ()):
                fp, fr = gen_mod.fingerprint(a.float().cpu().numpy()), g[f"{case}/aux{i}"]
                aux_err = max(aux_err, float(np.abs(fp - fr)[2:-2].max() / max(1.0, fr[0])))
            scale = max(1.0, float(np.abs(ref).max()))
            say(f"  golden {net} {kind} {x.shape[1:4]} features {gen_mod.FEATURES}: logits "
                f"max_abs_err {err:.3g} (scale {scale:.3g}), aux {aux_err:.3g}, argmax "
                f"agreement {agree:.6f}; launches {launches}")
            ok = (err <= 1e-4 * scale and aux_err <= 1e-4 if net == "resunet3d"
                  else err <= 6e-2 and agree >= 0.999)
            if not ok:
                fail(f"{net} {kind} golden mismatch")
            if not launches["conv3d_small"] or not launches["fused_group_norm_relu"] or (
                    kind == "twin" and not launches["packed_conv3d_structured"]):
                fail(f"{net} {kind} golden forward missed a kernel: {launches}")


def phase_zoo(torch, mods, workdir):
    """The rest of the trained 3D zoo (config 5 and its neighbours):
    K1 at one channel per group; the golden file; each net's forward (and
    the twins') at config 5's shapes, kernels against plain, launches and
    times; ``train.build`` / ``run`` of each net, plain and (ResUNet3d,
    STUNet3d) ``--train.packed_stem true``, in f32 and bf16, 1 epoch of 3
    steps with every step's launches checked; the packed f32 step against
    the plain net's f64 step through the plain versions; step times
    interleaved.
    Returns ({path: launches}, K1 rows)."""
    t_phase = time.perf_counter()
    in_rows = _zoo_instance_norm_rows(torch, mods)
    _zoo_golden(torch, mods)
    paths, twins = {}, {"resunet3d": mods["packed_resunet3d_apply"],
                        "stunet3d": mods["packed_stunet3d_apply"]}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    fwd_ms = {}
    for net, dhw in ZOO_DHW.items():
        model = _zoo_net(torch, mods, net).eval()
        x = torch.randn((1,) + dhw + (1,), generator=gen, device="cuda")
        want = _forward_only(ZOO_TRAIN_LAUNCHES[net])
        for dtype_name in ("float32", "bfloat16"):
            xd = x.to(getattr(torch, dtype_name))
            tag = "" if dtype_name == "float32" else "_bf16"
            reset_counts(mods)
            with torch.inference_mode():
                probs = model(xd)[1]
            launches = counts(mods)
            if launches != want:
                fail(f"{net} {dtype_name} forward launches {launches} != {want}")
            paths[f"fwd_{net}{tag}"] = launches
            with torch.inference_mode(), plain_kernels(mods):
                ref = model(xd)[1]
            # phase 8's f32 gate on probabilities; STUNet3d at JAX's own bar
            tol = (1e-2 if net == "stunet3d" else 1e-3) if tag == "" else 1e-2
            agree, bad, err = _masks_agree(torch, probs, ref, tol)
            mask = probs.argmax(-1).to(torch.uint8)
            say(f"  {net} {dtype_name} forward 1x{dhw[0]}x{dhw[1]}x{dhw[2]}: launches "
                f"{ {k: v for k, v in launches.items() if v} }; kernels vs plain: probs "
                f"max_abs_err {err:.3g}, mask agreement {agree:.6f}, mismatches outside "
                f"near-ties {bad}; labels {torch.unique(mask).tolist()}")
            gate = 0.999 if tag == "" else 0.99
            if not agree >= gate or (tag == "" and (bad or err > tol)):
                fail(f"{net} {dtype_name} forward kernels vs plain")
            with torch.inference_mode():
                fwd_ms[f"{net}{tag}"] = time_ms(torch, lambda: model(xd)[1].argmax(-1).to(
                    torch.uint8), iters=5)
                with plain_kernels(mods):
                    fwd_ms[f"{net}{tag}_plain_versions"] = time_ms(
                        torch, lambda: model(xd)[1].argmax(-1), iters=3)
            if net in twins:
                twin = twins[net]
                reset_counts(mods)
                with torch.inference_mode():
                    tprobs = twin(model, xd)[1]
                launches = counts(mods)
                tw = _forward_only(ZOO_TRAIN_LAUNCHES[f"{net}_packed"])
                if launches != tw:
                    fail(f"{net} twin {dtype_name} forward launches {launches} != {tw}")
                paths[f"fwd_{net}_packed{tag}"] = launches
                agree = float((tprobs.argmax(-1) == probs.argmax(-1)).float().mean())
                say(f"  {net} twin {dtype_name}: launches "
                    f"{ {k: v for k, v in launches.items() if v} }; mask agreement with the "
                    f"plain net {agree:.6f} (gate {PACKED_AGREE[dtype_name]})")
                if not agree >= PACKED_AGREE[dtype_name]:
                    fail(f"{net} twin {dtype_name} against the plain net: {agree}")
                with torch.inference_mode():
                    fwd_ms[f"{net}_packed{tag}"] = time_ms(
                        torch, lambda: twin(model, xd)[1].argmax(-1).to(torch.uint8), iters=5)
        del model
    say(f"  config 5 forwards (eval, argmax to uint8), ms by CUDA events, "
        f"{mods['smi']}: {json.dumps({k: round(v, 3) for k, v in fwd_ms.items()})}")

    # training through train.build / run: 1 epoch of 3 steps each
    parse_cli = mods["parse_cli"]
    data = {dhw: write_vnet_training_data(workdir, np.random.default_rng(SEED + 7 + i), dhw,
                                          f"z{i}")
            for i, dhw in enumerate(sorted(set(ZOO_DHW.values())))}
    trainers = {}
    for net, dhw in ZOO_DHW.items():
        train_csv, val_csv = data[dhw]
        flags = ["--model.name", net, "--model.num_classes", str(ZOO_CLASSES),
                 "--model.features", str(ZOO_FEATURES), "--model.dropout", "0.2",
                 "--data.image_size", json.dumps(list(dhw[::-1])),
                 "--data.train_csv", train_csv, "--data.val_csv", val_csv,
                 "--train.loss_name", "MutilDiceLoss", "--train.optimizer", "adam",
                 "--train.lr", "1e-3", "--train.epochs", "1"]
        for packed in ((False, True) if net in twins else (False,)):
            for bf16 in (False, True):
                tag = f"train_{net}{'_packed' if packed else ''}{'_bf16' if bf16 else ''}"
                extra = (["--train.packed_stem", "true"] if packed else []) + (
                    ["--train.compute_dtype", "bfloat16"] if bf16 else [])
                cfg = parse_cli(flags + ["--train.model_dir", os.path.join(workdir, tag)]
                                + extra)
                trainers[tag], paths[tag] = _run_training(
                    torch, mods, cfg, ZOO_TRAIN_LAUNCHES[net + ("_packed" if packed else "")],
                    tag)

    step_ms = {}
    for net, dhw in ZOO_DHW.items():
        first = trainers[f"train_{net}"]
        train_csv, _ = data[dhw]
        batch = first._put(next(iter(mods["train"].DataLoader(mods["train"].SegDataset3D(
            *mods["train"].read_manifest_csv(train_csv), dhw, False), 1, shuffle=False))))
        if net in twins:
            # one packed f32 step against the plain net's step in float64
            # through the plain versions (same weights, batch and dropout
            # generator), at phase 6's gate.  The plain net's f32 step is
            # printed beside it, not gated: STUNet3d's leaky ReLUs after
            # InstanceNorms over 6^3 voxels make its f32 gradients jump
            # when one voxel crosses the kink, so one f32 step is no
            # reference (the line prints its own distance from the f64 one)
            model = _zoo_net(torch, mods, net).train()

            def loss_grads(packed, image=batch["image"], dtype=torch.float32):
                tr = mods["make_segmentation_trainer"](
                    model, ZOO_CLASSES, "MutilDiceLoss", alpha=[1.0] * ZOO_CLASSES,
                    device="cuda", packed_stem=packed)
                model.to(dtype).zero_grad(set_to_none=True)
                out = tr.apply_fn(model, image.to(dtype), True,
                                  mods["step_generator"](SEED, 0, "cuda"))
                out = {k: tuple(t.to(dtype) for t in v) if isinstance(v, tuple)
                       else v.to(dtype) for k, v in out.items()}
                loss = tr.loss_fn(out, batch)
                loss.backward()
                grads = {n: p.grad.clone() for n, p in model.named_parameters()}
                model.float()
                return loss.item(), grads

            loss_k, grads_k = loss_grads(True)
            eps = torch.randn(batch["image"].shape, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(SEED))
            with plain_kernels(mods):
                loss_ref, grads_ref = loss_grads(False, dtype=torch.float64)
                loss_p, grads_p = loss_grads(False)
                # the plain path's own move at rounding level of the image
                floor = grad_errors(loss_grads(False, batch["image"] * (1 + 1e-7 * eps))[1],
                                    grads_p, 1e-3)
            worst, worst_name, median, worst_abs = grad_errors(grads_k, grads_ref, 1e-3)
            vs_plain, plain_vs_ref = (grad_errors(grads_k, grads_p, 1e-3),
                                      grad_errors(grads_p, grads_ref, 1e-3))
            rel = abs(loss_k - loss_ref) / abs(loss_ref)
            say(f"  {net} packed f32 step vs the plain net's f64 step (plain versions): loss "
                f"{loss_k:.7f} vs {loss_ref:.7f} (relative {rel:.3g}, tol 1e-5); worst grad "
                f"error / max(its max |g|, 1e-3 of the largest) {worst:.3g} ({worst_name}, "
                f"tol {STEP_GRAD_TOL}); / max(1, max |g|) {worst_abs:.3g} (tol 1e-3); median "
                f"max |g| {median:.3g}; not gated: vs the plain net's f32 step {vs_plain[0]:.3g} "
                f"({vs_plain[1]}), which lies {plain_vs_ref[0]:.3g} ({plain_vs_ref[1]}) from "
                f"the f64 step; plain vs plain on the image at rounding level {floor[0]:.3g} "
                f"({floor[1]})")
            if not rel <= 1e-5 or not worst <= STEP_GRAD_TOL or not worst_abs <= 1e-3:
                fail(f"{net} packed train step vs the f64 step mismatch")
            del model
        variants = {k[len("train_"):]: tr for k, tr in trainers.items()
                    if k == f"train_{net}" or k.startswith(f"train_{net}_")}
        mins, meds = _train_passes(torch, variants, batch, steps=3, reps=3)
        step_ms[net] = {"min": mins, "median": meds}
        say(f"  {net} train step 1x{dhw[0]}x{dhw[1]}x{dhw[2]} ms ({mods['smi']}), 3 steps a "
            f"pass, 3 interleaved passes: min {json.dumps(mins)}, median {json.dumps(meds)}")
        for name, tr in variants.items():
            split, wall = mods["traced_split"](lambda tr=tr: tr.train_step(batch))
            dev = sum(split.values())
            say(f"  {name} step device {dev:.3f} ms of {wall:.3f} wall (busy "
                f"{dev / wall:.2f}), by family {json.dumps(kernel_families(split))}")
    del trainers
    say(f"  zoo phase in {time.perf_counter() - t_phase:.1f} s")
    return paths, in_rows


def phase_bench(torch, mods):
    """K2's micro-benchmarks at the probes' full shapes.  Each K4-K6
    variant is held to its plain version (one bf16 step) and the plain
    version timed; each partial slab variant's one cuDNN call is held to
    it too and timed.  Then the probe modules run with counts from 0, as a
    user runs them, and their times are the kernels' ms.  Returns
    ({kernel: {tag: row}}, the bench path's launches)."""
    kmicro, kmicro2, kmicro3, kbench = (mods[k] for k in ("kmicro", "kmicro2", "kmicro3",
                                                          "kbench"))
    s1, s3 = kmicro.DEFAULTS, kmicro3.DEFAULTS  # kmicro2.DEFAULTS is s1
    t0 = time.perf_counter()
    in1 = kmicro.make_inputs("cuda")
    in2 = kmicro2.make_inputs("cuda", k4_inputs=in1)  # K4's xf, drawn once
    in3 = kmicro3.make_inputs("cuda")
    torch.cuda.synchronize()
    say(f"  inputs drawn (numpy default_rng(0), the probes' order) in "
        f"{time.perf_counter() - t0:.1f} s")

    # the whole conv's yardstick: cuDNN's bf16 conv of K4 full's work, on
    # the probe's NDHWC volume, with K4's weight as a DHWIO kernel
    # (Wm[(dx, co), (dz, dy, ci)]) in channels_last_3d
    w_lib = in1["wm"].reshape(3, 16, 3, 3, 16).permute(1, 4, 2, 3, 0).contiguous(
        memory_format=torch.channels_last_3d)
    x_lib = in1["x_nd"].permute(0, 4, 1, 2, 3)
    conv_ms = time_ms(torch, lambda: torch.nn.functional.conv3d(x_lib, w_lib, padding=1))
    say(f"  library: cuDNN bf16 conv3d {tuple(x_lib.shape)} channels_last_3d "
        f"{conv_ms:.4f} ms")
    whole = ("K4 full", "K6 pre", "K6 cat")

    xflat, w2 = in3["xflat"], in3["w2"]
    xcat = mods["flat_conv"].build_xcat(xflat)
    # (kernel, tag, kernel call, plain call, library call or None)
    cases = [("slab_conv", f"K4 {kind}", lambda kind=kind: kmicro.kernel(in1, kind, s1),
              lambda kind=kind: kmicro.plain(in1, kind, s1),
              kmicro.library(in1["xf"], in1["wm"], kind, s1))
             for kind in kmicro.KINDS]
    cases += [("slab_conv", f"K5 {tag}", lambda tag=tag: kmicro2.kernel(in2, tag, s1),
               lambda tag=tag: kmicro2.plain(in2, tag, s1),
               kmicro.library(in2["xf"], in2[tag], kmicro2.variant_args(tag, s1)[0], s1))
              for tag in kmicro2.VARIANTS]
    cases += [("flat_conv", "K6 pre", lambda: kmicro3.kernel(xcat, w2, s3, True),
               lambda: kmicro3.plain(xcat, w2, s3, True), None),
              ("flat_conv", "K6 cat", lambda: kmicro3.kernel(xflat, w2, s3, False),
               lambda: kmicro3.plain(xflat, w2, s3, False), None)]
    results = {"slab_conv": {}, "flat_conv": {}}
    for name, tag, kernel, plain, lib in cases:
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        del got
        if not err <= TOL["bfloat16"] * scale:
            fail(f"{name} {tag}: error {err} > {TOL['bfloat16']} * {scale}")
        library_ms, lib_note = (conv_ms, "the whole conv") if tag in whole else (None, "none")
        if lib is not None:
            lib_err, _ = rel_err(kmicro.library_out(lib()), ref)
            if not lib_err <= TOL["bfloat16"] * scale:
                fail(f"{name} {tag}: cuDNN differs from the plain version by {lib_err}")
            library_ms = time_ms(torch, lib)
            lib_note = f"one cuDNN conv3d, max_abs_err {lib_err:.3g}"
        del ref
        # the plain version builds A in fp32 in device memory: fewer runs
        plain_ms = time_ms(torch, plain, iters=3)
        results[name][tag] = dict(max_abs_err=err, plain_ms=plain_ms, library_ms=library_ms)
        say(f"  {name} {tag}: max_abs_err {err:.3g} (scale {scale:.3g}), plain "
            f"{plain_ms:.4f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} ({lib_note})")
    del xcat

    # the bench path, as `python -m tpuseg_torch.benchmarks.<probe>` runs it
    reset_counts(mods)
    t0 = time.perf_counter()
    r4 = kmicro.run("cuda", inputs=in1)
    r5 = kmicro2.run("cuda", inputs=in2)
    r6 = kmicro3.run("cuda", inputs=in3)
    del in1, in2, in3
    chains = kbench.run("cuda")
    torch.cuda.synchronize()
    path_launches = counts(mods)
    say(f"  bench path in {time.perf_counter() - t0:.1f} s; launches {path_launches}")
    # each variant's kernel time and bound, from the probe modules' run
    timed = {f"K4 {kind}": r4[kind] for kind in kmicro.KINDS}
    timed.update({f"K5 {tag}": r5[tag] for tag in kmicro2.VARIANTS})
    timed["K6 pre"] = {"ms": r6["a_prebuilt_xcat"]["kernel_ms"],
                       **r6["a_prebuilt_xcat"]["kernel_bound"]}
    timed["K6 cat"] = r6["b_inkernel_cat"]
    for name, rows in results.items():
        for tag, row in rows.items():
            t = timed[tag]
            row.update(ms=t["ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"])
            say(f"  {name} {tag}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['gflop']:.1f} GFLOP the output needs, "
                f"{t['mbytes']:.1f} MB; the probe's GEMM {t['gemm_gflop']:.1f} GFLOP)")
    for case, r in chains.items():
        say(f"  kbench {case}: cuDNN {r['cudnn']:.2f} TF/s ({r['cudnn_ms']:.4f} ms per "
            f"chain), conv3d_small {r['conv3d_small']:.2f} TF/s ({r['conv3d_small_ms']:.4f} "
            f"ms); one layer max_abs_diff {r['max_abs_diff_1layer']:.3g} (scale "
            f"{r['scale_1layer']:.3g})")
        if not r["max_abs_diff_1layer"] <= TOL["bfloat16"] * r["scale_1layer"]:
            fail(f"kbench {case}: K2 and cuDNN differ by {r['max_abs_diff_1layer']}")
    return results, path_launches


def vnet_conv_cases():
    """(cin, cout, side, uses per forward) of the convs that take
    conv3d_small in VNet3d(features=16) at 96^3 patches."""
    f = FEATURES
    return [(f, f, 96, 1), (2 * f, 2 * f, 48, 4), (4 * f, 4 * f, 24, 6)]


def vnet_norm_cases():
    """(channels, side, uses per forward) of the VNet3d's 34 GroupNorms."""
    f = FEATURES
    return [(f, 96, 5), (2 * f, 48, 7), (4 * f, 24, 9), (8 * f, 12, 9), (16 * f, 6, 4)]


def unet_batch_cases():
    """The packed UNet3d forward's kernel shapes ((d, h, w) per sample):
    K2's convs at levels 1-2 (level 0 runs packed, through K3), K1's 18
    GroupNorms (level 0's on the packed maps, the same rows as the fine
    map's), K3's packed convs on the level-1 grid."""
    convs = [(cin, cout, level_shape(lvl), uses) for cin, cout, lvl, uses in conv_cases()
             if lvl > 0]
    norms = [(c, level_shape(lvl), uses) for c, lvl, uses in norm_cases()]
    packs = [(c_fines, f, level_shape(lvl), uses, FULL_AXES)
             for c_fines, f, lvl, uses in packed_cases()]
    return convs, norms, packs


def vnet_batch_cases():
    """The VNet3d forward's K2 and K1 shapes at 96^3 patches."""
    return ([(cin, cout, (side,) * 3, uses) for cin, cout, side, uses in vnet_conv_cases()],
            [(c, (side,) * 3, uses) for c, side, uses in vnet_norm_cases()], [])


def vnet_packed_batch_cases():
    """The packed VNet3d twin's K3 shapes at 96^3 patches (its K2 and K1
    shapes are the plain net's, held and timed for ``swin_vnet``): up_tr32's
    LUConv on the fully packed 48^3 grid, 8 x 16 channels, and level B's
    four LUConvs on the (H, W) grid (48, 24, 24), 4 x 32 channels."""
    f = FEATURES
    return ([], [], [((f,), f, (48, 48, 48), 1, FULL_AXES),
                     ((2 * f,), 2 * f, (48, 24, 24), 4, HW_AXES)])


def batch_kernel_rows(torch, mods, n: int, cases, dtypes, tag: str):
    """K2, K1 and K3 at one forward's shapes at a batch of ``n`` patches,
    each held to its plain version and timed (a, b, b, a): {(kernel,
    dtype): one forward's calls summed}.  ``cases`` is (convs (cin, cout,
    (d, h, w), uses), norms (c, (d, h, w), uses), packs (c_fines, f,
    packed (d, h, w), uses, the grid's packed axes))."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    convs, norms, packs = cases
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
        rate = "tf32x3" if dtype_name == "float32" else dtype_name
        rows = {"conv3d_small": [], "fused_group_norm_relu": [],
                "packed_conv3d_structured": []}
        for cin, cout, (d, h, w), uses in convs:
            x = torch.randn((n, d, h, w, cin), generator=gen, device="cuda").to(dtype)
            wt = torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda") \
                * (2.0 / (27 * cin)) ** 0.5
            packed = conv3d.pack_weight(wt, dtype)
            err, scale = rel_err(conv3d.conv3d_small(x, wt, packed),
                                 conv3d.conv3d_small_plain(x, wt))
            ms, plain_ms = time_pair(torch, lambda: conv3d.conv3d_small(x, wt, packed),
                                     lambda: conv3d.conv3d_small_plain(x, wt), iters=5)
            vox = n * d * h * w
            bound = bound_ms(2.0 * 27 * cin * cout * vox,
                             (cin + cout) * vox * size + 27 * cin * cout * 4, rate)
            _check_row({"c": rows["conv3d_small"]}, "c", dtype_name,
                       f"{tag} {cin}->{cout} @{n}x{d}x{h}x{w}", err, scale, ms, plain_ms,
                       uses, bound, plain_ms)
            del x
        for c, (d, h, w), uses in norms:
            x = (torch.randn((n, d, h, w, c), generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            err, scale = rel_err(fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                                 fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6))
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                lambda: fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6),
                iters=5)
            xl = x.permute(0, 4, 1, 2, 3).contiguous()
            library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl, 8, gamma.to(dtype), beta.to(dtype), 1e-6), iters=5)
            del xl
            n_el = x.numel()
            _check_row({"c": rows["fused_group_norm_relu"]}, "c", dtype_name,
                       f"{tag} C{c} @{n}x{d}x{h}x{w}", err, scale, ms, plain_ms, uses,
                       bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name), library_ms,
                       " (F.group_norm, no ReLU)")
            del x
        for c_fines, f, (d, h, w), uses, axes in packs:
            npos = n * d * h * w
            p = 2 ** sum(axes)
            parts = [torch.randn((n, d, h, w, p * c), generator=gen, device="cuda").to(dtype)
                     for c in c_fines]
            cin = sum(c_fines)
            wf = (torch.randn((3, 3, 3, cin, f), generator=gen, device="cuda")
                  * (2.0 / (27 * cin)) ** 0.5).cpu()
            splits = [sum(c_fines[:i]) for i in range(len(c_fines) + 1)]
            w3s = [mods["pack_k3_axes"](wf[..., a:b, :], axes).cuda()
                   for a, b in zip(splits, splits[1:])]
            packed = packed_conv.pack_tc(w3s, dtype, axes)

            def k3(parts=parts, w3s=w3s, packed=packed, axes=axes):
                return packed_conv.packed_conv3d_structured(parts, w3s, packed=packed,
                                                            axes=axes)

            err, scale = rel_err(k3(), packed_conv.packed_conv3d_plain(parts, w3s))
            ms, plain_ms = time_pair(
                torch, k3, lambda: packed_conv.packed_conv3d_plain(parts, w3s), iters=5)
            x_cat = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cat = torch.cat(w3s, dim=3).to(dtype).permute(4, 3, 0, 1, 2)
            library_ms = time_ms(
                torch, lambda: torch.nn.functional.conv3d(x_cat, w_cat, padding=1), iters=5)
            del x_cat
            # as phase 3: 27 fine taps of cin channels per fine output, p
            # fine outputs a position; the structural weight read once
            flops = 2.0 * npos * p * f * 27 * cin
            k = packed_conv.k_rows([p * c for c in c_fines], axes)
            io = (p * cin + p * f) * npos * size + k * p * f * 4
            grid = "packed" if all(axes) else "packed (H, W)"
            _check_row({"c": rows["packed_conv3d_structured"]}, "c", dtype_name,
                       f"{tag} {' + '.join(str(p * c) for c in c_fines)}->{p * f} "
                       f"@{n}x{d}x{h}x{w} {grid}", err, scale, ms, plain_ms, uses,
                       bound_ms(flops, io, rate), library_ms, " (cuDNN's dense coarse conv)")
            del parts
        for name, r in rows.items():
            if not r:
                continue
            out[(name, dtype_name)] = {
                f: sum(row[f] * row["uses"] for row in r)
                for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            out[(name, dtype_name)]["max_abs_err"] = max(row["max_abs_err"] for row in r)
            out[(name, dtype_name)]["max_err_over_scale"] = max(
                row["max_abs_err"] / row["scale"] for row in r)
            out[(name, dtype_name)]["calls"] = sum(row["uses"] for row in r)
    return out


def swin_volume_hu(rng) -> np.ndarray:
    """bench.py's primary volume (``bench.py:248-251``), drawn from ``rng``
    in its order: integer HU, soft tissue with noise and a brighter box."""
    hu = rng.normal(0.0, 120.0, size=SWIN_VOL)
    hu[40:120, 40:120, 48:144] += rng.normal(60.0, 30.0, size=(80, 80, 96))
    return np.round(hu).astype(np.float32)


def interleaved(torch, fns: dict, reps: int):
    """Host-clock seconds of each variant, round-robin over ``reps``, each
    call ended by ``torch.cuda.synchronize()``: ({name: min}, {name:
    median})."""
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append(time.perf_counter() - t0)
    return ({k: float(np.min(v)) for k, v in ts.items()},
            {k: float(np.median(v)) for k, v in ts.items()})


def phase_swin(torch, mods):
    """Sliding-window inference: VNet3d at bench.py's primary (f32 from a
    host-normalized or a uint8 HU-coded upload, bf16 compute from a bf16
    upload, 25 % overlap), its packed twin from the uint8 upload in f32 and
    bf16 (bench.py's ``run_primary``) and at packed_levels 1, and
    MutilUNet3dModel.inference_patch through the packed twin and the
    packed merge; gates, launch counts, times.  Returns ({path: launches},
    {path: batch_kernel_rows})."""
    import copy

    swi = mods["sliding_window_inference"]
    psw = mods["sliding_window"]
    rng = np.random.default_rng(SEED)
    vol_hu = swin_volume_hu(rng)
    vol = mods["truncate_and_normalize"](vol_hu, *SWIN_HU_WINDOW, "meanstd")
    codes, dq = mods["hu_code_volume"](vol_hu, *SWIN_HU_WINDOW, "meanstd")

    net = mods["VNet"](SWIN_CLASSES, FEATURES).cuda().eval()
    net.load_state_dict(mods["vnet_params_from_jax"](
        mods["seeded_vnet_params"](SEED, FEATURES, SWIN_CLASSES, 1)), strict=True)
    # its own copy for bf16, so that each keeps one dtype's packed weights
    net_bf16 = copy.deepcopy(net)

    def apply_f32(p):
        return net(p)[1]

    def apply_bf16(p):
        return net_bf16(p.to(torch.bfloat16))[1]

    # the packed twin as inference_patch serves it: class-major packed
    # probabilities into the packed merge; bf16 on the bf16 copy
    pvp = mods["vnet_packed"]

    def apply_packed(p, levels=2):
        return pvp.packed_vnet3d_apply(net, p, packed_levels=levels, return_packed=True,
                                       packed_layout="class")[1]

    def apply_packed_bf16(p):
        return pvp.packed_vnet3d_apply(net_bf16, p.to(torch.bfloat16), return_packed=True,
                                       packed_layout="class")[1]

    opts = dict(return_mask=True, pack_mask=True)
    packed_opts = dict(opts, dequant=dq, packed_apply=True, packed_layout="class")
    runs = {
        "f32": lambda: swi(vol, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH, **opts),
        "u8": lambda: swi(codes, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH,
                          dequant=dq, **opts),
        "bf16": lambda: swi(vol, SWIN_PATCH, apply_bf16, SWIN_CLASSES, SWIN_BATCH,
                            transfer_dtype="bfloat16", **opts),
        "u8_overlap25": lambda: swi(codes, SWIN_PATCH, apply_f32, SWIN_CLASSES, 12,
                                    overlap=0.25, dequant=dq, **opts),
        # the plain bf16 net from the uint8 upload, the packed bf16 twin's
        # reference
        "u8_bf16": lambda: swi(codes, SWIN_PATCH, apply_bf16, SWIN_CLASSES, SWIN_BATCH,
                               dequant=dq, **opts),
        "u8_packed": lambda: swi(codes, SWIN_PATCH, apply_packed, SWIN_CLASSES, SWIN_BATCH,
                                 **packed_opts),
        "u8_packed_bf16": lambda: swi(codes, SWIN_PATCH, apply_packed_bf16, SWIN_CLASSES,
                                      SWIN_BATCH, **packed_opts),
        "u8_packed_lv1": lambda: swi(codes, SWIN_PATCH, lambda p: apply_packed(p, 1),
                                     SWIN_CLASSES, SWIN_BATCH, **packed_opts),
    }
    t0 = time.perf_counter()
    masks = {k: fn() for k, fn in runs.items()}  # builds each path's packed weights
    say(f"  first volumes (one each) in {time.perf_counter() - t0:.2f} s")
    launches = {}
    for path, run, want in (("swin_vnet", "u8", SWIN_VNET_LAUNCHES),
                            ("swin_vnet_bf16", "bf16", SWIN_VNET_LAUNCHES),
                            ("swin_vnet_packed", "u8_packed", SWIN_VNET_PACKED_LAUNCHES),
                            ("swin_vnet_packed_bf16", "u8_packed_bf16",
                             SWIN_VNET_PACKED_LAUNCHES),
                            ("swin_vnet_packed_lv1", "u8_packed_lv1",
                             SWIN_VNET_PACKED1_LAUNCHES)):
        reset_counts(mods)
        masks[run] = runs[run]()
        launches[path] = counts(mods)
        if launches[path] != want:
            fail(f"{path}: launches {launches[path]} != {want} (one 27-patch forward)")
    # packed_levels 1 is a variant timed beside the primary, not a path of
    # the kernels line
    launches_lv1 = launches.pop("swin_vnet_packed_lv1")
    with plain_kernels(mods):
        mask_plain = runs["f32"]()
    n_vox = float(np.prod(SWIN_VOL))
    agree = {
        "f32_kernels_vs_plain": float((masks["f32"] == mask_plain).mean()),
        "u8_vs_f32": float((masks["u8"] == masks["f32"]).mean()),
        "bf16_vs_f32": float((masks["bf16"] == masks["f32"]).mean()),
        "overlap25_vs_50": float((masks["u8_overlap25"] == masks["u8"]).mean()),
        "packed_vs_plain_f32": float((masks["u8_packed"] == masks["u8"]).mean()),
        "packed_vs_plain_bf16": float((masks["u8_packed_bf16"] == masks["u8_bf16"]).mean()),
        "packed_lv1_vs_plain_f32": float((masks["u8_packed_lv1"] == masks["u8"]).mean()),
    }
    say(f"  VNet3d {SWIN_VOL} patch {SWIN_PATCH} batch {SWIN_BATCH}: launches per volume "
        f"{json.dumps(launches)}, packed_levels 1 {json.dumps(launches_lv1)}; mask agreement "
        f"{json.dumps(agree)} (gates: f32 kernels vs plain and u8 vs f32 >= 0.999, the "
        f"packed twin vs the plain net >= {PACKED_AGREE['float32']} in f32 (both levels) "
        f"and >= {PACKED_AGREE['bfloat16']} in bf16; bf16 vs f32 and 25 % overlap not "
        f"gated); foreground {float(masks['u8'].sum()) / n_vox:.4f}")
    for m in masks.values():
        if m.shape != SWIN_VOL or m.max() > 1:
            fail(f"VNet3d mask shape {m.shape} / labels {np.unique(m)}")
    if not agree["f32_kernels_vs_plain"] >= 0.999 or not agree["u8_vs_f32"] >= 0.999:
        fail(f"VNet3d sliding-window agreement {agree}")
    if (not agree["packed_vs_plain_f32"] >= PACKED_AGREE["float32"]
            or not agree["packed_lv1_vs_plain_f32"] >= PACKED_AGREE["float32"]
            or not agree["packed_vs_plain_bf16"] >= PACKED_AGREE["bfloat16"]):
        fail(f"packed VNet3d twin against the plain net: {agree}")

    # volume wall time, interleaved; peak memory of the primary
    best, med = interleaved(torch, runs, reps=3)
    peak_gb = {}
    for k in ("u8", "u8_packed", "u8_packed_bf16"):
        torch.cuda.reset_peak_memory_stats()
        runs[k]()
        peak_gb[k] = torch.cuda.max_memory_allocated() / 1e9
    # device ms: one 27-patch forward (f32, bf16), and the merge alone (the
    # forward replaced by its stored output): patches, dequant, accumulate,
    # argmax, bit packing
    positions = psw.grid_positions(SWIN_VOL, SWIN_PATCH, 0.5)
    x_codes = torch.from_numpy(codes[..., None]).cuda()
    pd, ph, pw = SWIN_PATCH
    batch = torch.stack([x_codes[z:z + pd, y:y + ph, w:w + pw]
                         for z, y, w in positions.tolist()]).float() * dq[0] + dq[1]
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: apply_f32(batch), iters=3)
        fwd_bf16_ms = time_ms(torch, lambda: apply_bf16(batch), iters=3)
        # the packed twin's forward, packed_levels 2 and 1, f32 and bf16
        fwd_packed_ms = {
            "f32_lv2": time_ms(torch, lambda: apply_packed(batch), iters=3),
            "bf16_lv2": time_ms(torch, lambda: apply_packed_bf16(batch), iters=3),
            "f32_lv1": time_ms(torch, lambda: apply_packed(batch, 1), iters=3),
            "bf16_lv1": time_ms(torch, lambda: pvp.packed_vnet3d_apply(
                net_bf16, batch.to(torch.bfloat16), packed_levels=1, return_packed=True,
                packed_layout="class")[1], iters=3)}
        stored = apply_f32(batch)
        merge_ms = time_ms(torch, lambda: psw._merge(
            x_codes, positions, lambda p: stored, SWIN_PATCH, SWIN_BATCH, SWIN_CLASSES,
            False, True, True, dq, False, "delta"), iters=5)
        stored = apply_packed(batch)
        merge_packed_ms = time_ms(torch, lambda: psw._merge(
            x_codes, positions, lambda p: stored, SWIN_PATCH, SWIN_BATCH, SWIN_CLASSES,
            False, True, True, dq, True, "class"), iters=5)
        del stored
    # host: pad, pin and upload (the codes need no pad here), fetch
    t0 = time.perf_counter()
    for _ in range(3):
        psw._upload(codes[..., None], False, "cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / 3 * 1e3
    dev_mask = torch.zeros(int(n_vox) // 8, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    for _ in range(3):
        psw._fetched(psw._fetch(dev_mask))
    fetch_ms = (time.perf_counter() - t0) / 3 * 1e3
    del x_codes, batch, dev_mask
    # the device's busy share within one volume's own run: a torch.profiler
    # trace of one u8 volume, its kernels' and copies' device time over
    # its host-clock time
    busy = {k: mods["traced_busy"](runs[k]) for k in ("u8", "bf16", "u8_packed",
                                                      "u8_packed_bf16")}
    times = {k: {"min_ms": best[k] * 1e3, "median_ms": med[k] * 1e3} for k in runs}
    say(f"  VNet3d volume wall ms (host clock, min / median of 3 interleaved): "
        f"{json.dumps(times)}; device ms: forward f32 {fwd_ms:.3f}, bf16 {fwd_bf16_ms:.3f}, "
        f"packed twin " + ", ".join(f"{k} {v:.3f}" for k, v in fwd_packed_ms.items())
        + f", merge {merge_ms:.3f}, packed merge {merge_packed_ms:.3f}; host ms: pin + "
        f"upload of the uint8 codes {upload_ms:.3f}, fetch of the packed mask "
        f"{fetch_ms:.3f}; traced volume (device ms, host ms, busy share): "
        + ", ".join(f"{k} {d:.3f} / {w:.3f} / {d / w:.4f}" for k, (d, w) in busy.items())
        + "; peak memory " + ", ".join(f"{k} {v:.2f} GB" for k, v in peak_gb.items()))
    # the packed twin's forward by kernel (torch.profiler, one 27-patch
    # forward after a warmup, seeded weights as above)
    for dtype_name in ("float32", "bfloat16"):
        split, _ = mods["swin_forward_split"](getattr(torch, dtype_name), forwards=1,
                                              packed_levels=2)
        top = list(split.items())[:12]
        say(f"  packed VNet3d forward {dtype_name} device ms by kernel (sum "
            f"{sum(split.values()):.3f} over {len(split)} kernels): "
            + "; ".join(f"{k[:70]} {v:.3f}" for k, v in top))

    # the pipelined stream: 3 coded volumes, masks as one by one
    t0 = time.perf_counter()
    piped = mods["sliding_window_inference_pipelined"](
        [codes] * 3, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH, dequants=dq)
    piped_ms = (time.perf_counter() - t0) * 1e3
    piped_agree = min(float((m == masks["u8"]).mean()) for m in piped)
    say(f"  pipelined: 3 uint8 volumes in {piped_ms:.1f} ms ({piped_ms / 3:.1f} a volume); "
        f"least agreement with the one-volume call's mask {piped_agree:.6f}")
    if len(piped) != 3 or not piped_agree >= 0.999:
        fail("the pipelined masks differ from the one-volume call's")

    # whole-volume VNet3d inference through the compat class, once
    model_v = mods["MutilVNet3dModel"](96, 96, 96, 1, SWIN_CLASSES, features=FEATURES,
                                       device="cuda")
    model_v.load_jax_params(mods["seeded_vnet_params"](SEED, FEATURES, SWIN_CLASSES, 1))
    ct = mods["synthetic_ct"]((140, 120, 90), rng)
    reset_counts(mods)
    whole = model_v.inference(ct, (96, 96, 96)).array
    whole_launches = counts(mods)
    say(f"  MutilVNet3dModel.inference {ct.array.shape} at 96^3 (the packed twin, as "
        f"JAX serves a side that 32 divides): labels "
        f"{sorted(int(v) for v in np.unique(whole))}; launches {whole_launches}")
    if (whole.shape != ct.array.shape or whole.max() > 1
            or whole_launches != SWIN_VNET_PACKED_LAUNCHES):
        fail("MutilVNet3dModel.inference")
    del model_v

    # UNet3d inference_patch: the packed twin and the packed merge
    model_u = mods["MutilUNet3dModel"](*SWIN_UNET_PATCH, 1, CLASSES, features=FEATURES,
                                       device="cuda")
    model_u.load_jax_params(mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1))
    ct = mods["synthetic_ct"](SWIN_UNET_SIZE, rng)
    ct.spacing = SWIN_UNET_SPACING

    def unet_patch():
        return model_u.inference_patch(ct, (0.5, 0.5, 0.5), batch_size=SWIN_UNET_BATCH).array

    unet_patch()
    reset_counts(mods)
    mask_u = unet_patch()
    launches["swin_unet"] = counts(mods)
    with plain_kernels(mods), unpacked(model_u):
        ref_u = unet_patch()
    agree_u = float((mask_u == ref_u).mean())
    u_best, u_med = interleaved(torch, {"unet": unet_patch}, reps=3)
    work = mods["resample_to_spacing"](ct, (0.5, 0.5, 0.5))
    positions_u = psw.grid_positions(work.array.shape, SWIN_UNET_PATCH, 0.5)
    n_fwd = -(-len(positions_u) // SWIN_UNET_BATCH)
    # device ms of one batch-8 forward of the packed twin (as
    # inference_patch calls it) and of the packed merge alone (its forward
    # replaced by the stored output); the traced volume's busy share
    layout = model_u.packed_probs_layout
    batch_u = torch.randn((SWIN_UNET_BATCH, *SWIN_UNET_PATCH, 1), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(SEED))
    x_work = torch.randn((*work.array.shape, 1), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.inference_mode():
        def fwd_u():
            return mods["packed_unet3d_apply"](model_u.model, batch_u, return_packed=True,
                                               packed_layout=layout)[1]
        fwd_u_ms = time_ms(torch, fwd_u, iters=3)
        stored_u = fwd_u()
        merge_u_ms = time_ms(torch, lambda: psw._merge(
            x_work, positions_u, lambda p: stored_u, SWIN_UNET_PATCH, SWIN_UNET_BATCH,
            CLASSES, False, True, False, None, True, layout), iters=5)
        del stored_u
    del batch_u, x_work
    dev_u, wall_u = mods["traced_busy"](unet_patch)
    say(f"  MutilUNet3dModel.inference_patch {ct.array.shape} -> {work.array.shape} at "
        f"0.5 mm, patch {SWIN_UNET_PATCH} batch {SWIN_UNET_BATCH} ({n_fwd} forward): "
        f"launches {launches['swin_unet']}; labels {sorted(int(v) for v in np.unique(mask_u))}; "
        f"agreement with the plain, unpacked net through the plain versions {agree_u:.6f}; "
        f"wall ms min {u_best['unet'] * 1e3:.1f}, median {u_med['unet'] * 1e3:.1f}; "
        f"device ms: batch-{SWIN_UNET_BATCH} packed forward {fwd_u_ms:.3f}, packed merge "
        f"{merge_u_ms:.3f}; traced volume: device {dev_u:.3f} ms of {wall_u:.3f} ms host "
        f"(busy share {dev_u / wall_u:.4f})")
    if mask_u.shape != ct.array.shape or mask_u.max() > CLASSES - 1:
        fail(f"UNet3d inference_patch mask {mask_u.shape}")
    if launches["swin_unet"]["packed_conv3d_structured"] != 3 * n_fwd:
        fail(f"UNet3d inference_patch launched K3 "
             f"{launches['swin_unet']['packed_conv3d_structured']} times, not {3 * n_fwd}")
    if not agree_u >= 0.999:
        fail(f"UNet3d inference_patch agreement {agree_u} < 0.999")
    del model_u

    # K2 and K1 at the VNet3d's shapes at 27 patches (f32, bf16), and K2,
    # K1 and K3 at the packed UNet3d's at 8 (f32), against plain, timed
    rows = {"swin_vnet": batch_kernel_rows(torch, mods, SWIN_BATCH, vnet_batch_cases(),
                                           ("float32", "bfloat16"), "VNet"),
            "swin_vnet_packed": batch_kernel_rows(torch, mods, SWIN_BATCH,
                                                  vnet_packed_batch_cases(),
                                                  ("float32", "bfloat16"), "VNet packed"),
            "swin_unet": batch_kernel_rows(torch, mods, SWIN_UNET_BATCH, unet_batch_cases(),
                                           ("float32",), "UNet packed")}
    return launches, rows


# phase 9: the whole-volume pipeline on the card runs the plain UNet3d
# (features 16): K2 its 10 convs at 16-64 channels, K1 its 18 GroupNorms
DEVICE_INFER_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES}, conv3d_small=10,
                             fused_group_norm_relu=18)
# the losses phase 9 trains with (loss name, classes): one class on the
# labels binarised (``--data.binary_labels``)
HOST_LOSSES = (("LovaszLoss", CLASSES), ("MutilClDiceLoss", CLASSES),
               ("BinaryLovaszLoss", 1), ("BinaryClDiceLoss", 1))


def _device_pipeline(torch, mods, net, served):
    """The on-card whole-volume pipeline on the served volumes: launches
    per volume (counts from 0 over the three), shape and geometry,
    agreement with the host pipeline and with itself through the plain
    versions, and times.  Returns (the path's launches, [(name, volume,
    device mask, host mask)])."""
    infer_volume, infer_volume_device = mods["infer_volume"], mods["infer_volume_device"]

    def host(vol):
        return infer_volume(vol, lambda b: net(b)[1], NEW_SIZE)

    def device(vol):
        return infer_volume_device(vol, net, NEW_SIZE, CLASSES)

    for _, vol, _ in served:  # first calls: cuDNN's choices, the bucket caches
        device(vol)
    torch.cuda.synchronize()
    reset_counts(mods)
    dev_masks = []
    for name, vol, _ in served:
        c0 = counts(mods)
        dev_masks.append(device(vol))
        launches = delta(counts(mods), c0)
        if launches != DEVICE_INFER_LAUNCHES:
            fail(f"infer_volume_device {name}: launches {launches} != {DEVICE_INFER_LAUNCHES}")
    path_launches = counts(mods)

    masks = []
    for (name, vol, _), dev in zip(served, dev_masks):
        # each pipeline through its entry point once more, its forward's
        # probabilities kept: the masks on the network's grid, before the
        # resize back (the host's C++ nearest rounds half away from zero in
        # float64 and the device's half to even in float32, each as the
        # JAX package's route does, so the resized masks differ by design)
        seen_dev, seen_host = _KeepProbs(net), _KeepProbs(net)
        dev_again = infer_volume_device(vol, seen_dev, NEW_SIZE, CLASSES)
        ref = infer_volume(vol, lambda b: seen_host(b)[1], NEW_SIZE)
        grid_dev, grid_host = seen_dev.mask(torch), seen_host.mask(torch)
        agree_grid = float((grid_dev == grid_host).mean())
        back = mods["resize_volume_device"](torch.from_numpy(grid_dev),
                                            vol.array.shape, "nearest").numpy()
        resized_back = bool((back == dev_again.array).all())
        with plain_kernels(mods):
            plain = device(vol)
        agree_plain = float((dev.array == plain.array).mean())
        geometry = all(getattr(dev, g)() == getattr(vol, g)()
                       for g in ("GetOrigin", "GetSpacing", "GetDirection"))
        mins, meds = interleaved(torch, {"device": lambda: device(vol),
                                         "host": lambda: host(vol)}, reps=5)
        dev_ms, wall_ms = mods["traced_busy"](lambda: device(vol))
        raw = np.ascontiguousarray(vol.array, np.float32)
        up = time_host_ms(torch, lambda: torch.from_numpy(raw).cuda())
        on_card = torch.zeros(vol.array.shape, dtype=torch.uint8).cuda()
        fetch = time_host_ms(torch, lambda: on_card.cpu())
        say(f"  {name} {vol.array.shape[::-1]} (x y z): infer_volume_device "
            f"{mins['device'] * 1e3:.2f} / {meds['device'] * 1e3:.2f} ms (min / median of "
            f"5, interleaved), host pipeline {mins['host'] * 1e3:.2f} / "
            f"{meds['host'] * 1e3:.2f} ms; traced: device {dev_ms:.3f} of {wall_ms:.3f} ms "
            f"(busy {dev_ms / wall_ms:.3f}); upload of the raw float32 {up:.3f} ms, fetch "
            f"of the uint8 mask {fetch:.3f} ms; agreement with the host pipeline on the "
            f"network's {NEW_SIZE} grid {agree_grid:.6f} (>= 0.99, all voxels), after "
            f"each resize back {float((dev.array == ref.array).mean()):.6f} (not gated); "
            f"the output is its grid mask's nearest resize back: {resized_back}; with the "
            f"plain versions {agree_plain:.6f} (>= 0.999); shape {dev.array.shape}, "
            f"geometry equal: {geometry}")
        if dev.array.shape != vol.array.shape or dev.array.dtype != np.uint8 or not geometry:
            fail(f"infer_volume_device {name}: shape, dtype or geometry differs")
        if not agree_grid >= 0.99 or not resized_back or not agree_plain >= 0.999:
            fail(f"infer_volume_device {name}: agreement {agree_grid} / {resized_back} / "
                 f"{agree_plain}")
        masks.append((name, vol, dev, ref))
    return path_launches, masks


class _KeepProbs:
    """A net for the two whole-volume pipelines that keeps the
    probabilities of its last forward; ``mask`` is their argmax on the
    network's grid, (D, H, W) uint8 on the host."""

    def __init__(self, net):
        self.net, self.probs = net, None

    def __call__(self, x):
        out = self.net(x)
        self.probs = out[1]
        return out

    def mask(self, torch):
        return torch.argmax(self.probs[0], dim=-1).to(torch.uint8).cpu().numpy()


def time_host_ms(torch, fn, iters: int = 5) -> float:
    """Mean host-clock ms of ``fn``, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _evaluator(mods, served, masks, workdir):
    """``SegMetric3d`` on the first volume's device and host masks, native
    KD-tree against scipy's; ``tools.evaluate`` over the served masks
    against the host pipeline's."""
    seg3d, evaluate = mods["seg3d"], mods["evaluate"]
    _, vol, dev, ref = masks[0]
    real, pred = (ref.array != 0).astype(np.uint8), (dev.array != 0).astype(np.uint8)
    spacing = vol.GetSpacing()
    t0 = time.perf_counter()
    native = seg3d.SegMetric3d(real, pred, spacing)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    saved = seg3d.nn_distances
    seg3d.nn_distances = seg3d.nn_distances_plain
    try:
        plain = seg3d.SegMetric3d(real, pred, spacing)
    finally:
        seg3d.nn_distances = saved
    plain_ms = (time.perf_counter() - t0) * 1e3
    pts = (native.real_pts, native.pred_pts)
    t0 = time.perf_counter()
    mods["io_native"].nn_distances(*pts)
    mods["io_native"].nn_distances(*pts[::-1])
    kd_native = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seg3d.nn_distances_plain(*pts)
    seg3d.nn_distances_plain(*pts[::-1])
    kd_plain = (time.perf_counter() - t0) * 1e3
    got, ref_m = native.all_metrics(), plain.all_metrics()
    worst = max(abs(got[k] - ref_m[k]) / max(1.0, abs(ref_m[k])) for k in ref_m)
    say(f"  SegMetric3d, first volume, foreground of the device mask against the host "
        f"mask's ({len(pts[0])} + {len(pts[1])} surface points): native KD-tree "
        f"{native_ms:.1f} ms (its two queries {kd_native:.1f} ms), scipy cKDTree "
        f"{plain_ms:.1f} ms ({kd_plain:.1f} ms); worst metric difference {worst:.3g} "
        f"(<= 1e-9 relative); " + json.dumps({k: round(v, 6) for k, v in got.items()}))
    if not worst <= 1e-9:
        fail(f"SegMetric3d native against scipy: {worst}")

    pred_dir, gt_dir = os.path.join(workdir, "served"), os.path.join(workdir, "host")
    os.makedirs(pred_dir)
    os.makedirs(gt_dir)
    for i, ((name, _, served_mask), (_, _, _, host_mask)) in enumerate(zip(served, masks)):
        mods["write_nifti"](served_mask, os.path.join(pred_dir, name))
        mods["write_nifti"](host_mask, os.path.join(gt_dir, name))
    out_csv = os.path.join(workdir, "evaluation.csv")
    t0 = time.perf_counter()
    evaluate.main([pred_dir, gt_dir, out_csv])
    eval_s = time.perf_counter() - t0
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    say(f"  tools.evaluate over the 3 served masks against the host pipeline's: "
        f"{len(rows)} rows in {eval_s:.2f} s, columns {list(rows[0]) if rows else []}, "
        f"dice {[round(float(r['dice']), 6) for r in rows]}")
    if len(rows) != 4 or rows[-1]["case"] != "MEAN" \
            or list(rows[0]) != ["case", *evaluate.METRIC_KEYS]:
        fail(f"tools.evaluate wrote {rows}")


def _loss_training(torch, mods, workdir):
    """``train.build`` / ``run`` with each loss of ``HOST_LOSSES`` (phase 6's
    data, 1 epoch of 3 steps, f32), every step's launches asserted; one step
    against the same step through the plain versions; step times."""
    train, parse_cli = mods["train"], mods["parse_cli"]
    train_csv, val_csv = write_training_data(workdir, np.random.default_rng(SEED))
    eval_expect = {k: (v if k in ("conv3d_small", "fused_group_norm_relu") else 0)
                   for k, v in TRAIN_LAUNCHES.items()}
    paths = {}
    for loss_name, classes in HOST_LOSSES:
        flags = ["--model.num_classes", str(classes), "--model.features", str(FEATURES),
                 "--model.dropout", "0.2", "--data.image_size", json.dumps(list(NEW_SIZE)),
                 "--data.train_csv", train_csv, "--data.val_csv", val_csv,
                 "--data.binary_labels", json.dumps(classes == 1),
                 "--train.loss_name", loss_name, "--train.optimizer", "adam",
                 "--train.lr", "1e-3", "--train.epochs", "1",
                 "--train.model_dir", os.path.join(workdir, f"run_{loss_name}")]
        cfg = parse_cli(flags)
        trainer, train_loader, val_loader = train.build(cfg, device="cuda")
        steps = []
        _watch_steps(trainer, mods, steps)
        reset_counts(mods)
        t0 = time.perf_counter()
        history = train.run(cfg, trainer, train_loader, val_loader)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        paths[f"train_{loss_name}"] = counts(mods)
        for kind, launches in steps:
            expect = TRAIN_LAUNCHES if kind == "train_step" else eval_expect
            if launches != expect:
                fail(f"{loss_name} {kind} launches {launches} != {expect}")
        kinds = [k for k, _ in steps]
        if kinds.count("train_step") != 3 or kinds.count("eval_step") != 1 \
                or not all(np.isfinite(history["train_loss"])):
            fail(f"{loss_name}: steps {kinds}, history {history}")

        # one step's loss and gradients, kernels against plain
        batch = trainer._put(next(iter(train_loader)))
        net = mods["UNet"](classes, FEATURES, 0.2).cuda()
        net.load_state_dict(mods["unet_params_from_jax"](
            mods["seeded_unet_params"](SEED, FEATURES, classes, 1)), strict=True)
        net.train()
        loss_fn = mods["build_loss"](loss_name, classes, alpha=[1.0] * classes)
        loss_and_grads = _step_grads(torch, mods, net, loss_fn, batch)
        image = batch["image"]
        eps = torch.randn(image.shape, device=image.device,
                          generator=torch.Generator("cuda").manual_seed(SEED))
        noisy = image * (1 + 1e-7 * eps)
        with plain_kernels(mods):
            logits = net(image, mods["step_generator"](SEED, 0, "cuda"))[0].float()
        logits = logits.detach().requires_grad_(True)
        dlogits, = torch.autograd.grad(loss_fn(logits, batch["label"]), logits)
        # given one gradient of the loss by the logits (the plain path's),
        # the step's parameter gradients, kernels against plain, are held to
        # phase 6's gate, which a bf16 step, the control, must exceed.  End
        # to end (the loss's own gradient) they are printed, not gated:
        # Lovasz sorts the errors and clDice's max pools route each gradient
        # to one voxel of a window, so rounding anywhere before the loss
        # moves its gradient by as much as the gate (the plain path against
        # itself on the image perturbed at rounding level shows how much).
        # Both steps' distances from the step in float64 are printed too
        loss_k, e2e_k = loss_and_grads(image)
        grads_k = loss_and_grads(image, dlogits=dlogits)[1]
        with plain_kernels(mods):
            loss_p, e2e_p = loss_and_grads(image)
            e2e_floor = grad_errors(loss_and_grads(noisy)[1], e2e_p)
            grads_p = loss_and_grads(image, dlogits=dlogits)[1]
            floor = grad_errors(loss_and_grads(noisy, dlogits=dlogits)[1], grads_p)
            ref = loss_and_grads(image, torch.float64, dlogits)[1]
        worst, worst_name, median, worst_abs = grad_errors(grads_k, grads_p)
        control = grad_errors(loss_and_grads(image, torch.bfloat16, dlogits)[1], grads_p)
        err_k, err_p = grad_errors(grads_k, ref), grad_errors(grads_p, ref)
        e2e = grad_errors(e2e_k, e2e_p)
        rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)

        def plain_step():
            with plain_kernels(mods):
                trainer.train_step(batch)

        ms, plain_ms = time_pair(torch, lambda: trainer.train_step(batch), plain_step, iters=3)
        say(f"  {loss_name} ({classes} class{'es' if classes > 1 else ''}): 1 epoch x 3 "
            f"steps + validation in {run_s:.2f} s, train loss {history['train_loss']}; "
            f"launches per step as phase 6's on all 3; step kernels vs plain: loss "
            f"{loss_k:.7f} vs {loss_p:.7f} (relative {rel:.3g}, tol 1e-5); given the "
            f"plain path's gradient of the loss by the logits, worst grad error / its "
            f"max |g| {worst:.3g} ({worst_name}, tol {STEP_GRAD_TOL}), / max(1, max |g|) "
            f"{worst_abs:.3g} (tol 1e-3), median max |g| {median:.3g}, plain vs plain on "
            f"the image at rounding level {floor[0]:.3g} ({floor[1]}), bf16 kernels "
            f"control {control[0]:.3g} ({control[1]}); against the f64 step: kernels "
            f"{err_k[0]:.3g} ({err_k[1]}), plain f32 {err_p[0]:.3g} ({err_p[1]}); end to "
            f"end (not gated) kernels vs plain {e2e[0]:.3g} ({e2e[1]}), plain vs plain on "
            f"the image at rounding level {e2e_floor[0]:.3g} ({e2e_floor[1]}); train step "
            f"kernels {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not rel <= 1e-5 or not worst <= STEP_GRAD_TOL or not worst_abs <= 1e-3:
            fail(f"{loss_name} train step kernels vs plain mismatch")
        if not control[0] > STEP_GRAD_TOL:
            fail(f"{loss_name}: the gradient gate does not tell a bf16 step from an f32 one")
    return paths


def phase_host(torch, mods, served, workdir):
    """Phase 9: the whole-volume pipeline on the card, the evaluator, the
    Lovasz and clDice losses in training, and SSIM on the card against the
    CPU.  Returns the launches of its paths."""
    net = mods["UNet"](CLASSES, FEATURES, 0.2).cuda().eval()
    net.load_state_dict(mods["unet_params_from_jax"](
        mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1)), strict=True)
    device_launches, masks = _device_pipeline(torch, mods, net, served)
    paths = {"volume_device": device_launches}
    _evaluator(mods, served, masks, workdir)
    paths.update(_loss_training(torch, mods, workdir))

    # SSIM of two 128x112x112 volumes, on the card against the CPU
    rng = np.random.default_rng(SEED)
    a = rng.random((1,) + TRAIN_DHW + (1,)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0.0, 1.0).astype(np.float32)
    ssim, ms_ssim = mods["ssim"], mods["ms_ssim"]
    cpu = [torch.from_numpy(a), torch.from_numpy(b)]
    card = [t.cuda() for t in cpu]
    for name, fn in (("ssim", ssim), ("ms_ssim", ms_ssim)):
        t0 = time.perf_counter()
        ref = fn(*cpu).item()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = fn(*card).item()
        card_ms = time_ms(torch, lambda: fn(*card), iters=5)
        say(f"  {name} 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]}: card {got:.7f} "
            f"({card_ms:.3f} ms), CPU {ref:.7f} ({cpu_ms:.1f} ms); difference "
            f"{abs(got - ref):.3g} (tol 1e-5)")
        if not abs(got - ref) <= 1e-5:
            fail(f"{name} on the card {got} against the CPU {ref}")
    return paths


# phase 10: augmentation, registration and TPDDNet, in f32 on 1x128^3.  A
# forward's launches (a train step's each way too): VNet3dRegistration
# (features 16): K2 the LUConvINs at 16-64 channels (downs.0 and downs.1 2
# each, ups.1 and ups.2 2 each, ups.3 1; the 128- and 256-channel levels
# and the 2-channel stem go to cuDNN), K1 its 29 InstanceNorms (the stem's
# one norm twice, downs 3 each, ups 4, 4, 4, 3).  TPDDNet (2 classes): K2
# the undilated 3^3 convs with 8-64 channels in (enc 1, 3, 6, 9, 10, 11;
# dec 1, 3, 4, 5: one decoder pass serves both heads), K1 its 18
# InstanceNorms (12 encoder, 6 decoder); the dilated convs go to cuDNN
AUG_DHW = (128, 128, 128)
REG_FEATURES = 16
REG_TRAIN_LAUNCHES = _zoo_step(9, 29)
TP_CLASSES = 2
TP_TRAIN_LAUNCHES = _zoo_step(10, 18)


def _affine_gate(torch, mods, image: np.ndarray, label: np.ndarray) -> dict:
    """The augmenter's affine on the card against the same affine on the
    CPU with the same parameters: the image within 1e-5 of its scale, the
    masks on >= 0.999 of the voxels and exactly without rotation, labels in
    the class set.  Returns the figures."""
    aug = mods["augment3d"]
    img, lab = torch.from_numpy(image)[..., None], torch.from_numpy(label)[..., None]
    params = aug.random_affine_params(torch.Generator().manual_seed(SEED), aug.Affine3DConfig())
    out = {}
    for tag, p in (("rotated", params), ("no rotation", (torch.zeros(3),) + params[1:])):
        ci, cm = aug._apply(img.cuda(), lab.cuda(), *p)
        pi, pm = aug._apply(img, lab, *p)
        err, scale = rel_err(ci.cpu(), pi)
        agree = float((cm.cpu() == pm).float().mean())
        classes = torch.unique(cm).tolist()
        say(f"  affine {tag} 1x{image.shape[0]}x{image.shape[1]}x{image.shape[2]} "
            f"(rot {[round(v, 4) for v in p[0].tolist()]}, zoom "
            f"{[round(v, 4) for v in p[2].tolist()]}, flips {p[3].tolist()}): card vs CPU "
            f"image max_abs_err {err:.3g} (scale {scale:.3g}), mask agreement {agree:.7f}, "
            f"labels {classes}")
        if not err <= 1e-5 * scale or not agree >= 0.999 or not set(classes) <= set(
                range(CLASSES)):
            fail(f"augmentation affine ({tag}) on the card vs the CPU")
        if tag == "no rotation" and agree != 1.0:
            fail("augmentation masks differ without rotation")
        out[tag] = {"image_err": err, "mask_agreement": agree}
    return out


def _peak(torch, fn):
    """(fn's result, the peak device memory in GiB while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() / 2 ** 30


def _param_errors(got: dict, ref: dict, floor: float = 1e-3) -> dict:
    """Per parameter: max |got - ref| over max(max |ref|, ``floor`` x the
    largest max |ref|) (a conv bias feeding an InstanceNorm has a zero
    gradient in exact arithmetic)."""
    top = floor * max(r.double().abs().max().item() for r in ref.values())
    return {n: (got[n].double() - r.double()).abs().max().item()
            / max(r.double().abs().max().item(), top, 1e-30) for n, r in ref.items()}


def _kernel_step_gate(torch, mods, tag: str, loss_and_grads):
    """One train step's loss and parameter gradients through the kernels
    against the same step in float64 through the plain versions (same
    weights, batch and dropout generator).  These InstanceNorm nets' f32
    gradients are ill-conditioned in places (the weight gradient of a conv
    that feeds an InstanceNorm is a difference of large terms: on
    VNet3dRegistration's 16^3 level the plain path's own f32 step moves
    by 6e-2 of max |g| when the input moves at rounding level), so the
    plain versions are measured the same two ways: their f32 step against
    the f64 one, and against itself with the input scaled by 1 + 1e-7.
    The kernels' step must lie within phase 6's gate of the f64 step, or
    no farther than twice the larger of those two distances, worst and
    median (errors over max(max |g|, 1e-3 of the largest)); a bf16 step
    through the kernels, the control, must lie outside that.  Loss 1e-5
    relative."""
    def summary(errs):
        worst = max(errs, key=errs.get)
        return errs[worst], worst, float(np.median(list(errs.values())))

    loss_k, grads_k = loss_and_grads(torch.float32)
    control = loss_and_grads(torch.bfloat16)[1]
    with plain_kernels(mods):
        loss_ref, grads_ref = loss_and_grads(torch.float64)
        grads_p = loss_and_grads(torch.float32)[1]
        own = summary(_param_errors(loss_and_grads(torch.float32, 1.0 + 1e-7)[1], grads_p))
    k, p, c = (summary(_param_errors(g, grads_ref)) for g in (grads_k, grads_p, control))
    gate = (max(STEP_GRAD_TOL, 2 * max(p[0], own[0])), max(1e-3, 2 * max(p[2], own[2])))
    rel = abs(loss_k - loss_ref) / max(abs(loss_ref), 1e-12)
    say(f"  {tag} step vs the f64 step (plain versions): loss {loss_k:.7f} vs {loss_ref:.7f} "
        f"(relative {rel:.3g}, tol 1e-5); grad error / max(its max |g|, 1e-3 of the "
        f"largest), worst and median: kernels {k[0]:.3g} ({k[1]}), {k[2]:.3g}; plain f32 "
        f"{p[0]:.3g} ({p[1]}), {p[2]:.3g}; gate {gate[0]:.3g}, {gate[1]:.3g}; bf16 control "
        f"{c[0]:.3g} ({c[1]}), {c[2]:.3g}; plain f32 vs itself with the input scaled by "
        f"1 + 1e-7 {own[0]:.3g} ({own[1]}), {own[2]:.3g}")
    if not rel <= 1e-5 or not k[0] <= gate[0] or not k[2] <= gate[1]:
        fail(f"{tag} train step kernels vs the f64 step mismatch")
    if not (c[0] > gate[0] or c[2] > gate[1]):
        fail(f"{tag}: the gate does not tell a bf16 step from an f32 one")
    return k


def _steps(torch, mods, trainer, batch, expect: dict, tag: str, n: int = 3):
    """``n`` train steps of ``trainer`` on ``batch`` with counts from 0,
    each step's launches checked; (launches, losses, step ms min, peak
    GiB)."""
    record = []
    _watch_steps(trainer, mods, record)
    reset_counts(mods)
    (losses, ms), peak = _peak(torch, lambda: _timed_steps(torch, trainer, batch, n))
    launches = counts(mods)
    for kind, got in record:
        if got != expect:
            fail(f"{tag} {kind} launches {got} != {expect}")
    del trainer.train_step, trainer.eval_step
    if len(record) != n or not all(np.isfinite(losses)):
        fail(f"{tag}: steps {len(record)}, losses {losses}")
    say(f"  {tag}: {n} train steps, losses {[round(v, 6) for v in losses]}, launches per "
        f"step { {k: v for k, v in expect.items() if v} } on every step; step "
        f"{min(ms):.3f} ms (min of {n}), peak {peak:.2f} GiB ({mods['smi']})")
    return launches, min(ms), peak


def _timed_steps(torch, trainer, batch, n: int):
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _step_split(torch, mods, tag: str, fn) -> None:
    """One call of ``fn`` traced: device ms by kernel family and the five
    longest kernels against its wall time, and the cuDNN conv backward by
    shape (the five longest)."""
    split, wall = mods["traced_split"](fn, 1)
    dev = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:5]
    conv_bwd = list(mods["conv_backward_split"](fn, 1).items())[:5]
    say(f"  {tag} step device {dev:.3f} ms of {wall:.3f} wall (busy {dev / wall:.2f}), by "
        f"family {json.dumps(kernel_families(split))}; longest "
        f"{json.dumps({k[:80]: round(v, 3) for k, v in top})}; conv backward by "
        f"(grad_output, input, weight) {json.dumps({k: round(v, 3) for k, v in conv_bwd})}")


def _augmentation(torch, mods, workdir):
    """Online augmentation through ``train.build`` / ``run`` at phase 6's
    KiPA setting, the affine gate and the augmenter's time; offline
    ``DataAug3D`` over two of the volumes.  Returns the path's launches."""
    train, parse_cli, aug = mods["train"], mods["parse_cli"], mods["augment3d"]
    train_csv, val_csv = write_training_data(workdir, np.random.default_rng(SEED))
    images, labels = train.read_manifest_csv(train_csv)
    _affine_gate(torch, mods, np.load(images[0]), np.load(labels[0]))

    loader = train.DataLoader(train.SegDataset3D(images, labels, TRAIN_DHW), 1)
    batch = next(iter(loader))
    transform = aug.make_batch_augmenter(device="cuda")
    out = transform(batch)
    if out["label"].dtype != batch["label"].dtype or out["image"].shape != batch[
            "image"].shape:
        fail("the batch augmenter changed the batch's dtypes or shapes")
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        transform(batch)
        ts.append((time.perf_counter() - t0) * 1e3)
    say(f"  batch augmenter 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]} on the card "
        f"(host arrays in and out): {min(ts):.2f} ms min, {float(np.median(ts)):.2f} median "
        f"of 5 ({mods['smi']})")

    calls = []
    real = train.make_batch_augmenter

    def counting(*args, **kw):
        fn = real(*args, **kw)

        def counted(b):
            calls.append(kw.get("device"))
            return fn(b)
        return counted

    flags = ["--model.num_classes", str(CLASSES), "--model.features", str(FEATURES),
             "--model.dropout", "0.2", "--data.image_size", json.dumps(list(NEW_SIZE)),
             "--data.train_csv", train_csv, "--data.val_csv", val_csv,
             "--train.loss_name", "MutilDiceLoss", "--train.optimizer", "adam",
             "--train.lr", "1e-3", "--train.epochs", "1", "--data.online_augment", "true",
             "--train.model_dir", os.path.join(workdir, "run_aug")]
    train.make_batch_augmenter = counting
    try:
        (trainer, launches), peak = _peak(torch, lambda: _run_training(
            torch, mods, parse_cli(flags), TRAIN_LAUNCHES, "train_online_augment"))
    finally:
        train.make_batch_augmenter = real
    if calls != ["cuda"] * 3:
        fail(f"online augmentation ran {calls} times, not once per training batch on the card")
    say(f"  online augmentation: the augmenter ran on the card for each of the 3 training "
        f"batches; peak {peak:.2f} GiB")

    # offline: two copies of each of two volumes and their manifest
    two = os.path.join(workdir, "two.csv")
    with open(two, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Image", "Mask"])
        writer.writerows(zip(images[:2], labels[:2]))
    t0 = time.perf_counter()
    out_csv = aug.DataAug3D(aug_number=2, device="cuda").run(two, os.path.join(workdir, "aug"))
    off_s = time.perf_counter() - t0
    rows = train.read_manifest_csv(out_csv)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in images[:2]]
    want = [[os.path.join(workdir, "aug", f"{s}_aug{j}_{k}.npy") for s in stems
             for j in range(2)] for k in ("img", "msk")]
    with open(out_csv) as f:
        header = f.readline().strip()
    if list(rows) != want or header != "Image,Mask":
        fail(f"DataAug3D manifest {header} {rows}")
    for ip, mp in zip(*rows):
        a_img, a_msk = np.load(ip), np.load(mp)
        if a_img.shape != TRAIN_DHW or a_img.dtype != np.float32 or a_msk.dtype != np.uint8 \
                or not set(np.unique(a_msk).tolist()) <= set(range(CLASSES)):
            fail(f"DataAug3D copy {ip}: {a_img.shape} {a_img.dtype} {a_msk.dtype}")
    say(f"  DataAug3D: 2 copies of 2 volumes and trainaugdata.csv in {off_s:.2f} s")
    return {"train_online_augment": launches}


def _registration_pair(torch, mods):
    """A 1x128^3 moving CT (``synthetic_ct``, z-scored) and the fixed one,
    the moving warped by a known smooth displacement (up to 2 voxels a
    side), with their labels (voxels above the mean); a batch on the card."""
    ct = mods["synthetic_ct"](AUG_DHW[::-1], np.random.default_rng(SEED + 11)).array
    mov = ((ct - ct.mean()) / ct.std()).astype(np.float32)
    mov = torch.from_numpy(mov)[None, ..., None].cuda()
    axes = [torch.arange(n, device="cuda", dtype=torch.float32) * (2 * np.pi / n)
            for n in AUG_DHW]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    flow = torch.stack([1.5 * torch.sin(yy), 2.0 * torch.cos(xx) * torch.sin(zz),
                        -1.0 * torch.sin(zz + xx)], dim=-1)[None]
    fix = mods["warp_3d"](mov, flow, "linear")
    return {"moving_image": mov, "fixed_image": fix,
            "moving_label": (mov > mov.mean()).float(),
            "fixed_label": (fix > fix.mean()).float()}


def _regtp_golden(torch, mods):
    """VNet3dRegistration (features 8) and TPDDNet (2 classes) at 1x32^3
    on the card against the JAX package's outputs
    (``tests/data/torch_port_regtp_golden.npz``), within 1e-4 of each
    output's scale."""
    gen_mod = mods["regtp_golden"]
    g = np.load(gen_mod.GOLDEN)
    reg = gen_mod.port_net("reg").cuda().eval()
    pair = gen_mod.reg_inputs()
    with torch.inference_mode():
        out = reg(*(torch.from_numpy(pair[k]).cuda() for k in ("moving_image", "fixed_image",
                                                                 "moving_label")))
    errs = {}
    for key, t in zip(("moved_image", "moved_label", "ddf"), out):
        ref = g[f"reg_fwd/{key}"]
        errs[key] = (float(np.abs(t.cpu().numpy() - ref).max()),
                     max(1.0, float(np.abs(ref).max())))
    tp = gen_mod.port_net("tp").cuda().eval()
    with torch.inference_mode():
        logits = tp(torch.from_numpy(gen_mod.tp_inputs()[0]).cuda())[0].cpu().numpy()
    ref = g["tp_fwd/logits"]
    errs["tpddnet logits"] = (float(np.abs(logits - ref).max()),
                              max(1.0, float(np.abs(ref).max())))
    say("  golden 1x32^3 (JAX, CPU) vs the card: " + ", ".join(
        f"{k} {e:.3g} (scale {s:.3g})" for k, (e, s) in errs.items()))
    if any(e > 1e-4 * s for e, s in errs.values()):
        fail("registration / TPDDNet golden mismatch")


def _registration(torch, mods, workdir):
    """VNet3dRegistration (features 16) on a 1x128^3 pair: the forward
    through the kernels against the plain versions, its launches; the
    task's train steps, one against the plain versions; the
    ``trainregistration3d`` recipe for a few epochs (its loss falls).
    Returns the paths' launches."""
    wts = mods["zoo_weights"]["vnet3dregistration"]
    batch = _registration_pair(torch, mods)
    net = mods["build_model"]("vnet3dregistration", 0, features=REG_FEATURES)
    net.load_state_dict(wts[1](wts[0](SEED, REG_FEATURES)), strict=True)
    net = net.cuda().eval()
    args = [batch[k] for k in ("moving_image", "fixed_image", "moving_label")]
    reset_counts(mods)
    with torch.inference_mode():
        out = net(*args)
    launches = counts(mods)
    want = _forward_only(REG_TRAIN_LAUNCHES)
    if launches != want:
        fail(f"registration forward launches {launches} != {want}")
    with torch.inference_mode(), plain_kernels(mods):
        ref = net(*args)
    errs = {k: rel_err(a, b) for k, a, b in zip(("moved_image", "moved_label", "ddf"), out, ref)}
    agree = float((out[1] == ref[1]).float().mean())
    with torch.inference_mode():
        ms = time_ms(torch, lambda: net(*args), iters=5)
        with plain_kernels(mods):
            plain_ms = time_ms(torch, lambda: net(*args), iters=3)
    say(f"  registration forward 1x{AUG_DHW[0]}^3 features {REG_FEATURES}: launches "
        f"{ {k: v for k, v in launches.items() if v} }; kernels vs plain: moved image "
        f"{errs['moved_image'][0]:.3g} (scale {errs['moved_image'][1]:.3g}), ddf "
        f"{errs['ddf'][0]:.3g} (scale {errs['ddf'][1]:.3g}), moved label agreement "
        f"{agree:.7f}; ddf max |v| {out[2].abs().max().item():.3g} voxels; {ms:.3f} ms "
        f"(plain versions {plain_ms:.3f})")
    if any(errs[k][0] > 1e-4 * errs[k][1] for k in ("moved_image", "ddf")) or agree < 0.999:
        fail("registration forward kernels vs plain")
    paths = {"fwd_vnet3dregistration": launches}

    trainer = mods["make_registration_trainer"](
        example_shape=(1,) + AUG_DHW + (1,), seg_weight=0.5, model=net.train(),
        device="cuda")
    paths["train_vnet3dregistration"], reg_ms, reg_peak = _steps(
        torch, mods, trainer, batch, REG_TRAIN_LAUNCHES, "train_vnet3dregistration")
    _step_split(torch, mods, "train_vnet3dregistration", lambda: trainer.train_step(batch))

    gate_net = mods["build_model"]("vnet3dregistration", 0, features=REG_FEATURES)
    gate_net.load_state_dict(wts[1](wts[0](SEED, REG_FEATURES)), strict=True)
    gate_net = gate_net.cuda().train()

    def loss_and_grads(dtype, scale=1.0):
        gate_net.zero_grad(set_to_none=True)
        b = {k: v.to(dtype) for k, v in batch.items()}
        b["moving_image"] = b["moving_image"] * scale
        o = trainer.apply_fn(gate_net, b, True, mods["step_generator"](SEED, 0, "cuda"))
        loss = trainer.loss_fn(o, b)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in gate_net.named_parameters()}

    _kernel_step_gate(torch, mods, "train_vnet3dregistration", loss_and_grads)
    del gate_net, trainer, net

    # the recipe, as a user runs it: .npy pairs from a CSV, a few epochs
    pair_paths = []
    for key in ("moving_image", "fixed_image"):
        p = os.path.join(workdir, f"reg_{key}.npy")
        np.save(p, batch[key][0, ..., 0].cpu().numpy())
        pair_paths.append(p)
    csv_path = os.path.join(workdir, "reg.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["moving_image", "fixed_image"])
        writer.writerow(pair_paths)
    reset_counts(mods)
    t0 = time.perf_counter()
    history = mods["recipes"].trainregistration3d(csv_path, csv_path,
                                                  os.path.join(workdir, "reg_run"), 8)
    torch.cuda.synchronize()
    paths["recipe_trainregistration3d"] = counts(mods)
    losses = history["train_loss"]
    say(f"  trainregistration3d: 8 epochs of 1 step in {time.perf_counter() - t0:.2f} s, "
        f"train loss {[round(v, 5) for v in losses]}, validation dice "
        f"{[round(v, 4) for v in history['valdation_accuracy']]}")
    # the loss falls: the last three epochs' mean under the first epoch's
    # (dropout 0.2 makes single steps noisy)
    if not np.mean(losses[-3:]) < losses[0] or not all(np.isfinite(losses)):
        fail(f"trainregistration3d's loss did not fall: {losses}")
    return paths, reg_ms, reg_peak


def _tpddnet(torch, mods):
    """TPDDNet (2 classes) on 1x1x128^3: the eval forward through the
    kernels against the plain versions, its launches; segmentation train
    steps (MutilDiceLoss with the aux heads), one against the plain
    versions.  Returns the paths' launches."""
    wts = mods["zoo_weights"]["tpddnet"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x = torch.randn((1,) + AUG_DHW + (1,), generator=gen, device="cuda")
    d, h, w = AUG_DHW
    zz, yy, xx = np.ogrid[:d, :h, :w]
    label = ((zz - 60) / 30.0) ** 2 + ((yy - 70) / 25.0) ** 2 + ((xx - 64) / 35.0) ** 2 < 1
    label = torch.from_numpy(label.astype(np.int32))[None].cuda()
    x = x + 0.5 * label[..., None]

    def fresh():
        net = mods["build_model"]("tpddnet", TP_CLASSES)
        net.load_state_dict(wts[1](wts[0](SEED, TP_CLASSES)), strict=True)
        return net.cuda()

    net = fresh().eval()
    reset_counts(mods)
    with torch.inference_mode():
        probs = net(x)[1]
    launches = counts(mods)
    want = _forward_only(TP_TRAIN_LAUNCHES)
    if launches != want:
        fail(f"TPDDNet forward launches {launches} != {want}")
    with torch.inference_mode(), plain_kernels(mods):
        ref = net(x)[1]
    agree, bad, err = _masks_agree(torch, probs, ref, 1e-3)
    with torch.inference_mode():
        ms = time_ms(torch, lambda: net(x)[1].argmax(-1), iters=5)
        with plain_kernels(mods):
            plain_ms = time_ms(torch, lambda: net(x)[1].argmax(-1), iters=3)
    say(f"  TPDDNet forward 1x{d}^3, {TP_CLASSES} classes: launches "
        f"{ {k: v for k, v in launches.items() if v} }; kernels vs plain: probs max_abs_err "
        f"{err:.3g}, argmax agreement {agree:.7f}, mismatches outside near-ties {bad}; "
        f"{ms:.3f} ms (plain versions {plain_ms:.3f})")
    if agree < 0.999:
        fail("TPDDNet forward kernels vs plain")
    paths = {"fwd_tpddnet": launches}
    del net

    batch = {"image": x, "label": label}
    trainer = mods["make_segmentation_trainer"](fresh(), TP_CLASSES, "MutilDiceLoss",
                                                alpha=[1.0] * TP_CLASSES, device="cuda")
    paths["train_tpddnet"], tp_ms, tp_peak = _steps(torch, mods, trainer, batch,
                                                    TP_TRAIN_LAUNCHES, "train_tpddnet")
    _step_split(torch, mods, "train_tpddnet", lambda: trainer.train_step(batch))
    gate_net = fresh().train()

    def loss_and_grads(dtype, scale=1.0):
        gate_net.zero_grad(set_to_none=True)
        o = trainer.apply_fn(gate_net, x.to(dtype) * scale, True,
                             mods["step_generator"](SEED, 0, "cuda"))
        loss = trainer.loss_fn(o, batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in gate_net.named_parameters()}

    _kernel_step_gate(torch, mods, "train_tpddnet", loss_and_grads)
    return paths, tp_ms, tp_peak


def phase_augreg(torch, mods, workdir):
    """Phase 10: online and offline augmentation, the registration path and
    TPDDNet.  Returns {path: launches}."""
    t_phase = time.perf_counter()
    paths = _augmentation(torch, mods, workdir)
    _regtp_golden(torch, mods)
    reg_paths, reg_ms, reg_peak = _registration(torch, mods, workdir)
    paths.update(reg_paths)
    tp_paths, tp_ms, tp_peak = _tpddnet(torch, mods)
    paths.update(tp_paths)
    say(f"  step times ({mods['smi']}): registration {reg_ms:.3f} ms, peak {reg_peak:.2f} "
        f"GiB; TPDDNet {tp_ms:.3f} ms, peak {tp_peak:.2f} GiB")
    say(f"  phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------------- phase 11
SEG2D_HW, SEG2D_BATCH = (512, 512), 8
CLS2D_HW, CLS2D_BATCH, CLS2D_CLASSES = (28, 28), 64, 10
CLS3D_DHW, CLS3D_BATCH, CLS3D_CLASSES = (96, 96, 96), 2, 2
GAN_HW, GAN_BATCH = (256, 256), 4
# one forward's kernel launches (each way in a train step): K1 at every
# GroupNorm / InstanceNorm call, K2 at ResNet3d's 3^3 LUConvs of 32 and 64
# channels (2D convs run on cuDNN)
MODEL_API_FORWARD = {"seg_unet2d": (0, 18), "seg_vnet2d": (0, 34), "cls_resnet2d": (0, 17),
                     "cls_resnet3d": (5, 17)}
MODEL_API_GOLDEN_TOL = 1e-4
SEG2D_PATHS = (("seg_unet2d", "BinaryUNet2dModel", "BinaryCrossEntropyDiceLoss", 1),
               ("seg_vnet2d", "MutilVNet2dModel", "MutilDiceLoss", 2))


def _slices_2d(rng, n: int, hw, classes: int):
    """``n`` synthetic 2D slices: (uint8 image, uint8 mask) pairs, bright
    discs on a smooth background, the mask the discs (0/255 for one class,
    labels 0/1 for two)."""
    h, w = hw
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = []
    for _ in range(n):
        inside = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            r = rng.uniform(0.06, 0.15) * min(h, w)
            inside |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img = 60 + 40 * np.sin(xx / (w / 3.0)) * np.cos(yy / (h / 4.0)) + 110 * inside
        img = np.clip(img + rng.normal(0, 8, (h, w)), 0, 255).astype(np.uint8)
        out.append((img, (inside * (255 if classes == 1 else 1)).astype(np.uint8)))
    return out


def _write_slices(io_image, root: str, tag: str, pairs) -> tuple:
    images, masks = [], []
    for i, (img, mask) in enumerate(pairs):
        images.append(io_image.imwrite(os.path.join(root, f"{tag}_img{i}.png"), img))
        masks.append(io_image.imwrite(os.path.join(root, f"{tag}_mask{i}.png"), mask))
    return images, masks


def _timed_step(torch, mods, fn, what: str, steps: int = 5) -> dict:
    """A train step's ms (min and median of ``steps`` by CUDA events after a
    warmup), device ms by family and busy share (``torch.profiler``), peak
    memory."""
    fn()
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    split, wall = mods["traced_split"](fn, 2)
    fams = kernel_families(split)
    device_ms, busy_wall = mods["traced_busy"](fn)
    _, peak = _peak(torch, fn)
    out = {"step_ms_min": min(times), "step_ms_median": float(np.median(times)),
           "device_ms": sum(split.values()), "families": fams,
           "busy": device_ms / busy_wall, "peak_gib": peak}
    say(f"  {what} step ({mods['smi']}): {out['step_ms_min']:.3f} / "
        f"{out['step_ms_median']:.3f} ms min / median, device {out['device_ms']:.3f} ms "
        f"{json.dumps(fams)}, busy {out['busy']:.3f}, peak {peak:.2f} GiB")
    return out


def _forward_launches(torch, mods, fn, path: str) -> None:
    """One eval forward's K2 and K1 launches against MODEL_API_FORWARD."""
    reset_counts(mods)
    fn()
    torch.cuda.synchronize()
    c = counts(mods)
    got = (c["conv3d_small"], c["fused_group_norm_relu"])
    say(f"  {path} forward launches: K2 {got[0]}, K1 {got[1]}")
    if got != MODEL_API_FORWARD[path]:
        fail(f"{path}: forward launches K2, K1 {got}, expected {MODEL_API_FORWARD[path]}")


def _train_launches(mods, path: str) -> dict:
    """The launches of a trainprocess run (the counts set to 0 just before
    it): K1 each way on every path, K2 on ResNet3d's and on no 2D path."""
    c = counts(mods)
    say(f"  {path} trainprocess launches: {json.dumps({k: v for k, v in c.items() if v})}")
    if c["fused_group_norm_relu"] == 0 or c["fused_group_norm_relu_bwd"] == 0:
        fail(f"{path}: K1 was not launched each way")
    k2 = c["conv3d_small"] + c["conv3d_small_dx"] + c["conv3d_small_dw"]
    if (k2 > 0) != path.endswith("3d"):
        fail(f"{path}: K2 launches {k2} (2D convs run cuDNN; ResNet3d's LUConvs K2)")
    return c


def _model_api_seg2d(torch, mods, workdir, compat, io_image) -> dict:
    """BinaryUNet2dModel and MutilVNet2dModel at 512^2, batch 8: trainprocess
    (2 steps + validation) from PNG files, launches, a timed step,
    ``predict``'s launches and ``inference`` on a 600 x 480 image."""
    rng = np.random.default_rng(SEED + 11)
    paths = {}
    for path, cls_name, loss, classes in SEG2D_PATHS:
        train = _write_slices(io_image, workdir, f"{path}_t",
                              _slices_2d(rng, 2 * SEG2D_BATCH, SEG2D_HW, classes))
        val = _write_slices(io_image, workdir, f"{path}_v",
                            _slices_2d(rng, SEG2D_BATCH, SEG2D_HW, classes))
        model = getattr(compat, cls_name)(*SEG2D_HW, 1, classes, SEG2D_BATCH, loss)
        reset_counts(mods)
        t0 = time.perf_counter()
        hist = model.trainprocess(*train, *val, os.path.join(workdir, path), epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        paths[path] = _train_launches(mods, path)
        if not all(np.isfinite(hist[k][0]) for k in hist):
            fail(f"{path}: history not finite: {hist}")
        say(f"  {path}: trainprocess 2 steps + validation in {fit_s:.2f} s, history "
            f"{json.dumps({k: round(v[0], 5) for k, v in hist.items()})}")
        trainer = model.trainer
        batch = trainer._put(next(iter(model._dataloader(*train, shuffle=False))))
        _timed_step(torch, mods, lambda: trainer.train_step(batch), path)
        model.model.eval()
        img = io_image.imread(val[0][0], 0).astype(np.float32)
        chw = ((img - img.mean()) / (img.std() or 1.0))[None]
        _forward_launches(torch, mods, lambda: model.predict(chw), path)
        big = io_image.resize(img, (600, 480))
        t0 = time.perf_counter()
        mask = model.inference(big)
        inf_ms = (time.perf_counter() - t0) * 1e3
        if mask.shape != (600, 480) or mask.dtype != np.uint8 or mask.max() >= max(2, classes):
            fail(f"{path}: inference mask {mask.shape} {mask.dtype} max {mask.max()}")
        say(f"  {path}: inference of a 600x480 image {inf_ms:.1f} ms, labels "
            f"{sorted(np.unique(mask).tolist())}")
    return paths


def _model_api_classify(torch, mods, workdir, compat, io_image) -> dict:
    """MutilResNet2dModel (28^2, 10 classes, batch 64) and
    MutilResNet3dModel (96^3, 2 classes, batch 2): trainprocess 2 steps +
    validation, launches, a timed step, ``predict`` and
    ``Grad_CAM_Visual``."""
    rng = np.random.default_rng(SEED + 12)
    paths = {}
    imgs = [io_image.imwrite(os.path.join(workdir, f"cls{i}.png"),
                             rng.integers(0, 256, CLS2D_HW, dtype=np.uint8))
            for i in range(3 * CLS2D_BATCH)]
    labels = rng.integers(0, CLS2D_CLASSES, len(imgs)).tolist()
    vols = []
    for i in range(3 * CLS3D_BATCH):
        vols.append(os.path.join(workdir, f"cls3d{i}.npy"))
        np.save(vols[-1], rng.standard_normal(CLS3D_DHW).astype(np.float32))
    cases = (("cls_resnet2d", compat.MutilResNet2dModel(*CLS2D_HW, 1, CLS2D_CLASSES,
                                                        CLS2D_BATCH, "MutilCrossEntropyLoss"),
              imgs, labels, 2 * CLS2D_BATCH, (1,) + CLS2D_HW),
             ("cls_resnet3d", compat.MutilResNet3dModel(*CLS3D_DHW, 1, CLS3D_CLASSES,
                                                        CLS3D_BATCH, "MutilCrossEntropyLoss"),
              vols, [i % CLS3D_CLASSES for i in range(len(vols))], 2 * CLS3D_BATCH,
              (1,) + CLS3D_DHW))
    for path, model, x, y, n, shape in cases:
        reset_counts(mods)
        hist = model.trainprocess(x[:n], y[:n], x[n:], y[n:], os.path.join(workdir, path),
                                  epochs=1)
        torch.cuda.synchronize()
        paths[path] = _train_launches(mods, path)
        if not np.isfinite(hist["train_loss"][0]):
            fail(f"{path}: loss {hist}")
        trainer = model.trainer
        batch = trainer._put(next(iter(model._dataloader(x[:n], y[:n], shuffle=False))))
        _timed_step(torch, mods, lambda: trainer.train_step(batch), path)
        img = rng.standard_normal(shape).astype(np.float32)
        _forward_launches(torch, mods, lambda: model.predict(img), path)
        label, probs = model.predict(img)
        cam = model.Grad_CAM_Visual(img)
        if cam.shape != shape[1:] or not (0 <= cam.min() and cam.max() <= 1 + 1e-6):
            fail(f"{path}: Grad-CAM {cam.shape} [{cam.min()}, {cam.max()}]")
        say(f"  {path}: predict {label} (p {float(np.max(probs)):.4f}), Grad-CAM "
            f"{cam.shape} max {cam.max():.3f}, history "
            f"{json.dumps({k: round(v[0], 5) for k, v in hist.items()})}")
    return paths


def _model_api_gan(torch, mods, workdir, compat, io_image) -> dict:
    """Pixel2PixelGAN2dModel (256^2, batch 4, features 16 / 32): trainprocess
    2 steps + validation, launches, a timed step, ``inference``."""
    rng = np.random.default_rng(SEED + 13)
    pairs = _slices_2d(rng, 3 * GAN_BATCH, GAN_HW, 1)
    imgs = [io_image.imwrite(os.path.join(workdir, f"gan_in{i}.png"), a)
            for i, (a, _) in enumerate(pairs)]
    tgts = [io_image.imwrite(os.path.join(workdir, f"gan_tgt{i}.png"),
                             np.clip(255 - a.astype(int) // 2 + m // 4, 0, 255).astype(np.uint8))
            for i, (a, m) in enumerate(pairs)]
    model = compat.Pixel2PixelGAN2dModel(*GAN_HW, 1, 1, batch_size=GAN_BATCH)
    n = 2 * GAN_BATCH
    reset_counts(mods)
    hist = model.trainprocess(imgs[:n], tgts[:n], imgs[n:], tgts[n:],
                              os.path.join(workdir, "gan"), epochs=1)
    torch.cuda.synchronize()
    launches = _train_launches(mods, "gan_pix2pix")
    if not all(np.isfinite(v[0]) for v in hist.values()):
        fail(f"GAN history {hist}")
    trainer = model.trainer
    batch = trainer._put(next(iter(model._dataloader(imgs[:n], tgts[:n], shuffle=False))))
    _timed_step(torch, mods, lambda: trainer.train_step(batch), "gan_pix2pix")
    out = model.inference(io_image.resize(io_image.imread(imgs[-1], 0).astype(np.float32),
                                          (240, 200)))
    if out.shape != (240, 200) or not np.isfinite(out).all():
        fail(f"GAN inference {out.shape}")
    say(f"  gan_pix2pix: history {json.dumps({k: round(v[0], 4) for k, v in hist.items()})}, "
        f"inference {out.shape} range [{out.min():.1f}, {out.max():.1f}]")
    return {"gan_pix2pix": launches}


def _model_api_norm_rows(torch, mods) -> dict:
    """K1 at the 2D paths' shapes, f32, each held to its plain version and
    timed beside ``F.group_norm``: UNet2d's 18 GroupNorm(8)+ReLU calls at
    8 x 512^2 (a forward's, and a backward's each), and the discriminator's
    six affine-free InstanceNorms (groups = C, no ReLU) at 4 x 128^2 x 32
    ... 4 x 4^2 x 1024 for a 256^2 input."""
    fused_norm = mods["fused_norm"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows = {"fused_group_norm_relu": [], "fused_group_norm_relu_bwd": []}
    n = SEG2D_BATCH
    cases = [(n, 512 >> lvl, 16 << lvl, 8, True, uses)
             for lvl, uses in ((0, 4), (1, 4), (2, 4), (3, 4), (4, 2))]
    cases += [(GAN_BATCH, 128 >> i, 32 << i, 32 << i, False, 1) for i in range(6)]
    for n_, side, c, groups, relu, uses in cases:
        x = torch.randn((n_, side, side, c), generator=gen, device="cuda") * 2 + 0.5
        gamma = torch.randn(c, generator=gen, device="cuda") if relu else torch.ones(
            c, device="cuda")
        beta = torch.randn(c, generator=gen, device="cuda") if relu else torch.zeros(
            c, device="cuda")
        g = torch.randn(x.shape, generator=gen, device="cuda")
        if relu:  # no element at the ReLU's kink, where rounding picks the side
            g = _off_the_kink(torch, x, gamma, beta, g)
        what = f"{'GN8+ReLU' if relu else 'InstanceNorm'} C{c} @{n_}x{side}^2"

        def fwd():
            return fused_norm.fused_group_norm_relu(x, gamma, beta, groups, 1e-6, relu)

        def fwd_plain():
            return fused_norm.fused_group_norm_relu_plain(x, gamma, beta, groups, 1e-6, relu)

        got, ref = fwd(), fwd_plain()
        ms, plain_ms = time_pair(torch, fwd, fwd_plain)
        xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
        gl, bl = (t.detach().clone().requires_grad_() for t in (gamma, beta))
        library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
            xl.detach(), groups, gl.detach(), bl.detach(), 1e-6))
        yl = torch.nn.functional.group_norm(xl, groups, gl, bl, 1e-6)
        g_lib = g.permute(0, 3, 1, 2).contiguous()
        library_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, gl, bl), g_lib, retain_graph=True))
        del xl, gl, bl, yl, g_lib
        n_el = x.numel()
        _check_row(rows, "fused_group_norm_relu", "float32", what, *rel_err(got, ref), ms,
                   plain_ms, uses, bound_ms(10.0 * n_el, 2 * n_el * 4, "float32"),
                   library_ms, " (F.group_norm, no ReLU)")
        _, stats = fused_norm._launch(x, gamma, beta, groups, 1e-6, relu)

        def bwd():
            return fused_norm._launch_backward(x, g, stats, gamma, beta, groups, relu)

        def bwd_plain():
            return fused_norm.fused_group_norm_relu_backward_plain(
                x, gamma, beta, g, groups, 1e-6, relu)

        got, ref = bwd(), bwd_plain()
        err, scale = max((rel_err(a, b) for a, b in zip(got, ref)), key=lambda e: e[0] / e[1])
        ms, plain_ms = time_pair(torch, bwd, bwd_plain)
        _check_row(rows, "fused_group_norm_relu_bwd", "float32", what + " (dx, dgamma, dbeta)",
                   err, scale, ms, plain_ms, uses,
                   bound_ms(20.0 * n_el, 3 * n_el * 4, "float32"), library_bwd_ms,
                   " (F.group_norm's autograd backward)")
        del x, g
    return rows


def _model_api_golden(torch, mods, compat, golden) -> None:
    """The golden file's JAX outputs on the card, f32, TF32 off: UNet2d,
    VNet2d, ResNet2d / 3d logits (float64 JAX, within 1e-4 of their
    scale), the ResNet2d Grad-CAM (1e-4), one GAN step (G loss 1e-5, D
    loss 1e-3 of their scale; gradients no farther from JAX's float64 step
    than twice JAX's own f32 step, nor than 4x the port's own f32 step on
    the CPU: the step is ill-conditioned, so JAX's f32 distance is loose,
    while a bfloat16 step on the CPU lies an order of magnitude or more
    beyond the port's f32 one), and the committed tpuseg run directory read by
    MutilUNet2dModel (its logits 1e-4) and serving an image."""
    from tpuseg_torch.tasks.gan import GANTrainer
    from tpuseg_torch.tools.gradcam import grad_cam

    ref = golden.load()
    for case in golden.FORWARDS:
        net = golden.port_nets(case)["net"].cuda().eval()
        with torch.no_grad():
            out = net(torch.from_numpy(golden.inputs(case)["x"]).cuda())
        logits = (out if case.startswith("resnet") else out[0]).double().cpu()
        err, scale = rel_err(logits, torch.from_numpy(ref[f"{case}/logits"]))
        say(f"  golden {case}: logits max_abs_err {err:.3g} (scale {scale:.3g})")
        if err > MODEL_API_GOLDEN_TOL * scale:
            fail(f"golden {case}: {err} > {MODEL_API_GOLDEN_TOL} * {scale}")
    cam = grad_cam(golden.port_nets("resnet2d")["net"].cuda(),
                   golden.inputs("resnet2d")["x"][:1])
    cam_err = float(np.abs(cam - ref["resnet2d/cam"]).max())
    say(f"  golden resnet2d Grad-CAM: max_abs_err {cam_err:.3g}")
    if cam_err > MODEL_API_GOLDEN_TOL:
        fail(f"golden Grad-CAM error {cam_err}")
    nets, gin = golden.port_nets("gan"), golden.inputs("gan")

    def gan_step(device):
        trainer = GANTrainer(1, 1, golden.F, device=device, dropout=0.0, d_features=golden.F)
        trainer.generator.load_state_dict(nets["g"].state_dict())
        trainer.discriminator.load_state_dict(nets["d"].state_dict())
        m = trainer.train_step({k: torch.from_numpy(gin[v]).to(device)
                                for k, v in (("image", "x"), ("target", "target"))})
        return trainer, m

    trainer, m = gan_step("cuda")
    cpu_trainer, _ = gan_step("cpu")
    for key, tol in (("g_loss", 1e-5), ("d_loss", 1e-3)):
        want = float(ref[f"gan/{key}"])
        err = abs(float(m[key]) - want)
        say(f"  golden GAN {key}: {float(m[key]):.7f} vs JAX f64 {want:.7f} (JAX f32 "
            f"{float(ref[f'gan/{key}_f32']):.7f})")
        if err > tol * max(1.0, abs(want)):
            fail(f"golden GAN {key}: error {err}")
    for tag in ("g", "d"):
        want = {k.split("/", 2)[2]: v for k, v in ref.items() if k.startswith(f"gan/{tag}_grad/")}
        dist, cpu_dist = (golden.grad_distance(
            {n: p.grad.double().cpu().numpy() for n, p in getattr(
                t, "generator" if tag == "g" else "discriminator").named_parameters()}, want)
            for t in (trainer, cpu_trainer))
        jax_own = float(ref[f"gan/{tag}_f32_distance"])
        say(f"  golden GAN {tag} gradients: distance from JAX's f64 step {dist:.4g} "
            f"(the port's f32 step on the CPU {cpu_dist:.4g}, JAX's own f32 step "
            f"{jax_own:.4g})")
        if dist > min(2 * jax_own, 4 * cpu_dist):
            fail(f"golden GAN {tag} gradients: {dist} > min(2 * {jax_own}, 4 * {cpu_dist})")
    model = compat.MutilUNet2dModel(32, 32, 1, 2, 1, inference=True, model_path=golden.RUN_DIR,
                                    features=golden.F)
    with torch.no_grad():
        logits = model.model(torch.from_numpy(golden.inputs("unet2d")["x"]).cuda())[0]
    err, scale = rel_err(logits.double().cpu(), torch.from_numpy(ref["unet2d/logits"]))
    mask = model.inference(np.linspace(0, 255, 45 * 50, dtype=np.float32).reshape(45, 50))
    say(f"  tpuseg run directory {os.path.relpath(golden.RUN_DIR, ROOT)}: logits "
        f"max_abs_err {err:.3g} (scale {scale:.3g}), served mask {mask.shape}")
    if err > MODEL_API_GOLDEN_TOL * scale or mask.shape != (45, 50):
        fail(f"tpuseg run directory: error {err}, mask {mask.shape}")


def phase_model_api(torch, mods, workdir):
    """Phase 11: the 2D segmentation classes, the classifiers with Grad-CAM,
    pix2pix and a tpuseg run directory.  Returns ({path: launches},
    {kernel: K1 rows at the 2D shapes}, {(kernel, dtype): ResNet3d's K2
    and K1 rows})."""
    from tpuseg_torch import compat
    from tpuseg_torch.io_native import image as io_image

    t_phase = time.perf_counter()
    _model_api_golden(torch, mods, compat, mods["model_api_golden"])
    norm_rows = _model_api_norm_rows(torch, mods)
    f = FEATURES
    resnet3d_rows = batch_kernel_rows(
        torch, mods, CLS3D_BATCH,
        ([(2 * f, 2 * f, (48,) * 3, 2), (4 * f, 4 * f, (24,) * 3, 3)],
         [(f, (96,) * 3, 2), (2 * f, (48,) * 3, 3), (4 * f, (24,) * 3, 4),
          (8 * f, (12,) * 3, 4), (16 * f, (6,) * 3, 4)], []),
        ("float32",), "resnet3d")
    paths = _model_api_seg2d(torch, mods, workdir, compat, io_image)
    paths.update(_model_api_classify(torch, mods, workdir, compat, io_image))
    paths.update(_model_api_gan(torch, mods, workdir, compat, io_image))
    say(f"  phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return paths, norm_rows, resnet3d_rows


# phase 12: the recipes' sizes ((x, y, z) of their prepared volumes: KiPA's
# UNet3d and the V-Net recipe's (d, h, w) 176x112x80), the 2D augmenter's
# BMP pairs, the 2D MLP nets at 512^2, batch 8, with K1's launches a
# forward (UNeXt2d: 3 stems with the ReLU, 4 decoder stages without;
# AmlpUNet2d: its 3 decoder blocks' 2 norms)
RECIPE_VNET_XYZ, RECIPE_VNET_CLASSES = (80, 112, 176), 16
AUG2D_HW, AUG2D_PAIRS, AUG2D_COPIES = (512, 512), 4, 3
MLP2D_HW, MLP2D_BATCH, MLP2D_CLASSES = (512, 512), 8, 2
MLP2D_NETS = {"unext2d": ("unext2d", 7), "amlp_unet2d": ("amlpunet2d", 6)}
# an image of inferencemutilvnet2d: one VNet2d forward (phase 11's)
FOLDER_VNET2D_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES},
                              fused_group_norm_relu=MODEL_API_FORWARD["seg_vnet2d"][1])


@contextlib.contextmanager
def _watch_trainer_class(mods, record: list, first: dict):
    """Record the launches of every train/eval step of any ``Trainer`` (the
    ones a recipe builds inside); ``first`` gets the trainer and the batch
    of the first train step."""
    trainer_cls = mods["Trainer"]
    saved = {k: getattr(trainer_cls, k) for k in ("train_step", "eval_step")}

    def watch(kind, step):
        def watched(self, batch):
            if kind == "train_step" and not first:
                first.update(trainer=self, batch=batch)
            c0 = counts(mods)
            out = step(self, batch)
            record.append((kind, delta(counts(mods), c0)))
            return out
        return watched

    for kind, step in saved.items():
        setattr(trainer_cls, kind, watch(kind, step))
    try:
        yield
    finally:
        for kind, step in saved.items():
            setattr(trainer_cls, kind, step)


def _label_ct(vol, rng):
    """A label volume of a ``synthetic_ct`` volume: its two organs, its bone
    column and an ellipsoid, labels 1-4, with the CT's geometry."""
    hu = vol.array.astype(np.float32)
    label = np.zeros(hu.shape, np.uint8)
    label[(hu > 90) & (hu < 150)] = 1
    label[(hu >= 150) & (hu < 300)] = 2
    label[hu >= 500] = 3
    d, h, w = hu.shape
    zz, yy, xx = np.ogrid[:d, :h, :w]
    cz, cy, cx = rng.uniform(0.3, 0.7, 3) * (d, h, w)
    label[((zz - cz) / (d / 6)) ** 2 + ((yy - cy) / (h / 8)) ** 2
          + ((xx - cx) / (w / 8)) ** 2 < 1] = 4
    out = type(vol)(label)
    out.copy_geometry_from(vol)
    return out


def _split_manifest(csv_path: str, n_train: int) -> tuple:
    """A prepared manifest split into train (the first ``n_train`` rows)
    and validation manifests."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    out = []
    for name, part in (("train", rows[1:1 + n_train]), ("val", rows[1 + n_train:])):
        path = csv_path.replace(".csv", f"_{name}.csv")
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows([rows[0]] + part)
        out.append(path)
    return tuple(out)


def _recipe_training(torch, mods, recipe, manifests, model_dir, expect: dict, tag: str):
    """One epoch of a training recipe with counts from 0: every step's
    launches, finite history, checkpoints.  Returns (the path's launches,
    {"trainer", "batch"} of its first train step)."""
    record, first = [], {}
    reset_counts(mods)
    t0 = time.perf_counter()
    with _watch_trainer_class(mods, record, first):
        history = recipe(*manifests, model_dir, epochs=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts(mods)
    for kind, got in record:
        want = expect if kind == "train_step" else _forward_only(expect)
        if got != want:
            fail(f"{tag} {kind} launches {got} != {want}")
    kinds = [k for k, _ in record]
    if kinds.count("train_step") != 2 or kinds.count("eval_step") != 1:
        fail(f"{tag} steps {kinds}")
    if not all(np.isfinite(history["train_loss"] + history["valdation_loss"])):
        fail(f"{tag} non-finite history {history}")
    if not os.path.isfile(os.path.join(model_dir, "best", "state.pt")):
        fail(f"{tag}: no best checkpoint")
    say(f"  {tag}: 1 epoch (2 steps + validation) in {run_s:.2f} s, history "
        f"{json.dumps({k: round(v[0], 5) for k, v in history.items()})}; launches per train "
        f"step { {k: v for k, v in expect.items() if v} } on every step")
    return launches, first


def _trainer_step_gate(torch, mods, tag: str, trainer, net, batch) -> None:
    """``_kernel_step_gate`` of one step of ``trainer``'s apply and loss on
    ``batch``, each dtype's step through a fresh copy of ``net`` cast to
    that dtype (torch's LayerNorm takes no parameters of another dtype than
    its input's)."""
    import copy

    def loss_and_grads(dtype, scale=1.0):
        model = copy.deepcopy(net).to(dtype).train()
        model.zero_grad(set_to_none=True)
        o = trainer.apply_fn(model, batch["image"].to(dtype) * scale, True,
                             mods["step_generator"](SEED, 0, "cuda"))
        loss = trainer.loss_fn(o, batch)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    _kernel_step_gate(torch, mods, tag, loss_and_grads)


def _folder_inference(torch, mods, fn, per_input: dict, n: int, tag: str) -> dict:
    """``fn()`` (a folder inference over ``n`` volumes or images) with counts
    from 0: ``per_input`` launches each.  Returns the launches."""
    reset_counts(mods)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = counts(mods)
    want = {k: v * n for k, v in per_input.items()}
    if got != want:
        fail(f"{tag}: launches {got} != {want} ({n} x {per_input})")
    say(f"  {tag}: {n} inputs in {run_s:.2f} s, launches per input "
        f"{ {k: v for k, v in per_input.items() if v} }")
    return got


def _recipes_and_inference(torch, mods, workdir):
    """Data preparation, the 3D training recipes and the folder inferences.
    Returns ({path: launches}, the KiPA train / validation manifests)."""
    dataprep, recipes, inference = mods["dataprep"], mods["recipes"], mods["inference"]
    rng = np.random.default_rng(SEED + 12)
    src = os.path.join(workdir, "nifti")
    os.makedirs(src)
    images, masks = [], []
    for i, size in enumerate(REQUEST_SIZES):
        vol = mods["synthetic_ct"](size, rng)
        images.append(os.path.join(src, f"case{i}.nii.gz"))
        masks.append(os.path.join(workdir, f"case{i}_mask.nii.gz"))
        mods["write_nifti"](vol, images[-1])
        mods["write_nifti"](_label_ct(vol, rng), masks[-1])
    t0 = time.perf_counter()
    unet_csv = dataprep.prepare_sampling_3d(images, masks, os.path.join(workdir, "kipa"),
                                            NEW_SIZE)
    vnet_csv = dataprep.prepare_sampling_3d(images, masks, os.path.join(workdir, "amos"),
                                            RECIPE_VNET_XYZ)
    prep_s = time.perf_counter() - t0
    arr = np.load(os.path.join(workdir, "kipa", "case_0000_img.npy"))
    lab = np.load(os.path.join(workdir, "amos", "case_0000_msk.npy"))
    if arr.shape != NEW_SIZE[::-1] or lab.shape != RECIPE_VNET_XYZ[::-1] or lab.max() != 4:
        fail(f"prepare_sampling_3d: {arr.shape}, {lab.shape}, labels {np.unique(lab)}")
    say(f"  prepare_sampling_3d: 3 cases at two sizes in {prep_s:.2f} s; z-scored image "
        f"mean {arr.mean():.4f}, std {arr.std():.4f}")
    paths = {}
    run_u, run_v = os.path.join(workdir, "run_unet3d"), os.path.join(workdir, "run_vnet3d")
    unet_manifests = _split_manifest(unet_csv, 2)
    paths["recipe_unet3d"] = _recipe_training(
        torch, mods, recipes.trainmutilunet3d, unet_manifests, run_u, TRAIN_LAUNCHES,
        "recipe_unet3d")[0]
    paths["recipe_vnet3d"], first = _recipe_training(
        torch, mods, recipes.trainmutilvnet3d, _split_manifest(vnet_csv, 2), run_v,
        VNET_TRAIN_LAUNCHES, "recipe_vnet3d")
    # the recipe's own net and first batch: K1 and K2 at its extents
    _trainer_step_gate(torch, mods, "recipe_vnet3d", first["trainer"], first["trainer"].model,
                       first["batch"])
    del first

    folder = os.path.join(workdir, "folder")
    os.makedirs(folder)
    for i in (0, 1):
        shutil.copy(images[i], folder)
    out_u = os.path.join(workdir, "masks_unet3d")
    argv = ["--infer.model_dir", run_u, "--model.num_classes", str(CLASSES),
            "--model.features", str(FEATURES), "--infer.new_size",
            json.dumps(list(NEW_SIZE)), folder, out_u]
    paths["folder_unet3d"] = _folder_inference(
        torch, mods, lambda: inference.main(argv), EXPECTED_LAUNCHES, 2, "folder_unet3d")
    ref_model = mods["MutilUNet3dModel"](NEW_SIZE[2], NEW_SIZE[1], NEW_SIZE[0], 1, CLASSES,
                                         inference=True, model_path=run_u)
    for i in (0, 1):
        got = mods["read_nifti"](os.path.join(out_u, f"case{i}_mask.nii.gz"))
        vol = mods["read_nifti"](images[i])
        with plain_kernels(mods), unpacked(ref_model):
            ref = ref_model.inference(vol, NEW_SIZE).array
        agree = float((got.array == ref).mean())
        say(f"  folder_unet3d case{i}: labels {sorted(np.unique(got.array).tolist())}, "
            f"agreement with the plain net through the plain versions {agree:.6f}")
        if got.array.shape != vol.array.shape or not agree >= 0.999:
            fail(f"folder_unet3d case{i}: shape {got.array.shape}, agreement {agree}")
    out_v = os.path.join(workdir, "masks_vnet3d")
    paths["folder_vnet3d"] = _folder_inference(
        torch, mods, lambda: recipes.inferencemutilvnet3d(run_v, folder, out_v),
        SWIN_VNET_LAUNCHES, 2, "folder_vnet3d")
    # the recipe serves (d, h, w) 80x112x176: the transpose of its training size
    ref_model = mods["MutilVNet3dModel"](*RECIPE_VNET_XYZ, 1, RECIPE_VNET_CLASSES,
                                         inference=True, model_path=run_v)
    for i in (0, 1):
        got = mods["read_nifti"](os.path.join(out_v, f"case{i}_mask.nii.gz")).array
        with plain_kernels(mods), unpacked(ref_model):
            ref = ref_model.inference(mods["read_nifti"](images[i]),
                                      RECIPE_VNET_XYZ[::-1]).array
        agree = float((got == ref).mean())
        say(f"  folder_vnet3d case{i}: labels {sorted(np.unique(got).tolist())}, agreement "
            f"with the net through the plain versions {agree:.6f}")
        if got.shape != REQUEST_SIZES[i][::-1] or not agree >= 0.999:
            fail(f"folder_vnet3d case{i}: shape {got.shape}, agreement {agree}")
    del ref_model

    io_image = mods["io_image"]
    pngs = [io_image.imwrite(os.path.join(workdir, f"slice{i}.png"), img)
            for i, (img, _) in enumerate(_slices_2d(rng, 2, AUG2D_HW, 2))]
    png_csv = os.path.join(workdir, "slices.csv")
    with open(png_csv, "w", newline="") as f:
        csv.writer(f).writerows([("Image", "Mask")] + [(p, p) for p in pngs])
    net = mods["VNet"](2, features=FEATURES, ndim=2)
    net.load_state_dict(mods["vnet_params_from_jax"](
        mods["seeded_vnet_params"](SEED, FEATURES, 2, 1, ndim=2)), strict=True)
    pth = os.path.join(workdir, "vnet2d.pth")
    torch.save(net.state_dict(), pth)
    out_2d = os.path.join(workdir, "masks_vnet2d")
    paths["folder_vnet2d"] = _folder_inference(
        torch, mods, lambda: recipes.inferencemutilvnet2d(pth, png_csv, out_2d),
        FOLDER_VNET2D_LAUNCHES, 2, "folder_vnet2d")
    for i in (0, 1):
        mask = io_image.imread(os.path.join(out_2d, f"{i}.png"), 0)
        if mask.shape != AUG2D_HW or mask.max() > 1:
            fail(f"inferencemutilvnet2d mask {i}: {mask.shape}, max {mask.max()}")
    return paths, unet_manifests


def _augment2d(torch, mods, workdir) -> None:
    """``run_offline`` on the card against the CPU, same seed."""
    io_image, augment2d = mods["io_image"], mods["augment2d"]
    rng = np.random.default_rng(SEED + 13)
    rows = []
    for i, (img, mask) in enumerate(_slices_2d(rng, AUG2D_PAIRS, AUG2D_HW, 1)):
        rows.append((io_image.imwrite(os.path.join(workdir, f"aug{i}.bmp"), img),
                     io_image.imwrite(os.path.join(workdir, f"aug{i}_mask.bmp"), mask)))
    manifest = os.path.join(workdir, "aug.csv")
    with open(manifest, "w", newline="") as f:
        csv.writer(f).writerows([("Image", "Mask")] + rows)
    times, dirs = {}, {}
    for device in ("cuda", "cpu"):
        dirs[device] = os.path.join(workdir, f"aug_{device}")
        aug = augment2d.SegmentationAug2D(seed=SEED, p_blur=0.6, device=device)
        t0 = time.perf_counter()
        aug.run_offline(manifest, dirs[device], AUG2D_COPIES)
        torch.cuda.synchronize()
        times[device] = time.perf_counter() - t0
    names = sorted(os.listdir(dirs["cpu"]))
    if names != sorted(os.listdir(dirs["cuda"])) or len(names) != 2 * AUG2D_PAIRS * AUG2D_COPIES + 1:
        fail(f"augment2d: files {names}")
    exact = total = 0
    for name in names:
        if not name.endswith(".bmp"):
            continue
        a = io_image.imread(os.path.join(dirs["cuda"], name), 0)
        b = io_image.imread(os.path.join(dirs["cpu"], name), 0)
        diff = np.abs(a.astype(int) - b)
        if diff.max() > (0 if name.endswith("_mask.bmp") else 1):
            fail(f"augment2d: card and CPU differ by {diff.max()} in {name}")
        if not name.endswith("_mask.bmp"):
            exact += int((diff == 0).sum())
            total += diff.size
    n = AUG2D_PAIRS * AUG2D_COPIES
    say(f"  SegmentationAug2D.run_offline: {n} copies of {AUG2D_HW[0]}x{AUG2D_HW[1]} pairs, "
        f"card {times['cuda'] * 1e3 / n:.2f} ms a copy, CPU {times['cpu'] * 1e3 / n:.2f} ms "
        f"(file reads and writes included); masks equal, images exact on "
        f"{exact / total:.6f} of pixels and within one gray level on all")


def _profile_flag(torch, mods, manifests, workdir) -> None:
    """``--train.profile true``: the trace of three steps before the fit
    names K1's and K2's kernels."""
    train, parse_cli = mods["train"], mods["parse_cli"]
    model_dir = os.path.join(workdir, "run_profile")
    cfg = parse_cli(["--train.profile", "true", "--data.train_csv", manifests[0],
                     "--data.val_csv", manifests[1], "--data.image_size",
                     json.dumps(list(NEW_SIZE)), "--model.num_classes", str(CLASSES),
                     "--train.epochs", "1", "--train.model_dir", model_dir])
    trainer, tl, vl = train.build(cfg, device="cuda")
    t0 = time.perf_counter()
    history = train.run(cfg, trainer, tl, vl)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    path = os.path.join(model_dir, "trace", "trace.json")
    if not os.path.isfile(path):
        fail("--train.profile wrote no trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k2 = sorted(k for k in kernels if "conv3d_" in k)
    k1 = sorted(k for k in kernels if "gn_" in k)
    if not k1 or not k2 or trainer.step != 4 + 2 or not np.isfinite(history["train_loss"][0]):
        fail(f"--train.profile: K1 {k1}, K2 {k2}, step {trainer.step}, history {history}")
    say(f"  --train.profile: a trace of 3 steps ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
        f"{len(kernels)} kernel names), then 1 epoch, in {run_s:.2f} s; K1 kernels "
        f"{[k[:40] for k in k1]}, K2 kernels {[k[:40] for k in k2]}")


def _mlp2d_golden(torch, mods) -> None:
    """The nets on the card against the golden file's JAX f32 logits."""
    gen = mods["mlp2d_golden"]
    golden = gen.load()
    for net in gen.CASES:
        model = gen.port_net(net).cuda()
        x = torch.from_numpy(gen.inputs(net)["image"]).cuda()
        with torch.no_grad():
            logits = model(x)[0].cpu().numpy()
        ref = golden[f"{net}/logits"]
        err, scale = float(np.abs(logits - ref).max()), float(np.abs(ref).max())
        say(f"  {net} on the card vs the golden JAX logits {ref.shape}: max_abs_err "
            f"{err:.3g} (scale {scale:.3g})")
        if not err <= 1e-4 * scale:
            fail(f"{net}: golden logits error {err} > 1e-4 x {scale}")


def _mlp2d(torch, mods) -> dict:
    """UNeXt2d and AmlpUNet2d at 512^2, batch 8: the kernels' step against
    the plain versions' f64 step, three steps' launches, a timed step."""
    rng = np.random.default_rng(SEED + 14)
    pairs = _slices_2d(rng, MLP2D_BATCH, MLP2D_HW, MLP2D_CLASSES)
    images = np.stack([(p[0] - p[0].mean()) / p[0].std() for p in pairs])[..., None]
    host = {"image": images.astype(np.float32),
            "label": np.stack([p[1] for p in pairs]).astype(np.int32)}
    paths = {}
    for tag, (name, k1) in MLP2D_NETS.items():
        model = mods["build_model"](name, MLP2D_CLASSES,
                                    generator=torch.Generator().manual_seed(SEED))
        trainer = mods["make_segmentation_trainer"](
            model, MLP2D_CLASSES, "MutilDiceLoss", alpha=[1.0] * MLP2D_CLASSES,
            config=mods["TrainerConfig"](optimizer="adamw"), device="cuda")
        batch = trainer._put(host)
        _trainer_step_gate(torch, mods, tag, trainer, model, batch)
        expect = dict({k: 0 for k in EXPECTED_LAUNCHES}, fused_group_norm_relu=k1,
                      fused_group_norm_relu_bwd=k1)
        paths[tag], _, _ = _steps(torch, mods, trainer, batch, expect, tag)
        _timed_step(torch, mods, lambda: trainer.train_step(batch), tag)
        del trainer, model, batch
        torch.cuda.empty_cache()
    return paths


def phase_entry_points(torch, mods, workdir) -> dict:
    """Phase 12: data preparation, the 3D recipes, folder inference, the 2D
    augmenter, ``--train.profile`` and the 2D MLP nets.  Returns {path:
    launches}."""
    t_phase = time.perf_counter()
    paths, unet_manifests = _recipes_and_inference(torch, mods, workdir)
    _augment2d(torch, mods, workdir)
    _profile_flag(torch, mods, unet_manifests, workdir)
    _mlp2d_golden(torch, mods)
    paths.update(_mlp2d(torch, mods))
    say(f"  phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 13: the attention zoo at its published widths, f32: smt_t (15
# classes) on 1x1x128^3 (the reference's smoke input,
# networks/smt.py:415-424), one eval forward of smt_s, smt_b and smt_l
# there, and VSNet's defaults (feature_size 24) on 1x1x96^3
# (networks/VSNet.py:1066-1079).  A forward's launches (each way in a train
# step), (K2, K1): smt_t K2 the stem's 32 -> 64 conv, enc1's two 64 -> 64 and
# dec0's second, K1 the stem's norm (with the ReLU), the CA blocks' (5;
# smt_s 16, smt_b and smt_l 24) and the 14 UNETR norms; smt_l (embed 96)
# has no conv in K2's range.  VSNet: K2 its six UNETR convs at 24-48
# channels, K1 its 8 encoder, 8 decoder and 9 gate norms (3 over one channel)
ATTN_SMT_DHW, ATTN_SMT_CLASSES = (128, 128, 128), 15
ATTN_VSNET_DHW = (96, 96, 96)
ATTN_FORWARD = {"smt": (4, 20), "smt_s": (4, 31), "smt_b": (4, 39), "smt_l": (0, 39),
                "vsnet": (6, 25)}


def _attn_golden(torch, mods) -> None:
    """Both nets on the card against the golden file's JAX f32 outputs
    (16^3, small widths)."""
    gen = mods["attn_golden"]
    golden = gen.load()
    for net in gen.CASES:
        model = gen.port_net(net).cuda()
        with torch.no_grad():
            out = model(torch.from_numpy(gen.inputs(net)["image"]).cuda())
        pairs = [(out[0], golden[f"{net}/logits"])] + [
            (a, golden[f"{net}/aux{i}"]) for i, a in enumerate(out[2] if len(out) == 3 else ())]
        worst = max(float(np.abs(a.cpu().numpy() - r).max()) / float(np.abs(r).max())
                    for a, r in pairs)
        say(f"  {net} on the card vs the golden JAX outputs (16^3, {len(pairs)} heads): "
            f"max_abs_err over the scale {worst:.3g}")
        if not worst <= 1e-4:
            fail(f"{net}: golden outputs error {worst} > 1e-4 of the scale")


def _attn_batch(torch, net: str, dhw, classes: int) -> dict:
    """A seeded batch on the card: blob labels (8^3 blocks of random
    classes), an image that shows them; VSNet's also a regression target
    (the foreground) and an edge label (its boundary)."""
    rng = np.random.default_rng(SEED + 13)
    blocks = rng.integers(0, classes, (8, 8, 8))
    label = blocks.repeat(dhw[0] // 8, 0).repeat(dhw[1] // 8, 1).repeat(dhw[2] // 8, 2)
    image = (rng.standard_normal(dhw) + label / classes).astype(np.float32)
    batch = {"image": image[None, ..., None], "label": label[None].astype(np.int32)}
    if net == "vsnet":
        fg = label > 0
        edge = np.zeros_like(fg)
        for axis in range(3):
            edge |= fg != np.roll(fg, 1, axis)
        batch["reg_target"] = fg[None, ..., None].astype(np.float32)
        batch["edge_label"] = (edge & fg)[None].astype(np.int32)
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@contextlib.contextmanager
def _record_kernel_shapes(mods, record: dict):
    """Record the K2 (x shape, weight shape) and K1 (x shape, groups, ReLU)
    of every call the models make, with its count."""
    layers = mods["layers"]
    conv, norm = layers.conv3d_small, layers.fused_group_norm_relu

    def conv_rec(x, w, *a):
        key = ("conv3d_small", tuple(x.shape), tuple(w.shape))
        record[key] = record.get(key, 0) + 1
        return conv(x, w, *a)

    def norm_rec(x, gamma, beta, groups=8, eps=1e-6, relu=True):
        key = ("fused_group_norm_relu", tuple(x.shape), groups, relu)
        record[key] = record.get(key, 0) + 1
        return norm(x, gamma, beta, groups, eps, relu=relu)

    layers.conv3d_small, layers.fused_group_norm_relu = conv_rec, norm_rec
    try:
        yield
    finally:
        layers.conv3d_small, layers.fused_group_norm_relu = conv, norm


def _attn_forward(torch, mods, tag: str, model, x) -> dict:
    """One eval forward with counts from 0 against ATTN_FORWARD, its K1 / K2
    shapes recorded; probabilities against the same net through the plain
    versions (within 1e-4, masks equal outside near-ties: phase 8's rule);
    kernels' and plain versions' ms, each of one call after the checked one
    (the presets' forwards take up to 1.3 s).  Returns (launches, {shape
    key: uses})."""
    shapes = {}
    reset_counts(mods)
    with torch.inference_mode(), _record_kernel_shapes(mods, shapes):
        probs = model(x)[1]
    launches = counts(mods)
    got = (launches["conv3d_small"], launches["fused_group_norm_relu"])
    if got != ATTN_FORWARD[tag] or sum(launches.values()) != sum(got):
        fail(f"{tag} forward launches {launches}, expected K2, K1 {ATTN_FORWARD[tag]}")
    with torch.inference_mode(), plain_kernels(mods):
        ref = model(x)[1]
    agree, bad, err = _masks_agree(torch, probs, ref, 1e-4)
    with torch.inference_mode():
        ms = time_ms(torch, lambda: model(x)[1].argmax(-1), iters=1, warmup=0)
        with plain_kernels(mods):
            plain_ms = time_ms(torch, lambda: model(x)[1].argmax(-1), iters=1, warmup=0)
    say(f"  {tag} forward {'x'.join(map(str, x.shape[1:4]))}: K2 {got[0]}, K1 {got[1]}; "
        f"kernels vs plain: probs max_abs_err {err:.3g}, mask agreement {agree:.7f}, "
        f"mismatches outside near-ties {bad}; {ms:.3f} ms (plain versions {plain_ms:.3f}), "
        f"{mods['smi']}")
    if bad or not err <= 1e-4 or not torch.isfinite(probs).all():
        fail(f"{tag} forward kernels vs plain")
    return launches, shapes


def _attn_kernel_rows(torch, mods, shapes: dict, rows: dict, dw_drift: dict) -> None:
    """K2 (forward, dX, dW) and K1 (forward, backward) at the shapes one
    forward handed them, f32, against their plain versions and timed (uses:
    a forward's calls; K2 3 calls a turn: cuDNN's fp32 wgrad takes 0.6 s
    at 24 -> 48 on 96^3); K2 dW's signed mean error over its rms against
    the float64 plain dW."""
    conv3d, fused_norm = mods["conv3d"], mods["fused_norm"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for key, uses in sorted(shapes.items(), key=str):
        if key[0] == "conv3d_small":
            xs, ws = key[1], key[2]
            cin, cout = ws[3], ws[4]
            vox = int(np.prod(xs[:4]))
            x = torch.randn(xs, generator=gen, device="cuda")
            g = torch.randn(xs[:4] + (cout,), generator=gen, device="cuda")
            wt = torch.randn(ws, generator=gen, device="cuda") * (2.0 / (27 * cin)) ** 0.5
            bound = bound_ms(2.0 * 27 * cin * cout * vox, (cin + cout) * vox * 4
                             + 27 * cin * cout * 4, "tf32x3")
            what = f"{cin}->{cout} @{'x'.join(map(str, xs[1:4]))}"
            packed, packed_t = conv3d.pack_weight(wt, torch.float32), conv3d.pack_weight_t(
                wt, torch.float32)
            for name, fn, plain, label in (
                    ("conv3d_small", lambda: conv3d.conv3d_small(x, wt, packed),
                     lambda: conv3d.conv3d_small_plain(x, wt), what),
                    ("conv3d_small_dx", lambda: conv3d._launch_dx(g, packed_t, cin),
                     lambda: conv3d.conv3d_small_dx_plain(g, wt), what + " dX"),
                    ("conv3d_small_dw", lambda: conv3d._launch_dw(x, g),
                     lambda: conv3d.conv3d_small_dw_plain(x, g), what + " dW")):
                got, ref = fn(), plain()
                torch.cuda.synchronize()
                ms, plain_ms = time_pair(torch, fn, plain, iters=3)
                _check_row(rows, name, "float32", "attention " + label, *rel_err(got, ref),
                           ms, plain_ms, uses, bound, plain_ms)
            ref64 = conv3d.conv3d_small_dw_plain(x.double(), g.double())
            dw = conv3d._launch_dw(x, g).double()
            dw_drift[what] = float((dw - ref64).mean() / ref64.pow(2).mean().sqrt())
        else:
            xs, groups, relu = key[1], key[2], key[3]
            c, n_el = xs[-1], int(np.prod(xs))
            x = torch.randn(xs, generator=gen, device="cuda") * 2 + 0.5
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            g = torch.randn(xs, generator=gen, device="cuda")
            if relu:
                g = _off_the_kink(torch, x, gamma, beta, g, groups)
            what = (f"attention C{c} groups {groups}{' ReLU' if relu else ''} "
                    f"@{'x'.join(map(str, xs[1:-1]))}")
            xl = x.movedim(-1, 1).contiguous().requires_grad_()
            gl, bl = gamma.detach().requires_grad_(), beta.detach().requires_grad_()
            lib_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl.detach(), groups, gamma, beta, 1e-6))
            yl = torch.nn.functional.group_norm(xl, groups, gl, bl, 1e-6)
            g_lib = g.movedim(-1, 1).contiguous()
            lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, gl, bl), g_lib, retain_graph=True))
            del xl, gl, bl, yl, g_lib

            def fwd():
                return fused_norm.fused_group_norm_relu(x, gamma, beta, groups, 1e-6, relu)

            def fwd_plain():
                return fused_norm.fused_group_norm_relu_plain(x, gamma, beta, groups, 1e-6,
                                                              relu)

            got, ref = fwd(), fwd_plain()
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, fwd, fwd_plain)
            _check_row(rows, "fused_group_norm_relu", "float32", what, *rel_err(got, ref), ms,
                       plain_ms, uses, bound_ms(10.0 * n_el, 2 * n_el * 4, "float32"), lib_ms,
                       " (F.group_norm)")
            _, stats = fused_norm._launch(x, gamma, beta, groups, 1e-6, relu)

            def bwd():
                return fused_norm._launch_backward(x, g, stats, gamma, beta, groups, relu)

            def bwd_plain():
                return fused_norm.fused_group_norm_relu_backward_plain(
                    x, gamma, beta, g, groups, 1e-6, relu)

            got, ref = bwd(), bwd_plain()
            torch.cuda.synchronize()
            err, scale = max((rel_err(a, b) for a, b in zip(got, ref)),
                             key=lambda e: e[0] / e[1])
            ms, plain_ms = time_pair(torch, bwd, bwd_plain)
            _check_row(rows, "fused_group_norm_relu_bwd", "float32",
                       what + " (dx, dgamma, dbeta)", err, scale, ms, plain_ms, uses,
                       bound_ms(20.0 * n_el, 3 * n_el * 4, "float32"), lib_bwd_ms,
                       " (F.group_norm's autograd backward)")


def _attn_train(torch, mods, tag: str, trainer, batch) -> dict:
    """The kernels' f32 step against the plain versions' f64 step (phase
    10's gate), three steps with each step's launches checked, a timed
    step, its longest kernels and cuDNN's conv backward by shape.  Returns
    the steps' launches."""
    _trainer_step_gate(torch, mods, f"train_{tag}", trainer, trainer.model, batch)
    k2, k1 = ATTN_FORWARD[tag]
    launches, _, _ = _steps(torch, mods, trainer, batch, _zoo_step(k2, k1), f"train_{tag}")
    _timed_step(torch, mods, lambda: trainer.train_step(batch), f"train_{tag}", steps=3)
    _step_split(torch, mods, f"train_{tag}", lambda: trainer.train_step(batch))
    return launches


def phase_attention(torch, mods):
    """Phase 13: SMT (smt_t forward and steps, smt_s / smt_b / smt_l
    forwards) at 128^3 and VSNet at 96^3, f32.  Returns ({path: launches},
    {kernel: rows at the attention nets' shapes})."""
    t_phase = time.perf_counter()
    _attn_golden(torch, mods)
    paths, shapes, dw_drift = {}, {}, {}
    rows = {k: [] for k in ("conv3d_small", "conv3d_small_dx", "conv3d_small_dw",
                            "fused_group_norm_relu", "fused_group_norm_relu_bwd")}
    cpu_gen = torch.Generator().manual_seed(SEED)

    smt = mods["smt_presets"]["smt_t"](ATTN_SMT_CLASSES, generator=cpu_gen)
    batch = _attn_batch(torch, "smt", ATTN_SMT_DHW, ATTN_SMT_CLASSES)
    trainer = mods["make_segmentation_trainer"](
        smt, ATTN_SMT_CLASSES, "MutilDiceLoss", alpha=[1.0] * ATTN_SMT_CLASSES,
        config=mods["TrainerConfig"](optimizer="adam", lr=1e-3), device="cuda")
    paths["fwd_smt"], shapes["smt"] = _attn_forward(torch, mods, "smt", smt.eval(),
                                                    batch["image"])
    paths["train_smt"] = _attn_train(torch, mods, "smt", trainer, batch)
    x = batch["image"]
    del trainer, smt, batch
    torch.cuda.empty_cache()
    laps = {"smt_t": time.perf_counter() - t_phase}
    for tag in ("smt_s", "smt_b", "smt_l"):
        model = mods["smt_presets"][tag](ATTN_SMT_CLASSES, generator=cpu_gen).cuda().eval()
        (paths[f"fwd_{tag}"], _), peak = _peak(torch, lambda: _attn_forward(
            torch, mods, tag, model, x))
        say(f"  {tag}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
            f"peak {peak:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    del x
    laps["smt_s/b/l"] = time.perf_counter() - t_phase - sum(laps.values())

    trainer = mods["make_vsnet_trainer"]((1,) + ATTN_VSNET_DHW + (1,), feature_size=24,
                                         device="cuda", seed=SEED)
    batch = _attn_batch(torch, "vsnet", ATTN_VSNET_DHW, 3)
    paths["fwd_vsnet"], shapes["vsnet"] = _attn_forward(torch, mods, "vsnet",
                                                        trainer.model.eval(), batch["image"])
    paths["train_vsnet"] = _attn_train(torch, mods, "vsnet", trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    laps["vsnet"] = time.perf_counter() - t_phase - sum(laps.values())

    merged = {}
    for s in shapes.values():
        for k, v in s.items():
            merged[k] = merged.get(k, 0) + v
    _attn_kernel_rows(torch, mods, merged, rows, dw_drift)
    say(f"  K2 f32 dW signed mean error over its rms at the attention nets' shapes: "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in dw_drift.items()})} (phase 3's "
        f"level-0 shapes: the ROADMAP precision note)")
    laps["kernel rows"] = time.perf_counter() - t_phase - sum(laps.values())
    say(f"  phase 13 in {time.perf_counter() - t_phase:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in laps.items())})")
    return paths, rows


# ---------------------------------------------------------------------------
# phase 14: parallelism (2 ranks on the one card over gloo)
# ---------------------------------------------------------------------------

# the phase's world: 2 processes on the one card, gloo (NCCL refuses two
# ranks on one device), each naming cuda:0; its volumes (d, h, w)
PAR_WORLD = 2
PAR_DHW = (128, 112, 112)  # UNet3d: z split 64 + 64
PAR_VNET_DHW = (96, 96, 96)  # VNet3d: 48 + 48
# per rank and step (the z-sharded twins; K1 split's own counters): the
# plain UNet3d's 10 K2 convs and 18 GroupNorms, the packed twin's K3 3 / 4
# / 4, K2 7, the VNet3d's K2 11 and GroupNorms 34
PAR_UNET_LAUNCHES = {"conv3d_small": 10, "conv3d_small_dx": 10, "conv3d_small_dw": 10,
                     "fused_group_norm_relu": 0, "fused_group_norm_relu_bwd": 0,
                     "fused_group_norm_relu_split": 18, "fused_group_norm_relu_split_bwd": 18}
PAR_PACKED_LAUNCHES = dict(PAR_UNET_LAUNCHES, conv3d_small=7, conv3d_small_dx=7,
                           conv3d_small_dw=7, packed_conv3d_structured=3,
                           packed_conv3d_structured_dx=4, packed_conv3d_structured_dw=4,
                           stem_dw_gemm=1)
PAR_VNET_LAUNCHES = dict(PAR_UNET_LAUNCHES, conv3d_small=11, conv3d_small_dx=11,
                         conv3d_small_dw=11, fused_group_norm_relu_split=34,
                         fused_group_norm_relu_split_bwd=34)
# K1 split held against its plain version on a rank's shard (C, groups)
PAR_SPLIT_CASES = ((16, 8), (64, 8))


def split_counts(mods) -> dict:
    fn = mods["fused_norm"]
    return dict(counts(mods), fused_group_norm_relu_split=fn.SPLIT_LAUNCHES,
                fused_group_norm_relu_split_bwd=fn.SPLIT_BWD_LAUNCHES)


def _par_mods():
    """The modules a rank of phase 14 takes (no build: the library is the
    parent's)."""
    sys.path.insert(0, ROOT)
    from tpuseg_torch.compat.weights import (seeded_unet_params, seeded_vnet_params,
                                             unet_params_from_jax, vnet_params_from_jax)
    from tpuseg_torch.core import checkpoint, distributed
    from tpuseg_torch.core.mesh import MeshContext, make_mesh
    from tpuseg_torch.core.prng import step_generator
    from tpuseg_torch.kernels import conv3d, flat_conv, fused_norm, packed_conv, slab_conv
    from tpuseg_torch.models import vnet_packed
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.nn import layers
    from tpuseg_torch.parallel import pipeline, spatial
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    return dict(conv3d=conv3d, fused_norm=fused_norm, packed_conv=packed_conv,
                vnet_packed=vnet_packed, slab_conv=slab_conv, flat_conv=flat_conv,
                layers=layers, UNet=UNet, VNet=VNet, seeded_unet_params=seeded_unet_params,
                unet_params_from_jax=unet_params_from_jax, seeded_vnet_params=seeded_vnet_params,
                vnet_params_from_jax=vnet_params_from_jax, checkpoint=checkpoint,
                distributed=distributed, MeshContext=MeshContext, make_mesh=make_mesh,
                step_generator=step_generator, pipeline=pipeline, spatial=spatial,
                make_segmentation_trainer=make_segmentation_trainer,
                TrainerConfig=TrainerConfig)


def _par_net(torch, mods, kind: str, dropout: float = 0.2):
    """The seeded UNet3d (features 16, 5 classes) or VNet3d (2 classes) on
    the card."""
    if kind == "vnet":
        net = mods["VNet"](VNET_CLASSES, features=FEATURES, dropout=dropout)
        net.load_state_dict(mods["vnet_params_from_jax"](
            mods["seeded_vnet_params"](SEED, FEATURES, VNET_CLASSES, 1)), strict=True)
    else:
        net = mods["UNet"](CLASSES, features=FEATURES, dropout=dropout)
        net.load_state_dict(mods["unet_params_from_jax"](
            mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1)), strict=True)
    return net.cuda()


def _par_batch(kind: str, n: int = 1) -> dict:
    """A seeded host batch: the UNet3d's (5 classes) or the VNet3d's (2)."""
    dhw, k = (PAR_VNET_DHW, VNET_CLASSES) if kind == "vnet" else (PAR_DHW, CLASSES)
    rng = np.random.default_rng(SEED + 14)
    image = rng.standard_normal((n,) + dhw + (1,)).astype(np.float32)
    zz = np.arange(dhw[0])[:, None, None] // (dhw[0] // k)
    label = np.broadcast_to(np.minimum(zz, k - 1), dhw)[None].repeat(n, 0).astype(np.int64)
    return {"image": image, "label": label}


def _par_loss_grads(torch, mods, trainer, net, batch, dtype):
    """One step's loss and global gradients (summed over the (data, space)
    ranks) of ``trainer``'s apply and loss on its part of ``batch``, the
    weights unchanged, with step 0's dropout generator (folded with the data
    index on a data axis above one, as the trainer's steps are)."""
    from tpuseg_torch.core.mesh import DATA_AXIS, SPACE_AXIS

    net.train()
    net.zero_grad(set_to_none=True)
    b = trainer._put(trainer.shard_batch(batch))
    gen = mods["step_generator"](trainer._dropout_seed(), 0, "cuda")
    out = trainer.apply_fn(net, b["image"].to(dtype), True, gen)
    out = {k: v.float() for k, v in out.items()}
    loss = trainer.loss_fn(out, b)
    loss.backward()
    if trainer.mesh is not None:
        mods["spatial"].sum_grads_(net.parameters(), trainer.mesh.group(DATA_AXIS, SPACE_AXIS))
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


def _par_timed(torch, trainer, batch, n: int = 3) -> float:
    """Min ms of ``n`` train steps on this rank's part of ``batch``."""
    b = trainer._put(trainer.shard_batch(batch))
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms)


def _par_counted(torch, mods, fn):
    """fn()'s result and the launches it made (counters from 0)."""
    reset_counts(mods)
    mods["fused_norm"].SPLIT_LAUNCHES = mods["fused_norm"].SPLIT_BWD_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, split_counts(mods)


def _par_split_rows(torch, mods, group) -> list:
    """K1 split on this rank's shard against its plain version (the JAX
    formula with the same collectives), forward and backward, and times:
    the call on the 2-rank line (its gather staged through the host by
    gloo), the same call on a line of one (kernels only), the plain
    version and F.group_norm of the shard."""
    from tpuseg_torch.core.distributed import SOLO

    fn = mods["fused_norm"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140 + group.index)
    shared = torch.Generator(device="cuda").manual_seed(SEED + 140)  # the parameters'
    rows = []
    d, h, w = PAR_DHW[0] // PAR_WORLD, PAR_DHW[1], PAR_DHW[2]
    for c, groups in PAR_SPLIT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((1, d, h, w, c), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=shared, device="cuda")
            beta = torch.randn(c, generator=shared, device="cuda")
            g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            # g zero where the whole map's GroupNorm output lies within 1e-3
            # of the ReLU kink (``_off_the_kink``, with the global statistics)
            v = fn.fused_group_norm_relu_split_plain(x.double(), gamma.double(), beta.double(),
                                                     groups, 1e-6, False, group)
            g = g * (v.abs() > 1e-3).to(dtype)
            got = fn.fused_group_norm_relu_split(x, gamma, beta, groups, 1e-6, True, group)
            ref = fn.fused_group_norm_relu_split_plain(x, gamma, beta, groups, 1e-6, True, group)
            err = rel_err(got, ref)
            y, stats = fn._launch_split(x, gamma, beta, groups, 1e-6, True, group)
            got_b = fn._launch_split_backward(x, g, stats, gamma, beta, groups, True, group)
            ref_b = fn.fused_group_norm_relu_split_backward_plain(x, gamma, beta, g, groups,
                                                                  1e-6, True, group)
            err_b = max((rel_err(a, b) for a, b in zip(got_b, ref_b)),
                        key=lambda e: e[0] / e[1])
            ms = time_ms(torch, lambda: fn._launch_split(x, gamma, beta, groups, 1e-6, True,
                                                         group), iters=5)
            ms_b = time_ms(torch, lambda: fn._launch_split_backward(
                x, g, stats, gamma, beta, groups, True, group), iters=5)
            ms1 = time_ms(torch, lambda: fn._launch_split(x, gamma, beta, groups, 1e-6, True,
                                                          SOLO))
            ms1_b = time_ms(torch, lambda: fn._launch_split_backward(
                x, g, stats, gamma, beta, groups, True, SOLO))
            plain_ms = time_ms(torch, lambda: fn.fused_group_norm_relu_split_plain(
                x, gamma, beta, groups, 1e-6, True, group), iters=5)
            plain_b = time_ms(torch, lambda: fn.fused_group_norm_relu_split_backward_plain(
                x, gamma, beta, g, groups, 1e-6, True, group), iters=5)
            xl = x.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
            gl, bl = (t.to(dtype).detach().requires_grad_() for t in (gamma, beta))
            lib_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl.detach(), groups, gl.detach(), bl.detach(), 1e-6))
            yl = torch.nn.functional.group_norm(xl, groups, gl, bl, 1e-6)
            g_lib = g.permute(0, 4, 1, 2, 3).contiguous()
            lib_b = time_ms(torch, lambda: torch.autograd.grad(yl, (xl, gl, bl), g_lib,
                                                               retain_graph=True))
            n_el, size = x.numel(), x.element_size()
            dtype_name = "float32" if dtype == torch.float32 else "bfloat16"
            rows.append(dict(
                c=c, dtype=dtype_name, shape=list(x.shape), fwd_err=err, bwd_err=err_b,
                ms=ms1, ms_gloo=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound=bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name),
                bwd_ms=ms1_b, bwd_ms_gloo=ms_b, bwd_plain_ms=plain_b, bwd_library_ms=lib_b,
                bwd_bound=bound_ms(20.0 * n_el, 3 * n_el * size, dtype_name)))
    return rows


def _par_rank(torch, rank: int, workdir: str) -> dict:
    """Everything phase 14 runs on one rank of the 2-rank world."""
    from tpuseg_torch.core.mesh import DATA_AXIS, MODEL_AXIS, SPACE_AXIS

    mods = _par_mods()
    out = {}
    mc, mm = mods["MeshContext"], mods["make_mesh"]
    meshes = {"space": mm(data=1, space=PAR_WORLD, device="cuda:0"),
              "data": mm(data=PAR_WORLD, device="cuda:0"),
              "model": mm(data=1, model=PAR_WORLD, device="cuda:0")}
    cfg = mods["TrainerConfig"]

    def trainer(kind, mesh, dtype=torch.float32, packed=False, loss="MutilDiceLoss",
                dropout=0.2):
        net = _par_net(torch, mods, kind, dropout)
        k = VNET_CLASSES if kind == "vnet" else CLASSES
        tr = mods["make_segmentation_trainer"](
            net, k, loss, alpha=[1.0] * k, config=cfg(optimizer="adam", compute_dtype=dtype),
            device="cuda", packed_stem=packed, mesh=None if mesh is None else mc(mesh))
        return tr, tr.model

    # the z-sharded steps: loss, global gradients, launches, step ms
    unet_b, vnet_b = _par_batch("unet"), _par_batch("vnet")
    for tag, kind, dtype, packed, batch in (
            ("unet_f32", "unet", torch.float32, False, unet_b),
            ("unet_bf16", "unet", torch.bfloat16, False, unet_b),
            ("packed_f32", "unet", torch.float32, True, unet_b),
            ("vnet_f32", "vnet", torch.float32, False, vnet_b),
            ("vnet_bf16", "vnet", torch.bfloat16, False, vnet_b)):
        tr, net = trainer(kind, meshes["space"], dtype, packed)
        if tag == "vnet_f32":  # the eval forward at the seeded weights
            with torch.no_grad():
                net.eval()
                b = tr._put(tr.shard_batch(batch))
                probs = tr.apply_fn(net, b["image"], False, None)["probs"]
                parts = mods["distributed"].all_gather(probs.contiguous(),
                                                       meshes["space"].group(SPACE_AXIS))
                out["sp/vnet_fwd"] = torch.cat(list(parts.unbind(0)), dim=1).cpu()
        (loss, grads), launches = _par_counted(
            torch, mods, lambda: _par_loss_grads(torch, mods, tr, net, batch, dtype))
        out[f"sp/{tag}"] = dict(loss=loss, grads=grads if rank == 0 else None,
                                launches=launches, ms=_par_timed(torch, tr, batch))
        del tr, net
        torch.cuda.empty_cache()

    # data parallel: a batch of 2 on 2 ranks, a pooled and a gathered loss
    # (dropout off: each data rank draws its own masks)
    dp_b = _par_batch("unet", 2)
    for loss_name in ("MutilDiceLoss", "LovaszLoss"):
        for dtype in (torch.float32, torch.bfloat16):
            tr, net = trainer("unet", meshes["data"], dtype, loss=loss_name, dropout=0.0)
            loss, grads = _par_loss_grads(torch, mods, tr, net, dp_b, dtype)
            tag = f"dp/{loss_name}_{'f32' if dtype == torch.float32 else 'bf16'}"
            out[tag] = dict(loss=loss, grads=grads if rank == 0 else None,
                            ms=_par_timed(torch, tr, dp_b))
            del tr, net
            torch.cuda.empty_cache()

    # tensor parallel: model 2, the 256-channel bottleneck kernels sharded
    tr, net = trainer("unet", meshes["model"])
    loss, grads = _par_loss_grads(torch, mods, tr, net, unet_b, torch.float32)
    out["tp"] = dict(loss=loss, grads=grads, spec=dict(tr.tp_spec),
                     ms=_par_timed(torch, tr, unet_b))
    path = os.path.join(workdir, "tp_ckpt")
    tr._checkpoints(path).save_latest(tr.state_dict(), tr.step, 0.0, epoch=1)
    out["tp/ckpt"] = dict(path=os.path.join(path, "latest"),
                          model={k: v.cpu() for k, v in tr.state_dict()["model"].items()})
    del tr, net
    torch.cuda.empty_cache()

    # GPipe over the model axis, against the sequential reference
    gen = torch.Generator(device="cuda").manual_seed(SEED + 141)
    params = {"w": torch.randn((PAR_WORLD, 256, 256), generator=gen, device="cuda") * 0.06,
              "b": torch.randn((PAR_WORLD, 256), generator=gen, device="cuda") * 0.1}
    mb = torch.randn((8, 64, 256), generator=gen, device="cuda")

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    pipe = mods["pipeline"].pipeline_apply(stage_fn, params, mb,
                                           meshes["model"].group(MODEL_AXIS))
    seq = mods["pipeline"].sequential_reference(stage_fn, params, mb)
    out["pipe"] = rel_err(pipe, seq)

    # overlap-tile inference of a conv net (K2 inside), against the whole
    layers = mods["layers"]
    convs = [layers.ConvND(1, 16, 3), layers.ConvND(16, 16, 3), layers.ConvND(16, 2, 3)]
    torch.manual_seed(SEED)
    for c in convs:
        layers.he_normal_init_(c)
        c.cuda()

    @torch.no_grad()
    def conv_net(t):
        y = t[None].cuda()
        for i, c in enumerate(convs):
            y = c(y)
            y = torch.tanh(y) if i < len(convs) - 1 else y
        return y[0]

    vol = torch.from_numpy(unet_b["image"][0])
    reset_counts(mods)
    sharded = mods["spatial"].spatial_partition_infer(vol, conv_net,
                                                      meshes["space"].group(SPACE_AXIS),
                                                      margin=8, device="cuda")
    k2 = counts(mods)["conv3d_small"]
    out["infer"] = (rel_err(sharded, conv_net(vol)), k2)

    # K1 split against its plain version on the card, each rank's shard
    out["split_rows"] = _par_split_rows(torch, mods, meshes["space"].group(SPACE_AXIS))
    return out


def _par_child(rank: int, workdir: str, queue) -> None:
    """A rank of phase 14's world: gloo over a file store, cuda:0."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        sys.path.insert(0, ROOT)
        from tpuseg_torch.compat.seg_models import disable_tf32

        disable_tf32()
        dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                                world_size=PAR_WORLD)
        try:
            out = _par_rank(torch, rank, workdir)
        finally:
            dist.barrier()
            dist.destroy_process_group()
        # through a file: a tensor put on the queue would be shared by a
        # file descriptor that dies with this process
        path = os.path.join(workdir, f"rank{rank}.pt")
        torch.save(out, path)
        queue.put((rank, path, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def _spawn(target, args_of, n: int, timeout_s: float):
    """Run ``target(*args_of(i), queue)`` in ``n`` spawned processes; their
    results in rank order.  Any rank's failure fails the script."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args_of(i), q)) for i in range(n)]
    for p in procs:
        p.start()
    results, errors, done = [None] * n, [], set()
    t_end = time.monotonic() + timeout_s
    try:
        while len(done) < n and not errors:
            try:
                rank, out, err = q.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead or time.monotonic() > t_end:
                    errors.append(f"ranks {dead or 'all'} gave no result")
                continue
            done.add(rank)
            results[rank] = out
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        fail("phase 14: " + "\n".join(errors))
    return results


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_child(rank: int, world: int, port: int, queue) -> None:
    """torchrun's environment for ``world`` ranks on cuda:0, the NCCL
    backend, one all_reduce (and with world 1 one train step of the mesh
    path and K1 split on its one-rank line)."""
    import traceback

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        import torch
        import torch.distributed as dist

        sys.path.insert(0, ROOT)
        from tpuseg_torch.compat.seg_models import disable_tf32

        disable_tf32()
        mods = _par_mods()
        device = "cuda:0" if world > 1 else None
        _, n, dev = mods["distributed"].initialize("nccl", device=device)
        t = torch.ones(4, device=dev) * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out = {"backend": dist.get_backend(), "world": n, "sum": t[0].item()}
        if world == 1:
            mesh = mods["make_mesh"](device=dev)
            tr = mods["make_segmentation_trainer"](
                _par_net(torch, mods, "unet"), CLASSES, "MutilDiceLoss", alpha=[1.0] * CLASSES,
                config=mods["TrainerConfig"](optimizer="adam"), device=dev,
                mesh=mods["MeshContext"](mesh))
            out["ms"] = _par_timed(torch, tr, _par_batch("unet"))
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def _nccl_probe(torch, mods) -> dict:
    """NCCL on this card: two ranks on one device (expected refused), and
    one rank through torchrun's environment variables."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_nccl_child, args=(r, 2, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    outcome, t_end = [], time.monotonic() + 60
    for _ in range(2):
        try:
            rank, out, err = q.get(timeout=max(1.0, t_end - time.monotonic()))
            outcome.append(err.strip().splitlines()[-1] if err else f"rank {rank} {out}")
        except Exception:
            outcome.append("no answer within 60 s")
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    say(f"  NCCL, two ranks on one card: {outcome}")
    port = _free_port()
    one = _spawn(_nccl_child, lambda r: (r, 1, port), 1, 300)[0]
    if one["backend"] != "nccl" or one["sum"] != 1.0:
        fail(f"NCCL world 1: {one}")
    say(f"  NCCL world 1 through torchrun's variables: backend {one['backend']}, "
        f"all_reduce ok, mesh-path UNet3d f32 step {one['ms']:.3f} ms ({mods['smi']})")
    return {"two_ranks_one_card": outcome, "world1": one}


def _par_gate(torch, mods, tag: str, got, control, single) -> tuple:
    """``_kernel_step_gate``'s gate for a sharded step: ``got`` (loss,
    grads) of the sharded f32 step through the kernels, ``control`` a bf16
    one, ``single(dtype, scale)`` one process's step; the sharded step
    must lie within phase 6's gate of the f64 step through the plain
    versions, or no farther than twice the plain f32 step's distance from
    it (and from itself with the input scaled by 1 + 1e-7)."""
    def summary(errs):
        worst = max(errs, key=errs.get)
        return errs[worst], worst, float(np.median(list(errs.values())))

    with plain_kernels(mods):
        loss_ref, ref = single(torch.float64)
        grads_p = single(torch.float32)[1]
        own = summary(_param_errors(single(torch.float32, 1.0 + 1e-7)[1], grads_p))
    k, p, c = (summary(_param_errors(g, ref)) for g in (got[1], grads_p, control[1]))
    gate = (max(STEP_GRAD_TOL, 2 * max(p[0], own[0])), max(1e-3, 2 * max(p[2], own[2])))
    rel = abs(got[0] - loss_ref) / max(abs(loss_ref), 1e-12)
    say(f"  {tag} sharded step vs one process's f64 step (plain versions): loss "
        f"{got[0]:.7f} vs {loss_ref:.7f} (relative {rel:.3g}, tol 1e-5); grad error / "
        f"max(its max |g|, 1e-3 of the largest), worst and median: sharded {k[0]:.3g} "
        f"({k[1]}), {k[2]:.3g}; plain f32 {p[0]:.3g}, {p[2]:.3g}; gate {gate[0]:.3g}, "
        f"{gate[1]:.3g}; bf16 control {c[0]:.3g}, {c[2]:.3g}")
    if not rel <= 1e-5 or not k[0] <= gate[0] or not k[2] <= gate[1]:
        fail(f"{tag}: sharded step vs one process's step mismatch")
    if not (c[0] > gate[0] or c[2] > gate[1]):
        fail(f"{tag}: the gate does not tell a bf16 step from an f32 one")
    return k, gate


def _par_single(torch, mods, kind: str, batch: dict, loss_name: str = "MutilDiceLoss",
                dropout: float = 0.2):
    """fn(dtype, scale=1.0) -> (loss, grads) of one process's step at step
    0's dropout generator (the plain trainer's apply and loss; each result
    made once, under whichever kernel routing is on at its first call),
    and the process's f32 train step ms through the kernels."""
    import copy

    k = VNET_CLASSES if kind == "vnet" else CLASSES
    net = _par_net(torch, mods, kind, dropout)
    tr = mods["make_segmentation_trainer"](
        copy.deepcopy(net), k, loss_name, alpha=[1.0] * k,
        config=mods["TrainerConfig"](optimizer="adam"), device="cuda")
    b = tr._put(batch)
    made = {}

    def loss_and_grads(dtype, scale=1.0):
        if (dtype, scale) not in made:
            model = copy.deepcopy(net).to(dtype).train()
            o = tr.apply_fn(model, b["image"].to(dtype) * scale, True,
                            mods["step_generator"](SEED, 0, "cuda"))
            loss = tr.loss_fn({n: v.float() for n, v in o.items()}, b)
            loss.backward()
            made[(dtype, scale)] = (loss.item(), {n: p.grad.detach().cpu()
                                                  for n, p in model.named_parameters()})
        return made[(dtype, scale)]

    return loss_and_grads, _par_timed(torch, tr, batch)


def phase_parallel(torch, mods) -> tuple:
    """Phase 14: the parallel paths on 2 ranks on the one card (gloo), each
    step gated against one process's; returns (launches by path, the K1
    split rows)."""
    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_par_")
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        ranks = [torch.load(path, weights_only=False)
                 for path in _spawn(_par_child, lambda r: (r, workdir), PAR_WORLD, 900)]
        r0 = ranks[0]
        for r, res in enumerate(ranks):
            for tag, expect in (("unet_f32", PAR_UNET_LAUNCHES), ("unet_bf16", PAR_UNET_LAUNCHES),
                                ("packed_f32", PAR_PACKED_LAUNCHES),
                                ("vnet_f32", PAR_VNET_LAUNCHES), ("vnet_bf16", PAR_VNET_LAUNCHES)):
                got = res[f"sp/{tag}"]["launches"]
                if any(got.get(k, 0) != v for k, v in expect.items()):
                    fail(f"phase 14 rank {r} {tag} launches {got}, expected {expect}")
            if res["sp/unet_f32"]["loss"] != r0["sp/unet_f32"]["loss"]:
                fail("phase 14: the ranks' global losses differ")
        say(f"  launches per rank and step: UNet3d { {k: v for k, v in PAR_UNET_LAUNCHES.items() if v} }"
            f"; packed { {k: v for k, v in PAR_PACKED_LAUNCHES.items() if v} }; VNet3d "
            f"{ {k: v for k, v in PAR_VNET_LAUNCHES.items() if v} } on both ranks")
        for r, res in enumerate(ranks):
            say(f"  rank {r} step ms: " + ", ".join(
                f"{t} {res[f'sp/{t}']['ms']:.3f}" for t in
                ("unet_f32", "unet_bf16", "packed_f32", "vnet_f32", "vnet_bf16"))
                + ", " + ", ".join(f"{t} {res[t]['ms']:.3f}" for t in
                                   ("dp/MutilDiceLoss_f32", "dp/MutilDiceLoss_bf16",
                                    "dp/LovaszLoss_f32", "tp")) + f" ({mods['smi']})")

        unet_b, vnet_b = _par_batch("unet"), _par_batch("vnet")
        single, single_ms = _par_single(torch, mods, "unet", unet_b)
        control = (r0["sp/unet_bf16"]["loss"], r0["sp/unet_bf16"]["grads"])
        gates = {}
        gates["unet"] = _par_gate(torch, mods, "spatial UNet3d f32",
                                  (r0["sp/unet_f32"]["loss"], r0["sp/unet_f32"]["grads"]),
                                  control, single)
        gates["packed"] = _par_gate(torch, mods, "packed x spatial UNet3d f32",
                                    (r0["sp/packed_f32"]["loss"], r0["sp/packed_f32"]["grads"]),
                                    control, single)
        # the bf16 sharded step against one process's bf16 step through the kernels
        _, g_bf = single(torch.bfloat16)
        with plain_kernels(mods):
            ref = single(torch.float64)[1]
        d_sh = max(_param_errors(control[1], ref).values())
        d_one = max(_param_errors(g_bf, ref).values())
        say(f"  spatial UNet3d bf16: worst grad error vs the f64 step, sharded {d_sh:.3g}, "
            f"one process {d_one:.3g}")
        if not d_sh <= 2 * d_one + STEP_GRAD_TOL:
            fail("spatial UNet3d bf16 step farther from the f64 step than one process's")
        # tensor parallel: the shards gathered into whole gradients
        tp = dict(r0["tp"]["grads"])
        for name, dim in r0["tp"]["spec"].items():
            tp[name] = torch.cat([res["tp"]["grads"][name] for res in ranks], dim=dim)
        say(f"  tensor parallel: sharded {sorted(r0['tp']['spec'])}")
        gates["tp"] = _par_gate(torch, mods, "tensor-parallel UNet3d f32",
                                (r0["tp"]["loss"], tp), control, single)
        del single

        vsingle, vsingle_ms = _par_single(torch, mods, "vnet", vnet_b)
        gates["vnet"] = _par_gate(torch, mods, "spatial VNet3d f32",
                                  (r0["sp/vnet_f32"]["loss"], r0["sp/vnet_f32"]["grads"]),
                                  (r0["sp/vnet_bf16"]["loss"], r0["sp/vnet_bf16"]["grads"]),
                                  vsingle)
        net = _par_net(torch, mods, "vnet").eval()
        with torch.no_grad():
            probs = net(torch.from_numpy(vnet_b["image"]).cuda())[1].cpu()
        err = rel_err(r0["sp/vnet_fwd"], probs)
        say(f"  spatial VNet3d forward (96^3, 48 + 48): probs vs one process's, max_abs_err "
            f"{err[0]:.3g} (tol 1e-4)")
        if not err[0] <= 1e-4:
            fail("spatial VNet3d forward vs one process's")
        del vsingle, net

        dp_b = _par_batch("unet", 2)
        for loss_name in ("MutilDiceLoss", "LovaszLoss"):
            dsingle, dms = _par_single(torch, mods, "unet", dp_b, loss_name, dropout=0.0)
            gates[f"dp_{loss_name}"] = _par_gate(
                torch, mods, f"data-parallel UNet3d f32 ({loss_name}, batch 2)",
                (r0[f"dp/{loss_name}_f32"]["loss"], r0[f"dp/{loss_name}_f32"]["grads"]),
                (r0[f"dp/{loss_name}_bf16"]["loss"], r0[f"dp/{loss_name}_bf16"]["grads"]),
                dsingle)
            say(f"  one process's batch-2 {loss_name} step {dms:.3f} ms")
            del dsingle

        say(f"  pipeline_apply (2 stages, 8 microbatches) vs sequential_reference: "
            f"max_abs_err {r0['pipe'][0]:.3g}")
        err, k2 = r0["infer"]
        say(f"  spatial_partition_infer (conv net, margin 8) vs the whole forward: "
            f"max_abs_err {err[0]:.3g} (scale {err[1]:.3g}), K2 {k2} launches on rank 0")
        if not (r0["pipe"][0] <= 1e-5 and err[0] <= 1e-4 * err[1] and k2 > 0):
            fail("pipeline or spatial_partition_infer mismatch")

        from tpuseg_torch.core.checkpoint import restore_sharded

        state = restore_sharded(r0["tp/ckpt"]["path"])
        spec = r0["tp"]["spec"]
        for name, v in state["model"].items():
            want = (torch.cat([res["tp/ckpt"]["model"][name] for res in ranks], dim=spec[name])
                    if name in spec else r0["tp/ckpt"]["model"][name])
            if not torch.equal(v, want):
                fail(f"sharded checkpoint {name} differs after the restore")
        say(f"  sharded checkpoint: written by 2 ranks (model 2), restored in one process, "
            f"{len(state['model'])} tensors equal bit for bit")

        for r, res in enumerate(ranks):
            for row in res["split_rows"]:
                bad = [e for e in (row["fwd_err"], row["bwd_err"])
                       if not e[0] <= TOL[row["dtype"]] * e[1]]
                say(f"  rank {r} K1 split {row['dtype']} C{row['c']} {row['shape']}: "
                    f"max_abs_err fwd {row['fwd_err'][0]:.3g} bwd {row['bwd_err'][0]:.3g}; "
                    f"ms fwd {row['ms']:.4f} (with the gloo gather {row['ms_gloo']:.3f}), "
                    f"plain {row['plain_ms']:.4f}, F.group_norm {row['library_ms']:.4f}, "
                    f"bound {row['bound'][0]:.4f}; bwd {row['bwd_ms']:.4f} (gloo "
                    f"{row['bwd_ms_gloo']:.3f}), plain {row['bwd_plain_ms']:.4f}, library "
                    f"{row['bwd_library_ms']:.4f}, bound {row['bwd_bound'][0]:.4f}")
                if bad:
                    fail(f"K1 split vs plain on rank {r}: {row}")
        say(f"  one process's UNet3d f32 step {single_ms:.3f} ms, VNet3d {vsingle_ms:.3f} ms; "
            f"the collectives are gloo's on one card (staged through the host), not NCCL's "
            f"({mods['smi']})")
        nccl = _nccl_probe(torch, mods)
        paths = {f"par_{t}": r0[f"sp/{t}"]["launches"] for t in
                 ("unet_f32", "unet_bf16", "packed_f32", "vnet_f32", "vnet_bf16")}
        return paths, r0["split_rows"], nccl
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# phase 15: the opt-in variants.  Per 27-patch VNet3d forward (features
# 16, 2 classes): under int8_inference every ConvND of the plain net runs
# on the int8 kernel's dense mode (its 31 convs, each input quantized by
# the quantizer kernel; K2 none, K1 its 34 GroupNorms); under
# int8_packed_inference the twin at packed_levels 2 sends JAX's ``_conv``
# sites with Cin >= 32 to it (29: the five packed k3s in the structured
# mode instead of K3, the packed 1x1s, the packing convs and the fine
# levels' convs in the dense mode instead of K2; 29 quantizer calls); the
# shift form runs the twin's packed k3s on cuDNN (K3 none); k4s2 the last
# LUConv as a depth-to-space and the k4 stride-2 conv (K3 4).  No call
# shape of these paths takes the mma.sync kernel (``conv_int8_sync``)
INT8_NONE = {"conv_int8": 0, "conv_int8_structured": 0, "conv_int8_sync": 0,
             "quantize_int8": 0}
# per plain UNet3d forward (features 16, 5 classes, phase 8's batch of 8
# patches of 128x112x112) under int8_inference: its 19 ConvNDs on the int8
# route, 18 in the wgmma kernel's dense mode and the 256 -> 128 decoder k3
# at 16x14x14, whose brick does not fit a block, on the mma.sync kernel;
# 19 quantizer calls; K1 its 18 GroupNorms; K2 none
UNET_INT8_FORWARD = dict({k: 0 for k in EXPECTED_LAUNCHES}, fused_group_norm_relu=18,
                         **dict(INT8_NONE, conv_int8=18, conv_int8_sync=1, quantize_int8=19))
VAR_VNET_LAUNCHES = {
    "vnet_f32": dict(SWIN_VNET_LAUNCHES, **INT8_NONE),
    "vnet_int8": dict(SWIN_VNET_LAUNCHES, **dict(INT8_NONE, conv_int8=31, quantize_int8=31),
                      conv3d_small=0),
    "vnet_packed_f32": dict(SWIN_VNET_PACKED_LAUNCHES, **INT8_NONE),
    "vnet_packed_int8": dict(SWIN_VNET_PACKED_LAUNCHES, packed_conv3d_structured=0,
                             conv3d_small=0, **dict(INT8_NONE, conv_int8=24,
                                                    conv_int8_structured=5,
                                                    quantize_int8=29)),
    "vnet_packed_shift": dict(SWIN_VNET_PACKED_LAUNCHES, packed_conv3d_structured=0,
                              **INT8_NONE),
    "vnet_packed_k4s2": dict(SWIN_VNET_PACKED_LAUNCHES, packed_conv3d_structured=4,
                             **INT8_NONE),
}
# per UNet3d train step at 112x112x128, 5 classes: the packed twin with
# the fine loss and with each packed loss runs phase 6's launches; the
# shift form none of K3's; the plain net, with and without
# USE_GEMM_FASTPATH, phase 6's plain launches (its transpose convs are
# products under the flag)
VAR_TRAIN_LAUNCHES = {
    "train_packed_fine": dict(TRAIN_PACKED_LAUNCHES, **INT8_NONE),
    "train_packed_class_loss": dict(TRAIN_PACKED_LAUNCHES, **INT8_NONE),
    "train_packed_grid_loss": dict(TRAIN_PACKED_LAUNCHES, **INT8_NONE),
    "train_packed_shift": dict(TRAIN_PACKED_LAUNCHES, packed_conv3d_structured=0,
                               packed_conv3d_structured_dx=0, packed_conv3d_structured_dw=0,
                               **INT8_NONE),
    "train_plain": dict(TRAIN_LAUNCHES, **INT8_NONE),
    "train_plain_gemm_fastpath": dict(TRAIN_LAUNCHES, **INT8_NONE),
}
# JAX's own bars for int8 masks against the float net (tests/test_int8.py,
# tests/test_vnet_packed.py)
INT8_AGREE = {"vnet_int8": 0.98, "vnet_packed_int8": 0.97}
# NVIDIA H100 SXM data sheet: dense int8 on the tensor cores
PEAK_INT8_OPS = 1979e12


def _int8_counts(mods) -> dict:
    ci = mods["conv_int8"]
    return {"conv_int8": ci.LAUNCHES, "conv_int8_structured": ci.LAUNCHES_STRUCTURED,
            "conv_int8_sync": ci.LAUNCHES_SYNC, "quantize_int8": ci.QUANTIZE_LAUNCHES}


def _var_counts(mods) -> dict:
    return dict(counts(mods), **_int8_counts(mods))


def _var_reset(mods) -> None:
    reset_counts(mods)
    ci = mods["conv_int8"]
    ci.LAUNCHES = ci.LAUNCHES_STRUCTURED = ci.LAUNCHES_SYNC = ci.QUANTIZE_LAUNCHES = 0


@contextlib.contextmanager
def _flag(mod, name: str, value):
    prev = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, prev)


def _bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _int_mm_ms(torch, xs, wq):
    """torch._int_mm (int8 x int8 -> int32, the same sums) of a 1x1 conv's
    concat and weight, or None where its shape rules refuse the shape."""
    a = torch.cat(xs, dim=-1).reshape(-1, wq.shape[-2])
    b = wq.reshape(wq.shape[-2], wq.shape[-1])
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        return None
    return time_ms(torch, lambda: torch._int_mm(a, b), iters=10)


def _int8_rows(torch, mods, calls: dict, tag: str) -> list:
    """conv_int8 at each recorded call shape of a path (random int8
    operands, the same epilogue), in the mode it runs (dense, structured,
    or the mma.sync kernel, read from the counter it moves): bit for bit against
    its plain version (the dense mode: the float64 conv on the card; the
    structured mode: the float64 sums of its K-row table, and the float64
    conv too), kernel and plain timed, the bound from the int8 rate and
    the bytes; as the library, torch._int_mm where the conv is a 1x1 its
    shape rules take, and cuDNN's bf16 conv of the shape as a labelled
    reference (another function).  The structured rows also time the
    dense mode on the same inputs."""
    ci, pc = mods["conv_int8"], mods["packed_conv"]
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (xs, ws, st, pads, dtype_name, bias_mode, axes, c2), uses in calls.items():
        dtype = getattr(torch, dtype_name)
        xqs = [torch.randint(-127, 128, xs, generator=g, device="cuda", dtype=torch.int8)]
        if c2:
            xqs.append(torch.randint(-127, 128, xs[:-1] + (c2,), generator=g, device="cuda",
                                     dtype=torch.int8))
        cins = tuple(x.shape[-1] for x in xqs)
        if axes is None:
            wq = torch.randint(-127, 128, ws, generator=g, device="cuda", dtype=torch.int8)
            packed = ci.pack_dense(wq)
        else:  # a packed k3's weight: pack_k3_axes of random fine weights, quantized
            p = pc.deltas(axes)
            w3 = torch.cat([pc.pack_k3_axes(torch.randn(
                (3, 3, 3, c // p, ws[-1] // p), generator=g, device="cuda"), axes)
                for c in cins], dim=3)
            wq = ci.quantize_weight(w3)[0]
            packed = ci.pack_int8(wq, ci.structured_pieces(cins, axes), True)
        scale = torch.rand(ws[-1], generator=g, device="cuda") * 1e-4
        bias = torch.randn(ws[-1], generator=g, device="cuda") if bias_mode else None
        two = xqs[1] if c2 else None

        def kern():
            return ci.conv_int8(xqs[0], wq, scale, bias, st, pads, dtype, bias_mode, packed,
                                axes=axes, xq2=two)

        before = _int8_counts(mods)
        y = kern()
        mode = next(m for m, n in _int8_counts(mods).items() if n != before[m])
        mode = {"conv_int8": "dense", "conv_int8_structured": "structured",
                "conv_int8_sync": "sync"}[mode]
        xcat = torch.cat(xqs, dim=-1) if c2 else xqs[0]
        ref = ci.conv_int8_plain(xcat, wq, scale, bias, st, pads, dtype, bias_mode)
        if not torch.equal(y, ref):
            fail(f"conv_int8 {tag} {xs} x {ws} axes {axes}: not equal to its plain version "
                 f"(max diff {(y.float() - ref.float()).abs().max().item()})")
        ms = time_ms(torch, kern, iters=10)
        if axes is None:
            plain = lambda: ci.conv_int8_plain(xcat, wq, scale, bias, st, pads, dtype, bias_mode)
        else:
            def plain():
                acc = ci.int32_sums_table_plain(xqs, wq, packed.pieces, 1, "SAME")
                return ci._epilogue(acc, scale, bias, bias_mode, dtype)

            if not torch.equal(plain(), y):
                fail(f"conv_int8 {tag} {xs} structured: not equal to its table's plain sums")
        plain_ms = time_ms(torch, plain, iters=1, warmup=0)
        # cuDNN's bf16 conv of the same shape (the (low, high) pads applied first)
        x3 = xcat.to(torch.bfloat16) if xcat.dim() == 5 else xcat.unsqueeze(1).to(torch.bfloat16)
        w3b = wq.to(torch.bfloat16) if wq.dim() == 5 else wq.unsqueeze(0).to(torch.bfloat16)
        p3 = pads if len(pads) == 3 else ((0, 0),) + tuple(pads)
        s3 = st if len(st) == 3 else (1,) + tuple(st)
        xc = F.pad(x3.permute(0, 4, 1, 2, 3), [q for lo_hi in reversed(p3) for q in lo_hi])
        wc = w3b.permute(4, 3, 0, 1, 2).contiguous()
        cudnn_ms = time_ms(torch, lambda: F.conv3d(xc, wc, stride=s3), iters=10)
        library_ms = (_int_mm_ms(torch, xqs, wq) if all(k == 1 for k in ws[:-2])
                      and all(s == 1 for s in st) else None)
        out = y.numel() // y.shape[-1]
        k_rows = 16 * len(packed.pieces) if packed.pieces else int(np.prod(ws[:-1]))
        ops = 2.0 * out * k_rows * ws[-1]
        nbytes = sum(x.numel() for x in xqs) + k_rows * ws[-1] + y.numel() * y.element_size()
        bound = _bound(ops, nbytes)
        row = dict(shape=[list(xs), list(ws), list(st), [list(p) for p in pads]],
                   parts=list(cins), mode=mode,
                   dtype=dtype_name, uses=uses, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
                   cudnn_bf16_ms=cudnn_ms, k_rows=k_rows, tops=ops / ms / 1e9)
        extra = ""
        if axes is not None:
            dense = ci.pack_dense(wq)
            row["dense_mode_ms"] = time_ms(torch, lambda: ci.conv_int8(
                xcat, wq, scale, bias, st, pads, dtype, bias_mode, dense), iters=10)
            extra = f", the dense mode {row['dense_mode_ms']:.4f} ms"
        rows.append(row)
        say(f"  conv_int8 {tag} {row['mode']} x {xs} parts {list(cins)} w {ws} stride {st} "
            f"pads {pads} -> {dtype_name} (x{uses}): equal to plain; kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s over K {k_rows}){extra}, plain {plain_ms:.3f} ms, "
            f"torch._int_mm {library_ms if library_ms is None else round(library_ms, 4)} ms, "
            f"cuDNN bf16 (another function) {cudnn_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]})")
        del xqs, xcat, wq, xc, wc, y, ref, packed
        torch.cuda.empty_cache()
    return rows


def _quant_rows(torch, mods, calls: dict, tag: str) -> list:
    """The quantizer at each recorded (parts, dtype) of a path: random maps,
    the kernel bit for bit against its plain version (PyTorch's ops on the
    card, dividing by a tensor: true division as on the CPU), both timed;
    bound: each input byte read once and each int8 written once."""
    ci = mods["conv_int8"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (shapes, dtype_name), uses in calls.items():
        dtype = getattr(torch, dtype_name)
        parts = [(torch.randn(s, generator=g, device="cuda") * 3).to(dtype) for s in shapes]
        qs, scale = ci.quantize_parts(parts)
        whole = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        want, wscale = ci.quantize_activation_plain(whole)
        if not (torch.equal(torch.cat(qs, dim=-1), want) and torch.equal(scale, wscale)):
            fail(f"quantize_int8 {tag} {shapes} {dtype_name}: not equal to its plain version")
        ms = time_ms(torch, lambda: ci.quantize_parts(parts), iters=10)
        plain_ms = time_ms(torch, lambda: ci.quantize_activation_plain(whole), iters=5)
        n = sum(p.numel() for p in parts)
        bound = _bound(0.0, n * (parts[0].element_size() + 1))
        rows.append(dict(shape=[list(s) for s in shapes], dtype=dtype_name, uses=uses,
                         max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], library_ms=None))
        say(f"  quantize_int8 {tag} {shapes} {dtype_name} (x{uses}): equal to plain; kernel "
            f"{ms:.4f} ms, plain (PyTorch ops) {plain_ms:.4f} ms, bound {bound[0]:.4f} ms")
        del parts, whole, qs, want
        torch.cuda.empty_cache()
    return rows


def _record_int8_calls(mods, calls: dict, qcalls: dict):
    """Wrap conv_int8 to count each (shape, stride, pads, dtype, bias mode,
    mode, second part) it is called with, and the quantizer each (parts,
    dtype); returns the undo."""
    ci = mods["conv_int8"]
    orig, orig_q = ci.conv_int8, ci.quantize_parts

    def rec(xq, wq, scale, bias=None, stride=1, padding="VALID", out_dtype=None,
            bias_mode=None, packed=None, *, axes=None, split=None, xq2=None):
        x3, w3, st, pad = ci._as3d(xq, wq, stride, padding)
        pads, _ = ci._geometry(x3.shape, w3.shape, st, pad)
        if xq.dim() == 4:
            st, pads = st[1:], pads[1:]
        key = (tuple(xq.shape), tuple(wq.shape), tuple(st), tuple(pads),
               str(out_dtype).replace("torch.", ""), bias_mode if bias is not None else None,
               None if axes is None else tuple(axes), 0 if xq2 is None else xq2.shape[-1])
        calls[key] = calls.get(key, 0) + 1
        return orig(xq, wq, scale, bias, stride, padding, out_dtype, bias_mode, packed,
                    axes=axes, split=split, xq2=xq2)

    def rec_q(parts):
        key = (tuple(tuple(p.shape) for p in parts), str(parts[0].dtype).replace("torch.", ""))
        qcalls[key] = qcalls.get(key, 0) + 1
        return orig_q(parts)

    ci.conv_int8, ci.quantize_parts = rec, rec_q
    return lambda: (setattr(ci, "conv_int8", orig), setattr(ci, "quantize_parts", orig_q))


def _var_inference(torch, mods):
    """The VNet3d variants through MutilVNet3dModel.inference_patch at
    bench.py's primary (160x160x192 at 0.5 mm, 27 patches of 96^3 in one
    batch): launches per path, masks against the flag-off route, volume
    times; one 27-patch forward of each in f32 and bf16; the int8 kernel's
    rows at the shapes of both int8 paths; K3 beside the shift form's cuDNN
    conv at the twin's two k3 grids."""
    import copy

    layers, pvp = mods["layers"], mods["vnet_packed"]
    model = mods["MutilVNet3dModel"](*SWIN_PATCH, 1, SWIN_CLASSES, features=FEATURES,
                                     device="cuda")
    model.load_jax_params(mods["seeded_vnet_params"](SEED, FEATURES, SWIN_CLASSES, 1))
    rng = np.random.default_rng(SEED)
    ct = mods["synthetic_ct"](SWIN_VOL[::-1], rng)
    ct.spacing = (0.5, 0.5, 0.5)

    def patch_run(packed: bool, ctx):
        def run():
            model.packed_inference = packed
            with ctx():
                return model.inference_patch(ct, (0.5, 0.5, 0.5), batch_size=SWIN_BATCH).array
        return run

    none = contextlib.nullcontext
    runs = {
        "vnet_f32": patch_run(False, none),
        "vnet_int8": patch_run(False, layers.int8_inference),
        "vnet_packed_f32": patch_run(True, none),
        "vnet_packed_int8": patch_run(True, pvp.int8_packed_inference),
        "vnet_packed_shift": patch_run(True, lambda: _flag(pvp, "USE_SHIFT_PACKED_K3", True)),
        "vnet_packed_k4s2": patch_run(True, lambda: _flag(pvp, "LUCONV96_MODE", "k4s2")),
    }
    for run in runs.values():
        run()  # each path's derived weights
    launches, masks, calls, qcalls = {}, {}, {}, {}
    for path, run in runs.items():
        undo = _record_int8_calls(mods, calls.setdefault(path, {}), qcalls.setdefault(path, {}))
        _var_reset(mods)
        try:
            masks[path] = run()
        finally:
            undo()
        launches[path] = _var_counts(mods)
        if launches[path] != VAR_VNET_LAUNCHES[path]:
            fail(f"{path}: launches {launches[path]} != {VAR_VNET_LAUNCHES[path]}")
    agree = {p: float((masks[p] == masks["vnet_f32" if p == "vnet_int8" else
                                          "vnet_packed_f32"]).mean())
             for p in runs if p not in ("vnet_f32", "vnet_packed_f32")}
    agree["vnet_packed_f32_vs_plain"] = float((masks["vnet_packed_f32"]
                                               == masks["vnet_f32"]).mean())
    for p, bar in INT8_AGREE.items():
        if not agree[p] >= bar:
            fail(f"{p}: mask agreement with the float route {agree[p]} < {bar}")
    for p in ("vnet_packed_shift", "vnet_packed_k4s2"):
        if not agree[p] >= PACKED_AGREE["float32"]:
            fail(f"{p}: mask agreement with the dense twin {agree[p]}")
    best, med = interleaved(torch, runs, reps=3)
    model.packed_inference = True
    say(f"  inference_patch {ct.array.shape} at 0.5 mm, {SWIN_BATCH} patches of {SWIN_PATCH} "
        f"in one batch: launches per volume {json.dumps(launches)}; mask agreement with the "
        f"flag-off route {json.dumps(agree)} (gates: int8 {json.dumps(INT8_AGREE)}, shift and "
        f"k4s2 >= {PACKED_AGREE['float32']}); volume wall ms (host clock, min / median of 3 "
        f"interleaved): " + ", ".join(f"{k} {best[k] * 1e3:.1f} / {med[k] * 1e3:.1f}"
                                      for k in runs))

    # one 27-patch forward of each route, f32 and bf16 (the bf16 on a copy
    # of the net in bf16), masks against the dense twin in the same dtype
    net = model.model
    net_bf16 = copy.deepcopy(net)
    x = torch.randn((SWIN_BATCH, *SWIN_PATCH, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    fwd = {}
    with torch.inference_mode():
        for dtype_name, n in (("float32", net), ("bfloat16", net_bf16)):
            xb = x.to(getattr(torch, dtype_name))

            def twin(ctx, lv=2, n=n, xb=xb):
                def f():
                    with ctx():
                        return pvp.packed_vnet3d_apply(n, xb, packed_levels=lv)[1]
                return f

            variants = {
                "plain": lambda n=n, xb=xb: n(xb)[1],
                "packed": twin(none),
                "packed_shift": twin(lambda: _flag(pvp, "USE_SHIFT_PACKED_K3", True)),
                "packed_k4s2": twin(lambda: _flag(pvp, "LUCONV96_MODE", "k4s2")),
                "packed_int8": twin(pvp.int8_packed_inference),
            }
            variants["plain_int8"] = lambda n=n, xb=xb: _int8_plain(layers, n, xb)
            ref = variants["packed"]().argmax(-1)
            for k in ("packed_shift", "packed_k4s2"):
                a = float((variants[k]().argmax(-1) == ref).mean(dtype=torch.float32))
                if not a >= PACKED_AGREE[dtype_name]:
                    fail(f"{k} {dtype_name} forward: mask agreement {a} with the dense twin")
            for k, f in variants.items():
                fwd[f"{dtype_name} {k}"] = time_ms(torch, f, iters=3)
    _var_reset(mods)
    say("  27-patch forward device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in fwd.items()))
    del net_bf16, x
    # where an int8 forward's device time goes (torch.profiler; the int8
    # route's calls in ranges of their own)
    int8_split = {f"{route} {dt}": mods["int8_split"].split(route, dt)
                  for route in ("plain", "twin") for dt in ("float32", "bfloat16")}
    _var_reset(mods)
    say("  int8 27-patch forward device ms by part (torch.profiler): "
        + json.dumps(int8_split))

    # K3 beside the shift form's one cuDNN conv at the twin's k3 grids
    k3_rows = {}
    g = torch.Generator(device="cpu").manual_seed(SEED)
    for grid, axes, shape in (("full8", (True, True, True), (SWIN_BATCH, 48, 48, 48)),
                              ("part4", (False, True, True), (SWIN_BATCH, 48, 24, 24))):
        c = 16 if grid == "full8" else 32
        p = 8 if grid == "full8" else 4
        w = torch.randn((3, 3, 3, c, c), generator=g) * 0.1
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            k3 = pvp.Derive(dtype, "cuda", False).k3([w], axes, torch.zeros(c))
            xk = torch.randn((*shape, p * c), device="cuda", dtype=dtype)
            with torch.inference_mode():
                k3_ms = time_ms(torch, lambda: k3(xk), iters=5)
                with _flag(pvp, "USE_SHIFT_PACKED_K3", True):
                    shift = k3(xk)
                    shift_ms = time_ms(torch, lambda: k3(xk), iters=5)
                err, scale = rel_err(shift, k3(xk))
            if not err <= TOL[dtype_name] * scale:
                fail(f"shift form {grid} {dtype_name}: {err} against K3")
            k3_rows[f"{grid} {dtype_name}"] = {"k3_ms": k3_ms, "shift_cudnn_ms": shift_ms,
                                                "max_abs_err": err}
            del xk, shift
    say("  K3 vs the shift form's cuDNN conv, one 27-patch call: " + json.dumps(k3_rows))
    rows = {p: _int8_rows(torch, mods, calls[p], p) for p in ("vnet_int8", "vnet_packed_int8")}
    rows.update({f"quantize {p}": _quant_rows(torch, mods, qcalls[p], p)
                 for p in ("vnet_int8", "vnet_packed_int8")})
    del model, net
    torch.cuda.empty_cache()
    return launches, rows, {"volume_ms": {k: best[k] * 1e3 for k in runs},
                            "forward_ms": fwd, "k3_vs_shift": k3_rows, "agree": agree,
                            "int8_split": int8_split}


def _int8_plain(layers, net, x):
    with layers.int8_inference():
        return net(x)[1]


@contextlib.contextmanager
def _int8_plain_versions(torch, mods):
    """Route the int8 conv's dense calls and the quantizer to their plain
    versions on the card (the float64 conv, PyTorch's ops)."""
    ci = mods["conv_int8"]
    orig, orig_q = ci.conv_int8, ci.quantize_parts

    def conv(xq, wq, scale, bias=None, stride=1, padding="VALID", out_dtype=None,
             bias_mode=None, packed=None, *, axes=None, split=None, xq2=None):
        if axes is not None or xq2 is not None:
            fail("_int8_plain_versions: a structured or two-part call")
        return ci.conv_int8_plain(xq, wq, scale, bias, stride, padding, out_dtype, bias_mode)

    def quantize(parts):
        xq, a_scale = ci.quantize_activation_plain(torch.cat(list(parts), dim=-1))
        return list(xq.split([p.shape[-1] for p in parts], dim=-1)), a_scale

    ci.conv_int8, ci.quantize_parts = conv, quantize
    try:
        yield
    finally:
        ci.conv_int8, ci.quantize_parts = orig, orig_q


def _var_unet_int8(torch, mods):
    """The plain UNet3d (features 16, 5 classes) through
    MutilUNet3dModel.inference_patch at phase 8's volume and batch under
    int8_inference (module comment above ``UNET_INT8_FORWARD``): launches
    per volume, the mask against the same route through the int8 conv's
    and the quantizer's plain versions (the same function: gate 0.999) and
    against the float route (reported), volume and forward times; the int8
    rows at each of its call shapes.  Returns (launches, conv rows,
    quantizer rows, numbers)."""
    layers = mods["layers"]
    model = mods["MutilUNet3dModel"](*SWIN_UNET_PATCH, 1, CLASSES, features=FEATURES,
                                     device="cuda")
    model.load_jax_params(mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1))
    model.packed_inference = False
    ct = mods["synthetic_ct"](SWIN_UNET_SIZE, np.random.default_rng(SEED))
    ct.spacing = SWIN_UNET_SPACING
    work = mods["resample_to_spacing"](ct, (0.5, 0.5, 0.5))
    n_fwd = -(-len(mods["sliding_window"].grid_positions(work.array.shape, SWIN_UNET_PATCH,
                                                          0.5)) // SWIN_UNET_BATCH)

    def patch_run(ctx):
        def run():
            with ctx():
                return model.inference_patch(ct, (0.5, 0.5, 0.5),
                                             batch_size=SWIN_UNET_BATCH).array
        return run

    runs = {"unet_f32": patch_run(contextlib.nullcontext),
            "unet_int8": patch_run(layers.int8_inference)}
    for run in runs.values():
        run()
    calls, qcalls = {}, {}
    undo = _record_int8_calls(mods, calls, qcalls)
    _var_reset(mods)
    try:
        mask = runs["unet_int8"]()
    finally:
        undo()
    launches = _var_counts(mods)
    want = {k: v * n_fwd for k, v in UNET_INT8_FORWARD.items()}
    if launches != want:
        fail(f"unet_int8: launches {launches} != {want}")
    with _int8_plain_versions(torch, mods):
        plain = runs["unet_int8"]()
    _var_reset(mods)
    agree = {"plain_versions": float((mask == plain).mean()),
             "float_route": float((mask == runs["unet_f32"]()).mean())}
    if mask.shape != ct.array.shape or mask.max() > CLASSES - 1:
        fail(f"unet_int8: mask {mask.shape} labels up to {mask.max()}")
    if not agree["plain_versions"] >= 0.999:
        fail(f"unet_int8: mask agreement {agree['plain_versions']} with the plain versions")
    best, med = interleaved(torch, runs, reps=3)
    net = model.model
    x = torch.randn((SWIN_UNET_BATCH, *SWIN_UNET_PATCH, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.inference_mode():
        fwd = {"float32": time_ms(torch, lambda: net(x)[1], iters=3),
               "float32 int8": time_ms(torch, lambda: _int8_plain(layers, net, x), iters=3)}
    _var_reset(mods)
    say(f"  MutilUNet3dModel.inference_patch (plain net) {ct.array.shape} at 0.5 mm, "
        f"{n_fwd} forwards of {SWIN_UNET_BATCH} patches of {SWIN_UNET_PATCH} under "
        f"int8_inference: launches per volume {json.dumps(launches)}; mask agreement "
        f"{json.dumps(agree)} (gate: 0.999 with the plain versions); volume wall ms (host "
        f"clock, min / median of 3 interleaved): "
        + ", ".join(f"{k} {best[k] * 1e3:.1f} / {med[k] * 1e3:.1f}" for k in runs)
        + f"; batch-{SWIN_UNET_BATCH} forward device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in fwd.items()))
    del x, net
    rows = _int8_rows(torch, mods, calls, "unet_int8")
    qrows = _quant_rows(torch, mods, qcalls, "unet_int8")
    del model
    torch.cuda.empty_cache()
    return launches, rows, qrows, {"volume_ms": {k: best[k] * 1e3 for k in runs},
                                   "forward_ms": fwd, "agree": agree, "forwards": n_fwd}


def _var_training(torch, mods):
    """UNet3d (features 16, 5 classes) at 112x112x128: one Adam step each
    through the packed twin with the fine loss, each packed loss and the
    shift form, and the plain net with and without USE_GEMM_FASTPATH;
    launches per step, the first step's loss against the fine route's,
    step times."""
    import copy

    layers, seg = mods["layers"], sys.modules["tpuseg_torch.tasks.segmentation"]
    pvp = mods["vnet_packed"]
    net = mods["UNet"](CLASSES, FEATURES, dropout=0.0).cuda()
    net.load_state_dict(mods["unet_params_from_jax"](
        mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1)), strict=True)
    rng = np.random.default_rng(SEED)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (1, *TRAIN_DHW, 1)).astype(np.float32)).cuda(),
             "label": torch.from_numpy(rng.integers(0, CLASSES, (1, *TRAIN_DHW))).cuda()}
    none = contextlib.nullcontext
    cases = {
        "train_packed_fine": (True, none),
        "train_packed_class_loss": (True, lambda: _flag(seg, "USE_PACKED_CLASS_LOSS", True)),
        "train_packed_grid_loss": (True, lambda: _flag(seg, "USE_PACKED_GRID_LOSS", True)),
        "train_packed_shift": (True, lambda: _flag(pvp, "USE_SHIFT_PACKED_K3", True)),
        "train_plain": (False, none),
        "train_plain_gemm_fastpath": (False, lambda: _flag(layers, "USE_GEMM_FASTPATH", True)),
    }
    d2s = {"n": 0}
    orig_d2s = layers.depth_to_space

    def counted_d2s(*a, **kw):
        d2s["n"] += 1
        return orig_d2s(*a, **kw)

    layers.depth_to_space = counted_d2s
    trainers, launches, first = {}, {}, {}
    try:
        for path, (packed, ctx) in cases.items():
            with ctx():
                tr = mods["make_segmentation_trainer"](
                    copy.deepcopy(net), CLASSES, "MutilDiceLoss", device="cuda",
                    packed_stem=packed, config=mods["TrainerConfig"](optimizer="adam",
                                                                    lr=1e-4))
                _var_reset(mods)
                d2s["n"] = 0
                m = tr.train_step(batch)
                torch.cuda.synchronize()
                launches[path] = _var_counts(mods)
                first[path] = (float(m["loss"]), float(m["metric"]))
                if path == "train_plain_gemm_fastpath" and d2s["n"] != 4:
                    fail(f"{path}: {d2s['n']} depth-to-space products, not the UNet's 4")
            if launches[path] != VAR_TRAIN_LAUNCHES[path]:
                fail(f"{path}: launches {launches[path]} != {VAR_TRAIN_LAUNCHES[path]}")
            trainers[path] = (tr, ctx)
    finally:
        layers.depth_to_space = orig_d2s
    ref = first["train_packed_fine"]
    for path, (loss, metric) in first.items():
        tol = 1e-5 if path.endswith("loss") else 1e-4
        if not (abs(loss - ref[0]) <= tol * max(1.0, abs(ref[0])) and np.isfinite(loss)):
            fail(f"{path}: first loss {loss} against the fine route's {ref[0]}")
    steps = {}
    for path, (tr, ctx) in trainers.items():
        def step(tr=tr, ctx=ctx):
            with ctx():
                for _ in range(3):
                    tr.train_step(batch)
        steps[path] = step
    for f in steps.values():
        f()
    best, med = interleaved(torch, steps, reps=3)
    say(f"  UNet3d {TRAIN_DHW} train step: launches per step {json.dumps(launches)}; first "
        f"(loss, metric) {json.dumps(first)} (gate 1e-5 of the fine route's for the packed "
        f"losses, 1e-4 for the others); ms per step (3-step passes, "
        f"min / median of 3 interleaved): "
        + ", ".join(f"{k} {best[k] * 1e3 / 3:.2f} / {med[k] * 1e3 / 3:.2f}" for k in steps))
    del trainers, steps, net
    torch.cuda.empty_cache()
    return launches, {k: best[k] * 1e3 / 3 for k in cases}


def phase_variants(torch, mods):
    """Phase 15: the opt-in variants (module comment above).  Returns
    ({path: launches}, {path: conv_int8 rows, "quantize <path>": the
    quantizer's rows}, numbers)."""
    if any(_int8_counts(mods).values()):
        fail(f"the int8 route launched with every flag off: {_int8_counts(mods)}")
    launches, rows, numbers = _var_inference(torch, mods)
    (launches["unet_int8"], rows["unet_int8"], rows["quantize unet_int8"],
     numbers["unet_int8"]) = _var_unet_int8(torch, mods)
    train_launches, step_ms = _var_training(torch, mods)
    launches.update(train_launches)
    numbers["step_ms"] = step_ms
    return launches, rows, numbers


def _load_generator(name: str):
    """``tests/<name>.py``, a golden file's generator, as a module (its
    inputs, fingerprints and golden path; it imports JAX only inside the
    functions that write the file)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", f"{name}.py")
    if not os.path.isfile(path):
        fail(f"golden generator missing: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(torch):
    """Phases 1 and 2 (the card, the build) and the modules the phases
    take: returns (mods, nvidia-smi line).  Fails without a CUDA card."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    from tpuseg_torch import inference, recipes, serve, train
    from tpuseg_torch.benchmarks import int8_split, kbench, kmicro, kmicro2, kmicro3
    from tpuseg_torch.compat.seg_models import (MutilUNet3dModel, MutilVNet3dModel,
                                                disable_tf32)
    from tpuseg_torch.compat import weights as zoo_weights
    from tpuseg_torch.compat.weights import (seeded_unet_params, seeded_vnet_params,
                                             unet_params_from_jax, vnet_params_from_jax)
    from tpuseg_torch.config import parse_cli
    from tpuseg_torch.core.prng import step_generator
    from tpuseg_torch.data import augment2d, augment3d
    from tpuseg_torch.data.geometry import resample_to_spacing
    from tpuseg_torch.data.nifti import read_nifti, write_nifti
    from tpuseg_torch.data.normalize import truncate_and_normalize
    from tpuseg_torch.infer import sliding_window
    from tpuseg_torch.infer.serving import SegServer
    from tpuseg_torch.infer.volume import hu_code_volume, infer_volume, infer_volume_device
    from tpuseg_torch import io_native
    from tpuseg_torch.kernels import (_build, conv3d, conv_int8, flat_conv, fused_norm,
                                      packed_conv, slab_conv)
    from tpuseg_torch.kernels.resample import resize_volume_device, warp_3d
    from tpuseg_torch.losses import build_loss, ms_ssim
    from tpuseg_torch.metrics import seg3d, ssim
    from tpuseg_torch.models import (build_model, resunet_packed, stunet_packed, unet_packed,
                                     vnet_packed)
    from tpuseg_torch.models.smt import PRESETS as smt_presets
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.nn import layers
    from tpuseg_torch.tasks.multitask import make_vsnet_trainer
    from tpuseg_torch.tasks.registration import make_registration_trainer
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig
    from tpuseg_torch.tools import dataprep, evaluate
    from tpuseg_torch.io_native import image as io_image
    from tpuseg_torch.tools.profiling import (conv_backward_split, request_stages,
                                              swin_forward_split, synthetic_ct, traced_busy,
                                              traced_split, train_step_kernel_split)

    zoo_golden = _load_generator("make_torch_port_zoo_golden")
    regtp_golden = _load_generator("make_torch_port_regtp_golden")
    model_api_golden = _load_generator("make_torch_port_model_api_golden")
    mlp2d_golden = _load_generator("make_torch_port_mlp2d_golden")
    attn_golden = _load_generator("make_torch_port_attn_golden")
    if "jax" in sys.modules:
        fail("jax was imported")
    disable_tf32()

    say("phase 1: device")
    smi = nvidia_smi()
    say(f"  nvidia-smi: {smi}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    say("phase 2: build")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    say(f"  built {_build.library_path().name} in {build_s:.2f} s")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill", "C75")):
            say(f"  ptxas {line.strip()}")
    t0 = time.perf_counter()
    built = not io_native.library_path().is_file()
    io_native.library()
    say(f"  C++ host library {io_native.library_path().name} "
        f"{'built' if built else 'found'} and loaded in {time.perf_counter() - t0:.2f} s")

    mods = dict(
        serve=serve, train=train, parse_cli=parse_cli, SegServer=SegServer,
        conv3d=conv3d, fused_norm=fused_norm, packed_conv=packed_conv, layers=layers,
        conv_int8=conv_int8, int8_split=int8_split,
        unet_packed=unet_packed, vnet_packed=vnet_packed,
        packed_unet3d_apply=unet_packed.packed_unet3d_apply,
        pack_k3_to_k3_coarse=vnet_packed.pack_k3_to_k3_coarse,
        pack_k3_axes=vnet_packed.pack_k3_axes, read_nifti=read_nifti,
        write_nifti=write_nifti, synthetic_ct=synthetic_ct, UNet=UNet,
        seeded_unet_params=seeded_unet_params, unet_params_from_jax=unet_params_from_jax,
        make_segmentation_trainer=make_segmentation_trainer, build_loss=build_loss,
        step_generator=step_generator, slab_conv=slab_conv, flat_conv=flat_conv,
        kmicro=kmicro, kmicro2=kmicro2, kmicro3=kmicro3, kbench=kbench, VNet=VNet,
        seeded_vnet_params=seeded_vnet_params, vnet_params_from_jax=vnet_params_from_jax,
        hu_code_volume=hu_code_volume, truncate_and_normalize=truncate_and_normalize,
        resample_to_spacing=resample_to_spacing, sliding_window=sliding_window,
        sliding_window_inference=sliding_window.sliding_window_inference,
        sliding_window_inference_pipelined=sliding_window.sliding_window_inference_pipelined,
        MutilUNet3dModel=MutilUNet3dModel, MutilVNet3dModel=MutilVNet3dModel,
        traced_busy=traced_busy, swin_forward_split=swin_forward_split,
        train_step_kernel_split=train_step_kernel_split, smi=smi, build_model=build_model,
        traced_split=traced_split, conv_backward_split=conv_backward_split,
        io_native=io_native, request_stages=request_stages,
        infer_volume=infer_volume, infer_volume_device=infer_volume_device, seg3d=seg3d,
        evaluate=evaluate, ssim=ssim, ms_ssim=ms_ssim,
        resize_volume_device=resize_volume_device,
        stunet_packed=stunet_packed, zoo_golden=zoo_golden, regtp_golden=regtp_golden,
        model_api_golden=model_api_golden, mlp2d_golden=mlp2d_golden,
        attn_golden=attn_golden, smt_presets=smt_presets, make_vsnet_trainer=make_vsnet_trainer,
        inference=inference, augment2d=augment2d, dataprep=dataprep, io_image=io_image,
        Trainer=Trainer, TrainerConfig=TrainerConfig,
        augment3d=augment3d, recipes=recipes, warp_3d=warp_3d,
        make_registration_trainer=make_registration_trainer,
        packed_resunet3d_apply=resunet_packed.packed_resunet3d_apply,
        packed_stunet3d_apply=stunet_packed.packed_stunet3d_apply,
        zoo_weights={
            "resunet3d": (zoo_weights.seeded_resunet_params,
                          zoo_weights.resunet_params_from_jax),
            "stunet3d": (zoo_weights.seeded_stunet_params, zoo_weights.stunet_params_from_jax),
            "kiunet3d": (zoo_weights.seeded_kiunet_params, zoo_weights.kiunet_params_from_jax),
            "unet3dthin": (zoo_weights.seeded_unet_thin_params,
                           zoo_weights.unet_thin_params_from_jax),
            "vnet3dregistration": (zoo_weights.seeded_registration_params,
                                   zoo_weights.registration_params_from_jax),
            "tpddnet": (zoo_weights.seeded_tpddnet_params,
                        zoo_weights.tpddnet_params_from_jax)})
    return mods, smi


def main() -> int:
    import torch

    mods, smi = setup(torch)
    say(f"phase 3: kernels vs plain ({smi})")
    kernels = phase_kernels(torch, mods)

    say("phase 4: golden")
    phase_golden(torch, mods)

    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        say(f"phase 5: serving ({smi})")
        serve_launches, served = phase_serve(torch, mods, workdir)
        say(f"phase 6: training ({smi})")
        train_paths, ctx = phase_train(torch, mods, workdir)
        train_paths.update(phase_train_packed(torch, mods, workdir, ctx))
        del ctx
        say(f"phase 6b: the rest of the trained 3D zoo ({smi})")
        zoo_paths, zoo_in_rows = phase_zoo(torch, mods, workdir)
        train_paths.update(zoo_paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 7: K2 micro-benchmarks ({smi})")
    bench_rows, bench_launches = phase_bench(torch, mods)
    say(f"phase 8: sliding window ({smi})")
    swin_launches, swin_rows = phase_swin(torch, mods)
    say(f"phase 9: the host layer and the evaluator ({smi})")
    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        host_paths = phase_host(torch, mods, served, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 10: augmentation, registration and TPDDNet ({smi})")
    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        augreg_paths = phase_augreg(torch, mods, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 11: the 2D, classification and GAN Model API ({smi})")
    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        model_api_paths, model_api_norm_rows, resnet3d_rows = phase_model_api(
            torch, mods, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 12: recipes, folder inference, augment2d, --train.profile, UNeXt2d and "
        f"AmlpUNet2d ({smi})")
    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        entry_paths = phase_entry_points(torch, mods, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 13: the attention zoo, SMT and VSNet ({smi})")
    attn_paths, attn_rows = phase_attention(torch, mods)
    say(f"phase 14: parallelism, 2 ranks on the one card over gloo ({smi})")
    par_paths, split_rows, nccl = phase_parallel(torch, mods)
    say(f"phase 15: the opt-in variants: int8, the shift form, k4s2, the packed losses, "
        f"the GEMM fast path ({smi})")
    var_paths, int8_rows, var_numbers = phase_variants(torch, mods)
    say("variants " + json.dumps(var_numbers))

    summary = []
    # (name in the line, phase 3 rows, dtype, source, what it replaces): the
    # f32 conv runs the 3xTF32 kernels on the served and f32 training
    # paths, the bf16 conv the bf16 kernels on the mixed-precision training
    # paths and the bench path (kbench's chains).  K3's dX (K3 on the
    # flip-transposed weight) and dW (K2's dW kernel on the fine views)
    # replace XLA's VJP of the dense coarse conv JAX trains through
    # (`packed_k3_conv`): its Pallas K3 has no VJP
    k3_vjp = "tpuseg/models/vnet_packed.py:723 (XLA's VJP of packed_k3_conv)"
    entries = [
        ("conv3d_small", "conv3d_small", "float32", "conv3d_small_tf32.cu",
         "tpuseg/kernels/conv3d.py:100"),
        ("conv3d_small_dx", "conv3d_small_dx", "float32", "conv3d_small_tf32.cu",
         "tpuseg/kernels/conv3d.py:161"),
        ("conv3d_small_dw", "conv3d_small_dw", "float32", "conv3d_small_dw_tf32.cu",
         "tpuseg/kernels/conv3d.py:161"),
        ("conv3d_small_tc", "conv3d_small", "bfloat16", "conv3d_small_tc.cu",
         "tpuseg/kernels/conv3d.py:100"),
        ("conv3d_small_tc_dx", "conv3d_small_dx", "bfloat16", "conv3d_small_tc.cu",
         "tpuseg/kernels/conv3d.py:161"),
        ("conv3d_small_dw_tc", "conv3d_small_dw", "bfloat16", "conv3d_small_dw_tc.cu",
         "tpuseg/kernels/conv3d.py:161"),
        ("fused_group_norm_relu", "fused_group_norm_relu", "float32", "fused_norm.cu",
         "tpuseg/kernels/fused_norm.py:74"),
        ("fused_group_norm_relu_bwd", "fused_group_norm_relu_bwd", "float32",
         "fused_norm_bwd.cu", "tpuseg/kernels/fused_norm.py:136"),
        ("packed_conv3d_structured", "packed_conv3d_structured", "float32",
         "packed_conv_tc.cu", "tpuseg/kernels/packed_conv.py:184"),
        ("packed_conv3d_structured_dx", "packed_conv3d_structured_dx", "float32",
         "packed_conv_tc.cu", k3_vjp),
        ("packed_conv3d_structured_dw", "packed_conv3d_structured_dw", "float32",
         "conv3d_small_dw_tf32.cu", k3_vjp),
    ]
    paths = {"serve": serve_launches, **train_paths, "bench": bench_launches,
             **swin_launches, **host_paths, **augreg_paths, **model_api_paths,
             **entry_paths, **attn_paths, **par_paths, **var_paths}

    def per_pass(rows, field):
        """One forward's (or train step's) worth of calls at the path shapes."""
        return sum(r[field] * r["uses"] for r in rows)

    def pass_fields(rows):
        return {f: per_pass(rows, f) for f in ("ms", "plain_ms", "bound_ms")}

    for name, key, dtype_name, source, replaces in entries:
        all_rows = [r for r in kernels[key] if r["dtype"] == dtype_name]
        # K3's backward rows: the packed UNet3d step's in the entry, the
        # packed VNet3d step's in a sub-entry
        rows = [r for r in all_rows if r["path"] in (None, "unet")]
        if key.startswith("conv3d_small"):
            # a dtype's kernels run on that dtype's paths
            by_path = {p: c[key] for p, c in paths.items()
                       if (p.endswith("_bf16") or p == "bench") == (dtype_name == "bfloat16")}
        else:
            by_path = {p: c[key] for p, c in paths.items()}
        launches = sum(by_path.values())
        if launches == 0:
            fail(f"{name} was not launched on the serving, training or bench path")
        lib = [r["library_ms"] for r in rows]
        entry = {
            "name": name, "route": "cuda", "dtype": dtype_name,
            "source": f"tpuseg_torch/kernels/csrc/{source}", "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            **pass_fields(rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"],
            "peak_tflops": rows[0]["peak_flops"] / 1e12,
            "library_ms": None if None in lib else per_pass(rows, "library_ms"),
        }
        if dtype_name == "float32" and (key.startswith("packed_conv3d_structured")
                                        or key.startswith("conv3d_small")):
            # the f32 route is 3xTF32 on the tensor cores: its error against
            # the plain version beside the f32 gate
            entry["tf32x3"] = {"max_err_over_scale": max(r["max_abs_err"] / r["scale"]
                                                         for r in all_rows),
                               "gate": TOL["float32"]}
        if key in zoo_in_rows:
            # STUNet3d's InstanceNorms: K1 at one channel per group, no
            # ReLU, one f32 forward's (or backward's) calls at 96^3
            zrows = [r for r in zoo_in_rows[key] if r["dtype"] == dtype_name]
            entry["zoo_instance_norm"] = dict(
                pass_fields(zrows), library_ms=per_pass(zrows, "library_ms"),
                max_abs_err=max(r["max_abs_err"] for r in zrows))
        if key in model_api_norm_rows:
            # phase 11: UNet2d's GroupNorms at 8 x 512^2 and the pix2pix
            # discriminator's InstanceNorms up to 1024 channels on 4 x 4
            mrows = model_api_norm_rows[key]
            entry["model_api_2d"] = dict(
                pass_fields(mrows), library_ms=per_pass(mrows, "library_ms"),
                max_abs_err=max(r["max_abs_err"] for r in mrows))
        if dtype_name == "float32" and attn_rows.get(key):
            # phase 13: one smt_t forward's and one VSNet forward's calls
            arows = attn_rows[key]
            entry["attention"] = dict(
                pass_fields(arows), library_ms=per_pass(arows, "library_ms"),
                max_abs_err=max(r["max_abs_err"] for r in arows))
        if (key, dtype_name) in resnet3d_rows:
            # phase 11: one ResNet3d forward's calls at 2 x 96^3
            entry["model_api_resnet3d"] = resnet3d_rows[(key, dtype_name)]
        vrows = [r for r in all_rows if r["path"] == "vnet"]
        if vrows:
            entry["train_vnet_packed"] = dict(pass_fields(vrows), library_ms=per_pass(
                vrows, "library_ms"))
        for path, path_rows in swin_rows.items():
            # one sliding-window forward's calls at its batch (phase 8): 27
            # VNet3d patches (plain, and the packed twin's K3), 8 packed
            # UNet3d ones; the bf16 instantiation's beside K1's and K3's
            if (key, dtype_name) in path_rows:
                entry[path] = path_rows[(key, dtype_name)]
                if (key, "bfloat16") in path_rows and key in ("fused_group_norm_relu",
                                                              "packed_conv3d_structured"):
                    entry[path]["bfloat16"] = path_rows[(key, "bfloat16")]
        if not key.startswith("conv3d_small"):
            # the same kernel's bf16 instantiation, timed in phase 3
            bf = [r for r in kernels[key] if r["dtype"] == "bfloat16"
                  and r["path"] in (None, "unet")]
            entry["bfloat16"] = pass_fields(bf)
            entry["bfloat16"]["bound_by"] = max(
                bf, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"]
            entry["bfloat16"]["peak_tflops"] = bf[0]["peak_flops"] / 1e12
            entry["bfloat16"]["library_ms"] = (
                None if None in [r["library_ms"] for r in bf] else per_pass(bf, "library_ms"))
        summary.append(entry)
    # the probe kernels: the variant that computes the whole conv (K4 full,
    # K6 with the concat built in the kernel), every variant beside it
    for name, replaces, main_tag in (
            ("slab_conv", "benchmarks/kmicro_r2.py:65, benchmarks/kmicro2_r2.py:88", "K4 full"),
            ("flat_conv", "benchmarks/kmicro3_r2.py:100,113", "K6 cat")):
        rows = bench_rows[name]
        launches = bench_launches[name]
        if launches == 0:
            fail(f"{name} was not launched on the bench path")
        top = rows[main_tag]
        summary.append({
            "name": name, "route": "cuda", "source": f"tpuseg_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "variants": {tag: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by")} for tag, r in rows.items()},
        })
    # K1 split (phase 14): per call on a rank's z-shard of the UNet3d's
    # finest level, f32 (the bf16 call beside it); ms is the split call on
    # a line of one (its kernels), ms_with_gloo_gather the same call on the
    # 2-rank line of one card, the all-gather staged through the host
    for name, pre, source in (
            ("fused_group_norm_relu_split", "", "fused_norm.cu"),
            ("fused_group_norm_relu_split_bwd", "bwd_", "fused_norm_bwd.cu")):
        by_path = {p: c.get(name, 0) for p, c in paths.items() if c.get(name, 0)}
        if not by_path:
            fail(f"{name} was not launched on the parallel paths")

        def fields(row):
            return {"ms": row[f"{pre}ms"], "ms_with_gloo_gather": row[f"{pre}ms_gloo"],
                    "plain_ms": row[f"{pre}plain_ms"], "bound_ms": row[f"{pre}bound"][0],
                    "bound_by": row[f"{pre}bound"][1],
                    "library_ms": row[f"{pre}library_ms"]}

        rows = [r for r in split_rows if r["c"] == PAR_SPLIT_CASES[0][0]]
        f32 = next(r for r in rows if r["dtype"] == "float32")
        summary.append({
            "name": name, "route": "cuda", "dtype": "float32",
            "source": f"tpuseg_torch/kernels/csrc/{source}",
            "replaces": ("tpuseg/kernels/fused_norm.py:85,102 around the psum of "
                         "tpuseg/parallel/spatial.py:174-196" if not pre else
                         "tpuseg/kernels/fused_norm.py:137 (the VJP across the psum)"),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r[f"{'bwd' if pre else 'fwd'}_err"][0] for r in split_rows),
            **fields(f32), "shape": f32["shape"],
            "bfloat16": fields(next(r for r in rows if r["dtype"] == "bfloat16")),
            "c64": fields(next(r for r in split_rows if r["c"] == PAR_SPLIT_CASES[1][0]
                               and r["dtype"] == "float32"))})
    # the W8A8 int8 route (phase 15): one 27-patch forward's calls of the
    # packed twin under int8_packed_inference, the plain net's under
    # int8_inference beside it, and a plain UNet3d volume's (its forwards'
    # calls) under int8_inference: the conv's dense mode, its structured
    # mode (the twin's packed k3s), the mma.sync kernel (the UNet3d's
    # decoder k3 at 16x14x14) and the quantizer
    def int8_fields(rows, library=True):
        lib = [r["library_ms"] for r in rows]
        return dict(pass_fields(rows),
                    library_ms=None if not library or None in lib else per_pass(rows,
                                                                                "library_ms"),
                    bound_by=max(rows, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"],
                    max_abs_err=max(r["max_abs_err"] for r in rows))

    def int_mm_rows(rows):  # the 1x1 rows torch._int_mm takes: kernel and library
        rows = [r for r in rows if r["library_ms"] is not None]
        return {"ms": per_pass(rows, "ms"), "library_ms": per_pass(rows, "library_ms"),
                "calls": sum(r["uses"] for r in rows)} if rows else None

    int8_src = "tpuseg_torch/kernels/csrc/"
    int8_paths = ("vnet_packed_int8", "vnet_int8", "unet_int8")  # the first with rows leads
    for name, src, replaces, sel in (
            ("conv_int8", "conv_int8.cu",
             "tpuseg/models/vnet_packed.py:396 and tpuseg/nn/layers.py:152 "
             "(lax.conv_general_dilated on int8, an XLA op: no Pallas kernel)", "dense"),
            ("conv_int8_structured", "conv_int8.cu",
             "tpuseg/models/vnet_packed.py:738-742 (the packed k3 as a dense coarse "
             "lax.conv_general_dilated on int8 through _conv_int8: no Pallas kernel)",
             "structured"),
            ("conv_int8_sync", "conv_int8_sync.cu",
             "tpuseg/nn/layers.py:152 (lax.conv_general_dilated on int8, an XLA op: no "
             "Pallas kernel) at the shapes whose brick does not fit conv_int8.cu's block",
             "sync"),
            ("quantize_int8", "quantize_int8.cu",
             "tpuseg/nn/layers.py:151-153 and tpuseg/models/vnet_packed.py:402-404 "
             "(jnp ops, fused by XLA: no Pallas kernel)", "quantize")):
        by_path = {p: c[name] for p, c in var_paths.items() if c[name]}
        if not by_path:
            fail(f"{name} was not launched on the int8 paths")
        if sel == "quantize":
            per_path = {p: int8_rows[f"quantize {p}"] for p in int8_paths}
        else:
            per_path = {p: [r for r in int8_rows[p] if r["mode"] == sel] for p in int8_paths}
        lead = next(p for p in int8_paths if per_path[p])
        entry = {"name": name, "route": "cuda", "dtype": "int8", "source": int8_src + src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "rows_of": lead, **int8_fields(per_path[lead]),
                 "peak_tops": PEAK_INT8_OPS / 1e12}
        if sel != "quantize":
            entry["library"] = ("torch._int_mm (int8 x int8 -> int32) where every call is a "
                                "1x1 it takes, else null; cuDNN's bf16 conv of the shape "
                                "(another function) as cudnn_bf16_ms")
            entry["cudnn_bf16_ms"] = per_pass(per_path[lead], "cudnn_bf16_ms")
            entry["int_mm_1x1"] = int_mm_rows(per_path[lead])
        if sel == "structured":
            entry["dense_mode_ms"] = per_pass(per_path[lead], "dense_mode_ms")
        for p in int8_paths:
            if p != lead and per_path[p]:
                entry[p] = int8_fields(per_path[p])
                if sel != "quantize":
                    entry[p]["cudnn_bf16_ms"] = per_pass(per_path[p], "cudnn_bf16_ms")
                    entry[p]["int_mm_1x1"] = int_mm_rows(per_path[p])
        entry["rows"] = per_path
        summary.append(entry)
    say("nccl " + json.dumps(nccl, default=str))
    # the stem's one-product weight gradient (torch.matmul, not a kernel of
    # the package), a train step's calls of each packed net beside cuDNN's
    stem = {f"{r['path']} {r['dtype']}": {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "max_abs_err")}
            for r in kernels["stem_dw_gemm"]}
    say("stem_dw_gemm " + json.dumps({"per_step": stem, "launches_by_path": {
        p: c["stem_dw_gemm"] for p, c in paths.items() if c["stem_dw_gemm"]}}))
    say(json.dumps({"kernels": summary}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
