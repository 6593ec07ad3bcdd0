#!/usr/bin/env python3
"""Drive the PyTorch port of the detector on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the script exits
non-zero and never prints its last line):
  1. device: torch/CUDA versions, the card's name and power limit; TF32 off
     for the parity phases.
  2. build: compile csrc/*.cu with nvcc, one process per source, all started
     together (seconds and ptxas resource lines).
  3. kernels vs their plain PyTorch twins at the shapes of the paths: NMS
     at (8, 2048) -> 300 @ 0.7, (16, 300) -> 100 @ 0.6 (image serving),
     (8, 4096) -> 2000 @ 0.7 (training), (8, 1100) -> 300 @ 0.7 and
     (16, 300) -> 100 @ 0.6 (BEV serving), (8, 1024) -> 1024 slots @ 0.7
     (BEV training) must keep identical lanes (each check also prints the
     sort, mask and scan kernels' device times apart, from torch.profiler,
     beside the replaced kernels' (REPLACED_NMS_MS)), and so must 4,000
     problems of two boxes whose IoU lies a float32 step or two from each
     threshold's midpoint (check_nms_near_mid); RoI
     align at features
     (8, 32, 60, 1024) and (8, 25, 22, 1024) x 300 rois and (8, 25, 22,
     1024) x 256 (BEV training) within 1e-5 * max|F| (float32) and 1e-2 *
     max|F| (bfloat16, rounded output), its time printed beside the
     replaced kernel's (REPLACED_FWD_MS); the RoI-align backward at
     (8, 32, 60, 1024) and (8, 25, 22, 1024) x 256 rois: every element
     within the sum-order limit of the twin's autograd gradient on CPU
     copies (sum_order_tolerance: 64 float32 eps times the summed
     magnitudes of its contributions, plus one bf16 ulp for bfloat16; the
     max|dF|-relative error is printed beside it), and two runs bitwise
     equal; the BEV
     voxelizer at (8, 32768) points -> 400 x 350 x 15 and
     (8, 180000) -> 800 x 700 x 15, with points on cell and slice
     boundaries, invalid lanes, points out of range, over-full voxels and an
     all-invalid frame, and at both sizes once more with frame 0's points
     all in one tile of the raster (skew_points): height and density
     channels equal, and equal over two runs, the meta channels within
     1e-5 (float sums in arrival order), times beside the replaced
     kernel's (REPLACED_VOX_MS).  Forward results are
     compared with the twins on CPU copies, the backwards too.  Each kernel's time is device time (CUDA events, the median
     of 5 windows queued while the card sleeps, so the host's launch time is
     not in it: kernel_ms), beside the twin's time on the card (back to
     back, host included) and the least time the card could take (the
     larger of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s).
  4. the image serving slice at res101, float32, one 256x320 frame: card
     (kernels) against CPU (twins).
  5. the image serving path: the image config at test settings, compute
     dtype bfloat16, SyntheticDataset 512x960, batch 8, one warm-up batch
     then 3 batches through inference.evaluate.  Outputs must be finite,
     every frame must have proposals, and NMS and RoI align must have
     launched.
  6. the training slice at res101, float32, one 256x320 frame, ROI_BATCH_SIZE
     64, NMS_PRE_TRAIN 1024 -> 256: card against CPU on the same random
     draws, the card's second stage pinned to the CPU's proposal lanes.
     Equal anchor and RoI samples, the four losses within rtol 1e-3, the
     gradients of six trainable leaves within 1e-3 * max|g| of each leaf.
  7. the training path: the image config (res101, bf16), SyntheticDataset
     512x960 through the BatchLoader, batch 8, one warm-up step then 10
     steps of training.solver.train.  Every loss finite at every step; NMS,
     RoI align and its backward must have launched.
  8. the BEV serving slice at res101, float32, one synthetic 400 x 350 x 15
     frame: card (kernels) against CPU (twins): raster, C4 features,
     fg_prob, proposals, cls_prob and 7-DoF boxes pinned to the CPU's rois
     and 3D anchors, final detections.
  9. the BEV serving path: the BEV config (res101 LiDAR, 0.2 m voxels,
     400 x 350 x 15 raster, 1,100 anchors a frame) at test settings, bf16,
     batch 8 of synthetic LiDAR frames (32768 padded points) through the
     BatchLoader (voxelize_bev on the card) and inference.evaluate, one
     warm-up batch then 3 batches.  Outputs finite, proposals in every
     frame, voxelize_bev, NMS and RoI align launched.
 10. the BEV training slice at res101, float32, one synthetic 400 x 350 x 15
     raster with 7-DoF GT, as phase 6: card against CPU on the same draws,
     equal samples, losses within rtol 1e-3, leaf gradients within 1e-3 *
     max|g|.
 11. the BEV training path: the BEV config (the JAX bench's bev_config:
     frozen BN, RPN_POST_NMS_TOP_N 2000, NMS_PRE_TRAIN 1024, MAX_GT 64),
     bf16, batch 8 of synthetic LiDAR frames through the BatchLoader
     (voxelize_bev on the card), one warm-up step then 10 steps.  Every loss
     finite; voxelize_bev, NMS, RoI align and its backward launched.
 12. the rotated BEV serving path: phase 9 with TEST.ROTATED_NMS and
     TEST.NMS_THRESH 0.3.  The rotated NMS kernel must launch once a batch
     and the axis-aligned one that much less than in phase 9; ms, frames/s
     and peak memory beside phase 9's.  Then the rotated NMS checks of
     phase 3 (rotated_case) on what the path's final filter gave NMS in its
     first batch (filter_nms_inputs), with the share of pairs whose
     bounding circles meet.
 13. the FPN slices at res101, float32, one 256x320 frame, serving and
     training, card against CPU as in phases 4 and 6 (the pyramid p2..p5 in
     place of the C4 map; the FPN, layer4 and FCTail among the leaves).
 14. the FPN serving path: the FPN config (the image config with USE_FPN and
     multiscale pooling: the RPN on p2 at stride 4, 768,000 anchors a frame)
     at test settings, bf16, batch 8, 512x960, one warm-up batch then 3
     batches.  The multiscale RoI-align kernel must have launched and the
     single-level one not.
 15. the FPN training path: the FPN config, bf16, batch 8, one warm-up step
     then 10 steps; the multiscale kernel and its backward must have
     launched.  Then anchor_target alone at (8, 768000 anchors, 64 GT):
     time and peak memory.
 16. the live-BN slices (RESNET.FIXED_BLOCKS -1) at res18, float32: one
     256x320 frame and one 400 x 350 x 15 BEV raster, a training forward
     and backward card against CPU on the same draws, the card's second
     stage pinned to the CPU's proposal lanes and each ReLU unit whose
     input takes another sign on the card given the CPU's gate: equal
     samples, losses within rtol 1e-3, every leaf's gradient within 1e-3 *
     max|g|, the running statistics within 1e-5 of max; then in eval mode
     on those statistics the serving slice's checks (check_live_slice).
 17. the live-BN training path: the image config with FIXED_BLOCKS -1
     (res101, live BN everywhere, zero-init terminators), bf16, batch 8,
     512x960, one warm-up step then 10 steps: ms/step (median, min, max),
     frames/s, peak memory; the running statistics float32, finite and
     moved from their init.
 18. the res18 live-BN BEV path: the BEV config at res18 with FIXED_BLOCKS
     -1, one warm-up step then 10 steps, then one serving batch of the
     trained model cast by to_device (bf16, eval mode, float32 running
     statistics).
 19. the UC slices: res50 float32 with every UC.* flag, one 256x320 frame
     and one 400 x 350 x 15 BEV raster, card against CPU on the same
     weights, dropout masks and normals (drawn on the CPU and recorded,
     UCDraws(record=True)): forward_test with the card's second stage and
     RPN uncertainties pinned to the CPU's proposals, cls_prob, boxes and
     the 8 detection and 8 RPN uncertainty keys (within 1e-3 of max, plus
     the float32 rounding of what e_cls_var and the mutual informations
     cancel: uc_slack); then a training forward and backward, pinned to the
     CPU's lanes and ReLU gates: equal samples, the losses and a_mutual_info
     within rtol 1e-3, every leaf's gradient within 1e-3 * max|g|.
 20. the UC serving path: the JAX bench's uncertainty_config (the image
     config with class and box aleatoric and epistemic uncertainty, T = 10
     MC samples, 200 logit draws) at test settings, res101 bf16, batch 8,
     512x960, one warm-up batch then 3: ms/batch, frames/s, peak memory;
     NMS exactly twice and RoI align exactly once a batch (the RoIs pooled
     once, the tail and predictors run for each sample); the 8 uncertainty
     keys finite and e_bbox_var nonzero somewhere.
 21. the UC training path: uncertainty_config from scratch (FIXED_BLOCKS
     -1: with frozen BN and random weights each Bottleneck's drop3 doubles
     the residual stream's second moment and the class log-variance's exp
     overflows, in JAX's step too), res101 bf16, batch 8, one warm-up step
     then 10 (the dropout layers live, the Bayesian cross-entropy, the
     attenuated box loss): every loss finite; NMS, RoI align and its
     backward launched.
 22. the BEV UC training path: bev_uncertainty_config (bev_config with the
     same flags, the stacks' BN) from scratch, 10 steps, then one serving
     batch of the trained model: the voxelizer, NMS, RoI align and its
     backward launched.
 23. the Solver path (image): the image config (res101 C4, bf16, batch 8,
     512x960, frozen BN, terminators at 0.25) through training.solver.Solver
     with synthetic train and val loaders, the train loader's prefetch on,
     the val cycle every 5 steps (val losses and activation summaries;
     TRAIN.DRAW_VAL_DETECTIONS False, so that the script needs no PIL),
     snapshots at 10
     and 20, 20 steps; then a new Solver in the same output directory resumes
     from iter_10 and runs to 20: its losses within rtol 1e-3 of the first
     run's (bitwise equality printed too).  NMS, RoI align and its backward
     launched.  The Solver's wall ms a step and frames/s, the loader's host
     ms a batch (next() without prefetch) and the bare train loop's ms a step,
     each with the card's name and power limit (run_solver_path).
 24. the Solver path (BEV): the BEV training config, 10 steps with a
     snapshot at 5, then a resume to 10 held as in 23; the voxelizer must
     have run in the prefetch thread, NMS, RoI align and its backward in
     the steps.
 25. the dataset path (Waymo lidar), run_waymo_path: a seeded tree in the
     unpacked layout WaymoDB reads (24 train and 8 val frames of
     160,000-180,000 points, 10-40 vehicles and some don't-care boxes a
     frame, per-box difficulty and point counts) under build/;
     bev_config with STATIC.MAX_POINTS 180000 and the lidar augmentation
     on (every native op runs).  The first 3 batches of BatchLoader(
     workers=4) equal the serial loader's: every host array and the points
     bitwise (rasterize off), then in Solver.train the rasters (height and
     density bitwise, meta within 1e-5); K3 from the collector thread;
     a batch's round trip through a spawn-context queue (the workers'
     pipe, 28.8 MB).  Solver.train for 10 steps with 4 workers, again with
     the prefetch thread alone, then 5 steps of the bare train loop, each
     counted (K1, K2, K2-bwd, K3 launched); the loader's host ms a batch
     (next() without prefetch, median of 5), the Solver's wall ms a step,
     the median ms between batches handed out after the first and over
     the last 10 steps (the batches drawn ahead used up) and frames/s, and
     the bare loop's device and wall ms a step, with the card's name and
     power limit; K3 against its twin on a loader batch's points, (8,
     180000) -> (8, 400, 350, 15); tools/test_net_torch.py --db waymo
     --eval_det on the val split from the 4-worker run's snapshot: L1/L2
     AP, det files, counted.
 26. the dataset path (KITTI lidar), run_kitti_path: a seeded KITTI tree
     (16 train and 8 val frames of ~120,000 points; Car, Pedestrian,
     Cyclist and DontCare lines of all three difficulties; the camera-FOV
     crop keeps about a quarter of the points); the test-time rain and
     dropout once, bitwise the native library's on the same draws;
     Solver.train for 5 steps with 2 workers and the augmentation, then
     tools/test_net_torch.py --db kitti --eval_det (easy/moderate/hard AP),
     both counted.  Image databases are not run here (the card's machine has
     no cv2); tests/test_torch_port_datasets.py holds them on the CPU.
 27. the VGG16 and MobileNet slices (MobileNet at depth multiplier 1),
     float32: the image serving slice (phase 4's checks), the image
     training slice (phase 6's, the gradients of fc6 / fc7 and the first
     and last convs, or of layers 12-13, layer 11 and conv0), the BEV
     serving slice (phase 8's; VGG16's map floors 350 to 21 columns) and
     the BEV training slice, card against CPU.
 28. the VGG16 image path: the image config with NET_VARIANT vgg16, bf16,
     b8, 512x960: one warm-up batch then 3 serving batches, then one
     warm-up step then 10 training steps (run_serving, run_training).
 29. the MobileNet image path: the same with NET_VARIANT mobile.
 30. FPN x UC: the UC slice (phase 19's checks, res50 fp32, every UC flag,
     the RPN's epistemic samples over the whole pyramid) on the FPN
     detector; then the FPN config with the four det-stage flags of
     bench.py's uncertainty_config at T = 10: the serving path (NMS
     exactly twice and the multiscale RoI align exactly once a batch, the
     single-level one never) and 10 training steps from scratch (live BN).
 31. FPN on BEV rasters: the BEV config with USE_FPN and multiscale
     pooling (the RPN on p2 100 x 88 of the 400 x 350 raster): the BEV
     serving and training slices card vs CPU, the serving path, once more
     with TEST.ROTATED_NMS, 10 training steps (K2-FPN and its backward,
     never K2), then K2-FPN and K2-FPN-bwd against their twins over the
     BEV pyramid (p2 100 x 88 .. p5 13 x 11) on the RoIs the path's first
     serving batch and first training step pooled.
 32. data parallel on one card (run_data_parallel): two ranks spawned once
     (parallel.multihost.spawn_ranks, after the build) share cuda:0 over
     gloo (NCCL refuses two ranks on one device).  (a) the 2-rank step
     against the one-process step on the card, fp32, TF32 off: res101 image
     C4 at 256x320 and a global batch of 2 (2 x 1), once more with the two
     ranks' frames of two sizes (256x320 and 320x448: each rank's loader
     pads its row to the global batch's bucket, MixedSizes), then res18
     live BN at 4 (2 x 2), the one-process step pinned to the ranks' proposal lanes and
     ReLU gates (dp_check): equal labels, losses within rtol 1e-4, each
     leaf's update within 1e-3 of its max, the running statistics within
     1e-5.  (b) Solver.train for 10 steps of the image config (res101 C4
     bf16 512x960) and of bev_config, a global batch of 8 as 2 ranks x 4:
     each rank's K1, K2, K2-bwd (and K3 on BEV) launched and counted, its
     device ms a step, its gradient all-reduce's ms a step, wall ms a step
     and peak memory, printed beside the one-process Solver paths of 23-24
     (two ranks sharing one card measure the collective's cost, not a
     speed-up).  A failed rank fails the phase.
Phase 3 also holds the multiscale RoI-align kernels against their twins at
the FPN shapes: maps (8, 128, 240, 256) .. (8, 16, 30, 256), (8, 300) RoIs
of 16-900 px (every level gets RoIs, every RoI on the twin's level) within
1e-5 / 1e-2 * max|F| (its bound reads only the tap rows the RoIs hit on
their levels; times beside the replaced kernel's, REPLACED_MS_FWD_MS), and
once with every RoI on p2, many of them wide enough for a one-row ring
(p2_rois), the backward at dOut (8, 256, 7, 7, 256) within the
sum-order limit on every level and bitwise equal over two runs, and once
with every RoI on p5 (times beside the replaced kernel's,
REPLACED_MS_BWD_MS); and the
rotated NMS at the BEV final filter's shape, (16, 300) -> 100 @ 0.3, on
rotated boxes in voxel units, half of them clustered, then on dense ones
(every box of a problem in one 40-voxel square, so that every pair clips),
also at threshold 0: its IoU kernel within 5e-5 of the twin's IoU (and on
edge cases: identical, nested, shared edge, 90 degrees, zero width,
disjoint), its keeps identical to the twin's on every problem where no
kept lane's pair lies within 1e-4 of the threshold, and on every problem a
tolerant greedy check against the twin's IoU matrix (`greedy_violations`);
RoI align and its backward at the res18 C4 maps' 256 channels, (8, 32,
60, 256) x 300 and (8, 25, 22, 256) x 256, under the same limits; and the
rotated IoU kernel on 300 pairs with collinear sides within 1e-6 of a
float64 oracle (fault F5: the twin, as JAX, is far off there); and RoI
align and its backward at VGG16's and MobileNet's 512-channel C4 maps:
(8, 32, 60, 512) x 300, (8, 25, 21, 512) x 256 (VGG16's floored BEV map),
(8, 25, 22, 512) x 256, the backward onto (8, 32, 60, 512) and (8, 25, 21,
512).
Each path (5, 7, 9, 11, 12, 14, 15, 17, 18, 20-26, 28-31, 32's in each
rank, 33's sections and 34's proposals) runs with the launch counts set to 0 just before it and read just
after.  Then one JSON line describing
the kernels (each kernel's `launches` is the count on the newest path that runs
it: the Waymo dataset path's 4-worker Solver run for the voxelizer (timed on
that path's own batch), the BEV Solver path for NMS, RoI align and its
backward (the BEV training config's shapes), rotated BEV serving for the
rotated NMS, FPN serving and FPN training for the multiscale kernels; its
times, error and bound are from phase 3 at that path's shapes;
`launches_by_path` has every counted path, phase 32's ranks' too
(dp_image_rank0, ...); `at_512_channels` and `bev_pyramid` the checks at
the new nets' shapes), the nvidia-smi name/power line,
and the result line {"ok": true, "device": ...}.  Worker processes are
spawned: this file keeps its `if __name__ == "__main__":` guard, since a
spawned child imports the main module again.
 33. the train step's stage split (tools/profile_step_torch.py, run_profile):
     nested prefixes of the training forward plus backward, each timed
     after warm-up between CUDA events, for the image, bev and fpn configs
     at full width (res101 bf16, batch 8, terminators at 0.25): backbone
     (BEV: the K3 raster first), + the RPN head and its losses, + the
     proposals (K1), + the targets, the full make_train_step (K2, K2-bwd;
     K2-FPN and its backward on FPN).  Each section's losses finite; its
     launches join launches_by_path (profile_<config>_<section>), and
     the kernels each section runs must have launched there.
 34. the debug draws card vs CPU (check_debug_draws): anchor_target_boxes
     and proposal_target_boxes at res101 bf16, batch 8, 512x960, the image
     config: the sampling keys drawn on the CPU and given to both, the card's
     proposal targets pinned to the CPU's proposals (as check_train_slice
     pins the second stage); the box lists and classes equal.  Then the
     card's own proposals (K1 launched) against the CPU's: the share of
     equal lanes, printed.  No PNG is written on the card (no PIL there);
     tests/test_torch_port_debug_draw.py holds the drawing to JAX's.
 35. model parallel on one card (run_model_parallel): four ranks (data 2 x
     model 2) spawned once share cuda:0 over gloo.  (a) the 2 x 2 step
     against the one-process step on the card, fp32, TF32 off, at 256x320
     (BEV 400 x 350 x 15) and a global batch of 2, DP_CHECK_OVERRIDES, the
     one-process step pinned to the ranks' proposal lanes (mp_check): res101
     C4 tp+sp (the tail's channels sharded, the backbone's rows split),
     res101 FPN tp, res101 BEV tp+sp (K3's 400 rows, 25 at stride 16 split
     12 and 13): equal labels, losses within rtol 1e-4, each leaf's update
     within 1e-3 of its max (phase 32's bars).  (b) the image config (res101
     C4 bf16 512x960, terminators 0.25) at MESH.DATA 2 MESH.MODEL 2
     MESH.SPATIAL True through Solver.train for 3 steps: each rank's K1, K2,
     K2-bwd counted, its device ms a step, gradient all-reduce ms, wall ms,
     peak memory and the tail's bytes it holds (half of one process's), then
     one more step with every collective counted (mesh.STATS: the model
     group's forward and backward collectives' calls, bytes and ms, the
     data group's and the optimizer's), beside phase 23's one-process
     Solver path (four ranks sharing one card over gloo measure the
     collectives' cost, not a speed-up).  A failed rank fails the phase.

Imports nothing of JAX; needs the repository checkout around it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "faster_rcnn_pytorch_multimodal_tpu_torch"
B, H_FEAT, W_FEAT, C_FEAT, R = 8, 32, 60, 1024, 300
C_RES18 = 256  # the C4 map of a BasicBlock backbone (res18/34)
C_VGG = 512  # the stride-16 map of VGG16 (conv5_3) and of MobileNet (layer 11) at multiplier 1
VGG_BEV_FEAT_HW = (25, 21)  # VGG16's four 2x2 pools floor 350 to 21 columns
R_TRAIN = 256  # TRAIN.ROI_BATCH_SIZE: RoIs pooled per training frame
FRAME_HW = (512, 960)  # the serving and training frame: 32 x 60 C4 cells at stride 16
BEV_FEAT_HW = (25, 22)  # the 400 x 350 BEV raster at stride 16
BEV_ANCHORS = 25 * 22 * 2  # 2 anchor headings a cell
SLICE_HW = (256, 320)
TRAIN_STEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
IOU_FLOPS = 13  # float32 operations of one IoU pair in the NMS mask
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz: the host queues a window meanwhile
EPS32 = 2.0 ** -23  # float32 machine epsilon
# sum_order_tolerance's factor: float32 rounding errors of a sum of up to
# ~1e4 contributions, random in sign, stay several standard deviations below
# 64 eps times the sum of their magnitudes, in either summation order
SUM_ORDER_FACTOR = 64
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative to the value it rounds

# The image and BEV configurations of the JAX package's bench (bench.py:196-228):
# Waymo front camera at scale 0.5, and Waymo BEV at scale 0.5 (400 x 350 x 15).
IMAGE_OVERRIDES = (
    "NET_TYPE", "image", "NET_VARIANT", "res101", "PIXEL_STDDEVS", "[60.,60.,60.]",
    "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "4096", "STATIC.MAX_GT", "64",
)
BEV_OVERRIDES = (
    "NET_TYPE", "lidar", "NET_VARIANT", "res101", "TRAIN.SCALES", "(0.5,)",
    "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "1024", "STATIC.MAX_GT", "64",
    "STATIC.MAX_POINTS", "32768",
)
SERVING_OVERRIDES = ("STATIC.NMS_PRE_TEST", "2048", "TEST.RPN_POST_NMS_TOP_N", "300")
# bench.py:292-297: the image config with the FPN backbone and multiscale pooling
FPN_OVERRIDES = ("USE_FPN", "True", "POOLING_MODE", "multiscale")
FPN_STRIDES = (4, 8, 16, 32)
FPN_MAP_HW = ((128, 240), (64, 120), (32, 60), (16, 30))  # p2..p5 of a 512x960 frame
BEV_PYRAMID_HW = ((100, 88), (50, 44), (25, 22), (13, 11))  # p2..p5 of a 400 x 350 raster
C_FPN = 256
# the raster grid follows TRAIN.SCALES[0] in the loader; serving sets both
BEV_SERVING_OVERRIDES = SERVING_OVERRIDES + ("TEST.SCALES", "(0.5,)", "COMPUTE_DTYPE", "bfloat16")
# rotated NMS in the final filter at the quality recipe's threshold (tools/quality_run.py:219-222)
ROTATED_OVERRIDES = ("TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3")
# bench.py:276-289 and :308-319 (uncertainty_config, bev_uncertainty_config):
# class and box aleatoric and epistemic uncertainty, UC.E_NUM_SAMPLE 10 MC
# samples, UC.A_NUM_CE_SAMPLE 200 logit draws (the defaults)
UC_OVERRIDES = (
    "UC.EN_BBOX_ALEATORIC", "True", "UC.EN_CLS_ALEATORIC", "True",
    "UC.EN_BBOX_EPISTEMIC", "True", "UC.EN_CLS_EPISTEMIC", "True",
)
# the two nets of the original repo beside ResNet (lib/nets/vgg16.py, mobilenet_v1.py)
VGG_OVERRIDES = ("NET_VARIANT", "vgg16")
MOBILE_OVERRIDES = ("NET_VARIANT", "mobile", "MOBILENET.DEPTH_MULTIPLIER", "1.0")
# the card-vs-CPU UC slices: every flag, the RPN's too
UC_ALL_OVERRIDES = UC_OVERRIDES + (
    "UC.EN_RPN_BBOX_ALEATORIC", "True", "UC.EN_RPN_CLS_ALEATORIC", "True",
    "UC.EN_RPN_BBOX_EPISTEMIC", "True", "UC.EN_RPN_CLS_EPISTEMIC", "True",
    "UC.EN_BBOX_EPISTEMIC_INV_TRANSFORM", "True",
)


def make_config(*overrides):
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config

    cfg = default_config()
    for o in overrides:
        cfg = cfg_from_list(cfg, o)
    return cfg


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_T0 = time.perf_counter()


def sum_order_tolerance(twin_fn, inputs, grad_out, out_dtype=None) -> list:
    """Per-element limits for holding a gradient that sums the twin's
    contributions in another order (the backward kernels' tile gathers) to the
    twin's gradient: SUM_ORDER_FACTOR x EPS32 x S, where S is the twin's
    gradient of |grad_out| taken in float32, per element the sum of the
    magnitudes of every contribution to it; for a bfloat16 gradient plus one
    bf16 ulp of the float32 gradient and of that limit (each side rounds
    once).  twin_fn(list of float32 inputs) -> output; returns one limit
    tensor per input."""
    import torch

    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    out = twin_fn(xs)
    g = grad_out.float()
    sums = torch.autograd.grad(out, xs, g.abs(), retain_graph=True)
    grads = torch.autograd.grad(out, xs, g) if out_dtype == torch.bfloat16 else sums
    limits = []
    for s_, d in zip(sums, grads):
        lim = SUM_ORDER_FACTOR * EPS32 * s_
        if out_dtype == torch.bfloat16:
            lim = lim + BF16_ULP * (d.abs() + lim)
        limits.append(lim)
    return limits


def limit_ratio(got, want, limit) -> float:
    """The largest |got - want| / limit over the elements: at most 1 passes
    (an element with a zero limit must be equal)."""
    import torch

    diff = (got.float() - want.float()).abs()
    ratio = torch.where(limit > 0, diff / limit.clamp_min(1e-30),
                        torch.where(diff > 0, torch.full_like(diff, float("inf")), diff))
    return float(ratio.max()) if ratio.numel() else 0.0


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs back to back, after one
    warm-up, between CUDA events: where the host takes longer to issue a call
    than the card to run it, the host's time is in the number."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps: int, windows: int = 5) -> dict:
    """Device milliseconds of one fn() call without the host's time: in each
    of `windows` windows the card first sleeps (SLEEP_CYCLES) while the host
    queues reps calls, so the CUDA events time the calls back to back on the
    card.  Returns the median, min and max over the windows and the host's
    milliseconds to queue a window, which must stay below the sleep (else
    the host's time would be in the number, and this raises)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, host = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    times.sort()
    sleep = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    sleep[1].record()
    sleep[1].synchronize()
    sleep_ms = sleep[0].elapsed_time(sleep[1])
    if max(host) >= sleep_ms:
        raise AssertionError(f"kernel_ms: the host took {max(host)} ms to queue {reps} calls, "
                             f"longer than the card's {sleep_ms} ms sleep")
    return {"ms": times[len(times) // 2], "min": times[0], "max": times[-1], "windows": windows,
            "host_queue_ms": max(host), "sleep_ms": sleep_ms}


def profile_kernels(fn, reps: int, *names, attempts: int = 3) -> dict:
    """Device milliseconds per launch of the CUDA kernels fn() launches, one
    launch a call each, whose names hold `names`, from torch.profiler's
    per-kernel totals over reps calls (after one warm-up call): {name: ms},
    each the mean over the launches the profile holds.  The profiler can
    lose a run's records, all of them or some (seen on the H100: 6 of 10);
    a profile without a record of one of the kernels is taken again, up to
    `attempts` profiles, then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, seen, keys = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0), []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            for n in names:
                if n in e.key:
                    keys.append((e.key[:60], e.count, us))
                    if us > 0:
                        total[n] += us
                        seen[n] += e.count
        if any(seen[n] != reps for n in names):
            print(f"profile_kernels: the profile holds {seen} launches of {reps} each ({keys})")
        if all(seen[n] > 0 for n in names):
            return {n: total[n] / 1e3 / seen[n] for n in names}
    raise AssertionError(f"profile_kernels: {attempts} profiles hold no launch of a kernel: {seen}")


def spread(t: dict) -> str:
    return (f"{t['ms']} ms (device time, median of {t['windows']} windows, min {t['min']}, max "
            f"{t['max']}; the host queued a window in {t['host_queue_ms']} ms while the card "
            f"slept {t['sleep_ms']} ms)")


def random_boxes(rng, n, frame_hw=(512, 960), size=(16.0, 256.0)):
    x1 = rng.uniform(0, frame_hw[1] - size[0], n)
    y1 = rng.uniform(0, frame_hw[0] - size[0], n)
    w = rng.uniform(*size, n)
    h = rng.uniform(*size, n)
    return np.stack([x1, y1, np.minimum(x1 + w, frame_hw[1] - 1),
                     np.minimum(y1 + h, frame_hw[0] - 1)], 1).astype(np.float32)


def nms_problems(rng, g, n):
    """g problems of n boxes: random boxes and scores, plus score ties,
    invalid lanes and a suppression chain in some of the problems."""
    boxes = np.stack([random_boxes(rng, n) for _ in range(g)])
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    valid = np.ones((g, n), bool)
    scores[1] = np.round(scores[1] * 8) / 8  # ties
    valid[2] = rng.uniform(size=n) < 0.7  # invalid lanes
    # neighbours overlap at IoU 0.74, every other box at 0.54: greedy keeps
    # the even lanes at thresholds 0.6 and 0.7
    chain = min(n, 40)
    boxes[3, :chain] = [[i * 1.5, 0, i * 1.5 + 10, 10] for i in range(chain)]
    scores[3, :chain] = np.linspace(2.0, 1.5, chain)  # above every random score
    return boxes, scores, valid


def near_mid_pairs(rng, thr, count):
    """(count, 2, 4) pairs of boxes whose IoU lies next to the midpoint of
    the float32 threshold and the float32 after it, where the axis-aligned
    mask's division-free test decides (csrc/nms.cu threshold_test): box b
    nested in box a, b's width the float32 steps around mid * a's width."""
    t = np.float32(thr)
    mid = (float(t) + float(np.nextafter(t, np.float32(np.inf)))) / 2
    w = rng.uniform(5, 400, count).astype(np.float32)
    h = rng.uniform(5, 400, count).astype(np.float32)
    bits = (mid * w.astype(np.float64)).astype(np.float32).view(np.int32)
    x = np.maximum(bits + rng.randint(-2, 3, count).astype(np.int32), 0).view(np.float32)
    zero = np.zeros(count, np.float32)
    return np.stack([np.stack([zero, zero, w, h], -1), np.stack([zero, zero, x, h], -1)], 1)


def nms_pairs(scores, valid, idx, ok):
    """IoU pairs greedy NMS needs on these problems: each kept box against
    every box after it in score order."""
    pairs = 0
    for s, v, i, k in zip(scores, valid, idx, ok):
        order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
        pos = np.empty_like(order)
        pos[order] = np.arange(len(order))
        pairs += int((len(order) - 1 - pos[i[k]]).sum())
    return pairs


def score_order(scores, valid):
    """Lanes of one problem in NMS order: descending score, stable, invalid
    lanes last (the wrappers' sort)."""
    return np.argsort(-np.where(valid, scores, -1e30).astype(np.float64), kind="stable")


def near_threshold(iou, valid, thr, tol, rows) -> bool:
    """Whether one of the lanes `rows` (a reference's kept lanes: only their
    rows decide a greedy NMS) has an IoU within tol of thr with another
    valid lane of the problem (iou: (N, N) over the input lanes)."""
    near = (np.abs(iou - thr) <= tol) & valid[:, None] & valid[None, :]
    np.fill_diagonal(near, False)
    return bool(near[rows].any())


def greedy_violations(iou, scores, valid, idx, ok, thr, tol, max_out) -> list:
    """How one problem's keep slots (idx, ok) break greedy NMS by more than
    tol against iou (N, N), the IoU of every lane (row) with every later one
    (column): walking the lanes in score order, a kept lane has no earlier
    kept lane with IoU > thr + tol, a valid lane not kept has an earlier kept
    lane with IoU > thr - tol, and the slots hold the first min(count, M)
    kept lanes in order, M = min(N, max_out).  Returns messages, [] when it
    passes."""
    n = len(scores)
    m = min(n, max_out)
    order = score_order(scores, valid)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    count = int(ok.sum())
    bad = []
    if not ok[:count].all():
        bad.append("valid slots are not a prefix")
    kept = idx[:count].astype(np.int64)
    if not valid[kept].all():
        bad.append("an invalid lane was kept")
    if (np.diff(pos[kept]) <= 0).any():
        bad.append("kept lanes are not in score order")
    last = pos[kept[-1]] if count == m and count else n - 1
    is_kept = np.zeros(n, bool)
    is_kept[kept] = True
    before = []
    for lane in order[:last + 1]:
        best = float(iou[before, lane].max()) if before else 0.0
        if is_kept[lane]:
            if best > thr + tol:
                bad.append(f"lane {lane} kept under IoU {best}")
            before.append(lane)
        elif valid[lane] and best <= thr - tol:
            bad.append(f"lane {lane} dropped at best IoU {best}")
    return bad


# K1's and K4's times with the mask kernels and the wrapper's torch sort and
# casts that the sort kernel replaced (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W): the whole call, its mask kernel and its scan kernel
REPLACED_NMS_MS = {"proposals": (0.1257, 0.0592, 0.0167), "final filter": (0.0717, 0.0148, 0.0071),
                   "train proposals": (0.3053, 0.1864, 0.0673),
                   "BEV proposals": (0.0946, 0.0298, 0.0140),
                   "BEV final filter": (0.0720, 0.0148, 0.0071),
                   "BEV train proposals": (0.0982, 0.0242, 0.0219),
                   "rotated": (0.2010, 0.1446, 0.0064)}
NMS_KERNELS = ("nms_sort_kernel", "nms_mask_kernel", "nms_scan_kernel")
ROT_NMS_KERNELS = ("nms_sort_kernel", "nms_rotated_mask_kernel", "nms_scan_kernel")


def split_line(split, names, replaced) -> str:
    """The sort, mask and scan kernels' times of one call beside the
    replaced call's mask and scan (REPLACED_NMS_MS)."""
    sort_, mask, scan = (split[k] for k in names)
    return (f"of it per call (torch.profiler) the sort kernel {sort_} ms, the mask kernel {mask} ms "
            f"(replaced: {replaced[1]}) and the staged block scan {scan} ms (replaced: "
            f"{replaced[2]}); the call replaced took {replaced[0]} ms (PERF.md)")


def check_nms(name, g, n, thr, max_out, rng):
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain

    boxes, scores, valid = nms_problems(rng, g, n)
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    db, ds, dv = (t.cuda() for t in (tb, ts, tv))
    idx, ok = nms(db, ds, thr, max_out, dv)
    torch.cuda.synchronize()
    want_idx, want_ok = nms_plain(tb, ts, thr, max_out, tv)
    bad = (idx.cpu() != want_idx) | (ok.cpu() != want_ok)
    if bad.any():
        raise AssertionError(f"nms {name}: {int(bad.sum())} slots differ from the twin")
    err = float((idx.cpu().double() - want_idx.double()).abs().max())
    chain_kept = idx[3][ok[3]][:20].cpu().numpy()
    if not np.array_equal(chain_kept, np.arange(0, 40, 2)[:20]):
        raise AssertionError(f"nms {name}: chain keeps {chain_kept}")
    t = kernel_ms(lambda: nms(db, ds, thr, max_out, dv), 50)
    ms = t["ms"]
    split = profile_kernels(lambda: nms(db, ds, thr, max_out, dv), 10, *NMS_KERNELS)
    plain_ms = cuda_ms(lambda: nms_plain(db, ds, thr, max_out, dv), 2)
    m = idx.shape[-1]
    pairs = nms_pairs(scores, valid, want_idx.numpy(), want_ok.numpy())
    bound, by = bound_ms(g * n * (16 + 4 + 1) + g * m * (4 + 1), pairs * IOU_FLOPS)
    print(f"nms {name} ({g}, {n}) -> {max_out} @ {thr}: identical keeps "
          f"({int(ok.sum())} kept); kernel {spread(t)}, "
          f"{split_line(split, NMS_KERNELS, REPLACED_NMS_MS[name])}; plain twin on "
          f"the card {plain_ms} ms, bound {bound} ms ({by}; {pairs} IoU pairs)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "sort_ms": split["nms_sort_kernel"], "mask_ms": split["nms_mask_kernel"],
            "scan_ms": split["nms_scan_kernel"]}


def check_nms_near_mid(rng, count=4000):
    """K1 on problems of two nested boxes whose IoU lies a float32 step or
    two from each threshold's midpoint (near_mid_pairs), where the mask's
    division-free test decides: keeps identical to the twin's."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain

    scores = torch.tensor([[1.0, 0.5]]).expand(count, 2).contiguous()
    for thr in (0.3, 0.5, 0.6, 0.7):
        pairs = torch.from_numpy(near_mid_pairs(rng, thr, count))
        idx, ok = nms(pairs.cuda(), scores.cuda(), thr, 2)
        want_idx, want_ok = nms_plain(pairs, scores, thr, 2)
        if not (torch.equal(idx.cpu(), want_idx) and torch.equal(ok.cpu(), want_ok)):
            raise AssertionError(f"nms at the midpoint of {thr}: keeps differ from the twin's")
        print(f"nms at the midpoint of {thr}: {count} problems of two boxes whose IoU lies a "
              f"float32 step or two from it, identical keeps ({int(want_ok[:, 1].sum())} second "
              f"boxes kept)")


def rotated_boxes(rng, g, n):
    """g problems of n rotated BEV boxes [xc, yc, l, w, ry] in voxel units:
    centers over the 400-voxel raster, l 8-25, w 4-10, any heading; the
    first half jittered copies of the second half's centers, so that many
    pairs overlap."""
    b = np.stack([rng.uniform(0, 400, (g, n)), rng.uniform(0, 400, (g, n)),
                  rng.uniform(8, 25, (g, n)), rng.uniform(4, 10, (g, n)),
                  rng.uniform(-np.pi, np.pi, (g, n))], -1)
    h = n // 2
    b[:, :h, :2] = b[:, n - h:, :2] + rng.uniform(-6, 6, (g, h, 2))
    return b.astype(np.float32)


def dense_rotated_boxes(rng, g, n):
    """rotated_boxes with every box of a problem inside one 40-voxel square:
    the centers within 3 voxels of the problem's center, so that any two
    are nearer (8.5) than the smallest two half-diagonals (8.9).  The
    rotated mask's early out never fires, and every lane clips."""
    b = rotated_boxes(rng, g, n).astype(np.float64)
    b[..., :2] = rng.uniform(20, 380, (g, 1, 2)) + rng.uniform(-3, 3, (g, n, 2))
    return b.astype(np.float32)


# The least float32 operations the rotated IoU test needs, whatever the
# kernel: every pair greedy NMS must decide (each kept lane against every
# lane after it) needs at least a separation test of the two boxes' bounding
# circles (the center offset 2, the squared distance 2, the sum of the radii
# and its square 2, the compare 1; the radii are per box); a pair whose
# boxes intersect (the twin's IoU > 0) also needs each box's 4 corners
# placed against the other box's 4 edges (8 x 4 x 2; the edge normals are
# per box), the shoelace of the intersection over at least 3 vertices
# (3 x 2) and the IoU (the union 2, the quotient 1, the compare 1).  The
# edge crossings are not counted, so this is a floor.
ROT_SEPARATION_OPS = 2 + 2 + 2 + 1
ROT_INTERSECTION_OPS = 8 * 4 * 2 + 3 * 2 + 4


def circles_meet(boxes):
    """(G, N, 5) -> (G, N, N) bool: csrc/nms.cu `circles_apart` negated, in
    float32 (the pairs the rotated mask kernel clips)."""
    b = boxes.astype(np.float32)
    r = np.float32(0.5) * np.sqrt(b[..., 2] * b[..., 2] + b[..., 3] * b[..., 3])
    dx = b[..., None, :, 0] - b[..., :, None, 0]
    dy = b[..., None, :, 1] - b[..., :, None, 1]
    reach = r[..., :, None] + r[..., None, :]
    lim = reach + np.float32(1e-5) * (np.abs(dx) + np.abs(dy) + reach)
    return ~(dx * dx + dy * dy > lim * lim)


ROTATED_EDGE_CASES = np.array([
    [100, 100, 20, 8, 0.3], [100, 100, 20, 8, 0.3],  # identical: 1
    [100, 100, 10, 4, 0.3],  # inside 0 at a quarter of its area: 0.25
    [100, 108, 20, 8, 0.0],  # shares an edge with 8: 0
    [100, 100, 20, 8, np.pi / 2],  # 8 turned by 90 degrees: 64 / 256
    [100, 100, 20, 0, 0.1],  # zero width: 0
    [300, 300, 10, 5, 1.0],  # disjoint from all: 0
    [130, 100, 20, 8, 0.0],  # disjoint from 8: 0
    [100, 100, 20, 8, 0.0],
], np.float32)


def greedy_pairs(scores, valid, idx, ok):
    """(G, N, N) bool over the input lanes: row a kept lane, column a lane
    after it in score order; the pairs greedy NMS must test (nms_pairs
    counts them)."""
    g, n = scores.shape
    out = np.zeros((g, n, n), bool)
    for p in range(g):
        pos = np.empty(n, np.int64)
        pos[score_order(scores[p], valid[p])] = np.arange(n)
        kept = idx[p][ok[p]]
        out[p, kept] = pos[None, :] > pos[kept][:, None]
    return out


def rotated_case(label, boxes, scores, valid, thr, max_out, tol=1e-4, timed=True):
    """One set of rotated problems: the IoU kernel's matrix within 5e-5 of
    the twin's, the rotated NMS kernel's keeps identical to the twin's on
    every problem where no kept lane's pair lies within tol of the
    threshold, and the tolerant greedy check against the twin's IoU matrix
    on every problem.  Twin on the card.  Also counts the pairs: those the
    mask kernel tests (every upper-triangle pair) and the share whose
    bounding circles meet (those it clips), and those greedy NMS needs
    (greedy_pairs) and the share of them that intersect (the bound's)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix,
        rotated_iou_matrix_plain,
    )

    g, n = scores.shape
    db, ds, dv = (torch.from_numpy(a).cuda() for a in (boxes, scores, valid))
    got = rotated_iou_matrix(db, db)
    want = rotated_iou_matrix_plain(db, db)
    torch.cuda.synchronize()
    iou_err = float((got - want).abs().max())
    if not iou_err <= 5e-5:
        raise AssertionError(f"rotated_iou {label}: max |dIoU| {iou_err}")
    idx, ok = nms(db, ds, thr, max_out, dv, rotated=True)
    torch.cuda.synchronize()
    want_idx, want_ok = (t.cpu().numpy() for t in nms_plain(db, ds, thr, max_out, dv, rotated=True))
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    iou_np = want.cpu().numpy()
    near = bad = 0
    for i in range(g):
        rows = want_idx[i][want_ok[i]]
        if near_threshold(iou_np[i], valid[i], thr, tol, rows):
            near += 1
        elif not (np.array_equal(idx[i], want_idx[i]) and np.array_equal(ok[i], want_ok[i])):
            raise AssertionError(f"nms_rotated {label} problem {i}: keeps differ from the twin's, "
                                 f"and no kept lane's pair lies within {tol} of {thr}")
        broken = greedy_violations(iou_np[i], scores[i], valid[i], idx[i], ok[i], thr, tol, max_out)
        if broken:
            bad += 1
            print(f"nms_rotated {label} problem {i}: {broken[:5]}")
    if bad:
        raise AssertionError(f"nms_rotated {label}: {bad} problems fail the tolerant greedy check")
    upper = np.triu(np.ones((n, n), bool), 1)
    pairs = g * n * (n - 1) // 2
    meeting = int((circles_meet(boxes) & upper).sum())
    needed = greedy_pairs(scores, valid, want_idx, want_ok)
    intersecting = int((needed & (iou_np > 0)).sum())
    out = {"max_abs_err": iou_err, "near_problems": near, "kept": int(ok.sum()),
           "overlapping": int((iou_np > 0.05).sum()) - g * n, "mask_pairs": pairs,
           "meeting": meeting, "meeting_share": meeting / pairs, "greedy_pairs": int(needed.sum()),
           "intersecting": intersecting}
    print(f"nms_rotated {label}: the bounding circles meet on {meeting} of the {pairs} "
          f"upper-triangle pairs the mask kernel tests ({meeting / pairs:.4%}); greedy NMS needs "
          f"{out['greedy_pairs']} pairs, of which {intersecting} intersect (twin IoU > 0)")
    if not timed:
        return out
    t = kernel_ms(lambda: nms(db, ds, thr, max_out, dv, rotated=True), 20)
    split = profile_kernels(lambda: nms(db, ds, thr, max_out, dv, rotated=True), 10,
                            *ROT_NMS_KERNELS)
    plain_ms = cuda_ms(lambda: nms_plain(db, ds, thr, max_out, dv, rotated=True), 2)
    iou_t = kernel_ms(lambda: rotated_iou_matrix(db, db), 20)
    ops = out["greedy_pairs"] * ROT_SEPARATION_OPS + intersecting * ROT_INTERSECTION_OPS
    m = idx.shape[-1]
    bound, by = bound_ms(g * n * (20 + 4 + 1) + g * m * (4 + 1), ops)
    print(f"rotated_iou {label} ({g}, {n}, 5)^2 -> ({g}, {n}, {n}): max |dIoU| vs twin {iou_err} "
          f"(limit 5e-5), {out['overlapping']} overlapping pairs (IoU > 0.05); kernel "
          f"{spread(iou_t)}")
    print(f"nms_rotated {label} ({g}, {n}) -> {max_out} @ {thr}: {out['kept']} kept; identical "
          f"keeps on the {g - near} problems without a kept lane's pair within {tol} of {thr} "
          f"({near} with one); the tolerant greedy check passes on all {g}; kernel {spread(t)}, "
          f"{split_line(split, ROT_NMS_KERNELS, REPLACED_NMS_MS['rotated'])}; plain twin on the "
          f"card {plain_ms} ms, bound {bound} ms ({by}: the {out['greedy_pairs']} pairs greedy NMS "
          f"needs x {ROT_SEPARATION_OPS} float32 operations of a separation test + the "
          f"{intersecting} of them that intersect x {ROT_INTERSECTION_OPS})")
    return {**out, "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "iou_ms": iou_t["ms"], "sort_ms": split["nms_sort_kernel"],
            "mask_ms": split["nms_rotated_mask_kernel"], "scan_ms": split["nms_scan_kernel"]}


def check_rotated(g, n, thr, max_out, rng, tol=1e-4):
    """K4 at (g, n) -> max_out @ thr: the rotated IoU kernel on the edge
    cases (by value, and within 5e-5 of the twin); rotated_case on random
    boxes (half of them clustered), then, from a stream of its own, on
    dense boxes (every box of a problem in one 40-voxel square: every lane
    clips), timed, and at threshold 0."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix,
        rotated_iou_matrix_plain,
    )

    boxes = rotated_boxes(rng, g, n)
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    scores[1] = np.round(scores[1] * 8) / 8  # ties
    valid = np.ones((g, n), bool)
    valid[2] = rng.uniform(size=n) < 0.7  # invalid lanes
    e = torch.from_numpy(ROTATED_EDGE_CASES).cuda()
    ge, we = rotated_iou_matrix(e, e).cpu().numpy(), rotated_iou_matrix_plain(e, e).cpu().numpy()
    edge_err = float(np.abs(ge - we).max())
    edges = {"identical": float(ge[0, 1]), "inside": float(ge[0, 2]),
             "shared edge": float(abs(ge[3, 8])), "90 deg": float(ge[4, 8]),
             "zero width": float(np.abs(ge[5]).max()), "disjoint": float(np.delete(ge[6], 6).max())}
    edge_ok = (abs(edges["identical"] - 1) <= 1e-6 and abs(edges["inside"] - 0.25) <= 1e-6
               and edges["shared edge"] <= 1e-6 and abs(edges["90 deg"] - 0.25) <= 1e-6
               and edges["zero width"] <= 1e-6 and edges["disjoint"] == 0)
    if not edge_err <= 5e-5 or not edge_ok:
        raise AssertionError(f"rotated_iou: edge cases {edge_err} {edges}")
    print(f"rotated_iou edge cases {edges}, max |dIoU| vs twin {edge_err}")
    random = rotated_case("random", boxes, scores, valid, thr, max_out, tol)
    rng_dense = np.random.RandomState(3)
    dense_boxes = dense_rotated_boxes(rng_dense, g, n)
    dense_scores = rng_dense.uniform(size=(g, n)).astype(np.float32)
    dense_valid = rng_dense.uniform(size=(g, n)) < 0.9
    dense = rotated_case("dense", dense_boxes, dense_scores, dense_valid, thr, max_out, tol)
    zero = rotated_case("dense @ 0", dense_boxes, dense_scores, dense_valid, 0.0, max_out, tol,
                        timed=False)
    print(f"nms_rotated dense @ 0: {zero['kept']} kept, identical keeps on the "
          f"{g - zero['near_problems']} problems without a kept lane's pair within {tol} of 0; "
          f"the tolerant greedy check passes on all {g}")
    return {**random, "dense": dense}


def collinear_boxes(rng, count):
    """(2 * count, 5) pairs of boxes [xc, yc, l, w, ry] with one heading: slid
    along the length (both long sides collinear), slid across so that one
    long side lies on the other's, or side by side touching along a long
    side (tests/test_torch_port_nms_plans.py builds the same pairs)."""
    out = []
    for _ in range(count):
        ry, length, width = rng.uniform(-np.pi, np.pi), rng.uniform(8, 25), rng.uniform(4, 10)
        x, y = rng.uniform(50, 350, 2)
        c, s = np.cos(ry), np.sin(ry)
        kind = rng.randint(3)
        if kind == 0:
            d = rng.uniform(-length, length)
            out += [[x, y, length, width, ry], [x + d * c, y + d * s, length, width, ry]]
        elif kind == 1:
            d = rng.uniform(0, width)
            out += [[x, y, length, width, ry],
                    [x - d / 2 * s, y + d / 2 * c, length, width - d, ry]]
        else:
            out += [[x, y, length, width, ry], [x - width * s, y + width * c, length, width, ry]]
    return np.array(out, np.float32)


def rotated_oracle(a, b) -> float:
    """float64 IoU of two [xc, yc, l, w, ry] boxes: Sutherland-Hodgman on
    their BEV corners (the port's evaluation code)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
        rotated_bev_intersection,
    )

    p, q = a.astype(np.float64), b.astype(np.float64)
    inter = rotated_bev_intersection(np.array([p[0], p[1], 0, p[2], p[3], 1, p[4]]),
                                     np.array([q[0], q[1], 0, q[2], q[3], 1, q[4]]))
    union = p[2] * p[3] + q[2] * q[3] - inter
    return inter / union if union > 1e-9 else 0.0


# JAX's rotated_iou_matrix on the same kind of pairs, row-centered: 0.316 off
# the float64 oracle (tests/test_torch_port_nms_plans.py
# ::test_clip_mirror_on_collinear_edges on the CPU; fault F5)
JAX_COLLINEAR_ERR = 0.316


def self_iou_limit(boxes):
    """The limit on |IoU - 1| of each [xc, yc, l, w, ry] box against itself
    in float32: the clip returns the box itself, and the shoelace of its
    corners differs from l * w by the rounding of terms of size (l + w)^2 /
    4, so a sliver (w << l) strays furthest.  SELF_IOU_ULPS of that
    relative rounding, per box."""
    l, w = boxes[:, 2].astype(np.float64), boxes[:, 3].astype(np.float64)
    return SELF_IOU_ULPS * float(np.finfo(np.float32).eps) * (l + w) ** 2 / (l * w)


# The clip's mirror (tests/test_torch_port_nms_plans.py) reaches 1.25 of
# these on 12 draws of collinear_boxes
SELF_IOU_ULPS = 4


def check_collinear(rng, count=300):
    """K4's IoU kernel on pairs with collinear sides (fault F5): within 1e-6
    of the float64 oracle, with the twin's distance from it beside (the twin
    copies JAX's candidate formulation, JAX_COLLINEAR_ERR off), and each
    box against itself (NMS never pairs a lane with itself) within
    self_iou_limit of 1."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix,
        rotated_iou_matrix_plain,
    )

    b = collinear_boxes(rng, count)
    got = rotated_iou_matrix(torch.from_numpy(b).cuda(), torch.from_numpy(b).cuda()).cpu().numpy()
    twin = rotated_iou_matrix_plain(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    pairs = np.arange(0, len(b), 2)
    want = np.array([rotated_oracle(b[i], b[i + 1]) for i in pairs])
    err = float(np.abs(got[pairs, pairs + 1] - want).max())
    twin_err = float(np.abs(twin[pairs, pairs + 1] - want).max())
    self_dev = np.abs(np.diag(got).astype(np.float64) - 1)
    self_err = float(self_dev.max())
    self_share = float((self_dev / self_iou_limit(b)).max())
    print(f"rotated_iou on {count} pairs with collinear sides (F5): kernel max |IoU - float64 "
          f"oracle| {err} (limit 1e-6); twin {twin_err}; JAX {JAX_COLLINEAR_ERR} (CPU test); "
          f"a box against itself max |IoU - 1| {self_err}, at most {self_share} of its "
          f"self_iou_limit")
    if not err <= 1e-6:
        raise AssertionError(f"rotated_iou collinear pairs: {err} from the float64 oracle")
    if not self_share <= 1:
        raise AssertionError(f"rotated_iou of a box against itself: {self_share} of its limit")
    return {"max_abs_err": err, "twin_err": twin_err, "self_err": self_err,
            "self_share": self_share}


def serving_rois(rng, b, r, frame_hw=FRAME_HW):
    """Proposal-like rois on a frame, with some straddling the edge, some
    outside it and some smaller than one feature cell."""
    size = (16.0, min(256.0, frame_hw[0] / 2))
    rois = np.stack([random_boxes(rng, r, frame_hw, size) for _ in range(b)])
    rois[:, :20, :2] -= 100.0
    rois[:, 20:30] += 2000.0
    rois[:, 30:40, 2:] = rois[:, 30:40, :2] + rng.uniform(1, 12, (b, 10, 2))
    return rois.astype(np.float32)


def roi_align_flops(n_out: int, sr: int = 2) -> int:
    """float32 operations of RoI align per output (or dOut) element: sr x sr
    samples of 4 bilinear taps, a multiply and an add each."""
    return n_out * sr * sr * 4 * 2


# The tap-by-tap forward's device ms (bf16, fp32) at these checks' shapes,
# before the staged forward replaced it (PERF.md section 6: chip_smoke.py on
# an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_FWD_MS = {((32, 60), 300): (0.4962, 0.7252), ((25, 22), 300): (0.4949, 0.7149),
              ((25, 22), 256): (0.4264, 0.6156)}


def check_roi_align(rng, feat_hw, r=R, c=C_FEAT):
    """The forward kernel against the twin on CPU copies at a path's shapes,
    values within tol * max|F|; its device time, printed beside the
    tap-by-tap kernel's it replaced (REPLACED_FWD_MS) where that was
    measured."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        roi_align_batched,
        roi_align_batched_plain,
    )

    h, w = feat_hw
    feats = rng.normal(size=(B, h, w, c)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, r, (h * 16, w * 16)))
    replaced = REPLACED_FWD_MS.get((tuple(feat_hw), r)) if c == C_FEAT else None
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        tf = torch.from_numpy(feats).to(dtype)
        df, dr = tf.cuda(), rois.cuda()
        got = roi_align_batched(df, dr, 1.0 / 16)
        torch.cuda.synchronize()
        want = roi_align_batched_plain(tf, rois, 1.0 / 16)
        fmax = float(tf.float().abs().max())
        err = float((got.cpu().float() - want.float()).abs().max())
        if not err <= tol * fmax:
            raise AssertionError(f"roi_align {dtype}: max err {err} > {tol} * {fmax}")
        t = kernel_ms(lambda: roi_align_batched(df, dr, 1.0 / 16), 20)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: roi_align_batched_plain(df, dr, 1.0 / 16), 3)
        bound, by = bound_ms(df.numel() * df.element_size() + dr.numel() * 4
                             + got.numel() * got.element_size(), roi_align_flops(got.numel()))
        print(f"roi_align {str(dtype).split('.')[-1]} features {tuple(df.shape)} rois "
              f"{tuple(dr.shape)}: max abs err {err} (bound {tol} * max|F| = {tol * fmax}); "
              f"kernel {spread(t)} (the tap-by-tap kernel it replaced: "
              f"{replaced[dtype == torch.float32] if replaced else 'not measured'} ms, PERF.md), "
              f"plain twin on the card {plain_ms} ms, bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
    return results


def check_roi_align_backward(rng, feat_hw, c=C_FEAT):
    """The backward kernel against the twin's autograd gradient on CPU
    copies, at a training path's shapes (dOut (B, R_TRAIN, 7, 7, C) onto
    the feat_hw map): every element within the sum-order limit
    (sum_order_tolerance), and two runs bitwise equal (the tile gather sums
    in a fixed order); times of the backward alone.  Not the twin on the
    card: there PyTorch divides by the Python int P through a float32
    reciprocal, so the twin's sample coordinates differ from the kernel's
    (and the CPU twin's) in the last bit, which moves a near-integer tap's
    small weight far more than summation order does."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _roi_align_bwd_cuda,
        roi_align_batched,
        roi_align_batched_plain,
    )

    h, w = feat_hw
    feats = rng.normal(size=(B, h, w, c)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, R_TRAIN, (h * 16, w * 16))).cuda()
    grad_out = rng.normal(size=(B, R_TRAIN, 7, 7, c)).astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        f = torch.from_numpy(feats).to(dtype).cuda().requires_grad_(True)
        g = torch.from_numpy(grad_out).to(dtype).cuda()
        (got,) = torch.autograd.grad(roi_align_batched(f, rois, 1.0 / 16), f, g)
        shape, fd = tuple(f.shape), f.dtype
        again = _roi_align_bwd_cuda(g, rois, shape, fd, 1.0 / 16, 7, 2, False)
        torch.cuda.synchronize()
        got, again = got.cpu(), again.cpu()
        f_cpu, g_cpu, r_cpu = f.detach().cpu().requires_grad_(True), g.cpu(), rois.cpu()
        (want,) = torch.autograd.grad(roi_align_batched_plain(f_cpu, r_cpu, 1.0 / 16), f_cpu, g_cpu)
        (limit,) = sum_order_tolerance(
            lambda xs: roi_align_batched_plain(xs[0], r_cpu, 1.0 / 16), [f_cpu], g_cpu, dtype)
        plain_out = roi_align_batched_plain(f, rois, 1.0 / 16)
        gmax = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        ratio = limit_ratio(got, want, limit)
        bitwise = torch.equal(got, again)
        if got.dtype != dtype or not ratio <= 1.0 or not bitwise:
            raise AssertionError(f"roi_align backward {dtype}: max |dF - twin| / limit {ratio}, "
                                 f"max err {err} ({err / gmax} of max|dF|), two runs bitwise "
                                 f"equal {bitwise}")
        t = kernel_ms(lambda: _roi_align_bwd_cuda(g, rois, shape, fd, 1.0 / 16, 7, 2, False), 10)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, f, g, retain_graph=True), 3)
        bound, by = bound_ms(g.numel() * g.element_size() + rois.numel() * 4
                             + f.numel() * f.element_size(), roi_align_flops(g.numel()))
        print(f"roi_align backward {str(dtype).split('.')[-1]} dOut {tuple(g.shape)} -> dF "
              f"{shape}: max |dF - twin| / sum-order limit {ratio} (limit {SUM_ORDER_FACTOR} x "
              f"eps32 x the summed |contributions| of each element"
              f"{' + one bf16 ulp' if dtype == torch.bfloat16 else ''}); max abs err {err} = "
              f"{err / gmax} x max|dF| {gmax}; two runs bitwise equal; kernel {spread(t)}, plain "
              f"twin's autograd backward on the card {plain_ms} ms, bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by, "limit_ratio": ratio}
        del plain_out
    return results


def fpn_rois(rng, b, r, sides=(16.0, 900.0), frame_hw=FRAME_HW):
    """RoIs with log-uniform sides in `sides` px (clipped to the frame), so
    that every level of the pyramid gets some."""
    x1 = rng.uniform(0, frame_hw[1] - 16, (b, r))
    y1 = rng.uniform(0, frame_hw[0] - 16, (b, r))
    side = np.exp(rng.uniform(np.log(sides[0]), np.log(sides[1]), (b, r)))
    aspect = np.exp(rng.uniform(-0.7, 0.7, (b, r)))
    x2 = np.minimum(x1 + side * aspect, frame_hw[1] - 1)
    y2 = np.minimum(y1 + side / aspect, frame_hw[0] - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def p5_rois(rng, b, r, frame_hw=FRAME_HW):
    """Squares of 450-510 px inside the frame: sqrt(area) >= 448, all on p5."""
    side = rng.uniform(450, 510, (b, r))
    x1 = rng.uniform(0, 1, (b, r)) * (frame_hw[1] - 1 - side)
    y1 = rng.uniform(0, 1, (b, r)) * (frame_hw[0] - 1 - side)
    return np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.float32)


def level_counts(levels) -> list:
    return [int((levels == i).sum()) for i in range(len(FPN_STRIDES))]


def tap_cells(rois, levels, p=7, sr=2, map_hw=FPN_MAP_HW) -> list:
    """Per level p2..p5, the distinct (frame, y, x) cells whose C-channel rows
    the forward must read: the bilinear taps of the samples of the RoIs mapped
    there (zero-weight taps included, as the kernel loads them).  A RoI's
    samples pair every sample row with every sample column, so its taps are
    the product of its y taps and its x taps.  rois (B, R, 4) and levels
    (B, R) on the CPU."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import _sample_coords, _taps

    cells = []
    for lvl, ((h, w), stride) in enumerate(zip(map_hw, FPN_STRIDES)):
        on = levels == lvl
        frame = torch.nonzero(on)[:, 0]
        gy, gx = _sample_coords(rois[on], 1.0 / stride, p, sr, False)
        ylo, yhi, _, _ = _taps(gy, h)
        xlo, xhi, _, _ = _taps(gx, w)
        ys, xs = torch.cat([ylo, yhi], -1), torch.cat([xlo, xhi], -1)
        flat = (frame[:, None, None] * h + ys[:, :, None]) * w + xs[:, None, :]
        cells.append(int(torch.unique(flat).numel()))
    return cells


def p2_rois(rng, b, r, frame_hw=FRAME_HW):
    """RoIs of sqrt(area) 16-110 px (all on p2) with aspects e^-1.5 .. e^1.5:
    the widest span up to ~120 p2 columns, so many take the forward's
    one-row ring (more than 1.5 x P x sr distinct tap columns)."""
    side = np.exp(rng.uniform(np.log(16.0), np.log(110.0), (b, r)))
    aspect = np.exp(rng.uniform(-1.5, 1.5, (b, r)))
    x1 = rng.uniform(0, frame_hw[1] - 16, (b, r))
    y1 = rng.uniform(0, frame_hw[0] - 16, (b, r))
    return np.stack([x1, y1, x1 + side * aspect, y1 + side / aspect], -1).astype(np.float32)


def staged_cells(rois, levels, p=7, sr=2, map_hw=FPN_MAP_HW) -> tuple[int, int]:
    """What the forward stages, RoI by RoI on its level: (the tap cells it
    reads, each RoI's distinct tap rows x distinct tap columns, summed; the
    RoIs whose distinct tap columns exceed 1.5 x P x sr, for which the ring
    holds one tap row, kFwdCap 3)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import _sample_coords, _taps

    def distinct(coords, dim):
        lo, hi, _, _ = _taps(coords, dim)
        taps = torch.cat([lo, hi], -1).sort(-1).values
        return 1 + (taps[:, 1:] != taps[:, :-1]).sum(-1)

    cells = one_row = 0
    for lvl, ((h, w), stride) in enumerate(zip(map_hw, FPN_STRIDES)):
        gy, gx = _sample_coords(rois[levels == lvl], 1.0 / stride, p, sr, False)
        ny, nx = distinct(gy, h), distinct(gx, w)
        cells += int((ny * nx).sum())
        one_row += int((nx * 2 > 3 * p * sr).sum())
    return cells, one_row


# The bin-by-bin multiscale forward's device ms (bf16, fp32) at the 16-900 px
# check's shapes, before the staged forward replaced it (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_MS_FWD_MS = (0.1349, 0.2321)


def check_multiscale_roi_align(rng, rois_np=None, label="16-900 px RoIs", map_hw=FPN_MAP_HW,
                               one_level=True):
    """The multiscale forward kernel against its twin (CPU copies) at the FPN
    serving shape: every RoI on the twin's level, values within tol * max|F|.
    The kernel's time is the raw entry's device time (kernel_ms); the
    public wrapper's time back to back (cuda_ms), host included, is printed
    beside it.  The bound counts the tap rows the RoIs hit on their levels
    (tap_cells), not the whole maps.  rois_np: (B, R, 4) RoIs (default
    fpn_rois, drawn after the maps, so that every level gets some; given
    RoIs must all lie on one level unless one_level is False); map_hw: the
    pyramid's p2..p5 sizes (default a 512x960 frame's)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _multiscale_roi_align_cuda,
        multiscale_roi_align_batched,
        multiscale_roi_align_batched_plain,
        roi_levels,
    )

    maps = [rng.normal(size=(B, h, w, C_FPN)).astype(np.float32) for h, w in map_hw]
    rois = torch.from_numpy(fpn_rois(rng, B, R) if rois_np is None else rois_np)
    want_levels = roi_levels(rois, len(FPN_STRIDES))
    counts = level_counts(want_levels)
    if rois_np is None and min(counts) == 0:
        raise AssertionError(f"multiscale roi_align: a level got no RoI: {counts}")
    if rois_np is not None and one_level and max(counts) != sum(counts):
        raise AssertionError(f"multiscale roi_align {label}: RoIs on several levels: {counts}")
    staged, one_row = staged_cells(rois, want_levels, map_hw=map_hw)
    cells = tap_cells(rois, want_levels, map_hw=map_hw)
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        tm = [torch.from_numpy(m).to(dtype) for m in maps]
        dm, dr = [m.cuda() for m in tm], rois.cuda()
        got = multiscale_roi_align_batched(dm, dr, FPN_STRIDES)
        _out, levels = _multiscale_roi_align_cuda(dm, dr, FPN_STRIDES, 7, 2)
        torch.cuda.synchronize()
        want = multiscale_roi_align_batched_plain(tm, rois, FPN_STRIDES)
        fmax = max(float(m.float().abs().max()) for m in tm)
        err = float((got.cpu().float() - want.float()).abs().max())
        same_levels = torch.equal(levels.cpu().long(), want_levels)
        if not same_levels or not err <= tol * fmax:
            raise AssertionError(f"multiscale roi_align {dtype}: levels equal {same_levels}, "
                                 f"max err {err} > {tol} * {fmax}")
        t = kernel_ms(lambda: _multiscale_roi_align_cuda(dm, dr, FPN_STRIDES, 7, 2), 20)
        wrapper_ms = cuda_ms(lambda: multiscale_roi_align_batched(dm, dr, FPN_STRIDES), 20)
        plain_ms = cuda_ms(lambda: multiscale_roi_align_batched_plain(dm, dr, FPN_STRIDES), 3)
        esize = got.element_size()
        tap_bytes = sum(cells) * C_FPN * esize
        map_bytes = sum(m.numel() * m.element_size() for m in dm)
        nbytes = tap_bytes + dr.numel() * 4 + got.numel() * esize + levels.numel() * 4
        bound, by = bound_ms(nbytes, roi_align_flops(got.numel()))
        replaced = (f"the bin-by-bin kernel it replaced: "
                    f"{REPLACED_MS_FWD_MS[dtype == torch.float32]} ms, PERF.md"
                    if rois_np is None else "the replaced kernel was not timed on this case")
        print(f"roi_align_multiscale {label} {str(dtype).split('.')[-1]} maps "
              f"{[tuple(m.shape) for m in dm]} rois {tuple(dr.shape)}, RoIs per level p2..p5 "
              f"{counts} ({one_row} with a one-row ring): levels equal to the twin's, max abs err "
              f"{err} (bound {tol} * max|F| = {tol * fmax}); kernel {spread(t)} ({replaced}); "
              f"through the public wrapper back to back "
              f"{wrapper_ms} ms (host included); plain twin on the card {plain_ms} ms; bound "
              f"{bound} ms ({by}: {nbytes} B = the rows of the {cells} distinct tap cells on "
              f"p2..p5, {tap_bytes} B of the maps' {map_bytes}, plus the rois, the output and "
              f"the levels once); the kernel stages {staged} tap cells ({staged * C_FPN * esize} "
              f"B: each RoI's distinct tap rows x columns on its level)")
        results[dtype] = {"max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
    return results


# The float32-atomic multiscale backward's device ms (bf16, fp32) at these
# checks' shapes, before the tile gather replaced it (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_MS_BWD_MS = {"16-900 px RoIs": (1.084, 0.8399), "every RoI on p5": (1.041, 0.7955)}


def check_multiscale_backward(rng, rois_np, label, map_hw=FPN_MAP_HW):
    """The multiscale backward kernel against the twin's autograd gradients
    on CPU copies (see check_roi_align_backward), at dOut (8, 256, 7, 7,
    256): every element of each level within the sum-order limit
    (sum_order_tolerance: the per-level tile gather sums in another order
    than the twin), and two runs bitwise equal; times of the backward
    alone, printed beside the atomic kernel's it replaced (REPLACED_MS_BWD_MS)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _multiscale_roi_align_bwd_cuda,
        multiscale_roi_align_batched,
        multiscale_roi_align_batched_plain,
        roi_levels,
    )

    maps = [rng.normal(size=(B, h, w, C_FPN)).astype(np.float32) for h, w in map_hw]
    rois = torch.from_numpy(rois_np).cuda()
    counts = level_counts(roi_levels(rois, len(FPN_STRIDES)))
    grad_out = rng.normal(size=(B, rois.shape[1], 7, 7, C_FPN)).astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        f = [torch.from_numpy(m).to(dtype).cuda().requires_grad_(True) for m in maps]
        g = torch.from_numpy(grad_out).to(dtype).cuda()
        got = torch.autograd.grad(multiscale_roi_align_batched(f, rois, FPN_STRIDES), f, g)
        shapes, fd = [tuple(m.shape) for m in f], f[0].dtype
        again = _multiscale_roi_align_bwd_cuda(g, rois, shapes, fd, FPN_STRIDES, 7, 2)
        torch.cuda.synchronize()
        got = [a.cpu() for a in got]
        bitwise = all(torch.equal(a, b.cpu()) for a, b in zip(got, again))
        f_cpu = [m.detach().cpu().requires_grad_(True) for m in f]
        g_cpu, r_cpu = g.cpu(), rois.cpu()
        want = torch.autograd.grad(multiscale_roi_align_batched_plain(f_cpu, r_cpu, FPN_STRIDES),
                                   f_cpu, g_cpu)
        limits = sum_order_tolerance(
            lambda xs: multiscale_roi_align_batched_plain(xs, r_cpu, FPN_STRIDES), f_cpu, g_cpu,
            dtype)
        plain_out = multiscale_roi_align_batched_plain(f, rois, FPN_STRIDES)
        errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
        gmax = [float(w.float().abs().max()) for w in want]
        ratios = [limit_ratio(a, w, lim) for a, w, lim in zip(got, want, limits)]
        ok = all(a.dtype == dtype for a in got) and all(r <= 1.0 for r in ratios) and bitwise
        if not ok:
            raise AssertionError(f"multiscale backward {label} {dtype}: max |dF - twin| / limit "
                                 f"per level {ratios}, max err per level {errs}, max|dF| {gmax}, "
                                 f"two runs bitwise equal {bitwise}")
        t = kernel_ms(lambda: _multiscale_roi_align_bwd_cuda(
            g, rois, shapes, fd, FPN_STRIDES, 7, 2), 10)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, f, g, retain_graph=True), 3)
        nbytes = (g.numel() * g.element_size() + rois.numel() * 4
                  + sum(m.numel() * m.element_size() for m in f))
        bound, by = bound_ms(nbytes, roi_align_flops(g.numel()))
        replaced = REPLACED_MS_BWD_MS.get(label)
        replaced = ("the replaced kernel was not timed on this case" if replaced is None else
                    f"the float32-atomic kernel it replaced: {replaced[dtype == torch.float32]} "
                    f"ms, PERF.md")
        print(f"roi_align_multiscale backward {label} {str(dtype).split('.')[-1]} dOut "
              f"{tuple(g.shape)} onto {shapes}, RoIs per level p2..p5 {counts}: max |dF - twin| "
              f"/ sum-order limit per level {ratios}; max abs err per level {errs} = "
              f"{[e / m if m else 0.0 for e, m in zip(errs, gmax)]} x max|dF| per level {gmax}; "
              f"two runs bitwise equal; kernel {spread(t)} ({replaced}), plain twin's autograd "
              f"backward on the card {plain_ms} ms, bound {bound} ms ({by}: dOut, the rois and "
              f"each map's gradient once)")
        results[dtype] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by, "limit_ratio": max(ratios)}
        del plain_out
    return results


def bev_points(rng, b, p, grid):
    """(b, p, 5) points and (b, p) valid over the BEV grid: a random cloud
    with points exactly on cell and slice boundaries, invalid lanes, points
    outside x, y and z, 40 points in one voxel, and frame 1 all invalid
    (all zeros)."""
    (x0, x1), (y0, y1), (z0, z1) = grid["x_range"], grid["y_range"], grid["z_range"]
    nx, ny, ns, vh = grid["num_x"], grid["num_y"], grid["num_slices"], grid["voxel_height"]
    pts = np.stack([rng.uniform(x0 - 5, x1 + 5, (b, p)), rng.uniform(y0 - 5, y1 + 5, (b, p)),
                    rng.uniform(z0 - 1, z1 + 1, (b, p)), rng.uniform(0, 1, (b, p)),
                    rng.uniform(0, 0.3, (b, p))], -1).astype(np.float32)
    valid = rng.uniform(size=(b, p)) < 0.9
    n = p // 4  # on the boundaries, including the grid's own edges
    pts[:, :n, 0] = x0 + rng.randint(-1, nx + 2, (b, n)) * ((x1 - x0) / nx)
    pts[:, :n, 1] = y0 + rng.randint(-1, ny + 2, (b, n)) * ((y1 - y0) / ny)
    pts[:, :n, 2] = z0 + rng.randint(-1, ns + 2, (b, n)) * vh
    pts[:, n:n + 40, :3] = [x0 + 1.01, y0 + 1.01, z0 + 0.26]  # one over-full voxel
    valid[:, n:n + 40] = True
    pts[1], valid[1] = 0.0, False
    return pts, valid


def skew_points(rng, b, p, grid):
    """bev_points with frame 0's points all valid and all inside one 8 x 32
    tile of the raster (cells y 24-31, x 64-95), 40 of them in one voxel:
    one tile holds a whole frame, many times the 256 x 4 entries the
    voxelizer's tile block takes a round."""
    pts, valid = bev_points(rng, b, p, grid)
    (x0, x1), (y0, y1), (z0, _) = grid["x_range"], grid["y_range"], grid["z_range"]
    px, py = (x1 - x0) / grid["num_x"], (y1 - y0) / grid["num_y"]
    cx, cy = 64, 24
    pts[0, :, 0] = x0 + (cx + rng.uniform(0.001, 0.999, p) * 32) * px
    pts[0, :, 1] = y0 + (cy + rng.uniform(0.001, 0.999, p) * 8) * py
    pts[0, :, 2] = rng.uniform(z0, z0 + grid["num_slices"] * grid["voxel_height"], p)
    pts[0, :40, :3] = [x0 + (cx + 5.5) * px, y0 + (cy + 2.5) * py, z0 + 0.26]
    valid[0] = True
    return pts, valid


# The scatter-and-finalize voxelizer's device ms at these checks' grids, before
# the binned tile pass replaced it (PERF.md section 6: chip_smoke.py on an
# NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_VOX_MS = {(400, 350): 0.1872, (800, 700): 0.7251}


def check_voxelize(rng, cfg, frame_scale, p, skew=False, points=None):
    """The voxelizer kernel against its twin (CPU copy) and its time: height
    and density channels equal and equal over two runs, meta within 1e-5,
    the all-invalid frame zero.  skew: frame 0's points all in one tile.
    points: (pts, valid) of a loader batch in place of the drawn cloud (no
    all-invalid frame then)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (
        raster_kwargs,
        voxelize_bev,
        voxelize_bev_plain,
    )

    grid = raster_kwargs(cfg, frame_scale)
    pts, valid = points if points is not None else (skew_points if skew else bev_points)(
        rng, B, p, grid)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    dp, dv = tp.cuda(), tv.cuda()
    got = voxelize_bev(dp, dv, **grid)
    again = voxelize_bev(dp, dv, **grid)
    torch.cuda.synchronize()
    got, again = got.cpu(), again.cpu()
    want = voxelize_bev_plain(tp, tv, **grid)
    s = grid["num_slices"]
    exact = torch.equal(got[..., :s + 1], want[..., :s + 1])
    repeat = torch.equal(got[..., :s + 1], again[..., :s + 1])
    err = float((got - want).abs().max())
    meta_err = float((got[..., s + 1:] - want[..., s + 1:]).abs().max())
    empty_ok = points is not None or not bool(got[1].any())
    if not exact or not repeat or not meta_err <= 1e-5 or not empty_ok:
        raise AssertionError(f"voxelize_bev {tuple(got.shape)} skew {skew}: height/density equal "
                             f"{exact}, equal over two runs {repeat}, meta err {meta_err}, "
                             f"all-invalid frame zero {not bool(got[1].any())}")
    if skew and not float(want[0, 24:32, 64:96, s].max()) == 1.0:
        raise AssertionError("voxelize_bev skew: the over-full voxel is not capped at 1.0")
    t = kernel_ms(lambda: voxelize_bev(dp, dv, **grid), 20)
    ms = t["ms"]
    plain_ms = cuda_ms(lambda: voxelize_bev_plain(dp, dv, **grid), 3)
    # float32 operations: ~11 a point (subtract, scale, floor per axis; the
    # height), ~2 per slice and ~50 for the two divisions and tanhs a column
    n_cols = got.numel() // got.shape[-1]
    flops = dv.numel() * 11 + n_cols * (2 * s + 50)
    bound, by = bound_ms(dp.numel() * 4 + dv.numel() + got.numel() * 4, flops)
    hw = tuple(got.shape[1:3])
    replaced = (f"the scatter-and-finalize kernel it replaced: {REPLACED_VOX_MS[hw]} ms, PERF.md"
                if not skew and points is None else
                "the replaced kernel was not timed on this case")
    case = (" (frame 0: every point in one tile)" if skew else
            f" (a loader batch: {int(valid.sum())} valid points)" if points is not None else "")
    print(f"voxelize_bev points {tuple(dp.shape)} -> {tuple(got.shape)}{case}: height and density "
          f"channels equal, and equal over two runs; meta channels max err {meta_err} (limit "
          f"1e-5), filled cells {int((want[..., s] > 0).sum())}; kernel {spread(t)} ({replaced}), "
          f"plain twin on the card {plain_ms} ms, bound {bound} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


HE_GAIN = 2.0 ** 0.5


def scale_terminators(model, value=0.25):
    """Residual-terminator BN scales (bn3 of a Bottleneck, bn2 of a
    BasicBlock) to `value`, as bench.py does for random weights, so res101's
    activations stay finite.  VGG16 and MobileNet have no residuals; at
    their lecun-normal init each ReLU halves the activations' second
    moment (15 of them in VGG16, 27 ReLU6 in MobileNet), so a random net's
    maps come out ~1e-4 of its input and every RoI scores alike: VGG16's
    conv and fc weights, and MobileNet's BN scales, take He's gain sqrt(2)
    instead."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import FrozenBatchNorm

    variant = model.cfg.net_variant
    with torch.no_grad():
        for name, m in model.named_modules():
            if hasattr(m, "terminator"):
                m.terminator.weight.fill_(value)
            elif not name.startswith(("backbone.", "tail.")):
                continue
            elif variant == "vgg16" and isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.mul_(HE_GAIN)
            elif variant == "mobile" and isinstance(m, FrozenBatchNorm):
                m.weight.fill_(HE_GAIN)
    return model


def iou_plus1(a, b):
    import torch

    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def split_thresh(scores, valid) -> float:
    """A threshold in the widest gap among the middle third of the valid
    rois' scores (pad slots repeat the top box), so about half pass and none
    sits within backend noise of it."""
    s = np.sort(scores[valid].numpy().ravel())
    lo, hi = s.size // 3, max(s.size // 3 + 1, 2 * s.size // 3)
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[i] + s[i + 1]) / 2)


def feature_err(got, want):
    """(max |card - CPU|, max |CPU|) over a feature map or a pyramid."""
    gs, ws = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    return (max(float((g.cpu() - w).abs().max()) for g, w in zip(gs, ws)),
            max(float(w.abs().max()) for w in ws))


def check_slice(cfg_base):
    """cfg_base's net (res101, FPN, VGG16, MobileNet) in float32 on one
    256x320 frame: card against CPU."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections

    cfg = cfg_from_list(cfg_base, ("COMPUTE_DTYPE", "float32"))
    cpu = scale_terminators(build_detector(cfg, 2, "cpu", seed=1))
    gpu = scale_terminators(build_detector(cfg, 2, "cuda", seed=1))
    rng = np.random.RandomState(2)
    h, w = SLICE_HW
    x = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8))
    win = torch.tensor([[0.0, float(w), 0.0, float(h)]])
    with torch.inference_mode():
        c_feat = cpu.features(x)
        c_rpn = cpu.rpn_scores(c_feat)
        c_out = cpu.forward_test(x, win)
        g_feat = gpu.features(x.cuda())
        g_rpn = gpu.rpn_scores(g_feat)
        g_out = {k: v.cpu() for k, v in gpu.forward_test(x.cuda(), win.cuda()).items()}
        # second stage on the CPU's rois (pinned), so the comparison isolates it
        g_cls, g_boxes = gpu.classify_rois(g_feat, c_out["rois"].cuda(), win.cuda())
    feat_err, feat_max = feature_err(g_feat, c_feat)
    fg_err = float((g_rpn["fg_prob"].cpu() - c_rpn["fg_prob"]).abs().max())
    delta_err = float((g_rpn["deltas"].cpu() - c_rpn["deltas"]).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    fm = "p2..p5" if cfg.use_fpn else "C4"
    print(f"slice {'FPN ' if cfg.use_fpn else ''}{cfg.net_variant} fp32 {h}x{w}: {fm} max err "
          f"{feat_err} "
          f"(max|{fm}| {feat_max}); "
          f"fg_prob {fg_err}; deltas {delta_err}; proposals matched {matched}/{len(cr)} "
          f"at IoU >= 0.99; pinned cls_prob {cls_err}; pinned boxes {box_err} px")
    checks = {
        f"{fm} features": feat_err <= 1e-4 * feat_max,
        "fg_prob": fg_err <= 2e-3,
        "deltas": delta_err <= 2e-3,
        "proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "boxes": box_err <= 0.15,
    }
    kw = dict(num_classes=2, bbox_elem=4, max_dets=100,
              thresh=split_thresh(c_out["cls_prob"][..., 1], c_out["roi_valid"]), nms_thresh=0.6)
    cf = filter_detections(c_out["cls_prob"], c_out["bbox_pred"], c_out["roi_valid"], **kw)
    gf = filter_detections(*(g_out[k].cuda() for k in ("cls_prob", "bbox_pred", "roi_valid")), **kw)
    cb = cf["boxes"][0, 1][cf["valid"][0, 1]]
    gb = gf["boxes"][0, 1][gf["valid"][0, 1]].cpu()
    det_match = len(cb) == len(gb) and (
        len(cb) == 0 or bool((iou_plus1(cb, gb).max(dim=1).values >= 0.99).all()))
    print(f"slice final detections: cpu {len(cb)}, card {len(gb)}, matched {det_match}")
    checks["detections"] = det_match
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice card vs CPU out of tolerance: {failed}")


NET_NAMES = {"vgg16": "VGG16", "mobile": "MobileNet"}


def path_name(cfg, kind: str) -> str:
    """A path's name from its config: e.g. 'serving', 'UC FPN training',
    'FPN BEV serving', 'VGG16 BEV training'."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import uses_uncertainty

    parts = ["live-BN" if cfg.resnet.fixed_blocks == -1 and cfg.net_variant.startswith("res")
             else "", "UC" if uses_uncertainty(cfg) else "", NET_NAMES.get(cfg.net_variant, ""),
             "FPN" if cfg.use_fpn else "", "BEV" if cfg.net_type == "lidar" else "", kind]
    return " ".join(p for p in parts if p)


@contextlib.contextmanager
def recording_multiscale_rois(store: list):
    """Within the block, the rois of the first call of the detector's
    multiscale RoI align are appended to `store` (a float32 numpy copy),
    the call itself unchanged.  The first call puts the detector's own
    function back, so later calls (a path's timed batches and steps, after
    its warm-up) run untouched: no host copy, no wait for the card."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector

    inner = detector.multiscale_roi_align_batched

    def recorded(maps, rois, *args, **kwargs):
        detector.multiscale_roi_align_batched = inner
        store.append(rois.detach().float().cpu().numpy())
        return inner(maps, rois, *args, **kwargs)

    detector.multiscale_roi_align_batched = recorded
    try:
        yield store
    finally:
        detector.multiscale_roi_align_batched = inner


def run_serving(cfg, smi, need=("nms", "roi_align"), never=(), per_batch=None):
    """The image serving path: warm-up batch, then 3 batches, counted; the
    kernels in `need` must have launched and those in `never` not, and each
    kernel of `per_batch` exactly that many times a batch.  With uncertainty
    the warm-up batch's outputs are checked too (check_uc_outputs)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import (
        detect_batch,
        evaluate,
        filter_batch,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    batches = 3
    db = SyntheticDataset(cfg, num_frames=batches * B, num_classes=2, image_hw=FRAME_HW,
                          mode="val", seed=101)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", augment=False, shuffle=False,
                         seed=0)
    model = scale_terminators(build_detector(cfg, 2, "cuda", seed=0))
    warm = loader.peek()  # the first evaluated batch, run once to warm up
    warm_out = detect_batch(model, warm)
    filter_batch(model, warm_out, cfg.test.thresh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = evaluate(model, loader, db, batches * B, cfg.test.thresh)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    ms = np.asarray(res["detect_ms"]) + np.asarray(res["filter_ms"])
    name = path_name(cfg, "serving")
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} {FRAME_HW[0]}x{FRAME_HW[1]} batch {B} "
          f"({smi}): "
          f"detect ms/batch {res['detect_ms']}, filter ms/batch {res['filter_ms']}, "
          f"mean {float(ms.mean())} ms/batch, {B * len(ms) / (float(ms.sum()) / 1e3)} frames/s, "
          f"peak memory {peak / 2**30} GiB, random-weight mAP {res['mAP']}")
    print(f"{name}: outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError(f"{name}: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError(f"{name}: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in need) or any(launches[k] for k in never):
        raise AssertionError(f"{name}: launches {launches}, needed {need}, never {never}")
    for k, n in (per_batch or {}).items():
        print(f"{name}: {k} launched {launches[k]} times in {batches} batches (want {n} a batch)")
        if launches[k] != n * batches:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times, want {n * batches}")
    if "uncertainties" in warm_out:
        check_uc_outputs(warm_out, name)
    return launches


def check_uc_outputs(out, name):
    """Every uncertainty key of a serving batch finite and of the rois'
    leading shape, and the epistemic box variance nonzero somewhere (the MC
    samples differ)."""
    import torch

    un = {**{f"rpn {k}": v for k, v in out.get("rpn_uncertainties", {}).items()},
          **out["uncertainties"]}
    bad = [k for k, v in un.items() if not bool(torch.isfinite(v).all())
           or tuple(v.shape[:2]) != tuple(out["rois"].shape[:2])]
    print(f"{name}: uncertainty keys {sorted(un)}; max per key "
          f"{ {k: float(v.abs().max()) for k, v in un.items()} }")
    if bad or len(out["uncertainties"]) != 8 or not bool((out["uncertainties"]["e_bbox_var"] > 0).any()):
        raise AssertionError(f"{name}: uncertainty keys not finite or misshapen: {bad}, or "
                             f"e_bbox_var zero everywhere")


TRAIN_LEAVES = (
    "rpn.rpn_cls_score_net.weight", "rpn.rpn_bbox_pred_net.weight",
    "predictors.cls_score_net.weight", "predictors.bbox_pred_net.weight",
    "tail.layer4.0.conv1.weight",
)
FPN_TRAIN_LEAVES = TRAIN_LEAVES[:4] + (
    "tail.t_fc1.weight", "fpn.latlayer2.weight", "fpn.aalayer2.weight",
    "backbone.layer4.0.conv1.weight",
)
VGG_TRAIN_LEAVES = TRAIN_LEAVES[:4] + (
    "tail.fc6.weight", "tail.fc7.weight", "backbone.late_conv12.weight",
    "backbone.early_conv0.weight",
)
MOBILE_TRAIN_LEAVES = TRAIN_LEAVES[:4] + (
    "tail.layer13.pointwise.weight", "tail.layer12.depthwise.weight",
    "backbone.layer11.pointwise.weight", "backbone.conv0.weight",
)


def train_leaves(cfg) -> tuple:
    """The leaves whose gradients a train slice compares: the RPN's and the
    predictors', and the net's own (the last block of layer3 for ResNet)."""
    if cfg.net_variant == "vgg16":
        return VGG_TRAIN_LEAVES
    if cfg.net_variant == "mobile":
        return MOBILE_TRAIN_LEAVES
    return FPN_TRAIN_LEAVES if cfg.use_fpn else TRAIN_LEAVES
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")


def train_slice_batch(cfg, cpu, rng):
    """One training frame for the train slice and its GT, jittered copies of
    some of the CPU model's proposals (so proposals are sampled as fg):
    image: a random 256x320 frame, (1, G, 5) GT; lidar: a synthetic 400 x 350
    x 15 raster (the voxelizer's twin), (1, G, 8) 7-DoF GT on the proposals'
    footprints and their 3D anchors' z and h, turned by up to 0.3 rad."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    lidar = cfg.net_type == "lidar"
    if lidar:
        frame = SyntheticDataset(cfg, num_frames=1, mode="train", seed=7).frame(0)
        pts = torch.from_numpy(frame["points"])[None]
        x = voxelize_bev(pts, torch.ones(pts.shape[:2], dtype=torch.bool),
                         **raster_kwargs(cfg, float(cfg.train.scales[0])))
        win = torch.from_numpy(frame["window"])[None]
    else:
        h, w = SLICE_HW
        x = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8))
        win = torch.tensor([[0.0, float(w), 0.0, float(h)]])
    with torch.no_grad():
        feat = cpu.features(x)
        fm = cpu.rpn_map(feat)
        anchors, anchors_3d = cpu.anchor_grids(fm.shape[1], fm.shape[2], "cpu", "train")
        rois, _scores, valid, src = cpu._propose_batch(cpu.rpn_scores(feat), anchors, win, "train")
    pick = torch.nonzero(valid[0])[:, 0][::9][:6]
    props, n = rois[0][pick], len(pick)
    mask = torch.zeros((1, cfg.static.max_gt), dtype=torch.bool)
    mask[0, :n] = True
    if not lidar:
        gt = torch.zeros((1, cfg.static.max_gt, 5))
        gt[0, :n, :4] = props + torch.from_numpy(rng.uniform(-2, 2, (n, 4)).astype(np.float32))
        gt[0, :n, 4] = 1
        return x, win, gt, mask
    a3d = anchors_3d[src[0][pick]]
    jitter = lambda lo, hi, *shape: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, (n,) + shape).astype(np.float32))
    gt = torch.zeros((1, cfg.static.max_gt, 8))
    gt[0, :n, 0:2] = (props[:, :2] + props[:, 2:]) / 2 + jitter(-1, 1, 2)
    gt[0, :n, 2] = a3d[:, 2]
    gt[0, :n, 3:5] = (props[:, 2:] - props[:, :2]) * jitter(0.9, 1.1, 2)
    gt[0, :n, 5] = a3d[:, 5]
    gt[0, :n, 6] = jitter(-0.3, 0.3)
    gt[0, :n, 7] = 1
    return x, win, gt, mask


def check_train_slice(cfg_base):
    """cfg_base's net (res101 C4 or FPN, VGG16, MobileNet) in float32,
    training forward and backward on one frame (image 256x320, or a 400 x
    350 x 15 BEV raster with 7-DoF GT): card against CPU, on the same
    draws; the card's second stage pinned to the CPU's proposal lanes (its
    boxes still come from the card's deltas), each ReLU unit at 0 within
    rounding to the CPU's gate and, on VGG16 (the only net with max-pool
    modules, pool_sites), each max-pool window whose two largest values tie
    within rounding to the CPU's pick (card_ties; ties_few: few, and
    small); the gradients of train_leaves(cfg) compared.  Unpinned, one
    such tie reaches a leaf's gradient at up to 1e-3 of its max|g| on the
    res101 FPN BEV slice and 5e-3 on VGG16's first conv."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import TrainDraws
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        create_train_state,
        draw_train_keys,
    )

    cfg = cfg_from_list(cfg_base, (
        "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "64",
        "STATIC.NMS_PRE_TRAIN", "1024", "TRAIN.RPN_POST_NMS_TOP_N", "256",
    ))
    cpu, _ = create_train_state(cfg, 2, "cpu", seed=1)
    gpu, _ = create_train_state(cfg, 2, "cuda", seed=1)
    scale_terminators(cpu), scale_terminators(gpu)
    rng = np.random.RandomState(3)
    x, win, gt, mask = train_slice_batch(cfg, cpu, rng)
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": win}
    draws = draw_train_keys(cpu, batch, torch.Generator().manual_seed(4))
    with relu_inputs(cpu) as c_relu, pool_inputs(cpu) as c_pool:
        c_losses, c_aux = cpu.forward_train(x, gt, mask, win, draws)
    c_losses["total_loss"].backward()
    pin = (c_aux.proposal_src.cuda(), c_aux.proposal_valid.cuda())
    g_draws = TrainDraws(*(None if t is None else t.cuda() for t in draws))
    g_args = (x.cuda(), gt.cuda(), mask.cuda(), win.cuda(), g_draws)
    ties, pools = card_ties(gpu, c_relu, g_args, pin, c_pool)
    with pinned_ties(gpu, ties), pinned_pool_ties(gpu, pools):
        g_losses, g_aux = gpu.forward_train(*g_args, proposals=pin)
    g_losses["total_loss"].backward()
    torch.cuda.synchronize()
    few, units, tie_size = ties_few(ties, c_relu, pools, c_pool)

    checks = {
        "ties few": few,
        "anchor samples": torch.equal(g_aux.anchor_targets.sel.cpu(), c_aux.anchor_targets.sel)
        and torch.equal(g_aux.anchor_targets.labels.cpu(), c_aux.anchor_targets.labels),
        "roi labels": torch.equal(g_aux.proposal_targets.labels.cpu(), c_aux.proposal_targets.labels),
    }
    loss_err = {}
    for k in LOSSES:
        c, g = float(c_losses[k].detach()), float(g_losses[k].detach())
        loss_err[k] = abs(g - c) / max(abs(c), 1e-12)
        checks[f"loss {k}"] = loss_err[k] <= 1e-3 and np.isfinite(g)
    grad_err = {}
    c_params, g_params = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    leaves = train_leaves(cfg)
    if cfg.net_variant.startswith("res"):
        leaves += (f"backbone.layer3.{len(cpu.backbone.layer3) - 1}.conv3.weight",)
    for name in leaves:
        cg, gg = c_params[name].grad, g_params[name].grad
        scale = float(cg.abs().max())
        grad_err[name] = float((gg.cpu() - cg).abs().max()) / scale
        checks[f"grad {name}"] = scale > 0 and grad_err[name] <= 1e-3
    labels = c_aux.proposal_targets.labels
    kind = ("BEV " if cfg.net_type == "lidar" else "") + ("FPN " if cfg.use_fpn else "")
    print(f"train slice {kind}{cfg.net_variant} fp32 {tuple(x.shape)}: losses cpu "
          f"{ {k: float(c_losses[k].detach()) for k in LOSSES} }, relative errors {loss_err} "
          f"(rpn losses unpinned, second stage pinned); sampled RoIs fg {int((labels > 0).sum())} "
          f"bg {int((labels == 0).sum())}; gradient error / max|g| per leaf {grad_err}; ReLU "
          f"units pinned to the CPU's gate {len(ties)} of {units}, the largest |input| / "
          f"max|input| of its ReLU {tie_size}; max-pool windows pinned to the CPU's pick "
          f"{len(pools)}, the largest gap / max|input| of its pool "
          f"{max((t[3] for t in pools), default=0.0)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train slice card vs CPU out of tolerance: {failed}")


def relu_sites(model):
    """The detector's ReLU inputs: {(module path, residual): (module,
    block)}.  Each module's output is a ReLU's input (bn1/bn2 of a block, the
    stem's bn1, the RPN's 3x3 conv, the FPN tail's t_fc layers, VGG16's
    convs and fc6/fc7, MobileNet's bn0, dw_bn and pw_bn (ReLU6: its gate at
    0), the epistemic stacks' fc or BN layers); with
    residual=True it is the block's terminator, whose output plus the
    block's identity is."""
    import torch

    sites = {("rpn.rpn_net", False): (model.rpn.rpn_net, None)}
    if hasattr(model.backbone, "bn1"):  # the ResNet stem
        sites[("backbone.bn1", False)] = (model.backbone.bn1, None)
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if hasattr(m, "terminator"):
            for k in ("bn1", "bn2", "bn3"):
                if hasattr(m, k):
                    bn = getattr(m, k)
                    sites[(f"{name}.{k}", bn is m.terminator)] = (bn, m)
        elif isinstance(m, torch.nn.Linear) and name.startswith(("tail.t_fc", "tail.fc")):
            sites[(name, False)] = (m, None)
        elif ((name.startswith("backbone.") and leaf.startswith(("early_conv", "late_conv")))
              or leaf in ("bn0", "dw_bn", "pw_bn")):
            sites[(name, False)] = (m, None)
        elif name in ("predictors.cls_stack", "predictors.bbox_stack"):
            # an epistemic stack's fc (or its BN under lidar) feeds each ReLU
            for i in (1, 2):
                k = f"{m.prefix}_bn{i}" if hasattr(m, f"{m.prefix}_bn{i}") else f"{m.prefix}_fc{i}"
                sites[(f"{name}.{k}", False)] = (getattr(m, k), None)
    return sites


@contextlib.contextmanager
def relu_inputs(model):
    """Within the block, record each ReLU input of the model's forward
    (relu_sites): a dict that receives {(path, residual): float32 CPU
    tensor} as the forward runs.  Hooks added after this block's start run
    after these, so enter pinned_ties first to record pinned inputs."""
    got, hooks, out = {}, [], {}
    sites = relu_sites(model)
    for (path, residual), (mod, block) in sites.items():
        hooks.append(mod.register_forward_hook(
            lambda _m, _a, o, key=path: got.__setitem__(key, o.detach())))
        if residual and block.downsample is not None:
            hooks.append(block.downsample.register_forward_hook(
                lambda _m, _a, o, key=path: got.__setitem__(("id", key), o.detach())))
        elif residual:
            hooks.append(block.register_forward_pre_hook(
                lambda _m, args, key=path: got.__setitem__(("id", key), args[0].detach())))
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()
    for path, residual in sites:
        x = got[path] + got[("id", path)] if residual else got[path]
        out[(path, residual)] = x.float().cpu()


def find_ties(want: dict, got: dict, skip=()) -> list:
    """The ReLU units whose input has another sign in `got` than in `want`
    (relu_inputs of two runs, in the port's layout): (path, residual,
    index, wanted input, input, max|wanted input| of that ReLU), except
    those at (path, residual, index) in `skip`.  Such a unit sits at 0
    within float32 rounding and passes gradient in one run only; with live
    BN its error reaches its whole channel through the batch statistics."""
    ties = []
    for key, w in want.items():
        g = got[key]
        for at in map(tuple, ((w > 0) != (g > 0)).nonzero().tolist()):
            if key + (at,) not in skip:
                ties.append(key + (at, float(w[at]), float(g[at]), float(w.abs().max())))
    return ties


@contextlib.contextmanager
def pinned_ties(model, ties):
    """Within the block, the model's input to each tied ReLU unit (find_ties)
    takes the wanted sign: a constant of the size of the unit's float32
    rounding is added to the feeding module's output at that unit (for the
    residual ReLU, whose input adds the block's identity, the
    terminator's).  The gradient still flows through the module, and the
    unit's gate is the wanted one."""
    import torch

    hooks, identity = [], {}
    for path, residual, at, want, *_ in ties:
        mod = model.get_submodule(path)
        block = model.get_submodule(path.rsplit(".", 1)[0]) if residual else None
        if residual and block.downsample is not None:
            hooks.append(block.downsample.register_forward_hook(
                lambda _m, _a, out, key=path: identity.__setitem__(key, out.detach())))
        elif residual:
            hooks.append(block.register_forward_pre_hook(
                lambda _m, args, key=path: identity.__setitem__(key, args[0].detach())))

        def pin(_m, _a, out, key=path, residual=residual, at=at, want=want):
            base = identity[key][at] if residual else out.new_zeros(())
            v = out[at].detach()
            d = torch.tensor(want, dtype=out.dtype, device=out.device) - (v + base)
            toward = torch.tensor(np.inf if want > 0 else -np.inf, dtype=out.dtype,
                                  device=out.device)
            while bool(((v + d) + base > 0) != (want > 0)):  # the block's float32 order
                d = torch.nextafter(d, toward)
            delta = torch.zeros_like(out)
            delta[at] = d
            return out + delta

        hooks.append(mod.register_forward_hook(pin))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def pool_sites(model) -> dict:
    """The model's 2x2 max pools as modules (VGG16's pool0..3): {path: module}."""
    import torch

    return {name: m for name, m in model.named_modules() if isinstance(m, torch.nn.MaxPool2d)}


@contextlib.contextmanager
def pool_inputs(model):
    """Within the block, record each pool_sites input of the model's
    forward: a dict that receives {path: float32 CPU tensor}."""
    got, hooks = {}, []
    for path, mod in pool_sites(model).items():
        hooks.append(mod.register_forward_pre_hook(
            lambda _m, args, key=path: got.__setitem__(key, args[0].detach().float().cpu())))
    try:
        yield got
    finally:
        for h in hooks:
            h.remove()


def find_pool_ties(want: dict, got: dict, skip=()) -> list:
    """The 2x2 max-pool windows whose largest element is another one in
    `got` than in `want` (pool_inputs of two runs), their largest value
    above 0: (path, (n, c, oy, ox), the wanted element's flat index in its
    plane, the gap), except those at (path, (n, c, oy, ox)) in `skip`.  The
    gap is the larger of the two runs' differences between the window's
    largest value and its value at the other run's pick, over max|input| of
    that pool in `want`: for a tie it is rounding-sized (ties_few bounds
    it), and the pool routes the gradient to another pixel on each device.
    (A window of zeros passes no gradient below its ReLU, whichever zero it
    picks.)"""
    import torch

    ties = []
    for path, w in want.items():
        g = got[path]
        wv, wi = torch.nn.functional.max_pool2d(w, 2, 2, return_indices=True)
        gv, gi = torch.nn.functional.max_pool2d(g, 2, 2, return_indices=True)
        scale = float(w.abs().max())
        w_flat, g_flat = w.flatten(2), g.flatten(2)
        for at in map(tuple, ((wi != gi) & (gv > 0)).nonzero().tolist()):
            if (path, at) in skip:
                continue
            n, c = at[:2]
            gap = max(float(wv[at] - w_flat[n, c, int(gi[at])]),
                      float(gv[at] - g_flat[n, c, int(wi[at])]))
            ties.append((path, at, int(wi[at]), gap / scale))
    return ties


@contextlib.contextmanager
def pinned_pool_ties(model, ties):
    """Within the block, each tied window's wanted element (find_pool_ties)
    is the largest of its window in the model's pool input: the gap to the
    window's largest value and 2^-20 of that value are added to it (a
    constant: the gradient still flows), so the pool picks the wanted
    element."""
    import torch

    hooks = []
    for path, mod in pool_sites(model).items():
        mine = [(at, idx) for p, at, idx, _gap in ties if p == path]
        if not mine:
            continue

        def pin(_m, args, mine=mine):
            x = args[0]
            delta = torch.zeros_like(x)
            w = x.shape[-1]
            for (n, c, oy, ox), idx in mine:
                top = x[n, c, 2 * oy:2 * oy + 2, 2 * ox:2 * ox + 2].max().detach()
                v = x[n, c, idx // w, idx % w].detach()
                delta[n, c, idx // w, idx % w] = top - v + top.abs() * 2.0 ** -20
            return (x + delta,)

        hooks.append(mod.register_forward_pre_hook(pin))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def card_ties(gpu, c_relu, g_args, pin, c_pool=None, rounds=4) -> tuple:
    """The ReLU units of the card's forward_train(*g_args, proposals=pin)
    whose input has another sign than in the CPU's (`c_relu`, relu_inputs
    of its forward), and with `c_pool` (pool_inputs of the CPU's forward)
    the max-pool windows that pick another element (find_pool_ties),
    collected on copies of the card's model with those found so far pinned
    (pinned_ties, pinned_pool_ties), until none is new.  Returns (ReLU
    ties, pool ties)."""
    import copy

    import torch

    ties, pools = [], []
    for _ in range(rounds):
        probe = copy.deepcopy(gpu)
        with pinned_ties(probe, ties), pinned_pool_ties(probe, pools), \
                relu_inputs(probe) as g_relu, pool_inputs(probe) as g_pool, torch.no_grad():
            probe.forward_train(*g_args, proposals=pin)
        new = find_ties(c_relu, g_relu, skip={tie[:3] for tie in ties})
        new_pools = (find_pool_ties(c_pool, g_pool, skip={t[:2] for t in pools})
                     if c_pool else [])
        if not new and not new_pools:
            break
        ties += new
        pools += new_pools
    return ties, pools


def ties_few(ties, c_relu, pools=(), c_pool=None) -> tuple:
    """(whether the ties are few: at most 1e-5 of the ReLU units, each
    within 1e-4 of its ReLU's max|input| of 0, and at most 1e-5 of the
    pool windows, each's gap (find_pool_ties) within 1e-4 of its pool's
    max|input|, the bound of the ReLU ties on the same convs' outputs; the
    units; the largest ReLU tie)."""
    units = sum(v.numel() for v in c_relu.values())
    windows = sum(v.numel() // 4 for v in (c_pool or {}).values())
    size = max((max(abs(w), abs(g)) / m for *_, w, g, m in ties), default=0.0)
    gap = max((t[3] for t in pools), default=0.0)
    return (len(ties) <= 1e-5 * units and size <= 1e-4 and len(pools) <= 1e-5 * max(windows, 1)
            and gap <= 1e-4, units, size)


LIVE_OVERRIDES = ("RESNET.FIXED_BLOCKS", "-1")
RES18_LIVE = ("NET_VARIANT", "res18") + LIVE_OVERRIDES


def check_live_slice(cfg_base):
    """res18 live-BN float32 training forward and backward on one frame
    (image 256x320, or a 400 x 350 x 15 BEV raster with 7-DoF GT): card
    against CPU on the same draws, the card's second stage pinned to the
    CPU's proposal lanes and each ReLU unit whose input takes another sign
    on the card given the CPU's (relu_inputs, find_ties, pinned_ties; found
    until none is new).  Equal samples, the four losses within rtol 1e-3,
    every leaf's gradient within 1e-3 * max|g| of the leaf, the running
    statistics after the step within 1e-5 of max.  Then in eval mode on
    those statistics the serving slice's checks: features within 1e-4 of
    max, fg_prob within 2e-3, proposals matched, and on the CPU's rois
    cls_prob within 3e-3 of max and the boxes within 0.15."""
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import TrainDraws, live_bn_stats
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        create_train_state,
        draw_train_keys,
    )

    cfg = cfg_from_list(cfg_base, RES18_LIVE + (
        "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "64",
        "STATIC.NMS_PRE_TRAIN", "1024", "TRAIN.RPN_POST_NMS_TOP_N", "256",
    ))
    lidar = cfg.net_type == "lidar"
    cpu, _ = create_train_state(cfg, 2, "cpu", seed=1)
    scale_terminators(cpu)  # zero at init: the branches' leaves would get no gradient
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(3)
    x, win, gt, mask = train_slice_batch(cfg, copy.deepcopy(cpu).eval(), rng)
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": win}
    draws = draw_train_keys(cpu, batch, torch.Generator().manual_seed(4))
    start = {k: v.clone() for k, v in live_bn_stats(cpu).items()}
    with relu_inputs(cpu) as c_relu:
        c_losses, c_aux = cpu.forward_train(x, gt, mask, win, draws)
    c_losses["total_loss"].backward()
    pin = (c_aux.proposal_src.cuda(), c_aux.proposal_valid.cuda())
    g_draws = TrainDraws(*(None if t is None else t.cuda() for t in draws))
    g_args = (x.cuda(), gt.cuda(), mask.cuda(), win.cuda(), g_draws)
    ties, _ = card_ties(gpu, c_relu, g_args, pin)
    with pinned_ties(gpu, ties):
        g_losses, g_aux = gpu.forward_train(*g_args, proposals=pin)
    g_losses["total_loss"].backward()
    torch.cuda.synchronize()

    checks = {
        "anchor samples": torch.equal(g_aux.anchor_targets.sel.cpu(), c_aux.anchor_targets.sel),
        "roi labels": torch.equal(g_aux.proposal_targets.labels.cpu(), c_aux.proposal_targets.labels),
        "ties few": len(ties) <= 32 and all(
            max(abs(w), abs(g)) <= 1e-5 * m for *_, w, g, m in ties),
    }
    loss_err = {}
    for k in LOSSES:
        c, g = float(c_losses[k].detach()), float(g_losses[k].detach())
        loss_err[k] = abs(g - c) / max(abs(c), 1e-12)
        checks[f"loss {k}"] = loss_err[k] <= 1e-3 and np.isfinite(g)
    g_params = dict(gpu.named_parameters())
    grad_err = {}
    for name, cp in cpu.named_parameters():
        cg, gg = cp.grad, g_params[name].grad
        scale = float(cg.abs().max())
        grad_err[name] = float((gg.cpu() - cg).abs().max()) / max(scale, 1e-30)
        checks[f"grad {name}"] = scale > 0 and grad_err[name] <= 1e-3
    g_stats = live_bn_stats(gpu)
    stat_err = {}
    for k, cv in live_bn_stats(cpu).items():
        stat_err[k] = float((g_stats[k].cpu() - cv).abs().max()) / float(cv.abs().max())
        checks[f"stats {k}"] = stat_err[k] <= 1e-5 and not torch.equal(cv, start[k])
    worst = max(grad_err, key=grad_err.get)
    kind = "BEV " if lidar else ""
    print(f"live-BN slice {kind}res18 fp32 {tuple(x.shape)}: losses cpu "
          f"{ {k: float(c_losses[k].detach()) for k in LOSSES} }, relative errors {loss_err}; "
          f"{len(grad_err)} leaves, largest gradient error / max|g| {grad_err[worst]} ({worst}); "
          f"running statistics ({len(stat_err)} buffers) largest error / max "
          f"{max(stat_err.values())}; ReLU units pinned to the CPU's gate {len(ties)}: "
          f"{[t[:3] for t in ties]}")

    cpu.eval(), gpu.eval()
    with torch.inference_mode():
        c_feat, g_feat = cpu.features(x), gpu.features(x.cuda())
        c_fg, g_fg = cpu.rpn_scores(c_feat)["fg_prob"], gpu.rpn_scores(g_feat)["fg_prob"]
        c_out = cpu.forward_test(x, win)
        g_out = {k: v.cpu() for k, v in gpu.forward_test(x.cuda(), win.cuda()).items()}
        a3d = c_out["anchors_3d"].cuda() if lidar else None
        g_cls, g_boxes = gpu.classify_rois(g_feat, c_out["rois"].cuda(), win.cuda(), a3d)
    feat_err, feat_max = feature_err(g_feat, c_feat)
    fg_err = float((g_fg.cpu() - c_fg).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    print(f"live-BN slice {kind}eval on the running statistics: C4 max err {feat_err} (max|C4| "
          f"{feat_max}); fg_prob {fg_err}; proposals matched {matched}/{len(cr)}; pinned "
          f"cls_prob {cls_err}; pinned boxes {box_err}")
    checks.update({
        "eval features": feat_err <= 1e-4 * feat_max,
        "eval fg_prob": fg_err <= 2e-3,
        "eval proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "eval cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "eval boxes": box_err <= 0.15,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"live-BN slice card vs CPU out of tolerance: {failed}")


UC_SLICE_OVERRIDES = UC_ALL_OVERRIDES + (
    "NET_VARIANT", "res50", "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "64",
    "STATIC.NMS_PRE_TRAIN", "1024", "TRAIN.RPN_POST_NMS_TOP_N", "256",
)
RPN_1X1 = ("rpn_cls_score_net", "rpn_bbox_pred_net", "rpn_bbox_al_var_net", "rpn_cls_al_var_net")


def scale_rpn_heads(model, value=0.02):
    """The RPN's 1x1 heads (scores, deltas and their log-variances) times
    `value`: on random res50 weights they give logits of ~300 and
    log-variances whose exp overflows float32; a trained RPN's are a few
    units."""
    import torch

    with torch.no_grad():
        for name, m in model.named_modules():
            if name.split(".")[-1] in RPN_1X1:
                m.weight.mul_(value)
    return model


def uc_slack(key: str, t: int, classes: int) -> float:
    """Beside a share of max|x|, the float32 rounding of the terms an
    uncertainty key cancels: e_cls_var is sum(p^2) - (sum p)^2 / T over T
    softmaxes (terms up to T / (T - 1)), a mutual information the entropy of
    the mean less the mean entropy (terms up to log2(classes) bits)."""
    if key == "e_cls_var":
        return 4 * EPS32 * t / (t - 1)
    if key.endswith("mutual_info"):
        return 4 * EPS32 * np.log2(classes)
    return 0.0


def check_uc_slice(cfg_base):
    """Uncertainty, res50 float32 with every UC flag, on one frame (image
    256x320, or a 400 x 350 x 15 BEV raster): card against CPU on the same
    weights, dropout masks and normals (drawn on the CPU, recorded, handed
    to the card).  Serving: forward_test, the card's second stage and RPN
    uncertainties pinned to the CPU's proposals (its own NMS still runs):
    cls_prob within 3e-3 of max, the boxes within 0.15, each of the 8
    detection and 8 RPN keys within 1e-3 of max (plus uc_slack).
    Training: forward_train and backward, the card pinned to the CPU's
    proposal lanes and ReLU gates: equal samples, the losses (a_mutual_info
    too) within rtol 1e-3, every leaf's gradient within 1e-3 * max|g|."""
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import TrainDraws, UCDraws
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        create_train_state,
        draw_train_keys,
    )

    cfg = cfg_from_list(cfg_base, UC_SLICE_OVERRIDES)
    lidar = cfg.net_type == "lidar"
    kind = ("BEV " if lidar else "") + ("FPN " if cfg.use_fpn else "")
    cpu, _ = create_train_state(cfg, 2, "cpu", seed=1)
    scale_rpn_heads(scale_terminators(cpu))
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(3)
    x, win, gt, mask = train_slice_batch(cfg, copy.deepcopy(cpu).eval(), rng)

    def on_card(d):
        return {k: v.cuda() for k, v in d.items()}

    # serving, in eval mode
    cpu.eval(), gpu.eval()
    props = {}
    c_propose, g_propose = cpu._propose_batch, gpu._propose_batch
    cpu._propose_batch = lambda *a, **k: props.setdefault("cpu", c_propose(*a, **k))

    def pinned(*a, **k):
        props["card"] = g_propose(*a, **k)
        return tuple(t.cuda() for t in props["cpu"])

    gpu._propose_batch = pinned
    c_draws = UCDraws(torch.Generator().manual_seed(5), record=True)
    try:
        with torch.inference_mode():
            c_out = cpu.forward_test(x, win, c_draws)
            g_out = gpu.forward_test(x.cuda(), win.cuda(),
                                     UCDraws(masks=on_card(c_draws.masks),
                                             normals=on_card(c_draws.normals)))
    finally:
        del cpu._propose_batch, gpu._propose_batch
    torch.cuda.synchronize()
    cr = props["cpu"][0][0][props["cpu"][2][0]]
    gr = props["card"][0][0][props["card"][2][0]].cpu()
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    t = cfg.uc.e_num_sample
    errs, checks = {}, {"own proposals": len(cr) > 0 and matched >= 0.95 * len(cr)}
    cls_err = float((g_out["cls_prob"].cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_out["bbox_pred"].cpu() - c_out["bbox_pred"]).abs().max())
    checks["cls_prob"] = cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max())
    checks["boxes"] = box_err <= 0.15
    for stage, classes in (("uncertainties", 2), ("rpn_uncertainties", 2)):
        if len(c_out[stage]) != 8:
            checks[f"{stage} keys"] = False
        for k, want in c_out[stage].items():
            got = g_out[stage][k].cpu()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            errs[f"{stage[:3]} {k}"] = err / max(scale, 1e-30)
            checks[f"{stage} {k}"] = (bool(torch.isfinite(got).all()) and scale > 0
                                      and err <= 1e-3 * scale + uc_slack(k, t, classes))
    print(f"UC slice {kind}res50 fp32 {tuple(x.shape)}, T = {t}, every UC flag: card's own "
          f"proposals matched {matched}/{len(cr)}; pinned to the CPU's: cls_prob {cls_err}, "
          f"boxes {box_err}; uncertainty error / max|x| {errs}")

    # training, in train mode, frozen BN
    cpu.train(), gpu.train()
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": win}
    draws = draw_train_keys(cpu, batch, torch.Generator().manual_seed(4))
    draws = draws._replace(uc=UCDraws(torch.Generator().manual_seed(6), record=True))
    with relu_inputs(cpu) as c_relu:
        c_losses, c_aux = cpu.forward_train(x, gt, mask, win, draws)
    c_losses["total_loss"].backward()
    pin = (c_aux.proposal_src.cuda(), c_aux.proposal_valid.cuda())
    g_draws = TrainDraws(*(None if v is None else v.cuda() for v in draws[:5]),
                         UCDraws(masks=on_card(draws.uc.masks), normals=on_card(draws.uc.normals)))
    g_args = (x.cuda(), gt.cuda(), mask.cuda(), win.cuda(), g_draws)
    ties, _ = card_ties(gpu, c_relu, g_args, pin)
    with pinned_ties(gpu, ties):
        g_losses, g_aux = gpu.forward_train(*g_args, proposals=pin)
    g_losses["total_loss"].backward()
    torch.cuda.synchronize()
    checks["anchor samples"] = torch.equal(g_aux.anchor_targets.sel.cpu(), c_aux.anchor_targets.sel)
    checks["roi labels"] = torch.equal(g_aux.proposal_targets.labels.cpu(),
                                       c_aux.proposal_targets.labels)
    # res50's C4 tail alone has 64 RoIs x 49 x 9,216 ReLU units: few is a
    # share of them, each at 0 within the rounding of its ReLU's input (in
    # the tail that of the pooled RoIs, whose boxes each device rebuilds
    # from its own RPN deltas)
    checks["ties few"], units, tie_size = ties_few(ties, c_relu)
    loss_err = {}
    for k in LOSSES + ("a_mutual_info",):
        c, g = float(c_losses[k].detach()), float(g_losses[k].detach())
        loss_err[k] = abs(g - c) / max(abs(c), 1e-12)
        checks[f"loss {k}"] = loss_err[k] <= 1e-3 and np.isfinite(g)
    g_params = dict(gpu.named_parameters())
    grad_err = {}
    for name, cp in cpu.named_parameters():
        if not cp.requires_grad:
            continue
        cg, gg = cp.grad, g_params[name].grad
        if cg is None:  # a layer the forward never applies (the FPN's aalayer4)
            checks[f"grad {name}"] = gg is None
            continue
        scale = float(cg.abs().max())
        grad_err[name] = float((gg.cpu() - cg).abs().max()) / max(scale, 1e-30)
        checks[f"grad {name}"] = scale > 0 and grad_err[name] <= 1e-3
    worst = max(grad_err, key=grad_err.get)
    print(f"UC training slice {kind}res50 fp32: losses cpu "
          f"{ {k: float(c_losses[k].detach()) for k in loss_err} }, relative errors {loss_err}; "
          f"{len(grad_err)} leaves, largest gradient error / max|g| {grad_err[worst]} ({worst}); "
          f"ReLU units pinned to the CPU's gate {len(ties)} of {units}, the largest "
          f"|input| / max|input| of its ReLU {tie_size}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"UC slice card vs CPU out of tolerance: {failed}")


def run_training(cfg, smi, need=("nms", "roi_align", "roi_align_bwd"), scale=True):
    """The training path: warm-up step, then TRAIN_STEPS steps, counted; the
    kernels in `need` must have launched.  Image frames are 512x960; a lidar
    config's loader rasterizes synthetic LiDAR frames on the card.  With
    scale the residual terminators start at 0.25 (frozen BN), else as
    init_params leaves them (zero under live BN).  Returns the launches and
    the model."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state, train

    db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", seed=0)
    model, optimizer = create_train_state(cfg, 2, "cuda", seed=0)
    if scale:
        scale_terminators(model)
    generator = torch.Generator(device="cuda").manual_seed(0)
    warm = train(model, optimizer, loader, 1, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = train(model, optimizer, loader, TRAIN_STEPS, generator)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    ms = np.asarray(res["ms"])
    finite = all(np.isfinite(v) for losses in warm["losses"] + res["losses"] for v in losses.values())
    lidar = cfg.net_type == "lidar"
    live = cfg.resnet.fixed_blocks == -1 and cfg.net_variant.startswith("res")
    name = path_name(cfg, "training")
    frames = (f"raster {tuple(loader.peek()['data'].shape)}" if lidar
              else f"{FRAME_HW[0]}x{FRAME_HW[1]}")
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} {frames} batch {B} ({smi}): "
          f"warm-up step {warm['ms'][0]} ms; ms/step {res['ms']}; mean {float(ms.mean())} ms, "
          f"median {float(np.median(ms))} ms (min {float(ms.min())}, max {float(ms.max())}), "
          f"{B / (float(ms.mean()) / 1e3)} frames/s, peak memory {peak / 2**30} GiB")
    for i, losses in enumerate(res["losses"]):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v}" for k, v in losses.items()))
    print(f"{name}: losses finite {finite}, kernel launches {launches}")
    if not finite:
        raise AssertionError(f"{name}: a non-finite loss")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    if live:
        check_live_stats(model, name)
    return launches, model


SOLVER_OVERRIDES = ("TRAIN.DISPLAY", "5", "TRAIN.SNAPSHOT_KEPT", "10", "TRAIN.EN_ACT_SUMMARIES",
                    "True", "TRAIN.DRAW_VAL_DETECTIONS", "False")
SOLVER_RTOL = 1e-3
LOADER_BATCHES = 5  # batches the loader's host time is taken over
BARE_STEPS = 5  # steps of the bare train loop beside the Solver


def run_solver_path(cfg, smi, steps, snap, need):
    """The Solver path (training.solver.Solver, as tools/trainval_net_torch.py
    drives it): synthetic train and val loaders, the train loader's prefetch
    on, the val cycle every 5 steps (val losses and activation summaries; no
    drawing, so that the script needs no PIL), snapshots at `snap` and at
    `steps`, counted.
    Then a new Solver in the same output directory resumes from iter_<snap>
    (the later snapshot removed) and runs to `steps`: its losses must equal
    the first run's within SOLVER_RTOL.  Then, timed alone in this process,
    the loader's host ms a batch (next() without prefetch) and the bare
    train loop's ms a step.  Returns the first run's launches and its
    device ms a step (median), wall ms a step and peak memory."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import live_bn_stats
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    cfg = cfg_from_list(cfg, SOLVER_OVERRIDES + ("TRAIN.SNAPSHOT_ITERS", str(snap)))
    lidar = cfg.net_type == "lidar"
    name = f"Solver path ({'BEV' if lidar else 'image'})"
    out = REPO / "build" / "chip_smoke_solver"
    shutil.rmtree(out, ignore_errors=True)
    train_db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    val_db = SyntheticDataset(cfg, num_frames=2 * B, num_classes=2, image_hw=FRAME_HW, seed=101,
                              mode="val")

    def solver():
        train_loader = BatchLoader(train_db, cfg, B, device="cuda", seed=cfg.rng_seed)
        val_loader = BatchLoader(val_db, cfg, B, device="cuda", augment=False,
                                 seed=cfg.rng_seed + 1)
        model, _ = S.create_train_state(cfg, 2, "cuda", seed=0)
        return S.Solver(cfg, scale_terminators(model), train_loader, val_loader,
                        output_dir=str(out))

    try:
        first = solver()
        n_stats = len(live_bn_stats(first.model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        res = first.train(steps)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCH_COUNTS)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        raster_thread = first.train_loader.last_raster_thread
        with open(out / "tb_val" / "scalars.jsonl") as f:
            val = [json.loads(line) for line in f]
        snaps = sorted((p.name for p in (out / "checkpoints").iterdir()),
                       key=lambda n: int(n.split("_")[1]))
        for p in (out / "checkpoints").iterdir():
            if int(p.name.split("_")[1]) > snap:
                p.unlink()
        again = solver()
        resumed = again.train(steps)
        torch.cuda.synchronize()
        # one snapshot write and one val cycle, timed alone
        t0 = time.perf_counter()
        again.snapshot(steps + 1)
        snap_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again._val_cycle(steps + 1)
        torch.cuda.synchronize()
        val_ms = (time.perf_counter() - t0) * 1e3

        # the loader's host time a batch, and the bare loop on the trained model
        plain = BatchLoader(train_db, cfg, B, device="cuda", seed=cfg.rng_seed)
        host_ms = []
        for _ in range(LOADER_BATCHES):
            t0 = time.perf_counter()
            plain.next()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        model = first.model
        t0 = time.perf_counter()
        bare = S.train(model, DetectorSGD(model, cfg), plain, BARE_STEPS,
                       torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        bare_wall = (time.perf_counter() - t0) * 1e3 / BARE_STEPS
    finally:
        shutil.rmtree(out, ignore_errors=True)

    want, got = res["history"][snap:], resumed["history"]
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for g, w in zip(got, want) for k in w)
    bitwise = got == want
    finite = all(np.isfinite(v) for losses in res["history"] + got for v in losses.values())
    print(f"{name}: {cfg.net_variant} {cfg.compute_dtype} batch {B}, prefetch on, val every "
          f"{cfg.train.display} steps, snapshots {snaps}; TRAIN.DRAW_VAL_DETECTIONS False "
          f"(the script needs no PIL; the drawing is tested on the CPU)")
    n_val, n_snap = steps // cfg.train.display, len(snaps)
    steady = (res["wall_s"] * 1e3 - res["ms"][0] - n_val * val_ms - n_snap * snap_ms) / (steps - 1)
    print(f"{name} ({smi}): Solver wall {res['wall_s'] * 1e3 / steps} ms/step over {steps} "
          f"steps (val cycles and snapshots included), {res['frames_per_sec']} frames/s; one "
          f"snapshot write {snap_ms} ms, one val cycle {val_ms} ms; the steps alone after the "
          f"first (wall less the first step's device ms, {n_val} val cycles and {n_snap} "
          f"snapshots) {steady} ms/step, {B / (steady / 1e3)} frames/s; device "
          f"ms/step median {float(np.median(res['ms']))} (first {res['ms'][0]}); loader host "
          f"{float(np.median(host_ms))} ms/batch median of {LOADER_BATCHES} ({host_ms}; "
          f"next() without prefetch{', the raster on the card included' if lidar else ''}); "
          f"bare train loop {float(np.median(bare['ms']))} ms/step device median, {bare_wall} "
          f"ms/step wall, over {BARE_STEPS} steps")
    print(f"{name}: resumed from iter_{snap} at step {resumed['step'] - len(got)}, ran to "
          f"{resumed['step']}; losses against the uninterrupted run: largest relative "
          f"difference {worst} (rtol {SOLVER_RTOL}; deterministic algorithms off), bitwise "
          f"equal {bitwise}")
    keys = {"total_loss", "act_conv0/mean", "act_conv0/std", "act_conv0/absmax"}
    val_ok = [v["step"] for v in val] == list(range(5, steps + 1, 5)) and all(
        keys <= set(v) and all(np.isfinite(v[k]) for k in keys) for v in val)
    print(f"{name}: val cycle at steps {[v['step'] for v in val]}, val losses and activation "
          f"summaries finite: {val_ok}; first val {val[0]}; live-BN running statistics: "
          f"{n_stats} (frozen BN; that the val cycle leaves live statistics as they are is held "
          f"on the CPU, tests/test_torch_port_solver.py)")
    print(f"{name}: losses finite {finite}, kernel launches {launches}"
          + (f"; voxelize_bev launched from the thread {raster_thread!r}" if lidar else ""))
    if not finite or not val_ok:
        raise AssertionError(f"{name}: non-finite losses or a val cycle missing")
    if len(got) != steps - snap or resumed["step"] != steps or worst > SOLVER_RTOL:
        raise AssertionError(f"{name}: the resumed run does not follow the uninterrupted one")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    if lidar and raster_thread != "BatchLoader-prefetch":
        raise AssertionError(f"{name}: the raster was made on {raster_thread!r}")
    return launches, {"ms_median": float(np.median(res["ms"])),
                      "wall_ms": res["wall_s"] * 1e3 / steps, "peak_gib": peak_gib}


def check_live_stats(model, name):
    """Every live-BN running statistic float32, finite and moved from its
    init (mean 0, var 1)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import live_bn_stats

    stats = live_bn_stats(model)
    bad = [k for k, v in stats.items() if v.dtype != torch.float32 or not bool(torch.isfinite(v).all())
           or bool((v == (0.0 if k.endswith("mean") else 1.0)).all())]
    print(f"{name}: {len(stats)} running statistics, float32, finite and moved from init: "
          f"{not bad}")
    if not stats or bad:
        raise AssertionError(f"{name}: running statistics not float32, finite and moved: {bad[:5]}")


def measure_anchor_targets(cfg, smi):
    """anchor_target alone (plain torch: the IoU of every anchor with every
    GT box, labels, sampling, regression targets) at the FPN training shape:
    8 frames x 768,000 anchors x 64 GT boxes.  Times by CUDA events; peak
    memory above what was allocated before the call."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
        build_anchor_grid,
        feat_stride,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_overlaps
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import (
        anchor_target,
        effective_rpn_overlaps,
    )

    s = feat_stride(cfg)
    fh, fw = -(-FRAME_HW[0] // s), -(-FRAME_HW[1] // s)
    anchors = torch.from_numpy(build_anchor_grid(cfg, fh, fw, float(cfg.train.scales[0]))[0]).cuda()
    rng = np.random.RandomState(9)
    g = cfg.static.max_gt
    gt = np.zeros((B, g, 5), np.float32)
    gt[..., :4] = np.stack([random_boxes(rng, g) for _ in range(B)])
    gt[..., 4] = 1
    gt = torch.from_numpy(gt).cuda()
    mask = torch.ones((B, g), dtype=torch.bool, device="cuda")
    win = torch.tensor([[0.0, FRAME_HW[1], 0.0, FRAME_HW[0]]] * B, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = anchors.shape[0]
    kf, kb = (torch.rand((B, n), generator=gen, device="cuda") for _ in range(2))
    pos, neg = effective_rpn_overlaps(cfg)
    c = cfg.train

    def run():
        return anchor_target(anchors, gt, mask, win, kf, kb, rpn_batchsize=c.rpn_batchsize,
                             fg_fraction=c.rpn_fg_fraction, positive_overlap=pos,
                             negative_overlap=neg, clobber_positives=c.rpn_clobber_positives)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    at = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(run, 5)
    iou_ms = cuda_ms(lambda: bbox_overlaps(anchors, gt[..., :4]), 5)
    fg = int((at.labels == 1).sum())
    print(f"anchor_target ({B}, {n} anchors, {g} GT) ({smi}): {ms} ms, peak memory above the "
          f"inputs {peak / 2**30} GiB; bbox_overlaps alone {iou_ms} ms for the "
          f"({B}, {n}, {g}) float32 IoU tensor ({B * n * g * 4 / 2**30} GiB); {fg} fg anchors "
          f"sampled")
    return {"anchor_target_ms": ms, "bbox_overlaps_ms": iou_ms, "peak_gib": peak / 2**30}


def bev_aabb(boxes7):
    """BEV footprint x1y1x2y2 (center +- l/2, w/2) of (N, 7) boxes, as the
    lidar NMS sees them."""
    import torch

    half = boxes7[:, 3:5] / 2
    return torch.cat([boxes7[:, :2] - half, boxes7[:, :2] + half], dim=1)


def check_bev_slice(cfg_base):
    """cfg_base's net (res101 C4 or FPN, VGG16, MobileNet) in float32 on one
    synthetic 400 x 350 LiDAR frame: card (the voxelizer, NMS and RoI-align
    kernels, single-level or multiscale) against CPU (their twins)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    cfg = cfg_from_list(cfg_base, ("COMPUTE_DTYPE", "float32"))
    cpu = scale_terminators(build_detector(cfg, 2, "cpu", seed=1))
    gpu = scale_terminators(build_detector(cfg, 2, "cuda", seed=1))
    frame = SyntheticDataset(cfg, num_frames=1, mode="val", seed=7).frame(0)
    pts = torch.from_numpy(frame["points"])[None]
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    grid = raster_kwargs(cfg, float(cfg.train.scales[0]))
    win = torch.from_numpy(frame["window"])[None]
    with torch.inference_mode():
        c_x = voxelize_bev(pts, valid, **grid)
        g_x = voxelize_bev(pts.cuda(), valid.cuda(), **grid)
        c_feat = cpu.features(c_x)
        c_rpn = cpu.rpn_scores(c_feat)
        c_out = cpu.forward_test(c_x, win)
        g_feat = gpu.features(g_x)
        g_rpn = gpu.rpn_scores(g_feat)
        g_out = {k: v.cpu() for k, v in gpu.forward_test(g_x, win.cuda()).items()}
        # second stage on the CPU's rois and 3D anchors (pinned)
        g_cls, g_boxes = gpu.classify_rois(g_feat, c_out["rois"].cuda(), win.cuda(),
                                           c_out["anchors_3d"].cuda())
    s = cfg.lidar.num_slices
    raster_equal = torch.equal(g_x[..., :s + 1].cpu(), c_x[..., :s + 1])
    meta_err = float((g_x[..., s + 1:].cpu() - c_x[..., s + 1:]).abs().max())
    feat_err, feat_max = feature_err(g_feat, c_feat)
    fg_err = float((g_rpn["fg_prob"].cpu() - c_rpn["fg_prob"]).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    fm = "p2..p5" if cfg.use_fpn else "C4"
    print(f"BEV slice {'FPN ' if cfg.use_fpn else ''}{cfg.net_variant} fp32 {tuple(c_x.shape)}: "
          f"raster height/density equal {raster_equal}, meta err {meta_err}; {fm} max err "
          f"{feat_err} (max|{fm}| {feat_max}); fg_prob {fg_err}; "
          f"proposals matched {matched}/{len(cr)} at IoU >= 0.99; pinned cls_prob {cls_err}; "
          f"pinned 7-DoF boxes {box_err} voxels")
    checks = {
        "raster": raster_equal and meta_err <= 1e-5,
        f"{fm} features": feat_err <= 1e-4 * feat_max,
        "fg_prob": fg_err <= 2e-3,
        "proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "boxes": box_err <= 0.15,
    }
    kw = dict(num_classes=2, bbox_elem=7, max_dets=100, is_lidar=True,
              thresh=split_thresh(c_out["cls_prob"][..., 1], c_out["roi_valid"]), nms_thresh=0.6)
    cf = filter_detections(c_out["cls_prob"], c_out["bbox_pred"], c_out["roi_valid"], **kw)
    gf = filter_detections(*(g_out[k].cuda() for k in ("cls_prob", "bbox_pred", "roi_valid")), **kw)
    cb = cf["boxes"][0, 1][cf["valid"][0, 1]]
    gb = gf["boxes"][0, 1][gf["valid"][0, 1]].cpu()
    det_match = len(cb) == len(gb) and (
        len(cb) == 0 or bool((iou_plus1(bev_aabb(cb), bev_aabb(gb)).max(dim=1).values >= 0.99).all()))
    print(f"BEV slice final detections: cpu {len(cb)}, card {len(gb)}, matched {det_match}")
    checks["detections"] = det_match and len(cb) > 0
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BEV slice card vs CPU out of tolerance: {failed}")


@contextlib.contextmanager
def filter_nms_inputs():
    """Within the block, record what the final filter (ops/filter.py) gives
    NMS: a list that receives one dict a call, the boxes (G, N, E), scores
    and valid (G, N) as numpy arrays, the threshold and max_out."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import filter as filter_mod

    seen, nms = [], filter_mod.nms

    def recording(boxes, scores, iou_threshold, max_out, valid=None, rotated=False):
        n, e = boxes.shape[-2:]
        ok = np.ones(scores.shape, bool) if valid is None else valid.cpu().numpy()
        seen.append({"boxes": boxes.reshape(-1, n, e).cpu().numpy(),
                     "scores": scores.reshape(-1, n).cpu().numpy(), "valid": ok.reshape(-1, n),
                     "thr": iou_threshold, "max_out": max_out})
        return nms(boxes, scores, iou_threshold, max_out, valid=valid, rotated=rotated)

    filter_mod.nms = recording
    try:
        yield seen
    finally:
        filter_mod.nms = nms


def run_bev_serving(cfg, smi, need=("voxelize_bev", "nms", "roi_align"), never=()):
    """The BEV serving path: warm-up batch, then 3 batches, counted; the
    kernels in `need` must have launched and those in `never` not.  Returns the launches and the
    batch's ms, frames/s, peak memory and the final filter's NMS input of
    the warm-up batch (the first evaluated batch: filter_nms_inputs)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import (
        detect_batch,
        evaluate,
        filter_batch,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    batches = 3
    db = SyntheticDataset(cfg, num_frames=batches * B, num_classes=2, mode="val", seed=101)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", augment=False, shuffle=False,
                         seed=0)
    model = scale_terminators(build_detector(cfg, 2, "cuda", seed=0))
    warm = loader.peek()  # the first evaluated batch, run once to warm up
    with filter_nms_inputs() as seen:
        filter_batch(model, detect_batch(model, warm), cfg.test.thresh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = evaluate(model, loader, db, batches * B, cfg.test.thresh)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    # the peeked batch was rasterized before the counts were reset
    raster = np.asarray(res["raster_ms"][1:])
    ms = np.asarray(res["detect_ms"][1:]) + np.asarray(res["filter_ms"][1:]) + raster
    shape = tuple(warm["data"].shape)
    name = ("rotated " if cfg.test.rotated_nms else "") + path_name(cfg, "serving")
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} raster {shape} batch {B} "
          f"({smi}): voxelize ms/batch {res['raster_ms']}, detect ms/batch {res['detect_ms']}, "
          f"filter ms/batch {res['filter_ms']}; batches 2-3 mean {float(ms.mean())} ms/batch, "
          f"{B * len(ms) / (float(ms.sum()) / 1e3)} frames/s; peak memory {peak / 2**30} GiB; "
          f"random-weight mAP ({res['eval_type']} @ {res['iou_thresh']}) {res['mAP']}")
    print(f"{name} (final NMS {'rotated' if cfg.test.rotated_nms else 'axis-aligned'} @ "
          f"{cfg.test.nms_thresh}): outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError(f"{name}: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError(f"{name}: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in need) or any(launches[k] for k in never):
        raise AssertionError(f"{name}: launches {launches}, needed {need}, never {never}")
    return launches, {"ms": float(ms.mean()), "fps": B * len(ms) / (float(ms.sum()) / 1e3),
                      "peak_gib": peak / 2**30, "filter_input": seen[0]}


def run_trained_serving(model, cfg, smi):
    """One serving batch of a model after its training path: the model cast
    for serving (to_device: bf16, eval mode, live BN's running statistics
    float32), 8 synthetic frames through inference.evaluate, counted."""
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import evaluate
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import to_device, uses_uncertainty
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    serving = to_device(copy.deepcopy(model), "cuda")
    serving.cfg = cfg
    db = SyntheticDataset(cfg, num_frames=B, num_classes=2, image_hw=FRAME_HW, mode="val",
                          seed=101)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", augment=False, shuffle=False,
                         seed=0)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = evaluate(serving, loader, db, B, cfg.test.thresh)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    live = cfg.resnet.fixed_blocks == -1
    name = (f"{'live-BN ' if live else ''}{'BEV ' if cfg.net_type == 'lidar' else ''}"
            f"{'UC ' if uses_uncertainty(cfg) else ''}serving")
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} batch {B} ({smi}), eval mode after "
          f"training: voxelize {res['raster_ms']} ms, detect {res['detect_ms']} "
          f"ms, filter {res['filter_ms']} ms (one batch, the first: not a steady-state time); "
          f"outputs finite {res['finite']}, fewest proposals in a frame {res['min_proposals']}, "
          f"kernel launches {launches}")
    if live:
        check_live_stats(serving, name)
    if serving.training or not res["finite"] or not res["min_proposals"]:
        raise AssertionError(f"{name}: training mode {serving.training}, finite {res['finite']}, "
                             f"fewest proposals {res['min_proposals']}")
    need = ("voxelize_bev", "nms", "roi_align") if cfg.net_type == "lidar" else ("nms", "roi_align")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    return launches


# -- the dataset paths: seeded Waymo and KITTI trees, real-sized frames --------

DATASET_ROOT = REPO / "build" / "chip_smoke_datasets"
# the dataset paths: bev_config at a Waymo top-lidar sweep's size, the JAX
# defaults' augmentation (flips, gauss jitter, dropout, the x/y swap:
# config.py:250-254) plus the rotation, so that every native op runs
WAYMO_OVERRIDES = ("STATIC.MAX_POINTS", "180000", "LIDAR.EN_AUG_ROTATE", "True")
DATASET_STEPS = 10
STEADY_STEPS = 10
PIPE_TRIPS = 5
KITTI_STEPS = 5
RECORDED_BATCHES = 3
WAYMO_TRAIN, WAYMO_VAL = 24, 8
KITTI_TRAIN, KITTI_VAL = 16, 8
# a KITTI-like calibration (P2 and Tr_velo_to_cam of the raw KITTI rig)
KITTI_CALIB = """P0: 721.5377 0 609.5593 0 0 721.5377 172.854 0 0 0 1 0
P1: 721.5377 0 609.5593 -387.5744 0 721.5377 172.854 0 0 0 1 0
P2: 721.5377 0 609.5593 44.85728 0 721.5377 172.854 0.2163791 0 0 1 0.002745884
P3: 721.5377 0 609.5593 -339.5242 0 721.5377 172.854 2.199936 0 0 1 0.002729905
R0_rect: 0.9999239 0.00983776 -0.007445048 -0.009869795 0.9999421 -0.004278459 0.007402527 0.004351614 0.9999631
Tr_velo_to_cam: 0.007533745 -0.9999714 -0.000616602 -0.004069766 0.01480249 0.0007280733 -0.9998902 -0.07631618 0.9998621 0.007523790 0.01480755 -0.2717806
Tr_imu_to_velo: 0.9999976 0.0007553071 -0.002035826 -0.8086759 -0.0007854027 0.9998898 -0.01482298 0.3195559 0.002024406 0.01482454 0.9998881 -0.7997231
"""


def box_points(rng, box, n):
    """n points inside a 7-DoF box [xc, yc, zc, l, w, h, heading]."""
    local = (rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]).astype(np.float64)
    c, s = np.cos(box[6]), np.sin(box[6])
    x = local[:, 0] * c - local[:, 1] * s + box[0]
    y = local[:, 0] * s + local[:, 1] * c + box[1]
    return np.stack([x, y, local[:, 2] + box[2]], 1)


def sweep(rng, n, max_range, ground_z):
    """n returns of a spinning lidar: ground rings denser near the sensor,
    the rest on walls and vegetation up to max_range, all around."""
    n_ground = int(n * 0.7)
    az = rng.uniform(-np.pi, np.pi, n)
    r = np.concatenate([2.5 + (max_range - 2.5) * rng.uniform(0, 1, n_ground) ** 2,
                        rng.uniform(5, max_range, n - n_ground)])
    z = np.concatenate([ground_z + rng.normal(0, 0.04, n_ground),
                        ground_z + rng.uniform(0, 4.0, n - n_ground)])
    return np.stack([r * np.cos(az), r * np.sin(az), z], 1)


def waymo_frame(rng, n_points):
    """One Waymo top-lidar sweep (vehicle frame, ground at z 0) with 10-40
    vehicles and a few pedestrians, cyclists and signs (the don't-care
    classes); returns the (n, 5) float32 points and the label dict's box,
    class, difficulty and meta lists."""
    n_veh, n_dc = rng.randint(10, 41), rng.randint(3, 9)
    boxes, classes, diff, meta, chunks = [], [], [], [], []
    for k in range(n_veh + n_dc):
        vehicle = k < n_veh
        r, az = rng.uniform(6, 68), rng.uniform(-0.9, 0.9)
        dims = ([rng.uniform(3.8, 5.6), rng.uniform(1.7, 2.2), rng.uniform(1.4, 2.0)] if vehicle
                else [rng.uniform(0.5, 1.8), rng.uniform(0.5, 0.9), rng.uniform(1.2, 1.9)])
        box = np.array([r * np.cos(az), r * np.sin(az), dims[2] / 2, *dims,
                        rng.uniform(-np.pi, np.pi)])
        # returns fall off with range; some boxes are nearly empty (level 2)
        n = int(min(2500, 9e4 / r ** 2) * rng.uniform(0.05, 1.0))
        chunks.append(box_points(rng, box, n))
        boxes.append({"xc": box[0], "yc": box[1], "zc": box[2], "lx": box[3], "wy": box[4],
                      "hz": box[5], "heading": box[6]})
        classes.append(1 if vehicle else int(rng.choice([2, 3, 4])))
        diff.append(int(rng.choice([0, 2], p=[0.8, 0.2])))
        meta.append({"pts": n, "avg_intensity": float(rng.uniform(0, 1)),
                     "avg_elongation": float(rng.uniform(0, 0.2)),
                     "return_ratio": float(rng.uniform(0.5, 1))})
    xyz = np.concatenate(chunks)
    xyz = np.concatenate([sweep(rng, n_points - len(xyz), 75.0, 0.0), xyz])
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1)),
                          rng.uniform(0, 0.3, (len(xyz), 1))], 1).astype(np.float32)
    return pts, {"box": boxes, "class": classes, "difficulty": diff, "meta": meta}


def make_waymo_tree(root: Path, seed: int = 0) -> None:
    """The unpacked layout WaymoDB reads (tools/waymo_unpack_combined.py):
    waymo/{train,val}/point_clouds/<frame>.npy of 160,000-180,000 points
    (x, y, z, intensity, elongation) and labels/lidar_labels.json."""
    rng = np.random.RandomState(seed)
    frame = 0
    for split, count in (("train", WAYMO_TRAIN), ("val", WAYMO_VAL)):
        base = root / "waymo" / split
        (base / "point_clouds").mkdir(parents=True)
        (base / "labels").mkdir()
        labels = []
        for _ in range(count):
            stem = f"{frame:07d}"
            pts, lab = waymo_frame(rng, rng.randint(160000, 180001))
            np.save(base / "point_clouds" / f"{stem}.npy", pts)
            lab.update({"assoc_frame": stem, "id": [f"t{frame}_{i}" for i in range(len(lab["box"]))],
                        "scene_type": [{"tod": ("Day", "Night", "Dawn/Dusk")[frame % 3],
                                        "weather": "sunny"}]})
            labels.append(lab)
            frame += 1
        with open(base / "labels" / "lidar_labels.json", "w") as f:
            json.dump(labels, f)


def kitti_label(rng, calib, kind, box):
    """A KITTI label line for a velo-frame box [xc, yc, zc, l, w, h, yaw]:
    the bottom center and heading in the rectified camera frame, the 2D box
    from the projected corners, occlusion and truncation drawn so that the
    three difficulties all occur."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils.kitti_utils import Object3d, compute_box_3d

    center = calib.project_velo_to_rect(box[None, :3])[0]
    bottom = center + np.array([0.0, box[5] / 2, 0.0])
    ry = -box[6] - np.pi / 2
    ry = float(np.arctan2(np.sin(ry), np.cos(ry)))
    line = (f"{kind} 0 0 0 0 0 1 1 {box[5]:.2f} {box[4]:.2f} {box[3]:.2f} "
            f"{bottom[0]:.2f} {bottom[1]:.2f} {bottom[2]:.2f} {ry:.2f}")
    _, uv = compute_box_3d(Object3d(line), calib)
    x1, y1 = np.clip(uv.min(0), 0, [1241, 374])
    x2, y2 = np.clip(uv.max(0), 0, [1241, 374])
    trunc = float(rng.choice([0.0, 0.2, 0.4]))
    occ = int(rng.choice([0, 1, 2]))
    return (f"{kind} {trunc:.2f} {occ} {ry:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"{box[5]:.2f} {box[4]:.2f} {box[3]:.2f} {bottom[0]:.2f} {bottom[1]:.2f} "
            f"{bottom[2]:.2f} {ry:.2f}")


def make_kitti_tree(root: Path, seed: int = 1) -> None:
    """The layout KittiDB reads: kitti/training/{velodyne/*.bin (x, y, z,
    intensity; ~120,000 points, all around), label_2/*.txt (Car,
    Pedestrian, Cyclist and DontCare lines), calib/*.txt} and
    kitti/splits/{train,val}.txt."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils.kitti_utils import Calibration

    rng = np.random.RandomState(seed)
    base = root / "kitti" / "training"
    for sub in ("velodyne", "label_2", "calib"):
        (base / sub).mkdir(parents=True)
    (root / "kitti" / "splits").mkdir()
    (base / "calib" / "calib.txt").write_text(KITTI_CALIB)
    calib = Calibration(str(base / "calib" / "calib.txt"))
    (base / "calib" / "calib.txt").unlink()
    ids = [f"{i:06d}" for i in range(KITTI_TRAIN + KITTI_VAL)]
    for idx in ids:
        lines, chunks = [], []
        for k in range(rng.randint(6, 16)):
            kind = "Car" if k < 4 else str(rng.choice(["Car", "Pedestrian", "Cyclist"]))
            x = rng.uniform(6, 55)
            dims = ([rng.uniform(3.5, 4.8), rng.uniform(1.5, 1.9), rng.uniform(1.4, 1.7)]
                    if kind == "Car" else [rng.uniform(0.5, 1.8), rng.uniform(0.5, 0.8),
                                           rng.uniform(1.5, 1.9)])
            box = np.array([x, rng.uniform(-0.6, 0.6) * x, -1.73 + dims[2] / 2, *dims,
                            rng.uniform(-np.pi, np.pi)])
            chunks.append(box_points(rng, box, int(min(1500, 6e4 / x ** 2))))
            lines.append(kitti_label(rng, calib, kind, box))
        for _ in range(rng.randint(1, 4)):
            x1, y1 = rng.uniform(0, 1100), rng.uniform(120, 300)
            lines.append(f"DontCare -1 -1 -10 {x1:.2f} {y1:.2f} {x1 + rng.uniform(20, 120):.2f} "
                         f"{y1 + rng.uniform(10, 60):.2f} -1 -1 -1 -1000 -1000 -1000 -10")
        xyz = np.concatenate(chunks)
        xyz = np.concatenate([sweep(rng, rng.randint(115000, 125001) - len(xyz), 80.0, -1.73), xyz])
        pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1).astype(np.float32)
        pts.tofile(base / "velodyne" / f"{idx}.bin")
        (base / "label_2" / f"{idx}.txt").write_text("\n".join(lines) + "\n")
        (base / "calib" / f"{idx}.txt").write_text(KITTI_CALIB)
    (root / "kitti" / "splits" / "train.txt").write_text("\n".join(ids[:KITTI_TRAIN]))
    (root / "kitti" / "splits" / "val.txt").write_text("\n".join(ids[KITTI_TRAIN:]))


def test_net_tool():
    """tools/test_net_torch.py as a module (its main takes argv)."""
    import importlib.util

    path = REPO / "tools" / "test_net_torch.py"
    spec = importlib.util.spec_from_file_location("test_net_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recording(loader, n, marks):
    """Wrap loader.next: keep copies of the first n batches it hands out,
    and the host time at each hand-out (marks)."""
    import torch

    kept, inner = [], loader.next

    def next_batch():
        b = inner()
        marks.append(time.perf_counter())
        if len(kept) < n:
            kept.append({k: v.clone() if isinstance(v, torch.Tensor) else np.copy(v)
                         for k, v in b.items()})
        return b

    loader.next = next_batch
    return kept


def as_host(v):
    import torch

    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def same_batches(got, want, s, name) -> dict:
    """Loader batches against the serial loader's: every host array (and
    the points) bitwise, the raster's height and density channels bitwise,
    its meta channels within 1e-5 (sums in arrival order in the voxelizer's
    tile blocks); raises otherwise.  Returns the raster's largest meta
    difference and whether the rasters were bitwise equal too."""
    meta, bitwise = 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"{name}: batch {i} keys {sorted(g)} vs {sorted(w)}")
        for k in w:
            a, b = as_host(g[k]), as_host(w[k])
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name}: batch {i} {k} {a.shape} {a.dtype} vs "
                                     f"{b.shape} {b.dtype}")
            if k == "data" and a.dtype == np.float32:
                if not np.array_equal(a[..., :s + 1], b[..., :s + 1]):
                    raise AssertionError(f"{name}: batch {i}: raster height/density differ")
                meta = max(meta, float(np.abs(a[..., s + 1:] - b[..., s + 1:]).max()))
                bitwise &= np.array_equal(a.view(np.uint32), b.view(np.uint32))
            elif not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
                raise AssertionError(f"{name}: batch {i}: {k} differs")
    if meta > 1e-5:
        raise AssertionError(f"{name}: raster meta channels differ by {meta}")
    return {"meta_err": meta, "raster_bitwise": bitwise}


def dataset_solver(cfg, db, out, workers, steps, marks, keep=0):
    """Solver.train of `steps` steps on the real database through a
    BatchLoader with `workers` worker processes (0: the prefetch thread),
    counted; a fresh output directory, so nothing resumes.  Returns the
    Solver, its result, the launches and the first `keep` batches."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S

    shutil.rmtree(out, ignore_errors=True)
    loader = BatchLoader(db, cfg, B, device="cuda", augment=cfg.train.augment_en,
                         seed=cfg.rng_seed, workers=workers)
    kept = recording(loader, keep, marks)
    model, _ = S.create_train_state(cfg, len(db.classes), "cuda", seed=0)
    solver = S.Solver(cfg, scale_terminators(model), loader, output_dir=str(out))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = solver.train(steps)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    return solver, res, launches, kept


def steady_ms(marks, last=None) -> float:
    """Median host ms between batches handed to the step after the first
    (the first waits for the workers' start), or over the last `last`
    steps (the batches drawn ahead during the first steps used up)."""
    marks = marks[1:] if last is None else marks[-last - 1:]
    return float(np.median(np.diff(marks))) * 1e3 if len(marks) > 1 else float("nan")


def pipe_ms(batch) -> list:
    """Host ms of a batch's round trip through a spawn-context queue in this
    process: the workers' pipe (pickled in the worker, written, read and
    unpickled in the collector), PIPE_TRIPS times."""
    import multiprocessing as mp

    q = mp.get_context("spawn").Queue()
    out = []
    try:
        for _ in range(PIPE_TRIPS):
            t0 = time.perf_counter()
            q.put(batch)
            back = q.get()
            out.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(back["points"], batch["points"]):
                raise AssertionError("pipe: the batch came back changed")
    finally:
        q.close()
        q.join_thread()
    return out


def check_finite(res, name):
    if not all(np.isfinite(v) for losses in res["history"] for v in losses.values()):
        raise AssertionError(f"{name}: a non-finite loss")


def run_waymo_path(smi):
    """Dataset path (Waymo lidar): a seeded Waymo tree of real-sized sweeps,
    bev_config at STATIC.MAX_POINTS 180000 with the lidar augmentation on.
    The first batches of 4 worker processes against the serial loader's
    (rasterize off: every host array and the points bitwise); Solver.train
    with 4 workers (its first batches' rasters against the serial loader's,
    K3 from the collector thread), then with the prefetch thread alone, then
    the bare loop on a serial loader, each counted; the loader's host ms a
    batch; K3 against its twin on a loader batch's 180,000-point frames;
    tools/test_net_torch.py --db waymo --eval_det on the val split from the
    4-worker run's snapshot (L1/L2 AP, det files).  Returns the launches of
    each run and K3's measurement."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    root = DATASET_ROOT / "waymo_path"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lib = pc_ops.build()
    t_lib = time.perf_counter() - t0
    make_waymo_tree(root / "data")
    gen_s = time.perf_counter() - t0 - t_lib
    cfg = make_config(BEV_OVERRIDES, WAYMO_OVERRIDES, (
        "DATA_DIR", str(root / "data"), "CACHE_DIR", str(root / "cache"),
        "TRAIN.SNAPSHOT_ITERS", str(DATASET_STEPS)))
    db = get_db("waymo", cfg, "train")
    sizes = [len(np.load(e["filename"], mmap_mode="r")) for e in db.roidb]
    n_veh = [len(e["boxes"]) for e in db.roidb]
    n_dc = [len(e["boxes_dc"]) for e in db.roidb]
    print(f"Waymo tree: {len(db)} train frames of {min(sizes)}-{max(sizes)} points, {min(n_veh)}-"
          f"{max(n_veh)} vehicles and {min(n_dc)}-{max(n_dc)} don't-care boxes a frame in range, "
          f"written in {gen_s:.1f} s; native library {lib} (built in {t_lib:.2f} s); image "
          f"databases are not run on the card (no cv2 there): tests/test_torch_port_datasets.py "
          f"holds them on the CPU")
    s = cfg.lidar.num_slices
    try:
        # the serial loader's first batches: host arrays with the points, and
        # with the raster
        host_serial = BatchLoader(db, cfg, B, device="cuda", seed=cfg.rng_seed, rasterize=False)
        want_host = [host_serial._build_batch(host_serial._sample_task())
                     for _ in range(RECORDED_BATCHES)]
        serial = BatchLoader(db, cfg, B, device="cuda", seed=cfg.rng_seed)
        want = [S.batch_to_device(serial._build_batch(serial._sample_task()), torch.device("cuda"))
                for _ in range(RECORDED_BATCHES)]
        workers = BatchLoader(db, cfg, B, device="cuda", seed=cfg.rng_seed, rasterize=False,
                              workers=4)
        t0 = time.perf_counter()
        workers.start()
        try:
            got_host = [workers.next() for _ in range(RECORDED_BATCHES)]
            first_s = time.perf_counter() - t0
        finally:
            workers.kill()
        same_batches(got_host, want_host, s, "4 workers (host arrays, points)")
        pipe = pipe_ms(want_host[0])
        print(f"4 workers: the first {RECORDED_BATCHES} batches (rasterize off) equal the serial "
              f"loader's bitwise, every host array and the points ({want_host[0]['points'].shape}"
              f" float32, {want_host[0]['points'].nbytes / 1e6:.1f} MB a batch through the "
              f"workers' pipe); {first_s:.2f} s from start() to the third batch, the workers' "
              f"start included; one batch's round trip through a spawn-context queue in this "
              f"process {float(np.median(pipe))} ms median of {PIPE_TRIPS} ({pipe})")

        # Solver.train with 4 workers: counted; its first batches' rasters
        marks_w: list = []
        solver_w, res_w, launches_w, kept = dataset_solver(
            cfg, db, root / "solver_workers", 4, DATASET_STEPS, marks_w, RECORDED_BATCHES)
        check_finite(res_w, "Waymo Solver (4 workers)")
        raster_thread = solver_w.train_loader.last_raster_thread
        cmp = same_batches(kept, want, s, "4 workers (rasters)")
        print(f"4 workers in Solver.train: the first {RECORDED_BATCHES} batches against the "
              f"serial loader's: host arrays bitwise, raster height and density bitwise, meta "
              f"max diff {cmp['meta_err']} (limit 1e-5), rasters bitwise {cmp['raster_bitwise']}; "
              f"voxelize_bev launched from the thread {raster_thread!r}")
        t0 = time.perf_counter()
        solver_w.snapshot(DATASET_STEPS + 1)
        snap_ms = (time.perf_counter() - t0) * 1e3

        marks_t: list = []
        _, res_t, launches_t, _ = dataset_solver(cfg, db, root / "solver_thread", 0,
                                                 DATASET_STEPS, marks_t)
        check_finite(res_t, "Waymo Solver (thread)")

        # the loader's host time a batch, and the bare loop on a serial loader
        plain = BatchLoader(db, cfg, B, device="cuda", seed=cfg.rng_seed)
        host_ms = []
        for _ in range(LOADER_BATCHES):
            t0 = time.perf_counter()
            plain.next()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        model = solver_w.model
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        bare = S.train(model, DetectorSGD(model, cfg), plain, BARE_STEPS,
                       torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        bare_wall = (time.perf_counter() - t0) * 1e3 / BARE_STEPS
        launches_bare = dict(_build.LAUNCH_COUNTS)
        check_finite({"history": bare["losses"]}, "Waymo bare loop")

        # K3 on a loader batch's own points
        vox = check_voxelize(None, cfg, float(cfg.train.scales[0]), None,
                             points=(want_host[0]["points"], want_host[0]["point_valid"]))

        # evaluation through tools/test_net_torch.py on the val split
        snap = root / "solver_workers" / "checkpoints" / f"iter_{DATASET_STEPS}"
        argv = ["--db", "waymo", "--data_dir", str(root / "data"), "--cache_dir",
                str(root / "cache"), "--net", "res101", "--net_type", "lidar", "--scale", "0.5",
                "--batch_size", str(B), "--eval_det", "1", "--thresh", "0.05", "--weights_file",
                str(snap), "--out_dir", str(root / "eval"), "--set", "STATIC.MAX_GT", "64",
                "STATIC.MAX_POINTS", "180000", "STATIC.NMS_PRE_TEST", "2048",
                "TEST.RPN_POST_NMS_TOP_N", "300"]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        ap = test_net_tool().main(argv)
        torch.cuda.synchronize()
        launches_eval = dict(_build.LAUNCH_COUNTS)
        ev = root / "eval" / "eval" / "waymo_lidar_val"
        det_lines = sum(1 for _ in open(ev / "det_val_vehicle.car.txt"))
        written = all((ev / f).exists() for f in ("detections.pkl", "vehicle.car_pr.pkl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    levels = sorted(k[1] for k in ap)
    print(f"Waymo eval (tools/test_net_torch.py --db waymo --eval_det, {WAYMO_VAL} val frames, "
          f"weights of the 4-worker run's iter_{DATASET_STEPS}): AP {ap}; det_val_vehicle.car.txt "
          f"{det_lines} lines, detections.pkl and vehicle.car_pr.pkl written {written}; launches "
          f"{launches_eval}")
    for name, res, marks, launches in (("4 workers", res_w, marks_w, launches_w),
                                       ("prefetch thread", res_t, marks_t, launches_t)):
        steady, last = steady_ms(marks), steady_ms(marks, STEADY_STEPS)
        print(f"Waymo Solver, {name} ({smi}): wall {res['wall_s'] * 1e3 / DATASET_STEPS} ms/step "
              f"over {DATASET_STEPS} steps (the loader's start, the first step and one snapshot "
              f"included), {res['frames_per_sec']} frames/s; ms between batches handed out "
              f"(median): {steady} after the first, {last} over the last {STEADY_STEPS} steps "
              f"({B / (last / 1e3)} frames/s); device ms/step median {float(np.median(res['ms']))}, "
              f"over the last {STEADY_STEPS} {float(np.median(res['ms'][-STEADY_STEPS:]))} (first "
              f"{res['ms'][0]}); launches {launches}")
    print(f"Waymo ({smi}): one snapshot write {snap_ms} ms; loader host "
          f"{float(np.median(host_ms))} ms/batch median of {LOADER_BATCHES} ({host_ms}; next() "
          f"without prefetch, workers=0, {B} frames of 160,000-180,000 points read, augmented, "
          f"padded to 180,000, copied up and rasterized); bare train loop "
          f"{float(np.median(bare['ms']))} ms/step device median, {bare_wall} ms/step wall over "
          f"{BARE_STEPS} steps (the serial loader included); launches {launches_bare}")
    if levels != ["L1", "L2"] or not all(np.isfinite(v) for v in ap.values()) or not written:
        raise AssertionError(f"Waymo eval: AP {ap}")
    for name, launches, need in (
            ("4 workers", launches_w, ("voxelize_bev", "nms", "roi_align", "roi_align_bwd")),
            ("thread", launches_t, ("voxelize_bev", "nms", "roi_align", "roi_align_bwd")),
            ("bare", launches_bare, ("voxelize_bev", "nms", "roi_align", "roi_align_bwd")),
            ("eval", launches_eval, ("voxelize_bev", "nms", "roi_align"))):
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"Waymo {name}: a kernel never launched: {launches}")
    if raster_thread != "BatchLoader-collector":
        raise AssertionError(f"Waymo: the raster was made on {raster_thread!r}")
    return {"dataset_waymo": launches_w, "dataset_waymo_thread": launches_t,
            "dataset_waymo_bare": launches_bare, "dataset_waymo_eval": launches_eval}, vox


def run_kitti_path(smi):
    """Dataset path (KITTI lidar): a seeded KITTI tree (~120,000 points a
    sweep, the camera-FOV crop keeping about a quarter), bev_config with the
    lidar augmentation; the test-time rain and dropout once through the
    native library (against the library called directly on the same draws);
    Solver.train of 5 steps with 2 worker processes, counted; then
    tools/test_net_torch.py --db kitti --eval_det (easy/moderate/hard AP).
    Returns the launches."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db
    from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    root = DATASET_ROOT / "kitti_path"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_kitti_tree(root / "data")
    gen_s = time.perf_counter() - t0
    data = ("DATA_DIR", str(root / "data"), "CACHE_DIR", str(root / "cache"))
    cfg = make_config(BEV_OVERRIDES, ("LIDAR.EN_AUG_ROTATE", "True", "TRAIN.SNAPSHOT_ITERS",
                                      str(KITTI_STEPS)), data)
    try:
        db = get_db("kitti", cfg, "train")
        raw = [len(np.fromfile(e["filename"], np.float32)) // 4 for e in db.roidb]
        kept = [len(db._load_frame_data(e)) for e in db.roidb]
        diff = np.concatenate([e["difficulty"] for e in db.roidb])
        print(f"KITTI tree: {len(db)} train frames of {min(raw)}-{max(raw)} points, the "
              f"camera-FOV crop keeps {min(kept)}-{max(kept)} ({np.mean(kept) / np.mean(raw):.3f}"
              f" of them); cars by difficulty (easy, moderate, hard, other) "
              f"{np.bincount(diff, minlength=4).tolist()}, written in {gen_s:.1f} s; image "
              f"databases are not run on the card (no cv2 there): tests/test_torch_port_datasets.py "
              f"holds them on the CPU")

        # the test-time rain and dropout through the native library
        rain_cfg = make_config(BEV_OVERRIDES, data, ("TEST.RAIN_SIM_EN", "True",
                                                     "TEST.DROPOUT_EN", "True"))
        val = get_db("kitti", rain_cfg, "val")
        entry = val.roidb[0]
        plain = val._load_frame_data(entry)
        plain = np.hstack([plain, np.zeros((len(plain), 1), np.float32)])
        got = val.frame(0, rng=np.random.RandomState(7))["points"]
        rng = np.random.RandomState(7)
        want = pc_ops.pc_rain_sim(plain, float(rain_cfg.test.rain_rate),
                                  float(val._lidar_max_range()), int(rng.randint(1 << 31)))
        want = pc_ops.pc_dropout(want, 0.8, int(rng.randint(1 << 31)))
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            raise AssertionError("KITTI test-time rain and dropout: the frame's points are not "
                                 "the native library's")
        print(f"KITTI test-time TEST.RAIN_SIM_EN and TEST.DROPOUT_EN (rain rate "
              f"{rain_cfg.test.rain_rate}): {len(plain)} -> {len(got)} points, bitwise the native "
              f"library's ({pc_ops.library_path()}) on the same draws")

        marks: list = []
        _, res, launches, _ = dataset_solver(cfg, db, root / "solver", 2, KITTI_STEPS, marks)
        check_finite(res, "KITTI Solver (2 workers)")
        snap = root / "solver" / "checkpoints" / f"iter_{KITTI_STEPS}"
        argv = ["--db", "kitti", "--data_dir", str(root / "data"), "--cache_dir",
                str(root / "cache"), "--net", "res101", "--net_type", "lidar", "--scale", "0.5",
                "--batch_size", str(B), "--eval_det", "1", "--thresh", "0.05", "--weights_file",
                str(snap), "--out_dir", str(root / "eval"), "--set", "STATIC.MAX_GT", "64",
                "STATIC.MAX_POINTS", "32768", "STATIC.NMS_PRE_TEST", "2048",
                "TEST.RPN_POST_NMS_TOP_N", "300"]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        ap = test_net_tool().main(argv)
        torch.cuda.synchronize()
        launches_eval = dict(_build.LAUNCH_COUNTS)
        det_lines = sum(1 for _ in open(root / "eval" / "eval" / "kitti_lidar_val" /
                                        "det_val_car.txt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steady = steady_ms(marks)
    print(f"KITTI Solver, 2 workers ({smi}): wall {res['wall_s'] * 1e3 / KITTI_STEPS} ms/step over "
          f"{KITTI_STEPS} steps (the workers' start, the first step and one snapshot included), "
          f"steady {steady} ms between batches, {B / (steady / 1e3)} frames/s; device ms/step "
          f"median {float(np.median(res['ms']))}; launches {launches}")
    print(f"KITTI eval (tools/test_net_torch.py --db kitti --eval_det, {KITTI_VAL} val frames): AP "
          f"{ap}; det_val_car.txt {det_lines} lines; launches {launches_eval}")
    if sorted(k[1] for k in ap) != ["easy", "hard", "moderate"]:
        raise AssertionError(f"KITTI eval: AP {ap}")
    need = ("voxelize_bev", "nms", "roi_align", "roi_align_bwd")
    if not all(launches[k] > 0 for k in need) or not all(
            launches_eval[k] > 0 for k in need[:3]):
        raise AssertionError(f"KITTI: a kernel never launched: {launches}, {launches_eval}")
    return {"dataset_kitti": launches, "dataset_kitti_eval": launches_eval}


# -- phase 32: data parallel on one card ----------------------------------------------

DP_WORLD = 2
DP_OVERRIDES = ("MESH.DATA", str(DP_WORLD))
# the card checks' step: float32, the training slice's lane counts, the GT
# boxes among the RoIs (random weights propose few foreground RoIs)
DP_CHECK_OVERRIDES = ("COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "64",
                      "STATIC.NMS_PRE_TRAIN", "1024", "TRAIN.RPN_POST_NMS_TOP_N", "256",
                      "TRAIN.USE_GT", "True")
DP_STEPS = 10
DP_ROOT = REPO / "build" / "chip_smoke_dp"
DP_LOSS_RTOL = 1e-4
DP_UPDATE_TOL = 1e-3  # of a leaf's max |update|, plus 1e-6 of its max |parameter|
DP_STAT_TOL = 1e-5  # of a statistic's max


DP_MIXED_HW = (SLICE_HW, (320, 448))  # the mixed check's two frame sizes


class MixedSizes:
    """Synthetic frames of two sizes: even indices from a SyntheticDataset
    of hws[0] frames, odd ones from one of hws[1] (a 4-frame set's first
    batch of 2, sampler seed 0, is frames 2 and 3: one of each)."""

    def __init__(self, cfg, num_frames: int, hws, seed: int = 0, mode: str = "train",
                 num_classes: int = 2):
        from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset

        self.parts = [SyntheticDataset(cfg, num_frames=num_frames, num_classes=num_classes,
                                       image_hw=hw, mode=mode, seed=seed + i)
                      for i, hw in enumerate(hws)]

    def __len__(self) -> int:
        return len(self.parts[0])

    def frame(self, index: int, **kwargs):
        return self.parts[index % 2].frame(index, **kwargs)


def dp_check(dp, name, cfg, init_model, batch, hw):
    """One data-parallel step on the card against the one-process step on
    the same global batch of `batch` frames (rank 0 computes it after).
    Each rank records the ReLU inputs of its forward (a probe forward in
    data_parallel, the running statistics untouched) and its step's
    proposal lanes and sampled labels; rank 0 runs the one-process step
    pinned to the ranks' lanes and, where a ReLU unit's input takes another
    sign than in the ranks' forward (find_ties, collected until none is
    new), to the ranks' gate.  Equal labels; the losses within rtol
    DP_LOSS_RTOL, each leaf's update within DP_UPDATE_TOL of its max (plus
    1e-6 of the leaf's max: its float32 rounding), the running statistics
    within DP_STAT_TOL of max.  `hw` a pair of sizes: the frames are
    MixedSizes', and each rank's own rows must pad to another size than
    the other rank's (the loader pads them to the global bucket).  Returns
    rank 0's measured errors (and raises on a miss)."""
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import live_bn_stats
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    device = dp.device
    mixed = isinstance(hw[0], tuple)
    db = (MixedSizes(cfg, 2 * batch, hw) if mixed
          else SyntheticDataset(cfg, num_frames=2 * batch, num_classes=2, image_hw=hw, seed=0))
    local = S.batch_to_device(BatchLoader(db, cfg, batch, device=device, seed=0,
                                          dp=dp).next(), device)
    own = tuple(BatchLoader(db, cfg, batch, device=device, seed=0, rows=dp.rows(batch)).next()[
        "data"].shape)
    owns = [None] * dp.world
    torch.distributed.all_gather_object(owns, own, group=dp.host_group)
    if mixed and len(set(owns)) != dp.world:
        raise AssertionError(f"data parallel {name}: the ranks' own rows are of one size {owns}")
    model = copy.deepcopy(init_model).to(device)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = DetectorSGD(model, cfg, dp=dp)

    def args(m, b, shard):
        return (b["data"], b["gt_boxes"], b["gt_mask"], b["window"],
                S.draw_train_keys(m, b, S.step_generator(0, 0, device), shard))

    with relu_inputs(model) as relu, torch.no_grad(), S.frozen_running_stats(model), \
            mesh.data_parallel(dp):
        model.forward_train(*args(model, local, dp))
    losses, aux = S.make_train_step(model, opt, dp)(local, args(model, local, dp)[-1])
    torch.save({"relu": relu, "src": aux.proposal_src.cpu(), "valid": aux.proposal_valid.cpu(),
                "anchor_labels": aux.anchor_targets.labels.cpu(),
                "roi_labels": aux.proposal_targets.labels.cpu()},
               DP_ROOT / f"{name}_{dp.rank}.pt")
    mesh.barrier(dp)
    out = {"losses": {k: float(v) for k, v in losses.items()}}
    if dp.rank == 0:
        parts = [torch.load(DP_ROOT / f"{name}_{r}.pt", weights_only=False)
                 for r in range(dp.world)]
        want = {k: torch.cat([p["relu"][k] for p in parts]) for k in parts[0]["relu"]}
        pin = tuple(torch.cat([p[k] for p in parts]).to(device) for k in ("src", "valid"))
        full = S.batch_to_device(BatchLoader(db, cfg, batch, device=device, seed=0).next(), device)
        ref = copy.deepcopy(init_model).to(device)
        ref_opt = DetectorSGD(ref, cfg)
        ties = []
        for _ in range(4):
            probe = copy.deepcopy(ref)
            with pinned_ties(probe, ties), relu_inputs(probe) as got, torch.no_grad():
                probe.forward_train(*args(probe, full, None), proposals=pin)
            new = find_ties(want, got, skip={t[:3] for t in ties})
            if not new:
                break
            ties += new
        with pinned_ties(ref, ties):
            ref_losses, ref_aux = S.make_train_step(ref, ref_opt)(full, args(ref, full, None)[-1],
                                                                  pin)
        for key, t in (("anchor_labels", ref_aux.anchor_targets.labels),
                       ("roi_labels", ref_aux.proposal_targets.labels)):
            if not torch.equal(torch.cat([p[key] for p in parts]), t.cpu()):
                raise AssertionError(f"data parallel {name}: {key} differ from one process's")
        loss_err = max(abs(out["losses"][k] - float(v)) / max(abs(float(v)), 1e-30)
                       for k, v in ref_losses.items())
        upd_share, worst = 0.0, None  # the largest share of a leaf's limit
        got_params = dict(model.named_parameters())
        for k, p in ref.named_parameters():
            want_u = (p.detach() - start[k]).double()
            got_u = (got_params[k].detach() - start[k]).double()
            limit = (DP_UPDATE_TOL * float(want_u.abs().max())
                     + 1e-6 * float(start[k].abs().max()) + 1e-30)
            share = float((got_u - want_u).abs().max()) / limit
            if share > upd_share:
                upd_share, worst = share, k
        ref_stats, got_stats = live_bn_stats(ref), live_bn_stats(model)
        stat_err = max((float((got_stats[k] - v).abs().max() / v.abs().max())
                        for k, v in ref_stats.items()), default=0.0)
        out.update(loss_err=loss_err, update_share=upd_share, worst_leaf=worst,
                   stat_err=stat_err, n_stats=len(ref_stats), ties=len(ties),
                   fg_rois=int((ref_aux.proposal_targets.labels > 0).sum()),
                   own_shapes=owns, shape=tuple(full["data"].shape))
        if loss_err > DP_LOSS_RTOL or upd_share > 1.0 or stat_err > DP_STAT_TOL:
            raise AssertionError(f"data parallel {name}: 2 ranks vs one process {out}")
    mesh.barrier(dp)
    return out


def dp_solver_path(dp, name, cfg, init_model, need):
    """`cfg`'s Solver.train for DP_STEPS steps at a global batch of B, this
    rank's B / world rows (the loader's prefetch on), counted: each rank's
    device ms a step (CUDA events: two ranks share the card), its gradient
    all-reduce's ms a step, wall ms a step, peak memory, launches (the
    kernels in `need` must have launched in this rank)."""
    import copy
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import Solver

    out = DP_ROOT / name
    if dp.rank == 0:
        shutil.rmtree(out, ignore_errors=True)
    mesh.barrier(dp)
    db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    loader = BatchLoader(db, cfg, B, device=dp.device, seed=cfg.rng_seed, dp=dp)
    model = copy.deepcopy(init_model).to(dp.device)
    solver = Solver(cfg, model, loader, output_dir=str(out), dp=dp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = solver.train(DP_STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    finite = all(np.isfinite(v) for losses in res["history"] for v in losses.values())
    if not finite or len(res["ms"]) != DP_STEPS:
        raise AssertionError(f"data parallel {name} rank {dp.rank}: {res['history']}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"data parallel {name} rank {dp.rank}: a kernel never launched: "
                             f"{launches}")
    return {"launches": launches, "ms": res["ms"], "reduce_ms": res["reduce_ms"],
            "wall_ms": res["wall_s"] * 1e3 / DP_STEPS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "last_loss": res["history"][-1]["total_loss"]}


def dp_rank(rank, world, init_method, smi):
    """One rank of phase 32 (spawned by run_data_parallel): the checks of
    (a), then the Solver paths of (b), in one process group."""
    import copy

    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state

    _build.library()  # built by the parent before it spawned the ranks
    image_cfg = make_config(IMAGE_OVERRIDES, DP_OVERRIDES)
    dp = mesh.init_data_parallel(image_cfg, B, rank=rank, world=world, init_method=init_method,
                                 device="cuda")
    try:
        res = {"backend": dp.backend, "device": str(dp.device)}
        # (a) res101 image C4 fp32 at 256x320, 2 ranks x 1 frame; the same
        # initial net serves (b)'s bf16 path
        image_model, _ = create_train_state(image_cfg, 2, "cpu", seed=0)
        scale_terminators(image_model)
        check_model = copy.deepcopy(image_model)
        check_model.cfg = cfg_from_list(image_cfg, DP_CHECK_OVERRIDES)
        res["res101"] = dp_check(dp, "res101", check_model.cfg, check_model, 2, SLICE_HW)
        res["res101_mixed"] = dp_check(dp, "res101_mixed", check_model.cfg, check_model, 2,
                                       DP_MIXED_HW)
        # res18 live BN, 2 ranks x 2 frames: the statistics are the global batch's
        live_cfg = make_config(IMAGE_OVERRIDES, RES18_LIVE, DP_CHECK_OVERRIDES, DP_OVERRIDES)
        live_model, _ = create_train_state(live_cfg, 2, "cpu", seed=1)
        scale_terminators(live_model)  # zero at init: the branches would get no gradient
        res["res18_live"] = dp_check(dp, "res18_live", live_cfg, live_model, 4, SLICE_HW)
        # (b) the paths at full width
        res["image"] = dp_solver_path(dp, "image", image_cfg, image_model,
                                      ("nms", "roi_align", "roi_align_bwd"))
        bev_cfg = make_config(BEV_OVERRIDES, DP_OVERRIDES)
        bev_model, _ = create_train_state(bev_cfg, 2, "cpu", seed=0)
        res["bev"] = dp_solver_path(dp, "bev", bev_cfg, scale_terminators(bev_model),
                                    ("voxelize_bev", "nms", "roi_align", "roi_align_bwd"))
        return res
    finally:
        mesh.shutdown(dp)


def run_data_parallel(smi, one_process):
    """Phase 32: data parallel on one card.  Two ranks share cuda:0 over gloo
    (NCCL refuses two ranks on one device; the NCCL branch is the same code
    with another backend string and is not run here), spawned once after
    the kernels were built.  (a) the 2-rank step against the one-process
    step on the card (dp_check): res101 image C4 fp32 256x320 at a global
    batch of 2, then res18 live BN at 4.  (b) Solver.train for DP_STEPS
    steps of the image config (res101 C4 bf16 512x960) and bev_config, a
    global batch of B as 2 ranks x B / 2, each rank's K1, K2, K2-bwd (and
    K3) counted; each rank's ms a step, its all-reduce's ms a step and its
    peak memory printed beside the one-process Solver paths of phases 23-24
    (`one_process`).  Returns each rank's launches by path."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    DP_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(dp_rank, DP_WORLD, smi, timeout=600)
    finally:
        shutil.rmtree(DP_ROOT, ignore_errors=True)
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"data parallel on one card ({smi}): {DP_WORLD} ranks on {r0['device']}, backend "
          f"{r0['backend']}, one process group for every check and path, {seconds} s with the "
          f"ranks' start")
    for name, what in (("res101", "res101 image C4 fp32 256x320, global batch 2 (2 x 1)"),
                       ("res101_mixed", "res101 image C4 fp32, global batch 2 (2 x 1) of a "
                        "256x320 and a 320x448 frame"),
                       ("res18_live", "res18 live BN fp32 256x320, global batch 4 (2 x 2)")):
        c = r0[name]
        print(f"data parallel check {what}: 2 ranks vs one process on the card: losses "
              f"largest relative difference {c['loss_err']} (rtol {DP_LOSS_RTOL}), updates: "
              f"largest share of a leaf's limit {c['update_share']} (limit {DP_UPDATE_TOL} "
              f"of its max update + 1e-6 of its max; worst {c['worst_leaf']}), "
              f"running statistics {c['stat_err']} of max over {c['n_stats']} (limit "
              f"{DP_STAT_TOL}), labels equal, {c['fg_rois']} foreground RoIs, ReLU ties pinned "
              f"{c['ties']}; the ranks' own rows {c['own_shapes']}, padded to {c['shape']}; "
              f"losses {c['losses']}")
    paths = {}
    for name, label in (("image", "res101 image C4 bf16 512x960"),
                        ("bev", "bev_config res101 bf16 400 x 350 x 15")):
        one = one_process[name]
        for r, rank in enumerate(ranks):
            p = rank[name]
            ms = np.asarray(p["ms"][1:])
            paths[f"dp_{name}_rank{r}"] = p["launches"]
            print(f"data parallel {label}, global batch {B} = 2 ranks x {B // 2}, rank {r} "
                  f"({smi}): {DP_STEPS} Solver steps; device ms/step after the first: median "
                  f"{float(np.median(ms))} (min {float(ms.min())}, max {float(ms.max())}; first "
                  f"{p['ms'][0]}); gradient all-reduce ms/step median "
                  f"{float(np.median(p['reduce_ms']))} ({p['reduce_ms']}); wall "
                  f"{p['wall_ms']} ms/step; peak memory {p['peak_gib']} GiB; launches "
                  f"{p['launches']}; last loss {p['last_loss']}")
        print(f"  beside: the one-process Solver path at batch {B} (phase "
              f"{'23' if name == 'image' else '24'}): device ms/step median "
              f"{one['ms_median']}, wall {one['wall_ms']} ms/step, peak memory "
              f"{one['peak_gib']} GiB.  Two ranks sharing one card over gloo, which carries "
              f"every gradient through the host, measure the cost of the collective, not a "
              f"speed-up")
        if ranks[0][name]["last_loss"] != ranks[1][name]["last_loss"]:
            raise AssertionError(f"data parallel {name}: the ranks report different losses")
    return paths


MP_WORLD = 4  # data 2 x model 2
MP_TP = ("MESH.DATA", "2", "MESH.MODEL", "2")
MP_TP_SP = MP_TP + ("MESH.SPATIAL", "True")
MP_STEPS = 3
MP_ROOT = REPO / "build" / "chip_smoke_mp"


def mp_check(dp, name, cfg, init_model, batch):
    """One (data 2 x model 2) step on the card against the one-process step
    on the card on the same global batch of `batch` frames (rank 0 computes
    it after), float32, TF32 off: each rank shards the tail
    (parallel.tensor_parallel) and, with MESH.SPATIAL, splits the
    backbone's rows; its step's proposal lanes and sampled labels are
    saved, rank 0 pins the one-process step to the data ranks' lanes.
    Equal labels; the losses within rtol DP_LOSS_RTOL, each leaf's update
    within DP_UPDATE_TOL of its max (plus 1e-6 of the leaf's max), phase
    32's bars.  Returns rank 0's measured errors (and raises on a miss)."""
    import copy
    import dataclasses

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    dp = dataclasses.replace(dp, spatial=bool(cfg.mesh.spatial))
    device = dp.device
    hw = SLICE_HW if cfg.net_type == "image" else FRAME_HW
    db = SyntheticDataset(cfg, num_frames=2 * batch, num_classes=2, image_hw=hw, seed=0)
    local = S.batch_to_device(BatchLoader(db, cfg, batch, device=device, seed=0,
                                          dp=dp).next(), device)
    model = copy.deepcopy(init_model).to(device)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = DetectorSGD(model, cfg, dp=dp)
    tp.shard_model_(model, dp, opt)  # every rank holds the same init
    draws = S.draw_train_keys(model, local, S.step_generator(0, 0, device), dp)
    losses, aux = S.make_train_step(model, opt, dp)(local, draws)
    split = model.rows_split
    tp.unshard_model_(model, dp, opt)
    torch.save({"src": aux.proposal_src.cpu(), "valid": aux.proposal_valid.cpu(),
                "anchor_labels": aux.anchor_targets.labels.cpu(),
                "roi_labels": aux.proposal_targets.labels.cpu()}, MP_ROOT / f"{name}_{dp.rank}.pt")
    mesh.barrier(dp)
    out = {"losses": {k: float(v) for k, v in losses.items()}, "rows_split": split}
    if dp.rank == 0:
        parts = [torch.load(MP_ROOT / f"{name}_{r}.pt", weights_only=False)
                 for r in range(0, dp.world, dp.model)]  # one rank of each data index
        pin = tuple(torch.cat([p[k] for p in parts]).to(device) for k in ("src", "valid"))
        full = S.batch_to_device(BatchLoader(db, cfg, batch, device=device, seed=0).next(), device)
        ref = copy.deepcopy(init_model).to(device)
        ref_losses, ref_aux = S.make_train_step(ref, DetectorSGD(ref, cfg))(
            full, S.draw_train_keys(ref, full, S.step_generator(0, 0, device)), pin)
        for key, t in (("anchor_labels", ref_aux.anchor_targets.labels),
                       ("roi_labels", ref_aux.proposal_targets.labels)):
            if not torch.equal(torch.cat([p[key] for p in parts]), t.cpu()):
                raise AssertionError(f"model parallel {name}: {key} differ from one process's")
        loss_err = max(abs(out["losses"][k] - float(v)) / max(abs(float(v)), 1e-30)
                       for k, v in ref_losses.items())
        upd_share, worst = 0.0, None
        got_params = dict(model.named_parameters())
        for k, p in ref.named_parameters():
            want_u = (p.detach() - start[k]).double()
            got_u = (got_params[k].detach() - start[k]).double()
            limit = (DP_UPDATE_TOL * float(want_u.abs().max())
                     + 1e-6 * float(start[k].abs().max()) + 1e-30)
            share = float((got_u - want_u).abs().max()) / limit
            if share > upd_share:
                upd_share, worst = share, k
        out.update(loss_err=loss_err, update_share=upd_share, worst_leaf=worst,
                   fg_rois=int((ref_aux.proposal_targets.labels > 0).sum()),
                   shape=tuple(full["data"].shape))
        if loss_err > DP_LOSS_RTOL or upd_share > 1.0:
            raise AssertionError(f"model parallel {name}: 2 x 2 vs one process {out}")
    mesh.barrier(dp)
    return out


def mp_solver_path(dp, cfg, init_model, need):
    """The image config's Solver.train for MP_STEPS steps at a global batch
    of B on the (data 2 x model 2) mesh, this rank's B / 2 rows, counted:
    its device ms a step, wall ms a step, its gradient all-reduce's ms a step
    (over the data group; over every rank for the backbone's row-slab
    leaves), peak memory, launches (the kernels in `need` must launch in
    this rank), the tail's bytes it holds.  Then one more step of the
    sharded model with every collective counted (mesh.STATS: each
    synchronized and timed on the host clock): the model group's
    collectives' ms and bytes, forward and backward, and the optimizer's."""
    import copy
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import tensor_parallel as tp
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD

    out = MP_ROOT / "image"
    if dp.rank == 0:
        shutil.rmtree(out, ignore_errors=True)
    mesh.barrier(dp)
    db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    loader = BatchLoader(db, cfg, B, device=dp.device, seed=cfg.rng_seed, dp=dp)
    model = copy.deepcopy(init_model).to(dp.device)
    solver = S.Solver(cfg, model, loader, output_dir=str(out), dp=dp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = solver.train(MP_STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(np.isfinite(v) for losses in res["history"] for v in losses.values())
    if not finite or len(res["ms"]) != MP_STEPS:
        raise AssertionError(f"model parallel image rank {dp.rank}: {res['history']}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"model parallel image rank {dp.rank}: a kernel never launched: "
                             f"{launches}")
    # one more step, every collective counted
    opt = DetectorSGD(model, cfg, dp=dp)
    mesh.broadcast_parameters_(model, dp, opt)
    counted = BatchLoader(db, cfg, B, device=dp.device, seed=cfg.rng_seed + 1, dp=dp)
    mesh.STATS.reset()
    mesh.STATS.enabled = True
    try:
        step = S.train(model, opt, counted, 1, S.step_generator(0, MP_STEPS, dp.device), dp=dp)
    finally:
        mesh.STATS.enabled = False
    table = {f"{axis} {phase}": {"calls": c, "bytes": b, "ms": ms}
             for (axis, phase), (c, b, ms) in sorted(mesh.STATS.table.items())}
    tp.unshard_model_(model, dp, opt)
    return {"launches": launches, "ms": res["ms"], "reduce_ms": res["reduce_ms"],
            "wall_ms": res["wall_s"] * 1e3 / MP_STEPS, "peak_gib": peak,
            "tail_bytes": res["tail_bytes"], "whole_tail_bytes": tp.tail_bytes(model),
            "last_loss": res["history"][-1]["total_loss"], "collectives": table,
            "counted_step_ms": step["ms"][0]}


def mp_rank(rank, world, init_method, smi):
    """One rank of phase 35 (spawned by run_model_parallel): the checks
    against one process, then the image config's Solver path, in one
    process group of 2 data x 2 model ranks."""
    import copy

    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state

    _build.library()  # built by the parent before it spawned the ranks
    image_cfg = make_config(IMAGE_OVERRIDES, MP_TP_SP)
    dp = mesh.init_data_parallel(image_cfg, B, rank=rank, world=world, init_method=init_method,
                                 device="cuda")
    try:
        res = {"backend": dp.backend, "device": str(dp.device)}
        image_model, _ = create_train_state(image_cfg, 2, "cpu", seed=0)
        scale_terminators(image_model)
        checks = (("c4_tp_sp", (IMAGE_OVERRIDES, MP_TP_SP), image_model),
                  ("fpn_tp", (IMAGE_OVERRIDES, FPN_OVERRIDES, MP_TP), None),
                  ("bev_tp_sp", (BEV_OVERRIDES, MP_TP_SP), None))
        for name, over, init in checks:
            cfg = make_config(*over, DP_CHECK_OVERRIDES)
            if init is None:
                init, _ = create_train_state(cfg, 2, "cpu", seed=0)
                scale_terminators(init)
            check_model = copy.deepcopy(init)
            check_model.cfg = cfg
            res[name] = mp_check(dp, name, cfg, check_model, 2)
        res["image"] = mp_solver_path(dp, image_cfg, image_model,
                                      ("nms", "roi_align", "roi_align_bwd"))
        return res
    finally:
        mesh.shutdown(dp)


def run_model_parallel(smi, one_process):
    """Phase 35: model parallel on one card.  Four ranks (data 2 x model 2)
    share cuda:0 over gloo, spawned once after the kernels were built.  (a)
    The 2 x 2 step against the one-process step on the card (mp_check,
    fp32 at SLICE_HW, DP_CHECK_OVERRIDES, a global batch of 2): res101 C4
    tp+sp, res101 FPN tp, res101 BEV tp+sp (K3 on 400 x 350, its 25 rows at
    stride 16 split 12 and 13).  (b) the image config (res101 C4 bf16,
    512x960, terminators 0.25) at MESH.DATA 2 MESH.MODEL 2 MESH.SPATIAL
    True, a global batch of B, through Solver.train for MP_STEPS steps:
    each rank's K1, K2, K2-bwd counted, its ms a step, the collectives'
    cost, peak memory and the tail's bytes it holds, beside the
    one-process Solver path of phase 23 (`one_process`).  Returns each
    rank's launches by path."""
    import shutil

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shutil.rmtree(MP_ROOT, ignore_errors=True)
    MP_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(mp_rank, MP_WORLD, smi, timeout=600)
    finally:
        shutil.rmtree(MP_ROOT, ignore_errors=True)
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"model parallel on one card ({smi}): {MP_WORLD} ranks = 2 data x 2 model on "
          f"{r0['device']}, backend {r0['backend']}, one process group for every check and the "
          f"path, {seconds} s with the ranks' start")
    for name, what in (("c4_tp_sp", "res101 image C4 fp32 256x320 tp+sp"),
                       ("fpn_tp", "res101 image FPN fp32 256x320 tp"),
                       ("bev_tp_sp", "res101 BEV fp32 400 x 350 x 15 tp+sp")):
        c = r0[name]
        print(f"model parallel check {what}, global batch 2 (2 data x 2 model): against one "
              f"process on the card: losses largest relative difference {c['loss_err']} (rtol "
              f"{DP_LOSS_RTOL}), updates: largest share of a leaf's limit {c['update_share']} "
              f"(limit {DP_UPDATE_TOL} of its max update + 1e-6 of its max; worst "
              f"{c['worst_leaf']}), labels equal, {c['fg_rois']} foreground RoIs, rows split "
              f"{c['rows_split']}, batch {c['shape']}; losses {c['losses']}")
    paths = {}
    one = one_process["image"]
    for r, rank in enumerate(ranks):
        p = rank["image"]
        ms = np.asarray(p["ms"][1:])
        paths[f"mp_image_rank{r}"] = p["launches"]
        print(f"model parallel res101 image C4 bf16 512x960 tp+sp, global batch {B} = 2 data "
              f"x {B // 2} frames, model axis 2, rank {r} ({smi}): {MP_STEPS} Solver steps; "
              f"device ms/step after the first: median {float(np.median(ms))} (first "
              f"{p['ms'][0]}); gradient all-reduce ms/step {p['reduce_ms']}; wall "
              f"{p['wall_ms']} ms/step; peak memory {p['peak_gib']} GiB; tail bytes held "
              f"{p['tail_bytes']} of one process's {p['whole_tail_bytes']}; launches "
              f"{p['launches']}; last loss {p['last_loss']}")
        print(f"  rank {r}'s collectives in one counted step ({p['counted_step_ms']} ms with "
              f"each collective synchronized): {p['collectives']}")
        if p["last_loss"] != r0["image"]["last_loss"]:
            raise AssertionError("model parallel image: the ranks report different losses")
        if 2 * p["tail_bytes"] != p["whole_tail_bytes"]:
            raise AssertionError(f"model parallel image rank {r}: the tail is not halved")
    print(f"  beside: the one-process Solver path at batch {B} (phase 23): device ms/step "
          f"median {one['ms_median']}, wall {one['wall_ms']} ms/step, peak memory "
          f"{one['peak_gib']} GiB.  Four ranks sharing one card over gloo, which carries every "
          f"collective through the host, measure the collectives' cost, not a speed-up")
    return paths


PROFILE_NEED = {  # the kernels each section of the stage split must launch
    "image": ((), (), ("nms",), ("nms",), ("nms", "roi_align", "roi_align_bwd")),
    "bev": (("voxelize_bev",),) * 2 + (("voxelize_bev", "nms"),) * 2
    + (("voxelize_bev", "nms", "roi_align", "roi_align_bwd"),),
    "fpn": ((), (), ("nms",), ("nms",),
            ("nms", "roi_align_multiscale", "roi_align_multiscale_bwd")),
}


def _profile_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("profile_step_torch",
                                                  REPO / "tools" / "profile_step_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_profile(smi):
    """Phase 33: tools/profile_step_torch.py's sections for the image, bev
    and fpn configs at full width (res101 bf16, batch 8): each section's
    ms a step and frames/s, its launches a step; every section's losses
    finite and the kernels of PROFILE_NEED launched in its timed calls.
    Returns the launches by path (profile_<config>_<section>)."""
    import torch

    tool = _profile_tool()
    paths = {}
    for which in ("image", "bev", "fpn"):
        cfg = make_config(*tool.CONFIGS[which])
        res = tool.profile(cfg, "cuda")
        torch.cuda.synchronize()
        print(tool.report(which, cfg, res, smi, B))
        for (name, r), need, key in zip(res.items(), PROFILE_NEED[which],
                                        ("backbone", "rpn", "proposals", "targets", "full")):
            losses = r["losses"].values() if isinstance(r["losses"], dict) else [r["losses"]]
            if not all(np.isfinite(v) for v in losses):
                raise AssertionError(f"profile {which} {name}: a non-finite loss {r['losses']}")
            if not all(r["launches"][k] > 0 for k in need):
                raise AssertionError(f"profile {which} {name}: a kernel never launched: "
                                     f"{r['launches']}")
            paths[f"profile_{which}_{key}"] = r["launches"]
        del res
        torch.cuda.empty_cache()
    return paths


def check_debug_draws(cfg, smi, hw=FRAME_HW, batch=B, device="cuda"):
    """Phase 34: utils/debug_draw's anchor_target_boxes and
    proposal_target_boxes for one batch of the image config (res101 bf16,
    batch 8, 512x960, terminators at 0.25) card against CPU: the sampling
    keys drawn on the CPU and given to both; the proposal targets over the
    CPU's proposals on both devices (the card pinned to them): every box
    list and its classes equal.  Then the card's own proposals
    (train_proposals: its features, RPN and K1): their lanes against the
    CPU's, the share printed.  Returns the card proposals' launches.
    (`device` "cpu" runs both sides on the CPU: a check of this code.)"""
    import copy

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        batch_to_device,
        create_train_state,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import debug_draw as dd

    db = SyntheticDataset(cfg, num_frames=2 * batch, num_classes=2, image_hw=hw, seed=0)
    host = BatchLoader(db, cfg, batch, device="cpu", seed=0).next()
    cpu_batch = batch_to_device(host, torch.device("cpu"))
    gpu_batch = batch_to_device(host, torch.device(device))
    cpu, _ = create_train_state(cfg, 2, "cpu", seed=0)
    scale_terminators(cpu)
    gpu = copy.deepcopy(cpu).to(device)
    g = torch.Generator().manual_seed(0)
    n = len(dd._grid(cfg, host["data"].shape))
    anchor_keys = (torch.rand((1, n), generator=g), torch.rand((1, n), generator=g))
    t0 = time.perf_counter()
    props = dd.train_proposals(cfg, cpu, cpu_batch)
    cpu_s = time.perf_counter() - t0
    roi_keys = tuple(torch.rand(tuple(props[1].shape), generator=g) for _ in range(2))
    results = {}
    for what, fn in (
            ("anchor targets", lambda b, m: dd.anchor_target_boxes(cfg, b, keys=anchor_keys)),
            ("proposal targets", lambda b, m: dd.proposal_target_boxes(
                cfg, m, b, keys=roi_keys, proposals=props))):
        want, got = fn(cpu_batch, cpu), fn(gpu_batch, gpu)
        for group, (boxes, classes) in want.items():
            if not (np.array_equal(got[group][0], boxes)
                    and np.array_equal(got[group][1], classes)):
                raise AssertionError(f"debug draws {what} {group}: card {got[group]} against "
                                     f"CPU {(boxes, classes)}")
        results[what] = {k: len(v[0]) for k, v in want.items()}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    _build.reset_launch_counts()
    own = dd.train_proposals(cfg, gpu, gpu_batch)
    sync()
    launches = dict(_build.LAUNCH_COUNTS)
    if device == "cuda" and launches["nms"] <= 0:
        raise AssertionError(f"debug draws: the card's proposals launched no NMS: {launches}")
    same = float((own[2].cpu() == props[2]).float().mean())
    print(f"debug draws card vs CPU ({cfg.net_variant} {cfg.compute_dtype} batch {batch} "
          f"{hw[0]}x{hw[1]}, {smi}): box lists and classes equal, frame 0's counts "
          f"{results}; the CPU's proposals took {cpu_s} s; the card's own proposals: launches "
          f"{launches}, {same} of their lanes equal to the CPU's")
    return launches


def main() -> int:
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = smi_name_power()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN (parity phases)")

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    path, seconds, log = _build.build()
    _build.library()
    print(f"built {path} in {seconds} s (load {time.perf_counter() - t0} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    image_cfg = make_config(IMAGE_OVERRIDES)
    bev_cfg = make_config(BEV_OVERRIDES, BEV_SERVING_OVERRIDES)
    bev_train_cfg = make_config(BEV_OVERRIDES)
    bev_rotated_cfg = make_config(BEV_OVERRIDES, BEV_SERVING_OVERRIDES, ROTATED_OVERRIDES)

    phase("kernels vs plain twins")
    rng = np.random.RandomState(0)
    nms_prop = check_nms("proposals", B, 2048, 0.7, 300, rng)
    nms_filter = check_nms("final filter", 2 * B, 300, 0.6, 100, rng)
    nms_train = check_nms("train proposals", B, 4096, 0.7, 2000, rng)
    nms_bev = check_nms("BEV proposals", B, BEV_ANCHORS, 0.7, 300, rng)
    nms_bev_filter = check_nms("BEV final filter", 2 * B, 300, 0.6, 100, rng)
    nms_rot = check_rotated(2 * B, 300, 0.3, 100, rng)
    roi = check_roi_align(rng, (H_FEAT, W_FEAT))
    roi_bev = check_roi_align(rng, BEV_FEAT_HW)
    roi_bwd = check_roi_align_backward(rng, (H_FEAT, W_FEAT))
    ms_fwd = check_multiscale_roi_align(rng)
    ms_bwd = check_multiscale_backward(rng, fpn_rois(rng, B, R_TRAIN), "16-900 px RoIs")
    ms_bwd_p5 = check_multiscale_backward(rng, p5_rois(rng, B, R_TRAIN), "every RoI on p5")
    vox_waymo = check_voxelize(rng, bev_cfg, 1.0, 180000)
    vox = check_voxelize(rng, bev_cfg, 0.5, bev_cfg.static.max_points)
    # the BEV training path's shapes (NMS_PRE_TRAIN of the 1,100 anchors, 256
    # RoIs a frame on the 25 x 22 map), from a stream of their own so that
    # the checks above keep their inputs
    rng_bev_train = np.random.RandomState(1)
    nms_bev_train = check_nms("BEV train proposals", B, bev_train_cfg.static.nms_pre_train, 0.7,
                              bev_train_cfg.train.rpn_post_nms_top_n, rng_bev_train)
    roi_bev_train = check_roi_align(rng_bev_train, BEV_FEAT_HW, R_TRAIN)
    roi_bwd_bev = check_roi_align_backward(rng_bev_train, BEV_FEAT_HW)
    # every point of one frame in one tile of the raster, and the multiscale
    # forward with every RoI on p2, from a third stream
    rng_skew = np.random.RandomState(2)
    vox_skew = check_voxelize(rng_skew, bev_cfg, 0.5, bev_cfg.static.max_points, skew=True)
    vox_skew_waymo = check_voxelize(rng_skew, bev_cfg, 1.0, 180000, skew=True)
    ms_fwd_p2 = check_multiscale_roi_align(rng_skew, p2_rois(rng_skew, B, R), "every RoI on p2")
    # K1's division-free test on pairs at each threshold's midpoint, from a
    # fourth stream
    check_nms_near_mid(np.random.RandomState(4))
    # the res18 (BasicBlock) C4 maps: 256 channels, image and BEV, serving
    # and training RoI counts, from a fifth stream
    rng_256 = np.random.RandomState(5)
    roi_256 = check_roi_align(rng_256, (H_FEAT, W_FEAT), R, C_RES18)
    roi_bev_256 = check_roi_align(rng_256, BEV_FEAT_HW, R_TRAIN, C_RES18)
    roi_bwd_256 = check_roi_align_backward(rng_256, (H_FEAT, W_FEAT), C_RES18)
    roi_bwd_bev_256 = check_roi_align_backward(rng_256, BEV_FEAT_HW, C_RES18)
    # the res18 BEV serving path's shape (TEST.RPN_POST_NMS_TOP_N 300)
    roi_bev_256_serve = check_roi_align(rng_256, BEV_FEAT_HW, R, C_RES18)
    # K4's IoU on pairs with collinear sides (F5), from a sixth stream
    collinear = check_collinear(np.random.RandomState(6))
    # VGG16's and MobileNet's 512-channel C4 maps: image serving, BEV
    # training (VGG16's floored 25 x 21 map, MobileNet's 25 x 22) and the
    # backward onto both, from a seventh stream
    rng_512 = np.random.RandomState(8)
    roi_512 = check_roi_align(rng_512, (H_FEAT, W_FEAT), R, C_VGG)
    roi_bev_512 = check_roi_align(rng_512, VGG_BEV_FEAT_HW, R_TRAIN, C_VGG)
    roi_bev_512_mobile = check_roi_align(rng_512, BEV_FEAT_HW, R_TRAIN, C_VGG)
    roi_bwd_512 = check_roi_align_backward(rng_512, (H_FEAT, W_FEAT), C_VGG)
    roi_bwd_bev_512 = check_roi_align_backward(rng_512, VGG_BEV_FEAT_HW, C_VGG)

    serving_cfg = make_config(IMAGE_OVERRIDES, SERVING_OVERRIDES)

    phase("slice: card vs CPU")
    check_slice(serving_cfg)

    phase("serving path")
    serving = run_serving(serving_cfg, smi)

    phase("training slice: card vs CPU")
    check_train_slice(image_cfg)

    phase("training path")
    training, _ = run_training(image_cfg, smi)

    phase("BEV slice: card vs CPU")
    check_bev_slice(bev_cfg)

    phase("BEV serving path")
    bev_serving, bev_stats = run_bev_serving(bev_cfg, smi)

    phase("BEV training slice: card vs CPU")
    check_train_slice(bev_train_cfg)

    phase("BEV training path")
    bev_training, _ = run_training(bev_train_cfg, smi,
                                   need=("voxelize_bev", "nms", "roi_align", "roi_align_bwd"))

    phase("rotated BEV serving path")
    bev_rotated, rot_stats = run_bev_serving(
        bev_rotated_cfg, smi, need=("voxelize_bev", "nms", "nms_rotated", "roi_align"))
    # the final filter's NMS moves from the axis-aligned kernel to the rotated one
    if not (bev_rotated["nms_rotated"] == bev_serving["nms"] - bev_rotated["nms"] > 0):
        raise AssertionError(f"rotated BEV serving: launches {bev_rotated} against the "
                             f"axis-aligned path's {bev_serving}")
    print(f"rotated vs axis-aligned BEV serving, one call ({smi}): {rot_stats['ms']} vs "
          f"{bev_stats['ms']} ms/batch, {rot_stats['fps']} vs {bev_stats['fps']} frames/s, peak "
          f"memory {rot_stats['peak_gib']} vs {bev_stats['peak_gib']} GiB; filter NMS launches "
          f"moved: nms {bev_serving['nms']} -> {bev_rotated['nms']}, nms_rotated "
          f"{bev_rotated['nms_rotated']}")
    # K4 on what this path's final filter gave it (the first batch), after the
    # path's counted run
    path_in = rot_stats["filter_input"]
    rot_path = rotated_case("BEV filter input", path_in["boxes"], path_in["scores"],
                            path_in["valid"], path_in["thr"], path_in["max_out"])

    fpn_cfg = make_config(IMAGE_OVERRIDES, FPN_OVERRIDES)
    fpn_serving_cfg = make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, SERVING_OVERRIDES)

    phase("FPN slices: card vs CPU")
    # at init the top-scored anchors of the stride-4 grid are mostly large
    # boxes clipped to the frame, which NMS folds together: a wider
    # candidate pool keeps more proposals to compare
    check_slice(make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, SERVING_OVERRIDES,
                            ("STATIC.NMS_PRE_TEST", "6000")))
    check_train_slice(fpn_cfg)

    phase("FPN serving path")
    fpn_serving = run_serving(fpn_serving_cfg, smi, need=("nms", "roi_align_multiscale"),
                              never=("roi_align",))

    phase("FPN training path")
    fpn_training, _ = run_training(fpn_cfg, smi, need=(
        "nms", "roi_align_multiscale", "roi_align_multiscale_bwd"))
    measure_anchor_targets(fpn_cfg, smi)

    phase("live-BN slices: card vs CPU")
    check_live_slice(image_cfg)
    check_live_slice(bev_train_cfg)

    phase("live-BN training path")
    live_training, _ = run_training(make_config(IMAGE_OVERRIDES, LIVE_OVERRIDES), smi,
                                    scale=False)

    phase("live-BN BEV path (res18)")
    bev_live_cfg = make_config(BEV_OVERRIDES, RES18_LIVE)
    bev_live_training, bev_live_model = run_training(
        bev_live_cfg, smi, need=("voxelize_bev", "nms", "roi_align", "roi_align_bwd"), scale=False)
    bev_live_serving = run_trained_serving(bev_live_model, make_config(
        BEV_OVERRIDES, BEV_SERVING_OVERRIDES, RES18_LIVE), smi)

    phase("UC slices: card vs CPU")
    check_uc_slice(image_cfg)
    check_uc_slice(bev_train_cfg)

    phase("UC serving path")
    # RoIs pooled once a batch; the tail and predictors run for each MC sample
    uc_serving = run_serving(make_config(IMAGE_OVERRIDES, SERVING_OVERRIDES, UC_OVERRIDES), smi,
                             per_batch={"nms": 2, "roi_align": 1})

    # from scratch (live BN): with frozen BN and random weights every
    # Bottleneck's drop3 doubles the residual stream's second moment
    # (2^30 over res101's layers 1-3), and exp of the class log-variance
    # overflows float32 (JAX's step on the same weights gives NaN too)
    phase("UC training path")
    uc_training, _ = run_training(make_config(IMAGE_OVERRIDES, UC_OVERRIDES, LIVE_OVERRIDES), smi,
                                  scale=False)

    phase("BEV UC training path")
    bev_uc_training, bev_uc_model = run_training(
        make_config(BEV_OVERRIDES, UC_OVERRIDES, LIVE_OVERRIDES), smi,
        need=("voxelize_bev", "nms", "roi_align", "roi_align_bwd"), scale=False)
    bev_uc_serving = run_trained_serving(bev_uc_model, make_config(
        BEV_OVERRIDES, BEV_SERVING_OVERRIDES, UC_OVERRIDES, LIVE_OVERRIDES), smi)

    phase("Solver path (image)")
    solver_image, one_image = run_solver_path(image_cfg, smi, steps=20, snap=10,
                                              need=("nms", "roi_align", "roi_align_bwd"))

    phase("Solver path (BEV)")
    solver_bev, one_bev = run_solver_path(
        bev_train_cfg, smi, steps=10, snap=5,
        need=("voxelize_bev", "nms", "roi_align", "roi_align_bwd"))

    phase("Dataset path (Waymo lidar)")
    waymo_paths, vox_waymo_path = run_waymo_path(smi)

    phase("Dataset path (KITTI lidar)")
    kitti_paths = run_kitti_path(smi)

    phase("VGG16 and MobileNet slices: card vs CPU")
    for net in (VGG_OVERRIDES, MOBILE_OVERRIDES):
        check_slice(make_config(IMAGE_OVERRIDES, net, SERVING_OVERRIDES))
        check_train_slice(make_config(IMAGE_OVERRIDES, net))
        check_bev_slice(make_config(BEV_OVERRIDES, net, BEV_SERVING_OVERRIDES))
        check_train_slice(make_config(BEV_OVERRIDES, net))

    phase("VGG16 image path")
    vgg_serving = run_serving(make_config(IMAGE_OVERRIDES, VGG_OVERRIDES, SERVING_OVERRIDES), smi)
    vgg_training, _ = run_training(make_config(IMAGE_OVERRIDES, VGG_OVERRIDES), smi)

    phase("MobileNet image path")
    mobile_serving = run_serving(make_config(IMAGE_OVERRIDES, MOBILE_OVERRIDES, SERVING_OVERRIDES),
                                 smi)
    mobile_training, _ = run_training(make_config(IMAGE_OVERRIDES, MOBILE_OVERRIDES), smi)

    phase("FPN x UC slice: card vs CPU")
    # every flag, the RPN's epistemic over the whole pyramid too, here only;
    # the GT boxes among the RoIs: with the pyramid's dropout live the
    # step's proposals move off those the GT was jittered from (drawn in
    # eval mode), no RoI is foreground and the box branch gets no gradient
    check_uc_slice(make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, ("TRAIN.USE_GT", "True")))

    phase("FPN x UC path")
    # the RoIs pooled once a batch by the multiscale kernel; FCTail and the
    # predictors run for each of the T = 10 samples
    fpn_uc_serving = run_serving(
        make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, SERVING_OVERRIDES, UC_OVERRIDES), smi,
        need=("nms", "roi_align_multiscale"), never=("roi_align",),
        per_batch={"nms": 2, "roi_align_multiscale": 1})
    # from scratch (live BN), as the C4 UC training path
    fpn_uc_training, _ = run_training(
        make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, UC_OVERRIDES, LIVE_OVERRIDES), smi,
        need=("nms", "roi_align_multiscale", "roi_align_multiscale_bwd"), scale=False)

    phase("FPN BEV slices: card vs CPU")
    fpn_bev_cfg = make_config(BEV_OVERRIDES, FPN_OVERRIDES)
    check_bev_slice(make_config(BEV_OVERRIDES, FPN_OVERRIDES, BEV_SERVING_OVERRIDES))
    check_train_slice(fpn_bev_cfg)

    phase("FPN BEV path")
    serve_rois, train_rois = [], []
    with recording_multiscale_rois(serve_rois):
        fpn_bev_serving, fpn_bev_stats = run_bev_serving(
            make_config(BEV_OVERRIDES, FPN_OVERRIDES, BEV_SERVING_OVERRIDES), smi,
            need=("voxelize_bev", "nms", "roi_align_multiscale"), never=("roi_align",))
    fpn_bev_rotated, fpn_rot_stats = run_bev_serving(
        make_config(BEV_OVERRIDES, FPN_OVERRIDES, BEV_SERVING_OVERRIDES, ROTATED_OVERRIDES), smi,
        need=("voxelize_bev", "nms", "nms_rotated", "roi_align_multiscale"), never=("roi_align",))
    print(f"rotated vs axis-aligned FPN BEV serving, one call ({smi}): {fpn_rot_stats['ms']} vs "
          f"{fpn_bev_stats['ms']} ms/batch, {fpn_rot_stats['fps']} vs {fpn_bev_stats['fps']} "
          f"frames/s, peak memory {fpn_rot_stats['peak_gib']} vs {fpn_bev_stats['peak_gib']} GiB")
    with recording_multiscale_rois(train_rois):
        fpn_bev_training, _ = run_training(fpn_bev_cfg, smi, need=(
            "voxelize_bev", "nms", "roi_align_multiscale", "roi_align_multiscale_bwd"))
    # K2-FPN and K2-FPN-bwd on the BEV pyramid (p2 100 x 88 .. p5 13 x 11),
    # on the RoIs the path's warm-up batch and warm-up step pooled
    rng_pyr = np.random.RandomState(9)
    ms_bev_fwd = check_multiscale_roi_align(rng_pyr, serve_rois[0], "the FPN BEV path's RoIs",
                                            BEV_PYRAMID_HW, one_level=False)
    ms_bev_bwd = check_multiscale_backward(rng_pyr, train_rois[0],
                                           "the FPN BEV training path's RoIs", BEV_PYRAMID_HW)

    phase("data parallel on one card")
    dp_paths = run_data_parallel(smi, {"image": one_image, "bev": one_bev})

    phase("train step stage split (tools/profile_step_torch.py)")
    profile_paths = run_profile(smi)

    phase("debug draws: card vs CPU")
    debug_proposals = check_debug_draws(image_cfg, smi)

    phase("model parallel on one card")
    mp_paths = run_model_parallel(smi, {"image": one_image})

    paths = {"serving": serving, "training": training, "bev_serving": bev_serving,
             "fpn_serving": fpn_serving, "fpn_training": fpn_training,
             "bev_training": bev_training, "bev_rotated_serving": bev_rotated,
             "live_training": live_training, "bev_live_training": bev_live_training,
             "bev_live_serving": bev_live_serving, "uc_serving": uc_serving,
             "uc_training": uc_training, "bev_uc_training": bev_uc_training,
             "bev_uc_serving": bev_uc_serving, "solver_image": solver_image,
             "solver_bev": solver_bev, **waymo_paths, **kitti_paths,
             "vgg_serving": vgg_serving, "vgg_training": vgg_training,
             "mobile_serving": mobile_serving, "mobile_training": mobile_training,
             "fpn_uc_serving": fpn_uc_serving, "fpn_uc_training": fpn_uc_training,
             "fpn_bev_serving": fpn_bev_serving, "fpn_bev_rotated_serving": fpn_bev_rotated,
             "fpn_bev_training": fpn_bev_training, **dp_paths, **mp_paths, **profile_paths,
             "debug_draw_proposals": debug_proposals}

    def entry(name, source, replaces, path, measured):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                "replaces": f"faster_rcnn_pytorch_multimodal_tpu/{replaces}",
                "launches": paths[path][name],
                "launches_by_path": {k: v[name] for k, v in paths.items()},
                **measured, "library_ms": None}

    nms_err = max(r["max_abs_err"] for r in (nms_prop, nms_filter, nms_train, nms_bev,
                                             nms_bev_filter, nms_bev_train))
    kernels = {"kernels": [
        entry("voxelize_bev", "voxelize.cu", "ops/voxelize.py:39", "dataset_waymo",
              vox_waymo_path),
        entry("nms", "nms.cu", "ops/nms.py:53", "solver_bev",
              {**nms_bev_train, "max_abs_err": nms_err}),
        entry("roi_align", "roi_align.cu", "ops/roi_align.py:122", "solver_bev",
              {**roi_bev_train[torch.bfloat16], "at_512_channels": {
                  "image (8, 32, 60, 512) x 300": roi_512[torch.bfloat16],
                  "VGG16 BEV (8, 25, 21, 512) x 256": roi_bev_512[torch.bfloat16],
                  "MobileNet BEV (8, 25, 22, 512) x 256": roi_bev_512_mobile[torch.bfloat16]}}),
        entry("roi_align_bwd", "roi_align.cu", "ops/roi_align.py:122 (VJP)", "solver_bev",
              {**roi_bwd_bev[torch.bfloat16], "at_512_channels": {
                  "onto (8, 32, 60, 512)": roi_bwd_512[torch.bfloat16],
                  "onto (8, 25, 21, 512)": roi_bwd_bev_512[torch.bfloat16]}}),
        entry("roi_align_multiscale", "roi_align.cu", "ops/roi_align.py:208", "fpn_serving",
              {**ms_fwd[torch.bfloat16], "bev_pyramid": ms_bev_fwd[torch.bfloat16]}),
        entry("roi_align_multiscale_bwd", "roi_align.cu", "ops/roi_align.py:208 (VJP)",
              "fpn_training",
              {**ms_bwd[torch.bfloat16], "bev_pyramid": ms_bev_bwd[torch.bfloat16]}),
        entry("nms_rotated", "nms.cu", "ops/rotated_iou.py:93 (via ops/nms.py:164)",
              "bev_rotated_serving",
              {k: nms_rot[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
    ]}
    print("timed at the shapes of the path each entry's launches come from: voxelize_bev "
          "(8, 180000) -> (8, 400, 350, 15) on a batch of the Waymo dataset path (the points "
          "counting-sorted by 8 x 32 tiles of the "
          "raster, then one block a tile sums its list in shared memory and writes its cells "
          "once: no zeroed raster, no full-raster scratch); nms (8, 1024) -> 1024 slots @ 0.7 (BEV "
          "training; three launches: a cluster of 8 blocks a problem sorts the lanes (bitonic "
          "chunks in shared memory, each key placed by binary searches in the cluster's "
          "distributed shared memory), the IoU mask kernel tests each pair without a division, "
          "two threads a tile row, then the keep scan in 64-row blocks staged by TMA bulk "
          "copies; max_abs_err over every NMS shape); roi_align bf16 (8, 25, 22, 1024) x 256 "
          "(one warp a "
          "RoI and 128 channels: each distinct tap cell staged once by cp.async into a ring of "
          "tap rows, x-then-y sums in registers); "
          "roi_align_bwd bf16 dOut (8, 256, 7, 7, 1024) -> (8, 25, 22, 1024) (the tile gather: "
          "2 x 4 cells a block, sums in registers, no atomics, bitwise repeatable); "
          "roi_align_multiscale bf16 p2..p5 of 512x960 x (8, 300) rois of 16-900 px (the "
          "single-level forward's staged body on each RoI's level); "
          "roi_align_multiscale_bwd bf16 dOut (8, 256, 7, 7, 256) (the same tile gather over the "
          "tiles of the four levels, 4 x 4 cells on p2 and p3, 2 x 4 on p4 and p5, after a pass "
          "that lists each frame's RoIs by level: no atomics, no float32 accumulator, bitwise "
          "repeatable); nms_rotated (16, 300) -> 100 "
          "@ 0.3 (the same sort kernel; the rotated mask kernel: a bounding-circle test a pair "
          "a lane, the pairs whose circles meet queued a warp at a time and clipped by "
          "Sutherland-Hodgman in registers; the same block scan; max_abs_err: its IoU kernel "
          "against the twin's IoU); library_ms null: no "
          "single PyTorch call computes these functions (torchvision's nms, roi_align and "
          "MultiScaleRoIAlign are not installed)")
    print(f"also: voxelize_bev (8, 32768) -> 400 x 350 (the BEV paths' bench shape): {vox}; "
          f"(8, 180000) -> 800 x 700: {vox_waymo}; frame 0 in one tile: "
          f"(8, 32768) -> 400 x 350 {vox_skew}, (8, 180000) -> 800 x 700 {vox_skew_waymo}; "
          f"roi_align_multiscale every RoI on p2: bf16 {ms_fwd_p2[torch.bfloat16]}, fp32 "
          f"{ms_fwd_p2[torch.float32]}; nms (8, 2048) -> 300: "
          f"{nms_prop}; (16, 300) -> 100: {nms_filter}; (8, 4096) -> 2000: {nms_train}; "
          f"BEV (8, 1100) -> 300: {nms_bev}; BEV (16, 300) -> 100: {nms_bev_filter}; "
          f"roi_align (8, 32, 60, 1024) x 300: fp32 {roi[torch.float32]}, bf16 "
          f"{roi[torch.bfloat16]}; (8, 25, 22, 1024) x 300: fp32 {roi_bev[torch.float32]}, bf16 "
          f"{roi_bev[torch.bfloat16]}; x 256 fp32 {roi_bev_train[torch.float32]}; roi_align "
          f"backward onto (8, 32, 60, 1024): fp32 {roi_bwd[torch.float32]}, bf16 "
          f"{roi_bwd[torch.bfloat16]}; onto (8, 25, 22, 1024) fp32 {roi_bwd_bev[torch.float32]}; "
          f"roi_align_multiscale fp32 {ms_fwd[torch.float32]}; its backward fp32 "
          f"{ms_bwd[torch.float32]}; backward with every RoI on p5: fp32 "
          f"{ms_bwd_p5[torch.float32]}, bf16 {ms_bwd_p5[torch.bfloat16]}; rotated_iou (16, 300)^2 "
          f"kernel {nms_rot['iou_ms']} ms; nms_rotated problems with a kept lane's pair near the "
          f"threshold {nms_rot['near_problems']}; nms_rotated on dense boxes (every lane clips) "
          f"{nms_rot['dense']}; nms_rotated on the rotated BEV serving path's filter input "
          f"{rot_path}")
    print(f"res18 C4 maps (256 channels): roi_align (8, 32, 60, 256) x 300: fp32 "
          f"{roi_256[torch.float32]}, bf16 {roi_256[torch.bfloat16]}; (8, 25, 22, 256) x 256: "
          f"fp32 {roi_bev_256[torch.float32]}, bf16 {roi_bev_256[torch.bfloat16]}; "
          f"(8, 25, 22, 256) x 300: fp32 {roi_bev_256_serve[torch.float32]}, bf16 "
          f"{roi_bev_256_serve[torch.bfloat16]}; backward "
          f"onto (8, 32, 60, 256): fp32 {roi_bwd_256[torch.float32]}, bf16 "
          f"{roi_bwd_256[torch.bfloat16]}; onto (8, 25, 22, 256): fp32 "
          f"{roi_bwd_bev_256[torch.float32]}, bf16 {roi_bwd_bev_256[torch.bfloat16]}; "
          f"rotated_iou on collinear pairs {collinear}")
    print(f"VGG16 and MobileNet C4 maps (512 channels): roi_align (8, 32, 60, 512) x 300: fp32 "
          f"{roi_512[torch.float32]}, bf16 {roi_512[torch.bfloat16]}; (8, 25, 21, 512) x 256: fp32 "
          f"{roi_bev_512[torch.float32]}, bf16 {roi_bev_512[torch.bfloat16]}; (8, 25, 22, 512) x "
          f"256: fp32 {roi_bev_512_mobile[torch.float32]}, bf16 "
          f"{roi_bev_512_mobile[torch.bfloat16]}; backward onto (8, 32, 60, 512): fp32 "
          f"{roi_bwd_512[torch.float32]}, bf16 {roi_bwd_512[torch.bfloat16]}; onto (8, 25, 21, "
          f"512): fp32 {roi_bwd_bev_512[torch.float32]}, bf16 {roi_bwd_bev_512[torch.bfloat16]}; "
          f"the BEV pyramid (p2 100 x 88 .. p5 13 x 11) on the FPN BEV path's RoIs: "
          f"roi_align_multiscale fp32 {ms_bev_fwd[torch.float32]}, bf16 "
          f"{ms_bev_fwd[torch.bfloat16]}; its backward fp32 {ms_bev_bwd[torch.float32]}, bf16 "
          f"{ms_bev_bwd[torch.bfloat16]}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
