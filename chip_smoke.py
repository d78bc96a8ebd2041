#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (kfnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, with their seconds:
  1. environment: torch and CUDA versions, the GPU, nvidia-smi's name and
     power limit, the float32 settings in force (TF32 off, so the plain
     versions' float32 products are full float32), the cuBLAS and cuSOLVER
     loaded, beside RANSAC_PROBED (the versions whose rounding the pose
     kernels copy) and whether they are the same;
  2. build: the three CUDA libraries, one nvcc each, started together, from
     the sources in the checkout, then the checkpoint reader's zstd
     decoder (utils/csrc/zstd_decode.cpp, host C++, libc only);
  3. the fused warp + Kalman kernel against its plain PyTorch version on
     the card, at the main path's 60x80 map (r=4, χ² 2.365974), with
     out-of-bounds-heavy flow, and on an odd 17x23 map (r=3): atol 2e-5 on
     x, rtol 2e-5 on P, the consistency mask equal; then a loss on its
     outputs at 60x80 with inputs that require grad: the gradients of all
     six inputs through its autograd node (forward: the kernel; backward:
     autograd through the plain version) against autograd through the
     plain version, at the golden tolerance (rtol 5e-4, atol 5e-5);
  3b. the fused update's heads-in entry (fused_filter_step: the two
     heads' raw outputs in, their output steps, the flow clip, the warp and
     the update in one launch) against its plain version on the card at
     60x80, one map and a batch of four, on heads drawn
     from a seeded generator with raw flows deep in tanh's saturation (the
     flow at ±r) and log-variances past ±12: flow, W, z and V within
     ULP_TOL units in the last place (both sides use libdevice's tanhf and
     expf, each within 2 ulps of the truth), x and P at phase 3's
     tolerances, the mask equal away from χ² ties; then its gradients into
     both raw heads, x_prev and P_prev through its autograd node against
     autograd through the plain version, at the golden tolerance;
  4. the conv kernels against their plain versions on the card at every
     distinct shape of the conv-kernel configuration's path (below), plus
     an odd 17x23 map and a 13x21 map (neither a multiple of the 8 x 8
     pixel tile) at cout 128 and 512; conv3x3_gn_chain twice, bit-equal
     (its sums are reduced in a fixed order), and conv3x3_same twice where
     it splits K (15x20, 30x40: partials summed in split order), bit-equal.
     Tolerances: float32 outputs
     and Σy within 3e-5 of the largest |value| (the kernel sums the same
     exact bf16 products in another order); Σy² within rtol 5e-5 (the same
     reordering, squared); bf16 outputs within one bf16 rounding step
     (rtol 2^-7, plus 3e-5 of the largest |value| near zero);
  5. the slice at full width: the default KFNetConfig (GN SCoordNet
     64..512 with a 512 head, OFlowNet encoder 32..128, r=4, U-Net
     128/128/256, s2d 2, bf16) with weights drawn from seed 0, serving
     eight 640x480 uint8 frames through OnlineRelocalizer, whose filter
     step is one CUDA graph replayed a frame. The fused kernel must launch
     once per frame after the first and the conv kernels never (every
     count set to 0 just before and read after, under replay), each pose
     kernel once a solve and each solve one pose.kernel_solves (eager on
     the first frame, replayed after), the packed
     outputs must be finite, the same frames through use_fused_kernel=False
     must give the same x and P (rtol 1e-3, atol 1e-3: the two paths share
     every bf16 op, so any difference is the kernel's), and through the
     eager filter step (graph=False) the same x, P and packed outputs
     (bit-equal is recorded; held at rtol = atol = 1e-3); no host sync
     inside a replayed frame, nor in the two frames after a reset, which
     keep the graph and replay it from the new carry;
  6. the same weights and frames in the conv-kernel configuration
     (SCoordNet conv_impl="pallas_fused", OFlowNet "pallas_3x3"): every
     kernel's launches equal the count kfnet.kernel_shapes gives for the
     config (12 chain calls a frame; conv3x3_same once on the first frame
     and 6 times on each later one; the fused update once a frame after the
     first; each pose kernel once a solve, as in phase 5), outputs finite,
     no host sync inside a frame, and the bf16
     weight layout copied once per weight tensor, not per frame (no copy
     after the second frame); every kernel
     call of one frame's (z, V) and one pair's (flow, W) within phase 4's
     tolerances of its plain version on its own inputs; those outputs
     within BOUNDS of the same path with each kernel's plain version in
     its place, and of the default config's; the graphed relocaliser
     against the eager filter step, as in phase 5;
  7. pose on known data: 4800 correspondences, 30% outliers, solved on the
     card to within 1 cm and 0.1°;
  7b. sequence: the sequence path (filter/sequence.py) in the default
     config on 16 uint8 640x480 frames: run_filter (each filter step a
     CUDA graph replay), the chunked stream of host frames at chunk 4
     (chunks 5/4/4/3, a ragged tail, uploads on a copy stream) and the run
     resumed from the carry after frame 7, each against the eager
     run_filter_python_loop on x and P at rtol = atol = TOL_PATH (bit-equal
     recorded), the fused update launched once a filter-step frame (15,
     counted under replay); run_filter_batched on two such sequences
     (B = 2), one fused launch a step for both maps, each sequence of the
     batch against its own eager loop: in bf16 recorded (a batch of two
     takes other conv and reduction orders than one frame, and a flipped
     bf16 rounding spreads through the random-weight nets), with frame 0's
     z and V within BOUNDS of the single frame's, and the same in float32
     (compute_dtype of both nets, same widths and weights) held at
     TOL_PATH; the conv-kernel config on 8 frames held the same way
     (graphed, chunked, resumed; a batch runs PyTorch's convs, the kernels
     take one frame), its launches kfnet.kernel_shapes' count for frame 0
     plus 7 filter-step frames; the batched pose solve on 8 frames of
     known poses (4800 points, 30% outliers each): every frame within 1 cm
     and 0.1°, and equal to each frame's solve_with_indices on the same
     index sets at POSE_RTOL/POSE_ATOL on T_wc (bit-equal recorded), the
     batched solve's time against 8 single solves; then, in both configs,
     eval/benchmark.py's filter_fps (32 float frames), e2e_pose_fps
     (filter + batched solve), streaming_fps_device (a 96-frame stream at
     chunk 32), the analytic GFLOP a frame, the MFU and the card's bf16
     peak (eval/flops.py; null for a card it does not know), beside the
     card's name and power limit;
  7c. pretrained: the shipped synthetic weights (the committed .npz
     export, kfnet_tpu_torch/assets) loaded on the card by pretrained.load
     and load_stage12; sceneA's held-out trajectory (seed 0, trajectory
     seed 99, 16 frames at the export's 96x128) rendered on the card by
     data/synthetic.py, against the same render on the CPU (at most 0.1% of
     the pixels off by more than 1e-4: sphere silhouettes); evaluate_sequence's
     medians within the JAX package's artifact gate (< 0.5 m, < 8°), the
     fused update's launches (15 a filter run, warm-up and timed run), the
     stage-1 + stage-2 pair's filter finite;
  7d. p3p: one 640x480 frame's 60x80 maps of a known pose (30% outliers)
     solved by RANSAC's P3P solver at the full-size synthetic preset
     (configs.synthetic_ransac(True)): within 1 cm and 0.1°; the served tick
     with the P3P solver enqueued with no host sync; the solve's time beside
     the DLT's at the same budget;
  7d'. ransac: the pose solve's three kernels (kernels/ransac.py) at the
     served shapes, the DLT over 2048 points at T = 1 and 4 and P3P over a
     stack of 4 x 19 maps of 4800 cells (map_of), 256 draws a frame, on
     known-pose maps: each stage's kernel against its plain version on the
     plain version's inputs (candidates and scores bit for bit, a NaN for a
     NaN; the refined pose and inliers within RANSAC_TOL), the three
     launches against the plain solve on the same draws; each kernel's
     device time alone (CUDA graph of 20 launches) and back to back,
     beside its plain stage's, eager and as a CUDA graph, and the whole
     solve after the draws the same way; bound: bytes at 3.35 TB/s
     (their true bound is serial depth, csrc/ransac.cu);
  7e. fleet: FleetRelocalizer, FLEET_B = 4 streams of 640x480 uint8 frames
     over FLEET_T ticks at full width, default and conv-kernel configs,
     slot 2 reset at tick FLEET_RESET: launches (one fused launch a tick;
     kfnet.kernel_shapes' conv calls times B), one capture and none after
     the reset ticks, each pose kernel once a tick's solve and each solve
     one pose.kernel_solves, no host sync in a tick with or without a
     reset mask,
     the reset slot's consistent_frac 0, pipelined (depth 1) ticks equal to
     the sync ticks, each slot against the stream alone through an
     OnlineRelocalizer (bf16 default config recorded, its float32 form and
     the conv-kernel config held at TOL_PATH relative), every conv kernel
     call of one tick pair against its plain version; fleet_tick_ms_b4 and
     fleet_pipelined_tick_ms_b4 by CUDA events, and the tick's parts: the
     filter step's graph replay and the batched pose solve;
  8. times with CUDA events: process() per frame in both configurations,
     graphed and eager, and the filter step alone (solve_pose=False): its
     host ms a frame (the enqueue) and its ms a frame, graphed and eager,
     in turns default, conv, conv, default; what a capture costs: in each
     configuration the host ms of process() on the frame that captures,
     on the next (a replay), on the two frames after a reset and on the
     frame after an in-place weight update (which captures again); the
     fused update's heads-in entry alone (its wrapper in a CUDA graph) at
     one map and a batch of four, and through its wrapper back to back; the
     kernel launches it removes from a frame (torch.profiler: the output
     steps, W * w_scale, the flow clip and the TPU kernel's entry against
     the one entry);
     each kernel through its wrapper called back to back, beside its
     plain version and (conv3x3_same) cuDNN's conv at the same shape,
     also back to back (the kernels line's ms, plain_ms, library_ms; the
     conv kernels at each distinct main-path shape, summed over a
     filter-step frame); each kernel alone: the fused update and every
     conv kernel call of one served filter-step frame on that call's own
     inputs, bias, ReLU and output type (prepared weights, preallocated
     outputs), and cuDNN's conv at each call's shape, as device time from
     a CUDA graph of 20 launches (kfnet_tpu_torch/tools/conv_tiles.py;
     the kernels line's alone_ms, library_alone_ms); the bounds; the pose
     solve;
  9. train: the three training stages at full width (configs.full_scoordnet
     / full_oflownet, bf16) on 16 640x480 frames rendered on the card by
     data/synthetic.py, each through fit_on_device (Adam, lr TRAIN_LR):
     stage 1 (scoordnet_objective, batch 8, 6 steps in chunks of 3), stage
     2 (oflownet_objective, flow_reg 0.01, 8 pairs, 6 steps), stage 3a
     (kfnet_window_objective with the fused kernel and remat, T = 4, batch
     1, 3 steps: the fused update launches once in each step's forward and
     once more in remat's recompute, 3 x (T-1) x 2 = 18; its backward is
     autograd through the plain version and launches nothing), stage 3b
     (kfnet_objective on the composition, batch 2 pairs, 2 steps); each
     stage's ms a step (CUDA events, the median over the steps after the
     first), frames/s and torch.cuda.max_memory_allocated. Checks: every
     loss, last grad norm and trained param finite; the loss of one fixed
     stage-1 batch after 8 steps of trainer.fit (lr FIXED_LR) below the
     first; the window objective with the kernel, with the kernel's plain
     version in its place and with the composition, on the same params and
     window, with deterministic algorithms (cuDNN deterministic and
     torch.use_deterministic_algorithms): loss within KERNEL_LOSS_RTOL
     relative, each grad leaf within KERNEL_GRAD_OF_MAX of its largest
     |value| against the plain version (whose autograd is the kernel's
     backward) and within one bf16 step (BF16_STEP) against the
     composition (another order of the float32 filter arithmetic, which
     the nets' bf16 weight grads round otherwise), T - 1 launches; by
     default the backward's atomics differ from run to run: recorded, with
     the kernel run twice;
     remat against none at T = 3 at tests/test_train.py:101-104's
     tolerances with deterministic algorithms (the default recorded); a
     checkpoint at step 3 resumed to step 6 bit-equal to 6 steps
     uninterrupted with deterministic algorithms (the default's gap
     recorded);
     the tiny float32 configs' loss and grads (stages 1 and 2, and the
     window objective at T = 3, B = 2) on the card against the CPU (GOLDEN,
     GRAD_*; the small configs recorded beside them, with how far the
     CPU's own grads move under a 1e-6 relative nudge of the params); the
     trained weights through evaluate_sequence (graphed) against
     run_filter_python_loop (eager) on 8 held-out frames at TOL_PATH, 14
     fused launches;
  10. pretrained_full: the four full-size shipped stages (full_stages:
     artifacts/pretrained_full and artifacts/pretrained_full_nonorm,
     stage3_sceneA and stage3_outdoor_train, the JAX package's orbax
     exports read by utils/checkpoint.py's reader, float32 masters from
     bf16), each loaded on the card (load seconds: the reader's decode of
     about 40 MB), GroupNorm stages at w_scale 16 and norm="none" ones at
     their meta's serving w_scale 2; its scene's held-out trajectory
     (its row of the protocol's table: sceneA seed 0, outdoor_train seed
     50 at world scale 20; trajectory seed + 99; PRE_T frames at 640x480)
     rendered on the card and served by the graphed OnlineRelocalizer
     (its default RANSAC) in the default and the conv-kernel
     configurations (conv_kernel_config: SCoordNet on the chain kernel
     for GroupNorm, on conv3x3_same for norm none): medians below
     FULL_GATE for sceneA and OUTDOOR_GATE (twice the JAX package's CPU
     medians, JAX_CPU_MEDIANS) for outdoor_train, poses finite, launches
     counted (the fused update PRE_T - 1 a config, the conv kernels
     kfnet.kernel_shapes' count); for one stage of each trunk, every conv
     kernel call of one frame pair against its plain version
     (check_calls) with its weights;
  10b. winograd: the flagship and the norm="none" sceneA stage at
     640x480 with conv_impl="winograd" on both nets (kernels/winograd.py,
     F(2x2, 3x3): the contraction a torch.bmm with float32 accumulation)
     against conv_impl="xla": every Winograd conv call of one frame pair
     against cuDNN's direct conv on its inputs at WINO_BF16 of the
     largest |y| (bf16), the pair's (z, V) of the float32 nets at WINO_Z
     and WINO_V (tests/test_winograd.py's bounds); one PRE_T-frame
     run_filter of each (the fused update's PRE_T - 1 launches, the
     poses' medians by the batched solve); filter_fps of the two in
     WINO_TURNS alternating turns each (a record, not a claim); whether
     torch.bmm(out_dtype=) has a backward on the card;
  11. data: a 7-Scenes fixture (chess, DATA_TRAIN + DATA_TEST frames at
     640x480) and a Cambridge fixture written by the port's fixture
     writers (rendered on the card, PNG-encoded by image_io); every file
     read back by the C++ decoder and by the plain numpy decoder, bit-equal;
     depth_png_to_labels against labels.generate on the card at rtol = atol
     = DATA_LABEL_TOL; the first batch of batched_native against batched's
     (same seed: images and validity equal, coordinates at the label
     tolerance); the loader's frames/s on both routes (DATA_EPOCHS epochs
     of the train split, files in the page cache); then the three train
     scripts at --net_scale full on the card on the 7-Scenes fixture
     (batch CLI_B, CLI_STEPS steps each: train_scoordnet with the C++
     batch loader, train_oflownet, and train_kfnet from the two exports
     with --window_size CLI_T --remat): step counts, finite losses and
     params, metrics.jsonl, the last checkpoint, the export and its meta;
     no kernel launched by stages 1 and 2, and train_kfnet's fused
     launches 2 (T - 1) a step (the forward and remat's recompute, each
     for the whole batch), 24 for 6 steps at T = 3; ms a step (the median
     over the steps after the first, CliTimer), the card's busy ms and
     idle share over those steps from a torch.profiler trace, the host's
     ms between steps and within one, and peak memory; then 12-Scenes: a
     fixture (S12_TRAIN + S12_TEST frames at 640x480) written by the
     port's JPEG encoder (quality 95, 4:4:4) and one 4:2:0 file beside it,
     every file decoded by the C++ route and by the plain numpy route,
     bit-equal; the loaded colour within JPEG_MEAN / JPEG_MAX of the
     render; train_scoordnet --dataset 12scenes at full width for
     S12_STEPS steps (the per-frame loader: the batch loader reads PNG
     only), losses and params finite;
  12. eval: a 7-Scenes fixture (chess, EVAL_TRAIN + EVAL_TEST frames at
     640x480) through tools/acceptance.py at full width on the card
     (EVAL_STEPS, batch EVAL_B): every stage export present, the filtered
     and measurement-only medians finite, each eval CLI call's launches
     (the filtered eval's fused update EVAL_TEST - 1 a filter run,
     evaluate_sequence's warm-up and EVAL_TIMING_REPS timed runs; none in
     measurement-only); the run again with --pose_smooth_beta 0.4: no
     optimizer step (every stage cached) and a finite filtered_smoothed
     block; then the eval CLI with --kfnet_ckpt on the committed flagship
     over the same fixture in batch, --streaming and --streaming
     --uint8_stream, each with --dump_dir: launches (EVAL_TEST - 1 a
     filter run), the streaming maps against the batch maps at TOL_PATH,
     uint8 against float streaming at TOL_PATH (bit-equality recorded:
     the device ingest multiplies by 1/255 as the JAX package's does, the
     loaders divide by 255), the CLI's maps and poses against
     evaluate_sequence with pretrained.load(FULL_ASSETS) on the same
     loaded frames (TOL_PATH, POSE_RTOL / POSE_ATOL; bit-equality
     recorded), the medians below FULL_GATE; tools/eval_poses.py on the
     batch dump: its poses against the CLI's (same seed and solver), held
     at POSE_RTOL / POSE_ATOL, bit-equality recorded, and its medians
     equal;
  13. soak: tools/soak.run_soak on the flagship at 640x480, SOAK_FRAMES
     frames of sceneA rendered on the card a chunk at a time (chunk
     SOAK_CHUNK): healthy (no non-finite value, covariance within the
     measurement envelope, stationary, host RSS flat), the fused update
     launched SOAK_FRAMES - 1 times, steady_state_fps and rss_growth_mb;
  14. mesh: the multi-GPU path over a kfnet_tpu_torch.parallel.mesh.Mesh:
     the visible GPUs that divide MESH_B, or, where one card is visible,
     cuda:0 named MESH_ENTRIES times (the entries share the card; the
     line names the mesh and says so). run_filter_fleet over MESH_T uint8
     640x480 frames of MESH_B streams at full width in both configs: the
     launches (the fused update once an entry a step after the first;
     kfnet.kernel_shapes' conv calls per stream), each entry's streams
     against the same streams alone on its device (bit-equality recorded,
     held at TOL_PATH), the whole against the one-device B = MESH_B run
     (held in the conv-kernel config, recorded in bf16);
     FleetRelocalizer(mesh=) over FLEET_T ticks with a reset, in float32
     at pipeline depth 0 and 1 on the shipped full-size weights
     (pretrained.FULL_ASSETS) and MESH_B windows of sceneA's renders, and
     in the conv-kernel config on the random weights: x within TOL_PATH
     of the largest |x| of the one-device fleet's; the poses too in the
     conv-kernel config (bit-equal maps), and on sceneA their median
     (where RANSAC's best hypotheses tie, a float32 slot of one picks
     another winner now and then: the largest recorded) with both
     fleets' medians against the ground truth under FULL_GATE (the pose
     solve runs once on the maps gathered on the first entry, with the
     one-device fleet's draws), bit-equality recorded, one host
     wait a tick, no sync while a tick is enqueued, the launches; one
     data-parallel step of stage 1 (batch MESH_TRAIN_B, float32) against
     the same step on one device: loss and grad_norm within DP_LOSS_RTOL,
     params within DP_PARAMS_ATOL wherever the gradient is above
     DP_NEAR_ZERO of its leaf's largest (Adam's first step moves a param
     whose gradient is within noise of zero by up to 2 lr), the gradients
     recorded (bf16 recorded); MESH_WIN_STEPS steps of the window
     objective (T = MESH_WIN_T, batch MESH_WIN_B, remat, the fused kernel
     on every entry: 2 (T - 1) launches an entry a step), its first loss
     and grad_norm within DP_LOSS_RTOL of one device's;
     cost_volume_spatial at 60x80x128, r = 4, against cost_volume within
     CV_ATOL; run_filter_spatial on the MESH_T frames of one stream
     against run_filter (the composition) on one device: in float32 at
     GOLDEN with its largest deviation and no kernel launched (bf16
     recorded), and in the float32 conv-kernel config with its launches
     (conv3x3_same on each shard's halo'd block, the chain once a frame
     on the gathered map), every conv kernel call of a frame pair against
     its plain version on its inputs (check_calls), x's median and largest
     difference recorded (the kernels' bf16 operands); ms a fleet tick, a
     stage-1 train step (bf16) and a spatial frame over the mesh, and on
     one device beside them where the entries are distinct GPUs.
  15. study: the study tools of kfnet_tpu_torch/tools at full width on
     the card, in a temporary work dir. protocol.prepare_stages at 640x480
     (the flagship nets, full_size=True) on sceneA and heldout
     (STUDY_TRAIN train and STUDY_TEST test frames, STUDY_STEPS steps a
     stage), then evaluate_scenes: every row finite, the optimizer steps
     (4 STUDY_STEPS: stage 1 twice, stage 2, stage 3 on sceneA; stage 3
     trains 2-frame pairs through the composition, which returns the
     prior its NLL needs), the fused update's launches (STUDY_TEST - 1 a
     filtered run, evaluate_sequence's warm-up and EVAL_TIMING_REPS timed
     runs, both scenes; none while training); a strict re-run from the
     cache: no optimizer step, the params and sceneA's filtered maps
     bit-equal. calibrate.sweep_scene on sceneA's cache over χ² {2.37,
     7.81} x w {1, 8}, rows finite; filter_from_series (the warp ∘ Kalman
     composition over the precomputed series) at the config's χ² and
     w_scale against run_filter (the fused kernel, STUDY_TEST - 1
     launches) on the same frames: in the float32 form of the config
     (same weights) x and P within TOL_PATH, in bf16 recorded; run_filter
     with the fused kernel against the composition, timed in alternating
     turns (STUDY_TURNS each). diagnose.main on heldout with --modes
     measurement_only,cf_derigid,filtered_serving: every field finite.
     conv_study.main at 640x480 over STUDY_CONV_T frames, --norms group
     --impls xla,pallas_3x3,pallas_fused: each cell's launches (its
     filter_fps: 1 + 3 x 3 run_filter calls, each kfnet.kernel_shapes'
     conv calls of a first frame and STUDY_CONV_T - 1 later ones, the
     fused update STUDY_CONV_T - 1 times), every conv kernel call of one
     frame pair of the pallas_3x3 cell (SCoordNet's eligible convs on
     conv3x3_same) and of the pallas_fused cell (its conv3x3_gn_chain
     trunk) against its plain version (check_calls, phase 4's tolerances)
     and the calls' shapes against kernel_shapes', fps and MFU. norm_study over
     the group cache and a norm="none" cache (prepare_cache's route: the
     group cache's stage 2 copied, then STUDY_STEPS steps of stages 1 and
     3), fps, MFU and the paired report finite. profile_filter over
     STUDY_PROFILE_T frames: the fused kernel among the traced kernels
     (STUDY_PROFILE_T - 1 a run), the idle fraction. profile_tick at
     B = 4: compute_ms, roundtrip_floor_ms, tick_ms, the residual, the
     fused update's launches (PT_FLEET_TICKS filter ticks a fleet, two
     fleets). The host tools: cache_manifest builds and verifies the work
     dir, and a flipped byte in a copy is reported; generate_labels on a
     640x480 7-Scenes fixture (the port's fixture writer); eval.main on the
     committed flagship over its test split with --dump_dir, and
     visualize on that dump (3 PNGs a frame at 480x640);
  16. graft_entry: the port's root entry points (kfnet_tpu_torch/
     graft_entry.py, the counterpart of __graft_entry__.py). entry()'s
     params and frames on the card, its config with the fused kernel on;
     its step (first_step, then filter_step, at 480x640) against the
     same step with use_fused_kernel=False on the same params and frames, x1, P1 and flow at rtol = atol = TOL_PATH,
     finite, P1 > 0; 1 fused launch and no conv-kernel launch a call,
     eager and as one captured CUDA graph (counted under replay); the
     graph against the eager call at GRAPH_TOL; the median ms of
     GRAFT_CALLS calls of each (CUDA events) beside nvidia-smi's name and
     power limit; dryrun_multichip(GRAFT_DRYRUN_ENTRIES) on cuda:0 named
     that many times (its data-parallel joint step, width-sharded filter
     and fleet on the composition: no kernel launch), with its seconds;
Imports only the standard library, numpy, torch and kfnet_tpu_torch; reads
the shipped full-size stages under artifacts/ (the JAX package's orbax
exports) through kfnet_tpu_torch's own reader; writes only the kernel build directory, and the
training checkpoints of phase 9 and the fixtures, train outputs and dumps
of phases 11 and 12, in temporary directories it removes.
"""

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock as mock
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the conv kernels' tolerances (TOL_F32_SUM: f32 outputs and Σy, of the
# largest |value|; TOL_S2: Σy², rtol; BF16_STEP: one bf16 rounding step,
# rtol), their check against the plain version and the H100 SXM's memory
# rate live beside the conv kernels' timing tool, which checks the same
from kfnet_tpu_torch.tools.conv_tiles import (  # noqa: E402
    BF16_STEP, HBM_BYTES_PER_S, TOL_F32_SUM, TOL_S2, arguments, call_errors)

F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TOL_X, TOL_P = 2e-5, 2e-5   # the kernel against its plain version
ULP_TOL = 4                 # heads-in entry's flow, W, z, V: two libdevice
                            # results of at most 2 ulps error each
# the heads-in entry's constants; the clamps are the nets' LOG_VAR_CLIP
STEP_KW = dict(w_scale=16.0, coord_scale=1.5, coord_offset=(0.5, -1.0, 2.0),
               log_w_clip=(-12.0, 12.0), log_v_clip=(-12.0, 12.0))
TOL_PATH = 1e-3             # fused vs unfused slice, x and P (rtol, atol)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # fused kernel's gradients: golden tols
# conv-kernel config against the default one, and against the same path
# with each conv kernel's plain version in its place, same weights and
# frames: the largest |difference| over the largest |value| of the other
# output for z and flow, the largest relative difference for the variances
# V and W. About 3x what the card showed against the default (z 0.015,
# flow 0.023, V 0.035, W 0.023); against the plain path it showed as much
# (z 0.014, flow 0.022, V 0.033, W 0.029). A reordered float32 sum flips a
# bf16 rounding now and then, and through the 15-layer random-weight trunk
# the flips spread until both sides differ at bf16's own noise level. So
# this bound cannot be tight; each kernel call of the path is held tightly
# against its plain version on its own inputs instead (check_calls).
BOUNDS = {"z": 0.05, "flow": 0.07, "V": 0.1, "W": 0.1}
IMG = (480, 640, 3)
SEQ_T, SEQ_T_CONV = 16, 8   # frames of the sequence phase, per config
PRE_T = 16                  # frames of sceneA's held-out trajectory
FLEET_B, FLEET_T = 4, 6     # the fleet phase's streams and ticks
FLEET_RESET = 3             # the tick at which slot 2 starts over
# the batched pose solve against each frame's solve on the same indices,
# T_wc: rtol, and an atol for its entries near 0
POSE_RTOL, POSE_ATOL = 1e-4, 1e-6
FORBIDDEN = ("jax", "kfnet_tpu", "__graft_entry__", "orbax", "optax",
             "tensorstore", "zstandard", "cv2", "PIL")
# phase "train" (the stages at full width, 640x480, on a rendered sequence)
TRAIN_FRAMES = 16           # frames of the training sequence
TRAIN_B, TRAIN_STEPS, TRAIN_CHUNK = 8, 6, 3  # stages 1 and 2
WIN_T, WIN_B, WIN_STEPS = 4, 1, 3            # stage 3a: BPTT windows, remat
PAIR_B, PAIR_STEPS = 2, 2                    # stage 3b: pairs, composition
TRAIN_LR = 3e-4             # the demo's full-size rate
FIXED_LR = 1e-4             # one batch 8 times: the reference recipe's rate
                            # (OptimizerConfig; 3e-4 oscillated there)
# the window objective, the fused kernel against the composition: the loss
# relative, each grad leaf's largest |difference| over its largest |value|
KERNEL_LOSS_RTOL, KERNEL_GRAD_OF_MAX = 1e-4, 1e-3
# remat against none: tests/test_train.py:101-104
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL, REMAT_GRAD_ATOL = 1e-6, 2e-3, 1e-5
# card against CPU, float32: the golden loss tolerance; grads within rtol
# plus atol plus a share of the leaf's largest |value| (tests/test_torch_train.py;
# named apart from the fused kernel's GRAD_RTOL / GRAD_ATOL above)
GOLDEN = dict(rtol=5e-4, atol=5e-5)
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL, TRAIN_GRAD_LEAF = 2e-3, 1e-5, 5e-4
# phase "pretrained_full": the full-size sceneA weights' medians, each config
FULL_GATE = {"median_translation_m": 0.10, "median_rotation_deg": 2.0}
# the JAX package's medians of each full-size stage on the CPU over the
# same frames (tools_port/jax_full_medians.py: OnlineRelocalizer, its
# default RANSAC, seed 0), and the outdoor stages' gates: twice those
JAX_CPU_MEDIANS = {
    "full_sceneA": {"median_translation_m": 0.05010,
                    "median_rotation_deg": 0.8137},
    "full_nonorm_sceneA": {"median_translation_m": 0.04874,
                           "median_rotation_deg": 0.6102},
    "full_outdoor_train": {"median_translation_m": 0.8868,
                           "median_rotation_deg": 1.0380},
    "full_nonorm_outdoor_train": {"median_translation_m": 0.4057,
                                  "median_rotation_deg": 0.5068}}
OUTDOOR_GATE = {
    norm: {k: 2.0 * v for k, v in JAX_CPU_MEDIANS[name].items()}
    for norm, name in (("group", "full_outdoor_train"),
                       ("none", "full_nonorm_outdoor_train"))}
# phase "winograd": tests/test_winograd.py's bounds, bf16 per conv output
# (of its largest |y|) and (z, V) of the float32 nets; filter_fps turns
WINO_BF16 = 0.015
WINO_Z = dict(rtol=1e-3, atol=1e-4)
WINO_V = dict(rtol=1e-2, atol=1e-6)
WINO_TURNS = 5
# phase "data": the fixtures' frames, the loader's batch and epochs, the
# labels' tolerance (tests/test_native_io.py:61), and the train scripts at
# full width: batch, steps, BPTT window
DATA_TRAIN, DATA_TEST = 8, 6
DATA_B, DATA_EPOCHS = 4, 16
DATA_LABEL_TOL = 1e-5
CLI_B, CLI_T = 2, 3
CLI_NET_SCALE = "full"
# each script's ms a step is the median over its steps after the first
CLI_STEPS = {"train_scoordnet": 8, "train_oflownet": 8, "train_kfnet": 6}
# phase "data", 12-Scenes: the JPEG fixture's frames, the bound of its
# loaded colour against the render (tests/test_acceptance.py:89-90), and
# train_scoordnet's steps on it
S12_TRAIN, S12_TEST = 4, 2
JPEG_MEAN, JPEG_MAX = 0.02, 0.15
S12_STEPS = 2
# phase "eval": the 7-Scenes fixture's frames, the acceptance run's steps
# and batch, evaluate_sequence's timed runs after its warm-up (so a
# filtered eval runs the filter 1 + EVAL_TIMING_REPS times), and the net
# scale of the flagship's CLI runs
EVAL_TRAIN, EVAL_TEST = 8, 16
EVAL_STEPS = {"sc_steps": 4, "of_steps": 4, "joint_steps": 2}
EVAL_B = 2
EVAL_TIMING_REPS = 3
FLAGSHIP_NET_SCALE = "full"
# phase "soak": the stream's frames and chunk (the flagship at 640x480)
SOAK_FRAMES, SOAK_CHUNK = 960, 48
# phase "mesh": the streams (a batch the mesh splits), the entries of the
# mesh where one card is visible, the fleet's frames, stage 1's batch, the
# window objective's T, batch and steps; the data-parallel step against
# one device: loss rtol, params atol (tests/test_sharding.py:54-59)
MESH_B, MESH_ENTRIES, MESH_T = 4, 4, 8
MESH_TRAIN_B = 8
MESH_WIN_T, MESH_WIN_B, MESH_WIN_STEPS = 3, 4, 2
DP_LOSS_RTOL, DP_PARAMS_ATOL = 1e-5, 1e-5
DP_NEAR_ZERO = 1e-3         # of a leaf's largest |grad|: within noise of 0
CV_ATOL = 1e-6              # the W-sharded cost volume against cost_volume
# phase "study": the protocol's frames and steps a stage, the conv study's
# and the profiler's frames, the timed turns of the fused kernel against
# the composition, the fixture's frames, and profile_tick's filter ticks a
# fleet (the second process() call, _median_ms's warm-up and 5 x 3 calls,
# the chain's warm-up of 2 and 5 x 16 ticks)
STUDY_TRAIN, STUDY_TEST, STUDY_STEPS = 8, 16, 2
STUDY_CONV_T, STUDY_PROFILE_T, STUDY_TURNS = 8, 8, 5
STUDY_FIX_TRAIN, STUDY_FIX_TEST = 4, 4
FILTER_FPS_RUNS = 1 + 3 * 3            # eval/benchmark.filter_fps's calls
PT_FLEET_TICKS = 1 + (1 + 5 * 3) + (2 + 5 * 16)
# phase "ransac": the served shapes (name, solver, frames), the experts a
# frame of the P3P stack, and the tolerances of the refined pose against the
# plain version's (tests/test_torch_ransac_cuda.py says why; candidates and
# scores are held bit for bit)
RANSAC_SHAPES = (("stream1", "dlt", 1), ("fleet4", "dlt", 4),
                 ("esac4", "p3p", 4))
RANSAC_EXPERTS = 19
RANSAC_TOL = {"T_wc": 1e-3, "inliers": 2.0}
# the libraries whose rounding the pose kernels copy, as the probes behind
# csrc/ransac.cu ran (library_versions()'s fields): under others the
# candidates may round apart from the plain version's with no kernel change
RANSAC_PROBED = {"torch": "2.11.0+cu128", "cuda": "12.8",
                 "cublas": "12.9.2", "cusolver": "11.7.3"}
# the pose kernels (kernels/ransac.py's wrappers) and the tracer's counters
# of the served solve
POSE_KERNELS = ("hypothesize", "score", "pick_and_refine")
POSE_COUNTERS = ("pose.kernel_solves", "pose.captures", "pose.replays")
HBM_BYTES_PER_MS = 3.35e9   # an H100 SXM's 3.35 TB/s
# phase "graft_entry": the timed calls of entry()'s step, eager and
# graphed; graphed against eager (rtol, atol); the dry run's entries
GRAFT_CALLS, GRAPH_TOL, GRAFT_DRYRUN_ENTRIES = 20, 1e-3, 4


def say(phase, t0, **fields):
  print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                    **fields}), flush=True)


def nvidia_smi():
  try:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20)
    if res.returncode == 0 and res.stdout.strip():
      return res.stdout.strip().splitlines()[0]
    return f"nvidia-smi failed ({res.returncode}): {res.stderr.strip()}"
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi failed: {e}"


def probed_libraries(libraries):
  """Whether ``libraries`` (library_versions()) are the ones the pose
  kernels' rounding was probed under (RANSAC_PROBED)."""
  return all(libraries.get(k) == v for k, v in RANSAC_PROBED.items())


def library_versions():
  """torch, its CUDA and cuDNN, and the cuBLAS and cuSOLVER this process
  loaded (each one's GetProperty: major.minor.patch, None where not
  loaded): the libraries whose rounding the pose kernels copy
  (kernels/csrc/ransac.cu, RANSAC_PROBED)."""
  import ctypes
  import torch
  a = torch.ones(8, 8, device="cuda")  # a product and a Cholesky load both
  torch.linalg.cholesky(a @ a.T + 8 * torch.eye(8, device="cuda"))
  torch.cuda.synchronize()
  out = {"torch": torch.__version__, "cuda": torch.version.cuda,
         "cudnn": torch.backends.cudnn.version()}
  with open("/proc/self/maps") as f:
    loaded = sorted({line.split()[-1] for line in f if ".so" in line})
  for lib in ("cublas", "cusolver"):
    path = next((p for p in loaded
                 if os.path.basename(p).startswith(f"lib{lib}.so")), None)
    if path is None:
      out[lib] = None
      continue
    get = getattr(ctypes.CDLL(path), f"{lib}GetProperty")
    parts = [ctypes.c_int(-1) for _ in range(3)]  # MAJOR, MINOR, PATCH
    for i, p in enumerate(parts):
      get(i, ctypes.byref(p))
    out[lib] = ".".join(str(p.value) for p in parts)
  return out


def filter_inputs(rng, h, w, r, oob):
  """The inputs of tests/test_pallas_fused.py at (h, w), float32 numpy."""
  import numpy as np
  x = rng.normal(size=(h, w, 3)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  lim = r if oob else 1.5
  flow = rng.uniform(-lim, lim, (h, w, 2)).astype(np.float32)
  W = rng.uniform(0.01, 0.5, (h, w, 1)).astype(np.float32)
  z = x + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.3
  V = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  return x, P, flow, W, z, V


def fused_grads(ff, args, r, thr):
  """Gradients of a loss on the fused update's outputs through the kernel's
  autograd node and through the plain version, on the card; raises unless
  all six agree at the golden tolerance. Returns the largest |difference|
  of each."""
  import numpy as np
  import torch
  g = torch.Generator(device=args[0].device).manual_seed(7)
  gx = torch.randn(args[0].shape, generator=g, device=args[0].device)
  gP = torch.randn(args[1].shape, generator=g, device=args[0].device)
  grads = []
  for fn in (ff.fused_warp_kalman, ff.fused_warp_kalman_reference):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    x, P, _ = fn(*ts, radius=r, threshold=thr)
    grads.append(torch.autograd.grad(
        torch.sum(x * gx) + torch.sum(P * gP), ts))
  out = {}
  for name, k, p in zip(("x_prev", "P_prev", "flow", "W", "z", "V"),
                        *grads):
    out[name] = (k - p).abs().max().item()
    if not (p.abs().max().item() > 0 and np.allclose(
        k.cpu().numpy(), p.cpu().numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)):
      raise AssertionError(f"fused kernel gradient of {name} disagrees: "
                           f"{out[name]}")
  return out


def raw_heads(rng, h, w, batch=None):
  """OFlowNet's and SCoordNet's raw heads and a previous (x, P), float32
  numpy: flows and variances near the previous state, every 11th raw flow
  at +30 and every 13th at -30 (tanh saturates: the flow is ±r), every 7th
  raw log W at +20 and every 7th at -20, every 5th raw log V at +15 and
  every 9th at -15 (past the ±12 clamps)."""
  import numpy as np
  lead = (h, w) if batch is None else (batch, h, w)
  x = rng.normal(size=lead + (3,)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, lead + (1,)).astype(np.float32)
  fl = (rng.normal(size=lead + (2,)) * 0.4).astype(np.float32)
  lw = np.log(rng.uniform(0.01, 0.5, lead + (1,)) / 16.0).astype(np.float32)
  off = np.asarray(STEP_KW["coord_offset"], np.float32)
  z = x + (rng.normal(size=lead + (3,)) * 0.3).astype(np.float32)
  rc = ((z - off) / STEP_KW["coord_scale"]).astype(np.float32)
  lv = np.log(rng.uniform(0.05, 2.0, lead + (1,)) / 2.25).astype(np.float32)
  fl.reshape(-1)[::11], fl.reshape(-1)[5::13] = 30.0, -30.0
  lw.reshape(-1)[::7], lw.reshape(-1)[3::7] = 20.0, -20.0
  lv.reshape(-1)[::5], lv.reshape(-1)[2::9] = 15.0, -15.0
  return (np.concatenate([fl, lw], -1), np.concatenate([rc, lv], -1), x, P)


def ulps(a, b):
  """Largest distance in units in the last place between two float32
  tensors (0: the same bits)."""
  import torch
  def ordered(t):
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
  return int((ordered(a) - ordered(b)).abs().max().item())


def step_vs_plain(ff, args, r, thr):
  """The heads-in entry's launch against its plain version on the same
  inputs; raises on a miss. Returns the deviations."""
  import torch
  kw = dict(radius=r, threshold=thr, **STEP_KW)
  got = ff._launch_step(*args, r, *STEP_KW.values(), thr, 1e8)
  want = ff.fused_filter_step_reference(*args, **kw)
  torch.cuda.synchronize()
  flow, W, z, V = want[3:]  # the plain mask just under and over the gate
  chi2 = torch.stack([ff.fused_warp_kalman_reference(
      args[2], args[3], flow, W, z, V, r, t)[2] for t in (thr * (1 - 1e-5),
                                                         thr * (1 + 1e-5))])
  away = chi2[0] == chi2[1]  # not within 1e-5 of the gate
  out = {"ulps": {n: ulps(g, w) for n, g, w in
                  zip(("flow", "W", "z", "V"), got[3:], want[3:])},
         "max_abs_dx": (got[0] - want[0]).abs().max().item(),
         "max_rel_dP": ((got[1] - want[1]).abs() / want[1].abs()).max().item(),
         "mask_equal_away_from_ties": bool(torch.equal(got[2][away],
                                                       want[2][away])),
         "ties": int((~away).sum().item()),
         "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
         "flow_at_bound": int((want[3].abs() == r).sum().item())}
  out["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want))
  if not (max(out["ulps"].values()) <= ULP_TOL and out["max_abs_dx"] <= TOL_X
          and out["max_rel_dP"] <= TOL_P and out["mask_equal_away_from_ties"]):
    raise AssertionError(f"fused_filter_step disagrees with its plain "
                         f"version: {out}")
  return out


def step_grads(ff, args, r, thr):
  """Gradients of a loss on all six differentiable outputs of the heads-in
  entry through its autograd node and through the plain version, on the
  card; raises unless the four inputs' agree at the golden tolerance."""
  import numpy as np
  import torch
  g = torch.Generator(device=args[0].device).manual_seed(8)
  kw = dict(radius=r, threshold=thr, **STEP_KW)
  cots = None
  grads = []
  for fn in (ff.fused_filter_step, ff.fused_filter_step_reference):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*ts, **kw)
    diff = [o for i, o in enumerate(out) if i != 2]
    if cots is None:
      cots = [torch.randn(o.shape, generator=g, device=o.device)
              for o in diff]
    loss = sum(torch.sum(o * c) for o, c in zip(diff, cots))
    grads.append(torch.autograd.grad(loss, ts))
  res = {}
  for name, k, p in zip(("raw_flow_head", "raw_coord_head", "x_prev",
                         "P_prev"), *grads):
    res[name] = (k - p).abs().max().item()
    if not (p.abs().max().item() > 0 and np.allclose(
        k.cpu().numpy(), p.cpu().numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)):
      raise AssertionError(f"fused_filter_step gradient of {name} "
                           f"disagrees: {res[name]}")
  return res


def profiled_kernels(fn, n=5):
  """CUDA kernels one call of ``fn`` runs (torch.profiler's trace, as
  tools/profile_online.py reads it)."""
  from kfnet_tpu_torch.tools import profile_online
  return len(profile_online.trace_kernels(fn, n)[0]) / n


def same_outputs(a, b):
  """(bit-equal, largest |difference|) of two relocalisers' states and of
  the packed outputs of their process() calls."""
  import numpy as np
  import torch
  def packed(outs):
    return np.stack([np.concatenate([[i["consistent_frac"]],
                                     p.reshape(-1), [i["num_inliers"],
                                                     i["inlier_ratio"]]])
                     for p, i in outs])
  pa, pb = packed(a[1]), packed(b[1])
  xa, Pa = a[0].state[:2]
  xb, Pb = b[0].state[:2]
  return {"bit_equal": bool(torch.equal(xa, xb) and torch.equal(Pa, Pb) and
                            np.array_equal(pa, pb)),
          "x_max_abs": (xa - xb).abs().max().item(),
          "P_max_abs": (Pa - Pb).abs().max().item(),
          "packed_max_abs": float(np.abs(pa - pb).max()),
          "held": bool(torch.allclose(xa, xb, rtol=TOL_PATH, atol=TOL_PATH)
                       and torch.allclose(Pa, Pb, rtol=TOL_PATH,
                                          atol=TOL_PATH)
                       and np.allclose(pa, pb, rtol=TOL_PATH,
                                       atol=TOL_PATH))}


def rodrigues(w):
  import numpy as np
  th = float(np.linalg.norm(w))
  k = w / th
  Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
  return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def host_syncs(reloc, frame, **kw):
  """Warnings of torch's sync debug mode while one frame (or a fleet's
  tick) is enqueued: its work must not wait on the device before its one
  result copy."""
  import torch
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      packed = reloc.tick(frame, **kw)
    finally:
      torch.cuda.set_sync_debug_mode("default")
  (packed.full() if hasattr(packed, "full") else packed).cpu()
  return [str(w.message)[:120] for w in caught
          if "called a synchronizing" in str(w.message)]


def capture_costs(reloc, frames):
  """Host ms of process() (each ends in its one result copy) on a new
  graphed relocaliser: the frame that captures the filter step, the next
  one (a replay), the two after a reset (first_step, then a replay from
  the new carry) and the one after an in-place weight update (which
  captures again); raises unless only the first and last captured."""
  import torch
  def ms(frame):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reloc.process(frame)
    return (time.perf_counter() - t0) * 1e3
  reloc.process(frames[0])
  out = {"capture": ms(frames[1]), "replay": ms(frames[2])}
  graph = reloc._step
  reloc.reset()
  out["after_reset"] = [ms(frames[3]), ms(frames[4])]
  kept = reloc._step is graph
  leaf = next(p for p in graph._leaves if p.dim() == 4)
  with torch.no_grad():
    leaf.add_(0.0)  # a new version of the same values
  out["after_weight_update"] = ms(frames[5])
  if not (kept and reloc._step is not graph):
    raise AssertionError("captures: not at the first filter frame and "
                         "after the weight update only")
  return out


def cuda_ms(fn, n):
  """Mean ms of ``fn`` over n runs, by CUDA events, after one warm-up."""
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


# beyond the main path's shapes: an odd map, and a map whose rows and
# columns are not multiples of the 8 x 8 pixel tile, at cout 128 and 512
EXTRA_SAME = [(17, 23, 256, 128), (13, 21, 128, 128), (13, 21, 128, 512)]
EXTRA_CHAIN = [(17, 23, 256, 128), (13, 21, 256, 512)]


def check_conv_kernels(c3, conv_inputs, gen, dev, same_shapes, chain_shapes):
  """Each conv kernel against its plain version; raises on a miss."""
  import torch
  out = {"conv3x3_same": {}, "conv3x3_gn_chain": {}, "same_splits": {}}
  for shape in same_shapes + EXTRA_SAME:
    x, wt, b, _, _ = conv_inputs(gen, *shape, dev)
    splits = c3.plan(*shape, sms=c3.sm_count(dev.index)).splits
    for bias, relu, od in ((b, True, torch.float32),
                           (None, False, torch.bfloat16)):
      args = (x, wt, bias, relu, od)
      got = c3.conv3x3_same(*args)
      errs, ok = call_errors("conv3x3_same", args, {}, got)
      same_twice = torch.equal(got, c3.conv3x3_same(*args))
      err = errs["y"]
      key = f"{shape}/{'f32_bias_relu' if relu else 'bf16_layer'}"
      out["conv3x3_same"][key] = err
      out["same_splits"][str(shape)] = splits
      if not (ok and same_twice):
        raise AssertionError(f"conv3x3_same disagrees at {key}: {err}, "
                             f"bit-equal twice: {same_twice}")
  for i, shape in enumerate(chain_shapes + EXTRA_CHAIN):
    x, wt, _, scale, shift = conv_inputs(gen, *shape, dev)
    args = (x, scale, shift, wt, i > 0)
    got = c3.conv3x3_gn_chain(*args)
    again = c3.conv3x3_gn_chain(*args)
    errs, ok = call_errors("conv3x3_gn_chain", args, {}, got)
    same_twice = all(torch.equal(a, b) for a, b in zip(got, again))
    out["conv3x3_gn_chain"][str(shape)] = dict(
        errs, prologue_relu=i > 0, bit_equal_twice=same_twice)
    if not (ok and same_twice):
      raise AssertionError(f"conv3x3_gn_chain disagrees at {shape}: "
                           f"{out['conv3x3_gn_chain'][str(shape)]}")
  return out


@contextlib.contextmanager
def recording(c3, calls):
  """Record each conv kernel call's arguments and result in ``calls``
  ({wrapper name: []}). While patched, a wrapper adds its launch to its
  recorder's count, not to its own."""
  with contextlib.ExitStack() as stack:
    for name, log in calls.items():
      def rec(*args, _real=getattr(c3, name), _log=log, **kwargs):
        out = _real(*args, **kwargs)
        _log.append((args, kwargs, out))
        return out
      rec.launches = 0
      stack.enter_context(mock.patch.object(c3, name, rec))
    yield


def check_calls(c3, calls):
  """Every recorded call against its plain version on its own inputs, at
  the tolerances of ``check_conv_kernels``; raises on a miss."""
  out = {}
  for name, log in calls.items():
    worst = {}
    for args, kwargs, got in log:
      errs, ok = call_errors(name, args, kwargs, got)
      if not ok:
        raise AssertionError(f"{name} disagrees in the path at "
                             f"{tuple(args[0].shape)}: {errs}")
      worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
    out[name] = dict(calls=len(log), **worst)
  return out


def call_shape(name, args, kwargs):
  """The (h, w, cin, cout) of a recorded conv kernel call."""
  a = arguments(name, args, kwargs)
  return (*a["x"].shape, a["w"].shape[0])


def deviation(got, want, relative):
  d = (got.float() - want.float()).abs()
  if relative:
    return {"max_abs": d.max().item(),
            "max_rel": (d / want.float().abs()).max().item()}
  scale = want.float().abs().max().item()
  return {"max_abs": d.max().item(), "scale": scale,
          "max_rel": d.max().item() / scale}


def time_conv_kernels(c3, conv_tiles, gen, dev, shapes, chain):
  """Per distinct shape, ms per call by CUDA events, called back to back:
  the wrapper (bf16 output, no bias; the chain's prologue ReLU after its
  first shape), its plain version and cuDNN's bf16 channels-last conv
  (``F.conv2d``); and the call's bound."""
  import torch
  import torch.nn.functional as F
  rows = {}
  for i, shape in enumerate(shapes):
    x, wt, _, scale, shift = conv_tiles.inputs(gen, *shape, dev)
    if chain:
      relu = i > 0
      kern = lambda: c3.conv3x3_gn_chain(x, scale, shift, wt, relu)
      plain = lambda: c3.conv3x3_gn_chain_reference(x, scale, shift, wt, relu)
    else:
      kern = lambda: c3.conv3x3_same(x, wt, None, False, torch.bfloat16)
      plain = lambda: c3.conv3x3_same_reference(x, wt, None, False,
                                                torch.bfloat16)
    xl = x.permute(2, 0, 1)[None]  # channels-last (1, C, H, W) view
    wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bound, by = conv_tiles.bound_ms(*shape, chain=chain)
    rows[shape] = {"ms": cuda_ms(kern, 30), "plain_ms": cuda_ms(plain, 10),
                   "cudnn_ms": cuda_ms(lambda: F.conv2d(xl, wl, padding=1),
                                       30),
                   "bound_ms": bound, "bound_by": by}
  return rows


def per_frame(rows, calls):
  """Sum of each column over one frame's calls (shapes repeat)."""
  tot = {k: sum(rows[c][k] for c in calls)
         for k in ("ms", "plain_ms", "cudnn_ms", "bound_ms")}
  ops = sum(rows[c]["bound_by"] == "operations" for c in calls)
  tot["bound_by"] = "operations" if 2 * ops >= len(calls) else "bytes"
  return tot


def time_calls_alone(conv_tiles, calls):
  """Each recorded conv kernel call of one served frame, on its own inputs
  and its own bias, ReLU and output type: the kernel alone (prepared
  weights, preallocated outputs; device ms from a CUDA graph) and cuDNN's
  bare conv at its shape, timed the same way. Raises unless the kernel
  alone gives the served call's bits. Returns {wrapper name: {"alone_ms",
  "cudnn_alone_ms": sums over the frame, "calls"}}."""
  import torch
  out = {}
  for name, log in calls.items():
    alone = cudnn = 0.0
    for args, kwargs, got in log:
      run, mine = conv_tiles.kernel_call(name, args, kwargs)
      run()
      pairs = zip(mine, got) if isinstance(got, tuple) else [(mine, got)]
      if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} alone differs from the served call at "
                             f"{tuple(args[0].shape)}")
      alone += conv_tiles.graph_ms(run, 20)
      a = conv_tiles.arguments(name, args, kwargs)
      cudnn += conv_tiles.cudnn_ms(a["x"], a["w"], 20)
    out[name] = {"alone_ms": alone, "cudnn_alone_ms": cudnn,
                 "calls": len(log)}
  return out


def close_to(got, want):
  """(bit-equal, largest |difference| of x and of P, within TOL_PATH) of
  two (xs, Ps) results."""
  import torch
  (gx, gP), (wx, wP) = got, want
  return {"bit_equal": bool(torch.equal(gx, wx) and torch.equal(gP, wP)),
          "x_max_abs": (gx - wx).abs().max().item(),
          "P_max_abs": (gP - wP).abs().max().item(),
          "held": bool(torch.allclose(gx, wx, rtol=TOL_PATH, atol=TOL_PATH)
                       and torch.allclose(gP, wP, rtol=TOL_PATH,
                                          atol=TOL_PATH))}


def counted(wrappers, fn):
  """``fn()``'s result and the launches of each wrapper it made (counted
  under replay), the counts set to 0 just before."""
  import torch
  for w in wrappers.values():
    w.launches = 0
  out = fn()
  torch.cuda.synchronize()
  return out, {name: w.launches for name, w in wrappers.items()}


def counted_solves(fn):
  """``fn()``'s result and the pose solve's counts it made: each pose
  kernel's launches (counted under replay, set to 0 just before) and the
  tracer's POSE_COUNTERS (the tracer on around ``fn``)."""
  import torch
  from kfnet_tpu_torch.kernels import ransac as kr
  from kfnet_tpu_torch.utils import tracing
  for stage in POSE_KERNELS:
    getattr(kr, stage).launches = 0
  tracing.enable()
  try:
    out = fn()
    torch.cuda.synchronize()
  finally:
    tracing.disable()
  counters = tracing.snapshot()["counters"]
  return out, {**{s: getattr(kr, s).launches for s in POSE_KERNELS},
               **{k: counters.get(k, 0) for k in POSE_COUNTERS}}


def one_launch_a_solve(counts, solves):
  """Whether ``counts`` (counted_solves') show ``solves`` solves, each
  one launch of every pose kernel and one ``pose.kernel_solves``."""
  return all(counts[k] == solves
             for k in POSE_KERNELS + ("pose.kernel_solves",))


def sequence_forms(sequence, params, c, frames, resume_at, chunk, wrappers,
                   dev):
  """The graphed run, the chunked stream (host uint8 frames) and the run
  resumed from a carry after frame ``resume_at - 1``, each against the
  eager loop on x and P, with each one's kernel launches."""
  import torch
  dev_frames = torch.from_numpy(frames).to(dev)
  ref = sequence.run_filter_python_loop(params, c, dev_frames)

  def chunked():
    outs = list(sequence.run_filter_chunked_arrays(params, c, list(frames),
                                                   chunk_size=chunk))
    return ((torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])),
            [o[0].shape[0] for o in outs])

  def resumed():
    xa, Pa, carry = sequence.run_filter(params, c, dev_frames[:resume_at])
    xb, Pb, _ = sequence.run_filter(params, c, dev_frames[resume_at:],
                                    carry=carry)
    return torch.cat([xa, xb]), torch.cat([Pa, Pb])

  forms = {}
  out, n = counted(wrappers, lambda: sequence.run_filter(
      params, c, dev_frames)[:2])
  forms["graphed"] = dict(close_to(out, ref), launches=n)
  (out, sizes), n = counted(wrappers, chunked)
  forms["chunked"] = dict(close_to(out, ref), launches=n, chunks=sizes)
  out, n = counted(wrappers, resumed)
  forms["resumed"] = dict(close_to(out, ref), launches=n)
  return forms, ref


def known_poses(rng, T, n, K):
  """T frames of n correspondences of known poses (camera-to-world), 0.5
  px pixel noise and 30% outliers (2 m world noise): (uv, X, var, T_wc)."""
  import numpy as np
  uvs, Xs, poses = [], [], []
  for _ in range(T):
    R_wc = rodrigues(rng.normal(size=3) * 0.3)
    t_wc = rng.normal(size=3)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.0, 5.0, n)], -1)
    X = pc @ R_wc.T + t_wc
    uv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
    uv += rng.normal(size=uv.shape) * 0.5
    out = rng.choice(n, int(0.3 * n), replace=False)
    X[out] += rng.normal(size=(len(out), 3)) * 2.0
    T_wc = np.eye(4)
    T_wc[:3, :3], T_wc[:3, 3] = R_wc, t_wc
    uvs.append(uv)
    Xs.append(X)
    poses.append(T_wc)
  return (np.stack(uvs), np.stack(Xs), rng.uniform(0.5, 2.0, (T, n)),
          np.stack(poses))


def pretrained_phase(dev, wrappers):
  """The shipped synthetic weights on the card: both loaders, sceneA's
  held-out trajectory rendered on the card (16 frames at the export's
  96x128) against the same frames rendered on the CPU, evaluate_sequence's
  medians within the JAX package's artifact gate (< 0.5 m, < 8°), the
  stage-1 + stage-2 pair filtering the same frames; fused launches counted
  (the counts set to 0 just before, read just after)."""
  import torch
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.data import synthetic
  from kfnet_tpu_torch.eval import eval_sequence
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.utils import checkpoint
  cfg, params = pretrained.load(device=dev)
  cfg12, params12 = pretrained.load_stage12(device=dev)
  meta = checkpoint.load_meta(os.path.join(pretrained.ASSETS,
                                           "stage3_sceneA"))
  h, w = int(meta["height"]), int(meta["width"])
  kw = dict(height=h, width=w, seed=0, traj_seed=99, duration=PRE_T / 48.0)
  data = synthetic.make_sequence(PRE_T, device=dev, **kw)
  host = synthetic.make_sequence(PRE_T, device="cpu", **kw)
  d_rgb = (data["images"].cpu() - host["images"]).abs().amax(-1)
  d_depth = (data["depths"].cpu() - host["depths"]).abs()
  far = int(((d_rgb > 1e-4) | (d_depth > 1e-4 * host["depths"].clamp_min(
      1.0))).sum())
  reps = 1
  res, n = counted(wrappers, lambda: eval_sequence.evaluate_sequence(
      params, cfg, data["images"], data["K"].cpu().numpy(),
      gt_poses=data["poses"].cpu().numpy(), scene="sceneA",
      ransac_config=ransac.RansacConfig(num_hypotheses=256, top_k=512),
      timing_reps=reps))
  xs12, Ps12, _ = sequence.run_filter(params12, cfg12, data["images"])
  out = {
      "config": "pretrained stage3_sceneA (small float32 nets) 96x128",
      "on_device": all(p.device.type == "cuda" for p in
                       L.tree_leaves(params) + L.tree_leaves(params12)),
      "render_pixels_off_cpu": far, "render_pixels": int(d_depth.numel()),
      "median_translation_m": res.report["median_translation_m"],
      "median_rotation_deg": res.report["median_rotation_deg"],
      "accuracy_5cm_5deg": res.report["accuracy_5cm_5deg"],
      "frames_per_sec": res.report["frames_per_sec"],
      "launches": n,
      "launches_expected": {"fused_warp_kalman": (1 + reps) * (PRE_T - 1),
                            "conv3x3_same": 0, "conv3x3_gn_chain": 0},
      "stage12_finite": bool(torch.isfinite(xs12).all()
                             and (Ps12 > 0).all()),
      "jax_package_report_for_comparison": "artifacts/pretrained_synthetic/"
                                           "REPORT.json",
  }
  return out


def known_pose_maps(rng, K, h=60, w=80, stride=8, outliers=0.3):
  """One 640x480 frame's (h, w) maps of a known pose: world coordinates of
  each cell's pixel at depths in [1, 5) m, 30% of them moved 2 m away,
  variances in [0.5, 2): (coords (h, w, 3), var (h, w, 1), T_wc)."""
  import numpy as np
  R_wc = rodrigues(np.array([0.25, -0.2, 0.15]))
  t_wc = np.array([0.4, -0.3, 0.8])
  off = (stride - 1) // 2
  v, u = np.meshgrid(np.arange(h) * stride + off, np.arange(w) * stride + off,
                     indexing="ij")
  depth = rng.uniform(1.0, 5.0, (h, w))
  pc = np.stack([(u - K[0, 2]) / K[0, 0] * depth,
                 (v - K[1, 2]) / K[1, 1] * depth, depth], -1)
  X = pc @ R_wc.T + t_wc
  out = rng.uniform(size=(h, w)) < outliers
  X[out] += rng.normal(size=(int(out.sum()), 3)) * 2.0
  T_wc = np.eye(4)
  T_wc[:3, :3], T_wc[:3, 3] = R_wc, t_wc
  return X, rng.uniform(0.5, 2.0, (h, w, 1)), T_wc


def ransac_case(dev, solver, T, seed):
  """One served shape's solve after its draws on known-pose maps: ((uv, X,
  w, K, idx, map_of), config). The DLT: T frames' 60x80 maps (30%
  outliers), their 2048 most confident cells; P3P: T x RANSAC_EXPERTS maps
  (60% outliers) of 4800 cells on one pixel grid, frame t's 256 draws over
  its own experts, as EsacRelocalizer's stack."""
  import numpy as np
  import torch
  from kfnet_tpu_torch.core import geometry
  from kfnet_tpu_torch.pose import ransac
  rng = np.random.default_rng(seed)
  K = np.array([[585.0, 0.0, 319.5], [0.0, 585.0, 239.5], [0.0, 0.0, 1.0]])
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
  grid = geometry.cell_center_grid(60, 80, 8, device=dev).reshape(-1, 2)
  gen = torch.Generator(device=dev).manual_seed(seed)
  if solver == "dlt":
    cfg = ransac.RansacConfig()
    maps = [known_pose_maps(rng, K) for _ in range(T)]
    var = f32(np.stack([m[1] for m in maps])).reshape(T, -1)
    uv, X, w = ransac.select_confident(
        grid, f32(np.stack([m[0] for m in maps])).reshape(T, -1, 3), var,
        torch.ones(var.shape, dtype=torch.bool, device=dev), cfg.top_k)
    idx = ransac.sample_hypotheses(w, cfg.num_hypotheses, cfg.draw_size, gen)
    return (uv, X, w, f32(K), idx, None), cfg
  cfg = ransac.RansacConfig(solver="p3p")
  E = T * RANSAC_EXPERTS
  X = f32(np.stack([known_pose_maps(rng, K, outliers=0.6)[0]
                    for _ in range(E)])).reshape(E, -1, 3)
  w = torch.ones(X.shape[:2], device=dev)
  experts = torch.as_tensor(
      rng.integers(0, RANSAC_EXPERTS, (T, cfg.num_hypotheses)), device=dev)
  map_of = experts + RANSAC_EXPERTS * torch.arange(T, device=dev)[:, None]
  idx = ransac.sample_hypotheses(w, cfg.num_hypotheses, cfg.draw_size, gen,
                                 map_of)
  return (grid, X, w, f32(K), idx, map_of), cfg


def ransac_phase(dev):
  """Phase "ransac" (module docstring, 7d'): {shape: fields} of each served
  shape; raises where a kernel's candidates or scores are not its plain
  version's bits, or its refined pose misses the plain one by more than
  RANSAC_TOL."""
  import torch
  from kfnet_tpu_torch.kernels import ransac as kr
  from kfnet_tpu_torch.tools import conv_tiles
  wrappers = (kr.hypothesize, kr.score, kr.pick_and_refine)
  out = {}
  for i, (name, solver, T) in enumerate(RANSAC_SHAPES):
    (uv, X, w, K, idx, map_of), cfg = ransac_case(dev, solver, T, 20 + i)
    c = kr.CANDIDATES[solver]
    thr, iters, fin = (cfg.inlier_threshold_px, cfg.refine_iters,
                       cfg.refine_threshold_px)
    uvh, Xh, wh = kr.per_hypothesis(uv, X, w, map_of)
    Rs, ts = kr.hypothesize_reference(uvh, Xh, K, idx, solver)
    inl = kr.score_reference(uvh, Xh, wh, K, Rs, ts, thr)
    want = kr.refine_reference(uv, X, w, K, Rs, ts, inl, iters, fin, map_of)
    cands, scores = kr.candidates(Rs, ts), torch.sum(inl, dim=-1)
    stages = {
        "hypothesize": (
            lambda: kr.hypothesize(uv, X, K, idx, solver, map_of),
            lambda: kr.hypothesize_reference(uvh, Xh, K, idx, solver)),
        "score": (
            lambda: kr.score(uv, X, w, K, cands, c, thr, map_of),
            lambda: kr.score_reference(uvh, Xh, wh, K, Rs, ts, thr)),
        "pick_and_refine": (
            lambda: kr.pick_and_refine(uv, X, w, K, cands, scores, c, thr,
                                       iters, fin, map_of),
            lambda: kr.refine_reference(uv, X, w, K, Rs, ts, inl, iters, fin,
                                        map_of))}

    def kernels():
      cc = kr.hypothesize(uv, X, K, idx, solver, map_of)
      ss = kr.score(uv, X, w, K, cc, c, thr, map_of)
      return kr.pick_and_refine(uv, X, w, K, cc, ss, c, thr, iters, fin,
                                map_of)

    def plain():
      R_, t_ = kr.hypothesize_reference(uvh, Xh, K, idx, solver)
      i_ = kr.score_reference(uvh, Xh, wh, K, R_, t_, thr)
      return kr.refine_reference(uv, X, w, K, R_, t_, i_, iters, fin, map_of)

    got_c = stages["hypothesize"][0]()
    got_s = stages["score"][0]()
    got = stages["pick_and_refine"][0]()
    whole = kernels()
    gap = lambda a, b: (a - b).abs().max().item()
    same = (got_c == cands) | (torch.isnan(got_c) & torch.isnan(cands))
    fields = {
        "frames": T, "solver": solver, "draws": int(idx.shape[1]),
        "points": int(X.shape[1]), "pools": int(X.shape[0]),
        "finite_share": torch.isfinite(got_c).all(-1).float().mean().item(),
        "candidates_bit_equal": same.all(-1).float().mean().item(),
        "scores_equal": bool(torch.equal(got_s, scores)),
        "T_wc_gap": gap(got["T_wc"], want["T_wc"]),
        "inliers_gap": gap(got["num_inliers"], want["num_inliers"]),
        "whole_T_wc_gap": gap(whole["T_wc"], want["T_wc"]),
        "whole_inliers_gap": gap(whole["num_inliers"], want["num_inliers"]),
        "inliers": want["num_inliers"].tolist()}
    tol = RANSAC_TOL
    if not (fields["candidates_bit_equal"] == 1.0 and fields["scores_equal"]
            and max(fields["T_wc_gap"], fields["whole_T_wc_gap"])
            < tol["T_wc"]
            and max(fields["inliers_gap"], fields["whole_inliers_gap"])
            <= tol["inliers"]):
      libraries = library_versions()
      raise AssertionError(
          f"ransac kernels off their plain versions at {name}: {fields}; "
          f"libraries {libraries}, probed under {RANSAC_PROBED}"
          + ("" if probed_libraries(libraries) else
             ": the libraries changed, so re-probe their rounding "
             "(csrc/ransac.cu) before suspecting the kernel"))
    nbytes = {  # each input byte read once, each output byte written once
        "hypothesize": idx.numel() * (8 + 5 * 4) + cands.numel() * 4,
        "score": (X.numel() + w.numel() + uv.numel() + cands.numel()
                  + scores.numel()) * 4,
        "pick_and_refine": (T * X.shape[1] * 6 + T * 12
                            + scores.numel() + T * 19) * 4}
    times = {}
    for stage, (kernel, reference) in stages.items():
      times[stage] = {
          "alone_ms": conv_tiles.graph_ms(kernel, 20),
          "ms": cuda_ms(kernel, 50),
          "plain_ms": cuda_ms(reference, 3),
          "plain_graph_ms": conv_tiles.graph_ms(reference, 1),
          "bound_ms": nbytes[stage] / HBM_BYTES_PER_MS, "bound_by": "bytes"}
    before = [f.launches for f in wrappers]
    times["solve"] = {"alone_ms": conv_tiles.graph_ms(kernels, 20),
                      "ms": cuda_ms(kernels, 50),
                      "plain_ms": cuda_ms(plain, 3),
                      "plain_graph_ms": conv_tiles.graph_ms(plain, 1),
                      "bound_ms": sum(nbytes.values()) / HBM_BYTES_PER_MS,
                      "bound_by": "bytes"}
    fields["launches_in_solve_timing"] = [
        f.launches - b for f, b in zip(wrappers, before)]
    out[name] = {**fields, "times": times}
  return out


def fleet_run(FleetRelocalizer, params, c, K, ticks, resets, dev, **kw):
  """A fleet over ``ticks`` ((T, B, H, W, 3) uint8) with ``resets`` (a mask
  or None per tick): (the fleet, its (poses, info) per tick in tick order,
  pipelined ones included, the state after each tick, cloned)."""
  fleet = FleetRelocalizer(params, c, K, batch_size=ticks.shape[1],
                           device=dev, **kw)
  outs, states = [], []
  for t in range(ticks.shape[0]):
    res = fleet.process(ticks[t], reset=resets[t])
    if not res[1].get("pending"):
      outs.append(res)
    states.append(tuple(a.clone() for a in fleet.state[:2]))
  outs += fleet.flush()
  return fleet, outs, states


def lone_states(OnlineRelocalizer, params, c, K, ticks, resets, dev):
  """Each slot's stream alone through an OnlineRelocalizer (reset where its
  slot resets): [per tick: (x (B, ...), P (B, ...))]."""
  import torch
  B = ticks.shape[1]
  lone = [OnlineRelocalizer(params, c, K, device=dev, solve_pose=False)
          for _ in range(B)]
  states = []
  for t in range(ticks.shape[0]):
    per = []
    for b in range(B):
      if resets[t] is not None and resets[t][b]:
        lone[b].reset()
      lone[b].process(ticks[t, b])
      per.append(tuple(a.clone() for a in lone[b].state[:2]))
    states.append(tuple(torch.stack([p[i] for p in per]) for i in range(2)))
  return states


def states_close(got, want):
  """Largest |difference| of x and of P, relative to the largest |value|,
  over the ticks; bit-equal; held within TOL_PATH (relative)."""
  import torch
  dx = max((g[0] - w[0]).abs().max().item() / w[0].abs().max().item()
           for g, w in zip(got, want))
  dP = max(((g[1] - w[1]).abs() / w[1].abs()).max().item()
           for g, w in zip(got, want))
  return {"bit_equal": all(torch.equal(g[i], w[i]) for g, w in zip(got, want)
                           for i in range(2)),
          "x_max_rel": dx, "P_max_rel": dP,
          "held": dx <= TOL_PATH and dP <= TOL_PATH}


def fleet_phase(dev, params, configs_, cfg32, K, fticks, resets, first, later,
                wrappers, c3):
  """The fleet of FLEET_B streams over ``fticks`` in each configuration of
  ``configs_`` ({"default": ..., "conv_kernels": ...}): launches (counts
  set to 0 just before), captures, host syncs of a tick with and without a
  reset mask, pipelined against sync, slots against lone streams (the
  default config's bf16 recorded and its float32 ``cfg32`` held; the
  conv-kernel config held, and every conv call of a tick pair against its
  plain version); then each config's sync and pipelined tick by CUDA
  events. Returns ({config: checks}, {config: times})."""
  import numpy as np
  import torch
  from kfnet_tpu_torch.eval import online
  from kfnet_tpu_torch.eval.online import FleetRelocalizer, OnlineRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.pose import ransac
  captures = []

  class CountedStep(sequence.GraphedStep):
    def __init__(self, *a, **kw):
      captures.append(1)
      super().__init__(*a, **kw)

  fleet_checks, fleets = {}, {}
  for name, c in configs_.items():
    captures.clear()
    with mock.patch.object(online, "GraphedStep", CountedStep):
      ((fl, outs, states), solves), n = counted(
          wrappers, lambda: counted_solves(lambda: fleet_run(
              FleetRelocalizer, params, c, K, fticks, resets, dev)))
      n_captures = len(captures)
      syncs = (host_syncs(fl, fticks[1], reset=resets[FLEET_RESET])
               + host_syncs(fl, fticks[2]))
      n_captures_after = len(captures)
    fleets[name] = fl
    expected = {"fused_warp_kalman": FLEET_T - 1}
    for k in ("conv3x3_same", "conv3x3_gn_chain"):
      expected[k] = (FLEET_B * (len(first[k]) + (FLEET_T - 1) * len(later[k]))
                     if name == "conv_kernels" else 0)
    _, piped, _ = fleet_run(FleetRelocalizer, params, c, K, fticks, resets,
                            dev, pipeline_depth=1)
    shifted = all(
        ps["tick"] == pp["tick"] and np.array_equal(a, b) and
        all(np.array_equal(ps[k], pp[k]) for k in
            ("consistent_frac", "num_inliers", "inlier_ratio"))
        for (a, ps), (b, pp) in zip(outs, piped))
    row = {
        "launches": n, "launches_expected": expected,
        "pose_solves": solves, "pose_solves_expected": FLEET_T,
        "captures": n_captures, "captures_after_reset_ticks":
            n_captures_after - n_captures,
        "host_syncs_in_one_tick_with_and_without_reset": syncs,
        "packed_finite": bool(all(np.isfinite(p).all() for p, _ in outs)),
        "consistent_frac_reset_tick": outs[FLEET_RESET][1][
            "consistent_frac"].tolist(),
        "pipelined_equals_sync_shifted": shifted,
        "ticks_pipelined": len(piped),
        "vs_lone_streams": states_close(states, lone_states(
            OnlineRelocalizer, params, c, K, fticks, resets, dev))}
    if name == "default":  # bf16 is recorded; float32 (same weights) is held
      _, _, states32 = fleet_run(FleetRelocalizer, params, cfg32, K, fticks,
                                 resets, dev, solve_pose=False)
      row["vs_lone_streams_float32"] = states_close(states32, lone_states(
          OnlineRelocalizer, params, cfg32, K, fticks, resets, dev))
    else:  # a kernel net runs frame by frame: every call against its plain
      calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
      eager_f = FleetRelocalizer(params, c, K, batch_size=FLEET_B,
                                 device=dev, graph=False, solve_pose=False)
      with recording(c3, calls):
        eager_f.process(fticks[0])
        eager_f.process(fticks[1])
      row["calls_in_tick_pair_vs_plain"] = check_calls(c3, calls)
      want_calls = {k: FLEET_B * (len(first[k]) + len(later[k]))
                    for k in calls}
      if {k: len(v) for k, v in calls.items()} != want_calls:
        raise AssertionError(f"fleet conv calls in the tick pair: "
                             f"{ {k: len(v) for k, v in calls.items()} }")
      del calls, eager_f
    fleet_checks[name] = row
  # times: a sync tick and a pipelined one, CUDA events over 8 ticks each
  cyc = itertools.cycle(fticks)
  fleet_times = {}
  for name, c in configs_.items():
    piped = FleetRelocalizer(params, c, K, batch_size=FLEET_B, device=dev,
                             pipeline_depth=1)
    for _ in range(3):
      piped.process(next(cyc))
    fl = fleets[name]
    step, frames_dev = fl._step, fl._step.frame.clone()
    x, P = fl.state[:2]
    fleet_times[name] = {
        "fleet_tick_ms_b4": cuda_ms(lambda: fl.process(next(cyc)), 8),
        "fleet_pipelined_tick_ms_b4": cuda_ms(lambda: piped.process(
            next(cyc)), 8),
        # the tick's parts: the filter step's replay (device time: the
        # enqueue is one graph launch) and the batched pose solve (the
        # host's pace)
        "filter_step_replay_ms": cuda_ms(lambda: step.replay(
            frames_dev, step.carry, fl._zero_mask), 8),
        "pose_solve_ms": cuda_ms(lambda: ransac.solve_pnp_from_maps(
            x, P, torch.ones_like(P, dtype=torch.bool), fl._K, fl._gen),
            5)}
    piped.flush()
  return fleet_checks, fleet_times


class StepTimer:
  """A loss function that times the training steps calling it: a CUDA
  event at the start of each call (one call a step, also under remat,
  whose recompute does not call it again) and each call's loss kept.
  ``step_ms()`` after ``stop()``: each step's ms, start to next start (the
  last to ``stop``), device time of everything the step enqueued."""

  def __init__(self, loss_fn):
    self.loss_fn, self.events, self.losses = loss_fn, [], []

  def _mark(self):
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    self.events.append(ev)

  def __call__(self, params, batch):
    self._mark()
    loss, metrics = self.loss_fn(params, batch)
    self.losses.append(loss.detach())
    return loss, metrics

  def stop(self):
    import torch
    self._mark()
    torch.cuda.synchronize()

  def step_ms(self):
    return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def tree_finite(tree):
  import torch
  from kfnet_tpu_torch.nn import layers as L
  return all(bool(torch.isfinite(p).all()) for p in L.tree_leaves(tree))


def grads_gap(got, want):
  """The largest |difference| of each grad leaf over that leaf's largest
  |value| in ``want``: the worst leaf's."""
  return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
             for g, w in zip(got, want))


def grads_within(got, want, rtol, atol, leaf=0.0):
  """Every element of every leaf within rtol·|want| + atol + leaf·(the
  leaf's largest |want|)."""
  import torch
  return all(bool(torch.all((g - w).abs() <= rtol * w.abs() + atol
                            + leaf * w.abs().max()))
             for g, w in zip(got, want))


def states_gap(a, b):
  """(bit-equal, largest |difference|) of two TrainStates' params and
  moments, and whether their counters agree."""
  import torch
  from kfnet_tpu_torch.nn import layers as L
  la = L.tree_leaves([a.params, a.opt_state.mu, a.opt_state.nu])
  lb = L.tree_leaves([b.params, b.opt_state.mu, b.opt_state.nu])
  return {"bit_equal": all(torch.equal(x, y) for x, y in zip(la, lb)),
          "max_abs": max((x - y).abs().max().item() for x, y in zip(la, lb)),
          "steps": [a.step, b.step],
          "counts": [a.opt_state.count, b.opt_state.count]}


@contextlib.contextmanager
def deterministic(on):
  """cuDNN deterministic and PyTorch's deterministic algorithms (gather's
  and repeat_interleave's backward without atomics) when ``on``; an op
  with no deterministic form warns rather than raises."""
  import torch
  was = (torch.backends.cudnn.deterministic,
         torch.are_deterministic_algorithms_enabled(),
         torch.is_deterministic_algorithms_warn_only_enabled())
  torch.backends.cudnn.deterministic = on
  torch.use_deterministic_algorithms(on, warn_only=True)
  try:
    yield
  finally:
    torch.backends.cudnn.deterministic = was[0]
    torch.use_deterministic_algorithms(was[1], warn_only=was[2])


def train_phase(dev, wrappers):
  """Phase "train": the three stages at full width (bf16, 640x480) on a
  training sequence rendered on the card, each through fit_on_device, and
  the checks of the training path (module docstring, phase 9). Returns
  (stages, checks); the caller asserts."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import configs
  from kfnet_tpu_torch.data import labels, synthetic
  from kfnet_tpu_torch.eval import eval_sequence
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import fused_filter as ff
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.tools.demo import label_maps, render_frames
  from kfnet_tpu_torch.train import device_fit, objectives, trainer
  from kfnet_tpu_torch.utils import logging as log_lib

  seq = synthetic.make_sequence(TRAIN_FRAMES, height=IMG[0], width=IMG[1],
                                seed=0, device=dev)
  K = seq["K"]
  coords, valid = label_maps(seq["depths"], seq["poses"], K)
  mean, std = labels.scene_statistics([coords.cpu().numpy()],
                                      [valid.cpu().numpy()])
  cfg = kfnet.KFNetConfig(scoordnet=configs.full_scoordnet(mean, std),
                          oflownet=configs.full_oflownet())
  pair_cfg = dataclasses.replace(cfg, use_fused_kernel=False)
  params = kfnet.init(0, cfg, IMG, device=dev)
  images = seq["images"]
  frames = {"image": images, "coords": coords, "valid": valid}
  pairs = {"image_prev": images[:-1], "image": images[1:],
           "coords_prev": coords[:-1], "valid_prev": valid[:-1],
           "coords": coords[1:], "valid": valid[1:]}
  windows = {"images": images, "coords": coords, "valid": valid}
  joint_pairs = {k: pairs[k] for k in ("image_prev", "image", "coords",
                                       "valid")}
  sc_loss = objectives.scoordnet_objective(cfg.scoordnet)
  stages = {}

  def stage(name, loss_fn, p, data, steps, batch, frames_per_row, **kw):
    timer = StepTimer(loss_fn)
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    (state, m), n = counted(wrappers, lambda: device_fit.fit_on_device(
        timer, p, data, steps, TRAIN_LR, batch=batch, chunk=TRAIN_CHUNK,
        tag=name, log=log.append, device=dev, **kw))
    timer.stop()
    ms = timer.step_ms()
    med = float(np.median(ms[1:]))
    stages[name] = {
        "steps": steps, "batch": batch, "frames_per_row": frames_per_row,
        "ms_per_step": med, "ms_steps": ms,
        "frames_per_s": batch * frames_per_row * 1e3 / med,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "losses": [x.item() for x in timer.losses],
        "grad_norm_last": m["grad_norm"].item(),
        "params_finite": tree_finite(state.params), "launches": n,
        "log": log}
    return state

  s1 = stage("stage1_scoordnet", sc_loss, params["scoordnet"], frames,
             TRAIN_STEPS, TRAIN_B, 1, seed=0)
  s2 = stage("stage2_oflownet",
             objectives.oflownet_objective(cfg.oflownet, flow_reg_weight=0.01),
             params["oflownet"], pairs, TRAIN_STEPS, TRAIN_B, 2, seed=1)
  joint = {"scoordnet": s1.params, "oflownet": s2.params}
  s3 = stage("stage3a_window",
             objectives.kfnet_window_objective(cfg, remat=True), joint,
             windows, WIN_STEPS, WIN_B, WIN_T, seed=2, window=WIN_T)
  s4 = stage("stage3b_pairs", objectives.kfnet_objective(pair_cfg),
             s3.params, joint_pairs, PAIR_STEPS, PAIR_B, 2, seed=3)
  checks = {"train_launches_expected": WIN_STEPS * (WIN_T - 1) * 2}
  checks["finite"] = all(
      np.isfinite(s["losses"]).all() and np.isfinite(s["grad_norm_last"])
      and s["params_finite"] for s in stages.values())

  # one fixed stage-1 batch, 8 steps of fit: the loss goes down
  class Rows(log_lib.MetricLogger):
    def __init__(self):
      super().__init__(stream=open(os.devnull, "w"))
      self.rows = []

    def log_metrics(self, step, metrics):
      self.rows.append(metrics["loss"])

  fixed = device_fit.gather(frames, torch.arange(TRAIN_B, device=dev))
  rows = Rows()
  trainer.fit(sc_loss, params["scoordnet"], iter([fixed] * 8),
              trainer.OptimizerConfig(learning_rate=FIXED_LR),
              trainer.TrainLoopConfig(max_steps=8, log_every=1),
              logger=rows, device=dev)
  checks["fixed_batch_losses"] = rows.rows
  checks["fixed_batch_loss_falls"] = rows.rows[-1] < rows.rows[0]

  # the window objective with the fused kernel, with the kernel's plain
  # version in its place, and with the composition (use_fused_kernel off),
  # same params and window, held with deterministic algorithms. The plain
  # version's backward is the kernel's own (autograd through it), so the
  # two are held at KERNEL_*; the composition's backward orders the same
  # float32 arithmetic otherwise, and the nets' bf16 weight grads round
  # differently: held within one bf16 step (BF16_STEP) of each leaf's
  # largest |value|. By default the backward's atomics (the warp's
  # gather) differ from run to run: recorded, with the kernel run twice.
  win = device_fit.gather(windows, torch.arange(WIN_T, device=dev)[None])
  on, off = (objectives.kfnet_window_objective(c) for c in (cfg, pair_cfg))
  kernel = {"tol": {"loss_rel": KERNEL_LOSS_RTOL,
                    "plain_grads_of_leaf_max": KERNEL_GRAD_OF_MAX,
                    "composition_grads_of_leaf_max": BF16_STEP}}
  for det in (True, False):
    with deterministic(det):
      (l_on, _, g_on), n_on = counted(
          wrappers, lambda: trainer.value_and_grad(on, s3.params, win))
      l_on2, _, g_on2 = trainer.value_and_grad(on, s3.params, win)
      with mock.patch.object(ff, "fused_filter_step",
                             ff.fused_filter_step_reference):
        l_pl, _, g_pl = trainer.value_and_grad(on, s3.params, win)
      l_off, _, g_off = trainer.value_and_grad(off, s3.params, win)
    row = {"loss_kernel": l_on.item(), "loss_plain": l_pl.item(),
           "loss_composition": l_off.item(),
           "plain_loss_rel": abs((l_on - l_pl) / l_pl).item(),
           "plain_grads_of_leaf_max": grads_gap(g_on, g_pl),
           "composition_loss_rel": abs((l_on - l_off) / l_off).item(),
           "composition_grads_of_leaf_max": grads_gap(g_on, g_off),
           "kernel_twice_loss_rel": abs((l_on2 - l_on) / l_on).item(),
           "kernel_twice_grads_of_leaf_max": grads_gap(g_on2, g_on),
           "launches": n_on["fused_warp_kalman"]}
    row["held"] = (row["plain_loss_rel"] <= KERNEL_LOSS_RTOL and
                   row["plain_grads_of_leaf_max"] <= KERNEL_GRAD_OF_MAX and
                   row["composition_loss_rel"] <= KERNEL_LOSS_RTOL and
                   row["composition_grads_of_leaf_max"] <= BF16_STEP and
                   row["launches"] == WIN_T - 1)
    kernel["deterministic" if det else "default"] = row
  checks["kernel_vs_plain_and_composition"] = kernel

  # remat against no remat at T = 3, with deterministic algorithms (held)
  # and without (recorded)
  win3 = device_fit.gather(windows, torch.arange(3, device=dev)[None])
  remat = {}
  for det in (True, False):
    with deterministic(det):
      l_r, _, g_r = trainer.value_and_grad(
          objectives.kfnet_window_objective(cfg, remat=True), s3.params, win3)
      l_n, _, g_n = trainer.value_and_grad(
          objectives.kfnet_window_objective(cfg), s3.params, win3)
    rel = abs((l_r - l_n) / l_n).item()
    remat["deterministic" if det else "default"] = {
        "loss_rel": rel, "grads_of_leaf_max": grads_gap(g_r, g_n),
        "bit_equal": bool(torch.equal(l_r, l_n)) and all(
            torch.equal(a, b) for a, b in zip(g_r, g_n)),
        "held": rel <= REMAT_LOSS_RTOL and grads_within(
            g_r, g_n, REMAT_GRAD_RTOL, REMAT_GRAD_ATOL)}
  checks["remat_vs_none_T3"] = remat

  # a checkpoint at step 3 resumed to 6 against 6 steps uninterrupted:
  # bit for bit with deterministic algorithms (cuDNN's included), the gap
  # recorded without
  rng = np.random.default_rng(4)
  batches = [device_fit.gather(frames, torch.as_tensor(
      rng.integers(0, TRAIN_FRAMES, TRAIN_B), device=dev)) for _ in range(6)]
  opt_cfg = trainer.OptimizerConfig(learning_rate=TRAIN_LR)
  quiet = log_lib.MetricLogger(stream=open(os.devnull, "w"))
  resume = {}
  for det in (True, False):
    with deterministic(det), tempfile.TemporaryDirectory() as ck:
      run = lambda bs, **loop: trainer.fit(
          sc_loss, params["scoordnet"], iter(bs), opt_cfg,
          trainer.TrainLoopConfig(log_every=1000, checkpoint_every=3,
                                  keep_checkpoints=1, **loop),
          logger=quiet, device=dev)
      whole = run(batches, max_steps=6)
      run(batches[:3], max_steps=3, checkpoint_dir=ck)
      resumed = run(batches[3:], max_steps=6, checkpoint_dir=ck)
    resume["deterministic" if det else "default"] = states_gap(resumed, whole)
  checks["resume_vs_uninterrupted"] = resume

  # float32 configs: one step's loss and grads, card against CPU; the
  # tiny configs held, the small ones recorded (their grads have a kink at
  # these weights: the CPU's own move by ~9% of a leaf's largest value
  # under a 1e-6 relative perturbation of the params, cpu_floor)
  checks["float32_card_vs_cpu"] = {
      "tiny_48x64": float32_card_vs_cpu(dev, "tiny", 48, 64),
      "small_96x128": float32_card_vs_cpu(dev, "small", 96, 128)}

  # the trained weights served: evaluate_sequence (graphed) against the
  # eager loop
  test_poses = torch.as_tensor(synthetic.orbit_trajectory(8, seed=99),
                               device=dev)
  test_imgs, _ = render_frames(synthetic.make_scene(0), test_poses, K,
                               IMG[0], IMG[1])
  res, n_eval = counted(wrappers, lambda: eval_sequence.evaluate_sequence(
      s4.params, cfg, test_imgs, K.cpu().numpy(), timing_reps=1))
  eager = sequence.run_filter_python_loop(s4.params, cfg, test_imgs)
  served = close_to((torch.from_numpy(res.coords).to(dev),
                     torch.from_numpy(res.covariance).to(dev)), eager)
  served["launches"] = n_eval["fused_warp_kalman"]
  served["launches_expected"] = 2 * (8 - 1)  # warm-up and timed run
  checks["served_graph_vs_eager"] = served
  return stages, checks


def float32_card_vs_cpu(dev, scale, h, w):
  """The float32 configs of ``configs.NET_SCALES[scale]`` at h x w (frames
  rendered on the CPU): the stage-1 objective (4 frames), the stage-2 one
  (4 pairs) and the window objective (B = 2, T = 3; the fused kernel on
  the card, its plain version on the CPU). ``within``: the loss at the
  golden tolerance and the grads within TRAIN_GRAD_RTOL plus
  TRAIN_GRAD_ATOL and TRAIN_GRAD_LEAF of the leaf's largest |value| (one
  framework on two devices
  summing in other orders). ``cpu_floor``: how far the CPU's own grads
  move (of each leaf's largest |value|, the worst leaf) when every param
  is scaled by 1 + 1e-6·N(0, 1), the size of the card's rounding
  differences."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import configs
  from kfnet_tpu_torch.data import labels, synthetic
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.tools.demo import label_maps
  from kfnet_tpu_torch.train import objectives, trainer

  seq = synthetic.make_sequence(6, height=h, width=w, seed=0, device="cpu")
  coords, valid = label_maps(seq["depths"], seq["poses"], seq["K"])
  mean, std = labels.scene_statistics([coords.numpy()], [valid.numpy()])
  sc_net, of_net = configs.NET_SCALES[scale]
  cfg = kfnet.KFNetConfig(scoordnet=sc_net(mean, std), oflownet=of_net())
  cpu_params = kfnet.init(0, cfg, (h, w, 3), device="cpu")
  card_params = L.tree_map(lambda p: p.to(dev), cpu_params)
  cases = {
      "scoordnet": (objectives.scoordnet_objective(cfg.scoordnet),
                    "scoordnet", {"image": seq["images"][:4],
                                  "coords": coords[:4], "valid": valid[:4]}),
      "oflownet": (objectives.oflownet_objective(cfg.oflownet, 0.01),
                   "oflownet", {"image_prev": seq["images"][:4],
                                "image": seq["images"][1:5],
                                "coords_prev": coords[:4],
                                "valid_prev": valid[:4],
                                "coords": coords[1:5], "valid": valid[1:5]}),
      "window_T3_B2": (objectives.kfnet_window_objective(cfg), None,
                       {"images": torch.stack([seq["images"][:3],
                                               seq["images"][3:]]),
                        "coords": torch.stack([coords[:3], coords[3:]]),
                        "valid": torch.stack([valid[:3], valid[3:]])})}
  out = {}
  for name, (loss_fn, sub, batch) in cases.items():
    pick = (lambda p: p[sub]) if sub else (lambda p: p)
    lc, _, gc = trainer.value_and_grad(loss_fn, pick(cpu_params), batch)
    lg, _, gg = trainer.value_and_grad(
        loss_fn, pick(card_params),
        {k: v.to(dev) for k, v in batch.items()})
    gg = [g.cpu() for g in gg]
    noise = torch.Generator().manual_seed(1)
    nudged = L.tree_map(lambda p: p * (1 + 1e-6 * torch.randn(
        p.shape, generator=noise)), pick(cpu_params))
    _, _, gn = trainer.value_and_grad(loss_fn, nudged, batch)
    out[name] = {"loss_card": lg.item(), "loss_cpu": lc.item(),
                 "grads_of_leaf_max": grads_gap(gg, gc),
                 "cpu_floor": grads_gap(gn, gc),
                 "within": bool(np.isclose(lg.item(), lc.item(), **GOLDEN))
                           and grads_within(gg, gc, TRAIN_GRAD_RTOL,
                                            TRAIN_GRAD_ATOL,
                                            TRAIN_GRAD_LEAF)}
  return out


def frame_pair_outputs(params, c, img0, img1):
  """One frame pair's measurement (z, V) of frame 1 and flow (flow, W)
  from frame 0 to 1 (preprocessed frames): every conv of a filter step."""
  from kfnet_tpu_torch.models import kfnet
  z, V = kfnet.measure(params, c, img1)
  flow, W = kfnet.flow_from_features(params, c, kfnet.encode(params, c, img0),
                                     kfnet.encode(params, c, img1))
  return {"z": z, "V": V, "flow": flow, "W": W}


def conv_kernel_config(cfg):
  """``cfg`` in the conv-kernel configuration: OFlowNet on the 3x3 kernel,
  SCoordNet on the chain kernel where its trunk is GroupNorm (the chain's
  prologues are GroupNorm passes) and on the 3x3 kernel otherwise."""
  sc_impl = "pallas_fused" if cfg.scoordnet.norm == "group" else "pallas_3x3"
  return dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet, conv_impl=sc_impl),
      oflownet=dataclasses.replace(cfg.oflownet, conv_impl="pallas_3x3"))


def full_stages():
  """The four full-size stages: (name, export root, scene, gate); the
  flagship (GroupNorm sceneA) first."""
  from kfnet_tpu_torch import pretrained
  return [("full_sceneA", pretrained.FULL_ASSETS, "sceneA", FULL_GATE),
          ("full_nonorm_sceneA", pretrained.FULL_NONORM_ASSETS, "sceneA",
           FULL_GATE),
          ("full_outdoor_train", pretrained.FULL_ASSETS, "outdoor_train",
           OUTDOOR_GATE["group"]),
          ("full_nonorm_outdoor_train", pretrained.FULL_NONORM_ASSETS,
           "outdoor_train", OUTDOOR_GATE["none"])]


def stage_frames(scene, h, w, dev):
  """PRE_T frames of ``scene``'s held-out trajectory at h x w, rendered
  on the card: its row of the protocol's scene table (seed, world scale),
  trajectory seed + 99, one frame in 48 of the orbit apart."""
  from kfnet_tpu_torch.data import synthetic
  from kfnet_tpu_torch.tools import protocol
  spec = {s.name: s for s in protocol.DEFAULT_SCENES}[scene]
  return synthetic.make_sequence(PRE_T, height=h, width=w, seed=spec.seed,
                                 scale=spec.scale, traj_seed=spec.seed + 99,
                                 duration=PRE_T / 48.0, device=dev)


def pretrained_full_phase(dev, wrappers):
  """Phase "pretrained_full": the four full-size stages (full_stages:
  read from the JAX package's orbax exports under artifacts/ by the
  port's own reader) each served at 640x480 through the graphed
  OnlineRelocalizer in both configurations, on its scene's held-out
  trajectory rendered on the card; for one stage of each trunk, each conv
  kernel call of one frame pair against its plain version. Returns the
  phase's fields; the caller asserts."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  from kfnet_tpu_torch.kernels import conv3x3 as c3
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.pose import metrics
  from kfnet_tpu_torch.utils import checkpoint

  repo = os.path.dirname(os.path.abspath(__file__))
  out, frames, checked = {}, {}, set()
  for name, root, scene, gate in full_stages():
    t0 = time.time()
    cfg, params = pretrained.load(root, scene=scene, device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    stage = os.path.join(root, f"stage3_{scene}")
    meta = checkpoint.load_meta(stage)
    h, w = int(meta["height"]), int(meta["width"])
    if scene not in frames:
      frames[scene] = stage_frames(scene, h, w, dev)
    data = frames[scene]
    K = data["K"].cpu().numpy()
    gt = data["poses"].cpu().numpy()
    conv_cfg = conv_kernel_config(cfg)
    r = {"weights": os.path.relpath(stage, repo), "scene": scene,
         "load_seconds": load_s, "frames": PRE_T, "frame_size": [h, w],
         "norm": cfg.scoordnet.norm, "w_scale": cfg.w_scale,
         "params": sum(p.numel() for p in L.tree_leaves(params)),
         "on_device": all(p.device.type == "cuda"
                          for p in L.tree_leaves(params)),
         "gate": gate, "jax_cpu_medians": JAX_CPU_MEDIANS[name],
         "conv_impls": [conv_cfg.scoordnet.conv_impl,
                        conv_cfg.oflownet.conv_impl],
         "configs": {}}
    for cname, c in (("default", cfg), ("conv_kernels", conv_cfg)):
      reloc = OnlineRelocalizer(params, c, K, device=dev, seed=0)
      res, n = counted(wrappers, lambda: [reloc.process(f)
                                          for f in data["images"]])
      poses = np.stack([p for p, _ in res])
      t_err, r_err = metrics.median_errors(poses, gt)
      first = kfnet.kernel_shapes(c, IMG, first=True)
      later = kfnet.kernel_shapes(c, IMG)
      expected = {"fused_warp_kalman": PRE_T - 1}
      for k in ("conv3x3_same", "conv3x3_gn_chain"):
        expected[k] = len(first[k]) + (PRE_T - 1) * len(later[k])
      r["configs"][cname] = {
          "median_translation_m": float(t_err),
          "median_rotation_deg": float(r_err),
          "finite": bool(np.isfinite(poses).all()),
          "consistent_frac_last": res[-1][1]["consistent_frac"],
          "launches": n, "launches_expected": expected}
    if cfg.scoordnet.norm not in checked:  # one stage of each trunk
      checked.add(cfg.scoordnet.norm)
      up = lambda i: kfnet.preprocess_images(cfg, data["images"][i])
      calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
      with recording(c3, calls):
        frame_pair_outputs(params, conv_cfg, up(0), up(1))
      r["calls_in_path_vs_plain"] = check_calls(c3, calls)
    out[name] = r
    del params
    torch.cuda.empty_cache()
  return out


def check_pretrained_full(full):
  """Each stage on the card with its trunk's serving point; in each
  configuration, launches as kernel_shapes counts them, finite poses and
  medians inside its gate; the held calls within their tolerances."""
  if len(full) != 4:
    raise AssertionError(f"pretrained_full: {sorted(full)}")
  for name, st in full.items():
    want = (("group", 16.0) if st["norm"] == "group" else ("none", 2.0))
    if not st["on_device"] or (st["norm"], st["w_scale"]) != want or \
        st["norm"] != ("none" if "nonorm" in name else "group"):
      raise AssertionError(f"full-size weights {name}: {st}")
    for cname, r in st["configs"].items():
      if r["launches"] != r["launches_expected"]:
        raise AssertionError(f"pretrained_full {name} {cname} launches "
                             f"{r['launches']}, expected "
                             f"{r['launches_expected']}")
      if not (r["finite"] and all(r[k] < v for k, v in st["gate"].items())):
        raise AssertionError(f"{st['scene']} not relocalized by {name} in "
                             f"the {cname} config: {r}")
    calls = st.get("calls_in_path_vs_plain")  # check_calls raised on a miss
    kinds = (("conv3x3_same", "conv3x3_gn_chain") if st["norm"] == "group"
             else ("conv3x3_same",))
    if calls is not None and not all(calls[k]["calls"] for k in kinds):
      raise AssertionError(f"pretrained_full {name} held no call of "
                           f"{kinds}: {calls}")
  if sum("calls_in_path_vs_plain" in st for st in full.values()) != 2:
    raise AssertionError("pretrained_full: calls held for one stage of each "
                         "trunk")


def with_conv_impl(cfg, impl, dtype=None):
  """``cfg`` with both nets on ``impl`` (and in ``dtype`` where given)."""
  kw = {"conv_impl": impl}
  if dtype is not None:
    kw["compute_dtype"] = dtype
  return dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet, **kw),
      oflownet=dataclasses.replace(cfg.oflownet, **kw))


def bmm_dtype_has_backward(dev) -> bool:
  """Whether this torch differentiates ``torch.bmm(..., out_dtype=)`` (the
  Winograd contraction's bf16 route; kernels/winograd.py upcasts where a
  gradient is needed either way)."""
  import torch
  a = torch.ones(2, 3, 4, device=dev, dtype=torch.bfloat16,
                 requires_grad=True)
  try:
    torch.bmm(a, a.detach().transpose(1, 2),
              out_dtype=torch.float32).sum().backward()
  except (RuntimeError, NotImplementedError):
    return False
  return a.grad is not None


def direct_conv(x, w, bias, cd):
  """The direct conv of nn/layers.conv (SAME, stride 1): cuDNN's output
  rounded to ``cd``, the bias added in float32 and rounded again."""
  import torch
  import torch.nn.functional as F
  y = F.conv2d(x.to(cd), w.to(cd), padding=1)
  if bias is not None:
    y = (y.to(torch.float32) + bias[:, None, None]).to(cd)
  return y


def winograd_phase(dev, wrappers):
  """Phase "winograd": the flagship (GroupNorm) and the norm="none"
  sceneA stage at 640x480 with conv_impl="winograd" on both nets, against
  conv_impl="xla": every Winograd conv call of one frame pair against the
  direct conv on its inputs at WINO_BF16 of its largest |y| (bf16), the
  pair's (z, V) in float32 at WINO_Z / WINO_V; one PRE_T-frame run_filter
  (its fused launches, its poses' medians); filter_fps of the two in
  WINO_TURNS alternating turns each. Returns the phase's fields; the
  caller asserts."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.eval import benchmark, eval_sequence
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import winograd
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.pose import metrics

  out = {"bmm_dtype_backward": bmm_dtype_has_backward(dev), "stages": {}}
  for name, root, scene, gate in full_stages()[:2]:
    cfg, params = pretrained.load(root, scene=scene, device=dev)
    data = stage_frames(scene, IMG[0], IMG[1], dev)
    images, K = data["images"], data["K"].cpu().numpy()
    wcfg, xcfg = with_conv_impl(cfg, "winograd"), with_conv_impl(cfg, "xla")
    up = lambda i: kfnet.preprocess_images(cfg, images[i])
    calls, conv = [], winograd.conv3x3_winograd

    def recorded(x, w, bias=None, compute_dtype=torch.bfloat16):
      y = conv(x, w, bias, compute_dtype)
      calls.append((x, w, bias, compute_dtype, y))
      return y

    with mock.patch.object(winograd, "conv3x3_winograd", recorded):
      frame_pair_outputs(params, wcfg, up(0), up(1))
    worst = 0.0
    for x, w, bias, cd, y in calls:
      ref = direct_conv(x, w, bias, cd).to(torch.float32)
      err = (y.to(torch.float32) - ref).abs().max().item()
      worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    shapes = sorted({(tuple(x.shape[-3:]), w.shape[0])
                     for x, w, *_ in calls})
    w32 = frame_pair_outputs(params, with_conv_impl(cfg, "winograd",
                                                    "float32"), up(0), up(1))
    x32 = frame_pair_outputs(params, with_conv_impl(cfg, "xla", "float32"),
                             up(0), up(1))
    gap = {k: (w32[k] - x32[k]).abs().max().item() for k in w32}
    f32_held = bool(torch.allclose(w32["z"], x32["z"], **WINO_Z)
                    and torch.allclose(w32["V"], x32["V"], **WINO_V))
    runs = {}
    for cname, c in (("winograd", wcfg), ("xla", xcfg)):
      (xs, Ps, _), n = counted(
          wrappers, lambda: sequence.run_filter(params, c, images))
      solve = eval_sequence.make_pose_solver(K)
      poses = solve(xs, Ps, torch.Generator(device=dev).manual_seed(0))
      poses = poses["T_wc"].cpu().numpy()
      t_err, r_err = metrics.median_errors(poses,
                                           data["poses"].cpu().numpy())
      runs[cname] = {"median_translation_m": t_err,
                     "median_rotation_deg": r_err,
                     "finite": bool(np.isfinite(poses).all()),
                     "launches": n}
    fps = {"winograd": [], "xla": []}
    for _ in range(WINO_TURNS):
      for cname, c in (("winograd", wcfg), ("xla", xcfg)):
        fps[cname].append(benchmark.filter_fps(c, params, images))
    out["stages"][name] = {
        "norm": cfg.scoordnet.norm, "conv_calls": len(calls),
        "conv_shapes": shapes, "bf16_worst_of_max_y": worst,
        "bf16_held": bool(calls) and worst <= WINO_BF16,
        "float32_max_abs": gap, "float32_held": f32_held,
        "run_filter": runs,
        "filter_fps": {k: {"turns": v, "median": float(np.median(v))}
                       for k, v in fps.items()}}
    del params
    torch.cuda.empty_cache()
  return out


def check_winograd(wg):
  for name, st in wg["stages"].items():
    if not (st["bf16_held"] and st["float32_held"]):
      raise AssertionError(f"winograd {name} off the direct conv: {st}")
    for cname, r in st["run_filter"].items():
      if r["launches"]["fused_warp_kalman"] != PRE_T - 1 or not r["finite"]:
        raise AssertionError(f"winograd {name} {cname} run_filter: {r}")


class CliTimer:
  """Times a train script's ``steps`` steps on the card without touching
  it: while active, the objective ``factory`` of ``objectives`` gives its
  loss functions wrapped in a StepTimer (an event as each step starts, its
  loss kept) and stamps the host clock as each is called; ``Adam.update``
  marks an event and stamps the host clock as each step's update is
  enqueued. Steps 2 to ``steps`` run under a torch.profiler trace of the
  card's kernels, copies and fills (started after step 1's update with
  the card drained, stopped after the last update and a drain).

  ``step_ms()``: step 1 from its start to its update, each later step from
  the update before it to its own (the whole cycle: data, forward,
  backward, update). ``profile()``: over steps 2 to ``steps``, the card's
  busy ms a step (union of the traced spans), its idle share of the
  event-timed cycle, kernels a step, and the host's median ms from an
  update to the next step's loss call (next batch, its copy up) and from
  that call to the step's update (enqueueing forward, backward and
  update)."""

  def __init__(self, objectives, trainer, factory, steps):
    self.step, self.steps, self.updates = None, steps, []
    self.host_calls, self.host_updates = [], []
    self._prof = None
    make, update = getattr(objectives, factory), trainer.Adam.update

    def timed_factory(*args, **kwargs):
      self.step = StepTimer(make(*args, **kwargs))

      def loss_fn(params, batch):
        self.host_calls.append(time.perf_counter())
        return self.step(params, batch)
      return loss_fn

    def timed_update(adam, *args, **kwargs):
      import torch
      from torch.profiler import ProfilerActivity, profile
      update(adam, *args, **kwargs)
      if not self.updates:
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      self.updates.append(ev)
      self.host_updates.append(time.perf_counter())
      if len(self.updates) == self.steps:
        torch.cuda.synchronize()
        self._prof.stop()

    self._patches = [mock.patch.object(objectives, factory, timed_factory),
                     mock.patch.object(trainer.Adam, "update", timed_update)]

  def __enter__(self):
    for p in self._patches:
      p.start()
    return self

  def __exit__(self, *exc):
    for p in reversed(self._patches):
      p.stop()

  def step_ms(self):
    import torch
    torch.cuda.synchronize()
    ends = self.updates
    if not ends:
      return []
    return [self.step.events[0].elapsed_time(ends[0])] + [
        a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

  def profile(self):
    import numpy as np
    from kfnet_tpu_torch.tools import profile_online
    ms = self.step_ms()[1:]
    n = len(ms)
    if n < 1 or len(self.updates) != self.steps:
      return None
    kernels = profile_online.profiled_kernels(self._prof, copies=True)
    busy = (profile_online.summarize(kernels, sum(ms), n)["device_busy_ms"]
            if kernels else 0.0)
    return {
        "steps": n,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy * n / sum(ms),
        "kernels_per_step": len(kernels) / n,
        "host_ms_update_to_next_step": 1e3 * float(np.median(
            [c - u for u, c in zip(self.host_updates[:-1],
                                   self.host_calls[1:])])),
        "host_ms_step_to_update": 1e3 * float(np.median(
            [u - c for c, u in zip(self.host_calls[1:],
                                   self.host_updates[1:])]))}


def data_phase(dev, wrappers):
  """Phase "data": the on-disk data path and the three train scripts on
  the card (module docstring, phase 11). Returns the phase's fields; the
  caller asserts."""
  import glob

  import numpy as np
  import torch
  from kfnet_tpu_torch.data import fixture, image_io, labels, native_io
  from kfnet_tpu_torch.data import pipeline
  from kfnet_tpu_torch.data import seven_scenes as s7
  from kfnet_tpu_torch.train import objectives, trainer
  from kfnet_tpu_torch.train import train_kfnet, train_oflownet
  from kfnet_tpu_torch.train import train_scoordnet
  from kfnet_tpu_torch.utils import checkpoint
  from kfnet_tpu_torch.utils import config as config_lib

  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "data")
    t0 = time.time()
    native_io.load_library()
    out["host_library_build_s"] = time.time() - t0
    t0 = time.time()
    fixture.write_seven_scenes_fixture(root, train_frames=DATA_TRAIN,
                                       test_frames=DATA_TEST, height=IMG[0],
                                       width=IMG[1], device=dev)
    fixture.write_cambridge_fixture(root, train_frames=DATA_TRAIN,
                                    test_frames=DATA_TEST, device=dev)
    out["fixture_write_s"] = time.time() - t0
    files = sorted(glob.glob(os.path.join(root, "**", "*.png"),
                             recursive=True))
    t_cpp = t_np = 0.0
    unequal = []
    for path in files:
      with open(path, "rb") as f:
        raw = f.read()
      t = time.perf_counter()
      a = image_io.decode_png(raw)
      t_cpp += time.perf_counter() - t
      t = time.perf_counter()
      b = image_io.decode_png_plain(raw)
      t_np += time.perf_counter() - t
      if a.dtype != b.dtype or not np.array_equal(a, b):
        unequal.append(os.path.relpath(path, root))
    out["decode"] = {"files": len(files), "unequal": unequal,
                     "cpp_ms_per_file": 1e3 * t_cpp / len(files),
                     "numpy_ms_per_file": 1e3 * t_np / len(files)}

    exp = config_lib.ExperimentConfig(input_folder=root, device=str(dev))
    split = s7.load_split(root, "chess", "train")
    K = split.intrinsics
    label_err = 0.0
    valid_equal = True
    for fr in split.frames:
      T = s7.read_pose(fr.pose_path)
      c, v = native_io.depth_png_to_labels(fr.depth_path, K, T)
      rc, rv = labels.generate(
          torch.from_numpy(s7.read_depth(fr.depth_path)).to(dev),
          torch.from_numpy(K).to(dev), torch.from_numpy(T).to(dev))
      rc, rv = rc.cpu().numpy(), rv.cpu().numpy()
      valid_equal &= bool(np.array_equal(v, rv))
      label_err = max(label_err, float(
          (np.abs(c - rc) / (DATA_LABEL_TOL + DATA_LABEL_TOL * np.abs(rc)))
          .max()))
    out["labels_vs_generate"] = {"frames": len(split.frames),
                                 "valid_equal": valid_equal,
                                 "max_err_over_tol": label_err,
                                 "rtol_atol": DATA_LABEL_TOL}

    load_fns, _, native_meta = train_scoordnet.make_scene_loader(exp)
    meta = native_meta()
    first = lambda it: (next(it), it.close())[0]
    b_py = first(pipeline.batched(load_fns, DATA_B, seed=0,
                                  to_device=False))
    b_nat = first(pipeline.batched_native(batch_size=DATA_B, seed=0,
                                          to_device=False, **meta))
    out["native_vs_python_batch"] = {
        "keys_equal": sorted(b_py) == sorted(b_nat),
        "image_equal": bool(np.array_equal(b_py["image"], b_nat["image"])),
        "valid_equal": bool(np.array_equal(b_py["valid"], b_nat["valid"])),
        "coords_max_abs": float(np.abs(b_py["coords"]
                                       - b_nat["coords"]).max()),
        "coords_max_err_over_tol": float(
            (np.abs(b_nat["coords"] - b_py["coords"])
             / (DATA_LABEL_TOL + DATA_LABEL_TOL * np.abs(b_py["coords"])))
            .max())}
    rates = {}
    for route, make in (
        ("batched_native", lambda: pipeline.batched_native(
            batch_size=DATA_B, seed=0, epochs=DATA_EPOCHS, to_device=False,
            **meta)),
        ("batched", lambda: pipeline.batched(
            load_fns, DATA_B, seed=0, epochs=DATA_EPOCHS, to_device=False))):
      t = time.perf_counter()
      n = sum(b["image"].shape[0] for b in make())
      rates[route] = {"frames": n,
                      "frames_per_s": n / (time.perf_counter() - t)}
    out["loader"] = rates

    models = os.path.join(tmp, "models")
    common = ["--input_folder", root, "--scene", "chess", "--model_folder",
              models, "--net_scale", CLI_NET_SCALE, "--device", str(dev),
              "--batch_size", str(CLI_B)]
    runs = {
        "train_scoordnet": (train_scoordnet, "scoordnet_objective",
                            "scoordnet_chess", CLI_STEPS["train_scoordnet"],
                            common),
        "train_oflownet": (train_oflownet, "oflownet_objective",
                           "oflownet_7scenes", CLI_STEPS["train_oflownet"],
                           common + ["--scenes", "chess"]),
        "train_kfnet": (train_kfnet, "kfnet_window_objective", "kfnet_chess",
                        CLI_STEPS["train_kfnet"],
                        common + ["--window_size", str(CLI_T), "--remat",
                                  "--scoordnet_ckpt",
                                  os.path.join(models, "scoordnet_chess"),
                                  "--oflownet_ckpt",
                                  os.path.join(models, "oflownet_7scenes")]),
    }
    clis = {}
    for name, (module, factory, sub, steps, argv) in runs.items():
      torch.cuda.reset_peak_memory_stats()
      t = time.time()
      with CliTimer(objectives, trainer, factory, steps) as timer:
        state, n = counted(wrappers, lambda: module.main(
            argv + ["--max_steps", str(steps)]))
      ms = timer.step_ms()
      prof = timer.profile()
      out_dir = os.path.join(models, sub)
      export = os.path.join(out_dir, "export")
      emeta = checkpoint.load_meta(export) or {}
      clis[name] = {
          "seconds": time.time() - t, "steps": state.step,
          "steps_expected": steps, "optimizer_count": state.opt_state.count,
          "losses": [float(x) for x in timer.step.losses],
          "step_ms": ms,
          "ms_per_step": float(np.median(ms[1:])) if len(ms) > 1 else None,
          "profile": prof,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "params_finite": tree_finite(state.params),
          "files": {
              "metrics_jsonl": os.path.exists(os.path.join(out_dir,
                                                           "metrics.jsonl")),
              "checkpoint_step": checkpoint.Checkpointer(
                  out_dir).latest_step(),
              "export_params": checkpoint.has_params(export),
              "export_meta": sorted(emeta)},
          "launches": n}
    clis["train_kfnet"]["launches_expected"] = {
        "fused_warp_kalman": CLI_STEPS["train_kfnet"] * 2 * (CLI_T - 1),
        "conv3x3_same": 0, "conv3x3_gn_chain": 0}
    out["clis"] = clis
    out["twelve_scenes"] = jpeg_fixture_checks(dev, tmp, models)
  return out


def jpeg_fixture_checks(dev, tmp, models):
  """Phase "data"'s 12-Scenes part: the fixture written by the port's JPEG
  encoder at the full frame size, one 4:2:0 file beside it, both JPEG
  decoders on every file, the loaded colour against the render, and
  train_scoordnet --dataset 12scenes at full width. Returns its fields."""
  import glob

  import numpy as np
  import torch
  from kfnet_tpu_torch.data import fixture, image_io
  from kfnet_tpu_torch.data import twelve_scenes as s12
  from kfnet_tpu_torch.train import objectives, trainer, train_scoordnet

  out = {}
  root = os.path.join(tmp, "data12")
  t0 = time.time()
  gt = fixture.write_twelve_scenes_fixture(
      root, train_frames=S12_TRAIN, test_frames=S12_TEST, height=IMG[0],
      width=IMG[1], device=dev)["apt1/kitchen"]
  first = np.clip(gt["seq-01"]["images"][0] * 255.0 + 0.5, 0,
                  255).astype(np.uint8)
  image_io.write_jpeg(os.path.join(root, "frame-420.jpg"), first,
                      quality=95, subsampling="4:2:0")
  out["fixture_write_s"] = time.time() - t0
  files = sorted(glob.glob(os.path.join(root, "**", "*.jpg"),
                           recursive=True))
  t_cpp = t_np = 0.0
  unequal = []
  for path in files:
    with open(path, "rb") as f:
      raw = f.read()
    t = time.perf_counter()
    a = image_io.decode_jpeg(raw)
    t_cpp += time.perf_counter() - t
    t = time.perf_counter()
    b = image_io.decode_jpeg_plain(raw)
    t_np += time.perf_counter() - t
    if a.dtype != b.dtype or not np.array_equal(a, b):
      unequal.append(os.path.relpath(path, root))
  out["decode"] = {"files": len(files), "unequal": unequal,
                   "subsampled_420": "frame-420.jpg",
                   "cpp_ms_per_file": 1e3 * t_cpp / len(files),
                   "numpy_ms_per_file": 1e3 * t_np / len(files)}
  errs = []
  for split, seq in (("train", "seq-01"), ("test", "seq-02")):
    frames = s12.load_split(root, "apt1/kitchen", split).frames
    for i, fr in enumerate(frames):
      errs.append(np.abs(s12.load_frame(fr)["image"]
                         - gt[seq]["images"][i]))
  errs = np.stack(errs)
  out["loaded_vs_render"] = {"frames": len(errs),
                             "mean": float(errs.mean()),
                             "max": float(errs.max()),
                             "bound": {"mean": JPEG_MEAN, "max": JPEG_MAX}}
  argv = ["--input_folder", root, "--dataset", "12scenes", "--scene",
          "apt1/kitchen", "--model_folder", models, "--net_scale",
          CLI_NET_SCALE, "--device", str(dev), "--batch_size", str(CLI_B),
          "--max_steps", str(S12_STEPS)]
  t = time.time()
  with CliTimer(objectives, trainer, "scoordnet_objective",
                S12_STEPS) as timer:
    state = train_scoordnet.main(argv)
  torch.cuda.synchronize()
  out["train_scoordnet_12scenes"] = {
      "seconds": time.time() - t, "steps": state.step,
      "losses": [float(x) for x in timer.step.losses],
      "params_finite": tree_finite(state.params)}
  return out


def eval_phase(dev, wrappers):
  """Phase "eval" (module docstring, phase 12): the acceptance runner on a
  7-Scenes fixture at full width, its cached re-run, the eval CLI on the
  committed flagship in batch, streaming and uint8 streaming, and the
  offline pose tool on its dump. Returns the phase's fields; the caller
  asserts."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.data import fixture
  from kfnet_tpu_torch.data import seven_scenes as s7
  from kfnet_tpu_torch.eval import eval_sequence
  from kfnet_tpu_torch.eval import main as eval_main
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.tools import acceptance, eval_poses
  from kfnet_tpu_torch.train import trainer
  from kfnet_tpu_torch.utils import checkpoint

  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "data")
    t0 = time.time()
    fixture.write_seven_scenes_fixture(root, train_frames=EVAL_TRAIN,
                                       test_frames=EVAL_TEST, height=IMG[0],
                                       width=IMG[1], device=dev)
    out["fixture_write_s"] = time.time() - t0
    work = os.path.join(tmp, "work")
    argv = ["--dataset", "7scenes", "--root", root, "--scenes", "chess",
            "--work_dir", work, "--net_scale", CLI_NET_SCALE,
            "--batch_size", str(EVAL_B), "--device", str(dev)]
    for k, v in EVAL_STEPS.items():
      argv += [f"--{k}", str(v)]
    runs = {}
    for name, extra in (("first", []), ("rerun", ["--pose_smooth_beta",
                                                  "0.4"])):
      evals, updates = [], []
      main_fn, update_fn = eval_main.main, trainer.Adam.update

      def eval_counted(a, main_fn=main_fn, evals=evals):
        before = {k: w.launches for k, w in wrappers.items()}
        t = time.time()
        reps = main_fn(a)
        torch.cuda.synchronize()
        evals.append({
            "mode": ("measurement_only" if "--measurement_only" in a
                     else "filtered"),
            "seconds": time.time() - t,
            "frames_per_sec": [r["frames_per_sec"] for r in reps],
            "launches": {k: w.launches - before[k]
                         for k, w in wrappers.items()}})
        return reps

      def update_counted(adam, *a, update_fn=update_fn, updates=updates,
                         **kw):
        updates.append(1)
        return update_fn(adam, *a, **kw)

      t = time.time()
      with mock.patch.object(acceptance.eval_main, "main", eval_counted), \
          mock.patch.object(trainer.Adam, "update", update_counted):
        res, n = counted(wrappers, lambda: acceptance.main(argv + extra))
      runs[name] = {
          "seconds": time.time() - t, "optimizer_steps": len(updates),
          "launches": n, "evals": evals,
          "medians": {mode: {k: r[k] for k in ("median_translation_m",
                                               "median_rotation_deg")}
                      for mode, r in res["scenes"]["chess"].items()},
          "exports": {stage: checkpoint.has_params(
              os.path.join(work, stage, "export"))
                      for stage in ("scoordnet_chess", "oflownet_7scenes",
                                    "kfnet_chess")}}
    out["acceptance"] = runs
    out["filtered_launches_expected"] = {
        "fused_warp_kalman": (EVAL_TEST - 1) * (1 + EVAL_TIMING_REPS),
        "conv3x3_same": 0, "conv3x3_gn_chain": 0}
    out["optimizer_steps_expected"] = sum(EVAL_STEPS.values())

    # the eval CLI on the committed flagship, three ways
    flagship = os.path.join(pretrained.FULL_ASSETS, "stage3_sceneA")
    base = ["--input_folder", root, "--scene", "chess", "--net_scale",
            FLAGSHIP_NET_SCALE, "--device", str(dev), "--kfnet_ckpt",
            flagship]
    forms = {"batch": [], "streaming": ["--streaming"],
             "uint8_streaming": ["--streaming", "--uint8_stream"]}
    cli, dumps = {}, {}
    for name, extra in forms.items():
      dumps[name] = os.path.join(tmp, f"dump_{name}")
      t = time.time()
      reps, n = counted(wrappers, lambda: eval_main.main(
          base + extra + ["--dump_dir", dumps[name]]))
      rep = reps[0]
      cli[name] = {"seconds": time.time() - t, "launches": n,
                   "frames": rep["frames"],
                   "frames_per_sec": rep["frames_per_sec"],
                   "median_translation_m": rep["median_translation_m"],
                   "median_rotation_deg": rep["median_rotation_deg"],
                   "median_coord_err_m": rep.get("median_coord_err_m")}
    out["flagship_cli"] = cli
    out["flagship_launches_expected"] = {
        "batch": (EVAL_TEST - 1) * (1 + EVAL_TIMING_REPS),
        "streaming": EVAL_TEST - 1, "uint8_streaming": EVAL_TEST - 1}
    seq = "seq-02"  # the fixture's test sequence
    maps = {k: eval_poses.load_dump_sequence(os.path.join(d, seq))
            for k, d in dumps.items()}

    def maps_close(a, b):
      ta = {k: torch.from_numpy(a[k]) for k in ("coords", "covariance")}
      tb = {k: torch.from_numpy(b[k]) for k in ("coords", "covariance")}
      return {
          "bit_equal": all(torch.equal(ta[k], tb[k]) for k in ta),
          "coords_max_abs": (ta["coords"] - tb["coords"]).abs().max().item(),
          "covariance_max_abs": (ta["covariance"]
                                 - tb["covariance"]).abs().max().item(),
          "held": all(torch.allclose(ta[k], tb[k], rtol=TOL_PATH,
                                     atol=TOL_PATH) for k in ta)}

    def poses_close(a, b):
      ta, tb = torch.from_numpy(a), torch.from_numpy(b)
      return {"bit_equal": bool(torch.equal(ta, tb)),
              "max_abs": (ta - tb).abs().max().item(),
              "held": bool(torch.allclose(ta, tb, rtol=POSE_RTOL,
                                          atol=POSE_ATOL))}

    out["streaming_vs_batch"] = maps_close(maps["streaming"], maps["batch"])
    # the device ingest multiplies uint8 by 1/255 (the JAX package's
    # arithmetic), the loaders divide: an ulp apart at the input for some
    # values, so bit-equality is recorded and TOL_PATH held
    out["uint8_vs_float_streaming"] = maps_close(maps["uint8_streaming"],
                                                 maps["streaming"])
    cfg, params = pretrained.load(pretrained.FULL_ASSETS, device=dev)
    split = s7.load_split(root, "chess", "test")
    frames = np.stack([s7.load_frame(f)["image"] for f in split.frames])
    ref = eval_sequence.evaluate_sequence(
        params, cfg, frames, split.intrinsics, timing_reps=1,
        ransac_config=ransac.RansacConfig(), device=dev)
    out["cli_vs_evaluate_sequence"] = {
        "maps": maps_close(maps["batch"], {"coords": ref.coords,
                                           "covariance": ref.covariance}),
        "poses": poses_close(maps["batch"]["pose"], ref.poses)}
    batch = cli["batch"]
    out["flagship_gate"] = {
        "gate": FULL_GATE,
        "medians": {k: batch[k] for k in FULL_GATE},
        "passed": all(batch[k] < v for k, v in FULL_GATE.items())}
    t = time.time()
    offline = eval_poses.main(["--dump_dir", dumps["batch"], "--device",
                               str(dev)])[0]
    resolved = eval_poses.solve_sequence(
        maps["batch"]["coords"], maps["batch"]["covariance"],
        split.intrinsics, 8, ransac.RansacConfig(), seed=0, device=dev)
    out["eval_poses"] = {
        "seconds": time.time() - t,
        "poses_vs_eval_main": poses_close(resolved, maps["batch"]["pose"]),
        "medians_equal": all(offline[k] == batch[k] for k in FULL_GATE)}
  return out


def mesh_of_cards(torch):
  """Phase "mesh"'s mesh: one card named MESH_ENTRIES times where one GPU
  is visible (the counterpart of XLA's forced host device count: the
  entries share the card), else the visible GPUs that divide MESH_B.
  Returns (mesh, its description)."""
  from kfnet_tpu_torch.parallel import mesh as mesh_lib
  n = torch.cuda.device_count()
  if n == 1:
    mesh = mesh_lib.Mesh([torch.device("cuda", 0)] * MESH_ENTRIES)
  else:
    mesh = mesh_lib.default_mesh(MESH_B)
  distinct = len(set(mesh.devices)) == mesh.size
  return mesh, {"visible_gpus": n, "entries": [str(d) for d in mesh.devices],
                "distinct_devices": distinct,
                "name": (f"{mesh.size} entries over {n} distinct GPUs"
                         if distinct else f"{mesh.size} entries sharing "
                         f"cuda:0 (one card named {mesh.size} times)")}


def mesh_fleet(sequence, params, c, frames, mesh, wrappers, dev):
  """run_filter_fleet over the mesh, with its launches; each entry's
  streams against the same streams alone on that entry's device, and the
  whole against the one-device batch (close_to each)."""
  import torch
  (xs, Ps), n = counted(wrappers, lambda: sequence.run_filter_fleet(
      params, c, frames, mesh))
  b = frames.shape[1] // mesh.size
  alone = []
  for i, d in enumerate(mesh.devices):
    ref = sequence.run_filter_batched(params, c, frames[:, i * b:(i + 1) * b],
                                      device=d)
    alone.append(close_to((xs.shards[i], Ps.shards[i]), ref))
  one = sequence.run_filter_batched(params, c, frames, device=dev)
  whole = tuple(t.full(dev) for t in (xs, Ps))
  return {"launches": n,
          "entries_vs_alone": {
              "bit_equal": all(a["bit_equal"] for a in alone),
              "x_max_abs": max(a["x_max_abs"] for a in alone),
              "P_max_abs": max(a["P_max_abs"] for a in alone),
              "held": all(a["held"] for a in alone)},
          "vs_one_device_b4": close_to(whole, one),
          "finite": bool(torch.isfinite(whole[0]).all()
                         and torch.isfinite(whole[1]).all())}


def mesh_relocalizer(FleetRelocalizer, params, c, K, ticks, resets, mesh,
                     dev, wrappers, depth, gt=None):
  """FleetRelocalizer over the mesh against the one-device fleet on the
  same ticks: poses and x per tick (bit-equality, the largest difference
  of each over the largest |value|, and the median over the poses of
  each pose's), the mesh's launches, its host waits a tick and its syncs
  while a tick is enqueued; with ``gt`` ((T, B, 4, 4) poses), both
  fleets' median errors. The caller holds them."""
  import numpy as np
  import torch
  from kfnet_tpu_torch.pose import metrics
  waits = []
  sync = torch.cuda.Event.synchronize

  def counting(ev):
    waits.append(1)
    return sync(ev)

  one_out, one_x = [], []
  one = FleetRelocalizer(params, c, K, batch_size=ticks.shape[1], device=dev)
  for t in range(ticks.shape[0]):
    res = one.process(ticks[t], reset=resets[t])
    one_out.append(res)
    one_x.append(one.state[0].clone())

  def run():
    fl = FleetRelocalizer(params, c, K, batch_size=ticks.shape[1], mesh=mesh,
                          pipeline_depth=depth)
    outs, xs, per_tick = [], [], []
    for t in range(ticks.shape[0]):
      waits.clear()
      with mock.patch.object(torch.cuda.Event, "synchronize", counting):
        res = fl.process(ticks[t], reset=resets[t])
      per_tick.append(len(waits))
      if not res[1].get("pending"):
        outs.append(res)
      xs.append(fl.state[0].full(dev))
    outs += fl.flush()
    return fl, outs, xs, per_tick

  (fl, outs, xs, per_tick), n = counted(wrappers, run)
  poses = [(o[0], w[0]) for o, w in zip(outs, one_out)]
  dpose = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in poses)
  each = [float(np.abs(p - q).max() / np.abs(q).max())
          for a, b in poses for p, q in zip(a, b)]
  dx = max((a - b).abs().max().item() / b.abs().max().item()
           for a, b in zip(xs, one_x))
  syncs = host_syncs(fl, ticks[1], reset=resets[FLEET_RESET])
  out = {"pipeline_depth": depth, "launches": n,
         "ticks": len(outs), "host_waits_per_tick": per_tick,
         "host_syncs_while_enqueued": syncs,
         "poses_bit_equal": all(np.array_equal(a, b) for a, b in poses),
         "x_bit_equal": all(torch.equal(a, b) for a, b in zip(xs, one_x)),
         "pose_max_rel": dpose, "pose_median_rel": float(np.median(each)),
         "poses_over_tol_path": sum(e > TOL_PATH for e in each),
         "poses": len(each), "x_max_rel": dx,
         "finite": bool(all(np.isfinite(o[0]).all() for o in outs))}
  if gt is not None:
    gt = np.asarray(gt).reshape(-1, 4, 4)
    for name, res in (("mesh", [o[0] for o in outs]),
                      ("one_device", [w[0] for w in one_out])):
      t, r = metrics.median_errors(np.concatenate(res), gt)
      out[f"{name}_median_translation_m"] = t
      out[f"{name}_median_rotation_deg"] = r
  return out


def mesh_phase(dev, wrappers, params, cfg, conv_cfg, cfg32, K):
  """Phase 14 "mesh" (module docstring). Returns (checks, times, launches
  by path); the caller asserts."""
  import numpy as np
  import torch
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.data import synthetic
  from kfnet_tpu_torch.eval.online import FleetRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import conv3x3 as c3
  from kfnet_tpu_torch.kernels.cost_volume import cost_volume
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.parallel import mesh as mesh_lib, spatial
  from kfnet_tpu_torch.tools.demo import label_maps
  from kfnet_tpu_torch.train import objectives, trainer
  from kfnet_tpu_torch.utils import logging as log_lib

  mesh, about = mesh_of_cards(torch)
  print(json.dumps({"mesh": about}), flush=True)
  checks, times, launches = {"mesh": about}, {}, {}
  rng = np.random.default_rng(11)
  frames = rng.integers(0, 256, (MESH_T, MESH_B) + IMG, dtype=np.uint8)
  first = kfnet.kernel_shapes(conv_cfg, IMG, first=True)
  later = kfnet.kernel_shapes(conv_cfg, IMG)

  # the fleet split over the entries, both configurations
  for name, c in (("default", cfg), ("conv_kernels", conv_cfg)):
    row = mesh_fleet(sequence, params, c, frames, mesh, wrappers, dev)
    row["launches_expected"] = {"fused_warp_kalman": mesh.size
                                * (MESH_T - 1)}
    for k in ("conv3x3_same", "conv3x3_gn_chain"):
      row["launches_expected"][k] = (
          MESH_B * (len(first[k]) + (MESH_T - 1) * len(later[k]))
          if name == "conv_kernels" else 0)
    checks[f"fleet_{name}"] = row
    launches[f"mesh_fleet_{name}"] = row["launches"]

  # FleetRelocalizer over the mesh against the one-device fleet: float32
  # at both depths on the shipped full-size weights and sceneA's renders
  # (trained maps: RANSAC's winner is not near a tie, so the poses are
  # held), and the conv-kernel config on the random weights (its nets run
  # frame by frame, so its maps, and then its poses, are the one device's)
  full_cfg, full_params = pretrained.load(pretrained.FULL_ASSETS, device=dev)
  full32 = dataclasses.replace(
      full_cfg, scoordnet=dataclasses.replace(full_cfg.scoordnet,
                                              compute_dtype="float32"),
      oflownet=dataclasses.replace(full_cfg.oflownet,
                                   compute_dtype="float32"))
  # stream b: frames [b FLEET_T, (b + 1) FLEET_T) of sceneA's held-out
  # trajectory, so that a slot served another's frames is off
  scene = synthetic.make_sequence(FLEET_T * MESH_B, height=IMG[0],
                                  width=IMG[1], seed=0, traj_seed=99,
                                  duration=FLEET_T * MESH_B / 48.0,
                                  device=dev)
  scene_ticks = scene["images"].reshape((MESH_B, FLEET_T) + IMG).transpose(
      0, 1)
  scene_gt = scene["poses"].reshape(MESH_B, FLEET_T, 4, 4).transpose(
      0, 1).cpu().numpy()
  scene_K = scene["K"].cpu().numpy()
  ticks = frames[:FLEET_T]
  resets = [None] * FLEET_T
  resets[FLEET_RESET] = np.arange(MESH_B) == 2
  for name, p, c, k, tk, gt, depth in (
      ("float32_sceneA", full_params, full32, scene_K, scene_ticks, scene_gt,
       0),
      ("float32_sceneA", full_params, full32, scene_K, scene_ticks, scene_gt,
       1),
      ("conv_kernels", params, conv_cfg, K, ticks, None, 0)):
    row = mesh_relocalizer(FleetRelocalizer, p, c, k, tk, resets, mesh, dev,
                           wrappers, depth, gt)
    row["launches_expected"] = {"fused_warp_kalman": mesh.size
                                * (FLEET_T - 1)}
    for kn in ("conv3x3_same", "conv3x3_gn_chain"):
      row["launches_expected"][kn] = (
          MESH_B * (len(first[kn]) + (FLEET_T - 1) * len(later[kn]))
          if name == "conv_kernels" else 0)
    checks[f"relocalizer_{name}_depth{depth}"] = row
  checks["relocalizer_float32_sceneA_depth0"]["weights"] = (
      "artifacts/pretrained_full/stage3_sceneA")
  launches["mesh_relocalizer"] = checks[
      "relocalizer_float32_sceneA_depth0"]["launches"]

  # data parallelism: stage 1 one step, float32 (held) and bf16 (recorded)
  seq = synthetic.make_sequence(MESH_TRAIN_B, height=IMG[0], width=IMG[1],
                                seed=0, device=dev)
  coords, valid = label_maps(seq["depths"], seq["poses"], seq["K"])
  batch = {"image": seq["images"], "coords": coords, "valid": valid}
  one_step = trainer.TrainLoopConfig(max_steps=1, log_every=1)

  class Rows(log_lib.MetricLogger):
    def __init__(self):
      super().__init__(stream=open(os.devnull, "w"))
      self.rows = []

    def log_metrics(self, step, metrics):
      self.rows.append(metrics)

  def dp_vs_one(c):
    """One step on one device and over the mesh: the loss, the gradient
    the optimizer is given (recorded: a leaf whose sums cancel differs by
    a larger share of its largest value) and the params after the update
    (held within DP_PARAMS_ATOL where the gradient is not within noise of
    zero, above DP_NEAR_ZERO of its leaf's largest |value|: Adam's first
    update is lr·g/(|g|+eps), so where the rounding flips g's sign the
    param moves by up to 2 lr whichever way the batch is summed)."""
    loss_fn = objectives.scoordnet_objective(c.scoordnet)
    update = trainer.Adam.update
    out = []
    for kw in ({"device": dev}, {"mesh": mesh}):
      rows, fed = Rows(), []

      def recording(self, grads, state, p, fed=fed):
        fed.append([g.clone() for g in grads])
        return update(self, grads, state, p)

      with mock.patch.object(trainer.Adam, "update", recording):
        state = trainer.fit(loss_fn, params["scoordnet"], iter([batch]),
                            loop_cfg=one_step, logger=rows, **kw)
      out.append((rows.rows[0], fed[0], L.tree_leaves(state.params)))
    (m0, g0, p0), (m1, g1, p1) = out
    away = [g.abs() > DP_NEAR_ZERO * g.abs().max() for g in g0]
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(g1, g0)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    dp = max((a - b).abs().max().item() for a, b in zip(p0, p1))
    dp_away = max(((a - b).abs() * m).max().item()
                  for a, b, m in zip(p0, p1, away))
    return {"loss": [m0["loss"], m1["loss"]],
            "loss_rel": abs(m1["loss"] - m0["loss"]) / abs(m0["loss"]),
            "grad_norm": [m0["grad_norm"], m1["grad_norm"]],
            "grad_norm_rel": (abs(m1["grad_norm"] - m0["grad_norm"])
                              / abs(m0["grad_norm"])),
            "grads_within": grads_within(g1, g0, TRAIN_GRAD_RTOL,
                                         TRAIN_GRAD_ATOL, TRAIN_GRAD_LEAF),
            "grads_max_rel_of_leaf_max": max(rel),
            "grads_worst_leaf": {"index": worst,
                                 "shape": list(g0[worst].shape),
                                 "max_abs": g0[worst].abs().max().item()},
            "params_max_abs": dp, "params_max_abs_grad_away_from_0": dp_away,
            "params_over_1e-5": sum(int(((a - b).abs() > 1e-5).sum())
                                    for a, b in zip(p0, p1)),
            "params": sum(a.numel() for a in p0),
            "params_finite": all(bool(torch.isfinite(b).all()) for b in p1)}

  checks["dp_stage1_float32"] = dp_vs_one(cfg32)
  checks["dp_stage1_bf16_recorded"] = dp_vs_one(cfg)

  # the stage-3 window objective over the mesh: the fused kernel on every
  # entry, 2 (T - 1) launches an entry a step (the forward and remat's)
  win = {"images": torch.stack([seq["images"][i:i + MESH_WIN_T]
                                for i in range(MESH_WIN_B)]),
         "coords": torch.stack([coords[i:i + MESH_WIN_T]
                                for i in range(MESH_WIN_B)]),
         "valid": torch.stack([valid[i:i + MESH_WIN_T]
                               for i in range(MESH_WIN_B)])}
  win_loss = objectives.kfnet_window_objective(cfg32, remat=True)
  rows = Rows()
  state, n = counted(wrappers, lambda: trainer.fit(
      win_loss, params, iter([win] * MESH_WIN_STEPS),
      loop_cfg=trainer.TrainLoopConfig(max_steps=MESH_WIN_STEPS,
                                       log_every=1), mesh=mesh, logger=rows))
  one_rows = Rows()
  trainer.fit(win_loss, params, iter([win]), loop_cfg=one_step,
              logger=one_rows, device=dev)
  checks["dp_window"] = {
      "T": MESH_WIN_T, "batch": MESH_WIN_B, "steps": state.step,
      "launches": n, "launches_expected": {
          "fused_warp_kalman": MESH_WIN_STEPS * mesh.size
          * 2 * (MESH_WIN_T - 1), "conv3x3_same": 0, "conv3x3_gn_chain": 0},
      "losses": [r["loss"] for r in rows.rows],
      "first_loss_one_device": one_rows.rows[0]["loss"],
      "first_loss_rel": (abs(rows.rows[0]["loss"] - one_rows.rows[0]["loss"])
                         / abs(one_rows.rows[0]["loss"])),
      "grad_norm": [rows.rows[0]["grad_norm"],
                    one_rows.rows[0]["grad_norm"]],
      "grad_norm_rel": (abs(rows.rows[0]["grad_norm"]
                            - one_rows.rows[0]["grad_norm"])
                        / abs(one_rows.rows[0]["grad_norm"])),
      "finite": bool(np.isfinite([r["loss"] for r in rows.rows]).all()
                     and all(bool(torch.isfinite(p).all())
                             for p in L.tree_leaves(state.params)))}
  launches["mesh_train_window"] = n

  # width sharding: the cost volume, then the whole filter
  g = torch.Generator(device=dev).manual_seed(5)
  fp, fc = (torch.randn((60, 80, 128), generator=g, device=dev)
            for _ in range(2))
  cv = spatial.cost_volume_spatial(fp, fc, 4, mesh)
  checks["cost_volume_spatial"] = {
      "shard_widths": [s.shape[1] for s in cv.shards],
      "max_abs": (cv.full(dev) - cost_volume(fp, fc, 4)).abs().max().item()}
  stream = frames[:, 0]
  spatial_rows = {}
  spatial_expected = {"fused_warp_kalman": 0}
  for kn, per in (("conv3x3_same", mesh.size), ("conv3x3_gn_chain", 1)):
    # conv3x3_same on each shard's halo'd block; the chain on the map
    # gathered on the first entry
    spatial_expected[kn] = per * (len(first[kn])
                                  + (MESH_T - 1) * len(later[kn]))
  for name, c in (("float32", cfg32), ("bf16_recorded", cfg),
                  ("conv_kernels_float32", conv_kernel_config(cfg32))):
    (xs, Ps), n = counted(wrappers, lambda: spatial.run_filter_spatial(
        params, c, stream, mesh))
    ref = sequence.run_filter(params, dataclasses.replace(
        c, use_fused_kernel=False), stream, device=dev)[:2]
    gx, gP = xs.full(dev), Ps.full(dev)
    dx = (gx - ref[0]).abs()
    spatial_rows[name] = {
        "launches": n, "shard_widths": [s.shape[2] for s in xs.shards],
        "x": deviation(gx, ref[0], False), "P": deviation(gP, ref[1], True),
        "x_median_abs": dx.median().item(),
        "bit_equal": bool(torch.equal(gx, ref[0])
                          and torch.equal(gP, ref[1])),
        "held": bool(torch.allclose(gx, ref[0], **GOLDEN)
                     and torch.allclose(gP, ref[1], **GOLDEN)),
        "finite": bool(torch.isfinite(gx).all() and torch.isfinite(gP).all())}
    if name.startswith("conv"):
      spatial_rows[name]["launches_expected"] = spatial_expected
      # every conv kernel call of a frame pair on its own inputs (the
      # halo'd blocks' shapes) against its plain version
      calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
      with recording(c3, calls):
        spatial.run_filter_spatial(params, c, stream[:2], mesh)
      spatial_rows[name]["calls_in_path_vs_plain"] = check_calls(c3, calls)
      spatial_rows[name]["call_shapes"] = {
          k: sorted({tuple(a[0].shape) for a, _, _ in v})
          for k, v in calls.items()}
  checks["spatial_filter"] = spatial_rows
  launches["mesh_spatial"] = spatial_rows["float32"]["launches"]
  launches["mesh_spatial_conv_kernels"] = spatial_rows[
      "conv_kernels_float32"]["launches"]

  # times over the mesh (and on one device beside them where the entries
  # are distinct GPUs)
  cyc = itertools.cycle(frames[:FLEET_T])
  fleet = FleetRelocalizer(params, cfg, K, batch_size=MESH_B, mesh=mesh)
  times["fleet_tick_ms"] = cuda_ms(lambda: fleet.process(next(cyc)), 8)
  loss_fn = objectives.scoordnet_objective(cfg.scoordnet)
  opt = trainer.make_optimizer(trainer.OptimizerConfig())
  st = trainer.create_state(trainer.clone_params(params["scoordnet"], dev),
                            opt)
  reps = [st.params] + mesh_lib.replicate_tree(
      mesh_lib.Mesh(mesh.devices[1:]), st.params)
  dp_step = trainer.make_dp_train_step(loss_fn, opt, mesh, reps)
  sharded = mesh_lib.shard_batch(mesh, batch)
  parts = [mesh_lib.entry_batch(sharded, i) for i in range(mesh.size)]
  times["train_step_ms_stage1_b8"] = cuda_ms(lambda: dp_step(st, parts), 3)
  times["spatial_frame_ms"] = cuda_ms(lambda: spatial.run_filter_spatial(
      params, cfg, stream, mesh), 2) / MESH_T
  if about["distinct_devices"]:
    one = FleetRelocalizer(params, cfg, K, batch_size=MESH_B, device=dev)
    one_step_fn = trainer.make_train_step(loss_fn, opt)
    one_batch = trainer.to_device(batch, dev)
    times["one_device"] = {
        "fleet_tick_ms": cuda_ms(lambda: one.process(next(cyc)), 8),
        "train_step_ms_stage1_b8": cuda_ms(lambda: one_step_fn(
            st, one_batch), 3),
        "filter_frame_ms_composition": cuda_ms(lambda: sequence.run_filter(
            params, dataclasses.replace(cfg, use_fused_kernel=False),
            stream, device=dev), 2) / MESH_T}
  return checks, times, launches


def check_mesh(mesh_checks, mesh_times):
  """Phase "mesh"'s checks: raises on the first that fails."""
  import numpy as np
  for name in ("fleet_default", "fleet_conv_kernels"):
    row = mesh_checks[name]
    if row["launches"] != row["launches_expected"] or not row["finite"]:
      raise AssertionError(f"mesh {name}: {row}")
    if not row["entries_vs_alone"]["held"]:
      raise AssertionError(f"mesh {name}: entries off their streams alone: "
                           f"{row['entries_vs_alone']}")
  if not mesh_checks["fleet_conv_kernels"]["vs_one_device_b4"]["held"]:
    raise AssertionError(f"mesh fleet (conv kernels) off the one-device "
                         f"fleet: {mesh_checks['fleet_conv_kernels']}")
  for name in ("float32_sceneA_depth0", "float32_sceneA_depth1",
               "conv_kernels_depth0"):
    row = mesh_checks[f"relocalizer_{name}"]
    depth = row["pipeline_depth"]
    # float32: cuDNN sums a slot of one otherwise than a batch of four
    # (x within 1e-5), and where RANSAC's best hypotheses tie on inliers
    # that picks another winner for a pose now and then (the same draws:
    # one solve of the gathered maps): the median pose is held at
    # TOL_PATH, the largest recorded, and both fleets' medians against
    # the ground truth under FULL_GATE; the conv-kernel maps are the one
    # device's bits, so every pose is held
    poses_held = (row["pose_median_rel"] <= TOL_PATH
                  and all(row[f"{f}_{k}"] < v for f in ("mesh", "one_device")
                          for k, v in FULL_GATE.items())
                  if "sceneA" in name else row["pose_max_rel"] <= TOL_PATH)
    if not (row["x_max_rel"] <= TOL_PATH and poses_held
            and row["finite"] and row["ticks"] == FLEET_T
            and row["launches"] == row["launches_expected"]
            and all(w <= 1 for w in row["host_waits_per_tick"])
            and sum(row["host_waits_per_tick"]) == FLEET_T - depth
            and not row["host_syncs_while_enqueued"]):
      raise AssertionError(f"mesh relocalizer {name}: {row}")
  dp = mesh_checks["dp_stage1_float32"]
  if not (dp["loss_rel"] <= DP_LOSS_RTOL
          and dp["grad_norm_rel"] <= DP_LOSS_RTOL
          and dp["params_max_abs_grad_away_from_0"] <= DP_PARAMS_ATOL
          and dp["params_finite"]):
    raise AssertionError(f"the data-parallel step off one device: {dp}")
  dw = mesh_checks["dp_window"]
  if not (dw["launches"] == dw["launches_expected"] and dw["finite"]
          and dw["steps"] == MESH_WIN_STEPS
          and dw["first_loss_rel"] <= DP_LOSS_RTOL
          and dw["grad_norm_rel"] <= DP_LOSS_RTOL):
    raise AssertionError(f"the window objective over the mesh: {dw}")
  cvs = mesh_checks["cost_volume_spatial"]
  if cvs["max_abs"] > CV_ATOL:
    raise AssertionError(f"cost_volume_spatial: {cvs}")
  sp = mesh_checks["spatial_filter"]["float32"]
  if not sp["held"] or any(sp["launches"].values()):
    raise AssertionError(f"run_filter_spatial off run_filter: {sp}")
  sk = mesh_checks["spatial_filter"]["conv_kernels_float32"]
  # each kernel call is held against its plain version on its own inputs
  # (check_calls raises); the whole run is recorded against one device:
  # the kernels take bf16 operands, and a float32 conv between them that
  # sums a halo'd block in another order flips a rounding now and then
  if not (sk["launches"] == sk["launches_expected"] and sk["finite"]):
    raise AssertionError(f"run_filter_spatial (conv kernels): {sk}")
  if not all(np.isfinite(v) for k, v in mesh_times.items()
             if k != "one_device"):
    raise AssertionError(f"mesh times: {mesh_times}")


def soak_phase(dev, wrappers):
  """Phase "soak" (module docstring, phase 13): tools/soak.run_soak on the
  flagship over SOAK_FRAMES frames of sceneA rendered on the card at its
  export's size, chunk SOAK_CHUNK. Returns the phase's fields."""
  from kfnet_tpu_torch import pretrained
  from kfnet_tpu_torch.tools import protocol, soak
  from kfnet_tpu_torch.utils import checkpoint

  cfg, params = pretrained.load(pretrained.FULL_ASSETS, device=dev)
  meta = checkpoint.load_meta(os.path.join(pretrained.FULL_ASSETS,
                                           "stage3_sceneA"))
  spec = next(s for s in protocol.DEFAULT_SCENES if s.name == "sceneA")
  report, n = counted(wrappers, lambda: soak.run_soak(
      params, cfg, SOAK_FRAMES, int(meta["height"]), int(meta["width"]),
      chunk=SOAK_CHUNK, seed=spec.seed, scale=spec.scale, log=None))
  return {"report": report, "problems": soak.healthy(report),
          "launches": n,
          "launches_expected": {"fused_warp_kalman": SOAK_FRAMES - 1,
                                "conv3x3_same": 0, "conv3x3_gn_chain": 0}}


def finite_fields(tree):
  """True where every number in ``tree`` (dicts, lists; bools and strings
  skipped) is finite and no value is None."""
  if isinstance(tree, dict):
    return all(finite_fields(v) for v in tree.values())
  if isinstance(tree, (list, tuple)):
    return all(finite_fields(v) for v in tree)
  if isinstance(tree, (bool, str)):
    return True
  if tree is None:
    return False
  import math
  return math.isfinite(float(tree))


def study_phase(dev, wrappers):
  """Phase "study" (module docstring, phase 15): the study tools at full
  width. Returns (the phase's fields, the launches of its paths by name);
  the caller asserts."""
  import shutil
  import numpy as np
  import torch
  from kfnet_tpu_torch import configs, pretrained
  from kfnet_tpu_torch.data import fixture, image_io
  from kfnet_tpu_torch.eval import main as eval_main
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import conv3x3 as c3
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.tools import (cache_manifest, calibrate, conv_study,
                                     diagnose, generate_labels, norm_study,
                                     prepare_cache, profile_filter,
                                     profile_tick, protocol, visualize)
  from kfnet_tpu_torch.train import trainer

  out, launches = {}, {}
  scenes = tuple(s for s in protocol.DEFAULT_SCENES
                 if s.name in ("sceneA", "heldout"))
  stages = dict(H=IMG[0], W=IMG[1], train_frames=STUDY_TRAIN,
                test_frames=STUDY_TEST, sc_steps=STUDY_STEPS,
                of_steps=STUDY_STEPS, joint_steps=STUDY_STEPS, lr=TRAIN_LR,
                full_size=True, log=None, device=dev)
  updates = []
  update_fn = trainer.Adam.update

  def update_counted(adam, *a, **kw):
    updates.append(1)
    return update_fn(adam, *a, **kw)

  with tempfile.TemporaryDirectory() as tmp, \
      mock.patch.object(trainer.Adam, "update", update_counted):
    gn = os.path.join(tmp, "gn")

    # the protocol: train, evaluate, re-run strictly from the cache
    t = time.time()

    def first_run():
      res = protocol.prepare_stages(scenes=scenes, work_dir=gn, **stages)
      return res, protocol.evaluate_scenes(*res, scenes=scenes,
                                           full_size=True, log=None)

    (res, rows), launches["study_protocol"] = counted(wrappers, first_run)
    steps_first = len(updates)
    strict = protocol.prepare_stages(scenes=scenes, work_dir=gn,
                                     strict_cache=True, **stages)
    cfg, params = strict[3]["sceneA"]
    d = strict[0]["sceneA"]
    imgs = d["test"]["images"]
    xa, Pa, _ = sequence.run_filter(res[3]["sceneA"][1], cfg, imgs)
    xb, Pb, _ = sequence.run_filter(params, cfg, imgs)
    out["protocol"] = {
        "seconds": time.time() - t, "rows": rows,
        "rows_finite": all(finite_fields(r) for r in rows),
        "optimizer_steps": steps_first,
        "optimizer_steps_expected": 4 * STUDY_STEPS,
        "strict_rerun_optimizer_steps": len(updates) - steps_first,
        "strict_rerun_params_bit_equal": all(
            torch.equal(a, b) for name in ("sceneA", "heldout")
            for a, b in zip(L.tree_leaves(res[3][name][1]),
                            L.tree_leaves(strict[3][name][1]))),
        "strict_rerun_maps_bit_equal": bool(torch.equal(xa, xb)
                                            and torch.equal(Pa, Pb)),
        "launches": launches["study_protocol"],
        "launches_expected": {
            "fused_warp_kalman": len(scenes) * (1 + EVAL_TIMING_REPS)
                                 * (STUDY_TEST - 1),
            "conv3x3_same": 0, "conv3x3_gn_chain": 0}}

    # the calibration sweep, and the series recursion against the kernel
    t = time.time()
    K = d["train"]["K"].cpu().numpy()
    gt = d["test"]["poses"].cpu().numpy()
    rcfg = configs.synthetic_ransac(True)
    sweep, meas = calibrate.sweep_scene(params, cfg, imgs, K, gt,
                                        [2.37, 7.81], [1.0, 8.0], rcfg)
    cfg32 = dataclasses.replace(
        cfg, scoordnet=dataclasses.replace(cfg.scoordnet,
                                           compute_dtype="float32"),
        oflownet=dataclasses.replace(cfg.oflownet, compute_dtype="float32"))

    def series_vs_kernel(c):
      c1 = dataclasses.replace(c, w_scale=1.0)
      series = calibrate.precompute_series(params, c1, imgs)
      got = calibrate.filter_from_series(c1, series, c.chi2_threshold,
                                         c.w_scale)
      (wx, wP, _), n = counted(wrappers, lambda: sequence.run_filter(
          params, c, imgs))
      res_ = close_to(got, (wx, wP))
      res_.update(launches=n, x_scale=wx.abs().max().item(),
                  P_max_rel=((got[1] - wP).abs() / wP.abs()).max().item())
      res_["x_max_rel"] = res_["x_max_abs"] / res_["x_scale"]
      return res_

    turns = {"fused": [], "composition": []}
    plain = dataclasses.replace(cfg, use_fused_kernel=False)
    for _ in range(STUDY_TURNS):
      for name, c in (("fused", cfg), ("composition", plain)):
        ms = cuda_ms(lambda c=c: sequence.run_filter(params, c, imgs), 1)
        turns[name].append(ms)
    out["calibrate"] = {
        "seconds": time.time() - t, "points": len(sweep),
        "points_finite": all(finite_fields(r) for r in sweep)
                         and finite_fields(meas),
        "measurement_only": meas,
        "config": {"chi2_threshold": cfg.chi2_threshold,
                   "w_scale": cfg.w_scale,
                   "use_fused_kernel": cfg.use_fused_kernel,
                   "adaptive_alpha_max": cfg.adaptive_alpha_max},
        "series_vs_kernel_float32": series_vs_kernel(cfg32),
        "series_vs_kernel_bf16": series_vs_kernel(cfg),
        "launches_expected": STUDY_TEST - 1,
        "run_filter_ms": turns,
        "run_filter_ms_median": {k: float(np.median(v))
                                 for k, v in turns.items()},
        "frames": STUDY_TEST}

    # the diagnosis of the held-out scene
    t = time.time()
    diag = diagnose.main([
        "--work_dir", gn, "--full_size", "--scene", "heldout",
        "--train_frames", str(STUDY_TRAIN), "--test_frames", str(STUDY_TEST),
        "--modes", "measurement_only,cf_derigid,filtered_serving",
        "--device", str(dev)])
    out["diagnose"] = {
        "seconds": time.time() - t,
        "modes": [r["mode"] for r in diag["modes"]],
        "finite": finite_fields(diag["modes"])
                  and finite_fields(diag["scene_geometry"]),
        "rows": diag["modes"], "scene_geometry": diag["scene_geometry"]}

    # the conv study, each cell's launches counted
    t = time.time()
    cells = []
    real_fps = conv_study.benchmark.filter_fps

    def fps_counted(c, p, images, **kw):
      r, n = counted(wrappers, lambda: real_fps(c, p, images, **kw))
      cells.append((c.scoordnet.conv_impl, n))
      return r

    with mock.patch.object(conv_study.benchmark, "filter_fps", fps_counted):
      cs = conv_study.main([
          "--frames", str(STUDY_CONV_T), "--height", str(IMG[0]), "--width",
          str(IMG[1]), "--norms", "group", "--impls",
          "xla,pallas_3x3,pallas_fused", "--device", str(dev)])
    per_cell = {}
    for (impl, n), row in zip(cells, cs["rows"]):
      c = conv_study.cell_config("group", impl, True)
      first = kfnet.kernel_shapes(c, IMG, first=True)
      later = kfnet.kernel_shapes(c, IMG)
      want = {k: FILTER_FPS_RUNS * (len(first[k]) + (STUDY_CONV_T - 1)
                                    * len(later[k]))
              for k in ("conv3x3_same", "conv3x3_gn_chain")}
      want["fused_warp_kalman"] = FILTER_FPS_RUNS * (STUDY_CONV_T - 1)
      per_cell[impl] = {"launches": n, "launches_expected": want,
                        "fps": row["fps"], "mfu": row["mfu"]}
    launches["study_conv_study"] = {
        k: sum(v["launches"][k] for v in per_cell.values()) for k in wrappers}
    # every conv kernel call of one frame pair of each kernel cell (its
    # seed-0 weights, its first two frames) against its plain version, and
    # the calls' shapes against kernel_shapes' (OFlowNet stays on xla in
    # both cells, so a pair's calls are one later frame's)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (STUDY_CONV_T,) + IMG).astype(np.float32)[:2]).to(dev)
    pair_calls = {}
    for impl in ("pallas_3x3", "pallas_fused"):
      c = conv_study.cell_config("group", impl, True)
      cparams = kfnet.init(0, c, IMG, device=dev)
      pre = kfnet.preprocess_images(c, frames)
      calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
      with recording(c3, calls):
        frame_pair_outputs(cparams, c, pre[0], pre[1])
      later = kfnet.kernel_shapes(c, IMG)
      pair_calls[impl] = {
          "vs_plain": check_calls(c3, calls),
          "shapes": {k: [call_shape(k, a, kw)
                         for a, kw, _ in log] for k, log in calls.items()},
          "shapes_expected": {k: [tuple(s) for s in later[k]]
                              for k in calls}}
      del cparams
    out["conv_study"] = {"seconds": time.time() - t, "cells": per_cell,
                         "frames": STUDY_CONV_T,
                         "frame_pair_calls": pair_calls}

    # the norm study over the group cache and a norm="none" cache
    t = time.time()
    nonorm = os.path.join(tmp, "none")
    prepare_cache.copy_stage2(gn, nonorm, log=lambda *a: None)
    before = len(updates)
    protocol.prepare_stages(scenes=scenes[:1], work_dir=nonorm,
                            scoordnet_norm="none",
                            **dict(stages, test_frames=4))
    none_steps = len(updates) - before
    with mock.patch.object(norm_study, "STAGES",
                           dict(norm_study.STAGES, train_frames=STUDY_TRAIN)):
      ns = norm_study.main(["--gn_dir", gn, "--nonorm_dir", nonorm,
                            "--test_frames", str(STUDY_TEST),
                            "--bench_frames", str(STUDY_CONV_T),
                            "--device", str(dev)])
    out["norm_study"] = {
        "seconds": time.time() - t, "none_cache_optimizer_steps": none_steps,
        "none_cache_optimizer_steps_expected": 2 * STUDY_STEPS,
        "perf": ns["perf"], "group_report": ns["group_report"],
        "none_report": ns["none_report"],
        "finite": finite_fields(ns["perf"]) and finite_fields(
            [ns["group_report"], ns["none_report"], ns["paired"]])}

    # the two profilers
    t = time.time()
    pf, launches["study_profile_filter"] = counted(
        wrappers, lambda: profile_filter.main([
            "--frames", str(STUDY_PROFILE_T), "--trace_dir",
            os.path.join(tmp, "trace"), "--device", str(dev)]))
    out["profile_filter"] = {
        "seconds": time.time() - t,
        **{k: pf[k] for k in ("wall_ms_per_run",
                              "device_busy_ms_per_run", "idle_fraction",
                              "conv_class_share", "conv_class_ms_per_run",
                              "other_ms_per_run", "own_kernels_per_run",
                              "n_ops")},
        "top_ops": pf["ops"][:5],
        "fused_kernels_per_run_expected": STUDY_PROFILE_T - 1,
        "launches": launches["study_profile_filter"],
        "launches_expected": {
            "fused_warp_kalman": (1 + profile_filter.RUNS)
                                 * (STUDY_PROFILE_T - 1),
            "conv3x3_same": 0, "conv3x3_gn_chain": 0}}
    t = time.time()
    pt, launches["study_profile_tick"] = counted(
        wrappers, lambda: profile_tick.main(["--device", str(dev)]))
    out["profile_tick"] = {
        "seconds": time.time() - t, "report": pt,
        "launches": launches["study_profile_tick"],
        "launches_expected": {"fused_warp_kalman": 2 * PT_FLEET_TICKS,
                              "conv3x3_same": 0, "conv3x3_gn_chain": 0}}

    # the host tools: manifest, labels, visualisation
    t = time.time()
    manifest = cache_manifest.build_manifest(gn)
    clean = cache_manifest.verify_manifest(gn, manifest)
    flipped = os.path.join(tmp, "flipped")
    shutil.copytree(gn, flipped)
    victim = os.path.join(flipped, "stage2_indoor", "params.npz")
    with open(victim, "r+b") as f:
      data = bytearray(f.read())
      data[len(data) // 2] ^= 0xFF
      f.seek(0)
      f.write(bytes(data))
    tampered = cache_manifest.verify_manifest(flipped, manifest)
    root = os.path.join(tmp, "data")
    fixture.write_seven_scenes_fixture(root, train_frames=STUDY_FIX_TRAIN,
                                       test_frames=STUDY_FIX_TEST,
                                       height=IMG[0], width=IMG[1],
                                       device=dev)
    lab = {}
    for split in ("train", "test"):
      lab[split] = generate_labels.main([
          "--input_folder", root, "--output_folder",
          os.path.join(tmp, f"labels_{split}"), "--scene", "chess",
          "--split", split, "--device", str(dev)])
    dump, viz = os.path.join(tmp, "dump"), os.path.join(tmp, "viz")
    eval_main.main(["--input_folder", root, "--scene", "chess",
                    "--net_scale", FLAGSHIP_NET_SCALE, "--device", str(dev),
                    "--kfnet_ckpt", os.path.join(pretrained.FULL_ASSETS,
                                                 "stage3_sceneA"),
                    "--dump_dir", dump])
    visualize.main(["--dump_dir", os.path.join(dump, "seq-02"),
                    "--out_dir", viz, "--gt_labels",
                    os.path.join(tmp, "labels_test", "seq-02")])
    pngs = sorted(os.listdir(viz))
    out["host_tools"] = {
        "seconds": time.time() - t, "manifest_stages": sorted(
            manifest["stages"]),
        "manifest_clean_problems": clean, "manifest_flipped_problems":
            tampered,
        "labels": lab, "pngs": len(pngs),
        "pngs_expected": 3 * STUDY_FIX_TEST,
        "png_shape": list(image_io.read_png(os.path.join(viz, pngs[0])).shape)
                     if pngs else None}
  return out, launches


def check_study(st):
  """Raise on any hold of phase "study" that failed."""
  p = st["protocol"]
  if not p["rows_finite"] or len(p["rows"]) != 2:
    raise AssertionError(f"study protocol rows: {p['rows']}")
  if p["optimizer_steps"] != p["optimizer_steps_expected"] or \
      p["strict_rerun_optimizer_steps"]:
    raise AssertionError(f"study protocol steps {p['optimizer_steps']} then "
                         f"{p['strict_rerun_optimizer_steps']}")
  if not (p["strict_rerun_params_bit_equal"]
          and p["strict_rerun_maps_bit_equal"]):
    raise AssertionError("study: the strict re-run differs from the first")
  if p["launches"] != p["launches_expected"]:
    raise AssertionError(f"study protocol launches {p['launches']}, "
                         f"expected {p['launches_expected']}")
  c = st["calibrate"]
  if c["points"] != 4 or not c["points_finite"]:
    raise AssertionError(f"study calibrate sweep: {c['points']} points")
  s32 = c["series_vs_kernel_float32"]
  if not s32["held"]:
    raise AssertionError(f"filter_from_series off the fused kernel's "
                         f"run_filter in float32: {s32}")
  for k in ("series_vs_kernel_float32", "series_vs_kernel_bf16"):
    if c[k]["launches"]["fused_warp_kalman"] != c["launches_expected"]:
      raise AssertionError(f"{k} launches {c[k]['launches']}")
  dg = st["diagnose"]
  if not dg["finite"] or dg["modes"][:1] != ["measurement_only"] or \
      len(dg["modes"]) != 4:
    raise AssertionError(f"study diagnose: {dg['modes']}, finite "
                         f"{dg['finite']}")
  for impl, cell in st["conv_study"]["cells"].items():
    if cell["launches"] != cell["launches_expected"] or not (
        cell["fps"] > 0 and cell["mfu"] is not None):
      raise AssertionError(f"conv_study cell {impl}: {cell}")
  if sorted(st["conv_study"]["cells"]) != ["pallas_3x3", "pallas_fused",
                                           "xla"]:
    raise AssertionError(f"conv_study cells {st['conv_study']['cells']}")
  for impl, pair in st["conv_study"]["frame_pair_calls"].items():
    if pair["shapes"] != pair["shapes_expected"] or not any(
        pair["shapes"].values()):
      raise AssertionError(f"conv_study {impl}: a frame pair's conv calls "
                           f"{pair['shapes']}, kernel_shapes "
                           f"{pair['shapes_expected']}")
  ns = st["norm_study"]
  if not ns["finite"] or ns["none_cache_optimizer_steps"] != \
      ns["none_cache_optimizer_steps_expected"]:
    raise AssertionError(f"study norm_study: {ns}")
  pf = st["profile_filter"]
  if pf["own_kernels_per_run"]["fused_filter_kernel"] != \
      pf["fused_kernels_per_run_expected"] or \
      pf["launches"] != pf["launches_expected"] or \
      not 0.0 <= pf["idle_fraction"] < 1.0:
    raise AssertionError(f"study profile_filter: {pf}")
  pt = st["profile_tick"]
  if pt["launches"] != pt["launches_expected"] or not finite_fields(
      {k: pt["report"][k] for k in ("compute_ms", "roundtrip_floor_ms",
                                    "tick_ms", "dispatch_residual_ms")}):
    raise AssertionError(f"study profile_tick: {pt}")
  h = st["host_tools"]
  if h["manifest_clean_problems"] or len(h["manifest_flipped_problems"]) != 1 \
      or "stage2_indoor" not in h["manifest_flipped_problems"][0]:
    raise AssertionError(f"study cache_manifest: {h}")
  if h["labels"]["train"]["frames"] != STUDY_FIX_TRAIN or \
      h["pngs"] != h["pngs_expected"] or h["png_shape"] != [IMG[0], IMG[1],
                                                             3]:
    raise AssertionError(f"study labels / visualize: {h}")


def median_call_ms(fn, n):
  """Median ms of n calls of ``fn``, each between two CUDA events, after
  one warm-up: for an eager step the events also span the device's waits
  on the host's enqueue."""
  import numpy as np
  import torch
  fn()
  times = []
  for _ in range(n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def outputs_gap(got, want, tol):
  """(largest |difference| of each of x1, P1 and flow, all within rtol =
  atol = tol) of two entry() steps' outputs."""
  import torch
  gap = {k: (g - w).abs().max().item()
         for k, g, w in zip(("x1", "P1", "flow"), got, want)}
  return {**gap, "bit_equal": all(torch.equal(g, w)
                                  for g, w in zip(got, want)),
          "held": all(torch.allclose(g, w, rtol=tol, atol=tol)
                      for g, w in zip(got, want))}


def graft_entry_phase(dev, wrappers):
  """Phase "graft_entry" (module docstring, phase 16): the port's root
  entry points on the card. Returns (the phase's fields, the launches of its
  paths by name); ``check_graft_entry`` asserts."""
  import torch
  from kfnet_tpu_torch import graft_entry
  from kfnet_tpu_torch.kernels import launches as launches_lib
  from kfnet_tpu_torch.nn import layers as L
  fn, args = graft_entry.entry()
  params, img_prev, img_cur = args
  tensors = L.tree_leaves(params) + [img_prev, img_cur]
  out = {"config_use_fused_kernel": fn.config.use_fused_kernel,
         "on_card": all(t.device.type == "cuda" for t in tensors),
         "frame_shape": list(img_cur.shape)}
  kernel, call_launches = counted(wrappers, lambda: fn(*args))
  plain = graft_entry.Step(dataclasses.replace(fn.config,
                                               use_fused_kernel=False))
  out["kernel_vs_plain"] = outputs_gap(kernel, plain(*args), TOL_PATH)
  out["finite"] = all(bool(torch.isfinite(t).all()) for t in kernel)
  out["P1_positive"] = bool((kernel[1] > 0).all())
  out["shapes"] = [list(t.shape) for t in kernel]

  # the step as one CUDA graph: warm-up on a side stream, then capture
  side = torch.cuda.Stream(dev)
  side.wait_stream(torch.cuda.current_stream(dev))
  with torch.cuda.stream(side):
    fn(*args)
  torch.cuda.current_stream(dev).wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with launches_lib.recorded() as record, torch.cuda.graph(
      graph, capture_error_mode="thread_local"):
    graphed = fn(*args)

  def replay():
    graph.replay()
    launches_lib.replayed(record)

  _, replay_launches = counted(wrappers, replay)
  out["graphed_vs_eager"] = outputs_gap(graphed, kernel, GRAPH_TOL)
  out["eager_ms"] = median_call_ms(lambda: fn(*args), GRAFT_CALLS)
  out["graphed_ms"] = median_call_ms(graph.replay, GRAFT_CALLS)
  out["timed_calls"] = GRAFT_CALLS
  out["launches"] = call_launches
  out["launches_replay"] = replay_launches
  out["launches_expected"] = {"fused_warp_kalman": 1, "conv3x3_same": 0,
                              "conv3x3_gn_chain": 0}
  del graph, graphed, kernel, params, args, tensors

  # the dry run over the card named GRAFT_DRYRUN_ENTRIES times
  t0 = time.time()
  _, dry_launches = counted(
      wrappers, lambda: graft_entry.dryrun_multichip(GRAFT_DRYRUN_ENTRIES))
  out["dryrun"] = {"entries": GRAFT_DRYRUN_ENTRIES,
                   "mesh": [str(d) for d in graft_entry.dryrun_mesh(
                       GRAFT_DRYRUN_ENTRIES).devices],
                   "seconds": round(time.time() - t0, 3),
                   "launches": dry_launches}
  return out, {"graft_entry": call_launches,
               "graft_entry_replay": replay_launches,
               "graft_dryrun": dry_launches}


def check_graft_entry(ge):
  """Raise on any hold of phase "graft_entry" that failed."""
  if not (ge["config_use_fused_kernel"] and ge["on_card"]):
    raise AssertionError(f"entry() off the card or without the fused "
                         f"kernel: {ge}")
  if not ge["kernel_vs_plain"]["held"]:
    raise AssertionError(f"entry()'s kernel step off its plain version: "
                         f"{ge['kernel_vs_plain']}")
  if not (ge["finite"] and ge["P1_positive"]):
    raise AssertionError("entry()'s step: non-finite outputs or P1 <= 0")
  if not ge["graphed_vs_eager"]["held"]:
    raise AssertionError(f"entry()'s step graphed off eager: "
                         f"{ge['graphed_vs_eager']}")
  for k in ("launches", "launches_replay"):
    if ge[k] != ge["launches_expected"]:
      raise AssertionError(f"entry() {k} {ge[k]}, expected "
                           f"{ge['launches_expected']}")
  if any(ge["dryrun"]["launches"].values()):
    raise AssertionError(f"the dry run (the composition) launched "
                         f"{ge['dryrun']['launches']}")


def main():
  t_all = time.time()
  import numpy as np
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
          file=sys.stderr)
    return 1
  import kfnet_tpu_torch
  from kfnet_tpu_torch.core import geometry
  from kfnet_tpu_torch.eval import benchmark, flops
  from kfnet_tpu_torch import configs
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import _build
  from kfnet_tpu_torch.kernels import conv3x3 as c3
  from kfnet_tpu_torch.kernels import fused_filter as ff
  from kfnet_tpu_torch.kernels import ransac as kr
  from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.utils import ocdbt
  from kfnet_tpu_torch.tools import conv_tiles, profile_online

  # 1. environment
  t0 = time.time()
  dev = torch.device("cuda")
  gpu = torch.cuda.get_device_name(0)
  smi = nvidia_smi()
  precision = kfnet_tpu_torch.set_fp32_precision()
  print(smi, flush=True)
  libraries = library_versions()
  say("env", t0, torch=torch.__version__, cuda=torch.version.cuda, gpu=gpu,
      count=torch.cuda.device_count(), nvidia_smi=smi, fp32=precision,
      libraries=libraries, ransac_probed_under=RANSAC_PROBED,
      libraries_as_probed=probed_libraries(libraries))

  # 2. build
  t0 = time.time()
  _build.build_libraries([(ff.LIBRARY, ff.SOURCES), (c3.LIBRARY, c3.SOURCES),
                          (kr.LIBRARY, kr.SOURCES)])
  ff.build()
  c3.build()
  kr.build()
  t1 = time.time()
  ocdbt.load_library()  # the checkpoint reader's zstd decoder (host C++)
  say("build", t0, sources=["kfnet_tpu_torch/kernels/csrc/fused_filter.cu",
                            "kfnet_tpu_torch/kernels/csrc/conv3x3.cu",
                            "kfnet_tpu_torch/kernels/csrc/ransac.cu",
                            "kfnet_tpu_torch/utils/csrc/zstd_decode.cpp"],
      host_library_seconds=round(time.time() - t1, 2))

  # 3. kernel against its plain version on the card
  t0 = time.time()
  rng = np.random.default_rng(0)
  cases = [("main_60x80_r4", 60, 80, 4, False, 2.365974),
           ("oob_60x80_r4", 60, 80, 4, True, 2.365974),
           ("odd_17x23_r3", 17, 23, 3, True, 7.814728)]
  errs = {}
  main_inputs = None
  for name, h, w, r, oob, thr in cases:
    args = [torch.from_numpy(a).to(dev) for a in filter_inputs(rng, h, w, r,
                                                               oob)]
    if main_inputs is None:
      main_inputs = (args, r, thr)
    kx, kP, kc = ff.fused_warp_kalman(*args, radius=r, threshold=thr)
    px, pP, pc = ff.fused_warp_kalman_reference(*args, radius=r,
                                                threshold=thr)
    torch.cuda.synchronize()
    dx = (kx - px).abs().max().item()
    dP = ((kP - pP).abs() / pP.abs()).max().item()
    mask_equal = bool(torch.equal(kc, pc))
    errs[name] = {"max_abs_dx": dx, "max_rel_dP": dP,
                  "max_abs_err": max(dx, (kP - pP).abs().max().item()),
                  "mask_equal": mask_equal,
                  "inconsistent_frac": 1.0 - float(pc.float().mean())}
    if not (dx <= TOL_X and dP <= TOL_P and mask_equal):
      raise AssertionError(f"kernel disagrees with its plain version on "
                           f"{name}: {errs[name]}")
  grad_errs = fused_grads(ff, main_inputs[0], main_inputs[1],
                          main_inputs[2])
  say("kernel_vs_plain", t0, tol={"x_atol": TOL_X, "P_rtol": TOL_P,
                                  "grad_rtol": GRAD_RTOL,
                                  "grad_atol": GRAD_ATOL},
      cases=errs, grads_vs_plain=grad_errs)

  # 3b. the heads-in entry against its plain version
  t0 = time.time()
  srng = np.random.default_rng(3)
  step_args = {}
  step_errs = {}
  for label, batch in (("B1_60x80_r4", None), ("B4_60x80_r4", 4)):
    step_args[label] = [torch.from_numpy(a).to(dev)
                        for a in raw_heads(srng, 60, 80, batch)]
    step_errs[label] = step_vs_plain(ff, step_args[label], 4, 2.365974)
  step_grad_errs = step_grads(
      ff, [torch.from_numpy(a).to(dev) for a in raw_heads(srng, 17, 23)], 3,
      7.814728)
  say("fused_step_vs_plain", t0, tol={"ulps": ULP_TOL, "x_atol": TOL_X,
                                      "P_rtol": TOL_P, "grad_rtol": GRAD_RTOL,
                                      "grad_atol": GRAD_ATOL},
      cases=step_errs,
      grads_vs_plain=step_grad_errs)

  # 4. the conv kernels against their plain versions
  t0 = time.time()
  conv_cfg = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(conv_impl="pallas_fused"),
      oflownet=oflownet.OFlowNetConfig(conv_impl="pallas_3x3"))
  first = kfnet.kernel_shapes(conv_cfg, IMG, first=True)
  later = kfnet.kernel_shapes(conv_cfg, IMG)
  same_shapes = list(dict.fromkeys(later["conv3x3_same"]))
  chain_shapes = list(dict.fromkeys(later["conv3x3_gn_chain"]))
  gen = torch.Generator(device=dev).manual_seed(0)
  conv_errs = check_conv_kernels(c3, conv_tiles.inputs, gen, dev,
                                 same_shapes, chain_shapes)
  say("conv_kernels_vs_plain", t0,
      tol={"f32_and_s1_of_max": TOL_F32_SUM, "s2_rtol": TOL_S2,
           "bf16_rtol": BF16_STEP}, **conv_errs)

  # 5. the slice at full width
  t0 = time.time()
  cfg = kfnet.KFNetConfig()
  params = kfnet.init(0, cfg, IMG, device=dev)
  K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(0).integers(0, 256, (8, 480, 640, 3),
                                             dtype=np.uint8)
  reloc = OnlineRelocalizer(params, cfg, K, device=dev, seed=0)
  # the main path's fused update is the heads-in entry, counted under
  # replay; every kernel's count is set to 0 just before and read after
  wrappers = {"fused_warp_kalman": ff.fused_filter_step,
              "conv3x3_same": c3.conv3x3_same,
              "conv3x3_gn_chain": c3.conv3x3_gn_chain}
  (outs, slice_solves), slice_launches = counted(
      wrappers, lambda: counted_solves(
          lambda: [reloc.process(f) for f in frames]))
  launches = slice_launches["fused_warp_kalman"]
  x_f, P_f = (a.clone() for a in reloc.state[:2])
  eager = OnlineRelocalizer(params, cfg, K, device=dev, seed=0, graph=False)
  graph_vs_eager = same_outputs((reloc, outs),
                                (eager, [eager.process(f) for f in frames]))
  plain_cfg = dataclasses.replace(cfg, use_fused_kernel=False)
  plain = OnlineRelocalizer(params, plain_cfg, K, device=dev, seed=0)
  plain_outs = [plain.process(f) for f in frames]
  x_p, P_p = plain.state[:2]
  poses = np.stack([p for p, _ in outs])
  fracs = [i["consistent_frac"] for _, i in outs]
  slice_expected = {"fused_warp_kalman": len(frames) - 1,
                    "conv3x3_same": 0, "conv3x3_gn_chain": 0}
  checks = {
      "launches": slice_launches,
      "launches_expected": slice_expected,
      "pose_solves": slice_solves, "pose_solves_expected": len(frames),
      "state_shapes": [list(x_f.shape), list(P_f.shape)],
      "packed_finite": bool(np.isfinite(poses).all() and all(
          np.isfinite([i["consistent_frac"], i["num_inliers"],
                       i["inlier_ratio"]]).all() for _, i in outs)),
      "x_max_abs_diff_vs_unfused": (x_f - x_p).abs().max().item(),
      "P_max_rel_diff_vs_unfused": ((P_f - P_p).abs() / P_p).max().item(),
      "consistent_frac": fracs,
      "consistent_frac_unfused": [i["consistent_frac"]
                                  for _, i in plain_outs],
      "inliers_last": outs[-1][1]["num_inliers"],
      "graph_vs_eager": graph_vs_eager,
      "host_syncs_in_one_tick": host_syncs(reloc, frames[0]),
  }
  graph_before = reloc._step
  reloc.reset()
  checks["host_syncs_after_reset"] = (host_syncs(reloc, frames[0]) +
                                      host_syncs(reloc, frames[1]))
  checks["graph_kept_across_reset"] = reloc._step is graph_before
  say("slice_full_width", t0, config="KFNetConfig() 640x480 bf16", **checks)
  if not graph_vs_eager["held"]:
    raise AssertionError(f"the graphed filter step disagrees with the eager "
                         f"one: {graph_vs_eager}")
  if slice_launches != slice_expected:
    raise AssertionError(f"kernel launches {slice_launches} for "
                         f"{len(frames)} frames, expected {slice_expected}")
  if not one_launch_a_solve(slice_solves, len(frames)):
    raise AssertionError(f"pose kernels {slice_solves} for {len(frames)} "
                         f"solves: expected one launch of each a solve")
  if not checks["packed_finite"]:
    raise AssertionError("non-finite packed output")
  if not torch.allclose(x_f, x_p, rtol=TOL_PATH, atol=TOL_PATH) or \
      not torch.allclose(P_f, P_p, rtol=TOL_PATH, atol=TOL_PATH):
    raise AssertionError("fused and unfused paths disagree")
  if checks["host_syncs_in_one_tick"] or checks["host_syncs_after_reset"]:
    raise AssertionError("a frame's work waits on the device before its "
                         "result copy")
  if not checks["graph_kept_across_reset"]:
    raise AssertionError("reset() captured the filter step again")

  # 6. the conv-kernel configuration at full width
  t0 = time.time()
  reloc_c = OnlineRelocalizer(params, conv_cfg, K, device=dev, seed=0)
  ff.fused_filter_step.launches = 0
  c3.conv3x3_same.launches = 0
  c3.conv3x3_gn_chain.launches = 0
  L.layout_copies = 0
  c3.prepared_weights.copies = 0

  def served_c():  # (outputs, weight copies over the first two frames)
    pair = [reloc_c.process(f) for f in frames[:2]]
    copies = c3.prepared_weights.copies
    return pair + [reloc_c.process(f) for f in frames[2:]], copies

  (outs_c, weight_copies_first_pair), conv_solves = counted_solves(served_c)
  weight_copies_later = c3.prepared_weights.copies - weight_copies_first_pair
  # "fused_warp_kalman" is the kernels line's name for the fused update
  conv_launches = {"fused_warp_kalman": ff.fused_filter_step.launches,
                   "conv3x3_same": c3.conv3x3_same.launches,
                   "conv3x3_gn_chain": c3.conv3x3_gn_chain.launches}
  eager_c = OnlineRelocalizer(params, conv_cfg, K, device=dev, seed=0,
                              graph=False)
  conv_graph_vs_eager = same_outputs(
      (reloc_c, outs_c), (eager_c, [eager_c.process(f) for f in frames]))
  n_later = len(frames) - 1
  expected = {"fused_warp_kalman": n_later}
  for name in ("conv3x3_same", "conv3x3_gn_chain"):
    expected[name] = len(first[name]) + n_later * len(later[name])
  copies = L.layout_copies
  up = lambda f: kfnet.preprocess_images(cfg, torch.from_numpy(f).to(dev))
  img0, img1 = up(frames[0]), up(frames[1])

  def pair_outputs(c):
    return frame_pair_outputs(params, c, img0, img1)

  calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
  with recording(c3, calls):
    out_c = pair_outputs(conv_cfg)
  in_path = check_calls(c3, calls)
  n_calls = {k: len(v) for k, v in calls.items()}
  if n_calls != {"conv3x3_same": len(first["conv3x3_same"])
                 + len(later["conv3x3_same"]),
                 "conv3x3_gn_chain": len(later["conv3x3_gn_chain"])}:
    raise AssertionError(f"kernel calls in the checked pair: {n_calls}")
  out_x = pair_outputs(cfg)
  # the same path with each kernel's plain version in its place (same
  # rounding points; these calls are not counted)
  with mock.patch.object(c3, "conv3x3_same", c3.conv3x3_same_reference), \
      mock.patch.object(c3, "conv3x3_gn_chain",
                        c3.conv3x3_gn_chain_reference):
    out_p = pair_outputs(conv_cfg)
  dev_vs_xla = {k: deviation(out_c[k], out_x[k], k in ("V", "W"))
                for k in out_c}
  dev_vs_plain = {k: deviation(out_c[k], out_p[k], k in ("V", "W"))
                  for k in out_c}
  poses_c = np.stack([p for p, _ in outs_c])
  conv_checks = {
      "launches": conv_launches, "launches_expected": expected,
      "pose_solves": conv_solves, "pose_solves_expected": len(frames),
      "layout_copies": copies,
      "weight_layout_copies": {"first_two_frames": weight_copies_first_pair,
                               "later_frames": weight_copies_later},
      "packed_finite": bool(np.isfinite(poses_c).all() and all(
          np.isfinite([i["consistent_frac"], i["num_inliers"],
                       i["inlier_ratio"]]).all() for _, i in outs_c)),
      "consistent_frac": [i["consistent_frac"] for _, i in outs_c],
      "calls_in_path_vs_plain": in_path, "vs_plain_path": dev_vs_plain,
      "vs_default_config": dev_vs_xla, "bounds": BOUNDS,
      "graph_vs_eager": conv_graph_vs_eager,
      "host_syncs_in_one_tick": host_syncs(reloc_c, frames[0]),
  }
  say("slice_conv_kernels", t0,
      config="KFNetConfig(SCoordNet pallas_fused, OFlowNet pallas_3x3) "
      "640x480 bf16", **conv_checks)
  if conv_launches != expected:
    raise AssertionError(f"kernel launches {conv_launches}, expected "
                         f"{expected}")
  if not one_launch_a_solve(conv_solves, len(frames)):
    raise AssertionError(f"pose kernels {conv_solves} for {len(frames)} "
                         f"solves (conv kernels): expected one launch of "
                         f"each a solve")
  if not conv_graph_vs_eager["held"]:
    raise AssertionError(f"the graphed filter step disagrees with the eager "
                         f"one (conv kernels): {conv_graph_vs_eager}")
  if weight_copies_later:
    raise AssertionError(f"{weight_copies_later} weight layout copies after "
                         f"the second frame: the copy is not once per "
                         f"weight tensor")
  if not conv_checks["packed_finite"]:
    raise AssertionError("non-finite packed output (conv kernels)")
  for what, devs in (("its plain version", dev_vs_plain),
                     ("the default config", dev_vs_xla)):
    over = {k: v["max_rel"] for k, v in devs.items()
            if not v["max_rel"] <= BOUNDS[k]}
    if over:
      raise AssertionError(f"conv-kernel path off {what}: {over}")
  if conv_checks["host_syncs_in_one_tick"]:
    raise AssertionError("a frame's work waits on the device before its "
                         "result copy (conv kernels)")

  # 7. pose on known data
  t0 = time.time()
  prng = np.random.default_rng(1)
  n = 4800
  R_wc = rodrigues(np.array([0.2, -0.3, 0.1]))
  t_wc = np.array([0.5, -0.2, 1.0])
  pc = np.stack([prng.uniform(-1.5, 1.5, n), prng.uniform(-1.0, 1.0, n),
                 prng.uniform(1.0, 5.0, n)], -1)
  X = pc @ R_wc.T + t_wc
  uv = pc[:, :2] / pc[:, 2:] * 525.0 + np.array([320.0, 240.0])
  uv += prng.normal(size=uv.shape) * 0.5
  out_idx = prng.choice(n, int(0.3 * n), replace=False)
  X[out_idx] += prng.normal(size=(len(out_idx), 3)) * 2.0
  T_gt = np.eye(4)
  T_gt[:3, :3], T_gt[:3, 3] = R_wc, t_wc
  var = prng.uniform(0.5, 2.0, n)
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  K_dev = f32(K)
  pose_args = (f32(uv), f32(X), f32(var),
               torch.ones(n, dtype=torch.bool, device=dev), K_dev)
  sol = ransac.solve_pnp_ransac(*pose_args, gen)
  T_gt_t = f32(T_gt)
  terr = geometry.translation_error(sol["T_wc"], T_gt_t).item()
  rerr = geometry.rotation_error_deg(sol["T_wc"], T_gt_t).item()
  say("pose_known_data", t0, n=n, outliers=0.3, t_err_m=terr,
      r_err_deg=rerr, inlier_ratio=sol["inlier_ratio"].item())
  if not (terr < 0.01 and rerr < 0.1):
    raise AssertionError(f"pose off: {terr} m, {rerr} deg")

  # 7b. the sequence path
  t0 = time.time()
  srng = np.random.default_rng(4)
  seq_a, seq_b = (srng.integers(0, 256, (SEQ_T,) + IMG, dtype=np.uint8)
                  for _ in range(2))
  forms, ref_a = sequence_forms(sequence, params, cfg, seq_a, 8, 4, wrappers,
                                dev)
  ref_b = sequence.run_filter_python_loop(params, cfg,
                                          torch.from_numpy(seq_b).to(dev))
  pair = torch.from_numpy(np.stack([seq_a, seq_b], 1)).to(dev)
  (xs_b, Ps_b), n_b = counted(wrappers, lambda: sequence.run_filter_batched(
      params, cfg, pair))
  # a batch of two takes other conv and reduction orders than one frame,
  # and in bf16 a flipped rounding spreads through the random-weight nets
  # (frame 0's z already 1.6% of its largest value off): the bf16 batch
  # is recorded, its frame 0 held at BOUNDS, and the same sequences in
  # float32 (same widths and weights) held at TOL_PATH
  cfg32 = dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet,
                                         compute_dtype="float32"),
      oflownet=dataclasses.replace(cfg.oflownet, compute_dtype="float32"))
  xs32, Ps32 = sequence.run_filter_batched(params, cfg32, pair)
  forms["batched_B2"] = {
      "launches": n_b,
      "bf16": {"vs_a": close_to((xs_b[:, 0], Ps_b[:, 0]), ref_a),
               "vs_b": close_to((xs_b[:, 1], Ps_b[:, 1]), ref_b),
               "frame0_vs_alone": {
                   "z": deviation(xs_b[0, 0], ref_a[0][0], False),
                   "V": deviation(Ps_b[0, 0], ref_a[1][0], True)}},
      "float32": {
          "vs_" + k: close_to((xs32[:, i], Ps32[:, i]),
                              sequence.run_filter_python_loop(
                                  params, cfg32, pair[:, i]))
          for i, k in enumerate("ab")}}
  conv_forms, _ = sequence_forms(sequence, params, conv_cfg,
                                 seq_a[:SEQ_T_CONV], 4, 4, wrappers, dev)
  seq_expected = {
      "default": {"fused_warp_kalman": SEQ_T - 1, "conv3x3_same": 0,
                  "conv3x3_gn_chain": 0},
      "conv_kernels": {
          "fused_warp_kalman": SEQ_T_CONV - 1,
          **{k: len(first[k]) + (SEQ_T_CONV - 1) * len(later[k])
             for k in ("conv3x3_same", "conv3x3_gn_chain")}}}
  # the batched solve on known poses, and against each frame's solve on
  # the same index sets
  puv, pX, pvar, pT = known_poses(np.random.default_rng(5), 8, 4800, K)
  rc = ransac.RansacConfig()
  pgen = torch.Generator(device=dev).manual_seed(0)
  pose_in = (f32(puv), f32(pX), f32(pvar),
             torch.ones(pvar.shape, dtype=torch.bool, device=dev))
  uv_k, X_k, w_k = ransac.select_confident(*pose_in, rc.top_k)
  idx = ransac.sample_hypotheses(w_k, rc.num_hypotheses, rc.sample_size, pgen)
  batched = ransac.solve_with_indices(uv_k, X_k, w_k, K_dev, idx, rc)
  single = torch.stack([ransac.solve_with_indices(
      uv_k[f], X_k[f], w_k[f], K_dev, idx[f], rc)["T_wc"] for f in range(8)])
  T_true = f32(pT)
  pose_check = {
      "t_err_m": geometry.translation_error(batched["T_wc"], T_true).tolist(),
      "r_err_deg": geometry.rotation_error_deg(batched["T_wc"],
                                               T_true).tolist(),
      "vs_single_bit_equal": bool(torch.equal(batched["T_wc"], single)),
      "vs_single_max_abs": (batched["T_wc"] - single).abs().max().item(),
      "vs_single_held": bool(torch.allclose(batched["T_wc"], single,
                                            rtol=POSE_RTOL, atol=POSE_ATOL)),
      "inlier_ratio": batched["inlier_ratio"].tolist(),
      # CUDA events around the enqueue: the host's pace
      "ms_batched_8_frames": cuda_ms(lambda: ransac.solve_pnp_ransac(
          *pose_in, K_dev, pgen), 3),
      "ms_single_8_frames": cuda_ms(lambda: [ransac.solve_pnp_ransac(
          *(a[f] for a in pose_in), K_dev, pgen) for f in range(8)], 3)}
  # the bench's figures (eval/benchmark.py's protocols): 32 float frames
  # of the bench, a 96-frame stream of them on the card
  fimg = torch.from_numpy(np.random.default_rng(0).uniform(
      0, 1, (32,) + IMG).astype(np.float32)).to(dev)
  K_bench = np.array([[585.0, 0, 319.5], [0, 585.0, 239.5], [0, 0, 1]],
                     np.float32)
  peak = flops.peak_flops(dev)
  figures = {}
  for name, c in (("default", cfg), ("conv_kernels", conv_cfg)):
    fps = benchmark.filter_fps(c, params, fimg)
    fl = flops.filter_step_flops(c, *IMG[:2])
    figures[name] = {
        "filter_fps": fps,
        "e2e_pose_fps": benchmark.e2e_pose_fps(c, params, fimg, K_bench),
        "streaming_fps_device": benchmark.streaming_fps(
            c, params, list(torch.cat([fimg] * 3))),
        "gflops_per_frame": fl / 1e9,
        "mfu": fl * fps / peak if peak else None, "peak_flops": peak}
  print(smi, flush=True)
  say("sequence", t0, gpu=gpu, nvidia_smi=smi, frames=SEQ_T,
      frames_conv_kernels=SEQ_T_CONV, tol=TOL_PATH,
      default=forms, conv_kernels=conv_forms, launches_expected=seq_expected,
      batched_pose=pose_check, pose_tol={"rtol": POSE_RTOL, "atol": POSE_ATOL},
      figures=figures)
  for name, fs in (("default", forms), ("conv_kernels", conv_forms)):
    for form, res in fs.items():
      checks = (list(res["float32"].values()) if form == "batched_B2"
                else [res])
      if not all(r["held"] for r in checks):
        raise AssertionError(f"{name} {form} off the eager loop: {res}")
      want = seq_expected[name]
      if form == "batched_B2":  # one fused launch a step for both maps
        want = dict(want, fused_warp_kalman=SEQ_T - 1)
      if res["launches"] != want:
        raise AssertionError(f"{name} {form} launches {res['launches']}, "
                             f"expected {want}")
  frame0 = forms["batched_B2"]["bf16"]["frame0_vs_alone"]
  if not all(frame0[k]["max_rel"] <= BOUNDS[k] for k in frame0):
    raise AssertionError(f"bf16 batch's frame 0 off the single frame's: "
                         f"{frame0}")
  if forms["chunked"]["chunks"] != [5, 4, 4, 3]:
    raise AssertionError(f"chunks {forms['chunked']['chunks']}")
  if not (max(pose_check["t_err_m"]) < 0.01
          and max(pose_check["r_err_deg"]) < 0.1):
    raise AssertionError(f"batched pose off: {pose_check}")
  if not pose_check["vs_single_held"]:
    raise AssertionError(f"batched pose differs from the per-frame solves: "
                         f"{pose_check}")
  if not all(np.isfinite(v["filter_fps"]) for v in figures.values()):
    raise AssertionError(f"figures: {figures}")

  # 7c. the shipped weights
  t0 = time.time()
  pre = pretrained_phase(dev, wrappers)
  print(smi, flush=True)
  say("pretrained", t0, gpu=gpu, nvidia_smi=smi,
      gate={"median_translation_m": 0.5, "median_rotation_deg": 8.0}, **pre)
  if pre["launches"] != pre["launches_expected"]:
    raise AssertionError(f"pretrained launches {pre['launches']}, expected "
                         f"{pre['launches_expected']}")
  if not (pre["on_device"] and pre["stage12_finite"]):
    raise AssertionError(f"pretrained weights: {pre}")
  if pre["render_pixels_off_cpu"] > 1e-3 * pre["render_pixels"]:
    raise AssertionError(f"the card's render is off the CPU's: {pre}")
  if not (pre["median_translation_m"] < 0.5
          and pre["median_rotation_deg"] < 8.0):
    raise AssertionError(f"sceneA not relocalized: {pre}")

  # 7d. P3P on known poses, and the served tick with the P3P solver
  t0 = time.time()
  p3p_cfg = configs.synthetic_ransac(full_size=True)
  dlt_cfg = dataclasses.replace(p3p_cfg, solver="dlt")
  coords, var, T_p = known_pose_maps(np.random.default_rng(6), K)
  maps = (f32(coords), f32(var),
          torch.ones(var.shape, dtype=torch.bool, device=dev))
  sol = ransac.solve_pnp_from_maps(*maps, K_dev, gen, config=p3p_cfg)
  T_p = f32(T_p)
  reloc_p = OnlineRelocalizer(params, cfg, K, device=dev, seed=0,
                              ransac_config=p3p_cfg)
  for f in frames[:2]:
    reloc_p.process(f)
  p3p_checks = {
      "config": dataclasses.asdict(p3p_cfg), "maps": list(coords.shape),
      "outliers": 0.3,
      "t_err_m": geometry.translation_error(sol["T_wc"], T_p).item(),
      "r_err_deg": geometry.rotation_error_deg(sol["T_wc"], T_p).item(),
      "inlier_ratio": sol["inlier_ratio"].item(),
      "host_syncs_in_one_tick": host_syncs(reloc_p, frames[2]),
      # CUDA events around the enqueue: the host's pace
      "ms_p3p": cuda_ms(lambda: ransac.solve_pnp_from_maps(
          *maps, K_dev, gen, config=p3p_cfg), 5),
      "ms_dlt_same_budget": cuda_ms(lambda: ransac.solve_pnp_from_maps(
          *maps, K_dev, gen, config=dlt_cfg), 5),
      "packed_finite": bool(np.isfinite(reloc_p.process(frames[3])[0]).all())}
  say("p3p", t0, gpu=gpu, nvidia_smi=smi, **p3p_checks)
  if not (p3p_checks["t_err_m"] < 0.01 and p3p_checks["r_err_deg"] < 0.1):
    raise AssertionError(f"P3P pose off: {p3p_checks}")
  if p3p_checks["host_syncs_in_one_tick"] or not p3p_checks["packed_finite"]:
    raise AssertionError(f"the P3P tick: {p3p_checks}")

  # 7d'. the pose solve's kernels at the served shapes
  t0 = time.time()
  rs = ransac_phase(dev)
  say("ransac", t0, gpu=gpu, nvidia_smi=smi, tol=RANSAC_TOL, **rs)

  # 7e. the fleet: B streams at full width, both configurations
  t0 = time.time()
  fticks = np.random.default_rng(7).integers(
      0, 256, (FLEET_T, FLEET_B) + IMG, dtype=np.uint8)
  resets = [None] * FLEET_T
  resets[FLEET_RESET] = np.arange(FLEET_B) == 2
  fleet_checks, fleet_times = fleet_phase(
      dev, params, {"default": cfg, "conv_kernels": conv_cfg}, cfg32, K,
      fticks, resets, first, later, wrappers, c3)
  print(smi, flush=True)
  say("fleet", t0, gpu=gpu, nvidia_smi=smi, batch=FLEET_B, ticks=FLEET_T,
      reset={"tick": FLEET_RESET, "slot": 2}, tol=TOL_PATH,
      times=fleet_times, **fleet_checks)
  for name, row in fleet_checks.items():
    if row["launches"] != row["launches_expected"]:
      raise AssertionError(f"fleet {name} launches {row['launches']}, "
                           f"expected {row['launches_expected']}")
    if not one_launch_a_solve(row["pose_solves"], FLEET_T):
      raise AssertionError(f"fleet {name} pose kernels {row['pose_solves']} "
                           f"for {FLEET_T} solves: expected one launch of "
                           f"each a solve")
    if row["captures"] != 1 or row["captures_after_reset_ticks"]:
      raise AssertionError(f"fleet {name}: captured {row['captures']} "
                           f"times, then {row['captures_after_reset_ticks']}")
    if row["host_syncs_in_one_tick_with_and_without_reset"]:
      raise AssertionError(f"a fleet tick waits on the device ({name})")
    if not (row["packed_finite"] and row["pipelined_equals_sync_shifted"]
            and row["ticks_pipelined"] == FLEET_T):
      raise AssertionError(f"fleet {name}: {row}")
    if row["consistent_frac_reset_tick"][2] != 0.0:
      raise AssertionError(f"fleet {name}: the reset slot's tick {row}")
    held = (row["vs_lone_streams_float32"] if name == "default"
            else row["vs_lone_streams"])
    if not held["held"]:
      raise AssertionError(f"fleet {name} slots off their lone streams: "
                           f"{held}")
  if not all(np.isfinite(v).all() for t in fleet_times.values()
             for v in t.values()):
    raise AssertionError(f"fleet times: {fleet_times}")

  # 8. times
  t0 = time.time()
  # the TPU kernel's contract (fused_warp_kalman) at 60x80
  args, r, thr = main_inputs
  fwk = {"ms": cuda_ms(lambda: ff.fused_warp_kalman(*args, radius=r,
                                                    threshold=thr), 200),
         "plain_ms": cuda_ms(lambda: ff.fused_warp_kalman_reference(
             *args, radius=r, threshold=thr), 200),
         "alone_ms": conv_tiles.graph_ms(lambda: ff.fused_warp_kalman(
             *args, radius=r, threshold=thr), 20)}
  # the bound: each input read once, each output written once: per pixel
  # 11 f32 in, 4 f32 + 1 byte out; ~70 f32 operations
  h, w = args[0].shape[:2]
  fwk["bytes"] = h * w * (11 * 4 + 4 * 4 + 1)
  fwk["bound_ms"] = max(fwk["bytes"] / HBM_BYTES_PER_S,
                        h * w * 70 / F32_FLOPS_PER_S) * 1e3
  fwk["max_abs_err"] = errs["main_60x80_r4"]["max_abs_err"]
  # the main path's entry (fused_filter_step), one 60x80 map and four:
  # per pixel 11 f32 in (raw heads 3 + 4, x 3, P 1), 11 f32 + 1 byte out;
  # ~130 f32 operations
  skw = dict(radius=4, threshold=2.365974, **STEP_KW)
  step = {}
  for label, sa in step_args.items():
    run = lambda sa=sa: ff.fused_filter_step(*sa, **skw)
    pixels = sa[2][..., 0].numel()
    row = {"ms": cuda_ms(run, 200),
           "plain_ms": cuda_ms(lambda sa=sa: ff.fused_filter_step_reference(
               *sa, **skw), 50),
           "alone_ms": conv_tiles.graph_ms(run, 20),
           "bytes": pixels * (11 * 4 + 11 * 4 + 1)}
    ops_ms = pixels * 130 / F32_FLOPS_PER_S * 1e3
    bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    step[label] = row

  def unfused_route(fh, ch, x, P):
    """What the filter step launched around the update before the heads-in
    entry: the nets' output steps, W * w_scale, the flow clip, then the TPU
    kernel's contract."""
    flow, W = oflownet.output_step(fh, 4)
    W = W * STEP_KW["w_scale"]
    z, V = scoordnet.output_step(ch, STEP_KW["coord_scale"],
                                 STEP_KW["coord_offset"])
    flow = torch.clamp(flow, -4.0, 4.0)
    return ff.fused_warp_kalman(x, P, flow.contiguous(), W.contiguous(),
                                z.contiguous(), V.contiguous(), radius=4,
                                threshold=2.365974)

  more = np.random.default_rng(2).integers(0, 256, (16, 480, 640, 3),
                                           dtype=np.uint8)
  cycle = itertools.cycle(more)
  serve = {"default": {"graph": reloc, "eager": eager},
           "conv_kernels": {"graph": reloc_c, "eager": eager_c}}
  for name, c in (("default", cfg), ("conv_kernels", conv_cfg)):
    for mode in ("graph", "eager"):
      rl = OnlineRelocalizer(params, c, K, device=dev, solve_pose=False,
                             graph=mode == "graph")
      for f in more[:2]:
        rl.process(f)
      serve[name]["filter_" + mode] = rl
  # in turns, default, conv, conv, default: 8 frames each, graphed and eager
  turns = {"default": [], "conv_kernels": []}  # process(), graphed (served)
  turns_eager = {"default": [], "conv_kernels": []}
  filter_host_ms = {n: {"graph": [], "eager": []} for n in serve}
  filter_ms = {n: {"graph": [], "eager": []} for n in serve}
  for name in ("default", "conv_kernels", "conv_kernels", "default"):
    sv = serve[name]
    turns[name].append(cuda_ms(lambda: sv["graph"].process(next(cycle)), 8))
    turns_eager[name].append(cuda_ms(lambda: sv["eager"].process(next(cycle)),
                                     8))
    for mode in ("graph", "eager"):
      rl = sv["filter_" + mode]
      filter_host_ms[name][mode].append(
          profile_online.host_ms(lambda: rl.tick(next(cycle)), 8))
      filter_ms[name][mode].append(
          cuda_ms(lambda: rl.process(next(cycle)), 8))
  capture = {name: capture_costs(OnlineRelocalizer(
      params, c, K, device=dev, solve_pose=False), more)
             for name, c in (("default", cfg), ("conv_kernels", conv_cfg))}
  process_ms = sum(turns["default"]) / 2
  process_conv_ms = sum(turns["conv_kernels"]) / 2
  # every conv kernel call of one filter-step frame, served eagerly (a
  # replay calls no wrapper), timed alone
  frame_calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
  with recording(c3, frame_calls):
    eager_c.process(next(cycle))
  if {k: len(v) for k, v in frame_calls.items()} != {
      k: len(later[k]) for k in frame_calls}:
    raise AssertionError("conv kernel calls in the timed frame: "
                         f"{ {k: len(v) for k, v in frame_calls.items()} }")
  alone = time_calls_alone(conv_tiles, frame_calls)
  same_rows = time_conv_kernels(c3, conv_tiles, gen, dev, same_shapes,
                                chain=False)
  chain_rows = time_conv_kernels(c3, conv_tiles, gen, dev, chain_shapes,
                                 chain=True)
  same_frame = per_frame(same_rows, later["conv3x3_same"])
  chain_frame = per_frame(chain_rows, later["conv3x3_gn_chain"])
  x_now, P_now = reloc.state[:2]
  ones = torch.ones_like(P_now, dtype=torch.bool)
  pose_ms = cuda_ms(lambda: ransac.solve_pnp_from_maps(
      x_now, P_now, ones, K_dev, gen), 10)
  # last, so that the profiler runs after every time above is taken
  b1 = step_args["B1_60x80_r4"]
  route_kernels = {
      "before": profiled_kernels(lambda: unfused_route(*b1)),
      "fused_filter_step": profiled_kernels(
          lambda: ff.fused_filter_step(*b1, **skw))}
  removed = route_kernels["before"] - route_kernels["fused_filter_step"]
  print(smi, flush=True)
  say("times", t0, gpu=gpu, nvidia_smi=smi, process_ms_per_frame=process_ms,
      process_ms_per_frame_conv_kernels=process_conv_ms, process_turns=turns,
      process_turns_eager=turns_eager, filter_step_host_ms=filter_host_ms,
      filter_step_ms=filter_ms, capture_ms=capture,
      fused_warp_kalman_entry=fwk,
      fused_filter_step=step, fused_route_kernels=route_kernels,
      pose_solve_ms=pose_ms,
      conv3x3_same_per_shape={str(k): v for k, v in same_rows.items()},
      conv3x3_same_per_frame=same_frame,
      conv3x3_gn_chain_per_shape={str(k): v for k, v in chain_rows.items()},
      conv3x3_gn_chain_per_frame=chain_frame,
      served_frame_alone=alone,
      total_seconds=round(time.time() - t_all, 1))

  # 9. training at full width
  t0 = time.time()
  train_stages, train_checks = train_phase(dev, wrappers)
  print(smi, flush=True)
  say("train", t0, gpu=gpu, nvidia_smi=smi, stages=train_stages,
      **train_checks, total_seconds=round(time.time() - t_all, 1))
  train_launches = train_stages["stage3a_window"]["launches"]
  if train_launches["fused_warp_kalman"] != train_checks[
      "train_launches_expected"]:
    raise AssertionError(f"stage 3a fused launches {train_launches}, "
                         f"expected {train_checks['train_launches_expected']}")
  if any(n for s in train_stages.values() for k, n in s["launches"].items()
         if k != "fused_warp_kalman") or train_stages["stage3b_pairs"][
             "launches"]["fused_warp_kalman"]:
    raise AssertionError(f"training launched another kernel: "
                         f"{ {k: s['launches'] for k, s in train_stages.items()} }")
  if not train_checks["finite"]:
    raise AssertionError(f"a training loss, grad norm or param is not "
                         f"finite: {train_stages}")
  if not train_checks["fixed_batch_loss_falls"]:
    raise AssertionError(f"the loss on one batch did not fall: "
                         f"{train_checks['fixed_batch_losses']}")
  if not train_checks["kernel_vs_plain_and_composition"]["deterministic"][
      "held"]:
    raise AssertionError(f"train kernel against plain and composition: "
                         f"{train_checks['kernel_vs_plain_and_composition']}")
  if not train_checks["served_graph_vs_eager"]["held"]:
    raise AssertionError(f"trained weights served: "
                         f"{train_checks['served_graph_vs_eager']}")
  if not train_checks["remat_vs_none_T3"]["deterministic"]["held"]:
    raise AssertionError(f"remat off no remat: "
                         f"{train_checks['remat_vs_none_T3']}")
  resumed = train_checks["resume_vs_uninterrupted"]["deterministic"]
  if not (resumed["bit_equal"] and resumed["steps"] == [6, 6]
          and resumed["counts"] == [6, 6]):
    raise AssertionError(f"resumed run off the uninterrupted one: "
                         f"{train_checks['resume_vs_uninterrupted']}")
  served = train_checks["served_graph_vs_eager"]
  if served["launches"] != served["launches_expected"]:
    raise AssertionError(f"trained weights served: {served}")
  if not all(c["within"] for c in
             train_checks["float32_card_vs_cpu"]["tiny_48x64"].values()):
    raise AssertionError(f"card off the CPU: "
                         f"{train_checks['float32_card_vs_cpu']}")

  # 10. the four full-size shipped stages at 640x480, read from artifacts/
  t0 = time.time()
  full = pretrained_full_phase(dev, wrappers)
  print(smi, flush=True)
  say("pretrained_full", t0, gpu=gpu, nvidia_smi=smi, stages=full,
      total_seconds=round(time.time() - t_all, 1))
  check_pretrained_full(full)

  # 10b. Winograd convs on the flagship and the norm="none" sceneA stage
  t0 = time.time()
  wg = winograd_phase(dev, wrappers)
  print(smi, flush=True)
  say("winograd", t0, gpu=gpu, nvidia_smi=smi, tol={
      "bf16_of_max_y": WINO_BF16, "z": WINO_Z, "V": WINO_V}, **wg,
      total_seconds=round(time.time() - t_all, 1))
  check_winograd(wg)

  # 11. the on-disk data path and the three train scripts
  t0 = time.time()
  data = data_phase(dev, wrappers)
  print(smi, flush=True)
  say("data", t0, gpu=gpu, nvidia_smi=smi, **data,
      total_seconds=round(time.time() - t_all, 1))
  if data["decode"]["unequal"] or not data["decode"]["files"]:
    raise AssertionError(f"the C++ and numpy PNG decoders differ: "
                         f"{data['decode']}")
  lab = data["labels_vs_generate"]
  if not (lab["valid_equal"] and lab["max_err_over_tol"] <= 1.0):
    raise AssertionError(f"depth_png_to_labels off labels.generate: {lab}")
  nb = data["native_vs_python_batch"]
  if not (nb["keys_equal"] and nb["image_equal"] and nb["valid_equal"]
          and nb["coords_max_err_over_tol"] <= 1.0):
    raise AssertionError(f"batched_native off batched: {nb}")
  for name, r in data["clis"].items():
    f = r["files"]
    if not (r["steps"] == r["optimizer_count"] == r["steps_expected"]
            and len(r["losses"]) == r["steps_expected"]
            and np.isfinite(r["losses"]).all() and r["params_finite"]
            and f["metrics_jsonl"] and f["export_params"]
            and f["checkpoint_step"] == r["steps_expected"]
            and r["profile"] is not None):
      raise AssertionError(f"{name}: {r}")
    want_meta = (["dataset", "scenes"] if name == "train_oflownet"
                 else ["coord_offset", "coord_scale", "scene"])
    if f["export_meta"] != want_meta:
      raise AssertionError(f"{name} export meta: {f}")
    if name != "train_kfnet" and any(r["launches"].values()):
      raise AssertionError(f"{name} launched a kernel: {r['launches']}")
  cli_kf = data["clis"]["train_kfnet"]
  if cli_kf["launches"] != cli_kf["launches_expected"]:
    raise AssertionError(f"train_kfnet launches {cli_kf['launches']}, "
                         f"expected {cli_kf['launches_expected']}")
  s12 = data["twelve_scenes"]
  if s12["decode"]["unequal"] or s12["decode"]["files"] != (
      S12_TRAIN + S12_TEST + 1):
    raise AssertionError(f"the C++ and numpy JPEG decoders differ: "
                         f"{s12['decode']}")
  lvr = s12["loaded_vs_render"]
  if not (lvr["mean"] < JPEG_MEAN and lvr["max"] < JPEG_MAX):
    raise AssertionError(f"12-Scenes colour off the render: {lvr}")
  t12 = s12["train_scoordnet_12scenes"]
  if not (t12["steps"] == S12_STEPS and len(t12["losses"]) == S12_STEPS
          and np.isfinite(t12["losses"]).all() and t12["params_finite"]):
    raise AssertionError(f"train_scoordnet on 12-Scenes: {t12}")

  # 12. evaluation: acceptance, the eval CLI on the flagship, eval_poses
  t0 = time.time()
  ev = eval_phase(dev, wrappers)
  print(smi, flush=True)
  say("eval", t0, gpu=gpu, nvidia_smi=smi, **ev,
      total_seconds=round(time.time() - t_all, 1))
  first, rerun = ev["acceptance"]["first"], ev["acceptance"]["rerun"]
  if not all(first["exports"].values()):
    raise AssertionError(f"acceptance exports: {first['exports']}")
  if first["optimizer_steps"] != ev["optimizer_steps_expected"] or \
      rerun["optimizer_steps"]:
    raise AssertionError(f"acceptance optimizer steps {first['optimizer_steps']}"
                         f" then {rerun['optimizer_steps']}, expected "
                         f"{ev['optimizer_steps_expected']} then 0")
  for name, run in ev["acceptance"].items():
    if not all(np.isfinite(list(m.values())).all()
               for m in run["medians"].values()):
      raise AssertionError(f"acceptance {name} medians: {run['medians']}")
    for e in run["evals"]:
      want = (ev["filtered_launches_expected"] if e["mode"] == "filtered"
              else {k: 0 for k in wrappers})
      if e["launches"] != want:
        raise AssertionError(f"acceptance {name} {e['mode']} launches "
                             f"{e['launches']}, expected {want}")
  if "filtered_smoothed" not in rerun["medians"]:
    raise AssertionError(f"acceptance re-run: {rerun['medians']}")
  for name, r in ev["flagship_cli"].items():
    want = ev["flagship_launches_expected"][name]
    if r["launches"]["fused_warp_kalman"] != want or \
        r["frames"] != EVAL_TEST or not np.isfinite(
            r["median_translation_m"]):
      raise AssertionError(f"flagship eval {name}: {r}, fused launches "
                           f"expected {want}")
  for key in ("streaming_vs_batch", "uint8_vs_float_streaming"):
    if not ev[key]["held"]:
      raise AssertionError(f"{key}: {ev[key]}")
  if not ev["flagship_gate"]["passed"]:
    raise AssertionError(f"the flagship's medians on the fixture: "
                         f"{ev['flagship_gate']}")
  cvs = ev["cli_vs_evaluate_sequence"]
  if not (cvs["maps"]["held"] and cvs["poses"]["held"]):
    raise AssertionError(f"the eval CLI off evaluate_sequence: {cvs}")
  if not (ev["eval_poses"]["poses_vs_eval_main"]["held"]
          and ev["eval_poses"]["medians_equal"]):
    raise AssertionError(f"eval_poses off eval.main: {ev['eval_poses']}")

  # 13. the long-stream soak of the flagship
  t0 = time.time()
  sk = soak_phase(dev, wrappers)
  print(smi, flush=True)
  say("soak", t0, gpu=gpu, nvidia_smi=smi, **sk,
      total_seconds=round(time.time() - t_all, 1))
  if sk["problems"] or sk["report"]["frames"] != SOAK_FRAMES:
    raise AssertionError(f"soak unhealthy: {sk['problems']}")
  if sk["launches"] != sk["launches_expected"]:
    raise AssertionError(f"soak launches {sk['launches']}, expected "
                         f"{sk['launches_expected']}")

  # 14. the mesh: the fleet split, data parallelism, width sharding
  t0 = time.time()
  mesh_checks, mesh_times, mesh_launches = mesh_phase(
      dev, wrappers, params, cfg, conv_cfg, cfg32, K)
  print(smi, flush=True)
  about = mesh_checks.pop("mesh")
  say("mesh", t0, gpu=gpu, nvidia_smi=smi, mesh=about,
      times=mesh_times, times_note=(
          "entries on distinct GPUs; one_device beside"
          if about["distinct_devices"] else
          "the entries share one card: not scaling figures"),
      tol={"path": TOL_PATH, "dp_loss_rtol": DP_LOSS_RTOL,
           "dp_params_atol": DP_PARAMS_ATOL, "cost_volume_atol": CV_ATOL,
           "spatial": GOLDEN}, **mesh_checks,
      total_seconds=round(time.time() - t_all, 1))
  check_mesh(mesh_checks, mesh_times)

  # 15. the study tools at full width
  t0 = time.time()
  st, study_launches = study_phase(dev, wrappers)
  print(smi, flush=True)
  say("study", t0, gpu=gpu, nvidia_smi=smi, tol={"path": TOL_PATH}, **st,
      total_seconds=round(time.time() - t_all, 1))
  check_study(st)

  # 16. the root entry points' counterpart: entry() and dryrun_multichip
  t0 = time.time()
  ge, ge_launches = graft_entry_phase(dev, wrappers)
  print(smi, flush=True)
  say("graft_entry", t0, gpu=gpu, nvidia_smi=smi,
      tol={"path": TOL_PATH, "graphed_vs_eager": GRAPH_TOL}, **ge,
      total_seconds=round(time.time() - t_all, 1))
  check_graft_entry(ge)

  bad = [m for m in FORBIDDEN if m in sys.modules]
  if bad:
    raise AssertionError(f"imported {bad}")
  b1, b4 = step["B1_60x80_r4"], step["B4_60x80_r4"]
  # each path's launches, its counts set to 0 just before it
  by_phase = {"slice_full_width": slice_launches,
              "slice_conv_kernels": conv_launches,
              "sequence_default": forms["graphed"]["launches"],
              "sequence_conv_kernels": conv_forms["graphed"]["launches"],
              "pretrained": pre["launches"],
              "train": train_launches,
              **{f"pretrained_{s}_{k}": v["launches"]
                 for s, st in full.items()
                 for k, v in st["configs"].items()},
              **{f"winograd_{s}_{k}": v["launches"]
                 for s, st in wg["stages"].items()
                 for k, v in st["run_filter"].items()},
              "data_train_kfnet": cli_kf["launches"],
              "eval_acceptance": ev["acceptance"]["first"]["launches"],
              "eval_flagship": ev["flagship_cli"]["batch"]["launches"],
              "eval_flagship_streaming":
                  ev["flagship_cli"]["streaming"]["launches"],
              "eval_flagship_uint8":
                  ev["flagship_cli"]["uint8_streaming"]["launches"],
              "soak": sk["launches"],
              **{f"fleet_{k}": v["launches"]
                 for k, v in fleet_checks.items()},
              **mesh_launches, **study_launches, **ge_launches}
  phase_launches = lambda k: {p: v[k] for p, v in by_phase.items()}
  solves_by_phase = {"slice_full_width": slice_solves,
                     "slice_conv_kernels": conv_solves,
                     **{f"fleet_{k}": v["pose_solves"]
                        for k, v in fleet_checks.items()}}
  solve_launches = lambda k: {p: v[k] for p, v in solves_by_phase.items()}
  print(json.dumps({"kernels": [{
      # the fused update: the main path's heads-in entry, one 60x80 map
      # (ms and plain_ms back to back, alone_ms its wrapper in a graph);
      # the same at four maps, and the TPU kernel's contract entry, beside
      "name": "fused_warp_kalman", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/fused_filter.cu",
      "replaces": "kfnet_tpu/kernels/fused_filter.py:44",
      "launches": launches,
      "launches_by_phase": phase_launches("fused_warp_kalman"),
      "max_abs_err": step_errs["B1_60x80_r4"]["max_abs_err"],
      "ms": b1["ms"], "plain_ms": b1["plain_ms"],
      "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
      "library_ms": None,
      "alone_ms": b1["alone_ms"], "library_alone_ms": None,
      "alone_ms_batch4": b4["alone_ms"], "bound_ms_batch4": b4["bound_ms"],
      "ms_batch4": b4["ms"],
      "launches_removed_per_frame": removed,
      "warp_kalman_entry": fwk}, {
      # conv kernels: times summed over one filter-step frame's calls;
      # ms, plain_ms and library_ms back to back per distinct shape,
      # alone_ms and library_alone_ms device times of the served calls
      "name": "conv3x3_same", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/conv3x3.cu",
      "replaces": "kfnet_tpu/kernels/conv3x3.py:31",
      "launches": conv_launches["conv3x3_same"],
      "launches_by_phase": phase_launches("conv3x3_same"),
      "max_abs_err": max(v for k, v in conv_errs["conv3x3_same"].items()
                         if any(k.startswith(str(s)) for s in same_shapes)),
      "ms": same_frame["ms"], "plain_ms": same_frame["plain_ms"],
      "bound_ms": same_frame["bound_ms"],
      "bound_by": same_frame["bound_by"],
      "library_ms": same_frame["cudnn_ms"],
      "alone_ms": alone["conv3x3_same"]["alone_ms"],
      "library_alone_ms": alone["conv3x3_same"]["cudnn_alone_ms"]}, {
      "name": "conv3x3_gn_chain", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/conv3x3.cu",
      "replaces": "kfnet_tpu/kernels/conv3x3.py:57",
      "launches": conv_launches["conv3x3_gn_chain"],
      "launches_by_phase": phase_launches("conv3x3_gn_chain"),
      "max_abs_err": max(v["y"] for k, v in
                         conv_errs["conv3x3_gn_chain"].items()
                         if k in {str(s) for s in chain_shapes}),
      "ms": chain_frame["ms"], "plain_ms": chain_frame["plain_ms"],
      "bound_ms": chain_frame["bound_ms"],
      "bound_by": chain_frame["bound_by"],
      "library_ms": None,
      "alone_ms": alone["conv3x3_gn_chain"]["alone_ms"],
      "library_alone_ms": None}] + [{
      # the pose solve's kernels: one row each, times per served shape
      # (phase "ransac"); no TPU kernel replaced, no library call computes
      # the same function
      "name": stage, "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/ransac.cu", "replaces": None,
      # served: one relocaliser's 8 solves, eager then replayed (phase 5)
      "launches": slice_solves[stage],
      "launches_by_phase": solve_launches(stage),
      **{key: {shape: v["times"][stage][key] for shape, v in rs.items()}
         for key in ("alone_ms", "ms", "plain_ms", "plain_graph_ms",
                     "bound_ms")},
      "bound_by": "bytes", "library_ms": None}
      for stage in ("hypothesize", "score", "pick_and_refine")]}),
        flush=True)
  torch.cuda.synchronize()
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
