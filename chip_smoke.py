#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (semantichuman_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc.  Phases, each of which fails the
run:

1. build: compile every CUDA kernel of the port from `semantichuman_torch/
   csrc/` (one nvcc per source, six sources, in parallel) and print the
   card.
2. the conv forward: at each of the nine full-width conv shapes (the
   bundled 6892-vertex topology's spiral tables), in float32 and bfloat16
   inputs, at B = 1, 12, 16, 64 and 384, hold the forward kernel
   (`csrc/spiral_conv_fwd.cu`, as `spiral_conv` dispatches it) against its
   plain PyTorch version: rtol 1e-4, atol 1e-5 (the only difference is
   the order of f32 sums over K <= 480), an exactly zero dummy row, two
   runs bit-equal.  At B = 64 and 384 time the kernel, the plain version
   and cuBLAS's SGEMM alone on the pre-gathered [B*V1, S*C] buffer in
   turns.
3. serving: build the full-width PartAE from the default ModelConfig (seed
   0, banded_conv on), export a bundle (`torch.export` programs with a
   symbolic batch), load it on the card, answer forward from the programs
   called eagerly (phase 10 holds the captured forward) at B = 1, 16, 64
   and encode -> decode at B = 64 with the launch counts set to 0 just
   before; require per forward the take route
   (SERVE_LAUNCHES["take"]: 9 spiral-conv launches, 10 row gathers), since
   the card's measurements closed both banded gates; finite outputs,
   exactly zero dummy rows, and agreement (atol 1e-4) with the same model
   run through the plain conv on the card, and bit for bit with the same
   params exported with banded_conv off.  Then the forced banded arm: the
   bundle's live model (an exported program keeps the route it was traced
   on) with the gates open to the JAX package's (FORCED_GATES,
   16 and 128), per forward at B <= 16 five banded convs and four banded
   unpools (9 banded-gather forwards, 8 fix-up row gathers) and 4
   spiral-conv launches, at B = 64 nine spiral-conv launches and the four
   banded unpools (3 row gathers), and at every batch the encode's 6 row
   gathers; within atol 1e-4 of the take route.  Then time both routes
   in turns.

4. training kernels, at the training step's full-width shapes (trunk
   batch 384 = three segments of B = 128): the spiral conv's backward
   (dx, dW, db) against autograd of the plain conv at the nine conv
   shapes in float32 and bfloat16, and there the two fused kernels
   (spiral_conv_bwd_dw, spiral_conv_bwd_dx) each alone against its plain
   version (1e-4 of the largest entry, two runs bit-equal) and timed
   beside the unfused route (torch matmuls around the [B, V1, S*C]
   buffers and csr_reduce), whole and half by half, the routes in turns
   (a, b, b, a) with both readings kept; the CSR reduce
   (`csrc/csr_reduce.cu`, row 8) at the shapes of the 17 calls of one
   B = 128 step, recorded from one loss + gradient (the unfused dx at
   level 3, the 4 pools' and the part head's backward, the 4 unpools'
   weighted backward, the loss's 7 gathers with a gradient), and at the
   nine convs' dx shapes at 384 (the stress case of the long dummy row):
   two runs bit-equal, within 1e-5 (1e-4 for a spiral inverse) of the
   plain version's largest entry; device times of the kernel, the plain
   version and `index_add_` beside the byte bound, summed by family; the
   row gather
   (`csrc/row_gather.cu`, row 7) at the step's gathers (the four unpools
   and pool L0 at 384, the face gather at 128; float32 and bfloat16)
   against its plain version (copies bit-equal, weighted sums within 2e-6
   of the largest entry, two runs bit-equal) beside index_select or
   embedding_bag and its byte bound; the part_dist kernel
   (`csrc/part_dist.cu`, modes fwd, fwd_grad, bwd) against its plain
   versions at 17 parts x B = 128, for w_mode threshold, sin and all_one,
   relat on: counts equal exactly, two runs bit-equal; the shares of
   ordered pairs in the mask and of unordered pairs whose two Gram orders
   round otherwise printed; kernel and plain timed in turns.  Errors,
   times and bounds per kernel.
5. the training step: the full-width model from seed 0, `make_train_step`
   with StepFlags(), exc_variant 'ori', EditSampler(seed=0) at epoch 200
   and make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1), three segments
   of B = 128.  One loss+gradient through the kernels and one through the
   plain versions (plain conv, autograd of the plain distance sums) must
   agree; then 10 steps with the launch counts set to 0 just before:
   finite losses and, per step (STEP_LAUNCHES), 9 conv forward, 9 dW, 7
   dx launches (the first conv's input is data, so 8 convs ask for dx;
   the 64 -> 128 conv's takes the unfused route, whose reduction is one
   csr_reduce), 21 row gathers (encode 6, the take route's 4 unpools, the
   loss's 11) and a csr_reduce for each of the 16 with a gradient, and 2
   part_dist fwd_grad launches (0 fwd, 0 bwd).  Then ms/step, meshes/s
   (128 per step, as bench.py counts), the device idle share, the top
   kernels and the device ms by family (torch.profiler: the index_add_
   family must be 0); the step with its gathers swapped back to
   index_select and autograd against the kernels, in turns (ms/step and
   device ms by family, no gate); one bf16-trunk step (finite loss).
   At trunk batch 384 no banded route engages: 0 banded launches.
6. banded kernels, at the trainer's shapes (trunk batch 12 = three
   segments of B = 4, the bundled topology's band tables): every banded
   call of one step of the forced banded arm (convs at levels 0-1 at
   their input widths, unpools into levels 0-3).  The banded-gather forward against its plain version
   (bit-equal unweighted, rtol 1e-6 weighted), its backward (1e-5 of the
   largest entry with the dummy row zeroed, two runs bit-equal) and the
   fix-up row gather (bit-equal to index_select), each timed on the device
   (torch.profiler: these kernels take microseconds, so back-to-back calls
   are paced by the host) beside its plain version, the library call
   (index_select, index_add_) and its bound (bytes moved / 3.35 TB/s).
   Then the two fused backward kernels at the four convs that stay on the
   take route in that arm (enc L2, enc L3, dec L3, dec L2; batch 12 fills the
   dx kernel's batch tiles only partly), float32 and bfloat16: each
   within 1e-4 of the largest entry of its plain version, two runs
   bit-equal.  Then the part_dist kernel's three modes at the Trainer's
   grid (17 parts x B = 4, each tile split over blocks) as in phase 4,
   with fwd_grad's device time.
   Then the CSR reduce at the shapes of one Trainer step's calls (batch
   12, the default take route: the 8 unfused dx, the gathers' backward),
   recorded from one loss + gradient, checked and timed as in phase 4.
7. the Trainer: the paper recipe (Config() defaults: B = 4 per segment,
   lr 1e-3, banded_conv on, both gates closed: the take route) on
   synthetic SMPL-scale data (64 train, 16 test meshes), full width, 3
   epochs with the launch counts set to 0 just before fit(): finite
   falling epoch losses and per step (TRAIN_LAUNCHES) 9 spiral-conv
   forwards and 9 dW, 0 dx (at batch <= 16 every dx half takes the
   unfused route), 21 row gathers (the encode's 6, the unpools' 4, the
   loss's 11), 24 csr_reduce (the 8 unfused dx, the 16 gathers with a
   gradient), 2 part_dist fwd_grad, one row gather and one csr_reduce
   fewer on a step whose skeleton exchange drew 'm' (no volume term);
   plus 9 forward launches and 11 row gathers per validation pass.
   fit() runs as a user's does, with torch's default algorithms, and a
   second fit() from the same seed must give its epoch losses and final
   parameters bit for bit.  Four runs resumed from its epoch-2
   checkpoint, the forced banded arm (FORCED_GATES), the take route, the
   take route, the forced banded arm, repeat epoch 3: its train loss to
   rtol 1e-4 (take) and 1e-3 (banded), and per route
   ms/step (the median of both runs' epoch-3 steps, a synchronize after
   each step), meshes/s (4 a step), s/epoch, the idle share, top kernels
   and families (the index_add_ family must be 0); evaluate once (finite
   l1 and mm).  The same resume gate runs again under torch's
   deterministic algorithms: a fit() there, and two runs resumed from its
   epoch-2 checkpoint, forced banded and take (rtol 1e-3 banded, 1e-4
   take).  All of that drives the loop (`epoch_scan: False`).  Then the
   Trainer's default epoch path (a CUDA graph a step, `train/graph.py`):
   (a) a 3-epoch fit from the same seed must give the loop's epoch losses
   and 24 parameter tensors bit for bit, and a second graph fit the same;
   (b) runs resumed on it from the loop's epoch-2 checkpoint repeat epoch
   3 to the resume gates above; (c) scan_epochs 3 with val_every 4 over 4
   epochs equals one chunk an epoch bit for bit; (d) the launches counted
   while the step is captured are GRAPH_LAUNCHES, the captured step's
   record holds the 9 dW calls in `spiral_conv_dw` and, at each level-0
   conv, more than DW_MIN_REUSE entries read a window row staged, and
   over one replayed epoch the profiler counts each of the port's kernels a whole number of
   times the epoch's 16 steps, the index_add_ family at 0; (e) forced
   banded and take, each on both paths in turns (graph, loop, loop,
   graph), resumed from that checkpoint and timed over two
   more epochs: ms/step, s/epoch with and without validation, device
   busy ms a step, the idle share, the host time of the capture; the
   forced banded arm's captured step launches GRAPH_LAUNCHES_BANDED (9
   banded-gather forwards, 8 backwards).  The rounding of `_foreach_div`
   by a Python float on the card is printed (why Adam takes its per-step
   scalars as a tensor on both paths).
8. training from an on-disk dataset (`phase_dfaust`): the port's
   preprocessing CLIs (make_synthetic at SMPL scale with 64 train and 16
   test meshes, obj2npy, data_generation --n_val 8) in a temporary
   directory, then `cli.train` with configs/train_dfaust.yaml (bf16
   trunk, banded_conv off), only root_dir, asset_dir, n_val and 2 epochs
   set, twice: (a) the stacked layout (staged: the epoch path) and (b)
   data.from_stacked off (FileSource: the loop, its batches through
   prefetch_to_device).  (a) compiles the first train frame's template
   into its workdir, (b) reads it from that cache; finite falling epoch
   losses and a finite test eval on both; launches as GRAPH_LAUNCHES (the
   captured step, its two warm-up steps) or TRAIN_LAUNCHES a step plus
   VAL_LAUNCHES per eval batch; the first host batch of (a) equals (b)'s,
   epoch 1's loss to DFAUST_LOSS_RTOL; ms/step and the idle share of
   both; the port's compile of the bundled synthetic template equals
   assets/topology_synth_full_2222.npz array for array; the seconds of
   the preprocessing and the compiles.
9. the neural3DMM baseline and reference checkpoints (`phase_baseline`):
   (a) `cli.train` with configs/train_neural3dmm.yaml (nz 256, B = 16,
   zeroroot, banded_conv off, f32), only root_dir, asset_dir, n_val,
   3 epochs and the loop (epoch_scan off) set, on phase 8's dataset (preprocessed anew when phase 8 did
   not run), the launch counts set to 0 just before: finite falling epoch
   losses, a finite test eval, per step TRAIN_LAUNCHES_N3DMM (9 conv
   forwards, 9 dW, 0 dx, 9 row gathers, 17 csr_reduce) and per eval
   batch VAL_LAUNCHES_N3DMM; one loss + gradient through the kernels
   against the plain conv (rtol 1e-4, each gradient leaf within 1e-4 of
   its largest entry); ms/step (a synchronize after each step, the median
   of epoch 3), meshes/s, the idle share and the kernel families of one
   profiled epoch (the index_add_ family 0).  Then the file as written,
   whose baseline takes the Trainer's epoch path, on the same dataset,
   the counts set to 0 just before: one capture, graph train/<flags>/ori,
   whose record is TRAIN_LAUNCHES_N3DMM, replayed once a step; launches
   as TRAIN_LAUNCHES_N3DMM for its two warm-up steps and the capture plus
   VAL_LAUNCHES_N3DMM per eval batch; epoch losses and the 22 parameter
   tensors bit-equal to the loop's; ms/step.  (b) for each model family,
   the port's epoch-2 checkpoint (neural3DMM: (a)'s, saved after its
   second epoch; PartAE: phase 7's loop fit at Config() defaults, resumed
   on its epoch path) written in the reference's `.pth.tar` layout
   (`write_reference_checkpoint`: the part heads' pads and their moments
   must be exactly 0) and resumed for epoch 3 through train.resume_torch
   and through train.resume: the epoch-3 loss and every parameter tensor
   equal bit for bit, the launches counted, the host seconds of the
   reference checkpoint's load printed.

10. editing and deployment (`phase_deploy`), at full width (the default
   ModelConfig on the bundled topology) with phase 7's trained parameters
   (in the mode alone PartAE.init(0), and a 2-epoch fit writes the
   checkpoint the CLIs start from): (a) `edit/editor.py:run_demo` at 4
   meshes on the card, launches as counted (DEMO_CALLS of
   ENCODE_LAUNCHES, DECODE_LAUNCHES and KPS_ENCODE_LAUNCHES) and no plain
   version of rows 1 and 7 called on a CUDA tensor, each of the five
   outputs within atol 1e-4 of the same edits through the plain versions
   (the Editor on the CPU, the same parameters), the identity girth edit
   equal to reconstruct bit for bit, `PartAE.kps2skl` on the encoded
   keypoints equal to `ops.skeleton.kps2skl` in its five modes, host ms
   per edit at B = 1 and 4;
   (b) `export_inference` on the card, symbolic, its host seconds, the
   load's and the `.pt2` sizes; the programs called eagerly at B = 1,
   16, 64 (and encode -> decode at 16) with SERVE_LAUNCHES["take"] per
   call, each within atol 1e-5 of the live model; (c) the captured
   forward: the capture counts GRAPH_WARMUPS + 1 forwards and a replay
   none (as read_counts reads them), each replay bit-equal to the eager program, a second call with
   other meshes leaves the first call's outputs as they were; then the
   eager program and the graph in turns (eager, graph, graph, eager) at
   B = 1, 16, 64, ms per forward and the idle share (profiler; the
   replays' kernels as it reads them), and `graph_gate`,
   the rule that set `serving.py:_GRAPH_MAX_B`; (d) `cli.export` from the
   native checkpoint, its forward within 1e-5 of the Trainer's eval step;
   the checkpoint in the reference layout through `cli.eval_reference`
   on the CPU, then on the card with the CPU's numbers as --torch_l1 /
   --torch_mm (exit 0: within 0.5 %), its mm equal to `Trainer.evaluate`
   after resume_torch of the same file to rtol 1e-6; `cli.demo
   --checkpoint_torch` on it writes the five OBJs.

11. data parallelism, the trace window, geometry and the serving dtype A/B
   (`phase_parallel`): (a) two ranks joined by gloo, both on cuda:0 (NCCL
   refuses two ranks on one card), each a `tools/dp_fit.py` process
   through `cli.train --distributed`, the full-width default model at
   global batches of 8 (the paper recipe's 4 a rank), 24 train and 16 test
   synthetic meshes, one epoch of the loop, against the same run in this
   process without a process group: per-step losses within rtol 2e-4,
   parameters within rtol 1e-4, atol 1e-6, the two ranks' parameters bit
   for bit, the val loss within rtol 1e-4, one checkpoint and one
   configuration dump (rank 0 alone writes), and that checkpoint resumed
   by two ranks for epoch 2 within the same tolerances; (b) one rank
   under NCCL bit-equal to the run without a process group; every rank
   within DP_TIMEOUT s, or the phase fails and its processes are killed;
   (c) the B = 4 loop with a trace window over global steps [2, 5): the
   trace file names the kernels of rows 1, 3, 7 and 8 and no plain
   version's, the logged losses equal the untraced fit's
   bit for bit, the window's cost in ms a step; (d) `ops/geometry.py`
   and distance.py's vertex normals and volumes on icosphere(3) (with
   the spectral basis and the biharmonic distance) and on the full-scale
   synthetic template, card against CPU within the CPU tests' tolerances,
   with times; (e) `tools/serving_accuracy.py` on phase 7's epoch-2
   checkpoint: f32 and bf16 arms, each with its own Trainer and inputs,
   a nonzero delta.

12. data-parallel serving and the DFAUST first-contact drill
   (`phase_dp_drill`): (a) the full-width default model (phase 7's
   epoch-2 parameters, in the mode alone PartAE.init(0)) exported once on
   cuda:0 and loaded as a one-device bundle and as two copies on cuda:0
   (`ServingBundle(dir, device=["cuda:0", "cuda:0"])`): at B = 2, 16, 64
   forward, encode and decode, eagerly and then captured, every output
   shard on its copy's device, the gathered outputs within atol 1e-5 of
   the one-device bundle (the largest absolute and relative gaps
   printed), and at each (artifact, B), eager and captured, the JAX
   test's rule allclose(rtol 2e-6, atol 2e-7) read with its count of
   entries outside it; where one fails, `shard_diagnostic` runs the live
   model op by op at B = 1 against row 0 of B = 2 (each conv with its
   tile) and names the first op whose row differs; a captured call
   bit-equal to the eager one; per copy call SERVE_LAUNCHES["take"]
   (encode and decode: their halves) eagerly, GRAPH_WARMUPS + 1 times
   that at the copy's first capture at a shard batch, none on a replay;
   where the process has two cards, the same on [cuda:0, cuda:1] and on
   cuda:1 alone; one copy against two on the one card in turns at B = 64,
   ms per forward, no gate.  (b) on phase 8's dataset (preprocessed anew where
   phase 8 did not run), cli.train with configs/train_dfaust.yaml for 2
   epochs, its epoch-2 state written in the reference layout; the port's
   drill (`semantichuman_torch/tools/dfaust_drill.py`) on the card as a
   subprocess on it with --data_root (exit 0, all six stages) and on a
   copy whose first part head is widened (exit 1, import FAILED, topology
   not), the two started together; the eval stage's mm equal to
   Trainer.evaluate after resume_torch of the same file to rtol 1e-6, the
   demo's five OBJs, the resumed epoch finite on the epoch path, every
   stage's launches as the main paths' literals count them, each stage's
   seconds printed.

The last two lines are a JSON object with each kernel's launches, error and
times, and `{"ok": true, "device": {...}}`.  Without a card it exits 1
before printing any result. `python3 chip_smoke.py --conv-forward` runs
phase 1 and phase 2 alone, `--conv-backward` phase 1 and phase 4's conv
backward alone, each with a per-kernel profile, `--part-dist` phase 1
and the part_dist checks of phases 4 and 6, `--gather-rows` phase 1 and
the row gather's checks of phase 4, `--csr-reduce` phase 1 and the CSR
reduce's checks and times of phases 4 and 6, for tuning those kernels,
`--trainer` phase 1 and phase 7, `--dfaust` phase 1 and phase 8,
`--baseline` phase 1 and phase 9, `--deploy` phase 1 and phase 10,
`--parallel` phase 1 and phase 11, `--drill` phase 1 and phase 12,
`--shard-diagnostic` phase 1 and phase 12 (a)'s diagnostic on its own
(PartAE.init(0)), and `--band-gates` phase 1 and each banded gate
measured on its own against the take route in turns (serving at B = 1,
16, 64, the Trainer's epoch path at trunk 12 and the fast recipe's 128),
the measurement that set both gates: they print no result
line and are no gate.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOPOLOGY = ROOT / "assets" / "topology_synth_full_2222.npz"
BATCH = 64
SERVE_BATCHES = (1, 16, 64)
# phase 2: every batch at which a main path runs the forward kernel --
# serving (1, 16, 64), the Trainer's trunk (12) and validation batch (16),
# the step's trunk (384)
FWD_BATCHES = (1, 12, 16, 64, 384)
FWD_TIMED = (64, 384)
TRAIN_B = 128                  # per segment, as bench.py
TRUNK_B = 3 * TRAIN_B          # the three segments share the trunk
TRAIN_STEPS = 10
TRAINER_B = 4                  # the paper recipe's batch_train/batch_interp
TRAINER_TRUNK_B = 3 * TRAINER_B
DEVICE = "cuda"
KERNEL_COUNTS = ("spiral_conv_fwd", "spiral_conv_bwd_dw",
                 "spiral_conv_bwd_dx", "csr_reduce", "part_dist_fwd",
                 "part_dist_fwd_grad", "part_dist_bwd", "banded_gather_fwd",
                 "banded_gather_bwd", "row_gather")
# row gathers (`ops/row_gather.py:gather_rows`, the row_gather kernel) of
# one encode: the 4 pools and the part and keypoint heads; all but the
# keypoint head's (its input is data) take a gradient, whose backward is
# one csr_reduce each.  Unpool adds 4 on the take route; on the banded
# route it adds its fix-up gathers instead.
ENCODE_GATHERS, ENCODE_GATHER_GRADS = 6, 5
UNPOOL_GATHERS = 4
# the loss's row gathers per step: the keypoint targets of the rec and
# interp segments (2, data), the faces of edgereg and volume (2), the
# non-leaf |z| (1), the two keypoint-consistency terms (2) and the part
# buckets of GT and reconstruction in the distance loss's two calls (4);
# the 7 on the reconstruction or z take a gradient
LOSS_GATHERS, LOSS_GATHER_GRADS = 11, 7
# the batch gates of the banded routes (`ops/spiral_conv.py:_BANDED_MAX_B`
# for the conv, `ops/sampling.py:_UNPOOL_BAND_MAX_B` for unpool) that the
# forced banded arms open: the JAX package's, under which the port ran by
# default until the card's measurements closed both (`--band-gates`)
FORCED_GATES = (16, 128)
# launches per forward of the default model: the take route at every
# batch (both gates closed), 9 convs, the encode's gathers and the 4
# unpools'.  The forced banded arm (FORCED_GATES): at B <= 16 the convs at
# levels 0-1 (5 of 9) and the four unpools take the banded route; every
# banded call but unpool 4->3 (no out-of-band taps) adds a fix-up row
# gather (8).  At 16 < B <= 128 only the unpools do (3).
SERVE_LAUNCHES = {
    "small": {"spiral_conv_fwd": 4, "banded_gather_fwd": 9,
              "row_gather": ENCODE_GATHERS + 8},
    "large": {"spiral_conv_fwd": 9, "banded_gather_fwd": 4,
              "row_gather": ENCODE_GATHERS + 3},
    "take": {"spiral_conv_fwd": 9,
             "row_gather": ENCODE_GATHERS + UNPOOL_GATHERS},
}
# staging a train split on the device (`data/device_data.py`) computes its
# GT loss inputs once: the face gathers of the edge lengths and of the
# part volumes
STAGE_GATHERS = 2
# a step on host batches (a split not staged) computes its GT loss inputs
# itself: the face gathers of the GT edge lengths and, on a step that runs
# the volume term (not 'm'), of the GT part volumes
UNSTAGED_GT_GATHERS = 2
# a Trainer step whose skeleton exchange draws 'm' (exc_mode 'ori_or_m'
# draws 'ori' or 'm' each step) has no volume term: one face gather and
# its backward fewer than TRAIN_LAUNCHES counts
M_VARIANT_FEWER = {"row_gather": 1, "csr_reduce": 1}
# a Trainer validation or test batch (16 meshes): one forward and the
# eval step's keypoint gather; by route as SERVE_LAUNCHES
VAL_LAUNCHES = dict(SERVE_LAUNCHES["take"],
                    row_gather=SERVE_LAUNCHES["take"]["row_gather"] + 1)
VAL_LAUNCHES_BANDED = dict(
    SERVE_LAUNCHES["small"],
    row_gather=SERVE_LAUNCHES["small"]["row_gather"] + 1)
# launches per Trainer step at trunk batch 12, the default (take) route:
# 9 conv forwards and their 9 dW; the 8 dx halves (all but the first
# conv's, whose input is data) take the unfused route at batch <= 16, one
# csr_reduce each; the encode's, the unpools' and the loss's row gathers
# and one csr_reduce per gather with a gradient; the loss's two part_dist
# fwd_grad calls.
TRAIN_LAUNCHES = {"spiral_conv_fwd": 9, "spiral_conv_bwd_dw": 9,
                  "spiral_conv_bwd_dx": 0,
                  "row_gather": ENCODE_GATHERS + UNPOOL_GATHERS
                  + LOSS_GATHERS,
                  "csr_reduce": 8 + ENCODE_GATHER_GRADS + UNPOOL_GATHERS
                  + LOSS_GATHER_GRADS,
                  "part_dist_fwd_grad": 2}
# the same step in the forced banded arm (FORCED_GATES): the forward as
# "small" above plus the loss's gathers; backward through 8 banded calls
# and their 7 fix-up gathers' backward through csr_reduce; the 4
# take-route convs (enc L2, enc L3, dec L3, dec L2) launch 4 dW and 4
# unfused dx.
TRAIN_LAUNCHES_BANDED = {"spiral_conv_fwd": 4, "spiral_conv_bwd_dw": 4,
                         "spiral_conv_bwd_dx": 0, "banded_gather_fwd": 9,
                         "banded_gather_bwd": 8,
                         "row_gather": ENCODE_GATHERS + 8 + LOSS_GATHERS,
                         "csr_reduce": 7 + 4 + ENCODE_GATHER_GRADS
                         + LOSS_GATHER_GRADS,
                         "part_dist_fwd_grad": 2}
# launches per step of the epoch path, recorded while its step is captured
# (train/graph.py): the 'dynamic' exchange variant runs the volume term on
# every step and multiplies it by the step's 'ori' draw, so every step
# launches what a loop step that drew 'ori' does
GRAPH_LAUNCHES = dict(TRAIN_LAUNCHES)
GRAPH_LAUNCHES_BANDED = dict(TRAIN_LAUNCHES_BANDED)
# the least spiral entries a staged window row must serve at a level-0
# conv's dW in the captured step (`spiral_conv_dw`: entries / rows)
DW_MIN_REUSE = 1.5
# launches per B = 128 training step (trunk batch 384, no banded route):
# nine convs forward and their dW; dx for all but the first, whose input
# is data, the 64 -> 128 conv's on the unfused route (one csr_reduce); the
# encode's, the four take-route unpools' and the loss's row gathers, and
# one csr_reduce per gather with a gradient
STEP_LAUNCHES = {"spiral_conv_fwd": 9, "spiral_conv_bwd_dw": 9,
                 "spiral_conv_bwd_dx": 7,
                 "row_gather": ENCODE_GATHERS + UNPOOL_GATHERS + LOSS_GATHERS,
                 "csr_reduce": 1 + ENCODE_GATHER_GRADS + UNPOOL_GATHERS
                 + LOSS_GATHER_GRADS,
                 "part_dist_fwd_grad": 2}
# launches per step of the neural3DMM recipe (configs/train_neural3dmm.yaml:
# B = 16, banded_conv off, so the take route): 9 conv forwards and their
# 9 dW; the 8 dx halves (all but the first conv's, whose input is data)
# take the unfused route at batch <= 16, one csr_reduce each; the 4
# pools', the 4 unpools' and edgereg's face gather of the reconstruction
# are row gathers with a gradient, one csr_reduce each (the GT edge
# lengths come staged with the split)
POOL_GATHERS = 4
N3DMM_GATHERS = POOL_GATHERS + UNPOOL_GATHERS + 1
TRAIN_LAUNCHES_N3DMM = {"spiral_conv_fwd": 9, "spiral_conv_bwd_dw": 9,
                        "spiral_conv_bwd_dx": 0, "row_gather": N3DMM_GATHERS,
                        "csr_reduce": 8 + N3DMM_GATHERS}
# a neural3DMM val or test batch (16 meshes): one forward, its pools and
# unpools
VAL_LAUNCHES_N3DMM = {"spiral_conv_fwd": 9,
                      "row_gather": POOL_GATHERS + UNPOOL_GATHERS}
# phase 10: launches of one encode and one decode of the default model (the
# take route), whose sum is SERVE_LAUNCHES["take"]: encode 4 convs, the 4
# pools and the part and keypoint heads; decode 5 convs and the 4
# unpools.  A pose from explicit keypoints (`Editor.decode_with_kps`)
# adds the keypoint head's gather.
ENCODE_LAUNCHES = {"spiral_conv_fwd": 4, "row_gather": ENCODE_GATHERS}
DECODE_LAUNCHES = {"spiral_conv_fwd": 5, "row_gather": UNPOOL_GATHERS}
KPS_ENCODE_LAUNCHES = {"row_gather": 1}
# `edit/editor.py:run_demo`'s calls: reconstruct (an encode, a decode),
# the orientation transplant (two encodes, a keypoint encode, a decode),
# the bone-length edit (an encode, a keypoint encode, a decode), the girth
# edit (an encode, a decode) and the style transfer (two encodes, a
# decode)
DEMO_CALLS = {"encode": 7, "decode": 5, "kps_encode": 2}
# phase 10's meshes per edit (the demo's 4, and one)
EDIT_BATCHES = (1, 4)
# the warm-up calls `serving.py` makes before it captures a program; the
# counters count them and the capture (and each replay again, which
# read_counts leaves out)
GRAPH_WARMUPS = 2
# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# special-function unit results (square root, reciprocal, the core of
# acos) per second: 16 per clock per SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x 1.98 GHz
PEAK_SFU = 16 * 132 * 1.98e9


# kernel families of the step's profile, by a substring of the kernel name
PROFILE_GROUPS = {"conv_fwd": "sc_fwd_",
                  "conv_bwd_dw": "dw_partial_kernel",
                  "conv_bwd_dw_finish": "dw_finish_kernel",
                  "conv_bwd_dx_short": "dx_short_kernel",
                  "conv_bwd_dx_narrow": "dx_narrow_kernel",
                  "conv_bwd_dx_long": "dx_long_",
                  "csr_reduce": "csr_rows_",
                  "part_dist": "part_dist_rows_",
                  "row_gather": "gather_copy_kernel",
                  "row_gather_sum": "gather_sum_kernel",
                  "gemm": "gemm", "index_add": "indexFunc",
                  "index_select": "indexSelect",
                  "index_elementwise": "index_elementwise",
                  "scatter_gather": "_scatter_gather"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, attempts: int = 5,
              windows: int = 2) -> float:
    """Device time per call of fn(): the summed durations of every kernel
    and copy that `iters` calls ran (torch.profiler), over iters.  Unlike
    time_ms it leaves out the host: back-to-back calls of a kernel of a
    few microseconds are paced by the host's launch rate, not the card.
    The profiler on the chip machine now and then records no device
    activity in a window (once three in a row): such a window is taken
    again with twice the calls.  It also drops part of a window's events
    now and then (one window read half of a part_dist v1 time), which can
    only lower a reading: the time is the larger of `windows` windows."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return time_ms(fn, iters)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us == 0:
            iters *= 2
            continue
        times.append(us / 1e3 / iters)
        if len(times) == windows:
            return max(times)
    raise SmokeFailure(f"the profiler saw device time in {len(times)} of "
                       f"{attempts} windows")


def phase_build() -> str:
    from semantichuman_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log(f"[build] {name}: {path.relative_to(ROOT)}")
        ptxas = path.with_suffix(".log")
        if ptxas.exists():
            entry = ""
            for line in ptxas.read_text().splitlines():
                found = re.search(r"Compiling entry function '(\w+)'", line)
                if found:
                    entry = found.group(1)
                if "registers" in line or "spill" in line:
                    log(f"[build]   {entry} {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[build] card: {card}")
    return card


def conv_layers(model):
    """(label, V1, S, C_in, C_out, activation, spiral table, inverse
    table) of every conv of the model's forward, in order."""
    t = model.tables
    out = []
    for side, plan in (("enc", model.enc_plan), ("dec", model.dec_plan)):
        for lvl, cin, cout, act in plan:
            out.append((f"{side} L{lvl} {cin}->{cout}", t.sizes[lvl] + 1,
                        t.spiral_sizes[lvl], cin, cout, act, t.spirals[lvl],
                        t.spiral_csr[lvl]))
    return out


def bound(b, v1, s, cin, cout, dtype):
    """(ms for the operations, ms for the bytes) of one conv at the card's
    peaks: each input read once, the output written once."""
    es = 2 if dtype == torch.bfloat16 else 4
    flops = 2 * b * v1 * s * cin * cout
    nbytes = (b * v1 * cin * es + s * cin * cout * es + v1 * s * 4
              + cout * 4 + b * v1 * cout * 4)
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def in_turns(fns: dict, iters: int = 3, warmup: int = 1) -> dict:
    """Each fn timed twice (time_ms), the routes in turns a, b, ..., b, a;
    {name: [first reading, second reading]}."""
    order = list(fns.items())
    runs = {k: [] for k in fns}
    for k, fn in order + order[::-1]:
        runs[k].append(time_ms(fn, iters=iters, warmup=warmup))
    return runs


def phase_kernels(model, profile: bool = False):
    """The spiral conv's forward kernel at the nine conv shapes, in float32
    and bfloat16, at B = 1, 12, 16, 64 and 384 (FWD_BATCHES): the dispatched
    kernel (`spiral_conv`'s take route) against the plain version (rtol
    1e-4, atol 1e-5: the same products, f32 sums over K <= 480 in another
    order), an exactly zero dummy row, two runs bit-equal, one counted
    launch a call.  At B = 64 and 384 (FWD_TIMED) the routes are timed in
    turns with both readings kept (`*_runs`): the kernel (`ms`) and, in
    float32, the plain version (`plain_ms`) and cuBLAS's SGEMM alone on
    the pre-gathered [B*V1, S*C] buffer (`gemm_ms`: the yardstick of a
    library GEMM of the same M x K x N, which computes no
    conv and which the port never calls).  `profile` adds the device time
    by kernel of each float32 conv at B = 384."""
    SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the plain and GEMM routes must run in full f32")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows, max_err = [], 0.0
    for b in FWD_BATCHES:
        for label, v1, s, cin, cout, act, spiral, _ in conv_layers(model):
            x = torch.randn((b, v1, cin), generator=gen, device=DEVICE)
            x[:, -1] = 0.0
            w = torch.randn((s * cin, cout), generator=gen, device=DEVICE)
            w /= (s * cin) ** 0.5
            bias = torch.randn((cout,), generator=gen, device=DEVICE) * 0.1
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{label} B={b} {str(dtype).split('.')[-1]}"
                xc, wc = x.to(dtype), w.to(dtype)
                before = read_counts()

                def kernel():
                    return SC.spiral_conv(xc, spiral, wc, bias, act)

                def plain():
                    return SC.spiral_conv_plain(xc, spiral, wc, bias, act)

                got, again, ref = kernel(), kernel(), plain()
                sync()
                got_counts = counts_diff(read_counts(), before)
                require(got_counts["spiral_conv_fwd"] == 2,
                        f"{tag}: launches {got_counts}")
                require(torch.equal(got, again), f"{tag}: two runs differ")
                require(torch.count_nonzero(got[:, -1]) == 0,
                        f"{tag}: dummy row not zero")
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                           msg=lambda m: f"{tag}: {m}")
                err = float((got - ref).abs().max())
                max_err = max(max_err, err)
                plan = SC._fwd_plan(b, v1, cin, s, cout, dtype)
                row = {"layer": label, "batch": b,
                       "dtype": str(dtype).split(".")[-1], "v1": v1, "s": s,
                       "c_in": cin, "c_out": cout, "tile": plan["tile"],
                       "max_abs_err": err}
                del got, again, ref
                if b in FWD_TIMED:
                    fns = {"ms": kernel}
                    g = None
                    if dtype == torch.float32:
                        g = xc.index_select(1, spiral.reshape(-1).long()) \
                            .reshape(b * v1, s * cin)
                        fns.update(plain_ms=plain,
                                   gemm_ms=lambda: torch.matmul(g, wc))
                    iters = 20 if b <= BATCH else 5
                    runs = in_turns(fns, iters=iters, warmup=2)
                    for k, v in runs.items():
                        row[k], row[f"{k}_runs"] = float(np.mean(v)), v
                    ops_ms, bytes_ms = bound(b, v1, s, cin, cout, dtype)
                    row.update(bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms
                               else "bytes", ops_ms=ops_ms, bytes_ms=bytes_ms)
                    log(f"[kernel] {tag:30s} tile {plan['tile']} err={err:.3e}"
                        f" ms kernel {row['ms']:.4f}"
                        + (f" plain {row['plain_ms']:.4f} gemm "
                           f"{row['gemm_ms']:.4f}" if g is not None else "")
                        + f" bound {row['bound_ms']:.4f} ({row['bound_by']})"
                        f" | runs {np.round(runs['ms'], 4).tolist()}")
                    if profile and b == max(FWD_TIMED) and g is not None:
                        log(f"[profile] {tag} forward as dispatched")
                        profile_steps(kernel, row["ms"])
                    del g
                else:
                    log(f"[kernel] {tag:30s} tile {plan['tile']} "
                        f"err={err:.3e}")
                rows.append(row)
            del x, w, bias, xc, wc
        torch.cuda.empty_cache()
    return rows, max_err


def fwd_sums(rows, b: int) -> dict:
    """The nine float32 convs at batch b, summed."""
    f32 = [r for r in rows if r["dtype"] == "float32" and r["batch"] == b]
    keys = ("ms", "plain_ms", "gemm_ms", "bound_ms", "ops_ms", "bytes_ms")
    out = {k: sum(r[k] for r in f32) for k in keys}
    for k in ("ms", "plain_ms", "gemm_ms"):
        out[f"{k}_runs"] = [sum(r[f"{k}_runs"][i] for r in f32)
                            for i in range(2)]
    bf16 = [r for r in rows if r["dtype"] == "bfloat16" and r["batch"] == b]
    out["bf16_ms"] = sum(r["ms"] for r in bf16)
    return out


def serve_route(b: int) -> str:
    return "small" if b <= 16 else "large"


def phase_serving(model, model_take, params, human):
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.ops.spiral_conv import spiral_conv_plain
    from semantichuman_torch.serving import ServingBundle, export_inference

    meshes = human.sample_meshes(max(SERVE_BATCHES), seed=0)
    verts_all = np.concatenate(
        [meshes, np.zeros((len(meshes), 1, 3))], axis=1).astype(np.float32)
    # the exported programs, called eagerly (phase 10 holds the captured
    # forward); the forced banded arm runs the bundle's live model, whose
    # route the gates choose at call time
    with tempfile.TemporaryDirectory() as tmp:
        manifest = export_inference(model, params, human.J_regressor, tmp)
        bundle = ServingBundle(tmp, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        manifest_take = export_inference(model_take, params,
                                         human.J_regressor, tmp)
        bundle_take = ServingBundle(tmp, device="cuda")
    require(manifest["n_vertices"] == len(human.template_verts),
            "manifest vertex count")
    require(manifest["symbolic_batch"] and manifest_take["symbolic_batch"],
            "the bundles' programs must have a symbolic batch")
    require(manifest["banded_conv"] and not manifest_take["banded_conv"],
            "bundles must carry their banded_conv flag")
    v1 = manifest["n_vertices"] + 1
    batches = {b: torch.from_numpy(verts_all[:b]).cuda()
               for b in SERVE_BATCHES}
    for bd in (bundle, bundle_take):
        for b in SERVE_BATCHES:                      # warm-up, not counted
            bd.call("forward", batches[b], graph=False)
    torch.cuda.synchronize()

    # --- the main path, the default bundle (banded_conv on, both gates
    # closed: the take route): counts from 0, read right after -----------
    reset_counts()
    outs = {}
    for b in SERVE_BATCHES:
        before = read_counts()
        outs[b] = bundle.call("forward", batches[b], graph=False)
        torch.cuda.synchronize()
        got = counts_diff(read_counts(), before)
        want = expect(SERVE_LAUNCHES["take"])
        require(got == want, f"forward B={b}: launches {got}, want {want}")
    before = read_counts()
    z, z_kps, _dummy = bundle.call("encode", batches[BATCH], graph=False)
    dec = bundle.call("decode", z, z_kps, graph=False)
    torch.cuda.synchronize()
    got = counts_diff(read_counts(), before)
    require(got == expect(SERVE_LAUNCHES["take"]),
            f"encode+decode: launches {got}")
    launches = read_counts()
    log(f"[serve] main path (default bundle): launches {launches}")

    # the forced banded arm: the same bundle's live model with the gates
    # open to FORCED_GATES, rows 5-6 on their main-path shapes
    reset_counts()
    outs_banded = {}
    with band_gates(*FORCED_GATES):
        for b in SERVE_BATCHES:
            before = read_counts()
            outs_banded[b] = bundle.live("forward", batches[b])
            torch.cuda.synchronize()
            got = counts_diff(read_counts(), before)
            want = expect(SERVE_LAUNCHES[serve_route(b)])
            require(got == want, f"forced banded forward B={b}: launches "
                    f"{got}, want {want}")
    launches_banded = read_counts()
    log(f"[serve] forced banded arm: launches {launches_banded}")

    # the same params exported with banded_conv off: the take route only
    reset_counts()
    outs_take = {}
    for b in SERVE_BATCHES:
        outs_take[b] = bundle_take.call("forward", batches[b], graph=False)
    torch.cuda.synchronize()
    launches_take = read_counts()
    require(launches_take == expect(SERVE_LAUNCHES["take"],
                                    len(SERVE_BATCHES)),
            f"take bundle: launches {launches_take}")
    for b in SERVE_BATCHES:
        for name, got, banded, want in zip(("rec", "z", "z_kps"), outs[b],
                                           outs_banded[b], outs_take[b]):
            # one route, one set of kernels: the same bits
            require(torch.equal(got, want), f"B={b} {name}: the default "
                    "bundle differs from the take bundle")
            err = float((banded - want).abs().max())
            log(f"[serve] forced banded vs take B={b} {name}: max abs err "
                f"{err:.3e}")
            torch.testing.assert_close(banded, want, rtol=0, atol=1e-4)

    for b, (rec, zb, zkb) in outs.items():
        require(rec.shape == (b, v1, 3) and zb.shape == (b, 17, 8)
                and zkb.shape == (b, 17, 8), f"B={b}: output shapes")
        require(all(bool(torch.isfinite(t).all()) for t in (rec, zb, zkb)),
                f"B={b}: non-finite output")
        require(torch.count_nonzero(rec[:, -1]) == 0,
                f"B={b}: rec dummy row not zero")
    require(dec.shape == (BATCH, v1 - 1, 3)
            and bool(torch.isfinite(dec).all()), "decode output")
    # the encoder's dummy feature row is zero, so decode(encode(x)) with a
    # zero dummy is forward(x) without its dummy row
    torch.testing.assert_close(dec, outs[BATCH][0][:, :-1], rtol=0,
                               atol=1e-6)

    # the same model and params through the plain conv on the card
    plain = copy.copy(bundle.model)
    plain.conv_fn = spiral_conv_plain
    kps = np.einsum("jv,bvd->bjd", human.J_regressor,
                    verts_all[:BATCH, :-1])[:, KPS_KEEP]
    with torch.inference_mode():
        ref = plain(bundle.params, batches[BATCH],
                    torch.from_numpy(kps.astype(np.float32)).cuda())
    for name, got, want in zip(("rec", "z", "z_kps"), outs[BATCH], ref):
        err = float((got - want).abs().max())
        log(f"[serve] kernel vs plain conv, {name}: max abs err {err:.3e}")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    # --- timing (after the counted run), the two routes in turns: the
    # default bundle's eager program, and its live model in the forced
    # banded arm --------------------------------------------------------
    serve = {"take": lambda x: bundle.call("forward", x, graph=False),
             "banded": lambda x: bundle.live("forward", x)}

    def wall_ms(fn, b, reps=20):
        for _ in range(3):
            fn(batches[b])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(batches[b])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    timing, timing_banded = {}, {}
    for b in SERVE_BATCHES:
        runs = {"banded": [], "take": []}
        for route in ("banded", "take", "take", "banded"):
            with route_gates(route == "banded"):
                runs[route].append(wall_ms(serve[route], b))
        timing[b], timing_banded[b] = (float(np.mean(runs["take"])),
                                       float(np.mean(runs["banded"])))
        log(f"[serve] forward B={b}: default (take) {runs['take']} ms, "
            f"forced banded {runs['banded']} ms; "
            f"{b / timing[b] * 1e3:.1f} meshes/s default")
    for b in SERVE_BATCHES:
        for route, wall in (("default", timing[b]),
                            ("banded", timing_banded[b])):
            log(f"[profile] serving, {route} route")
            with route_gates(route == "banded"):
                profile_forward(serve["banded" if route == "banded"
                                      else "take"], batches[b], wall)
    return launches, launches_banded, launches_take, timing, timing_banded


def profile_forward(forward, verts, wall_ms: float, reps: int = 5) -> dict:
    """Device time per forward by kernel name (torch.profiler), and the
    share of the unprofiled wall time with no kernel running:
    {"busy_ms", "idle_share", "kernels"} (busy None where the profiler saw
    no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward(verts)
        torch.cuda.synchronize()
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
            calls[e.name] = calls.get(e.name, 0) + 1
    b = verts.shape[0]
    if not by_name:
        log(f"[profile] B={b}: the profiler saw no device kernels; device "
            "time not measured")
        return {"busy_ms": None, "idle_share": None, "kernels": {},
                "calls": {}}
    busy = sum(by_name.values())
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"[profile] B={b}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"per forward, idle share {idle:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:8.4f} ms  {name[:90]}")
    return {"busy_ms": busy, "idle_share": idle, "kernels": by_name,
            "calls": calls}


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def conv_bwd_bound(b, v1, s, cin, cout, dtype):
    """(ms for the operations, ms for the bytes) of one conv's backward:
    the dW and dx products (2 x 2*B*V1*S*C_in*C_out), x, y, dy, W and the
    tables read once, dx, dW and db written once."""
    es = 2 if dtype == torch.bfloat16 else 4
    flops = 4 * b * v1 * s * cin * cout
    nbytes = (b * v1 * cin * es + 2 * b * v1 * cout * 4 + s * cin * cout * es
              + 2 * v1 * s * 4 + b * v1 * cin * 4 + s * cin * cout * 4
              + cout * 4)
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_conv_backward(model, profile: bool = False):
    """The spiral conv's backward (SpiralConvFn) against autograd of the
    plain conv, at the nine conv shapes at trunk batch 384.  float32: max
    |err| <= 1e-4 of the largest entry (the same products summed in
    another order; dW sums 2.6M terms at level 0, the dummy row's dx
    34,041).  bfloat16: the reference is the plain conv in f32 on the
    bf16-rounded x and W, its gradients rounded to bf16 like the kernel
    route's, so the two differ by that f32 order (atol 1e-4 of the
    largest entry) and one bf16 rounding (rtol 2^-7).

    Then the two fused kernels alone, on dy with a zero dummy row: each
    within 1e-4 of the largest entry of its plain version and bit-equal
    over two runs.  Times per conv and type, each the mean of two
    readings taken in turns (a, b, b, a) that are kept beside it
    (`*_runs`, the run's spread): SpiralConvFn.backward's body (dy', db,
    dx, dW and the casts back) with the halves the dispatch table names
    unfused (`ms`), with both fused (`fused_ms`) and with both on the
    unfused route (`unfused_ms`, `spiral_conv_bwd_unfused`: torch matmuls
    around the [B, V1, S*C] buffers and csr_reduce); each half alone,
    fused and unfused; and the plain conv's autograd (`plain_ms`).
    `profile` adds the dispatched float32 backward's device time by kernel
    name."""
    SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for label, v1, s, cin, cout, act, spiral, csr in conv_layers(model):
        x = torch.randn((TRUNK_B, v1, cin), generator=gen, device=DEVICE)
        x[:, -1] = 0.0
        w = torch.randn((s * cin, cout), generator=gen, device=DEVICE)
        w /= (s * cin) ** 0.5
        bias = torch.randn((cout,), generator=gen, device=DEVICE) * 0.1
        dy = torch.randn((TRUNK_B, v1, cout), generator=gen,
                         device=DEVICE) * 0.1
        dyz = dy.clone()
        dyz[:, -1] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            cd = None if dtype == torch.float32 else dtype
            leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
            y = SC.spiral_conv(*leaves[:1], spiral, *leaves[1:], act,
                               compute_dtype=cd, csr=csr)

            def backward():
                return torch.autograd.grad(y, leaves, dy, retain_graph=True)

            got = backward()
            if cd is None:
                ref_in = [t.detach().requires_grad_(True)
                          for t in (x, w, bias)]
            else:
                ref_in = [x.to(cd).float().requires_grad_(True),
                          w.to(cd).float().requires_grad_(True),
                          bias.detach().requires_grad_(True)]
            y_ref = SC.spiral_conv_plain(ref_in[0], spiral, *ref_in[1:], act)
            ref = torch.autograd.grad(y_ref, ref_in, dy, retain_graph=True)
            if cd is not None:
                ref = [r.to(cd).float() for r in ref[:2]] + [ref[2]]
            sync()
            errs = {}
            for name, g, r in zip(("dx", "dw", "db"), got, ref):
                require(g.dtype == torch.float32 and g.shape == r.shape,
                        f"{label} {dtype} {name}: dtype/shape")
                errs[name] = rel_err(g, r)
                # db stays float32 (bias is never cast)
                bf16 = cd is not None and name != "db"
                torch.testing.assert_close(
                    g, r, rtol=2 ** -7 if bf16 else 0,
                    atol=1e-4 * float(r.abs().max()),
                    msg=lambda m: f"{label} {dtype} {name}: {m}")
            del got, ref, y_ref, ref_in

            # --- each kernel alone against its plain version ----------------
            xc, wc = x.to(dtype), w.to(dtype)
            halves = {
                "dw": (lambda: SC.spiral_conv_bwd_dw(xc, spiral, dyz),
                       lambda: SC.spiral_conv_bwd_dw_plain(xc, spiral, dyz),
                       lambda: SC.spiral_conv_bwd_unfused(
                           xc, wc, dyz, spiral, csr, need_x=False)),
                "dx": (lambda: SC.spiral_conv_bwd_dx(dyz, wc, csr, (v1, s)),
                       lambda: SC.spiral_conv_bwd_dx_plain(dyz, wc, csr,
                                                           (v1, s)),
                       lambda: SC.spiral_conv_bwd_unfused(
                           xc, wc, dyz, spiral, csr, need_w=False))}
            row = {"layer": label, "dtype": str(dtype).split(".")[-1],
                   "rel_err": errs}
            for name, (kernel, plain, unfused) in halves.items():
                a, again, r = kernel(), kernel(), plain()
                sync()
                require(torch.equal(a, again),
                        f"{label} {dtype} {name} kernel: two runs differ")
                torch.testing.assert_close(
                    a, r, rtol=0, atol=1e-4 * float(r.abs().max()),
                    msg=lambda m: f"{label} {dtype} {name} kernel: {m}")
                row[f"{name}_kernel_max_abs_err"] = float((a - r).abs().max())
                row[f"{name}_kernel_rel_err"] = rel_err(a, r)
                del a, again, r
                runs = in_turns({f"{name}_ms": kernel,
                                 f"{name}_unfused_ms": unfused})
                for k, v in runs.items():
                    row[k], row[f"{k}_runs"] = float(np.mean(v)), v

            # --- the whole backward: dispatched, fused, unfused, plain ------
            y_out = y.detach()

            def body(unfused):
                # SpiralConvFn.backward with the route given
                dyp = SC._dy_prime(dy, y_out, act)
                db = dyp.sum(dim=(0, 1))
                dx, dw = SC._conv_backward(xc, wc, dyp, spiral, csr, True,
                                           True, unfused)
                return dx.to(dtype), dw.to(dtype), db

            dispatched = SC._unfused_halves(xc, wc, spiral)
            runs = in_turns({"ms": lambda: body(dispatched),
                             "fused_ms": lambda: body(()),
                             "unfused_ms": lambda: body(("dx", "dw"))})
            for k, v in runs.items():
                row[k], row[f"{k}_runs"] = float(np.mean(v)), v
            if profile and cd is None:
                log(f"[profile] {label} backward as dispatched")
                profile_steps(backward, row["ms"])
            plain_in = [t.detach().requires_grad_(True) for t in (x, w, bias)]
            y_pl = SC.spiral_conv_plain(plain_in[0], spiral, *plain_in[1:],
                                        act, compute_dtype=cd)
            row["plain_ms"] = time_ms(lambda: torch.autograd.grad(
                y_pl, plain_in, dy, retain_graph=True), iters=3, warmup=1)
            ops_ms, bytes_ms = conv_bwd_bound(TRUNK_B, v1, s, cin, cout,
                                              dtype)
            row.update(bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes", ops_ms=ops_ms, bytes_ms=bytes_ms,
                       unfused_halves=list(dispatched))
            rows.append(row)
            log(f"[conv-bwd] {label:18s} {row['dtype']:8s} rel err dx "
                f"{errs['dx']:.2e} dw {errs['dw']:.2e} db {errs['db']:.2e} "
                f"kernels dx {row['dx_kernel_rel_err']:.2e} dw "
                f"{row['dw_kernel_rel_err']:.2e} | ms dispatched "
                f"{row['ms']:.3f} fused {row['fused_ms']:.3f} unfused "
                f"{row['unfused_ms']:.3f} plain {row['plain_ms']:.3f} bound "
                f"{row['bound_ms']:.3f} ({row['bound_by']}) | dw "
                f"{row['dw_ms']:.3f}/{row['dw_unfused_ms']:.3f} dx "
                f"{row['dx_ms']:.3f}/{row['dx_unfused_ms']:.3f} "
                f"fused/unfused | runs dispatched "
                f"{np.round(row['ms_runs'], 3).tolist()} fused "
                f"{np.round(row['fused_ms_runs'], 3).tolist()} unfused "
                f"{np.round(row['unfused_ms_runs'], 3).tolist()}")
            del y, y_out, y_pl, leaves, plain_in, xc, wc
    return rows


def csr_families(model) -> dict:
    """id of each CSR table of the model -> (family, label): the spiral
    inverses (the unfused dx), the pools' and unpools' gather inverses,
    the part head's, and the banded routes' fix-ups.  Any other table a
    step reduces over is one of the loss's gathers."""
    t = model.tables
    fam = {id(csr): ("dx", f"dx L{lvl}")
           for lvl, csr in enumerate(t.spiral_csr)}
    for lvl, g in enumerate(t.pool_gather):
        fam[id(g.inverse)] = ("pool", f"pool {lvl}->{lvl + 1}")
    for lvl, g in enumerate(t.unpool_gather):
        fam[id(g.inverse)] = ("unpool", f"unpool {lvl + 1}->{lvl}")
    fam[id(model.part_gather.inverse)] = ("part head", "part head")
    for kind, bands in (("conv", t.bands), ("unpool", t.unpool_bands)):
        for lvl, band in enumerate(bands):
            if band is not None and band.fix is not None:
                fam[id(band.fix.inverse)] = ("fix-up",
                                             f"fix-up {kind} L{lvl}")
    return fam


def capture_csr_calls(model, run) -> list:
    """Every csr_reduce call of run(), in order: family, label, g's shape,
    table and weights.  It wraps the name csr_reduce in the two modules
    that call it (the gathers' backward, the unfused dx) for the length
    of run(), which still goes through the kernel."""
    from semantichuman_torch.ops import row_gather as RG
    SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

    fam = csr_families(model)
    calls, real = [], (RG.csr_reduce, SC.csr_reduce)

    def record(g, table, wt=None):
        family, label = fam.get(id(table), ("loss", "loss gather"))
        calls.append({"family": family, "label": label,
                      "shape": tuple(g.shape), "table": table, "wt": wt})
        return real[0](g, table, wt)

    RG.csr_reduce = SC.csr_reduce = record
    try:
        run()
    finally:
        RG.csr_reduce, SC.csr_reduce = real
    return calls


def step_csr_calls(model, human, tables, b: int | None = None) -> list:
    """The csr_reduce calls of one loss + gradient of the training step at
    B = b per segment (TRAIN_B if None; trunk batch 3b), exchange variant
    'ori', StepFlags() and the edit spec of phase 5."""
    from semantichuman_torch.train.edits import EditSampler
    from semantichuman_torch.train.step import (StepFlags, make_loss_fn,
                                                to_device, value_and_grad)

    b = TRAIN_B if b is None else b
    params = model.init(0)
    segs = [host_batch(human, tables, seed=s, b=b) for s in range(3)]
    spec = to_device(EditSampler(seed=0).sample_interp(200, b), DEVICE)
    loss_fn = make_loss_fn(model, tables, StepFlags(), "ori")
    calls = capture_csr_calls(
        model, lambda: value_and_grad(loss_fn, params, *segs, spec))
    sync()
    return calls


def csr_bound_ms(table, wt, b: int, c: int) -> float:
    """Row 8's byte bound: each row of g the table reads, read once, each
    output row written once, the offsets, columns and weights read
    once."""
    n_read = int(torch.unique(table.cols).numel())
    nnz = int(table.cols.numel())
    nbytes = (b * (n_read + table.n_rows) * c * 4
              + (table.n_rows + 1 + nnz * (1 if wt is None else 2)) * 4)
    return nbytes / PEAK_BYTES * 1e3


CSR_SUMS = ("ms", "plain_ms", "library_ms", "bound_ms")


def csr_checks(calls, tag: str, seed: int) -> list:
    """Row 8 at each call's shape, on g drawn from `seed`: the kernel
    equals itself over two runs and lies within 1e-5 of the plain
    version's largest entry (1e-4 for a spiral inverse, whose dummy row
    sums up to 34,041 rows: index_add_ adds the same terms in its own
    order); one counted launch a call.  Device ms (device_ms) of the
    kernel (the mean of two readings, both kept), of the plain version
    and of `index_add_` (the library call; the gathered, weighted source
    rows made before it), beside the byte bound."""
    from semantichuman_torch.ops import csr_reduce as TR

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows = []
    for call in calls:
        table, wt = call["table"], call["wt"]
        b, m, c = call["shape"]
        g = torch.randn((b, m, c), generator=gen, device=DEVICE)
        name = (f"{tag} {call['label']} [{b}, {m}, {c}]"
                + (" weighted" if wt is not None else ""))
        before = read_counts()
        got = TR.csr_reduce(g, table, wt)
        again = TR.csr_reduce(g, table, wt)
        ref = TR.csr_reduce_plain(g, table, wt)
        sync()
        n = counts_diff(read_counts(), before)
        require(n["csr_reduce"] == 2, f"csr {name}: launches {n}")
        require(torch.equal(got, again), f"csr {name}: two runs differ")
        tol = 1e-4 if call["family"] == "dx" else 1e-5
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()),
                                   msg=lambda s: f"csr {name}: {s}")
        row = {"family": call["family"], "call": call["label"], "batch": b,
               "m": m, "n_rows": table.n_rows, "c": c,
               "weighted": wt is not None,
               "long_rows": int(table.long_rows.numel()),
               "max_abs_err": float((got - ref).abs().max())}
        del got, again, ref
        runs = [device_ms(lambda: TR.csr_reduce(g, table, wt))
                for _ in range(2)]
        src = g.index_select(1, table.cols.long())
        if wt is not None:
            src = src * wt[:, None]
        row["ms"], row["ms_runs"] = float(np.mean(runs)), runs
        row.update(
            plain_ms=device_ms(lambda: TR.csr_reduce_plain(g, table, wt)),
            library_ms=device_ms(lambda: torch.zeros(
                (b, table.n_rows, c), device=DEVICE).index_add_(
                    1, table.rows, src)),
            bound_ms=csr_bound_ms(table, wt, b, c), bound_by="bytes")
        log(f"[csr] {name:44s} err={row['max_abs_err']:.3e} device ms "
            f"kernel {row['ms']:.4f} plain "
            f"{row['plain_ms']:.4f} index_add_ {row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} "
            f"({100 * row['bound_ms'] / row['ms']:.0f} % of it) | runs "
            f"{np.round(runs, 4).tolist()}")
        rows.append(row)
        del g, src
    torch.cuda.empty_cache()
    return rows


def csr_family_sums(rows) -> dict:
    """Row 8's timed calls summed by family: calls and CSR_SUMS."""
    fams = {}
    for r in rows:
        f = fams.setdefault(r["family"], {"calls": 0,
                                          **{k: 0.0 for k in CSR_SUMS}})
        f["calls"] += 1
        for k in CSR_SUMS:
            f[k] += r[k]
    return fams


def phase_csr_reduce(model, human, tables):
    """Row 8 at the shapes of the 17 calls of one B = 128 step (recorded
    from one loss + gradient: STEP_LAUNCHES' csr_reduce count) and at the
    nine convs' dx shapes ([384, V1*S, C_in] over the inverse spiral
    tables, the stress case of the long dummy row), checked and timed by
    csr_checks.  Returns (the step's rows, the dx rows)."""
    calls = step_csr_calls(model, human, tables)
    require(len(calls) == STEP_LAUNCHES["csr_reduce"],
            f"one step recorded {len(calls)} csr_reduce calls, "
            f"STEP_LAUNCHES counts {STEP_LAUNCHES['csr_reduce']}")
    step_rows = csr_checks(calls, "step", seed=2)
    for fam, f in csr_family_sums(step_rows).items():
        log(f"[csr] step family {fam:9s} {f['calls']:2d} calls: device ms "
            f"kernel {f['ms']:.4f} plain "
            f"{f['plain_ms']:.4f} index_add_ {f['library_ms']:.4f} bound "
            f"{f['bound_ms']:.4f}")
    dx_calls = [{"family": "dx", "label": f"dx {label}",
                 "shape": (TRUNK_B, v1 * s, cin), "table": csr, "wt": None}
                for label, v1, s, cin, _co, _a, _sp, csr in conv_layers(model)]
    dx_rows = csr_checks(dx_calls, "conv", seed=3)
    return step_rows, dx_rows


def phase_csr_trainer(model, human, tables):
    """Row 8 at the shapes of one Trainer step's calls (trunk batch 12,
    the default take route: the unfused dx, the gathers' backward),
    recorded from one loss + gradient, checked and timed by csr_checks."""
    calls = step_csr_calls(model, human, tables, b=TRAINER_B)
    log(f"[csr] one Trainer step (trunk {TRAINER_TRUNK_B}, 'ori'): "
        f"{len(calls)} csr_reduce calls (TRAIN_LAUNCHES counts "
        f"{TRAIN_LAUNCHES['csr_reduce']})")
    rows = csr_checks(calls, "trainer", seed=8)
    for fam, f in csr_family_sums(rows).items():
        log(f"[csr] trainer family {fam:9s} {f['calls']:2d} calls: device "
            f"ms kernel {f['ms']:.4f} bound "
            f"{f['bound_ms']:.4f}")
    return rows


def gather_calls(model, tables):
    """(label, batch, source rows, gather table, C) of row 7's main-path
    calls at the training step's shapes: the four take-route unpools at
    trunk batch 384 (T = 3, weighted; the width entering each level), the
    level-0 pool at 384 (C = 16) and the edgereg face gather on B = 128
    reconstructions (C = 3)."""
    t = model.tables
    calls = []
    for lvl in range(t.n_levels - 2, -1, -1):
        c = next(cin for lv, cin, _co, _a in model.dec_plan if lv == lvl)
        calls.append((f"unpool {lvl + 1}->{lvl}", TRUNK_B,
                      t.sizes[lvl + 1] + 1, t.unpool_gather[lvl], c))
    c0 = [co for lv, _ci, co, _a in model.enc_plan if lv == 0][-1]
    calls.append(("pool 0->1", TRUNK_B, t.sizes[0] + 1, t.pool_gather[0],
                  c0))
    calls.append(("faces", TRAIN_B, t.sizes[0], tables.faces, 3))
    return calls


def gather_bound_ms(table, b: int, c: int, es: int) -> float:
    """Row 7's byte bound: each distinct source row read once, each output
    written once, and the index and weights read once."""
    n_read = int(torch.unique(table.idx).numel())
    taps = table.taps
    nbytes = (b * (n_read + table.n_rows) * c * es
              + table.n_rows * taps * 4 * (2 if table.w is not None else 1))
    return nbytes / PEAK_BYTES * 1e3


def gather_library(x, table):
    """One PyTorch call of the same function, its inputs prepared before:
    index_select at T = 1; at T = 3 embedding_bag (mode sum with the taps'
    weights as per-sample weights) over x viewed as [B*N, C], with the
    index offset per batch element."""
    b, n, c = x.shape
    if table.taps == 1 and table.w is None:
        idx = table.idx.long()
        return lambda: x.index_select(1, idx)
    if table.taps == 1:
        return None
    off = (torch.arange(b, device=x.device) * n)[:, None, None]
    bags = (table.idx.long()[None] + off).reshape(-1, table.taps)
    psw = table.w.repeat(b, 1)
    flat = x.reshape(b * n, c)
    return lambda: torch.nn.functional.embedding_bag(
        bags, flat, per_sample_weights=psw, mode="sum")


def phase_gather_rows(model, tables):
    """Row 7 at the step's shapes (gather_calls), float32 and bfloat16:
    the kernel against its plain version, copies bit-equal and weighted
    sums within 2e-6 of the plain version's largest entry (both round each
    product and sum in tap order), two runs bit-equal.  Device times
    (device_ms) of the kernel, the plain version and, in float32, the
    library call (gather_library), beside the byte bound.  Row 8 at the
    unpools' backward is phase_csr_reduce's."""
    from semantichuman_torch.ops import row_gather as RG

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = []
    for label, b, n, table, c in gather_calls(model, tables):
        x32 = torch.randn((b, n, c), generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            tag = f"{label} B={b} C={c} {str(dtype).split('.')[-1]}"

            def kernel():
                return RG.gather_rows_fwd(x, table.idx, table.w)

            def plain():
                return RG.gather_rows_plain(x, table.idx, table.w)

            got, again, ref = kernel(), kernel(), plain()
            sync()
            require(torch.equal(got, again), f"gather {tag}: runs differ")
            weighted = table.w is not None or table.taps > 1
            if weighted:
                torch.testing.assert_close(
                    got.float(), ref.float(), rtol=2e-6,
                    atol=2e-6 * float(ref.float().abs().max()),
                    msg=lambda m: f"gather {tag}: {m}")
            else:
                require(torch.equal(got, ref), f"gather {tag}: not equal")
            row = {"call": label, "batch": b, "c": c, "taps": table.taps,
                   "weighted": table.w is not None,
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": float((got.float() - ref.float())
                                        .abs().max()),
                   "ms": device_ms(kernel), "plain_ms": device_ms(plain),
                   "bound_ms": gather_bound_ms(table, b, c,
                                               x.element_size()),
                   "bound_by": "bytes", "library_ms": None}
            lib = gather_library(x, table) if dtype == torch.float32 \
                else None
            if lib is not None:
                torch.testing.assert_close(
                    lib().reshape(got.shape), ref, rtol=1e-5,
                    atol=1e-5 * float(ref.abs().max()))
                row["library_ms"] = device_ms(lib)
            rows.append(row)
            log(f"[gather] {tag:34s} err={row['max_abs_err']:.3e} device ms"
                f" kernel {row['ms']:.4f} plain {row['plain_ms']:.4f} "
                f"library {row['library_ms']} bound {row['bound_ms']:.4f} "
                f"({100 * row['bound_ms'] / row['ms']:.0f} % of it)")
            del got, again, ref, x
        del x32
    torch.cuda.empty_cache()
    return rows


def part_dist_case(human, w_mode, batch: int = TRAIN_B):
    """The interp-branch inputs of the part_dist kernels at `batch` (the
    step's 128 or the Trainer's 4): one bucket of 17 parts (n_pad 408), as
    the loss stacks them."""
    from semantichuman_torch.ops.part_dist import (PartDistTables,
                                                   _stack_parts)
    from semantichuman_torch.train.edits import EditSampler
    from semantichuman_torch.train.losses import (build_loss_tables,
                                                  part_bones, regress_kps)

    tables = build_loss_tables(human.template_faces, human.J_regressor,
                               human.part_dict, device=DEVICE)
    ptab = PartDistTables(tables.part_indices, True, w_mode, DEVICE)
    require(len(ptab.buckets) == 1 and ptab.buckets[0]["n_pad"] == 408,
            "expected one part bucket of n_pad 408")
    bk = ptab.buckets[0]
    rng = np.random.default_rng(3)
    tx = human.sample_meshes(batch, seed=3).astype(np.float32)
    rec = (tx + rng.normal(0, 0.01, tx.shape)).astype(np.float32)
    tx_t = torch.from_numpy(tx).to(DEVICE)
    rec_t = torch.from_numpy(rec).to(DEVICE)
    bones = part_bones(regress_kps(tx_t, tables.j_regressor))
    pc = bk["part_ids"].shape[0]
    a_full = EditSampler(seed=0).sample_interp(200, batch)["a_full"]
    a = torch.from_numpy(a_full).to(DEVICE).index_select(
        1, bk["part_ids"]).t().contiguous()
    bone = bones.index_select(1, bk["part_ids"]).transpose(0, 1) \
        .reshape(pc * batch, 3).contiguous()
    return (_stack_parts(tx_t, bk["gather"], pc, 408),
            _stack_parts(rec_t, bk["gather"], pc, 408), bone, a,
            bk["n_real"], bk["allone"])


def part_dist_bound(args, counts, asym, mode, w_mode):
    """(ms for the f32 operations, ms for the special-function operations)
    of one call on this run's data, counting the least work: one
    evaluation per unordered pair j < k, plus one more for each pair whose
    two Gram orders round otherwise (`asym`, per tile).  An evaluation
    takes the GT Gram distance (a dot product, the Gram sum, relu: ~9 f32
    operations and a square root), the cosine against the bone (a divide,
    ~6 f32) and the weight (acos on the SFU where the threshold keeps the
    pair, for every pair in linear mode, a square root in sin mode; none
    on a uniform part), de and the mask (~5 f32).  Each evaluation in the
    mask (the ordered count over two, scaled by evaluations / pairs) adds
    the reconstruction's distance, q and the sums (~16 f32; a square root
    and a divide), and with the gradient ~10 f32 and two divides (w / de,
    g / de_r).  Both kernels evaluate every ordered pair, about twice this
    least work."""
    _vp, _rp, _bone, _a, n_real, allone = args
    batch = _vp.shape[0] // n_real.shape[0]
    n = n_real.double().repeat_interleave(batch)
    uniform = allone.double().repeat_interleave(batch)
    if w_mode == "all_one":
        uniform = torch.ones_like(uniform)
    pairs = n * (n - 1) / 2
    evals = pairs + asym.double()
    masked = counts.double() / 2 * evals / pairs.clamp_min(1)
    grad = mode != "fwd"
    flops = float((evals * 20 + masked * (16 + (10 if grad else 0))).sum())
    weight = {"threshold": masked, "linear": evals, "sin": evals,
              "all_one": 0 * evals}[w_mode]
    sfu = float((evals + (1 - uniform) * (evals + weight)
                 + masked * (2 + (2 if grad else 0))).sum())
    return flops / PEAK_FLOPS[torch.float32] * 1e3, sfu / PEAK_SFU * 1e3


def part_dist_modes(args, consts, ct, tag: str, times: bool):
    """The three modes of the kernel against their plain versions on one
    input: counts equal exactly, term sums rtol 1e-5 (f32 sums of ~165k
    pair terms per tile in another order), g0 and drp to 1e-4 of the
    largest entry (rows of ~400 terms of either sign, summed in another
    order), two runs bit-equal.  With `times`, kernel and plain in turns
    (kernel, plain, plain, kernel).  Returns {mode: row}."""
    from semantichuman_torch.ops.part_dist import (part_dist_call,
                                                   part_dist_plain)

    out = {}
    for mode in ("fwd", "fwd_grad", "bwd"):
        kw = {"ct": ct} if mode == "bwd" else {}
        got = part_dist_call(mode, *args, *consts, **kw)
        again = part_dist_call(mode, *args, *consts, **kw)
        ref = part_dist_plain(*args, *consts, mode=mode, **kw)
        sync()
        where = f"part_dist {mode} {tag}"
        require(all(torch.equal(x, y) for x, y in zip(
            got if isinstance(got, tuple) else (got,),
            again if isinstance(again, tuple) else (again,))),
            f"{where}: two runs differ")
        # fwd -> sums, fwd_grad -> (sums, g0), bwd -> drp
        sums_got, grad_got = {"fwd": (got, None), "bwd": (None, got)
                              }.get(mode, got)
        sums_ref, grad_ref = {"fwd": (ref, None), "bwd": (None, ref)
                              }.get(mode, ref)
        err = {"max_abs": 0.0}
        if sums_got is not None:
            d = (sums_got[:, 0] - sums_ref[:, 0]).abs()
            err["max_abs"] = float(d.max())
            err["sums_rtol"] = float((d / sums_ref[:, 0].abs()
                                      .clamp_min(1e-30)).max())
            torch.testing.assert_close(
                sums_got[:, 0], sums_ref[:, 0], rtol=1e-5, atol=0,
                msg=lambda m: f"{where} sums: {m}")
            require(torch.equal(sums_got[:, 1], sums_ref[:, 1]),
                    f"{where}: counts differ from the plain version's")
        if grad_got is not None:
            err["grad"] = rel_err(grad_got, grad_ref)
            err["max_abs"] = max(err["max_abs"], float(
                (grad_got - grad_ref).abs().max()))
            torch.testing.assert_close(
                grad_got, grad_ref, rtol=0,
                atol=1e-4 * float(grad_ref.abs().max()),
                msg=lambda m: f"{where} grad: {m}")
        if sums_ref is None:
            sums_ref = part_dist_plain(*args, *consts, mode="fwd")
        row = {"mode": mode, "err": err, "counts": sums_ref[:, 1]}
        del got, again, ref
        if times:
            runs = in_turns({
                "ms": lambda: part_dist_call(mode, *args, *consts, **kw),
                "plain_ms": lambda: part_dist_plain(*args, *consts,
                                                    mode=mode, **kw)},
                iters=5)
            row.update({k: float(np.mean(v)) for k, v in runs.items()})
            row.update({f"{k}_runs": v for k, v in runs.items()})
        out[mode] = row
    return out


def phase_part_dist(human):
    """The three part_dist modes against their plain versions at 17 parts
    x B = 128 (w_mode threshold, sin and all_one, relat on): see
    part_dist_modes.  The shares of ordered pairs in the mask and of
    unordered pairs whose two Gram orders round otherwise
    (asymmetric_pairs) are printed."""
    from semantichuman_torch.ops.part_dist import asymmetric_pairs

    rows = []
    for w_mode in ("threshold", "sin", "all_one"):
        args = part_dist_case(human, w_mode)
        consts = (w_mode, 0.8, True)
        ct = torch.linspace(0.5, 1.5, args[0].shape[0], device=DEVICE)
        asym = asymmetric_pairs(*args, *consts[:2])
        n = args[4].double().repeat_interleave(TRAIN_B)
        pairs = float((n * (n - 1) / 2).sum())
        for mode, r in part_dist_modes(args, consts, ct, w_mode,
                                       times=True).items():
            counts = r.pop("counts")
            ops_ms, sfu_ms = part_dist_bound(args, counts, asym, mode,
                                             w_mode)
            r.update({"w_mode": w_mode, "bound_ms": max(ops_ms, sfu_ms),
                      "bound_by": "operations", "flop_ms": ops_ms,
                      "sfu_ms": sfu_ms,
                      "masked_pairs": float(counts.sum()),
                      "masked_share": float(counts.sum()) / (2 * pairs),
                      "asymmetric_pairs": float(asym.sum()),
                      "asymmetric_share": float(asym.sum()) / pairs})
            rows.append(r)
            log(f"[part_dist] {w_mode:9s} {mode:8s} err={r['err']} "
                f"kernel={r['ms']:.4f} ms "
                f"{np.round(r['ms_runs'], 4).tolist()} plain="
                f"{r['plain_ms']:.3f} ms bound={r['bound_ms']:.4f} ms (f32 "
                f"{ops_ms:.4f}, sfu {sfu_ms:.4f}) masked share "
                f"{r['masked_share']:.4f} asymmetric share "
                f"{r['asymmetric_share']:.4f}")
    return rows


def phase_part_dist_trainer(human):
    """The three part_dist modes at the Trainer's grid (17 parts x B = 4 =
    68 tiles) against their plain versions, as part_dist_modes, for
    w_mode threshold, sin and all_one; device times (profiler) of
    fwd_grad, the Trainer's call, the mean of two readings."""
    from semantichuman_torch.ops.part_dist import part_dist_call

    rows = []
    for w_mode in ("threshold", "sin", "all_one"):
        args = part_dist_case(human, w_mode, batch=TRAINER_B)
        consts = (w_mode, 0.8, True)
        ct = torch.linspace(0.5, 1.5, args[0].shape[0], device=DEVICE)
        modes = part_dist_modes(args, consts, ct, f"{w_mode} B={TRAINER_B}",
                                times=False)
        runs = [device_ms(lambda: part_dist_call("fwd_grad", *args,
                                                 *consts))
                for _ in range(2)]
        row = {"w_mode": w_mode, "tiles": args[0].shape[0],
               "err": {m: r["err"] for m, r in modes.items()},
               "fwd_grad_ms": float(np.mean(runs)), "fwd_grad_ms_runs": runs}
        rows.append(row)
        log(f"[part_dist] Trainer grid {row['tiles']} tiles {w_mode:9s} "
            f"fwd_grad device ms {row['fwd_grad_ms']:.4f}"
            f" {np.round(runs, 4).tolist()}; errors {row['err']}")
    return rows


def host_batch(human, tables, seed: int, b: int | None = None) -> dict:
    """One segment of B = b (TRAIN_B if None) on the device: verts with
    the dummy row, measures, and the staged GT edge lengths and part
    volumes."""
    from semantichuman_torch.ops.distance import (face_edge_lengths,
                                                  signed_part_volumes)

    b = TRAIN_B if b is None else b
    verts = human.sample_meshes(b, seed=seed).astype(np.float32)
    v = torch.from_numpy(np.concatenate(
        [verts, np.zeros((b, 1, 3), np.float32)], axis=1)).to(DEVICE)
    with torch.no_grad():
        edges = face_edge_lengths(v[:, :-1], tables.faces)
        vols = signed_part_volumes(v[:, :-1], tables.faces,
                                   tables.face_part_mask)
    return {"verts": v,
            "measure": torch.from_numpy(human.measures(verts).astype(
                np.float32)).to(DEVICE),
            "gt_face_edges": edges, "gt_part_vols": vols}


def reset_counts():
    from semantichuman_torch.ops import launches
    launches.reset()


def read_counts() -> dict:
    """The launches the host made or a capture recorded, by kernel, as this
    script's literals count them: the counters less what replays added
    (each replay of a graph adds its capture's record,
    `launches.graph_record`)."""
    from semantichuman_torch.ops import launches
    got = launches.read()
    out = {k: got[k] for k in KERNEL_COUNTS}
    for name, n in got["graph_replays"]["by_name"].items():
        rec = launches.graph_record(name)
        for k in out:
            out[k] -= n * rec.get(k, 0)
    return out


def counts_diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in KERNEL_COUNTS}


def expect(per_call: dict, calls: int = 1) -> dict:
    """Every kernel count as per_call x calls (kernels absent: 0)."""
    return {k: per_call.get(k, 0) * calls for k in KERNEL_COUNTS}


def phase_train(human, hier):
    """The training step through the kernels, against the plain route, then
    timed and counted."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.ops.part_dist import part_dist_sums_plain
    from semantichuman_torch.ops.spiral_conv import spiral_conv_plain
    from semantichuman_torch.train.edits import EditSampler
    from semantichuman_torch.train.losses import build_loss_tables
    from semantichuman_torch.train.optim import make_optimizer
    from semantichuman_torch.train.step import (StepFlags, make_loss_fn,
                                                make_train_step, to_device,
                                                value_and_grad)
    from semantichuman_torch.utils.params import tree_leaves

    model = build_model(ModelConfig(), hier, human.part_dict, device=DEVICE)
    params = model.init(0)
    tables = build_loss_tables(human.template_faces, human.J_regressor,
                               human.part_dict, device=DEVICE)
    segs = [host_batch(human, tables, seed=s) for s in range(3)]
    spec = to_device(EditSampler(seed=0).sample_interp(200, TRAIN_B),
                     DEVICE)
    flags = StepFlags()

    # --- kernels against the plain route, one loss + gradient -------------
    plain = copy.copy(model)
    plain.conv_fn = spiral_conv_plain
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    got = value_and_grad(make_loss_fn(model, tables, flags, "ori"),
                         params, *segs, spec)
    sync()
    kernel_peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                   if DEVICE == "cuda" else 0.0)
    log(f"[train] kernel route peak device memory {kernel_peak:.1f} GiB")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ref = value_and_grad(make_loss_fn(plain, tables, flags, "ori",
                                      sums_fn=part_dist_sums_plain),
                         params, *segs, spec)
    sync()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else 0.0)
    log(f"[train] plain route peak device memory {peak:.1f} GiB")
    require(sorted(got[1]) == sorted(ref[1]), "metric names differ")
    for k in ref[1]:
        log(f"[train] {k:11s} kernels {float(got[1][k]):.7f} plain "
            f"{float(ref[1][k]):.7f}")
        torch.testing.assert_close(got[1][k], ref[1][k], rtol=1e-4, atol=0,
                                   msg=lambda m: f"metric {k}: {m}")
    grad_errs = []
    for i, (g, r) in enumerate(zip(tree_leaves(got[2]),
                                   tree_leaves(ref[2]))):
        grad_errs.append(rel_err(g, r))
        # every leaf's gradient within 1e-4 of its largest entry: both
        # routes make the same per-pair decisions in the distance loss
        # and differ in the order of f32 sums only
        require(grad_errs[-1] <= 1e-4, f"gradient leaf {i}: relative "
                f"error {grad_errs[-1]:.3e}")
    log(f"[train] per-leaf gradient error vs plain: max "
        f"{max(grad_errs):.3e} over {len(grad_errs)} leaves")
    del got, ref, plain

    # --- the main path: 10 steps, counts from 0 ------------------------------
    opt = make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    step = make_train_step(model, tables, opt, flags, "ori")
    state = opt.init(params)
    p, state, _ = step(params, state, *segs, spec)          # warm-up
    sync()
    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        p, state, metrics = step(p, state, *segs, spec)
        losses.append(metrics["loss"])
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"[train] main path, {TRAIN_STEPS} steps: launches {counts}")
    # at trunk batch 384 no banded route engages
    want = expect(STEP_LAUNCHES, TRAIN_STEPS)
    require(counts == want, f"{TRAIN_STEPS} steps: launches {counts}, "
            f"want {want}")
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"non-finite loss {losses}")
    log(f"[train] losses {[round(float(v), 6) for v in losses]}")
    ms = wall * 1e3 / TRAIN_STEPS
    log(f"[train] {ms:.3f} ms/step, {TRAIN_B / ms * 1e3:.1f} meshes/s "
        f"(B={TRAIN_B} per segment, trunk batch {TRUNK_B})")
    prof = profile_steps(lambda: step(p, state, *segs, spec), ms)
    if prof:
        fam = prof["kernel_families_ms"]
        require(fam["index_add"] == 0, f"the step ran index_add_ kernels "
                f"({fam['index_add']:.4f} ms a step): a gather's backward "
                "added with atomics")
    prof["gathers_vs_index_select"] = step_gathers_vs_index_select(
        lambda: step(p, state, *segs, spec))

    # --- bf16 trunk, one step --------------------------------------------------
    model16 = build_model(ModelConfig(trunk_dtype="bfloat16"), hier,
                          human.part_dict,
                          device=DEVICE)
    step16 = make_train_step(model16, tables, opt, flags, "ori")
    _, _, m16 = step16(params, opt.init(params), *segs, spec)
    loss16 = float(m16["loss"])
    require(np.isfinite(loss16), f"bf16 trunk step loss {loss16}")
    log(f"[train] bf16 trunk step loss {loss16:.6f} (f32 first step "
        f"{float(losses[0]):.6f})")
    return {"counts": counts, "ms_per_step": ms,
            "meshes_per_s": TRAIN_B / ms * 1e3, "losses": losses.tolist(),
            "grad_rel_err_max": max(grad_errs), "plain_peak_gib": peak,
            "kernel_peak_gib": kernel_peak, "bf16_loss": loss16, **prof}


def device_by_name(run, reps: int, attempts: int = 5,
                   windows: int = 2) -> dict:
    """Device ms per call of run() by kernel name (torch.profiler): per
    name the larger of `windows` windows, since a window whose events the
    profiler dropped in part reads low, as in device_ms; a window that
    records no device activity is taken again ({} if every one is
    empty)."""
    from torch.profiler import ProfilerActivity, profile

    got = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / reps)
        if by_name:
            got.append(by_name)
        if len(got) == windows:
            break
    return {n: max(w.get(n, 0.0) for w in got)
            for n in set().union(*got)} if got else {}


def step_gathers_vs_index_select(run, reps: int = 3) -> dict:
    """The yardstick of row 7's redesign: the step with every gather of
    `gather_rows` swapped back to index_select and autograd as before
    (IndexSelectFn: its backward is index_add_ with atomics), and
    through GatherRowsFn (the row 7 kernel forward, the row 8 kernel
    backward), in turns (yardstick, kernels, kernels, yardstick), on the
    same parameters and batch: wall ms per step and device ms by kernel
    family.  Outside the counted steps; the swap lives here only."""
    from semantichuman_torch.ops import row_gather as RG

    if DEVICE != "cuda":
        return {}
    kernel_fn = RG.GatherRowsFn

    class IndexSelectFn:
        """The gathers as the port ran them before row 7 took them:
        index_select, and unpool's taps weighted and summed over a
        [B, V_f, 3, C] buffer (autograd: index_add_ backward)."""

        @staticmethod
        def apply(x, table):
            b, _, c = x.shape
            g = x.index_select(1, table.idx.reshape(-1).long())
            if table.taps == 1:
                return g if table.w is None else g * table.w[None, :, None]
            g = g.reshape(b, table.n_rows, table.taps, c)
            return (g * table.w.to(x.dtype)[None, :, :, None]).sum(dim=2)

    runs = {k: [] for k in ("wall_ms", "yardstick_wall_ms", "device_ms",
                            "yardstick_device_ms")}
    families = {"kernels": [], "yardstick": []}
    try:
        for swapped in (True, False, False, True):
            RG.GatherRowsFn = IndexSelectFn if swapped else kernel_fn
            run()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            sync()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            by_name = device_by_name(run, reps)
            require(bool(by_name), "the profiler saw no device kernels in "
                    "the step")
            pre = "yardstick_" if swapped else ""
            runs[pre + "wall_ms"].append(wall)
            runs[pre + "device_ms"].append(sum(by_name.values()))
            families["yardstick" if swapped else "kernels"].append(
                {label: sum(t for n, t in by_name.items() if key in n)
                 for label, key in PROFILE_GROUPS.items()})
    finally:
        RG.GatherRowsFn = kernel_fn
    out = {k: float(np.mean(v)) for k, v in runs.items()}
    out.update({f"{k}_runs": v for k, v in runs.items()})
    out["families_ms"] = {
        name: {k: float(np.mean([f[k] for f in fs])) for k in fs[0]}
        for name, fs in families.items()}
    log(f"[profile] train step, gathers through the kernels: "
        f"{out['wall_ms']:.3f} ms/step {np.round(runs['wall_ms'], 3).tolist()}"
        f", device {out['device_ms']:.3f} ms; swapped to index_select and "
        f"autograd: {out['yardstick_wall_ms']:.3f} ms/step "
        f"{np.round(runs['yardstick_wall_ms'], 3).tolist()}, device "
        f"{out['yardstick_device_ms']:.3f} ms")
    for name, fam in out["families_ms"].items():
        log(f"[profile]   {name} by family, ms per step: "
            f"{ {k: round(v, 4) for k, v in fam.items()} }")
    return out


def profile_steps(run, wall_ms: float, reps: int = 3) -> dict:
    """Device time per step by kernel name (torch.profiler), and the share
    of the unprofiled step time with no kernel running."""
    if DEVICE != "cuda":
        return {}
    by_name = device_by_name(run, reps)
    if not by_name:
        log("[profile] train: the profiler saw no device kernels; device "
            "time not measured")
        return {}
    busy = sum(by_name.values())
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"[profile] train step: device busy {busy:.3f} ms of {wall_ms:.3f} "
        f"ms, idle share {idle:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, t in top:
        log(f"[profile]   {t:8.4f} ms  {name[:90]}")
    groups = {label: sum(t for n, t in by_name.items() if key in n)
              for label, key in PROFILE_GROUPS.items()}
    log(f"[profile] by kernel family, ms per step: "
        f"{ {k: round(v, 4) for k, v in groups.items()} }")
    return {"device_busy_ms": busy, "idle_share": idle,
            "top_kernels": [[n[:90], t] for n, t in top],
            "kernel_families_ms": groups}


def banded_calls(model):
    """(label, band table, C, needs dx) of every banded call of one trunk
    pass at B <= 16, in order: the convs at banded levels (their input
    width), then the unpools into banded transitions (the width entering
    the level, which unpool keeps).  The first conv's input is data, so its
    backward never runs."""
    t = model.tables
    calls = []
    for side, plan in (("enc", model.enc_plan), ("dec", model.dec_plan)):
        for j, (lvl, cin, _cout, _act) in enumerate(plan):
            if t.band_for(lvl) is not None:
                calls.append((f"{side} conv L{lvl} C={cin}", t.band_for(lvl),
                              cin, not (side == "enc" and j == 0)))
    for lvl in range(t.n_levels - 2, -1, -1):
        band = t.unpool_band_for(lvl)
        if band is not None:
            c = next(cin for lv, cin, _co, _a in model.dec_plan if lv == lvl)
            calls.append((f"unpool {lvl + 1}->{lvl} C={c}", band, c, True))
    return calls


def phase_banded_kernels(model, b: int = TRAINER_TRUNK_B):
    """Rows 5-7 at every banded call of one Trainer step (trunk batch 12),
    float32 as the step feeds them: the forward bit-equal (unweighted) or
    to rtol 1e-6 (weighted: one product per element either way), the
    backward to 1e-5 of the largest entry with the dummy row zeroed (sums
    of the same terms in another order; the dummy row collects every
    in-band pad and its gradient is discarded) and bit-equal over two
    runs, the fix-up gather bit-equal.  One bf16 forward per conv call,
    bit-equal (a copy).  Device times per call (device_ms): kernel, plain,
    library (index_select of the sources, index_add_ of the in-band rows,
    selected and weighted before the timed call); the kernel's host-paced
    time (time_ms); bound = bytes / 3.35 TB/s."""
    from semantichuman_torch.ops import banded_gather as BG
    from semantichuman_torch.ops import row_gather as RG

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = []
    for label, table, c, needs_dx in banded_calls(model):
        m = b * c
        xp = torch.randn((table.n_src, m), generator=gen, device=DEVICE)
        xp[-1] = 0.0
        src, inband = BG._sources(table)
        row = {"call": label, "m": m, "weighted": table.weighted,
               "n_rows": table.n_rows, "n_src": table.n_src}
        # --- row 5 ----------------------------------------------------------
        got = BG.banded_gather_fwd(xp, table)
        ref = BG.banded_gather_fwd_plain(xp, table)
        sync()
        if table.weighted:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0,
                                       msg=lambda s: f"fwd {label}: {s}")
        else:
            require(torch.equal(got, ref), f"fwd {label}: not bit-equal")
            x16 = xp.bfloat16()
            require(torch.equal(BG.banded_gather_fwd(x16, table),
                                BG.banded_gather_fwd_plain(x16, table)),
                    f"fwd {label} bf16: not bit-equal")
        extra = table.n_rows * 4 if table.weighted else 0
        fwd_bytes = ((table.n_src + table.n_rows) * m * 4 + table.n_rows * 4
                     + table.base.numel() * 4 + extra)
        row["fwd"] = {
            "max_abs_err": float((got - ref).abs().max()),
            "ms": device_ms(lambda: BG.banded_gather_fwd(xp, table)),
            "host_ms": time_ms(lambda: BG.banded_gather_fwd(xp, table)),
            "plain_ms": device_ms(lambda: BG.banded_gather_fwd_plain(
                xp, table)),
            "library_ms": device_ms(lambda: xp.index_select(0, src)),
            "bound_ms": fwd_bytes / PEAK_BYTES * 1e3}
        del got, ref
        # --- row 6 ----------------------------------------------------------
        if needs_dx:
            ct = torch.randn((table.n_rows, m), generator=gen, device=DEVICE)
            got = BG.banded_gather_bwd(ct, table)
            again = BG.banded_gather_bwd(ct, table)
            ref = BG.banded_gather_bwd_plain(ct, table)
            sync()
            require(torch.equal(got, again), f"bwd {label}: runs differ")
            got[-1] = 0
            ref[-1] = 0
            err = float((got - ref).abs().max())
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-5 * float(ref.abs().max()),
                                       msg=lambda s: f"bwd {label}: {s}")
            ct_in = ct[inband]
            if table.weighted:
                ct_in = ct_in * table.w[inband][:, None]
            src_in = src[inband]
            nnz = int(src_in.numel())
            bwd_bytes = ((table.n_rows + table.n_src) * m * 4
                         + (table.n_src + 1 + nnz) * 4
                         + (nnz * 4 if table.weighted else 0))
            row["bwd"] = {
                "max_abs_err": err, "rel_err": err / float(ref.abs().max()),
                "ms": device_ms(lambda: BG.banded_gather_bwd(ct, table)),
                "host_ms": time_ms(lambda: BG.banded_gather_bwd(ct, table)),
                "plain_ms": device_ms(lambda: BG.banded_gather_bwd_plain(
                    ct, table)),
                "library_ms": device_ms(lambda: torch.zeros(
                    (table.n_src, m), device=DEVICE).index_add_(0, src_in,
                                                                ct_in)),
                "bound_ms": bwd_bytes / PEAK_BYTES * 1e3}
            del got, again, ref, ct, ct_in
        # --- row 7 ----------------------------------------------------------
        if table.fix is not None:
            idx = table.fix.idx
            got = RG.row_gather(xp, idx)
            ref = RG.row_gather_plain(xp, idx)
            sync()
            require(torch.equal(got, ref), f"row_gather {label}: not equal")
            n_fix = int(idx.numel())
            n_read = int(torch.unique(idx).numel())
            row["row_gather"] = {
                "n_fix": n_fix, "max_abs_err": 0.0,
                "ms": device_ms(lambda: RG.row_gather(xp, idx)),
                "host_ms": time_ms(lambda: RG.row_gather(xp, idx)),
                "plain_ms": device_ms(lambda: RG.row_gather_plain(xp, idx)),
                "library_ms": device_ms(lambda: xp.index_select(
                    0, idx.long())),
                "bound_ms": ((n_read + n_fix) * m * 4 + n_fix * 4)
                / PEAK_BYTES * 1e3}
        rows.append(row)
        parts = " ".join(
            f"{k} {row[k]['ms']:.4f}/{row[k]['plain_ms']:.4f}/"
            f"{row[k]['library_ms']:.4f}/{row[k]['bound_ms']:.4f}"
            for k in ("fwd", "bwd", "row_gather") if k in row)
        log(f"[banded] {label:22s} M={m:5d} kernel/plain/library/bound "
            f"ms (device): {parts}")
    return rows


def phase_conv_backward_trainer(model, b: int = TRAINER_TRUNK_B):
    """The two fused backward kernels at the Trainer's shapes: the convs
    that stay on the take route at trunk batch 12 (the levels without a
    band: enc L2, enc L3, dec L3, dec L2).  Twelve batch elements fill the
    dx kernel's batch tiles only partly, which trunk batch 384 never
    does.  float32 and bfloat16, each kernel within 1e-4 of the largest
    entry of its plain version and bit-equal over two runs; device times
    (device_ms) of the float32 kernels and their plain versions."""
    SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

    t = model.tables
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for side, plan in (("enc", model.enc_plan), ("dec", model.dec_plan)):
        for lvl, cin, cout, _act in plan:
            if t.band_for(lvl) is not None:
                continue
            label = f"{side} L{lvl} {cin}->{cout}"
            spiral, csr = t.spirals[lvl], t.spiral_csr[lvl]
            v1, s = spiral.shape
            x = torch.randn((b, v1, cin), generator=gen, device=DEVICE)
            x[:, -1] = 0.0
            w = torch.randn((s * cin, cout), generator=gen, device=DEVICE)
            w /= (s * cin) ** 0.5
            dy = torch.randn((b, v1, cout), generator=gen,
                             device=DEVICE) * 0.1
            dy[:, -1] = 0.0
            for dtype in (torch.float32, torch.bfloat16):
                xc, wc = x.to(dtype), w.to(dtype)
                halves = {
                    "dw": (lambda: SC.spiral_conv_bwd_dw(xc, spiral, dy),
                           lambda: SC.spiral_conv_bwd_dw_plain(xc, spiral,
                                                               dy)),
                    "dx": (lambda: SC.spiral_conv_bwd_dx(dy, wc, csr,
                                                         (v1, s)),
                           lambda: SC.spiral_conv_bwd_dx_plain(dy, wc, csr,
                                                               (v1, s)))}
                row = {"layer": label, "dtype": str(dtype).split(".")[-1],
                       "batch": b}
                for name, (kernel, plain) in halves.items():
                    a, again, r = kernel(), kernel(), plain()
                    sync()
                    require(torch.equal(a, again), f"{label} B={b} {dtype} "
                            f"{name} kernel: two runs differ")
                    torch.testing.assert_close(
                        a, r, rtol=0, atol=1e-4 * float(r.abs().max()),
                        msg=lambda m: f"{label} B={b} {dtype} {name}: {m}")
                    row[f"{name}_max_abs_err"] = float((a - r).abs().max())
                    row[f"{name}_rel_err"] = rel_err(a, r)
                    if dtype == torch.float32:
                        row[f"{name}_ms"] = device_ms(kernel)
                        row[f"{name}_plain_ms"] = device_ms(plain)
                rows.append(row)
                log(f"[conv-bwd] {label:18s} B={b} {row['dtype']:8s} kernel "
                    f"rel err dw {row['dw_rel_err']:.2e} dx "
                    f"{row['dx_rel_err']:.2e}" + (
                        f" | device ms kernel/plain dw {row['dw_ms']:.4f}/"
                        f"{row['dw_plain_ms']:.4f} dx {row['dx_ms']:.4f}/"
                        f"{row['dx_plain_ms']:.4f}"
                        if dtype == torch.float32 else ""))
    require(len(rows) == 8, f"expected four take-route convs, got "
            f"{len(rows) // 2}")
    return rows


def banded_summary(rows, key: str) -> dict:
    """A kernel's numbers summed over the step's calls of it."""
    calls = [r[key] for r in rows if key in r]
    out = {k: sum(c[k] for c in calls)
           for k in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(c["max_abs_err"] for c in calls)
    out["calls"] = len(calls)
    return out


def trainer_cfg(banded: bool = True, **train):
    """The paper recipe (Config() defaults) on synthetic SMPL-scale data;
    the loop path unless `epoch_scan=True` is passed."""
    from semantichuman_torch.config import Config
    return Config.from_dict({
        "model": {"banded_conv": banded},
        "data": {"synthetic": True, "synthetic_train": 64,
                 "synthetic_test": 16},
        "train": {"n_epochs": 3, "ck_frequency": 2, "save_recons": False,
                  "epoch_scan": False, **train}})


def trainer_workdir(root: Path, name: str) -> str:
    """A new workdir (the Trainer reads the bundled hierarchy, whose
    compile key matches the synthetic template)."""
    d = root / name
    d.mkdir()
    return str(d)


def timed_steps(trainer) -> list:
    """Wrap the trainer's steps: a synchronize after each, and the host
    time of each loop iteration (batch fetch, edit sampling and the step)
    appended to the returned list."""
    times, last = [], [None]
    get = trainer._get_step

    def get_step(epoch, variant):
        step = get(epoch, variant)

        def run(*args):
            out = step(*args)
            sync()
            now = time.perf_counter()
            if last[0] is not None:
                times.append((now - last[0]) * 1e3)
            last[0] = now
            return out
        return run

    trainer._get_step = get_step
    return times


@contextlib.contextmanager
def graph_probe():
    """Wrap the epoch path's warm-up and capture (`train/graph.py`): the
    launches each capture recorded (its graph's record, which each replay
    adds to the counters again), and the host time of each warm-up and
    capture."""
    from semantichuman_torch.train import graph as G

    rec = []
    warm, cap = G.warm_up, G.capture

    def warm_up(fn, reset, *args):
        t0 = time.perf_counter()
        warm(fn, reset, *args)
        rec.append({"warm_up_s": time.perf_counter() - t0})

    def capture(fn, pool, name):
        sync()
        t0 = time.perf_counter()
        graph = cap(fn, pool, name)
        rec[-1].update(capture_s=time.perf_counter() - t0,
                       counts=expect(graph.record),
                       dw=graph.record.get("spiral_conv_dw", {}))
        return graph

    G.warm_up, G.capture = warm_up, capture
    try:
        yield rec
    finally:
        G.warm_up, G.capture = warm, cap


def check_dw_record(dw: dict, v1_fine: int, calls: int) -> None:
    """A captured step's `spiral_conv_dw` record ("<B>,<V1>,<S>,<C>,<Co>:<T>"
    -> calls, window rows staged, entries read): `calls` dW calls, and at
    each conv of the finest level (V1 = v1_fine) entries over rows above
    DW_MIN_REUSE."""
    n = sum(r["calls"] for r in dw.values())
    reuse = {k: r["entries"] / r["rows"] for k, r in dw.items()}
    log("[graph] captured step's dW windows: "
        + ", ".join(f"{k} {r:.2f} entries a row" for k, r in reuse.items()))
    require(n == calls, f"spiral_conv_dw records {n} dW calls, want {calls}")
    fine = {k: r for k, r in reuse.items()
            if int(k.split(",")[1]) == v1_fine}
    require(fine and all(r > DW_MIN_REUSE for r in fine.values()),
            f"level-0 dW windows {fine}: want more than {DW_MIN_REUSE} "
            "entries a staged row")


@contextlib.contextmanager
def deterministic_torch():
    """torch's deterministic algorithms on for the block: any torch op that
    would add with atomics takes its fixed-order form (the port's own
    kernels always sum in a fixed order).  Ops without a deterministic
    form only warn."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def resumed_epoch(root: Path, name: str, banded: bool, ckpt: str,
                  graph: bool = False):
    """A Trainer resumed from the epoch-2 checkpoint, its epoch 3 run (the
    loop's steps timed): (trainer, step times in ms, epoch-3 train
    loss)."""
    from semantichuman_torch.train.loop import Trainer

    tr = Trainer(trainer_cfg(banded, resume=ckpt, epoch_scan=graph),
                 trainer_workdir(root, name), device=DEVICE)
    require(tr.start_epoch == 3, f"resumed at {tr.start_epoch}")
    require(tr._epoch_scan_ok() == graph, "the Trainer takes the "
            f"{'loop' if graph else 'epoch path'}")
    times = [] if graph else timed_steps(tr)
    tr.fit()
    return tr, times, tr.history[0]["train"]


def params_equal(a, b) -> list:
    from semantichuman_torch.utils.params import tree_leaves
    return [torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                              tree_leaves(b))]


def phase_trainer_graph(root: Path, losses: list, final: list,
                        ckpt: str) -> dict:
    """The Trainer's default epoch path on the card (train.epoch_scan):
    (a) a 3-epoch fit, Config() defaults, default algorithms, against the
    loop's fit from the same seed (`losses`, `final`) and against a second
    graph fit, each bit for bit; (c) one chunk per epoch (the first fit
    taken on to epoch 4) against train.scan_epochs 3 and val_every 4 (the
    chunks clipped at the epoch-2 checkpoint), bit for bit; (d) the
    launches recorded while the step is captured (GRAPH_LAUNCHES) and,
    over one replayed epoch, torch.profiler's count of every kernel a
    multiple of the epoch's steps, the index_add_ family at 0."""
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.params import tree_leaves

    out = {}
    torch.cuda.reset_peak_memory_stats()
    with graph_probe() as caps:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        tr = Trainer(trainer_cfg(epoch_scan=True),
                     trainer_workdir(root, "graph_fit"), device=DEVICE)
        require(tr._epoch_scan_ok(), "Config() defaults do not take the "
                "epoch path")
        tr.fit()
        sync()
        out["fit_s"] = time.perf_counter() - t0
        out["counts"] = read_counts()
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    require(len(caps) == 1, f"{len(caps)} captures, want 1 (one key: "
            "the loss flags of Config() do not change, 'dynamic' variant)")
    cap = caps[0]
    want = expect(GRAPH_LAUNCHES)
    log(f"[graph] captured step: launches {cap['counts']}; warm-up "
        f"{cap['warm_up_s']:.3f} s, capture {cap['capture_s']:.3f} s "
        f"(host); peak device memory {out['peak_memory_gib']:.2f} GiB")
    require(cap["counts"] == want,
            f"captured step launches {cap['counts']}, want {want}")
    check_dw_record(cap["dw"], tr.model.tables.sizes[0] + 1,
                    GRAPH_LAUNCHES["spiral_conv_bwd_dw"])
    got = [h["train"] for h in tr.history]
    same = params_equal(final, tr.params)
    log(f"[graph] (a) epoch losses {got} (loop {losses}); {sum(same)} of "
        f"{len(same)} parameter tensors bit-equal to the loop's")
    if not (got == losses and all(same)):
        for i, (x, y) in enumerate(zip(tree_leaves(final),
                                       tree_leaves(tr.params))):
            log(f"[graph]   leaf {i}: max |graph - loop| "
                f"{float((x - y).abs().max()):.3e}")
    require(got == losses and all(same) and len(same) == 24,
            "the epoch path's fit differs from the loop's")
    out.update(epoch_losses=got, captures=caps)

    tr2 = Trainer(trainer_cfg(epoch_scan=True),
                  trainer_workdir(root, "graph_refit"), device=DEVICE)
    tr2.fit()
    again = [h["train"] for h in tr2.history]
    same = params_equal(tr.params, tr2.params)
    log(f"[graph] (a) second graph fit: epoch losses {again}; {sum(same)} "
        f"of {len(same)} parameter tensors bit-equal")
    require(again == got and all(same), "two graph fits differ")
    del tr2

    # (c) one chunk per epoch (the first fit on to epoch 4) against chunks
    tr.start_epoch = 4
    tr.fit(4)
    chunked = Trainer(trainer_cfg(epoch_scan=True, n_epochs=4,
                                  scan_epochs=3, val_every=4),
                      trainer_workdir(root, "graph_chunks"), device=DEVICE)
    chunks = []
    run_chunk = chunked._run_scan_chunk

    def record(e0, e1):
        chunks.append((e0, e1))
        return run_chunk(e0, e1)

    chunked._run_scan_chunk = record
    chunked.fit()
    per_epoch = [h["train"] for h in tr.history]
    by_chunk = [h["train"] for h in chunked.history]
    same = params_equal(tr.params, chunked.params)
    log(f"[graph] (c) chunks {chunks}: epoch losses {by_chunk} (one chunk "
        f"an epoch {per_epoch}); {sum(same)} of {len(same)} parameter "
        "tensors bit-equal")
    require(chunks == [(1, 2), (3, 4)], f"chunks {chunks}")
    require(by_chunk == per_epoch and all(same),
            "chunked epochs differ from one chunk an epoch")
    out.update(chunks=chunks, chunk_epoch_losses=by_chunk)
    del chunked

    # (d) the profiler over one replayed epoch
    out["replay_profile"] = profile_replays(tr, 5)
    del tr
    return out


def port_kernels() -> set:
    """The names of the __global__ functions of the port's CUDA sources."""
    names = set()
    for src in (ROOT / "semantichuman_torch" / "csrc").glob("*.cu"):
        for chunk in src.read_text().split("__global__")[1:]:
            chunk = re.sub(r"__launch_bounds__\([^)]*\)", "", chunk)
            names.add(re.search(r"(\w+)\(", chunk).group(1))
    return names


def profile_replays(tr, epoch: int) -> dict:
    """torch.profiler over one epoch of replays of the Trainer's captured
    step (its staged schedule, on its static buffers; the Trainer's state
    is not read back): each of the port's kernels counted a multiple of
    the epoch's steps, the port's kernel families present, the index_add_
    family at 0.  -> device busy ms a step, top kernels, families."""
    from torch.profiler import ProfilerActivity, profile

    k = len(tr.train_loader)
    run, _names = tr._get_scan_step(epoch, "dynamic")
    buf = tr._epoch_buffers
    # the profiler drops a window's events now and then: a window whose
    # count of one of the port's kernels is off a multiple of the replays
    # is taken again, up to three windows, each from the same state
    for _ in range(3):
        buf.load(tr.params, tr.opt_state)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                run()
            torch.cuda.synchronize()
        by_name, n_by_name = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / k)
                n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
        ours = {nm: n for nm, n in n_by_name.items()
                if any(re.search(rf"\b{f}\b", nm) for f in port_kernels())}
        odd = {nm: n for nm, n in ours.items() if n % k}
        if ours and not odd:
            break
    require(by_name, "the profiler saw no device kernels in the replays")
    busy = sum(by_name.values())
    require(ours and not odd, f"the port's kernels not run a whole number "
            f"of times a replay over {k} replays: {odd}")
    # torch's own kernels: printed, no gate (a window has been seen to
    # miss the first kernel of its first replay)
    other = {nm[:80]: n for nm, n in n_by_name.items()
             if nm not in ours and n % k}
    if other:
        log(f"[graph] (d) torch kernels counted off a multiple of {k}: "
            f"{other}")
    groups = {label: sum(t for nm, t in by_name.items() if key in nm)
              for label, key in PROFILE_GROUPS.items()}
    launches = {label: sum(n for nm, n in n_by_name.items() if key in nm)
                // k for label, key in PROFILE_GROUPS.items()}
    log(f"[graph] (d) one replayed epoch ({k} replays): device busy "
        f"{busy:.3f} ms a step; kernels a step by family {launches}")
    for label in ("conv_fwd", "conv_bwd_dw", "csr_reduce", "part_dist",
                  "row_gather"):
        require(launches[label] > 0, f"no {label} kernel in the replays")
    require(launches["index_add"] == 0, "index_add in the replays: "
            f"{launches['index_add']} a step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"device_busy_ms": busy, "kernels_per_step": sum(
        n_by_name.values()) // k, "family_launches_per_step": launches,
        "kernel_families_ms": groups,
        "top_kernels": [[nm[:90], t] for nm, t in top]}


def route_runs(root: Path, resume_from: dict) -> dict:
    """(b) and (e): per route (the forced banded arm, FORCED_GATES, and
    the default take route), the epoch path and the loop in turns (graph,
    loop, loop, graph), each resumed from the epoch-2 checkpoint of the
    loop's fit on its route (resume_from: route -> (epoch losses,
    checkpoint dir)): epoch 3's loss to rtol 1e-4 against that fit's; the
    launches of the banded arm's captured step (GRAPH_LAUNCHES_BANDED);
    then two more epochs each, timed: ms/step (the epoch's training time
    over its steps), s/epoch with and without the val pass, device busy
    ms a step (one profiled epoch more), the idle share; the host time of
    the capture."""
    out = {}
    for banded in (True, False):
        name = "banded" if banded else "take"
        losses, ckpt = resume_from[name]
        runs = {"graph": {}, "loop": {}}
        for i, graph in enumerate((True, False, False, True)):
            path = "graph" if graph else "loop"
            r = runs[path]
            with graph_probe() as caps, route_gates(banded):
                tr, times, loss3 = resumed_epoch(
                    root, f"{name}_{path}{i}", banded, ckpt, graph=graph)
                np.testing.assert_allclose(loss3, losses[2], rtol=1e-4)
                tr.start_epoch = 4
                tr.fit(5)
            if banded and graph and i == 0:
                want = expect(GRAPH_LAUNCHES_BANDED)
                got = [c["counts"] for c in caps]
                require(got == [want], "forced banded arm: captured steps' "
                        f"launches {got}, want one with {want}")
                out["banded_counts"] = got[0]
            steady = tr.history[1:]
            k = len(tr.train_loader)
            r.setdefault("epoch3_loss", []).append(loss3)
            r.setdefault("ms_per_step_runs", []).append(float(np.mean(
                [h["train_sec"] for h in steady])) / k * 1e3)
            r.setdefault("epoch_s_runs", []).append(float(np.mean(
                [h["sec"] for h in steady])))
            r.setdefault("epoch_train_s_runs", []).append(float(np.mean(
                [h["train_sec"] for h in steady])))
            if graph:
                r.setdefault("capture_s_runs", []).append(
                    caps[0]["capture_s"])
                r.setdefault("warm_up_s_runs", []).append(
                    caps[0]["warm_up_s"])
            else:
                r.setdefault("step_ms_median_runs", []).append(
                    float(np.median(times)))
            log(f"[trainer] {name} {path}: epoch 3 loss {loss3!r} "
                f"(uninterrupted {losses[2]!r}, bit-equal "
                f"{loss3 == losses[2]}); epochs 4-5 "
                f"{r['ms_per_step_runs'][-1]:.3f} ms/step, "
                f"{r['epoch_train_s_runs'][-1]:.3f} s/epoch before val, "
                f"{r['epoch_s_runs'][-1]:.3f} with val"
                + (f"; capture {caps[0]['capture_s']:.3f} s host"
                   if graph else ""))
            if i < 2:
                # the loop's profiled epoch runs eagerly: on the arm's
                # route only under its gates
                with route_gates(banded):
                    r.update(profile_replays(tr, 6) if graph
                             else profile_epoch(tr))
            if not banded and i == 1:
                _p, _z, _zk, _tx, l1, mm = tr.evaluate()
                require(np.isfinite(l1) and np.isfinite(mm),
                        f"evaluate: l1 {l1} mm {mm}")
                log(f"[trainer] evaluate: l1 {l1:.6f}, {mm:.3f} mm")
                out.update(eval_l1=l1, eval_mm=mm)
            del tr
        for path, r in runs.items():
            ms = float(np.mean(r["ms_per_step_runs"]))
            r.update(ms_per_step=ms, meshes_per_s=TRAINER_B / ms * 1e3,
                     epoch_s=float(np.mean(r["epoch_s_runs"])),
                     epoch_train_s=float(np.mean(r["epoch_train_s_runs"])))
            if "device_busy_ms" in r:
                r["idle_share"] = max(0.0, 1 - r["device_busy_ms"] / ms)
            log(f"[trainer] {name} {path}: {ms:.3f} ms/step (runs "
                f"{r['ms_per_step_runs']}), {r['meshes_per_s']:.1f} "
                f"meshes/s, {r['epoch_train_s']:.3f} s/epoch before val, "
                f"{r['epoch_s']:.3f} with val, device busy "
                f"{r.get('device_busy_ms', 'not measured')} ms a step, idle "
                f"share {r.get('idle_share', 'not measured')}")
        out[name] = runs
    return out


@contextlib.contextmanager
def band_gates(conv: int, unpool: int):
    """The batch gates of the banded conv (`ops/spiral_conv.py:
    _BANDED_MAX_B`) and the banded unpool (`ops/sampling.py:
    _UNPOOL_BAND_MAX_B`) set for the block: the route is banded at batch
    <= the gate on the card, and 0 closes it.  A graph captured inside
    the block keeps the routes it recorded."""
    from semantichuman_torch.ops import sampling

    sc = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    saved = sc._BANDED_MAX_B, sampling._UNPOOL_BAND_MAX_B
    sc._BANDED_MAX_B, sampling._UNPOOL_BAND_MAX_B = conv, unpool
    try:
        yield
    finally:
        sc._BANDED_MAX_B, sampling._UNPOOL_BAND_MAX_B = saved


def route_gates(banded: bool):
    """The forced banded arm's gates (FORCED_GATES) for banded, else the
    default gates."""
    return band_gates(*FORCED_GATES) if banded else contextlib.nullcontext()


def gate_trainer_ms(root: Path, name: str, cfg, gates) -> float:
    """ms/step of a Trainer's fit on the epoch path under `gates` (conv,
    unpool): the mean training time of every epoch but the first (which
    holds the capture) over its steps."""
    from semantichuman_torch.train.loop import Trainer

    with band_gates(*gates):
        tr = Trainer(cfg, trainer_workdir(root, name), device=DEVICE)
        require(tr._epoch_scan_ok(), f"{name}: not on the epoch path")
        tr.fit()
    ms = float(np.mean([h["train_sec"] for h in tr.history[1:]])) \
        / len(tr.train_loader) * 1e3
    require(all(np.isfinite(h["train"]) for h in tr.history),
            f"{name}: non-finite epoch loss")
    del tr
    torch.cuda.empty_cache()
    return ms


def phase_band_gates(model, params, human) -> dict:
    """Each banded route's gate on its own against the take route, in
    turns (banded, take, take, banded): the conv gate open (the unpool
    gate closed) and the unpool gate open (the conv gate closed), each
    against both closed.  Serving: ms per forward at B = 1, 16, 64 (host
    clock, 20 forwards after 3).  The Trainer on its epoch path: the
    paper recipe at B = 4 (trunk 12; 64 train meshes, 6 epochs of 16
    steps) and the fast recipe (`configs/train_fast.yaml`: batches 64 and
    32, trunk 128; 256 train meshes, 11 epochs of 4 steps), ms/step over
    the epochs after the first.  For each gate, the batches at which its
    banded arm wins.  A record, no gate."""
    from semantichuman_torch.config import Config
    from semantichuman_torch.serving import ServingBundle, export_inference

    open_ = 1 << 30
    arms = {"conv": (open_, 0), "unpool": (0, open_), "take": (0, 0)}
    meshes = human.sample_meshes(max(SERVE_BATCHES), seed=0)
    verts_all = np.concatenate(
        [meshes, np.zeros((len(meshes), 1, 3))], axis=1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        export_inference(model, params, human.J_regressor, tmp)
        bundle = ServingBundle(tmp, device="cuda")

    def wall_ms(b, reps=20):
        # the live model: an exported program fixes its route when traced
        x = torch.from_numpy(verts_all[:b]).cuda()
        for _ in range(3):
            bundle.live("forward", x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            bundle.live("forward", x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {"serving": {}, "trainer": {}}
    for b in SERVE_BATCHES:
        for gate in ("conv", "unpool"):
            runs = {gate: [], "take": []}
            for arm in (gate, "take", "take", gate):
                with band_gates(*arms[arm]):
                    runs[arm].append(wall_ms(b))
            out["serving"][f"{gate} B={b}"] = runs
            log(f"[gates] serving B={b}, {gate} gate open: banded "
                f"{runs[gate]} ms, take {runs['take']} ms")

    fast = Config.from_yaml(str(ROOT / "configs" / "train_fast.yaml"))
    fast = Config.from_dict({**fast.to_dict(), "train": {
        **fast.to_dict()["train"], "n_epochs": 11, "scan_epochs": 1,
        "val_every": 100, "ck_frequency": 100, "save_recons": False}})
    cases = {"B=4 trunk 12": trainer_cfg(epoch_scan=True, n_epochs=6,
                                         ck_frequency=100, val_every=100),
             "fast trunk 128": fast}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for case, cfg in cases.items():
            for gate in ("conv", "unpool"):
                runs = {gate: [], "take": []}
                for i, arm in enumerate((gate, "take", "take", gate)):
                    runs[arm].append(gate_trainer_ms(
                        root, f"{case[:4]}_{gate}_{arm}{i}".replace(
                            " ", "_").replace("=", ""), cfg, arms[arm]))
                out["trainer"][f"{gate} {case}"] = runs
                log(f"[gates] Trainer {case}, {gate} gate open: banded "
                    f"{runs[gate]} ms/step, take {runs['take']} ms/step")
    wins = {gate: [k.split(" ", 1)[1] for k, r in {
        **out["serving"], **out["trainer"]}.items()
        if k.startswith(gate) and np.mean(r[gate]) < np.mean(r["take"])]
        for gate in ("conv", "unpool")}
    log(f"[gates] the banded arm wins at: {wins}")
    out["banded_wins"] = wins
    return out


def foreach_div_rounding() -> dict:
    """Why `Adam` takes its per-step lr and bias corrections as a float32
    tensor in the loop too: which rounding `torch._foreach_div` by a
    Python float s gives on the card, against a true division by float32
    s (what a captured step can do with s on the device) and against a
    product with the float32 reciprocal of s in float32 or in double.  A
    record, no gate."""
    x = torch.rand(1 << 16, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0)) + 0.5
    out = {}
    for t in (1, 7, 300):
        s = 1.0 - 0.9 ** t
        got = torch._foreach_div([x], s)[0]
        out[t] = {
            "true_division": torch.equal(got, x / torch.tensor(
                s, device="cuda")),
            "times_f32_reciprocal": torch.equal(got, x * float(
                np.float32(1) / np.float32(s))),
            "times_f64_reciprocal": torch.equal(got, x * float(
                np.float32(1.0 / s)))}
    log(f"[trainer] _foreach_div(x, s) on the card equals, for s = "
        f"1 - 0.9^t: {out}")
    return out


def phase_trainer(root: Path):
    """The Trainer's main paths, their workdirs under root: the loop (fit
    with counts, a second fit,
    the same fit in the forced banded arm with its counts) and the epoch
    path (`phase_trainer_graph`), both routes in turns on both paths
    resumed from the loop's checkpoint on their route (`route_runs`),
    evaluate.

    Everything but the last block uses torch's default algorithms, as a
    user's training does.  No kernel of the path adds with atomics (every
    gather's backward is the fixed-order CSR reduce; the profiles hold the
    index_add_ family at 0), so a second fit() from the same seed must give
    the same epoch losses and final parameters bit for bit, the epoch path
    must give the loop's, and the runs resumed from a route's epoch-2
    checkpoint must repeat that route's epoch 3 loss to rtol 1e-4.  (The
    two routes' losses are not held to each other: their gradients' f32
    sums run in another order, and 16 Adam steps from one checkpoint took
    them 7.5e-3 apart.)  The last block repeats the resume under torch's
    deterministic algorithms: per route a fit() and a run resumed from its
    epoch-2 checkpoint, held to the same tolerance."""
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.params import tree_leaves, tree_unflatten

    out = {"foreach_div_by_float": foreach_div_rounding()}
    t0 = time.perf_counter()
    tr = Trainer(trainer_cfg(), trainer_workdir(root, "fit"),
                 device=DEVICE)
    out["init_s"] = time.perf_counter() - t0
    # banded_conv on builds the bands; the closed gates keep the
    # default route off them (the forced banded arm reads them)
    t = tr.model.tables
    require([b is not None for b in t.bands] == [True, True] + [False] * 3
            and all(b is not None for b in t.unpool_bands),
            "expected conv bands at levels 0-1 and four unpool bands")
    require(tr.device_data is not None, "data not staged on the device")
    require(not tr._epoch_scan_ok(), "epoch_scan False takes the loop")
    n_steps = len(tr.train_loader) * 3
    n_val = len(tr.val_loader) * 3
    require(n_val == 3, "expected one validation batch per epoch")

    # --- the loop: counts from 0, read right after; the exchange
    # variant of each step recorded -------------------------------------
    variants, get = [], tr._get_step

    def get_step(epoch, variant):
        variants.append(variant)
        return get(epoch, variant)

    tr._get_step = get_step
    sync()
    reset_counts()
    t0 = time.perf_counter()
    tr.fit()
    sync()
    out["fit_s"] = time.perf_counter() - t0
    counts = read_counts()
    tr._get_step = get
    require(len(variants) == n_steps
            and set(variants) <= {"ori", "m"},
            f"exchange variants {variants}")
    n_m = variants.count("m")
    # a validation batch of 16 is one forward on the B <= 16 routes
    want = {k: TRAIN_LAUNCHES.get(k, 0) * n_steps
            + VAL_LAUNCHES.get(k, 0) * n_val
            - M_VARIANT_FEWER.get(k, 0) * n_m for k in KERNEL_COUNTS}
    log(f"[trainer] fit: {n_steps} steps ({n_m} with the 'm' exchange), "
        f"{n_val} val batches, launches {counts}")
    require(counts == want, f"trainer launches {counts}, want {want}")
    hist = tr.history
    losses = [h["train"] for h in hist]
    log(f"[trainer] epochs {[(h['epoch'], h['train'], h['val'], h['sec']) for h in hist]}")
    require(all(np.isfinite(losses)) and all(
        np.isfinite(h["val"]) for h in hist), "non-finite epoch loss")
    require(losses[2] < losses[1] < losses[0],
            f"epoch losses not falling: {losses}")
    out.update(counts=counts, epoch_losses=losses,
               epoch_val=[h["val"] for h in hist],
               epoch_s=[h["sec"] for h in hist])
    ckpt = os.path.join(tr.workdir, "checkpoints")
    require(os.path.isdir(os.path.join(ckpt, "2")),
            "no epoch-2 checkpoint")
    # phase 9 resumes the epoch path from it through the reference layout
    out["epoch2_checkpoint"] = ckpt
    final = tree_unflatten(tr.params, [p.detach().clone()
                                       for p in tree_leaves(tr.params)])
    del tr

    # --- a second fit from the same seed, default algorithms: the
    # same bits (no kernel of the path adds with atomics) ---------------
    tr = Trainer(trainer_cfg(), trainer_workdir(root, "refit"),
                 device=DEVICE)
    tr.fit()
    again = [h["train"] for h in tr.history]
    same = params_equal(final, tr.params)
    log(f"[trainer] second fit, default algorithms: epoch losses "
        f"{again} (first {losses}); {sum(same)} of {len(same)} "
        "parameter tensors bit-equal")
    require(again == losses and all(same) and len(same) == 24,
            "two default-mode fits from one seed differ")
    out["refit_epoch_losses"] = again
    del tr

    # --- the forced banded arm (FORCED_GATES): the same fit on the
    # banded routes, its launches counted; its epoch-2 checkpoint is
    # where the banded runs below resume ---------------------------------
    with band_gates(*FORCED_GATES), variant_probe() as variants_b:
        tr = Trainer(trainer_cfg(), trainer_workdir(root, "banded_fit"),
                     device=DEVICE)
        sync()
        reset_counts()
        tr.fit()
        sync()
        counts_b = read_counts()
    n_m = variants_b.count("m")
    want = {k: TRAIN_LAUNCHES_BANDED.get(k, 0) * n_steps
            + VAL_LAUNCHES_BANDED.get(k, 0) * n_val
            - M_VARIANT_FEWER.get(k, 0) * n_m for k in KERNEL_COUNTS}
    losses_b = [h["train"] for h in tr.history]
    log(f"[trainer] forced banded fit: epoch losses {losses_b}, {n_m} "
        f"steps with the 'm' exchange, launches {counts_b}")
    require(len(variants_b) == n_steps and counts_b == want,
            f"forced banded fit: launches {counts_b}, want {want}")
    require(all(np.isfinite(losses_b))
            and losses_b[2] < losses_b[1] < losses_b[0],
            f"forced banded fit: epoch losses {losses_b}")
    out.update(banded_counts=counts_b, banded_epoch_losses=losses_b)
    resume_from = {"banded": (losses_b, os.path.join(tr.workdir,
                                                     "checkpoints")),
                   "take": (losses, ckpt)}
    del tr

    # --- the epoch path: (a), (c), (d) ----------------------------------
    graph = phase_trainer_graph(root, losses, final, ckpt)
    out["graph_counts"] = graph.pop("counts")
    out["graph"] = graph
    del final

    # --- (b), (e): both routes, both paths, in turns --------------------
    out["routes"] = route_runs(root, resume_from)

    # --- the exact gate, under deterministic algorithms: a fit, then
    # its epoch 3 repeated from its epoch-2 checkpoint ---------------------
    with deterministic_torch():
        for banded in (True, False):
            name = "banded" if banded else "take"
            with route_gates(banded):
                tr = Trainer(trainer_cfg(),
                             trainer_workdir(root, f"held_fit_{name}"),
                             device=DEVICE)
                tr.fit()
                held = [h["train"] for h in tr.history]
                held_ckpt = os.path.join(tr.workdir, "checkpoints")
                out.update({
                    f"deterministic_{name}_epoch_losses": held,
                    f"deterministic_{name}_epoch_s":
                        [h["sec"] for h in tr.history]})
                del tr
                tr, _times, loss3 = resumed_epoch(root, f"held_{name}",
                                                  banded, held_ckpt)
            log(f"[trainer] resumed {name}, deterministic: epoch 3 loss "
                f"{loss3:.9f} (uninterrupted {held[2]:.9f})")
            np.testing.assert_allclose(loss3, held[2], rtol=1e-4)
            out[f"resumed_{name}_loss"] = loss3
            del tr
    return out


def profile_epoch(tr) -> dict:
    """Device time per step by kernel name over one more epoch of steps
    (torch.profiler); the caller sets it against the unprofiled step time
    for the idle share."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return {}
    n = len(tr.train_loader)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr._run_epoch_steps(3, tr.interp_loader.cycle(anchor=3))
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    if not by_name:
        log("[profile] trainer: the profiler saw no device kernels; device "
            "time not measured")
        return {}
    busy = sum(by_name.values())
    log(f"[profile] trainer step: device busy {busy:.3f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, t in top:
        log(f"[profile]   {t:8.4f} ms  {name[:90]}")
    groups = {label: sum(t for nm, t in by_name.items() if key in nm)
              for label, key in PROFILE_GROUPS.items()}
    log(f"[profile] trainer by kernel family, ms per step: "
        f"{ {k: round(v, 4) for k, v in groups.items()} }")
    require(groups["index_add"] == 0, f"the Trainer's epoch ran index_add_ "
            f"kernels ({groups['index_add']:.4f} ms a step)")
    return {"device_busy_ms": busy,
            "top_kernels": [[nm[:90], t] for nm, t in top],
            "kernel_families_ms": groups}


DFAUST_CONFIG = ROOT / "configs" / "train_dfaust.yaml"
# the dataset phase 8 preprocesses: the Trainer phase's cut (64 train, 16
# test meshes) at SMPL scale, 8 train meshes carved off as the val split
DFAUST_TRAIN, DFAUST_TEST, DFAUST_VAL = 64, 16, 8
DFAUST_EPOCHS = 2
# epoch 1's train loss of the stacked layout (the epoch path, its splits
# normalized on the device) against the per-sample layout (the loop, its
# batches normalized on the host): the same batches and edit specs, inputs
# that differ in the last bits of the zeroroot offset, through the bf16
# trunk and 14 Adam steps.  Stated before the first run: 1e-2, four bf16
# roundings (2^-8 each) of room.
DFAUST_LOSS_RTOL = 1e-2


@contextlib.contextmanager
def compile_probe():
    """Count the topology compiler's hierarchy builds and time each call
    the Trainer makes to compile_topology (a compile, or a read of its
    workdir cache)."""
    from semantichuman_torch.topology import compiler
    from semantichuman_torch.train import loop

    rec = {"builds": 0, "compile_s": []}
    build, comp = compiler.build_hierarchy, loop.compile_topology

    def build_hierarchy(*args, **kw):
        rec["builds"] += 1
        return build(*args, **kw)

    def compile_topology(*args, **kw):
        t0 = time.perf_counter()
        hier = comp(*args, **kw)
        rec["compile_s"].append(time.perf_counter() - t0)
        return hier

    compiler.build_hierarchy, loop.compile_topology = (build_hierarchy,
                                                       compile_topology)
    try:
        yield rec
    finally:
        compiler.build_hierarchy, loop.compile_topology = build, comp


@contextlib.contextmanager
def variant_probe():
    """Record the exchange variant of each loop step of any Trainer."""
    from semantichuman_torch.train.loop import Trainer

    variants, get = [], Trainer._get_step

    def get_step(self, epoch, variant):
        variants.append(variant)
        return get(self, epoch, variant)

    Trainer._get_step = get_step
    try:
        yield variants
    finally:
        Trainer._get_step = get


def preprocess(root: Path) -> dict:
    """The port's preprocessing CLIs into root, as a user runs them:
    make_synthetic (SMPL scale), obj2npy, data_generation.  -> seconds
    each."""
    from semantichuman_torch.cli import (data_generation, make_synthetic,
                                         obj2npy)

    secs = {}
    t0 = time.perf_counter()
    make_synthetic.main(["--out_dir", str(root), "--n_train",
                         str(DFAUST_TRAIN), "--n_test", str(DFAUST_TEST)])
    secs["make_synthetic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    obj2npy.main(["--save_path", str(root),
                  "--trainobj_path", str(root / "obj_train"),
                  "--testobj_path", str(root / "obj_test"),
                  "--asset_dir", str(root / "asset")])
    secs["obj2npy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_generation.main(["-r", str(root), "--n_val", str(DFAUST_VAL)])
    secs["data_generation"] = time.perf_counter() - t0
    return secs


def dfaust_config(root: Path, out: Path, from_stacked: bool,
                  **data) -> str:
    """configs/train_dfaust.yaml with root_dir, asset_dir and n_val set to
    the preprocessed dataset (and data.from_stacked off for the
    per-sample layout, and any other data field given), written as a
    YAML file for cli.train."""
    import yaml

    raw = yaml.safe_load(DFAUST_CONFIG.read_text())
    raw["data"].update(root_dir=str(root), asset_dir=str(root / "asset"),
                       n_val=DFAUST_VAL, **data)
    if not from_stacked:
        raw["data"]["from_stacked"] = False
    out.write_text(yaml.safe_dump(raw))
    return str(out)


def dfaust_run(root: Path, tmp: Path, layout: str, **data) -> tuple:
    """`cli.train --config <train_dfaust> --epochs 2` on the card, the
    launch counts set to 0 just before and read just after.  -> (trainer,
    counts, compile probe, graph captures, loop variants, seconds)."""
    from semantichuman_torch.cli import train as train_cli

    cfg = dfaust_config(root, tmp / f"train_dfaust_{layout}.yaml",
                        layout == "stacked", **data)
    with compile_probe() as comp, graph_probe() as caps, \
            variant_probe() as variants:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(["--config", cfg, "--workdir",
                             str(tmp / layout), "--epochs",
                             str(DFAUST_EPOCHS), "--device", DEVICE])
        sync()
        secs = time.perf_counter() - t0
        counts = read_counts()
    return tr, counts, comp, caps, variants, secs


def dfaust_checks(tr, counts, caps, variants, layout: str) -> dict:
    """One layout's gates: the route it took, finite falling epoch
    losses, a finite test eval, the launches; ms/step of epoch 2 and the
    device idle share (one profiled epoch more)."""
    graph = layout == "stacked"
    require(tr._epoch_scan_ok() == graph, f"{layout}: the Trainer takes "
            f"{'the loop' if graph else 'the epoch path'}")
    require(tr.model.compute_dtype == torch.bfloat16
            and not tr.model.tables.banded_conv,
            f"{layout}: not the DFAUST recipe's bf16 take-route trunk")
    hist = tr.history
    losses = [h["train"] for h in hist]
    log(f"[dfaust] {layout}: epochs {[(h['epoch'], h['train'], h['val'], h['sec']) for h in hist]}")
    require(len(losses) == DFAUST_EPOCHS and all(np.isfinite(losses))
            and all(np.isfinite(h["val"]) for h in hist),
            f"{layout}: non-finite epoch loss {losses}")
    require(losses[1] < losses[0], f"{layout}: epoch losses not falling: "
            f"{losses}")
    report = Path(tr.workdir, "checkpoints", "train_params.txt").read_text()
    l1 = float(re.findall(r"autoencoder: L1 loss (\S+)", report)[-1])
    mm = float(re.findall(r"euclidean distance in mm (\S+)", report)[-1])
    preds = np.load(Path(tr.workdir, "predictions", "predictions.npy"))
    require(np.isfinite(l1) and np.isfinite(mm)
            and bool(np.isfinite(preds).all())
            and preds.shape[0] == DFAUST_TEST,
            f"{layout}: test eval l1 {l1} mm {mm}, predictions "
            f"{preds.shape}")
    n_steps = len(tr.train_loader) * DFAUST_EPOCHS
    n_eval = len(tr.val_loader) * DFAUST_EPOCHS + len(tr.test_loader)
    if graph:
        want_step = expect(GRAPH_LAUNCHES)
        got_step = [c["counts"] for c in caps]
        require(got_step == [want_step], f"{layout}: captured steps' "
                f"launches {got_step}, want one with {want_step}")
        # the two warm-up steps and the captured one (read_counts leaves
        # the replays out), and the staging of the train split in the
        # Trainer
        want = {k: GRAPH_LAUNCHES.get(k, 0) * 3
                + VAL_LAUNCHES.get(k, 0) * n_eval for k in KERNEL_COUNTS}
        want["row_gather"] += STAGE_GATHERS
    else:
        require(len(caps) == 0 and len(variants) == n_steps
                and set(variants) <= {"ori", "m"},
                f"{layout}: captures {len(caps)}, variants {variants}")
        n_m = variants.count("m")
        want = {k: TRAIN_LAUNCHES.get(k, 0) * n_steps
                + VAL_LAUNCHES.get(k, 0) * n_eval
                - M_VARIANT_FEWER.get(k, 0) * n_m for k in KERNEL_COUNTS}
        want["row_gather"] += UNSTAGED_GT_GATHERS * n_steps - n_m
    log(f"[dfaust] {layout}: {n_steps} steps, {n_eval} eval batches, "
        f"launches {counts}")
    require(counts == want, f"{layout}: launches {counts}, want {want}")
    k = len(tr.train_loader)
    ms = hist[-1]["train_sec"] / k * 1e3
    prof = profile_replays(tr, DFAUST_EPOCHS + 1) if graph \
        else profile_epoch(tr)
    busy = prof.get("device_busy_ms")
    idle = None if busy is None else max(0.0, 1 - busy / ms)
    log(f"[dfaust] {layout}: epoch {DFAUST_EPOCHS} {ms:.3f} ms/step "
        f"({k} steps), device busy {busy} ms a step, idle share {idle}; "
        f"test eval l1 {l1:.6f}, {mm:.3f} mm")
    return {"epoch_losses": losses, "epoch_val": [h["val"] for h in hist],
            "epoch_s": [h["sec"] for h in hist], "ms_per_step": ms,
            "device_busy_ms": busy, "idle_share": idle, "test_l1": l1,
            "test_mm": mm, "counts": counts, "profile": prof}


def copy_cache(cache: Path, workdir: Path) -> None:
    """A compiled hierarchy and its .meta key into a new workdir."""
    workdir.mkdir()
    for suffix in ("", ".meta"):
        shutil.copy(str(cache) + suffix, workdir / (cache.name + suffix))


def dfaust_dataset(tmp: Path) -> tuple:
    """The SMPL-scale dataset of phases 8 and 9, tmp/DFAUST: built by the
    port's preprocessing CLIs at first use, reused after.  -> (root, the
    seconds of each CLI, or None where it was reused)."""
    root = tmp / "DFAUST"
    if (root / "preprocessed").is_dir():
        return root, None
    return root, preprocess(root)


def phase_dfaust(card: str, tmp: Path) -> dict:
    """Phase 8: training from an on-disk dataset on the card, in the
    directory tmp.  The port's preprocessing CLIs build an SMPL-scale
    dataset (64 train, 16 test meshes, 8 of the train meshes the val
    split; `dfaust_dataset`); cli.train trains
    configs/train_dfaust.yaml (bf16 trunk, banded_conv off, the DFAUST
    recipe's losses) for 2 epochs from (a) the stacked layout (staged: the
    epoch path) and (b) the per-sample layout (data.from_stacked off:
    FileSource, the loop with prefetch_to_device).  (a) compiles the first
    train frame's template into its workdir, (b) reads that cache; both
    give finite falling losses, a finite test eval and the launches
    counted; the first host batch of (a) equals (b)'s and epoch 1's loss
    agrees to DFAUST_LOSS_RTOL; the port's compile of the bundled
    synthetic template equals assets/topology_synth_full_2222.npz array
    for array."""
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.topology import compile_topology

    out = {}
    root, out["preprocess_s"] = dfaust_dataset(tmp)
    log(f"[dfaust] preprocessing {out['preprocess_s']} s")

    tr_a, counts_a, comp_a, caps_a, var_a, secs_a = dfaust_run(
        root, tmp, "stacked")
    cache = tmp / "stacked" / "topology_2222.npz"
    require(comp_a["builds"] == 1 and cache.exists()
            and Path(str(cache) + ".meta").exists(),
            f"(a): the topology was not compiled into the workdir "
            f"({comp_a})")
    out["stacked"] = dfaust_checks(tr_a, counts_a, caps_a, var_a,
                                   "stacked")
    out["stacked"].update(run_s=secs_a, compile_s=comp_a["compile_s"])

    copy_cache(cache, tmp / "files")
    tr_b, counts_b, comp_b, caps_b, var_b, secs_b = dfaust_run(
        root, tmp, "files")
    require(comp_b["builds"] == 0, "(b): the cached topology was "
            f"compiled again ({comp_b})")
    out["files"] = dfaust_checks(tr_b, counts_b, caps_b, var_b, "files")
    out["files"].update(run_s=secs_b, compile_s=comp_b["compile_s"])
    # prefetch's effect on (b): the same run with the batches staged
    # inline (data.prefetch 0); one run, a record, no gate
    copy_cache(cache, tmp / "files_inline")
    tr_c = dfaust_run(root, tmp, "files_inline", prefetch=0)[0]
    k = len(tr_c.train_loader)
    out["files_inline_ms_per_step"] = \
        tr_c.history[-1]["train_sec"] / k * 1e3
    require([h["train"] for h in tr_c.history]
             == out["files"]["epoch_losses"],
             "the per-sample layout trains otherwise without prefetch")
    log(f"[dfaust] files, data.prefetch 0: epoch {DFAUST_EPOCHS} "
        f"{out['files_inline_ms_per_step']:.3f} ms/step (prefetch "
        f"{tr_b.cfg.data.prefetch}: {out['files']['ms_per_step']:.3f})")
    del tr_c

    host_a = tr_a.train_loader.loader
    host_a.set_epoch(1)
    tr_b.train_loader.set_epoch(1)
    first_a, first_b = next(iter(host_a)), next(iter(tr_b.train_loader))
    require(all(np.array_equal(first_a[key], first_b[key])
                for key in ("verts", "measure", "global_idx")),
            "the first host batch differs between the layouts")
    la, lb = (out["stacked"]["epoch_losses"][0],
              out["files"]["epoch_losses"][0])
    gap = abs(la - lb) / abs(lb)
    log(f"[dfaust] epoch 1 loss: stacked {la!r}, per-sample {lb!r}, "
        f"relative gap {gap:.3e} (tolerance {DFAUST_LOSS_RTOL})")
    require(gap <= DFAUST_LOSS_RTOL, f"epoch 1 loss gap {gap:.3e}")
    out["epoch1_gap"] = gap
    del tr_a, tr_b
    torch.cuda.empty_cache()

    sh = SyntheticHuman()
    t0 = time.perf_counter()
    compile_topology(sh.template_verts, sh.template_faces,
                     reference_vertex=414,
                     cache_path=str(tmp / "full.npz"))
    out["full_compile_s"] = time.perf_counter() - t0
    with np.load(tmp / "full.npz") as got, np.load(TOPOLOGY) as want:
        same = sorted(got.files) == sorted(want.files) and all(
            got[k].dtype == want[k].dtype
            and np.array_equal(got[k], want[k]) for k in want.files)
    require(same, "the full-scale compile differs from "
            f"{TOPOLOGY.name}")
    a, b = out["stacked"], out["files"]
    log(f"[dfaust] {card}: preprocessing "
        f"{sum(out['preprocess_s'].values()):.2f} s, compile "
        f"{a['compile_s'][0]:.2f} s (cached read "
        f"{b['compile_s'][0]:.3f} s, full-scale template "
        f"{out['full_compile_s']:.2f} s); stacked {a['ms_per_step']:.3f} "
        f"ms/step idle {a['idle_share']}, per-sample {b['ms_per_step']:.3f} "
        f"ms/step idle {b['idle_share']} (inline staging "
        f"{out['files_inline_ms_per_step']:.3f} ms/step)")
    return out


N3DMM_CONFIG = ROOT / "configs" / "train_neural3dmm.yaml"
N3DMM_EPOCHS = 3


def n3dmm_config(root: Path, out: Path, loop: bool = True) -> str:
    """configs/train_neural3dmm.yaml with root_dir, asset_dir and n_val set
    to the preprocessed dataset and N3DMM_EPOCHS epochs, and with `loop`
    the loop (epoch_scan off, which loop_probe times; without it the
    file's epoch path, the Trainer's default), written as a YAML file for
    cli.train (nz 256, B 16, zeroroot, banded_conv off as the file has
    them)."""
    import yaml

    raw = yaml.safe_load(N3DMM_CONFIG.read_text())
    raw["data"].update(root_dir=str(root), asset_dir=str(root / "asset"),
                       n_val=DFAUST_VAL)
    raw["train"]["n_epochs"] = N3DMM_EPOCHS
    if loop:
        raw["train"]["epoch_scan"] = False
    out.write_text(yaml.safe_dump(raw))
    return str(out)


@contextlib.contextmanager
def loop_probe(save_at: int):
    """Wrap the loop of every Trainer: a synchronize after each step and
    its host time in ms, by epoch (from the end of the step before, or the
    start of the epoch), and the state saved as the epoch-`save_at`
    checkpoint right after that epoch's steps (what fit() saves at a
    checkpoint epoch; the recipe's ck_frequency is 100)."""
    from semantichuman_torch.train.loop import Trainer

    rec = {"step_ms": {}}
    get, run = Trainer._get_step, Trainer._run_epoch_steps
    last = [0.0]

    def get_step(self, epoch, variant):
        step = get(self, epoch, variant)

        def timed(*args):
            out = step(*args)
            sync()
            now = time.perf_counter()
            rec["step_ms"].setdefault(epoch, []).append((now - last[0]) * 1e3)
            last[0] = now
            return out
        return timed

    def run_epoch(self, epoch, interp_iter):
        last[0] = time.perf_counter()
        out = run(self, epoch, interp_iter)
        if epoch == save_at:
            self.save(epoch)
        return out

    Trainer._get_step, Trainer._run_epoch_steps = get_step, run_epoch
    try:
        yield rec
    finally:
        Trainer._get_step, Trainer._run_epoch_steps = get, run


def part_pads(tree, model) -> list:
    """The zero pads of PartAE's batched part heads in a tree shaped like
    its parameters (the parameters or an Adam moment): the encoder rows
    past a part's n_p x C, the decoder columns past n_p x C0, the keypoint
    rows past 3 x its group's size."""
    c, c0 = model.enc_out_c, model.dec_in_c
    out = []
    for p, (n_p, grp) in enumerate(zip(model.part_sizes,
                                       model.kps_index_list)):
        out += [tree["enc_heads"]["w"][p, n_p * c:],
                tree["dec_heads"]["w"][p, :, n_p * c0:],
                tree["dec_heads"]["b"][p, n_p * c0:],
                tree["kps_heads"]["w"][p, len(grp) * 3:]]
    return out


def reference_state_dict(tree, model) -> dict:
    """A tree shaped like the model's parameters (the parameters or an
    Adam moment) in the reference's layout, as CPU tensors: weights [out,
    in], the transpose of the port's; the part heads without their pads.
    PartAE's keys in the order of `benchmarks/torch_baseline.py:
    reference_state_dict` (conv, dconv, fc_latent_enc_list, kps_enc_list,
    fc_latent_dec_list), SpiralAE's in the order neural3DMM's
    SpiralAutoencoder registers them (conv, fc_latent_enc, fc_latent_dec,
    dconv)."""
    sd = {}

    def cpu(t):
        return t.detach().to("cpu").clone(memory_format=torch.contiguous_format)

    def lin(name, w, b):
        sd[f"{name}.weight"] = cpu(w.t())
        sd[f"{name}.bias"] = cpu(b)

    def convs(name, layers):
        for i, layer in enumerate(layers):
            lin(f"{name}.{i}.conv", layer["w"], layer["b"])

    convs("conv", tree["conv"])
    if not hasattr(model, "kps_encode"):
        lin("fc_latent_enc", tree["fc_enc"]["w"], tree["fc_enc"]["b"])
        lin("fc_latent_dec", tree["fc_dec"]["w"], tree["fc_dec"]["b"])
        convs("dconv", tree["dconv"])
        return sd
    convs("dconv", tree["dconv"])
    c, c0 = model.enc_out_c, model.dec_in_c
    enc, dec, kps = tree["enc_heads"], tree["dec_heads"], tree["kps_heads"]
    for p, n_p in enumerate(model.part_sizes):
        lin(f"fc_latent_enc_list.{p}", enc["w"][p, :n_p * c], enc["b"][p])
    for p, grp in enumerate(model.kps_index_list):
        lin(f"kps_enc_list.{p}", kps["w"][p, :len(grp) * 3], kps["b"][p])
    for p, n_p in enumerate(model.part_sizes):
        lin(f"fc_latent_dec_list.{p}", dec["w"][p, :, :n_p * c0],
            dec["b"][p, :n_p * c0])
    return sd


def write_reference_checkpoint(path: str, state: dict, model,
                               train_cfg) -> None:
    """The port's checkpoint `state` ({"params", "opt_state", "epoch",
    "step"}, `utils/checkpoint.py`) as the reference's `.pth.tar`
    (train_funcs.py:450-455): `autoencoder_state_dict`
    (reference_state_dict), `optimizer_state_dict` laid out as
    torch.optim.Adam.state_dict() (integer keys in the state dict's
    order, each {"step", "exp_avg", "exp_avg_sq"}; one param group),
    `scheduler_state_dict` with the configured gamma, and the epoch.  The
    part heads' pads and their moments must be exactly 0 (else the
    reference layout cannot carry the state), and Adam's count the
    schedule's step, epoch x steps_per_epoch."""
    from semantichuman_torch.utils.params import tree_unflatten

    params, opt = state["params"], state["opt_state"]
    trees = {"params": params,
             "exp_avg": tree_unflatten(params, list(opt["mu"])),
             "exp_avg_sq": tree_unflatten(params, list(opt["nu"]))}
    if hasattr(model, "kps_encode"):
        for name, tree in trees.items():
            bad = sum(int(torch.count_nonzero(t))
                      for t in part_pads(tree, model))
            require(bad == 0, f"{bad} entries of the part heads' pads of "
                    f"the {name} are not 0")
    require(opt.get("schedule_offset", 0) == 0
            and opt["notfinite_count"] == 0
            and opt["count"] == state["step"],
            f"Adam's count {opt['count']} is not the schedule's step "
            f"{state['step']}")
    sd, m, v = (reference_state_dict(t, model) for t in trees.values())
    epoch = int(state["epoch"])
    t = train_cfg
    torch.save({
        "epoch": epoch,
        "autoencoder_state_dict": sd,
        "optimizer_state_dict": {
            "state": {i: {"step": torch.tensor(float(opt["count"])),
                          "exp_avg": m[k], "exp_avg_sq": v[k]}
                      for i, k in enumerate(sd)},
            "param_groups": [{"lr": t.lr * t.lr_decay ** epoch,
                              "betas": (0.9, t.adam_b2), "eps": 1e-8,
                              "weight_decay": t.weight_decay,
                              "amsgrad": False,
                              "params": list(range(len(sd)))}]},
        "scheduler_state_dict": {"gamma": t.lr_decay, "last_epoch": epoch},
    }, path)


def resume_round_trip(name: str, cfg, workdir, ckpt: str, tmp: Path,
                      want_fn) -> dict:
    """Phase 9 (b) for one model family: the port's epoch-2 checkpoint
    under `ckpt`, written in the reference's layout
    (write_reference_checkpoint), resumed for epoch 3 once through
    train.resume_torch and once through train.resume; the epoch-3 loss and
    every parameter tensor must be equal, and each resumed fit launch
    want_fn(trainer).  workdir(tag) makes a Trainer's workdir."""
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.checkpoint import restore_checkpoint
    from semantichuman_torch.utils.import_torch import \
        load_reference_training_state
    from semantichuman_torch.utils.params import tree_leaves

    t = cfg.train

    def trainer(tag, **train):
        c = dataclasses.replace(cfg, train=dataclasses.replace(t, **train))
        return Trainer(c, workdir(tag), device=DEVICE)

    out = {}
    native = trainer("resume", resume=ckpt)
    require(native.start_epoch == 3, f"{name}: resumed at epoch "
            f"{native.start_epoch}")
    state, step = restore_checkpoint(ckpt, device=DEVICE)
    pth = tmp / f"{name}_checkpoint{step}.pth.tar"
    write_reference_checkpoint(str(pth), state, native.model, t)
    del state
    out["pth_mb"] = pth.stat().st_size / 2 ** 20
    sync()
    t0 = time.perf_counter()
    load_reference_training_state(str(pth), native.model,
                                  native.steps_per_epoch, lr_decay=t.lr_decay)
    sync()
    out["load_s"] = time.perf_counter() - t0
    ref = trainer("resume_torch", resume_torch=str(pth))
    pth.unlink()
    got = (ref.start_epoch, ref.global_step, ref.opt_state.count,
           ref.opt_state.schedule_offset)
    want = (3, native.global_step, native.opt_state.count, 0)
    require(got == want, f"{name}: resume_torch at (epoch, step, count, "
            f"offset) {got}, the native resume at {want}")
    counts = {}
    for tag, tr in (("resume", native), ("resume_torch", ref)):
        sync()
        reset_counts()
        tr.fit()
        sync()
        counts[tag] = read_counts()
        require(counts[tag] == want_fn(tr), f"{name} {tag}: launches "
                f"{counts[tag]}, want {want_fn(tr)}")
    losses = [native.history[0]["train"], ref.history[0]["train"]]
    same = params_equal(native.params, ref.params)
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(native.params), tree_leaves(ref.params))]
    log(f"[baseline] (b) {name}: reference checkpoint "
        f"{out['pth_mb']:.1f} MiB, loaded in {out['load_s']:.3f} s (host); "
        f"epoch 3 loss resume_torch {losses[1]!r}, resume {losses[0]!r}; "
        f"{sum(same)} of {len(same)} parameter tensors bit-equal, largest "
        f"difference {max(diffs):.3e}")
    require(losses[0] == losses[1] and all(same),
            f"{name}: resume_torch differs from the native resume")
    out.update(epoch3_loss=losses[1], counts=counts["resume_torch"])
    return out


def phase_baseline(card: str, tmp: Path, partae_ckpt: str | None) -> dict:
    """Phase 9, in the directory tmp: (a) cli.train with
    configs/train_neural3dmm.yaml (n3dmm_config) for N3DMM_EPOCHS epochs
    on phase 8's dataset (`dfaust_dataset`) through the loop, its gates
    and times, then the file as written on the epoch path against it; (b)
    resume_torch bit-equal to a native resume for both model families: the
    neural3DMM run of (a) on the loop from the checkpoint loop_probe saves
    at epoch 2, and PartAE at Config() defaults on its epoch path from
    `partae_ckpt` (phase 7's epoch-2 checkpoint; None: a 2-epoch fit makes
    one)."""
    from semantichuman_torch.cli import train as train_cli
    from semantichuman_torch.config import Config
    from semantichuman_torch.models import SpiralAE
    from semantichuman_torch.ops import launches
    from semantichuman_torch.ops.spiral_conv import spiral_conv_plain
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.train.step import (flags_for_epoch,
                                                make_baseline_loss_fn,
                                                value_and_grad)
    from semantichuman_torch.utils.params import tree_leaves

    t_phase = time.perf_counter()
    out = {}
    root, out["preprocess_s"] = dfaust_dataset(tmp)
    wd = tmp / "p9_n3dmm"
    cache = tmp / "stacked" / "topology_2222.npz"
    if cache.exists():
        copy_cache(cache, wd)           # phase 8 compiled this template
    cfg_path = n3dmm_config(root, tmp / "train_neural3dmm.yaml")

    # --- (a) the recipe through cli.train, counts from 0 ------------------
    with loop_probe(save_at=2) as probe:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(["--config", cfg_path, "--workdir", str(wd),
                             "--device", DEVICE])
        sync()
        out["run_s"] = time.perf_counter() - t0
        counts = read_counts()
    require(isinstance(tr.model, SpiralAE) and tr.model.latent_size == 256
            and tr.cfg.train.batch_train == 16
            and tr.cfg.data.normalization == "zeroroot"
            and not tr.model.tables.banded_conv
            and tr.model.compute_dtype is None and not tr._epoch_scan_ok()
            and tr.device_data is not None,
            "(a) is not the neural3DMM recipe (nz 256, B 16, zeroroot, "
            "f32 take route) on staged data through the loop")
    # the loop's state after its fit, before the checks below train on
    loop_params = [t.detach().clone() for t in tree_leaves(tr.params)]
    hist = tr.history
    losses = [h["train"] for h in hist]
    log(f"[baseline] (a) epochs {[(h['epoch'], h['train'], h['val'], h['sec']) for h in hist]}")
    require(len(losses) == N3DMM_EPOCHS and all(np.isfinite(losses))
            and all(np.isfinite(h["val"]) for h in hist)
            and losses[2] < losses[1] < losses[0],
            f"(a): epoch losses {losses}")
    report = Path(tr.workdir, "checkpoints", "train_params.txt").read_text()
    l1 = float(re.findall(r"autoencoder: L1 loss (\S+)", report)[-1])
    mm = float(re.findall(r"euclidean distance in mm (\S+)", report)[-1])
    preds = np.load(Path(tr.workdir, "predictions", "predictions.npy"))
    require(np.isfinite(l1) and np.isfinite(mm)
            and bool(np.isfinite(preds).all())
            and preds.shape[0] == DFAUST_TEST,
            f"(a): test eval l1 {l1} mm {mm}, predictions {preds.shape}")
    n_steps = len(tr.train_loader) * N3DMM_EPOCHS
    n_eval = len(tr.val_loader) * N3DMM_EPOCHS + len(tr.test_loader)
    want = {k: TRAIN_LAUNCHES_N3DMM.get(k, 0) * n_steps
            + VAL_LAUNCHES_N3DMM.get(k, 0) * n_eval for k in KERNEL_COUNTS}
    want["row_gather"] += STAGE_GATHERS
    log(f"[baseline] (a) {n_steps} steps, {n_eval} eval batches, launches "
        f"{counts}")
    require(counts == want, f"(a): launches {counts}, want {want}")

    # one loss + gradient through the kernels against the plain conv
    batch = tr._step_view(next(iter(tr.train_loader)))
    flags = flags_for_epoch(tr.cfg.train, N3DMM_EPOCHS)
    plain = copy.copy(tr.model)
    plain.conv_fn = spiral_conv_plain
    got = value_and_grad(make_baseline_loss_fn(tr.model, tr.tables, flags),
                         tr.params, batch)
    ref = value_and_grad(make_baseline_loss_fn(plain, tr.tables, flags),
                         tr.params, batch)
    require(sorted(got[1]) == sorted(ref[1]) == ["edgereg", "loss", "rec"],
            f"metrics {sorted(got[1])}")
    for k in ref[1]:
        torch.testing.assert_close(got[1][k], ref[1][k], rtol=1e-4, atol=0,
                                   msg=lambda m: f"(a) metric {k}: {m}")
    grad_errs = [rel_err(g, r) for g, r in zip(tree_leaves(got[2]),
                                               tree_leaves(ref[2]))]
    log(f"[baseline] (a) kernels against the plain conv: loss "
        f"{float(got[0]):.7f} / {float(ref[0]):.7f}, per-leaf gradient "
        f"error max {max(grad_errs):.3e} over {len(grad_errs)} leaves")
    require(max(grad_errs) <= 1e-4, f"(a) gradient errors {grad_errs}")
    del got, ref, plain

    ms = float(np.median(probe["step_ms"][N3DMM_EPOCHS]))
    prof = profile_epoch(tr)
    busy = prof.get("device_busy_ms")
    idle = None if busy is None else max(0.0, 1 - busy / ms)
    b = tr.cfg.train.batch_train
    out.update(epoch_losses=losses, epoch_val=[h["val"] for h in hist],
               test_l1=l1, test_mm=mm, ms_per_step=ms,
               step_ms=probe["step_ms"], meshes_per_s=b / ms * 1e3,
               device_busy_ms=busy, idle_share=idle,
               grad_rel_err_max=max(grad_errs), counts=counts,
               profile=prof)
    log(f"[baseline] (a) {card}: epoch {N3DMM_EPOCHS} {ms:.3f} ms/step "
        f"(median of {len(probe['step_ms'][N3DMM_EPOCHS])}, a synchronize "
        f"after each), {b / ms * 1e3:.1f} meshes/s, device busy {busy} ms "
        f"a step, idle share {idle}; test eval l1 {l1:.6f}, {mm:.3f} mm")
    n3dmm_ckpt = str(wd / "checkpoints")
    del tr
    torch.cuda.empty_cache()

    # --- (a) again: the file as written, the epoch path, counts from 0 ----
    wd_epoch = tmp / "p9_n3dmm_epoch"
    copy_cache(wd / "topology_2222.npz", wd_epoch)
    epoch_cfg = n3dmm_config(root, tmp / "train_neural3dmm_epoch.yaml",
                             loop=False)
    with graph_probe() as caps:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(["--config", epoch_cfg, "--workdir",
                             str(wd_epoch), "--device", DEVICE])
        sync()
        out["epoch_path_run_s"] = time.perf_counter() - t0
        counts = read_counts()
        replays = launches.read()["graph_replays"]["by_name"]
    require(isinstance(tr.model, SpiralAE) and tr._epoch_scan_ok()
            and tr.cfg.train.batch_train == 16,
            "(a) as written does not take the epoch path")
    n_steps = len(tr.train_loader) * N3DMM_EPOCHS
    replays = {name: n for name, n in replays.items() if n}
    log(f"[baseline] (a) epoch path: captures "
        f"{[c['counts'] for c in caps]}, replays {replays}")
    require(len(caps) == 1
            and caps[0]["counts"] == expect(TRAIN_LAUNCHES_N3DMM),
            f"(a) epoch path: captured steps' launches "
            f"{[c['counts'] for c in caps]}, want one with "
            f"{expect(TRAIN_LAUNCHES_N3DMM)}")
    (name, n), = replays.items()
    require(re.fullmatch(r"train/[0-9a-f]+/ori", name) is not None
            and n == n_steps
            and expect(launches.graph_record(name))
            == expect(TRAIN_LAUNCHES_N3DMM),
            f"(a) epoch path: replays {replays}, want {n_steps} of one "
            "train/<flags>/ori graph")
    # the two warm-up steps and the captured one (read_counts leaves the
    # replays out), the validation and test batches and the staging
    want = {k: TRAIN_LAUNCHES_N3DMM.get(k, 0) * 3
            + VAL_LAUNCHES_N3DMM.get(k, 0) * n_eval for k in KERNEL_COUNTS}
    want["row_gather"] += STAGE_GATHERS
    require(counts == want, f"(a) epoch path: launches {counts}, want "
            f"{want}")
    got = [h["train"] for h in tr.history]
    same = [torch.equal(x, y) for x, y in zip(loop_params,
                                              tree_leaves(tr.params))]
    k = len(tr.train_loader)
    epoch_ms = tr.history[-1]["train_sec"] / k * 1e3
    log(f"[baseline] (a) epoch path {card}: epoch losses {got} (loop "
        f"{losses}); {sum(same)} of {len(same)} parameter tensors bit-equal "
        f"to the loop's; epoch {N3DMM_EPOCHS} {epoch_ms:.3f} ms/step "
        f"({k} steps, no synchronize), {b / epoch_ms * 1e3:.1f} meshes/s")
    if not (got == losses and all(same)):
        for i, (x, y) in enumerate(zip(loop_params, tree_leaves(tr.params))):
            log(f"[baseline]   leaf {i}: max |epoch path - loop| "
                f"{float((x - y).abs().max()):.3e}")
    require(got == losses and all(same) and len(same) == 22,
            "(a): the epoch path's fit differs from the loop's")
    out.update(epoch_path_losses=got, epoch_path_ms_per_step=epoch_ms,
               epoch_path_counts=counts)
    del tr, loop_params
    torch.cuda.empty_cache()

    # --- (b) resume_torch against the native resume, both families --------
    def n3dmm_workdir(tag):
        d = tmp / f"p9_n3dmm_{tag}"
        copy_cache(wd / "topology_2222.npz", d)
        return str(d)

    out["n3dmm_resume"] = resume_round_trip(
        "neural3DMM", Config.from_yaml(cfg_path), n3dmm_workdir, n3dmm_ckpt,
        tmp, lambda t: {k: TRAIN_LAUNCHES_N3DMM.get(k, 0)
                        * len(t.train_loader)
                        + VAL_LAUNCHES_N3DMM.get(k, 0) * len(t.val_loader)
                        for k in KERNEL_COUNTS})
    if partae_ckpt is None:
        fit = Trainer(trainer_cfg(epoch_scan=True),
                      trainer_workdir(tmp, "p9_partae_fit"), device=DEVICE)
        fit.fit(2)
        partae_ckpt = os.path.join(fit.workdir, "checkpoints")
        del fit

    def partae_want(t):
        require(t._epoch_scan_ok(), "the PartAE resume takes the loop")
        # the two warm-up steps and the captured one, then validation
        return {k: GRAPH_LAUNCHES.get(k, 0) * 3
                + VAL_LAUNCHES.get(k, 0) * len(t.val_loader)
                for k in KERNEL_COUNTS}

    out["partae_resume"] = resume_round_trip(
        "PartAE", trainer_cfg(epoch_scan=True),
        lambda tag: trainer_workdir(tmp, f"p9_partae_{tag}"), partae_ckpt,
        tmp, partae_want)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[baseline] phase 9: {out['phase_s']:.1f} s")
    return out


def demo_launches() -> dict:
    """The launches of one run_demo (DEMO_CALLS), every kernel counted."""
    per = {"encode": ENCODE_LAUNCHES, "decode": DECODE_LAUNCHES,
           "kps_encode": KPS_ENCODE_LAUNCHES}
    return {k: sum(per[c].get(k, 0) * n for c, n in DEMO_CALLS.items())
            for k in KERNEL_COUNTS}


def graph_gate(runs: dict) -> int:
    """The rule that sets `serving.py:_GRAPH_MAX_B` from phase 10 (c):
    runs {b: {"eager": [ms, ...], "graph": [ms, ...]}} measured in turns;
    the largest batch b such that the captured forward's mean beats the
    eager program's at b and at every smaller batch measured (0: at
    none)."""
    gate = 0
    for b in sorted(runs):
        if np.mean(runs[b]["graph"]) >= np.mean(runs[b]["eager"]):
            break
        gate = b
    return gate


@contextlib.contextmanager
def no_plain_on_card():
    """Count the calls of the plain versions of rows 1 and 7 on a CUDA
    tensor in the block ({"spiral_conv_plain": n, "gather_rows_plain":
    n}): on the card the wrappers launch the kernels, and a call of a
    plain version there is a fallback."""
    from semantichuman_torch.ops import row_gather as RG

    sc = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    calls = {"spiral_conv_plain": 0, "gather_rows_plain": 0}
    saved = sc.spiral_conv_plain, RG.gather_rows_plain

    def counted(name, fn):
        def run(x, *args, **kw):
            calls[name] += x.device.type == "cuda"
            return fn(x, *args, **kw)
        return run

    sc.spiral_conv_plain = counted("spiral_conv_plain", saved[0])
    RG.gather_rows_plain = counted("gather_rows_plain", saved[1])
    try:
        yield calls
    finally:
        sc.spiral_conv_plain, RG.gather_rows_plain = saved


def host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Host ms per call of fn() over `reps` calls after `warmup`, a
    synchronize before and after (fn may end on the host)."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_cli(main, argv) -> tuple:
    """(return value, the last line it printed) of a CLI's main(argv)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    text = buf.getvalue()
    log(text.rstrip())
    lines = text.strip().splitlines()
    return ret, lines[-1] if lines else ""


def deploy_editor(model, params, assets, meshes, hier, tmp: Path) -> dict:
    """Phase 10 (a): the Editor on the card against the plain versions."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.constants import PART_LIST
    from semantichuman_torch.edit import Editor, run_demo
    from semantichuman_torch.models import build_model

    out = {}
    editor = Editor(model, params, assets, device=DEVICE)
    verts = meshes[:4]
    lat = editor.encode(verts)                       # warm-up, not counted
    editor.decode(lat["z"], lat["z_kps"])
    sync()
    # PartAE.kps2skl on the card's encoded keypoints against
    # ops.skeleton.kps2skl, every mode
    from semantichuman_torch.ops.skeleton import kps2skl
    kps = lat["kps_full"]
    out["kps2skl"] = {}
    for mode in ("ori_m", "kps_ori_m", "vec_m", "vec", "m"):
        got, want = model.kps2skl(kps, mode), kps2skl(kps, mode)
        out["kps2skl"][mode] = list(got.shape)
        require(got.device == kps.device and torch.equal(got, want)
                and bool(torch.isfinite(got).all()),
                f"(a) PartAE.kps2skl({mode!r}) differs from "
                "ops.skeleton.kps2skl on the card")
    log(f"[deploy] (a) PartAE.kps2skl on the card's keypoints equal to "
        f"ops.skeleton.kps2skl: {out['kps2skl']}")
    with no_plain_on_card() as plain_calls:
        reset_counts()
        res = run_demo(editor, verts, str(tmp / "p10_edits"))
        sync()
        out["counts"] = read_counts()
        reset_counts()
        lat = editor.encode(verts)
        sync()
        enc = read_counts()
        reset_counts()
        editor.decode(lat["z"], lat["z_kps"])
        sync()
        dec = read_counts()
    log(f"[deploy] (a) run_demo at B=4: launches {out['counts']}; per "
        f"encode {enc}, per decode {dec}; plain versions on the card "
        f"{plain_calls}")
    require(out["counts"] == demo_launches(),
            f"(a) run_demo launches {out['counts']}, want {demo_launches()}")
    require(enc == expect(ENCODE_LAUNCHES) and dec == expect(DECODE_LAUNCHES),
            f"(a) launches per encode {enc} / decode {dec}")
    require(not any(plain_calls.values()),
            f"(a) plain versions ran on the card: {plain_calls}")
    require(sorted(os.listdir(tmp / "p10_edits")) == sorted(
        f"sample0_{k}.obj" for k in res), "(a) run_demo's five OBJs")

    # the plain versions: the same edits on the CPU, the same parameters
    cpu = Editor(build_model(ModelConfig(), hier, assets.part_dict,
                             device="cpu"), params, assets, device="cpu")
    ref = run_demo(cpu, verts, str(tmp / "p10_edits_cpu"))
    out["max_abs_err"] = {k: float(np.abs(res[k] - ref[k]).max())
                          for k in res}
    log(f"[deploy] (a) the card's edits against the plain versions on the "
        f"CPU: max abs err {out['max_abs_err']}")
    require(max(out["max_abs_err"].values()) <= 1e-4,
            f"(a) edits differ from the plain versions: {out['max_abs_err']}")
    del cpu
    rec = editor.reconstruct(verts)
    require(np.array_equal(editor.edit_girth(verts, PART_LIST, 1.0), rec),
            "(a) the identity girth edit is not reconstruct bit for bit")

    arm = [14, 15, 16, 17]
    edits = {
        "reconstruct": lambda v: editor.reconstruct(v),
        "orientation": lambda v: editor.edit_orientation(
            v, np.roll(v, 1, axis=0), arm),
        "bone_length": lambda v: editor.edit_bone_length(v, arm, 1.2),
        "girth": lambda v: editor.edit_girth(
            v, ["chest", "abdomen", "hip"], 1.2),
        "style": lambda v: editor.style_transfer(v, np.roll(v, 1, axis=0)),
    }
    out["ms"] = {f"B={b}": {name: host_ms(lambda: fn(meshes[:b]))
                            for name, fn in edits.items()}
                 for b in EDIT_BATCHES}
    log(f"[deploy] (a) host ms per edit (numpy in, numpy out): {out['ms']}")
    return out


def deploy_export(model, params, assets, meshes, tmp: Path) -> tuple:
    """Phase 10 (b) and (c): the exported bundle on the card, and its
    captured forward against the eager program.  Returns (record,
    export_serve counts, graph_serve counts)."""
    from semantichuman_torch import serving as SV
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.serving import ServingBundle, export_inference

    out = {}
    bdir = tmp / "p10_bundle"
    sync()
    t0 = time.perf_counter()
    manifest = export_inference(model, params, assets.j_regressor, str(bdir))
    out["export_s"] = time.perf_counter() - t0
    require(manifest["symbolic_batch"] and manifest["batch_size"] is None,
            "(b) the export did not come out symbolic")
    require(all(m["platforms"] == [f"cuda:{torch.cuda.current_device()}"]
                for m in manifest["artifacts"].values()),
            f"(b) platforms {manifest['artifacts']}")
    out["pt2_mib"] = {name: os.path.getsize(bdir / m["file"]) / 2 ** 20
                      for name, m in manifest["artifacts"].items()}
    t0 = time.perf_counter()
    bundle = ServingBundle(str(bdir), device=DEVICE)
    sync()
    out["load_s"] = time.perf_counter() - t0
    log(f"[deploy] (b) export {out['export_s']:.2f} s, load "
        f"{out['load_s']:.2f} s (host); .pt2 MiB {out['pt2_mib']}")

    v = np.concatenate([meshes, np.zeros((len(meshes), 1, 3), np.float32)],
                       axis=1)
    batches = {b: torch.from_numpy(v[:b]).cuda() for b in SERVE_BATCHES}
    others = {b: torch.from_numpy(np.roll(v, 7, axis=0)[:b]).cuda()
              for b in SERVE_BATCHES}
    for b in SERVE_BATCHES:                          # warm-up, not counted
        bundle.call("forward", batches[b], graph=False)
    sync()
    reset_counts()
    eager = {b: bundle.call("forward", batches[b], graph=False)
             for b in SERVE_BATCHES}
    z, z_kps, _dummy = bundle.call("encode", batches[16], graph=False)
    dec = bundle.call("decode", z, z_kps, graph=False)
    sync()
    export_counts = read_counts()
    want = expect(SERVE_LAUNCHES["take"], len(SERVE_BATCHES) + 1)
    log(f"[deploy] (b) eager programs: launches {export_counts}")
    require(export_counts == want,
            f"(b) launches {export_counts}, want {want}")
    torch.testing.assert_close(dec, eager[16][0][:, :-1], rtol=0, atol=1e-6)
    jreg = torch.as_tensor(assets.j_regressor, dtype=torch.float32,
                           device=DEVICE)
    keep = torch.as_tensor(KPS_KEEP, device=DEVICE)
    out["max_abs_err"] = {}
    for b, x in batches.items():
        kps = torch.einsum("jv,bvc->bjc", jreg, x[:, :-1]).index_select(
            1, keep)
        with torch.inference_mode():
            live = model(params, x, kps)
        err = max(float((g - r).abs().max()) for g, r in zip(eager[b], live))
        out["max_abs_err"][f"B={b}"] = err
        require(err <= 1e-5, f"(b) B={b}: the program is {err:.3e} from "
                "the live model")
    log(f"[deploy] (b) programs against the live model: max abs err "
        f"{out['max_abs_err']}")

    # --- (c) the captured forward -----------------------------------------
    reset_counts()
    for b in SERVE_BATCHES:
        before = read_counts()
        first = bundle.call("forward", batches[b], graph=True)
        sync()
        caps = counts_diff(read_counts(), before)
        require(caps == expect(SERVE_LAUNCHES["take"], GRAPH_WARMUPS + 1),
                f"(c) B={b}: the capture counted {caps}")
        kept = [t.clone() for t in first]
        require(all(torch.equal(g, e) for g, e in zip(first, eager[b])),
                f"(c) B={b}: the replay differs from the eager program")
        before = read_counts()
        second = bundle.call("forward", others[b], graph=True)
        sync()
        require(counts_diff(read_counts(), before) == expect({}),
                f"(c) B={b}: a replay counted launches")
        ref = bundle.call("forward", others[b], graph=False)
        require(all(torch.equal(g, e) for g, e in zip(second, ref)),
                f"(c) B={b}: the second replay differs from the eager "
                "program")
        require(all(torch.equal(f, k) for f, k in zip(first, kept))
                and not torch.equal(first[0], second[0]),
                f"(c) B={b}: the second call changed the first's result")
    graph_counts = read_counts()
    for name, args in (("encode", (batches[16],)), ("decode", (z, z_kps))):
        e = bundle.call(name, *args, graph=False)
        g = bundle.call(name, *args, graph=True)
        g = (g,) if torch.is_tensor(g) else g
        e = (e,) if torch.is_tensor(e) else e
        require(all(torch.equal(a, c) for a, c in zip(g, e)),
                f"(c) {name} B=16: the replay differs from the eager "
                "program")
    log(f"[deploy] (c) captures (2 warm-ups and the capture per batch): "
        f"launches {graph_counts}; replays bit-equal to the eager program, "
        "each call's outputs its own")

    runs, prof = {}, {}
    arms = {"eager": lambda x: bundle.call("forward", x, graph=False),
            "graph": lambda x: bundle.call("forward", x, graph=True)}
    for b in SERVE_BATCHES:
        runs[b] = {"eager": [], "graph": []}
        for arm in ("eager", "graph", "graph", "eager"):
            runs[b][arm].append(host_ms(lambda: arms[arm](batches[b]),
                                        reps=20, warmup=3))
        prof[b] = {arm: profile_forward(arms[arm], batches[b],
                                        float(np.mean(runs[b][arm])))
                   for arm in arms}
        # the replays as the profiler reads them: five replays launch 45
        # convs and 50 row gathers (the bit-equality above shows that they
        # run); in full runs the profiler dropped 2-3 of a B = 1 window's
        # 95 kernel events, so this is a reading and no gate
        calls = prof[b]["graph"]["calls"]
        prof[b]["graph"]["replay_kernels_seen"] = {
            "spiral_conv_fwd": sum(n for k, n in calls.items()
                                   if PROFILE_GROUPS["conv_fwd"] in k),
            "row_gather": sum(n for k, n in calls.items()
                              if PROFILE_GROUPS["row_gather"] in k
                              or PROFILE_GROUPS["row_gather_sum"] in k)}
        log(f"[deploy] (c) B={b}: eager program "
            f"{runs[b]['eager']} ms, graph {runs[b]['graph']} ms; idle "
            f"eager {prof[b]['eager']['idle_share']}, graph "
            f"{prof[b]['graph']['idle_share']}; five profiled replays: "
            f"{prof[b]['graph']['replay_kernels_seen']} (45 and 50 ran)")
    gate = graph_gate(runs)
    log(f"[deploy] (c) the graph wins through B={gate} (serving."
        f"_GRAPH_MAX_B = {SV._GRAPH_MAX_B})")
    out.update(graph_ms=runs, graph_gate=gate,
               graph_max_b=SV._GRAPH_MAX_B,
               profile={f"B={b}": {arm: {k: p.get(k) for k in (
                   "busy_ms", "idle_share", "replay_kernels_seen")}
                   for arm, p in pr.items()} for b, pr in prof.items()})
    return out, export_counts, graph_counts


def deploy_clis(tmp: Path, ckpt: str) -> tuple:
    """Phase 10 (d): cli.export from the native checkpoint `ckpt` against
    the Trainer's eval step, cli.eval_reference on it in the reference
    layout against the resumed Trainer's evaluate and the CPU, cli.demo
    --checkpoint_torch.  Returns (record, eval_reference counts)."""
    import yaml

    from semantichuman_torch.cli import demo as demo_cli
    from semantichuman_torch.cli import eval_reference as eval_cli
    from semantichuman_torch.cli import export as export_cli
    from semantichuman_torch.serving import ServingBundle
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.checkpoint import restore_checkpoint

    out = {}
    cfg = trainer_cfg(epoch_scan=True)
    cfg_path = tmp / "p10_config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))

    # --- cli.export against the Trainer's eval-step reconstruction --------
    bdir = tmp / "p10_cli_bundle"
    t0 = time.perf_counter()
    manifest, _ = run_cli(export_cli.main, [
        "--config", str(cfg_path), "--workdir", trainer_workdir(
            tmp, "p10_export"), "--resume", ckpt, "--out", str(bdir),
        "--device", DEVICE])
    out["export_cli_s"] = time.perf_counter() - t0
    require(manifest["symbolic_batch"], "(d) cli.export: not symbolic")
    tr = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume=ckpt, finetune=True)),
        trainer_workdir(tmp, "p10_resumed"), device=DEVICE)
    batch = next(iter(tr.test_loader))
    with torch.no_grad():
        ref = tr._get_eval_step()(tr.params, tr._step_view(batch))["rec"]
    got = ServingBundle(str(bdir), device=DEVICE).forward(batch["verts"])[0]
    out["export_cli_max_abs_err"] = float((got - ref).abs().max())
    log(f"[deploy] (d) cli.export in {out['export_cli_s']:.2f} s: its "
        f"forward against the Trainer's eval step at B="
        f"{batch['verts'].shape[0]}: max abs err "
        f"{out['export_cli_max_abs_err']:.3e}")
    require(out["export_cli_max_abs_err"] <= 1e-5,
            "(d) the exported forward differs from the eval step")

    # --- cli.eval_reference on the checkpoint in the reference layout ------
    state, step = restore_checkpoint(ckpt, device=DEVICE)
    pth = tmp / f"p10_partae_checkpoint{step}.pth.tar"
    write_reference_checkpoint(str(pth), state, tr.model, cfg.train)
    del state, tr
    argv = ["--config", str(cfg_path), "--checkpoint", str(pth)]
    _rc, line = run_cli(eval_cli.main, argv + [
        "--workdir", trainer_workdir(tmp, "p10_eval_cpu"), "--device",
        "cpu"])
    on_cpu = json.loads(line)
    sync()
    reset_counts()
    rc, line = run_cli(eval_cli.main, argv + [
        "--workdir", trainer_workdir(tmp, "p10_eval"), "--device", DEVICE,
        "--torch_l1", str(on_cpu["l1"]), "--torch_mm", str(on_cpu["mm"]),
        "--max_delta_pct", "0.5"])
    sync()
    eval_counts = read_counts()
    on_card = json.loads(line)
    resumed = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume_torch=str(pth), finetune=True)),
        trainer_workdir(tmp, "p10_resume_torch"), device=DEVICE)
    *_rest, l1, mm = resumed.evaluate()
    out["eval_reference"] = {"card": on_card, "cpu": on_cpu,
                             "trainer_l1": l1, "trainer_mm": mm}
    log(f"[deploy] (d) cli.eval_reference: card {on_card}, cpu {on_cpu}; "
        f"Trainer.evaluate after resume_torch l1 {l1!r} mm {mm!r}; "
        f"launches {eval_counts}")
    require(rc == 0, f"(d) cli.eval_reference exit {rc}: the card is "
            f"{on_card.get('mm_delta_pct')} % from the CPU")
    require(abs(on_card["mm"] - mm) <= 1e-6 * abs(mm),
            f"(d) cli.eval_reference mm {on_card['mm']} against the "
            f"resumed Trainer's {mm}")
    want = expect(VAL_LAUNCHES, len(resumed.test_loader))
    want["row_gather"] += STAGE_GATHERS
    require(eval_counts == want,
            f"(d) cli.eval_reference launches {eval_counts}, want {want}")
    del resumed

    # --- cli.demo off the same reference checkpoint ------------------------
    wd = trainer_workdir(tmp, "p10_demo")
    run_cli(demo_cli.main, ["--config", str(cfg_path), "--workdir", wd,
                            "--checkpoint_torch", str(pth), "--device",
                            DEVICE])
    edits = sorted(os.listdir(Path(wd) / "edits"))
    require(edits == sorted(f"sample0_{k}.obj" for k in (
        "rec", "ori", "bonelen", "girth", "style")),
        f"(d) cli.demo wrote {edits}")
    pth.unlink()
    return out, eval_counts


def phase_deploy(card: str, tmp: Path, ckpt: str | None) -> dict:
    """Phase 10, in the directory tmp: editing and deployment on the card
    at full width (the default ModelConfig on the bundled topology), with
    the parameters of the native checkpoint `ckpt` (phase 7's; None: the
    Editor and the export take PartAE.init(0), and a 2-epoch fit writes
    the checkpoint the CLIs start from)."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    assets, human = BodyAssets.synthetic()
    hier = MeshHierarchy.load(str(TOPOLOGY))
    model = build_model(ModelConfig(), hier, assets.part_dict, device=DEVICE)
    if ckpt is None:
        params = model.init(0)
        fit = Trainer(trainer_cfg(epoch_scan=True),
                      trainer_workdir(tmp, "p10_fit"), device=DEVICE)
        fit.fit(2)
        ckpt = os.path.join(fit.workdir, "checkpoints")
        del fit
        out = {"params": "PartAE.init(0)"}
    else:
        params = restore_checkpoint(ckpt, device=DEVICE)[0]["params"]
        out = {"params": ckpt}
    meshes = human.sample_meshes(max(SERVE_BATCHES), seed=5).astype(
        np.float32)
    out["edit"] = deploy_editor(model, params, assets, meshes, hier, tmp)
    out["export"], export_counts, graph_counts = deploy_export(
        model, params, assets, meshes, tmp)
    out["clis"], eval_counts = deploy_clis(tmp, ckpt)
    out["counts"] = {"edit": out["edit"].pop("counts"),
                     "export_serve": export_counts,
                     "graph_serve": graph_counts,
                     "eval_reference": eval_counts}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[deploy] phase 10 ({card}): {out['phase_s']:.1f} s")
    return out


# --- phase 11: data parallelism, the trace window, geometry, serving A/B -----

DP_WORLD = 2
DP_STEPS = 3                # steps an epoch of phase 11's run
# seconds every rank of a launch may take together; a hung rank fails the
# phase there and is killed
DP_TIMEOUT = 300
# tests/test_parallel.py's tolerances for the JAX package's own mesh
DP_LOSS_RTOL = 2e-4
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-4, 1e-6
DP_VAL_RTOL = 1e-4
# the first step's gradient (both runs from the same parameters) within
# this share of each tensor's largest entry (the CPU test's per-term
# gradient tolerance).  The parameters after Adam, and the later steps'
# gradients that follow from them, are reported beside the tolerances
# above and not held to them: Adam divides each gradient entry by its own
# size, and where the coupled L2 gradient (data + DP_DECAY * p) crosses
# zero it turns the last bits that a split batch sums otherwise into
# ~2e-5 on a few weights (on the card 6 of 65 536 of dconv/0/w, whose
# first coupled gradient is ~1e-9, a tenth of Adam's eps; none on the CPU)
DP_GRAD_TOL = 1e-5
DP_DECAY = 5e-5             # Config().train.weight_decay
# global steps [start, stop) the trace window records
TRACE_WINDOW = (2, 5)
# kernel families the window's trace must name: row 1 (forward and dW),
# row 3 (part_dist fwd_grad), row 7, row 8 (PROFILE_GROUPS)
TRACE_FAMILIES = ("conv_fwd", "conv_bwd_dw", "part_dist", "row_gather",
                  "csr_reduce")
# families of a plain version: none may run in the window
TRACE_ABSENT = ("index_add",)
# the CPU tests' tolerances (tests/test_torch_geometry.py): operators
# within GEO_OP_TOL of the output's largest entry; on icosphere(3) the
# geodesic field and the biharmonic distances within GEO_FIELD_TOL of
# their largest value.  On the full template (an elongated mesh, its poles
# 64-valent) the geodesic field is held as tests/test_geometry.py holds
# the elongated mesh's (finite, bounded) and its card-to-CPU difference is
# reported: 200 CG iterations that do not converge amplify the last bits
# in which the card's CSR reduce sums a row longer than LONG_ROW (a chunk
# tree) and the plain version (in order) differ
GEO_OP_TOL = 1e-5
GEO_FIELD_TOL = 1e-3
GEO_EIG_RTOL = 1e-4
# the unit sphere's eigenspaces l = 0, 1, 2 (multiplicity 2l + 1)
GEO_CLUSTERS = ((0, 1), (1, 4), (4, 9))


def dp_raw(epochs: int) -> dict:
    """Phase 11's data-parallel run: the full-width default model,
    Config() otherwise, global batches of 8 (the paper recipe's 4 on each
    of two ranks), 24 train and 16 test synthetic meshes (3 steps an
    epoch), the loop, every step logged, a checkpoint every epoch."""
    return {"data": {"synthetic": True, "synthetic_train": 24,
                     "synthetic_test": 16},
            "train": {"batch_train": 8, "batch_interp": 8, "batch_test": 8,
                      "n_epochs": epochs, "epoch_scan": False,
                      "log_every": 1, "ck_frequency": 1,
                      "save_recons": False}}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_argvs(tmp: Path, name: str, cfg: str, world: int, backend: str,
             *extra) -> list:
    """One `tools/dp_fit.py` process per rank: cli.train --distributed on
    the card with `backend`, its results into tmp/<name>_out with the
    gradients of its first DP_STEPS steps."""
    port = free_port()
    return [[sys.executable, "-m", "semantichuman_torch.tools.dp_fit",
             "--out", str(tmp / f"{name}_out"), "--save_grads",
             str(DP_STEPS), "--", "--config", cfg,
             "--workdir", str(tmp / name), "--device", "cuda",
             "--distributed", "--coordinator", f"tcp://localhost:{port}",
             "--num_processes", str(world), "--process_id", str(r),
             "--backend", backend, *extra] for r in range(world)]


@contextlib.contextmanager
def dp_launch(jobs: dict):
    """Start every job's rank processes at once (name -> argvs); yields
    wait(), which waits for them all within DP_TIMEOUT seconds and returns
    {name: [(rank json, rank npz arrays), ...]}.  A rank that exits
    non-zero or hangs fails the phase; every process is stopped on the
    way out."""
    procs = {name: [subprocess.Popen(a, cwd=str(ROOT),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                    for a in argvs] for name, argvs in jobs.items()}
    t0 = time.perf_counter()

    def wait() -> dict:
        for name, ps in procs.items():
            for r, p in enumerate(ps):
                left = DP_TIMEOUT - (time.perf_counter() - t0)
                try:
                    out, _ = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    raise SmokeFailure(f"[parallel] {name}: rank {r} still "
                                       f"running after {DP_TIMEOUT} s")
                require(p.returncode == 0, f"[parallel] {name}: rank {r} "
                        f"exited {p.returncode}:\n{out[-4000:]}")
        res = {}
        for name, argvs in jobs.items():
            d = Path(argvs[0][argvs[0].index("--out") + 1])
            res[name] = [(json.loads((d / f"rank{r}.json").read_text()),
                          dict(np.load(d / f"rank{r}.npz")))
                         for r in range(len(argvs))]
        log(f"[parallel] {', '.join(jobs)}: {time.perf_counter() - t0:.1f} "
            "s with start-up")
        return res

    try:
        yield wait
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def step_metrics(workdir) -> dict:
    """{global step: {metric: value}} from a run's metrics.jsonl (every
    step logged, log_every 1)."""
    out = {}
    with open(Path(workdir, "summaries", "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if "loss" in r:
                out[r["step"]] = {k: v for k, v in r.items()
                                  if k not in ("step", "time")}
    return out


def param_arrays(params) -> dict:
    """{"param:<key path>": numpy} as tools/dp_fit.py writes them."""
    from semantichuman_torch.utils.params import tree_leaves, tree_paths
    return {"param:" + "/".join(map(str, p)): t.detach().cpu().numpy()
            for p, t in zip(tree_paths(params), tree_leaves(params))}


def dp_compare(name: str, ranks: list, workdir, ref: dict, steps,
               exact: bool = False, same_start: bool = True) -> dict:
    """The ranks' run (its rank-0 log in `workdir`, its npz with the
    gradients of its first steps, `tools/dp_fit.py --save_grads`) against
    the one-process run `ref` (its step metrics, its gradient of each
    step, its parameters after the steps and the val loss after them):
    the losses of `steps` within rtol DP_LOSS_RTOL, the first step's
    gradient (where same_start: both runs start from the same parameters)
    within DP_GRAD_TOL of each tensor's largest entry, the val loss within
    rtol DP_VAL_RTOL (exact: every step's gradient, the losses, the val
    loss and the parameters bit for bit); every rank's gradients and
    parameters equal rank 0's bit for bit.  Otherwise the gradients and
    the parameters are reported: the parameters beyond rtol 1e-4, atol
    1e-6 with, at the largest difference, the one-process run's gradient
    of each step and the weight decay's term of the coupled L2 gradient.
    -> results, with the checks that failed under "failures"."""
    j0, a0 = ranks[0]
    mine = step_metrics(workdir)
    got = [mine[s]["loss"] for s in steps]
    want = [ref["metrics"][s]["loss"] for s in steps]
    worst = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
    fails = [f"{name}: step {s} logged {sorted(mine[s])}, the one-process "
             f"run {sorted(ref['metrics'][s])}" for s in steps
             if sorted(mine[s]) != sorted(ref["metrics"][s])]
    metric_rel = {}
    for s in steps:
        for k, w in ref["metrics"][s].items():
            if k in mine[s]:
                metric_rel[k] = max(metric_rel.get(k, 0.0),
                                    abs(mine[s][k] - w) / max(abs(w), 1e-30))
    grad_rel = {}       # step -> tensor -> share of its largest entry
    for i, s in enumerate(steps, start=1):
        grad_rel[s] = {}
        for path, w in ref["grads"][s].items():
            d = float(np.abs(a0[f"grad{i}:{path}"] - w).max())
            grad_rel[s][path] = d / max(float(np.abs(w).max()), 1e-30)
    held = steps if exact else steps[:1] if same_start else ()
    bad_grads = {(s, k): v for s in held for k, v in grad_rel[s].items()
                 if (v > 0 if exact else v > DP_GRAD_TOL)}
    if bad_grads:
        fails.append(f"{name}: gradients beyond "
                     f"{'equality' if exact else DP_GRAD_TOL} of their "
                     f"largest entry: {bad_grads}")
    if exact:
        if got != want:
            fails.append(f"{name}: losses {got} != {want}")
        if j0["val"] != ref["val"][steps[-1]]:
            fails.append(f"{name}: val {j0['val']} != "
                         f"{ref['val'][steps[-1]]}")
    else:
        if worst > DP_LOSS_RTOL:
            fails.append(f"{name}: step losses {got} vs {want} (rel "
                         f"{worst:.3g})")
        if abs(j0["val"] - ref["val"][steps[-1]]) > (
                DP_VAL_RTOL * abs(ref["val"][steps[-1]])):
            fails.append(f"{name}: val {j0['val']} vs "
                         f"{ref['val'][steps[-1]]}")
    beyond = {}
    for path, v in ref["params"][steps[-1]].items():
        d = np.abs(a0["param:" + path] - v)
        off = d > 0 if exact else d > DP_PARAM_ATOL + DP_PARAM_RTOL * np.abs(v)
        if off.any():
            at = np.unravel_index(int(d.argmax()), d.shape)
            start = ref["params"][steps[0] - 1][path][at]
            beyond[path] = {
                "n": int(off.sum()), "of": int(off.size),
                "max_abs": float(d.max()), "ref": float(v[at]),
                "ref_grads": [float(ref["grads"][s][path][at])
                              for s in steps],
                "decay_term": float(DP_DECAY * start)}
    if beyond and exact:
        fails.append(f"{name}: parameters differ: {beyond}")
    for j, a in ranks[1:]:
        bad = [k for k in a0 if k != "preds"
               and not np.array_equal(a0[k], a[k])]
        if bad:
            fails.append(f"{name}: rank {j['rank']}'s gradients or "
                         f"parameters differ from rank 0's: {bad[:3]}")
        if j["start_epoch"] != j0["start_epoch"]:
            fails.append(f"{name}: the ranks' start epochs differ")
    grad_max = {s: max(g.values()) for s, g in grad_rel.items()}
    log(f"[parallel] {name}: losses {got} vs {want}; metrics' max rel "
        f"{ {k: float(f'{v:.3g}') for k, v in metric_rel.items()} }; "
        f"each step's gradient, its largest difference over the largest "
        f"entry of its tensor "
        f"{ {s: float(f'{v:.3g}') for s, v in grad_max.items()} }; "
        f"parameter tensors beyond rtol {DP_PARAM_RTOL}, atol "
        f"{DP_PARAM_ATOL}: {beyond or 'none'}")
    return {"losses": got, "ref_losses": want, "loss_max_rel": worst,
            "metric_max_rel": metric_rel, "grad_max_rel": grad_max,
            "grad_rel": grad_rel,
            "params_beyond": beyond, "val": j0["val"],
            "ref_val": ref["val"][steps[-1]],
            "start_epoch": j0["start_epoch"], "world": j0["world"],
            "devices": [j["device"] for j, _a in ranks], "failures": fails}


def rank_counts(ranks: list) -> dict:
    """The launches of a run's ranks, summed (each counted from its
    process's start)."""
    return {k: sum(j["launches"][k] for j, _a in ranks)
            for k in KERNEL_COUNTS}


def dp_reference(tmp: Path) -> dict:
    """Phase 11's run without a process group, two epochs in this process:
    its step metrics, each step's gradient as the optimizer receives it
    (`tools/dp_fit.py:recording_grads`), its parameters before the first
    step and after each epoch (by key path) and its val loss after each
    epoch, and its checkpoint directory."""
    from semantichuman_torch.config import Config
    from semantichuman_torch.tools.dp_fit import recording_grads
    from semantichuman_torch.train.loop import Trainer

    wd = trainer_workdir(tmp, "dp_ref")
    t0 = time.perf_counter()
    tr = Trainer(Config.from_dict(dp_raw(2)), wd, device=DEVICE)
    require(not tr.data_parallel, "the one-process run is data-parallel")
    steps = tr.steps_per_epoch
    params = {0: param_arrays(tr.params)}
    with recording_grads(2 * steps) as grads:
        for epoch in (1, 2):
            tr.fit(epoch)
            tr.start_epoch = epoch + 1
            params[epoch * steps] = param_arrays(tr.params)
    sync()
    paths = [k[len("param:"):] for k in params[0]]
    params = {s: {k[len("param:"):]: v for k, v in p.items()}
              for s, p in params.items()}
    return {"fit_s": time.perf_counter() - t0,
            "ckdir": os.path.join(wd, "checkpoints"),
            "metrics": step_metrics(wd), "params": params,
            "grads": {s: dict(zip(paths, g))
                      for s, g in enumerate(grads, start=1)},
            "val": {h["epoch"] * steps: h["val"] for h in tr.history}}


def phase_dp(tmp: Path) -> tuple:
    """(a) two ranks under gloo on cuda:0 and (b) one rank under NCCL,
    each through cli.train --distributed (`tools/dp_fit.py`), against the
    same run in this process without a process group; then (a)'s
    checkpoint resumed by two ranks for epoch 2.  (a) is held by its
    losses, its first step's gradient and the val loss; its parameters
    after Adam are reported (DP_GRAD_TOL says why).  -> (results,
    {path: launches}, the one-process run's checkpoint directory)."""
    import yaml
    cfg1, cfg2 = tmp / "dp1.yaml", tmp / "dp2.yaml"
    cfg1.write_text(yaml.safe_dump(dp_raw(1)))
    cfg2.write_text(yaml.safe_dump(dp_raw(2)))
    out = {}
    jobs = {"dp_gloo": dp_argvs(tmp, "dp_gloo", str(cfg1), DP_WORLD,
                                "gloo"),
            "dp_nccl1": dp_argvs(tmp, "dp_nccl1", str(cfg1), 1, "nccl")}
    with dp_launch(jobs) as wait:
        ref = dp_reference(tmp)         # while the ranks run
        res = wait()
    out["ref_fit_s"] = ref["fit_s"]
    out["gloo"] = dp_compare("(a) gloo", res["dp_gloo"], tmp / "dp_gloo",
                             ref, (1, 2, 3))
    out["nccl1"] = dp_compare("(b) nccl, world 1", res["dp_nccl1"],
                              tmp / "dp_nccl1", ref, (1, 2, 3), exact=True)
    gl = tmp / "dp_gloo"
    require(sorted(os.listdir(gl / "checkpoints"))
            == ["1", "train_params.txt"],
            f"(a) checkpoints: {os.listdir(gl / 'checkpoints')}")
    dumps = (gl / "checkpoints" / "train_params.txt").read_text()
    require(dumps.count('"git_sha"') == 1,
            "(a) the configuration was dumped by more than one rank")
    # both ranks resume (a)'s checkpoint and train epoch 2
    jobs = {"dp_resume": dp_argvs(tmp, "dp_resume", str(cfg2), DP_WORLD,
                                  "gloo", "--resume",
                                  str(gl / "checkpoints"))}
    with dp_launch(jobs) as wait:
        res.update(wait())
    # from (a)'s epoch-1 parameters, which are not the one-process run's
    out["resume"] = dp_compare("(a) resumed", res["dp_resume"],
                               tmp / "dp_resume", ref, (4, 5, 6),
                               same_start=False)
    require(out["resume"]["start_epoch"] == 2,
            f"(a) resumed at epoch {out['resume']['start_epoch']}")
    out["failures"] = [f for k in ("gloo", "nccl1", "resume")
                       for f in out[k].pop("failures")]
    counts = {"dp_gloo": rank_counts(res["dp_gloo"] + res["dp_resume"]),
              "dp_nccl1": rank_counts(res["dp_nccl1"])}
    for path, c in counts.items():
        for k in ("spiral_conv_fwd", "spiral_conv_bwd_dw", "row_gather",
                  "csr_reduce", "part_dist_fwd_grad"):
            require(c[k] > 0, f"[parallel] {path}: no {k} launch")
    ranks = res["dp_gloo"]
    require(ranks[0][0]["launches"] == ranks[1][0]["launches"],
            "(a) the two ranks launched different kernels: "
            f"{ranks[0][0]['launches']} vs {ranks[1][0]['launches']}")
    return out, counts, ref["ckdir"]


def trace_families(path: str) -> dict:
    """{family: kernel events} of a Chrome trace, by PROFILE_GROUPS."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {label: sum(key in n for n in names)
            for label, key in PROFILE_GROUPS.items()}


def phase_trace(tmp: Path) -> tuple:
    """(c) the B = 4 loop (the paper recipe, one epoch of 16 steps) with a
    trace window over TRACE_WINDOW and without: the trace names the
    kernels of rows 1, 3, 7 and 8 and no plain version, the
    logged losses are bit-equal, and the window's cost in ms a step.
    -> (results, launches of the traced fit)."""
    from semantichuman_torch.train.loop import Trainer

    lo, hi = TRACE_WINDOW
    runs = {}
    for name, over in (("plain", {}), ("window", {"profile_start": lo,
                                                  "profile_stop": hi})):
        wd = trainer_workdir(tmp, f"trace_{name}")
        tr = Trainer(trainer_cfg(n_epochs=1, log_every=1, **over), wd,
                     device=DEVICE)
        times = timed_steps(tr)
        sync()
        reset_counts()
        tr.fit()
        sync()
        runs[name] = (tr, wd, times, read_counts())
    (tr, wd, times, counts) = runs["window"]
    plain_times = runs["plain"][2]
    fam = trace_families(tr.trace_window.path)
    for label in TRACE_FAMILIES:
        require(fam[label] > 0, f"(c) no {label} kernel in the trace")
    for label in TRACE_ABSENT:
        require(fam[label] == 0, f"(c) {label} in the trace: {fam[label]}")
    with open(Path(runs["plain"][1], "summaries", "metrics.jsonl")) as f:
        plain = [{k: v for k, v in json.loads(x).items() if k != "time"}
                 for x in f]
    with open(Path(wd, "summaries", "metrics.jsonl")) as f:
        traced = [{k: v for k, v in json.loads(x).items() if k != "time"}
                  for x in f]
    require(plain == traced, "(c) the traced fit's losses differ from the "
            "fit without a window")
    # times[j] is the loop iteration that ends with step j + 1: times[lo-1]
    # holds the profiler's start and step lo, times[lo:hi-1] the steps
    # inside the window, times[hi-1] its stop, the export and step hi
    require(len(times) >= hi and len(plain_times) >= hi,
            f"(c) the fit ran {len(times) + 1} steps, the window ends at {hi}")
    d = np.asarray(times[:hi]) - np.asarray(plain_times[:hi])
    cost = {"start_ms": float(d[lo - 1]),
            "per_step_ms": float(d[lo:hi - 1].mean()),
            "stop_export_ms": float(d[hi - 1])}
    out = {"trace": os.path.relpath(tr.trace_window.path, tmp),
           "trace_bytes": os.path.getsize(tr.trace_window.path),
           "families": fam, "window_ms": times[lo - 1:hi],
           "plain_ms": plain_times[lo - 1:hi], **cost}
    log(f"[trace] (c) window over steps [{lo}, {hi}): kernel events by "
        f"family {fam}; losses bit-equal to the untraced fit; the window "
        f"costs {cost['per_step_ms']:.3f} ms a step, its start "
        f"{cost['start_ms']:.1f} ms, its stop and export "
        f"{cost['stop_export_ms']:.1f} ms "
        f"({np.round(times[lo - 1:hi], 3).tolist()} against "
        f"{np.round(plain_times[lo - 1:hi], 3).tolist()} ms); trace "
        f"{out['trace_bytes'] / 2**20:.1f} MiB")
    return out, counts


def geometry_case(name: str, verts: np.ndarray, faces: np.ndarray,
                  spectral: bool) -> tuple:
    """(d) one mesh: every operator of ops/geometry.py (the spectral ones
    where `spectral`) and distance.py's vertex normals and volumes on the
    card against the CPU within the CPU tests' tolerances; card and CPU
    times.  -> (results, launches of the checks)."""
    from semantichuman_torch.ops import distance as D
    from semantichuman_torch.ops import geometry as G

    n = len(verts)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((n, 5)).astype(np.float32)
    src_np = np.zeros(n, np.float32)
    src_np[0] = 1.0

    def ops(dev):
        mt = G.MeshTables.build(faces, n, dev)
        v = torch.as_tensor(verts, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x_np, device=dev)
        res = {"areas": G.face_areas_normals(v, mt)[0],
               "normals": G.face_areas_normals(v, mt)[1],
               "cotan": G.cotan_weights(v, mt),
               "mass": G.lumped_mass(v, mt),
               "laplacian": G.laplacian_apply(v, mt, x),
               "laplacian_vec": G.laplacian_apply(v, mt, x[:, 0]),
               "volume": G.mesh_volume(v, mt)[None],
               "vertex_normals": D.vertex_normals(v[None], mt.corners),
               "total_volume": D.total_mesh_volume(v[None], mt.corners)}
        fields = {"geodesic": G.geodesics_in_heat(
            v, mt, torch.as_tensor(src_np, device=dev))}
        if spectral:
            res["laplacian_dense"] = G.laplacian_dense(v, mt)
            w, phi = G.spectral_basis(v, mt, 9)
            res["eigenvalues"] = w
            fields["biharmonic"] = G.biharmonic_distance(v, mt, k=36)
            fields["eigenvectors"] = phi
        return ({k: t.cpu().numpy() for k, t in res.items()},
                {k: t.cpu().numpy() for k, t in fields.items()}, mt, v, x)

    cpu, cpu_fields, mt_c, v_c, x_c = ops("cpu")
    sync()
    reset_counts()
    card, card_fields, mt_g, v_g, x_g = ops(DEVICE)
    sync()
    counts = read_counts()
    errs = {}
    for k, want in cpu.items():
        err = float(np.abs(card[k] - want).max())
        scale = max(float(np.abs(want).max()), 1e-30)
        tol = (GEO_EIG_RTOL if k == "eigenvalues" else GEO_OP_TOL) * scale
        errs[k] = err / scale
        require(err <= tol, f"(d) {name} {k}: card vs cpu {err:.3g} > "
                f"{tol:.3g}")
    for k in ("geodesic", "biharmonic"):
        if k in cpu_fields:
            want = cpu_fields[k]
            err = float(np.abs(card_fields[k] - want).max())
            errs[k] = err / float(want.max())
            if spectral:
                require(err <= GEO_FIELD_TOL * float(want.max()),
                        f"(d) {name} {k}: card vs cpu {errs[k]:.3g} of "
                        "its largest value")
    if not spectral:
        # tests/test_geometry.py's check of an elongated mesh: finite and
        # bounded by 4 bounding-box diagonals (see GEO_FIELD_TOL)
        diag = float(np.linalg.norm(np.ptp(verts, axis=0)))
        for f in (cpu_fields["geodesic"], card_fields["geodesic"]):
            require(np.isfinite(f).all() and f.max() < 4 * diag,
                    f"(d) {name} geodesic unbounded: max {f.max():.3g}, "
                    f"diagonal {diag:.3g}")
    if spectral:
        m = cpu["mass"]
        for lo, hi in GEO_CLUSTERS:
            cos = np.linalg.svd(card_fields["eigenvectors"][:, lo:hi].T
                                @ (m[:, None]
                                   * cpu_fields["eigenvectors"][:, lo:hi]),
                                compute_uv=False)
            require(np.all(np.abs(cos - 1.0) <= GEO_EIG_RTOL),
                    f"(d) {name} eigenvectors {lo}:{hi}: cosines {cos}")
    src_g = torch.as_tensor(src_np, device=DEVICE)
    src_c = torch.as_tensor(src_np)
    times = {
        "laplacian_ms": time_ms(lambda: G.laplacian_apply(v_g, mt_g, x_g)),
        "laplacian_cpu_ms": host_ms(lambda: G.laplacian_apply(v_c, mt_c,
                                                              x_c), reps=5),
        "geodesics_ms": host_ms(lambda: G.geodesics_in_heat(v_g, mt_g,
                                                            src_g), reps=2,
                                warmup=1),
        "geodesics_cpu_ms": host_ms(lambda: G.geodesics_in_heat(
            v_c, mt_c, src_c), reps=1, warmup=0)}
    log(f"[geometry] (d) {name} ({n} vertices, {len(faces)} faces): card "
        f"against cpu, the largest difference over each output's scale "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }; laplacian "
        f"{times['laplacian_ms']:.4f} ms on the card, "
        f"{times['laplacian_cpu_ms']:.3f} ms on the cpu; geodesics "
        f"{times['geodesics_ms']:.1f} / {times['geodesics_cpu_ms']:.1f} ms")
    return {"vertices": n, "faces": len(faces), "max_rel_err": errs,
            **times}, counts


def phase_geometry() -> tuple:
    """(d) on icosphere(3) (with the spectral tools) and on the full-scale
    synthetic template (the bundled topology's level 0).  -> (results,
    launches of the checks)."""
    from semantichuman_torch.data.synthetic import SyntheticHuman, icosphere

    v, f = icosphere(3)
    ico, c1 = geometry_case("icosphere(3)", v, f, spectral=True)
    sh = SyntheticHuman()
    full, c2 = geometry_case("full template", sh.template_verts,
                             sh.template_faces, spectral=False)
    require(c1["csr_reduce"] > 0 and c1["row_gather"] > 0,
            f"(d) geometry launched no row 7 / row 8 kernel: {c1}")
    return ({"icosphere3": ico, "full_template": full},
            {k: c1[k] + c2[k] for k in c1})


def phase_serving_ab(ckpt: str) -> tuple:
    """(e) tools/serving_accuracy.py on the card from the checkpoint
    `ckpt` (its train_params.txt beside it): f32 and bf16 arms, each with
    its own Trainer and inputs; a finite, nonzero delta.  -> (results,
    launches)."""
    from semantichuman_torch.tools import serving_accuracy

    sync()
    reset_counts()
    t0 = time.perf_counter()
    res = serving_accuracy.main(["--resume", ckpt, "--device", DEVICE])
    sync()
    res["tool_s"] = time.perf_counter() - t0
    counts = read_counts()
    require(np.isfinite([res[k] for k in ("f32_mm", "bf16_mm", "f32_l1",
                                          "bf16_l1")]).all(),
            f"(e) non-finite serving accuracy {res}")
    require(res["delta_mm"] != 0.0, f"(e) the bf16 delta reads 0: {res}")
    require(counts["spiral_conv_fwd"] > 0 and counts["row_gather"] > 0,
            f"(e) the eval launched no conv or gather: {counts}")
    log(f"[serving] (e) f32 {res['f32_mm']:.4f} mm, bf16 "
        f"{res['bf16_mm']:.4f} mm, delta {res['delta_mm']:.4g} mm")
    return res, counts


def phase_parallel(card: str, tmp: Path, ckpt: str | None) -> dict:
    """Phase 11 in the directory tmp: (a)-(b) data parallelism, (c) the
    trace window, (d) geometry, (e) the serving dtype A/B on phase 7's
    epoch-2 checkpoint `ckpt` (None: the one-process run of (a)'s).
    -> results with their launches under "counts"."""
    t_phase = time.perf_counter()
    out = {"card": card}
    out["dp"], counts, dp_ckpt = phase_dp(tmp)
    out["trace"], counts["trace"] = phase_trace(tmp)
    out["geometry"], counts["geometry"] = phase_geometry()
    out["serving_ab"], counts["serving_ab"] = phase_serving_ab(
        ckpt or dp_ckpt)
    out["counts"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[parallel] phase 11 ({card}): {out['phase_s']:.1f} s")
    # (a)-(b)'s comparisons fail the phase here, once (c)-(e) have run
    fails = out["dp"].pop("failures")
    require(not fails, "[parallel] " + "; ".join(fails))
    return out


# --- phase 12: data-parallel serving and the DFAUST first-contact drill -----

# (a): the batches served over two copies of the bundle (shards of 1, 8 and
# 32 meshes), each copy's launches counted around its call
DP_SERVE_BATCHES = (2, 16, 64)
DP_SERVE_COPIES = 2
# the gathered shards against the one-device bundle: phase 10 (b)'s
# program-against-live tolerance
DP_SERVE_ATOL = 1e-5
# the JAX test's elementwise rule for sharded serving
# (tests/test_serving.py::test_sharded_batch_serving_dp8): a reading at
# each (artifact, B), eager and captured, with the count of entries
# outside it; where one fails, `shard_diagnostic` names the op
JAX_SERVE_RTOL, JAX_SERVE_ATOL = 2e-6, 2e-7
# per call of each artifact, per shard: the take route
ARTIFACT_LAUNCHES = {"forward": SERVE_LAUNCHES["take"],
                     "encode": ENCODE_LAUNCHES, "decode": DECODE_LAUNCHES}
# (b): the drill's subprocesses, the two together
DRILL_TIMEOUT = 300
# the drill's eval against Trainer.evaluate after resume_torch of the same
# file, as phase 10 (d) holds cli.eval_reference
DRILL_MM_RTOL = 1e-6


@contextlib.contextmanager
def copy_probe():
    """Record each call of a bundle's per-device copy (`serving._Copy`):
    (copy, device, artifact, shard batch, graph flag, launches), counted
    around the call with a synchronize on each side."""
    from semantichuman_torch import serving as SV

    calls, call = [], SV._Copy.call

    def probe(self, name, args, graph):
        sync()
        before = read_counts()
        out = call(self, name, args, graph)
        sync()
        calls.append((id(self), str(self.device), name, args[0].shape[0],
                      graph, counts_diff(read_counts(), before)))
        return out

    SV._Copy.call = probe
    try:
        yield calls
    finally:
        SV._Copy.call = call


def gaps(got, ref) -> tuple:
    """(largest absolute, largest relative) difference over outputs."""
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    ab = max(float((g.to(r.device) - r).abs().max())
             for g, r in zip(got, ref))
    rel = max(float(((g.to(r.device) - r).abs()
                     / r.abs().clamp_min(1e-30)).max())
              for g, r in zip(got, ref))
    return ab, rel


def jax_rule(got, ref) -> list:
    """[meets the JAX test's rule, entries outside it, entries, the largest
    |got - ref| / (atol + rtol |ref|)] of the outputs `got` against `ref`:
    torch.allclose(got, ref, rtol=JAX_SERVE_RTOL, atol=JAX_SERVE_ATOL),
    output by output (the share is above 1 where an entry is outside)."""
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    # torch.allclose is isclose everywhere: met where no entry is outside
    bad = sum(int((~torch.isclose(g.to(r.device), r, rtol=JAX_SERVE_RTOL,
                                  atol=JAX_SERVE_ATOL)).sum())
              for g, r in zip(got, ref))
    share = max(float(((g.to(r.device) - r).abs()
                       / (JAX_SERVE_ATOL + JAX_SERVE_RTOL * r.abs())).max())
                for g, r in zip(got, ref))
    return [bad == 0, bad, sum(r.numel() for r in ref), share]


def serve_dp_case(bdir: Path, devices: list, refs: dict) -> tuple:
    """Phase 12 (a) on one device list: at each of DP_SERVE_BATCHES,
    forward, encode and then decode (on the one-device bundle's z) eagerly
    and then by default (captured), each output shard on its copy's
    device, the gathered outputs within DP_SERVE_ATOL of the one-device
    bundle's (`refs`), the captured call bit-equal to the eager one; per
    copy call SERVE_LAUNCHES["take"] (encode, decode: their halves)
    eagerly, GRAPH_WARMUPS + 1 times that at its first capture, 0 on a
    replay.  -> (record, launches)."""
    from semantichuman_torch.serving import Shards, ServingBundle

    bundle = ServingBundle(str(bdir), device=devices)
    n = len(devices)
    out = {"devices": [str(d) for d in bundle.devices], "gaps": {},
           "jax_rule": {}}

    def shards(res):
        return res if isinstance(res, Shards) else Shards([res])

    sync()
    reset_counts()
    with copy_probe() as calls:
        for b in DP_SERVE_BATCHES:
            x, (z, z_kps) = refs[b]["x"], refs[b]["z"]
            args = {"forward": (x,), "encode": (x,), "decode": (z, z_kps)}
            for name in ("forward", "encode", "decode"):
                eager = shards(bundle.call(name, *args[name], graph=False))
                for graph in (None, None):
                    got = shards(bundle.call(name, *args[name],
                                             graph=graph))
                    require(all(torch.equal(g, e) for s, t in zip(got, eager)
                                for g, e in zip(
                                    (s,) if torch.is_tensor(s) else s,
                                    (t,) if torch.is_tensor(t) else t)),
                            f"(a) {out['devices']} {name} B={b}: the "
                            "captured call differs from the eager one")
                for s, copy in zip(eager, bundle._copies):
                    ts = (s,) if torch.is_tensor(s) else s
                    require(all(t.device == copy.device
                                and t.shape[0] == b // n for t in ts),
                            f"(a) {name} B={b}: a shard off its copy's "
                            f"device {copy.device}")
                ab, rel = gaps(eager.gather(refs["device"]),
                               refs[b][name])
                out["gaps"][f"{name} B={b}"] = [ab, rel]
                out["jax_rule"][f"{name} B={b}"] = {
                    "eager": jax_rule(eager.gather(refs["device"]),
                                      refs[b][name]),
                    "captured": jax_rule(got.gather(refs["device"]),
                                         refs[b][name])}
                require(ab <= DP_SERVE_ATOL, f"(a) {out['devices']} {name} "
                        f"B={b}: {ab:.3e} from the one-device bundle")
    sync()
    counts = read_counts()
    seen = set()
    for copy, dev, name, b, graph, got in calls:
        per = ARTIFACT_LAUNCHES[name]
        if graph is False:
            want = expect(per)
        elif (copy, name, b) not in seen:
            want = expect(per, GRAPH_WARMUPS + 1)
        else:
            want = expect({})
        if graph is None:
            seen.add((copy, name, b))
        require(got == want, f"(a) {out['devices']} {name} at shard batch "
                f"{b} on {dev} (graph {graph}): launches {got}, want {want}")
    require(len(calls) == len(DP_SERVE_BATCHES) * 3 * 3 * n,
            f"(a) {len(calls)} copy calls")
    ab = max(g[0] for g in out["gaps"].values())
    rel = max(g[1] for g in out["gaps"].values())
    out["max_abs_err"], out["max_rel_err"] = ab, rel
    log(f"[serve-dp] (a) {out['devices']}: forward, encode, decode at "
        f"B = {DP_SERVE_BATCHES}, eager and captured, every shard on its "
        f"copy's device; gathered against the one-device bundle: largest "
        f"abs gap {ab:.3e}, rel {rel:.3e} (tolerance atol "
        f"{DP_SERVE_ATOL}); launches {counts}")
    log(f"[serve-dp] (a) {out['devices']}: the JAX test's rule "
        f"allclose(rtol={JAX_SERVE_RTOL}, atol={JAX_SERVE_ATOL}) per "
        "artifact and B, [met, entries outside, entries, largest share "
        "of the allowed error]: "
        + json.dumps(out["jax_rule"]))
    return out, counts, bundle


def rule_fails(record: dict) -> list:
    """The (artifact, B) readings of a serve_dp_case record that fail the
    JAX test's rule, eager or captured."""
    return [k for k, r in record["jax_rule"].items()
            if not (r["eager"][0] and r["captured"][0])]


def shard_diagnostic(model, params, j_regressor, x) -> dict:
    """Phase 12 (a)'s diagnostic where a shard of 1 fails the JAX rule: the
    live model's forward op by op on x [2, V+1, 3], each op run on the
    two rows and on row 0 alone from the same input (the two-row run's
    output feeds the next op), row 0 of the two outputs compared: largest
    difference, entries that differ, entries outside the JAX rule; each
    conv with its `_fwd_plan` tile at both batches.  -> {"ops": [...],
    "first": the first op whose row differs, or None}."""
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.models.common import _band_kw
    from semantichuman_torch.ops.row_gather import gather_rows
    from semantichuman_torch.ops.sampling import pool, unpool

    SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    t, ops = model.tables, []
    jreg = torch.as_tensor(np.asarray(j_regressor, np.float32),
                           device=x.device)
    keep = torch.as_tensor(KPS_KEEP, device=x.device)

    def step(name, fn, *ins, **info):
        two = fn(*ins)
        one = fn(*(a[:1].contiguous() for a in ins))
        d = (one[0] - two[0]).abs()
        rule = jax_rule(one[:1], two[:1])
        ops.append({"op": name, "max_abs": float(d.max()),
                    "differ": int((d != 0).sum()), "outside": rule[1],
                    "share": rule[3], "entries": d.numel(), **info})
        return two

    def conv(level, p, act):
        w = p["w"].to(model.compute_dtype or p["w"].dtype)
        v1, s = t.spirals[level].shape
        plan = {f"tile_b{b}": SC._fwd_plan(b, v1, w.shape[0] // s, s,
                                            w.shape[1], w.dtype)["tile"]
                for b in (1, 2)}
        return (lambda h: model.conv_fn(
            h, t.spirals[level], p["w"], p["b"], act,
            compute_dtype=model.compute_dtype, csr=t.spiral_csr[level],
            **_band_kw(t, level))), plan

    with torch.inference_mode():
        kps = step("regress (jv,bvc->bjc einsum)", lambda v: torch.einsum(
            "jv,bvc->bjc", jreg, v[:, :-1]).index_select(1, keep), x)
        g = step("kps gather", lambda k: gather_rows(
            k, model.kps_gather).reshape(k.shape[0], model.n_parts, -1), kps)
        hp = params["kps_heads"]
        z_kps = step("kps heads (bpk,pkl->bpl einsum)", lambda a: torch.einsum(
            "bpk,pkl->bpl", a, hp["w"]) + hp["b"][None], g)
        h, j = x, 0
        for i in range(t.n_levels - 1):
            while j < len(model.enc_plan) and model.enc_plan[j][0] == i:
                fn, plan = conv(i, params["conv"][j], model.enc_plan[j][3])
                h = step(f"encoder conv {j} (level {i})", fn, h, **plan)
                j += 1
            h = step(f"pool {i}", lambda a, i=i: pool(a, t.pool_gather[i]), h)
        g = step("part gather", lambda a: gather_rows(
            a, model.part_gather).reshape(a.shape[0], model.n_parts, -1), h)
        hp = params["enc_heads"]
        z = step("enc heads (bpk,pkl->bpl einsum)", lambda a: torch.einsum(
            "bpk,pkl->bpl", a, hp["w"]) + hp["b"][None], g)
        zz = torch.cat([z, z_kps], dim=-1)
        hp = params["dec_heads"]
        y = step("dec heads (bpl,plk->bpk einsum)", lambda a: torch.einsum(
            "bpl,plk->bpk", a, hp["w"]) + hp["b"][None], zz)
        dummy = h[:, -1:]

        def scatter(a, d):
            a = a.reshape(a.shape[0], -1, model.dec_in_c)
            o = a.new_zeros((a.shape[0], model.coarse_v + 1, a.shape[2]))
            o[:, model.part_pad_idx] = a
            return torch.cat([o[:, :model.coarse_v], d], dim=1)

        h = step("decode scatter", scatter, y, dummy)
        j = 0
        for i in range(t.n_levels - 1):
            lvl = t.n_levels - 2 - i
            h = step(f"unpool {lvl}", lambda a, lvl=lvl: unpool(
                a, t.unpool_gather[lvl], band=t.unpool_band_for(lvl)), h)
            while j < len(model.dec_plan) and model.dec_plan[j][0] == lvl:
                fn, plan = conv(lvl, params["dconv"][j], model.dec_plan[j][3])
                h = step(f"decoder conv {j} (level {lvl})", fn, h, **plan)
                j += 1
    first = next((o for o in ops if o["differ"]), None)
    for o in ops:
        log(f"[serve-dp] (a) diagnostic: {json.dumps(o)}")
    log("[serve-dp] (a) diagnostic, B = 1 against row 0 of B = 2: "
        + (f"the first op whose row differs is {first['op']}: "
           f"{first['differ']} of {first['entries']} entries, largest "
           f"{first['max_abs']:.3e}, {first['outside']} outside the JAX "
           "rule" if first else "every op's row is bit-equal"))
    return {"ops": ops, "first": first and first["op"]}


def phase_shard_diagnostic() -> dict:
    """`shard_diagnostic` on its own: the full-width default model with
    PartAE.init(0) on the card, phase 12's meshes (seed 5) at B = 2."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy

    assets, human = BodyAssets.synthetic()
    model = build_model(ModelConfig(), MeshHierarchy.load(str(TOPOLOGY)),
                        assets.part_dict, device=DEVICE)
    meshes = human.sample_meshes(max(DP_SERVE_BATCHES), seed=5)[:2].astype(
        np.float32)
    v = np.concatenate([meshes, np.zeros((2, 1, 3), np.float32)], axis=1)
    return shard_diagnostic(model, model.init(0), assets.j_regressor,
                            torch.from_numpy(v).to(DEVICE))


def phase_serve_dp(tmp: Path, model, params, meshes, j_regressor) -> tuple:
    """Phase 12 (a): the full-width bundle exported once on cuda:0, served
    by one copy and by two copies on cuda:0 (serve_dp_case), and where the
    process has two cards by [cuda:0, cuda:1] and by cuda:1 alone; then
    one copy against two on the one card in turns at B = 64 (ms per
    forward, no gate).  -> (record, launches of the two-copy run)."""
    from semantichuman_torch.serving import ServingBundle, export_inference

    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    bdir = tmp / "p12_bundle"
    export_inference(model, params, j_regressor, str(bdir))
    one = ServingBundle(str(bdir), device=card0)
    v = np.concatenate([meshes, np.zeros((len(meshes), 1, 3), np.float32)],
                       axis=1)
    refs = {"device": one.device}
    for b in DP_SERVE_BATCHES:
        x = torch.from_numpy(v[:b]).to(card0)
        enc = one.call("encode", x, graph=False)
        refs[b] = {"x": x, "z": enc[:2],
                   "forward": one.call("forward", x, graph=False),
                   "encode": enc,
                   "decode": one.call("decode", *enc[:2], graph=False)}
    out = {}
    out["cuda0x2"], counts, two = serve_dp_case(
        bdir, [card0] * DP_SERVE_COPIES, refs)
    fails = rule_fails(out["cuda0x2"])
    if fails:
        log(f"[serve-dp] (a) outside the JAX test's rule: {fails}; the "
            "diagnostic follows")
        out["diagnostic"] = shard_diagnostic(
            model, params, j_regressor,
            refs[min(DP_SERVE_BATCHES)]["x"][:2])
    else:
        log("[serve-dp] (a) every (artifact, B) meets the JAX test's rule, "
            "eager and captured: no diagnostic")
    if torch.cuda.device_count() >= 2:
        out["cuda0_cuda1"] = serve_dp_case(bdir, ["cuda:0", "cuda:1"],
                                           refs)[0]
        out["cuda1"] = serve_dp_case(bdir, ["cuda:1"], refs)[0]
    else:
        log("[serve-dp] (a) one card: [cuda:0, cuda:1] and cuda:1 alone "
            "not run")
    x = refs[max(DP_SERVE_BATCHES)]["x"]
    arms = {"one": lambda: one.forward(x), "two": lambda: two.forward(x)}
    runs = {"one": [], "two": []}
    for arm in ("one", "two", "two", "one"):
        runs[arm].append(host_ms(arms[arm], reps=20, warmup=3))
    out["ms_per_forward_b64"] = runs
    log(f"[serve-dp] (a) B={max(DP_SERVE_BATCHES)} on the one card, in "
        f"turns: one copy {runs['one']} ms, two copies {runs['two']} ms "
        "per forward (no gate: the two copies replay on one stream)")
    return out, counts


def drill_cmd(root: Path, ckpt: str, cfg: str, workdir: Path,
              data: bool) -> list:
    """The port's drill on the card as a user runs it."""
    cmd = [sys.executable, "-m", "semantichuman_torch.tools.dfaust_drill",
           "--asset_dir", str(root / "asset"), "--template",
           str(root / "template" / "template.obj"), "--checkpoint", ckpt,
           "--config", cfg, "--workdir", str(workdir), "--device", DEVICE]
    return cmd + (["--data_root", str(root)] if data else [])


def drill_launches(record: dict, test_batches: int) -> dict:
    """Each stage's launches as the main paths' literals count them: the
    import's one forward of the template; the eval's test batches and the
    staging of the train split; one run_demo and that staging; the resumed
    epoch on the epoch path (its two warm-up steps and the captured one,
    the replays left out as read_counts leaves them), its validation and
    test batches and the staging."""
    res = record["resume"]
    stage = expect({"row_gather": STAGE_GATHERS})
    want = {"import": expect(SERVE_LAUNCHES["take"]),
            "eval": {k: VAL_LAUNCHES.get(k, 0) * test_batches + stage[k]
                     for k in KERNEL_COUNTS},
            "demo": {k: demo_launches()[k] + stage[k] for k in KERNEL_COUNTS},
            "resume": {k: GRAPH_LAUNCHES.get(k, 0) * 3
                       + VAL_LAUNCHES.get(k, 0) * res["eval_batches"]
                       + stage[k] for k in KERNEL_COUNTS}}
    want.update(assets=expect({}), topology=expect({}))
    return want


def phase_drill(card: str, tmp: Path) -> tuple:
    """Phase 12 (b): the DFAUST first-contact drill on the card.  On phase
    8's dataset (preprocessed anew where phase 8 did not run), a PartAE
    trained 2 epochs by cli.train with configs/train_dfaust.yaml (the
    topology it compiles from the dataset's template with that file's
    knobs, as the drill does) and written in the reference layout; the
    port's drill on it (all six stages) and on a copy whose first part
    head is widened (import fails, topology not), two subprocesses
    started together; the eval's mm against Trainer.evaluate after
    resume_torch of the same file, the demo's OBJs, the resumed epoch and
    every stage's launches.  -> (record, the good drill's launches)."""
    from semantichuman_torch.cli import train as train_cli
    from semantichuman_torch.config import Config
    from semantichuman_torch.tools.dfaust_drill import RECORD, STAGES
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.checkpoint import restore_checkpoint

    out = {}
    root, out["preprocess_s"] = dfaust_dataset(tmp)
    cfg = dfaust_config(root, tmp / "p12_train_dfaust.yaml", True)
    t0 = time.perf_counter()
    tr = train_cli.main(["--config", cfg, "--workdir", str(tmp / "p12_fit"),
                         "--epochs", str(DFAUST_EPOCHS), "--device", DEVICE])
    tr.save(DFAUST_EPOCHS)
    state, step = restore_checkpoint(os.path.join(tr.workdir,
                                                  "checkpoints"),
                                     device=DEVICE)
    pth = tmp / f"p12_checkpoint{step}.pth.tar"
    write_reference_checkpoint(str(pth), state, tr.model, tr.cfg.train)
    out["fit_s"] = time.perf_counter() - t0
    del state, tr
    ck = torch.load(pth, map_location="cpu", weights_only=False)
    sd = ck["autoencoder_state_dict"]
    w = sd["fc_latent_enc_list.0.weight"]
    sd["fc_latent_enc_list.0.weight"] = torch.cat([w, w], dim=1)
    bad = tmp / "p12_widened.pth.tar"
    torch.save(ck, bad)
    del ck, sd

    wd, wd_bad = tmp / "p12_drill", tmp / "p12_drill_bad"
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        drill_cmd(root, ck_path, cfg, d, data), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, ck_path, d, data in (("good", str(pth), wd, True),
                                       ("bad", str(bad), wd_bad, False))}
    texts = {}
    try:
        for name, proc in procs.items():
            texts[name] = proc.communicate(timeout=DRILL_TIMEOUT)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["drill_s"] = time.perf_counter() - t0
    for name, text in texts.items():
        log(f"[drill] --- the {name} checkpoint's drill ---")
        log(text.rstrip()[-6000:])
    rc = {name: p.returncode for name, p in procs.items()}
    last = {name: json.loads(t.strip().splitlines()[-1])
            for name, t in texts.items()}
    require(rc["good"] == 0 and last["good"]["drill"] == "ok"
            and list(last["good"]["stages"]) == list(STAGES),
            f"(b) the drill: exit {rc['good']}, {last['good']}")
    require(rc["bad"] == 1 and last["bad"]["stages"].get("import")
            == "FAILED" and last["bad"]["stages"].get("topology")
            not in (None, "FAILED"),
            f"(b) the widened head's drill: exit {rc['bad']}, "
            f"{last['bad']}")
    record = json.loads((wd / RECORD).read_text())
    out["stages"] = last["good"]["stages"]
    out["stage_s"] = {k: r["seconds"] for k, r in record.items()}
    log(f"[drill] (b) stages {out['stages']}; seconds {out['stage_s']}; "
        f"the widened head: {last['bad']['stages']}")

    evals = [json.loads(line) for line in texts["good"].splitlines()
             if line.startswith('{"checkpoint"')]
    require(len(evals) == 1, f"(b) the eval stage printed {len(evals)} "
            "result lines")
    drill_cfg = Config.from_yaml(str(wd / "drill_cfg.yaml"))
    resumed = Trainer(dataclasses.replace(
        drill_cfg, train=dataclasses.replace(
            drill_cfg.train, resume_torch=str(pth), finetune=True)),
        trainer_workdir(tmp, "p12_resume_torch"), device=DEVICE)
    *_rest, l1, mm = resumed.evaluate()
    test_batches = len(resumed.test_loader)
    del resumed
    out["eval"] = {"drill": evals[0], "trainer_l1": l1, "trainer_mm": mm}
    log(f"[drill] (b) eval stage {evals[0]}; Trainer.evaluate after "
        f"resume_torch l1 {l1!r} mm {mm!r}")
    require(abs(evals[0]["mm"] - mm) <= DRILL_MM_RTOL * abs(mm),
            f"(b) the drill's eval mm {evals[0]['mm']} against the resumed "
            f"Trainer's {mm}")
    edits = sorted(os.listdir(wd / "demo" / "edits"))
    require(edits == sorted(f"sample0_{k}.obj" for k in (
        "rec", "ori", "bonelen", "girth", "style")),
        f"(b) the demo wrote {edits}")
    res = record["resume"]
    out["resume"] = {k: res[k] for k in ("epoch", "loss", "epoch_scan",
                                         "steps", "eval_batches")}
    require(np.isfinite(res["loss"]) and res["epoch_scan"]
            and res["epoch"] == DFAUST_EPOCHS + 1,
            f"(b) the resumed epoch {out['resume']}")
    want = drill_launches(record, test_batches)
    got = {k: {c: r["launches"][c] for c in KERNEL_COUNTS}
           for k, r in record.items()}
    # the resumed epoch's replays, one a step, each counting the captured
    # step's launches: left out, as read_counts leaves them out
    got["resume"] = {c: n - GRAPH_LAUNCHES.get(c, 0) * res["steps"]
                     for c, n in got["resume"].items()}
    for stage_name in STAGES:
        require(got[stage_name] == want[stage_name],
                f"(b) the drill's {stage_name}: launches "
                f"{got[stage_name]}, want {want[stage_name]}")
    counts = {k: sum(g[k] for g in got.values()) for k in KERNEL_COUNTS}
    log(f"[drill] (b) {card}: the resumed epoch {out['resume']}; launches "
        f"by stage {got}; both drills {out['drill_s']:.1f} s, the fit "
        f"{out['fit_s']:.1f} s")
    return out, counts


def phase_dp_drill(card: str, tmp: Path, ckpt: str | None) -> dict:
    """Phase 12 in the directory tmp: (a) data-parallel serving of the
    full-width default model (phase 7's epoch-2 parameters `ckpt`, None:
    PartAE.init(0)) and (b) the drill.  -> results with their launches
    under "counts" (serve_dp, drill)."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    assets, human = BodyAssets.synthetic()
    model = build_model(ModelConfig(), MeshHierarchy.load(str(TOPOLOGY)),
                        assets.part_dict, device=DEVICE)
    if ckpt is None:
        params, src = model.init(0), "PartAE.init(0)"
    else:
        params = restore_checkpoint(ckpt, device=DEVICE)[0]["params"]
        src = ckpt
    meshes = human.sample_meshes(max(DP_SERVE_BATCHES), seed=5).astype(
        np.float32)
    out = {"params": src}
    out["serve_dp"], serve_counts = phase_serve_dp(
        tmp, model, params, meshes, assets.j_regressor)
    del model, params
    torch.cuda.empty_cache()
    out["drill"], drill_counts = phase_drill(card, tmp)
    out["counts"] = {"serve_dp": serve_counts, "drill": drill_counts}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dp-drill] phase 12 ({card}): {out['phase_s']:.1f} s")
    return out


def parse_args(argv):
    """No argument: every phase, the gates and the result line.  The two
    tuning modes run phase 1 and one kernel's phase alone, with a profile
    per conv; they are no gate and print no result line."""
    import argparse

    p = argparse.ArgumentParser(description="On-card smoke test of the "
                                "PyTorch/CUDA port.")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--conv-forward", action="store_true",
                      help="phase 1 and the conv forward's phase 2 alone")
    mode.add_argument("--conv-backward", action="store_true",
                      help="phase 1 and the conv backward's phase alone, "
                      "with the dx controls")
    mode.add_argument("--part-dist", action="store_true",
                      help="phase 1 and the part_dist kernel's checks and "
                      "times alone (phase 4's and phase 6's)")
    mode.add_argument("--gather-rows", action="store_true",
                      help="phase 1 and the row gather's checks and times "
                      "alone (phase 4's)")
    mode.add_argument("--csr-reduce", action="store_true",
                      help="phase 1 and the CSR reduce's checks and times "
                      "alone (phases 4 and 6), with a sweep of its batch "
                      "tile")
    mode.add_argument("--trainer", action="store_true",
                      help="phase 1 and the Trainer's phase 7 alone (the "
                      "loop and the epoch path, their gates and times)")
    mode.add_argument("--dfaust", action="store_true",
                      help="phase 1 and phase 8 alone (the preprocessing "
                      "CLIs and cli.train on configs/train_dfaust.yaml, "
                      "both layouts)")
    mode.add_argument("--baseline", action="store_true",
                      help="phase 1 and phase 9 alone (cli.train on "
                      "configs/train_neural3dmm.yaml, resume_torch against "
                      "the native resume for both model families)")
    mode.add_argument("--deploy", action="store_true",
                      help="phase 1 and phase 10 alone (the Editor, the "
                      "exported bundle and its captured forward, "
                      "cli.export, cli.eval_reference and cli.demo)")
    mode.add_argument("--parallel", action="store_true",
                      help="phase 1 and phase 11 alone (data-parallel "
                      "training over gloo and NCCL, the trace window, "
                      "geometry, the serving dtype A/B)")
    mode.add_argument("--drill", action="store_true",
                      help="phase 1 and phase 12 alone (data-parallel "
                      "serving from one bundle, the DFAUST first-contact "
                      "drill)")
    mode.add_argument("--shard-diagnostic", action="store_true",
                      help="phase 1 and phase 12 (a)'s diagnostic alone: "
                      "the full-width model (PartAE.init(0)) op by op at "
                      "B = 1 against row 0 of B = 2")
    mode.add_argument("--band-gates", action="store_true",
                      help="phase 1 and the banded routes' batch gates, "
                      "each on its own against the take route, in turns "
                      "(serving and the Trainer's epoch path)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train.losses import build_loss_tables

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")

    card = phase_build()
    if args.dfaust:
        # the on-disk dataset's phase alone: no result line
        with tempfile.TemporaryDirectory() as tmp:
            dfaust = phase_dfaust(card, Path(tmp))
        for layout in ("stacked", "files"):
            dfaust[layout].pop("profile")
        log(json.dumps({"dfaust": dfaust}))
        log(card)
        return 0
    if args.trainer:
        # the Trainer's phase alone, for work on its paths: no result line
        with tempfile.TemporaryDirectory() as tmp:
            log(json.dumps({"trainer": phase_trainer(Path(tmp))}))
        log(card)
        return 0
    if args.deploy:
        # editing and deployment alone: no result line
        with tempfile.TemporaryDirectory() as tmp:
            deploy = phase_deploy(card, Path(tmp), None)
        deploy.pop("counts")
        log(json.dumps({"deploy": deploy}, default=str))
        log(card)
        return 0
    if args.parallel:
        # data parallelism, the trace window, geometry and the serving A/B
        # alone: no result line
        with tempfile.TemporaryDirectory() as tmp:
            par = phase_parallel(card, Path(tmp), None)
        par.pop("counts")
        log(json.dumps({"parallel": par}, default=str))
        log(card)
        return 0
    if args.shard_diagnostic:
        # the shard-of-1 diagnostic alone, whatever the rule reads: no
        # result line
        log(json.dumps({"shard_diagnostic": phase_shard_diagnostic()}))
        log(card)
        return 0
    if args.drill:
        # data-parallel serving and the drill alone: no result line
        with tempfile.TemporaryDirectory() as tmp:
            dp_drill = phase_dp_drill(card, Path(tmp), None)
        dp_drill.pop("counts")
        log(json.dumps({"dp_drill": dp_drill}, default=str))
        log(card)
        return 0
    if args.baseline:
        # the baseline's and resume_torch's phase alone: no result line
        with tempfile.TemporaryDirectory() as tmp:
            baseline = phase_baseline(card, Path(tmp), None)
        baseline.pop("profile")
        log(json.dumps({"baseline": baseline}))
        log(card)
        return 0

    human = SyntheticHuman()
    hier = MeshHierarchy.load(str(TOPOLOGY))
    model = build_model(ModelConfig(), hier, human.part_dict, device="cuda")
    model_take = build_model(ModelConfig(banded_conv=False), hier,
                             human.part_dict, device="cuda")
    params = model.init(0)
    require(len(conv_layers(model)) == 9, "expected 9 convs per forward")
    if args.band_gates:
        # the gates' measurements alone: no result line
        log(json.dumps({"band_gates": phase_band_gates(model, params,
                                                       human)}))
        log(card)
        return 0

    if args.conv_forward:
        # the conv-forward phase alone, for tuning its kernel: prints the
        # per-conv lines and the sums, and no result line
        rows, _err = phase_kernels(model, profile=True)
        log(json.dumps({f"B={b}": fwd_sums(rows, b) for b in FWD_TIMED}))
        log(card)
        return 0
    if args.conv_backward:
        # the conv-backward phase alone, for tuning its kernels: prints
        # the per-conv lines and the sums, and no result line
        bwd32 = [r for r in phase_conv_backward(model, profile=True)
                 if r["dtype"] == "float32"]
        log(json.dumps({k: sum(r[k] for r in bwd32) for k in (
            "ms", "fused_ms", "unfused_ms", "dw_ms", "dw_unfused_ms",
            "dx_ms", "dx_unfused_ms", "bound_ms")}))
        log(card)
        return 0
    if args.part_dist:
        # the part_dist checks alone, for tuning its kernel: no result line
        phase_part_dist(human)
        phase_part_dist_trainer(human)
        log(card)
        return 0
    loss_tables = build_loss_tables(human.template_faces, human.J_regressor,
                                    human.part_dict, device=DEVICE)
    if args.gather_rows:
        # the row gather's checks alone, for tuning its kernel
        phase_gather_rows(model, loss_tables)
        log(card)
        return 0
    if args.csr_reduce:
        # the CSR reduce's checks alone, for tuning its kernel
        step_rows, _dx = phase_csr_reduce(model, human, loss_tables)
        phase_csr_trainer(model, human, loss_tables)
        log(json.dumps({"families": csr_family_sums(step_rows)}))
        log(card)
        return 0

    rows, max_err = phase_kernels(model)
    serve, serve_banded, serve_take, timing, timing_banded = phase_serving(
        model, model_take, params, human)
    del model_take

    fwd = {b: fwd_sums(rows, b) for b in FWD_TIMED}
    for b, f in fwd.items():
        log(f"[kernel] nine float32 convs at B={b}: kernel {f['ms']:.3f} ms "
            f"(runs {np.round(f['ms_runs'], 3).tolist()}), "
            f"plain {f['plain_ms']:.3f}, gemm alone {f['gemm_ms']:.3f}, bound "
            f"{f['bound_ms']:.3f} ms ({100 * f['bound_ms'] / f['ms']:.1f} % "
            f"of it); bf16 kernel {f['bf16_ms']:.3f}")
    kernel_ms = fwd[BATCH]["ms"]
    log(f"[serve] B={BATCH}: spiral_conv kernels {kernel_ms:.3f} ms of "
        f"{timing[BATCH]:.3f} ms per forward "
        f"({100 * kernel_ms / timing[BATCH]:.1f} %)")

    conv_bwd = phase_conv_backward(model)
    csr_step, csr_dx = phase_csr_reduce(model, human, loss_tables)
    gather_shapes = phase_gather_rows(model, loss_tables)
    pd_rows = phase_part_dist(human)
    banded_rows = phase_banded_kernels(model)
    conv_bwd_trainer = phase_conv_backward_trainer(model)
    pd_trainer = phase_part_dist_trainer(human)
    csr_trainer = phase_csr_trainer(model, human, loss_tables)
    torch.cuda.empty_cache()
    train = phase_train(human, hier)
    step_counts = train.pop("counts")
    torch.cuda.empty_cache()
    # phases 7-9 share a directory: phase 9 trains on phase 8's dataset and
    # resumes from phase 7's checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        trainer = phase_trainer(Path(tmp))
        trainer_counts = trainer.pop("counts")
        graph_counts = trainer.pop("graph_counts")
        banded_counts = trainer.pop("banded_counts")
        banded_graph_counts = trainer["routes"].pop("banded_counts")
        torch.cuda.empty_cache()
        dfaust = phase_dfaust(card, Path(tmp))
        dfaust_counts = {layout: dfaust[layout].pop("counts")
                         for layout in ("stacked", "files")}
        torch.cuda.empty_cache()
        baseline = phase_baseline(card, Path(tmp),
                                  trainer["epoch2_checkpoint"])
        torch.cuda.empty_cache()
        deploy = phase_deploy(card, Path(tmp), trainer["epoch2_checkpoint"])
        torch.cuda.empty_cache()
        parallel = phase_parallel(card, Path(tmp),
                                  trainer["epoch2_checkpoint"])
        torch.cuda.empty_cache()
        dp_drill = phase_dp_drill(card, Path(tmp),
                                  trainer["epoch2_checkpoint"])
    deploy_counts = deploy.pop("counts")
    parallel_counts = parallel.pop("counts")
    dp_drill_counts = dp_drill.pop("counts")
    baseline_counts = {
        "neural3dmm": baseline.pop("counts"),
        "neural3dmm_epoch": baseline.pop("epoch_path_counts"),
        "neural3dmm_resume_torch": baseline["n3dmm_resume"].pop("counts"),
        "partae_resume_torch": baseline["partae_resume"].pop("counts")}

    # trainer_graph: the epoch path's fit, whose wrappers count its
    # warm-up steps, the captured step and the validation passes
    # (read_counts leaves the replays out; phase 7 holds them to the
    # profiler);
    # serve_banded, trainer_banded (the loop's fit) and
    # trainer_banded_graph (the launches recorded while the epoch path's
    # step is captured): the forced banded arms (FORCED_GATES), the only
    # runs of rows 5-6 on a path a user drives, since the card's
    # measurements closed both gates; neural3dmm: phase 9 (a)'s cli.train;
    # neural3dmm_epoch: (a) again on the epoch path (warm-ups, capture,
    # validation and test; replays left out);
    # *_resume_torch: the epoch 3 resumed from a reference checkpoint;
    # phase 10: edit (one run_demo), export_serve (the eager programs),
    # graph_serve (per batch the two warm-ups and the capture; replays
    # left out, phase 10 holds the replays to the profiler),
    # eval_reference (cli.eval_reference on the card); phase 11: dp_gloo
    # (both ranks of (a) and of its resume, each counted in its own
    # process), dp_nccl1, trace (the windowed fit), geometry (the card's
    # checks), serving_ab (the tool's two arms); phase 12: serve_dp (the
    # two copies on one card, eager calls and captures; replays left
    # out), drill (the drill's six stages, counted in its process, the
    # resumed epoch's replays included)
    paths = {"serve": serve, "serve_banded": serve_banded,
             "serve_take": serve_take, "train_step": step_counts,
             "trainer": trainer_counts, "trainer_graph": graph_counts,
             "trainer_banded": banded_counts,
             "trainer_banded_graph": banded_graph_counts,
             "dfaust_stacked": dfaust_counts["stacked"],
             "dfaust_files": dfaust_counts["files"], **baseline_counts,
             **deploy_counts, **dp_drill_counts, **parallel_counts}

    def launches(name):
        by_path = {p: c[name] for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    bwd32 = [r for r in conv_bwd if r["dtype"] == "float32"]
    bwd_sum = {k: sum(r[k] for r in bwd32)
               for k in ("ms", "fused_ms", "unfused_ms", "plain_ms",
                         "bound_ms", "ops_ms", "bytes_ms", "dw_ms",
                         "dw_unfused_ms", "dx_ms", "dx_unfused_ms")}
    log(f"[conv-bwd] nine float32 convs at batch {TRUNK_B}: dispatched "
        f"{bwd_sum['ms']:.3f} ms, all fused {bwd_sum['fused_ms']:.3f} ms, "
        f"all unfused {bwd_sum['unfused_ms']:.3f} ms, plain "
        f"{bwd_sum['plain_ms']:.3f} ms, bound {bwd_sum['bound_ms']:.3f} ms")
    pd = {(r["w_mode"], r["mode"]): r for r in pd_rows}
    pallas = "semantichuman_tpu/ops/pallas/part_dist_pallas.py"
    f64, f384 = fwd[BATCH], fwd[TRUNK_B]
    kernels = [{
        "name": "spiral_conv_fwd",
        "row": 1,
        "route": "cuda",
        "source": "semantichuman_torch/csrc/spiral_conv_fwd.cu",
        "replaces": "semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:78",
        **launches("spiral_conv_fwd"),
        "max_abs_err": max_err,
        # the nine float32 convs of one B=64 forward, summed; the same at
        # the step's trunk batch 384 below
        "ms": f64["ms"],
        "plain_ms": f64["plain_ms"],
        "bound_ms": f64["bound_ms"],
        "bound_by": ("operations" if f64["ops_ms"] >= f64["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        # cuBLAS's SGEMM alone on the pre-gathered buffer
        "gemm_ms": f64["gemm_ms"],
        "b384": f384,
        "b64": f64,
        "forward_ms": {"default": timing, "banded": timing_banded},
        "layers": rows,
    }]
    kernels.append({
        "name": "spiral_conv_bwd",
        "row": "1 bwd",
        "route": "cuda",
        "source": "semantichuman_torch/csrc/spiral_conv_bwd.cu",
        # the kernel's backward: XLA's autodiff of spiral_conv_take
        "replaces": "semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:78",
        "launches": sum(c["spiral_conv_bwd_dw"] + c["spiral_conv_bwd_dx"]
                        for c in paths.values()),
        "launches_by_path": {p: {"dw": c["spiral_conv_bwd_dw"],
                                 "dx": c["spiral_conv_bwd_dx"]}
                             for p, c in paths.items()},
        "max_abs_err": max(
            [max(r["dw_kernel_max_abs_err"], r["dx_kernel_max_abs_err"])
             for r in conv_bwd]
            + [max(r["dw_max_abs_err"], r["dx_max_abs_err"])
               for r in conv_bwd_trainer]),
        # the nine float32 convs' backward at batch 384, summed: as the
        # dispatch table routes it, and on the unfused route
        "ms": bwd_sum["ms"],
        "fused_ms": bwd_sum["fused_ms"],
        "unfused_ms": bwd_sum["unfused_ms"],
        "plain_ms": bwd_sum["plain_ms"],
        # the sum of the layers' bounds, two of which (3 channels in or
        # out) are bound by bytes
        "bound_ms": bwd_sum["bound_ms"],
        "bound_by": ("operations" if bwd_sum["ops_ms"] >= bwd_sum["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "halves_ms": {k: bwd_sum[k] for k in ("dw_ms", "dw_unfused_ms",
                                              "dx_ms", "dx_unfused_ms")},
        "layers": conv_bwd,
        # each kernel against its plain version at trunk batch 12
        "trainer_layers": conv_bwd_trainer,
    })
    for row, (mode, line) in enumerate((("fwd", 330), ("fwd_grad", 356),
                                        ("bwd", 413)), start=2):
        r = pd[("threshold", mode)]
        kernels.append({
            "name": f"part_dist_{mode}",
            "row": row,
            "route": "cuda",
            "source": "semantichuman_torch/csrc/part_dist.cu",
            "replaces": f"{pallas}:{line}",
            **launches(f"part_dist_{mode}"),
            "max_abs_err": r["err"]["max_abs"],
            # one call at 17 parts x B = 128, w_mode threshold; each time
            # the mean of the two readings in *_runs
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "ms_runs": r["ms_runs"],
            "masked_share": r["masked_share"],
            "asymmetric_share": r["asymmetric_share"],
            "sin": pd[("sin", mode)],
            "all_one": pd[("all_one", mode)],
            "trainer_grid": pd_trainer if mode == "fwd_grad" else None,
        })
    banded_pallas = "semantichuman_tpu/ops/pallas/banded_gather_pallas.py"
    for row, name, key, source, replaces in (
            (5, "banded_gather_fwd", "fwd", "banded_gather.cu",
             f"{banded_pallas}:187"),
            (6, "banded_gather_bwd", "bwd", "banded_gather.cu",
             f"{banded_pallas}:237")):
        # every call of it in one Trainer step (trunk batch 12), summed
        summary = banded_summary(banded_rows, key)
        kernels.append({
            "name": name,
            "row": row,
            "route": "cuda",
            "source": f"semantichuman_torch/csrc/{source}",
            "replaces": replaces,
            **launches(name),
            "max_abs_err": summary.pop("max_abs_err"),
            **{k: summary.pop(k) for k in ("ms", "plain_ms", "bound_ms")},
            # back-to-back calls timed with CUDA events: the host's pace
            "host_ms": summary.pop("host_ms"),
            "bound_by": "bytes",
            "library_ms": summary.pop("library_ms"),
            "step_calls": summary.pop("calls"),
            "calls": [{"call": r["call"], "m": r["m"], **r[key]}
                      for r in banded_rows if key in r],
        })
    # row 7: the step's gathers at their main-path shapes, float32, summed
    # (gather_calls); the Trainer step's banded fix-ups beside them
    g32 = [r for r in gather_shapes if r["dtype"] == "float32"]
    fixups = banded_summary(banded_rows, "row_gather")
    kernels.append({
        "name": "row_gather",
        "row": 7,
        "route": "cuda",
        "source": "semantichuman_torch/csrc/row_gather.cu",
        "replaces": "benchmarks/pallas_dma_gather_probe.py:83",
        **launches("row_gather"),
        "max_abs_err": max(max(r["max_abs_err"] for r in gather_shapes),
                           fixups["max_abs_err"]),
        **{k: sum(r[k] for r in g32) for k in ("ms", "plain_ms",
                                               "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "shapes": gather_shapes,
        "trainer_fixups": fixups,
        "trainer_fixup_calls": [{"call": r["call"], "m": r["m"],
                                 **r["row_gather"]}
                                for r in banded_rows if "row_gather" in r],
    })
    # row 8: the 17 calls of one B = 128 step at their shapes, summed; by
    # family beside them; the conv dx shapes and the Trainer's shapes
    csr_fams = csr_family_sums(csr_step)
    csr_w = [r for r in csr_step if r["weighted"]]
    kernels.append({
        "name": "csr_reduce",
        "row": 8,
        "route": "cuda",
        "source": "semantichuman_torch/csrc/csr_reduce.cu",
        "replaces": "benchmarks/pallas_dma_gather_probe.py:157",
        **launches("csr_reduce"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in csr_step + csr_dx + csr_trainer),
        **{k: sum(r[k] for r in csr_step) for k in CSR_SUMS},
        "bound_by": "bytes",
        "families": csr_fams,
        "step_calls": csr_step,
        # weighted, at the four unpools' backward shapes (B = 384)
        "weighted_ms": sum(r["ms"] for r in csr_w),
        "weighted_bound_ms": sum(r["bound_ms"] for r in csr_w),
        "weighted_library_ms": sum(r["library_ms"] for r in csr_w),
        # the stress case: the nine convs' dx shapes at 384; the step runs
        # the 64 -> 128 conv's
        "conv_dx": csr_dx,
        "conv_dx_ms": {k: sum(r[k] for r in csr_dx[1:]) for k in CSR_SUMS},
        "trainer_calls": csr_trainer,
        "conv_backward_f32_sum": bwd_sum,
        "conv_backward": conv_bwd,
    })
    # the two fused backward kernels are asked for where every conv takes
    # the take route, the B = 128 step; at trunk batch 12 the Trainer
    # reaches them at its four coarse convs only
    for k in KERNEL_COUNTS:
        path = ("train_step" if k.startswith("spiral_conv_bwd")
                else "trainer_banded" if k.startswith("banded_gather")
                else "trainer")
        require(paths[path][k] > 0 or k in ("part_dist_fwd",
                                            "part_dist_bwd"),
                f"{k}: no launch on the {path} path")
    log(json.dumps({"trainer": trainer}))
    log(json.dumps({"dfaust": dfaust}, default=str))
    log(json.dumps({"baseline": baseline}, default=str))
    log(json.dumps({"deploy": deploy}, default=str))
    log(json.dumps({"parallel": parallel}, default=str))
    log(json.dumps({"dp_drill": dp_drill}, default=str))
    log(json.dumps({"train": train}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
