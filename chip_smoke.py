#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (semantichuman_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc.  Phases, each of which fails the
run:

1. build: compile every CUDA kernel of the port from `semantichuman_torch/
   csrc/` (one nvcc per source, seven sources, in parallel) and print the
   card.
2. the conv forward: at each of the nine full-width conv shapes (the
   bundled 6892-vertex topology's spiral tables), in float32 and bfloat16
   inputs, at B = 1, 12, 16, 64 and 384, hold the forward kernel
   (`csrc/spiral_conv_fwd.cu`, as `spiral_conv` dispatches it) against its
   plain PyTorch version and against the port's first kernel
   (`spiral_conv_fwd_v1`, `csrc/spiral_conv.cu`, the yardstick): rtol
   1e-4, atol 1e-5 (the only difference is the order of f32 sums over
   K <= 480), an exactly zero dummy row, two runs bit-equal.  At B = 64
   and 384 time the kernel, v1, the plain version and cuBLAS's SGEMM alone
   on the pre-gathered [B*V1, S*C] buffer in turns; the nine float32 convs
   must be faster through the kernel than through v1 at both.
3. serving: build the full-width PartAE from the default ModelConfig (seed
   0, banded_conv on), export a bundle, load it on the card, answer forward
   at B = 1, 16, 64 and encode -> decode at B = 64 with the launch counts
   set to 0 just before; require per forward, by route (SERVE_LAUNCHES):
   at B <= 16 five banded convs and four banded unpools (9 banded-gather
   forwards, 8 fix-up row gathers) and 4 spiral-conv launches, at B = 64
   nine spiral-conv launches and the four banded unpools (3 row gathers);
   finite outputs, exactly zero dummy rows, and agreement (atol 1e-4) with
   the same model run through the plain conv on the card and with the
   same params exported with banded_conv off (9 spiral-conv launches).
   Then time both bundles.

4. training kernels, at the training step's full-width shapes (trunk
   batch 384 = three segments of B = 128): the spiral conv's backward
   (dx, dW, db) against autograd of the plain conv at the nine conv
   shapes in float32 and bfloat16, and there the two fused kernels
   (spiral_conv_bwd_dw, spiral_conv_bwd_dx) each alone against its plain
   version (1e-4 of the largest entry, two runs bit-equal) and timed
   beside the unfused route (torch matmuls around the [B, V1, S*C]
   buffers and csr_reduce), whole and half by half, the routes in turns
   (a, b, b, a) with both readings kept; csr_reduce
   against its plain version and `index_add_`; the part_dist kernels
   (rows fwd, fwd_grad, bwd) against their plain versions at 17 parts x
   B = 128, for w_mode threshold and sin, relat on.  Errors, times and
   bounds per kernel.
5. the training step: the full-width model from seed 0, `make_train_step`
   with StepFlags(), exc_variant 'ori', EditSampler(seed=0) at epoch 200
   and make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1), three segments
   of B = 128.  One loss+gradient through the kernels and one through the
   plain versions (plain conv, autograd of the plain distance sums) must
   agree; then 10 steps with the launch counts set to 0 just before:
   finite losses and, per step (STEP_LAUNCHES), 9 conv forward, 9 dW, 7
   dx and 1 csr_reduce launches (the first conv's input is data, so 8
   convs ask for dx; the 64 -> 128 conv's takes the unfused route, whose
   reduction is the csr_reduce launch) and 2 part_dist fwd_grad launches
   (0 fwd, 0 bwd).  Then ms/step, meshes/s
   (128 per step, as bench.py counts), the device idle share, the top
   kernels (torch.profiler) and one bf16-trunk step (finite loss).
   At trunk batch 384 no banded route engages: 0 banded launches.
6. banded kernels, at the trainer's shapes (trunk batch 12 = three
   segments of B = 4, the bundled topology's band tables): every banded
   call of one step (convs at levels 0-1 at their input widths, unpools
   into levels 0-3).  The banded-gather forward against its plain version
   (bit-equal unweighted, rtol 1e-6 weighted), its backward (1e-5 of the
   largest entry with the dummy row zeroed, two runs bit-equal) and the
   fix-up row gather (bit-equal to index_select), each timed on the device
   (torch.profiler: these kernels take microseconds, so back-to-back calls
   are paced by the host) beside its plain version, the library call
   (index_select, index_add_) and its bound (bytes moved / 3.35 TB/s).
   Then the two fused backward kernels at the four convs that stay on the
   take route there (enc L2, enc L3, dec L3, dec L2; batch 12 fills the
   dx kernel's batch tiles only partly), float32 and bfloat16: each
   within 1e-4 of the largest entry of its plain version, two runs
   bit-equal.
7. the Trainer: the paper recipe (Config() defaults: B = 4 per segment,
   lr 1e-3, banded_conv on) on synthetic SMPL-scale data (64 train, 16
   test meshes), full width, 3 epochs with the launch counts set to 0 just
   before fit(): finite falling epoch losses and per step (TRAIN_LAUNCHES)
   9 banded-gather forwards, 8 backwards, 8 row gathers, 4 spiral-conv
   forwards, 2 part_dist fwd_grad, and for the four coarse convs on the
   take route (enc L2, enc L3, dec L3, dec L2) 4 dW launches and 0 dx (at
   batch <= 16 every dx half takes the unfused route), and 11 csr_reduce
   (the 7 fix-up gathers' backwards and the 4 unfused dx); plus 9/8/4
   forward launches per validation pass.  The v1 forward kernel launches
   on no main path.
   fit() runs as a user's does, with torch's default algorithms.  Four
   runs resumed from its epoch-2 checkpoint, banded_conv on, off, off, on,
   repeat epoch 3: its train loss to rtol 1e-2 (atomics make the
   comparison chaotic, see phase_trainer), and per route ms/step (the
   median of both runs' epoch-3 steps, a synchronize after each step),
   meshes/s (4 a step), s/epoch, the idle share and top kernels; evaluate
   once (finite l1 and mm).  The exact gate runs under torch's
   deterministic algorithms: a second fit() there, and two runs resumed
   from its epoch-2 checkpoint, banded_conv on and off, held to its epoch
   3 (train loss to rtol 1e-4 banded, 1e-3 take).

The last two lines are a JSON object with each kernel's launches, error and
times, and `{"ok": true, "device": {...}}`.  Without a card it exits 1
before printing any result.  `python3 chip_smoke.py --conv-forward` runs
phase 1 and phase 2 alone, `--conv-backward` phase 1 and phase 4's conv
backward alone, each with a per-kernel profile, for tuning those kernels:
they print no result line and are no gate.
"""

from __future__ import annotations

import contextlib
import copy
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
KERNEL_COUNTS = ("spiral_conv_fwd", "spiral_conv_fwd_v1",
                 "spiral_conv_bwd_dw", "spiral_conv_bwd_dx", "csr_reduce", "part_dist_fwd",
                 "part_dist_fwd_grad", "part_dist_bwd", "banded_gather_fwd",
                 "banded_gather_bwd", "row_gather")
# launches per forward of the default model, by route: at B <= 16 the
# convs at levels 0-1 (5 of 9) and the four unpools take the banded route;
# every banded call but unpool 4->3 (no out-of-band taps) adds a fix-up
# row gather.  At 16 < B <= 128 only the unpools do.
SERVE_LAUNCHES = {
    "small": {"spiral_conv_fwd": 4, "banded_gather_fwd": 9, "row_gather": 8},
    "large": {"spiral_conv_fwd": 9, "banded_gather_fwd": 4, "row_gather": 3},
    "take": {"spiral_conv_fwd": 9},
}
# launches per Trainer step at trunk batch 12: the forward as "small"
# above; backward through 8 banded calls (all but the first conv, whose
# input is data) and their 7 fix-up gathers' backward through csr_reduce;
# the loss's two part_dist fwd_grad calls; the 4 take-route convs' backward
# (enc L2, enc L3, dec L3, dec L2) launches 4 dW, and their 4 dx halves take
# the unfused route at batch <= 16: 4 csr_reduce more.
TRAIN_LAUNCHES = {"spiral_conv_fwd": 4, "spiral_conv_bwd_dw": 4,
                  "spiral_conv_bwd_dx": 0, "banded_gather_fwd": 9,
                  "banded_gather_bwd": 8, "row_gather": 8, "csr_reduce": 11,
                  "part_dist_fwd_grad": 2}
# launches per B = 128 training step (trunk batch 384, no banded route):
# nine convs forward and their dW; dx for all but the first, whose input
# is data, the 64 -> 128 conv's on the unfused route (one csr_reduce)
STEP_LAUNCHES = {"spiral_conv_fwd": 9, "spiral_conv_bwd_dw": 9,
                 "spiral_conv_bwd_dx": 7, "csr_reduce": 1,
                 "part_dist_fwd_grad": 2}
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
                  "conv_fwd_v1": "spiral_conv_fwd_kernel",
                  "conv_bwd_dw": "dw_partial_kernel",
                  "conv_bwd_dw_finish": "dw_finish_kernel",
                  "conv_bwd_dx_short": "dx_short_kernel",
                  "conv_bwd_dx_narrow": "dx_narrow_kernel",
                  "conv_bwd_dx_long": "dx_long_",
                  "csr_reduce": "csr_", "part_dist": "part_dist_kernel",
                  "gemm": "gemm", "index_add": "indexFunc",
                  "index_select": "index_elementwise",
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


def device_ms(fn, iters: int = 20, attempts: int = 3) -> float:
    """Device time per call of fn(): the summed durations of every kernel
    and copy that `iters` calls ran (torch.profiler), over iters.  Unlike
    time_ms it leaves out the host: back-to-back calls of a kernel of a
    few microseconds are paced by the host's launch rate, not the card.
    A profiling window that records no device activity (seen once in
    some thirty windows on the chip machine) is taken again."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return time_ms(fn, iters)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise SmokeFailure(f"the profiler saw no device time in {attempts} "
                       "windows")


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
    order) and against the v1 kernel (`spiral_conv_fwd_v1`, the same
    tolerance), an exactly zero dummy row, two runs bit-equal, one counted
    launch a call.  At B = 64 and 384 (FWD_TIMED) the routes are timed in
    turns with both readings kept (`*_runs`): the kernel (`ms`), v1
    (`v1_ms`) and, in float32, the plain version (`plain_ms`) and cuBLAS's
    SGEMM alone on the pre-gathered [B*V1, S*C] buffer (`gemm_ms`: the
    yardstick of a library GEMM of the same M x K x N, which computes no
    conv and which the port never calls).  `profile` adds the device time
    by kernel of each float32 conv at B = 384."""
    from semantichuman_torch.ops import spiral_conv as SC

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

                def yardstick():
                    return SC.spiral_conv_fwd_v1(xc, spiral, wc, bias, act)

                def plain():
                    return SC.spiral_conv_plain(xc, spiral, wc, bias, act)

                got, again, v1_out, ref = kernel(), kernel(), yardstick(), \
                    plain()
                sync()
                got_counts = counts_diff(read_counts(), before)
                require(got_counts["spiral_conv_fwd"] == 2
                        and got_counts["spiral_conv_fwd_v1"] == 1,
                        f"{tag}: launches {got_counts}")
                require(torch.equal(got, again), f"{tag}: two runs differ")
                require(torch.count_nonzero(got[:, -1]) == 0,
                        f"{tag}: dummy row not zero")
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                           msg=lambda m: f"{tag}: {m}")
                torch.testing.assert_close(got, v1_out, rtol=1e-4, atol=1e-5,
                                           msg=lambda m: f"{tag} v1: {m}")
                err = float((got - ref).abs().max())
                max_err = max(max_err, err)
                plan = SC._fwd_plan(b, v1, cin, s, cout, dtype)
                row = {"layer": label, "batch": b,
                       "dtype": str(dtype).split(".")[-1], "v1": v1, "s": s,
                       "c_in": cin, "c_out": cout, "tile": plan["tile"],
                       "max_abs_err": err,
                       "v1_max_abs_err": float((v1_out - ref).abs().max())}
                del got, again, v1_out, ref
                if b in FWD_TIMED:
                    fns = {"ms": kernel, "v1_ms": yardstick}
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
                        f" ms kernel {row['ms']:.4f} v1 {row['v1_ms']:.4f}"
                        + (f" plain {row['plain_ms']:.4f} gemm "
                           f"{row['gemm_ms']:.4f}" if g is not None else "")
                        + f" bound {row['bound_ms']:.4f} ({row['bound_by']})"
                        f" | runs {np.round(runs['ms'], 4).tolist()} v1 "
                        f"{np.round(runs['v1_ms'], 4).tolist()}")
                    if profile and b == max(FWD_TIMED) and g is not None:
                        log(f"[profile] {tag} forward as dispatched")
                        profile_steps(kernel, row["ms"])
                    del g
                else:
                    log(f"[kernel] {tag:30s} tile {plan['tile']} "
                        f"err={err:.3e} v1 err={row['v1_max_abs_err']:.3e}")
                rows.append(row)
            del x, w, bias, xc, wc
        torch.cuda.empty_cache()
    return rows, max_err


def fwd_sums(rows, b: int) -> dict:
    """The nine float32 convs at batch b, summed."""
    f32 = [r for r in rows if r["dtype"] == "float32" and r["batch"] == b]
    keys = ("ms", "v1_ms", "plain_ms", "gemm_ms", "bound_ms", "ops_ms",
            "bytes_ms")
    out = {k: sum(r[k] for r in f32) for k in keys}
    for k in ("ms", "v1_ms", "plain_ms", "gemm_ms"):
        out[f"{k}_runs"] = [sum(r[f"{k}_runs"][i] for r in f32)
                            for i in range(2)]
    bf16 = [r for r in rows if r["dtype"] == "bfloat16" and r["batch"] == b]
    out["bf16_ms"] = sum(r["ms"] for r in bf16)
    out["bf16_v1_ms"] = sum(r["v1_ms"] for r in bf16)
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
    with tempfile.TemporaryDirectory() as tmp:
        manifest = export_inference(model, params, human.J_regressor, tmp)
        bundle = ServingBundle(tmp, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        manifest_take = export_inference(model_take, params,
                                         human.J_regressor, tmp)
        bundle_take = ServingBundle(tmp, device="cuda")
    require(manifest["n_vertices"] == len(human.template_verts),
            "manifest vertex count")
    require(manifest["banded_conv"] and not manifest_take["banded_conv"],
            "bundles must carry their banded_conv flag")
    v1 = manifest["n_vertices"] + 1
    batches = {b: torch.from_numpy(verts_all[:b]).cuda()
               for b in SERVE_BATCHES}
    for bd in (bundle, bundle_take):
        for b in SERVE_BATCHES:                      # warm-up, not counted
            bd.forward(batches[b])
    torch.cuda.synchronize()

    # --- the main path: counts from 0, read right after -------------------
    reset_counts()
    outs = {}
    for b in SERVE_BATCHES:
        before = read_counts()
        outs[b] = bundle.forward(batches[b])
        torch.cuda.synchronize()
        got = counts_diff(read_counts(), before)
        want = expect(SERVE_LAUNCHES[serve_route(b)])
        require(got == want, f"forward B={b}: launches {got}, want {want}")
    before = read_counts()
    z, z_kps, _dummy = bundle.encode(batches[BATCH])
    dec = bundle.decode(z, z_kps)
    torch.cuda.synchronize()
    got = counts_diff(read_counts(), before)
    require(got == expect(SERVE_LAUNCHES["large"]),
            f"encode+decode: launches {got}")
    launches = read_counts()
    log(f"[serve] main path (banded bundle): launches {launches}")

    # the same params exported with banded_conv off: the take route only
    reset_counts()
    outs_take = {}
    for b in SERVE_BATCHES:
        outs_take[b] = bundle_take.forward(batches[b])
    torch.cuda.synchronize()
    launches_take = read_counts()
    require(launches_take == expect(SERVE_LAUNCHES["take"],
                                    len(SERVE_BATCHES)),
            f"take bundle: launches {launches_take}")
    for b in SERVE_BATCHES:
        for name, got, want in zip(("rec", "z", "z_kps"), outs[b],
                                   outs_take[b]):
            err = float((got - want).abs().max())
            log(f"[serve] banded vs take B={b} {name}: max abs err "
                f"{err:.3e}")
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

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

    # --- timing (after the counted run), the two routes in turns ----------
    def wall_ms(bd, b, reps=20):
        for _ in range(3):
            bd.forward(batches[b])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            bd.forward(batches[b])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    timing, timing_take = {}, {}
    for b in SERVE_BATCHES:
        runs = {"banded": [], "take": []}
        for route in ("banded", "take", "take", "banded"):
            runs[route].append(wall_ms(
                bundle if route == "banded" else bundle_take, b))
        timing[b], timing_take[b] = (float(np.mean(runs["banded"])),
                                     float(np.mean(runs["take"])))
        log(f"[serve] forward B={b}: banded {runs['banded']} ms, take "
            f"{runs['take']} ms; {b / timing[b] * 1e3:.1f} meshes/s banded")
    for b in SERVE_BATCHES:
        for route, bd, wall in (("banded", bundle, timing[b]),
                                ("take", bundle_take, timing_take[b])):
            log(f"[profile] serving, {route} bundle")
            profile_forward(bd, batches[b], wall)
    return launches, launches_take, timing, timing_take


def profile_forward(bundle, verts, wall_ms: float, reps: int = 5) -> None:
    """Device time per forward by kernel name (torch.profiler), and the
    share of the unprofiled wall time with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bundle.forward(verts)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    b = verts.shape[0]
    if not by_name:
        log(f"[profile] B={b}: the profiler saw no device kernels; device "
            "time not measured")
        return
    busy = sum(by_name.values())
    log(f"[profile] B={b}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"per forward, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:8.4f} ms  {name[:90]}")


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
    unfused route (`unfused_ms`, the yardstick: torch matmuls around the
    [B, V1, S*C] buffers and csr_reduce); each half alone, fused and
    unfused; and the plain conv's autograd (`plain_ms`).  `profile` adds
    the dispatched float32 backward's device time by kernel name."""
    from semantichuman_torch.ops import spiral_conv as SC

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


def phase_csr_reduce(model):
    """csr_reduce at the dx shapes of the step's convs ([384, V1*S, C_in]
    f32) against its plain version and `index_add_` (the library call of
    the same function, timed only): max |err| <= 1e-4 of the largest
    entry, f32 sums in another order (the dummy row at level 0 sums 34,041
    rows)."""
    from semantichuman_torch.ops.csr_reduce import (csr_reduce,
                                                    csr_reduce_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = []
    for label, v1, s, cin, _cout, _act, spiral, csr in conv_layers(model):
        g = torch.randn((TRUNK_B, v1 * s, cin), generator=gen, device=DEVICE)
        got = csr_reduce(g, csr)
        ref = csr_reduce_plain(g, csr)
        flat = spiral.reshape(-1).long()

        def library():
            return torch.zeros((TRUNK_B, v1, cin), device=DEVICE) \
                .index_add_(1, flat, g)

        lib = library()
        sync()
        err = float((got - ref).abs().max())
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m: f"csr_reduce {label}: {m}")
        torch.testing.assert_close(lib, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
        k_ms = time_ms(lambda: csr_reduce(g, csr), iters=10, warmup=2)
        p_ms = time_ms(lambda: csr_reduce_plain(g, csr), iters=5, warmup=1)
        l_ms = time_ms(library, iters=10, warmup=2)
        nbytes = (g.numel() * 4 + TRUNK_B * v1 * cin * 4
                  + (v1 + 1 + 2 * v1 * s) * 4)
        b_ms = nbytes / PEAK_BYTES * 1e3
        rows.append({"layer": label, "c": cin, "max_abs_err": err,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": b_ms, "bound_by": "bytes"})
        log(f"[csr] {label:18s} [{TRUNK_B}, {v1 * s}, {cin}] err={err:.3e} "
            f"kernel={k_ms:.4f} ms plain={p_ms:.4f} ms index_add_="
            f"{l_ms:.4f} ms bound={b_ms:.4f} ms (bytes)")
        del g, got, ref, lib
    return rows


def part_dist_case(human, w_mode):
    """The step's interp-branch inputs of the part_dist kernels at B = 128:
    one bucket of 17 parts (n_pad 408), as the loss stacks them."""
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
    tx = human.sample_meshes(TRAIN_B, seed=3).astype(np.float32)
    rec = (tx + rng.normal(0, 0.01, tx.shape)).astype(np.float32)
    tx_t = torch.from_numpy(tx).to(DEVICE)
    rec_t = torch.from_numpy(rec).to(DEVICE)
    bones = part_bones(regress_kps(tx_t, tables.j_regressor))
    pc = bk["part_ids"].shape[0]
    a_full = EditSampler(seed=0).sample_interp(200, TRAIN_B)["a_full"]
    a = torch.from_numpy(a_full).to(DEVICE).index_select(
        1, bk["part_ids"]).t().contiguous()
    bone = bones.index_select(1, bk["part_ids"]).transpose(0, 1) \
        .reshape(pc * TRAIN_B, 3).contiguous()
    return (_stack_parts(tx_t, bk["idx_flat"], pc, 408),
            _stack_parts(rec_t, bk["idx_flat"], pc, 408), bone, a,
            bk["n_real"], bk["allone"])


def part_dist_bound(args, counts, mode):
    """(ms for the f32 operations, ms for the special-function operations)
    of one call on this run's data: every ordered pair j != k evaluates
    its GT distance and weight (~20 f32 operations; a square root, a
    divide and acos on the SFU, only the square root on a uniform-weight
    part); each pair in the mask (the kernel's count) adds the
    reconstruction distance, q and the sums (~16 f32 operations; a square
    root and a divide), and with the gradient ~10 more and two divides."""
    _vp, _rp, _bone, _a, n_real, allone = args
    batch = _vp.shape[0] // n_real.shape[0]
    n = n_real.double()
    pairs = float((n * (n - 1)).sum()) * batch
    uniform = float((n * (n - 1) * allone.double()).sum()) * batch
    masked = float(counts.sum())
    grad = mode != "fwd"
    flops = pairs * 20 + masked * (16 + (10 if grad else 0))
    sfu = 3 * (pairs - uniform) + uniform + masked * (2 + (2 if grad else 0))
    return flops / PEAK_FLOPS[torch.float32] * 1e3, sfu / PEAK_SFU * 1e3


def phase_part_dist(human):
    """The three part_dist kernels against their plain versions at 17
    parts x B = 128 (w_mode threshold and sin, relat on).  Both versions
    round every per-pair value alike (the kernel's note), so they put
    every pair on the same side of the mask, the threshold and q = 0:
    counts equal exactly, term sums to rtol 1e-5 (f32 sums of ~165k pair
    terms per tile in another order), g0 and drp to 1e-4 of the largest
    entry (rows of ~400 terms of either sign, summed in another order)."""
    from semantichuman_torch.ops.part_dist import (part_dist_call,
                                                   part_dist_plain)

    rows = []
    for w_mode in ("threshold", "sin"):
        args = part_dist_case(human, w_mode)
        consts = (w_mode, 0.8, True)
        ct = torch.linspace(0.5, 1.5, args[0].shape[0], device=DEVICE)
        for mode in ("fwd", "fwd_grad", "bwd"):
            kw = {"ct": ct} if mode == "bwd" else {}
            got = part_dist_call(mode, *args, *consts, **kw)
            ref = part_dist_plain(*args, *consts, mode=mode, **kw)
            sync()
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
                    msg=lambda m: f"part_dist {mode} {w_mode} sums: {m}")
                require(torch.equal(sums_got[:, 1], sums_ref[:, 1]),
                        f"part_dist {mode} {w_mode}: counts differ")
            if grad_got is not None:
                err["grad"] = rel_err(grad_got, grad_ref)
                err["max_abs"] = max(err["max_abs"], float(
                    (grad_got - grad_ref).abs().max()))
                torch.testing.assert_close(
                    grad_got, grad_ref, rtol=0,
                    atol=1e-4 * float(grad_ref.abs().max()),
                    msg=lambda m: f"part_dist {mode} {w_mode} grad: {m}")
            if sums_ref is None:
                sums_ref = part_dist_plain(*args, *consts, mode="fwd")
            counts = sums_ref[:, 1]
            k_ms = time_ms(lambda: part_dist_call(mode, *args, *consts, **kw),
                           iters=10, warmup=2)
            p_ms = time_ms(lambda: part_dist_plain(*args, *consts,
                                                   mode=mode, **kw),
                           iters=3, warmup=1)
            ops_ms, sfu_ms = part_dist_bound(args, counts, mode)
            row = {"w_mode": w_mode, "mode": mode, "err": err, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": max(ops_ms, sfu_ms),
                   "bound_by": "operations", "flop_ms": ops_ms,
                   "sfu_ms": sfu_ms,
                   "masked_pairs": float(counts.sum())}
            rows.append(row)
            log(f"[part_dist] {w_mode:9s} {mode:8s} err={err} "
                f"kernel={k_ms:.4f} ms plain={p_ms:.3f} ms "
                f"bound={row['bound_ms']:.4f} ms (f32 {ops_ms:.4f}, "
                f"sfu {sfu_ms:.4f}) masked pairs {row['masked_pairs']:.0f}")
            del got, ref
    return rows


def host_batch(human, tables, seed: int) -> dict:
    """One segment of B = 128 on the device: verts with the dummy row,
    measures, and the staged GT edge lengths and part volumes."""
    from semantichuman_torch.ops.distance import (face_edge_lengths,
                                                  signed_part_volumes)

    verts = human.sample_meshes(TRAIN_B, seed=seed).astype(np.float32)
    v = torch.from_numpy(np.concatenate(
        [verts, np.zeros((TRAIN_B, 1, 3), np.float32)], axis=1)).to(DEVICE)
    with torch.no_grad():
        edges = face_edge_lengths(v[:, :-1], tables.faces)
        vols = signed_part_volumes(v[:, :-1], tables.faces,
                                   tables.face_part_mask)
    return {"verts": v,
            "measure": torch.from_numpy(human.measures(verts).astype(
                np.float32)).to(DEVICE),
            "gt_face_edges": edges, "gt_part_vols": vols}


def reset_counts():
    from semantichuman_torch.ops.banded_gather import (banded_gather_bwd,
                                                       banded_gather_fwd)
    from semantichuman_torch.ops.csr_reduce import csr_reduce
    from semantichuman_torch.ops.part_dist import part_dist_sums
    from semantichuman_torch.ops.row_gather import row_gather
    from semantichuman_torch.ops.spiral_conv import (spiral_conv,
                                                     spiral_conv_bwd_dw,
                                                     spiral_conv_bwd_dx,
                                                     spiral_conv_fwd_v1)

    for fn in (spiral_conv, spiral_conv_fwd_v1, spiral_conv_bwd_dw,
               spiral_conv_bwd_dx, csr_reduce, banded_gather_fwd, banded_gather_bwd, row_gather):
        fn.launches = 0
    for mode in part_dist_sums.launches:
        part_dist_sums.launches[mode] = 0


def read_counts() -> dict:
    from semantichuman_torch.ops.banded_gather import (banded_gather_bwd,
                                                       banded_gather_fwd)
    from semantichuman_torch.ops.csr_reduce import csr_reduce
    from semantichuman_torch.ops.part_dist import part_dist_sums
    from semantichuman_torch.ops.row_gather import row_gather
    from semantichuman_torch.ops.spiral_conv import (spiral_conv,
                                                     spiral_conv_bwd_dw,
                                                     spiral_conv_bwd_dx,
                                                     spiral_conv_fwd_v1)

    return {"spiral_conv_fwd": spiral_conv.launches,
            "spiral_conv_fwd_v1": spiral_conv_fwd_v1.launches,
            "spiral_conv_bwd_dw": spiral_conv_bwd_dw.launches,
            "spiral_conv_bwd_dx": spiral_conv_bwd_dx.launches,
            "csr_reduce": csr_reduce.launches,
            **{f"part_dist_{m}": n for m, n in part_dist_sums.launches.items()},
            "banded_gather_fwd": banded_gather_fwd.launches,
            "banded_gather_bwd": banded_gather_bwd.launches,
            "row_gather": row_gather.launches}


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


def profile_steps(run, wall_ms: float, reps: int = 3) -> dict:
    """Device time per step by kernel name (torch.profiler), and the share
    of the unprofiled step time with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return {}
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
    from semantichuman_torch.ops import spiral_conv as SC

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
    """The paper recipe (Config() defaults) on synthetic SMPL-scale data."""
    from semantichuman_torch.config import Config
    return Config.from_dict({
        "model": {"banded_conv": banded},
        "data": {"synthetic": True, "synthetic_train": 64,
                 "synthetic_test": 16},
        "train": {"n_epochs": 3, "ck_frequency": 2, "save_recons": False,
                  **train}})


def trainer_workdir(root: Path, name: str) -> str:
    """A workdir holding the compiled hierarchy where the Trainer reads it
    (the port has no topology compiler)."""
    d = root / name
    d.mkdir()
    for suffix in ("", ".meta"):
        shutil.copy(str(TOPOLOGY) + suffix,
                    d / f"topology_2222.npz{suffix}")
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
def deterministic_torch():
    """torch's deterministic algorithms on for the block: `index_add_` and
    the scatters of the pool, unpool and head backward then add in a fixed
    order instead of with atomics (the port's own kernels always do), so
    two runs of the Trainer give the same bits.  Ops without a
    deterministic form only warn."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def resumed_epoch(root: Path, name: str, banded: bool, ckpt: str):
    """A Trainer resumed from the epoch-2 checkpoint, its epoch 3 run with
    timed steps: (trainer, step times in ms, epoch-3 train loss)."""
    from semantichuman_torch.train.loop import Trainer

    tr = Trainer(trainer_cfg(banded, resume=ckpt),
                 trainer_workdir(root, name), device=DEVICE)
    require(tr.start_epoch == 3, f"resumed at {tr.start_epoch}")
    times = timed_steps(tr)
    tr.fit()
    return tr, times, tr.history[0]["train"]


def phase_trainer():
    """The Trainer's main path (fit with counts), resume, evaluate, and
    the banded and take routes timed from the same checkpoint.

    The counted fit() and the four timed resumed runs use torch's default
    algorithms, as a user's training does.  There the order of the
    `index_add_` sums (atomics) changes from run to run, Adam amplifies
    that through the 16 steps of an epoch, and a resumed epoch misses the
    uninterrupted one's loss by up to 4.8e-3 in a third of all runs (19
    runs of this phase on one H100), so those runs are held to rtol 1e-2,
    twice the largest miss seen.  The exact gate runs under torch's
    deterministic algorithms, where the resumed banded epoch repeats the
    uninterrupted one bit for bit: a second fit() and two runs resumed
    from its epoch-2 checkpoint (rtol 1e-4 banded, 1e-3 take)."""
    from semantichuman_torch.train.loop import Trainer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        tr = Trainer(trainer_cfg(), trainer_workdir(root, "fit"),
                     device=DEVICE)
        out["init_s"] = time.perf_counter() - t0
        t = tr.model.tables
        require([b is not None for b in t.bands] == [True, True] + [False] * 3
                and all(b is not None for b in t.unpool_bands),
                "expected conv bands at levels 0-1 and four unpool bands")
        require(tr.device_data is not None, "data not staged on the device")
        n_steps = len(tr.train_loader) * 3
        n_val = len(tr.val_loader) * 3
        require(n_val == 3, "expected one validation batch per epoch")

        # --- the main path: counts from 0, read right after -------------
        sync()
        reset_counts()
        t0 = time.perf_counter()
        tr.fit()
        sync()
        out["fit_s"] = time.perf_counter() - t0
        counts = read_counts()
        # a validation batch of 16 is one forward on the B <= 16 routes
        val = SERVE_LAUNCHES["small"]
        want = {k: TRAIN_LAUNCHES.get(k, 0) * n_steps
                + val.get(k, 0) * n_val for k in KERNEL_COUNTS}
        log(f"[trainer] fit: {n_steps} steps, {n_val} val batches, "
            f"launches {counts}")
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
        del tr

        # --- timed from the checkpoint: banded, take, take, banded ----------
        runs = {"banded": {"run_ms": [], "step_ms": [], "epoch_s": [],
                           "epoch3_loss": []},
                "take": {"run_ms": [], "step_ms": [], "epoch_s": [],
                         "epoch3_loss": []}}
        for i, banded in enumerate((True, False, False, True)):
            name = "banded" if banded else "take"
            r = runs[name]
            tr, times, loss3 = resumed_epoch(root, f"resume{i}", banded, ckpt)
            r["run_ms"].append(float(np.median(times)))
            r["step_ms"] += times
            r["epoch_s"].append(tr.history[0]["sec"])
            r["epoch3_loss"].append(loss3)
            log(f"[trainer] resumed {name}: epoch 3 loss {loss3:.7f} "
                f"(uninterrupted {losses[2]:.7f}), {r['run_ms'][-1]:.3f} "
                f"ms/step median of {len(times)}, epoch "
                f"{tr.history[0]['sec']:.3f} s with val")
            np.testing.assert_allclose(loss3, losses[2], rtol=1e-2)
            if i < 2:
                r.update(profile_epoch(tr))
            if i == 0:
                _p, _z, _zk, _tx, l1, mm = tr.evaluate()
                require(np.isfinite(l1) and np.isfinite(mm),
                        f"evaluate: l1 {l1} mm {mm}")
                log(f"[trainer] evaluate: l1 {l1:.6f}, {mm:.3f} mm")
                out.update(eval_l1=l1, eval_mm=mm)
            del tr
        for name, r in runs.items():
            ms = float(np.median(r["step_ms"]))
            r.update(ms_per_step=ms, meshes_per_s=TRAINER_B / ms * 1e3)
            if "device_busy_ms" in r:
                r["idle_share"] = max(0.0, 1 - r["device_busy_ms"] / ms)
            log(f"[trainer] {name}: {ms:.3f} ms/step (median of "
                f"{len(r['step_ms'])} steps; runs {r['run_ms']}), "
                f"{TRAINER_B / ms * 1e3:.1f} meshes/s, idle share "
                f"{r.get('idle_share', 'not measured')}")
        out["routes"] = runs

        # --- the exact gate, under deterministic algorithms: a fit, then
        # its epoch 3 repeated from its epoch-2 checkpoint ---------------------
        with deterministic_torch():
            tr = Trainer(trainer_cfg(), trainer_workdir(root, "held_fit"),
                         device=DEVICE)
            tr.fit()
            held = [h["train"] for h in tr.history]
            held_ckpt = os.path.join(tr.workdir, "checkpoints")
            out.update(deterministic_epoch_losses=held,
                       deterministic_epoch_s=[h["sec"] for h in tr.history])
            del tr
            for banded in (True, False):
                name = "banded" if banded else "take"
                tr, _times, loss3 = resumed_epoch(root, f"held_{name}",
                                                  banded, held_ckpt)
                log(f"[trainer] resumed {name}, deterministic: epoch 3 loss "
                    f"{loss3:.9f} (uninterrupted {held[2]:.9f})")
                # take: the two routes gather the same values; the
                # gradients' f32 sums run in another order through 16
                # Adam steps
                np.testing.assert_allclose(loss3, held[2],
                                           rtol=1e-4 if banded else 1e-3)
                out[f"resumed_{name}_loss"] = loss3
                del tr
    return out


def profile_epoch(tr) -> dict:
    """Device time per step by kernel name over one more epoch of steps
    (torch.profiler); the caller sets it against the unprofiled median
    step time for the idle share."""
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
    return {"device_busy_ms": busy,
            "top_kernels": [[nm[:90], t] for nm, t in top]}


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
                      help="phase 1 and the conv backward's phase alone")
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")

    card = phase_build()

    human = SyntheticHuman()
    hier = MeshHierarchy.load(str(TOPOLOGY))
    model = build_model(ModelConfig(), hier, human.part_dict, device="cuda")
    model_take = build_model(ModelConfig(banded_conv=False), hier,
                             human.part_dict, device="cuda")
    params = model.init(0)
    require(len(conv_layers(model)) == 9, "expected 9 convs per forward")

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

    rows, max_err = phase_kernels(model)
    serve, serve_take, timing, timing_take = phase_serving(
        model, model_take, params, human)
    del model_take

    fwd = {b: fwd_sums(rows, b) for b in FWD_TIMED}
    for b, f in fwd.items():
        log(f"[kernel] nine float32 convs at B={b}: kernel {f['ms']:.3f} ms "
            f"(runs {np.round(f['ms_runs'], 3).tolist()}), v1 "
            f"{f['v1_ms']:.3f} ({np.round(f['v1_ms_runs'], 3).tolist()}), "
            f"plain {f['plain_ms']:.3f}, gemm alone {f['gemm_ms']:.3f}, bound "
            f"{f['bound_ms']:.3f} ms ({100 * f['bound_ms'] / f['ms']:.1f} % "
            f"of it); bf16 kernel {f['bf16_ms']:.3f} v1 {f['bf16_v1_ms']:.3f}")
        require(f["ms"] < f["v1_ms"], f"B={b}: the kernel's nine convs "
                f"({f['ms']:.3f} ms) not faster than v1 ({f['v1_ms']:.3f})")
    kernel_ms = fwd[BATCH]["ms"]
    log(f"[serve] B={BATCH}: spiral_conv kernels {kernel_ms:.3f} ms of "
        f"{timing[BATCH]:.3f} ms per forward "
        f"({100 * kernel_ms / timing[BATCH]:.1f} %)")

    conv_bwd = phase_conv_backward(model)
    csr_rows = phase_csr_reduce(model)
    pd_rows = phase_part_dist(human)
    banded_rows = phase_banded_kernels(model)
    conv_bwd_trainer = phase_conv_backward_trainer(model)
    torch.cuda.empty_cache()
    train = phase_train(human, hier)
    step_counts = train.pop("counts")
    torch.cuda.empty_cache()
    trainer = phase_trainer()
    trainer_counts = trainer.pop("counts")

    paths = {"serve": serve, "serve_take": serve_take,
             "train_step": step_counts, "trainer": trainer_counts}

    def launches(name):
        by_path = {p: c[name] for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    # the step's dx calls: every conv but the first, whose input is data
    step_csr = csr_rows[1:]
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
        # the yardsticks: the port's first kernel (csrc/spiral_conv.cu), and
        # cuBLAS's SGEMM alone on the pre-gathered buffer
        "v1_ms": f64["v1_ms"],
        "gemm_ms": f64["gemm_ms"],
        "v1_launches_by_path": launches("spiral_conv_fwd_v1")[
            "launches_by_path"],
        "b384": f384,
        "b64": f64,
        "forward_ms": {"banded": timing, "take": timing_take},
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
            # one call at 17 parts x B = 128, w_mode threshold
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "sin": pd[("sin", mode)],
        })
    banded_pallas = "semantichuman_tpu/ops/pallas/banded_gather_pallas.py"
    for row, name, key, source, replaces in (
            (5, "banded_gather_fwd", "fwd", "banded_gather.cu",
             f"{banded_pallas}:187"),
            (6, "banded_gather_bwd", "bwd", "banded_gather.cu",
             f"{banded_pallas}:237"),
            (7, "row_gather", "row_gather", "row_gather.cu",
             "benchmarks/pallas_dma_gather_probe.py:83")):
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
    kernels.append({
        "name": "csr_reduce",
        "row": 8,
        "route": "cuda",
        "source": "semantichuman_torch/csrc/csr_reduce.cu",
        "replaces": "benchmarks/pallas_dma_gather_probe.py:157",
        **launches("csr_reduce"),
        "max_abs_err": max(r["max_abs_err"] for r in csr_rows),
        # the eight dx reductions of one training step (B = 384), summed
        "ms": sum(r["ms"] for r in step_csr),
        "plain_ms": sum(r["plain_ms"] for r in step_csr),
        "bound_ms": sum(r["bound_ms"] for r in step_csr),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in step_csr),
        "layers": csr_rows,
        "conv_backward_f32_sum": bwd_sum,
        "conv_backward": conv_bwd,
    })
    # the two fused backward kernels are asked for where every conv takes
    # the take route, the B = 128 step; at trunk batch 12 the Trainer
    # reaches them at its four coarse convs only
    for k in KERNEL_COUNTS:
        if k == "spiral_conv_fwd_v1":
            # the yardstick: no main path reaches it
            require(all(c[k] == 0 for c in paths.values()),
                    f"{k} launched on a main path: {launches(k)}")
            continue
        path = ("train_step" if k.startswith("spiral_conv_bwd")
                else "trainer")
        require(paths[path][k] > 0 or k in ("part_dist_fwd",
                                            "part_dist_bwd"),
                f"{k}: no launch on the {path} path")
    log(json.dumps({"trainer": trainer}))
    log(json.dumps({"train": train}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
