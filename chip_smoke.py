#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (semantichuman_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc.  Phases, each of which fails the
run:

1. build: compile every CUDA kernel of the port from `semantichuman_torch/
   csrc/` (one nvcc per source, in parallel) and print the card.
2. kernels: at each of the nine full-width conv shapes of the serving path
   (B=64, the bundled 6892-vertex topology's spiral tables), in float32 and
   bfloat16 inputs, hold the spiral-conv kernel against its plain PyTorch
   version (rtol 1e-4, atol 1e-5: the only difference is the order of f32
   sums over K <= 1920), require an exactly zero dummy row, and time both.
3. serving: build the full-width PartAE from the default ModelConfig (seed
   0), export a bundle, load it on the card, answer forward at B = 1, 16, 64
   and encode -> decode at B = 64 with the launch count set to 0 just
   before; require 9 kernel launches per forward and per encode+decode,
   finite outputs, exactly zero dummy rows, and agreement (atol 1e-4) with
   the same model run through the plain conv on the card.  Then time it.

4. training kernels, at the training step's full-width shapes (trunk
   batch 384 = three segments of B = 128): the spiral conv's backward
   (dx through the csr_reduce kernel, dW, db) against autograd of the
   plain conv at the nine conv shapes in float32 and bfloat16; csr_reduce
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
   finite losses and, per step, 9 conv forward, 8 csr_reduce and 2
   part_dist fwd_grad launches (0 fwd, 0 bwd).  Then ms/step, meshes/s
   (128 per step, as bench.py counts), the device idle share, the top
   kernels (torch.profiler) and one bf16-trunk step (finite loss).

The last two lines are a JSON object with each kernel's launches, error and
times, and `{"ok": true, "device": {...}}`.  Without a card it exits 1
before printing any result.
"""

from __future__ import annotations

import copy
import json
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
TRAIN_B = 128                  # per segment, as bench.py
TRUNK_B = 3 * TRAIN_B          # the three segments share the trunk
TRAIN_STEPS = 10
DEVICE = "cuda"
# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# special-function unit results (square root, reciprocal, the core of
# acos) per second: 16 per clock per SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x 1.98 GHz
PEAK_SFU = 16 * 132 * 1.98e9


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
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {line.strip()}")
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


def phase_kernels(model):
    from semantichuman_torch.ops.spiral_conv import (spiral_conv,
                                                     spiral_conv_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0
    for label, v1, s, cin, cout, act, spiral, _ in conv_layers(model):
        x = torch.randn((BATCH, v1, cin), generator=gen, device="cuda")
        x[:, -1] = 0.0
        w = torch.randn((s * cin, cout), generator=gen, device="cuda")
        w /= (s * cin) ** 0.5
        bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            cd = None if dtype == torch.float32 else dtype
            got = spiral_conv(x, spiral, w, bias, act, compute_dtype=cd)
            ref = spiral_conv_plain(x, spiral, w, bias, act, compute_dtype=cd)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"{label} {dtype}: {m}")
            require(torch.count_nonzero(got[:, -1]) == 0,
                    f"{label} {dtype}: dummy row not zero")
            # the timed calls take inputs already in the compute type, as
            # the kernel sees them
            xc, wc = x.to(dtype), w.to(dtype)
            k_ms = time_ms(lambda: spiral_conv(xc, spiral, wc, bias, act))
            p_ms = time_ms(lambda: spiral_conv_plain(xc, spiral, wc, bias,
                                                     act))
            ops_ms, bytes_ms = bound(BATCH, v1, s, cin, cout, dtype)
            b_ms = max(ops_ms, bytes_ms)
            b_by = "operations" if ops_ms >= bytes_ms else "bytes"
            max_err = max(max_err, err)
            rows.append({"layer": label, "dtype": str(dtype).split(".")[-1],
                         "v1": v1, "s": s, "c_in": cin, "c_out": cout,
                         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "ops_ms": ops_ms, "bytes_ms": bytes_ms})
            log(f"[kernel] {label:18s} {rows[-1]['dtype']:8s} err={err:.3e} "
                f"kernel={k_ms:.4f} ms plain={p_ms:.4f} ms "
                f"bound={b_ms:.4f} ms ({b_by})")
    return rows, max_err


def phase_serving(model, params, human):
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.ops.spiral_conv import (spiral_conv,
                                                     spiral_conv_plain)
    from semantichuman_torch.serving import ServingBundle, export_inference

    meshes = human.sample_meshes(max(SERVE_BATCHES), seed=0)
    verts_all = np.concatenate(
        [meshes, np.zeros((len(meshes), 1, 3))], axis=1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        manifest = export_inference(model, params, human.J_regressor, tmp)
        bundle = ServingBundle(tmp, device="cuda")
    require(manifest["n_vertices"] == len(human.template_verts),
            "manifest vertex count")
    v1 = manifest["n_vertices"] + 1
    batches = {b: torch.from_numpy(verts_all[:b]).cuda()
               for b in SERVE_BATCHES}
    bundle.forward(batches[1])                       # warm-up, not counted
    torch.cuda.synchronize()

    # --- the main path: counts from 0, read right after -------------------
    spiral_conv.launches = 0
    outs = {}
    for b in SERVE_BATCHES:
        before = spiral_conv.launches
        outs[b] = bundle.forward(batches[b])
        torch.cuda.synchronize()
        require(spiral_conv.launches - before == 9,
                f"forward B={b}: {spiral_conv.launches - before} launches")
    before = spiral_conv.launches
    z, z_kps, _dummy = bundle.encode(batches[BATCH])
    dec = bundle.decode(z, z_kps)
    torch.cuda.synchronize()
    require(spiral_conv.launches - before == 9,
            f"encode+decode: {spiral_conv.launches - before} launches")
    launches = spiral_conv.launches
    log(f"[serve] main path: {launches} spiral_conv launches")

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

    # --- timing (after the counted run) -----------------------------------
    timing = {}
    for b in SERVE_BATCHES:
        for _ in range(3):
            bundle.forward(batches[b])
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            bundle.forward(batches[b])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        timing[b] = ms
        log(f"[serve] forward B={b}: {ms:.3f} ms, "
            f"{b / ms * 1e3:.1f} meshes/s")
    for b in SERVE_BATCHES:
        profile_forward(bundle, batches[b], timing[b])
    return launches, timing


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


def phase_conv_backward(model):
    """The spiral conv's backward (SpiralConvFn: csr_reduce kernel for dx)
    against autograd of the plain conv, at the nine conv shapes at trunk
    batch 384.  float32: max |err| <= 1e-4 of the largest entry (the same
    products summed in another order; dW sums 2.6M terms at level 0, the
    dummy row's dx 34,041).  bfloat16: the reference is the plain conv in
    f32 on the bf16-rounded x and W, its gradients rounded to bf16 like
    the kernel route's, so the two differ by that f32 order (atol 1e-4 of
    the largest entry) and one bf16 rounding (rtol 2^-7)."""
    from semantichuman_torch.ops.spiral_conv import (spiral_conv,
                                                     spiral_conv_plain)

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
        for dtype in (torch.float32, torch.bfloat16):
            cd = None if dtype == torch.float32 else dtype
            leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
            y = spiral_conv(*leaves[:1], spiral, *leaves[1:], act,
                            compute_dtype=cd, csr=csr)
            got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
            if cd is None:
                ref_in = [t.detach().requires_grad_(True)
                          for t in (x, w, bias)]
            else:
                ref_in = [x.to(cd).float().requires_grad_(True),
                          w.to(cd).float().requires_grad_(True),
                          bias.detach().requires_grad_(True)]
            y_ref = spiral_conv_plain(ref_in[0], spiral, *ref_in[1:], act)
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
            k_ms = time_ms(lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), iters=5, warmup=1)
            plain_in = [t.detach().requires_grad_(True) for t in (x, w, bias)]
            y_pl = spiral_conv_plain(plain_in[0], spiral, *plain_in[1:], act,
                                     compute_dtype=cd)
            p_ms = time_ms(lambda: torch.autograd.grad(
                y_pl, plain_in, dy, retain_graph=True), iters=5, warmup=1)
            ops_ms, bytes_ms = conv_bwd_bound(TRUNK_B, v1, s, cin, cout,
                                              dtype)
            row = {"layer": label, "dtype": str(dtype).split(".")[-1],
                   "rel_err": errs, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes"}
            rows.append(row)
            log(f"[conv-bwd] {label:18s} {row['dtype']:8s} rel err dx "
                f"{errs['dx']:.2e} dw {errs['dw']:.2e} db {errs['db']:.2e} "
                f"kernel route={k_ms:.3f} ms plain={p_ms:.3f} ms "
                f"bound={row['bound_ms']:.3f} ms ({row['bound_by']})")
            del y, y_pl, y_ref, got, ref
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
    from semantichuman_torch.ops.csr_reduce import csr_reduce
    from semantichuman_torch.ops.part_dist import part_dist_sums
    from semantichuman_torch.ops.spiral_conv import spiral_conv

    spiral_conv.launches = 0
    csr_reduce.launches = 0
    for mode in part_dist_sums.launches:
        part_dist_sums.launches[mode] = 0


def read_counts() -> dict:
    from semantichuman_torch.ops.csr_reduce import csr_reduce
    from semantichuman_torch.ops.part_dist import part_dist_sums
    from semantichuman_torch.ops.spiral_conv import spiral_conv

    return {"spiral_conv_fwd": spiral_conv.launches,
            "csr_reduce": csr_reduce.launches,
            **{f"part_dist_{m}": n for m, n in part_dist_sums.launches.items()}}


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
    got = value_and_grad(make_loss_fn(model, tables, flags, "ori"),
                         params, *segs, spec)
    sync()
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
    per_step = {"spiral_conv_fwd": 9, "csr_reduce": 8,
                "part_dist_fwd_grad": 2, "part_dist_fwd": 0,
                "part_dist_bwd": 0}
    for name, n in per_step.items():
        require(counts[name] == n * TRAIN_STEPS,
                f"{name}: {counts[name]} launches in {TRAIN_STEPS} steps")
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
            "bf16_loss": loss16, **prof}


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
    return {"device_busy_ms": busy, "idle_share": idle,
            "top_kernels": [[n[:90], t] for n, t in top]}


def main() -> int:
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
    params = model.init(0)
    require(len(conv_layers(model)) == 9, "expected 9 convs per forward")

    rows, max_err = phase_kernels(model)
    launches, timing = phase_serving(model, params, human)

    f32 = [r for r in rows if r["dtype"] == "float32"]
    kernel_ms = sum(r["ms"] for r in f32)
    log(f"[serve] B={BATCH}: spiral_conv kernels {kernel_ms:.3f} ms of "
        f"{timing[BATCH]:.3f} ms per forward "
        f"({100 * kernel_ms / timing[BATCH]:.1f} %)")

    conv_bwd = phase_conv_backward(model)
    csr_rows = phase_csr_reduce(model)
    pd_rows = phase_part_dist(human)
    torch.cuda.empty_cache()
    train = phase_train(human, hier)
    counts = train.pop("counts")

    # the step's dx calls: every conv but the first, whose input is data
    step_csr = csr_rows[1:]
    bwd32 = [r for r in conv_bwd if r["dtype"] == "float32"]
    bwd_sum = {k: sum(r[k] for r in bwd32)
               for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[conv-bwd] nine float32 convs at batch {TRUNK_B}: kernel route "
        f"{bwd_sum['ms']:.3f} ms, plain {bwd_sum['plain_ms']:.3f} ms, bound "
        f"{bwd_sum['bound_ms']:.3f} ms")
    pd = {(r["w_mode"], r["mode"]): r for r in pd_rows}
    pallas = "semantichuman_tpu/ops/pallas/part_dist_pallas.py"
    kernels = [{
        "name": "spiral_conv_fwd",
        "route": "cuda",
        "source": "semantichuman_torch/csrc/spiral_conv.cu",
        "replaces": "semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:78",
        "launches": launches + counts["spiral_conv_fwd"],
        "launches_by_path": {"serve": launches,
                             "train": counts["spiral_conv_fwd"]},
        "max_abs_err": max_err,
        # the nine float32 convs of one B=64 forward, summed
        "ms": kernel_ms,
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "bound_ms": sum(r["bound_ms"] for r in f32),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in f32)
                     >= sum(r["bytes_ms"] for r in f32) else "bytes"),
        "library_ms": None,
        "forward_ms": timing,
        "layers": rows,
    }, {
        "name": "csr_reduce",
        "route": "cuda",
        "source": "semantichuman_torch/csrc/csr_reduce.cu",
        "replaces": "benchmarks/pallas_dma_gather_probe.py:157",
        "launches": counts["csr_reduce"],
        "max_abs_err": max(r["max_abs_err"] for r in csr_rows),
        # the eight dx reductions of one training step, summed
        "ms": sum(r["ms"] for r in step_csr),
        "plain_ms": sum(r["plain_ms"] for r in step_csr),
        "bound_ms": sum(r["bound_ms"] for r in step_csr),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in step_csr),
        "layers": csr_rows,
        "conv_backward_f32_sum": bwd_sum,
        "conv_backward": conv_bwd,
    }]
    for mode, line in (("fwd", 330), ("fwd_grad", 356), ("bwd", 413)):
        r = pd[("threshold", mode)]
        kernels.append({
            "name": f"part_dist_{mode}",
            "route": "cuda",
            "source": "semantichuman_torch/csrc/part_dist.cu",
            "replaces": f"{pallas}:{line}",
            "launches": counts[f"part_dist_{mode}"],
            "max_abs_err": r["err"]["max_abs"],
            # one call at 17 parts x B = 128, w_mode threshold
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "sin": pd[("sin", mode)],
        })
    log(json.dumps({"train": train}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
