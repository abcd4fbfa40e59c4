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
# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


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
    """(label, V1, S, C_in, C_out, activation, spiral table) of every conv
    of the model's forward, in order."""
    t = model.tables
    out = []
    for side, plan in (("enc", model.enc_plan), ("dec", model.dec_plan)):
        for lvl, cin, cout, act in plan:
            out.append((f"{side} L{lvl} {cin}->{cout}", t.sizes[lvl] + 1,
                        t.spiral_sizes[lvl], cin, cout, act, t.spirals[lvl]))
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
    for label, v1, s, cin, cout, act, spiral in conv_layers(model):
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
    log(card)
    log(json.dumps({"kernels": [{
        "name": "spiral_conv_fwd",
        "route": "cuda",
        "source": "semantichuman_torch/csrc/spiral_conv.cu",
        "replaces": "semantichuman_tpu/ops/pallas/spiral_conv_pallas.py:78",
        "launches": launches,
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
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
