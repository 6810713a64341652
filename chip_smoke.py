#!/usr/bin/env python3
"""Smoke run of the gstbad_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result
line):

1. Require a CUDA card; print its name and power limit (nvidia-smi).
2. Build the hand-written kernels from gstbad_tpu_torch/csrc (nvcc, into
   gstbad_tpu_torch/_build/) and print the build time and ptxas report.
3. Hold each kernel bit-exactly against its plain PyTorch version on the
   card: at the main path's shapes ([64, 1080, 1920], materialized and
   broadcast source, both erode values) and at a ragged shape.
4. Drive the port's main path through parse_launch on the card: the 1080p
   headline graph on bars (broadcast source) and on ball (moving source),
   and the headline without zebrastripe (the nine-element prefix, which
   takes the whole-word lookup).  Every launch counter is zeroed just
   before and read just after; each kernel must have launched, and the
   frames must equal the same graphs run by the port on the CPU.
5. Time: the median of 5 runs of 1080p frames/s per graph (CUDA events
   around 10 steps of a 64-frame window, data kept on the card), a
   torch.profiler breakdown of each graph's step (device busy time, device
   ops per step, idle share), and each kernel beside its plain version at
   the main path's shapes.
6. Print the kernel table as one JSON line, then the result line
   {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import importlib.metadata
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
WINDOW = 64
HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls
    after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item())


def profile_step(p, step_ms: float, key: str, steps: int = 3) -> None:
    """Device time per step of pipeline `p` from a torch.profiler trace of
    `steps` steps: busy ms, device ops launched, the idle share against
    the untraced step time `step_ms`, and the kernels that take the most
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = p.compile(WINDOW)
    params, states = p.params(), p.init_states(WINDOW)
    for _ in range(2):
        states, _, _ = step(params, states, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            states, _, _ = step(params, states, None)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        log(f"profile {key}: device time not measured (the profiler saw no "
            "device events)")
        return
    by_name = {}
    for e in dev_events:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1000.0
    busy = sum(t for _, t in by_name.values()) / steps
    n = len(dev_events) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    log(f"profile {key}: device busy {busy:.3f} ms/step of {step_ms:.3f} ms "
        f"untraced (idle share {1 - busy / step_ms:.3f}), {n:.0f} device "
        "ops/step; top: " + "; ".join(
            f"{name[:48]} x{c // steps} {t / steps:.3f} ms"
            for name, (c, t) in top))


def launch_line(pattern: str, tail: str) -> str:
    return (f"videotestsrc pattern={pattern} width={W} height={H} "
            f"format=BGRx ! {tail} ! fakesink")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gstbad_tpu_torch as gtt
    from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.ops import _cuda, chainfuse, lut

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
        f"{triton} python {sys.version.split()[0]} devices {count}")

    # 2. build
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    log(f"build: {time.perf_counter() - t0:.2f} s total, nvcc "
        f"{info['seconds']:.2f} s, built={info['built']}, {info['path']}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand_i32(*shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    word_t = rand_i32(256)
    rank_t = TableChain.rank_table(rand_i32(256, lo=0, hi=60000))
    luma = LinearIndex((19, 183, 54, 0), 8, 16)      # sepia head on BGRx
    mean2 = LinearIndex((0, 1, 1, 0), 0, 1)
    err = {"dilate_zebra_fused": 0, "apply_word_table": 0}
    cases = [((WINDOW, H, W), None, luma), ((1, H, W), WINDOW, luma),
             ((3, 37, 333), None, mean2), ((1, 37, 333), 5, mean2)]
    for shape, batch, index in cases:
        src = rand_i32(*shape)
        b = batch or shape[0]
        phase = torch.arange(b, dtype=torch.int32, device=dev) + 5
        for erode in (False, True):
            got = chainfuse.dilate_zebra_fused(
                src, rank_t, word_t, index, erode, 120, phase, batch=batch)
            scal = torch.stack([
                torch.full((b,), int(erode), dtype=torch.int32, device=dev),
                torch.full((b,), 120, dtype=torch.int32, device=dev), phase])
            want = chainfuse.dilate_zebra_plain(src, rank_t, word_t, index,
                                                scal)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            log(f"K1 dilate_zebra_fused src {shape} batch {b} erode {erode}: "
                f"max_abs_err {e}")
            err["dilate_zebra_fused"] = max(err["dilate_zebra_fused"], e)
    for shape in ((WINDOW, H, W), (3, 37, 333)):
        idx = rand_i32(*shape, lo=0, hi=256)
        got = lut.apply_word_table(idx, word_t)
        want = lut.apply_word_table_plain(idx, word_t)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        log(f"K2 apply_word_table idx {shape}: max_abs_err {e}")
        err["apply_word_table"] = max(err["apply_word_table"], e)
    if any(err.values()):
        fail(f"kernels disagree with their plain versions: {err}")

    # 4. the main path through parse_launch on the card: the headline graph
    # as models/benchmarks.py builds it, on bars and on ball, and its prefix
    def launch(desc):
        return lambda device: gtt.parse_launch(desc, device=device)

    runs = {"headline_bars": lambda device: benchmarks.ten_element_graph(
                W, H, device=device),
            "headline_ball": launch(launch_line("ball", HEAD
                                                + " ! zebrastripe")),
            "prefix_bars": launch(launch_line("bars", HEAD))}
    n_windows, small = 3, 8
    outs, deltas = {}, {}
    chainfuse.dilate_zebra_fused.launches = 0
    lut.apply_word_table.launches = 0
    for key, build in runs.items():
        k1, k2 = (chainfuse.dilate_zebra_fused.launches,
                  lut.apply_word_table.launches)
        outs[key] = build("cuda").run(n_frames=n_windows * small,
                                      window=small)
        torch.cuda.synchronize()
        deltas[key] = (chainfuse.dilate_zebra_fused.launches - k1,
                       lut.apply_word_table.launches - k2)
    launches = {"dilate_zebra_fused": chainfuse.dilate_zebra_fused.launches,
                "apply_word_table": lut.apply_word_table.launches}
    log(f"main path launches {launches}, per graph {deltas}")
    for key in ("headline_bars", "headline_ball"):
        if deltas[key][0] != n_windows:
            fail(f"{key}: K1 launched {deltas[key][0]} times in "
                 f"{n_windows} windows")
    if deltas["prefix_bars"][1] != 2 * n_windows:
        fail(f"prefix_bars: K2 launched {deltas['prefix_bars'][1]} times in "
             f"{n_windows} windows (2 per window expected)")
    for key, build in runs.items():
        cpu = build("cpu").run(n_frames=n_windows * small, window=small)
        got = outs[key]
        if len(got) != len(cpu):
            fail(f"{key}: {len(got)} windows on the card, {len(cpu)} on CPU")
        for a, c in zip(got, cpu):
            if a.data.shape != (small, H, W, 4) or a.data.dtype.name != "uint8":
                fail(f"{key}: frames {a.data.shape} {a.data.dtype}")
            for f in ("data", "pts", "flags", "valid"):
                if not (getattr(a, f) == getattr(c, f)).all():
                    fail(f"{key}: {f} differs from the CPU port")
        log(f"{key}: {len(got)} windows of {small} frames equal the CPU port")

    # 5. timing
    def fps_runs(build, reps: int = 5, n_steps: int = 10):
        p = build("cuda")
        step = p.compile(WINDOW)
        params, states = p.params(), p.init_states(WINDOW)
        holder = {"states": states}

        def one():
            holder["states"], leaves, _ = step(params, holder["states"], None)
            holder["out"] = leaves[0]

        for _ in range(2):
            one()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            ms = cuda_ms(one, iters=n_steps, warmup=0)
            out.append(WINDOW * 1000.0 / ms)
        data = holder["out"].data
        if tuple(data.shape) != (WINDOW, H, W):
            fail(f"timed step gave {tuple(data.shape)}")
        return statistics.median(out), out

    fps = {}
    for key, build in runs.items():
        med, all_runs = fps_runs(build)
        fps[key] = med
        log(f"fps {key} 1080p window {WINDOW}: median {med:.1f} of "
            f"{[round(x, 1) for x in all_runs]} ({card})")
    for key, build in runs.items():
        profile_step(build("cuda"), WINDOW * 1000.0 / fps[key], key)

    src_bcast = rand_i32(1, H, W)
    src_full = rand_i32(WINDOW, H, W)
    phase = torch.arange(WINDOW, dtype=torch.int32, device=dev)
    scal = torch.stack([torch.zeros(WINDOW, dtype=torch.int32, device=dev),
                        torch.full((WINDOW,), 213, dtype=torch.int32,
                                   device=dev), phase])
    idx = rand_i32(WINDOW, H, W, lo=0, hi=256)
    times = {}
    for label, src, batch in (("bcast", src_bcast, WINDOW),
                              ("materialized", src_full, None)):
        times[f"K1_{label}"] = (
            cuda_ms(lambda: chainfuse.dilate_zebra_fused(
                src, rank_t, word_t, luma, False, 213, phase, batch=batch)),
            cuda_ms(lambda: chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, luma, scal), iters=5))
    times["K2"] = (cuda_ms(lambda: lut.apply_word_table(idx, word_t)),
                   cuda_ms(lambda: lut.apply_word_table_plain(idx, word_t),
                           iters=5))
    frame_bytes = H * W * 4
    for label, (ms, plain_ms) in times.items():
        moved = {"K1_bcast": WINDOW * frame_bytes,
                 "K1_materialized": 2 * WINDOW * frame_bytes,
                 "K2": 2 * WINDOW * frame_bytes}[label]
        log(f"{label} [{WINDOW}, {H}, {W}]: kernel {ms:.4f} ms "
            f"({moved / ms / 1e6:.1f} GB/s of min traffic), plain "
            f"{plain_ms:.4f} ms ({card})")

    kernels = [
        {"name": "dilate_zebra_fused", "route": "cuda",
         "source": "gstbad_tpu_torch/csrc/tablefuse_kernels.cu",
         "replaces": "gstbad_tpu/ops/chainfuse.py:78",
         "launches": launches["dilate_zebra_fused"],
         "max_abs_err": err["dilate_zebra_fused"],
         "ms": times["K1_bcast"][0], "plain_ms": times["K1_bcast"][1]},
        {"name": "apply_word_table", "route": "cuda",
         "source": "gstbad_tpu_torch/csrc/tablefuse_kernels.cu",
         "replaces": "gstbad_tpu/ops/lut.py:91",
         "launches": launches["apply_word_table"],
         "max_abs_err": err["apply_word_table"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
