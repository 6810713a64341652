#!/usr/bin/env python3
"""Smoke run of the gstbad_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result
line):

1. Require a CUDA card; print its name and power limit (nvidia-smi).
2. Build the hand-written kernels from gstbad_tpu_torch/csrc (one nvcc per
   source, all at once, into gstbad_tpu_torch/_build/) and print the build
   time and ptxas report.
3. Hold each kernel bit-exactly against its plain PyTorch version on the
   card, at the main paths' shapes and at a ragged shape: K1 and K2 at
   [64, 1080, 1920] (materialized and broadcast source, both erode
   values); K4 on a [129, 720, 1280] frame pool, K5 on 391 pairs of it, K6
   on [128, 720, 1280]; K3 (gaussian blur) at [64, 1080, 1920],
   materialized and as a broadcast [1, 1080, 1920] base, at sigma 1.2,
   -2.0 and 8.0 (41 taps); K7 (warp gather) at [64, 1080, 1920] and
   [16, 2160, 3840] through the fisheye and twirl maps, with the AYUV and
   the zero background, materialized and broadcast; K8 (the VAD power
   recurrence) in both modes, serial and bracket, at [64, 4800] on noise,
   DC, silence and square-wave rows and at [3, 300] and [5, 4801] (the
   serial plain version runs on a CPU copy: one Python step per sample).
4. Drive the port's main paths through parse_launch on the card: the 1080p
   headline graph on bars (broadcast source) and on ball (moving source),
   the headline without zebrastripe (the nine-element prefix, which takes
   the whole-word lookup), at 1280x720 GRAY8 24/1 BASELINE config 5
   (interlace 2:3 ! fieldanalysis ! ivtc) and the combdetect graph, the
   1080p AYUV gaussianblur graph (BASELINE config 2b) on bars and on ball,
   the 4K rgb2bayer ! bayer2rgb ! fisheye ! twirl graph (BASELINE config
   4, window 16), the 1080p fisheye graph, and the audio graphs at 4800
   samples per block, window 64: BASELINE config 3 (audiotestsrc !
   audiomixmatrix ! freeverb ! audioconvert ! removesilence, where the
   VAD's power bracket closes: K8's bracket mode once a window, its serial
   mode never) and vad_square (removesilence on a square wave: both modes
   once a window).  Each path's launch counters are zeroed just before and
   read just after; each of its kernels must have launched as planned, and
   its frames must equal the same graph run by the port on the CPU:
   exactly, but config 3's S16 samples within 1 LSB (with the share that
   differs printed) and its freeverb output within 2e-6, since the card's
   float32 matrix products sum in another order.  Config 5's SSIM gate
   (models/benchmarks.config5_fidelity) must give the same result on the
   card as on the CPU.  K3 to K8 are also held against their plain
   versions on the very inputs the main paths gave them.
5. Time: the median of 5 runs of source frames/s per graph (CUDA events
   around 10 steps of a 64-frame window, 16 at 4K, data kept on the card),
   a torch.profiler breakdown of each graph's step (device busy time,
   device ops per step, idle share), and each kernel beside its plain
   version, its bound and, where one PyTorch call computes the same
   function, that call, at the main path's shapes.  K8's line adds its
   dependency chain: samples walked in order times the cycles of one step
   (measured by a probe kernel that runs the step on registers alone) at
   the card's top SM clock; the audio graphs add their realtime factor.
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
W5, H5 = 1280, 720          # config 5 and combdetect
W4, H4 = 3840, 2160         # config 4
WINDOW = 64
WINDOW4 = 16                # config 4's window (bench.py:330 caps 4K at 16)
HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")
AUDIO_BLOCK = 4800          # config 3's samplesperbuffer, 48 kHz
AUDIO_RATE = 48000
# one H100 SXM, from NVIDIA's data sheet: HBM bytes/s, and the float32
# rate outside the tensor cores, taken as the rate of the kernels' 32-bit
# integer operations
HBM_BPS = 3.35e12
OPS_PER_S = 67e12
# the compiled-C audio chain of BASELINE config 3 on the host CPU
# (BASELINE_C.json audio_chain_realtime_x), the denominator of the
# audio graphs' realtime factor
C_AUDIO_REALTIME_X = 346.63


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over HBM_BPS and the
    operations over OPS_PER_S."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def byte_err(a, b) -> int:
    """Largest difference of any byte of two int32 word tensors (the
    packed-pixel kernels' error per channel)."""
    import torch
    return max_abs_err(a.view(torch.uint8), b.view(torch.uint8))


def profile_step(p, step_ms: float, key: str, window: int,
                 steps: int = 3) -> None:
    """Device time per step of pipeline `p` from a torch.profiler trace of
    `steps` steps: busy ms, device ops launched, the idle share against
    the untraced step time `step_ms`, and the kernels that take the most
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = p.compile(window)
    params, states = p.params(), p.init_states(window)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"profile {key}: device busy {busy:.3f} ms/step of {step_ms:.3f} ms "
        f"untraced (idle share {1 - busy / step_ms:.3f}), {n:.0f} device "
        "ops/step; top: " + "; ".join(
            f"{name[:48]} x{c // steps} {t / steps:.3f} ms"
            for name, (c, t) in top))


def launch_line(pattern: str, tail: str) -> str:
    return (f"videotestsrc pattern={pattern} width={W} height={H} "
            f"format=BGRx ! {tail} ! fakesink")


def frames_equal(key, got, cpu, shape) -> None:
    """Host batches of a card run against the CPU port's: same windows,
    frames of `shape` (after the frame axis), equal data, pts, flags and
    valid."""
    if len(got) != len(cpu):
        fail(f"{key}: {len(got)} windows on the card, {len(cpu)} on CPU")
    for a, c in zip(got, cpu):
        if a.data.shape[1:] != shape or a.data.dtype.name != "uint8":
            fail(f"{key}: frames {a.data.shape} {a.data.dtype}")
        for f in ("data", "pts", "flags", "valid"):
            if getattr(a, f).shape != getattr(c, f).shape or not (
                    getattr(a, f) == getattr(c, f)).all():
                fail(f"{key}: {f} differs from the CPU port")


def samples_close(key, got, cpu, got_msgs, cpu_msgs, lsb: int) -> None:
    """Host S16 audio batches of a card run against the CPU port's: same
    windows and blocks, pts, flags, valid and bus messages equal, samples
    within `lsb`; prints the share of samples that differ."""
    if len(got) != len(cpu):
        fail(f"{key}: {len(got)} windows on the card, {len(cpu)} on CPU")
    worst = n_diff = total = 0
    for a, c in zip(got, cpu):
        if a.data.shape[1:] != (AUDIO_BLOCK, 1) or a.data.dtype.name != "int16":
            fail(f"{key}: blocks {a.data.shape} {a.data.dtype}")
        for f in ("pts", "flags", "valid"):
            if getattr(a, f).shape != getattr(c, f).shape or not (
                    getattr(a, f) == getattr(c, f)).all():
                fail(f"{key}: {f} differs from the CPU port")
        if a.data.shape != c.data.shape:
            fail(f"{key}: {a.data.shape} blocks, {c.data.shape} on CPU")
        d = abs(a.data.astype(int) - c.data.astype(int))
        worst = max(worst, int(d.max()))
        n_diff += int((d > 0).sum())
        total += d.size
    if worst > lsb:
        fail(f"{key}: samples {worst} LSB from the CPU port's ({lsb} allowed)")
    if got_msgs != cpu_msgs:
        fail(f"{key}: bus messages differ from the CPU port's")
    log(f"{key}: {len(cpu)} windows; {n_diff} of {total} samples "
        f"({n_diff / total:.6f}) differ from the CPU port's, by at most "
        f"{worst} LSB; pts, valid and {len(cpu_msgs)} bus messages equal")


def bus_messages(p) -> list:
    return [(m.element, m.name, m.pts, m.fields) for m in p.bus.messages]


def tap_data(p, name: str, n_windows: int, window: int):
    """The output of element `name` over n_windows windows of pipeline p
    (a debug tap on the compiled step), on the host."""
    import torch
    step = p.compile(window, taps=(name,))
    params, states = p.params(), p.init_states(window)
    out = []
    for _ in range(n_windows):
        states, leaves, _ = step(params, states, None)
        out.append(p.taps_of(leaves)[name].data.cpu())
    return torch.cat(out)


def capture(module, name: str, store: dict):
    """Wrap module.<name> to record the arguments of each call (the inputs
    the main path gives a kernel) in store[name], a list.  Returns a
    function that puts the original back."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        store.setdefault(name, []).append((args, kw))
        return orig(*args, **kw)

    # the wrapper counts its launches on the module's attribute, the spy
    # while it is installed: those launches are not the counted run's
    spy.launches = 0
    setattr(module, name, spy)
    return lambda: setattr(module, name, orig)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gstbad_tpu_torch as gtt
    from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.golden import geometric
    from gstbad_tpu_torch.ops import (_cuda, audio, blur, chainfuse, comb,
                                      fieldanalysis, lut, remap)

    dev = torch.device("cuda", 0)
    device_kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    sm_hz = float(smi.stdout.split()[0]) * 1e6
    log(f"top SM clock: {sm_hz / 1e6:.0f} MHz")
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
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand_i32(*shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def rand_frames(n, h, w):
        """uint8 frames: noise, with every other one a smooth gradient
        plus a little noise, so comb scores fall on both sides of the
        thresholds and metrics on both sides of the noise floor."""
        f = rand_i32(n, h, w, lo=0, hi=256).to(torch.uint8)
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        smooth = (xx * 3 + yy * 2) % 256
        noise = rand_i32((n + 1) // 2, h, w, lo=-3, hi=4)
        f[0::2] = (smooth + noise).clamp(0, 255).to(torch.uint8)
        return f

    word_t = rand_i32(256)
    rank_t = TableChain.rank_table(rand_i32(256, lo=0, hi=60000))
    luma = LinearIndex((19, 183, 54, 0), 8, 16)      # sepia head on BGRx
    mean2 = LinearIndex((0, 1, 1, 0), 0, 1)
    err = {k: 0 for k in ("dilate_zebra_fused", "apply_word_table",
                          "metrics_default", "comb_score_pairs",
                          "comb_mask", "gaussian_blur_words",
                          "warp_words", "vad_powers_serial",
                          "vad_powers_bracket")}
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

    def check_telecine(label, pool, cur, prev, nf, pair_pool, top, bot,
                       frames):
        """K4, K5 and K6 against their plain versions on one input set."""
        got = fieldanalysis.metrics_default(pool, cur, prev, nf)
        want = fieldanalysis.metrics_default_plain(pool, cur, prev, nf)
        torch.cuda.synchronize()
        e4 = max(float((g - w).abs().max()) for g, w in zip(got, want))
        got = comb.comb_score_pairs(pair_pool, top, bot)
        want = comb.comb_score_pairs_plain(pair_pool, top, bot)
        torch.cuda.synchronize()
        e5 = max_abs_err(got, want)
        gm, gs = comb.comb_mask(frames)
        wm, ws = comb.comb_mask_plain(frames)
        torch.cuda.synchronize()
        e6 = max(max_abs_err(gm, wm), max_abs_err(gs, ws))
        log(f"K4/K5/K6 {label}: pool {tuple(pool.shape)}, {cur.numel()} "
            f"frames, {top.numel()} pairs (score sum {int(ws.sum())} / "
            f"{int(want.sum())}), mask {tuple(frames.shape)}: max_abs_err "
            f"{e4} / {e5} / {e6}")
        err["metrics_default"] = max(err["metrics_default"], e4)
        err["comb_score_pairs"] = max(err["comb_score_pairs"], e5)
        err["comb_mask"] = max(err["comb_mask"], e6)

    n_slots = 2 * WINDOW        # interlace's output slots per window
    n_pairs = 8 + 3 * n_slots - 1
    nf16 = torch.tensor(16, dtype=torch.int32, device=dev)
    for (p, h, w), npairs in (((n_slots + 1, H5, W5), n_pairs),
                              ((7, 50, 130), 13)):
        pool = rand_frames(p, h, w)
        cur = torch.arange(1, p, dtype=torch.int32, device=dev)
        prev = (cur - 1 - (cur % 3 == 0).to(torch.int32)).clamp(min=0)
        top = rand_i32(npairs, lo=0, hi=p)
        bot = rand_i32(npairs, lo=0, hi=p)
        check_telecine("random", pool, cur, prev, nf16, pool, top, bot,
                       pool[1:])

    def check_blur(label, src, kern, rows, cols, batch=None):
        """K3 against its plain version on one input."""
        got = blur.gaussian_blur_words(src, kern, rows, cols, batch=batch)
        want = blur.gaussian_blur_words_plain(src, kern, rows, cols,
                                              batch=batch)
        torch.cuda.synchronize()
        e = byte_err(got, want)
        log(f"K3 gaussian_blur_words {label} src {tuple(src.shape)} batch "
            f"{batch or src.shape[0]} taps {kern.numel()}: "
            f"max_abs_err {e} (bytes)")
        err["gaussian_blur_words"] = max(err["gaussian_blur_words"], e)

    def blur_tables(sigma, h, w):
        return [torch.from_numpy(t).to(dev)
                for t in blur.make_blur_tables(sigma, h, w)]

    def check_warp(label, src, mp, bg, batch=None):
        """K7 against its plain version on one input."""
        got = remap.warp_words(src, mp, bg, batch=batch)
        want = remap.warp_words_plain(src, mp, bg, batch=batch)
        torch.cuda.synchronize()
        e = byte_err(got, want)
        log(f"K7 warp_words {label} src {tuple(src.shape)} batch "
            f"{batch or src.shape[0]} bg {bg:#x}: max_abs_err {e} (bytes)")
        err["warp_words"] = max(err["warp_words"], e)

    def warp_map(warp, h, w, off_edge="ignore"):
        flat, valid = remap.fix_map(geometric.MAP_BUILDERS[warp](w, h), w, h,
                                    off_edge)
        return torch.from_numpy(remap.word_map(flat, valid)).to(dev)

    bg_ayuv = remap.background_word(b"\xff\x10\x80\x80")
    src_full, src_bcast = rand_i32(WINDOW, H, W), rand_i32(1, H, W)
    for sigma in (1.2, -2.0, 8.0):
        tables = blur_tables(sigma, H, W)
        check_blur(f"sigma {sigma}", src_full, *tables)
        check_blur(f"sigma {sigma}", src_bcast, *tables, batch=WINDOW)
        check_blur(f"sigma {sigma}", rand_i32(3, 37, 333),
                   *blur_tables(sigma, 37, 333))
    src4 = rand_i32(WINDOW4, H4, W4)
    for warp in ("fisheye", "twirl"):
        mp = warp_map(warp, H, W)
        check_warp(warp, src_full, mp, bg_ayuv)
        check_warp(warp, src_bcast, mp, 0, batch=WINDOW)
        check_warp(warp, src4, warp_map(warp, H4, W4), 0)
    check_warp("rotate wrap", rand_i32(3, 37, 333),
               warp_map("rotate", 37, 333, "wrap"), bg_ayuv)
    check_warp("rotate", rand_i32(1, 37, 333), warp_map("rotate", 37, 333),
               bg_ayuv, batch=5)
    del src_full, src_bcast, src4

    def vad_rows(kind, nb, n):
        """S16 VAD blocks: noise (the brackets close), DC 30000 and a 440 Hz
        square (they stay open), silence."""
        if kind == "noise":
            return rand_i32(nb, n, lo=-32768, hi=32768).to(torch.int16)
        if kind == "dc":
            return torch.full((nb, n), 30000, dtype=torch.int16, device=dev)
        if kind == "silence":
            return torch.zeros((nb, n), dtype=torch.int16, device=dev)
        t = torch.arange(nb * n, dtype=torch.float64, device=dev)
        return (26213 * torch.sign(torch.sin(2 * torch.pi * 440 * t
                                             / AUDIO_RATE))
                ).to(torch.int16).reshape(nb, n)

    def check_vad(label, data, p0):
        """K8's two modes against their plain versions on one input; the
        serial plain version on a CPU copy (one Python step per sample)."""
        got = audio.vad_powers_serial(data, p0)
        lo, hi = audio.vad_powers_bracket(data)
        want = audio.vad_powers_serial_plain(data.cpu(), p0.cpu())
        want_lo, want_hi = audio.vad_powers_bracket_plain(data)
        torch.cuda.synchronize()
        es = max_abs_err(got.cpu(), want)
        eb = max(max_abs_err(lo, want_lo), max_abs_err(hi, want_hi))
        closed = int((want_lo == want_hi).sum())
        log(f"K8 vad_powers serial/bracket {label} {tuple(data.shape)}: "
            f"max_abs_err {es} / {eb} ({closed} of {data.shape[0]} "
            "brackets closed)")
        err["vad_powers_serial"] = max(err["vad_powers_serial"], es)
        err["vad_powers_bracket"] = max(err["vad_powers_bracket"], eb)

    p0 = torch.tensor(123456789, dtype=torch.int64, device=dev)
    for kind in ("noise", "dc", "silence", "square"):
        check_vad(kind, vad_rows(kind, WINDOW, AUDIO_BLOCK), p0)
    for nb, n in ((3, 300), (5, 4801)):
        for kind in ("noise", "square"):
            check_vad(kind, vad_rows(kind, nb, n), p0)
    if any(err.values()):
        fail(f"kernels disagree with their plain versions: {err}")

    # 4. the main paths through parse_launch on the card
    def launch(desc):
        return lambda device: gtt.parse_launch(desc, device=device)

    runs = {"headline_bars": lambda device: benchmarks.ten_element_graph(
                W, H, device=device),
            "headline_ball": launch(launch_line("ball", HEAD
                                                + " ! zebrastripe")),
            "prefix_bars": launch(launch_line("bars", HEAD)),
            "config5_ivtc": lambda device: benchmarks.config5_ivtc(
                W5, H5, device=device),
            "combdetect_720p": lambda device: benchmarks.combdetect_720p(
                W5, H5, device=device),
            "config2_blur_bars": lambda device: benchmarks.config2_blur(
                W, H, device=device),
            "config2_blur_ball": launch(
                f"videotestsrc pattern=ball width={W} height={H} "
                "format=AYUV ! gaussianblur sigma=1.2 ! fakesink"),
            "config4_warp": lambda device: benchmarks.config4_warp(
                W4, H4, device=device),
            "warp_1080p": lambda device: benchmarks.warp_1080p(
                W, H, device=device),
            "config3_audio": lambda device: benchmarks.config3_audio(
                AUDIO_BLOCK, device=device),
            "vad_square": lambda device: benchmarks.vad_square(
                AUDIO_BLOCK, device=device)}
    audio_keys = ("config3_audio", "vad_square")
    counters = {"dilate_zebra_fused": chainfuse.dilate_zebra_fused,
                "apply_word_table": lut.apply_word_table,
                "metrics_default": fieldanalysis.metrics_default,
                "comb_score_pairs": comb.comb_score_pairs,
                "comb_mask": comb.comb_mask,
                "gaussian_blur_words": blur.gaussian_blur_words,
                "warp_words": remap.warp_words,
                "vad_powers_serial": audio.vad_powers_serial,
                "vad_powers_bracket": audio.vad_powers_bracket}
    # (windows, window) of each path's counted run, and the launches each
    # kernel must make per window on it
    plan = {"headline_bars": (3, 8, {"dilate_zebra_fused": 1}),
            "headline_ball": (3, 8, {"dilate_zebra_fused": 1}),
            "prefix_bars": (3, 8, {"apply_word_table": 2}),
            "config5_ivtc": (2, WINDOW, {"metrics_default": 1,
                                         "comb_score_pairs": 1}),
            "combdetect_720p": (2, WINDOW, {"comb_mask": 1}),
            "config2_blur_bars": (2, 8, {"gaussian_blur_words": 1}),
            "config2_blur_ball": (2, 8, {"gaussian_blur_words": 1}),
            "config4_warp": (1, WINDOW4, {"warp_words": 2}),
            "warp_1080p": (2, WINDOW, {"warp_words": 1}),
            # a sine's brackets close: the serial mode never runs
            "config3_audio": (2, WINDOW, {"vad_powers_bracket": 1,
                                          "vad_powers_serial": 0}),
            "vad_square": (2, WINDOW, {"vad_powers_bracket": 1,
                                       "vad_powers_serial": 1})}
    shapes = {"headline_bars": (H, W, 4), "headline_ball": (H, W, 4),
              "prefix_bars": (H, W, 4), "config5_ivtc": (H5, W5),
              "combdetect_720p": (H5, W5), "config2_blur_bars": (H, W, 4),
              "config2_blur_ball": (H, W, 4), "config4_warp": (H4, W4, 4),
              "warp_1080p": (H, W, 4)}
    windows = {key: WINDOW4 if key == "config4_warp" else WINDOW
               for key in runs}

    # K3 to K7's main-path inputs, recorded on uncounted runs
    inputs = {}
    undo = [capture(fieldanalysis, "metrics_default", inputs),
            capture(comb, "comb_score_pairs", inputs),
            capture(comb, "comb_mask", inputs),
            capture(blur, "gaussian_blur_words", inputs),
            capture(remap, "warp_words", inputs)]
    runs["config5_ivtc"]("cuda").run(n_frames=2 * WINDOW, window=WINDOW)
    runs["combdetect_720p"]("cuda").run(n_frames=WINDOW, window=WINDOW)
    for key in ("config2_blur_bars", "config2_blur_ball", "config4_warp",
                "warp_1080p"):
        runs[key]("cuda").run(n_frames=windows[key], window=windows[key])
    # K8's: config 3's bracket input and vad_square's serial input; config
    # 3's freeverb output on the card, held against the CPU port's below
    undo += [capture(audio, "vad_powers_bracket", inputs),
             capture(audio, "vad_powers_serial", inputs)]
    fv_card = tap_data(runs["config3_audio"]("cuda"), "freeverb", 2, WINDOW)
    runs["vad_square"]("cuda").run(n_frames=WINDOW, window=WINDOW)
    for u in undo:
        u()
    torch.cuda.synchronize()
    fv_err = float((fv_card - tap_data(runs["config3_audio"]("cpu"),
                                       "freeverb", 2, WINDOW)).abs().max())
    log(f"config3_audio: freeverb output on the card within {fv_err:.3e} "
        "of the CPU port's (2e-6 allowed)")
    if not fv_err <= 2e-6:
        fail("config3_audio: freeverb output differs from the CPU port's")
    (x_bracket,), _ = inputs["vad_powers_bracket"][0]
    (x_serial, p0_serial), _ = inputs["vad_powers_serial"][0]
    check_vad("main-path inputs config3_audio", x_bracket, p0_serial)
    check_vad("main-path inputs vad_square", x_serial, p0_serial)
    if len(inputs["vad_powers_bracket"]) != 3 or len(
            inputs["vad_powers_serial"]) != 1:
        fail("main paths gave K8's bracket "
             f"{len(inputs['vad_powers_bracket'])} and its serial mode "
             f"{len(inputs['vad_powers_serial'])} inputs, 3 and 1 expected")
    pool_mp, cur_mp, prev_mp, nf_mp = inputs["metrics_default"][-1][0]
    pool5, top_mp, bot_mp = inputs["comb_score_pairs"][-1][0]
    (frames_mp,) = inputs["comb_mask"][-1][0]
    check_telecine("main-path inputs", pool_mp, cur_mp, prev_mp, nf_mp,
                   pool5, top_mp, bot_mp, frames_mp)
    # blur: bars (broadcast base), ball (materialized); warp: config 4's
    # fisheye and twirl (materialized 4K), warp_1080p's fisheye (broadcast)
    blur_mp = inputs["gaussian_blur_words"]
    warp_mp = inputs["warp_words"]
    for (args, kw), label in zip(blur_mp, ("config2_blur_bars",
                                           "config2_blur_ball")):
        check_blur(f"main-path inputs {label}", *args, **kw)
    for (args, kw), label in zip(warp_mp, ("config4_warp fisheye",
                                           "config4_warp twirl",
                                           "warp_1080p fisheye")):
        check_warp(f"main-path inputs {label}", *args, **kw)
    if len(blur_mp) != 2 or len(warp_mp) != 3:
        fail(f"main paths gave K3 {len(blur_mp)} and K7 {len(warp_mp)} "
             "inputs, 2 and 3 expected")
    if any(err.values()):
        fail(f"kernels disagree with their plain versions: {err}")

    launches = {k: 0 for k in counters}
    outs, msgs = {}, {}
    for key, build in runs.items():
        n_windows, window, need = plan[key]
        pipe = build("cuda")
        for c in counters.values():
            c.launches = 0
        outs[key] = pipe.run(n_frames=n_windows * window, window=window)
        torch.cuda.synchronize()
        msgs[key] = bus_messages(pipe)
        delta = {k: c.launches for k, c in counters.items()}
        log(f"{key}: launches {delta}")
        for k, per in need.items():
            if delta[k] != per * n_windows:
                fail(f"{key}: {k} launched {delta[k]} times in {n_windows} "
                     f"windows ({per} per window expected)")
        for k in launches:
            launches[k] += delta[k]
    log(f"main path launches {launches}")
    for key, build in runs.items():
        n_windows, window, _ = plan[key]
        pipe = build("cpu")
        cpu = pipe.run(n_frames=n_windows * window, window=window)
        if key in audio_keys:
            samples_close(key, outs[key], cpu, msgs[key], bus_messages(pipe),
                          1 if key == "config3_audio" else 0)
            continue
        frames_equal(key, outs[key], cpu, shapes[key])
        log(f"{key}: {len(cpu)} windows, {sum(len(b.pts) for b in cpu)} "
            "frames equal the CPU port")
    fid = {d: benchmarks.config5_fidelity(W5, H5, device=d)
           for d in ("cuda", "cpu")}
    log(f"config5_fidelity card {fid['cuda']} cpu {fid['cpu']}")
    if fid["cuda"] != fid["cpu"]:
        fail("config5_fidelity differs between the card and the CPU port")

    # 5. timing
    def fps_runs(build, window, reps: int = 5, n_steps: int = 10):
        p = build("cuda")
        step = p.compile(window)
        params, states = p.params(), p.init_states(window)
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
            out.append(window * 1000.0 / ms)
        return statistics.median(out), out

    fps = {}
    for key, build in runs.items():
        med, all_runs = fps_runs(build, windows[key])
        fps[key] = med
        log(f"fps {key} window {windows[key]}: median {med:.1f} source "
            f"frames/s of {[round(x, 1) for x in all_runs]} ({card})")
    for key in audio_keys:
        rt = fps[key] * AUDIO_BLOCK / AUDIO_RATE
        log(f"realtime {key}: {fps[key]:.1f} source blocks/s of "
            f"{AUDIO_BLOCK} samples = {rt:.2f}x realtime at 48 kHz "
            f"({card})")
    log("realtime config3_audio: the compiled C chain of BASELINE config 3 "
        f"on the host CPU runs {C_AUDIO_REALTIME_X}x realtime "
        f"(BASELINE_C.json): the card's graph is "
        f"{fps['config3_audio'] * AUDIO_BLOCK / AUDIO_RATE / C_AUDIO_REALTIME_X:.3f}"
        "x that")
    for key, build in runs.items():
        profile_step(build("cuda"), windows[key] * 1000.0 / fps[key], key,
                     windows[key])

    src_bcast = rand_i32(1, H, W)
    src_full = rand_i32(WINDOW, H, W)
    phase = torch.arange(WINDOW, dtype=torch.int32, device=dev)
    scal = torch.stack([torch.zeros(WINDOW, dtype=torch.int32, device=dev),
                        torch.full((WINDOW,), 213, dtype=torch.int32,
                                   device=dev), phase])
    idx = rand_i32(WINDOW, H, W, lo=0, hi=256)
    times = {}   # label -> (ms, plain ms, library ms or None)
    for label, src, batch in (("bcast", src_bcast, WINDOW),
                              ("materialized", src_full, None)):
        times[f"K1_{label}"] = (
            cuda_ms(lambda: chainfuse.dilate_zebra_fused(
                src, rank_t, word_t, luma, False, 213, phase, batch=batch)),
            cuda_ms(lambda: chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, luma, scal), iters=5), None)
    # K2's one-call library form: the same lookup as a single indexing call
    times["K2"] = (cuda_ms(lambda: lut.apply_word_table(idx, word_t)),
                   cuda_ms(lambda: lut.apply_word_table_plain(idx, word_t),
                           iters=5),
                   cuda_ms(lambda: word_t[idx], iters=5))
    times["K4"] = (
        cuda_ms(lambda: fieldanalysis.metrics_default(
            pool_mp, cur_mp, prev_mp, nf_mp)),
        cuda_ms(lambda: fieldanalysis.metrics_default_plain(
            pool_mp, cur_mp, prev_mp, nf_mp), iters=3), None)
    times["K5"] = (
        cuda_ms(lambda: comb.comb_score_pairs(pool5, top_mp, bot_mp)),
        cuda_ms(lambda: comb.comb_score_pairs_plain(pool5, top_mp, bot_mp),
                iters=1, warmup=1), None)
    times["K6"] = (
        cuda_ms(lambda: comb.comb_mask(frames_mp)),
        cuda_ms(lambda: comb.comb_mask_plain(frames_mp), iters=1, warmup=1),
        None)
    # K3 on config2_blur's inputs (bars: a broadcast base; ball: a
    # materialized window); no one PyTorch call has the border-sum
    # normalisation and the rounding, so no library time
    for label, (args, kw) in zip(("K3_bcast", "K3_materialized"), blur_mp):
        times[label] = (
            cuda_ms(lambda: blur.gaussian_blur_words(*args, **kw)),
            cuda_ms(lambda: blur.gaussian_blur_words_plain(*args, **kw),
                    iters=3), None)
    # K7 on config4_warp's fisheye input (4K x 16, materialized) and on
    # warp_1080p's (a broadcast base, 64 frames); the library form is the
    # gather alone, index_select, without the background select
    for label, (args, kw) in zip(("K7_4k", "K7_1080p_bcast"),
                                 (warp_mp[0], warp_mp[2])):
        src, mp, bg = args
        b = kw.get("batch") or src.shape[0]
        flat = mp.clamp(min=0)
        full = src.expand(b, -1, -1).reshape(b, -1)
        times[label] = (
            cuda_ms(lambda: remap.warp_words(*args, **kw)),
            cuda_ms(lambda: remap.warp_words_plain(*args, **kw), iters=5),
            cuda_ms(lambda: full.index_select(1, flat), iters=5))

    # K8 on its main-path inputs: the serial mode on vad_square's window,
    # the bracket on config 3's; the plain serial version is a Python loop
    # on the host (it copies the samples there); no PyTorch call computes
    # a truncating recurrence, so no library time
    times["K8_serial"] = (
        cuda_ms(lambda: audio.vad_powers_serial(x_serial, p0_serial)),
        cuda_ms(lambda: audio.vad_powers_serial_plain(x_serial, p0_serial),
                iters=1, warmup=0), None)
    times["K8_bracket"] = (
        cuda_ms(lambda: audio.vad_powers_bracket(x_bracket)),
        cuda_ms(lambda: audio.vad_powers_bracket_plain(x_bracket), iters=1,
                warmup=1), None)
    # the latency of one step of the chain, from the probe kernel
    probe = torch.zeros(2, dtype=torch.int64, device=dev)
    probe_steps = 1 << 20
    _cuda.launch("gst_vad_step_cycles", probe, probe_steps)
    torch.cuda.synchronize()
    step_cycles = probe[0].item() / probe_steps
    log(f"K8 step latency: {step_cycles:.3f} cycles per dependent step "
        f"({probe_steps} steps on registers)")

    # bounds: each input byte read once, each output byte written once,
    # and the integer operations the function needs per element
    frame4 = H * W * 4
    hw5 = H5 * W5
    k4_frames = torch.unique(torch.cat([cur_mp, prev_mp])).numel()
    k5_bytes = (torch.unique(top_mp).numel() * ((H5 + 1) // 2)
                + torch.unique(bot_mp).numel() * (H5 // 2)) * W5
    n_k5, n_k6 = top_mp.numel(), frames_mp.shape[0]
    cells = (H5 - 4) * W5
    bounds = {
        # write B words; read one source frame; ~12 ops per pixel (index,
        # three neighbour indices, rank walk, stripe select)
        "K1_bcast": bound(WINDOW * frame4 + frame4, 12 * WINDOW * H * W),
        "K1_materialized": bound(2 * WINDOW * frame4, 12 * WINDOW * H * W),
        "K2": bound(2 * WINDOW * frame4, WINDOW * H * W),
        # the distinct frames read; ~20 ops per pixel (ssd, three taps on
        # half the rows, gates, sums)
        "K4": bound(k4_frames * hw5 + cur_mp.numel() * 5 * 8,
                    20 * cur_mp.numel() * hw5),
        # the woven rows read; ~10 ops per cell (outlier, scan, clamp)
        "K5": bound(k5_bytes + 4 * n_k5, 10 * n_k5 * cells),
        "K6": bound(2 * n_k6 * hw5 + 4 * n_k6, 10 * n_k6 * cells),
    }
    for label, (args, kw) in zip(("K3_bcast", "K3_materialized"), blur_mp):
        src, kern = args[0], args[1]
        b = kw.get("batch") or src.shape[0]
        px = b * src.shape[1] * src.shape[2]
        # read the source frames and the tables once, write B frames; per
        # pixel and channel of each distinct source frame (one for a
        # broadcast base) 2 (2c + 1) multiplies and adds, two divisions,
        # the +0.5 and the clamp
        table_bytes = 4 * (kern.numel() + src.shape[1] + src.shape[2])
        bounds[label] = bound(4 * px + src.numel() * 4 + table_bytes,
                              (4 * kern.numel() + 5) * 4 * src.numel())
    for label, (args, kw) in zip(("K7_4k", "K7_1080p_bcast"),
                                 (warp_mp[0], warp_mp[2])):
        src, mp = args[0], args[1]
        b = kw.get("batch") or src.shape[0]
        px = b * mp.numel()
        # read the map and the source pixels the map names once per source
        # frame, write B frames; one select per pixel
        named = torch.unique(mp[mp >= 0]).numel()
        bounds[label] = bound(4 * px + 4 * named * src.shape[0]
                              + 4 * mp.numel(), px)
        log(f"{label}: the map names {named} of {mp.numel()} source pixels")
    # K8: the samples read once (2 bytes each), the powers written once;
    # per sample 3 operations for the squared term and 2 per walk of the
    # step (multiply-high, add); the bracket walks each sample twice.  The
    # chain: the samples walked in order, times the step's latency, at
    # the top SM clock
    chains = {}
    for label, x, walks in (("K8_serial", x_serial, 1),
                            ("K8_bracket", x_bracket, 2)):
        nb, n = x.shape
        bounds[label] = bound(2 * nb * n + 8 * walks * nb + 8,
                              (3 + 2 * walks) * nb * n)
        in_order = nb * n if label == "K8_serial" else n
        chains[label] = in_order * step_cycles / sm_hz * 1e3
        log(f"{label}: {nb} blocks of {n} samples; chain {in_order} steps "
            f"x {step_cycles:.3f} cycles at {sm_hz / 1e6:.0f} MHz = "
            f"{chains[label]:.4f} ms")
    for label, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bounds[label]
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        chain = (f", chain {chains[label]:.4f} ms" if label in chains
                 else "")
        log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {b_ms:.4f} ms ({b_by}){chain} "
            f"({card})")
    log(f"K4 inputs: pool {tuple(pool_mp.shape)}, {cur_mp.numel()} frames, "
        f"{k4_frames} distinct; K5: {n_k5} pairs; K6: "
        f"{tuple(frames_mp.shape)}")

    def entry(kname, label, source, replaces):
        ms, plain_ms, lib_ms = times[label]
        b_ms, b_by = bounds[label]
        return {"name": kname, "route": "cuda",
                "source": f"gstbad_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    kernels = [
        entry("dilate_zebra_fused", "K1_bcast", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/chainfuse.py:78"),
        entry("apply_word_table", "K2", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/lut.py:91"),
        entry("metrics_default", "K4", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/fieldanalysis.py:190"),
        entry("comb_score_pairs", "K5", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/comb.py:258"),
        entry("comb_mask", "K6", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/comb.py:102"),
        entry("gaussian_blur_words", "K3_bcast", "blur_kernels.cu",
              "gstbad_tpu/ops/blur_pallas.py:56"),
        entry("warp_words", "K7_4k", "warp_kernels.cu",
              "gstbad_tpu/ops/warp_pallas.py:215"),
        entry("vad_powers_serial", "K8_serial", "vad_kernels.cu",
              "gstbad_tpu/ops/audio.py:585"),
        entry("vad_powers_bracket", "K8_bracket", "vad_kernels.cu",
              "gstbad_tpu/ops/audio.py:653"),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
