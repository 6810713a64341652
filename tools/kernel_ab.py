#!/usr/bin/env python3
"""Times H1 (ops/haar.haar_cascade), H2 (ops/haar.tilted_integral),
scope_filter and freeverb_scan (ops/audio) of this checkout against
another checkout's, on the same inputs, on one CUDA card.

    python tools/kernel_ab.py [--other DIR] [--paths] [--out FILE]

DIR holds another checkout of the repository (for example an earlier
commit unpacked with `git archive`).  Each checkout is measured in a
process of its own, with its own package and kernel library, in turns:
other, this, this, other (this alone without --other).  A measurement:
- H1 on every launch of a facedetect_720p window (16 frames of
  chip_smoke.face_frames at 1280x720, alt2, the pyramid's 16 scales at
  1.25) and of a handdetect_640x480 window (16 frames of
  chip_smoke.hand_frames, fist's 16 scales at 1.1, then palm's), each the
  mean of 20 launches by CUDA events, and their sum a window;
- H2 on every plane of that handdetect window (32 launches), and their
  sum;
- scope_filter on seeded int32 samples at [112896, 2] (scopes_720p's
  window) and [307200, 2] (play_vis_48k's);
- freeverb_scan on seeded float32 samples at [141120, 2] (freeverb_22k's
  window of 64 blocks) at 22.05 kHz, 8 kHz, 16 kHz and 31999 Hz, and at
  [3000, 2] (chip_smoke.py's long check block) at the last three: by CUDA
  events around its wrapper, and its kernel alone by its device time
  (torch.profiler; at [3000, 2] the wrapper's host work sets the events'
  time);
- with --paths, the device step of the face, hand, scope and freeverb_22k
  paths as chip_smoke.py times it (fps_runs), and one traced step: its
  device busy ms and the four kernels' share of it (torch.profiler).
This checkout's kernels are also held against their plain versions on
every input (H1: passed equal everywhere, score equal where passed; H2:
every element; freeverb_scan on its first 4410 samples at 22.05 kHz and
its [3000, 2] block at 8 kHz: every output), and its first run records
the survival profile of facedetect's largest scale (eval_cascade_plain's
count mode: the windows alive at each stage's start).  Prints a summary
and one JSON object (also written to FILE with --out), with the card's
name and power limit (nvidia-smi)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPE_SHAPES = ((112896, 2), (307200, 2))
FV_CASES = ((22050, 141120), (8000, 141120), (16000, 141120),
            (31999, 141120), (8000, 3000), (16000, 3000), (31999, 3000))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


PATHS = ("facedetect_720p", "faceblur_720p", "handdetect_640x480",
         "scopes_720p_wavescope", "scopes_720p_spacescope", "freeverb_22k")
KERNELS = ("haar_cascade_kernel", "tilted_integral_kernel",
           "scope_filter_kernel", "freeverb_scan_kernel")


def measure(root: str, check: bool, paths: bool = False) -> dict:
    """One checkout's times (in this process, root's package imported)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    import gstbad_tpu_torch as gtt
    from gstbad_tpu_torch.io.haarcascade import parse_cascade
    from gstbad_tpu_torch.ops import audio, haar
    from gstbad_tpu_torch.ops import cv as cvops
    from gstbad_tpu_torch.ops.resize import resize_linear

    dev = torch.device("cuda", 0)
    data = os.path.join(root, "gstbad_tpu_torch", "data")
    res = {"root": root, "h1": {}, "h2": {}, "scope": {}, "freeverb": {},
           "bad": 0}
    t0 = time.perf_counter()

    def traced(fn, iters=1):
        """fn called `iters` times under torch.profiler: (host ms, [(name,
        ms)] of the device ops they ran)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t1) * 1e3
        return host_ms, [(e.name, e.time_range.elapsed_us() / 1e3)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA]

    def launches(frames, packs, factor):
        gray = cvops.rgb2gray_u8(torch.from_numpy(frames).to(dev)).to(
            torch.float32)
        h, w = gray.shape[-2:]
        out = []
        planes.clear()
        for pk in packs:
            ww, wh = pk.window
            f = 1.0
            for _ in range(haar.MAX_SCALES):
                sh, sw = int(h / f), int(w / f)
                if sh < wh or sw < ww:
                    break
                x = resize_linear(gray, sh, sw)
                planes.append(x)
                ny, nx = haar.grid(sh, sw, pk)
                tii = haar.tilted_integral(x) if pk.any_tilted else None
                out.append((haar.integral(x), haar.integral(x * x), tii, pk,
                            ny, nx))
                f *= factor
        return out

    planes = []
    alt2 = haar.pack(parse_cascade(os.path.join(
        data, "haarcascade_frontalface_alt2.xml")), "arrays")
    hands = [haar.pack(parse_cascade(os.path.join(data, f"{n}.xml")),
                       "unrolled") for n in ("fist", "palm")]
    for key, frames, packs, factor in (
            ("facedetect_720p", cs.face_frames(16, 1280, 720), [alt2], 1.25),
            ("handdetect_640x480", cs.hand_frames(16, 640, 480), hands,
             1.1)):
        args = launches(frames, packs, factor)
        per = [cs.cuda_ms(lambda a=a: haar.haar_cascade(*a)) for a in args]
        row = {"per_launch_ms": per, "window_ms": sum(per),
               "shapes": [list(a[0].shape) for a in args]}
        if check:
            for i, a in enumerate(args):
                kp, ks = haar.haar_cascade(*a)
                first = i == 0 and key.startswith("face")
                out = haar.eval_cascade_plain(*a, count=first)
                pp, ps = out[:2]
                res["bad"] += int((kp != pp).sum()) + int(
                    (ks[pp] != ps[pp]).sum())
                if len(out) == 4:
                    row["alive_at_stage"] = out[3].tolist()
                    row["evaluations"] = int(out[2].sum())
        res["h1"][key] = row
    # H2 on the handdetect window's planes (the last `launches` call's)
    per = [cs.cuda_ms(lambda x=x: haar.tilted_integral(x)) for x in planes]
    res["h2"] = {"per_launch_ms": per, "window_ms": sum(per),
                 "shapes": [list(x.shape) for x in planes]}
    if check:
        res["h2"]["differ"] = [
            int((haar.tilted_integral(x).cpu()
                 != haar.tilted_integral_plain(x.cpu())).sum())
            for x in planes]
        res["bad"] += sum(res["h2"]["differ"])
    rng = np.random.default_rng(5)
    for n, c in SCOPE_SHAPES:
        st = torch.from_numpy(rng.standard_normal(6 * c) * 100).to(dev)
        x = torch.from_numpy(rng.integers(-32768, 32768, (n, c)).astype(
            np.int32)).to(dev)
        row = {"ms": cs.cuda_ms(lambda: audio.scope_filter(st, x))}
        if check:
            s1, t1 = audio.scope_filter(st, x)
            s2, t2 = audio.scope_filter_plain(st.cpu(), x.cpu())
            res["bad"] += int((s1.cpu() != s2).sum()) + int(
                (t1.cpu() != t2).sum())
        res["scope"][f"{n}x{c}"] = row
    prm = {k: v.to(dev) for k, v in gtt.make(
        "freeverb").dynamic_params().items()}
    for rate, n in FV_CASES:
        x = torch.from_numpy(((rng.random((n, 2)) - 0.5) * 1.8).astype(
            np.float32)).to(dev)
        st = audio.freeverb_init_state(rate, dev)

        def fv():
            audio.freeverb_scan(st, x, prm, rate, False)
        # its kernel alone: the mean device time of 20 traced calls (what
        # the host around it costs is left out)
        row = {"ms": cs.cuda_ms(fv),
               "kernel_ms": sum(t for name, t in traced(fv, 20)[1]
                                if "freeverb_scan_kernel" in name) / 20}
        if check and (rate, n) in ((22050, 141120), (8000, 3000)):
            m = 4410 if n > 4410 else n
            _, y = audio.freeverb_scan(st, x[:m], prm, rate, False)
            _, want = audio.freeverb_scan_plain(
                audio.freeverb_init_state(rate), x[:m].cpu(),
                {k: v.cpu() for k, v in prm.items()}, rate, False)
            row["max_abs_err"] = float((y.cpu() - want).abs().max())
            row["differ"] = int((y.cpu() != want).sum())
            res["bad"] += int(row["max_abs_err"] > 2e-6)
        res["freeverb"][f"{rate}Hz_{n}x2"] = row
    if paths:
        # the paths' device steps, as chip_smoke.py times them (fps_runs)
        from gstbad_tpu_torch.models import benchmarks
        found = {**cs.detect_paths(gtt), **{
            k: (v[0], v[1], cs.AUDIO_WINDOW, None, "device")
            for k, v in cs.audio_paths(benchmarks).items()},
            "freeverb_22k": (lambda device: benchmarks.freeverb_22k(
                cs.FV_BLOCK, device=device), None, cs.WINDOW, None,
                "device")}
        res["paths"] = {}
        for key in PATHS:
            build, feed, window, _, clock = found[key]
            med, runs = cs.fps_runs(build, window, feed=feed, clock=clock)
            # one traced step: device busy ms and the walks' share of it
            p = build("cuda")
            batch = cs.fed_input(p, feed, window)
            step = p.compile(window)
            params, states = p.params(), p.init_states(window)
            states, _, _ = step(params, states, batch)
            torch.cuda.synchronize()
            traced_ms, dev = traced(lambda: step(params, states, batch))
            res["paths"][key] = {
                "per_s": med, "step_ms": window * 1e3 / med, "runs": runs,
                "traced_step_ms": traced_ms, "device_ops": len(dev),
                "busy_ms": sum(t for _, t in dev),
                "kernel_ms": {k: sum(t for n, t in dev if k in n)
                              for k in KERNELS}}
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout's root")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--paths", action="store_true",
                    help="also the face, hand, scope and freeverb_22k "
                    "paths' steps")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.measure:
        print(json.dumps(measure(a.measure, a.check, a.paths)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    order = [("this", HERE, True)]
    if a.other:
        other = os.path.abspath(a.other)
        order = [("other", other, False), ("this", HERE, True),
                 ("this", HERE, False), ("other", other, False)]
    runs = []
    for label, root, check in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root]
        if check:
            cmd.append("--check")
        if a.paths:
            cmd.append("--paths")
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append({"label": label, **json.loads(p.stdout.splitlines()[-1])})
    result = {"card": card(), "runs": runs}
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    for r in runs:
        h1 = {k: round(v["window_ms"], 4) for k, v in r["h1"].items()}
        big = {k: round(v["per_launch_ms"][0], 4) for k, v in r["h1"].items()}
        fv = {k: (round(v["ms"], 4), round(v["kernel_ms"], 4))
              for k, v in r["freeverb"].items()}
        steps = {k: (round(v["step_ms"], 3), round(v["busy_ms"], 3),
                     {n: round(t, 3) for n, t in v["kernel_ms"].items() if t})
                 for k, v in r.get("paths", {}).items()}
        print(f"{r['label']}: H1 a window {h1}, largest scale {big}; H2 "
              f"the hand window {r['h2']['window_ms']:.4f}, largest plane "
              f"{r['h2']['per_launch_ms'][0]:.4f}; scope_filter "
              f"{r['scope']}; freeverb_scan (ms, kernel ms) {fv}; steps ms "
              f"(step, device busy, the kernels') {steps}; {r['bad']} "
              f"disagreements; "
              f"{r['seconds']:.1f} s")
    print(json.dumps(result))
    return 1 if any(r["bad"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
