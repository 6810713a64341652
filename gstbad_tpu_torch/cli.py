"""Console entry points — launch (the gst-launch-1.0 analog) and
transcode (the gst-transcoder CLI analog, tools/gst-transcoder.c).

    python -m gstbad_tpu_torch transcode in.y4m out.y4m \\
        --filters "videoconvert format=AYUV ! gaussianblur ! \\
                   videoconvert format=I420" [--device cpu]
    python -m gstbad_tpu_torch transcode in.y4m out.gdp --profile gdp
    python -m gstbad_tpu_torch transcode in.gdp out_%d.pnm --profile pnm:RGB
    python -m gstbad_tpu_torch transcode in.y4m out.h265 --profile hevc:lossless
    python -m gstbad_tpu_torch transcode in.y4m out.ivf --profile av1
    python -m gstbad_tpu_torch launch videotestsrc ! solarize ! fakesink

Both run on the CUDA card unless --device cpu is given; without a card a
CUDA run raises.
"""

import argparse
import sys
import time


def _device_arg(ap):
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the graph runs (default cuda)")


def launch_main(argv=None):
    """gst-launch-1.0 analog: build a pipeline from a launch string,
    run it, print negotiated specs (-v), bus messages (-m) and a
    throughput summary."""
    ap = argparse.ArgumentParser(
        prog="torch-launch",
        description="Run a gst-launch style pipeline description "
                    "(gst-launch-1.0 analog).")
    ap.add_argument("pipeline", nargs="+",
                    help="launch description, e.g. videotestsrc ! "
                         "solarize ! fakesink")
    ap.add_argument("-n", "--frames", type=int, default=64,
                    help="number of frames/buffers to run")
    ap.add_argument("-w", "--window", type=int, default=8)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print negotiated per-element specs "
                         "(gst-launch -v analog)")
    ap.add_argument("-m", "--messages", action="store_true",
                    help="print bus messages (gst-launch -m analog)")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from gstbad_tpu_torch.core.pipeline import parse_launch

    pipe = parse_launch(" ".join(args.pipeline), device=args.device)
    print(f"Setting pipeline to PAUSED ... ({len(pipe.elements)} "
          "elements)", file=sys.stderr)
    pipe.negotiate()
    if args.verbose:
        for el in pipe.elements:
            if el.out_spec is not None:
                print(f"  {el.NAME}: {el.out_spec}", file=sys.stderr)
    print("Setting pipeline to PLAYING ...", file=sys.stderr)
    t0 = time.perf_counter()
    outs = pipe.run(n_frames=args.frames, window=args.window)
    dt = time.perf_counter() - t0
    pipe.close()
    batches = outs if isinstance(outs, list) else outs[0]
    n = sum(o.batch for o in batches)
    if args.messages:
        for msg in pipe.bus.messages:
            print(f"  message: {msg.element} {msg.name} "
                  f"pts={msg.pts} {msg.fields}", file=sys.stderr)
    print("Got EOS from element \"pipeline0\".", file=sys.stderr)
    print(f"Execution ended after {dt:.3f}s — {n} buffers"
          + (f" ({n / dt:.1f}/s)" if dt > 0 and n else ""),
          file=sys.stderr)
    return 0


def transcode_main(argv=None):
    """gst-transcoder analog: a y4m or GDP file through a filter chain
    into a y4m file, a PNM image sequence or a GDP stream."""
    ap = argparse.ArgumentParser(
        prog="torch-transcode",
        description="Transcode a y4m or .gdp file through a gst-launch "
                    "style filter chain (gst-transcoder analog).")
    ap.add_argument("src")
    ap.add_argument("dest")
    ap.add_argument("--filters", default="",
                    help="gst-launch style filter chain")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--profile", default="y4m",
                    help="encoding profile: y4m[:FMT], pnm[:FMT] (dest "
                         "holds a %%d pattern), gdp[:FMT], "
                         "hevc[:qp=N|:lossless] (libx265) or "
                         "av1[:bitrate=N] (libaom, IVF)")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from gstbad_tpu_torch.session import Transcoder

    def progress(pos, total):
        pct = 100.0 * pos / total if total else 0.0
        print(f"\rposition {pos / 1e9:.2f}s / {total / 1e9:.2f}s "
              f"({pct:.0f}%)", end="", file=sys.stderr)

    t = Transcoder(args.src, args.dest, args.filters, window=args.window,
                   profile=args.profile, on_position=progress,
                   device=args.device)
    frames = t.run()
    print(f"\nwrote {frames} frames to {args.dest}", file=sys.stderr)
    return 0


def main(argv=None):
    """`launch ...` or `transcode ...`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"launch": launch_main, "transcode": transcode_main}
    if not argv or argv[0] not in commands:
        print("usage: python -m gstbad_tpu_torch {launch,transcode} ...",
              file=sys.stderr)
        return 2
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
