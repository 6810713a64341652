"""dryrun_multichip: the port's mesh paths on n logical shards, each
sharded run held bit for bit against the unsharded one (the port's
counterpart of the JAX package's __graft_entry__.dryrun_multichip).

    python -m gstbad_tpu_torch.parallel.dryrun 8        # on the card
    python -m gstbad_tpu_torch.parallel.dryrun 8 cpu    # on the host

  1. the table-fused headline (ten_element, 512x256, two windows): every
     node per shard, none gathered, the shard shapes checked;
  2. fisheye (the warp gather, by the gather rule);
  3. data-dependent emission: interlace -> ivtc and interlace ->
     fieldanalysis over two windows, frames and pts after compaction;
  4. the stateful temporal graph videodiff -> scenechange -> zebrastripe
     over two windows;
  5. bs2b on a window of audio blocks under dp (the JAX dry run has no
     audio case).

It runs on the card by default, the hand-written kernels on one mesh
entry per visible card repeated to n ([cuda:0] * n on one card, cuda:0..3
twice for n=8 on four), and raises where torch sees no card; device="cpu"
runs the kernels' plain versions on [cpu] * n.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _frames(res) -> tuple:
    return (np.concatenate([np.asarray(b.data) for b in res]),
            np.concatenate([np.asarray(b.pts) for b in res]))


def dryrun_multichip(n_devices: int = 8, device: str = "cuda") -> dict:
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.core.pipeline import parse_launch
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.parallel import make_mesh, shard_batch
    from gstbad_tpu_torch.parallel.mesh import resolve

    dev = resolve(device)
    devices = [dev] * n_devices
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", (dev.index + i) % count)
                   for i in range(n_devices)]
    sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // sp
    mesh = make_mesh(dp=dp, sp=sp, devices=devices)
    window = max(dp, 2)
    report = {"dp": dp, "sp": sp,
              "devices": sorted({str(d) for d in devices})}

    def run(build, use_mesh, n_windows=2):
        p = build()
        p.negotiate()
        p.compile(window, mesh=mesh if use_mesh else None)
        return _frames(p.run(n_frames=n_windows * window, window=window)), p

    def same(key, build, n_windows=2):
        (want, want_pts), _ = run(build, False, n_windows)
        (got, got_pts), p = run(build, True, n_windows)
        np.testing.assert_array_equal(got, want, err_msg=key)
        np.testing.assert_array_equal(got_pts, want_pts, err_msg=key)
        report[key] = p.shard_counts
        return p

    # 1. the fused headline: per shard, nothing gathered
    width, height = 512, 256
    p = same("headline", lambda: benchmarks.ten_element_graph(
        width, height, device=dev))
    gathered = {k: c["gather"] for k, c in p.shard_counts.items()
                if c["gather"]}
    if gathered:
        raise AssertionError(f"the headline gathered {gathered}")
    if p.shard_counts["zebrastripe"]["shard"] != 2 * n_devices:
        raise AssertionError(f"zebrastripe's tail ran "
                             f"{p.shard_counts['zebrastripe']} on "
                             f"{n_devices} shards over 2 windows")
    step = p.compile(window, mesh=mesh)
    _, leaves, _ = step(p.params(), p.init_states(window), None)
    leaf = leaves[-1]
    shapes = {tuple(fb.data.shape) for row in leaf.shards for fb in row}
    if shapes != {(window // dp, height // sp, width)} or \
            leaf.n_shards != n_devices:
        raise AssertionError(f"headline leaf shards {shapes}, "
                             f"{leaf.n_shards} of {n_devices}")
    report["headline_shard"] = (window // dp, height // sp, width)

    # 2. the warp gather
    same("fisheye", lambda: parse_launch(
        "videotestsrc pattern=ball width=256 height=64 format=BGRx "
        "! fisheye ! fakesink", device=dev), n_windows=1)

    # 3. data-dependent emission over two windows
    for key, tail in (("ivtc", "ivtc"), ("fieldanalysis", "fieldanalysis")):
        same(key, lambda tail=tail: parse_launch(
            "videotestsrc pattern=ball width=64 height=32 format=GRAY8 "
            f"framerate=24/1 ! interlace pattern=2:3 ! {tail} ! fakesink",
            device=dev))

    # 4. the stateful temporal graph, two windows through the step
    def temporal(use_mesh):
        p = parse_launch("videotestsrc pattern=ball width=64 height=32 "
                         "format=GRAY8 ! videodiff ! scenechange "
                         "! zebrastripe ! fakesink", device=dev)
        p.negotiate()
        step = p.compile(window, mesh=mesh if use_mesh else None)
        prm, st = p.params(), p.init_states(window)
        outs = []
        for _ in range(2):
            st, leaf, msgs = step(prm, st, None)
            if use_mesh:
                leaf[-1] = leaf[-1].gather()
            outs.append((leaf[-1].data.cpu().numpy(),
                         {k: {f: v.cpu().numpy() for f, v in m.items()}
                          for k, m in msgs.items()}))
        return outs, p

    want_t, _ = temporal(False)
    got_t, p = temporal(True)
    for (wd, wm), (gd, gm) in zip(want_t, got_t):
        np.testing.assert_array_equal(gd, wd)
        assert sorted(wm) == sorted(gm)
        for k in wm:
            for f in wm[k]:
                np.testing.assert_array_equal(gm[k][f], wm[k][f])
    report["temporal"] = p.shard_counts

    # 5. bs2b on audio blocks under dp
    x = (np.random.default_rng(0).random((window * dp, 256, 2)) - 0.5)
    spec = MediaSpec(kind="audio", format="F64", rate=48000, channels=2)

    def audio(use_mesh):
        p = parse_launch("bs2b fcut=800 feed=60 ! fakesink", device=dev)
        p.negotiate(spec)
        b = window * dp
        step = p.compile(b, mesh=mesh if use_mesh else None)
        batch = FrameBatch.make(torch.as_tensor(x, device=dev))
        if use_mesh:
            batch = shard_batch(batch, mesh)
        _, leaf, _ = step(p.params(), p.init_states(b), batch)
        out = leaf[-1].gather() if use_mesh else leaf[-1]
        return out.data.cpu().numpy(), p

    want_a, _ = audio(False)
    got_a, p = audio(True)
    np.testing.assert_array_equal(got_a, want_a)
    report["bs2b"] = p.shard_counts
    print(f"dryrun_multichip: ok on {n_devices} shards of "
          f"{', '.join(report['devices'])} (mesh "
          f"dp={dp} sp={sp}): the fused headline at {width}x{height} per "
          f"shard with no gather (leaf shard {report['headline_shard']}), "
          "fisheye, ivtc and fieldanalysis emission, videodiff -> "
          "scenechange -> zebrastripe and bs2b sharded == unsharded")
    return report


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
