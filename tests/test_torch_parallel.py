"""The port's mesh (gstbad_tpu_torch/parallel/) against its own unsharded
step and against the JAX package's unsharded step: every case of
tests/test_parallel.py on a [cpu] * 8 mesh at dp=4/sp=2 and dp=8/sp=1,
the shard rules' counters, the mesh errors and dryrun_multichip(8)."""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.frame import FrameBatch, map_tensors
from gstbad_tpu_torch.core.registry import make
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.elements.debugutils import FakeSink
from gstbad_tpu_torch.parallel import (make_mesh, pipeline_shardings,
                                       shard_batch, shard_spatial)

CPU = torch.device("cpu")
MESHES = [(4, 2), (8, 1)]
_JAX = {}   # the JAX package's unsharded results, shared by both meshes


@pytest.fixture(params=MESHES, ids=lambda m: f"dp{m[0]}sp{m[1]}")
def mesh(request):
    dp, sp = request.param
    return make_mesh(dp=dp, sp=sp, devices=[CPU] * 8)


def _bytes(a):
    """A host leaf as bytes: a word-keeping sink's int32 words viewed as
    their four bytes."""
    a = np.asarray(a)
    if a.dtype in (np.int32, np.uint32) and a.ndim == 3:
        return np.ascontiguousarray(a).view(np.uint8).reshape(a.shape + (4,))
    return a


def _msgs(m):
    return {k: {f: np.asarray(v) for f, v in fields.items()}
            for k, fields in m.items()}


def _jax_windows(key, desc, spec, frames, window, source=False):
    """The JAX package's unsharded step over consecutive windows:
    [(data bytes, valid, messages)], cached under `key`."""
    if key not in _JAX:
        import jax.numpy as jnp
        p = gt.parse_launch(desc)
        p.negotiate(None if spec is None else JMediaSpec(**spec))
        step = p.compile(window, jit=True, donate_state=False)
        params, states = p.params(), p.init_states(window)
        outs = []
        for i in range(len(frames) if not source else frames):
            b = None if source else JFrameBatch.make(jnp.asarray(frames[i]))
            states, leaf, m = step(params, states, b)
            outs.append((_bytes(leaf[-1].data), np.asarray(leaf[-1].valid),
                         _msgs(m)))
        _JAX[key] = outs
    return _JAX[key]


def _port_windows(desc, spec, frames, window, mesh=None, source=False):
    """The port's step over consecutive windows, sharded on `mesh` or not
    (`desc` a launch line or a function that builds the pipeline):
    ([(data bytes, valid, messages)], pipeline, last leaf)."""
    p = desc() if callable(desc) else gtt.parse_launch(desc, device="cpu")
    p.negotiate(None if spec is None else MediaSpec(**spec))
    step = p.compile(window, mesh=mesh)
    params, states = p.params(), p.init_states(window)
    outs, leaf = [], None
    for i in range(len(frames) if not source else frames):
        b = None
        if not source:
            b = FrameBatch.make(torch.as_tensor(frames[i]))
            if mesh is not None:
                b = shard_batch(b, mesh)
        states, leaves, m = step(params, states, b)
        leaf = leaves[-1]
        whole = leaf.gather() if mesh is not None else leaf
        outs.append((_bytes(whole.data.numpy()), whole.valid.numpy(),
                     _msgs(m)))
    return outs, p, leaf


def _check(key, desc, spec, frames, window, mesh, source=False,
           lsb=0, share=1.0, atol=None):
    """Port sharded == port unsharded bit for bit; port == JAX unsharded
    within the JAX tests' own tolerance."""
    want, _, _ = _port_windows(desc, spec, frames, window, None, source)
    got, p, leaf = _port_windows(desc, spec, frames, window, mesh, source)
    for (wd, wv, wm), (gd, gv, gm) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gv, wv)
        assert sorted(gm) == sorted(wm)
        for k in wm:
            for f in wm[k]:
                np.testing.assert_array_equal(gm[k][f], wm[k][f])
    jax_out = _jax_windows(key, desc, spec, frames, window, source)
    for (jd, jv, jm), (gd, gv, gm) in zip(jax_out, got):
        np.testing.assert_array_equal(gv, jv)
        jd, gd = jd[jv], gd[gv]
        if atol is not None:
            np.testing.assert_allclose(gd, jd, rtol=0, atol=atol)
        elif lsb:
            diff = np.abs(gd.astype(np.int64) - jd.astype(np.int64))
            assert diff.max() <= lsb
            assert (diff > 0).mean() < share
        else:
            np.testing.assert_array_equal(gd, jd)
    return got, p, leaf


BGRX = dict(kind="video", format="BGRx", width=128, height=32)


def test_sharded_pointops_match_unsharded(rng, mesh):
    img = rng.integers(0, 256, (8, 32, 128, 4), dtype=np.uint8)
    _, p, leaf = _check("pointops", "burn ! solarize ! chromahold "
                        "! fakesink", BGRX, [img], 8, mesh)
    assert all(c["gather"] == 0 for c in p.shard_counts.values())


def test_sharded_blur_halo_exchange(rng, mesh):
    """gaussianblur takes its radius of rows from the neighbouring sp
    shards; the JAX CPU path is its XLA blur, within 1 LSB."""
    img = rng.integers(0, 256, (8, 64, 128, 4), dtype=np.uint8)
    spec = dict(kind="video", format="AYUV", width=128, height=64)
    _, p, _ = _check("blur", "gaussianblur sigma=2.0 ! fakesink", spec,
                     [img], 8, mesh, lsb=1, share=1e-4)
    halos = p.shard_counts["gaussianblur"]["halo"]
    assert halos == (8 if mesh.sp > 1 else 0)
    assert p.shard_counts["gaussianblur"]["shard"] == 8


def test_output_actually_sharded(rng, mesh):
    img = rng.integers(0, 256, (8, 32, 128, 4), dtype=np.uint8)
    p = gtt.parse_launch("burn ! fakesink", device="cpu")
    p.negotiate(MediaSpec(**BGRX))
    batch = shard_batch(FrameBatch.make(torch.as_tensor(img)), mesh)
    plan = pipeline_shardings(mesh, FrameBatch.make(torch.as_tensor(img)))
    step = p.compile(8, mesh=mesh)
    _, leaf, _ = step(p.params(), p.init_states(8), batch)
    out = leaf[-1]
    assert out.n_shards == 8
    assert plan.data == ("dp", "sp" if mesh.sp > 1 else None, None, None)
    assert out.spec(4) == plan.data and batch.spec(1) == plan.pts
    shapes = {tuple(fb.data.shape) for row in out.shards for fb in row}
    assert shapes == {(8 // mesh.dp, 32 // mesh.sp, 128, 4)}


def test_pipeline_compile_with_mesh(mesh):
    """A source graph compiled straight onto the mesh: the source
    generates the window, which is split."""
    desc = ("videotestsrc pattern=bars width=128 height=32 format=BGRx "
            "! burn ! solarize ! fakesink")
    _, p, leaf = _check("compile_mesh", desc, None, 1, 8, mesh, source=True)
    assert leaf.n_shards == 8
    assert p.shard_counts["videotestsrc"]["split"] == 1


def test_sharded_digitalzoom_matches_unsharded(rng, mesh):
    """digitalzoom's resample mixes rows across sp shards: the gather
    rule runs it on the whole window, so the port's sharded run equals its
    unsharded one exactly; the JAX package within its 1 LSB."""
    img = rng.integers(0, 256, (8, 32, 128, 4), dtype=np.uint8)
    spec = dict(kind="video", format="AYUV", width=128, height=32)
    _, p, _ = _check("digitalzoom", "digitalzoom zoom=2.0 ! fakesink", spec,
                     [img], 8, mesh, lsb=1)
    assert p.shard_counts["digitalzoom"]["gather"] == 1


def test_sharded_audio_scan_elements(rng, mesh):
    """bs2b carries scan state across the window's blocks: the gather
    rule threads it exactly."""
    x = (rng.random((8, 256, 2)) - 0.5).astype(np.float64)
    spec = dict(kind="audio", format="F64", rate=48000, channels=2)
    _, p, _ = _check("bs2b", "bs2b fcut=800 feed=60 ! fakesink", spec,
                     [x], 8, mesh, atol=1e-12)
    assert p.shard_counts["bs2b"]["gather"] == 1


def test_multihost_feed_window_single_process(rng, mesh):
    """feed_window degrades to shard_batch in one process."""
    from gstbad_tpu_torch.parallel import feed_window
    img = rng.integers(0, 256, (8, 32, 128, 4), dtype=np.uint8)
    pts = np.arange(8, dtype=np.int64) * 33_000_000
    batch = feed_window(mesh, img, pts)
    assert batch.spec(4) == ("dp", "sp" if mesh.sp > 1 else None, None,
                             None)
    np.testing.assert_array_equal(batch.pts.numpy(), pts)
    p = gtt.parse_launch("burn ! fakesink", device="cpu")
    p.negotiate(MediaSpec(**BGRX))
    step = p.compile(8, mesh=mesh)
    _, leaf, _ = step(p.params(), p.init_states(8), batch)
    got = _bytes(leaf[-1].gather().data.numpy())
    want = _jax_windows("feed", "burn ! fakesink", BGRX, [img], 8)[0][0]
    np.testing.assert_array_equal(got, want)


def test_sharded_videodiff_state_spans_windows(rng, mesh):
    """videodiff differences consecutive frames across the dp shards and
    the window boundary (gstvideodiff.c:128-174): the gather rule."""
    frames = rng.integers(0, 256, (16, 32, 128), dtype=np.uint8)
    spec = dict(kind="video", format="GRAY8", width=128, height=32)
    _check("videodiff", "videodiff ! fakesink", spec,
           [frames[:8], frames[8:]], 8, mesh)


def test_sharded_scenechange_messages_span_windows(rng, mesh):
    """scenechange's 5-score ring over windows: the same decisions and
    counts (gstscenechange.c:147-160)."""
    frames = np.zeros((16, 32, 128), np.uint8)
    frames[:5] = 30
    frames[5:11] = 200
    frames[11:] = rng.integers(0, 40, (5, 32, 128), dtype=np.uint8)
    spec = dict(kind="video", format="GRAY8", width=128, height=32)
    got, _, _ = _check("scenechange", "scenechange ! fakesink", spec,
                       [frames[:8], frames[8:]], 8, mesh)
    assert any(m for _, _, m in got)


def test_sharded_ivtc_matches_unsharded(mesh):
    """interlace 2:3 -> ivtc holds a field queue across windows
    (gstivtc.c:284-307); frames and validity equal, sharded or not."""
    desc = ("videotestsrc pattern=ball width=128 height=32 format=GRAY8 "
            "framerate=24/1 ! interlace pattern=2:3 ! ivtc ! fakesink")
    _, p, leaf = _check("ivtc", desc, None, 2, 8, mesh, source=True)
    assert leaf.n_shards == 8
    assert p.shard_counts["ivtc"]["gather"] == 2


def test_headline_runs_per_shard_and_ivtc_gathers(monkeypatch):
    """The counters: the fused headline runs every node per shard (its
    fused tail, K1's plain version here, once a shard a window) and
    gathers nothing; ivtc and digitalzoom take the gather rule."""
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.ops import chainfuse
    calls = []
    orig = chainfuse.dilate_zebra_fused
    monkeypatch.setattr(chainfuse, "dilate_zebra_fused",
                        lambda *a, **k: calls.append(a[0].shape)
                        or orig(*a, **k))
    mesh = make_mesh(dp=4, sp=2, devices=[CPU] * 8)
    want = benchmarks.ten_element_graph(128, 32, device="cpu").run(
        n_frames=16, window=8)
    calls.clear()
    p = benchmarks.ten_element_graph(128, 32, device="cpu")
    p.negotiate()
    p.compile(8, mesh=mesh)
    got = p.run(n_frames=16, window=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.data, w.data)
    assert len(calls) == 16
    # a band of 16 rows with its halo row: 17 rows of the broadcast base
    assert set(calls) == {(1, 17, 128)}
    assert all(c["gather"] == 0 for c in p.shard_counts.values())
    assert p.shard_counts["zebrastripe"]["shard"] == 16
    assert p.shard_counts["coloreffects"]["halo"] == 16
    q = gtt.parse_launch("videotestsrc pattern=ball width=64 height=32 "
                         "format=GRAY8 framerate=24/1 ! interlace "
                         "pattern=2:3 ! ivtc ! fakesink", device="cpu")
    q.negotiate()
    q.compile(8, mesh=mesh)
    q.run(n_frames=16, window=8)
    assert q.shard_counts["ivtc"] == {"shard": 0, "halo": 0, "gather": 2,
                                      "split": 0}
    assert q.shard_counts["interlace"]["gather"] == 2


def test_two_stencils_in_one_chain(rng):
    """Two dilates in one table chain: the chain's halo covers both radii
    (the port's PR 1 review fault, now across shards)."""
    mesh = make_mesh(dp=2, sp=4, devices=[CPU] * 8)
    img = rng.integers(0, 256, (4, 32, 64, 4), dtype=np.uint8)
    spec = dict(kind="video", format="BGRx", width=64, height=32)
    _check("two_dilates", "burn ! dilate ! dilate ! fakesink", spec, [img],
           4, mesh)
    desc = ("videotestsrc pattern=ball width=64 height=32 format=BGRx "
            "! coloreffects preset=sepia ! dilate ! dilate ! videoconvert "
            "format=AYUV ! zebrastripe ! fakesink")
    want, _, _ = _port_windows(desc, None, 2, 4, None, source=True)
    got, _, _ = _port_windows(desc, None, 2, 4, mesh, source=True)
    for (wd, wv, _), (gd, gv, _) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)


def test_indivisible_axes_raise_or_stay_whole(rng):
    """shard_batch raises where JAX's device_put does; a step's own
    values keep an axis that does not divide whole, as JAX's `_sh` drops
    it from the spec."""
    import jax
    import jax.numpy as jnp
    from gstbad_tpu.parallel import make_mesh as jmake_mesh
    from gstbad_tpu.parallel import shard_batch as jshard_batch
    mesh = make_mesh(dp=4, sp=2, devices=[CPU] * 8)
    jmesh = jmake_mesh(dp=4, sp=2, devices=jax.devices()[:8])
    for shape in ((8, 15, 16, 4), (6, 16, 16, 4)):
        with pytest.raises(ValueError):
            jshard_batch(JFrameBatch.make(jnp.zeros(shape, jnp.uint8)),
                         jmesh)
        with pytest.raises(ValueError, match="divisible"):
            shard_batch(FrameBatch.make(torch.zeros(shape,
                                                    dtype=torch.uint8)),
                        mesh)
    desc = ("videotestsrc pattern=ball width=64 height=33 format=BGRx "
            "! burn ! fakesink")
    want, _, _ = _port_windows(desc, None, 1, 8, None, source=True)
    got, _, leaf = _port_windows(desc, None, 1, 8, mesh, source=True)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert leaf.spec(4) == ("dp", None, None, None)


def test_shards_keep_the_word_a_view_and_know_their_place(rng):
    mesh = make_mesh(dp=4, sp=2, devices=[CPU] * 8)
    img = torch.as_tensor(rng.integers(0, 256, (8, 32, 16, 4),
                                       dtype=np.uint8))
    word = img.view(torch.int32)[..., 0]
    sb = shard_batch(FrameBatch.make(img).replace(word=word), mesh)
    for d, row in enumerate(sb.shards):
        for s, fb in enumerate(row):
            assert fb.word.data_ptr() == fb.data.data_ptr()
            assert (fb.shard.frame0, fb.shard.part) == (2 * d, s)
            torch.testing.assert_close(fb.data, img[2 * d:2 * d + 2,
                                                    16 * s:16 * s + 16])
    whole = sb.gather()
    assert torch.equal(whole.data, img)
    assert whole.word.data_ptr() == whole.data.data_ptr()
    bands = shard_spatial(img[:1], mesh)
    assert [tuple(b.shape) for b in bands] == [(1, 4, 16, 4)] * 8
    assert torch.equal(torch.cat(bands, 1), img[:1])


def test_make_mesh_errors():
    with pytest.raises(ValueError, match=r"dp\*sp = 3\*2 != 8 devices"):
        make_mesh(dp=3, sp=2, devices=[CPU] * 8)
    assert make_mesh(dp=0, sp=2, devices=[CPU] * 8).shape == {"dp": 4,
                                                              "sp": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(dp=2, devices=["cuda:0", "cuda:0"])
    p = gtt.parse_launch("burn ! fakesink", device="cpu")
    p.negotiate(MediaSpec(**BGRX))
    from gstbad_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match="first device"):
        p.compile(8, mesh=Mesh([[torch.device("meta")]]))


def _storages(tree) -> set:
    """The data pointers of the non-empty tensors in an element's
    attributes (their dicts, lists and tuples)."""
    out = set()
    map_tensors(lambda t: out.add(t.data_ptr()) if isinstance(
        t, torch.Tensor) and t.numel() else None, tree)
    return out


class _KeptSink(FakeSink):
    """fakesink holding a tensor behind an `is None` guard in prepare()."""

    _kept = None

    def prepare(self):
        super().prepare()
        if self._kept is None:
            self._kept = torch.zeros(4, dtype=torch.int32,
                                     device=self.device)


def test_replicas_on_another_device(monkeypatch):
    """The branch a mesh over several cards takes, on the host: sp column
    1 is `cpu:0`, another torch device than the pipeline's `cpu`, and a
    move there copies, as a move to another card does.  Each per-shard
    element runs there as a copy that is prepared on that device and holds
    no tensor of the pipeline's element, and the sharded run equals the
    unsharded one."""
    from gstbad_tpu_torch.parallel import step as steps
    other = torch.device("cpu", 0)
    move = steps._move
    monkeypatch.setattr(steps, "_move", lambda tree, dev: map_tensors(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
        move(tree, dev)) if dev == other else move(tree, dev))
    seen = {}
    element = steps.ShardPlan.element

    def spy(plan, el, dev):
        rep = element(plan, el, dev)
        seen[(el.NAME, dev)] = (el, rep)
        return rep

    monkeypatch.setattr(steps.ShardPlan, "element", spy)
    mesh = make_mesh(dp=4, sp=2, devices=[CPU, other] * 4)

    def build():
        # the sink keeps a tensor that prepare() builds only once: a copy
        # shares it until the copy's tensors are moved
        return gtt.Pipeline([
            make("videotestsrc", pattern="ball", width=64, height=32,
                 format="BGRx"),
            make("burn"), make("dilate"), make("videoconvert", format="AYUV"),
            make("gaussianblur", sigma=1.5), make("zebrastripe"),
            _KeptSink()], device="cpu")

    want, _, _ = _port_windows(build, None, 2, 8, None, source=True)
    got, p, _ = _port_windows(build, None, 2, 8, mesh, source=True)
    for (wd, wv, _), (gd, gv, _) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gv, wv)
    names = {"burn", "dilate", "videoconvert", "gaussianblur",
             "zebrastripe", "fakesink"}
    assert {n for n, d in seen if d == other} == names
    assert p.shard_counts["gaussianblur"]["halo"] == 16
    for (name, dev), (el, rep) in seen.items():
        if dev == CPU:
            assert rep is el, name
            continue
        assert rep is not el and rep.device == other, name
        assert not _storages(vars(rep)) & _storages(vars(el)), name
    blur_el, blur_rep = seen[("gaussianblur", other)]
    assert blur_rep._tables is not blur_el._tables
    assert seen[("fakesink", other)][1]._kept is not None


def test_dryrun_multichip_8():
    from gstbad_tpu_torch.parallel.dryrun import dryrun_multichip
    if not torch.cuda.is_available():
        # the card is the default, and nothing falls back to the host
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(8)
    report = dryrun_multichip(8, "cpu")
    assert (report["dp"], report["sp"]) == (4, 2)
    assert report["headline_shard"] == (1, 128, 512)
    assert report["ivtc"]["ivtc"]["gather"] == 2
    assert report["bs2b"]["bs2b"]["gather"] == 1
