"""netsim in the port against the JAX package on the CPU.

Tolerance: exact on the deterministic parts — the token bucket and the
drop-packets counter (H5's plain walk against the JAX scan on random
windows, carried state included), every probability at 0 and at 1, the
delays where min-delay equals max-delay, the reordering floor on given pts,
the doubled window and the frame's bits.  The random draws come from a
torch.Generator in the port and from JAX's PRNG in the JAX package, so the
delays are held in distribution: a two-sample KS test against scipy.stats'
draws of the same distribution (and against the JAX element's), and the
port's own gamma sampler against scipy.stats.gamma.  H5 itself
(csrc/netsim_kernels.cu) is held against its plain walk on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import netsim as netsim_ops
from helpers.torch_runtime import check_both

torch.set_num_threads(1)   # parallel test workers share the cores

SRC = "videotestsrc pattern=ball width=32 height=24 format=BGRx ! "
# a 32x24 BGRx frame is 24576 bits; at 30 frames/s 600 kbps gives 20000
# bits a frame interval, so the bucket runs dry and refills
BUCKET = "max-kbps=600 max-bucket-size=60"


@pytest.mark.parametrize("props", [
    BUCKET,
    BUCKET + " drop-packets=3",
    "max-kbps=-1 max-bucket-size=50",
    "max-kbps=0 max-bucket-size=100",
    "drop-packets=5",
    BUCKET + " drop-packets=2 allow-reordering=false",
    "max-kbps=2000 max-bucket-size=30 drop-packets=1 seed=9",
])
def test_bucket_and_counter_equal_the_jax_element(props):
    check_both(SRC + f"netsim {props} ! fakesink", 24, 8)


@pytest.mark.parametrize("props", [
    "drop-probability=1",
    "duplicate-probability=1",
    "duplicate-probability=1 " + BUCKET,
    "delay-probability=1 min-delay=30 max-delay=30",
    "delay-probability=1 duplicate-probability=1 min-delay=5 max-delay=5 "
    "delay-distribution=normal",
    "delay-probability=1 min-delay=70 max-delay=70 "
    "delay-distribution=gamma allow-reordering=false",
])
def test_probabilities_at_zero_and_one_equal_the_jax_element(props):
    check_both(SRC + f"netsim {props} ! fakesink", 16, 8)


def test_reordering_floor_on_given_pts():
    """allow-reordering=false on pts that go back in time, across two
    windows (the carried last-ready time): each late frame moves to one
    nanosecond after the latest pts emitted before it, as it came in (two
    late frames in a row land on the same time)."""
    pts = np.array([0, 40, 10, 90, 50, 50, 200, 30,
                    35, 400, 20, 401, 402, 10, 500, 499], np.int64) * 10**6
    frames = np.random.default_rng(3).integers(0, 256, (16, 6, 8, 4),
                                               dtype=np.uint8)

    def feed(p):
        p.get_by_name("s").push_frames(frames, pts=pts)
    desc = ("appsrc name=s format=BGRx width=8 height=6 ! netsim "
            "allow-reordering=false duplicate-probability=1 ! fakesink")
    (_, jres), (_, tres) = check_both(desc, 16, 8, feed)
    out = np.concatenate([b.pts for b in tres])
    assert (np.diff(out[:8]) >= 0).all() and out[2] == 40 * 10**6 + 1
    assert out[4] == out[5] == 90 * 10**6 + 1


def test_netsim_doubles_the_window():
    """The output window is 2B frames: the originals, then the duplicates
    (planar data too), and the frame's bits count every data plane."""
    el = gtt.make("netsim", **{"duplicate-probability": 1.0})
    el.set_info(MediaSpec(kind="video", format="I420", width=8, height=6))
    data = {"y": torch.arange(4 * 48, dtype=torch.uint8).reshape(4, 6, 8),
            "u": torch.zeros((4, 3, 4), dtype=torch.uint8),
            "v": torch.ones((4, 3, 4), dtype=torch.uint8)}
    batch = FrameBatch.make(data, pts=torch.arange(4) * 1000)
    _, out = el.process(el.dynamic_params(), el.init_state(4), batch)
    assert out.batch == 8 and out.valid.all()
    assert torch.equal(out.data["y"][4:], data["y"])
    assert el._frame_bits(batch) == 72 * 8


def _jax_scan(props, pts, valid, state=None):
    """The JAX element's bucket walk alone: its process at probability 0
    gives keep as the first half of valid, and its carried state."""
    import jax.numpy as jnp
    el = gt.make("netsim", **props)
    el.set_info(_jspec())
    state = state or el.init_state(len(pts))
    b = len(pts)
    batch = JFrameBatch(data=jnp.zeros((b, 6, 8, 4), jnp.uint8),
                        pts=jnp.asarray(pts), flags=jnp.zeros(b, jnp.int32),
                        valid=jnp.asarray(valid))
    new_state, out = el.process(el.dynamic_params(), state, batch)
    return np.asarray(out.valid)[:b], new_state


def _jspec():
    from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
    return JMediaSpec(kind="video", format="BGRx", width=8, height=6)


@pytest.mark.parametrize("seed", range(4))
def test_h5_plain_walk_equals_the_jax_scan(seed):
    """netsim_bucket_plain on random pts (some going back, some repeated)
    and validity, over three windows with the carry threaded through,
    against the JAX scan; 8x6 BGRx frames are 1536 bits."""
    rng = np.random.default_rng(seed)
    kbps = int(rng.choice([-1, 0, 30, 45, 100]))
    mbs = int(rng.choice([-1, 2, 5, 40]))
    props = {"max-kbps": kbps, "max-bucket-size": mbs,
             "drop-packets": int(rng.integers(0, 6))}
    el = gtt.make("netsim", **props)
    carry = el.init_state(16)["carry"]
    jstate = None
    t = 0
    for _ in range(3):
        steps = rng.integers(-20, 80, 16) * 10**6
        pts = t + np.cumsum(steps).astype(np.int64)
        t = int(pts[-1])
        valid = rng.random(16) < 0.8
        jkeep, jstate = _jax_scan(props, pts, valid, jstate)
        keep, carry = netsim_ops.netsim_bucket(
            torch.from_numpy(pts), torch.from_numpy(valid), 1536,
            torch.tensor(kbps, dtype=torch.int32),
            torch.tensor(mbs, dtype=torch.int32), carry)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        assert carry.tolist() == [int(jstate["bucket"]),
                                  int(jstate["prev_time"]),
                                  int(jstate["drop_packets"])]
    assert netsim_ops.netsim_bucket.launches == 0


def _delays(dist, n=4000, lo=20, hi=80):
    el = gtt.make("netsim", **{"delay-distribution": dist, "seed": 5,
                               "min-delay": lo, "max-delay": hi})
    el.set_info(_spec_video())
    gen = torch.Generator().manual_seed(5)
    return el._delay_ms((n,), el.dynamic_params(), gen).numpy()


def _spec_video():
    return MediaSpec(kind="video", format="BGRx", width=8, height=6)


def _reference(dist, n=4000, lo=20, hi=80):
    """scipy.stats' draws of the element's distribution, rounded as the
    element rounds them (gstnetsim.c:244-247, :277-285, :318-327)."""
    rng = np.random.default_rng(17)
    if dist == "uniform":
        return scipy.stats.randint(lo, hi + 1).rvs(n, random_state=rng)
    if dist == "normal":
        x = scipy.stats.norm((lo + hi) / 2, (hi - lo) / 3.92).rvs(
            n, random_state=rng)
    else:
        x = scipy.stats.gamma(1.25, scale=(hi - lo) / 3.4640381).rvs(
            n, random_state=rng) + lo
    return np.maximum(np.round(x), 0)


def _jax_delays(dist, n=4000, lo=20, hi=80):
    import jax
    el = gt.make("netsim", **{"delay-distribution": dist,
                              "min-delay": lo, "max-delay": hi})
    el.set_info(_jspec())
    return np.asarray(el._delay_ms(jax.random.PRNGKey(3), (n,),
                                   el.dynamic_params()))


@pytest.mark.parametrize("dist", ["uniform", "normal", "gamma"])
def test_delays_follow_their_distribution(dist):
    got = _delays(dist)
    assert got.min() >= 0 and np.all(got == np.round(got))
    assert scipy.stats.ks_2samp(got, _reference(dist)).pvalue > 1e-3
    assert scipy.stats.ks_2samp(got, _jax_delays(dist)).pvalue > 1e-3
    if dist == "uniform":
        assert got.min() == 20 and got.max() == 80


def test_gamma_sampler_follows_scipy():
    gen = torch.Generator().manual_seed(1)
    x = netsim_ops.gamma((20000,), 1.25, gen, "cpu").numpy()
    assert scipy.stats.kstest(x, scipy.stats.gamma(1.25).cdf).pvalue > 1e-3
    gen = torch.Generator().manual_seed(1)
    again = netsim_ops.gamma((20000,), 1.25, gen, "cpu").numpy()
    np.testing.assert_array_equal(x, again)


def test_draws_follow_the_seed_and_carry_across_windows():
    desc = (SRC + "netsim drop-probability=0.3 duplicate-probability=0.3 "
            "delay-probability=0.5 seed={} ! fakesink")

    def run(seed, window):
        res = gtt.parse_launch(desc.format(seed), device="cpu").run(
            n_frames=16, window=window)
        return np.concatenate([b.pts for b in res])
    a = run(4, 8)
    np.testing.assert_array_equal(a, run(4, 8))
    assert not np.array_equal(a, run(5, 8))
    jres = gt.parse_launch(desc.format(4)).run(n_frames=16, window=8)
    # about 0.7 x 1.3 of the frames come out in both packages
    n_j = sum(len(b.pts) for b in jres)
    assert abs(len(a) - n_j) <= 8 and 8 <= len(a) <= 24

