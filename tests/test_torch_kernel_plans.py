"""The host-side planning of two walk kernels, on the CPU.

freeverb_scan (csrc/freeverb_kernels.cu): its chunk at every rate from
1 Hz to 31999 Hz (ops/audio.freeverb_chunk), held to the shortest comb,
and a numpy copy of the kernel's schedule (chunk c walked and its
allpasses run while chunk c - 1 goes into the histories and chunk c + 1's
taps are read) held
against freeverb_scan_plain bit for bit, with a chunk longer than half the
shortest comb as the case it must catch.

H2 tilted_integral (csrc/haar_kernels.cu): its launch geometry
(ops/haar.tilted_plan), the plane at which it raises, and the elements of
a block of input or table rows that its bulk copies and single threads
move: each once, the bulk copies' ends 16-byte aligned in memory and in
shared memory.
"""

import numpy as np
import pytest
import torch

from gstbad_tpu_torch.ops import audio, haar

torch.set_num_threads(1)
F32 = np.float32
HIST = audio.FV_HIST
MASK = HIST - 1


@pytest.mark.parametrize("band", range(8))
def test_freeverb_chunk_every_rate(band):
    """Rates band*4000 + 1 .. (band+1)*4000 (31999 at most): where every
    ring holds a sample, a chunk of 1 to 256 samples, at most half the
    shortest comb, a multiple of 16 where half the comb allows one, and
    the longest comb and a chunk inside the history; else ValueError."""
    for rate in range(band * 4000 + 1, min((band + 1) * 4000 + 1, 32000)):
        sizes = audio.freeverb_sizes(rate)
        if min(int(v.min()) for v in sizes.values()) < 1:
            with pytest.raises(ValueError):
                audio.freeverb_chunk(rate)
            continue
        k = audio.freeverb_chunk(rate)
        dmin = int(min(sizes["combL"].min(), sizes["combR"].min()))
        dmax = int(max(sizes["combL"].max(), sizes["combR"].max()))
        assert 1 <= k <= audio.FV_MAX_CHUNK and 2 * k <= dmin, rate
        assert dmax + k <= HIST, rate
        if dmin // 2 >= 16:
            assert k % 16 == 0 and k > min(audio.FV_MAX_CHUNK, dmin // 2) - 16


def test_freeverb_chunk_values():
    assert [audio.freeverb_chunk(r) for r in (8000, 11025, 16000, 22050,
                                              24000, 31999)] \
        == [96, 128, 192, 256, 256, 256]
    with pytest.raises(ValueError):
        audio.freeverb_chunk(100)          # rings shorter than a sample
    with pytest.raises(ValueError):
        audio.freeverb_chunk(96000)        # combs longer than the history


def _schedule(state, x, params, rate, mono, k_chunk):
    """freeverb_scan_kernel's order of work in numpy float32: the
    histories, a = tap*damp2 and the walk's filterstores by chunk; in
    iteration c the walk of chunk c and chunk c's allpasses and mix (from
    the tap sums read the iteration before), chunk c - 1 into the
    histories, then chunk c + 1's taps and their sums."""
    s = audio.freeverb_sizes(rate)
    d = np.concatenate([s["combL"], s["combR"]]).astype(np.int64)
    ap_len = np.concatenate([s["apL"], s["apR"]]).astype(np.int64)
    p = {k: F32(v.item()) for k, v in params.items()}
    t0, n = int(state["t"]), x.shape[0]
    bufs = np.concatenate([state["combL_buf"].numpy(),
                           state["combR_buf"].numpy()])
    hist = np.zeros((16, HIST), F32)
    for r in range(16):
        j = np.arange(d[r])
        hist[r, (j - d[r]) & MASK] = bufs[r, (t0 + j) % d[r]]
    aps = [np.array(state[f"ap{'LR'[r // 4]}_buf"][r % 4, :ap_len[r]].numpy())
           for r in range(8)]
    st = np.concatenate([state["storeL"].numpy(), state["storeR"].numpy()])
    xn = x.numpy()
    if mono:
        in1 = ((F32(2) * xn + audio.DC_OFFSET) * p["gain"]).astype(F32)
        in1, dry = np.stack([in1, in1]), np.stack([xn, xn])
    else:
        in1 = ((xn + audio.DC_OFFSET) * p["gain"]).T.astype(F32)
        dry = xn.T
    y = np.zeros((n, 2), F32)
    chunks = -(-n // k_chunk)
    a_buf, s_buf = {}, {}
    side = np.repeat(np.arange(2), 8)

    def span(c):
        base = c * k_chunk
        return base, np.arange(min(k_chunk, n - base))

    sums = {}

    def taps(c):   # group A: a for the walk and the tap sums
        base, t = span(c)
        tp = hist[np.arange(16)[:, None], (base + t[None] - d[:, None]) & MASK]
        a_buf[c] = tp * p["damp2"]
        sums[c] = []
        for sd in range(2):
            sig = tp[8 * sd]
            for i in range(1, 8):
                sig = sig + tp[8 * sd + i]
            sums[c].append(sig)

    def allpass_mix(c):   # group B: the allpasses and the mix
        base, t = span(c)
        for sd in range(2):
            sig = sums[c][sd].copy()
            for j, tt in enumerate(t):
                v = sig[j]
                for i in range(4):
                    ring = aps[4 * sd + i]
                    q = (t0 + base + tt) % ring.shape[0]
                    b = ring[q]
                    ring[q] = v + b * F32(0.5)
                    v = b - v
                sig[j] = v
            y[base + t, sd] = sig - audio.DC_OFFSET
        outl, outr = y[base + t, 0].copy(), y[base + t, 1].copy()
        y[base + t, 0] = outl * p["wet1"] + outr * p["wet2"] \
            + dry[0, base + t] * p["dry"]
        y[base + t, 1] = outr * p["wet1"] + outl * p["wet2"] \
            + dry[1, base + t] * p["dry"]

    def commit(c):
        base, t = span(c)
        hist[:, (base + t) & MASK] = in1[side][:, base + t] \
            + s_buf[c] * p["feedback"]

    def walk(c):
        nonlocal st
        _, t = span(c)
        out = np.zeros((16, t.size), F32)
        for j in range(t.size):
            st = a_buf[c][:, j] + st * p["damp1"]
            out[:, j] = st
        s_buf[c] = out

    if chunks:
        taps(0)
    for c in range(chunks + 1):
        if c < chunks:
            walk(c)
            allpass_mix(c)
        if c > 0:
            commit(c - 1)
        if c + 1 < chunks:
            taps(c + 1)
    rings = bufs.copy()
    for r in range(16):
        j = np.arange(d[r])
        rings[r, (t0 + n + j) % d[r]] = hist[r, (n - d[r] + j) & MASK]
    return rings, aps, st, y


def _fv_case(rate, mono, seed):
    import gstbad_tpu_torch as gtt
    params = gtt.make("freeverb", damping=0.3,
                      **{"room-size": 0.8}).dynamic_params()
    rng = np.random.default_rng(seed)
    state = audio.freeverb_init_state(rate)
    # a first block, so the rings and the stores are no longer constant
    warm = torch.from_numpy(((rng.random((700,) if mono else (700, 2))
                              - 0.5) * 1.8).astype(F32))
    state, _ = audio.freeverb_scan_plain(state, warm, params, rate, mono)
    n = 3 * int(audio.freeverb_sizes(rate)["combL"].min()) + 5
    x = torch.from_numpy(((rng.random((n,) if mono else (n, 2)) - 0.5)
                          * 1.8).astype(F32))
    return state, x, params


@pytest.mark.parametrize("rate,mono", [(8000, False), (11025, True),
                                       (22050, False), (31999, True)])
def test_freeverb_schedule_equals_plain(rate, mono):
    """The kernel's schedule at freeverb_chunk(rate) gives the plain
    version's output and state bit for bit."""
    state, x, params = _fv_case(rate, mono, rate)
    rings, aps, st, y = _schedule(state, x, params, rate, mono,
                                  audio.freeverb_chunk(rate))
    ref, want = audio.freeverb_scan_plain(state, x, params, rate, mono)
    np.testing.assert_array_equal(y, want.numpy())
    np.testing.assert_array_equal(
        rings, np.concatenate([ref["combL_buf"], ref["combR_buf"]]))
    for r in range(8):
        np.testing.assert_array_equal(
            aps[r], ref[f"ap{'LR'[r // 4]}_buf"][r % 4, :aps[r].shape[0]])
    np.testing.assert_array_equal(
        st, np.concatenate([ref["storeL"], ref["storeR"]]))


def test_freeverb_schedule_needs_half_the_shortest_comb():
    """A chunk as long as the shortest comb reads taps the chunk before
    has not written yet: the output differs."""
    rate = 8000
    state, x, params = _fv_case(rate, False, 3)
    dmin = int(audio.freeverb_sizes(rate)["combL"].min())
    _, _, _, y = _schedule(state, x, params, rate, False, dmin)
    _, want = audio.freeverb_scan_plain(state, x, params, rate, False)
    assert (y != want.numpy()).any()


# -- H2 ----------------------------------------------------------------------

PLANES = [(1, 1), (2, 3), (3, 7), (10, 885), (10, 886), (10, 884),
          (100, 1052), (100, 1050), (115, 153), (480, 640), (436, 581),
          (720, 1280), (1080, 1920), (2160, 3840)]


@pytest.mark.parametrize("h,w", PLANES)
def test_tilted_plan_geometry(h, w):
    p = haar.tilted_plan(h, w)
    w1 = w + h + 2 * haar.TILT_PAD + 1
    assert p.cols in haar.TILT_COLS and p.cols % 2 == 1
    assert p.threads % 32 == 0 and 32 <= p.threads <= haar.TILT_MAX_THREADS
    assert p.cols * p.threads >= w1
    assert p.cols * (p.threads - 32) < w1          # no idle warp
    # the fewest columns a thread that keep the block at 256 threads
    if w1 <= haar.TILT_THREADS * haar.TILT_COLS[-1]:
        assert p.threads <= haar.TILT_THREADS
        smaller = [c for c in haar.TILT_COLS if c < p.cols]
        assert all(-(-w1 // c) > haar.TILT_THREADS for c in smaller)
    else:
        assert p.cols == haar.TILT_COLS[-1]


def test_tilted_plan_main_paths():
    """handdetect's largest plane: 256 threads of 5 columns; a 1080p plane
    256 of 13; a 4K plane 416 of 15."""
    assert haar.tilted_plan(480, 640) == haar.TiltPlan(5, 256)
    assert haar.tilted_plan(1080, 1920) == haar.TiltPlan(13, 256)
    assert haar.tilted_plan(2160, 3840) == haar.TiltPlan(15, 416)


@pytest.mark.parametrize("h", [1, 480, 1080, 2160])
def test_tilted_plan_raises_where_the_table_is_too_wide(h):
    """The widest plane of each height whose table fits the largest block
    (TILT_MAX_THREADS threads of 15 columns) has a plan; one column more
    raises."""
    w = haar.TILT_MAX_THREADS * haar.TILT_COLS[-1] - h - 2 * haar.TILT_PAD - 1
    assert haar.tilted_plan(h, w) == haar.TiltPlan(haar.TILT_COLS[-1],
                                                   haar.TILT_MAX_THREADS)
    for v in range(w + 1, w + 8):
        with pytest.raises(ValueError):
            haar.tilted_plan(h, v)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (10, 886), (480, 640),
                                 (481, 641), (1080, 1920)])
def test_tilted_block_elements(h, w):
    """The kernel's split of a block of RB rows (1, 2 or 4), one piece of
    memory, for every block of a tensor of 4 planes.  Table rows (1 + b*RB
    .., float64): the bulk copy takes elements [p, end), even in count,
    starting 16-byte aligned in memory (element o0 + first*w1 + p even)
    and in its shared region (index 2*p); single threads write the first
    element when p is 1 and the last when the count after p is odd; every
    element once, within one element of the block's size.  Input rows
    (b*RB .., float32) of a tensor that starts on a 16-byte boundary and
    is readable to the next boundary after its last float: one bulk copy
    of the 16-byte units around the block, inside the tensor, at most six
    floats longer than the block."""
    w1 = w + h + 2 * haar.TILT_PAD + 1
    for rows in (1, 2, 4):
        for plane in range(4):
            o0 = plane * (h + 1) * w1
            for first in range(1, h + 1, rows):
                n = (min(first + rows, h + 1) - first) * w1
                p = (o0 + first * w1) & 1
                end = p + ((n - p) & ~1)
                # the bulk copy [p, end) and the singles: element 0 when p
                # is 1, element n - 1 when end < n (at most one past end)
                singles = int(p == 1) + int(end < n)
                assert (end - p) % 2 == 0 and (o0 + first * w1 + p) % 2 == 0
                assert 0 <= p <= 1 and end <= n <= end + 1
                assert (end - p) + singles == n and p + n <= rows * w1 + 1
        # the input tensor: 4 planes from a 16-byte boundary, readable to
        # the next boundary after its last float (the wrapper's copy
        # where it is not)
        x_end = (4 * h * w + 3) & ~3
        for plane in range(4):
            for b in range(-(-h // rows)):
                s0 = (plane * h + b * rows) * w
                s1 = s0 + min(rows, h - b * rows) * w
                a0 = s0 - s0 % 4
                a1 = a0 + ((s1 - a0 + 3) & ~3)
                assert a0 % 4 == 0 and a1 % 4 == 0 and a0 <= s0 < s1 <= a1
                assert 0 <= a0 and a1 <= x_end
                assert a1 - a0 <= (s1 - s0 + 6) & ~3
