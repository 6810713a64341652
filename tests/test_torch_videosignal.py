"""videosignal in the port against the JAX package on the CPU:
videoanalyse's luma messages, simplevideomark's frames and
simplevideomarkdetect's decoded marks, in GRAY8, I420 and AYUV, exact
(frames, pts, flags, valid and bus messages; the float64 statistics bit
for bit)."""

import pytest

from helpers.torch_runtime import check_both


def src(fmt, pattern="ball"):
    return (f"videotestsrc pattern={pattern} width=48 height=24 "
            f"format={fmt} ! ")


@pytest.mark.parametrize("fmt,pattern", [("GRAY8", "gradient"),
                                         ("I420", "ball"),
                                         ("AYUV", "bars")])
def test_videoanalyse(fmt, pattern):
    (_, _), (tp, _) = check_both(
        src(fmt, pattern) + "videoanalyse ! fakesink", 6, 3)
    assert len(tp.bus.messages) == 6
    m = tp.bus.messages[0]
    assert sorted(m.fields) == ["luma-average", "luma-variance"]


@pytest.mark.parametrize("fmt", ["GRAY8", "AYUV"])
def test_simplevideomark(fmt):
    check_both(src(fmt) + "simplevideomark pattern-data=21 "
               "pattern-width=3 pattern-height=5 bottom-offset=2 "
               "left-offset=4 ! fakesink", 4, 2)


@pytest.mark.parametrize("fmt,mark", [
    ("I420", "simplevideomark pattern-data=19 ! "),
    ("GRAY8", "simplevideomark pattern-data=7 pattern-count=3 "
              "pattern-data-count=6 ! "),
])
def test_simplevideomarkdetect_reads_the_mark(fmt, mark):
    (_, _), (tp, _) = check_both(
        src(fmt) + mark + "simplevideomarkdetect "
        + " ".join(t for t in mark.split() if t.startswith("pattern-c")
                   or t.startswith("pattern-data-c")) + " ! fakesink", 4, 2)
    want = int(mark.split("pattern-data=")[1].split()[0])
    assert [(m["have-pattern"], m["pattern-data"])
            for m in tp.bus.messages] == [(True, want)] * 4
