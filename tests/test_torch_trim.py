"""Trims in the port: audiosegmentclip and avwait (video alone, and video
plus audio through `pad` pickers) against the JAX package on the CPU.
Start and stop values cut inside a block, fall on a block's edge, and lie
outside the stream; the runner's host-side cut (_split_trimmed) gives the
split batches' shapes, pts and samples, all compared exactly, with the
bus messages."""

import pytest

from helpers.torch_runtime import check_both

# 480 samples at 48 kHz: 10 ms blocks, 8 blocks in windows of 4
CLIP = ("audiotestsrc wave=sine freq=440 channels=2 format=S16 "
        "samplesperbuffer=480 ! audiosegmentclip start={start} stop={stop} "
        "! fakesink")


@pytest.mark.parametrize("start,stop", [
    (15_000_000, 55_500_000),     # both inside a block
    (20_000_000, 40_000_000),     # both on block edges
    (0, -1),                      # the whole stream
    (35_000_000, -1),             # a head cut, no stop
    (0, 5_000_000),               # a tail cut in the first block
    (25_000_000, 45_000_000),     # cuts in one window's two blocks
    (900_000_000, -1),            # after the stream: nothing passes
])
def test_audiosegmentclip(start, stop):
    (_, jres), _ = check_both(CLIP.format(start=start, stop=stop), 8, 4)
    if start >= 900_000_000:
        assert jres == []


VIDEO = "videotestsrc pattern=ball width=16 height=8 format=GRAY8 "


@pytest.mark.parametrize("props", [
    "mode=running-time target-running-time=100000000",
    "mode=running-time target-running-time=1 end-running-time=150000000",
    "mode=timecode target-timecode-string=00:00:00:05",
    "mode=timecode target-timecode-string=00:00:00:02 "
    "end-timecode-string=00:00:00:09",
    "mode=video-first recording=false",
    "mode=running-time target-running-time=999000000",
])
def test_avwait_video(props):
    check_both(VIDEO + f"! avwait {props} ! fakesink", 12, 4)


AV = ("videotestsrc pattern=ball width=16 height=8 framerate=10/1 ! w.  "
      "audiotestsrc wave=sine samplesperbuffer={spb} ! w.  "
      "avwait name=w {props}  "
      "w. ! pad index=0 ! fakesink  "
      "w. ! pad index=1 ! fakesink")


@pytest.mark.parametrize("spb,props", [
    (3200, "mode=running-time target-running-time=250000000"),
    (4800, "mode=running-time target-running-time=300000000"),
    (3200, "mode=running-time target-running-time=250000000 "
           "end-running-time=550000000"),
    (4800, "mode=timecode target-timecode-string=00:00:00:03"),
    (3000, "mode=video-first end-running-time=412000000"),
])
def test_avwait_video_and_audio(spb, props):
    (_, jres), _ = check_both(AV.format(spb=spb, props=props), 10, 5)
    assert jres[0] and jres[1]
