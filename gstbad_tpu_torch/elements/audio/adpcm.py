"""adpcmdec and adpcmenc (gst/adpcmdec/adpcmdec.c, gst/adpcmenc/adpcmenc.c):
IMA/DVI and Microsoft ADPCM.

The decoders' recurrences are serial per channel and independent across
blocks; the encoder's step index carries across blocks.  Each is one
hand-written CUDA kernel on the card (csrc/adpcm_kernels.cu, through
ops/audio.adpcm_ima_decode / adpcm_ms_decode / adpcm_ima_encode) and its
plain walk on the CPU.  The byte packing around them is tensor reshapes.

adpcmdec is a host source: push bytes with push_bytes; it emits one
block per frame slot (the reference's block-aligned chain,
adpcmdec.c:398-454) as interleaved S16.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, to_device
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.ops import audio as ops


@register
class AdpcmDec(Element):
    NAME = "adpcmdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("layout", str, "dvi", static=True),  # dvi | microsoft
        Property("blocksize", int, 1024, 8, None, static=True),
        Property("rate", int, 44100, 1, None, static=True),
        Property("channels", int, 1, 1, 2, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0

    def negotiate(self, in_spec):
        require(self.props["layout"] in ("dvi", "microsoft"),
                f"adpcmdec: bad layout {self.props['layout']!r} "
                "(want dvi or microsoft)")
        bs, ch = self.props["blocksize"], self.props["channels"]
        if self.props["layout"] == "dvi":
            require(bs >= 4 * ch, "adpcmdec: blocksize < dvi header")
            self._n_samples = (bs - 4 * ch) * 2 + ch
            # the code region must form whole 8-sample groups per channel
            require((self._n_samples - ch) % (8 * ch) == 0,
                    "adpcmdec: blocksize not group-aligned for dvi")
        else:
            require(bs >= 7 * ch, "adpcmdec: blocksize < ms header")
            self._n_samples = (bs - 7 * ch) * 2 + 2 * ch
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=self.props["rate"], channels=ch)

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def pull_window(self, window: int):
        bs = self.props["blocksize"]
        n = min(len(self._buf) // bs, window)
        if n == 0:
            return None
        blocks = np.frombuffer(self._buf[: n * bs], np.uint8).reshape(n, bs)
        self._buf = self._buf[n * bs:]
        # _n_samples counts interleaved samples; duration is per channel
        dur = (self._n_samples // self.props["channels"]
               ) * 1_000_000_000 // self.props["rate"]
        pts = (self._n + np.arange(n, dtype=np.int64)) * dur
        self._n += n
        data, pts = to_device(self.device, blocks, pts)
        return FrameBatch.make(data, pts=pts)

    def process(self, params, state, batch: FrameBatch):
        ch = self.props["channels"]
        if self.props["layout"] == "dvi":
            out = ops.adpcm_ima_decode(batch.data, ch)
        else:
            out = ops.adpcm_ms_decode(batch.data, ch)
        return state, batch.with_data(out)


@register
class AdpcmEnc(Element):
    """adpcmenc (gst/adpcmenc/adpcmenc.c): the DVI/IMA encoder.  S16 blocks
    of samples-per-block in, uint8 ADPCM blocks out; the step index
    carries across blocks, prev resets to each block's header sample."""

    NAME = "adpcmenc"
    PROPERTIES = (
        Property("layout", str, "dvi", static=True),
        Property("blocksize", int, 1024, 8, 8192, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(self.props["layout"] == "dvi",
                "adpcmenc: only the dvi layout exists in the reference")
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16,
                "adpcmenc: needs S16 audio")
        ch = in_spec.channels
        bs = self.props["blocksize"]
        require((bs - 4 * ch) % (4 * ch) == 0,
                f"adpcmenc: blocksize {bs} not group-aligned "
                f"for {ch} channels")
        self._groups = (bs - 4 * ch) // (4 * ch)
        self._n_samples = 1 + 8 * self._groups
        self._channels = ch
        return MediaSpec(kind="bytes", format="adpcm-dvi",
                         rate=in_spec.rate, channels=ch)

    def init_state(self, batch: int):
        return torch.zeros(self._channels, dtype=torch.int32,
                           device=self.device)

    def process(self, params, state, batch: FrameBatch):
        b, s, ch = batch.data.shape
        require(s == self._n_samples,
                f"adpcmenc: need exactly {self._n_samples} samples per "
                f"block, got {s} (feed through audiobuffersplit)")
        codes, header_si, state = ops.adpcm_ima_encode(batch.data, state)
        # header: sample 0 (little-endian int16), step index, 0; per channel
        s0 = batch.data[:, 0, :].to(torch.int32) & 0xFFFF
        hdr = torch.stack([s0 & 0xFF, (s0 >> 8) & 0xFF, header_si,
                           torch.zeros_like(s0)], dim=-1).reshape(b, 4 * ch)
        # body: per group and channel, 4 bytes of (low | high << 4) pairs
        body = codes[:, 1:, :].reshape(b, self._groups, 8, ch)
        lo, hi = body[:, :, 0::2, :], body[:, :, 1::2, :]
        byts = (lo & 0x0F) | ((hi << 4) & 0xF0)
        byts = byts.permute(0, 1, 3, 2).reshape(b, self._groups * ch * 4)
        out = torch.cat([hdr, byts], dim=1).to(torch.uint8)
        return state, batch.with_data(out)
