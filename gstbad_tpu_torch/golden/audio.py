"""Constants and host walks of the audio elements, copied from the JAX
package's golden/audio.py: bs2b's preset table and the speed element's
resample walk."""

import numpy as np

# bs2b's presets (gstbs2b.c:85-98): name -> (fcut Hz, feed dB*10)
BS2B_PRESETS = {
    "default": (700, 45),
    "cmoy": (700, 60),
    "jmeier": (650, 95),
}


def speed_resample_indices(in_samples: int, speed: float):
    """The speed element's per-buffer resample walk
    (gst/speed/gstspeed.c:433-474 speed_chain_int16, :474-511 _float32).

    The reference restarts the walk on EVERY input buffer: i_float begins at
    0.5*(speed-1) and accumulates `+= speed` in gfloat; each output takes
    i = ceil(i_float), interp = i_float - floor(i_float), and blends
    `lower` (the previously selected input sample, in[0] initially) with
    in[i].  Returns (prev_idx, idx, interp_f32) arrays of the static output
    length for this buffer size."""
    i_float = np.float32(0.5 * (speed - 1.0))
    speed32 = np.float32(speed)
    i = int(np.ceil(np.float64(i_float)))
    prev_idx, idx, interp = [], [], []
    prev = 0
    while i < in_samples:
        interp.append(np.float32(np.float64(i_float)
                                 - np.floor(np.float64(i_float))))
        prev_idx.append(prev)
        idx.append(i)
        prev = i
        i_float = np.float32(i_float + speed32)
        i = int(np.ceil(np.float64(i_float)))
    return (np.array(prev_idx, np.int32), np.array(idx, np.int32),
            np.array(interp, np.float32))
