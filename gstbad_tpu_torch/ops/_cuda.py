"""Builds and loads the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, loaded
with ctypes: a build takes seconds, where an extension that includes
PyTorch's headers takes minutes.  The library lands in
gstbad_tpu_torch/_build/<hash of sources and flags>/, built on first use,
so a fresh checkout builds it and an edited source rebuilds it.  Nothing
here runs at import time: this module imports on a machine without nvcc or
a card, and only a CUDA launch reaches the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libgstbad_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# every entry point takes a trailing cudaStream_t and returns cudaError_t
SIGNATURES = {
    "gst_word_lut": (_P, _P, _P, _LL),
    "gst_dilate_zebra": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I),
    "gst_fieldanalysis_metrics": (_P, _P, _P, _P, _P, _I, _I, _I, _I),
    "gst_comb_score_pairs": (_P, _P, _P, _P, _I, _I, _I, _I),
    "gst_comb_mask": (_P, _P, _P, _I, _I, _I),
    "gst_gaussian_blur": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    "gst_warp_words": (_P, _P, _P, _I, _I, _I, _I, _I),
    "gst_vad_powers_serial": (_P, _P, _P, _I, _I),
    "gst_vad_powers_bracket": (_P, _P, _P, _I, _I),
    "gst_vad_step_cycles": (_P, _I),
}

_lib: Optional[ctypes.CDLL] = None
# what the last library() call did: {"path", "built", "seconds", "log"}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and Path("/usr/local/cuda/bin/nvcc").exists():
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "gstbad_tpu_torch are built from csrc/ with the "
                           "CUDA toolkit")
    return exe


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), built=False, seconds=0.0, log="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
    t0 = time.perf_counter()
    # one nvcc per source, all running at once
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        cmds.append([_nvcc(), "-shared", "-o", str(tmp),
                     *(str(o) for o in objs)])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.returncode)
    seconds = time.perf_counter() - t0
    log = "".join(" ".join(c) + "\n" + out for c, out in zip(cmds, logs))
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    build_info.update(path=str(lib), built=True, seconds=seconds, log=log)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = (*args, _P)
            fn.restype = _I
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point `name` on the current stream of the tensors'
    device: tensors pass as device pointers, ints as ints.  Raises when
    a tensor is not on a CUDA device or the launch reports an error."""
    dev = None
    c_args = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cuda" or (dev is not None and a.device != dev):
                raise ValueError(f"{name}: every tensor must be on one CUDA "
                                 f"device, got {a.device}")
            dev = a.device
            c_args.append(a.data_ptr())
        else:
            c_args.append(int(a))
    if dev is None:
        raise ValueError(f"{name}: no tensor argument")
    fn = getattr(library(), name)
    with torch.cuda.device(dev):
        rc = fn(*c_args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
