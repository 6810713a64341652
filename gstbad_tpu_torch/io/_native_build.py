"""Build the port's host C sources in csrc/ (the plugin fixtures
{ladspa,frei0r,lv2}_plugins.c with the LV2 bundle's .ttl files, exrdec.c
and shmring.cpp) at first use into
gstbad_tpu_torch/_build/<kind>-<hash of the sources>/: always from the
checked-in sources, never a committed binary.

Each file is written beside its target and then renamed, so that
processes that build at once (pytest-xdist workers) never load a
half-written library or read a half-copied manifest."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")


def build_dir(kind: str, sources: Sequence[str]) -> str:
    """The directory named from the content of `sources` (file names
    in csrc/), created if missing."""
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    directory = os.path.join(_PKG, "_build",
                             f"{kind}-{h.hexdigest()[:16]}")
    os.makedirs(directory, exist_ok=True)
    return directory


def gcc_shared(out: str, source: str, *flags: str, compiler: str = "gcc",
               libs: Sequence[str] = ("-lm",)) -> None:
    """Compile csrc/`source` into the shared object `out` unless it
    exists, with `flags` before the source and `libs` after it (the
    compiler's output kept out of the caller's)."""
    if os.path.exists(out):
        return
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run([compiler, "-O2", "-shared", "-fPIC", *flags, "-o", tmp,
                    os.path.join(CSRC, source), *libs],
                   check=True, capture_output=True)
    os.replace(tmp, out)


def install(out: str, source: str) -> None:
    """Copy csrc/`source` to `out` unless it exists."""
    if os.path.exists(out):
        return
    tmp = f"{out}.{os.getpid()}.tmp"
    shutil.copyfile(os.path.join(CSRC, source), tmp)
    os.replace(tmp, out)
