"""python -m gstbad_tpu_torch {launch,transcode} ... (see cli.py)."""

import sys

from gstbad_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
