"""``python -m horovod_tpu_torch.analysis`` -- run the static passes
(see lint.py; reference horovod_tpu/analysis/__main__.py)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
