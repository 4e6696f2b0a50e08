"""``python -m lightgbm_tpu_torch key=value ...``: the CLI (``cli.py``)."""

import sys

from .cli import main

sys.exit(main())
