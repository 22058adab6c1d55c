"""Entry point: ``python -m repro_torch.analysis``."""

import sys

from .cli import main

sys.exit(main())
