"""``python -m portbench``: one run of one cell (``portbench/run.py``)."""

import sys

from portbench.run import main

sys.exit(main())
