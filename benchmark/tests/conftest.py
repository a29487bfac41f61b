"""The benchmark's own CPU tests: `python -m pytest benchmark/tests -q` from the
checkout's root (the card's test with `-m cuda` on a machine that has one)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
