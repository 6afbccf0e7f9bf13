"""The benchmark's own tests: ``python -m pytest benchmark/tests`` (CPU);
on the card ``python -m pytest -m gpu benchmark/tests``."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
