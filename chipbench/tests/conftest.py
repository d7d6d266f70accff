"""The benchmark's own tests (CPU; the card's are marked ``cuda``):
``python -m pytest -q chipbench/tests`` from the root of the checkout."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
