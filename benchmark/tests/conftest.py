"""The benchmark's own tests (CPU, except those marked cuda): run from the
repository's root with  python3 -m pytest benchmark/tests -q"""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
