import os
import sys
from pathlib import Path

# tests run on the single real CPU device; only dryrun.py forces 512.
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
