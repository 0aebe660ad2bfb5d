"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the repository's root. Tests that need the card carry the `card` marker
and skip without one; they decide inside the test, never at import."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")
