"""The benchmark's CPU tests: the repository root on sys.path, and the
tiny cell (tests/tiny: 12^3 particles, a cut of science_1m) they run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def tiny_dir():
    return TINY
