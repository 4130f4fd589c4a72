"""The benchmark's tests: the folder's root and the port's sources on the
path, and the ``cuda`` marker for tests that need the card (they decide in
a fixture, ``card``, whether to skip)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one); run "
                   "them there with `python -m pytest -m cuda ragbench/tests`")
