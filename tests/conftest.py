import os
import sys

# tests run against the source tree
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device (the 512-device override is dryrun.py-only).


def pytest_configure(config):
    # `slow` marks long serving/stress tests; the tier-1 fast gate runs
    # `pytest -m "not slow"` (scripts/tier1.sh) while the full suite still
    # includes them
    config.addinivalue_line(
        "markers", "slow: long-running serving/stress test (excluded from "
                   "the tier-1 fast gate)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one); run "
                   "them there with `pytest -m cuda tests/test_torch_*.py`")
