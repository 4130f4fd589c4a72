"""Static invariant linter + runtime lock-order detector of the port (the
twin of the reference's ``analysis`` package, over ``src/repro_torch``).

Four static passes guard the invariants the benchmark results rest on:

- ``clock-purity``    -- no wall clock / unseeded randomness inside declared
                         deterministic zones (sim, autoscale step paths,
                         virtual-clock obs paths, fault replay).
- ``lock-discipline`` -- fields annotated ``# guarded-by: <lock>`` may only
                         be touched while holding that lock.
- ``conformance``     -- registered components satisfy their kind's
                         protocol; spec dataclasses round-trip through
                         to_dict/from_dict and reject unknown keys; every
                         spec of ``src/repro_torch/specs`` and scenario
                         pipeline resolves.
- ``gauge-schema``    -- gauge names handed to the metrics registry match a
                         ``GAUGE_SCHEMA`` family (static sibling of the
                         runtime DeprecationWarning).

CLI: ``PYTHONPATH=src python -m repro_torch.analysis [--check] [--json]``.
Findings are suppressed line-by-line with ``# noqa: <pass>`` or absorbed
into the committed ``src/repro_torch/analysis/baseline.json`` (empty: the
port repairs its findings) so CI fails only on *new* findings.  See
docs/analysis.md for the annotation grammar.

The runtime half lives in ``repro_torch.analysis.lockorder``: an opt-in
instrumented-lock wrapper that records the cross-thread lock-acquisition
order graph during tests and fails on cycles (potential deadlock).
"""
from repro_torch.analysis.core import Finding, run_passes  # noqa: F401
from repro_torch.analysis.lockorder import (  # noqa: F401
    InstrumentedLock, LockOrderError, LockOrderGraph, instrument)
