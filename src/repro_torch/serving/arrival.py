"""Arrival-process scheduler (open/closed-loop load generation).

Open-loop injection decouples request arrivals from completions: arrival
timestamps are drawn ahead of time from a configured stochastic process
(Poisson, bursty on/off Poisson, or uniform pacing) at a target offered QPS,
and the client submits at those instants regardless of how far the server has
fallen behind.  This is the regime where queueing delay and tail latency
emerge (RAGO, arXiv:2503.14649).  Closed-loop mode instead caps the number of
in-flight requests at a fixed concurrency; it measures capacity without
unbounded queue growth.

Timestamps are a pure function of ``(ArrivalConfig.seed, process, qps, n)`` —
same config, same stream, bit-for-bit — mirroring the determinism contract of
``WorkloadGenerator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArrivalConfig:
    mode: str = "open"            # open | closed
    process: str = "poisson"      # poisson | bursty | uniform | diurnal
    target_qps: float = 20.0      # offered load (open-loop)
    n_requests: int = 100
    concurrency: int = 4          # closed-loop in-flight cap
    burst_cycle_s: float = 2.0    # bursty: on+off period length
    burst_duty: float = 0.25      # fraction of each cycle that is "on"
    ramp_period_s: float = 8.0    # diurnal: one full "day" (trough→peak→trough)
    ramp_amplitude: float = 0.8   # diurnal: peak/trough swing around the mean
    seed: int = 0

    def __post_init__(self):
        assert self.mode in ("open", "closed"), self.mode
        assert self.process in ("poisson", "bursty", "uniform",
                                "diurnal"), self.process
        assert self.target_qps > 0.0
        assert 0.0 < self.burst_duty <= 1.0
        assert self.ramp_period_s > 0.0
        assert 0.0 <= self.ramp_amplitude <= 1.0


def arrival_times(cfg: ArrivalConfig) -> np.ndarray:
    """[n_requests] nondecreasing arrival offsets (seconds from t=0).

    * poisson — exponential inter-arrivals at rate ``target_qps``;
    * uniform — fixed ``1/target_qps`` spacing (deterministic pacing);
    * bursty  — on/off-modulated Poisson: arrivals only during the "on"
      window (``burst_duty`` of each ``burst_cycle_s``) at rate
      ``target_qps / burst_duty``, so the long-run mean rate is still
      ``target_qps`` but the instantaneous rate during bursts is
      ``1/duty``× higher;
    * diurnal — sinusoidally-modulated Poisson (one "day" per
      ``ramp_period_s``): the instantaneous rate ramps from
      ``(1-amplitude)·qps`` at the trough through ``(1+amplitude)·qps`` at
      the peak, drawn by thinning a homogeneous process at the peak rate —
      the slow load swell autoscalers must ride, as opposed to the abrupt
      on/off bursts of ``bursty``.
    """
    n, qps = cfg.n_requests, cfg.target_qps
    if cfg.process == "uniform":
        return np.arange(n, dtype=np.float64) / qps
    rng = np.random.default_rng(cfg.seed)
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / qps, size=n)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    if cfg.process == "diurnal":
        peak = qps * (1.0 + cfg.ramp_amplitude)
        out: list = []
        t = 0.0
        while len(out) < n:
            t += float(rng.exponential(1.0 / peak))
            rate = qps * (1.0 + cfg.ramp_amplitude
                          * np.sin(2.0 * np.pi * t / cfg.ramp_period_s
                                   - 0.5 * np.pi))
            # quantize the accept threshold: libm sin differs by ULPs across
            # platforms, and one flipped accept would change the whole
            # stream (the reference's golden traces pin it, and the port's
            # draws equal the reference's) — 9 decimals is far above sin's
            # error and far below any behavioral difference
            if rng.random() * peak <= round(float(rate), 9):
                out.append(t)
        # not shifted to start at 0: offsets stay phase-aligned with the
        # sinusoid (trough at t=0), which arrival-aware consumers rely on
        return np.asarray(out, dtype=np.float64)
    # bursty: draw Poisson arrivals on the compressed "active-time" axis at
    # the burst rate, then stretch active time back onto the wall clock so
    # each on-window of length duty*cycle is followed by a silent gap.
    on_len = cfg.burst_duty * cfg.burst_cycle_s
    gaps = rng.exponential(cfg.burst_duty / qps, size=n)
    gaps[0] = 0.0
    active = np.cumsum(gaps)
    cycle_idx = np.floor(active / on_len)
    return cycle_idx * cfg.burst_cycle_s + (active - cycle_idx * on_len)
