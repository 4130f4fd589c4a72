"""Concurrent serving layer of the port: load generation, continuous
batching, latency accounting, and pipelined and elastic replicated execution
(the "serving benchmark" regime on top of the offline replay in
``repro_torch.workload.runner``), and the token-level continuous-batching
generation engine. The port of ``repro.serving``."""
from repro_torch.serving.accounting import (LatencyAccountant, RequestRecord,
                                            percentile)
from repro_torch.serving.arrival import ArrivalConfig, arrival_times
from repro_torch.serving.autoscale import (AutoscaleConfig,
                                           AutoscaleController, ScaleEvent,
                                           Snapshot, StageSample,
                                           default_ladder)
from repro_torch.serving.batcher import (BatchPolicy, ContinuousBatcher,
                                         Submission)
from repro_torch.serving.elastic import (ElasticExecutor, ElasticResult,
                                         ReplicaKilled)
from repro_torch.serving.faults import (FAULT_KINDS, FaultEvent,
                                        FaultInjector, FaultSpec)
from repro_torch.serving.genengine import EngineLLM, GenEngine, GenRequest
from repro_torch.serving.harness import (ServingConfig, ServingHarness,
                                         ServingResult)
from repro_torch.serving.staged import StagedExecutor, StagedResult, StageStats

__all__ = [
    "ArrivalConfig", "arrival_times",
    "AutoscaleConfig", "AutoscaleController", "ScaleEvent", "Snapshot",
    "StageSample", "default_ladder",
    "BatchPolicy", "ContinuousBatcher", "Submission",
    "ElasticExecutor", "ElasticResult", "ReplicaKilled",
    "EngineLLM", "GenEngine", "GenRequest",
    "FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultSpec",
    "LatencyAccountant", "RequestRecord", "percentile",
    "ServingConfig", "ServingHarness", "ServingResult",
    "StagedExecutor", "StagedResult", "StageStats",
]
