from repro_torch.workload.corpus import SyntheticCorpus, CorpusConfig  # noqa: F401
from repro_torch.workload.generator import (  # noqa: F401
    WorkloadConfig, WorkloadGenerator, Request)
