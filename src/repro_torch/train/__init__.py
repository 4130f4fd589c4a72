"""Training: AdamW (``optimizer``), the deterministic data pipeline
(``data``), the train step (``train_step``) and checkpoints
(``checkpoint``): the port of ``repro.train``."""
