"""Quality metrics (port of ``repro.metrics``)."""
