"""Resource monitor and stage timer (port of ``repro.monitor``)."""
