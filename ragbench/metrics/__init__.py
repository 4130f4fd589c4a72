"""Per-layer metric readers, one file a metric (see ``_lib``)."""
