"""Traffic: the general request generator."""
