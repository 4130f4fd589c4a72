"""Distributed helpers of the port (the part of ``repro.distributed`` that
serving uses)."""
