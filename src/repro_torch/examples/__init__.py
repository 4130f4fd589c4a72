"""Worked examples of the port, one module each, named as the JAX package's
``examples/`` files are: ``python -m repro_torch.examples.<name>
[--device cuda|cpu]`` (default ``cuda``)."""
