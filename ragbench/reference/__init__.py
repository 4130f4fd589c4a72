"""The plain reference the benchmark judges the program against: plain
PyTorch in float64 (TF32 off, ``search.fp32_matmul``) over the rows and
writes the benchmark draws and records itself. It imports nothing of the
program, nor JAX."""
