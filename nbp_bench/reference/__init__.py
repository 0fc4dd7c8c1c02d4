"""Plain references that decide ``correct``: plain PyTorch over the raw
inputs the benchmark makes (triangles, GT points, lattices, weights,
draws). Nothing here imports the program or the JAX package; what the
program derived from the inputs (its triangle buffers, tables, folded
weights) is worked out again here."""
