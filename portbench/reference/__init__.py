"""Plain PyTorch references of what the cells run, in float32.

They import nothing of the program (``repro_torch``), of JAX or of the
JAX package, and take only what the benchmark made: inputs and weights
drawn from the seed."""
