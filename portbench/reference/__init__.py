"""Plain PyTorch references of what the benchmark's cells compute.

Nothing here imports JAX, the JAX package or the port: the arithmetic of
the port's keys and Philox draws is kept as a frozen copy in ``keys``, so
that the reference draws the same uniforms as the program."""
