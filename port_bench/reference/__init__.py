"""The plain reference of the benchmark: plain PyTorch, importing nothing
of the program and nothing of JAX."""
