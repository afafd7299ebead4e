"""Plain PyTorch reference of the benchmark's configurations. It imports
neither JAX nor the measured program, and takes no weights, entries or
tables that the program made."""
