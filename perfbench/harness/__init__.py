"""The benchmark harness of the PyTorch/CUDA port (`repro_torch`): run one
cell of BENCHMARK.json and print its result line. It imports neither JAX
nor the JAX package."""
