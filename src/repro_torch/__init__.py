"""PyTorch/CUDA port of the FourierFT system (`repro`, the JAX reference).

Module names mirror `repro`'s. Entry points (`serve.Engine`,
`serve.ContinuousScheduler`, `launch.serve`) run on `cuda` unless the caller
passes `device="cpu"`; with no device argument and no CUDA device they
raise. Kernels are CUDA C++ for sm_90a under `kernels/csrc/`, built with
nvcc at first use (see `kernels/build.py`)."""
