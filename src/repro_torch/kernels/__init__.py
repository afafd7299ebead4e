"""Kernels of the port: the (op, method, backend) registry in `api`, the
hand-written Hopper kernels with their plain PyTorch versions in
`fourier_deltaw` (K1 ΔW, K2 dc), `dct_deltaw` (K4 ΔW, K5 dc) and
`paged_attention` (K3), their CUDA sources under `csrc/` and the nvcc/ctypes
build in `build`, the padding harnesses in `ops`, and the FFT oracles in
`ref`. Importing this package builds nothing."""
