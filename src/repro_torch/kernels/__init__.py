"""Kernels of the port: the (op, method, backend) registry in `api`, the
hand-written Hopper kernels with their plain PyTorch versions in
`fourier_deltaw` (K1) and `paged_attention` (K3), their CUDA sources under
`csrc/` and the nvcc/ctypes build in `build`, the padding harness in `ops`,
and the ifft2 oracle in `ref`. Importing this package builds nothing."""
