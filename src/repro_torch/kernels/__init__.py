"""Hand-written Hopper (sm_90a) kernels and their plain PyTorch versions.

``ops`` holds the public wrappers: a CPU tensor takes the plain version in
``ref``, a CUDA tensor launches the CUDA kernel (``csrc/*.cu``, built by
``_build`` at first use) or raises."""
