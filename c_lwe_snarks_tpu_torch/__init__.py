"""c_lwe_snarks_tpu_torch — the lattice zk-SNARK of ``c_lwe_snarks_tpu`` in
PyTorch, with its five TPU kernels rewritten as CUDA kernels for Hopper.

Layers (bottom-up), mirroring the JAX package:
  utils/   parameters, host AES, byte formats and file IO, state
           conversion, stage timers and decrypt-probes
  ops/     Z_p and digit arithmetic, AES-CTR keystream (K1, K2 and the
           bitsliced K5), the fused keystream->MAC / keystream->encrypt
           kernels (K3, K4), CRT-NTT; csrc/ holds the CUDA sources, built
           with nvcc at first CUDA use
  models/  LWE scheme, SSP instances, SNARK protocol

Every kernel wrapper runs its plain torch version for CPU tensors and
its CUDA kernel for CUDA tensors.  The package imports neither jax nor
the JAX package.
"""

__version__ = "0.1.0"
