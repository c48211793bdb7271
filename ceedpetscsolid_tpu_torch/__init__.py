"""ceedpetscsolid_tpu_torch — the PyTorch/CUDA port of ceedpetscsolid_tpu.

The matrix-free solid-mechanics solver of the JAX package (the CeedPetscSolid
mini-app's capabilities), rebuilt on PyTorch for one NVIDIA Hopper GPU. The
module layout mirrors `ceedpetscsolid_tpu` so each counterpart is easy to
find:

  mesh/     numpy-only box mesh and FE-space numbering (copies of the JAX
            package's modules: importing that package pulls in JAX)
  ops/      quadrature, tensor bases, geometric qdata, conn gather /
            deterministic scatter, the fused element apply (hand-written
            CUDA kernel on the GPU, plain torch on the CPU) and the
            operator factory
  models/   hyperFS pointwise physics over torch planes, MMS data, BCs,
            forcing
  solve/    natural-norm PCG and Newton with the CP line search
  csrc/     CUDA sources and their nvcc build

Dtype policy: float64 on the CPU (the parity path), float32 on CUDA.
This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
