"""gpu_bench — a GPU micro-benchmark engine for high-order CFD kernels
(JAX / XLA / Pallas).

A re-creation of the CFD-Xing/gpu-benchmarking CUDA suite: five CFD kernel
benchmarks, each implemented in several variants spanning the XLA tier (the
Kokkos/Thrust/cuBLAS analog) and, where it beats XLA on the card, a
hand-written Pallas kernel on the Triton route (the hand-CUDA analog), with
a shared timing/validation/reporting harness and a postprocessing pipeline.

Benchmarks (reference parity, see SURVEY.md):
  01  L2-norm reduction          sqrt(sum x_i^2)          [GB/s]
  02  streaming vector addition  x += y                   [GB/s]
  03  dense matrix-vector        y = A.x                  [GB/s]
  04  2D tensor-product sum-factorization (BwdTrans quad) [GDOF/s]
  05  3D tensor-product sum-factorization (BwdTrans hex)  [GDOF/s]
"""

__version__ = "0.1.0"
