"""Layer ops on NHWC tensors, and the hand-written Hopper kernels
(``ops/kernels/``) that replace the JAX package's Pallas kernels."""
