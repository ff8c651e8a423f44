"""Hand-written Hopper kernels that replace the reference's Pallas TPU kernels."""
