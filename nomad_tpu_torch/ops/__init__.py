"""Device compute: dense fit/score over the node axis, the water-fill and
exact greedy-scan solves (hand-written CUDA kernels with plain PyTorch
versions beside them), and the coalescing dispatcher."""
