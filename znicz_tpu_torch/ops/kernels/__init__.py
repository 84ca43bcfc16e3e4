"""Hand-written Hopper kernels, one module per TPU kernel family they
replace, each beside its plain PyTorch version and launch counters."""
