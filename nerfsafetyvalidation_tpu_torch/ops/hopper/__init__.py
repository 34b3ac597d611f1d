"""Hand-written Hopper kernels and their wrappers. Each wrapper launches its
kernel on a CUDA tensor (or raises) and runs its plain PyTorch version on a
CPU tensor; `LAUNCHES` on each module counts kernel launches only."""
