"""Hand-written Hopper kernels and their wrappers. Each wrapper launches its
kernel on a CUDA tensor (or raises) and runs its plain PyTorch version on a
CPU tensor; the `LAUNCHES*` counters on each module count kernel launches
only, and `PLAIN_CALLS` the calls of the plain versions of K1-K4."""
