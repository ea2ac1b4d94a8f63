"""Data and tensor parallelism over `torch.distributed` (the port of the
JAX package's `parallel/mesh.py` and `parallel/sharding.py`, with Megatron
sequence parallelism): one process per rank, a ('data', 'model') mesh of
process groups, and the collectives with gradients in `collectives.py`.
Context and pipeline parallelism (`cp.py`, `pp.py`) are not ported yet."""
