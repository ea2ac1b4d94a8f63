"""Parallelism over `torch.distributed` (the port of the JAX package's
`parallel/`): one process per rank, a ('data', 'model') mesh of process
groups (`mesh.py`), the sharding rules and sharded train state
(`sharding.py`), the collectives with gradients (`collectives.py`), and
over the 'model' group context parallelism (`cp.py`: ring and Ulysses
attention) and pipeline parallelism (`pp.py`: a GPipe pipeline of the
encoder's blocks); data and tensor parallelism with Megatron sequence
parallelism run through the models' mesh paths."""
