"""Data and context parallelism over torch.distributed (the JAX package's
parallel/): mesh.py lays out and launches the ranks and holds the rank-order
collectives, cp.py the context-parallel FVTA attention."""
