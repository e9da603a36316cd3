"""Multi-GPU training over ``torch.distributed`` (replaces the JAX package's
``jax.sharding`` meshes): the (data, model) process layout, the data axis's
loading, draws and gradient mean, and the teacher's tensor parallelism."""
