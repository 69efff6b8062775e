"""Multi-device execution over `torch.distributed`: the device mesh and rank
launcher (`mesh`), differentiable collectives (`comm`), data parallelism
and the sharded sampler chain (`dp`), clause-partitioned graph
parallelism (`graph_partition`) and its halo exchange (`halo`)."""
