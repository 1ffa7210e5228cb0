"""Scale-out over torch.distributed ranks: the port of the JAX package's
parallel/ (mesh, distributed, sharded_serial, sharded_ipa).

Every rank runs the same host program (same seed, same transcript, same
template cache); only the device work is split, with explicit collectives
where the JAX package has shard_map and XLA's resharding.
"""
