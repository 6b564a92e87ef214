"""Multi-device paths of the PyTorch port: ``stream_shard`` (the sharded
stream backend, ``ShardedSession``) and ``shard`` (the dense x-slab
reference with backpressured migration).  One process drives a list of
devices, one per shard."""
