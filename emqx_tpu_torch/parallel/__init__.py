"""The ('dp', 'tp') mesh of the port on torch.distributed: one process a
shard (`launch`), the mesh, its placements and the sharded serving steps
(`mesh`). The counterpart of `emqx_tpu/parallel/`: axis ``dp`` splits the
topic batch, axis ``tp`` the subscriber table (dense lanes, or CSR and
semantic slot-owner shards); stats and counts meet in all-reduces, the
round-robin picks in an all-gather over ``dp``.

Imports torch, numpy and the standard library only.
"""
