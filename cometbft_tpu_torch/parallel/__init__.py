"""The multi-device plane: device meshes and sharded verification (the
port of cometbft_tpu/parallel/).

Signatures are independent, so a batch splits over the devices of a
mesh with no exchange between them until the one reduction, the AND of
the verdicts, done on the host.  Mesh convention (2-D, ``("blocks",
"sigs")``, as the reference's):

- ``blocks``: independent verification units (headers in light-client
  sync, blocks in blocksync replay);
- ``sigs``: the signatures of one unit (a validator set's commit).

The batch verifier shards over a 1-D mesh (axis ``"d"``), the keyed
tier's tables too (parallel/mesh.py).
"""

from cometbft_tpu_torch.parallel.mesh import (
    ShardedTorchBatchVerifier,
    all_valid,
    flat_mesh,
    make_mesh,
    shard_batch,
    sharded_verify_fn,
)

__all__ = [
    "ShardedTorchBatchVerifier",
    "all_valid",
    "flat_mesh",
    "make_mesh",
    "shard_batch",
    "sharded_verify_fn",
]
