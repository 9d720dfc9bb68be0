"""Statesync plane — snapshot-based bootstrap (a copy of
cometbft_tpu/statesync/__init__.py; reference: statesync/)."""

from cometbft_tpu_torch.statesync.messages import (
    CHUNK_CHANNEL,
    SNAPSHOT_CHANNEL,
)
from cometbft_tpu_torch.statesync.reactor import StatesyncReactor
from cometbft_tpu_torch.statesync.stateprovider import (
    LightClientStateProvider,
    StateProvider,
)
from cometbft_tpu_torch.statesync.syncer import (
    NoSnapshotsError,
    Snapshot,
    SnapshotPool,
    SnapshotRejectedError,
    Syncer,
)

__all__ = [
    "CHUNK_CHANNEL",
    "LightClientStateProvider",
    "NoSnapshotsError",
    "SNAPSHOT_CHANNEL",
    "Snapshot",
    "SnapshotPool",
    "SnapshotRejectedError",
    "StateProvider",
    "StatesyncReactor",
    "Syncer",
]
