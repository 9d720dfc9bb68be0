"""Blocksync plane — pipelined fast catch-up (a copy of
cometbft_tpu/blocksync/__init__.py; reference: internal/blocksync/)."""

from cometbft_tpu_torch.blocksync.pool import BlockPool, REQUEST_WINDOW
from cometbft_tpu_torch.blocksync.reactor import BLOCKSYNC_CHANNEL, BlocksyncReactor

__all__ = [
    "BLOCKSYNC_CHANNEL",
    "BlockPool",
    "BlocksyncReactor",
    "REQUEST_WINDOW",
]
