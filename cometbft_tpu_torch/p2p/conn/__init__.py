"""Connection layer (a copy of cometbft_tpu/p2p/conn/ without its WAN
emulation, netem.py): SecretConnection (authenticated encryption) and
MConnection (channel multiplexing) — reference: p2p/conn/."""

from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.conn.connection import (
    ChannelDescriptor,
    MConnConfig,
    MConnection,
)

__all__ = [
    "SecretConnection",
    "MConnection",
    "MConnConfig",
    "ChannelDescriptor",
]
