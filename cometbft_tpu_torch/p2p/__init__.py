"""p2p plane (a copy of cometbft_tpu/p2p/; reference: p2p/).

Stack, bottom-up: TCP → SecretConnection (X25519 + ChaCha20-Poly1305
authenticated encryption) → MConnection (priority channel
multiplexing, flow control) → Switch (reactor fan-out, peer
lifecycle) → PEX (``p2p/pex``: the address book and discovery).
WAN emulation (``p2p/conn/netem.py``) holds frames at the MConnection
frame pump when a switch is given a plan.
"""

from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn import (
    ChannelDescriptor,
    MConnConfig,
    MConnection,
    SecretConnection,
)
from cometbft_tpu_torch.p2p.key import NodeKey, pub_key_to_id
from cometbft_tpu_torch.p2p.netaddr import NetAddress, parse_peer_list
from cometbft_tpu_torch.p2p.node_info import NodeInfo, ProtocolVersion
from cometbft_tpu_torch.p2p.peer import Peer, PeerSet
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import MultiplexTransport, RejectedError

__all__ = [
    "ChannelDescriptor",
    "Envelope",
    "MConnConfig",
    "MConnection",
    "MultiplexTransport",
    "NetAddress",
    "NodeInfo",
    "NodeKey",
    "Peer",
    "PeerSet",
    "ProtocolVersion",
    "Reactor",
    "RejectedError",
    "SecretConnection",
    "Switch",
    "parse_peer_list",
    "pub_key_to_id",
]
