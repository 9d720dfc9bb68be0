"""Node info exchanged during the p2p handshake (a copy of
cometbft_tpu/p2p/node_info.py; reference: p2p/node_info.go).

After the secret connection is established, both sides exchange a
``NodeInfo`` and check compatibility: same network (chain id), same
block protocol version, at least one common channel
(node_info.go:145 CompatibleWith).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.p2p.key import validate_id
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.version import BLOCK_PROTOCOL, P2P_PROTOCOL, __version__ as SEMVER
from cometbft_tpu_torch.types.codec import as_bytes as _bz, as_int as _iv

MAX_NODE_INFO_SIZE = 10240  # p2p/node_info.go:19


class NodeInfoError(ValueError):
    pass


@dataclass(frozen=True)
class ProtocolVersion:
    """(p2p/node_info.go:29 ProtocolVersion)"""

    p2p: int = P2P_PROTOCOL
    block: int = BLOCK_PROTOCOL
    app: int = 0


@dataclass(frozen=True)
class NodeInfo:
    """(p2p/node_info.go:74 DefaultNodeInfo)"""

    node_id: str
    listen_addr: str
    network: str  # chain id
    version: str = SEMVER
    channels: bytes = b""
    moniker: str = "node"
    protocol_version: ProtocolVersion = field(default_factory=ProtocolVersion)
    tx_index: str = "on"
    rpc_address: str = ""

    def validate(self) -> None:
        """(node_info.go:98 Validate)"""
        validate_id(self.node_id)
        if len(self.channels) > 16:
            raise NodeInfoError("too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise NodeInfoError("duplicate channel id")
        if not self.moniker or len(self.moniker) > 256:
            raise NodeInfoError("invalid moniker")

    def compatible_with(self, other: "NodeInfo") -> None:
        """(node_info.go:145 CompatibleWith) — raises on mismatch."""
        if self.protocol_version.block != other.protocol_version.block:
            raise NodeInfoError(
                f"peer block protocol {other.protocol_version.block} != "
                f"ours {self.protocol_version.block}"
            )
        if self.network != other.network:
            raise NodeInfoError(
                f"peer network {other.network!r} != ours {self.network!r}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise NodeInfoError("no common channels")

    def has_channel(self, ch_id: int) -> bool:
        return ch_id in self.channels

    # -- wire (proto/cometbft/p2p/v1/types.proto DefaultNodeInfo) -------

    def encode(self) -> bytes:
        w = ProtoWriter()
        pv = ProtoWriter()
        pv.varint(1, self.protocol_version.p2p)
        pv.varint(2, self.protocol_version.block)
        pv.varint(3, self.protocol_version.app)
        w.message(1, pv.finish())
        w.string(2, self.node_id)
        w.string(3, self.listen_addr)
        w.string(4, self.network)
        w.string(5, self.version)
        w.bytes_(6, self.channels)
        w.string(7, self.moniker)
        other = ProtoWriter()
        other.string(1, self.tx_index)
        other.string(2, self.rpc_address)
        w.message(8, other.finish())
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        if len(data) > MAX_NODE_INFO_SIZE:
            raise NodeInfoError("node info exceeds max size")
        f = ProtoReader(data).to_dict()
        pv = ProtocolVersion()
        if 1 in f:
            pf = ProtoReader(_bz(f[1][0])).to_dict()
            pv = ProtocolVersion(
                p2p=_iv(pf.get(1, [0])[0]),
                block=_iv(pf.get(2, [0])[0]),
                app=_iv(pf.get(3, [0])[0]),
            )
        tx_index, rpc_address = "on", ""
        if 8 in f:
            of = ProtoReader(_bz(f[8][0])).to_dict()
            tx_index = _bz(of.get(1, [b"on"])[0]).decode()
            rpc_address = _bz(of.get(2, [b""])[0]).decode()
        return cls(
            protocol_version=pv,
            node_id=_bz(f.get(2, [b""])[0]).decode(),
            listen_addr=_bz(f.get(3, [b""])[0]).decode(),
            network=_bz(f.get(4, [b""])[0]).decode(),
            version=_bz(f.get(5, [b""])[0]).decode(),
            channels=_bz(f.get(6, [b""])[0]),
            moniker=_bz(f.get(7, [b"node"])[0]).decode(),
            tx_index=tx_index,
            rpc_address=rpc_address,
        )


__all__ = ["NodeInfo", "ProtocolVersion", "NodeInfoError", "MAX_NODE_INFO_SIZE"]
