"""Network addresses: ``id@host:port`` (a copy of
cometbft_tpu/p2p/netaddr.py; reference: p2p/netaddress.go).

Used by persistent-peer config and the transport dialer.  The ID prefix
authenticates the dial target: the secret-connection handshake must
present a key hashing to this ID (p2p/transport.go upgrade).
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.p2p.key import validate_id


class AddressError(ValueError):
    pass


@dataclass(frozen=True)
class NetAddress:
    """(p2p/netaddress.go:28 NetAddress)"""

    id: str
    host: str
    port: int

    def __str__(self) -> str:
        if self.id:
            return f"{self.id}@{self.host}:{self.port}"
        return f"{self.host}:{self.port}"

    def dial_string(self) -> str:
        return f"{self.host}:{self.port}"

    def routable(self) -> bool:
        """Loose routability check (netaddress.go:315 Routable).  The
        strict RFC-range classification matters for the address book's
        strict mode; loopback is unroutable there."""
        return self.host not in ("", "0.0.0.0") and self.port > 0

    def local(self) -> bool:
        return self.host in ("127.0.0.1", "localhost", "::1")

    @classmethod
    def parse(cls, addr: str) -> "NetAddress":
        """(p2p/netaddress.go:75 NewNetAddressString) — accepts
        ``id@host:port`` or ``host:port``; strips tcp:// scheme."""
        s = addr.strip()
        for scheme in ("tcp://", "unix://"):
            if s.startswith(scheme):
                s = s[len(scheme):]
        node_id = ""
        if "@" in s:
            node_id, s = s.split("@", 1)
            try:
                validate_id(node_id)
            except ValueError as exc:
                raise AddressError(f"invalid address {addr!r}: {exc}") from exc
        if ":" not in s:
            raise AddressError(f"invalid address {addr!r}: missing port")
        host, _, port_s = s.rpartition(":")
        host = host.strip("[]")  # ipv6 literals
        try:
            port = int(port_s)
        except ValueError as exc:
            raise AddressError(f"invalid port in {addr!r}") from exc
        # port 0 = "bind an ephemeral port" for listen addresses
        if not 0 <= port < 65536:
            raise AddressError(f"port out of range in {addr!r}")
        return cls(id=node_id, host=host or "127.0.0.1", port=port)


def parse_peer_list(spec: str) -> list[NetAddress]:
    """Split a comma-separated persistent_peers/seeds config string."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if part:
            out.append(NetAddress.parse(part))
    return out


__all__ = ["NetAddress", "AddressError", "parse_peer_list"]
