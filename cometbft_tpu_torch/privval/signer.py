"""Remote signer — keep validator keys in a separate process (a copy of
cometbft_tpu/privval/signer.py; reference:
privval/signer_listener_endpoint.go, signer_client.go, signer_server.go,
signer_dialer_endpoint.go).

Topology (the reference's primary mode): the NODE listens on
``priv_validator_laddr``; the SIGNER process (which holds the key)
dials in and then serves signing requests over that single connection.
The node side is ``SignerListenerEndpoint`` + ``SignerClient`` (a
PrivValidator drop-in for FilePV); the signer side is ``SignerServer``
wrapping a FilePV, whose CheckHRS double-sign guard therefore runs
next to the key, where it cannot be bypassed by a compromised node.

Wire: uvarint-length-prefixed envelopes:
  1 PubKeyRequest{chain_id}     2 PubKeyResponse{pub_key_type, pub_key}
  3 SignVoteRequest{chain_id, vote}        4 SignedVoteResponse{vote|err}
  5 SignProposalRequest{chain_id, proposal} 6 SignedProposalResponse{...}
  7 PingRequest                 8 PingResponse
(privval/msgs.go message oneof)

As in the reference, the signer's TCP link is not wrapped in a
``SecretConnection`` (CometBFT's is).  The signer is host code: it
never touches a card.  Where the port departs from its reference:
``SignerServer.served`` counts the requests it answered by kind, and
``main`` prints them as one JSON line when it stops.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import Counter

from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.privval import FilePV, PrivValidatorError
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import (
    ProtoReader,
    ProtoWriter,
    encode_uvarint,
    read_uvarint_from,
)
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.types.codec import as_bytes as _bz

MAX_SIGNER_MSG = 1 << 20


class RemoteSignerError(PrivValidatorError):
    pass


def _parse_addr(addr: str) -> tuple[str, object]:
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    if addr.startswith("tcp://"):
        hostport = addr[len("tcp://"):]
        host, _, port = hostport.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    raise ValueError(f"unsupported privval address {addr!r}")


# -- wire --------------------------------------------------------------

def _send(sock: socket.socket, field: int, body: bytes) -> None:
    w = ProtoWriter()
    w.message(field, body)
    payload = w.finish()
    sock.sendall(encode_uvarint(len(payload)) + payload)


def _recv(f) -> tuple[int, bytes]:
    def read_exact(n: int) -> bytes:
        data = f.read(n)
        if data is None or len(data) < n:
            raise EOFError("signer connection closed")
        return data

    size = read_uvarint_from(read_exact, max_value=MAX_SIGNER_MSG)
    fields = ProtoReader(read_exact(size)).to_dict()
    for no, vals in fields.items():
        return no, _bz(vals[0])
    raise ValueError("empty signer message")


def _err_body(msg: str) -> bytes:
    w = ProtoWriter()
    w.string(99, msg)
    return w.finish()


def _body_err(f: dict) -> str | None:
    if 99 in f:
        return _bz(f[99][0]).decode()
    return None


# -- node side ---------------------------------------------------------

class SignerClient:
    """PrivValidator over a remote signer connection
    (privval/signer_client.go SignerClient).  Presents the same surface
    as FilePV: pub_key/address properties, sign_vote, sign_proposal.
    """

    def __init__(self, endpoint: "SignerListenerEndpoint"):
        self._endpoint = endpoint
        self._cached_pub = None

    # identity
    @property
    def pub_key(self):
        if self._cached_pub is None:
            self._cached_pub = self._fetch_pub_key()
        return self._cached_pub

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def get_pub_key(self):
        return self.pub_key

    def _fetch_pub_key(self):
        w = ProtoWriter()
        w.string(1, self._endpoint.chain_id)
        no, body = self._endpoint.request(1, w.finish())
        if no != 2:
            raise RemoteSignerError(f"unexpected signer response {no}")
        f = ProtoReader(body).to_dict()
        err = _body_err(f)
        if err:
            raise RemoteSignerError(err)
        key_type = _bz(f.get(1, [b""])[0]).decode()
        key_bytes = _bz(f.get(2, [b""])[0])
        if key_type != ed.KEY_TYPE:
            raise RemoteSignerError(f"unsupported key type {key_type}")
        return ed.Ed25519PubKey(key_bytes)

    # signing
    def sign_vote(
        self, chain_id: str, vote: Vote, with_extension: bool = False
    ) -> Vote:
        w = ProtoWriter()
        w.string(1, chain_id)
        w.message(2, vote.encode())
        w.varint(3, 1 if with_extension else 0)
        no, body = self._endpoint.request(3, w.finish())
        if no != 4:
            raise RemoteSignerError(f"unexpected signer response {no}")
        f = ProtoReader(body).to_dict()
        err = _body_err(f)
        if err:
            raise RemoteSignerError(err)
        return Vote.decode(_bz(f[1][0]))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        w = ProtoWriter()
        w.string(1, chain_id)
        w.message(2, proposal.encode())
        no, body = self._endpoint.request(5, w.finish())
        if no != 6:
            raise RemoteSignerError(f"unexpected signer response {no}")
        f = ProtoReader(body).to_dict()
        err = _body_err(f)
        if err:
            raise RemoteSignerError(err)
        return Proposal.decode(_bz(f[1][0]))


class SignerListenerEndpoint(BaseService):
    """Node-side endpoint: accept the signer's dial-in and serialize
    request/response exchanges over it
    (privval/signer_listener_endpoint.go)."""

    def __init__(
        self,
        addr: str,
        chain_id: str,
        timeout: float = 5.0,
        accept_timeout: float = 30.0,
        logger: Logger | None = None,
    ):
        super().__init__(name="privval-listener")
        self.addr = addr
        self.chain_id = chain_id
        self.timeout = timeout
        self.accept_timeout = accept_timeout
        self.logger = logger or default_logger().with_fields(
            module="privval"
        )
        self._listener: socket.socket | None = None
        self._conn: socket.socket | None = None
        self._file = None
        self._mtx = cmtsync.Mutex()  # serializes request()
        self._conn_ready = threading.Event()
        self._unix_path: str | None = None

    def on_start(self) -> None:
        kind, target = _parse_addr(self.addr)
        if kind == "unix":
            self._unix_path = target
            try:
                os.unlink(target)
            except FileNotFoundError:
                pass
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
        ls.listen(1)
        self._listener = ls
        threading.Thread(
            target=self._accept_loop, name="privval-accept", daemon=True
        ).start()
        self.logger.info("privval listener up", addr=self.listen_addr)

    def on_stop(self) -> None:
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            ls.close()
        self._drop_conn()
        if self._unix_path:
            try:
                os.unlink(self._unix_path)
            except FileNotFoundError:
                pass

    @property
    def listen_addr(self) -> str:
        if self._listener is None:
            return self.addr
        kind, _ = _parse_addr(self.addr)
        if kind == "unix":
            return self.addr
        host, port = self._listener.getsockname()[:2]
        return f"tcp://{host}:{port}"

    def _accept_loop(self) -> None:
        while self.is_running():
            ls = self._listener
            if ls is None:
                return
            try:
                conn, _ = ls.accept()
            except OSError:
                return
            with self._mtx:
                # a reconnecting signer replaces the old connection
                self._drop_conn_locked()
                self._conn = conn
                self._file = conn.makefile("rb")
                self._conn_ready.set()
            self.logger.info("signer connected")

    def _drop_conn(self) -> None:
        with self._mtx:
            self._drop_conn_locked()

    def _drop_conn_locked(self) -> None:
        conn, self._conn = self._conn, None
        self._conn_ready.clear()
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        if self._file is not None:
            self._file.close()
            self._file = None

    def wait_for_signer(self, timeout: float | None = None) -> bool:
        return self._conn_ready.wait(
            timeout if timeout is not None else self.accept_timeout
        )

    def request(self, field: int, body: bytes) -> tuple[int, bytes]:
        """One request/response exchange; retries once after a
        reconnect window on IO failure (signer_listener_endpoint.go's
        retry semantics, simplified)."""
        for attempt in (0, 1):
            if not self._conn_ready.wait(self.accept_timeout):
                raise RemoteSignerError(
                    "no signer connected within accept deadline"
                )
            with self._mtx:
                conn, f = self._conn, self._file
                if conn is None:
                    continue
                try:
                    conn.settimeout(self.timeout)
                    _send(conn, field, body)
                    no, resp = _recv(f)
                    conn.settimeout(None)
                    return no, resp
                except (OSError, EOFError, ValueError) as exc:
                    self._drop_conn_locked()
                    if attempt == 1:
                        raise RemoteSignerError(
                            f"signer io failed: {exc!r}"
                        ) from exc
        raise RemoteSignerError("signer unavailable")


# -- signer side -------------------------------------------------------

_KINDS = {1: "pub_key", 3: "vote", 5: "proposal", 7: "ping"}


class SignerServer(BaseService):
    """The key-holding process: dial the validator and serve signing
    requests from a FilePV (privval/signer_server.go +
    signer_dialer_endpoint.go retry loop)."""

    def __init__(
        self,
        addr: str,
        chain_id: str,
        pv: FilePV,
        retry_interval: float = 0.5,
        max_dial_retries: int = 60,
        logger: Logger | None = None,
    ):
        super().__init__(name="signer-server")
        self.addr = addr
        self.chain_id = chain_id
        self.pv = pv
        self.retry_interval = retry_interval
        self.max_dial_retries = max_dial_retries
        self.logger = logger or default_logger().with_fields(
            module="signer"
        )
        self._conn: socket.socket | None = None
        #: requests answered, by kind: pub_key, vote, proposal, ping, and
        #: refused (an error body sent back)
        self.served: Counter = Counter()

    def on_start(self) -> None:
        threading.Thread(
            target=self._serve_loop, name="signer-serve", daemon=True
        ).start()

    def on_stop(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def _dial(self) -> socket.socket | None:
        kind, target = _parse_addr(self.addr)
        for _ in range(self.max_dial_retries):
            if not self.is_running():
                return None
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(target)
                else:
                    s = socket.create_connection(target, timeout=3.0)
                    s.settimeout(None)
                return s
            except OSError:
                time.sleep(self.retry_interval)
        return None

    def _serve_loop(self) -> None:
        while self.is_running():
            conn = self._dial()
            if conn is None:
                self.logger.error("signer could not reach validator")
                return
            self._conn = conn
            self.logger.info("signer serving", addr=self.addr)
            f = conn.makefile("rb")
            try:
                while self.is_running():
                    no, body = _recv(f)
                    field, resp = self._handle(no, body)
                    self._count(no, resp)
                    _send(conn, field, resp)
            except (OSError, EOFError, ValueError):
                pass
            finally:
                f.close()
                try:
                    conn.close()
                except OSError:
                    pass
                self._conn = None
            # validator went away: redial (retry loop)

    def _count(self, no: int, resp: bytes) -> None:
        if _body_err(ProtoReader(resp).to_dict()):
            self.served["refused"] += 1
        else:
            self.served[_KINDS.get(no, "unknown")] += 1

    def _handle(self, no: int, body: bytes) -> tuple[int, bytes]:
        f = ProtoReader(body).to_dict()
        # chain binding: the key only ever signs for ITS chain — a
        # compromised node must not be able to shop signatures across
        # chain ids (signer_requestHandlers chainID check)
        if no in (1, 3, 5):
            req_chain = _bz(f.get(1, [b""])[0]).decode()
            if req_chain != self.chain_id:
                return (
                    {1: 2, 3: 4, 5: 6}[no],
                    _err_body(
                        f"chain id mismatch: signer serves "
                        f"{self.chain_id!r}, got {req_chain!r}"
                    ),
                )
        if no == 1:  # PubKeyRequest
            w = ProtoWriter()
            w.string(1, self.pv.pub_key.type())
            w.bytes_(2, self.pv.pub_key.bytes())
            return 2, w.finish()
        if no == 3:  # SignVoteRequest
            chain_id = self.chain_id
            vote = Vote.decode(_bz(f[2][0]))
            with_ext = bool(f.get(3, [0])[0])
            try:
                signed = self.pv.sign_vote(
                    chain_id, vote, with_extension=with_ext
                )
            except PrivValidatorError as exc:
                return 4, _err_body(str(exc))
            w = ProtoWriter()
            w.message(1, signed.encode())
            return 4, w.finish()
        if no == 5:  # SignProposalRequest
            chain_id = self.chain_id
            proposal = Proposal.decode(_bz(f[2][0]))
            try:
                signed = self.pv.sign_proposal(chain_id, proposal)
            except PrivValidatorError as exc:
                return 6, _err_body(str(exc))
            w = ProtoWriter()
            w.message(1, signed.encode())
            return 6, w.finish()
        if no == 7:  # Ping
            return 8, b""
        return 4, _err_body(f"unknown request {no}")


def main(argv=None) -> int:
    """Standalone signer process:
    ``python -m cometbft_tpu_torch.privval.signer --key priv_validator_key.json
    --state priv_validator_state.json --addr tcp://127.0.0.1:26659
    --chain-id my-chain``; on SIGTERM or SIGINT it stops and prints
    ``{"signer_served": {kind: count}}``."""
    import argparse
    import signal as _signal

    parser = argparse.ArgumentParser(description="remote signer")
    parser.add_argument("--key", required=True)
    parser.add_argument("--state", required=True)
    parser.add_argument("--addr", required=True,
                        help="validator's priv_validator_laddr to dial")
    parser.add_argument("--chain-id", required=True)
    args = parser.parse_args(argv)

    pv = FilePV.load(args.key, args.state)
    srv = SignerServer(args.addr, args.chain_id, pv)
    srv.start()
    stop = threading.Event()
    _signal.signal(_signal.SIGTERM, lambda *a: stop.set())
    _signal.signal(_signal.SIGINT, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        srv.stop()
        print(json.dumps({"signer_served": dict(srv.served)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
