"""Authenticated encrypted connection (a copy of
cometbft_tpu/p2p/conn/secret_connection.py; reference:
p2p/conn/secret_connection.go).

Same capability as the reference's Station-to-Station construction
(secret_connection.go:33-50): an ephemeral X25519 Diffie-Hellman
exchange establishes forward-secret symmetric keys; each side then
signs the handshake transcript with its long-lived ed25519 node key to
authenticate; all subsequent traffic flows in fixed-size
ChaCha20-Poly1305-sealed frames so ciphertext length leaks nothing
beyond throughput.

The wire is the reference package's (new format, same guarantees as
CometBFT's): key derivation is HKDF-SHA256 over the DH secret bound to
both ephemeral pubkeys (CometBFT uses a Merlin transcript —
secret_connection.go:88-151); the challenge each side signs is the
HKDF transcript hash.  Frames are 1024 data bytes + 4-byte length,
sealed with a 12-byte little-endian counter nonce
(secret_connection.go:45-50, ``totalFrameSize``/``aeadNonceSize``).

The port's primitives are p2p/conn/handshake_crypto.py's (pure-Python
X25519, stdlib HKDF) and the native frame pump
(csrc/host/frame_crypto.cpp) for every frame; the node key signs and
verifies the challenge with crypto/ed25519.py, one signature each way
on the host.  It does not import `cryptography`.
"""

from __future__ import annotations

import errno
import select
import socket
import struct
import threading
import time

from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey
from cometbft_tpu_torch.metrics import p2p_metrics as _p2p_metrics
from cometbft_tpu_torch.p2p.conn import frame_native
from cometbft_tpu_torch.p2p.conn.handshake_crypto import (
    ChaCha20Poly1305,
    InvalidTag,
    X25519PrivateKey,
    X25519PublicKey,
    hkdf_sha256,
)

# Load (and if needed compile) the native frame pump at import time —
# node startup, not inside a handshake: a first-use g++ build mid-
# handshake would stall past the remote's handshake timeout.  A failed
# build raises here.
_NATIVE_PUMP = frame_native.load()

DATA_LEN_SIZE = 4          # secret_connection.go:40 dataLenSize
# frame geometry is owned by frame_native (shared with the C pump)
DATA_MAX_SIZE = frame_native.DATA_MAX_SIZE          # 1024
TOTAL_FRAME_SIZE = frame_native.TOTAL_FRAME_SIZE    # 1028
SEALED_FRAME_SIZE = frame_native.SEALED_FRAME_SIZE  # 1044
TAG_SIZE = SEALED_FRAME_SIZE - TOTAL_FRAME_SIZE     # poly1305 tag
NONCE_SIZE = 12


class SecretConnectionError(Exception):
    pass


class AuthError(SecretConnectionError):
    pass


def _hkdf(secret: bytes, info: bytes, length: int = 96) -> bytes:
    """HKDF-SHA256 (RFC 5869); replaces the reference's Merlin
    transcript KDF (secret_connection.go:88)."""
    return hkdf_sha256(secret, info, length)


class _Nonce:
    """96-bit little-endian counter nonce (secret_connection.go:47)."""

    def __init__(self) -> None:
        self._counter = 0

    def peek(self, n: int = 1) -> int:
        """The next counter value, validating that ``n`` consecutive
        values are available — WITHOUT consuming them (callers commit
        with take() only after the seal succeeds, so a failed seal
        leaves the counter in sync with what the peer received)."""
        if self._counter + n > 1 << 64:
            raise SecretConnectionError("nonce counter overflow")
        return self._counter

    def take(self, n: int = 1) -> int:
        """Reserve ``n`` consecutive counter values, returning the
        first (the native pump seals a whole write burst per call)."""
        start = self.peek(n)
        self._counter += n
        return start

    def next(self) -> bytes:
        return b"\x00\x00\x00\x00" + struct.pack("<Q", self.take())


class SecretConnection:
    """(secret_connection.go:60 SecretConnection)

    Wraps a socket-like object exposing ``sendall``/``recv``/``close``.
    ``remote_pubkey`` is the peer's authenticated ed25519 node key.
    """

    def __init__(self, sock, priv_key: Ed25519PrivKey):
        handshake_t0 = time.perf_counter()
        self._sock = sock
        self._send_mtx = threading.Lock()
        self._recv_mtx = threading.Lock()
        self._recv_buf = b""
        self.remote_pubkey: Ed25519PubKey | None = None

        # -- handshake (secret_connection.go:88 MakeSecretConnection) --
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        self._sock.sendall(eph_pub)
        their_eph = self._read_exact(32)

        # sort to give both sides the same transcript (secret_connection.go:104)
        lo, hi = sorted((eph_pub, their_eph))
        we_are_lo = eph_pub == lo
        try:
            dh = eph_priv.exchange(
                X25519PublicKey.from_public_bytes(their_eph)
            )
        except ValueError as exc:
            # the backend rejects low-order/invalid peer points with a
            # raw ValueError; adversarial pre-auth input must surface
            # as the typed handshake error (found by guided fuzzing)
            raise SecretConnectionError(
                f"invalid ephemeral public key: {exc}"
            ) from exc
        if dh == b"\x00" * 32:
            raise SecretConnectionError("zero shared secret (low-order point)")

        material = _hkdf(dh, b"COMETBFT_TPU_SECRET_CONNECTION" + lo + hi, 96)
        # lo-side sends with key[0:32], hi-side with key[32:64]
        # (mirrors recvSecret/sendSecret split, secret_connection.go:120)
        if we_are_lo:
            send_key, recv_key = material[0:32], material[32:64]
        else:
            send_key, recv_key = material[32:64], material[0:32]
        challenge = material[64:96]

        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)
        # raw keys for the native pump (batched seal on write bursts,
        # batched open when the socket has several frames buffered)
        self._send_key = send_key
        self._recv_key = recv_key
        self._sealed_buf = bytearray()
        # deferred receive error: a batched open that failed mid-burst
        # first delivers the valid prefix (sequential semantics), then
        # raises this on the following read
        self._recv_err: SecretConnectionError | None = None
        # deferred fd error from the opportunistic drain: surfaced only
        # after every already-buffered complete frame is delivered
        self._drain_err: OSError | None = None
        self._can_select: bool | None = None
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        # native frame pump (one C call per write burst)
        self._native = _NATIVE_PUMP

        # -- authenticate (secret_connection.go:151 shareAuthSignature) --
        pub = priv_key.pub_key()
        sig = priv_key.sign(challenge)
        self.write(pub.bytes() + sig)
        try:
            auth = self.read_exact(96)  # buffers any coalesced overrun back
        except SecretConnectionError as exc:
            raise AuthError("peer closed during auth handshake") from exc
        their_pub = Ed25519PubKey(auth[:32])
        their_sig = auth[32:96]
        if not their_pub.verify_signature(challenge, their_sig):
            raise AuthError("peer failed challenge signature")
        self.remote_pubkey = their_pub
        # only a COMPLETED handshake is observed — a failed one raised
        # above, and its latency would skew the histogram with peer
        # misbehavior rather than our DH/HKDF/signature cost
        _p2p_metrics().handshake_duration_seconds.observe(
            time.perf_counter() - handshake_t0
        )

    # -- framed I/O (secret_connection.go:210 Write / :250 Read) --------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise SecretConnectionError("connection closed")
            buf += chunk
        return buf

    def write(self, data: bytes) -> int:
        """Seal ``data`` into as many frames as needed.

        A burst of two frames or more seals in ONE pump call and leaves
        as ONE sendall — no per-frame interpreter work."""
        total = len(data)
        with self._send_mtx:
            nframes = frame_native.frame_count(total)
            _p2p_metrics().secret_frames_total.labels(
                direction="seal"
            ).inc(nframes)
            # the reference's crossover: a multi-frame burst seals in
            # one pump call, a single frame through the raw AEAD
            # (both native)
            if nframes >= 2:
                nonce0 = self._send_nonce.peek(nframes)
                try:
                    sealed = frame_native.seal_frames(
                        self._native, self._send_key, nonce0, data,
                        nframes=nframes,
                    )
                except ValueError as exc:
                    # counter stays unconsumed: the peer received
                    # nothing, so the stream is still in sync
                    raise SecretConnectionError(
                        f"native frame seal failed: {exc}"
                    ) from exc
                self._send_nonce.take(nframes)
                self._sock.sendall(sealed)
                return total
            off = 0
            while True:
                chunk = data[off : off + DATA_MAX_SIZE]
                frame = struct.pack("<I", len(chunk)) + chunk
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                sealed = self._send_aead.encrypt(
                    self._send_nonce.next(), frame, None
                )
                self._sock.sendall(sealed)
                off += len(chunk)
                if off >= total:
                    break
        return total

    #: most sealed frames a single batched read() will drain (32 KB of
    #: payload per native open call; bounds the buffer, not throughput)
    MAX_READ_FRAMES = 32

    def _drain_available(self) -> None:
        """Pull whatever the OS has ALREADY buffered into _sealed_buf
        without blocking — the batched native open then processes every
        complete frame in one call.  No-op for socket-likes without a
        selectable fd (test doubles)."""
        if self._can_select is None:
            try:
                self._sock.fileno()
                self._can_select = True
            except (AttributeError, OSError):
                self._can_select = False
        if not self._can_select:
            return
        cap = self.MAX_READ_FRAMES * SEALED_FRAME_SIZE
        while len(self._sealed_buf) < cap:
            try:
                ready, _, _ = select.select([self._sock], [], [], 0)
            except (OSError, ValueError):
                return
            if not ready:
                return
            try:
                chunk = self._sock.recv(cap - len(self._sealed_buf))
            except OSError as exc:
                # transient conditions (interrupted syscall, spurious
                # readiness) just end this opportunistic drain; a real
                # fd error (reset, bad fd) is PARKED and surfaced by
                # read() once the complete frames already buffered have
                # been delivered — raising here would strand them.
                # errno None means no fd-level error at all
                # (socket.timeout and friends carry no errno): with a
                # socket timeout set (it is during handshake), a
                # spuriously-ready fd would raise timeout here — that
                # is a transient drain-ender, not a connection failure.
                if exc.errno is not None and exc.errno not in (
                    errno.EINTR, errno.EAGAIN, errno.EWOULDBLOCK
                ):
                    self._drain_err = exc
                return
            if not chunk:
                return  # EOF; complete frames already read still count
            self._sealed_buf += chunk

    def read(self) -> bytes:
        """Return the data of the next frame(s) ('' on EOF).

        One frame is read blocking; any further frames the socket has
        already buffered are drained and opened in the SAME C call —
        their payloads return concatenated, which read_exact()'s
        buffering makes transparent to callers."""
        with self._recv_mtx:
            if self._recv_buf:
                out, self._recv_buf = self._recv_buf, b""
                return out
            if self._recv_err is not None:
                raise self._recv_err
            if (
                self._drain_err is not None
                and len(self._sealed_buf) < SEALED_FRAME_SIZE
            ):
                # buffered frames are exhausted: deliver the fd error
                # the drain parked (a blocking recv would raise it
                # anyway — this surfaces it one read sooner, typed)
                err, self._drain_err = self._drain_err, None
                raise err
            while len(self._sealed_buf) < SEALED_FRAME_SIZE:
                # OSError (timeout, reset) propagates distinctly —
                # only an orderly EOF reads as the empty string
                chunk = self._sock.recv(
                    SEALED_FRAME_SIZE - len(self._sealed_buf)
                )
                if not chunk:
                    return b""
                self._sealed_buf += chunk
            self._drain_available()
            nframes = len(self._sealed_buf) // SEALED_FRAME_SIZE
            take = nframes * SEALED_FRAME_SIZE
            with memoryview(self._sealed_buf) as mv:
                sealed = bytes(mv[:take])
            del self._sealed_buf[:take]
            if nframes > 1:
                payload, opened, err = frame_native.open_frames_partial(
                    self._native,
                    self._recv_key,
                    self._recv_nonce.peek(nframes),
                    sealed,
                )
                self._recv_nonce.take(opened)
                _p2p_metrics().secret_frames_total.labels(
                    direction="open"
                ).inc(opened)
                if err is not None:
                    # sequential semantics: everything a frame-by-frame
                    # reader would have delivered before the bad frame
                    # goes out now; the error fires on the next read
                    self._recv_err = SecretConnectionError(err)
                    if not payload:
                        raise self._recv_err
                return payload
            try:
                frame = self._recv_aead.decrypt(
                    self._recv_nonce.next(), sealed, None
                )
            except InvalidTag as exc:
                raise SecretConnectionError("frame auth failed") from exc
            _p2p_metrics().secret_frames_total.labels(
                direction="open"
            ).inc()
            (length,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
            if length > DATA_MAX_SIZE:
                raise SecretConnectionError("invalid frame length")
            return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length]

    def read_exact(self, n: int) -> bytes:
        """Read exactly n plaintext bytes (buffers frame remainders)."""
        out = b""
        while len(out) < n:
            chunk = self.read()
            if not chunk:
                raise SecretConnectionError("connection closed")
            out += chunk
        with self._recv_mtx:
            out, extra = out[:n], out[n:]
            if extra:
                self._recv_buf = extra + self._recv_buf
        return out

    def close(self) -> None:
        # shutdown before close: close() alone defers the FIN while another
        # thread sits blocked in recv() (the in-flight syscall pins the fd),
        # so the remote would never see EOF.  shutdown tears the stream down
        # immediately and unblocks both sides' readers.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass


__all__ = [
    "SecretConnection",
    "SecretConnectionError",
    "AuthError",
    "DATA_MAX_SIZE",
    "TOTAL_FRAME_SIZE",
    "SEALED_FRAME_SIZE",
]
