"""Signed-tx admission envelope — the device-batched CheckTx plane (a
copy of cometbft_tpu/mempool/ingest.py).

The north star serves "heavy traffic from millions of users", and on
a real chain every one of those users' transactions carries a sender
signature the mempool must verify before admission.  PAPERS.md's
"Performance of EdDSA and BLS Signatures in Committee-Based
Consensus" measures exactly this bottleneck: once the consensus path
is fast, per-signature host verification of *transactions* dominates.
This module defines the envelope that makes admission
signature-bearing, and ``CListMempool.check_tx`` routes its
verification through the process-wide VerifyQueue's low-priority
``ingest`` lane (crypto/verify_queue.py) — concurrent CheckTx calls
coalesce into single DispatchLadder launches while consensus and
prefetch work strictly preempt them.

Envelope layout (kvstore-compatible: the payload rides along intact,
so a committed signed tx still executes as ``key=value``)::

    stx:<pubkey-hex 64><signature-hex 128>:<payload>

The signature is Ed25519 over ``b"stx|" + payload`` — domain-separated
so an admission signature can never be replayed as a vote or proposal
signature (their sign-bytes are length-prefixed proto encodings that
cannot collide with the ``stx|`` prefix).

Unsigned txs (no ``stx:`` prefix) admit exactly as before this module
existed: the envelope is opt-in per tx, so every existing caller,
test, and workload is untouched.  A tx that CLAIMS the prefix but is
malformed (bad hex, wrong lengths) is rejected loudly — an envelope
is a promise.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import ed25519 as _ed

#: envelope marker; everything after it is fixed-width hex + payload
SIGNED_TX_PREFIX = b"stx:"
#: domain separator for the admission sign-bytes (module docstring)
SIGN_BYTES_PREFIX = b"stx|"

_PUB_HEX = _ed.PUB_KEY_SIZE * 2  # 64
_SIG_HEX = _ed.SIGNATURE_SIZE * 2  # 128
_HEADER_LEN = len(SIGNED_TX_PREFIX) + _PUB_HEX + _SIG_HEX + 1


class MalformedSignedTx(ValueError):
    """``stx:``-prefixed tx whose envelope does not parse."""


def sign_bytes(payload: bytes) -> bytes:
    """The bytes the sender signs (domain-separated payload)."""
    return SIGN_BYTES_PREFIX + payload


def make_signed_tx(priv_key, payload: bytes) -> bytes:
    """Wrap ``payload`` in a signed admission envelope."""
    pub = priv_key.pub_key().bytes()
    sig = priv_key.sign(sign_bytes(payload))
    return (
        SIGNED_TX_PREFIX
        + pub.hex().encode()
        + sig.hex().encode()
        + b":"
        + payload
    )


def parse_signed_tx(tx: bytes) -> tuple[bytes, bytes, bytes] | None:
    """``(pubkey, signature, payload)`` for an enveloped tx, ``None``
    for a plain one.  Raises :class:`MalformedSignedTx` when the
    prefix is present but the envelope is broken — a tx claiming to be
    signed must verify or be rejected, never silently admit as
    unsigned."""
    if not tx.startswith(SIGNED_TX_PREFIX):
        return None
    if len(tx) < _HEADER_LEN:
        raise MalformedSignedTx("signed tx shorter than its envelope")
    body = tx[len(SIGNED_TX_PREFIX):]
    pub_hex = body[:_PUB_HEX]
    sig_hex = body[_PUB_HEX:_PUB_HEX + _SIG_HEX]
    if body[_PUB_HEX + _SIG_HEX:_PUB_HEX + _SIG_HEX + 1] != b":":
        raise MalformedSignedTx("signed tx envelope missing separator")
    try:
        pub = bytes.fromhex(pub_hex.decode())
        sig = bytes.fromhex(sig_hex.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise MalformedSignedTx(f"signed tx envelope: {exc}") from None
    payload = tx[_HEADER_LEN:]
    return pub, sig, payload


def signed_tx_payload(tx: bytes) -> bytes:
    """The payload a committed enveloped tx executes as (the envelope
    itself for plain txs — identity for everything unsigned)."""
    try:
        parsed = parse_signed_tx(tx)
    except MalformedSignedTx:
        return tx
    return tx if parsed is None else parsed[2]


__all__ = [
    "MalformedSignedTx",
    "SIGNED_TX_PREFIX",
    "SIGN_BYTES_PREFIX",
    "make_signed_tx",
    "parse_signed_tx",
    "sign_bytes",
    "signed_tx_payload",
]
