"""ctypes binding for the secret connection's native frame pump
(csrc/host/frame_crypto.cpp; a copy of
cometbft_tpu/p2p/conn/frame_native.py without its build-on-demand
loader and its off switch).

The library is built by g++ through ops/_build.py, like the host
verifier, and a failed build raises: the port has no other frame path.
The win over a Python loop is structural, not cipher speed: one C call
seals a whole write's frames into one contiguous buffer (single
sendall, no per-frame interpreter work, no per-frame allocations), the
pattern the reference's sendRoutine batches toward
(p2p/conn/secret_connection.go:33-50).
"""

from __future__ import annotations

import ctypes

from cometbft_tpu_torch.ops import _build

DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = 1028
SEALED_FRAME_SIZE = 1044


def load() -> ctypes.CDLL:
    """The native library, built by g++ at first use (ops/_build.py);
    a failed build raises with g++'s stderr."""
    return _build.library("frame_crypto")


def frame_count(length: int) -> int:
    """Frames a ``length``-byte write seals into (empty writes still
    send one empty frame) — the ONE definition callers reserving nonce
    ranges share with the seal itself."""
    return max(1, (length + DATA_MAX_SIZE - 1) // DATA_MAX_SIZE)


def seal_frames(
    lib, key: bytes, nonce0: int, data: bytes, nframes: int | None = None
) -> memoryview:
    """data -> contiguous sealed frames (n * 1044 bytes).

    Returns a memoryview over the C output buffer (sendall and all
    bytes-likes accept it) — no copy of the burst on the hot path."""
    if nframes is None:
        nframes = frame_count(len(data))
    out = (ctypes.c_uint8 * (nframes * SEALED_FRAME_SIZE))()
    rc = lib.cmt_frames_seal(
        key, nonce0, data, len(data), out, len(out)
    )
    if rc != nframes:
        raise ValueError(f"native frame seal failed: rc={rc}")
    return memoryview(out).cast("B")


def open_frames_partial(
    lib, key: bytes, nonce0: int, sealed: bytes
) -> tuple[bytes, int, str | None]:
    """Contiguous sealed frames -> (payload, frames_opened, error).

    Sequential semantics for batched readers: the C side stops at the
    first bad frame, and everything a sequential reader would have
    delivered BEFORE it comes back as the payload prefix (one copy out
    of the C buffer — no per-frame split).  ``error`` is None on full
    success; otherwise a message naming the bad frame, with
    ``frames_opened`` telling the caller how many nonces were
    legitimately consumed first.
    """
    n, rem = divmod(len(sealed), SEALED_FRAME_SIZE)
    if rem or n == 0:
        raise ValueError("sealed buffer is not whole frames")
    out = (ctypes.c_uint8 * (n * DATA_MAX_SIZE))()
    lens = (ctypes.c_uint32 * n)()
    rc = lib.cmt_frames_open(
        key, nonce0, sealed, n, out, len(out), lens
    )
    if rc >= 0:
        return bytes(memoryview(out)[:rc]), n, None
    if rc <= -2000000:
        # resource failure: nothing was verified, nothing consumed
        return b"", 0, f"frame pump resource failure (rc={rc})"
    if rc <= -1000000:
        bad = -1000000 - rc
        err = f"invalid frame length (frame {bad})"
    else:
        bad = -rc - 1
        err = f"frame auth failed (frame {bad})"
    prefix = sum(lens[i] for i in range(bad))
    return bytes(memoryview(out)[:prefix]), bad, err


def open_frames(lib, key: bytes, nonce0: int, sealed: bytes) -> bytes:
    """Contiguous sealed frames -> concatenated payload; raises
    ValueError on any bad frame (callers translate into their typed
    connection error)."""
    payload, _, err = open_frames_partial(lib, key, nonce0, sealed)
    if err is not None:
        raise ValueError(err)
    return payload
