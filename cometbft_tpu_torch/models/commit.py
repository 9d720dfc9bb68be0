"""Commit verification as one forward step (the port of
cometbft_tpu/models/commit.py): verify every signature of a commit, or of
a batch of commits, on the generic device tier -- the hot path behind
VerifyCommit (types/validation.go:220), light-client header sync
(light/verifier.go) and blocksync replay
(internal/blocksync/reactor.go:550).

Arrays are feature-first, as in the reference: byte strings lead with
their byte axis and the batch axes follow, so (V,) is one commit of V
validators and (H, V) is H headers of V validators each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import jitguard as _jitguard
from cometbft_tpu_torch.utils.env import resolve_device

# Vote sign-bytes are ~120 bytes (canonical proto + chain id); bucket 128
# needs ceil((64+128+17)/128) = 2 SHA-512 blocks.
MSG_BUCKET = 128
NBLOCKS = 2


def commit_verify_step(pub, sig, msg, msglen, device=None) -> torch.Tensor:
    """One forward step: pub (32, *batch) uint8, sig (64, *batch) uint8,
    msg (128, *batch) uint8, msglen (*batch,) int -> (*batch,) bool on
    ``device`` (numpy arrays or tensors).  Trailing batch dims are free.

    Runs on ``cuda`` unless the caller passes ``device="cpu"``: the
    packed rows go to the device in one copy, then each MAX_LAUNCH-lane
    slice is the sha512_keyed and verify_generic kernels on the card, or
    their plain versions on the CPU (``verify_generic_rows``)."""
    dev = resolve_device(device)
    packed, batch = pack_feature_first(pub, sig, msg, msglen, MSG_BUCKET)
    with _jitguard.audited():
        packed = packed.to(dev)
    return EV.verify_generic_rows(packed, MSG_BUCKET).reshape(batch)


def pack_feature_first(pub, sig, msg, msglen, bucket: int):
    """Feature-first pub (32, *B), sig (64, *B), msg (bucket, *B) uint8
    and msglen (*B,) (numpy arrays or tensors, on one device) -> (the
    generic tier's packed rows (100 + bucket, prod(B)) uint8 on that
    device, B)."""
    pub, sig, msg, msglen = (torch.as_tensor(x) for x in (pub, sig, msg, msglen))
    batch = tuple(pub.shape[1:])
    if (pub.shape[0] != 32 or sig.shape != (64, *batch)
            or msg.shape != (bucket, *batch) or tuple(msglen.shape) != batch):
        raise ValueError(
            f"commit_verify_step: expected pub (32, *B), sig (64, *B), msg "
            f"({bucket}, *B), msglen B; got {tuple(pub.shape)}, {tuple(sig.shape)}, "
            f"{tuple(msg.shape)}, {tuple(msglen.shape)}")
    n = math.prod(batch)
    lens = msglen.reshape(n).to(torch.int64)
    len_rows = torch.stack([(lens >> (8 * i)) & 0xFF for i in range(4)])
    packed = torch.cat([
        pub.reshape(32, n).to(torch.uint8), sig.reshape(64, n).to(torch.uint8),
        msg.reshape(bucket, n).to(torch.uint8), len_rows.to(torch.uint8),
    ])
    return packed, batch


def example_inputs(
    shape: tuple[int, ...] = (64,),
    msglen: int = 120,
    seed: int = 7,
    invalid: np.ndarray | None = None,
):
    """(pub, sig, msg, msglen) example batch, host-generated numpy,
    feature-first: pub (32, *shape), sig (64, *shape), msg (128, *shape),
    msglen *shape.  One key signs distinct random messages.

    Unlike the reference, which draws a fresh random key, the key here
    is derived from ``seed`` (``priv_key_from_secret``), so the whole
    batch is a function of the seed.

    ``invalid`` (bool array of ``shape``) flips a signature byte in the
    marked lanes, so a caller can require that exactly those lanes come
    back false -- a constant-true verifier fails such a check."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    pub = np.zeros((n, 32), dtype=np.uint8)
    sig = np.zeros((n, 64), dtype=np.uint8)
    msg = np.zeros((n, MSG_BUCKET), dtype=np.uint8)
    lens = np.full((n,), msglen, dtype=np.int32)
    priv = ed.priv_key_from_secret(b"commit-example-%d" % seed)
    pub_bytes = np.frombuffer(priv.pub_key().bytes(), dtype=np.uint8)
    for i in range(n):
        m = rng.randint(0, 256, size=msglen, dtype=np.uint8).tobytes()
        pub[i] = pub_bytes
        sig[i] = np.frombuffer(priv.sign(m), dtype=np.uint8)
        msg[i, :msglen] = np.frombuffer(m, dtype=np.uint8)
    if invalid is not None:
        flat = np.asarray(invalid, dtype=bool).reshape(n)
        sig[flat, 40] ^= 0x55  # corrupt S: marked lanes must verify False
    return (
        pub.T.reshape(32, *shape).copy(),
        sig.T.reshape(64, *shape).copy(),
        msg.T.reshape(MSG_BUCKET, *shape).copy(),
        lens.reshape(shape),
    )
