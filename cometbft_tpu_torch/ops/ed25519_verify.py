"""Keyed Ed25519 batch verification on the device (the port of the keyed
tier of cometbft_tpu/ops/ed25519_verify.py) and ``TorchBatchVerifier``.

For every lane the device checks the cofactored ZIP-215 equation

    [8]([S]B + [k](-A) - R) == identity,   k = SHA-512(R || A || M) mod L,

with [S]B from the shared 8-bit comb of B and [k](-A) from the
validator set's per-key comb tables (ops/precompute.py), plus R's
decompression, S < L and the key's validity.  Results come back as one
bool per signature.

On the card a slice is three steps: the padded input (torch ops), the
sha512_padded kernel, and the verify_keyed kernel, which runs
everything after the digest for a lane in one thread
(csrc/verify_keyed.cu).  ``verify_keyed_plain`` is that kernel's plain
version, composed from ops/curve.py, ops/scalar.py and
ops/precompute.py.

Layouts are the reference's: the packed buffer is feature-first
(104 + bucket, B) uint8 -- pub[32] | sig[64] | msg[bucket] |
msglen_le[4] | key_id_le[4] -- padded to a power-of-two batch and a
message-length bucket.  Batches wider than MAX_LAUNCH run as a loop of
MAX_LAUNCH-lane slices; the slices' results are concatenated on the
device and come back with one copy per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import BatchVerifier, PubKey
from cometbft_tpu_torch.crypto import ed25519 as _ed
from cometbft_tpu_torch.crypto import edwards as _ref
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.ops import scalar as SC
from cometbft_tpu_torch.ops import sha512 as SH
from cometbft_tpu_torch.utils.env import resolve_device

# Message-length buckets (bytes). Vote sign-bytes are ~120 bytes; the
# largest bucket covers arbitrary app-level uses.
_BUCKETS = (128, 256, 512, 1024, 4096)
_MIN_BATCH = 8

#: Largest single device launch (lanes); wider batches run in slices.
MAX_LAUNCH = 8192

#: Smallest batch that takes the device when its tables are already
#: warm; below it the per-signature floor runs.
DEVICE_MIN_BATCH = 64


def nblocks_for_bucket(bucket: int) -> int:
    """SHA-512 block count for a message bucket: 64 bytes of R||A, the
    bucket, and 17 bytes of minimal padding, in 128-byte blocks."""
    return (64 + bucket + 17 + 127) // 128


def build_padded_input(r_enc, a_enc, msg, msglen, nblocks: int):
    """R || A || M with per-lane FIPS 180-4 padding, vectorized.

    r_enc/a_enc (32, B) uint8, msg (M, B) uint8, msglen (B,) int.
    Each lane's 0x80 marker and 16-byte big-endian bit length land at
    the end of its OWN final block.  Returns (buf (nblocks*128, B)
    uint8, nblocks_lane (B,) int64)."""
    dev = msg.device
    width = nblocks * 128
    content = torch.zeros((width, *msg.shape[1:]), dtype=torch.int64, device=dev)
    content[:32] = r_enc
    content[32:64] = a_enc
    content[64 : 64 + msg.shape[0]] = msg
    total = (64 + msglen.to(torch.int64))[None]           # (1, B)
    nblocks_lane = (total + 17 + 127) // 128
    lane_width = nblocks_lane * 128
    idx = torch.arange(width, dtype=torch.int64, device=dev).reshape(
        (width,) + (1,) * (msg.dim() - 1)
    )
    buf = torch.where(idx < total, content, 0)
    buf = torch.where(idx == total, 0x80, buf)
    pos_from_end = lane_width - 1 - idx
    lenbyte = ((total * 8) >> torch.clamp(8 * pos_from_end, 0, 56)) & 0xFF
    buf = torch.where((pos_from_end >= 0) & (pos_from_end < 8), lenbyte, buf)
    return buf.to(torch.uint8), nblocks_lane[0]


def _le32(rows: torch.Tensor) -> torch.Tensor:
    b = rows.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def keyed_digest(buf: torch.Tensor, bucket: int, nblocks: int) -> torch.Tensor:
    """SHA-512(R || A || M) per lane of the packed rows: (104+bucket, B)
    uint8 -> (64, B) uint8 (the sha512_padded kernel on a CUDA tensor)."""
    msglen = _le32(buf[96 + bucket : 100 + bucket])
    padded, nblocks_lane = build_padded_input(
        buf[32:64], buf[:32], buf[96 : 96 + bucket], msglen, nblocks
    )
    return SH.sha512_padded(padded, nblocks, nblocks_lane)


def verify_keyed_plain(buf, digest, table, key_valid, b_table, bucket: int,
                       window_bits: int):
    """The plain PyTorch version of the verify_keyed kernel: -> ((B,)
    bool verdicts, (4, 26, B) int32 limbs of [8]q).

    buf (104+bucket, B) uint8 packed rows pub[32] | sig[64] | msg[bucket]
    | msglen_le[4] | key_id_le[4]; digest (64, B) uint8 from
    :func:`keyed_digest`; table (nwin, 4, 26, cap*nent) int32; key_valid
    (cap,) bool; b_table the (32, 3, 26, 256) comb of B.  Its field
    products go through fe_mul / fe_sq, so on a CUDA tensor it is a
    composition of field-kernel launches and torch ops."""
    r_enc, s_bytes = buf[32:64], buf[64:96]
    key_ids = _le32(buf[100 + bucket : 104 + bucket])
    r_pt, r_ok = C.decompress(r_enc)
    s_ok = SC.bytes_lt_l(s_bytes)
    k_limbs = SC.reduce_digest(digest)
    if window_bits == 8:
        k_win = SC.limbs_to_windows8(k_limbs)
    else:
        k_win = SC.limbs_to_nibbles(k_limbs)
    p1 = PR.comb_mul_base8(s_bytes, b_table)                     # [S]B
    p2 = PR.comb_mul_keyed(table, key_ids, k_win, window_bits)   # [k](-A)
    q8 = C.mul8(C.pt_add(C.pt_add(p1, p2), C.pt_neg(r_pt)))
    ok = C.pt_is_identity(q8) & r_ok & s_ok & key_valid[key_ids.to(torch.int64)]
    return ok, torch.stack(q8)


def verify_keyed_fused(buf, digest, table, key_valid, b_table, bucket: int,
                       window_bits: int, out_point=None) -> torch.Tensor:
    """Keyed verify of the packed rows after SHA-512: (B,) bool verdicts
    (arguments as :func:`verify_keyed_plain`).  ``out_point``, a (4, 26,
    B) int32 tensor, receives the limbs of [8]q when given.

    A CUDA tensor goes through the verify_keyed kernel (one launch, one
    thread per lane; csrc/verify_keyed.cu), a CPU tensor through
    verify_keyed_plain."""
    if buf.dim() != 2 or buf.shape[0] != 104 + bucket or buf.dtype != torch.uint8:
        raise ValueError(f"verify_keyed: expected ({104 + bucket}, B) uint8 rows, "
                         f"got {tuple(buf.shape)} {buf.dtype}")
    if window_bits not in (8, 4):
        raise ValueError(f"verify_keyed: window_bits must be 8 or 4, got {window_bits}")
    n = buf.shape[1]
    nent = 1 << window_bits
    if (table.dim() != 4 or table.shape[:3] != (256 // window_bits, 4, F.NLIMBS)
            or table.shape[3] != key_valid.shape[0] * nent):
        raise ValueError(f"verify_keyed: table {tuple(table.shape)} does not match "
                         f"window_bits={window_bits} and {key_valid.shape[0]} keys")
    if out_point is not None and (out_point.shape != (4, F.NLIMBS, n)
                                  or out_point.dtype != F.DTYPE):
        raise ValueError("verify_keyed: out_point must be (4, 26, B) int32")
    if buf.device.type == "cpu":
        ok, q8 = verify_keyed_plain(buf, digest, table, key_valid, b_table,
                                    bucket, window_bits)
        if out_point is not None:
            out_point.copy_(q8)
        return ok
    if buf.device.type != "cuda":
        raise ValueError(f"verify_keyed: unsupported device {buf.device}")
    if buf.stride(1) != 1:
        raise ValueError("verify_keyed: the rows' lanes must be contiguous")
    if digest.shape != (64, n) or digest.dtype != torch.uint8:
        raise ValueError(f"verify_keyed: digest must be (64, {n}) uint8")
    for name, t, dtype in (("digest", digest, torch.uint8), ("table", table, F.DTYPE),
                           ("key_valid", key_valid, torch.bool),
                           ("b_table", b_table, F.DTYPE),
                           ("out_point", out_point, F.DTYPE)):
        if t is None:
            continue
        if t.device != buf.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"verify_keyed: {name} must be a contiguous {dtype} "
                             f"tensor on {buf.device}")
    if b_table.shape != (32, 3, F.NLIMBS, 256):
        raise ValueError(f"verify_keyed: b_table {tuple(b_table.shape)}")
    if F.NLIMBS * table.shape[3] >= 1 << 31:
        raise ValueError("verify_keyed: pool too wide for 32-bit limb strides")
    ok = torch.empty(n, dtype=torch.bool, device=buf.device)
    rc = _build.library("verify_keyed").verify_keyed_launch(
        buf.data_ptr(), buf.stride(0), bucket, digest.data_ptr(), table.data_ptr(),
        table.shape[3], key_valid.data_ptr(), key_valid.shape[0], b_table.data_ptr(),
        ok.data_ptr(), None if out_point is None else out_point.data_ptr(), n,
        window_bits, torch.cuda.current_stream(buf.device).cuda_stream,
    )
    _build.check(rc, "verify_keyed")
    _build.LAUNCHES["verify_keyed"] += 1
    return ok


def pack_inputs(pub: np.ndarray, sig: np.ndarray, msgs: list[bytes],
                start: int = 0, end: int | None = None,
                key_ids: np.ndarray | None = None) -> tuple[np.ndarray, int]:
    """Pad + pack (pub, sig, msgs[start:end]) into the feature-first
    (100+bucket, batch) uint8 layout -- (104+bucket, batch) with 4 LE
    key-id bytes per lane when ``key_ids`` is given.  Returns (packed,
    bucket).  Padded lanes are all zero: key id 0, zero windows."""
    if end is None:
        end = len(msgs)
    n = end - start
    lens = np.fromiter((len(msgs[i]) for i in range(start, end)),
                       dtype=np.int64, count=n)
    maxlen = int(lens.max()) if n else 0
    bucket = next((b for b in _BUCKETS if b >= maxlen), None)
    if bucket is None:
        raise ValueError(f"message too large for device path: {maxlen}")
    batch = max(PR.next_pow2(n), _MIN_BATCH)
    tail = 100 if key_ids is None else 104
    packed = np.zeros((tail + bucket, batch), dtype=np.uint8)
    packed[:32, :n] = pub[start:end].T
    packed[32:96, :n] = sig[start:end].T
    flat = np.frombuffer(b"".join(msgs[start:end]), dtype=np.uint8)
    if n and (lens == lens[0]).all():
        if lens[0]:
            packed[96 : 96 + int(lens[0]), :n] = flat.reshape(n, -1).T
    elif n:
        offs = np.concatenate([[0], np.cumsum(lens)])
        col = np.repeat(np.arange(n), lens)
        row = 96 + (np.arange(len(flat)) - offs[col])
        packed[row, col] = flat
    packed[96 + bucket : 100 + bucket, :n] = (
        lens.astype("<u4").view(np.uint8).reshape(n, 4).T
    )
    if key_ids is not None:
        packed[100 + bucket : 104 + bucket, :n] = (
            key_ids[start:end].astype("<u4").view(np.uint8).reshape(n, 4).T
        )
    return packed, bucket


def verify_arrays_keyed(entry: PR.KeySetTables, key_ids: np.ndarray,
                        pub: np.ndarray, sig: np.ndarray,
                        msgs: list[bytes]) -> np.ndarray:
    """Host entry of the keyed path: numpy (n, 32), (n, 64), n messages
    and their key ids in ``entry`` -> bool[n].  Runs on the device that
    holds ``entry.table``: one host-to-device copy of the packed batch,
    MAX_LAUNCH-lane slices, one device-to-host copy of the verdicts."""
    n = len(msgs)
    packed, bucket = pack_inputs(pub, sig, msgs, key_ids=key_ids)
    batch = packed.shape[-1]
    if batch > MAX_LAUNCH and batch % MAX_LAUNCH:
        packed = np.pad(packed, [(0, 0), (0, MAX_LAUNCH - batch % MAX_LAUNCH)])
        batch = packed.shape[-1]
    nblocks = nblocks_for_bucket(bucket)
    buf = torch.from_numpy(packed).to(entry.table.device)
    key_valid = entry.valid_device()
    b_table = F.const(PR.b_comb8(), buf.device)
    outs = []
    for s in range(0, batch, MAX_LAUNCH):
        rows = buf[:, s : s + MAX_LAUNCH]
        outs.append(verify_keyed_fused(
            rows, keyed_digest(rows, bucket, nblocks), entry.table, key_valid,
            b_table, bucket, entry.window_bits,
        ))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.cpu().numpy()[:n]


class _VerifyPlan:
    """Output of :meth:`TorchBatchVerifier.plan`: the route and what
    :meth:`TorchBatchVerifier.execute` needs to run it."""

    __slots__ = ("n", "route", "reason", "entry", "key_ids", "pub", "sig",
                 "msgs", "pubs", "sigs")

    def __init__(self) -> None:
        self.n = 0
        self.route = "empty"      # "empty" | "keyed" | "python"
        self.reason = "batch_size"
        self.entry = None
        self.key_ids = None
        self.pub = None
        self.sig = None
        self.msgs: list[bytes] = []
        self.pubs: list[bytes] = []
        self.sigs: list[bytes] = []


class TorchBatchVerifier(BatchVerifier):
    """BatchVerifier on the keyed device path (the counterpart of
    cometbft_tpu's TpuBatchVerifier, reference slot
    crypto/ed25519/ed25519.go:190).

    Routing (``plan``): a batch of at least ``device_min_batch``
    signatures looks up -- building if needed -- its key set's tables;
    a batch of DEVICE_MIN_BATCH or more but below that takes the device
    only when the tables are already warm (``peek``).  Anything else,
    or a message over 4096 bytes, runs the per-signature oracle floor.
    ``last_tier`` records the tier that ran: "keyed" or "python".

    A fault in a device launch propagates to the caller; it is never
    caught and re-run on the floor."""

    def __init__(self, device=None, device_min_batch: int = DEVICE_MIN_BATCH,
                 cache: PR.KeyTableCache | None = None) -> None:
        self.device = resolve_device(device)
        self._device_min_batch = device_min_batch
        self._cache = cache if cache is not None else PR.table_cache(self.device)
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []
        self.last_tier: str | None = None

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type() != _ed.KEY_TYPE:
            raise TypeError("TorchBatchVerifier requires ed25519 keys")
        if len(sig) != _ed.SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._pubs.append(pub_key.bytes())
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def __len__(self) -> int:
        return len(self._pubs)

    def plan(self) -> _VerifyPlan:
        """Host phase: the route (table lookup or warm peek) and the
        packed pub/sig arrays."""
        plan = _VerifyPlan()
        n = plan.n = len(self._pubs)
        if n == 0:
            return plan
        plan.pubs, plan.msgs, plan.sigs = self._pubs, self._msgs, self._sigs
        entry = None
        if max(len(m) for m in self._msgs) > _BUCKETS[-1]:
            plan.reason = "msg_too_large"
        elif n >= self._device_min_batch:
            entry = self._cache.lookup_or_build(self._pubs)
            plan.reason = "table_policy" if entry is None else "batch_size"
        elif n >= DEVICE_MIN_BATCH:
            entry = self._cache.peek(self._pubs)
            plan.reason = "keyed_warm" if entry is not None else "batch_size"
        if entry is None:
            plan.route = "python"
            return plan
        plan.route = "keyed"
        plan.entry = entry
        plan.key_ids = entry.key_ids(self._pubs)
        plan.pub = np.frombuffer(b"".join(self._pubs), dtype=np.uint8).reshape(n, 32)
        plan.sig = np.frombuffer(b"".join(self._sigs), dtype=np.uint8).reshape(n, 64)
        return plan

    def execute(self, plan: _VerifyPlan) -> tuple[bool, list[bool]]:
        """Run the planned route; ``verify()`` is ``execute(plan())``."""
        self.last_tier = None
        if plan.route == "empty":
            return False, []
        if plan.route == "keyed":
            out = verify_arrays_keyed(
                plan.entry, plan.key_ids, plan.pub, plan.sig, plan.msgs
            )
            results = [bool(v) for v in out]
        else:
            results = [
                _ref.verify_zip215(p, m, s)
                for p, m, s in zip(plan.pubs, plan.msgs, plan.sigs)
            ]
        self.last_tier = plan.route
        return all(results), results

    def verify(self) -> tuple[bool, list[bool]]:
        return self.execute(self.plan())

