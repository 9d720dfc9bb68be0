"""Ed25519 batch verification on the device (the port of the keyed and
generic tiers of cometbft_tpu/ops/ed25519_verify.py) and
``TorchBatchVerifier``.

For every lane the device checks the cofactored ZIP-215 equation

    [8]([S]B + [k](-A) - R) == identity,   k = SHA-512(R || A || M) mod L,

plus the decompressions, S < L and the key's validity.  Results come
back as one bool per signature.  Two tiers:

- **keyed**: [S]B from the shared 8-bit comb of B and [k](-A) from the
  validator set's per-key comb tables (ops/precompute.py).  On the card
  a slice is the sha512_keyed kernel (csrc/sha512.cu), which hashes
  R || A || M straight from the packed rows, and the verify_keyed kernel
  (csrc/verify_keyed.cu).  Plain versions: ``keyed_digest_plain`` and
  ``verify_keyed_plain``.
- **generic**: no tables.  A is decompressed on the device, [S]B comes
  from the 4-bit comb of B (``curve.B_COMB``) and [k](-A) from a
  per-lane window table.  A slice is sha512_keyed and the verify_generic
  kernel (csrc/verify_generic.cu); plain version
  ``verify_generic_plain``.  It takes sets with no table entry: more
  than TABLE_MAX_KEYS unique keys.

Layouts are the reference's: the packed buffer is feature-first
(100 + bucket, B) uint8 -- pub[32] | sig[64] | msg[bucket] |
msglen_le[4] -- plus key_id_le[4] on the keyed tier (104 + bucket),
padded to a power-of-two batch and a message-length bucket.  Batches
wider than MAX_LAUNCH run as a loop of MAX_LAUNCH-lane slices.

**The async path.**  ``verify_arrays_keyed_async`` and
``verify_arrays_async`` pack a batch into pinned host memory (PyTorch's
caching host allocator, which reuses a block only once its copy has
run), copy it to the card without waiting and enqueue the slices'
launches, returning ``[(verdicts on the device, n)]``.  ``_finish``
concatenates parts on the device and fetches them with one copy into
pinned memory, waiting on a CUDA event (timed as the fetch wait, which
the overlap ratio reads); the copy runs on a fetch stream after the
parts' own ready events, so it does not wait for work enqueued after
them.  ``verify_stream`` keeps up to
``max_in_flight`` jobs enqueued and fetches the oldest half at once, so
the host packs job N+1 while the card runs job N.  The synchronous
entries are ``_finish`` of the async ones with ``pipelined=False``:
nothing runs behind them, so they pack into pageable memory, copy while
the host waits and fetch on the compute stream; the pinned block and
the events cost them about 0.2 ms of commit150's 1 ms on the H100.
The copy in and every launch run on the device's current stream:
enqueue order keeps the key-table pool's writes (on the thread that
plans) ahead of the launches that read them; only the pipelined fetch
has a stream of its own.

``TorchBatchVerifier`` routes each batch down the dispatch ladder
(crypto/dispatch.py): keyed, generic, then the host tier (one native
RLC check, crypto/ed25519.py ``CpuBatchVerifier``) and the
per-signature oracle as the floor.  Below the calibrated device
threshold (``runtime_device_min_batch``), or with a message over 4096
bytes, a batch takes the host tier.  Only a typed tier fault (a chaos
fault, a launch the watchdog declared hung) moves a batch down the
walk; a kernel that fails to build or to launch raises to the caller.

On a card the cost model's sample for a device tier's batch is the
device time of its kernels, not the batch's wall as in the reference:
inside ``execute`` each launcher records a CUDA event just before and
just after its kernel in the same call (``device_timing``), and the
sample is the sum of those intervals.  A wall follows the host's load: a
blocksync node's verify queue shares the interpreter with the sync, and
there a batch's wall is mostly the wait for the interpreter lock; it
also holds the packing, whose cost follows the messages' lengths, so an
estimate learned on one workload would misrank the tiers on another.
The host tier's sample, and a device tier's on the CPU, stay the wall.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from collections import deque

import numpy as np
import torch

from cometbft_tpu_torch.crypto import BatchVerifier, PubKey
from cometbft_tpu_torch.crypto import dispatch as _dispatch
from cometbft_tpu_torch.crypto import ed25519 as _ed
from cometbft_tpu_torch.crypto import health as _health
from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import jitguard as _jitguard
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.ops import scalar as SC
from cometbft_tpu_torch.ops import sha512 as SH
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.trace import TRACER as _tracer

# Message-length buckets (bytes). Vote sign-bytes are ~120 bytes; the
# largest bucket covers arbitrary app-level uses.
_BUCKETS = (128, 256, 512, 1024, 4096)
_MIN_BATCH = 8

#: Largest single device launch (lanes); wider batches run in slices.
MAX_LAUNCH = 8192

#: Smallest batch that takes the device when its tables are already
#: warm, and the least calibrated threshold; below it the host tier runs.
DEVICE_MIN_BATCH = 64

#: Threads per lane that the verify_keyed kernel is compiled for
#: (csrc/point.cuh's launcher; pick_group chooses among them).
GROUPS = (1, 8, 32)

#: Launch shapes (quarters, threads per quarter) that the verify_generic
#: kernel is compiled for: a lane on Q groups of G threads, a point
#: formula's independent products side by side when Q = 4
#: (csrc/verify_generic.cu; pick_shape chooses among them).
VG_SHAPES = ((1, 1), (1, 8), (1, 32), (4, 1), (4, 8), (4, 32))


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


#: this thread's device timing: ``.pairs``, a list of (start, end)
#: CUDA events while a device_timing block runs (else absent), and
#: ``.pool``, device index -> events to reuse
_TIMING = threading.local()


class device_timing:
    """``with device_timing() as t``: every sha512_keyed, verify_keyed
    and verify_generic launch this thread makes inside the block records
    a CUDA event just before and just after its kernel, in the launcher's
    own call; after the kernels have run, ``t.seconds()`` is the sum of
    those intervals, or None when nothing launched on a card.  Blocks do
    not nest."""

    def __init__(self) -> None:
        self.pairs: list = []

    def __enter__(self):
        self.pairs = _TIMING.pairs = []
        return self

    def __exit__(self, *exc):
        del _TIMING.pairs
        pool = _TIMING.__dict__.setdefault("pool", {})
        for dev, ev0, ev1 in self.pairs:
            pool.setdefault(dev, []).extend((ev0, ev1))
        return False

    def seconds(self) -> float | None:
        if not self.pairs:
            return None
        self.pairs[-1][2].synchronize()
        return sum(ev0.elapsed_time(ev1) for _, ev0, ev1 in self.pairs) / 1e3


def _launch_events(device) -> tuple:
    """(start, end) event handles for a launcher to record around its
    kernel on ``device`` inside a :class:`device_timing` block, else
    (None, None).  An event is created by recording it once on the
    device's stream (PyTorch creates a CUDA event at its first record)."""
    pairs = getattr(_TIMING, "pairs", None)
    if pairs is None:
        return None, None
    pool = _TIMING.__dict__.setdefault("pool", {}).setdefault(device.index, [])
    evs = []
    for _ in range(2):
        if pool:
            evs.append(pool.pop())
        else:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            evs.append(ev)
    pairs.append((device.index, evs[0], evs[1]))
    return evs[0].cuda_event, evs[1].cuda_event


def _le32(rows: torch.Tensor) -> torch.Tensor:
    b = rows.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def keyed_digest_plain(buf: torch.Tensor, bucket: int, nblocks: int) -> torch.Tensor:
    """The plain PyTorch version of the sha512_keyed kernel: the padded
    input (:func:`build_padded_input`), then SHA-512 of each lane's own
    blocks."""
    msglen = _le32(buf[96 + bucket : 100 + bucket])
    padded, nblocks_lane = build_padded_input(
        buf[32:64], buf[:32], buf[96 : 96 + bucket], msglen, nblocks
    )
    return SH.sha512_padded_plain(padded, nblocks, nblocks_lane)


def keyed_digest(buf: torch.Tensor, bucket: int, nblocks: int) -> torch.Tensor:
    """SHA-512(R || A || M) per lane of the packed rows: (104+bucket, B)
    or (100+bucket, B) uint8 -> (64, B) uint8.  Both tiers' layouts hold
    R, A, the message and its length at the same rows, and the key-id
    rows are never read.

    A CUDA tensor goes through the sha512_keyed kernel, which reads the
    rows in place (lanes contiguous, any row stride) and pads each lane
    in registers; a CPU tensor through :func:`keyed_digest_plain`."""
    if (buf.dim() != 2 or buf.shape[0] not in (100 + bucket, 104 + bucket)
            or buf.dtype != torch.uint8):
        raise ValueError(f"sha512_keyed: expected ({104 + bucket}, B) or "
                         f"({100 + bucket}, B) uint8 rows, got {tuple(buf.shape)} {buf.dtype}")
    if nblocks != nblocks_for_bucket(bucket):
        raise ValueError(f"sha512_keyed: bucket {bucket} takes "
                         f"{nblocks_for_bucket(bucket)} blocks, not {nblocks}")
    if buf.device.type == "cpu":
        return keyed_digest_plain(buf, bucket, nblocks)
    if buf.device.type != "cuda":
        raise ValueError(f"sha512_keyed: unsupported device {buf.device}")
    if buf.stride(1) != 1:
        raise ValueError("sha512_keyed: the rows' lanes must be contiguous")
    n = buf.shape[1]
    out = torch.empty((64, n), dtype=torch.uint8, device=buf.device)
    rc = _build.library("sha512").sha512_keyed_launch(
        buf.data_ptr(), buf.stride(0), bucket, nblocks, out.data_ptr(), n,
        torch.cuda.current_stream(buf.device).cuda_stream, *_launch_events(buf.device),
    )
    _build.check(rc, "sha512_keyed")
    _build.LAUNCHES["sha512_keyed"] += 1
    return out


def verify_keyed_plain(buf, digest, table, key_valid, b_table, bucket: int,
                       window_bits: int):
    """The plain PyTorch version of the verify_keyed kernel: -> ((B,)
    bool verdicts, (4, 26, B) int32 limbs of [8]q).

    buf (104+bucket, B) uint8 packed rows pub[32] | sig[64] | msg[bucket]
    | msglen_le[4] | key_id_le[4]; digest (64, B) uint8 from
    :func:`keyed_digest`; table (nwin, 4, 26, cap*nent) int32 (its limb
    rows may be strided wider, as a mesh shard's are); key_valid
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
                       window_bits: int, out_point=None, group: int = 0) -> torch.Tensor:
    """Keyed verify of the packed rows after SHA-512: (B,) bool verdicts
    (arguments as :func:`verify_keyed_plain`).  ``out_point``, a (4, 26,
    B) int32 tensor, receives the limbs of [8]q when given.

    A CUDA tensor goes through the verify_keyed kernel (one launch, a
    group of ``group`` threads per lane, one of GROUPS, or 0 for the
    launcher's choice by lane count; csrc/verify_keyed.cu), a CPU tensor
    through verify_keyed_plain."""
    if buf.dim() != 2 or buf.shape[0] != 104 + bucket or buf.dtype != torch.uint8:
        raise ValueError(f"verify_keyed: expected ({104 + bucket}, B) uint8 rows, "
                         f"got {tuple(buf.shape)} {buf.dtype}")
    if window_bits not in (8, 4):
        raise ValueError(f"verify_keyed: window_bits must be 8 or 4, got {window_bits}")
    if group != 0 and group not in GROUPS:
        raise ValueError(f"verify_keyed: group must be 0 or one of {GROUPS}, got {group}")
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
    if table.device != buf.device or table.dtype != F.DTYPE:
        raise ValueError(f"verify_keyed: table must be an int32 tensor on {buf.device}")
    # the limb rows may be wider than the table (a shard of a mesh
    # placement is a view of a wider tensor): m is the row stride
    m = table.stride(2)
    if (table.stride(3) != 1 or m < table.shape[3] or table.stride(1) != F.NLIMBS * m
            or table.stride(0) != 4 * F.NLIMBS * m):
        raise ValueError("verify_keyed: the table must be row-major with unit entry stride")
    for name, t, dtype in (("digest", digest, torch.uint8),
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
    if F.NLIMBS * m >= 1 << 31:
        raise ValueError("verify_keyed: pool too wide for 32-bit limb strides")
    ok = torch.empty(n, dtype=torch.bool, device=buf.device)
    rc = _build.library("verify_keyed").verify_keyed_launch(
        buf.data_ptr(), buf.stride(0), bucket, digest.data_ptr(), table.data_ptr(),
        m, key_valid.data_ptr(), key_valid.shape[0], b_table.data_ptr(),
        ok.data_ptr(), None if out_point is None else out_point.data_ptr(), n,
        window_bits, group, torch.cuda.current_stream(buf.device).cuda_stream,
        *_launch_events(buf.device),
    )
    _build.check(rc, "verify_keyed")
    _build.LAUNCHES["verify_keyed"] += 1
    return ok


def verify_generic_plain(buf, digest, b_comb=None):
    """The plain PyTorch version of the verify_generic kernel: -> ((B,)
    bool verdicts, (4, 26, B) int32 limbs of [8]q).

    buf (100+bucket, B) uint8 packed rows pub[32] | sig[64] | msg[bucket]
    | msglen_le[4] (only pub and sig are read); digest (64, B) uint8 from
    :func:`keyed_digest`; b_comb ``curve.B_COMB`` on buf's device
    (uploaded once if None).  The reference's ``verify_kernel`` after the
    digest; its field products go through fe_mul / fe_sq, so on a CUDA
    tensor it is a composition of field-kernel launches and torch ops."""
    pub, r_enc, s_bytes = buf[:32], buf[32:64], buf[64:96]
    a_pt, a_ok = C.decompress(pub)
    r_pt, r_ok = C.decompress(r_enc)
    s_ok = SC.bytes_lt_l(s_bytes)
    k_nib = SC.limbs_to_nibbles(SC.reduce_digest(digest))
    s_nib = C.nibbles_from_bytes_le(s_bytes)
    p1 = C.comb_mul_base(s_nib, b_comb)                    # [S]B
    p2 = C.window_mul(k_nib, C.pt_neg(a_pt))               # [k](-A)
    q8 = C.mul8(C.pt_add(C.pt_add(p1, p2), C.pt_neg(r_pt)))
    ok = C.pt_is_identity(q8) & a_ok & r_ok & s_ok
    return ok, torch.stack(q8)


def verify_generic_fused(buf, digest, bucket: int, shape=None, want_q: bool = False):
    """Generic verify of the packed rows after SHA-512: (B,) bool
    verdicts, or (verdicts, (4, 26, B) int32 limbs of [8]q) when
    ``want_q`` (arguments as :func:`verify_generic_plain`).

    A CUDA tensor goes through the verify_generic kernel (one launch, a
    lane on ``shape`` = (quarters, threads per quarter), one of
    VG_SHAPES, or None for the launcher's choice by lane count;
    csrc/verify_generic.cu), a CPU tensor through verify_generic_plain."""
    if buf.dim() != 2 or buf.shape[0] != 100 + bucket or buf.dtype != torch.uint8:
        raise ValueError(f"verify_generic: expected ({100 + bucket}, B) uint8 rows, "
                         f"got {tuple(buf.shape)} {buf.dtype}")
    if shape is not None and tuple(shape) not in VG_SHAPES:
        raise ValueError(f"verify_generic: shape must be None or one of {VG_SHAPES}, "
                         f"got {shape}")
    n = buf.shape[1]
    if digest.shape != (64, n) or digest.dtype != torch.uint8:
        raise ValueError(f"verify_generic: digest must be (64, {n}) uint8")
    if buf.device.type == "cpu":
        ok, q8 = verify_generic_plain(buf, digest)
        return (ok, q8) if want_q else ok
    if buf.device.type != "cuda":
        raise ValueError(f"verify_generic: unsupported device {buf.device}")
    if buf.stride(1) != 1:
        raise ValueError("verify_generic: the rows' lanes must be contiguous")
    if digest.device != buf.device or not digest.is_contiguous():
        raise ValueError(f"verify_generic: digest must be contiguous on {buf.device}")
    b_comb = F.const(C.B_COMB, buf.device)
    # each lane's multiples 0..15 of -A, lanes on the minor axis
    mult = torch.empty((16, 4, F.NLIMBS, n), dtype=F.DTYPE, device=buf.device)
    ok = torch.empty(n, dtype=torch.bool, device=buf.device)
    q8 = (torch.empty((4, F.NLIMBS, n), dtype=F.DTYPE, device=buf.device)
          if want_q else None)
    rc = _build.library("verify_generic").verify_generic_launch(
        buf.data_ptr(), buf.stride(0), digest.data_ptr(), b_comb.data_ptr(),
        mult.data_ptr(), ok.data_ptr(), None if q8 is None else q8.data_ptr(), n,
        *(shape or (0, 0)), torch.cuda.current_stream(buf.device).cuda_stream,
        *_launch_events(buf.device),
    )
    _build.check(rc, "verify_generic")
    _build.LAUNCHES["verify_generic"] += 1
    return (ok, q8) if want_q else ok


def bucket_for(maxlen: int) -> int:
    """The smallest message bucket that holds ``maxlen`` bytes."""
    bucket = next((b for b in _BUCKETS if b >= maxlen), None)
    if bucket is None:
        raise ValueError(f"message too large for device path: {maxlen}")
    return bucket


def pack_inputs(pub: np.ndarray, sig: np.ndarray, msgs: list[bytes],
                start: int = 0, end: int | None = None,
                key_ids: np.ndarray | None = None, zeros=np.zeros,
                bucket: int | None = None) -> tuple[np.ndarray, int]:
    """Pad + pack (pub, sig, msgs[start:end]) into the feature-first
    (100+bucket, batch) uint8 layout -- (104+bucket, batch) with 4 LE
    key-id bytes per lane when ``key_ids`` is given.  Returns (packed,
    bucket).  Padded lanes are all zero: key id 0, zero windows.
    ``zeros(shape, dtype)`` makes the zeroed buffer (a pinned tensor's
    numpy view for the async path).  ``bucket`` (a whole batch's, when
    its lanes are packed in parts) must hold every message; by default
    the smallest that does."""
    if end is None:
        end = len(msgs)
    n = end - start
    lens = np.fromiter((len(msgs[i]) for i in range(start, end)),
                       dtype=np.int64, count=n)
    maxlen = int(lens.max()) if n else 0
    if bucket is None:
        bucket = bucket_for(maxlen)
    elif maxlen > bucket:
        raise ValueError(f"a message of {maxlen} bytes does not fit bucket {bucket}")
    batch = max(PR.next_pow2(n), _MIN_BATCH)
    tail = 100 if key_ids is None else 104
    packed = zeros((tail + bucket, batch), dtype=np.uint8)
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


def _stage(pub: np.ndarray, sig: np.ndarray, msgs: list[bytes], device,
           key_ids: np.ndarray | None = None,
           pipelined: bool = True) -> tuple[torch.Tensor, int]:
    """Pack a batch (:func:`pack_inputs`) and start its copy to
    ``device`` -> (packed rows on the device, bucket).  For a CUDA device
    the rows are packed into a pinned tensor and copied without waiting
    (the caching host allocator keeps the block until the copy has run),
    or, not ``pipelined``, packed into pageable memory and copied while
    the host waits.  For the CPU the packed array is the device tensor."""
    if device.type != "cuda" or not pipelined:
        packed, bucket = pack_inputs(pub, sig, msgs, key_ids=key_ids)
        buf = torch.from_numpy(packed)
        if device.type == "cuda":
            _crypto_metrics().bytes_transferred.child("h2d").inc(packed.size)
            with _jitguard.audited():
                buf = buf.to(device)
        return buf, bucket
    held = []

    def pinned_zeros(shape, dtype):
        t = torch.zeros(shape, dtype=torch.uint8, pin_memory=True)
        held.append(t)
        return t.numpy()

    _, bucket = pack_inputs(pub, sig, msgs, key_ids=key_ids, zeros=pinned_zeros)
    _crypto_metrics().bytes_transferred.child("h2d").inc(held[0].numel())
    with _jitguard.audited():
        return held[0].to(device, non_blocking=True), bucket


def verify_arrays_keyed_async(entry: PR.KeySetTables, key_ids: np.ndarray,
                              pub: np.ndarray, sig: np.ndarray, msgs: list[bytes],
                              pipelined: bool = True):
    """Enqueue the keyed path without waiting: numpy (n, 32), (n, 64), n
    messages and their key ids in ``entry`` -> ``[(bool verdicts on the
    device, n)]``, the verdicts padded to the packed batch.  Runs on the
    device that holds ``entry.table``: the packed batch's copy, then per
    MAX_LAUNCH-lane slice sha512_keyed and verify_keyed, the slices'
    verdicts concatenated on the device.  Fetch with :func:`_finish`
    (``pipelined`` as given here: :func:`_stage`)."""
    dev = entry.table.device
    buf, bucket = _stage(pub, sig, msgs, dev, key_ids=key_ids, pipelined=pipelined)
    batch = buf.shape[1]
    _jitguard.note_key("keyed", (batch, bucket, entry.window_bits, MAX_LAUNCH,
                                 slice_picks(dev, batch, keyed_group)))
    _crypto_metrics().batch_verify_launches.child("keyed").inc()
    with _tracer.span("device_launch", cat="device", kernel="keyed", batch=batch,
                      bucket=bucket, window_bits=entry.window_bits):
        out = keyed_rows(buf, bucket, entry.table, entry.valid_device(),
                         F.const(PR.b_comb8(), dev), entry.window_bits)
    return [(_mark_ready(out) if pipelined else out, len(msgs))]


def keyed_rows(buf: torch.Tensor, bucket: int, table: torch.Tensor, key_valid: torch.Tensor,
               b_table: torch.Tensor, window_bits: int) -> torch.Tensor:
    """Verdicts of packed keyed rows (104+bucket, B) uint8 against
    ``table``/``key_valid`` on their device: per MAX_LAUNCH-lane slice
    sha512_keyed then verify_keyed, the slices' verdicts concatenated
    on the device."""
    nblocks = nblocks_for_bucket(bucket)
    outs = []
    for s in range(0, buf.shape[1], MAX_LAUNCH):
        rows = buf[:, s : s + MAX_LAUNCH]
        outs.append(verify_keyed_fused(rows, keyed_digest(rows, bucket, nblocks), table,
                                       key_valid, b_table, bucket, window_bits))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def verify_generic_rows(buf: torch.Tensor, bucket: int) -> torch.Tensor:
    """Verdicts of packed generic rows (100+bucket, B) uint8 on their
    device: per MAX_LAUNCH-lane slice sha512_keyed then verify_generic,
    the slices' verdicts concatenated on the device.  Notes the
    ``generic`` seam (ops/jitguard.py), or ``chunked`` over MAX_LAUNCH
    lanes, with the slices' launch shapes."""
    batch = buf.shape[1]
    picks = slice_picks(buf.device, batch, generic_shape)
    if batch > MAX_LAUNCH:
        _jitguard.note_key("chunked", (batch, bucket, MAX_LAUNCH, picks))
    else:
        _jitguard.note_key("generic", (batch, bucket, picks))
    nblocks = nblocks_for_bucket(bucket)
    outs = []
    for s in range(0, batch, MAX_LAUNCH):
        rows = buf[:, s : s + MAX_LAUNCH]
        outs.append(verify_generic_fused(rows, keyed_digest(rows, bucket, nblocks), bucket))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


@functools.lru_cache(maxsize=None)
def keyed_group(n: int) -> int:
    """The group size G verify_keyed's launcher picks for n lanes."""
    return _build.library("verify_keyed").verify_keyed_group(n)


@functools.lru_cache(maxsize=None)
def generic_shape(n: int) -> tuple[int, int]:
    """The shape (Q, G) verify_generic's launcher picks for n lanes."""
    q, g = ctypes.c_int(), ctypes.c_int()
    _build.library("verify_generic").verify_generic_shape(n, ctypes.byref(q), ctypes.byref(g))
    return q.value, g.value


def slice_picks(device, batch: int, pick) -> tuple:
    """``pick`` of each MAX_LAUNCH-lane slice's width on a card (the
    launch shape a seam's key carries); () where the plain versions
    run."""
    if torch.device(device).type != "cuda":
        return ()
    return tuple(pick(min(MAX_LAUNCH, batch - s)) for s in range(0, batch, MAX_LAUNCH))


def verify_arrays_async(pub: np.ndarray, sig: np.ndarray, msgs: list[bytes], device,
                        pipelined: bool = True):
    """Enqueue the generic path on ``device`` without waiting: numpy (n,
    32), (n, 64) and n messages -> ``[(bool verdicts on the device,
    n)]`` (:func:`verify_generic_rows` of the packed batch's copy;
    ``pipelined`` as in :func:`verify_arrays_keyed_async`)."""
    buf, bucket = _stage(pub, sig, msgs, torch.device(device), pipelined=pipelined)
    _crypto_metrics().batch_verify_launches.child("generic").inc()
    with _tracer.span("device_launch", cat="device", kernel="generic", batch=buf.shape[1],
                      bucket=bucket):
        out = verify_generic_rows(buf, bucket)
    return [(_mark_ready(out) if pipelined else out, len(msgs))]


#: device -> the stream the verdicts are fetched on (one per device)
_FETCH_STREAMS: dict = {}


def _mark_ready(out: torch.Tensor) -> torch.Tensor:
    """Record, on a CUDA tensor of verdicts, an event on the current
    stream right after the launches that produce it (``_finish`` waits
    for that event, not for everything enqueued later)."""
    if out.device.type == "cuda":
        out._ready = torch.cuda.Event()
        out._ready.record(torch.cuda.current_stream(out.device))
    return out


def _finish(parts, pipelined: bool = True) -> np.ndarray:
    """Wait for a list of (device verdicts, n) parts and fetch them with
    one copy, into a pinned host tensor, then wait on a CUDA event after
    the copy (timed as this thread's fetch wait).  On a card the
    concatenation and the copy run on the device's fetch stream, after
    each part's ready event (``_mark_ready``): launches enqueued on the
    compute stream after the parts -- later jobs of a stream, the next
    batch's table build -- are not waited for.  Not ``pipelined``, the
    copy runs on the compute stream into pageable memory (the
    synchronous entries: nothing is enqueued behind them).  Each part is
    padded; its first n verdicts are kept -> bool[sum n]."""
    with _jitguard.audited():
        combined = _fetch(parts, pipelined)
    if len(parts) == 1:
        return combined[: parts[0][1]]
    pieces, off = [], 0
    for p, k in parts:
        pieces.append(combined[off : off + k])
        off += p.shape[0]
    return np.concatenate(pieces)


def _fetch(parts, pipelined: bool) -> np.ndarray:
    """:func:`_finish`'s copy: the parts' verdicts, concatenated, on the
    host."""
    first = parts[0][0]
    if first.device.type == "cuda" and not pipelined:
        out = first if len(parts) == 1 else torch.cat([p for p, _ in parts])
        with _health.USAGE.timed_fetch():
            host = out.cpu()
        _crypto_metrics().bytes_transferred.child("d2h").inc(host.numel())
        combined = host.numpy()
    elif first.device.type == "cuda":
        dev = first.device
        side = _FETCH_STREAMS.get(dev)
        if side is None:
            side = _FETCH_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
        for p, _ in parts:
            ready = getattr(p, "_ready", None)
            if ready is None:
                side.wait_stream(torch.cuda.current_stream(dev))
            else:
                side.wait_event(ready)
        # the parts stay referenced until the wait below: the compute
        # stream cannot reuse their memory while the fetch stream reads it
        with torch.cuda.stream(side):
            out = first if len(parts) == 1 else torch.cat([p for p, _ in parts])
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        with _health.USAGE.timed_fetch():
            done.synchronize()
        _crypto_metrics().bytes_transferred.child("d2h").inc(host.numel())
        combined = host.numpy()
    else:
        combined = (first if len(parts) == 1 else torch.cat([p for p, _ in parts])).numpy()
    return combined


def verify_arrays_keyed(entry: PR.KeySetTables, key_ids: np.ndarray,
                        pub: np.ndarray, sig: np.ndarray,
                        msgs: list[bytes]) -> np.ndarray:
    """Host entry of the keyed path -> bool[n]:
    ``_finish(verify_arrays_keyed_async(...))``, not pipelined."""
    return _finish(verify_arrays_keyed_async(entry, key_ids, pub, sig, msgs, pipelined=False),
                   pipelined=False)


def verify_arrays(pub: np.ndarray, sig: np.ndarray, msgs: list[bytes],
                  device) -> np.ndarray:
    """Host entry of the generic path on ``device`` -> bool[n]:
    ``_finish(verify_arrays_async(...))``, not pipelined."""
    return _finish(verify_arrays_async(pub, sig, msgs, device, pipelined=False),
                   pipelined=False)


def verify_stream(jobs, max_in_flight: int = 8, dispatch=None, device=None):
    """Pipelined verification: ``jobs`` yields (pub, sig, msgs) tuples;
    yields bool[n] per job, in order, with up to ``max_in_flight`` jobs
    enqueued so the card runs one job while the host packs the next.
    When the window is full the oldest half is fetched with one copy
    (:func:`_finish`); the rest at the end.

    ``dispatch(pub, sig, msgs)`` is the async launcher: by default
    :func:`verify_arrays_async` on ``device`` (``cuda`` unless given);
    a closure over :func:`verify_arrays_keyed_async` with a warm table
    entry streams the keyed path."""
    if dispatch is None:
        dev = resolve_device(device)

        def dispatch(pub, sig, msgs):
            return verify_arrays_async(pub, sig, msgs, dev)
    pending: deque = deque()

    def flush(count: int):
        # the oldest jobs are the likeliest to be done; newer ones stay
        # enqueued so the card does not drain
        batch = [pending.popleft() for _ in range(count)]
        combined = _finish([pt for job_parts in batch for pt in job_parts])
        off = 0
        for job_parts in batch:
            n = sum(k for _, k in job_parts)
            yield combined[off : off + n]
            off += n

    for job in jobs:
        pending.append(dispatch(*job))
        if len(pending) >= max_in_flight:
            yield from flush(max(1, len(pending) // 2))
    if pending:
        yield from flush(len(pending))


#: the threshold's per-signature costs: the host tier's (t_cpu), 48.4 us
#: on commit150's 150 valid lanes on the host CPU of an H100 80GB HBM3
#: machine, and the warm keyed tier's (t_dev), 7.4 us on the card at the
#: same batch (chip_smoke.py's host-tier phase).  With them n* stays
#: under DEVICE_MIN_BATCH until the link's round trip passes 2.6 ms.
_DEFAULT_T_CPU_SIG = 48.4e-6
_DEFAULT_T_DEV_SIG = 7.4e-6

#: the CPU "device": the device tiers' plain versions are slower than
#: the host tier at every size, so nothing is routed to them
CPU_SENTINEL = 1 << 30

def _measure_link_rtt(device) -> float:
    """The least of 3 round trips of an 8-byte tensor, host -> ``device``
    -> host, each ending in the copy back: the fixed cost every
    synchronous launch pays."""
    probe = torch.zeros(8, dtype=torch.uint8)
    best = float("inf")
    with _jitguard.audited():
        for _ in range(3):
            t0 = time.perf_counter()
            probe.to(device).cpu()
            best = min(best, time.perf_counter() - t0)
    return best


def crossover_batch(rtt: float, t_cpu: float = _DEFAULT_T_CPU_SIG,
                    t_dev: float = _DEFAULT_T_DEV_SIG) -> int:
    """The batch from which the device beats the host, n* = rtt /
    (t_cpu - t_dev), rounded up to a power of two from DEVICE_MIN_BATCH
    and capped at 16384."""
    n_star = rtt / max(t_cpu - t_dev, 1e-9)
    threshold = DEVICE_MIN_BATCH
    while threshold < n_star and threshold < 16384:
        threshold <<= 1
    return threshold


def runtime_device_min_batch(device=None) -> int:
    """The dispatch threshold for ``device``: :func:`crossover_batch` of
    the link's measured round trip, measured once per device (CPU_SENTINEL
    on the CPU).  A failed probe raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CPU_SENTINEL
    return _calibrated(str(dev))


@functools.lru_cache(maxsize=None)
def _calibrated(device: str) -> int:
    return crossover_batch(_measure_link_rtt(torch.device(device)))


#: device tiers that have run in this process: a tier's first run pays
#: its kernels' module loads and is kept out of the cost model
_RAN_TIERS: set[str] = set()


class _VerifyPlan:
    """Output of :meth:`TorchBatchVerifier.plan`: the route and what
    :meth:`TorchBatchVerifier.execute` needs to run it."""

    __slots__ = ("n", "route", "reason", "entry", "key_ids", "pub", "sig",
                 "msgs", "pubs", "sigs", "t_plan", "tiers")

    def __init__(self) -> None:
        self.n = 0
        self.route = "empty"      # "empty" | "device" | "host"
        self.reason = "batch_size"
        self.entry = None
        self.key_ids = None
        self.pub = None
        self.sig = None
        self.msgs: list[bytes] = []
        self.pubs: list[bytes] = []
        self.sigs: list[bytes] = []
        self.t_plan = 0.0
        #: the admissible tiers, best first, ending in the host/python
        #: floor; execute() walks them top-down
        self.tiers: list[str] = []


class TorchBatchVerifier(BatchVerifier):
    """BatchVerifier on the device (the counterpart of cometbft_tpu's
    TpuBatchVerifier, reference slot crypto/ed25519/ed25519.go:190).

    ``plan`` routes as the reference does.  While the ladder admits the
    keyed tier, a batch of at least ``device_min_batch`` signatures
    looks up -- building if needed -- its key set's tables; a batch of
    DEVICE_MIN_BATCH or more but below the threshold takes the keyed
    tier only when its tables are already warm (``peek``).  A set with
    no table entry (more than TABLE_MAX_KEYS unique keys) is eligible
    for the generic tier only.  The eligible tiers that the ladder
    admits, plus the host rung, are ordered by the cost model; with
    none, the batch takes the host tier, with its reason: batch_size,
    msg_too_large (over 4096 bytes), calibration (the CPU sentinel) or
    ladder_demoted.

    ``execute`` walks the plan's tiers.  A tier that raises a typed
    fault (``TierFault``, ``TierUnavailable``) is demoted on the ladder
    with its reason and the batch goes one rung down; any other
    exception reaches the caller, as does any exception of the python
    floor.  ``last_tier`` is the tier that answered.  A device tier's
    first run in the process, and the keyed tier's first run on a new
    table entry (its pool copies still in flight), are not given to the
    cost model: they time one-off work, not the tier.

    ``device_min_batch=None`` takes the calibrated threshold
    (:func:`runtime_device_min_batch`)."""

    def __init__(self, device=None, device_min_batch: int | None = None,
                 cache: PR.KeyTableCache | None = None) -> None:
        self.device = resolve_device(device)
        if device_min_batch is None:
            device_min_batch = runtime_device_min_batch(self.device)
        self._device_min_batch = device_min_batch
        self._cache = cache if cache is not None else PR.table_cache(self.device)
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []
        self._max_msg = 0
        self.last_tier: str | None = None
        # devices a launch occupies, for the per-device busy/idle
        # accounting (crypto/health.py DeviceUsage); the mesh verifier
        # sets its shard count
        self._usage_ndev = 1

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type() != _ed.KEY_TYPE:
            raise TypeError("TorchBatchVerifier requires ed25519 keys")
        if len(sig) != _ed.SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._pubs.append(pub_key.bytes())
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))
        self._max_msg = max(self._max_msg, len(msg))

    def __len__(self) -> int:
        return len(self._pubs)

    # -- ladder eligibility (crypto/dispatch.py owns admissibility) ------

    def _keyed_tiers(self) -> list[str]:
        """The keyed tiers this verifier can run, best first (the mesh
        verifier puts keyed_mesh first)."""
        return ["keyed"]

    def _generic_tiers(self) -> list[str]:
        return ["generic"]

    def plan(self) -> _VerifyPlan:
        """Host phase: the ladder's route (table lookup or warm peek for
        the keyed tiers) and the packed pub/sig arrays."""
        plan = _VerifyPlan()
        plan.t_plan = time.perf_counter()
        n = plan.n = len(self._pubs)
        if n == 0:
            return plan
        plan.pubs, plan.msgs, plan.sigs = self._pubs, self._msgs, self._sigs
        cm = _crypto_metrics()
        ladder = _dispatch.LADDER
        device_usable = self._device_min_batch < CPU_SENTINEL
        msg_fits = self._max_msg <= _BUCKETS[-1]
        entry = None
        reason = "batch_size"
        # with every keyed tier demoted the lookup is skipped: a dead
        # device must not stall the plan behind a build no admissible
        # tier uses
        if device_usable and msg_fits and any(ladder.active(t) for t in self._keyed_tiers()):
            try:
                if n >= self._device_min_batch:
                    entry = self._cache.lookup_or_build(self._pubs)
                elif n >= DEVICE_MIN_BATCH:
                    # warm tables take the keyed tier below the threshold
                    # (the threshold models a cold launch); peek never
                    # builds
                    entry = self._cache.peek(self._pubs)
                    if entry is not None:
                        reason = "keyed_warm"
            except (_dispatch.TierFault, _dispatch.TierUnavailable) as exc:
                # the recorded escalation: a typed fault of the lookup is
                # a keyed-tier fault; the batch walks on from the generic
                # tier (a build that fails otherwise raises to the caller)
                ladder.tier_fault("keyed", reason=f"table_lookup:{type(exc).__name__}",
                                  batch=n)
                entry = None
        eligible: list[str] = []
        if entry is not None:
            eligible += self._keyed_tiers()
        if device_usable and msg_fits and n >= self._device_min_batch:
            eligible += self._generic_tiers()
        admissible = ladder.admissible(eligible)
        if not admissible:
            if eligible:
                reason = "ladder_demoted"
            elif n >= self._device_min_batch:
                reason = "msg_too_large"
            elif not device_usable:
                reason = "calibration"
            elif not msg_fits:
                reason = "msg_too_large"
            else:
                reason = "batch_size"
            cm.dispatch_decisions.labels(route="host", reason=reason).inc()
            plan.route, plan.reason = "host", reason
            plan.tiers = ["host", _dispatch.FLOOR_TIER]
            ladder.note_route("host", n)
            return plan
        cm.dispatch_decisions.child("device", reason).inc()
        cm.batch_verify_batch_size.observe(n)
        plan.route, plan.reason = "device", reason
        plan.entry = entry
        plan.tiers = ladder.route(admissible, n) + [_dispatch.FLOOR_TIER]
        if entry is not None:
            plan.key_ids = entry.key_ids(self._pubs)
        plan.pub = np.frombuffer(b"".join(self._pubs), dtype=np.uint8).reshape(n, 32)
        plan.sig = np.frombuffer(b"".join(self._sigs), dtype=np.uint8).reshape(n, 64)
        return plan

    def execute(self, plan: _VerifyPlan) -> tuple[bool, list[bool]]:
        """Walk the plan's tiers top-down; ``verify()`` is
        ``execute(plan())``."""
        if plan.route == "empty":
            return False, []
        ladder = _dispatch.LADDER
        n = plan.n
        self.last_tier = None
        queue_wait_noted = False
        for tier in plan.tiers:
            if tier not in ("host", _dispatch.FLOOR_TIER) and not ladder.active(tier):
                continue  # demoted since the plan was made
            t_tier = time.perf_counter()
            timing = device_timing()
            try:
                if tier == _dispatch.FLOOR_TIER:
                    ok, results = self._run_python(plan)
                elif tier == "host":
                    ok, results = self._run_host(plan)
                else:
                    # flag before the launch: a faulting tier must not
                    # make the next rung count the queue wait again
                    note_qw = not queue_wait_noted
                    queue_wait_noted = True
                    with timing:
                        results = self._launch_tier(tier, plan, note_queue_wait=note_qw)
                    ok = all(results)
                    _crypto_metrics().kernel_time_seconds.observe(time.perf_counter() - t_tier)
            except (_dispatch.TierFault, _dispatch.TierUnavailable) as exc:
                # the escalation seam: a tier's typed fault is recorded on
                # the ladder and the batch goes one rung down; the floor
                # re-raises (a fault there is a bug)
                if tier == _dispatch.FLOOR_TIER:
                    raise
                ladder.tier_fault(tier, reason=_dispatch.fault_reason(exc), batch=n,
                                  duplicate=getattr(exc, "_ladder_watchdog_fired", False))
                continue
            seconds = time.perf_counter() - t_tier
            if tier in _dispatch.DEVICE_TIERS:
                seconds = timing.seconds() or seconds
                cold = tier not in _RAN_TIERS
                _RAN_TIERS.add(tier)
                if tier in ("keyed", "keyed_mesh"):
                    cold = cold or not plan.entry.launched
                    plan.entry.launched = True
                if cold:
                    seconds = None
            self.last_tier = tier
            ladder.note_batch(tier, batch=n, seconds=seconds)
            return ok, results
        raise RuntimeError("dispatch ladder exhausted without a floor tier")

    def verify(self) -> tuple[bool, list[bool]]:
        return self.execute(self.plan())

    def _launch_tier(self, tier: str, plan: _VerifyPlan,
                     note_queue_wait: bool = True) -> list[bool]:
        """One device-tier attempt under the launch watchdog, with chaos
        injected inside its armed window, the queue wait and busy/idle
        accounting over the launch's wall (to the verdicts' copy, on each
        of the tier's devices), and the overlap ratio from the fetch's
        wait, all inside the guard's sync window (ops/jitguard.py).  A
        launch the watchdog declared hung that then raises is a typed
        fault, marked so the back-off advances once; any other exception
        propagates as it is."""
        usage = _health.USAGE
        with _jitguard.transfer_window():
            t_launch = time.perf_counter()
            if note_queue_wait:
                usage.note_queue_wait(t_launch - plan.t_plan)
            fetch0 = usage.fetch_wait()
            wd = _health.WATCHDOG
            token = wd.arm(tier, batch=plan.n)
            try:
                # a launch_hang fault sleeps past the budget while the
                # watchdog watches, so the overrun fires first
                _dispatch.CHAOS.inject(tier)
                out = self._run_tier(tier, plan)
            except Exception as exc:
                if not wd.disarm(token):
                    raise
                # the watchdog already demoted this launch's tier
                if isinstance(exc, _dispatch.TierFault):
                    exc._ladder_watchdog_fired = True
                    raise
                fault = _dispatch.TierFault(tier, _dispatch.fault_reason(exc))
                fault._ladder_watchdog_fired = True
                raise fault from exc
            wd.disarm(token)
            usage.launch_end(t_launch, ndev=self._tier_ndev(tier),
                             fetch_wait=usage.fetch_wait() - fetch0)
        return out.tolist()

    def _run_tier(self, tier: str, plan: _VerifyPlan) -> np.ndarray:
        """tier -> its runner (the mesh verifier adds the mesh tiers)."""
        if tier == "keyed":
            return verify_arrays_keyed(plan.entry, plan.key_ids, plan.pub, plan.sig, plan.msgs)
        if tier == "generic":
            return verify_arrays(plan.pub, plan.sig, plan.msgs, self.device)
        raise _dispatch.TierUnavailable(tier, "no runner on this seam")

    def _tier_ndev(self, tier: str) -> int:
        """Devices one launch of ``tier`` occupies (busy/idle
        accounting)."""
        return self._usage_ndev if tier in _dispatch.MESH_TIERS else 1

    def _run_host(self, plan: _VerifyPlan) -> tuple[bool, list[bool]]:
        """The host tier: one native RLC check, per-signature on failure."""
        cpu = _ed.CpuBatchVerifier()
        for p, m, s in zip(plan.pubs, plan.msgs, plan.sigs):
            cpu.add(_ed.Ed25519PubKey(p), m, s)
        return cpu.verify()

    def _run_python(self, plan: _VerifyPlan) -> tuple[bool, list[bool]]:
        """The floor: the per-signature oracle."""
        results = [_ed.Ed25519PubKey(p).verify_signature(m, s)
                   for p, m, s in zip(plan.pubs, plan.msgs, plan.sigs)]
        return all(results), results


#: shape/dtype contracts (grammar: ops/contracts.py).  The packed rows
#: are the reference's (pub | sig | msg | msglen_le, + key_id_le on the
#: keyed tier); the verify kernels take the digest and the comb of B as
#: arguments, and the plain versions also return the limbs of [8]q.
_CONTRACTS = {
    "build_padded_input": {
        "args": {
            "r_enc": ("u8", (32, "B")),
            "a_enc": ("u8", (32, "B")),
            "msg": ("u8", ("M", "B")),
            "msglen": ("i32", ("B",)),
        },
        "static": ("nblocks",),
        "out": [("u8", ("nblocks*128", "B")), ("i64", ("B",))],
    },
    "keyed_digest": {
        "on": "cpu",
        "args": {"buf": ("u8", ("104+bucket", "B"))},
        "static": ("bucket", "nblocks"),
        "out": ("u8", (64, "B")),
    },
    "verify_keyed_fused": {
        "on": "cpu",
        "args": {
            "buf": ("u8", ("104+bucket", "B")),
            "digest": ("u8", (64, "B")),
            "table": ("i32", ("nwin", 4, "NLIMBS", "cap*nent")),
            "key_valid": ("bool", ("cap",)),
            "b_table": ("i32", (32, 3, "NLIMBS", 256)),
        },
        "static": ("bucket", "window_bits"),
        "out": ("bool", ("B",)),
    },
    "verify_generic_fused": {
        "on": "cpu",
        "args": {
            "buf": ("u8", ("100+bucket", "B")),
            "digest": ("u8", (64, "B")),
        },
        "static": ("bucket",),
        "out": ("bool", ("B",)),
    },
}
