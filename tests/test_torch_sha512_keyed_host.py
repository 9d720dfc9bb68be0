"""sha512_keyed (csrc/sha512.cu) compiled as plain C++ by g++ and run on
the host -- a warp's rows staged as the warp copies them, then its lanes
one after another -- against ``keyed_digest_plain`` and hashlib, on the
layouts the staging must handle: the keyed (104 + bucket) and generic
(100 + bucket) rows, row strides and column offsets that take the
16-byte, 4-byte and byte copies, lane counts that leave the last warp
part full, message lengths on both sides of each block edge and up to
the bucket, and length fields past the bucket or negative.

This checks the kernel's staging and padding where there is no CUDA
compiler; the card run (chip_smoke.py) checks the same on the device."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_verify as EV

SEED = 0x5A512


@pytest.fixture(scope="module")
def hostlib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH: the host build of the kernel sources needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("sha_host") / "libsha_host.so")
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", out,
         os.path.join(_build.CSRC, "sha512.cu")],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sha512_keyed_host.argtypes = [vp, i64, i32, i32, vp, i64]
    lib.sha512_keyed_host.restype = ctypes.c_int
    return lib


def _lens(bucket: int) -> list[int]:
    """Eight message lengths: R || A is 64 bytes and the padding at least
    17, so 47 is the longest message of one block and 48 the shortest of
    two (175 and 176 the same for two and three); 111 and 112 put the
    0x80 byte at the last and the first byte of a word; the empty one and
    the bucket's maximum."""
    return [0, 47, 48, 111, 112, bucket] + ([175, 176] if bucket >= 176 else [5, bucket - 1])


# Length fields that lie: past the bucket, and negative as signed int32
# (-16 still leaves one block; -100 and INT32_MIN none).
_LIES = [300, 0xFFFFFFF0, 0xFFFFFF9C, 0x80000000]


def _batch(keyed: bool, bucket: int, n: int, seed: int):
    """Packed rows of n lanes (the last four with lying length fields
    when n > 8), their messages, R || A, and which lanes are honest."""
    rs = np.random.RandomState(seed)
    lens = [_lens(bucket)[i % 8] for i in range(n)]
    pub = rs.randint(0, 256, (n, 32)).astype(np.uint8)
    sig = rs.randint(0, 256, (n, 64)).astype(np.uint8)
    msgs = [rs.randint(0, 256, ln).astype(np.uint8).tobytes() for ln in lens]
    packed, got_bucket = EV.pack_inputs(pub, sig, msgs,
                                        key_ids=np.arange(n) if keyed else None)
    assert got_bucket == bucket and packed.shape[0] == (104 if keyed else 100) + bucket
    packed = np.ascontiguousarray(packed[:, :n])  # pack_inputs pads the lanes to a power of two
    honest = np.ones(n, dtype=bool)
    if n > 8:
        for j, lie in zip(range(n - len(_LIES), n), _LIES):
            packed[96 + bucket : 100 + bucket, j] = np.frombuffer(
                np.uint32(lie).tobytes(), dtype=np.uint8)
            honest[j] = False
    return packed, msgs, [bytes(sig[j, :32]) + bytes(pub[j]) for j in range(n)], honest


def _place(packed: np.ndarray, ld: int, offset: int, rs) -> tuple[np.ndarray, int]:
    """The rows at a row stride of ``ld`` bytes and a column offset of
    ``offset`` in a buffer whose first byte is 64-byte aligned (so the
    offsets alone decide each copy's alignment), the other columns
    random: (holder, address of the first lane's first byte)."""
    rows, n = packed.shape
    assert offset + n <= ld
    holder = rs.randint(0, 256, rows * ld + 128).astype(np.uint8)
    base = (-holder.ctypes.data) % 64
    view = holder[base : base + rows * ld].reshape(rows, ld)
    view[:, offset : offset + n] = packed
    return holder, holder.ctypes.data + base + offset


# (rows, bucket, lanes, row stride, column offset): the copies each layout
# takes (16-byte when the stride and offset are multiples of 16, 4-byte
# when of 4, byte loads otherwise) and a last warp part full
LAYOUTS = [
    ("keyed", 256, 45, 128, 0),      # 16-byte copies, a warp of 13 lanes
    ("keyed", 128, 64, 80, 4),       # 4-byte copies (16-byte aligned rows, offset 4)
    ("generic", 256, 40, 101, 3),    # odd stride: byte loads
    ("generic", 128, 37, 96, 40),    # offset 8 mod 16: 4-byte copies and a tail
    ("keyed", 1024, 33, 1040, 977),  # 9 blocks; an odd offset: byte loads
]


@pytest.mark.parametrize("kind, bucket, n, ld, offset", LAYOUTS,
                         ids=[f"{k}-b{b}-n{n}-ld{ld}-off{o}" for k, b, n, ld, o in LAYOUTS])
def test_host_sha512_keyed_layouts(hostlib, kind, bucket, n, ld, offset):
    packed, msgs, heads, honest = _batch(kind == "keyed", bucket, n, SEED + ld + offset)
    nblocks = EV.nblocks_for_bucket(bucket)
    want = EV.keyed_digest_plain(torch.as_tensor(packed), bucket, nblocks).numpy()
    holder, at = _place(packed, ld, offset, np.random.RandomState(SEED + n))
    got = np.zeros((64, n), dtype=np.uint8)
    assert hostlib.sha512_keyed_host(at, ld, bucket, nblocks, got.ctypes.data, n) == 0
    np.testing.assert_array_equal(got, want)
    for j in np.flatnonzero(honest):
        assert bytes(got[:, j]) == hashlib.sha512(heads[j] + msgs[j]).digest()
    # the lying lengths: -100 and INT32_MIN absorb no block (the IV)
    if n > 8:
        iv = EV.keyed_digest_plain(torch.as_tensor(packed[:, n - 2 : n]), bucket, nblocks)
        assert np.array_equal(got[:, n - 2 :], iv.numpy())
        assert len({bytes(got[:, j]) for j in (n - 2, n - 1)}) == 1
