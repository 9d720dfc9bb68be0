"""The kernel sources of the keyed path compiled as plain C++ by g++ and
run on the host, lane by lane, against their plain PyTorch versions:

- csrc/verify_keyed.cu (with field.cuh) at every compiled group size,
  each group's ranks simulated phase by phase, against
  ``verify_keyed_plain``: verdicts and the limbs of [8]q identical on
  every lane, planted invalid lanes included;
- csrc/sha512.cu's sha512_keyed per-lane body against
  ``keyed_digest_plain``, with message lengths on both sides of every
  block edge.

This checks the kernels' arithmetic where there is no CUDA compiler;
the card run (chip_smoke.py) checks the same on the device."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR

SEED = 0x40575


@pytest.fixture(scope="session")
def hostlib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH: the host build of the kernel sources needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("keyed_host") / "libkeyed_host.so")
    srcs = [os.path.join(_build.CSRC, f) for f in ("verify_keyed.cu", "sha512.cu")]
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", out, *srcs],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.verify_keyed_host.argtypes = [vp, i64, i32, vp, vp, i64, vp, i64, vp, vp, vp, i64,
                                      i32, i32]
    lib.verify_keyed_host.restype = ctypes.c_int
    lib.sha512_keyed_host.argtypes = [vp, i64, i32, i32, vp, i64]
    lib.sha512_keyed_host.restype = ctypes.c_int
    return lib


def _lanes():
    """Eight votes by four keys (few keys keep the table build short):
    two valid, then flipped S, S >= L, undecodable R, non-canonical R,
    undecodable A, and a small-order A that the cofactored ZIP-215
    equation accepts."""
    rs = np.random.RandomState(SEED)
    privs = [ed.priv_key_from_secret(b"host-%d" % i) for i in range(2)]
    triples = []
    for i in range(8):
        priv = privs[i % 2]
        msg = rs.randint(0, 256, int(rs.randint(0, 200))).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    s = triples[2][2]
    triples[2][2] = s[:40] + bytes([s[40] ^ 1]) + s[41:]
    s = triples[3][2]
    triples[3][2] = s[:32] + (int.from_bytes(s[32:], "little") + E.L).to_bytes(32, "little")
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    triples[4][2] = bad + triples[4][2][32:]
    triples[5][2] = (E.P + 1).to_bytes(32, "little") + triples[5][2][32:]
    triples[6][0] = bad
    triples[7][0] = E.small_order_points()[1]
    triples[7][2] = E.encode_point(E.IDENTITY) + bytes(32)
    expected = [E.verify_zip215(p, m, s) for p, m, s in triples]
    assert expected == [True, True, False, False, False, False, False, True]
    return triples, expected


@pytest.fixture(scope="module", params=[8, 4])
def keyed_case(request):
    """The lanes, their tables at window width 8 or 4, and the plain
    version's verdicts and [8]q, built once for every group size."""
    window_bits = request.param
    triples, expected = _lanes()
    pubs = [p for p, _, _ in triples]
    with pytest.MonkeyPatch.context() as mp:
        if window_bits == 4:
            mp.setattr(PR, "KEY8_MAX", 1)
        entry = PR.KeyTableCache("cpu").lookup_or_build(pubs)
    assert entry.window_bits == window_bits
    # 16 lanes packed, the kernel given the second half (lanes 8..15,
    # a copy of 0..7) through its row stride, as a slice is
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs] * 2)
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples] * 2)
    msgs = [m for _, m, _ in triples] * 2
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=entry.key_ids(pubs * 2))
    rows = torch.as_tensor(packed)[:, 8:]
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    b_table = F.const(PR.b_comb8(), "cpu")
    want_ok, want_q8 = EV.verify_keyed_plain(
        rows, digest, entry.table, entry.valid_device(), b_table, bucket, window_bits)
    assert want_ok.tolist() == expected
    return dict(window_bits=window_bits, expected=expected, entry=entry, packed=packed,
                bucket=bucket, digest=np.ascontiguousarray(digest.numpy()),
                b_table=np.ascontiguousarray(b_table.numpy()), want_q8=want_q8.numpy())


@pytest.mark.parametrize("group", EV.GROUPS)
def test_host_build_matches_plain(hostlib, keyed_case, group):
    c = keyed_case
    table = c["entry"].table.numpy()
    valid = c["entry"].valid.astype(np.uint8)
    packed = c["packed"]
    ok = np.full(8, 7, dtype=np.uint8)
    q8 = np.zeros((4, F.NLIMBS, 8), dtype=np.int32)
    rc = hostlib.verify_keyed_host(
        packed.ctypes.data + 8, packed.shape[1], c["bucket"], c["digest"].ctypes.data,
        table.ctypes.data, table.shape[3], valid.ctypes.data, len(valid),
        c["b_table"].ctypes.data, ok.ctypes.data, q8.ctypes.data, 8, c["window_bits"], group,
    )
    assert rc == 0
    assert ok.astype(bool).tolist() == c["expected"]
    np.testing.assert_array_equal(q8, c["want_q8"])


def test_host_build_refuses_uncompiled_group(hostlib):
    z = np.zeros(1, dtype=np.uint8)
    assert hostlib.verify_keyed_host(z.ctypes.data, 1, 128, z.ctypes.data, z.ctypes.data, 1,
                                     z.ctypes.data, 1, z.ctypes.data, z.ctypes.data, None,
                                     0, 8, 16) == -1


# Message lengths on both sides of each block edge: R || A is 64 bytes
# and the padding at least 17, so 47 is the longest one-block message,
# 175 the longest of two; 256 is the bucket.
_SHA_LENS = [0, 46, 47, 48, 110, 111, 112, 175, 176, 256]


def test_host_sha512_keyed_matches_plain(hostlib):
    rs = np.random.RandomState(SEED + 1)
    n = len(_SHA_LENS) + 2
    pub = rs.randint(0, 256, (n, 32)).astype(np.uint8)
    sig = rs.randint(0, 256, (n, 64)).astype(np.uint8)
    msgs = [rs.randint(0, 256, ln).astype(np.uint8).tobytes() for ln in _SHA_LENS + [5, 9]]
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=np.arange(n))
    assert bucket == 256
    # two lanes whose length field lies: past the bucket, and negative
    # as a signed 32-bit value; the kernel must hash them as the plain
    # version does
    lens = packed[96 + bucket : 100 + bucket]
    lens[:, n - 2] = np.frombuffer(np.uint32(300).tobytes(), dtype=np.uint8)
    lens[:, n - 1] = np.frombuffer(np.uint32(0xFFFFFFF0).tobytes(), dtype=np.uint8)
    nblocks = EV.nblocks_for_bucket(bucket)
    # the kernel reads the second half of a 2n-lane buffer through its
    # row stride
    wide = np.concatenate([packed[:, :n], packed[:, :n]], axis=1)
    want = EV.keyed_digest_plain(torch.as_tensor(packed[:, :n]), bucket, nblocks).numpy()
    got = np.zeros((64, n), dtype=np.uint8)
    rc = hostlib.sha512_keyed_host(wide.ctypes.data + n, wide.shape[1], bucket, nblocks,
                                   got.ctypes.data, n)
    assert rc == 0
    np.testing.assert_array_equal(got, want)
    for j, m in enumerate(msgs[: len(_SHA_LENS)]):
        r_a = bytes(sig[j, :32]) + bytes(pub[j])
        assert bytes(got[:, j]) == hashlib.sha512(r_a + m).digest()
