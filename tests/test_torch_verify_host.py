"""The fused keyed-verify kernel's source (cometbft_tpu_torch/csrc/
verify_keyed.cu with field.cuh) compiled as plain C++ by g++ and run on
the host, lane by lane, against its plain PyTorch version
(``verify_keyed_plain``): verdicts and the limbs of [8]q must be
identical on every lane, planted invalid lanes included.  This checks
the kernel's arithmetic where there is no CUDA compiler; the card run
(chip_smoke.py) checks the same on the device."""

import ctypes
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
        pytest.skip("no g++ on PATH: the host build of the kernel source needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("verify_keyed_host") / "libverify_keyed_host.so")
    src = os.path.join(_build.CSRC, "verify_keyed.cu")
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", out, src],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.verify_keyed_host.argtypes = [vp, i64, i32, vp, vp, i64, vp, i64, vp, vp, vp, i64, i32]
    lib.verify_keyed_host.restype = ctypes.c_int
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


@pytest.mark.parametrize("window_bits", [8, 4])
def test_host_build_matches_plain(hostlib, window_bits, monkeypatch):
    triples, expected = _lanes()
    if window_bits == 4:
        monkeypatch.setattr(PR, "KEY8_MAX", 1)
    pubs = [p for p, _, _ in triples]
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

    table = entry.table.numpy()
    valid = entry.valid.astype(np.uint8)
    b_np = np.ascontiguousarray(b_table.numpy())
    dig = np.ascontiguousarray(digest.numpy())
    ok = np.full(8, 7, dtype=np.uint8)
    q8 = np.zeros((4, F.NLIMBS, 8), dtype=np.int32)
    rc = hostlib.verify_keyed_host(
        packed.ctypes.data + 8, packed.shape[1], bucket, dig.ctypes.data,
        table.ctypes.data, table.shape[3], valid.ctypes.data, len(valid),
        b_np.ctypes.data, ok.ctypes.data, q8.ctypes.data, 8, window_bits,
    )
    assert rc == 0
    assert ok.astype(bool).tolist() == expected
    np.testing.assert_array_equal(q8, want_q8.numpy())
