"""The generic tier's kernel source compiled as plain C++ by g++ and run
on the host, lane by lane, against its plain PyTorch version:

- csrc/verify_generic.cu (with field.cuh and point.cuh) at every compiled
  launch shape (quarters, threads per quarter), each group's ranks
  simulated phase by phase and each stage's jobs in turn, against
  ``verify_generic_plain``: verdicts and the limbs of [8]q identical on
  every lane, planted invalid lanes included; and again with each
  stage's jobs last to first, so that a job reading a slot that another
  job of its stage writes (a race between quarters on the card) shows;
- csrc/sha512.cu's sha512_keyed per-lane body on the generic layout
  (100 + bucket rows, no key ids) against ``keyed_digest_plain``.

This checks the kernel's arithmetic where there is no CUDA compiler; the
card run (chip_smoke.py) checks the same on the device."""

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
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F

SEED = 0x6E4E


@pytest.fixture(scope="module")
def hostlib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH: the host build of the kernel sources needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("generic_host") / "libgeneric_host.so")
    srcs = [os.path.join(_build.CSRC, f)
            for f in ("verify_generic.cu", "verify_keyed.cu", "sha512.cu")]
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", out, *srcs],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    pi32 = ctypes.POINTER(ctypes.c_int)
    lib.verify_generic_host.argtypes = [vp, i64, vp, vp, vp, vp, vp, i64, i32, i32, i32]
    lib.verify_generic_host.restype = ctypes.c_int
    lib.sha512_keyed_host.argtypes = [vp, i64, i32, i32, vp, i64]
    lib.sha512_keyed_host.restype = ctypes.c_int
    lib.verify_keyed_group.argtypes = [i64]
    lib.verify_keyed_group.restype = ctypes.c_int
    lib.verify_generic_shape.argtypes = [i64, pi32, pi32]
    lib.verify_generic_shape.restype = ctypes.c_int
    return lib


def _lanes():
    """Eight votes: two valid, then flipped S, S >= L, undecodable R,
    non-canonical R, undecodable A, and a small-order A that the
    cofactored ZIP-215 equation accepts."""
    rs = np.random.RandomState(SEED)
    privs = [ed.priv_key_from_secret(b"generic-host-%d" % i) for i in range(3)]
    triples = []
    for i in range(8):
        priv = privs[i % 3]
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


@pytest.fixture(scope="module")
def generic_case():
    """The lanes packed twice over (16 lanes, generic layout), and the
    plain version's verdicts and [8]q on the second copy, computed once
    for every group size."""
    triples, expected = _lanes()
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples] * 2)
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples] * 2)
    packed, bucket = EV.pack_inputs(pub, sig, [m for _, m, _ in triples] * 2)
    assert packed.shape[0] == 100 + bucket
    rows = torch.as_tensor(packed)[:, 8:]
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    want_ok, want_q8 = EV.verify_generic_plain(rows, digest)
    assert want_ok.tolist() == expected
    return dict(expected=expected, packed=packed, digest=np.ascontiguousarray(digest.numpy()),
                want_q8=want_q8.numpy())


def _sid(shape):
    """A shape's test id: the group size alone for one group per lane,
    as the tests were named when that was the only schedule."""
    q, g = shape
    return str(g) if q == 1 else f"{q}x{g}"


def _run_host(lib, packed, digest, n, shape, reverse=False, offset=0):
    """The host build on n lanes of ``packed`` from column ``offset``
    (read through the row stride): (verdicts, [8]q limbs)."""
    b_comb = np.ascontiguousarray(C.B_COMB)
    mult = np.zeros((16, 4, F.NLIMBS, n), dtype=np.int32)
    ok = np.full(n, 7, dtype=np.uint8)
    q8 = np.zeros((4, F.NLIMBS, n), dtype=np.int32)
    rc = lib.verify_generic_host(
        packed.ctypes.data + offset, packed.shape[1], digest.ctypes.data, b_comb.ctypes.data,
        mult.ctypes.data, ok.ctypes.data, q8.ctypes.data, n, *shape, int(reverse),
    )
    assert rc == 0
    return ok.astype(bool).tolist(), q8


@pytest.mark.parametrize("shape", EV.VG_SHAPES, ids=_sid)
def test_host_build_matches_plain(hostlib, generic_case, shape):
    """The kernel reads the second half of the 16-lane buffer through its
    row stride, as it reads a slice of a wider batch."""
    c = generic_case
    ok, q8 = _run_host(hostlib, c["packed"], c["digest"], 8, shape, offset=8)
    assert ok == c["expected"]
    np.testing.assert_array_equal(q8, c["want_q8"])


@pytest.mark.parametrize("shape", EV.VG_SHAPES, ids=_sid)
def test_host_build_reverse_order_matches_plain(hostlib, generic_case, shape):
    """Each stage's jobs run last to first: the verdicts and limbs must
    not move, or one quarter's product reads a slot that a concurrent
    quarter writes (on the card, a race)."""
    c = generic_case
    ok, q8 = _run_host(hostlib, c["packed"], c["digest"], 8, shape, reverse=True, offset=8)
    assert ok == c["expected"]
    np.testing.assert_array_equal(q8, c["want_q8"])


@pytest.fixture(scope="module")
def invalid_a_case():
    """Lanes whose equation holds whatever A is -- a zero digest (k = 0),
    S = 0, R the identity -- so that A's validity alone decides, and the
    plain version's verdicts and limbs on them."""
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    good = ed.priv_key_from_secret(b"generic-host-a").pub_key().bytes()
    sig = E.encode_point(E.IDENTITY) + bytes(32)
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in (good, bad, good, bad)])
    sigs = np.stack([np.frombuffer(sig, dtype=np.uint8)] * 4)
    packed, _ = EV.pack_inputs(pub, sigs, [b"m"] * 4)
    packed = np.ascontiguousarray(packed[:, :4])
    digest = np.zeros((64, 4), dtype=np.uint8)
    want_ok, want_q8 = EV.verify_generic_plain(torch.as_tensor(packed), torch.as_tensor(digest))
    assert want_ok.tolist() == [True, False, True, False]
    return packed, digest, want_q8.numpy()


@pytest.mark.parametrize("shape", EV.VG_SHAPES, ids=_sid)
def test_host_build_refuses_invalid_a_alone(hostlib, invalid_a_case, shape):
    """A valid A passes, an undecodable one fails, in the kernel as in
    the plain version, whichever quarter decompresses A."""
    packed, digest, want_q8 = invalid_a_case
    ok, q8 = _run_host(hostlib, packed, digest, 4, shape)
    assert ok == [True, False, True, False]
    np.testing.assert_array_equal(q8, want_q8)


@pytest.mark.parametrize("n, want", [(1, 32), (1024, 32), (1025, 8), (4096, 8),
                                     (4097, 1), (8192, 1)])
def test_launcher_group_choice(hostlib, n, want):
    """point.cuh's pick_group, which the keyed kernel launches with: 32
    threads per lane up to 1024 lanes, 8 up to 4096, then 1 -- always a
    compiled group size."""
    assert hostlib.verify_keyed_group(n) == want and want in EV.GROUPS


@pytest.mark.parametrize("n, want", [(1, (4, 32)), (256, (4, 32)), (257, (4, 8)),
                                     (1024, (4, 8)), (1025, (4, 1)), (8192, (4, 1))])
def test_launcher_shape_choice(hostlib, n, want):
    """verify_generic.cu's pick_shape, the generic kernel's own chooser:
    four quarters of 32 threads up to 256 lanes, of 8 up to 1024, then
    of one -- always a compiled shape."""
    q, g = ctypes.c_int(-1), ctypes.c_int(-1)
    assert hostlib.verify_generic_shape(n, ctypes.byref(q), ctypes.byref(g)) == 0
    assert (q.value, g.value) == want and want in EV.VG_SHAPES


def test_host_build_refuses_uncompiled_group(hostlib):
    z = np.zeros(1, dtype=np.uint8)
    for shape in [(1, 16), (2, 8), (4, 4), (0, 0)]:
        assert hostlib.verify_generic_host(z.ctypes.data, 1, z.ctypes.data, z.ctypes.data,
                                           z.ctypes.data, z.ctypes.data, None, 0, *shape,
                                           0) == -1, shape


def test_host_sha512_keyed_on_generic_rows(hostlib):
    """sha512_keyed on (100 + bucket) rows hashes R || A || M as
    ``keyed_digest_plain`` does on the same rows and on the keyed
    layout's (104 + bucket) rows: R, A, the message and its length sit at
    the same rows in both, and the key-id rows are never read."""
    rs = np.random.RandomState(SEED + 1)
    lens = [0, 47, 48, 111, 112, 128, 5, 99]
    n = len(lens)
    pub = rs.randint(0, 256, (n, 32)).astype(np.uint8)
    sig = rs.randint(0, 256, (n, 64)).astype(np.uint8)
    msgs = [rs.randint(0, 256, ln).astype(np.uint8).tobytes() for ln in lens]
    packed, bucket = EV.pack_inputs(pub, sig, msgs)
    keyed, kbucket = EV.pack_inputs(pub, sig, msgs, key_ids=np.arange(n))
    assert bucket == kbucket == 128 and packed.shape[0] == 100 + bucket
    np.testing.assert_array_equal(keyed[: 100 + bucket], packed)
    nblocks = EV.nblocks_for_bucket(bucket)
    want = EV.keyed_digest_plain(torch.as_tensor(packed), bucket, nblocks).numpy()
    np.testing.assert_array_equal(
        EV.keyed_digest_plain(torch.as_tensor(keyed), bucket, nblocks).numpy(), want)
    np.testing.assert_array_equal(
        EV.keyed_digest(torch.as_tensor(packed), bucket, nblocks).numpy(), want)
    got = np.zeros((64, n), dtype=np.uint8)
    rc = hostlib.sha512_keyed_host(packed.ctypes.data, packed.shape[1], bucket, nblocks,
                                   got.ctypes.data, n)
    assert rc == 0
    np.testing.assert_array_equal(got, want)
    for j, m in enumerate(msgs):
        assert bytes(got[:, j]) == hashlib.sha512(bytes(sig[j, :32]) + bytes(pub[j]) + m).digest()


def test_library_name_tracks_point_header(monkeypatch, tmp_path):
    """An edit to csrc/point.cuh renames the libraries of both verify
    kernels that include it, so a stale build is never loaded."""
    monkeypatch.setattr(_build, "CSRC", str(shutil.copytree(_build.CSRC, tmp_path / "csrc")))
    before = {name: _build._target(name)[1] for name in _build.SOURCES}
    header = tmp_path / "csrc" / "point.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.SOURCES}
    assert after["verify_keyed"] != before["verify_keyed"]
    assert after["verify_generic"] != before["verify_generic"]
