"""The port's host tier -- its g++ build of csrc/host/ed25519_batch.cpp,
``crypto/ed25519_native.rlc_verify`` and ``crypto/ed25519.CpuBatchVerifier``
-- against the reference's native library and verifier and the big-int
oracle.  Tolerance: exact (return codes and verdict vectors equal)."""

import ctypes
import hashlib
import shutil
import types

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import ed25519_native as jnat
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import ed25519_native as nat
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.ops import _build

SEED = 0x4057


@pytest.fixture(scope="module")
def libs():
    ref = jnat.load()
    assert ref is not None, "the reference's native library did not build"
    return nat.load(), ref


@pytest.fixture(scope="module")
def base():
    """20 valid signatures under 5 keys, messages of 0-79 bytes from a
    numpy seed."""
    rs = np.random.RandomState(SEED)
    privs = [ed.priv_key_from_secret(b"host-tier-%d" % i) for i in range(5)]
    out = []
    for i in range(20):
        priv = privs[i % 5]
        msg = rs.bytes(int(rs.randint(0, 80)))
        out.append((priv.pub_key().bytes(), msg, priv.sign(msg)))
    return privs, out


def _bad_point() -> bytes:
    return next(bytes([i]) + bytes(31) for i in range(2, 255)
                if E.decode_point(bytes([i]) + bytes(31)) is None)


def _case(name: str, base) -> list[tuple[bytes, bytes, bytes]]:
    privs, valid = base
    cases = [tuple(t) for t in valid]
    if name == "altered_message":
        pub, m, sig = cases[4]
        cases[4] = (pub, m + b"!", sig)
    elif name == "s_ge_l":
        pub, m, sig = cases[3]
        s = int.from_bytes(sig[32:], "little") + E.L
        cases[3] = (pub, m, sig[:32] + s.to_bytes(32, "little"))
    elif name == "cancellation":
        # two bad signatures whose S errors cancel in an unweighted sum
        d = 12345
        for i, sign in ((5, 1), (10, -1)):   # lanes 5 and 10 share key 0
            pub, m, sig = cases[i]
            s = (int.from_bytes(sig[32:], "little") + sign * d) % E.L
            cases[i] = (pub, m, sig[:32] + s.to_bytes(32, "little"))
    elif name == "torsion_key":
        # ZIP-215: a small-order key with R = [s]B + torsion is valid
        tors = E.small_order_points()
        for lane, (a_enc, t_enc) in enumerate([(tors[1], tors[0]), (tors[3], tors[2])]):
            s = 1 + lane * 7919
            r_pt = E.pt_add(E.pt_mul(s, E.B_POINT), E.decode_point(t_enc))
            cases[lane * 5] = (a_enc, b"torsion lane %d" % lane,
                               E.encode_point(r_pt) + s.to_bytes(32, "little"))
    elif name == "noncanonical_r":
        # the identity's y encoded as p + 1: k binds to the bytes
        priv = privs[0]
        h = hashlib.sha512(priv.bytes()[:32]).digest()
        a = int.from_bytes(bytes([h[0] & 248]) + h[1:31] + bytes([(h[31] & 63) | 64]),
                           "little")
        pub = priv.pub_key().bytes()
        r_enc = (E.P + 1).to_bytes(32, "little")
        msg = b"non-canonical R"
        k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % E.L
        cases[7] = (pub, msg, r_enc + (k * a % E.L).to_bytes(32, "little"))
    elif name == "undecodable_pub":
        _, m, sig = cases[11]
        cases[11] = (_bad_point(), m, sig)
    elif name == "undecodable_r":
        pub, m, sig = cases[12]
        cases[12] = (pub, m, _bad_point() + sig[32:])
    else:
        assert name == "all_valid"
    return cases


#: case -> the RLC equation's rc with any weights: 1 holds, 0 fails,
#: < 0 a point that does not decode (S >= L holds mod L; rlc_verify
#: rejects it before the call)
CASES = {
    "all_valid": 1, "altered_message": 0, "s_ge_l": 1, "cancellation": 0,
    "torsion_key": 1, "noncanonical_r": 1, "undecodable_pub": -6, "undecodable_r": -1000012,
}


def _draws(n: int, seed: int) -> list[bytes]:
    rs = np.random.RandomState(seed)
    return [rs.bytes(16) for _ in range(n)]


def _scalar_args(entries, draws):
    """The C function's arguments, computed once in the test: unique
    keys, key indices, R encodings, z_i k_i mod L, z_i, sum z_i s_i mod L."""
    keys: dict[bytes, int] = {}
    idx = (ctypes.c_int32 * len(entries))()
    rs, za, zr, c = bytearray(), bytearray(), bytearray(), 0
    for i, ((pub, msg, sig), draw) in enumerate(zip(entries, draws)):
        idx[i] = keys.setdefault(pub, len(keys))
        s = int.from_bytes(sig[32:], "little")
        k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % E.L
        z = int.from_bytes(draw, "little") | 1
        rs += sig[:32]
        za += (z * k % E.L).to_bytes(32, "little")
        zr += z.to_bytes(32, "little")
        c = (c + z * s) % E.L
    return (b"".join(keys), idx, bytes(rs), E.encode_point(E.B_POINT), bytes(za), bytes(zr),
            c.to_bytes(32, "little"), len(keys), len(entries))


@pytest.mark.parametrize("name", list(CASES))
def test_rlc_rc_matches_reference(name, base, libs):
    """Both builds of the C++ return the same code on the same scalar
    bytes."""
    entries = _case(name, base)
    args = _scalar_args(entries, _draws(len(entries), SEED + 1))
    port, ref = libs
    assert port.cmt_ed25519_rlc_verify(*args) == ref.cmt_ed25519_rlc_verify(*args) \
        == CASES[name]


@pytest.mark.parametrize("name", list(CASES))
def test_rlc_verify_replays_reference(name, base, libs, monkeypatch):
    """rlc_verify with a replayed draw equals the reference's rlc_verify
    with os.urandom giving the same draw, and the oracle's verdict on
    the batch as a whole."""
    entries = _case(name, base)
    draws = _draws(len(entries), SEED + 2)
    it = iter(draws)
    monkeypatch.setattr(jnat, "os", types.SimpleNamespace(urandom=lambda k: next(it)))
    want = all(E.verify_zip215(*t) for t in entries)
    port, ref = libs
    assert nat.rlc_verify(port, entries, weights=draws) is want
    assert jnat.rlc_verify(ref, entries) is want


@pytest.mark.parametrize("name,n", [(c, 20) for c in CASES] + [("altered_message", 8)])
def test_cpu_batch_verifier_matches_reference_and_oracle(name, n, base, libs):
    """CpuBatchVerifier's verdict vector: the port's = the reference's =
    the oracle's, at 20 and 8 lanes."""
    entries = _case(name, base)[:n]
    port, ref = ed.CpuBatchVerifier(), jed.CpuBatchVerifier()
    for pub, msg, sig in entries:
        port.add(ed.Ed25519PubKey(pub), msg, sig)
        ref.add(jed.Ed25519PubKey(pub), msg, sig)
    oracle = [E.verify_zip215(*t) for t in entries]
    assert port.verify() == ref.verify() == (all(oracle), oracle)


def test_cancellation_rejected_under_fresh_weights(base, libs):
    entries = _case("cancellation", base)
    for trial in range(5):
        assert nat.rlc_verify(libs[0], entries) is False, f"survived trial {trial}"
    assert nat.rlc_verify(libs[0], []) is None


def test_host_build_failure_raises_with_gxx_stderr(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "host" / "ed25519_batch.cpp"
    src.write_text(src.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_built", {})
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for host/ed25519_batch.cpp"
                                           r"(.|\n)*error"):
        nat.load()


def test_host_library_name_tracks_its_source_only(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build._target("ed25519_batch")[1]
    header = csrc / "field.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._target("ed25519_batch")[1] == before
    src = csrc / "host" / "ed25519_batch.cpp"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build._target("ed25519_batch")[1] != before
