"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the main path's shapes (chip_smoke.py phase 3 under pytest).
Exact equality: the arithmetic is integer.

Needs an NVIDIA GPU and nvcc; every test skips without a CUDA device.
Run on the card with (tests/conftest.py imports jax, which a machine
that only runs the port need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import sha512 as SH

pytestmark = pytest.mark.gpu

SEED = 0x6B0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    _build.build_all()
    return torch.device("cuda", 0)


def _limbs(rs, b, dev):
    return torch.as_tensor(
        rs.randint(-(1 << 13) + 1, 1 << 13, (F.NLIMBS, b)).astype(np.int32)
    ).to(dev)


@pytest.mark.parametrize("b", [1, 127, 256, 8192])
def test_fe_mul_equals_plain(dev, b):
    rs = np.random.RandomState(SEED + b)
    x, y = _limbs(rs, b, dev), _limbs(rs, b, dev)
    before = _build.LAUNCHES["fe_mul"]
    got = F.fe_mul(x, y)
    assert _build.LAUNCHES["fe_mul"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, F.mul_plain(x, y))


@pytest.mark.parametrize("b", [256, 8192])
@pytest.mark.parametrize("n", [1, 5, 50])
def test_fe_sq_equals_plain(dev, b, n):
    rs = np.random.RandomState(SEED + b + n)
    x = _limbs(rs, b, dev)
    before = _build.LAUNCHES["fe_sq"]
    got = F.fe_sq(x, n)
    assert _build.LAUNCHES["fe_sq"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, F.square_plain(x, n))


def test_fe_mul_broadcasts_constants_and_batches(dev):
    from cometbft_tpu_torch.ops import curve as C

    rs = np.random.RandomState(SEED)
    x = _limbs(rs, 6 * 40, dev).reshape(F.NLIMBS, 6, 40)
    c = F.cvec(C.TWO_D_LIMBS, 3, dev)
    got = F.fe_mul(x, c)
    assert got.shape == x.shape
    assert torch.equal(got, F.mul_plain(x, c))


def test_sha512_equals_plain_and_hashlib(dev):
    rs = np.random.RandomState(SEED)
    nblocks, b = 2, 256
    msgs = [rs.randint(0, 256, int(n)).astype(np.uint8).tobytes()
            for n in rs.randint(0, nblocks * 128 - 17 + 1, b)]
    buf = np.zeros((nblocks * 128, b), dtype=np.uint8)
    nbl = np.zeros(b, dtype=np.int64)
    for i, m in enumerate(msgs):
        p, k = SH.pad_message(m)
        buf[: len(p), i] = p
        nbl[i] = k
    tbuf, tnbl = torch.as_tensor(buf).to(dev), torch.as_tensor(nbl).to(dev)
    before = _build.LAUNCHES["sha512_padded"]
    got = SH.sha512_padded(tbuf, nblocks, tnbl)
    assert _build.LAUNCHES["sha512_padded"] == before + 1
    assert torch.equal(got, SH.sha512_padded_plain(tbuf, nblocks, tnbl))
    host = got.cpu().numpy()
    for i, m in enumerate(msgs):
        assert bytes(host[:, i]) == hashlib.sha512(m).digest()


def test_wrappers_raise_on_wrong_dtype(dev):
    with pytest.raises(TypeError):
        F.fe_mul(torch.zeros((F.NLIMBS, 4), dtype=torch.int64, device=dev),
                 torch.zeros((F.NLIMBS, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        F.fe_mul(torch.zeros((F.NLIMBS, 4), dtype=torch.int32, device=dev),
                 torch.zeros((F.NLIMBS, 4), dtype=torch.int32))


@pytest.mark.parametrize("window_bits", [8, 4])
def test_verify_keyed_equals_plain(dev, window_bits, monkeypatch):
    """The fused keyed verify against its plain version on the card:
    verdicts and the limbs of [8]q on every lane, planted invalid lanes
    (flipped S, S >= L, undecodable R, undecodable A) included."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import edwards as E
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    rs = np.random.RandomState(SEED + window_bits)
    triples = []
    for i in range(16):
        priv = ed.priv_key_from_secret(b"gpu-%d" % i)
        msg = rs.randint(0, 256, int(rs.randint(0, 250))).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    s = triples[1][2]
    triples[1][2] = s[:40] + bytes([s[40] ^ 1]) + s[41:]
    s = triples[2][2]
    triples[2][2] = s[:32] + (int.from_bytes(s[32:], "little") + E.L).to_bytes(32, "little")
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    triples[3][2] = bad + triples[3][2][32:]
    triples[4][0] = bad
    expected = [E.verify_zip215(p, m, s) for p, m, s in triples]
    if window_bits == 4:
        monkeypatch.setattr(PR, "KEY8_MAX", 8)
    pubs = [p for p, _, _ in triples]
    entry = PR.KeyTableCache(dev).lookup_or_build(pubs)
    assert entry.window_bits == window_bits
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    packed, bucket = EV.pack_inputs(pub, sig, [m for _, m, _ in triples],
                                    key_ids=entry.key_ids(pubs))
    rows = torch.as_tensor(packed).to(dev)
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    b_table = F.const(PR.b_comb8(), dev)
    q8 = torch.empty((4, F.NLIMBS, rows.shape[1]), dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["verify_keyed"]
    ok = EV.verify_keyed_fused(rows, digest, entry.table, entry.valid_device(),
                               b_table, bucket, window_bits, out_point=q8)
    assert _build.LAUNCHES["verify_keyed"] == before + 1
    torch.cuda.synchronize()
    want_ok, want_q8 = EV.verify_keyed_plain(rows, digest, entry.table,
                                             entry.valid_device(), b_table, bucket,
                                             window_bits)
    assert torch.equal(ok, want_ok)
    assert torch.equal(q8, want_q8)
    assert ok.tolist() == expected
