"""The port's per-key comb tables and key-table pool
(cometbft_tpu_torch/ops/precompute.py) against the JAX reference's
build_tables_kernel and the big-int oracle: the plain build's table
entries and validity masks must be identical, limb for limb.  (The
pool's policy against the reference: test_torch_key_pool.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cometbft_tpu.ops import precompute as JPR
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR

SEED = 0x7AB1E


def _invalid_encoding() -> bytes:
    return next(bytes([j]) + bytes(31) for j in range(2, 255)
                if E.decode_point(bytes([j]) + bytes(31)) is None)


def _pubs(n_valid: int, tag: bytes) -> list[bytes]:
    return [ed.priv_key_from_secret(tag + b"%d" % i).pub_key().bytes()
            for i in range(n_valid)]


def _stack(pubs):
    return np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs], axis=-1)


@pytest.mark.parametrize(
    "window_bits, keys",
    [
        # valid keys mixed with one that does not decode and a small-order one
        (4, lambda: _pubs(3, b"p4-") + [_invalid_encoding(), E.small_order_points()[2]]),
        (8, lambda: [_pubs(1, b"p8-")[0], _invalid_encoding()]),
    ],
    ids=["4bit-5keys", "8bit-2keys"],
)
def test_tables_match_reference(window_bits, keys):
    pub = _stack(keys())
    want_table, want_valid = jax.jit(
        lambda p: JPR.build_tables_kernel(p, window_bits)
    )(jnp.asarray(pub))
    table, valid = PR.build_tables_plain(torch.as_tensor(pub), window_bits)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert not valid.numpy().all()
    assert table.shape == want_table.shape
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_table))


def test_build_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor runs build_tables_plain; bad arguments raise before
    any build."""
    calls = []
    monkeypatch.setattr(PR, "build_tables_plain", lambda p, wb: calls.append((p, wb)) or "plain")
    pub = torch.zeros((32, 3), dtype=torch.uint8)
    assert PR.build_tables_kernel(pub, 4) == "plain" and calls == [(pub, 4)]
    for bad in (dict(pub=pub, window_bits=5), dict(pub=pub.to(torch.int32), window_bits=4),
                dict(pub=pub[:31], window_bits=8),
                dict(pub=pub, window_bits=4, shapes=((2, 1), (0, 0))),
                dict(pub=pub, window_bits=4, shapes=((0, 0),))):
        with pytest.raises(ValueError):
            PR.build_tables_kernel(**bad)
    assert len(calls) == 1


def test_tables_from_jax_round_trip():
    pubs = _pubs(3, b"rt-")
    cache = PR.KeyTableCache("cpu")
    entry = cache.lookup_or_build(pubs)
    back = PR.tables_from_jax(entry.table.numpy(), entry.valid, entry.key_index,
                              entry.window_bits, "cpu")
    assert torch.equal(back.table, entry.table)
    assert back.valid.tolist() == entry.valid.tolist()
    assert back.key_index == entry.key_index and back.sethash == entry.sethash
    with pytest.raises(ValueError):
        PR.tables_from_jax(entry.table.numpy()[:, :, :, :8], entry.valid,
                           entry.key_index, entry.window_bits, "cpu")


@pytest.mark.parametrize("window_bits", [4, 8])
def test_keyed_comb_matches_oracle(window_bits):
    rs = np.random.RandomState(SEED + window_bits)
    keys = [E.pt_mul(int(rs.randint(1, 2**62)), E.B_POINT) for _ in range(2)]
    pub = _stack([E.encode_point(k) for k in keys])
    table, valid = PR.build_tables_kernel(torch.as_tensor(pub), window_bits)
    assert valid.all()
    key_ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    ks = [E.L - 1, int(rs.randint(0, 2**62)) << 190, 12345]
    nwin = 256 // window_bits
    wins = torch.tensor(
        [[(k >> (window_bits * w)) & ((1 << window_bits) - 1) for k in ks]
         for w in range(nwin)], dtype=torch.int32,
    )
    out = PR.comb_mul_keyed(table, key_ids, wins, window_bits)
    for lane, k in enumerate(ks):
        x, y, z = (F.to_int(F.reduce_full(out[c][:, lane : lane + 1])) for c in range(3))
        zi = pow(z, E.P - 2, E.P)
        want = E.pt_to_affine(E.pt_mul(k, E.pt_neg(keys[int(key_ids[lane])])))
        assert (x * zi % E.P, y * zi % E.P) == want
    with pytest.raises(IndexError):
        PR.comb_mul_keyed(table, torch.tensor([2], dtype=torch.int32),
                          wins[:, :1], window_bits)


def test_comb_mul_base8_matches_oracle():
    np.testing.assert_array_equal(PR.b_comb8(), JPR.b_comb8())
    rs = np.random.RandomState(SEED)
    scalars = [0, 1, E.L - 1, 2**256 - 1, int(rs.randint(0, 2**62)) << 150]
    s = _stack([v.to_bytes(32, "little") for v in scalars])
    out = PR.comb_mul_base8(torch.as_tensor(s))
    for lane, v in enumerate(scalars):
        x, y, z = (F.to_int(F.reduce_full(out[c][:, lane : lane + 1])) for c in range(3))
        zi = pow(z, E.P - 2, E.P)
        assert (x * zi % E.P, y * zi % E.P) == E.pt_to_affine(E.pt_mul(v, E.B_POINT))


def test_rotating_one_key_builds_one_page(monkeypatch):
    monkeypatch.setattr(PR, "KEY8_MAX", 4)  # 4-bit pages: a small build
    cache = PR.KeyTableCache("cpu")
    pubs = _pubs(6, b"rot-")
    e1 = cache.lookup_or_build(pubs)
    assert e1.window_bits == 4 and cache.stats["keys_built"] == 6
    assert cache.lookup_or_build(list(reversed(pubs))) is e1  # memoized
    rotated = pubs[1:] + _pubs(1, b"rot-new-")
    assert cache.peek(rotated) is None  # the new key is cold
    e2 = cache.lookup_or_build(rotated)
    assert cache.stats["keys_built"] == 7  # one new page
    # pages of keys kept across the rotation are untouched, and the
    # new key's page equals a fresh build of that key alone
    for p in pubs[1:]:
        s1, s2 = e1.key_index[p], e2.key_index[p]
        assert s1 == s2
        assert torch.equal(e1.table[..., s1 * 16 : s1 * 16 + 16],
                           e2.table[..., s2 * 16 : s2 * 16 + 16])
    new = rotated[-1]
    alone, _ = PR.build_tables_kernel(torch.as_tensor(_stack([new])), 4)
    s = e2.key_index[new]
    assert torch.equal(e2.table[..., s * 16 : s * 16 + 16], alone)
    assert cache.peek(rotated) is e2
    # slots follow the reference pool's order: highest free slot first
    assert sorted(e1.key_index.values()) == list(range(2, 8))


def test_pool_policy_matches_reference():
    assert PR.KEY8_MAX == JPR.KEY8_MAX and PR.TABLE_MAX_KEYS == JPR.TABLE_MAX_KEYS
    assert PR.TABLE_CACHE_MB == JPR.TABLE_CACHE_MB
    for n in (1, 2, 150, 1000, 4096, 4097, 10_000):
        assert PR._pool_cap(n) == JPR._pool_cap(n)
    assert PR.KeyTableCache("cpu").lookup_or_build([]) is None
