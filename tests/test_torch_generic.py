"""The port's generic tier (no comb tables) against the JAX reference and
the big-int oracle: ``verify_generic_plain`` and
``models.commit.commit_verify_step(device="cpu")`` against the JAX
``commit_verify_step``; ``comb_mul_base``, ``window_mul`` and ``B_COMB``
against ``cometbft_tpu.ops.curve`` limb for limb; and the routing that
sends a table-less set to the generic tier.  Exact: the arithmetic is
integer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cometbft_tpu.models import commit as JM
from cometbft_tpu.ops import curve as JC
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.models import commit as M
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.ops import scalar as SC

SEED = 0x6E0E


def _triples():
    """Eight votes by three keys, messages of 0-128 bytes (bucket 128):
    two valid, then flipped S, S >= L, undecodable R, non-canonical R,
    undecodable A, and a small-order A that the cofactored ZIP-215
    equation accepts."""
    rs = np.random.RandomState(SEED)
    privs = [ed.priv_key_from_secret(b"generic-%d" % i) for i in range(3)]
    triples = []
    for i in range(8):
        priv = privs[i % 3]
        msg = rs.randint(0, 256, int(rs.randint(0, 129))).astype(np.uint8).tobytes()
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


def _feature_first(triples):
    """(pub (32, n), sig (64, n), msg (128, n), msglen (n,)) numpy."""
    n = len(triples)
    msg = np.zeros((M.MSG_BUCKET, n), dtype=np.uint8)
    for j, (_, m, _) in enumerate(triples):
        msg[: len(m), j] = np.frombuffer(m, dtype=np.uint8)
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples], axis=1)
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples], axis=1)
    return pub, sig, msg, np.array([len(m) for _, m, _ in triples], dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def fresh_ladder():
    """The port's ladder starts this module fresh, and never reads a perf
    ledger a card run left in the checkout."""
    D.reset_for_tests()
    yield
    D.reset_for_tests()


@pytest.fixture(scope="module")
def lanes():
    triples, expected = _triples()
    return triples, expected, _feature_first(triples)


@pytest.fixture(scope="module")
def port_parts(lanes):
    """The port's inputs to the scalar multiplications: S's nibbles, k's
    nibbles (from the digest) and -A, as numpy."""
    _, _, (pub, sig, msg, msglen) = lanes
    packed, bucket = EV.pack_inputs(
        pub.T.copy(), sig.T.copy(), [bytes(msg[: msglen[j], j]) for j in range(len(msglen))])
    assert bucket == M.MSG_BUCKET
    rows = torch.as_tensor(packed)
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    k_nib = SC.limbs_to_nibbles(SC.reduce_digest(digest))
    s_nib = C.nibbles_from_bytes_le(rows[64:96])
    a_pt, _ = C.decompress(rows[:32])
    neg_a = C.pt_neg(a_pt)
    return dict(rows=rows, digest=digest, s_nib=s_nib.numpy(), k_nib=k_nib.numpy(),
                neg_a=tuple(c.contiguous().numpy() for c in neg_a))


@pytest.fixture(scope="module")
def reference(lanes, port_parts):
    """The JAX reference on the same lanes, compiled once per module: its
    ``commit_verify_step`` verdicts, then ``comb_mul_base``,
    ``window_mul`` and ``nibbles_from_bytes_le`` on the port's inputs (a
    second program: two compiles take less time than one of both)."""
    _, _, (pub, sig, msg, msglen) = lanes
    verdicts = jax.jit(JM.commit_verify_step)(
        jnp.asarray(pub), jnp.asarray(sig), jnp.asarray(msg), jnp.asarray(msglen))

    def parts(sig, s_nib, k_nib, neg_a):
        return (JC.comb_mul_base(s_nib), JC.window_mul(k_nib, neg_a),
                JC.nibbles_from_bytes_le(sig[32:]))

    p1, p2, nib = jax.device_get(jax.jit(parts)(
        jnp.asarray(sig), jnp.asarray(port_parts["s_nib"]), jnp.asarray(port_parts["k_nib"]),
        tuple(jnp.asarray(c) for c in port_parts["neg_a"])))
    return dict(verdicts=np.asarray(verdicts).tolist(), p1=np.stack(p1), p2=np.stack(p2),
                nib=np.asarray(nib))


def test_plain_and_step_equal_reference_and_oracle(lanes, port_parts, reference):
    """verify_generic_plain and commit_verify_step(device="cpu"), the
    latter on (2, 4) batch dims, give the JAX commit_verify_step's and
    the oracle's verdicts."""
    _, expected, (pub, sig, msg, msglen) = lanes
    assert reference["verdicts"] == expected
    ok, q8 = EV.verify_generic_plain(port_parts["rows"], port_parts["digest"])
    assert ok.tolist() == expected
    assert q8.shape == (4, 26, 8) and q8.dtype == torch.int32
    step = M.commit_verify_step(pub.reshape(32, 2, 4), sig.reshape(64, 2, 4),
                                msg.reshape(128, 2, 4), msglen.reshape(2, 4), device="cpu")
    assert step.shape == (2, 4) and step.dtype == torch.bool
    assert step.reshape(8).tolist() == expected


def test_comb_and_window_mul_equal_reference(port_parts, reference):
    """comb_mul_base, window_mul and nibbles_from_bytes_le give the JAX
    functions' limbs on the same inputs."""
    s_nib = torch.as_tensor(port_parts["s_nib"])
    k_nib = torch.as_tensor(port_parts["k_nib"])
    neg_a = tuple(torch.as_tensor(c) for c in port_parts["neg_a"])
    np.testing.assert_array_equal(s_nib.numpy(), reference["nib"])
    p1 = torch.stack(C.comb_mul_base(s_nib)).numpy()
    np.testing.assert_array_equal(p1, reference["p1"])
    p2 = torch.stack(C.window_mul(k_nib, neg_a)).numpy()
    np.testing.assert_array_equal(p2, reference["p2"])


def test_b_comb_equals_reference():
    assert C.B_COMB.shape == (64, 16, 3, 26) and C.B_COMB.dtype == np.int32
    np.testing.assert_array_equal(C.B_COMB, np.asarray(JC.B_COMB))


def test_example_inputs_are_seeded_and_flag_invalid_lanes():
    invalid = np.array([[False, True, False], [False, False, True]])
    pub, sig, msg, msglen = M.example_inputs((2, 3), seed=11, invalid=invalid)
    again = M.example_inputs((2, 3), seed=11, invalid=invalid)
    for a, b in zip((pub, sig, msg, msglen), again):
        np.testing.assert_array_equal(a, b)
    assert pub.shape == (32, 2, 3) and msg.shape == (128, 2, 3) and msglen.shape == (2, 3)
    for h in range(2):
        for v in range(3):
            ok = E.verify_zip215(bytes(pub[:, h, v]), bytes(msg[: msglen[h, v], h, v]),
                                 bytes(sig[:, h, v]))
            assert ok == (not invalid[h, v])


def test_wrappers_refuse_what_they_cannot_run(lanes):
    _, _, (pub, sig, msg, msglen) = lanes
    with pytest.raises(ValueError):
        M.commit_verify_step(pub, sig[:, :4], msg, msglen, device="cpu")
    bucket = M.MSG_BUCKET
    with pytest.raises(ValueError, match="unsupported device"):
        EV.verify_generic_fused(torch.zeros((100 + bucket, 8), dtype=torch.uint8, device="meta"),
                                torch.zeros((64, 8), dtype=torch.uint8, device="meta"), bucket)
    with pytest.raises(ValueError):
        EV.verify_generic_fused(torch.zeros((104 + bucket, 8), dtype=torch.uint8),
                                torch.zeros((64, 8), dtype=torch.uint8), bucket)
    with pytest.raises(ValueError):
        EV.verify_generic_fused(torch.zeros((100 + bucket, 8), dtype=torch.uint8),
                                torch.zeros((64, 8), dtype=torch.uint8), bucket, shape=(4, 4))


# -- routing -------------------------------------------------------------

def _verifier(triples, **kw):
    bv = EV.TorchBatchVerifier(device="cpu", **kw)
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    return bv


def test_set_over_table_max_keys_takes_generic(lanes, monkeypatch):
    """Five unique keys over a TABLE_MAX_KEYS of 4: no table is built and
    the batch runs on the generic tier, in two MAX_LAUNCH slices of 8."""
    triples, expected, _ = lanes
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 4)
    monkeypatch.setattr(EV, "MAX_LAUNCH", 8)
    calls = []
    fused = EV.verify_generic_fused

    def counted(rows, *args, **kw):
        calls.append(rows.shape[1])
        return fused(rows, *args, **kw)

    monkeypatch.setattr(EV, "verify_generic_fused", counted)
    both = triples + [list(t) for t in triples[4:] + triples[:4]]
    assert len({p for p, _, _ in both}) == 5
    cache = PR.KeyTableCache("cpu")
    bv = _verifier(both, device_min_batch=0, cache=cache)
    plan = bv.plan()
    assert plan.route == "device" and plan.tiers[0] == "generic" and plan.entry is None
    ok, results = bv.execute(plan)
    assert bv.last_tier == "generic" and calls == [8, 8]
    assert results == expected + expected[4:] + expected[:4] and ok is False
    assert cache.stats["keys_built"] == 0


@pytest.fixture(scope="module")
def warm_cache(lanes):
    """A table cache that holds the lanes' keys."""
    cache = PR.KeyTableCache("cpu")
    cache.lookup_or_build([p for p, _, _ in lanes[0]])
    return cache


def test_disable_precompute_takes_generic(lanes, warm_cache, monkeypatch):
    """A TABLE_MAX_KEYS of 0 turns precomputation off: any set takes the
    generic tier, cold or warm, and builds nothing; the limit is read at
    plan time, so restoring it brings the warm set back to keyed."""
    triples, expected, _ = lanes
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 0)
    cold = PR.KeyTableCache("cpu")
    bv = _verifier(triples, device_min_batch=0, cache=cold)
    ok, results = bv.verify()
    assert bv.last_tier == "generic" and results == expected and ok is False
    assert cold.stats["keys_built"] == 0
    built = warm_cache.stats["keys_built"]
    plan = _verifier(triples, device_min_batch=0, cache=warm_cache).plan()
    assert plan.tiers[0] == "generic" and plan.entry is None
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 16384)
    assert _verifier(triples, device_min_batch=0, cache=warm_cache).plan().tiers[0] == "keyed"
    assert warm_cache.stats["keys_built"] == built


def test_routes_that_stay(lanes, warm_cache, monkeypatch):
    """A warm set keeps the keyed tier; below DEVICE_MIN_BATCH, and with
    a message over 4096 bytes, the batch takes the host tier even when
    it has no table entry."""
    triples, expected, _ = lanes
    bv = _verifier(triples, device_min_batch=0, cache=warm_cache)
    assert bv.verify()[1] == expected and bv.last_tier == "keyed"
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 0)
    bv = _verifier(triples, device_min_batch=64, cache=warm_cache)   # 8 lanes < 64
    assert bv.verify()[1] == expected and bv.last_tier == "host"
    big = [list(t) for t in triples]
    big[0][1] = bytes(4097)
    bv = _verifier(big, device_min_batch=0, cache=warm_cache)
    plan = bv.plan()
    assert plan.reason == "msg_too_large"
    assert bv.execute(plan)[1][1:] == expected[1:] and bv.last_tier == "host"
