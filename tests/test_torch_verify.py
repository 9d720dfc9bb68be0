"""The port's keyed verify path (cometbft_tpu_torch/ops/ed25519_verify.py)
and its entry point ``create_batch_verifier(..., device="cpu")`` against
the JAX reference's keyed verifier and the big-int oracle.  Verdict
vectors must be identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cometbft_tpu.crypto import dispatch as jdispatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.ops import ed25519_verify as JEV
from cometbft_tpu.ops import precompute as JPR
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.crypto.batch import create_batch_verifier
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.ops import scalar as SC

SEED = 0xC0111


def _commit(nval: int, tag: bytes, lengths):
    """A ``nval``-validator commit with crafted invalid lanes; the oracle
    gives each lane's expected verdict."""
    rs = np.random.RandomState(SEED + nval)
    privs = [ed.priv_key_from_secret(tag + b"%d" % i) for i in range(nval)]
    triples = []
    for i, priv in enumerate(privs):
        msg = rs.randint(0, 256, int(lengths[i % len(lengths)])).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    s = triples[1][2]
    triples[1][2] = s[:40] + bytes([s[40] ^ 1]) + s[41:]             # flipped S
    s = triples[2][2]
    s_big = int.from_bytes(s[32:], "little") + E.L
    triples[2][2] = s[:32] + s_big.to_bytes(32, "little")           # S >= L
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    triples[3][2] = bad + triples[3][2][32:]                        # invalid R
    triples[4][2] = (E.P + 1).to_bytes(32, "little") + triples[4][2][32:]  # non-canonical R
    triples[5][0] = bad                                             # invalid A
    ident = E.encode_point(E.IDENTITY)
    triples[6][0] = E.small_order_points()[1]                       # small-order A,
    triples[6][2] = ident + bytes(32)                               # accepted
    triples[7][1] = triples[7][1] + b"!"                            # altered message
    expected = [E.verify_zip215(p, m, s) for p, m, s in triples]
    return triples, expected


@pytest.fixture(scope="module")
def commit16():
    # message lengths across the 128 and 256 buckets: the batch takes
    # bucket 256, its lanes absorb 1, 2 or 3 SHA-512 blocks
    triples, expected = _commit(16, b"verify16-", [120, 40, 130, 200, 250, 0, 64, 181])
    assert expected[6] and not any(expected[1:6]) and not expected[7]
    return triples, expected


@pytest.fixture(scope="module")
def reference(commit16):
    """The JAX keyed verifier on the same commit: its verdicts, its
    table entry and its raw keyed-kernel output."""
    triples, _ = commit16
    # isolation from earlier tests in this process: a fresh dispatch
    # ladder (no demoted tier) and an empty table cache
    jdispatch.reset_for_tests()
    JPR.TABLE_CACHE.clear()
    bv = JEV.TpuBatchVerifier(device_min_batch=0)
    for p, m, s in triples:
        bv.add(jed.Ed25519PubKey(p), m, s)
    plan = bv.plan()
    assert plan.entry is not None
    _, verdicts = bv.execute(plan)
    assert bv._last_tier == "keyed"
    return verdicts, plan.entry, plan.key_ids


def _verifier(triples, **kw):
    bv = EV.TorchBatchVerifier(device="cpu", **kw)
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    return bv


def test_commit_matches_reference_and_oracle(commit16, reference, monkeypatch):
    """The entry point on the CPU: with its tables warm, the 16-vote
    commit takes the keyed tier (the warm floor lowered to 8 lanes)."""
    triples, expected = commit16
    monkeypatch.setattr(EV, "DEVICE_MIN_BATCH", 8)
    PR.table_cache("cpu").lookup_or_build([p for p, _, _ in triples])
    bv = create_batch_verifier(ed.Ed25519PubKey(triples[0][0]), device="cpu")
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    ok, results = bv.verify()
    assert bv.last_tier == "keyed"
    assert results == expected == reference[0]
    assert ok is False


def test_port_kernel_on_reference_table(commit16, reference):
    """The port's keyed verify (verify_keyed_fused) on the JAX-built
    table gives the JAX kernel's verdict vector, padded lanes included; and the port
    builds the same pages for these keys."""
    triples, _ = commit16
    _, jentry, key_ids = reference
    table = np.asarray(jentry.table)
    entry = PR.tables_from_jax(table, jentry.valid, jentry.key_index,
                               jentry.window_bits, "cpu")
    assert entry.window_bits == 8
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    msgs = [m for _, m, _ in triples]
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=key_ids)
    jpacked, jbucket = JEV.pack_inputs(pub, sig, msgs, key_ids=key_ids)
    np.testing.assert_array_equal(packed, jpacked)
    assert bucket == jbucket == 256
    nblocks = EV.nblocks_for_bucket(bucket)
    want = np.asarray(JEV._compiled_keyed(bucket, 8, JEV.MAX_LAUNCH)(
        jnp.asarray(jpacked), jentry.table, jentry.valid_device()))
    rows = torch.as_tensor(packed)
    got = EV.verify_keyed_fused(
        rows, EV.keyed_digest(rows, bucket, nblocks), entry.table,
        entry.valid_device(), F.const(PR.b_comb8(), "cpu"), bucket, 8,
    )
    np.testing.assert_array_equal(got.numpy(), want)

    own = PR.table_cache("cpu").lookup_or_build([p for p, _, _ in triples])
    assert own.valid[[own.key_index[p] for p in jentry.key_index]].tolist() == (
        jentry.valid[[jentry.key_index[p] for p in jentry.key_index]].tolist()
    )
    for p, slot in jentry.key_index.items():
        mine = own.key_index[p]
        np.testing.assert_array_equal(
            own.table[..., mine * 256 : (mine + 1) * 256].numpy(),
            table[..., slot * 256 : (slot + 1) * 256],
        )


def test_bucket_128_commit_matches_oracle():
    triples, expected = _commit(12, b"verify12-", [120, 0, 7, 128])
    bv = _verifier(triples, device_min_batch=0)
    assert bv.plan().entry.window_bits == 8
    ok, results = bv.verify()
    assert results == expected and bv.last_tier == "keyed"


def test_chunk_loop(commit16, monkeypatch):
    """MAX_LAUNCH = 8 splits the 16-lane batch into two slices."""
    triples, expected = commit16
    monkeypatch.setattr(EV, "MAX_LAUNCH", 8)
    big = triples + [list(t) for t in triples[8:] + triples[:4]]
    bv = _verifier(big, device_min_batch=0)
    _, results = bv.verify()
    assert results == expected + expected[8:] + expected[:4]
    assert bv.last_tier == "keyed"


def test_routing(commit16, monkeypatch):
    triples, expected = commit16
    small = triples[:8]
    # below device_min_batch and DEVICE_MIN_BATCH: the oracle floor
    bv = _verifier(small)
    assert bv.verify()[1] == expected[:8] and bv.last_tier == "python"
    # between the two thresholds: keyed only when the tables are warm
    monkeypatch.setattr(EV, "DEVICE_MIN_BATCH", 4)
    cache = PR.KeyTableCache("cpu")
    bv = _verifier(small, device_min_batch=1000, cache=cache)
    assert bv.verify()[1] == expected[:8] and bv.last_tier == "python"
    cache.lookup_or_build([p for p, _, _ in small])
    bv = _verifier(small, device_min_batch=1000, cache=cache)
    plan = bv.plan()
    assert plan.reason == "keyed_warm"
    assert bv.execute(plan)[1] == expected[:8] and bv.last_tier == "keyed"
    # a message over the largest bucket takes the floor
    big = [list(t) for t in small]
    big[0][1] = bytes(4097)
    bv = _verifier(big, device_min_batch=0)
    assert bv.verify()[1][1:] == expected[1:8] and bv.last_tier == "python"
    # empty batch
    empty = EV.TorchBatchVerifier(device="cpu")
    assert empty.verify() == (False, []) and empty.last_tier is None


def test_add_rejects_bad_input():
    bv = EV.TorchBatchVerifier(device="cpu")
    with pytest.raises(ValueError):
        bv.add(ed.Ed25519PubKey(bytes(32)), b"m", bytes(63))

    class Other(ed.Ed25519PubKey):
        def type(self):
            return "secp256k1"

    with pytest.raises(TypeError):
        bv.add(Other(bytes(32)), b"m", bytes(64))
    with pytest.raises(KeyError):
        create_batch_verifier(Other(bytes(32)), device="cpu")
    with pytest.raises(ValueError):
        EV.pack_inputs(np.zeros((1, 32), np.uint8), np.zeros((1, 64), np.uint8),
                       [bytes(4097)])


def _packed(triples, entry):
    pubs = [p for p, _, _ in triples]
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    packed, bucket = EV.pack_inputs(pub, sig, [m for _, m, _ in triples],
                                    key_ids=entry.key_ids(pubs))
    return torch.as_tensor(packed), bucket


def test_fused_4bit_matches_reference(commit16, reference, monkeypatch):
    """verify_keyed_fused with the port's 4-bit pool gives the JAX
    verifier's verdicts (a verdict does not depend on the window width);
    the 8-bit case is test_port_kernel_on_reference_table."""
    triples, _ = commit16
    monkeypatch.setattr(PR, "KEY8_MAX", 8)
    entry = PR.KeyTableCache("cpu").lookup_or_build([p for p, _, _ in triples])
    assert entry.window_bits == 4
    rows, bucket = _packed(triples, entry)
    got = EV.verify_keyed_fused(
        rows, EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket)),
        entry.table, entry.valid_device(), F.const(PR.b_comb8(), "cpu"), bucket, 4,
    )
    assert got.tolist() == list(reference[0])


def test_fused_two_slices_on_reference_table(commit16, reference, monkeypatch):
    """MAX_LAUNCH = 8: verify_arrays_keyed calls verify_keyed_fused once
    per slice, on the JAX-built table, and returns the JAX verdicts."""
    triples, _ = commit16
    verdicts, jentry, key_ids = reference
    entry = PR.tables_from_jax(np.asarray(jentry.table), jentry.valid,
                               jentry.key_index, jentry.window_bits, "cpu")
    monkeypatch.setattr(EV, "MAX_LAUNCH", 8)
    calls = []
    fused = EV.verify_keyed_fused

    def counted(rows, *args, **kw):
        calls.append(rows.shape[1])
        return fused(rows, *args, **kw)

    monkeypatch.setattr(EV, "verify_keyed_fused", counted)
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    got = EV.verify_arrays_keyed(entry, key_ids, pub, sig, [m for _, m, _ in triples])
    assert calls == [8, 8]
    assert got.tolist() == list(verdicts)


def test_plain_q8_equals_prerefactor_composition(commit16):
    """verify_keyed_plain's [8]q and verdicts equal, limb for limb, the
    composition the keyed path ran before the fused kernel (and which
    the fused kernel's out_point is held to on the card)."""
    triples, expected = commit16
    entry = PR.table_cache("cpu").lookup_or_build([p for p, _, _ in triples])
    rows, bucket = _packed(triples, entry)
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    ok, q8 = EV.verify_keyed_plain(rows, digest, entry.table, entry.valid_device(),
                                   F.const(PR.b_comb8(), "cpu"), bucket, 8)
    key_ids = torch.as_tensor(entry.key_ids([p for p, _, _ in triples]))
    r_pt, r_ok = C.decompress(rows[32:64])
    s_bytes = rows[64:96]
    k_win = SC.limbs_to_windows8(SC.reduce_digest(digest))
    p1 = PR.comb_mul_base8(s_bytes)
    p2 = PR.comb_mul_keyed(entry.table, key_ids, k_win, 8)
    want = C.mul8(C.pt_add(C.pt_add(p1, p2), C.pt_neg(r_pt)))
    want_ok = (C.pt_is_identity(want) & r_ok & SC.bytes_lt_l(s_bytes)
               & entry.valid_device()[key_ids.long()])
    assert torch.equal(q8, torch.stack(want))
    assert ok.tolist() == want_ok.tolist() == expected
    out = torch.zeros_like(q8)
    again = EV.verify_keyed_fused(rows, digest, entry.table, entry.valid_device(),
                                  F.const(PR.b_comb8(), "cpu"), bucket, 8,
                                  out_point=out)
    assert again.tolist() == expected and torch.equal(out, q8)
