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
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR
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


@pytest.mark.parametrize("group", (0,) + EV.GROUPS)
@pytest.mark.parametrize("window_bits", [8, 4])
def test_verify_keyed_equals_plain(dev, window_bits, group, monkeypatch):
    """The fused keyed verify against its plain version on the card, at
    every compiled group size and the launcher's choice (0): verdicts
    and the limbs of [8]q on every lane, planted invalid lanes (flipped
    S, S >= L, undecodable R, undecodable A) included."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import edwards as E
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
                               b_table, bucket, window_bits, out_point=q8, group=group)
    assert _build.LAUNCHES["verify_keyed"] == before + 1
    torch.cuda.synchronize()
    want_ok, want_q8 = EV.verify_keyed_plain(rows, digest, entry.table,
                                             entry.valid_device(), b_table, bucket,
                                             window_bits)
    assert torch.equal(ok, want_ok)
    assert torch.equal(q8, want_q8)
    assert ok.tolist() == expected


@pytest.mark.parametrize("offset", [8, 5])
def test_sha512_keyed_equals_plain(dev, offset):
    """sha512_keyed on packed rows (a slice of a wider buffer, so the
    row stride is not the lane count; at offset 5 the rows' bytes are
    not 4-byte aligned) against keyed_digest's plain route and hashlib,
    message lengths on both sides of each block edge."""
    rs = np.random.RandomState(SEED + 5)
    lens = [0, 46, 47, 48, 110, 111, 112, 175, 176, 256] * 4
    n = len(lens)
    pub = rs.randint(0, 256, (n, 32)).astype(np.uint8)
    sig = rs.randint(0, 256, (n, 64)).astype(np.uint8)
    msgs = [rs.randint(0, 256, ln).astype(np.uint8).tobytes() for ln in lens]
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=np.arange(n))
    nblocks = EV.nblocks_for_bucket(bucket)
    rows = torch.as_tensor(packed).to(dev)[:, offset:]
    before = _build.LAUNCHES["sha512_keyed"]
    got = EV.keyed_digest(rows, bucket, nblocks)
    assert _build.LAUNCHES["sha512_keyed"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, EV.keyed_digest_plain(rows, bucket, nblocks))
    host = got.cpu().numpy()
    for j in range(n - offset):
        i = j + offset
        want = hashlib.sha512(bytes(sig[i, :32]) + bytes(pub[i]) + msgs[i]).digest()
        assert bytes(host[:, j]) == want


@pytest.mark.parametrize("shape", (None,) + EV.VG_SHAPES,
                         ids=lambda s: "0" if s is None else f"{s[0]}x{s[1]}")
def test_verify_generic_equals_plain(dev, shape):
    """The generic verify (no tables) against its plain version on the
    card, at every compiled launch shape and the launcher's choice:
    verdicts and the limbs of [8]q on every lane of a slice read through
    its row stride, planted invalid lanes (flipped S, S >= L, undecodable
    and non-canonical R, undecodable A, small-order A) included."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import edwards as E

    rs = np.random.RandomState(SEED + 9)
    triples = []
    for i in range(24):
        priv = ed.priv_key_from_secret(b"gpu-generic-%d" % (i % 5))
        msg = rs.randint(0, 256, int(rs.randint(0, 129))).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    s = triples[9][2]
    triples[9][2] = s[:40] + bytes([s[40] ^ 1]) + s[41:]
    s = triples[10][2]
    triples[10][2] = s[:32] + (int.from_bytes(s[32:], "little") + E.L).to_bytes(32, "little")
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    triples[11][2] = bad + triples[11][2][32:]
    triples[12][2] = (E.P + 1).to_bytes(32, "little") + triples[12][2][32:]
    triples[13][0] = bad
    triples[14][0] = E.small_order_points()[1]
    triples[14][2] = E.encode_point(E.IDENTITY) + bytes(32)
    expected = [E.verify_zip215(p, m, s) for p, m, s in triples]
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    packed, bucket = EV.pack_inputs(pub, sig, [m for _, m, _ in triples])
    rows = torch.as_tensor(packed).to(dev)[:, 8:24]
    digest = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket))
    before = _build.LAUNCHES["verify_generic"]
    ok, q8 = EV.verify_generic_fused(rows, digest, bucket, shape=shape, want_q=True)
    assert _build.LAUNCHES["verify_generic"] == before + 1
    torch.cuda.synchronize()
    want_ok, want_q8 = EV.verify_generic_plain(rows, digest)
    assert torch.equal(ok, want_ok)
    assert torch.equal(q8, want_q8)
    assert ok.tolist() == expected[8:24]


def _build_keys(n_valid: int, tag: bytes) -> np.ndarray:
    """(32, n) uint8 keys: ``n_valid`` valid ones, then one encoding that
    does not decode and one small-order point."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import edwards as E

    keys = [ed.priv_key_from_secret(tag + b"%d" % i).pub_key().bytes() for i in range(n_valid)]
    keys.append(next(bytes([j]) + bytes(31) for j in range(2, 255)
                     if E.decode_point(bytes([j]) + bytes(31)) is None))
    keys.append(E.small_order_points()[2])
    return np.stack([np.frombuffer(k, dtype=np.uint8) for k in keys], axis=-1)


# each launch at every compiled shape with the other at the launcher's
# choice, and both at the choice
_PICK = (0, 0)
_BUILD_PAIRS = ([(_PICK, _PICK)] + [(s, _PICK) for s in PR.BUILD_SHAPES]
                + [(_PICK, s) for s in PR.BUILD_SHAPES])


@pytest.mark.parametrize("shapes", _BUILD_PAIRS,
                         ids=lambda p: f"{p[0][0]}x{p[0][1]}-{p[1][0]}x{p[1][1]}")
@pytest.mark.parametrize("window_bits", [8, 4])
def test_build_tables_equals_plain(dev, window_bits, shapes):
    """The table build against build_tables_plain on the card, every limb
    and the validity, invalid and small-order keys included, at each
    launch shape; one counted launch per call."""
    pub = torch.as_tensor(_build_keys(3 if window_bits == 8 else 13, b"gpu-build-")).to(dev)
    before = _build.LAUNCHES["build_tables"]
    table, valid = PR.build_tables_kernel(pub, window_bits, shapes=shapes)
    assert _build.LAUNCHES["build_tables"] == before + 1
    torch.cuda.synchronize()
    want_table, want_valid = PR.build_tables_plain(pub, window_bits)
    assert torch.equal(valid, want_valid)
    assert valid.tolist()[-2:] == [False, True]
    assert torch.equal(table, want_table)


def test_key_pool_rotation_on_the_card(dev):
    """A one-key rotation through the pool on the card builds one page
    with one build_tables launch, and the entry taken before it keeps
    its pages."""
    from cometbft_tpu_torch.ops import precompute as PR

    keys = [bytes(c) for c in _build_keys(6, b"gpu-pool-").T[:6]]
    cache = PR.KeyTableCache(dev)
    e1 = cache.lookup_or_build(keys[:5])
    before = e1.table.clone()
    n0 = _build.LAUNCHES["build_tables"]
    e2 = cache.lookup_or_build(keys[1:6])
    assert _build.LAUNCHES["build_tables"] == n0 + 1
    assert cache.stats == {"keys_built": 6, "keys_evicted": 0}
    s = e2.key_index[keys[5]]
    alone, _ = PR.build_tables_kernel(torch.as_tensor(_build_keys(6, b"gpu-pool-")[:, 5:6]).to(dev),
                                      8)
    torch.cuda.synchronize()
    assert torch.equal(e2.table[..., s * 256 : (s + 1) * 256], alone)
    for k in keys[:5]:
        s1 = e1.key_index[k]
        assert torch.equal(e1.table[..., s1 * 256 : (s1 + 1) * 256],
                           before[..., s1 * 256 : (s1 + 1) * 256])


def _stream_jobs(njobs: int, nval: int, tag: bytes):
    """``njobs`` jobs of ``nval`` votes, the same keys, one altered
    message per job at a job-dependent lane -> (jobs, oracle verdicts)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    privs = [ed.priv_key_from_secret(tag + b"%d" % i) for i in range(nval)]
    pubs = [p.pub_key().bytes() for p in privs]
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs])
    jobs, want = [], []
    for j in range(njobs):
        msgs = [b"stream job %d vote %d" % (j, i) for i in range(nval)]
        sig = np.stack([np.frombuffer(p.sign(m), dtype=np.uint8) for p, m in zip(privs, msgs)])
        bad = (7 * j) % nval
        msgs[bad] += b"!"
        jobs.append((pub, sig, msgs))
        want.append([i != bad for i in range(nval)])
    return pubs, jobs, want


@pytest.mark.parametrize("max_in_flight", [1, 3, 8])
def test_verify_stream_equals_sync_on_the_card(dev, max_in_flight):
    """verify_stream through the keyed closure and the generic default
    gives, job by job, the verdicts of the synchronous path and the
    oracle; the synchronous path is _finish of the async one."""
    from cometbft_tpu_torch.ops import precompute as PR

    pubs, jobs, want = _stream_jobs(5, 40, b"gpu-stream-")
    entry = PR.KeyTableCache(dev).lookup_or_build(pubs)
    key_ids = entry.key_ids(pubs)
    keyed = list(EV.verify_stream(
        iter(jobs), max_in_flight=max_in_flight,
        dispatch=lambda pub, sig, msgs: EV.verify_arrays_keyed_async(entry, key_ids, pub, sig,
                                                                     msgs)))
    generic = list(EV.verify_stream(iter(jobs), max_in_flight=max_in_flight, device=dev))
    sync_keyed = [EV.verify_arrays_keyed(entry, key_ids, *job) for job in jobs]
    sync_generic = [EV.verify_arrays(*job, dev) for job in jobs]
    for got in (keyed, generic, sync_keyed, sync_generic):
        assert [g.tolist() for g in got] == want


def test_async_parts_stay_on_the_card(dev):
    """The async entries return verdicts on the card without waiting;
    their packed rows were staged in pinned memory."""
    from cometbft_tpu_torch.ops import precompute as PR

    pubs, jobs, want = _stream_jobs(1, 12, b"gpu-async-")
    entry = PR.KeyTableCache(dev).lookup_or_build(pubs)
    parts = EV.verify_arrays_keyed_async(entry, entry.key_ids(pubs), *jobs[0])
    assert len(parts) == 1 and parts[0][0].is_cuda and parts[0][1] == 12
    assert EV._finish(parts).tolist() == want[0]
    parts = EV.verify_arrays_async(*jobs[0], dev)
    assert parts[0][0].is_cuda and EV._finish(parts).tolist() == want[0]


def test_unpipelined_parts_fetch_on_the_compute_stream(dev):
    """The synchronous entries' body: rows staged in pageable memory, no
    ready event, the fetch on the compute stream; either fetch of such
    parts gives the oracle's verdicts."""
    from cometbft_tpu_torch.ops import precompute as PR

    pubs, jobs, want = _stream_jobs(2, 12, b"gpu-unpiped-")
    entry = PR.KeyTableCache(dev).lookup_or_build(pubs)
    parts = EV.verify_arrays_keyed_async(entry, entry.key_ids(pubs), *jobs[0], pipelined=False)
    assert parts[0][0].is_cuda and not hasattr(parts[0][0], "_ready")
    assert EV._finish(parts, pipelined=False).tolist() == want[0]
    parts = EV.verify_arrays_async(*jobs[1], dev, pipelined=False)
    assert EV._finish(parts).tolist() == want[1]


def _precommit_set(nval: int, tag: bytes, chain_id: str):
    """A ``nval``-validator set of power 10 each and its precommits for
    one block, each with its own timestamp, signed by the oracle over
    its canonical sign bytes -> (set, block id, votes, their Commit)."""
    from dataclasses import replace

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import (PRECOMMIT_TYPE, BlockID, Commit, PartSetHeader,
                                          Validator, ValidatorSet, Vote)

    privs = [ed.priv_key_from_secret(tag + b"-%d" % i) for i in range(nval)]
    vals = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    h = hashlib.sha256(tag).digest()
    bid = BlockID(hash=h, part_set_header=PartSetHeader(total=1, hash=h[::-1]))
    rs = np.random.RandomState(SEED + nval)
    votes = []
    for i, v in enumerate(vals.validators):
        vote = Vote(type=PRECOMMIT_TYPE, height=1, round=0, block_id=bid,
                    timestamp_ns=1_760_000_000_000_000_000 + int(rs.randint(0, 10**9)),
                    validator_address=v.address, validator_index=i)
        votes.append(replace(vote, signature=by_addr[v.address].sign(vote.sign_bytes(chain_id))))
    commit = Commit(height=1, round=0, block_id=bid,
                    signatures=tuple(v.commit_sig() for v in votes))
    return vals, bid, votes, commit


def test_verify_commit_on_the_card(dev, monkeypatch):
    """types.validation.verify_commit on a 150-validator commit, on a
    fresh table cache: cold it launches build_tables, sha512_keyed and
    verify_keyed once each, warm sha512_keyed and verify_keyed once; an
    altered signature is named.  After the same precommits went through
    VoteSet.add_vote with a VerifyQueue installed, verify_commit on
    make_commit() is all speculative-cache hits and launches nothing."""
    from dataclasses import replace

    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, VoteSet
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.utils.flight import FLIGHT

    chain = "gpu-chain"
    monkeypatch.setattr(PR, "_caches", {})
    vals, bid, votes, commit = _precommit_set(150, b"gpu-commit", chain)

    def launches():
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    _build.reset_launches()
    V.verify_commit(chain, vals, bid, 1, commit)          # no device: cuda
    assert launches() == {"build_tables": 1, "sha512_keyed": 1, "verify_keyed": 1}
    for _ in range(3):
        _build.reset_launches()
        V.verify_commit(chain, vals, bid, 1, commit, device=dev)
        assert launches() == {"sha512_keyed": 1, "verify_keyed": 1}
    sigs = list(commit.signatures)
    s = sigs[9].signature
    sigs[9] = replace(sigs[9], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    with pytest.raises(V.InvalidCommitSignatures, match=r"wrong signature \(#9\)"):
        V.verify_commit(chain, vals, bid, 1, replace(commit, signatures=tuple(sigs)), device=dev)
    q = VQ.VerifyQueue()
    q.start()
    VQ.install_queue(q)
    try:
        vs = VoteSet(chain, 1, 0, PRECOMMIT_TYPE, vals)
        assert all(vs.add_vote(v) for v in votes)
        made = vs.make_commit()
        assert made == commit
        _build.reset_launches()
        V.verify_commit(chain, vals, bid, 1, made, device=dev)
        assert launches() == {}
        rec = [e for e in FLIGHT.tail(8) if e["kind"] == "consensus/speculative_verify"][-1]
        assert (rec["hits"], rec["misses"], rec["tier"]) == (150, 0, "speculative")
    finally:
        q.stop()
    assert VQ._QUEUE is None


def test_cost_sample_is_the_kernels_time_on_the_card(dev, monkeypatch):
    """A warm keyed verify of a 150-validator commit whose packing is
    held up 0.1 s: the cost model's sample is the kernels' device time
    from the launchers' events (sha512_keyed and verify_keyed, under 10
    ms), not the batch's wall."""
    import time

    from cometbft_tpu_torch.crypto import dispatch as D

    monkeypatch.setattr(PR, "_caches", {})
    vals, _, votes, _ = _precommit_set(150, b"gpu-sample", "gpu-chain")

    def verify():
        bv = EV.TorchBatchVerifier(device=dev)
        for v in votes:
            bv.add(vals.get_by_index(v.validator_index).pub_key, v.sign_bytes("gpu-chain"),
                   v.signature)
        ok, _ = bv.verify()
        assert ok and bv.last_tier == "keyed"

    verify()                       # cold: the tables' build, no sample
    D.reset_for_tests()
    pack = EV.pack_inputs

    def slow_pack(*args, **kwargs):
        time.sleep(0.1)
        return pack(*args, **kwargs)

    monkeypatch.setattr(EV, "pack_inputs", slow_pack)
    try:
        t0 = time.perf_counter()
        verify()
        wall = time.perf_counter() - t0
        [row] = [r for r in D.LADDER.cost_snapshot()["table"] if r["tier"] == "keyed"]
    finally:
        D.reset_for_tests()
    assert wall >= 0.1 and row["samples"] == 1
    assert 150 / row["sigs_per_sec"] < 0.01


def test_blocksync_on_the_card(dev, monkeypatch):
    """chip_smoke's blocksync phase at a small size: a 24-height chain of
    128 validators (a light verify sends 86 signatures, over the device
    threshold of 64) served over 127.0.0.1 TCP by a byzantine and an
    honest node, synced twice (cold with prefetch, warm without) on the
    card.  The
    phase checks the synced stores, app and handed-over state against
    the source's, the one stop, no pool-routine error, the launches of
    build_tables, sha512_keyed and verify_keyed, and verify_keyed at a
    prefetch batch's shape against its plain version; then statesync: a
    fresh node restores the chain from the source app's snapshot at 18
    and blocksyncs the last 6 heights."""
    import chip_smoke
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.utils.metrics import Registry

    registry = Registry()
    monkeypatch.setattr(M, "_CRYPTO", M.CryptoMetrics(registry))
    monkeypatch.setattr(M, "_HEALTH", M.HealthMetrics(registry))
    D.reset_for_tests()           # the static order: no estimate from another test
    try:
        res = chip_smoke.blocksync_phase(dev, "gpu test", registry, heights=24, nval=128,
                                         every=10, bad=10, nsigners=2, timeout_s=120)
        chip_smoke.check_ladder("blocksync on the card")
    finally:
        D.reset_for_tests()
    assert res["a"]["launches"]["build_tables"] >= 1
    assert res["prefetch_check"]["err"] == 0
    assert res["s"]["snapshot"] == 18 and res["s"]["backfilled"] == 6
    assert res["s"]["restore_launches"]["verify_keyed"] >= 1


def test_mesh_on_repeated_shards_equals_keyed(dev, monkeypatch):
    """The keyed and generic mesh on four shards of cuda:0 give the
    single-device tiers' verdicts, planted invalids included; each shard
    with lanes launches sha512_keyed and its verify once."""
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.parallel import mesh as MM

    D.reset_for_tests()
    monkeypatch.setattr(PR, "_caches", {})
    mesh = MM.flat_mesh(["cuda:0"] * 4)
    privs = [ed.priv_key_from_secret(b"gpu-mesh-%d" % i) for i in range(40)]
    triples = []
    for i in range(150):
        p, m = privs[i % 40], b"gpu mesh vote %d" % i
        s = p.sign(m)
        if i % 17 == 3:
            s = s[:40] + bytes([s[40] ^ 1]) + s[41:]
        triples.append((p, m, s))

    def verify(bv):
        for p, m, s in triples:
            bv.add(p.pub_key(), m, s)
        return bv.verify()[1]

    single = EV.TorchBatchVerifier(device=dev)
    want = verify(single)
    assert single.last_tier == "keyed" and want.count(False) == 9
    for limit, tier in ((PR.TABLE_MAX_KEYS, "keyed_mesh"), (0, "generic_mesh")):
        monkeypatch.setattr(PR, "TABLE_MAX_KEYS", limit)
        bv = MM.ShardedTorchBatchVerifier(mesh=mesh)
        _build.reset_launches()
        assert verify(bv) == want and bv.last_tier == tier
        kernel = "verify_keyed" if tier == "keyed_mesh" else "verify_generic"
        shards = sum(1 for s in bv.last_shards if s["lanes"])
        assert _build.LAUNCHES["sha512_keyed"] == _build.LAUNCHES[kernel] == shards
    D.reset_for_tests()


def test_sharded_verify_fn_on_repeated_shards(dev):
    """sharded_verify_fn over a (2, 2) mesh of cuda:0 shards: the
    planted invalid lanes, and only they, come back false; each block
    launches sha512_keyed and verify_generic once."""
    from cometbft_tpu_torch.models.commit import example_inputs
    from cometbft_tpu_torch.parallel import mesh as MM

    mesh = MM.make_mesh(["cuda:0"] * 4, shape=(2, 2))
    ii, jj = np.meshgrid(np.arange(4), np.arange(8), indexing="ij")
    invalid = (ii + 2 * jj) % 3 == 0
    pub, sig, msg, msglen = example_inputs(shape=(4, 8), msglen=90, invalid=invalid)
    _build.reset_launches()
    out = MM.sharded_verify_fn(mesh, nblocks=2)(pub, sig, msg, msglen)
    assert _build.LAUNCHES["sha512_keyed"] == _build.LAUNCHES["verify_generic"] == 4
    assert np.array_equal(out.numpy(), ~invalid)
    assert MM.all_valid(out) is False


def test_transfer_window_trips_on_a_planted_sync(dev, monkeypatch):
    """Armed and sealed, the window turns an implicit sync (``.item()``)
    into an error and counts one transfer trip; a verify's own copies
    are audited and pass; the mode is off again after the window."""
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import jitguard
    from cometbft_tpu_torch.utils.metrics import Registry

    cm = M.CryptoMetrics(Registry())
    M.install_crypto_metrics(cm)
    priv = ed.priv_key_from_secret(b"gpu-guard")

    def verify():
        bv = EV.TorchBatchVerifier(device=dev)
        for i in range(80):
            bv.add(priv.pub_key(), b"guard %d" % i, priv.sign(b"guard %d" % i))
        return bv.verify()

    jitguard.enable()
    jitguard.reset()
    try:
        assert verify()[0]
        jitguard.seal()
        with pytest.raises(RuntimeError, match="synchronizing"):
            with jitguard.transfer_window():
                assert verify()[0]
                torch.ones(1, device=dev).sum().item()
        assert cm.guard_trips.labels(kind="transfer").get() == 1.0
        assert torch.cuda.get_sync_debug_mode() == 0
        assert torch.ones(1, device=dev).sum().item() == 1.0
    finally:
        jitguard.reset()
        jitguard.enable(False)
        M.install_crypto_metrics(None)


def test_consensus_stub_run_on_the_card(dev):
    """chip_smoke's commit-N-consensus run at 1 + 3 validators on the
    card, without a queue and then with one: 2 heights each, every
    commit with at least 3 signatures (3 signatures a commit are below
    the device threshold: the host tier verifies them)."""
    import chip_smoke
    from cometbft_tpu_torch import config as C
    from cometbft_tpu_torch.utils.metrics import Registry

    for queue in (False, True):
        r = chip_smoke.cs_stub_run(dev, f"stubs on the card (queue {queue})", Registry(), 3, 2,
                                   queue, config=C.test_config(), timeout_s=120)
        assert [row["height"] for row in r["per_height"]] == [1, 2]
        assert all(row["sigs"] >= 3 for row in r["per_height"])
