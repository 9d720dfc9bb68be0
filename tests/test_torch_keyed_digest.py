"""The keyed path's digest on the CPU: ``keyed_digest`` (the plain route
of the sha512_keyed kernel) on packed rows equals hashlib's
SHA-512(R || A || M) per lane, message lengths on both sides of every
block edge; and the keyed wrappers refuse arguments their kernels do not
take."""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F

SEED = 0x5E4

# R || A is 64 bytes and the padding at least 17: 47 is the longest
# one-block message, 175 the longest of two, 4096 the largest bucket
LENGTHS = [0, 1, 46, 47, 48, 111, 112, 175, 176, 255, 256, 300, 4096]


def _rows(lengths, seed):
    rs = np.random.RandomState(seed)
    n = len(lengths)
    pub = rs.randint(0, 256, (n, 32)).astype(np.uint8)
    sig = rs.randint(0, 256, (n, 64)).astype(np.uint8)
    msgs = [rs.randint(0, 256, ln).astype(np.uint8).tobytes() for ln in lengths]
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=np.arange(n))
    return packed, bucket, pub, sig, msgs


@pytest.mark.parametrize("lengths", [LENGTHS[:9], LENGTHS], ids=["bucket256", "bucket4096"])
def test_keyed_digest_equals_hashlib(lengths):
    packed, bucket, pub, sig, msgs = _rows(lengths, SEED + len(lengths))
    rows = torch.as_tensor(packed)
    got = EV.keyed_digest(rows, bucket, EV.nblocks_for_bucket(bucket)).numpy()
    assert got.shape == (64, packed.shape[1])
    for j, m in enumerate(msgs):
        want = hashlib.sha512(bytes(sig[j, :32]) + bytes(pub[j]) + m).digest()
        assert bytes(got[:, j]) == want, f"lane {j}, message of {len(m)} bytes"


def test_keyed_wrappers_refuse_bad_arguments():
    packed, bucket, *_ = _rows([5, 9], SEED)
    rows = torch.as_tensor(packed)
    nblocks = EV.nblocks_for_bucket(bucket)
    with pytest.raises(ValueError):
        EV.keyed_digest(rows, bucket, nblocks + 1)
    with pytest.raises(ValueError):
        EV.keyed_digest(rows[1:], bucket, nblocks)
    with pytest.raises(ValueError):
        EV.keyed_digest(rows.to(torch.int32), bucket, nblocks)
    with pytest.raises(ValueError):
        EV.keyed_digest(rows.to("meta"), bucket, nblocks)
    digest = EV.keyed_digest(rows, bucket, nblocks)
    table = torch.zeros((32, 4, F.NLIMBS, 256), dtype=F.DTYPE)
    valid = torch.zeros(1, dtype=torch.bool)
    b_table = torch.zeros((32, 3, F.NLIMBS, 256), dtype=F.DTYPE)
    with pytest.raises(ValueError):
        EV.verify_keyed_fused(rows, digest, table, valid, b_table, bucket, 8, group=4)
