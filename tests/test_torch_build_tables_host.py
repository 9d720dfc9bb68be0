"""The table-build kernel source (csrc/build_tables.cu, with field.cuh
and point.cuh) compiled as plain C++ by g++ and run on the host, lane by
lane, each group's ranks simulated phase by phase, against its plain
PyTorch version ``build_tables_plain``: every limb of every entry and
the validity identical, at 4-bit windows (valid keys, one that does not
decode, one of small order) for every compiled shape (quarters, threads
per quarter) of each launch with the other at the launcher's choice,
each stage's jobs in order and last to first (``reverse``: a job that
reads a slot another job of its stage writes -- a race between quarters
on the card -- changes the limbs), and at 8-bit windows for one key.

This checks the kernel's arithmetic where there is no CUDA compiler; the
card run (chip_smoke.py) checks the same on the device."""

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
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR


@pytest.fixture(scope="module")
def hostlib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH: the host build of the kernel sources needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("build_host") / "libbuild_host.so")
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o", out,
         os.path.join(_build.CSRC, "build_tables.cu")],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    pi32 = ctypes.POINTER(ctypes.c_int)
    lib.build_tables_host.argtypes = [vp, i64, i32, vp, vp, vp, i32, i32, i32, i32, i32]
    lib.build_tables_host.restype = ctypes.c_int
    lib.build_tables_shape.argtypes = [i64, i32, pi32, pi32]
    lib.build_tables_shape.restype = ctypes.c_int
    return lib


def _shape(lib, n, launch):
    q, g = ctypes.c_int(), ctypes.c_int()
    assert lib.build_tables_shape(n, launch, ctypes.byref(q), ctypes.byref(g)) == 0
    return q.value, g.value


def _keys(window_bits: int) -> np.ndarray:
    """(32, n) uint8: two valid keys, one encoding that does not decode
    and a small-order point at 4-bit; one valid key at 8-bit."""
    valid = [ed.priv_key_from_secret(b"build-host-%d" % i).pub_key().bytes() for i in range(2)]
    if window_bits == 8:
        keys = valid[:1]
    else:
        bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
                   if E.decode_point(bytes([j]) + bytes(31)) is None)
        keys = valid + [bad, E.small_order_points()[2]]
    return np.stack([np.frombuffer(k, dtype=np.uint8) for k in keys], axis=-1)


@pytest.fixture(scope="module")
def plain():
    """The keys and the plain version's tables at a width, built once."""
    built = {}

    def get(window_bits):
        if window_bits not in built:
            pub = _keys(window_bits)
            table, valid = PR.build_tables_plain(torch.as_tensor(pub), window_bits)
            built[window_bits] = (pub, table.numpy(), valid.numpy())
        return built[window_bits]

    return get


def _host_build(lib, pub, window_bits, shapes, reverse=False):
    n = pub.shape[1]
    nwin, nent = 256 // window_bits, 1 << window_bits
    pub = np.ascontiguousarray(pub)
    bases = np.zeros((nwin, 4, F.NLIMBS, n), dtype=np.int32)
    table = np.full((nwin, 4, F.NLIMBS, n * nent), 0x5A5A5A5A, dtype=np.int32)
    valid = np.full(n, 7, dtype=np.uint8)
    rc = lib.build_tables_host(pub.ctypes.data, n, window_bits, bases.ctypes.data,
                               table.ctypes.data, valid.ctypes.data, *shapes[0], *shapes[1],
                               int(reverse))
    assert rc == 0
    return table, valid


PICK = (0, 0)
# 4-bit at every compiled shape of each launch, the other launch at the
# launcher's choice, in both orders; 8-bit (255 additions a window) at
# (4, 1) and at the choice
CASES = ([(4, (s, PICK), rev) for s in PR.BUILD_SHAPES for rev in (False, True)]
         + [(4, (PICK, s), rev) for s in PR.BUILD_SHAPES for rev in (False, True)]
         + [(8, ((4, 1), (4, 1)), False), (8, (PICK, PICK), False)])


def _case_id(case):
    wb, (sb, se), rev = case
    return (f"{wb}bit-bases{sb[0]}x{sb[1]}-entries{se[0]}x{se[1]}"
            + ("-reverse" if rev else ""))


@pytest.mark.parametrize("window_bits, shapes, reverse", CASES, ids=[_case_id(c) for c in CASES])
def test_host_build_matches_plain(hostlib, plain, window_bits, shapes, reverse):
    pub, want_table, want_valid = plain(window_bits)
    table, valid = _host_build(hostlib, pub, window_bits, shapes, reverse)
    assert valid.tolist() == want_valid.astype(np.uint8).tolist()
    np.testing.assert_array_equal(table, want_table)
    if window_bits == 4:
        assert valid.tolist() == [1, 1, 0, 1]


def test_host_group_choice_and_refusals(hostlib):
    """The launcher's shape per launch by lane count, and -1 for a shape
    or width that is not compiled."""
    # both launches by their own lane count: a warp per quarter up to 256
    # lanes, 8 threads up to 1024, then one
    sizes = (1, 150, 256, 257, 1024, 1025, 4800, 640000)
    want = [(4, 32)] * 3 + [(4, 8)] * 2 + [(4, 1)] * 3
    assert [_shape(hostlib, n, 1) for n in sizes] == want
    assert [_shape(hostlib, n, 2) for n in sizes] == want
    q, g = ctypes.c_int(), ctypes.c_int()
    assert hostlib.build_tables_shape(8, 3, ctypes.byref(q), ctypes.byref(g)) == -1
    pub = np.ascontiguousarray(_keys(4)[:, :1])
    bases = np.zeros((64, 4, F.NLIMBS, 1), dtype=np.int32)
    table = np.zeros((64, 4, F.NLIMBS, 16), dtype=np.int32)
    valid = np.zeros(1, dtype=np.uint8)
    args = (pub.ctypes.data, 1, 4, bases.ctypes.data, table.ctypes.data, valid.ctypes.data)
    assert hostlib.build_tables_host(*args, 2, 1, 4, 1, 0) == -1
    assert hostlib.build_tables_host(*args, 4, 1, 1, 16, 0) == -1
    assert hostlib.build_tables_host(*args, 0, 1, 0, 0, 0) == -1
    assert hostlib.build_tables_host(pub.ctypes.data, 1, 5, *args[3:], 4, 1, 4, 1, 0) == -1
