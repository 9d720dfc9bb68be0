#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. the device: torch's name and count, nvidia-smi's name and power limit;
2. build: nvcc of every kernel source in cometbft_tpu_torch/csrc, in
   parallel, with ptxas's register and spill report;
3. every kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality: the arithmetic is integer), with
   its time per launch beside the plain version's: device time from
   torch.profiler, and the back-to-back rate from CUDA events (which
   the host's enqueue cost bounds at these sizes);
4. the main path: keyed commit verification of a 150-validator commit
   through ``create_batch_verifier(...).verify()`` on ``cuda``, with
   planted invalid lanes whose verdicts the big-int oracle decides;
   every kernel's launch count must rise during that cold verify (the
   field kernels build the tables), and a warm verify must launch
   verify_keyed and sha512_padded once per slice and no field kernel;
   then one warm verify under torch.profiler for the device's busy
   share;
5. the same for a 1024-validator commit (the 4-bit comb tables);
6. a batch of more than 8192 lanes, through the MAX_LAUNCH slicing,
   with a profiled warm verify too;
   after each of phases 4-6 the fused verify_keyed kernel is held
   against its plain version on the same batch, slice by slice: the
   verdicts and the limbs of [8]q, exactly, on every lane; then timed
   (CUDA events) beside its bound, with nvidia-smi's SM clock sampled;
7. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port only.  Exits non-zero, printing no
result, when no CUDA device is available.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
#: H100 SXM published peaks: HBM bytes/s (NVIDIA data sheet), and the
#: int32 rate, which the sheet does not list: 132 SMs x 64 int32 lanes
#: (one result per lane per clock for add, logic, shift and
#: multiply-add, CUDA C++ Programming Guide throughput table, compute
#: capability 9.0) x the 1.98 GHz boost clock behind the sheet's
#: 67 TFLOP/s float32 figure (132 x 128 x 2 x 1.98e9)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 132 * 64 * 1.98e9

# Least int32 instructions per lane that each function needs, with a
# product and its column add as one multiply-add.  Field (csrc/field.cu):
# two shift-only relax passes over 27 rows (shift, mask, add), 27
# multiply-adds for the x608 fold, four relax passes over 26 rows plus
# the wrap's multiply-add.
FOLD_RELAX_OPS = 2 * 27 * 3 + 27 + 4 * (26 * 3 + 1)
MUL_OPS = 676 + FOLD_RELAX_OPS             # 26 x 26 multiply-adds
SQ_OPS = 26 + 325 + 26 + FOLD_RELAX_OPS    # diagonal, cross terms, doublings
# SHA-512 (csrc/sha512.cu), in 64-bit operations per absorbed block:
# 64 schedule steps of 13 (sigma0/sigma1: 2 rotates, 1 shift, 2 xors
# each; 3 adds) and 80 rounds of 23 (Sigma0/Sigma1: 3 rotates, 2 xors
# each; Ch as g ^ (e & (f ^ g)) and Maj as b ^ ((a ^ b) & (b ^ c)), 3
# each with a ^ b carried to the next round; 7 adds), plus the 8 state
# adds.  Each 64-bit operation is two 32-bit ones (a rotate is two
# funnel shifts, an add an add and an add-with-carry).
SHA_BLOCK_OPS = 2 * (64 * 13 + 80 * 23 + 8)
# The fused keyed verify (csrc/verify_keyed.cu), per lane: R's
# decompression takes 20 products (11 in pow22523) and 255 squarings
# (251 in pow22523), [S]B 32 mixed adds of 7 products, [k](-A) one add
# of 8 products per window, the two point additions 9 each, and [8] three
# doublings of 4 products and 4 squarings.  The canonical-form tests and
# the digest reduction are left out, so the bound is a lower one.
VK_SQUARES = 255 + 3 * 4


def vk_products(window_bits: int) -> int:
    return 20 + 32 * 7 + (256 // window_bits) * 8 + 2 * 9 + 3 * 4


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class SmiSampler:
    """nvidia-smi's SM clock and power draw, sampled every 50 ms while
    the block runs: the clock a time was taken at."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        time.sleep(0.5)  # nvidia-smi's own start-up
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.rows.append((mhz, watts))

    def summary(self) -> str:
        if not self.rows:
            return "SM clock not sampled"
        mhz = sorted(r[0] for r in self.rows)
        watts = sorted(r[1] for r in self.rows)
        return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
                f"{mhz[len(mhz) // 2]:.0f}), power {watts[len(watts) // 2]:.1f} W, "
                f"{len(mhz)} samples")


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after a warm-up).  For a launch shorter than the
    host's enqueue cost this is the enqueue rate, not the kernel."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _split_events(prof):
    """(device events, host events) of a profile: kernels and copies
    on the card, operators on the host."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    return on_card, [e for e in events if e.device_type != DeviceType.CUDA]


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the CUDA kernel and copy time of
    ``iters`` calls under torch.profiler, over ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in _split_events(prof)[0])
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3 / iters


def pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


# -- phase 3: kernels against their plain versions ---------------------

def check_kernels(dev) -> dict:
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import sha512 as SH

    rs = np.random.RandomState(SEED)
    res = {}

    def limbs(b):
        # multiply outputs plus up to two chained lazy adds: signed
        # limbs up to the 2^13 operand budget
        return torch.as_tensor(
            rs.randint(-(1 << 13) + 1, 1 << 13, (F.NLIMBS, b)).astype(np.int32)
        ).to(dev)

    for b in (256, 8192):
        x, y = limbs(b), limbs(b)
        got, want = F.fe_mul(x, y), F.mul_plain(x, y)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"fe_mul differs from mul_plain at B={b}: {err}")
        ms, pms = device_ms(lambda: F.fe_mul(x, y), 200), device_ms(lambda: F.mul_plain(x, y), 20)
        ems, epms = cuda_ms(lambda: F.fe_mul(x, y), 200), cuda_ms(lambda: F.mul_plain(x, y), 20)
        nb, ops = 3 * F.NLIMBS * 4 * b, MUL_OPS * b
        res[("fe_mul", b)] = dict(err=err, ms=ms, plain_ms=pms, bound=bound_ms(nb, ops))
        print(f"fe_mul  B={b:5d}: exact; device {ms * 1e3:8.2f} us/launch (plain "
              f"{pms * 1e3:8.2f} us); back-to-back {ems * 1e3:8.2f} us (plain "
              f"{epms * 1e3:9.2f} us); bound {bound_ms(nb, ops)[0] * 1e3:.4f} us")
        for n in (1, 5, 50):
            got, want = F.fe_sq(x, n), F.square_plain(x, n)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"fe_sq(n={n}) differs at B={b}: {err}")
            reps = 3 if n == 50 else 20
            ms = device_ms(lambda: F.fe_sq(x, n), 200)
            pms = device_ms(lambda: F.square_plain(x, n), reps)
            ems = cuda_ms(lambda: F.fe_sq(x, n), 200)
            epms = cuda_ms(lambda: F.square_plain(x, n), reps)
            nb, ops = 2 * F.NLIMBS * 4 * b, SQ_OPS * n * b
            res[("fe_sq", b, n)] = dict(err=err, ms=ms, plain_ms=pms,
                                        bound=bound_ms(nb, ops))
            print(f"fe_sq   B={b:5d} n={n:2d}: exact; device {ms * 1e3:8.2f} us/launch "
                  f"(plain {pms * 1e3:9.2f} us); back-to-back {ems * 1e3:8.2f} us "
                  f"(plain {epms * 1e3:9.2f} us); bound "
                  f"{bound_ms(nb, ops)[0] * 1e3:.4f} us")

    # SHA-512 at the 150-validator path's shape: bucket 128 -> 2 blocks,
    # lanes absorbing 1 or 2 blocks by message length
    b, nblocks = 256, 2
    lens = rs.randint(0, 128 + 64 - 17 + 1 + 64, b)
    lens = np.minimum(lens, nblocks * 128 - 17)
    buf = np.zeros((nblocks * 128, b), dtype=np.uint8)
    nbl = np.zeros(b, dtype=np.int64)
    msgs = []
    for i, n in enumerate(lens):
        m = rs.randint(0, 256, int(n)).astype(np.uint8).tobytes()
        padded, k = SH.pad_message(m)
        buf[: len(padded), i] = padded
        nbl[i] = k
        msgs.append(m)
    if set(nbl.tolist()) != {1, 2}:
        raise AssertionError("sha512 check wants lanes of 1 and 2 blocks")
    tbuf, tnbl = torch.as_tensor(buf).to(dev), torch.as_tensor(nbl).to(dev)
    got = SH.sha512_padded(tbuf, nblocks, tnbl)
    want = SH.sha512_padded_plain(tbuf, nblocks, tnbl)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"sha512_padded differs from its plain version: {err}")
    host = got.cpu().numpy()
    for i, m in enumerate(msgs):
        if bytes(host[:, i]) != hashlib.sha512(m).digest():
            raise AssertionError(f"sha512_padded lane {i} differs from hashlib")
    ms = device_ms(lambda: SH.sha512_padded(tbuf, nblocks, tnbl), 200)
    pms = device_ms(lambda: SH.sha512_padded_plain(tbuf, nblocks, tnbl), 3)
    ems = cuda_ms(lambda: SH.sha512_padded(tbuf, nblocks, tnbl), 200)
    epms = cuda_ms(lambda: SH.sha512_padded_plain(tbuf, nblocks, tnbl), 3)
    nb = nblocks * 128 * b + 8 * b + 64 * b
    ops = SHA_BLOCK_OPS * int(np.minimum(nbl, nblocks).sum())
    res[("sha512_padded", b)] = dict(err=err, ms=ms, plain_ms=pms, bound=bound_ms(nb, ops))
    print(f"sha512_padded B={b} nblocks={nblocks} (lanes of 1 and 2 blocks): exact "
          f"(and equal to hashlib); device {ms * 1e3:8.2f} us/launch (plain "
          f"{pms * 1e3:9.2f} us); back-to-back {ems * 1e3:8.2f} us (plain "
          f"{epms * 1e3:9.2f} us); bound {bound_ms(nb, ops)[0] * 1e3:.4f} us")
    print("library: no PyTorch call computes a GF(2^255-19) limb product, "
          "SHA-512 or a keyed Ed25519 verify, so library_ms is null")
    _build.reset_launches()
    return res


# -- phases 4-6: the main path ----------------------------------------

def make_commit(nval: int, tag: bytes, plant: bool):
    """A commit of ``nval`` validators signing 120-byte sign-bytes at
    one height, with (when ``plant``) crafted lanes; the oracle decides
    every lane's expected verdict."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import edwards as E

    rs = np.random.RandomState(SEED + nval)
    privs = [ed.priv_key_from_secret(tag + b"-%d" % i) for i in range(nval)]
    triples = []
    for i, priv in enumerate(privs):
        head = b"vote|h=1|r=0|val=%05d|" % i
        msg = head + rs.randint(0, 256, 120 - len(head)).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    planted = {}
    if plant:
        def put(i, pub=None, sig=None, why=""):
            if pub is not None:
                triples[i][0] = pub
            if sig is not None:
                triples[i][2] = sig
            planted[i] = why

        s = triples[3][2]
        put(3, sig=s[:40] + bytes([s[40] ^ 1]) + s[41:], why="flipped S byte")
        s = triples[10][2]
        s_big = int.from_bytes(s[32:], "little") + E.L
        put(10, sig=s[:32] + s_big.to_bytes(32, "little"), why="S >= L")
        bad_r = next(bytes([j]) + bytes(31) for j in range(2, 255)
                     if E.decode_point(bytes([j]) + bytes(31)) is None)
        put(20, sig=bad_r + triples[20][2][32:], why="invalid R encoding")
        # y = p + 1 encodes the identity's y non-canonically
        nc_r = (E.P + 1).to_bytes(32, "little")
        put(30, sig=nc_r + triples[30][2][32:], why="non-canonical R")
        put(40, pub=bad_r, why="invalid A encoding")
        # small-order A with R = identity and S = 0: the cofactored
        # ZIP-215 equation holds, so the oracle accepts it
        ident = E.encode_point(E.IDENTITY)
        put(50, pub=E.small_order_points()[1], sig=ident + bytes(32),
            why="small-order A")
    expected = [E.verify_zip215(p, m, s) for p, m, s in triples]
    for i, why in planted.items():
        print(f"  planted lane {i}: {why} -> oracle says {expected[i]}")
    return triples, expected


def run_verify(triples, dev):
    import torch

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier

    t0 = time.perf_counter()
    bv = create_batch_verifier(ed.Ed25519PubKey(triples[0][0]), device=dev)
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    t1 = time.perf_counter()
    plan = bv.plan()
    t2 = time.perf_counter()
    ok, results = bv.execute(plan)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return t3 - t0, bv, plan, results, (t1 - t0, t2 - t1, t3 - t2)


def drive(name: str, triples, expected, dev, warm_runs: int,
          window_bits: int, cold_kernels) -> dict:
    """Cold verify with launch counts (``cold_kernels`` must each
    launch: the field kernels only where the run builds tables), then
    warm VerifyCommit latency over ``warm_runs`` runs; a warm verify
    launches verify_keyed and sha512_padded once per slice and no
    field kernel."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    n = len(triples)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    cold, bv, plan, results, _ = run_verify(triples, dev)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if bv.last_tier != "keyed":
        raise AssertionError(f"{name}: ran on tier {bv.last_tier}, not keyed")
    if plan.entry.window_bits != window_bits:
        raise AssertionError(f"{name}: window_bits {plan.entry.window_bits}")
    if results != expected:
        bad = [i for i, (a, b) in enumerate(zip(results, expected)) if a != b]
        raise AssertionError(f"{name}: verdicts differ from the oracle at {bad[:20]}")
    missing = [k for k in cold_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    lat, phases = [], []
    for i in range(warm_runs):
        if i == 0:
            _build.reset_launches()
        dt, bv, _, results, split = run_verify(triples, dev)
        if i == 0:
            warm_launches = dict(_build.LAUNCHES)
        if results != expected or bv.last_tier != "keyed":
            raise AssertionError(f"{name}: warm run {i} differs")
        lat.append(dt)
        phases.append(split)
    slices = -(-max(PR.next_pow2(n), 8) // EV.MAX_LAUNCH)
    want = {"verify_keyed": slices, "sha512_padded": slices, "fe_mul": 0, "fe_sq": 0}
    if warm_launches != want:
        raise AssertionError(f"{name}: warm launches {warm_launches}, expected {want}")
    p50 = pct(lat, 50)
    out = dict(
        n=n, cold_s=cold, launches=launches, warm_launches=warm_launches,
        p50_ms=1e3 * p50, p90_ms=1e3 * pct(lat, 90), p95_ms=1e3 * pct(lat, 95),
        runs=warm_runs, sigs_per_s=n / p50, peak_mb=peak / 2**20,
        field_launches=warm_launches["fe_mul"] + warm_launches["fe_sq"],
        invalid=sum(not v for v in expected), plan=plan,
    )
    print(f"{name}: {n} lanes ({out['invalid']} invalid caught), tier keyed, "
          f"window_bits {window_bits}")
    print(f"  cold verify (tables built) {cold:.3f} s; launches {launches}")
    print(f"  warm VerifyCommit over {warm_runs} runs: p50 {out['p50_ms']:.2f} ms, "
          f"p90 {out['p90_ms']:.2f} ms, p95 {out['p95_ms']:.2f} ms; "
          f"{out['sigs_per_s']:.0f} sigs/s")
    add_ms, plan_ms, exec_ms = (1e3 * pct([p[j] for p in phases], 50) for j in range(3))
    print(f"  warm phases, p50: add {add_ms:.3f} ms (create_batch_verifier + add x {n}), "
          f"plan {plan_ms:.3f} ms (key lookup, key ids), execute {exec_ms:.3f} ms "
          "(pack, copy in, padded input, sha512_padded, verify_keyed, copy out)")
    print(f"  launches per warm verify: {warm_launches} ({slices} slice(s); "
          f"field kernels {out['field_launches']})")
    print(f"  peak device memory (cold run): {out['peak_mb']:.1f} MiB")
    return out


def check_fused(name: str, plan, expected, dev) -> dict:
    """The fused verify_keyed kernel against its plain version
    (verify_keyed_plain: the curve, scalar and comb code around the
    fe_mul / fe_sq kernels) on the plan's packed batch, slice by slice
    as verify_arrays_keyed cuts it: verdicts and the limbs of [8]q must
    be equal on every lane, and the verdicts of the real lanes the
    oracle's.  Then both timed on the first slice, beside the bound."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.ops import scalar as SC

    entry, wb = plan.entry, plan.entry.window_bits
    t0 = time.perf_counter()
    packed, bucket = EV.pack_inputs(plan.pub, plan.sig, plan.msgs, key_ids=plan.key_ids)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    batch = packed.shape[1]
    if batch > EV.MAX_LAUNCH and batch % EV.MAX_LAUNCH:
        packed = np.pad(packed, [(0, 0), (0, EV.MAX_LAUNCH - batch % EV.MAX_LAUNCH)])
        batch = packed.shape[1]
    buf = torch.from_numpy(packed).to(dev)
    nblocks = EV.nblocks_for_bucket(bucket)
    b_table = F.const(PR.b_comb8(), dev)
    key_valid = entry.valid_device()
    oks, slices, err = [], [], 0
    for s in range(0, batch, EV.MAX_LAUNCH):
        rows = buf[:, s : s + EV.MAX_LAUNCH]
        digest = EV.keyed_digest(rows, bucket, nblocks)
        q8 = torch.empty((4, F.NLIMBS, rows.shape[1]), dtype=F.DTYPE, device=dev)
        ok = EV.verify_keyed_fused(rows, digest, entry.table, key_valid, b_table,
                                   bucket, wb, out_point=q8)
        want_ok, want_q8 = EV.verify_keyed_plain(rows, digest, entry.table, key_valid,
                                                 b_table, bucket, wb)
        torch.cuda.synchronize()
        e = int((q8.long() - want_q8.long()).abs().max())
        if e != 0 or not torch.equal(q8, want_q8) or not torch.equal(ok, want_ok):
            bad = (ok != want_ok).nonzero().flatten().tolist()[:20]
            raise AssertionError(f"{name}: verify_keyed differs from its plain version "
                                 f"at slice {s}: max |dq8| {e}, verdicts differ at {bad}")
        err = max(err, e)
        oks.append(ok)
        slices.append((rows, digest))
    got = torch.cat(oks).cpu().numpy()[: len(expected)].tolist()
    if got != list(expected):
        raise AssertionError(f"{name}: verify_keyed verdicts differ from the oracle")
    rows, digest = slices[0]
    n = rows.shape[1]
    fused = lambda: EV.verify_keyed_fused(rows, digest, entry.table, key_valid, b_table,
                                          bucket, wb)
    plain = lambda: EV.verify_keyed_plain(rows, digest, entry.table, key_valid, b_table,
                                          bucket, wb)
    # the kernel runs for a millisecond, far longer than its host enqueue
    # (~0.05 ms), so back-to-back CUDA events time the kernel itself;
    # torch.profiler is printed beside them
    with SmiSampler() as smi:
        ms = cuda_ms(fused, 200)
        pfms = device_ms(fused, 50)
    pms = device_ms(plain, 2)
    # bytes: per lane S and the key id (68 of the packed rows), the
    # digest, the verdict; and each distinct comb entry the lanes gather
    s_idx = rows[64:96].long()
    k = SC.reduce_digest(digest)
    win = SC.limbs_to_windows8(k) if wb == 8 else SC.limbs_to_nibbles(k)
    kid = torch.from_numpy(packed[100 + bucket : 104 + bucket, :n].astype(np.int64)).to(dev)
    key = kid[0] | (kid[1] << 8) | (kid[2] << 16) | (kid[3] << 24)
    nwin = 256 // wb
    b_entries = int(torch.unique(s_idx + 256 * torch.arange(32, device=dev)[:, None]).numel())
    k_entries = int(torch.unique(
        (key[None] * (1 << wb) + win.long()) * nwin
        + torch.arange(nwin, device=dev)[:, None]).numel())
    nbytes = n * (68 + 64 + 1) + 3 * F.NLIMBS * 4 * b_entries + 4 * F.NLIMBS * 4 * k_entries
    ops = n * (vk_products(wb) * MUL_OPS + VK_SQUARES * SQ_OPS)
    bound = bound_ms(nbytes, ops)
    print(f"verify_keyed {name}: {len(oks)} slice(s) of {n} lanes, window_bits {wb}: "
          f"exact against its plain version (verdicts and [8]q limbs on every lane, "
          f"= oracle); {ms * 1e3:9.2f} us/launch back-to-back at {n} lanes (CUDA "
          f"events; torch.profiler {pfms * 1e3:9.2f} us; plain {pms * 1e3:10.2f} us "
          f"device time); bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]}; {b_entries} + {k_entries} comb "
          f"entries, {nbytes} bytes); while timed: {smi.summary()}; host "
          f"pack_inputs of the {len(expected)} lanes {pack_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=pms, bound=bound, lanes=n)


def profile_warm(name: str, triples, dev) -> None:
    """One warm verify under torch.profiler: the device's busy share
    (kernel and copy time over the wall), the kernels that take it, and
    the host operations that take the wall."""
    from torch.profiler import ProfilerActivity, profile

    run_verify(triples, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run_verify(triples, dev)[0]
    dev_events, host = _split_events(prof)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if dev_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    print(f"profile: warm {name} verify, wall {wall * 1e3:.2f} ms under the "
          f"profiler, device busy {dev_ms:.2f} ms, busy share {dev_ms / (wall * 1e3):.3f}, "
          f"{sum(e.count for e in dev_events)} kernels and copies on the card")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:7.3f} ms  calls {e.count:5d}  "
              f"{e.key[:70]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:7.3f} ms  calls {e.count:5d}  "
              f"{e.key[:70]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from cometbft_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {name}, count {count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} sources "
          "(nvcc in parallel)")
    print(f"  verify_keyed: {_build.library('verify_keyed').verify_keyed_smem_bytes()} "
          "bytes of dynamic shared memory per block")
    for b in built.values():
        print(f"  {b.name}: nvcc {b.seconds:.2f} s -> {b.path}")
        for line in b.ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {line.strip()}")

    print("kernels vs plain versions: tolerance exact (max |kernel - plain| must be 0; "
          "the arithmetic is integer)")
    kres = check_kernels(dev)

    every = ("fe_mul", "fe_sq", "sha512_padded", "verify_keyed")
    commit150, exp150 = make_commit(150, b"validator", plant=True)
    main150 = drive("commit150", commit150, exp150, dev, warm_runs=100,
                    window_bits=8, cold_kernels=every)
    profile_warm("commit150", commit150, dev)
    vk150 = check_fused("commit150", main150["plan"], exp150, dev)

    commit1k, exp1k = make_commit(1024, b"validator1k", plant=True)
    main1k = drive("commit1024", commit1k, exp1k, dev, warm_runs=20, window_bits=4,
                   cold_kernels=every)
    check_fused("commit1024", main1k["plan"], exp1k, dev)

    # > 8192 lanes: the 150-validator commit repeated across heights,
    # plus invalid lanes planted at known positions in both slices
    reps = -(-8193 // len(commit150))
    big = [list(t) for _ in range(reps) for t in commit150]
    big_exp = exp150 * reps
    for pos in (100, 8192, len(big) - 1):
        big[pos][1] = big[pos][1] + b"!"
        big_exp[pos] = False
    # the tables are warm from commit150: no field kernel runs here
    chunked = drive("chunked", big, big_exp, dev, warm_runs=5, window_bits=8,
                    cold_kernels=("sha512_padded", "verify_keyed"))
    profile_warm("chunked", big, dev)
    check_fused("chunked", chunked["plan"], big_exp, dev)

    kernels = []
    for kname, key in (("fe_mul", ("fe_mul", 256)), ("fe_sq", ("fe_sq", 256, 1)),
                       ("sha512_padded", ("sha512_padded", 256))):
        r = kres[key]
        src = "cometbft_tpu_torch/csrc/" + ("sha512.cu" if kname.startswith("sha") else "field.cu")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": ("cometbft_tpu/ops/sha512.py:116" if kname.startswith("sha")
                         else "cometbft_tpu/ops/field.py:338"),
            "launches": main150["launches"][kname],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
        })
    kernels.append({
        "name": "verify_keyed", "route": "cuda",
        "source": "cometbft_tpu_torch/csrc/verify_keyed.cu",
        "replaces": "cometbft_tpu/ops/field.py:338",
        "launches": main150["launches"]["verify_keyed"],
        "max_abs_err": vk150["err"], "ms": vk150["ms"], "plain_ms": vk150["plain_ms"],
        "bound_ms": vk150["bound"][0], "bound_by": vk150["bound"][1],
        "library_ms": None,
    })
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
