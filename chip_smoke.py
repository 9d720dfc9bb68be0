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
   the host's enqueue cost bounds at these sizes); the table build
   (build_tables) on commit150's 150 keys and one key (8-bit windows)
   and commit1024's 1024 keys and one key (4-bit), limbs and validity,
   at every compiled launch shape (Q, G) of each launch with the other
   at the launcher's pick, each timed by CUDA events beside its bound
   (the pick and the fastest marked) and the plain version;
4. the main path: keyed commit verification of a 150-validator commit
   through ``create_batch_verifier(...).verify()`` on ``cuda``, with
   planted invalid lanes whose verdicts the big-int oracle decides;
   the cold verify (b_comb8, the host-built comb of B, timed alone just
   before it) must launch build_tables once and sha512_keyed and
   verify_keyed once per slice, and nothing else (fe_mul and fe_sq 0),
   and is split into its table lookup (plan) and the rest, and the
   lookup into its parts (LookupSplit: zeroing, the build, the keys'
   upload and the validity's copy back, growth, the copy into the pool,
   compaction) by host clock and CUDA events; a warm verify must launch
   sha512_keyed and verify_keyed once per slice and no other kernel;
   then ten warm
   verifies under torch.profiler for the device's busy share, and
   twenty unprofiled ones after them (the cost model learns from every
   verify);
5. the same for a 1024-validator commit (the 4-bit comb tables);
6. a batch of more than 8192 lanes, through the MAX_LAUNCH slicing,
   with a profiled warm verify too;
   after each of phases 4-6 the sha512_keyed kernel is held against
   keyed_digest's plain route and the fused verify_keyed kernel against
   its plain version, at every compiled group size G, on the same batch,
   slice by slice: the digests, the verdicts and the limbs of [8]q,
   exactly, on every lane; then each G is timed (CUDA events) beside the
   bound, with nvidia-smi's SM clock sampled, and the launcher's choice
   marked, and sha512_keyed by CUDA events back to back and by
   torch.profiler;
7. the validator-set change: commit150's set on a fresh KeyTableCache,
   then 20 heights that each rotate one validator out and a newcomer in
   (generic-wide's keys), each a cold one-key verify (p50 and max, and
   the lookup split's p50), three times: the default budget (new pages into never-used slots, in
   place), a budget under the pool that evicts the key rotated out at
   every height (its slot reused by copy-on-write), and a budget that
   grows, evicts and compacts the pool at every height (after a prior
   106-key set); verdicts = the oracle's at every height, ``stats`` as
   the policy says, and an entry taken before the first eviction still
   verifies its own batch after the last height;
8. commit10k: generic-wide's first 10000 triples (two planted invalid
   keys) as one set on the keyed tier, 4-bit, on a fresh cache: cold
   seconds, warm p50, peak memory; the pool's pages of 512 of its keys,
   the invalid ones included, held to build_tables_plain, and the
   build of those keys at every shape of each launch; the build of all
   10000 keys timed by CUDA events at every shape of each launch beside
   its bound;
9. the generic tier (no comb tables), with precompute.TABLE_MAX_KEYS
   set to 0 for the phase only, on the same three cells (generic150,
   generic1024, generic-chunked): verdicts = the oracle's, a cold verify
   launches what a warm one does (sha512_keyed and verify_generic once
   per slice, no table build, no other kernel), warm latency; then
   verify_generic held to verify_generic_plain at every compiled launch
   shape (quarters, threads per quarter) on every slice (verdicts and
   [8]q limbs, exactly) and each shape timed beside its bound, with its
   time per step of the lane's critical path (VG_CHAIN), also on
   generic-chunked's first 256 to 4096 lanes; then generic-wide, a set of more than
   TABLE_MAX_KEYS distinct keys at the default limit, the traffic that
   takes the generic tier unasked; the oracle floor's time on commit150
   (the route these batches took before the generic tier), and
   ``models.commit.commit_verify_step`` on a (4, 150) batch against the
   oracle;
10. the dispatch ladder and the host tier, after the link's threshold
   (``_measure_link_rtt`` and ``runtime_device_min_batch``, printed
   after the build; commit150 takes the device unless n* > 150): the
   host cells (host2, a 2-signature evidence check; host16 and host63,
   commit150's first votes, one RLC check each; host63-invalid, one
   altered message, so every lane is re-verified; host-bigmsg, 150
   votes with one 5000-byte message) each take the host tier with its
   reason, verdicts = the oracle's, wall and RLC-call time per
   signature; CpuBatchVerifier alone on 150, 1024 and 4096 valid lanes
   beside the keyed tier's warm p50 on the same lanes; the ladder's
   bookkeeping on a warm commit150 verify (plan() beside the bare
   lookup, execute() beside verify_arrays_keyed, and execute() with the
   watchdog stubbed and with no-op metrics, in an order that rotates
   every run, after printing what the cost model learned); then the
   chaos phase: with demote_after 1 and a 1 s cool-down on an injected
   clock, a device loss on keyed (generic answers), on keyed and
   generic (host answers), a clean half-open trial past the cool-down
   (keyed again), and a launch hang on keyed under a 1 s watchdog
   budget (device_hangs_total counts 1, generic answers), every
   batch's verdicts the oracle's and the transitions as expected.
   After every phase but the chaos and prober phases the ladder must
   hold no demotion and no recorded fault, and the cost model must rank
   keyed first for commit150's and commit1024's shape buckets;
11. the verify-ahead plane, each part with the launch counters at 0 at
   its start, failing on a wrong verdict or a thread left behind:
   stream150 (64 warm commit150 jobs, each with one S byte flipped,
   through ``verify_stream`` over a ``verify_arrays_keyed_async``
   closure, max_in_flight 8), stream-chunked (8 jobs of 8250 lanes) and
   stream-generic1024 (16 commit1024 jobs on the generic tier), each
   beside a synchronous loop over the same jobs (sigs/s, busy share,
   host ms and launches per job); queue: a ``VerifyQueue`` with the
   default factory, installed, fed at once by four submitter threads
   (consensus vote pairs, 8 re-signed commit1024 prefetch blocks, 4
   re-signed commit150 light-client headers, 512 one-signature CheckTx
   submissions), every future = the oracle's, the consensus wait beside
   a prefetch launch's wall, the coalesced sizes, the spec cache on a
   header submitted again, the overlap ratio, the
   ``crypto_verify_queue_*`` series and a clean ``stop()``, then two
   warm mixes, and the same work without a queue for its sigs/s;
   prober: a
   ``HealthProber`` at 0.5 s with the default canaries (host, keyed,
   generic) demotes keyed under a chaos device_loss and promotes it with
   reason ``probes`` after it; seed: each tier's single-batch rows at
   150 and 1024 lanes appended to the port's perf ledger
   (``build/perf_ledger.json``) and a fresh subprocess whose seeded
   cost model must rank keyed first for buckets 256 and 1024;
12. commit verification through the types layer (``validation_phase``,
   the launch counters at 0 at its start, on a fresh KeyTableCache):
   verify150 (``types.validation.verify_commit`` on a 150-validator
   commit of commit150's keys, precommits signed over their canonical
   sign bytes with per-vote timestamps: cold launches build_tables,
   sha512_keyed and verify_keyed once each; warm p50/p99 over 200 with
   sha512_keyed and verify_keyed once per call, beside the synthetic
   ``create_batch_verifier -> add x n -> verify()`` on the same triples
   and the sign bytes alone; an altered signature, a commit under 2/3,
   a wrong height and a wrong block id raise the reference's errors),
   light1024 (``verify_commit_light`` on commit1024's keys: the
   signatures the early break sends and the tier), votes150 (the 150
   precommits through ``VoteSet.add_vote`` with a VerifyQueue
   installed, from one thread and from four: wall per vote, votes
   verified inline; ``verify_commit`` on ``make_commit()`` must be 150
   speculative-cache hits, no miss and no launch) and light-chain (the
   light verifier along a 64-header, 150-validator chain that rotates a
   validator every 8 heights: every adjacent step, skips of 8 and 32
   with ``now`` fixed, a tampered, an expired and a future header; per
   check the tier and the signatures sent, the rotation steps apart);
13. the multi-device plane (``mesh_phase``, the launch counters at 0 at
   its start, a static walk): on every visible card, or on 4 shards of
   cuda:0 on a one-card machine, commit150 and commit1024 through
   ``ShardedTorchBatchVerifier`` on keyed_mesh, chunked and generic1024
   on generic_mesh (each shard's lanes, width and launches; verdicts =
   the oracle's = the single-device tier's; each shard held to the plain
   versions on its own inputs and timed beside its bound; warm p50
   beside the single-device tier's, interleaved), commit10k's 4160 MiB
   pool through ``sharded_tables`` (the placement's bytes beside the
   pool's) and a keyed_mesh verify on it, a ``shard_loss`` window
   (keyed_mesh alone demoted, keyed answers) and the mesh canaries;
14. the device-plane guard (``guard_phase``): ``jitguard.enable()``,
   warm-up, ``seal()``, commit150 on keyed, generic and keyed_mesh
   inside ``transfer_window`` with no new launch signature and no
   build; a planted ``.item()`` raises and counts one transfer trip, a
   planted new signature raises ``RetraceError``; then ``reset()``;
15. persistence and the light client (``light_sync_phase``, cell
   light-sync1024: BASELINE config 3 at 150 validators, its depth cut
   to 1024 heights): a chain whose set loses an original validator to a
   newcomer at every 8th height, written block by block through
   ``BlockStore.save_block`` and ``state.Store.save`` into sqlite
   files, closed and opened again; then ``light.client.Client`` over
   ``NodeProvider``s of those stores on a fresh KeyTableCache: the
   skipping sync 1 -> 1024 (the direct skip refused, 1 -> 512 -> 1024;
   cold once, then warm on fresh LightStores), a sequential sync to 64,
   a backwards check from a root at 1024 (no launch), a flipped
   signature in a third store (refused by the keyed tier's verdict), an
   expired root, a missing height, and a forked witness
   (``ErrLightClientAttack``, one LightClientAttackEvidence to each
   provider); every check on the keyed or host tier;
16. blocksync catch-up (``blocksync_phase``, cell blocksync1024: BASELINE
   config 4 at 1024 validators, its depth cut to BS_HEIGHTS): a source
   node (``BlockExecutor`` over a ``KVStoreApp``, sqlite stores) builds
   the chain height by height, a val: tx pair rotating one validator
   every 64 heights, each commit signed by the height's own set in
   worker processes (``SignerPool``); a byzantine copy of its stores
   serves block BS_BAD_HEIGHT with a flipped LastCommit signature, an honest copy
   the rest; ``verify_keyed`` and ``sha512_keyed`` held to their plain
   versions on a cold verify-ahead step's 8192 lanes (4-bit combs); then
   two syncs of a fresh node between three nodes over 127.0.0.1 TCP
   (each a ``p2p.test_util.make_switch``: its own ``NodeKey``, a
   ``MultiplexTransport``, secret connections, MConnection, a ``Switch``
   with the ``BlocksyncReactor`` under "BLOCKSYNC"; the syncer dials the
   byzantine server, then the honest one when the byzantine peer is
   removed; a started ``VerifyQueue`` with the default factory):
   (a) cold tables, prefetch depth 8, (c) warm, depth 0.  Each prints
   its walls, blocks/s, the per-step split with the syncer's
   ``switch_dispatch``, a BlockResponse's bytes, the bytes each way per
   peer, each handshake's ms, the frame backend, the cache hits, the
   prefetch batches, launches and the busy share, and must store the
   source's blocks and states key for key, reach its app hash, hand the
   source's state to consensus, stop the byzantine peer (by node ID)
   once for "sent invalid block" and no honest one, and count no
   pool-routine error and no send timeout;
17. consensus (``consensus_phase``): (a) localnet4, four port validators
   at power 10 over 127.0.0.1 TCP, fully meshed, each with a
   ConsensusReactor and a MempoolReactor on its switch, a KVStoreApp
   through the local proxy, sqlite stores, the Handshaker at start, the
   default ConsensusConfig and MempoolConfig and the verify queue
   installed; CS_TXS signed txs (``make_signed_tx``, 64-100-byte kvstore
   payloads, a key and a sender each) sent to node 0 by CS_CLIENTS
   threads, run until every tx is committed and CS_MIN_HEIGHTS heights;
   it fails unless every node stored the same block hash at every
   height, each tx was committed once, the app hashes agree and no node
   logged a consensus error, and prints heights/s, the rounds above 0,
   each step's p50/max, the queue's coalesced sizes per lane, each
   node's CheckTx outcomes, the tiers and launches; (b)
   commit150-consensus, one port validator and 149 stubs (BASELINE
   config 2's width) driven by the validator-stub pattern, to height
   CS_STUB_HEIGHTS + 1, (b1) with the queue installed, (b2) with none:
   per height the wall, add_vote's p50, apply_block and its
   verify_commit; the launches, keys built, spec-cache hits and misses,
   tiers and busy share; (b2) must launch sha512_keyed and verify_keyed
   at every height from 2 on and build_tables, all on the keyed tier,
   (b1) must hit the cache and launch no verify; (w), a crash and the
   WAL's replay; (r) commit150-remote, (b2)'s configuration with the
   app and the signer out of process: the port's KVStoreApp behind
   ``abci.grammar.RecordingApp`` in a child served by the port's
   SocketServer (its Commit retaining the last CS_RETAIN heights), the
   validator's key in a second child, ``python -m
   cometbft_tpu_torch.privval.signer``, dialling the node's
   ``SignerListenerEndpoint``; the node reaches the app through
   ``proxy.default_client_creator`` (four sockets) and signs through a
   ``SignerClient``, runs the IndexerService and a Pruner with the
   trust guard armed, and takes CS_REMOTE_TXS signed txs before height
   2; per height the wall and add_vote's p50 beside (b2)'s, each ABCI
   method's and each signing round trip's p50/max; it must commit
   every tx once, find each by hash and by ``tx.height``, match the
   app's Info, pass ``check_grammar`` on the app's record, leave
   nothing below the pruner's retain height, count no trust-guard trip
   and the same signatures on both ends, and, once the app is killed,
   fire ``on_error`` within CS_APP_ERROR_S and stop consensus; then the
   same over gRPC for CS_GRPC_HEIGHTS heights;
18. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only light,blocksync,consensus

builds the kernels, runs the threshold (phase 1) and the comb of B, then
only the named phases of 15, 16 and 17, each followed by its ladder
check, and prints no kernels line and no result line.

    python3 chip_smoke.py --warm150 [TREE]

builds the kernels of the port in TREE (default: this script's
directory) and prints, as one JSON line, commit150's warm
VerifyCommit p50 and its add / plan / execute split over 200 runs
through ``create_batch_verifier``: run it on two trees in one call,
in the order A, B, B, A, to compare them on one card.

Imports torch, numpy and the port only.  Exits non-zero, printing no
result, when no CUDA device is available.  The launch watchdog's
daemon thread is stopped before it returns.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
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


# The generic verify (csrc/verify_generic.cu), per lane: two
# decompressions (A and R) of 20 products and 255 squarings, the
# multiples table of -A (14 point additions of 9 products), 64 windows of
# 4 doublings (4 products and 4 squarings each) and one addition of 9,
# [S]B's 64 mixed adds of 7, the two point additions and [8] as above.
VG_PRODUCTS = 2 * 20 + 14 * 9 + 64 * (4 * 4 + 9) + 64 * 7 + 2 * 9 + 3 * 4   # 2244
VG_SQUARES = 2 * 255 + 64 * 4 * 4 + 3 * 4                                   # 1546
# Dependent field operations on a lane's critical path, per schedule.
# One group per lane (Q = 1) runs all of them in turn.  Four quarters
# run A's and R's decompressions side by side (275 each), a mixed
# addition at a depth of two products, a point addition at three (x2d
# then xt2) and a doubling at two: [S]B after the decompressions
# four-way (64 x 2), or at (4, 32) beside them two-way (64 x 4 = 256,
# under the 275), then the table (14 x 3), 64 windows of four doublings
# and an addition (64 x 11), the two additions and [8] (2 x 3 + 3 x 2).
VG_DECOMPRESS = 20 + 255
VG_CHAIN = {
    1: VG_PRODUCTS + VG_SQUARES,                                          # 3790
    4: VG_DECOMPRESS + 64 * 2 + 14 * 3 + 64 * (4 * 2 + 3) + 2 * 3 + 3 * 2,  # 1161
    "split": max(VG_DECOMPRESS, 64 * 4) + 14 * 3 + 64 * 11 + 12,            # 1033
}


# The table build (csrc/build_tables.cu), per key: A's decompression (20
# products, 255 squarings), t = xy, (nwin - 1) * wb doublings of 4
# products and 4 squarings, nwin * (2^wb - 1) additions of 9 products,
# and 2dT for each window's last entry: every other entry's 2dT is T 2d,
# the first product of the addition that follows it (74485 products per
# 8-bit key, 9733 per 4-bit).  ``every_entry`` counts a 2dT product for
# each of the nwin * 2^wb entries instead (82645 and 10693).  Bytes:
# the key and its validity, and its page written once (the window bases
# are scratch).
def bt_counts(window_bits: int, every_entry: bool = False) -> tuple[int, int]:
    nwin, nent = 256 // window_bits, 1 << window_bits
    dbl = (nwin - 1) * window_bits
    t2d = nwin * nent if every_entry else nwin
    return 21 + 4 * dbl + 9 * nwin * (nent - 1) + t2d, 255 + 4 * dbl


def bt_bound(nkeys: int, window_bits: int, every_entry: bool = False) -> tuple[float, str]:
    prods, sqs = bt_counts(window_bits, every_entry)
    page = (256 // window_bits) * 4 * 26 * (1 << window_bits) * 4
    return bound_ms(nkeys * (32 + 1 + page), nkeys * (prods * MUL_OPS + sqs * SQ_OPS))


def vk_bound(rows, digest, bucket: int, window_bits: int):
    """verify_keyed's bound on a slice of packed keyed rows with its
    digest -> (bound, B comb entries, key comb entries, bytes).  Bytes:
    per lane S and the key id (68 of the packed rows), the digest, the
    verdict; and each distinct comb entry the lanes gather."""
    import torch

    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import scalar as SC

    n, dev, wb = rows.shape[1], rows.device, window_bits
    s_idx = rows[64:96].long()
    k = SC.reduce_digest(digest)
    win = SC.limbs_to_windows8(k) if wb == 8 else SC.limbs_to_nibbles(k)
    kid = rows[100 + bucket : 104 + bucket].long()
    key = kid[0] | (kid[1] << 8) | (kid[2] << 16) | (kid[3] << 24)
    nwin = 256 // wb
    b_entries = int(torch.unique(s_idx + 256 * torch.arange(32, device=dev)[:, None]).numel())
    k_entries = int(torch.unique(
        (key[None] * (1 << wb) + win.long()) * nwin
        + torch.arange(nwin, device=dev)[:, None]).numel())
    nbytes = n * (68 + 64 + 1) + 3 * F.NLIMBS * 4 * b_entries + 4 * F.NLIMBS * 4 * k_entries
    ops = n * (vk_products(wb) * MUL_OPS + VK_SQUARES * SQ_OPS)
    return bound_ms(nbytes, ops), b_entries, k_entries, nbytes


def sha_keyed_bound(rows, bucket: int, nblocks: int):
    """sha512_keyed's bound on a slice of packed rows -> (bound, blocks
    per lane).  Bytes: R, A, each lane's message and length, read once,
    and the digest written; operations the blocks each lane absorbs."""
    lens = rows[96 + bucket : 100 + bucket].cpu().numpy().astype(np.int64)
    msglen = lens[0] | (lens[1] << 8) | (lens[2] << 16) | (lens[3] << 24)
    blocks = np.minimum((64 + msglen + 17 + 127) // 128, nblocks)
    sha_bytes = int((64 + msglen + 4 + 64).sum())
    return bound_ms(sha_bytes, SHA_BLOCK_OPS * int(blocks.sum())), blocks


def vg_bound(rows):
    """verify_generic's bound on a slice of packed generic rows ->
    (bound, B comb entries, bytes).  Bytes: per lane pub and sig (96 of
    the packed rows), the digest and the verdict, and each distinct comb
    entry of B the lanes gather; the multiples table is scratch, written
    and read by the kernel."""
    import torch

    from cometbft_tpu_torch.ops import curve as C

    m, dev = rows.shape[1], rows.device
    nib = C.nibbles_from_bytes_le(rows[64:96]).long()
    entries = int(torch.unique(nib + 16 * torch.arange(64, device=dev)[:, None]).numel())
    nbytes = m * (96 + 64 + 1) + 3 * 26 * 4 * entries
    return bound_ms(nbytes, m * (VG_PRODUCTS * MUL_OPS + VG_SQUARES * SQ_OPS)), entries, nbytes


def vg_chain(shape) -> int:
    q, g = shape
    return VG_CHAIN["split" if (q, g) == (4, 32) else q]


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

    def median_mhz(self) -> float | None:
        mhz = sorted(r[0] for r in self.rows)
        return mhz[len(mhz) // 2] if mhz else None

    def summary(self) -> str:
        if not self.rows:
            return "SM clock not sampled"
        mhz = sorted(r[0] for r in self.rows)
        watts = sorted(r[1] for r in self.rows)
        return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
                f"{mhz[len(mhz) // 2]:.0f}), power {watts[len(watts) // 2]:.1f} W, "
                f"{len(mhz)} samples")


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after ``warm`` calls).  For a launch shorter than the
    host's enqueue cost this is the enqueue rate, not the kernel."""
    import torch

    for _ in range(warm):
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


def device_ms(fn, iters: int, profiles: int = 3) -> float:
    """Device time per call of ``fn``: the CUDA kernel and copy time of
    ``iters`` calls under torch.profiler, over ``iters``.  A profile
    that records no device event at all (CUPTI once returned none on
    the card's machine) is taken again, up to ``profiles`` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in _split_events(prof)[0])
        if total_us > 0:
            return total_us / 1e3 / iters
    raise AssertionError(f"torch.profiler recorded no device time in {profiles} profiles")


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
    print("library: no PyTorch call computes a GF(2^255-19) limb product, SHA-512, an "
          "Ed25519 verify or a comb-table build, so library_ms is null")
    _build.reset_launches()
    return res


def key_tensor(keys: list[bytes], dev):
    """(32, n) uint8 keys on ``dev``, key i in column i."""
    import torch

    return torch.as_tensor(np.stack([np.frombuffer(k, dtype=np.uint8) for k in keys],
                                    axis=-1)).to(dev)


def bt_choice(lib, n: int, launch: int) -> tuple[int, int]:
    """The shape build_tables' launcher picks for launch 1 (n keys) or 2
    (n entry lanes)."""
    import ctypes

    q, g = ctypes.c_int(), ctypes.c_int()
    if lib.build_tables_shape(n, launch, ctypes.byref(q), ctypes.byref(g)) != 0:
        raise AssertionError(f"build_tables_shape refused launch {launch}")
    return q.value, g.value


def bt_variants(pick) -> list:
    """The launcher's pick, then each launch at every other compiled shape
    with the other launch at its pick."""
    from cometbft_tpu_torch.ops import precompute as PR

    return ([pick] + [(s, pick[1]) for s in PR.BUILD_SHAPES if s != pick[0]]
            + [(pick[0], s) for s in PR.BUILD_SHAPES if s != pick[1]])


def check_build_shapes(name: str, pub, wb: int, want_table, want_valid, variants) -> int:
    """build_tables at every shape pair of ``variants`` against the plain
    version's table and validity: every limb equal.  Returns max |d|."""
    import torch

    from cometbft_tpu_torch.ops import precompute as PR

    err = 0
    for shapes in variants:
        table, valid = PR.build_tables_kernel(pub, wb, shapes=shapes)
        torch.cuda.synchronize()
        e = int((table - want_table).abs().max())
        if e != 0 or not torch.equal(table, want_table) or not torch.equal(valid, want_valid):
            raise AssertionError(f"build_tables {shapes} differs from build_tables_plain on "
                                 f"{name}: max |d| {e}, validity equal: "
                                 f"{torch.equal(valid, want_valid)}")
        err = max(err, e)
        del table
    return err


def sweep_build(pub, wb: int, variants, iters: int) -> tuple[dict, str]:
    """Each shape pair's time per call (CUDA events; both launches), with
    nvidia-smi's clock sampled meanwhile."""
    from cometbft_tpu_torch.ops import precompute as PR

    with SmiSampler() as smi:
        times = {shapes: cuda_ms(lambda shapes=shapes: PR.build_tables_kernel(pub, wb,
                                                                             shapes=shapes),
                                 iters, warm=1)
                 for shapes in variants}
    return times, smi.summary()


def print_build_sweep(times: dict, pick, bound: float) -> None:
    """The sweep per launch: each shape's time and bound share, the
    launcher's pick and the fastest marked."""
    for side, label in ((0, "bases"), (1, "entries")):
        row = {shapes[side]: t for shapes, t in times.items()
               if shapes[1 - side] == pick[1 - side]}
        best = min(row, key=row.get)
        print(f"  {label} launch at (Q, G), the other at its pick: " + ", ".join(
            f"{s}: {t:.3f} ms ({bound / t:.3f})" + (" pick" if s == pick[side] else "")
            + (" fastest" if s == best else "") for s, t in row.items()))


def check_build(dev, cases) -> dict:
    """The build_tables kernel against build_tables_plain on the card:
    ``cases`` are (name, keys, window_bits); every limb of the table and
    the validity must be equal at every compiled shape (Q, G) of each
    launch, the other launch at the launcher's pick.  Then each of those
    timed by CUDA events beside the bound (the launcher's pick and the
    fastest marked) and the plain version.  (CUDA events only:
    torch.profiler read these launches at about a third of their
    time.)"""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR

    lib = _build.library("build_tables")
    res = {}
    for name, keys, wb in cases:
        pub = key_tensor(keys, dev)
        n = pub.shape[1]
        pick = (bt_choice(lib, n, 1), bt_choice(lib, n * (256 // wb), 2))
        variants = bt_variants(pick)
        want_table, want_valid = PR.build_tables_plain(pub, wb)
        err = check_build_shapes(name, pub, wb, want_table, want_valid, variants)
        del want_table
        times, clocks = sweep_build(pub, wb, variants, 10 if n <= 150 else 3)
        ms = times[pick]
        pms = cuda_ms(lambda: PR.build_tables_plain(pub, wb), 1, warm=0)
        bound = bt_bound(n, wb)
        invalid = int((~want_valid).sum())
        print(f"build_tables {name}: {n} keys, window_bits {wb} ({invalid} invalid): exact "
              f"against build_tables_plain (every limb, validity) at {len(variants)} shape "
              f"pairs; {ms:.3f} ms per call at the pick {pick} (CUDA events), "
              f"{ms * 1e3 / n:.2f} us per key; plain {pms:.3f} ms; bound {bound[0]:.4f} ms "
              f"({bound[1]}; with a 2dT per entry {bt_bound(n, wb, True)[0]:.4f}), share "
              f"{bound[0] / ms:.4f}; {clocks}")
        print_build_sweep(times, pick, bound[0])
        res[name] = dict(err=err, ms=ms, plain_ms=pms, bound=bound, n=n, wb=wb,
                         choice=pick, sweep=times)
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


def run_verify(triples, dev, cache=None, mesh=None):
    """One verify through the entry point (``create_batch_verifier``, or
    a TorchBatchVerifier on ``cache`` when one is given, or a
    ShardedTorchBatchVerifier over ``mesh``): (seconds, the verifier, its
    plan, the verdicts, (add, plan, execute) seconds), the wall ending in
    ``torch.cuda.synchronize()`` (an audited wait: phase 14 runs this
    inside the guard's window)."""
    import torch

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.ops import jitguard
    from cometbft_tpu_torch.ops.ed25519_verify import TorchBatchVerifier
    from cometbft_tpu_torch.parallel.mesh import ShardedTorchBatchVerifier

    t0 = time.perf_counter()
    if mesh is not None:
        bv = ShardedTorchBatchVerifier(mesh=mesh, cache=cache)
    elif cache is None:
        bv = create_batch_verifier(ed.Ed25519PubKey(triples[0][0]), device=dev)
    else:
        bv = TorchBatchVerifier(device=dev, cache=cache)
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    t1 = time.perf_counter()
    plan = bv.plan()
    t2 = time.perf_counter()
    ok, results = bv.execute(plan)
    with jitguard.audited():
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    return t3 - t0, bv, plan, results, (t1 - t0, t2 - t1, t3 - t2)


class LookupSplit:
    """The table lookup's parts while the block runs, each by host clock
    and by CUDA events on the current stream (the stream's span over the
    part: its kernels, copies and the gaps the host leaves): allocation
    and zeroing of pool tensors (_KeyPool._zeros), the build
    (build_tables_kernel), the rest of the page build (_build_pages: the
    keys' upload and the validity's copy back, which waits for the
    build), growth (stage_growth), the copy of the pages into the pool
    (add_keys: in place, or a copy-on-write of the pool) and compaction
    (compact); each part less the parts it calls.  It wraps those
    functions of ops/precompute.py for the block only; the port is
    unchanged.  ``take()`` returns {part: (host ms, stream ms)} of the
    calls since the last take."""

    PARTS = ("zeroing", "build", "upload/copy back", "growth", "pool copy", "compaction")

    def __init__(self):
        from cometbft_tpu_torch.ops import precompute as PR

        self.targets = [(PR._KeyPool, "_zeros", "zeroing"),
                        (PR, "build_tables_kernel", "build"),
                        (PR.KeyTableCache, "_build_pages", "upload/copy back"),
                        (PR._KeyPool, "stage_growth", "growth"),
                        (PR._KeyPool, "add_keys", "pool copy"),
                        (PR._KeyPool, "compact", "compaction")]
        self.saved, self.stack, self.calls = [], [], []

    def _wrap(self, fn, part):
        import torch

        def timed(*args, **kw):
            rec = dict(part=part, kids=[], ev=[torch.cuda.Event(enable_timing=True)
                                              for _ in range(2)])
            (self.stack[-1]["kids"] if self.stack else self.calls).append(rec)
            self.stack.append(rec)
            rec["ev"][0].record()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                rec["host"] = time.perf_counter() - t0
                rec["ev"][1].record()
                self.stack.pop()
        return timed

    def __enter__(self):
        for owner, attr, part in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, part))
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)

    def take(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {p: [0.0, 0.0] for p in self.PARTS}

        def walk(rec):
            host, dev = 1e3 * rec["host"], rec["ev"][0].elapsed_time(rec["ev"][1])
            for kid in rec["kids"]:
                kh, kd = walk(kid)
                out[rec["part"]][0] -= kh
                out[rec["part"]][1] -= kd
            out[rec["part"]][0] += host
            out[rec["part"]][1] += dev
            return host, dev

        for rec in self.calls:
            walk(rec)
        self.calls = []
        return {p: tuple(v) for p, v in out.items()}


def split_line(parts: dict, plan_ms: float) -> str:
    """The lookup split as one line: each part's host ms / stream ms, and
    the rest of the lookup on the host (key dedup, hashing, latches, the
    entry)."""
    rest = plan_ms - sum(h for h, _ in parts.values())
    return ", ".join(f"{p} {h:.3f} / {d:.3f}" for p, (h, d) in parts.items() if h or d) + (
        f"; the rest of the lookup {rest:.3f} ms on the host")


def drive(name: str, triples, expected, dev, warm_runs: int, window_bits: int,
          builds: bool, cache=None, b8_s: float | None = None) -> dict:
    """Cold verify with launch counts -- build_tables once where the set
    is cold (``builds``), sha512_keyed and verify_keyed once per slice,
    nothing else -- split into the table lookup (plan) and the rest, then
    warm VerifyCommit latency over ``warm_runs`` runs; a warm verify
    launches sha512_keyed and verify_keyed once per slice and no other
    kernel.  ``b8_s``: the seconds of b_comb8's first call, timed alone
    before the cold verify."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    n = len(triples)
    slices = -(-max(PR.next_pow2(n), 8) // EV.MAX_LAUNCH)
    want = {k: 0 for k in _build.LAUNCHES}
    want.update(verify_keyed=slices, sha512_keyed=slices)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with LookupSplit() as ls:
        cold, bv, plan, results, cold_split = run_verify(triples, dev, cache)
    launches = dict(_build.LAUNCHES)
    lookup = ls.take()
    peak = torch.cuda.max_memory_allocated()
    if bv.last_tier != "keyed":
        raise AssertionError(f"{name}: ran on tier {bv.last_tier}, not keyed")
    if plan.entry.window_bits != window_bits:
        raise AssertionError(f"{name}: window_bits {plan.entry.window_bits}")
    if results != expected:
        bad = [i for i, (a, b) in enumerate(zip(results, expected)) if a != b]
        raise AssertionError(f"{name}: verdicts differ from the oracle at {bad[:20]}")
    if launches != dict(want, build_tables=int(builds)):
        raise AssertionError(f"{name}: cold launches {launches}, expected "
                             f"{dict(want, build_tables=int(builds))}")
    lat, phases = [], []
    for i in range(warm_runs):
        if i == 0:
            _build.reset_launches()
        dt, bv, _, results, split = run_verify(triples, dev, cache)
        if i == 0:
            warm_launches = dict(_build.LAUNCHES)
        if results != expected or bv.last_tier != "keyed":
            raise AssertionError(f"{name}: warm run {i} differs")
        lat.append(dt)
        phases.append(split)
    if warm_launches != want:
        raise AssertionError(f"{name}: warm launches {warm_launches}, expected {want}")
    p50 = pct(lat, 50)
    out = dict(
        n=n, cold_s=cold, cold_split=cold_split, launches=launches,
        warm_launches=warm_launches,
        p50_ms=1e3 * p50, p90_ms=1e3 * pct(lat, 90), p95_ms=1e3 * pct(lat, 95),
        runs=warm_runs, sigs_per_s=n / p50, peak_mb=peak / 2**20,
        field_launches=launches["fe_mul"] + launches["fe_sq"],
        invalid=sum(not v for v in expected), plan=plan,
    )
    print(f"{name}: {n} lanes ({out['invalid']} invalid caught), tier keyed, "
          f"window_bits {window_bits}")
    print(f"  cold verify ({'tables built' if builds else 'tables warm'}) {cold:.3f} s; "
          f"launches {launches}")
    add_s, plan_s, exec_s = cold_split
    print(f"  cold split: " + (f"b_comb8 {b8_s:.3f} s (its first call, timed alone before), "
                               if b8_s is not None else "")
          + f"table lookup (plan: build_tables, growth and the copy into the pool) "
          f"{plan_s:.4f} s, the rest {add_s + exec_s:.4f} s (add {add_s:.4f}, execute "
          f"{exec_s:.4f})")
    print(f"  table lookup split, host ms / stream ms (CUDA events): "
          + split_line(lookup, 1e3 * plan_s))
    print(f"  warm VerifyCommit over {warm_runs} runs: p50 {out['p50_ms']:.2f} ms, "
          f"p90 {out['p90_ms']:.2f} ms, p95 {out['p95_ms']:.2f} ms; "
          f"{out['sigs_per_s']:.0f} sigs/s")
    add_ms, plan_ms, exec_ms = (1e3 * pct([p[j] for p in phases], 50) for j in range(3))
    out["exec_ms"] = exec_ms
    print(f"  warm phases, p50: add {add_ms:.3f} ms (create_batch_verifier + add x {n}), "
          f"plan {plan_ms:.3f} ms (key lookup, key ids), execute {exec_ms:.3f} ms "
          "(pack, copy in, sha512_keyed, verify_keyed, copy out)")
    print(f"  launches per warm verify: {warm_launches} ({slices} slice(s))")
    print(f"  peak device memory (cold run): {out['peak_mb']:.1f} MiB")
    return out


def check_fused(name: str, plan, expected, dev, prefixes=()) -> dict:
    """The sha512_keyed kernel against keyed_digest's plain route, and
    the fused verify_keyed kernel against its plain version
    (verify_keyed_plain: the curve, scalar and comb code around the
    fe_mul / fe_sq kernels) at every compiled group size G, on the
    plan's packed batch, slice by slice as verify_arrays_keyed cuts it:
    digests, verdicts and the limbs of [8]q must be equal on every lane,
    and the verdicts of the real lanes the oracle's.  Then each timed on
    the first slice, beside its bound; the G sweep marks the launcher's
    choice; ``prefixes`` adds the sweep on the first slice's first n
    lanes for each n given."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import precompute as PR

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
    oks, slices, err, sha_err = [], [], 0, 0
    for s in range(0, batch, EV.MAX_LAUNCH):
        rows = buf[:, s : s + EV.MAX_LAUNCH]
        digest = EV.keyed_digest(rows, bucket, nblocks)
        want_digest = EV.keyed_digest_plain(rows, bucket, nblocks)
        torch.cuda.synchronize()
        sha_err = max(sha_err, int((digest.int() - want_digest.int()).abs().max()))
        if sha_err != 0 or not torch.equal(digest, want_digest):
            bad = (digest != want_digest).any(0).nonzero().flatten().tolist()[:20]
            raise AssertionError(f"{name}: sha512_keyed differs from keyed_digest's plain "
                                 f"route at slice {s}, lanes {bad}")
        want_ok, want_q8 = EV.verify_keyed_plain(rows, digest, entry.table, key_valid,
                                                 b_table, bucket, wb)
        for g in EV.GROUPS:
            q8 = torch.empty((4, F.NLIMBS, rows.shape[1]), dtype=F.DTYPE, device=dev)
            ok = EV.verify_keyed_fused(rows, digest, entry.table, key_valid, b_table,
                                       bucket, wb, out_point=q8, group=g)
            torch.cuda.synchronize()
            e = int((q8.long() - want_q8.long()).abs().max())
            if e != 0 or not torch.equal(q8, want_q8) or not torch.equal(ok, want_ok):
                bad = (ok != want_ok).nonzero().flatten().tolist()[:20]
                raise AssertionError(f"{name}: verify_keyed G={g} differs from its plain "
                                     f"version at slice {s}: max |dq8| {e}, verdicts "
                                     f"differ at {bad}")
            err = max(err, e)
        oks.append(want_ok)
        slices.append((rows, digest))
    got = torch.cat(oks).cpu().numpy()[: len(expected)].tolist()
    if got != list(expected):
        raise AssertionError(f"{name}: verify_keyed verdicts differ from the oracle")
    rows, digest = slices[0]
    n = rows.shape[1]
    lib = _build.library("verify_keyed")
    chosen = lib.verify_keyed_group(n)

    def fused(g):
        return lambda: EV.verify_keyed_fused(rows, digest, entry.table, key_valid, b_table,
                                             bucket, wb, group=g)

    plain = lambda: EV.verify_keyed_plain(rows, digest, entry.table, key_valid, b_table,
                                          bucket, wb)
    bound, b_entries, k_entries, nbytes = vk_bound(rows, digest, bucket, wb)
    # the kernel runs for far longer than its host enqueue (~0.05 ms),
    # so back-to-back CUDA events time the kernel itself; torch.profiler
    # is printed beside the launcher's choice
    sweep = {}
    with SmiSampler() as smi:
        for g in EV.GROUPS:
            sweep[g] = cuda_ms(fused(g), 100)
        pfms = device_ms(fused(0), 50)
    pms = device_ms(plain, 2)
    print(f"verify_keyed {name}: {len(slices)} slice(s) of {n} lanes, window_bits {wb}: "
          f"exact against its plain version at G = {list(EV.GROUPS)} (verdicts and [8]q "
          f"limbs on every lane, = oracle); bound {bound[0] * 1e3:.3f} us ({bound[1]}; "
          f"{b_entries} + {k_entries} comb entries, {nbytes} bytes); plain "
          f"{pms * 1e3:10.2f} us device time; host pack_inputs of the {len(expected)} lanes "
          f"{pack_ms:.3f} ms")
    for g, ms in sweep.items():
        mark = "  <- launcher's choice" if g == chosen else ""
        print(f"  G={g:2d}: {ms * 1e3:9.2f} us/launch back-to-back at {n} lanes (CUDA "
              f"events), roofline share {bound[0] / ms:.4f}{mark}")
    print(f"  launcher's choice under torch.profiler: {pfms * 1e3:9.2f} us; while timed: "
          f"{smi.summary()}")
    for m in prefixes:
        sub, sub_digest = rows[:, :m], digest[:, :m].contiguous()
        times = {g: cuda_ms(lambda g=g: EV.verify_keyed_fused(
            sub, sub_digest, entry.table, key_valid, b_table, bucket, wb, group=g), 20)
            for g in EV.GROUPS}
        pick = lib.verify_keyed_group(m)
        print(f"  first {m} lanes: " + ", ".join(
            f"G={g} {t * 1e3:.2f} us" + (" (choice)" if g == pick else "")
            for g, t in times.items()))

    sha_bound, blocks = sha_keyed_bound(rows, bucket, nblocks)
    digest_fn = lambda: EV.keyed_digest(rows, bucket, nblocks)
    # back to back by CUDA events: the wrapper's host path (checks, the
    # output's allocation; ~20 us) is longer than the kernel, so the
    # kernel's time is taken from its C launcher called with one output
    sha_lib = _build.library("sha512")
    out = torch.empty((64, n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lambda: sha_lib.sha512_keyed_launch(rows.data_ptr(), rows.stride(0), bucket, nblocks,
                                                 out.data_ptr(), n, stream, None, None)
    sms, wms = cuda_ms(launch, 200), cuda_ms(digest_fn, 200)
    spfms = device_ms(digest_fn, 200)
    spms = device_ms(lambda: EV.keyed_digest_plain(rows, bucket, nblocks), 3)
    print(f"sha512_keyed {name}: exact against keyed_digest's plain route on every slice; "
          f"device {spfms * 1e3:8.2f} us/launch (torch.profiler); back to back (CUDA events) "
          f"{sms * 1e3:8.2f} us from the C launcher, {wms * 1e3:8.2f} us through the wrapper; at "
          f"{n} lanes of {int(blocks.min())}-{int(blocks.max())} blocks; plain "
          f"{spms * 1e3:9.2f} us; bound {sha_bound[0] * 1e3:.4f} us ({sha_bound[1]})")
    return dict(err=err, ms=sweep[chosen], plain_ms=pms, bound=bound, lanes=n, group=chosen,
                sweep=sweep, sha=dict(err=sha_err, ms=spfms, plain_ms=spms, bound=sha_bound))


def profile_warm(name: str, triples, dev, runs: int = 10, settle: int = 20) -> None:
    """``runs`` warm verifies under torch.profiler, per verify: the
    device's busy share (kernel and copy time over the wall), the
    kernels that take it, and the host operations that take the wall.
    (A window of one warm verify holds only ~4 events on the card, which
    the profiler may not flush; ten hold enough.)  The profiler's
    per-operation recording slows the host part of every verify it
    records, and the dispatch ladder's cost model learns from those
    verifies too, so ``settle`` unprofiled warm verifies follow: the
    model's estimate (an EWMA, alpha 0.2) keeps ~1 % of the profiled
    runs after 20."""
    from torch.profiler import ProfilerActivity, profile

    run_verify(triples, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = sum(run_verify(triples, dev)[0] for _ in range(runs)) / runs
    for _ in range(settle):
        run_verify(triples, dev)
    dev_events, host = _split_events(prof)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / runs
    if dev_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    print(f"profile: warm {name} verify, {runs} runs: wall {wall * 1e3:.2f} ms per verify "
          f"under the profiler, device busy {dev_ms:.3f} ms, busy share "
          f"{dev_ms / (wall * 1e3):.3f}, {sum(e.count for e in dev_events) / runs:.1f} "
          "kernels and copies on the card per verify")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3 / runs:7.3f} ms  calls "
              f"{e.count / runs:5.1f}  {e.key[:70]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3 / runs:7.3f} ms  calls "
              f"{e.count / runs:5.1f}  {e.key[:70]}")


# -- phase 7: the generic tier ------------------------------------------

GENERIC_KERNELS = ("fe_mul", "fe_sq", "sha512_padded", "sha512_keyed", "verify_keyed",
                   "verify_generic", "build_tables")


def drive_generic(name: str, triples, expected, dev, warm_runs: int, why: str) -> dict:
    """The generic tier through ``create_batch_verifier(...).verify()``
    (``why`` says what sends the set there): a cold verify
    launches exactly what a warm one does -- sha512_keyed and
    verify_generic once per slice, no table build -- then warm latency
    over ``warm_runs`` runs."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    n = len(triples)
    slices = -(-max(PR.next_pow2(n), 8) // EV.MAX_LAUNCH)
    want = {k: 0 for k in GENERIC_KERNELS}
    want.update(sha512_keyed=slices, verify_generic=slices)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    cold, bv, plan, results, _ = run_verify(triples, dev)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if bv.last_tier != "generic" or plan.entry is not None:
        raise AssertionError(f"{name}: ran on tier {bv.last_tier}, not generic")
    if results != expected:
        bad = [i for i, (a, b) in enumerate(zip(results, expected)) if a != b]
        raise AssertionError(f"{name}: verdicts differ from the oracle at {bad[:20]}")
    if launches != want:
        raise AssertionError(f"{name}: cold launches {launches}, expected {want}")
    lat, phases = [], []
    for i in range(warm_runs):
        if i == 0:
            _build.reset_launches()
        dt, bv, _, results, split = run_verify(triples, dev)
        if i == 0:
            warm_launches = dict(_build.LAUNCHES)
        if results != expected or bv.last_tier != "generic":
            raise AssertionError(f"{name}: warm run {i} differs")
        lat.append(dt)
        phases.append(split)
    if warm_launches != want:
        raise AssertionError(f"{name}: warm launches {warm_launches}, expected {want}")
    p50 = pct(lat, 50)
    out = dict(n=n, cold_s=cold, launches=launches, p50_ms=1e3 * p50,
               p90_ms=1e3 * pct(lat, 90), p95_ms=1e3 * pct(lat, 95), runs=warm_runs,
               sigs_per_s=n / p50, peak_mb=peak / 2**20,
               invalid=sum(not v for v in expected), plan=plan)
    print(f"{name}: {n} lanes ({out['invalid']} invalid caught), tier generic ({why})")
    print(f"  cold verify {cold:.3f} s (no table build); launches {launches}, the same "
          "as a warm verify's")
    print(f"  warm VerifyCommit over {warm_runs} runs: p50 {out['p50_ms']:.2f} ms, "
          f"p90 {out['p90_ms']:.2f} ms, p95 {out['p95_ms']:.2f} ms; "
          f"{out['sigs_per_s']:.0f} sigs/s")
    add_ms, plan_ms, exec_ms = (1e3 * pct([p[j] for p in phases], 50) for j in range(3))
    out["exec_ms"] = exec_ms
    print(f"  warm phases, p50: add {add_ms:.3f} ms, plan {plan_ms:.3f} ms, execute "
          f"{exec_ms:.3f} ms (pack, copy in, sha512_keyed, verify_generic, copy out); "
          f"{slices} slice(s)")
    print(f"  peak device memory (cold run): {out['peak_mb']:.1f} MiB")
    return out


def vg_choice(lib, n: int) -> tuple[int, int]:
    """The launch shape verify_generic's launcher picks for n lanes."""
    import ctypes

    q, g = ctypes.c_int(), ctypes.c_int()
    lib.verify_generic_shape(n, ctypes.byref(q), ctypes.byref(g))
    return q.value, g.value


def check_generic(name: str, plan, expected, dev, prefixes=()) -> dict:
    """The verify_generic kernel against verify_generic_plain (the curve
    and scalar code around the fe_mul / fe_sq kernels) at every compiled
    launch shape, on the plan's packed batch, slice by slice as
    verify_arrays cuts it: verdicts and the limbs of [8]q equal on every
    lane, the real lanes' verdicts the oracle's; sha512_keyed held to
    keyed_digest_plain on the same (100 + bucket) rows.  Then each shape
    timed on the first slice beside the bound and per step of its
    critical path (VG_CHAIN), the launcher's choice marked; ``prefixes``
    adds the sweep on the first slice's first n lanes."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV

    t0 = time.perf_counter()
    packed, bucket = EV.pack_inputs(plan.pub, plan.sig, plan.msgs)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    batch = packed.shape[1]
    buf = torch.from_numpy(packed).to(dev)
    nblocks = EV.nblocks_for_bucket(bucket)
    oks, slices, err = [], [], 0
    for s in range(0, batch, EV.MAX_LAUNCH):
        rows = buf[:, s : s + EV.MAX_LAUNCH]
        digest = EV.keyed_digest(rows, bucket, nblocks)
        if not torch.equal(digest, EV.keyed_digest_plain(rows, bucket, nblocks)):
            raise AssertionError(f"{name}: sha512_keyed differs from keyed_digest_plain on "
                                 f"the generic rows at slice {s}")
        want_ok, want_q8 = EV.verify_generic_plain(rows, digest)
        for shape in EV.VG_SHAPES:
            ok, q8 = EV.verify_generic_fused(rows, digest, bucket, shape=shape, want_q=True)
            torch.cuda.synchronize()
            e = int((q8.long() - want_q8.long()).abs().max())
            if e != 0 or not torch.equal(q8, want_q8) or not torch.equal(ok, want_ok):
                bad = (ok != want_ok).nonzero().flatten().tolist()[:20]
                raise AssertionError(f"{name}: verify_generic {shape} differs from its plain "
                                     f"version at slice {s}: max |dq8| {e}, verdicts "
                                     f"differ at {bad}")
            err = max(err, e)
        oks.append(want_ok)
        slices.append((rows, digest))
    got = torch.cat(oks).cpu().numpy()[: len(expected)].tolist()
    if got != list(expected):
        raise AssertionError(f"{name}: verify_generic verdicts differ from the oracle")
    rows, digest = slices[0]
    n = rows.shape[1]
    lib = _build.library("verify_generic")
    chosen = vg_choice(lib, n)

    def fused(shape, r=rows, d=digest):
        return lambda: EV.verify_generic_fused(r, d, bucket, shape=shape)

    bound, b_entries, nbytes = vg_bound(rows)
    # CUDA events only: on an H100, torch.profiler lost most or all of
    # ten 8192-lane launches of this kernel (once it recorded no device
    # time at all)
    iters = 50 if n <= 1024 else 10
    sweep = {}
    with SmiSampler() as smi:
        for shape in EV.VG_SHAPES:
            sweep[shape] = cuda_ms(fused(shape), iters)
    mhz = smi.median_mhz() or 1980.0
    pms = device_ms(lambda: EV.verify_generic_plain(rows, digest), 1)
    print(f"verify_generic {name}: {len(slices)} slice(s) of {n} lanes: exact against its "
          f"plain version at every shape (Q, G) of {list(EV.VG_SHAPES)} (verdicts and [8]q "
          f"limbs on every lane, = oracle); bound {bound[0] * 1e3:.3f} us ({bound[1]}; "
          f"{b_entries} comb entries, {nbytes} bytes); plain {pms * 1e3:10.2f} us device "
          f"time; host pack_inputs of the {len(expected)} lanes {pack_ms:.3f} ms")
    fastest = min(sweep, key=sweep.get)
    for shape, ms in sweep.items():
        mark = "  <- launcher's choice" if shape == chosen else ""
        mark += "  (fastest)" if shape == fastest else ""
        chain = vg_chain(shape)
        print(f"  (Q, G) = {shape}: {ms * 1e3:9.2f} us/launch back-to-back at {n} lanes "
              f"(CUDA events), roofline share {bound[0] / ms:.4f}; chain {chain} steps, "
              f"{ms * 1e3 / chain:.4f} us = {ms * 1e-3 * mhz * 1e6 / chain:.0f} cycles "
              f"per step{mark}")
    print(f"  while timed: {smi.summary()} (cycles at the median)")
    for m in prefixes:
        sub, sub_digest = rows[:, :m], digest[:, :m].contiguous()
        times = {shape: cuda_ms(fused(shape, sub, sub_digest), 10) for shape in EV.VG_SHAPES}
        pick, best = vg_choice(lib, m), min(times, key=times.get)
        sub_bound = vg_bound(sub)[0][0]
        print(f"  first {m} lanes (bound {sub_bound * 1e3:.3f} us): " + ", ".join(
            f"{shape} {t * 1e3:.2f} us ({sub_bound / t:.3f})" + (" (choice)" if shape == pick
                                                                 else "")
            for shape, t in times.items()) + f"; fastest {best}"
              + ("" if best == pick else f", not the choice {pick}"))
    return dict(err=err, ms=sweep[chosen], plain_ms=pms, bound=bound, lanes=n, shape=chosen,
                sweep=sweep)


# One worker of oracle_verdicts: reads a pickled list of (pub, msg, sig)
# from stdin and writes the pickled verdicts to stdout.
_ORACLE_WORKER = (
    "import pickle, sys\n"
    "from cometbft_tpu_torch.crypto import edwards as E\n"
    "triples = pickle.load(sys.stdin.buffer)\n"
    "pickle.dump([E.verify_zip215(p, m, s) for p, m, s in triples], sys.stdout.buffer)\n"
)


def oracle_verdicts(triples) -> list[bool]:
    """The oracle's verdict on every lane, in worker processes (plain
    subprocesses, not multiprocessing, which would leave its resource
    tracker running; every worker is reaped, or killed, before this
    returns)."""
    import pickle

    workers = max(1, min(8, os.cpu_count() or 1))
    step = -(-len(triples) // workers)
    chunks = [triples[i : i + step] for i in range(0, len(triples), step)]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for chunk in chunks:
            proc = subprocess.Popen([sys.executable, "-c", _ORACLE_WORKER], cwd=root,
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            procs.append(proc)
            # The worker reads all of its input before it computes, and
            # its output is a few KB: writing each in turn cannot block.
            proc.stdin.write(pickle.dumps([tuple(t) for t in chunk]))
            proc.stdin.close()
        verdicts = []
        for proc in procs:
            out = proc.stdout.read()
            if proc.wait(timeout=600) != 0:
                raise RuntimeError(f"oracle worker exited {proc.returncode}")
            verdicts += pickle.loads(out)
        return verdicts
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def make_wide(nkeys: int):
    """``nkeys`` distinct keys, each signing one 120-byte vote: a set
    larger than precompute.TABLE_MAX_KEYS, which no table is built for.
    Key i is a0 + i and its nonce r0 + i, so A and R come by one point
    addition each instead of a scalar multiplication; the signatures are
    valid Ed25519 signatures (only the nonces are not RFC 8032's).  Three
    lanes, one in each of three slices, carry an altered message; the
    oracle decides every lane."""
    from cometbft_tpu_torch.crypto import edwards as E

    t0 = time.perf_counter()
    rs = np.random.RandomState(SEED + nkeys)
    a0, r0 = (int.from_bytes(rs.bytes(32), "little") % E.L for _ in range(2))
    a_pt, r_pt = E.pt_mul(a0, E.B_POINT), E.pt_mul(r0, E.B_POINT)
    triples = []
    for i in range(nkeys):
        pub, r_enc = E.encode_point(a_pt), E.encode_point(r_pt)
        head = b"vote|h=1|r=0|val=%05d|" % i
        msg = head + rs.bytes(120 - len(head))
        k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % E.L
        s = (r0 + i + k * (a0 + i)) % E.L
        triples.append([pub, msg, r_enc + s.to_bytes(32, "little")])
        a_pt, r_pt = E.pt_add(a_pt, E.B_POINT), E.pt_add(r_pt, E.B_POINT)
    for pos in (100, 8192 + 5, nkeys - 1):
        triples[pos][1] = triples[pos][1] + b"!"
    t1 = time.perf_counter()
    expected = oracle_verdicts(triples)
    print(f"generic-wide data: {nkeys} distinct keys made in {t1 - t0:.2f} s, the oracle's "
          f"verdicts in {time.perf_counter() - t1:.2f} s (worker processes)")
    if len({p for p, _, _ in triples}) != nkeys or sum(expected) != nkeys - 3:
        raise AssertionError("generic-wide: keys not distinct or verdicts not as planted")
    return triples, expected


def oracle_floor(triples) -> float:
    """Host seconds of the per-signature oracle over ``triples``: the
    route a table-less batch took before the generic tier."""
    from cometbft_tpu_torch.crypto import edwards as E

    t0 = time.perf_counter()
    for p, m, s in triples:
        E.verify_zip215(p, m, s)
    secs = time.perf_counter() - t0
    print(f"oracle floor: {len(triples)} verify_zip215 calls in {secs:.3f} s on the host "
          f"({len(triples) / secs:.0f} sigs/s)")
    return secs


def check_commit_step(triples, expected, dev, heights: int = 4) -> None:
    """``models.commit.commit_verify_step`` on a (heights, V) batch of
    the commit's votes, one lane per height altered, against the oracle:
    one sha512_keyed and one verify_generic launch per slice."""
    import torch

    from cometbft_tpu_torch.crypto import edwards as E
    from cometbft_tpu_torch.models import commit as M
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV

    nval = len(triples)
    pub = np.zeros((32, heights, nval), dtype=np.uint8)
    sig = np.zeros((64, heights, nval), dtype=np.uint8)
    msg = np.zeros((M.MSG_BUCKET, heights, nval), dtype=np.uint8)
    msglen = np.zeros((heights, nval), dtype=np.int32)
    want = np.zeros((heights, nval), dtype=bool)
    for h in range(heights):
        for v, (p, m, s) in enumerate(triples):
            if v == 7 * h + 1:
                m = m[:-1] + bytes([m[-1] ^ 1])
            pub[:, h, v] = np.frombuffer(p, dtype=np.uint8)
            sig[:, h, v] = np.frombuffer(s, dtype=np.uint8)
            msg[: len(m), h, v] = np.frombuffer(m, dtype=np.uint8)
            msglen[h, v] = len(m)
            want[h, v] = expected[v] if v != 7 * h + 1 else E.verify_zip215(p, m, s)
    _build.reset_launches()
    t0 = time.perf_counter()
    got = M.commit_verify_step(pub, sig, msg, msglen, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if got.shape != (heights, nval) or got.dtype != torch.bool:
        raise AssertionError(f"commit_verify_step: {tuple(got.shape)} {got.dtype}")
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("commit_verify_step: verdicts differ from the oracle")
    slices = -(-heights * nval // EV.MAX_LAUNCH)
    if launches != {"sha512_keyed": slices, "verify_generic": slices}:
        raise AssertionError(f"commit_verify_step: launches {launches}")
    print(f"commit_verify_step ({heights}, {nval}): = oracle ({int((~want).sum())} invalid "
          f"caught), {secs * 1e3:.2f} ms first call, launches {launches}")


# -- phases 7-8: the validator-set change -----------------------------

def verify_with_entry(entry, triples) -> list[bool]:
    """Verdicts of ``triples`` through the keyed path on a given entry
    (no lookup): the check that an older entry still verifies its set."""
    from cometbft_tpu_torch.ops import ed25519_verify as EV

    pubs = [p for p, _, _ in triples]
    pub = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(-1, 32)
    sig = np.frombuffer(b"".join(s for _, _, s in triples), dtype=np.uint8).reshape(-1, 64)
    out = EV.verify_arrays_keyed(entry, entry.key_ids(pubs), pub, sig, [m for _, m, _ in triples])
    return [bool(v) for v in out]


def rotation(name: str, dev, commit, expected, newcomers, new_exp, cap_bytes: int,
             evicts: bool, prior=None, heights: int = 20) -> dict:
    """The validator-set change on a fresh KeyTableCache(dev, cap_bytes):
    ``prior`` (triples, verdicts) first when given, then the commit's
    set, then ``heights`` heights, height h with validators 0..h-1
    replaced by newcomers 0..h-1 -- one cold key per height.  At every
    height: verdicts = the oracle's, one build_tables launch, and
    ``stats`` as the policy says (every key built once; with ``evicts``,
    each height evicts exactly one key, none before).  Afterwards the entry taken before the first
    eviction verifies its own batch.  Returns the one-key cold verify
    latencies."""
    import torch

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR

    cache = PR.KeyTableCache(dev, cap_bytes=cap_bytes)
    built = 0
    first = None
    if prior is not None:
        _, bv, plan, res, _ = run_verify(prior[0], dev, cache)
        if res != prior[1] or bv.last_tier != "keyed":
            raise AssertionError(f"{name}: the prior set's verdicts differ")
        first, first_batch = plan.entry, prior
        built += len({p for p, _, _ in prior[0]})
    cold0, bv, plan, res, _ = run_verify(commit, dev, cache)
    if res != expected or bv.last_tier != "keyed":
        raise AssertionError(f"{name}: the commit's verdicts differ")
    built += len({p for p, _, _ in commit})
    if first is None:
        first, first_batch = plan.entry, (commit, expected)
    if cache.stats != {"keys_built": built, "keys_evicted": 0}:
        raise AssertionError(f"{name}: stats {cache.stats} before the rotations")
    lat, plan_s, parts = [], [], []
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for h in range(1, heights + 1):
        triples = list(newcomers[:h]) + list(commit[h:])
        want = list(new_exp[:h]) + list(expected[h:])
        n0 = _build.LAUNCHES["build_tables"]
        with LookupSplit() as ls:
            dt, bv, plan, res, split = run_verify(triples, dev, cache)
        parts.append(ls.take())
        if res != want or bv.last_tier != "keyed" or plan.entry.window_bits != 8:
            bad = [i for i, (a, b) in enumerate(zip(res, want)) if a != b]
            raise AssertionError(f"{name}: height {h} verdicts differ at {bad[:20]} "
                                 f"(tier {bv.last_tier})")
        stats = {"keys_built": built + h, "keys_evicted": h if evicts else 0}
        if cache.stats != stats or _build.LAUNCHES["build_tables"] != n0 + 1:
            raise AssertionError(f"{name}: height {h}: stats {cache.stats}, expected {stats}; "
                                 f"build_tables launches {_build.LAUNCHES['build_tables'] - n0}")
        lat.append(dt)
        plan_s.append(split[1])
    launches = dict(_build.LAUNCHES)
    if launches != dict({k: 0 for k in launches}, build_tables=heights,
                        sha512_keyed=heights, verify_keyed=heights):
        raise AssertionError(f"{name}: launches over the heights {launches}")
    if verify_with_entry(first, first_batch[0]) != list(first_batch[1]):
        raise AssertionError(f"{name}: the entry taken before the first eviction no longer "
                             "verifies its own batch")
    pool = cache._pools[8]
    torch.cuda.synchronize()
    split_p50 = {p: (pct([x[p][0] for x in parts], 50), pct([x[p][1] for x in parts], 50))
                 for p in LookupSplit.PARTS}
    out = dict(p50_ms=1e3 * pct(lat, 50), max_ms=1e3 * max(lat),
               plan_p50_ms=1e3 * pct(plan_s, 50), cold0_s=cold0, stats=dict(cache.stats),
               cap=pool.cap, launches=launches,
               peak_above_mb=(torch.cuda.max_memory_allocated() - base) / 2**20)
    print(f"rotation {name}: cap_bytes {cap_bytes} ({cap_bytes / 2**20:.1f} MiB); the "
          f"commit's set cold in {cold0:.4f} s; {heights} heights, one new key each: cold "
          f"verify p50 {out['p50_ms']:.2f} ms, max {out['max_ms']:.2f} ms (table lookup p50 "
          f"{out['plan_p50_ms']:.2f} ms); = oracle at every height; stats {cache.stats}; "
          f"8-bit pool {len(pool.slots)} keys in {pool.cap} slots; peak device memory "
          f"{out['peak_above_mb']:.1f} MiB above the allocation before the heights; launches "
          f"{launches}; the entry taken before the first height still verifies its own batch")
    print(f"  table lookup split per height, p50, host ms / stream ms (CUDA events): "
          + split_line(split_p50, out["plan_p50_ms"]))
    return out


def drive_10k(wide, wide_exp, dev, nkeys: int = 10000, nsample: int = 512) -> dict:
    """commit10k: the first 10000 of generic-wide's triples, two keys
    replaced by an encoding that does not decode and a small-order point
    (the oracle decides them), as one set on the keyed tier (4-bit) on a
    fresh KeyTableCache: cold and warm verifies, the pool's pages of 512
    keys (the two invalid ones included) held to build_tables_plain, and
    the build of those keys at every shape pair of each launch held to it
    too, and the build of all 10000 keys timed by CUDA events at every
    shape of each launch."""
    import torch

    from cometbft_tpu_torch.crypto import edwards as E
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR

    triples = [list(t) for t in wide[:nkeys]]
    exp = list(wide_exp[:nkeys])
    bad = next(bytes([j]) + bytes(31) for j in range(2, 255)
               if E.decode_point(bytes([j]) + bytes(31)) is None)
    triples[40][0] = bad
    triples[50][0] = E.small_order_points()[1]
    triples[50][2] = E.encode_point(E.IDENTITY) + bytes(32)
    for i in (40, 50):
        exp[i] = E.verify_zip215(*triples[i])
    cache = PR.KeyTableCache(dev)
    out = drive("commit10k", triples, exp, dev, warm_runs=5, window_bits=4, builds=True,
                cache=cache)
    entry = out.pop("plan").entry
    keys = sorted({p for p, _, _ in triples})
    sample = [bad, triples[50][0]] + [k for k in keys
                                      if k not in (bad, triples[50][0])][: nsample - 2]
    sample_pub = key_tensor(sample, dev)
    want, want_valid = PR.build_tables_plain(sample_pub, 4)
    idx = torch.as_tensor(np.concatenate(
        [np.arange(16) + 16 * entry.key_index[k] for k in sample])).to(dev)
    got = entry.table.index_select(3, idx)
    got_valid = torch.as_tensor(entry.valid[[entry.key_index[k] for k in sample]]).to(dev)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(got_valid, want_valid):
        raise AssertionError("commit10k: the pool's pages differ from build_tables_plain")
    if want_valid.tolist()[:2] != [False, True]:
        raise AssertionError("commit10k: the planted keys' validity")
    del got, entry
    lib = _build.library("build_tables")
    sample_pick = (bt_choice(lib, nsample, 1), bt_choice(lib, nsample * 64, 2))
    check_build_shapes("commit10k's sample", sample_pub, 4, want, want_valid,
                       bt_variants(sample_pick))
    del want
    pub = key_tensor(keys, dev)
    pick = (bt_choice(lib, len(keys), 1), bt_choice(lib, len(keys) * 64, 2))
    times, clocks = sweep_build(pub, 4, bt_variants(pick), 2)
    ms = times[pick]
    bound = bt_bound(len(keys), 4)
    out.update(build_ms=ms, bound=bound, pool_mb=cache._pools[4].nbytes() / 2**20)
    print(f"  commit10k pool: {len(cache._pools[4].slots)} keys in {cache._pools[4].cap} "
          f"slots, {out['pool_mb']:.1f} MiB; the pages of {len(sample)} keys (2 invalid) = "
          f"build_tables_plain, and the build of those keys at every shape pair of each "
          f"launch (pick {sample_pick}); the build of {len(keys)} keys {ms:.3f} ms (CUDA "
          f"events) at the pick {pick}, {ms * 1e3 / len(keys):.2f} us per key, bound "
          f"{bound[0]:.3f} ms ({bound[1]}; with a 2dT per entry "
          f"{bt_bound(len(keys), 4, True)[0]:.3f}), "
          f"share {bound[0] / ms:.4f}; {clocks}")
    print_build_sweep(times, pick, bound[0])
    cache.clear()
    return out


# -- phase 10: the dispatch ladder and the host tier -------------------

def check_ladder(phase: str) -> None:
    """Outside the chaos phase the dispatch ladder must hold no fault:
    no tier demoted, no transition recorded.  And the cost model must
    rank keyed first for commit150's and commit1024's shape buckets (256
    and 1024): no adopted order there puts another tier first, and no
    tier's learned estimate beats keyed's by the reorder margin."""
    from cometbft_tpu_torch.crypto import dispatch as D

    snap = D.LADDER.snapshot()
    demoted = [t for t, st in snap["tiers"].items() if st["demoted"] or st.get("demotions")]
    if demoted or snap["transitions"]:
        raise AssertionError(f"{phase}: the dispatch ladder recorded a fault outside the "
                             f"chaos phase: demoted {demoted}, transitions "
                             f"{snap['transitions']}")
    cost = D.LADDER.cost_snapshot()
    margin = 1.0 + cost["policy"]["margin"]
    for bucket in (256, 1024):
        est = {r["tier"]: r["sigs_per_sec"] for r in cost["table"]
               if r["bucket"] == bucket and r["participating"]}
        orders = [r["order"] for r in cost["orders"]
                  if r["bucket"] == bucket and "keyed" in r["candidates"]]
        faster = [t for t, v in est.items() if "keyed" in est and v > est["keyed"] * margin]
        if faster or any(o[0] != "keyed" for o in orders):
            raise AssertionError(f"{phase}: the cost model does not rank keyed first for "
                                 f"bucket {bucket}: estimates (sigs/s) {est}, adopted "
                                 f"orders {orders}")


def threshold_phase(dev) -> int:
    """The calibrated device threshold: the link's round trip
    (_measure_link_rtt) and runtime_device_min_batch from it.  A batch
    of commit150's 150 lanes must take the device unless n* > 150."""
    from cometbft_tpu_torch.ops import ed25519_verify as EV

    rtt = EV._measure_link_rtt(dev)
    threshold = EV.runtime_device_min_batch(dev)
    n_star = rtt / (EV._DEFAULT_T_CPU_SIG - EV._DEFAULT_T_DEV_SIG)
    print(f"threshold: link round trip {rtt * 1e6:.1f} us (least of 3 8-byte round trips), "
          f"n* = rtt / (t_cpu - t_dev) = {n_star:.2f} with t_cpu "
          f"{EV._DEFAULT_T_CPU_SIG * 1e6:.0f} us and t_dev {EV._DEFAULT_T_DEV_SIG * 1e6:.0f} us "
          f"per signature: {EV.crossover_batch(rtt)}; runtime_device_min_batch (its own "
          f"probe) = {threshold}")
    if threshold > 150:
        print(f"  n* exceeds commit150's 150 lanes: the round trip alone costs more than the "
              f"host tier's {150 * EV._DEFAULT_T_CPU_SIG * 1e3:.2f} ms for 150 signatures, so "
              f"commit150 takes the host tier and the keyed phases below fail")
    return threshold


def valid_commit(nval: int, tag: bytes):
    """make_commit's votes without the planted lanes and without the
    oracle pass (every signature valid by construction)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    rs = np.random.RandomState(SEED + nval)
    privs = [ed.priv_key_from_secret(tag + b"-%d" % i) for i in range(nval)]
    triples = []
    for i, priv in enumerate(privs):
        head = b"vote|h=1|r=0|val=%05d|" % i
        msg = head + rs.randint(0, 256, 120 - len(head)).astype(np.uint8).tobytes()
        triples.append([priv.pub_key().bytes(), msg, priv.sign(msg)])
    return triples, privs


def host_rlc_ms(triples, reps: int) -> tuple[float, float]:
    """p50 ms of one ``rlc_verify`` call on ``triples`` (the Python
    scalars and the C check), and of its C check alone."""
    from cometbft_tpu_torch.crypto import ed25519_native as nat

    class Timed:
        """The library, with its one call timed."""

        def __init__(self, lib):
            self.lib, self.secs = lib, 0.0

        def cmt_ed25519_rlc_verify(self, *args):
            t0 = time.perf_counter()
            rc = self.lib.cmt_ed25519_rlc_verify(*args)
            self.secs = time.perf_counter() - t0
            return rc

    lib = Timed(nat.load())
    entries = [tuple(t) for t in triples]
    lat, c_lat = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        nat.rlc_verify(lib, entries)
        lat.append(time.perf_counter() - t0)
        c_lat.append(lib.secs)
    return 1e3 * pct(lat, 50), 1e3 * pct(c_lat, 50)


def host_cells(dev, threshold: int) -> dict:
    """Batches under the threshold, or with a message over 4096 bytes,
    through the entry point: each takes the host tier with the reason
    expected, verdicts = the oracle's on every lane; wall ms and us per
    signature through the verifier and for the RLC call alone."""
    import torch

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import ed25519_native as nat
    from cometbft_tpu_torch.crypto import edwards as E
    from cometbft_tpu_torch.ops import _build

    valid, privs = valid_commit(150, b"validator")
    # duplicate-vote evidence: one validator's two conflicting votes
    pa, pb = b"vote|h=7|r=0|block=A", b"vote|h=7|r=0|block=B"
    evidence = [[privs[9].pub_key().bytes(), m, privs[9].sign(m)] for m in (pa, pb)]
    invalid63 = [list(t) for t in valid[:63]]
    invalid63[17][1] = invalid63[17][1][:-1] + bytes([invalid63[17][1][-1] ^ 1])
    big = [list(t) for t in valid]
    big_msg = b"vote|h=1|r=0|val=00042|" + bytes(5000 - 23)
    big[42] = [privs[42].pub_key().bytes(), big_msg, privs[42].sign(big_msg)]
    cells = [
        ("host2", evidence, "batch_size", 20),
        ("host16", valid[:16], "batch_size", 20),
        ("host63", valid[:63], "batch_size", 20),
        ("host63-invalid", invalid63, "batch_size", 3),
        ("host-bigmsg", big, "msg_too_large" if threshold <= 150 else "batch_size", 10),
    ]
    out = {}
    for name, triples, reason, reps in cells:
        expected = [E.verify_zip215(*t) for t in triples]
        rlc_on = len(triples) >= ed.CpuBatchVerifier.NATIVE_MIN_BATCH
        lat = []
        _build.reset_launches()
        for _ in range(reps):
            dt, bv, plan, results, _ = run_verify(triples, dev)
            if bv.last_tier != "host" or plan.route != "host" or plan.reason != reason:
                raise AssertionError(f"{name}: tier {bv.last_tier}, route {plan.route}, "
                                     f"reason {plan.reason}; expected host, {reason}")
            if results != expected:
                raise AssertionError(f"{name}: verdicts differ from the oracle")
            lat.append(dt)
        if any(_build.LAUNCHES.values()):
            raise AssertionError(f"{name}: the host tier launched {_build.LAUNCHES}")
        torch.cuda.synchronize()
        p50 = 1e3 * pct(lat, 50)
        rlc, c_ms = host_rlc_ms(triples, reps) if rlc_on else (None, None)
        n = len(triples)
        out[name] = dict(n=n, p50_ms=p50, rlc_ms=rlc, c_ms=c_ms)
        print(f"{name}: {n} lanes ({n - sum(expected)} invalid), tier host ({reason}), = "
              f"oracle; p50 {p50:.3f} ms over {reps} verifies, {1e3 * p50 / n:.1f} us per "
              f"signature; " + (f"rlc_verify alone {rlc:.3f} ms, {1e3 * rlc / n:.1f} us per "
                               f"signature, its C check {c_ms:.3f} ms" if rlc is not None else
                               f"under NATIVE_MIN_BATCH = {ed.CpuBatchVerifier.NATIVE_MIN_BATCH}"
                               ": the per-signature oracle only"))
    if nat.rlc_verify(nat.load(), [tuple(t) for t in invalid63]) is not False:
        raise AssertionError("host63-invalid: the RLC check accepted an altered message")
    return out


def host_at_device_sizes(dev, commit150, exp150, p50_150, p50_1k, wide) -> dict:
    """CpuBatchVerifier alone at the device tiers' sizes, beside the
    keyed tier's warm p50 on the same lanes: the crossover the cost
    model learns.  All-valid batches are one RLC check; commit150 with
    its planted lanes also pays the per-signature re-verify."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import precompute as PR

    def host_ms(triples, reps):
        lat = []
        for _ in range(reps):
            cpu = ed.CpuBatchVerifier()
            for p, m, s in triples:
                cpu.add(ed.Ed25519PubKey(p), m, s)
            t0 = time.perf_counter()
            ok, results = cpu.verify()
            lat.append(time.perf_counter() - t0)
        return 1e3 * pct(lat, 50), results

    valid150, _ = valid_commit(150, b"validator")
    valid1k, _ = valid_commit(1024, b"validator1k")
    wide4k = [list(t) for t in wide[:4096]]
    wide4k[100][1] = wide4k[100][1][:-1]          # make_wide's altered lane, restored
    cache = PR.KeyTableCache(dev)
    run_verify(wide4k, dev, cache)
    lat = []
    for _ in range(10):
        dt, bv, _, results, _ = run_verify(wide4k, dev, cache)
        if bv.last_tier != "keyed" or not all(results):
            raise AssertionError(f"wide4096: tier {bv.last_tier} or verdicts")
        lat.append(dt)
    p50_4k = 1e3 * pct(lat, 50)
    cache.clear()
    out = {}
    for name, triples, keyed_ms, reps in (("commit150", valid150, p50_150, 10),
                                          ("commit1024", valid1k, p50_1k, 5),
                                          ("wide4096", wide4k, p50_4k, 3)):
        ms, results = host_ms(triples, reps)
        if not all(results):
            raise AssertionError(f"host tier at {name}: a valid signature rejected")
        rlc, c_ms = host_rlc_ms(triples, reps)
        n = len(triples)
        out[name] = dict(n=n, host_ms=ms, rlc_ms=rlc, c_ms=c_ms, keyed_ms=keyed_ms)
        print(f"host tier at device size, {name} ({n} lanes, all valid): CpuBatchVerifier "
              f"{ms:.3f} ms, {1e3 * ms / n:.2f} us per signature (rlc_verify alone {rlc:.3f} "
              f"ms, its C check {c_ms:.3f} ms); keyed tier warm p50 {keyed_ms:.3f} ms, "
              f"{1e3 * keyed_ms / n:.2f} us per "
              f"signature; host / keyed {ms / keyed_ms:.2f}x")
    ms, results = host_ms(commit150, 1)
    if results != exp150:
        raise AssertionError("host tier on commit150: verdicts differ from the oracle")
    out["commit150-planted"] = dict(n=len(commit150), host_ms=ms)
    print(f"host tier on commit150 with its planted lanes: {ms:.1f} ms ({1e3 * ms / 150:.0f} us "
          f"per signature): the RLC check fails and every lane is re-verified by the oracle")
    return out


def walk_overhead(dev, commit150, exp150, runs: int = 300) -> dict:
    """The ladder's bookkeeping on a warm commit150 verify: plan() beside
    the bare lookup it wraps, and execute() beside verify_arrays_keyed on
    the same plan, and beside itself with the launch watchdog stubbed
    out and with the metrics sinks set to no-ops; each ends in a
    synchronize, and their order rotates every run, so no variant always
    follows the same one.  Then the whole verify's p50 (add, plan,
    execute).  The cost model's estimates for commit150's shape bucket
    are printed first; the ladder is not reset."""
    import torch

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import health as H
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    cost = D.LADDER.cost_snapshot()
    learned = [(r["tier"], round(r["sigs_per_sec"]), r["samples"]) for r in cost["table"]
               if r["bucket"] == 256]
    orders = [r["order"] for r in cost["orders"] if r["bucket"] == 256]
    print(f"cost model before the walk phase, bucket 256: (tier, sigs/s, samples) {learned}; "
          f"adopted orders {orders or 'static'}")
    pubs = [p for p, _, _ in commit150]
    cache = PR.table_cache(dev)
    _, bv, plan, _, _ = run_verify(commit150, dev)
    cm, hm = M.crypto_metrics(), M.health_metrics()
    times = {k: [] for k in ("plan", "bare_plan", "execute", "no_watchdog", "no_metrics",
                             "direct", "whole")}
    phases = []
    p = bv.plan()

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        return out

    def bare():
        entry = cache.lookup_or_build(pubs)
        entry.key_ids(pubs)
        np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(-1, 32)
        np.frombuffer(b"".join(s for _, _, s in commit150), dtype=np.uint8).reshape(-1, 64)

    def walk(key):
        ok, res = timed(key, lambda: bv.execute(p))
        if res != exp150 or bv.last_tier != "keyed":
            raise AssertionError(f"walk overhead ({key}): tier {bv.last_tier} of walk "
                                 f"{p.tiers}, verdicts = oracle {res == exp150}; cost model "
                                 f"{D.LADDER.cost_snapshot()}")

    def no_watchdog():
        H.WATCHDOG.arm = lambda tier, batch=0: 0
        H.WATCHDOG.disarm = lambda token: False
        try:
            walk("no_watchdog")
        finally:
            del H.WATCHDOG.arm, H.WATCHDOG.disarm

    def no_metrics():
        M.install_crypto_metrics(None)
        M.install_health_metrics(None)
        try:
            walk("no_metrics")
        finally:
            M.install_crypto_metrics(cm)
            M.install_health_metrics(hm)

    def direct():
        out = timed("direct", lambda: EV.verify_arrays_keyed(p.entry, p.key_ids, p.pub, p.sig,
                                                             p.msgs))
        if out.tolist() != exp150:
            raise AssertionError("walk overhead: verify_arrays_keyed differs from the oracle")

    def whole():
        dt, bv2, _, res, split = run_verify(commit150, dev)
        if res != exp150 or bv2.last_tier != "keyed":
            raise AssertionError(f"walk overhead: a whole verify ran {bv2.last_tier}")
        times["whole"].append(dt)
        phases.append(split)

    variants = [lambda: timed("plan", bv.plan), lambda: timed("bare_plan", bare),
                lambda: walk("execute"), no_watchdog, no_metrics, direct, whole]
    for r in range(runs):
        for k in range(len(variants)):
            variants[(r + k) % len(variants)]()
    out = {k: 1e3 * pct(v, 50) for k, v in times.items()}
    add_ms, plan_ms, exec_ms = (1e3 * pct([s[j] for s in phases], 50) for j in range(3))
    print(f"walk overhead, commit150 warm, {runs} runs, order rotated, p50: plan "
          f"{out['plan']:.3f} ms vs the bare lookup {out['bare_plan']:.3f} ms "
          f"(+{out['plan'] - out['bare_plan']:.3f}); execute {out['execute']:.3f} ms vs "
          f"verify_arrays_keyed {out['direct']:.3f} ms (+{out['execute'] - out['direct']:.3f}); "
          f"the ladder's bookkeeping "
          f"{1e3 * (out['plan'] - out['bare_plan'] + out['execute'] - out['direct']):.0f} us "
          f"per verify; execute with the watchdog stubbed {out['no_watchdog']:.3f} ms, with "
          f"no-op metrics {out['no_metrics']:.3f} ms")
    print(f"  warm VerifyCommit through the ladder: p50 {out['whole']:.3f} ms (add {add_ms:.3f}"
          f" / plan {plan_ms:.3f} / execute {exec_ms:.3f}); the tree before the ladder: "
          f"chip_smoke.py --warm150 on it, in the same call")
    return out


def warm150(runs: int = 200) -> int:
    """commit150's warm VerifyCommit p50 and its add / plan / execute
    split, through create_batch_verifier, on the port found first on
    sys.path, as one JSON line.  Uses only what every tree of the port
    has since the keyed tier."""
    import torch

    from cometbft_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cometbft_tpu_torch

    dev = torch.device("cuda", 0)
    _build.build_all()
    commit, expected = make_commit(150, b"validator", plant=True)
    lat, phases = [], []
    for i in range(runs + 5):
        dt, bv, _, results, split = run_verify(commit, dev)
        if results != expected or bv.last_tier != "keyed":
            raise AssertionError(f"warm150: run {i} tier {bv.last_tier}, verdicts = oracle "
                                 f"{results == expected}")
        if i >= 5:
            lat.append(dt)
            phases.append(split)
    add_ms, plan_ms, exec_ms = (1e3 * pct([s[j] for s in phases], 50) for j in range(3))
    print(json.dumps({"tree": os.path.dirname(os.path.abspath(cometbft_tpu_torch.__file__)),
                      "runs": runs, "p50_ms": 1e3 * pct(lat, 50), "add_ms": add_ms,
                      "plan_ms": plan_ms, "execute_ms": exec_ms, "smi": smi_line()}))
    return 0


def chaos_phase(dev, commit150, exp150) -> list:
    """The ladder under planted faults, with demote_after 1 and a 1 s
    cool-down on an injected clock: a device loss on keyed (generic
    answers), then on generic too (host answers); past the cool-down a
    clean half-open trial re-admits keyed; a launch hang on keyed under a
    1 s watchdog budget (the watchdog fires, device_hangs_total counts 1,
    generic answers).  Every batch's verdicts = the oracle's.  The
    ladder and chaos are reset before and after."""
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import health as H

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    D.LADDER.reset(demote_after=1, cooldown_s=1.0, cooldown_max_s=8.0, clock=clock)
    hangs0 = M.health_metrics().device_hangs_total.labels().get()
    budget = H.WATCHDOG.budget_s
    steps = []
    try:
        def step(what, want_tier):
            t0 = time.perf_counter()
            _, bv, plan, results, _ = run_verify(commit150, dev)
            secs = time.perf_counter() - t0
            if bv.last_tier != want_tier or results != exp150:
                raise AssertionError(f"chaos, {what}: tier {bv.last_tier} (expected "
                                     f"{want_tier}), verdicts = oracle {results == exp150}")
            steps.append((what, plan.tiers, bv.last_tier, secs))
            print(f"  chaos, {what}: walk {plan.tiers}, answered by {bv.last_tier} in "
                  f"{secs * 1e3:.1f} ms, = oracle")

        D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed",))
        step("device_loss on keyed", "generic")
        keyed = D.LADDER.snapshot()["tiers"]["keyed"]
        if not keyed["demoted"] or keyed["last_reason"] != "chaos:device_loss":
            raise AssertionError(f"chaos: keyed not demoted as expected: {keyed}")
        D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed", "generic"))
        step("device_loss on keyed and generic", "host")
        clock.t += 1.5
        D.CHAOS.load(None)
        step("clean, past the cool-down (half-open trial)", "keyed")
        step("clean, next verify", "keyed")
        H.WATCHDOG.budget_s = 1.0
        D.CHAOS.load(D.ChaosPlan.parse("launch_hang@0-3600"), tiers=("keyed",))
        step("launch_hang on keyed, 1 s watchdog budget", "generic")
        deadline = time.time() + 10
        while M.health_metrics().device_hangs_total.labels().get() == hangs0:
            if time.time() > deadline:
                raise AssertionError("chaos: the watchdog never counted the hang")
            time.sleep(0.01)
        hangs = M.health_metrics().device_hangs_total.labels().get() - hangs0
        snap = D.LADDER.snapshot()
        trail = [(e["kind"], e["from"], e["to"], e["reason"]) for e in snap["transitions"]]
        want = [("demote", "keyed", "generic", "chaos:device_loss"),
                ("demote", "generic", "host", "chaos:device_loss"),
                ("promote", "keyed", "keyed", "trial_success"),
                ("demote", "keyed", "generic", "watchdog"),
                ("demote", "keyed", "generic", "chaos:launch_hang"),
                ("promote", "generic", "generic", "trial_success")]
        # one back-off step for the hang: 1 s, doubled at the first demotion
        # and again at the watchdog's, not at the chaos fault's duplicate
        if trail != want or hangs != 1 or snap["tiers"]["keyed"]["next_cooldown_s"] != 4.0:
            raise AssertionError(f"chaos: transitions {trail}, hangs {hangs}, keyed "
                                 f"{snap['tiers']['keyed']}")
        print(f"chaos: transitions {trail}; device_hangs_total +{hangs:.0f}; keyed "
              f"next_cooldown_s {snap['tiers']['keyed']['next_cooldown_s']}")
    finally:
        H.WATCHDOG.budget_s = budget
        D.CHAOS.load(None)
        D.LADDER.reset()
    return steps


# -- phase 11: the verify-ahead plane ---------------------------------

#: commit150's planted lanes (make_commit), the same in every copy
PLANTED = (3, 10, 20, 30, 40, 50)


def live_threads() -> set[str]:
    """Names of the live threads but the launch watchdog's (a
    process-wide daemon, stopped when the script ends)."""
    return {t.name for t in threading.enumerate() if t.name != "crypto-watchdog"}


def launched() -> dict:
    from cometbft_tpu_torch.ops import _build

    return {k: v for k, v in _build.LAUNCHES.items() if v}


def end_phase(name: str, threads_before: set[str]) -> dict:
    """The phase's launch counts; fails if it left a thread behind."""
    from cometbft_tpu_torch.ops import _build

    deadline = time.time() + 10
    while live_threads() - threads_before and time.time() < deadline:
        time.sleep(0.01)
    left = live_threads() - threads_before
    if left:
        raise AssertionError(f"{name}: threads left behind: {sorted(left)}")
    return launched()


class FastSigner:
    """Ed25519 signatures over any bytes whose nonces are r0, r0 + 1, ...
    (mod L), so R costs one point addition instead of a scalar
    multiplication: valid signatures at tens of microseconds each.  The
    nonces are not RFC 8032's."""

    def __init__(self, r0: int) -> None:
        from cometbft_tpu_torch.crypto import edwards as E

        self.E = E
        self.r = r0 % E.L
        self.r_pt = E.pt_mul(self.r, E.B_POINT)

    def sign(self, a: int, pub: bytes, msg: bytes) -> bytes:
        return self.sign_all([(a, pub, msg)])[0]

    def sign_all(self, jobs) -> list[bytes]:
        """The signatures of ``jobs`` ((scalar, public key, message) each)
        with the next nonces in turn, one field inversion for all their R
        encodings (Montgomery's trick)."""
        E, P = self.E, self.E.P
        pts, pt = [], self.r_pt
        for _ in jobs:
            pts.append(pt)
            pt = E.pt_add(pt, E.B_POINT)
        prefix, acc = [], 1
        for q in pts:
            prefix.append(acc)
            acc = acc * q[2] % P
        inv, zinv = pow(acc, P - 2, P), [0] * len(pts)
        for i in range(len(pts) - 1, -1, -1):
            zinv[i] = prefix[i] * inv % P
            inv = inv * pts[i][2] % P
        sigs, r = [], self.r
        for (a, pub, msg), q, zi in zip(jobs, pts, zinv):
            x, y = q[0] * zi % P, q[1] * zi % P
            r_enc = (y | ((x & 1) << 255)).to_bytes(32, "little")
            k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % E.L
            sigs.append(r_enc + ((r + k * a) % E.L).to_bytes(32, "little"))
            r += 1
        self.r, self.r_pt = r, pt
        return sigs


def seeded_keys(tag: bytes, n: int, pubs=None) -> list:
    """(scalar, public key) of the keys ``make_commit`` derives from
    ``tag``; ``pubs`` (a commit's triples) saves the scalar
    multiplications for all but its planted lanes 40 and 50."""
    from cometbft_tpu_torch.crypto import edwards as E

    out = []
    for i in range(n):
        seed = hashlib.sha256(tag + b"-%d" % i).digest()
        a, _ = E.secret_expand(seed)
        out.append((a, pubs[i][0] if pubs is not None and i not in (40, 50)
                    else E.public_key(seed)))
    return out


def resign(commit, tag: bytes, height: int, alter: int):
    """``commit``'s validators (the seeds make_commit derives from
    ``tag``) signing new 120-byte votes at ``height``, with FastSigner's
    nonces.  Lane ``alter`` gets one byte of S flipped."""
    rs = np.random.RandomState(SEED + 7919 * height + len(commit))
    signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
    out = []
    for i, (a, pub) in enumerate(seeded_keys(tag, len(commit), commit)):
        head = b"vote|h=%d|r=0|val=%05d|" % (height, i)
        msg = head + rs.bytes(120 - len(head))
        sig = signer.sign(a, pub, msg)
        if i == alter:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        out.append((pub, msg, sig))
    return out


def arrays(triples):
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    return pub, sig, [m for _, m, _ in triples]


def altered_jobs(triples, expected, njobs: int, start: int):
    """``njobs`` copies of the batch, copy j with one byte of S flipped
    on one valid, unplanted lane (from ``start`` on; the messages keep
    their lengths, so packing takes the path the main cells take) ->
    (jobs as (pub, sig, msgs), each job's oracle verdicts)."""
    from cometbft_tpu_torch.crypto import edwards as E

    pub, sig, msgs = arrays(triples)
    lanes = [i for i in range(start, len(triples))
             if expected[i] and i % 150 not in PLANTED][:njobs]
    jobs, want = [], []
    for lane in lanes:
        s = sig.copy()
        s[lane, 40] ^= 1
        w = list(expected)
        w[lane] = E.verify_zip215(triples[lane][0], msgs[lane], s[lane].tobytes())
        jobs.append((pub, s, msgs))
        want.append(w)
    return jobs, want


def job_device_ms(job, dev, entry=None, key_ids=None, iters: int = 20) -> float:
    """The device time of one job's work alone: its rows packed once into
    pinned memory, then the copy in and the slices' launches (keyed on
    ``entry``, else generic) back to back under CUDA events (``cuda_ms``;
    their enqueue is far shorter than the work)."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.ops import field as F

    pub, sig, msgs = job
    packed, bucket = EV.pack_inputs(pub, sig, msgs, key_ids=key_ids)
    host = torch.from_numpy(packed).pin_memory()
    nblocks = EV.nblocks_for_bucket(bucket)
    if entry is not None:
        key_valid, b_table = entry.valid_device(), F.const(PR.b_comb8(), dev)

    def work():
        buf = host.to(dev, non_blocking=True)
        if entry is None:
            return EV.verify_generic_rows(buf, bucket)
        for s in range(0, buf.shape[1], EV.MAX_LAUNCH):
            rows = buf[:, s: s + EV.MAX_LAUNCH]
            EV.verify_keyed_fused(rows, EV.keyed_digest(rows, bucket, nblocks), entry.table,
                                  key_valid, b_table, bucket, entry.window_bits)

    return cuda_ms(work, iters)


def stream_cell(name: str, jobs, want, dispatch, dev_ms: float, smi: str,
                max_in_flight: int = 8) -> dict:
    """``verify_stream`` over ``jobs`` beside a synchronous loop
    (``_finish(dispatch(job))`` one job at a time) on the same jobs:
    sigs/s, the busy share (``dev_ms``, a job's device time from
    ``job_device_ms``, times the jobs, over each wall), the host's
    dispatch ms per job (packing, the copy's and the launches' enqueue)
    and launches per job; every verdict = the oracle's and the two
    paths' equal."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    nj, n = len(jobs), len(jobs[0][2])
    # a first stream run allocates the pinned blocks the caching host
    # allocator then reuses (a block comes back once its copy has run)
    t0 = time.perf_counter()
    warm = list(EV.verify_stream(iter(jobs[:2 * max_in_flight]), max_in_flight=max_in_flight,
                                 dispatch=dispatch))
    first_ms = 1e3 * (time.perf_counter() - t0) / len(warm)
    host = [0.0]

    def timed(*job):
        t = time.perf_counter()
        parts = dispatch(*job)
        host[0] += time.perf_counter() - t
        return parts

    _build.reset_launches()
    t0 = time.perf_counter()
    sync = [EV._finish(timed(*job)) for job in jobs]
    sync_wall = time.perf_counter() - t0
    sync_host, sync_launches = host[0], dict(_build.LAUNCHES)
    host[0] = 0.0
    _build.reset_launches()
    t0 = time.perf_counter()
    stream = list(EV.verify_stream(iter(jobs), max_in_flight=max_in_flight, dispatch=timed))
    stream_wall = time.perf_counter() - t0
    stream_host, stream_launches = host[0], dict(_build.LAUNCHES)
    for j, (a, b, w) in enumerate(zip(sync, stream, want)):
        if a.tolist() != w or b.tolist() != w:
            raise AssertionError(f"{name}: job {j} differs from the oracle (sync "
                                 f"{a.tolist() == w}, stream {b.tolist() == w})")
    slices = -(-max(PR.next_pow2(n), 8) // EV.MAX_LAUNCH)
    if sync_launches != stream_launches or sorted(v for v in stream_launches.values() if v) != [
            slices * nj] * 2:
        raise AssertionError(f"{name}: launches: sync {sync_launches}, stream "
                             f"{stream_launches}, expected two kernels x {slices} per job")
    per_job = {k: v / nj for k, v in stream_launches.items() if v}
    # the dispatch's packing alone (pageable, no key ids), on the jobs as
    # they are: one message length that differs takes the scatter path
    t0 = time.perf_counter()
    for pub, sig, msgs in jobs[:4]:
        EV.pack_inputs(pub, sig, msgs)
    pack_ms = 1e3 * (time.perf_counter() - t0) / min(4, nj)
    out = dict(jobs=nj, lanes=n, sync_sps=nj * n / sync_wall, stream_sps=nj * n / stream_wall,
               first_ms=first_ms, pack_ms=pack_ms,
               sync_busy=dev_ms * nj / (1e3 * sync_wall),
               stream_busy=dev_ms * nj / (1e3 * stream_wall),
               sync_host_ms=1e3 * sync_host / nj, stream_host_ms=1e3 * stream_host / nj,
               device_ms=dev_ms, launches_per_job=per_job)
    print(f"{name} [{smi}]: {nj} jobs of {n} lanes, every verdict = the oracle's and the "
          f"synchronous loop's")
    print(f"  sigs/s: synchronous {out['sync_sps']:.0f}, verify_stream (max_in_flight "
          f"{max_in_flight}) {out['stream_sps']:.0f}: {out['stream_sps'] / out['sync_sps']:.3f}x; "
          f"wall per job {1e3 * sync_wall / nj:.3f} / {1e3 * stream_wall / nj:.3f} ms (the "
          f"process's first {len(warm)} streamed jobs, its pinned blocks allocated: "
          f"{first_ms:.3f} ms a job)")
    print(f"  busy share (device {dev_ms:.3f} ms per job by CUDA events): synchronous "
          f"{out['sync_busy']:.3f}, stream {out['stream_busy']:.3f}; host dispatch ms per job "
          f"(pack, copy and launch enqueue): {out['sync_host_ms']:.3f} / "
          f"{out['stream_host_ms']:.3f}, of which pack_inputs alone {pack_ms:.3f}; "
          f"launches per job {per_job}")
    return out


def stream_phase(dev, commit150, exp150, big, big_exp, commit1k, exp1k, smi: str) -> dict:
    """stream150 (64 warm commit150 jobs on the keyed tier), stream-chunked
    (8 jobs of 8250 lanes, keyed) and stream-generic1024 (16 commit1024
    jobs, verify_stream's default generic dispatch)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    threads = live_threads()
    _build.reset_launches()
    pubs = [p for p, _, _ in commit150]
    entry = PR.table_cache(dev).lookup_or_build(pubs)

    def keyed(pub, sig, msgs):
        return EV.verify_arrays_keyed_async(entry, ids[len(msgs)], pub, sig, msgs)

    ids = {150: entry.key_ids(pubs), len(big): entry.key_ids([p for p, _, _ in big])}
    out = {}
    jobs, want = altered_jobs(commit150, exp150, 64, 60)
    out["stream150"] = stream_cell("stream150", jobs, want, keyed,
                                   job_device_ms(jobs[0], dev, entry, ids[150]), smi)
    jobs, want = altered_jobs(big, big_exp, 8, 1000)
    out["stream-chunked"] = stream_cell("stream-chunked", jobs, want, keyed,
                                        job_device_ms(jobs[0], dev, entry, ids[len(big)]), smi)
    jobs, want = altered_jobs(commit1k, exp1k, 16, 60)
    out["stream-generic1024"] = stream_cell(
        "stream-generic1024", jobs, want,
        lambda pub, sig, msgs: EV.verify_arrays_async(pub, sig, msgs, dev),
        job_device_ms(jobs[0], dev), smi)
    launches = end_phase("stream", threads)
    if launches.get("build_tables") or set(launches) - {"sha512_keyed", "verify_keyed",
                                                          "verify_generic"}:
        raise AssertionError(f"stream: unexpected launches {launches}")
    print(f"stream phase: launches {launches}")
    return out


def run_mix(q, data) -> dict:
    """Four submitter threads at once on the installed queue ``q``:
    consensus (vote pairs through verify_or_fallback, one every 2 ms),
    prefetch (the blocks, one every 3 ms), light (the headers through
    light_verify_or_fallback) and ingest (one-signature submissions);
    every verdict = the oracle's.  -> the wall, the consensus waits
    (seconds, verified inline), the queue's spans and the garbage
    collector's pauses ((generation, seconds); a collection holds the
    GIL, so it stalls every thread of the mix at once)."""
    import gc

    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.utils.trace import TRACER

    items, pk = data["items"], data["pk"]
    errors: list = []
    waits: list = []

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 -- re-raised by run_submitters
                errors.append(exc)
        run.__name__ = fn.__name__
        return run

    @guard
    def consensus():
        for i in range(40, 75):
            before = q.stats()["submitted"]["consensus"]
            t = time.perf_counter()
            got = VQ.verify_or_fallback(data["pairs"][i], timeout=60)
            waits.append((time.perf_counter() - t,
                          q.stats()["submitted"]["consensus"] == before))
            if got != data["pair_exp"][i]:
                raise AssertionError(f"queue: consensus pair {i} differs")
            time.sleep(0.002)

    @guard
    def prefetch():
        futs = []
        for b in data["blocks"]:              # blocks arrive one after another
            futs.append(q.submit_many(items(b), VQ.PRIORITY_PREFETCH))
            time.sleep(0.003)
        for h, fs in enumerate(futs):
            if [f.result(60) for f in fs] != data["block_exp"][h]:
                raise AssertionError(f"queue: prefetch block {h} differs")

    @guard
    def light():
        for h, hdr in enumerate(data["headers"]):
            got, n_inline = VQ.light_verify_or_fallback(items(hdr), timeout=60)
            if got != data["header_exp"][h] or n_inline:
                raise AssertionError(f"queue: light header {h} differs ({n_inline} inline)")

    @guard
    def checktx():
        futs = [q.submit(pk(p), m, s, priority=VQ.PRIORITY_INGEST)
                for p, m, s in data["ingest"]]
        if [f.result(60) for f in futs] != data["ingest_exp"]:
            raise AssertionError("queue: ingest verdicts differ")

    pauses: list = []
    started: list = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"], time.perf_counter() - started.pop()))

    TRACER.clear()
    gc.callbacks.append(on_gc)
    try:
        mix_s, busy = run_submitters((consensus, prefetch, light, checktx), errors)
    finally:
        gc.callbacks.remove(on_gc)
    spans: dict = {}
    for e in TRACER.events():
        if e["name"].startswith("verify_queue/") or e["name"] == "device_launch":
            key = (e["name"], e["args"].get("priority") or e["args"].get("kernel"))
            spans.setdefault(key, []).append((e["dur"] / 1e3, e["args"].get("batch")))
    return dict(mix_s=mix_s, waits=waits, spans=spans, busy=busy, gc=pauses)


#: the signatures of one mix: 35 consensus pairs, 8 blocks of 1024, 4
#: headers of 150, 512 CheckTx
MIX_SIGS = 70 + 8192 + 600 + 512


def run_submitters(fns, errors: list) -> tuple[float, float]:
    """Run the submitter functions on threads at once -> (wall seconds,
    the share of it the device spent inside launches by the host's
    clock: DeviceUsage's busy seconds, an upper bound on the card's busy
    share)."""
    from cometbft_tpu_torch.crypto import health as H

    busy0 = H.USAGE.snapshot()["busy_seconds"]
    workers = [threading.Thread(target=fn, name=f"submit-{fn.__name__}") for fn in fns]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(120)
    wall = time.perf_counter() - t0
    if errors or any(w.is_alive() for w in workers):
        raise AssertionError(f"submitters failed: {errors!r}")
    return wall, (H.USAGE.snapshot()["busy_seconds"] - busy0) / wall


def sync_mix(data, dev) -> dict:
    """The same four lanes of work without a queue, each lane verifying
    for itself as a node without one does: a vote's signatures one by
    one (``verify_signature``), a block's and a header's commit through
    ``create_batch_verifier``, a CheckTx's one signature; every verdict =
    the oracle's."""
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier

    items = data["items"]
    errors: list = []

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 -- re-raised by run_submitters
                errors.append(exc)
        run.__name__ = fn.__name__
        return run

    def batch(triples):
        bv = create_batch_verifier(items(triples[:1])[0][0], device=dev)
        for pk, m, s in items(triples):
            bv.add(pk, m, s)
        return bv.verify()[1]

    def consensus():
        for i in range(40, 75):
            if [pk.verify_signature(m, s) for pk, m, s in data["pairs"][i]] != \
                    data["pair_exp"][i]:
                raise AssertionError(f"sync: consensus pair {i} differs")
            time.sleep(0.002)

    def prefetch():
        for h, b in enumerate(data["blocks"]):
            if batch(b) != data["block_exp"][h]:
                raise AssertionError(f"sync: block {h} differs")

    def light():
        for h, hdr in enumerate(data["headers"]):
            if batch(hdr) != data["header_exp"][h]:
                raise AssertionError(f"sync: header {h} differs")

    def checktx():
        got = [pk.verify_signature(m, s) for pk, m, s in items(data["ingest"])]
        if got != data["ingest_exp"]:
            raise AssertionError("sync: ingest verdicts differ")

    wall, busy = run_submitters([guard(f) for f in (consensus, prefetch, light, checktx)],
                                errors)
    return dict(mix_s=wall, busy=busy)


def mix_line(label: str, mix: dict, overlap: float) -> str:
    waits = [1e3 * w for w, _ in mix["waits"]]
    inline = sum(1 for _, i in mix["waits"] if i)
    pf = [d for d, _ in mix["spans"].get(("verify_queue/launch", "prefetch"), [(0.0, 0)])]
    dl = [d for d, _ in mix["spans"].get(("device_launch", "keyed"), [(0.0, 0)])]
    full = [1e3 * d for g, d in mix["gc"] if g == 2]
    return (f"  {label}: mix {mix['mix_s']:.3f} s, {MIX_SIGS / mix['mix_s']:.0f} sigs/s, "
            f"launch-wall share {mix['busy']:.3f}; consensus wait p50 {pct(waits, 50):.3f} ms, "
            f"max {max(waits):.3f} ms ({inline} of {len(waits)} pairs inline); prefetch launch "
            f"wall p50 {pct(pf, 50):.3f} ms, max {max(pf):.3f} ms; keyed device_launch "
            f"(enqueue) p50 {pct(dl, 50):.3f} ms, max {max(dl):.3f} ms; overlap ratio "
            f"{overlap:.4f}; garbage collections {len(mix['gc'])} "
            f"({1e3 * sum(d for _, d in mix['gc']):.1f} ms), full {len(full)} (longest "
            f"{max(full, default=0.0):.1f} ms)")


def queue_phase(dev, commit150, exp150, commit1k, wide, wide_exp, registry, smi: str) -> dict:
    """A VerifyQueue with the default factory (cuda), installed, fed by
    four submitter threads at once (``run_mix``): consensus (commit150
    vote pairs), prefetch (8 commit1024 blocks at new heights), light
    (commit150 headers at new heights) and ingest (512 one-signature
    CheckTx submissions, released once the 256 target is pending).
    Every future = the oracle's verdict; then the spec cache answers a
    header submitted again, and stop() leaves no thread behind.  A
    consensus pair's cost through the idle queue and inline comes
    first; after the first queue, the mix runs twice more on fresh
    queues with warm tables, each with the tiers that answered; then once
    without a queue (``sync_mix``)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    blocks = [resign(commit1k, b"validator1k", 2 + h, alter=(97 * h) % 1024) for h in range(8)]
    headers = [resign(commit150, b"validator", 2 + h, alter=60 + h) for h in range(4)]
    verdicts = oracle_verdicts([t for b in blocks + headers for t in b])
    if sum(not v for v in verdicts) != 12:
        raise AssertionError("queue: the re-signed votes are not valid but the altered ones")
    print(f"queue data: 8 blocks of 1024 and 4 headers of 150 re-signed votes, the oracle's "
          f"verdicts in {time.perf_counter() - t0:.2f} s")
    pk = ed.Ed25519PubKey
    items = lambda triples: [(pk(p), m, s) for p, m, s in triples]  # noqa: E731
    data = dict(
        pk=pk, items=items, blocks=blocks, headers=headers,
        block_exp=[verdicts[1024 * h: 1024 * (h + 1)] for h in range(8)],
        header_exp=[verdicts[8192 + 150 * h: 8192 + 150 * (h + 1)] for h in range(4)],
        pairs=[items(commit150[i: i + 2]) for i in range(0, 150, 2)],     # 75 vote pairs
        pair_exp=[exp150[i: i + 2] for i in range(0, 150, 2)],
        ingest=wide[2000:2512], ingest_exp=wide_exp[2000:2512])

    threads = live_threads()
    _build.reset_launches()
    q = VQ.VerifyQueue()
    q.start()
    VQ.install_queue(q)
    res: dict = {}
    try:
        # a consensus pair through the idle queue, then inline
        via_queue, inline = [], []
        for i in range(40):
            t = time.perf_counter()
            got = (VQ.verify_or_fallback(data["pairs"][i], timeout=60) if i < 20
                   else VQ._verify_inline(q, data["pairs"][i]))
            (via_queue if i < 20 else inline).append(time.perf_counter() - t)
            if got != data["pair_exp"][i]:
                raise AssertionError(f"queue: consensus pair {i} differs from the oracle")
        mix = run_mix(q, data)
        # the speculative cache answers a header submitted again
        hits0 = registry_value(registry, "cometbft_crypto_verify_queue_spec_cache",
                               'result="hit"')
        resolved0 = q.stats()["cache_resolved"]
        got, _ = VQ.light_verify_or_fallback(items(headers[0]), timeout=60)
        if got != data["header_exp"][0]:
            raise AssertionError("queue: a header submitted again differs")
        hits = registry_value(registry, "cometbft_crypto_verify_queue_spec_cache",
                              'result="hit"') - hits0
        res["spec_hits"] = q.stats()["cache_resolved"] - resolved0
        if res["spec_hits"] != sum(data["header_exp"][0]) or hits != res["spec_hits"]:
            raise AssertionError(f"queue: the header again: {res['spec_hits']} cache hits, "
                                 f"metric {hits}, expected {sum(data['header_exp'][0])}")
        stats = q.stats()
    finally:
        q.stop()
    launches = end_phase("queue", threads)
    if VQ._QUEUE is not None or q.is_running():
        raise AssertionError("queue: stop() left the queue installed or running")
    sizes = {k[1]: sorted(b for _, b in v) for k, v in mix["spans"].items()
             if k[0] == "verify_queue/launch"}
    lanes = MIX_SIGS
    res.update(stats=stats, sizes=sizes, launches=launches, mix_s=mix["mix_s"],
               pair_queue_ms=1e3 * pct(via_queue, 50), pair_inline_ms=1e3 * pct(inline, 50))
    print(f"queue [{smi}]: four submitter threads, {lanes} signatures in {mix['mix_s']:.3f} s, "
          f"every future = the oracle's")
    print(f"  a consensus pair: {res['pair_queue_ms']:.3f} ms p50 through the idle queue "
          f"(the host tier: 2 < the threshold), {res['pair_inline_ms']:.3f} ms p50 inline "
          f"(the oracle, twice)")
    print(mix_line("first queue (cold: ingest's 512 keys and prefetch's set are built in plan)",
                   mix, stats["overlap_ratio"]))
    print(f"  coalesced batch sizes per lane: "
          + "; ".join(f"{p}: {v}" for p, v in sorted(sizes.items())))
    for (span, key), v in sorted(mix["spans"].items()):
        durs = [d for d, _ in v]
        print(f"  {span} {key}: {len(v)} spans, ms p50 {pct(durs, 50):.3f}, max {max(durs):.3f}")
    print(f"  spec cache: the header submitted again resolved {res['spec_hits']} of 150 from the "
          f"cache (its invalid lane is never cached)")
    print(f"  stats {stats}")
    print(f"  launches {launches}")
    for line in registry.expose().splitlines():
        if line.startswith("cometbft_crypto_verify_queue") and "_bucket" not in line:
            print(f"  metric {line}")
    tiers = ("keyed", "generic", "host", "python")
    for r in range(2):
        label = f"warm {r + 1}, buffers of at most {VQ.DEFAULT_MAX_BATCH}"
        threads = live_threads()
        answered0 = [registry_value(registry, "cometbft_crypto_dispatch_tier", f'"{t}"')
                     for t in tiers]
        q = VQ.VerifyQueue()
        q.start()
        VQ.install_queue(q)
        try:
            mix = run_mix(q, data)
            overlap = q.stats()["overlap_ratio"]
        finally:
            q.stop()
        end_phase("queue", threads)
        answered = {t: int(registry_value(registry, "cometbft_crypto_dispatch_tier", f'"{t}"')
                           - a) for t, a in zip(tiers, answered0)}
        res[label] = dict(mix_s=mix["mix_s"], overlap=overlap, answered=answered)
        print(mix_line(label, mix, overlap) + f"; batches answered per tier {answered}")
    sync = sync_mix(data, dev)
    res["sync"] = sync
    print(f"  without a queue (each lane verifies for itself: votes and CheckTx one signature "
          f"at a time on the oracle, blocks and headers through create_batch_verifier): mix "
          f"{sync['mix_s']:.3f} s, {MIX_SIGS / sync['mix_s']:.0f} sigs/s, launch-wall share "
          f"{sync['busy']:.3f}")
    return res


def registry_value(registry, name: str, label: str) -> float:
    """A sample's value from the exposition (0 when absent)."""
    for line in registry.expose().splitlines():
        if line.startswith(name + "{") and label in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def prober_phase(dev, registry, smi: str) -> dict:
    """A HealthProber at a 0.5 s interval with default_tier_probes()
    (host, keyed, generic: CUDA is initialised) on a ladder with a 3 s
    cool-down; a chaos device_loss on keyed for its first 1.2 s: three
    failed keyed canaries demote keyed (probe_failures), and once the
    window is over healthy canaries past the cool-down promote it
    (probes).  The ladder and chaos are reset after."""
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import health as H

    threads = live_threads()
    from cometbft_tpu_torch.ops import _build

    _build.reset_launches()
    D.LADDER.reset(cooldown_s=3.0)
    probes = H.default_tier_probes()
    if set(probes) != {"host", "keyed", "generic"}:
        raise AssertionError(f"prober: default probes {sorted(probes)}")
    prober = H.HealthProber(interval_s=0.5)
    t0 = time.perf_counter()
    marks = {}
    try:
        D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-1.2"), tiers=("keyed",))
        prober.start()
        deadline = time.time() + 30
        while "promoted" not in marks and time.time() < deadline:
            keyed = D.LADDER.snapshot()["tiers"]["keyed"]
            if keyed.get("demoted") and "demoted" not in marks:
                marks["demoted"] = time.perf_counter() - t0
            if keyed.get("promotions") and "promoted" not in marks:
                marks["promoted"] = time.perf_counter() - t0
            time.sleep(0.01)
    finally:
        prober.stop()
        D.CHAOS.load(None)
    launches = end_phase("prober", threads)
    snap = D.LADDER.snapshot()
    trail = [(e["kind"], e["from"], e["to"], e["reason"]) for e in snap["transitions"]]
    psnap = prober.snapshot()
    D.LADDER.reset()
    want = [("demote", "keyed", "generic", "probe_failures"),
            ("promote", "keyed", "keyed", "probes")]
    if trail != want or psnap["last_error"] is not None:
        raise AssertionError(f"prober: transitions {trail}, expected {want}; last error "
                             f"{psnap['last_error']}")
    hm = M.health_metrics()
    secs = {}
    for tier in ("host", "keyed", "generic"):
        h = hm.tier_probe_seconds.labels(tier=tier)
        secs[tier] = 1e3 * h._sum / max(h._count, 1)
    print(f"prober [{smi}]: keyed demoted at {marks.get('demoted', 0):.2f} s (three failed "
          f"canaries under chaos), promoted with reason probes at {marks['promoted']:.2f} s; "
          f"transitions {trail}; {psnap['probes_total']} canaries")
    print("  tier_probe_seconds mean per canary: " + ", ".join(
        f"{t} {ms:.3f} ms ({hm.tier_probe_seconds.labels(tier=t)._count} probes)"
        for t, ms in secs.items()) + f"; the canaries' launches {launches}")
    return dict(marks=marks, trail=trail, probe_ms=secs, launches=launches)


_SEED_CHILD = (
    "import json\n"
    "from cometbft_tpu_torch.crypto import dispatch as D\n"
    "D.LADDER.ensure_seeded()\n"
    "cost = D.LADDER.cost_snapshot()\n"
    "route = {b: D.LADDER.route(['keyed', 'generic'], b) for b in (150, 1024)}\n"
    "payload = D.debug_dispatch_payload()\n"
    "print(json.dumps({'cost': cost, 'route': route,\n"
    "                  'contradictions': payload['order_contradictions']}))\n"
)


def seed_phase(main150, main1k, gen150, gen1k, host_sizes, smi: str) -> dict:
    """The single-batch keyed, generic and host rows at 150 and 1024
    lanes (each tier's warm execute p50; the host tier's
    CpuBatchVerifier) appended to the port's perf ledger; then a fresh
    subprocess seeds its cost model from it and must rank keyed first
    for buckets 256 and 1024 before any online sample."""
    from cometbft_tpu_torch.crypto import batch as B
    from cometbft_tpu_torch.crypto import health as H

    name, power = (x.strip() for x in smi.split(",", 1))
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    rows = []
    for tier, n, ms in (("keyed", 150, main150["exec_ms"]), ("keyed", 1024, main1k["exec_ms"]),
                        ("generic", 150, gen150["exec_ms"]), ("generic", 1024, gen1k["exec_ms"]),
                        ("host", 150, host_sizes["commit150"]["host_ms"]),
                        ("host", 1024, host_sizes["commit1024"]["host_ms"])):
        sps = 1e3 * n / ms
        rows.append({"config": f"chip_smoke_{tier}_{n}", "dispatch_tier": tier, "batch": n,
                     "value": sps, "unit": "sigs/sec", "sigs_per_sec": sps, "route_seed": True,
                     "platform": "gpu", "device": name, "power_limit": power,
                     "source": "chip_smoke.py", "measured": stamp})
    path = H.append_perf_ledger(rows)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", _SEED_CHILD], cwd=root, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"seed: the subprocess failed: {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    table = {(r["tier"], r["bucket"]): r for r in child["cost"]["table"]}
    for bucket in (256, 1024):
        for tier in ("keyed", "generic", "host"):
            r = table.get((tier, bucket))
            if r is None or r["source"] != "seeded" or r["samples"] != 0:
                raise AssertionError(f"seed: ({tier}, {bucket}) not seeded: {r}")
    if any(order[0] != "keyed" for order in child["route"].values()):
        raise AssertionError(f"seed: the seeded model does not rank keyed first: "
                             f"{child['route']}")
    status = B.device_status()
    if status != {"status": "ready", "ndev": 1} or H.debug_perf_payload()["device"] != status:
        raise AssertionError(f"seed: device probe {status}")
    print(f"seed [{smi}]: {len(rows)} rows appended to {os.path.relpath(path, root)}: "
          + ", ".join(f"{r['dispatch_tier']}@{r['batch']} {r['sigs_per_sec']:.0f} sigs/s"
                      for r in rows))
    print(f"  a fresh process's seeded cost model: " + "; ".join(
        f"{t}@{b} {r['sigs_per_sec']:.0f}" for (t, b), r in sorted(table.items()))
        + f"; routes {child['route']} (keyed first, before any online sample)")
    print(f"  order contradictions: {child['contradictions']}")
    print(f"  device probe (a subprocess counting the cards, run beside the prober phase): "
          f"{status}")
    return dict(rows=rows, child=child)


# -- phase 12: commit verification through the types layer ------------------

CHAIN_ID = "chip-smoke-chain"
HEADER_T0 = 1_760_000_000_000_000_000
BLOCK_NS = 6 * 10**9
TRUSTING_NS = 14 * 24 * 3600 * 10**9


def validator_set(keys, power: int = 10):
    """(ValidatorSet of ``keys``, address -> (scalar, public key))."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import Validator, ValidatorSet

    vals = ValidatorSet([Validator(ed.Ed25519PubKey(pub), power) for _, pub in keys])
    by_addr = {ed.Ed25519PubKey(pub).address(): (a, pub) for a, pub in keys}
    return vals, by_addr


def make_block_id(tag: bytes):
    from cometbft_tpu_torch.types import BlockID, PartSetHeader

    h = hashlib.sha256(tag).digest()
    return BlockID(hash=h, part_set_header=PartSetHeader(total=1, hash=hashlib.sha256(h).digest()))


def precommits(signer: FastSigner, vals, by_addr, bid, height: int, t_ns: int, rs) -> list:
    """Every validator's precommit for ``bid``, each with its own
    timestamp (``t_ns`` plus up to a second, as votes reach a proposer),
    signed over its canonical sign bytes."""
    from dataclasses import replace

    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, Vote

    votes, jobs = [], []
    for idx, v in enumerate(vals.validators):
        a, pub = by_addr[v.address]
        vote = Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                    timestamp_ns=t_ns + int(rs.randint(0, 10**9)),
                    validator_address=v.address, validator_index=idx)
        votes.append(vote)
        jobs.append((a, pub, vote.sign_bytes(CHAIN_ID)))
    return [replace(v, signature=sig) for v, sig in zip(votes, signer.sign_all(jobs))]


def commit_of(votes, bid, height: int):
    """The Commit of ``votes``, all for ``bid``: what VoteSet.make_commit()
    gives for such a set (votes150 checks that byte for byte)."""
    from cometbft_tpu_torch.types import Commit

    return Commit(height=height, round=0, block_id=bid,
                  signatures=tuple(v.commit_sig() for v in votes))


class FactoryLog:
    """Wraps ``crypto.batch.create_batch_verifier`` while installed: the
    verifiers that types/validation makes, for the signatures each was
    sent and the tier that answered (``last_tier``)."""

    def __init__(self) -> None:
        from cometbft_tpu_torch.crypto import batch as B

        self.B, self.real, self.made = B, B.create_batch_verifier, []

    def __enter__(self) -> "FactoryLog":
        def make(pub_key, device=None):
            verifier = self.real(pub_key, device=device)
            self.made.append(verifier)
            return verifier

        self.B.create_batch_verifier = make
        return self

    def __exit__(self, *exc) -> None:
        self.B.create_batch_verifier = self.real

    def take(self) -> list:
        """[(signatures sent, tier)] per verifier since the last take."""
        out = [(len(v), v.last_tier) for v in self.made]
        self.made = []
        return out


def expect_error(what: str, fn, cls, message: str) -> None:
    """``fn`` must raise ``cls`` with exactly ``message``."""
    try:
        fn()
    except cls as exc:
        if str(exc) != message:
            raise AssertionError(f"{what}: {cls.__name__} says {str(exc)!r}, "
                                 f"expected {message!r}") from exc
        return
    raise AssertionError(f"{what}: no {cls.__name__} raised")


def light_chain(signer: FastSigner, keys150, newcomers, heights: int, rs):
    """A 150-validator chain of ``heights`` light blocks: the proposer
    rotates by priority every height, and at every 8th height one
    validator leaves and a newcomer joins (update_with_change_set).
    Each header carries its set's hash, the next set's hash, the last
    block id and the last commit's hash; each commit is its set's
    precommits over the header's hash.  -> (light blocks by height,
    the heights whose set changed)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import BlockID, Data, Header, PartSetHeader
    from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader

    vals, by_addr = validator_set(keys150)
    sets, rotations = {1: vals}, []
    for h in range(2, heights + 2):
        nxt = sets[h - 1].increment_proposer_priority(1)
        if h % 8 == 1:
            out_v = nxt.validators[(7 * h) % len(nxt)]
            a, pub = newcomers.pop(0)
            by_addr[ed.Ed25519PubKey(pub).address()] = (a, pub)
            nxt = nxt.update_with_change_set([(out_v.pub_key, 0), (ed.Ed25519PubKey(pub), 10)])
            if h <= heights:
                rotations.append(h)
        sets[h] = nxt
    blocks, prev_bid, prev_commit = {}, BlockID(), None
    for h in range(1, heights + 1):
        header = Header(
            chain_id=CHAIN_ID, height=h, time_ns=HEADER_T0 + h * BLOCK_NS,
            last_block_id=prev_bid,
            last_commit_hash=prev_commit.hash() if prev_commit is not None else b"",
            data_hash=Data((b"tx-%d" % h,)).hash(), validators_hash=sets[h].hash(),
            next_validators_hash=sets[h + 1].hash(),
            consensus_hash=hashlib.sha256(b"params").digest(),
            app_hash=hashlib.sha256(b"app-%d" % h).digest(),
            proposer_address=sets[h].get_proposer().address)
        bid = BlockID(hash=header.hash(), part_set_header=PartSetHeader(
            total=1, hash=hashlib.sha256(b"parts-%d" % h).digest()))
        votes = precommits(signer, sets[h], by_addr, bid, h, header.time_ns + BLOCK_NS // 2, rs)
        prev_commit = commit_of(votes, bid, h)
        blocks[h] = LightBlock(SignedHeader(header, prev_commit), sets[h])
        prev_bid = bid
    return blocks, rotations


def add_votes(vs, votes, nthreads: int) -> float:
    """``votes`` through ``vs.add_vote`` from ``nthreads`` threads (thread
    k takes every nthreads-th vote from k) -> wall seconds.  Fails on a
    vote not added or an error in any thread."""
    errors: list = []

    def run(chunk):
        try:
            for v in chunk:
                if not vs.add_vote(v):
                    raise AssertionError(f"vote {v.validator_index} not added")
        except Exception as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(votes[k::nthreads],), name=f"votes-{k}")
               for k in range(nthreads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"votes: add_vote failed: {errors[:1]}")
    return wall


def validation_phase(dev, commit150, commit1k, registry, smi: str) -> dict:
    """Commit verification through the port's types layer, on a fresh
    KeyTableCache: verify150 (types.validation.verify_commit on a
    150-validator commit of real canonical precommits with per-vote
    timestamps: cold launches, warm p50/p99 beside the synthetic
    create_batch_verifier -> add x n -> verify() on the same triples,
    the reference's errors), light1024 (verify_commit_light on 1024
    validators: the early break and its tier), votes150 (the precommits
    through VoteSet.add_vote with a VerifyQueue installed, from one
    thread and from four; verify_commit on make_commit() must be all
    speculative-cache hits with no launch) and light-chain (the light
    verifier along a 64-header chain that rotates a validator every 8
    heights: adjacent steps, skips of 8 and 32, three refusals).  Fails
    on a wrong verdict, exception, launch count or a thread left
    behind."""
    import torch

    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.light import verifier as LV
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, CommitSig, VoteSet, codec
    from cometbft_tpu_torch.types import validation as VAL
    from cometbft_tpu_torch.types.light_block import LightBlock, LightBlockError, SignedHeader
    from cometbft_tpu_torch.utils.flight import FLIGHT
    from dataclasses import replace

    t_phase = time.perf_counter()
    threads = live_threads()
    _build.reset_launches()
    rs = np.random.RandomState(SEED + 10)
    signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
    keys150 = seeded_keys(b"validator", 150, commit150)
    vals150, by150 = validator_set(keys150)
    bid150 = make_block_id(b"block-150")
    votes150 = precommits(signer, vals150, by150, bid150, 1, HEADER_T0, rs)
    c150 = commit_of(votes150, bid150, 1)
    vals1k, by1k = validator_set(seeded_keys(b"validator1k", 1024, commit1k))
    bid1k = make_block_id(b"block-1024")
    c1k = commit_of(precommits(signer, vals1k, by1k, bid1k, 1, HEADER_T0, rs), bid1k, 1)
    newcomers = seeded_keys(b"newcomer", 8)
    blocks, rotations = light_chain(signer, keys150, newcomers, 64, rs)
    t_data = time.perf_counter() - t_phase
    lens = sorted({len(c150.vote_sign_bytes(CHAIN_ID, i)) for i in range(150)})
    counts = {n: sum(len(c150.vote_sign_bytes(CHAIN_ID, i)) == n for i in range(150))
              for n in lens}
    print(f"validation [{smi}]: data in {t_data:.2f} s (150 + 1024 precommits, a 64-header "
          f"chain: {64 * 150} precommits, rotations at heights {rotations})")
    print(f"  sign bytes of commit150's precommits (per-vote timestamps): lengths {counts} -> "
          + ("one length" if len(lens) == 1 else
             "not one length: pack_inputs takes its variable-length path"))

    key = str(dev)
    saved = PR._caches.get(key)
    PR._caches[key] = PR.KeyTableCache(dev)
    res: dict = {"sign_bytes_lengths": counts}
    try:
        # -- verify150 -----------------------------------------------------
        def vc(commit=c150, vals=vals150, bid=bid150, height=1):
            VAL.verify_commit(CHAIN_ID, vals, bid, height, commit, device=dev)

        _build.reset_launches()
        t0 = time.perf_counter()
        vc()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        if launched() != {"build_tables": 1, "sha512_keyed": 1, "verify_keyed": 1}:
            raise AssertionError(f"verify150: cold launches {launched()}")
        triples = [(vals150.validators[i].pub_key, c150.vote_sign_bytes(CHAIN_ID, i),
                    c150.signatures[i].signature) for i in range(150)]
        from cometbft_tpu_torch.crypto.batch import create_batch_verifier

        def synthetic():
            bv = create_batch_verifier(triples[0][0], device=dev)
            for pk, m, s in triples:
                bv.add(pk, m, s)
            ok, _ = bv.verify()
            if not ok:
                raise AssertionError("verify150: the synthetic batch is not valid")

        def sign_bytes():
            [c150.vote_sign_bytes(CHAIN_ID, i) for i in range(150)]

        warm, syn, sb = [], [], []
        timed = [(vc, warm, True), (synthetic, syn, True), (sign_bytes, sb, False)]
        for r in range(200):
            for fn, out, launches in timed[r % 3:] + timed[:r % 3]:
                _build.reset_launches()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                if launches and launched() != {"sha512_keyed": 1, "verify_keyed": 1}:
                    raise AssertionError(f"verify150: warm launches {launched()} (run {r})")
        res["verify150"] = dict(cold_s=cold_s, p50_ms=1e3 * pct(warm, 50),
                                p99_ms=1e3 * pct(warm, 99), synthetic_p50_ms=1e3 * pct(syn, 50),
                                sign_bytes_p50_ms=1e3 * pct(sb, 50))
        v = res["verify150"]
        print(f"  verify150 [{smi}]: cold {cold_s:.4f} s (build_tables, sha512_keyed, "
              f"verify_keyed: 1 each); warm verify_commit p50 {v['p50_ms']:.3f} ms, p99 "
              f"{v['p99_ms']:.3f} ms over 200 (sha512_keyed 1, verify_keyed 1 each); the "
              f"synthetic create_batch_verifier -> add x 150 -> verify() on the same triples "
              f"p50 {v['synthetic_p50_ms']:.3f} ms; the types layer's host cost (sign bytes, "
              f"address checks, tally, span): {v['p50_ms'] - v['synthetic_p50_ms']:.3f} ms; "
              f"the 150 sign bytes alone p50 {v['sign_bytes_p50_ms']:.3f} ms (the three "
              f"interleaved, in turns)")
        sigs = list(c150.signatures)
        s = sigs[77].signature
        sigs[77] = replace(sigs[77], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
        expect_error("verify150, an altered signature",
                     lambda: vc(replace(c150, signatures=tuple(sigs))),
                     VAL.InvalidCommitSignatures, "wrong signature (#77)")
        under = tuple(cs if i < 100 else CommitSig() for i, cs in enumerate(c150.signatures))
        expect_error("verify150, under 2/3", lambda: vc(replace(c150, signatures=under)),
                     VAL.NotEnoughVotingPower, "tallied 1000 <= needed 1000")
        expect_error("verify150, a wrong height", lambda: vc(height=2),
                     VAL.InvalidCommitHeight, "commit height 1, expected 2")
        expect_error("verify150, a wrong block id", lambda: vc(bid=make_block_id(b"other")),
                     VAL.InvalidCommitSignatures, f"commit for wrong block id {bid150}")
        print("  verify150 errors as the reference's: an altered signature -> "
              "InvalidCommitSignatures 'wrong signature (#77)'; 100 of 150 signed -> "
              "NotEnoughVotingPower; a wrong height -> InvalidCommitHeight; a wrong block id "
              "-> InvalidCommitSignatures")

        # -- light1024 -----------------------------------------------------
        def vcl():
            VAL.verify_commit_light(CHAIN_ID, vals1k, bid1k, 1, c1k, device=dev)

        with FactoryLog() as log:
            _build.reset_launches()
            t0 = time.perf_counter()
            vcl()
            torch.cuda.synchronize()
            cold_s, cold_l, cold_v = time.perf_counter() - t0, launched(), log.take()
            walls = []
            for _ in range(30):
                t0 = time.perf_counter()
                vcl()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            sent = set(log.take())
        if len(sent) != 1 or cold_v[0] != next(iter(sent)):
            raise AssertionError(f"light1024: verifiers {cold_v}, then {sent}")
        (n_sent, tier), = sent
        res["light1024"] = dict(cold_s=cold_s, p50_ms=1e3 * pct(walls, 50), sent=n_sent, tier=tier)
        print(f"  light1024 [{smi}]: verify_commit_light sends {n_sent} of 1024 signatures "
              f"(the early break past 2/3), tier {tier}; cold {cold_s:.4f} s, launches "
              f"{cold_l}; warm p50 {res['light1024']['p50_ms']:.3f} ms over 30")

        # -- votes150 ------------------------------------------------------
        tiers = ("keyed", "generic", "host", "python")
        for nthreads in (1, 4):
            q = VQ.VerifyQueue()
            q.start()
            VQ.install_queue(q)
            try:
                answered0 = [registry_value(registry, "cometbft_crypto_dispatch_tier", f'"{t}"')
                             for t in tiers]
                sub0 = q.stats()["submitted"]["consensus"]
                _build.reset_launches()
                vs = VoteSet(CHAIN_ID, 1, 0, PRECOMMIT_TYPE, vals150)
                wall = add_votes(vs, votes150, nthreads)
                add_launches = launched()
                stats = q.stats()
                inline = 150 - (stats["submitted"]["consensus"] - sub0)
                answered = {t: int(registry_value(registry, "cometbft_crypto_dispatch_tier",
                                                  f'"{t}"') - a)
                            for t, a in zip(tiers, answered0)}
                made = vs.make_commit()
                if codec.encode_commit(made) != codec.encode_commit(c150):
                    raise AssertionError("votes150: make_commit() differs from commit150's bytes")
                _build.reset_launches()
                t0 = time.perf_counter()
                vc(made)
                spec_ms = 1e3 * (time.perf_counter() - t0)
                rec = [e for e in FLIGHT.tail(8) if e["kind"] == "consensus/speculative_verify"]
                got = (rec[-1]["hits"], rec[-1]["misses"], rec[-1]["tier"]) if rec else None
                if got != (150, 0, "speculative") or launched():
                    raise AssertionError(f"votes150: verify_commit after the vote set: "
                                         f"(hits, misses, tier) {got}, launches {launched()}")
            finally:
                q.stop()
            if VQ._QUEUE is not None or q.is_running():
                raise AssertionError("votes150: stop() left the queue installed or running")
            res[f"votes150/{nthreads}"] = dict(wall_s=wall, per_vote_ms=1e3 * wall / 150,
                                               inline=inline, answered=answered,
                                               batches=stats["launched_batches"],
                                               spec_ms=spec_ms)
            print(f"  votes150 [{smi}], {nthreads} thread{'s' if nthreads > 1 else ''}: "
                  f"150 add_vote in {wall:.3f} s, {1e3 * wall / 150:.3f} ms a vote; "
                  f"{inline} verified inline (the oracle: the queue was busy), "
                  f"{stats['launched_batches']} queue batches of {stats['launched_sigs']} "
                  f"signatures, batches answered per tier {answered}, launches "
                  f"{add_launches or 'none'}; verify_commit on make_commit(): 150 cache hits, "
                  f"0 misses, tier speculative, no launch, {spec_ms:.3f} ms")

        # -- light-chain ---------------------------------------------------
        now = HEADER_T0 + 70 * BLOCK_NS
        adj, adj_rot, kinds = [], [], {}
        with FactoryLog() as log:
            for h in range(1, 64):
                _build.reset_launches()
                t0 = time.perf_counter()
                LV.verify_adjacent(blocks[h], blocks[h + 1], CHAIN_ID, TRUSTING_NS, now,
                                   device=dev)
                wall = time.perf_counter() - t0
                built = launched().get("build_tables", 0)
                if h + 1 in rotations:
                    adj_rot.append((h + 1, round(1e3 * wall, 3), built))
                else:
                    adj.append(wall)
                    if built:
                        raise AssertionError(f"light-chain: a table build at height {h + 1}, "
                                             "no rotation")
                kinds.setdefault("adjacent", []).extend(log.take())
            skips = {8: [(h, h + 8) for h in range(1, 57, 8)], 32: [(1, 33), (32, 64)]}
            skip_walls = {}
            for step, pairs in skips.items():
                skip_walls[step] = []
                for a, b in pairs:
                    t0 = time.perf_counter()
                    LV.verify_non_adjacent(blocks[a], blocks[b], CHAIN_ID, TRUSTING_NS, now,
                                           device=dev)
                    skip_walls[step].append(time.perf_counter() - t0)
                    made = log.take()
                    kinds.setdefault(f"skip {step}, trusting", []).append(made[0])
                    kinds.setdefault(f"skip {step}, own commit", []).append(made[1])
        tampered = LightBlock(SignedHeader(replace(blocks[2].header, app_hash=b"\xde\xad" * 16),
                                           blocks[2].commit), blocks[2].validator_set)
        expect_error("light-chain, a tampered header",
                     lambda: LV.verify_adjacent(blocks[1], tampered, CHAIN_ID, TRUSTING_NS, now,
                                                device=dev),
                     LightBlockError, "commit signs a different header")
        expiry = blocks[1].time_ns + 1
        expect_error("light-chain, an expired trusted header",
                     lambda: LV.verify_adjacent(blocks[1], blocks[2], CHAIN_ID, 1, now,
                                                device=dev),
                     LV.ErrOldHeaderExpired, f"trusted header expired at {expiry} (now {now})")
        expect_error("light-chain, a header from the future",
                     lambda: LV.verify_adjacent(blocks[1], blocks[2], CHAIN_ID, TRUSTING_NS,
                                                blocks[1].time_ns, max_clock_drift_ns=0,
                                                device=dev),
                     LV.ErrInvalidHeader, "new header is from the future")
        summary = {k: {f"{n} sigs, {t}": sum(1 for x in v if x == (n, t)) for n, t in set(v)}
                   for k, v in kinds.items()}
        res["light-chain"] = dict(adjacent_p50_ms=1e3 * pct(adj, 50), rotations=adj_rot,
                                  skip_p50_ms={k: 1e3 * pct(v, 50) for k, v in skip_walls.items()},
                                  checks=summary)
        lc = res["light-chain"]
        print(f"  light-chain [{smi}]: 64 headers of 150 validators, a validator rotated at "
              f"heights {rotations}; verify_adjacent p50 {lc['adjacent_p50_ms']:.3f} ms a "
              f"header over {len(adj)} steps without a set change; the steps into a rotation "
              f"(height, ms, build_tables launches): {adj_rot}")
        print(f"  light-chain: verify_non_adjacent p50 {lc['skip_p50_ms'][8]:.3f} ms in skips "
              f"of 8 ({len(skips[8])}), {lc['skip_p50_ms'][32]:.3f} ms in skips of 32 "
              f"({len(skips[32])}); refusals as the reference's: a tampered header -> "
              f"LightBlockError, an expired trusted header -> ErrOldHeaderExpired, a header "
              f"from the future -> ErrInvalidHeader")
        for kind, table in summary.items():
            print(f"    {kind}: signatures sent and tier per check {table}")
    finally:
        if saved is None:
            PR._caches.pop(key, None)
        else:
            PR._caches[key] = saved
    res["launches"] = end_phase("validation", threads)
    print(f"  validation phase: {time.perf_counter() - t_phase:.2f} s")
    return res


# -- phase 13: the multi-device plane -----------------------------------

def mesh_devices() -> tuple[list[str], str]:
    """Every visible card when there is more than one, else four shards
    on cuda:0 (a mesh's devices may repeat)."""
    import torch

    n = torch.cuda.device_count()
    if n > 1:
        return [f"cuda:{i}" for i in range(n)], f"every visible card ({n} cards)"
    return ["cuda:0"] * 4, "one card: 4 shards on cuda:0"


def mesh_shard_check(name: str, bv, plan, mesh, tier: str) -> dict:
    """Each shard's launches of the last mesh verify, redone on the
    shard's own inputs: the kernels' verdicts held to the plain versions
    (keyed_digest_plain, then verify_keyed_plain or verify_generic_plain)
    on every lane, then each shard's launch sequence and its plain
    version timed by CUDA events beside the sum of its slices' bounds
    (vk_bound or vg_bound, and sha_keyed_bound)."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.parallel import mesh as MM

    if tier == "keyed_mesh":
        entry = plan.entry
        wb = entry.window_bits
        tables, valids, _ = entry.sharded_tables(mesh)
        _, bucket, packed = bv.keyed_shards(plan.key_ids, plan.pub, plan.sig, plan.msgs)
    else:
        bucket, packed, _ = bv.generic_shards(plan.pub, plan.sig, plan.msgs)
    nblocks = EV.nblocks_for_bucket(bucket)
    shards = []
    for d, dev in enumerate(mesh.flat):
        if packed[d] is None:
            continue
        with MM._on(dev):
            buf = torch.from_numpy(packed[d]).to(dev)
            if tier == "keyed_mesh":
                b_table = F.const(PR.b_comb8(), dev)
                run = lambda buf=buf, d=d, b=b_table: MM.verify_keyed_shard(
                    buf, tables[d], valids[d], b, bucket, nblocks, wb)
            else:
                run = lambda buf=buf: EV.verify_generic_rows(buf, bucket)
            got = run()

            def plain(buf=buf, d=d):
                oks = []
                for s in range(0, buf.shape[1], EV.MAX_LAUNCH):
                    rows = buf[:, s : s + EV.MAX_LAUNCH]
                    digest = EV.keyed_digest_plain(rows, bucket, nblocks)
                    if tier == "keyed_mesh":
                        oks.append(EV.verify_keyed_plain(rows, digest, tables[d], valids[d],
                                                         b_table, bucket, wb)[0])
                    else:
                        oks.append(EV.verify_generic_plain(rows, digest)[0])
                return torch.cat(oks)

            want = plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero().flatten().tolist()[:20]
                raise AssertionError(f"mesh {name}: shard {d}'s kernels differ from their "
                                     f"plain versions at lanes {bad}")
            bound_ms_sum = 0.0
            for s in range(0, buf.shape[1], EV.MAX_LAUNCH):
                rows = buf[:, s : s + EV.MAX_LAUNCH]
                bound = (vk_bound(rows, EV.keyed_digest(rows, bucket, nblocks), bucket, wb)[0]
                         if tier == "keyed_mesh" else vg_bound(rows)[0])
                bound_ms_sum += bound[0] + sha_keyed_bound(rows, bucket, nblocks)[0][0]
            ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 2, warm=1)
        shards.append(dict(shard=d, device=str(dev), lanes=buf.shape[1], ms=ms,
                           plain_ms=plain_ms, bound=bound_ms_sum))
    return dict(shards=shards, ms=sum(s["ms"] for s in shards),
                plain_ms=sum(s["plain_ms"] for s in shards),
                bound=sum(s["bound"] for s in shards))


def mesh_cell(name: str, triples, expected, mesh, dev, tier: str, warm_runs: int,
              smi: str) -> dict:
    """One cell on a mesh tier: the verify with the launch counters at 0
    (sha512_keyed and the tier's verify kernel once per slice of each
    shard with lanes, build_tables at most once), verdicts = the oracle's
    = the single-device tier's on the same triples; each shard held to
    the plain versions (mesh_shard_check); warm p50 of the mesh verify
    and of the single-device tier, interleaved: on one card the
    difference is the cost of routing, not a speed-up."""
    from cometbft_tpu_torch.ops import _build

    single = tier.replace("_mesh", "")
    kernel = "verify_keyed" if tier == "keyed_mesh" else "verify_generic"
    _build.reset_launches()
    cold, bv, plan, results, _ = run_verify(triples, dev, mesh=mesh)
    launches = launched()
    if bv.last_tier != tier or results != list(expected):
        bad = [i for i, (a, b) in enumerate(zip(results, expected)) if a != b][:20]
        raise AssertionError(f"mesh {name}: tier {bv.last_tier} (expected {tier}), verdicts "
                             f"differ from the oracle at {bad}")
    want = {"sha512_keyed": sum(s["launches"]["sha512_keyed"] for s in bv.last_shards),
            kernel: sum(s["launches"][kernel] for s in bv.last_shards)}
    if {k: v for k, v in launches.items() if k != "build_tables"} != want or \
            launches.get("build_tables", 0) > 1:
        raise AssertionError(f"mesh {name}: launches {launches}, expected {want}")
    _, sbv, _, sresults, _ = run_verify(triples, dev)
    if sbv.last_tier != single or sresults != results:
        raise AssertionError(f"mesh {name}: the single-device tier {sbv.last_tier} disagrees")
    check = mesh_shard_check(name, bv, plan, mesh, tier)
    lat_mesh, lat_single = [], []
    for _ in range(warm_runs):
        for lat, kw in ((lat_mesh, dict(mesh=mesh)), (lat_single, {})):
            dt, b, _, r, _ = run_verify(triples, dev, **kw)
            if r != results or b.last_tier not in (tier, single):
                raise AssertionError(f"mesh {name}: a warm run differs")
            lat.append(dt)
    out = dict(name=name, tier=tier, n=len(triples), cold_s=cold, launches=launches,
               shards=bv.last_shards, p50_ms=1e3 * pct(lat_mesh, 50),
               single_p50_ms=1e3 * pct(lat_single, 50), check=check)
    print(f"mesh {name} [{smi}]: {len(triples)} lanes on {tier} over {mesh.size} shards, "
          f"= oracle = {single} ({sum(not v for v in expected)} invalid); first verify "
          f"{cold:.4f} s, launches {launches}")
    for s, c in zip([s for s in bv.last_shards if s["lanes"]], check["shards"]):
        print(f"  shard {c['shard']} ({s['device']}): {s['lanes']} lanes, width {s['width']}, "
              f"launches {s['launches']}; = plain versions; sha512_keyed + {kernel} "
              f"{c['ms'] * 1e3:.2f} us (CUDA events), bound {c['bound'] * 1e3:.3f} us, plain "
              f"{c['plain_ms'] * 1e3:.2f} us")
    idle = [i for i, s in enumerate(bv.last_shards) if not s["lanes"]]
    print(f"  shards' launches {check['ms'] * 1e3:.2f} us in all, bound {check['bound'] * 1e3:.3f}"
          f" us, plain {check['plain_ms'] * 1e3:.2f} us; shards without lanes (no launch): "
          f"{idle}")
    print(f"  warm p50 over {warm_runs}, interleaved: {tier} {out['p50_ms']:.3f} ms, {single} "
          f"{out['single_p50_ms']:.3f} ms on the same triples (the cost of routing on "
          f"{'one card' if len(set(mesh.flat)) == 1 else 'these cards'})")
    return out


def mesh_phase(dev, commit150, exp150, commit1k, exp1k, big, big_exp, wide, wide_exp,
               smi: str) -> dict:
    """Phase 13, the multi-device plane (parallel/mesh.py) on every
    visible card, or on 4 shards of cuda:0 when there is one, with a
    static walk (no cost model) and the launch counters at 0 at its
    start: commit150 and commit1024 on keyed_mesh, chunked and
    generic1024 on generic_mesh (mesh_cell); commit10k's 10000-key 4-bit
    pool through sharded_tables (the placement's bytes beside the
    pool's) and a keyed_mesh verify on it; a shard_loss chaos window
    (keyed_mesh demoted, keyed answers exactly, nothing else demoted);
    the mesh canaries once."""
    import torch

    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import health as H
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.parallel import mesh as MM

    devices, what = mesh_devices()
    mesh = MM.flat_mesh(devices)
    print(f"mesh phase [{smi}]: {what}: {mesh}")
    threads0 = live_threads()
    _build.reset_launches()
    D.LADDER.reset(cost_model=D.TierCostModel(enabled=False))
    cells = {}
    try:
        cells["commit150"] = mesh_cell("commit150", commit150, exp150, mesh, dev, "keyed_mesh",
                                       50, smi)
        cells["commit1024"] = mesh_cell("commit1024", commit1k, exp1k, mesh, dev, "keyed_mesh",
                                        20, smi)
        limit, PR.TABLE_MAX_KEYS = PR.TABLE_MAX_KEYS, 0
        try:
            cells["chunked"] = mesh_cell("chunked", big, big_exp, mesh, dev, "generic_mesh", 5,
                                         smi)
            cells["generic1024"] = mesh_cell("generic1024", commit1k, exp1k, mesh, dev,
                                             "generic_mesh", 20, smi)
        finally:
            PR.TABLE_MAX_KEYS = limit
        snap = D.LADDER.snapshot()
        if snap["transitions"] or any(st["demoted"] for st in snap["tiers"].values()):
            raise AssertionError(f"mesh phase: a demotion outside its chaos window: {snap}")

        # commit10k's pool, placed over the mesh
        triples, exp = wide[:10000], wide_exp[:10000]
        cache = PR.KeyTableCache(dev)
        t0 = time.perf_counter()
        entry = cache.lookup_or_build(sorted({p for p, _, _ in triples}))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tables, valids, per_cap = entry.sharded_tables(mesh)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        pool_mib, placed_mib = entry.nbytes / 2**20, entry.placement_bytes() / 2**20
        shared = len({t.untyped_storage().data_ptr() for t in tables}) == 1
        dt, bv, plan, results, _ = run_verify(triples, dev, cache=cache, mesh=mesh)
        if bv.last_tier != "keyed_mesh" or results != list(exp) or plan.entry is not entry:
            raise AssertionError(f"mesh commit10k: tier {bv.last_tier}, = oracle "
                                 f"{results == list(exp)}")
        _, sbv, _, sres, _ = run_verify(triples, dev, cache=cache)
        if sres != results:
            raise AssertionError("mesh commit10k: the single-device keyed tier disagrees")
        print(f"mesh commit10k [{smi}]: {len(entry.key_index)} keys, 4-bit pool of "
              f"{entry.nbytes // PR._KeyPool(4, dev).key_bytes} slots, {pool_mib:.1f} MiB "
              f"(built in {build_s:.3f} s); sharded_tables over {mesh.size} shards: "
              f"{per_cap} slots a shard, {placed_mib:.1f} MiB placed (the permuted table "
              f"and mask{', one tensor the shards view' if shared else ''}) in "
              f"{place_s * 1e3:.1f} ms; keyed_mesh verify {dt * 1e3:.1f} ms = oracle = keyed; "
              f"shards' lanes {[s['lanes'] for s in bv.last_shards]}")
        cells["commit10k"] = dict(pool_mib=pool_mib, placed_mib=placed_mib, place_s=place_s,
                                  verify_ms=dt * 1e3, shards=bv.last_shards)
        del tables, valids, entry, plan, bv, sbv
        cache.clear()

        # a shard lost: keyed_mesh demoted, keyed answers
        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        D.LADDER.reset(demote_after=1, cooldown_s=1.0, clock=Clock(),
                       cost_model=D.TierCostModel(enabled=False))
        D.CHAOS.load(D.ChaosPlan.parse("shard_loss@0-3600"))
        dt, bv, plan, results, _ = run_verify(commit150, dev, mesh=mesh)
        snap = D.LADDER.snapshot()
        trail = [(e["kind"], e["from"], e["to"], e["reason"]) for e in snap["transitions"]]
        demoted = sorted(t for t, st in snap["tiers"].items() if st["demoted"])
        if (bv.last_tier != "keyed" or results != list(exp150) or demoted != ["keyed_mesh"]
                or trail != [("demote", "keyed_mesh", "keyed", "chaos:shard_loss")]):
            raise AssertionError(f"mesh shard_loss: answered by {bv.last_tier}, = oracle "
                                 f"{results == list(exp150)}, demoted {demoted}, {trail}")
        print(f"mesh shard_loss: walk {plan.tiers}; keyed_mesh demoted ({trail}), keyed "
              f"answered commit150 in {dt * 1e3:.1f} ms = oracle; nothing else demoted")
        D.CHAOS.load(None)
        D.LADDER.reset(cost_model=D.TierCostModel(enabled=False))

        canaries = {}
        for tier, probe in (("keyed_mesh", H._probe_keyed_mesh),
                            ("generic_mesh", H._probe_generic_mesh)):
            t0 = time.perf_counter()
            ok = probe(mesh)
            canaries[tier] = (ok, time.perf_counter() - t0)
            if not ok:
                raise AssertionError(f"mesh canary {tier} failed")
        print("mesh canaries: " + ", ".join(f"{t} ok in {s * 1e3:.1f} ms"
                                              for t, (_, s) in canaries.items()))
    finally:
        D.CHAOS.load(None)
        D.LADDER.reset()
    launches = end_phase("mesh phase", threads0)
    print(f"mesh phase: launches in all {launches} (the plain versions' fe_mul and fe_sq "
          f"among them)")
    return dict(cells=cells, launches=launches, mesh=[str(d) for d in mesh.flat])


# -- phase 14: the device-plane guard ----------------------------------

def unseen_keyed_batch(triples, seen):
    """A batch of ``triples``' keys whose keyed launch signature (padded
    width, bucket) is in no key of ``seen``: the first of 100 then 64
    lanes, at the triples' message length, then padded to 200, 400, 1000
    and 4000 bytes (the messages no longer match their signatures)."""
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    used = {(k[0], k[1]) for k in seen}
    for length in (len(triples[0][1]), 200, 400, 1000, 4000):
        for n in (min(100, len(triples)), min(64, len(triples))):
            if (max(PR.next_pow2(n), 8), EV.bucket_for(length)) not in used:
                return [(p, m.ljust(length, b"-"), s) for p, m, s in triples[:n]]
    raise AssertionError(f"guard: every keyed width and bucket was seen: {sorted(used)}")


#: sealed verifies of each tier in the guard phase
GUARD_RUNS = 20


def guard_phase(dev, commit150, exp150, mesh_devs, smi: str) -> dict:
    """Phase 14, ops/jitguard.py armed: ``jitguard.enable()``, GUARD_RUNS
    warm-up verifies of commit150 each on keyed, generic (the table limit
    at 0) and keyed_mesh, interleaved (the unsealed p50), ``seal()``, then
    GUARD_RUNS verifies of each inside ``transfer_window`` (the sync debug
    mode "error" around the launches, the audited copies allowed): zero
    new seam keys and zero builds.  A planted ``.item()`` inside the
    window raises and counts one transfer trip; a planted batch whose
    keyed signature no earlier phase launched (unseen_keyed_batch) raises
    RetraceError.
    Then ``reset()``; the launch counters at 0 at its start."""
    import torch

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import jitguard as JG
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.parallel import mesh as MM

    mesh = MM.flat_mesh(mesh_devs)
    threads0 = live_threads()
    _build.reset_launches()
    D.LADDER.reset(cost_model=D.TierCostModel(enabled=False))
    cm = M.crypto_metrics()

    def run(tier):
        limit = PR.TABLE_MAX_KEYS
        if tier == "generic":
            PR.TABLE_MAX_KEYS = 0
        try:
            dt, bv, _, results, _ = run_verify(
                commit150, dev, mesh=mesh if tier == "keyed_mesh" else None)
        finally:
            PR.TABLE_MAX_KEYS = limit
        if bv.last_tier != tier or results != list(exp150):
            raise AssertionError(f"guard: {tier} answered by {bv.last_tier}, = oracle "
                                 f"{results == list(exp150)}")
        return dt

    tiers = ("keyed", "generic", "keyed_mesh")
    JG.enable()
    JG.reset()
    try:
        # warm-up, then the unguarded p50 the sealed runs are held beside
        base = {t: [] for t in tiers}
        for _ in range(GUARD_RUNS):
            for tier in tiers:
                base[tier].append(run(tier))
        counts = JG.compile_counts()
        seen = sum(len(keys) for keys in JG._SEEN.values())
        JG.seal()
        lat = {t: [] for t in tiers}
        for _ in range(GUARD_RUNS):
            for tier in tiers:
                with JG.transfer_window():
                    lat[tier].append(run(tier))
        after = JG.compile_counts()
        if after != counts:
            raise AssertionError(f"guard: new seam keys or builds after seal(): {counts} -> "
                                 f"{after}")
        trips = cm.guard_trips.labels(kind="transfer").get()
        try:
            with JG.transfer_window():
                torch.ones(1, device=dev).sum().item()
        except RuntimeError as exc:
            if "synchronizing" not in str(exc):
                raise
            planted = str(exc).splitlines()[0]
        else:
            raise AssertionError("guard: a planted .item() in the window did not raise")
        if cm.guard_trips.labels(kind="transfer").get() != trips + 1:
            raise AssertionError("guard: the planted sync did not count one transfer trip")
        retraces = cm.guard_trips.labels(kind="retrace").get()
        try:
            run_verify(unseen_keyed_batch(commit150, JG._SEEN.get("keyed", ())), dev)
        except JG.RetraceError as exc:
            retrace = str(exc).splitlines()[0]
        else:
            raise AssertionError("guard: a new launch signature after seal() did not raise")
        if cm.guard_trips.labels(kind="retrace").get() != retraces + 1:
            raise AssertionError("guard: the planted signature did not count one retrace trip")
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError("guard: the sync debug mode is still on after the window")
    finally:
        JG.reset()
        JG.enable(False)
        D.LADDER.reset()
    launches = end_phase("guard phase", threads0)
    print(f"guard phase [{smi}]: {seen} launch signatures seen in the process, {counts} new "
          f"in the warm-up; after seal() {GUARD_RUNS} verifies each of {list(tiers)} inside "
          f"the window: 0 new keys, 0 builds; p50 sealed / unsealed: " + ", ".join(
              f"{t} {1e3 * pct(lat[t], 50):.3f} / {1e3 * pct(base[t], 50):.3f} ms"
              for t in tiers))
    print(f"  planted .item() in the window: raised ({planted}), transfer trips +1; planted new "
          f"signature: {retrace}; launches {launches}")
    return dict(counts=counts, p50_ms={t: 1e3 * pct(v, 50) for t, v in lat.items()},
                base_p50_ms={t: 1e3 * pct(v, 50) for t, v in base.items()}, launches=launches)


# -- phase 15: persistence and the light client -------------------------

#: light-sync1024: BASELINE config 3 (light/verifier.go skipping sync, 10k
#: headers of 150-validator commits) at its full width, its depth cut to
#: SYNC_HEIGHTS; one original validator leaves and a newcomer joins at
#: every ROTATE_EVERY-th height
SYNC_HEIGHTS = 1024
SYNC_VALIDATORS = 150
ROTATE_EVERY = 8
SYNC_TXS = 4
SYNC_WARM_RUNS = 5


def open_stores(dirname: str):
    """(BlockStore, state.Store) over ``open_db(..., "sqlite", dirname)``."""
    from cometbft_tpu_torch.state import Store
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.utils.db import open_db

    bdb, sdb = open_db("blockstore", "sqlite", dirname), open_db("state", "sqlite", dirname)
    return BlockStore(bdb), Store(sdb), (bdb, sdb)


def sync_block(state, height: int, txs, last_commit, signer, by_addr, rs, app_hash=None):
    """The block ``state`` proposes at ``height`` (State.make_block, its
    hashes filled), its part set and BlockID, and the commit of
    ``state.validators`` over that BlockID (canonical precommits with
    per-vote timestamps)."""
    from dataclasses import replace

    from cometbft_tpu_torch.types import BlockID
    from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES

    t_ns = HEADER_T0 + height * BLOCK_NS
    block = state.make_block(height, txs, last_commit, (),
                             state.validators.get_proposer().address, t_ns)
    if app_hash is not None:
        block = replace(block, header=replace(block.header, app_hash=app_hash)).with_hashes()
    parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
    bid = BlockID(hash=block.hash(), part_set_header=parts.header)
    votes = precommits(signer, state.validators, by_addr, bid, height, t_ns + BLOCK_NS // 2, rs)
    return block, parts, bid, commit_of(votes, bid, height)


def store_chain(dirname: str, keys, newcomers, heights: int, every: int, rs, signer) -> dict:
    """Writes a chain of ``heights`` blocks into a block store and a state
    store over sqlite in ``dirname``, as a node writes them: each block
    (SYNC_TXS txs, the previous height's commit, its hashes) through
    ``BlockStore.save_block`` with its seen commit, and after it the next
    ``State`` (validators forward one height; at every ``every``-th
    height's set one original validator leaves and a newcomer joins,
    update_with_change_set then one proposer step) through
    ``state.Store.save``.  -> the sets by height, the rotated heights,
    what each height's block needs to be forked (state, last commit),
    and the save times."""
    from dataclasses import replace

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.state import State
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    block_store, state_store, dbs = open_stores(dirname)
    gen = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=HEADER_T0, validators=tuple(
        GenesisValidator(ed.Ed25519PubKey(pub), 10) for _, pub in keys))
    state = State.from_genesis(gen)
    state_store.save(state)
    by_addr = {ed.Ed25519PubKey(pub).address(): (a, pub) for a, pub in keys}
    originals = set(by_addr)
    sets, rotated, saves = {1: state.validators, 2: state.next_validators}, [], []
    last_commit, top = None, {}
    for h in range(1, heights + 1):
        txs = tuple(b"tx-%d-%d|" % (h, i) + rs.bytes(64) for i in range(SYNC_TXS))
        block, parts, bid, commit = sync_block(state, h, txs, last_commit, signer, by_addr, rs)
        if h == heights:
            top = dict(state=state, last_commit=last_commit, txs=txs)
        t0 = time.perf_counter()
        block_store.save_block(block, parts, commit)
        saves.append(time.perf_counter() - t0)
        nxt, changed = state.next_validators.copy(), state.last_height_validators_changed
        if (h + 2) % every == 1:
            left = sorted(v.address for v in nxt.validators if v.address in originals)
            out_v = nxt.get_by_address(left[(7 * h) % len(left)])[1]
            a, pub = newcomers.pop(0)
            by_addr[ed.Ed25519PubKey(pub).address()] = (a, pub)
            nxt = nxt.update_with_change_set([(out_v.pub_key, 0),
                                              (ed.Ed25519PubKey(pub), 10)])
            changed = h + 2
            if h + 2 <= heights:
                rotated.append(h + 2)
        state = replace(
            state, last_block_height=h, last_block_id=bid, last_block_time_ns=block.header.time_ns,
            validators=state.next_validators.copy(),
            next_validators=nxt.increment_proposer_priority(1),
            last_validators=state.validators.copy(), last_height_validators_changed=changed,
            app_hash=hashlib.sha256(b"app-%d" % h).digest())
        sets[h + 2] = state.next_validators
        state_store.save(state)
        last_commit = commit
    for db in dbs:
        db.close()
    return dict(sets=sets, rotated=rotated, originals=originals, by_addr=by_addr, top=top,
                saves=saves)


def db_mib(dirname: str) -> float:
    return sum(os.path.getsize(os.path.join(dirname, f)) for f in os.listdir(dirname)) / 2**20


def copy_stores(src: str, dst: str) -> None:
    """A copy of the closed sqlite files of ``src`` in ``dst``."""
    import shutil

    os.makedirs(dst)
    for f in os.listdir(src):
        shutil.copy2(os.path.join(src, f), os.path.join(dst, f))


class HopLog:
    """Wraps light.client's ``_verify`` and ``verify_adjacent`` while
    installed: each check's (trusted height, new height, outcome, ms)."""

    def __init__(self) -> None:
        from cometbft_tpu_torch.light import client as LC

        self.LC, self.hops = LC, []

    def _wrap(self, fn):
        def run(trusted, untrusted, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                fn(trusted, untrusted, *args, **kwargs)
            except Exception as exc:
                self.hops.append((trusted.height, untrusted.height, type(exc).__name__,
                                  1e3 * (time.perf_counter() - t0)))
                raise
            self.hops.append((trusted.height, untrusted.height, "ok",
                              1e3 * (time.perf_counter() - t0)))
        return run

    def __enter__(self) -> "HopLog":
        self.saved = self.LC._verify, self.LC.verify_adjacent
        self.LC._verify, self.LC.verify_adjacent = (self._wrap(f) for f in self.saved)
        return self

    def __exit__(self, *exc) -> None:
        self.LC._verify, self.LC.verify_adjacent = self.saved


def need_launches(what: str, got: dict, want: dict, may: tuple = ()) -> None:
    """Fails unless every kernel in ``want`` launched at least that often
    and no kernel outside ``want`` and ``may`` launched (an empty
    ``want``: none)."""
    short = {k: got.get(k, 0) for k, n in want.items() if got.get(k, 0) < n}
    extra = {k: n for k, n in got.items() if k not in want and k not in may}
    if short or extra:
        raise AssertionError(f"{what}: launches {got}, expected at least {want} and no other")


def light_sync_phase(dev, smi: str, heights: int = SYNC_HEIGHTS, nval: int = SYNC_VALIDATORS,
                     every: int = ROTATE_EVERY) -> dict:
    """Phase 15, light-sync1024: a ``heights``-block chain of ``nval``
    validators (store_chain) in sqlite stores, closed and opened again;
    then light.client.Client over NodeProviders of those stores on a
    fresh KeyTableCache: the skipping sync from height 1 to the top (cold
    once, then warm on fresh LightStores; bisection must be needed), a
    sequential sync to height 64, a backwards check from a trust root at
    the top to 24 heights below it (no launch), three refusals (a flipped signature in a third
    store, an expired root, a missing height) and an attack (a witness
    whose store holds a conflicting top block: ErrLightClientAttack, one
    LightClientAttackEvidence to each provider).  (e2): the primary holds
    an evidence ``Pool`` over the main stores, so the evidence it is sent
    goes through ``Pool.add_evidence`` -- the lunatic check, every
    signature of the conflicting commit verified twice on the keyed tier
    (its +1/3 of the common set, its own set's +2/3), launches counted
    around the call -- and stays pending; a copy of it naming one
    byzantine validator fewer is refused with the reference's message.
    The launch counters at 0 before each run; every check on the keyed or
    host tier."""
    import shutil
    import tempfile
    from dataclasses import replace

    from cometbft_tpu_torch.evidence import EvidenceInvalidError, Pool
    from cometbft_tpu_torch.light import client as LC
    from cometbft_tpu_torch.light import verifier as LV
    from cometbft_tpu_torch.light.provider import LightBlockNotFoundError, NodeProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.store import _COMMIT, _hkey
    from cometbft_tpu_torch.types import codec
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.utils.db import MemDB

    class RecordingProvider(NodeProvider):
        """A NodeProvider that keeps the evidence it is sent and the
        seconds its light_block calls took (``load_s``)."""

        def __init__(self, *args) -> None:
            super().__init__(*args)
            self.reported: list = []
            self.load_s = 0.0

        def light_block(self, height: int):
            t0 = time.perf_counter()
            try:
                return super().light_block(height)
            finally:
                self.load_s += time.perf_counter() - t0

        def report_evidence(self, ev) -> None:
            self.reported.append(ev)
            super().report_evidence(ev)

    warm_runs, seq_to, back_to = SYNC_WARM_RUNS, min(64, heights), max(1, heights - 24)
    t_phase = time.perf_counter()
    threads = live_threads()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="light_sync_", dir=root)
    key = str(dev)
    saved_cache = PR._caches.get(key)
    PR._caches[key] = PR.KeyTableCache(dev)
    res: dict = {}
    opened: list = []
    try:
        rs = np.random.RandomState(SEED + 15)
        signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
        t0 = time.perf_counter()
        keys = seeded_keys(b"sync-validator", nval)
        newcomers = seeded_keys(b"sync-newcomer", heights // every + 1)
        t_keys = time.perf_counter() - t0
        main_dir = os.path.join(work, "main")
        chain = store_chain(main_dir, keys, newcomers, heights, every, rs, signer)
        t_data = time.perf_counter() - t0
        sets, rotated, originals = chain["sets"], chain["rotated"], chain["originals"]
        left = sum(v.address in originals for v in sets[heights].validators)
        saves = chain["saves"]
        mib = db_mib(main_dir)
        print(f"light-sync{heights} [{smi}]: BASELINE config 3 (light/verifier.go skipping "
              f"sync, 10k headers x 150-validator commits) at {nval} validators, depth cut to "
              f"{heights} heights")
        print(f"  data: {t_data:.2f} s ({t_keys:.2f} s of it the keys): {heights} blocks of "
              f"{SYNC_TXS} txs, {heights * nval} precommits, {len(rotated)} rotations (a set "
              f"in {every}: an original validator out, a newcomer in), {left} of the "
              f"{nval} originals left at height {heights}; save_block p50 "
              f"{1e3 * pct(saves, 50):.3f} ms, max {1e3 * max(saves):.3f} ms; sqlite files "
              f"{mib:.2f} MiB")
        res.update(data_s=t_data, save_p50_ms=1e3 * pct(saves, 50),
                   save_max_ms=1e3 * max(saves), db_mib=mib, rotations=len(rotated),
                   originals_left=left)

        # a third store: one flipped signature byte in the commit at height
        # heights // 2 (stored with the next block), the lane every check of
        # that commit sends first; and a witness's store whose top block
        # conflicts (another app_hash, the same signers)
        bad_h = heights // 2
        bad_dir, fork_dir = os.path.join(work, "bad"), os.path.join(work, "fork")
        copy_stores(main_dir, bad_dir)
        copy_stores(main_dir, fork_dir)
        bstore, sstore, dbs = open_stores(bad_dir)
        bad_commit = bstore.load_block_commit(bad_h)
        sig0 = bad_commit.signatures[0]
        flipped = sig0.signature[:40] + bytes([sig0.signature[40] ^ 1]) + sig0.signature[41:]
        bad_commit = replace(bad_commit, signatures=(replace(sig0, signature=flipped),)
                             + bad_commit.signatures[1:])
        dbs[0].set(_hkey(_COMMIT, bad_h), codec.encode_commit(bad_commit))
        for db in dbs:
            db.close()
        fstore, _, dbs = open_stores(fork_dir)
        top = chain["top"]
        fstore.prune_last_block()
        fork_block, fork_parts, _, fork_commit = sync_block(
            top["state"], heights, top["txs"], top["last_commit"], signer, chain["by_addr"], rs,
            app_hash=hashlib.sha256(b"forked app state").digest())
        fstore.save_block(fork_block, fork_parts, fork_commit)
        for db in dbs:
            db.close()

        # everything from here reads stores opened again
        t0 = time.perf_counter()
        stores = {}
        for name in ("main", "bad", "fork"):
            b, s, dbs = open_stores(os.path.join(work, name))
            opened.extend(dbs)
            stores[name] = (b, s)
        block_store, state_store = stores["main"]
        if (block_store.base(), block_store.height()) != (1, heights):
            raise AssertionError(f"light-sync: reopened store holds {block_store.base()}.."
                                 f"{block_store.height()}")
        pool = Pool(MemDB(), state_store, block_store, device=dev)
        pool_calls: list = []
        add_evidence = pool.add_evidence

        def counted_add_evidence(ev) -> None:
            before = launched()
            t1 = time.perf_counter()
            try:
                add_evidence(ev)
            finally:
                after = launched()
                pool_calls.append((time.perf_counter() - t1, {
                    k: after.get(k, 0) - before.get(k, 0) for k in after
                    if after.get(k, 0) != before.get(k, 0)}))

        pool.add_evidence = counted_add_evidence
        primary = RecordingProvider(CHAIN_ID, block_store, state_store, pool)
        witness = RecordingProvider(CHAIN_ID, block_store, state_store)
        sample = list(range(1, heights + 1, max(1, heights // 64)))
        loads, lbs = [], []
        for h in sample:
            t1 = time.perf_counter()
            block = block_store.load_block(h)
            loads.append(time.perf_counter() - t1)
            if block.hash() != block_store.load_block_meta(h).block_id.hash:
                raise AssertionError(f"light-sync: block {h} loads with another hash")
            t1 = time.perf_counter()
            primary.light_block(h)
            lbs.append(time.perf_counter() - t1)
        print(f"  reopened: {time.perf_counter() - t0:.3f} s for {len(sample)} loads; load_block "
              f"p50 {1e3 * pct(loads, 50):.3f} ms, NodeProvider.light_block p50 "
              f"{1e3 * pct(lbs, 50):.3f} ms")
        res.update(load_block_p50_ms=1e3 * pct(loads, 50),
                   light_block_p50_ms=1e3 * pct(lbs, 50))

        lb1 = primary.light_block(1)
        trust = LC.TrustOptions(period_ns=TRUSTING_NS, height=1,
                                hash=block_store.load_block_meta(1).block_id.hash)
        now = HEADER_T0 + (heights + 10) * BLOCK_NS

        def client(provider, witnesses, mode=LC.SKIPPING, options=trust):
            return LC.Client(CHAIN_ID, options, provider, witnesses, LightStore(MemDB()),
                             verification_mode=mode, device=dev)

        # -- skipping sync, cold then warm --------------------------------
        walls, runs = [], []
        for run in range(1 + warm_runs):
            _build.reset_launches()
            primary.load_s = witness.load_s = 0.0
            with FactoryLog() as log, HopLog() as hops:
                t0 = time.perf_counter()
                c = client(primary, [witness])
                got = c.update(now=now)
                wall = time.perf_counter() - t0
                checks = log.take()
            launches = launched()
            if got is None or got.height != heights or got.hash() != \
                    block_store.load_block_meta(heights).block_id.hash:
                raise AssertionError(f"light-sync: update reached {got and got.height}")
            trusted = [h for h in range(1, heights + 1) if c.store.get(h) is not None]
            runs.append(dict(wall=wall, hops=hops.hops, checks=checks, launches=launches,
                             trusted=trusted, load_ms=1e3 * (primary.load_s + witness.load_s),
                             check_ms=sum(ms for *_, ms in hops.hops)))
            if run:
                walls.append(wall)
            bad_tier = [t for _, t in checks if t not in ("keyed", "host")]
            if bad_tier:
                raise AssertionError(f"light-sync: checks answered by {bad_tier}")
        cold = runs[0]
        need_launches("light-sync, cold", cold["launches"],
                      {"build_tables": 1, "sha512_keyed": 1, "verify_keyed": 1})
        for r in runs[1:]:
            need_launches("light-sync, warm", r["launches"],
                          {"sha512_keyed": 1, "verify_keyed": 1})
        first = cold["hops"][0]
        if first[:2] != (1, heights) or first[2] != "ErrNewValSetCantBeTrusted":
            raise AssertionError(f"light-sync: the first skip was {first}, not a refused "
                                 f"1 -> {heights}")
        path = [1] + [b for a, b, how, _ in cold["hops"] if how == "ok"]
        if path != [1, heights // 2, heights] or cold["trusted"] != path:
            raise AssertionError(f"light-sync: verified path {path}, trusted "
                                 f"{cold['trusted']}, expected 1 -> {heights // 2} -> {heights}")
        tally = {}
        for sent, tier in cold["checks"]:
            tally[f"{sent} sigs, {tier}"] = tally.get(f"{sent} sigs, {tier}", 0) + 1
        split = {k: pct([r[k] for r in runs[1:]], 50) for k in ("load_ms", "check_ms")}
        res.update(cold_ms=1e3 * cold["wall"], warm_p50_ms=1e3 * pct(walls, 50), warm_split=split,
                   path=path, cold_launches=cold["launches"],
                   warm_launches=runs[-1]["launches"], checks=cold["checks"])
        print(f"  skipping sync 1 -> {heights}, cold: {1e3 * cold['wall']:.3f} ms; checks "
              f"(trusted, new, outcome, ms): " + ", ".join(
                  f"({a}, {b}, {how}, {ms:.3f})" for a, b, how, ms in cold["hops"]))
        print(f"    bisection visited {path}; signatures sent and tier per verifier "
              f"{cold['checks']} ({tally}); launches {cold['launches']}")
        print(f"  skipping sync, warm on a fresh LightStore x{warm_runs}: p50 "
              f"{1e3 * pct(walls, 50):.3f} ms (" + ", ".join(f"{1e3 * w:.3f}" for w in walls)
              + f" ms); launches per run {runs[-1]['launches']}; p50 of its parts: the "
              f"providers' light_block {split['load_ms']:.3f} ms (the witness's included), the "
              f"header checks {split['check_ms']:.3f} ms, the rest (the root's own commit, "
              f"validate_basic, the LightStore) the remainder")

        # -- sequential, then backwards ------------------------------------
        _build.reset_launches()
        with FactoryLog() as log, HopLog() as hops:
            c = client(primary, [], mode=LC.SEQUENTIAL)
            t0 = time.perf_counter()
            c.verify_light_block_at_height(seq_to, now)
            seq_wall = time.perf_counter() - t0
            seq_checks = log.take()
        steps = [ms for a, b, how, ms in hops.hops if b == a + 1 and how == "ok"]
        if len(steps) != seq_to - 1 or len(hops.hops) != seq_to - 1:
            raise AssertionError(f"light-sync: sequential took {hops.hops}")
        # a rotation's newcomer not yet in the pool is built on its way
        need_launches("light-sync, sequential", launched(),
                      {"sha512_keyed": seq_to, "verify_keyed": seq_to}, may=("build_tables",))
        seq_sent = sorted({s for s, _ in seq_checks[1:]})
        seq_tiers = sorted({t for _, t in seq_checks})
        res.update(seq_p50_ms=pct(steps, 50), seq_wall_ms=1e3 * seq_wall)
        print(f"  sequential 1 -> {seq_to}: {seq_to - 1} adjacent checks, p50 "
              f"{pct(steps, 50):.3f} ms a header, {1e3 * seq_wall:.3f} ms in all; signatures "
              f"sent per check {seq_sent}, tiers {seq_tiers}; launches {launched()}")
        top_trust = LC.TrustOptions(period_ns=TRUSTING_NS, height=heights,
                                    hash=block_store.load_block_meta(heights).block_id.hash)
        c = client(primary, [], options=top_trust)
        _build.reset_launches()
        t0 = time.perf_counter()
        back = c.verify_light_block_at_height(back_to, now)
        back_wall = time.perf_counter() - t0
        need_launches("light-sync, backwards", launched(), {})
        if back.hash() != block_store.load_block_meta(back_to).block_id.hash:
            raise AssertionError("light-sync: backwards verification gave another block")
        res.update(back_ms=1e3 * back_wall)
        print(f"  backwards {heights} -> {back_to} by hash links: {1e3 * back_wall:.3f} ms, "
              f"launches {launched() or 'none'}")

        # -- refusals ------------------------------------------------------
        bad = NodeProvider(CHAIN_ID, *stores["bad"])
        _build.reset_launches()
        with FactoryLog() as log:
            expect_error("light-sync, a flipped signature",
                         lambda: client(bad, []).update(now=now),
                         LV.ErrInvalidHeader, "invalid commit: wrong signature (#0)")
            refused = log.take()
        need_launches("light-sync, a flipped signature", launched(),
                      {"sha512_keyed": 1, "verify_keyed": 1})
        if refused[-1][1] != "keyed":
            raise AssertionError(f"light-sync: the flipped signature was refused by "
                                 f"{refused[-1]}, not the keyed tier")
        short = LC.TrustOptions(period_ns=BLOCK_NS, height=1, hash=trust.hash)
        expiry = lb1.time_ns + BLOCK_NS
        expect_error("light-sync, an expired trust root",
                     lambda: client(primary, [], options=short).update(now=now),
                     LV.ErrOldHeaderExpired, f"trusted header expired at {expiry} (now {now})")
        expect_error("light-sync, a height the primary lacks",
                     lambda: client(primary, []).verify_light_block_at_height(heights + 1, now),
                     LightBlockNotFoundError, f"no block at height {heights + 1}")
        print(f"  refusals as the reference's: a flipped signature at height {bad_h} -> "
              f"ErrInvalidHeader after {len(refused)} verifiers (the last {refused[-1]}); an "
              f"expired trust root -> ErrOldHeaderExpired; height {heights + 1} -> "
              f"LightBlockNotFoundError")

        # -- an attack -----------------------------------------------------
        forked = RecordingProvider(CHAIN_ID, *stores["fork"])
        c = client(primary, [forked])
        want_w = forked.light_block(heights).hash()
        want_p = block_store.load_block_meta(heights).block_id.hash
        expect_error("light-sync, a forked witness", lambda: c.update(now=now),
                     LC.ErrLightClientAttack,
                     f"witness header {want_w.hex()[:12]} conflicts with primary "
                     f"{want_p.hex()[:12]} at height {heights}")
        if len(primary.reported) != 1 or len(forked.reported) != 1 or not all(
                isinstance(ev, LightClientAttackEvidence)
                for ev in primary.reported + forked.reported):
            raise AssertionError(f"light-sync: evidence reported {primary.reported!r} / "
                                 f"{forked.reported!r}")
        ev = primary.reported[0]
        common = heights // 2
        signers = {cs.validator_address for cs in
                   forked.light_block(heights).commit.signatures if cs.is_commit()}
        byz = signers & {v.address for v in sets[common].validators}
        for e in (ev, forked.reported[0]):
            if e.common_height != common or set(e.byzantine_validators) != byz:
                raise AssertionError(f"light-sync: evidence at common height "
                                     f"{e.common_height} names {len(e.byzantine_validators)} "
                                     f"validators, expected {len(byz)} at {common}")
        size = len(codec.encode_evidence(ev))
        res.update(evidence_hash=ev.hash().hex(), evidence_bytes=size, byzantine=len(byz))
        print(f"  attack: a witness with a conflicting block {heights} (another app_hash, "
              f"{len(signers)} signers) -> ErrLightClientAttack; one LightClientAttackEvidence "
              f"to each provider; common height {common}; byzantine validators: the "
              f"{len(byz)} signers bonded at the common height; evidence to the primary "
              f"{ev.hash().hex()}, {size} bytes")

        # -- (e2) the evidence through the primary's pool -------------------
        if len(pool_calls) != 1 or [e.hash() for e in pool.pending_evidence(-1)[0]] != \
                [ev.hash()]:
            raise AssertionError(f"light-sync (e2): {len(pool_calls)} add_evidence calls, "
                                 f"pending {pool.pending_evidence(-1)[0]!r}")
        add_s, add_launches = pool_calls[0]
        need_launches("light-sync (e2), Pool.add_evidence", add_launches,
                      {"sha512_keyed": 1, "verify_keyed": 1}, may=("build_tables",))
        fewer = replace(ev, byzantine_validators=ev.byzantine_validators[1:])
        _build.reset_launches()
        t0 = time.perf_counter()
        expect_error("light-sync (e2), one byzantine validator fewer",
                     lambda: pool.verify(fewer), EvidenceInvalidError,
                     "byzantine validator list does not match the conflicting commit's signers")
        refuse_s = time.perf_counter() - t0
        refuse_launches = launched()
        need_launches("light-sync (e2), the refused copy", refuse_launches,
                      {"sha512_keyed": 1, "verify_keyed": 1})
        res.update(evidence_add_ms=1e3 * add_s, evidence_add_launches=add_launches,
                   evidence_refuse_ms=1e3 * refuse_s, evidence_refuse_launches=refuse_launches)
        print(f"  (e2) Pool.add_evidence on the primary's stores: the lunatic check "
              f"(+1/3 of the {len(sets[common])}-validator set at {common}, +2/3 of the "
              f"conflicting set, every signature) in {1e3 * add_s:.3f} ms, launches "
              f"{add_launches}; pending; the copy naming {len(byz) - 1} validators refused "
              f"(EvidenceInvalidError, the reference's message) in {1e3 * refuse_s:.3f} ms, "
              f"launches {refuse_launches}")
    finally:
        for db in opened:
            db.close()
        shutil.rmtree(work)
        if saved_cache is None:
            PR._caches.pop(key, None)
        else:
            PR._caches[key] = saved_cache
    res["launches"] = end_phase("light sync", threads)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"  light sync phase: {res['wall_s']:.2f} s")
    return res


# -- phase 16: blocksync catch-up ------------------------------------------

#: blocksync1024: BASELINE config 4 (internal/blocksync fast-sync replay, 1k
#: blocks x 1k-validator commits) at full width: BS_HEIGHTS applied blocks
#: and one more, whose LastCommit commits the last; a val: tx pair every
#: BS_ROTATE_EVERY heights brings a newcomer in at power 10 and takes an
#: original to power 0.  Depth cut from 1000 to 512: timed on an NVIDIA
#: H100 host (PERF.md section 4), 64 heights' build and three syncs put
#: 1000 heights beyond 1000 s
BS_HEIGHTS = 256
BS_VALIDATORS = 1024
BS_ROTATE_EVERY = 64
BS_TXS = 4
BS_BAD_HEIGHT = 200
BS_SIGNERS = 8


class ConsensusRecorder:
    """Stands in for the consensus reactor: keeps the state blocksync
    hands over and when."""

    def __init__(self) -> None:
        self.states: list = []
        self.at = None
        self.done = threading.Event()

    def switch_to_consensus(self, state) -> None:
        self.states.append(state)
        self.at = time.perf_counter()
        self.done.set()


# One worker of SignerPool: reads pickled (height, block id, votes) jobs from
# stdin and writes each job's signatures, until it reads None.
_SIGN_WORKER = (
    "import pickle, sys\n"
    "from chip_smoke import CHAIN_ID, FastSigner\n"
    "from cometbft_tpu_torch.types import PRECOMMIT_TYPE, BlockID, PartSetHeader, Vote\n"
    "signer = FastSigner(int(sys.argv[1]))\n"
    "inp, out = sys.stdin.buffer, sys.stdout.buffer\n"
    "while True:\n"
    "    job = pickle.load(inp)\n"
    "    if job is None:\n"
    "        break\n"
    "    height, (h, total, ph), votes = job\n"
    "    bid = BlockID(hash=h, part_set_header=PartSetHeader(total=total, hash=ph))\n"
    "    jobs = [(a, pub, Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,\n"
    "                          timestamp_ns=ts, validator_address=addr,\n"
    "                          validator_index=idx).sign_bytes(CHAIN_ID))\n"
    "            for idx, a, pub, addr, ts in votes]\n"
    "    pickle.dump(signer.sign_all(jobs), out)\n"
    "    out.flush()\n"
)


class SignerPool:
    """``n`` worker processes that sign a height's precommits in parallel,
    worker k with FastSigner nonces from r0 + k * 2**48 (disjoint ranges).
    Plain subprocesses, each killed in ``close`` if it has not ended."""

    def __init__(self, n: int, r0: int) -> None:
        from cometbft_tpu_torch.crypto import edwards as E

        root = os.path.dirname(os.path.abspath(__file__))
        self.procs = []
        try:
            for k in range(n):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _SIGN_WORKER, str((r0 + k * 2**48) % E.L)],
                    cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        except BaseException:
            self.close()
            raise
        self._busy: list = []

    def submit(self, height: int, bid, votes) -> None:
        """Starts signing ``votes`` ((index, scalar, public key, address,
        timestamp) each) for ``bid`` at ``height``."""
        import pickle

        step = -(-len(votes) // len(self.procs))
        key = (bid.hash, bid.part_set_header.total, bid.part_set_header.hash)
        self._busy = []
        for proc, i in zip(self.procs, range(0, len(votes), step)):
            pickle.dump((height, key, votes[i : i + step]), proc.stdin)
            proc.stdin.flush()
            self._busy.append(proc)

    def collect(self) -> list[bytes]:
        """The signatures of the last ``submit``, in its order."""
        import pickle

        sigs: list[bytes] = []
        for proc in self._busy:
            sigs += pickle.load(proc.stdout)
        return sigs

    def close(self) -> None:
        import pickle

        for proc in self.procs:
            try:
                pickle.dump(None, proc.stdin)
                proc.stdin.close()
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 -- the worker is killed below
                pass
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def bs_txs(h: int, ntx: int, rs) -> list[bytes]:
    """``ntx`` kvstore txs ``k<h>-<i>=<hex>`` of 64 to 100 bytes."""
    out = []
    for i in range(ntx):
        head = b"k%d-%d=" % (h, i)
        n = int(rs.randint(64, 101)) - len(head)
        out.append(head + rs.bytes(n // 2 + 1).hex().encode()[:n])
    return out


def db_image(db) -> dict:
    """key -> sha256 of the value, over every key of ``db``."""
    return {bytes(k): hashlib.sha256(bytes(v)).digest() for k, v in db.iterator()}


def bs_node(dirname: str, gen, dev, validate: bool = True, snapshot_interval: int = 0):
    """A node's stores, app and executor: sqlite block and state stores in
    ``dirname`` (the genesis state saved), a KVStoreApp over a MemDB after
    InitChain with the genesis set (a snapshot every ``snapshot_interval``
    heights, 0: none), its local proxy connections and an EventBus.
    ``validate=False``: the executor trusts the blocks (the source node
    builds its own chain; the syncing node validates every block).
    -> dict."""
    from cometbft_tpu_torch.abci import InitChainRequest, ValidatorUpdate
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.mempool import NopMempool
    from cometbft_tpu_torch.proxy import local_client_creator, new_app_conns
    from cometbft_tpu_torch.state import State
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.types.event_bus import EventBus
    from cometbft_tpu_torch.utils.db import MemDB
    from cometbft_tpu_torch.utils.log import NopLogger

    block_store, state_store, dbs = open_stores(dirname)
    state = State.from_genesis(gen)
    state_store.save(state)
    app_db = MemDB()
    app = KVStoreApp(app_db, snapshot_interval=snapshot_interval)
    app.init_chain(InitChainRequest(chain_id=gen.chain_id, validators=tuple(
        ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power) for v in gen.validators)))
    conns = new_app_conns(local_client_creator(app))
    conns.start()
    bus = EventBus()
    bus.start()
    ex = BlockExecutor(state_store, conns.consensus, NopMempool(), block_store=block_store,
                       event_bus=bus, logger=NopLogger(), device=dev)
    if not validate:
        ex.validate_block = lambda state, block: None
    return dict(block_store=block_store, state_store=state_store, dbs=dbs, state=state, app=app,
                app_db=app_db, conns=conns, bus=bus, exec=ex)


def close_node(node: dict) -> None:
    for svc in (node["conns"], node["bus"]):
        if svc.is_running():
            svc.stop()
    for db in node["dbs"]:
        db.close()


def bs_chain(work: str, dev, heights: int, nval: int, every: int, ntx: int, rs,
             nsigners: int = BS_SIGNERS, snapshot_interval: int = 0, cut: int = 0) -> dict:
    """Builds the served chain as a node does, one height after another:
    State.make_block (time: the median of the last commit's timestamps),
    BlockExecutor.apply_block over a KVStoreApp, save_block with the
    height's commit: every validator of the height's own set precommits
    with its own timestamp, signed in ``nsigners`` worker processes while
    the block applies.  At every ``every``-th height two val: txs bring a
    newcomer in at power 10 and take an original to power 0 (the set two
    heights later).  After height ``heights`` the stores' images, the
    app's persisted record and the state are kept; then block heights + 1
    (not applied) carries the last commit.  The app (``app``; a snapshot
    every ``snapshot_interval`` heights) outlives the node.  ``cut`` (0:
    none): the same images, record, hash and state as they stood after
    height ``cut`` are kept under "cut".  -> dict."""
    import base64

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.state import encode_state
    from cometbft_tpu_torch.state.execution import median_time
    from cometbft_tpu_torch.types import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES

    t0 = time.perf_counter()
    keys = seeded_keys(b"bs-validator", nval)
    newcomers = seeded_keys(b"bs-newcomer", heights // every + 1)
    t_keys = time.perf_counter() - t0
    gen = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=HEADER_T0, validators=tuple(
        GenesisValidator(ed.Ed25519PubKey(pub), 10) for _, pub in keys))
    src_dir = os.path.join(work, "source")
    node = bs_node(src_dir, gen, dev, validate=False, snapshot_interval=snapshot_interval)
    by_addr = {ed.Ed25519PubKey(pub).address(): (a, pub) for a, pub in keys}
    originals = sorted(pub for _, pub in keys)
    signers = SignerPool(nsigners, int.from_bytes(rs.bytes(32), "little"))
    state, last_commit, out = node["state"], None, {}
    sign_s = apply_s = save_s = 0.0
    rotations, ntxs = [], 0
    try:
        for h in range(1, heights + 2):
            if h == cut + 1 and cut:
                out["cut"] = dict(block_image=db_image(node["dbs"][0]),
                                  state_image=db_image(node["dbs"][1]),
                                  app_record=node["app_db"].get(b"kvstore:state"),
                                  app_hash=node["app"].app_hash, state=encode_state(state),
                                  height=state.last_block_height)
            txs = bs_txs(h, ntx, rs)
            if h <= heights and h % every == 0:
                a, pub = newcomers.pop(0)
                by_addr[ed.Ed25519PubKey(pub).address()] = (a, pub)
                gone = originals.pop((7 * h) % len(originals))
                txs += [b"val:%s!10" % base64.b64encode(pub), b"val:%s!0" % base64.b64encode(gone)]
                rotations.append(h)
            ntxs += len(txs)
            t_ns = (state.last_block_time_ns if h == 1
                    else median_time(last_commit, state.last_validators))
            block = state.make_block(h, tuple(txs),
                                     last_commit if last_commit is not None else Commit(), (),
                                     state.validators.get_proposer().address, t_ns)
            parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
            bid = BlockID(hash=block.hash(), part_set_header=parts.header)
            t1 = time.perf_counter()
            votes = []
            for idx, v in enumerate(state.validators.validators):
                a, pub = by_addr[v.address]
                votes.append((idx, a, pub, v.address,
                              t_ns + BLOCK_NS // 2 + int(rs.randint(0, 10**9))))
            signers.submit(h, bid, votes)
            t2 = time.perf_counter()
            if h <= heights:
                state = node["exec"].apply_block(state, bid, block)
            t3 = time.perf_counter()
            sigs = signers.collect()
            commit = Commit(height=h, round=0, block_id=bid, signatures=tuple(
                CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=addr,
                          timestamp_ns=ts, signature=sig)
                for (_, _, _, addr, ts), sig in zip(votes, sigs)))
            t4 = time.perf_counter()
            if h > heights:
                out.update(block_image=db_image(node["dbs"][0]),
                           state_image=db_image(node["dbs"][1]),
                           app_record=node["app_db"].get(b"kvstore:state"),
                           app_hash=node["app"].app_hash, state=encode_state(state),
                           height=state.last_block_height)
            node["block_store"].save_block(block, parts, commit)
            t5 = time.perf_counter()
            sign_s += (t2 - t1) + (t4 - t3)
            apply_s += t3 - t2
            save_s += t5 - t4
            last_commit = commit
    finally:
        signers.close()
        close_node(node)
    out.update(gen=gen, src_dir=src_dir, app=node["app"], rotations=rotations, txs=ntxs,
               keys_s=t_keys,
               data_s=time.perf_counter() - t0, sign_s=sign_s, apply_s=apply_s, save_s=save_s,
               originals_left=len(originals), mib=db_mib(src_dir))
    return out


def bs_byzantine(src_dir: str, dst_dir: str, height: int) -> None:
    """A copy of the source's stores in which block ``height`` carries its
    LastCommit with signature #0 flipped: its parts and meta rewritten
    (the header, hence the block hash, unchanged)."""
    from dataclasses import replace

    from cometbft_tpu_torch.store import _META, _hkey, _pkey
    from cometbft_tpu_torch.types import codec
    from cometbft_tpu_torch.types.block_meta import BlockMeta
    from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES

    copy_stores(src_dir, dst_dir)
    block_store, _, dbs = open_stores(dst_dir)
    try:
        block = block_store.load_block(height)
        lc = block.last_commit
        sig0 = lc.signatures[0]
        flipped = sig0.signature[:40] + bytes([sig0.signature[40] ^ 1]) + sig0.signature[41:]
        bad = replace(block, last_commit=replace(
            lc, signatures=(replace(sig0, signature=flipped),) + lc.signatures[1:]))
        parts = bad.make_part_set(BLOCK_PART_SIZE_BYTES)
        old = block_store.load_block_meta(height).block_id.part_set_header.total
        if parts.header.total != old:
            raise AssertionError(f"blocksync: the flipped block has {parts.header.total} parts, "
                                 f"not {old}")
        ops = [(_pkey(height, i), codec.encode_part(parts.get_part(i)))
               for i in range(parts.header.total)]
        ops.append((_hkey(_META, height), BlockMeta.from_parts(bad, parts).encode()))
        dbs[0].write_batch(ops)
    finally:
        for db in dbs:
            db.close()


class Handshakes:
    """Stands in for ``handshake_duration_seconds`` in the installed
    P2PMetrics: forwards each observation to the histogram and keeps it."""

    def __init__(self, histogram) -> None:
        self.histogram, self.seconds = histogram, []

    def observe(self, value: float) -> None:
        self.seconds.append(value)
        self.histogram.observe(value)


class ThreadCPU:
    """CPU seconds (user + system: /proc/<pid>/task/<tid>/stat, in clock
    ticks) each thread spent between ``start`` and ``stop``.  A ``sh``
    loop outside the interpreter reads every thread's counters each
    ``period`` seconds, so the sampling takes no interpreter time from the
    threads it measures and a thread that ends keeps its last sample;
    ``stop`` reads the living threads once more.  ``roles`` maps a
    thread's native id to a label; the rest go under their Python names,
    threads Python did not start (torch's, the CUDA driver's) under
    "native threads", and an unlabelled thread that ended under
    "ended (unnamed)"."""

    def __init__(self, period: float = 1.0) -> None:
        self.tick = os.sysconf("SC_CLK_TCK")
        self.period = period
        self.roles: dict = {}
        self._alive0: dict = {}     # native id -> name, at start
        self._proc = self._out = None
        self.process0 = self.wall0 = 0.0

    def _stat_cpu(self, line: str) -> tuple[int, float]:
        fields = line.rsplit(")", 1)[1].split()
        return int(line.split(" ", 1)[0]), (int(fields[11]) + int(fields[12])) / self.tick

    def start(self) -> None:
        import tempfile

        self._alive0 = {t.native_id: t.name for t in threading.enumerate()}
        self._out = tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            ["sh", "-c", f"while :; do cat /proc/{os.getpid()}/task/*/stat 2>/dev/null; "
                         f"echo; sleep {self.period}; done"],
            stdout=self._out, stderr=subprocess.DEVNULL, start_new_session=True)
        self.process0, self.wall0 = time.process_time(), time.perf_counter()

    def close(self) -> None:
        """Kills the loop's process group (the shell, and its ``cat`` or
        ``sleep``) and reaps the shell."""
        if self._proc is None:
            return
        os.killpg(self._proc.pid, signal.SIGKILL)
        self._proc.wait()
        self._proc = None

    def stop(self) -> dict:
        """-> {label: CPU s} and, under "process" and "wall", the
        process's CPU seconds and the wall seconds since ``start``."""
        out = {"process": time.process_time() - self.process0,
               "wall": time.perf_counter() - self.wall0}
        names = {t.native_id: t.name for t in threading.enumerate()}
        lines = []
        for tid in names:
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    lines.append(f.read())
            except OSError:       # the thread ended after enumerate()
                pass
        self.close()
        self._out.seek(0)
        samples = self._out.read().decode().split("\n\n")
        self._out.close()
        first: dict = {}
        last: dict = {}
        for line in samples[0].splitlines():
            tid, cpu = self._stat_cpu(line)
            first[tid] = last[tid] = cpu
        for line in "\n".join(samples[1:] + lines).splitlines():
            if ")" in line:
                tid, cpu = self._stat_cpu(line)
                last[tid] = cpu
        for tid, cpu in last.items():
            # a thread missing from the first sample was born during the run
            label = self.roles.get(tid) or names.get(tid) or self._alive0.get(tid) or (
                "native threads" if tid in first else "ended (unnamed)")
            out[label] = out.get(label, 0.0) + cpu - first.get(tid, 0.0)
        return out


def bs_run(name: str, dev, chain: dict, byz_dir: str, honest_dir: str, work: str, depth: int,
           registry, timeout_s: float, handshakes: Handshakes) -> dict:
    """One sync of a fresh node (fresh sqlite stores, a fresh KVStoreApp,
    the genesis state, BlocksyncReactor(block_sync=True) with
    ``prefetch_depth=depth``, a started VerifyQueue with the default
    factory) from two serving nodes over 127.0.0.1 TCP: three switches of
    ``p2p.test_util.make_switch`` (each its own node key), the syncer
    dialling the byzantine one first and the honest one when the
    byzantine peer is removed.  The launch counters at 0 and the
    tracer's ring cleared just before the dial; the per-step split, the
    syncer's dispatches and a BlockResponse's bytes are read from the
    ring's spans, the bytes each way from the peers' flow monitors, the
    handshakes from ``handshakes``, each thread's CPU seconds by role
    (ThreadCPU; a connection's three threads as "syncer ..." or
    "server ...").  -> dict."""
    import shutil

    from cometbft_tpu_torch.blocksync import reactor as R
    from cometbft_tpu_torch.crypto import batch as B
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.p2p.test_util import make_switch
    from cometbft_tpu_torch.utils.log import NopLogger
    from cometbft_tpu_torch.utils.trace import TRACER

    gen = chain["gen"]
    sync_dir = os.path.join(work, f"sync-{name}")
    node = bs_node(sync_dir, gen, dev)
    servers, switches, reactor = [], [], None
    q = VQ.VerifyQueue(verifier_factory=None if dev.type == "cuda" else
                       (lambda pk: B.create_batch_verifier(pk, device="cpu")))
    made = []
    real_factory = B.create_batch_verifier
    cpu = ThreadCPU()
    res: dict = {}

    def label_threads(side: str, add_peer):
        def labelled(peer) -> None:
            for th in (peer.mconn._send_thread, peer.mconn._recv_thread,
                       peer.mconn._ping_thread):
                cpu.roles[th.native_id] = f"{side} {th.name}"
            add_peer(peer)
        return labelled

    try:
        for sname, sdir in (("byzantine", byz_dir), ("honest", honest_dir)):
            bstore, sstore, dbs = open_stores(sdir)
            servers.append(dbs)
            r = R.BlocksyncReactor(sstore.load(), None, bstore, False, logger=NopLogger(),
                                   device=dev)
            r.add_peer = label_threads("server", r.add_peer)
            switches.append(make_switch(network=CHAIN_ID, moniker=sname,
                                        reactors={"BLOCKSYNC": r}))
        recorder = ConsensusRecorder()
        reactor = R.BlocksyncReactor(node["state"], node["exec"], node["block_store"], True,
                                     consensus_reactor=recorder, logger=NopLogger(),
                                     prefetch_depth=depth, device=dev)
        syncer = make_switch(network=CHAIN_ID, moniker="syncer",
                             reactors={"BLOCKSYNC": reactor})
        byz_sw, honest_sw = switches
        switches.append(syncer)
        byz_id, honest_id = (sw.node_info().node_id for sw in (byz_sw, honest_sw))
        stopped: dict = {sw.node_info().moniker: [] for sw in switches}
        for sw in switches:
            real_stop = sw.stop_peer_for_error

            def stop_peer_for_error(peer, reason, sw=sw, real_stop=real_stop) -> None:
                if sw.peers.has(peer.id):
                    stopped[sw.node_info().moniker].append((peer.id, reason))
                real_stop(peer, reason)

            sw.stop_peer_for_error = stop_peer_for_error
        recv_tids, wire = set(), {}
        add, remove = reactor.add_peer, reactor.remove_peer

        def add_peer(peer) -> None:
            recv_tids.add(peer.mconn._recv_thread.ident)
            add(peer)

        def remove_peer(peer, reason=None) -> None:
            wire[peer.id] = peer.status()
            remove(peer, reason)
            if peer.id == byz_id and syncer.is_running() and not syncer.peers.has(honest_id):
                syncer.dial_peers_async([honest_sw.transport.listen_addr])

        reactor.add_peer = label_threads("syncer", add_peer)
        reactor.remove_peer = remove_peer
        redone: list = []
        redo = reactor.pool.redo_request

        def redo_request(height: int) -> str:
            pid = redo(height)
            redone.append((height, pid))
            return pid

        reactor.pool.redo_request = redo_request

        def make(pub_key, device=None):
            verifier = real_factory(pub_key, device=device)
            made.append((verifier, threading.current_thread().name))
            return verifier

        B.create_batch_verifier = make
        hits0 = registry_value(registry, "cometbft_crypto_verify_queue_spec_cache", 'result="hit"')
        miss0 = registry_value(registry, "cometbft_crypto_verify_queue_spec_cache",
                               'result="miss"')
        busy0 = busy_seconds(registry)
        shakes0 = len(handshakes.seconds)
        q.start()
        VQ.install_queue(q)
        for sw in switches:
            sw.start()
        _build.reset_launches()
        TRACER.clear()
        cpu.start()
        t0 = time.perf_counter()
        if not syncer.dial_peer_with_address(byz_sw.transport.listen_addr):
            raise AssertionError(f"blocksync {name}: the syncer could not dial the byzantine "
                                 f"server")
        if not recorder.done.wait(timeout_s):
            raise AssertionError(f"blocksync {name}: no switch to consensus in {timeout_s} s "
                                 f"(applied up to {reactor.state.last_block_height}, pool "
                                 f"{reactor.pool.status()}, errors "
                                 f"{reactor.pool_routine_errors})")
        launches = launched()
        res["cpu"] = cpu.stop()
        busy = busy_seconds(registry) - busy0
        stops = {k: list(v) for k, v in stopped.items()}
        for peer in syncer.peers.copy():
            wire[peer.id] = peer.status()
        cost = D.LADDER.cost_snapshot()
        res["cost"] = {b: [(e["tier"], e["sigs_per_sec"], e["samples"], e["source"])
                           for e in cost["table"] if e["bucket"] == b]
                       for b in (512, 1024, 2048, 4096, 8192)}
        res["orders"] = [(o["bucket"], o["order"], o["reorders"]) for o in cost["orders"]]
        res.update(
            t0=t0, wall_switch=recorder.at - t0, launches=launches, busy=busy, redone=redone,
            stops=stops, byz_id=byz_id, honest_id=honest_id,
            syncer_id=syncer.node_info().node_id, pool_errors=reactor.pool_routine_errors,
            hits=registry_value(registry, "cometbft_crypto_verify_queue_spec_cache",
                                'result="hit"') - hits0,
            misses=registry_value(registry, "cometbft_crypto_verify_queue_spec_cache",
                                  'result="miss"') - miss0,
            state=recorder.states[-1], q_stats=q.stats(),
            verifiers=[(len(v), v.last_tier, where) for v, where in made],
            wire={("byzantine" if pid == byz_id else "honest"): (st["send"]["bytes"],
                                                                st["recv"]["bytes"])
                  for pid, st in wire.items()},
            handshakes=handshakes.seconds[shakes0:], pool_tid=reactor._pool_thread.ident)
    finally:
        B.create_batch_verifier = real_factory
        cpu.close()
        for sw in switches:
            if sw.is_running():
                sw.stop()
            else:
                sw.transport.on_stop()   # never started: close its listener
        if reactor is not None and reactor._pool_thread is not None:
            reactor._pool_thread.join(30)
        if q.is_running():
            q.stop()
        close_node(node)
        for dbs in servers:
            for db in dbs:
                db.close()
    export = TRACER.export()
    if export["otherData"]["dropped_spans"]:
        raise AssertionError(f"blocksync {name}: the tracer's ring of {TRACER.capacity} spans "
                             f"dropped {export['otherData']['dropped_spans']}")
    events = [e for e in export["traceEvents"] if e["ph"] == "X"]
    res.update(bs_steps(events, res["pool_tid"], TRACER.epoch - res["t0"]))
    res["steps"]["switch_dispatch (syncer)"] = [
        e["dur"] / 1e6 for e in events if e["name"] == "switch_dispatch" and e["tid"] in recv_tids]
    res["block_bytes"] = [e["args"]["bytes"] for e in events if e["name"] == "blocksync/decode"
                          and e["args"].get("kind") == "block"]
    dropped = [e["args"]["dropped"] for e in events
               if e["name"] == "channel_enqueue" and "dropped" in e["args"]]
    res["send_timeouts"] = dropped.count("timeout")
    res["try_send_failures"] = dropped.count("full")
    # the synced node's stores, opened again, and its app, against the source's
    block_store, state_store, dbs = open_stores(sync_dir)
    try:
        res["block_image"], res["state_image"] = db_image(dbs[0]), db_image(dbs[1])
    finally:
        for db in dbs:
            db.close()
    res["app_record"] = node["app_db"].get(b"kvstore:state")
    res["app_hash"] = node["app"].app_hash
    res["mib"] = db_mib(sync_dir)
    shutil.rmtree(sync_dir)
    return res


#: the per-step split of a sync, by label: (span name, parent or None
#: for any, the span's args that must match)
BS_STEPS = (
    ("decode_bs_message", "blocksync/decode", None, {"kind": "block"}),
    ("part set", "blocksync/part_set", None, {}),
    ("verify_commit_light", "verify_commit", "blocksync/sync_step", {}),
    ("save_block", "store/save_block", None, {}),
    ("apply_block", "exec/apply_block", None, {}),
    ("validate_block's verify_commit", "verify_commit", "exec/apply_block", {}),
    ("FinalizeBlock", "abci/finalize_block", None, {}),
    ("Commit", "abci/commit", None, {}),
    ("state save", "state/save", None, {}),
    ("prefetch (sign bytes, submit)", "blocksync/prefetch", None, {}),
)


def bs_steps(events: list, pool_tid: int, offset_s: float) -> dict:
    """A sync's split from the tracer's spans: each BS_STEPS label's
    durations (seconds), the pool wait (the gaps between the pool
    thread's consecutive ``blocksync/sync_step`` spans), and the sync's
    wall to the end of its last ``exec/apply_block`` (``offset_s``: the
    tracer's epoch less the sync's start) with its height."""
    steps: dict[str, list[float]] = {}
    for label, span, parent, args in BS_STEPS:
        steps[label] = [e["dur"] / 1e6 for e in events if e["name"] == span
                        and (parent is None or e["args"].get("parent") == parent)
                        and all(e["args"].get(k) == v for k, v in args.items())]
    sync = sorted((e for e in events if e["name"] == "blocksync/sync_step"
                   and e["tid"] == pool_tid), key=lambda e: e["ts"])
    steps["pool wait"] = [(b["ts"] - a["ts"] - a["dur"]) / 1e6 for a, b in zip(sync, sync[1:])]
    applied = [e for e in events if e["name"] == "exec/apply_block"]
    last = max(applied, key=lambda e: e["ts"])
    return {"steps": steps, "top": max(e["args"]["height"] for e in applied),
            "wall_applied": offset_s + (last["ts"] + last["dur"]) / 1e6}


def prefetch_triples(src_dir: str, depth: int):
    """(public key, sign bytes, signature) of every precommit of heights
    1..depth in the source's stores, signature #0 of height 1 flipped ->
    (triples, the verdicts the oracle gives)."""
    block_store, state_store, dbs = open_stores(src_dir)
    triples = []
    try:
        for h in range(1, depth + 1):
            commit, vals = block_store.load_block_commit(h), state_store.load_validators(h)
            for i, cs in enumerate(commit.signatures):
                triples.append((vals.get_by_index(i).pub_key.bytes(),
                                commit.vote_sign_bytes(CHAIN_ID, i), cs.signature))
    finally:
        for db in dbs:
            db.close()
    pub, msg, sig = triples[0]
    triples[0] = (pub, msg, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
    expected = oracle_verdicts(triples[:1]) + [True] * (len(triples) - 1)
    return triples, expected


def busy_seconds(registry) -> float:
    """The health plane's device busy seconds, summed over devices."""
    total = 0.0
    for line in registry.expose().splitlines():
        if line.startswith("cometbft_crypto_device_busy_seconds_total"):
            total += float(line.rsplit(" ", 1)[1])
    return total


def image_diff(got: dict, want: dict) -> str:
    """'' when the two images are equal, else the first few differences."""
    missing = sorted(set(want) - set(got))[:3]
    extra = sorted(set(got) - set(want))[:3]
    differ = sorted(k for k in set(got) & set(want) if got[k] != want[k])[:3]
    if not (missing or extra or differ):
        return ""
    return f"missing {missing}, extra {extra}, different {differ}"


#: the node paths' launch counts are printed in this order
KERNEL_ORDER = ("build_tables", "sha512_keyed", "verify_keyed", "verify_generic")
#: statesync1024: the source app's one snapshot, this many heights below the
#: top applied height (its headers H + 1 and H + 2 are stored)
SS_BELOW = 6
SS_PERIOD_NS = 100 * 365 * 24 * 3600 * 10**9


def ss_run(name: str, dev, chain: dict, src_dir: str, work: str, timeout_s: float) -> dict:
    """(s) statesync1024: a fresh node -- empty sqlite stores, a fresh
    KVStoreApp (no InitChain), a StatesyncReactor and a BlocksyncReactor
    waiting -- restores blocksync1024's chain from a source node over
    127.0.0.1 TCP: the chain's own app (its one snapshot) behind a
    StatesyncReactor and a BlocksyncReactor over a copy of the source's
    stores in ``src_dir``.  Its light client (a primary and a witness,
    NodeProviders over those stores, trust root block 1) verifies the
    1024-validator headers at H, H + 1 and H + 2 on the keyed tier of a
    fresh KeyTableCache; the chunks are fetched and applied, the app's
    hash checked, the stores bootstrapped (the reference node's
    ``_on_statesync_complete``), and blocksync (``start_sync``) applies
    the rest to the top.  The launch counters at 0 before the light
    client starts (it verifies its root's commit: the cold build) and
    read when the restore hands over and at the end.  Fails unless the
    node ends with the source's state (but the height it last saw the
    params change, which a restore cannot know), app record and hash,
    the source's blocks, FinalizeBlock responses and validator sets at
    every height it holds, every backfilled block counted, and keyed
    launches in the restore.  -> dict."""
    from dataclasses import replace

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.blocksync import reactor as BR
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.mempool import NopMempool
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.p2p.test_util import make_switch
    from cometbft_tpu_torch.proxy import local_client_creator, new_app_conns
    from cometbft_tpu_torch.state import State, decode_state, encode_state
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.statesync import LightClientStateProvider, StatesyncReactor
    from cometbft_tpu_torch.utils.db import MemDB
    from cometbft_tpu_torch.utils.log import NopLogger
    from cometbft_tpu_torch.utils.metrics import Registry

    gen = chain["gen"]
    registry = Registry()
    ss_metrics = M.StateSyncMetrics(registry)
    src_blocks, src_states, src_dbs = open_stores(src_dir)
    dbs = list(src_dbs)
    conns: list = []
    switches: list = []
    res: dict = {"name": name}
    key = str(dev)
    PR._caches[key] = PR.KeyTableCache(dev)
    try:
        src_conns = new_app_conns(local_client_creator(chain["app"]))
        src_conns.start()
        conns.append(src_conns)
        snaps = chain["app"].list_snapshots().snapshots
        src = make_switch(network=CHAIN_ID, moniker="ss-source", reactors={
            "STATESYNC": StatesyncReactor(src_conns.snapshot, logger=NopLogger()),
            "BLOCKSYNC": BR.BlocksyncReactor(src_states.load(), None, src_blocks, False,
                                             logger=NopLogger(), device=dev)})
        switches.append(src)
        blocks, states, sdbs = open_stores(os.path.join(work, "statesync"))
        dbs.extend(sdbs)
        app_db = MemDB()
        app = KVStoreApp(app_db)
        node_conns = new_app_conns(local_client_creator(app))
        node_conns.start()
        conns.append(node_conns)
        ex = BlockExecutor(states, node_conns.consensus, NopMempool(), block_store=blocks,
                           logger=NopLogger(), device=dev)
        recorder = ConsensusRecorder()
        bs = BR.BlocksyncReactor(State.from_genesis(gen), ex, blocks, False,
                                 consensus_reactor=recorder, logger=NopLogger(),
                                 statesync_metrics=ss_metrics, device=dev)
        providers = [NodeProvider(gen.chain_id, src_blocks, src_states) for _ in range(2)]
        trust = TrustOptions(period_ns=SS_PERIOD_NS, height=1,
                             hash=src_blocks.load_block_meta(1).block_id.hash)
        # the counters cover the light client's start too: it verifies
        # its root's own commit, the first keyed verify of the cold set
        _build.reset_launches()
        t_init = time.perf_counter()
        lc = Client(gen.chain_id, trust, providers[0], providers[1:], LightStore(MemDB()),
                    logger=NopLogger(), device=dev)
        init_s = time.perf_counter() - t_init
        checks: list = []
        verify = lc.verify_light_block_at_height

        def timed_verify(height, now=None):
            t0 = time.perf_counter()
            try:
                return verify(height, now)
            finally:
                checks.append((height, time.perf_counter() - t0))

        lc.verify_light_block_at_height = timed_verify
        provider = LightClientStateProvider(lc, consensus_params_fn=providers[0].consensus_params,
                                            logger=NopLogger())
        done: dict = {}

        def on_complete(state, commit) -> None:
            done["restore_at"] = time.perf_counter()
            done["restore_launches"] = launched()
            states.bootstrap(state)
            blocks.save_seen_commit(state.last_block_height, commit)
            done["state"] = state
            bs.start_sync(state)

        ss = StatesyncReactor(node_conns.snapshot, enabled=True, state_provider=provider,
                              on_complete=on_complete, discovery_time=1.0,
                              logger=NopLogger(), metrics=ss_metrics)
        syncer = make_switch(network=CHAIN_ID, moniker="ss-syncer",
                             reactors={"STATESYNC": ss, "BLOCKSYNC": bs})
        switches.append(syncer)
        src.start()
        t0 = time.perf_counter()
        syncer.start()
        syncer.dial_peer_with_address(src.transport.listen_addr)
        if not ss.sync_done.wait(timeout_s) or ss.sync_error is not None:
            raise AssertionError(f"{name}: the restore did not end ({ss.sync_error!r})")
        if not recorder.done.wait(timeout_s):
            raise AssertionError(f"{name}: blocksync stopped at {blocks.height()}")
        res.update(init_s=init_s, restore_s=done["restore_at"] - t0, wall_s=recorder.at - t0,
                   launches=launched(), restore_launches=done["restore_launches"],
                   checks=checks, snapshot=done["state"].last_block_height,
                   chunks=snaps[-1].chunks, snapshots=[sn.height for sn in snaps],
                   backfilled=plain_value(registry, "cometbft_statesync_backfilled_blocks"))
    finally:
        for sw in switches:
            if sw.is_running():
                sw.stop()
        for c in conns:
            if c.is_running():
                c.stop()
        PR._caches.pop(key, None)
    try:
        top, h0 = chain["height"], res["snapshot"]
        got, want = recorder.states[0], decode_state(chain["state"])
        if encode_state(replace(got, last_height_params_changed=0)) != encode_state(
                replace(want, last_height_params_changed=0)) or blocks.height() != top:
            raise AssertionError(f"{name}: handed over the state at {got.last_block_height} "
                                 f"(stores to {blocks.height()}), not the source's at {top}")
        if app_db.get(b"kvstore:state") != chain["app_record"] or \
                app.app_hash != chain["app_hash"]:
            raise AssertionError(f"{name}: the app's state or hash differs from the source's")
        if blocks.base() != h0 + 1 or res["backfilled"] != top - h0:
            raise AssertionError(f"{name}: blocks {blocks.base()}..{blocks.height()}, "
                                 f"{res['backfilled']} backfilled, after a restore at {h0}")
        for h in range(h0 + 1, top + 1):
            if blocks.load_block(h).encode() != src_blocks.load_block(h).encode() or \
                    states.load_finalize_block_response(h).encode() != \
                    src_states.load_finalize_block_response(h).encode():
                raise AssertionError(f"{name}: height {h} differs from the source's")
        for h in range(h0 + 1, top + 3):
            if states.load_validators(h).hash() != src_states.load_validators(h).hash():
                raise AssertionError(f"{name}: the validator set at {h} differs")
        if top - h0 > 16 or [c for c in res["checks"] if c[0] not in (h0, h0 + 1, h0 + 2)]:
            raise AssertionError(f"{name}: restored at {h0} of {top}, light checks "
                                 f"{res['checks']}")
    finally:
        for db in dbs:
            db.close()
    need_launches(f"{name}, the restore", res["restore_launches"],
                  {"build_tables": 1, "sha512_keyed": 1, "verify_keyed": 1})
    need_launches(name, res["launches"], {"build_tables": 1, "sha512_keyed": 1,
                                          "verify_keyed": 1})
    return res


#: pex-wan1024 (d): the first heights of blocksync1024's chain it syncs (past
#: the rotations at 64 and 128; at most half the chain), the one cross-region
#: link every connection of its syncer and sources sends through (50 ms +/-
#: 10 ms one way, 0.5 % of frames charged a retransmit: assumed figures, not
#: measured ones; CometBFT-QA-v1.md:307-309 emulates the latency between its
#: zones with tc, and the reference's tests/test_e2e_wan.py uses 80 ms one way
#: with no jitter and no loss), and the PEX ensure interval (the deployment's
#: 30 s, cut: with 30 s the whole smoke took 1192.6 s of its 1200 on an
#: NVIDIA H100 80GB HBM3 at 700 W; the rate is also read from the first
#: source's join, which the interval does not move)
BS_PEX_HEIGHTS = 128
PEX_NETEM = "delay=50~10;loss=0.005;seed=7"
PEX_ENSURE_S = 2.0


class Raised:
    """Counts each PotentialDeadlock and LockOrderError made while armed,
    wherever it is raised (a receive thread's error handler or the pool
    routine's would swallow it)."""

    def __init__(self, classes) -> None:
        self.names: list = []
        self._saved = []
        for cls in classes:
            init = cls.__init__

            def counted(obj, *args, _init=init, _name=cls.__name__):
                self.names.append(_name)
                _init(obj, *args)

            self._saved.append((cls, init))
            cls.__init__ = counted

    def close(self) -> None:
        for cls, init in self._saved:
            cls.__init__ = init


def pex_wan_run(name: str, dev, chain: dict, work: str, registry, timeout_s: float,
                cut: int) -> dict:
    """(d) pex-wan1024: a fresh node joins blocksync1024's chain through a
    seed over an emulated WAN link.  Two source nodes serve the chain's
    first ``cut`` heights (copies of the source's stores pruned to height
    ``cut`` + 1), each a switch with a BlocksyncReactor server and a
    PexReactor; a seed (PexReactor, seed mode) whose book holds the two
    sources' addresses; the syncing node (fresh sqlite stores and app,
    BlocksyncReactor with the default prefetch depth through a started
    VerifyQueue, a fresh KeyTableCache, PexReactor) is given only the
    seed's address.  Every connection of the syncer and the sources sends
    through the netem plan ``PEX_NETEM``; every PexReactor ensures its
    peers every ``PEX_ENSURE_S`` seconds.  Armed for the run, before its nodes are
    built: ``sync.configure(deadlock=True, lockgraph=True)`` and
    ``trustguard.enable()`` (trips counted on the run's own registry);
    both are off again at the end.  The launch counters at 0 and the
    tracer's ring cleared just before the switches start.  Fails unless
    the seed's reply puts both sources in the syncer's book, the syncer
    dials both, reaches height ``cut`` with the source's stores, app and
    state as they stood at ``cut``, every batch at or above the device
    threshold verifies on the keyed tier, every sync link injected delay,
    the guard tripped 0 times (and then exactly once on a planted sink),
    no PotentialDeadlock or LockOrderError was made, and no dispatch
    tier was demoted.  -> dict."""
    import random

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.blocksync import reactor as R
    from cometbft_tpu_torch.crypto import batch as B
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.p2p.conn.netem import NetemPlan
    from cometbft_tpu_torch.p2p.netaddr import NetAddress
    from cometbft_tpu_torch.p2p.pex import AddrBook, PexReactor
    from cometbft_tpu_torch.p2p.test_util import make_switch
    from cometbft_tpu_torch.state import State, Store
    from cometbft_tpu_torch.utils import fleetobs, trustguard
    from cometbft_tpu_torch.utils import sync as cmtsync
    from cometbft_tpu_torch.utils.db import MemDB
    from cometbft_tpu_torch.utils.log import NopLogger
    from cometbft_tpu_torch.utils.metrics import Registry
    from cometbft_tpu_torch.utils.trace import TRACER

    gen, snap = chain["gen"], chain["cut"]
    netem = NetemPlan.parse(PEX_NETEM)
    rng = random.Random(SEED + 17)
    reg = Registry()          # the run's own planes: trips, netem, fleet
    cons_m, netem_m, fleet_m = M.ConsensusMetrics(reg), M.NetemMetrics(reg), M.FleetMetrics(reg)
    saved = (M.netem_metrics(), M.fleet_metrics())
    src_dirs = [os.path.join(work, f"pex-source{k}") for k in (1, 2)]
    copy_stores(chain["src_dir"], src_dirs[0])
    block_store, _, dbs = open_stores(src_dirs[0])
    try:
        while block_store.height() > cut + 1:
            block_store.prune_last_block()
    finally:
        for db in dbs:
            db.close()
    copy_stores(src_dirs[0], src_dirs[1])
    sync_dir = os.path.join(work, f"sync-{name}")
    q = VQ.VerifyQueue(verifier_factory=None if dev.type == "cuda" else
                       (lambda pk: B.create_batch_verifier(pk, device="cpu")))
    real_factory = B.create_batch_verifier
    made: list = []
    switches: list = []
    servers: list = []
    node = None
    res: dict = {"name": name, "plan": netem.describe(), "ensure_s": PEX_ENSURE_S}
    cmtsync._reset_lock_graph()
    cmtsync.configure(deadlock=True, lockgraph=True)
    trustguard.reset(enable=True)
    trustguard.install_metrics(cons_m)
    raised = Raised((cmtsync.PotentialDeadlock, cmtsync.LockOrderError))
    M.install_netem_metrics(netem_m)
    M.install_fleet_metrics(fleet_m)
    PR._caches[str(dev)] = PR.KeyTableCache(dev)
    try:
        node = bs_node(sync_dir, gen, dev)

        def pex(tag: str, **kw) -> PexReactor:
            book = AddrBook(os.path.join(work, f"{tag}-book.json"), strict=False,
                            rng=random.Random(rng.random()), key=f"{SEED:048x}"[:48])
            return PexReactor(book, ensure_interval=PEX_ENSURE_S,
                              rng=random.Random(rng.random()),
                              logger=NopLogger(), **kw)

        sources = []
        for k, sdir in enumerate(src_dirs, 1):
            bstore, sstore, dbs = open_stores(sdir)
            servers.append(dbs)
            r = R.BlocksyncReactor(sstore.load(), None, bstore, False, logger=NopLogger(),
                                   device=dev)
            sources.append(make_switch(network=CHAIN_ID, moniker=f"source{k}", netem=netem,
                                       reactors={"BLOCKSYNC": r, "PEX": pex(f"source{k}")}))
        switches += sources
        seed_pex = pex("seed", seed_mode=True)
        seed = make_switch(network=CHAIN_ID, moniker="seed", reactors={"PEX": seed_pex})
        switches.append(seed)
        src_addrs = [sw.transport.listen_addr for sw in sources]
        for a in src_addrs:
            seed_pex.book.add_address(a, a)
        sa = seed.transport.listen_addr
        recorder = ConsensusRecorder()
        reactor = R.BlocksyncReactor(node["state"], node["exec"], node["block_store"], True,
                                     consensus_reactor=recorder, logger=NopLogger(),
                                     prefetch_depth=VQ.DEFAULT_PREFETCH_DEPTH, device=dev)
        sync_pex = pex("syncer", seeds=[NetAddress(id=sa.id, host=sa.host, port=sa.port)])
        syncer = make_switch(network=CHAIN_ID, moniker="syncer", netem=netem,
                             reactors={"BLOCKSYNC": reactor, "PEX": sync_pex})
        switches.append(syncer)
        names = {sw.node_info().node_id: sw.node_info().moniker for sw in switches}
        stages: list = []         # every connection's stage, reconnects included
        stops: list = []
        for sw in switches:       # as a node's assembly does
            sw.reactors["PEX"].book.add_our_address(sw.transport.listen_addr)
            stage_for = sw._netem_stage

            def track(peer_id, sw=sw, stage_for=stage_for):
                st = stage_for(peer_id)
                if st is not None:
                    stages.append((sw.node_info().moniker, names.get(peer_id, peer_id[:8]),
                                   st))
                return st

            sw._netem_stage = track
        real_stop = syncer.stop_peer_for_error

        def stop_peer_for_error(peer, reason) -> None:
            if syncer.peers.has(peer.id):
                stops.append((names.get(peer.id, peer.id[:8]), str(reason)))
            real_stop(peer, reason)

        syncer.stop_peer_for_error = stop_peer_for_error
        seed_id = seed.node_info().node_id
        src_ids = [sw.node_info().node_id for sw in sources]
        learned: list = []
        handle = sync_pex._handle_addrs

        def handle_addrs(peer, addrs) -> None:
            handle(peer, addrs)
            if peer.id == seed_id:
                learned.append((time.perf_counter(), [a.id for a in addrs],
                                [sync_pex.book.has_address(a) for a in src_addrs]))

        sync_pex._handle_addrs = handle_addrs
        joined: dict = {}
        add = reactor.add_peer

        def add_peer(peer) -> None:
            joined.setdefault(peer.id, time.perf_counter())
            add(peer)

        reactor.add_peer = add_peer

        def make(pub_key, device=None):
            verifier = real_factory(pub_key, device=device)
            made.append((verifier, threading.current_thread().name))
            return verifier

        B.create_batch_verifier = make
        q.start()
        VQ.install_queue(q)
        for sw in sources + [seed]:
            sw.start()
        _build.reset_launches()
        TRACER.clear()
        t0 = time.perf_counter()
        syncer.start()
        if not recorder.done.wait(timeout_s):
            raise AssertionError(f"{name}: no switch to consensus in {timeout_s} s (applied "
                                 f"up to {reactor.state.last_block_height}, peers "
                                 f"{[p.id[:8] for p in syncer.peers.copy()]}, book "
                                 f"{sync_pex.book.size()}, learned {learned})")
        res["launches"] = launched()
        # each link's totals over its connections (frames, dropped,
        # injected s, connections)
        links: dict = {}
        for who, other, st in stages:
            f, d, inj, n = links.get(f"{who}->{other}", (0, 0, 0.0, 0))
            links[f"{who}->{other}"] = (f + st.frames, d + st.dropped, inj + st.injected_s, n + 1)
        # read before the switches stop and retire the stages' series
        scrape = fleetobs.self_scrape("pex-wan", reg)
        res["rollup"] = fleetobs.fleet_rollup([scrape])
        res["netem_series"] = {
            f"{s}{{{','.join(f'{k}={v[:8]}' for k, v in lbl.items())}}}": v
            for s in ("netem_injected_delay_seconds_sum", "netem_injected_delay_seconds_count",
                      "netem_dropped_frames_total")
            for lbl, v in fleetobs.series(scrape, s)}
        res.update(t0=t0, wall_switch=recorder.at - t0, links=links, learned=learned,
                   stops=list(stops),
                   joined={("seed" if pid == seed_id else f"source{src_ids.index(pid) + 1}"
                            if pid in src_ids else pid[:8]): at - t0
                           for pid, at in joined.items()},
                   state=recorder.states[-1], pool_tid=reactor._pool_thread.ident,
                   pool_errors=reactor.pool_routine_errors,
                   verifiers=[(len(v), v.last_tier, where) for v, where in made],
                   trips=registry_line(reg, "cometbft_consensus_trust_guard_trips_total"),
                   edges=len(cmtsync.lock_order_edges()),
                   keys_built=PR._caches[str(dev)].stats["keys_built"],
                   demoted=[t for t, st in D.LADDER.snapshot()["tiers"].items()
                            if st["demoted"] or st.get("demotions")])
        # the planted trip: a sink reached inside a wire context, no validator
        probe = Store(MemDB())
        try:
            with trustguard.wire_context("pex_reactor"):
                probe.save(State.from_genesis(gen))
            planted = None
        except trustguard.TrustGuardError as exc:
            planted = str(exc)
        res["planted"] = (planted, registry_line(
            reg, "cometbft_consensus_trust_guard_trips_total"), probe.load() is None)
    finally:
        B.create_batch_verifier = real_factory
        for sw in switches:
            if sw.is_running():
                sw.stop()
            else:
                sw.transport.on_stop()
        if q.is_running():
            q.stop()
        VQ.install_queue(None)
        if node is not None:
            close_node(node)
        for dbs in servers:
            for db in dbs:
                db.close()
        cmtsync.configure()
        raised.close()
        trustguard.install_metrics(None)
        trustguard.reset(enable=False)
        M.install_netem_metrics(saved[0])
        M.install_fleet_metrics(saved[1])
    res["raised"] = list(raised.names)
    events = [e for e in TRACER.export()["traceEvents"] if e["ph"] == "X"]
    res.update(bs_steps(events, res["pool_tid"], TRACER.epoch - res["t0"]))
    block_store, state_store, dbs = open_stores(sync_dir)
    try:
        res["block_image"], res["state_image"] = db_image(dbs[0]), db_image(dbs[1])
    finally:
        for db in dbs:
            db.close()
    res["app_record"] = node["app_db"].get(b"kvstore:state")
    res["app_hash"] = node["app"].app_hash
    shutil.rmtree(sync_dir)
    for d in src_dirs:
        shutil.rmtree(d)
    return res


def registry_line(registry, name: str) -> list:
    """Every sample line of ``name`` in the exposition."""
    return [line for line in registry.expose().splitlines() if line.startswith(name + "{")]


def blocksync_phase(dev, smi: str, registry, heights: int = BS_HEIGHTS,
                    nval: int = BS_VALIDATORS, every: int = BS_ROTATE_EVERY,
                    bad: int = BS_BAD_HEIGHT, nsigners: int = BS_SIGNERS,
                    timeout_s: float = 600.0) -> dict:
    """Phase 16, blocksync1024: a ``heights`` + 1 block chain of ``nval``
    validators built by a source node (bs_chain) into sqlite stores; a
    byzantine copy whose block ``bad`` carries a flipped LastCommit
    signature, and an honest copy; then two syncs of a fresh node from
    them over 127.0.0.1 TCP (bs_run): (a) on a fresh KeyTableCache,
    prefetch depth 8, (c) warm tables, depth 0.  Each must store the
    source's blocks and states key for key, reach its app record and hash
    and hand over its state, stop the byzantine peer (by node ID) once
    for "sent invalid block" and no honest one (a server stops the syncer
    only for the connection the syncer closed), count no pool-routine
    error and no send timeout, verify every batch at or above the device
    threshold on the keyed tier (the host tier only below it) and launch
    verify_keyed; (a) builds the tables of the set's keys and of one
    newcomer per rotation inside the synced heights, (c) none.  Then (s),
    statesync1024 (``ss_run``): a fresh node restores the chain from the
    source app's one snapshot, ``SS_BELOW`` heights below the top, and
    blocksyncs the rest.  Then (d), pex-wan1024 (``pex_wan_run``): a fresh
    node given only a seed's address learns two sources by PEX and syncs
    the chain's first ``BS_PEX_HEIGHTS`` heights (at most half the chain)
    from them over an emulated
    cross-region link, with the lock modes and the trust guard armed."""
    import shutil
    import tempfile

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.p2p.conn import connection as MC
    from cometbft_tpu_torch.p2p.conn import secret_connection as SC
    from cometbft_tpu_torch.state import encode_state
    from cometbft_tpu_torch.utils.trace import TRACER

    t_phase = time.perf_counter()
    threads = live_threads()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="blocksync_", dir=root)
    key = str(dev)
    saved_cache = PR._caches.get(key)
    ring = TRACER.capacity
    saved_p2p = M.p2p_metrics()
    p2p = M.P2PMetrics(registry)
    p2p.handshake_duration_seconds = handshakes = Handshakes(p2p.handshake_duration_seconds)
    threshold = EV.runtime_device_min_batch(dev)
    backend = "evp" if SC._NATIVE_PUMP.cmt_frame_backend() == 1 else "portable"
    wire_errors = (SC.SecretConnectionError, MC.MConnError, OSError)
    res: dict = {"frame_backend": backend}
    try:
        M.install_p2p_metrics(p2p)
        TRACER.set_capacity(128 * heights + 8192)
        rs = np.random.RandomState(SEED + 16)
        pex_cut = min(BS_PEX_HEIGHTS, heights // 2)
        chain = bs_chain(work, dev, heights, nval, every, BS_TXS, rs, nsigners,
                         snapshot_interval=heights - SS_BELOW, cut=pex_cut)
        # a val: tx at height h changes the set that signs height h + 2
        newcomers = sum(1 for h in chain["rotations"] if h + 2 <= heights)
        print(f"blocksync{nval} [{smi}]: BASELINE config 4 (internal/blocksync fast-sync "
              f"replay, 1k blocks x 1k-validator commits) at {nval} validators, "
              f"{heights} heights, between nodes over 127.0.0.1 TCP (secret connections, "
              f"frame backend {backend})")
        print(f"  data: {chain['data_s']:.2f} s ({chain['keys_s']:.2f} s of it the keys; "
              f"signing {chain['sign_s']:.2f} s in {nsigners} workers, apply_block "
              f"{chain['apply_s']:.2f} s, save_block {chain['save_s']:.2f} s): "
              f"{heights + 1} blocks, {chain['txs']} txs, {(heights + 1) * nval} precommits, "
              f"{len(chain['rotations'])} rotations ({newcomers} newcomers sign inside the "
              f"synced heights); sqlite {chain['mib']:.2f} MiB; device threshold {threshold}")
        res.update(data_s=chain["data_s"], sign_s=chain["sign_s"], src_mib=chain["mib"],
                   rotations=len(chain["rotations"]))
        byz_dir, honest_dir = os.path.join(work, "byzantine"), os.path.join(work, "honest")
        bs_byzantine(chain["src_dir"], byz_dir, bad)
        copy_stores(chain["src_dir"], honest_dir)
        want_state = chain["state"]
        # the kernels at the shapes of a cold verify-ahead step: the
        # commits of heights 1..8 (1024 keys, 4-bit combs) in one
        # 8192-lane slice, signature #0 flipped as the byzantine block's
        PR._caches[key] = PR.KeyTableCache(dev)
        triples, expected = prefetch_triples(chain["src_dir"], VQ.DEFAULT_PREFETCH_DEPTH)
        _, _, plan, verdicts, _ = run_verify(triples, dev)
        if verdicts != expected:
            raise AssertionError("blocksync: the prefetch batch's verdicts are not the oracle's")
        res["prefetch_check"] = check_fused(f"blocksync-prefetch ({len(triples)} lanes)", plan,
                                            expected, dev)
        for name, depth, cold in (("a", VQ.DEFAULT_PREFETCH_DEPTH, True), ("c", 0, False)):
            if cold:
                PR._caches[key] = PR.KeyTableCache(dev)
            built0 = PR._caches[key].stats["keys_built"]
            r = bs_run(name, dev, chain, byz_dir, honest_dir, work, depth, registry, timeout_s,
                       handshakes)
            r["keys_built"] = PR._caches[key].stats["keys_built"] - built0
            for what, got, want in (("block store", r["block_image"], chain["block_image"]),
                                    ("state store", r["state_image"], chain["state_image"])):
                diff = image_diff(got, want)
                if diff:
                    raise AssertionError(f"blocksync ({name}): the synced {what} differs from "
                                         f"the source's: {diff}")
            if r["app_record"] != chain["app_record"] or r["app_hash"] != chain["app_hash"]:
                raise AssertionError(f"blocksync ({name}): the app's state or hash differs")
            if encode_state(r["state"]) != want_state or r["top"] != heights:
                raise AssertionError(f"blocksync ({name}): handed over the state at "
                                     f"{r['state'].last_block_height}, applied to {r['top']}")
            stops = r["stops"]
            server_stops = [(pid, type(why).__name__) for pid, why in stops["byzantine"]
                            if pid != r["syncer_id"] or not isinstance(why, wire_errors)]
            if [(p, str(why)) for p, why in stops["syncer"]] != \
                    [(r["byz_id"], "sent invalid block")] or server_stops or stops["honest"]:
                raise AssertionError(f"blocksync ({name}): stops {stops} (the byzantine server "
                                     f"is {r['byz_id']}, the syncer {r['syncer_id']})")
            if r["pool_errors"] or r["send_timeouts"]:
                raise AssertionError(f"blocksync ({name}): {r['pool_errors']} pool-routine "
                                     f"errors, {r['send_timeouts']} send timeouts")
            # every batch at or above the threshold on the keyed tier;
            # the host tier only below it
            off = [(n, t) for n, t, _ in r["verifiers"]
                   if n and t != "keyed" and not (t == "host" and n < threshold)]
            if off:
                raise AssertionError(f"blocksync ({name}): verifies (signatures, tier) {off} "
                                     f"off the keyed tier (device threshold {threshold})")
            want_built = nval + newcomers if cold else 0
            if r["keys_built"] != want_built:
                raise AssertionError(f"blocksync ({name}): {r['keys_built']} keys built, not "
                                     f"{want_built}")
            want = {"sha512_keyed": 1, "verify_keyed": 1}
            if cold:
                want["build_tables"] = 1 + newcomers
            need_launches(f"blocksync ({name})", r["launches"], want)
            bs_print(name, depth, cold, r, heights, nval)
            res[name] = {k: r[k] for k in ("wall_applied", "wall_switch", "launches", "busy",
                                           "hits", "misses", "redone", "mib", "keys_built",
                                           "wire", "handshakes", "send_timeouts", "cpu")}
            res[name]["steps"] = {k: (1e3 * pct(v, 50), 1e3 * max(v))
                                  for k, v in r["steps"].items() if v}
            res[name]["block_bytes"] = (pct(r["block_bytes"], 50), max(r["block_bytes"]))
        ss_dir = os.path.join(work, "ss-source")
        copy_stores(chain["src_dir"], ss_dir)
        ss = ss_run(f"statesync{nval}", dev, chain, ss_dir, work, timeout_s)
        light_ms = [1e3 * d for _, d in ss["checks"]]
        print(f"statesync{nval} [{smi}]: BASELINE config 4's chain restored from a snapshot "
              f"(the source app's snapshots {ss['snapshots']}) at height {ss['snapshot']} of "
              f"{heights}, {ss['chunks']} chunks, over 127.0.0.1 TCP: the light client's "
              f"start {ss['init_s']:.3f} s (its root's commit, the cold build), the restore "
              f"{ss['restore_s']:.3f} s (discovery, light checks, chunks, the app's hash), "
              f"then {ss['backfilled']:.0f} blocks by blocksync, {ss['wall_s']:.3f} s in all; "
              f"light checks of heights {[h for h, _ in ss['checks']]} p50 "
              f"{pct(light_ms, 50):.3f} ms (max {max(light_ms):.3f}); launches "
              f"(build_tables / sha512_keyed / verify_keyed / verify_generic) in the restore "
              + " / ".join(str(ss["restore_launches"].get(k, 0)) for k in KERNEL_ORDER)
              + ", in all " + " / ".join(str(ss["launches"].get(k, 0)) for k in KERNEL_ORDER)
              + "; state, app and stores equal the source's")
        res["s"] = {k: ss[k] for k in ("init_s", "restore_s", "wall_s", "launches",
                                       "restore_launches",
                                       "checks", "snapshot", "chunks", "backfilled")}
        res["d"] = pex_wan_phase(dev, smi, chain, work, registry, timeout_s, nval,
                                 pex_cut, threshold, res["c"], heights)
    finally:
        M.install_p2p_metrics(saved_p2p)
        TRACER.set_capacity(ring)
        shutil.rmtree(work)
        if saved_cache is None:
            PR._caches.pop(key, None)
        else:
            PR._caches[key] = saved_cache
    res["launches"] = end_phase("blocksync", threads)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"  blocksync phase: {res['wall_s']:.2f} s")
    return res


def pex_wan_phase(dev, smi: str, chain: dict, work: str, registry, timeout_s: float,
                  nval: int, cut: int, threshold: int, warm: dict, warm_heights: int) -> dict:
    """Runs (d) (``pex_wan_run``), checks it and prints its lines beside
    run (c)'s (``warm``, ``warm_heights`` blocks).  -> the numbers kept."""
    from cometbft_tpu_torch.state import encode_state

    name = f"pex-wan{nval}"
    threads = live_threads()
    d = pex_wan_run(name, dev, chain, work, registry, timeout_s, cut=cut)
    end_phase(name, threads)
    want_state = chain["cut"]
    for what, got, want in (("block store", d["block_image"], want_state["block_image"]),
                            ("state store", d["state_image"], want_state["state_image"])):
        diff = image_diff(got, want)
        if diff:
            raise AssertionError(f"{name}: the synced {what} differs from the source's at "
                                 f"{cut}: {diff}")
    if d["app_record"] != want_state["app_record"] or d["app_hash"] != want_state["app_hash"]:
        raise AssertionError(f"{name}: the app's state or hash differs")
    if encode_state(d["state"]) != want_state["state"] or d["top"] != cut:
        raise AssertionError(f"{name}: handed over the state at "
                             f"{d['state'].last_block_height}, applied to {d['top']}")
    if not d["learned"] or d["learned"][0][2] != [True, True]:
        raise AssertionError(f"{name}: the seed's reply did not put both sources in the "
                             f"syncer's book: {d['learned']}")
    if not {"source1", "source2"} <= set(d["joined"]):
        raise AssertionError(f"{name}: the syncer joined {sorted(d['joined'])}")
    off = [(n, t) for n, t, _ in d["verifiers"]
           if n and t != "keyed" and not (t == "host" and n < threshold)]
    if off or d["pool_errors"]:
        raise AssertionError(f"{name}: verifies off the keyed tier {off} (device threshold "
                             f"{threshold}), {d['pool_errors']} pool-routine errors")
    newcomers = sum(1 for h in chain["rotations"] if h + 2 <= cut)
    if d["keys_built"] != nval + newcomers:
        raise AssertionError(f"{name}: {d['keys_built']} keys built, not {nval + newcomers}")
    need_launches(name, d["launches"], {"build_tables": 1 + newcomers, "sha512_keyed": 1,
                                        "verify_keyed": 1})
    if d["launches"].get("sha512_keyed") != d["launches"].get("verify_keyed"):
        raise AssertionError(f"{name}: launches {d['launches']}")
    sync_links = ("syncer->source1", "syncer->source2", "source1->syncer", "source2->syncer")
    dry = [k for k in sync_links if d["links"].get(k, (0, 0, 0.0, 0))[2] <= 0]
    if dry:
        raise AssertionError(f"{name}: no injected delay on {dry}: {d['links']}")
    planted, lines, untouched = d["planted"]
    if d["trips"] or planted is None or not untouched or \
            lines != ['cometbft_consensus_trust_guard_trips_total{sink="state.save"} 1']:
        raise AssertionError(f"{name}: trust-guard trips in the run {d['trips']}; the planted "
                             f"sink: {planted!r}, metric {lines}, store untouched "
                             f"{untouched}")
    if d["raised"] or d["demoted"]:
        raise AssertionError(f"{name}: {d['raised']} raised, tiers demoted {d['demoted']}")
    wall, wwall = d["wall_applied"], warm["wall_applied"]
    print(f"{name} [{smi}]: BASELINE config 4's chain (blocksync1024) joined through a seed: "
          f"a fresh node given only the seed's address, two sources, every connection of "
          f"the syncer and the sources through netem {d['plan']} (one cross-region link, "
          f"assumed figures); sync.configure(deadlock=True, "
          f"lockgraph=True) and trustguard.enable() armed")
    first = min(d["joined"][k] for k in ("source1", "source2"))
    print(f"  discovery: the seed's reply at {d['learned'][0][0] - d['t0']:.3f} s (addresses "
          f"{len(d['learned'][0][1])}), sources joined at "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(d["joined"].items()))
          + f" (PEX ensure interval {d['ensure_s']} s)")
    print(f"  (d) {cut} blocks applied in {wall:.3f} s from the syncer's start "
          f"({cut / wall:.2f} blocks/s, {cut * nval / wall:.0f} commit signatures/s; "
          f"{wall - first:.3f} s and {cut / (wall - first):.2f} blocks/s from the first "
          f"source's join), switch to consensus at {d['wall_switch']:.3f} s; beside (c) "
          f"warm over 127.0.0.1: {warm_heights} blocks in {wwall:.3f} s "
          f"({warm_heights / wwall:.2f} blocks/s), both read from the dial or start to "
          f"the end of the last exec/apply_block span")
    print(f"    p50 / max ms per step (tracer spans): " + "; ".join(
        f"{k} {1e3 * pct(v, 50):.3f} / {1e3 * max(v):.3f}"
        for k, v in d["steps"].items() if v))
    print("    links (frames, dropped, injected s, connections): " + "; ".join(
        f"{k} {n}, {drop}, {inj:.3f}, {c}" for k, (n, drop, inj, c) in sorted(d["links"].items()))
        + f"; the syncer's peer stops {len(d['stops'])} "
        + str(sorted({why: sum(1 for _, w in d["stops"] if w == why)
                      for _, why in d["stops"]}.items())))
    print(f"    launches (build_tables / sha512_keyed / verify_keyed / verify_generic) "
          + " / ".join(str(d["launches"].get(k, 0)) for k in KERNEL_ORDER)
          + f"; keys built {d['keys_built']}; stores, app and state equal the source's at "
          f"{cut}; trust-guard trips in the run {len(d['trips'])}, then the planted "
          f"sink's TrustGuardError ({lines[0]}); PotentialDeadlock / LockOrderError "
          f"{len(d['raised'])}; lock-order edges recorded {d['edges']}; demoted "
          f"{d['demoted']}")
    roll = d["rollup"]
    print(f"    fleetobs self_scrape of the run's registry: rollup nodes "
          f"{len(roll['nodes'])}, scrape errors {roll['scrape_errors']}, max height "
          f"{roll['max_height']}; netem series " + "; ".join(
              f"{k} {v:.4f}" for k, v in sorted(d["netem_series"].items())))
    return {k: d[k] for k in ("wall_applied", "wall_switch", "launches", "links", "joined",
                              "trips", "edges", "keys_built", "raised", "stops")} | {
        "first_join": first, "planted": lines,
        "steps": {k: (1e3 * pct(v, 50), 1e3 * max(v)) for k, v in d["steps"].items() if v}}


def bs_print(name: str, depth: int, cold: bool, r: dict, heights: int, nval: int) -> None:
    """One run's lines: walls, rates, the per-step split, the wire (the
    syncer's dispatches, a BlockResponse's bytes, the bytes each way per
    peer, the handshakes), the cache, the coalesced prefetch batches,
    launches, busy share, stops."""
    wall = r["wall_applied"]
    sigs = sum(n for n, _, _ in r["verifiers"])
    queue_sizes = [n for n, _, where in r["verifiers"] if where.startswith("verify-queue")]
    inline = [n for n, _, where in r["verifiers"] if not where.startswith("verify-queue")]
    tiers = sorted({t for n, t, _ in r["verifiers"] if n})
    steps = r["steps"]

    def line(label: str) -> str:
        xs = steps.get(label)
        if not xs:
            return f"{label} -"
        return f"{label} {1e3 * pct(xs, 50):.3f} / {1e3 * max(xs):.3f}"

    print(f"  ({name}) {'cold' if cold else 'warm'} tables, prefetch depth {depth}: "
          f"{heights} blocks applied in {wall:.3f} s ({heights / wall:.2f} blocks/s, "
          f"{heights * nval / wall:.0f} commit signatures/s), switch to consensus at "
          f"{r['wall_switch']:.3f} s")
    print(f"    p50 / max ms per step (tracer spans): " + "; ".join(
        line(k) for k in ("pool wait",) + tuple(label for label, *_ in BS_STEPS)
        + ("switch_dispatch (syncer)",)))
    sizes = r["block_bytes"]
    names = {r["byz_id"]: "byzantine", r["honest_id"]: "honest", r["syncer_id"]: "syncer"}
    print(f"    wire: BlockResponse bytes p50 {pct(sizes, 50):.0f}, max {max(sizes)} "
          f"({len(sizes)} received); bytes sent / received by the syncer per peer "
          f"(flow monitors) {r['wire']}; handshakes ms (both ends of each connection) "
          f"{[round(1e3 * x, 3) for x in r['handshakes']]}; send timeouts "
          f"{r['send_timeouts']}, try_send failures {r['try_send_failures']}")
    cpu = dict(r["cpu"])
    process, cwall = cpu.pop("process"), cpu.pop("wall")
    print(f"    CPU s by thread from the dial to the switch ({process:.2f} s of process CPU "
          f"in {cwall:.2f} s; /proc ticks): " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(cpu.items(), key=lambda kv: -kv[1]) if v >= 0.05))
    stops = {who: [(names.get(pid, pid), str(why)) for pid, why in got]
             for who, got in r["stops"].items()}
    redone = [(h, names.get(pid, pid)) for h, pid in r["redone"]]
    print(f"    spec cache: {r['hits']:.0f} hits, {r['misses']:.0f} misses "
          f"({r['hits'] / (2 * heights):.1f} hits per verify); prefetch batches "
          f"{len(queue_sizes)} (coalesced sizes p50 "
          f"{pct(queue_sizes, 50) if queue_sizes else 0:.0f}, max "
          f"{max(queue_sizes, default=0)}), verifiers outside the queue {len(inline)} "
          f"({sum(inline)} signatures); {sigs} signatures sent to verifiers, tiers {tiers}")
    by_tier: dict = {}
    for n, tier, _ in r["verifiers"]:
        if n:
            by_tier[tier] = by_tier.get(tier, 0) + 1
    print(f"    launches {r['launches']}; keys built {r['keys_built']}; verifiers per tier "
          f"{by_tier}; busy share {r['busy'] / wall:.3f} ({r['busy']:.3f} s); sqlite "
          f"{r['mib']:.2f} MiB; stops by switch {stops}, redone {redone}")
    print(f"    cost model after the run (tier: sigs/s, samples, source): " + "; ".join(
        f"bucket {b}: " + ", ".join(f"{t} {v:.0f} {n} {src}" for t, v, n, src in rows)
        for b, rows in r["cost"].items() if rows) + f"; adopted orders {r['orders']}")


# -- phase 17: consensus ------------------------------------------------------------

CS_CHAIN_ID = "chip-smoke-consensus"
CS_T0 = 1_760_000_000_000_000_000
CS_NODES = 4                # localnet4: validators at power 10, fully meshed
CS_TXS = 512                # localnet4: signed txs sent to node 0
CS_CLIENTS = 32             # localnet4: client threads sending them
CS_MIN_HEIGHTS = 12         # localnet4: at least this many heights
CS_STUBS = 149              # commit150-consensus: stub validators beside the node
CS_STUB_HEIGHTS = 8         # commit150-consensus: heights per run
CS_EQUIVOCATE_AT = 3        # (e1): the height (b2)'s first stub equivocates at
CS_WAL_HEIGHTS = 4          # (w): heights per run
CS_WAL_CRASH_AT = 3         # (w): the height the node is stopped in
CS_WAL_COMMIT_NS = 100 * 10**6  # (w): its commit timeout
CS_STEP_NAMES = ("NewHeight", "NewRound", "Propose", "Prevote", "PrevoteWait", "Precommit",
                 "PrecommitWait", "Commit")
CS_REMOTE_TXS = 256         # (r): signed txs sent to the node's mempool before height 2
CS_RETAIN = 4               # (r): the app's Commit asks to retain the last CS_RETAIN heights
CS_PRUNE_S = 0.2            # (r): the pruner's interval
CS_GRPC_HEIGHTS = 3         # (r) over gRPC: heights
CS_CHILD_S = 60.0           # (r): bound on a child's start and on the signer's dial-in
CS_APP_ERROR_S = 5.0        # (r): bound on on_error after the app child is killed

#: (r)'s app process: ``python -c APP_CHILD TRANSPORT ADDR RECORD RETAIN``.
#: The port's KVStoreApp behind ``abci.grammar.RecordingApp``, served by
#: the port's SocketServer ("socket") or GrpcServer ("grpc"); its Commit
#: asks to retain the last RETAIN heights, as the retain_blocks setting
#: of CometBFT's e2e app does.  It prints {"addr": ...} once it listens,
#: writes the recorded calls to RECORD at every Commit and on SIGTERM,
#: and then prints its height and app hash.  It is host code: it never
#: imports torch, so it cannot touch the card.
APP_CHILD = """
import json, os, signal, sys, threading
from cometbft_tpu_torch.abci.grammar import RecordingApp
from cometbft_tpu_torch.abci.kvstore import KVStoreApp
from cometbft_tpu_torch.abci.types import CommitResponse

transport, addr, record, retain = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])


def dump():
    with rec._mtx:
        calls = list(rec.calls)
    with open(record + ".tmp", "w") as f:
        json.dump(calls, f)
    os.replace(record + ".tmp", record)


class RetainApp(KVStoreApp):
    def commit(self):
        super().commit()
        dump()
        return CommitResponse(retain_height=max(self.height - retain, 0))


rec = RecordingApp(RetainApp())
if transport == "grpc":
    from cometbft_tpu_torch.abci.grpc import GrpcServer
    srv = GrpcServer(rec, addr)
    listen = "grpc://127.0.0.1:%d" % srv.port
else:
    from cometbft_tpu_torch.abci.server import SocketServer
    srv = SocketServer(addr, rec)
srv.start()
if transport != "grpc":
    listen = srv.listen_addr
if "torch" in sys.modules:
    raise SystemExit("the app process imported torch")
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *a: stop.set())
print(json.dumps({"addr": listen}), flush=True)
while not stop.wait(0.5):
    pass
srv.stop()
dump()
print(json.dumps({"height": rec.inner.height, "app_hash": rec.inner.app_hash.hex()}), flush=True)
"""


class ErrorLines:
    """A logger sink that keeps the lines written to it (an error-level
    ``utils.log.Logger`` writes only error lines)."""

    def __init__(self) -> None:
        self.lines: list[str] = []

    def write(self, s: str) -> None:
        self.lines.append(s.rstrip("\n"))


def scalar_keys(a0: int, n: int) -> list:
    """(scalar, public key) for the scalars a0, a0 + 1, ...: one point
    addition each.  Valid Ed25519 keys, not derived from RFC 8032 seeds."""
    from cometbft_tpu_torch.crypto import edwards as E

    out, pt = [], E.pt_mul(a0 % E.L, E.B_POINT)
    for i in range(n):
        out.append(((a0 + i) % E.L, E.encode_point(pt)))
        pt = E.pt_add(pt, E.B_POINT)
    return out


class FastKey:
    """A private key for ``mempool.ingest.make_signed_tx`` that signs with
    a FastSigner."""

    def __init__(self, signer: FastSigner, a: int, pub: bytes) -> None:
        self.signer, self.a, self.pub = signer, a, pub

    def pub_key(self):
        from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey

        return Ed25519PubKey(self.pub)

    def sign(self, msg: bytes) -> bytes:
        return self.signer.sign(self.a, self.pub, msg)


def cs_txs(n: int, rs) -> list[bytes]:
    """``n`` signed txs (``make_signed_tx``), each a 64-100-byte kvstore
    payload with a key of its own, each from a sender key of its own."""
    from cometbft_tpu_torch.mempool.ingest import make_signed_tx

    signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
    keys = scalar_keys(int.from_bytes(rs.bytes(32), "little"), n)
    payloads = bs_txs(0, n, rs)
    return [make_signed_tx(FastKey(signer, a, pub), b"cs" + p[1:]) for (a, pub), p
            in zip(keys, payloads)]


def spawn_child(args: list, log_path: str) -> subprocess.Popen:
    """A child process running ``python`` with ``args`` from the repo's
    root, in a session of its own (so a signal reaches all of it), its
    stdout piped back and its stderr to ``log_path``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "w") as err:
        return subprocess.Popen([sys.executable, *args], cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err, start_new_session=True)


def child_line(p: subprocess.Popen, timeout: float, what: str) -> dict:
    """The next line a child prints, as JSON, within ``timeout`` s."""
    import select

    ready, _, _ = select.select([p.stdout], [], [], timeout)
    line = p.stdout.readline() if ready else ""
    if not line:
        raise AssertionError(f"{what}: no line within {timeout} s (exit code {p.poll()})")
    return json.loads(line)


def stop_child(p: subprocess.Popen, what: str, sig: int = signal.SIGTERM) -> str:
    """Sends ``sig`` to the child's session, waits (bounded), then
    SIGKILL; -> what it printed.  Fails if it is still alive."""
    if p.poll() is None:
        os.killpg(p.pid, sig)
    try:
        out, _ = p.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate(timeout=5)
    if p.poll() is None:
        raise AssertionError(f"{what}: still alive after SIGKILL")
    return out or ""


class TimedSigner:
    """(r)'s priv_validator: a ``privval.signer.SignerClient`` whose
    sign_vote and sign_proposal round trips are counted and timed (s)."""

    def __init__(self, client) -> None:
        self.client, self.votes, self.proposals = client, [], []

    @property
    def pub_key(self):
        return self.client.pub_key

    @property
    def address(self) -> bytes:
        return self.client.address

    def get_pub_key(self):
        return self.client.pub_key

    def sign_vote(self, chain_id: str, vote, with_extension: bool = False):
        t = time.perf_counter()
        out = self.client.sign_vote(chain_id, vote, with_extension=with_extension)
        self.votes.append(time.perf_counter() - t)
        return out

    def sign_proposal(self, chain_id: str, proposal):
        t = time.perf_counter()
        out = self.client.sign_proposal(chain_id, proposal)
        self.proposals.append(time.perf_counter() - t)
        return out


def first_proposer_key(stub_pubs: list):
    """A validator key whose address is below every stub's: at equal
    power the lowest address proposes height 1 (types/validator.py), so
    (r)'s node signs a proposal through its signer."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey, priv_key_from_secret

    low = min(Ed25519PubKey(p).address() for p in stub_pubs)
    for i in range(100000):
        key = priv_key_from_secret(b"smoke-remote-node-%d" % i)
        if key.pub_key().address() < low:
            return key
    raise AssertionError("no key below the stubs' addresses")


def index_checker(node: dict, stop: threading.Event, out: dict) -> threading.Thread:
    """(r)'s index check, on a thread of its own: for each NewBlock on
    the node's bus, waits (bounded) until the IndexerService has indexed
    the block, then every tx is found by hash with its height, index and
    FinalizeBlock result, and ``tx.height=H`` finds exactly block H's
    txs.  Records (height, txs) in ``out["checked"]``, each failure in
    ``out["failed"]``, block H's tx hashes in ``out["txs"][H]`` and the
    signatures present and round of its LastCommit in
    ``out["last_commits"][H - 1]`` (the pruner removes the stored
    commits below its retain height while the run goes on)."""
    from cometbft_tpu_torch.types.block import tx_hash
    from cometbft_tpu_torch.types.event_bus import EVENT_QUERY_NEW_BLOCK

    sub = node["bus"].subscribe("smoke-index-check", EVENT_QUERY_NEW_BLOCK, capacity=1000)
    txi, db = node["tx_indexer"], node["index_db"]

    def check(data) -> None:
        h, txs = data.block.header.height, list(data.block.data.txs)
        results = data.result_finalize_block.tx_results
        hashes = [tx_hash(tx) for tx in txs]
        deadline = time.perf_counter() + 10.0
        while (db.get(b"blk/height/" + h.to_bytes(8, "big")) is None
               or any(txi.get(x) is None for x in hashes)):
            if time.perf_counter() > deadline:
                out["failed"].append((h, "not indexed within 10 s"))
                return
            time.sleep(0.005)
        for i, (tx, x, want) in enumerate(zip(txs, hashes, results)):
            got = txi.get(x)
            r = got["result"]
            if (got["height"], got["index"], got["tx"]) != (h, i, tx) or (
                    r.code, r.data, r.log, r.gas_wanted, r.gas_used, r.events) != (
                    want.code, want.data, want.log, want.gas_wanted, want.gas_used,
                    tuple(want.events)):
                out["failed"].append((h, f"tx {i} indexed as {got['height']}/{got['index']}"))
        found = {tx_hash(e["tx"]) for e in txi.search(f"tx.height = {h}", limit=1 << 20)}
        if found != set(hashes):
            out["failed"].append((h, f"tx.height={h} found {len(found)} of {len(hashes)}"))
        out["checked"].append((h, len(txs)))
        out["txs"][h] = hashes
        if h > 1:
            lc = data.block.last_commit
            out["last_commits"][h - 1] = (sum(1 for c in lc.signatures if not c.is_absent()),
                                          lc.round)

    def run() -> None:
        while not stop.is_set():
            try:
                msg = sub.next(timeout=0.05)
            except TimeoutError:
                continue
            check(msg.data)

    t = threading.Thread(target=run, name="smoke-index-check")
    t.start()
    return t


def check_pruned(name: str, node: dict, retain: int, dev) -> dict:
    """(r)'s pruning check after the pruner's last run: nothing below
    ``retain`` in the block store, the state store's sets, params and
    FinalizeBlock responses, or either index; the top commit verifies.
    -> the counts pruned."""
    from cometbft_tpu_torch.state import _ABCI_RESP, _PARAMS, _VALS, _hkey
    from cometbft_tpu_torch.types.validation import verify_commit

    blocks, states, db = node["block_store"], node["state_store"], node["index_db"]
    deadline = time.perf_counter() + 10.0
    while blocks.base() < retain and time.perf_counter() < deadline:
        time.sleep(0.01)
    node["pruner"].stop()
    left = []
    if retain > 1 and blocks.base() != retain:
        left.append(f"block store base {blocks.base()}")
    left += [f"block {h}" for h in range(1, retain)
             if blocks.load_block_meta(h) is not None or blocks.load_seen_commit(h) is not None]
    for prefix in (_VALS, _PARAMS, _ABCI_RESP):
        left += [repr(k) for k, _ in states._db.iterator(prefix, _hkey(prefix, retain))]
    # the indexes' keys end in the height (8 bytes), then a tx's index (4)
    txi, below = node["tx_indexer"], lambda k, end: int.from_bytes(k[end - 8:end], "big") < retain
    left += [f"tx index row {k!r}" for k, _ in db.prefix_iterator(b"txh/") if below(k, 12)]
    left += [f"tx event key {k!r}" for k, _ in db.prefix_iterator(b"txk/") if below(k, len(k) - 4)]
    left += [f"block event key {k!r}" for k, _ in db.prefix_iterator(b"blk/") if below(k, len(k))]
    left += [f"tx result {k[3:].hex()}" for k, _ in db.prefix_iterator(b"tx/")
             if txi.get(k[3:])["height"] < retain]
    if left:
        raise AssertionError(f"{name}: below the retain height {retain}: {left[:8]}")
    top = blocks.height()
    verify_commit(node["cs"].state.chain_id, node["cs"].state.last_validators,
                  blocks.load_block_meta(top).block_id, top, blocks.load_seen_commit(top),
                  device=dev)
    return dict(retain=retain, base=blocks.base(), top=top,
                pruned_blocks=plain_value(node["registry"], "cometbft_state_pruned_blocks"))


def cs_node(dev, gen, pv, config, dirname: str | None, logger, switch: bool = True,
            moniker: str = "node", wal=None, determinism: bool = False,
            evidence: bool = False, proxy_app: str | None = None,
            prune_s: float | None = None) -> dict:
    """A consensus node as the reference's Node assembles one: block and
    state stores (sqlite in ``dirname``, else MemDBs), a KVStoreApp over a
    MemDB through the local proxy, an EventBus, a CListMempool with the
    node's pre/post checks, the BlockExecutor, the Handshaker (InitChain
    at genesis), ConsensusState (``logger``: consensus's and its
    reactor's); with ``switch``, a ConsensusReactor (waiting for
    ``switch_to_consensus``) and a MempoolReactor on a switch of
    ``p2p.test_util.make_switch``.  Its metrics go to its own registry.
    ``wal``: the consensus WAL (a started ``wal.WAL``; else the NopWAL),
    ``determinism``: the executor's and Handshaker's digest guard,
    ``evidence``: an evidence ``Pool`` over a MemDB in the executor, and
    the app's FinalizeBlock misbehavior types kept in ``misbehavior``.
    ``proxy_app``: an external app's address (``tcp://``, ``unix://`` or
    ``grpc://``) for ``proxy.default_client_creator`` in place of the
    in-process KVStoreApp (``app`` None); the first app error is kept in
    ``app_error`` as (perf_counter s, error) and stops consensus, as the
    reference node's ``_stop_for_app_error`` stops the node.
    ``prune_s``: an ``IndexerService`` with a ``TxIndexer`` and a
    ``BlockIndexer`` over one MemDB (``index_db``) on the bus, and a
    ``Pruner`` with that interval wired as the executor's ``pruner``."""
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.consensus import ConsensusState, Handshaker
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.mempool import CListMempool, post_check_max_gas, pre_check_max_bytes
    from cometbft_tpu_torch.mempool.reactor import MempoolReactor
    from cometbft_tpu_torch.p2p.test_util import make_switch
    from cometbft_tpu_torch.proxy import (default_client_creator, local_client_creator,
                                          new_app_conns)
    from cometbft_tpu_torch.state import Store, load_state_from_db_or_genesis
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.event_bus import EventBus
    from cometbft_tpu_torch.utils.db import MemDB
    from cometbft_tpu_torch.utils.log import NopLogger
    from cometbft_tpu_torch.utils.metrics import Registry

    if dirname is not None:
        block_store, state_store, dbs = open_stores(dirname)
    else:
        dbs = (MemDB(), MemDB())
        block_store, state_store = BlockStore(dbs[0]), Store(dbs[1])
    n = dict(block_store=block_store, state_store=state_store, dbs=dbs, registry=Registry(),
             app=None if proxy_app else KVStoreApp(MemDB()), bus=EventBus(), services=[],
             misbehavior=[], pool=None, app_error=None)
    if evidence:
        from cometbft_tpu_torch.evidence import Pool

        n["pool"] = Pool(MemDB(), state_store, block_store, logger=NopLogger(),
                         metrics=M.EvidenceMetrics(n["registry"]), device=dev)
        finalize = n["app"].finalize_block

        def finalize_block(req):
            n["misbehavior"].extend((req.height, m.type) for m in req.misbehavior)
            return finalize(req)

        n["app"].finalize_block = finalize_block
    if proxy_app:
        n["conns"] = new_app_conns(default_client_creator(proxy_app),
                                   metrics=M.ProxyMetrics(n["registry"]))

        def stop_for_app_error(exc) -> None:
            n["app_error"] = (time.perf_counter(), exc)
            if "cs" in n and n["cs"].is_running():
                n["cs"].stop()

        n["conns"].set_on_error(stop_for_app_error)
    else:
        n["conns"] = new_app_conns(local_client_creator(n["app"]))
    try:
        for svc in (n["conns"], n["bus"]):
            svc.start()
            n["services"].append(svc)
        if prune_s is not None:
            from cometbft_tpu_torch.state.txindex import BlockIndexer, IndexerService, TxIndexer

            n["index_db"] = MemDB()
            n["tx_indexer"], n["block_indexer"] = TxIndexer(n["index_db"]), BlockIndexer(
                n["index_db"])
            indexer = IndexerService(n["tx_indexer"], n["block_indexer"], n["bus"],
                                     logger=NopLogger())
            indexer.start()
            n["services"].append(indexer)
        state = load_state_from_db_or_genesis(state_store, gen)
        mc = config.mempool
        n["mempool"] = CListMempool(
            n["conns"].mempool, height=state.last_block_height, size=mc.size,
            max_tx_bytes=mc.max_tx_bytes, max_txs_bytes=mc.max_txs_bytes,
            cache_size=mc.cache_size, keep_invalid_txs_in_cache=mc.keep_invalid_txs_in_cache,
            recheck=mc.recheck, metrics=M.MempoolMetrics(n["registry"]), device=dev)
        n["exec"] = BlockExecutor(state_store, n["conns"].consensus, n["mempool"],
                                  evidence_pool=n["pool"],
                                  block_store=block_store, event_bus=n["bus"],
                                  metrics=M.StateMetrics(n["registry"]), logger=NopLogger(),
                                  device=dev, determinism=determinism)
        n["state"] = Handshaker(state_store, state, block_store, gen, logger=NopLogger(),
                                device=dev, determinism=determinism).handshake(n["conns"])
        if prune_s is not None:
            from cometbft_tpu_torch.state.pruner import Pruner

            n["pruner"] = Pruner(state_store, block_store, n["tx_indexer"], n["block_indexer"],
                                 interval_s=prune_s, metrics=n["exec"].metrics,
                                 logger=NopLogger())
            n["exec"].pruner = n["pruner"]
            n["pruner"].start()
            n["services"].append(n["pruner"])
        max_bytes = n["state"].consensus_params.block.max_bytes
        n["mempool"].pre_check = pre_check_max_bytes(max_bytes if max_bytes > 0 else 104857600)
        n["mempool"].post_check = post_check_max_gas(n["state"].consensus_params.block.max_gas)
        n["cs"] = ConsensusState(config.consensus, n["state"], n["exec"], block_store,
                                 priv_validator=pv, event_bus=n["bus"], wal=wal,
                                 metrics=M.ConsensusMetrics(n["registry"]), logger=logger,
                                 device=dev)
        n["services"].append(n["cs"])
        if switch:
            n["cr"] = ConsensusReactor(n["cs"], wait_sync=True, logger=logger)
            n["mr"] = MempoolReactor(n["mempool"], broadcast=mc.broadcast, logger=NopLogger())
            n["sw"] = make_switch(network=gen.chain_id, moniker=moniker,
                                  reactors={"CONSENSUS": n["cr"], "MEMPOOL": n["mr"]})
            n["services"].append(n["sw"])
    except BaseException:
        cs_close(n)
        raise
    return n


def cs_mesh(ns: list, timeout: float) -> list:
    """Meshes the nodes' switches as ``p2p.persistent_peers`` does in a
    localnet (the reference's localnet tests dial so too): node i dials
    each later node, persistent, so a link dropped under load (a pong
    timeout while a node's receive threads wait on a lock its consensus
    thread holds through the app's calls) is dialed again with the
    switch's backoff.  -> the peers each switch holds once every pair is
    joined."""
    for i, a in enumerate(ns):
        for b in ns[i + 1:]:
            if not a["sw"].dial_peer_with_address(b["sw"].transport.listen_addr,
                                                  persistent=True):
                raise AssertionError(f"localnet: node {i} failed to dial "
                                     f"{b['sw'].transport.listen_addr}")
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        links = [n["sw"].peers.copy() for n in ns]
        if all(len(p) == len(ns) - 1 for p in links):
            return links
        time.sleep(0.01)
    raise AssertionError(f"localnet: peers {[len(p) for p in links]} after {timeout} s")


def cs_net_report(ns: list, errors: ErrorLines) -> str:
    """What a stalled localnet looks like: each node's height, round,
    step, peers, consensus queue depth and mempool size, and the
    consensus errors logged (the switches log each peer they stop)."""
    nodes = "; ".join(
        f"node {i} at {n['cs'].height}/{n['cs'].round}/{n['cs'].step}, "
        f"{len(n['sw'].peers.copy())} peers, queue {n['cs']._queue.qsize()}, "
        f"mempool {n['mempool'].size()}"
        for i, n in enumerate(ns))
    return f"{nodes}; errors {errors.lines[:5]}"


def cs_close(n: dict) -> None:
    """Stops a node's services, last started first, and closes its DBs."""
    from cometbft_tpu_torch.utils.service import NotStartedError

    for svc in reversed(n["services"]):
        try:
            svc.stop()
        except NotStartedError:
            pass
    n["services"] = []
    for db in n["dbs"]:
        db.close()


def cs_steps(events: list) -> dict:
    """p50/max seconds of each consensus step (the ``consensus/<Step>``
    spans ConsensusState records as it leaves a step)."""
    out = {}
    for step in CS_STEP_NAMES:
        d = [e["dur"] / 1e6 for e in events if e["name"] == f"consensus/{step}"]
        if d:
            out[step] = (pct(d, 50), max(d), len(d))
    return out


def spans_by_name(events: list, prefix: str) -> dict:
    """name -> the seconds of each span whose name starts with ``prefix``."""
    out: dict = {}
    for e in events:
        if e["name"].startswith(prefix):
            out.setdefault(e["name"], []).append(e["dur"] / 1e6)
    return out


def cs_abci(events: list) -> dict:
    """The app's calls from the ``abci/<method>`` spans: method -> (count,
    seconds); CheckTx split into the mempool's recheck (inside
    ``exec/apply_block``) and admission (the rest)."""
    out: dict = {}
    for e in events:
        if not e["name"].startswith("abci/"):
            continue
        key = e["name"][5:]
        if key == "check_tx":
            key += (" (recheck)" if e["args"].get("parent") == "exec/apply_block"
                    else " (admission)")
        n, t = out.get(key, (0, 0.0))
        out[key] = (n + 1, t + e["dur"] / 1e6)
    return out


def cs_ingest(events: list) -> dict:
    """The queue's launches from its spans: lane -> batch sizes."""
    out: dict = {}
    for e in events:
        if e["name"] == "verify_queue/launch":
            out.setdefault(e["args"].get("priority"), []).append(e["args"].get("batch"))
    return out


def plain_value(registry, name: str) -> float:
    """An unlabelled sample's value from the exposition (0 when absent)."""
    for line in registry.expose().splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def tier_counts(registry) -> dict:
    """crypto_dispatch_tier's samples: tier -> count."""
    out = {}
    for line in registry.expose().splitlines():
        if line.startswith("cometbft_crypto_dispatch_tier{"):
            tier = line.split('tier="', 1)[1].split('"', 1)[0]
            out[tier] = out.get(tier, 0) + float(line.rsplit(" ", 1)[1])
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def cs_localnet(dev, smi: str, registry, nodes: int = CS_NODES, ntx: int = CS_TXS,
                clients: int = CS_CLIENTS, min_heights: int = CS_MIN_HEIGHTS, config=None,
                timeout_s: float = 300.0, work: str | None = None,
                verifier_factory=None) -> dict:
    """Run (a), localnet4: ``nodes`` port validators at power 10 over
    127.0.0.1 TCP, fully meshed, each a ``cs_node`` with sqlite stores, the
    verify queue installed (the node's default), ``ntx`` signed txs sent to
    node 0 by ``clients`` threads; until every tx is committed and at
    least ``min_heights`` heights.  Fails unless every node stored the
    same block hash at every height, each tx was committed exactly once,
    the app hashes agree and no node logged a consensus error.
    ``verifier_factory``: the queue's (default the card's)."""
    import shutil

    from cometbft_tpu_torch import config as C
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.crypto.ed25519 import priv_key_from_secret
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils.log import Logger
    from cometbft_tpu_torch.utils.trace import TRACER

    config = config or C.default_config()
    rs = np.random.RandomState(SEED + 1717)
    pvs = [FilePV(priv_key_from_secret(b"smoke-validator-%d" % i)) for i in range(nodes)]
    gen = GenesisDoc(chain_id=CS_CHAIN_ID, genesis_time_ns=CS_T0,
                     validators=tuple(GenesisValidator(pv.pub_key, 10) for pv in pvs))
    t0 = time.perf_counter()
    txs = cs_txs(ntx, rs)
    data_s = time.perf_counter() - t0
    work = work or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                "consensus_localnet")
    shutil.rmtree(work, ignore_errors=True)
    threads = live_threads()
    errors = ErrorLines()
    tiers0 = tier_counts(registry)
    q = VQ.VerifyQueue(verifier_factory=verifier_factory)
    q.start()
    VQ.install_queue(q)
    ns: list = []
    ring = TRACER.capacity
    TRACER.set_capacity(1 << 20)
    TRACER.clear()
    _build.reset_launches()
    res: dict = {"data_s": data_s}
    try:
        for i, pv in enumerate(pvs):
            d = os.path.join(work, f"node{i}")
            os.makedirs(d)
            ns.append(cs_node(dev, gen, pv, config, d,
                              Logger(sink=errors, level="error", fields={"node": i}),
                              moniker=f"node{i}"))
        for n in ns:
            n["sw"].start()
        links0 = cs_mesh(ns, timeout=30.0)
        t_start = time.perf_counter()
        for n in ns:
            n["cr"].switch_to_consensus(n["state"])
        sent_errors: list = []
        admitted: list = []

        def client(k: int) -> None:
            for tx in txs[k::clients]:
                try:
                    ns[0]["mempool"].check_tx(tx)
                    admitted.append(tx)
                except Exception as exc:  # noqa: BLE001 -- every rejection fails the run
                    sent_errors.append(repr(exc))

        senders = [threading.Thread(target=client, args=(k,), name=f"cs-client-{k}")
                   for k in range(clients)]
        for t in senders:
            t.start()
        for t in senders:
            t.join(timeout_s)
        res["admit_s"] = time.perf_counter() - t_start
        if sent_errors or len(admitted) != ntx:
            raise AssertionError(f"localnet: node 0 refused {len(sent_errors)} of {ntx} txs: "
                                 f"{sent_errors[:3]}")
        deadline = time.perf_counter() + timeout_s
        want = set(txs)
        while time.perf_counter() < deadline:
            top = min(n["block_store"].height() for n in ns)
            if top >= min_heights:
                seen = set()
                for h in range(1, top + 1):
                    seen.update(ns[0]["block_store"].load_block(h).data.txs)
                if want <= seen:
                    break
            time.sleep(0.1)
        else:
            raise AssertionError(f"localnet: heights {[n['block_store'].height() for n in ns]} "
                                 f"after {timeout_s} s, txs not all committed; "
                                 + cs_net_report(ns, errors))
        res["wall"] = time.perf_counter() - t_start
        res["redialed"] = sum(1 for n, first in zip(ns, links0)
                              for p in n["sw"].peers.copy() if p not in first)
        events = TRACER.events()
        res["mempool"] = [{k: registry_value(n["registry"], "cometbft_mempool_checktx_total",
                                             f'result="{k}"')
                           for k in ("accepted", "duplicate", "sig", "app", "full")}
                          | {"batched": plain_value(n["registry"],
                                                    "cometbft_mempool_checktx_batched"),
                             "inline": plain_value(n["registry"],
                                                   "cometbft_mempool_checktx_inline")}
                          for n in ns]
    finally:
        for n in ns:
            cs_close(n)
        q.stop()
        TRACER.set_capacity(ring)
    res["launches"] = end_phase("consensus localnet4", threads)
    res["tiers"] = delta(tier_counts(registry), tiers0)
    if errors.lines:
        raise AssertionError(f"localnet: consensus errors logged: {errors.lines[:5]}")
    # the checks, on the stores as the nodes left them
    stores = [open_stores(os.path.join(work, f"node{i}")) for i in range(nodes)]
    try:
        top = min(b.height() for b, _, _ in stores)
        committed: list = []
        rounds = []
        for h in range(1, top + 1):
            hashes = {b.load_block_meta(h).block_id.hash for b, _, _ in stores}
            if len(hashes) != 1:
                raise AssertionError(f"localnet: the nodes stored different blocks at {h}")
            committed += list(stores[0][0].load_block(h).data.txs)
            rounds.append(stores[0][0].load_seen_commit(h).round)
        if len(committed) != len(set(committed)) or set(committed) != set(txs):
            raise AssertionError(f"localnet: {len(committed)} txs committed, "
                                 f"{len(set(committed))} distinct, of {ntx}")
        app_hashes = {s.load_finalize_block_response(top).app_hash for _, s, _ in stores}
        if len(app_hashes) != 1:
            raise AssertionError(f"localnet: the app hashes differ at height {top}")
        res.update(heights=top, rounds=rounds, block_txs=[len(stores[0][0].load_block(h).data.txs)
                                                          for h in range(1, top + 1)])
    finally:
        for _, _, dbs in stores:
            for db in dbs:
                db.close()
        shutil.rmtree(work, ignore_errors=True)
    res["steps"] = cs_steps(events)
    res["ingest"] = cs_ingest(events)
    res["abci"] = cs_abci(events)
    return res


def start_remote(rem: dict, transport: str, work: str, chain: str, key_path: str,
                 state_path: str) -> None:
    """(r)'s two children, recorded in ``rem`` as they start (the caller
    stops them whatever happens): the app (``APP_CHILD``, on a
    ``unix://`` socket in ``work`` or a ``grpc://`` port it picks) and,
    once the node's ``SignerListenerEndpoint`` listens on 127.0.0.1, the
    signer (``python -m cometbft_tpu_torch.privval.signer``) dialling it
    with the validator's key and state files.  Fills ``addr`` (the app's),
    ``endpoint`` (started, the signer connected), ``record`` (the app's
    call record) and ``start_s``."""
    from cometbft_tpu_torch.privval.signer import SignerListenerEndpoint

    t0 = time.perf_counter()
    rem["record"] = os.path.join(work, "app_calls.json")
    # a unix socket in ``work`` unless its path is too long for one
    sock = os.path.join(work, "app.sock")
    listen = ("127.0.0.1:0" if transport == "grpc" else
              "unix://" + sock if len(sock) < 100 else "tcp://127.0.0.1:0")
    rem["app"] = spawn_child(["-c", APP_CHILD, transport, listen, rem["record"], str(CS_RETAIN)],
                             os.path.join(work, "app.log"))
    rem["addr"] = child_line(rem["app"], CS_CHILD_S, "the app process")["addr"]
    rem["endpoint"] = SignerListenerEndpoint("tcp://127.0.0.1:0", chain,
                                             accept_timeout=CS_CHILD_S)
    rem["endpoint"].start()
    rem["signer"] = spawn_child(
        ["-m", "cometbft_tpu_torch.privval.signer", "--key", key_path, "--state", state_path,
         "--addr", rem["endpoint"].listen_addr, "--chain-id", chain],
        os.path.join(work, "signer.log"))
    if not rem["endpoint"].wait_for_signer(CS_CHILD_S):
        raise AssertionError(f"the signer did not dial in within {CS_CHILD_S} s "
                             f"(exit code {rem['signer'].poll()})")
    rem["start_s"] = time.perf_counter() - t0


def stop_remote(rem: dict) -> None:
    """Stops whatever of ``rem``'s children and endpoint is still up."""
    for key in ("app", "signer"):
        if key in rem and rem[key].poll() is None:
            stop_child(rem[key], f"the {key} process")
    if "endpoint" in rem:
        rem["endpoint"].stop()


def end_remote(name: str, node: dict, rem: dict, pv: TimedSigner, checked: dict,
               sent: list, errors: ErrorLines, dev) -> dict:
    """(r)'s end, with consensus still running: the node's app hash
    against the app's Info; the app killed with SIGKILL and one CheckTx
    sent, so ``on_error`` must fire within CS_APP_ERROR_S and stop
    consensus; the app's recorded calls through ``check_grammar``; each
    sent tx committed once and found in the index (``index_checker``);
    the pruned stores and indexes (``check_pruned``); the signer's own
    counts against the node's.  -> the figures it printed from."""
    from cometbft_tpu_torch.abci.grammar import check_grammar
    from cometbft_tpu_torch.abci.types import InfoRequest
    from cometbft_tpu_torch.types.block import tx_hash

    cs = node["cs"]
    info = node["conns"].query.info(InfoRequest())
    if (info.last_block_height, info.last_block_app_hash) != (cs.state.last_block_height,
                                                             cs.state.app_hash):
        raise AssertionError(f"{name}: the app's Info {info.last_block_height} "
                             f"{info.last_block_app_hash.hex()} != the node's "
                             f"{cs.state.last_block_height} {cs.state.app_hash.hex()}")
    if errors.lines:
        raise AssertionError(f"{name}: consensus errors logged: {errors.lines[:5]}")
    t_kill = time.perf_counter()
    stop_child(rem["app"], "the app process", signal.SIGKILL)
    try:
        node["mempool"].check_tx(b"smoke-after-kill=1")
        probe = "accepted"
    except Exception as exc:  # noqa: BLE001 -- the dead app's error, recorded
        probe = type(exc).__name__
    deadline = t_kill + CS_APP_ERROR_S
    while (node["app_error"] is None or cs.is_running()) and time.perf_counter() < deadline:
        time.sleep(0.01)
    if node["app_error"] is None or cs.is_running():
        raise AssertionError(f"{name}: on_error {node['app_error']}, consensus running "
                             f"{cs.is_running()} {CS_APP_ERROR_S} s after the app was killed")
    out = dict(on_error_s=node["app_error"][0] - t_kill, app_error=repr(node["app_error"][1]),
               probe=probe, errors_after_kill=len(errors.lines))
    errors.lines.clear()
    with open(rem["record"]) as f:
        calls = [tuple(c) for c in json.load(f)]
    check_grammar(calls, clean_start=True)
    out["calls"] = len(calls)
    committed = [x for h in sorted(checked["txs"]) for x in checked["txs"][h]]
    want = sorted(tx_hash(tx) for tx in sent)
    if sorted(committed) != want:
        raise AssertionError(f"{name}: {len(committed)} txs committed ({len(set(committed))} "
                             f"distinct) of the {len(sent)} sent; heights checked "
                             f"{checked['checked']}, failed {checked['failed'][:3]}")
    top = cs.state.last_block_height
    if checked["failed"] or sorted(h for h, _ in checked["checked"]) != list(range(1, top + 1)):
        raise AssertionError(f"{name}: index checks failed {checked['failed'][:5]}, heights "
                             f"checked {sorted(h for h, _ in checked['checked'])}")
    out["pruned"] = check_pruned(name, node, node["pruner"].effective_retain_height(), dev)
    out["pruned"]["txs_unindexed"] = sum(len(checked["txs"][h]) for h in checked["txs"]
                                         if h < out["pruned"]["retain"])
    served = child_line_text(stop_child(rem["signer"], "the signer process"))["signer_served"]
    want = {"vote": len(pv.votes), "proposal": len(pv.proposals)}
    if {k: served.get(k, 0) for k in want} != want or served.get("refused"):
        raise AssertionError(f"{name}: the signer served {served}, the node signed {want}")
    out["served"] = served
    out["trips"] = sum(float(line.rsplit(" ", 1)[1])
                       for line in node["registry"].expose().splitlines()
                       if line.startswith("cometbft_consensus_trust_guard_trips_total{"))
    if out["trips"]:
        raise AssertionError(f"{name}: {out['trips']} trust guard trips")
    return out


def child_line_text(text: str) -> dict:
    """The last JSON line of a child's stdout."""
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"no JSON line in the child's output {text[-500:]!r}")
    return json.loads(lines[-1])


def cs_stub_run(dev, name: str, registry, nstub: int, heights: int, queue: bool,
                config=None, verifier_factory=None, timeout_s: float = 120.0,
                equivocate_at: int | None = None, remote: str | None = None,
                work: str | None = None, ntx: int = CS_REMOTE_TXS) -> dict:
    """Run (b), commit-N through consensus: one port validator (a
    ``cs_node`` without a switch) and ``nstub`` stub validators at power
    10, driven by the reference's validator-stub pattern
    (tests/test_consensus.py:166-248): when a stub proposes, the loop
    builds the block with the node's executor and signs the proposal with
    the stub's key; on every complete proposal all stubs prevote and
    precommit it (FastSigner).  ``queue``: with the verify queue installed
    (``verifier_factory``, default the card's), else none.  Fails unless
    every commit carries at least 2/3 + 1 of the signatures and
    ``heights`` heights commit within ``timeout_s``.

    ``equivocate_at`` (e1): the node runs with an evidence pool, and at
    that height the first stub also signs a precommit for another block
    id, delivered right after its real one.  The node reports the
    conflict, its pool makes the DuplicateVoteEvidence, a later proposal
    (the stubs' come from the node's executor) carries it and the app is
    told of it; fails unless exactly one block carries it, the app gets
    exactly one MISBEHAVIOR_DUPLICATE_VOTE, and the pool's
    ``committed_total`` reads 1.

    ``remote`` (r): the app and the signer run out of process
    (``start_remote``, transport "socket" or "grpc", files in ``work``):
    the node reaches the app through ``default_client_creator`` and signs
    through a ``SignerClient`` (``TimedSigner``), whose key is chosen to
    propose height 1; it runs the ``IndexerService`` and a ``Pruner``
    (``cs_node(prune_s=CS_PRUNE_S)``) with the trust guard armed, and
    ``ntx`` signed txs go to its mempool before it starts.  The run then
    ends with ``end_remote``'s checks."""
    from dataclasses import replace as dc_replace

    from cometbft_tpu_torch import config as C
    from cometbft_tpu_torch.consensus import BlockPartMessage, ProposalMessage, VoteMessage
    from cometbft_tpu_torch.crypto import verify_queue as VQ
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey, priv_key_from_secret
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.privval.signer import SignerClient
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, PREVOTE_TYPE, BlockID, Vote
    from cometbft_tpu_torch.types.event_bus import (EVENT_COMPLETE_PROPOSAL, EVENT_NEW_ROUND,
                                                    query_for_event)
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES
    from cometbft_tpu_torch.types.vote import Proposal
    from cometbft_tpu_torch.utils import critpath as CP
    from cometbft_tpu_torch.utils import trustguard
    from cometbft_tpu_torch.utils.log import Logger
    from cometbft_tpu_torch.utils.time import now_ns
    from cometbft_tpu_torch.utils.trace import TRACER

    config = config or C.default_config()
    rs = np.random.RandomState(SEED + 2 * nstub + 1)
    signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
    stubs = scalar_keys(int.from_bytes(rs.bytes(32), "little"), nstub)
    chain = f"{CS_CHAIN_ID}-{nstub + 1}"
    rem: dict = {}
    if remote is None:
        pv = FilePV(priv_key_from_secret(b"smoke-consensus-node"))
        node_pub = pv.pub_key
    else:
        # the key's files are written here and read only by the signer
        chain += f"-{remote}"
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        key = first_proposer_key([pub for _, pub in stubs])
        key_files = (os.path.join(work, "pv_key.json"), os.path.join(work, "pv_state.json"))
        FilePV(key, *key_files).save()
        node_pub = key.pub_key()
        sent = cs_txs(ntx, rs)
    gen = GenesisDoc(chain_id=chain, genesis_time_ns=CS_T0, validators=tuple(
        [GenesisValidator(Ed25519PubKey(pub), 10) for _, pub in stubs]
        + [GenesisValidator(node_pub, 10)]))
    threads = live_threads()
    errors = ErrorLines()
    q = None
    if queue:
        q = VQ.VerifyQueue(verifier_factory=verifier_factory)
        q.start()
        VQ.install_queue(q)
    ring = TRACER.capacity
    TRACER.set_capacity(1 << 20)
    node = None
    res: dict = {"name": name, "attribution": []}
    add_vote_s: list = []
    observe = CP.observe_height

    def observed(height, tracer=None, metrics=None):
        d = observe(height, tracer=tracer, metrics=metrics)
        res["attribution"].append((height, d))
        return d

    CP.observe_height = observed
    checker, checked, checker_stop = None, None, threading.Event()
    try:
        if remote is not None:
            start_remote(rem, remote, work, chain, *key_files)
            pv = TimedSigner(SignerClient(rem["endpoint"]))
            trustguard.enable()
        node = cs_node(dev, gen, pv, config, None, Logger(sink=errors, level="error"),
                       switch=False, evidence=equivocate_at is not None,
                       proxy_app=rem.get("addr"), prune_s=None if remote is None else CS_PRUNE_S)
        cs, ex, bus, blocks = node["cs"], node["exec"], node["bus"], node["block_store"]
        if remote is not None:
            trustguard.install_metrics(cs.metrics)
            t = time.perf_counter()
            for tx in sent:
                resp = node["mempool"].check_tx(tx)
                if resp.code != 0:
                    raise AssertionError(f"{name}: CheckTx refused a sent tx: {resp}")
            res.update(remote_start_s=rem["start_s"], admit_s=time.perf_counter() - t,
                       ntx=len(sent))
            checked = dict(checked=[], failed=[], txs={}, last_commits={})
            checker = index_checker(node, checker_stop, checked)
        vals = cs.state.validators
        stub_idx = {}
        for a, pub in stubs:
            addr = Ed25519PubKey(pub).address()
            stub_idx[addr] = (vals.get_by_address(addr)[0], a, pub)
        inner = cs._add_vote

        def timed_add_vote(vote, peer_id):
            t = time.perf_counter()
            try:
                return inner(vote, peer_id)
            finally:
                add_vote_s.append((vote.height, time.perf_counter() - t))

        cs._add_vote = timed_add_vote
        sub_nr = bus.subscribe("stub-driver-nr", query_for_event(EVENT_NEW_ROUND),
                               capacity=1000)
        sub_cp = bus.subscribe("stub-driver-cp", query_for_event(EVENT_COMPLETE_PROPOSAL),
                               capacity=1000)
        TRACER.clear()
        _build.reset_launches()
        spec = "cometbft_crypto_verify_queue_spec_cache"
        hits0 = registry_value(registry, spec, 'result="hit"')
        miss0 = registry_value(registry, spec, 'result="miss"')
        tiers0 = tier_counts(registry)
        busy0 = busy_seconds(registry)
        t_start = time.perf_counter()
        cs.start()
        voted: set = set()
        proposed: set = set()
        deadline = time.perf_counter() + timeout_s
        while cs.state.last_block_height < heights:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{name}: height {blocks.height()} after {timeout_s} s")
            try:
                ev = sub_nr.next(timeout=0.005)
            except TimeoutError:
                ev = None
            if ev is not None:
                rstate = cs.round_state()
                h, r = rstate["height"], rstate["round"]
                proposer = rstate["validators"].get_proposer()
                if proposer.address in stub_idx and rstate["proposal"] is None \
                        and (h, r) not in proposed:
                    proposed.add((h, r))
                    _, a, pub = stub_idx[proposer.address]
                    last_commit = blocks.load_seen_commit(h - 1) if h > 1 else None
                    block = ex.create_proposal_block(h, cs.state, last_commit, proposer.address)
                    parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
                    prop = Proposal(height=h, round=r, pol_round=-1,
                                    block_id=BlockID(block.hash(), parts.header),
                                    timestamp_ns=block.header.time_ns)
                    prop = dc_replace(prop, signature=signer.sign(a, pub, prop.sign_bytes(chain)))
                    cs.send_peer_msg(ProposalMessage(prop), "stub-peer")
                    for i in range(parts.header.total):
                        cs.send_peer_msg(BlockPartMessage(h, r, parts.get_part(i)), "stub-peer")
            try:
                ev = sub_cp.next(timeout=0.005)
            except TimeoutError:
                continue
            rstate = cs.round_state()
            if rstate["proposal"] is None:
                continue
            h, r = rstate["height"], rstate["round"]
            if (h, r) in voted:
                continue
            voted.add((h, r))
            bid = rstate["proposal"].block_id
            ts = max(now_ns(), cs.state.last_block_time_ns + 1)
            votes = [Vote(type=vt, height=h, round=r, block_id=bid, timestamp_ns=ts,
                          validator_address=addr, validator_index=idx)
                     for vt in (PREVOTE_TYPE, PRECOMMIT_TYPE)
                     for addr, (idx, _, _) in stub_idx.items()]
            if h == equivocate_at and r == 0:
                # the first stub's second precommit, for another block id,
                # right after its real one
                fake = bytes(b ^ 0xFF for b in bid.hash)
                first = len(stub_idx)
                votes.insert(first + 1, dc_replace(votes[first], block_id=BlockID(
                    fake, dc_replace(bid.part_set_header, hash=fake[::-1]))))
            keyed = [stub_idx[v.validator_address] for v in votes]
            sigs = signer.sign_all([(a, pub, v.sign_bytes(chain)) for v, (_, a, pub)
                                    in zip(votes, keyed)])
            for v, sig in zip(votes, sigs):
                cs.send_peer_msg(VoteMessage(dc_replace(v, signature=sig)), "stub-peer")
        res["wall"] = time.perf_counter() - t_start
        bus.unsubscribe_all("stub-driver-nr")
        bus.unsubscribe_all("stub-driver-cp")
        events = TRACER.events()
        res["launches"] = launched()
        res["hits"] = registry_value(registry, spec, 'result="hit"') - hits0
        res["misses"] = registry_value(registry, spec, 'result="miss"') - miss0
        res["tiers"] = delta(tier_counts(registry), tiers0)
        res["busy"] = busy_seconds(registry) - busy0
        res["stats"] = q.stats() if q is not None else None
        if remote is not None:
            checker_stop.set()
            checker.join(15)
            res["abci"] = {k[5:]: (pct(d, 50), max(d), len(d)) for k, d in spans_by_name(
                events, "abci/").items()}
            res["sign"] = {k: (pct(d, 50), max(d), len(d)) for k, d in (
                ("sign_vote", pv.votes), ("sign_proposal", pv.proposals)) if d}
            res["remote"] = end_remote(name, node, rem, pv, checked, sent, errors, dev)
        cs.stop()
        if equivocate_at is not None:
            res["evidence"] = cs_check_evidence(name, node, equivocate_at)
        need = (2 * (nstub + 1)) // 3 + 1
        pipe = {e["args"]["height"]: e["dur"] / 1e6 for e in events
                if e["name"] == "height/pipeline"}
        apply = {e["args"]["height"]: e["dur"] / 1e6 for e in events
                 if e["name"] == "exec/apply_block"}
        vc = {e["args"]["height"] + 1: e["dur"] / 1e6 for e in events
              if e["name"] == "verify_commit" and e["args"].get("parent") == "exec/apply_block"}
        per: list = []
        for h in range(1, heights + 1):
            if checked is not None and h in checked["last_commits"]:
                present, rnd = checked["last_commits"][h]
            else:
                commit = blocks.load_seen_commit(h)
                present, rnd = sum(1 for s in commit.signatures if not s.is_absent()), commit.round
            if present < need:
                raise AssertionError(f"{name}: the commit of height {h} carries {present} "
                                     f"signatures, fewer than {need}")
            adds = [d for hh, d in add_vote_s if hh == h]
            per.append(dict(height=h, sigs=present, round=rnd, wall=pipe.get(h),
                            add_vote_p50=pct(adds, 50) if adds else None, adds=len(adds),
                            apply=apply.get(h), verify_commit=vc.get(h)))
    finally:
        CP.observe_height = observe
        checker_stop.set()
        if checker is not None:
            checker.join(15)
        if node is not None:
            cs_close(node)
        stop_remote(rem)
        if remote is not None:
            trustguard.reset(enable=False)
            trustguard.install_metrics(None)
            shutil.rmtree(work, ignore_errors=True)
        if q is not None:
            q.stop()
        TRACER.set_capacity(ring)
    end_phase(name, threads)
    if errors.lines:
        raise AssertionError(f"{name}: consensus errors logged: {errors.lines[:5]}")
    res["per_height"] = per
    res["steps"] = cs_steps(events)
    return res


def wal_side(dev) -> dict:
    """What ``cs_wal_chain`` drives: the port's modules, and ``node``, a
    ``cs_node`` without a switch over a file WAL with the determinism
    guard on (a caller may hand ``cs_wal_chain`` another package's, as
    tests/test_torch_wal.py does with the reference's)."""
    from types import SimpleNamespace

    from cometbft_tpu_torch import consensus, privval, wal
    from cometbft_tpu_torch.consensus import state as csm
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.state import determinism
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, PREVOTE_TYPE, BlockID, Vote
    from cometbft_tpu_torch.types import event_bus, genesis, part_set
    from cometbft_tpu_torch.types.vote import Proposal
    from cometbft_tpu_torch.utils import log

    m = SimpleNamespace(
        Vote=Vote, Proposal=Proposal, BlockID=BlockID, PREVOTE_TYPE=PREVOTE_TYPE,
        PRECOMMIT_TYPE=PRECOMMIT_TYPE, VoteMessage=consensus.VoteMessage,
        ProposalMessage=consensus.ProposalMessage, BlockPartMessage=consensus.BlockPartMessage,
        EVENT_NEW_ROUND=event_bus.EVENT_NEW_ROUND,
        EVENT_COMPLETE_PROPOSAL=event_bus.EVENT_COMPLETE_PROPOSAL,
        query_for_event=event_bus.query_for_event,
        BLOCK_PART_SIZE_BYTES=part_set.BLOCK_PART_SIZE_BYTES, Ed25519PubKey=ed25519.Ed25519PubKey,
        priv_key_from_secret=ed25519.priv_key_from_secret, FilePV=privval.FilePV, WAL=wal.WAL,
        KIND_MSG_INFO=wal.KIND_MSG_INFO, csm=csm, verify_wal_digests=determinism.verify_wal_digests,
        GenesisDoc=genesis.GenesisDoc, GenesisValidator=genesis.GenesisValidator,
        Handshaker=consensus.Handshaker, ConsensusState=consensus.ConsensusState,
        Logger=log.Logger, NopLogger=log.NopLogger)

    def node(gen, pv, config, logger, w):
        return cs_node(dev, gen, pv, config, None, logger, switch=False, wal=w,
                       determinism=True)

    return dict(m=m, node=node, close=cs_close,
                kw=dict(device=dev), hs_kw=dict(device=dev, determinism=True))


def cs_wal_chain(dev, name: str, nstub: int, heights: int, workdir: str,
                 crash_at: int | None, config=None, timeout_s: float = 120.0,
                 side: dict | None = None) -> dict:
    """One run of (w): one validator with a file WAL and the determinism
    guard on (``side``'s ``node``, default the port's: ``wal_side``; its
    FilePV in files) and ``nstub`` stubs at power 10.  The stubs' votes
    make the chain a function of the seed alone: the consensus state
    reads a frozen clock (every vote's time is then the last block time +
    1 ns), and only the first ``need - 1`` stubs vote (``need`` = 2/3 of
    the power + 1), so each commit holds exactly those and the node's own
    precommit.  With ``crash_at``, the node's receive thread is ended
    right after the WAL has its own precommit of that height (its
    prevote, and the stubs' votes it processed, before it), and a new
    ConsensusState over the same WAL (reopened), stores, FilePV (reloaded
    from its files) and app replays the WAL and commits on; the stubs
    send that height's votes again.  -> the block ids and app hashes of
    heights 1..``heights``, the replay's counts, and the WAL's digest
    records checked against the stores."""
    from dataclasses import replace as dc_replace

    from cometbft_tpu_torch import config as C

    from cometbft_tpu_torch.ops import _build

    side = side or wal_side(dev)
    m = side["m"]
    config = config or C.default_config()
    rs = np.random.RandomState(SEED + 7 * nstub + 3)
    signer = FastSigner(int.from_bytes(rs.bytes(32), "little"))
    stubs = scalar_keys(int.from_bytes(rs.bytes(32), "little"), nstub)
    os.makedirs(workdir, exist_ok=True)
    key_path, state_path = os.path.join(workdir, "pv_key.json"), os.path.join(workdir,
                                                                               "pv_state.json")
    pv = m.FilePV(m.priv_key_from_secret(b"smoke-wal-node"), key_path, state_path)
    pv.save()
    chain = f"{CS_CHAIN_ID}-wal-{nstub + 1}"
    gen = m.GenesisDoc(chain_id=chain, genesis_time_ns=CS_T0, validators=tuple(
        [m.GenesisValidator(m.Ed25519PubKey(pub), 10) for _, pub in stubs]
        + [m.GenesisValidator(pv.pub_key, 10)]))
    need = (2 * (nstub + 1)) // 3 + 1
    wal_path = os.path.join(workdir, "wal", "wal")
    errors = ErrorLines()
    logger = m.Logger(sink=errors, level="error")
    real_now = m.csm.now_ns
    m.csm.now_ns = lambda: CS_T0
    node, wal = None, None
    res: dict = {"name": name}
    crashed = threading.Event()
    try:
        wal = m.WAL(wal_path)
        wal.start()
        node = side["node"](gen, pv, config, logger, wal)
        cs, ex, bus, blocks = node["cs"], node["exec"], node["bus"], node["block_store"]
        vals = cs.state.validators
        stub_idx = {}
        for a, pub in stubs:
            addr = m.Ed25519PubKey(pub).address()
            stub_idx[addr] = (vals.get_by_address(addr)[0], a, pub)
        voters = dict(sorted(stub_idx.items(), key=lambda kv: kv[1][0])[:need - 1])

        def arm(w):
            real = w.write_sync

            def write_sync(kind, data):
                real(kind, data)
                if crash_at is None or crashed.is_set() or kind != m.KIND_MSG_INFO:
                    return
                mi = m.csm.decode_msg_info(data)
                v = getattr(mi.msg, "vote", None)
                if (mi.peer_id == "" and v is not None and v.type == m.PRECOMMIT_TYPE
                        and v.height == crash_at):
                    res["own_precommit"] = v.signature
                    crashed.set()
                    # ends the receive thread as a kill would: its
                    # catch-all lets SystemExit out, and threading drops it
                    raise SystemExit("crash after the WAL write")

            w.write_sync = write_sync

        arm(wal)
        sub_nr = bus.subscribe("wal-driver-nr", m.query_for_event(m.EVENT_NEW_ROUND),
                               capacity=1000)
        sub_cp = bus.subscribe("wal-driver-cp", m.query_for_event(m.EVENT_COMPLETE_PROPOSAL),
                               capacity=1000)
        signed: dict = {}
        proposed: set = set()
        _build.reset_launches()
        t_start = time.perf_counter()
        cs.start()
        deadline = time.perf_counter() + timeout_s
        while cs.state.last_block_height < heights:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{name}: height {blocks.height()} after {timeout_s} s")
            if crashed.is_set() and "restart_s" not in res:
                # the receive thread is gone; what it left is on disk
                t0 = time.perf_counter()
                cs.stop()              # the ticker; the WAL is closed with it
                pv = m.FilePV.load(key_path, state_path)
                wal = m.WAL(wal_path)
                wal.start()
                arm(wal)
                state = m.Handshaker(node["state_store"], node["state_store"].load(), blocks,
                                     gen, logger=m.NopLogger(), **side["hs_kw"]).handshake(
                                         node["conns"])
                old = cs
                cs = m.ConsensusState(config.consensus, state, ex, blocks, priv_validator=pv,
                                      event_bus=bus, wal=wal, logger=logger, **side["kw"])
                node["cs"] = cs
                node["services"] = [cs if svc is old else svc for svc in node["services"]]
                cs.start()
                res["restart_s"] = time.perf_counter() - t0
                res["replayed_records"] = cs.replayed_records
                res["replayed_digests"] = cs.replayed_digests
                # the replay may commit the height itself (the precommits
                # it needs all in the WAL): no digest record is written
                # in replay, as in the reference
                res["committed_in_replay"] = cs.state.last_block_height >= crash_at
                for hr, msgs in signed.items():
                    if hr[0] == crash_at:
                        for msg in msgs:
                            cs.send_peer_msg(msg, "stub-peer")
            try:
                ev = sub_nr.next(timeout=0.005)
            except TimeoutError:
                ev = None
            if ev is not None:
                rstate = cs.round_state()
                h, r = rstate["height"], rstate["round"]
                proposer = rstate["validators"].get_proposer()
                if proposer.address in stub_idx and rstate["proposal"] is None \
                        and (h, r) not in proposed:
                    proposed.add((h, r))
                    _, a, pub = stub_idx[proposer.address]
                    last_commit = blocks.load_seen_commit(h - 1) if h > 1 else None
                    block = ex.create_proposal_block(h, cs.state, last_commit, proposer.address)
                    parts = block.make_part_set(m.BLOCK_PART_SIZE_BYTES)
                    prop = m.Proposal(height=h, round=r, pol_round=-1,
                                      block_id=m.BlockID(block.hash(), parts.header),
                                      timestamp_ns=block.header.time_ns)
                    prop = dc_replace(prop, signature=signer.sign(a, pub, prop.sign_bytes(chain)))
                    cs.send_peer_msg(m.ProposalMessage(prop), "stub-peer")
                    for i in range(parts.header.total):
                        cs.send_peer_msg(m.BlockPartMessage(h, r, parts.get_part(i)),
                                         "stub-peer")
            try:
                ev = sub_cp.next(timeout=0.005)
            except TimeoutError:
                continue
            rstate = cs.round_state()
            if rstate["proposal"] is None:
                continue
            h, r = rstate["height"], rstate["round"]
            if (h, r) in signed:
                continue
            bid = rstate["proposal"].block_id
            ts = cs.state.last_block_time_ns + 1
            votes = [m.Vote(type=vt, height=h, round=r, block_id=bid, timestamp_ns=ts,
                            validator_address=addr, validator_index=idx)
                     for vt in (m.PREVOTE_TYPE, m.PRECOMMIT_TYPE)
                     for addr, (idx, _, _) in voters.items()]
            sigs = signer.sign_all([(voters[v.validator_address][1],
                                     voters[v.validator_address][2], v.sign_bytes(chain))
                                    for v in votes])
            signed[(h, r)] = [m.VoteMessage(dc_replace(v, signature=sig))
                              for v, sig in zip(votes, sigs)]
            for msg in signed[(h, r)]:
                cs.send_peer_msg(msg, "stub-peer")
        res["wall"] = time.perf_counter() - t_start
        res["launches"] = launched()
        bus.unsubscribe_all("wal-driver-nr")
        bus.unsubscribe_all("wal-driver-cp")
        cs.stop()
        states = node["state_store"]
        res["chain"] = [(blocks.load_block_meta(h).block_id.hash,
                         states.load_finalize_block_response(h).app_hash)
                        for h in range(1, heights + 1)]
        res["rounds"] = [blocks.load_seen_commit(h).round for h in range(1, heights + 1)]
        check = m.WAL(wal_path)
        try:
            res["digests_verified"] = m.verify_wal_digests(check, blocks, states)
        finally:
            check._group.close()
        if crash_at is not None:
            if "restart_s" not in res:
                raise AssertionError(f"{name}: the node never reached its precommit of "
                                     f"height {crash_at}")
            commit = blocks.load_seen_commit(crash_at)
            own = [cs_ for cs_ in commit.signatures
                   if cs_.validator_address == pv.address and not cs_.is_absent()]
            if not own or own[0].signature != res["own_precommit"]:
                raise AssertionError(f"{name}: the commit of height {crash_at} does not hold "
                                     "the precommit the node signed before the crash")
    finally:
        m.csm.now_ns = real_now
        if node is not None:
            side["close"](node)
        if wal is not None and wal.is_running():
            wal.stop()
    # replay re-enters the height's steps, and the FilePV refuses to sign
    # below the step it signed before the crash: the guard at work
    refused = [ln for ln in errors.lines if "failed signing vote" in ln
               and "step regression" in ln]
    res["refusals"] = len(refused)
    others = [ln for ln in errors.lines if ln not in refused]
    if others or (refused and crash_at is None):
        raise AssertionError(f"{name}: consensus errors logged: {errors.lines[:5]}")
    return res


def cs_wal_run(dev, name: str, nstub: int, heights: int, crash_at: int, workdir: str,
               config=None, timeout_s: float = 120.0) -> dict:
    """(w) crash and WAL replay: the chain of an uninterrupted run, then
    the same run with the node stopped in the middle of height
    ``crash_at`` and restarted through its WAL (``cs_wal_chain``).  Fails
    unless the block ids and app hashes of every height are equal, the
    restart replayed records and at least one transition digest, each
    height's digest record (but that of a height the replay itself
    committed, which writes none) checks against the stores, and no
    error was logged but the FilePV's refusals to sign below the step it
    reached before the crash."""
    threads = live_threads()
    try:
        plain = cs_wal_chain(dev, name + " (uninterrupted)", nstub, heights,
                             os.path.join(workdir, "plain"), None, config, timeout_s)
        crash = cs_wal_chain(dev, name, nstub, heights, os.path.join(workdir, "crash"),
                             crash_at, config, timeout_s)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    end_phase(name, threads)
    if crash["chain"] != plain["chain"]:
        diff = [h + 1 for h, (a, b) in enumerate(zip(crash["chain"], plain["chain"])) if a != b]
        raise AssertionError(f"{name}: the restarted chain differs from the uninterrupted one "
                             f"at heights {diff} (rounds {crash['rounds']} / {plain['rounds']})")
    if crash["replayed_records"] < 2 or crash["replayed_digests"] < 1 \
            or crash["digests_verified"] != heights - crash["committed_in_replay"] \
            or plain["digests_verified"] != heights:
        raise AssertionError(f"{name}: replayed {crash['replayed_records']} records, "
                             f"{crash['replayed_digests']} digests; WAL digests verified "
                             f"{crash['digests_verified']} / {plain['digests_verified']} of "
                             f"{heights}")
    return dict(plain=plain, crash=crash, heights=heights, crash_at=crash_at)


def cs_check_evidence(name: str, node: dict, height: int) -> dict:
    """(e1)'s checks on a node after its run: the equivocation at
    ``height`` committed once, told to the app once, counted once."""
    from cometbft_tpu_torch.abci.types import MISBEHAVIOR_DUPLICATE_VOTE
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

    blocks = node["block_store"]
    carried = [(h, ev) for h in range(1, blocks.height() + 1)
               for ev in blocks.load_block(h).evidence]
    committed = plain_value(node["registry"], "cometbft_evidence_committed_total")
    types = [t for _, t in node["misbehavior"]]
    if (len(carried) != 1 or not isinstance(carried[0][1], DuplicateVoteEvidence)
            or carried[0][1].height != height or types != [MISBEHAVIOR_DUPLICATE_VOTE]
            or committed != 1):
        raise AssertionError(f"{name}: evidence of the equivocation at height {height}: "
                             f"blocks carry {[(h, type(e).__name__) for h, e in carried]}, "
                             f"the app was told {node['misbehavior']}, committed_total "
                             f"{committed}")
    ev = carried[0][1]
    if not node["pool"]._is_committed(ev) or node["pool"].size() != 0:
        raise AssertionError(f"{name}: the pool did not mark the evidence committed")
    return dict(height=height, block=carried[0][0], misbehavior=list(node["misbehavior"]),
                committed_total=committed, validator=ev.vote_a.validator_address.hex()[:12])


def consensus_phase(dev, smi: str, registry, stub_heights: int = CS_STUB_HEIGHTS,
                    nstub: int = CS_STUBS) -> dict:
    """Phase 17: consensus.  Run (a) localnet4 (``cs_localnet``), then
    commit150-consensus (``cs_stub_run``) twice: (b1) with the verify queue
    installed -- every vote's verdict lands in the speculative cache, so
    the LastCommit checks of validate_block and apply_block hit it and
    launch nothing -- and (b2) with none, where each vote is verified
    inline on the host and every LastCommit check is a cold keyed verify
    (``build_tables`` once for the new set, then ``sha512_keyed`` and
    ``verify_keyed``).  Each run goes to height ``stub_heights`` + 1, so
    ``stub_heights`` commits of ``nstub`` + 1 validators are verified
    through consensus.  Fails on a run's own checks, on (b2) without a
    keyed launch at every height from 2 on, on a generic or host
    verify_commit in (b2), on a spec-cache miss in (b1)'s LastCommit
    checks, or on a thread left behind.  (b2) carries (e1): its first stub
    equivocates at ``CS_EQUIVOCATE_AT`` and the evidence must be
    committed (``cs_stub_run``).  Then (w), crash and WAL replay
    (``cs_wal_run``): the same validators with a file WAL and the
    determinism guard, a 100 ms commit timeout, ``CS_WAL_HEIGHTS`` heights,
    the node stopped in height ``CS_WAL_CRASH_AT``.  Last, (r): the app
    and the signer out of process (``remote_runs``)."""
    from dataclasses import replace

    from cometbft_tpu_torch import config as C
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.ops import precompute as PR

    t0 = time.perf_counter()
    a = cs_localnet(dev, smi, registry)
    res = {"a": a}
    print(f"consensus localnet4 [{smi}]: {CS_NODES} port validators over 127.0.0.1 TCP, "
          f"{len(a['block_txs'])} heights in {a['wall']:.3f} s "
          f"({a['heights'] / a['wall']:.3f} heights/s), {sum(a['block_txs'])} signed txs "
          f"committed once each (txs a block {a['block_txs']}), stores and app hashes equal; "
          f"the txs made in {a['data_s']:.3f} s, admitted by node 0 in {a['admit_s']:.3f} s "
          f"from {CS_CLIENTS} threads; links dialed again {a['redialed']}")
    print(f"  rounds above 0: {sum(1 for r in a['rounds'] if r > 0)} of {len(a['rounds'])} "
          f"heights (commit rounds {a['rounds']})")
    print("  step s p50 / max (count), tracer spans of the four nodes: " + "; ".join(
        f"{k} {p:.3f} / {m:.3f} ({n})" for k, (p, m, n) in a["steps"].items()))
    for lane, sizes in sorted(a["ingest"].items()):
        print(f"  queue lane {lane}: {len(sizes)} launches, coalesced sizes p50 "
              f"{pct(sizes, 50):.0f}, max {max(sizes)}, sum {sum(sizes)}")
    print("  the app's calls on the four nodes (count, s): " + "; ".join(
        f"{k} {n}, {t:.3f}" for k, (n, t) in sorted(a["abci"].items())))
    for i, m in enumerate(a["mempool"]):
        print(f"  node {i} CheckTx: " + ", ".join(f"{k} {v:.0f}" for k, v in m.items()))
    print(f"  tiers (crypto_dispatch_tier) {a['tiers']}; launches {a['launches']}")

    saved_attr = M.attribution_metrics()
    M.install_attribution_metrics(M.AttributionMetrics(registry))
    runs = {}
    for key, queue in (("b1", True), ("b2", False)):
        name = f"commit{nstub + 1}-consensus ({key}: {'queue' if queue else 'no queue'})"
        keys0 = PR.table_cache(dev).stats["keys_built"]
        r = cs_stub_run(dev, name, registry, nstub, stub_heights + 1, queue,
                        equivocate_at=None if queue else CS_EQUIVOCATE_AT)
        r["keys_built"] = PR.table_cache(dev).stats["keys_built"] - keys0
        runs[key] = r
        print(f"{name} [{smi}]: {stub_heights + 1} heights in {r['wall']:.3f} s, launches "
              f"{r['launches']}, keys built {r['keys_built']}, spec cache {r['hits']:.0f} hits "
              f"/ {r['misses']:.0f} misses, tiers {r['tiers']}, busy share "
              f"{r['busy'] / r['wall']:.4f} ({r['busy']:.4f} s)")
        for row in r["per_height"]:
            print(f"  height {row['height']}: {row['sigs']} signatures (round {row['round']}), "
                  f"wall {fmt_s(row['wall'])} s, add_vote p50 "
                  f"{fmt_s(row['add_vote_p50'], 1e3)} ms ({row['adds']} votes), apply_block "
                  f"{fmt_s(row['apply'], 1e3)} ms, its verify_commit "
                  f"{fmt_s(row['verify_commit'], 1e3)} ms")
        if r["stats"] is not None:
            print(f"  queue stats {r['stats']}")
        if "evidence" in r:
            e = r["evidence"]
            print(f"  (e1) equivocation at height {e['height']} (validator {e['validator']}): "
                  f"DuplicateVoteEvidence committed in block {e['block']}, the app told "
                  f"{e['misbehavior']} ((height, type); type 1 = duplicate vote), "
                  f"evidence_committed_total {e['committed_total']:.0f}")
    M.install_attribution_metrics(saved_attr)
    b1, b2 = runs["b1"], runs["b2"]
    res["critpath"] = check_critpath(f"commit{nstub + 1}-consensus (b2)", b2["attribution"],
                                     stub_heights + 1, registry)
    keyed = min(b2["launches"].get("sha512_keyed", 0), b2["launches"].get("verify_keyed", 0))
    if keyed < stub_heights or b2["launches"].get("build_tables", 0) < 1:
        raise AssertionError(f"commit-consensus (b2): launches {b2['launches']}, wanted "
                             f"sha512_keyed and verify_keyed at least once a height "
                             f"({stub_heights}) and build_tables")
    if b2["tiers"].get("generic") or b2["tiers"].get("host") or b2["launches"].get(
            "verify_generic"):
        raise AssertionError(f"commit-consensus (b2): a commit off the keyed tier: "
                             f"{b2['tiers']}, {b2['launches']}")
    if b1["launches"].get("verify_keyed") or b1["hits"] < stub_heights * (nstub + 1) * 2 // 3:
        raise AssertionError(f"commit-consensus (b1): launches {b1['launches']}, cache hits "
                             f"{b1['hits']}: the LastCommit checks did not hit the cache")
    wal_cfg = C.default_config()
    wal_cfg.consensus = replace(wal_cfg.consensus, timeout_commit_ns=CS_WAL_COMMIT_NS)
    wname = f"commit{nstub + 1}-consensus (w)"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    w = cs_wal_run(dev, wname, nstub, CS_WAL_HEIGHTS, CS_WAL_CRASH_AT,
                   os.path.join(root, "consensus_wal"), config=wal_cfg)
    plain, crash = w["plain"], w["crash"]
    print(f"{wname} [{smi}]: file WAL, determinism guard on, {CS_WAL_HEIGHTS} heights twice: "
          f"uninterrupted {plain['wall']:.3f} s; stopped in height {CS_WAL_CRASH_AT} after its "
          f"own precommit was written, restarted in {crash['restart_s']:.3f} s (replayed "
          f"{crash['replayed_records']} records, {crash['replayed_digests']} digest(s) "
          f"matched, the height committed in the replay: {crash['committed_in_replay']}; "
          f"FilePV refusals {crash['refusals']}), {crash['wall']:.3f} s; block ids and app "
          f"hashes equal at every height; WAL digests checked {plain['digests_verified']} / "
          f"{crash['digests_verified']}; launches {plain['launches']} / {crash['launches']}")
    res.update(b1=b1, b2=b2, w=w)
    res.update(remote_runs(dev, smi, registry, nstub, stub_heights, b2,
                           os.path.join(root, "cs_remote")))
    res["seconds"] = time.perf_counter() - t0
    print(f"consensus phase: {res['seconds']:.1f} s")
    return res


def remote_runs(dev, smi: str, registry, nstub: int, stub_heights: int, b2: dict,
                work: str) -> dict:
    """(r), commit150-remote: (b2)'s configuration with the app and the
    signer in processes of their own (``cs_stub_run(remote=...)``), over
    the ABCI socket protocol for ``stub_heights`` + 1 heights, then over
    gRPC for CS_GRPC_HEIGHTS.  Prints each run beside (b2)'s heights and
    fails on a run's own checks, on a height from 2 on without its keyed
    verify (``sha512_keyed`` and ``verify_keyed``), on a generic or host
    verify, or on the socket run without a ``build_tables`` launch (its
    node key is new to the table cache).  -> {"r": ..., "r_grpc": ...}."""
    from cometbft_tpu_torch.abci import grpc as G
    from cometbft_tpu_torch.ops import precompute as PR

    print(f"(r): grpc {G.grpc.__version__} on this machine")
    out = {}
    for key, transport, heights in (("r", "socket", stub_heights + 1),
                                    ("r_grpc", "grpc", CS_GRPC_HEIGHTS)):
        name = f"commit{nstub + 1}-remote ({key}: {transport})"
        keys0 = PR.table_cache(dev).stats["keys_built"]
        r = cs_stub_run(dev, name, registry, nstub, heights, False, remote=transport,
                        work=work)
        r["keys_built"] = PR.table_cache(dev).stats["keys_built"] - keys0
        out[key] = r
        e = r["remote"]
        print(f"{name} [{smi}]: the app ({transport}) and the signer in processes of their own "
              f"(started in {r['remote_start_s']:.3f} s), {r['ntx']} signed txs admitted in "
              f"{r['admit_s']:.3f} s; {heights} heights in {r['wall']:.3f} s, launches "
              f"{r['launches']}, keys built {r['keys_built']}, tiers {r['tiers']}, busy share "
              f"{r['busy'] / r['wall']:.4f} ({r['busy']:.4f} s)")
        by_h = {row["height"]: row for row in b2["per_height"]}
        for row in r["per_height"]:
            o = by_h.get(row["height"], {})
            print(f"  height {row['height']}: {row['sigs']} signatures (round {row['round']}), "
                  f"wall {fmt_s(row['wall'])} s (b2: {fmt_s(o.get('wall'))}), add_vote p50 "
                  f"{fmt_s(row['add_vote_p50'], 1e3)} ms (b2: {fmt_s(o.get('add_vote_p50'), 1e3)}),"
                  f" apply_block {fmt_s(row['apply'], 1e3)} ms, its verify_commit "
                  f"{fmt_s(row['verify_commit'], 1e3)} ms")
        print("  ABCI round trips ms p50 / max (count): " + "; ".join(
            f"{k} {p * 1e3:.3f} / {m * 1e3:.3f} ({n})" for k, (p, m, n) in sorted(
                r["abci"].items())))
        print("  through the signer ms p50 / max (count): " + "; ".join(
            f"{k} {p * 1e3:.3f} / {m * 1e3:.3f} ({n})" for k, (p, m, n) in r["sign"].items())
              + f"; the signer served {e['served']}")
        pr = e["pruned"]
        print(f"  index and pruner: every tx committed once and found by hash and by "
              f"tx.height; retain height {pr['retain']}, block store base {pr['base']} of "
              f"{pr['top']}, {pr['pruned_blocks']:.0f} blocks pruned, {pr['txs_unindexed']} "
              f"txs' index rows pruned, nothing left below it; the top commit verifies")
        print(f"  the app killed: on_error after {e['on_error_s']:.3f} s ({e['app_error'][:80]}; "
              f"the CheckTx sent after the kill: {e['probe']}), consensus stopped, "
              f"{e['errors_after_kill']} consensus errors logged after it; the app's "
              f"{e['calls']} recorded calls pass check_grammar; trust guard trips "
              f"{e['trips']:.0f}")
        keyed = min(r["launches"].get("sha512_keyed", 0), r["launches"].get("verify_keyed", 0))
        if keyed < heights - 1 or (key == "r" and r["launches"].get("build_tables", 0) < 1):
            raise AssertionError(f"{name}: launches {r['launches']}, wanted sha512_keyed and "
                                 f"verify_keyed at every height from 2 on and build_tables")
        if r["tiers"].get("generic") or r["tiers"].get("host") or r["launches"].get(
                "verify_generic"):
            raise AssertionError(f"{name}: a commit off the keyed tier: {r['tiers']}, "
                                 f"{r['launches']}")
    return out


def check_critpath(name: str, observed: list, heights: int, registry) -> dict:
    """The attribution plane over a run's committed heights
    (``observe_height`` at each ``_finalize_commit``): fails unless every
    height 1..``heights`` was decomposed and its stages sum to its wall
    within 1e-5 s.  Prints each stage's p50 (ms), each height's critical
    stage, and the stage dominant over the heights (the largest summed
    seconds).  -> {"p50_ms": {stage: ms}, "dominant": stage, "per_height":
    [(height, wall s, critical stage)]}."""
    from cometbft_tpu_torch.utils import critpath as CP

    got = {h: d for h, d in observed if d is not None}
    missing = [h for h in range(1, heights + 1) if h not in got]
    off = [(h, d["wall_s"], sum(d["stages"].values())) for h, d in got.items()
           if abs(sum(d["stages"].values()) - d["wall_s"]) > 1e-5]
    if missing or off:
        raise AssertionError(f"{name}: critpath: heights not decomposed {missing}; stages "
                             f"not summing to the wall (height, wall, sum) {off}")
    ds = [got[h] for h in sorted(got)]
    p50 = {st: 1e3 * pct([d["stages"][st] for d in ds], 50) for st in CP.STAGES}
    total = {st: sum(d["stages"][st] for d in ds) for st in CP.STAGES}
    dominant = CP.dominant_stage(total)
    gauge = [line for line in registry.expose().splitlines()
             if line.startswith("cometbft_attribution_height_critical_stage{")
             and line.endswith(" 1")]
    print(f"  critpath ({name}): {len(ds)} heights decomposed, stages sum to the wall within "
          f"1e-5 s at each (max |sum - wall| "
          f"{max(abs(sum(d['stages'].values()) - d['wall_s']) for d in ds):.2e} s); stage p50 "
          f"ms: " + ", ".join(f"{st} {v:.3f}" for st, v in p50.items())
          + f"; dominant over the heights: {dominant}; per height "
          + ", ".join(f"{d['height']} {d['critical_stage']}" for d in ds)
          + f"; the gauge's last one-hot {gauge}")
    return {"p50_ms": p50, "dominant": dominant,
            "per_height": [(d["height"], d["wall_s"], d["critical_stage"]) for d in ds]}


def consensus_launches(cons: dict, kname: str) -> int:
    """A kernel's launches over consensus_phase's runs (a), (b1), (b2),
    (r), (r) over gRPC and (w)'s two."""
    return sum(cons[k]["launches"].get(kname, 0)
               for k in ("a", "b1", "b2", "r", "r_grpc")) + sum(
        cons["w"][k]["launches"].get(kname, 0) for k in ("plain", "crash"))


def fmt_s(x, scale: float = 1.0) -> str:
    return "n/a" if x is None else f"{x * scale:.3f}"


def main() -> int:
    if sys.argv[1:2] == ["--warm150"]:
        if len(sys.argv) > 2:
            sys.path.insert(0, os.path.abspath(sys.argv[2]))
        return warm150()
    only = None
    if sys.argv[1:2] == ["--only"]:
        only = sys.argv[2].split(",") if len(sys.argv) > 2 else []
        unknown = [p for p in only if p not in ONLY_PHASES]
        if not only or unknown:
            print(f"chip_smoke: --only takes a comma-separated list of {', '.join(ONLY_PHASES)}"
                  f" (got {sys.argv[2:3]})", file=sys.stderr)
            return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from cometbft_tpu_torch.crypto import health as H

    try:
        return run_all(torch) if only is None else run_only(torch, only)
    finally:
        H.WATCHDOG.stop()


#: the phases ``--only`` runs, in the order ``run_all`` runs them
ONLY_PHASES = ("light", "blocksync", "consensus")


def setup(torch) -> tuple:
    """The set-up every run shares: the device's line, the build of every
    kernel, the crypto and health metrics on a fresh registry, and the
    dispatch threshold (phase 1).  -> (dev, name, count, smi, built,
    registry, threshold)."""
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.utils.metrics import Registry

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
    registry = Registry()
    M.install_crypto_metrics(M.CryptoMetrics(registry))
    M.install_health_metrics(M.HealthMetrics(registry))
    threshold = threshold_phase(dev)
    return dev, name, count, smi, built, registry, threshold


def run_only(torch, phases: list) -> int:
    """``--only light,blocksync,consensus``: the shared set-up and the
    comb of B, then the named phases alone, as ``run_all`` runs them,
    each followed by its ladder check; prints no kernels line and no
    result line."""
    from cometbft_tpu_torch.ops import precompute as PR

    t_start = time.perf_counter()
    dev, _, _, smi, _, registry, _ = setup(torch)
    PR.b_comb8()
    runs = {
        "light": ("light sync phase", lambda: light_sync_phase(dev, smi)),
        "blocksync": ("blocksync phase", lambda: blocksync_phase(dev, smi, registry)),
        "consensus": ("consensus phase", lambda: consensus_phase(dev, smi, registry)),
    }
    for p in phases:
        what, run = runs[p]
        run()
        check_ladder(what)
    print(f"chip_smoke --only {','.join(phases)}: {time.perf_counter() - t_start:.1f} s")
    return 0


def run_all(torch) -> int:
    from cometbft_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev, name, count, smi, built, registry, threshold = setup(torch)
    from cometbft_tpu_torch.ops import ed25519_verify as EV
    from cometbft_tpu_torch.ops import precompute as PR

    vk_lib = _build.library("verify_keyed")
    for g in EV.GROUPS:
        print(f"  verify_keyed G={g}: {vk_lib.verify_keyed_smem_bytes(g)} bytes of dynamic "
              f"shared memory per 32-thread block ({32 // g} lanes)")
    vg_lib = _build.library("verify_generic")
    for q, g in EV.VG_SHAPES:
        threads = max(32, q * g)
        print(f"  verify_generic (Q, G) = ({q}, {g}): {vg_lib.verify_generic_smem_bytes(q, g)} "
              f"bytes of dynamic shared memory per {threads}-thread block "
              f"({threads // (q * g)} lanes)")
    bt_lib = _build.library("build_tables")
    for q, g in PR.BUILD_SHAPES:
        threads = max(32, q * g)
        print(f"  build_tables (Q, G) = ({q}, {g}): {bt_lib.build_tables_smem_bytes(1, q, g)} / "
              f"{bt_lib.build_tables_smem_bytes(2, q, g)} bytes of dynamic shared memory per "
              f"{threads}-thread block for the bases / the entries ({threads // (q * g)} lanes)")
    spills = []
    for b in built.values():
        print(f"  {b.name}: nvcc {b.seconds:.2f} s -> {b.path}")
        entry = None
        for line in b.ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {line.strip()}")
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{entry}: {line.strip()}")
    print("ptxas spills: " + ("none" if not spills else "; ".join(spills)))

    print("kernels vs plain versions: tolerance exact (max |kernel - plain| must be 0; "
          "the arithmetic is integer)")
    kres = check_kernels(dev)
    commit150, exp150 = make_commit(150, b"validator", plant=True)
    commit1k, exp1k = make_commit(1024, b"validator1k", plant=True)
    keys150 = sorted({p for p, _, _ in commit150})
    keys1k = sorted({p for p, _, _ in commit1k})
    bres = check_build(dev, [("commit150", keys150, 8), ("one key, 8-bit", keys150[:1], 8),
                             ("commit1024", keys1k, 4), ("one key, 4-bit", keys1k[:1], 4)])

    t0 = time.perf_counter()
    PR.b_comb8()
    b8_s = time.perf_counter() - t0
    main150 = drive("commit150", commit150, exp150, dev, warm_runs=100, window_bits=8,
                    builds=True, b8_s=b8_s)
    check_ladder("commit150")
    profile_warm("commit150", commit150, dev)
    vk150 = check_fused("commit150", main150["plan"], exp150, dev)

    main1k = drive("commit1024", commit1k, exp1k, dev, warm_runs=20, window_bits=4,
                   builds=True)
    check_ladder("commit1024")
    check_fused("commit1024", main1k["plan"], exp1k, dev)

    # > 8192 lanes: the 150-validator commit repeated across heights,
    # plus invalid lanes planted at known positions in both slices
    reps = -(-8193 // len(commit150))
    big = [list(t) for _ in range(reps) for t in commit150]
    big_exp = exp150 * reps
    for pos in (100, 8192, len(big) - 1):
        big[pos][1] = big[pos][1] + b"!"
        big_exp[pos] = False
    # the tables are warm from commit150: nothing is built here
    chunked = drive("chunked", big, big_exp, dev, warm_runs=5, window_bits=8, builds=False)
    check_ladder("chunked")
    profile_warm("chunked", big, dev, runs=3)
    check_fused("chunked", chunked["plan"], big_exp, dev, prefixes=(512, 2048, 4096))

    # phase 7: the validator-set change; newcomers are generic-wide's keys
    wide, wide_exp = make_wide(PR.TABLE_MAX_KEYS + 16)
    kb8 = 32 * 4 * 26 * 256 * 4
    rot_args = (dev, commit150, exp150, wide[:20], wide_exp[:20])
    rotation("in place", *rot_args, cap_bytes=PR.TABLE_CACHE_MB << 20, evicts=False)
    rotation("evict", *rot_args, cap_bytes=200 * kb8, evicts=True)
    rotation("compact", *rot_args, cap_bytes=256 * kb8, evicts=True,
             prior=(wide[20:126], wide_exp[20:126]))
    check_ladder("rotations")
    # phase 8: the largest set in the repo's sources, keyed at 4-bit
    drive_10k(wide, wide_exp, dev)
    check_ladder("commit10k")

    # phase 9: the same cells on the generic tier, the tables bypassed by
    # a table limit of 0 for the phase
    limit, PR.TABLE_MAX_KEYS = PR.TABLE_MAX_KEYS, 0
    try:
        why = "TABLE_MAX_KEYS set to 0"
        gen150 = drive_generic("generic150", commit150, exp150, dev, warm_runs=50, why=why)
        vg150 = check_generic("generic150", gen150["plan"], exp150, dev)
        gen1k = drive_generic("generic1024", commit1k, exp1k, dev, warm_runs=20, why=why)
        check_generic("generic1024", gen1k["plan"], exp1k, dev)
        gen_big = drive_generic("generic-chunked", big, big_exp, dev, warm_runs=5, why=why)
        check_generic("generic-chunked", gen_big["plan"], big_exp, dev,
                      prefixes=(256, 512, 1024, 2048, 4096))
    finally:
        PR.TABLE_MAX_KEYS = limit
    check_ladder("generic150, generic1024, generic-chunked")
    # a set over the default limit takes the generic tier by itself
    drive_generic("generic-wide", wide, wide_exp, dev, warm_runs=5,
                  why=f"{len(wide)} distinct keys > TABLE_MAX_KEYS = {PR.TABLE_MAX_KEYS}")
    check_ladder("generic-wide")
    oracle_floor(commit150)
    check_commit_step(commit150, exp150, dev)

    # phase 10: the host tier and the dispatch ladder
    host_cells(dev, threshold)
    check_ladder("host cells")
    host_sizes = host_at_device_sizes(dev, commit150, exp150, main150["p50_ms"],
                                      main1k["p50_ms"], wide)
    check_ladder("host tier at device sizes")
    walk_overhead(dev, commit150, exp150)
    check_ladder("walk overhead")
    chaos_phase(dev, commit150, exp150)
    check_ladder("after the chaos phase")

    # phase 11: the verify-ahead plane
    stream_phase(dev, commit150, exp150, big, big_exp, commit1k, exp1k, smi)
    check_ladder("stream phase")
    queue_phase(dev, commit150, exp150, commit1k, wide, wide_exp, registry, smi)
    check_ladder("queue phase")
    from cometbft_tpu_torch.crypto import batch as B

    probe = threading.Thread(target=B.probe_device, name="device-probe")
    probe.start()          # a subprocess counting the cards, while the prober runs
    prober_phase(dev, registry, smi)
    check_ladder("after the prober phase")
    probe.join(120)
    seed_phase(main150, main1k, gen150, gen1k, host_sizes, smi)
    # phase 12: commit verification through the types layer
    validation_phase(dev, commit150, commit1k, registry, smi)
    check_ladder("validation phase")
    # phases 13-14: the multi-device plane and the device-plane guard
    mesh = mesh_phase(dev, commit150, exp150, commit1k, exp1k, big, big_exp, wide, wide_exp,
                      smi)
    check_ladder("mesh phase")
    guard_phase(dev, commit150, exp150, mesh["mesh"], smi)
    check_ladder("guard phase")
    # phase 15: persistence and the light client
    light = light_sync_phase(dev, smi)
    check_ladder("light sync phase")
    # phase 16: blocksync catch-up
    bsync = blocksync_phase(dev, smi, registry)
    check_ladder("blocksync phase")
    # phase 17: consensus
    cons = consensus_phase(dev, smi, registry)
    check_ladder("consensus phase")
    for line in registry.expose().splitlines():
        if line.startswith(("cometbft_crypto_dispatch_tier", "cometbft_crypto_dispatch_decisions",
                            "cometbft_crypto_device_hangs_total", "cometbft_crypto_key_pool")):
            print(f"  metric {line}")

    def slice_launches(kname: str) -> dict:
        """A kernel's launches on the later slices' paths: (e2) the
        evidence pool's check and its refused copy, (s) statesync1024,
        (d) pex-wan1024, (r) commit150-remote and its gRPC run."""
        return {"evidence_launches": light["evidence_add_launches"].get(kname, 0)
                + light["evidence_refuse_launches"].get(kname, 0),
                "statesync_launches": bsync["s"]["launches"].get(kname, 0),
                "pex_wan_launches": bsync["d"]["launches"].get(kname, 0),
                "remote_launches": sum(cons[k]["launches"].get(kname, 0)
                                       for k in ("r", "r_grpc"))}

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
            "blocksync_launches": bsync["a"]["launches"].get(kname, 0),
            "consensus_launches": consensus_launches(cons, kname),
        **slice_launches(kname),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
        })
    kernels.append({
        "name": "verify_keyed", "route": "cuda",
        "source": "cometbft_tpu_torch/csrc/verify_keyed.cu",
        "replaces": "cometbft_tpu/ops/field.py:338",
        "launches": main150["launches"]["verify_keyed"],
        "blocksync_launches": bsync["a"]["launches"].get("verify_keyed", 0),
        "consensus_launches": consensus_launches(cons, "verify_keyed"),
        **slice_launches("verify_keyed"),
        "max_abs_err": vk150["err"], "ms": vk150["ms"], "plain_ms": vk150["plain_ms"],
        "bound_ms": vk150["bound"][0], "bound_by": vk150["bound"][1],
        "library_ms": None, "G": vk150["group"],
    })
    sha = vk150["sha"]
    kernels.append({
        "name": "sha512_keyed", "route": "cuda",
        "source": "cometbft_tpu_torch/csrc/sha512.cu",
        "replaces": "cometbft_tpu/ops/sha512.py:116",
        "launches": main150["launches"]["sha512_keyed"],
        "blocksync_launches": bsync["a"]["launches"].get("sha512_keyed", 0),
        "consensus_launches": consensus_launches(cons, "sha512_keyed"),
        **slice_launches("sha512_keyed"),
        "max_abs_err": sha["err"], "ms": sha["ms"], "plain_ms": sha["plain_ms"],
        "bound_ms": sha["bound"][0], "bound_by": sha["bound"][1],
        "library_ms": None,
    })
    kernels.append({
        "name": "verify_generic", "route": "cuda",
        "source": "cometbft_tpu_torch/csrc/verify_generic.cu",
        "replaces": "cometbft_tpu/ops/field.py:338",
        "launches": gen150["launches"]["verify_generic"],
        "blocksync_launches": bsync["a"]["launches"].get("verify_generic", 0),
        "consensus_launches": consensus_launches(cons, "verify_generic"),
        **slice_launches("verify_generic"),
        "max_abs_err": vg150["err"], "ms": vg150["ms"], "plain_ms": vg150["plain_ms"],
        "bound_ms": vg150["bound"][0], "bound_by": vg150["bound"][1],
        "library_ms": None, "shape": list(vg150["shape"]),
    })
    b = bres["commit150"]
    kernels.append({
        "name": "build_tables", "route": "cuda",
        "source": "cometbft_tpu_torch/csrc/build_tables.cu",
        "replaces": "cometbft_tpu/ops/precompute.py:115",
        "launches": main150["launches"]["build_tables"],
        "blocksync_launches": bsync["a"]["launches"].get("build_tables", 0),
        "consensus_launches": consensus_launches(cons, "build_tables"),
        **slice_launches("build_tables"),
        "max_abs_err": b["err"], "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound"][0], "bound_by": b["bound"][1],
        "library_ms": None, "shapes": [list(x) for x in b["choice"]],
    })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
