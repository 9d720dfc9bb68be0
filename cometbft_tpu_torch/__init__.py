"""PyTorch and CUDA port of the cometbft_tpu device plane.

The JAX package ``cometbft_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100 (sm_90a).  It imports torch, numpy
and the standard library only -- never ``jax`` and never a
``cometbft_tpu`` module: what it needs of the reference's host code
(the big-int oracle, the key types, the env readers) it keeps as its
own copy.

Layout mirrors the reference:

  utils/env.py          env readers + the device resolver
  utils/metrics.py      Prometheus registry and text exposition
  utils/flight.py       the flight recorder (recent events)
  utils/service.py      BaseService, the start/stop lifecycle
  utils/trace.py        the span tracer (TRACER) and its trace-event export
  utils/protoio.py      the deterministic protobuf wire writer and reader
  utils/time.py         now_ns, the one clock (tests patch it)
  utils/bit_array.py    BitArray, the vote set's presence bits
  utils/log.py          Logger, the leveled key-value logger
  utils/db.py           the ordered key-value seam: MemDB, SQLiteDB, open_db
  version.py            BLOCK_PROTOCOL and the protocol constants
  metrics/__init__.py   StoreMetrics, CryptoMetrics, HealthMetrics and
                        their sinks
  crypto/edwards.py     pure-Python big-int oracle (host constants, signing)
  crypto/ed25519.py     Ed25519 key types over the oracle; CpuBatchVerifier,
                        the host tier
  crypto/ed25519_native.py  ctypes binding of the host RLC check
                        (csrc/host/ed25519_batch.cpp, built with g++)
  crypto/dispatch.py    the dispatch ladder, chaos plan and cost model
                        (seeded from the perf ledger)
  crypto/health.py      the launch watchdog, busy/idle and overlap
                        accounting, the canary prober, the perf ledger
  crypto/batch.py       create_batch_verifier -- the entry point; the
                        device probe
  crypto/verify_queue.py  the verify-ahead queue: collector and launcher
                        threads, four priority lanes, the speculative cache
  crypto/tmhash.py, crypto/merkle.py  SHA-256 sums, the RFC 6962 tree and
                        its proofs
  types/canonical.py    canonical vote and proposal sign bytes
  types/block.py        PartSetHeader, BlockID, Header, CommitSig, Commit,
                        Block (its part set, encoding and derived hashes)
  types/part_set.py     Part, PartSet: a block's merkle-proven parts
  types/evidence.py     DuplicateVoteEvidence, LightClientAttackEvidence
  types/block_meta.py   BlockMeta, the block store's per-height record
  types/params.py       ConsensusParams and its hash
  types/genesis.py      GenesisDoc and its JSON
  types/validator.py    Validator, ValidatorSet (proposer rotation, changes)
  types/codec.py        the wire codec of headers, commits, evidence,
                        blocks, parts and proofs
  types/vote.py         Vote, Proposal
  types/vote_set.py     VoteSet: tallies, majorities, make_commit; each
                        vote through verify_or_fallback (the queue)
  types/validation.py   verify_commit, verify_commit_light,
                        verify_commit_light_trusting -- the callers of
                        create_batch_verifier
  types/light_block.py  SignedHeader, LightBlock and their encodings
  store/__init__.py     BlockStore: blocks as parts, metas and commits
  state/__init__.py     State, its codecs, the state Store
  light/verifier.py     verify, verify_adjacent, verify_non_adjacent
  light/store.py        LightStore, the client's trusted blocks
  light/provider.py     Provider, NodeProvider (a node's stores)
  light/client.py       Client: skipping and sequential sync, backwards
                        verification, witness comparison
  ops/_build.py         nvcc build of csrc/*.cu and g++ build of
                        csrc/host/*.cpp, loaded with ctypes
  ops/field.py          GF(2^255-19) limbs; fe_mul / fe_sq CUDA kernels
  ops/sha512.py         SHA-512; sha512_padded CUDA kernel
  ops/scalar.py         arithmetic mod L
  ops/curve.py          edwards25519 point ops, ZIP-215 decompression,
                        the comb of B and window_mul (generic tier)
  ops/precompute.py     per-validator comb tables (build_tables CUDA
                        kernel) + the key-table pool
  ops/ed25519_verify.py the keyed and generic verify paths, their async
                        entries and verify_stream, TorchBatchVerifier
                        (the ladder's walk) and the calibrated threshold
  models/commit.py      commit_verify_step: the generic tier as one step
  utils/flowrate.py     Monitor: a connection's rate accounting and limit
  p2p/                  the wire: NodeKey, NetAddress, NodeInfo, Peer,
                        MultiplexTransport, Switch, make_switch; p2p/conn/:
                        SecretConnection (handshake_crypto.py, and
                        frame_native.py over csrc/host/frame_crypto.cpp,
                        built with g++), MConnection

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""
