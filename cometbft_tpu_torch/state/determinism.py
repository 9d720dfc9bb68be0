"""Replay-determinism runtime guard (a copy of
cometbft_tpu/state/determinism.py).

The BFT contract rests on one invariant no test had checked
mechanically: the state transition machine is a pure function of
(block, prior state) — under WAL replay, handshake recovery, and
speculative execution the same decided block must produce bit-equal
results on every node and every re-execution.  This module catches a
divergence as a digest mismatch at the exact height and field where
execution diverged.

With the guard on, every committed height appends a
:class:`TransitionDigest` record (``KIND_TRANSITION_DIGEST``) to the
WAL after the height's end-height marker: per-field sha256 digests of
the decided block id, the tx results, the validator-set updates, the
consensus-param updates, and the app hash — the exact inputs to
``Header.app_hash`` / ``last_results_hash`` / ``validators_hash`` at
the next height, i.e. everything a nondeterministic app or a
nondeterministic ``update_state`` could corrupt.  The digests are
re-derived and compared at three surfaces:

* **WAL catch-up replay** (`ConsensusState._apply_wal_record`): the
  recorded digest vs one recomputed from the stores.
* **Handshake re-execution** (`Handshaker._replay_block_to_app`): the
  stored FinalizeBlock response vs the app's fresh re-execution of
  the same block — the app-nondeterminism direction.
* **Node startup** (:func:`verify_wal_digests`): every digest record
  still in the WAL vs the block/state stores, before the node starts
  moving.

A mismatch raises :class:`DivergenceError` naming the first diverging
field and carrying both digests plus the flight-recorder tail, after
recording a ``determinism_divergence`` flight event and bumping
``consensus_replay_divergence_total{surface=...}``.

Where the port departs from its reference: the guard is an argument,
not ``CMT_TPU_DETERMINISM``.  ``BlockExecutor(determinism=True)``
records the digest of every applied block, ``ConsensusState`` (which
reads the executor's setting) writes it to the WAL and checks the
records it replays, and ``Handshaker(determinism=True)``
checks each block it re-executes; ``enabled()`` is gone.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from cometbft_tpu_torch.utils.flight import FLIGHT, flight_tail

#: per-field digest order — compare() reports the FIRST diverging
#: field in this order, so the name points at the subsystem that
#: diverged: block_id = consensus decided differently, tx_results /
#: app_hash = the app re-executed differently, validator_updates /
#: consensus_param_updates = update_state inputs drifted.
DIGEST_FIELDS = (
    "block_id",
    "tx_results",
    "validator_updates",
    "consensus_param_updates",
    "app_hash",
)


def _h(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@dataclass(frozen=True)
class TransitionDigest:
    """Per-height digest of the state transition's outputs.

    ``fields`` maps each DIGEST_FIELDS name to a sha256 hexdigest of
    that field's canonical encoding; ``digest`` is the sha256 over
    ``height`` plus the field digests in declaration order.  The WAL
    payload is canonical JSON (sorted keys) so the record itself is
    byte-deterministic.
    """

    height: int
    fields: dict[str, str]
    digest: str

    def encode(self) -> bytes:
        return json.dumps(
            {"height": self.height, "fields": self.fields,
             "digest": self.digest},
            sort_keys=True, separators=(",", ":"),
        ).encode()

    @classmethod
    def decode(cls, data: bytes) -> "TransitionDigest":
        obj = json.loads(data.decode())
        return cls(
            height=int(obj["height"]),
            fields={str(k): str(v) for k, v in obj["fields"].items()},
            digest=str(obj["digest"]),
        )


class DivergenceError(RuntimeError):
    """A transition digest failed to reproduce: the same height's
    re-execution (or the stores backing it) no longer matches what was
    committed.  Carries both digests and the first diverging field —
    plus the flight tail, because the events *before* the divergence
    are the post-mortem."""

    def __init__(
        self,
        recorded: TransitionDigest,
        recomputed: TransitionDigest,
        first_field: str,
        surface: str,
    ):
        self.recorded = recorded
        self.recomputed = recomputed
        self.first_field = first_field
        self.surface = surface
        super().__init__(
            f"state transition diverged on replay at height "
            f"{recorded.height} ({surface}): first diverging field "
            f"'{first_field}' — recorded "
            f"{recorded.fields.get(first_field, recorded.digest)[:16]}…, "
            f"recomputed "
            f"{recomputed.fields.get(first_field, recomputed.digest)[:16]}… "
            f"(recorded={recorded.fields} recomputed={recomputed.fields})"
            + flight_tail()
        )


def _validator_updates_bytes(updates) -> bytes:
    # app-provided order is part of the determinism contract
    # (CometBFT hashes updates in the order the app returned them)
    out = bytearray()
    for u in updates:
        out += u.pub_key_type.encode()
        out += b"|"
        out += u.pub_key_bytes
        out += b"|"
        out += str(u.power).encode()
        out += b"\n"
    return bytes(out)


def transition_digest(height, block_id, resp) -> TransitionDigest:
    """Digest one height's transition outputs from the decided block
    id and the FinalizeBlock response — the same code path serves the
    live commit (record) and every replay surface (recompute), so the
    two can only differ if the underlying values differ."""
    from cometbft_tpu_torch.abci.types import results_hash

    params = resp.consensus_param_updates
    fields = {
        "block_id": _h(block_id.encode()),
        "tx_results": _h(results_hash(list(resp.tx_results))),
        "validator_updates": _h(
            _validator_updates_bytes(resp.validator_updates)
        ),
        "consensus_param_updates": _h(
            params.hash() if params is not None else b""
        ),
        "app_hash": _h(resp.app_hash),
    }
    overall = hashlib.sha256(str(height).encode())
    for name in DIGEST_FIELDS:
        overall.update(name.encode())
        overall.update(fields[name].encode())
    return TransitionDigest(
        height=int(height), fields=fields, digest=overall.hexdigest()
    )


def compare(
    recorded: TransitionDigest,
    recomputed: TransitionDigest,
    *,
    surface: str,
    metrics=None,
) -> None:
    """Raise DivergenceError on the first diverging field (flight
    event + consensus_replay_divergence_total first, so the signal
    survives even if the caller swallows the raise)."""
    first = None
    if recorded.height != recomputed.height:
        first = "height"
    else:
        for name in DIGEST_FIELDS:
            if recorded.fields.get(name) != recomputed.fields.get(name):
                first = name
                break
        if first is None and recorded.digest != recomputed.digest:
            first = "digest"
    if first is None:
        return
    FLIGHT.record(
        "determinism_divergence",
        height=recorded.height,
        surface=surface,
        field=first,
        recorded=recorded.fields.get(first, recorded.digest),
        recomputed=recomputed.fields.get(first, recomputed.digest),
    )
    if metrics is not None:
        metrics.replay_divergence_total.labels(surface=surface).inc()
    raise DivergenceError(recorded, recomputed, first, surface)


def recompute_from_stores(height: int, block_store, state_store):
    """Re-derive a height's TransitionDigest from the persisted block
    meta + FinalizeBlock response; None when either side has been
    pruned (nothing left to check against)."""
    meta = block_store.load_block_meta(height)
    resp = state_store.load_finalize_block_response(height)
    if meta is None or resp is None:
        return None
    return transition_digest(height, meta.block_id, resp)


def verify_wal_digests(wal, block_store, state_store, metrics=None) -> int:
    """Startup surface: replay every KIND_TRANSITION_DIGEST record
    still in the WAL against the stores.  Returns the number of
    heights verified digest-clean; raises DivergenceError on the
    first mismatch."""
    from cometbft_tpu_torch.wal import KIND_TRANSITION_DIGEST

    verified = 0
    for rec in wal.records():
        if rec.kind != KIND_TRANSITION_DIGEST:
            continue
        recorded = TransitionDigest.decode(rec.data)
        recomputed = recompute_from_stores(
            recorded.height, block_store, state_store
        )
        if recomputed is None:
            continue  # pruned past this height
        compare(recorded, recomputed, surface="startup", metrics=metrics)
        verified += 1
    if verified:
        FLIGHT.record("determinism_wal_verified", heights=verified)
    return verified
