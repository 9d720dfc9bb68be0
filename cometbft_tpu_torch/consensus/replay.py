"""Handshake & block replay — crash recovery against the app (a part
of cometbft_tpu/consensus/replay.py; reference:
internal/consensus/replay.go:201 Handshaker).

On startup the node compares three heights: the app's (ABCI Info), the
state store's, and the block store's.  Any disagreement is a crash
signature; recovery replays stored blocks into the app (and, for the
final block, through the full BlockExecutor) until all three agree.
The WAL covers the *in-flight* height; this covers committed ones.

Where the port departs from its reference: ``Handshaker`` takes a
keyword ``device`` (``cuda`` unless given; without a card only
``device="cpu"`` runs) for the executor that replays the last stored
block, and the replay-determinism check of ``state/determinism.py`` is
the argument ``determinism`` (the reference reads
``CMT_TPU_DETERMINISM``): with it on, each block re-executed into the
app must reproduce the FinalizeBlock response the store kept.  The
handshaker counts the heights it checked (``n_digests_checked``).
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

from cometbft_tpu_torch.abci.types import (
    FinalizeBlockRequest,
    InfoRequest,
    InitChainRequest,
    ValidatorUpdate,
)
from cometbft_tpu_torch.mempool import NopMempool
from cometbft_tpu_torch.state import State, Store, determinism as _determinism
from cometbft_tpu_torch.state.execution import (
    BlockExecutor,
    abci_validator_updates_to_changes,
    build_last_commit_info,
)
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.version import ABCI_SEMVER, BLOCK_PROTOCOL, __version__


class HandshakeError(Exception):
    pass


class Handshaker:
    """(replay.go:201)"""

    def __init__(
        self,
        state_store: Store,
        state: State,
        block_store,
        genesis: GenesisDoc,
        logger: Logger | None = None,
        metrics=None,
        *,
        device=None,
        determinism: bool = False,
    ):
        self.device = resolve_device(device)
        self.determinism = determinism
        self.n_digests_checked = 0
        self.state_store = state_store
        self.state = state
        self.block_store = block_store
        self.genesis = genesis
        self.logger = logger or default_logger().with_fields(module="handshake")
        self.metrics = metrics  # ConsensusMetrics or None
        self.n_blocks_replayed = 0

    def handshake(self, proxy_app) -> State:
        """(replay.go:242 Handshake) → the possibly-updated state."""
        info = proxy_app.query.info(
            InfoRequest(
                version=__version__,
                block_version=BLOCK_PROTOCOL,
                abci_version=ABCI_SEMVER,
            )
        )
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")
        self.logger.info(
            "ABCI handshake",
            app_height=app_height,
            app_hash=app_hash.hex()[:12],
        )
        state = self._replay_blocks(proxy_app, self.state, app_hash, app_height)
        self.logger.info(
            "handshake complete",
            height=state.last_block_height,
            replayed=self.n_blocks_replayed,
        )
        return state

    # -- internals -------------------------------------------------------

    def _init_chain(self, proxy_app, state: State) -> State:
        """Genesis InitChain round-trip (replay.go:284 first branch)."""
        val_updates = tuple(
            ValidatorUpdate(
                pub_key_type=v.pub_key.type(),
                pub_key_bytes=v.pub_key.bytes(),
                power=v.power,
            )
            for v in self.genesis.validators
        )
        resp = proxy_app.consensus.init_chain(
            InitChainRequest(
                time_ns=self.genesis.genesis_time_ns,
                chain_id=self.genesis.chain_id,
                consensus_params=self.genesis.consensus_params,
                validators=val_updates,
                app_state_bytes=self.genesis.app_state,
                initial_height=self.genesis.initial_height,
            )
        )
        if state.last_block_height != 0:
            return state  # InitChain responses only apply pre-genesis
        changes = {}
        if resp.app_hash:
            changes["app_hash"] = resp.app_hash
        if resp.consensus_params is not None:
            changes["consensus_params"] = resp.consensus_params
        if resp.validators:
            vals = ValidatorSet(
                [
                    Validator(pk, power)
                    for pk, power in abci_validator_updates_to_changes(
                        resp.validators
                    )
                ]
            )
            changes["validators"] = vals
            changes["next_validators"] = vals.copy().increment_proposer_priority(
                1
            )
        if changes:
            state = dc_replace(state, **changes)
        self.state_store.save(state)
        return state

    def _replay_blocks(
        self, proxy_app, state: State, app_hash: bytes, app_height: int
    ) -> State:
        """(replay.go:284 ReplayBlocks)"""
        store_height = self.block_store.height()
        state_height = state.last_block_height

        if app_height == 0:
            state = self._init_chain(proxy_app, state)
            app_hash = state.app_hash

        if store_height == 0:
            return state

        if app_height > state_height + 1 or app_height > store_height:
            raise HandshakeError(
                f"app height {app_height} ahead of chain "
                f"(state {state_height}, store {store_height})"
            )
        if store_height < state_height:
            raise HandshakeError(
                f"block store height {store_height} < state height "
                f"{state_height}: corrupt stores"
            )

        # Blocks the app missed but the state already applied: replay to
        # the app only (replay.go replayBlocks "appHeight < stateHeight").
        for h in range(app_height + 1, state_height + 1):
            app_hash = self._replay_block_to_app(proxy_app, h)
            self.n_blocks_replayed += 1

        # The block saved to the store but never applied to our state
        # (crash inside ApplyBlock's persistence sequence).
        if store_height == state_height + 1:
            if app_height == store_height:
                # The app ALREADY executed+committed this block (crash
                # between proxy Commit and state save): rebuild the state
                # transition from the saved FinalizeBlock response WITHOUT
                # re-sending the block — re-execution would double-apply
                # txs on a persistent app (replay.go:417 "Kvstore should
                # not have state" branch / updateStateFromStore).
                from cometbft_tpu_torch.state.execution import update_state

                resp = self.state_store.load_finalize_block_response(
                    store_height
                )
                if resp is None:
                    raise HandshakeError(
                        f"app at height {store_height} but no saved "
                        "FinalizeBlock response to reconstruct state from"
                    )
                block = self.block_store.load_block(store_height)
                meta = self.block_store.load_block_meta(store_height)
                state = update_state(state, meta.block_id, block, resp)
                self.state_store.save(state)
            else:
                # App never saw the block: run it through the full
                # executor (validate → FinalizeBlock → Commit → save).
                executor = BlockExecutor(
                    self.state_store,
                    proxy_app.consensus,
                    NopMempool(),
                    block_store=self.block_store,
                    logger=self.logger,
                    device=self.device,
                )
                block = self.block_store.load_block(store_height)
                meta = self.block_store.load_block_meta(store_height)
                state = executor.apply_block(state, meta.block_id, block)
            self.n_blocks_replayed += 1
            app_hash = state.app_hash

        if state.app_hash != app_hash:
            raise HandshakeError(
                f"app hash mismatch after replay: state "
                f"{state.app_hash.hex()} app {app_hash.hex()}"
            )
        return state

    def _replay_block_to_app(self, proxy_app, height: int) -> bytes:
        """FinalizeBlock+Commit against the app without touching state
        (replay.go ExecCommitBlock semantics)."""
        block = self.block_store.load_block(height)
        if block is None:
            raise HandshakeError(f"missing block {height} for replay")
        meta = self.block_store.load_block_meta(height)
        resp = proxy_app.consensus.finalize_block(
            FinalizeBlockRequest(
                txs=block.data.txs,
                decided_last_commit=build_last_commit_info(
                    block, self.state_store
                ),
                hash=meta.block_id.hash,
                height=height,
                time_ns=block.header.time_ns,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
                syncing_to_height=self.block_store.height(),
            )
        )
        proxy_app.consensus.commit()
        if self.determinism:
            # the app-nondeterminism direction: the fresh re-execution
            # must reproduce the FinalizeBlock response the original
            # run persisted (tx results, valset deltas, app hash)
            saved = self.state_store.load_finalize_block_response(height)
            if saved is not None:
                _determinism.compare(
                    _determinism.transition_digest(
                        height, meta.block_id, saved
                    ),
                    _determinism.transition_digest(
                        height, meta.block_id, resp
                    ),
                    surface="handshake",
                    metrics=self.metrics,
                )
                self.n_digests_checked += 1
        self.logger.info("replayed block to app", height=height)
        return resp.app_hash
