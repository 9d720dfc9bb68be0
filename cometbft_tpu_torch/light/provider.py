"""Light-block providers (a copy of cometbft_tpu/light/provider.py:1-75;
reference: light/provider/provider.go).

A provider serves light blocks for a chain.  ``NodeProvider`` reads a
local node's stores directly (the in-process analog of the reference's
http provider — the RPC-backed provider plugs in the same interface
once the RPC plane lands).  ``HTTPProvider`` and its JSON decoders (the
reference's :77-280) need the RPC client and are not ported yet."""

from __future__ import annotations

from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader


class ProviderError(Exception):
    pass


class LightBlockNotFoundError(ProviderError):
    """(provider/errors.go ErrLightBlockNotFound)"""


class Provider:
    """(light/provider/provider.go:14 Provider)"""

    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """Height 0 means latest."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        raise NotImplementedError


class NodeProvider(Provider):
    """Serves light blocks straight from a node's block/state stores."""

    def __init__(self, chain_id: str, block_store, state_store,
                 evidence_pool=None):
        self._chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.evidence_pool = evidence_pool

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            raise LightBlockNotFoundError(f"no block at height {height}")
        # the canonical commit FOR height H is stored with block H+1;
        # for the chain head fall back to the seen commit
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        if commit is None:
            raise LightBlockNotFoundError(f"no commit for height {height}")
        vals = self.state_store.load_validators(height)
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def report_evidence(self, ev) -> None:
        if self.evidence_pool is not None:
            self.evidence_pool.add_evidence(ev)

    def consensus_params(self, height: int):
        return self.state_store.load_consensus_params(height)


__all__ = [
    "LightBlockNotFoundError",
    "NodeProvider",
    "Provider",
    "ProviderError",
]
