"""State provider — trusted state for a snapshot height (a copy of
cometbft_tpu/statesync/stateprovider.py; reference:
statesync/stateprovider.go:39 lightClientStateProvider).

Uses the light client to fetch verified headers H, H+1 and H+2 and
assemble the post-snapshot consensus state: the app hash that block
H's execution must reproduce lives in header H+1; the validator sets
for H/H+1/H+2 become last/current/next validators
(stateprovider.go State()).

The port's light client verifies on its own ``device`` (``Client(...,
device=...)``): the headers' commits go through the keyed tier there.
"""

from __future__ import annotations

import time

from cometbft_tpu_torch.light.client import Client
from cometbft_tpu_torch.light.provider import ProviderError
from cometbft_tpu_torch.state import State
from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.utils.log import Logger, default_logger


class StateProviderError(Exception):
    pass


class StateProvider:
    """(statesync/stateprovider.go:30 StateProvider iface)"""

    def app_hash(self, height: int) -> bytes:
        raise NotImplementedError

    def commit(self, height: int) -> Commit:
        raise NotImplementedError

    def state(self, height: int) -> State:
        raise NotImplementedError


class LightClientStateProvider(StateProvider):
    """(stateprovider.go:39) — every answer is light-client verified."""

    def __init__(
        self,
        light_client: Client,
        consensus_params_fn=None,  # (height) -> ConsensusParams
        logger: Logger | None = None,
    ):
        self.lc = light_client
        self.consensus_params_fn = consensus_params_fn
        self.logger = logger or default_logger().with_fields(
            module="stateprovider"
        )

    def app_hash(self, height: int) -> bytes:
        """(stateprovider.go:74 AppHash) — header H+1 carries the app
        hash produced by executing block H."""
        lb = self._verified(height + 1)
        return lb.header.app_hash

    def commit(self, height: int) -> Commit:
        lb = self._verified(height)
        return lb.signed_header.commit

    def state(self, height: int) -> State:
        """(stateprovider.go:118 State)"""
        cur = self._verified(height)
        nxt = self._verified(height + 1)
        nxt2 = self._verified(height + 2)
        if self.consensus_params_fn is not None:
            params = self.consensus_params_fn(height + 1)
            # params come from an unverified channel; the light-verified
            # header H+1 commits to them via consensus_hash
            if params.hash() != nxt.header.consensus_hash:
                raise StateProviderError(
                    "fetched consensus params do not match the verified "
                    "header's consensus_hash"
                )
        else:
            params = ConsensusParams()
            if params.hash() != nxt.header.consensus_hash:
                raise StateProviderError(
                    "no consensus-params source and defaults do not match "
                    "the verified header"
                )
        return State(
            chain_id=cur.header.chain_id,
            initial_height=1,
            last_block_height=cur.height,
            last_block_id=nxt.header.last_block_id,
            last_block_time_ns=cur.time_ns,
            validators=nxt.validator_set,
            next_validators=nxt2.validator_set,
            last_validators=cur.validator_set,
            last_height_validators_changed=nxt.height,
            consensus_params=params,
            last_height_params_changed=nxt.height,
            last_results_hash=nxt.header.last_results_hash,
            app_hash=nxt.header.app_hash,
        )

    def _verified(self, height: int, retries: int = 60):
        """Verify via light client, waiting briefly for heights the
        chain hasn't produced yet (stateprovider.go retry loop).
        ONLY not-found errors retry — a hard verification failure
        (bad trust hash, conflicting header) must fail fast, not burn
        the whole retry window."""
        last_err = None
        for _ in range(retries):
            try:
                return self.lc.verify_light_block_at_height(height)
            except ProviderError as exc:  # height may not exist yet
                last_err = exc
                time.sleep(0.5)
            except Exception as exc:  # noqa: BLE001 — verification failed
                raise StateProviderError(
                    f"could not verify header {height}: {exc}"
                ) from exc
        raise StateProviderError(
            f"could not verify header {height}: {last_err}"
        )


__all__ = [
    "LightClientStateProvider",
    "StateProvider",
    "StateProviderError",
]
