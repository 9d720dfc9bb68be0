"""Consensus reactor — gossips the consensus state over p2p (a copy of
cometbft_tpu/consensus/reactor.py; reference:
internal/consensus/reactor.go:59).

Four channels (reactor.go:27-30): state 0x20 (round steps, vote
presence), data 0x21 (proposals + block parts), vote 0x22, vote-set
bits 0x23.  Per peer, three gossip threads (reactor.go:212-214):

- gossip_data: streams proposal block parts the peer is missing, plus
  catch-up parts from the block store for lagging peers
  (reactor.go:590 gossipDataRoutine, pickPartToSend :816);
- gossip_votes: picks one vote the peer needs per tick
  (reactor.go:650, pickVoteToSend :894) driven by BitArray
  set-difference;
- query_maj23: anti-entropy — asks peers to prove claimed +2/3
  majorities vote-by-vote (reactor.go:716 queryMaj23Routine).

Inbound messages are routed into the single-writer consensus loop via
``send_peer_msg``; nothing here mutates consensus state directly.

Where the port departs from its reference:
- whether the node stamps its gossip with a trace context is the
  constant ``messages.TRACE_CTX`` (on), where the reference reads
  ``CMT_TPU_TRACE_CTX``;
- ``on_stop`` joins the gossip and event-pump threads it started
  (bounded), so a stopped node leaves none behind;
- the adversary hooks of ``consensus/byz.py`` reach the consensus
  state's ``Byz``, which is its executor's (unarmed unless a caller arms
  it), where the reference's reach a process-wide one armed by
  ``CMT_TPU_BYZ``.

Its lock is ``utils/sync``'s ``Mutex()``, and ``receive`` is the
``consensus_reactor`` trust-guard seam, as in the reference.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    decode_message_traced,
    encode_message,
    make_trace_ctx,
    stamping_enabled,
)
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.consensus.ticker import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
)
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    PartSetHeader,
)
from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.event_bus import (
    EVENT_COMPLETE_PROPOSAL,
    EVENT_NEW_ROUND_STEP,
    EVENT_VOTE,
    query_for_event,
)
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.metrics import p2p_metrics
from cometbft_tpu_torch.utils.bit_array import BitArray
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard

#: envelope types that carry (and receivers hop-record) a trace
#: context — the consensus-critical gossip the fleet plane stitches
_HOP_MSG_TYPES = {
    ProposalMessage: "proposal",
    BlockPartMessage: "block_part",
    VoteMessage: "vote",
}


def gossip_hop_seconds(
    recv_wall: float, send_wall: float, offset: float | None
) -> float:
    """Offset-corrected hop latency, clamped at zero.  ``offset`` is
    the peer clock-offset estimate (remote_wall - local_wall, None
    when no stamped pong has arrived yet): the sender's stamp is
    converted onto OUR clock before differencing, so skewed-but-
    estimated clocks still give ms-accurate hops, and the clamp
    guarantees the histogram never sees a negative sample."""
    return max(0.0, recv_wall - send_wall + (offset or 0.0))

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

PEER_GOSSIP_SLEEP = 0.05        # config peer_gossip_sleep_duration (100ms ref)
PEER_QUERY_MAJ23_SLEEP = 2.0    # config peer_query_maj23_sleep_duration

PEER_STATE_KEY = "consensus_peer_state"


def vote_from_commit(commit: Commit, idx: int) -> Vote | None:
    """Reconstruct the precommit a CommitSig came from
    (types/commit.go GetVote) — used to catch lagging peers up from
    the block store."""
    if idx >= len(commit.signatures):
        return None
    cs = commit.signatures[idx]
    if not cs.signature:
        return None
    block_id = (
        commit.block_id
        if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
        else BlockID()
    )
    return Vote(
        type=PRECOMMIT_TYPE,
        height=commit.height,
        round=commit.round,
        block_id=block_id,
        timestamp_ns=cs.timestamp_ns,
        validator_address=cs.validator_address,
        validator_index=idx,
        signature=cs.signature,
    )


@dataclass
class PeerRoundState:
    """What we believe the peer knows (reactor.go PeerRoundState)."""

    height: int = 0
    round: int = -1
    step: int = STEP_NEW_HEIGHT
    start_time_ns: int = 0
    proposal: bool = False
    proposal_block_part_set_header: PartSetHeader | None = None
    proposal_block_parts: BitArray | None = None
    proposal_pol_round: int = -1
    proposal_pol: BitArray | None = None
    prevotes: BitArray | None = None
    precommits: BitArray | None = None
    last_commit_round: int = -1
    last_commit: BitArray | None = None
    catchup_commit_round: int = -1
    catchup_commit: BitArray | None = None


class PeerState:
    """Thread-safe view of a peer's round state (reactor.go PeerState)."""

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self._mtx = cmtsync.Mutex()
        self.prs = PeerRoundState()

    def snapshot(self) -> PeerRoundState:
        with self._mtx:
            return PeerRoundState(
                height=self.prs.height,
                round=self.prs.round,
                step=self.prs.step,
                start_time_ns=self.prs.start_time_ns,
                proposal=self.prs.proposal,
                proposal_block_part_set_header=self.prs.proposal_block_part_set_header,
                proposal_block_parts=(
                    self.prs.proposal_block_parts.copy()
                    if self.prs.proposal_block_parts
                    else None
                ),
                proposal_pol_round=self.prs.proposal_pol_round,
                proposal_pol=self.prs.proposal_pol,
                prevotes=(
                    self.prs.prevotes.copy() if self.prs.prevotes else None
                ),
                precommits=(
                    self.prs.precommits.copy() if self.prs.precommits else None
                ),
                last_commit_round=self.prs.last_commit_round,
                last_commit=(
                    self.prs.last_commit.copy() if self.prs.last_commit else None
                ),
                catchup_commit_round=self.prs.catchup_commit_round,
                catchup_commit=(
                    self.prs.catchup_commit.copy()
                    if self.prs.catchup_commit
                    else None
                ),
            )

    # -- inbound state application --------------------------------------

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        """(reactor.go ApplyNewRoundStepMessage)"""
        with self._mtx:
            prs = self.prs
            ps_height, ps_round = prs.height, prs.round
            ps_catchup_commit_round = prs.catchup_commit_round
            ps_catchup_commit = prs.catchup_commit

            ps_precommits = prs.precommits  # saved BEFORE the reset below
            prs.height = msg.height
            prs.round = msg.round
            prs.step = msg.step
            prs.start_time_ns = (
                now_ns() - msg.seconds_since_start_time * 1_000_000_000
            )
            if ps_height != msg.height or ps_round != msg.round:
                prs.proposal = False
                prs.proposal_block_part_set_header = None
                prs.proposal_block_parts = None
                prs.proposal_pol_round = -1
                prs.proposal_pol = None
                prs.prevotes = None
                prs.precommits = None
            if (
                ps_height == msg.height
                and ps_round != msg.round
                and msg.round == ps_catchup_commit_round
            ):
                # peer caught up to the round we have a commit for
                prs.precommits = ps_catchup_commit
            if ps_height != msg.height:
                # shift precommits to last_commit
                if ps_height + 1 == msg.height and ps_round == msg.last_commit_round:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = ps_precommits
                else:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = None
                prs.catchup_commit_round = -1
                prs.catchup_commit = None

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height:
                return
            if prs.round != msg.round and not msg.is_commit:
                return
            prs.proposal_block_part_set_header = msg.block_part_set_header
            prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height:
                return
            if prs.proposal_pol_round != msg.proposal_pol_round:
                return
            prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg: HasVoteMessage) -> None:
        with self._mtx:
            if self.prs.height != msg.height:
                return
            self._set_has_vote_locked(msg.height, msg.round, msg.type, msg.index)

    def apply_vote_set_bits(
        self, msg: VoteSetBitsMessage, our_votes: BitArray | None
    ) -> None:
        """(reactor.go ApplyVoteSetBitsMessage) — if we know our vote
        set for that BlockID, the peer's claim is authoritative within
        our set (votes.sub(ourVotes).or(msg.votes)): bits outside our
        set are kept, bits within it are replaced; else replace."""
        with self._mtx:
            prs = self.prs
            if prs.height == msg.height:
                arr = self._get_vote_bit_array_locked(msg.round, msg.type)
                if arr is not None and our_votes is not None:
                    had = arr.sub(our_votes).or_(msg.votes)
                    self._set_vote_bit_array_locked(msg.round, msg.type, had)
                else:
                    self._set_vote_bit_array_locked(
                        msg.round, msg.type, msg.votes
                    )

    # -- outbound bookkeeping -------------------------------------------

    def set_has_proposal(self, proposal) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != proposal.height or prs.round != proposal.round:
                return
            if prs.proposal:
                return
            prs.proposal = True
            if prs.proposal_block_parts is not None:
                return  # NewValidBlock already set them
            prs.proposal_block_part_set_header = proposal.block_id.part_set_header
            prs.proposal_block_parts = BitArray(
                proposal.block_id.part_set_header.total
            )
            prs.proposal_pol_round = proposal.pol_round
            prs.proposal_pol = None

    def init_proposal_block_parts(self, header: PartSetHeader) -> None:
        with self._mtx:
            if self.prs.proposal_block_parts is not None:
                return
            self.prs.proposal_block_part_set_header = header
            self.prs.proposal_block_parts = BitArray(header.total)

    def set_has_proposal_block_part(
        self, height: int, round_: int, index: int
    ) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != height or prs.round != round_:
                return
            if prs.proposal_block_parts is not None:
                prs.proposal_block_parts.set_index(index, True)

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        with self._mtx:
            self._ensure_vote_bit_arrays_locked(height, num_validators)

    def _ensure_vote_bit_arrays_locked(
        self, height: int, num_validators: int
    ) -> None:
        prs = self.prs
        if prs.height == height:
            if prs.prevotes is None:
                prs.prevotes = BitArray(num_validators)
            if prs.precommits is None:
                prs.precommits = BitArray(num_validators)
            if prs.catchup_commit is None:
                prs.catchup_commit = BitArray(num_validators)
            if prs.proposal_pol is None:
                prs.proposal_pol = BitArray(num_validators)
        elif prs.height == height + 1:
            if prs.last_commit is None:
                prs.last_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(
        self, height: int, round_: int, num_validators: int
    ) -> None:
        """(reactor.go EnsureCatchupCommitRound)"""
        with self._mtx:
            self._ensure_catchup_commit_round_locked(
                height, round_, num_validators
            )

    def _ensure_catchup_commit_round_locked(
        self, height: int, round_: int, num_validators: int
    ) -> None:
        prs = self.prs
        if prs.height != height:
            return
        if prs.catchup_commit_round == round_:
            return
        prs.catchup_commit_round = round_
        if round_ == prs.round and prs.precommits is not None:
            prs.catchup_commit = prs.precommits
        else:
            prs.catchup_commit = BitArray(num_validators)

    def set_has_vote(self, vote: Vote) -> None:
        with self._mtx:
            self._set_has_vote_locked(
                vote.height, vote.round, vote.type, vote.validator_index
            )

    def _set_has_vote_locked(
        self, height: int, round_: int, vote_type: int, index: int
    ) -> None:
        arr = self._get_vote_bit_array_for_height_locked(
            height, round_, vote_type
        )
        if arr is not None and index >= 0:
            arr.set_index(index, True)

    def _get_vote_bit_array_for_height_locked(
        self, height: int, round_: int, vote_type: int
    ) -> BitArray | None:
        prs = self.prs
        if prs.height == height:
            return self._get_vote_bit_array_locked(round_, vote_type)
        if prs.height == height + 1:
            if round_ == prs.last_commit_round and vote_type == PRECOMMIT_TYPE:
                return prs.last_commit
        return None

    def _get_vote_bit_array_locked(
        self, round_: int, vote_type: int
    ) -> BitArray | None:
        prs = self.prs
        if round_ == prs.round:
            return prs.prevotes if vote_type == PREVOTE_TYPE else prs.precommits
        if round_ == prs.proposal_pol_round and vote_type == PREVOTE_TYPE:
            return prs.proposal_pol
        if round_ == prs.catchup_commit_round and vote_type == PRECOMMIT_TYPE:
            return prs.catchup_commit
        return None

    def _set_vote_bit_array_locked(
        self, round_: int, vote_type: int, arr: BitArray
    ) -> None:
        prs = self.prs
        if round_ == prs.round:
            if vote_type == PREVOTE_TYPE:
                prs.prevotes = arr
            else:
                prs.precommits = arr
        elif round_ == prs.proposal_pol_round and vote_type == PREVOTE_TYPE:
            prs.proposal_pol = arr
        elif round_ == prs.catchup_commit_round and vote_type == PRECOMMIT_TYPE:
            prs.catchup_commit = arr

    def get_vote_bit_array(self, round_: int, vote_type: int) -> BitArray | None:
        with self._mtx:
            arr = self._get_vote_bit_array_locked(round_, vote_type)
            return arr.copy() if arr is not None else None

    # -- vote picking (reactor.go:894 pickVoteToSend) -------------------

    def pick_vote_to_send(self, votes) -> Vote | None:
        """Given a VoteSet we hold, pick one vote the peer is missing.
        The caller marks it via :meth:`set_has_vote` only after a
        successful send (reactor.go PickSendVote)."""
        if votes is None:
            return None
        num_validators = votes.bit_array().size
        if num_validators == 0:
            return None
        height = votes.height
        round_ = votes.round
        vote_type = votes.signed_msg_type
        with self._mtx:
            # A commit-carrying set (precommits with a +2/3 majority for
            # an actual BLOCK — a nil majority is not a commit) makes
            # its round the peer's catchup-commit round first, so a peer
            # whose own round has moved past the commit round still gets
            # the commit votes (reactor.go:1306 "Lazily set data" +
            # VoteSet.IsCommit) — without this, a validator stuck one
            # height back at a later round never receives the committed
            # precommits and the whole network stalls behind it.
            maj = (
                votes.two_thirds_majority()
                if vote_type == PRECOMMIT_TYPE
                else None
            )
            if maj is not None and not maj.is_nil():
                self._ensure_catchup_commit_round_locked(
                    height, round_, num_validators
                )
            self._ensure_vote_bit_arrays_locked(height, num_validators)
            peer_arr = self._get_vote_bit_array_for_height_locked(
                height, round_, vote_type
            )
            if peer_arr is None:
                return None
            missing = votes.bit_array().sub(peer_arr)
            index, ok = missing.pick_random()
            if not ok:
                return None
            return votes.get_by_index(index)


class ConsensusReactor(Reactor):
    """(internal/consensus/reactor.go:59 Reactor)"""

    def __init__(
        self,
        consensus: ConsensusState,
        wait_sync: bool = False,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="consensus-reactor",
            logger=logger
            or default_logger().with_fields(module="consensus-reactor"),
        )
        self.consensus = consensus
        self._wait_sync = threading.Event()
        if wait_sync:
            self._wait_sync.set()
        self._rng = random.Random()
        cfg = consensus.config
        self._gossip_sleep = (
            getattr(cfg, "peer_gossip_sleep_duration_ns", 0) / 1e9
            or PEER_GOSSIP_SLEEP
        )
        self._maj23_sleep = (
            getattr(cfg, "peer_query_maj23_sleep_duration_ns", 0) / 1e9
            or PEER_QUERY_MAJ23_SLEEP
        )
        #: fleet plane: stamp outbound proposal/part/vote envelopes
        #: (TRACE_CTX off reverts to pre-fleet untagged sends AND
        #: disables receive-side hop recording — the whole node
        #: behaves like an old peer)
        self._trace_ctx_on = stamping_enabled()
        #: the threads this reactor started, joined by on_stop
        self._threads: list[threading.Thread] = []
        self._threads_mtx = threading.Lock()
        self._origin_id: str | None = None
        #: hop-histogram children, resolved ONCE on first stamped
        #: receive (the sink is installed at node assembly, which can
        #: be after reactor construction) — the receive path must not
        #: pay a labels() dict lookup per message (the MConnection
        #: _m_rtt convention)
        self._hop_hist: dict[str, object] | None = None

    def _origin(self) -> str:
        """Our node id for trace-context stamps (lazy: the switch is
        attached after construction)."""
        if self._origin_id is None and self.switch is not None:
            try:
                self._origin_id = self.switch.node_info().node_id
            except Exception:  # noqa: BLE001 — tests without transports
                self._origin_id = ""
        return self._origin_id or ""

    def _enc(self, msg, height: int, round_: int) -> bytes:
        """Encode a consensus-critical message, trace-context-stamped
        when the fleet plane is on.  The stamp is minted per SEND (a
        relayed vote gets THIS hop's origin + wall time), which is
        what makes p2p_gossip_hop_seconds a true per-hop latency."""
        if not self._trace_ctx_on:
            return encode_message(msg)
        return encode_message(
            msg, make_trace_ctx(self._origin(), height, round_)
        )

    def _record_hop(self, peer, msg_type: str, ctx) -> None:
        recv_wall = time.time()
        offset = getattr(getattr(peer, "mconn", None), "clock_offset", None)
        hop = gossip_hop_seconds(recv_wall, ctx.send_wall, offset)
        if self._hop_hist is None:
            hist = p2p_metrics().gossip_hop_seconds
            self._hop_hist = {
                t: hist.labels(message_type=t)
                for t in _HOP_MSG_TYPES.values()
            }
        self._hop_hist[msg_type].observe(hop)
        # paint the hop interval ending at receive; keyed by
        # (height, round, origin) these spans are the stitchable
        # fragments the fleet aggregator joins across rings
        TRACER.add_complete(
            "p2p/recv_hop", time.perf_counter() - hop, hop, cat="p2p",
            args={
                "msg_type": msg_type,
                "origin": ctx.origin[:16],
                "height": ctx.height,
                "round": ctx.round,
                "from_peer": peer.id[:16],
                "send_wall": ctx.send_wall,
                "offset_corrected": offset is not None,
            },
        )

    def wait_sync(self) -> bool:
        return self._wait_sync.is_set()

    def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Called by blocksync when caught up (reactor.go SwitchToConsensus)."""
        self.consensus.update_state_and_start(state)
        self._wait_sync.clear()

    # -- channels -------------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=6,
                              send_queue_capacity=100),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=7,
                              send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2),
        ]

    # -- lifecycle ------------------------------------------------------

    def _spawn(self, target, args, name: str) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        with self._threads_mtx:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def on_start(self) -> None:
        self._subscribe_to_broadcast_events()
        if self.switch is not None:
            # the node's adversary: the equivocator's raw vote-channel
            # broadcast (its conflicting vote never enters its own vote
            # set, so normal gossip cannot carry it)
            self.consensus.byz.register_broadcast(
                lambda raw: self.switch.broadcast(VOTE_CHANNEL, raw)
            )
        if not self.wait_sync():
            if not self.consensus.is_running():
                self.consensus.start()

    def on_stop(self) -> None:
        bus = self.consensus.event_bus
        if bus is not None:
            try:
                bus.unsubscribe_all("consensus-reactor")
            except Exception:  # noqa: BLE001
                pass
        with self._threads_mtx:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)

    def _subscribe_to_broadcast_events(self) -> None:
        """Internal events → p2p broadcasts (reactor.go:377
        subscribeToBroadcastEvents)."""
        bus = self.consensus.event_bus
        if bus is None:
            return
        subs = [
            (EVENT_NEW_ROUND_STEP, self._broadcast_new_round_step),
            (EVENT_VOTE, self._broadcast_has_vote),
            (EVENT_COMPLETE_PROPOSAL, self._broadcast_new_valid_block),
        ]
        for event_type, handler in subs:
            sub = bus.subscribe(
                "consensus-reactor", query_for_event(event_type), capacity=100
            )
            self._spawn(self._event_pump, (sub, handler),
                        f"cs-event-{event_type}")

    def _event_pump(self, sub, handler) -> None:
        while not self._quit.is_set():
            try:
                msg = sub.next(timeout=0.2)
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001 — subscription canceled
                return
            try:
                handler(msg.data)
            except Exception as exc:  # noqa: BLE001
                self.logger.error("broadcast handler error", err=repr(exc))

    # -- broadcasts -----------------------------------------------------

    def _new_round_step_message(self) -> NewRoundStepMessage:
        rs = self.consensus.round_state()
        return NewRoundStepMessage(
            height=rs["height"],
            round=rs["round"],
            step=rs["step"],
            seconds_since_start_time=max(
                0, (now_ns() - rs["start_time_ns"]) // 1_000_000_000
            ),
            last_commit_round=(
                rs["last_commit"].round if rs["last_commit"] else -1
            ),
        )

    def _broadcast_new_round_step(self, _data) -> None:
        if self.switch is not None:
            msg = self._new_round_step_message()
            self.switch.broadcast(STATE_CHANNEL, encode_message(msg))

    def _broadcast_has_vote(self, data) -> None:
        if self.switch is None:
            return
        vote = data.vote
        msg = HasVoteMessage(
            height=vote.height,
            round=vote.round,
            type=vote.type,
            index=vote.validator_index,
        )
        self.switch.broadcast(STATE_CHANNEL, encode_message(msg))

    def _broadcast_new_valid_block(self, _data) -> None:
        if self.switch is None:
            return
        rs = self.consensus.round_state()
        parts = rs["proposal_block_parts"]
        if parts is None:
            return
        msg = NewValidBlockMessage(
            height=rs["height"],
            round=rs["round"],
            block_part_set_header=parts.header,
            block_parts=parts.parts_bit_array.copy(),
            is_commit=rs["step"] == STEP_COMMIT,
        )
        self.switch.broadcast(STATE_CHANNEL, encode_message(msg))

    # -- peer lifecycle --------------------------------------------------

    def init_peer(self, peer):
        peer.set(PEER_STATE_KEY, PeerState(peer.id))
        return peer

    def add_peer(self, peer) -> None:
        ps: PeerState = peer.get(PEER_STATE_KEY)
        for target, tag in (
            (self._gossip_data_routine, "gossip-data"),
            (self._gossip_votes_routine, "gossip-votes"),
            (self._query_maj23_routine, "query-maj23"),
        ):
            self._spawn(target, (peer, ps), f"{tag}-{peer.id[:8]}")
        # tell the peer our current state immediately
        if not self.wait_sync():
            peer.send(
                STATE_CHANNEL, encode_message(self._new_round_step_message())
            )

    # -- receive --------------------------------------------------------

    @trustguard.guarded_seam("consensus_reactor")
    def receive(self, env: Envelope) -> None:
        try:
            msg, ctx = decode_message_traced(env.message)
        except Exception as exc:  # noqa: BLE001
            self.logger.error("malformed consensus msg", err=repr(exc),
                              peer=env.src.id[:10])
            if self.switch is not None:
                self.switch.stop_peer_for_error(env.src, exc)
            return
        if ctx is not None and self._trace_ctx_on:
            hop_type = _HOP_MSG_TYPES.get(type(msg))
            if hop_type is not None:
                self._record_hop(env.src, hop_type, ctx)
        ps: PeerState = env.src.get(PEER_STATE_KEY)
        if ps is None:
            return
        ch = env.channel_id
        cs = self.consensus
        if ch == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                ps.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, VoteSetMaj23Message):
                self._handle_vote_set_maj23(env.src, ps, msg)
        elif ch == DATA_CHANNEL:
            if self.wait_sync():
                return
            if isinstance(msg, ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                # the proposal's origin stamp rides into the state
                # machine so the height tree can record the true
                # network-inclusive start (height/proposal_origin_wall)
                # — unless this node opted out entirely: the escape
                # hatch must reproduce PRE-fleet rings, not just
                # pre-fleet sends
                cs.send_peer_msg(
                    msg, env.src.id,
                    ctx=ctx if self._trace_ctx_on else None,
                )
            elif isinstance(msg, ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round,
                                               msg.part.index)
                cs.send_peer_msg(msg, env.src.id)
        elif ch == VOTE_CHANNEL:
            if self.wait_sync():
                return
            if isinstance(msg, VoteMessage):
                rs = cs.round_state()
                val_size = len(rs["validators"])
                last_size = (
                    rs["last_commit"].bit_array().size
                    if rs["last_commit"]
                    else 0
                )
                ps.ensure_vote_bit_arrays(rs["height"], val_size)
                ps.ensure_vote_bit_arrays(rs["height"] - 1, last_size)
                ps.set_has_vote(msg.vote)
                cs.send_peer_msg(msg, env.src.id)
        elif ch == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                rs = cs.round_state()
                our = None
                if rs["height"] == msg.height:
                    vs = (
                        rs["votes"].prevotes(msg.round)
                        if msg.type == PREVOTE_TYPE
                        else rs["votes"].precommits(msg.round)
                    )
                    if vs is not None:
                        our = vs.bit_array_by_block_id(msg.block_id)
                ps.apply_vote_set_bits(msg, our)

    def _handle_vote_set_maj23(self, peer, ps: PeerState,
                               msg: VoteSetMaj23Message) -> None:
        """(reactor.go Receive StateChannel VoteSetMaj23 case)"""
        cs = self.consensus
        rs = cs.round_state()
        if rs["height"] != msg.height:
            return
        try:
            rs["votes"].set_peer_maj23(msg.round, msg.type, peer.id,
                                       msg.block_id)
        except Exception as exc:  # noqa: BLE001
            if self.switch is not None:
                self.switch.stop_peer_for_error(peer, exc)
            return
        vs = (
            rs["votes"].prevotes(msg.round)
            if msg.type == PREVOTE_TYPE
            else rs["votes"].precommits(msg.round)
        )
        our = (
            vs.bit_array_by_block_id(msg.block_id) if vs is not None else None
        )
        if our is None:
            our = BitArray(0)
        reply = VoteSetBitsMessage(
            height=msg.height, round=msg.round, type=msg.type,
            block_id=msg.block_id, votes=our,
        )
        peer.try_send(VOTE_SET_BITS_CHANNEL, encode_message(reply))

    # -- gossip: data (reactor.go:590) ----------------------------------

    def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        while (
            peer.is_running()
            and self.is_running()
            and not self._quit.is_set()
        ):
            try:
                if self.wait_sync() or not self._gossip_data_once(peer, ps):
                    self._quit.wait(self._gossip_sleep)
            except Exception as exc:  # noqa: BLE001
                self.logger.debug("gossip data error", err=repr(exc))
                self._quit.wait(self._gossip_sleep)

    def _gossip_data_once(self, peer, ps: PeerState) -> bool:
        """One gossip step; returns True if something was sent."""
        rs = self.consensus.round_state()
        prs = ps.snapshot()

        # 1. proposal block parts for the current height/round
        rs_parts = rs["proposal_block_parts"]
        if (
            rs_parts is not None
            and rs["height"] == prs.height
            and prs.proposal_block_parts is not None
            and prs.proposal_block_part_set_header == rs_parts.header
        ):
            missing = rs_parts.parts_bit_array.sub(prs.proposal_block_parts)
            index, ok = missing.pick_random(self._rng)
            if ok:
                part = rs_parts.get_part(index)
                if part is not None:
                    msg = BlockPartMessage(
                        height=rs["height"], round=rs["round"],
                        part=self.consensus.byz.maybe_corrupt_part(part),
                    )
                    if peer.send(
                        DATA_CHANNEL,
                        self._enc(msg, rs["height"], rs["round"]),
                    ):
                        ps.set_has_proposal_block_part(
                            prs.height, prs.round, index
                        )
                    return True

        # 2. catch-up: peer is on an earlier height we have in the store
        block_store = self.consensus.block_store
        if (
            prs.height != 0
            and prs.height < rs["height"]
            and prs.height >= block_store.base()
        ):
            return self._gossip_catchup(peer, ps, prs)

        # 3. the proposal itself — height AND round must match, or
        # set_has_proposal no-ops and we'd re-send without sleeping
        # (reactor.go gossipDataRoutine round guard)
        if (
            rs["proposal"] is not None
            and rs["height"] == prs.height
            and rs["round"] == prs.round
            and not prs.proposal
        ):
            msg = ProposalMessage(proposal=rs["proposal"])
            if peer.send(
                DATA_CHANNEL, self._enc(msg, rs["height"], rs["round"])
            ):
                ps.set_has_proposal(rs["proposal"])
            pol_round = rs["proposal"].pol_round
            if pol_round >= 0:
                pol = rs["votes"].prevotes(pol_round)
                if pol is not None:
                    pol_msg = ProposalPOLMessage(
                        height=rs["height"],
                        proposal_pol_round=pol_round,
                        proposal_pol=pol.bit_array(),
                    )
                    peer.send(DATA_CHANNEL, encode_message(pol_msg))
            return True
        return False

    def _gossip_catchup(self, peer, ps: PeerState,
                        prs: PeerRoundState) -> bool:
        """(reactor.go:780 gossipDataForCatchup)"""
        block_store = self.consensus.block_store
        meta = block_store.load_block_meta(prs.height)
        if meta is None:
            return False
        header = meta.block_id.part_set_header
        if prs.proposal_block_part_set_header != header:
            # init only takes effect when the peer has no parts yet; a
            # peer holding its own round's (different) header must change
            # rounds first — sleep rather than spin (reactor.go:806)
            ps.init_proposal_block_parts(header)
            return False
        if prs.proposal_block_parts is None:
            return False
        have = BitArray(header.total)
        for i in range(header.total):
            have.set_index(i, True)
        missing = have.sub(prs.proposal_block_parts)
        index, ok = missing.pick_random(self._rng)
        if not ok:
            return False
        part = block_store.load_block_part(prs.height, index)
        if part is None:
            return False
        msg = BlockPartMessage(height=prs.height, round=prs.round, part=part)
        if peer.send(DATA_CHANNEL, self._enc(msg, prs.height, prs.round)):
            ps.set_has_proposal_block_part(prs.height, prs.round, index)
        return True

    # -- gossip: votes (reactor.go:650) ---------------------------------

    def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        while (
            peer.is_running()
            and self.is_running()
            and not self._quit.is_set()
        ):
            try:
                if self.wait_sync() or not self._gossip_votes_once(peer, ps):
                    self._quit.wait(self._gossip_sleep)
            except Exception as exc:  # noqa: BLE001
                self.logger.debug("gossip votes error", err=repr(exc))
                self._quit.wait(self._gossip_sleep)

    def _gossip_votes_once(self, peer, ps: PeerState) -> bool:
        rs = self.consensus.round_state()
        prs = ps.snapshot()

        if rs["height"] == prs.height:
            if self._gossip_votes_for_height(peer, ps, rs, prs):
                return True
        # peer one height behind: send our last commit's votes
        if (
            prs.height != 0
            and rs["height"] == prs.height + 1
            and rs["last_commit"] is not None
        ):
            return self._send_vote(peer, ps,
                                   ps.pick_vote_to_send(rs["last_commit"]))
        # peer further behind: reconstruct precommits from the stored commit
        block_store = self.consensus.block_store
        if (
            prs.height != 0
            and rs["height"] >= prs.height + 2
            and block_store.base() <= prs.height <= block_store.height()
        ):
            commit = block_store.load_block_commit(prs.height)
            if commit is not None and prs.catchup_commit_round != commit.round:
                ps.ensure_catchup_commit_round(
                    prs.height, commit.round, len(commit.signatures)
                )
                prs = ps.snapshot()
            if commit is not None and prs.catchup_commit is not None:
                have = BitArray(len(commit.signatures))
                for i, sig in enumerate(commit.signatures):
                    have.set_index(i, bool(sig.signature))
                missing = have.sub(prs.catchup_commit)
                index, ok = missing.pick_random(self._rng)
                if ok:
                    vote = None
                    if self.consensus.state.consensus_params.\
                            vote_extensions_enabled(prs.height):
                        # a reconstructed commit-sig vote has no
                        # extension signature and a VE-enabled receiver
                        # rightly rejects it — serve the stored FULL
                        # precommit (saved atomically with the block)
                        ext = block_store.load_seen_extended_votes(
                            prs.height
                        )
                        if ext is not None and index < len(ext):
                            cand = ext[index]
                            # the seen (extended) round can differ from
                            # the canonical commit round the peer's
                            # catchup set was built for
                            if (
                                cand is not None
                                and cand.round == commit.round
                            ):
                                vote = cand
                    if vote is None:
                        vote = vote_from_commit(commit, index)
                    if vote is not None:
                        msg = VoteMessage(vote=vote)
                        if peer.send(
                            VOTE_CHANNEL,
                            self._enc(msg, vote.height, vote.round),
                        ):
                            with ps._mtx:
                                if ps.prs.catchup_commit is not None:
                                    ps.prs.catchup_commit.set_index(
                                        index, True
                                    )
                            return True
                        return False
        return False

    def _gossip_votes_for_height(self, peer, ps: PeerState, rs: dict,
                                 prs: PeerRoundState) -> bool:
        """(reactor.go gossipVotesForHeight) — ordered preference."""
        votes = rs["votes"]
        # peer establishing its last commit
        if prs.step == STEP_NEW_HEIGHT and rs["last_commit"] is not None:
            if self._send_vote(peer, ps,
                               ps.pick_vote_to_send(rs["last_commit"])):
                return True
        # POL prevotes for peer's proposal
        if prs.step <= STEP_PROPOSE and 0 <= prs.proposal_pol_round:
            pol = votes.prevotes(prs.proposal_pol_round)
            if self._send_vote(peer, ps, ps.pick_vote_to_send(pol)):
                return True
        # round prevotes
        if prs.step <= STEP_PREVOTE_WAIT and 0 <= prs.round <= rs["round"]:
            pv = votes.prevotes(prs.round)
            if self._send_vote(peer, ps, ps.pick_vote_to_send(pv)):
                return True
        # round precommits
        if prs.step <= STEP_PRECOMMIT_WAIT and 0 <= prs.round <= rs["round"]:
            pc = votes.precommits(prs.round)
            if self._send_vote(peer, ps, ps.pick_vote_to_send(pc)):
                return True
        # any old-round prevotes up to our round
        if 0 <= prs.round <= rs["round"]:
            pv = votes.prevotes(prs.round)
            if self._send_vote(peer, ps, ps.pick_vote_to_send(pv)):
                return True
        # POL prevotes even if we've moved on
        if 0 <= prs.proposal_pol_round:
            pol = votes.prevotes(prs.proposal_pol_round)
            if self._send_vote(peer, ps, ps.pick_vote_to_send(pol)):
                return True
        return False

    def _send_vote(self, peer, ps: PeerState, vote: Vote | None) -> bool:
        """Send + mark-on-success (reactor.go PickSendVote): a vote
        dropped by a full queue stays unmarked and is re-picked later."""
        if vote is None:
            return False
        msg = VoteMessage(vote=vote)
        if peer.send(VOTE_CHANNEL, self._enc(msg, vote.height, vote.round)):
            ps.set_has_vote(vote)
            return True
        return False

    # -- query maj23 (reactor.go:716) -----------------------------------

    def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        while (
            peer.is_running()
            and self.is_running()
            and not self._quit.is_set()
        ):
            self._quit.wait(self._maj23_sleep)
            if not peer.is_running() or self.wait_sync():
                continue
            try:
                self._query_maj23_once(peer, ps)
            except Exception as exc:  # noqa: BLE001
                self.logger.debug("query maj23 error", err=repr(exc))

    def _query_maj23_once(self, peer, ps: PeerState) -> None:
        rs = self.consensus.round_state()
        prs = ps.snapshot()
        votes = rs["votes"]
        if rs["height"] != prs.height:
            return
        # our prevote/precommit majorities for the peer's round
        for vote_type, vs in (
            (PREVOTE_TYPE, votes.prevotes(prs.round)),
            (PRECOMMIT_TYPE, votes.precommits(prs.round)),
        ):
            if vs is None:
                continue
            maj23 = vs.two_thirds_majority()
            if maj23 is not None:
                msg = VoteSetMaj23Message(
                    height=prs.height, round=prs.round,
                    type=vote_type, block_id=maj23,
                )
                peer.try_send(STATE_CHANNEL, encode_message(msg))
        # POL majority
        if prs.proposal_pol_round >= 0:
            pol = votes.prevotes(prs.proposal_pol_round)
            if pol is not None:
                maj23 = pol.two_thirds_majority()
                if maj23 is not None:
                    msg = VoteSetMaj23Message(
                        height=prs.height, round=prs.proposal_pol_round,
                        type=PREVOTE_TYPE, block_id=maj23,
                    )
                    peer.try_send(STATE_CHANNEL, encode_message(msg))


__all__ = [
    "ConsensusReactor",
    "PeerState",
    "PeerRoundState",
    "gossip_hop_seconds",
    "vote_from_commit",
    "STATE_CHANNEL",
    "DATA_CHANNEL",
    "VOTE_CHANNEL",
    "VOTE_SET_BITS_CHANNEL",
]
