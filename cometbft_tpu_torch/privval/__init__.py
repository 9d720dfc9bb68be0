"""Private validator — key management + double-sign protection (a copy
of cometbft_tpu/privval/__init__.py; reference: privval/file.go:164).

``FilePV`` keeps the signing key in one JSON file and the last-signed
state (height/round/step + sign bytes) in another.  The last-sign-state
check is the node's *local* double-sign protection: it refuses to sign
two different messages at the same (height, round, step), persisting
state BEFORE releasing a signature so a crash can't forget a vote.

Its lock is ``utils/sync``'s ``Mutex()``.  Where the port departs from
its reference: the remote signer (``privval/signer.py``) comes later.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
from dataclasses import replace

from cometbft_tpu_torch.crypto import PrivKey, PubKey
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.utils import sync as cmtsync

# Sign-step ordering within a round (privval/file.go:47-51)
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_TYPE_TO_STEP = {
    canonical.PREVOTE_TYPE: STEP_PREVOTE,
    canonical.PRECOMMIT_TYPE: STEP_PRECOMMIT,
}


class PrivValidatorError(Exception):
    pass


class DoubleSignError(PrivValidatorError):
    pass


def _atomic_write(path: str, data: str) -> None:
    """Write-rename so a crash never leaves a torn state file."""
    dir_ = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dir_, prefix=".tmp-privval")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class FilePV:
    """File-backed private validator (privval/file.go:164)."""

    def __init__(
        self,
        priv_key: PrivKey,
        key_file_path: str | None = None,
        state_file_path: str | None = None,
    ):
        self._priv_key = priv_key
        self._key_path = key_file_path
        self._state_path = state_file_path
        self._mtx = cmtsync.Mutex()
        # last sign state (privval/file.go:60 FilePVLastSignState)
        self.height = 0
        self.round = 0
        self.step = 0
        self.signature: bytes | None = None
        self.sign_bytes: bytes | None = None

    # -- construction --------------------------------------------------

    @classmethod
    def generate(cls, key_path: str | None = None, state_path: str | None = None):
        return cls(ed.gen_priv_key(), key_path, state_path)

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        """(privval/file.go LoadOrGenFilePV)"""
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        pv = cls.generate(key_path, state_path)
        pv.save()
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            key_doc = json.load(f)
        priv_raw = base64.b64decode(key_doc["priv_key"]["value"])
        if "ed25519" not in key_doc["priv_key"].get("type", "ed25519").lower():
            raise PrivValidatorError("unsupported key type")
        pv = cls(ed.Ed25519PrivKey(priv_raw), key_path, state_path)
        if os.path.exists(state_path):
            with open(state_path) as f:
                st = json.load(f)
            pv.height = int(st.get("height", 0))
            pv.round = int(st.get("round", 0))
            pv.step = int(st.get("step", 0))
            sig = st.get("signature")
            pv.signature = base64.b64decode(sig) if sig else None
            sb = st.get("signbytes")
            pv.sign_bytes = bytes.fromhex(sb) if sb else None
        return pv

    def save(self) -> None:
        if self._key_path:
            _atomic_write(
                self._key_path,
                json.dumps(
                    {
                        "address": self.address.hex().upper(),
                        "pub_key": {
                            "type": "tendermint/PubKeyEd25519",
                            "value": base64.b64encode(
                                self.pub_key.bytes()
                            ).decode(),
                        },
                        "priv_key": {
                            "type": "tendermint/PrivKeyEd25519",
                            "value": base64.b64encode(
                                self._priv_key.bytes()
                            ).decode(),
                        },
                    },
                    indent=2,
                ),
            )
        self._save_state()

    def _save_state(self) -> None:
        if not self._state_path:
            return
        _atomic_write(
            self._state_path,
            json.dumps(
                {
                    "height": self.height,
                    "round": self.round,
                    "step": self.step,
                    "signature": (
                        base64.b64encode(self.signature).decode()
                        if self.signature
                        else None
                    ),
                    "signbytes": (
                        self.sign_bytes.hex() if self.sign_bytes else None
                    ),
                },
                indent=2,
            ),
        )

    # -- identity ------------------------------------------------------

    @property
    def pub_key(self) -> PubKey:
        return self._priv_key.pub_key()

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def get_pub_key(self) -> PubKey:
        """PrivValidator interface (types/priv_validator.go)."""
        return self.pub_key

    # -- signing -------------------------------------------------------

    def _check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Regression check (privval/file.go:100 CheckHRS).  Returns
        True if this exact HRS was already signed (caller must then
        compare sign bytes)."""
        if self.height > height:
            raise DoubleSignError(
                f"height regression: {self.height} -> {height}"
            )
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}: "
                    f"{self.round} -> {round_}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at {height}/{round_}: "
                        f"{self.step} -> {step}"
                    )
                if self.step == step:
                    if self.sign_bytes is None:
                        raise DoubleSignError(
                            "no sign bytes at same HRS"
                        )
                    return True
        return False

    def sign_vote(
        self, chain_id: str, vote: Vote, with_extension: bool = False
    ) -> Vote:
        """Sign a prevote/precommit (privval/file.go signVote).  On an
        identical re-request (same HRS, sign bytes differing only in
        timestamp) the previous signature is returned instead of
        producing a conflicting one."""
        with self._mtx:
            step = _TYPE_TO_STEP.get(vote.type)
            if step is None:
                raise PrivValidatorError(f"unknown vote type {vote.type}")
            sign_bytes = vote.sign_bytes(chain_id)
            same_hrs = self._check_hrs(vote.height, vote.round, step)
            if same_hrs:
                if sign_bytes == self.sign_bytes:
                    sig = self.signature
                elif self._only_timestamp_differs(sign_bytes, chain_id, vote):
                    # Reuse the previous signature — and restore the
                    # previously signed timestamp into the vote, else the
                    # signature would not verify against the new sign
                    # bytes (privval/file.go:360-368).
                    sig = self.signature
                    vote = replace(
                        vote,
                        timestamp_ns=_timestamp_from_sign_bytes(
                            self.sign_bytes
                        ),
                    )
                else:
                    raise DoubleSignError(
                        "conflicting data at same height/round/step"
                    )
                vote = replace(vote, signature=sig)
                if with_extension and not vote.is_nil():
                    ext_sig = self._priv_key.sign(
                        vote.extension_sign_bytes(chain_id)
                    )
                    vote = replace(vote, extension_signature=ext_sig)
                return vote
            sig = self._priv_key.sign(sign_bytes)
            self.height = vote.height
            self.round = vote.round
            self.step = step
            self.signature = sig
            self.sign_bytes = sign_bytes
            self._save_state()  # persist BEFORE releasing the signature
            vote = replace(vote, signature=sig)
            if with_extension and not vote.is_nil():
                ext_sig = self._priv_key.sign(
                    vote.extension_sign_bytes(chain_id)
                )
                vote = replace(vote, extension_signature=ext_sig)
            return vote

    def _only_timestamp_differs(
        self, new_sign_bytes: bytes, chain_id: str, vote: Vote
    ) -> bool:
        """checkVotesOnlyDifferByTimestamp (privval/file.go:415): the
        re-signed vote may carry a fresh wall-clock timestamp."""
        if self.sign_bytes is None:
            return False
        stripped_new = canonical.vote_sign_bytes(
            chain_id, vote.type, vote.height, vote.round, vote.block_id, 0
        )
        try:
            old = _reparse_with_zero_timestamp(self.sign_bytes)
        except ValueError:
            return False
        return old == stripped_new

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        with self._mtx:
            sign_bytes = proposal.sign_bytes(chain_id)
            same_hrs = self._check_hrs(
                proposal.height, proposal.round, STEP_PROPOSE
            )
            if same_hrs:
                if sign_bytes == self.sign_bytes:
                    return replace(proposal, signature=self.signature)
                raise DoubleSignError(
                    "conflicting proposal at same height/round"
                )
            sig = self._priv_key.sign(sign_bytes)
            self.height = proposal.height
            self.round = proposal.round
            self.step = STEP_PROPOSE
            self.signature = sig
            self.sign_bytes = sign_bytes
            self._save_state()
            return replace(proposal, signature=sig)

    def sign_bytes_raw(self, msg: bytes) -> bytes:
        """Sign arbitrary bytes (p2p handshake, not consensus-gated)."""
        return self._priv_key.sign(msg)


def _strip_length_prefix(sign_bytes: bytes) -> bytes:
    from cometbft_tpu_torch.utils.protoio import decode_uvarint

    n, off = decode_uvarint(sign_bytes)
    payload = sign_bytes[off:]
    if len(payload) != n:
        raise ValueError("bad canonical vote length prefix")
    return payload


def _timestamp_from_sign_bytes(sign_bytes: bytes) -> int:
    """Extract timestamp_ns from a canonical vote encoding."""
    from cometbft_tpu_torch.types.codec import decode_timestamp
    from cometbft_tpu_torch.utils.protoio import ProtoReader

    f = ProtoReader(_strip_length_prefix(sign_bytes)).to_dict()
    return decode_timestamp(f[5][0]) if 5 in f else 0


def _reparse_with_zero_timestamp(sign_bytes: bytes) -> bytes:
    """Rewrite a canonical vote encoding with timestamp zeroed, so two
    encodings can be compared net of timestamps."""
    from cometbft_tpu_torch.utils.protoio import ProtoReader, sfixed64_from_u64

    f = ProtoReader(_strip_length_prefix(sign_bytes)).to_dict()
    vote_type = int(f.get(1, [0])[0])
    height = sfixed64_from_u64(int(f.get(2, [0])[0]))
    round_ = sfixed64_from_u64(int(f.get(3, [0])[0]))
    chain_id = bytes(f.get(6, [b""])[0]).decode()
    from cometbft_tpu_torch.types.block import BlockID, PartSetHeader

    if 4 in f:
        bf = ProtoReader(f[4][0]).to_dict()
        psh = PartSetHeader()
        if 2 in bf:
            pf = ProtoReader(bf[2][0]).to_dict()
            psh = PartSetHeader(
                total=int(pf.get(1, [0])[0]), hash=bytes(pf.get(2, [b""])[0])
            )
        block_id = BlockID(hash=bytes(bf.get(1, [b""])[0]), part_set_header=psh)
    else:
        block_id = BlockID()
    return canonical.vote_sign_bytes(
        chain_id, vote_type, height, round_, block_id, 0
    )
