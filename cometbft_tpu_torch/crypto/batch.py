"""Batch-verifier factory (counterpart of cometbft_tpu/crypto/batch.py;
reference crypto/batch/batch.go:10).

``create_batch_verifier`` returns the device verifier on ``cuda`` unless
the caller passes another device; without a card it raises (the
reference's factory hands out a host verifier when no device is usable,
the silent fallback the port does not make).  When the device probe has
counted more than one card (``device_status()["ndev"] > 1``), a caller
on ``cuda`` gets the mesh verifier over every card
(parallel/mesh.py ``ShardedTorchBatchVerifier``); a one-card machine, a
named card (``cuda:1``) and ``device="cpu"`` get ``TorchBatchVerifier``.

``device_status()`` is the health plane's read-only view of the device
probe: ``probe_device()`` counts the cards in a subprocess
(``torch.cuda.device_count()``), so a wedged CUDA runtime costs its timeout,
never a hang of the caller.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable

from cometbft_tpu_torch.crypto import BatchVerifier, PubKey
from cometbft_tpu_torch.crypto import ed25519 as _ed
from cometbft_tpu_torch.utils import sync as cmtsync

#: how long the device probe's subprocess may take
PROBE_TIMEOUT_S = 60.0

_probe_lock = cmtsync.Mutex()
_device_state = {"status": "unknown", "ndev": 0}


def _ed25519_factory(device=None) -> BatchVerifier:
    from cometbft_tpu_torch.ops.ed25519_verify import TorchBatchVerifier

    if (device is None or str(device) == "cuda") and device_status()["ndev"] > 1:
        from cometbft_tpu_torch.parallel.mesh import ShardedTorchBatchVerifier, flat_mesh

        return ShardedTorchBatchVerifier(mesh=flat_mesh())
    return TorchBatchVerifier(device=device)


REGISTRY: dict[str, Callable[..., BatchVerifier]] = {
    _ed.KEY_TYPE: _ed25519_factory,
}


def create_batch_verifier(pub_key: PubKey, device=None) -> BatchVerifier:
    """A batch verifier for ``pub_key``'s type on ``device`` (``cuda``
    unless the caller passes another; raises without a card unless
    ``device="cpu"``).  KeyError for key types without a batch
    implementation."""
    return REGISTRY[pub_key.type()](device)


def supports_batch_verifier(pub_key: PubKey | None) -> bool:
    return pub_key is not None and pub_key.type() in REGISTRY


def probe_device(timeout_s: float = PROBE_TIMEOUT_S) -> dict:
    """Count the visible cards in a subprocess and record the result
    (status ``ready`` with ``ndev`` >= 1, else ``failed``) -> the new
    ``device_status()``."""
    with _probe_lock:
        _device_state["status"] = "probing"
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=timeout_s,
        )
        ndev = int(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else 0
    except (subprocess.TimeoutExpired, ValueError, IndexError):
        ndev = 0
    with _probe_lock:
        _device_state["ndev"] = ndev
        _device_state["status"] = "ready" if ndev > 0 else "failed"
    return device_status()


def device_status() -> dict:
    """{"status": unknown | probing | ready | failed, "ndev": cards
    counted}: a read-only snapshot, never a probe."""
    with _probe_lock:
        return dict(_device_state)
