"""The port stands alone: it imports neither jax, nor `cryptography`,
nor any cometbft_tpu module, builds no kernel at import (the one host
library loaded at import is the secret connection's frame pump, as the
reference loads it), and never falls back to the CPU unless asked to."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["cryptography"] = None
    import importlib, pkgutil
    import cometbft_tpu_torch
    for m in pkgutil.walk_packages(cometbft_tpu_torch.__path__, "cometbft_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke
    from cometbft_tpu_torch.ops import _build
    assert set(_build._built) == {"frame_crypto"}, "a kernel was built at import"

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops.ed25519_verify import TorchBatchVerifier
    bv = TorchBatchVerifier(device="cpu", device_min_batch=0)
    expected = []
    for i in range(8):
        priv = ed.priv_key_from_secret(b"iso-%d" % i)
        msg = b"isolated vote %d" % i
        sig = priv.sign(msg)
        if i == 5:
            msg += b"?"
        bv.add(priv.pub_key(), msg, sig)
        expected.append(i != 5)
    ok, results = bv.verify()
    assert results == expected and bv.last_tier == "keyed", results
    host = TorchBatchVerifier(device="cpu")   # the CPU sentinel: the host tier
    for p, m, s in zip(bv._pubs, bv._msgs, bv._sigs):
        host.add(ed.Ed25519PubKey(p), m, s)
    assert host.verify() == (False, expected) and host.last_tier == "host"
    for name in ("crypto.dispatch", "crypto.health", "crypto.ed25519_native", "metrics",
                 "utils.flight", "utils.metrics", "utils.service", "utils.trace",
                 "crypto.verify_queue", "parallel.mesh", "ops.jitguard", "ops.contracts",
                 "p2p", "p2p.base_reactor", "p2p.conn.connection", "abci", "abci.types",
                 "abci.codec", "abci.kvstore", "proxy", "mempool", "mempool.ingest",
                 "blocksync", "blocksync.pool", "blocksync.reactor", "state.execution",
                 "types.event_bus", "utils.pubsub", "utils.fail", "utils.flowrate",
                 "p2p.key", "p2p.netaddr", "p2p.node_info", "p2p.conn.frame_native",
                 "p2p.conn.handshake_crypto", "p2p.conn.secret_connection", "p2p.peer",
                 "p2p.transport", "p2p.switch", "p2p.test_util", "config", "privval", "wal",
                 "consensus", "consensus.ticker", "consensus.messages",
                 "consensus.height_vote_set", "consensus.replay", "consensus.state",
                 "consensus.reactor", "mempool.reactor", "evidence", "evidence.pool",
                 "evidence.reactor", "consensus.byz", "wal.autofile", "state.determinism",
                 "statesync", "statesync.messages", "statesync.reactor",
                 "statesync.stateprovider", "statesync.syncer", "utils.sync",
                 "utils.trustguard", "utils.critpath", "utils.fleetobs", "p2p.conn.netem",
                 "p2p.pex", "p2p.pex.addrbook", "p2p.pex.reactor", "abci.server",
                 "abci.client", "abci.grpc", "abci.grammar", "privval.signer",
                 "state.txindex", "state.pruner"):
        assert "cometbft_tpu_torch." + name in sys.modules, name
    leaked = sorted(m for m in sys.modules
                    if m == "cometbft_tpu" or m.startswith("cometbft_tpu."))
    assert not leaked, leaked
    assert sys.modules["jax"] is None and sys.modules["cryptography"] is None
    print("ISOLATED-OK")
    """
)


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def _imports(path: str) -> set:
    """The top-level package names a source file imports, anywhere in it."""
    import ast

    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_only_the_grpc_transport_imports_grpc():
    """abci/grpc.py is the one port module that imports grpc (the proxy
    imports it only for a grpc:// app); the app and the signer processes
    import no torch."""
    root = os.path.join(REPO, "cometbft_tpu_torch")
    users = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, files in os.walk(root) for f in files
                   if f.endswith(".py") and "grpc" in _imports(os.path.join(d, f)))
    assert users == ["abci/grpc.py"]
    child = ("import sys, cometbft_tpu_torch.abci.server, cometbft_tpu_torch.abci.kvstore, "
             "cometbft_tpu_torch.abci.grammar, cometbft_tpu_torch.privval.signer; "
             "print(sorted(m for m in ('torch', 'numpy', 'jax', 'grpc') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", child], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "[]"


def test_no_silent_cpu_fallback(monkeypatch):
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.utils.env import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk = ed.Ed25519PubKey(bytes(32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_batch_verifier(pk)
    with pytest.raises(RuntimeError):
        create_batch_verifier(pk, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert create_batch_verifier(pk, device="cpu").device.type == "cpu"


def test_consensus_entry_points_need_a_card_or_device_cpu(monkeypatch):
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.consensus import ConsensusState, Handshaker
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.proxy import local_client_creator, new_app_conns
    from cometbft_tpu_torch.state import State, Store
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils.db import MemDB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = GenesisDoc(chain_id="iso", validators=(
        GenesisValidator(ed.priv_key_from_secret(b"iso").pub_key(), 10),))
    conns = new_app_conns(local_client_creator(KVStoreApp()))
    states, blocks, state = Store(MemDB()), BlockStore(MemDB()), State.from_genesis(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CListMempool(conns.mempool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Handshaker(states, state, blocks, gen)
    mp = CListMempool(conns.mempool, device="cpu")
    ex = BlockExecutor(states, conns.consensus, mp, block_store=blocks, device="cpu")
    cfg = test_config().consensus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusState(cfg, state, ex, blocks)
    assert ConsensusState(cfg, state, ex, blocks, device="cpu").device.type == "cpu"
    ex.device = torch.device("cuda", 0)       # an executor on another device
    with pytest.raises(ValueError, match="executor"):
        ConsensusState(cfg, state, ex, blocks, device="cpu")


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_env_readers_reject_malformed_values(monkeypatch):
    from cometbft_tpu_torch.utils import env

    monkeypatch.setenv("X_INT", "25x")
    with pytest.raises(ValueError, match="X_INT"):
        env.int_from_env("X_INT", 256)
    monkeypatch.setenv("X_INT", "-1")
    with pytest.raises(ValueError):
        env.int_from_env("X_INT", 256)
    monkeypatch.setenv("CMT_TPU_DEBUG_CHECKS", "yes")
    with pytest.raises(ValueError):
        env.flag_from_env("CMT_TPU_DEBUG_CHECKS")
    monkeypatch.setenv("CMT_TPU_DEBUG_CHECKS", "1")
    assert env.flag_from_env("CMT_TPU_DEBUG_CHECKS")
    with pytest.raises(ValueError):
        monkeypatch.setenv("X_CHOICE", "c")
        env.choice_from_env("X_CHOICE", "a", ("a", "b"))
    monkeypatch.delenv("X_CHOICE")
    assert env.choice_from_env("X_CHOICE", "a", ("a", "b")) == "a"


def test_library_name_tracks_shared_headers(monkeypatch, tmp_path):
    """A kernel library's name hashes its source, every csrc/*.cuh and
    the flags: an edit to the shared field.cuh renames the library of
    every source that includes it, so a stale build is never loaded."""
    import shutil

    from cometbft_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {name: _build._target(name)[1] for name in _build.SOURCES}
    assert _build._target("field")[0] == str(csrc / "field.cu")
    header = csrc / "field.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.SOURCES}
    assert all(after[n] != before[n] for n in ("field", "verify_keyed"))
    header.write_bytes(header.read_bytes()[: -len(b"\n// edited\n")])
    assert {name: _build._target(name)[1] for name in _build.SOURCES} == before
