"""The port's kernel shape/dtype contracts (cometbft_tpu_torch/ops/
contracts.py and each module's ``_CONTRACTS``), checked without a card
as the reference's tests/test_jitcheck.py checks its own: the grammar's
helpers against the reference's, every port ops/ module and
parallel/mesh.py across the ladder_env sweep, and a planted wrong
contract that must fail."""

import ast
import inspect

import pytest

from cometbft_tpu.ops import contracts as jcontracts
from cometbft_tpu_torch.ops import contracts as CT
from cometbft_tpu_torch.ops import curve, ed25519_verify, field, precompute, scalar, sha512
from cometbft_tpu_torch.parallel import mesh

MODULES = (field, sha512, scalar, curve, precompute, ed25519_verify, mesh)


def test_grammar_matches_reference():
    assert CT.DIM_SYMBOLS == jcontracts.DIM_SYMBOLS
    assert set(CT.DTYPES) == set(jcontracts.DTYPES)
    env = CT.ladder_env(64, 256, window_bits=4, cap=32, ndev=8)
    assert env == jcontracts.ladder_env(64, 256, window_bits=4, cap=32, ndev=8)
    for dim in (7, "B", "104+bucket", "nblocks*128", "cap*nent//ndev", "(B+1)*2-3", "B/ndev"):
        assert CT.eval_dim(dim, env) == jcontracts.eval_dim(dim, env)
        assert CT.dim_names(dim) == jcontracts.dim_names(dim)
    with pytest.raises(ValueError):
        CT.eval_dim("B**2", env)


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_contracts_are_pure_literals_over_the_grammar(module):
    """Each module declares ``_CONTRACTS`` as a literal whose dims use
    only DIM_SYMBOLS and whose functions exist."""
    tree = ast.parse(inspect.getsource(module))
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "_CONTRACTS" for t in n.targets))
    literal = ast.literal_eval(node.value)
    assert literal == module._CONTRACTS and literal

    def leaves(spec):
        if CT.is_leaf(spec):
            yield spec
        else:
            for s in spec:
                yield from leaves(s)

    for name, contract in literal.items():
        assert callable(getattr(module, name))
        assert set(contract) <= {"args", "static", "out", "on"}
        assert contract.get("on", "meta") in ("meta", "cpu")
        for spec in [*contract["args"].values(), contract["out"]]:
            for dtype, shape in leaves(spec):
                assert dtype in CT.DTYPES
                for dim in shape:
                    assert CT.dim_names(dim) <= CT.DIM_SYMBOLS, (name, dim)
        assert set(contract.get("static", ())) <= {"bucket", "nblocks", "window_bits"}


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_contract_at_the_base_rung(module):
    env = CT.ladder_env(8, 128, window_bits=8, cap=16)
    errs = CT.check_module(module, env)
    assert not errs, "\n".join(errs)


@pytest.mark.parametrize("name", ["build_tables_kernel", "comb_mul_keyed"])
def test_window_shaped_contracts_at_4bit(name):
    """Only the window-shaped functions: the others' dims do not mention
    nwin or nent."""
    env = CT.ladder_env(16, 128, window_bits=4, cap=32)
    errs = CT.check_contract(getattr(precompute, name), precompute._CONTRACTS[name], env)
    assert not errs, "\n".join(errs)


def test_keyed_verify_contract_at_4bit():
    env = CT.ladder_env(16, 128, window_bits=4, cap=32)
    c = ed25519_verify._CONTRACTS["verify_keyed_fused"]
    errs = CT.check_contract(ed25519_verify.verify_keyed_fused, c, env)
    assert not errs, "\n".join(errs)


@pytest.mark.parametrize("bucket", [256, 512, 1024, 4096])
def test_bucket_ladder_for_bucket_shaped_functions(bucket):
    env = CT.ladder_env(8, bucket, window_bits=8, cap=16)
    errs = []
    for mod, names in ((ed25519_verify, ("build_padded_input", "keyed_digest")),
                       (sha512, ("sha512_padded", "bytes_to_words"))):
        for name in names:
            errs.extend(CT.check_contract(getattr(mod, name), mod._CONTRACTS[name], env))
    assert not errs, "\n".join(errs)


@pytest.mark.parametrize("ndev, wb, cap", [(8, 4, 64), (3, 8, 24)])
def test_sharded_keyed_contract_across_mesh_shapes(ndev, wb, cap):
    """The shard-local keyed body (dims global // ndev), at a mesh of 8
    and one of 3 shards."""
    env = CT.ladder_env(8 * ndev, 128, window_bits=wb, cap=cap, ndev=ndev)
    errs = CT.check_contract(mesh.verify_keyed_shard, mesh._CONTRACTS["verify_keyed_shard"], env)
    assert not errs, "\n".join(errs)


def test_contract_catches_planted_drift():
    """A wrong contract fails the check (reference test_jitcheck.py:596):
    a dtype, a shape and a leaf count, on meta and on the CPU."""
    env = CT.ladder_env(8, 128)
    bad = {"args": {"s_bytes": ("u8", (32, "B"))}, "static": (), "out": ("i32", ("B",))}
    errs = CT.check_contract(scalar.bytes_lt_l, bad, env)
    assert errs and "dtype" in errs[0]
    bad = {"args": {"b": ("u8", (32, "B"))}, "static": (), "out": ("i32", (32, "B"))}
    errs = CT.check_contract(curve.nibbles_from_bytes_le, bad, env)
    assert errs and "shape" in errs[0]
    bad = dict(ed25519_verify._CONTRACTS["keyed_digest"], out=[("u8", (64, "B"))] * 2)
    errs = CT.check_contract(ed25519_verify.keyed_digest, bad, env)
    assert errs and "output leaves" in errs[0]
    good = dict(ed25519_verify._CONTRACTS["keyed_digest"],
                args={"buf": ("u8", ("100+bucket", "B"))})
    assert CT.check_contract(ed25519_verify.keyed_digest, good, env) == []  # both layouts
    bad = dict(good, args={"buf": ("u8", ("99+bucket", "B"))})
    errs = CT.check_contract(ed25519_verify.keyed_digest, bad, env)
    assert errs and "failed on cpu" in errs[0]
    # a kernel wrapper refuses meta: only a card or the CPU runs it
    errs = CT.check_contract(ed25519_verify.keyed_digest, dict(good, on="meta"), env)
    assert errs and "failed on meta" in errs[0] and "unsupported device meta" in errs[0]
