"""Kernel shape/dtype contracts, checked without a card (the port of
cometbft_tpu/ops/contracts.py).

Every port ``ops/`` module, and parallel/mesh.py, declares its device
functions' input and output shapes and dtypes in a module-level
``_CONTRACTS`` dict of pure literals, in the reference's grammar::

    _CONTRACTS = {
        "keyed_digest": {
            "args": {"buf": ("u8", ("104+bucket", "B"))},
            "static": ("bucket", "nblocks"),
            "out": ("u8", (64, "B")),
        },
    }

- a leaf spec is ``(dtype, shape)``: dtype one of DTYPES, shape a tuple
  of dims; a dim is an int or a string arithmetic expression over
  DIM_SYMBOLS, which :func:`ladder_env` binds (``B``, ``bucket``,
  ``nblocks``, ``NLIMBS``, ``nwin``, ``nent``, ``cap``, ``M``,
  ``ndev``);
- a list groups specs into a tuple-valued argument or output (an
  extended point is four ``("i32", ("NLIMBS", "B"))`` leaves).

Where the port keeps the reference's layout (limbs first, the packed
rows, the window-major comb pages) the spec is the reference's; where
it differs, the port's own.

:func:`check_contract` builds zero tensors from the spec and runs the
function, and diffs the output's leaves against the declared ones.  By
default the tensors are on the ``meta`` device (shapes and dtypes only,
no data), the counterpart of the reference's ``jax.eval_shape``.  A
contract says ``"on": "cpu"`` where that cannot or should not run, and
then runs on the CPU at the smallest rung of the ladder
(:data:`SMALLEST`), on zeros:

- a kernel wrapper runs its plain version only for a CPU tensor and
  refuses any other device but a card (``fe_mul``, ``keyed_digest``,
  ``verify_keyed_fused``, ``build_tables_kernel``, ...);
- a long chain of ops (a decompression, a scalar multiplication): on
  ``meta`` torch runs each op through its Python reference
  implementation, about 15x the CPU's time per op at these sizes (a
  point addition: 102 ms against 7 ms).
"""

from __future__ import annotations

import ast
import functools

DTYPES = {
    "u8": "uint8",
    "i32": "int32",
    "i64": "int64",
    "u64": "uint64",
    "bool": "bool",
}

#: symbols a dim expression may reference (ladder_env binds them); ``ndev``
#: is a mesh's shard count: shard-local contracts (parallel/mesh.py) give
#: their dims as global // ndev
DIM_SYMBOLS = frozenset(
    {"B", "bucket", "nblocks", "NLIMBS", "nwin", "nent", "cap", "M", "ndev"}
)

#: the ladder's smallest batch and pool per shard, where a contract runs
#: on the CPU
SMALLEST = {"B": 8, "cap": 8}


def eval_dim(dim, env: dict) -> int:
    """An int dim, or a string arithmetic expression over DIM_SYMBOLS
    (+ - * // and parentheses; ``/`` resolves as integer division)."""
    if isinstance(dim, int):
        return dim
    node = ast.parse(str(dim), mode="eval").body

    def ev(n) -> int:
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name):
            return int(env[n.id])
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
            if isinstance(n.op, ast.Mult):
                return a * b
            if isinstance(n.op, (ast.FloorDiv, ast.Div)):
                return a // b
        raise ValueError(f"unsupported dim expression: {dim!r}")

    return ev(node)


def dim_names(dim) -> set[str]:
    """The symbols a dim expression references."""
    if isinstance(dim, int):
        return set()
    return {
        n.id
        for n in ast.walk(ast.parse(str(dim), mode="eval"))
        if isinstance(n, ast.Name)
    }


def is_leaf(spec) -> bool:
    return isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[0], str)


def _leaves(spec) -> list[tuple]:
    if is_leaf(spec):
        return [spec]
    out: list[tuple] = []
    for s in spec:
        out.extend(_leaves(s))
    return out


def _dtype(name: str):
    import torch

    return getattr(torch, DTYPES[name])


def _build(spec, env: dict, device):
    """Spec -> a zero tensor (leaf) or a tuple of them (list)."""
    import torch

    if is_leaf(spec):
        dtype, shape = spec
        return torch.zeros(tuple(eval_dim(d, env) for d in shape), dtype=_dtype(dtype),
                           device=device)
    return tuple(_build(s, env, device) for s in spec)


def _flatten(out) -> list:
    if isinstance(out, (tuple, list)):
        leaves: list = []
        for o in out:
            leaves.extend(_flatten(o))
        return leaves
    return [out]


def ladder_env(batch: int, bucket: int = 128, window_bits: int = 8,
               cap: int | None = None, ndev: int = 1) -> dict:
    """The dim bindings for one rung of the batch/bucket ladder, as the
    dispatch path derives them (nblocks from the bucket, nwin/nent from
    the window width, cap the pool's slots, ndev the mesh's shards,
    which divide ``batch`` and ``cap`` as the routing and the placement
    pad them)."""
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops.ed25519_verify import nblocks_for_bucket

    return {
        "B": batch,
        "bucket": bucket,
        "M": bucket,
        "nblocks": nblocks_for_bucket(bucket),
        "NLIMBS": F.NLIMBS,
        "window_bits": window_bits,
        "nwin": 256 // window_bits,
        "nent": 1 << window_bits,
        "cap": cap if cap is not None else batch,
        "ndev": ndev,
    }


def check_contract(fn, contract: dict, env: dict) -> list[str]:
    """Run ``fn`` on inputs built from one contract at one env binding
    (on ``meta``, or on the CPU at the smallest rung for an ``"on":
    "cpu"`` contract).  Returns a list of mismatch descriptions (empty:
    it conforms)."""
    device = contract.get("on", "meta")
    if device == "cpu":
        env = dict(env, B=SMALLEST["B"] * env["ndev"], cap=SMALLEST["cap"] * env["ndev"])
    elif device != "meta":
        raise ValueError(f"{fn.__name__}: a contract runs on 'meta' or 'cpu', not {device!r}")
    # traced args go by keyword, so statics interleaved in a signature
    # (sha512_padded(buf, nblocks, nblocks_lane)) bind right
    args = {name: _build(spec, env, device) for name, spec in contract["args"].items()}
    static = {name: env[name] for name in contract.get("static", ())}
    try:
        got = functools.partial(fn, **static)(**args)
    except Exception as exc:  # noqa: BLE001 -- reported, the sweep goes on
        return [f"{fn.__name__}: failed on {device} at {env}: {exc!r}"]
    got_leaves = _flatten(got)
    want = _leaves(contract["out"])
    if len(got_leaves) != len(want):
        return [f"{fn.__name__}: {len(got_leaves)} output leaves, contract declares "
                f"{len(want)}"]
    errors: list[str] = []
    for i, (leaf, (dtype, shape)) in enumerate(zip(got_leaves, want)):
        want_shape = tuple(eval_dim(d, env) for d in shape)
        if tuple(leaf.shape) != want_shape:
            errors.append(f"{fn.__name__} out[{i}]: shape {tuple(leaf.shape)} != contract "
                          f"{want_shape} (dims {shape}) at {env}")
        if leaf.dtype != _dtype(dtype):
            errors.append(f"{fn.__name__} out[{i}]: dtype {leaf.dtype} != contract "
                          f"{_dtype(dtype)} at {env}")
    return errors


def check_module(module, env: dict) -> list[str]:
    """Every contract a module declares, at one env binding."""
    errors: list[str] = []
    for name, contract in getattr(module, "_CONTRACTS", {}).items():
        errors.extend(check_contract(getattr(module, name), contract, env))
    return errors
