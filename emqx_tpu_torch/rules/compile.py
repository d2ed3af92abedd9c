"""Rule-predicate compiler: WHERE clauses -> device masks in the serving
launch. The port's copy of `emqx_tpu/rules/compile.py` (`_shash`,
`_Compiler`, `compile_where`, the numpy path of `eval_prog`,
`extract_features`, `CompiledRule`, `DeviceRuleFilter`), bit for bit as
in the original, plus the device half that replaces the JAX trace-time
unrolling:

- `encode_progs`: R compiled programs (hashable tuples of RPN ops) -> one
  int32 opcode/argument array, per-rule offsets and an f32 literal pool
  (`RuleCode`), with each program's stack depth checked against the
  kernel's `STACK_MAX`;
- `rule_code`: the encoded programs as one int32 buffer on a device,
  cached by the programs' value and the device, so `encode_progs` and the
  copy run once a rule set (after `DeviceRuleFilter.refresh` changes it),
  never once a batch;
- `eval_rule_masks`: every rule's WHERE mask over one feature batch in ONE
  launch of the `rule_masks` kernel (`kernels/csrc/rule_masks.cu`): a
  block stages a tile of rows' features, then its warps interpret a group
  of 8 programs over them, a warp a program. A rule-set change is a new
  upload of a few hundred bytes, never a rebuild;
- `eval_rule_masks_plain`, its plain PyTorch twin, which follows the JAX
  trace's arithmetic (`jnp.floor_divide` and `jnp.mod` on floats, null
  semantics) op for op.

Feature schema (host-extracted per batch into one f32 [B, F] matrix + a
validity mask): ``qos``, numeric ``payload.<key>`` lanes and hashed
string-identity lanes for ``topic(N)`` / ``payload.<key>`` equality.
String lanes hash to 24 bits (f32-exact): equal strings always collide,
unequal strings may, so rules carrying a string lane are flagged
``exact=False`` and the engine re-verifies device-passed rows.

Null semantics (as rules/runtime.eval_expr): every numeric node carries a
validity lane; invalid operands poison arithmetic, lose every ordering
comparison, and compare equal only to each other.

The rule engine (`rules/engine.py`) owns a `DeviceRuleFilter` once
`RuleEngine.attach_device` runs: the broker's batches carry its programs
and features into the route launch, and `RuleEngine.fire_settled` consumes
the masks.
"""

from __future__ import annotations

import collections
import json
import threading
import zlib
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.rules.sql import BinOp, Call, InList, Lit, Query, UnOp, Var

# f32 holds 24-bit integers exactly; string identity lanes live there
_HASH_BITS = 0xFFFFFF


def _shash(s) -> float:
    if isinstance(s, bytes):
        s = s.decode("utf-8", "replace")
    return float(zlib.crc32(str(s).encode("utf-8")) & _HASH_BITS)


class _Uncompilable(Exception):
    pass


class _Compiler:
    """AST -> RPN ops. Lane keys: ("num", "qos"), ("num",
    "payload.<k>"), ("str", "payload.<k>"), ("str", "topic.<n>")."""

    def __init__(self, lanes: Dict[Tuple[str, str], int]):
        self.lanes = lanes
        self.ops: List[tuple] = []
        self.exact = True

    def _lane(self, kind: str, name: str) -> int:
        key = (kind, name)
        if key not in self.lanes:
            self.lanes[key] = len(self.lanes)
        if kind == "str":
            self.exact = False
        return self.lanes[key]

    # numeric-producing nodes push ("feat"|"lit"|arith...) ops
    def num(self, node) -> None:
        if isinstance(node, Lit):
            v = node.value
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise _Uncompilable(f"non-numeric literal {v!r}")
            self.ops.append(("lit", float(v)))
            return
        if isinstance(node, Var):
            p = node.path
            if p == ["qos"]:
                self.ops.append(("feat", self._lane("num", "qos")))
                return
            if (
                len(p) == 2 and p[0] == "payload"
                and isinstance(p[1], str)
            ):
                self.ops.append(
                    ("feat", self._lane("num", f"payload.{p[1]}"))
                )
                return
            raise _Uncompilable(f"variable {p!r}")
        if isinstance(node, UnOp) and node.op == "neg":
            self.num(node.operand)
            self.ops.append(("neg",))
            return
        if isinstance(node, BinOp) and node.op in (
            "+", "-", "*", "/", "div", "mod"
        ):
            self.num(node.left)
            self.num(node.right)
            self.ops.append((
                {"+": "add", "-": "sub", "*": "mul", "/": "truediv",
                 "div": "idiv", "mod": "mod"}[node.op],
            ))
            return
        raise _Uncompilable(f"numeric node {type(node).__name__}")

    def _str_operand(self, node) -> None:
        """Push a string-identity feature (hashed lane)."""
        if isinstance(node, Var):
            p = node.path
            if (
                len(p) == 2 and p[0] == "payload"
                and isinstance(p[1], str)
            ):
                self.ops.append(
                    ("feat", self._lane("str", f"payload.{p[1]}"))
                )
                return
        if (
            isinstance(node, Call) and node.name == "topic"
            and len(node.args) == 1 and isinstance(node.args[0], Lit)
            and isinstance(node.args[0].value, int)
        ):
            n = node.args[0].value
            self.ops.append(("feat", self._lane("str", f"topic.{n}")))
            return
        raise _Uncompilable(f"string operand {type(node).__name__}")

    def _eq_pair(self, left, right, neq: bool) -> None:
        """Equality: numeric x numeric, or string-feature x string-lit
        (hashed identity)."""
        lit_str = isinstance(right, Lit) and isinstance(right.value, str)
        lit_str_l = isinstance(left, Lit) and isinstance(left.value, str)
        if lit_str or lit_str_l:
            feat, lit = (left, right) if lit_str else (right, left)
            self._str_operand(feat)
            self.ops.append(("lit", _shash(lit.value)))
        else:
            self.num(left)
            self.num(right)
        self.ops.append(("ne",) if neq else ("eq",))

    # boolean-producing nodes push mask ops
    def boolean(self, node) -> None:
        if isinstance(node, Lit) and isinstance(node.value, bool):
            self.ops.append(("blit", bool(node.value)))
            return
        if isinstance(node, BinOp):
            op = node.op
            if op in ("and", "or"):
                self.boolean(node.left)
                self.boolean(node.right)
                self.ops.append((op,))
                return
            if op in ("=", "!="):
                self._eq_pair(node.left, node.right, op == "!=")
                return
            if op in (">", "<", ">=", "<="):
                self.num(node.left)
                self.num(node.right)
                self.ops.append((
                    {">": "gt", "<": "lt", ">=": "ge", "<=": "le"}[op],
                ))
                return
            raise _Uncompilable(f"operator {op!r}")
        if isinstance(node, UnOp) and node.op == "not":
            self.boolean(node.operand)
            self.ops.append(("not",))
            return
        if isinstance(node, InList):
            # expand to OR of equalities (device has no set primitive);
            # items may be any compilable operand (-3 parses as a neg)
            for i, item in enumerate(node.items):
                self._eq_pair(node.needle, item, neq=False)
                if i:
                    self.ops.append(("or",))
            if node.negated:
                self.ops.append(("not",))
            return
        # numeric node in boolean position: truthiness (non-zero)
        self.num(node)
        self.ops.append(("truthy",))


def compile_where(expr, lanes: Dict[Tuple[str, str], int]):
    """Compile one WHERE AST against a SHARED lane table (lanes grow in
    place so every rule in a set extracts from one feature matrix).

    Returns ``(prog, exact)`` or None when the expression uses anything
    outside the compilable subset. ``prog`` is a hashable tuple of ops —
    the serving jit's static argument, so a rule-set change recompiles
    the program exactly once.
    """
    c = _Compiler(lanes)
    snapshot = dict(lanes)
    try:
        c.boolean(expr)
    except _Uncompilable:
        # roll back lanes this expression introduced before failing
        lanes.clear()
        lanes.update(snapshot)
        return None
    return tuple(c.ops), c.exact


# -- evaluation (ONE interpreter, two array modules) -------------------------


def eval_prog(prog: Sequence[tuple], feats, valid, xp):
    """Evaluate a compiled program over a feature batch.

    feats: f32 [B, F]; valid: bool [B, F]; xp: numpy, the vectorized host
    fallback (the JAX package also passes jax.numpy here at trace time;
    the port's device path is `eval_rule_masks`).

    Stack values are ("n", value, valid) numeric pairs or ("b", mask)
    booleans; null semantics follow rules/runtime.eval_expr (module
    docstring).
    """
    B = feats.shape[0]
    tt = xp.ones(B, bool)
    stack: list = []
    for op in prog:
        tag = op[0]
        if tag == "feat":
            lane = op[1]
            stack.append(("n", feats[:, lane], valid[:, lane]))
        elif tag == "lit":
            stack.append((
                "n", xp.full(B, op[1], np.float32), tt,
            ))
        elif tag == "blit":
            stack.append(("b", tt if op[1] else ~tt))
        elif tag in ("add", "sub", "mul", "truediv", "idiv", "mod"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            ok = va & vb
            if tag == "add":
                r = a + b
            elif tag == "sub":
                r = a - b
            elif tag == "mul":
                r = a * b
            else:
                ok = ok & (b != 0)
                safe = xp.where(b != 0, b, np.float32(1))
                if tag == "truediv":
                    r = a / safe
                elif tag == "idiv":
                    # host: int(a) // int(b) — trunc the operands, floor
                    # the quotient (python // semantics on the ints)
                    r = xp.floor_divide(xp.trunc(a), xp.trunc(safe))
                else:
                    r = xp.mod(xp.trunc(a), xp.trunc(safe))
            stack.append(("n", r, ok))
        elif tag == "neg":
            _, a, va = stack.pop()
            stack.append(("n", -a, va))
        elif tag in ("eq", "ne"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            # None = None is True; None = x is False (runtime._eq)
            eq = xp.where(
                va & vb, a == b, ~va & ~vb
            )
            stack.append(("b", eq if tag == "eq" else ~eq))
        elif tag in ("gt", "lt", "ge", "le"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            ok = va & vb
            if tag == "gt":
                r = a > b
            elif tag == "lt":
                r = a < b
            elif tag == "ge":
                r = a >= b
            else:
                r = a <= b
            stack.append(("b", ok & r))
        elif tag == "truthy":
            _, a, va = stack.pop()
            stack.append(("b", va & (a != 0)))
        elif tag == "not":
            _, m = stack.pop()
            stack.append(("b", ~m))
        elif tag == "and":
            _, m2 = stack.pop()
            _, m1 = stack.pop()
            stack.append(("b", m1 & m2))
        elif tag == "or":
            _, m2 = stack.pop()
            _, m1 = stack.pop()
            stack.append(("b", m1 | m2))
        else:  # pragma: no cover - compiler and interpreter co-evolve
            raise ValueError(f"unknown rule op {tag!r}")
    # the compiler leaves exactly one boolean on the stack
    tag, *rest = stack[-1] if stack else ("b", ~tt)
    if tag == "b":
        return rest[0]
    a, va = rest  # numeric top (bare `WHERE payload.x`): truthiness
    return va & (a != 0)


# -- the device half: encoded programs, the rule_masks kernel and its twin ---

# opcode of each RPN op, as `kernels/csrc/rule_masks.cu` numbers them
OPCODES = {
    name: i for i, name in enumerate((
        "feat", "lit", "blit", "add", "sub", "mul", "truediv", "idiv", "mod",
        "neg", "eq", "ne", "gt", "lt", "ge", "le", "truthy", "not", "and",
        "or",
    ))
}
# per-thread stack of the kernel (entries of (value, valid) or a mask)
STACK_MAX = 64

# stack effect of each op: (popped operand kinds, pushed kind); "n" is a
# numeric (value, valid) pair, "b" a boolean mask
_EFFECT = {
    "feat": ((), "n"), "lit": ((), "n"), "blit": ((), "b"),
    "neg": (("n",), "n"), "truthy": (("n",), "b"), "not": (("b",), "b"),
    "and": (("b", "b"), "b"), "or": (("b", "b"), "b"),
    **{t: (("n", "n"), "n")
       for t in ("add", "sub", "mul", "truediv", "idiv", "mod")},
    **{t: (("n", "n"), "b") for t in ("eq", "ne", "gt", "lt", "ge", "le")},
}


class RuleCode(NamedTuple):
    """R programs encoded for the `rule_masks` kernel: ``code`` int32
    [2 * ops] holds (opcode, argument) pairs, ``offsets`` int32 [R + 1]
    each program's first op, ``lits`` f32 the literal pool; ``depth`` is
    the deepest stack of any program and ``lanes`` one past the highest
    feature lane read."""

    code: np.ndarray
    offsets: np.ndarray
    lits: np.ndarray
    depth: int
    lanes: int


def _check_prog(prog) -> int:
    """The stack depth of one program; raises ValueError on an unknown
    op or an operand of the wrong kind, where the JAX interpreter raises
    too."""
    stack: List[str] = []
    depth = 0
    for op in prog:
        eff = _EFFECT.get(op[0])
        if eff is None:
            raise ValueError(f"unknown rule op {op[0]!r}")
        pops, push = eff
        for want in reversed(pops):
            if not stack or stack.pop() != want:
                raise ValueError(f"rule op {op[0]!r}: malformed program {prog!r}")
        stack.append(push)
        depth = max(depth, len(stack))
    return depth


def encode_progs(progs: Sequence[Sequence[tuple]]) -> RuleCode:
    """Compiled programs -> the kernel's `RuleCode`. A literal is rounded
    as ``np.float32(value)``, as the JAX interpreter's ``xp.full(B, lit,
    np.float32)`` rounds it. A program whose stack would be deeper than
    the kernel's `STACK_MAX` raises ValueError: nothing runs it elsewhere.
    """
    code: List[int] = []
    offsets = [0]
    lits: List[np.float32] = []
    depth = 0
    lanes = 0
    for prog in progs:
        d = _check_prog(prog)
        if d > STACK_MAX:
            raise ValueError(
                f"rule program needs a stack of {d}; the rule_masks kernel "
                f"holds at most {STACK_MAX}"
            )
        depth = max(depth, d)
        for op in prog:
            tag = op[0]
            arg = 0
            if tag == "feat":
                arg = int(op[1])
                if arg < 0:
                    raise ValueError(f"negative feature lane {arg}")
                lanes = max(lanes, arg + 1)
            elif tag == "lit":
                arg = len(lits)
                lits.append(np.float32(op[1]))
            elif tag == "blit":
                arg = 1 if op[1] else 0
            code += [OPCODES[tag], arg]
        offsets.append(len(code) // 2)
    return RuleCode(
        np.asarray(code, np.int32), np.asarray(offsets, np.int32),
        np.asarray(lits, np.float32), depth, lanes,
    )


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round's default (half away from zero); torch.round rounds half
    to even. ``x - trunc(x)`` is exact, inf and NaN pass through."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.floor_divide on floats: `_float_divmod`'s quotient (fmod, the
    exact quotient of what is left, one off where the signs differ, then
    rounded half away from zero). torch.floor_divide is a different
    formula."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return _round_half_away(torch.where(ind, div - 1, div))


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod on floats: fmod, plus b where the signs differ."""
    m = torch.fmod(a, b)
    plus = ((m < 0) != (b < 0)) & (m != 0)
    return torch.where(plus, m + b, m)


def eval_prog_plain(prog: Sequence[tuple], feats: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """One program's mask over the batch (bool [B]): the plain PyTorch
    twin of one thread column of the `rule_masks` kernel, op for op as
    the JAX trace of `eval_prog` computes it."""
    B = feats.shape[0]
    dev = feats.device
    tt = torch.ones(B, dtype=torch.bool, device=dev)
    stack: list = []
    for op in prog:
        tag = op[0]
        if tag == "feat":
            lane = op[1]
            stack.append(("n", feats[:, lane], valid[:, lane]))
        elif tag == "lit":
            stack.append(("n", torch.full((B,), float(np.float32(op[1])),
                                          dtype=torch.float32, device=dev), tt))
        elif tag == "blit":
            stack.append(("b", tt if op[1] else ~tt))
        elif tag in ("add", "sub", "mul", "truediv", "idiv", "mod"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            ok = va & vb
            if tag == "add":
                r = a + b
            elif tag == "sub":
                r = a - b
            elif tag == "mul":
                r = a * b
            else:
                ok = ok & (b != 0)
                safe = torch.where(b != 0, b, torch.ones_like(b))
                if tag == "truediv":
                    r = a / safe
                elif tag == "idiv":
                    r = _floor_divide(torch.trunc(a), torch.trunc(safe))
                else:
                    r = _remainder(torch.trunc(a), torch.trunc(safe))
            stack.append(("n", r, ok))
        elif tag == "neg":
            _, a, va = stack.pop()
            stack.append(("n", -a, va))
        elif tag in ("eq", "ne"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            eq = torch.where(va & vb, a == b, ~va & ~vb)
            stack.append(("b", eq if tag == "eq" else ~eq))
        elif tag in ("gt", "lt", "ge", "le"):
            _, b, vb = stack.pop()
            _, a, va = stack.pop()
            r = {"gt": a > b, "lt": a < b, "ge": a >= b, "le": a <= b}[tag]
            stack.append(("b", va & vb & r))
        elif tag == "truthy":
            _, a, va = stack.pop()
            stack.append(("b", va & (a != 0)))
        elif tag == "not":
            _, m = stack.pop()
            stack.append(("b", ~m))
        elif tag == "and":
            _, m2 = stack.pop()
            _, m1 = stack.pop()
            stack.append(("b", m1 & m2))
        elif tag == "or":
            _, m2 = stack.pop()
            _, m1 = stack.pop()
            stack.append(("b", m1 | m2))
        else:
            raise ValueError(f"unknown rule op {tag!r}")
    tag, *rest = stack[-1] if stack else ("b", ~tt)
    if tag == "b":
        return rest[0]
    a, va = rest
    return va & (a != 0)


# the encoded rule sets kept on their devices, the last used last
RULE_CODE_CACHE_MAX = 4
_rule_code: "collections.OrderedDict[tuple, Tuple[RuleCode, torch.Tensor]]" = (
    collections.OrderedDict())
_rule_code_lock = threading.Lock()
# buffers `rule_code` encoded and placed on a device (each after one
# `encode_progs`)
RULE_CODE_COUNTS = {"uploads": 0}


def rule_code_key(progs, device) -> tuple:
    """The key `rule_code` caches under: the programs by value (the tuple
    of op tuples `compile_where` makes, as it is; any other sequence turned
    into one) and the device. Equal programs share an entry: Python's ==
    merges literals such as 1, 1.0 and True, which encode alike, and 0.0
    with -0.0, whose sign reaches no mask (a division by a zero of either
    sign is invalid, and every other op keeps or drops a zero's sign only)."""
    if isinstance(progs, tuple):
        try:
            hash(progs)
            return progs, torch.device(device)
        except TypeError:
            pass
    return tuple(tuple(tuple(op) for op in p) for p in progs), torch.device(device)


def rule_code(progs, device) -> Tuple[RuleCode, torch.Tensor]:
    """-> (the programs' `RuleCode`, its one int32 buffer on `device`: the
    codes, the offsets, the rules longest program first, then the
    literals' bits), cached by
    `rule_code_key`. `encode_progs` and the copy run only for programs not
    seen on that device among the `RULE_CODE_CACHE_MAX` last used, so a
    serving loop pays them once after each `DeviceRuleFilter.refresh` that
    changes the rule set. The copy to a card goes through pinned memory on
    the current stream and does not block the host."""
    key = rule_code_key(progs, device)
    with _rule_code_lock:
        hit = _rule_code.get(key)
        if hit is not None:
            _rule_code.move_to_end(key)
            return hit
    rc = encode_progs(key[0])
    # the kernel's groups of 8 rules take them longest program first
    order = np.argsort(-np.diff(rc.offsets), kind="stable").astype(np.int32)
    words = np.concatenate([rc.code, rc.offsets, order, rc.lits.view(np.int32)])
    dev = key[1]
    if dev.type == "cuda":
        host = torch.empty(words.size, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = words
        buf = host.to(dev, non_blocking=True)
    else:
        buf = torch.from_numpy(words).to(dev)
    with _rule_code_lock:
        RULE_CODE_COUNTS["uploads"] += 1
        _rule_code[key] = (rc, buf)
        while len(_rule_code) > RULE_CODE_CACHE_MAX:
            _rule_code.popitem(last=False)
    return rc, buf


def _check_inputs(progs, feats, valid) -> Tuple[RuleCode, torch.Tensor]:
    kernels.check_tensor(feats, "feats", torch.float32, 2)
    kernels.check_tensor(valid, "valid", torch.bool, 2)
    if feats.shape != valid.shape:
        raise ValueError(f"feats {tuple(feats.shape)} != valid {tuple(valid.shape)}")
    rc, buf = rule_code(progs, feats.device)
    if rc.lanes > feats.shape[1]:
        raise ValueError(f"a program reads lane {rc.lanes - 1} of {feats.shape[1]} features")
    return rc, buf


def eval_rule_masks_plain(progs, feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of `eval_rule_masks` (any device): bool [R, B]."""
    _check_inputs(progs, feats, valid)
    if not progs:
        return torch.zeros((0, feats.shape[0]), dtype=torch.bool, device=feats.device)
    return torch.stack([eval_prog_plain(p, feats, valid) for p in progs])


def eval_rule_masks(progs, feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Every compiled rule's WHERE mask over one feature batch (kernel
    `rule_masks`): progs, a sequence of R programs from `compile_where`;
    feats f32 [B, F] and valid bool [B, F] from `extract_features` ->
    bool [R, B]. The counterpart of `eval_rule_masks`
    (emqx_tpu/rules/compile.py:318), which unrolls `eval_prog` into the
    serving jit. One launch: a block stages a tile of 32 rows, and its 8
    warps interpret a group of 8 rules over them, longest programs first
    (`kernels/csrc/rule_masks.cu`); any R fits (the 65,535-rule limit of
    the earlier grid is lifted). The encoded programs come from
    `rule_code`: a call with a rule set already on the device encodes and
    copies nothing."""
    rc, buf = _check_inputs(progs, feats, valid)
    if not kernels.on_cuda(feats, valid):
        return eval_rule_masks_plain(progs, feats, valid)
    B, F = feats.shape
    R = len(rc.offsets) - 1
    dev = feats.device
    out = torch.empty((R, B), dtype=torch.bool, device=dev)
    if R == 0 or B == 0:
        return out
    kernels.launch("rule_masks", "emqx_rule_masks", dev, buf.data_ptr(), rc.code.size, R,
                   buf.numel(), rc.depth, feats.data_ptr(), valid.data_ptr(), B, F,
                   out.data_ptr())
    return out


# -- feature extraction ------------------------------------------------------


def _mget(m, key, default=None):
    """Feature source accessor: a Message object (broker batches) or an
    event-context dict (rules/runtime.eval_where_rows) both work."""
    if isinstance(m, dict):
        return m.get(key, default)
    return getattr(m, key, default)


def extract_features(msgs, lanes: Dict[Tuple[str, str], int]):
    """One f32 [B, F] matrix + validity mask + per-row SUSPECT flags
    for a message batch (Message objects or event-context dicts).

    Host-side, loop thread; the payload JSON decodes at most once per
    message and only when some rule declared a payload lane. A numeric
    lane is valid only for REAL numbers; a string/bool/structure value
    marks the ROW suspect instead — the scalar evaluator's coercion
    rules there (numeric strings compare numerically but poison
    arithmetic, bools are identity-only) cannot be mirrored by one f32
    lane, so suspect rows force a PASS and the engine re-verifies them
    with the scalar authority. Well-typed rows (the overwhelming case)
    keep the pure device-rate drop. Message objects additionally carry
    the flag in ``headers["_rule_suspect"]`` so settle-time firing
    needs no re-extraction.
    """
    B, F = len(msgs), len(lanes)
    feats = np.zeros((B, F), np.float32)
    valid = np.zeros((B, F), bool)
    suspect = np.zeros(B, bool)
    keys = list(lanes.items())
    need_payload = any(
        name.startswith("payload.") for (_k, name), _i in keys
    )
    for i, m in enumerate(msgs):
        payload = None
        decoded = False
        for (kind, name), lane in keys:
            if name == "qos":
                q = _mget(m, "qos", 0)
                if isinstance(q, bool) or not isinstance(
                    q, (int, float)
                ):
                    continue
                feats[i, lane] = float(q)
                valid[i, lane] = True
                continue
            if name.startswith("topic."):
                n = int(name[6:])
                toks = str(_mget(m, "topic", "") or "").split("/")
                if 1 <= n <= len(toks):
                    feats[i, lane] = _shash(toks[n - 1])
                    valid[i, lane] = True
                continue
            # payload.<key>
            if need_payload and not decoded:
                decoded = True
                payload = _mget(m, "payload", None)
                if isinstance(payload, (bytes, str)):
                    try:
                        payload = json.loads(payload or b"null")
                    except (ValueError, TypeError):
                        payload = None
            if not isinstance(payload, dict):
                continue
            v = payload.get(name[8:])
            if kind == "str":
                if isinstance(v, (str, bytes)):
                    feats[i, lane] = _shash(v)
                    valid[i, lane] = True
                continue
            if v is None:
                continue  # missing: exact None semantics in-program
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                feats[i, lane] = np.float32(v)
                valid[i, lane] = True
            else:
                # string/bool/structure in a numeric lane: the scalar
                # evaluator's coercion rules decide — flag the row
                suspect[i] = True
        if suspect[i] and not isinstance(m, dict):
            m.headers["_rule_suspect"] = True
    return feats, valid, suspect


class CompiledRule:
    __slots__ = ("rule", "prog", "exact")

    def __init__(self, rule, prog, exact: bool):
        self.rule = rule
        self.prog = prog
        self.exact = exact


class DeviceRuleFilter:
    """The rule set's device-resident half: compiled WHERE programs +
    the shared feature-lane table, refreshed whenever the registry
    changes (rule create/delete/enable toggles).

    A rule compiles when: it is enabled, selects 'message.publish'
    events through plain topic filters (no $events, no FOREACH), and
    its WHERE fits the compilable subset. Everything else stays on the
    scalar hook path untouched.
    """

    def __init__(self):
        self.lanes: Dict[Tuple[str, str], int] = {}
        self.compiled: List[CompiledRule] = []
        self._ids: frozenset = frozenset()

    def refresh(self, rules) -> None:
        lanes: Dict[Tuple[str, str], int] = {}
        out: List[CompiledRule] = []
        for rule in rules:
            q: Query = rule.query
            if not rule.enabled or q.where is None:
                continue
            if q.foreach is not None:
                continue
            if any(t.startswith("$events/") for t in q.topics):
                continue
            res = compile_where(q.where, lanes)
            if res is None:
                continue
            prog, exact = res
            out.append(CompiledRule(rule, prog, exact))
        self.lanes = lanes
        self.compiled = out
        self._ids = frozenset(c.rule.id for c in out)

    @property
    def active(self) -> bool:
        return bool(self.compiled)

    @property
    def progs(self) -> tuple:
        """The serving jit's static argument (hashable; identity keys
        the compiled program, so rule-set churn retraces exactly once)."""
        return tuple(c.prog for c in self.compiled)

    def covers(self, rule_id: str) -> bool:
        return rule_id in self._ids

    def features(self, msgs):
        """(feats, valid) for the device launch; the per-row suspect
        flags land in the message headers (see extract_features)."""
        feats, valid, _suspect = extract_features(msgs, self.lanes)
        return feats, valid

    def host_masks(self, msgs) -> np.ndarray:
        """Vectorized numpy evaluation — the CPU-degraded batch path
        (and the differential reference for the device masks)."""
        if not self.compiled:
            return np.zeros((0, len(msgs)), bool)
        feats, valid, _suspect = extract_features(msgs, self.lanes)
        return np.stack([
            np.asarray(eval_prog(c.prog, feats, valid, np))
            for c in self.compiled
        ])
