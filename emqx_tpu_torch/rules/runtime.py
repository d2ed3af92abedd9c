"""Rule SQL evaluator: apply a parsed Query to an event context dict. The
port's copy of `emqx_tpu/rules/runtime.py` (`apply_query`, `eval_expr`)
over the port's `rules/sql.py` AST and `rules/funcs.py`, unchanged but for
those imports; `eval_where_rows` (the vectorised WHERE of a batch of
contexts) is left out: the engine's settle path evaluates batches through
`DeviceRuleFilter` (`rules/compile.py`).

Reference analog: emqx_rule_runtime.erl — select/where evaluation per
event, with the reference's semantics:
- unknown fields evaluate to None ('undefined');
- `payload` is lazily JSON-decoded when a dotted path reaches into it
  (the reference decodes on demand the same way);
- comparisons against None are False except =/!= equality checks;
- FOREACH iterates an array expression, applying DO/INCASE per element;
- un-aliased dotted selects keep their nested shape in the output
  (`SELECT payload.x` -> {"payload": {"x": ...}}).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from emqx_tpu_torch.rules.funcs import CONTEXT_FUNCS, FUNCS, context_flag
from emqx_tpu_torch.rules.sql import (
    BinOp,
    Call,
    Case,
    InList,
    Lit,
    Query,
    SelectItem,
    UnOp,
    Var,
)


class RuleEvalError(Exception):
    pass


def _decode_payload(val):
    if isinstance(val, (bytes, str)):
        try:
            return json.loads(val)
        except (ValueError, TypeError):
            return None
    return val


def _walk(ctx: Dict, path: List[object]):
    cur: Any = ctx
    for i, seg in enumerate(path):
        if cur is None:
            return None
        if isinstance(seg, int):
            if isinstance(cur, (list, tuple)) and 1 <= seg <= len(cur):
                cur = cur[seg - 1]  # SQL arrays are 1-based
            else:
                return None
            continue
        if isinstance(cur, (bytes, str)) and i > 0:
            # dotted access into an undecoded JSON payload string/bytes
            cur = _decode_payload(cur)
        if not isinstance(cur, dict) or seg not in cur:
            return None
        cur = cur[seg]
    return cur


def _truthy(v) -> bool:
    return v is True or v == "true" or (isinstance(v, (int, float)) and not isinstance(v, bool) and v != 0)


def _cmp_values(a, b):
    """Normalize operands: numeric strings compare numerically."""
    if isinstance(a, (int, float)) and not isinstance(a, bool) and isinstance(b, str):
        try:
            return a, float(b)
        except ValueError:
            return a, b
    if isinstance(b, (int, float)) and not isinstance(b, bool) and isinstance(a, str):
        try:
            return float(a), b
        except ValueError:
            return a, b
    if isinstance(a, bytes):
        a = a.decode("utf-8", "replace")
    if isinstance(b, bytes):
        b = b.decode("utf-8", "replace")
    return a, b


def eval_expr(node, ctx: Dict):
    if isinstance(node, Lit):
        return node.value
    if isinstance(node, Var):
        return _walk(ctx, node.path)
    if isinstance(node, UnOp):
        v = eval_expr(node.operand, ctx)
        if node.op == "not":
            return not _truthy(v)
        if node.op == "neg":
            return -v if isinstance(v, (int, float)) else None
    if isinstance(node, InList):
        needle = eval_expr(node.needle, ctx)
        items = [eval_expr(i, ctx) for i in node.items]
        hit = any(_eq(needle, i) for i in items)
        return hit != node.negated
    if isinstance(node, Case):
        for cond, result in node.whens:
            if _truthy(eval_expr(cond, ctx)):
                return eval_expr(result, ctx)
        return eval_expr(node.default, ctx) if node.default is not None else None
    if isinstance(node, Call):
        # zero-arg message-context accessors (clientid(), topic(), ...)
        cf = CONTEXT_FUNCS.get(node.name)
        if cf is not None and not node.args:
            return cf(ctx)
        if node.name == "flag" and len(node.args) == 1:
            return context_flag(ctx, eval_expr(node.args[0], ctx))
        if node.name == "topic" and len(node.args) == 1:
            # topic(N): Nth level of the message topic, 1-based
            # (emqx_rule_funcs.erl topic/1 -> lists:nth over tokens)
            i = eval_expr(node.args[0], ctx)
            toks = str(ctx.get("topic") or "").split("/")
            if isinstance(i, (int, float)) and 1 <= int(i) <= len(toks):
                return toks[int(i) - 1]
            return None
        if node.name == "payload" and len(node.args) == 1:
            # payload(Path): nested get into the (decoded) payload map
            # (emqx_rule_funcs.erl payload/1 -> nested_get(map_path(...)))
            return FUNCS["map_path"](
                eval_expr(node.args[0], ctx), ctx.get("payload")
            )
        fn = FUNCS.get(node.name)
        if fn is None:
            raise RuleEvalError(f"unknown function {node.name!r}")
        return fn(*[eval_expr(a, ctx) for a in node.args])
    if isinstance(node, BinOp):
        op = node.op
        if op == "and":
            return _truthy(eval_expr(node.left, ctx)) and _truthy(
                eval_expr(node.right, ctx)
            )
        if op == "or":
            return _truthy(eval_expr(node.left, ctx)) or _truthy(
                eval_expr(node.right, ctx)
            )
        a = eval_expr(node.left, ctx)
        b = eval_expr(node.right, ctx)
        if op == "=":
            return _eq(a, b)
        if op == "!=":
            return not _eq(a, b)
        if op in (">", "<", ">=", "<="):
            a, b = _cmp_values(a, b)
            try:
                if op == ">":
                    return a > b
                if op == "<":
                    return a < b
                if op == ">=":
                    return a >= b
                return a <= b
            except TypeError:
                return False
        # arithmetic
        if op == "+" and isinstance(a, str) and isinstance(b, str):
            return a + b
        if not isinstance(a, (int, float)) or isinstance(a, bool):
            return None
        if not isinstance(b, (int, float)) or isinstance(b, bool):
            return None
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b if b != 0 else None
        if op == "div":
            return int(a) // int(b) if b != 0 else None
        if op == "mod":
            return int(a) % int(b) if b != 0 else None
    raise RuleEvalError(f"cannot evaluate {node!r}")


def _eq(a, b) -> bool:
    a, b = _cmp_values(a, b)
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    return a == b


def _set_path(out: Dict, path: List[str], value) -> None:
    cur = out
    for seg in path[:-1]:
        nxt = cur.get(seg)
        if not isinstance(nxt, dict):
            nxt = cur[seg] = {}
        cur = nxt
    cur[path[-1]] = value


def _project(selects: Optional[List[SelectItem]], ctx: Dict) -> Dict:
    if selects is None:  # SELECT *
        return {k: v for k, v in ctx.items() if not k.startswith("__")}
    out: Dict = {}
    for item in selects:
        val = eval_expr(item.expr, ctx)
        if item.alias:
            _set_path(out, item.alias, val)
        elif isinstance(item.expr, Var):
            path = [str(p) for p in item.expr.path]
            if path[0] == "payload" and len(path) > 1:
                _set_path(out, path, val)
            else:
                _set_path(out, [path[-1]], val)
        else:
            # un-aliased computed column: reference names it by position
            _set_path(out, [f"${len(out)}"], val)
    return out


def apply_query(q: Query, ctx: Dict) -> Optional[List[Dict]]:
    """Run the query against one event context.

    Returns None if the event doesn't pass WHERE (rule no-match), else the
    list of output rows (1 row for SELECT; N for FOREACH).
    """
    if q.where is not None and not _truthy(eval_expr(q.where, ctx)):
        return None
    if q.foreach is None:
        return [_project(q.selects, ctx)]
    arr = eval_expr(q.foreach, ctx)
    if not isinstance(arr, (list, tuple)):
        return []
    rows = []
    alias = q.foreach_alias or "item"
    for elem in arr:
        row_ctx = dict(ctx)
        row_ctx[alias] = elem
        if q.foreach_alias is None:
            row_ctx["item"] = elem
        if q.incase is not None and not _truthy(eval_expr(q.incase, row_ctx)):
            continue
        if q.selects is None:
            rows.append(elem if isinstance(elem, dict) else {alias: elem})
        else:
            rows.append(_project(q.selects, row_ctx))
    return rows
