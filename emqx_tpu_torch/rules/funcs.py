"""Built-in SQL functions for the rule engine: the port's copy of
`emqx_tpu/rules/funcs.py` (`FUNCS`, `CONTEXT_FUNCS`), unchanged below
this docstring but for the topic module it imports (the port's own).

Reference analog: emqx_rule_funcs.erl (~200 functions). This library covers
the families its test suite exercises: arithmetic, comparison helpers,
strings, maps/arrays, type conversion, JSON, hashing/encoding, time,
and id generation. Functions are total: bad input returns None (the
reference raises and fails the rule; we fail the row the same way by
letting real errors propagate only for arity mistakes).
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import re
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

FUNCS: Dict[str, Callable] = {}


def func(*names):
    def deco(f):
        for n in names:
            FUNCS[n] = f
        return f

    return deco


def _num(x) -> Optional[float]:
    if isinstance(x, bool):
        return None
    if isinstance(x, (int, float)):
        return x
    try:
        f = float(x)
        return int(f) if f.is_integer() else f
    except (TypeError, ValueError):
        return None


def _s(x) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if x is None:
        return ""
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


# -- arithmetic / math -------------------------------------------------------

@func("abs")
def _abs(x):
    n = _num(x)
    return None if n is None else abs(n)


@func("ceil")
def _ceil(x):
    n = _num(x)
    return None if n is None else math.ceil(n)


@func("floor")
def _floor(x):
    n = _num(x)
    return None if n is None else math.floor(n)


@func("round")
def _round(x):
    n = _num(x)
    return None if n is None else round(n)


@func("sqrt")
def _sqrt(x):
    n = _num(x)
    return None if n is None or n < 0 else math.sqrt(n)


@func("power", "pow")
def _pow(x, y):
    a, b = _num(x), _num(y)
    return None if a is None or b is None else a**b

@func("exp")
def _exp(x):
    n = _num(x)
    return None if n is None else math.exp(n)


@func("log")
def _log(x):
    n = _num(x)
    return None if n is None or n <= 0 else math.log(n)


@func("random")
def _random():
    import random

    return random.random()


@func("range")
def _range(a, b):
    x, y = _num(a), _num(b)
    if x is None or y is None:
        return None
    return list(range(int(x), int(y) + 1))


# -- strings -----------------------------------------------------------------

@func("lower")
def _lower(s):
    return _s(s).lower()


@func("upper")
def _upper(s):
    return _s(s).upper()


@func("trim")
def _trim(s):
    return _s(s).strip()


@func("ltrim")
def _ltrim(s):
    return _s(s).lstrip()


@func("rtrim")
def _rtrim(s):
    return _s(s).rstrip()


@func("reverse")
def _reverse(s):
    if isinstance(s, list):
        return s[::-1]
    return _s(s)[::-1]


@func("strlen")
def _strlen(s):
    return len(_s(s))


@func("substr")
def _substr(s, start, length=None):
    st = int(_num(start) or 0)
    text = _s(s)
    return text[st:] if length is None else text[st : st + int(_num(length) or 0)]


@func("split")
def _split(s, sep=" "):
    return [p for p in _s(s).split(_s(sep)) if p != ""]


@func("concat")
def _concat(*parts):
    if parts and all(isinstance(p, list) for p in parts):
        out: List = []
        for p in parts:
            out.extend(p)
        return out
    return "".join(_s(p) for p in parts)


@func("pad")
def _pad(s, width, side="trailing", char=" "):
    text, w, c = _s(s), int(_num(width) or 0), _s(char) or " "
    if side == "leading":
        return text.rjust(w, c[0])
    if side == "both":
        return text.center(w, c[0])
    return text.ljust(w, c[0])


@func("replace")
def _replace(s, old, new):
    return _s(s).replace(_s(old), _s(new))


@func("regex_match")
def _regex_match(s, pattern):
    try:
        return re.search(_s(pattern), _s(s)) is not None
    except re.error:
        return None


@func("regex_replace")
def _regex_replace(s, pattern, repl):
    try:
        return re.sub(_s(pattern), _s(repl), _s(s))
    except re.error:
        return None


@func("ascii")
def _ascii(s):
    text = _s(s)
    return ord(text[0]) if text else None


@func("find")
def _find(s, sub, direction="leading"):
    text, needle = _s(s), _s(sub)
    i = text.find(needle) if direction == "leading" else text.rfind(needle)
    return text[i:] if i >= 0 else ""


@func("tokens")
def _tokens(s, seps):
    parts = re.split("[" + re.escape(_s(seps)) + "]", _s(s))
    return [p for p in parts if p]


@func("sprintf")
def _sprintf(fmt, *args):
    # Erlang io_lib ~s/~p/~w -> python format
    out, i = [], 0
    fmt = _s(fmt)
    j = 0
    while j < len(fmt):
        if fmt[j] == "~" and j + 1 < len(fmt):
            c = fmt[j + 1]
            if c in "spw":
                out.append(_s(args[i]) if i < len(args) else "")
                i += 1
                j += 2
                continue
            if c == "n":
                out.append("\n")
                j += 2
                continue
        out.append(fmt[j])
        j += 1
    return "".join(out)


# -- maps / arrays -----------------------------------------------------------

@func("map_get", "mget")
def _map_get(key, m, default=None):
    if isinstance(m, dict):
        return m.get(_s(key), default)
    return default


@func("map_put", "mput")
def _map_put(key, value, m):
    if not isinstance(m, dict):
        m = {}
    out = dict(m)
    out[_s(key)] = value
    return out


@func("map_keys")
def _map_keys(m):
    return list(m.keys()) if isinstance(m, dict) else None


@func("map_values")
def _map_values(m):
    return list(m.values()) if isinstance(m, dict) else None


@func("nth")
def _nth(i, arr):
    n = _num(i)
    if n is None or not isinstance(arr, (list, tuple)):
        return None
    idx = int(n) - 1  # 1-based (reference Erlang lists:nth)
    return arr[idx] if 0 <= idx < len(arr) else None


@func("length")
def _length(x):
    if isinstance(x, (list, tuple, dict)):
        return len(x)
    return len(_s(x))


@func("sublist")
def _sublist(a, b, c=None):
    """sublist(Len, Array) or sublist(Start, Len, Array), 1-based
    (reference lists:sublist argument order)."""
    if c is None:
        length, arr = a, b
        if not isinstance(arr, (list, tuple)):
            return None
        return list(arr[: int(_num(length) or 0)])
    start, length, arr = a, b, c
    if not isinstance(arr, (list, tuple)):
        return None
    st = int(_num(start) or 1) - 1
    return list(arr[st : st + int(_num(length) or 0)])


@func("first")
def _first(arr):
    return arr[0] if isinstance(arr, (list, tuple)) and arr else None


@func("last")
def _last(arr):
    return arr[-1] if isinstance(arr, (list, tuple)) and arr else None


@func("contains")
def _contains(item, arr):
    return item in arr if isinstance(arr, (list, tuple)) else None


@func("zip")
def _zip(a, b):
    if isinstance(a, list) and isinstance(b, list):
        return [list(p) for p in zip(a, b)]
    return None


# -- type conversion / checks ------------------------------------------------

@func("str", "str_utf8")
def _str(x):
    if isinstance(x, (dict, list)):
        return json.dumps(x)
    return _s(x)


@func("int")
def _int(x):
    n = _num(x)
    return None if n is None else int(n)


@func("float")
def _float(x):
    n = _num(x)
    return None if n is None else float(n)


@func("bool")
def _bool(x):
    if isinstance(x, bool):
        return x
    if x in (0, 1):
        return bool(x)
    if _s(x).lower() in ("true", "false"):
        return _s(x).lower() == "true"
    return None


@func("is_null")
def _is_null(x):
    return x is None


@func("is_not_null")
def _is_not_null(x):
    return x is not None


@func("is_num")
def _is_num(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@func("is_int")
def _is_int(x):
    return isinstance(x, int) and not isinstance(x, bool)


@func("is_float")
def _is_float(x):
    return isinstance(x, float)


@func("is_str")
def _is_str(x):
    return isinstance(x, str)


@func("is_bool")
def _is_bool(x):
    return isinstance(x, bool)


@func("is_map")
def _is_map(x):
    return isinstance(x, dict)


@func("is_array")
def _is_array(x):
    return isinstance(x, list)


@func("coalesce")
def _coalesce(*args):
    for a in args:
        if a is not None:
            return a
    return None


@func("iif")
def _iif(cond, then, otherwise):
    return then if cond in (True, 1, "true") else otherwise


# -- JSON --------------------------------------------------------------------

@func("json_encode")
def _json_encode(x):
    try:
        return json.dumps(x)
    except (TypeError, ValueError):
        return None


@func("json_decode")
def _json_decode(x):
    try:
        return json.loads(_s(x))
    except (TypeError, ValueError):
        return None


# -- hashing / encoding ------------------------------------------------------

def _bytes(x) -> bytes:
    return x if isinstance(x, bytes) else _s(x).encode()


@func("md5")
def _md5(x):
    return hashlib.md5(_bytes(x)).hexdigest()


@func("sha")
def _sha(x):
    return hashlib.sha1(_bytes(x)).hexdigest()


@func("sha256")
def _sha256(x):
    return hashlib.sha256(_bytes(x)).hexdigest()


@func("crc32")
def _crc32(x):
    import zlib

    return zlib.crc32(_bytes(x))


@func("base64_encode")
def _b64e(x):
    return base64.b64encode(_bytes(x)).decode()


@func("base64_decode")
def _b64d(x):
    try:
        return base64.b64decode(_s(x)).decode("utf-8", "replace")
    except (ValueError, TypeError):
        return None


@func("hexstr")
def _hexstr(x):
    return _bytes(x).hex()


@func("bitand")
def _bitand(a, b):
    return int(_num(a) or 0) & int(_num(b) or 0)


@func("bitor")
def _bitor(a, b):
    return int(_num(a) or 0) | int(_num(b) or 0)


@func("bitxor")
def _bitxor(a, b):
    return int(_num(a) or 0) ^ int(_num(b) or 0)


@func("bitnot")
def _bitnot(a):
    return ~int(_num(a) or 0)


@func("bitsl")
def _bitsl(a, n):
    return int(_num(a) or 0) << int(_num(n) or 0)


@func("bitsr")
def _bitsr(a, n):
    return int(_num(a) or 0) >> int(_num(n) or 0)


# -- time / ids --------------------------------------------------------------

@func("now_timestamp")
def _now_timestamp(unit="second"):
    t = time.time()
    if unit == "millisecond":
        return int(t * 1000)
    if unit == "microsecond":
        return int(t * 1e6)
    return int(t)


@func("unix_ts_to_rfc3339")
def _ts_to_rfc3339(ts, unit="second"):
    import datetime

    n = _num(ts)
    if n is None:
        return None
    if unit == "millisecond":
        n = n / 1000.0
    return (
        datetime.datetime.fromtimestamp(n, datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


@func("rfc3339_to_unix_ts")
def _rfc3339_to_ts(s):
    import datetime

    try:
        return int(
            datetime.datetime.fromisoformat(
                _s(s).replace("Z", "+00:00")
            ).timestamp()
        )
    except ValueError:
        return None


@func("uuid_v4", "uuid")
def _uuid():
    return str(uuid.uuid4())


@func("timezone_to_second")
def _tz_to_s(tz):
    s = _s(tz)
    if s in ("Z", "z", "+00:00"):
        return 0
    m = re.match(r"([+-])(\d\d):?(\d\d)", s)
    if not m:
        return None
    sign = 1 if m.group(1) == "+" else -1
    return sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)


# -- trig / extra math (emqx_rule_funcs.erl math family) ---------------------

for _name in (
    "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "log2", "log10",
):
    def _mk(fname):
        mf = getattr(math, fname)

        def _f(x, _mf=mf):
            v = _num(x)
            try:
                return _mf(v) if v is not None else None
            except ValueError:
                return None

        return _f

    FUNCS[_name] = _mk(_name)
del _name, _mk


@func("mod")
def _mod(x, y):
    a, b = _num(x), _num(y)
    if a is None or b is None or int(b) == 0:
        return None
    return int(a) % int(b)


@func("fmod")
def _fmod(x, y):
    a, b = _num(x), _num(y)
    if a is None or b in (None, 0):
        return None
    return math.fmod(a, b)


@func("eq")
def _eq_fn(a, b):
    # same semantics as the SQL '=' operator (runtime._eq): bools only
    # equal themselves, numbers/strings compare through coercion
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None:
        return na == nb
    return a == b


# -- binaries / encoding -----------------------------------------------------


@func("bin2hexstr")
def _bin2hexstr(b):
    if isinstance(b, str):
        b = b.encode()
    return b.hex() if isinstance(b, bytes) else None


@func("hexstr2bin")
def _hexstr2bin(s):
    try:
        return bytes.fromhex(_s(s))
    except ValueError:
        return None


@func("hash")
def _hash(alg, data):
    alg = _s(alg).lower()
    if isinstance(data, str):
        data = data.encode()
    if not isinstance(data, bytes):
        data = _s(data).encode()
    try:
        return hashlib.new(alg, data).hexdigest()
    except ValueError:
        return None


@func("bitsize")
def _bitsize(b):
    if isinstance(b, str):
        b = b.encode()
    return len(b) * 8 if isinstance(b, bytes) else None


@func("subbits", "get_subbits")
def _subbits(b, *args):
    """subbits(bytes, len) / subbits(bytes, start, len): big-endian
    unsigned integer slice (emqx_rule_funcs subbits default mode)."""
    if isinstance(b, str):
        b = b.encode()
    if not isinstance(b, bytes):
        return None
    nums = [_num(a) for a in args]
    if any(v is None for v in nums) or not nums:
        return None
    if len(nums) == 1:
        start, ln = 1, int(nums[0])
    else:
        start, ln = int(nums[0]), int(nums[1])
    bits = int.from_bytes(b, "big")
    total = len(b) * 8
    lo = total - (start - 1) - ln
    if lo < 0 or ln <= 0:
        return None
    return (bits >> lo) & ((1 << ln) - 1)


# -- topic helpers -----------------------------------------------------------


@func("contains_topic")
def _contains_topic(topics, topic):
    if not isinstance(topics, list):
        return False
    return any(_s(t) == _s(topic) for t in topics)


@func("contains_topic_match")
def _contains_topic_match(filters, topic):
    from emqx_tpu_torch.ops import topics as _T

    if not isinstance(filters, list):
        return False
    return any(_T.match(_s(topic), _s(f)) for f in filters)


@func("find_topic_filter")
def _find_topic_filter(filters, topic):
    from emqx_tpu_torch.ops import topics as _T

    if not isinstance(filters, list):
        return None
    for f in filters:
        if _T.match(_s(topic), _s(f)):
            return f
    return None


# -- strings / maps extras ---------------------------------------------------


@func("find_s")
def _find_s(s, sub):
    """Suffix of `s` from the first occurrence of `sub` ('' if absent)."""
    s, sub = _s(s), _s(sub)
    i = s.find(sub)
    return "" if i < 0 else s[i:]


@func("sprintf_s")
def _sprintf_s(fmt, *args):
    """Erlang io_lib-style ~s/~p/~w formatting subset."""
    out = []
    it = iter(args)
    i = 0
    fmt = _s(fmt)
    while i < len(fmt):
        c = fmt[i]
        if c == "~" and i + 1 < len(fmt):
            d = fmt[i + 1]
            if d in ("s", "p", "w"):
                try:
                    v = next(it)
                except StopIteration:
                    return None
                out.append(_s(v) if d == "s" else json.dumps(v, default=str))
                i += 2
                continue
            if d == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


@func("map_new")
def _map_new():
    return {}


@func("map_path", "mget_path")
def _map_path(path, m):
    """Dotted-path get (map_path("a.b.c", m))."""
    cur = m
    for seg in _s(path).split("."):
        if isinstance(cur, (str, bytes)):
            try:
                cur = json.loads(cur)
            except (ValueError, TypeError):
                return None
        if not isinstance(cur, dict) or seg not in cur:
            return None
        cur = cur[seg]
    return cur


@func("null")
def _null():
    return None


@func("now_rfc3339")
def _now_rfc3339(unit="second"):
    t = time.time()
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
    u = _s(unit)
    if u == "millisecond":
        return f"{base}.{int(t * 1e3) % 1000:03d}Z"
    if u == "microsecond":
        return f"{base}.{int(t * 1e6) % 1000000:06d}Z"
    return base + "Z"


# -- rule-engine KV store / proc dict (emqx_rule_funcs kv_store_*,
#    proc_dict_* — cross-rule persistent scratch state) ----------------------

# NOTE scope divergence vs the reference: emqx scopes proc_dict_* to the
# rule's process while kv_store_* is node-global; this runtime evaluates
# all rules on one loop, so both are node-global (separate namespaces).
_KV_STORE: Dict[str, Any] = {}
_PROC_DICT: Dict[str, Any] = {}


def _store_put(store, k, v):
    store[_s(k)] = v
    return v


@func("kv_store_put")
def _kv_put(k, v):
    return _store_put(_KV_STORE, k, v)


@func("kv_store_get")
def _kv_get(k, default=None):
    return _KV_STORE.get(_s(k), default)


@func("kv_store_del")
def _kv_del(k):
    _KV_STORE.pop(_s(k), None)
    return None


@func("proc_dict_put")
def _pd_put(k, v):
    return _store_put(_PROC_DICT, k, v)


@func("proc_dict_get")
def _pd_get(k):
    return _PROC_DICT.get(_s(k))


@func("proc_dict_del")
def _pd_del(k):
    _PROC_DICT.pop(_s(k), None)
    return None


# -- message-context accessors (zero-arg funcs reading the rule ctx;
#    emqx_rule_funcs clientid/0, topic/0, payload/0 etc.) --------------------
# The runtime special-cases these: they receive the evaluation context.

CONTEXT_FUNCS: Dict[str, Callable[[Dict], Any]] = {
    "clientid": lambda ctx: ctx.get("clientid"),
    "username": lambda ctx: ctx.get("username"),
    "topic": lambda ctx: ctx.get("topic"),
    "payload": lambda ctx: ctx.get("payload"),
    "qos": lambda ctx: ctx.get("qos"),
    "msgid": lambda ctx: ctx.get("id"),
    "peerhost": lambda ctx: ctx.get("peerhost"),
    "clientip": lambda ctx: ctx.get("peerhost"),
    "flags": lambda ctx: ctx.get("flags") or {},
    "pub_props": lambda ctx: ctx.get("pub_props") or {},
}


def context_flag(ctx: Dict, name) -> Any:
    return (ctx.get("flags") or {}).get(_s(name))


# -- named operator forms + term codec + map conversion ----------------------
# (parity with emqx_rule_funcs.erl exports '+'/2 '-'/2 '*'/2 '/'/2 'div'/2,
# map/1, term_encode/1, term_decode/1. The SQL grammar reaches the
# arithmetic ones as infix operators; the named forms exist so the
# function surface matches the reference export list 1:1.)


@func("+")
def _op_add(x, y):
    # numeric add; if either side is a string, implicit-concat like the
    # reference ('+'(X, Y) when is_binary -> concat)
    if isinstance(x, (bytes, str)) or isinstance(y, (bytes, str)):
        return _concat(x, y)
    a, b = _num(x), _num(y)
    return None if a is None or b is None else a + b


@func("-")
def _op_sub(x, y):
    a, b = _num(x), _num(y)
    return None if a is None or b is None else a - b


@func("*")
def _op_mul(x, y):
    a, b = _num(x), _num(y)
    return None if a is None or b is None else a * b


@func("/")
def _op_div(x, y):
    a, b = _num(x), _num(y)
    if a is None or b is None or b == 0:
        return None
    return a / b


@func("div")
def _op_intdiv(x, y):
    a, b = _num(x), _num(y)
    if a is None or b is None or int(b) == 0:
        return None
    q = abs(int(a)) // abs(int(b))  # erlang div truncates toward zero
    return q if (int(a) < 0) == (int(b) < 0) else -q


@func("map")
def _to_map(x):
    """Coerce to a map (emqx_plugin_libs_rule:map/1): maps pass through,
    JSON strings decode, key-value pair lists fold."""
    if isinstance(x, dict):
        return x
    if isinstance(x, (bytes, str)):
        try:
            v = json.loads(_s(x))
            return v if isinstance(v, dict) else None
        except (ValueError, TypeError):
            return None
    if isinstance(x, list):
        try:
            return {str(k): v for k, v in x}
        except (ValueError, TypeError):
            return None
    return None


def _term_tag(x):
    if isinstance(x, bytes):
        return {"t": "b", "v": base64.b64encode(x).decode()}
    if isinstance(x, list):
        return {"t": "l", "v": [_term_tag(i) for i in x]}
    if isinstance(x, dict):
        return {"t": "m", "v": {str(k): _term_tag(v) for k, v in x.items()}}
    return {"t": "v", "v": x}


def _term_untag(d):
    t = d.get("t")
    if t == "b":
        return base64.b64decode(d["v"])
    if t == "l":
        return [_term_untag(i) for i in d["v"]]
    if t == "m":
        return {k: _term_untag(v) for k, v in d["v"].items()}
    return d.get("v")


@func("term_encode")
def _term_encode(x):
    """Self-describing binary term encoding (reference: term_to_binary —
    a BEAM-native format; here a tagged-JSON framework-native one, so
    encode/decode round-trips bytes/lists/maps losslessly)."""
    try:
        return b"\x01ET" + json.dumps(_term_tag(x)).encode()
    except (TypeError, ValueError):
        return None


@func("term_decode")
def _term_decode(x):
    if isinstance(x, str):
        x = x.encode("utf-8", "surrogatepass")
    if not isinstance(x, bytes) or not x.startswith(b"\x01ET"):
        return None
    try:
        return _term_untag(json.loads(x[3:].decode()))
    except (ValueError, TypeError):
        return None
