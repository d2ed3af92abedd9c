"""Shared ``${var}`` placeholder templating: the port's copy of
`emqx_tpu/utils/placeholder.py`, unchanged below this docstring.

The emqx_plugin_libs `emqx_placeholder` analog: one implementation used by
the rule engine, data bridges, authz patterns, and auto-subscribe instead
of per-module reimplementations. Supports dotted paths into nested dicts
(JSON-decoding string/bytes nodes on the way down), with the reference's
rendering conventions (bools as true/false, integral floats as ints,
missing vars as empty string).
"""

from __future__ import annotations

import json
import re
from typing import Dict

_PLACEHOLDER = re.compile(r"\$\{([A-Za-z0-9_.$]+)\}")


def render(template: str, env: Dict) -> str:
    """Substitute every ``${a.b}`` in `template` from `env`."""

    def repl(m):
        cur = env
        for seg in m.group(1).split("."):
            if isinstance(cur, (bytes, str)):
                try:
                    cur = json.loads(cur)
                except (ValueError, TypeError):
                    cur = None
            if not isinstance(cur, dict) or seg not in cur:
                return ""
            cur = cur[seg]
        if isinstance(cur, bytes):
            return cur.decode("utf-8", "replace")
        if isinstance(cur, (dict, list)):
            return json.dumps(cur)
        if isinstance(cur, bool):
            return "true" if cur else "false"
        if isinstance(cur, float) and cur.is_integer():
            return str(int(cur))
        return "" if cur is None else str(cur)

    return _PLACEHOLDER.sub(repl, template)
