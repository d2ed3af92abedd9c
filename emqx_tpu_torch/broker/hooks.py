"""Hook registry: priority-ordered callback chains per hookpoint. The
port's copy of `emqx_tpu/broker/hooks.py`, its code unchanged.

Parity with the reference's extension spine (apps/emqx/src/emqx_hooks.erl:
30-41 API, 163-196 run/run_fold with 'stop' short-circuit). Every extension
in the reference attaches here (authn/authz, rule engine, retainer, exhook —
SURVEY.md §2 L4); this framework keeps the same contract so extensions stay
decoupled from the broker kernel.

Hookpoint names mirror the canonical enumeration in the reference's
exhook.proto (apps/emqx_exhook/priv/protos/exhook.proto:27-69):
client.connect/connack/connected/disconnected/authenticate/authorize/
subscribe/unsubscribe, session.created/subscribed/unsubscribed/resumed/
discarded/takenover/terminated, message.publish/delivered/acked/dropped,
delivery.dropped/completed.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple


class StopAndReturn(Exception):
    """Raised by a callback to short-circuit a fold with a final value."""

    def __init__(self, value):
        self.value = value


STOP = object()  # sentinel return: stop the chain (keep current acc)


class Hooks:
    def __init__(self) -> None:
        # chain entries: (priority, tag, callback, is_coroutine_fn) —
        # coroutine-ness is classified ONCE at registration; the fold
        # paths run per message and inspect.iscoroutinefunction there
        # measured as the single largest hook-framework cost
        self._table: Dict[str, List[Tuple[int, str, Callable, bool]]] = {}

    def add(
        self,
        name: str,
        callback: Callable,
        priority: int = 0,
        tag: Optional[str] = None,
    ) -> None:
        """Register; higher priority runs first (emqx_hooks.erl ordering)."""
        chain = self._table.setdefault(name, [])
        tag = tag or getattr(callback, "__qualname__", repr(callback))
        chain.append(
            (priority, tag, callback, inspect.iscoroutinefunction(callback))
        )
        chain.sort(key=lambda e: -e[0])

    def delete(self, name: str, callback_or_tag) -> None:
        chain = self._table.get(name, [])
        self._table[name] = [
            e
            for e in chain
            if e[2] is not callback_or_tag and e[1] != callback_or_tag
        ]

    def run(self, name: str, *args) -> None:
        """Run all callbacks; a STOP return short-circuits.

        Coroutine-function callbacks are skipped on this sync path (they
        only fire on `arun`); the async channel path uses arun/arun_fold so
        client-originated traffic always reaches async extensions (exhook).
        """
        for _, _, cb, is_coro in self._table.get(name, ()):
            if is_coro:
                continue
            if cb(*args) is STOP:
                return

    def run_fold(self, name: str, args: tuple, acc: Any) -> Any:
        """Fold acc through the chain.

        Callback returns: None (keep acc) | ('ok', new_acc) | STOP |
        ('stop', final_acc); or raises StopAndReturn(final).
        Coroutine-function callbacks are skipped (see `run`).
        """
        for _, _, cb, is_coro in self._table.get(name, ()):
            if is_coro:
                continue
            try:
                r = cb(*args, acc)
            except StopAndReturn as s:
                return s.value
            acc2, stop = self._fold_step(r, acc)
            if stop:
                return acc2
            acc = acc2
        return acc

    @staticmethod
    def _fold_step(r, acc) -> Tuple[Any, bool]:
        """-> (new_acc, stop?)"""
        if r is None or r is True:
            return acc, False
        if r is STOP:
            return acc, True
        if isinstance(r, tuple) and len(r) == 2:
            kind, val = r
            if kind == "ok":
                return val, False
            if kind == "stop":
                return val, True
        return r, False  # plain new acc

    async def arun(self, name: str, *args) -> None:
        """Async `run`: awaits coroutine callbacks, runs sync ones inline.

        This is the channel-path variant — a slow async extension (e.g. an
        exhook gRPC sidecar) suspends only the calling connection's task,
        never the event loop (ADVICE r1: emqx_exhook blocking finding).
        """
        for _, _, cb, _is_coro in self._table.get(name, ()):
            r = cb(*args)
            if inspect.isawaitable(r):
                r = await r
            if r is STOP:
                return

    async def arun_fold(self, name: str, args: tuple, acc: Any) -> Any:
        """Async `run_fold`: awaits coroutine callbacks along the chain.
        (isawaitable stays per-result: a SYNC callback may still return
        an awaitable it built — only the registration-time coroutine
        check is cached.)"""
        for _, _, cb, _is_coro in self._table.get(name, ()):
            try:
                r = cb(*args, acc)
                if inspect.isawaitable(r):
                    r = await r
            except StopAndReturn as s:
                return s.value
            acc2, stop = self._fold_step(r, acc)
            if stop:
                return acc2
            acc = acc2
        return acc

    def callbacks(self, name: str):
        return list(self._table.get(name, ()))


# process-global default registry (the reference's hooks are node-global)
default_hooks = Hooks()
