"""Retained messages (reference: apps/emqx_retainer): the port's copy of
`Retainer` (emqx_tpu/broker/retainer.py:33).

Behaviour parity with emqx_retainer_mnesia.erl: store on PUBLISH with
retain=1 (an empty payload deletes), deliver the matching retained
messages on subscribe, the expiry sweep (`clear_expired`), and a bounded
message count.

Storage is a topic trie over the retained TOPICS, so a wildcard filter
finds its matches by walking the trie with the filter (the transpose of
routing). Behind `device_threshold` a device replay index
(`models.retained_index.DeviceRetainedIndex`) answers wildcard matches
with storm launches instead of the walk, while every stored topic fits
its budget. With a `RetainedStormFeed` attached (`storm_feed`, wired to
this index) and a running event loop, a wildcard SUBSCRIBE's replay joins
the feed's storm, which rides the broker's next device batch or the
feed's standalone flush (`attach`, `_replay_batched`); an answer of None
sends it to the trie walk.

`ensure_device` builds the index on an explicit device: CUDA unless the
retainer was made with ``device="cpu"`` (the tests' plain twins). The
app (app.py) wires the retainer, its device index and the feed; the REST
page reader (`messages_page`) stays with the management API (ROADMAP item
10.3d). `all_messages` and `load` carry a store across (`convert.
retained_messages_from_reference`).
"""

from __future__ import annotations

import asyncio
import copy
import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.kernels.build import KernelBuildError
from emqx_tpu_torch.ops import topics as T

log = logging.getLogger("emqx_tpu_torch.retainer")


class _Node:
    __slots__ = ("children", "msg")

    def __init__(self):
        self.children: Dict[str, _Node] = {}
        self.msg: Optional[Message] = None


class Retainer:
    def __init__(
        self,
        max_retained: int = 1_000_000,
        max_payload: int = 1024 * 1024,
        device_threshold: int = 10_000,
        enable_device: bool = False,
        device=None,
    ):
        self._root = _Node()
        self._count = 0
        self.max_retained = max_retained
        self.max_payload = max_payload
        self.enabled = True
        # the device replay index: wildcard matches over big stores as
        # storm launches instead of a trie walk per subscriber. Opt-in;
        # used once the store crosses device_threshold, and only while
        # EVERY stored topic fits the device budget
        self.device_threshold = device_threshold
        self.enable_device = enable_device
        self.device = device  # None: CUDA
        self._device = None
        self._device_unfit = 0
        # RetainedStormFeed (broker/retained_feed.py), attached by its
        # owner: wildcard-subscribe replays batch into device storms
        self.storm_feed = None

    def ensure_device(self) -> None:
        """Build the device replay index now (its owner wires the storm
        feed to it before any retained insert). On a card this builds and
        loads the kernel library, so a build failure raises here, not
        inside a storm that would fall back to the trie."""
        if self.enable_device and self._device is None:
            from emqx_tpu_torch.models.retained_index import DeviceRetainedIndex

            self._device = DeviceRetainedIndex(
                device="cuda" if self.device is None else self.device)

    def _dev_add(self, topic: str) -> None:
        if not self.enable_device:
            return
        self.ensure_device()
        if self._device is None:
            return
        if not self._device.add(topic):
            self._device_unfit += 1

    def _dev_remove(self, topic: str) -> None:
        if self._device is None:
            return
        if topic in self._device._rows:
            self._device.remove(topic)
        else:
            self._device_unfit = max(0, self._device_unfit - 1)

    def __len__(self) -> int:
        return self._count

    # -- store side -------------------------------------------------------
    def on_publish(self, msg: Message) -> None:
        """Called from the 'message.publish' pipeline for retain=1 messages."""
        if not self.enabled or not msg.retain or msg.topic.startswith("$SYS/"):
            return
        if msg.payload == b"":
            self.delete(msg.topic)
            return
        if len(msg.payload) > self.max_payload:
            return
        self._insert(msg)

    def _insert(self, msg: Message) -> None:
        msg.own_buffers()  # the store holds messages indefinitely
        words = T.words(msg.topic)
        if self._count >= self.max_retained:
            # at capacity only an overwrite of an existing topic is allowed;
            # probe without allocating so a rejected insert leaves no nodes
            node = self._root
            for w in words:
                node = node.children.get(w)
                if node is None:
                    return
            if node.msg is None:
                return
            node.msg = msg
            return
        node = self._root
        for w in words:
            node = node.children.setdefault(w, _Node())
        if node.msg is None:
            self._count += 1
            self._dev_add(msg.topic)
        node.msg = msg

    def load(self, msgs: Iterable[Message]) -> None:
        """Store each message as its publish would (a carried-over store,
        `convert.retained_messages_from_reference`)."""
        for m in msgs:
            self._insert(m)

    def delete(self, topic: str) -> bool:
        path: List[Tuple[_Node, str]] = []
        node = self._root
        for w in T.words(topic):
            child = node.children.get(w)
            if child is None:
                return False
            path.append((node, w))
            node = child
        if node.msg is None:
            return False
        node.msg = None
        self._count -= 1
        self._dev_remove(topic)
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.msg is None and not child.children:
                del parent.children[w]
            else:
                break
        return True

    def get(self, topic: str) -> Optional[Message]:
        node = self._root
        for w in T.words(topic):
            node = node.children.get(w)
            if node is None:
                return None
        return node.msg

    # -- read side --------------------------------------------------------
    def _device_ready(self) -> bool:
        return (self._device is not None and self._device_unfit == 0
                and self._count >= self.device_threshold)

    def match(self, filter_: str, now: Optional[float] = None) -> List[Message]:
        """All live retained messages whose topic matches `filter_`."""
        fw = T.words(filter_)
        out: List[Message] = []
        now = now or time.time()

        # the device replay path for wildcard filters over big stores
        if T.wildcard(filter_) and self._device_ready():
            topics = self._device.match(filter_)
            if topics is not None:
                for t in topics:
                    m = self.get(t)
                    if m is not None and not m.is_expired(now):
                        out.append(m)
                return out

        def walk(node: _Node, i: int, root_level: bool) -> None:
            if i == len(fw):
                if node.msg is not None and not node.msg.is_expired(now):
                    out.append(node.msg)
                return
            w = fw[i]
            if w == "#":
                # matches the parent and every descendant; skip $-roots at top
                def rec(n: _Node) -> None:
                    if n.msg is not None and not n.msg.is_expired(now):
                        out.append(n.msg)
                    for c in n.children.values():
                        rec(c)

                if i == 0:
                    for cw, c in node.children.items():
                        if not cw.startswith("$"):
                            rec(c)
                else:
                    rec(node)
                return
            if w == "+":
                for cw, c in node.children.items():
                    if root_level and cw.startswith("$"):
                        continue
                    walk(c, i + 1, False)
                return
            c = node.children.get(w)
            if c is not None:
                walk(c, i + 1, False)

        walk(self._root, 0, True)
        return out

    def clear_expired(self, now: Optional[float] = None) -> int:
        now = now or time.time()
        removed: List[str] = []

        def sweep(node: _Node, prefix: List[str]) -> None:
            if node.msg is not None and node.msg.is_expired(now):
                removed.append("/".join(prefix))
            for w, c in list(node.children.items()):
                prefix.append(w)
                sweep(c, prefix)
                prefix.pop()

        sweep(self._root, [])
        for t in removed:
            self.delete(t)
        return len(removed)

    def all_messages(self, limit: Optional[int] = None) -> List[Message]:
        """Every stored message, '$'-rooted topics included (a plain store
        walk, not wildcard matching)."""
        out: List[Message] = []

        def walk(node: _Node) -> None:
            if limit is not None and len(out) >= limit:
                return
            if node.msg is not None:
                out.append(node.msg)
            for c in node.children.values():
                walk(c)

        walk(self._root)
        return out

    def topics(self) -> List[str]:
        out: List[str] = []

        def walk(node: _Node, prefix: List[str]) -> None:
            if node.msg is not None:
                out.append("/".join(prefix))
            for w, c in node.children.items():
                prefix.append(w)
                walk(c, prefix)
                prefix.pop()

        walk(self._root, [])
        return out

    # -- wiring -----------------------------------------------------------
    def attach(self, hooks: Hooks) -> None:
        """Install on the reference's hookpoints ('message.publish' and
        'session.subscribed', emqx_retainer.erl)."""

        def on_pub(msg):
            if msg is not None:
                self.on_publish(msg)
            return None

        def on_sub(client_info, filter_, opts, channel=None):
            # the channel passes itself; a call without one delivers nothing
            if channel is None:
                return
            group, real = T.parse_share(filter_)
            if group is not None:
                return  # no retained delivery for shared subscriptions
            if opts.retain_handling == 2:
                return
            if opts.retain_handling == 1 and getattr(opts, "_existing", False):
                return
            if self._storm_eligible(real):
                # device-scale wildcard replay: batched through the storm
                # feed (it rides the next device batch) instead of one
                # device pass per subscriber on the hook path. Retained
                # delivery may land any time after the subscription.
                asyncio.ensure_future(self._replay_batched(real, opts, channel))
                return
            self._deliver_retained(self.match(real), opts, channel)

        hooks.add("message.publish", lambda msg: on_pub(msg), priority=100)
        hooks.add("session.subscribed", on_sub)

    def _storm_eligible(self, real: str) -> bool:
        """A wildcard filter the device replay path would serve, with a
        storm feed attached."""
        return (
            self.storm_feed is not None
            and T.wildcard(real)
            and self._device_ready()
            and len(T.words(real)) <= self._device.max_levels
        )

    def _deliver_retained(self, msgs, opts, channel) -> None:
        for m in msgs:
            mm = copy.copy(m)
            mm.headers = dict(m.headers, retained=True)
            channel.handle_deliver(mm, opts)

    async def _replay_batched(self, real: str, opts, channel) -> None:
        """One batched replay: await the storm feed's answer (a fused
        batch or the standalone flush), or walk the trie when the device
        pass could not serve it. Topics re-fetch from the live store, so a
        concurrent delete costs a lookup, never a stale replay. A kernel
        library that will not build raises out of the replay task instead
        of taking the walk."""
        try:
            topics = await self.storm_feed.submit(real)
        except KernelBuildError:
            raise
        except Exception:  # noqa: BLE001 — replay must not kill the task
            topics = None
        now = time.time()
        if topics is None:
            msgs = self.match(real, now)
        else:
            msgs = []
            for t in topics:
                m = self.get(t)
                if m is not None and not m.is_expired(now):
                    msgs.append(m)
        try:
            self._deliver_retained(msgs, opts, channel)
        except Exception:  # noqa: BLE001 — a subscriber gone mid-replay
            log.debug("retained replay delivery failed (subscriber gone?)", exc_info=True)
