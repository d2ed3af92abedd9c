"""Append-only message WAL: the between-snapshot durability delta.

Parity: the reference persists every message for persistent sessions at publish
time and tracks per-session delivered/undelivered markers
(emqx_persistent_session.erl:63-77, persist at emqx_broker.erl:213). This
stack keeps session *state* in periodic snapshots (persistent_session.py)
and closes the crash window between snapshots with this WAL:

- every message banked for a detached persistent session appends one
  JSONL record (optionally fsynced);
- a snapshot flush truncates the log (the snapshot now owns the state);
- restore = snapshot + replay of the post-snapshot WAL suffix.

Crash between a resumed client consuming a message and the next snapshot
re-delivers it (at-least-once, QoS1 semantics — same guarantee the
reference provides). Records are self-describing JSON lines; a torn tail
line (crash mid-append) is dropped on replay.

The port's copy of `emqx_tpu/storage/wal.py`, its code unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple


class MessageWal:
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def append(self, client_id: str, msg_json: dict) -> None:
        rec = json.dumps(
            {"cid": client_id, "msg": msg_json}, separators=(",", ":")
        )
        self._f.write(rec + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def truncate(self) -> None:
        """Snapshot taken: the log's contents are now owned by it."""
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def replay(self) -> Iterator[Tuple[str, dict]]:
        """Yield (client_id, msg_json) records; tolerates a torn tail."""
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        yield rec["cid"], rec["msg"]
                    except (ValueError, KeyError):
                        return  # torn/corrupt tail: stop replay here
        except FileNotFoundError:
            return

    def close(self) -> None:
        self._f.close()
