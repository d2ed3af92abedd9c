"""Namespace -> JSON file store with atomic replace.

The durability substrate standing in for the reference's mnesia disc copies
(disc_copies tables hold retained/delayed/banned/persistent-session state;
SURVEY.md §5.4). Writes go to a temp file then rename() — crash-atomic on
POSIX — so a partially written snapshot can never shadow the previous good
one. JSON keeps snapshots debuggable (`emqx_node_dump` spirit); payload
bytes are base64 in the codec layer.

The port's copy of `emqx_tpu/storage/kv.py`, its code unchanged.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional


class FileKv:
    def __init__(self, data_dir: str, fsync: bool = False):
        self.data_dir = data_dir
        self.fsync = fsync
        os.makedirs(data_dir, exist_ok=True)

    def _path(self, namespace: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "-_." else "_" for c in namespace
        )
        return os.path.join(self.data_dir, f"{safe}.json")

    def read(self, namespace: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(namespace), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError):
            # corrupt/unreadable snapshot: behave like a cold start rather
            # than refusing to boot (mnesia would recover from the log; we
            # degrade to empty)
            return None

    def write(self, namespace: str, obj: Dict[str, Any]) -> None:
        path = self._path(namespace)
        fd, tmp = tempfile.mkstemp(
            dir=self.data_dir, prefix=".tmp_", suffix=".json"
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(obj, f, separators=(",", ":"))
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
            if self.fsync:
                # the rename is only crash-durable once the directory
                # entry itself is synced
                dfd = os.open(self.data_dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def delete(self, namespace: str) -> bool:
        try:
            os.unlink(self._path(namespace))
            return True
        except OSError:
            return False
