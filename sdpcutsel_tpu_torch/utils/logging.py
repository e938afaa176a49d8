"""Structured JSONL logging (port of ``sdpcutsel_tpu/utils/logging.py``).

The reference printed ad-hoc timing lines and wrote CSVs at the end; here
every round emits one JSON object (bound, gap-closed, cuts added/purged, LP
iterations, wall-clock) so suite aggregation is a file concat.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import IO, Any


def read_records(path: str) -> list:
    """The JSON objects of a JSONL file in order, malformed lines skipped;
    [] when the file does not exist."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


class JSONLLogger:
    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh: IO | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: Any, **extra):
        if dataclasses.is_dataclass(record):
            record = dataclasses.asdict(record)
        record = {**record, **extra, "ts": time.time()}
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
