"""Structured observability: stdout INFO + JSONL run records.

The reference logs via stdout macros and per-query result files [R:
mylib.h/query.h — reconstruction, SURVEY.md Sec. 5.5]; here each run can
also append one JSON object per event to a .jsonl file (queries/sec,
precision@k, phase times, bytes exchanged) for the bench driver.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional


def info(msg: str, **kv: Any) -> None:
    extra = ("  " + " ".join(f"{k}={v}" for k, v in kv.items())) if kv else ""
    print(f"[fora] {msg}{extra}", file=sys.stderr, flush=True)


class RunLog:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "kind": kind, **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
