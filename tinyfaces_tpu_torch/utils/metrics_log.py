"""Structured training-metrics logging (JSONL).

One JSON object per logging event, beside the reference-format console
line; the same records as tinyfaces_tpu/utils/metrics_log.py.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str | Path]):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        else:
            self._fh = None
        self._t0 = time.time()

    def log(self, **fields: Any) -> None:
        if self._fh is None:
            return
        record = {"t": round(time.time() - self._t0, 3), **fields}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
