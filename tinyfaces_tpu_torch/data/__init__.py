"""Data layer of the port: templates, device-side targets, the batch loader.

`load_templates` mirrors tinyfaces_tpu/data/__init__.py: it reads the
checked-in `tinyfaces_tpu/data/templates.json` by path (that package's
`data` module imports JAX, so it is not imported) and rounds to 8 decimals.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import tinyfaces_tpu

TEMPLATE_FILE = Path(tinyfaces_tpu.__file__).resolve().parent / "data" / "templates.json"


def load_templates(template_file: str | Path | None = None) -> np.ndarray:
    """(T, 5) template matrix [x1, y1, x2, y2, natural_scale], rounded to 8
    decimals. Raises FileNotFoundError when the file is missing."""
    template_file = Path(template_file or TEMPLATE_FILE)
    if not template_file.exists():
        raise FileNotFoundError(f"{template_file} missing (re-clustering is not ported)")
    with open(template_file) as f:
        templates = json.load(f)
    return np.round(np.array(templates, np.float64), decimals=8)
