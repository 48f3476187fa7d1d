"""Stable byte serialization for models and datasets.

The same versioned npz container as ``ppca_rs_tpu.utils.serialization``,
with the same magic and kind strings, so a model or dataset dumped by either
package loads in the other.  Arrays are stored as numpy float64/bool.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Tuple

import numpy as np

MAGIC = "ppca_rs_tpu"
VERSION = 1


def dump_bytes(kind: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any] | None = None) -> bytes:
    """Serialize named arrays + JSON-able metadata into stable bytes."""
    header = {
        "magic": MAGIC,
        "version": VERSION,
        "kind": kind,
        "meta": meta or {},
    }
    buf = io.BytesIO()
    np.savez(buf, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def load_bytes(data: bytes, expected_kind: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Inverse of :func:`dump_bytes`; validates the container kind."""
    buf = io.BytesIO(data)
    with np.load(buf, allow_pickle=False) as npz:
        header = json.loads(bytes(npz["__header__"].tobytes()).decode())
        if header.get("magic") != MAGIC:
            raise ValueError("not a ppca_rs_tpu serialized object")
        if header.get("kind") != expected_kind:
            raise ValueError(
                f"serialized object is a {header.get('kind')!r}, expected {expected_kind!r}"
            )
        arrays = {k: npz[k] for k in npz.files if k != "__header__"}
    return arrays, header.get("meta", {})
