"""Benchmark report block.

The reference's machine-readable output contract: ``%25s\\t%s`` key-value rows between
a 40×'+' opener and 40×'-' closer (/root/reference/src/main.cpp:109-207).  The
downstream toolchain (log/format.cpp) keys on Matrix / Architecture / MatrixFormat /
Performance(GFLOPS) / nRow / nCol / nNnz — we keep that schema exactly and add
device keys (device kind, bandwidth, roofline, convert time) plus a JSONL
sidecar.
"""
from __future__ import annotations

import json
import os
from typing import Dict

OPEN = "+" * 40
CLOSE = "-" * 40

# Reference spelling of format names (src/main.cpp:126-191).
FORMAT_NAMES = {
    "csr": "CRS", "crs": "CRS", "coo": "COO", "ell": "ELL", "jds": "JDS",
    "dia": "DIA", "ss": "SS", "css": "CSS", "csr5": "CSR5", "dense": "DENSE",
    "bcoo": "BCOO", "bsr": "BSR", "auto": "AUTO",
}


def get_basename(path: str) -> str:
    """Strip directory and extension (reference GetBasename: 'ASIC_680ks')."""
    base = os.path.basename(str(path))
    if base.endswith(".mtx"):
        base = base[: -len(".mtx")]
    return base


def format_block(data: Dict[str, object]) -> str:
    lines = [OPEN]
    for k, v in data.items():
        if isinstance(v, float):
            v = f"{v:f}"
        lines.append(f"{k:>25}\t{v}")
    lines.append(CLOSE)
    return "\n".join(lines)


def parse_blocks(text: str):
    """Parse ++++/---- delimited blocks into dicts (log/format.cpp:29-43)."""
    blocks = []
    cur = None
    for line in text.splitlines():
        if line.strip() == OPEN:
            cur = {}
        elif line.strip() == CLOSE:
            if cur is not None:
                blocks.append(cur)
            cur = None
        elif cur is not None and line.strip():
            parts = line.split("\t", 1) if "\t" in line else line.split(None, 1)
            if len(parts) == 2:
                cur[parts[0].strip()] = parts[1].strip()
    return blocks


def to_jsonl(data: Dict[str, object]) -> str:
    return json.dumps(data, sort_keys=True)
