"""Converted-state cache — the checkpoint/resume analog.

The reference has no in-process checkpointing (runs are seconds long); its de
facto resume unit is the sweep lockfile (SURVEY §5.3-5.4), and the expensive
artifact worth persisting here is the OptimizeProblem output: format conversion
(host-side sorts, diagonal peeling, level scheduling) can take minutes at
10⁸-nnz scale while SpMV takes microseconds.  ``save_state``/``load_state``
serialize any registered format state — nested states (hyb's dia + residual,
auto's wrapper) included — as an .npz of array leaves + a JSON structure
descriptor, fingerprinted by (matrix shape, nnz, Config fields) so a stale
cache is never silently reused.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict

import numpy as np

from ..config import Config

_SENTINEL = "__state__"


def _encode(obj, arrays: Dict[str, np.ndarray], prefix: str):
    import jax

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_SENTINEL: f"{type(obj).__module__}:{type(obj).__qualname__}",
               "fields": {}}
        for f in dataclasses.fields(obj):
            out["fields"][f.name] = _encode(getattr(obj, f.name), arrays,
                                            f"{prefix}.{f.name}")
        return out
    if hasattr(obj, "chosen") and hasattr(obj, "inner"):   # AutoState wrapper
        return {_SENTINEL: "singlespmv_tpu.formats.auto:AutoState",
                "chosen": obj.chosen, "failed": list(obj.failed),
                "inner": _encode(obj.inner, arrays, f"{prefix}.inner")}
    if isinstance(obj, (jax.Array, np.ndarray)):
        key = prefix.lstrip(".")
        arrays[key] = np.asarray(obj)
        return {"__array__": key}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays, f"{prefix}.{i}")
                              for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot serialize {type(obj)!r} at {prefix}")


def _decode(node, arrays):
    from .base import device_put

    if isinstance(node, dict):
        if "__array__" in node:
            return device_put(arrays[node["__array__"]])
        if "__tuple__" in node:
            return tuple(_decode(v, arrays) for v in node["__tuple__"])
        if node.get(_SENTINEL) == "singlespmv_tpu.formats.auto:AutoState":
            from .auto import AutoState

            return AutoState(node["chosen"], _decode(node["inner"], arrays),
                             tuple(node.get("failed", ())))
        if _SENTINEL in node:
            mod_name, qual = node[_SENTINEL].split(":")
            cls = getattr(importlib.import_module(mod_name), qual)
            kw = {k: _decode(v, arrays) for k, v in node["fields"].items()}
            return cls(**kw)
    return node


def fingerprint(coo, cfg: Config) -> dict:
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(coo.row).tobytes())
    h.update(np.ascontiguousarray(coo.col).tobytes())
    h.update(np.ascontiguousarray(coo.val).tobytes())
    # json round-trip so tuples in Config compare equal to the lists a saved
    # .json gives back; only convert-relevant fields participate — timing /
    # instrumentation knobs (n_trials, calibrate_seconds, verify, ...) must
    # not invalidate a converted state
    _CONVERT_FIELDS = (
        "format", "variant", "segment_width", "n_block", "padding",
        "index_bits", "omega", "sigma", "row_block", "lane_width",
        "auto_exclude", "spmm_b", "dtype")
    cfg_d = json.loads(json.dumps(
        {k: v for k, v in dataclasses.asdict(cfg).items()
         if k in _CONVERT_FIELDS}))
    # per-format layout revision: a format module bumps STATE_REV when its
    # convert layout/planning changes, invalidating stale cached states.
    # format=auto wraps ANY inner format, so its rev must fold every
    # candidate's rev — otherwise an inner bump leaves a cached auto state
    # that chose that format valid and silently reuses an incompatible state.
    try:
        mod = importlib.import_module(f".{cfg.format}", __package__)
        rev = getattr(mod, "STATE_REV", 0)
    except ImportError:
        rev = 0
    if cfg.format == "auto":
        from .auto import _MODULES

        rev = {"auto": rev}
        for name, m in sorted(_MODULES.items()):
            rev[name] = getattr(m, "STATE_REV", 0)
    # the device kind: a state planned (and, for auto, timed) on one device
    # is never reused on another
    import jax

    return {"n_row": coo.n_row, "n_col": coo.n_col, "nnz": coo.nnz,
            "digest": h.hexdigest(), "config": cfg_d, "rev": rev,
            "device_kind": jax.devices()[0].device_kind}


def save_state(path: str, state: Any, coo=None, cfg: Config = None) -> None:
    """Persist a converted format state (.npz + .json next to it)."""
    arrays: Dict[str, np.ndarray] = {}
    tree = _encode(state, arrays, "")
    meta = {"tree": tree}
    if coo is not None and cfg is not None:
        meta["fingerprint"] = fingerprint(coo, cfg)
    # uncompressed: value planes are incompressible floats and giant states
    # run to GBs — zlib would add minutes per matrix for ~nothing
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def load_state(path: str, coo=None, cfg: Config = None):
    """Load a cached state; returns None on fingerprint mismatch / missing."""
    npz = path if path.endswith(".npz") else path + ".npz"
    if not (os.path.exists(npz) and os.path.exists(_meta_path(path))):
        return None
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    if coo is not None and cfg is not None:
        if meta.get("fingerprint") != fingerprint(coo, cfg):
            return None
    with np.load(npz) as arrays:
        return _decode(meta["tree"], dict(arrays))


def convert_cached(coo, cfg: Config, cache_dir: str, name: str):
    """convert() with a disk cache keyed by name + fingerprint."""
    from . import convert as _convert

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}-{cfg.format}")
    state = load_state(path, coo, cfg)
    if state is not None:
        return state
    state = _convert(coo, cfg)
    save_state(path, state, coo, cfg)
    return state
