"""Step-atomic checkpointing with integrity manifests.

Port of ``repro.training.checkpoint``, with its on-disk format, so either
package reads the other's checkpoints:

    <root>/step_00000120/
        arrays.npz       -- every tree leaf, keyed by its "/"-joined path
                            (dict keys sorted, list indices as numbers)
        manifest.json    -- step, keys, shapes/dtypes, sampled sha256
                            fingerprints, the caller's extras, wall time

A checkpoint is written into ``step_X.tmp-<pid>`` and published by an
atomic rename, so a partly written one is never listed.
``restore_latest`` verifies the fingerprints and falls back past a
step that cannot be read, but raises on an intact one that does not fit
its template. Leaves are stored unsharded as numpy arrays and come back
on the template's device and dtype; a shape that differs from the
template's raises (the packages' conv layouts differ: HWIO in the JAX
package, OIHW here). bfloat16 leaves, which numpy cannot hold, raise.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step", "list_steps"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _items(tree: Any, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the JAX package's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _to_numpy(key: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"leaf {key} is bfloat16, which numpy cannot hold: bf16 "
                f"checkpoints come with LM training (ROADMAP queue 1, "
                f"item 6: the rest of item 13)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fingerprint(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    # sample-based fingerprint: fast yet catches truncation/corruption
    flat = arr.reshape(-1)
    step = max(flat.size // 4096, 1)
    h.update(np.ascontiguousarray(flat[::step]).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(
    root: str | os.PathLike,
    step: int,
    state: Dict[str, Any],
    *,
    extra: Optional[Dict[str, Any]] = None,
    keep_last: int = 3,
) -> pathlib.Path:
    """Atomically persist ``state`` (a nested dict/list of tensors) at
    ``step``; keep the newest ``keep_last`` steps."""
    flat = {k: _to_numpy(k, v) for k, v in _items(state)}
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    np.savez(tmp / _ARRAYS, **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "fingerprints": {k: _fingerprint(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic publish

    for old in list_steps(root)[:-keep_last]:
        shutil.rmtree(root / f"step_{old:08d}", ignore_errors=True)
    return final


def list_steps(root: str | os.PathLike):
    root = pathlib.Path(root)
    steps = []
    if root.exists():
        for p in root.iterdir():
            if p.name.startswith("step_") and ".tmp" not in p.name:
                try:
                    steps.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
    return sorted(steps)


def latest_step(root) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _verify(manifest: dict, arrays: Dict[str, np.ndarray]) -> bool:
    return all(k in arrays
               and _fingerprint(arrays[k]) == manifest["fingerprints"][k]
               for k in manifest["keys"])


def _leaf(key: str, arr: np.ndarray, like: Any) -> Any:
    """A stored array as the template leaf ``like`` holds it: a tensor on
    its device and in its dtype; any other leaf comes back as the array."""
    if not isinstance(like, torch.Tensor):
        return arr
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                         f"the template {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, order="C")).to(
        device=like.device, dtype=like.dtype)


def _rebuild(tree: Any, arrays: Dict[str, np.ndarray],
             path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, arrays, path + (str(i),))
                          for i, v in enumerate(tree))
    key = "/".join(path)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    return _leaf(key, arrays[key], tree)


def _load(root: str | os.PathLike, step: int
          ) -> Tuple[Dict[str, np.ndarray], dict]:
    """The arrays and manifest of step ``step``, integrity checked."""
    path = pathlib.Path(root) / f"step_{step:08d}"
    manifest = json.loads((path / _MANIFEST).read_text())
    with np.load(path / _ARRAYS) as z:
        arrays = {k: z[k] for k in z.files}
    if not _verify(manifest, arrays):
        raise IOError(f"checkpoint {path} failed integrity check")
    return arrays, manifest


def restore_checkpoint(
    root: str | os.PathLike, step: int, template: Dict[str, Any]
) -> Tuple[Dict[str, Any], dict]:
    """Load step ``step`` into the structure of ``template``: each leaf on
    the template leaf's device and in its dtype.

    Returns (state, manifest-extra). Raises on integrity failure and on
    a leaf missing or shaped unlike the template's.
    """
    arrays, manifest = _load(root, step)
    return _rebuild(template, arrays), manifest["extra"]


# What reading a damaged or half-deleted step can raise: a missing file,
# a manifest that is not JSON or lacks a field, a zip that does not
# open or ends early, a failed fingerprint.
_CORRUPT = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def restore_latest(
    root: str | os.PathLike, template: Dict[str, Any]
) -> Optional[Tuple[int, Dict[str, Any], dict]]:
    """Restore the newest intact checkpoint, falling back past corrupt
    ones. Returns (step, state, extra) or None if nothing usable.

    Only a step that cannot be read is passed over. An intact one that
    does not fit ``template`` (a missing leaf, another shape, e.g. a JAX
    checkpoint's HWIO convolutions) raises, rather than training on from
    step 0 in a directory whose steps ``keep_last`` would then prune.
    """
    for step in reversed(list_steps(root)):
        try:
            arrays, manifest = _load(root, step)
        except _CORRUPT:
            continue
        return step, _rebuild(template, arrays), manifest["extra"]
    return None
