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
package, OIHW here). bfloat16 leaves are written as numpy writes
``ml_dtypes.bfloat16`` (the JAX package's files).

Over a process mesh the trainer writes from rank 0 the whole arrays
(``sharding.gather_logical``), so the files are the one-device ones;
``restore_latest(..., specs=, pmesh=)`` gives each rank its block of each
stored array, on any mesh (elastic restart).
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
_BF16 = "bfloat16"
_V2 = np.dtype("V2")     # how numpy loads a stored bfloat16 array


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


class _Bits:
    """A bfloat16 leaf on its way to disk: its 16-bit patterns."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape = bits.shape


def _to_numpy(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _Bits(x.view(torch.int16).numpy())
        return x.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: Any, stored: Optional[str] = None) -> str:
    """The dtype a leaf is written and hashed under: ``"bfloat16"`` for
    its bits (or for a loaded ``V2`` array the manifest calls bfloat16),
    else numpy's name."""
    if isinstance(arr, _Bits) or (stored == _BF16 and arr.dtype == _V2):
        return _BF16
    return str(arr.dtype)


def _fingerprint(arr: Any, stored: Optional[str] = None) -> str:
    data = arr.bits if isinstance(arr, _Bits) else arr
    h = hashlib.sha256()
    h.update(str(data.shape).encode())
    h.update(_dtype_name(arr, stored).encode())
    # sample-based fingerprint: fast yet catches truncation/corruption
    flat = data.reshape(-1)
    step = max(flat.size // 4096, 1)
    h.update(np.ascontiguousarray(flat[::step]).tobytes())
    return h.hexdigest()[:16]


def _savez(path: pathlib.Path, flat: Dict[str, Any]) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``), with each
    bfloat16 leaf's bits under the header descr ``<V2``, as numpy writes
    an ``ml_dtypes.bfloat16`` array."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if isinstance(arr, _Bits):
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False,
                            "shape": arr.shape})
                    f.write(memoryview(np.ascontiguousarray(arr.bits))
                            .cast("B"))
                else:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)


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
    flat = {k: _to_numpy(v) for k, v in _items(state)}
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    _savez(tmp / _ARRAYS, flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
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
    dtypes = manifest.get("dtypes", {})
    return all(k in arrays
               and _fingerprint(arrays[k], dtypes.get(k))
               == manifest["fingerprints"][k]
               for k in manifest["keys"])


def _leaf(key: str, arr: np.ndarray, like: Any, block=None) -> Any:
    """A stored array as the template leaf ``like`` holds it: a tensor on
    its device and in its dtype; any other leaf comes back as the array.
    A ``V2`` array (a bfloat16 leaf, checked against the manifest by
    ``_verify``) is read as bfloat16 bits. ``block``: ``(spec, pmesh)``,
    when ``like`` is this rank's block of the stored array under ``spec``
    (the block comes back tagged with it)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if block is not None:
        from repro_torch.distributed.sharding import NamedSharding
        spec, pmesh = block
        arr = arr[NamedSharding(pmesh, spec).devices_indices_map(
            arr.shape)[pmesh.rank]]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                         f"the template {tuple(like.shape)}")
    if arr.dtype == _V2:
        x = torch.from_numpy(np.array(arr, order="C").view(np.int16)).view(
            torch.bfloat16)
    else:
        x = torch.from_numpy(np.array(arr, order="C"))
    x = x.to(device=like.device, dtype=like.dtype)
    if block is not None:
        from repro_torch.distributed.annotate import tag
        x = tag(x, block[0])
    return x


def _rebuild(tree: Any, arrays: Dict[str, np.ndarray],
             path: Tuple[str, ...] = (), specs: Any = None,
             pmesh: Any = None) -> Any:
    def sub(k):
        return None if specs is None else specs[k]
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays, path + (str(k),), sub(k), pmesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, arrays, path + (str(i),), sub(i),
                                   pmesh)
                          for i, v in enumerate(tree))
    key = "/".join(path)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    return _leaf(key, arrays[key], tree,
                 None if specs is None else (tuple(specs), pmesh))


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
    root: str | os.PathLike, template: Dict[str, Any], *,
    specs: Any = None, pmesh: Any = None
) -> Optional[Tuple[int, Dict[str, Any], dict]]:
    """Restore the newest intact checkpoint, falling back past corrupt
    ones. Returns (step, state, extra) or None if nothing usable.

    Only a step that cannot be read is passed over. An intact one that
    does not fit ``template`` (a missing leaf, another shape, e.g. a JAX
    checkpoint's HWIO convolutions) raises, rather than training on from
    step 0 in a directory whose steps ``keep_last`` would then prune.

    With ``specs`` (the state's spec tree) and ``pmesh`` (a process
    mesh) the template's leaves are this rank's blocks, and each comes
    back as its block of the stored whole array.
    """
    for step in reversed(list_steps(root)):
        try:
            arrays, manifest = _load(root, step)
        except _CORRUPT:
            continue
        return step, _rebuild(template, arrays, (), specs, pmesh), \
            manifest["extra"]
    return None
