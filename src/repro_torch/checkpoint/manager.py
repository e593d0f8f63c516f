"""Atomic, keep-N, CRC-checked checkpoints in the JAX package's format.

A step directory ``step_<N>/`` holds ``arrays.npz`` (every leaf of a
nested-dict tree under its keystr path, e.g. ``['params']['dense']['w0']``),
``meta.json`` (step, time, the caller's ``extra`` dict, and shape, dtype
and CRC32 per array) and a ``COMMIT`` marker. Writes go to
``step_<N>.tmp/``, each file through a ``.part`` sibling and
``os.replace``, and the directory is renamed into place, so a crashed
writer never leaves a torn step a reader could open. The format is the
one ``repro.checkpoint.manager`` writes: either package reads the
other's checkpoints. The bf16/fp8 uint views of the reference are not
needed by the fp32 port yet.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
import zlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib


class CheckpointCorruption(ValueError):
    """A stored array failed its CRC32, or a step file is unreadable."""


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _atomic_write(path: str, emit: Callable):
    """Write ``path`` via a ``.part`` sibling + ``os.replace``.

    ``emit`` receives an OPEN binary file object — np.savez must be
    handed a file object here, because given a string path without the
    ``.npz`` suffix it silently appends one.
    """
    part = path + ".part"
    with open(part, "wb") as f:
        emit(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, path)


def save(directory: str, step: int, tree, *, extra: Optional[Dict] = None,
         keep: int = 3) -> None:
    """Write ``tree`` (nested dicts of tensors/arrays) at ``step``."""
    os.makedirs(directory, exist_ok=True)
    host = {k: _host(v) for k, v in tree_lib.leaves_with_paths(tree)}
    meta = {
        "step": int(step),
        "time": time.time(),
        "extra": extra or {},
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": zlib.crc32(v.tobytes())}
                   for k, v in host.items()},
    }
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _atomic_write(os.path.join(tmp, "arrays.npz"),
                  lambda f: np.savez(f, **{k.replace("/", "|"): v
                                           for k, v in host.items()}))
    _atomic_write(os.path.join(tmp, "meta.json"),
                  lambda f: f.write(json.dumps(meta).encode()))
    _atomic_write(os.path.join(tmp, "COMMIT"),
                  lambda f: f.write(str(step).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def all_steps(directory: str):
    steps = []
    if not os.path.isdir(directory):
        return steps
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            commit = os.path.join(directory, name, "COMMIT")
            if os.path.exists(commit):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    pass
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_arrays(directory: str, step: int, *, verify: bool = True,
                   only: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """Load (a subset of) a step's host arrays, CRC-verified.

    ``only`` limits the read to the named keystr paths — the degraded
    serving path pulls just a fixup bitset out of an index checkpoint
    whose model arrays may be unreadable. Checkpoints predating
    checksums load unverified.
    """
    path = os.path.join(directory, f"step_{step}")
    meta = read_meta(directory, step)
    want = set(only) if only is not None else None
    host = {}
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k in z.files:
                key = k.replace("|", "/")
                if want is not None and key not in want:
                    continue
                raw = z[k]
                crc = meta["arrays"].get(key, {}).get("crc32")
                if verify and crc is not None and \
                        zlib.crc32(raw.tobytes()) != crc:
                    raise CheckpointCorruption(
                        f"array {key!r} in {path} failed its CRC32 "
                        f"(stored {crc})")
                host[key] = raw
    except CheckpointCorruption:
        raise
    except (OSError, zipfile.BadZipFile, zlib.error, ValueError,
            KeyError) as e:
        raise CheckpointCorruption(
            f"unreadable checkpoint step {step} in {directory}: {e}") from e
    if want is not None and want - set(host):
        raise CheckpointCorruption(
            f"checkpoint step {step} missing arrays {sorted(want - set(host))}")
    return host


def read_meta(directory: str, step: int) -> Dict:
    with open(os.path.join(directory, f"step_{step}", "meta.json")) as f:
        return json.load(f)
