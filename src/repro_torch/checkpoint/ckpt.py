"""Checkpointing: tensor tree ⇄ .npz with slash-joined key paths.  PyTorch
port of ``repro.checkpoint.ckpt``, in the same file layout, so that a
checkpoint written by either package restores in the other.

Layout: one array per leaf under its key path (dict keys and sequence
indices joined by "/"); bf16 stored as uint16 bits; ``__dtypes__`` (JSON,
leaf → dtype name), optional ``__meta__`` (JSON) and ``__checksum__``, a
CRC32 over every other entry's name and raw bytes in sorted key order.  A
save is atomic (temporary file, then rename); a truncated or corrupted file
raises ``ValueError`` on restore.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path

_ERRORS = (zlib.error, zipfile.BadZipFile, EOFError, OSError, ValueError)


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _crc_of(items: dict) -> int:
    """Content checksum over key names + raw array bytes, key-sorted so it
    is independent of insertion/zip member order."""
    crc = 0
    for k in sorted(items):
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(items[k]).tobytes(), crc)
    return crc


def _open(path: str):
    """``np.load`` with truncation/bit-rot mapped to a clear ValueError."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except _ERRORS as e:
        raise ValueError(f"checkpoint {path!r} is unreadable — truncated "
                         f"or corrupted ({e})") from e


def verify(path: str) -> None:
    """Recompute the stored content checksum; raise ``ValueError`` when the
    file is corrupted.  Checkpoints without a checksum pass unverified."""
    with _open(path) as data:
        try:
            if "__checksum__" not in data:
                return
            stored = int(data["__checksum__"])
            items = {k: data[k] for k in data.files if k != "__checksum__"}
        except _ERRORS as e:
            raise ValueError(f"checkpoint {path!r} is unreadable — "
                             f"truncated or corrupted ({e})") from e
    got = _crc_of(items)
    if got != stored:
        raise ValueError(
            f"checkpoint {path!r} failed its content checksum "
            f"(stored {stored:#010x}, recomputed {got:#010x}) — the file "
            f"was corrupted or modified after it was written")


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(stored array, dtype name) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``tree`` (tensors, numpy arrays or scalars as leaves)."""
    packed, dtypes = {}, {}

    def put(p, leaf):
        packed[_key(p)], dtypes[_key(p)] = _to_numpy(leaf)

    tree_map_with_path(put, tree)
    packed["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                         np.uint8)
    if metadata:
        packed["__meta__"] = np.frombuffer(json.dumps(metadata).encode(),
                                           np.uint8)
    packed["__checksum__"] = np.asarray(_crc_of(packed), np.uint32)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **packed)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _stored(data, dtypes: dict, key: str) -> torch.Tensor:
    """One stored leaf as a CPU tensor (bf16 restored from its bits)."""
    arr = data[key]
    if dtypes[key] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf comes back with
    the dtype and on the device of the matching ``like`` tensor (a numpy
    leaf of ``like`` gives a numpy array).  The checksum is verified first;
    a missing leaf raises ``KeyError``, a shape mismatch ``ValueError``."""
    verify(path)
    with _open(path) as data:
        dtypes = json.loads(bytes(data["__dtypes__"]).decode())

        def load(p, leaf):
            key = _key(p)
            if key not in data:
                stored = sorted(k for k in data.files
                                if not k.startswith("__"))
                raise KeyError(
                    f"checkpoint {path!r} has no leaf {key!r}; it stores "
                    f"{stored[:8]}{'…' if len(stored) > 8 else ''} — the "
                    f"restore target has a different tree structure")
            t = _stored(data, dtypes, key)
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(t.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {tuple(t.shape)} "
                    f"but the restore target expects {want} — the "
                    f"checkpoint was written for a different model/run "
                    f"configuration")
            if isinstance(leaf, torch.Tensor):
                return t.to(device=leaf.device, dtype=leaf.dtype)
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.numpy().astype(np.asarray(leaf).dtype, copy=False)

        return tree_map_with_path(load, like)


def load_subtree(path: str, prefix: str) -> dict:
    """The stored subtree under slash-joined ``prefix`` as a nested dict of
    CPU tensors, without a template (keys come back as strings, sequence
    indices included).  ``{}`` when nothing is stored there.  The JAX
    package returns numpy arrays; the port returns tensors, which hold bf16
    without an extra package."""
    out: dict = {}
    pre = prefix.rstrip("/") + "/"
    with _open(path) as data:
        dtypes = json.loads(bytes(data["__dtypes__"]).decode())
        for key in data.files:
            if key.startswith("__") or not key.startswith(pre):
                continue
            node = out
            parts = key[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _stored(data, dtypes, key)
    return out


def metadata(path: str) -> dict:
    with _open(path) as data:
        if "__meta__" in data:
            return json.loads(bytes(data["__meta__"]).decode())
    return {}


def check_fingerprint(path: str, meta: dict, want: dict, *,
                      defaults: dict | None = None,
                      ignore: tuple = ()) -> None:
    """Refuse resuming across a run-configuration change: ``meta`` (the
    stored metadata, backfilled in place with ``defaults``) must agree with
    ``want`` on every field not in ``ignore``, else ``ValueError`` names
    the mismatched fields."""
    for k, v in (defaults or {}).items():
        meta.setdefault(k, v)
    stale = {k: (meta.get(k), v) for k, v in want.items()
             if k not in ignore and meta.get(k) != v}
    if stale:
        raise ValueError(
            f"checkpoint {path!r} was written by a different run "
            f"configuration; refusing to resume (mismatched fields: "
            f"{ {k: f'{a!r} != {b!r}' for k, (a, b) in stale.items()} })")
