"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``).

A checkpoint is a pickle of the nested state (dicts, lists, tuples) with
every tensor (facade :class:`~.tensor.Tensor` or ``torch.Tensor``) packed
as a host numpy array and a dtype tag, and an ``LRScheduler`` as its
``state_dict`` under ``"__lr_scheduler__"``, as the JAX package packs them.
bfloat16 is stored as its uint16 bits with the tag ``"bfloat16"``, so no
``ml_dtypes`` is needed to write or read it.

``save`` writes a temporary file, renames it into place, then writes the
``<path>.sha256`` sidecar (digest and byte size;
``PADDLE_CHECKPOINT_CHECKSUM=0`` turns it off). ``load`` checks the sidecar
when there is one and raises :class:`CheckpointCorruptError` on a
truncated, changed or unpicklable file.

``load`` also reads files the JAX package's ``paddle_tpu.save`` wrote,
without importing it: the unpickler maps
``paddle_tpu.framework.io._TensorPayload`` onto this module's payload and
refuses any other ``paddle_tpu`` name. A JAX file's bfloat16 arrays are
``ml_dtypes`` arrays; where ``ml_dtypes`` is not installed, reading one
raises :class:`CheckpointCorruptError` naming it (nothing is cast).
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch

from . import place as place_mod
from .tensor import Parameter, Tensor

__all__ = ["save", "load", "CheckpointCorruptError"]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity checks at load."""

    def __init__(self, path, reason, expected_bytes=None, actual_bytes=None):
        self.path = path
        self.reason = reason
        self.expected_bytes = expected_bytes
        self.actual_bytes = actual_bytes
        size = ""
        if expected_bytes is not None or actual_bytes is not None:
            size = (f" (expected {expected_bytes} bytes, "
                    f"actual {actual_bytes} bytes)")
        super().__init__(f"corrupt checkpoint {path!r}: {reason}{size}")


def _sidecar_path(path):
    return f"{path}.sha256"


def _write_sidecar(path, digest, nbytes):
    """``<hexdigest> <nbytes>\\n``, written atomically."""
    tmp = f"{_sidecar_path(path)}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{digest} {nbytes}\n")
    os.replace(tmp, _sidecar_path(path))


def _read_sidecar(path):
    """(digest, nbytes), or None when absent or unreadable."""
    try:
        with open(_sidecar_path(path)) as f:
            parts = f.read().split()
        return parts[0], int(parts[1])
    except (OSError, ValueError, IndexError):
        return None


class _TensorPayload:
    """One packed tensor: a numpy ``array`` (uint16 bits for bfloat16),
    its paddle ``dtype_name``, whether it was a Parameter, and its name."""

    def __init__(self, array: np.ndarray, dtype_name: str, is_param: bool,
                 name):
        self.array = array
        self.dtype_name = dtype_name
        self.is_param = is_param
        self.name = name


def _payload(v: torch.Tensor, is_param=False, name=None):
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        arr = v.contiguous().view(torch.int16).numpy().view(np.uint16)
        return _TensorPayload(arr, "bfloat16", is_param, name)
    from .dtype import convert_dtype
    return _TensorPayload(v.numpy(), convert_dtype(v.dtype).name, is_param,
                          name)


def _pack(obj):
    from ..optimizer.lr import LRScheduler
    if isinstance(obj, Tensor):
        return _payload(obj._value, obj._is_param, obj.name)
    if isinstance(obj, torch.Tensor):
        return _payload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    if isinstance(obj, LRScheduler):
        return {"__lr_scheduler__": type(obj).__name__,
                "state": obj.state_dict()}
    return obj


def _payload_value(p: _TensorPayload) -> torch.Tensor:
    """A payload's CPU tensor, in its tagged dtype."""
    arr = p.array
    if p.dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)   # ours or ml_dtypes
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    from .dtype import to_torch_dtype
    return torch.from_numpy(np.array(arr, copy=True)).to(
        to_torch_dtype(p.dtype_name))


def _payload_numpy(p: _TensorPayload):
    if p.dtype_name != "bfloat16" or p.array.dtype.name == "bfloat16":
        return p.array
    from .dtype import bfloat16
    npd = bfloat16.np_dtype
    if npd is None:
        raise TypeError(
            "a bfloat16 tensor has no numpy form without the ml_dtypes "
            "package; load with return_numpy=False for torch tensors")
    return p.array.view(npd)


def _unpack(obj, return_numpy=False, place=None):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return _payload_numpy(obj)
        v = _payload_value(obj)
        if obj.is_param:
            return Parameter(v, name=obj.name, place=place)
        return Tensor(v, place=place)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, place) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy, place) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy, place) for v in obj)
    return obj


class _HashingWriter:
    """Digests exactly the bytes pickle streams out, so the sidecar needs
    no second copy of the payload in memory."""

    def __init__(self, f):
        self._f = f
        self.sha256 = hashlib.sha256()
        self.nbytes = 0

    def write(self, b):
        self.sha256.update(b)
        self.nbytes += len(b)
        return self._f.write(b)


class _Unpickler(pickle.Unpickler):
    """Reads the port's files and the JAX package's: its payload class is
    mapped onto ours; any other ``paddle_tpu`` name is refused."""

    def find_class(self, module, name):
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            if (module, name) == ("paddle_tpu.framework.io",
                                  "_TensorPayload"):
                return _TensorPayload
            raise pickle.UnpicklingError(
                f"refusing {module}.{name}: only tensor payloads are read "
                f"from the JAX package's checkpoints")
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            try:
                return super().find_class(module, name)
            except ImportError as e:
                raise pickle.UnpicklingError(
                    f"a bfloat16 array of the JAX package needs the "
                    f"ml_dtypes package, which is not installed ({e})") \
                    from e
        return super().find_class(module, name)


def save(obj, path, protocol=4, checksum=None, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if checksum is None:
        checksum = os.environ.get("PADDLE_CHECKPOINT_CHECKSUM", "1") != "0"
    # write, then rename: a save killed midway leaves the previous file
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            w = _HashingWriter(f)
            pickle.dump(_pack(obj), w, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # the sidecar after the rename: a kill in between leaves a stale
        # sidecar, which can only fail the file just written
        if checksum:
            _write_sidecar(path, w.sha256.hexdigest(), w.nbytes)
        elif os.path.exists(_sidecar_path(path)):
            os.unlink(_sidecar_path(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path, return_numpy=False, verify_checksum=True, **configs):
    """The object :func:`save` wrote. Tensors come back as facade Tensors
    on the current place, or as numpy arrays with ``return_numpy``."""
    sidecar = _read_sidecar(path) if verify_checksum else None
    actual = os.path.getsize(path)  # a missing file raises FileNotFoundError
    if sidecar is not None:
        digest, nbytes = sidecar
        if actual != nbytes:
            raise CheckpointCorruptError(
                path, "truncated (size differs from .sha256 sidecar)",
                expected_bytes=nbytes, actual_bytes=actual)
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != digest:
            raise CheckpointCorruptError(
                path, "sha256 mismatch vs sidecar",
                expected_bytes=nbytes, actual_bytes=actual)
    try:
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
    except Exception as e:  # UnpicklingError, EOFError, ValueError, ...
        raise CheckpointCorruptError(
            path, f"unpicklable ({type(e).__name__}: {e})",
            expected_bytes=sidecar[1] if sidecar else None,
            actual_bytes=actual) from e
    place = None if return_numpy else place_mod._get_current_place()
    return _unpack(obj, return_numpy=return_numpy, place=place)
