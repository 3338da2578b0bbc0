"""Carries the JAX package's parameters into the port's modules.

``read_msgpack`` decodes a flax-serialised msgpack file (a params
snapshot such as ``weights/flagship_f16/params_f16.msgpack`` or a training
checkpoint) into nested dicts of numpy arrays with the installed ``msgpack``
alone: flax stores an ndarray as msgpack ext type 1 holding
``(shape, dtype name, C-order bytes)``.

``load_jax_params`` maps the flax parameter paths onto the port's module
names (they are the same path with ``/`` for ``.``), transposes conv
kernels from HWIO to OIHW, upcasts to float32, and raises on a missing or
extra leaf or a wrong shape, as ``Checkpointer._check_compat`` does in the
JAX package.
"""

import msgpack
import numpy as np
import torch

__all__ = ["read_msgpack", "flatten", "load_jax_params"]

_EXT_NDARRAY = 1


def _ext_hook(code, data):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported flax msgpack ext type {code}")
    shape, name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape).copy()


def read_msgpack(path):
    """Decode a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def flatten(tree, prefix=()):
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def load_jax_params(model, tree):
    """Copy a flax parameter tree into ``model`` (in place) and return it.

    Args:
      model: a port module whose parameter names mirror the flax module
        tree (``embedding_00.layer_0.v`` <-> ``embedding_00/layer_0/v``).
      tree: the flax variables (``{"params": {...}}``) or the params dict.

    Raises:
      ValueError: on a missing or extra leaf, or a shape that does not
        match the model.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten(tree)
    own = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError("checkpoint does not match the model: missing %s, "
                         "unexpected %s" % (missing, extra))
    arrays = {}
    for path, p in own.items():
        arr = np.asarray(flat[path])
        if path.rsplit("/", 1)[-1] == "v" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError("checkpoint shape mismatch at %s: model %s vs "
                             "checkpoint %s" % (path, tuple(p.shape),
                                                tuple(arr.shape)))
        arrays[path] = arr
    with torch.no_grad():
        for path, p in own.items():
            p.copy_(torch.from_numpy(
                np.ascontiguousarray(arrays[path], np.float32)))
    return model
