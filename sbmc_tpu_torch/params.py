"""Carries parameters and optimizer state between the JAX package and the
port's modules, in both directions.

``read_msgpack`` decodes a flax-serialised msgpack file (a params
snapshot such as ``weights/flagship_f16/params_f16.msgpack`` or a training
checkpoint) into nested dicts of numpy arrays with the installed ``msgpack``
alone: flax stores an ndarray as msgpack ext type 1 holding
``(shape, dtype name, C-order bytes)``.

``load_jax_params`` maps the flax parameter paths onto the port's module
names (they are the same path with ``/`` for ``.``), transposes conv
kernels (``v`` of the conv chains, ``kernel`` of a plain flax ``nn.Conv``)
from HWIO to OIHW, upcasts to float32, and raises on a missing or
extra leaf or a wrong shape, as ``Checkpointer._check_compat`` does in the
JAX package. ``export_jax_params`` is its inverse, and ``pack_msgpack``
writes what ``read_msgpack`` reads, so a checkpoint written by either
package resumes in the other.

``export_adam_state`` / ``load_adam_state`` map ``torch.optim.Adam``'s
per-parameter ``exp_avg`` / ``exp_avg_sq`` / ``step`` onto the state of
``optax.chain(clip_by_global_norm, adam)`` as flax serialises it:
``{"0": {}, "1": {"0": {"count", "mu": {"params": ...}, "nu": {"params":
...}}, "1": {}}}``.
"""

import msgpack
import numpy as np
import torch

__all__ = ["read_msgpack", "pack_msgpack", "flatten", "unflatten",
           "load_jax_params", "export_jax_params", "export_adam_state",
           "load_adam_state"]

_EXT_NDARRAY = 1
_CONV_KERNELS = ("v", "kernel")  # 4-D leaves stored HWIO by flax


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


def _ext_default(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialise {type(obj).__name__}: a checkpoint "
                    "tree holds dicts and numpy arrays")


def pack_msgpack(tree):
    """Encode nested dicts of numpy arrays as flax msgpack bytes."""
    return msgpack.packb(tree, default=_ext_default, strict_types=True)


def flatten(tree, prefix=()):
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def unflatten(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for path, v in flat.items():
        d = out
        *head, last = path.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _named(model):
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def _to_flax(path, t):
    """A parameter-shaped tensor as the flax leaf at ``path`` (float32; conv
    kernels OIHW -> HWIO). Always a copy: the leaf must not change when the
    model trains on."""
    arr = t.detach().to("cpu", torch.float32).numpy()
    if path.rsplit("/", 1)[-1] in _CONV_KERNELS and arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
    return np.array(arr, dtype=np.float32, order="C", copy=True)


def _from_flax(path, arr, like):
    """The flax leaf at ``path`` in the layout of parameter ``like``; raises
    on a shape that does not match."""
    arr = np.asarray(arr)
    if path.rsplit("/", 1)[-1] in _CONV_KERNELS and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError("checkpoint shape mismatch at %s: model %s vs "
                         "checkpoint %s" % (path, tuple(like.shape),
                                            tuple(arr.shape)))
    return np.ascontiguousarray(arr, np.float32)


def _match(own, tree):
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten(tree)
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError("checkpoint does not match the model: missing %s, "
                         "unexpected %s" % (missing, extra))
    return {path: _from_flax(path, flat[path], p) for path, p in own.items()}


def export_jax_params(model):
    """The model's parameters as the flax variables ``{"params": {...}}``
    (float32 numpy; conv kernels HWIO): the inverse of
    :func:`load_jax_params`."""
    return {"params": unflatten({path: _to_flax(path, p)
                                 for path, p in _named(model).items()})}


def export_adam_state(model, optimizer):
    """``torch.optim.Adam``'s state for ``model``'s parameters as the
    serialised optax state (see the module docstring). Parameters the
    optimizer has not stepped yet export zero moments."""
    mu, nu, count = {}, {}, 0
    for path, p in _named(model).items():
        st = optimizer.state.get(p, {})
        mu[path] = _to_flax(path, st.get("exp_avg", torch.zeros_like(p)))
        nu[path] = _to_flax(path, st.get("exp_avg_sq", torch.zeros_like(p)))
        count = max(count, int(st.get("step", 0)))
    adam = {"count": np.asarray(count, np.int32),
            "mu": {"params": unflatten(mu)}, "nu": {"params": unflatten(nu)}}
    return {"0": {}, "1": {"0": adam, "1": {}}}


def load_adam_state(model, optimizer, tree):
    """Load a serialised optax state into ``optimizer`` (in place). Raises
    ``ValueError`` on a structure or shape that does not match."""
    try:
        adam = tree["1"]["0"]
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError("optimizer state is not that of optax.chain("
                         "clip_by_global_norm, adam): %r" % (e,)) from e
    own = _named(model)
    mu, nu = _match(own, mu), _match(own, nu)
    for path, p in own.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.from_numpy(mu[path]).to(p.device),
            "exp_avg_sq": torch.from_numpy(nu[path]).to(p.device)}


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
    own = _named(model)
    arrays = _match(own, tree)
    with torch.no_grad():
        for path, p in own.items():
            p.copy_(torch.from_numpy(arrays[path]))
    return model
