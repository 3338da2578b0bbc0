"""Import reference (adobe/sbmc, PyTorch/ttools) checkpoints into the port
(counterpart of ``sbmc_tpu/train/convert.py``).

The reference's ``state_dict`` names map onto the port's parameter names
(reference module structure: sbmc/models.py and sbmc/modules.py):

===============================================  ==========================
reference key                                     port parameter
===============================================  ==========================
embedding_NN.layer_i.layer.0.weight_v             embedding_NN.layer_i.v
embedding_NN.prediction.weight_g                  embedding_NN.prediction.g
propagation_NN.net(.next_level)*L.left.<cc>       propagation_NN.left_L.<cc>
propagation_NN.net(.next_level)*L.right.<cc>      propagation_NN.right_L.<cc>
kernel_regressor.<cc>                             kernel_stage.kernel_regressor.<cc>
diffuse.layer_i.layer.0.weight  (KPCN, no WN)     diffuse.layer_i.v
===============================================  ==========================

Conv weights stay OIHW, the port's layout; ``weight_g`` ``[out, 1, 1, 1]``
becomes ``[out]``. The weight-norm parameterisation is the reference's
(a norm per output channel over the other dims), so a converted model
computes what the reference model computes.
"""

import re

import torch

__all__ = ["reference_key_to_port", "torch_state_dict_to_port",
           "load_reference_state_dict"]

_CC_RE = re.compile(r"^(layer_\d+|prediction)$")
_LEAVES = {"weight_v": "v", "weight": "v", "weight_g": "g", "bias": "bias"}


def _convchain(tokens, key):
    """``['layer_0', 'layer', '0', 'weight_v']`` or ``['prediction',
    'bias']`` -> ``(layer, port leaf)``."""
    if not tokens or not _CC_RE.match(tokens[0]):
        raise ValueError("unexpected conv chain component in %r" % key)
    rest = tokens[1:]
    if rest[:2] == ["layer", "0"]:  # the hidden layers' Sequential wrapper
        rest = rest[2:]
    if len(rest) != 1 or rest[0] not in _LEAVES:
        raise ValueError("unexpected conv chain leaf in %r" % key)
    return tokens[0], _LEAVES[rest[0]]


def reference_key_to_port(key):
    """The port parameter name of reference ``state_dict`` key ``key``;
    raises ``ValueError`` on a key of no known module."""
    tokens = key.split(".")
    mod = tokens[0]
    if mod.startswith("embedding_") or mod in ("diffuse", "specular"):
        prefix, cc = [mod], tokens[1:]
    elif mod.startswith("propagation_"):
        if len(tokens) < 3 or tokens[1] != "net":
            raise ValueError("unexpected autoencoder key %r" % key)
        i = 2
        while i < len(tokens) and tokens[i] == "next_level":
            i += 1
        if i >= len(tokens) or tokens[i] not in ("left", "right"):
            raise ValueError("unexpected autoencoder branch in %r" % key)
        prefix, cc = [mod, "%s_%d" % (tokens[i], i - 2)], tokens[i + 1:]
    elif mod == "kernel_regressor":
        prefix, cc = ["kernel_stage", "kernel_regressor"], tokens[1:]
    else:
        raise ValueError("unrecognized reference parameter %r" % key)
    layer, leaf = _convchain(cc, key)
    return ".".join(prefix + [layer, leaf])


def torch_state_dict_to_port(state_dict, model):
    """Map a reference ``state_dict`` onto ``model``'s parameters.

    Returns ``{port name: float32 tensor}`` in the model's layout. Raises
    ``ValueError`` on a missing or extra parameter or a shape that does not
    match the model, as the JAX package's converter does."""
    own = dict(model.named_parameters())
    out = {}
    for key, value in state_dict.items():
        name = reference_key_to_port(key)
        t = torch.as_tensor(value).detach().to("cpu", torch.float32)
        if name.endswith(".g"):
            t = t.reshape(-1)
        out[name] = t
    missing, extra = sorted(set(own) - set(out)), sorted(set(out) - set(own))
    if missing or extra:
        raise ValueError("reference parameters do not match the model: "
                         "missing %s, extra %s" % (missing, extra))
    for name, p in own.items():
        if tuple(out[name].shape) != tuple(p.shape):
            raise ValueError("shape mismatch at %s: model %s vs reference %s"
                             % (name, tuple(p.shape),
                                tuple(out[name].shape)))
    return out


def load_reference_state_dict(model, state_dict):
    """Copy a reference ``state_dict`` into ``model`` (in place) and return
    it; raises ``ValueError`` as :func:`torch_state_dict_to_port` does."""
    params = torch_state_dict_to_port(state_dict, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model
