"""Map the reference's parameter names to the program's.

The program (``sbmc_tpu_torch.models``) names its modules after the JAX
package's flax keys: ``embedding_00``, ``propagation_00.left_1``,
``kernel_stage.kernel_regressor``, ``layer_0`` ... ``prediction``, and its
leaves ``v``, ``g``, ``bias``. The reference names the same parameters
``embed0``, ``unet0.down1``, ``regress``, ``conv0`` ... ``out`` and ``w``,
``g``, ``b``.
"""

import re

__all__ = ["program_name"]

_MODULES = [
    (re.compile(r"^embed(\d+)\."), lambda m: "embedding_%02d." % int(m[1])),
    (re.compile(r"^unet(\d+)\."), lambda m: "propagation_%02d." % int(m[1])),
    (re.compile(r"^regress\."), lambda m: "kernel_stage.kernel_regressor."),
]
_PARTS = [
    (re.compile(r"\.down(\d+)\."), lambda m: ".left_%s." % m[1]),
    (re.compile(r"\.up(\d+)\."), lambda m: ".right_%s." % m[1]),
    (re.compile(r"\.conv(\d+)\."), lambda m: ".layer_%s." % m[1]),
    (re.compile(r"\.out\."), lambda m: ".prediction."),
]
_LEAVES = {"w": "v", "g": "g", "b": "bias"}


def program_name(name):
    """The program's ``state_dict`` key of reference parameter ``name``."""
    for pat, rep in _MODULES:
        name = pat.sub(rep, name, count=1)
    for pat, rep in _PARTS:
        name = pat.sub(rep, name)
    head, leaf = name.rsplit(".", 1)
    return head + "." + _LEAVES[leaf]
