"""Convert a reference (adobe/sbmc, PyTorch/ttools) checkpoint into a
checkpoint directory (counterpart of ``scripts/convert_checkpoint.py``).

    python -m sbmc_tpu_torch.convert_checkpoint MODEL.pth META.json OUT_DIR

Reads the ``.pth`` (tensors only: ``torch.load(weights_only=True)``), maps
its names onto the port's parameters (:mod:`sbmc_tpu_torch.train.convert`),
checks every leaf against the model that ``META.json`` describes, and
writes step 0 with fresh Adam state, tagged ``final``, in the JAX package's
checkpoint format, so the denoise and train entry points of both packages
read it.
"""

import argparse
import json

import torch

from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.train.convert import load_reference_state_dict
from sbmc_tpu_torch.train.interface import DenoiserInterface

__all__ = ["main", "parse_args"]


def main(args):
    blob = torch.load(args.pth, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob:
        state_dict = blob["model"]
    elif isinstance(blob, dict) and "state_dict" in blob:
        state_dict = blob["state_dict"]
    else:
        state_dict = blob
    with open(args.meta) as f:
        meta = json.load(f)
    model = load_reference_state_dict(build_model(meta), state_dict)
    iface = DenoiserInterface(model, device="cpu")
    Checkpointer(args.output, meta=meta).save(iface.state_tree(), 0,
                                              tag="final")
    print("converted %d tensors -> %s" % (len(state_dict), args.output))
    return iface


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("pth", help="reference .pth checkpoint file")
    parser.add_argument("meta", help="meta .json describing the model "
                        "(arch or kpcn_mode, model_params, data_params)")
    parser.add_argument("output", help="output checkpoint directory")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
