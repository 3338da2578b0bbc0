"""``python -m sbmc_tpu_torch.train DATA CKPT_DIR ...``: the training entry
point (:mod:`sbmc_tpu_torch.train_cli`)."""

from sbmc_tpu_torch.train_cli import cli

if __name__ == "__main__":
    cli()
