"""``python -m sbmc_tpu_torch.train DATA CKPT_DIR ...``: the training entry
point (:mod:`sbmc_tpu_torch.train_cli`)."""

from sbmc_tpu_torch.train_cli import main, parse_args

if __name__ == "__main__":
    main(parse_args())
