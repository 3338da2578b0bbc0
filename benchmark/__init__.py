"""The benchmark of sbmc_tpu_torch: see README.md."""
