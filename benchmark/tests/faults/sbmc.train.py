"""Faults of a training cell of the sample-based splatting model (one
card, so no exchange to leave out)."""

from benchmark.tests.faults import (train_grad_flipped, train_half_batch,
                                    train_loss_altered,
                                    train_state_unchanged)

FAULTS = {"state_unchanged": train_state_unchanged,
          "half_batch": train_half_batch,
          "answer_altered": train_loss_altered,
          "flipped_grad": train_grad_flipped}
