"""Data loaders for the RL trainer. ``FakeDataLoader`` generates random
packed batches with the full stream schema so the trainer and its bench mode
run with no orchestrator or inference process: the same numpy draws, in the
same order, as the JAX package's loader. The transport-fed loader waits for
the loop slice.
"""

from __future__ import annotations

import numpy as np

from prime_rl_tpu_torch.trainer.batch import prepare_batch, token_counts
from prime_rl_tpu_torch.trainer.step import MicroBatchArrays
from prime_rl_tpu_torch.transport.types import TrainingSample


class FakeDataLoader:
    """Synthetic GRPO-shaped batches: random tokens, random logprobs,
    per-sequence scalar advantages broadcast over sampled tokens."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        micro_batch_rows: int = 1,
        num_micro_batches: int = 4,
        sequences_per_batch: int | None = None,
        seed: int = 0,
        variable_lengths: bool = True,
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.micro_batch_rows = micro_batch_rows
        self.num_micro_batches = num_micro_batches
        self.sequences_per_batch = sequences_per_batch or micro_batch_rows * num_micro_batches
        self.rng = np.random.default_rng(seed)
        self.variable_lengths = variable_lengths

    def make_sample(self) -> TrainingSample:
        if self.variable_lengths:
            n = int(self.rng.integers(self.seq_len // 2, self.seq_len + 1))
        else:
            n = self.seq_len
        prompt_len = max(1, n // 4)
        mask = np.zeros(n, bool)
        mask[prompt_len:] = True
        adv = np.zeros(n, np.float32)
        adv[prompt_len:] = self.rng.normal()
        return TrainingSample(
            token_ids=self.rng.integers(0, self.vocab_size, n).astype(np.int32),
            mask=mask,
            logprobs=self.rng.normal(-2.0, 0.5, n).astype(np.float32),
            temperatures=np.ones(n, np.float32),
            env_name="fake",
            advantages=adv,
        )

    def next_batch(self) -> tuple[MicroBatchArrays, dict[str, int]]:
        samples = [self.make_sample() for _ in range(self.sequences_per_batch)]
        batch = prepare_batch(
            samples, self.seq_len, self.micro_batch_rows, self.num_micro_batches
        )
        return batch, token_counts(batch)
