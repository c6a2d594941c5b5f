"""SFT datasets: fake, prompt-completion, and messages formats with role
loss-masking and sequence packing (the port of the JAX package's
``trainer/sft/data.py``, numpy on the host as there).

Examples are tokenized into ``TrainingSample``s (the same wire type the RL
path trains on: ``ce_weights`` carries the SFT loss mask) and packed by the
shared packer into fixed-shape micro-batches, so SFT and RL share one train
step. The same config and seed give the JAX package's batches, array for
array. ``datasets`` is imported only by the HF datasets; the vision streams
(``vlm_spec``, ``max_mm_patches``) raise until the VLM slice.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator

import numpy as np

from prime_rl_tpu_torch.configs.trainer import SFTDataConfig
from prime_rl_tpu_torch.trainer.batch import prepare_batch, token_counts, truncate_sample
from prime_rl_tpu_torch.trainer.step import MicroBatchArrays
from prime_rl_tpu_torch.transport.types import TrainingSample


def sample_from_tokens(token_ids: np.ndarray, trainable: np.ndarray) -> TrainingSample:
    """SFT sample: CE on trainable tokens, rl component disabled (zero
    weights), neutral logprob/temperature streams."""
    n = len(token_ids)
    return TrainingSample(
        token_ids=token_ids.astype(np.int32),
        mask=trainable.astype(bool),
        logprobs=np.zeros(n, np.float32),
        temperatures=np.ones(n, np.float32),
        env_name="sft",
        rl_weights=np.zeros(n, np.float32),
        ce_weights=trainable.astype(np.float32),
    )


class FakeDataset:
    """Random token streams (reference: sft/data.py FakeDataset)."""

    def __init__(self, config: SFTDataConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)

    def __iter__(self) -> Iterator[TrainingSample]:
        c = self.config
        while True:
            n = int(self.rng.integers(c.seq_len // 4, c.seq_len + 1))
            prompt = max(1, n // 4)
            trainable = np.zeros(n, bool)
            trainable[prompt:] = True
            yield sample_from_tokens(
                self.rng.integers(0, c.fake_vocab, n), trainable
            )


class PromptCompletionDataset:
    """HF dataset with ``prompt``/``completion`` text columns; loss on the
    completion tokens only."""

    def __init__(self, config: SFTDataConfig, tokenizer):
        self.config = config
        self.tokenizer = tokenizer
        import datasets

        self.ds = datasets.load_dataset(config.name, split=config.split)
        if config.num_examples:
            self.ds = self.ds.select(range(min(config.num_examples, len(self.ds))))

    def __iter__(self) -> Iterator[TrainingSample]:
        for epoch in itertools.count():
            ds = self.ds.shuffle(seed=self.config.seed + epoch)
            for ex in ds:
                prompt_ids = self.tokenizer(ex["prompt"], add_special_tokens=True)["input_ids"]
                completion_ids = self.tokenizer(ex["completion"], add_special_tokens=False)["input_ids"]
                ids = np.array(prompt_ids + completion_ids, np.int32)
                trainable = np.zeros(len(ids), bool)
                trainable[len(prompt_ids):] = True
                if self.config.loss_mask == "all":
                    trainable[:] = True
                yield sample_from_tokens(ids, trainable)


class MessagesDataset:
    """HF dataset with a ``messages`` column (chat format); loss on assistant
    turns, masked via incremental chat-template rendering — token-exact
    against the template the model will be served with."""

    def __init__(self, config: SFTDataConfig, tokenizer):
        self.config = config
        self.tokenizer = tokenizer
        import datasets

        self.ds = datasets.load_dataset(config.name, split=config.split)
        if config.num_examples:
            self.ds = self.ds.select(range(min(config.num_examples, len(self.ds))))

    def tokenize_messages(self, messages: list[dict],
                          tools: list | None = None) -> tuple[np.ndarray, np.ndarray]:
        tok = self.tokenizer
        prev_ids: list[int] = []
        trainable_flags: list[bool] = []
        kw = {}
        if tools:
            # tools-schema rendering: the template injects the schemas into
            # the system region (reference: sft/data.py tools columns)
            kw["tools"] = tools
        for i in range(len(messages)):
            prefix = messages[: i + 1]
            add_gen = False
            try:
                ids = tok.apply_chat_template(prefix, tokenize=True,
                                              add_generation_prompt=add_gen, **kw)
            except TypeError:  # tokenizer without tools support (ByteTokenizer)
                ids = tok.apply_chat_template(prefix, tokenize=True,
                                              add_generation_prompt=add_gen)
            new = ids[len(prev_ids):]
            is_assistant = messages[i].get("role") == "assistant"
            trainable_flags.extend([is_assistant] * len(new))
            prev_ids = ids
        ids_arr = np.array(prev_ids, np.int32)
        mask = np.array(trainable_flags, bool)
        if self.config.loss_mask == "all":
            mask[:] = True
        return ids_arr, mask

    def __iter__(self) -> Iterator[TrainingSample]:
        import json

        for epoch in itertools.count():
            ds = self.ds.shuffle(seed=self.config.seed + epoch)
            for ex in ds:
                tools = ex.get("tools")
                if isinstance(tools, str) and tools:
                    tools = json.loads(tools)
                ids, mask = self.tokenize_messages(ex["messages"], tools or None)
                yield sample_from_tokens(ids, mask)


class SFTBatchLoader:
    """Pulls examples from a dataset iterator and packs fixed-shape batches."""

    def __init__(self, config: SFTDataConfig, dataset_iter: Iterator[TrainingSample],
                 vlm_spec=None, max_mm_patches: int = 0):
        if vlm_spec is not None or max_mm_patches > 0:
            raise NotImplementedError("SFT on vision inputs waits for the VLM slice "
                                      "(ROADMAP.md, Queue 1 item 9)")
        self.config = config
        self.it = dataset_iter
        self.num_micro_batches = max(1, config.batch_size // max(config.micro_batch_size, 1))

    def next_batch(self) -> tuple[MicroBatchArrays, dict[str, int]]:
        samples = []
        for _ in range(self.config.batch_size):
            s = next(self.it)
            if len(s) > self.config.seq_len:
                s = truncate_sample(s, self.config.seq_len)
            samples.append(s)
        batch = prepare_batch(samples, self.config.seq_len, self.config.micro_batch_size,
                              self.num_micro_batches)
        return batch, token_counts(batch)


class InterleavedDataset:
    """Weighted mix over subset datasets (reference: sft/data.py subset
    interleaving with ratios): each example is drawn from subset i with
    probability ratio_i / sum(ratios), seeded-reproducible."""

    def __init__(self, iterators: list[Iterator[TrainingSample]],
                 ratios: list[float], seed: int = 0):
        if len(iterators) != len(ratios):
            raise ValueError("one ratio per subset")
        self.iterators = iterators
        p = np.asarray(ratios, np.float64)
        self.p = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[TrainingSample]:
        while True:
            i = int(self.rng.choice(len(self.iterators), p=self.p))
            yield next(self.iterators[i])


def _make_dataset(config: SFTDataConfig, tokenizer):
    if config.type == "fake":
        return FakeDataset(config)
    if config.format == "prompt_completion":
        return PromptCompletionDataset(config, tokenizer)
    return MessagesDataset(config, tokenizer)


def setup_sft_loader(config: SFTDataConfig, tokenizer=None, vlm_spec=None,
                     max_mm_patches: int = 0) -> SFTBatchLoader:
    mm = {"vlm_spec": vlm_spec, "max_mm_patches": max_mm_patches}
    if config.subsets:
        iterators, ratios = [], []
        for i, sub in enumerate(config.subsets):
            sub_cfg = config.model_copy(update={
                "name": sub.name, "split": sub.split, "format": sub.format,
                "subsets": [], "seed": config.seed + i,
            })
            iterators.append(iter(_make_dataset(sub_cfg, tokenizer)))
            ratios.append(sub.ratio)
        return SFTBatchLoader(config, iter(InterleavedDataset(iterators, ratios, config.seed)), **mm)
    return SFTBatchLoader(config, iter(_make_dataset(config, tokenizer)), **mm)
