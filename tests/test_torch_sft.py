"""The SFT slice on the CPU against the JAX package at debug size: the data
path (the fake stream's packed micro-batches array for array from one seed,
the messages tokenizer with a tools column, the subset mix), the trainer
(``train`` from one HF snapshot: per-step loss, nll and grad_norm and the
validation nll within rtol 1e-4, the tolerance of the RL trainers' agreement
in ``tests/test_torch_loop.py``), the entry point's records, checkpoints and
weight snapshots, and the refusals (no card without ``--device cpu``, LoRA,
a mesh larger than one device, a truncated vocabulary without random init).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs.trainer import SFTConfig as JSFTConfig
from prime_rl_tpu.configs.trainer import SFTDataConfig as JSFTDataConfig
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.trainer.sft import data as jdata
from prime_rl_tpu.trainer.sft.train import train as jtrain
from prime_rl_tpu.trainer.weights import save_hf_weights as j_save_hf_weights
from prime_rl_tpu_torch.configs import SFTConfig, SFTDataConfig
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.trainer.sft import data as tdata
from prime_rl_tpu_torch.trainer.sft.train import train as ttrain
from prime_rl_tpu_torch.utils import logger as tlogger
from prime_rl_tpu_torch.utils import pathing

torch.set_num_threads(2)


class ToolTok:
    """The stub chat tokenizer of the JAX package's SFT data tests: one id a
    character, the tool schemas rendered ahead of the messages."""

    eos_token_id = 0

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=False,
                            tools=None):
        text = f"[TOOLS:{len(tools)}]" if tools else ""
        for m in messages:
            text += f"<{m['role']}>{m['content']}"
        return [ord(c) % 256 for c in text]


@pytest.mark.parametrize("raw", [
    dict(seq_len=64, batch_size=4, micro_batch_size=2),
    dict(seq_len=128, batch_size=6, micro_batch_size=3, seed=5, fake_vocab=300),
    dict(seq_len=64, batch_size=4, micro_batch_size=2, subsets=[
        {"name": "a", "ratio": 2.0}, {"name": "b", "ratio": 1.0}]),
], ids=["fake", "fake seed 5", "two subsets"])
def test_fake_loader_packs_the_jax_batches(raw):
    """``setup_sft_loader`` gives the JAX package's packed micro-batches,
    every stream equal, for three batches from one config and seed; the
    counts agree and the rl stream carries zero weights."""
    cfg = dict(type="fake", **raw)
    j_loader = jdata.setup_sft_loader(JSFTDataConfig(**cfg))
    t_loader = tdata.setup_sft_loader(SFTDataConfig(**cfg))
    for _ in range(3):
        (jb, jc), (tb, tc) = j_loader.next_batch(), t_loader.next_batch()
        assert jc == tc and tc["ce"] > 0
        assert jb._fields == tb._fields
        for name, j, t in zip(jb._fields, jb, tb):
            if j is None:
                assert t is None, name
            else:
                np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=name)
        assert not np.asarray(tb.rl_weights).any()


@pytest.mark.parametrize("loss_mask", ["assistant", "all"])
def test_messages_tokenizer_with_tools_matches_jax(loss_mask):
    """Incremental chat-template rendering: the ids and the loss mask of a
    conversation with a tools column equal the JAX package's; the schema span
    is untrained; the assistant turns carry the mask."""
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "yo"}, {"role": "user", "content": "and?"},
            {"role": "assistant", "content": "done"}]
    tools = [{"name": "t"}, {"name": "u"}]
    out = []
    for mod, cfg_cls in ((jdata, JSFTDataConfig), (tdata, SFTDataConfig)):
        ds = mod.MessagesDataset.__new__(mod.MessagesDataset)
        ds.config = cfg_cls(type="hf", name="x", loss_mask=loss_mask)
        ds.tokenizer = ToolTok()
        out.append((ds.tokenize_messages(msgs), ds.tokenize_messages(msgs, tools=tools)))
    (j_plain, j_tools), (t_plain, t_tools) = out
    for j, t in ((j_plain, t_plain), (j_tools, t_tools)):
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
    ids, mask = t_tools
    assert len(ids) == len(t_plain[0]) + len("[TOOLS:2]")
    if loss_mask == "assistant":
        assert not mask[:len("[TOOLS:2]")].any() and 0 < mask.sum() < len(mask)
    else:
        assert mask.all()


def test_interleaved_mix_follows_the_ratios():
    """A 3:1 mix of two streams draws the same sequence of subsets as the
    JAX package's from one seed, within the JAX test's bounds (70-80%)."""
    def const(mod, env):
        while True:
            s = mod.sample_from_tokens(np.arange(4), np.ones(4, bool))
            s.env_name = env
            yield s

    names = []
    for mod in (jdata, tdata):
        it = iter(mod.InterleavedDataset([const(mod, "a"), const(mod, "b")], ratios=[3.0, 1.0],
                                         seed=0))
        names.append([next(it).env_name for _ in range(4000)])
    assert names[0] == names[1]
    assert 0.70 < names[1].count("a") / 4000 < 0.80
    with pytest.raises(ValueError, match="one ratio"):
        tdata.InterleavedDataset([const(tdata, "a")], ratios=[1.0, 2.0])


def _raw(model: str, out, **kw) -> dict:
    return dict(
        output_dir=str(out),
        model={"name": model, "attn": {"impl": "xla"}, "compute_dtype": "float32",
               "lm_head_chunk_size": 48},
        optimizer={"type": "adamw", "lr": 1e-3, "weight_decay": 0.1},
        data={"type": "fake", "seq_len": 64, "batch_size": 4, "micro_batch_size": 2},
        val={"interval": 2, "num_batches": 2},
        weight_ckpt={"interval": 2, "keep_last": 2}, **kw)


def _records(path) -> tuple[list[dict], list[dict]]:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if "loss" in r], [r for r in rows if "val_nll" in r]


def test_train_matches_the_jax_sft_trainer(tmp_path):
    """``train`` on the debug spec from one HF snapshot of the JAX init, three
    steps with validation every two: per-step loss, nll and grad_norm and the
    validation nll within rtol 1e-4 of the JAX package's ``train``; the
    returned records are the ones logged; snapshots and a checkpoint."""
    jspec = j_debug_spec()
    snap = tmp_path / "snapshot"
    j_save_hf_weights(jax.device_get(jqwen3.init_params(jspec, jax.random.key(0))), jspec, snap)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jtrain(JSFTConfig(**_raw(str(snap), jout, max_steps=3)))
    try:
        result = ttrain(SFTConfig(**_raw(str(snap), tout, max_steps=3), device="cpu"))
    finally:
        tlogger.reset_logger()
    (j_steps, j_val), (t_steps, t_val) = (_records(out / "metrics.jsonl") for out in (jout, tout))
    assert [r["step"] for r in t_steps] == [1, 2, 3] == [r["step"] for r in j_steps]
    assert [r["loss"] for r in result.records] == [r["loss"] for r in t_steps]
    for t, j in zip(t_steps, j_steps):
        assert t["total_tokens"] == j["total_tokens"]
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=f"step {t['step']} {key}")
    assert len(t_val) == len(j_val) == 1 and t_val[0]["step"] == 2
    np.testing.assert_allclose(t_val[0]["val_nll"], j_val[0]["val_nll"], rtol=1e-4)
    assert t_steps[0]["loss"] != t_steps[2]["loss"]
    assert pathing.is_stable(pathing.weights_dir(tout, 2))
    assert (tout / "checkpoints" / "step_3").is_dir()


def test_entrypoint_trains_on_the_cpu_and_raises_without_a_card(tmp_path, monkeypatch):
    """``entrypoints.sft --device cpu --data.type fake --model.name debug``
    takes its steps and writes records, validation, a snapshot and a
    checkpoint; without ``--device cpu`` and without a card it raises."""
    from prime_rl_tpu_torch.entrypoints import sft as entry

    out = tmp_path / "out"
    args = ["sft", "--data.type", "fake", "--model.name", "debug", "--max-steps", "2",
            "--data.seq-len", "64", "--data.batch-size", "4", "--data.micro-batch-size", "2",
            "--val.interval", "2", "--val.num-batches", "1", "--weight-ckpt.interval", "2",
            "--model.lm-head-chunk-size", "48", "--output-dir", str(out)]
    monkeypatch.setattr(sys, "argv", args + ["--device", "cpu"])
    try:
        entry.main()
    finally:
        tlogger.reset_logger()
    steps, val = _records(out / "metrics.jsonl")
    assert len(steps) == 2 and len(val) == 1
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    snap = pathing.weights_dir(out, 2)
    assert pathing.is_stable(snap) and get_spec(str(snap)) == get_spec("debug")
    assert (out / "checkpoints" / "step_2").is_dir()
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", args)
        with pytest.raises(RuntimeError):  # no card and no cpu asked for: no fallback
            entry.main()
        tlogger.reset_logger()


@pytest.mark.parametrize("over, err, match", [
    (dict(model={"name": "debug", "debug": {"vocab_size": 64}}), ValueError, "random_init"),
    (dict(model={"name": "debug_vlm", "lora": {"rank": 4}, "debug": {"random_init": True}},
          data={"type": "fake", "seq_len": 64, "batch_size": 2, "micro_batch_size": 2,
                "max_mm_patches": 256}), None, None),
    (dict(mesh={"fsdp": 2}), NotImplementedError, "item 11"),
    (dict(model={"name": "debug_vlm", "debug": {"random_init": True}},
          data={"type": "fake", "seq_len": 64, "batch_size": 2, "micro_batch_size": 2,
                "max_mm_patches": 256}), None, None),
], ids=["vocab guard", "lora", "mesh", "vision"])
def test_refusals(tmp_path, over, err, match):
    """The vocabulary guard (a deliberate divergence: the JAX SFT trainer has
    none) and a mesh larger than one device raise, naming their ROADMAP.md
    item where one waits. SFT on the vision families, with LoRA among them,
    runs since the VLM slice (``err`` None): a step of finite loss, whose
    batches carry the vision streams (the fake stream is text, so the patch
    buffer is all padding)."""
    config = SFTConfig(**{"output_dir": str(tmp_path), "device": "cpu", "max_steps": 1, **over})
    try:
        if err is None:
            result = ttrain(config)
            assert len(result.records) == 1 and np.isfinite(result.records[0]["loss"])
            return
        with pytest.raises(err, match=match):
            ttrain(config)
    finally:
        tlogger.reset_logger()


def _vision_stream(mod, spec, seed: int = 0):
    """Hand-built SFT samples of ``mod`` (either package's data module): an
    image of 4 x 4 or 2 x 4 patches in random text, its second half trainable,
    and a text sample every third."""
    rng = np.random.default_rng(seed)
    m = spec.vision.spatial_merge_size
    for i in range(10**6):
        n_text = int(rng.integers(8, 20))
        text = rng.integers(3, 250, n_text)
        if i % 3 == 2:
            yield mod.sample_from_tokens(text, np.arange(n_text) >= n_text // 2)
            continue
        grid = [(1, 4, 4), (1, 2, 4)][i % 2]
        n_img = grid[0] * (grid[1] // m) * (grid[2] // m)
        ids = np.concatenate([text[:4], [spec.vision_start_token_id],
                              [spec.image_token_id] * n_img, text[4:]]).astype(np.int32)
        s = mod.sample_from_tokens(ids, np.arange(len(ids)) >= len(ids) // 2)
        s.mm_kwargs = {"pixel_values": rng.standard_normal(
            (int(np.prod(grid)), spec.vision.patch_dim)).astype(np.float32),
            "image_grid_thw": np.asarray([grid], np.int64)}
        yield s


def test_train_on_vision_samples_matches_the_jax_sft_trainer(tmp_path, monkeypatch):
    """``train`` on ``debug_vlm`` from one HF snapshot (the port's
    ``Qwen3VLForConditionalGeneration`` export of the JAX init, read by both
    packages) over the same hand-built image and text samples, the patch
    buffer pinned at 256: per-step loss, nll and grad_norm within rtol 1e-4
    of the JAX package's ``train``."""
    from prime_rl_tpu.models import qwen3_vl as jvl
    from prime_rl_tpu.models.base import get_spec as j_get_spec
    from prime_rl_tpu_torch.models.qwen3 import params_from_jax
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    jspec, tspec = j_get_spec("debug_vlm"), get_spec("debug_vlm")
    snap = tmp_path / "snapshot"
    np_params = jax.device_get(jvl.init_params(jspec, jax.random.key(0)))
    save_hf_weights(params_from_jax(np_params, tspec), tspec, snap)
    monkeypatch.setattr(jdata, "_make_dataset", lambda cfg, tok: _vision_stream(jdata, jspec))
    monkeypatch.setattr(tdata, "_make_dataset", lambda cfg, tok: _vision_stream(tdata, tspec))
    raw = dict(_raw(str(snap), tmp_path / "jax", max_steps=2), val=None)
    raw["data"] = {**raw["data"], "max_mm_patches": 256}
    jtrain(JSFTConfig(**raw))
    raw["output_dir"] = str(tmp_path / "port")
    try:
        ttrain(SFTConfig(**raw, device="cpu"))
    finally:
        tlogger.reset_logger()
    j_steps, t_steps = (_records(tmp_path / d / "metrics.jsonl")[0] for d in ("jax", "port"))
    assert [r["step"] for r in t_steps] == [1, 2] == [r["step"] for r in j_steps]
    for t, j in zip(t_steps, j_steps):
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=f"step {t['step']} {key}")
