"""The Qwen3-VL families (``qwen3_vl`` and ``qwen3_vl_moe``) on the CPU
against the JAX package, on ``debug_vlm`` (2 layers, 4/2 heads of 32, a
2-block tower with one DeepStack tap) and its MoE variant (4 experts, top 2):
the training forward with and without vision inputs and with LoRA, the HF
conversion and ``spec_to_hf_config``, the Qwen3-VL-8B reader, the packed
vision streams of ``prepare_batch``, one train step, the sampler's prefill
and the engine (prompt logprobs, greedy tokens with the mRoPE decode offset,
a text prompt, the rejections, no prefix reuse for an image prompt, a
sampled image token left as text) and the server's ``mm`` wire. Weights come
from the JAX init, every leaf moved off its init value, carried across as
numpy; everything runs in float32.

Tolerances: 2e-4 on hidden states, logits and prompt logprobs (f32 sums in
another order through the tower and the trunk), 1e-4 relative on the step's
loss and metrics and 4e-5 absolute on the parameters after the update, as
the other families' tests; streams, specs, tokens and keys equal.
"""

import base64
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import LoRAConfig as JLoRAConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import lora as jlora
from prime_rl_tpu.models import qwen3_vl as jvl
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.models.base import spec_from_hf_config as j_spec_from_hf_config
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu.trainer.batch import prepare_batch as j_prepare_batch
from prime_rl_tpu.transport.types import TrainingSample as JTrainingSample
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.configs.shared import LoRAConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import lora as tlora
from prime_rl_tpu_torch.models import qwen3_next as tnext
from prime_rl_tpu_torch.models import qwen3_vl as tvl
from prime_rl_tpu_torch.models.base import get_spec, spec_from_hf_config
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights, params_from_jax
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams, prepare_mm
from prime_rl_tpu_torch.sampler.server import _mm_from_body
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.batch import prepare_batch
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config
from prime_rl_tpu_torch.transport.types import TrainingSample

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
MOE = dict(family="qwen3_vl_moe", num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64)
SPECS = {"dense": (j_get_spec("debug_vlm"), get_spec("debug_vlm")),
         "moe": (dataclasses.replace(j_get_spec("debug_vlm"), **MOE),
                 dataclasses.replace(get_spec("debug_vlm"), **MOE))}


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=["dense", "moe"])
def family(request):
    """(name, JAX spec, port spec, JAX params as numpy, port params): the JAX
    init from a seed with every leaf moved by 0.05 * N(0, 1)."""
    jspec, tspec = SPECS[request.param]
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
        jvl.init_params(jspec, jax.random.key(0)))
    return request.param, jspec, tspec, np_params, params_from_jax(np_params, tspec)


def _vlm_ids(spec, grids, n_text=6, tail=4, seed=0):
    rng = np.random.default_rng(seed)
    m = spec.vision.spatial_merge_size
    ids = list(rng.integers(3, 250, size=n_text))
    for t, h, w in grids:
        ids += [spec.vision_start_token_id] + [spec.image_token_id] * (t * (h // m) * (w // m))
        ids += list(rng.integers(3, 250, size=2))
    ids += list(rng.integers(3, 250, size=tail))
    grid = np.asarray(grids, np.int64)
    pixels = rng.standard_normal((int(grid.prod(axis=1).sum()), spec.vision.patch_dim))
    return ids, {"pixel_values": pixels.astype(np.float32), "image_grid_thw": grid}


def _samples(cls, spec, sampled_image_token=False):
    """A VLM sample of two images, a video sample (t = 2) and a text sample;
    ``sampled_image_token`` adds an image token after the images that no
    pixels stand behind."""
    out = []
    for grids, seed in (([(1, 4, 4), (1, 2, 4)], 0), ([(2, 2, 2)], 1)):
        ids, mm = _vlm_ids(spec, grids, seed=seed)
        if sampled_image_token:
            ids = ids[:-2] + [spec.image_token_id] + ids[-2:]
        n = len(ids)
        rng = np.random.default_rng(seed + 10)
        out.append(cls(token_ids=np.asarray(ids, np.int32), mask=np.ones(n, bool),
                       logprobs=rng.standard_normal(n).astype(np.float32),
                       temperatures=np.ones(n, np.float32), advantages=np.ones(n, np.float32),
                       mm_kwargs=mm))
    rng = np.random.default_rng(5)
    out.append(cls(token_ids=rng.integers(3, 250, 11).astype(np.int32), mask=np.ones(11, bool),
                   logprobs=rng.standard_normal(11).astype(np.float32),
                   temperatures=np.ones(11, np.float32), advantages=-np.ones(11, np.float32)))
    return out


def _batches(jspec, tspec, sampled_image_token=False):
    kw = dict(seq_len=64, micro_batch_rows=2, num_micro_batches=1)
    jb = j_prepare_batch(_samples(JTrainingSample, jspec, sampled_image_token), vlm_spec=jspec,
                         **kw)
    tb = prepare_batch(_samples(TrainingSample, tspec, sampled_image_token), vlm_spec=tspec, **kw)
    return jb, tb


def _mm(batch, i=0, to=torch.as_tensor):
    keys = ("patches", "vis_seg_ids", "vis_pos_idx", "vis_pos_w", "vis_rope_coords", "img_slot",
            "mm_position_ids")
    return {k: to(np.asarray(getattr(batch, f"mm_{k}" if k.startswith(("patches",
                                                                         "img", "vis"))
                                     else k))[i]) for k in keys}


def test_prepare_batch_mm_streams_match_jax():
    """Every stream of a packed batch of an image sample, a video sample and a
    text sample (the image token past the grids among them) equals the JAX
    package's, the auto-sized patch buffer too."""
    jspec, tspec = SPECS["dense"]
    for sampled in (False, True):
        jb, tb = _batches(jspec, tspec, sampled)
        assert tb.mm_patches is not None and tb.mm_patches.shape[1] == 256
        for field in tstep.MicroBatchArrays._fields:
            a, b = getattr(tb, field), getattr(jb, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
    b = prepare_batch(_samples(TrainingSample, tspec), 64, 2, 1, vlm_spec=tspec,
                      max_mm_patches=512)
    assert b.mm_patches.shape == (1, 512, tspec.vision.patch_dim)


@pytest.mark.parametrize("mode", ["mm", "text", "mm+lora", "sampled image token"])
def test_forward_matches_jax(family, mode):
    """Hidden states on the packed batch's rows (2e-4): with the vision
    streams, without them (plain rope), with a LoRA adapter on every target
    and with an image token that has no pixels behind it (it stays text)."""
    name, jspec, tspec, np_params, params = family
    jb, tb = _batches(jspec, tspec, sampled_image_token=mode == "sampled image token")
    ids, seg, pos = (np.asarray(getattr(tb, f))[0] for f in ("input_ids", "segment_ids",
                                                             "position_ids"))
    jkw = dict(compute_dtype=jnp.float32, remat="none", attn_impl="xla")
    tkw = dict(compute_dtype=torch.float32, remat="full" if mode == "mm" else "none")
    if mode != "text":
        jkw["mm"] = _mm(jb, to=jnp.asarray)
        tkw["mm"] = _mm(tb)
    if mode == "mm+lora":
        jcfg, tcfg = JLoRAConfig(rank=4, alpha=8.0), LoRAConfig(rank=4, alpha=8.0)
        rng = np.random.default_rng(3)
        ad = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
            x.shape, np.float32), jlora.init_lora(jspec, jcfg, jax.random.key(1)))
        jkw.update(lora=jax.tree.map(jnp.asarray, ad), lora_scale=jlora.lora_scale(jcfg))
        tkw.update(lora=tlora.lora_from_jax(ad), lora_scale=tlora.lora_scale(tcfg))
    want = jvl.forward(jax.tree.map(jnp.asarray, np_params), jspec,
                       *map(jnp.asarray, (ids, seg, pos)), **jkw)
    leaves = params if mode != "mm" else toptim.tree_map(lambda x: x.clone().requires_grad_(),
                                                         params)
    got = tvl.forward(leaves, tspec, *map(torch.from_numpy, (ids, seg, pos)), **tkw)
    real = seg > 0
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    if mode == "mm":  # the vision streams reach the hidden states
        plain = tvl.forward(params, tspec, *map(torch.from_numpy, (ids, seg, pos)),
                            compute_dtype=torch.float32, remat="none")
        assert not np.allclose(_np(plain)[real], _np(got)[real], atol=1e-3)


def test_hf_round_trip_and_config(tmp_path, family):
    """to_hf names every key the JAX package names, with equal values; from_hf
    gives the params back; a snapshot reloads through ``get_spec`` as the same
    VLM spec (``Qwen3VLForConditionalGeneration`` or its MoE name, with its
    nested text and vision configs) and ``load_hf_weights``."""
    name, jspec, tspec, np_params, params = family
    want = jvl.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), jspec)
    fam = get_family(tspec)
    state = fam.to_hf(params, tspec)
    assert set(state) == set(want)
    for k, v in state.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    back = fam.from_hf(state, tspec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa
    cfg = spec_to_hf_config(tspec)
    arch = "Qwen3VLMoeForConditionalGeneration" if name == "moe" else \
        "Qwen3VLForConditionalGeneration"
    assert cfg["architectures"] == [arch] and "vision_config" in cfg and "text_config" in cfg
    assert j_spec_from_hf_config(cfg).family == tspec.family
    save_hf_weights(params, tspec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == tspec
    loaded = load_hf_weights(tmp_path / "snap", tspec, dtype=torch.float32)
    for (pa, a), (_, b) in zip(toptim.tree_paths(params), toptim.tree_paths(loaded)):
        assert torch.equal(a.bfloat16().float(), b), pa


def test_qwen3_vl_8b_spec_matches_the_jax_reader():
    """``chip_smoke.QWEN3_VL_8B_CONFIG`` read by both packages: every field of
    the spec and of its tower equal; the widths are the model card's."""
    got = spec_from_hf_config(dict(chip_smoke.QWEN3_VL_8B_CONFIG))
    want = j_spec_from_hf_config(dict(chip_smoke.QWEN3_VL_8B_CONFIG))
    for f in dataclasses.fields(want):
        if f.name != "vision":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(want.vision):
        assert getattr(got.vision, f.name) == getattr(want.vision, f.name), f.name
    assert (got.hidden_size, got.num_layers, got.num_heads, got.num_kv_heads, got.head_dim,
            got.mrope_section) == (4096, 36, 32, 8, 128, (24, 20, 20))
    assert (got.vision.depth, got.vision.head_dim, got.vision.out_hidden_size,
            got.vision.deepstack_visual_indexes) == (27, 72, 4096, (8, 16, 24))


def test_qwen3_next_vl_still_waits():
    """The hybrid VLM (the second part of the VLM item, no longer waiting):
    its debug spec and a Qwen3.5 config with a tower resolve to
    ``qwen3_next_vl`` and its family, as the JAX package resolves them (the
    parity suite is tests/test_torch_qwen3_next_vl.py)."""
    spec = get_spec("debug_qwen3_next_vl")
    assert spec.family == "qwen3_next_vl" and spec.vision is not None
    assert dataclasses.asdict(spec) == dataclasses.asdict(j_get_spec("debug_qwen3_next_vl"))
    cfg = {"architectures": ["Qwen3_5MoeForConditionalGeneration"],
           "text_config": spec_to_hf_config(dataclasses.replace(spec, family="qwen3_next",
                                                                vision=None)),
           "vision_config": spec_to_hf_config(spec)["vision_config"]}
    got = spec_from_hf_config(cfg)
    assert got.family == "qwen3_next_vl" and got.mrope_section == (16, 8, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(j_spec_from_hf_config(cfg))
    assert get_family(got).init is tnext.init_params_vl


def _model_cfg(cls):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}},
               optimizer={"type": "sgd", "lr": 1e-2, "weight_decay": 0.1})


def test_train_step_matches_jax_step_one(family):
    """One packed batch of image, video and text samples through
    ``make_train_step``: loss, grad_norm and every metric (rtol 1e-4), and
    every parameter after an sgd update with weight decay, the tower's among
    them (atol 4e-5)."""
    name, jspec, tspec, np_params, params = family
    jb, tb = _batches(jspec, tspec)
    scale = float((np.asarray(tb.loss_mask)).sum())
    j_cfg, t_cfg = _model_cfg(JTrainerConfig), _model_cfg(TrainerConfig)
    j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info)
    j_batch = jstep.put_batch(jax.tree.map(jnp.asarray, jb), mesh_info)
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(
        jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0)))

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(tspec, "cpu", t_opt,
                                     params=toptim.tree_map(lambda x: x.clone(), params))
    t_step = tstep.make_train_step(tspec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, tb, tstep.Scales(scale, 1.0, 1.0))

    assert set(t_metrics) == set(j_metrics)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]), rtol=1e-4)
    for key, stat in t_metrics.items():
        if key not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[key].total),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    moved = 0
    for path, t in toptim.tree_paths(t_state.params):
        np.testing.assert_allclose(_np(t), j_flat[path], atol=4e-5, rtol=0, err_msg=path)
        moved += path.startswith("vision/blocks") and not torch.equal(
            t, dict(toptim.tree_paths(params))[path])
    assert moved  # the tower trains


CACHE = dict(num_pages=48, page_size=16, max_slots=4, max_seq_len=192)


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's engines on the same dense weights
    (scaled by 2 for decisive greedy tokens)."""
    jspec, tspec = SPECS["dense"]
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda x: (np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32))
        * np.float32(2.0), jvl.init_params(jspec, jax.random.key(0)))
    t_engine = Engine(params_from_jax(np_params, tspec), tspec, CacheConfig(**CACHE),
                      device="cpu", compute_dtype=torch.float32, decode_block=4)
    j_engine = JEngine(jax.tree.map(jnp.array, np_params), jspec, JCacheConfig(**CACHE),
                       compute_dtype=jnp.float32)
    return tspec, t_engine, j_engine


def test_engine_prompt_logprobs_and_greedy_tokens_match_jax(engines):
    """An image prompt (its prompt logprobs, 2e-4) and a video prompt whose
    text decodes after the grid (greedy tokens, with the mRoPE offset
    ``pos_delta``), and the same prompt with an image token past the grids
    (left as text): the JAX engine's results."""
    tspec, t_engine, j_engine = engines
    ids_a, mm_a = _vlm_ids(tspec, [(1, 4, 4), (1, 2, 4)], seed=3)
    ids_b, mm_b = _vlm_ids(tspec, [(2, 2, 2)], seed=4)
    ids_c = ids_b[:-2] + [tspec.image_token_id] + ids_b[-2:]
    score = dict(max_tokens=0, temperature=1.0, prompt_logprobs=True)
    greedy = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
    got = t_engine.generate([ids_a, ids_b, ids_c], [SamplingParams(**score),
                                                    SamplingParams(**greedy),
                                                    SamplingParams(**greedy)],
                            mm=[mm_a, mm_b, mm_b])
    want = j_engine.generate([ids_a, ids_b, ids_c], [JSamplingParams(**score),
                                                     JSamplingParams(**greedy),
                                                     JSamplingParams(**greedy)],
                             mm=[mm_a, mm_b, mm_b])
    np.testing.assert_allclose(np.asarray(got[0].prompt_logprobs)[1:],
                               np.asarray(want[0].prompt_logprobs)[1:], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.token_ids == w.token_ids and len(g.token_ids) == 6


def test_sampler_prefill_with_mm_matches_the_training_forward(engines):
    """The sampler's prefill of an image prompt, fed the tower's outputs and
    the per-frequency positions as the engine makes them: its prompt
    logprobs equal the training forward's log-softmax (2e-4)."""
    tspec, t_engine, _ = engines
    ids, mm = _vlm_ids(tspec, [(1, 4, 4)], seed=6)
    n = len(ids)
    lpad = 64
    mm_dev, delta = prepare_mm(t_engine.params, tspec, mm, ids, lpad, t_engine._to_dev,
                               torch.float32)
    params = t_engine.params
    ps = CACHE["page_size"]
    pool = [torch.zeros(tspec.num_kv_heads, 8, ps, tspec.head_dim) for _ in range(2)]
    pool2 = [torch.zeros_like(p) for p in pool]
    ids_pad = torch.zeros((1, lpad), dtype=torch.int64)
    ids_pad[0, :n] = torch.tensor(ids)
    _, _, _, plp = tmodel.prefill(params, tspec, pool, pool2, ids_pad, n,
                                  torch.arange(1, 1 + lpad // ps), compute_dtype=torch.float32,
                                  want_prompt_logprobs=True, mm=mm_dev)
    tb = prepare_batch([TrainingSample(token_ids=np.asarray(ids, np.int32),
                                       mask=np.ones(n, bool), logprobs=np.zeros(n, np.float32),
                                       temperatures=np.ones(n, np.float32), mm_kwargs=mm)],
                       n, 1, 1, vlm_spec=tspec)
    assert delta == int(np.asarray(tb.mm_position_ids).max()) + 1 - n
    stacked = _restack(t_engine.params, tspec)
    h = tvl.forward(stacked, tspec, torch.tensor([ids]), torch.ones(1, n, dtype=torch.int32),
                    torch.arange(n)[None], compute_dtype=torch.float32, remat="none",
                    mm=_mm(tb))
    lsm = torch.log_softmax(h[0] @ stacked["lm_head"], -1)
    want = lsm[torch.arange(n - 1), torch.tensor(ids[1:])]
    np.testing.assert_allclose(_np(plp[1:n]), _np(want), **TOL)


def _restack(serving: dict, spec) -> dict:
    """Serving layout (per-layer dicts) back to the stacked training layout."""
    layers = serving["layers"]
    out = {k: v for k, v in serving.items() if k != "layers"}
    out["layers"] = {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}
    return out


def test_text_prompt_and_mixed_batch_on_the_vlm_engine(engines):
    """A text prompt on the VLM engine decodes as a text model (plain rope,
    offset 0) beside an image prompt: the JAX engine's tokens."""
    tspec, t_engine, j_engine = engines
    text = list(range(3, 20))
    ids, mm = _vlm_ids(tspec, [(1, 4, 4)], seed=2)
    sp = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
    got = t_engine.generate([text, ids], SamplingParams(**sp), mm=[None, mm])
    want = j_engine.generate([text, ids], JSamplingParams(**sp), mm=[None, mm])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids and g.finish_reason == "length"


def test_image_prompt_takes_no_prefix_hit(engines):
    """Two image prompts with equal token ids and different pixels: the
    second reuses no cached page (the hash sees only the ids), and its tokens
    are its own; a text prompt repeated does hit the cache."""
    tspec, t_engine, _ = engines
    ids, mm = _vlm_ids(tspec, [(1, 4, 4)], n_text=40, seed=8)
    other = {**mm, "pixel_values": -mm["pixel_values"]}
    sp = SamplingParams(max_tokens=3, temperature=0.0, ignore_eos=True)
    before = t_engine.stats["prefill_tokens_cached"]
    t_engine.generate([ids], sp, mm=[mm])
    t_engine.generate([ids], sp, mm=[other])
    assert t_engine.stats["prefill_tokens_cached"] == before
    text = list(range(5, 60))
    t_engine.generate([text], sp)
    t_engine.generate([text], sp)
    assert t_engine.stats["prefill_tokens_cached"] > before


def test_mm_rejected_on_a_text_family_and_past_the_largest_bucket(engines):
    tspec, t_engine, _ = engines
    spec = get_spec("debug")
    params = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    engine = Engine(params, spec, CacheConfig(num_pages=16, page_size=16, max_slots=2,
                                              max_seq_len=128), device="cpu",
                    compute_dtype=torch.float32)
    mm = {"pixel_values": np.zeros((16, 96), np.float32), "image_grid_thw": np.asarray([[1, 4, 4]])}
    fut = engine.submit([1, 2, 3], SamplingParams(max_tokens=2), mm=mm)
    engine.run_until_idle()
    with pytest.raises(ValueError, match="takes no multimodal inputs"):
        fut.result()
    long_ids = [5] * (t_engine.buckets[-1] + 1)
    fut = t_engine.submit(long_ids, SamplingParams(max_tokens=1), mm=mm)
    t_engine.run_until_idle()
    with pytest.raises((ValueError, MemoryError)):
        fut.result()


def test_mm_from_body_takes_both_wire_forms():
    """``mm.pixel_values`` as a nested list and as base64 little-endian f32
    with its shape give the same arrays; no ``mm`` gives None."""
    rng = np.random.default_rng(0)
    pv = rng.standard_normal((8, 96)).astype(np.float32)
    grid = [[1, 2, 4]]
    listed = _mm_from_body({"mm": {"pixel_values": pv.tolist(), "image_grid_thw": grid}})
    b64 = _mm_from_body({"mm": {"pixel_values": {"b64": base64.b64encode(
        pv.astype("<f4").tobytes()).decode(), "shape": list(pv.shape)}, "image_grid_thw": grid}})
    for got in (listed, b64):
        np.testing.assert_array_equal(got["pixel_values"], pv)
        assert got["image_grid_thw"].dtype == np.int64
        np.testing.assert_array_equal(got["image_grid_thw"], grid)
    assert _mm_from_body({"token_ids": [1]}) is None
