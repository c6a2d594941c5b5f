"""The hybrid vision-language family ``qwen3_next_vl`` (the GatedDeltaNet
trunk of ``qwen3_next`` with the Qwen3-VL tower) on the CPU against the JAX
package, on the debug spec both packages name ``debug_qwen3_next_vl`` (LLLA,
gated attention at partial rotary with mRoPE section (2, 1, 1), 8 experts
top-2 with a gated shared expert, a 2-block tower with one DeepStack tap):
the training forward with vision inputs (and with LoRA, with the adapter
gradients), the HF conversion
both ways and the snapshot's config, the Qwen3.5-class composition that
``chip_smoke.py`` serves read as the JAX package reads it, one RL and one SFT
train step (loss, metrics and every gradient, the tower's included), the
adapter gradients, and the engine's greedy tokens on an image prompt (the
vision prefill, the recurrent decode and the mRoPE offset ``pos_delta``).
Weights are the JAX init's from a seed with every leaf moved by 0.05 *
N(0, 1) (doubled for the engine, so that greedy tokens are decisive),
carried across as numpy; float32 throughout. The JAX functions run under
``jax.jit``.

Tolerances: 2e-4 (atol and rtol) on hidden states (f32 sums in another order
through the tower, the chunked rule and the trunk); 1e-4 relative on a
step's loss and metrics; each parameter's gradient (the update of sgd at lr
1 without weight decay) within 1e-3 of its norm; each adapter gradient at
rtol 2e-4 and atol 1e-5 of its largest magnitude, as
``tests/test_torch_lora.py`` holds every family; keys, specs, streams and
tokens equal.
"""

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
from prime_rl_tpu.models import qwen3_next as jnext
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.models.base import spec_from_hf_config as j_spec_from_hf_config
from prime_rl_tpu.ops import gated_delta as jgd
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu.trainer.batch import prepare_batch as j_prepare_batch
from prime_rl_tpu.trainer.sft import data as jsft
from prime_rl_tpu.transport.types import TrainingSample as JTrainingSample
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.configs.shared import LoRAConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import lora as tlora
from prime_rl_tpu_torch.models import qwen3_next as tnext
from prime_rl_tpu_torch.models.base import get_spec, spec_from_hf_config
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights, params_from_jax
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.batch import prepare_batch
from prime_rl_tpu_torch.trainer.sft import data as tsft
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config
from prime_rl_tpu_torch.transport.types import TrainingSample

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

NAME = "debug_qwen3_next_vl"
TOL = dict(atol=2e-4, rtol=2e-4)
MM_KEYS = ("patches", "vis_seg_ids", "vis_pos_idx", "vis_pos_w", "vis_rope_coords", "img_slot",
           "mm_position_ids")

j_forward = jax.jit(jnext.forward, static_argnums=(1,),
                    static_argnames=("compute_dtype", "attn_impl", "remat"))


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


@pytest.fixture(scope="module")
def model():
    """(JAX spec, port spec, JAX params as numpy, the same params in the port)."""
    if not _weights:
        jspec, spec = j_get_spec(NAME), get_spec(NAME)
        rng = np.random.default_rng(0)
        np_params = jax.tree.map(
            lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
            jax.jit(jnext.init_params_vl, static_argnums=0)(jspec, jax.random.key(0)))
        _weights["m"] = (jspec, spec, np_params, params_from_jax(np_params, spec))
    return _weights["m"]


def _vlm_ids(spec, grids, n_text=6, tail=4, seed=0):
    """Token ids of random text around one vision block a grid, and the
    block's pixels."""
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


def _samples(cls, spec):
    """RL samples: one of two images, a video sample (t = 2) and a text
    sample, with the per-token weights of the RL loss alone written out (the
    streams an SFT batch carries too, so that both batches feed one compiled
    JAX step)."""
    out = []
    for grids, seed in (([(1, 4, 4), (1, 2, 4)], 0), ([(2, 2, 2)], 1), (None, 5)):
        rng = np.random.default_rng(seed + 10)
        if grids is None:
            ids, mm = list(rng.integers(3, 250, 11)), None
        else:
            ids, mm = _vlm_ids(spec, grids, seed=seed)
        n = len(ids)
        out.append(cls(token_ids=np.asarray(ids, np.int32), mask=np.ones(n, bool),
                       logprobs=rng.standard_normal(n).astype(np.float32),
                       temperatures=np.ones(n, np.float32),
                       advantages=np.full(n, -1.0 if mm is None else 1.0, np.float32),
                       rl_weights=np.ones(n, np.float32), ce_weights=np.zeros(n, np.float32),
                       mm_kwargs=mm))
    return out


def _sft_samples(mod, spec):
    """SFT samples of ``mod`` (either package's SFT data module): two images
    in text, their second half trainable, and a text sample."""
    out = []
    for grids, seed in (([(1, 4, 4)], 2), ([(1, 2, 4)], 3)):
        ids, mm = _vlm_ids(spec, grids, seed=seed)
        ids = np.asarray(ids, np.int32)
        s = mod.sample_from_tokens(ids, np.arange(len(ids)) >= len(ids) // 2)
        s.mm_kwargs = mm
        out.append(s)
    text = np.random.default_rng(4).integers(3, 250, 13).astype(np.int32)
    out.append(mod.sample_from_tokens(text, np.arange(13) >= 4))
    return out


def _batches(jspec, spec, sft: bool = False):
    """Both packages' packed batch (rows of 64, two a micro-batch) of the RL
    or the SFT samples."""
    kw = dict(seq_len=64, micro_batch_rows=2, num_micro_batches=1)
    if sft:
        return (j_prepare_batch(_sft_samples(jsft, jspec), vlm_spec=jspec, **kw),
                prepare_batch(_sft_samples(tsft, spec), vlm_spec=spec, **kw))
    return (j_prepare_batch(_samples(JTrainingSample, jspec), vlm_spec=jspec, **kw),
            prepare_batch(_samples(TrainingSample, spec), vlm_spec=spec, **kw))


def _mm(batch, to=torch.as_tensor):
    """The first micro-batch's vision streams as a forward's ``mm``."""
    return {k: to(np.asarray(getattr(batch, k if k == "mm_position_ids" else f"mm_{k}"))[0])
            for k in MM_KEYS}


def test_spec_and_family_resolve_as_in_jax(model):
    """``debug_qwen3_next_vl`` equals the JAX package's spec field for field,
    the tower's too, and resolves to the hybrid VLM family."""
    jspec, spec, _, _ = model
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.family == "qwen3_next_vl" and spec.gdn_pattern == "LLLA"
    assert get_family(spec).forward is tnext.forward


def test_forward_with_images_matches_jax(model):
    """Hidden states on the packed rows of an image sample, a video sample
    and a text sample with the vision streams (2e-4; the port under full
    remat, the tower's blocks included). The pixels, the DeepStack tap and
    the mRoPE positions each reach the states, and an image's pixels reach
    no other sample's."""
    jspec, spec, np_params, params = model
    jb, tb = _batches(jspec, spec)
    ids, seg, pos = (np.asarray(getattr(tb, f))[0] for f in ("input_ids", "segment_ids",
                                                             "position_ids"))
    want = j_forward(jax.tree.map(jnp.asarray, np_params), jspec,
                     *map(jnp.asarray, (ids, seg, pos)), compute_dtype=jnp.float32,
                     remat="none", attn_impl="xla", mm=_mm(jb, jnp.asarray))
    args = tuple(map(torch.from_numpy, (ids, seg, pos)))
    mm = _mm(tb)
    got = tnext.forward(params, spec, *args, compute_dtype=torch.float32, remat="full", mm=mm)
    real = seg > 0
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    img = mm["img_slot"] >= 0
    assert bool(img.any()) and bool((mm["mm_position_ids"][0] != torch.from_numpy(pos)).any())

    def moved(**kw):
        h = tnext.forward(params, spec, *args, compute_dtype=torch.float32, remat="none", **kw)
        return float((h - got).abs()[torch.from_numpy(real)].max())

    assert moved(mm=None) > 1e-3  # the tower's rows and the mRoPE positions
    assert moved(mm={**mm, "patches": mm["patches"] + 1.0}) > 1e-3  # the pixels
    no_tap = dataclasses.replace(spec.vision, deepstack_visual_indexes=())
    h = tnext.forward({**params, "vision": {**params["vision"], "ds_mergers": {}}},
                      dataclasses.replace(spec, vision=no_tap), *args,
                      compute_dtype=torch.float32, remat="none", mm=mm)
    assert float((h - got).abs()[torch.from_numpy(real)].max()) > 1e-3  # the DeepStack tap
    # the GDN layers and the attention read the text segments: new pixels of
    # the first sample's images move its states and no other sample's
    first = int((mm["vis_seg_ids"] > 0).sum()) - 8  # its 16 + 8 patches; the video's 8 follow
    assert first == 24
    h = tnext.forward(params, spec, *args, compute_dtype=torch.float32, remat="none",
                      mm={**mm, "patches": torch.cat([mm["patches"][:first] + 1.0,
                                                      mm["patches"][first:]])})
    own = torch.from_numpy(seg == seg[0, 0])
    assert float((h - got).abs()[own].max()) > 1e-3
    np.testing.assert_allclose(_np(h)[real & ~own.numpy()], _np(got)[real & ~own.numpy()],
                               atol=1e-5, rtol=0)


def test_hf_round_trip_and_snapshot(tmp_path, model):
    """``to_hf`` names every key the JAX package's ``params_to_hf_state_dict_vl``
    names (the text under ``model.language_model.*``, the tower under
    ``model.visual.*``), with equal values; ``from_hf`` gives the params back
    in both packages (1e-7: the zero-centred norms' +1 folded out and in); a snapshot's config (``Qwen3_5MoeForConditionalGeneration``
    around a ``Qwen3NextForCausalLM`` text config) reads back to the same
    spec through the port's ``get_spec`` and the JAX reader, and its weights
    through ``load_hf_weights``."""
    jspec, spec, np_params, params = model
    want = jnext.params_to_hf_state_dict_vl(jax.tree.map(jnp.asarray, np_params), jspec)
    fam = get_family(spec)
    state = fam.to_hf(params, spec)
    assert set(state) == set(want)
    assert any(k.startswith("model.language_model.layers.3.self_attn") for k in state)
    assert any(k.startswith("model.visual.deepstack_merger_list.0") for k in state)
    for k, v in state.items():
        np.testing.assert_allclose(v, np.asarray(want[k]), atol=1e-7, rtol=0, err_msg=k)
    back = fam.from_hf(state, spec)
    j_back = dict(toptim.tree_paths(jax.tree.map(
        np.asarray, jnext.params_from_hf_state_dict_vl(state, jspec))))
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-7, rtol=0, err_msg=pa)
        np.testing.assert_allclose(j_back[pa], _np(a), atol=1e-7, rtol=0, err_msg=pa)
    cfg = spec_to_hf_config(spec)
    assert cfg["architectures"] == ["Qwen3_5MoeForConditionalGeneration"]
    assert cfg["text_config"]["architectures"] == ["Qwen3NextForCausalLM"]
    assert dataclasses.asdict(j_spec_from_hf_config(cfg)) == dataclasses.asdict(jspec)
    save_hf_weights(params, spec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == spec
    loaded = load_hf_weights(tmp_path / "snap", spec, dtype=torch.float32)
    stored = fam.from_hf({k: torch.as_tensor(v).bfloat16() for k, v in state.items()}, spec)
    for (pa, a), (_, b) in zip(toptim.tree_paths(stored), toptim.tree_paths(loaded)):
        assert torch.equal(a, b), pa  # the snapshot's bf16 values, the zero-centred norms' +1 too


def test_qwen35_composition_reads_as_jax_reads_it():
    """``chip_smoke.QWEN35_COMPOSITION_CONFIG`` (the Qwen3-Next-80B-A3B trunk
    with the Qwen3-VL-8B tower at an output width of 2048) read by both
    packages: every field of the spec and of its tower equal, and the widths
    its two sources publish."""
    got = spec_from_hf_config(dict(chip_smoke.QWEN35_COMPOSITION_CONFIG))
    want = j_spec_from_hf_config(dict(chip_smoke.QWEN35_COMPOSITION_CONFIG))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == spec_from_hf_config(spec_to_hf_config(got))
    assert (got.family, got.hidden_size, got.num_layers, got.gdn_pattern[:4], got.num_heads,
            got.num_kv_heads, got.head_dim, got.partial_rotary_factor, got.num_experts,
            got.num_experts_per_tok, got.vocab_size, got.mrope_section) == (
        "qwen3_next_vl", 2048, 48, "LLLA", 16, 2, 256, 0.25, 512, 10, 151936, (16, 8, 8))
    assert (got.vision.depth, got.vision.hidden_size, got.vision.head_dim,
            got.vision.out_hidden_size, got.vision.deepstack_visual_indexes) == (
        27, 1152, 72, 2048, (8, 16, 24))
    base = get_spec("Qwen/Qwen3-Next-80B-A3B-Instruct")
    assert dataclasses.replace(got, family="qwen3_next", mrope_section=(), vision=None,
                               vision_start_token_id=-1, image_token_id=-1,
                               video_token_id=-1) == base


_JAX_STEP: dict = {}


def _exact_tril_inv(a, chunk):
    """(I - a)^-1 for the strictly lower ``a`` of the JAX chunked rule by a
    triangular solve, the port's form, in place of the JAX package's Neumann
    doubling while its train step is traced (``test_train_step_matches_jax_step_one``).
    On a chunk of padding (g = 0, one key repeated) ``a`` is -beta below the
    diagonal: the exact inverse is bounded by beta, but the doubling's
    powers a^(2^j) reach C(63, 31) beta^32 and leave f32 noise of up to 1e9
    in the states there (``test_all_pad_chunk_is_exact_in_the_port``). The
    load-balance term reads the padding's routing, so only an exact
    inverse on both sides lets it agree."""
    eye = jnp.eye(chunk, dtype=a.dtype)
    return jax.scipy.linalg.solve_triangular(eye - a, jnp.broadcast_to(eye, a.shape),
                                             lower=True, unit_diagonal=True)


def _jax_step(jspec):
    """The JAX package's train step (``_model_cfg``), compiled once for the
    RL and the SFT batch, which carry the same streams and shapes; call it
    with ``_exact_tril_inv`` in place (the test's ``monkeypatch``)."""
    if not _JAX_STEP:
        j_cfg = _model_cfg(JTrainerConfig)
        j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
        mesh_info = build_mesh(JMeshConfig(fsdp=-1))
        _JAX_STEP["step"] = (j_opt, mesh_info, jstep.make_train_step(
            jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info))
    return _JAX_STEP["step"]


def _model_cfg(cls):
    """Full remat, sgd at lr 1 without weight decay, and the load-balance
    term on (it counts the padding rows' routing: ``_exact_tril_inv``)."""
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1.0, "weight_decay": 0.0})


def test_all_pad_chunk_is_exact_in_the_port():
    """The (I - A)^-1 of a chunk of padding (g = 0, one key repeated, beta
    0.9), here as one segment so that the recurrence also writes its state:
    the port's chunked rule gives the one-token recurrence's outputs and state
    (1e-5), while the JAX package's Neumann doubling departs from the exact
    inverse by more than 1 (the reason for ``_exact_tril_inv``)."""
    from prime_rl_tpu_torch.ops import gated_delta as tgd

    rng = np.random.default_rng(0)
    b, s, h, dk, dv = 1, 64, 2, 16, 16

    def repeated(d):
        return torch.from_numpy(np.broadcast_to(rng.standard_normal((1, 1, h, d)),
                                                (b, s, h, d)).astype(np.float32).copy())

    q, k, v = repeated(dk), repeated(dk), repeated(dv)
    g, beta = torch.zeros(b, s, h), torch.full((b, s, h), 0.9)
    out, state = tgd.chunk_gated_delta_rule(q, k, v, g, beta,
                                            segment_ids=torch.ones(b, s, dtype=torch.int64))
    rec = torch.zeros(b, h, dk, dv)
    for t in range(s):
        o, rec = tgd.recurrent_gated_delta_rule(q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t],
                                                rec)
        np.testing.assert_allclose(_np(out[:, t]), _np(o), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(state), _np(rec), atol=1e-5, rtol=1e-5)
    kn = k[0, :, 0] / k[0, :, 0].norm(dim=-1, keepdim=True)
    a = -torch.tril((0.9 * kn) @ kn.T, -1).numpy()
    exact = np.asarray(_exact_tril_inv(jnp.asarray(a), s))
    np.testing.assert_allclose(exact @ (np.eye(s) - a), np.eye(s), atol=1e-5)
    assert np.abs(np.asarray(jgd._neumann_tril_inv(jnp.asarray(a), s)) - exact).max() > 1.0


@pytest.mark.parametrize("kind", ["rl", "sft"])
def test_train_step_matches_jax_step_one(model, kind, monkeypatch):
    """One packed batch of image, video and text samples (RL: the policy loss;
    SFT: the cross-entropy of the SFT data path's samples) in two rows, the
    second all padding, through ``make_train_step`` (``_model_cfg``; the JAX
    step with ``_exact_tril_inv``): loss, grad_norm and every metric, the
    load-balance term's among them (rtol 1e-4), and every parameter's gradient
    (the update of sgd at lr 1 without weight decay) within 1e-3 of its norm,
    the tower's among them (which moves)."""
    jspec, spec, np_params, params = model
    jb, tb = _batches(jspec, spec, sft=kind == "sft")
    if kind == "sft":
        scales = (1.0, float(np.asarray(tb.ce_weights).sum()), 1.0)
    else:
        scales = (float(np.asarray(tb.loss_mask).sum()), 1.0, 1.0)
    monkeypatch.setattr(jgd, "_neumann_tril_inv", _exact_tril_inv)
    j_opt, mesh_info, j_step = _jax_step(jspec)
    t_cfg = _model_cfg(TrainerConfig)
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_batch = jstep.put_batch(jax.tree.map(jnp.asarray, jb), mesh_info)
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(*map(jnp.float32, scales)))

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(spec, "cpu", t_opt,
                                     params=toptim.tree_map(lambda x: x.clone(), params))
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, tb, tstep.Scales(*scales))

    assert set(t_metrics) == set(j_metrics) and "moe_load_balance" in t_metrics
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]), rtol=1e-4)
    for key, stat in t_metrics.items():
        if key not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[key].total),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
    before = dict(toptim.tree_paths(np_params))
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    tower = 0.0
    for path, t in toptim.tree_paths(t_state.params):
        t_grad, j_grad = before[path] - _np(t), before[path] - j_flat[path]
        assert np.linalg.norm(t_grad - j_grad) <= 1e-3 * np.linalg.norm(j_grad) + 1e-7, path
        if path.startswith("vision/blocks"):
            tower += float(np.abs(t_grad).sum())
    assert tower > 0  # the tower trains


def test_lora_forward_gradients_and_merge_match_jax(model):
    """An adapter on every target with the per-expert targets on (B != 0),
    with the vision streams: the final hidden states (2e-4 on the real rows)
    and the gradients of a fixed contraction of them with respect to every
    adapter tensor against ``jax.value_and_grad`` (rtol 2e-4, atol 1e-5 of
    each one's largest magnitude), the tower taking none; ``merge_lora``
    gives JAX's merge, the tower as it was."""
    jspec, spec, np_params, params = model
    jcfg = JLoRAConfig(rank=4, alpha=8.0, experts=True)
    tcfg = LoRAConfig(rank=4, alpha=8.0, experts=True)
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: jlora.init_lora(jspec, jcfg, jax.random.key(0)))
    ad = {"layers": {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
                     for k, v in shapes["layers"].items()}}
    jb, tb = _batches(jspec, spec)
    ids, seg, pos = (np.asarray(getattr(tb, f))[0] for f in ("input_ids", "segment_ids",
                                                             "position_ids"))
    ct = rng.standard_normal((*ids.shape, spec.hidden_size)).astype(np.float32) * (
        seg != 0)[..., None]
    jmm = _mm(jb, jnp.asarray)

    def j_loss(lora):
        h = jnext.forward(jax.tree.map(jnp.asarray, np_params), jspec,
                          *map(jnp.asarray, (ids, seg, pos)), compute_dtype=jnp.float32,
                          attn_impl="xla", remat="none", lora=lora,
                          lora_scale=jlora.lora_scale(jcfg), mm=jmm)
        return jnp.sum(h * ct), h

    (_, want), jgrads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, ad))
    jgrads = jgrads["layers"]
    tl = tlora.lora_from_jax(ad)
    for t in tl["layers"].values():
        t.requires_grad_()
    h = tnext.forward(params, spec, *map(torch.from_numpy, (ids, seg, pos)),
                      compute_dtype=torch.float32, remat="none", lora=tl,
                      lora_scale=tlora.lora_scale(tcfg), mm=_mm(tb))
    (h * torch.from_numpy(ct)).sum().backward()
    real = seg > 0
    np.testing.assert_allclose(_np(h)[real], np.asarray(want)[real], **TOL)
    assert set(tl["layers"]) == set(jgrads) and "moe_up_a" in jgrads
    for k, t in tl["layers"].items():
        w = np.asarray(jgrads[k])
        np.testing.assert_allclose(_np(t.grad), w, atol=1e-5 * float(np.abs(w).max()),
                                   rtol=2e-4, err_msg=k)
    merged = tlora.merge_lora(params, tlora.lora_from_jax(ad), tcfg, spec=spec)
    j_merged = dict(toptim.tree_paths(jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, ad), jcfg, spec=jspec))))
    for path, t in toptim.tree_paths(merged):
        np.testing.assert_allclose(_np(t), j_merged[path], atol=1e-6, rtol=1e-6, err_msg=path)
    assert merged["vision"] is params["vision"]


CACHE = dict(num_pages=48, page_size=16, max_slots=4, max_seq_len=192)


def test_engine_greedy_tokens_on_an_image_prompt_match_jax(model):
    """The port's engine and the JAX package's on the same weights (doubled,
    so that greedy tokens are decisive): an image prompt (the single-shot
    vision prefill seeding the recurrent rows, then the recurrent decode at
    ``lengths + pos_delta``) and a text prompt beside it, 6 greedy tokens
    each, equal to JAX's; the image prompt reuses no cached prefix and
    touches no state snapshot, and one past the largest bucket (here the
    engine's length limit) is rejected, as the JAX engine rejects it."""
    jspec, spec, np_params, _ = model
    np2 = jax.tree.map(lambda x: x * np.float32(2.0), np_params)
    t_engine = Engine(params_from_jax(np2, spec), spec, CacheConfig(**CACHE), device="cpu",
                      compute_dtype=torch.float32, decode_block=4)
    j_engine = JEngine(jax.tree.map(jnp.array, np2), jspec, JCacheConfig(**CACHE),
                       compute_dtype=jnp.float32)
    ids, mm = _vlm_ids(spec, [(1, 4, 4), (2, 2, 2)], n_text=20, seed=3)
    text = list(range(3, 40))
    greedy = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
    got = t_engine.generate([ids, text], SamplingParams(**greedy), mm=[mm, None])
    want = j_engine.generate([ids, text], JSamplingParams(**greedy), mm=[mm, None])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids and len(g.token_ids) == 6
    assert t_engine.stats["vision_patches"] == len(mm["pixel_values"])
    again = t_engine.generate([ids], SamplingParams(**greedy), mm=[mm])[0]
    assert again.token_ids == got[0].token_ids
    assert t_engine.stats["prefill_tokens_cached"] == 0
    assert t_engine.stats.get("state_restores", 0) == 0
    long_ids = ids + [5] * (t_engine.buckets[-1] + 1 - len(ids))  # past the largest bucket
    fut = t_engine.submit(long_ids, SamplingParams(max_tokens=1), mm=mm)
    t_engine.run_until_idle()
    with pytest.raises((ValueError, MemoryError)):  # the bucket, or the length it equals
        fut.result()
