"""The port's Qwen3-VL vision tower (``prime_rl_tpu_torch/models/vision.py``)
against the JAX package's: the forward and its gradients on the same weights
(``params_from_jax``) and seeded numpy inputs in float32, and the host prep
functions, array for array.

Tolerances: the tower's outputs (merged rows and DeepStack features) and the
gradients of every weight and of the patches within 1e-4 of the reference's
largest magnitude (f32 sums in another order, across 2-3 blocks); the pad
rows are compared only through the gradients, which they do not reach (the
JAX form gives pad rows a mean of the values, the port zeros: no real row
reads either). The prep functions are integer or float32 arrays that must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import vision as jv
from prime_rl_tpu_torch.models import vision as tv
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.models.qwen3 import params_from_jax

jax.config.update("jax_platforms", "cpu")

# a tower of head dim 72 (Qwen3-VL-8B's 1152 / 16) with two DeepStack taps
WIDE_HEADS = jv.VisionSpec(depth=3, hidden_size=144, intermediate_size=96, num_heads=2,
                           in_channels=3, patch_size=4, temporal_patch_size=2,
                           spatial_merge_size=2, out_hidden_size=64, num_position_embeddings=16,
                           deepstack_visual_indexes=(0, 1))

GRIDS = ([(1, 4, 4)], [(1, 4, 6), (1, 2, 2)], [(2, 4, 4)], [(1, 6, 4), (2, 2, 4), (1, 4, 4)])


def _towers():
    d = get_spec("debug_vlm").vision
    return {"debug_vlm": jv.VisionSpec(**d.__dict__), "head dim 72": WIDE_HEADS}


def _inputs(vspec, grids, pad_to=None, seed=0):
    rng = np.random.default_rng(seed)
    meta = jv.prep_patch_metadata(np.asarray(grids), vspec, pad_to=pad_to)
    P = meta["seg_ids"].shape[0]
    patches = rng.standard_normal((P, vspec.patch_dim)).astype(np.float32)
    return patches, meta


def _tv_spec(vspec):
    return tv.VisionSpec(**vspec.__dict__)


@pytest.mark.parametrize("tower", ["debug_vlm", "head dim 72"])
@pytest.mark.parametrize("grids,pad_to", [(GRIDS[1], None), (GRIDS[3], 160)])
def test_vision_forward_and_grads_match_jax(tower, grids, pad_to):
    vspec = _towers()[tower]
    patches, meta = _inputs(vspec, grids, pad_to)
    real = int((meta["seg_ids"] > 0).sum()) // vspec.merge_unit
    jparams = jv.init_vision_params(vspec, jax.random.PRNGKey(3))
    jparams = jax.tree.map(lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(5), x.shape),
                           jparams)  # non-trivial norms and biases
    rng = np.random.default_rng(1)
    n_ds = len(vspec.deepstack_visual_indexes)
    wm = rng.standard_normal((real, vspec.out_hidden_size)).astype(np.float32)
    wd = rng.standard_normal((n_ds, real, vspec.out_hidden_size)).astype(np.float32)
    args = [jnp.asarray(meta[k]) for k in ("seg_ids", "pos_idx", "pos_w", "rope_coords")]

    def jloss(p, x):
        merged, ds = jv.vision_forward(p, vspec, x, *args)
        return (merged[:real] * wm).sum() + (ds[:, :real] * wd).sum(), (merged, ds)

    (_, (jm, jds)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(patches))

    tparams = params_from_jax(jax.device_get(jparams), get_spec("debug_vlm"))
    leaves = {k: v.requires_grad_() for k, v in _flat(tparams).items()}
    x = torch.tensor(patches, requires_grad=True)
    targs = [torch.as_tensor(meta[k]) for k in ("seg_ids", "pos_idx", "pos_w", "rope_coords")]
    tm, tds = tv.vision_forward(_unflat(leaves), _tv_spec(vspec), x, *targs, remat="full")
    loss = (tm[:real] * torch.tensor(wm)).sum() + (tds[:, :real] * torch.tensor(wd)).sum()
    loss.backward()

    def close(name, got, ref):
        ref = np.asarray(ref)
        tol = 1e-4 * max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=tol, rtol=0, err_msg=name)

    close("merged", tm[:real], jm[:real])
    close("deepstack", tds[:, :real], jds[:, :real])
    assert (tm[real:] == 0).all()  # pad rows: left out of the mergers
    close("d patches", x.grad, jgx)
    for name, leaf in leaves.items():
        close(f"d {name}", leaf.grad, _get(jg, name))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree: dict = {"ds_mergers": {}}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _get(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("grids", GRIDS)
def test_prep_patch_metadata_matches_jax(grids):
    vspec = _towers()["debug_vlm"]
    for pad_to in (None, 200):
        ours = tv.prep_patch_metadata(np.asarray(grids), _tv_spec(vspec), pad_to=pad_to)
        ref = jv.prep_patch_metadata(np.asarray(grids), vspec, pad_to=pad_to)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("grids", GRIDS)
def test_prep_mrope_positions_and_slots_match_jax(grids):
    """mRoPE positions and image slots of a prompt with the grids' vision
    blocks between text, a truncated sample, and a sampled image token past
    the grids (it stays text: no slot, sequential positions)."""
    spec = get_spec("debug_vlm")
    m = spec.vision.spatial_merge_size
    rng = np.random.default_rng(0)
    ids = list(rng.integers(3, 200, size=5))
    for t, h, w in grids:
        ids += [spec.vision_start_token_id] + [spec.image_token_id] * (t * (h // m) * (w // m))
        ids += list(rng.integers(3, 200, size=3))
    ids += [spec.image_token_id, 7, 8]  # sampled, with no pixels behind it
    ids = np.asarray(ids, np.int32)
    grid = np.asarray(grids, np.int64)
    n_merged = int(grid.prod(axis=1).sum()) // (m * m)
    for cut in (len(ids), len(ids) - 6):
        args = (ids[:cut], grid, m, spec.image_token_id, spec.video_token_id)
        assert np.array_equal(tv.prep_mrope_position_ids(*args),
                              jv.prep_mrope_position_ids(*args))
    for base, cap in ((0, None), (17, n_merged)):
        sargs = (ids, spec.image_token_id, spec.video_token_id, base, cap)
        ours, ref = tv.prep_image_slots(*sargs), jv.prep_image_slots(*sargs)
        assert np.array_equal(ours, ref)
    assert tv.prep_image_slots(ids, spec.image_token_id, spec.video_token_id,
                               max_slots=n_merged)[-3] == -1


@pytest.mark.parametrize("section,rot_half", [((8, 4, 4), 16), ((24, 20, 20), 64),
                                              ((2, 1, 1), 4)])
def test_mrope_dim_select_matches_jax(section, rot_half):
    assert np.array_equal(tv.mrope_dim_select(section, rot_half),
                          jv.mrope_dim_select(section, rot_half))


def test_frame_attention_is_per_frame():
    """Each frame attends only itself and pad rows get 0: the same rows as one
    masked full-matrix softmax over the buffer."""
    rng = np.random.default_rng(2)
    seg = torch.tensor([1] * 5 + [2] * 5 + [3] * 3 + [0] * 4)
    q, k, v = (torch.tensor(rng.standard_normal((17, 2, 8)), dtype=torch.float32)
               for _ in range(3))
    got = tv.frame_attention(q, k, v, tv.frame_runs(seg), 0.3)
    mask = (seg[:, None] == seg[None, :]) & (seg > 0)[:, None]
    s = torch.einsum("qhd,khd->hqk", q, k) * 0.3
    ref = torch.einsum("hqk,khd->qhd", torch.softmax(s.masked_fill(~mask, -1e30), -1), v)
    real = seg > 0
    torch.testing.assert_close(got[real], ref[real], atol=1e-6, rtol=1e-6)
    assert (got[~real] == 0).all()
