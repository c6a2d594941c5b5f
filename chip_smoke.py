#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's serving and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. device   — requires CUDA; prints nvidia-smi's name and power limit.
  2. build    — compiles the hand-written kernels from ``prime_rl_tpu_torch/csrc``
                and prints the registers, local memory and shared memory of each of
                the six instantiations of K1, K2a and K2b (head dim 64, 128 and
                256, dense and windowed), the four of K3, the twelve of K4,
                and K5a and K5b (with their blocks an SM and tile sizes) as the
                runtime loaded them (it fails on local memory: a spill), and
                K3's launch (split of D, ring, clusters) at both serving shapes.
  3. kernels  — K1 flash_attn_fwd, K3 decode_qkv_prep and K4 decode_paged_attention
                at the Qwen3-0.6B shapes of the serving path (K3 also at
                Qwen3-30B-A3B's and GLM-4.5-Air's, rot 64, and over
                K3_EDGE_CASES: S from 1 to 256, head dims 32, 64 and 128, rot < HD,
                biases with and without qk-norm, positions near 131071 with
                YaRN, each launched twice for equal bits, with the weight tiles
                each block loaded, as the kernel counted them, held against the
                tiling's mirror; its yardstick the cuBLAS product alone; K1 also at the
                trainer's rows of four sequences; K4 also over 16 slots of
                3000-4000 cached tokens, and over K4_EDGE_CASES: lengths 0 and
                at split and page boundaries, inactive slots, windows, sinks,
                page sizes 8-64, both head dims, GQA 1/2/4/8 and the groups
                cut into chunks, 3/5/6/12 (12 with a window), each launched
                twice for equal bits, with the rows each work item read as the
                kernel counted them held against the split rule's mirror),
                K2a flash_attn_bwd_dq and K2b
                flash_attn_bwd_dkv at the trainer's shape and one long shape,
                K1, K2a and K2b over K1_EDGE_CASES (ragged and odd lengths,
                padding, short segments, GQA 1/2/4/8/12, both head dims, the
                cross-block form with an lse cotangent, windows with and without
                sinks, the SFT micro-batch of 2 x 8192 tokens, each launched
                twice for equal bits), K5a sparse_mla_fwd,
                K5b sparse_mla_bwd and the dkv reduction at the GLM-5 attention
                widths (64 heads, 576 = 512 + 64 channels, top-k 2048) over a
                packed row of 4096 tokens and over a short row full of
                sentinels, and at 128 heads over the packed row (K5a and K5b
                also over K5B_EDGE_CASES: T of 100 and 2047, S = 1, a token
                that selected nothing, sentinels scattered inside rows (S, -1
                and S + 7), a small Sk, several chunks; and over
                K5_HEAD_CASES at 8, 32, 96 and 128 heads; every K5a and K5b case launched twice for equal bits,
                with the tiles of 64 (K5a) and 32 (K5b) slots each visited, as
                the kernel counted them, held against the skip rule's mirror;
                K5a timed with the L2 flushed, its yardstick one SDPA call
                over the same selection as a dense mask, K5b's the backward
                of that call, with the L2 flushed), and the window and
                sink forms of K1, K2a, K2b and K4
                (plus K3) at gpt-oss-20b's shapes (64/8 heads of 64; K1/K2 over
                4096 tokens at window 128 and 0 with sinks, the sinks' gradient
                too, and over four packed sequences of 1024; K4 over 64 slots at
                window 128 and 0 with sinks), each held against its plain
                PyTorch version (computed in float32 on the same bf16 inputs)
                and timed beside the plain version, a one-call PyTorch yardstick
                where one exists, and the bound of the H100 (SXM data sheet:
                3.35 TB/s, 989 TFLOP/s dense bf16). The rows of K1, K2a and K2b
                also give the tile pairs visited, as the kernels counted them
                (every case holds those counts against the skip rules' plain
                mirrors; K5a's and K5b's rows give their tiles visited too).
                Windowed K1 must take at most a quarter of full K1's
                time, and K1, and K2a + K2b, over the four packed sequences at
                most half of the one-sequence time. K4 also at the MoE serving
                shapes (64 slots of 500-1100 tokens): Qwen3-30B-A3B's 32/4
                heads (group 8) and GLM-4.5-Air's 96/8 (group 12, two chunks a
                kv head), each a row of its own. Then this slice's rows
                (gated_kernel_phase): K1, K2a and K2b at MiniMax-M2's 48/8
                heads of 128 (group 6) over a packed row of 4096 tokens, and in
                their window form without sinks at head dim 128 (the SDPA
                yardstick over the banded mask); K4 at MiniMax-M2's serving
                shape (64 slots, group 6); K5a at the GLM-5 serving prefill's
                shape (one 4096-token bucket of a 3500-token prompt), each
                against its plain version and launched twice for equal bits.
                Then the head-dim-256 rows (qwen3_next_kernel_phase): K1, K2a and K2b at
                Qwen3-Next's 16/2 heads of 256 over a packed row of 4096
                tokens (three sequences), K4 at its serving shape (64 slots
                of 500-1100 tokens, 16/2 heads of 256); K1_EDGE_CASES and
                K4_EDGE_CASES hold head dim 256 too. Then the Nemotron-H rows
                (nemotron_kernel_phase): K1, K2a and K2b at Nemotron-H-8B's
                32/8 heads of 128 over the same packed row, K4 at 64 slots of
                500-1100 tokens.
  4. train-reference — loss and every gradient of one micro-batch [2, 512] of
                the full-width model cut to 2 layers (full vocabulary), through
                the kernels in bf16 on the card, against the plain float32 path
                on the CPU.
  5. training — the port's RL trainer through its normal entry (Qwen3-0.6B, all
                28 layers, full vocabulary, random weights from a seed, fake
                data, seq_len 512, 4 micro-batches of 8 rows, adamw_8bit with
                bf16 masters) takes 2 steps, twice from the same seed: finite
                losses and grad-norms, changed parameters, bit-equal losses,
                the expected launches of K1, K2a and K2b, and a v4 HF snapshot
                that reads back equal to the state's parameters.
  6. dsa-train-reference — the same for the glm_moe_dsa family at GLM-5's
                widths, cut to 1 dense + 1 MoE layer of 8 experts: one row of
                512 tokens with top-k 256, K5a/K5b in bf16 on the card against
                float32 on the CPU.
  7. dsa-training — the trainer through the same entry on a directory whose
                config.json names GlmMoeDsaForCausalLM at GLM-5's widths (depth
                78 -> 2 layers, 1 dense + 1 MoE; 256 -> 32 routed experts; the
                cuts are logged), seq_len 4096, 2 micro-batches of 1 row,
                adamw_8bit with bf16 masters, full remat: 2 steps, twice from the
                same seed: finite and changing losses, changed parameters,
                bit-equal losses, the launches of K5a, K5b and the reduction that
                the layers, micro-batches and remat imply, and a snapshot that
                reads back through get_spec and the family's from_hf.
  8. gpt-oss-train-reference — the same for gpt-oss at gpt-oss-20b's widths
                cut to 2 layers (one windowed, one full) of 8 experts, random
                sinks and biases: one row of 512 tokens, K1/K2a/K2b in their
                window and sink forms; the CPU replays the card's routing and
                reports how far its own agrees.
  9. gpt-oss-training — the trainer on a directory whose config.json names
                GptOssForCausalLM at gpt-oss-20b's widths (24 -> 2 layers, 32 -> 8
                experts; logged), rows of four sequences, seq_len 4096, 2
                micro-batches of 1 row, adamw_8bit, bf16 masters, full remat: 2
                steps twice: bit-equal finite losses, changed parameters (the
                sinks among them), the launches of K1, K2a and K2b (and of their
                window forms) that the layers imply, a snapshot read back.
 10. sft      — SFT through its entry's parser on
                configs/examples/qwen3_0.6b_sft.toml as it is (Qwen3-0.6B at full
                width and depth, seq_len 8192, 16 sequences a step in 8
                micro-batches of 2 rows) with fake data, random init, 2 steps,
                validation every step over 2 batches and a snapshot at step 2:
                finite records, two val_nll records, the snapshot, launches of
                K1, K2a and K2b; its tokens/s, step time and peak memory.
 11. qwen3-moe-reference — Qwen3-30B-A3B at full width and vocabulary cut to 2
                layers: a prefill of 200 tokens and 4 decode steps through K1,
                K3 and K4 against float32 on the CPU, which replays the card's
                routing and reports how far its own agrees.
 12. qwen3-moe-training — the trainer's step on Qwen3-30B-A3B at full width (all 128
                experts) cut to 4 layers, seq_len 4096, 2 micro-batches of 1
                row, adamw_8bit, bf16 masters, full remat, half the tokens
                replaying a routing (a fake loader the phase builds): 2 steps
                twice, bit-equal finite losses,
                the launches of K1, K2a and K2b the layers imply, then one step
                under the profiler for torch._grouped_mm's share.
 13. reference — the served Qwen3-0.6B's prefill and decode logits through the
                kernels against a plain float32 forward on the CPU.
 14. serving  — the port's inference server (Qwen3-0.6B, all 28 layers, full
                vocabulary, random weights from a seed, byte tokenizer) answers
                16 concurrent /inference/v1/generate requests, a /v1/completions
                request and a streaming /v1/chat/completions request over HTTP;
                greedy requests are deterministic; every kernel was launched.
 15. gpt-oss-reference — gpt-oss at gpt-oss-20b's widths cut to 2 layers: a
                prefill of 200 tokens and decode steps past position 128 through
                K1, K3 and K4 against float32 on the CPU.
 16. gpt-oss-serving — the same server and requests with openai/gpt-oss-20b at
                full width cut to 6 of its 24 layers (random weights, byte tokenizer,
                max_model_len 4096): K1 and K4 launched on the windowed and the
                full layers, K3 on every layer; its tokens/s and first-token time.
 17. qwen3-moe-serving — the same server and requests with Qwen/Qwen3-30B-A3B at
                full width cut to 6 of its 48 layers (the KV pool sized from
                the memory left) recording the routing: every generate
                completion carries routed_experts [n_gen, 6, 8], ids in
                [0, 128), the last row -1.
 18. glm4-moe-reference — the reference of phase 11 for GLM-4.5-Air (1 dense +
                1 MoE layer; partial rotary, noaux routing with a random
                correction bias, a shared expert; K4 at group 12).
 19. glm4-moe-serving — the server of phase 17 for GLM-4.5-Air at full width
                cut to 4 layers (1 dense + 3 MoE), routed_experts [n_gen, 3, 8].
 20. minimax-reference — MiniMax-M2 at its published widths
                (MINIMAX_M2_CONFIG through spec_from_hf_config, 1 of 62
                layers): the served prefill and decode through K1 and K4 (K3
                not: a layer-scope qk-norm) against float32 on the CPU.
 21. minimax-training — phase 12's trainer step on MiniMax-M2 at its
                published widths, 1 layer (4.90 G parameters), seq_len 4096,
                half the tokens replaying a routing, 2 steps twice.
 22. afmoe-reference, laguna-reference — each family at GATED_TEST_SHAPE
                (heads of 128, 128-token windows on every other layer, 4
                layers, the first dense): the training forward and backward
                (K1, K2a, K2b in their window form) and the served prefill and
                decode (K1, K4 in their window form; K3 not: gated layers)
                against float32 on the CPU, each twice for equal bits.
 23. deepseek-v3-reference — dense MLA at DEEPSEEK_V3_TEST_CONFIG: the
                served prefill and decode over the latent cache on the card
                (no kernel: plain PyTorch, as XLA in the JAX package) against
                float32 on the CPU, twice for equal bits.
 24. glm5-serving-reference — GLM-5 at its widths cut to 1 dense + 1 MoE
                layer of 8 experts, top-k 256: the served prefill of 384 tokens
                (K5a over the sampler's own indexer selection, the indexer keys
                paged into the V pool), a chunked prefill of the last 76 and 4
                decode steps (each masked to its exact top-k over the paged
                indexer keys) against float32 on the CPU on the card's routing
                and selections (at least 90% of the selected rows shared with
                float32's own), twice for equal bits: K5a launched.
 25. minimax-serving — the server of phase 17 for MiniMax-M2 at its published
                widths, MINIMAX_SERVE_LAYERS (4) of 62 layers, the pool
                sized from the memory left, routed_experts [n_gen, 8, 8]: K1
                and K4 (group 6) launched, K3 not.
 26. glm5-serving — the server for GLM-5 (GLM5_CONFIG, GLM5_CUTS: 4 layers,
                32 routed experts) over the MLA latent cache with the DSA
                indexer keys paged beside, the requests of phase 14 and one
                prompt of GLM5_LONG_PROMPT tokens (above top-k 2048: the
                serving prefill's K5a and the decode's top-k select part of
                the history), routed_experts [n_gen, 1, 8]: K5a launched.
 27. qwen3-next-reference — Qwen3-Next at its widths and full vocabulary
                cut to one period (LLLA) and 32 experts: the loss and every
                gradient of one row of 256 tokens through K1, K2a and K2b
                (each gradient within 5% of its norm, or 1.25 times the plain
                bf16 path's own error plus 1%), the served prefill of 200
                tokens, a chunk of 300 from the recurrent rows and 4 decode
                steps through K1 and K4 (pages of 8), against float32 on the
                CPU on the card's routing, twice for equal bits; K3 never.
 28. qwen3-next-training — the trainer through its entry on a directory
                whose config.json names Qwen3NextForCausalLM (4 layers LLLA,
                16 experts), seq_len 4096, 2 micro-batches of 1 row,
                adamw_8bit, bf16 masters, full remat, 2 steps twice:
                bit-equal finite losses, changed parameters, the launches of
                K1, K2a and K2b, a snapshot read back.
 29. qwen3-next-serving — the server of phase 17 for Qwen3-Next at 4 of 48
                layers with all 512 experts, routed_experts on
                every completion, then a GRPO group of four on one
                1100-token prompt: the recurrent-state tier hit, the cached
                members' first-token logits within 0.03 of |logit| of the
                cold member's; K4 at head dim 256 launched, K3 not.
 30. nemotron-h-reference — Nemotron-H at the 8B's widths and full
                vocabulary, one layer of each kind (M*-E, the LatentMoE
                layer at a test shape: 8 experts top-2 at latent 1024): the
                loss and every gradient of one row of 256 tokens through
                K1, K2a and K2b (each within 5% of its norm), the served
                prefill of 200 tokens, a chunk of 300 from the Mamba rows and
                4 decode steps through K1 and K4 (pages of 8), against
                float32 on the CPU on the card's routing, twice for equal
                bits; K3 never.
 31. nemotron-h-training — the trainer through its entry on a directory
                whose config.json names NemotronHForCausalLM (one period of
                the 8B's pattern cut to 3 layers, M-*), seq_len 4096, 2 micro-batches
                of 1 row, adamw_8bit, bf16 masters, full remat, 2 steps twice:
                bit-equal finite losses, changed parameters, the launches of
                K1, K2a and K2b, a snapshot read back.
 32. nemotron-h-serving — the server of phase 17 for Nemotron-H-8B cut to
                13 of its 52 layers (one period), then the GRPO group of phase 29 on its Mamba
                rows; K1 and K4 launched, K3 not.
 33. lora-training — two LoRA tenants of a MultiRunManager (at most one
                live: each switch evicts one to disk and reloads the other, bit
                for bit) on Qwen3-0.6B at full width and depth with
                configs/examples/qwen3_0.6b_rl_lora.toml's adapter (rank 16,
                alpha 32, all seven projections), 4 steps alternating on packed
                fake rows of 4096 tokens: the frozen base's bits unchanged, the
                tenants' adapters different, K1, K2a and K2b launched; the
                base snapshot and each tenant's PEFT adapter written; step time,
                tokens/s and peak memory beside the training phase's.
 34. lora-serving — the server on that base with an adapter bank
                (max_adapters 4): the requests of phase 14, both adapters loaded
                over /load_lora_adapter, 16 concurrent greedy requests over the
                base and the two adapters against engines on each adapter's
                merged weights (first-token logits within 0.05 of max |logit|,
                the bound of phase 13), /unload_lora_adapter and the error for
                a request naming the unloaded adapter, the decode step at 64
                slots with the bank on and off; K3 never launched, K1 and K4
                launched.
 35. loop     — the RL loop through its launcher: ``python -m
                prime_rl_tpu_torch.entrypoints.rl @configs/bench/northstar_rl_tpu.toml
                --colocated`` with 3 trainer and orchestrator steps (Qwen3-0.6B at
                full width and depth, random weights, byte tokenizer, async GRPO on
                reverse_text, trainer and sampler in one process on the card, the
                orchestrator a CPU process). It fails unless the launcher exits 0
                within 600 s, no log holds a traceback, trainer.jsonl holds the 3
                steps with finite losses, the sampler served every published
                version, orchestrator.jsonl holds the shipped batches, the mean
                mismatch_kl is finite and below 0.5, and the colocated process
                launched K1, K2a, K2b, K3 and K4. It prints the loop's figures of
                this single run: trainer tokens/s and step time, the wait for a
                batch, the in-process swap, rollout tokens/s, env steps/s and the
                wall time a step.
 36. lora-loop — the loop of phase 35 on configs/examples/qwen3_0.6b_rl_lora.toml
                cut as phase 35 is cut (northstar_rl_tpu.toml's settings less its
                optimizer and env list; completions of up to 128 tokens): the same
                checks, the engine serving the merge of the frozen base and the
                adapter, and the trainer's base bit-equal at the end (its logged
                fingerprints).
 37. range-repairs — K1, K2a and K2b at head dim 512, K4 at 384 and 512, K5a
                and K5b at Dq 1152 / v_dim 1024 and 640 / 512, each against its
                plain version, twice for equal bits, timed (the edge cases at
                320, 384 and 512 run in the kernel phases).
 38. qwen3-vl-reference — debug_vlm's tower with a trunk of heads of 128,
                dense and MoE: the train step's loss and gradients (the
                tower's among them) and the served prefill, prompt logprobs
                and 4 decode steps with the mRoPE offset, through K1, K2a,
                K2b, K3 and K4, against float32 on the CPU.
 39. qwen3-vl-training — Qwen3-VL-8B's whole tower and QWEN3_VL_TRAIN_LAYERS
                of its 36 trunk layers, 2 steps on packed rows of 4096 tokens
                that mix image and text samples: step time, peak memory.
 40. qwen3-vl-serving — the server on Qwen3-VL-8B at full width and depth, 16
                requests of one synthetic image each (196 or 768 image tokens)
                and 128 generated tokens, then one text-only request: tokens/s,
                the decode step's host and busy ms; K1, K3 and K4 launched.
 41. vlm-loop — configs/debug/rl_vlm.toml through the launcher, colocated,
                3 steps: the loop's checks, K1, K2a, K2b and K3 launched, and
                the trainer's records holding the vision patches.
Then one JSON line with every kernel's numbers, and the result line. A kernel's
``launches`` is its count on the path that runs it (K1 runs on both: its
``launches`` is the serving path's, ``launches_training`` the Qwen3 trainer's;
the sparse-MLA kernels run on the DSA trainer's path; the window and sink
forms' rows count the gpt-oss paths, ``launches_window`` their windowed layers).
K1, K2a, K2b, K3 and K4 also give ``launches_loop``, their launches in the
colocated process of the loop phase; K1, K2a and K2b ``launches_sft`` and
``launches_moe_training``, and K1, K3 and K4 ``launches_moe_serving`` and
``launches_glm_serving``, their launches on the paths of Qwen3-MoE and
GLM-4.5; K1, K2a, K2b and K4 ``launches_minimax_training``,
``launches_minimax_serving``, ``launches_afmoe`` and ``launches_laguna``, and
K5a ``launches_glm5_serving``, on the gated-MoE and MLA serving paths; K1,
K2a, K2b and K4 ``launches_qwen3_next_training``, ``_serving`` and
``_reference`` on the Qwen3-Next paths, and ``launches_nemotron_training``,
``_serving`` and ``_reference`` on Nemotron-H's; K1, K2a and K2b
``launches_lora_training``, K1 and K4 ``launches_lora_serving`` (K3's row
gives its 0 there: with a bank attached it never runs), and K1-K4
``launches_lora_loop``. K4's
rows at the MoE shapes count the Qwen3-30B-A3B serving path (group 8), the
GLM-4.5-Air path's chunked launches (group 12) and MiniMax-M2's (group 6);
the group-6 K1/K2 rows the MiniMax-M2 trainer, the window-hd128 rows the
AFMoE and Laguna references, K5a's serving row the GLM-5 server, and the
hd256 rows the Qwen3-Next trainer (K1 also its server) and server (K4), the
nemotron-h rows the Nemotron-H trainer (K1 also its server) and server (K4).
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
MODEL = "Qwen/Qwen3-0.6B"
GPT_OSS = "openai/gpt-oss-20b"
QWEN3_MOE = "Qwen/Qwen3-30B-A3B"
GLM = "zai-org/GLM-4.5-Air"
SEED = 0

# zai-org/GLM-5, config.json, GlmMoeDsaForCausalLM: the published widths, all
# kept. Depth and the number of routed experts are cut to fit one card.
GLM5_CONFIG = {
    "architectures": ["GlmMoeDsaForCausalLM"],
    "hidden_size": 6144, "num_attention_heads": 64, "num_key_value_heads": 64,
    "q_lora_rank": 2048, "kv_lora_rank": 512, "qk_nope_head_dim": 192,
    "qk_rope_head_dim": 64, "v_head_dim": 256, "index_n_heads": 32, "index_head_dim": 128,
    "index_topk": 2048, "intermediate_size": 12288, "moe_intermediate_size": 2048,
    "num_experts_per_tok": 8, "n_shared_experts": 1, "first_k_dense_replace": 3,
    "routed_scaling_factor": 2.5, "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "rope_interleave": True, "vocab_size": 154880,
    "tie_word_embeddings": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 202752, "eos_token_id": 154820, "pad_token_id": 154820,
    "num_hidden_layers": 78, "n_routed_experts": 256,
}
GLM5_CUTS = {"num_hidden_layers": 4, "n_routed_experts": 32}
# the trainer's cut (4 layers, 3 dense, before the cuts below): one dense and
# one MoE layer
GLM5_TRAIN_CUTS = {"num_hidden_layers": 2, "first_k_dense_replace": 1, "n_routed_experts": 32}

# a prompt of this many tokens in the GLM-5 serving phase: above top-k 2048, so
# the serving prefill's K5a and the decode's top-k select a part of the history
GLM5_LONG_PROMPT = 3500

# MiniMaxAI/MiniMax-M2, config.json, MiniMaxM2ForCausalLM: the published
# widths, all kept (intermediate_size is the experts' width). The token ids
# and max_position_embeddings are the repository's named spec's, not widths.
# Only the depth is cut (MINIMAX_TRAIN_LAYERS, MINIMAX_SERVE_LAYERS).
MINIMAX_M2_CONFIG = {
    "architectures": ["MiniMaxM2ForCausalLM"],
    "hidden_size": 3072, "num_hidden_layers": 62, "num_attention_heads": 48,
    "num_key_value_heads": 8, "head_dim": 128, "rotary_dim": 64, "intermediate_size": 1536,
    "num_local_experts": 256, "num_experts_per_tok": 8, "scoring_func": "sigmoid",
    "use_qk_norm": True, "qk_norm_type": "per_layer", "rope_theta": 5000000.0,
    "rms_norm_eps": 1e-6, "vocab_size": 200064, "tie_word_embeddings": False,
    "max_position_embeddings": 131072, "eos_token_id": 2, "pad_token_id": 0,
}
# Qwen/Qwen3-VL-8B-Instruct's config.json as its model card gives it (typed
# here: nothing is downloaded); the port's spec_from_hf_config reads it as the
# JAX package's reader does. Serving keeps all 36 layers; training keeps the
# whole tower (27 blocks; its last DeepStack tap is block 24) and cuts the
# trunk to QWEN3_VL_TRAIN_LAYERS.
QWEN3_VL = "Qwen/Qwen3-VL-8B-Instruct"
QWEN3_VL_8B_CONFIG = {
    "architectures": ["Qwen3VLForConditionalGeneration"],
    "image_token_id": 151655, "video_token_id": 151656, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653, "tie_word_embeddings": False,
    "text_config": {
        "hidden_size": 4096, "num_hidden_layers": 36, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "intermediate_size": 12288,
        "vocab_size": 151936, "rope_theta": 5000000, "max_position_embeddings": 262144,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "attention_bias": False,
        "hidden_act": "silu", "bos_token_id": 151643, "eos_token_id": 151645,
        "rope_scaling": {"rope_type": "default", "mrope_section": [24, 20, 20],
                         "mrope_interleaved": True},
    },
    "vision_config": {
        "depth": 27, "hidden_size": 1152, "intermediate_size": 4304, "num_heads": 16,
        "in_channels": 3, "patch_size": 16, "temporal_patch_size": 2, "spatial_merge_size": 2,
        "out_hidden_size": 4096, "num_position_embeddings": 2304,
        "deepstack_visual_indexes": [8, 16, 24], "hidden_act": "gelu_pytorch_tanh",
    },
}
MINIMAX_TRAIN_LAYERS = 1  # 4.90 G parameters, near GLM-5's and gpt-oss's trainer cuts
MINIMAX_SERVE_LAYERS = 4  # of 62 (8 before the last cuts)
# the Qwen3-Next and Nemotron-H train references' row (1024 tokens before
# the cuts below: their float32 CPU side took most of the run's reference
# time; the DSA, gpt-oss, AFMoE and Laguna references take 512, where their
# selections, windows and routing agreements keep their meaning and their
# floors) and the Qwen3 trainer's steps (4 before: each step publishes a 1.2
# GB snapshot)
REF_TOKENS = 256
# the steps of the trainers at seq_len 4096 (GLM-5, gpt-oss, Qwen3-30B-A3B,
# MiniMax-M2, Qwen3-Next, Nemotron-H), each run twice; 3 before the last cuts
BIG_TRAIN_STEPS = 2
TRAIN_STEPS = 2
# cuts of depth and steps that keep the run near 900 s from the build on, so
# that a host 30% slower still ends well inside the limit (the card's host
# varies 10-50% from call to call; PERF.md has the per-phase times before and
# after); every layer kind and window form of each path still runs
GPT_OSS_SERVE_LAYERS = 6  # of 24, windowed and full layers alternating (12 before the last cuts)
QWEN3_MOE_SERVE_LAYERS = 6  # of 48 (12 before the last cuts)
GPT_OSS_TRAIN_LAYERS = 2  # one windowed, one full (4 before the cuts)
# of 32 (all 32 before the last cuts): top-4 of 8 stays sparse; the trainer's
# grouped products over 32 experts are not on this path (gpt-oss-serving runs
# all 32)
GPT_OSS_TRAIN_EXPERTS = 8

# The AFMoE and Laguna phases' shape: the structure of the debug_afmoe and
# debug_laguna specs (gates, sandwich norms, a local rope base, shared
# experts, 8 experts top-2) with heads of 128 (K1, K2 and K4 take 64 or 128),
# 128-token windows on every other layer and 4 layers, the first dense. A
# test shape, not a published model: these families' published widths are
# not in the repository.
GATED_TEST_SHAPE = dict(hidden_size=1024, num_heads=8, num_kv_heads=2, head_dim=128,
                        sliding_window=128, sliding_window_pattern=2, num_layers=4,
                        first_k_dense_replace=1)

# DeepSeek-V3's dense MLA at a test shape (not its published widths): the
# family's structure, a latent of 512 + 64 rope channels, 2 layers (1 dense),
# 8 routed experts top-2 and a shared one.
DEEPSEEK_V3_TEST_CONFIG = {
    "architectures": ["DeepseekV3ForCausalLM"],
    "hidden_size": 1024, "num_attention_heads": 8, "num_key_value_heads": 8,
    "q_lora_rank": 512, "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "intermediate_size": 2048, "moe_intermediate_size": 512,
    "num_experts_per_tok": 2, "n_routed_experts": 8, "n_shared_experts": 1,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.5, "n_group": 1, "topk_group": 1,
    "scoring_func": "sigmoid", "rope_interleave": True, "vocab_size": 4096,
    "tie_word_embeddings": False, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "num_hidden_layers": 2, "eos_token_id": 1, "pad_token_id": 0,
}


# Qwen3-Next: the named spec's widths (hidden 2048, 16/2 attention heads of
# 256, 16/32 GDN key/value heads of 128, 512 experts top-10 of 512, vocab
# 151936, LLLA x 12), cut in depth (with its gdn_pattern) and experts by
# dataclasses.replace (``qwen3_next_spec``), or as a config.json
# (``qwen3_next_dir``); each cut is logged
QWEN3_NEXT = "Qwen/Qwen3-Next-80B-A3B-Instruct"
QWEN3_NEXT_PACKING = [1700, 1300, 1096]  # the kernel rows' packed row of 4096 tokens
QWEN3_NEXT_REF_CUTS = {"num_layers": 4, "num_experts": 32}  # one period, 32 experts
# 128, then 64 before the cuts: top-10 of 16 stays sparse; the trainer's grouped
# products over 64 experts are not on this path (qwen3-next-serving runs all 512)
QWEN3_NEXT_TRAIN_CUTS = {"num_layers": 4, "num_experts": 16}
QWEN3_NEXT_SERVE_LAYERS = 4  # LLLA, all 512 experts (16, then 8 before the cuts)
QWEN3_NEXT_GROUP_PROMPT = 1100  # the GRPO group's shared prompt (Nemotron-H's too)

# Nemotron-H: the repository's named 8B spec (hidden 4096, 32/8 heads of 128,
# 128 Mamba-2 heads of 64 in 8 groups, state 128, SSD chunk 128, vocab
# 131072; its 52-layer pattern is ("M-" * 6 + "*") * 4, no LatentMoE layer).
# The reference runs one layer of each kind, "M*-E", with a LatentMoE test
# shape (no Nemotron-H MoE config.json is in the repository): 8 experts top-2
# of width 2048 at latent width 1024, a shared expert of 2048.
NEMOTRON = "nvidia/Nemotron-H-8B-Base-8K"
NEMOTRON_REF_PATTERN = "M*-E"
NEMOTRON_TEST_MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=2048,
                         moe_latent_size=1024, moe_shared_expert_size=2048)
NEMOTRON_TRAIN_PATTERN = "M-*"  # 3 layers, one of each kind (13, then 7 before the cuts)
NEMOTRON_SERVE_LAYERS = 13  # one period of the pattern's four (52, then 26 before the cuts)
# the server's state tier: a checkpoint of the 24 Mamba layers' rows is 103
# MB, so the default 256 MB keeps two, and the other requests' checkpoints
# evict the shared prefix's before the request that reuses it arrives (the
# serving phase's prefix check failed so at the default)
NEMOTRON_STATE_CACHE_MB = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call: CUDA events around each call, queued
    behind a sleep kernel so host overhead stays out of the measurement;
    ``flush`` (a large tensor zeroed before each call) evicts the L2 cache."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def check_close(name: str, got, ref, atol: float, rtol: float) -> float:
    """max |got - ref|; raises unless |got - ref| <= atol + rtol * |ref| everywhere."""
    import torch

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.4g} exceeds "
                             f"atol {atol} + rtol {rtol} * |ref|")
    return float(err.max())


# bf16 stores 8 significant bits (relative rounding <= 2^-9 per value); the
# kernels round their bf16 output once and K1 also rounds its probabilities
# to bf16 before the PV product, so 1e-2 absolute plus 1e-2 relative bounds
# a correct kernel with room to spare and catches any wrong element.
ATOL, RTOL = 1e-2, 1e-2
# K5a/K5b against their plain versions on the same bf16 inputs: one bf16 step
# of the result plus the p and ds roundings that flip between the kernel's
# exp and PyTorch's, as for K2a/K2b; dkv sums up to S rows
K5B_TOL = 2e-2


def packed_segments(b: int, l: int, seg_lens: list, dev):
    """[b, l] int32 segment ids: row r holds sequences of seg_lens[r] tokens
    (ids 1, 2, ...) and padding after them; also the causal (query, key)
    pairs they leave."""
    import torch

    seg = torch.zeros(b, l, dtype=torch.int32, device=dev)
    pairs = 0
    for r, lens in enumerate(seg_lens):
        off = 0
        for i, n in enumerate(lens):
            seg[r, off:off + n] = i + 1
            off += n
            pairs += n * (n + 1) // 2
    return seg, pairs


def k1_tiles(q, k, v, seg_q, seg_kv, causal: bool, window: int = 0, sinks=None) -> str:
    """"visited of candidates": the kv tile pairs of one head that K1 visited
    and those the causal cut and the band leave it, as the kernel counted them
    in one launch. Raises unless every (batch row, head, q tile) matches the
    skip rule's plain mirror (``flash_tiles_visited``)."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        flash_tile_counts,
        flash_tiles_visited,
        fwd_tiles,
    )

    counts = flash_tile_counts(q, k, v, seg_q, seg_kv, causal, window, sinks)  # [B, NH, nq, 2]
    ones_q, ones_kv = torch.ones_like(seg_q), torch.ones_like(seg_kv)
    tiles = fwd_tiles(q.shape[-1])
    for col, (sq, sk) in enumerate(((seg_q, seg_kv), (ones_q, ones_kv))):
        rule = flash_tiles_visited(sq, sk, causal, window, *tiles).sum(-1, dtype=torch.int32)
        if not torch.equal(counts[..., col], rule[:, None].expand_as(counts[..., col])):
            what = ("visited", "candidate")[col]
            raise AssertionError(f"flash_attn_fwd: the kernel's {what} kv tiles differ from "
                                 "the skip rule's (flash_tiles_visited)")
    head = counts[:, 0].sum(dim=(0, 1))
    return f"{int(head[0])} of {int(head[1])}"


def k1_timing(name: str, q, k, v, seg, window: int = 0, sinks=None) -> dict:
    """K1 over one causal packing: its median time beside its plain version's
    and, with neither window nor sinks, one SDPA call with the same mask (no
    single PyTorch call takes sinks); its bound for the (query, key) pairs the
    mask leaves (each input read once, each output written once); and the kv
    tile pairs it visited (``k1_tiles``). Without sinks the SDPA mask
    carries the window. Logs one line; returns the row's
    numbers."""
    import torch
    import torch.nn.functional as F

    from prime_rl_tpu_torch.ops.flash_attention import _fwd, _mask, flash_attention_reference

    b, l, nh, hd = q.shape
    mask = _mask(q, k, seg, seg, True, window)  # [B, 1, L, L]
    pairs = int(mask.sum())
    ms = time_ms(lambda: _fwd(q, k, v, seg, seg, True, None, window=window, sinks=sinks))
    plain = time_ms(lambda: flash_attention_reference(q, k, v, seg, seg, True, hd ** -0.5, window,
                                                      sinks), iters=3, warmup=1)
    lib = None
    if sinks is None:  # the mask carries the window
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True), iters=10)
        del qt, kt, vt
    del mask
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + (b * nh * l + seg.numel()) * 4 + (
        0 if sinks is None else nh * 4)
    bms, by = bound(nbytes, pairs * nh * 4 * hd)
    tiles = k1_tiles(q, k, v, seg, seg, True, window, sinks)
    log(f"{name}: kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
        f"{'none' if lib is None else f'sdpa {lib:.4f} ms'}  bound {bms:.4f} ms ({by}), "
        f"{pairs} pairs a head, kv tile pairs visited {tiles} (kernel's count)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                pairs_per_head=pairs, tile_pairs_visited=tiles)


# The edge cases of K1, K2a and K2b (name, B, Lq, Lk, NH, NKV, HD, segment
# lengths of q rows, of kv rows (None: the q rows'), causal, window, sinks):
# lengths that are no multiple of the tiles (odd ones too: the flat id, lse and
# delta maps then start off 16-byte bounds), a fully padded row, many short
# segments (tiles skipped), segments that end mid-tile, GQA groups 1, 2, 4, 8
# and 12 (GLM-4.5-Air's 96/8 heads), every built head dim (320 and 512 among
# them: K1's plain form, K2's forms that compute a part of D an item), the
# cross-block form (Lq <
# Lk and Lq > Lk, rows that see no key), windows of 128 and 100 (at both head
# dims) with and without sinks, and the SFT trainer's micro-batch (2 rows of
# 8192 at Qwen3-0.6B's 16/8 heads)
K1_EDGE_CASES = (
    ("L=64 hd 128 group 2", 2, 64, 64, 4, 2, 128, [[40, 24], [64]], None, True, 0, False),
    ("L=192 hd 64 group 1, padded tail", 2, 192, 192, 2, 2, 64, [[70, 80], [100]], None, True,
     0, False),
    ("L=200 hd 128 group 8, a segment ends mid-tile", 1, 200, 200, 16, 2, 128, [[130, 70]],
     None, True, 0, False),
    ("L=1000 hd 64 group 8, 27 short segments", 2, 1000, 1000, 8, 1, 64, [[37] * 27, [500, 400]],
     None, True, 0, False),
    ("L=256 hd 128, a fully padded row", 2, 256, 256, 4, 2, 128, [[], [256]], None, True, 0,
     False),
    ("cross-block Lq 128 Lk 200, not causal", 2, 128, 200, 4, 2, 128, [[128], [100]],
     [[200], [150]], False, 0, False),
    ("L=1000 hd 64 group 8, window 128", 1, 1000, 1000, 16, 2, 64, [[300, 600]], None, True,
     128, False),
    ("L=1000 hd 64 group 8, window 128 + sinks", 1, 1000, 1000, 16, 2, 64, [[300, 600]], None,
     True, 128, True),
    ("L=1000 hd 128 group 2, sinks, padding", 2, 1000, 1000, 4, 2, 128, [[1000], [10, 600]], None,
     True, 0, True),
    ("L=77 hd 64 group 4, odd length", 3, 77, 77, 8, 2, 64, [[30, 47], [77], [5]], None, True, 0,
     False),
    ("cross-block Lq 300 Lk 77, not causal, rows that see no key", 2, 300, 77, 8, 1, 64,
     [[150, 150], [299]], [[77], [40, 30]], False, 0, False),
    ("L=333 hd 128 group 2, window 100", 1, 333, 333, 4, 2, 128, [[200, 133]], None, True, 100,
     False),
    ("L=1000 hd 128 group 12 (GLM-4.5-Air), packed segments", 2, 1000, 1000, 96, 8, 128,
     [[300, 420, 280], [1000]], None, True, 0, False),
    ("B=2 L=8192 hd 128 group 2 (the SFT micro-batch), packed segments", 2, 8192, 8192, 16, 8,
     128, [[3000, 2500, 2692], [8192]], None, True, 0, False),
    ("L=200 hd 256 group 8 (Qwen3-Next's 16/2), a segment ends mid-tile", 1, 200, 200, 16, 2,
     256, [[130, 70]], None, True, 0, False),
    ("L=77 hd 256 group 2, odd length, a padded tail", 2, 77, 77, 4, 2, 256, [[30, 47], [5]],
     None, True, 0, False),
    ("L=1000 hd 256 group 8, 27 short segments", 1, 1000, 1000, 16, 2, 256, [[37] * 27], None,
     True, 0, False),
    ("cross-block Lq 130 Lk 200 hd 256, not causal", 2, 130, 200, 4, 1, 256, [[130], [100]],
     [[200], [150]], False, 0, False),
    ("L=1000 hd 256 group 8, window 128 + sinks", 1, 1000, 1000, 16, 2, 256, [[300, 600]], None,
     True, 128, True),
    ("L=200 hd 96 group 2 (zero-padded to 128), a segment ends mid-tile", 1, 200, 200, 4, 2,
     96, [[130, 70]], None, True, 0, False),
    # head dims 384 and 512 (320 zero-padded to 384)
    ("L=200 hd 320 group 2 (zero-padded to 384), a segment ends mid-tile", 1, 200, 200, 4, 2,
     320, [[130, 70]], None, True, 0, False),
    ("L=77 hd 512 group 4, odd length, a padded tail", 2, 77, 77, 8, 2, 512, [[30, 47], [5]],
     None, True, 0, False),
    ("L=1000 hd 320 group 8, 27 short segments", 1, 1000, 1000, 16, 2, 320, [[37] * 27], None,
     True, 0, False),
    ("cross-block Lq 130 Lk 200 hd 512, not causal", 2, 130, 200, 4, 1, 512, [[130], [100]],
     [[200], [150]], False, 0, False),
    ("L=1000 hd 512 group 8, window 128 + sinks", 1, 1000, 1000, 16, 2, 512, [[300, 600]], None,
     True, 128, True),
)


def by_row(fn, b: int, batched: tuple, *rest):
    """``fn(*batched, *rest)`` computed one batch row at a time and joined on
    dim 0 (a plain attention version holds [1, NH, Lq, Lk] float32 scores at a
    time, not [B, ...]: 4.3 GB a matrix at 16 heads and L 8192)."""
    import torch

    outs = [fn(*(x[i:i + 1] for x in batched), *rest) for i in range(b)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def k1_edge_cases(gen) -> tuple[int, float]:
    """K1 on every case of K1_EDGE_CASES against its plain version (out, lse,
    padding rows), each launched twice for equal bits, and its kv tile counts
    against the skip rule. Returns (cases, max error of out)."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import _fwd, flash_attention_reference

    dev = torch.device("cuda")
    worst = 0.0
    for name, b, lq, lk, nh, nkv, hd, q_lens, kv_lens, causal, window, with_sinks in K1_EDGE_CASES:
        def randn(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

        q, k, v = randn(b, lq, nh, hd), randn(b, lk, nkv, hd), randn(b, lk, nkv, hd)
        seg_q, _ = packed_segments(b, lq, q_lens, dev)
        seg_kv = seg_q if kv_lens is None else packed_segments(b, lk, kv_lens, dev)[0]
        sinks = torch.randn(nh, device=dev, generator=gen) if with_sinks else None
        runs = [_fwd(q, k, v, seg_q, seg_kv, causal, None, window=window, sinks=sinks)
                for _ in range(2)]
        torch.cuda.synchronize()
        (out, lse), (out2, lse2) = runs
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash_attn_fwd {name}: two launches differ")
        k1_tiles(q, k, v, seg_q, seg_kv, causal, window, sinks)
        ref_out, ref_lse = by_row(flash_attention_reference, b,
                                  (q.float(), k.float(), v.float(), seg_q, seg_kv), causal,
                                  hd ** -0.5, window, sinks)
        worst = max(worst, check_close(f"flash_attn_fwd {name}", out, ref_out, ATOL, RTOL))
        check_close(f"flash_attn_fwd lse {name}", lse, ref_lse, 1e-3, 1e-4)
        pad = (seg_q == 0)[:, None, :].expand_as(lse)
        want = (sinks[None, :, None].expand_as(lse)[pad] if with_sinks
                else torch.full_like(lse[pad], -1e30))
        if not (torch.equal(lse[pad], want) and bool((out[seg_q == 0] == 0).all())):
            raise AssertionError(f"flash_attn_fwd {name}: padding rows must give out 0 and lse "
                                 "-1e30 (with sinks: the sink)")
    return len(K1_EDGE_CASES), worst


# K2a/K2b against their plain backward on the same bf16 inputs (it rounds p
# and ds to bf16 where the kernels do, and sums in float32): one bf16 step of
# the result (2^-8 relative) plus the few ds roundings that flip between the
# kernel's exp and PyTorch's -> 2e-2 absolute + 2e-2 relative
K2_TOL = 2e-2


def k2_tiles(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool, window: int = 0):
    """("visited of candidates" of K2a, of K2b): the tile pairs of one head
    (``dq_tiles``, K2a: kv tiles of 64 for each q tile of 128, of 64 at head
    dim 256, of 32 for each q tile of 64 at 384 and 512; ``dkv_tiles``, K2b: q
    tiles of 64 for each kv tile of 64, of 32 at 384 and 512, for one q head
    of its group) as the kernels counted them in
    one launch each. Raises unless every item matches the rules' plain
    mirrors (``flash_tiles_visited``, ``flash_bwd_dkv_tiles_visited``)."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        dkv_tiles,
        dq_tiles,
        flash_bwd_dkv_tiles_visited,
        flash_bwd_tile_counts,
        flash_tiles_visited,
    )

    counts = flash_bwd_tile_counts(q, k, v, seg_q, seg_kv, lse, delta, do, causal, window)
    ones_q, ones_kv = torch.ones_like(seg_q), torch.ones_like(seg_kv)
    tiles, kv_tiles = dq_tiles(q.shape[-1]), dkv_tiles(q.shape[-1])
    rules = (lambda sq, sk: flash_tiles_visited(sq, sk, causal, window, *tiles),
             lambda sq, sk: flash_bwd_dkv_tiles_visited(sq, sk, causal, window, *kv_tiles))
    out = []
    for name, got, rule in zip(("flash_attn_bwd_dq", "flash_attn_bwd_dkv"), counts, rules):
        for col, (sq, sk) in enumerate(((seg_q, seg_kv), (ones_q, ones_kv))):
            want = rule(sq, sk).sum(-1, dtype=torch.int32)  # [B, n items a head]
            if not torch.equal(got[..., col], want[:, None].expand_as(got[..., col])):
                what = ("visited", "candidate")[col]
                raise AssertionError(f"{name}: the kernel's {what} tiles differ from the skip "
                                     "rule's plain mirror")
        head = got[:, 0].sum(dim=(0, 1))
        out.append(f"{int(head[0])} of {int(head[1])}")
    return tuple(out)


def k2_timing(name: str, q, k, v, do, seg, window: int = 0, sinks=None) -> dict:
    """K2a and K2b over one causal packing (lse from K1): each one's median
    time beside its plain version's, their bounds for the (query, key) pairs
    the mask leaves (each input read once, each output written once; 3 and 4
    products of 2 HD flops a pair and head), the tile pairs they visited
    (``k2_tiles``) and, with neither window nor sinks, autograd through one
    SDPA call with the same mask, whose backward gives dq, dk and dv together.
    Logs one line a kernel; returns {"dq": row, "dkv": row}."""
    import torch
    import torch.nn.functional as F

    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        _fwd,
        _mask,
        flash_attention_dkv,
        flash_attention_dkv_reference,
        flash_attention_dq,
        flash_attention_dq_reference,
    )

    b, l, nh, hd = q.shape
    out, lse = _fwd(q, k, v, seg, seg, True, None, window=window, sinks=sinks)
    delta = _delta(out, do, None)
    args = (q, k, v, seg, seg, lse, delta, do, True, hd ** -0.5, window)
    mask = _mask(q, k, seg, seg, True, window)  # [B, 1, L, L]
    pairs = int(mask.sum())
    ms_dq = time_ms(lambda: flash_attention_dq(*args))
    ms_dkv = time_ms(lambda: flash_attention_dkv(*args))
    plain_dq = time_ms(lambda: flash_attention_dq_reference(*args), iters=3, warmup=1)
    plain_dkv = time_ms(lambda: flash_attention_dkv_reference(*args), iters=3, warmup=1)
    lib = None
    if sinks is None:  # the mask carries the window
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        do_t = do.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True),
                      iters=10)
        del qt, kt, vt, o_lib, do_t
    del mask
    tiles = k2_tiles(*args[:9], window)
    small = (2 * lse.numel() + seg.numel()) * 4
    qb, kb = q.numel() * 2, k.numel() * 2
    rows = {}
    for key, label, ms, plain, nbytes, nprod, visited in (
            ("dq", "K2a flash_attn_bwd_dq", ms_dq, plain_dq, 3 * qb + 2 * kb + small, 3, tiles[0]),
            ("dkv", "K2b flash_attn_bwd_dkv", ms_dkv, plain_dkv, 2 * qb + 4 * kb + small, 4,
             tiles[1])):
        bms, by = bound(nbytes, pairs * nh * nprod * 2 * hd)
        rows[key] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                         pairs_per_head=pairs, tile_pairs_visited=visited)
        log(f"{label} {name}: kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
            f"{'none' if lib is None else f'sdpa backward (dq+dk+dv) {lib:.4f} ms'}  bound "
            f"{bms:.4f} ms ({by}), {pairs} pairs a head, tile pairs visited {visited} (kernel's "
            "count)")
    return rows


def k2_check(name: str, q, k, v, do, seg, out, lse, window: int = 0) -> tuple[float, float]:
    """K2a and K2b over one causal packing, from K1's (out, lse), against
    their plain versions on the same bf16 inputs; padding rows must give dq =
    0. Returns the max errors of dq and of dk/dv."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention_dkv,
        flash_attention_dkv_reference,
        flash_attention_dq,
        flash_attention_dq_reference,
    )

    args = (q, k, v, seg, seg, lse, _delta(out, do, None), do, True, q.shape[-1] ** -0.5, window)
    dq, (dk, dv) = flash_attention_dq(*args), flash_attention_dkv(*args)
    torch.cuda.synchronize()
    err_dq = check_close(f"flash_attn_bwd_dq {name}", dq, flash_attention_dq_reference(*args),
                         K2_TOL, K2_TOL)
    if not bool((dq[seg == 0] == 0).all()):
        raise AssertionError(f"flash_attn_bwd_dq {name}: padding rows must give dq = 0")
    del dq
    ref_dk, ref_dv = flash_attention_dkv_reference(*args)
    err_dkv = max(check_close(f"flash_attn_bwd_dkv {n} {name}", g, r, K2_TOL, K2_TOL)
                  for n, g, r in (("dk", dk, ref_dk), ("dv", dv, ref_dv)))
    return err_dq, err_dkv


def k2_edge_cases(gen, head_dims=None) -> tuple[int, float]:
    """K2a and K2b on every case of K1_EDGE_CASES (lse from K1; the
    cross-block case, not causal, with an lse cotangent folded into delta)
    against their plain versions, padding rows dq = 0, each launched twice
    for equal bits, and their tile counts against the skip rules; with
    ``head_dims``, only the cases that run at those built head dims. Returns
    (cases, max error)."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        _fwd,
        flash_attention_dkv,
        flash_attention_dkv_reference,
        flash_attention_dq,
        flash_attention_dq_reference,
        padded_head_dim,
    )

    dev = torch.device("cuda")
    worst = 0.0
    cases = [c for c in K1_EDGE_CASES if head_dims is None or padded_head_dim(c[6]) in head_dims]
    for name, b, lq, lk, nh, nkv, hd, q_lens, kv_lens, causal, window, with_sinks in cases:
        def randn(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

        q, k, v, do = randn(b, lq, nh, hd), randn(b, lk, nkv, hd), randn(b, lk, nkv, hd), randn(
            b, lq, nh, hd)
        seg_q, _ = packed_segments(b, lq, q_lens, dev)
        seg_kv = seg_q if kv_lens is None else packed_segments(b, lk, kv_lens, dev)[0]
        sinks = torch.randn(nh, device=dev, generator=gen) if with_sinks else None
        dlse = None if causal else torch.randn(b, nh, lq, device=dev, generator=gen)
        out, lse = _fwd(q, k, v, seg_q, seg_kv, causal, None, window=window, sinks=sinks)
        delta = _delta(out, do, dlse)
        args = (q, k, v, seg_q, seg_kv, lse, delta, do, causal, hd ** -0.5, window)
        runs = [(flash_attention_dq(*args), *flash_attention_dkv(*args)) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(*runs)):
            raise AssertionError(f"flash_attn_bwd {name}: two launches differ")
        dq, dk, dv = runs[0]
        refs = (by_row(flash_attention_dq_reference, b, args[:8], *args[8:]),
                *by_row(flash_attention_dkv_reference, b, args[:8], *args[8:]))
        for what, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            worst = max(worst, check_close(f"flash_attn_bwd {what} {name}", got, ref, K2_TOL,
                                           K2_TOL))
        if not bool((dq[seg_q == 0] == 0).all()):
            raise AssertionError(f"flash_attn_bwd_dq {name}: padding rows must give dq = 0")
        tiles = k2_tiles(*args[:9], window)
        log(f"K2 edge case {name}: within tolerance, tile pairs visited {tiles[0]} (K2a), "
            f"{tiles[1]} (K2b)")
    return len(cases), worst


def k4_inputs(gen, s: int, nh: int, nkv: int, hd: int, ps: int, p: int, lengths, n_inactive=0):
    """One decode batch of K4: pools [nkv, s*p + 1, ps, hd] whose page 0 is
    the null page, slot i owning pages 1 + i*p ...; the last ``n_inactive``
    slots are inactive (their table rows all 0, as the engine leaves them);
    ``lengths`` (a list, or a function that draws them after the pools); q,
    k_new and v_new. Returns (q, k_new, v_new, k_pool, v_pool, lengths,
    table)."""
    import torch

    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    k_pool, v_pool = randn(nkv, s * p + 1, ps, hd), randn(nkv, s * p + 1, ps, hd)
    table = (1 + torch.arange(s * p, device=dev, dtype=torch.int32)).reshape(s, p)
    if n_inactive:
        table[-n_inactive:] = 0
    lengths = torch.as_tensor(lengths() if callable(lengths) else lengths,
                              dtype=torch.int32).to(dev)
    return randn(s, nh, hd), randn(s, nkv, hd), randn(s, nkv, hd), k_pool, v_pool, lengths, table


def k4_check(name: str, qd, k_new, v_new, k_pool, v_pool, lengths, table, window: int = 0,
             sinks=None, n_inactive: int = 0, launches: int = 1) -> float:
    """K4 on one decode batch against its plain version (float32 on the same
    bf16 inputs), the pool writes exact; with ``launches`` 2, on two copies of
    the pools, equal bits of the outputs and pools. With inactive slots only
    the active slots and the pages past the null page 0 are compared:
    inactive slots all append into page 0 and read it, in no fixed order.
    Leaves the appended pools in place. Returns the max error."""
    import torch

    from prime_rl_tpu_torch.ops.decode_attention import (
        decode_paged_attention,
        decode_paged_attention_reference,
    )

    k_ref, v_ref = k_pool.float(), v_pool.float()
    copies = [(k_pool.clone(), v_pool.clone()) for _ in range(launches - 1)]
    kw = dict(window=window, sinks=sinks)
    o = decode_paged_attention(qd, k_new, v_new, k_pool, v_pool, lengths, table, **kw)[0]
    again = [decode_paged_attention(qd, k_new, v_new, kp, vp, lengths, table, **kw)
             for kp, vp in copies]
    torch.cuda.synchronize()
    act = slice(0, qd.shape[0] - n_inactive)
    pages = slice(1 if n_inactive else 0, None)
    for o2, kp, vp in again:
        if not (torch.equal(o[act], o2[act]) and torch.equal(kp[:, pages], k_pool[:, pages])
                and torch.equal(vp[:, pages], v_pool[:, pages])):
            raise AssertionError(f"decode_paged_attention {name}: two launches differ")
    del copies, again
    ref_o, k_ref, v_ref = decode_paged_attention_reference(
        qd.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table, **kw)
    err = check_close(f"decode_paged_attention {name}", o[act], ref_o[act], ATOL, RTOL)
    for what, pool, want in (("k", k_pool, k_ref), ("v", v_pool, v_ref)):
        if not torch.equal(pool[:, pages].float(), want[:, pages]):
            raise AssertionError(f"decode_paged_attention {name}: {what} pool writes are not exact")
    return err


def k4_rows(name: str, qd, k_new, v_new, k_pool, v_pool, lengths, table, window: int = 0,
            sinks=None) -> int:
    """The cached rows K4's work items read, as the kernel counted them in
    one launch (``decode_rows_counts``); raises unless every item's count is
    the split rule's plain mirror (``decode_rows_visited``). Returns the rows
    of one kv head summed over the slots."""
    import torch

    from prime_rl_tpu_torch.ops.decode_attention import (
        SPLIT_ROWS,
        decode_rows_counts,
        decode_rows_visited,
        max_splits,
    )

    counts = decode_rows_counts(qd, k_new, v_new, k_pool, v_pool, lengths, table, window=window,
                                sinks=sinks)
    want = decode_rows_visited(lengths, window, SPLIT_ROWS,
                               max_splits(table.shape[1] * k_pool.shape[2], SPLIT_ROWS))
    if not torch.equal(counts, want[:, None, :].expand_as(counts)):
        raise AssertionError(f"decode_paged_attention {name}: the rows the kernel's work items "
                             "read differ from the split rule's (decode_rows_visited)")
    return int(counts[:, 0].sum())


def k4_timing(name: str, qd, k_new, v_new, k_pool, v_pool, lengths, table, window: int = 0,
              sinks=None, flush=None) -> dict:
    """K4 over one decode batch: its median time (L2 flushed before each call
    when ``flush`` is given) beside its plain version's and, without sinks,
    one SDPA call over each slot's gathered pages with the same mask (the
    gather untimed; no single PyTorch call takes sinks); its bound for the
    cached rows the inputs leave (each read once), q, the new token (read,
    and written into the pools), the output, lengths and table; and the rows
    its work items read (``k4_rows``, the kernel's count). Logs one line;
    returns the row's numbers."""
    import torch
    import torch.nn.functional as F

    from prime_rl_tpu_torch.ops.decode_attention import (
        decode_paged_attention,
        decode_paged_attention_reference,
    )

    s, nh, hd = qd.shape
    nkv, _, ps, _ = k_pool.shape
    p = table.shape[1]
    args = (qd, k_new, v_new, k_pool, v_pool, lengths, table)
    kw = dict(window=window, sinks=sinks)
    ms = time_ms(lambda: decode_paged_attention(*args, **kw), flush=flush)
    plain = time_ms(lambda: decode_paged_attention_reference(*args, **kw), iters=5, flush=flush)
    lib = None
    if sinks is None:
        t_all = p * ps
        kg = k_pool[:, table.long()].permute(1, 0, 2, 3, 4).reshape(s, nkv, t_all, hd)
        vg = v_pool[:, table.long()].permute(1, 0, 2, 3, 4).reshape(s, nkv, t_all, hd)
        pos = torch.arange(t_all, device=qd.device)[None, :]
        amask = pos < (lengths + 1)[:, None]
        if window:
            amask &= pos >= (lengths + 1 - window)[:, None]
        amask = amask[:, None, None]
        q4 = qd[:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=amask,
                                                             enable_gqa=True), flush=flush)
        del kg, vg, amask
    rows_read = k4_rows(name, *args, **kw)
    nbytes = (rows_read * nkv * hd * 2 * 2 + 2 * (s * nkv * hd * 2 * 2) + 2 * s * nh * hd * 2
              + s * 4 + s * p * 4 + (0 if sinks is None else nh * 4))
    bms, by = bound(nbytes, (rows_read + s) * nh * hd * 4)
    log(f"K4 decode_paged_attention {name}: kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
        f"{'none' if lib is None else f'sdpa over gathered pages {lib:.4f} ms'}  bound {bms:.4f} "
        f"ms ({by}), {rows_read} cached rows a kv head (kernel's count){'' if flush is None else '  (cold L2)'}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                rows_read=rows_read)


# The edge cases of K4 (name, S, NH, NKV, HD, PS, P, lengths, inactive slots
# at the end, window, sinks): lengths 0 (the new token alone), a multiple of
# PS (the append opens a page) and of the split's 256 rows, one past it,
# inactive slots reading the null page, many splits, windows whose first row
# falls inside a page and that span two splits (window 300), PS 8, 16, 32 and
# 64, tiles that span pages (PS < 64), every built head dim (64 to 512),
# groups 1, 2, 4 and 8;
# then the groups of served specs that the kernel pads to a chunk (3, 5, 6) or
# cuts into chunks of 8 and 4 (12), with and without a window
K4_EDGE_CASES = (
    ("hd 128 group 2 PS 16, lengths 0-2000", 10, 4, 2, 128, 16, 128,
     [0, 1, 15, 16, 255, 256, 257, 2000, 513, 40], 1, 0, False),
    ("hd 64 group 8 PS 64, window 128 + sinks", 6, 16, 2, 64, 64, 32,
     [0, 127, 128, 129, 1000, 2047], 0, 128, True),
    ("hd 64 group 8 PS 16, sinks, 16 splits", 4, 16, 2, 64, 16, 256,
     [4000, 1, 700, 64], 0, 0, True),
    ("hd 128 group 1 PS 8, window 300 (two splits)", 6, 2, 2, 128, 8, 128,
     [1000, 299, 300, 301, 5, 30], 1, 300, False),
    ("hd 128 group 8 PS 64, sinks", 3, 8, 1, 128, 64, 64, [3999, 2500, 777], 0, 0, True),
    ("hd 64 group 4 PS 32, lengths multiples of PS and of 256", 6, 8, 2, 64, 32, 64,
     [512, 256, 32, 0, 1024, 2015], 0, 0, False),
    ("hd 128 group 3 PS 16 (Llama-3.2-3B's 24/8)", 6, 6, 2, 128, 16, 128,
     [0, 255, 256, 1000, 2000, 17], 1, 0, False),
    ("hd 128 group 5 PS 64, sinks (Qwen3-14B's 40/8)", 4, 10, 2, 128, 64, 64,
     [3999, 512, 1, 700], 0, 0, True),
    ("hd 128 group 6 PS 32 (MiniMax-M2's 48/8)", 5, 12, 2, 128, 32, 64,
     [2047, 300, 0, 64, 1025], 0, 0, False),
    ("hd 128 group 12 PS 16 (GLM-4.5's 96/8), 16 splits", 6, 24, 2, 128, 16, 256,
     [4000, 0, 257, 1500, 40, 3], 1, 0, False),
    ("hd 128 group 12 PS 64, window 300 + sinks", 5, 12, 1, 128, 64, 64,
     [1000, 299, 300, 301, 5], 0, 300, True),
    ("hd 256 group 8 PS 16 (Qwen3-Next's 16/2), lengths 0-2000", 10, 16, 2, 256, 16, 128,
     [0, 1, 15, 16, 255, 256, 257, 2000, 513, 40], 1, 0, False),
    ("hd 256 group 8 PS 64, window 300 + sinks", 4, 16, 2, 256, 64, 32, [1000, 299, 300, 2047],
     0, 300, True),
    ("hd 256 group 2 PS 8, lengths at page and split bounds", 6, 4, 2, 256, 8, 128,
     [1023, 0, 64, 512, 7, 256], 0, 0, False),
    ("hd 256 group 12 PS 32, 8 splits", 5, 24, 2, 256, 32, 64, [2047, 300, 0, 1025, 64], 1, 0,
     False),
    # head dims 384 and 512 (the shallower rings of Cfg<384> and Cfg<512>)
    ("hd 384 group 1 PS 16, lengths 0-2000", 8, 2, 2, 384, 16, 128,
     [0, 1, 15, 256, 257, 2000, 513, 40], 1, 0, False),
    ("hd 384 group 4 PS 64, window 300 + sinks", 4, 8, 2, 384, 64, 32, [1000, 299, 300, 2047],
     0, 300, True),
    ("hd 512 group 4 PS 16, lengths 0-2000", 8, 8, 2, 512, 16, 128,
     [0, 1, 15, 256, 257, 2000, 513, 40], 1, 0, False),
    ("hd 512 group 1 PS 32, sinks, 8 splits", 5, 2, 2, 512, 32, 64, [2047, 300, 0, 1025, 64],
     0, 0, True),
    ("hd 512 group 12 PS 64, window 300", 5, 24, 2, 512, 64, 32, [1000, 299, 300, 301, 5], 1,
     300, False),
)


def k4_edge_cases(gen) -> tuple[int, float]:
    """K4 on every case of K4_EDGE_CASES against its plain version, two
    launches on each for equal bits, the pools exact, the rows each item
    read as the kernel counted them against the split rule. Returns (cases,
    max error)."""
    import torch

    worst = 0.0
    for name, s, nh, nkv, hd, ps, p, lengths, n_inactive, window, with_sinks in K4_EDGE_CASES:
        args = k4_inputs(gen, s, nh, nkv, hd, ps, p, lengths, n_inactive)
        sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
        worst = max(worst, k4_check(name, *args, window=window, sinks=sinks,
                                    n_inactive=n_inactive, launches=2))
        rows = k4_rows(name, *args, window=window, sinks=sinks)
        log(f"K4 edge case {name}: within tolerance, two launches equal, {rows} cached rows a kv "
            "head as the split rule gives")
        del args
    return len(K4_EDGE_CASES), worst


def k4_qwen3_cases(spec, gen, flush) -> list[dict]:
    """K4 at Qwen3-0.6B's serving shapes (16/8 heads of 128, PS 64, tables of
    4096 rows): 64 slots of 1-1500 cached tokens, the last 8 inactive on the
    null page (0-63 tokens), and 16 slots of 3000-4000 (the long contexts
    split-K exists for); each checked (``k4_check``) and timed
    (``k4_timing``, cold L2)."""
    import torch

    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    ps, p = 64, 4096 // 64
    cases = []
    for s, lo, hi, n_inactive in ((64, 1, 1500, 8), (16, 3000, 4000, 0)):
        def lengths():
            n = torch.randint(lo, hi + 1, (s,), device="cuda", generator=gen, dtype=torch.int32)
            if n_inactive:
                n[-n_inactive:] = torch.randint(0, 64, (n_inactive,), device="cuda",
                                                generator=gen, dtype=torch.int32)
            return n

        args = k4_inputs(gen, s, nh, nkv, hd, ps, p, lengths, n_inactive)
        shape = f"S={s} PS={ps} P={p} lengths {lo}..{hi}"
        err = k4_check(shape, *args, n_inactive=n_inactive)
        cases.append(dict(shape=shape, max_abs_err=err, **k4_timing(
            f"{shape} (err {err:.3g})", *args, flush=flush)))
        del args
        torch.cuda.empty_cache()
    return cases


def k4_moe_case(spec, gen, flush) -> dict:
    """K4 at a MoE model's serving shape (its heads of 128, PS 64, tables of
    4096 rows) over 64 slots of 500-1100 cached tokens (mean near 800),
    checked (``k4_check``) and timed (``k4_timing``, cold L2): group 8 at
    Qwen3-30B-A3B's 32/4 heads, group 12 (two chunks) at GLM-4.5-Air's 96/8."""
    import torch

    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    s, ps, p = 64, 64, 4096 // 64

    def lengths():
        return torch.randint(500, 1101, (s,), device="cuda", generator=gen, dtype=torch.int32)

    args = k4_inputs(gen, s, nh, nkv, hd, ps, p, lengths)
    shape = f"S={s} PS={ps} lengths 500..1100, {nh}/{nkv} heads (group {nh // nkv})"
    err = k4_check(shape, *args, launches=2)
    case = dict(shape=shape, max_abs_err=err, **k4_timing(f"{shape} (err {err:.3g})", *args,
                                                          flush=flush))
    del args
    torch.cuda.empty_cache()
    return case


def k4_gpt_oss_cases(spec, gen, flush, sinks) -> list[dict]:
    """K4 at gpt-oss-20b's shapes (64/8 heads of 64, sinks, PS 64, tables of
    4096 rows) over 64 slots of 500-1000 cached tokens (four shorter than the
    window: 5, 64, 126, 127), at window 128 (the windowed layers) and 0 (the
    full ones); each checked and timed as ``k4_qwen3_cases``."""
    import torch

    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    s, ps, p = 64, 64, 4096 // 64

    def lengths():
        n = torch.randint(500, 1001, (s,), device="cuda", generator=gen, dtype=torch.int32)
        n[:4] = torch.tensor([5, 64, 126, 127], dtype=torch.int32)
        return n

    args = k4_inputs(gen, s, nh, nkv, hd, ps, p, lengths)
    cases = []
    for window in (spec.sliding_window, 0):
        form = f"window {window} + sinks" if window else "full + sinks"
        shape = f"S={s} PS={ps} lengths 5..1000, {form}"
        err = k4_check(shape, *args, window=window, sinks=sinks)
        cases.append(dict(shape=shape, max_abs_err=err, **k4_timing(
            f"{shape} (err {err:.3g})", *args, window=window, sinks=sinks, flush=flush)))
    del args
    torch.cuda.empty_cache()
    return cases


def k3_inputs(gen, s: int, d: int, nh: int, nkv: int, hd: int, *, qk_norm: bool, bias: bool,
              inv_freq=None, scaling: float = 1.0, rot=None, positions=(0, 4000), eps=1e-6):
    """One K3 call: x [s, d] and the norm weight near 1, wq/wk/wv of scale
    0.02, q/k norm weights near 1 (with ``qk_norm``), q/k/v biases of scale 0.5
    (with ``bias``), positions drawn from [lo, hi), and ``inv_freq`` (default
    theta 1e6 over ``rot`` = head dim channels). Returns (args, kwargs) of
    ``decode_qkv_prep``."""
    import torch

    dev = gen.device

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    def near_one(n):
        return (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(torch.bfloat16)

    rot = (2 * inv_freq.numel() if inv_freq is not None else hd) if rot is None else rot
    if inv_freq is None:
        inv_freq = 1.0 / (1e6 ** (torch.arange(0, rot, 2, device=dev, dtype=torch.float32) / rot))
    x, nw = randn(s, d), near_one(d)
    wq, wk, wv = (randn(d, n * hd, scale=0.02) for n in (nh, nkv, nkv))
    pos = torch.randint(positions[0], positions[1], (s,), device=dev, generator=gen,
                        dtype=torch.int32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd, qk_norm=qk_norm, rot=rot,
              scaling=scaling, eps=eps)
    if qk_norm:
        kw.update(q_norm_w=near_one(hd), k_norm_w=near_one(hd))
    if bias:
        kw.update(zip(("q_bias", "k_bias", "v_bias"),
                      (randn(n * hd, scale=0.5) for n in (nh, nkv, nkv))))
    return (x, nw, wq, wk, wv, pos, inv_freq), kw


def k3_check(name: str, args, kw, launches: int = 2) -> float:
    """K3 on one call's inputs against its plain version (float32 arithmetic
    on the same bf16 inputs) at ATOL + RTOL |ref|; with ``launches`` 2, equal
    bits across two launches. Returns the max error."""
    import torch

    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep, decode_qkv_prep_reference

    runs = [decode_qkv_prep(*args, **kw) for _ in range(launches)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)):
        raise AssertionError(f"decode_qkv_prep {name}: two launches differ")
    ref = decode_qkv_prep_reference(args[0].float(), *args[1:], **kw)
    return max(check_close(f"decode_qkv_prep {name} {n}", g, r, ATOL, RTOL)
               for n, g, r in zip("qkv", runs[0], ref))


def k3_tiles(name: str, args, kw) -> dict:
    """The weight tiles K3's blocks loaded, as the kernel counted them in one
    launch (``decode_qkv_tile_counts``); raises unless every block's count is
    the tiling's plain mirror (``decode_qkv_tiles_visited``) and, up to 128
    rows, unless every weight tile was loaded exactly once. Returns the
    tiles loaded, the weight's tiles and the launch's split."""
    import math

    import torch

    from prime_rl_tpu_torch.ops.decode_qkv import (
        COL_TILE,
        ROWS_PER_BLOCK,
        WEIGHT_TILE_ROWS,
        decode_qkv_tile_counts,
        decode_qkv_tiles_visited,
    )

    x = args[0]
    s, d = x.shape
    ncols = [w.shape[1] for w in args[2:5]]
    counts = decode_qkv_tile_counts(*args, **kw)
    splits = counts.shape[2]
    want = decode_qkv_tiles_visited(s, d, ncols, splits).to(counts.device)
    if not torch.equal(counts, want):
        raise AssertionError(f"decode_qkv_prep {name}: the weight tiles the kernel's blocks "
                             "loaded differ from the tiling's (decode_qkv_tiles_visited)")
    tiles = math.ceil(d / WEIGHT_TILE_ROWS) * sum(math.ceil(n / COL_TILE) for n in ncols)
    loaded = int(counts.sum())
    if s <= ROWS_PER_BLOCK and loaded != tiles:
        raise AssertionError(f"decode_qkv_prep {name}: {loaded} weight tiles loaded of {tiles}")
    return dict(tiles_loaded=loaded, weight_tiles=tiles, splits=splits)


def k3_timing(name: str, args, kw, flush) -> dict:
    """K3 on one call's inputs: its median time beside its plain version's
    and, as the yardstick, the cuBLAS product alone (``torch.matmul`` of the
    bf16 normed x by the [D, ncols] concatenation of wq, wk, wv; the norm and
    the concatenation untimed: not the same function, so no library time),
    the L2 flushed before each call. Its bound counts x, the weights, the
    norm/bias weights, positions, inv_freq and the outputs, each moved once,
    and 2 S D ncols flops. Also the weight tiles its blocks loaded
    (``k3_tiles``). Logs one line; returns the row's numbers."""
    import torch

    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep, decode_qkv_prep_reference

    x, nw, wq, wk, wv, pos, inv_freq = args
    s, d = x.shape
    ncols = wq.shape[1] + wk.shape[1] + wv.shape[1]
    xf = x.float()
    xn = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + kw["eps"]) * nw.float()).to(
        torch.bfloat16)
    wcat = torch.cat([wq, wk, wv], 1)
    ms = time_ms(lambda: decode_qkv_prep(*args, **kw), flush=flush)
    plain = time_ms(lambda: decode_qkv_prep_reference(*args, **kw), flush=flush)
    product = time_ms(lambda: torch.matmul(xn, wcat), flush=flush)
    del xf, xn, wcat
    extra = sum(kw[n].numel() for n in ("q_bias", "k_bias", "v_bias", "q_norm_w", "k_norm_w")
                if kw.get(n) is not None)
    nbytes = (s * d + d * ncols + d + extra + s * ncols) * 2 + s * 4 + inv_freq.numel() * 4
    bms, by = bound(nbytes, 2 * s * d * ncols)
    tiles = k3_tiles(name, args, kw)
    log(f"K3 decode_qkv_prep {name}: kernel {ms:.4f} ms  plain {plain:.4f} ms  cuBLAS product "
        f"alone {product:.4f} ms  bound {bms:.4f} ms ({by}); split {tiles['splits']}, "
        f"{tiles['tiles_loaded']} weight tiles loaded of {tiles['weight_tiles']} (kernel's count)")
    return dict(ms=ms, plain_ms=plain, library_ms=None, cublas_product_ms=product, bound_ms=bms,
                bound_by=by, **tiles)


# The edge cases of K3 (name, S, D, NH, NKV, HD, qk-norm, biases, rot,
# positions [lo, hi), YaRN): S of 1, 7, 64, 65 (two M tiles), 130 and 256 (row
# groups that load the weights again), D a multiple of 16 and not of 64 (a
# partial last K tile), head dims 32 (debug_vlm's: four heads a column tile),
# 64 and 128, a kv projection of one 64-wide head
# (half a column tile), rot < HD, biases with and without qk-norm, positions
# near 131071 with gpt-oss's YaRN frequencies and scaling ("yarn") and with
# theta 1e6
K3_EDGE_CASES = (
    ("S 1 hd 128 qk-norm", 1, 1024, 16, 8, 128, True, False, 128, (0, 4000), False),
    ("S 7 hd 64 D 400 biases rot 32", 7, 400, 8, 2, 64, False, True, 32, (0, 300), False),
    ("S 64 hd 64 qk-norm + biases rot 48, one kv head", 64, 1024, 6, 1, 64, True, True, 48,
     (0, 4000), False),
    ("S 65 hd 128 D 1040 qk-norm rot 64", 65, 1040, 16, 8, 128, True, False, 64, (0, 4000),
     False),
    ("S 130 hd 64 D 2880 biases YaRN, positions near 131071", 130, 2880, 64, 8, 64, False,
     True, None, (130000, 131072), True),
    ("S 256 hd 128 qk-norm, positions near 131071", 256, 1024, 16, 8, 128, True, False, 128,
     (130000, 131072), False),
    ("S 16 hd 32 D 256 qk-norm", 16, 256, 4, 2, 32, True, False, 32, (0, 4000),
     False),
    ("S 65 hd 32 D 400 biases rot 16", 65, 400, 8, 2, 32, False, True, 16, (0, 300), False),
)


def k3_edge_cases(gen) -> tuple[int, float]:
    """K3 on every case of K3_EDGE_CASES against its plain version, two
    launches on each for equal bits, the weight tiles each block loaded as
    the kernel counted them against the tiling's mirror. Returns (cases, max
    error)."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import rope_setup

    yarn_freq, yarn = rope_setup(get_spec(GPT_OSS), device=gen.device)
    worst = 0.0
    for name, s, d, nh, nkv, hd, qk_norm, bias, rot, positions, use_yarn in K3_EDGE_CASES:
        rope = dict(inv_freq=yarn_freq, scaling=yarn) if use_yarn else dict(rot=rot)
        args, kw = k3_inputs(gen, s, d, nh, nkv, hd, qk_norm=qk_norm, bias=bias,
                             positions=positions, **rope)
        worst = max(worst, k3_check(name, args, kw))
        tiles = k3_tiles(name, args, kw)
        log(f"K3 edge case {name}: within tolerance, two launches equal, split "
            f"{tiles['splits']}, {tiles['tiles_loaded']} weight tiles loaded of "
            f"{tiles['weight_tiles']} as the tiling gives")
        del args, kw
    return len(K3_EDGE_CASES), worst


def k3_row(spec, gen, flush, name: str, *, qk_norm: bool, bias: bool) -> dict:
    """K3 at a model's serving shape (64 decode slots, positions 0-3999, the
    model's rope): checked (``k3_check``) and timed (``k3_timing``)."""
    from prime_rl_tpu_torch.models.qwen3 import rope_setup

    inv_freq, scaling = rope_setup(spec, device=gen.device)
    s = 64
    args, kw = k3_inputs(gen, s, spec.hidden_size, spec.num_heads, spec.num_kv_heads,
                         spec.head_dim, qk_norm=qk_norm, bias=bias, inv_freq=inv_freq,
                         scaling=scaling, eps=spec.rms_eps)
    err = k3_check(name, args, kw)
    rot = 2 * inv_freq.numel()
    shape = (f"S={s} D={spec.hidden_size} {spec.num_heads}/{spec.num_kv_heads} heads hd "
             f"{spec.head_dim}{f', rot {rot}' if rot != spec.head_dim else ''}"
             f"{', biases' if bias else ''}{', qk-norm' if qk_norm else ''}"
             f"{f', YaRN x{scaling:.4f}' if scaling != 1.0 else ''}")
    return dict(shape=shape, max_abs_err=err, **k3_timing(f"{name} {shape} (err {err:.3g})",
                                                          args, kw, flush))


def kernel_phase(spec) -> list[dict]:
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    from prime_rl_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_attention_with_lse,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    rows = []

    # ---- K1: prefill flash attention --------------------------------------
    # the serving path's shapes and the Qwen3 trainer's (rows of four sequences)
    cases = []
    for b, l, seg_lens in ((4, 512, [[200, 250], [512], [37], []]), (1, 2048, [[2048]]),
                           (8, 512, [[120, 130, 100, 110]] * 8)):
        q, k, v = randn(b, l, nh, hd), randn(b, l, nkv, hd), randn(b, l, nkv, hd)
        seg, _ = packed_segments(b, l, seg_lens, dev)
        out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                     True, hd ** -0.5)
        err = check_close(f"flash_attn_fwd B={b} L={l}", out, ref_out, ATOL, RTOL)
        valid = ref_lse > -1e29
        check_close("flash_attn_fwd lse", lse[valid], ref_lse[valid], 1e-3, 1e-4)
        if not bool((lse[~valid] < -1e29).all()):
            raise AssertionError("flash_attn_fwd: padding rows must give lse -1e30")
        shape = f"B={b} L={l} segments {seg_lens[0]}"
        cases.append(dict(shape=shape, max_abs_err=err, **k1_timing(
            f"K1 flash_attn_fwd {shape} (err {err:.3g})", q, k, v, seg)))
        del q, k, v, out, lse, ref_out, ref_lse
    n_edge, edge_err = k1_edge_cases(gen)
    log(f"K1 flash_attn_fwd edge cases: {n_edge} cases within tolerance, max err {edge_err:.3g}, "
        "two launches on each gave equal bits, kv tiles visited as the skip rule gives")
    rows.append(dict(name="flash_attn_fwd", route="cuda",
                     source="prime_rl_tpu_torch/csrc/flash_attn_fwd.cu",
                     replaces="prime_rl_tpu/ops/flash_attention.py:59",
                     **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
                     max_abs_err=max([edge_err] + [c["max_abs_err"] for c in cases]),
                     cases=cases, edge_cases=n_edge))

    # ---- K2a / K2b: flash attention backward ---------------------------------
    dq_cases, dkv_cases = [], []
    for b, l, seg_lens in ((8, 512, [[120, 130, 100, 110]] * 8), (1, 4096, [[4096]])):
        q, k, v = randn(b, l, nh, hd), randn(b, l, nkv, hd), randn(b, l, nkv, hd)
        do = randn(b, l, nh, hd)
        seg, _ = packed_segments(b, l, seg_lens, dev)
        out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
        err_dq, err_dkv = k2_check(f"B={b} L={l}", q, k, v, do, seg, out, lse)
        del out, lse
        shape = f"B={b} L={l} segments {seg_lens[0]}"
        timing = k2_timing(shape, q, k, v, do, seg)
        dq_cases.append(dict(shape=shape, max_abs_err=err_dq, **timing["dq"]))
        dkv_cases.append(dict(shape=shape, max_abs_err=err_dkv, **timing["dkv"]))
        del q, k, v, do
        torch.cuda.empty_cache()
    n_edge, edge_err = k2_edge_cases(gen)
    log(f"K2a/K2b edge cases: {n_edge} cases within tolerance ({K2_TOL} + {K2_TOL} * |ref|), max "
        f"err {edge_err:.3g}, padding rows dq = 0, two launches on each gave equal bits, tiles "
        "visited as the skip rules give")
    for name, cases, line in (("flash_attn_bwd_dq", dq_cases, 227),
                              ("flash_attn_bwd_dkv", dkv_cases, 282)):
        rows.append(dict(name=name, route="cuda",
                         source="prime_rl_tpu_torch/csrc/flash_attn_bwd.cu",
                         replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                         **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                         max_abs_err=max([edge_err] + [c["max_abs_err"] for c in cases]),
                         cases=cases, edge_cases=n_edge))

    # ---- K3: decode qkv prep ----------------------------------------------
    # at Qwen3-0.6B's serving shape (the row's numbers), then at the MoE
    # serving paths' own: Qwen3-30B-A3B (D 2048, 32/4 heads) and GLM-4.5-Air
    # (D 4096, 96/8 heads, rot 64 of 128)
    case = k3_row(spec, gen, flush, "Qwen3", qk_norm=True, bias=False)
    moe_cases = []
    for model in (QWEN3_MOE, GLM):
        moe_spec = get_spec(model)
        moe_cases.append(dict(model=model, **k3_row(moe_spec, gen, flush, model,
                                                    qk_norm=bool(moe_spec.qk_norm),
                                                    bias=moe_spec.attn_bias)))
    n_edge, edge_err = k3_edge_cases(gen)
    log(f"K3 decode_qkv_prep edge cases: {n_edge} cases within tolerance, max err "
        f"{edge_err:.3g}, two launches on each gave equal bits, weight tiles as the tiling gives")
    rows.append(dict(name="decode_qkv_prep", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_qkv.cu",
                     replaces="prime_rl_tpu/ops/decode_qkv.py:36",
                     **{k: v for k, v in case.items() if k != "max_abs_err"},
                     max_abs_err=max([edge_err, case["max_abs_err"]]
                                     + [c["max_abs_err"] for c in moe_cases]),
                     cases=moe_cases, edge_cases=n_edge))

    # ---- K4: paged decode attention + KV append ---------------------------
    cases = k4_qwen3_cases(spec, gen, flush)
    n_edge, edge_err = k4_edge_cases(gen)
    log(f"K4 decode_paged_attention edge cases: {n_edge} cases within tolerance, max err "
        f"{edge_err:.3g}, two launches on each gave equal bits, rows read as the split rule gives")
    rows.append(dict(name="decode_paged_attention", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50",
                     **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
                     max_abs_err=max([edge_err] + [c["max_abs_err"] for c in cases]),
                     cases=cases, edge_cases=n_edge))
    for model in (QWEN3_MOE, GLM):
        moe_spec = get_spec(model)
        case = k4_moe_case(moe_spec, gen, flush)
        group = moe_spec.num_heads // moe_spec.num_kv_heads
        rows.append(dict(name=f"decode_paged_attention/group{group}", route="cuda",
                         source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                         replaces="prime_rl_tpu/ops/decode_attention.py:50",
                         **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "max_abs_err")},
                         cases=[case], model=model))
    del flush
    torch.cuda.empty_cache()
    return rows


def causal_topk_indices(S: int, T: int, gen, device):
    """[S, T] int32 top-k-looking indices: token i selects min(T, i + 1)
    distinct rows of [0, i] at random; the rest of its row is the sentinel S."""
    import torch

    score = torch.rand(S, S, device=device, generator=gen)
    pos = torch.arange(S, device=device)
    score = torch.where(pos[None, :] <= pos[:, None], score, -1.0)
    val, idx = torch.sort(score, dim=-1, descending=True)
    idx = torch.where(val >= 0, idx, S)[:, :T].to(torch.int32)
    if T > S:
        idx = torch.nn.functional.pad(idx, (0, T - S), value=S)
    return idx.contiguous()


# K5b's edge cases: (name, S, Sk, T, layout, token that selected nothing or
# None, BWD_SLOTS of the call or None). Layouts: "causal" (token i selects
# min(T, i + 1) rows of [0, i], sentinels last), "scattered" (the same rows
# with each index row shuffled, the sentinels S, -1 and S + 7 among the real
# indices), "dense" (every token selects T distinct rows of Sk at random).
K5B_EDGE_CASES = (
    ("T=100", 300, 300, 100, "causal", 7, None),
    ("T=2047", 2100, 2100, 2047, "causal", None, None),
    ("S=1", 1, 300, 96, "dense", None, None),
    ("scattered sentinels", 320, 320, 256, "scattered", 3, None),
    ("small Sk", 256, 40, 40, "dense", None, None),
    ("several chunks", 256, 256, 128, "causal", 11, 64 * 128),
)

# K5a/K5b at the other DSA head counts (every H % 8 == 0 the JAX kernel
# takes): the K5B_EDGE_CASES fields and the heads. The wrappers pad q to whole
# groups of 64 heads and launch once a group; "several chunks" at 32 and 128
# heads runs each chunk's groups in turn through one dkvg buffer.
K5_HEAD_CASES = (
    ("H=8", 300, 300, 100, "causal", 7, None, 8),
    ("H=32 several chunks", 256, 256, 128, "causal", 11, 64 * 128, 32),
    ("H=96 scattered sentinels", 320, 320, 256, "scattered", 3, None, 96),
    ("H=128 several chunks", 256, 256, 128, "causal", None, 64 * 128, 128),
)


def k5b_inputs(gen, S: int, Sk: int, T: int, layout: str, empty, heads: int = 64):
    """q [S, heads, 576], kv [Sk, 576], do [S, heads, 512] bf16 and indices
    [S, T] int32 of one K5B_EDGE_CASES layout on the card."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    q, kv, do = randn(S, heads, K.DQ), randn(Sk, K.DQ), randn(S, heads, K.DV)
    if layout == "dense":
        idx = torch.rand(S, Sk, device=dev, generator=gen).argsort(-1)[:, :T].to(torch.int32)
    else:
        idx = causal_topk_indices(S, T, gen, dev)
        if layout == "scattered":
            perm = torch.rand(S, T, device=dev, generator=gen).argsort(-1)
            idx = idx.gather(1, perm)
            pick = torch.randint(0, 3, (S, T), device=dev, generator=gen)
            other = torch.where(pick == 0, -1, torch.where(pick == 1, S + 7, S)).to(torch.int32)
            idx = torch.where(idx >= S, other, idx)
    if empty is not None:
        idx[empty] = Sk
    return q, kv, do, idx.contiguous()


def k5a_check(name: str, q, kv, idx, empty=None):
    """K5a against the plain forward on the same bf16 inputs: out within
    K5B_TOL + K5B_TOL * |ref|, lse within 1e-3, two launches bit-equal, the
    kernel's tile counts (the first launch's) equal to
    ``sparse_mla_bwd_tiles_visited`` at ``FWD_TILE``, and out 0 with lse
    below -1e29 for a token that selected nothing. Returns (out, lse, max
    error of out, tiles visited)."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    scale = K.DQ ** -0.5
    Sk = kv.shape[0]
    tiles = torch.full((q.shape[0], 2), -1, dtype=torch.int32, device=q.device)
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, K.DV, tiles=tiles)
    out2, lse2 = K.sparse_mla_fwd(q, kv, idx, scale, K.DV)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError(f"sparse_mla_fwd {name}: two launches on the same inputs differ")
    ref_out, ref_lse = K.sparse_mla_attention_reference(q, kv, idx, scale, K.DV)
    err = check_close(f"sparse_mla_fwd out {name}", out, ref_out, K5B_TOL, K5B_TOL)
    check_close(f"sparse_mla_fwd lse {name}", lse, ref_lse, 1e-3, 0.0)
    if empty is not None and not (bool((out[empty] == 0).all())
                                  and bool((lse[empty] < -1e29).all())):
        raise AssertionError(f"sparse_mla_fwd {name}: a token that selected nothing must get "
                             "out 0 and lse -5e29")
    n = sparse_mla_tiles("sparse_mla_fwd", name, tiles, idx, Sk, K.FWD_TILE)
    log(f"K5a case {name} (S={q.shape[0]} Sk={Sk} T={idx.shape[1]} H={q.shape[1]}): err "
        f"{err:.3g}, bit-equal over two launches")
    return out, lse, err, n


def k5b_check(name: str, q, kv, do, idx, empty=None, slots=None) -> float:
    """K5b and the dkv reduction against the plain backward on the same bf16
    inputs (out and lse from K5a; ``k5b_reference``, the group mirror above
    64 heads): dq and dkv within K5B_TOL + K5B_TOL * |ref|,
    two calls bit-equal, the kernel's tile counts equal to
    ``sparse_mla_bwd_tiles_visited``, and dq = 0 for a token that selected
    nothing. ``slots`` cuts BWD_SLOTS for the call (several chunks). Returns
    the max error."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    scale = K.DQ ** -0.5
    Sk = kv.shape[0]
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, K.DV)
    own = K.BWD_SLOTS
    K.BWD_SLOTS = slots or own
    try:
        tiles = torch.full((q.shape[0], 2), -1, dtype=torch.int32, device=q.device)
        dq, dkv = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, K.DV, tiles=tiles)
        dq2, dkv2 = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, K.DV)
        chunks = K.bwd_launches(q.shape[0], idx.shape[1])
        launches = K.bwd_launches(q.shape[0], idx.shape[1], q.shape[1])
    finally:
        K.BWD_SLOTS = own
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(dkv, dkv2)):
        raise AssertionError(f"sparse_mla_bwd {name}: two runs on the same inputs differ")
    ref_dq, ref_dkv = k5b_reference(q, kv, idx, out, lse, do, scale)
    err = max(check_close(f"sparse_mla_bwd dq {name}", dq, ref_dq, K5B_TOL, K5B_TOL),
              check_close(f"sparse_mla_bwd dkv {name}", dkv, ref_dkv, K5B_TOL, K5B_TOL))
    if empty is not None and not bool((dq[empty] == 0).all()):
        raise AssertionError(f"sparse_mla_bwd {name}: a token that selected nothing must get dq 0")
    sparse_mla_tiles("sparse_mla_bwd", name, tiles, idx, Sk, K.BWD_TILE)
    log(f"K5b case {name} (S={q.shape[0]} Sk={Sk} T={idx.shape[1]} H={q.shape[1]}, {chunks} "
        f"chunk{'s' if chunks > 1 else ''}, {launches} launches): err {err:.3g}, bit-equal over "
        "two runs")
    return err


def k5b_reference(q, kv, idx, out, lse, do, scale: float):
    """K5b's plain version on the same inputs: the plain backward at up to 64
    heads, and above 64 its mirror over the kernels' groups of 64 heads
    (``sparse_mla_grouped_reference``: each group's per-slot dkv rows rounded
    to bf16 before the f32 sum, as K5b writes them, where the plain backward
    rounds the sum over all heads once). Returns (dq, dkv)."""
    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    if q.shape[1] <= K.HEADS:
        return K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale, K.DV)
    return K.sparse_mla_grouped_reference(q, kv, idx, scale, K.DV, do=do, out=out, lse=lse)[2:]


def sparse_mla_tiles(kernel: str, name: str, tiles, idx, Sk: int, bt: int) -> int:
    """A sparse-MLA kernel's own tile counts (int32 [S, 2]: visited,
    candidates; K5a's tiles of FWD_TILE slots, K5b's of BWD_TILE) against
    ``sparse_mla_bwd_tiles_visited`` at ``bt``; raises on any token where they
    differ. Returns the tiles visited."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    visit = K.sparse_mla_bwd_tiles_visited(idx, Sk, bt)
    want = torch.stack([visit.sum(-1), torch.full_like(visit.sum(-1), visit.shape[1])], -1)
    if not torch.equal(tiles.long(), want.long()):
        bad = int((tiles.long() != want.long()).any(-1).sum())
        raise AssertionError(f"{kernel} {name}: the kernel's tile counts differ from "
                             f"sparse_mla_bwd_tiles_visited on {bad} tokens")
    log(f"{kernel} {name}: tiles of {bt} slots visited {int(visit.sum())} of "
        f"{visit.numel()} (the kernel's count = the mirror's)")
    return int(visit.sum())


def k5_padded_case(gen) -> tuple[float, float]:
    """K5a and K5b at Dq 320 and v_dim 256 (the wrappers zero-pad q and kv to
    576 columns and do to 512, and slice the results back) against the plain
    versions at those widths, K5B_TOL, twice for equal bits. Returns (max error
    of out, of dq and dkv)."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    S, T, H, dq_w, dv = 300, 100, 16, 320, 256
    q, kv, do, idx = k5b_inputs(gen, S, S, T, "causal", 7, H)
    q, kv, do = q[..., :dq_w].contiguous(), kv[:, :dq_w].contiguous(), do[..., :dv].contiguous()
    scale = dq_w ** -0.5
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, dv)
    grads = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv)
    again = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("sparse_mla_bwd at Dq 320 / v_dim 256: two runs differ")
    ref_out, ref_lse = K.sparse_mla_attention_reference(q, kv, idx, scale, dv)
    ref = K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale, dv)
    err_a = check_close("sparse_mla_fwd out at Dq 320 / v_dim 256", out, ref_out, K5B_TOL,
                        K5B_TOL)
    err_b = max(check_close(f"sparse_mla_bwd {what} at Dq 320 / v_dim 256", g, r, K5B_TOL,
                            K5B_TOL) for what, g, r in zip(("dq", "dkv"), grads, ref))
    if out.shape[-1] != dv or grads[0].shape[-1] != dq_w or grads[1].shape[-1] != dq_w:
        raise AssertionError("the padded K5 wrappers must give back the narrow widths")
    log(f"K5 case Dq 320 / v_dim 256 (zero-padded to 576 / 512), H={H}: err {err_a:.3g} "
        f"(K5a), {err_b:.3g} (K5b), bit-equal over two runs")
    return err_a, err_b


def k5_edge_cases(gen) -> tuple[int, float, float]:
    """Every case of K5B_EDGE_CASES (64 heads) and K5_HEAD_CASES through
    k5a_check and k5b_check, and the narrow widths of ``k5_padded_case``.
    Returns (cases, max error of K5a, max error of K5b)."""
    worst_a = worst_b = 0.0
    cases = [c + (64,) for c in K5B_EDGE_CASES] + list(K5_HEAD_CASES)
    for name, S, Sk, T, layout, empty, slots, heads in cases:
        q, kv, do, idx = k5b_inputs(gen, S, Sk, T, layout, empty, heads)
        worst_a = max(worst_a, k5a_check(name, q, kv, idx, empty)[2])
        worst_b = max(worst_b, k5b_check(name, q, kv, do, idx, empty, slots))
    err_a, err_b = k5_padded_case(gen)
    return len(cases) + 1, max(worst_a, err_a), max(worst_b, err_b)


# K5a/K5b at the wide widths (name, Dq, v_dim, S, Sk, T, layout, empty token,
# heads): the instance's own 1152/1024 and 640/512, zero-padded to it; 24
# heads are the wide K5b's two groups of 16, the second of 8 real heads
K5_WIDE_CASES = (
    ("Dq 1152 / v_dim 1024", 1152, 1024, 300, 300, 100, "causal", 7, 16),
    ("Dq 640 / v_dim 512", 640, 512, 256, 256, 128, "scattered", 3, 32),
    ("Dq 1152 / v_dim 1024, 24 heads", 1152, 1024, 260, 260, 150, "scattered", 11, 24),
)


def k5_wide_case(gen, name: str, dq_w: int, dv: int, S: int, Sk: int, T: int, layout: str,
                 empty, heads: int) -> tuple[float, float]:
    """K5a and K5b at one of K5_WIDE_CASES against the plain versions at those
    widths (K5B_TOL; lse within 1e-3; K5b against the plain backward over its
    groups of WIDE_HEADS heads, ``sparse_mla_grouped_reference``), each twice
    for equal bits, their tile counts (of WIDE_FWD_TILE and WIDE_BWD_TILE
    slots) against the mirror, out and dq 0 for the token that selected
    nothing. Returns (max error of out, of dq and dkv)."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    idx = k5b_inputs(gen, S, Sk, T, layout, empty, 8)[3]

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, kv, do = randn(S, heads, dq_w), randn(Sk, dq_w), randn(S, heads, dv)
    scale = dq_w ** -0.5
    t_fwd, t_bwd = (torch.full((S, 2), -1, dtype=torch.int32, device="cuda") for _ in range(2))
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, dv, tiles=t_fwd)
    out2, lse2 = K.sparse_mla_fwd(q, kv, idx, scale, dv)
    grads = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv, tiles=t_bwd)
    again = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, again))):
        raise AssertionError(f"sparse_mla at {name}: two runs differ")
    ref_out, ref_lse = K.sparse_mla_attention_reference(q, kv, idx, scale, dv)
    ref = K.sparse_mla_grouped_reference(q, kv, idx, scale, dv, do=do, out=out, lse=lse)[2:]
    err_a = check_close(f"sparse_mla_fwd out at {name}", out, ref_out, K5B_TOL, K5B_TOL)
    check_close(f"sparse_mla_fwd lse at {name}", lse, ref_lse, 1e-3, 0.0)
    err_b = max(check_close(f"sparse_mla_bwd {what} at {name}", g, r, K5B_TOL, K5B_TOL)
                for what, g, r in zip(("dq", "dkv"), grads, ref))
    if not (bool((out[empty] == 0).all()) and bool((grads[0][empty] == 0).all())):
        raise AssertionError(f"sparse_mla at {name}: a token that selected nothing must get "
                             "out 0 and dq 0")
    sparse_mla_tiles("sparse_mla_fwd", name, t_fwd, idx, Sk, K.WIDE_FWD_TILE)
    sparse_mla_tiles("sparse_mla_bwd", name, t_bwd, idx, Sk, K.WIDE_BWD_TILE)
    log(f"K5 case {name} (the wide forms), H={heads}: err {err_a:.3g} (K5a), {err_b:.3g} "
        "(K5b), bit-equal over two runs")
    return err_a, err_b


def sparse_mla_build_report() -> None:
    """Registers, local memory, shared memory and blocks an SM of K5a and K5b
    as the runtime loaded them (``cudaFuncGetAttributes``); raises if either
    uses local memory (neither has local arrays, so any is a spill), or if
    K5a's compiled tile is not the wrapper's ``FWD_TILE``."""
    import ctypes

    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    lib = _build.load("sparse_mla")
    spills = []
    wide = wide_bwd_build()
    log(f"K5b at 1152/1024 build: {wide['registers']} registers a thread ({wide['threads']} "
        f"threads a block, {wide['blocks_per_sm']} blocks an SM), local memory (spills) "
        f"{wide['local_bytes']} bytes a thread, shared memory {wide['smem_bytes']} bytes dynamic "
        f"a block, tiles of {K.WIDE_BWD_TILE} slots, {K.WIDE_HEADS} heads a launch")
    if wide["local_bytes"]:
        spills.append("K5b at 1152/1024")
    if lib.sparse_mla_bwd_wide_heads() != K.WIDE_HEADS:
        raise AssertionError("the wide K5b's heads a launch differ from the wrapper's WIDE_HEADS")
    for kernel, name in ((3, "K5a at 1152/1024"), (2, "the dkv reduction at 576"),
                         (5, "the dkv reduction at 1152")):
        attrs = (ctypes.c_int * 4)()
        _build.check("sparse_mla", lib.sparse_mla_attributes(kernel, attrs))
        regs, local, static, threads = attrs
        log(f"{name} build: {regs} registers a thread ({threads} threads a block), local memory "
            f"(spills) {local} bytes a thread, shared memory {static} bytes static")
        if local:
            spills.append(name)
    if (lib.sparse_mla_wide_tile(0), lib.sparse_mla_wide_tile(1)) != (K.WIDE_FWD_TILE,
                                                                      K.WIDE_BWD_TILE):
        raise AssertionError("the wide K5a/K5b tiles differ from the wrapper's")
    for kernel, name, fn in ((0, "K5a", "sparse_mla_fwd"), (1, "K5b", "sparse_mla_bwd")):
        attrs = (ctypes.c_int * 4)()
        _build.check(fn, lib.sparse_mla_attributes(kernel, attrs))
        regs, local, static, threads = attrs
        per_sm = getattr(lib, f"{fn}_blocks_per_sm")()
        smem = getattr(lib, f"{fn}_smem")()
        tile = K.FWD_TILE if kernel == 0 else K.BWD_TILE
        log(f"{name} build: {regs} registers a thread ({threads} threads a block, {per_sm} "
            f"blocks an SM), local memory (spills) {local} bytes a thread, shared memory "
            f"{static} bytes static + {smem} dynamic a block, tiles of {tile} slots")
        if local:
            spills.append(name)
    if lib.sparse_mla_fwd_tile() != K.FWD_TILE:
        raise AssertionError(f"K5a is built with tiles of {lib.sparse_mla_fwd_tile()} slots, the "
                             f"wrapper's FWD_TILE is {K.FWD_TILE}")
    if spills:
        raise AssertionError(f"{' and '.join(spills)} use local memory: registers spill")


def wide_bwd_build() -> dict:
    """The wide K5b as the runtime loaded it: registers and local memory a
    thread, threads and dynamic shared memory a block, blocks an SM."""
    import ctypes

    from prime_rl_tpu_torch.ops import _build

    lib = _build.load("sparse_mla")
    attrs = (ctypes.c_int * 4)()
    _build.check("sparse_mla", lib.sparse_mla_attributes(4, attrs))
    regs, local, _, threads = attrs
    return dict(registers=regs, local_bytes=local, threads=threads,
                smem_bytes=lib.sparse_mla_bwd_wide_smem(),
                blocks_per_sm=lib.sparse_mla_bwd_wide_blocks_per_sm())


def k5b_wide_own_ms(q, kv, idx, out, lse, do, scale: float, flush) -> tuple[float, int]:
    """The wide K5b's own launches of one backward call (every chunk and
    group of WIDE_HEADS heads, as ``sparse_mla_bwd`` makes them) without the
    reductions, the wrapper's delta or the slot orders, timed by CUDA events
    with the L2 flushed before each pass. Returns (ms, launches a pass)."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    S, H = q.shape[:2]
    T = idx.shape[1]
    delta = (out.float() * do).sum(dim=-1).contiguous()
    dq = torch.empty_like(q)
    chunk = K.bwd_chunk(S, T, K.DQ_WIDE)
    dkvg = torch.empty((chunk, T, K.DQ_WIDE), dtype=torch.bfloat16, device=q.device)
    calls = [(slice(c0, min(c0 + chunk, S)), h0) for c0 in range(0, S, chunk)
             for h0 in range(0, H, K.WIDE_HEADS)]

    def launches():
        for sl, h0 in calls:
            K.sparse_mla_bwd_wide_chunk(q[sl], kv, idx[sl], do[sl], lse[sl], delta[sl], dq[sl],
                                        dkvg, scale, h0=h0)

    ms = time_ms(launches, iters=5, warmup=1, flush=flush)
    del dkvg, dq
    torch.cuda.empty_cache()
    return ms, len(calls)


def selection_mask(kv, idx):
    """The tokens that selected a row (a fully masked row gives SDPA NaN) and
    the dense boolean [S', Sk] mask of the rows each selected."""
    import torch

    Sk = kv.shape[0]
    real = (idx >= 0) & (idx < Sk)
    rows = real.any(-1).nonzero().squeeze(-1)
    r_i, c_i = real[rows].nonzero(as_tuple=True)
    mask = torch.zeros(len(rows), Sk, dtype=torch.bool, device=kv.device)
    mask[r_i, idx[rows][r_i, c_i].long()] = True
    return rows, mask


def k5a_library_ms(q, kv, idx, scale: float, flush, v_dim: int = 512):
    """K5a's yardstick: one ``scaled_dot_product_attention`` call over the
    tokens that selected something (a fully masked row gives NaN), q as [1,
    64, S', 576] against kv as one KV head (``enable_gqa``), v = kv[:, :512],
    a dense boolean [S', Sk] mask of the selected pairs built outside the
    timed call. It computes all S' x Sk pairs and masks the unselected ones.
    Returns (ms or None, what was timed or why not)."""
    import torch.nn.functional as F

    Sk = kv.shape[0]
    rows, mask = selection_mask(kv, idx)
    qq = q[rows].transpose(0, 1).unsqueeze(0).contiguous()
    k = kv[None, None]
    v = kv[:, :v_dim].contiguous()[None, None]
    try:
        ms = time_ms(lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask[None, None],
                                                            scale=scale, enable_gqa=True),
                     iters=5, warmup=1, flush=flush)
        return ms, f"sdpa over {len(rows)} tokens x {Sk} rows"
    except Exception as err:  # noqa: BLE001  (reported: the card refused these widths)
        return None, f"none ({type(err).__name__}: {str(err).splitlines()[0][:200]})"


def k5b_library_ms(q, kv, idx, do, scale: float, flush, v_dim: int = 512):
    """K5b's yardstick: the backward of the SDPA call of ``k5a_library_ms``
    (the same dense [S', Sk] mask of the selected pairs, the same tokens),
    timed alone: ``torch.autograd.grad`` of its output against q, k and v
    (k = kv, v = kv[:, :512], so dkv is dk plus dv padded) with ``do`` as the
    cotangent, the forward run once outside the timed calls. Returns (ms or
    None, what was timed or why not)."""
    import torch
    import torch.nn.functional as F

    Sk = kv.shape[0]
    rows, mask = selection_mask(kv, idx)
    qq = q[rows].transpose(0, 1).unsqueeze(0).contiguous().requires_grad_()
    k = kv[None, None].detach().clone().requires_grad_()
    v = kv[:, :v_dim].contiguous()[None, None].requires_grad_()
    dout = do[rows].transpose(0, 1).unsqueeze(0).contiguous()
    try:
        out = F.scaled_dot_product_attention(qq, k, v, attn_mask=mask[None, None], scale=scale,
                                             enable_gqa=True)
        ms = time_ms(lambda: torch.autograd.grad(out, (qq, k, v), dout, retain_graph=True),
                     iters=5, warmup=1, flush=flush)
        return ms, f"sdpa backward over {len(rows)} tokens x {Sk} rows"
    except Exception as err:  # noqa: BLE001  (reported: the card refused these widths)
        return None, f"none ({type(err).__name__}: {str(err).splitlines()[0][:200]})"


def sparse_mla_kernel_phase() -> list[dict]:
    """K5a, K5b and the dkv reduction against their plain versions on the same
    bf16 inputs: a packed row of 4096 tokens with top-k 2048 (the DSA trainer's
    shape) and a short row of 1024 tokens whose every index row holds
    sentinels, one of them nothing else, at 64 heads, and the trainer's shape
    at 128 heads; then K5a and K5b over every case of K5B_EDGE_CASES and
    K5_HEAD_CASES (k5_edge_cases). Each kernel launched twice for equal bits,
    with its tiles visited, as it counted them, held against the mirror."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    DQ, DV, T = K.DQ, K.DV, 2048
    scale = DQ ** -0.5
    tol = K5B_TOL
    fwd_cases, bwd_cases, red_cases = [], [], []
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # the DSA trainer's shape at GLM-5's 64 heads, the short row, and the
    # trainer's shape at 128 heads (two groups of 64 a launch each)
    for S, H in ((4096, K.HEADS), (1024, K.HEADS), (4096, 128)):
        q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
        kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
        do = torch.randn(S, H, DV, device=dev, generator=gen).to(torch.bfloat16)
        idx = causal_topk_indices(S, T, gen, dev)
        if S == 1024:
            idx[7] = S  # a token that selected nothing
        pairs = int((idx < S).sum())
        shape = f"S=Sk={S} T={T} pairs={pairs}" + ("" if H == K.HEADS else f" H={H}")

        out, lse, err_fwd, fwd_visited = k5a_check(shape, q, kv, idx, 7 if S == 1024 else None)
        dq, dkv = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
        torch.cuda.synchronize()
        ref_dq, ref_dkv = k5b_reference(q, kv, idx, out, lse, do, scale)
        err_bwd = max(check_close(f"sparse_mla_bwd dq {shape}", dq, ref_dq, tol, tol),
                      check_close(f"sparse_mla_bwd dkv {shape}", dkv, ref_dkv, tol, tol))
        if S == 1024 and not bool((dq[7] == 0).all()):
            raise AssertionError("sparse_mla_bwd: a token that selected nothing must give dq 0")
        dq2, dkv2 = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
        if not (torch.equal(dq, dq2) and torch.equal(dkv, dkv2)):
            raise AssertionError("sparse_mla_bwd: two runs on the same inputs differ")
        del ref_dq, ref_dkv, dq2, dkv2
        tiles = K.sparse_mla_bwd_tile_counts(q, kv, idx, out, lse, do, scale, DV)
        n_visited = sparse_mla_tiles("sparse_mla_bwd", shape, tiles, idx, S, K.BWD_TILE)

        # K5a with the L2 flushed before each call (as the other kernels' rows);
        # its yardstick one SDPA call (k5a_library_ms)
        ms_fwd = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV), iters=10, flush=flush)
        lib_fwd, lib_note = k5a_library_ms(q, kv, idx, scale, flush)
        lib_bwd, lib_bwd_note = k5b_library_ms(q, kv, idx, do, scale, flush)
        torch.cuda.empty_cache()  # the SDPA backward's float32 scores
        ms_bwd = time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV), iters=5)
        plain_fwd = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, DV),
                            iters=3, warmup=1)
        plain_bwd = time_ms(lambda: K.sparse_mla_backward_reference(q, kv, idx, out, lse, do,
                                                                    scale, DV),
                            iters=3, warmup=1)
        # each input read once and each output written once; the operations are
        # those of the (query, selected row) pairs this run's indices hold
        small = idx.numel() * 4 + lse.numel() * 4
        b_fwd = (q.numel() + kv.numel() + out.numel()) * 2 + small
        b_bwd = (2 * q.numel() + 2 * kv.numel() + 2 * out.numel()) * 2 + small
        for cases, name, ms, plain, lib, note, err, nbytes, flops, visited, bt in (
                (fwd_cases, "K5a sparse_mla_fwd (L2 flushed)", ms_fwd, plain_fwd, lib_fwd,
                 lib_note, err_fwd, b_fwd, 2 * H * pairs * (DQ + DV), fwd_visited, K.FWD_TILE),
                (bwd_cases, "K5b sparse_mla_bwd (+ dkv reduction)", ms_bwd, plain_bwd, lib_bwd,
                 lib_bwd_note, err_bwd, b_bwd, 2 * H * pairs * (3 * DQ + 2 * DV), n_visited,
                 K.BWD_TILE)):
            bms, by = bound(nbytes, flops)
            n_tiles = S * -(-T // bt)
            cases.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bms, bound_by=by, tiles_visited=visited,
                              tiles=f"{visited} of {n_tiles} (tiles of {bt} slots)"))
            cases[-1]["library"] = note
            log(f"{name} {shape}: err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                f"library {note if lib is None else f'{lib:.4f} ms ({note})'}  bound "
                f"{bms:.4f} ms ({by})  tiles of {bt} visited {visited} of {n_tiles} (kernel's "
                f"count)  (tolerance {tol} + {tol} * |ref|)")

        # the reduction alone, on the last chunk of queries: K5b's dkvg rows of
        # that chunk summed per kv row, against index_add_ (one PyTorch call)
        chunk = K.bwd_chunk(S, T)
        ic = idx[S - chunk:]
        dkvg = torch.empty((chunk, T, DQ), dtype=torch.bfloat16, device=dev)
        delta = (out.float() * do.float()).sum(dim=-1)
        sl = slice(S - chunk, S)
        K.sparse_mla_bwd_chunk(q[sl], kv, ic, do[sl], lse[sl], delta[sl], torch.empty_like(q[sl]),
                               dkvg, scale, DV)
        order, seg = K.slot_order(ic, S)
        valid = (ic < S).reshape(-1)
        rows_f32 = dkvg.reshape(-1, DQ)[valid].float()
        where = ic.reshape(-1)[valid].long()
        acc = torch.zeros((S, DQ), dtype=torch.float32, device=dev)
        K.sparse_mla_dkv_reduce(dkvg, order, seg, acc)
        want = torch.zeros_like(acc).index_add_(0, where, rows_f32)
        # f32 sums of the same bf16 rows in another order
        err_red = check_close(f"sparse_mla_dkv_reduce {shape}", acc, want, 1e-3, 1e-4)
        ms_red = time_ms(lambda: K.sparse_mla_dkv_reduce(dkvg, order, seg, acc), iters=10)
        plain_red = time_ms(lambda: torch.zeros_like(acc).index_add_(
            0, ic.reshape(-1)[valid].long(), dkvg.reshape(-1, DQ)[valid].float()), iters=5)
        lib_red = time_ms(lambda: acc.index_add_(0, where, rows_f32), iters=10)
        n_valid = int(valid.sum())
        bms, by = bound(n_valid * (DQ * 2 + 8) + (S + 1) * 4 + 2 * acc.numel() * 4, n_valid * DQ)
        red_cases.append(dict(shape=f"{shape} chunk={chunk} slots={n_valid}", max_abs_err=err_red,
                              ms=ms_red, plain_ms=plain_red, library_ms=lib_red, bound_ms=bms,
                              bound_by=by))
        log(f"sparse_mla_dkv_reduce {shape} (one chunk of {chunk} queries, {n_valid} slots): "
            f"err {err_red:.3g}  kernel {ms_red:.4f} ms  plain {plain_red:.4f} ms  "
            f"index_add_ {lib_red:.4f} ms  bound {bms:.4f} ms ({by})")
        del q, kv, do, idx, out, lse, dq, dkv, dkvg, acc, want, rows_f32, where, order, seg, delta
        torch.cuda.empty_cache()
    del flush
    n_edge, err_edge_a, err_edge_b = k5_edge_cases(gen)
    rows = []
    for name, cases, line in (("sparse_mla_fwd", fwd_cases, 67), ("sparse_mla_bwd", bwd_cases, 153),
                              ("sparse_mla_dkv_reduce", red_cases, 308)):
        rows.append(dict(name=name, route="cuda", source="prime_rl_tpu_torch/csrc/sparse_mla.cu",
                         replaces=f"prime_rl_tpu/ops/sparse_mla_pallas.py:{line}",
                         **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                         max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases))
    for row, err in zip(rows, (err_edge_a, err_edge_b)):
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["edge_cases"] = n_edge
        row["tiles"] = row["cases"][0]["tiles"]
    return rows


def window_pairs(n: int, window: int) -> int:
    """(query, key) pairs a causal sequence of n tokens attends under a
    sliding window (0 = none): query i sees min(i + 1, window) keys."""
    if window <= 0 or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def gpt_oss_kernel_phase() -> list[dict]:
    """The window and sink forms of K1, K2a, K2b and K4, and K3, at the shapes
    gpt-oss-20b gives them (64/8 heads of 64): K1/K2 over one row of 4096
    tokens with sinks, at window 128 (the windowed layers) and 0 (the full
    ones); K4 over 64 slots of 500-1000 cached tokens (four shorter than the
    window), both forms with sinks; K3 with q/k/v biases, no qk-norm and the
    YaRN rope. Each against its plain version on the same bf16 inputs (float32
    arithmetic), timed beside it; no single PyTorch call computes attention
    with sinks, so the library time is none."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        _fwd,
        flash_attention_reference,
        sinks_grad,
    )

    spec = get_spec(GPT_OSS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    sinks = torch.randn(nh, device=dev, generator=gen)
    scale = hd ** -0.5
    l = 4096
    q, k, v, do = randn(1, l, nh, hd), randn(1, l, nkv, hd), randn(1, l, nkv, hd), randn(
        1, l, nh, hd)
    seg = torch.ones(1, l, dtype=torch.int32, device=dev)
    fwd_cases, dq_cases, dkv_cases = [], [], []
    for window in (spec.sliding_window, 0):
        form = f"window {window} + sinks" if window else "full causal + sinks"
        shape = f"B=1 L={l} {nh}/{nkv} heads hd {hd}, {form}"
        leaves = [t.clone().requires_grad_() for t in (q, k, v, sinks)]
        out, lse = _fwd(*leaves[:3], seg, seg, True, None, window=window, sinks=leaves[3])
        dsinks = torch.autograd.grad(out, leaves[3], do)[0]
        out, lse = out.detach(), lse.detach()
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                     True, scale, window, sinks)
        err = check_close(f"flash_attn_fwd {shape}", out, ref_out, ATOL, RTOL)
        check_close(f"flash_attn_fwd lse {shape}", lse, ref_lse, 1e-3, 1e-4)
        want_ds = sinks_grad(sinks, ref_lse, _delta(ref_out, do, None))
        ds_err = float((dsinks - want_ds).norm() / want_ds.norm())
        if not ds_err <= K2_TOL:
            raise AssertionError(f"dsinks {shape}: relative error {ds_err:.4g} exceeds {K2_TOL}")
        del ref_out, ref_lse
        err_dq, err_dkv = k2_check(shape, q, k, v, do, seg, out, lse, window)
        del leaves, out, lse, dsinks
        torch.cuda.empty_cache()
        fwd_cases.append(dict(shape=shape, max_abs_err=err, **k1_timing(
            f"K1 flash_attn_fwd {shape} (err {err:.3g})", q, k, v, seg, window, sinks)))
        timing = k2_timing(shape, q, k, v, do, seg, window, sinks)
        dq_cases.append(dict(shape=shape, max_abs_err=err_dq, dsinks_rel_err=ds_err,
                             **timing["dq"]))
        dkv_cases.append(dict(shape=shape, max_abs_err=err_dkv, **timing["dkv"]))
        log(f"dsinks {shape}: relative error {ds_err:.3g} of its norm (tolerance {K2_TOL})")
        torch.cuda.empty_cache()
    windowed, full = fwd_cases[0]["ms"], fwd_cases[1]["ms"]
    if not windowed <= 0.25 * full:
        raise AssertionError(f"windowed K1 takes {windowed:.4f} ms, more than a quarter of the "
                             f"full causal K1's {full:.4f} ms: the band is not skipped")
    log(f"K1 at window {spec.sliding_window} takes {windowed / full:.3f} of the full causal time "
        f"(pairs: {fwd_cases[0]['pairs_per_head'] / fwd_cases[1]['pairs_per_head']:.3f})")

    # the full layers' row as the trainer packs it: four sequences of 1024
    packed, _ = packed_segments(1, l, [[1024] * 4], dev)
    shape = f"B=1 L={l} {nh}/{nkv} heads hd {hd}, full causal + sinks, four segments of 1024"
    out, lse = _fwd(q, k, v, packed, packed, True, None, sinks=sinks)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), packed, packed,
                                                 True, scale, 0, sinks)
    err = check_close(f"flash_attn_fwd {shape}", out, ref_out, ATOL, RTOL)
    check_close(f"flash_attn_fwd lse {shape}", lse, ref_lse, 1e-3, 1e-4)
    del ref_out, ref_lse
    err_dq, err_dkv = k2_check(shape, q, k, v, do, packed, out, lse, 0)
    del out, lse
    torch.cuda.empty_cache()
    fwd_cases.append(dict(shape=shape, max_abs_err=err, **k1_timing(
        f"K1 flash_attn_fwd {shape} (err {err:.3g})", q, k, v, packed, 0, sinks)))
    ms = fwd_cases[-1]["ms"]
    if not ms <= 0.5 * full:
        raise AssertionError(f"K1 over four packed segments takes {ms:.4f} ms, more than half of "
                             f"the one-segment time {full:.4f} ms: tiles are not skipped")
    log(f"K1 over four packed segments takes {ms / full:.3f} of the one-segment time")
    timing = k2_timing(shape, q, k, v, do, packed, 0, sinks)
    dq_cases.append(dict(shape=shape, max_abs_err=err_dq, **timing["dq"]))
    dkv_cases.append(dict(shape=shape, max_abs_err=err_dkv, **timing["dkv"]))
    k2_full = dq_cases[1]["ms"] + dkv_cases[1]["ms"]
    k2_packed = dq_cases[2]["ms"] + dkv_cases[2]["ms"]
    if not k2_packed <= 0.5 * k2_full:
        raise AssertionError(f"K2a + K2b over four packed segments take {k2_packed:.4f} ms, more "
                             f"than half of the one-segment time {k2_full:.4f} ms: tiles are not "
                             "skipped")
    log(f"K2a + K2b over four packed segments take {k2_packed / k2_full:.3f} of the one-segment "
        "time")
    del q, k, v, do
    torch.cuda.empty_cache()

    # ---- K3 at gpt-oss-20b's shapes --------------------------------------------
    case = k3_row(spec, gen, flush, "gpt-oss", qk_norm=False, bias=True)
    k3 = dict(name="decode_qkv_prep/gpt-oss", route="cuda",
              source="prime_rl_tpu_torch/csrc/decode_qkv.cu",
              replaces="prime_rl_tpu/ops/decode_qkv.py:36",
              **case)

    # ---- K4 with a window and sinks ------------------------------------------------
    k4_cases = k4_gpt_oss_cases(spec, gen, flush, sinks)
    del flush
    torch.cuda.empty_cache()

    def row(name, source, replaces, cases):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
                    max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases)

    fa = "prime_rl_tpu/ops/flash_attention.py"
    return [row("flash_attn_fwd/window+sinks", "prime_rl_tpu_torch/csrc/flash_attn_fwd.cu",
                f"{fa}:59", fwd_cases),
            row("flash_attn_bwd_dq/window", "prime_rl_tpu_torch/csrc/flash_attn_bwd.cu",
                f"{fa}:227", dq_cases),
            row("flash_attn_bwd_dkv/window", "prime_rl_tpu_torch/csrc/flash_attn_bwd.cu",
                f"{fa}:282", dkv_cases),
            k3,
            row("decode_paged_attention/window+sinks",
                "prime_rl_tpu_torch/csrc/decode_attention.cu",
                "prime_rl_tpu/ops/decode_attention.py:50", k4_cases)]


def k12_rows(gen, name: str, b: int, l: int, nh: int, nkv: int, hd: int, seg_lens,
             window: int = 0, k1: bool = True) -> list[dict]:
    """K1, K2a and K2b over one causal packing: each against its plain
    version (K1 at ATOL + RTOL |ref|, K2 at K2_TOL + K2_TOL |ref|), each
    launched twice for equal bits, then timed (``k1_timing``, ``k2_timing``).
    Returns the three rows' numbers; without ``k1``, K1 only gives K2 its
    inputs and the two rows of K2a and K2b are returned."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        _fwd,
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_reference,
    )

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    q, k, v = randn(b, l, nh, hd), randn(b, l, nkv, hd), randn(b, l, nkv, hd)
    do = randn(b, l, nh, hd)
    seg, _ = packed_segments(b, l, seg_lens, dev)
    (out, lse), (out2, lse2) = [_fwd(q, k, v, seg, seg, True, None, window=window)
                                for _ in range(2)]
    args = (q, k, v, seg, seg, lse, _delta(out, do, None), do, True, hd ** -0.5, window)
    grads = [(flash_attention_dq(*args), flash_attention_dkv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    (dq, (dk, dv)), (dq2, (dk2, dv2)) = grads
    if not (torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
            and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"flash attention {name}: two launches differ")
    del out2, lse2, grads, dq2, dk2, dv2
    if k1:
        ref_out, _ = by_row(flash_attention_reference, b,
                            (q.float(), k.float(), v.float(), seg, seg), True, hd ** -0.5,
                            window, None)
        err = check_close(f"flash_attn_fwd {name}", out, ref_out, ATOL, RTOL)
        del ref_out
    err_dq, err_dkv = k2_check(name, q, k, v, do, seg, out, lse, window)
    del out, lse, dq, dk, dv
    shape = f"B={b} L={l} {nh}/{nkv} heads hd {hd}{f', window {window}' if window else ''}, " \
            f"segments {seg_lens[0]}"
    fwd = [dict(shape=shape, max_abs_err=err, **k1_timing(
        f"K1 flash_attn_fwd {shape} (err {err:.3g}, two launches equal)", q, k, v, seg,
        window))] if k1 else []
    timing = k2_timing(shape, q, k, v, do, seg, window)
    del q, k, v, do
    torch.cuda.empty_cache()
    return fwd + [dict(shape=shape, max_abs_err=err_dq, **timing["dq"]),
                  dict(shape=shape, max_abs_err=err_dkv, **timing["dkv"])]


def gated_kernel_phase() -> list[dict]:
    """This slice's kernel rows, each held against its plain version, launched
    twice for equal bits and timed as the other rows are: K1, K2a and K2b at
    MiniMax-M2's training shape (one row of 4096 tokens in three sequences,
    48/8 heads of 128: group 6) and in their window form without sinks at
    head dim 128 (128-token windows, 8/2 heads: the AFMoE/Laguna test shape);
    K4 at MiniMax-M2's serving shape (64 slots of 500-1100 tokens, PS 64,
    48/8 heads of 128); K5a at the GLM-5 serving prefill's shape (one row of
    the 4096-token bucket of a 3500-token prompt, top-k 2048, the padding
    rows selecting nothing)."""
    import torch

    from prime_rl_tpu_torch.models.base import spec_from_hf_config
    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    for suffix, b, l, nh, nkv, seg_lens, window in (
            ("group6", 1, 4096, 48, 8, [[1200, 1500, 1396]], 0),
            ("window-hd128", 1, 4096, 8, 2, [[2048, 2048]], 128)):
        found = k12_rows(gen, suffix, b, l, nh, nkv, 128, seg_lens, window)
        for (name, line), case in zip((("flash_attn_fwd", 59), ("flash_attn_bwd_dq", 227),
                                       ("flash_attn_bwd_dkv", 282)), found):
            source = "fwd" if name == "flash_attn_fwd" else "bwd"
            rows.append(dict(name=f"{name}/{suffix}", route="cuda",
                             source=f"prime_rl_tpu_torch/csrc/flash_attn_{source}.cu",
                             replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                             **{k: case[k] for k in keys}, cases=[case]))

    minimax = spec_from_hf_config(dict(MINIMAX_M2_CONFIG))
    case = k4_moe_case(minimax, gen, flush)
    rows.append(dict(name="decode_paged_attention/group6", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50",
                     **{k: case[k] for k in keys}, cases=[case], model="MiniMaxAI/MiniMax-M2"))

    S, valid, T = 4096, GLM5_LONG_PROMPT, 2048
    H, DQ, DV = K.HEADS, K.DQ, K.DV
    scale = DQ ** -0.5
    q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
    idx = causal_topk_indices(S, T, gen, dev)
    idx[valid:] = S  # the bucket's padding rows select nothing
    pairs = int((idx < S).sum())
    shape = f"S=Sk={S} (a prompt of {valid}) T={T} pairs={pairs}"
    out, lse, err, visited = k5a_check(shape, q, kv, idx)
    ms = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV), iters=10, flush=flush)
    lib, note = k5a_library_ms(q, kv, idx, scale, flush)
    plain = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, DV), iters=3,
                    warmup=1)
    nbytes = (q.numel() + kv.numel() + out.numel()) * 2 + idx.numel() * 4 + lse.numel() * 4
    bms, by = bound(nbytes, 2 * H * pairs * (DQ + DV))
    n_tiles = S * -(-T // K.FWD_TILE)
    case = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, library=note,
                tiles=f"{visited} of {n_tiles} (tiles of {K.FWD_TILE} slots)")
    log(f"K5a sparse_mla_fwd at the serving prefill {shape}: err {err:.3g}  kernel {ms:.4f} ms  "
        f"plain {plain:.4f} ms  library {note if lib is None else f'{lib:.4f} ms ({note})'}  "
        f"bound {bms:.4f} ms ({by})  tiles of {K.FWD_TILE} visited {visited} of {n_tiles} "
        "(kernel's count)")
    rows.append(dict(name="sparse_mla_fwd/serving", route="cuda",
                     source="prime_rl_tpu_torch/csrc/sparse_mla.cu",
                     replaces="prime_rl_tpu/ops/sparse_mla_pallas.py:67",
                     **{k: case[k] for k in keys}, cases=[case]))
    del q, kv, idx, out, lse, flush
    torch.cuda.empty_cache()
    return rows


def train_reference_phase() -> None:
    """Loss and every gradient of one micro-batch [2, 512] of the full-width
    model cut to 2 layers (full vocabulary): bf16 through the kernels on the
    card against the plain float32 path on the CPU, from the same weights."""
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import init_params
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    spec = get_spec(MODEL, num_layers=2)
    gen = torch.Generator().manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16), init_params(spec, gen))
    batch, counts = FakeDataLoader(spec.vocab_size, 512, 2, 1, seed=SEED).next_batch()
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute):
        params = tree_map(lambda x: x.to(device=device, dtype=dtype).requires_grad_(), master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        loss_fn = make_loss_fn(spec, ModelConfig(compute_dtype=compute), DefaultLossConfig())
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        return float(loss.detach()), {p: x.grad.float().cpu() for p, x in tree_paths(params)}

    before = dict(_build.launches)
    loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16")
    torch.cuda.synchronize()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if _build.launches[name] <= before.get(name, 0):
            raise AssertionError(f"train-reference: {name} was not launched on the card")
    loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32")
    # bf16 weights, activations and gradients through 2 layers and a 151936-wide
    # head against float32: a few bf16 steps (2^-8) on the loss, and per tensor
    # a gradient error of a few percent of the gradient's norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    if not abs(loss_gpu - loss_cpu) <= loss_rtol * abs(loss_cpu):
        raise AssertionError(f"train-reference loss {loss_gpu} vs float32 {loss_cpu}")
    if set(grads_cpu) != set(grads_gpu):
        raise AssertionError(f"train-reference: the card's and the CPU's gradients are "
                             f"of other tensors: {sorted(set(grads_cpu) ^ set(grads_gpu))}")
    worst = 0.0
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"train-reference gradient of {path}: relative error {rel:.4g} "
                                 f"exceeds {grad_rtol}")
    log(f"train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} (tolerance {loss_rtol} "
        f"relative); worst gradient error {worst:.4g} of its norm over {len(grads_cpu)} tensors "
        f"(tolerance {grad_rtol})")


def training_phase() -> tuple[dict, dict]:
    """The port's trainer through its normal entry, twice from the same seed.
    Returns (launches of the first run, its last metrics record)."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.step import init_train_state
    from prime_rl_tpu_torch.utils.pathing import is_stable, weights_dir

    steps, n_mb, rows, seq_len = TRAIN_STEPS, 4, 8, 512

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": MODEL, "seq_len": seq_len, "debug": {"random_init": True}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
        )

    spec = get_spec(MODEL)
    if spec.num_layers != 28 or spec.vocab_size != 151936 or spec.hidden_size != 1024:
        raise AssertionError("the trained model must be Qwen3-0.6B at full width and depth")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        cfg = config(out)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        runs.append((result, dict(_build.launches)))
        log(f"training run {i}: {steps} steps in {wall:.2f} s, losses "
            f"{[r['loss'] for r in result.records]}")
    (result, launches), (again, _) = runs
    records = result.records
    if len(records) != steps:
        raise AssertionError(f"expected {steps} steps, got {len(records)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 and math.isfinite(r["entropy"])):
            raise AssertionError(f"bad step record {r}")
    if [r["loss"] for r in records] != [r["loss"] for r in again.records]:
        raise AssertionError("two runs from the same seed gave different losses")
    per_pass = spec.num_layers * n_mb * steps
    remat = config(outs[0]).model.ac.mode
    want = {"flash_attn_fwd": per_pass * (2 if remat == "full" else 1),
            "flash_attn_bwd_dq": per_pass, "flash_attn_bwd_dkv": per_pass}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the training "
                                 f"path, expected {n} (ac.mode {remat})")
    # parameters changed: against the initial state rebuilt from the same seed
    cfg = config(outs[0])
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    init = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(tree_leaves(init.params), tree_leaves(result.state.params)))
    del init
    if changed < len(tree_leaves(result.state.params)) // 2:
        raise AssertionError(f"only {changed} parameter tensors changed in {steps} steps")
    snap = weights_dir(outs[0], steps)
    if not is_stable(snap):
        raise AssertionError(f"no STABLE v{steps} snapshot at {snap}")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in tree_paths(result.state.params):
        if not torch.equal(loaded[path], want_t):
            raise AssertionError(f"v{steps} snapshot: {path} differs from the state's parameters")
    last = dict(records[-1], peak_gib=peak_gib)
    log(f"training: {steps} steps of {n_mb} x [{rows}, {seq_len}] tokens; peak {peak_gib:.2f} "
        f"GiB; last step "
        f"{last['step_time_s']:.3f} s, {n_mb * rows * seq_len / last['step_time_s']:.0f} tokens/s, "
        f"MFU {spec.flops_per_token(seq_len) * n_mb * rows * seq_len / last['step_time_s'] / PEAK_BF16:.4f} "
        f"of {PEAK_BF16 / 1e12:.0f} TFLOP/s; {changed} parameter tensors changed; the v{steps} "
        f"snapshot reads back equal; launches {launches}")
    for out in outs:
        shutil.rmtree(out, ignore_errors=True)
    del runs, result, again, loaded
    torch.cuda.empty_cache()
    return launches, last


def glm5_model_dir(name: str, **cuts) -> str:
    """A directory whose config.json names GlmMoeDsaForCausalLM at GLM-5's
    widths with ``cuts`` applied: how this family is given to the trainer."""
    return config_dir(name, GLM5_CONFIG, **cuts)


def config_dir(name: str, config: dict, **cuts) -> str:
    """A directory under build/chip_smoke whose config.json is ``config``
    with ``cuts`` applied, each cut logged."""
    path = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**config, **cuts}, f, indent=1)
    for key, value in cuts.items():
        log(f"{name}: {key} cut from {config.get(key)} to {value}")
    return path


def dsa_train_reference_phase() -> None:
    """Loss and every gradient of one row of 512 tokens through the
    glm_moe_dsa model at GLM-5's widths, cut to 1 dense + 1 MoE layer of 8
    experts with top-k 256 (so that the selection restricts): bf16 through
    K5a/K5b on the card, under full remat, against float32 on the CPU through
    the chunked-gather op and PyTorch's autograd, from the same weights.

    The top-k is a discrete choice: scored from bf16 activations on the card
    and from float32 ones on the CPU, a few percent of the selected rows differ,
    and the two runs then differentiate two different functions (gradients up
    to 30% apart, while with equal selections every tensor agrees within 2%).
    So the CPU run is made twice: once with its own selections, to report how
    far the card's agree with them (at least 90% of each layer's selected rows
    must be the same), and once replaying the card's, which is the run the
    loss and the gradients are held against."""
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    seq_len = 512  # 1024 before the cuts; the selections still share 95-100% of their rows
    spec = get_spec(glm5_model_dir("glm5_reference", num_hidden_layers=2, first_k_dense_replace=1,
                                   n_routed_experts=8, index_topk=256))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16),
                      get_family(spec).init(spec, gen, device="cuda"))
    batch, counts = FakeDataLoader(spec.vocab_size, seq_len, 1, 1, seed=SEED).next_batch()
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute, remat, backward=True):
        params = tree_map(lambda x: x.detach().to(device=device, dtype=dtype).requires_grad_(),
                          master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        cfg = ModelConfig(compute_dtype=compute, ac={"mode": remat})
        loss_fn = make_loss_fn(spec, cfg, DefaultLossConfig())
        if not backward:
            with torch.no_grad():
                return float(loss_fn(params, mb, scales)[0]), None
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        grads = {p: (None if x.grad is None else x.grad.float().cpu())
                 for p, x in tree_paths(params)}
        return float(loss.detach()), grads

    before = dict(_build.launches)
    t0 = time.perf_counter()
    on_card: list = []
    with dsa_selections(record=on_card):
        loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16", "full")
    torch.cuda.synchronize()
    for name in ("sparse_mla_fwd", "sparse_mla_bwd", "sparse_mla_dkv_reduce"):
        if _build.launches[name] <= before.get(name, 0):
            raise AssertionError(f"dsa-train-reference: {name} was not launched on the card")
    # the forward's calls come first, one a layer; the recompute's follow
    on_card = [idx.cpu() for idx in on_card[:spec.num_layers]]
    t1 = time.perf_counter()
    own: list = []
    with dsa_selections(record=own):
        loss_own, _ = run(torch.device("cpu"), torch.float32, "float32", "none", backward=False)
    overlaps = []
    for a, b in zip(on_card, own):
        # every 16th token's selected set (the sentinel counts as one member)
        pairs = [(set(x), set(y)) for x, y in zip(a[::16].tolist(), b[::16].tolist())]
        overlaps.append(sum(len(x & y) for x, y in pairs) / sum(len(x) for x, _ in pairs))
    if min(overlaps) < 0.9:
        raise AssertionError(f"dsa-train-reference: the card's selections share only {overlaps} "
                             "of their rows with the float32 indexer's")
    with dsa_selections(replay=on_card):
        loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32", "none")
    t2 = time.perf_counter()
    del master
    torch.cuda.empty_cache()
    # bf16 weights, activations and gradients through 2 layers and a 154880-wide
    # head against float32, on the same selections: a few bf16 steps (2^-8) on
    # the loss, and per tensor a gradient error of a few percent of its norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    for what, ref in (("the card's selections", loss_cpu), ("its own selections", loss_own)):
        if not abs(loss_gpu - ref) <= loss_rtol * abs(ref):
            raise AssertionError(f"dsa-train-reference loss {loss_gpu} vs float32 {ref} on {what}")
    worst, n = 0.0, 0
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        if want is None or got is None or float(want.norm()) == 0.0:
            # the indexer and the selection bias: no gradient on either side
            if not ((want is None or float(want.norm()) == 0.0)
                    and (got is None or float(got.norm()) == 0.0)):
                raise AssertionError(f"dsa-train-reference: {path} has a gradient on one side only")
            continue
        rel = float((got - want).norm() / want.norm())
        worst, n = max(worst, rel), n + 1
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"dsa-train-reference gradient of {path}: relative error "
                                 f"{rel:.4g} exceeds {grad_rtol}")
    log(f"dsa-train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} on the card's "
        f"selections and {loss_own:.6g} on its own (tolerance {loss_rtol} relative); the "
        f"selections share {[round(o, 4) for o in overlaps]} of their rows per layer; worst "
        f"gradient error {worst:.4g} of its norm over {n} tensors (tolerance {grad_rtol}); "
        f"card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


def dsa_training_phase() -> tuple[dict, dict]:
    """The trainer through its normal entry on a GlmMoeDsaForCausalLM directory
    at GLM-5's widths, twice from the same seed. Returns (launches of the first
    run, numbers of its last step). The run is in bench mode, which publishes
    the initial weights only: at this size a snapshot per step is 9 GB through
    the host (the Qwen3 phase covers publishing every step); one snapshot is
    written and read back here."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.ops import _build, moe
    from prime_rl_tpu_torch.ops.sparse_mla_kernel import bwd_launches
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.step import init_train_state
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    steps, n_mb, rows, seq_len = BIG_TRAIN_STEPS, 2, 1, 4096
    model_dir = glm5_model_dir("glm5_model", **GLM5_TRAIN_CUTS)

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": model_dir, "seq_len": seq_len, "debug": {"random_init": True}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
            bench={"warmup_steps": 0, "steps": steps},
        )

    spec = get_spec(model_dir)
    if (spec.family, spec.hidden_size, spec.num_heads, spec.kv_lora_rank, spec.index_topk,
            spec.vocab_size) != ("glm_moe_dsa", 6144, 64, 512, 2048, 154880):
        raise AssertionError("the trained model must be glm_moe_dsa at GLM-5's widths")
    log(f"dsa-training: {spec.num_layers} layers ({spec.first_k_dense_replace} dense), "
        f"{spec.num_experts} routed experts")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"dsa_train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(config(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        # only the last run's state is kept: two states do not fit beside a step
        runs.append((result.records, dict(_build.launches), peak))
        state = result.state if i == len(outs) - 1 else None
        del result
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        log(f"dsa-training run {i}: {steps} steps in {wall:.2f} s (initial publish included), "
            f"peak device memory {peak:.2f} GiB, losses {[r['loss'] for r in runs[-1][0]]}, "
            f"step times {[round(r['step_time_s'], 3) for r in runs[-1][0]]}")
    (records, launches, peak), (records_again, _, _) = runs
    losses = [r["loss"] for r in records]
    if len(records) != steps:
        raise AssertionError(f"expected {steps} steps, got {len(records)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 and math.isfinite(r["entropy"])):
            raise AssertionError(f"bad step record {r}")
    if len(set(losses)) != steps:
        raise AssertionError(f"the losses do not change from step to step: {losses}")
    if losses != [r["loss"] for r in records_again]:
        raise AssertionError(f"two runs from the same seed gave different losses: {losses} and "
                             f"{[r['loss'] for r in records_again]}")
    per_pass = spec.num_layers * n_mb * rows * steps
    remat = config(outs[0]).model.ac.mode
    chunks = bwd_launches(seq_len, spec.index_topk)
    want = {"sparse_mla_fwd": per_pass * (2 if remat == "full" else 1),
            "sparse_mla_bwd": per_pass * chunks, "sparse_mla_dkv_reduce": per_pass * chunks}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the DSA training "
                                 f"path, expected {n} (ac.mode {remat}, {chunks} chunks a call)")
    cfg = config(outs[0])
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    init = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(tree_leaves(init.params), tree_leaves(state.params)))
    del init
    torch.cuda.empty_cache()
    if changed < len(tree_leaves(state.params)) // 2:
        raise AssertionError(f"only {changed} parameter tensors changed in {steps} steps")
    snap = os.path.join(ROOT, "build", "chip_smoke", "dsa_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    save_hf_weights(state.params, spec, snap)
    t_save = time.perf_counter() - t0
    if get_spec(snap) != spec:
        raise AssertionError("the snapshot's config.json does not read back as the trained spec")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in tree_paths(state.params):
        if not torch.equal(loaded[path].float(), want_t.float()):
            raise AssertionError(f"snapshot: {path} differs from the state's parameters")
    shutil.rmtree(snap, ignore_errors=True)
    last = records[-1]
    tokens = n_mb * rows * seq_len
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=peak, parameters=n_params, grouped_product=moe.grouped_product_impl(
                       tree_leaves(state.params)[0]))
    log(f"dsa-training: {n_params / 1e9:.3f} G parameters; {steps} steps of {n_mb} x [{rows}, "
        f"{seq_len}] tokens; last step "
        f"{last['step_time_s']:.3f} s, {numbers['tokens_per_s']:.0f} tokens/s, peak device memory "
        f"{peak:.2f} GiB; {changed} parameter tensors changed; the snapshot ({t_save:.1f} s to "
        f"write) reads back equal through get_spec and from_hf; expert products by "
        f"{numbers['grouped_product']}; launches {launches}")
    del state, loaded
    torch.cuda.empty_cache()
    return launches, numbers


def gpt_oss_model_dir(name: str, **cuts) -> str:
    """A directory whose config.json names GptOssForCausalLM at
    gpt-oss-20b's widths (the built-in spec of openai/gpt-oss-20b, written as
    the trainer writes its snapshots) with ``cuts`` applied; a cut of the depth
    cuts the layer-type list with it, so the alternation stays."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.trainer.weights import spec_to_hf_config

    cfg = spec_to_hf_config(get_spec(GPT_OSS))
    new = {**cfg, **cuts}
    new["layer_types"] = cfg["layer_types"][:new["num_hidden_layers"]]
    path = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(new, f, indent=1)
    for key, value in cuts.items():
        log(f"{name}: {key} cut from {cfg.get(key)} to {value}")
    return path


@contextlib.contextmanager
def recorded_routing(record: list | None = None, replay: list | None = None):
    """Within the block, every ``route_topk`` call appends its expert ids to
    ``record``, or routes to the next ids of ``replay`` (router replay: the
    combine weights are still its own router's, at those experts)."""
    from prime_rl_tpu_torch.ops import moe

    own = moe.route_topk
    todo = iter(replay or ())

    def wrapped(x, *args, **kw):
        if replay is not None:
            kw["forced_experts"] = next(todo).to(x.device)
        out = own(x, *args, **kw)
        if record is not None:
            record.append(out.expert_ids)
        return out

    moe.route_topk = wrapped
    try:
        yield
    finally:
        moe.route_topk = own


def perturbed(params: dict, gen) -> dict:
    """``params`` with the sinks drawn from N(0, 1) and every bias from
    N(0, 0.1^2), so that neither is the init's zero (in every layer stack:
    ``layers``, or Qwen3-Next's ``lin_layers`` and ``attn_layers``, whose
    ``dt_bias`` is not the init's zero and stays)."""
    import torch

    out = dict(params)
    for stack, layers in params.items():
        if not isinstance(layers, dict):
            continue
        layers = dict(layers)
        for name, t in layers.items():
            if name == "sink" or (name.endswith("_bias") and name != "dt_bias"):
                std = 1.0 if name == "sink" else 0.1
                layers[name] = (torch.randn(t.shape, device=t.device, generator=gen)
                                * std).to(t.dtype)
        out[stack] = layers
    return out


def gpt_oss_train_reference_phase() -> None:
    """Loss and every gradient, the sinks' and the biases' included, of one
    micro-batch of 512 tokens (a row of two sequences and padding) through
    gpt-oss at gpt-oss-20b's widths, cut to 2 layers (one windowed, one full)
    of 8 experts: bf16 through K1/K2a/K2b on the card under full remat, against
    float32 on the CPU from the same weights.

    The top-4 of 8 experts is a discrete choice: scored from bf16 activations
    on the card and from float32 ones on the CPU, a near-tie can pick another
    expert, and the two runs then differentiate two different functions. So
    the CPU runs twice: with its own routing, to report the share of the
    card's choices it agrees with (at least 90%), and replaying the card's
    routing (``routed_experts``), which is the run the loss and the gradients
    are held against."""
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    import numpy as np

    seq_len = 512  # 1024 before the cuts; each sequence still twice the window
    spec = get_spec(gpt_oss_model_dir("gpt_oss_reference", num_hidden_layers=2,
                                      num_local_experts=8))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16),
                      perturbed(get_family(spec).init(spec, gen, device="cuda"), gen))
    batch, counts = FakeDataLoader(spec.vocab_size, seq_len // 2, 2, 1, seed=SEED).next_batch()
    # the two half-length rows packed into one row of two sequences
    batch = MicroBatchArrays(*[None if x is None else x.reshape(1, 1, seq_len) for x in batch])
    seg, second = batch.segment_ids, np.arange(seq_len) >= seq_len // 2
    batch = batch._replace(segment_ids=np.where((seg > 0) & second, seg + 10, seg).astype(np.int32))
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute, remat, routed=None, backward=True):
        params = tree_map(lambda x: x.detach().to(device=device, dtype=dtype).requires_grad_(),
                          master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        if routed is not None:
            mb = mb._replace(routed_experts=routed.to(device))
        cfg = ModelConfig(compute_dtype=compute, ac={"mode": remat})
        loss_fn = make_loss_fn(spec, cfg, DefaultLossConfig())
        if not backward:
            with torch.no_grad():
                return float(loss_fn(params, mb, scales)[0]), None
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        return float(loss.detach()), {p: x.grad.float().cpu() for p, x in tree_paths(params)}

    before = dict(_build.launches)
    t0 = time.perf_counter()
    on_card: list = []
    with recorded_routing(on_card):
        loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16", "full")
    torch.cuda.synchronize()
    for name in ("flash_attn_fwd/window", "flash_attn_fwd/sinks", "flash_attn_bwd_dq/window",
                 "flash_attn_bwd_dkv/window"):
        if _build.launches[name] <= before.get(name, 0):
            raise AssertionError(f"gpt-oss-train-reference: {name} was not launched on the card")
    # the forward's calls come first, one a layer; the recompute's follow
    routed = torch.stack([e.cpu() for e in on_card[:spec.num_layers]], dim=1)  # [T, NL, K]
    t1 = time.perf_counter()
    own: list = []
    with recorded_routing(own):
        loss_own, _ = run(torch.device("cpu"), torch.float32, "float32", "none", backward=False)
    agree = [float(sum(len(set(a) & set(b)) for a, b in zip(x.tolist(), y.cpu().tolist()))
                   / x.numel()) for x, y in zip(routed.unbind(1), own)]
    if min(agree) < 0.9:
        raise AssertionError(f"gpt-oss-train-reference: the card's routing agrees with the "
                             f"float32 router's on only {agree} of its choices")
    loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32", "none",
                              routed=routed.reshape(1, seq_len, spec.num_layers, -1))
    t2 = time.perf_counter()
    del master
    torch.cuda.empty_cache()
    # bf16 weights, activations and gradients through 2 layers and a 201088-wide
    # head against float32 on the same routing: a few bf16 steps (2^-8) on the
    # loss, and per tensor a gradient error of a few percent of its norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    for what, ref in (("the card's routing", loss_cpu), ("its own routing", loss_own)):
        if not abs(loss_gpu - ref) <= loss_rtol * abs(ref):
            raise AssertionError(f"gpt-oss-train-reference loss {loss_gpu} vs float32 {ref} on "
                                 f"{what}")
    worst, errs = 0.0, {}
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        worst, errs[path] = max(worst, rel), rel
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"gpt-oss-train-reference gradient of {path}: relative error "
                                 f"{rel:.4g} exceeds {grad_rtol}")
    log(f"gpt-oss-train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} on the card's "
        f"routing and {loss_own:.6g} on its own (tolerance {loss_rtol} relative); the routing "
        f"agrees on {[round(a, 4) for a in agree]} of the choices per layer; worst gradient "
        f"error {worst:.4g} of its norm over {len(grads_cpu)} tensors, the sinks' "
        f"{errs['layers/sink']:.4g} (tolerance {grad_rtol}); card {t1 - t0:.1f} s, "
        f"CPU {t2 - t1:.1f} s")


def packed_fake_loader(per_row: int):
    """A ``FakeDataLoader`` whose rows each pack ``per_row`` sequences of an
    eighth to a quarter of a row (for ``per_row`` 4; its own draws fill a row
    with one sequence of half to all of it)."""
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader

    class Packed(FakeDataLoader):
        def __init__(self, vocab_size, seq_len, rows=1, num_micro_batches=4, **kw):
            super().__init__(vocab_size, seq_len, rows, num_micro_batches,
                             sequences_per_batch=per_row * rows * num_micro_batches, **kw)

        def make_sample(self):
            full, self.seq_len = self.seq_len, self.seq_len // per_row
            try:
                return super().make_sample()  # draws a length in [seq_len / 2, seq_len]
            finally:
                self.seq_len = full

    return Packed


@contextlib.contextmanager
def packed_fake_rows(per_row: int):
    """Within the block the trainer's fake loader is ``packed_fake_loader``."""
    from prime_rl_tpu_torch.trainer.rl import train as train_mod

    own = train_mod.FakeDataLoader
    train_mod.FakeDataLoader = packed_fake_loader(per_row)
    try:
        yield
    finally:
        train_mod.FakeDataLoader = own


def gpt_oss_training_phase() -> tuple[dict, dict]:
    """The trainer through its normal entry on a GptOssForCausalLM directory
    at gpt-oss-20b's widths, cut to ``GPT_OSS_TRAIN_LAYERS`` layers (windowed
    and full alternating) with GPT_OSS_TRAIN_EXPERTS experts, twice from the same seed, on
    rows of four sequences each.
    Returns (launches of the first run, numbers of its last step). Bench mode,
    as in the DSA phase: only the initial weights are published (a snapshot
    is 8.9 GB); one snapshot is written and read back here."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import layer_windows_list, load_hf_weights
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    steps, n_mb, rows, seq_len, per_row = BIG_TRAIN_STEPS, 2, 1, 4096, 4
    model_dir = gpt_oss_model_dir("gpt_oss_model", num_hidden_layers=GPT_OSS_TRAIN_LAYERS,
                                  num_local_experts=GPT_OSS_TRAIN_EXPERTS)

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": model_dir, "seq_len": seq_len, "debug": {"random_init": True}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
            bench={"warmup_steps": 0, "steps": steps},
        )

    spec = get_spec(model_dir)
    if (spec.family, spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.head_dim,
            spec.num_experts, spec.vocab_size) != ("gpt_oss", 2880, 64, 8, 64, GPT_OSS_TRAIN_EXPERTS,
                                                   201088):
        raise AssertionError("the trained model must be gpt-oss at gpt-oss-20b's widths")
    windows = layer_windows_list(spec)
    log(f"gpt-oss-training: {spec.num_layers} layers (windows {windows}), {spec.num_experts} "
        f"experts, ac.mode {config('-').model.ac.mode}, {per_row} sequences a row")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"gpt_oss_train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with packed_fake_rows(per_row):
            result = train(config(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append((result.records, dict(_build.launches), peak))
        state = result.state if i == len(outs) - 1 else None
        del result
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        log(f"gpt-oss-training run {i}: {steps} steps in {wall:.2f} s (initial publish included), "
            f"peak device memory {peak:.2f} GiB, losses {[r['loss'] for r in runs[-1][0]]}, "
            f"step times {[round(r['step_time_s'], 3) for r in runs[-1][0]]}")
    (records, launches, peak), (records_again, _, _) = runs
    losses = [r["loss"] for r in records]
    if len(records) != steps:
        raise AssertionError(f"expected {steps} steps, got {len(records)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 and math.isfinite(r["entropy"])):
            raise AssertionError(f"bad step record {r}")
    if losses != [r["loss"] for r in records_again]:
        raise AssertionError(f"two runs from the same seed gave different losses: {losses} and "
                             f"{[r['loss'] for r in records_again]}")
    per_pass = spec.num_layers * n_mb * rows * steps
    windowed = sum(1 for w in windows if w) * n_mb * rows * steps
    fwd_passes = 2 if config("-").model.ac.mode == "full" else 1
    want = {"flash_attn_fwd": per_pass * fwd_passes, "flash_attn_fwd/sinks": per_pass * fwd_passes,
            "flash_attn_fwd/window": windowed * fwd_passes,
            "flash_attn_bwd_dq": per_pass, "flash_attn_bwd_dkv": per_pass,
            "flash_attn_bwd_dq/window": windowed, "flash_attn_bwd_dkv/window": windowed}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the gpt-oss "
                                 f"training path, expected {n}")
    # the initial parameters, as init_train_state draws them from the seed
    # (without an optimizer state: two of those do not fit beside the step's)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    init = dict(tree_paths(get_family(spec).init(spec, gen, dtype=torch.float32, device="cuda")))
    final = dict(tree_paths(state.params))
    unchanged = sorted(p for p, t in final.items() if torch.equal(t, init[p].to(t.dtype)))
    del init
    torch.cuda.empty_cache()
    if "layers/sink" in unchanged or len(unchanged) > len(final) // 2:
        raise AssertionError(f"parameters that did not change in {steps} steps: {unchanged}")
    snap = os.path.join(ROOT, "build", "chip_smoke", "gpt_oss_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    save_hf_weights(state.params, spec, snap)
    t_save = time.perf_counter() - t0
    if get_spec(snap) != spec:
        raise AssertionError("the snapshot's config.json does not read back as the trained spec")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in final.items():
        if not torch.equal(loaded[path].float(), want_t.float()):
            raise AssertionError(f"snapshot: {path} differs from the state's parameters")
    shutil.rmtree(snap, ignore_errors=True)
    last = records[-1]
    tokens = n_mb * rows * seq_len
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=peak, parameters=n_params)
    log(f"gpt-oss-training: {n_params / 1e9:.3f} G parameters; {steps} steps of {n_mb} x [{rows}, "
        f"{seq_len}] tokens; last step {last['step_time_s']:.3f} s, "
        f"{numbers['tokens_per_s']:.0f} tokens/s, peak device memory {peak:.2f} GiB; "
        f"{len(final) - len(unchanged)} of {len(final)} parameter tensors changed (the sinks "
        f"among them); the snapshot ({t_save:.1f} s to write) reads back equal through get_spec "
        f"and from_hf; launches {launches}")
    del state, loaded, final
    torch.cuda.empty_cache()
    return launches, numbers


SFT_CONFIG = "configs/examples/qwen3_0.6b_sft.toml"
SFT_STEPS = 2  # 4 before the cuts


def sft_phase() -> tuple[dict, dict]:
    """SFT through its entry's config parser and ``train`` on
    ``configs/examples/qwen3_0.6b_sft.toml`` as it is (Qwen3-0.6B at full
    width and depth, ``seq_len`` 8192, 16 sequences a step in 8 micro-batches
    of 2 rows, adamw), with fake data, random init, 4 steps, validation every
    2 steps over 2 batches and a weight snapshot at step 4. Returns (launches,
    numbers of the last step)."""
    import torch

    from prime_rl_tpu_torch.configs import SFTConfig, parse_config
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.sft.train import train
    from prime_rl_tpu_torch.utils import pathing

    out = os.path.join(ROOT, "build", "chip_smoke", "sft")
    shutil.rmtree(out, ignore_errors=True)
    config = parse_config(SFTConfig, [
        "@", os.path.join(ROOT, SFT_CONFIG), "--data.type", "fake", "--model.debug.random-init",
        "--max-steps", str(SFT_STEPS), "--val.interval", "1", "--val.num-batches", "2",
        "--weight-ckpt.interval", str(SFT_STEPS), "--output-dir", out])
    if (config.model.name, config.data.seq_len) != (MODEL, 8192):
        raise AssertionError(f"{SFT_CONFIG} must train {MODEL} at seq_len 8192")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    records = result.records
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    val = [r["val_nll"] for r in rows if "val_nll" in r]
    if len(records) != SFT_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
            for r in records):
        raise AssertionError(f"sft: bad step records {records}")
    if len(val) != 2 or not all(math.isfinite(v) for v in val):
        raise AssertionError(f"sft: expected two finite val_nll records, got {val}")
    if not pathing.is_stable(pathing.weights_dir(out, SFT_STEPS)):
        raise AssertionError("sft: no weight snapshot at the last step")
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"sft: {name} was not launched on the SFT path")
    last = records[-1]
    tokens = config.data.batch_size // config.data.micro_batch_size * (
        config.data.micro_batch_size * config.data.seq_len)
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=last["device_mem_peak_gib"], mfu=last["mfu"])
    log(f"sft: {SFT_STEPS} steps in {wall:.1f} s; step times "
        f"{[round(r['step_time_s'], 3) for r in records]}; last step {tokens} tokens in "
        f"{last['step_time_s']:.3f} s -> {numbers['tokens_per_s']:.0f} tokens/s, mfu "
        f"{last['mfu']:.4f}, peak device memory {numbers['peak_gib']:.2f} GiB; losses "
        f"{[round(r['loss'], 4) for r in records]}; val_nll {val}; launches {launches}")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return launches, numbers


def replayed_fake_loader(spec, seq_len: int, rows: int, n_mb: int, seed: int = SEED):
    """The trainer's fake loader (``FakeDataLoader``) whose batches also carry
    a router replay (``routed_experts`` [N, B, L, NL, K]: distinct random
    experts on every other token, -1 on the rest, so half the tokens replay),
    drawn from a numpy generator seeded with ``seed``."""
    import numpy as np

    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader

    class Replayed(FakeDataLoader):
        def __init__(self):
            super().__init__(spec.vocab_size, seq_len, rows, n_mb, seed=seed)
            self.replay_rng = np.random.default_rng(seed)

        def next_batch(self):
            batch, counts = super().next_batch()
            shape = (*batch.input_ids.shape, spec.num_layers, spec.num_experts)
            routed = np.argsort(self.replay_rng.random(shape, np.float32), axis=-1)
            routed = routed[..., :spec.num_experts_per_tok].astype(np.int32)
            routed[:, :, 1::2] = -1
            return batch._replace(routed_experts=routed), counts

    return Replayed()


def grouped_mm_share(step, state, batch, scales) -> str:
    """One more train step under ``torch.profiler``: the device time of
    ``torch._grouped_mm`` (the experts' products) against the step's busy
    device time, or "not measured" when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, scales)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # device-side events only (kernels, copies) for the busy time: the aten
    # ops that launched them carry the same device time and would count it twice
    busy = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    grouped = sum(e.device_time_total for e in events if e.key == "aten::_grouped_mm")
    if busy <= 0:
        return "not measured (the trace holds no device time)"
    return (f"{grouped / 1e3:.1f} of {busy / 1e3:.1f} busy device ms in aten::_grouped_mm "
            f"({grouped / busy:.3f})")


def qwen3_moe_training_phase() -> tuple[dict, dict]:
    """``moe_training_phase`` on Qwen3-30B-A3B at full width (hidden 2048,
    32/4 heads of 128, all 128 experts top-8 of 768, vocab 151936), cut to 4
    layers."""
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec(QWEN3_MOE, num_layers=4)
    if (spec.family, spec.hidden_size, spec.num_heads, spec.num_kv_heads, spec.num_experts,
            spec.moe_intermediate_size, spec.vocab_size) != ("qwen3_moe", 2048, 32, 4, 128, 768,
                                                              151936):
        raise AssertionError("the trained model must be Qwen3-30B-A3B at full width")
    return moe_training_phase("qwen3-moe-training", QWEN3_MOE, spec)


def minimax_training_phase() -> tuple[dict, dict]:
    """``moe_training_phase`` on a directory whose config.json is MiniMax-M2's
    published one (``MINIMAX_M2_CONFIG``: hidden 3072, 48/8 heads of 128, a
    layer-scope qk-norm, rotary over 64, 256 experts top-8 of 1536, vocab
    200064), its depth cut to ``MINIMAX_TRAIN_LAYERS``."""
    from prime_rl_tpu_torch.models.base import get_spec

    path = config_dir("minimax_m2_training", MINIMAX_M2_CONFIG,
                      num_hidden_layers=MINIMAX_TRAIN_LAYERS)
    spec = get_spec(path)
    if (spec.family, spec.hidden_size, spec.num_heads, spec.num_experts,
            spec.moe_intermediate_size, spec.qk_norm_scope) != ("minimax_m2", 3072, 48, 256, 1536,
                                                                "layer"):
        raise AssertionError("the trained model must be MiniMax-M2 at its published widths")
    return moe_training_phase("minimax-training", path, spec)


def moe_training_phase(name: str, model: str, spec) -> tuple[dict, dict]:
    """The trainer's step (``make_train_step``, as ``train`` builds it) on
    ``spec`` (``model`` names it to the trainer's config), twice from the same
    seed: ``seq_len`` 4096, 2 micro-batches of 1 row, adamw_8bit with bf16
    masters, full remat, BIG_TRAIN_STEPS steps, each batch from ``replayed_fake_loader`` so
    that half the tokens replay a routing; bit-equal finite losses and the
    launches of K1, K2a and K2b the layers imply. Then one more step under the
    profiler for the experts' share. Returns (launches of the first run,
    numbers of its last step)."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves
    from prime_rl_tpu_torch.trainer.step import Scales, init_train_state, make_train_step

    steps, n_mb, rows, seq_len, layers = BIG_TRAIN_STEPS, 2, 1, 4096, spec.num_layers
    cfg = TrainerConfig(
        device="cuda", seed=SEED, grad_clip=1.0,
        model={"name": model, "seq_len": seq_len,
               "debug": {"random_init": True, "num_layers": layers}},
        optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"})
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    step = make_train_step(spec, cfg.model, cfg.loss, optimizer, "cuda")

    def scales(counts):
        return Scales(rl=float(max(counts["rl"], 1)), ce=float(max(counts["ce"], 1)),
                      ref_kl=float(max(counts["ref_kl"], 1)))

    runs = []
    for i in range(2):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
        loader = replayed_fake_loader(spec, seq_len, rows, n_mb)
        records = []
        t_run = time.perf_counter()
        for _ in range(steps):
            batch, counts = loader.next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, scales(counts))
            loss = float(metrics["loss"])  # reads the device: the step has finished
            torch.cuda.synchronize()
            records.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                                step_time_s=time.perf_counter() - t0))
        wall = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append((records, dict(_build.launches), peak))
        log(f"{name} run {i}: {steps} steps in {wall:.2f} s, peak device memory "
            f"{peak:.2f} GiB, losses {[r['loss'] for r in records]}, step times "
            f"{[round(r['step_time_s'], 3) for r in records]}")
        if i == 0:
            del state, metrics
            gc.collect()
            torch.cuda.empty_cache()
    (records, launches, peak), (records_again, _, _) = runs
    losses = [r["loss"] for r in records]
    if len(records) != steps or not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                        and r["grad_norm"] > 0 for r in records):
        raise AssertionError(f"{name}: bad step records {records}")
    if losses != [r["loss"] for r in records_again]:
        raise AssertionError(f"two runs from the same seed gave different losses: {losses} and "
                             f"{[r['loss'] for r in records_again]}")
    per_pass = layers * n_mb * rows * steps
    want = {"flash_attn_fwd": 2 * per_pass, "flash_attn_bwd_dq": per_pass,
            "flash_attn_bwd_dkv": per_pass}
    for kernel, n in want.items():
        if launches.get(kernel, 0) != n:
            raise AssertionError(f"{kernel}: {launches.get(kernel, 0)} launches on the {name} "
                                 f"path, expected {n}")
    batch, counts = replayed_fake_loader(spec, seq_len, rows, n_mb, seed=SEED + 1).next_batch()
    share = grouped_mm_share(step, state, batch, scales(counts))
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    last = records[-1]
    tokens = n_mb * rows * seq_len
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=peak, parameters=n_params, grouped_mm=share)
    log(f"{name}: {n_params / 1e9:.3f} G parameters; {steps} steps of {n_mb} x "
        f"[{rows}, {seq_len}] tokens, half replaying a routing; last step "
        f"{last['step_time_s']:.3f} s, {numbers['tokens_per_s']:.0f} tokens/s, peak device "
        f"memory {peak:.2f} GiB; the experts' products: {share}; launches {launches}")
    del state, step, optimizer, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def gpt_oss_reference_phase() -> None:
    """The served gpt-oss at gpt-oss-20b's widths and full vocabulary, cut to
    2 layers (one windowed, one full) with random sinks and biases: a prefill
    of 200 tokens and 4 decode steps (positions 200-203, so the 128-token
    window is in force) through K1, K3 and K4 in bf16 on the card, against a
    plain float32 forward on the CPU from the same weights
    (``served_moe_reference``)."""
    served_moe_reference(GPT_OSS, ("flash_attn_fwd/window", "decode_qkv_prep",
                                   "decode_paged_attention/window"))


def served_moe_reference(model: str, kernels: tuple[str, ...]) -> None:
    """``served_reference`` of ``model`` at its widths and full vocabulary,
    cut to 2 layers."""
    from prime_rl_tpu_torch.models.base import get_spec

    served_reference(get_spec(model, num_layers=2), model.split("/")[-1], kernels)


def served_reference(spec, name: str, kernels: tuple[str, ...], twice: bool = False,
                     prompt: int = 200, chunk: int = 0, ps: int = 64) -> dict:
    """The served forward of ``spec``, with random sinks and biases where it
    has them (the correction bias of a noaux router among them): a prefill of
    ``prompt`` tokens and 4 decode steps (at 200 tokens, positions 200-203: a
    128-token window is in force) through the kernels (``kernels`` must
    launch) in bf16 on the card, against a plain float32 forward on the CPU
    from the same weights. With ``chunk`` the prompt's last ``chunk`` tokens
    go through ``prefill_chunk`` over the pages the prefill wrote (pages of
    ``ps`` tokens); a hybrid model's chunk continues from the recurrent rows
    the prefill returned, copied to the host and back as the engine's state
    tier restores them, and its decode advances them. The CPU
    replays the card's routing and DSA selections (a near-tie in a top-k
    picks another expert or row from bf16 activations), and a run on its own
    reports the agreement. With ``twice`` the card runs again and must give
    equal bits. Returns the kernels' launches of the card's first run."""
    import torch

    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.sampler import model as smodel
    from prime_rl_tpu_torch.sampler.cache import CacheConfig, KVPool

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = perturbed(get_family(spec).init(spec, gen, dtype=torch.bfloat16, device="cuda"), gen)
    n, steps = prompt, 4
    head = n - chunk  # prefilled at once; the chunk starts on a page bound
    if head % ps if chunk else False:
        raise ValueError(f"served_reference: the chunk must start on a page bound, not {head}")
    lpad, cpad = -(-head // ps) * ps, -(-chunk // ps) * ps
    n_pages = -(-(n + steps) // ps) + 1
    rng = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(1, spec.vocab_size, (n,), generator=rng)
    nxt = torch.randint(1, spec.vocab_size, (steps,), generator=rng)
    ids = torch.zeros(1, lpad, dtype=torch.int64)
    ids[0, :head] = tokens[:head]
    chunk_ids = torch.zeros(1, cpad, dtype=torch.int64)
    chunk_ids[0, :chunk] = tokens[head:]
    table = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]  # pages of 64
    cache = CacheConfig(num_pages=n_pages + 1, page_size=ps, max_slots=1,
                        max_seq_len=n_pages * ps)
    what = ["prefill"] + (["chunked prefill"] if chunk else []) + [
        f"decode at position {n + i}" for i in range(steps)]

    def run(params, device, dtype):
        sp = smodel.unstack_params(params, spec)
        pool = KVPool(spec, cache, dtype=dtype, device=device)
        kp, vp = pool.k, pool.v
        got = smodel.prefill(sp, spec, kp, vp, ids.to(device), head,
                             table[0, :lpad // ps].to(device), compute_dtype=dtype)
        h = got[2]
        # a hybrid's recurrent rows, through the host as the state tier keeps them
        rows = [None if r is None else tuple(x.cpu().to(device) for x in r)
                for r in got[4]] if spec.gdn_pattern or spec.layer_pattern else None
        out = [smodel.logits_from_hidden(sp, spec, h[None], dtype)]
        if chunk:
            got = smodel.prefill_chunk(
                sp, spec, kp, vp, chunk_ids.to(device), head, chunk,
                table[0, head // ps:(head + cpad) // ps].to(device), table[0].to(device),
                compute_dtype=dtype, r_rows=rows)
            h, rows = got[2], got[3] if rows is not None else None
            out.append(smodel.logits_from_hidden(sp, spec, h[None], dtype))
        rec = {}
        if rows is not None:
            rec = dict(r_conv=[None if r is None else r[0][None].clone() for r in rows],
                       r_state=[None if r is None else r[1][None].clone() for r in rows])
        for i in range(steps):
            tok = (tokens[n - 1:n] if i == 0 else nxt[i - 1:i]).to(device)
            _, _, logits = smodel.decode(sp, spec, kp, vp, tok, torch.tensor(
                [n + i], dtype=torch.int32, device=device), table.to(device), compute_dtype=dtype,
                **rec)
            out.append(logits)
        return [o.float().cpu() for o in out]

    _build.reset_launches()
    on_card: list = []
    card_sel: list = []
    with recorded_routing(record=on_card), dsa_selections(record=card_sel):
        got = run(params, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for kernel in kernels:
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{name} reference: {kernel} was not launched on the card")
    if twice:
        again = run(params, torch.device("cuda"), torch.bfloat16)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} reference: two runs on the card differ")
    cpu = {k: (v.float().cpu() if not isinstance(v, dict) else
               {n_: t.float().cpu() for n_, t in v.items()}) for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    on_card = [e.cpu() for e in on_card]
    card_sel = [e.cpu() for e in card_sel]
    own: list = []
    own_sel: list = []
    with recorded_routing(record=own), dsa_selections(record=own_sel):
        want_own = run(cpu, torch.device("cpu"), torch.float32)
    agree = (sum(len(set(a) & set(b)) for x, y in zip(on_card, own)
                 for a, b in zip(x.tolist(), y.tolist()))
             / max(sum(x.numel() for x in on_card), 1))
    with recorded_routing(replay=on_card), dsa_selections(replay=card_sel):
        want = run(cpu, torch.device("cpu"), torch.float32)
    for label, g, w, wo in zip(what, got, want, want_own):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        # bf16 activations against float32: a few bf16 ulps of the largest logit
        if not (err <= 0.05 * scale and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{name} served {label} logits differ from the float32 "
                                 f"reference: max err {err:.4g} vs max |logit| {scale:.4g}")
        log(f"{name} reference {label} logits: max err {err:.4g} on the card's selections, "
            f"{float((g - wo).abs().max()):.4g} on the CPU's own (max |logit| {scale:.4g})")
    sel = ""
    if card_sel:
        shared = selection_agreement(card_sel, own_sel)
        # as the DSA train reference: near-ties of the indexer's scores
        if shared < 0.9:
            raise AssertionError(f"{name} reference: the card's DSA selections share only "
                                 f"{shared:.4f} of their rows with the float32 indexer's")
        sel = (f"; the card's DSA selections agree with float32's on {shared:.4f} of the "
               f"selected rows over {len(card_sel)} selections")
    log(f"{name} reference: the card's routing agrees with the float32 router's on {agree:.4f} "
        f"of the choices{sel}{'; two runs on the card gave equal bits' if twice else ''}; "
        f"launches {launches}")
    return launches


@contextlib.contextmanager
def dsa_selections(record: list | None = None, replay: list | None = None):
    """Within the block, every DSA selection of the sampler (the prefill's
    ``mla_topk_indices``, the chunked prefill's and the decode's
    ``_mla_topk_mask``) appends its result to ``record`` in call order, or
    returns the next of ``replay`` (moved to its inputs' device)."""
    from prime_rl_tpu_torch.ops import sparse_mla
    from prime_rl_tpu_torch.sampler import model as smodel

    todo = iter(replay or ())
    own_idx, own_mask = sparse_mla.mla_topk_indices, smodel._mla_topk_mask

    def wrap(own):
        def wrapped(x, *args, **kw):
            if replay is not None:
                return next(todo).to(x.device)
            out = own(x, *args, **kw)
            if record is not None:
                record.append(out)
            return out
        return wrapped

    sparse_mla.mla_topk_indices, smodel._mla_topk_mask = wrap(own_idx), wrap(own_mask)
    try:
        yield
    finally:
        sparse_mla.mla_topk_indices, smodel._mla_topk_mask = own_idx, own_mask


def selection_agreement(a: list, b: list) -> float:
    """The share of ``a``'s selected rows that ``b`` selects too: boolean
    masks [R, T], or index lists [..., K] (the sentinel counts as one
    member)."""
    import torch

    hit = total = 0
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            hit += int((x & y).sum())
            total += int(x.sum())
            continue
        for r, t in zip(x.reshape(-1, x.shape[-1]).tolist(), y.reshape(-1, y.shape[-1]).tolist()):
            want = set(r)
            hit += len(want & set(t))
            total += len(want)
    return hit / max(total, 1)


def gated_test_spec(name: str):
    """``name``'s debug spec (debug_afmoe, debug_laguna) at GATED_TEST_SHAPE."""
    import dataclasses

    from prime_rl_tpu_torch.models.base import get_spec

    return dataclasses.replace(get_spec(name), **GATED_TEST_SHAPE)


def gated_train_reference(spec, name: str,
                          kernels=("flash_attn_fwd/window", "flash_attn_bwd_dq/window",
                                   "flash_attn_bwd_dkv/window"),
                          bf16_floor: bool = False, seq_len: int = 512) -> dict:
    """Loss and every gradient of one micro-batch of ``seq_len`` tokens (a row of
    two sequences and padding) through ``spec``: bf16 on the card through K1,
    K2a and K2b (``kernels`` must launch: by default their window form, on
    the windowed layers) under full remat, twice for equal bits, against
    float32 on the CPU from the same weights. The CPU replays the card's
    routing (``routed_experts`` over the MoE layers), and its own routing
    reports the agreement (at least 75% of the choices a layer). A gradient
    must be within 5% of its norm; with ``bf16_floor`` the CPU also runs the
    plain versions in bf16 (no kernel), and a gradient may differ from
    float32's by up to 1.25 times that run's own error plus 1% where bf16
    alone passes the 5%: at Qwen3-Next's full widths bf16 arithmetic by
    itself is 3.5-7.7% off float32. Returns the card's launches (its first
    run)."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    n_moe = (spec.layer_pattern.count("E") if spec.layer_pattern
             else spec.num_layers - spec.first_k_dense_replace)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16),
                      perturbed(get_family(spec).init(spec, gen, device="cuda"), gen))
    batch, counts = FakeDataLoader(spec.vocab_size, seq_len // 2, 2, 1, seed=SEED).next_batch()
    batch = MicroBatchArrays(*[None if x is None else x.reshape(1, 1, seq_len) for x in batch])
    seg, second = batch.segment_ids, np.arange(seq_len) >= seq_len // 2
    batch = batch._replace(segment_ids=np.where((seg > 0) & second, seg + 10, seg).astype(np.int32))
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute, remat, routed=None, backward=True):
        params = tree_map(lambda x: x.detach().to(device=device, dtype=dtype).requires_grad_(),
                          master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        if routed is not None:
            mb = mb._replace(routed_experts=routed.to(device))
        loss_fn = make_loss_fn(spec, ModelConfig(compute_dtype=compute, ac={"mode": remat}),
                               DefaultLossConfig())
        if not backward:
            with torch.no_grad():
                return float(loss_fn(params, mb, scales)[0]), None
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        # the selection-only correction bias has no gradient
        return float(loss.detach()), {p: x.grad.float().cpu() for p, x in tree_paths(params)
                                      if x.grad is not None}

    _build.reset_launches()
    t0 = time.perf_counter()
    on_card: list = []
    with recorded_routing(on_card):
        loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16", "full")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for kernel in kernels:
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{name}-train-reference: {kernel} was not launched on the card")
    loss_again, grads_again = run(torch.device("cuda"), torch.bfloat16, "bfloat16", "full")
    if loss_again != loss_gpu or any(not torch.equal(grads_gpu[p], g)
                                     for p, g in grads_again.items()):
        raise AssertionError(f"{name}-train-reference: two runs on the card differ")
    # the forward's calls come first, one a MoE layer; the recompute's follow
    routed = torch.stack([e.cpu() for e in on_card[:n_moe]], dim=1)  # [T, NL_moe, K]
    t1 = time.perf_counter()
    own: list = []
    with recorded_routing(own):
        loss_own, _ = run(torch.device("cpu"), torch.float32, "float32", "none", backward=False)
    agree = [float(sum(len(set(a) & set(b)) for a, b in zip(x.tolist(), y.cpu().tolist()))
                   / x.numel()) for x, y in zip(routed.unbind(1), own)]
    # at random init many scores nearly tie; the served references of the MoE
    # families read 0.79-0.86 of the choices in common (logged above)
    if min(agree) < 0.75:
        raise AssertionError(f"{name}-train-reference: the card's routing agrees with the "
                             f"float32 router's on only {agree} of its choices")
    loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32", "none",
                              routed=routed.reshape(1, seq_len, n_moe, -1))

    def rel_err(got, want):
        return float((got - want).norm() / want.norm().clamp_min(1e-30))

    floor = {}
    if bf16_floor:
        _, grads_bf16 = run(torch.device("cpu"), torch.bfloat16, "bfloat16", "none",
                            routed=routed.reshape(1, seq_len, n_moe, -1))
        floor = {p: rel_err(g, grads_cpu[p]) for p, g in grads_bf16.items()}
        del grads_bf16
    t2 = time.perf_counter()
    del master
    torch.cuda.empty_cache()
    # bf16 weights, activations and gradients against float32 on the same
    # routing: a few bf16 steps on the loss, a few percent of each gradient's norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    for what, ref in (("the card's routing", loss_cpu), ("its own routing", loss_own)):
        if not abs(loss_gpu - ref) <= loss_rtol * abs(ref):
            raise AssertionError(f"{name}-train-reference loss {loss_gpu} vs float32 {ref} on "
                                 f"{what}")
    if set(grads_cpu) != set(grads_gpu):
        raise AssertionError(f"{name}-train-reference: the card's and the CPU's gradients are "
                             f"of other tensors: {sorted(set(grads_cpu) ^ set(grads_gpu))}")
    errors = {path: rel_err(grads_gpu[path], want) for path, want in grads_cpu.items()}
    limits = {p: max(grad_rtol, 1.25 * floor[p] + 0.01) if p in floor else grad_rtol
              for p in errors}
    worst = max(errors.values())
    bad = {p: (round(e, 4), round(limits[p], 4)) for p, e in errors.items()
           if not (e <= limits[p] and bool(torch.isfinite(grads_gpu[p]).all()))}
    if bad:
        raise AssertionError(f"{name}-train-reference gradients over their limits (error, "
                             f"limit): {bad}; all: "
                             f"{ {p: round(e, 4) for p, e in errors.items()} }")
    if floor:
        log(f"{name}-train-reference: the plain bf16 path's own gradient error against "
            f"float32 is {min(floor.values()):.4g}-{max(floor.values()):.4g} of the norm; the "
            f"card's {min(errors.values()):.4g}-{worst:.4g}, at most "
            f"{max(errors[p] / floor[p] for p in floor):.3g} times the bf16 path's")
    log(f"{name}-train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} on the card's "
        f"routing and {loss_own:.6g} on its own (tolerance {loss_rtol} relative); the routing "
        f"agrees on {[round(a, 4) for a in agree]} of the choices per MoE layer; worst gradient "
        f"error {worst:.4g} of its norm over {len(grads_cpu)} tensors (tolerance {grad_rtol}"
        f"{', or the bf16 floor above' if floor else ''}); "
        f"two runs on the card gave equal bits; card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s; "
        f"launches {launches}")
    return launches


def gated_reference_phase(debug_name: str) -> dict:
    """AFMoE or Laguna at GATED_TEST_SHAPE on the card: the training forward
    and backward (``gated_train_reference``) and the serving prefill and
    decode (``served_reference``, twice for equal bits), through K1, K2a, K2b
    and K4 in their window form without sinks, each against the plain float32
    path. Decode prepares q/k/v in plain PyTorch, as the JAX package does for
    gated layers: K3 must not launch. Returns {"train": launches, "serve":
    launches}."""
    spec = gated_test_spec(debug_name)
    name = spec.family
    train = gated_train_reference(spec, name)
    serve_launches = served_reference(spec, f"{name} (test shape)",
                                      ("flash_attn_fwd/window", "decode_paged_attention/window"),
                                      twice=True)
    if serve_launches.get("decode_qkv_prep", 0):
        raise AssertionError(f"{name}: K3 launched on gated layers, which the JAX package "
                             "prepares outside its kernel")
    return {"train": train, "serve": serve_launches}


def minimax_reference_phase() -> dict:
    """MiniMax-M2 at its published widths (``MINIMAX_M2_CONFIG`` through
    spec_from_hf_config, depth cut to 1 layer: 256 experts at 7.25 GB): the
    served prefill and decode through K1 and K4 on the card against float32
    on the CPU (``served_reference``); K3 must not launch (a layer-scope
    qk-norm). Returns the launches."""
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec(config_dir("minimax_m2_reference", MINIMAX_M2_CONFIG, num_hidden_layers=1))
    launches = served_reference(spec, "MiniMax-M2", ("flash_attn_fwd", "decode_paged_attention"))
    if launches.get("decode_qkv_prep", 0):
        raise AssertionError("MiniMax-M2: K3 launched on a layer-scope qk-norm, which the JAX "
                             "package prepares outside its kernel")
    return launches


def qwen3_next_spec(num_layers: int, num_experts: int | None = None):
    """Qwen3-Next's named spec cut to ``num_layers`` (its pattern cut with
    it: ``get_spec`` keeps the pattern, as the JAX package does) and
    ``num_experts`` (top-10 kept), the cuts logged."""
    import dataclasses

    from prime_rl_tpu_torch.models.base import get_spec

    full = get_spec(QWEN3_NEXT)
    cut = dataclasses.replace(full, num_layers=num_layers,
                              gdn_pattern=full.gdn_pattern[:num_layers],
                              num_experts=num_experts or full.num_experts)
    log(f"{QWEN3_NEXT}: layers cut from {full.num_layers} to {num_layers} "
        f"({cut.gdn_pattern}), experts from {full.num_experts} to {cut.num_experts} "
        f"(top-{cut.num_experts_per_tok})")
    return cut


def qwen3_next_dir(name: str, num_layers: int, num_experts: int | None = None) -> str:
    """A directory under build/chip_smoke whose config.json names
    Qwen3NextForCausalLM at the named spec's widths, cut as ``qwen3_next_spec``."""
    from prime_rl_tpu_torch.trainer.weights import spec_to_hf_config

    spec = qwen3_next_spec(num_layers, num_experts)
    return config_dir(name, spec_to_hf_config(spec))


def qwen3_next_kernel_phase() -> list[dict]:
    """The kernel rows at head dim 256, each held against its plain
    version, launched twice for equal bits and timed as the other rows are
    (the L2 flushed for K4): K1, K2a and K2b at Qwen3-Next's 16/2 heads over a
    packed row of 4096 tokens (``QWEN3_NEXT_PACKING``: three sequences); K4
    at its serving shape (64 slots of 500-1100 tokens, PS 64, 16/2 heads of
    256: the bytes a token of Qwen3-30B-A3B's 4/32 heads of 128)."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    spec = get_spec(QWEN3_NEXT)
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    found = k12_rows(gen, "hd256", 1, 4096, spec.num_heads, spec.num_kv_heads, spec.head_dim,
                     [QWEN3_NEXT_PACKING])
    for (name, line), case in zip((("flash_attn_fwd", 59), ("flash_attn_bwd_dq", 227),
                                   ("flash_attn_bwd_dkv", 282)), found):
        source = "fwd" if name == "flash_attn_fwd" else "bwd"
        rows.append(dict(name=f"{name}/hd256", route="cuda",
                         source=f"prime_rl_tpu_torch/csrc/flash_attn_{source}.cu",
                         replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                         **{k: case[k] for k in keys}, cases=[case], model=QWEN3_NEXT))
    case = k4_moe_case(spec, gen, flush)
    rows.append(dict(name="decode_paged_attention/hd256", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50",
                     **{k: case[k] for k in keys}, cases=[case], model=QWEN3_NEXT))
    del flush
    torch.cuda.empty_cache()
    return rows


def qwen3_next_reference_phase() -> dict:
    """Qwen3-Next at its widths and full vocabulary, cut to one period (LLLA,
    4 layers) and 32 experts (top-10): the loss and every gradient of one row
    of ``REF_TOKENS`` tokens through K1, K2a and K2b under full remat
    (``gated_train_reference``, each gradient also held against bf16's own
    error on the CPU), and the serving path (``served_reference``,
    pages of 8): a prefill of 200 tokens (past the GDN's chunk of 64), a
    chunked prefill of 100 more from the recurrent rows the prefill returned,
    and 4 decode steps through K1 and K4, each twice for equal bits, against
    float32 on the CPU replaying the card's routing. K3 must not launch (the
    attention layers are gated). Returns {"train": launches, "serve":
    launches}."""
    spec = qwen3_next_spec(**QWEN3_NEXT_REF_CUTS)
    k12 = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    train = gated_train_reference(spec, "qwen3-next", kernels=k12, bf16_floor=True,
                                  seq_len=REF_TOKENS)
    serve_launches = served_reference(spec, "Qwen3-Next (1 period, 32 experts)",
                                      ("flash_attn_fwd", "decode_paged_attention"), twice=True,
                                      prompt=300, chunk=100, ps=8)
    if serve_launches.get("decode_qkv_prep", 0):
        raise AssertionError("qwen3-next: K3 launched on gated attention layers, which the JAX "
                             "package prepares outside its kernel")
    return {"train": train, "serve": serve_launches}


def qwen3_next_training_phase() -> tuple[dict, dict]:
    """The trainer through its normal entry on a directory whose config.json
    names Qwen3NextForCausalLM at its widths, cut to 4 layers (LLLA) and 64
    experts (``QWEN3_NEXT_TRAIN_CUTS``), twice from the same seed
    (``hybrid_training_phase``). Returns (launches of the first run, numbers
    of its last step)."""
    model_dir = qwen3_next_dir("qwen3_next_training", **QWEN3_NEXT_TRAIN_CUTS)
    return hybrid_training_phase(
        "qwen3-next", model_dir,
        ("qwen3_next", 2048, 16, 2, 256, "LLLA", QWEN3_NEXT_TRAIN_CUTS["num_experts"], 151936),
        lambda spec: (spec.family, spec.hidden_size, spec.num_heads, spec.num_kv_heads,
                      spec.head_dim, spec.gdn_pattern, spec.num_experts, spec.vocab_size),
        lambda spec: spec.gdn_pattern.count("A"),
        lambda path: path.startswith("lin_layers/") and path.split("/")[1] in (
            "in_q", "conv_w", "A_log"))


def nemotron_training_phase() -> tuple[dict, dict]:
    """The trainer through its normal entry on a directory whose config.json
    names NemotronHForCausalLM at the 8B's widths, cut to one period of its
    pattern (``NEMOTRON_TRAIN_PATTERN``: a Mamba-2 and relu^2 pair, then an
    attention layer; 3 layers), twice from the same seed
    (``hybrid_training_phase``). Returns (launches of the first run, numbers
    of its last step)."""
    model_dir = nemotron_dir("nemotron_training", NEMOTRON_TRAIN_PATTERN)
    return hybrid_training_phase(
        "nemotron-h", model_dir,
        ("nemotron_h", 4096, 32, 8, 128, NEMOTRON_TRAIN_PATTERN, 128, 131072),
        lambda spec: (spec.family, spec.hidden_size, spec.num_heads, spec.num_kv_heads,
                      spec.head_dim, spec.layer_pattern, spec.mamba_num_heads, spec.vocab_size),
        lambda spec: spec.layer_pattern.count("*"),
        lambda path: path.startswith("mamba_layers/") and path.split("/")[1] in (
            "in_proj", "conv_w", "out_proj"))


def hybrid_training_phase(label: str, model_dir: str, expect: tuple, widths, n_attn,
                          must_change) -> tuple[dict, dict]:
    """A hybrid model's trainer through its normal entry on ``model_dir``,
    twice from the same seed: seq_len 4096, 2 micro-batches of 1 row,
    adamw_8bit with bf16 masters, full remat, BIG_TRAIN_STEPS steps. ``widths(spec)`` must
    give ``expect``. Bit-equal finite losses, changed parameters (none for
    which ``must_change(path)`` holds unchanged), the launches of K1, K2a and
    K2b the ``n_attn(spec)`` attention layers, micro-batches and remat imply,
    and a snapshot that reads back through get_spec and from_hf. Bench mode,
    as the other big trainers: only the initial weights are published.
    Returns (launches of the first run, numbers of its last step)."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    steps, n_mb, rows, seq_len = BIG_TRAIN_STEPS, 2, 1, 4096
    tag = label.replace("-", "_")

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": model_dir, "seq_len": seq_len, "debug": {"random_init": True},
                   "ac": {"mode": "full"}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
            bench={"warmup_steps": 0, "steps": steps},
        )

    spec = get_spec(model_dir)
    if widths(spec) != expect:
        raise AssertionError(f"the trained model must be {expect}, not {widths(spec)}")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"{tag}_train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(config(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append((result.records, dict(_build.launches), peak))
        state = result.state if i == len(outs) - 1 else None
        del result
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        log(f"{label}-training run {i}: {steps} steps in {wall:.2f} s (initial publish "
            f"included), peak device memory {peak:.2f} GiB, losses "
            f"{[r['loss'] for r in runs[-1][0]]}, step times "
            f"{[round(r['step_time_s'], 3) for r in runs[-1][0]]}")
    (records, launches, peak), (records_again, _, _) = runs
    losses = [r["loss"] for r in records]
    if len(records) != steps or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
            for r in records):
        raise AssertionError(f"{label}-training: bad step records {records}")
    if losses != [r["loss"] for r in records_again]:
        raise AssertionError(f"two runs from the same seed gave different losses: {losses} and "
                             f"{[r['loss'] for r in records_again]}")
    per_pass = n_attn(spec) * n_mb * rows * steps
    want = {"flash_attn_fwd": 2 * per_pass, "flash_attn_bwd_dq": per_pass,
            "flash_attn_bwd_dkv": per_pass}
    for kernel, n in want.items():
        if launches.get(kernel, 0) != n:
            raise AssertionError(f"{kernel}: {launches.get(kernel, 0)} launches on the "
                                 f"{label} training path, expected {n}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    init = dict(tree_paths(get_family(spec).init(spec, gen, dtype=torch.float32, device="cuda")))
    final = dict(tree_paths(state.params))
    unchanged = sorted(p for p, t in final.items() if torch.equal(t, init[p].to(t.dtype)))
    del init
    torch.cuda.empty_cache()
    if any(must_change(p) for p in unchanged) or len(unchanged) > len(final) // 2:
        raise AssertionError(f"parameters that did not change in {steps} steps: {unchanged}")
    snap = os.path.join(ROOT, "build", "chip_smoke", f"{tag}_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    save_hf_weights(state.params, spec, snap)
    t_save = time.perf_counter() - t0
    if get_spec(snap) != spec:
        raise AssertionError("the snapshot's config.json does not read back as the trained spec")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in final.items():
        # the zero-centred norms convert through w - 1 and back: bf16 rounds
        # the stored difference, so those compare within a bf16 step
        got_t = loaded[path].float()
        exact = torch.equal(got_t, want_t.float())
        if not exact and not torch.allclose(got_t, want_t.float(), atol=1e-2, rtol=0):
            raise AssertionError(f"snapshot: {path} differs from the state's parameters")
    shutil.rmtree(snap, ignore_errors=True)
    last = records[-1]
    tokens = n_mb * rows * seq_len
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=peak, parameters=n_params)
    log(f"{label}-training: {n_params / 1e9:.3f} G parameters; {steps} steps of {n_mb} x "
        f"[{rows}, {seq_len}] tokens; last step {last['step_time_s']:.3f} s, "
        f"{numbers['tokens_per_s']:.0f} tokens/s, peak device memory {peak:.2f} GiB; "
        f"{len(final) - len(unchanged)} of {len(final)} parameter tensors changed; the snapshot "
        f"({t_save:.1f} s to write) reads back through get_spec and from_hf; launches {launches}")
    del state, loaded, final
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def nemotron_spec(pattern: str, **moe):
    """Nemotron-H's named 8B spec with the layer pattern ``pattern`` (and
    ``moe``, the LatentMoE fields of an "E" layer), the cut logged."""
    import dataclasses

    from prime_rl_tpu_torch.models.base import get_spec

    full = get_spec(NEMOTRON)
    cut = dataclasses.replace(full, num_layers=len(pattern), layer_pattern=pattern, **moe)
    log(f"{NEMOTRON}: layers cut from {full.num_layers} to {cut.num_layers} ({pattern})"
        + (f", LatentMoE test shape {moe}" if moe else ""))
    return cut


def nemotron_dir(name: str, pattern: str, **moe) -> str:
    """A directory under build/chip_smoke whose config.json names
    NemotronHForCausalLM at the 8B's widths with ``pattern`` (``nemotron_spec``)."""
    from prime_rl_tpu_torch.trainer.weights import spec_to_hf_config

    return config_dir(name, spec_to_hf_config(nemotron_spec(pattern, **moe)))


def nemotron_kernel_phase() -> list[dict]:
    """The kernel rows at Nemotron-H-8B's attention shape (32/8 heads of 128,
    group 4, no rope), each held against its plain version, launched twice
    for equal bits and timed as the other rows are (the L2 flushed for K4):
    K1, K2a and K2b over a packed row of 4096 tokens (``QWEN3_NEXT_PACKING``:
    three sequences); K4 at its serving shape (64 slots of 500-1100 tokens,
    PS 64)."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    spec = get_spec(NEMOTRON)
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    found = k12_rows(gen, "nemotron-h", 1, 4096, spec.num_heads, spec.num_kv_heads,
                     spec.head_dim, [QWEN3_NEXT_PACKING])
    for (name, line), case in zip((("flash_attn_fwd", 59), ("flash_attn_bwd_dq", 227),
                                   ("flash_attn_bwd_dkv", 282)), found):
        source = "fwd" if name == "flash_attn_fwd" else "bwd"
        rows.append(dict(name=f"{name}/nemotron-h", route="cuda",
                         source=f"prime_rl_tpu_torch/csrc/flash_attn_{source}.cu",
                         replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                         **{k: case[k] for k in keys}, cases=[case], model=NEMOTRON))
    case = k4_moe_case(spec, gen, flush)
    rows.append(dict(name="decode_paged_attention/nemotron-h", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50",
                     **{k: case[k] for k in keys}, cases=[case], model=NEMOTRON))
    del flush
    torch.cuda.empty_cache()
    return rows


def nemotron_reference_phase() -> dict:
    """Nemotron-H at the 8B's widths and full vocabulary, one layer of each
    kind (``NEMOTRON_REF_PATTERN``, the LatentMoE layer at
    ``NEMOTRON_TEST_MOE``): the loss and every gradient of one row of ``REF_TOKENS``
    tokens through K1, K2a and K2b under full remat (``gated_train_reference``),
    and the serving path (``served_reference``, pages of 8): a prefill of 200
    tokens (past the SSD's chunk of 128), a chunked prefill of 300 more from
    the Mamba rows the prefill returned, and 4 decode steps through K1 and
    K4, each twice for equal bits, against float32 on the CPU replaying the
    card's routing. K3 must not launch (the JAX decode prepares the bare
    attention's q/k/v outside its kernel). Returns {"train": launches,
    "serve": launches}."""
    spec = nemotron_spec(NEMOTRON_REF_PATTERN, **NEMOTRON_TEST_MOE)
    k12 = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    train = gated_train_reference(spec, "nemotron-h", kernels=k12, seq_len=REF_TOKENS)
    serve_launches = served_reference(spec, "Nemotron-H (M*-E)",
                                      ("flash_attn_fwd", "decode_paged_attention"), twice=True,
                                      prompt=500, chunk=300, ps=8)
    for what, counts in (("train", train), ("serve", serve_launches)):
        if counts.get("decode_qkv_prep", 0):
            raise AssertionError(f"nemotron-h {what}: K3 launched on the bare attention layer")
    return {"train": train, "serve": serve_launches}


async def grpo_group_phase(server, port: int) -> dict:
    """A GRPO group on a hybrid server: four greedy requests that share one
    prompt of ``QWEN3_NEXT_GROUP_PROMPT`` tokens, the first sent alone and the
    other three together once it has finished and its slot is released (its
    prefill checkpointed the recurrent rows at its last full page, and the
    release gives its pages to the prefix cache). The three must hit the state
    tier, carry ``routed_experts`` where the server records the routing (a
    MoE model), and their first-token logits (recorded as
    the engine computes them) must be within 0.03 of the largest |logit| of
    the first member's, served cold: the cached members' tail prefills from
    the restored rows in another order of bf16 sums than a whole prefill."""
    import aiohttp
    import numpy as np

    from prime_rl_tpu_torch.sampler import engine as engine_mod

    engine = server.engine
    spec = engine.spec
    smodel = engine_mod.smodel
    base = f"http://127.0.0.1:{port}"
    prompt = np.random.default_rng(SEED + 15).integers(
        0, spec.vocab_size, QWEN3_NEXT_GROUP_PROMPT).tolist()
    first_logits = []
    own = smodel.logits_from_hidden

    def recording(params, spec_, hidden, *rest):
        out = own(params, spec_, hidden, *rest)
        if hidden.shape[0] == 1:  # an admission's first token (decode runs all slots)
            first_logits.append(out.float().cpu())
        return out

    restores0 = engine.stats.get("state_restores", 0)
    n_moe = spec.layer_pattern.count("E") if spec.layer_pattern else spec.num_layers
    routed_shape = (n_moe, spec.num_experts_per_tok) if engine._collect_routed else None
    smodel.logits_from_hidden = recording
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            async def generate():
                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": prompt, "sampling_params": {"max_tokens": 16,
                                                             "temperature": 0.0}})
                if r.status != 200:
                    raise AssertionError(f"group member: HTTP {r.status}: {await r.text()}")
                c = (await r.json())["choices"][0]
                if routed_shape is not None:
                    routed = np.asarray(c["routed_experts"])
                    if routed.shape != (len(c["token_ids"]), *routed_shape):
                        raise AssertionError(f"group member: routed_experts of shape "
                                             f"{routed.shape}")
                return c["token_ids"]

            t0 = time.perf_counter()
            cold_tokens = await generate()
            for _ in range(500):  # the first member's slot released, its pages cached
                if not engine.active:
                    break
                await asyncio.sleep(0.01)
            t1 = time.perf_counter()
            cached_tokens = await asyncio.gather(*(generate() for _ in range(3)))
            t2 = time.perf_counter()
    finally:
        smodel.logits_from_hidden = own
    hits = engine.stats.get("state_restores", 0) - restores0
    if hits <= 0:
        raise AssertionError("the GRPO group's members did not hit the recurrent-state tier")
    if len(first_logits) != 4:
        raise AssertionError(f"expected 4 first-token logits, recorded {len(first_logits)}")
    cold, scale = first_logits[0], float(first_logits[0].abs().max())
    errs = [float((c - cold).abs().max()) for c in first_logits[1:]]
    if not max(errs) <= 0.03 * scale:
        raise AssertionError(f"the cached members' first-token logits differ from the cold "
                             f"prefill's by {errs} (max |logit| {scale:.4g})")
    same = sum(t == cold_tokens for t in cached_tokens)
    log(f"GRPO group of 4 on a prompt of {QWEN3_NEXT_GROUP_PROMPT} tokens: {hits} state-tier "
        f"hits, first-token logits within {max(errs):.4g} of the cold member's (max |logit| "
        f"{scale:.4g}), {same} of 3 greedy completions equal to the cold one; first member "
        f"{t1 - t0:.3f} s, the other three {t2 - t1:.3f} s")
    return dict(group_state_hits=hits, group_first_logit_err=max(errs),
                group_logit_scale=scale, group_cold_s=t1 - t0, group_cached_s=t2 - t1)


def deepseek_reference_phase() -> None:
    """DeepSeek-V3's dense MLA at DEEPSEEK_V3_TEST_CONFIG: the served prefill
    and decode over the latent cache on CUDA tensors in bf16 (plain PyTorch:
    no kernel is on this path, as no Pallas kernel is in the JAX package's),
    twice for equal bits, against float32 on the CPU."""
    from prime_rl_tpu_torch.models.base import spec_from_hf_config

    spec = spec_from_hf_config(dict(DEEPSEEK_V3_TEST_CONFIG))
    if spec.family != "deepseek_v3" or spec.index_topk:
        raise AssertionError("the DeepSeek-V3 reference must run dense MLA")
    served_reference(spec, "DeepSeek-V3 (test shape)", (), twice=True)


def dsa_serving_reference_phase() -> dict:
    """GLM-5's served forward at its widths, cut as the DSA train reference
    cuts it (1 dense + 1 MoE layer of 8 experts, top-k 256, so that a prompt
    of 460 tokens selects a part of its history): a prefill of 384 tokens
    (K5a over the sampler's own indexer selection, the indexer keys paged
    into the V pool), a chunked prefill of the last 76 (a page bound inside,
    each query masked to its top-k over the paged indexer keys) and 4 decode
    steps (the exact top-k over the gathered history), in bf16 on the card,
    twice for equal bits, against float32 on the CPU on the card's routing
    and selections. Returns the launches."""
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec(glm5_model_dir("glm5_serving_reference", num_hidden_layers=2,
                                   first_k_dense_replace=1, n_routed_experts=8, index_topk=256))
    return served_reference(spec, "GLM-5 DSA", ("sparse_mla_fwd",), twice=True, prompt=460,
                            chunk=76)


def reference_phase(engine) -> None:
    """The served weights' prefill and one decode step through the kernels
    (bf16, CUDA) against the plain float32 path on the CPU."""
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec = engine.spec
    dev = engine.device
    ps, lpad, n = 64, 64, 37
    rng = torch.Generator().manual_seed(SEED)
    ids = torch.zeros(1, lpad, dtype=torch.int64)
    ids[0, :n] = torch.randint(1, spec.vocab_size, (n,), generator=rng)
    table = torch.zeros(1, 2, dtype=torch.int32)
    table[0] = torch.tensor([1, 2])
    shape = (spec.num_kv_heads, 3, ps, spec.head_dim)

    def run(params, device, dtype):
        kp = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(spec.num_layers)]
        vp = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(spec.num_layers)]
        _, _, h, _ = smodel.prefill(params, spec, kp, vp, ids.to(device), n,
                                    table[0, :1].to(device), compute_dtype=dtype)
        first = smodel.logits_from_hidden(params, spec, h[None], dtype)
        tok = torch.tensor([int(ids[0, n - 1])], device=device)
        _, _, second = smodel.decode(params, spec, kp, vp, tok, torch.tensor(
            [n], dtype=torch.int32, device=device), table.to(device), compute_dtype=dtype)
        return first.float().cpu(), second.float().cpu()

    got = run(engine.params, dev, torch.bfloat16)
    cpu_params = {k: v for k, v in engine.params.items() if k != "layers"}
    cpu_params = {k: v.float().cpu() for k, v in cpu_params.items()}
    cpu_params["layers"] = [{k: v.float().cpu() for k, v in lp.items()}
                            for lp in engine.params["layers"]]
    want = run(cpu_params, torch.device("cpu"), torch.float32)
    for name, g, w in zip(("prefill", "decode"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        # bf16 activations through 28 layers against float32: the logits may
        # drift by a few bf16 ulps of the largest logit
        if not (err <= 0.05 * scale and bool(torch.isfinite(g).all())):
            raise AssertionError(f"served {name} logits differ from the float32 reference: "
                                 f"max err {err:.4g} vs max |logit| {scale:.4g}")
        log(f"reference {name} logits: max err {err:.4g} (max |logit| {scale:.4g})")


async def serving_phase(server, port: int, model: str, collect: bool,
                        long_prompt: int = 0) -> dict:
    import aiohttp
    import numpy as np

    base = f"http://127.0.0.1:{port}"
    spec = server.engine.spec
    # router replay: [n_gen, NL_moe, K] with ids in [0, E), the last row -1
    routed_shape = (spec.num_layers - spec.first_k_dense_replace, spec.num_experts_per_tok)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, spec.vocab_size, 128).tolist()
    lengths = [20, 45, 64, 90, 200, 300, 400, 512, 640, 800, 1000, 1200, 1400, 1500]
    prompts = [rng.integers(0, spec.vocab_size, n).tolist() for n in lengths]
    prompts += [prefix + rng.integers(0, spec.vocab_size, n).tolist() for n in (40, 70)]
    if long_prompt:
        prompts.append(rng.integers(0, spec.vocab_size, long_prompt).tolist())
    samplings = [dict(temperature=1.0), dict(temperature=0.8, top_p=0.9),
                 dict(temperature=1.0, top_k=20), dict(temperature=0.0)]
    max_tokens = 64
    stop_ids = {spec.eos_token_id}

    def check(result: dict, what: str) -> int:
        c = result["choices"][0]
        toks, lps = c["token_ids"], c["logprobs"]
        if c["finish_reason"] == "length":
            ok = len(toks) == max_tokens
        else:
            ok = c["finish_reason"] == "stop" and toks and toks[-1] in stop_ids
        if not ok or len(lps) != len(toks) or not np.all(np.isfinite(lps)):
            raise AssertionError(f"{what}: bad result {c['finish_reason']} {len(toks)} tokens")
        if collect:
            r = np.asarray(c["routed_experts"])
            if (r.shape != (len(toks), *routed_shape) or not (r[-1] == -1).all()
                    or not ((r[:-1] >= 0) & (r[:-1] < spec.num_experts)).all()):
                raise AssertionError(f"{what}: routed_experts of shape {r.shape}, expected "
                                     f"{(len(toks), *routed_shape)} with ids in "
                                     f"[0, {spec.num_experts}) and a last row of -1")
        return len(toks)

    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
        async def generate(prompt, sampling):
            t0 = time.perf_counter()
            r = await http.post(f"{base}/inference/v1/generate", json={
                "token_ids": prompt, "sampling_params": {"max_tokens": max_tokens, **sampling}})
            if r.status != 200:
                raise AssertionError(f"generate: HTTP {r.status}: {await r.text()}")
            return await r.json(), time.perf_counter() - t0

        t0 = time.perf_counter()
        results = await asyncio.gather(*(generate(p, samplings[i % len(samplings)])
                                         for i, p in enumerate(prompts)))
        wall = time.perf_counter() - t0
        n_tokens = sum(check(r, f"generate #{i}") for i, (r, _) in enumerate(results))
        out["generate_requests"] = len(prompts)
        out["generate_tokens"] = n_tokens
        out["generate_wall_s"] = wall
        out["generate_tokens_per_s"] = n_tokens / wall
        out["request_latency_s_mean"] = sum(t for _, t in results) / len(results)
        log(f"serving: {len(prompts)} concurrent generate requests, {n_tokens} tokens in "
            f"{wall:.3f} s -> {n_tokens / wall:.1f} tokens/s")

        r = await http.post(f"{base}/v1/completions",
                            json={"prompt": "The quick brown fox", "max_tokens": 16})
        body = await r.json()
        if r.status != 200 or body["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"completions: HTTP {r.status}: {body}")

        t0 = time.perf_counter()
        ttft = None
        async with http.post(f"{base}/v1/chat/completions", json={
                "model": model, "messages": [{"role": "user", "content": "hi there"}],
                "max_tokens": 32, "temperature": 0.7, "stream": True}) as r:
            if r.status != 200:
                raise AssertionError(f"chat stream: HTTP {r.status}")
            events = []
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                events.append(line[6:])
                if ttft is None and '"content"' in line:
                    ttft = time.perf_counter() - t0
        if events[-1] != "[DONE]" or json.loads(events[-2])["choices"][0]["finish_reason"] not in (
                "stop", "length"):
            raise AssertionError("chat stream: missing [DONE] or finish reason")
        out["chat_stream_ttft_s"] = ttft
        log(f"serving: streaming chat, time to first token {ttft}")

        # greedy determinism: the same prompt twice, concurrently
        greedy = dict(temperature=0.0)
        a, b = await asyncio.gather(generate(prompts[3], greedy), generate(prompts[3], greedy))
        for r in (a[0], b[0]):
            check(r, "greedy")
        if a[0]["choices"][0]["token_ids"] != b[0]["choices"][0]["token_ids"]:
            raise AssertionError("greedy requests for the same prompt differ")
        # a prompt sharing the 128-token prefix with finished requests: the
        # prefix cache serves its first pages, the rest prefills in chunks
        cached0 = server.engine.stats["prefill_tokens_cached"]
        r, _ = await generate(prefix + [5, 6, 7], dict(temperature=0.0))
        check(r, "prefix hit")
        if server.engine.stats["prefill_tokens_cached"] <= cached0:
            raise AssertionError("the shared prefix was not served from the prefix cache")
    return out


def serve(model: str, want_layers: int, want_vocab: int, reference=None, collect: bool = False,
          num_layers: int | None = None, long_prompt: int = 0, extra=None,
          state_cache_mb: int | None = None, lora: dict | None = None):
    """Build the inference server for ``model`` (all its layers, or
    ``num_layers``; random weights from the seed, or with ``lora`` (the
    server's ``inference.lora`` section, its adapter bank) the weights of the
    snapshot directory ``model``; with ``collect`` recording
    the routing of every completion; a hybrid's state tier of
    ``state_cache_mb`` set on its engine's cache config, which the server's
    config does not expose, or the default), run ``reference`` on its engine,
    warm it up and drive it over HTTP with the launch counts reset just before
    (with ``long_prompt`` one more request of that many prompt tokens; then
    ``extra(server, port)``, whose numbers join the stats). Returns (stats,
    launches); the server is stopped and freed."""
    import dataclasses

    import aiohttp.web_app
    import torch

    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server
    from prime_rl_tpu_torch.ops import _build

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    config = InferenceConfig(
        device="cuda", seed=SEED, max_model_len=4096,
        output_dir=os.path.join(ROOT, "build", "chip_smoke"),
        model={"name": model, "debug": {"random_init": lora is None, "num_layers": num_layers}},
        tokenizer={"name": "byte"}, scheduler={"max_batch_size": 64},
        collect_routed_experts=collect, lora=lora,
        # the LoRA phase's reference engines and timing need memory beside the pool
        **({"kv": {"num_pages": 8192}} if lora is not None else {}),
    )
    t0 = time.perf_counter()
    server = build_server(config)
    engine = server.engine
    log(f"{model} server built in {time.perf_counter() - t0:.2f} s: "
        f"{engine.spec.num_layers} layers, vocab {engine.spec.vocab_size}, "
        f"{engine.config.num_pages} KV pages of {engine.config.page_size}, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if engine.spec.num_layers != want_layers or engine.spec.vocab_size != want_vocab:
        raise AssertionError(f"the served model must be {model} at full width and depth")
    if state_cache_mb is not None:
        engine.config = dataclasses.replace(engine.config, state_cache_mb=state_cache_mb)
    if reference is not None:
        reference(engine)
    engine.warmup(4)

    async def drive():
        runner = await server.start_async("127.0.0.1", port)
        try:
            _build.reset_launches()
            stats = await serving_phase(server, port, model, collect, long_prompt)
            if extra is not None:
                stats.update(await extra(server, port))
            launches = dict(_build.launches)
        finally:
            await server.stop_async(runner)
        return stats, launches

    out = asyncio.run(drive())
    # aiohttp memoises its handler chains in module-level caches keyed by the
    # bound handlers, which would keep the server, and the engine's weights and
    # KV pool, alive beside the next model
    for fn in vars(aiohttp.web_app).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    alive = weakref.ref(engine)
    del server, engine
    gc.collect()
    if alive() is not None:
        raise AssertionError(f"the {model} engine outlived its server: its memory is not freed")
    torch.cuda.empty_cache()
    return out


LOOP_STEPS = 3  # 6 before the cuts; 3 is the least that serves a published version
LOOP_TIMEOUT_S = 600
LOOP_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "decode_qkv_prep",
                "decode_paged_attention")


def _jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def loop_phase(card: str) -> dict:
    """The RL loop of ``configs/bench/northstar_rl_tpu.toml`` through the
    launcher, colocated, ``LOOP_STEPS`` steps, in a process group of its own (killed
    whole at the time limit). Checks what the header says, prints the loop's
    figures and returns the colocated process's kernel launches."""
    return run_loop(card, "loop", [os.path.join("configs", "bench", "northstar_rl_tpu.toml")])[0]


def run_loop(card: str, label: str, tomls: list[str], flags: tuple = (),
             kernels: tuple[str, ...] = LOOP_KERNELS) -> tuple[dict, str]:
    """``loop_phase``'s run and checks for the launcher on ``tomls`` (merged
    left to right) and ``flags``, under ``build/chip_smoke/<label>``; every
    kernel of ``kernels`` must launch in the colocated process.
    Returns (the colocated process's kernel launches, its log)."""
    import re
    import signal

    import numpy as np

    out = os.path.join(ROOT, "build", "chip_smoke", label)
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "prime_rl_tpu_torch.entrypoints.rl",
           *("@" + os.path.join(ROOT, t) for t in tomls), "--colocated",
           "--trainer.max-steps", str(LOOP_STEPS), "--orchestrator.max-steps", str(LOOP_STEPS),
           *flags, "--output-dir", out]
    log(f"{label}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        stdout, _ = proc.communicate(timeout=LOOP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and every child it started
        proc.communicate()
        raise AssertionError(f"{label}: the launcher did not finish within {LOOP_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    logs = os.path.join(out, "logs")
    texts = {}
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
        if name.endswith(".out"):
            with open(os.path.join(logs, name)) as fh:
                texts[name] = fh.read()
    if proc.returncode != 0:
        tails = "\n".join(f"--- {n}\n{s[-3000:]}" for n, s in texts.items())
        raise AssertionError(f"{label}: the launcher exited {proc.returncode}\n{stdout}\n{tails}")
    for name, text in texts.items():
        if "Traceback" in text:
            raise AssertionError(f"{label}: a traceback in {name}:\n{text[-3000:]}")
    colocated = texts.get("colocated.out", "")
    trows = _jsonl(os.path.join(out, "trainer.jsonl"))
    if [r["step"] for r in trows] != list(range(1, LOOP_STEPS + 1)):
        raise AssertionError(f"{label}: trainer.jsonl holds steps {[r['step'] for r in trows]}")
    if not all(math.isfinite(r["loss"]) for r in trows):
        raise AssertionError(f"{label}: non-finite loss {[r['loss'] for r in trows]}")
    # the launcher's carve-out skips the last target_lag + 1 = 2 publishes
    served = [int(v) for v in re.findall(r"the engine serves v(\d+)", colocated)]
    if served != list(range(LOOP_STEPS - 1)):
        raise AssertionError(f"{label}: the sampler served versions {served}, not v0..v"
                             f"{LOOP_STEPS - 2} in order")
    orows = [r for r in _jsonl(os.path.join(out, "orchestrator.jsonl")) if "reward_mean" in r]
    if [r["step"] for r in orows] != list(range(LOOP_STEPS)):
        raise AssertionError(f"{label}: orchestrator.jsonl shipped steps "
                             f"{[r['step'] for r in orows]}")
    kls = [r["mismatch_kl"] for r in trows]
    kl = float(np.mean(kls))
    if not (math.isfinite(kl) and kl < 0.5):
        raise AssertionError(f"{label}: mean mismatch_kl {kl} (per step {kls}) not below 0.5")
    found = re.findall(r"colocated kernel launches: (\{.*\})", colocated)
    if not found:
        raise AssertionError(f"{label}: the colocated process did not log its kernel launches")
    launches = json.loads(found[-1])
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched in the colocated process: "
                             f"{launches}")

    # the loop's figures, this single run; steady state = steps 2..6
    steady = trows[1:]
    med = lambda key: float(np.median([r[key] for r in steady]))  # noqa: E731
    step_wall = float(np.median(np.diff([r["ts"] for r in trows])))
    gen = [r.get("inference/mixed/generation_tokens_total/sum") for r in orows]
    span = orows[-1]["ts"] - orows[0]["ts"]
    rollout_tps = ((gen[-1] - gen[0]) / span) if None not in (gen[0], gen[-1]) and span > 0 \
        else float("nan")
    env_sps = sum(r["num_rollouts"] for r in orows[1:]) / span if span > 0 else float("nan")
    stats = {
        "wall_s": round(wall, 1), "steps": LOOP_STEPS,
        "trainer_tokens_per_s": med("tokens_per_sec"), "train_step_s": med("step_time_s"),
        "wait_for_batch_s": med("wait_for_batch_s"), "step_wall_s": step_wall,
        "publish_s": float(np.median([r["publish_s"] for r in steady if r["publish_s"] > 0]
                                     or [float("nan")])),
        "rollout_tokens_per_s": rollout_tps, "env_steps_per_s": env_sps,
        "rl_tokens_per_step": float(np.median([r["rl_tokens"] for r in trows])),
        "mismatch_kl_mean": kl, "reward_mean": [r["reward_mean"] for r in orows],
    }
    log(f"{label} on {card} (one run, medians of steps 2-{LOOP_STEPS}): trainer "
        f"{stats['trainer_tokens_per_s']:.1f} tokens/s, train step {stats['train_step_s']:.3f} s, "
        f"wait for a batch {stats['wait_for_batch_s']:.3f} s, publish_s (in-process swap) "
        f"{stats['publish_s']:.4f} s, wall time a step {step_wall:.3f} s; rollouts "
        f"{rollout_tps:.1f} tokens/s, env steps {env_sps:.2f}/s; mean mismatch_kl {kl:.4g}; "
        f"the launcher took {wall:.1f} s")
    for line in re.findall(r"colocated (?:swap|engine host seconds): .*", colocated):
        log(f"{label}: {line}")
    log(f"{label} stats: {json.dumps(stats)}")
    log(f"launches on the {label} colocated process: {launches}")
    return launches, colocated


LORA_CONFIG = os.path.join("configs", "examples", "qwen3_0.6b_rl_lora.toml")
LORA_TRAIN_STEPS = 4  # alternating between two tenants
LORA_ROW = 4096  # tokens a packed fake row
LORA_ROWS, LORA_MB = 2, 2  # rows a micro-batch, micro-batches a step
LORA_LR = 2e-3  # large for LoRA, so that 2 steps give each tenant an adapter that shows
LORA_SLOTS = 64  # the decode step timed with the bank on and off
# the Qwen3 serving reference's bound (reference_phase): bf16 through 28
# layers against float32, logits within this share of the largest |logit|
LOGIT_BOUND = 0.05


def toml_text(tree: dict, prefix: str = "") -> str:
    """``tree`` (strings, numbers, booleans, lists of them, tables, arrays of
    tables) as TOML text."""
    def value(v) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, list):
            return "[" + ", ".join(value(x) for x in v) + "]"
        return repr(v)

    lines, tables = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            tables.append((k, v, False))
        elif isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
            tables.append((k, v, True))
        else:
            lines.append(f"{k} = {value(v)}")
    text = "\n".join(lines) + ("\n" if lines else "")
    for k, v, many in tables:
        name = f"{prefix}{k}"
        for item in (v if many else [v]):
            text += f"\n[{'[' if many else ''}{name}{']' if many else ''}]\n"
            text += toml_text(item, name + ".")
    return text


def lora_config(spec):
    """The LoRA section of ``LORA_CONFIG`` (rank 16, alpha 32, the default
    targets: all seven projections), held to that."""
    import tomllib

    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import resolve_targets

    with open(os.path.join(ROOT, LORA_CONFIG), "rb") as fh:
        cfg = LoRAConfig(**tomllib.load(fh)["trainer"]["model"]["lora"])
    targets = resolve_targets(cfg, spec)
    if (cfg.rank, cfg.alpha, len(targets)) != (16, 32.0, 7):
        raise AssertionError(f"{LORA_CONFIG}: expected rank 16, alpha 32 and all seven targets, "
                             f"got {cfg.rank}, {cfg.alpha}, {targets}")
    return cfg


@contextlib.contextmanager
def uncounted():
    """Launches made in the block (a check's references, a timing) are taken
    back out of the kernels' counts: the counts keep the path's own."""
    from prime_rl_tpu_torch.ops import _build

    saved = dict(_build.launches)
    try:
        yield
    finally:
        _build.launches.clear()
        _build.launches.update(saved)


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def lora_training_phase(full_numbers: dict) -> tuple[dict, dict, dict]:
    """Two tenants of a ``MultiRunManager`` (at most one live: every switch
    evicts one to disk and reloads the other) on Qwen3-0.6B at full width and
    depth with ``LORA_CONFIG``'s adapter, ``LORA_TRAIN_STEPS`` steps
    alternating between them on packed fake rows of ``LORA_ROW`` tokens.
    Checks: the frozen base's bits unchanged (``params_fingerprint``), each
    reload bit-equal to the state evicted, the two adapters different, K1,
    K2a and K2b launched. Writes the base as an HF snapshot and each tenant's
    PEFT adapter (the serving phase's inputs). Returns (launches, numbers,
    {"base": dir, "run_0": adapter dir, "run_1": ...})."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.lora import save_adapter
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import make_optimizer
    from prime_rl_tpu_torch.trainer.runs import MultiRunManager
    from prime_rl_tpu_torch.trainer.step import (
        Scales,
        init_base_params,
        make_train_step,
        params_fingerprint,
    )
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    spec = get_spec(MODEL)
    if spec.num_layers != 28 or spec.vocab_size != 151936 or spec.hidden_size != 1024:
        raise AssertionError("the LoRA trainer's model must be Qwen3-0.6B at full width and depth")
    lcfg = lora_config(spec)
    cfg = TrainerConfig(device="cuda", seed=SEED, grad_clip=1.0,
                        model={"name": MODEL, "lora": lcfg.model_dump()},
                        optimizer={"type": "adamw", "lr": LORA_LR})
    out = os.path.join(ROOT, "build", "chip_smoke", "lora_train")
    shutil.rmtree(out, ignore_errors=True)
    base = init_base_params(spec, "cuda", SEED)
    before = params_fingerprint(base)
    base_dir = os.path.join(out, "base")
    save_hf_weights(base, spec, base_dir)
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    step = make_train_step(spec, cfg.model, cfg.loss, optimizer, "cuda", base_params=base)
    mgr = MultiRunManager(out, spec, lcfg, "cuda", optimizer, max_runs=1, seed=SEED)
    loader = packed_fake_loader(4)(spec.vocab_size, LORA_ROW, LORA_ROWS, LORA_MB, seed=SEED)
    tokens = LORA_ROW * LORA_ROWS * LORA_MB
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    kept, times, losses, reloads = {}, [], [], 0
    for i in range(LORA_TRAIN_STEPS):
        rid = f"run_{i % 2}"
        run = mgr.get_or_create(rid)  # evicts the other tenant (max_runs 1)
        if rid in kept:
            got = _tensors(tuple(run.state))
            if len(got) != len(kept[rid]) or not all(torch.equal(a, b)
                                                      for a, b in zip(got, kept[rid])):
                raise AssertionError(f"lora-training: {rid} reloaded from disk differs from the "
                                     "state evicted")
            reloads += 1
        batch, counts = loader.next_batch()
        scales = Scales(float(max(counts["rl"], 1)), float(max(counts["ce"], 1)),
                        float(max(counts["ref_kl"], 1)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.state, metrics = step(run.state, batch, scales)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run.progress.step += 1
        kept[rid] = [t.clone() for t in _tensors(tuple(run.state))]
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if reloads != LORA_TRAIN_STEPS - 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lora-training: {reloads} reloads, losses {losses}")
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"lora-training: {name} was not launched: {launches}")
    after = params_fingerprint(base)
    if after != before:
        raise AssertionError(f"lora-training: the frozen base changed ({before} -> {after})")
    paths = {"base": base_dir}
    adapters = {}
    for rid in ("run_0", "run_1"):
        run = mgr.get_or_create(rid)
        adapters[rid] = {k: v.clone() for k, v in run.state.params["layers"].items()}
        paths[rid] = os.path.join(out, "runs", rid, "adapter")
        save_adapter(run.state.params, spec, paths[rid])
    if any(float(a.abs().max()) == 0 for k, a in adapters["run_0"].items() if k.endswith("_b")):
        raise AssertionError("lora-training: a tenant's B is still zero after training")
    diff = max(float((adapters["run_0"][k] - adapters["run_1"][k]).abs().max())
               for k in adapters["run_0"])
    if diff == 0:
        raise AssertionError("lora-training: the two tenants' adapters are equal")
    steady = sorted(times[2:]) or times
    step_s = steady[len(steady) // 2]
    numbers = {"step_s": step_s, "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
               "peak_gib": peak, "losses": losses, "step_times_s": times,
               "adapter_params": sum(v.numel() for v in adapters["run_0"].values()),
               "tenant_diff_max": diff, "base_fingerprint": before}
    log(f"lora-training: {LORA_TRAIN_STEPS} steps over 2 tenants ({reloads} reloads bit-equal), "
        f"{tokens} tokens a step (rows of {LORA_ROW}); step {step_s:.3f} s, "
        f"{tokens / step_s:.0f} tokens/s, peak {peak:.2f} GiB; the full-parameter training "
        f"phase: step {full_numbers.get('step_time_s', float('nan')):.3f} s, "
        f"{full_numbers.get('tokens_per_sec', float('nan')):.0f} tokens/s, peak "
        f"{full_numbers.get('peak_gib', float('nan')):.2f} GiB; the base's bits unchanged "
        f"({before}); adapters of {numbers['adapter_params']} parameters, the tenants differ by "
        f"up to {diff:.4g}; launches {launches}")
    del step, mgr, kept, base
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers, paths


def _merged_params(base_dir: str, adapter_dir: str, lcfg, spec):
    import torch

    from prime_rl_tpu_torch.models.lora import load_adapter_file, lora_from_jax, merge_lora
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights

    base = load_hf_weights(base_dir, spec, dtype=torch.bfloat16, device="cuda")
    if adapter_dir is None:
        return base
    lora = lora_from_jax({"layers": load_adapter_file(adapter_dir, spec)}, device="cuda")
    return merge_lora(base, lora, lcfg, spec=spec)


def lora_serving_extra(paths: dict, lcfg):
    """``serve``'s extra step of the LoRA server: load the two tenants'
    adapters over ``/load_lora_adapter``; 16 concurrent greedy requests split
    over the base and the two adapters; each adapter's (and the base's)
    first-token logits against an engine (no bank) on that adapter's merged
    weights within ``LOGIT_BOUND`` of the largest |logit|, and the first
    greedy token equal to the merged engine's where its top-2 margin exceeds
    twice the logit error (the agreeing prefix of the 16 greedy tokens is
    reported); ``/unload_lora_adapter``, after which a request naming the
    adapter gets the error; the decode step at ``LORA_SLOTS`` slots with the
    bank on and off."""
    async def extra(server, port: int) -> dict:
        import aiohttp
        import numpy as np
        import torch

        from prime_rl_tpu_torch.sampler import model as smodel
        from prime_rl_tpu_torch.sampler.cache import CacheConfig
        from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams

        engine, spec = server.engine, server.engine.spec
        base = f"http://127.0.0.1:{port}"
        out = {}
        rng = np.random.default_rng(SEED + 17)
        prompts = [rng.integers(0, spec.vocab_size, int(n)).tolist()
                   for n in rng.integers(30, 400, 16)]
        names = [(None, "run_0", "run_1")[i % 3] for i in range(16)]
        n_tok = 16
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            for rid in ("run_0", "run_1"):
                r = await http.post(f"{base}/load_lora_adapter",
                                    json={"lora_name": rid, "lora_path": paths[rid]})
                if r.status != 200:
                    raise AssertionError(f"load_lora_adapter {rid}: HTTP {r.status}: "
                                         f"{await r.text()}")

            async def gen(prompt, name):
                body = {"token_ids": prompt, "sampling_params": {
                    "max_tokens": n_tok, "temperature": 0.0, "ignore_eos": True}}
                if name:
                    body["lora_name"] = name
                r = await http.post(f"{base}/inference/v1/generate", json=body)
                return r.status, await r.json()

            t0 = time.perf_counter()
            results = await asyncio.gather(*(gen(p, n) for p, n in zip(prompts, names)))
            out["lora_mixed_wall_s"] = time.perf_counter() - t0
            for (status, body), name in zip(results, names):
                if status != 200:
                    raise AssertionError(f"lora request ({name}): HTTP {status}: {body}")
            tokens = [body["choices"][0]["token_ids"] for _, body in results]

            # the engines on the merged weights (and on the base, bank-less),
            # their launches and the checks' out of the path's counts
            cache = CacheConfig(num_pages=1024, page_size=16, max_slots=16, max_seq_len=1024)
            report = {}
            with uncounted():
                for name in (None, "run_0", "run_1"):
                    merged = _merged_params(paths["base"], paths.get(name), lcfg, spec)
                    ref = Engine(merged, spec, cache, device="cuda", compute_dtype=torch.bfloat16)
                    idx = [i for i, n in enumerate(names) if n == name]
                    want = ref.generate([prompts[i] for i in idx],
                                        SamplingParams(max_tokens=n_tok, temperature=0.0,
                                                       ignore_eos=True))
                    row = engine.adapters.get(name, 0) if name else 0
                    errs, agree = [], []
                    for i, w in zip(idx, want):
                        got_l = _first_logits(engine, prompts[i], row)
                        want_l = _first_logits(ref, prompts[i], None)
                        err = float((got_l - want_l).abs().max())
                        scale = float(want_l.abs().max())
                        if not (err <= LOGIT_BOUND * scale and bool(torch.isfinite(got_l).all())):
                            raise AssertionError(f"lora-serving ({name}): first-token logits differ "
                                                 f"from the merged engine's: {err:.4g} vs max "
                                                 f"|logit| {scale:.4g}")
                        top2 = torch.topk(want_l, 2).values
                        if (float(top2[0] - top2[1]) > 2 * err
                                and tokens[i][0] != w.token_ids[0]):
                            raise AssertionError(f"lora-serving ({name}): first greedy token "
                                                 f"{tokens[i][0]} != the merged engine's "
                                                 f"{w.token_ids[0]} at a margin above 2 x {err:.3g}")
                        errs.append(err / scale)
                        n = 0
                        while n < n_tok and tokens[i][n] == w.token_ids[n]:
                            n += 1
                        agree.append(n)
                    report[name or "base"] = {"first_logit_err_rel_max": max(errs),
                                              "greedy_prefix_agreed": agree}
                    del ref, merged
                    gc.collect()
                    torch.cuda.empty_cache()
            out["lora_vs_merged"] = report
            log(f"lora-serving: 16 mixed greedy requests against engines on the merged weights "
                f"(bound {LOGIT_BOUND} of max |logit|): {json.dumps(report)}")
            # the adapters change the function
            with uncounted():
                d = _first_logits(engine, prompts[1], engine.adapters["run_0"]) - _first_logits(
                    engine, prompts[1], 0)
            out["lora_first_logit_shift_max"] = float(d.abs().max())

            r = await http.post(f"{base}/unload_lora_adapter", json={"lora_name": "run_1"})
            if (await r.json()).get("status") != "ok":
                raise AssertionError("unload_lora_adapter run_1 failed")
            status, body = await gen(prompts[0], "run_1")
            if status == 200 or "unknown LoRA adapter" not in json.dumps(body):
                raise AssertionError(f"a request naming the unloaded adapter got {status}: {body}")
        with uncounted():
            out.update(lora_decode_timing(engine))
        return out

    return extra


def _first_logits(engine, prompt: list, row):
    """The first sampled position's logits [V] f32 of ``prompt`` on
    ``engine``'s weights (through its bank row ``row``, or none), over pools
    of its own."""
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec, dev = engine.spec, engine.device
    ps = 16
    lpad = -(-len(prompt) // 64) * 64
    shape = (spec.num_kv_heads, lpad // ps + 1, ps, spec.head_dim)
    kp = [torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(spec.num_layers)]
    vp = [torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(spec.num_layers)]
    ids = torch.zeros(1, lpad, dtype=torch.int64, device=dev)
    ids[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    idx = None if row is None else torch.tensor(row, device=dev)
    with torch.no_grad():
        _, _, h, _ = smodel.prefill(engine.params, spec, kp, vp, ids, len(prompt),
                                    torch.arange(1, lpad // ps + 1, device=dev),
                                    compute_dtype=torch.bfloat16, adapter_idx=idx)
        return smodel.logits_from_hidden(engine.params, spec, h[None],
                                         torch.bfloat16)[0].float()


def lora_decode_timing(engine) -> dict:
    """The decode step at ``LORA_SLOTS`` slots of 512 cached tokens on the
    LoRA server's weights: with the bank (the slots' rows cycling over the
    base and the loaded adapters; no K3) and without it (the same layers
    without ``lora``: K3 prepares q/k/v), CUDA events, in one call."""
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec, dev = engine.spec, engine.device
    s, ps, n = LORA_SLOTS, 16, 512
    p = n // ps + 1
    shape = (spec.num_kv_heads, s * p + 1, ps, spec.head_dim)
    kp = [torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(spec.num_layers)]
    vp = [torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(spec.num_layers)]
    table = (1 + torch.arange(s * p, device=dev, dtype=torch.int32)).reshape(s, p)
    lengths = torch.full((s,), n, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, spec.vocab_size, (s,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
    rows = torch.tensor([0, *sorted(engine.adapters.values())], device=dev)
    adapter_idx = rows[torch.arange(s, device=dev) % rows.numel()]
    bankless = dict(engine.params)
    bankless["layers"] = [{k: v for k, v in lp.items() if k != "lora"}
                          for lp in engine.params["layers"]]

    def step(params, idx):
        with torch.no_grad():
            smodel.decode(params, spec, kp, vp, tokens, lengths, table,
                          compute_dtype=torch.bfloat16, adapter_idx=idx)

    on = time_ms(lambda: step(engine.params, adapter_idx), iters=10)
    off = time_ms(lambda: step(bankless, None), iters=10)
    log(f"lora-serving: the decode step at {s} slots of {n} tokens: {on:.3f} ms with the bank "
        f"on ({rows.numel()} rows: the base and {rows.numel() - 1} adapters), {off:.3f} ms with "
        f"it off (K3)")
    return {"decode_step_ms_bank_on": on, "decode_step_ms_bank_off": off}


def lora_serving_phase(paths: dict) -> tuple[dict, dict]:
    """The inference server on the LoRA trainer's base snapshot (Qwen3-0.6B
    at full width and depth) with ``inference.lora`` (``max_adapters`` 4 and
    ``LORA_CONFIG``'s rank, alpha and targets): the requests of phase 14,
    then ``lora_serving_extra``. Returns (stats, launches): K3 must not have
    launched, K1 and K4 must have."""
    from prime_rl_tpu_torch.models.base import get_spec

    lcfg = lora_config(get_spec(MODEL))
    serving_lora = {"max_adapters": 4, "rank": lcfg.rank, "alpha": lcfg.alpha,
                    "target_modules": list(lcfg.target_modules)}
    stats, launches = serve(paths["base"], 28, 151936, extra=lora_serving_extra(paths, lcfg),
                            lora=serving_lora)
    if launches.get("decode_qkv_prep", 0) != 0:
        raise AssertionError(f"K3 launched on the multi-LoRA bank path: {launches}")
    for name in ("flash_attn_fwd", "decode_paged_attention"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the multi-LoRA serving path")
    return stats, launches


def lora_loop_phase(card: str) -> dict:
    """``LORA_CONFIG`` colocated through the launcher, cut as the loop phase
    is cut (``configs/bench/northstar_rl_tpu.toml`` merged under it for the
    random init, the byte tokenizer, the pool and ports, seq_len 512;
    ``LOOP_STEPS`` steps, 64 rollouts of up to 128 tokens a step): the loop's
    checks, and the trainer's frozen base bit-equal after every swap (its
    fingerprint at the start and the end, logged by the colocated trainer).
    Returns the colocated process's kernel launches."""
    import re
    import tomllib

    # the loop phase's cuts: northstar_rl_tpu.toml less its optimizer (the LoRA
    # config's adamw stays) and its env list (the LoRA config's reverse_text
    # groups of 16 stay, their completions cut to 128 tokens by a flag)
    with open(os.path.join(ROOT, "configs", "bench", "northstar_rl_tpu.toml"), "rb") as fh:
        cuts = tomllib.load(fh)
    for section, key in (("trainer", "optimizer"), ("orchestrator", "train_envs")):
        del cuts[section][key]
    for key in ("output_dir", "colocated"):
        cuts.pop(key, None)
    cuts_path = os.path.join("build", "chip_smoke", "lora_loop_cuts.toml")
    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    with open(os.path.join(ROOT, cuts_path), "w") as fh:
        fh.write(toml_text(cuts))
    flags = ("--orchestrator.train-envs.0.sampling.max-tokens", "128")
    launches, colocated = run_loop(card, "lora-loop", [LORA_CONFIG, cuts_path], flags)
    start = re.findall(r"training adapters only; frozen base fingerprint (\w+)", colocated)
    end = re.findall(r"LoRA frozen base fingerprint at the end: (\w+)", colocated)
    if not start or not end or start[-1] != end[-1]:
        raise AssertionError(f"lora-loop: the trainer's base fingerprint {start} at the start, "
                             f"{end} at the end")
    log(f"lora-loop: the trainer's frozen base bit-equal after the swaps ({end[-1]})")
    return launches


# ---- the wide kernel forms and Qwen3-VL ----------------------------------------

QWEN3_VL_TRAIN_LAYERS = 16  # of 36: the trunk beside the whole tower (27 blocks), see PERF.md
QWEN3_VL_ROW = 4096  # tokens a packed training row
# the packed row of the kernel rows: two image samples and two text samples
QWEN3_VL_PACKING = [1269, 997, 1100, 730]
# synthetic images as (t, h, w) patch grids: 448 x 448 -> 28 x 28 patches of 16
# (784, 196 image tokens); 1024 x 768 -> 64 x 48 (3072, 768 image tokens)
QWEN3_VL_IMAGES = ((1, 28, 28), (1, 64, 48))
QWEN3_VL_REQUESTS = 16
QWEN3_VL_MAX_TOKENS = 128
# the reference phases' trunk: debug_vlm's tower and token ids, the trunk at
# head dim 128 (so that K3 and K4 take its decode), out_hidden_size = hidden
QWEN3_VL_TEST_SHAPE = dict(hidden_size=512, num_heads=4, num_kv_heads=2, head_dim=128,
                           intermediate_size=1024, mrope_section=(24, 20, 20))
QWEN3_VL_TEST_MOE = dict(family="qwen3_vl_moe", num_experts=8, num_experts_per_tok=2,
                         moe_intermediate_size=256)


def qwen3_vl_spec(num_layers: int | None = None):
    """Qwen3-VL-8B's spec from QWEN3_VL_8B_CONFIG (the port's reader), the
    trunk cut to ``num_layers`` where given."""
    import dataclasses

    from prime_rl_tpu_torch.models.base import spec_from_hf_config

    spec = spec_from_hf_config(json.loads(json.dumps(QWEN3_VL_8B_CONFIG)))
    return spec if num_layers is None else dataclasses.replace(spec, num_layers=num_layers)


def qwen3_vl_test_spec(moe: bool):
    import dataclasses

    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec("debug_vlm")
    spec = dataclasses.replace(spec, **QWEN3_VL_TEST_SHAPE, vision=dataclasses.replace(
        spec.vision, out_hidden_size=QWEN3_VL_TEST_SHAPE["hidden_size"]))
    return dataclasses.replace(spec, **QWEN3_VL_TEST_MOE) if moe else spec


def vlm_prompt(spec, grid, n_text: int, rng) -> tuple[list[int], dict]:
    """A synthetic VLM prompt: ``n_text`` random text tokens (below the vision
    token ids) around one vision block of ``grid`` (t, h, w patches), and its
    pixels from ``rng`` in the HF processor's layout."""
    import numpy as np

    t, h, w = grid
    m = spec.vision.spatial_merge_size
    hi = min(spec.vision_start_token_id, spec.vocab_size)
    text = rng.integers(3, hi, n_text).tolist()
    ids = (text[:n_text // 2] + [spec.vision_start_token_id]
           + [spec.image_token_id] * (t * (h // m) * (w // m)) + text[n_text // 2:])
    pixels = rng.standard_normal((t * h * w, spec.vision.patch_dim)).astype(np.float32)
    return ids, {"pixel_values": pixels, "image_grid_thw": np.asarray([grid], np.int64)}


def vlm_samples(spec, rng, layout) -> list:
    """TrainingSamples of ``layout``: (grid or None, text tokens) each, an
    image sample or a text sample, advantages of both signs."""
    import numpy as np

    from prime_rl_tpu_torch.transport.types import TrainingSample

    out = []
    for i, (grid, n_text) in enumerate(layout):
        if grid is None:
            ids, mm = rng.integers(3, min(spec.vision_start_token_id, spec.vocab_size),
                                   n_text).tolist(), None
        else:
            ids, mm = vlm_prompt(spec, grid, n_text, rng)
        n = len(ids)
        out.append(TrainingSample(
            token_ids=np.asarray(ids, np.int32), mask=np.arange(n) >= n // 2,
            logprobs=(-rng.random(n) * 3).astype(np.float32),
            temperatures=np.ones(n, np.float32),
            advantages=np.full(n, 1.0 if i % 2 else -1.0, np.float32), mm_kwargs=mm))
    return out


def k4_wide_case(gen, flush, hd: int) -> dict:
    """K4 at head dim ``hd`` (384 or 512: the shallower rings) over 32 slots of
    500-1100 cached tokens, 16/4 heads, PS 64: checked twice for equal bits
    and timed as the other K4 rows are."""
    import torch

    s, nh, nkv, ps, p = 32, 16, 4, 64, 4096 // 64

    def lengths():
        return torch.randint(500, 1101, (s,), device="cuda", generator=gen, dtype=torch.int32)

    args = k4_inputs(gen, s, nh, nkv, hd, ps, p, lengths)
    shape = f"S={s} PS={ps} lengths 500..1100, {nh}/{nkv} heads of {hd}"
    err = k4_check(shape, *args, launches=2)
    case = dict(shape=shape, max_abs_err=err, **k4_timing(f"{shape} (err {err:.3g})", *args,
                                                          flush=flush))
    del args
    torch.cuda.empty_cache()
    return case


def k5_wide_timing(gen, flush) -> tuple[dict, dict]:
    """K5a and K5b in their wide forms at S = Sk = 2048, T = 512 (a causal
    top-k), 16 heads, Dq 1152 / v_dim 1024: against the plain versions, each
    timed beside its plain version and one SDPA call (its backward) over the
    dense mask of the selected pairs. Returns the two rows' numbers."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    S, T, H, dq_w, dv = 2048, 512, 16, K.DQ_WIDE, K.DV_WIDE

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, kv, do = randn(S, H, dq_w), randn(S, dq_w), randn(S, H, dv)
    idx = causal_topk_indices(S, T, gen, torch.device("cuda"))
    scale = dq_w ** -0.5
    pairs = int((idx < S).sum())
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, dv)
    ref_out, _ = K.sparse_mla_attention_reference(q, kv, idx, scale, dv)
    err_a = check_close("sparse_mla_fwd (wide) timed row", out, ref_out, K5B_TOL, K5B_TOL)
    dq, dkv = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv)
    ref = K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale, dv)
    err_b = max(check_close(f"sparse_mla_bwd (wide) timed row {w}", g, r, K5B_TOL, K5B_TOL)
                for w, g, r in zip(("dq", "dkv"), (dq, dkv), ref))
    del ref_out, ref
    fwd_ms = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, dv), iters=5, flush=flush)
    bwd_ms = time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, dv), iters=10,
                     warmup=2)
    own_ms, own_launches = k5b_wide_own_ms(q, kv, idx, out, lse, do, scale, flush)
    tiles = K.sparse_mla_bwd_tile_counts(q, kv, idx, out, lse, do, scale, dv)
    shape = f"S=Sk={S} T={T} pairs={pairs} H={H} Dq {dq_w} / v_dim {dv}"
    visited = sparse_mla_tiles("sparse_mla_bwd", f"(wide) {shape}", tiles, idx, S,
                               K.WIDE_BWD_TILE)
    build = wide_bwd_build()
    fwd_plain = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, dv), iters=2,
                        warmup=1)
    bwd_plain = time_ms(lambda: K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale,
                                                                 dv), iters=2, warmup=1)
    fwd_lib, fwd_note = k5a_library_ms(q, kv, idx, scale, flush, dv)
    bwd_lib, bwd_note = k5b_library_ms(q, kv, idx, do, scale, flush, dv)
    rows = []
    for label, ms, plain, lib, note, nbytes, flops, err in (
            ("K5a sparse_mla_fwd (wide)", fwd_ms, fwd_plain, fwd_lib, fwd_note,
             (q.numel() + kv.numel() + out.numel()) * 2 + idx.numel() * 4 + lse.numel() * 4,
             2 * H * pairs * (dq_w + dv), err_a),
            ("K5b sparse_mla_bwd (wide)", bwd_ms, bwd_plain, bwd_lib, bwd_note,
             (q.numel() * 2 + kv.numel() * 2 + do.numel() + out.numel()) * 2 + idx.numel() * 4
             + lse.numel() * 4, 2 * H * pairs * (3 * dq_w + 2 * dv), err_b)):
        bms, by = bound(nbytes, flops)
        log(f"{label} {shape}: err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"library {note if lib is None else f'{lib:.4f} ms ({note})'}  bound {bms:.4f} ms "
            f"({by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         library=note, bound_ms=bms, bound_by=by))
    n_tiles = tiles.shape[0] * -(-T // K.WIDE_BWD_TILE)
    rows[1].update(own_ms=own_ms, own_launches=own_launches,
                   tiles=f"{visited} of {n_tiles} (kernel's count = the mirror's)", build=build)
    log(f"K5b sparse_mla_bwd (wide) {shape}: its own {own_launches} launches {own_ms:.4f} ms "
        f"(L2 flushed; the call {bwd_ms:.4f} ms), tiles of {K.WIDE_BWD_TILE} visited {visited} "
        f"of {n_tiles}, {build['registers']} registers, {build['local_bytes']} bytes of local "
        f"memory, {build['smem_bytes']} bytes of shared memory, {build['blocks_per_sm']} blocks "
        "an SM")
    del q, kv, do, idx, out, lse, dq, dkv
    torch.cuda.empty_cache()
    return rows[0], rows[1]


def range_repairs_phase() -> list[dict]:
    """The forms of ROADMAP Queue 3's repairs, each held against its plain
    version, launched twice for equal bits and timed (their edge cases run in
    the kernel phases: K1_EDGE_CASES at head dims 320 and 512, K4_EDGE_CASES
    at 384 and 512): K1, K2a and K2b at head dim 512 and K2a and K2b at 384
    (B=1 L=2048, 16/4 heads, two sequences), K4 at 384 and 512, and K5a/K5b
    at the wide widths over K5_WIDE_CASES (1152/1024 and 640/512) and timed
    at 1152/1024."""
    import torch

    from prime_rl_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    before = dict(_build.launches)
    rows = []
    kernels = (("flash_attn_fwd", 59), ("flash_attn_bwd_dq", 227), ("flash_attn_bwd_dkv", 282))
    # the rows at 384 draw from a generator of their own: the phase's other
    # checks keep their inputs whatever rows come before them
    gen384 = torch.Generator(device=dev)
    gen384.manual_seed(SEED + 20)
    for hd, g in ((512, gen), (384, gen384)):  # K1 at 384 is the plain form of 512: not timed
        found = k12_rows(g, f"hd{hd}", 1, 2048, 16, 4, hd, [[1100, 948]], k1=hd == 512)
        for (name, line), case in zip(kernels[3 - len(found):], found):
            source = "fwd" if name == "flash_attn_fwd" else "bwd"
            rows.append(dict(name=f"{name}/hd{hd}", route="cuda",
                             source=f"prime_rl_tpu_torch/csrc/flash_attn_{source}.cu",
                             replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                             **{k: case[k] for k in keys}, cases=[case]))
    for hd in (384, 512):
        case = k4_wide_case(gen, flush, hd)
        rows.append(dict(name=f"decode_paged_attention/hd{hd}", route="cuda",
                         source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                         replaces="prime_rl_tpu/ops/decode_attention.py:50",
                         **{k: case[k] for k in keys}, cases=[case]))
    errs = [k5_wide_case(gen, *case) for case in K5_WIDE_CASES]
    fwd, bwd = k5_wide_timing(gen, flush)
    fwd["max_abs_err"] = max([fwd["max_abs_err"]] + [e[0] for e in errs])
    bwd["max_abs_err"] = max([bwd["max_abs_err"]] + [e[1] for e in errs])
    for name, line, case in (("sparse_mla_fwd", 67, fwd), ("sparse_mla_bwd", 153, bwd)):
        rows.append(dict(name=f"{name}/wide", route="cuda",
                         source="prime_rl_tpu_torch/csrc/sparse_mla.cu",
                         replaces=f"prime_rl_tpu/ops/sparse_mla_pallas.py:{line}",
                         **{k: case[k] for k in keys}, cases=[case],
                         edge_cases=len(K5_WIDE_CASES)))
    forms = {k: v - before.get(k, 0) for k, v in _build.launches.items()
             if k.endswith("/wide") and v > before.get(k, 0)}
    for kernel in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                   "decode_paged_attention", "sparse_mla_fwd", "sparse_mla_bwd"):
        if forms.get(f"{kernel}/wide", 0) <= 0:
            raise AssertionError(f"range-repairs: the wide form of {kernel} never launched")
    for row in rows:
        row["launches_range_repairs"] = forms[row["name"].split("/")[0] + "/wide"]
    log(f"range-repairs: the wide forms' launches in this phase {forms}")
    del flush
    torch.cuda.empty_cache()
    return rows


def qwen3_vl_kernel_phase() -> list[dict]:
    """The kernel rows at Qwen3-VL-8B's trunk (32/8 heads of 128), each held
    against its plain version, launched twice for equal bits and timed: K1,
    K2a and K2b over a packed row of 4096 tokens (QWEN3_VL_PACKING: two image
    samples, two text samples), K3 at D 4096 with its qk-norm at 64 slots, K4
    at the serving phase's shape (16 slots of 260-1100 cached tokens, PS 64);
    and K3 at debug_vlm's D 128, 4/2 heads of 32 (the VLM loop's decode)."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    spec = qwen3_vl_spec()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    rows = []
    found = k12_rows(gen, "qwen3-vl", 1, QWEN3_VL_ROW, spec.num_heads, spec.num_kv_heads,
                     spec.head_dim, [QWEN3_VL_PACKING])
    for (name, line), case in zip((("flash_attn_fwd", 59), ("flash_attn_bwd_dq", 227),
                                   ("flash_attn_bwd_dkv", 282)), found):
        source = "fwd" if name == "flash_attn_fwd" else "bwd"
        rows.append(dict(name=f"{name}/qwen3-vl", route="cuda",
                         source=f"prime_rl_tpu_torch/csrc/flash_attn_{source}.cu",
                         replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                         **{k: case[k] for k in keys}, cases=[case], model=QWEN3_VL))
    case = k3_row(spec, gen, flush, QWEN3_VL, qk_norm=True, bias=False)
    rows.append(dict(name="decode_qkv_prep/qwen3-vl", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_qkv.cu",
                     replaces="prime_rl_tpu/ops/decode_qkv.py:36",
                     **{k: case[k] for k in keys}, cases=[case], model=QWEN3_VL))
    # head dim 32: debug_vlm's trunk, which the VLM loop decodes through K3
    case = k3_row(get_spec("debug_vlm"), gen, flush, "debug_vlm", qk_norm=True, bias=False)
    rows.append(dict(name="decode_qkv_prep/hd32", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_qkv.cu",
                     replaces="prime_rl_tpu/ops/decode_qkv.py:36",
                     **{k: case[k] for k in keys}, cases=[case], model="debug_vlm"))
    s, ps, p = QWEN3_VL_REQUESTS, 64, 4096 // 64

    def lengths():
        return torch.randint(260, 1101, (s,), device="cuda", generator=gen, dtype=torch.int32)

    args = k4_inputs(gen, s, spec.num_heads, spec.num_kv_heads, spec.head_dim, ps, p, lengths)
    shape = f"S={s} PS={ps} lengths 260..1100, 32/8 heads of 128 (Qwen3-VL-8B serving)"
    err = k4_check(shape, *args, launches=2)
    case = dict(shape=shape, max_abs_err=err, **k4_timing(f"{shape} (err {err:.3g})", *args,
                                                          flush=flush))
    rows.append(dict(name="decode_paged_attention/qwen3-vl", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50",
                     **{k: case[k] for k in keys}, cases=[case], model=QWEN3_VL))
    del args, flush
    torch.cuda.empty_cache()
    return rows


def vlm_train_reference(spec, label: str) -> dict:
    """Loss and every gradient (the tower's among them) of one packed row of
    512 tokens (an image sample, a text sample) through ``spec`` in bf16 on
    the card (K1, K2a, K2b; the tower's products), against float32 on the CPU
    from the same bf16-representable weights; the CPU replays the card's
    routing. Returns the card's launches."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.batch import prepare_batch
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    gen = torch.Generator().manual_seed(SEED)
    master = tree_map(lambda x: x.to(torch.bfloat16), get_family(spec).init(spec, gen))
    rng = np.random.default_rng(SEED)
    batch = prepare_batch(vlm_samples(spec, rng, [((1, 16, 12), 200), (None, 240)]), 512, 1, 1,
                          vlm_spec=spec)
    scales = Scales(float(batch.loss_mask.sum()), 1.0, 1.0)

    def run(device, dtype, compute):
        params = tree_map(lambda x: x.to(device=device, dtype=dtype).requires_grad_(), master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        loss_fn = make_loss_fn(spec, ModelConfig(compute_dtype=compute), DefaultLossConfig())
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        return float(loss.detach()), {p: x.grad.float().cpu() for p, x in tree_paths(params)}

    _build.reset_launches()
    routing: list = []
    with recorded_routing(record=routing):
        loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label} train reference: {name} was not launched on the card")
    with recorded_routing(replay=[r.cpu() for r in routing]):
        loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32")
    # as train_reference_phase: bf16 through the tower and the trunk against float32
    loss_rtol, grad_rtol = 2e-2, 5e-2
    if not abs(loss_gpu - loss_cpu) <= loss_rtol * abs(loss_cpu):
        raise AssertionError(f"{label} train reference loss {loss_gpu} vs float32 {loss_cpu}")
    worst = 0.0
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"{label} train reference gradient of {path}: relative error "
                                 f"{rel:.4g} exceeds {grad_rtol}")
    log(f"{label} train reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} (tolerance "
        f"{loss_rtol} relative); worst gradient error {worst:.4g} of its norm over "
        f"{len(grads_cpu)} tensors, the tower's {sum(p.startswith('vision') for p in grads_cpu)} "
        f"among them (tolerance {grad_rtol}); launches {launches}")
    return launches


def vlm_served_reference(spec, label: str) -> dict:
    """The served forward of ``spec`` on an image prompt (one vision block of
    48 tokens in 149): the tower, the prefill with its image slots, DeepStack
    and mRoPE positions (logits and prompt logprobs), and 4 decode steps with
    the prompt's ``pos_delta``, in bf16 through K1, K3 and K4 on the card,
    against float32 on the CPU from the same weights (the CPU replays the
    card's routing), within 0.05 of the largest |logit| as the other served
    references. Returns the card's launches."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.sampler import model as smodel
    from prime_rl_tpu_torch.sampler.cache import CacheConfig, KVPool
    from prime_rl_tpu_torch.sampler.engine import prepare_mm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = perturbed(get_family(spec).init(spec, gen, dtype=torch.bfloat16, device="cuda"), gen)
    rng = np.random.default_rng(SEED)
    ids, mm = vlm_prompt(spec, (1, 16, 12), 100, rng)
    n, steps, ps = len(ids), 4, 64
    lpad = -(-n // ps) * ps
    n_pages = -(-(n + steps) // ps) + 1
    table = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    cache = CacheConfig(num_pages=n_pages + 1, page_size=ps, max_slots=1,
                        max_seq_len=n_pages * ps)
    ids_pad = torch.zeros(1, lpad, dtype=torch.int64)
    ids_pad[0, :n] = torch.tensor(ids)
    nxt = torch.randint(1, 250, (steps,), generator=torch.Generator().manual_seed(SEED))
    what = ["prefill", "prompt logprobs"] + [f"decode {i}" for i in range(steps)]

    def run(params, device, dtype):
        sp = smodel.unstack_params(params, spec)
        pool = KVPool(spec, cache, dtype=dtype, device=device)
        kp, vp = pool.k, pool.v

        def to_dev(a):
            return torch.as_tensor(np.asarray(a)).to(device)

        mm_dev, delta = prepare_mm(sp, spec, mm, ids, lpad, to_dev, dtype)
        got = smodel.prefill(sp, spec, kp, vp, ids_pad.to(device), n,
                             table[0, :lpad // ps].to(device), compute_dtype=dtype,
                             want_prompt_logprobs=True, mm=mm_dev)
        out = [smodel.logits_from_hidden(sp, spec, got[2][None], dtype), got[3][1:n]]
        for i in range(steps):
            tok = (torch.tensor(ids[-1:]) if i == 0 else nxt[i - 1:i]).to(device)
            _, _, logits = smodel.decode(
                sp, spec, kp, vp, tok, torch.tensor([n + i], dtype=torch.int32, device=device),
                table.to(device), compute_dtype=dtype,
                pos_delta=torch.tensor([delta], dtype=torch.int32, device=device))
            out.append(logits)
        return [o.float().cpu() for o in out], delta

    _build.reset_launches()
    routing: list = []
    with recorded_routing(record=routing):
        got, delta = run(params, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for kernel in ("flash_attn_fwd", "decode_qkv_prep", "decode_paged_attention"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{label} served reference: {kernel} was not launched")
    cpu = {k: (v.float().cpu() if isinstance(v, torch.Tensor) else
               {n_: (t.float().cpu() if isinstance(t, torch.Tensor) else
                     {m_: u.float().cpu() for m_, u in t.items()}) for n_, t in v.items()})
           for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    with recorded_routing(replay=[r.cpu() for r in routing]):
        want, delta_cpu = run(cpu, torch.device("cpu"), torch.float32)
    if delta != delta_cpu or delta >= 0:
        raise AssertionError(f"{label}: pos_delta {delta} on the card, {delta_cpu} on the CPU")
    for what_, g, w in zip(what, got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        if not (err <= 0.05 * scale and bool(torch.isfinite(g).all())):
            raise AssertionError(f"{label} served {what_} differs from the float32 reference: "
                                 f"max err {err:.4g} vs max |ref| {scale:.4g}")
        log(f"{label} served reference {what_}: max err {err:.4g} (max |ref| {scale:.4g})")
    log(f"{label} served reference: pos_delta {delta}; launches {launches}")
    return launches


def qwen3_vl_reference_phase() -> dict:
    """``vlm_train_reference`` and ``vlm_served_reference`` for the dense
    trunk and the MoE trunk at QWEN3_VL_TEST_SHAPE. Returns {label: {"train":
    launches, "serve": launches}}."""
    out = {}
    for label, moe in (("qwen3-vl", False), ("qwen3-vl-moe", True)):
        spec = qwen3_vl_test_spec(moe)
        out[label] = {"train": vlm_train_reference(spec, label),
                      "serve": vlm_served_reference(spec, label)}
    return out


def vlm_decode_timing(engine, slots: int = QWEN3_VL_REQUESTS, cached: int = 1000) -> dict:
    """The decode step of the served Qwen3-VL-8B at ``slots`` slots of
    ``cached`` tokens with an mRoPE offset (the engine's pool, after its
    requests): busy ms (CUDA events around a step) and host ms (the host
    clock around a step that ends in a synchronize), medians of 10."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec, dev, ps = engine.spec, engine.device, engine.config.page_size
    p = cached // ps + 2
    table = (1 + torch.arange(slots * p, device=dev, dtype=torch.int32)).reshape(slots, p)
    lengths = torch.full((slots,), cached, dtype=torch.int32, device=dev)
    delta = torch.full((slots,), -600, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, 150000, (slots,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))

    def step():
        with torch.no_grad():
            smodel.decode(engine.params, spec, engine.k_pool, engine.v_pool, tokens, lengths,
                          table, compute_dtype=torch.bfloat16, pos_delta=delta)

    busy = time_ms(step, iters=10)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return {"decode_step_busy_ms": busy, "decode_step_host_ms": float(np.median(host)),
            "decode_slots": slots, "decode_cached_tokens": cached}


def vlm_tower_timing(engine) -> dict:
    """The vision tower of the served Qwen3-VL-8B alone (CUDA events, bf16,
    no grad) on one image of each of QWEN3_VL_IMAGES, its patches padded to
    the engine's bucket, and its attention alone (``frame_attention`` over
    the real patches at 16 heads of 72, one frame): ms each."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.models.vision import frame_attention, prep_patch_metadata, vision_forward
    from prime_rl_tpu_torch.sampler.engine import MM_BUCKETS, _bucket

    spec, dev = engine.spec, engine.device
    vspec = spec.vision
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for grid in QWEN3_VL_IMAGES:
        n = int(np.prod(grid))
        pb = _bucket(n, list(MM_BUCKETS))
        meta = {k: torch.as_tensor(v).to(dev) for k, v in
                prep_patch_metadata(np.asarray([grid]), vspec, pad_to=pb).items()}
        pixels = torch.randn(pb, vspec.patch_dim, device=dev, generator=gen)
        with torch.no_grad():
            tower = time_ms(lambda: vision_forward(
                engine.params["vision"], vspec, pixels, meta["seg_ids"], meta["pos_idx"],
                meta["pos_w"], meta["rope_coords"], compute_dtype=torch.bfloat16, remat="none"),
                iters=5, warmup=1)
            q, k, v = (torch.randn(n, vspec.num_heads, vspec.head_dim, device=dev,
                                   generator=gen).to(torch.bfloat16) for _ in range(3))
            attn = time_ms(lambda: frame_attention(q, k, v, [(0, n)], vspec.head_dim ** -0.5),
                           iters=10)
        out[f"tower_ms_{n}_patches"] = tower
        out[f"tower_attention_ms_{n}_patches"] = attn
    log(f"the Qwen3-VL-8B tower alone (27 blocks, bf16): {json.dumps(out)} (the attention "
        f"alone: one block's, one frame)")
    return out


def qwen3_vl_serving_phase(card: str) -> tuple[dict, dict]:
    """The inference server on Qwen3-VL-8B at full width and depth (36
    layers, the 27-block tower; random weights from the seed) over HTTP:
    QWEN3_VL_REQUESTS concurrent requests, each one synthetic image
    (QWEN3_VL_IMAGES in turn: 196 or 768 image tokens) in 64-256 text tokens,
    its pixels as base64 f32 on the wire, QWEN3_VL_MAX_TOKENS tokens each;
    then one text-only request on the same engine, and the decode step's
    busy and host ms. Returns (stats, launches of the requests)."""
    import base64

    import aiohttp
    import aiohttp.web_app
    import numpy as np
    import torch

    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.sampler.engine import SamplingParams

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    model_dir = config_dir("qwen3_vl_serving", QWEN3_VL_8B_CONFIG)
    config = InferenceConfig(
        device="cuda", seed=SEED, max_model_len=4096,
        output_dir=os.path.join(ROOT, "build", "chip_smoke"),
        model={"name": model_dir, "debug": {"random_init": True}},
        tokenizer={"name": "byte"}, scheduler={"max_batch_size": 64})
    t0 = time.perf_counter()
    server = build_server(config)
    engine = server.engine
    spec = engine.spec
    log(f"{QWEN3_VL} server built in {time.perf_counter() - t0:.2f} s: {spec.num_layers} "
        f"layers, a tower of {spec.vision.depth} blocks, vocab {spec.vocab_size}, "
        f"{engine.config.num_pages} KV pages of {engine.config.page_size}, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if (spec.num_layers, spec.vision.depth, spec.vocab_size) != (36, 27, 151936):
        raise AssertionError(f"the served model must be {QWEN3_VL} at full width and depth")
    rng = np.random.default_rng(SEED)
    engine.warmup(4)
    warm_ids, warm_mm = vlm_prompt(spec, QWEN3_VL_IMAGES[0], 64, rng)
    engine.generate([warm_ids], SamplingParams(max_tokens=2), mm=[warm_mm])  # the tower's first call
    prompts = [vlm_prompt(spec, QWEN3_VL_IMAGES[i % 2], int(rng.integers(64, 257)), rng)
               for i in range(QWEN3_VL_REQUESTS)]
    text_prompt = rng.integers(3, 150000, 200).tolist()
    base = f"http://127.0.0.1:{port}"

    def body(ids, mm):
        out = {"token_ids": ids, "sampling_params": {"max_tokens": QWEN3_VL_MAX_TOKENS,
                                                     "temperature": 1.0}}
        if mm is not None:
            pv = mm["pixel_values"]
            out["mm"] = {"pixel_values": {"b64": base64.b64encode(pv.astype("<f4").tobytes())
                                          .decode(), "shape": list(pv.shape)},
                         "image_grid_thw": mm["image_grid_thw"].tolist()}
        return out

    def check(result: dict, what: str) -> int:
        c = result["choices"][0]
        toks, lps = c["token_ids"], c["logprobs"]
        ok = (len(toks) == QWEN3_VL_MAX_TOKENS if c["finish_reason"] == "length"
              else c["finish_reason"] == "stop" and toks and toks[-1] == spec.eos_token_id)
        if not ok or len(lps) != len(toks) or not np.all(np.isfinite(lps)):
            raise AssertionError(f"{what}: bad result {c['finish_reason']} {len(toks)} tokens")
        return len(toks)

    async def drive():
        runner = await server.start_async("127.0.0.1", port)
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
                async def generate(ids, mm):
                    r = await http.post(f"{base}/inference/v1/generate", json=body(ids, mm))
                    if r.status != 200:
                        raise AssertionError(f"generate: HTTP {r.status}: {await r.text()}")
                    return await r.json()

                _build.reset_launches()
                t0 = time.perf_counter()
                results = await asyncio.gather(*(generate(ids, mm) for ids, mm in prompts))
                wall = time.perf_counter() - t0
                launches = dict(_build.launches)
                tokens = sum(check(r, f"image request {i}") for i, r in enumerate(results))
                t1 = time.perf_counter()
                text = await generate(text_prompt, None)
                text_s = time.perf_counter() - t1
                check(text, "the text request")
        finally:
            await server.stop_async(runner)
        return launches, dict(
            requests=len(prompts), generated_tokens=tokens, wall_s=wall,
            tokens_per_s=tokens / wall,
            image_tokens=[sum(t == spec.image_token_id for t in ids) for ids, _ in prompts],
            prompt_tokens=[len(ids) for ids, _ in prompts],
            text_request_tokens=len(text["choices"][0]["token_ids"]), text_request_s=text_s)

    launches, stats = asyncio.run(drive())
    stats["vision_patches"] = engine.stats.get("vision_patches", 0)
    stats.update(vlm_decode_timing(engine))
    stats.update(vlm_tower_timing(engine))
    stats["device_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for kernel in ("flash_attn_fwd", "decode_qkv_prep", "decode_paged_attention"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"qwen3-vl-serving: {kernel} was not launched: {launches}")
    log(f"{QWEN3_VL} serving on {card}: {stats['tokens_per_s']:.1f} tokens/s over "
        f"{stats['requests']} image requests ({stats['generated_tokens']} tokens in "
        f"{stats['wall_s']:.2f} s; image tokens {sorted(set(stats['image_tokens']))}), the "
        f"decode step at {stats['decode_slots']} slots of {stats['decode_cached_tokens']} tokens "
        f"{stats['decode_step_host_ms']:.3f} host ms, {stats['decode_step_busy_ms']:.3f} busy ms; "
        f"a text request after them {stats['text_request_tokens']} tokens in "
        f"{stats['text_request_s']:.2f} s; launches {launches}")
    for fn in vars(aiohttp.web_app).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    alive = weakref.ref(engine)
    del server, engine
    gc.collect()
    if alive() is not None:
        raise AssertionError("the Qwen3-VL engine outlived its server: its memory is not freed")
    torch.cuda.empty_cache()
    return stats, launches


def qwen3_vl_training_phase(card: str) -> tuple[dict, dict]:
    """The trainer's step (``make_train_step``, as ``train`` builds it) on
    Qwen3-VL-8B with the whole tower and the trunk cut to
    QWEN3_VL_TRAIN_LAYERS, random weights from the seed: 2 micro-batches of
    one packed row of 4096 tokens that mix image samples (768 and 196 image
    tokens) and text samples, the patch buffer auto-sized, adamw_8bit with
    bf16 masters, full remat, 2 steps: finite losses, the tower's gradients
    non-zero, the launches of K1, K2a and K2b the layers imply. Returns
    (launches, numbers of the last step)."""
    import numpy as np
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.batch import prepare_batch, token_counts
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves
    from prime_rl_tpu_torch.trainer.step import Scales, init_train_state, make_train_step

    steps, layers = 2, QWEN3_VL_TRAIN_LAYERS
    spec = qwen3_vl_spec(layers)
    cfg = TrainerConfig(
        device="cuda", seed=SEED, grad_clip=1.0,
        model={"name": QWEN3_VL, "seq_len": QWEN3_VL_ROW,
               "debug": {"random_init": True, "num_layers": layers}},
        optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"})
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    step = make_train_step(spec, cfg.model, cfg.loss, optimizer, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    tower = sum(x.numel() for x in tree_leaves(state.params["vision"]))
    big, small = QWEN3_VL_IMAGES[1], QWEN3_VL_IMAGES[0]
    # first-fit decreasing packs these into two rows: [text 2000, image 768 + text],
    # [image 196 + text, text 1300, image 196 + text]
    layout = [(None, 2000), (big, 2000 - 769), (small, 1400 - 197), (None, 1300),
              (small, 700 - 197)]
    rng = np.random.default_rng(SEED)
    records = []
    _build.reset_launches()
    for i in range(steps):
        batch = prepare_batch(vlm_samples(spec, rng, layout), QWEN3_VL_ROW, 1, 2, vlm_spec=spec)
        if batch.input_ids.shape != (2, 1, QWEN3_VL_ROW):
            raise AssertionError(f"qwen3-vl-training: batch of shape {batch.input_ids.shape}")
        counts = token_counts(batch)
        scales = Scales(rl=float(max(counts["rl"], 1)), ce=1.0, ref_kl=1.0)
        patches = int((np.asarray(batch.mm_vis_seg_ids) > 0).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, scales)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        records.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                            step_time_s=time.perf_counter() - t0, mm_patches=patches,
                            mm_buffer=int(batch.mm_patches.shape[1])))
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
               for r in records):
        raise AssertionError(f"qwen3-vl-training: bad step records {records}")
    per_pass = layers * 2 * steps
    want = {"flash_attn_fwd": 2 * per_pass, "flash_attn_bwd_dq": per_pass,
            "flash_attn_bwd_dkv": per_pass}
    for kernel, n in want.items():
        if launches.get(kernel, 0) != n:
            raise AssertionError(f"{kernel}: {launches.get(kernel, 0)} launches on the "
                                 f"qwen3-vl-training path, expected {n}")
    last = records[-1]
    numbers = dict(step_time_s=last["step_time_s"],
                   tokens_per_s=2 * QWEN3_VL_ROW / last["step_time_s"], peak_gib=peak,
                   parameters=n_params, tower_parameters=tower, layers=layers,
                   mm_patches=last["mm_patches"], mm_buffer=last["mm_buffer"])
    log(f"qwen3-vl-training on {card}: {n_params / 1e9:.3f} G parameters ({tower / 1e9:.3f} G "
        f"in the tower, {layers} of 36 layers); {steps} steps of 2 x [1, {QWEN3_VL_ROW}] tokens "
        f"({last['mm_patches']} real patches in a buffer of {last['mm_buffer']} a micro-batch); "
        f"losses {[r['loss'] for r in records]}, step times "
        f"{[round(r['step_time_s'], 3) for r in records]} s, peak device memory {peak:.2f} GiB; "
        f"launches {launches}")
    del state, step, optimizer, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


VLM_LOOP_CONFIG = os.path.join("configs", "debug", "rl_vlm.toml")
VLM_LOOP_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                    "decode_qkv_prep")


def vlm_loop_phase(card: str) -> dict:
    """``configs/debug/rl_vlm.toml`` (debug_vlm, the dominant_color image env,
    sync GRPO) through the launcher, colocated on the card, for LOOP_STEPS
    steps (run_loop's checks), the trainer's attention on the card's kernels
    (the config's ``xla`` is its CPU setting), and the trainer's records
    holding the vision patches it trained on. debug_vlm's head dim 32 runs
    K1/K2 (zero-padded to 64) and K3; its decode attention is the plain
    one, as the JAX decode sends head dim 32 to XLA (``takes_k4``). Returns
    the colocated process's launches."""
    launches, _ = run_loop(card, "vlm-loop", [VLM_LOOP_CONFIG],
                           ("--trainer.model.attn.impl", "auto"), kernels=VLM_LOOP_KERNELS)
    rows = _jsonl(os.path.join(ROOT, "build", "chip_smoke", "vlm-loop", "trainer.jsonl"))
    if not all(r.get("mm_patches", 0) > 0 for r in rows):
        raise AssertionError(f"vlm-loop: the trainer's records lack vision patches: "
                             f"{[r.get('mm_patches') for r in rows]}")
    log(f"vlm-loop: vision patches trained a step {[r['mm_patches'] for r in rows]}")
    return launches


def flash_build_report() -> None:
    """Registers, local memory and shared memory of each instantiation of K1,
    K2a and K2b (head dims 64 to 512, dense and banded) as the runtime loaded
    it (``cudaFuncGetAttributes``): registers a thread, local memory a thread
    (where ptxas puts spilled registers; the kernels have no local arrays, so
    any is a spill), static and dynamic shared memory a block. Logs every
    instantiation, then raises if any uses local memory."""
    import ctypes

    from prime_rl_tpu_torch.ops import _build

    fwd, bwd = _build.load("flash_attn_fwd"), _build.load("flash_attn_bwd")
    kernels = (
        ("K1", "flash_attn_fwd", fwd.flash_attn_fwd_attributes,
         lambda hd: fwd.flash_attn_fwd_smem(hd, 4096), lambda hd, w: 1, "Lk"),
        ("K2a", "flash_attn_bwd_dq", lambda *a: bwd.flash_attn_bwd_attributes(0, *a),
         lambda hd: bwd.flash_attn_bwd_smem(0, hd, 4096),
         lambda hd, w: bwd.flash_attn_bwd_blocks_per_sm(0, hd, w, 4096), "Lk"),
        ("K2b", "flash_attn_bwd_dkv", lambda *a: bwd.flash_attn_bwd_attributes(1, *a),
         lambda hd: bwd.flash_attn_bwd_smem(1, hd, 4096),
         lambda hd, w: bwd.flash_attn_bwd_blocks_per_sm(1, hd, w, 4096), "Lq"))
    spills = []
    for label, name, attributes, dynamic, per_sm, over in kernels:
        for hd in (512, 384, 256, 128, 64):  # K1's plain form at 384 and 512: one kernel for both
            for window, form in ((0, "dense"), (1, "window")):
                attrs = (ctypes.c_int * 4)()
                _build.check(name, attributes(hd, window, attrs))
                regs, local, static, threads = attrs
                log(f"{label} build: head dim {hd}, {form}: {regs} registers a thread ({threads} "
                    f"threads a block, {per_sm(hd, window)} blocks an SM), local memory (spills) "
                    f"{local} bytes a thread, shared memory {static} bytes static + {dynamic(hd)} "
                    f"dynamic a block at {over} 4096")
                if local:
                    spills.append(f"{label} head dim {hd} {form}")
    if spills:
        raise AssertionError(f"{', '.join(spills)} use local memory: registers spill")

def decode_build_report() -> None:
    """Registers, local memory and shared memory of each instantiation of K4
    (head dim 128 and 64, chunks of 1, 2, 4 and 8 query heads a block: a GQA
    group is cut into chunks of these) and of K3 (head dim 128 and 64, one and
    two 64-row M tiles a block) as the runtime loaded it
    (``cudaFuncGetAttributes``), and K3's launch at the serving shapes of
    Qwen3-0.6B, gpt-oss-20b, Qwen3-30B-A3B and GLM-4.5-Air (split of D,
    clusters the card holds, shared memory). Logs every instantiation, then raises if any uses local memory
    (neither kernel has local arrays, so any is a spill)."""
    import ctypes

    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_plan

    lib = _build.load("decode_attention")
    spills = []
    for hd in (512, 384, 256, 128, 64):
        for group in (1, 2, 4, 8):
            attrs = (ctypes.c_int * 4)()
            _build.check("decode_paged_attention",
                         lib.decode_attention_attributes(hd, group, attrs))
            regs, local, static, threads = attrs
            log(f"K4 build: head dim {hd}, chunk of {group}: {regs} registers a thread ({threads} "
                f"threads a block), local memory (spills) {local} bytes a thread, shared memory "
                f"{static} bytes static + {lib.decode_attention_smem(hd)} dynamic a block")
            if local:
                spills.append(f"K4 head dim {hd} group {group}")
    k3 = _build.load("decode_qkv")
    for hd in (128, 64, 32):
        for mt in (1, 2):
            attrs = (ctypes.c_int * 4)()
            _build.check("decode_qkv_prep", k3.decode_qkv_attributes(hd, mt, attrs))
            regs, local, static, threads = attrs
            log(f"K3 build: head dim {hd}, {mt} M tile{'s' if mt > 1 else ''} a block: {regs} "
                f"registers a thread ({threads} threads a block), local memory (spills) {local} "
                f"bytes a thread, shared memory {static} bytes static")
            if local:
                spills.append(f"K3 head dim {hd} M tiles {mt}")
    for model in (MODEL, GPT_OSS, QWEN3_MOE, GLM):
        spec = get_spec(model)
        plan = decode_qkv_plan(64, spec.hidden_size, spec.num_heads, spec.num_kv_heads,
                               spec.head_dim)
        log(f"K3 launch at {model}'s S=64: {plan['col_tiles']} column tiles x split "
            f"{plan['splits']} = {plan['col_tiles'] * plan['splits']} blocks, a ring of "
            f"{plan['stages']} stages, {plan['smem']} bytes of dynamic shared memory a block, "
            f"{plan['clusters']} clusters of {plan['splits']} at once")
    if spills:
        raise AssertionError(f"{', '.join(spills)} use local memory: registers spill")


def main() -> int:
    # the DSA trainer's state comes within a few GiB of the card's memory: keep
    # the caching allocator from stranding it in fragments (read at its first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    flash_build_report()
    decode_build_report()
    sparse_mla_build_report()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    spec = get_spec(MODEL)
    rows = (timed("kernels", kernel_phase, spec) + timed("dsa kernels", sparse_mla_kernel_phase)
            + timed("gpt-oss kernels", gpt_oss_kernel_phase)
            + timed("gated and serving kernels", gated_kernel_phase)
            + timed("qwen3-next kernels", qwen3_next_kernel_phase)
            + timed("nemotron-h kernels", nemotron_kernel_phase)
            + timed("range-repairs", range_repairs_phase)
            + timed("qwen3-vl kernels", qwen3_vl_kernel_phase))
    timed("train-reference", train_reference_phase)
    train_launches, train_numbers = timed("training", training_phase)
    timed("dsa-train-reference", dsa_train_reference_phase)
    dsa_launches, _ = timed("dsa-training", dsa_training_phase)
    timed("gpt-oss-train-reference", gpt_oss_train_reference_phase)
    oss_train_launches, _ = timed("gpt-oss-training", gpt_oss_training_phase)
    sft_launches, sft_numbers = timed("sft", sft_phase)
    timed("qwen3-moe-reference", served_moe_reference, QWEN3_MOE,
          ("flash_attn_fwd", "decode_qkv_prep", "decode_paged_attention"))
    moe_train_launches, moe_train_numbers = timed("qwen3-moe-training", qwen3_moe_training_phase)
    minimax_ref_launches = timed("minimax-reference", minimax_reference_phase)
    minimax_train_launches, minimax_train_numbers = timed("minimax-training",
                                                          minimax_training_phase)
    gated_launches = {name: timed(f"{name}-reference", gated_reference_phase, debug)
                      for name, debug in (("afmoe", "debug_afmoe"), ("laguna", "debug_laguna"))}
    timed("deepseek-v3-reference", deepseek_reference_phase)
    timed("glm5-serving-reference", dsa_serving_reference_phase)
    next_ref_launches = timed("qwen3-next-reference", qwen3_next_reference_phase)
    next_train_launches, next_train_numbers = timed("qwen3-next-training",
                                                    qwen3_next_training_phase)
    nem_ref_launches = timed("nemotron-h-reference", nemotron_reference_phase)
    nem_train_launches, nem_train_numbers = timed("nemotron-h-training", nemotron_training_phase)
    vl_ref_launches = timed("qwen3-vl-reference", qwen3_vl_reference_phase)
    gc.collect()
    torch.cuda.empty_cache()
    vl_train_launches, vl_train_numbers = timed("qwen3-vl-training", qwen3_vl_training_phase,
                                                card)

    stats, launches = timed("reference + serving", serve, MODEL, 28, 151936, reference_phase)
    timed("gpt-oss-reference", gpt_oss_reference_phase)
    oss_stats, oss_launches = timed("gpt-oss-serving", serve, GPT_OSS, GPT_OSS_SERVE_LAYERS,
                                    201088, None, False, GPT_OSS_SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    moe_stats, moe_launches = timed("qwen3-moe-serving", serve, QWEN3_MOE, QWEN3_MOE_SERVE_LAYERS,
                                    151936, None, True, QWEN3_MOE_SERVE_LAYERS)
    timed("glm4-moe-reference", served_moe_reference, GLM,
          ("flash_attn_fwd", "decode_qkv_prep", "decode_paged_attention/chunked"))
    glm_stats, glm_launches = timed("glm4-moe-serving", serve, GLM, 4, 151552, None, True, 4)
    gc.collect()
    torch.cuda.empty_cache()
    minimax_stats, minimax_launches = timed(
        "minimax-serving", serve, config_dir("minimax_m2_serving", MINIMAX_M2_CONFIG,
                                             num_hidden_layers=MINIMAX_SERVE_LAYERS),
        MINIMAX_SERVE_LAYERS, 200064, None, True)
    gc.collect()
    torch.cuda.empty_cache()
    glm5_stats, glm5_launches = timed(
        "glm5-serving", serve, glm5_model_dir("glm5_serving", **GLM5_CUTS),
        GLM5_CUTS["num_hidden_layers"], GLM5_CONFIG["vocab_size"], None, True, None,
        GLM5_LONG_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    next_stats, next_launches = timed(
        "qwen3-next-serving", serve,
        qwen3_next_dir("qwen3_next_serving", QWEN3_NEXT_SERVE_LAYERS), QWEN3_NEXT_SERVE_LAYERS,
        151936, None, True, None, 0, grpo_group_phase)
    gc.collect()
    torch.cuda.empty_cache()
    nem_stats, nem_launches = timed(
        "nemotron-h-serving", serve,
        nemotron_dir("nemotron_serving", get_spec(NEMOTRON).layer_pattern[:NEMOTRON_SERVE_LAYERS]),
        NEMOTRON_SERVE_LAYERS, 131072, None, False, None, 0, grpo_group_phase,
        NEMOTRON_STATE_CACHE_MB)
    gc.collect()
    torch.cuda.empty_cache()
    vl_stats, vl_launches = timed("qwen3-vl-serving", qwen3_vl_serving_phase, card)
    gc.collect()
    torch.cuda.empty_cache()
    lora_train_launches, lora_train_numbers, lora_paths = timed(
        "lora-training", lora_training_phase, train_numbers)
    lora_stats, lora_launches = timed("lora-serving", lora_serving_phase, lora_paths)
    gc.collect()
    torch.cuda.empty_cache()  # the loop's processes need the card's memory
    loop_launches = timed("loop", loop_phase, card)
    lora_loop_launches = timed("lora-loop", lora_loop_phase, card)
    vlm_loop_launches = timed("vlm-loop", vlm_loop_phase, card)
    log(f"gpt-oss-20b serving on {card}: {oss_stats['generate_tokens_per_s']:.1f} tokens/s "
        f"over {oss_stats['generate_requests']} concurrent requests, first token of the streamed "
        f"chat after {oss_stats['chat_stream_ttft_s']} s")
    # every gpt-oss layer has sinks: the sink launches less the windowed ones
    # are the full layers'; K3 has no window form and runs on every layer
    for name in ("flash_attn_fwd", "decode_paged_attention"):
        windowed = oss_launches.get(f"{name}/window", 0)
        if min(windowed, oss_launches.get(f"{name}/sinks", 0) - windowed) <= 0:
            raise AssertionError(f"{name} was not launched on both the windowed and the full "
                                 f"layers of the gpt-oss serving path: {oss_launches}")
    # MiniMax-M2's and the gated layers' decode prepares q/k/v outside K3, as
    # the JAX package does; GLM-5's serving prefill runs K5a
    for path, counts in (("MiniMax-M2 serving", minimax_launches),
                         ("MiniMax-M2 reference", minimax_ref_launches),
                         ("Qwen3-Next serving", next_launches),
                         ("Nemotron-H serving", nem_launches),
                         ("Nemotron-H reference", {**nem_ref_launches["train"],
                                                   **nem_ref_launches["serve"]})):
        if counts.get("decode_qkv_prep", 0):
            raise AssertionError(f"K3 launched on the {path} path: {counts}")
    # the rows' launches on the paths of slices 13 and 14: SFT and the Qwen3-MoE
    # trainer (K1, K2a, K2b), Qwen3-30B-A3B and GLM-4.5-Air serving (K1, K3,
    # K4), the MiniMax-M2 trainer (K1, K2a, K2b) and server (K1, K4), the
    # AFMoE and Laguna references (K1, K2a, K2b, K4), GLM-5 serving (K5a)
    gated = {name: {k: counts["train"].get(k, 0) + counts["serve"].get(k, 0)
                    for k in {**counts["train"], **counts["serve"]}}
             for name, counts in gated_launches.items()}
    next_ref, nem_ref = ({k: ref["train"].get(k, 0) + ref["serve"].get(k, 0)
                          for k in {**ref["train"], **ref["serve"]}}
                         for ref in (next_ref_launches, nem_ref_launches))
    vl_ref = {}
    for ref in vl_ref_launches.values():
        for part in ref.values():
            for k, v in part.items():
                vl_ref[k] = vl_ref.get(k, 0) + v
    new_paths = {"launches_sft": sft_launches, "launches_moe_training": moe_train_launches,
                 "launches_moe_serving": moe_launches, "launches_glm_serving": glm_launches,
                 "launches_minimax_training": minimax_train_launches,
                 "launches_minimax_serving": minimax_launches,
                 "launches_afmoe": gated["afmoe"], "launches_laguna": gated["laguna"],
                 "launches_glm5_serving": glm5_launches,
                 "launches_qwen3_next_training": next_train_launches,
                 "launches_qwen3_next_serving": next_launches,
                 "launches_qwen3_next_reference": next_ref,
                 "launches_nemotron_training": nem_train_launches,
                 "launches_nemotron_serving": nem_launches,
                 "launches_nemotron_reference": nem_ref,
                 "launches_lora_training": lora_train_launches,
                 "launches_lora_serving": lora_launches, "launches_lora_loop": lora_loop_launches,
                 "launches_qwen3_vl_training": vl_train_launches,
                 "launches_qwen3_vl_serving": vl_launches,
                 "launches_qwen3_vl_reference": vl_ref,
                 "launches_vlm_loop": vlm_loop_launches}
    k12 = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    path_kernels = {"launches_sft": k12, "launches_moe_training": k12,
                    "launches_moe_serving": ("flash_attn_fwd", "decode_qkv_prep",
                                             "decode_paged_attention"),
                    "launches_glm_serving": ("flash_attn_fwd", "decode_qkv_prep",
                                             "decode_paged_attention"),
                    "launches_minimax_training": k12,
                    "launches_minimax_serving": ("flash_attn_fwd", "decode_paged_attention"),
                    "launches_afmoe": k12 + ("decode_paged_attention",),
                    "launches_laguna": k12 + ("decode_paged_attention",),
                    "launches_glm5_serving": ("sparse_mla_fwd",),
                    "launches_qwen3_next_training": k12,
                    "launches_qwen3_next_serving": ("flash_attn_fwd", "decode_paged_attention"),
                    "launches_qwen3_next_reference": k12 + ("decode_paged_attention",),
                    "launches_nemotron_training": k12,
                    "launches_nemotron_serving": ("flash_attn_fwd", "decode_paged_attention"),
                    "launches_nemotron_reference": k12 + ("decode_paged_attention",),
                    "launches_lora_training": k12,
                    "launches_lora_serving": ("flash_attn_fwd", "decode_paged_attention"),
                    "launches_lora_loop": k12 + ("decode_qkv_prep", "decode_paged_attention"),
                    "launches_qwen3_vl_training": k12,
                    "launches_qwen3_vl_serving": ("flash_attn_fwd", "decode_qkv_prep",
                                                  "decode_paged_attention"),
                    "launches_qwen3_vl_reference": k12 + ("decode_qkv_prep",
                                                          "decode_paged_attention"),
                    "launches_vlm_loop": k12 + ("decode_qkv_prep",)}
    for row in rows:
        name = row["name"]
        for key, kernels in path_kernels.items():
            if name in kernels:
                row[key] = new_paths[key].get(name, 0)
                if row[key] <= 0:
                    raise AssertionError(f"kernel {name} was not launched on its {key[9:]} path")
        on_serving, on_training = launches.get(name, 0), train_launches.get(name, 0)
        kernel = name.split("/")[0]
        if name.endswith("/qwen3-vl"):  # Qwen3-VL-8B's 32/8 heads: its trainer and server
            row["launches"] = (vl_launches if kernel in ("decode_qkv_prep",
                                                         "decode_paged_attention")
                               else vl_train_launches).get(kernel, 0)
            if kernel == "flash_attn_fwd":
                row["launches_serving"] = vl_launches.get(kernel, 0)
        elif name == "decode_qkv_prep/hd32":  # debug_vlm's head dim 32: the VLM loop
            row["launches"] = vlm_loop_launches.get(kernel, 0)
        elif name.endswith(("/hd384", "/hd512", "/wide")):
            # the forms of the range repairs: no in-repo config has these widths,
            # so no main path runs them; the kernel's launches on the path that
            # runs it (K5: the DSA trainer), and the form's own in its phase
            row["launches"] = (dsa_launches if kernel.startswith("sparse_mla")
                               else vl_launches if kernel == "decode_paged_attention"
                               else vl_train_launches).get(kernel, 0)
        elif name.endswith("/hd256"):  # Qwen3-Next's 16/2 heads of 256: its trainer and server
            row["launches"] = (next_launches if kernel == "decode_paged_attention"
                               else next_train_launches).get(kernel, 0)
            if kernel == "flash_attn_fwd":
                row["launches_serving"] = next_launches.get(kernel, 0)
        elif name.endswith("/nemotron-h"):  # Nemotron-H-8B's 32/8 heads: trainer and server
            row["launches"] = (nem_launches if kernel == "decode_paged_attention"
                               else nem_train_launches).get(kernel, 0)
            if kernel == "flash_attn_fwd":
                row["launches_serving"] = nem_launches.get(kernel, 0)
        elif name.endswith("/group6"):  # MiniMax-M2's 48/8 heads: its trainer and server
            row["launches"] = (minimax_launches if kernel == "decode_paged_attention"
                               else minimax_train_launches).get(kernel, 0)
            if kernel == "flash_attn_fwd":
                row["launches_serving"] = minimax_launches.get(kernel, 0)
        elif name.endswith("/window-hd128"):  # the AFMoE and Laguna references
            row["launches"] = sum(g.get(f"{kernel}/window", 0) for g in gated.values())
        elif name == "sparse_mla_fwd/serving":  # GLM-5's serving prefill
            row["launches"] = glm5_launches.get(kernel, 0)
        elif name == "decode_paged_attention/group8":  # Qwen3-30B-A3B's 32/4 heads
            row["launches"] = moe_launches.get("decode_paged_attention", 0)
        elif name == "decode_paged_attention/group12":  # GLM-4.5-Air's 96/8: two chunks
            row["launches"] = glm_launches.get("decode_paged_attention/chunked", 0)
        elif name == "flash_attn_fwd":  # K1 runs on both paths
            row["launches"], row["launches_training"] = on_serving, on_training
            if min(on_serving, on_training) <= 0:
                raise AssertionError("kernel flash_attn_fwd was not launched on both paths")
        elif name.startswith("sparse_mla"):
            row["launches"] = dsa_launches.get(name, 0)
        elif name == "flash_attn_fwd/window+sinks":  # gpt-oss serving and training
            row["launches"] = oss_launches.get("flash_attn_fwd/sinks", 0)
            row["launches_window"] = oss_launches.get("flash_attn_fwd/window", 0)
            row["launches_training"] = oss_train_launches.get("flash_attn_fwd/sinks", 0)
            if min(row["launches_window"], row["launches_training"]) <= 0:
                raise AssertionError(f"{name} was not launched on both gpt-oss paths")
        elif name.startswith("flash_attn_bwd"):
            if "/" in name:  # gpt-oss training
                row["launches"] = oss_train_launches.get(kernel, 0)
                row["launches_window"] = oss_train_launches.get(name, 0)
                if row["launches_window"] <= 0:
                    raise AssertionError(f"{name}: no windowed launch on the gpt-oss path")
            else:
                row["launches"] = on_training
        elif name == "decode_qkv_prep/gpt-oss":
            row["launches"] = oss_launches.get("decode_qkv_prep", 0)
        elif name == "decode_paged_attention/window+sinks":
            row["launches"] = oss_launches.get("decode_paged_attention/sinks", 0)
            row["launches_window"] = oss_launches.get("decode_paged_attention/window", 0)
        else:
            row["launches"] = on_serving + on_training
        if row["launches"] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the path that runs it")
        if name in LOOP_KERNELS:
            row["launches_loop"] = loop_launches[name]
        if name == "decode_qkv_prep":  # absent on the bank path: checked to be 0
            row["launches_lora_serving"] = lora_launches.get(name, 0)
    log(f"launches on the serving path: {launches}")
    log(f"launches on the training path: {train_launches}")
    log(f"launches on the DSA training path: {dsa_launches}")
    log(f"launches on the gpt-oss training path: {oss_train_launches}")
    log(f"launches on the gpt-oss serving path: {oss_launches}")
    log(f"launches on the SFT path: {sft_launches}")
    log(f"launches on the Qwen3-MoE training path: {moe_train_launches}")
    log(f"launches on the Qwen3-30B-A3B serving path: {moe_launches}")
    log(f"launches on the GLM-4.5-Air serving path: {glm_launches}")
    log(f"serving stats: {json.dumps(stats)}")
    log(f"gpt-oss serving stats: {json.dumps(oss_stats)}")
    log(f"sft on {card}: {json.dumps(sft_numbers)}")
    log(f"qwen3-moe training on {card}: {json.dumps(moe_train_numbers)}")
    log(f"Qwen3-30B-A3B serving stats on {card}: {json.dumps(moe_stats)}")
    log(f"GLM-4.5-Air (4 layers) serving stats on {card}: {json.dumps(glm_stats)}")
    log(f"launches on the MiniMax-M2 training path: {minimax_train_launches}")
    log(f"launches on the MiniMax-M2 serving path: {minimax_launches}")
    log(f"launches on the AFMoE and Laguna reference paths: {json.dumps(gated_launches)}")
    log(f"launches on the GLM-5 serving path: {glm5_launches}")
    log(f"minimax training on {card}: {json.dumps(minimax_train_numbers)}")
    log(f"MiniMax-M2 ({MINIMAX_SERVE_LAYERS} layers) serving stats on {card}: "
        f"{json.dumps(minimax_stats)}")
    log(f"GLM-5 ({GLM5_CUTS['num_hidden_layers']} layers) serving stats on {card}: "
        f"{json.dumps(glm5_stats)}")
    log(f"launches on the Qwen3-Next reference paths: {json.dumps(next_ref_launches)}")
    log(f"launches on the Qwen3-Next training path: {next_train_launches}")
    log(f"launches on the Qwen3-Next serving path: {next_launches}")
    log(f"qwen3-next training on {card}: {json.dumps(next_train_numbers)}")
    log(f"Qwen3-Next ({QWEN3_NEXT_SERVE_LAYERS} layers) serving stats on {card}: "
        f"{json.dumps(next_stats)}")
    log(f"launches on the Nemotron-H reference paths: {json.dumps(nem_ref_launches)}")
    log(f"launches on the Nemotron-H training path: {nem_train_launches}")
    log(f"launches on the Nemotron-H serving path: {nem_launches}")
    log(f"nemotron-h training on {card}: {json.dumps(nem_train_numbers)}")
    log(f"Nemotron-H ({NEMOTRON_SERVE_LAYERS} layers) serving stats on {card}: "
        f"{json.dumps(nem_stats)}")
    log(f"launches on the LoRA training path: {lora_train_launches}")
    log(f"launches on the multi-LoRA serving path: {lora_launches}")
    log(f"launches on the LoRA loop's colocated process: {lora_loop_launches}")
    log(f"lora training on {card}: {json.dumps(lora_train_numbers)}")
    log(f"multi-LoRA serving stats on {card}: {json.dumps(lora_stats)}")
    log(f"launches on the Qwen3-VL reference paths: {json.dumps(vl_ref_launches)}")
    log(f"launches on the Qwen3-VL training path: {vl_train_launches}")
    log(f"launches on the Qwen3-VL serving path: {vl_launches}")
    log(f"launches on the VLM loop's colocated process: {vlm_loop_launches}")
    log(f"qwen3-vl training on {card}: {json.dumps(vl_train_numbers)}")
    log(f"Qwen3-VL-8B serving stats on {card}: {json.dumps(vl_stats)}")
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build on")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
