"""Per-step JSONL export of per-token training tensors for offline analysis
(the port of the JAX package's ``trainer/rl/token_export.py``, numpy only):
one record a packed row that holds a loss-masked token, with its token ids,
inference logprobs and advantages at those tokens (rounded to 5 decimals),
at most ``max_rows_per_step`` of them, then a ``.STABLE`` marker beside the
file. The bytes are the JAX package's for the same host batch."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class TokenExporter:
    def __init__(self, output_dir: str | Path, max_rows_per_step: int = 64):
        self.dir = Path(output_dir) / "token_export"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_rows = max_rows_per_step

    def export(self, step: int, batch) -> Path:
        """``batch``: the step's host ``MicroBatchArrays`` [N, B, L]. Writes
        ``token_export/step_{step}.jsonl`` and its ``.STABLE`` marker."""
        path = self.dir / f"step_{step}.jsonl"
        rows = 0
        with open(path, "w") as f:
            n, b, _ = batch.input_ids.shape
            for i in range(n):
                for j in range(b):
                    if rows >= self.max_rows:
                        break
                    mask = np.asarray(batch.loss_mask[i, j], bool)
                    if not mask.any():
                        continue
                    inf_lp = np.asarray(batch.inference_logprobs[i, j], np.float32)
                    rec = {
                        "micro_batch": i,
                        "row": j,
                        "token_ids": np.asarray(batch.input_ids[i, j])[mask].tolist(),
                        "inference_logprobs": inf_lp[mask].round(5).tolist(),
                        "advantages": np.asarray(batch.advantages[i, j])[mask].round(5).tolist(),
                    }
                    f.write(json.dumps(rec) + "\n")
                    rows += 1
        path.with_suffix(".STABLE").touch()
        return path
