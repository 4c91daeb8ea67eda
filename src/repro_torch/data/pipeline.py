"""Deterministic, resumable synthetic LM data pipeline (port of
`repro.data.pipeline`).

Batches are a pure function of (seed, step): after a restart the loop resumes
at step k and the pipeline regenerates exactly the batch it would have seen.
Token streams are Zipf-distributed with a next-token structure (labels =
tokens shifted), so small models learn and loss curves mean something.  The
arithmetic is numpy's, draw for draw the reference's, so a batch is
bit-equal to the reference's for every architecture; batches stay numpy and
the training loop moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLMData"]


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    vocab_cap: int = 0  # 0: full vocab

    def __post_init__(self):
        self.vocab = self.vocab_cap or self.cfg.vocab_size
        # fixed bigram transition structure so there is signal to learn
        rng = np.random.default_rng(self.seed)
        self._shift = rng.integers(1, self.vocab, size=self.vocab)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.batch, self.seq
        cfg = self.cfg
        # Zipf-ish marginal + deterministic bigram: t_{i+1} = shift[t_i] w.p. 0.5
        z = rng.zipf(1.3, size=(B, S)).clip(max=self.vocab) - 1
        toks = np.empty((B, S), dtype=np.int64)
        toks[:, 0] = z[:, 0]
        follow = rng.random((B, S)) < 0.5
        for i in range(1, S):
            toks[:, i] = np.where(
                follow[:, i], self._shift[toks[:, i - 1]], z[:, i]
            )
        tokens = toks.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1
        )
        out = {"tokens": tokens, "labels": labels}
        if cfg.encdec or cfg.frontend == "frame":
            out["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32
            )
        elif cfg.frontend == "patch":
            P = cfg.frontend_len
            out["embeds"] = rng.standard_normal(
                (B, P, cfg.d_model), dtype=np.float32
            )
            out["tokens"] = tokens[:, : S - P]
            # labels span patch+text positions; patches are ignored
            out["labels"] = np.concatenate(
                [np.full((B, P), -100, np.int32), labels[:, : S - P]], axis=1
            )
        return out
