"""Data pipelines: synthetic LM batches and the MICA KVS workload.

``SyntheticLMData`` is deterministic per (seed, step): a restart after a
failure regenerates the exact same batch stream, which is what makes
checkpoint/restart bitwise reproducible.  Tokens follow a Markov-ish
mixture so the LM loss curve is non-trivial (structure to learn) rather
than uniform noise.  Its batches equal the reference's bit for bit.

``ZipfKVWorkload`` (§5.6) draws zipf-skewed keys (s = 0.99 / 0.9999),
tiny (8B/8B) or small (16B/32B) records and a set/get mix (50/50 or
5/95).

Both are pure numpy on the host, like the reference's
``repro.data.pipeline``; their draws equal the reference's for the same
seed.

``zipf_keys`` keeps the reference's draws but not its cost: numpy's
``Generator.choice(n, p=...)`` builds ``cdf = p.cumsum(); cdf /=
cdf[-1]`` on every call, then takes one ``rng.random`` per draw and a
right ``searchsorted``.  At millions of keys that rebuild costs tens of
ms per batch, so the CDF is built once per ``(n_keys, s)`` and the same
two steps run on it — the same uniforms, the same indices.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from repro_torch.config import ModelConfig


class SyntheticLMData:
    """Batches of ``batch`` x ``seq`` tokens (and the model's frontend or
    encoder features) as numpy arrays, a pure function of (seed, step)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        # fixed "grammar": each token prefers a successor band.  Host
        # generator, fully determined by seed  # fabriclint: allow(FL003)
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, cfg.vocab, size=(256,), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given global step: ``tokens`` and
        ``labels`` [batch, seq] int32, ``frontend_feats`` (a vision
        prefix) or ``enc_feats`` (an encoder) [batch, frontend_tokens,
        frontend_dim] float32."""
        # pure in (seed, step) by construction — the reproducibility
        # contract FL003 protects  # fabriclint: allow(FL003)
        rng = np.random.default_rng((self.seed << 32) ^ step)
        v = self.cfg.vocab
        toks = np.empty((self.batch, self.seq), np.int64)
        toks[:, 0] = rng.integers(0, v, size=self.batch)
        noise = rng.random((self.batch, self.seq))
        jumps = rng.integers(0, v, size=(self.batch, self.seq))
        for t in range(1, self.seq):
            follow = (self._succ[toks[:, t - 1] % 256] + toks[:, t - 1]) % v
            toks[:, t] = np.where(noise[:, t] < 0.75, follow, jumps[:, t])
        batch = {"tokens": toks.astype(np.int32),
                 "labels": toks.astype(np.int32)}
        if self.cfg.frontend and not self.cfg.enc_layers:
            batch["frontend_feats"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_tokens,
                 self.cfg.frontend_dim)).astype(np.float32)
        if self.cfg.enc_layers:
            batch["enc_feats"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_tokens,
                 self.cfg.frontend_dim)).astype(np.float32)
        return batch

    def shard_for(self, step: int, shard: int, n_shards: int) -> dict:
        """Deterministic per-host shard (multi-host input pipeline)."""
        full = self.batch_at(step)
        per = self.batch // n_shards
        return {k: v[shard * per:(shard + 1) * per] for k, v in full.items()}


@functools.lru_cache(maxsize=4)
def _zipf_cdf(n_keys: int, s: float) -> np.ndarray:
    """The normalised CDF ``Generator.choice`` builds from the reference's
    pmf (read-only: every caller shares it)."""
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    probs = ranks ** -s
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    cdf.flags.writeable = False
    return cdf


def zipf_keys(n: int, n_keys: int, s: float, rng) -> np.ndarray:
    """Zipf-distributed key ids in [0, n_keys) (rank-frequency s): the
    draws of ``rng.choice(n_keys, size=n, p=pmf)``."""
    u = rng.random(n)
    return _zipf_cdf(int(n_keys), float(s)).searchsorted(
        u, side="right").astype(np.int64)


@dataclass
class ZipfKVWorkload:
    n_keys: int = 10000
    skew: float = 0.99
    set_fraction: float = 0.5        # 0.5 = write-intense, 0.05 = read-intense
    key_bytes: int = 8               # tiny: 8B keys / 8B values
    value_bytes: int = 8             # small: 16B / 32B
    seed: int = 0

    def batches(self, batch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """Endless ``(keys, is_set, key_words, val_words)`` batches."""
        # host KVS workload generator, seeded  # fabriclint: allow(FL003)
        rng = np.random.default_rng(self.seed)
        kw = max(1, self.key_bytes // 4)
        vw = max(1, self.value_bytes // 4)
        while True:
            keys = zipf_keys(batch, self.n_keys, self.skew, rng)
            is_set = rng.random(batch) < self.set_fraction
            key_words = np.zeros((batch, kw), np.int32)
            key_words[:, 0] = (keys & 0x7FFFFFFF).astype(np.int32)
            if kw > 1:
                key_words[:, 1] = (keys >> 31).astype(np.int32)
            val_words = rng.integers(0, 2 ** 31 - 1,
                                     size=(batch, vw)).astype(np.int32)
            yield keys, is_set, key_words, val_words
