"""The MICA KVS workload (§5.6): Zipf key popularity over a key space.

``ZipfKVWorkload`` draws zipf-skewed keys (s = 0.99 / 0.9999), tiny
(8B/8B) or small (16B/32B) records and a set/get mix (50/50 or 5/95).
Pure numpy on the host, like the reference's ``repro.data.pipeline``;
its draws equal the reference's for the same seed.

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
