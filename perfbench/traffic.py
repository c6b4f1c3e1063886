"""The one generator of every traffic mix: a mix is a data file of parameters.

Lengths come from a fixed grid over the mix's range (``length_grid``
points, uniform or log-uniform), so every seed sends the same sizes and
only their order and the token ids change with it: the work of a run does
not depend on its seed.

* ``train``: documents of ``doc_tokens`` lengths, their token ids uniform
  over the vocabulary, packed by the program's own writer into shards.
* ``serve``: waves of ``batch`` requests with ``prompt_tokens`` lengths and
  ``new_tokens`` output lengths, each on a grid of its own.  Each grid is
  dealt into waves by strata (wave w of a block of W = grid/batch waves
  takes grid points w, w + W, w + 2W, ...), so the set of waves, and each
  wave's longest prompt and longest answer, is the same for every seed; the
  seed orders the waves of each block and pairs prompts with answers in a
  wave.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def grid(lo: int, hi: int, n: int, dist: str = "uniform") -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    if dist == "log_uniform":
        x = lo * (hi / lo) ** q
    elif dist == "uniform":
        x = lo + (hi - lo) * q
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(x).astype(np.int64), lo, hi)


def documents(mix: Dict, vocab: int, seed: int, n_tokens: int) -> List[np.ndarray]:
    """Documents of int32 token ids, at least ``n_tokens`` in all."""
    r = rng(seed, 1)
    lengths = grid(*mix["doc_tokens"], mix["length_grid"], mix.get("length_dist", "uniform"))
    docs, total = [], 0
    while total < n_tokens:
        for n in r.permutation(lengths):
            docs.append(r.integers(0, vocab, int(n), dtype=np.int32))
            total += int(n)
    return docs


def _dealt(lo_hi, n: int, dist: str, b: int) -> np.ndarray:
    g = grid(*lo_hi, n, dist)
    if len(g) % b:
        raise ValueError(f"length_grid {len(g)} is not a multiple of the batch {b}")
    return g.reshape(b, len(g) // b).T


def wave_lengths(mix: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """[waves, batch] prompt lengths and output lengths of one block, before
    the seed's order."""
    n, b = mix["length_grid"], mix["batch"]
    return (_dealt(mix["prompt_tokens"], n, mix.get("length_dist", "uniform"), b),
            _dealt(mix["new_tokens"], n, mix.get("new_dist", "uniform"), b))


def waves(mix: Dict, vocab: int, seed: int) -> Iterator[Tuple[List[np.ndarray], List[int]]]:
    """Waves of (prompts of int32 token ids, their output lengths), without end."""
    r = rng(seed, 2)
    prompts, news = wave_lengths(mix)
    while True:
        for w in r.permutation(len(prompts)):
            yield ([r.integers(0, vocab, int(n), dtype=np.int32) for n in r.permutation(prompts[w])],
                   [int(n) for n in r.permutation(news[w])])
