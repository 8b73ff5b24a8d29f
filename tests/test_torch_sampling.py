"""Sampled decoding: the port's ``select_token`` and JAX's draw the same
distribution.

The port draws from a ``torch.Generator`` (argmax of p / E, E ~ Exp(1));
JAX draws with ``jax.random.categorical`` from threefry keys. The bits
differ by design, so no draw is compared with another. Instead, for
temperature, top-k and top-p alone and combined, both packages draw
``N_DRAWS`` tokens from fixed seeds over one row of logits, and:

  * no token outside the filtered support appears in either package;
  * each histogram passes a chi-square test against the exact filtered
    softmax, computed in numpy (float64), at significance ``ALPHA``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from livecc_tpu.engine.generation import GenerationParams as JaxGenerationParams
from livecc_tpu.engine.generation import select_token as jax_select_token
from livecc_tpu_torch.engine.generation import GenerationParams, select_token
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 12
N_DRAWS = 20_000
JAX_SPLITS = 20            # keys from jax.random.split, N_DRAWS / JAX_SPLITS rows each
ALPHA = 1e-3

CASES = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=4),
    "top_p": dict(top_p=0.8),
    "combined": dict(temperature=1.3, top_k=6, top_p=0.9),
}


def logits_row() -> np.ndarray:
    return (np.random.RandomState(0).randn(VOCAB) * 1.5).astype(np.float32)


def filtered_probs(logits: np.ndarray, temperature=1.0, top_k=0, top_p=1.0) -> np.ndarray:
    """The exact distribution ``select_token`` samples: softmax over the
    tokens that survive temperature, then top-k, then top-p (the smallest
    prefix of the sorted tokens whose cumulative probability reaches
    top_p)."""
    x = logits.astype(np.float64) / max(temperature, 1e-6)
    keep = np.ones(len(x), bool)
    if top_k > 0:
        keep &= x >= np.sort(x)[-top_k]
    if top_p < 1.0:
        order = np.argsort(-np.where(keep, x, -np.inf))
        p = np.exp(x[order] - x[order][0]) * keep[order]
        cum = np.cumsum(p / p.sum())
        cutoff = x[order][int(np.sum(cum < top_p))]
        keep &= x >= cutoff
    p = np.where(keep, np.exp(x - x.max()), 0.0)
    return p / p.sum()


def chi_square_p(counts: np.ndarray, probs: np.ndarray) -> float:
    support = probs > 0
    expected = probs[support] * counts.sum()
    stat = float(np.sum((counts[support] - expected) ** 2 / expected))
    return float(stats.chi2.sf(stat, int(support.sum()) - 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_tokens_follow_the_filtered_softmax_in_both_packages(case):
    settings = CASES[case]
    row = logits_row()
    probs = filtered_probs(row, **settings)
    assert 1 < (probs > 0).sum() < VOCAB or case == "temperature"

    gen = dataclasses.replace(GenerationParams(), do_sample=True, **settings)
    port = select_token(torch.from_numpy(np.tile(row, (N_DRAWS, 1))), gen,
                        torch.Generator().manual_seed(0)).numpy()

    jgen = dataclasses.replace(JaxGenerationParams(), do_sample=True, **settings)
    rows = jnp.asarray(np.tile(row, (N_DRAWS // JAX_SPLITS, 1)))
    draw = jax.jit(lambda key: jax_select_token(rows, jgen, key))
    ref = np.concatenate([np.asarray(draw(k)) for k in
                          jax.random.split(jax.random.PRNGKey(0), JAX_SPLITS)])

    for name, tokens in (("port", port), ("jax", ref)):
        assert tokens.shape == (N_DRAWS,)
        counts = np.bincount(tokens, minlength=VOCAB)
        outside = counts[probs == 0].sum()
        assert outside == 0, f"{name}: {outside} draws outside the filtered support"
        p = chi_square_p(counts, probs)
        assert p > ALPHA, f"{name}: chi-square p = {p:.2e} against the filtered softmax"
