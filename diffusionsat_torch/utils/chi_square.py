"""Chi-square uniformity likelihood over sample-count dicts.

Counterpart of the TPU package's `utils/chi_square.py`, the port of
reference `utils/chi_square.py:7-36`: align two {solution: count}
dicts onto one support and return the chi-square p-value.
"""

from __future__ import annotations

from scipy import stats


def chi_square_likelihood(observed: dict, expected: dict) -> float:
    if len(observed) == 1 and len(expected) == 1:
        return 1.0
    ids = list(dict.fromkeys(list(expected.keys()) + list(observed.keys())))
    idx = {k: i for i, k in enumerate(ids)}
    obs = [0.0] * len(ids)
    exp = [0.0] * len(ids)
    for k, v in observed.items():
        obs[idx[k]] += v
    for k, v in expected.items():
        exp[idx[k]] += v
    # scipy requires equal sums; rescale expected to the observed mass
    total_obs = sum(obs)
    total_exp = sum(exp)
    if total_exp == 0 or total_obs == 0:
        return 0.0
    exp = [e * total_obs / total_exp for e in exp]
    _, p = stats.chisquare(obs, exp)
    return float(p)


def ideal_counts(n_solutions: int, n_samples: int) -> dict[int, float]:
    """Uniform expectation: every solution drawn n_samples/n_solutions times."""
    per = n_samples / max(n_solutions, 1)
    return {i: per for i in range(n_solutions)}
