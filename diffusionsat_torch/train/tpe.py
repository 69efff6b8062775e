"""Tree-structured Parzen Estimator (TPE) hyperparameter sampler.

Counterpart of the TPU package's `train/tpe.py`, host numpy over the same
stream, so equal seeds and equal observations give equal suggestions.
After a few random startup trials, observed trials are split into the top
`gamma` fraction ("good") and the rest ("bad"); per dimension a Parzen
(kernel-density) estimator is fit to each group, candidates are drawn from
the good density and ranked by the density ratio l(x)/g(x), the
expected-improvement-maximizing rule of Bergstra et al., "Algorithms for
Hyper-Parameter Optimization" (NeurIPS 2011).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float


@dataclass(frozen=True)
class LogUniform:
    lo: float
    hi: float


@dataclass(frozen=True)
class IntUniform:
    lo: int
    hi: int  # inclusive


@dataclass(frozen=True)
class Choice:
    options: tuple

    def __init__(self, options):
        object.__setattr__(self, "options", tuple(options))


def _to_internal(dim, v):
    if isinstance(dim, LogUniform):
        return math.log(v)
    if isinstance(dim, (Uniform, IntUniform)):
        return float(v)
    return dim.options.index(v)


def _from_internal(dim, x):
    if isinstance(dim, LogUniform):
        return float(np.clip(math.exp(x), dim.lo, dim.hi))
    if isinstance(dim, Uniform):
        return float(np.clip(x, dim.lo, dim.hi))
    if isinstance(dim, IntUniform):
        return int(np.clip(round(x), dim.lo, dim.hi))
    return dim.options[int(x)]


class _ParzenNumeric:
    """1-D Gaussian mixture over observed points + a uniform prior blob."""

    def __init__(self, xs, lo, hi):
        xs = np.asarray(xs, dtype=np.float64)
        self.lo, self.hi = lo, hi
        span = max(hi - lo, 1e-12)
        # bandwidth: span scaled by sample count (Optuna's "normal" rule)
        sigma = span / max(np.sqrt(len(xs)), 1.0)
        self.mus = np.concatenate([xs, [(lo + hi) / 2]])
        self.sigmas = np.concatenate(
            [np.full(len(xs), max(sigma, 1e-9)), [span]])
        self.weights = np.full(len(self.mus), 1.0 / len(self.mus))

    def sample(self, rng, n):
        idx = rng.choice(len(self.mus), size=n, p=self.weights)
        x = rng.normal(self.mus[idx], self.sigmas[idx])
        return np.clip(x, self.lo, self.hi)

    def logpdf(self, x):
        x = np.asarray(x, dtype=np.float64)[:, None]
        z = (x - self.mus[None, :]) / self.sigmas[None, :]
        comp = -0.5 * z * z - np.log(self.sigmas[None, :] *
                                     math.sqrt(2 * math.pi))
        m = comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(
            (self.weights[None, :] * np.exp(comp - m)).sum(axis=1)))


class _ParzenCategorical:
    def __init__(self, xs, n_options):
        counts = np.ones(n_options)  # add-one smoothing (uniform prior)
        for x in xs:
            counts[int(x)] += 1.0
        self.p = counts / counts.sum()

    def sample(self, rng, n):
        return rng.choice(len(self.p), size=n, p=self.p)

    def logpdf(self, x):
        return np.log(self.p[np.asarray(x, dtype=int)])


class TPESampler:
    """suggest()/observe() loop; maximizes the observed objective."""

    def __init__(self, space: dict, seed: int = 0, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.trials: list[tuple[dict, float]] = []

    def _random_point(self) -> dict:
        out = {}
        for k, dim in self.space.items():
            if isinstance(dim, LogUniform):
                out[k] = float(np.exp(self.rng.uniform(
                    math.log(dim.lo), math.log(dim.hi))))
            elif isinstance(dim, Uniform):
                out[k] = float(self.rng.uniform(dim.lo, dim.hi))
            elif isinstance(dim, IntUniform):
                out[k] = int(self.rng.integers(dim.lo, dim.hi + 1))
            else:
                out[k] = dim.options[self.rng.integers(len(dim.options))]
        return out

    def _bounds(self, dim):
        if isinstance(dim, LogUniform):
            return math.log(dim.lo), math.log(dim.hi)
        if isinstance(dim, Uniform):
            return dim.lo, dim.hi
        return float(dim.lo), float(dim.hi)

    def suggest(self) -> dict:
        if len(self.trials) < self.n_startup:
            return self._random_point()
        ranked = sorted(self.trials, key=lambda t: -t[1])
        n_good = max(2, int(np.ceil(self.gamma * len(ranked))))
        good, bad = ranked[:n_good], ranked[n_good:]
        out = {}
        for k, dim in self.space.items():
            gx = [_to_internal(dim, t[0][k]) for t in good]
            bx = [_to_internal(dim, t[0][k]) for t in bad] or gx
            if isinstance(dim, Choice):
                l = _ParzenCategorical(gx, len(dim.options))
                g = _ParzenCategorical(bx, len(dim.options))
            else:
                lo, hi = self._bounds(dim)
                l = _ParzenNumeric(gx, lo, hi)
                g = _ParzenNumeric(bx, lo, hi)
            cand = l.sample(self.rng, self.n_candidates)
            score = l.logpdf(cand) - g.logpdf(cand)
            out[k] = _from_internal(dim, cand[int(np.argmax(score))])
        return out

    def observe(self, params: dict, value: float) -> None:
        self.trials.append((dict(params), float(value)))

    @property
    def best(self) -> tuple[dict, float] | None:
        if not self.trials:
            return None
        return max(self.trials, key=lambda t: t[1])


class RandomSampler:
    """Baseline: pure random search over the same space API."""

    def __init__(self, space: dict, seed: int = 0):
        self._tpe = TPESampler(space, seed=seed, n_startup=1 << 30)

    def suggest(self) -> dict:
        return self._tpe._random_point()

    def observe(self, params: dict, value: float) -> None:
        self._tpe.observe(params, value)

    @property
    def best(self):
        return self._tpe.best
