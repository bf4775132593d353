"""Hyper-parameter samplers: TPE and random (counterpart of
`miseg_tpu/hpo/samplers.py`: the same draws from
`np.random.default_rng(seed)` in the same order, so the same history
gives the same suggestion, bit for bit).

The reference drives HPO with Optuna's `TPESampler` (tune.py:308-326).
Optuna is not needed: a Tree-structured Parzen Estimator over
independent 1-d distributions — completed trials are split into
good/bad by the γ quantile of the objective, each group is modeled with
a Parzen (KDE) mixture, and candidates maximize l(x)/g(x).  Falls back
to random draws until `n_startup_trials` complete (Optuna's default).
"""

from __future__ import annotations

import math

import numpy as np


class _Dist:
    """1-d search distribution with transforms to an unbounded space."""

    def __init__(self, kind: str, low=None, high=None, choices=None,
                 log: bool = False, step=None):
        self.kind = kind  # float | int | categorical
        self.low, self.high, self.choices, self.log, self.step = \
            low, high, choices, log, step

    def key(self):
        return (self.kind, self.low, self.high,
                tuple(self.choices) if self.choices else None, self.log)

    def to_internal(self, v):
        if self.kind == "categorical":
            return float(self.choices.index(v))
        x = float(v)
        return math.log(x) if self.log else x

    def from_internal(self, x):
        if self.kind == "categorical":
            return self.choices[int(np.clip(round(x), 0, len(self.choices) - 1))]
        v = math.exp(x) if self.log else x
        lo, hi = self.low, self.high
        v = min(max(v, lo), hi)
        return int(round(v)) if self.kind == "int" else v

    def sample_uniform(self, rng: np.random.Generator):
        if self.kind == "categorical":
            return self.choices[int(rng.integers(len(self.choices)))]
        lo, hi = self.low, self.high
        if self.log:
            return self.from_internal(rng.uniform(math.log(lo), math.log(hi)))
        v = rng.uniform(lo, hi)
        return int(round(v)) if self.kind == "int" else v


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, name: str, dist: _Dist, history: list[tuple[dict, float]]):
        return dist.sample_uniform(self.rng)


class TPESampler:
    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    def sample(self, name: str, dist: _Dist,
               history: list[tuple[dict, float]]):
        """history: [(params_dict, objective_value)] of COMPLETED trials,
        higher objective = better (the study negates for minimize)."""
        obs = [(p[name], v) for p, v in history if name in p]
        if len(obs) < self.n_startup_trials:
            return dist.sample_uniform(self.rng)
        xs = np.array([dist.to_internal(o) for o, _ in obs])
        vals = np.array([v for _, v in obs])
        n_good = max(1, int(np.ceil(self.gamma * len(obs))))
        order = np.argsort(-vals)  # best first
        good, bad = xs[order[:n_good]], xs[order[n_good:]]
        if bad.size == 0:
            bad = xs

        if dist.kind == "categorical":
            k = len(dist.choices)
            # weighted category counts with add-one smoothing
            pg = np.bincount(good.astype(int), minlength=k) + 1.0
            pb = np.bincount(bad.astype(int), minlength=k) + 1.0
            pg, pb = pg / pg.sum(), pb / pb.sum()
            # sample FROM the smoothed l/g ratio distribution (not
            # argmax over it): a dominated category keeps a small but
            # non-zero draw probability, so exploration never locks out
            # permanently after startup (Optuna's TPE keeps exploring
            # through its smoothed proposal distribution the same way).
            score = pg / pb
            probs = score / score.sum()
            return dist.choices[int(self.rng.choice(k, p=probs))]

        lo = dist.to_internal(dist.low)
        hi = dist.to_internal(dist.high)
        span = max(hi - lo, 1e-12)
        bw_good = max(span * 1.06 * good.size ** -0.2, 1e-3 * span)

        def kde_logpdf(x, data):
            if data.size == 0:
                return np.full_like(x, -1e9)
            bw = max(span * 1.06 * data.size ** -0.2, 1e-3 * span)
            d = (x[:, None] - data[None, :]) / bw
            return (np.log(np.mean(np.exp(-0.5 * d * d), axis=1) + 1e-300)
                    - math.log(bw * math.sqrt(2 * math.pi)))

        # candidates drawn FROM l(x) (the good-KDE mixture: pick a good
        # observation, jitter by its bandwidth — TPE's own proposal
        # distribution), plus a small uniform floor for exploration
        n_l = max(1, int(0.75 * self.n_candidates))
        centers = good[self.rng.integers(good.size, size=n_l)]
        cands = np.concatenate([
            centers + self.rng.normal(0, bw_good, n_l),
            self.rng.uniform(lo, hi, self.n_candidates - n_l)])
        cands = np.clip(cands, lo, hi)
        score = kde_logpdf(cands, good) - kde_logpdf(cands, bad)
        return dist.from_internal(float(cands[int(np.argmax(score))]))
