"""Trial pruners: asynchronous successive halving (ASHA) and no-op
(counterpart of `miseg_tpu/hpo/pruners.py`, the same arithmetic).

Reference parity: Optuna `SuccessiveHalvingPruner(min_resource=
4*check_val_every_n_epoch, reduction_factor=3)` (tune.py:314-315) — a
trial reaching rung k (resource = min_resource * rf^k, reached when
`step + 1 >= resource`) survives only if its best intermediate value is
at least the `ceil(n / rf) - 1`-th best (0-based) of the n trials'
values at that rung.
"""

from __future__ import annotations

import math


class NopPruner:
    def prune(self, study, trial) -> bool:
        return False


class SuccessiveHalvingPruner:
    def __init__(self, min_resource: int = 1, reduction_factor: int = 3,
                 min_early_stopping_rate: int = 0):
        self.min_resource = max(1, int(min_resource))
        self.rf = int(reduction_factor)
        self.s = int(min_early_stopping_rate)

    def _rung(self, step: int) -> int | None:
        """Highest rung whose resource the step has reached, or None."""
        rung = None
        k = 0
        while True:
            resource = self.min_resource * (self.rf ** (k + self.s))
            if step + 1 < resource:
                break
            rung = k
            k += 1
        return rung

    def prune(self, study, trial) -> bool:
        if not trial.intermediate:
            return False
        step, value = max(trial.intermediate.items())
        rung = self._rung(step)
        if rung is None:
            return False
        # competitors: best value each other trial had reached by this rung's
        # resource (higher = better; study normalizes direction)
        resource = self.min_resource * (self.rf ** (rung + self.s))
        competitors = []
        for t in study.trials:
            vals = [v for s, v in t.intermediate.items() if s + 1 <= resource]
            if vals:
                competitors.append(max(vals))
        if len(competitors) < self.rf:
            return False
        competitors.sort(reverse=True)
        cutoff_idx = max(0, int(math.ceil(len(competitors) / self.rf)) - 1)
        cutoff = competitors[cutoff_idx]
        my_best = max(v for s, v in trial.intermediate.items() if s + 1 <= resource)
        return my_best < cutoff
