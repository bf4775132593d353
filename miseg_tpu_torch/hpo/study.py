"""Study orchestration with resumable JSONL journal storage (counterpart
of `miseg_tpu/hpo/study.py`, record for record).

Reference parity (tune.py:308-353): `optuna.create_study(sampler=TPE,
pruner=SuccessiveHalving, storage=..., load_if_exists=True)` +
`study.optimize(objective, n_trials, timeout)`.  Storage is a JSONL
journal (the Optuna `JournalStorage(JournalFileStorage)` analog,
tune.py:331-335): every trial state change is an appended record
(`study` direction, only on a new journal; `create`, `param`, `report`,
`finish`), so a re-submitted job resumes the same study
(`load_if_exists`), whichever package began it, and concurrent workers
on a shared filesystem can cooperate (appends are O_APPEND + flock).
A pruned trial is told its best intermediate value, un-normalised.
"""

from __future__ import annotations

import fcntl
import json
import time
from pathlib import Path
from typing import Any, Callable

from .pruners import NopPruner
from .samplers import TPESampler, _Dist


class TrialPruned(Exception):
    pass


class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: dict[str, Any] = {}
        self.intermediate: dict[int, float] = {}
        self.value: float | None = None
        self.state = "running"

    # ------------------------------------------------------------ suggest

    def _suggest(self, name: str, dist: _Dist):
        if name in self.params:
            return self.params[name]
        val = self.study.sampler.sample(name, dist, self.study._history())
        self.params[name] = val
        self.study.storage.record({"op": "param", "trial": self.number,
                                   "name": name, "value": val})
        return val

    def suggest_float(self, name, low, high, *, log: bool = False):
        return float(self._suggest(name, _Dist("float", low, high, log=log)))

    def suggest_int(self, name, low, high):
        return int(self._suggest(name, _Dist("int", low, high)))

    def suggest_categorical(self, name, choices):
        return self._suggest(name, _Dist("categorical", choices=list(choices)))

    # ------------------------------------------------------------- report

    def report(self, value: float, step: int) -> None:
        self.intermediate[step] = self.study._norm(float(value))
        self.study.storage.record({"op": "report", "trial": self.number,
                                   "step": step, "value": float(value)})

    def should_prune(self) -> bool:
        return self.study.pruner.prune(self.study, self)


class JournalStorage:
    """Append-only JSONL journal with flock-guarded appends."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, rec: dict) -> None:
        if not self.path:
            return
        line = json.dumps({"ts": time.time(), **rec}) + "\n"
        with open(self.path, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.write(line)
            fcntl.flock(f, fcntl.LOCK_UN)

    def replay(self) -> list[dict]:
        if not self.path or not self.path.exists():
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
        return out


class Study:
    def __init__(self, study_name: str = "study", storage: str | None = None,
                 sampler=None, pruner=None, direction: str | None = None,
                 load_if_exists: bool = True):
        self.study_name = study_name
        requested = direction  # None = caller adopts whatever the journal says
        self.direction = direction or "maximize"
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or NopPruner()
        self.storage = JournalStorage(storage)
        self.trials: list[Trial] = []
        self._direction_recorded = False
        records = self.storage.replay()
        if load_if_exists:
            self._restore(records)
        if (requested is not None and self._direction_recorded
                and self.direction != requested):
            # journal wins (it IS the study being resumed), but never
            # silently: optuna raises/warns on a direction conflict too
            import warnings
            warnings.warn(
                f"study journal direction {self.direction!r} overrides the "
                f"requested {requested!r} (resuming the existing study)",
                stacklevel=3)
        if not self._direction_recorded and not records:
            # persist direction so journal READERS (dashboard, a resuming
            # study opened with the default) adopt the creator's direction.
            # Only on a NEW journal: appending an opener's direction to a
            # pre-'study'-record journal would record a guess as truth.
            self.storage.record({"op": "study", "direction": self.direction})
            self._direction_recorded = True

    def _norm(self, v: float) -> float:
        return v if self.direction == "maximize" else -v

    def _restore(self, records: list[dict]) -> None:
        by_num: dict[int, Trial] = {}
        for rec in records:
            n = rec.get("trial")
            if rec["op"] == "study":
                self.direction = rec.get("direction", self.direction)
                self._direction_recorded = True
            elif rec["op"] == "create":
                by_num[n] = Trial(self, n)
            elif n in by_num:
                t = by_num[n]
                if rec["op"] == "param":
                    t.params[rec["name"]] = rec["value"]
                elif rec["op"] == "report":
                    t.intermediate[rec["step"]] = self._norm(rec["value"])
                elif rec["op"] == "finish":
                    t.state = rec["state"]
                    t.value = rec.get("value")
        self.trials = [by_num[k] for k in sorted(by_num)]

    def _history(self) -> list[tuple[dict, float]]:
        return [(t.params, self._norm(t.value)) for t in self.trials
                if t.state == "complete" and t.value is not None]

    @property
    def best_trial(self) -> Trial | None:
        done = [t for t in self.trials if t.state == "complete"
                and t.value is not None]
        if not done:
            return None
        return max(done, key=lambda t: self._norm(t.value))

    def ask(self) -> Trial:
        number = len(self.trials)
        t = Trial(self, number)
        self.trials.append(t)
        self.storage.record({"op": "create", "trial": number})
        return t

    def tell(self, trial: Trial, value: float | None, state: str = "complete"):
        trial.value = value
        trial.state = state
        self.storage.record({"op": "finish", "trial": trial.number,
                             "state": state, "value": value})

    def optimize(self, objective: Callable[[Trial], float],
                 n_trials: int | None = None, timeout: float | None = None):
        t_start = time.time()
        done = 0
        while True:
            if n_trials is not None and done >= n_trials:
                break
            if timeout is not None and time.time() - t_start > timeout:
                break
            trial = self.ask()
            try:
                value = objective(trial)
                self.tell(trial, float(value), "complete")
            except TrialPruned:
                # intermediates are stored normalized; tell() takes RAW
                best_n = (max(trial.intermediate.values())
                          if trial.intermediate else None)
                best = (best_n if best_n is None
                        else self._norm(best_n))  # involution: un-normalize
                self.tell(trial, best, "pruned")
            done += 1


def create_study(*, study_name: str = "study", storage: str | None = None,
                 sampler=None, pruner=None, direction: str | None = None,
                 load_if_exists: bool = True) -> Study:
    return Study(study_name=study_name, storage=storage, sampler=sampler,
                 pruner=pruner, direction=direction,
                 load_if_exists=load_if_exists)
