"""The port's hyper-parameter search layer (`miseg_tpu_torch/hpo/`,
`cli/dashboard.py`, `cli/sync_wandb.py`) against the JAX package's, on
the CPU.  Both are pure Python and numpy, so everything is held exactly:

* TPE and random suggestions over 30 trials of a pure objective (past
  TPE's 10 startup trials, so its KDE path runs) on float, log-float,
  int and categorical spaces, maximized and minimized: every parameter
  and value equal (==).
* Successive halving: the prune decision after every report of a
  recorded history, at three (min_resource, reduction_factor,
  min_early_stopping_rate) settings, equal to JAX's; some prune.
* Journals: one that JAX's `Study` wrote (with pruned trials) resumed by
  the port's gives the same next trials as JAX's own resume, and the two
  resumed journals hold the same records (but their time stamps); the
  same the other way; a journal without a `study` record gets none.
* `study_report` equal to JAX's; the dashboard's `/` and `/api/report`
  over a real socket; `sync_wandb` listing runs without wandb, and
  running `wandb sync` once a run through a stub `wandb` module and a
  stub executable on PATH.
"""

import json
import math
import os
import shutil
import sys
import threading
import types
import urllib.request

import pytest

from miseg_tpu import hpo as jhpo
from miseg_tpu.cli import dashboard as jdashboard
from miseg_tpu.cli import sync_wandb as jsync
from miseg_tpu_torch import hpo
from miseg_tpu_torch.cli import dashboard, sync_wandb


def _objective(pkg, prune: bool = False):
    """A pure objective over four kinds of space; with `prune`, reports a
    curve of 6 steps and stops where the pruner says."""
    def objective(trial):
        x = trial.suggest_float("x", -3.0, 2.0)
        lr = trial.suggest_float("lr", 1e-5, 5e-3, log=True)
        n = trial.suggest_int("n", 2, 10)
        kind = trial.suggest_categorical("kind", ["a", "b", "c"])
        value = (-(x - 0.5) ** 2 - 0.1 * abs(math.log10(lr) + 3.0) + 0.05 * n
                 + {"a": 0.0, "b": 0.3, "c": -0.2}[kind])
        if prune:
            for step in range(6):
                trial.report(value * (step + 1) / 6, step)
                if trial.should_prune():
                    raise pkg.TrialPruned()
        return value
    return objective


def _sampler(pkg, kind: str, seed: int):
    return pkg.TPESampler(seed=seed) if kind == "tpe" else pkg.RandomSampler(seed=seed)


def _trials(study):
    return [(t.number, t.state, t.value, dict(t.params), dict(t.intermediate))
            for t in study.trials]


def _as_json(obj):
    """`obj` as it comes back from JSON (tuples become lists)."""
    return json.loads(json.dumps(obj))


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(path)]


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
@pytest.mark.parametrize("kind", ["tpe", "random"])
def test_suggestions_equal_jax(kind, direction):
    studies = []
    for pkg in (jhpo, hpo):
        study = pkg.create_study(sampler=_sampler(pkg, kind, 11), direction=direction)
        study.optimize(_objective(pkg), n_trials=30)
        studies.append(study)
    want, got = (_trials(s) for s in studies)
    assert len(got) == 30 and got == want
    assert studies[1].best_trial.number == studies[0].best_trial.number
    if kind == "tpe":   # the same draws as random for 10 startup trials, then the KDE's
        rand = hpo.create_study(sampler=hpo.RandomSampler(seed=11), direction=direction)
        rand.optimize(_objective(hpo), n_trials=30)
        assert [t[3] for t in _trials(rand)[:10]] == [t[3] for t in got[:10]]
        assert [t[3] for t in _trials(rand)[10:]] != [t[3] for t in got[10:]]


@pytest.mark.parametrize("min_resource,rf,s", [(1, 3, 0), (4, 3, 0), (2, 2, 1)])
def test_successive_halving_decisions_equal_jax(min_resource, rf, s):
    """20 trials of 12 steps each, reported in interleaved order (every
    trial's step k before any trial's step k + 1); the pruner asked after
    every report."""
    import numpy as np
    curves = np.random.default_rng(5).normal(size=(20, 12)).cumsum(axis=1)
    decisions = []
    for pkg in (jhpo, hpo):
        study = pkg.create_study(pruner=pkg.SuccessiveHalvingPruner(
            min_resource=min_resource, reduction_factor=rf, min_early_stopping_rate=s))
        trials = [study.ask() for _ in range(20)]
        out = []
        for step in range(12):
            for t, curve in zip(trials, curves):
                t.report(float(curve[step]), step)
                out.append(t.should_prune())
        decisions.append(out)
    assert decisions[1] == decisions[0]
    assert 0 < sum(decisions[1]) < len(decisions[1])


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_journal_resumes_across_packages(tmp_path, first, direction):
    """12 trials (some pruned) written by one package; each package then
    resumes a copy of that journal for 14 more (past TPE's startup)."""
    pkgs = {"jax": jhpo, "port": hpo}
    start = tmp_path / "start.journal.jsonl"
    pkg = pkgs[first]
    study = pkg.create_study(study_name="s", storage=str(start), direction=direction,
                             sampler=pkg.TPESampler(seed=3),
                             pruner=pkg.SuccessiveHalvingPruner(min_resource=2))
    study.optimize(_objective(pkg, prune=True), n_trials=12)
    assert {t.state for t in study.trials} == {"complete", "pruned"}
    resumed = {}
    for name, pkg in pkgs.items():
        path = tmp_path / f"{name}.journal.jsonl"
        shutil.copy(start, path)
        study = pkg.create_study(study_name="s", storage=str(path), direction=None,
                                 sampler=pkg.TPESampler(seed=4),
                                 pruner=pkg.SuccessiveHalvingPruner(min_resource=2))
        assert study.direction == direction
        study.optimize(_objective(pkg, prune=True), n_trials=14)
        resumed[name] = (_trials(study), _records(path))
    assert len(resumed["port"][0]) == 26
    assert resumed["port"] == resumed["jax"]
    assert sum(r["op"] == "study" for r in resumed["port"][1]) == 1
    # a pruned trial is told its best intermediate value, un-normalised
    for number, state, value, _, inter in resumed["port"][0]:
        if state == "pruned":
            sign = 1.0 if direction == "maximize" else -1.0
            assert value == sign * max(inter.values())


def test_no_study_record_is_added_to_an_old_journal(tmp_path):
    """A journal from before the `study` record: neither package records
    a direction when it resumes one (that would record a guess)."""
    for name, pkg in (("jax", jhpo), ("port", hpo)):
        path = tmp_path / f"{name}.journal.jsonl"
        path.write_text(json.dumps({"ts": 0.0, "op": "create", "trial": 0}) + "\n"
                        + json.dumps({"ts": 0.0, "op": "finish", "trial": 0,
                                      "state": "complete", "value": 0.5}) + "\n")
        study = pkg.create_study(storage=str(path), direction="maximize")
        study.optimize(_objective(pkg), n_trials=2)
    assert _records(tmp_path / "port.journal.jsonl") == _records(tmp_path / "jax.journal.jsonl")
    assert not any(r["op"] == "study" for r in _records(tmp_path / "port.journal.jsonl"))


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    """A minimized study of 15 trials, some pruned, written by JAX."""
    path = tmp_path_factory.mktemp("dash") / "MI-Seg.journal.jsonl"
    study = jhpo.create_study(study_name="swin", storage=str(path), direction="minimize",
                              sampler=jhpo.TPESampler(seed=9),
                              pruner=jhpo.SuccessiveHalvingPruner(min_resource=2))
    study.optimize(_objective(jhpo, prune=True), n_trials=15)
    return str(path)


def test_study_report_equals_jax(journal):
    got = dashboard.study_report(journal, "swin")
    assert got == jdashboard.study_report(journal, "swin")
    assert got["n_trials"] == 15 and got["direction"] == "minimize"
    assert {t["state"] for t in got["trials"]} == {"complete", "pruned"}


def test_dashboard_main_prints_the_report(journal, capsys):
    dashboard.main(["--storage", journal, "--study_name", "swin"])
    assert json.loads(capsys.readouterr().out) == _as_json(dashboard.study_report(journal, "swin"))


def test_dashboard_serves_page_and_report(journal):
    server = dashboard.make_server(journal, "swin", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            page = r.read().decode()
            assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
        assert "/api/report" in page and "<svg" in page
        with urllib.request.urlopen(base + "/api/report", timeout=10) as r:
            assert r.headers["Content-Type"] == "application/json"
            assert json.loads(r.read()) == _as_json(jdashboard.study_report(journal, "swin"))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture
def offline_runs(tmp_path):
    for name in ("offline-run-20260101_000000-a1", "offline-run-20260102_000000-b2"):
        (tmp_path / "wandb" / name).mkdir(parents=True)
    (tmp_path / "wandb" / "latest-run").mkdir()
    return tmp_path / "wandb"


def test_sync_wandb_lists_runs_without_wandb(offline_runs, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import wandb raises
    outs = []
    for main in (jsync.main, sync_wandb.main):
        main(["--dir", str(offline_runs)])
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "2 offline runs pending sync" in outs[1] and "latest-run" not in outs[1]
    sync_wandb.main(["--dir", str(offline_runs / "none")])
    assert capsys.readouterr().out.startswith("no offline runs under")


def test_sync_wandb_runs_wandb_sync_once_a_run(offline_runs, tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    exe = bin_dir / "wandb"
    exe.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n')
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setitem(sys.modules, "wandb", types.ModuleType("wandb"))
    sync_wandb.main(["--dir", str(offline_runs)])
    runs = sorted(str(p) for p in offline_runs.glob("offline-run-*"))
    assert calls.read_text().splitlines() == [f"sync {r}" for r in runs]
