"""Native hyperparameter-search engine: samplers, pruning, SQLite storage.

The port of ``optionslab_tpu/optimize/search.py``: an Optuna-style lifecycle
— persistent study storage (SQLite), seeded sampling, median pruning with
warmup, resume via ``load_if_exists``, environment metadata, per-trial
deterministic seeds, failed-trial tolerance, JSON study export — with the
same surface: ``Trial.suggest_*``, ``StudyManager.optimize(objective,
n_trials)``. Samplers (by instance or by name, ``sampler="sobol"|"random"|
"tpe"``): seeded uniform random, a scrambled Sobol space-filler (the port's
``ops.rng.sobol_sequence`` with a digital shift drawn by a seeded
``torch.Generator``), and a TPE (Tree-structured Parzen Estimator) adaptive
sampler. The samplers are host work; the objectives run where they like.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sqlite3
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.rng import sobol_sequence
from ..utils.exceptions import ValidationError
from ..utils.logging import get_logger
from .reproducibility import environment_fingerprint, get_trial_seed

logger = get_logger(__name__)


class TrialPruned(Exception):
    """Raised inside an objective to abort an unpromising trial."""


@dataclasses.dataclass
class FrozenTrial:
    number: int
    params: dict
    value: Optional[float]
    state: str  # COMPLETE | FAIL | PRUNED
    seed: int
    duration_s: float = 0.0
    intermediate: dict = dataclasses.field(default_factory=dict)
    # unit-cube coordinates of each suggest_* draw (persisted so adaptive
    # samplers — TPE — keep their history across study resume)
    unit: dict = dataclasses.field(default_factory=dict)


class Trial:
    """Parameter-suggestion API (Optuna-compatible subset)."""

    def __init__(self, number: int, sampler, study):
        self.number = number
        self._sampler = sampler
        self._study = study
        self.params: dict = {}
        self.intermediate: dict = {}
        self.unit: dict = {}
        self.seed = get_trial_seed(study.base_seed, number, study.name)

    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        u = self._sampler.draw(self.number, name)
        self.unit[name] = float(u)
        if log:
            if low <= 0:
                raise ValidationError(f"log-scale range requires low > 0 for {name}")
            val = float(math.exp(math.log(low) + u * (math.log(high) - math.log(low))))
        else:
            val = float(low + u * (high - low))
        self.params[name] = val
        return val

    def suggest_int(self, name: str, low: int, high: int, log: bool = False) -> int:
        val = int(round(self.suggest_float(name, low, high, log)))
        val = max(low, min(high, val))
        self.params[name] = val
        return val

    def suggest_categorical(self, name: str, choices) -> object:
        u = self._sampler.draw(self.number, name)
        self.unit[name] = float(u)
        val = choices[min(int(u * len(choices)), len(choices) - 1)]
        self.params[name] = val
        return val

    def report(self, value: float, step: int) -> None:
        self.intermediate[step] = float(value)

    def should_prune(self) -> bool:
        return self._study.pruner.should_prune(self.number, self.intermediate,
                                               self._study.trials)


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.seed = seed

    def draw(self, trial_number: int, name: str) -> float:
        h = get_trial_seed(self.seed, trial_number, name)
        return float(np.random.default_rng(h).uniform())


class SobolSampler:
    """Low-discrepancy coverage of the search box: dimension index is
    assigned per parameter name in first-seen order."""

    def __init__(self, seed: int = 0, max_trials: int = 4096):
        self.seed = seed
        self.max_trials = max_trials
        self._dims: dict[str, int] = {}
        self._table = None

    def _ensure(self, name: str):
        if name not in self._dims:
            self._dims[name] = len(self._dims)
            self._table = None  # rebuild with more dims

    def draw(self, trial_number: int, name: str) -> float:
        self._ensure(name)
        if self._table is None or self._table.shape[1] < len(self._dims):
            self._table = sobol_sequence(
                self.max_trials, max(len(self._dims), 1),
                generator=torch.Generator().manual_seed(self.seed)).numpy()
        return float(self._table[trial_number % self.max_trials, self._dims[name]])


class TPESampler:
    """Tree-structured Parzen Estimator (Bergstra et al. 2011), the adaptive
    sampler Optuna's ``TPESampler(seed)`` provides.

    Univariate TPE in the unit cube, per parameter name (Optuna's
    independent-sampler default): completed trials are split at the
    ``gamma`` quantile of the objective into GOOD and BAD sets; both get
    a Parzen (Gaussian-kernel + uniform-prior) density over the recorded
    unit coordinates, ``n_candidates`` points are drawn from the good
    density, and the candidate maximizing l(x)/g(x) wins. The first
    ``n_startup`` trials (and any parameter with too little history) fall
    back to the seeded Sobol space-filler. Unit coordinates are persisted
    with each trial, so a RESUMED study keeps its TPE history.

    Fully deterministic: every random decision derives from
    ``get_trial_seed(seed, trial_number, name)``.
    """

    def __init__(self, seed: int = 0, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.seed = seed
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._fallback = SobolSampler(seed)
        self._study = None

    def attach(self, study) -> None:
        """Called by StudyManager — gives the sampler the trial history."""
        self._study = study

    def _history(self, name: str):
        if self._study is None:
            return np.empty(0), np.empty(0)
        us, ys = [], []
        for t in self._study.trials:
            if t.state == "COMPLETE" and t.value is not None and name in t.unit:
                us.append(float(t.unit[name]))
                ys.append(float(t.value))
        return np.asarray(us), np.asarray(ys)

    @staticmethod
    def _log_parzen(x, centers, bw):
        """log density of (mixture of N(c_i, bw) + one uniform[0,1] prior
        pseudo-component), pointwise over x."""
        n = len(centers)
        d = (x[:, None] - centers[None, :]) / bw
        log_k = -0.5 * d * d - math.log(bw * math.sqrt(2.0 * math.pi))
        # logsumexp over kernels plus the uniform prior term (log 1 = 0)
        m = np.maximum(log_k.max(axis=1), 0.0)
        s = np.exp(log_k - m[:, None]).sum(axis=1) + np.exp(-m)
        return m + np.log(s) - math.log(n + 1)

    def draw(self, trial_number: int, name: str) -> float:
        us, ys = self._history(name)
        if len(ys) < self.n_startup:
            return self._fallback.draw(trial_number, name)
        if self._study is not None and self._study.direction == "maximize":
            ys = -ys
        n_good = max(1, min(int(math.ceil(self.gamma * len(ys))), 25))
        order = np.argsort(ys, kind="stable")
        good, bad = us[order[:n_good]], us[order[n_good:]]
        if bad.size == 0:
            bad = us
        # Scott's-rule bandwidths with a floor that keeps exploration alive
        bw_g = max(float(np.std(good)) * len(good) ** -0.2, 0.08)
        bw_b = max(float(np.std(bad)) * len(bad) ** -0.2, 0.08)
        rng = np.random.default_rng(get_trial_seed(self.seed, trial_number,
                                                   name))
        centers = good[rng.integers(0, len(good), self.n_candidates)]
        cands = centers + rng.normal(0.0, bw_g, self.n_candidates)
        # one uniform candidate preserves global exploration
        cands[-1] = rng.uniform()
        cands = np.clip(cands, 1e-6, 1.0 - 1e-6)
        score = (self._log_parzen(cands, good, bw_g)
                 - self._log_parzen(cands, bad, bw_b))
        return float(cands[int(np.argmax(score))])


SAMPLERS = {"random": RandomSampler, "sobol": SobolSampler,
            "tpe": TPESampler}


class MedianPruner:
    """Prune if the latest intermediate value is worse than the median of
    completed trials at the same step (reference uses Optuna's,
    ``study_manager.py:230``)."""

    def __init__(self, n_warmup_trials: int = 5, n_warmup_steps: int = 1):
        self.n_warmup_trials = n_warmup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, trial_number: int, intermediate: dict, trials: list) -> bool:
        if not intermediate:
            return False
        step, value = max(intermediate.items())
        if step < self.n_warmup_steps:
            return False
        peers = [t.intermediate.get(step) for t in trials
                 if t.state == "COMPLETE" and step in t.intermediate]
        if len(peers) < self.n_warmup_trials:
            return False
        return value > float(np.median(peers))


class NopPruner:
    def should_prune(self, *a, **k) -> bool:
        return False


class StudyStorage:
    """SQLite persistence with resume semantics (reference: RDB storage +
    ``load_if_exists``)."""

    def __init__(self, url: str = "sqlite:///optionslab_studies.db"):
        if not url.startswith("sqlite:///"):
            raise ValidationError(f"only sqlite:/// URLs supported, got {url}")
        self.path = url[len("sqlite:///"):]
        self._init()

    def _conn(self):
        return sqlite3.connect(self.path)

    def _init(self):
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS studies (
                name TEXT PRIMARY KEY, direction TEXT, base_seed INTEGER,
                metadata TEXT, created REAL)""")
            c.execute("""CREATE TABLE IF NOT EXISTS trials (
                study TEXT, number INTEGER, params TEXT, value REAL,
                state TEXT, seed INTEGER, duration_s REAL, intermediate TEXT,
                unit TEXT, PRIMARY KEY (study, number))""")
            # migrate pre-round-5 databases (no unit column)
            cols = [r[1] for r in c.execute("PRAGMA table_info(trials)")]
            if "unit" not in cols:
                c.execute("ALTER TABLE trials ADD COLUMN unit TEXT")

    def create_study(self, name: str, direction: str, base_seed: int, metadata: dict,
                     load_if_exists: bool = True) -> bool:
        """Returns True if an existing study was loaded."""
        with self._conn() as c:
            row = c.execute("SELECT name FROM studies WHERE name=?", (name,)).fetchone()
            if row:
                if not load_if_exists:
                    raise ValidationError(f"study {name!r} already exists")
                return True
            c.execute("INSERT INTO studies VALUES (?,?,?,?,?)",
                      (name, direction, base_seed, json.dumps(metadata), time.time()))
            return False

    def load_trials(self, name: str) -> list[FrozenTrial]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT number, params, value, state, seed, duration_s, "
                "intermediate, unit "
                "FROM trials WHERE study=? ORDER BY number", (name,)).fetchall()
        return [FrozenTrial(n, json.loads(p), v, s, sd, d,
                            {int(k): vv for k, vv in json.loads(im or "{}").items()},
                            json.loads(un or "{}"))
                for n, p, v, s, sd, d, im, un in rows]

    def save_trial(self, study: str, t: FrozenTrial):
        with self._conn() as c:
            c.execute("INSERT OR REPLACE INTO trials VALUES (?,?,?,?,?,?,?,?,?)",
                      (study, t.number, json.dumps(t.params), t.value, t.state,
                       t.seed, t.duration_s, json.dumps(t.intermediate),
                       json.dumps(t.unit)))


@dataclasses.dataclass
class StudyResult:
    study_name: str
    best_value: Optional[float]
    best_params: dict
    n_trials: int
    n_complete: int
    n_failed: int
    n_pruned: int
    total_seconds: float
    metadata: dict

    def to_json(self, path=None) -> str:
        payload = json.dumps(dataclasses.asdict(self), indent=2, default=float)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload


class StudyManager:
    """Create/resume studies, run objectives, tolerate failures.

    ``objective(trial, trial_seed) -> float`` (minimized by default) — the
    reference's objective signature (``objectives.py:31``).
    """

    def __init__(self, study_name: str = "study",
                 storage: str = "sqlite:///optionslab_studies.db",
                 direction: str = "minimize", sampler=None, pruner=None,
                 base_seed: int = 42, load_if_exists: bool = True):
        if direction not in ("minimize", "maximize"):
            raise ValidationError(f"direction must be minimize|maximize: {direction}")
        self.name = study_name
        self.direction = direction
        self.base_seed = base_seed
        if isinstance(sampler, str):
            if sampler not in SAMPLERS:
                raise ValidationError(
                    f"sampler must be one of {sorted(SAMPLERS)}: {sampler!r}")
            sampler = SAMPLERS[sampler](base_seed)
        self.sampler = sampler or SobolSampler(base_seed)
        # adaptive samplers (TPE) read the trial history through the study
        getattr(self.sampler, "attach", lambda s: None)(self)
        self.pruner = pruner or MedianPruner()
        self.metadata = environment_fingerprint()
        self.storage = StudyStorage(storage)
        self.resumed = self.storage.create_study(study_name, direction, base_seed,
                                                 self.metadata, load_if_exists)
        self.trials: list[FrozenTrial] = self.storage.load_trials(study_name)

    # -- core loop ----------------------------------------------------------
    def optimize(self, objective: Callable, n_trials: int = 50,
                 catch_exceptions: bool = True) -> StudyResult:
        t_start = time.perf_counter()
        start_number = len(self.trials)
        for i in range(start_number, start_number + n_trials):
            trial = Trial(i, self.sampler, self)
            t0 = time.perf_counter()
            try:
                value = objective(trial, trial.seed)
                state = "COMPLETE"
                value = float(value)
                if not np.isfinite(value):
                    state, value = "FAIL", None
            except TrialPruned:
                state, value = "PRUNED", None
            except Exception as e:
                if not catch_exceptions:
                    raise
                logger.warning("trial %d failed: %s", i, e)
                state, value = "FAIL", None
            frozen = FrozenTrial(i, trial.params, value, state, trial.seed,
                                 time.perf_counter() - t0, trial.intermediate,
                                 trial.unit)
            self.trials.append(frozen)
            self.storage.save_trial(self.name, frozen)
        return self.result(time.perf_counter() - t_start)

    # -- results ------------------------------------------------------------
    def best_trial(self) -> Optional[FrozenTrial]:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            return None
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    def result(self, total_seconds: float = 0.0) -> StudyResult:
        best = self.best_trial()
        states = [t.state for t in self.trials]
        return StudyResult(
            study_name=self.name,
            best_value=best.value if best else None,
            best_params=best.params if best else {},
            n_trials=len(self.trials),
            n_complete=states.count("COMPLETE"),
            n_failed=states.count("FAIL"),
            n_pruned=states.count("PRUNED"),
            total_seconds=total_seconds,
            metadata=self.metadata,
        )


# Back-compat alias matching the reference class name
OptunaStudyManager = StudyManager
