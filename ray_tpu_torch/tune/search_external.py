"""External optimizer plug surface for Tune.

Counterpart: ``ray_tpu/tune/search_external.py``.

The reference vendors ~9 searcher integrations
(`python/ray/tune/search/optuna/optuna_search.py`, `bohb/`, `ax/`, ...).
Every modern HPO library exposes the same two calls — *ask* for a config,
*tell* it a result — so instead of vendoring clients this module ships
the adapter those integrations reduce to:

- ``AskTellSearcher``: wraps ANY object implementing ask()/tell() in the
  Tune ``Searcher`` protocol (suggest/on_trial_complete), with pending
  bookkeeping and nested-path config assembly.
- ``OptunaSearcher``: the concrete proof on the most popular library —
  translates Tune domains to optuna distributions and drives a Study
  through ask/tell. Gated on optuna being importable (this image does
  not ship it); its translation layer is exercised by tests through a
  fake study honoring optuna's ask/tell surface.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.tune.search import (Choice, Domain, GridSearch, LogUniform,
                                 QUniform, RandInt, Searcher, Uniform,
                                 _deepcopy_plain, _set, _walk)


class AskTellSearcher(Searcher):
    """Adapter from an ask/tell optimizer to the Tune Searcher protocol.

    ``ask()`` returns either a flat ``{path-tuple-or-dotted-name: value}``
    mapping, a nested config dict, or ``(token, mapping)`` where *token*
    is handed back to ``tell(token, value)`` (libraries like optuna need
    their trial object back). ``tell`` receives the raw metric value —
    direction handling belongs to the external optimizer, which knows
    its own objective sense; `metric`/`mode` arrive via set_objective
    and are exposed as ``self._metric``/``self._mode``.
    """

    def __init__(self, ask: Callable[[], Any],
                 tell: Callable[[Any, Optional[float]], None]):
        self._ask_fn = ask
        self._tell_fn = tell
        self._pending: Dict[str, Any] = {}  # trial_id -> token

    # -- config assembly -----------------------------------------------

    def _assemble(self, values: Dict) -> Dict[str, Any]:
        """Merge ask()'d values over the param space's constant entries.
        Keys may be path tuples or dotted names; unnamed Domain leaves
        left unset by the optimizer raise (a silently-random leaf would
        corrupt the optimizer's model of the trial)."""
        cfg = _deepcopy_plain(self._space)
        norm = {}
        for k, v in values.items():
            norm[tuple(k.split(".")) if isinstance(k, str) else tuple(k)] = v
        for path, spec in _walk(self._space):
            if isinstance(spec, GridSearch):
                raise ValueError(
                    "ask/tell searchers do not support grid_search "
                    "entries; use BasicVariantGenerator for grids")
            if path not in norm:
                raise KeyError(
                    f"external optimizer returned no value for "
                    f"search-space leaf {'.'.join(path)}")
            _set(cfg, path, norm[path])
        return cfg

    # -- Searcher protocol ---------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        out = self._ask_fn()
        if out is None:
            return None
        if isinstance(out, tuple) and len(out) == 2:
            token, values = out
        else:
            token, values = out, out
        self._pending[trial_id] = token
        if isinstance(values, dict) and not any(
                isinstance(k, (tuple, list)) or "." in str(k)
                for k in values):
            # flat single-level dict keyed by top-level names
            values = {(k,): v for k, v in values.items()}
        return self._assemble(values)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        token = self._pending.pop(trial_id, None)
        if token is None:
            return
        value = None
        if result is not None:
            raw = result.get(self._metric)
            value = None if raw is None else float(raw)
        self._tell_fn(token, value)


def _optuna_distributions(space) -> Dict[str, Any]:
    """Tune domains -> optuna distributions, keyed by dotted path."""
    import optuna

    dists = {}
    for path, spec in _walk(space):
        name = ".".join(path)
        if isinstance(spec, GridSearch):
            raise ValueError("grid_search entries are not ask/tell")
        if isinstance(spec, LogUniform):
            dists[name] = optuna.distributions.FloatDistribution(
                spec.low, spec.high, log=True)
        elif isinstance(spec, QUniform):
            dists[name] = optuna.distributions.FloatDistribution(
                spec.low, spec.high, step=spec.q)
        elif isinstance(spec, Uniform):
            dists[name] = optuna.distributions.FloatDistribution(
                spec.low, spec.high)
        elif isinstance(spec, RandInt):
            dists[name] = optuna.distributions.IntDistribution(
                spec.low, spec.high - 1)  # tune's high is exclusive
        elif isinstance(spec, Choice):
            dists[name] = optuna.distributions.CategoricalDistribution(
                spec.categories)
        elif isinstance(spec, Domain):
            raise ValueError(
                f"domain {type(spec).__name__} at {name} has no optuna "
                f"distribution; use AskTellSearcher with a custom ask()")
    return dists


class OptunaSearcher(AskTellSearcher):
    """Optuna-backed searcher (ref
    `python/ray/tune/search/optuna/optuna_search.py`): a Study drives
    trial configs through ask/tell. Pass `study_factory` to control
    sampler/pruner/storage; the default creates an in-memory TPE study
    oriented by set_objective's mode."""

    def __init__(self, study_factory: Optional[Callable[[str], Any]] = None):
        super().__init__(self._ask, self._tell)
        self._study_factory = study_factory
        self._study = None
        self._dists: Dict[str, Any] = {}

    def set_search_space(self, param_space) -> None:
        super().set_search_space(param_space)
        self._dists = _optuna_distributions(param_space)

    def _ensure_study(self):
        if self._study is None:
            if self._study_factory is not None:
                direction = ("maximize" if getattr(self, "_mode", "max")
                             == "max" else "minimize")
                self._study = self._study_factory(direction)
            else:
                import optuna

                self._study = optuna.create_study(
                    direction="maximize"
                    if getattr(self, "_mode", "max") == "max"
                    else "minimize")
        return self._study

    def _ask(self) -> Tuple[Any, Dict[str, Any]]:
        trial = self._ensure_study().ask(self._dists)
        return trial, dict(trial.params)

    def _tell(self, trial, value: Optional[float]) -> None:
        if value is None:
            try:
                import optuna

                self._ensure_study().tell(
                    trial, state=optuna.trial.TrialState.FAIL)
                return
            except ImportError:
                pass
            self._ensure_study().tell(trial, None)
            return
        self._ensure_study().tell(trial, value)
