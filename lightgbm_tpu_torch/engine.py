"""Training entry point (counterpart of ``lightgbm_tpu/engine.py`` train,
:34-300): validation sets, custom evaluation functions and callbacks, the
early stopping of ``early_stopping_round``, and ``best_iteration`` /
``best_score``.  A custom evaluation function receives output-space
predictions, [N, k] for k trees an iteration (boosting/gbdt.py:2480-2492).  Checkpoints, ``init_model``, ``resume_from``, custom
objectives, fleets and the multi-step launch are not ported yet."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .boosting.gbdt import Booster
from .callback import CallbackEnv, EarlyStopException, early_stopping
from .config import Config
from .dataset import Dataset


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[Union[Dataset, Sequence[Dataset]]] = None,
    valid_names: Optional[Sequence[str]] = None,
    feval: Optional[Callable] = None,
    init_model=None,
    callbacks: Optional[List[Callable]] = None,
    device=None,
    **kwargs,
) -> Booster:
    """Train a GBDT model on ``device`` (the CUDA card unless
    ``device='cpu'``): ``num_boost_round`` iterations (``num_iterations``
    or an alias in ``params`` wins), fewer when no split has a positive
    gain or early stopping ends the run.  After each iteration the
    training set (when it is one of ``valid_sets``, under its name there)
    and the validation sets are evaluated every ``metric_freq`` iterations
    and at the last, then the callbacks run."""
    if init_model is not None:
        raise NotImplementedError("init_model not yet ported to lightgbm_tpu_torch")
    if kwargs:
        raise NotImplementedError(
            "train() argument(s) not yet ported to lightgbm_tpu_torch: "
            + ", ".join(sorted(kwargs)))
    params = dict(params or {})
    cfg = Config.from_params(params)
    if "num_iterations" in cfg.raw:
        num_boost_round = cfg.num_iterations
    train_set.params = {**params, **train_set.params}
    booster = Booster(params, train_set, device=device)

    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_names = list(valid_names or [])
    train_name = None
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            train_name = name
        else:
            booster.add_valid(vs, name)

    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0:
        callbacks.append(early_stopping(cfg.early_stopping_round, cfg.first_metric_only,
                                        verbose=cfg.verbosity > 0,
                                        min_delta=cfg.early_stopping_min_delta))
    before = sorted((cb for cb in callbacks if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    begin = booster.current_iteration()
    end = begin + num_boost_round
    has_eval = train_name is not None or bool(booster._valid)
    results: List = []
    try:
        for it in range(begin, end):
            for cb in before:
                cb(CallbackEnv(booster, params, it, begin, end, None))
            finished = booster.update()
            results = []
            if has_eval and ((it + 1) % max(1, cfg.metric_freq) == 0 or it + 1 == end):
                if train_name is not None:
                    results.extend((train_name,) + r[1:] for r in booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
            for cb in after:
                cb(CallbackEnv(booster, params, it, begin, end, results))
            if finished:
                break
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        results = e.best_score
    booster.best_score = {}
    for item in results or []:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    return booster
