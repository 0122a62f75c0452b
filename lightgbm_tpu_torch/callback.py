"""Training callbacks (counterpart of ``lightgbm_tpu/callback.py``).

The reference's callback protocol: a callable receives a ``CallbackEnv``;
``before_iteration`` callbacks run before the boosting update, the others
after the evaluation, each group in ``order``; ``EarlyStopException``
unwinds the training loop.  ``reset_parameter`` and the checkpoint callback
are not ported yet.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List


class EarlyStopException(Exception):
    """Raised to stop training (reference callback.py EarlyStopException)."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"],
)


def _results(items) -> str:
    return "\t".join(f"{it[0]}'s {it[1]}: {it[2]:g}" for it in items)


def log_evaluation(period: int = 1) -> Callable:
    """Print the evaluation results every ``period`` iterations (reference
    callback.py log_evaluation)."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and (env.iteration + 1) % period == 0:
            print(f"[{env.iteration + 1}]\t" + _results(env.evaluation_result_list))

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """Record the evaluation results into ``eval_result[data][metric]``, one
    value a round (reference callback.py record_evaluation)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list or []:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict()).setdefault(
                eval_name, []).append(result)

    _callback.order = 20
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta=0.0) -> Callable:
    """Stop when no validation metric has improved by more than
    ``min_delta`` (a number, or one a metric) for ``stopping_rounds``
    rounds, or at the last round; sets the booster's ``best_iteration``
    (reference callback.py early_stopping / _EarlyStoppingCallback).  With
    ``first_metric_only`` only the first metric decides.  The training
    set's results never stop training."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    state = {"enabled": True, "first_metric": ""}

    def _init(env: CallbackEnv) -> None:
        state["enabled"] = bool(env.evaluation_result_list)
        if not state["enabled"]:
            return
        state["first_metric"] = env.evaluation_result_list[0][1].split(" ")[-1]
        n = len(env.evaluation_result_list)
        deltas = min_delta if isinstance(min_delta, list) else [min_delta] * n
        for item, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if item[3]:
                best_score.append(float("-inf"))
                cmp_op.append(lambda curr, best, d=delta: curr > best + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda curr, best, d=delta: curr < best - d)

    def _stop(i: int, env: CallbackEnv, what: str) -> None:
        env.model.best_iteration = best_iter[i] + 1
        if verbose:
            print(f"{what}, best iteration is:\n[{best_iter[i] + 1}]\t"
                  + _results(best_score_list[i]))
        raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not state["enabled"]:
            return
        for i, item in enumerate(env.evaluation_result_list):
            data_name, eval_name, score = item[0], item[1], item[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and state["first_metric"] != eval_name.split(" ")[-1]:
                continue
            if data_name == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                _stop(i, env, "Early stopping")
            if env.iteration == env.end_iteration - 1:
                _stop(i, env, "Did not meet early stopping")

    _callback.order = 30
    return _callback
