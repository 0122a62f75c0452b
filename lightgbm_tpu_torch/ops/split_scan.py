"""Per-leaf best-split scan: one launch computes every feature's best
numeric split of a leaf histogram.

Counterpart of ``lightgbm_tpu/ops/pallas/split_scan.py``: ``split_scan``
returns the ``[F, 8]`` rows (gain, bin, default_left, left g, left h, left
count, runner-up gain, 0) of ``split_scan_pallas`` (:187), and
``fused_best_split`` (:243) turns them into the leaf's ``SplitCandidate``
(the cross-feature argmax and the improvement over the parent, :286-334).

``split_scan`` dispatches on the histogram's device: the plain PyTorch
version on the CPU, the ``csrc/split_scan.cu`` kernel on a CUDA device
(launches counted in ``_build.LAUNCHES['split_scan']``).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .split import _EPS, SplitCandidate, _ordered_cum, leaf_gain, split_gains


def split_scan_plain(
    hist: torch.Tensor, parent: torch.Tensor, num_bins: torch.Tensor,
    nan_bins: torch.Tensor, feature_mask: torch.Tensor, *, lambda_l1: float,
    lambda_l2: float, min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
) -> torch.Tensor:
    """[F, 8] per-feature best rows.  Within a feature, missing-left wins
    only when strictly better and the lowest bin wins a tie, as the TPU
    kernel's rows (split_scan.py:145-178)."""
    f, b, _ = hist.shape
    has_nan, nan_stats, cum = _ordered_cum(hist, nan_bins)
    gains = split_gains(
        cum, nan_stats, has_nan, parent, num_bins, feature_mask.bool(),
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=float(min_data_in_leaf),
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )  # [2, F, B]
    m_r, i_r = gains[0].max(dim=1)  # first maximum per feature
    m_l, i_l = gains[1].max(dim=1)
    go_left = m_l > m_r
    best = torch.where(go_left, m_l, m_r)
    bin_ = torch.where(go_left, i_l, i_r)
    rows_f = torch.arange(f, device=hist.device)
    left = cum[rows_f, bin_] + torch.where(
        go_left[:, None], nan_stats, torch.zeros_like(nan_stats)
    )
    gwin = torch.where(go_left[:, None], gains[1], gains[0])
    glose = torch.where(go_left[:, None], gains[0], gains[1])
    bins_b = torch.arange(b, device=hist.device)[None, :]
    other = torch.where(bins_b == bin_[:, None], float("-inf"), gwin)
    sec = torch.maximum(other, glose).max(dim=1).values
    return torch.stack(
        [
            best, bin_.to(torch.float32), go_left.to(torch.float32),
            left[:, 0], left[:, 1], left[:, 2], sec, torch.zeros_like(best),
        ],
        dim=1,
    )


def split_scan(
    hist: torch.Tensor,  # [F, B, 3] f32
    parent: torch.Tensor,  # [3] f32 (g, h, count)
    num_bins: torch.Tensor,  # [F] i32
    nan_bins: torch.Tensor,  # [F] i32
    feature_mask: torch.Tensor,  # [F] bool
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: int,
    min_sum_hessian_in_leaf: float,
) -> torch.Tensor:
    """Per-feature best rows [F, 8]: plain version on the CPU, the
    ``csrc/split_scan.cu`` kernel on a CUDA device."""
    kw = dict(
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )
    if hist.device.type == "cpu":
        return split_scan_plain(hist, parent, num_bins, nan_bins, feature_mask, **kw)
    if hist.device.type != "cuda":
        raise ValueError(f"no kernel for device {hist.device}")
    f, b, three = hist.shape
    if b > 256 or three != 3:
        raise ValueError(f"split scan takes [F, B<=256, 3] histograms, got {tuple(hist.shape)}")
    dev = hist.device
    hist = hist.to(torch.float32).contiguous()
    parent = parent.to(device=dev, dtype=torch.float32).contiguous()
    nb = num_bins.to(device=dev, dtype=torch.int32).contiguous()
    nanb = nan_bins.to(device=dev, dtype=torch.int32).contiguous()
    mask = feature_mask.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((f, 8), dtype=torch.float32, device=dev)
    fn = _build.entry("split_scan")
    rc = fn(
        hist.data_ptr(), parent.data_ptr(), nb.data_ptr(), nanb.data_ptr(),
        mask.data_ptr(), f, b, float(lambda_l1), float(lambda_l2),
        float(min_data_in_leaf), float(min_sum_hessian_in_leaf),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "split_scan kernel")
    _build.LAUNCHES["split_scan"] += 1
    return out


def fused_best_split(
    hist, parent_g: float, parent_h: float, parent_cnt: float, num_bins,
    nan_bins, feature_mask, *, lambda_l1: float, lambda_l2: float,
    min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
    min_gain_to_split: float, with_margin: bool = False,
):
    """The leaf's best split from the scan rows: first feature with the
    largest row gain (split_scan.py:286-334).

    ``with_margin``: also return the near-tie margin (split_scan.py:306-320),
    ``(best - runner_up) / max(|best|, 1e-15)`` in f32, where the runner-up
    is the best row of the other features or the winning feature's own
    second best (row column 6); +inf when either gain is not finite.  It
    comes back in the candidate's one host transfer."""
    parent = torch.tensor(
        [parent_g, parent_h, parent_cnt], dtype=torch.float32, device=hist.device
    )
    rows = split_scan(
        hist, parent, num_bins, nan_bins, feature_mask,
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )
    feat = torch.argmax(rows[:, 0])
    r = rows[feat]
    improvement = r[0] - leaf_gain(parent[0], parent[1], lambda_l1, lambda_l2) - min_gain_to_split
    parts = [improvement[None], r[:6], parent - r[3:6], feat.to(torch.float32)[None]]
    if with_margin:
        f = rows.shape[0]
        others = torch.where(
            torch.arange(f, device=rows.device) == feat, float("-inf"), rows[:, 0]
        )
        sec = torch.maximum(others.max(), r[6])
        margin = torch.where(
            torch.isfinite(r[0]) & torch.isfinite(sec),
            (r[0] - sec) / torch.clamp(r[0].abs(), min=_EPS),
            float("inf"),
        )
        parts.append(margin[None])
    vals = torch.cat(parts).tolist()
    gain = vals[0] if math.isfinite(vals[1]) else float("-inf")
    cand = SplitCandidate(
        gain, int(vals[10]), int(vals[2]), vals[3] > 0.5, vals[4], vals[5],
        vals[6], vals[7], vals[8], vals[9],
    )
    return (cand, vals[11]) if with_margin else cand
