"""Per-leaf best-split scan: one launch computes every feature's best
numeric split of a leaf histogram, or of M leaf histograms.

Counterpart of ``lightgbm_tpu/ops/pallas/split_scan.py``: ``split_scan``
returns the ``[F, 8]`` rows (gain, bin, default_left, left g, left h, left
count, runner-up gain, 0) of ``split_scan_pallas`` (:187), and
``fused_best_split`` (:243) turns them into the leaf's ``SplitCandidate``
(the cross-feature argmax and the improvement over the parent, :286-334).
``split_scan_batch`` and ``fused_best_split_batch`` do the same for M
leaves at once -- the ``jax.vmap(_child_cand_b)`` refresh of the 2K
children of a frontier-batched step (lightgbm_tpu/ops/grower.py:2670-2712)
-- in one launch and one host transfer; each member's rows and candidate
are bit-equal to a single call on that member.

``split_scan`` and ``split_scan_batch`` dispatch on the histogram's device:
the plain PyTorch version on the CPU, the ``csrc/split_scan.cu`` kernel on
a CUDA device (launches counted in ``_build.LAUNCHES['split_scan']`` and
``['split_scan_batch']``).
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


def _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf):
    return dict(
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )


def _launch(hist, parent, num_bins, nan_bins, feature_mask, counted_as, kw):
    """One launch of ``csrc/split_scan.cu`` over hist [M, F, B, 3] ->
    [M, F, 8], counted as ``counted_as`` ('split_scan' for one leaf,
    'split_scan_batch' for M leaves)."""
    if hist.device.type != "cuda":
        raise ValueError(f"no kernel for device {hist.device}")
    m, f, b, three = hist.shape
    if b > 256 or three != 3:
        raise ValueError(f"split scan takes [F, B<=256, 3] histograms, got {tuple(hist.shape[1:])}")
    dev = hist.device
    hist = hist.to(torch.float32).contiguous()
    parent = parent.to(device=dev, dtype=torch.float32).reshape(m, 3).contiguous()
    nb = num_bins.to(device=dev, dtype=torch.int32).contiguous()
    nanb = nan_bins.to(device=dev, dtype=torch.int32).contiguous()
    mask = feature_mask.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((m, f, 8), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scal = (float(kw["lambda_l1"]), float(kw["lambda_l2"]),
            float(kw["min_data_in_leaf"]), float(kw["min_sum_hessian_in_leaf"]))
    rc = _build.entry("split_scan")(
        hist.data_ptr(), parent.data_ptr(), nb.data_ptr(), nanb.data_ptr(),
        mask.data_ptr(), m, f, b, f if mask.dim() == 2 else 0, *scal,
        out.data_ptr(), stream,
    )
    _build.check(rc, "split_scan kernel")
    _build.LAUNCHES[counted_as] += 1
    return out


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
    kw = _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)
    if hist.device.type == "cpu":
        return split_scan_plain(hist, parent, num_bins, nan_bins, feature_mask, **kw)
    return _launch(hist[None], parent, num_bins, nan_bins, feature_mask, "split_scan", kw)[0]


def _member_masks(feature_mask: torch.Tensor, m: int) -> torch.Tensor:
    """[M, F] per-member feature masks from one [F] mask or [M, F] masks."""
    if feature_mask.dim() == 1:
        return feature_mask[None].expand(m, -1)
    if feature_mask.shape[0] != m:
        raise ValueError(f"feature masks: {feature_mask.shape[0]} rows for {m} members")
    return feature_mask


def split_scan_batch_plain(
    hist, parent, num_bins, nan_bins, feature_mask, *, lambda_l1: float,
    lambda_l2: float, min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
) -> torch.Tensor:
    """[M, F, 8]: ``split_scan_plain`` of each member."""
    kw = _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)
    masks = _member_masks(feature_mask, hist.shape[0])
    return torch.stack([
        split_scan_plain(hist[i], parent[i], num_bins, nan_bins, masks[i], **kw)
        for i in range(hist.shape[0])
    ])


def split_scan_batch(
    hist: torch.Tensor,  # [M, F, B, 3] f32
    parent: torch.Tensor,  # [M, 3] f32 (g, h, count) per member
    num_bins: torch.Tensor,  # [F] i32
    nan_bins: torch.Tensor,  # [F] i32
    feature_mask: torch.Tensor,  # [F] or [M, F] bool
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: int,
    min_sum_hessian_in_leaf: float,
) -> torch.Tensor:
    """Per-feature best rows [M, F, 8] of M leaf histograms: plain version
    on the CPU, ONE launch of the ``csrc/split_scan.cu`` batched entry on a
    CUDA device."""
    kw = _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)
    if hist.device.type == "cpu":
        return split_scan_batch_plain(hist, parent, num_bins, nan_bins, feature_mask, **kw)
    _member_masks(feature_mask, hist.shape[0])
    return _launch(hist, parent, num_bins, nan_bins, feature_mask, "split_scan_batch", kw)


def _candidates(rows, parent, *, lambda_l1: float, lambda_l2: float,
                min_gain_to_split: float, with_margin: bool, case_major: bool = False):
    """M candidates from scan rows [M, F, 8] and parents [M, 3]: first
    feature with the largest row gain (split_scan.py:286-334), in one set
    of tensor operations and ONE host transfer.

    ``case_major``: the tie rule of ``best_split``'s argmax over [case, F,
    B] (lightgbm_tpu/ops/split.py:408), which the JAX package takes where
    its split-scan kernel is off (ops/grower.py:460-478): among the
    features whose row gain equals the largest, the first whose row goes
    missing-right, else the first.  A row's bin is already the first
    maximum of its winning case, so the rows carry all the rule needs.

    ``with_margin``: also the near-tie margin (split_scan.py:306-320),
    ``(best - runner_up) / max(|best|, 1e-15)`` in f32, where the runner-up
    is the best row of the other features or the winning feature's own
    second best (row column 6); +inf when either gain is not finite."""
    m, f = rows.shape[0], rows.shape[1]
    dev = rows.device
    if case_major:
        # the first maximum of [case 0 (missing-right) | case 1] over the
        # features: a missing-right row's gain is its case-0 best, and a
        # missing-left row's case-0 best is below its gain, so it cannot
        # be the case-0 maximum and is left out there
        gain = rows[..., 0]
        cases = torch.cat([torch.where(rows[..., 2] <= 0.5, gain, float("-inf")), gain], dim=1)
        feat = torch.argmax(cases, dim=1) % f  # [M]
    else:
        feat = torch.argmax(rows[..., 0], dim=1)  # [M] first maximum
    r = rows[torch.arange(m, device=dev), feat]  # [M, 8]
    improvement = (
        r[:, 0] - leaf_gain(parent[:, 0], parent[:, 1], lambda_l1, lambda_l2)
        - min_gain_to_split
    )
    parts = [improvement[:, None], r[:, :6], parent - r[:, 3:6],
             feat.to(torch.float32)[:, None]]
    if with_margin:
        others = torch.where(
            torch.arange(f, device=dev)[None, :] == feat[:, None], float("-inf"),
            rows[..., 0],
        )
        sec = torch.maximum(others.max(dim=1).values, r[:, 6])
        margin = torch.where(
            torch.isfinite(r[:, 0]) & torch.isfinite(sec),
            (r[:, 0] - sec) / torch.clamp(r[:, 0].abs(), min=_EPS),
            float("inf"),
        )
        parts.append(margin[:, None])
    out = []
    for vals in torch.cat(parts, dim=1).tolist():
        gain = vals[0] if math.isfinite(vals[1]) else float("-inf")
        cand = SplitCandidate(
            gain, int(vals[10]), int(vals[2]), vals[3] > 0.5, vals[4], vals[5],
            vals[6], vals[7], vals[8], vals[9],
        )
        out.append((cand, vals[11]) if with_margin else cand)
    return out


def fused_best_split(
    hist, parent_g: float, parent_h: float, parent_cnt: float, num_bins,
    nan_bins, feature_mask, *, lambda_l1: float, lambda_l2: float,
    min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
    min_gain_to_split: float, with_margin: bool = False, case_major: bool = False,
):
    """The leaf's best split from the scan rows of one ``split_scan``
    launch; with ``with_margin`` also its near-tie margin
    (``_candidates``), which comes back in the candidate's one host
    transfer; ``case_major`` picks the tie rule (``_candidates``)."""
    parent = torch.tensor(
        [[parent_g, parent_h, parent_cnt]], dtype=torch.float32, device=hist.device
    )
    rows = split_scan(
        hist, parent[0], num_bins, nan_bins, feature_mask,
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )
    return _candidates(
        rows[None], parent, lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_gain_to_split=min_gain_to_split, with_margin=with_margin,
        case_major=case_major,
    )[0]


def fused_best_split_batch(
    hist, parents, num_bins, nan_bins, feature_mask, *, lambda_l1: float,
    lambda_l2: float, min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
    min_gain_to_split: float, with_margin: bool = False, case_major: bool = False,
):
    """Best splits of M leaves: hist [M, F, B, 3], parents [M, 3] (g, h,
    count; host values or a tensor), feature_mask [F] or [M, F].  One
    ``split_scan_batch`` launch, then the M argmaxes, gains and (with
    ``with_margin``) margins in one set of tensor operations and ONE host
    transfer.  Returns a list of M candidates, or of (candidate, margin);
    member i equals ``fused_best_split`` of member i alone."""
    parent = torch.as_tensor(parents, dtype=torch.float32).to(hist.device).reshape(-1, 3)
    rows = split_scan_batch(
        hist, parent, num_bins, nan_bins, feature_mask,
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )
    return _candidates(
        rows, parent, lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_gain_to_split=min_gain_to_split, with_margin=with_margin,
        case_major=case_major,
    )
