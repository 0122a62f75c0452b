"""Per-leaf best-split scan: one launch computes every feature's best
numeric split of M leaf histograms, and, where asked, each leaf's
candidate.

Counterpart of ``lightgbm_tpu/ops/pallas/split_scan.py``: ``split_scan``
returns the ``[F, 8]`` rows (gain, bin, default_left, left g, left h, left
count, runner-up gain, 0) of ``split_scan_pallas`` (:187), and
``fused_best_split`` (:243) turns them into the leaf's ``SplitCandidate``
(the cross-feature argmax and the improvement over the parent, :286-334).
``split_scan_batch`` and ``fused_best_split_batch`` do the same for M
leaves at once -- the ``jax.vmap(_child_cand_b)`` refresh of the 2K
children of a frontier-batched step (lightgbm_tpu/ops/grower.py:2670-2712);
each member's rows and candidate are bit-equal to a single call on that
member.

Every entry dispatches on the histograms' device: the plain PyTorch
version on the CPU (``split_scan_plain``, then ``candidates_plain``), the
``csrc/split_scan.cu`` kernel on a CUDA device.  On the card
``fused_best_split_batch`` is ONE launch that scans and reduces each
member to its packed candidate row, then ONE copy of the M rows to the
host: the histograms' addresses, the parents and the scalars go in by
value, and the kernel's scratch, ticket counters and pinned host buffer
are made once per device.  The callers pass ``num_bins`` / ``nan_bins`` as
i32 and the feature mask as f32, on the card, made once a tree
(``scan_inputs``).  Launches are counted in ``_build.LAUNCHES``:
``'split_scan'`` (one leaf) or ``'split_scan_batch'`` (M leaves) for each
launch, and ``'split_candidates'`` for each launch that also reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import _build
from .split import _EPS, SplitCandidate, _ordered_cum, leaf_gain, split_gains

MAX_MEMBERS = 32  # leaves of one launch (csrc/split_scan.cu kMaxMembers)
CAND_COLS = 12  # the packed candidate row (csrc/split_scan.cu kCandCols)


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


def candidates_plain(rows: torch.Tensor, parent: torch.Tensor, *, lambda_l1: float,
                     lambda_l2: float, min_gain_to_split: float,
                     case_major: bool = False) -> torch.Tensor:
    """The packed candidates [M, 12] f32 of scan rows [M, F, 8] and parents
    [M, 3] f32 (g, h, count): (improvement, feature, bin, default_left,
    left g, h, count, right g, h, count, margin, 0), the reduction the
    kernel runs after its scan, in the same f32 operations.

    The feature is the first with the largest row gain (split_scan.py:
    286-334), or, with ``case_major``, the tie rule of ``best_split``'s
    argmax over [case, F, B] (lightgbm_tpu/ops/split.py:408), which the JAX
    package takes where its split-scan kernel is off (ops/grower.py:
    460-478): among the features whose row gain equals the largest, the
    first whose row goes missing-right, else the first.  A row's bin is
    already the first maximum of its winning case, so the rows carry all
    the rule needs.  The improvement is the gain less the parent's leaf
    gain and ``min_gain_to_split``, -inf where the gain is not finite.  The
    margin is the near-tie margin (split_scan.py:306-320), ``(best -
    runner_up) / max(|best|, 1e-15)``, where the runner-up is the best row
    of the other features or the winning feature's own second best (row
    column 6); +inf when either gain is not finite."""
    m, f = rows.shape[0], rows.shape[1]
    dev = rows.device
    gain = rows[..., 0]
    if case_major:
        # the first maximum of [case 0 (missing-right) | case 1] over the
        # features: a missing-right row's gain is its case-0 best, and a
        # missing-left row's case-0 best is below its gain, so it cannot
        # be the case-0 maximum and is left out there
        cases = torch.cat([torch.where(rows[..., 2] <= 0.5, gain, float("-inf")), gain], dim=1)
        feat = torch.argmax(cases, dim=1) % f  # [M]
    else:
        feat = torch.argmax(gain, dim=1)  # [M] first maximum
    r = rows[torch.arange(m, device=dev), feat]  # [M, 8]
    finite = torch.isfinite(r[:, 0])
    improvement = torch.where(
        finite,
        r[:, 0] - leaf_gain(parent[:, 0], parent[:, 1], lambda_l1, lambda_l2)
        - min_gain_to_split,
        float("-inf"),
    )
    others = torch.where(torch.arange(f, device=dev)[None, :] == feat[:, None],
                         float("-inf"), gain)
    sec = torch.maximum(others.max(dim=1).values, r[:, 6])
    margin = torch.where(
        finite & torch.isfinite(sec),
        (r[:, 0] - sec) / torch.clamp(r[:, 0].abs(), min=_EPS),
        float("inf"),
    )
    return torch.cat([improvement[:, None], feat.to(torch.float32)[:, None], r[:, 1:6],
                      parent - r[:, 3:6], margin[:, None], torch.zeros_like(margin)[:, None]],
                     dim=1)


def unpack_candidates(vals: Sequence[Sequence[float]], with_margin: bool):
    """Host candidates from packed rows (``candidates_plain``'s columns):
    a list of ``SplitCandidate``, or of (candidate, margin)."""
    out = []
    for v in vals:
        cand = SplitCandidate(v[0], int(v[1]), int(v[2]), v[3] > 0.5, v[4], v[5], v[6], v[7],
                              v[8], v[9])
        out.append((cand, v[10]) if with_margin else cand)
    return out


def scan_inputs(num_bins, nan_bins, feature_mask, device):
    """(num_bins i32, nan_bins i32, feature mask f32) contiguous on
    ``device``, as the kernel reads them: made once a tree by the grower;
    a tensor already so is passed on as it is."""
    def on(t, dt):
        if (isinstance(t, torch.Tensor) and t.dtype == dt and t.device == device
                and t.is_contiguous()):
            return t
        return torch.as_tensor(t).to(device=device, dtype=dt).contiguous()

    return on(num_bins, torch.int32), on(nan_bins, torch.int32), on(feature_mask, torch.float32)


@dataclasses.dataclass
class _Buffers:
    """A device's scratch for candidate launches: the rows [32, F, 8] (grown
    with F), the ticket counters (zero between launches), the candidates on
    the card and their pinned host copy."""

    rows: torch.Tensor
    tickets: torch.Tensor
    cand: torch.Tensor
    host: torch.Tensor


_BUFFERS: Dict[torch.device, _Buffers] = {}


def _buffers(dev: torch.device, f: int) -> _Buffers:
    buf = _BUFFERS.get(dev)
    if buf is None:
        buf = _Buffers(
            rows=torch.empty(0, dtype=torch.float32, device=dev),
            tickets=torch.zeros(MAX_MEMBERS, dtype=torch.int32, device=dev),
            cand=torch.empty((MAX_MEMBERS, CAND_COLS), dtype=torch.float32, device=dev),
            host=torch.empty((MAX_MEMBERS, CAND_COLS), dtype=torch.float32, pin_memory=True),
        )
        _BUFFERS[dev] = buf
    if buf.rows.numel() < MAX_MEMBERS * f * 8:
        buf.rows = torch.empty(MAX_MEMBERS * f * 8, dtype=torch.float32, device=dev)
    return buf


def _launch(hists: List[torch.Tensor], parents: np.ndarray, inputs, kw, rows_out=None,
            cand=None):
    """One launch of ``csrc/split_scan.cu`` over M <= 32 members: hists, M
    [F, B, 3] f32 tensors on the card; parents [M, 3] f32 on the host.
    With ``cand`` (min_gain, case_major): the M packed candidates, read
    back in one copy (a list of M lists of 12 floats); else the rows into
    ``rows_out`` [M, F, 8]."""
    m = len(hists)
    f, b, three = hists[0].shape
    dev = hists[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if b > 256 or three != 3:
        raise ValueError(f"split scan takes [F, B<=256, 3] histograms, got {tuple(hists[0].shape)}")
    if not 1 <= m <= MAX_MEMBERS:
        raise ValueError(f"split scan takes 1 to {MAX_MEMBERS} members a launch, got {m}")
    for h in hists:
        if h.shape != hists[0].shape or h.dtype != torch.float32 or not h.is_contiguous():
            raise ValueError("split scan members: contiguous f32 histograms of one shape")
    nb, nanb, mask = inputs
    ptrs = np.fromiter((h.data_ptr() for h in hists), np.int64, m)
    par = np.ascontiguousarray(parents, np.float32).reshape(m, 3)
    scal = (float(kw["lambda_l1"]), float(kw["lambda_l2"]),
            float(kw["min_data_in_leaf"]), float(kw["min_sum_hessian_in_leaf"]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cand is None:
        buf, rows, ticket_p, cand_p, host_p, min_gain, major = None, rows_out, None, None, None, 0.0, 0
    else:
        buf = _buffers(dev, f)
        rows, ticket_p, cand_p, host_p = (buf.rows, buf.tickets.data_ptr(), buf.cand.data_ptr(),
                                          buf.host.data_ptr())
        min_gain, major = float(cand[0]), int(bool(cand[1]))
    rc = _build.entry("split_scan")(
        ptrs.ctypes.data, par.ctypes.data, nb.data_ptr(), nanb.data_ptr(), mask.data_ptr(),
        m, f, b, f if mask.dim() == 2 else 0, *scal, rows.data_ptr(), min_gain, major,
        ticket_p, cand_p, host_p, stream,
    )
    _build.check(rc, "split_scan kernel")
    _build.LAUNCHES["split_scan" if m == 1 else "split_scan_batch"] += 1
    if buf is None:
        return rows_out
    _build.LAUNCHES["split_candidates"] += 1
    return buf.host[:m].tolist()


def _host_parents(parent, m: int) -> np.ndarray:
    if isinstance(parent, torch.Tensor):
        parent = parent.detach().cpu()
    return np.asarray(parent, np.float32).reshape(m, 3)


def _rows_launch(hist, parent, num_bins, nan_bins, feature_mask, kw) -> torch.Tensor:
    """The rows [M, F, 8] of hist [M, F, B, 3] on the card, in launches of
    at most 32 members."""
    m, f = hist.shape[0], hist.shape[1]
    dev = hist.device
    _member_masks(feature_mask, m)
    nb, nanb, mask = scan_inputs(num_bins, nan_bins, feature_mask, dev)
    par = _host_parents(parent, m)
    hist = hist.to(torch.float32).contiguous()
    out = torch.empty((m, f, 8), dtype=torch.float32, device=dev)
    for i in range(0, m, MAX_MEMBERS):
        j = min(m, i + MAX_MEMBERS)
        mk = mask[i:j] if mask.dim() == 2 else mask
        _launch(list(hist[i:j]), par[i:j], (nb, nanb, mk), kw, rows_out=out[i:j])
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
    return _rows_launch(hist[None], parent, num_bins, nan_bins, feature_mask, kw)[0]


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
    on the CPU, ONE launch of the ``csrc/split_scan.cu`` kernel per 32
    members on a CUDA device."""
    kw = _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)
    if hist.device.type == "cpu":
        return split_scan_batch_plain(hist, parent, num_bins, nan_bins, feature_mask, **kw)
    return _rows_launch(hist, parent, num_bins, nan_bins, feature_mask, kw)


def fused_best_split_batch(
    hist, parents, num_bins, nan_bins, feature_mask, *, lambda_l1: float,
    lambda_l2: float, min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
    min_gain_to_split: float, with_margin: bool = False, case_major: bool = False,
):
    """Best splits of M leaves: hist [M, F, B, 3] or a sequence of M [F, B,
    3] histograms, parents [M, 3] (g, h, count; host values or a tensor),
    feature_mask [F] or [M, F].  On the card ONE launch per 32 members (the
    scan and each member's candidate) and ONE copy of the packed
    candidates to the host; on the CPU ``split_scan_batch_plain`` and
    ``candidates_plain``.  Returns a list of M candidates, or of
    (candidate, margin) with ``with_margin``; member i equals
    ``fused_best_split`` of member i alone."""
    kw = _scan_kwargs(lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)
    hists = list(hist)
    m = len(hists)
    if hists[0].device.type == "cpu":
        stacked = torch.stack(hists)
        parent = torch.as_tensor(_host_parents(parents, m))
        rows = split_scan_batch_plain(stacked, parent, num_bins, nan_bins, feature_mask, **kw)
        packed = candidates_plain(rows, parent, lambda_l1=lambda_l1, lambda_l2=lambda_l2,
                                  min_gain_to_split=min_gain_to_split, case_major=case_major)
        return unpack_candidates(packed.tolist(), with_margin)
    par = _host_parents(parents, m)
    inputs = scan_inputs(num_bins, nan_bins, feature_mask, hists[0].device)
    nb, nanb, mask = inputs
    if mask.dim() == 2:
        _member_masks(mask, m)
    vals = []
    for i in range(0, m, MAX_MEMBERS):
        j = min(m, i + MAX_MEMBERS)
        mk = mask[i:j] if mask.dim() == 2 else mask
        vals += _launch(hists[i:j], par[i:j], (nb, nanb, mk), kw,
                        cand=(min_gain_to_split, case_major))
    return unpack_candidates(vals, with_margin)


def fused_best_split(
    hist, parent_g: float, parent_h: float, parent_cnt: float, num_bins,
    nan_bins, feature_mask, *, lambda_l1: float, lambda_l2: float,
    min_data_in_leaf: int, min_sum_hessian_in_leaf: float,
    min_gain_to_split: float, with_margin: bool = False, case_major: bool = False,
):
    """The leaf's best split (``fused_best_split_batch`` of one member);
    with ``with_margin`` also its near-tie margin, which comes back in the
    candidate's one host transfer; ``case_major`` picks the tie rule
    (``candidates_plain``)."""
    return fused_best_split_batch(
        [hist], [(parent_g, parent_h, parent_cnt)], num_bins, nan_bins, feature_mask,
        lambda_l1=lambda_l1, lambda_l2=lambda_l2, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=min_gain_to_split, with_margin=with_margin, case_major=case_major,
    )[0]
