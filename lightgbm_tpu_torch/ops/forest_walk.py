"""Batch prediction: node tables, device binning and the forest walk.

Counterpart of ``lightgbm_tpu/ops/pallas/forest_walk.py``:

  * ``walk_reject_reason`` (:101-149) says why the kernel cannot walk a
    model (more than 512 features, bins or NaN bins past a byte, too many
    nodes per tree, tables past the kernel's shared memory); the booster
    then walks with the plain level-synchronous walker of predict.py on
    the same device, as the JAX package falls back to its XLA walker;
  * ``build_tables`` (:158) stacks bin-space tree records into per-tree
    node tables, in the port's own encoding (one i32 of split data and one
    i32 of two i16 children per node, see ``csrc/forest_walk.cu``);
  * ``bin_numeric`` (:512) is value -> bin on the device in f32, flagging
    the rows whose f32 compare could disagree with the exact f64 host
    binning; the caller re-bins those rows on the host;
  * ``forest_walk`` (:367) walks every row through every tree: the plain
    PyTorch version on the CPU, the ``csrc/forest_walk.cu`` kernel on a
    CUDA device (launches counted in ``_build.LAUNCHES['forest_walk']``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build
from ..binning import K_ZERO_THRESHOLD, MissingType
from ..predict import BinTreeBatch, predict_bins_raw

MAX_BIN_VALUE = 256  # bins are bytes; thresholds and NaN bins fit 9 bits
MAX_F = 512  # 9-bit feature field of a node
MAX_NODES = 1 << 15  # children are i16 node indices
# dynamic shared memory of csrc/forest_walk.cu (kSharedBytes): one tree's
# tables, 8 bytes a node and 4 a leaf, must fit
SHARED_TABLE_BYTES = 48 * 1024


def walk_reject_reason(
    records: Sequence[dict], nan_bins: np.ndarray, num_features: int, max_bin: int
):
    """None when the walk kernel can run this model, else why not (the
    checks of the JAX package's ``walk_reject_reason`` that apply to the
    port's kernel)."""
    if num_features > MAX_F:
        return f"{num_features} features > {MAX_F}"
    if max_bin > MAX_BIN_VALUE:
        return f"max_bin {max_bin} > {MAX_BIN_VALUE} (bins must fit a byte)"
    if len(nan_bins) and int(np.max(nan_bins)) >= MAX_BIN_VALUE:
        return f"NaN bin {int(np.max(nan_bins))} >= {MAX_BIN_VALUE}"
    m_nodes = m_leaves = 1
    for r in records:
        sf = r["split_feature"]
        if len(sf) >= MAX_NODES:
            return f"a tree has {len(sf)} splits >= {MAX_NODES}"
        if len(sf) and int(np.max(np.asarray(r["split_bin"]))) >= MAX_BIN_VALUE:
            return f"a split threshold bin >= {MAX_BIN_VALUE}"
        m_nodes = max(m_nodes, len(sf))
        m_leaves = max(m_leaves, len(r["leaf_value"]))
    table_bytes = m_nodes * 8 + m_leaves * 4
    if table_bytes > SHARED_TABLE_BYTES:
        return (f"one tree's tables ({table_bytes} bytes) exceed the walk "
                f"kernel's {SHARED_TABLE_BYTES} bytes of shared memory")
    return None


class ForestTables(NamedTuple):
    """Walk tables of T trees, M nodes and Lm leaves per tree at most."""

    node: torch.Tensor  # [T, M] i32: thr | feat<<9 | dl<<18 | (nanb+1)<<19
    child: torch.Tensor  # [T, M] i32: (left & 0xFFFF) | right<<16, i16 each
    leaf: torch.Tensor  # [T, Lm] f32 leaf values
    n_trees: int


def build_tables(
    records: Sequence[dict], nan_bins: np.ndarray, device
) -> ForestTables:
    """Stack bin-space records (split_feature, split_bin, default_left,
    left_child, right_child, leaf_value) into walk tables on ``device``."""
    t = len(records)
    m = max([len(r["split_feature"]) for r in records] + [1])
    lm = max(len(r["leaf_value"]) for r in records)
    node = np.zeros((t, m), np.int64)
    child = np.zeros((t, m), np.int64)
    leaf = np.zeros((t, lm), np.float32)
    nan_bins = np.asarray(nan_bins, np.int64)
    for i, r in enumerate(records):
        sf = np.asarray(r["split_feature"], np.int64)
        nn = len(sf)
        lv = np.asarray(r["leaf_value"], np.float32)
        leaf[i, : len(lv)] = lv
        if nn == 0:
            # single-leaf tree: node 0 sends every row to leaf 0
            child[i, 0] = (~0 & 0xFFFF) | ((~0 & 0xFFFF) << 16)
            continue
        thr = np.asarray(r["split_bin"], np.int64)
        if thr.max() >= MAX_BIN_VALUE or sf.max() >= MAX_F:
            raise ValueError("forest walk tables need bins < 256 and < 512 features")
        dl = np.asarray(r["default_left"], np.int64)
        lc = np.asarray(r["left_child"], np.int64)
        rc = np.asarray(r["right_child"], np.int64)
        node[i, :nn] = thr | (sf << 9) | (dl << 18) | ((nan_bins[sf] + 1) << 19)
        child[i, :nn] = (lc & 0xFFFF) | ((rc & 0xFFFF) << 16)
    as_i32 = lambda a: torch.as_tensor(a.astype(np.uint32).view(np.int32), device=device)
    return ForestTables(
        node=as_i32(node),
        child=as_i32(child),
        leaf=torch.as_tensor(leaf, device=device),
        n_trees=t,
    )


def forest_walk_plain(bins: torch.Tensor, tables: ForestTables, k: int) -> torch.Tensor:
    """The plain version: decode the tables and run the level-synchronous
    walker of predict.py.  bins [N, F] u8 -> [N, k] f32."""
    node = tables.node.long()
    child = tables.child.long()
    i16 = lambda x: torch.where(x >= 0x8000, x - 0x10000, x)
    batch = BinTreeBatch(
        split_feature=(node >> 9) & 0x1FF,
        split_bin=node & 0x1FF,
        default_left=((node >> 18) & 1) != 0,
        nan_bin=((node >> 19) & 0x1FF) - 1,
        left_child=i16(child & 0xFFFF),
        right_child=i16((child >> 16) & 0xFFFF),
        leaf_value=tables.leaf,
    )
    return predict_bins_raw(batch, bins, k)


def forest_walk(bins: torch.Tensor, tables: ForestTables, k: int) -> torch.Tensor:
    """Raw scores [N, k] of bins [N, F] u8: plain version on the CPU, the
    ``csrc/forest_walk.cu`` kernel on a CUDA device."""
    if bins.device.type == "cpu":
        return forest_walk_plain(bins, tables, k)
    if bins.device.type != "cuda":
        raise ValueError(f"no kernel for device {bins.device}")
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise ValueError("forest walk takes [N, F] u8 bins")
    bins = bins.contiguous()
    n, f = bins.shape
    out = torch.empty((n, k), dtype=torch.float32, device=bins.device)
    fn = _build.entry("forest_walk")
    rc = fn(
        bins.data_ptr(), tables.node.data_ptr(), tables.child.data_ptr(),
        tables.leaf.data_ptr(), n, f, tables.n_trees,
        int(tables.node.shape[1]), int(tables.leaf.shape[1]), int(k),
        out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
    )
    _build.check(rc, "forest_walk kernel")
    _build.LAUNCHES["forest_walk"] += 1
    return out


def build_devbin_tables(mappers, used_features, device):
    """(ub [F, Bmax] f32 +inf padded, nan_bin [F] i32, missing_type [F] i32)
    of the used features' mappers, for ``bin_numeric``."""
    ubs = [np.asarray(mappers[j].bin_upper_bound, np.float64) for j in used_features]
    bmax = max((len(u) for u in ubs), default=1)
    ub = np.full((len(ubs), bmax), np.inf, np.float64)
    for i, u in enumerate(ubs):
        ub[i, : len(u)] = u
    nanb = np.asarray([mappers[j].nan_bin for j in used_features], np.int32)
    mtype = np.asarray([mappers[j].missing_type for j in used_features], np.int32)
    return (
        torch.as_tensor(ub.astype(np.float32), device=device),
        torch.as_tensor(nanb, device=device),
        torch.as_tensor(mtype, device=device),
    )


def bin_numeric(x: torch.Tensor, ub: torch.Tensor, nanb: torch.Tensor, mtype: torch.Tensor):
    """Value -> bin in f32 (BinMapper::ValueToBin, bin.h:173):
    bin = #{upper bounds < v}, with the NaN / zero missing rules.

    Returns (bins [N, F] i32, suspect [N] bool).  A row is suspect when a
    value lies within 8 f32 ulps of one of the two bounds around it — only
    there can the f32 compare disagree with the f64 host rule."""
    isnan = torch.isnan(x)
    safe = torch.where(isnan, torch.zeros_like(x), x)
    bmax = ub.shape[1]
    idx_fn = torch.searchsorted(ub, safe.T.contiguous())  # [F, N] #{ub < v}
    eps = 8.0 * torch.finfo(torch.float32).eps
    suspect = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for nb_idx in (idx_fn - 1, idx_fn):  # the bounds below and above v
        bound = torch.gather(ub, 1, nb_idx.clamp(0, bmax - 1)).T
        tol = eps * torch.maximum(safe.abs(), bound.abs())
        near = ((safe - bound).abs() <= tol) & torch.isfinite(bound)
        suspect |= near.any(dim=1)
    idx = idx_fn.T.to(torch.int32)
    miss_zero = (mtype[None, :] == MissingType.ZERO) & (
        isnan | (safe.abs() <= K_ZERO_THRESHOLD)
    )
    miss_nan = (mtype[None, :] == MissingType.NAN) & isnan & (nanb[None, :] >= 0)
    bins = torch.where(miss_zero | miss_nan, nanb[None, :].expand_as(idx), idx)
    return bins, suspect
