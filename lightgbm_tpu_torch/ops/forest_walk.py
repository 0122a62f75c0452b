"""Batch prediction: node tables, device binning and the forest walk.

Counterpart of ``lightgbm_tpu/ops/pallas/forest_walk.py``:

  * ``walk_reject_reason`` (:101-149) says why the kernel cannot walk a
    model (more than 512 features, bins or NaN bins past a byte, too many
    nodes per tree, tables past the kernel's shared memory, a categorical
    mask wider than 256 bins or claiming bin 255, the predict sentinel of
    unseen categories, :124-137); the booster
    then walks with the plain level-synchronous walker of predict.py on
    the same device, as the JAX package falls back to its XLA walker;
  * ``build_tables`` (:158) stacks bin-space tree records into per-tree
    tables in the port's own encoding (an 8-byte record a node, then the
    leaf values, then a 256-bit bitset of each categorical node, and the
    NaN-left words; see ``csrc/forest_walk.cu``), and
    ``walk_plan`` gives the kernel's launch plan for a call's shapes;
  * ``bin_numeric`` (:512) is value -> bin on the device in f32, flagging
    the rows whose f32 compare could disagree with the exact f64 host
    binning; the caller re-bins those rows on the host;
  * ``forest_walk`` (:367) walks every row through every tree: the plain
    PyTorch version on the CPU, the ``csrc/forest_walk.cu`` kernel on a
    CUDA device (launches counted in ``_build.LAUNCHES['forest_walk']``, as
    ``'forest_walk_cat'`` too when the tables hold a categorical node, and
    as ``'forest_walk_multi'`` too in the class mode, k > 1 trees an
    iteration: any k, in blocks of at most 8 classes, a grid dimension).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build
from ..binning import K_ZERO_THRESHOLD, MissingType
from ..predict import BinTreeBatch, predict_bins_raw, walk_levels

MAX_BIN_VALUE = 256  # bins, thresholds and NaN bins are bytes
MAX_F = 512  # a node's staged word, NaN-left ones included, fits a byte (kMaxF)
MAX_NODES = 1 << 15  # splits a tree, at most (the table size below binds first)
# one tree's tables, counted as 8 bytes a node and 4 a leaf, must fit this
# many bytes (the earlier kernel's check, kept); every chunk of the kernel
# then holds at least one tree (walk_plan)
SHARED_TABLE_BYTES = 48 * 1024
CAT_MARKER = 0x01  # byte 0 of a categorical node's record (0x54: numeric)
CAT_BITSET_BYTES = 32  # a categorical node's bitset: 256 bins, 8 words

# the launch plan of csrc/forest_walk.cu (FW_ROWS, kMaxThreads, kSinkBytes
# there; tests/test_torch_forest_walk.py checks the source)
ROWS_PER_THREAD = 2
MAX_THREADS = 512
SINK_BYTES = 16
BLOCK_SHARED = 113 * 1024  # a block's shared memory: two blocks a multiprocessor
MAX_BLOCK_SHARED = 227 * 1024  # the most a block can take (one a multiprocessor)
BIN_SHARED = 64 * 1024  # at most this much of it for a tile's staged words
MAX_GROUPS = MAX_THREADS // 16  # groups of threads on a tile's rows, at most
CLASS_BLOCK = 8  # classes a block walks (kMaxClass): the register accumulators


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
    m_cat = 0
    for r in records:
        sf = r["split_feature"]
        if len(sf) >= MAX_NODES:
            return f"a tree has {len(sf)} splits >= {MAX_NODES}"
        cat = _cat_nodes(r)
        if cat.any():
            cm = np.asarray(r["cat_mask"], bool)
            if cm.shape[-1] > MAX_BIN_VALUE:
                return "a categorical mask is wider than 256 bins"
            if cm.shape[-1] >= MAX_BIN_VALUE and cm[cat][:, MAX_BIN_VALUE - 1].any():
                return "a categorical mask claims bin 255 (sentinel clash)"
        num = ~cat
        if num.any() and int(np.max(np.asarray(r["split_bin"])[num])) >= MAX_BIN_VALUE:
            return f"a split threshold bin >= {MAX_BIN_VALUE}"
        m_nodes = max(m_nodes, len(sf))
        m_leaves = max(m_leaves, len(r["leaf_value"]))
        m_cat = max(m_cat, int(cat.sum()))
    table_bytes = m_nodes * 8 + m_leaves * 4 + m_cat * CAT_BITSET_BYTES
    if table_bytes > SHARED_TABLE_BYTES:
        return (f"one tree's tables ({table_bytes} bytes) exceed the walk "
                f"kernel's {SHARED_TABLE_BYTES} bytes of shared memory")
    return None


def _cat_nodes(r: dict) -> np.ndarray:
    """[nodes] bool: the record's categorical (goes-left-by-table) nodes."""
    sic = r.get("split_is_cat")
    n = len(r["split_feature"])
    if sic is None or r.get("cat_mask") is None or not np.size(sic):
        return np.zeros(n, bool)
    return np.asarray(sic, bool)[:n]


class ForestTables(NamedTuple):
    """Walk tables of T trees for rows of ``n_words`` staged words (``F``
    bins, 4 a word): one row of ``2 * m_nodes + m_leaves + 8 * m_cat`` words
    a tree, the node records, the leaf values, then the categorical nodes'
    bitsets, and the NaN-left words (``build_tables``)."""

    tables: torch.Tensor  # [T, 2M + Lm + 8C] i32
    nan_words: torch.Tensor  # [W_A, 3] i32: (word, its features' NaN bins, 0xFF mask)
    nan_bins: torch.Tensor  # [F] i64, -1 where a feature has none
    n_words: int  # W = ceil(F / 4)
    m_nodes: int  # M: node records a tree, even
    m_leaves: int  # Lm: leaf values a tree, a multiple of 4
    n_trees: int
    m_cat: int = 0  # C: categorical nodes' bitsets a tree (0: a numeric forest)


def _nan_words(nan_bins: np.ndarray) -> np.ndarray:
    """[W_A, 3] u32 of the words that hold a feature with a NaN bin: (the
    word, its four features' NaN bins as bytes, a 0xFF mask of the bytes
    that have one)."""
    f = len(nan_bins)
    nb = np.full(4 * (-(-f // 4)), -1, np.int64)
    nb[:f] = nan_bins
    nb = nb.reshape(-1, 4)
    has = nb >= 0
    shift = np.arange(0, 32, 8)
    rows = [(q, int((np.where(has[q], nb[q], 0) << shift).sum()),
             int((np.where(has[q], 0xFF, 0) << shift).sum()))
            for q in range(len(nb)) if has[q].any()]
    return np.asarray(rows, np.uint32).reshape(-1, 3)


def _split_word(sf, thr, dl, nan_bins, n_words, nan_word_of):
    """The node records' first word: the selector bytes 0x54, 0x06 | (feat
    & 3) << 4 (the byte permute that puts the feature's byte of the staged
    word in place of thr), the staged word (bits 16-23: the row's word
    feat >> 2, or its NaN-left word where the node sends missing values left
    and the feature has a NaN bin) and thr (bits 24-31)."""
    nan_left = (dl != 0) & (nan_bins[sf] >= 0)
    word = np.where(nan_left, n_words + nan_word_of[sf >> 2], sf >> 2)
    return 0x54 | ((0x06 | (sf & 3) << 4) << 8) | (word << 16) | (thr << 24)


def _cat_word(sf, off):
    """The first word of a categorical node's record: byte 0 CAT_MARKER,
    byte 1 (feat & 3) | (o & 0x3F) << 2, byte 2 the row's staged word feat
    >> 2 (a categorical node never reads a NaN-left word: its mask never
    holds the NaN bin), byte 3 o >> 6, for o its bitset's byte offset in
    the tree's tables over 4 (14 bits: the tables stay below 64 KB)."""
    o = off // 4
    return (CAT_MARKER | (((sf & 3) | (o & 0x3F) << 2) << 8) | ((sf >> 2) << 16)
            | ((o >> 6) << 24))


def build_tables(
    records: Sequence[dict], nan_bins: np.ndarray, device
) -> ForestTables:
    """Stack bin-space records (split_feature, split_bin, default_left,
    left_child, right_child, leaf_value; split_is_cat and cat_mask where
    categorical nodes go left by their category masks) into walk tables on
    ``device``: per tree M node records of two words (``_split_word``, or
    ``_cat_word`` for a categorical node; left | right << 16, each the u16
    byte offset of the child in the tree's tables: 8 * i for node i, 8 * M +
    4 * j for leaf j), then Lm f32 leaf values, then C 256-bit bitsets (8
    words, bit v & 31 of word v >> 5 for bin v) of the tree's categorical
    nodes in node order, M even and Lm a multiple of 4 so every tree is
    16-byte aligned; and the NaN-left words of the features' NaN bins
    (``nan_bins``, one a used feature)."""
    t = len(records)
    m = max([len(r["split_feature"]) for r in records] + [1])
    m += m % 2
    lm = max(len(r["leaf_value"]) for r in records)
    lm = -(-lm // 4) * 4
    cats = [_cat_nodes(r) for r in records]
    mc = max([int(c.sum()) for c in cats] + [0])
    if 8 * m + 4 * lm + CAT_BITSET_BYTES * mc > 0x10000:
        raise ValueError("a tree's tables pass the u16 child offsets of the walk tables")
    nan_bins = np.asarray(nan_bins, np.int64)
    n_words = -(-len(nan_bins) // 4)
    nan_words = _nan_words(nan_bins)
    nan_word_of = np.zeros(max(n_words, 1), np.int64)
    nan_word_of[nan_words[:, 0].astype(np.int64)] = np.arange(len(nan_words))
    words = np.zeros((t, 2 * m + lm + 8 * mc), np.uint32)
    for i, r in enumerate(records):
        sf = np.asarray(r["split_feature"], np.int64)
        nn = len(sf)
        lv = np.asarray(r["leaf_value"], np.float32)
        words[i, 2 * m: 2 * m + len(lv)] = lv.view(np.uint32)
        if nn == 0:
            # single-leaf tree: node 0 sends every row to leaf 0
            words[i, 1] = 8 * m | (8 * m) << 16
            continue
        thr = np.asarray(r["split_bin"], np.int64)
        cat = cats[i]
        thr = np.where(cat, 0, thr)
        if thr.max() >= MAX_BIN_VALUE or sf.max() >= MAX_F:
            raise ValueError("forest walk tables need bins < 256 and < 512 features")
        dl = np.asarray(r["default_left"], np.int64)
        lc = np.asarray(r["left_child"], np.int64)
        rc = np.asarray(r["right_child"], np.int64)
        words[i, 0: 2 * nn: 2] = _split_word(sf, thr, dl, nan_bins, n_words, nan_word_of)
        if cat.any():
            nodes = np.flatnonzero(cat)
            cm = np.asarray(r["cat_mask"], bool)[nodes, :MAX_BIN_VALUE]
            if cm.shape[1] >= MAX_BIN_VALUE and cm[:, MAX_BIN_VALUE - 1].any():
                raise ValueError("a categorical mask claims bin 255, the predict sentinel")
            bits = np.zeros((len(nodes), MAX_BIN_VALUE), np.int64)
            bits[:, : cm.shape[1]] = cm
            at = 2 * m + lm + 8 * np.arange(len(nodes))
            words[i, 2 * nodes] = _cat_word(sf[nodes], 4 * at)
            for a, row in zip(at, bits.reshape(len(nodes), 8, 32)):
                words[i, a: a + 8] = (row << np.arange(32)).sum(axis=1).astype(np.uint32)
        off = lambda c: np.where(c >= 0, 8 * c, 8 * m + 4 * ~c)  # noqa: E731
        words[i, 1: 2 * nn: 2] = off(lc) | (off(rc) << 16)
    return ForestTables(
        tables=torch.as_tensor(words.view(np.int32), device=device),
        nan_words=torch.as_tensor(nan_words.view(np.int32), device=device),
        nan_bins=torch.as_tensor(nan_bins, device=device),
        n_words=n_words, m_nodes=m, m_leaves=lm, n_trees=t, m_cat=mc,
    )


def decode_tables(tables: ForestTables) -> BinTreeBatch:
    """The stacked trees of the plain walker that route every row as the
    tables do: a node that reads a NaN-left word sends missing values left,
    a categorical node goes left by its bitset (a [256] mask)."""
    m, nw, lm = tables.m_nodes, tables.n_words, tables.m_leaves
    w = tables.tables.long() & 0xFFFFFFFF
    x, y = w[:, 0: 2 * m: 2], w[:, 1: 2 * m: 2]
    word = (x >> 16) & 0xFF
    is_cat = (x & 0xFF) == CAT_MARKER
    nan_left = (word >= nw) & ~is_cat
    q_of = torch.cat([torch.arange(nw, device=w.device), tables.nan_words[:, 0].long()])
    feat = q_of[word] * 4 + torch.where(is_cat, (x >> 8) & 3, (x >> 12) & 3)
    # a categorical node's bitset: 8 words at byte offset 4 * o
    o = ((x >> 10) & 0x3F) | ((x >> 24) << 6)
    span = torch.arange(8, device=w.device)
    at = torch.where(is_cat, o, 2 * m + lm)[..., None] + span  # [T, M, 8] word index
    width = int(w.shape[1])
    bitset = torch.gather(w, 1, at.clamp(max=width - 1).reshape(w.shape[0], -1))
    bitset = bitset.reshape(at.shape)
    mask = ((bitset[..., None] >> torch.arange(32, device=w.device)) & 1).bool()
    cat_mask = (mask.reshape(x.shape + (MAX_BIN_VALUE,)) & is_cat[..., None]
                if tables.m_cat else torch.zeros(x.shape + (1,), dtype=torch.bool,
                                                 device=w.device))
    # a child's byte offset -> node index, or ~leaf past the node records
    child = lambda off: torch.where(off < 8 * m, off // 8, ~((off - 8 * m) // 4))  # noqa: E731
    nan_bins = torch.cat([tables.nan_bins, torch.full((4 * nw - len(tables.nan_bins),), -1,
                                                      device=w.device, dtype=torch.long)])
    left, right = child(y & 0xFFFF), child(y >> 16)
    return BinTreeBatch(
        split_feature=feat,
        split_bin=torch.where(is_cat, 0, x >> 24),
        default_left=nan_left,
        nan_bin=nan_bins[feat],
        left_child=left,
        right_child=right,
        leaf_value=tables.tables[:, 2 * m:].contiguous().view(torch.float32),
        split_is_cat=is_cat,
        cat_mask=cat_mask,
        levels=walk_levels(zip(left.cpu().numpy(), right.cpu().numpy())),
    )


def forest_walk_plain(bins: torch.Tensor, tables: ForestTables, k: int) -> torch.Tensor:
    """The plain version: decode the tables and run the level-synchronous
    walker of predict.py.  bins [N, F] u8 -> [N, k] f32."""
    return predict_bins_raw(decode_tables(tables), bins, k)


class WalkPlan(NamedTuple):
    threads: int  # a block
    chunk_trees: int  # trees staged in a block's shared memory at once
    groups: int  # groups of threads on the same rows, each walking every groups-th tree


def walk_plan(n: int, f: int, n_trees: int, m_nodes: int, m_leaves: int, sms: int,
              n_nan_words: int = 0) -> WalkPlan:
    """The kernel's launch plan, a function of the shapes and the card's
    multiprocessors: a group of threads takes ROWS_PER_THREAD rows each, as
    many as give two blocks a multiprocessor a tile each (a multiple of 32
    threads, at most MAX_THREADS) and as the tile's staged words allow
    within BIN_SHARED; where the rows, not the words, make that fewer than
    MAX_THREADS, groups of at least 16 threads sized the same way (a
    multiple of 16), up to MAX_GROUPS of them (a power of two), share a
    tile's rows, each walking every groups-th tree of a chunk into a stash
    (at 4,096 rows 3.5x one group; on wide rows, where the words limit the
    tile, groups were slower), if at least two such groups fit a block;
    and a chunk holds as many trees as BLOCK_SHARED leaves room for beside
    the words and the stash (a tree too large for that takes a block of
    MAX_BLOCK_SHARED).  Every plan meets the C entry's checks: threads a
    multiple of 32 and of groups."""
    return _walk_plan(n, f, n_trees, m_nodes, m_leaves, sms, n_nan_words, MAX_GROUPS)


def _walk_plan(n, f, n_trees, m_nodes, m_leaves, sms, n_nan_words, max_groups) -> WalkPlan:
    """``walk_plan`` with at most ``max_groups`` groups (1: one group of
    threads a block at every size, the plan the bench compares with)."""
    rows_threads = -(-n // (2 * sms * ROWS_PER_THREAD))
    group_threads = min(MAX_THREADS, max(32, -(-rows_threads // 32) * 32))
    per_thread = ROWS_PER_THREAD * (-(-f // 4) + n_nan_words) * 4
    words_cap = max(32, BIN_SHARED // per_thread // 32 * 32)
    # the rows are few: groups (of half a warp at the fewest) on them fill
    # the block, where two of them fit it (a lone group of an odd number of
    # half warps would not be a multiple of 32 threads)
    half_warps = max(16, -(-rows_threads // 16) * 16)
    groups = 1
    if (group_threads < min(words_cap, MAX_THREADS) and max_groups > 1
            and 2 * half_warps <= MAX_THREADS):
        group_threads = half_warps
        while groups * 2 <= max_groups and group_threads * groups * 2 <= MAX_THREADS:
            groups *= 2
    group_threads = min(group_threads, words_cap)
    tile_rows = group_threads * ROWS_PER_THREAD
    bins_bytes = group_threads * per_thread
    tree_bytes = 8 * m_nodes + 4 * m_leaves + (4 * tile_rows if groups > 1 else 0)
    for budget in (BLOCK_SHARED, MAX_BLOCK_SHARED):
        chunk = min(n_trees, (budget - SINK_BYTES - bins_bytes) // tree_bytes)
        if chunk >= 1:
            return WalkPlan(group_threads * groups, chunk, groups)
    raise ValueError(f"a tree's tables ({tree_bytes} bytes) do not fit the walk kernel")


_SMS = {}


def sm_count(device) -> int:
    """Multiprocessors of a CUDA device (cached)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def forest_walk(bins: torch.Tensor, tables: ForestTables, k: int) -> torch.Tensor:
    """Raw scores [N, k] of bins [N, F] u8, tree t added into class t % k:
    plain version on the CPU, the ``csrc/forest_walk.cu`` kernel on a CUDA
    device at ``walk_plan``'s plan (past 8 classes a class block of the grid
    may hold no tree, so its columns start from zeros)."""
    if bins.device.type == "cpu":
        return forest_walk_plain(bins, tables, k)
    if bins.device.type != "cuda":
        raise ValueError(f"no kernel for device {bins.device}")
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise ValueError("forest walk takes [N, F] u8 bins")
    bins = bins.contiguous()
    n, f = bins.shape
    if -(-f // 4) != tables.n_words:
        raise ValueError(f"tables built for {tables.n_words} words of bins, not {f} features")
    n_nan = int(tables.nan_words.shape[0])
    # the bitsets ride behind the leaf values: 8 more words a categorical node
    leaf_words = tables.m_leaves + 8 * tables.m_cat
    plan = walk_plan(n, f, tables.n_trees, tables.m_nodes, leaf_words,
                     sm_count(bins.device), n_nan)
    alloc = torch.zeros if k > CLASS_BLOCK else torch.empty
    out = alloc((n, k), dtype=torch.float32, device=bins.device)
    fn = _build.entry("forest_walk")
    rc = fn(
        bins.data_ptr(), tables.tables.data_ptr(), tables.nan_words.data_ptr(), n, f, n_nan,
        tables.n_trees, tables.m_nodes, leaf_words, int(k), plan.threads,
        plan.chunk_trees, plan.groups, out.data_ptr(),
        torch.cuda.current_stream(bins.device).cuda_stream, int(tables.m_cat > 0),
    )
    _build.check(rc, "forest_walk kernel")
    _build.LAUNCHES["forest_walk"] += 1
    if tables.m_cat:
        _build.LAUNCHES["forest_walk_cat"] += 1
    if k > 1:
        _build.LAUNCHES["forest_walk_multi"] += 1
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
