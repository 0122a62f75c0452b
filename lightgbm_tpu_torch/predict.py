"""Stacked trees and the plain level-synchronous walkers.

Counterpart of ``lightgbm_tpu/predict.py``: ``stack_bin_trees`` pads the
per-tree records into ``[T, M]`` arrays and ``predict_bins_leaves`` /
``predict_bins_raw`` walk every row through every tree one level at a time
(``_walk``, predict.py:180-238).  This walker is the plain version the
forest-walk kernel (``ops/forest_walk.py``) is held against, and the
booster's walker for a model the kernel rejects (``walk_reject_reason``),
on the booster's device: the JAX package's XLA fallback, and the walker of
every EFB model (a bundle-plane node goes left by its [B] goes-left table,
``cat_mask``, as predict.py:63, :199-226 walk it; the JAX package declines
its walk kernel for such models, boosting/gbdt.py:2872-2875).

``stack_real_trees`` / ``predict_real_leaves`` are the real-space walker
of a model read from text, which has no bin mappers (predict.py:133-284
and ``Tree._decide``, tree.py:286-305): NumericalDecision on the raw
values, with the None, Zero and NaN missing types, and CategoricalDecision
(a NaN or negative value goes right, else the bit of ``int(value)`` in the
node's bitset goes left, a value past its words right).  It decides in f64
(the JAX package walks in f32 and re-walks the rows near a threshold in
f64, so its decisions are the f64 ones); the engine sums the f64 leaf
values.

``StreamingPredictor`` is the streaming engine (predict.py:344-985):
chunks of ``pred_chunk_rows`` padded to a ``bucket_rows`` ladder, host
preparation of chunk k+1 while chunk k walks, at most ``pred_num_buffers``
chunks in flight, and the phase stats; the Booster sends ``pred_leaf``,
prediction early stopping and every predict of a model read from text
through it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .binning import K_ZERO_THRESHOLD
from .config import check_pred_engine
from .tree import K_CATEGORICAL_MASK, MISSING_NAN, MISSING_ZERO, missing_type_of


def walk_levels(children) -> int:
    """Steps of a level-synchronous walk that bring every row to a leaf:
    the depth of the deepest leaf over the trees, ``children`` a sequence
    of (left_child, right_child) arrays (negative = ``~leaf``); a tree with
    no split (node 0 routes to leaf 0) takes one step.  Only the nodes
    reached from node 0 count (padding past a tree's nodes is never
    reached), and no tree is deeper than its node count."""
    levels = 1
    for lc, rc in children:
        lc, rc = np.asarray(lc, np.int64), np.asarray(rc, np.int64)
        depth, frontier = 0, np.zeros(1 if len(lc) else 0, np.int64)
        while frontier.size and depth <= len(lc):
            depth += 1
            kids = np.concatenate([lc[frontier], rc[frontier]])
            frontier = kids[kids >= 0]
        levels = max(levels, depth)
    return levels


class BinTreeBatch(NamedTuple):
    split_feature: torch.Tensor  # [T, M] i64 used-feature index
    split_bin: torch.Tensor  # [T, M] i64
    default_left: torch.Tensor  # [T, M] bool
    nan_bin: torch.Tensor  # [T, M] i64 NaN bin of the node's feature, -1 none
    left_child: torch.Tensor  # [T, M] i64 (neg = ~leaf)
    right_child: torch.Tensor  # [T, M] i64
    leaf_value: torch.Tensor  # [T, Lm] f32
    split_is_cat: torch.Tensor  # [T, M] bool: the node goes left by its table
    cat_mask: torch.Tensor  # [T, M, Bm] bool goes-left tables (Bm = 1: none)
    # steps that bring every row to a leaf (``walk_levels``), so that a walk
    # on the card queues its operations without reading anything back
    levels: int


def stack_bin_trees(records: Sequence[dict], nan_bins: np.ndarray, device) -> BinTreeBatch:
    """Pad bin-space records to [T, M]; a single-leaf tree routes every row
    to leaf 0 from node 0.  Records with ``split_is_cat`` / ``cat_mask``
    (EFB) give the tables, as wide as the widest."""
    t = len(records)
    m = max([len(r["split_feature"]) for r in records] + [1])
    lm = max(len(r["leaf_value"]) for r in records)
    arr = {k: np.zeros((t, m), np.int64) for k in ("sf", "sb", "dl", "lc", "rc")}
    arr["lc"][:] = -1
    arr["rc"][:] = -1
    leaf = np.zeros((t, lm), np.float32)
    for i, r in enumerate(records):
        nn = len(r["split_feature"])
        arr["sf"][i, :nn] = r["split_feature"]
        arr["sb"][i, :nn] = r["split_bin"]
        arr["dl"][i, :nn] = r["default_left"]
        arr["lc"][i, :nn] = r["left_child"]
        arr["rc"][i, :nn] = r["right_child"]
        leaf[i, : len(r["leaf_value"])] = r["leaf_value"]
    bm = max([np.asarray(r["cat_mask"]).shape[1] for r in records
              if r.get("cat_mask") is not None and np.size(r["cat_mask"])] + [1])
    is_cat = np.zeros((t, m), bool)
    cmask = np.zeros((t, m, bm), bool)
    for i, r in enumerate(records):
        if r.get("cat_mask") is not None and np.size(r["cat_mask"]):
            cm = np.asarray(r["cat_mask"], bool)
            is_cat[i, : len(r["split_is_cat"])] = r["split_is_cat"]
            cmask[i, : cm.shape[0], : cm.shape[1]] = cm
    nan_bins = np.asarray(nan_bins, np.int64)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return BinTreeBatch(
        split_feature=as_t(arr["sf"]),
        split_bin=as_t(arr["sb"]),
        default_left=as_t(arr["dl"] != 0),
        nan_bin=as_t(np.where(arr["sf"] >= 0, nan_bins[arr["sf"]], -1)),
        left_child=as_t(arr["lc"]),
        right_child=as_t(arr["rc"]),
        leaf_value=as_t(leaf),
        split_is_cat=as_t(is_cat),
        cat_mask=as_t(cmask),
        levels=walk_levels((r["left_child"], r["right_child"]) for r in records),
    )


def predict_bins_leaves(batch: BinTreeBatch, bins: torch.Tensor) -> torch.Tensor:
    """Leaf index [N, T] of every row in every tree; bins [N, F].  A table
    node sends a row left by its table's entry of the row's bin (a bin past
    the table goes right)."""
    n = bins.shape[0]
    t = batch.split_feature.shape[0]
    trees = torch.arange(t, device=bins.device)[None, :]
    nodes = torch.zeros((n, t), dtype=torch.int64, device=bins.device)
    for _ in range(batch.levels):
        cur = torch.clamp(nodes, min=0)
        feat = batch.split_feature[trees, cur]
        fval = torch.gather(bins, 1, feat).long()
        nb = batch.nan_bin[trees, cur]
        gl = (fval <= batch.split_bin[trees, cur]) | (
            batch.default_left[trees, cur] & (nb >= 0) & (fval == nb)
        )
        bm = batch.cat_mask.shape[-1]
        if bm > 1:
            gl_cat = batch.cat_mask[trees, cur, torch.clamp(fval, max=bm - 1)] & (fval < bm)
            gl = torch.where(batch.split_is_cat[trees, cur], gl_cat, gl)
        nxt = torch.where(gl, batch.left_child[trees, cur], batch.right_child[trees, cur])
        nodes = torch.where(nodes >= 0, nxt, nodes)
    return ~nodes


def predict_bins_raw(batch: BinTreeBatch, bins: torch.Tensor, k: int) -> torch.Tensor:
    """Raw scores [N, k]: leaf values of tree t summed into class t % k,
    trees in order, in f32."""
    leaves = predict_bins_leaves(batch, bins)
    t = leaves.shape[1]
    trees = torch.arange(t, device=bins.device)[None, :]
    vals = batch.leaf_value[trees, leaves]
    out = torch.zeros((bins.shape[0], k), dtype=torch.float32, device=bins.device)
    for i in range(t):
        out[:, i % k] += vals[:, i]
    return out


class RealTreeBatch(NamedTuple):
    split_feature: torch.Tensor  # [T, M] i64 original feature index
    threshold: torch.Tensor  # [T, M] f64
    missing_type: torch.Tensor  # [T, M] i64
    default_left: torch.Tensor  # [T, M] bool
    left_child: torch.Tensor  # [T, M] i64 (neg = ~leaf)
    right_child: torch.Tensor  # [T, M] i64
    leaf_value: torch.Tensor  # [T, Lm] f64
    is_cat: torch.Tensor  # [T, M] bool: a categorical decision
    cat_begin: torch.Tensor  # [T, M] i64: the node's first word in cat_words
    cat_nwords: torch.Tensor  # [T, M] i64: its words (0 for a numeric node)
    cat_words: torch.Tensor  # [W + 1] i64: every tree's bitset words, then a 0
    levels: int  # as BinTreeBatch.levels


def stack_real_trees(trees: Sequence, device) -> RealTreeBatch:
    """Pad real-space trees (``tree.Tree``) to [T, M]; a single-leaf tree
    routes every row to leaf 0 from node 0."""
    t = len(trees)
    m = max([tr.num_leaves - 1 for tr in trees] + [1])
    lm = max([tr.num_leaves for tr in trees] + [1])
    sf = np.zeros((t, m), np.int64)
    dt = np.zeros((t, m), np.int64)
    thr = np.zeros((t, m), np.float64)
    lc = np.full((t, m), -1, np.int64)
    rc = np.full((t, m), -1, np.int64)
    leaf = np.zeros((t, lm), np.float64)
    cat_begin = np.zeros((t, m), np.int64)
    cat_nwords = np.zeros((t, m), np.int64)
    words = []
    for i, tr in enumerate(trees):
        nn = tr.num_leaves - 1
        sf[i, :nn] = tr.split_feature_real
        dt[i, :nn] = tr.decision_type
        thr[i, :nn] = tr.threshold
        lc[i, :nn] = tr.left_child
        rc[i, :nn] = tr.right_child
        leaf[i, : tr.num_leaves] = tr.leaf_value
        if tr.num_cat:
            cat = np.flatnonzero(np.asarray(tr.decision_type[:nn], np.int64) & K_CATEGORICAL_MASK)
            idx = np.asarray(tr.threshold, np.float64)[cat].astype(np.int64)
            cat_begin[i, cat] = len(words) + tr.cat_boundaries[idx]
            cat_nwords[i, cat] = tr.cat_boundaries[idx + 1] - tr.cat_boundaries[idx]
            words.extend(int(w) for w in tr.cat_threshold)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return RealTreeBatch(
        split_feature=as_t(sf),
        threshold=as_t(thr),
        missing_type=as_t(missing_type_of(dt)),
        default_left=as_t((dt & 2) != 0),
        left_child=as_t(lc),
        right_child=as_t(rc),
        leaf_value=as_t(leaf),
        is_cat=as_t((dt & K_CATEGORICAL_MASK) != 0),
        cat_begin=as_t(cat_begin),
        cat_nwords=as_t(cat_nwords),
        cat_words=as_t(np.asarray(words + [0], np.int64)),
        levels=walk_levels((tr.left_child, tr.right_child) for tr in trees),
    )


def predict_real_leaves(batch: RealTreeBatch, x: torch.Tensor) -> torch.Tensor:
    """Leaf index [N, T] of every row in every tree; x [N, F] f64 raw
    values.  A NaN is 0 unless the node's missing type is NaN; a missing
    value (NaN for NaN, |v| <= 1e-35 for Zero) takes the default side,
    else ``v <= threshold`` goes left.  At a categorical node a NaN or
    negative value goes right, else v's integer part c goes left when bit c
    & 31 of the node's word c >> 5 is set (a word past the node's goes
    right)."""
    n = x.shape[0]
    t = batch.split_feature.shape[0]
    trees = torch.arange(t, device=x.device)[None, :]
    nodes = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    for _ in range(batch.levels):
        cur = torch.clamp(nodes, min=0)
        fval = torch.gather(x, 1, batch.split_feature[trees, cur])
        mt = batch.missing_type[trees, cur]
        isnan = torch.isnan(fval)
        fval = torch.where(isnan & (mt != MISSING_NAN), torch.zeros_like(fval), fval)
        missing = ((mt == MISSING_ZERO) & (fval.abs() <= K_ZERO_THRESHOLD)) | (
            (mt == MISSING_NAN) & isnan)
        gl = torch.where(missing, batch.default_left[trees, cur],
                         fval <= batch.threshold[trees, cur])
        if len(batch.cat_words) > 1:
            raw = torch.gather(x, 1, batch.split_feature[trees, cur])
            # values past 2^31 lie past every bitset: go right
            ok = ~torch.isnan(raw) & (raw >= 0) & (raw < 2.0**31)
            c = torch.where(ok, raw, torch.zeros_like(raw)).long()
            w = c >> 5
            ok &= w < batch.cat_nwords[trees, cur]
            word = batch.cat_words[torch.where(ok, batch.cat_begin[trees, cur] + w, -1)]
            gl_cat = ok & (((word >> (c & 31)) & 1) != 0)
            gl = torch.where(batch.is_cat[trees, cur], gl_cat, gl)
        nxt = torch.where(gl, batch.left_child[trees, cur], batch.right_child[trees, cur])
        nodes = torch.where(nodes >= 0, nxt, nodes)
    return ~nodes


# ---------------------------------------------------------------------------
# The streaming engine (predict.py:344-985).
# ---------------------------------------------------------------------------

LADDER_MIN = 256  # smallest bucket: tiny requests pad here, not per size
HOST_BIN_BLOCK = 65536  # rows binned on the host at once, at least (_HOST_BIN_BLOCK)


def bucket_rows(rows: int, chunk: int) -> int:
    """Smallest ladder bucket >= rows: powers of two from LADDER_MIN up,
    capped at the full chunk (which need not be a power of two); a full
    chunk always maps to ``chunk``."""
    if rows >= chunk:
        return chunk
    b = LADDER_MIN
    while b < rows:
        b <<= 1
    return min(b, chunk)


def ladder_buckets(chunk: int) -> List[int]:
    """Every bucket ``bucket_rows`` can give for this chunk size."""
    out = []
    b = LADDER_MIN
    while b < chunk:
        out.append(b)
        b <<= 1
    out.append(chunk)
    return out


def shard_count(shard_devices: int, device) -> int:
    """``pred_shard_devices`` resolved as ``StreamingPredictor._shard_count``
    (predict.py:777-786): 0 or 1 is one device, -1 every device, else the
    largest power of two within the request and the devices present.  More
    than one raises: the port has no multi-device predict yet."""
    avail = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    n = 1
    if shard_devices not in (0, 1):
        want = min(avail if shard_devices < 0 else shard_devices, avail)
        while n * 2 <= want:
            n *= 2
    if n > 1:
        raise NotImplementedError(
            f"pred_shard_devices={shard_devices} resolves to {n} devices: predict over "
            "several devices is not yet ported to lightgbm_tpu_torch (ROADMAP Queue 1, "
            "item 9)")
    return n


# a staging ring stays on the booster for later calls while one slot (its
# input and output on the host, and its input again on the card) takes at
# most this many bytes; a larger one lives for its call only, so a predict
# in large chunks keeps no page-locked memory once it returns
STAGING_KEEP_BYTES = 64 << 20


class _Slot:
    """One chunk's staging: its input rows on the host (page-locked when
    the device is a card) and on the device, its output on the host, and
    the events that order them.  On the CPU the host tensors are the
    device's."""

    def __init__(self, bucket: int, width: int, dtype: torch.dtype, out_cols: int,
                 out_dtype: torch.dtype, device: torch.device):
        self.cuda = device.type == "cuda"
        # pin_memory raises when the memory cannot be page-locked: predict
        # never falls back to a synchronous copy on its own
        self.h_in = torch.zeros((bucket, width), dtype=dtype, pin_memory=self.cuda)
        self.d_in = torch.zeros((bucket, width), dtype=dtype, device=device) if self.cuda else None
        self.h_out = torch.empty((bucket, out_cols), dtype=out_dtype, pin_memory=self.cuda)
        self.copied = torch.cuda.Event() if self.cuda else None
        self.done = torch.cuda.Event() if self.cuda else None


def _out_dtype(kind: str) -> torch.dtype:
    return torch.int32 if kind == "leaf" else torch.float64


def slot_bytes(bucket: int, width: int, dtype: torch.dtype, out_cols: int, kind: str) -> int:
    """Bytes of one slot: its input twice (host and card), its output."""
    return bucket * (2 * width * dtype.itemsize + out_cols * _out_dtype(kind).itemsize)


def staging(cache: Dict, bucket: int, width: int, dtype: torch.dtype, kind: str,
            out_cols: int, slots: int, device: torch.device) -> List[_Slot]:
    """The staging ring of (bucket, width, dtype, kind, out_cols), at least
    ``slots`` long: taken from ``cache``, and put there (made at its first
    use) while a slot takes at most STAGING_KEEP_BYTES, so that a stream of
    any length allocates at most one ring a ladder bucket."""
    key = (bucket, width, dtype, kind, out_cols)
    ring = cache.get(key, [])
    while len(ring) < slots:
        ring.append(_Slot(bucket, width, dtype, out_cols, _out_dtype(kind), device))
    if slot_bytes(bucket, width, dtype, out_cols, kind) <= STAGING_KEEP_BYTES:
        cache[key] = ring
    return ring


class StreamingPredictor:
    """Chunked, bucket-padded, overlapped prediction of a Booster's trees.

    The input is cut into chunks of ``chunk`` rows, each padded to its
    ``bucket_rows`` bucket in a staging buffer of that size.  Chunk k+1 is
    prepared on the host (binned, in bin space) into its page-locked buffer
    and copied to the card on a side stream while chunk k walks on the
    current stream, ordered by CUDA events; at most ``num_buffers`` chunks'
    outputs are in flight before the oldest is copied back.

    The walker is the plain level-synchronous one of this module over the
    stacked trees (``BinTreeBatch``), run for the forest's known depth so
    that a chunk's walk queues without reading anything back.  The JAX
    package packs the node fields into two i32 tables
    (``PackedBinForest``) to save XLA gathers, a cost of its compiler;
    here each gather is one operator whatever the packing, and the stacked
    trees also walk EFB planes and categorical tables, which the packed
    tables do not.  The leaves are the same either way."""

    def __init__(self, booster):
        self._b = booster
        self.last_stats: Dict = {}

    def stacked(self, space: str, t0: int, t1: int):
        """(stacked trees of [t0, t1), whether this call built them),
        cached on the booster until its trees change."""
        b = self._b
        key = ("stream", space, t0, t1)
        if key in b._tables:
            return b._tables[key], 0
        if space == "real":
            batch = stack_real_trees(b.trees[t0:t1], b.device)
        else:
            batch = stack_bin_trees([t.record() for t in b.trees[t0:t1]], b.nan_bins, b.device)
        b._tables[key] = batch
        return batch, 1

    def warmup(self, t0: int, t1: int, *, space: str, chunk: int, width: Optional[int] = None,
               kinds=("value",), num_buffers: int = 2) -> int:
        """Build this range's tables and every ladder bucket's staging for
        ``kinds``, so the first predict builds nothing; returns the tables
        built (0 when warm)."""
        b = self._b
        _, built = self.stacked(space, t0, t1)
        if width is None:
            width = b.max_feature_idx + 1 if space == "real" else b._bin_matrix_width()
        dtype = torch.float64 if space == "real" else torch.int32
        for bucket in ladder_buckets(max(LADDER_MIN, int(chunk))):
            for kind in kinds:
                staging(b._staging, bucket, width, dtype, kind, t1 - t0,
                        max(1, int(num_buffers)), b.device)
        return built

    def run(self, X, t0: int, t1: int, *, space: str, kind: str = "value", chunk: int,
            num_buffers: int = 2, shard_devices: int = 1,
            reduce_fn: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
            engine: str = "walk") -> np.ndarray:
        """Stream X [N, F] through trees [t0, t1).  ``kind="value"`` gives
        per-tree leaf outputs [N, T] f64, ``kind="leaf"`` i32 leaf indices;
        ``reduce_fn(block, rows)`` maps each chunk's block on the host
        before concatenation (for example the sum over trees), while the
        next chunk walks.  ``space="bin"`` bins the rows exactly on the host
        (``Booster._bin_matrix``, in blocks of at least HOST_BIN_BLOCK
        rows); ``space="real"`` walks the raw values in f64."""
        b = self._b
        check_pred_engine(engine)
        ndev = shard_count(shard_devices, b.device)
        n = int(X.shape[0])
        n_trees = t1 - t0
        chunk = max(LADDER_MIN, int(chunk))
        num_buffers = max(1, min(int(num_buffers), -(-n // chunk)))
        stats = {"path": "stream_" + space, "engine": engine, "rows": n, "chunks": 0,
                 "buckets": [], "shard_devices": ndev, "bin_ms": 0.0, "transfer_ms": 0.0,
                 "walk_ms": 0.0, "host_ms": 0.0, "compiles": 0}
        batch, stats["compiles"] = self.stacked(space, t0, t1)
        if n == 0:
            empty = np.zeros((0, n_trees), np.int32 if kind == "leaf" else np.float64)
            self.last_stats = stats
            return reduce_fn(empty, 0) if reduce_fn is not None else empty
        if space == "real":
            width, dtype, walk = int(X.shape[1]), torch.float64, predict_real_leaves

            def host_rows(lo: int, rows: int):
                return X[lo: lo + rows]
        else:
            width, dtype, walk = b._bin_matrix_width(), torch.int32, predict_bins_leaves
            block_rows = max(chunk, HOST_BIN_BLOCK)
            block = {"lo": -1, "mat": None}

            def host_rows(lo: int, rows: int):
                blo = lo // block_rows * block_rows
                if block["lo"] != blo:
                    block["lo"], block["mat"] = blo, b._bin_matrix(X[blo: blo + block_rows])
                return block["mat"][lo - blo: lo - blo + rows]

        dev = b.device
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        trees = torch.arange(n_trees, device=dev)[None, :]
        blocks: List[np.ndarray] = []
        inflight: deque = deque()
        rings: Dict[int, List[_Slot]] = {}  # this call's, by bucket

        def drain_one():
            slot, rows, h_out = inflight.popleft()
            t_w = time.perf_counter()
            if cuda:
                slot.done.synchronize()
            stats["walk_ms"] += (time.perf_counter() - t_w) * 1e3
            t_h = time.perf_counter()
            blk = h_out[:rows].numpy()
            blk = blk.astype(np.float64) if kind == "value" else blk.copy()
            if reduce_fn is not None:
                blk = reduce_fn(blk, rows)
            blocks.append(blk)
            stats["host_ms"] += (time.perf_counter() - t_h) * 1e3

        for ci, lo in enumerate(range(0, n, chunk)):
            rows = min(chunk, n - lo)
            bucket = bucket_rows(rows, chunk)
            if bucket not in rings:
                rings[bucket] = staging(b._staging, bucket, width, dtype, kind, n_trees,
                                        num_buffers, dev)
            slot = rings[bucket][ci % num_buffers]
            t_b = time.perf_counter()
            h_in = slot.h_in.numpy()
            h_in[:rows] = host_rows(lo, rows)
            h_in[rows:] = 0
            stats["bin_ms"] += (time.perf_counter() - t_b) * 1e3
            t_t = time.perf_counter()
            if cuda:
                cur = torch.cuda.current_stream(dev)
                with torch.cuda.stream(side):
                    slot.d_in.copy_(slot.h_in, non_blocking=True)
                    slot.copied.record(side)
                cur.wait_event(slot.copied)
                x_dev = slot.d_in
            else:
                x_dev = slot.h_in
            leaves = walk(batch, x_dev)
            out = leaves.to(torch.int32) if kind == "leaf" else batch.leaf_value[trees, leaves]
            h_out = slot.h_out
            h_out.copy_(out, non_blocking=cuda)
            if cuda:
                slot.done.record(cur)
            stats["transfer_ms"] += (time.perf_counter() - t_t) * 1e3
            inflight.append((slot, rows, h_out))
            stats["chunks"] += 1
            if bucket not in stats["buckets"]:
                stats["buckets"].append(bucket)
            while len(inflight) >= num_buffers:
                drain_one()
        while inflight:
            drain_one()
        t_h = time.perf_counter()
        out = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, axis=0)
        stats["host_ms"] += (time.perf_counter() - t_h) * 1e3
        self.last_stats = stats
        return out
