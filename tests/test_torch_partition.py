"""The destination arithmetic of the partition kernel (csrc/partition.cu)
and its host side (ops/seg.py: tile size, scratch size), on the CPU.

The kernel runs only on the card.  ``model_partition`` below repeats, in
plain PyTorch, what its two passes compute for each tile of each window:
its stable ranks from the split feature's bytes as they stand when it
reads them, its rows staged as they stand when it stages them, its left
offset from the counts of the tiles before it (the look-back), its left
run written IN PLACE and its right run to the window's part of the
scratch at the right-rank offset, then the copy of the right runs to
[start + nl, start + cnt).  The three events of every tile run in a
random order that the kernel's waits allow (a write waits for the tile's
own staging, the counts of the tiles before it, and the staging of the
tiles whose rows its left run overwrites), so a wait too short would let
a tile read rows another tile had already overwritten and show as a wrong
result.

Held against ``sort_partition_batch_plain`` and the JAX package's
``sort_partition_batch`` (ops/segpart.py:228): nl and every column
exactly, on random windows and the bench's edge cases, at the kernel's
own tile size and at the smallest (many tiles a window).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas.seg import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.pallas.seg import padded_rows, unpack_stats
from lightgbm_tpu.ops.segpart import sort_partition_batch as jax_sort_partition_batch

from lightgbm_tpu_torch import _build, bench_partition
from lightgbm_tpu_torch.ops import seg

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

COLS = ("g", "h", "m", "ridx")


def _rows(n, f, seed):
    """Seg rows from a numpy seed: bins as the bench makes them (bin 0
    empty, the last bin of each feature its NaN bin), and their bin
    counts."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(12, 40, size=f)
    bins = 1 + (rng.random((f, n)) * (nb[:, None] - 2)).astype(np.int64)
    bins = np.where(rng.random((f, n)) < 0.05, nb[:, None] - 1, bins).astype(np.uint8)
    rows = seg.pack_rows(
        torch.as_tensor(bins), torch.as_tensor(rng.normal(size=n).astype(np.float32)),
        torch.as_tensor((rng.random(n) + 0.1).astype(np.float32)),
        torch.as_tensor((rng.random(n) < 0.9).astype(np.float32)),
    )
    return rows, nb


def _clone(rows):
    return seg.SegRows(rows.bins.clone(), rows.g.clone(), rows.h.clone(), rows.m.clone(),
                       rows.ridx.clone(), wide=rows.wide, used_bins=rows.used_bins)


def _key(bins, feat, wide):
    """Feature ``feat``'s bins of a [P, cnt] block of planes: its plane, or
    in the u16 mode lo | hi << 8 (the kernel's load_keys)."""
    if not wide:
        return bins[feat]
    return bins[2 * feat].to(torch.int64) | bins[2 * feat + 1].to(torch.int64) << 8


def _offsets(mem, tile):
    """The C entry's plan (csrc/partition.cu lgbt_partition): each window's
    first tile, counting tiles of `tile` rows over the windows in member
    order, and its right run's offset in the scratch, 16 plus the earlier
    windows' cnt each rounded up to 16 rows."""
    cnt = np.maximum(mem[:, 1], 0)
    tile0 = np.concatenate([[0], np.cumsum(-(-cnt // tile))[:-1]])
    s0 = 16 + np.concatenate([[0], np.cumsum(-(-cnt // 16) * 16)[:-1]])
    return tile0, s0


def model_partition(rows, mem, tile, rng):
    """The kernel's two passes on the CPU (see the module docstring);
    returns nl [K] i32.  Asserts the design's invariants on the way: left
    runs land on rows of the tile or of earlier tiles, right runs inside
    the window's part of the scratch, scratch parts disjoint and clear of
    the scratch's ends."""
    tile0, s0 = _offsets(mem, tile)
    k, f, n = mem.shape[0], rows.planes, rows.n
    stride = seg.partition_scratch_rows(n)
    s_bins = torch.zeros((f, stride), dtype=torch.uint8)
    s_cols = {c: torch.zeros(stride, dtype=getattr(rows, c).dtype) for c in COLS}
    tiles = [(w, t) for w in range(k) for t in range(-(-int(mem[w, 1]) // tile))]
    assert [tile0[w] for w in range(k)] == [
        sum(1 for v, _ in tiles if v < w) for w in range(k)]
    parts = sorted((int(s0[w]), int(s0[w] + mem[w, 1])) for w in range(k))
    assert parts[0][0] >= 16 and parts[-1][1] + 16 <= stride
    assert all(a[1] <= b[0] and b[0] % 16 == 0 for a, b in zip(parts, parts[1:]))

    counted, staged, done, nl = {}, {}, set(), np.zeros(k, np.int64)

    def bounds(w, t):
        start, cnt = int(mem[w, 0]), int(mem[w, 1])
        return start + t * tile, min(start + cnt, start + (t + 1) * tile)

    def count(w, t):  # the split feature's bytes, read directly, by the rule
        lo, hi = bounds(w, t)  # of the window (its threshold or its table)
        gl = seg.member_go_left(_key(rows.bins[:, lo:hi].clone(), int(mem[w, 2]), rows.wide),
                                mem[w])
        counted[(w, t)] = (gl, torch.cat([torch.nonzero(gl)[:, 0], torch.nonzero(~gl)[:, 0]]))

    def stage(w, t):  # every byte the tile moves
        lo, hi = bounds(w, t)
        staged[(w, t)] = {"bins": rows.bins[:, lo:hi].clone(),
                          **{c: getattr(rows, c)[lo:hi].clone() for c in COLS}}

    def l0_of(w, t):  # the look-back
        return sum(int(counted[(w, u)][0].sum()) for u in range(t))

    def can_write(w, t):
        if (w, t) not in staged or any((w, u) not in counted for u in range(t + 1)):
            return False
        return all((w, u) in staged for u in range(l0_of(w, t) // tile, t))

    def write(w, t):
        start, cnt = int(mem[w, 0]), int(mem[w, 1])
        gl, src_of = counted[(w, t)]
        snap = staged[(w, t)]
        feat = int(mem[w, 2])
        # the bytes ranked and the bytes staged are the same bytes
        assert torch.equal(gl, seg.member_go_left(_key(snap["bins"], feat, rows.wide), mem[w]))
        tl, tt = int(gl.sum()), len(gl)
        l0 = l0_of(w, t)
        r0 = t * tile - l0
        lsrc, rsrc = src_of[:tl], src_of[tl:]
        assert start + l0 + tl <= start + t * tile + tt  # in place: own or earlier rows
        ldst = slice(start + l0, start + l0 + tl)
        rdst = slice(int(s0[w]) + r0, int(s0[w]) + r0 + tt - tl)
        assert rdst.stop <= s0[w] + cnt
        rows.bins[:, ldst] = snap["bins"][:, lsrc]
        s_bins[:, rdst] = snap["bins"][:, rsrc]
        for c in COLS:
            getattr(rows, c)[ldst] = snap[c][lsrc]
            s_cols[c][rdst] = snap[c][rsrc]
        if t + 1 == -(-cnt // tile):
            nl[w] = l0 + tl
        done.add((w, t))

    while len(done) < len(tiles):  # any order the waits allow
        events = ([(count, wt) for wt in tiles if wt not in counted]
                  + [(stage, wt) for wt in tiles if wt not in staged]
                  + [(write, wt) for wt in tiles if wt not in done and can_write(*wt)])
        fn, wt = events[rng.integers(len(events))]
        fn(*wt)

    for w in range(k):  # the copy pass
        start, cnt, sw = int(mem[w, 0]), int(mem[w, 1]), int(s0[w])
        r = cnt - int(nl[w])
        dst = slice(start + int(nl[w]), start + cnt)
        rows.bins[:, dst] = s_bins[:, sw:sw + r]
        for c in COLS:
            getattr(rows, c)[dst] = s_cols[c][sw:sw + r]
    return torch.as_tensor(nl, dtype=torch.int32)


def _members(n, nb, rng, k):
    """k disjoint windows at unaligned starts, some tiny, one maybe empty."""
    cuts = np.sort(rng.choice(np.arange(1, n), size=2 * k, replace=False))
    starts, cnts = cuts[0::2], cuts[1::2] - cuts[0::2]
    if k > 2:
        cnts[rng.integers(k)] = 0
    feats = rng.integers(0, len(nb), size=k)
    tbins = [int(rng.integers(0, nb[j])) for j in feats]
    return seg.split_members(starts, cnts, feats, tbins, rng.integers(0, 2, size=k),
                             [int(nb[j]) - 1 for j in feats])


def _assert_same(a, b):
    for c in ("bins",) + COLS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c


@pytest.mark.parametrize("k,seed", [(1, 0), (2, 1), (4, 2), (16, 3)])
@pytest.mark.parametrize("tile", ["kernel", 128])
def test_model_equals_plain_on_random_windows(k, seed, tile):
    rng = np.random.default_rng(seed)
    rows, nb = _rows(6_000, 5, seed)
    mem = _members(rows.n, nb, rng, k)
    t = seg.partition_tile_rows(rows.f, int(mem[:, 1].sum())) if tile == "kernel" else tile
    want = _clone(rows)
    nl_p = seg.sort_partition_batch_plain(want, mem)
    nl = model_partition(rows, mem, t, rng)
    assert torch.equal(nl, nl_p)
    _assert_same(rows, want)


@pytest.mark.parametrize("case", ["all left", "all right", "cnt 0 among K", "cnt < 32",
                                  "NaN bin left"])
@pytest.mark.parametrize("tile", [2048, 128])
def test_model_equals_plain_on_the_bench_edge_cases(case, tile):
    rows, nb = _rows(24_000, 10, 7)
    mem = bench_partition.edge_cases(rows.n, nb)[case]
    want = _clone(rows)
    nl_p = seg.sort_partition_batch_plain(want, mem)
    nl = model_partition(rows, mem, tile, np.random.default_rng(11))
    assert torch.equal(nl, nl_p)
    _assert_same(rows, want)
    if case == "all left":
        assert int(nl[0]) == int(mem[0, 1])
    if case == "all right":
        assert int(nl[0]) == 0


@pytest.mark.parametrize("case", ["random K=4", "tbin 255", "tbin 256", "NaN bin past 255 left",
                                  "all left", "cnt 0 among K", "cnt < 32", "table members",
                                  "root, 1024-bin tables", "K=4, 1024-bin tables"])
@pytest.mark.parametrize("tile", ["kernel", 128])
def test_model_equals_plain_on_u16_windows(case, tile):
    """The u16 mode (two byte planes a feature, 300-1,024 bins, NaN bins
    past 255): the kernel's key lo | hi << 8, its tiles moving the planes as
    bytes, on random windows and the bench's u16 edge cases (thresholds on
    either side of the byte, table members whose bins past 255 go right),
    and its wide tables (the bench's 1,024-bin tables: wide member rows)."""
    rows, nb = bench_partition.synthetic_rows_u16(24_000, 5, torch.device("cpu"), seed=3)
    assert rows.wide and rows.planes == 10
    rng = np.random.default_rng(4)
    if case == "random K=4":
        mem = _members(rows.n, nb, rng, 4)
    elif "1024-bin" in case:
        mem = bench_partition.wide_table_cases(rows.n, nb, 1024)[case]
        assert mem.shape == (len(mem), 7 + 32)
    else:
        mem = bench_partition.u16_edge_cases(rows.n, nb)[case]
    t = seg.partition_tile_rows(rows.planes, int(mem[:, 1].sum())) if tile == "kernel" else tile
    want = _clone(rows)
    nl_p = seg.sort_partition_batch_plain(want, mem)
    nl = model_partition(rows, mem, t, rng)
    assert torch.equal(nl, nl_p)
    _assert_same(rows, want)
    if case == "all left":
        assert int(nl[0]) == int(mem[0, 1])


def test_model_equals_jax_sort_partition_batch():
    """K=3 windows, one empty, one sending its NaN bin left, at the
    smallest tile (several tiles a window): the model against the JAX
    package's batched partition."""
    n, f = 3_000, 6
    rows, nb = _rows(n, f, 5)
    members = [(13, 700, 2, 11, 0, int(nb[2]) - 1), (713, 0, 5, 3, 0, -1),
               (1501, 1333, 4, 20, 1, int(nb[4]) - 1)]
    cols = np.asarray(members).T
    mem = seg.split_members(*cols)
    bins = rows.bins.numpy().T.astype(np.int32)
    n_pad = padded_rows(n)
    seg_j = jax_pack_rows(jnp.asarray(bins), jnp.asarray(rows.g.numpy()),
                          jnp.asarray(rows.h.numpy()), jnp.asarray(rows.m.numpy()), n_pad)
    seg_j, nl_j, _ = jax_sort_partition_batch(
        seg_j, *[jnp.asarray(c, jnp.int32) for c in cols], jnp.zeros(3, jnp.int32),
        jnp.zeros((3, 1), jnp.float32), f=f, n_pad=n_pad,
    )
    nl = model_partition(rows, mem, 128, np.random.default_rng(0))
    np.testing.assert_array_equal(nl.numpy(), np.asarray(nl_j))
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg_j, f, n))
    np.testing.assert_array_equal(rows.bins.numpy().T, b_j)
    for got, want in ((rows.g, g_j), (rows.h, h_j), (rows.m, m_j), (rows.ridx, r_j)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [16 * 4_097, 1 << 20, 1_000_003])
def test_scratch_holds_every_right_run(n):
    """16 windows of odd sizes that fill the rows (the most rounding the
    C entry's offsets add): every right run, and the 16 rows the copy pass
    may read past it, fit the scratch's row stride."""
    cnt = np.full(16, n // 16)
    cnt[:n % 16] += 1
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    mem = seg.split_members(starts, cnt, [0] * 16, [1] * 16, [0] * 16, [-1] * 16)
    _, s0 = _offsets(mem, 256)
    stride = seg.partition_scratch_rows(n)
    assert s0[0] == 16 and np.all(s0 % 16 == 0)
    assert s0[-1] + cnt[-1] + 16 <= stride and stride % 16 == 0


@pytest.mark.parametrize("k", [0, 17])
def test_launch_refuses_k_outside_1_to_16(k):
    rows, _ = _rows(500, 3, 0)
    mem = seg.split_members(list(range(0, 10 * k, 10)), [5] * k, [0] * k, [1] * k, [0] * k,
                            [-1] * k)
    with pytest.raises(ValueError, match="1 to 16 windows"):
        seg._partition_launch(rows, mem, "partition_batch")


@pytest.mark.parametrize("f,tile", [(1, 2048), (28, 1024), (100, 512), (242, 256), (300, 128)])
def test_tile_rows_fit_three_blocks_a_multiprocessor(f, tile):
    assert seg.partition_tile_rows(f) == tile
    assert seg.partition_stage_bytes(f, tile) <= seg.PART_BLOCK_SMEM
    if tile != seg.PART_TILES[0]:  # the next larger tile would not fit
        assert seg.partition_stage_bytes(f, 2 * tile) > seg.PART_BLOCK_SMEM


@pytest.mark.parametrize("rows,tile", [(1 << 20, 1024), (270_336, 1024), (270_335, 512),
                                       (65_536, 256), (4_096, 256), (17, 256)])
def test_tile_rows_shrink_for_small_calls(rows, tile):
    """At F = 28: the largest tile that still gives 264 tiles, down to 256
    rows."""
    assert seg.partition_tile_rows(28, rows) == tile
    assert seg.partition_tile_rows(300, rows) == 128  # never above the stage's limit


def test_tile_rows_refuse_a_table_too_wide():
    with pytest.raises(ValueError, match="features"):
        seg.partition_tile_rows(2_000)


def test_scratch_keeps_its_buffers_and_epochs():
    rows, _ = _rows(5_000, 28, 0)
    ps = seg.PartitionScratch(rows)
    assert ps.planes.shape == (28, ps.stride) and ps.cols.shape == (4, ps.stride)
    # room for every tile at the smallest tile size
    assert ps.status.shape[0] == ps.staged.shape[0] >= -(-5_000 // 128) + seg.MAX_WINDOWS
    assert not bool(ps.status.any()) and int(ps.counter) == 0
    assert [ps.next_epoch() for _ in range(3)] == [1, 2, 3]
    ps.epoch = (1 << 30) - 1
    ps.status.fill_(7)
    ps.staged.fill_(7)
    assert ps.next_epoch() == 1 and not bool(ps.status.any()) and not bool(ps.staged.any())


def test_kernel_source_agrees_with_the_host_side():
    """The constants, the C entry and the offsets of partition.cu that the
    wrapper and the model above rely on (the kernel is built only on the
    card)."""
    with open(os.path.join(_build.CSRC, "partition.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"kMaxWindows = (\d+)", src).group(1)) == seg.MAX_WINDOWS
    assert int(re.search(r"kCopyRows = (\d+)", src).group(1)) == seg.PART_COPY_ROWS
    assert int(re.search(r"kTableWords = (\d+)", src).group(1)) == seg.TABLE_WORDS
    assert re.search(r"kMemberCols = 7 \+ kTableWords;", src) and seg.MEMBER_COLS == 7 + 8
    # the member row's table columns and the rule the tiles rank by
    assert "P.iscat[i] = r[6] != 0;" in src
    assert "for (int j = 0; j < kTableWords; ++j) P.table[i][j] = (unsigned)r[7 + j];" in src
    # a bin past the table's 256 goes right, as member_go_left sends it
    assert ("by_table ? (v < 32 * kTableWords && ((s_table[v >> 5] >> (v & 31)) & 1u))\n"
            "                                  : go_left(v, tbin, dl, nanb)") in src
    # wide member rows: every table's words from the card, a bin past the
    # table's 32 W bins right (member_table reads the row's words the same)
    assert "const bool wide_table = by_table && a.wwords > 0;" in src
    assert "[&](int v) { return v < wbits && ((s_wide[v >> 5] >> (v & 31)) & 1u); }" in src
    assert "load_wide_table(a.wtable + (long long)w * a.wwords, a.wwords, s_wide);" in src
    # the u16 mode's key: the feature's two planes, lo | hi << 8 (_key above)
    assert "a.bins + (long long)P.feat[w] * (a.wide ? 2 : 1) * n + row0;" in src
    assert "load_keys<T>(tt, col, a.wide ? col + n : nullptr, key);" in src
    with open(os.path.join(_build.CSRC, "partition_tile.cuh")) as fh:
        assert "hi != nullptr ? (int)col[r] | (int)hi[r] << 8 : (int)col[r];" in fh.read()
    # the offsets of _offsets above
    assert "P.tile0[i + 1] = P.tile0[i] + (P.cnt[i] + tile - 1) / tile;" in src
    assert "long long most = 0, s0 = 16;" in src and "s0 += (P.cnt[i] + 15) / 16 * 16;" in src
    cases = [int(t) for t in re.findall(r"case (\d+): rc = launch_tiles<\1>", src)]
    assert tuple(cases) == seg.PART_TILES
    decl = re.search(r'extern "C" int lgbt_partition\(([^)]*)\)', src).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["partition"])
    with open(os.path.join(_build.CSRC, "partition_tile.cuh")) as fh:
        assert int(re.search(r"kThreads = (\d+)", fh.read()).group(1)) == 256
