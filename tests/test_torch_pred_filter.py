"""The port's ``pred_filter_batch`` against the JAX package's.

The same numpy inputs, made from a seed, go through the reference's Pallas
kernel (interpret mode), its zone-free oracle ``pred_filter_batch_ref`` and
the port's wrapper on CPU tensors (its plain PyTorch version).  Masks must be
exactly equal.  The cases that run the CUDA kernels against the plain
version are skipped without a card; the reference package is imported inside
the parity helpers, so those cases also run where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_pred_filter.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import scan as port_scan
from repro_torch.kernels.pred_filter import (
    LAUNCHES,
    OPS,
    block_bounds,
    pack_program,
    pred_filter_batch,
    search_iters,
)

BR = 256  # small zone blocks keep Pallas interpret mode quick


def _ref():
    """The reference package's kernel module and scan helpers."""
    import jax.numpy as jnp

    from repro.core import scan
    from repro.kernels import pred_filter

    return jnp, pred_filter, scan


def _pad(cols: np.ndarray, br: int = BR) -> np.ndarray:
    pad = (-cols.shape[1]) % br
    return np.pad(cols, ((0, 0), (0, pad))) if pad else cols


def _sets(key_sets, K, M):
    """Flat slab + [K, M] offsets/lengths, laid out as the scan backend does
    (the all-empty case is the one-key dummy slab)."""
    off = np.zeros((K, M), np.int32)
    ln = np.zeros((K, M), np.int32)
    segs, pos, mx = [], 0, 1
    for k in range(K):
        for m in range(M):
            ks = np.asarray(key_sets[k][m], np.int32)
            segs.append(ks)
            off[k, m], ln[k, m] = pos, ks.size
            pos += ks.size
            mx = max(mx, ks.size)
    slab = np.concatenate(segs).astype(np.int32) if pos else np.zeros(1, np.int32)
    return slab, off, ln, mx


def _run_all(cols, thr, atoms, set_cols=(), key_sets=None, br=BR,
             interpret=True):
    """(reference kernel, reference oracle, port plain) masks as numpy."""
    jnp, rk, _ = _ref()
    cols = _pad(cols, br)
    rows = tuple(c for c, _ in atoms) + tuple(set_cols)
    lo, hi = rk.block_bounds(cols, br, rows)
    kw_ref, kw_port = {}, {}
    if set_cols:
        K, M = thr.shape[0], len(set_cols)
        slab, off, ln, mx = _sets(key_sets, K, M)
        assert search_iters(mx) == rk.search_iters(mx)
        kw_ref = dict(set_cols=tuple(set_cols), set_slab=jnp.asarray(slab),
                      set_off=jnp.asarray(off), set_len=jnp.asarray(ln),
                      iters=rk.search_iters(mx))
        kw_port = dict(set_cols=tuple(set_cols),
                       set_slab=torch.from_numpy(slab),
                       set_off=torch.from_numpy(off),
                       set_len=torch.from_numpy(ln), iters=search_iters(mx))
    want_ref = np.asarray(rk.pred_filter_batch_ref(
        jnp.asarray(cols), jnp.asarray(thr), atoms,
        **{k: v for k, v in kw_ref.items()})).astype(bool)
    want_kernel = None
    if interpret:
        want_kernel = np.asarray(rk.pred_filter_batch(
            jnp.asarray(cols), jnp.asarray(thr), atoms, jnp.asarray(lo),
            jnp.asarray(hi), block_rows=br, interpret=True, **kw_ref)).astype(bool)
    got = pred_filter_batch(torch.from_numpy(cols), torch.from_numpy(thr), atoms,
                            torch.from_numpy(lo), torch.from_numpy(hi),
                            block_rows=br, **kw_port)
    assert got.dtype == torch.bool and tuple(got.shape) == want_ref.shape
    return want_kernel, want_ref, got.numpy()


def _assert_same(cols, thr, atoms, **kw):
    want_kernel, want_ref, got = _run_all(cols, thr, atoms, **kw)
    assert np.array_equal(got, want_ref)
    if want_kernel is not None:
        assert np.array_equal(got, want_kernel)
    return got


@pytest.mark.parametrize("op", sorted(OPS, key=OPS.get))
def test_each_op_matches_reference(op):
    rng = np.random.default_rng(100 + OPS[op])
    cols = rng.integers(-20, 20, (2, 1024)).astype(np.int32)
    thr = rng.integers(-20, 20, (3, 2)).astype(np.int32)
    thr[0, 0] = cols[0, 5]  # an exact hit for == / != / <= / >=
    atoms = ((0, OPS[op]), (1, OPS[op]))
    _assert_same(cols, thr, atoms)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_batched_bindings_all_ops(k):
    rng = np.random.default_rng(200 + k)
    cols = rng.integers(-100, 100, (3, 2048)).astype(np.int32)
    thr = rng.integers(-100, 100, (k, 6)).astype(np.int32)
    atoms = tuple((j % 3, j) for j in range(6))
    _assert_same(cols, thr, atoms)


@pytest.mark.parametrize("n", [1, 255, 1000, 4096])
def test_ragged_and_padded_rows(n):
    rng = np.random.default_rng(300 + n)
    cols = rng.integers(-5, 5, (2, n)).astype(np.int32)
    thr = np.array([[0, 3], [-1, 5]], np.int32)
    atoms = ((0, OPS[">="]), (1, OPS["<"]))
    got = _assert_same(cols, thr, atoms, interpret=n <= 1024)
    assert got.shape == (2, n + (-n) % BR)


@pytest.mark.parametrize("kind", ["all", "none", "partial"])
def test_sorted_data_prunes_blocks(kind):
    blocks = 8
    base = np.repeat(np.arange(blocks) * 1000, BR).astype(np.int32)
    col = (base + np.tile(np.arange(BR) % 100, blocks)).astype(np.int32)
    thr = {"all": [[10 ** 6]], "none": [[0]], "partial": [[4000]]}[kind]
    got = _assert_same(col[None, :], np.array(thr, np.int32),
                       ((0, OPS[">="]),))
    if kind == "all":
        assert not got.any()
    # the host mirror of the zone check agrees block for block
    lo, hi = block_bounds(col[None, :], BR, (0,))
    thr_np = np.array(thr, np.int32)
    ref_scan = _ref()[2]
    assert port_scan._skipped_blocks(((0, OPS[">="]),), lo, hi, thr_np) == \
        ref_scan._skipped_blocks(((0, OPS[">="]),), lo, hi, thr_np)


_F32_VALUES = [0.0, -0.0, 3.0, np.nan, np.inf, -np.inf, 3.0000000001, 1e40,
               np.float64(3.0000000001), np.float32(0.25), -7.5]


@pytest.mark.parametrize("v", _F32_VALUES, ids=[repr(v) for v in _F32_VALUES])
def test_float32_key_lane(v):
    rng = np.random.default_rng(400)
    f = rng.normal(0, 10, 1024).astype(np.float32)
    f[::13] = np.nan
    f[1::97], f[2::97] = np.inf, -np.inf
    f[3::31], f[4::31] = -0.0, 0.0
    f[5::17] = np.float32(3.0)
    ref_scan = _ref()[2]
    keys = port_scan._f32_key(f)
    assert np.array_equal(keys, ref_scan._f32_key(f))
    for op in range(6):
        exp = port_scan._f32_atoms(op, v)
        assert exp == ref_scan._f32_atoms(op, v)
        atoms = tuple((0, o) for o, _ in exp)
        thr = np.array([[t for _, t in exp]], np.int32)
        got = _assert_same(keys[None, :], thr, atoms, interpret=op in (0, 5))
        with np.errstate(invalid="ignore"):
            want = [np.equal, np.not_equal, np.less, np.less_equal,
                    np.greater, np.greater_equal][op](f, v)
        assert np.array_equal(got[0, :1024], want)


def test_set_variant_empty_disjoint_heterogeneous():
    rng = np.random.default_rng(500)
    cols = np.stack([rng.integers(0, 500, 2048),
                     rng.integers(0, 100, 2048)]).astype(np.int32)
    big = np.unique(rng.integers(0, 500, 200))
    key_sets = [
        [np.array([7])],                            # one key
        [np.unique(rng.integers(0, 500, 40))],      # mid-size
        [np.array([], np.int32)],                   # empty: must miss
        [big],                                      # heterogeneous sizes
        [np.array([10 ** 6, 2 * 10 ** 6])],         # disjoint from the column
    ]
    thr = np.array([[90], [50], [99], [10], [100]], np.int32)
    got = _assert_same(cols, thr, ((1, OPS["<"]),), set_cols=(0,),
                       key_sets=key_sets)
    assert not got[2].any() and not got[4].any()
    want1 = np.isin(cols[0], key_sets[1][0]) & (cols[1] < 50)
    assert np.array_equal(got[1, :2048], want1)


def test_set_variant_all_empty_dummy_slab_and_tautology():
    """Pure membership: the tautology atom ``>= INT32_MIN`` rides the set
    column, and all-empty sets use the one-key dummy slab."""
    rng = np.random.default_rng(501)
    cols = rng.integers(-3, 3, (1, 1024)).astype(np.int32)
    taut = ((0, OPS[">="]),)
    thr = np.full((2, 1), port_scan.INT32_MIN, np.int32)
    assert port_scan._TRUE_ATOM == _ref()[2]._TRUE_ATOM
    got = _assert_same(cols, thr, taut, set_cols=(0,),
                       key_sets=[[np.array([], np.int32)]] * 2)
    assert not got.any()
    got = _assert_same(cols, thr, taut, set_cols=(0,),
                       key_sets=[[np.array([-3, 0, 2])], [np.array([1])]])
    assert np.array_equal(got[0, :1024], np.isin(cols[0], [-3, 0, 2]))


def test_set_variant_two_set_atoms_sorted_blocks():
    """Two IN atoms on sorted data: set atoms join the block prune."""
    n = 8 * BR
    a = np.arange(n, dtype=np.int32)
    b = (np.arange(n) % 17).astype(np.int32)
    cols = np.stack([a, b])
    key_sets = [[np.array([5, 300, 301]), np.array([5, 12])],
                [np.arange(1500, 1600), np.arange(17)],
                [np.array([n + 5]), np.array([1])]]
    thr = np.zeros((3, 1), np.int32)
    got = _assert_same(cols, thr, ((0, OPS[">="]),), set_cols=(0, 1),
                       key_sets=key_sets)
    assert np.array_equal(np.flatnonzero(got[0]), [5, 301])
    assert not got[2].any()


def test_block_bounds_parity():
    rng = np.random.default_rng(600)
    slab = rng.integers(-(2 ** 31), 2 ** 31 - 1, (3, 4 * BR)).astype(np.int32)
    for atom_cols in ((0,), (2, 0, 2), (1, 1, 0, 2)):
        lo, hi = block_bounds(slab, BR, atom_cols)
        rlo, rhi = _ref()[1].block_bounds(slab, BR, atom_cols)
        assert np.array_equal(lo, rlo) and np.array_equal(hi, rhi)
        assert lo.dtype == rlo.dtype == np.int32


def test_wrapper_rejects_bad_shapes():
    cols = torch.zeros((1, 1000), dtype=torch.int32)
    thr = torch.zeros((1, 1), dtype=torch.int32)
    lo = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        pred_filter_batch(cols, thr, ((0, 0),), lo, lo, block_rows=BR)
    with pytest.raises(ValueError):
        pred_filter_batch(torch.zeros((1, 1024), dtype=torch.int32), thr,
                          ((0, 0), (0, 1)), lo, lo, block_rows=BR)


def test_pack_program_layout():
    """The kernel's program: atom columns, then atom ops, then set columns."""
    prog = pack_program(((0, OPS[">="]), (2, OPS["!="])), (1,))
    assert prog.dtype == np.int32
    assert prog.tolist() == [0, 2, OPS[">="], OPS["!="], 1]
    assert pack_program(()).size == 0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """Every op, the set variant, and a program wider than a kernel
    parameter block would hold (70 atoms, 20 set atoms)."""
    rng = np.random.default_rng(700)
    n = 64 * 1024
    cols = np.sort(rng.integers(-40, 40, (3, n)), axis=1).astype(np.int32)
    cols[2] = rng.permutation(cols[2])
    programs = [tuple((j % 3, op) for j, op in enumerate(ops))
                for ops in ((5, 2, 1), (0, 4, 3), (3, 1, 0), (4, 5, 2))]
    # wide: near-tautologies, with the selective atoms past index 64
    wide = tuple((j % 3, 1 + j % 5) for j in range(70))
    loose = {1: 100, 2: 45, 3: 44, 4: -45, 5: -44}
    dev = cuda_device
    for atoms in programs + [wide]:
        for m in (0, 1, 20):
            k = 8
            if atoms is wide:
                thr = np.tile([loose[o] for _, o in atoms], (k, 1))
                thr[:, 65:] = rng.integers(-40, 40, (k, 5))
                thr = thr.astype(np.int32)
            else:
                thr = rng.integers(-40, 40, (k, len(atoms))).astype(np.int32)
                thr[0, :] = cols[[c for c, _ in atoms], n // 2]  # exact hits
            set_cols = tuple(j % 3 for j in range(m))
            rows = tuple(c for c, _ in atoms) + set_cols
            lo, hi = block_bounds(cols, 1024, rows)
            kw = {}
            if m:
                key_sets = [[np.unique(rng.integers(-40, 40, int(s)))
                             for s in rng.integers(100, 300, m)] for _ in range(k)]
                slab, off, ln, mx = _sets(key_sets, k, m)
                kw = dict(set_cols=set_cols, set_slab=torch.from_numpy(slab),
                          set_off=torch.from_numpy(off),
                          set_len=torch.from_numpy(ln), iters=search_iters(mx))
            args = (torch.from_numpy(cols), torch.from_numpy(thr), atoms,
                    torch.from_numpy(lo), torch.from_numpy(hi))
            want = pred_filter_batch(*args, **kw)
            before = dict(LAUNCHES)
            got = pred_filter_batch(
                *[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args],
                **{key: v.to(dev) if isinstance(v, torch.Tensor) else v
                   for key, v in kw.items()})
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (atoms[:3], m)
            variant = "sets" if m else "cmp"
            assert LAUNCHES[variant] == before[variant] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,pure", [(1, False), (8, False), (64, False),
                                    (600, False), (1, True)])
def test_cuda_set_search_matches_plain(cuda_device, k, pure):
    """The set variant's lock-step search, bit for bit against the plain
    version: segment lengths 0, 1, 2 and around powers of two (where the
    number of halvings changes) and 65,536; INT32_MIN and INT32_MAX as keys
    and as column values; duplicates; compare and IN atoms mixed (or the
    scan backend's pure membership); whole blocks zone-pruned; up to 1,200
    segments in one launch."""
    rng = np.random.default_rng(900 + k + pure)
    i32 = np.iinfo(np.int32)
    n = 1024 * 24
    cols = np.stack([np.arange(n),                               # sorted
                     np.sort(rng.integers(-2000, 2000, n)),      # sorted
                     rng.integers(-2000, 2000, n)]).astype(np.int32)
    cols[1, :3], cols[1, -3:] = i32.min, i32.max
    cols[2, 5::97], cols[2, 7::89] = i32.min, i32.max
    set_cols = (1,) if pure else (1, 2)
    m = len(set_cols)
    lengths = [0, 1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257]
    key_sets = [[None] * m for _ in range(k)]
    for seg in range(k * m):
        ln = 1 << 16 if seg == 0 else lengths[7 * seg % len(lengths)]
        if seg % 4 == 3:  # duplicates
            keys = np.sort(rng.integers(-2500, 2500, ln))
        else:  # short sets over the columns' range, so that rows hit them
            pool = np.arange(-40_000, 40_000) if ln > 4000 else np.arange(-2500, 2500)
            keys = np.sort(rng.choice(pool, ln, replace=False))
        if ln >= 2 and seg % 3 == 0:
            keys[0], keys[-1] = i32.min, i32.max
        key_sets[seg // m][seg % m] = keys.astype(np.int32)
    if pure:  # the tautology atom the scan backend launches membership with
        atoms = ((1, OPS[">="]),)
        thr = np.full((k, 1), i32.min, np.int32)
    else:  # the first half of the blocks fails col 0 for every binding
        atoms = ((0, OPS[">="]), (2, OPS["!="]))
        thr = np.stack([rng.integers(n // 2, 3 * n // 4, k),
                        rng.integers(-2000, 2000, k)], axis=1).astype(np.int32)
    slab, off, ln, mx = _sets(key_sets, k, m)
    lo, hi = block_bounds(cols, 1024, tuple(c for c, _ in atoms) + set_cols)
    kw = dict(set_cols=set_cols, set_slab=torch.from_numpy(slab),
              set_off=torch.from_numpy(off), set_len=torch.from_numpy(ln),
              iters=search_iters(mx))
    args = (torch.from_numpy(cols), torch.from_numpy(thr), atoms,
            torch.from_numpy(lo), torch.from_numpy(hi))
    want = pred_filter_batch(*args, **kw)
    assert want.any() and not want.all()
    before = dict(LAUNCHES)
    got = pred_filter_batch(
        *[a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args],
        **{key: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for key, v in kw.items()})
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert LAUNCHES["sets"] == before["sets"] + 1
    assert LAUNCHES["cmp"] == before["cmp"]


# --------------------------------------------------------------------------- #
# the comparison kernel's persistent schedule (pred_filter_cmp_kernel)
# --------------------------------------------------------------------------- #

_CMP_WARPS = 8  # kCmpWarps: warps of a CTA, each owning whole zone blocks


def _cmp_schedule_writes(g, block_rows, grid, p, alive):
    """Mirror of the kernel's index arithmetic: how many times each mask
    byte of one binding is written, given which zone blocks are alive.  A
    warp walks blocks ``cta * 8 + warp`` in strides of ``grid * 8``; a live
    block is stored in passes of ``p`` chunks of 128 rows, one 4-byte word a
    lane a chunk; a dead one as a zero tile of 16-byte stores."""
    writes = np.zeros(g * block_rows, np.int64)
    chunks = block_rows // 128
    lanes = np.arange(32)
    for cta in range(grid):
        for warp in range(_CMP_WARPS):
            for blk in range(cta * _CMP_WARPS + warp, g, grid * _CMP_WARPS):
                base = blk * block_rows
                if alive[blk]:
                    for c0 in range(0, chunks, p):
                        for q in range(p):
                            if c0 + q < chunks:
                                start = base + (c0 + q) * 128 + lanes * 4
                                for b in range(4):
                                    writes[start + b] += 1
                else:
                    for i0 in range(0, block_rows // 16, 32):
                        i = i0 + lanes[i0 + lanes < block_rows // 16]
                        for b in range(16):
                            writes[base + 16 * i + b] += 1
    return writes


@pytest.mark.parametrize("block_rows,p", [(128, 8), (256, 4), (1024, 8),
                                         (1024, 4), (4096, 8), (640, 4)])
@pytest.mark.parametrize("g,grid", [(1, 1), (37, 3), (100, 13), (1000, 4)])
def test_cmp_schedule_writes_every_byte_once(block_rows, p, g, grid):
    """Every zone block is visited by exactly one warp, and every mask byte
    of a binding is written exactly once, live block or zero tile, for grids
    that do not divide the blocks and passes that do not divide a block."""
    grid = min(grid, -(-g // _CMP_WARPS))  # the launcher never starts more
    alive = np.random.default_rng(g + block_rows).random(g) < 0.5
    writes = _cmp_schedule_writes(g, block_rows, grid, p, alive)
    assert (writes == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,a,block_rows,kind", [
    (1, 1, 1024, "mixed"),        # the main path's largest launch shape
    (1, 4, 1024, "mixed"),
    (8, 1, 256, "mixed"),
    (16, 6, 1024, "mixed"),       # all six ops in one program
    (64, 4, 4096, "mixed"),
    (600, 2, 1024, "mixed"),
    (8200, 1, 128, "mixed"),      # more than one launch's bindings
    (1, 70, 1024, "mixed"),       # atoms past the ones held in registers
    (8, 70, 512, "mixed"),
    (1, 1, 1024, "all_pruned"),
    (8, 4, 1024, "all_pruned"),
    (1, 1, 1024, "none_pruned"),
    (8, 4, 1024, "none_pruned"),
])
def test_cuda_cmp_kernel_matches_plain(cuda_device, k, a, block_rows, kind):
    """The comparison kernel (no IN atoms) bit for bit against the plain
    version: zone-block counts that the persistent grid does not divide
    (3,301 blocks where memory allows), every block pruned or none, INT32
    extremes as column values and thresholds, all six ops."""
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(1300 + k + a + block_rows + len(kind))
    g = max(3, min(3301, 40_000_000 // (k * block_rows)))
    n = g * block_rows
    cols = np.stack([np.sort(rng.integers(-10**6, 10**6, n)),     # prunable
                     rng.integers(i32.min, i32.max, n, endpoint=True),
                     rng.integers(-3, 4, n)]).astype(np.int32)
    cols[1, 5::101], cols[1, 9::103] = i32.min, i32.max
    cols[0, :2], cols[0, -2:] = i32.min, i32.max
    # ops by column: ranges on the sorted column, == on the narrow one
    col_ops = ((2, 5, 3, 4, 1), (1, 4, 3, 2, 5, 0), (0, 1, 3, 5, 2, 4))
    atoms = tuple((j % 3, col_ops[j % 3][(j // 3) % len(col_ops[j % 3])])
                  for j in range(a))
    thr = np.empty((k, a), np.int64)
    mid = rng.integers(-5 * 10**5, 5 * 10**5, k)  # a window of col 0
    for j, (c, op) in enumerate(atoms):
        if c == 0:
            thr[:, j] = mid + {1: 0, 2: 2 * 10**5, 3: 2 * 10**5,
                               4: -2 * 10**5, 5: -2 * 10**5}[op]
        elif c == 1:
            thr[:, j] = rng.integers(i32.min, i32.max, k, endpoint=True)
            thr[1::3, j] = i32.min
            thr[2::3, j] = i32.max
        else:
            thr[:, j] = rng.integers(-3, 4, k)
    if a >= 8:  # long programs: loose atoms between selective ones
        loose = {1: 12_345_678, 3: i32.max, 5: i32.min}
        for j in range(4, a - 2):
            op = (1, 3, 5)[j % 3]
            atoms = atoms[:j] + ((j % 3, op),) + atoms[j + 1:]
            thr[:, j] = loose[op]
        # != a value other than atom 2's ==, so the two can both hold
        atoms = atoms[:a - 2] + ((2, OPS["!="]), (1, OPS["<"]))
        thr[:, a - 2] = (thr[:, 2] + 4) % 7 - 3
        thr[:, a - 1] = rng.integers(i32.min // 2, i32.max // 2, k)
    if kind == "all_pruned":  # col 0 < INT32_MIN: no block can match
        atoms = ((0, OPS["<"]),) + atoms[1:]
        thr[:, 0] = i32.min
    elif kind == "none_pruned":  # col 0 >= INT32_MIN, binding 0 loose
        loose = {0: 0, 1: 0, 2: i32.max, 3: i32.max, 4: i32.min, 5: i32.min}
        for j, (c, op) in enumerate(atoms):
            if c == 0:
                atoms = atoms[:j] + ((0, OPS[">="]),) + atoms[j + 1:]
                thr[:, j] = i32.min
            else:
                thr[0, j] = loose[op]
    thr = thr.astype(np.int32)
    lo, hi = block_bounds(cols, block_rows, tuple(c for c, _ in atoms))
    skipped = port_scan._skipped_blocks(atoms, lo, hi, thr)
    if kind == "all_pruned":
        assert skipped == g
    elif kind == "none_pruned":
        assert skipped == 0
    elif k == 1:
        assert 0 < skipped < g
    args = (torch.from_numpy(cols), torch.from_numpy(thr), atoms,
            torch.from_numpy(lo), torch.from_numpy(hi))
    want = pred_filter_batch(*args, block_rows=block_rows)
    assert want.any() or kind == "all_pruned"
    before = dict(LAUNCHES)
    got = pred_filter_batch(*[x.to(cuda_device) if isinstance(x, torch.Tensor)
                              else x for x in args], block_rows=block_rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert LAUNCHES["cmp"] == before["cmp"] + 1
    assert LAUNCHES["sets"] == before["sets"]
