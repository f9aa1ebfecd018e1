"""The float64 tensor-core kernels' index maps, emulated in numpy on the CPU.

``csrc/flash_f64.cu::flash_bwd_dkv_dmma_kernel`` (B3) and
``csrc/grouped_matmul.cu::grouped_matmul_dmma_kernel`` (B5; and
``grouped_matmul_tc_kernel<double>`` for rows TMA cannot take) run
``mma.sync.m16n8k8`` in float64 (``mma_f64`` in ``csrc/mma_tf32.cuh``) and
hard-code where each lane reads its fragments from shared memory. These
tests mirror those reads lane by lane, hand the fragments to an emulation of
the instruction (lane (g, t) holds a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],
b[i] = B[t + 4 i][g], c[i] = C[g + 8 (i / 2)][2t + i % 2]) and hold the
results to plain products at 1e-12 of their largest value (float64 sums in
another order). They also check that the reads are free of shared-memory
bank conflicts (a half warp's 16 doubles on 16 distinct 8-byte bank pairs),
and mirror B5's walk over the output tiles of ragged groups. No card: the
kernels themselves are held to their plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops

# the module (ops/__init__ exports a function of this name)
pgm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

TOL = 1e-12
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # the lane's group and thread in the group
I4, I2 = np.arange(4), np.arange(2)
# the fragment maps of mma.sync m16n8k8 .f64: [lane, register] -> (row, column)
A_ROW, A_COL = G[:, None] + 8 * (I4 % 2), T[:, None] + 4 * (I4 // 2)
B_ROW, B_COL = T[:, None] + 4 * I2, np.broadcast_to(G[:, None], (32, 2))
C_ROW, C_COL = G[:, None] + 8 * (I4 // 2), 2 * T[:, None] + I4 % 2


def mma_f64(c, a, b):
    """The instruction on one warp's fragments: c [32, 4] + a [32, 4] x b [32, 2]."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    A[A_ROW, A_COL], B[B_ROW, B_COL], C[C_ROW, C_COL] = a, b, c
    return (A @ B + C)[C_ROW, C_COL]


def swz(r, c):
    """wgmma.cuh's swz<double>: (r, c) of a 128B-swizzled block of 16 doubles a row."""
    return r * 16 + ((((c >> 1) ^ (r & 7)) << 1) | (c & 1))


def tile_at(rows, r, c):
    """wgmma.cuh's tile_at<double, rows>: (r, c) of [c / 16][rows][16] swizzled blocks."""
    return (c >> 4) * rows * 16 + swz(r, c & 15)


def dmma_col(t, slot):
    """The column of a 16-column block that flash_f64.cu's K-major reads
    take for lane t at reduction slot ``slot`` (0-3: the k8 steps' indices
    t and t + 4), as ``lane_offsets`` encodes it."""
    return (t & 1) + 8 * (t >> 1) + 2 * slot


def lane_offsets(gr, tc):
    """flash_f64.cu's lane_offsets: (k [4], mn [2][2]) of each lane."""
    k = [gr * 16 + ((((4 * (tc >> 1) + s) ^ gr) << 1) | (tc & 1)) for s in range(4)]
    mn = [[(2 * tc + e) * 16 + ((((4 * h + (gr >> 1)) ^ (2 * tc + e)) << 1) | (gr & 1))
           for e in range(2)] for h in range(2)]
    return k, mn


def swizzled(x):
    """A [rows, cols] matrix laid out as the kernel's swizzled tile (flat)."""
    rows, cols = x.shape
    out = np.zeros(rows * cols)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    out[tile_at(rows, r, c)] = x
    return out


def conflict_free(addr):
    """Every half warp's 16 doubles (addresses in doubles from a 128-byte
    aligned base) on 16 distinct 8-byte bank pairs."""
    addr = np.asarray(addr).reshape(32)
    return all(len(set((addr[h:h + 16] % 16).tolist())) == 16 for h in (0, 16))


@pytest.mark.parametrize("shape,rows,cols", [("A", A_ROW, A_COL), ("B", B_ROW, B_COL),
                                             ("C", C_ROW, C_COL)])
def test_fragment_maps_cover_every_element_once(shape, rows, cols):
    n_rows, n_cols = {"A": (16, 8), "B": (8, 8), "C": (16, 8)}[shape]
    seen = np.zeros((n_rows, n_cols), dtype=int)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulator_is_the_next_a_fragment_in_the_permuted_order(seed):
    """An m16n8 accumulator P (16 rows x 8 columns) as the A fragment (c[0],
    c[2], c[1], c[3]) of P·X, with X's rows read 2t and 2t + 1 (the kernels'
    MN-major B fragments), gives P·X."""
    rs = np.random.RandomState(seed)
    P, X = rs.randn(16, 8), rs.randn(8, 8)
    c = P[C_ROW, C_COL]
    a = c[:, [0, 2, 1, 3]]
    b = np.stack([X[2 * T, G], X[2 * T + 1, G]], axis=1)
    got = mma_f64(np.zeros((32, 4)), a, b)
    np.testing.assert_allclose(got, (P @ X)[C_ROW, C_COL], rtol=0, atol=TOL * abs(P @ X).max())


@pytest.mark.parametrize("rows", [32, 128])
def test_lane_offsets_are_the_swizzled_addresses(rows):
    """lane_offsets plus the kernel's constants address the elements the
    fragments want: K-major row r0 + g at column 16 kb + dmma_col(t, s),
    MN-major row 8j + 2t + e at column 8n + g."""
    ok, omn = lane_offsets(G, T)
    for kb in range(4):
        for r0 in range(0, rows, 8):
            for slot in range(4):
                want = tile_at(rows, r0 + G, kb * 16 + dmma_col(T, slot))
                assert (kb * rows * 16 + r0 * 16 + ok[slot] == want).all()
    for j in range(rows // 8):
        for n in range(8):
            for e in range(2):
                want = tile_at(rows, 8 * j + 2 * T + e, 8 * n + G)
                assert ((n >> 1) * rows * 16 + 128 * j + omn[n & 1][e] == want).all()


def test_dmma_col_is_a_permutation_of_each_block():
    cols = sorted(int(dmma_col(t, s)) for t in range(4) for s in range(4))
    assert cols == list(range(16))


def _b3_warp(k, v, q, g, lse, delta, scale, keep, warp):
    """One warp of the dk/dv kernel over one q tile, lane by lane as the
    kernel reads and computes: dk (unscaled, as accumulated) and dv of the
    warp's 16 keys. ``keep`` [keys, queries] is the mask the kernel forms."""
    nk, dmax = k.shape
    bm = q.shape[0]
    ks, vs, qs, gs = swizzled(k), swizzled(v), swizzled(q), swizzled(g)
    w0 = 16 * warp
    ok, omn = lane_offsets(G, T)
    s = np.zeros((bm // 8, 32, 4))
    dp = np.zeros((bm // 8, 32, 4))
    for kb in range(dmax // 16):  # scores(): k, v from the warp's first row
        for s2 in range(2):
            o0, o1 = ok[2 * s2], ok[2 * s2 + 1]
            pk = w0 * 16 + kb * nk * 16
            ak = np.stack([ks[pk + o0], ks[pk + 128 + o0], ks[pk + o1], ks[pk + 128 + o1]], 1)
            av = np.stack([vs[pk + o0], vs[pk + 128 + o0], vs[pk + o1], vs[pk + 128 + o1]], 1)
            for j in range(bm // 8):
                pq = kb * bm * 16 + 128 * j
                bq = np.stack([qs[pq + o0], qs[pq + o1]], 1)
                bg = np.stack([gs[pq + o0], gs[pq + o1]], 1)
                s[j] = mma_f64(s[j], ak, bq)
                dp[j] = mma_f64(dp[j], av, bg)
    for j in range(bm // 8):
        for e in range(4):
            kl = w0 + G + 8 * (e >> 1)
            ql = 8 * j + 2 * T + (e & 1)
            sv = np.where(keep[kl, ql], s[j][:, e] * scale, -1e30)
            p = np.where(sv > -0.5e30, np.exp(sv - lse[ql]), 0.0)
            s[j][:, e] = p
            dp[j][:, e] = p * (dp[j][:, e] - delta[ql])
    dk_acc = np.zeros((dmax // 8, 32, 4))
    dv_acc = np.zeros((dmax // 8, 32, 4))
    for j in range(bm // 8):  # sums()
        ap, ads = s[j][:, [0, 2, 1, 3]], dp[j][:, [0, 2, 1, 3]]
        for n in range(dmax // 8):
            px = (n >> 1) * bm * 16 + 128 * j
            o = omn[n & 1]
            bg = np.stack([gs[px + o[0]], gs[px + o[1]]], 1)
            bq = np.stack([qs[px + o[0]], qs[px + o[1]]], 1)
            dv_acc[n] = mma_f64(dv_acc[n], ap, bg)
            dk_acc[n] = mma_f64(dk_acc[n], ads, bq)
    dk, dv = np.zeros((16, dmax)), np.zeros((16, dmax))
    for n in range(dmax // 8):
        for e in range(4):
            r, c = G + 8 * (e >> 1), 8 * n + 2 * T + (e & 1)
            dk[r, c], dv[r, c] = dk_acc[n][:, e], dv_acc[n][:, e]
    return dk, dv


@pytest.mark.parametrize("dmax", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_b3_dmma_warp_matches_plain_products(dmax, masked):
    """dv = pᵀ·g and dk = dsᵀ·q (unscaled) of every warp of a 64-key block
    over a 32-row q tile, with the kernel's causal and key masks."""
    rs = np.random.RandomState(dmax + masked)
    nk, bm, scale = 64, 32, dmax ** -0.5
    k, v = rs.randn(nk, dmax), rs.randn(nk, dmax)
    q, g = rs.randn(bm, dmax), rs.randn(bm, dmax)
    keep = np.ones((nk, bm), dtype=bool)
    if masked:  # a causal frontier through the tile and a dropped key
        keep &= np.arange(bm)[None, :] + 40 >= np.arange(nk)[:, None]
        keep[5] = False
    s = np.where(keep, k @ q.T * scale, -np.inf)
    lse = np.log(np.exp(s).sum(axis=0)) + rs.rand(bm)  # other keys' weight besides
    delta = rs.randn(bm)
    p = np.where(keep, np.exp(s - lse[None, :]), 0.0)
    ds = p * (v @ g.T - delta[None, :])
    want_dv, want_dk = p @ g, ds @ q
    for warp in range(nk // 16):
        dk, dv = _b3_warp(k, v, q, g, lse, delta, scale, keep, warp)
        rows = slice(16 * warp, 16 * warp + 16)
        np.testing.assert_allclose(dv, want_dv[rows], rtol=0, atol=TOL * abs(want_dv).max())
        np.testing.assert_allclose(dk, want_dk[rows], rtol=0, atol=TOL * abs(want_dk).max())


@pytest.mark.parametrize("read", ["k, v (A)", "q, g (K-major B)", "g, q (MN-major B)"])
@pytest.mark.parametrize("dmax", [32, 64])
def test_b3_fragment_reads_are_conflict_free(read, dmax):
    nk, bm = 128, 32
    for kb in range(dmax // 16):
        for slot in range(4):
            col = kb * 16 + dmma_col(T, slot)
            if read == "k, v (A)":
                for w0 in range(0, nk, 16):
                    for half in (0, 8):
                        assert conflict_free(tile_at(nk, w0 + G + half, col))
            elif read == "q, g (K-major B)":
                for j in range(bm // 8):
                    assert conflict_free(tile_at(bm, 8 * j + G, col))
    if read == "g, q (MN-major B)":
        for j in range(bm // 8):
            for n in range(dmax // 8):
                for e in (0, 1):
                    assert conflict_free(tile_at(bm, 8 * j + 2 * T + e, 8 * n + G))


def test_b3_natural_k_order_would_conflict():
    """Why dmma_col: reading the K-major tiles at columns t and t + 4, as
    they lie, puts two lanes of a half warp on each bank pair."""
    assert not conflict_free(tile_at(32, G, T))


# B5 in float64: grouped_matmul.cu's grouped_matmul_dmma_kernel (TMA,
# swizzled stages) and, for rows TMA cannot take, Slab<double> of
# grouped_matmul_tc_kernel (cp.async, padded stages)
BM, BN, BK, AS, BS = 128, 128, 16, 20, 132
WARPS_M, WARPS_N, MT, NT = 2, 4, 4, 4


def dm_col(p, g):
    """grouped_matmul.cu's dm_col: the column of a 16-column block that
    holds column g of n8 tile p."""
    return (g & 1) + 2 * p + 4 * (g >> 2) + 8 * ((g >> 1) & 1)


def dm_lane_offsets(g, t):
    """The TMA kernel's la[u][rr] and lb[p][q]."""
    la = [[(2 * g + rr) * 16 + ((((2 * u + (t >> 1)) ^ ((2 * g + rr) & 7)) << 1) | (t & 1))
           for rr in range(2)] for u in range(4)]
    lb = [[(t + 4 * q) * 16 + ((((dm_col(p, g) >> 1) ^ (t + 4 * q)) << 1) | (g & 1))
           for q in range(2)] for p in range(2)]
    return la, lb


DM_BK = 48  # the TMA kernel's k-slab (kDmBK)


def _b5_dmma_block(A, B):
    """One 128 x 128 output tile of the TMA kernel: each slab's A [128][48]
    and B [48][128] laid out as TMA writes them (128B-swizzled blocks of 16
    doubles a row: A as [3][128][16], B as [8][48][16]), the 8 warps' reads
    through dm_lane_offsets, and the store through the row and column
    permutations."""
    d = A.shape[1]
    la, lb = dm_lane_offsets(G, T)
    out = np.full((BM, BN), np.nan)
    for warp in range(WARPS_M * WARPS_N):
        wm0, wn0 = (warp // WARPS_N) * 64, (warp % WARPS_N) * 32
        acc = np.zeros((MT, NT, 32, 4))
        for k0 in range(0, d, DM_BK):
            As = np.zeros((BM, DM_BK))
            Bs = np.zeros((DM_BK, BN))
            kw = min(DM_BK, d - k0)
            As[:, :kw], Bs[:kw] = A[:, k0:k0 + kw], B[k0:k0 + kw]
            As = swizzled(As)
            Bs = np.concatenate([swizzled(Bs[:, 16 * j:16 * j + 16]) for j in range(BN // 16)])
            for k8 in range(DM_BK // 8):
                u = 2 * (k8 & 1)
                a = [np.stack([As[(k8 >> 1) * BM * 16 + (wm0 + 16 * i) * 16 + la[u + q][rr]]
                               for q in range(2) for rr in range(2)], 1) for i in range(MT)]
                b = [np.stack([Bs[((wn0 >> 4) + (j >> 1)) * DM_BK * 16 + k8 * 128 + lb[j & 1][q]]
                               for q in range(2)], 1) for j in range(NT)]
                for i in range(MT):
                    for j in range(NT):
                        acc[i, j] = mma_f64(acc[i, j], a[i], b[j])
        for i in range(MT):
            for j in range(NT):
                for e in range(4):
                    r = wm0 + 16 * i + 2 * G + e // 2
                    c = wn0 + 16 * (j >> 1) + dm_col(j & 1, 2 * T) + e % 2
                    out[r, c] = acc[i, j][:, e]
    return out


@pytest.mark.parametrize("d", [16, 40, 96])
def test_b5_tma_kernel_block_matches_the_product(d):
    rs = np.random.RandomState(d + 1)
    A, B = rs.randn(BM, d), rs.randn(d, BN)
    want = A @ B
    np.testing.assert_allclose(_b5_dmma_block(A, B), want, rtol=0, atol=TOL * abs(want).max())


def test_b5_tma_kernel_reads_are_conflict_free():
    la, lb = dm_lane_offsets(G, T)
    for u in range(4):
        for rr in range(2):
            assert conflict_free(la[u][rr])
    for p in range(2):
        for q in range(2):
            assert conflict_free(lb[p][q])
    # the same reads without the permutations would not be
    assert not conflict_free(tile_at(16, G, T))                   # A rows g, columns t
    assert not conflict_free(tile_at(16, T, G))                   # B rows t, columns g


def test_b5_tma_kernel_permutations_are_bijections():
    assert sorted(dm_col(p, g) for p in range(2) for g in range(8)) == list(range(16))
    rows = sorted(2 * g + rr for g in range(8) for rr in range(2))
    assert rows == list(range(16))


def _b5_block(A, B):
    """One 128 x 128 output tile of the cp.async kernel: the 8 warps'
    fragment reads from the padded slabs (A [128][20], B [16][132])."""
    d = A.shape[1]
    out = np.zeros((BM, BN))
    for warp in range(WARPS_M * WARPS_N):
        wm0, wn0 = (warp // WARPS_N) * 64, (warp % WARPS_N) * 32
        acc = np.zeros((MT, NT, 32, 4))
        for k0 in range(0, d, BK):
            As = np.zeros((BM, AS))
            Bs = np.zeros((BK, BS))
            kw = min(BK, d - k0)
            As[:, :kw], Bs[:kw, :BN] = A[:, k0:k0 + kw], B[k0:k0 + kw]
            As, Bs = As.reshape(-1), Bs.reshape(-1)
            for kk in range(0, BK, 8):
                a = [np.stack([As[p], As[p + 8 * AS], As[p + 4], As[p + 8 * AS + 4]], 1)
                     for p in ((wm0 + 16 * i + G) * AS + kk + T for i in range(MT))]
                b = [np.stack([Bs[p], Bs[p + 4 * BS]], 1)
                     for p in ((kk + T) * BS + wn0 + 8 * j + G for j in range(NT))]
                for i in range(MT):
                    for j in range(NT):
                        acc[i, j] = mma_f64(acc[i, j], a[i], b[j])
        for i in range(MT):
            for j in range(NT):
                for e in range(4):
                    out[wm0 + 16 * i + G + 8 * (e // 2), wn0 + 8 * j + 2 * T + e % 2] = \
                        acc[i, j][:, e]
    return out


@pytest.mark.parametrize("d", [16, 40, 96])
def test_b5_cp_async_block_matches_the_product(d):
    rs = np.random.RandomState(d)
    A, B = rs.randn(BM, d), rs.randn(d, BN)
    want = A @ B
    np.testing.assert_allclose(_b5_block(A, B), want, rtol=0, atol=TOL * abs(want).max())


def test_b5_cp_async_reads_are_conflict_free():
    for kk in (0, 8):
        for i in range(MT):
            for wm0 in (0, 64):
                p = (wm0 + 16 * i + G) * AS + kk + T
                for off in (0, 8 * AS, 4, 8 * AS + 4):
                    assert conflict_free(p + off)
        for j in range(NT):
            for wn0 in (0, 32, 64, 96):
                p = (kk + T) * BS + wn0 + 8 * j + G
                assert conflict_free(p) and conflict_free(p + 4 * BS)


def _group_rows(sizes, n, m_pad, e, m0):
    """grouped_matmul.cu's group_rows<128>: (first row, rows) of group e's
    tile at local row m0, or None past the group's frontier or outside n."""
    off = sum(sizes[:e])
    limit = min(max(sizes[e], 0), m_pad)
    if m0 >= limit:
        return None
    row0 = off + m0
    if row0 < 0 or row0 >= n:
        return None
    return row0, min(min(BM, limit - m0), n - row0)


@pytest.mark.parametrize("n,d,h,sizes,max_group", [
    (300, 72, 130, (0, 150, 90, 5), 100),      # an empty group, a group over m_pad, a tail
    (1000, 256, 200, (0, 300, 0, 350, 100), 256),
    (50, 16, 8, (30, 40), None),               # sum(sizes) > n: rows >= n never touched
    (16384, 8, 16, (2560, 2560, 2560, 2560, 1900, 1300, 944, 0), 2560),  # the MoE's routing
    (333, 40, 90, (100, 0, 150), None),
])
def test_b5_tile_walk_covers_each_kept_row_once(n, d, h, sizes, max_group):
    """The grid (h tiles, m tiles up to m_pad, groups) writes each kept row
    once a column tile and no other row; the kept rows are those the plain
    version leaves nonzero, so every other row of the output is the
    wrapper's zero."""
    m_pad = pgm._tiling(n, max_group, 128)[0]
    covered = np.zeros((n, (h + BN - 1) // BN), dtype=int)
    for e in range(len(sizes)):
        for y in range((m_pad + BM - 1) // BM):
            tile = _group_rows(list(sizes), n, m_pad, e, y * BM)
            if tile is None:
                continue
            row0, rows = tile
            covered[row0:row0 + rows] += 1  # every column tile x of this (y, e)
    rs = np.random.RandomState(n)
    lhs = torch.from_numpy(rs.randn(n, d) + 3.0)
    rhs = torch.from_numpy(rs.rand(len(sizes), d, h) + 1.0)  # positive: kept rows are nonzero
    ref = ops.grouped_matmul_plain(lhs.abs(), torch.tensor(sizes, dtype=torch.int32), rhs,
                                   max_group_size=max_group)
    kept = (ref != 0).any(dim=1).numpy()
    assert (covered[kept] == 1).all() and (covered[~kept] == 0).all()
