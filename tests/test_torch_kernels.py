"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels (interpret mode) and oracles, at
tests/test_kernels.py's shapes and tolerances; and the tiling the wrappers
pick for the CUDA kernels."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_decode.kernel import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_fd_ref
from repro.kernels.rowstream_matmul.kernel import (
    rowstream_matmul as jax_rowstream)
from repro.kernels.rowstream_matmul.ref import rowstream_matmul_ref as jax_rm_ref
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.rowstream_matmul import kernel as rm_kernel
from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same float32 values as a JAX array and a tensor of `dtype`
    (both round float32 to bf16 to nearest even: identical bits)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(port, ref, tol, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=atol)


# --- rowstream matmul --------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (64, 512, 256),
                                   (256, 1024, 128), (8, 256, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowstream_matmul_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * k + n)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    out = rowstream_matmul(xt, wt)
    assert out.dtype == xt.dtype and out.shape == (m, n)
    assert torch.equal(out, rowstream_matmul_ref(xt, wt))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    _close(out, jax_rowstream(xj, wj), tol, tol * 8)
    _close(out, jax_rm_ref(xj, wj), tol, tol * 8)


def test_rowstream_matmul_rejects_bad_inputs():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        rowstream_matmul(x, torch.zeros((9, 3)))
    with pytest.raises(TypeError):
        rowstream_matmul(x, torch.zeros((8, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rowstream_matmul(x, torch.zeros((3, 8)).T)
    with pytest.raises(ValueError):
        rowstream_matmul(torch.zeros((0, 8)), torch.zeros((8, 3)))


# The decode products of qwen2-7b and rwkv6-3b at 4 slots, and odd shapes.
RM_DECODE = [(4, 3584, 3584), (4, 3584, 512), (4, 3584, 18944),
             (4, 18944, 3584), (4, 3584, 152064), (4, 2560, 2560),
             (4, 2560, 64), (4, 64, 2560), (4, 2560, 8960), (4, 8960, 2560),
             (4, 2560, 65536)]
RM_ODD = [(1, 100, 37), (33, 1000, 1000), (4, 64, 4100), (1, 1000, 1000),
          (4, 64, 2056)]
SMS = 132
# The heaviest block streams at most this many times the mean weight bytes
# of a block, or one split unit more than the mean where blocks hold only a
# few units: the product takes as long as its heaviest block, and a block
# lighter than the rest costs nothing (a narrow last tile of a wide head
# can take no more rows than a cluster's share of K).
MAX_BLOCK_OVER_MEAN = 1.25


@pytest.mark.parametrize("m,k,n", RM_DECODE + RM_ODD)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rowstream_plan_covers_and_keeps_rows(m, k, n, itemsize):
    p = rm_kernel.plan(m, k, n, itemsize, True, SMS)
    assert rm_kernel.plan(m, k, n, itemsize, True, SMS) is p    # cached
    assert p.mt >= min(m, 8) and p.mt in (1, 2, 4, 8)
    if (n * itemsize) % 16:
        assert p.vec == 1                       # the scalar kernel
        return
    assert p.vec * itemsize == 16
    assert 1 <= p.cluster <= rm_kernel.MAX_CLUSTER
    # Columns and K are covered exactly once, K by non-empty splits that
    # start on whole units, in every tile.
    assert p.tiles * p.cols + p.cols_r == n and 0 <= p.cols_r < p.cols
    assert p.cols * itemsize <= 4096
    for _, _, groups in p.classes:
        ranges = p.k_ranges(groups)
        assert len(ranges) == groups * p.cluster
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(kb < ke and kb % p.granule == 0 for kb, ke in ranges)
    weight = k * n * itemsize
    # Runs of whole 4 KB rows where the row width allows it (wider than
    # 4 KB, or dividing it), unless the product holds fewer than two such
    # rows per SM: then a full wave of blocks comes first.
    row = n * itemsize
    if (row > 4096 or 4096 % row == 0) and weight >= 2 * SMS * 4096:
        assert p.run_bytes % 4096 == 0
    # The fp32 workspace is at most 1/16 of the weight's bytes.
    assert p.ws_floats * 4 * 16 <= weight
    assert (p.ws_floats > 0) == (p.groups > 1)
    assert p.counters == (p.mtiles * (p.tiles + 1) * p.cluster
                          if p.groups > 1 else 0)
    # The grid fills one wave: a block on every SM, and the decode
    # products' bf16 grids fit at two blocks per SM; products under
    # SMALL_BYTES fit at one block per SM, with a block on half the SMs.
    small = weight < rm_kernel.SMALL_BYTES
    assert p.blocks >= (SMS + 1) // 2 if small else p.blocks >= SMS
    if (m, k, n) in RM_DECODE and itemsize == 2:
        assert p.clusters <= rm_kernel.uniform_slots(
            SMS, 1 if small else 2)[p.cluster - 1]
    # Balanced by bytes.
    bytes_ = p.block_bytes()
    assert sum(bytes_) == weight
    mean = weight / len(bytes_)
    assert max(bytes_) <= max(MAX_BLOCK_OVER_MEAN * mean,
                              mean + p.granule * p.cols * itemsize)
    # x's slice and the shared memory fit.
    assert p.rows_max() * p.mt * itemsize <= rm_kernel.X_BYTES
    assert p.smem <= rm_kernel.SMEM_PER_BLOCK


def test_rowstream_plan_scalar_and_row_tiles():
    """An unaligned weight takes the scalar kernel; m > 8 takes tiles of 8
    rows of x; a narrow row is streamed in whole 4 KB runs (wk, wv)."""
    assert rm_kernel.plan(4, 3584, 3584, 2, False, SMS).vec == 1
    p = rm_kernel.plan(33, 2560, 2560, 2, True, SMS)
    assert (p.mt, p.mtiles) == (8, 5)
    p = rm_kernel.plan(4, 3584, 512, 2, True, SMS)
    assert (p.tiles, p.cols, p.cols_r) == (1, 512, 0)
    assert p.granule * 512 * 2 == 4096


# --- flash decode ------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 8, 2, 128, 64),
                                         (1, 4, 4, 256, 64),
                                         (3, 16, 4, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_jax(b, h, hkv, s, d, dtype):
    rng = np.random.default_rng(b * h + s + d)
    qj, qt = _pair(rng.standard_normal((b, h, d), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    pos = s // 2
    out = flash_decode(qt, kt, vt, pos)
    assert out.dtype == qt.dtype and out.shape == (b, h, d)
    assert torch.equal(out, flash_decode_ref(qt, kt, vt, pos))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    pj = jnp.array(pos, jnp.int32)
    _close(out, jax_flash_decode(qj, kj, vj, pj), tol, tol)
    _close(out, jax_fd_ref(qj, kj, vj, pj), tol, tol)


@pytest.mark.parametrize("pos", [0, 37, 63, 64, 100])
def test_flash_decode_fp32_query_bf16_cache(pos):
    """The fp32 model keeps q in fp32 against the bf16 cache; pos >= S (a
    full ring buffer) attends to every slot."""
    rng = np.random.default_rng(pos)
    b, h, hkv, s, d = 2, 6, 2, 64, 16
    q = rng.standard_normal((b, h, d), np.float32)
    kj, kt = _pair(rng.standard_normal((b, hkv, s, d), np.float32),
                   "bfloat16")
    vj, vt = _pair(rng.standard_normal((b, hkv, s, d), np.float32),
                   "bfloat16")
    out = flash_decode(torch.from_numpy(q), kt, vt, pos)
    assert out.dtype == torch.float32
    ref = jax_fd_ref(jnp.asarray(q), kj, vj, jnp.array(pos, jnp.int32))
    _close(out, ref, 1e-5, 1e-5)


def test_flash_decode_masks_future():
    """Slots beyond pos are unwritten garbage and must not leak."""
    rng = np.random.default_rng(7)
    b, h, hkv, s, d = 1, 4, 2, 64, 32
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    vc = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    out1 = flash_decode(q, kc, vc, 10)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, :, 11:] = 1e9
    vc2[:, :, 11:] = -1e9
    out2 = flash_decode(q, kc2, vc2, 10)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


def test_flash_decode_rejects_bad_inputs():
    q = torch.zeros((1, 4, 16))
    kc = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        flash_decode(q, kc, kc, -1)
    with pytest.raises(ValueError):
        flash_decode(torch.zeros((1, 3, 16)), kc, kc, 0)
    with pytest.raises(TypeError):
        flash_decode(q.bfloat16(), kc, kc, 0)
    with pytest.raises(ValueError):
        flash_decode(torch.zeros((1, 4, 512)), torch.zeros((1, 2, 8, 512)),
                     torch.zeros((1, 2, 8, 512)), 0)
    with pytest.raises(ValueError):
        flash_decode(q, kc[:, :, :0], kc[:, :, :0], 0)


@pytest.mark.parametrize("n_valid,d,itemsize", [(128, 128, 2), (1, 128, 2),
                                                (4096, 128, 2), (200, 80, 2),
                                                (33, 16, 4), (1000, 100, 2)])
def test_flash_decode_chunks_start_on_rows(n_valid, d, itemsize):
    chunk, nsplit = fd_kernel.plan(n_valid, 16, d, itemsize, 132)
    row_tokens = 4096 // np.gcd(d * itemsize, 4096)
    if row_tokens <= fd_kernel.MAX_ROW_TOKENS:
        assert (chunk * d * itemsize) % 4096 == 0
    else:
        assert chunk % fd_kernel.GRANULE == 0
    assert (nsplit - 1) * chunk < n_valid <= nsplit * chunk


def _chunks(n_valid, clusters, d, itemsize, sms=132):
    chunk, nsplit = fd_kernel.plan(n_valid, clusters, d, itemsize, sms)
    return [(i * chunk, min(n_valid, (i + 1) * chunk))
            for i in range(nsplit)]


@pytest.mark.parametrize("n_valid", [1, 15, 16, 17, 101, 128, 4095, 4096,
                                     20001, 32768])
@pytest.mark.parametrize("clusters,d,itemsize", [(16, 128, 2), (16, 128, 4),
                                                 (4, 64, 2), (200, 128, 2),
                                                 (2, 80, 2), (3, 100, 2)])
def test_flash_decode_chunks_cover_the_prefix(n_valid, clusters, d,
                                              itemsize):
    """The chunks cover [0, n_valid) exactly, in order, none empty; every
    chunk but the last starts on a 4 KB row of one head's K where rows
    hold at most MAX_ROW_TOKENS tokens; 1 <= nsplit <= 8; no chunk but
    the last is shorter than MIN_CHUNK."""
    chunks = _chunks(n_valid, clusters, d, itemsize)
    assert 1 <= len(chunks) <= fd_kernel.MAX_SPLITS
    assert chunks[0][0] == 0 and chunks[-1][1] == n_valid
    assert all(a < b for a, b in chunks)
    assert all(chunks[i][1] == chunks[i + 1][0]
               for i in range(len(chunks) - 1))
    assert all(b - a >= fd_kernel.MIN_CHUNK for a, b in chunks[:-1])
    if 4096 // np.gcd(d * itemsize, 4096) <= fd_kernel.MAX_ROW_TOKENS:
        assert all(a * d * itemsize % 4096 == 0 for a, _ in chunks)


@pytest.mark.parametrize("sms,splits", [(132, 8), (64, 4), (16, 1),
                                        (8, 1)])
def test_flash_decode_splits_fill_one_wave(sms, splits):
    """qwen2-7b at 4 slots (16 pairs) over its 32768-slot cache: 8 splits
    on the H100's 132 SMs, fewer where the card has fewer."""
    chunk, nsplit = fd_kernel.plan(32768, 16, 128, 2, sms)
    assert nsplit == splits and chunk * nsplit == 32768


@pytest.mark.parametrize("pos,S,n_valid", [(0, 64, 1), (63, 64, 64),
                                           (64, 64, 64), (1000, 64, 64),
                                           (40000, 32768, 32768)])
def test_flash_decode_ring_buffer_reads_every_slot(pos, S, n_valid):
    """pos >= S (a full ring buffer) attends to every slot."""
    assert fd_kernel.valid_tokens(pos, S) == n_valid
    chunks = _chunks(fd_kernel.valid_tokens(pos, S), 16, 128, 2)
    assert chunks[-1][1] == n_valid


@pytest.mark.parametrize("g,groups", [(1, 1), (7, 1), (8, 1), (9, 2),
                                      (32, 4)])
def test_flash_decode_head_groups(g, groups):
    assert fd_kernel.head_groups(g) == groups
