"""The port's RWKV6 scan wrapper on CPU tensors (its plain PyTorch
version) against the JAX package's Pallas kernel (interpret mode) and
oracle, at tests/test_kernels.py's shapes and tolerances; the CPU mirror
of the CUDA kernel's algebra (tiles, decays as running products of w)
against both; the chunk pickers; the kernel's launch plan; and the
wrapper's input checks."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rwkv_scan.kernel import pick_chunk as jax_pick_chunk
from repro.kernels.rwkv_scan.kernel import rwkv_scan as jax_rwkv_scan
from repro.kernels.rwkv_scan.ref import rwkv_scan_ref as jax_rwkv_ref
from repro_torch.kernels import launch_counters, reset_launch_counters
from repro_torch.kernels.rwkv_scan import kernel as rs_kernel
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.kernels.rwkv_scan.ref import (rwkv_scan_chunked_ref,
                                               rwkv_scan_ref)

TOL = 1e-3           # tests/test_kernels.py::test_rwkv_scan
DECAY_ATOL = 2e-3    # tests/test_kernels.py::test_rwkv_scan_extreme_decay_stable


def _inputs(seed, b, s, H, hd, extreme=False, low=1e-35):
    """r, k, v, w (b, s, H, hd) and u (H, hd) as float32 numpy arrays, w
    in (0.4, 0.9) as in tests/test_kernels.py, or with extreme=True `low`
    at 40 % of the entries and 0.9 elsewhere, and u zero."""
    rng = np.random.default_rng(seed)
    shape = (b, s, H, hd)
    r, k, v = (rng.standard_normal(shape, np.float32) for _ in range(3))
    if extreme:
        w = np.where(rng.random(shape) < 0.4, low, 0.9).astype(np.float32)
        u = np.zeros((H, hd), np.float32)
    else:
        w = (0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.4
             ).astype(np.float32)
        u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=TOL,
                               atol=atol)


@pytest.mark.parametrize("b,s,H,hd,chunk", [(2, 64, 3, 16, 16),
                                            (1, 128, 2, 32, 32),
                                            (2, 48, 4, 16, 8)])
def test_rwkv_scan_matches_jax(b, s, H, hd, chunk):
    arrays = _inputs(b * s + hd, b, s, H, hd)
    jin = [jnp.asarray(a) for a in arrays]
    tin = [torch.from_numpy(a) for a in arrays]
    o, S = rwkv_scan(*tin, chunk=chunk)
    assert o.shape == (b, s, H, hd) and o.dtype == torch.float32
    assert S.shape == (b, H, hd, hd) and S.dtype == torch.float32
    ro, rS = rwkv_scan_ref(*tin)
    assert torch.equal(o, ro) and torch.equal(S, rS)
    for jo, jS in (jax_rwkv_scan(*jin, chunk=chunk), jax_rwkv_ref(*jin)):
        _close(o, jo, TOL)
        _close(S, jS, TOL)


def test_rwkv_scan_extreme_decay_matches_jax():
    """Decays of 1e-35 at 40 % of the entries: finite, and within the
    reference's tolerance of its kernel and oracle."""
    arrays = _inputs(3, 1, 32, 2, 16, extreme=True)
    jin = [jnp.asarray(a) for a in arrays]
    o, S = rwkv_scan(*(torch.from_numpy(a) for a in arrays), chunk=8)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    for jo, jS in (jax_rwkv_scan(*jin, chunk=8), jax_rwkv_ref(*jin)):
        _close(o, jo, DECAY_ATOL)
        _close(S, jS, DECAY_ATOL)


@pytest.mark.parametrize("s", [1, 6, 37])
def test_rwkv_scan_bf16_inputs_match_jax(s):
    """bf16 r/k/v/w with an fp32 u: fp32 math inside, o in bf16 (both
    packages round float32 to bf16 to nearest even: identical inputs)."""
    b, H, hd = 2, 2, 16
    arrays = _inputs(s, b, s, H, hd)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:4]] \
        + [jnp.asarray(arrays[4])]
    tin = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:4]] \
        + [torch.from_numpy(arrays[4])]
    o, S = rwkv_scan(*tin)
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    jo, jS = jax_rwkv_ref(*jin)
    # o rounds to bf16 once, from fp32 sums in another order: 2e-2, the
    # bf16 tolerance of tests/test_kernels.py.
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               rtol=2e-2, atol=2e-2)
    _close(S, jS, TOL)


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 48, 64, 128])
@pytest.mark.parametrize("s", [1, 6, 8, 48, 64, 100, 1000, 1024, 4096])
def test_pick_chunk_matches_jax(s, hd):
    assert rs_kernel.pick_chunk(s, hd) == jax_pick_chunk(s, hd)
    assert rs_kernel.pick_chunk(s, hd, 2) == jax_pick_chunk(s, hd, 2)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_default_chunk_fills_whole_rows(hd):
    """The kernel's chunk when none is given: a 4 KB row of fp32 per
    operand chunk (16 tokens at rwkv6's hd 64), whatever s is."""
    c = rs_kernel.default_chunk(hd)
    assert c * hd * 4 == 4096 and c <= rs_kernel.MAX_CHUNK
    assert c == jax_pick_chunk(1024, hd)


@pytest.mark.parametrize("b,s,H,hd,chunk", [(2, 64, 3, 16, 16),
                                            (1, 128, 2, 32, 32),
                                            (2, 48, 4, 16, 8)])
def test_chunked_mirror_matches_jax(b, s, H, hd, chunk):
    """The kernel's algebra at tests/test_kernels.py's shapes: a chunk of
    32 is walked as two tiles of 16, a chunk of 8 as one padded tile."""
    arrays = _inputs(b * s + hd, b, s, H, hd)
    jin = [jnp.asarray(a) for a in arrays]
    o, S = rwkv_scan_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                                 chunk=chunk)
    for jo, jS in (jax_rwkv_scan(*jin, chunk=chunk), jax_rwkv_ref(*jin)):
        _close(o, jo, TOL)
        _close(S, jS, TOL)


@pytest.mark.parametrize("low", [0.0, 1e-35])
def test_chunked_mirror_extreme_decay_matches_jax(low):
    """Decays of 0 or 1e-35 at 40 % of the entries: the running products
    underflow to 0 where the reference's exp does, never to NaN. At w = 0
    only the oracle is a reference: the Pallas kernel's clamp, 1e-38, is
    subnormal, the CPU flushes it to 0, and its log of 0 makes its
    outputs NaN."""
    arrays = _inputs(5, 1, 48, 2, 16, extreme=True, low=low)
    jin = [jnp.asarray(a) for a in arrays]
    o, S = rwkv_scan_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                                 chunk=16)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    refs = [jax_rwkv_ref(*jin)]
    if low > 0:
        refs.append(jax_rwkv_scan(*jin, chunk=16))
    for jo, jS in refs:
        _close(o, jo, DECAY_ATOL)
        _close(S, jS, DECAY_ATOL)


@pytest.mark.parametrize("s,chunk", [(1, 16), (6, 16), (37, 16), (37, 24),
                                     (100, 64), (21, 5)])
def test_chunked_mirror_ragged_matches_jax(s, chunk):
    """A ragged last chunk (and chunks that are not whole tiles) against
    the JAX kernel at its own dividing chunk and against its oracle."""
    arrays = _inputs(s + chunk, 2, s, 2, 16)
    jin = [jnp.asarray(a) for a in arrays]
    o, S = rwkv_scan_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                                 chunk=chunk)
    for jo, jS in (jax_rwkv_scan(*jin), jax_rwkv_ref(*jin)):
        _close(o, jo, TOL)
        _close(S, jS, TOL)


def _tile_at(t, s, chunk):
    """csrc ``tile_at``, transcribed."""
    tpc = -(-chunk // rs_kernel.TILE)
    c, m = divmod(t, tpc)
    start = c * chunk + m * rs_kernel.TILE
    return start, min(rs_kernel.TILE, chunk - m * rs_kernel.TILE, s - start)


@pytest.mark.parametrize("s", [1, 6, 16, 17, 100, 1000, 1024])
@pytest.mark.parametrize("chunk", [1, 5, 8, 16, 24, 32, 63, 64])
def test_tiles_cover_the_sequence_within_chunks(s, chunk):
    """The kernel's tiles, as csrc ``tile_at`` numbers them and as
    ``tile_bounds`` lists them: in order, back to back, at most TILE tokens,
    none across a chunk boundary; the count is the launch's."""
    tiles = rs_kernel.tile_bounds(s, chunk)
    tpc = -(-chunk // rs_kernel.TILE)
    assert len(tiles) == (s // chunk) * tpc \
        + -(-(s % chunk) // rs_kernel.TILE)
    assert tiles == [_tile_at(t, s, chunk) for t in range(len(tiles))]
    pos = 0
    for start, n in tiles:
        assert start == pos and 1 <= n <= rs_kernel.TILE
        assert start // chunk == (start + n - 1) // chunk
        pos += n
    assert pos == s
    assert rs_kernel.plan(2, 3, s, chunk, 4).tiles == len(tiles)


def test_plan_one_block_per_head_two_per_sm():
    """rwkv6-3b's forward: one block per (b, h), 64 tiles of 16 tokens, so
    each tile of one fp32 operand of one head is one 4 KB row; the block's
    shared memory is within one block's limit and two blocks fit an SM,
    in fp32 and in bf16."""
    p = rs_kernel.plan(4, 40, 1024, rs_kernel.default_chunk(64), 4)
    assert (p.blocks, p.tiles) == (160, 64)
    assert rs_kernel.TILE * rs_kernel.MAX_HEAD_DIM * 4 == 4096
    for itemsize in (4, 2):
        smem = rs_kernel.smem_bytes(itemsize)
        assert smem <= rs_kernel.BLOCK_SMEM_MAX
        assert rs_kernel.plan(1, 1, 8, 8, itemsize).blocks_per_sm == 2


@pytest.mark.parametrize("hd", [1, 16, 64])
def test_heads_major_pads_the_head_dim(hd):
    """(b, s, H, hd) -> (b, H, s, 64): the channels past hd hold the fill
    (0 for r, k, v; 1 for w, a decay that changes nothing)."""
    x = torch.arange(2 * 3 * 2 * hd, dtype=torch.float32).reshape(2, 3, 2,
                                                                    hd)
    out = rs_kernel._heads_major(x, 1.0)
    assert out.shape == (2, 2, 3, 64) and out.is_contiguous()
    assert torch.equal(out[..., :hd], x.transpose(1, 2))
    assert bool((out[..., hd:] == 1.0).all())


def test_rwkv_scan_rejects_bad_inputs():
    r = torch.zeros((1, 4, 2, 16))
    u = torch.zeros((2, 16))
    with pytest.raises(ValueError):                    # shapes differ
        rwkv_scan(r, r, r, torch.zeros((1, 4, 2, 8)), u)
    with pytest.raises(ValueError):                    # u's shape
        rwkv_scan(r, r, r, r, torch.zeros((16, 2)))
    with pytest.raises(ValueError):                    # empty
        e = torch.zeros((1, 0, 2, 16))
        rwkv_scan(e, e, e, e, u)
    with pytest.raises(ValueError, match="64"):        # hd over the limit
        big = torch.zeros((1, 4, 1, 128))
        rwkv_scan(big, big, big, big, torch.zeros((1, 128)))
    with pytest.raises(ValueError):                    # chunk out of range
        rwkv_scan(r, r, r, r, u, chunk=65)
    with pytest.raises(TypeError):                     # mixed dtypes
        rwkv_scan(r, r, r.to(torch.bfloat16), r, u)
    with pytest.raises(TypeError):                     # unsupported dtype
        h = r.to(torch.float16)
        rwkv_scan(h, h, h, h, u)
    with pytest.raises(ValueError, match="devices"):   # mixed devices
        rwkv_scan(r, r, r, r, u.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 4, 16)).transpose(1, 2)
        rwkv_scan(t, t, t, t, u)


def test_rwkv_scan_cpu_launches_nothing():
    reset_launch_counters()
    x = torch.ones((1, 3, 1, 16))
    rwkv_scan(x, x, x, x * 0.5, torch.zeros((1, 16)))
    assert launch_counters()["rwkv_scan"].count == 0
