"""The port's plain RWKV6 scan backward (``rwkv_scan_bwd_ref``) against
``jax.vjp`` of the JAX package's oracle (``repro.kernels.rwkv_scan.ref``)
and against torch autograd of the port's own ``rwkv_scan_ref``, with and
without a gradient of the final state; the wrapper's autograd.Function on
CPU tensors against both; its launch counters; and the kernel wrapper's
scratch size; and the backward kernel's tile algebra
(``rwkv_scan_bwd_chunked_ref``) against ``jax.vjp`` of the oracle. Shapes:
tests/test_kernels.py's three, its extreme-decay case, one of rwkv6's head
dim with a ragged length, and bf16 inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rwkv_scan.ref import rwkv_scan_ref as jax_rwkv_ref
from repro_torch.kernels import launch_counters, reset_launch_counters
from repro_torch.kernels.rwkv_scan import kernel as rs_kernel
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.kernels.rwkv_scan.ref import (rwkv_scan_bwd_chunked_ref,
                                               rwkv_scan_bwd_ref,
                                               rwkv_scan_ref)

# tests/test_kernels.py's rwkv tolerance (test_rwkv_scan), on gradients
# relative to the largest magnitude of each (they reach tens at s 128).
TOL = 1e-3
# bf16 inputs: the gradients round once to bf16 (2^-8 relative), from
# fp32 sums taken in the same order on both sides.
BF16_TOL = 2e-2

SHAPES = [(2, 64, 3, 16), (1, 128, 2, 32), (2, 48, 4, 16), (2, 13, 2, 64)]
# The tile algebra also at several tiles with a ragged last one.
TILE_SHAPES = SHAPES + [(1, 37, 2, 64)]


def _inputs(seed, b, s, H, hd, extreme=False):
    """r, k, v, w, u as in tests/test_torch_rwkv_scan.py, plus do and dS:
    float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (b, s, H, hd)
    r, k, v = (rng.standard_normal(shape, np.float32) for _ in range(3))
    if extreme:
        w = np.where(rng.random(shape) < 0.4, 1e-35, 0.9).astype(np.float32)
        u = np.zeros((H, hd), np.float32)
    else:
        w = (0.5 / (1 + np.exp(-rng.standard_normal(shape))) + 0.4
             ).astype(np.float32)
        u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    do = rng.standard_normal(shape, np.float32)
    dS = rng.standard_normal((b, H, hd, hd), np.float32)
    return (r, k, v, w, u), do, dS


def _jax_grads(arrays, do, dS):
    _, vjp = jax.vjp(lambda *x: jax_rwkv_ref(*x),
                     *[jnp.asarray(a) for a in arrays])
    b, _, H, hd = do.shape
    dS = jnp.zeros((b, H, hd, hd), jnp.float32) if dS is None \
        else jnp.asarray(dS)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), dS))]


def _autograd(arrays, do, dS, fn=rwkv_scan_ref):
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    o, S = fn(*xs)
    loss = (o * torch.from_numpy(do)).sum()
    if dS is not None:
        loss = loss + (S * torch.from_numpy(dS)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


def _close(got, want, tol=TOL):
    for g, w, name in zip(got, want, ("dr", "dk", "dv", "dw", "du")):
        g = np.asarray(g.float().numpy() if torch.is_tensor(g) else g,
                       np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1.0)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{name}: max err {err}, scale {scale}"


@pytest.mark.parametrize("with_dS", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bwd_ref_matches_jax_vjp(shape, with_dS):
    arrays, do, dS = _inputs(sum(shape), *shape)
    dS = dS if with_dS else None
    got = rwkv_scan_bwd_ref(*[torch.from_numpy(a) for a in arrays],
                            torch.from_numpy(do),
                            None if dS is None else torch.from_numpy(dS))
    _close(got, _jax_grads(arrays, do, dS))


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_bwd_ref_matches_torch_autograd(shape):
    arrays, do, dS = _inputs(sum(shape) + 1, *shape)
    got = rwkv_scan_bwd_ref(*[torch.from_numpy(a) for a in arrays],
                            torch.from_numpy(do), torch.from_numpy(dS))
    _close(got, _autograd(arrays, do, dS))


def test_bwd_ref_extreme_decay():
    """Decays of 1e-35 at 40 % of the entries: the walk back never divides
    by w, so every gradient is finite and matches the oracle's."""
    arrays, do, dS = _inputs(7, 1, 32, 2, 16, extreme=True)
    got = rwkv_scan_bwd_ref(*[torch.from_numpy(a) for a in arrays],
                            torch.from_numpy(do), torch.from_numpy(dS))
    _close(got, _jax_grads(arrays, do, dS))


def test_bwd_ref_bf16_inputs():
    """bf16 r/k/v/w/do give bf16 gradients (u's stay fp32) within a bf16
    rounding of the fp32 gradients of the same values."""
    arrays, do, dS = _inputs(11, 2, 24, 2, 16)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:4]]
    u = torch.from_numpy(arrays[4])
    dob = torch.from_numpy(do).to(torch.bfloat16)
    got = rwkv_scan_bwd_ref(*tb, u, dob, torch.from_numpy(dS))
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32]
    want = rwkv_scan_bwd_ref(*[t.float() for t in tb], u, dob.float(),
                             torch.from_numpy(dS))
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("with_dS", [True, False])
def test_autograd_function_on_cpu(with_dS):
    """The wrapper's autograd.Function on CPU tensors gives the plain
    backward's gradients, bit for bit, and launches nothing."""
    shape = SHAPES[0]
    arrays, do, dS = _inputs(3, *shape)
    dS = dS if with_dS else None
    reset_launch_counters()
    got = _autograd(arrays, do, dS, fn=rwkv_scan)
    want = rwkv_scan_bwd_ref(*[torch.from_numpy(a) for a in arrays],
                             torch.from_numpy(do),
                             None if dS is None else torch.from_numpy(dS))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    _close(got, _jax_grads(arrays, do, dS))
    assert all(c.count == 0 for c in launch_counters().values())


def test_autograd_function_only_final_state_used():
    """A loss on the final state alone leaves do missing: it counts as
    zero."""
    arrays, _, dS = _inputs(5, 1, 20, 2, 16)
    zero = np.zeros(arrays[0].shape, np.float32)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    _, S = rwkv_scan(*xs)
    got = torch.autograd.grad((S * torch.from_numpy(dS)).sum(), xs)
    _close(got, _jax_grads(arrays, zero, dS))


@pytest.mark.parametrize("b,s,H", [(4, 128, 40), (2, 13, 3), (1, 16, 2)])
def test_bwd_scratch_size(b, s, H):
    """One (64, 64) fp32 checkpoint per tile of TILE tokens after the
    first, a ragged last tile included: 18.4 MB at the training shape."""
    n = -(-s // rs_kernel.TILE) - 1
    assert rs_kernel.BWD_CHUNK == rs_kernel.TILE
    assert rs_kernel.bwd_scratch_floats(b, H, s) == b * H * n * 64 * 64


@pytest.mark.parametrize("with_dS", [True, False])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=str)
def test_bwd_chunked_ref_matches_jax_vjp(shape, with_dS):
    """The backward kernel's per-tile algebra (tiles of 16 tokens, the
    ragged last one padded; dw from G_out, S_in and dA without dividing by
    w) against the oracle's autodiff."""
    arrays, do, dS = _inputs(sum(shape) + 2, *shape)
    dS = dS if with_dS else None
    got = rwkv_scan_bwd_chunked_ref(
        *[torch.from_numpy(a) for a in arrays], torch.from_numpy(do),
        None if dS is None else torch.from_numpy(dS))
    assert [g.dtype for g in got] == [torch.float32] * 5
    _close(got, _jax_grads(arrays, do, dS))


@pytest.mark.parametrize("with_dS", [True, False])
@pytest.mark.parametrize("shape", [(1, 32, 2, 16), (2, 45, 2, 64)], ids=str)
def test_bwd_chunked_ref_extreme_decay(shape, with_dS):
    """Decays of 1e-35 at 40 % of the entries: the tile algebra forms
    every decay as a product, so every gradient is finite and matches the
    oracle's."""
    arrays, do, dS = _inputs(sum(shape) + 3, *shape, extreme=True)
    dS = dS if with_dS else None
    got = rwkv_scan_bwd_chunked_ref(
        *[torch.from_numpy(a) for a in arrays], torch.from_numpy(do),
        None if dS is None else torch.from_numpy(dS))
    _close(got, _jax_grads(arrays, do, dS))
