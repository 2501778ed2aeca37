"""The port's decode-path layers against ``repro.models.layers`` in fp32,
on the same numpy-seeded inputs, at tests/test_layers.py's tolerances;
layernorm, the GELU MLP, cross-attention (its q-block path included) and
the cross decode attention through flash decode at tests/test_kernels.py's
fp32 tolerance, 1e-5 (a bf16 cross cache at its bf16 one, 3e-2).
Biases and norm weights are seeded values, not the zeros and ones init
gives, so those paths are exercised."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import layers as jl
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models import layers as tl

TOL = 2e-5
LAYER_TOL = 1e-5


def _cfgs(arch):
    return (jax_reduced(JAX_ARCHS[arch], dtype="float32"),
            reduced(ALL_ARCHS[arch], dtype="float32"))


def _both(tree):
    """numpy tree -> (jnp tree, torch tree) with the same values."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree.copy())


def _attn_params(rng, cfg) -> dict:
    hd, d = cfg.resolved_head_dim, cfg.d_model
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"wq": w(d, nq), "wk": w(d, nkv), "wv": w(d, nkv), "wo": w(nq, d)}
    if cfg.qkv_bias:
        p |= {"bq": w(nq, scale=0.1), "bk": w(nkv, scale=0.1),
              "bv": w(nkv, scale=0.1)}
    if cfg.qk_norm:
        p |= {"q_norm": 1 + w(hd, scale=0.1), "k_norm": 1 + w(hd, scale=0.1)}
    return p


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = _both(rng.standard_normal((3, 5, 64),
                                                   np.float32) * 3), \
        _both(1 + rng.standard_normal(64).astype(np.float32) * 0.1)
    _close(tl.rmsnorm(xt, wt, 1e-6), jl.rmsnorm(xj, wj, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 3, 7, 16), np.float32))
    posj, post = _both(rng.integers(0, 500, (2, 1, 7)).astype(np.int32))
    _close(tl.rope_frequencies(16, theta), jl.rope_frequencies(16, theta))
    _close(tl.apply_rope(xt, post, theta), jl.apply_rope(xj, posj, theta))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "minitron-8b"])
def test_gqa_project_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    pj, pt = _both(_attn_params(rng, cfg))
    xj, xt = _both(rng.standard_normal((2, 3, cfg.d_model), np.float32))
    for port, ref in zip(tl.gqa_project(pt, xt, cfg),
                         jl.gqa_project(pj, xj, jcfg)):
        assert tuple(port.shape) == ref.shape
        _close(port, ref)


@pytest.mark.parametrize("arch,pos,slot", [("qwen2-7b", 0, 0),
                                           ("qwen3-14b", 9, 9),
                                           ("h2o-danube-1.8b", 40, 8),
                                           ("qwen2-7b", 20, 20)])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(arch, pos, slot, cache_dtype):
    """Output and the written caches; slot 20 lies past S = 16 and is not
    written (the reference's masked write)."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(pos)
    pj, pt = _both(_attn_params(rng, cfg))
    b, S, hd = 2, 16, cfg.resolved_head_dim
    xj, xt = _both(rng.standard_normal((b, 1, cfg.d_model), np.float32))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    shape = (b, cfg.n_kv_heads, S, hd)
    k0 = rng.standard_normal(shape, np.float32)
    v0 = rng.standard_normal(shape, np.float32)
    kt, vt = (torch.from_numpy(a).to(tdt) for a in (k0, v0))
    out = tl.decode_attention(pt, xt, cfg, kt, vt, pos, slot)
    ref, kj, vj = jl.decode_attention(
        pj, xj, jcfg, jnp.asarray(k0, jdt), jnp.asarray(v0, jdt),
        jnp.array(pos, jnp.int32), jnp.array(slot, jnp.int32))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    _close(out, ref)
    _close(kt.float(), np.asarray(kj, np.float32))
    _close(vt.float(), np.asarray(vj, np.float32))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    d, f = 64, 128
    pj, pt = _both({
        "w_gate": (rng.standard_normal((d, f)) / 8).astype(np.float32),
        "w_up": (rng.standard_normal((d, f)) / 8).astype(np.float32),
        "w_down": (rng.standard_normal((f, d)) / 11).astype(np.float32)})
    xj, xt = _both(rng.standard_normal((2, 1, d), np.float32))
    _close(tl.swiglu(pt, xt), jl.swiglu(pj, xj))


def test_layernorm_matches_jax():
    rng = np.random.default_rng(4)
    xj, xt = _both((rng.standard_normal((3, 5, 64)) * 3 + 1.5
                    ).astype(np.float32))
    (wj, wt), (bj, bt) = (
        _both((1 + rng.standard_normal(64) * 0.1).astype(np.float32)),
        _both((rng.standard_normal(64) * 0.1).astype(np.float32)))
    _close(tl.layernorm(xt, wt, bt, 1e-5), jl.layernorm(xj, wj, bj, 1e-5),
           LAYER_TOL)


def test_gelu_mlp_matches_jax_with_tanh_gelu():
    rng = np.random.default_rng(5)
    d, f = 64, 128
    pj, pt = _both({
        "w_up": (rng.standard_normal((d, f)) / 8).astype(np.float32),
        "b_up": (rng.standard_normal(f) * 0.1).astype(np.float32),
        "w_down": (rng.standard_normal((f, d)) / 11).astype(np.float32),
        "b_down": (rng.standard_normal(d) * 0.1).astype(np.float32)})
    xj, xt = _both(rng.standard_normal((2, 3, d), np.float32) * 2)
    _close(tl.gelu_mlp(pt, xt, torch.matmul), jl.gelu_mlp(pj, xj),
           LAYER_TOL)
    _close(tl.gelu_mlp(pt, xt), jl.gelu_mlp(pj, xj), LAYER_TOL)


@pytest.mark.parametrize("arch,s", [("llama-3.2-vision-90b", 7),
                                    ("qwen3-14b", 5),
                                    ("llama-3.2-vision-90b", 8192 + 100)])
def test_cross_attention_matches_jax(arch, s):
    """qwen3-14b's config exercises the qk_norm branch; a query length of
    8292 takes the q-block path, its last block padded."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(s)
    pj, pt = _both(_attn_params(rng, cfg))
    xj, xt = _both(rng.standard_normal((1, s, cfg.d_model), np.float32))
    kvj, kvt = _both(rng.standard_normal((1, 16, cfg.d_model), np.float32))
    out = tl.cross_attention(pt, xt, kvt, cfg)
    ref = jl.cross_attention(pj, xj, kvj, jcfg)
    assert tuple(out.shape) == ref.shape == (1, s, cfg.d_model)
    _close(out, ref, LAYER_TOL)


@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    ("float32", "float32", LAYER_TOL), ("float32", "bfloat16", 3e-2),
    ("bfloat16", "bfloat16", 3e-2)])
def test_cross_decode_attention_matches_attention_scores(q_dtype, kv_dtype,
                                                         tol):
    """Flash decode at pos = S - 1 against the reference's cross decode
    (``attention_scores`` over the KV heads repeated), S not a multiple of
    a 4 KB row's tokens. The reference rounds the probabilities to the
    cache's dtype before the second product; the port does not."""
    rng = np.random.default_rng(6)
    b, h, hkv, S, hd = 2, 4, 2, 37, 16
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    kv = rng.standard_normal((2, b, hkv, S, hd)).astype(np.float32)
    qj = jnp.asarray(q, getattr(jnp, q_dtype))
    kj, vj = (jnp.asarray(x, getattr(jnp, kv_dtype)) for x in kv)
    ref = jl.attention_scores(qj, jl.repeat_kv(kj, 2), jl.repeat_kv(vj, 2),
                              None)
    qt = torch.from_numpy(q).to(getattr(torch, q_dtype))
    kt, vt = (torch.from_numpy(x).to(getattr(torch, kv_dtype)) for x in kv)
    out = tl.cross_decode_attention(qt, kt, vt)
    assert out.dtype == qt.dtype and tuple(out.shape) == ref.shape
    _close(out.float(), np.asarray(ref, np.float32), tol)


def test_dense_init_distribution():
    """normal / sqrt(fan_in), drawn in fp32 and cast, on the generator's
    device."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (400, 300), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert abs(w.float().std().item() * 20 - 1) < 0.02
    assert abs(w.float().mean().item()) < 2e-3
