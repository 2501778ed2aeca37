"""The port's mllama (vlm family) against ``repro.models.mllama`` on the
same numpy-seeded inputs and (bridged) parameters, at ``reduced()`` sizes
(4 layers: two units of one self and one cross layer, d_model 64, 4 query
/ 2 KV heads of 16, 16 vision tokens): ``forward`` logits in fp32 at 3e-5
(the earlier slices' fp32 forward tolerance) and, in bf16, each self and
cross layer at 3e-2 of its output's largest magnitude;
``precompute_cross_kv`` at 1e-5; ``decode_step`` over four tokens with the
cross KV filled from the vision embeddings, with an fp32 cache at 3e-5 and
with the default bf16 one at 3e-2 (the reference rounds the cross
probabilities to the cache's dtype, the port's flash decode does not); and
decode against forward over six tokens within 0.15 (the reference tests
this only for qwen2, rwkv6 and zamba2: its driver never fills the cross
KV). The reference's init gives zero gates, which make every cross layer
the identity, and unit norms; the gates are set to seeded values in
[0.5, 1.0] and the norms perturbed first."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import mllama as jm
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models import mllama as tm
from repro_torch.models import transformer

ARCH = "llama-3.2-vision-90b"
LAYER_TOL = 1e-5               # tests/test_kernels.py's fp32 tolerance
TOL = 3e-5                     # tests/test_torch_transformer.py
BF16_TOL = 3e-2                # tests/test_kernels.py's bf16 tolerance
DECODE_VS_FORWARD_TOL = 0.15   # tests/test_models_smoke.py


def _seed(params: dict, rng) -> dict:
    """Gates U(0.5, 1.0) (fp32, stacked per unit), norms 1 + N(0, 0.1)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.startswith("gate_"):
                out[k] = rng.uniform(0.5, 1.0, v.shape).astype(v.dtype)
            elif k.endswith("norm"):
                out[k] = (1 + rng.standard_normal(v.shape) * 0.1
                          ).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(params)


def bridged(dtype: str = "float32", seed: int = 0):
    """(jax cfg, port cfg, numpy params) for reduced llama-3.2-vision: the
    reference's init, then seeded gates and norms."""
    jcfg = jax_reduced(JAX_ARCHS[ARCH], dtype=dtype)
    cfg = reduced(ALL_ARCHS[ARCH], dtype=dtype)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    return jcfg, cfg, _seed(params, np.random.default_rng(seed))


def _both(x: np.ndarray, dtype):
    j = jnp.asarray(x).astype(dtype)
    return j, bridge.to_torch(np.asarray(j), "cpu")


def _vision(cfg, b, dtype, seed=2):
    return _both(np.random.default_rng(seed).standard_normal(
        (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32), dtype)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol)


def _held(port, ref, tol=BF16_TOL):
    """Max |port - ref| within `tol` of the largest |ref|, in the
    reference's dtype (the gate is cast before it multiplies, so the
    residual stream stays bf16)."""
    assert str(port.dtype).removeprefix("torch.") == str(ref.dtype)
    p, r = _f32(port), _f32(ref)
    assert np.abs(p - r).max() <= tol * np.abs(r).max()


def test_seeded_gates_are_stacked_fp32_and_nonzero():
    _, cfg, np_params = bridged("bfloat16")
    tp = bridge.to_torch(np_params, "cpu")
    for g in ("gate_attn", "gate_ffn"):
        gate = tp["cross_blocks"][g]
        assert gate.dtype == torch.float32 and gate.shape == (2,)
        assert bool((gate >= 0.5).all())
        np.testing.assert_array_equal(gate.numpy(),
                                      np_params["cross_blocks"][g])


def test_forward_matches_jax_fp32():
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    vj, vt = _vision(cfg, 2, jnp.float32)
    toks = _tokens(cfg, 2, 7)
    got = tm.forward(tp, cfg, torch.from_numpy(toks).long(), vt)
    want = jm.forward(jp, jcfg, jnp.asarray(toks), vj)
    assert got.shape == (2, 7, 256)
    _close(got, want, TOL)


def test_layers_match_jax_bf16():
    """Each self layer and each cross layer on the same bf16 input."""
    jcfg, cfg, np_params = bridged("bfloat16")
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    vj, vt = _vision(cfg, 2, jnp.bfloat16)
    hj, ht = _both(np.random.default_rng(3).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32), jnp.bfloat16)
    pj = jnp.broadcast_to(jnp.arange(7, dtype=jnp.int32), (2, 7))
    pt = torch.arange(7, dtype=torch.int32).expand(2, 7)
    for i in range(2):
        sj = tree_map(lambda x: x[i], jp["self_blocks"])
        _held(transformer._block_forward(cfg, ht,
                                         tm._index(tp["self_blocks"], i), pt),
              jm._self_fwd(jcfg, hj, sj, pj))
        cj = tree_map(lambda x: x[i], jp["cross_blocks"])
        _held(tm._cross_fwd(cfg, ht, tm._index(tp["cross_blocks"], i), vt),
              jm._cross_fwd(jcfg, hj, cj, vj))


def test_precompute_cross_kv_matches_jax():
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    vj, vt = _vision(cfg, 2, jnp.float32)
    (xkj, xvj), (xkt, xvt) = (jm.precompute_cross_kv(jp, jcfg, vj),
                              tm.precompute_cross_kv(tp, cfg, vt))
    assert xkt.shape == (2, 2, cfg.n_kv_heads, cfg.n_vision_tokens,
                         cfg.resolved_head_dim)
    _close(xkt, xkj, LAYER_TOL)
    _close(xvt, xvj, LAYER_TOL)


@pytest.mark.parametrize("cache_dtype,tol", [("float32", TOL),
                                             ("bfloat16", BF16_TOL)])
def test_decode_step_with_cross_kv_matches_jax(cache_dtype, tol):
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    vj, vt = _vision(cfg, 2, jnp.float32)
    jcache = jm.init_cache(jcfg, 2, 16, dtype=getattr(jnp, cache_dtype))
    tcache = tm.init_cache(cfg, 2, 16, dtype=getattr(torch, cache_dtype),
                           device="cpu")
    xkj, xvj = jm.precompute_cross_kv(jp, jcfg, vj)
    jcache["xk"] = xkj.astype(jcache["xk"].dtype)
    jcache["xv"] = xvj.astype(jcache["xv"].dtype)
    xkt, xvt = tm.precompute_cross_kv(tp, cfg, vt)
    tcache["xk"].copy_(xkt)
    tcache["xv"].copy_(xvt)
    toks = _tokens(cfg, 2, 4, seed=5)
    for pos in range(4):
        lj, jcache = jm.decode_step(jp, jcfg, jnp.asarray(toks[:, pos:pos + 1]),
                                    jcache, jnp.asarray(pos, jnp.int32))
        lt, tcache = tm.decode_step(tp, cfg,
                                    torch.from_numpy(toks[:, pos:pos + 1]),
                                    tcache, pos)
        assert lt.shape == (2, 1, 256)
        _close(lt, lj, tol)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], tol)


def test_decode_matches_forward():
    """Six tokens one by one through decode_step, the cross KV filled from
    the same vision embeddings and an fp32 cache, against forward's
    logits."""
    _, cfg, np_params = bridged()
    tp = bridge.to_torch(np_params, "cpu")
    _, vt = _vision(cfg, 1, jnp.float32)
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=4))
    full = tm.forward(tp, cfg, toks, vt)
    cache = tm.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    xk, xv = tm.precompute_cross_kv(tp, cfg, vt)
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    outs = []
    for t in range(6):
        lg, cache = tm.decode_step(tp, cfg, toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=DECODE_VS_FORWARD_TOL,
                               atol=DECODE_VS_FORWARD_TOL)
