"""The port's whisper (audio family) against ``repro.models.whisper`` on the
same numpy-seeded inputs and (bridged) parameters, at ``reduced()`` sizes
(2 encoder and 2 decoder layers, d_model 64, 4 heads of 16, 16 frames):
``sinusoid_pos`` at 1e-5, ``encode`` and ``forward`` logits in fp32 at
3e-5 (the earlier slices' fp32 forward tolerance) and, in bf16, each
encoder and decoder block at 3e-2 of its output's largest magnitude;
``precompute_cross_kv`` at 1e-5; ``decode_step`` over four tokens with
the cross KV filled from the encoder output, with an fp32 cache at 3e-5
and with the default bf16 one at 3e-2 (the reference rounds the cross
probabilities to the cache's dtype, the port's flash decode does not);
decode against forward over six tokens within 0.15 (the reference tests
this only for qwen2, rwkv6 and zamba2: its driver never fills the cross
KV); and the tied head, made once and equal to ``embed.T`` bit for bit.
The reference's init gives zero biases and LayerNorm shifts and unit
scales; those are replaced by seeded values first, so that the bias and
shift order is exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import layers as jl
from repro.models import whisper as jw
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models import layers as tl
from repro_torch.models import whisper as tw
from repro_torch.models.registry import get_adapter

ARCH = "whisper-small"
LAYER_TOL = 1e-5               # tests/test_kernels.py's fp32 tolerance
TOL = 3e-5                     # tests/test_torch_transformer.py
BF16_TOL = 3e-2                # tests/test_kernels.py's bf16 tolerance
DECODE_VS_FORWARD_TOL = 0.15   # tests/test_models_smoke.py


def _seed(params: dict, rng) -> dict:
    """Biases and LayerNorm shifts N(0, 0.02), LayerNorm scales
    1 + N(0, 0.1), in each leaf's dtype."""
    def walk(tree, ln=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k.startswith("ln_"))
            elif ln and k == "w":
                out[k] = (1 + rng.standard_normal(v.shape) * 0.1
                          ).astype(v.dtype)
            elif k.startswith("b") or ln:
                out[k] = (rng.standard_normal(v.shape) * 0.02).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(params)


def bridged(dtype: str = "float32", seed: int = 0):
    """(jax cfg, port cfg, numpy params) for reduced whisper-small: the
    reference's init, then seeded biases and LayerNorms."""
    jcfg = jax_reduced(JAX_ARCHS[ARCH], dtype=dtype)
    cfg = reduced(ALL_ARCHS[ARCH], dtype=dtype)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    return jcfg, cfg, _seed(params, np.random.default_rng(seed))


def _frames(cfg, b, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), bridge.to_torch(
        np.asarray(jnp.asarray(x).astype(dtype)), "cpu")


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
    reference's dtype."""
    assert str(port.dtype).removeprefix("torch.") == str(ref.dtype)
    p, r = _f32(port), _f32(ref)
    assert np.abs(p - r).max() <= tol * np.abs(r).max()


def test_sinusoid_pos_matches_jax():
    pos = np.arange(64, dtype=np.int32).reshape(2, 32)
    _close(tw.sinusoid_pos(torch.from_numpy(pos), 768),
           jw.sinusoid_pos(jnp.asarray(pos), 768), LAYER_TOL)


def test_encode_and_forward_match_jax_fp32():
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    fj, ft = _frames(cfg, 2, jnp.float32)
    _close(tw.encode(tp, cfg, ft), jw.encode(jp, jcfg, fj), TOL)
    toks = _tokens(cfg, 2, 7)
    got = tw.forward(tp, cfg, torch.from_numpy(toks).long(), ft)
    want = jw.forward(jp, jcfg, jnp.asarray(toks), fj)
    assert got.shape == (2, 7, 256)
    _close(got, want, TOL)


def test_blocks_match_jax_bf16():
    """Each encoder and decoder block on the same bf16 input, and the
    encoder output given to each decoder block."""
    jcfg, cfg, np_params = bridged("bfloat16")
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    fj, ft = _frames(cfg, 2, jnp.bfloat16)
    for i in range(cfg.encoder_layers):
        bj = tree_map(lambda x: x[i], jp["encoder"])
        bt = tw._index(tp["encoder"], i)
        _held(tw._enc_block(cfg, ft, bt), jw._enc_block(jcfg, fj, bj))
    enc_j, enc_t = fj * 0.5, ft * 0.5
    h = np.random.default_rng(3).standard_normal((2, 7, cfg.d_model))
    hj = jnp.asarray(h, jnp.bfloat16)
    ht = bridge.to_torch(np.asarray(hj), "cpu")
    mj, mt = jl.causal_mask(7, 7), tl.causal_mask(7, 7)
    for i in range(cfg.n_layers):
        bj = tree_map(lambda x: x[i], jp["decoder"])
        bt = tw._index(tp["decoder"], i)
        _held(tw._dec_block(cfg, ht, bt, enc_t, mt),
              jw._dec_block(jcfg, hj, bj, enc_j, mj))


def test_precompute_cross_kv_matches_jax():
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    fj, ft = _frames(cfg, 2, jnp.float32)
    (xkj, xvj), (xkt, xvt) = (jw.precompute_cross_kv(jp, jcfg, fj),
                              tw.precompute_cross_kv(tp, cfg, ft))
    assert xkt.shape == (cfg.n_layers, 2, cfg.n_heads, cfg.n_audio_frames,
                         cfg.resolved_head_dim)
    _close(xkt, xkj, LAYER_TOL)
    _close(xvt, xvj, LAYER_TOL)


def _filled(jp, tp, jcfg, cfg, fj, ft, b, cache_dtype):
    """Both packages' decode caches with the cross KV of the encoder
    output written in, in the cache's dtype."""
    jcache = jw.init_cache(jcfg, b, 16, dtype=getattr(jnp, cache_dtype))
    tcache = tw.init_cache(cfg, b, 16, dtype=getattr(torch, cache_dtype),
                           device="cpu")
    xkj, xvj = jw.precompute_cross_kv(jp, jcfg, jw.encode(jp, jcfg, fj))
    jcache["xk"] = xkj.astype(jcache["xk"].dtype)
    jcache["xv"] = xvj.astype(jcache["xv"].dtype)
    xkt, xvt = tw.precompute_cross_kv(tp, cfg, tw.encode(tp, cfg, ft))
    tcache["xk"].copy_(xkt)
    tcache["xv"].copy_(xvt)
    return jcache, tcache


@pytest.mark.parametrize("cache_dtype,tol", [("float32", TOL),
                                             ("bfloat16", BF16_TOL)])
def test_decode_step_with_cross_kv_matches_jax(cache_dtype, tol):
    jcfg, cfg, np_params = bridged()
    jp, tp = tree_map(jnp.asarray, np_params), bridge.to_torch(np_params,
                                                              "cpu")
    fj, ft = _frames(cfg, 2, jnp.float32)
    jcache, tcache = _filled(jp, tp, jcfg, cfg, fj, ft, 2, cache_dtype)
    toks = _tokens(cfg, 2, 4, seed=5)
    for pos in range(4):
        lj, jcache = jw.decode_step(jp, jcfg, jnp.asarray(toks[:, pos:pos + 1]),
                                    jcache, jnp.asarray(pos, jnp.int32))
        lt, tcache = tw.decode_step(tp, cfg,
                                    torch.from_numpy(toks[:, pos:pos + 1]),
                                    tcache, pos)
        assert lt.shape == (2, 1, 256)
        _close(lt, lj, tol)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], tol)
    assert bool(tcache["xk"].any())


def test_decode_matches_forward():
    """Six tokens one by one through decode_step, the cross KV filled from
    the same frames and an fp32 cache, against forward's logits."""
    _, cfg, np_params = bridged()
    tp = bridge.to_torch(np_params, "cpu")
    _, ft = _frames(cfg, 1, jnp.float32)
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=4))
    full = tw.forward(tp, cfg, toks, ft)
    cache = tw.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    xk, xv = tw.precompute_cross_kv(tp, cfg, tw.encode(tp, cfg, ft))
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    outs = []
    for t in range(6):
        lg, cache = tw.decode_step(tp, cfg, toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=DECODE_VS_FORWARD_TOL,
                               atol=DECODE_VS_FORWARD_TOL)


def test_tied_head_made_once_and_equal_to_embed_transposed():
    _, cfg, np_params = bridged("bfloat16")
    tp = bridge.to_torch(np_params, "cpu")
    cache = get_adapter(cfg).init_decode_state(2, 16, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int32)
    tw.decode_step(tp, cfg, tok, cache, 0)
    head = tw.tied_head(tp["embed"])
    tw.decode_step(tp, cfg, tok, cache, 1)
    assert tw.tied_head(tp["embed"]) is head
    assert head.is_contiguous() and head.shape == (cfg.d_model, 256)
    assert torch.equal(head.view(torch.int16),
                       tp["embed"].T.contiguous().view(torch.int16))
    tp["embed"].mul_(2)           # an in-place change makes a new head
    assert torch.equal(tw.tied_head(tp["embed"]), tp["embed"].T)


def test_tied_head_refuses_an_inference_tensor():
    """An inference tensor has no version counter, so an in-place change
    of the embedding could not be seen: the head refuses it."""
    with torch.inference_mode():
        embed = torch.ones((8, 4))
    with pytest.raises(ValueError, match="inference tensor"):
        tw.tied_head(embed)
