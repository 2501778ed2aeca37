"""The port's dense prefill path against ``repro.models``: the masks and
attention functions of ``layers`` on numpy-seeded inputs, and the whole
``forward`` on the reference's (bridged) parameters for the four reduced
dense configs, in fp32 at 3e-5 (tests/test_torch_transformer.py) and in
bf16 at 3e-2 of the largest reference logit. h2o-danube runs past its
reduced window of 32, so the window bites. Also the port's own
decode-matches-forward check (tests/test_models_smoke.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.kernels import launch_counters, reset_launch_counters
from repro_torch.models import layers as tl
from repro_torch.models.registry import get_adapter

TOL = 3e-5                     # tests/test_torch_transformer.py
BF16_TOL = 3e-2                # tests/test_kernels.py's bf16 tolerance
DECODE_VS_FORWARD_TOL = 0.15   # tests/test_models_smoke.py
DENSE = ["qwen2-7b", "qwen3-14b", "minitron-8b", "h2o-danube-1.8b"]


def _seed_biases_and_norms(params: dict, rng) -> dict:
    """Replace init's zero biases and unit norms by seeded values."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bk", "bv"):
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
            elif k.endswith("norm"):
                out[k] = (1 + rng.standard_normal(v.shape) * 0.1
                          ).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(params)


def bridged_params(arch: str, dtype: str = "float32", seed: int = 0):
    """(jax cfg, port cfg, numpy params) for reduced `arch`: the
    reference's init, then seeded biases and norms."""
    jcfg = jax_reduced(JAX_ARCHS[arch], dtype=dtype)
    cfg = reduced(ALL_ARCHS[arch], dtype=dtype)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    return jcfg, cfg, _seed_biases_and_norms(params,
                                             np.random.default_rng(seed))


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _qkv(rng, b, h, s, d, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s_kv, d)).astype(np.float32),
            rng.standard_normal((b, h, s_kv, d)).astype(np.float32))


# --- masks and attention --------------------------------------------------

@pytest.mark.parametrize("q_len,kv_len,window",
                         [(7, 7, None), (5, 12, None), (40, 40, 8),
                          (3, 20, 6), (1, 9, None)])
def test_causal_mask_matches_jax(q_len, kv_len, window):
    got = tl.causal_mask(q_len, kv_len, window)
    ref = np.asarray(jl.causal_mask(q_len, kv_len, window))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_rep", [1, 2, 3])
def test_repeat_kv_matches_jax(n_rep):
    x = np.random.default_rng(n_rep).standard_normal(
        (2, 3, 5, 4)).astype(np.float32)
    xj, xt = _both(x)
    np.testing.assert_array_equal(tl.repeat_kv(xt, n_rep).numpy(),
                                  np.asarray(jl.repeat_kv(xj, n_rep)))


@pytest.mark.parametrize("s_q,s_kv,window,masked",
                         [(9, 9, None, True), (9, 9, 4, True),
                          (4, 11, None, True), (6, 6, None, False)])
def test_attention_scores_matches_jax(s_q, s_kv, window, masked):
    rng = np.random.default_rng(s_q + s_kv)
    q, k, v = _qkv(rng, 2, 3, s_q, 16, s_kv)
    mask = np.array(jl.causal_mask(s_q, s_kv, window)) if masked else None
    ref = jl.attention_scores(*map(jnp.asarray, (q, k, v)),
                              None if mask is None else jnp.asarray(mask))
    got = tl.attention_scores(*map(torch.from_numpy, (q, k, v)),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_attention_scores_bf16_casts_probs_to_v_dtype():
    """bf16 in, bf16 out; the probabilities are rounded to bf16 before
    the second product, as in the reference."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 2, 12, 16)
    mask = np.array(jl.causal_mask(12, 12, None))
    ref = np.asarray(jl.attention_scores(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(mask)), np.float32)
    got = tl.attention_scores(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=BF16_TOL * np.abs(ref).max())


@pytest.mark.parametrize("s,q_chunk,kv_chunk,window",
                         [(37, 8, 8, None), (37, 16, 8, None),
                          (37, 8, 16, 5), (50, 12, 7, 20), (5, 8, 8, None)])
def test_chunked_attention_matches_jax_and_full_attention(s, q_chunk,
                                                          kv_chunk, window):
    """Ragged s against both packages' chunked and full attention."""
    rng = np.random.default_rng(s + q_chunk)
    q, k, v = _qkv(rng, 2, 3, s, 16)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = tl.chunked_attention(qt, kt, vt, window, q_chunk, kv_chunk).numpy()
    mask = jl.causal_mask(s, s, window)
    refs = {
        "jax chunked": jl.chunked_attention(qj, kj, vj, window, q_chunk,
                                            kv_chunk),
        "jax full": jl.attention_scores(qj, kj, vj, mask),
        "port full": tl.attention_scores(qt, kt, vt,
                                         torch.from_numpy(np.array(mask))),
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_self_attention_switches_to_chunked_at_threshold(monkeypatch):
    """At CHUNKED_ATTN_THRESHOLD tokens self_attention takes the chunked
    path (here made small, with small chunks) and still matches the
    reference's full attention."""
    jcfg, cfg, params = bridged_params("h2o-danube-1.8b")
    p = params["blocks"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    s = 40
    x = np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    ref = jl.self_attention(tree_map(jnp.asarray, p), jnp.asarray(x), jcfg,
                            jnp.asarray(positions))
    calls = []
    small = functools.partial(tl.chunked_attention, q_chunk=16, kv_chunk=8)

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return small(*args, **kwargs)

    monkeypatch.setattr(tl, "CHUNKED_ATTN_THRESHOLD", s)
    monkeypatch.setattr(tl, "chunked_attention", spy)
    got = tl.self_attention(bridge.to_torch(p, "cpu"), torch.from_numpy(x),
                            cfg, torch.from_numpy(positions.copy()))
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


# --- forward --------------------------------------------------------------

def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, cfg, params = bridged_params(arch)
    s = 45 if cfg.sliding_window else 12
    assert not cfg.sliding_window or s > cfg.sliding_window
    toks = _tokens(cfg, 2, s)
    ref = jt.forward(tree_map(jnp.asarray, params), jcfg, jnp.asarray(toks))
    reset_launch_counters()
    got = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                   {"tokens": torch.from_numpy(toks)})
    assert all(c.count == 0 for c in launch_counters().values())
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_bf16_matches_jax(arch):
    """bf16 rounds at the same places; the two packages sum in other
    orders, so logits are held to 3e-2 of the largest reference logit."""
    jcfg, cfg, params = bridged_params(arch, "bfloat16")
    s = 45 if cfg.sliding_window else 12
    toks = _tokens(cfg, 2, s)
    ref = np.asarray(jt.forward(tree_map(jnp.asarray, params), jcfg,
                                jnp.asarray(toks)), np.float32)
    got = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                   {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=BF16_TOL * np.abs(ref).max())


def test_sliding_window_bites_in_forward():
    """h2o-danube beyond its window: the logits past the window differ
    from those of the same model without one (so the window is applied),
    and those within it do not."""
    jcfg, cfg, params = bridged_params("h2o-danube-1.8b")
    toks = torch.from_numpy(_tokens(cfg, 1, 45))
    tp = bridge.to_torch(params, "cpu")
    windowed = get_adapter(cfg).forward(tp, {"tokens": toks})
    full = get_adapter(reduced(ALL_ARCHS["h2o-danube-1.8b"], dtype="float32",
                               sliding_window=None)).forward(
        tp, {"tokens": toks})
    w = cfg.sliding_window
    torch.testing.assert_close(windowed[:, :w], full[:, :w], rtol=TOL,
                               atol=TOL)
    assert (windowed[:, w:] - full[:, w:]).abs().max() > 1e-3


def test_decode_matches_forward_qwen2():
    """tests/test_models_smoke.py's check in the port: six tokens fed one
    by one through decode reproduce the bf16 forward's logits."""
    cfg = reduced(ALL_ARCHS["qwen2-7b"])
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=0))
    full = ad.forward(params, {"tokens": toks}).float()
    state = ad.init_decode_state(1, 16, device="cpu")
    outs = []
    for t in range(6):
        lg, state = ad.decode(params, {"tokens": toks[:, t:t + 1]}, state, t)
        outs.append(lg[:, 0].float())
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(full.numpy(), dec.numpy(),
                               rtol=DECODE_VS_FORWARD_TOL,
                               atol=DECODE_VS_FORWARD_TOL)
