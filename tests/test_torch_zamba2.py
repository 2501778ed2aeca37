"""The port's zamba2 (hybrid family) against ``repro.models.zamba2`` on the
same numpy-seeded inputs and (bridged) parameters, at ``reduced()`` sizes
(5 Mamba2 blocks, the shared block after blocks 2 and 4, one tail block):
``_ssd_scan`` and ``_causal_conv`` in fp32 at 1e-5, ``forward`` logits in
fp32 at 3e-5 and, in bf16, each block at 3e-2 of its output's largest
magnitude (whole-model bf16 logits move by more than that in the reference
itself under a one-ulp input change),
``decode_step`` over six tokens with the whole state after them (with an
fp32 KV cache at 3e-5, with the default bf16 one at bf16 tolerances), the
port's
own decode-matches-forward check, ``init``'s structure, dtypes and scales,
and the reduced config of every arch the port has against the reference's.
The reference's init gives A_log = 0, D = 1, dt_bias = -2 and unit norms;
those are replaced by seeded values so that every path is exercised."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import zamba2 as jz
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models import layers, transformer
from repro_torch.models import zamba2 as tz
from repro_torch.models.registry import get_adapter

ARCH = "zamba2-1.2b"
SCAN_TOL = 1e-5                # tests/test_kernels.py's fp32 tolerance
TOL = 3e-5                     # tests/test_torch_transformer.py
BF16_TOL = 3e-2                # tests/test_kernels.py's bf16 tolerance
DECODE_VS_FORWARD_TOL = 0.15   # tests/test_models_smoke.py


def _seed(params: dict, rng) -> dict:
    """Replace init's constant leaves (A_log, D, dt_bias, the norms) by
    seeded values of the same shape and dtype."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("A_log", "D", "dt_bias") or k.endswith("norm"):
                mean, scale = {"A_log": (0.0, 0.5), "D": (1.0, 0.3),
                               "dt_bias": (-1.0, 0.5)}.get(k, (1.0, 0.1))
                out[k] = (mean + rng.standard_normal(v.shape) * scale
                          ).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(params)


def bridged(dtype: str = "float32", seed: int = 0, **over):
    """(jax cfg, port cfg, numpy params) for reduced zamba2-1.2b: the
    reference's init, then seeded SSM constants and norms."""
    jcfg = jax_reduced(JAX_ARCHS[ARCH], dtype=dtype, **over)
    cfg = reduced(ALL_ARCHS[ARCH], dtype=dtype, **over)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    return jcfg, cfg, _seed(params, np.random.default_rng(seed))


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_reduced_config_fields_equal_reference(arch):
    """Every field the port's config has equals the reference's, for the
    full config and the reduced one (the dense, MoE and rwkv6 reduced
    configs included: the hybrid case must not change them)."""
    for port, ref in ((ALL_ARCHS[arch], JAX_ARCHS[arch]),
                      (reduced(ALL_ARCHS[arch]), jax_reduced(JAX_ARCHS[arch]))):
        for f in dataclasses.fields(port):
            got, want = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (arch, f.name)
        assert port.resolved_head_dim == ref.resolved_head_dim


def test_reduced_zamba2_pattern():
    cfg = reduced(ALL_ARCHS[ARCH])
    assert (cfg.n_layers, cfg.shared_attn_every) == (5, 2)
    assert tz._pattern(cfg) == (2, 2) == jz._pattern(jax_reduced(
        JAX_ARCHS[ARCH]))
    assert tz._pattern(ALL_ARCHS[ARCH]) == (6, 6)
    assert (tz.inner_dim(cfg), tz.ssm_heads(cfg)) == (128, 8)


# --- the Mamba2 core --------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(1, tz.SCAN_CHUNK), (9, tz.SCAN_CHUNK),
                                     (9, 4)])
def test_ssd_scan_matches_jax(monkeypatch, s, chunk):
    """From a seeded nonzero state: y and the final state, fp32; with a
    chunk of 4 tokens the updates are formed in three chunks."""
    monkeypatch.setattr(tz, "SCAN_CHUNK", chunk)
    jcfg, cfg, params = bridged()
    bp = {k: v[1] for k, v in params["blocks"].items()}
    jbp, tbp = tree_map(jnp.asarray, bp), bridge.to_torch(bp, "cpu")
    rng = np.random.default_rng(2)
    b, din, N = 2, tz.inner_dim(cfg), cfg.ssm.state_dim
    nh, hd = tz.ssm_heads(cfg), cfg.ssm.head_dim
    xj, xt = _both(rng.standard_normal((b, s, din)).astype(np.float32))
    Bj, Bt = _both(rng.standard_normal((b, s, N)).astype(np.float32))
    Cj, Ct = _both(rng.standard_normal((b, s, N)).astype(np.float32))
    dj, dt = _both(rng.standard_normal((b, s, nh)).astype(np.float32))
    Hj, Ht = _both((rng.standard_normal((b, nh, hd, N)) * 0.5
                    ).astype(np.float32))
    jy, jH = jz._ssd_scan(jbp, jcfg, xj, Bj, Cj, dj, Hj)
    y, H = tz._ssd_scan(tbp, cfg, xt, Bt, Ct, dt, Ht)
    assert y.shape == (b, s, din) and y.dtype == torch.float32
    assert H is Ht and H.dtype == torch.float32      # updated in place
    _close(y, jy, SCAN_TOL)
    _close(H, jH, SCAN_TOL)


def test_ssd_scan_casts_y_back_to_bf16():
    jcfg, cfg, params = bridged("bfloat16")
    bp = bridge.to_torch({k: v[0] for k, v in params["blocks"].items()},
                         "cpu")
    rng = np.random.default_rng(3)
    din, N, nh = tz.inner_dim(cfg), cfg.ssm.state_dim, tz.ssm_heads(cfg)
    x = torch.from_numpy(rng.standard_normal((1, 4, din))).to(torch.bfloat16)
    B, C = (torch.from_numpy(rng.standard_normal((1, 4, N))).to(
        torch.bfloat16) for _ in range(2))
    dtr = torch.from_numpy(rng.standard_normal((1, 4, nh))).to(torch.bfloat16)
    H0 = torch.zeros((1, nh, cfg.ssm.head_dim, N))
    y, H = tz._ssd_scan(bp, cfg, x, B, C, dtr, H0)
    assert y.dtype == torch.bfloat16 and H.dtype == torch.float32


@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_jax(s):
    rng = np.random.default_rng(4)
    wj, wt = _both((rng.standard_normal((4, 160)) * 0.5).astype(np.float32))
    xj, xt = _both(rng.standard_normal((2, s, 160)).astype(np.float32))
    _close(tz._causal_conv(wt, xt), jz._causal_conv(wj, xj), SCAN_TOL)


# --- forward and decode -----------------------------------------------------

@pytest.mark.parametrize("s", [6, 13])
def test_forward_matches_jax(s):
    jcfg, cfg, params = bridged()
    toks = _tokens(cfg, 2, s)
    ref = jz.forward(tree_map(jnp.asarray, params), jcfg, jnp.asarray(toks))
    got = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                   {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == ref.shape == (2, s, cfg.vocab)
    _close(got, ref, TOL)


def _bf16_logits(params, jcfg, toks):
    return np.asarray(jz.forward(tree_map(jnp.asarray, params), jcfg,
                                 jnp.asarray(toks)), np.float32)


def test_forward_bf16_matches_jax_block_by_block():
    """bf16 rounds at the same places; the two packages sum in other
    orders (and the reference's CPU lowering expands silu's sigmoid in
    bf16 steps), so some values differ by an ulp. Each block (the five
    Mamba2 blocks and both shared applications) runs on the reference's
    bf16 input through both packages and is held to 3e-2 of its output's
    largest magnitude; the head likewise. Whole-model bf16 logits cannot
    be held to 3e-2 of the largest logit: the reference itself moves by
    more than that under a one-ulp input change
    (test_bf16_reference_moves_more_than_tol_under_one_ulp)."""
    jcfg, cfg, params = bridged("bfloat16")
    jp, tp = tree_map(jnp.asarray, params), bridge.to_torch(params, "cpu")
    toks = _tokens(cfg, 2, 11)
    s = toks.shape[1]
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), toks.shape)
    k, n_shared = tz._pattern(cfg)
    h = jp["embed"][jnp.asarray(toks)]

    def held(ref, got):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=BF16_TOL * np.abs(ref).max())

    def port(a):
        return bridge.to_torch({"a": np.asarray(a)}, "cpu")["a"]

    for i in range(cfg.n_layers):
        jbp = {n: v[i] for n, v in jp["blocks"].items()}
        tbp = {n: v[i] for n, v in tp["blocks"].items()}
        ref = jz._mamba_block_seq(jbp, jcfg, h)
        held(ref, tz._mamba_block_seq(tbp, cfg, port(h)))
        h = ref
        if i < n_shared * k and (i + 1) % k == 0:
            ref = jz._shared_block_seq(jp["shared"], jcfg, h,
                                       jnp.asarray(positions))
            held(ref, transformer._block_forward(
                cfg, port(h), tp["shared"],
                torch.from_numpy(positions.copy())))
            h = ref
    assert np.isfinite(_bf16_logits(params, jcfg, toks)).all()
    got = get_adapter(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())


def test_bf16_reference_moves_more_than_tol_under_one_ulp():
    """Why the bf16 forward is held block by block: reduced zamba2's
    reference logits move by more than 3e-2 of their largest magnitude
    when every embedding value moves by one bf16 ulp."""
    jcfg, cfg, params = bridged("bfloat16")
    toks = _tokens(cfg, 2, 11)
    ref = _bf16_logits(params, jcfg, toks)
    e = params["embed"]
    bumped = dict(params, embed=(e.view(np.uint16) + 1).view(e.dtype))
    moved = np.abs(_bf16_logits(bumped, jcfg, toks) - ref).max()
    assert moved > BF16_TOL * np.abs(ref).max()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values (8 significant bits) at |x|."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _decode_both(window, cache_dtype, steps=6, b=2, max_seq=16):
    """Steps of both packages from zero states on the same tokens; yields
    (pos, port logits, reference logits, port state, reference state)."""
    jcfg, cfg, params = bridged(sliding_window=window)
    jparams = tree_map(jnp.asarray, params)
    tparams = bridge.to_torch(params, "cpu")
    jstate = jz.init_state(jcfg, b, max_seq, dtype=jnp.dtype(cache_dtype))
    state = get_adapter(cfg).init_decode_state(
        b, max_seq, dtype=getattr(torch, cache_dtype), device="cpu")
    assert set(state) == set(jstate) == {"ssm", "conv", "k", "v"}
    for name, leaf in state.items():
        assert tuple(leaf.shape) == jstate[name].shape, name
        assert str(leaf.dtype).split(".")[1] == jstate[name].dtype.name
        assert not leaf.any()
    assert state["k"].shape[3] == (window or max_seq)
    jstep = jax.jit(lambda p, t, s, pos: jz.decode_step(p, jcfg, t, s, pos))
    rng = np.random.default_rng(5)
    for pos in range(steps):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jstep(jparams, jnp.asarray(tok), jstate,
                                jnp.asarray(pos, jnp.int32))
        logits, state = tz.decode_step(tparams, cfg, torch.from_numpy(tok),
                                       state, pos)
        assert logits.shape == (b, 1, cfg.vocab)
        yield pos, logits, jlogits, state, jstate


@pytest.mark.parametrize("window", [None, 4])
def test_decode_step_matches_jax(window):
    """Six tokens with an fp32 KV cache (both packages take a cache
    dtype): logits every step, the whole state (ssm, conv, k, v) after
    them. With a window of 4 the cache is a ring buffer of 4 slots that
    the last two tokens overwrite."""
    for _, logits, jlogits, state, jstate in _decode_both(window, "float32"):
        _close(logits, jlogits, TOL)
    for name in ("ssm", "conv", "k", "v"):
        _close(state[name], jstate[name], TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_step_bf16_cache_matches_jax(window):
    """The default bf16 KV cache, the one the port serves with. A K/V
    value that differs between the packages in its last fp32 bits may
    round to the neighbouring bf16 value, and logits read it afterwards
    (tests/test_torch_transformer.py). So, at every step: the greedy token
    is the same; the same cache rows are written; the first shared
    application's new K/V, from inputs that have read no cache, is within
    one bf16 ulp; every cache and state value within
    tests/test_kernels.py's bf16 decode tolerance (3e-2)."""
    for pos, logits, jlogits, state, jstate in _decode_both(window,
                                                            "bfloat16"):
        np.testing.assert_array_equal(
            logits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1),
            err_msg=f"pos {pos}")
        slot = pos % state["k"].shape[3]
        for name in ("k", "v"):
            got = state[name].float().numpy()
            ref = np.asarray(jstate[name], np.float32)
            np.testing.assert_array_equal(got.any(-1), ref.any(-1),
                                          err_msg=f"{name} rows, pos {pos}")
            g0, r0 = got[0, :, :, slot], ref[0, :, :, slot]
            assert np.all(np.abs(g0 - r0) <= _bf16_ulp(
                np.maximum(np.abs(g0), np.abs(r0)))), f"{name}, pos {pos}"
        for name in ("ssm", "conv", "k", "v"):
            np.testing.assert_allclose(
                state[name].float().numpy(),
                np.asarray(jstate[name], np.float32), rtol=BF16_TOL,
                atol=BF16_TOL, err_msg=f"{name}, pos {pos}")


def test_decode_step_products_go_through_the_kernel_wrappers(monkeypatch):
    """Every product of a step takes ``layers.rowstream_matmul`` (2 per
    Mamba2 block, 7 per shared application, the head) and every shared
    application ``layers.flash_decode``: the names chip_smoke.py's plain
    path patches."""
    _, cfg, params = bridged()
    calls = {"rowstream_matmul": 0, "flash_decode": 0}
    for name in calls:
        fn = getattr(layers, name)

        def spy(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(layers, name, spy)
    state = tz.init_state(cfg, 2, 8, device="cpu")
    tz.decode_step(bridge.to_torch(params, "cpu"), cfg,
                   torch.zeros((2, 1), dtype=torch.int64), state, 0)
    k, n_shared = tz._pattern(cfg)
    assert calls == {"rowstream_matmul": 2 * cfg.n_layers + 7 * n_shared + 1,
                     "flash_decode": n_shared}
    full = ALL_ARCHS[ARCH]
    assert 2 * full.n_layers + 7 * tz._pattern(full)[1] + 1 == 119


def test_decode_matches_forward_bf16():
    """tests/test_models_smoke.py's check on the port alone, in bf16:
    six tokens fed one by one through decode_step reproduce forward's
    logits, through both shared applications and the tail block."""
    cfg = reduced(ALL_ARCHS[ARCH])
    assert cfg.dtype == "bfloat16" and cfg.n_layers % cfg.shared_attn_every
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=0))
    full = ad.forward(params, {"tokens": toks}).float()
    state = ad.init_decode_state(1, 16, device="cpu")
    outs = []
    for t in range(6):
        lg, state = ad.decode(params, {"tokens": toks[:, t:t + 1]}, state, t)
        outs.append(lg[:, 0].float())
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=DECODE_VS_FORWARD_TOL,
                               atol=DECODE_VS_FORWARD_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_matches_jax_structure_and_scales(dtype):
    jcfg = jax_reduced(JAX_ARCHS[ARCH], d_model=128, dtype=dtype)
    cfg = reduced(ALL_ARCHS[ARCH], d_model=128, dtype=dtype)
    jp = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(0), tp=1))
    tp = bridge.to_numpy(get_adapter(cfg).init(
        torch.Generator().manual_seed(0)))

    def walk(j, t, path=""):
        assert set(j) == set(t), path
        for key in j:
            if isinstance(j[key], dict):
                walk(j[key], t[key], f"{path}/{key}")
                continue
            ja, ta = j[key], t[key]
            assert ja.shape == ta.shape, (path, key)
            jf = ja.astype(np.float32)
            if ja.dtype.name == "bfloat16":
                assert ta.dtype == np.uint16, (path, key)
                tf = (ta.astype(np.uint32) << 16).view(np.float32)
            else:
                assert ta.dtype == ja.dtype, (path, key)
                tf = ta
            if np.all(jf == jf.flat[0]):              # constants: equal
                np.testing.assert_array_equal(tf, jf, err_msg=key)
            else:                                     # draws: same scale
                assert abs(tf.std() / jf.std() - 1) < 0.1, (key, tf.std(),
                                                            jf.std())
                assert abs(tf.mean()) < 0.1 * jf.std(), key
    walk(jp, tp)
    for name in ("A_log", "D", "dt_bias"):
        assert tp["blocks"][name].dtype == np.float32
        assert tp["blocks"][name].shape == (cfg.n_layers, tz.ssm_heads(cfg))
