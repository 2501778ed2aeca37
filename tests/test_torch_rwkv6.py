"""The port's rwkv6 against ``repro.models.rwkv6`` in fp32 on the same
(bridged) parameters: the mixing functions and several ``decode_step``s at
2e-5, ``forward`` logits at FORWARD_TOL, for reduced rwkv6-3b with one head
(d_model 64) and with two (d_model 128). The reference's init gives u = 0,
w0 = -5, mixes of 0.5 and unit norms; those are replaced by seeded values
so that every path is exercised. Also the port's own decode-matches-forward
check in bf16, ``init`` against the reference's, and the adapter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import rwkv6 as jr
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.kernels import launch_counters, reset_launch_counters
from repro_torch.models import rwkv6 as tr
from repro_torch.models.registry import get_adapter

TOL = 2e-5
# forward against the reference, from a zero state: a one-ulp change of the
# input moves reduced rwkv6's logits by up to 4.2e-5 (see
# test_decode_step_matches_jax), so 1e-4, inside tests/test_kernels.py's
# rwkv tolerance of 1e-3.
FORWARD_TOL = 1e-4
DECODE_VS_FORWARD_TOL = 0.15     # tests/test_models_smoke.py, bf16

WIDTHS = [64, 128]               # d_model: one head, two heads


def _seed_block(blocks: dict, rng) -> dict:
    """Replace init's constant leaves by seeded values of the same shape
    and dtype."""
    out = dict(blocks)
    for name, (mean, scale) in {"mu": (0.5, 0.3), "mu_c": (0.5, 0.3),
                                "w0": (-2.0, 1.0), "u": (0.0, 0.1),
                                "ln_x": (1.0, 0.1), "tm_norm": (1.0, 0.1),
                                "cm_norm": (1.0, 0.1)}.items():
        v = blocks[name]
        out[name] = (mean + rng.standard_normal(v.shape) * scale
                     ).astype(v.dtype)
    return out


def bridged(d_model: int, seed: int = 0, dtype: str = "float32"):
    """(jax cfg, port cfg, numpy params) for reduced rwkv6-3b: the
    reference's init, then seeded mixes, decays, bonus and norms."""
    jcfg = jax_reduced(JAX_ARCHS["rwkv6-3b"], d_model=d_model, dtype=dtype)
    cfg = reduced(ALL_ARCHS["rwkv6-3b"], d_model=d_model, dtype=dtype)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    rng = np.random.default_rng(seed)
    params["blocks"] = _seed_block(params["blocks"], rng)
    params["final_norm"] = (1 + rng.standard_normal(
        params["final_norm"].shape) * 0.1).astype(np.float32)
    return jcfg, cfg, params


def _layer(params: dict, i: int) -> tuple:
    """Layer i's params as (jnp dict, torch dict)."""
    bp = {k: v[i] for k, v in params["blocks"].items()}
    return ({k: jnp.asarray(v) for k, v in bp.items()},
            bridge.to_torch(bp, "cpu"))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _rows(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("d_model", WIDTHS)
def test_decay_matches_jax(d_model):
    _, _, params = bridged(d_model)
    jbp, tbp = _layer(params, 1)
    xj, xt = _rows(np.random.default_rng(1), 3, d_model, scale=2.0)
    w = tr._decay(tbp, xt)
    assert w.dtype == torch.float32
    assert bool(((w > 0) & (w < 1)).all())
    _close(w, jr._decay(jbp, xj))


@pytest.mark.parametrize("d_model", WIDTHS)
def test_time_mix_step_matches_jax(d_model):
    jcfg, cfg, params = bridged(d_model)
    jbp, tbp = _layer(params, 0)
    rng = np.random.default_rng(2)
    H = d_model // 64
    xj, xt = _rows(rng, 2, d_model)
    pj, pt = _rows(rng, 2, d_model)
    Sj, St = _rows(rng, 2, H, 64, 64, scale=0.5)
    out, S = tr._time_mix_step(tbp, cfg, xt, pt, St)
    jout, jS = jr._time_mix_step(jbp, jcfg, xj, pj, Sj)
    assert out.shape == (2, d_model) and S.shape == (2, H, 64, 64)
    _close(out, jout)
    _close(S, jS)


@pytest.mark.parametrize("d_model", WIDTHS)
def test_channel_mix_step_matches_jax(d_model):
    _, _, params = bridged(d_model)
    jbp, tbp = _layer(params, 1)
    rng = np.random.default_rng(3)
    xj, xt = _rows(rng, 3, d_model)
    pj, pt = _rows(rng, 3, d_model)
    _close(tr._channel_mix_step(tbp, xt, pt),
           jr._channel_mix_step(jbp, xj, pj))


@pytest.mark.parametrize("d_model", WIDTHS)
def test_decode_step_matches_jax(d_model):
    """Six steps: logits every step, the whole state at the end.

    Both start from the same seeded state, as a slot holds after its first
    tokens. From a zero state the first token's time-mix output
    (r . (u * k)) v is tiny, and the group norm's eps (64e-5) then scales
    it by up to 1 / sqrt(64e-5) = 40: at d_model 64 a one-ulp change of
    the embedding moves the port's own logits by more than TOL there
    (test_zero_state_decode_moves_more_than_tol_under_one_ulp). The
    zero-state start is held by the forward and serve parity tests."""
    jcfg, cfg, params = bridged(d_model)
    jparams = tree_map(jnp.asarray, params)
    tparams = bridge.to_torch(params, "cpu")
    b = 2
    rng = np.random.default_rng(4)
    jstate = jr.init_state(jcfg, b)
    state = tr.init_state(cfg, b, "cpu")
    for name, leaf in state.items():
        assert tuple(leaf.shape) == jstate[name].shape
        assert str(leaf.dtype).split(".")[1] == jstate[name].dtype.name
        assert not leaf.any()
    seeded = {name: (rng.standard_normal(leaf.shape) * 0.5
                     ).astype(np.float32) for name, leaf in state.items()}
    jstate = tree_map(jnp.asarray, seeded)
    state = bridge.to_torch(seeded, "cpu")
    jstep = jax.jit(lambda p, t, s: jr.decode_step(p, jcfg, t, s))
    for pos in range(6):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jstep(jparams, jnp.asarray(tok), jstate)
        logits, state = tr.decode_step(tparams, cfg, torch.from_numpy(tok),
                                       state, pos)
        assert logits.shape == (b, 1, cfg.vocab)
        _close(logits, jlogits)
    for name in ("x_tm", "x_cm", "S"):
        _close(state[name], jstate[name])


def test_zero_state_decode_moves_more_than_tol_under_one_ulp():
    """Why test_decode_step_matches_jax starts from a seeded state: from a
    zero state, reduced rwkv6 (d_model 64) moves its logits by more than
    TOL when every embedding value moves by one fp32 ulp."""
    _, cfg, params = bridged(64)
    tparams = bridge.to_torch(params, "cpu")
    bumped = dict(tparams, embed=torch.nextafter(
        tparams["embed"], torch.full_like(tparams["embed"], np.inf)))
    rng = np.random.default_rng(4)
    a, b = tr.init_state(cfg, 2, "cpu"), tr.init_state(cfg, 2, "cpu")
    moved = 0.0
    for pos in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))
        la, a = tr.decode_step(tparams, cfg, tok, a, pos)
        lb, b = tr.decode_step(bumped, cfg, tok, b, pos)
        moved = max(moved, (la - lb).abs().max().item())
    assert moved > TOL


@pytest.mark.parametrize("d_model", WIDTHS)
def test_forward_matches_jax(d_model):
    """Logits of a 2 x 37 prompt (37: not a multiple of any chunk)."""
    jcfg, cfg, params = bridged(d_model)
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (2, 37)
                                            ).astype(np.int32)
    jlogits = jr.forward(tree_map(jnp.asarray, params), jcfg,
                         jnp.asarray(tok))
    logits = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                      {"tokens": torch.from_numpy(tok)})
    assert logits.shape == (2, 37, cfg.vocab)
    _close(logits, jlogits, FORWARD_TOL)


def test_forward_scans_once_per_layer_through_the_wrapper(monkeypatch):
    """The prefill runs each layer's whole recurrence in one call of the
    rwkv_scan wrapper (on the CPU, its plain version: no launch)."""
    _, cfg, params = bridged(128)
    calls = []
    scan = tr.rwkv_scan

    def spy(r, k, v, w, u):
        calls.append(tuple(r.shape))
        return scan(r, k, v, w, u)

    monkeypatch.setattr(tr, "rwkv_scan", spy)
    reset_launch_counters()
    tr.forward(bridge.to_torch(params, "cpu"), cfg,
               torch.zeros((3, 5), dtype=torch.int64))
    assert calls == [(3, 5, 2, 64)] * cfg.n_layers
    assert all(c.count == 0 for c in launch_counters().values())


@pytest.mark.parametrize("d_model", WIDTHS)
def test_decode_matches_forward_bf16(d_model):
    """tests/test_models_smoke.py's check on the port alone, in bf16:
    feeding tokens one by one through decode_step reproduces forward."""
    cfg = reduced(ALL_ARCHS["rwkv6-3b"], d_model=d_model)
    assert cfg.dtype == "bfloat16"
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 8)).astype(np.int64))
    full = ad.forward(params, {"tokens": tok})
    state = ad.init_decode_state(2, 16, device="cpu")
    steps = []
    for t in range(tok.shape[1]):
        lg, state = ad.decode(params, {"tokens": tok[:, t:t + 1]}, state, t)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(full.float().numpy(),
                               torch.stack(steps, 1).float().numpy(),
                               rtol=DECODE_VS_FORWARD_TOL,
                               atol=DECODE_VS_FORWARD_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_matches_jax_structure_and_scales(dtype):
    jcfg = jax_reduced(JAX_ARCHS["rwkv6-3b"], d_model=128, d_ff=256,
                       dtype=dtype)
    cfg = reduced(ALL_ARCHS["rwkv6-3b"], d_model=128, d_ff=256, dtype=dtype)
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
    assert tp["blocks"]["w0"].dtype == np.float32
    assert tp["blocks"]["u"].shape == (cfg.n_layers, 2, 64)


def test_ssm_decode_state_ignores_max_seq():
    cfg = reduced(ALL_ARCHS["rwkv6-3b"])
    ad = get_adapter(cfg)
    a = ad.init_decode_state(3, 16, device="cpu")
    b = ad.init_decode_state(3, 4096, dtype=torch.float32, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in a.items()} \
        == {k: (v.shape, v.dtype) for k, v in b.items()}
    assert a["S"].shape == (cfg.n_layers, 3, 1, 64, 64)
    assert a["x_tm"].dtype == torch.bfloat16


# --- gradients against an independent float64 computation --------------------

def _rms(x, w, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _independent_loss(p: dict, cfg, tokens, labels):
    """rwkv6's training loss written apart from both packages, token by
    token as the reference scans, in the dtype of `p`: the mean next-token
    cross entropy of the logits at positions 0..s-2 against labels 1..s-1,
    padded vocab entries masked."""
    H, hd, eps = tr.n_heads(cfg), tr.HEAD_DIM, cfg.norm_eps
    h = p["embed"][tokens]
    b, s, d = h.shape
    for layer in range(cfg.n_layers):
        q = {k: v[layer] for k, v in p["blocks"].items()}
        x = _rms(h, q["tm_norm"], eps)
        prev = torch.zeros_like(x[:, 0])
        S = torch.zeros((b, H, hd, hd), dtype=h.dtype)
        outs = []
        for t in range(s):
            xt = x[:, t]
            xr, xk, xv, xg, xw = (xt + (prev - xt) * q["mu"][i]
                                  for i in range(5))
            r, k, v = ((a @ q[n]).reshape(b, H, hd)
                       for a, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
            lora = torch.tanh(xw @ q["w_lora_a"]) @ q["w_lora_b"]
            w = torch.exp(-torch.exp(q["w0"] + lora)).reshape(b, H, hd)
            kv = k[..., :, None] * v[..., None, :]
            o = torch.einsum("bhk,bhkv->bhv", r,
                             S + q["u"][None, :, :, None] * kv)
            S = w[..., None] * S + kv
            mean = o.mean(-1, keepdim=True)
            var = ((o - mean) ** 2).mean(-1, keepdim=True)
            o = ((o - mean) / torch.sqrt(var + 64e-5)).reshape(b, d) \
                * q["ln_x"]
            outs.append((o * torch.nn.functional.silu(xg @ q["wg"]))
                        @ q["wo"])
            prev = xt
        h = h + torch.stack(outs, 1)
        x = _rms(h, q["cm_norm"], eps)
        xp = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
        xk = x + (xp - x) * q["mu_c"][0]
        xr = x + (xp - x) * q["mu_c"][1]
        h = h + (torch.relu(xk @ q["ck"]) ** 2 @ q["cv"]) \
            * torch.sigmoid(xr @ q["cr"])
    lg = (_rms(h, p["final_norm"], eps) @ p["lm_head"])[:, :-1]
    if lg.shape[-1] > cfg.vocab:
        lg = torch.where(torch.arange(lg.shape[-1]) >= cfg.vocab, -1e9, lg)
    picked = torch.gather(lg, -1, labels[:, 1:, None])[..., 0]
    return torch.mean(torch.logsumexp(lg, -1) - picked)


def _loss_and_grads(fn, params: dict, dtype) -> tuple:
    """(loss, {leaf path: grad}) of fn(params as `dtype` leaves)."""
    paths, leaves = [], []

    def leaf(path, t):
        paths.append(path)
        leaves.append(t.detach().to(dtype).requires_grad_(True))
        return leaves[-1]

    def walk(tree, prefix=()):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else leaf("/".join(prefix + (k,)), v)
                for k, v in tree.items()}

    loss = fn(walk(params))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(paths, (g.numpy() for g in grads)))


def _grad_errors(batch_rows: int) -> dict:
    """For reduced rwkv6-3b in fp32 (``bridged(64)``) on a batch of
    `batch_rows` x 16 tokens of seed 3 (labels rolled by one): the port's
    loss and its gradients with remat, the reference's
    (``jax.value_and_grad``), and the independent computation's in fp32
    and in float64; each fp32 gradient's max |g - g64| over the leaf's
    max |g64|, printed for blocks/u."""
    jcfg, cfg, p = bridged(64)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab,
                                               (batch_rows, 16))
    tok = torch.from_numpy(tokens)
    lab = torch.from_numpy(np.roll(tokens, -1, axis=1))
    params = bridge.to_torch(p, "cpu")
    ad = get_adapter(cfg)
    port = _loss_and_grads(lambda q: ad.loss(q, {"tokens": tok, "labels":
                                                 lab}, remat=True),
                           params, torch.float32)
    ind = {dt: _loss_and_grads(lambda q: _independent_loss(q, cfg, tok, lab),
                               params, dt)
           for dt in (torch.float32, torch.float64)}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(
        np.roll(tokens, -1, axis=1))}
    jgrads = jax.grad(lambda q: jax_get_adapter(jcfg).loss(
        q, jbatch, remat=True))(tree_map(jnp.asarray, p))
    ref = {"/".join(k.key for k in path): np.asarray(g) for path, g in
           jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    exact = ind[torch.float64][1]

    def err(grads):
        return {k: float(np.abs(grads[k] - g).max() / np.abs(g).max())
                for k, g in exact.items()}
    out = {"port_loss": port[0], "loss64": ind[torch.float64][0],
           "port": err(port[1]), "jax": err(ref),
           "fp32": err(ind[torch.float32][1])}
    u = exact["blocks/u"]
    at = np.unravel_index(np.argmax(np.abs(port[1]["blocks/u"] - ref[
        "blocks/u"])), u.shape)
    print(f"{batch_rows} x 16 tokens, blocks/u: max |g - g64| / max |g64| "
          f"port {out['port']['blocks/u']!r}, jax {out['jax']['blocks/u']!r}"
          f", independent fp32 {out['fp32']['blocks/u']!r}; at {at} port "
          f"{port[1]['blocks/u'][at]!r}, jax {ref['blocks/u'][at]!r}, "
          f"float64 {u[at]!r} (max |g64| {np.abs(u).max()!r})")
    return out


def test_loss_grads_match_independent_float64():
    """The port's loss and gradients on the JAX parity tests' 4 x 16 batch
    against the independent computation in float64, at the training
    tolerances (tests/test_torch_train.py)."""
    e = _grad_errors(4)
    assert e["port_loss"] == pytest.approx(e["loss64"], rel=1e-5)
    assert max(e["port"].values()) <= 1e-4, e["port"]


def test_grads_on_8x16_batch_as_close_to_float64_as_fp32_allows():
    """On the 8 x 16 batch of seed 3, blocks/u's gradient in fp32 is far
    from its float64 value for any fp32 computation (the reference's too,
    at layer 0, head 0, channel 47): the independent fp32 computation,
    which scans token by token as the reference does, is off by more than
    the training tolerance. The port is no farther from float64 than it,
    on every leaf."""
    e = _grad_errors(8)
    assert e["port_loss"] == pytest.approx(e["loss64"], rel=1e-5)
    assert e["fp32"]["blocks/u"] > 1e-4
    for k, port in e["port"].items():
        assert port <= e["fp32"][k], (k, port, e["fp32"][k])
