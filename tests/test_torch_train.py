"""The port's training substrate (``repro_torch.train``) against
``repro.train``: tests/test_train.py's cases mirrored one for one (AdamW
converges, moments fp32 with the param dtype kept, the clip applies,
microbatch equivalence, the int8 round trip, error feedback, the
compression property); ``adamw_update`` and ``compress_tree`` on
identical grads against JAX's over 3 steps; the loss and its gradients
through ``ModelAdapter.loss(..., remat=True)`` against
``jax.value_and_grad`` of the reference's, and one ``make_train_step``
with two microbatches against the reference's, for reduced rwkv6-3b and
qwen2-7b in fp32 on the reference's (bridged) parameters; the loss and
its gradients of granite-moe-3b, zamba2-1.2b, whisper-small and
llama-3.2-vision-90b against ``jax.value_and_grad`` with ``remat`` off
and on; ``adamw_update`` on the sliced path (``UPDATE_ELEMS`` 16 and 7)
with bf16 and fp32 leaves against JAX's over 3 steps; and ``remat=True``
against ``remat=False`` for every family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _proptest import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.compat import tree_map as jax_tree_map
from repro.models.registry import get_adapter as jax_get_adapter
from repro.train import grad_compress as jgc
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import train_state_init as jax_state_init
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models.registry import get_adapter
from repro_torch.train import optimizer as port_optimizer
from repro_torch.train.grad_compress import (ErrorFeedback, compress_int8,
                                             compress_tree, decompress_int8,
                                             decompress_tree, ef_init)
from repro_torch.train.optimizer import adamw_init, adamw_update, tree_map
from repro_torch.train.train_step import make_train_step, train_state_init
from test_torch_mllama import bridged as mllama_bridged
from test_torch_moe import bridged_params as moe_bridged
from test_torch_prefill import bridged_params as dense_bridged
from test_torch_rwkv6 import bridged as rwkv_bridged
from test_torch_whisper import bridged as whisper_bridged
from test_torch_zamba2 import bridged as zamba_bridged

# AdamW and compression on identical inputs: both compute in fp32 in the
# same order; they differ in the last bits of sqrt, pow and division.
OPT_TOL = 1e-6
# Loss gradients against jax.value_and_grad, per leaf: max |port - jax|
# within 1e-4 of the leaf's largest |jax| gradient. The forwards agree to
# 1e-4 (tests/test_torch_rwkv6.py FORWARD_TOL; the port's rwkv6 scans in
# chunks where the reference scans token by token), and the backward
# sums in another order again.
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def _quadratic_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _toy_problem(n=64, d=8):
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((d, 1)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.standard_normal((n, 1)).astype(np.float32)
    params = {"w": torch.zeros((d, 1)), "b": torch.zeros((1,))}
    return params, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _grad(loss_fn, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, batch)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


# --- tests/test_train.py, mirrored -------------------------------------------

def test_adamw_converges():
    params, batch = _toy_problem()
    state = adamw_init(params)
    loss0 = float(_quadratic_loss(params, batch))
    for _ in range(200):
        grads = _grad(_quadratic_loss, params, batch)
        params, state = adamw_update(params, grads, state, lr=0.05,
                                     weight_decay=0.0)
    assert float(_quadratic_loss(params, batch)) < 0.05 * loss0


def test_adamw_moments_fp32_params_dtype_kept():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state.mu["w"].dtype == torch.float32
    assert state.nu["w"].dtype == torch.float32
    grads = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    new, state = adamw_update(params, grads, state)
    assert new["w"].dtype == torch.bfloat16
    assert int(state.step) == 1 and state.step.dtype == torch.int32


def test_grad_clip_applies():
    params = {"w": torch.zeros((4,))}
    state = adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    p1, _ = adamw_update(params, huge, state, lr=1e-3, grad_clip=1.0,
                         weight_decay=0.0)
    assert float(p1["w"].abs().max()) < 1e-2


def test_microbatch_equivalence():
    """Accumulated step == single-batch step (same grads => same params)."""
    params, batch = _toy_problem(n=32)
    s1 = train_state_init({k: v.clone() for k, v in params.items()})
    s2 = train_state_init({k: v.clone() for k, v in params.items()})
    step1 = make_train_step(_quadratic_loss, microbatches=1, lr=0.01)
    step4 = make_train_step(_quadratic_loss, microbatches=4, lr=0.01)
    s1, m1 = step1(s1, batch)
    s2, m2 = step4(s2, batch)
    np.testing.assert_allclose(s1.params["w"].numpy(), s2.params["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


def test_compress_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32))
    q, s = compress_int8(g)
    back = decompress_int8(q, s)
    assert float((back - g).abs().max()) <= float(s) / 2 + 1e-9


def test_error_feedback_unbiased_over_time():
    """With EF, the accumulated applied gradient converges to the true
    accumulated gradient (the residual stays bounded)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        128).astype(np.float32)) * 1e-3}
    ef = ef_init(g)
    assert isinstance(ef, ErrorFeedback)
    applied = torch.zeros((128,))
    for _ in range(50):
        (q, s), ef = compress_tree(g, ef)
        applied = applied + decompress_tree(q, s)["w"]
    true = g["w"] * 50
    resid = float(ef.buf["w"].abs().max())
    np.testing.assert_allclose((applied + ef.buf["w"]).numpy(), true.numpy(),
                               rtol=1e-4, atol=1e-6)
    assert resid < float(g["w"].abs().max())


@settings(deadline=None, max_examples=25)
@given(scale=st.floats(min_value=1e-6, max_value=1e4),
       n=st.integers(min_value=1, max_value=64))
def test_compress_property(scale, n):
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n).astype(np.float32)) * scale
    q, s = compress_int8(g)
    assert q.dtype == torch.int8
    back = decompress_int8(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-12


# --- against JAX on identical inputs -----------------------------------------

def _opt_tree(rng) -> dict:
    """A nested tree of fp32 leaves, one of them stacked like a model's
    blocks."""
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "blocks": {"w": rng.standard_normal((3, 8, 8)).astype(np.float32),
                       "u": rng.standard_normal((3, 8)).astype(np.float32)}}


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(1)
    p_np = _opt_tree(rng)
    jp, tp = jax_tree_map(jnp.asarray, p_np), bridge.to_torch(p_np, "cpu")
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        g_np = jax_tree_map(lambda a: a * grad_scale, _opt_tree(rng))
        jp, js = jax_adamw_update(jp, jax_tree_map(jnp.asarray, g_np), js,
                                  lr=1e-2)
        tp, ts = adamw_update(tp, bridge.to_torch(g_np, "cpu"), ts, lr=1e-2)
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        jax_tree_map(lambda w, g: np.testing.assert_allclose(
            g, np.asarray(w), rtol=OPT_TOL, atol=OPT_TOL),
            want, bridge.to_numpy(got))
    assert int(ts.step) == int(js.step) == 3


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(2)
    jef = jgc.ef_init(jax_tree_map(jnp.asarray, _opt_tree(rng)))
    tef = ef_init(bridge.to_torch(_opt_tree(rng), "cpu"))
    for _ in range(3):
        g_np = _opt_tree(rng)
        (jq, js), jef = jgc.compress_tree(jax_tree_map(jnp.asarray, g_np), jef)
        (tq, ts), tef = compress_tree(bridge.to_torch(g_np, "cpu"), tef)
        jax_tree_map(lambda w, g: np.testing.assert_array_equal(
            g, np.asarray(w)), jq, bridge.to_numpy(tq))
        for got, want in ((ts, js), (tef.buf, jef.buf),
                          (decompress_tree(tq, ts), jgc.decompress_tree(jq,
                                                                        js))):
            jax_tree_map(lambda w, g: np.testing.assert_allclose(
                g, np.asarray(w), rtol=OPT_TOL, atol=OPT_TOL),
                want, bridge.to_numpy(got))


def _sliced_tree(rng) -> dict:
    """Leaves of 7 to 96 elements in bf16 and fp32, a 0-d one among them,
    so that UPDATE_ELEMS of 16 or 7 slices most of them."""
    bf = lambda *s: np.asarray(jnp.asarray(
        rng.standard_normal(s).astype(np.float32), jnp.bfloat16))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": bf(12, 8), "blocks": {"w": bf(3, 4, 8), "u": f32(3, 5)},
            "norm": f32(7), "gate": f32()}


@pytest.mark.parametrize("elems", [16, 7])
def test_adamw_update_sliced_and_bf16_matches_jax(elems, monkeypatch):
    """adamw_update with its leaves updated and normed UPDATE_ELEMS
    elements at a time (another summation order than the reference's),
    on bf16 and fp32 leaves, against JAX's over 3 steps, the last one
    clipped."""
    monkeypatch.setattr(port_optimizer, "UPDATE_ELEMS", elems)
    rng = np.random.default_rng(4)
    p_np = _sliced_tree(rng)
    jp, tp = jax_tree_map(jnp.asarray, p_np), bridge.to_torch(p_np, "cpu")
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for scale in (1e-2, 1e-2, 10.0):
        g_np = jax_tree_map(lambda a: (a.astype(np.float32) * scale).astype(
            a.dtype), _sliced_tree(rng))
        jp, js = jax_adamw_update(jp, jax_tree_map(jnp.asarray, g_np), js,
                                  lr=1e-2)
        tp, ts = adamw_update(tp, bridge.to_torch(g_np, "cpu"), ts, lr=1e-2)
    assert tp["embed"].dtype == torch.bfloat16
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        jax_tree_map(lambda w, g: np.testing.assert_allclose(
            np.asarray(jnp.asarray(g if g.dtype != np.uint16 else
                                   g.view(jnp.bfloat16), jnp.float32)),
            np.asarray(w, np.float32), rtol=OPT_TOL, atol=OPT_TOL),
            want, bridge.to_numpy(got))
    assert int(ts.step) == int(js.step) == 3


# --- the loss and its gradients against jax.value_and_grad -------------------

def _bridged(arch):
    """(jax adapter, port adapter, numpy params) for reduced `arch` in
    fp32, the reference's init with seeded constants."""
    if arch == "rwkv6-3b":
        jcfg, cfg, p = rwkv_bridged(64)
    else:
        jcfg, cfg, p = dense_bridged(arch)
    return jax_get_adapter(jcfg), get_adapter(cfg), p


def _batch(vocab, b=4, s=16, seed=3):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _close_leaves(got: dict, want: dict, tol=GRAD_TOL):
    """Every leaf: max |got - want| within `tol` of max |want|."""
    def one(w, g):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        assert scale > 0
        assert float(np.abs(np.asarray(g, np.float32) - w).max()) \
            <= tol * scale
    jax_tree_map(one, want, got)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-7b"])
def test_loss_and_grads_with_remat_match_jax(arch):
    jad, tad, p = _bridged(arch)
    batch = _batch(tad.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(
        lambda q: jad.loss(q, jax_tree_map(jnp.asarray, batch), remat=True))(
        jax_tree_map(jnp.asarray, p))
    tp = bridge.to_torch(p, "cpu")
    leaves = tree_map(lambda t: t.requires_grad_(True), tp)
    loss = tad.loss(leaves, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, remat=True)
    flat = []
    tree_map(flat.append, leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    tgrads = tree_map(lambda _: next(grads).numpy(), leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    _close_leaves(tgrads, jgrads)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-7b"])
def test_train_step_matches_jax(arch):
    """One step of make_train_step with 2 microbatches, remat on: the loss
    and the first moment (the clipped, accumulated gradient times 0.1)
    against the reference's step on the same parameters and batch. The
    updated parameters are not compared elementwise: AdamW's first step
    moves each by about lr * sign(g), so a gradient near zero flips a
    whole step."""
    jad, tad, p = _bridged(arch)
    batch = _batch(tad.cfg.vocab, b=4)
    jstep = jax_make_train_step(lambda q, b: jad.loss(q, b, remat=True),
                                microbatches=2, lr=1e-3)
    js, jm = jax.jit(jstep)(jax_state_init(jax_tree_map(jnp.asarray, p)),
                            jax_tree_map(jnp.asarray, batch))
    tstep = make_train_step(lambda q, b: tad.loss(q, b, remat=True),
                            microbatches=2, lr=1e-3)
    ts, tm = tstep(train_state_init(bridge.to_torch(p, "cpu")),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    _close_leaves(bridge.to_numpy(ts.opt.mu), js.opt.mu)
    assert int(ts.opt.step) == int(js.opt.step) == 1


def _other_family(arch):
    """(jax adapter, port adapter, numpy params, numpy batch) for reduced
    `arch` in fp32 on the reference's parameters with seeded constants,
    the batch with the family's extra inputs."""
    bridged = {"granite-moe-3b-a800m": lambda: moe_bridged(arch),
               "zamba2-1.2b": zamba_bridged,
               "whisper-small": whisper_bridged,
               "llama-3.2-vision-90b": mllama_bridged}[arch]
    jcfg, cfg, p = bridged()
    batch = _batch(cfg.vocab)
    n = {"frames": cfg.n_audio_frames, "vision_embeds": cfg.n_vision_tokens}
    ad = get_adapter(cfg)
    for name in ad.extra_inputs:
        batch[name] = np.random.default_rng(5).standard_normal(
            (4, n[name], cfg.d_model)).astype(np.float32)
    return jax_get_adapter(jcfg), ad, p, batch


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-1.2b",
                                  "whisper-small", "llama-3.2-vision-90b"])
def test_loss_and_grads_of_other_families_match_jax(arch, remat):
    jad, tad, p, batch = _other_family(arch)
    jloss, jgrads = jax.value_and_grad(
        lambda q: jad.loss(q, jax_tree_map(jnp.asarray, batch), remat=remat))(
        jax_tree_map(jnp.asarray, p))
    leaves = tree_map(lambda t: t.requires_grad_(True),
                      bridge.to_torch(p, "cpu"))
    loss = tad.loss(leaves, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, remat=remat)
    flat = []
    tree_map(flat.append, leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    tgrads = tree_map(lambda _: next(grads).numpy(), leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    _close_leaves(tgrads, jgrads)


# --- remat changes no gradient ----------------------------------------------

def _family_case(arch):
    """Reduced `arch` in fp32: port params from a seeded generator with
    every leaf moved by seeded noise (so biases, gates and norms are not
    init's constants), and a batch with the family's extra inputs."""
    cfg = reduced(ALL_ARCHS[arch], dtype="float32")
    ad = get_adapter(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=gen, dtype=t.dtype), ad.init(gen))
    np_batch = _batch(cfg.vocab, b=2, s=8)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    for name in ad.extra_inputs:
        n = cfg.n_vision_tokens if name == "vision_embeds" \
            else cfg.n_audio_frames
        batch[name] = torch.randn((2, n, cfg.d_model), generator=gen)
    return ad, params, batch


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "zamba2-1.2b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_remat_gives_the_same_grads(arch):
    ad, params, batch = _family_case(arch)
    out = []
    for remat in (False, True):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        flat = []
        tree_map(flat.append, leaves)
        loss = ad.loss(leaves, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, flat)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
