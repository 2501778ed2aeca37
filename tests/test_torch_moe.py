"""The port's MoE family against ``repro.models.moe`` and
``repro.models.transformer`` on the same numpy-seeded inputs: ``moe_ffn``
(einsum and gather) in fp32 at tests/test_torch_layers.py's 2e-5, with
dropped tokens and with tied gate probabilities, which must route as
``jax.lax.top_k`` routes them (lower index first; ``torch.topk`` does
not); ``pick_group_size``, ``aux_load_balance_loss``, and reduced
granite-moe / phi3.5-moe ``forward`` and ``decode_step`` through the
adapter on the reference's (bridged) parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _proptest import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import moe as jm
from repro.models import transformer as jt
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import MoEConfig, reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.models import moe as tm
from repro_torch.models import transformer
from repro_torch.models.registry import get_adapter

TOL = 2e-5                     # tests/test_torch_layers.py
FORWARD_TOL = 3e-5             # tests/test_torch_transformer.py
BF16_TOL = 3e-2                # tests/test_kernels.py's bf16 tolerance
MOE = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


def _cfgs(arch="granite-moe-3b-a800m", **moe):
    """(jax cfg, port cfg), reduced, fp32; `moe` overrides MoEConfig
    fields in both."""
    jcfg = jax_reduced(JAX_ARCHS[arch], dtype="float32")
    cfg = reduced(ALL_ARCHS[arch], dtype="float32")
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


def _moe_params(rng, cfg) -> dict:
    m, d = cfg.moe, cfg.d_model

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)

    return {"router": w(d, m.n_experts),
            "w_gate": w(m.n_experts, d, m.expert_d_ff),
            "w_up": w(m.n_experts, d, m.expert_d_ff),
            "w_down": w(m.n_experts, m.expert_d_ff, d)}


def _run_both(jcfg, cfg, params, x, impl, **kw):
    ref = jm.moe_ffn(tree_map(jnp.asarray, params), jnp.asarray(x), jcfg,
                     impl=impl, **kw)
    got = tm.moe_ffn(bridge.to_torch(params, "cpu"), torch.from_numpy(x),
                     cfg, impl=impl, **kw)
    return got.numpy(), np.asarray(ref)


# --- routing helpers --------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("cap", [512, 128, 64])
def test_pick_group_size_matches_jax(arch, cut, cap):
    jcfg, cfg = JAX_ARCHS[arch], ALL_ARCHS[arch]
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    assert tm.pick_group_size(cfg, cap) == jm.pick_group_size(jcfg, cap)


def test_pick_group_size_of_the_two_configs():
    """granite's 512-wide experts give groups of 64, phi3.5's 6400-wide
    ones the cap of 512."""
    assert tm.pick_group_size(ALL_ARCHS["granite-moe-3b-a800m"]) == 64
    assert tm.pick_group_size(ALL_ARCHS["phi3.5-moe-42b-a6.6b"]) == 512


@pytest.mark.parametrize("probs,k", [
    ([.1, .3, .3, .1, .2, .3], 3),
    ([1 / 40] * 40, 8),
    ([.2, .2, .1, .2, .1, .2], 4),
    ([.5, .1, .1, .1, .1, .1], 2),
])
def test_top_k_breaks_ties_as_jax(probs, k):
    p = np.asarray(probs, np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    tv, ti = tm.top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 16, 8)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    idx = np.argsort(-probs, -1)[..., :2].astype(np.int32)
    ref = jm.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 8)
    got = tm.aux_load_balance_loss(torch.from_numpy(probs),
                                   torch.from_numpy(idx), 8)
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)


# --- moe_ffn ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("shape,group_size,cf", [
    ((2, 16, 64), None, 1.25),       # one group of 32
    ((3, 40, 64), 64, 1.25),         # 120 tokens: g 64 -> 60, two groups
    ((2, 24, 64), 16, 1.25),         # three groups of 16
    ((4, 1, 64), None, 1.25),        # a decode step: capacity at top_k
    ((2, 32, 64), 16, 0.05),         # capacity floor top_k: tokens drop
])
def test_moe_ffn_matches_jax(impl, shape, group_size, cf):
    jcfg, cfg = _cfgs(capacity_factor=cf)
    rng = np.random.default_rng(sum(shape))
    params = _moe_params(rng, cfg)
    x = rng.standard_normal(shape).astype(np.float32)
    got, ref = _run_both(jcfg, cfg, params, x, impl, group_size=group_size)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_ffn_drops_tokens_as_jax(impl):
    """At capacity_factor 0.05 each expert keeps top_k = 2 of a group's
    assignments: the output differs from the undropped one, and matches
    the reference's."""
    rng = np.random.default_rng(11)
    jcfg, cfg = _cfgs(capacity_factor=0.05)
    params = _moe_params(rng, cfg)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    got, ref = _run_both(jcfg, cfg, params, x, impl, group_size=16)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    full = tm.moe_ffn(bridge.to_torch(params, "cpu"), torch.from_numpy(x),
                      dataclasses.replace(cfg, moe=dataclasses.replace(
                          cfg.moe, capacity_factor=10.0)),
                      group_size=16, impl=impl).numpy()
    dropped = np.abs(full - got).max(-1) > 1e-3
    assert 0 < dropped.sum() < dropped.size


def _tied_inputs(rng, cfg, tie: str):
    """params and x whose gate probabilities tie. "all": a zero router, so
    all experts tie for every token. "boundary": x carries a constant 1
    in feature 0 and only router row 0 is non-zero, so every token sees
    the logits of row 0, in which experts 1, 2 and 5 tie for the top."""
    params = _moe_params(rng, cfg)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    router = np.zeros_like(params["router"])
    if tie == "boundary":
        x[..., 0] = 1.0
        row = np.full(cfg.moe.n_experts, -5.0, np.float32)
        row[[1, 2, 5]] = 0.0
        row[4] = -1.0
        router[0] = row
    params["router"] = router
    return params, x


TIES = [("all", dict(n_experts=40, top_k=8, expert_d_ff=64)),
        ("all", {}),
        ("boundary", {}),
        ("boundary", dict(top_k=1))]


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("tie,moe", TIES)
def test_moe_ffn_routes_tied_gates_as_jax(impl, tie, moe):
    """granite's 40 experts top-8 all tied, the reduced 8 top-2 all tied,
    and a tie across the top-k boundary (top-2 and top-1 of three equal
    experts). Every token routes to the same experts, so capacity (5 of a
    group of 16 at top-2) drops tokens too, slot-major."""
    jcfg, cfg = _cfgs(**moe)
    params, x = _tied_inputs(np.random.default_rng(3), cfg, tie)
    got, ref = _run_both(jcfg, cfg, params, x, impl)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_ffn_with_torch_topk_would_route_otherwise(monkeypatch, impl):
    """The case above with granite's 40 tied experts: routed by plain
    torch.topk, whose order among equal values is its own, the output
    leaves the reference's; the port's top_k keeps it."""
    jcfg, cfg = _cfgs(n_experts=40, top_k=8, expert_d_ff=64)
    params, x = _tied_inputs(np.random.default_rng(3), cfg, "all")
    _, ref = _run_both(jcfg, cfg, params, x, impl)

    def plain_topk(probs, k):
        vals, idx = torch.topk(probs, k)
        return vals, idx

    monkeypatch.setattr(tm, "top_k", plain_topk)
    got = tm.moe_ffn(bridge.to_torch(params, "cpu"), torch.from_numpy(x),
                     cfg, impl=impl).numpy()
    assert np.abs(got - ref).max() > 1e-2


@settings(deadline=None, max_examples=10)
@given(seed=st.integers(min_value=0, max_value=999))
def test_moe_ffn_matches_jax_property(seed):
    """tests/test_moe.py's property: the gather path equals the einsum
    path; here both port paths also equal the reference's."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    params = _moe_params(rng, cfg)
    x = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    got_e, ref = _run_both(jcfg, cfg, params, x, "einsum")
    got_g, _ = _run_both(jcfg, cfg, params, x, "gather")
    np.testing.assert_allclose(got_e, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_g, got_e, rtol=TOL, atol=TOL)


def test_moe_ffn_bf16_matches_jax():
    """bf16 activations and experts, fp32 router: dispatch and combine in
    fp32, cast to bf16 at the reference's places."""
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    rng = np.random.default_rng(9)
    params = _moe_params(rng, cfg)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else torch.bfloat16)
          for k, v in params.items()}
    for impl in ("einsum", "gather"):
        ref = np.asarray(jm.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                    impl=impl), np.float32)
        got = tm.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), cfg,
                         impl=impl)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=BF16_TOL * np.abs(ref).max(),
                                   err_msg=impl)


# --- the model --------------------------------------------------------------

def bridged_params(arch: str, dtype: str = "float32", seed: int = 0):
    """(jax cfg, port cfg, numpy params) for reduced `arch`: the
    reference's init, then seeded norms."""
    jcfg = jax_reduced(JAX_ARCHS[arch], dtype=dtype)
    cfg = reduced(ALL_ARCHS[arch], dtype=dtype)
    params = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(seed), tp=1))
    rng = np.random.default_rng(seed)
    blocks = params["blocks"]
    for name in ("attn_norm", "ffn_norm"):
        v = blocks[name]
        blocks[name] = (1 + rng.standard_normal(v.shape) * 0.1
                        ).astype(v.dtype)
    return jcfg, cfg, params


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch):
    """80 tokens: groups of 64 do not divide them, so two groups of 40."""
    jcfg, cfg, params = bridged_params(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)
                                             ).astype(np.int32)
    ref = jt.forward(tree_map(jnp.asarray, params), jcfg, jnp.asarray(toks))
    got = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                   {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FORWARD_TOL,
                               atol=FORWARD_TOL)


def test_forward_bf16_matches_jax():
    jcfg, cfg, params = bridged_params("granite-moe-3b-a800m", "bfloat16")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20)
                                             ).astype(np.int32)
    ref = np.asarray(jt.forward(tree_map(jnp.asarray, params), jcfg,
                                jnp.asarray(toks)), np.float32)
    got = get_adapter(cfg).forward(bridge.to_torch(params, "cpu"),
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=BF16_TOL * np.abs(ref).max())


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches_jax(arch):
    """Six steps at 3 slots in fp32 with an fp32 cache: logits every step,
    the cache at the end."""
    jcfg, cfg, params = bridged_params(arch)
    jad, ad = jax_get_adapter(jcfg), get_adapter(cfg)
    jparams = tree_map(jnp.asarray, params)
    tparams = bridge.to_torch(params, "cpu")
    b, max_seq = 3, 16
    jcache = jad.init_decode_state(b, max_seq, dtype=jnp.float32)
    tcache = ad.init_decode_state(b, max_seq, dtype=torch.float32,
                                  device="cpu")
    jstep = jax.jit(lambda p, t, c, pos: jad.decode(p, {"tokens": t}, c,
                                                    pos))
    rng = np.random.default_rng(4)
    for pos in range(6):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlog, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                             jnp.array(pos, jnp.int32))
        tlog, tcache = ad.decode(tparams, {"tokens": torch.from_numpy(tok)},
                                 tcache, pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=f"pos {pos}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_mirrors_reference_structure(dtype):
    """Same tree, shapes and dtypes as the reference's init: a ``moe``
    subtree in place of ``ffn``, the router fp32 in a bf16 model, expert
    weights scaled by 1/sqrt(n_experts) (fan-in is shape[0])."""
    jcfg = jax_reduced(JAX_ARCHS["granite-moe-3b-a800m"], dtype=dtype)
    cfg = reduced(ALL_ARCHS["granite-moe-3b-a800m"], dtype=dtype)
    ref = tree_map(np.asarray, jax_get_adapter(jcfg).init(
        jax.random.PRNGKey(0), tp=1))
    got = bridge.to_numpy(transformer.init(
        cfg, torch.Generator().manual_seed(0)))

    def walk(r, g, path=""):
        assert set(r) == set(g), path
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], g[k], f"{path}/{k}")
            else:
                assert g[k].shape == r[k].shape, f"{path}/{k}"
                assert (g[k].dtype == np.uint16) == (r[k].dtype.name
                                                     == "bfloat16"), k
    walk(ref, got)
    assert got["blocks"]["moe"]["router"].dtype == np.float32
    w = transformer.init(cfg, torch.Generator().manual_seed(1)
                         )["blocks"]["moe"]["w_up"].float()
    assert abs(w.std().item() * np.sqrt(cfg.moe.n_experts) - 1) < 0.05


def test_reduced_moe_config_matches_jax():
    for arch in MOE:
        assert dataclasses.asdict(reduced(ALL_ARCHS[arch]).moe) \
            == dataclasses.asdict(jax_reduced(JAX_ARCHS[arch]).moe)
    assert isinstance(reduced(ALL_ARCHS[MOE[0]]).moe, MoEConfig)
