"""The port's counterpart of tests/test_models_smoke.py over all ten
architectures, reduced, on the CPU: one forward (shapes, no NaN), the loss
(finite; forward only, no gradient yet), one decode step (shapes, no NaN,
the state's structure kept), and the parameter tree and decode state of
the port's ``init`` and ``init_decode_state`` equal to the reference's,
leaf for leaf in name, shape and dtype. Also ``_xent`` against the
reference's on whisper's padded vocab (51865 -> 51968, and a reduced
vocab of 250 -> 256) at the fp32 tolerance 1e-5, and ``loss`` of reduced
whisper on bridged parameters at the fp32 forward tolerance 3e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import registry as jax_registry
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed.sharding import padded_vocab
from repro_torch.models import registry
from repro_torch.models.registry import get_adapter

ARCHS = sorted(ALL_ARCHS)
KEY = jax.random.PRNGKey(0)


def test_port_has_all_ten_archs():
    assert ARCHS == sorted(JAX_ARCHS) and len(ARCHS) == 10


def _batch(adapter, cfg, b=2, s=8):
    batch = {"tokens": torch.ones((b, s), dtype=torch.int64) * 3,
             "labels": torch.ones((b, s), dtype=torch.int64) * 5}
    if "vision_embeds" in adapter.extra_inputs:
        batch["vision_embeds"] = torch.ones(
            (b, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16) \
            * 0.02
    if "frames" in adapter.extra_inputs:
        batch["frames"] = torch.ones(
            (b, cfg.n_audio_frames, cfg.d_model), dtype=torch.bfloat16) * 0.02
    return batch


def _port(arch):
    cfg = reduced(ALL_ARCHS[arch])
    ad = get_adapter(cfg)
    return cfg, ad, ad.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_no_nan(arch):
    cfg, ad, params = _port(arch)
    logits = ad.forward(params, _batch(ad, cfg))
    assert logits.shape[:2] == (2, 8)
    assert logits.shape[2] == padded_vocab(cfg.vocab) >= cfg.vocab
    assert not bool(logits.float().isnan().any())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_finite(arch):
    cfg, ad, params = _port(arch)
    loss = ad.loss(params, _batch(ad, cfg))
    assert loss.shape == () and bool(loss.isfinite())


def _leaves(tree, prefix=()) -> dict:
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    dtype = str(tree.dtype).removeprefix("torch.")
    return {prefix: (tuple(tree.shape), dtype)}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg, ad, params = _port(arch)
    state = ad.init_decode_state(2, 16, device="cpu")
    before = _leaves(state)
    logits, state2 = ad.decode(params, {"tokens": torch.ones(
        (2, 1), dtype=torch.int32)}, state, 3)
    assert logits.shape[:2] == (2, 1)
    assert not bool(logits.float().isnan().any())
    assert _leaves(state2) == before


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_decode_state_match_reference(arch):
    """Leaf names, shapes and dtypes of the parameters and of the decode
    state (batch 2, max_seq 16, the default dtype) equal the reference's
    (traced with jax.eval_shape: nothing is computed)."""
    cfg, ad, params = _port(arch)
    jad = jax_registry.get_adapter(jax_reduced(JAX_ARCHS[arch]))
    assert _leaves(params) == _leaves(jax.eval_shape(lambda: jad.init(KEY)))
    assert _leaves(ad.init_decode_state(2, 16, device="cpu")) == _leaves(
        jax.eval_shape(lambda: jad.init_decode_state(2, 16)))
    assert ad.extra_inputs == jad.extra_inputs


@pytest.mark.parametrize("vocab,Vp", [(51865, 51968), (250, 256),
                                      (256, 256)])
def test_xent_matches_jax_on_padded_vocab(vocab, Vp):
    """The padded entries hold the largest logits, so an unmasked pad
    would change the loss."""
    assert padded_vocab(vocab) == Vp
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((2, 5, Vp)).astype(np.float32) * 3
    logits[..., vocab:] += 20
    labels = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    got = registry._xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         vocab)
    want = jax_registry._xent(jnp.asarray(logits), jnp.asarray(labels), vocab)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_loss_matches_jax_reduced_whisper_padded_vocab():
    jcfg = jax_reduced(JAX_ARCHS["whisper-small"], dtype="float32", vocab=250)
    cfg = reduced(ALL_ARCHS["whisper-small"], dtype="float32", vocab=250)
    jad, ad = jax_registry.get_adapter(jcfg), get_adapter(cfg)
    np_params = tree_map(np.asarray, jad.init(KEY))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 250, (2, 8)).astype(np.int32)
    frames = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)
                                 ).astype(np.float32)
    want = jad.loss(tree_map(jnp.asarray, np_params), {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
        "frames": jnp.asarray(frames)})
    got = ad.loss(bridge.to_torch(np_params, "cpu"), {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(toks).long(),
        "frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(got.item(), float(want), rtol=3e-5, atol=3e-5)
