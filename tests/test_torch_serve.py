"""The slices as a whole: the port's serve loop, on the reference's
parameters moved across by the bridge, emits exactly the greedy tokens of
``repro.launch.serve.main`` for reduced qwen2-7b (KV cache), reduced
granite-moe-3b (KV cache, MoE FFN), reduced rwkv6-3b (recurrent state),
reduced zamba2-1.2b (SSM and conv state, a KV cache per shared attention
application), reduced whisper-small and reduced llama-3.2-vision (a KV
cache and a cross KV that neither driver fills) in fp32."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.launch import serve as jax_serve
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.launch import serve as port_serve

ARGV = ["--reduced", "--requests", "4", "--slots", "2", "--max-new", "8"]


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "zamba2-1.2b",
                                  "whisper-small", "llama-3.2-vision-90b"])
def test_serve_tokens_match_jax_driver(monkeypatch, arch):
    batchers = []

    class Capture(JaxBatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            batchers.append(self)

    def reduced_fp32(cfg):
        return jax_reduced(cfg, dtype="float32")

    monkeypatch.setattr(jax_serve, "ContinuousBatcher", Capture)
    monkeypatch.setattr(jax_serve, "reduced", reduced_fp32)
    assert jax_serve.main(["--arch", arch] + ARGV) == 0
    (jb,) = batchers
    expected = {r.rid: r.out_tokens for r in jb.completed}

    # The reference's parameters, built as its driver builds them.
    jcfg = reduced_fp32(JAX_ARCHS[arch])
    jparams = jax_get_adapter(jcfg).init(jax.random.PRNGKey(0), tp=1)
    params = bridge.to_torch(tree_map(np.asarray, jparams), "cpu")

    cfg = reduced(ALL_ARCHS[arch], dtype="float32")
    requests = port_serve.make_requests(4, 16, 8, cfg.vocab, seed=0)
    run = port_serve.serve(cfg, params, requests, slots=2, max_seq=128,
                           device="cpu")
    got = {r.rid: r.out_tokens for r in run.batcher.completed}
    assert got == expected
    assert len(got) == 4 and all(len(t) == 8 for t in got.values())
    assert run.batcher.steps == jb.steps
    # Counted as the reference counts it: after retirement, so a request's
    # last token is not counted.
    assert run.tokens_out == sum(len(t) for t in got.values()) - len(got)


def test_serve_requests_match_reference_prompts():
    cfg = reduced(ALL_ARCHS["qwen2-7b"])
    reqs = port_serve.make_requests(3, 16, 5, cfg.vocab, seed=4)
    rng = np.random.default_rng(4)
    for rid, req in enumerate(reqs):
        np.testing.assert_array_equal(
            req.prompt, rng.integers(1, cfg.vocab, size=(16,),
                                     dtype=np.int32))
        assert req.rid == rid and req.max_new_tokens == 5
