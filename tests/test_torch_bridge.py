"""numpy -> port -> numpy is bit-exact for f32 and bf16 parameters of the
reference's ``transformer.init(reduced(qwen2-7b))``, and the stacked
``blocks`` leaves stay stacked."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map
from repro.configs.base import reduced
from repro.configs.registry_configs import ALL_ARCHS
from repro.models import transformer
from repro_torch import bridge


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    cfg = reduced(ALL_ARCHS["qwen2-7b"], dtype=dtype)
    params = tree_map(np.asarray,
                      transformer.init(cfg, jax.random.PRNGKey(3)))
    tparams = bridge.to_torch(params, "cpu")
    back = bridge.to_numpy(tparams)
    want = dict(_leaves(params))
    got = dict(_leaves(back))
    tgot = dict(_leaves(tparams))
    assert set(got) == set(want)
    for name, ref in want.items():
        assert tgot[name].dtype == getattr(torch, dtype), name
        assert tuple(tgot[name].shape) == ref.shape, name
        bits = ref.view(np.uint16) if dtype == "bfloat16" else ref
        np.testing.assert_array_equal(got[name], bits, err_msg=name)
    # Stacked per-layer leaves keep their leading layer dim.
    assert tgot["/blocks/attn/wq"].shape[0] == cfg.n_layers
    # A bf16 value reaches torch exactly.
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            tgot["/embed"].float().numpy(),
            params["embed"].astype(np.float32))
