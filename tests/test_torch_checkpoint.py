"""The port's checkpoints (``repro_torch.distributed.checkpoint``):
tests/test_checkpoint.py's cases mirrored one for one (round trip, bf16
survives, torn saves skipped, a structure mismatch raises, async, the
same step overwritten); the on-disk format shared with
``repro.distributed.checkpoint`` both ways, for reduced rwkv6-3b and
qwen2-7b ``TrainState``s with bf16 parameters, bit for bit; and the train
driver resumed from a checkpoint giving the uninterrupted run's losses
bit for bit, with and without async saves."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import tree_map as jax_tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.distributed import checkpoint as jax_ckpt
from repro.models.registry import get_adapter as jax_get_adapter
from repro.train.train_step import train_state_init as jax_state_init
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train as port_train
from repro_torch.models.registry import get_adapter
from repro_torch.train.optimizer import tree_map
from repro_torch.train.train_step import TrainState, train_state_init


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _flat(tree):
    return ckpt._flatten(tree)


# --- tests/test_checkpoint.py, mirrored --------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    r = ckpt.restore(str(tmp_path), 3, _zeros_like(t))
    for a, b in zip(_flat(t), _flat(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_bf16_dtype_survives(tmp_path):
    t = {"w": torch.full((4,), 1.25, dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), 0, t)
    with open(tmp_path / "step_000000" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == ["bfloat16"]
    with np.load(tmp_path / "step_000000" / "host_000.npz") as data:
        assert data["leaf_0"].dtype == np.uint16
    r = ckpt.restore(str(tmp_path), 0, _zeros_like(t))
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"], t["w"])


def test_latest_step_skips_torn_saves(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 5, t)
    # torn save: directory without a complete manifest
    os.makedirs(tmp_path / "step_000009")
    with open(tmp_path / "step_000009" / "manifest.json", "w") as f:
        json.dump({"step": 9, "status": "writing"}, f)
    # and a save that never got renamed into place
    os.makedirs(tmp_path / "step_000011.tmp0")
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_structure_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 0, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), 0, {"only": torch.zeros(3)})
    # the same number of leaves in another order: caught by the shapes
    swapped = {"a": torch.zeros(5, dtype=torch.bfloat16),
               "b": {"c": torch.zeros(3, 4), "d": torch.tensor(0)}}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), 0, swapped)


def test_async_checkpointer(tmp_path):
    t = _tree()
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 2, t)
    saver.save(str(tmp_path), 4, t)     # joins the in-flight save first
    saver.close()
    assert ckpt.latest_step(str(tmp_path)) == 4
    r = ckpt.restore(str(tmp_path), 2, _zeros_like(t))
    assert torch.equal(r["a"], t["a"])
    assert [s["step"] for s in saver.saves] == [2, 4]
    assert all(s["host_bytes"] == 12 * 4 + 5 * 2 + 4 and s["write_s"] > 0
               and s["block_s"] >= s["copy_s"] for s in saver.saves)


def test_async_save_is_a_copy(tmp_path):
    """The host copy is taken before save() returns: an in-place update
    of the state right after (as the train step's) does not reach the
    checkpoint."""
    t = _tree()
    want = t["a"].clone()
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 1, t)
    t["a"].add_(100.0)
    saver.close()
    r = ckpt.restore(str(tmp_path), 1, _zeros_like(t))
    assert torch.equal(r["a"], want)


def test_overwrite_same_step(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    t2 = tree_map(lambda x: x + 1 if x.dtype != torch.bfloat16 else x, t)
    ckpt.save(str(tmp_path), 7, t2)
    r = ckpt.restore(str(tmp_path), 7, _zeros_like(t))
    assert torch.equal(r["a"], t2["a"])


# --- the format shared with the JAX package ----------------------------------

ARCHS = ["rwkv6-3b", "qwen2-7b"]


def _jax_state(arch):
    """A reduced bf16 TrainState of the reference after one update of its
    moments and step (so no leaf is init's constant), and the port's
    TrainState of the same structure, zeroed."""
    jcfg = jax_reduced(JAX_ARCHS[arch])
    params = jax_get_adapter(jcfg).init(jax.random.PRNGKey(1), tp=1)
    s = jax_state_init(params)
    rng = np.random.default_rng(2)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
    s = s._replace(opt=s.opt._replace(step=jnp.asarray(3, jnp.int32),
                                      mu=jax_tree_map(noise, s.opt.mu),
                                      nu=jax_tree_map(noise, s.opt.nu)))
    cfg = reduced(ALL_ARCHS[arch])
    port = train_state_init(get_adapter(cfg).init(
        torch.Generator().manual_seed(0)))
    return s, TrainState(_zeros_like(port.params), port.opt._replace(
        mu=_zeros_like(port.opt.mu), nu=_zeros_like(port.opt.nu),
        step=torch.zeros((), dtype=torch.int32)))


def _bridged(js) -> TrainState:
    as_np = lambda t: jax_tree_map(np.asarray, t)
    return TrainState(bridge.to_torch(as_np(js.params), "cpu"),
                      js.opt._replace(
                          step=torch.from_numpy(np.asarray(js.opt.step)),
                          mu=bridge.to_torch(as_np(js.opt.mu), "cpu"),
                          nu=bridge.to_torch(as_np(js.opt.nu), "cpu")))


def _port_leaves_np(tree) -> list:
    """The port's leaves as numpy, bf16 as its uint16 bits."""
    out = []
    for t in _flat(tree):
        if t.dtype == torch.bfloat16:
            out.append(t.view(torch.int16).numpy().view(np.uint16))
        else:
            out.append(t.numpy())
    return out


def _jax_leaves_np(tree) -> list:
    out = []
    for a in jax.tree.leaves(tree):
        a = np.asarray(a)
        out.append(a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_save_restores_in_the_port_bit_for_bit(arch, tmp_path):
    js, like = _jax_state(arch)
    assert jax.tree.leaves(js.params)[0].dtype == jnp.bfloat16
    jax_ckpt.save(str(tmp_path), 4, js)
    assert ckpt.latest_step(str(tmp_path)) == 4
    got = ckpt.restore(str(tmp_path), 4, like)
    want = _bridged(js)
    assert len(_flat(got)) == len(jax.tree.leaves(js))
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w)
    assert int(got.opt.step) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_restores_in_jax_bit_for_bit(arch, tmp_path):
    js, _ = _jax_state(arch)
    port = _bridged(js)
    ckpt.save(str(tmp_path), 6, port)
    assert jax_ckpt.latest_step(str(tmp_path)) == 6
    r = jax_ckpt.restore(str(tmp_path), 6,
                         jax_tree_map(jnp.zeros_like, js))
    got, want = _jax_leaves_np(r), _port_leaves_np(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert r.params["embed"].dtype == jnp.bfloat16
    assert int(r.opt.step) == 3


def test_leaf_order_is_jaxs():
    """Leaves numbered as jax.tree.flatten numbers them (dict keys sorted,
    NamedTuple fields in order), whatever the dicts' insertion order."""
    js, _ = _jax_state("rwkv6-3b")
    port = _bridged(js)
    shuffled = TrainState({k: port.params[k] for k in
                           reversed(list(port.params))}, port.opt)
    got = [tuple(t.shape) for t in _flat(shuffled)]
    assert got == [tuple(np.shape(a)) for a in jax.tree.leaves(js)]


# --- the driver resumes bit for bit ------------------------------------------

RUN = dict(use_reduced=True, seq_len=16, global_batch=4, device="cpu",
           seed=1)


@pytest.mark.parametrize("async_ckpt", [False, True],
                         ids=["sync", "async"])
def test_driver_resume_gives_the_same_losses(async_ckpt, tmp_path, capsys):
    whole = port_train.train("rwkv6-3b", steps=6, **RUN)
    d = str(tmp_path)
    first = port_train.train("rwkv6-3b", steps=3, ckpt_dir=d, ckpt_every=3,
                             async_ckpt=async_ckpt, **RUN)
    assert ckpt.latest_step(d) == 2 and first.restore_s is None
    assert [s["step"] for s in first.saves] == [2]
    resumed = port_train.train("rwkv6-3b", steps=3, ckpt_dir=d,
                               ckpt_every=3, async_ckpt=async_ckpt, **RUN)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert resumed.start_step == 3 and resumed.restore_s > 0
    assert first.losses + resumed.losses == whole.losses
    assert ckpt.latest_step(d) == 5
    assert int(resumed.state.opt.step) == 6
    for a, b in zip(_flat(resumed.state), _flat(whole.state)):
        assert torch.equal(a, b)


def test_driver_flags_resume(tmp_path, capsys):
    d = str(tmp_path)
    args = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "4", "--ckpt-dir", d,
            "--ckpt-every", "2", "--async-ckpt"]
    assert port_train.main(args + ["--steps", "4"]) == 0
    assert ckpt.latest_step(d) == 3
    assert port_train.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "[train] step 5 loss" in out
    assert ckpt.latest_step(d) == 5
