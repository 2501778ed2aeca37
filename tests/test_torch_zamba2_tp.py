"""zamba2 (the hybrid family) on a model axis of several ranks, on the CPU:
``models/zamba2.py``'s decode step and training forward on each rank's
shards, ``launch/serve.py``'s placement and ``models/registry.py``'s
paths, held against the single-process port and against JAX.

Reduced fp32 zamba2-1.2b (8 SSM heads, so they split over 2 and 4 ranks;
4 query and 2 KV heads in its shared block, so wk and wv stay whole on
every rank of a model axis of 4), its constant leaves seeded. One 4-rank
spawn (2x2 and 1x4) and one 2-rank spawn (1x2 and 2x1) of
``_torch_dist_worker.py``:

* decode: 8 steps of 4 rows from an fp32 state on every mesh, against the
  single-process port and JAX's ``decode_step`` at 1e-5; each rank holds
  its parts of in_proj and conv_w laid out once (its heads' z, x and dt
  and all of B and C), launches the meshless step's products and
  attention calls, one in_proj product a block, and gathers nothing the
  size of a weight in a step; the serve loop's greedy tokens equal the
  JAX driver's, and the serve driver runs on each mesh;
* training: the first step on 2x2, 1x2 and 1x4 (each rank on its model
  shards) against the single-process step and ``jax.value_and_grad``:
  the loss at 1e-5 relative, every gradient leaf at 1e-4 of its largest,
  in_proj's and conv_w's B and C columns on their own; the driver's
  losses over 3 steps; each rank's forward sees 1/n of every leaf split
  over ``model``;
* ``sharding.gather_parts_for_model`` is adjoint to its backward in fp64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as worker
from repro.compat import tree_map as jax_tree_map
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_train
from repro_torch.models import registry, zamba2
from repro_torch.models.registry import get_adapter
from repro_torch.train.optimizer import _leaves
from repro_torch.train.train_step import accumulate
from test_torch_cp_attention import ModelAxis
from test_torch_distributed import _jax_driver_tokens
from test_torch_train import GRAD_TOL, LOSS_TOL
from test_torch_train import _batch as parity_batch
from test_torch_zamba2 import bridged

ARCH = worker.ZAMBA
DECODE_MESHES = ["2x2", "1x4", "1x2", "2x1"]
TRAIN_MESHES = ["2x2", "1x4", "1x2"]
DECODE_STEPS, DECODE_B, MAX_SEQ = 8, 4, 8
DECODE_TOL = 1e-5


def _calls_of(step: list, name: str) -> list:
    return [what for n, what in step if n == name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process references, then the 4-rank and 2-rank
    spawns."""
    tmp = tmp_path_factory.mktemp("zamba2_tp")
    jcfg, cfg, seeded = bridged("float32")
    jad, ad = jax_get_adapter(jcfg), get_adapter(cfg)
    plain = jax_tree_map(np.asarray, jad.init(jax.random.PRNGKey(0), tp=1))
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (DECODE_STEPS, DECODE_B, 1)).astype(np.int32)

    # decode: the single-process port (its kernel calls counted) and JAX
    params = bridge.to_torch(seeded, "cpu")
    state = ad.init_decode_state(DECODE_B, MAX_SEQ, dtype=torch.float32,
                                 device="cpu")
    jstate = jad.init_decode_state(DECODE_B, MAX_SEQ, dtype=jnp.float32)
    jstep = jax.jit(lambda p, t, c, pos: jad.decode(p, {"tokens": t}, c,
                                                    pos))
    jparams = jax_tree_map(jnp.asarray, seeded)
    single, want, steps = [], [], []
    with torch.inference_mode():
        for pos, tok in enumerate(tokens):
            calls = []
            with worker._calls(calls):
                lg, state = ad.decode(params, {"tokens": torch.from_numpy(
                    tok)}, state, pos)
            steps.append(calls)
            single.append(lg.numpy())
            jlg, jstate = jstep(jparams, jnp.asarray(tok), jstate,
                                jnp.array(pos, jnp.int32))
            want.append(np.asarray(jlg))
    torch.save((params, bridge.to_torch(plain, "cpu"),
                torch.from_numpy(tokens), MAX_SEQ), tmp / "decode.pt")

    # training: the single-process step and the driver's losses
    batch = parity_batch(cfg.vocab)
    loss, grads = accumulate(lambda q, b: ad.loss(q, b, remat=True),
                             params,
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()}, worker.MICRO)
    losses = port_train.train(worker.fp32_cfg(ARCH), steps=worker.STEPS,
                              seq_len=worker.SEQ, global_batch=worker.BATCH,
                              microbatches=worker.MICRO,
                              device="cpu").losses
    torch.save({ARCH: (params, batch)}, tmp / "train.pt")

    four = worker.spawn(4, str(tmp), [
        ("zamba2_decode", (str(tmp / "decode.pt"), ["2x2", "1x4"])),
        ("meshes", (str(tmp / "train.pt"), {m: [ARCH]
                                            for m in ("2x2", "1x4")}))])
    two = worker.spawn(2, str(tmp), [
        ("zamba2_decode", (str(tmp / "decode.pt"), ["1x2", "2x1"])),
        ("meshes", (str(tmp / "train.pt"), {"1x2": [ARCH]})),
        ("gather_parts_adjoint", (5,))])
    jloss, jgrads = jax.value_and_grad(
        lambda q: jad.loss(q, jax_tree_map(jnp.asarray, batch),
                           remat=True))(jparams)
    return {"cfg": cfg, "seeded": seeded,
            "single": np.stack(single), "jax": np.stack(want),
            "single_steps": steps,
            "driver_tokens": _jax_driver_tokens(ARCH),
            "decode": {**four["zamba2_decode"], **two["zamba2_decode"]},
            "train": {**four["meshes"], **two["meshes"]},
            "train_single": {"loss": float(loss), "losses": losses,
                             "grads": {"/".join(k): g.numpy()
                                       for k, g in _leaves(grads)}},
            "train_jax": {"loss": float(jloss), "grads": {
                "/".join(k.key for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(
                    jgrads)[0]}},
            "adjoint": two["gather_parts_adjoint"]}


# --- decode ------------------------------------------------------------------

@pytest.mark.parametrize("mesh", DECODE_MESHES)
def test_decode_matches_single_process_and_jax(runs, mesh):
    """Eight steps on the mesh, each rank its rows and its SSM heads, the
    shared block's cache split by sequence: logits within 1e-5 of the
    single-process port and of JAX's decode_step."""
    got = runs["decode"][mesh]["logits"]
    assert got.shape == runs["single"].shape
    for name in ("single", "jax"):
        np.testing.assert_allclose(got, runs[name], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=name)


@pytest.mark.parametrize("mesh", DECODE_MESHES)
def test_serve_tokens_match_jax_driver(runs, mesh):
    """The serve loop on the mesh emits the JAX driver's greedy tokens, and
    the serve driver runs there to its end."""
    got = runs["decode"][mesh]
    assert got["tokens"] == runs["driver_tokens"]
    assert len(got["tokens"]) == worker.SERVE_REQUESTS
    assert got["driver"] == 0


@pytest.mark.parametrize("mesh", DECODE_MESHES)
def test_rank_holds_its_parts(runs, mesh):
    """Each rank holds in_proj and conv_w by its parts (its heads' z, x
    and dt columns and all of B and C), its heads of A_log, D, dt_bias
    and gate_norm, 1/model of out_proj, the shared block's split weights,
    the embedding and the head, and so about 1/model of the bytes; its
    state holds its rows, its heads and channels and S/model slots of the
    KV cache, whose whole S the step sees."""
    cfg = runs["cfg"]
    data, n = port_mesh.parse_mesh(mesh)
    N, hd = cfg.ssm.state_dim, cfg.ssm.head_dim
    din, nh = zamba2.inner_dim(cfg), zamba2.ssm_heads(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    whole = {"/".join(p): tuple(np.shape(t))
             for p, t in _leaves(runs["seeded"])}
    want = dict(whole)
    want.update({
        "blocks/in_proj": (L, d, 2 * din // n + 2 * N + nh // n),
        "blocks/conv_w": (L, cfg.ssm.conv_width, din // n + 2 * N),
        "blocks/A_log": (L, nh // n), "blocks/D": (L, nh // n),
        "blocks/dt_bias": (L, nh // n), "blocks/gate_norm": (L, din // n),
        "blocks/out_proj": (L, din // n, d), "embed": (V // n, d),
        "lm_head": (d, V // n)})
    for name in ("wq", "wo"):
        shape = list(whole[f"shared/attn/{name}"])
        shape[name == "wq"] //= n
        want[f"shared/attn/{name}"] = tuple(shape)
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    if kv % n == 0 and cfg.n_kv_heads >= n:
        for name in ("wk", "wv"):
            want[f"shared/attn/{name}"] = (d, whole[f"shared/attn/{name}"][1]
                                           // n)
    want["shared/ffn/w_gate"] = want["shared/ffn/w_up"] = (d, cfg.d_ff // n)
    want["shared/ffn/w_down"] = (cfg.d_ff // n, d)
    whole_bytes = 4 * sum(np.prod(s) for s in whole.values())
    _, n_shared = zamba2._pattern(cfg)
    got = runs["decode"][mesh]
    assert got["cache_seq"] == MAX_SEQ
    assert len(got["ranks"]) == data * n
    for rank in got["ranks"]:
        assert rank["local"] == want
        assert rank["bytes"] == 4 * sum(np.prod(s) for s in want.values())
        if n > 1:
            assert rank["bytes"] < whole_bytes / n * 1.35
        rows = DECODE_B // data
        assert rank["state"] == {
            "ssm": (L, rows, nh // n, hd, N),
            "conv": (L, rows, cfg.ssm.conv_width - 1, din // n + 2 * N),
            "k": (n_shared, rows, cfg.n_kv_heads, MAX_SEQ // n,
                  cfg.resolved_head_dim),
            "v": (n_shared, rows, cfg.n_kv_heads, MAX_SEQ // n,
                  cfg.resolved_head_dim)}


@pytest.mark.parametrize("mesh", DECODE_MESHES)
def test_rank_launches_the_meshless_calls(runs, mesh):
    """Each rank's step makes the meshless step's products, one in_proj
    product a block on its parts, and as many attention calls (partial
    over its slots where the model axis splits the cache); no collective
    of a step moves as many elements as one block's in_proj part, so no
    weight is gathered at decode."""
    cfg = runs["cfg"]
    n = port_mesh.parse_mesh(mesh)[1]
    single = runs["single_steps"][0]
    n_rm = len(_calls_of(single, "rowstream_matmul"))
    n_fd = len(_calls_of(single, "flash_decode"))
    _, n_shared = zamba2._pattern(cfg)
    assert (n_rm, n_fd) == (2 * cfg.n_layers + 7 * n_shared + 1, n_shared)
    part = tuple(runs["decode"][mesh]["ranks"][0]["local"][
        "blocks/in_proj"][1:])
    for rank in runs["decode"][mesh]["ranks"]:
        assert len(rank["steps"]) == DECODE_STEPS
        for step in rank["steps"]:
            products = _calls_of(step, "rowstream_matmul")
            assert len(products) == n_rm
            assert products.count(part) == cfg.n_layers
            attention = "flash_decode_partial" if n > 1 else "flash_decode"
            assert len(_calls_of(step, attention)) == n_fd
            moved = _calls_of(step, "all_gather") \
                + _calls_of(step, "all_reduce")
            assert bool(moved) == (n > 1)
            assert max(moved, default=0) < np.prod(part)


def test_decode_refuses_shapes_that_do_not_split():
    """A model axis of 3 divides neither reduced zamba2's 8 SSM heads nor
    its d_ff: the state, the placement and the step refuse with the
    reason, and the train step gathers whole (train_tp_path)."""
    _, cfg, seeded = bridged("float32")
    params = bridge.to_torch(seeded, "cpu")
    with pytest.raises(NotImplementedError, match="SSM heads"):
        zamba2.init_state(cfg, 2, 8, device="cpu", mesh=ModelAxis(3))
    with pytest.raises(NotImplementedError, match="SSM heads"):
        zamba2.decode_step(params, cfg, torch.zeros((1, 1), dtype=
                           torch.int64), {}, 0, ModelAxis(3))
    on, why = registry.train_tp_path(cfg, 3)
    assert not on and "SSM heads" in why and "gathers" in why


def test_decode_refuses_evenly_split_parameters():
    """The step on a model axis of 2 takes the parameters as
    place_decode_params lays them out; the reference's even split of
    in_proj (param_specs) is refused, not decoded."""
    _, cfg, seeded = bridged("float32")
    params = bridge.to_torch(seeded, "cpu")
    blocks = dict(params["blocks"])
    for name, (dim, n) in {"in_proj": (-1, 2), "conv_w": (-1, 2),
                           "out_proj": (-2, 2)}.items():
        blocks[name] = blocks[name].chunk(n, dim)[0]
    even = dict(params, blocks=blocks,
                embed=params["embed"].chunk(2, 0)[0],
                lm_head=params["lm_head"].chunk(2, -1)[0])
    with pytest.raises(ValueError, match="'blocks/in_proj': 148"):
        zamba2.check_decode_shards(even, cfg, 2)


# --- training ----------------------------------------------------------------

def _close_leaves(got: dict, want: dict):
    """Every leaf within GRAD_TOL of its largest |want|; in_proj's B and C
    columns and conv_w's B and C channels (partial on each rank, summed
    once) also within GRAD_TOL of their own largest, named apart."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.abs(np.asarray(got[k], np.float32) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), k
    cfg = get_adapter(worker.fp32_cfg(ARCH)).cfg
    din, N = zamba2.inner_dim(cfg), cfg.ssm.state_dim
    for k, lo in (("blocks/in_proj", 2 * din), ("blocks/conv_w", din)):
        for part, start in (("B", lo), ("C", lo + N)):
            w = np.asarray(want[k], np.float32)[..., start:start + N]
            g = np.asarray(got[k], np.float32)[..., start:start + N]
            assert float(np.abs(w).max()) > 0, (k, part)
            np.testing.assert_array_less(
                np.abs(g - w).max(), GRAD_TOL * np.abs(w).max() + 1e-30,
                err_msg=f"{k}: the {part} columns")


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_matches_single_process(runs, mesh):
    got, want = runs["train"][mesh][ARCH], runs["train_single"]
    assert got["shards"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
    _close_leaves(got["grads"], want["grads"])


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_matches_jax_value_and_grad(runs, mesh):
    got, want = runs["train"][mesh][ARCH], runs["train_jax"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
    _close_leaves(got["grads"], want["grads"])


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_driver_losses_match_single_process(runs, mesh):
    got = runs["train"][mesh][ARCH]["losses"]
    assert len(got) == worker.STEPS
    np.testing.assert_allclose(got, runs["train_single"]["losses"],
                               rtol=LOSS_TOL, atol=0)


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_forward_sees_model_shards(runs, mesh):
    """Every rank's forward sees 1/model of each leaf the specs split over
    model (in_proj and conv_w evenly, as stored; their parts are gathered
    inside the forward) and every other leaf whole."""
    data, n = port_mesh.parse_mesh(mesh)
    got = runs["train"][mesh][ARCH]
    cfg = worker.fp32_cfg(ARCH)
    ad = get_adapter(cfg)
    whole = {"/".join(p): tuple(np.shape(t))
             for p, t in _leaves(runs["seeded"])}
    split = set()
    for path, spec in _leaves(ad.param_specs("data", n)):
        key = "/".join(path)
        entries = sharding.constrain_entries(spec, whole[key],
                                             {"data": data, "model": n})
        if any("model" in sharding._axes(e) for e in entries):
            split.add(key)
    assert {"blocks/in_proj", "blocks/conv_w", "blocks/out_proj",
            "embed", "lm_head"} <= split
    assert len(got["ranks"]) == data * n
    for rank in got["ranks"]:
        for path, shape in whole.items():
            seen = rank["shapes"][path]
            if path in split:
                assert np.prod(seen) * n == np.prod(shape), path
            else:
                assert seen == shape, path


def test_train_tp_path_admits_zamba2():
    cfg = worker.fp32_cfg(ARCH)
    for n in (2, 4):
        on, why = registry.train_tp_path(cfg, n)
        assert on and cfg.name in why
        assert get_adapter(cfg).supports_train_tp(n)


# --- the collective ----------------------------------------------------------

@pytest.mark.parametrize("case", ["part", "whole"])
def test_gather_parts_is_adjoint(runs, case):
    """<f(x), y> = <x, f*(y)> in fp64 over 2 ranks whose indices overlap:
    x each rank's part (summed over the ranks) or the whole (once)."""
    lhs, rhs, fx_shape, xbar_shape = runs["adjoint"][case]
    assert fx_shape == (3, 5, 2)
    assert xbar_shape == ((3, 4, 2) if case == "part" else (3, 8, 2))
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)
    assert abs(lhs) > 1e-3
