"""The port's distributed training on the CPU: ``distributed/sharding.py``,
``distributed/elastic.py``, ``launch/mesh.py`` and the mesh path of
``train/train_step.py`` and ``train/optimizer.py``.

Multi-rank checks run in spawned processes joined into a gloo process
group by a ``FileStore`` (no network; ``_torch_dist_worker.py``): 4
ranks for a 2x2 mesh, then 2 ranks for 2x1, 1x2 and ``--mesh 2``. On
each mesh the first step's loss and gradients (reduced qwen2-7b and
rwkv6-3b in fp32, the reference's parameters bridged, the JAX parity
tests' 4 x 16 batch in 2 microbatches split over the data ranks) are
held against the single-process step at the repo's tolerances, and on
2x2 against ``jax.value_and_grad``; the driver's losses over 3 steps
against its single-process run; AdamW on the 2x2 mesh's local shards
against JAX's. A state saved on 2x2 resumes through ``elastic_resume``
on 1x2 and 1x1 with bit-equal leaves. The pure parts are held against
the reference directly: ``init(tp=3)`` shapes, the spec tuples,
``filter_spec``, ``spec``, ``constrain_like``'s rule, ``viable_meshes``
and ``shrink_mesh``'s choices.

Serving on a mesh (``launch/serve.py``, ``models/transformer.py``): in
the same spawns, reduced fp32 qwen2-7b and h2o-danube-1.8b (a sliding
window, its ring buffer wrapping) decode eight steps on 2x2, 1x2 and
2x1 from the reference's ``init(tp=2)`` parameters bridged, against the
single-process port and JAX's ``decode_step``; the serve loop on each
mesh emits the reference driver's greedy tokens; each rank holds 1/model
of every weight split over ``model`` and S/model cache slots; on 2x1 the
other families serve their one-process tokens, and on 1x2 and 2x2 whisper
and mllama do (their decode on shards is held against JAX in
tests/test_torch_cross_tp.py). A 1x1 mesh is the meshless step, call for
call.

Tensor-parallel training (``train/train_step.py`` with ``shards``, the
autograd collectives of ``distributed/sharding.py``): in the same spawns,
on 2x2 and 1x2, reduced qwen2-7b, qwen2-7b with one KV head and rwkv6-3b
at d_model 128 compute on their model shards (rwkv6-3b at 64, one head,
gathers whole); their first step and 3 driver steps are held against the
single-process port and ``jax.value_and_grad``, and each rank's forward
sees half of every leaf split over model and scans 1 of 2 heads. The
four collectives are adjoint in fp64 on 2 ranks and the identity on a
one-rank axis; a 1x1 train step is the meshless one bit for bit.

The MoE family and rwkv6 on a mesh (``models/moe.py``,
``models/transformer.py``, ``models/rwkv6.py``): in the same spawns,
reduced fp32 granite-moe-3b (8 experts, split 4 a rank), granite with 3
experts (each expert's FFN width split instead) and phi3.5-moe decode 8
steps at the driver's 4 slots on 2x2, 1x2 and 2x1, and rwkv6-3b at
d_model 128 on its heads, against the single-process port and JAX's
``decode_step`` at 1e-5, with the JAX driver's greedy tokens; every rank
of a model axis chooses the same experts; each rank holds its experts'
or its heads' shares. Their train steps on 2x1, 1x2 and 2x2 are held
against the single-process step and JAX's microbatched
``value_and_grad``. Where the batch axes hold several ranks the routing
groups span them, as the reference forms them from the whole batch: the
inputs are ones on which the single-process routing drops assignments,
which per-rank groups would drop otherwise."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as worker
from repro.compat import tree_map as jax_tree_map
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.distributed import elastic as jax_elastic
from repro.distributed import sharding as jax_sharding
from repro.launch import serve as jax_serve
from repro.models.registry import get_adapter as jax_get_adapter
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import (layers, mllama, moe, registry, rwkv6,
                                transformer, whisper)
from repro_torch.models.registry import get_adapter
from repro_torch.train.optimizer import _leaves
from repro_torch.train.train_step import accumulate
from test_torch_cp_attention import ModelAxis
from test_torch_mllama import bridged as mllama_bridged
from test_torch_prefill import _seed_biases_and_norms
from test_torch_prefill import bridged_params as dense_bridged
from test_torch_rwkv6 import _seed_block
from test_torch_rwkv6 import bridged as rwkv_bridged
from test_torch_train import GRAD_TOL, LOSS_TOL, OPT_TOL
from test_torch_train import _batch as parity_batch
from test_torch_whisper import bridged as whisper_bridged
from test_torch_zamba2 import bridged as zamba_bridged

ARCHS = ["qwen2-7b", "rwkv6-3b"]
MESHES_OF_2 = ["2x1", "1x2", "2"]
MESHES = ["2x2"] + MESHES_OF_2
# The tensor-parallel training cases (``_torch_dist_worker.CASES``), run on
# the meshes with a model axis of 2: rwkv6-3b at d_model 128 (2 heads) and
# qwen2-7b with one KV head (wk and wv whole on every rank).
TP_CASES = list(worker.CASES)
TP_MESHES = ["2x2", "1x2"]
# The MoE family's archs (reduced: 8 experts, top 2), trained on meshes
# whose batch axes split each microbatch's rows (the routing groups then
# span them) and whose model axis splits the experts.
MOE_ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]
MOE_MESHES = ["2x2", "2x1", "1x2"]
TRAIN_RUNS = [(a, m) for a in ARCHS for m in MESHES] \
    + [(a, m) for a in TP_CASES for m in TP_MESHES] \
    + [(a, m) for a in MOE_ARCHS for m in MOE_MESHES]
# Whether each arch's first step computes on model shards on a model axis
# of 2: reduced rwkv6-3b at d_model 64 has one head, so its parameters are
# gathered whole.
ON_SHARDS = {"qwen2-7b": True, "rwkv6-3b": False, "rwkv6-3b-d128": True,
             "qwen2-7b-kv1": True, "granite-moe-3b-a800m": True,
             "phi3.5-moe-42b-a6.6b": True, "granite-moe-e3": True}
# Serving: each arch with its cache's max_seq over DECODE_STEPS steps of
# DECODE_B rows. qwen2-7b's 8 slots put shard 1 of 2 empty for 4 steps;
# h2o-danube-1.8b's 4-slot ring buffer wraps after 4 (slot pos % 4 over
# the whole cache, 2 slots a rank).
SERVE_ARCHS = {"qwen2-7b": 8, "h2o-danube-1.8b": 4}
# The families that decode on a model axis since the MoE and rwkv6 slice:
# granite with its 8 experts split by expert, with 3 experts split by FFN
# width, phi3.5-moe, and rwkv6-3b at d_model 128 (2 heads, one a rank);
# each with the cache's max_seq (rwkv6's state has none).
TP_SERVE_ARCHS = {"granite-moe-3b-a800m": 8, "granite-moe-e3": 8,
                  "phi3.5-moe-42b-a6.6b": 8, "rwkv6-3b-d128": 8}
MOE_SERVE = [a for a in TP_SERVE_ARCHS if a != "rwkv6-3b-d128"]
SERVE_MESHES_OF_2 = ["1x2", "2x1"]
SERVE_MESHES = ["2x2"] + SERVE_MESHES_OF_2
DECODE_STEPS, DECODE_B = 8, 4
DECODE_TOL = 1e-5


def _jax_cfg(arch):
    """The reference's reduced fp32 config of a case (``worker.CASES``'
    overrides, a port MoEConfig as the reference's)."""
    name, overrides = worker.CASES.get(arch, (arch, {}))
    overrides = {k: JaxMoEConfig(**dataclasses.asdict(v))
                 if k == "moe" else v for k, v in overrides.items()}
    return jax_reduced(JAX_ARCHS[name], dtype="float32", **overrides)


def _bridged(arch):
    """(jax cfg, port cfg, numpy params) of a training case in fp32: the
    reference's init bridged, biases, norms and rwkv6's mixes seeded."""
    if arch == "rwkv6-3b":
        return rwkv_bridged(64)
    if arch == "rwkv6-3b-d128":
        return rwkv_bridged(128)
    if arch in worker.CASES:
        jcfg = _jax_cfg(arch)
        params = jax_tree_map(np.asarray, jax_get_adapter(jcfg).init(
            jax.random.PRNGKey(0), tp=1))
        return jcfg, worker.fp32_cfg(arch), _seed_biases_and_norms(
            params, np.random.default_rng(0))
    return dense_bridged(arch)


@contextlib.contextmanager
def _counted_drops(counts: list):
    """``moe.route`` counting, for each call, the assignments that the
    experts' capacity drops."""
    route = moe.route

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        counts.append(moe.dropped(r))
        return r

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", counted)
        yield


def _opt_case(rng):
    """A tree of fp32 and bf16 leaves placed on 2x2 by its specs (dims
    split over data, model, both, or neither), and 3 steps of grads."""
    def leaves():
        bf = np.asarray(jnp.asarray(rng.standard_normal((8, 6)).astype(
            np.float32), jnp.bfloat16))
        return {"embed": bf, "w": rng.standard_normal((4, 10)).astype(
                    np.float32),
                "stack": rng.standard_normal((3, 4, 4)).astype(np.float32),
                "norm": rng.standard_normal((6,)).astype(np.float32)}
    specs = {"embed": ("model", "data"), "w": ("data", None),
             "stack": (None, ("data", "model"), None), "norm": (None,)}
    tree = leaves()
    grads = [jax_tree_map(lambda a: (a.astype(np.float32) * s).astype(
        a.dtype), leaves()) for s in (1e-2, 1e-2, 10.0)]
    return tree, specs, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process references, then the 4-rank and the 2-rank
    spawns (the latter resumes what the former saved)."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs, single = {}, {}
    for arch in ARCHS + TP_CASES + MOE_ARCHS:
        _, cfg, p = _bridged(arch)
        # The JAX parity tests' batch (tests/test_torch_train.py): 4 x 16
        # tokens, 2 microbatches of 2 rows, 1 row a data rank.
        params, batch = bridge.to_torch(p, "cpu"), parity_batch(cfg.vocab)
        inputs[arch] = (params, batch)
        ad = get_adapter(cfg)
        drops = []
        with _counted_drops(drops):
            loss, grads = accumulate(
                lambda q, b: ad.loss(q, b, remat=True), params,
                {k: torch.from_numpy(v) for k, v in batch.items()},
                worker.MICRO)
        run = port_train.train(worker.fp32_cfg(arch), steps=worker.STEPS,
                               seq_len=worker.SEQ,
                               global_batch=worker.BATCH,
                               microbatches=worker.MICRO, device="cpu")
        single[arch] = {"loss": float(loss), "losses": run.losses,
                        "grads": {"/".join(k): g.numpy()
                                  for k, g in _leaves(grads)},
                        "dropped": sum(drops)}
    torch.save(inputs, tmp / "inputs.pt")
    serve_in, serve_ref = _serve_references()
    torch.save(serve_in, tmp / "serve.pt")
    opt = _opt_case(np.random.default_rng(6))
    torch.save((bridge.to_torch(opt[0], "cpu"), opt[1],
                [bridge.to_torch(g, "cpu") for g in opt[2]]),
               tmp / "opt.pt")
    ck, witness = str(tmp / "ckpt"), str(tmp / "witness.pt")
    def plan(texts):
        return {t: [a for a, m in TRAIN_RUNS if m == t] for t in texts}

    four = worker.spawn(4, str(tmp), [
        ("meshes", (str(tmp / "inputs.pt"), plan(["2x2"]))),
        ("adamw_2x2", (str(tmp / "opt.pt"),)),
        ("save_2x2", (ck, witness)),
        ("serve_meshes", (str(tmp / "serve.pt"), ["2x2"]))])
    two = worker.spawn(2, str(tmp), [
        ("meshes", (str(tmp / "inputs.pt"), plan(MESHES_OF_2))),
        ("resume", (ck, witness, 2)),
        ("serve_meshes", (str(tmp / "serve.pt"), SERVE_MESHES_OF_2)),
        ("tp_collectives", (11,))])
    return {"single": single, "inputs": inputs, "opt": opt, "ckpt": ck,
            "witness": witness, "meshes": {**four["meshes"],
                                           **two["meshes"]},
            "adamw_2x2": four["adamw_2x2"], "save_2x2": four["save_2x2"],
            "resume_1x2": two["resume"], "serve_in": serve_in,
            "tp_collectives": two["tp_collectives"],
            "serve_ref": serve_ref,
            "serve": {**four["serve_meshes"], **two["serve_meshes"]}}


def _serve_references():
    """For each serving arch: the workers' inputs (the reference's
    init(tp=2) parameters bridged, seeded and as its driver makes them;
    DECODE_STEPS steps of tokens; max_seq) and the references: the
    single-process port's and JAX's decode logits from fp32 caches, and
    the reference driver's greedy tokens on the same requests."""
    inputs, refs = {}, {}
    rng = np.random.default_rng(7)
    for arch, max_seq in (SERVE_ARCHS | TP_SERVE_ARCHS).items():
        jcfg = _jax_cfg(arch)
        jad = jax_get_adapter(jcfg)
        plain = jad.init(jax.random.PRNGKey(0), tp=2)
        # The reference driver's parameters are init(tp=1): the same tree
        # when the heads divide over 2, as in every reduced config.
        assert jax.tree_util.tree_all(jax_tree_map(
            lambda a, b: bool((a == b).all()), plain,
            jad.init(jax.random.PRNGKey(0), tp=1)))
        plain = jax_tree_map(np.asarray, plain)
        if jcfg.family == "ssm":
            seeded = rwkv_bridged(jcfg.d_model)[2]
        else:
            seeded = _seed_biases_and_norms(plain, np.random.default_rng(0))
        tokens = rng.integers(0, jcfg.vocab, (DECODE_STEPS, DECODE_B, 1)
                              ).astype(np.int32)
        inputs[arch] = (bridge.to_torch(seeded, "cpu"),
                        bridge.to_torch(plain, "cpu"),
                        torch.from_numpy(tokens), max_seq)

        ad = get_adapter(worker.fp32_cfg(arch))
        tparams = bridge.to_torch(seeded, "cpu")
        tcache = ad.init_decode_state(DECODE_B, max_seq,
                                      dtype=torch.float32, device="cpu")
        jcache = jad.init_decode_state(DECODE_B, max_seq, dtype=jnp.float32)
        jstep = jax.jit(lambda p, t, c, pos: jad.decode(p, {"tokens": t}, c,
                                                        pos))
        jparams = jax_tree_map(jnp.asarray, seeded)
        single, want, drops = [], [], []
        with torch.inference_mode(), _counted_drops(drops):
            for pos, tok in enumerate(tokens):
                lg, tcache = ad.decode(tparams, {"tokens": torch.from_numpy(
                    tok)}, tcache, pos)
                single.append(lg.numpy())
                jlg, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                    jnp.array(pos, jnp.int32))
                want.append(np.asarray(jlg))
        refs[arch] = {"single": np.stack(single), "jax": np.stack(want),
                      "tokens": _jax_driver_tokens(arch),
                      "dropped": sum(drops)}
    return inputs, refs


def _jax_driver_tokens(arch) -> dict:
    """The reference driver's greedy tokens for reduced fp32 `arch` (a
    case of ``worker.CASES`` with its overrides) on the workers' requests
    at the workers' slots (tests/test_torch_serve.py's capture)."""
    batchers = []

    class Capture(jax_serve.ContinuousBatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            batchers.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_serve, "ContinuousBatcher", Capture)
        mp.setattr(jax_serve, "reduced", lambda cfg: _jax_cfg(arch))
        assert jax_serve.main([
            "--arch", worker.CASES.get(arch, (arch,))[0], "--reduced",
            "--requests", str(worker.SERVE_REQUESTS), "--slots",
            str(worker.serve_slots(arch)), "--max-new",
            str(worker.SERVE_NEW), "--max-seq",
            str(worker.SERVE_MAX_SEQ)]) == 0
    (b,) = batchers
    return {r.rid: r.out_tokens for r in b.completed}


def _close_leaves(got: dict, want: dict, tol=GRAD_TOL):
    """Every leaf: max |got - want| within `tol` of max |want|."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert float(np.abs(np.asarray(got[k], np.float32) - w).max()) \
            <= tol * scale, k


# --- each mesh against the single-process step -------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_RUNS)
def test_mesh_first_step_matches_single_process(runs, arch, mesh):
    got, want = runs["meshes"][mesh][arch], runs["single"][arch]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
    _close_leaves(got["grads"], want["grads"])


@pytest.mark.parametrize("arch,mesh", TRAIN_RUNS)
def test_mesh_losses_over_three_steps_match_single_process(runs, arch, mesh):
    got, want = runs["meshes"][mesh][arch], runs["single"][arch]
    assert len(got["losses"]) == worker.STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_TOL,
                               atol=0)


@pytest.mark.parametrize("mesh,axes,tp", [
    ("2x2", ("data", "model"), 2), ("2x1", ("data", "model"), 1),
    ("1x2", ("data", "model"), 2), ("2", ("data",), 2)])
def test_mesh_axes_tp_and_split_leaves(runs, mesh, axes, tp):
    """The driver's axes and TP (``--mesh 2`` gives ("data",) with TP 2,
    the reference's quirk), and parameters really split on every mesh."""
    for arch in ARCHS:
        got = runs["meshes"][mesh][arch]
        assert got["axes"] == axes and got["tp"] == tp
        assert got["split_leaves"] > 0


def _jax_value_and_grad(runs, arch) -> tuple:
    """(loss, {leaf path: grad}) of jax.value_and_grad of the reference's
    loss with remat on the whole parity batch: the mean of equal
    microbatches' means. The MoE family's routing groups are each
    microbatch's, so there the mean is taken over the microbatches, as
    the reference's make_train_step scans them. Computed once an arch
    and kept in `runs`."""
    done = runs.setdefault("jax_grads", {})
    if arch not in done:
        done[arch] = _jax_value_and_grad_of(runs, arch)
    return done[arch]


def _jax_value_and_grad_of(runs, arch) -> tuple:
    jcfg, _, p = _bridged(arch)
    jad = jax_get_adapter(jcfg)
    batch = runs["inputs"][arch][1]
    parts = [batch]
    if jcfg.moe:
        rows = len(batch["tokens"]) // worker.MICRO
        parts = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                 for i in range(worker.MICRO)]
    jp = jax_tree_map(jnp.asarray, p)
    losses, grads = [], []
    for part in parts:
        part = jax_tree_map(jnp.asarray, part)
        jloss, jgrads = jax.value_and_grad(
            lambda q: jad.loss(q, part, remat=True))(jp)
        losses.append(float(jloss))
        grads.append(jgrads)
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(grads[0])[0]:
        key = "/".join(k.key for k in path)
        want[key] = np.mean([np.asarray(_at(g, path)) for g in grads], 0) \
            if len(grads) > 1 else np.asarray(_at(grads[0], path))
    return float(np.mean(losses)) if len(losses) > 1 else losses[0], want


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_step_matches_jax_value_and_grad(runs, arch):
    """The 2x2 mesh's first step (2 microbatches of 2 rows, each split
    over 2 data ranks) against jax.value_and_grad of the reference's loss
    on the whole batch: the mean of equal microbatches' means."""
    jloss, want = _jax_value_and_grad(runs, arch)
    got = runs["meshes"]["2x2"][arch]
    assert got["loss"] == pytest.approx(jloss, rel=LOSS_TOL)
    _close_leaves(got["grads"], want)


@pytest.mark.parametrize("arch,mesh", [
    (a, m) for a, m in TRAIN_RUNS if m in TP_MESHES
    and (a in TP_CASES or m == "1x2")])
def test_tp_step_matches_jax_value_and_grad(runs, arch, mesh):
    """The first step on a model axis of 2 (each rank on its model shards
    where the arch splits, ``ON_SHARDS``) against jax.value_and_grad, at
    the training tolerances."""
    jloss, want = _jax_value_and_grad(runs, arch)
    got = runs["meshes"][mesh][arch]
    assert got["shards"] == ON_SHARDS[arch]
    assert got["loss"] == pytest.approx(jloss, rel=LOSS_TOL)
    _close_leaves(got["grads"], want)


def _model_split(arch, mesh) -> dict:
    """{leaf path: whole shape} of the leaves whose spec splits them over
    the model axis of `mesh` (by constrain_entries' rule)."""
    data, model = port_mesh.parse_mesh(mesh)
    cfg = worker.fp32_cfg(arch)
    ad = get_adapter(cfg)
    params = dict(_leaves(ad.init(torch.Generator().manual_seed(0),
                                  tp=model)))
    out = {}
    for path, spec in _leaves(ad.param_specs("data", model)):
        entries = sharding.constrain_entries(
            spec, tuple(params[path].shape), {"data": data, "model": model})
        if any("model" in sharding._axes(e) for e in entries):
            out["/".join(path)] = tuple(params[path].shape)
    return out


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, m in TRAIN_RUNS
                                       if m in TP_MESHES])
def test_tp_step_computes_on_model_shards(runs, arch, mesh):
    """On a model axis of 2, every rank's forward sees 1/2 of each leaf
    split over model (its bytes half the whole) and every other leaf
    whole, and rwkv6's scan runs on 1 of the 2 heads a rank; where the
    arch does not split (rwkv6-3b at d_model 64: one head) every rank
    sees every leaf whole. qwen2-7b with one KV head keeps wk and wv
    whole on every rank."""
    got = runs["meshes"][mesh][arch]
    data = port_mesh.parse_mesh(mesh)[0]
    assert got["shards"] == ON_SHARDS[arch]
    assert len(got["ranks"]) == 2 * data
    split = _model_split(arch, mesh)
    whole = {"/".join(p): tuple(t.shape)
             for p, t in _leaves(runs["inputs"][arch][0])}
    assert split and set(split) < set(whole)
    if arch == "qwen2-7b-kv1":
        assert "blocks/attn/wk" not in split
        assert "blocks/attn/wq" in split
    for rank in got["ranks"]:
        seen = rank["shapes"]
        assert set(seen) == set(whole)
        for path, shape in whole.items():
            if got["shards"] and path in split:
                assert np.prod(seen[path]) * 2 == np.prod(shape), path
            else:
                assert seen[path] == shape, path
        if arch.startswith("rwkv6-3b"):
            heads = worker.fp32_cfg(arch).d_model // 64
            calls = rank["scan_heads"]
            # 2 layers x 2 microbatches, each layer's forward twice (remat)
            assert len(calls) == 8
            assert set(calls) == {heads // 2 if got["shards"] else heads}


def test_tp_collectives_are_adjoint_on_two_ranks(runs):
    """Each autograd collective's backward is the adjoint of its forward
    in fp64: <f(x), y> = <x, f*(y)>, a per-rank side summed over the
    ranks and a replicated side taken once; the output and gradient
    shapes are each rank's part."""
    got = runs["tp_collectives"]
    shapes = {"copy_to_model": ((3, 8, 5), (3, 8, 5)),
              "reduce_from_model": ((3, 8, 5), (3, 8, 5)),
              "gather_from_model": ((3, 8, 5), (3, 4, 5)),
              "slice_for_model": ((3, 4, 5), (3, 8, 5))}
    for name, want in shapes.items():
        lhs, rhs, fx_shape, xbar_shape = got[name]
        assert (fx_shape, xbar_shape) == want, name
        assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12), name
        assert abs(lhs) > 1e-3, name


def test_tp_collectives_are_the_identity_on_one_rank(runs):
    """On a model axis of one rank, and with no mesh, each collective
    returns its input itself: no op, no copy."""
    assert runs["tp_collectives"]["identity"] == {
        name: True for name in ("copy_to_model", "reduce_from_model",
                                "gather_from_model", "slice_for_model")}


def test_adamw_on_2x2_local_shards_matches_jax(runs):
    """AdamW over 3 steps (the last one clipped) on the 2x2 mesh's local
    shards, UPDATE_ELEMS = 7: the global norm counts each element once."""
    tree, _, grads = runs["opt"]
    jp = jax_tree_map(jnp.asarray, tree)
    js = jax_adamw_init(jp)
    for g in grads:
        jp, js = jax_adamw_update(jp, jax_tree_map(jnp.asarray, g), js,
                                  lr=1e-2)
    got = runs["adamw_2x2"]
    assert got["step"] == int(js.step) == 3
    for name, want in (("params", jp), ("mu", js.mu), ("nu", js.nu)):
        for k, w in want.items():
            g = got[name][k]
            g = g.view(np.uint16).view(jnp.bfloat16) if g.dtype == np.int16 \
                else g
            np.testing.assert_allclose(
                np.asarray(jnp.asarray(g, jnp.float32)),
                np.asarray(w, np.float32), rtol=OPT_TOL, atol=OPT_TOL)


# --- elastic resume ----------------------------------------------------------

def test_elastic_resume_on_1x2_bit_equal(runs):
    assert runs["save_2x2"]["split_leaves"] > 0
    r = runs["resume_1x2"]
    assert r["mesh"] == (1, 2) and r["names"] == ("data", "model")
    assert r["n"] == r["n_witness"] and r["equal"]
    assert r["split_leaves"] > 0


def test_elastic_resume_on_1x1_bit_equal(runs):
    r = worker.resume(runs["ckpt"], runs["witness"], 1)
    assert r["mesh"] == (1, 1)
    assert r["n"] == r["n_witness"] and r["equal"]
    assert r["split_leaves"] == 0


def test_viable_meshes_and_shrink_match_reference(monkeypatch):
    monkeypatch.setattr(jax_elastic, "Mesh",
                        lambda devs, names: (devs.shape, names))
    for n in range(1, 17):
        assert elastic.viable_meshes(n) == jax_elastic.viable_meshes(n)
        for md in (16, 8, 6, 4, 3, 2, 1):
            shape, names = jax_elastic.shrink_mesh(n, md,
                                                   devices=list(range(n)))
            assert elastic.shrink_shape(n, md) == shape
            assert names == ("data", "model")


# --- init and specs against the reference ------------------------------------

def _shapes(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_init_tp3_matches_reference_shapes(arch):
    """init(tp=3) pads the query heads (4 in the reduced configs) to 6, as
    the reference's init(key, tp=3) does, in every family."""
    jad = jax_get_adapter(jax_reduced(JAX_ARCHS[arch]))
    ad = get_adapter(reduced(ALL_ARCHS[arch]))
    want = jax.eval_shape(lambda: jad.init(jax.random.PRNGKey(0), tp=3))
    got = ad.init(torch.Generator().manual_seed(0), tp=3)
    assert _shapes(got) == _shapes(want)
    assert _shapes(got) != _shapes(ad.init(torch.Generator().manual_seed(0)))\
        or ad.cfg.family == "ssm"


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_decode_state_tp3_matches_reference_shapes(arch):
    jad = jax_get_adapter(jax_reduced(JAX_ARCHS[arch]))
    ad = get_adapter(reduced(ALL_ARCHS[arch]))
    want = jax.eval_shape(lambda: jad.init_decode_state(2, 16, tp=3))
    got = ad.init_decode_state(2, 16, device="cpu", tp=3)
    assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_specs_equal_reference(arch):
    jad = jax_get_adapter(jax_reduced(JAX_ARCHS[arch]))
    ad = get_adapter(reduced(ALL_ARCHS[arch]))
    for fsdp in (None, "data"):
        for tp in (16, 3, 2, 1):
            assert ad.param_specs(fsdp, tp) == jad.param_specs(fsdp, tp)
    assert ad.state_specs() == jad.state_specs()


# --- sharding vocabulary -----------------------------------------------------

class _FakeMesh:
    """What ``spec`` and ``constrain_entries`` read of a DeviceMesh."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def test_filter_spec_drops_missing_axes():
    for entries, names in [((("pod", "data"), None, "model"),
                            ("data", "model")),
                           (("pod",), ()), ((None, "x"), ("x",))]:
        assert sharding.filter_spec(entries, names) == \
            jax_sharding.filter_spec(entries, names)
    assert sharding.filter_spec((("pod", "data"), None, "model"),
                                ("data", "model")) == \
        (("data",), None, "model")


def test_spec_gives_placements():
    S, R = sharding.Shard, sharding.Replicate
    m = _FakeMesh((2, 4), ("data", "model"))
    assert sharding.spec(m, ("pod", "data"), None, "model") == (S(0), S(2))
    assert sharding.spec(m, None, None) == (R(), R())
    assert sharding.spec(m, ("data", "model")) == (S(0), S(0))
    # a mesh dim of one rank holds the whole tensor: Replicate
    assert sharding.spec(_FakeMesh((1, 4), ("data", "model")),
                         "data", "model") == (R(), S(1))
    pm = _FakeMesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.spec(pm, ("pod", "data"), "model") == (S(0), S(0), S(1))
    with pytest.raises(ValueError, match="twice"):
        sharding.spec(m, "data", "data")


def _reference_constrain(monkeypatch, entries, shape, sizes) -> tuple:
    """The reference's constrain_like on one leaf of `shape` under a mesh
    of `sizes`: the PartitionSpec it would constrain to, as a tuple."""
    seen = []
    monkeypatch.setattr(jax_sharding, "active_mesh", lambda: _FakeJaxMesh(
        sizes))
    monkeypatch.setattr(jax_sharding, "mesh_axis_sizes", lambda m: sizes)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, p: seen.append(tuple(p)) or x)
    jax_sharding.constrain_like({"x": np.empty(shape)}, {"x": entries})
    got = seen[0] if seen else (None,) * len(shape)
    return tuple(got) + (None,) * (len(shape) - len(got))


class _FakeJaxMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)


@pytest.mark.parametrize("sizes,entries,shape", [
    ({"data": 16, "model": 16}, (("pod", "data"),), (1,)),
    ({"data": 16, "model": 16}, (None, "model"), (8, 40)),
    ({"data": 16, "model": 16}, (("pod", "data"), None), (128, 4)),
    ({"data": 4, "model": 4}, ("data", ("data", "model")), (8, 8)),
    ({"data": 2, "model": 2}, ("model", "data"), (256, 64)),
    ({"data": 2, "model": 2}, (None, ("data", "model"), None), (3, 4, 4)),
    ({"data": 2, "model": 2}, (None, ("data", "model")), (3, 6)),
    ({"pod": 2, "data": 2, "model": 2}, (("pod", "data"), "model"), (8, 3)),
    ({"data": 2, "model": 2}, ("data",), (4, 4, 4)),
])
def test_constrain_rule_matches_reference(monkeypatch, sizes, entries,
                                          shape):
    got = sharding.constrain_entries(entries, shape, sizes)
    assert got == _reference_constrain(monkeypatch, entries, shape, sizes)
    flat = [a for e in got if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    assert len(flat) == len(set(flat))


def test_constrain_like_places_on_the_active_mesh():
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.constrain_like({"x": x}, {"x": ("data", "model")}) \
        == {"x": x}                                  # no active mesh
    assert sharding.shard_hint(x, "data", None) is x
    with sharding.use_mesh(mesh):
        placed = sharding.constrain_like({"x": x}, {"x": ("data", "model")})
        assert isinstance(placed["x"], sharding.DTensor)
        assert sharding.local(placed["x"]).data_ptr() == x.data_ptr()
        assert sharding.gather(placed["x"]).data_ptr() == x.data_ptr()
        assert sharding.shard_hint(x, "data", None) is x
    assert sharding.active_mesh() is None


def test_padding_policies_match_reference():
    for n, tp in [(28, 16), (40, 16), (12, 16), (32, 16), (4, 3), (8, 1)]:
        assert sharding.padded_heads(n, tp) == \
            jax_sharding.padded_heads(n, tp)
        assert sharding.padded_kv_heads(n, tp) == \
            jax_sharding.padded_kv_heads(n, tp)
    assert sharding.padded_vocab(51865) == jax_sharding.padded_vocab(51865)


# --- process groups: nothing falls back -------------------------------------

def test_mesh_of_another_size_than_the_world_raises():
    port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        port_mesh.make_mesh((2, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="differ in length"):
        port_mesh.make_mesh((1,), ("data", "model"), "cpu")


def test_failing_nccl_group_raises_without_gloo(monkeypatch):
    calls = []

    def failing(backend, **kwargs):
        calls.append(backend)
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(port_mesh, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group", failing)
    monkeypatch.setattr(port_mesh.torch.cuda, "set_device", lambda i: None)
    with pytest.raises(RuntimeError, match="NCCL"):
        port_mesh.init_process_group("cuda")
    assert calls == ["nccl"]


@pytest.mark.parametrize("launcher", [True, False],
                         ids=["launcher_env", "one_process"])
def test_process_group_from_the_environment(monkeypatch, launcher):
    """With a launcher's variables (torchrun's) the group joins them by
    env://; without, it is this process alone on a HashStore."""
    calls = []
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "4"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        if launcher:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    port_mesh.init_process_group("cpu")
    [(backend, kw)] = calls
    assert backend == "gloo"
    if launcher:
        assert kw == {"init_method": "env://"}
    else:
        assert kw["rank"] == 0 and kw["world_size"] == 1
        assert isinstance(kw["store"], port_mesh.dist.HashStore)


def test_driver_refuses_a_multi_card_mesh_on_cuda(monkeypatch):
    monkeypatch.setattr(port_train, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="one card"):
        port_train.build("rwkv6-3b", True, 2, 1e-3, (2, 1), "cuda")


def test_parse_mesh():
    assert port_train.parse_mesh("1x1") == (1, 1)
    assert port_train.parse_mesh("4") == (4,)
    with pytest.raises(ValueError):
        port_train.parse_mesh("2x2x2")


# --- serving on a mesh --------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_mesh_decode_matches_single_process_and_jax(runs, mesh, arch):
    """Eight steps, tensor-parallel on the model axis and context-parallel
    over the cache's slots, each rank its rows: logits within 1e-5 of the
    single-process port and of JAX's decode_step."""
    got = runs["serve"][mesh][arch]["logits"]
    ref = runs["serve_ref"][arch]
    assert got.shape == ref["single"].shape
    for name in ("single", "jax"):
        np.testing.assert_allclose(got, ref[name], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=name)


@pytest.mark.parametrize("arch", sorted(SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_mesh_serve_tokens_match_jax_driver(runs, mesh, arch):
    got = runs["serve"][mesh][arch]
    want = runs["serve_ref"][arch]["tokens"]
    assert got["tokens"] == want
    assert len(want) == worker.SERVE_REQUESTS
    assert got["steps"] == worker.SERVE_REQUESTS // worker.SERVE_SLOTS \
        * worker.SERVE_NEW


def _split_dims(arch, mesh) -> dict:
    """{leaf path: the dims the model axis splits} under param_specs(tp)
    by constrain_entries' rule on the mesh's sizes."""
    data, model = port_mesh.parse_mesh(mesh)
    ad = get_adapter(worker.fp32_cfg(arch))
    specs = dict(_leaves(ad.param_specs(None, model)))
    params = dict(_leaves(runs_params(arch)))
    out = {}
    for path, spec in specs.items():
        entries = sharding.constrain_entries(
            spec, tuple(params[path].shape), {"data": data, "model": model})
        out["/".join(path)] = [i for i, e in enumerate(entries)
                               if "model" in sharding._axes(e)]
    return out


def runs_params(arch):
    return get_adapter(worker.fp32_cfg(arch)).init(
        torch.Generator().manual_seed(0), tp=2)


@pytest.mark.parametrize("arch", sorted(SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_mesh_rank_holds_its_share(runs, mesh, arch):
    """Every weight with a model spec that divides is 1/model on the rank
    (the rest whole), so its bytes are 1/model; the cache has S/model
    slots of its rows, and the step sees the whole S."""
    data, model = port_mesh.parse_mesh(mesh)
    got = runs["serve"][mesh][arch]
    full = {"/".join(p): tuple(t.shape)
            for p, t in _leaves(runs["serve_in"][arch][0])}
    split = _split_dims(arch, mesh)
    assert set(got["local"]) == set(full)
    for path, shape in full.items():
        want = tuple(n // model if i in split[path] else n
                     for i, n in enumerate(shape))
        assert got["local"][path] == want, path
    if model > 1:
        for path in ("embed", "lm_head", "blocks/attn/wq", "blocks/attn/wo",
                     "blocks/ffn/w_gate", "blocks/ffn/w_down"):
            assert split[path], path
        local = sum(np.prod(got["local"][p]) for p in split if split[p])
        whole = sum(np.prod(full[p]) for p in split if split[p])
        assert local * model == whole
    S = SERVE_ARCHS[arch]
    cfg = worker.fp32_cfg(arch)
    assert got["cache"] == (cfg.n_layers, DECODE_B // data, cfg.n_kv_heads,
                            S // model, cfg.resolved_head_dim)
    assert got["cache_seq"] == S


@pytest.mark.parametrize("arch", worker.DATA_ONLY_ARCHS)
def test_data_mesh_serves_every_family(runs, arch):
    """On 2x1 each rank decodes its row of the slots (its share of the
    recurrent, SSM, conv and cross states): the one-process tokens."""
    mesh_tokens, single_tokens = runs["serve"]["2x1"]["families"][arch]
    assert mesh_tokens == single_tokens
    assert len(single_tokens) == worker.SERVE_REQUESTS


@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_serve_driver_runs_on_the_mesh(runs, mesh):
    assert runs["serve"][mesh]["driver"] == 0


def test_serve_driver_refuses_a_multi_card_mesh_on_cuda(monkeypatch):
    monkeypatch.setattr(port_serve, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="one card"):
        port_serve.main(["--reduced", "--mesh", "1x2"])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_serve_driver_on_a_model_axis_serves_what_splits(runs, arch):
    """On 1x2 the serve driver runs reduced granite-moe-3b, zamba2,
    whisper and mllama to exit code 0 (zamba2's tokens are held against
    the JAX driver's in tests/test_torch_zamba2_tp.py, whisper's and
    mllama's also in tests/test_torch_cross_tp.py); whisper's and
    mllama's serve loops on 1x2 emit their one-process tokens, and
    rwkv6-3b at d_model 128 (2 heads) serves its one-process tokens on
    1x2; reduced rwkv6-3b's one head does not split, and the serve driver
    says so."""
    got = runs["serve"]["1x2"]["drivers"][arch]
    if arch == "rwkv6-3b":
        assert "heads" in got and "do not split" in got
        arch = "rwkv6-3b-d128"
    else:
        assert got == 0
    if arch == "zamba2-1.2b":
        return
    if arch in worker.CROSS_ARCHS:
        mesh_tokens, single_tokens = runs["serve"]["1x2"]["cross_tokens"][
            arch]
        assert mesh_tokens == single_tokens
        assert len(single_tokens) == worker.SERVE_REQUESTS
        return
    assert runs["serve"]["1x2"][arch]["tokens"] \
        == runs["serve_ref"][arch]["tokens"]


def test_one_by_one_mesh_step_is_the_meshless_step(monkeypatch):
    """On a 1x1 mesh the serve loop and the decode step are the meshless
    ones: the same products and attention calls, no partial attention and
    no collective, the same cache (plain tensors) and bit-equal logits and
    tokens."""
    assert _one_by_one_decode(monkeypatch, "qwen2-7b") == {
        "rowstream_matmul", "flash_decode"}


@pytest.mark.parametrize("arch,launched", [
    ("granite-moe-3b-a800m", {"rowstream_matmul", "flash_decode"}),
    ("rwkv6-3b", {"rowstream_matmul"}),
    ("zamba2-1.2b", {"rowstream_matmul", "flash_decode"}),
    ("whisper-small", {"rowstream_matmul", "flash_decode"}),
    ("llama-3.2-vision-90b", {"rowstream_matmul", "flash_decode"})])
def test_one_by_one_mesh_step_is_the_meshless_step_for(monkeypatch, arch,
                                                       launched):
    """The 1x1 check above for the MoE family, rwkv6, zamba2, whisper and
    mllama: the same calls, no collective (the MoE's routing gathers and
    expert sums, rwkv6's head gather and row-parallel sums, zamba2's
    gated-norm and out_proj sums, whisper's and mllama's head gathers,
    partial merges and row-parallel sums included), bit-equal logits and
    tokens, and zamba2's placement keeping the parameters' storage (no
    by-parts copy)."""
    assert _one_by_one_decode(monkeypatch, arch) == launched


def _one_by_one_decode(monkeypatch, arch) -> set:
    """Decode and serve reduced fp32 `arch` meshless and on a 1x1 mesh;
    assert the same calls (kernels, the MoE's collectives, any process
    group collective) and bit-equal logits, tokens and plain-tensor
    states; return the names called."""
    calls = []
    for mod, names in ((layers, ("rowstream_matmul", "flash_decode",
                                 "flash_decode_partial", "all_gather",
                                 "all_reduce_sum", "all_reduce_max")),
                       (transformer, ("all_gather", "all_reduce_sum")),
                       (moe, ("all_gather", "all_reduce_sum",
                              "copy_to_model", "reduce_from_model")),
                       (whisper, ("all_gather", "all_reduce_sum")),
                       (mllama, ("all_gather", "all_reduce_sum")),
                       (torch.distributed, ("all_reduce", "all_gather"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                                calls.append(_n) or _fn(*a, **k))
    if arch == "rwkv6-3b":
        _, cfg, p = rwkv_bridged(64)
    elif arch == "zamba2-1.2b":
        _, cfg, p = zamba_bridged("float32")
    elif arch == "whisper-small":
        _, cfg, p = whisper_bridged("float32")
    elif arch == "llama-3.2-vision-90b":
        _, cfg, p = mllama_bridged("float32")
    else:
        _, cfg, p = dense_bridged(arch)
    params = bridge.to_torch(p, "cpu")
    ad = get_adapter(cfg)
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    placed = port_serve.place_params(ad, params, mesh, 1)
    assert all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
               for (_, a), (_, b) in zip(_leaves(placed), _leaves(params)))
    runs_by = {}
    for m, params in ((None, params), (mesh, placed)):
        calls.clear()
        cache = ad.init_decode_state(2, 16, device="cpu", mesh=m)
        assert all(type(t) is torch.Tensor for t in cache.values())
        tok = torch.tensor([[3], [5]], dtype=torch.int32)
        logits = []
        for pos in range(3):
            lg, cache = ad.decode(params, {"tokens": tok}, cache, pos, m)
            logits.append(lg)
            tok = port_serve.greedy_sample(lg)[:, None]
        run = port_serve.serve(cfg, params, port_serve.make_requests(
            3, 16, 4, cfg.vocab, 0), 2, 16, "cpu", m)
        runs_by[m is None] = (torch.stack(logits), list(calls),
                              {r.rid: r.out_tokens
                               for r in run.batcher.completed})
    (l0, c0, t0), (l1, c1, t1) = runs_by[True], runs_by[False]
    assert torch.equal(l0, l1) and c0 == c1 and t0 == t1
    return set(c0)


# --- tensor-parallel training: the paths and the 1x1 step ------------------

@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_train_tp_path_by_family(arch):
    """Which reduced archs compute on the shards of a model axis of 2: the
    dense and MoE families (8 experts, split 4 a rank) and zamba2 (8 SSM
    heads, 4 a rank); rwkv6-3b at d_model 128 but not at 64 (one head);
    the VLM and audio families not yet. On
    a model axis of one rank none does. An MoE whose experts and FFN
    width both do not split gathers whole, with the reason."""
    cfg = reduced(ALL_ARCHS[arch])
    on, why = registry.train_tp_path(cfg, 2)
    assert on == (cfg.family in ("dense", "moe", "hybrid"))
    assert cfg.name in why
    if cfg.moe:
        odd = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3, expert_d_ff=63))
        off, reason = registry.train_tp_path(odd, 2)
        assert not off and "neither its 3 experts" in reason
        assert get_adapter(worker.fp32_cfg("granite-moe-e3")) \
            .supports_train_tp(2)
    assert get_adapter(cfg).supports_train_tp(2) == on
    assert not get_adapter(cfg).supports_train_tp(1)
    if cfg.family == "ssm":
        assert "heads" in why
        assert get_adapter(worker.fp32_cfg("rwkv6-3b-d128")) \
            .supports_train_tp(2)


def test_forward_on_a_model_axis_refuses_what_does_not_split():
    """A family without a forward on model shards raises on a model axis of
    several ranks with the reason (the train step gathers its parameters
    whole instead); on a model axis of one rank the forward is the
    single-process one."""
    cfg = reduced(ALL_ARCHS["whisper-small"], dtype="float32")
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "frames": torch.randn((1, cfg.n_audio_frames, cfg.d_model),
                                   generator=torch.Generator()
                                   .manual_seed(1))}
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ad.forward(params, batch, mesh=ModelAxis(2))
    assert torch.equal(ad.forward(params, batch, mesh=ModelAxis(1)),
                       ad.forward(params, batch))


@pytest.mark.parametrize("arch", ARCHS + ["granite-moe-3b-a800m"])
def test_one_by_one_mesh_train_step_is_the_meshless_step(monkeypatch, arch):
    """On a 1x1 mesh the driver's step (which computes on model shards
    where the family can) gathers every parameter whole, passes no mesh
    to the loss and runs no collective: its loss and gradients are the
    meshless step's bit for bit."""
    from repro_torch.train import train_step as ts_mod
    calls = []
    for name in ("all_reduce", "all_gather"):
        fn = getattr(torch.distributed, name)
        monkeypatch.setattr(torch.distributed, name,
                            lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    monkeypatch.setattr(ts_mod, "gather_batch",
                        lambda x: calls.append("gather_batch") or x)
    cfg = worker.fp32_cfg(arch)
    ad = get_adapter(cfg)
    params, batch = (bridge.to_torch(_bridged(arch)[2], "cpu"),
                     parity_batch(cfg.vocab))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []

    def loss_fn(p, b, *mesh):
        losses.append(mesh)
        return ad.loss(p, b, True, *mesh)

    want = accumulate(loss_fn, params, batch, worker.MICRO)
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    placed = sharding.constrain_like(params, ad.param_specs("data", 1), mesh)
    got = accumulate(loss_fn, placed, batch, worker.MICRO, shards=True)
    assert not calls and losses == [()] * (2 * worker.MICRO)
    assert torch.equal(got[0], want[0])
    for (_, g), (_, w) in zip(_leaves(got[1]), _leaves(want[1])):
        assert torch.equal(sharding.local(g), w)


# --- the MoE family and rwkv6 on a mesh ---------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_moe_groups_span_the_data_axis_as_jax(runs, mesh, arch):
    """The repair: where the batch axes split each microbatch's rows, the
    routing groups and their capacity are still the whole microbatch's,
    as the reference forms them. On the parity batch, whose single-process
    routing drops assignments, the first step equals the single-process
    step and JAX's microbatched value_and_grad, and the driver's losses
    the single-process driver's."""
    assert runs["single"][arch]["dropped"] > 0
    got = runs["meshes"][mesh][arch]
    jloss, want = _jax_value_and_grad(runs, arch)
    for ref_loss, ref in ((runs["single"][arch]["loss"],
                           runs["single"][arch]["grads"]), (jloss, want)):
        assert got["loss"] == pytest.approx(ref_loss, rel=LOSS_TOL)
        _close_leaves(got["grads"], ref)


@pytest.mark.parametrize("arch,mesh", [
    (a, m) for a in MOE_ARCHS + ["granite-moe-e3"] for m in TP_MESHES])
def test_moe_router_gradient_on_model_shards(runs, arch, mesh):
    """The router is whole on every rank, but each rank's combine reaches
    only its own experts (or FFN columns): its gradient, summed over the
    model axis, is the single-process step's and JAX's."""
    got = runs["meshes"][mesh][arch]
    assert got["shards"]
    key = "blocks/moe/router"
    _, want = _jax_value_and_grad(runs, arch)
    for ref in (runs["single"][arch]["grads"][key], want[key]):
        _close_leaves({key: got["grads"][key]}, {key: ref})


def _same_gates(ranks, model: int):
    """Every group of ranks at one place on the batch axes (the model
    axis's ranks) recorded the same experts, call for call."""
    by_row = {}
    for data, gates in ranks:
        by_row.setdefault(data, []).append(gates)
    assert all(len(v) == model for v in by_row.values())
    for gates in by_row.values():
        first = gates[0]
        assert first and all(len(g) == len(first) for g in gates)
        for other in gates[1:]:
            assert all(torch.equal(a, b) for a, b in zip(first, other))


@pytest.mark.parametrize("arch,mesh", [
    (a, m) for a in MOE_ARCHS + ["granite-moe-e3"] for m in TP_MESHES])
def test_moe_train_ranks_route_alike(runs, arch, mesh):
    got = runs["meshes"][mesh][arch]
    _same_gates([(r["data"], r["gates"]) for r in got["ranks"]], 2)


@pytest.mark.parametrize("arch", sorted(TP_SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_tp_family_decode_matches_single_process_and_jax(runs, mesh, arch):
    """Eight steps of the MoE family (experts split by expert or by FFN
    width) and rwkv6 (on its heads) at the driver's 4 slots, each rank
    its rows: logits within 1e-5 of the single-process port and of JAX's
    decode_step. The MoE's single-process routing drops assignments on
    these tokens, so on 2x1 and 2x2 the groups must span the data axis."""
    got = runs["serve"][mesh][arch]["logits"]
    ref = runs["serve_ref"][arch]
    if arch in MOE_SERVE:
        assert ref["dropped"] > 0
    assert got.shape == ref["single"].shape
    for name in ("single", "jax"):
        np.testing.assert_allclose(got, ref[name], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=name)


@pytest.mark.parametrize("arch", sorted(TP_SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_tp_family_serve_tokens_match_jax_driver(runs, mesh, arch):
    got = runs["serve"][mesh][arch]
    want = runs["serve_ref"][arch]["tokens"]
    assert got["tokens"] == want
    assert len(want) == worker.SERVE_REQUESTS
    slots = worker.serve_slots(arch)
    assert got["steps"] == -(-worker.SERVE_REQUESTS // slots) \
        * worker.SERVE_NEW


@pytest.mark.parametrize("arch", MOE_SERVE)
@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_moe_decode_ranks_route_alike(runs, mesh, arch):
    """Every rank of the model axis chooses the same experts for the same
    token at every layer and step."""
    _same_gates(runs["serve"][mesh][arch]["gates"], 2)


@pytest.mark.parametrize("arch", sorted(TP_SERVE_ARCHS))
@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_tp_family_rank_holds_its_share(runs, mesh, arch):
    """The MoE's expert leaves hold E / model experts, or where model does
    not divide E each expert's FFN width / model; the router is whole.
    rwkv6's state holds H / model heads of the rank's rows, its token-shift
    states whole."""
    data, model = port_mesh.parse_mesh(mesh)
    got = runs["serve"][mesh][arch]
    cfg = worker.fp32_cfg(arch)
    b = DECODE_B // data
    if cfg.moe:
        L = cfg.n_layers
        for name, shape in moe.shard_shapes(cfg, model).items():
            assert got["local"][f"blocks/moe/{name}"] == (L,) + shape, name
        assert got["local"]["blocks/moe/router"] == (
            L, cfg.d_model, cfg.moe.n_experts)
        if cfg.moe.n_experts % model == 0:
            assert moe.shard_shapes(cfg, model)["w_gate"][0] \
                == cfg.moe.n_experts // model
        assert got["cache"] == (L, b, cfg.n_kv_heads, 8 // model,
                                cfg.resolved_head_dim)
    else:
        H = cfg.d_model // 64
        assert got["state"] == {
            "x_tm": (cfg.n_layers, b, cfg.d_model),
            "x_cm": (cfg.n_layers, b, cfg.d_model),
            "S": (cfg.n_layers, b, H // model, 64, 64)}
        assert got["local"]["blocks/wr"][-1] == cfg.d_model // model
        assert got["local"]["blocks/wo"][-2] == cfg.d_model // model


def test_decode_refuses_shapes_that_do_not_split():
    """A model axis that divides neither an MoE's experts nor their FFN
    width, or not rwkv6's heads (reduced rwkv6-3b has one), is refused
    with the reason, as train_tp_refusal words it."""
    cfg = reduced(ALL_ARCHS["granite-moe-3b-a800m"], dtype="float32")
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=3, expert_d_ff=63))
    params = get_adapter(odd).init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="neither its 3 experts"):
        transformer.decode_step(params, odd, torch.zeros((1, 1), dtype=
                                torch.int64), {}, 0, ModelAxis(2))
    rcfg = reduced(ALL_ARCHS["rwkv6-3b"], dtype="float32")
    with pytest.raises(NotImplementedError, match="heads"):
        rwkv6.init_state(rcfg, 2, "cpu", ModelAxis(2))
    assert rwkv6.train_tp_refusal(rcfg, 2) is not None


def test_moe_gather_impl_refuses_a_model_axis():
    """impl="gather" (the reference keeps it for single-device serving
    research) computes on whole experts only: a model axis of 2 is
    refused before any collective; on one rank it is the einsum's
    routing."""
    cfg = reduced(ALL_ARCHS["granite-moe-3b-a800m"], dtype="float32")
    params = get_adapter(cfg).init(torch.Generator().manual_seed(0))
    bp = transformer._index(params["blocks"], 0)["moe"]
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with pytest.raises(NotImplementedError, match="gather"):
        moe.moe_ffn(bp, x, cfg, impl="gather", mesh=ModelAxis(2))
    torch.testing.assert_close(moe.moe_ffn(bp, x, cfg, impl="gather",
                                           mesh=ModelAxis(1)),
                               moe.moe_ffn(bp, x, cfg))
