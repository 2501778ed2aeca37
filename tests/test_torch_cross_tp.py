"""whisper (the audio family) and llama-3.2-vision (the VLM family) decoding
on a model axis of several ranks, on the CPU: ``models/whisper.py``'s and
``models/mllama.py``'s decode steps on each rank's shards,
``layers.cross_decode_attention`` and ``layers.cross_kv_layout`` on a
cross KV laid out as the reference lays it out, ``launch/serve.py``'s
placement and ``models/registry.py``'s paths, held against the
single-process port and against JAX.

Reduced fp32 configs (whisper: 4 heads, 2 decoder layers; mllama: 4 query
and 2 KV heads, so wk and wv stay whole on a model axis of 4, two units of
one self and one cross layer), their constant leaves seeded, the cross KV
filled from seeded encoder output or vision embeddings (a zero cross KV
makes every cross attention uniform and proves nothing). Each family at
the reduced cross length of 16, which every model axis here divides (the
cross KV split by sequence), and at 15 frames or 17 vision tokens, which
none does (the cross KV whole on every rank, as the reference's
divisibility rule keeps it). One 4-rank spawn (2x2 and 1x4) and one 2-rank
spawn (1x2 and 2x1) of ``_torch_dist_worker.py``:

* decode: 8 steps of 4 rows from an fp32 state on every mesh, against the
  single-process port and JAX's ``decode_step`` at 1e-5;
* each rank holds 1/model of every leaf ``param_specs`` splits and the
  whole of every other, its rows of the state, S/model slots of the self
  KV and, where the axis divides it, of the cross KV;
* each rank launches the meshless step's products and attention calls
  (the partial entry over its slots where the cache is split) and gathers
  nothing the size of a weight in a step;
* ``precompute_cross_kv(mesh)`` gives the single-process cross KV cut to
  the rank's rows and frames;
* the serve loop's greedy tokens equal the JAX driver's, and the serve
  driver runs on each mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as worker
from repro.compat import tree_map as jax_tree_map
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry_configs import ALL_ARCHS as JAX_ARCHS
from repro.models import mllama as jax_mllama
from repro.models import whisper as jax_whisper
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import mllama, registry, whisper
from repro_torch.models.registry import get_adapter
from repro_torch.train.optimizer import _leaves
from test_torch_cp_attention import ModelAxis
from test_torch_distributed import _jax_driver_tokens
from test_torch_mllama import bridged as mllama_bridged
from test_torch_whisper import bridged as whisper_bridged

WHISPER, MLLAMA = worker.CROSS_ARCHS
# The cross length that does not divide over 2 or 4 ranks, by arch.
ODD = {WHISPER: ("n_audio_frames", 15), MLLAMA: ("n_vision_tokens", 17)}
CASES = {f"{arch}/{n}": (arch, {} if n == 16 else {field: n})
         for arch, (field, odd) in ODD.items() for n in (16, odd)}
MESHES = ["2x2", "1x4", "1x2", "2x1"]
DECODE_STEPS, DECODE_B, MAX_SEQ = 8, 4, 8
DECODE_TOL = 1e-5
XKV_TOL = 1e-6


def _calls_of(step: list, name: str) -> list:
    return [what for n, what in step if n == name]


def _case_reference(arch, over, rng) -> tuple:
    """The workers' inputs of one case and its references: the port's
    single-process decode logits, kernel calls and cross KV, and JAX's
    decode logits, from the same seeded parameters and cross input."""
    jcfg = jax_reduced(JAX_ARCHS[arch], dtype="float32", **over)
    cfg = reduced(ALL_ARCHS[arch], dtype="float32", **over)
    seeded = (whisper_bridged if arch == WHISPER else mllama_bridged)(
        "float32")[2]
    jparams = jax_tree_map(jnp.asarray, seeded)
    params = bridge.to_torch(seeded, "cpu")
    jad, ad = jax_get_adapter(jcfg), get_adapter(cfg)
    if arch == WHISPER:
        frames = rng.standard_normal(
            (DECODE_B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        cross_in = np.asarray(jax_whisper.encode(jparams, jcfg,
                                                 jnp.asarray(frames)))
        jxk, jxv = jax_whisper.precompute_cross_kv(jparams, jcfg,
                                                   jnp.asarray(cross_in))
        mod = whisper
    else:
        cross_in = rng.standard_normal(
            (DECODE_B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        jxk, jxv = jax_mllama.precompute_cross_kv(jparams, jcfg,
                                                  jnp.asarray(cross_in))
        mod = mllama
    tokens = rng.integers(0, cfg.vocab, (DECODE_STEPS, DECODE_B, 1)
                          ).astype(np.int32)
    state = ad.init_decode_state(DECODE_B, MAX_SEQ, dtype=torch.float32,
                                 device="cpu")
    jstate = dict(jad.init_decode_state(DECODE_B, MAX_SEQ,
                                        dtype=jnp.float32), xk=jxk, xv=jxv)
    jstep = jax.jit(lambda p, t, c, pos: jad.decode(p, {"tokens": t}, c,
                                                    pos))
    single, want, steps = [], [], []
    with torch.inference_mode():
        xk, xv = mod.precompute_cross_kv(params, cfg,
                                         torch.from_numpy(cross_in))
        state["xk"].copy_(xk)
        state["xv"].copy_(xv)
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
    inputs = (arch, over, params, torch.from_numpy(cross_in),
              torch.from_numpy(tokens), MAX_SEQ)
    return inputs, {"cfg": cfg, "seeded": seeded, "single": np.stack(single),
                    "jax": np.stack(want), "steps": steps,
                    "xk": xk.numpy(), "xv": xv.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process references, then the 4-rank and 2-rank
    spawns."""
    tmp = tmp_path_factory.mktemp("cross_tp")
    rng = np.random.default_rng(7)
    inputs, refs = {}, {}
    for name, (arch, over) in CASES.items():
        inputs[name], refs[name] = _case_reference(arch, over, rng)
    plain = {arch: bridge.to_torch(jax_tree_map(np.asarray, jax_get_adapter(
        jax_reduced(JAX_ARCHS[arch], dtype="float32")).init(
            jax.random.PRNGKey(0), tp=1)), "cpu")
        for arch in worker.CROSS_ARCHS}
    torch.save((inputs, plain), tmp / "cross.pt")
    four = worker.spawn(4, str(tmp), [
        ("cross_decode", (str(tmp / "cross.pt"), ["2x2", "1x4"]))])
    two = worker.spawn(2, str(tmp), [
        ("cross_decode", (str(tmp / "cross.pt"), ["1x2", "2x1"]))])
    return {"refs": refs, "mesh": {**four["cross_decode"],
                                   **two["cross_decode"]},
            "driver_tokens": {arch: _jax_driver_tokens(arch)
                              for arch in worker.CROSS_ARCHS}}


CASE_MESHES = [(m, c) for m in MESHES for c in CASES]


@pytest.mark.parametrize("mesh,case", CASE_MESHES)
def test_decode_matches_single_process_and_jax(runs, mesh, case):
    """Eight steps on the mesh from a filled cross KV, each rank its rows,
    its heads and its slots of the self KV, the cross KV split by sequence
    where the model axis divides it and whole elsewhere: logits within
    1e-5 of the single-process port and of JAX's decode_step."""
    got = runs["mesh"][mesh][case]["logits"]
    ref = runs["refs"][case]
    assert got.shape == ref["single"].shape
    assert np.abs(ref["single"]).max() > 0.1
    for name in ("single", "jax"):
        np.testing.assert_allclose(got, ref[name], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=name)


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in worker.CROSS_ARCHS])
def test_serve_tokens_match_jax_driver(runs, mesh, arch):
    """The serve loop on the mesh emits the JAX driver's greedy tokens (its
    cross KV left zero, as the reference driver leaves it), and the serve
    driver runs there to its end."""
    got = runs["mesh"][mesh][arch]
    assert got["tokens"] == runs["driver_tokens"][arch]
    assert len(got["tokens"]) == worker.SERVE_REQUESTS
    assert got["driver"] == 0


def _cross_len(cfg) -> int:
    return cfg.n_audio_frames if cfg.family == "audio" \
        else cfg.n_vision_tokens


@pytest.mark.parametrize("mesh,case", CASE_MESHES)
def test_rank_holds_its_shards(runs, mesh, case):
    """Each rank holds 1/model of every leaf that param_specs splits over
    model under the reference's divisibility rule and the whole of every
    other leaf (mllama's wk and wv whole on a model axis of 4, its 2 KV
    heads not splitting), those bytes and no more; its state holds its
    rows, every head, S/model slots of the self KV and of the cross KV
    where the axis divides it (16 does, 15 and 17 do not), and the step
    sees the whole lengths."""
    ref = runs["refs"][case]
    cfg = ref["cfg"]
    data, n = port_mesh.parse_mesh(mesh)
    ad = get_adapter(cfg)
    whole = {"/".join(p): tuple(np.shape(t))
             for p, t in _leaves(ref["seeded"])}
    want = {}
    for path, spec in _leaves(ad.param_specs(None, n)):
        key = "/".join(path)
        entries = sharding.constrain_entries(spec, whole[key],
                                             {"data": data, "model": n})
        want[key] = tuple(d // n if "model" in sharding._axes(e) else d
                          for d, e in zip(whole[key], entries))
    split = {k for k in want if want[k] != whole[k]}
    if cfg.family == "audio":
        some = {"embed", "decoder/attn/wq", "decoder/xattn/wo",
                "decoder/mlp/w_down"}
        layers = (cfg.n_layers, cfg.n_layers)
        heads = whole["decoder/attn/wq"][-1] // cfg.resolved_head_dim
    else:
        some = {"embed", "lm_head", "self_blocks/attn/wq",
                "cross_blocks/attn/wo", "cross_blocks/ffn/w_gate"}
        k, n_units = mllama._pattern(cfg)
        layers = (n_units * (k - 1), n_units)
        heads = cfg.n_kv_heads
        assert ("cross_blocks/attn/wk" in split) == (n == 2)
    assert (some <= split) == (n > 1) and bool(split) == (n > 1)
    F = _cross_len(cfg)
    got = runs["mesh"][mesh][case]
    assert len(got["ranks"]) == data * n
    for rank in got["ranks"]:
        assert rank["local"] == want
        assert rank["bytes"] == 4 * sum(np.prod(s) for s in want.values())
        rows = DECODE_B // data
        self_kv = (layers[0], rows, heads, MAX_SEQ // n,
                   cfg.resolved_head_dim)
        cross_kv = (layers[1], rows, heads, F // n if F % n == 0 else F,
                    cfg.resolved_head_dim)
        assert rank["state"] == {"k": self_kv, "v": self_kv,
                                 "xk": cross_kv, "xv": cross_kv}
        assert rank["seq"] == {"k": MAX_SEQ, "v": MAX_SEQ, "xk": F, "xv": F}


@pytest.mark.parametrize("mesh,case", CASE_MESHES)
def test_rank_launches_the_meshless_calls(runs, mesh, case):
    """Each rank's step makes the meshless step's products and as many
    attention calls: the partial entry over its slots for the self KV
    (split) and for a cross KV that the model axis divides, the whole
    flash_decode at pos S - 1 for one it does not; no collective where the
    model axis holds one rank, and none of a step moves as many elements
    as one weight shard (no weight is gathered at decode)."""
    ref = runs["refs"][case]
    cfg = ref["cfg"]
    n = port_mesh.parse_mesh(mesh)[1]
    single = ref["steps"][0]
    n_rm = len(_calls_of(single, "rowstream_matmul"))
    n_fd = len(_calls_of(single, "flash_decode"))
    if cfg.family == "audio":
        n_self = n_cross = cfg.n_layers
        assert n_rm == 8 * cfg.n_layers + 1
    else:
        k, n_cross = mllama._pattern(cfg)
        n_self = n_cross * (k - 1)
        assert n_rm == 7 * n_self + 5 * n_cross + 1
    assert n_fd == n_self + n_cross
    assert not _calls_of(single, "flash_decode_partial")
    cross_split = n > 1 and _cross_len(cfg) % n == 0
    want_partial = (n_self if n > 1 else 0) + (n_cross if cross_split else 0)
    got = runs["mesh"][mesh][case]
    for rank in got["ranks"]:
        smallest = min(np.prod(s) for k, s in rank["local"].items()
                       if k.endswith("/wq"))
        assert len(rank["steps"]) == DECODE_STEPS
        for step in rank["steps"]:
            assert len(_calls_of(step, "rowstream_matmul")) == n_rm
            assert len(_calls_of(step, "flash_decode_partial")) \
                == want_partial
            assert len(_calls_of(step, "flash_decode")) \
                == n_fd - want_partial
            moved = _calls_of(step, "all_gather") \
                + _calls_of(step, "all_reduce")
            assert bool(moved) == (n > 1)
            assert max(moved, default=0) < smallest


@pytest.mark.parametrize("mesh,case", CASE_MESHES)
def test_precompute_cross_kv_is_the_rank_cut(runs, mesh, case):
    """precompute_cross_kv on the rank's shards and rows gives the
    single-process cross KV cut to the rank's rows and, where the model
    axis divides the cross length, to its frames or vision tokens; every
    head whole."""
    ref = runs["refs"][case]
    F = _cross_len(ref["cfg"])
    n = port_mesh.parse_mesh(mesh)[1]
    for rank in runs["mesh"][mesh][case]["ranks"]:
        r0, r1 = rank["rows"]
        f0, f1 = 0, F
        if n > 1 and F % n == 0:
            f0 = rank["model_rank"] * F // n
            f1 = f0 + F // n
        for name in ("xk", "xv"):
            want = ref[name][:, r0:r1, :, f0:f1]
            assert rank[name].shape == want.shape
            np.testing.assert_allclose(rank[name], want, rtol=XKV_TOL,
                                       atol=XKV_TOL, err_msg=name)


@pytest.mark.parametrize("arch", worker.CROSS_ARCHS)
def test_decode_refuses_parameters_not_split_for_the_axis(arch):
    """On a model axis of 2 the step takes this rank's shards as
    init(tp=2) and param_specs make them; whole parameters are refused
    with the leaves' shapes, not decoded."""
    cfg = reduced(ALL_ARCHS[arch], dtype="float32")
    seeded = (whisper_bridged if arch == WHISPER else mllama_bridged)(
        "float32")[2]
    params = bridge.to_torch(seeded, "cpu")
    mod = whisper if arch == WHISPER else mllama
    with pytest.raises(ValueError, match="split leaves hold"):
        mod.decode_step(params, cfg, torch.zeros((1, 1), dtype=torch.int64),
                        {}, 0, ModelAxis(2))


@pytest.mark.parametrize("arch", worker.CROSS_ARCHS)
def test_decode_mesh_admitted_and_training_still_gathers(arch):
    """check_decode_mesh admits both families on model axes of 2 and 4;
    their training on model shards is not in the port yet, so
    train_tp_path says so and the train step gathers whole."""
    cfg = reduced(ALL_ARCHS[arch])
    assert cfg.family in registry.TP_DECODE_FAMILIES
    for n in (2, 4):
        registry.check_decode_mesh(cfg, n)
        on, why = registry.train_tp_path(cfg, n)
        assert not on and "training yet" in why and "gathers" in why
        assert not get_adapter(cfg).supports_train_tp(n)
