"""Worker processes for tests/test_torch_distributed.py,
tests/test_torch_cp_attention.py, tests/test_torch_zamba2_tp.py and
tests/test_torch_cross_tp.py. Each joins a gloo process group through
a ``FileStore`` (a file, no network), runs one job of the port on a mesh
and, on rank 0, saves what the test compares. No JAX here: the workers
import only the port."""
from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import MoEConfig, reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import elastic_resume
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_mesh, parse_mesh
from repro_torch.models import layers, mllama, moe, rwkv6, whisper
from repro_torch.models.registry import get_adapter
from repro_torch.train import optimizer
from repro_torch.train.optimizer import _leaves, adamw_init, adamw_update
from repro_torch.train.train_step import (accumulate, state_specs,
                                          train_state_init)

# The driver's runs: the reference driver's batch at a short sequence, 8
# rows in 2 microbatches, each split over up to 2 data ranks.
SEQ, BATCH, MICRO, STEPS = 16, 8, 2, 3
# Training cases beside the reduced archs: (arch, overrides of reduced()).
# rwkv6-3b at d_model 128 has 2 heads, which split over a model axis of 2
# (at 64 it has 1, and the step gathers its parameters whole); qwen2-7b
# with one KV head holds wk and wv whole on every rank of that axis;
# granite-moe-3b with 3 experts, which do not split over 2, splits each
# expert's FFN width instead (reduced granite's 8 split by expert).
CASES = {"rwkv6-3b-d128": ("rwkv6-3b", {"d_model": 128}),
         "qwen2-7b-kv1": ("qwen2-7b", {"n_kv_heads": 1}),
         "granite-moe-e3": ("granite-moe-3b-a800m", {"moe": MoEConfig(
             n_experts=3, top_k=2, expert_d_ff=64)})}


def fp32_cfg(arch):
    name, overrides = CASES.get(arch, (arch, {}))
    return reduced(ALL_ARCHS[name], dtype="float32", **overrides)


def _full_np(tree) -> dict:
    """Each leaf gathered whole as numpy, bf16 as its int16 bits."""
    out = {}
    for p, t in _leaves(tree):
        t = sharding.gather(t)
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out["/".join(p)] = t.numpy().copy()
    return out


def _split_leaves(leaves) -> int:
    return sum(any(isinstance(p, sharding.Shard) for p in t.placements)
               for t in leaves if isinstance(t, sharding.DTensor))


def _seen(ad, mesh, record: dict):
    """The driver's loss on `mesh` (the mesh passed where the family
    computes on model shards), recording the shape of every parameter
    leaf the forward sees and the head count of each rwkv_scan call."""
    def loss_fn(params, batch, mesh=None):
        record["shapes"] = {"/".join(p): tuple(t.shape)
                            for p, t in _leaves(params)}
        return ad.loss(params, batch, remat=True, mesh=mesh)
    return loss_fn


@contextlib.contextmanager
def _gates(record: list):
    """``moe.route`` recording, for each call, the experts chosen for this
    rank's own tokens (top-k indices, one row a token)."""
    route = moe.route

    def recorded(*args, **kwargs):
        r = route(*args, **kwargs)
        idx = r.gate_idx.reshape(-1, r.gate_idx.shape[-1])
        if r.own is not None:
            idx = idx[r.own.reshape(-1)]
        record.append(idx.clone())
        return r

    moe.route = recorded
    try:
        yield
    finally:
        moe.route = route


def _scan_heads(record: dict):
    """rwkv6's rwkv_scan, recording each call's head count."""
    scan = rwkv6.rwkv_scan

    def counted(r, *args, **kwargs):
        record.setdefault("scan_heads", []).append(r.shape[2])
        return scan(r, *args, **kwargs)
    return counted


def meshes(inputs_path, plan):
    """For each mesh of `plan` ({mesh text: archs}) and each of its archs:
    the first step (loss and the fp32 mean gradient, gathered whole) from
    the bridged parameters placed as the driver places them, through the
    driver's loss (on model shards where the family computes on them);
    the driver's mesh axes and TP, the number of parameter leaves split
    over some mesh axis, whether the step computed on model shards, and
    from every rank the shapes of the leaves its forward saw, the head
    count of each rwkv_scan call, its place on the batch axes and the
    experts each MoE layer chose for its own tokens; and the driver's
    losses over STEPS steps from its own seeded init."""
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for text, archs in plan.items():
        res = out[text] = {}
        for arch in archs:
            _, ad, mesh, _, tp = port_train.build(
                fp32_cfg(arch), False, MICRO, 1e-3,
                port_train.parse_mesh(text), "cpu")
            params, batch = inputs[arch]
            placed = sharding.constrain_like(
                params, ad.param_specs("data", tp), mesh)
            split = _split_leaves(t for _, t in _leaves(placed))
            shards = ad.supports_train_tp(sharding.model_size(mesh))
            record = {"data": sharding.data_rows(mesh)[0], "gates": []}
            scan = rwkv6.rwkv_scan
            rwkv6.rwkv_scan = _scan_heads(record)
            try:
                with _gates(record["gates"]):
                    loss, grads = accumulate(
                        _seen(ad, mesh, record), placed,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        MICRO, shards)
            finally:
                rwkv6.rwkv_scan = scan
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, record)
            run = port_train.train(fp32_cfg(arch), steps=STEPS, seq_len=SEQ,
                                   global_batch=BATCH, microbatches=MICRO,
                                   device="cpu", mesh=text)
            res[arch] = {"loss": float(loss), "grads": _full_np(grads),
                         "split_leaves": split, "losses": run.losses,
                         "axes": mesh.mesh_dim_names, "tp": tp,
                         "shards": shards, "ranks": ranks}
    return out


def tp_collectives(seed):
    """The four autograd collectives of sharding.py in fp64 on the mesh's
    model axis: for each, f(x) and its backward f*(y) on this rank, where
    x and y are the same on every rank when they are replicated and differ
    when they are per-rank terms or shards; the inner products <f(x), y>
    and <x, f*(y)>, each summed over the ranks where its space is
    per-rank and taken once where it is replicated (so each side is the
    same on every rank). Then, on a mesh whose model axis holds one rank
    and with no mesh, whether each op returns its input itself."""
    world = dist.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    rank = sharding.model_rank(mesh)
    shared = torch.Generator().manual_seed(seed)
    own = torch.Generator().manual_seed(seed + 1 + rank)
    shape = (3, 4 * world, 5)

    def draw(replicated, shape=shape):
        return torch.randn(shape, generator=shared if replicated else own,
                           dtype=torch.float64)

    def inner(a, b, replicated):
        v = torch.sum(a * b).reshape(1)
        return v if replicated else sharding.sum_over(v, mesh, ("model",))

    part = (3, 4, 5)
    # op: (f, x replicated?, x shape, f(x) replicated?, y shape)
    ops = {"copy_to_model": (lambda x: sharding.copy_to_model(x, mesh),
                             True, shape, False, shape),
           "reduce_from_model": (lambda x: sharding.reduce_from_model(
               x, mesh), False, shape, True, shape),
           "gather_from_model": (lambda x: sharding.gather_from_model(
               x, mesh, 1), False, part, True, shape),
           "slice_for_model": (lambda x: sharding.slice_for_model(
               x, mesh, 1), True, shape, False, part)}
    out = {}
    for name, (f, x_rep, x_shape, y_rep, y_shape) in ops.items():
        x = draw(x_rep, x_shape).requires_grad_(True)
        y = draw(y_rep, y_shape)
        fx = f(x)
        (xbar,) = torch.autograd.grad(fx, x, y)
        out[name] = (float(inner(fx.detach(), y, y_rep)),
                     float(inner(x.detach(), xbar, x_rep)),
                     tuple(fx.shape), tuple(xbar.shape))
    one = make_mesh((world, 1), ("data", "model"), "cpu")
    x = torch.ones(2, 4)
    out["identity"] = {
        name: all(f is x for f in (op(x, m) for m in (one, None)))
        for name, op in (
            ("copy_to_model", sharding.copy_to_model),
            ("reduce_from_model", sharding.reduce_from_model),
            ("gather_from_model",
             lambda t, m: sharding.gather_from_model(t, m, 1)),
            ("slice_for_model",
             lambda t, m: sharding.slice_for_model(t, m, 1)))}
    return out


def adamw_2x2(inputs_path):
    """adamw_update over 3 steps on the 2x2 mesh's local shards, leaves
    updated UPDATE_ELEMS = 7 elements at a time; the parameters and
    moments gathered whole."""
    optimizer.UPDATE_ELEMS = 7
    tree, specs, grads = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = sharding.constrain_like(tree, specs, mesh)
    state = adamw_init(params)
    for g in grads:
        params, state = adamw_update(
            params, sharding.constrain_like(g, specs, mesh), state, lr=1e-2)
    return {"params": _full_np(params), "mu": _full_np(state.mu),
            "nu": _full_np(state.nu), "step": int(state.step)}


def save_2x2(ckpt_dir, witness_path):
    """Reduced bf16 rwkv6-3b trained one step on a 2x2 mesh and saved;
    rank 0 also keeps the state gathered whole (torch.save, apart from
    the checkpoint code)."""
    run = port_train.train("rwkv6-3b", use_reduced=True, steps=1,
                           seq_len=SEQ, global_batch=BATCH, device="cpu",
                           mesh="2x2", ckpt_dir=ckpt_dir, ckpt_every=1)
    leaves = [sharding.gather(t) for t in ckpt._flatten(run.state)]
    if dist.get_rank() == 0:
        torch.save(leaves, witness_path)
    return {"split_leaves": _split_leaves(ckpt._flatten(run.state))}


def resume(ckpt_dir, witness_path, n_devices):
    """The checkpoint restored into plain tensors, then resharded by
    elastic_resume onto n_devices ranks: each leaf gathered whole against
    the witness, bit for bit, and the new mesh's shape."""
    ad = get_adapter(reduced(ALL_ARCHS["rwkv6-3b"]))
    state = train_state_init(ad.init(torch.Generator().manual_seed(9)))
    ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir), state)
    specs = state_specs(ad.param_specs("data", 16))
    state, mesh = elastic_resume(state, specs, n_devices, device="cpu")
    witness = torch.load(witness_path, weights_only=False)
    leaves = ckpt._flatten(state)
    equal = [torch.equal(sharding.gather(t).view(torch.int16)
                         if t.dtype == torch.bfloat16 else sharding.gather(t),
                         w.view(torch.int16) if w.dtype == torch.bfloat16
                         else w)
             for t, w in zip(leaves, witness)]
    return {"mesh": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "n": len(leaves), "n_witness": len(witness),
            "equal": all(equal), "split_leaves": _split_leaves(leaves)}


# The serving checks: the reference driver's requests at the CPU parity
# tests' size (tests/test_torch_serve.py); the MoE family at the driver's
# 4 slots, where its routing drops assignments that 2 slots never would.
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_MAX_SEQ = 4, 2, 8, 128
MOE_SERVE_SLOTS = 4
# The families whose serve loop the data-mesh test runs on 2x1 against one
# process (test_data_mesh_serves_every_family): each rank its rows of the
# recurrent, SSM, conv and cross states.
DATA_ONLY_ARCHS = ("zamba2-1.2b", "whisper-small", "llama-3.2-vision-90b")
# The families whose serve loop also runs on a model axis of several ranks
# against one process, their cross KV on shards.
CROSS_ARCHS = ("whisper-small", "llama-3.2-vision-90b")
# The serve driver on a model axis of several ranks: granite, zamba2,
# whisper and mllama serve there (their code), reduced rwkv6-3b's one head
# does not split (the refusal).
MODEL_AXIS_DRIVERS = ("granite-moe-3b-a800m", "rwkv6-3b", "zamba2-1.2b") \
    + CROSS_ARCHS


def serve_slots(arch) -> int:
    return MOE_SERVE_SLOTS if fp32_cfg(arch).moe else SERVE_SLOTS


def _driver(arch, text):
    """The serve driver's exit code for reduced `arch` on the mesh, or the
    refusal it raises."""
    try:
        return port_serve.main(
            ["--arch", arch, "--reduced", "--device", "cpu", "--mesh", text,
             "--requests", str(SERVE_REQUESTS), "--slots",
             str(serve_slots(arch)), "--max-new", str(SERVE_NEW)])
    except NotImplementedError as e:
        return str(e)


def _data_mesh(text):
    return make_mesh(parse_mesh(text), ("data", "model"), "cpu")


def _served(arch, mesh) -> dict:
    """The serve loop's greedy tokens for reduced fp32 `arch` from its own
    seeded init, on `mesh` (None: one process; its shards where its model
    axis holds several ranks)."""
    cfg = fp32_cfg(arch)
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator().manual_seed(0))
    if mesh is not None:
        params = port_serve.place_params(ad, params, mesh,
                                         sharding.model_size(mesh))
    run = port_serve.serve(cfg, params, port_serve.make_requests(
        SERVE_REQUESTS, 16, SERVE_NEW, cfg.vocab, 0), SERVE_SLOTS,
        SERVE_MAX_SEQ, "cpu", mesh)
    return {r.rid: r.out_tokens for r in run.batcher.completed}


def serve_meshes(inputs_path, mesh_texts):
    """For each mesh and each arch of the inputs (reduced fp32; the
    reference's parameters, seeded and as its driver makes them; the
    tokens of each step; the cache's max_seq): the decode steps on the
    mesh from an fp32 cache, each rank its rows, the logits gathered over
    the data axis; the local shapes of the placed parameters and of the
    decode state, and the KV cache's whole S; from every rank its place on
    the batch axes and the experts each MoE layer chose for its own
    tokens; the serve loop's greedy tokens on the mesh (the reference
    driver's requests, a bf16 cache); and the serve driver's exit code on
    the mesh (its own seeded bf16 model), and on a model axis of several
    ranks that of granite-moe-3b and rwkv6-3b's refusal. On a mesh whose
    model axis holds one rank, also each data-only family's tokens served
    on the mesh and in one process."""
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for text in mesh_texts:
        mesh = _data_mesh(text)
        tp = parse_mesh(text)[-1]
        res = out[text] = {}
        for arch, (params, serve_params, tokens, max_seq) in inputs.items():
            cfg = fp32_cfg(arch)
            ad = get_adapter(cfg)
            placed = port_serve.place_params(ad, params, mesh, tp)
            b = tokens.shape[1]
            cache = ad.init_decode_state(b, max_seq, dtype=torch.float32,
                                         device="cpu", mesh=mesh)
            r0, r1 = sharding.batch_rows(b, mesh)
            logits, gates = [], []
            with torch.inference_mode(), _gates(gates):
                for pos, tok in enumerate(tokens):
                    lg, cache = ad.decode(placed, {"tokens": tok[r0:r1]},
                                          cache, pos, mesh)
                    logits.append(sharding.all_gather(
                        lg, mesh, sharding.BATCH_AXES, 0))
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, (sharding.data_rows(mesh)[0],
                                           gates))
            run = port_serve.serve(
                cfg, port_serve.place_params(ad, serve_params, mesh, tp),
                port_serve.make_requests(SERVE_REQUESTS, 16, SERVE_NEW,
                                         cfg.vocab, 0),
                serve_slots(arch), SERVE_MAX_SEQ, "cpu", mesh)
            res[arch] = {
                "logits": torch.stack(logits).numpy(),
                "local": {"/".join(p): tuple(t.shape)
                          for p, t in _leaves(placed)},
                "state": {k: tuple(sharding.local(t).shape)
                          for k, t in cache.items()},
                "gates": ranks,
                "tokens": {r.rid: r.out_tokens
                           for r in run.batcher.completed},
                "steps": run.batcher.steps}
            if "k" in cache:
                res[arch].update(cache=tuple(sharding.local(cache["k"]).shape),
                                 cache_seq=cache["k"].shape[3])
        if tp == 1:
            res["families"] = {arch: (_served(arch, mesh),
                                      _served(arch, None))
                               for arch in DATA_ONLY_ARCHS}
        res["driver"] = port_serve.main(
            ["--reduced", "--device", "cpu", "--mesh", text, "--requests",
             str(SERVE_REQUESTS), "--slots", str(SERVE_SLOTS), "--max-new",
             str(SERVE_NEW)])
        if tp > 1:
            res["drivers"] = {arch: _driver(arch, text)
                              for arch in MODEL_AXIS_DRIVERS}
            res["cross_tokens"] = {arch: (_served(arch, mesh),
                                          _served(arch, None))
                                   for arch in CROSS_ARCHS}
    return out


def cp_attention(inputs_path, mesh_texts):
    """``layers.cached_attention_update`` on each mesh for each case (q,
    k_new, v_new, caches, pos, slot) of the inputs: each rank its batch
    rows and its slots of the caches; the output gathered over the data
    axis and the caches over both, in fp32."""
    cases = torch.load(inputs_path, weights_only=False)
    out = {}
    for text in mesh_texts:
        mesh = _data_mesh(text)
        n, r = sharding.model_size(mesh), sharding.model_rank(mesh)
        res = out[text] = []
        for q, kn, vn, kc, vc, pos, slot in cases:
            r0, r1 = sharding.batch_rows(q.shape[0], mesh)
            s_loc = kc.shape[2] // n
            kl, vl = (c[r0:r1, :, r * s_loc:(r + 1) * s_loc].clone()
                      for c in (kc, vc))
            o = layers.cached_attention_update(
                q[r0:r1], kn[r0:r1], vn[r0:r1], kl, vl, pos, slot, mesh,
                kc.shape[2])
            gather = (lambda t: sharding.all_gather(sharding.all_gather(
                t, mesh, "model", 2), mesh, sharding.BATCH_AXES, 0))
            res.append((sharding.all_gather(o, mesh, sharding.BATCH_AXES, 0),
                        gather(kl), gather(vl), tuple(kl.shape)))
    return out


# --- zamba2 on a model axis (tests/test_torch_zamba2_tp.py) ----------------

ZAMBA = "zamba2-1.2b"


@contextlib.contextmanager
def _calls(record: list):
    """Append ("rowstream_matmul", w's shape), ("flash_decode", cache
    slots), ("flash_decode_partial", cache slots) for each kernel call of
    ``layers``, and ("all_gather" / "all_reduce", elements) for each
    process-group collective, in call order."""
    wrapped = [(layers, "rowstream_matmul", lambda x, w: tuple(w.shape)),
               (layers, "flash_decode", lambda q, k, *a: k.shape[2]),
               (layers, "flash_decode_partial", lambda q, k, *a: k.shape[2]),
               (dist, "all_gather", lambda parts, t, **k: t.numel()),
               (dist, "all_reduce", lambda t, **k: t.numel())]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]

    def wrap(fn, name, what):
        def call(*args, **kwargs):
            record.append((name, what(*args, **kwargs)))
            return fn(*args, **kwargs)
        return call

    for (mod, name, what), (_, _, fn) in zip(wrapped, saved):
        setattr(mod, name, wrap(fn, name, what))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def zamba2_decode(inputs_path, mesh_texts):
    """For each mesh: reduced fp32 zamba2's decode steps from the inputs'
    seeded parameters placed as the serve driver places them and an fp32
    state, each rank its rows, the logits gathered over the data axis;
    from every rank the local shapes and bytes of the placed parameters
    and of the state, and its kernel calls and collectives step by step
    (:func:`_calls`); the serve loop's greedy tokens on the mesh from the
    inputs' plain parameters, and the serve driver's exit code there (its
    own seeded bf16 model)."""
    params, plain, tokens, max_seq = torch.load(inputs_path,
                                                weights_only=False)
    cfg = fp32_cfg(ZAMBA)
    ad = get_adapter(cfg)
    out = {}
    for text in mesh_texts:
        mesh = _data_mesh(text)
        tp = parse_mesh(text)[-1]
        placed = port_serve.place_params(ad, params, mesh, tp)
        b = tokens.shape[1]
        state = ad.init_decode_state(b, max_seq, dtype=torch.float32,
                                     device="cpu", mesh=mesh)
        r0, r1 = sharding.batch_rows(b, mesh)
        logits, steps = [], []
        with torch.inference_mode():
            for pos, tok in enumerate(tokens):
                calls = []
                with _calls(calls):
                    lg, state = ad.decode(placed, {"tokens": tok[r0:r1]},
                                          state, pos, mesh)
                logits.append(lg)
                steps.append(calls)
        record = {
            "local": {"/".join(p): tuple(t.shape)
                      for p, t in _leaves(placed)},
            "bytes": sum(t.numel() * t.element_size()
                         for _, t in _leaves(placed)),
            "state": {k: tuple(sharding.local(t).shape)
                      for k, t in state.items()},
            "steps": steps}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, record)
        run = port_serve.serve(
            cfg, port_serve.place_params(ad, plain, mesh, tp),
            port_serve.make_requests(SERVE_REQUESTS, 16, SERVE_NEW,
                                     cfg.vocab, 0),
            SERVE_SLOTS, SERVE_MAX_SEQ, "cpu", mesh)
        out[text] = {
            "logits": sharding.all_gather(torch.stack(logits), mesh,
                                          sharding.BATCH_AXES, 1).numpy(),
            "ranks": ranks, "cache_seq": state["k"].shape[3],
            "tokens": {r.rid: r.out_tokens for r in run.batcher.completed},
            "driver": port_serve.main(
                ["--arch", ZAMBA, "--reduced", "--device", "cpu", "--mesh",
                 text, "--requests", str(SERVE_REQUESTS), "--slots",
                 str(SERVE_SLOTS), "--max-new", str(SERVE_NEW)])}
    return out


# --- whisper and mllama on a model axis (tests/test_torch_cross_tp.py) -----

def cross_decode(inputs_path, mesh_texts):
    """For each mesh and each case of the inputs ({name: (arch, overrides
    of reduced(), seeded parameters, the cross input (encoder output or
    vision embeddings) of every row, tokens (steps, b, 1), max_seq)}):
    the parameters placed as the serve driver places them, an fp32 state
    whose cross KV ``precompute_cross_kv(mesh)`` fills from this rank's
    rows, then the decode steps, the logits gathered over the data axis;
    from every rank its rows and model rank, its cross KV, the local
    shapes and bytes of the placed parameters and of the state, and its
    kernel calls and collectives step by step (:func:`_calls`). Then, for
    each arch of the inputs' plain parameters ({arch: the reference
    driver's parameters}), the serve loop's greedy tokens on the mesh and
    the serve driver's exit code there (its own seeded bf16 model)."""
    cases, plain = torch.load(inputs_path, weights_only=False)
    out = {}
    for text in mesh_texts:
        mesh = _data_mesh(text)
        tp = parse_mesh(text)[-1]
        res = out[text] = {}
        for name, (arch, over, params, cross_in, tokens, max_seq) \
                in cases.items():
            cfg = reduced(ALL_ARCHS[arch], dtype="float32", **over)
            ad = get_adapter(cfg)
            mod = whisper if cfg.family == "audio" else mllama
            placed = port_serve.place_params(ad, params, mesh, tp)
            b = tokens.shape[1]
            r0, r1 = sharding.batch_rows(b, mesh)
            state = ad.init_decode_state(b, max_seq, dtype=torch.float32,
                                         device="cpu", mesh=mesh)
            logits, steps = [], []
            with torch.inference_mode():
                xk, xv = mod.precompute_cross_kv(placed, cfg,
                                                 cross_in[r0:r1], mesh)
                sharding.local(state["xk"]).copy_(xk)
                sharding.local(state["xv"]).copy_(xv)
                for pos, tok in enumerate(tokens):
                    calls = []
                    with _calls(calls):
                        lg, state = ad.decode(placed, {"tokens": tok[r0:r1]},
                                              state, pos, mesh)
                    logits.append(lg)
                    steps.append(calls)
            record = {
                "rows": (r0, r1), "model_rank": sharding.model_rank(mesh),
                "xk": xk.numpy(), "xv": xv.numpy(),
                "local": {"/".join(p): tuple(t.shape)
                          for p, t in _leaves(placed)},
                "bytes": sum(t.numel() * t.element_size()
                             for _, t in _leaves(placed)),
                "state": {k: tuple(sharding.local(t).shape)
                          for k, t in state.items()},
                "seq": {k: t.shape[3] for k, t in state.items()},
                "steps": steps}
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, record)
            res[name] = {"logits": sharding.all_gather(
                torch.stack(logits), mesh, sharding.BATCH_AXES, 1).numpy(),
                "ranks": ranks}
        for arch, driver_params in plain.items():
            cfg = fp32_cfg(arch)
            ad = get_adapter(cfg)
            run = port_serve.serve(
                cfg, port_serve.place_params(ad, driver_params, mesh, tp),
                port_serve.make_requests(SERVE_REQUESTS, 16, SERVE_NEW,
                                         cfg.vocab, 0),
                SERVE_SLOTS, SERVE_MAX_SEQ, "cpu", mesh)
            res[arch] = {"tokens": {r.rid: r.out_tokens
                                    for r in run.batcher.completed},
                         "driver": _driver(arch, text)}
    return out


def gather_parts_adjoint(seed):
    """``sharding.gather_parts_for_model`` in fp64 on the model axis, its
    indices overlapping between the ranks: <f(x), y> and <x, f*(y)>, each
    summed over the ranks (its output is per rank), x each rank's part of
    the whole (a per-rank space, summed) or the whole itself (replicated,
    taken once); and the output and gradient shapes."""
    world = dist.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    rank = sharding.model_rank(mesh)
    shared = torch.Generator().manual_seed(seed)
    own = torch.Generator().manual_seed(seed + 1 + rank)
    width = 4 * world
    # this rank's 3 columns of the first 3 * world, and the last `world`
    # columns, which every rank takes
    index = torch.cat([torch.arange(3 * rank, 3 * rank + 3),
                       torch.arange(3 * world, width)])

    def inner(a, b, replicated):
        v = torch.sum(a * b).reshape(1)
        return v if replicated else sharding.sum_over(v, mesh, ("model",))

    out = {}
    for case, (x_rep, cols) in {"part": (False, 4),
                                "whole": (True, width)}.items():
        x = torch.randn((3, cols, 2), generator=shared if x_rep else own,
                        dtype=torch.float64).requires_grad_(True)
        y = torch.randn((3, len(index), 2), generator=own,
                        dtype=torch.float64)
        fx = sharding.gather_parts_for_model(x, mesh, 1, index, width)
        (xbar,) = torch.autograd.grad(fx, x, y)
        out[case] = (float(inner(fx.detach(), y, False)),
                     float(inner(x.detach(), xbar, x_rep)),
                     tuple(fx.shape), tuple(xbar.shape))
    return out


JOBS = {"meshes": meshes, "adamw_2x2": adamw_2x2, "save_2x2": save_2x2,
        "resume": resume, "serve_meshes": serve_meshes,
        "cp_attention": cp_attention, "tp_collectives": tp_collectives,
        "zamba2_decode": zamba2_decode,
        "gather_parts_adjoint": gather_parts_adjoint,
        "cross_decode": cross_decode}

# Seconds a spawn may take before its ranks are killed and its test fails:
# the slowest spawn of these tests took under 90 s on one xdist worker.
SPAWN_TIMEOUT_S = 600
# Characters of each rank's log a failed spawn shows.
LOG_TAIL = 4000


def _log(tmp_dir: str, world: int, rank: int) -> str:
    return os.path.join(tmp_dir, f"world{world}.rank{rank}.log")


def _main(rank, world, store_path, out_path, jobs, tmp_dir):
    # What this rank prints goes to its log, which the parent shows when
    # the spawn fails or runs past its time limit.
    log = os.open(_log(tmp_dir, world, rank),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = {name: JOBS[name](*args) for name, args in jobs}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _logs(tmp_dir: str, world: int) -> str:
    text = []
    for rank in range(world):
        try:
            with open(_log(tmp_dir, world, rank), errors="replace") as f:
                text.append(f"--- rank {rank} ---\n{f.read()[-LOG_TAIL:]}")
        except OSError:
            text.append(f"--- rank {rank}: no log ---")
    return "\n".join(text)


def spawn(world: int, tmp_dir: str, jobs: list) -> dict:
    """Run each (job name, args) of `jobs` in turn on `world` spawned
    ranks of one process group; rank 0's results by job name. Ranks still
    running after SPAWN_TIMEOUT_S seconds are killed; then, as when a rank
    fails, this raises with the end of what each rank printed."""
    store = os.path.join(tmp_dir, f"world{world}.store")
    out = os.path.join(tmp_dir, f"world{world}.pt")
    ctx = mp.start_processes(_main, args=(world, store, out, jobs, tmp_dir),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise RuntimeError(
                    f"{world} spawned ranks ran past {SPAWN_TIMEOUT_S} s and were "
                    f"killed; what they printed:\n{_logs(tmp_dir, world)}")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
        raise RuntimeError(f"a spawned rank failed: {e}\nwhat the ranks "
                           f"printed:\n{_logs(tmp_dir, world)}") from e
    return torch.load(out, weights_only=False)

