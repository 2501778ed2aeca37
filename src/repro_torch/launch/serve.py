"""Serving driver: continuous-batching decode on one card, on a named-axis
mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --requests 12 --slots 4                 # on cuda (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --mesh 1x2                  # in each of 2 ranks of a gloo group
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch granite-moe-3b-a800m --mesh 1x2       # likewise, 4 experts a rank
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch zamba2-1.2b --mesh 1x2           # likewise, 4 SSM heads a rank
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch whisper-small --mesh 1x2     # likewise, 8 of 16 frames a rank
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch llama-3.2-vision-90b --mesh 1x2  # likewise, 2 of 4 heads a rank

The PyTorch counterpart of ``repro.launch.serve``, with the same flags plus
``--device``. It serves the dense and MoE families (a KV cache), rwkv6 (a
recurrent state), zamba2 (SSM states and conv tails, plus a KV cache
for each application of its shared attention block), llama-3.2-vision and
whisper-small (a KV cache plus a cross KV) through the same
loop, and reproduces the reference's behaviour exactly, including its
quirks: it never calls ``precompute_cross_kv`` and passes no vision
embeddings or audio frames, so the cross KV of mllama and whisper stays
zero and each cross-attention attends uniformly over zeros (whisper's
then adds only its output bias); only ``req.prompt[0]`` is fed at
admission; every slot decodes at
one shared host-side ``pos`` that clamps at ``max_seq - 1``; nothing is
cleared when a slot is reused, so a request admitted into it attends to
the KV its predecessor left there, or carries on from its predecessor's
recurrent, SSM and conv state; and the closing KV-bytes line uses
``n_kv_heads`` and the head dim also for rwkv6, which has no KV cache,
and all ``n_layers`` for zamba2, whose KV cache has one layer per shared
application, and for llama-3.2-vision, whose cross layers keep no self
KV.
``pos`` stays a host int, so a step reads nothing back from the device but
the sampled tokens.

``--mesh DATAxMODEL`` (default 1x1; one number is ``data`` with that TP, as
in the reference and ``launch/train.py``) must cover the process group
(``launch/mesh.py``): without a launcher the driver is one process, so a
larger mesh needs ranks started around it. Parameters come from
``init(tp=model)`` and each rank keeps its shards under the family's
``param_specs(tp=model)``. Every rank runs the same deterministic batcher
and decodes its rows of the slot array; the sampled tokens are gathered
over the batch axes, so every rank records the same tokens. On a
``model`` axis of several ranks the dense and MoE families decode tensor-
and context-parallel, the MoE's experts split over the ranks
(``models/transformer.py``, ``models/moe.py``), rwkv6 on its heads
(``models/rwkv6.py``), zamba2 on its SSM heads, each rank's parts of
its packed in_proj and conv laid out once by :func:`place_params`, the
shared block's KV cache split by sequence (``models/zamba2.py``), and
whisper and llama-3.2-vision tensor- and context-parallel, their cross
KV (never filled by this driver) split by sequence where the axis
divides it and whole on every rank where it does not
(``models/whisper.py``, ``models/mllama.py``); a shape that does not
split is refused (reduced rwkv6-3b's one head). The MoE family's routing groups
span the batch axes' rows, as the reference's span the whole batch, so
its slots must split evenly over them. On ``cuda`` a mesh holds one
card.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs.base import reduced
from ..configs.registry_configs import ALL_ARCHS
from ..distributed.sharding import BATCH_AXES, all_gather, batch_rows
from ..models.registry import check_decode_mesh, get_adapter
from ..serve.batching import ContinuousBatcher, Request
from ..serve.kv_cache import ROW_BYTES
from .mesh import driver_mesh, make_mesh, parse_mesh, process_group_scope


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def make_requests(n: int, prompt_len: int, max_new: int, vocab: int,
                  seed: int) -> list[Request]:
    """The reference driver's requests: prompts drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(1, vocab, size=(prompt_len,),
                                      dtype=np.int32),
                    max_new_tokens=max_new) for rid in range(n)]


@dataclass
class ServeRun:
    batcher: ContinuousBatcher
    #: as the reference counts it: slots still busy after each step's
    #: retirements, so each request's last token is left out.
    tokens_out: int
    seconds: float
    step_seconds: list


def place_params(adapter, params: dict, mesh, tp: int) -> dict:
    """This rank's shards of `params` (the same on every rank) under the
    family's ``param_specs(tp=tp)``, replicated over ``data``: plain
    tensors, the parameters themselves where nothing is split. zamba2 on a
    ``model`` axis of several ranks keeps its packed in_proj and conv by a
    rank's parts instead, laid out here once
    (``ModelAdapter.place_decode_params``)."""
    return adapter.place_decode_params(params, mesh, tp)


def serve(cfg, params: dict, requests: list, slots: int, max_seq: int,
          device, mesh=None) -> ServeRun:
    """Answer ``requests`` with greedy decoding over ``slots`` batch slots
    on ``device``, with a ``max_seq`` KV cache (dense, MoE; plus the
    never-filled cross KV of vlm and audio), a recurrent state (rwkv6) or
    both (zamba2). Each step's time is taken on
    the host clock after the sampled tokens reach the host, so it includes
    the device's work. On a `mesh` every rank calls this with the same
    requests and its shards of the parameters (:func:`place_params`),
    decodes its rows of the slots and gathers the sampled tokens."""
    device = resolve_device(device)
    adapter = get_adapter(cfg)
    batcher = ContinuousBatcher(slots)
    for req in requests:
        batcher.submit(req)
    cache = adapter.init_decode_state(slots, max_seq, device=device,
                                      mesh=mesh)
    r0, r1 = batch_rows(slots, mesh)
    loud = mesh is None or dist.get_rank() == 0
    cur = np.zeros((slots, 1), np.int32)
    pos = 0
    tokens_out = 0
    step_seconds = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        while not batcher.idle():
            ts = time.perf_counter()
            for slot, req in batcher.schedule():
                cur[slot, 0] = req.prompt[0]
            tokens = torch.from_numpy(cur[r0:r1]).to(device)
            logits, cache = adapter.decode(params, {"tokens": tokens}, cache,
                                           pos, mesh)
            out = greedy_sample(logits)
            if r1 - r0 < slots:
                out = all_gather(out, mesh, BATCH_AXES, 0)
            out = out.cpu().numpy()
            finished = batcher.record_tokens(out)
            for slot in range(slots):
                if batcher.active[slot] is not None:
                    cur[slot, 0] = out[slot]
            tokens_out += sum(1 for r in batcher.active if r is not None)
            pos = min(pos + 1, max_seq - 1)
            step_seconds.append(time.perf_counter() - ts)
            for req in finished if loud else ():
                print(f"[serve] request {req.rid} done "
                      f"({len(req.out_tokens)} tokens)")
    return ServeRun(batcher, tokens_out, time.perf_counter() - t0,
                    step_seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ALL_ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL (or one number: data, with that TP); "
                         "its size is the number of ranks")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ALL_ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    shape = parse_mesh(args.mesh)
    axes, tp = driver_mesh(shape, device)
    check_decode_mesh(cfg, shape[1] if len(shape) == 2 else 1)
    requests = make_requests(args.requests, args.prompt_len, args.max_new,
                             cfg.vocab, args.seed)
    adapter = get_adapter(cfg)
    with process_group_scope():
        mesh = make_mesh(shape, axes, device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = place_params(adapter, adapter.init(gen, tp=tp), mesh, tp)
        run = serve(cfg, params, requests, args.slots, args.max_seq, device,
                    mesh)
        if dist.get_rank():
            return 0

    b = run.batcher
    print(f"[serve] {len(b.completed)} requests, {b.steps} decode steps, "
          f"occupancy {b.occupancy:.2f}, "
          f"{run.tokens_out / max(run.seconds, 1e-9):.1f} tok/s on {device}")
    kv_bytes_tok = 2 * cfg.n_layers * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2
    print(f"[serve] KV bytes/token/all-layers = {kv_bytes_tok} "
          f"({kv_bytes_tok / ROW_BYTES:.2f} DRAM rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
